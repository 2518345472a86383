"""Analog physics of Processing-Using-DRAM (port of ``repro/pud/physics.py``).

Charge sharing of a 30 fF cell on a 270 fF bitline, the fitted noise
constants, and the sense-amplifier decision.  ``PhysicsParams`` keeps the
reference's fields, defaults and order exactly: the calibration cache keys
its tables on ``dataclasses.asdict(params)``, and the port must compute the
same key to read a table the JAX package wrote.

Float order: every scalar constant enters as a float32 tensor on the
operand's device and each operation rounds on its own (no fused
multiply-add, true division), which is what the reference computes when its
functions run eagerly.  A Python scalar divisor is avoided on purpose:
PyTorch's CUDA division by a CPU scalar multiplies by the reciprocal.
"""
from __future__ import annotations

import dataclasses

import torch

NEUTRAL = 0.5  # precharge / neutral charge level, in V_DD units


def f32(value, like: torch.Tensor) -> torch.Tensor:
    """A Python scalar as a 0-d float32 tensor on ``like``'s device."""
    return torch.tensor(float(value), dtype=torch.float32, device=like.device)


@dataclasses.dataclass(frozen=True)
class PhysicsParams:
    """Device physics constants. Defaults are the reference's fitted ones."""

    c_cell_ff: float = 30.0
    c_bitline_ff: float = 270.0
    n_simra_rows: int = 8
    frac_alpha: float = 0.418438
    sigma_static: float = 0.033281    # sense threshold process variation
    sigma_dynamic: float = 0.001315   # base per-sensing noise
    sigma_frac: float = 0.000024      # per applied Frac, at the bitline
    sigma_transfer: float = 0.000400  # per unit of squared row swing
    temp_nominal_c: float = 50.0
    sigma_temp_drift: float = 0.00002
    sigma_time_drift: float = 0.00012

    def c_total_ff(self, k_rows: int) -> float:
        return k_rows * self.c_cell_ff + self.c_bitline_ff

    def bitline_voltage(self, charge_sum: torch.Tensor,
                        k_rows: int) -> torch.Tensor:
        """Charge-sharing voltage for ``k_rows`` simultaneously opened rows."""
        num = (charge_sum * f32(self.c_cell_ff, charge_sum)
               + f32(NEUTRAL * self.c_bitline_ff, charge_sum))
        return num / f32(self.c_total_ff(k_rows), charge_sum)

    @property
    def cell_weight(self) -> float:
        """Bitline voltage shift per unit of cell charge in an 8-row SiMRA."""
        return self.c_cell_ff / self.c_total_ff(self.n_simra_rows)

    @property
    def maj_margin(self) -> float:
        return 0.5 * self.cell_weight

    def sensing_sigma(self, n_fracs_total: float,
                      sum_swing_sq: torch.Tensor) -> torch.Tensor:
        """Effective dynamic noise std of one SiMRA sensing:
        sqrt((sd^2 + sf^2 * n_fracs) + st^2 * sum_swing_sq), float32."""
        like = sum_swing_sq
        var = ((f32(self.sigma_dynamic ** 2, like)
                + f32(self.sigma_frac ** 2, like) * f32(n_fracs_total, like))
               + f32(self.sigma_transfer ** 2, like) * sum_swing_sq)
        return torch.sqrt(var)


def sense(v_bitline: torch.Tensor, threshold_offset: torch.Tensor,
          noise_sigma: torch.Tensor, generator: torch.Generator
          ) -> torch.Tensor:
    """Sense-amplifier decision: 1 iff V + noise > 0.5 + per-column offset."""
    noise = torch.randn(v_bitline.shape, generator=generator,
                        device=v_bitline.device, dtype=torch.float32)
    eps = noise_sigma * noise
    return (v_bitline + eps > f32(NEUTRAL, v_bitline)
            + threshold_offset).to(torch.float32)
