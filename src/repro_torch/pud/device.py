"""Closed-form MAJX outputs (port of ``maj_outputs`` in ``repro/pud/device.py``).

The command-level subarray simulator of the reference is not ported yet;
calibration and ECR measurement only need this fast path.  Noise comes from
an explicit ``torch.Generator`` in place of a ``jax.random`` key.
"""
from __future__ import annotations

import torch

from .physics import NEUTRAL, PhysicsParams, f32, sense


def maj_outputs(
    inputs: torch.Tensor,        # [..., n_inputs, n_cols] bits in {0, 1}
    calib_charge: torch.Tensor,  # [n_calib, n_cols] charge of non-operand rows
    sense_offset: torch.Tensor,  # [n_cols]
    generator: torch.Generator,
    params: PhysicsParams,
    n_fracs_applied: int,
    const_charge_sum: float = 0.0,
    const_swing_sq: float = 0.0,
) -> torch.Tensor:
    """Sensed result of SiMRA(inputs + calib rows + const rows) as float32."""
    q_in = inputs.to(torch.float32)
    half = f32(NEUTRAL, q_in)
    two = f32(2.0, q_in)
    charge_sum = (q_in.sum(dim=-2) + calib_charge.sum(dim=0)
                  + f32(const_charge_sum, q_in))
    v = params.bitline_voltage(charge_sum, params.n_simra_rows)
    swing_sq = (((two * (q_in - half)) ** 2).sum(dim=-2)
                + ((two * (calib_charge - half)) ** 2).sum(dim=0)
                + f32(const_swing_sq, q_in))
    sigma = params.sensing_sigma(float(n_fracs_applied), swing_sq)
    return sense(v, sense_offset, sigma, generator)
