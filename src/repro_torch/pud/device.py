"""Command-level DRAM subarray simulator for PUD (port of
``repro/pud/device.py``).

State is a ``SubarrayState`` of tensors; rows are the leading axis, columns
the trailing (column-parallel, like the real device).  Commands return a
new state and never write into the one they were given, as the reference's
pure functions do.

Commands (Sec. II-B of the paper):
  * ``write_row``   — host write (reliable, full charge).
  * ``rowcopy``     — ACT -> PRE -> ACT intra-subarray copy (reliable).
  * ``frac``        — violated-timing partial restore: charge moves a factor
                      ``frac_alpha`` toward neutral.
  * ``simra``       — simultaneous many-row activation: charge sharing across
                      the opened rows, per-column sense with offset + noise,
                      result restored into *all* opened rows.

``simra`` senses through ``kernels/ops.majx_sense`` as one event (charges
[1, k, C], noise [1, C] drawn from an explicit ``torch.Generator``), so on a
CUDA tensor every command-level SiMRA launches the sensing kernel.  The
fast path ``maj_outputs`` that calibration and ECR measurement share keeps
the reference's own order of float sums (operand rows, then calibration
rows, then constants) and does not go through the kernel.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from repro_torch.devices import resolve_device
from repro_torch.kernels.ops import majx_sense

from .physics import NEUTRAL, PhysicsParams, f32, sense


@dataclasses.dataclass
class SubarrayState:
    """Charge state of one subarray plus its (static) sense-amp offsets."""

    charge: torch.Tensor        # [n_rows, n_cols] float32, V_DD units
    sense_offset: torch.Tensor  # [n_cols] float32, threshold deviation

    @property
    def n_rows(self) -> int:
        return self.charge.shape[0]

    @property
    def n_cols(self) -> int:
        return self.charge.shape[1]


def make_subarray(gen: torch.Generator, n_rows: int, n_cols: int,
                  params: PhysicsParams, device=None) -> SubarrayState:
    """Manufacture a subarray on ``device`` (default the GPU; raises
    without one): cells neutral, offsets ~ N(0, sigma_static) drawn from
    ``gen`` on its own device."""
    device = resolve_device(device)
    draw = torch.randn(n_cols, generator=gen, device=gen.device,
                       dtype=torch.float32).to(device)
    offs = f32(params.sigma_static, draw) * draw
    charge = torch.full((n_rows, n_cols), NEUTRAL, dtype=torch.float32,
                        device=device)
    return SubarrayState(charge=charge, sense_offset=offs)


def _with_rows(state: SubarrayState, rows, values) -> SubarrayState:
    charge = state.charge.clone()
    for r in rows:
        charge[r] = values
    return dataclasses.replace(state, charge=charge)


def write_row(state: SubarrayState, row: int,
              bits: torch.Tensor) -> SubarrayState:
    return _with_rows(state, (row,), bits.to(torch.float32))


def read_row(state: SubarrayState, row: int) -> torch.Tensor:
    """Normal-timing single-row read: reliable full-margin sensing."""
    return (state.charge[row] > f32(NEUTRAL, state.charge)).to(torch.float32)


def rowcopy(state: SubarrayState, src: int,
            dst: Sequence[int]) -> SubarrayState:
    """ACT(src) -> PRE -> ACT(dst): copy src's digital value into dst row(s)
    (AAP-style multi-destination copy), restoring src to full charge."""
    return _with_rows(state, (src, *dst), read_row(state, src))


# The physics travels beside the state, as in the reference (it is static);
# a module-level holder keeps the command signatures simple.
_PARAMS: PhysicsParams = PhysicsParams()


def set_params(params: PhysicsParams) -> None:
    global _PARAMS
    _PARAMS = params


def _params(_: SubarrayState) -> PhysicsParams:
    return _PARAMS


def frac(state: SubarrayState, row: int) -> SubarrayState:
    """One Frac op: charge moves a factor ``frac_alpha`` toward neutral.
    Placement noise is accounted at sensing time (``sensing_sigma``)."""
    q = state.charge[row]
    half = f32(NEUTRAL, q)
    q = half + (q - half) * f32(_params(state).frac_alpha, q)
    return _with_rows(state, (row,), q)


def simra(state: SubarrayState, rows: Sequence[int], gen: torch.Generator,
          n_fracs_applied: int = 0) -> tuple[SubarrayState, torch.Tensor]:
    """Simultaneous many-row activation over ``rows`` (normally 8 rows).

    Returns the new state (result restored into all opened rows) and the
    sensed bits [n_cols].  One ``majx_sense`` event; its noise is drawn
    from ``gen``, which must live on the state's device.
    """
    rows = list(rows)
    q = state.charge[rows][None]                           # [1, k, n_cols]
    noise = torch.randn((1, state.n_cols), generator=gen,
                        device=state.charge.device, dtype=torch.float32)
    bits = majx_sense(q, state.sense_offset, noise, _params(state),
                      n_fracs_applied)[0]
    return _with_rows(state, rows, bits), bits


# ---------------------------------------------------------------------------
# Fast path: closed-form MAJX outputs for calibration / ECR measurement.
# ---------------------------------------------------------------------------

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
