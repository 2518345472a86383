"""Error-prone column ratio (ECR) measurement (port of
``repro/core/ecr.py``, paper Sec. IV-A).

A column is error-free iff it produces zero errors over the whole campaign
of random MAJX trials (the paper uses 8,192 per bank):

  * ``measure_ecr_maj5`` / ``measure_ecr_majx`` — Monte-Carlo over one
    subarray, chunked over trials (paper protocol);
  * ``measure_ecr_graph`` — the same protocol over a compound MAJ graph
    (ADD8 / MUL8): a column is error-prone if any trial's whole result is
    wrong, which is why arithmetic gains exceed the bare column gain;
  * ``measure_ecr_fleet`` / ``fleet_ecr_summary`` — per-subarray over a grid;
  * ``expected_ecr_maj5`` — the smooth closed form E[1 - (1 - p)^N] of the
    one-time noise fit; not used for reporting.

Plain PyTorch on the device of the offsets (the reference has no kernel
here either).  Random draws come from explicit ``torch.Generator``s where
the reference takes keys; each subarray of a fleet draws from its own.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.pud.bitserial import (MajContext, add_n, bits_to_int,
                                       int_to_bits, mul8_truncated)
from repro_torch.pud.device import maj_outputs
from repro_torch.pud.physics import PhysicsParams, f32

from .rng import generator

N_TRIALS_PAPER = 8192


def _majx_error_mask(gen: torch.Generator, sense_offset: torch.Tensor,
                     calib_charge: torch.Tensor, params: PhysicsParams,
                     n_fracs: int, n_trials: int, chunk: int,
                     n_inputs: int = 5, const_charge_sum: float = 0.0,
                     const_swing_sq: float = 0.0) -> torch.Tensor:
    """[n_cols] bool: True where any of ``n_trials`` MAJX trials erred."""
    n_cols = sense_offset.shape[0]
    device = sense_offset.device
    # n_trials < chunk would otherwise run zero chunks and report a
    # perfect mask without measuring anything
    chunk = min(chunk, n_trials)
    any_err = torch.zeros(n_cols, dtype=torch.bool, device=device)
    for _ in range(n_trials // chunk):
        inputs = torch.randint(0, 2, (chunk, n_inputs, n_cols),
                               generator=gen, device=device,
                               dtype=torch.uint8)
        out = maj_outputs(inputs, calib_charge, sense_offset, gen, params,
                          n_fracs, const_charge_sum=const_charge_sum,
                          const_swing_sq=const_swing_sq)
        truth = (inputs.sum(dim=-2) > n_inputs // 2).to(torch.float32)
        any_err |= (out != truth).any(dim=0)
    return any_err


def measure_ecr_maj5(gen: torch.Generator, sense_offset: torch.Tensor,
                     calib_charge: torch.Tensor, params: PhysicsParams,
                     n_fracs: int, n_trials: int = N_TRIALS_PAPER,
                     chunk: int = 256) -> tuple[float, torch.Tensor]:
    """Returns (ECR in [0, 1], per-column error-prone mask [n_cols])."""
    mask = _majx_error_mask(gen, sense_offset, calib_charge, params,
                            n_fracs, n_trials, chunk)
    return float(mask.float().mean()), mask


def measure_ecr_majx(gen: torch.Generator, sense_offset: torch.Tensor,
                     calib_charge: torch.Tensor, params: PhysicsParams,
                     n_fracs: int, n_inputs: int,
                     const_charge_sum: float = 0.0,
                     const_swing_sq: float = 0.0,
                     n_trials: int = N_TRIALS_PAPER,
                     chunk: int = 256) -> tuple[float, torch.Tensor]:
    """MAJX ECR for any input count (paper Sec. III-D extension).

    MAJ3 = 3 inputs + 0/1 constant pair (const_charge_sum=1, swing_sq=2)
    + 3 calibration rows; MAJ7 = 7 inputs + 1 calibration row.  Opened rows
    must total params.n_simra_rows.
    """
    mask = _majx_error_mask(gen, sense_offset, calib_charge, params,
                            n_fracs, n_trials, chunk, n_inputs=n_inputs,
                            const_charge_sum=const_charge_sum,
                            const_swing_sq=const_swing_sq)
    return float(mask.float().mean()), mask


def measure_ecr_graph(gen: torch.Generator, ctx: MajContext, op: str,
                      n_trials: int = 1024,
                      chunk: int = 64) -> tuple[float, torch.Tensor]:
    """ECR of a compound arithmetic graph ("add8" | "mul8") under the
    paper's protocol: random 8-bit operand pairs per column per trial; a
    column is error-prone if any trial's full result deviates from exact
    integer arithmetic."""
    if op not in ("add8", "mul8"):
        raise ValueError(op)
    n_cols = ctx.sense_offset.shape[0]
    device = ctx.sense_offset.device
    any_err = torch.zeros(n_cols, dtype=torch.bool, device=device)
    for _ in range(max(1, n_trials // chunk)):
        a = torch.randint(0, 256, (chunk, n_cols), generator=gen,
                          device=device, dtype=torch.int32)
        b = torch.randint(0, 256, (chunk, n_cols), generator=gen,
                          device=device, dtype=torch.int32)
        ab_, bb_ = int_to_bits(a, 8), int_to_bits(b, 8)
        abar, bbar = 1.0 - ab_, 1.0 - bb_
        if op == "add8":
            s, _, cout, _ = add_n(ctx, ab_, abar, bb_, bbar, gen)
            got = bits_to_int(s) + (cout.to(torch.int32) << 8)
            want = a + b
        else:
            s = mul8_truncated(ctx, ab_, abar, bb_, bbar, gen)
            got = bits_to_int(s)
            want = (a * b) & 0xFF
        any_err |= (got != want).any(dim=0)
    return float(any_err.float().mean()), any_err


def measure_ecr_fleet(seed: int, sense_offsets: torch.Tensor,
                      calib_charges: torch.Tensor, params: PhysicsParams,
                      n_fracs: int, n_trials: int = N_TRIALS_PAPER,
                      chunk: int = 256, n_inputs: int = 5
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-subarray MAJX ECR over a fleet grid.

    ``sense_offsets`` [G, n_cols], ``calib_charges`` [G, n_calib, n_cols].
    Returns (ecr [G] float32, error-prone masks [G, n_cols] bool).
    """
    device = sense_offsets.device
    masks = torch.stack([
        _majx_error_mask(generator(seed, "ecr", g, device=device),
                         sense_offsets[g], calib_charges[g], params, n_fracs,
                         n_trials, chunk, n_inputs=n_inputs)
        for g in range(sense_offsets.shape[0])])
    return masks.to(torch.float32).mean(dim=1), masks


def fleet_ecr_summary(masks) -> dict:
    """Aggregate statistics of per-subarray error-prone masks [G, n_cols]."""
    m = np.asarray(masks.cpu() if isinstance(masks, torch.Tensor)
                   else masks)
    per = m.mean(axis=1)
    return {
        "n_subarrays": int(m.shape[0]),
        "cols_per_subarray": int(m.shape[1]),
        "mean_ecr": float(per.mean()),
        "std_ecr": float(per.std()),
        "min_ecr": float(per.min()),
        "max_ecr": float(per.max()),
        "p90_ecr": float(np.percentile(per, 90)),
        "error_free_cols_total": int((~m).sum()),
        "cols_total": int(m.size),
    }


# ---------------------------------------------------------------------------
# Closed-form expectation for fitting.
# ---------------------------------------------------------------------------


def _trial_fail_prob(residual, sigma_eff, margin):
    """P(one random-MAJ5 trial errs | signed offset residual).

    Pattern probabilities for 5 uniform bits: the two margin-critical charge
    sums (3-of-5 / 2-of-5) each occur w.p. 10/32; patterns two margins out
    (4-of-5 / 1-of-5) w.p. 5/32 each; extremes are safe.
    """
    cdf = torch.special.ndtr
    m, m3 = f32(margin, residual), f32(3 * margin, residual)
    p_hi = cdf(-(m - residual) / sigma_eff)      # true-1 read as 0
    p_lo = cdf(-(m + residual) / sigma_eff)      # true-0 read as 1
    p_hi2 = cdf(-(m3 - residual) / sigma_eff)
    p_lo2 = cdf(-(m3 + residual) / sigma_eff)
    return (f32(10 / 32, residual) * (p_hi + p_lo)
            + f32(5 / 32, residual) * (p_hi2 + p_lo2))


def expected_ecr_maj5(sense_offset: torch.Tensor,
                      calib_offset_units: torch.Tensor,
                      params: PhysicsParams, n_fracs: int,
                      sum_swing_sq: float,
                      n_trials: int = N_TRIALS_PAPER) -> torch.Tensor:
    """E[ECR] under the analytic per-trial failure model (smooth in params),
    in the dtype of ``sense_offset``."""
    like = sense_offset
    residual = sense_offset - calib_offset_units * torch.tensor(
        params.cell_weight, dtype=like.dtype, device=like.device)
    sigma_eff = params.sensing_sigma(float(n_fracs),
                                     f32(sum_swing_sq, like)).to(like.dtype)
    p = _trial_fail_prob(residual, sigma_eff, params.maj_margin)
    one = torch.ones((), dtype=like.dtype, device=like.device)
    return (one - _integer_pow(one - p, n_trials)).mean()


def _integer_pow(x: torch.Tensor, n: int) -> torch.Tensor:
    """x ** n for an int n >= 1 by binary exponentiation, one rounded
    multiply at a time: the reference's ``x ** int`` (``lax.integer_pow``)
    computes exactly this, where ``pow`` would round once."""
    acc = None
    while n > 0:
        if n & 1:
            acc = x if acc is None else acc * x
        n >>= 1
        if n > 0:
            x = x * x
    return acc
