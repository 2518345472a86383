"""Error-prone column ratio (ECR) measurement (port of ``measure_ecr_fleet``
and ``_majx_error_mask`` in ``repro/core/ecr.py``).

A column is error-free iff it produces zero errors over the whole campaign
of random MAJX trials.  Plain PyTorch on the target device (the reference
has no kernel here either); each subarray draws from its own generator.
"""
from __future__ import annotations

import torch

from repro_torch.pud.device import maj_outputs
from repro_torch.pud.physics import PhysicsParams

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
