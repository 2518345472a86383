"""Calibration data identification — the paper's Algorithm 1 (port of
``repro/core/calibrate.py``).

Each iteration runs MAJ5 on random input patterns, computes the per-column
*bias* (proportion of '1' outputs minus the true-majority proportion) and
steps the column one level down/up the offset ladder when the bias exceeds
+-threshold: a positive bias (the column reads '1' too often) steps it
DOWN, as in Algorithm 1.

``identify_calibration`` runs one subarray in plain PyTorch on the device
of its ``sense_offset`` (the reference's single-subarray oracle); the fleet
engine (core/fleet.py) runs the same iteration through the ``calib_iter``
kernel.  Operand bits and noise come from an explicit ``torch.Generator``
on that device, where the reference takes a key.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.pud.device import maj_outputs
from repro_torch.pud.physics import PhysicsParams, f32

from .offsets import OffsetLadder, levels_to_charges, neutral_level


@dataclasses.dataclass(frozen=True)
class CalibrationConfig:
    n_iterations: int = 20      # paper Sec. IV-A
    n_samples: int = 512        # random samples per iteration
    # Bias threshold of Algorithm 1: below 1/n_samples, so one observed
    # error already steps the level.
    threshold: float = 0.0009
    maj_inputs: int = 5
    # constant (non-operand, non-calibration) rows: MAJ3 uses a 0/1 pair
    const_charge_sum: float = 0.0
    const_swing_sq: float = 0.0


def _iteration(gen: torch.Generator, levels: torch.Tensor,
               sense_offset: torch.Tensor, ladder: OffsetLadder,
               params: PhysicsParams, config: CalibrationConfig,
               const_charge_sum: float, const_swing_sq: float
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """One Algorithm-1 iteration; returns (new levels, bias [n_cols])."""
    n_cols = sense_offset.shape[0]
    inputs = torch.randint(0, 2, (config.n_samples, config.maj_inputs,
                                  n_cols), generator=gen,
                           device=sense_offset.device, dtype=torch.uint8)
    calib = levels_to_charges(ladder, levels, params)
    out = maj_outputs(inputs, calib, sense_offset, gen, params,
                      ladder.n_fracs, const_charge_sum=const_charge_sum,
                      const_swing_sq=const_swing_sq)
    truth = (inputs.sum(dim=-2) > config.maj_inputs // 2).to(torch.float32)
    bias = (out - truth).mean(dim=0)
    thr = f32(config.threshold, bias)
    step = torch.where(bias > thr, -1, 0) + torch.where(bias < -thr, 1, 0)
    levels = torch.clamp(levels + step, 0, ladder.n_levels - 1)
    return levels.to(torch.int32), bias


def identify_calibration_fn(
    gen: torch.Generator,
    sense_offset: torch.Tensor,       # [n_cols] float32
    ladder: OffsetLadder,
    params: PhysicsParams,
    config: CalibrationConfig = CalibrationConfig(),
) -> torch.Tensor:
    """Run Algorithm 1; returns per-column ladder level indices [n_cols]
    int32 on the device of ``sense_offset``."""
    levels = torch.full(sense_offset.shape, neutral_level(ladder),
                        dtype=torch.int32, device=sense_offset.device)
    for _ in range(config.n_iterations):
        levels, _ = _iteration(gen, levels, sense_offset, ladder, params,
                               config, config.const_charge_sum,
                               config.const_swing_sq)
    return levels


#: The reference jits ``identify_calibration_fn`` under this name; PyTorch
#: runs eagerly, so the two are one function here.
identify_calibration = identify_calibration_fn


def calibration_history(
    gen: torch.Generator,
    sense_offset: torch.Tensor,
    ladder: OffsetLadder,
    params: PhysicsParams,
    config: CalibrationConfig = CalibrationConfig(),
) -> tuple[torch.Tensor, list[float]]:
    """Like ``identify_calibration`` but also returns the per-iteration mean
    |bias| (for the convergence benchmark).  As in the reference, the
    sensing here leaves out ``config``'s constant rows."""
    levels = torch.full(sense_offset.shape, neutral_level(ladder),
                        dtype=torch.int32, device=sense_offset.device)
    history = []
    for _ in range(config.n_iterations):
        levels, bias = _iteration(gen, levels, sense_offset, ladder, params,
                                  config, 0.0, 0.0)
        history.append(float(bias.abs().mean()))
    return levels, history
