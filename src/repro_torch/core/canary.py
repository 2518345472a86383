"""Canary-column drift primitives shared by Fig. 6 and the live monitor
(port of ``repro/core/canary.py``).

  * ``drifted_offsets``   — the physics drift model (sigma_temp_drift /
    sigma_time_drift legs) applied to any offset tensor.  Fig. 6's sweep
    and the ``DriftSimulator`` behind ``serve --drift-sim`` call exactly
    this.
  * ``reserve_canaries`` / ``CanarySet`` — per-subarray columns, chosen from
    the calibration-time error-free set and withheld from placement, whose
    only job is to be probed (numpy, deterministic: the reference's columns
    and fingerprints).
  * ``probe_ecr`` — push random known bit-patterns through the MAJ5 path on
    a column subset and score per-subarray ECR: the paper's test campaign
    (Sec. IV-A) restricted to canaries, cheap enough to interleave with
    decode.

Drift is a column-independent threshold shift (the physics legs draw
i.i.d. per column), so a reserved error-free column flips with the same
probability as any placed error-free column: a few canaries per subarray
are an unbiased, coarse estimator of the placed columns that went bad.

Plain PyTorch on the device of the offsets.  Each leg draws from its own
``torch.Generator``: the temperature leg from ``seed``, the time leg from
``derive_seed(seed, 1)``, where the reference uses ``key`` and
``fold_in(key, 1)``.
"""
from __future__ import annotations

import dataclasses
import hashlib

import numpy as np
import torch

from repro_torch.pud.physics import PhysicsParams

from .ecr import measure_ecr_fleet
from .rng import derive_seed, generator


def drifted_offsets(seed: int, sense_offset: torch.Tensor,
                    params: PhysicsParams, temp_c: float | None = None,
                    days: float | None = None) -> torch.Tensor:
    """Apply the paper's temperature / time drift model to sense offsets.

    Each leg adds an i.i.d. normal shift per column: temperature scales as
    ``sigma_temp_drift * |T - T_nominal|``, aging as
    ``sigma_time_drift * sqrt(days)``.  Works on any offset shape (one
    subarray ``[C]`` or a fleet ``[G, C]``).  Each scale rounds in float32
    in the reference's order.
    """
    dev, shape = sense_offset.device, sense_offset.shape
    f32 = torch.float32
    drift = torch.zeros_like(sense_offset)
    if temp_c is not None:
        scale = (torch.tensor(params.sigma_temp_drift, dtype=f32)
                 * torch.tensor(abs(temp_c - params.temp_nominal_c),
                                dtype=f32)).to(dev)
        drift = drift + scale * torch.randn(
            shape, generator=generator(seed, device=dev), device=dev,
            dtype=f32)
    if days is not None:
        scale = (torch.tensor(params.sigma_time_drift, dtype=f32)
                 * torch.sqrt(torch.tensor(days, dtype=f32))).to(dev)
        drift = drift + scale * torch.randn(
            shape, generator=generator(derive_seed(seed, 1), device=dev),
            device=dev, dtype=f32)
    return sense_offset + drift


def reserve_canaries(masks, n_per_subarray: int) -> np.ndarray:
    """Pick ``n_per_subarray`` calibration-time error-free columns per
    subarray, [G, n] int32.

    Columns are spread evenly across each subarray's error-free set, so a
    spatially correlated failure cannot hide between canaries.
    Deterministic given the masks.  Raises if a subarray lacks enough
    error-free columns to sacrifice.
    """
    if isinstance(masks, torch.Tensor):
        masks = masks.cpu().numpy()
    masks = np.asarray(masks, bool)
    g, _ = masks.shape
    cols = np.zeros((g, n_per_subarray), np.int32)
    for gi in range(g):
        free = np.nonzero(~masks[gi])[0]
        if free.size < n_per_subarray:
            raise ValueError(
                f"subarray {gi}: only {free.size} error-free columns, "
                f"cannot reserve {n_per_subarray} canaries")
        idx = np.linspace(0, free.size - 1, n_per_subarray).round().astype(int)
        cols[gi] = free[idx]
    return cols


@dataclasses.dataclass(frozen=True)
class CanarySet:
    """Reserved canary columns of one fleet: ``cols[g, i]`` is the i-th
    canary's column within subarray ``g``."""

    cols: np.ndarray              # [G, n_per_subarray] int32
    n_cols: int                   # columns per subarray (mask width)

    @property
    def n_per_subarray(self) -> int:
        return int(self.cols.shape[1])

    def mask(self) -> np.ndarray:
        """[G, n_cols] bool, True at canary columns: OR it into the planning
        masks so placement treats canaries as unusable."""
        g = self.cols.shape[0]
        out = np.zeros((g, self.n_cols), bool)
        out[np.arange(g)[:, None], self.cols] = True
        return out

    def fingerprint(self) -> str:
        """Short stable hash of the reservation (over the int32 bytes, so it
        equals the reference's): keyed into persisted placement names, so
        a canary-less cached plan is never reused by a canary-reserving
        session."""
        h = hashlib.sha256(np.ascontiguousarray(self.cols).tobytes())
        return h.hexdigest()[:10]


def probe_ecr(seed: int, sense_offsets: torch.Tensor,
              calib_charges: torch.Tensor, params: PhysicsParams,
              n_fracs: int, *, cols: np.ndarray | None = None,
              n_trials: int = 64, chunk: int = 256
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """One probe round: per-subarray ECR of a column subset.

    ``sense_offsets`` [G, n_cols] (possibly drifted), ``calib_charges``
    [G, n_calib, n_cols] from the live table.  With ``cols`` [G, n] this is
    the monitor's canary probe; with ``cols=None`` it measures every column
    (Fig. 6's sweep, and the drift simulation's ground-truth fault masks).
    Returns (ecr [G] float32, error masks [G, n] bool).
    """
    offs, charges = sense_offsets, calib_charges
    if cols is not None:
        idx = torch.as_tensor(np.asarray(cols), dtype=torch.long,
                              device=offs.device)
        offs = torch.take_along_dim(offs, idx, dim=1)
        charges = torch.take_along_dim(charges, idx[:, None, :], dim=2)
    return measure_ecr_fleet(seed, offs, charges, params, n_fracs,
                             n_trials=n_trials, chunk=min(chunk, n_trials))
