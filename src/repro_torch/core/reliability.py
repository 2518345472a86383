"""Reliability under temperature and time drift (paper Fig. 6; port of
``repro/core/reliability.py``).

Calibration data is identified once at nominal conditions (50 C, day 0) and
then held fixed.  The sense-amp thresholds drift with temperature and age;
the metric is **new ECR**: the fraction of columns that were error-free at
calibration time but err under the shifted condition.  The paper measures
< 0.14 % across 40-100 C and < 0.27 % over one week.

Drift sampling and the probe measurement live in ``core/canary``
(``drifted_offsets`` / ``probe_ecr``), so Fig. 6's sweep and the live
monitor (``runtime/drift.py``) score drift with the same code.  This module
keeps the sweep and ``DriftSimulator``, the stand-in device behind
``serve --drift-sim``, which ages a fleet's offsets with the same legs.

Streams: every reference key becomes a seed, ``split`` positions and
``fold_in`` salts become ``derive_seed`` salts.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.devices import resolve_device
from repro_torch.pud.physics import PhysicsParams

from .calibrate import CalibrationConfig, identify_calibration
from .canary import drifted_offsets, probe_ecr
from .offsets import levels_to_charges, make_ladder
from .rng import derive_seed, generator


@dataclasses.dataclass
class ReliabilityPoint:
    condition: float          # degC or days
    ecr: float                # total ECR at the condition
    new_ecr: float            # newly error-prone among calibration-time EF


def reliability_sweep(
    seed: int,
    method: str = "T210",
    temps_c: tuple[float, ...] = (40, 50, 60, 70, 80, 90, 100),
    days: tuple[float, ...] = (1, 2, 3, 4, 5, 6, 7),
    params: PhysicsParams = PhysicsParams(),
    n_cols: int = 65536,
    n_trials: int = 8192,
    calib_config: CalibrationConfig = CalibrationConfig(),
    device=None,
) -> tuple[list[ReliabilityPoint], list[ReliabilityPoint]]:
    """Returns (temperature sweep, time sweep) for a PUDTune configuration,
    on ``device`` (default the GPU; raises without one)."""
    device = resolve_device(device)
    fc = tuple(int(c) for c in method[1:4])
    sense_offset = torch.tensor(params.sigma_static, dtype=torch.float32,
                                device=device) * torch.randn(
        n_cols, generator=generator(seed, "manufacture", device=device),
        device=device, dtype=torch.float32)
    ladder = make_ladder(fc, params)
    levels = identify_calibration(
        generator(seed, "calibrate", device=device), sense_offset, ladder,
        params, calib_config)
    # probe through the canary primitives as a 1-subarray fleet: the
    # measurement path the live monitor runs
    charges_fleet = levels_to_charges(ladder, levels, params)[None]

    _, base_err = probe_ecr(derive_seed(seed, "base"), sense_offset[None],
                            charges_fleet, params, ladder.n_fracs,
                            n_trials=n_trials)
    base_ef = ~base_err[0]

    def eval_at(k: int, offs: torch.Tensor) -> tuple[float, float]:
        ecr, err = probe_ecr(k, offs[None], charges_fleet, params,
                             ladder.n_fracs, n_trials=n_trials)
        new_ecr = float((err[0] & base_ef).float().mean())
        return float(ecr[0]), new_ecr

    temp_points, time_points = [], []
    for i, t in enumerate(temps_c):
        k = derive_seed(seed, "temp", i)
        offs = drifted_offsets(derive_seed(k, int(t)), sense_offset, params,
                               temp_c=float(t))
        ecr, new = eval_at(k, offs)
        temp_points.append(ReliabilityPoint(float(t), ecr, new))
    for i, d in enumerate(days):
        k = derive_seed(seed, "days", i)
        offs = drifted_offsets(derive_seed(k, int(d * 100)), sense_offset,
                               params, days=float(d))
        ecr, new = eval_at(k, offs)
        time_points.append(ReliabilityPoint(float(d), ecr, new))
    return temp_points, time_points


class DriftSimulator:
    """A PUD fleet whose sense offsets age: the device behind
    ``--drift-sim``.

    Holds the fleet's manufactured (calibration-time) offsets and exposes
    ``sense_offsets()``, the one method the drift monitor needs of a
    device.  ``advance`` moves the simulated condition; offsets are then
    redrawn through ``canary.drifted_offsets`` from a per-epoch seed, so
    they are stable within an epoch: the monitor's probe, the ground-truth
    fault masks and the recalibration all see the same drifted device until
    the next ``advance``.  ``subarrays`` confines an advance to a hot spot
    (rows of the grid); the other rows keep their base offsets.
    """

    def __init__(self, seed: int, base_offsets: torch.Tensor,
                 params: PhysicsParams):
        self.seed = int(seed)
        self.base = base_offsets
        self.params = params
        self.temp_c = float(params.temp_nominal_c)
        self.days = 0.0
        self._epoch = 0
        self._subarrays: list[int] | None = None

    @classmethod
    def for_session(cls, session) -> "DriftSimulator":
        """Simulator over the fleet a session calibrated: epoch 0 equals the
        offsets its table was identified against."""
        from .fleet import manufacture_fleet
        base = manufacture_fleet(session.seed, session.fleet_cfg,
                                 session.physics, session.device)
        return cls(derive_seed(session.seed, 0x0D21F7), base,
                   session.physics)

    def advance(self, temp_c: float | None = None, days: float | None = None,
                subarrays=None) -> None:
        """Age the device: set the operating temperature and / or add
        elapsed days, optionally confined to ``subarrays``."""
        if temp_c is not None:
            self.temp_c = float(temp_c)
        if days is not None:
            self.days += float(days)
        self._subarrays = (None if subarrays is None
                           else sorted(int(s) for s in subarrays))
        self._epoch += 1

    @property
    def drifted(self) -> bool:
        return (self._epoch > 0
                and (self.temp_c != self.params.temp_nominal_c
                     or self.days > 0.0))

    def sense_offsets(self) -> torch.Tensor:
        """Current [G, n_cols] offsets under the simulated condition."""
        if not self.drifted:
            return self.base
        temp = self.temp_c if self.temp_c != self.params.temp_nominal_c \
            else None
        days = self.days if self.days > 0.0 else None
        offs = drifted_offsets(derive_seed(self.seed, self._epoch),
                               self.base, self.params, temp_c=temp,
                               days=days)
        if self._subarrays is None:
            return offs
        sel = torch.zeros((self.base.shape[0], 1), dtype=torch.bool,
                          device=self.base.device)
        sel[self._subarrays] = True
        return torch.where(sel, offs, self.base)
