"""Fleet-scale calibration engine: Algorithm 1 across a whole device grid
(port of ``repro/core/fleet.py``, single device; the mesh path and the
``per_subarray`` method are not ported yet).

  * ``manufacture_fleet``  — per-subarray sense offsets [G, C], each row from
    its own generator, so a subarray's offsets do not depend on the grid.
  * ``calibrate_fleet``    — every iteration draws the whole fleet's operand
    bits and noise and runs one Algorithm-1 step on all G x C columns:
      - ``fused``:     the CUDA kernel (kernels/calib_iter.py) on a GPU
        tensor, its plain version on a CPU tensor;
      - ``reference``: the plain PyTorch version on any device.
  * ``fleet_calib_charges`` — levels -> per-subarray calibration-row charges.
  * ``load_or_calibrate``  — cache glue: a persisted table, or identify,
    measure ECR + masks, and persist.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.devices import resolve_device
from repro_torch.kernels.calib_iter import calib_iter
from repro_torch.kernels.ref import calib_iter_ref
from repro_torch.pud.physics import NEUTRAL, PhysicsParams

from .calibrate import CalibrationConfig
from .ecr import measure_ecr_fleet
from .offsets import OffsetLadder, make_ladder, neutral_level
from .rng import derive_seed, generator

METHODS = ("fused", "reference")


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    """Shape of one device's subarray grid."""

    n_channels: int = 1
    n_banks: int = 4
    n_subarrays: int = 4          # per bank
    n_cols: int = 4096            # per subarray (65 536 on real DDR4)
    frac_counts: tuple[int, ...] = (2, 1, 0)

    @property
    def grid_shape(self) -> tuple[int, int, int]:
        return (self.n_channels, self.n_banks, self.n_subarrays)

    @property
    def n_subarrays_total(self) -> int:
        return self.n_channels * self.n_banks * self.n_subarrays

    @property
    def n_cols_total(self) -> int:
        return self.n_subarrays_total * self.n_cols

    def ladder(self, params: PhysicsParams) -> OffsetLadder:
        return make_ladder(self.frac_counts, params)


@dataclasses.dataclass
class FleetCalibration:
    """Result of one fleet calibration run."""

    levels: torch.Tensor                 # [G, C] int32 ladder level
    mean_abs_bias: torch.Tensor          # [n_iterations]
    config: FleetConfig
    method: str


def manufacture_fleet(seed: int, cfg: FleetConfig, params: PhysicsParams,
                      device=None) -> torch.Tensor:
    """Per-subarray sense offsets [G, C] float32 ~ N(0, sigma_static), on
    ``device`` (default the GPU; raises without one)."""
    device = resolve_device(device)
    sigma = torch.tensor(params.sigma_static, dtype=torch.float32,
                         device=device)
    return torch.stack([
        sigma * torch.randn(cfg.n_cols, dtype=torch.float32, device=device,
                            generator=generator(seed, "manufacture", g,
                                                device=device))
        for g in range(cfg.n_subarrays_total)])


def ladder_tables(ladder: OffsetLadder, params: PhysicsParams
                  ) -> tuple[tuple[float, ...], tuple[float, ...]]:
    """Static per-level (charge sum, swing^2 sum) of the calibration rows,
    computed in float32 numpy exactly as the reference does."""
    rc = ladder.row_charges(params)                        # [L, n_rows]
    qsum = tuple(float(x) for x in rc.sum(axis=1))
    swing = tuple(float(x) for x in ((2.0 * (rc - NEUTRAL)) ** 2).sum(axis=1))
    return qsum, swing


def calibrate_fleet(seed: int, sense_offsets: torch.Tensor, cfg: FleetConfig,
                    params: PhysicsParams,
                    config: CalibrationConfig = CalibrationConfig(), *,
                    method: str = "fused") -> FleetCalibration:
    """Run Algorithm 1 over the whole subarray grid ``sense_offsets`` [G, C].

    Operand bits are drawn as uint8 {0, 1}; the kernel and the plain
    version give identical levels and bias on the same draws.
    """
    if method not in METHODS:
        raise ValueError(f"method {method!r} not in {METHODS}")
    device = sense_offsets.device
    g, c = sense_offsets.shape
    ladder = cfg.ladder(params)
    qsum, swing = ladder_tables(ladder, params)
    step = calib_iter if method == "fused" else calib_iter_ref
    gen = generator(seed, "calibrate", device=device)
    offsets = sense_offsets.to(torch.float32).contiguous()
    levels = torch.full((g, c), neutral_level(ladder), dtype=torch.int32,
                        device=device)
    hist = []
    for _ in range(config.n_iterations):
        inputs = torch.randint(0, 2, (g, config.n_samples, config.maj_inputs,
                                      c), generator=gen, device=device,
                               dtype=torch.uint8)
        noise = torch.randn((g, config.n_samples, c), generator=gen,
                            device=device, dtype=torch.float32)
        levels, bias = step(inputs, noise, levels, offsets, params,
                            ladder.n_fracs, qsum, swing, config.threshold,
                            config.maj_inputs, config.const_charge_sum,
                            config.const_swing_sq)
        hist.append(bias.abs().mean())
    return FleetCalibration(levels, torch.stack(hist), cfg, method)


def fleet_calib_charges(ladder: OffsetLadder, levels: torch.Tensor,
                        params: PhysicsParams) -> torch.Tensor:
    """[G, C] levels -> [G, n_rows, C] calibration-row charges."""
    table = torch.from_numpy(ladder.row_charges(params)).to(levels.device)
    return table[levels.long()].permute(0, 2, 1)


def load_or_calibrate(cache, device_id: str, seed: int, cfg: FleetConfig,
                      params: PhysicsParams = PhysicsParams(),
                      config: CalibrationConfig = CalibrationConfig(), *,
                      method: str = "fused", n_trials_ecr: int = 1024,
                      device=None):
    """Return (levels [G, C], ecr [G], masks [G, C], cache_hit) on ``device``
    (default the GPU; raises without one).

    A hit recalibrates nothing.  A miss manufactures the fleet, calibrates
    it, measures ECR + error-prone masks and persists the table.
    """
    device = resolve_device(device)
    hit = cache.load(device_id, cfg, params)
    if hit is not None and hit.ecr is not None and hit.masks is not None:
        return (torch.from_numpy(hit.levels).to(device),
                torch.from_numpy(hit.ecr).to(device),
                torch.from_numpy(hit.masks).to(device), True)

    offsets = manufacture_fleet(seed, cfg, params, device)
    cal = calibrate_fleet(seed, offsets, cfg, params, config, method=method)
    ladder = cfg.ladder(params)
    charges = fleet_calib_charges(ladder, cal.levels, params)
    ecr, masks = measure_ecr_fleet(derive_seed(seed, 0x0ECD), offsets,
                                   charges, params, ladder.n_fracs,
                                   n_trials=n_trials_ecr)
    cache.save(device_id, cfg, params, cal.levels.cpu().numpy(),
               ecr=ecr.cpu().numpy(), masks=masks.cpu().numpy(),
               metadata={"method": cal.method,
                         "n_iterations": config.n_iterations},
               assumed_temp_c=params.temp_nominal_c)
    return cal.levels, ecr, masks, False
