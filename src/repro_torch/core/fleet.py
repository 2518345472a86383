"""Fleet-scale calibration engine: Algorithm 1 across a whole device grid
(port of ``repro/core/fleet.py``).

  * ``manufacture_fleet``  — per-subarray sense offsets [G, C], each row from
    its own generator, so a subarray's offsets do not depend on the grid.
  * ``calibrate_fleet``    — every iteration draws the whole fleet's operand
    bits and noise and runs one Algorithm-1 step on all G x C columns:
      - ``fused``:     the CUDA kernel (kernels/calib_iter.py) on a GPU
        tensor, its plain version on a CPU tensor;
      - ``reference``: the plain PyTorch version on any device;
      - ``per_subarray``: ``identify_calibration`` on each subarray with
        its own generator, the single-subarray Algorithm 1 (the oracle: it
        draws per subarray, so its levels do not follow the fleet draws).
    With a ``mesh`` (``launch/mesh.py``) the block methods split the
    subarray axis G over every position of the mesh (G must divide
    evenly): each iteration's draws come from the one fleet stream, as
    without a mesh, and each position's block of rows runs its
    ``calib_iter`` launch on that position's device; levels and the bias
    history gather back.  So the result equals the single-device run bit
    for bit, however the grid is split.
  * ``recalibrate_subarrays`` — Algorithm 1 again on a subset of subarrays
    against their current offsets, each from its own stream
    (``subarray_key``), so the result does not depend on how the subsets
    were batched; the block methods stack the subset's draws and make one
    launch per iteration.
  * ``iterate_calibration`` — the block methods' iteration loop over given
    draws (what both engines above run, and what a test can feed).
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

from .calibrate import CalibrationConfig, identify_calibration_fn
from .ecr import measure_ecr_fleet
from .offsets import OffsetLadder, make_ladder, neutral_level
from .rng import derive_seed, generator

METHODS = ("fused", "reference", "per_subarray")


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
    mean_abs_bias: torch.Tensor | None   # [n_iterations] (None: per_subarray)
    config: FleetConfig
    method: str

    @property
    def levels_grid(self) -> torch.Tensor:
        """[channels, banks, subarrays, cols] view."""
        return self.levels.reshape(self.config.grid_shape
                                   + (self.config.n_cols,))


def subarray_key(seed: int, index: int, device=None) -> torch.Generator:
    """The stream of subarray ``index`` in a partial recalibration (the
    reference's ``subarray_key`` folds the index into its key)."""
    return generator(seed, "recalibrate", int(index), device=device)


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


def _mesh_devices(mesh, g: int) -> list | None:
    """The mesh's positions in row-major order, or None for no mesh or a
    mesh of one; raises when ``g`` subarrays do not divide over it."""
    if mesh is None or mesh.size == 1:
        return None
    if g % mesh.size != 0:
        raise ValueError(
            f"{g} subarrays not divisible over {mesh.size} devices")
    return mesh.flat_devices()


def calibrate_fleet(seed: int, sense_offsets: torch.Tensor, cfg: FleetConfig,
                    params: PhysicsParams,
                    config: CalibrationConfig = CalibrationConfig(), *,
                    method: str = "fused", mesh=None) -> FleetCalibration:
    """Run Algorithm 1 over the whole subarray grid ``sense_offsets`` [G, C].

    Operand bits are drawn as uint8 {0, 1}; the kernel and the plain
    version give identical levels and bias on the same draws.  ``mesh``
    splits the grid's rows over its positions (module docstring); the
    result stays on ``sense_offsets``' device.
    """
    if method not in METHODS:
        raise ValueError(f"method {method!r} not in {METHODS}")
    device = sense_offsets.device
    g, c = sense_offsets.shape
    ladder = cfg.ladder(params)
    if method == "per_subarray":
        levels = torch.stack([
            identify_calibration_fn(
                generator(seed, "calibrate", i, device=device),
                sense_offsets[i].to(torch.float32), ladder, params, config)
            for i in range(g)])
        return FleetCalibration(levels, None, cfg, method)
    gen = generator(seed, "calibrate", device=device)

    def draws():
        for _ in range(config.n_iterations):
            yield draw_iteration(gen, (g,), config, c, device)

    levels, hist = iterate_calibration(draws(), sense_offsets, ladder,
                                       params, config, method,
                                       devices=_mesh_devices(mesh, g))
    return FleetCalibration(levels, hist, cfg, method)


def draw_iteration(gen: torch.Generator, lead: tuple,
                   config: CalibrationConfig, c: int, device
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """One iteration's operand bits [*lead, S, M, C] uint8 and noise
    [*lead, S, C] float32, drawn in that order from ``gen``."""
    inputs = torch.randint(0, 2, lead + (config.n_samples, config.maj_inputs,
                                         c), generator=gen, device=device,
                           dtype=torch.uint8)
    noise = torch.randn(lead + (config.n_samples, c), generator=gen,
                        device=device, dtype=torch.float32)
    return inputs, noise


def iterate_calibration(draws, sense_offsets: torch.Tensor,
                        ladder: OffsetLadder, params: PhysicsParams,
                        config: CalibrationConfig, method: str = "fused",
                        devices=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Algorithm 1 over ``sense_offsets`` [G, C] from the neutral level,
    one step per item of ``draws`` (``(inputs [G, S, M, C], noise [G, S,
    C])``): the ``calib_iter`` kernel (``fused``) or its plain version
    (``reference``).  Returns (levels [G, C] int32, mean |bias| per
    iteration).  ``devices`` splits the G rows into equal blocks, block i
    stepping on ``devices[i]``; levels and bias gather on
    ``sense_offsets``' device, so the result is the unsplit one."""
    if method not in ("fused", "reference"):
        raise ValueError(f"method {method!r} has no iteration loop")
    qsum, swing = ladder_tables(ladder, params)
    step = calib_iter if method == "fused" else calib_iter_ref
    home = sense_offsets.device
    devices = [torch.device(d) for d in (devices or [home])]
    offsets = sense_offsets.to(torch.float32).contiguous()
    n_blk = offsets.shape[0] // len(devices)
    blocks = [offsets[i * n_blk:(i + 1) * n_blk].to(d).contiguous()
              for i, d in enumerate(devices)]
    levels = [torch.full(b.shape, neutral_level(ladder), dtype=torch.int32,
                         device=b.device) for b in blocks]
    hist = []
    for inputs, noise in draws:
        biases = []
        for i, (offs, d) in enumerate(zip(blocks, devices)):
            rows = slice(i * n_blk, (i + 1) * n_blk)
            levels[i], bias = step(
                inputs[rows].to(d), noise[rows].to(d), levels[i], offs,
                params, ladder.n_fracs, qsum, swing, config.threshold,
                config.maj_inputs, config.const_charge_sum,
                config.const_swing_sq)
            biases.append(bias.to(home))
        hist.append(torch.cat(biases).abs().mean())
    return torch.cat([lv.to(home) for lv in levels]), torch.stack(hist)


def recalibrate_subarrays(seed: int, sense_offsets: torch.Tensor, subarrays,
                          cfg: FleetConfig, params: PhysicsParams,
                          config: CalibrationConfig = CalibrationConfig(), *,
                          method: str = "fused") -> torch.Tensor:
    """Re-run Algorithm 1 for ``subarrays`` against the fleet's current
    offsets ``sense_offsets`` [G, C]; returns their levels [k, C] in
    ascending index order (merging them is the caller's job).

    Subarray g draws from ``subarray_key(seed, g)`` alone, so {3} then {5}
    gives the rows of one {3, 5} pass.  ``fused`` stacks the subset's
    draws into [k, S, M, C] and launches ``calib_iter`` once per
    iteration; ``reference`` runs its plain version on the same draws;
    ``per_subarray`` runs ``identify_calibration_fn`` on each stream.
    """
    if method not in METHODS:
        raise ValueError(f"method {method!r} not in {METHODS}")
    idx = sorted(int(s) for s in subarrays)
    device = sense_offsets.device
    offs = sense_offsets[torch.tensor(idx, device=device)].to(torch.float32)
    ladder = cfg.ladder(params)
    if method == "per_subarray":
        return torch.stack([
            identify_calibration_fn(subarray_key(seed, g, device=device), o,
                                    ladder, params, config)
            for g, o in zip(idx, offs)])
    levels, _ = iterate_calibration(
        recalibration_draws(seed, idx, config, offs.shape[1], device), offs,
        ladder, params, config, method)
    return levels


def recalibration_draws(seed: int, subarrays, config: CalibrationConfig,
                        c: int, device):
    """The draws of ``recalibrate_subarrays``: per iteration, each
    subarray's (in the given order) from its own ``subarray_key`` stream,
    stacked into (inputs [k, S, M, C], noise [k, S, C])."""
    gens = [subarray_key(seed, g, device=device) for g in subarrays]
    for _ in range(config.n_iterations):
        parts = [draw_iteration(gen, (), config, c, device) for gen in gens]
        yield (torch.stack([p[0] for p in parts]),
               torch.stack([p[1] for p in parts]))


def fleet_calib_charges(ladder: OffsetLadder, levels: torch.Tensor,
                        params: PhysicsParams) -> torch.Tensor:
    """[G, C] levels -> [G, n_rows, C] calibration-row charges."""
    table = torch.from_numpy(ladder.row_charges(params)).to(levels.device)
    return table[levels.long()].permute(0, 2, 1)


def load_or_calibrate(cache, device_id: str, seed: int, cfg: FleetConfig,
                      params: PhysicsParams = PhysicsParams(),
                      config: CalibrationConfig = CalibrationConfig(), *,
                      method: str = "fused", n_trials_ecr: int = 1024,
                      device=None, mesh=None):
    """Return (levels [G, C], ecr [G], masks [G, C], cache_hit) on ``device``
    (default the GPU; raises without one).  ``mesh`` splits a miss's
    calibration over its positions (``calibrate_fleet``).

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
    cal = calibrate_fleet(seed, offsets, cfg, params, config, method=method,
                          mesh=mesh)
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
