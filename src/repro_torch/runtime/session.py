"""PUDSession: the PUD serving lifecycle behind one object (port of
``repro/runtime/session.py``, single device).

    session = PUDSession.open("qwen3-1.7b", grid=FleetConfig(...),
                              cache_dir="~/.pud-cache")
    state  = session.calibrate()            # cache hit or Algorithm 1
    packed = session.pack(params, cfg)      # placement-aware PackedModel
    report = session.tune(batches=(1, 4))   # tuned launch plans, stamped
    y      = session.linear(x, "unembed/w") # one packed projection
    extras = session.decode_extras()        # layout / bytes diagnostics
    engine = session.serving_engine(model, max_len=...)
    report = session.perf_report(flops_per_token)   # DDR4-PUD rate models

Calibration tables and placements persist in the reference's on-disk
formats, so either package reads what the other wrote.  The session runs
on ``cuda`` unless ``device="cpu"`` is passed; without a GPU it raises.
``recalibrate_subarrays`` re-identifies a few subarrays against their
current offsets and merges them into the state; ``reserve_canaries``
withholds per-subarray canary columns from placement for the drift monitor
(``runtime/drift.py``).  ``tune`` times the kernels' launch plans on the
card (``kernels/autotune.py``), persists the winners beside the
calibration table (``<cache_dir>/tuning``, ``runtime/tune.py``) and stamps
them on the packs; ``at_operating_point`` pins a Table-I ECR for pricing
without a device.

``PUDSession.open_fleet`` opens one session per position of a ("data",
"model") serving mesh (``launch/mesh.py``): a ``PUDFleetSession`` whose
"model" shards split every packable projection on window-block
boundaries and whose "data" lanes serve independent request streams
(``runtime/engine.FleetServingEngine``).
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core.calibrate import CalibrationConfig
from repro_torch.core.ecr import measure_ecr_fleet
from repro_torch.core.fleet import (FleetConfig, fleet_calib_charges,
                                    load_or_calibrate, manufacture_fleet,
                                    recalibrate_subarrays)
from repro_torch.core.offsets import baseline_charges
from repro_torch.core.rng import derive_seed
from repro_torch.devices import resolve_device
from repro_torch.kernels.autotune import (MAX_CANDIDATES, row_class,
                                          tune_kernel, tuning_key)
from repro_torch.kernels.backends import DEFAULT_BACKEND, backend_names
from repro_torch.pud.gemv import (ECR_BASELINE_B300, ECR_PUDTUNE_T210,
                                  FleetPerfAggregate, FleetPerfModel,
                                  PUDGemvConfig, PUDPerfModel, pud_linear,
                                  weight_traffic)
from repro_torch.pud.packed import PackedModel, packed_bytes
from repro_torch.pud.packer import (pack_model, pack_model_sharded,
                                    packing_requests)
from repro_torch.pud.physics import PhysicsParams
from repro_torch.pud.placement import (Placement, PlacementError,
                                       plan_for_grid, requests_fingerprint,
                                       shard_column_slices)
from repro_torch.runtime.calib_cache import CalibrationTableCache


@dataclasses.dataclass
class CalibrationState:
    """One device's reliability state, as loaded or identified."""

    levels: torch.Tensor       # [G, C] int32 ladder level per column
    ecr: torch.Tensor          # [G] float32 per-subarray ECR
    masks: torch.Tensor        # [G, C] bool per-column error-prone mask
    cache_hit: bool
    wall_s: float

    @property
    def mean_ecr(self) -> float:
        return float(self.ecr.float().mean())


def _sync(device: torch.device) -> None:
    """Wait for ``device``'s queued work, so that a host wall is whole."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _restamp_model(pm: PackedModel, stamped: dict) -> PackedModel:
    """``pm`` with ``stamped[name]`` packs swapped in (same metadata)."""
    def walk(tree, path):
        out = {}
        for key, sub in tree.items():
            if key.endswith("_pud"):
                name = "/".join(path + (key[: -len("_pud")],))
                out[key] = stamped.get(name, sub)
            elif isinstance(sub, dict):
                out[key] = walk(sub, path + (key,))
            else:
                out[key] = sub
        return out

    return PackedModel(params=walk(pm.params, ()),
                       packed_names=pm.packed_names,
                       skipped_names=pm.skipped_names,
                       weight_bits=pm.weight_bits, placed=pm.placed)


class _NullCache:
    """Stand-in when no cache_dir is given: loads miss, saves are dropped."""

    def load(self, *a, **kw):
        return None

    def save(self, *a, **kw):
        return None


class PUDSession:
    """Facade over the calibrate -> cache -> place -> pack -> execute chain.

    Build one with ``PUDSession.open``.
    """

    def __init__(self, *, arch: str | None, fleet_cfg: FleetConfig,
                 cache: CalibrationTableCache | None, device_id: str,
                 backend: str, physics: PhysicsParams,
                 calib: CalibrationConfig, seed: int, placement: bool,
                 method: str, n_trials_ecr: int, device: torch.device):
        if backend not in backend_names():
            raise KeyError(f"unknown backend {backend!r}; registered: "
                           f"{backend_names()}")
        self.arch = arch
        self.fleet_cfg = fleet_cfg
        self.cache = cache
        self.device_id = device_id
        self.backend = backend
        self.physics = physics
        self.calib_cfg = calib
        self.seed = seed
        self.placement_enabled = placement
        self.method = method
        self.n_trials_ecr = n_trials_ecr
        self.device = device

        self._state: CalibrationState | None = None
        self._canaries = None                     # core/canary.CanarySet
        self._operating_point: float | None = None
        self._packed: PackedModel | None = None
        self._pack_cfg: PUDGemvConfig | None = None
        self._placement: Placement | None = None
        self._placement_name: str | None = None
        self._placement_status: str | None = None   # hit | planned | skipped
        self._placement_error: str | None = None
        self._tuning_report: dict | None = None

    @classmethod
    def open(cls, arch_or_grid: "str | FleetConfig | None" = None, *,
             grid: FleetConfig | None = None,
             cache_dir=None, device_id: str = "dimm0",
             backend: str = DEFAULT_BACKEND,
             physics: PhysicsParams | None = None,
             calib: CalibrationConfig | None = None,
             seed: int = 0,
             placement: bool = True,
             method: str = "fused",
             n_trials_ecr: int = 1024,
             device=None) -> "PUDSession":
        """Open a session on one device.

        ``arch_or_grid``: the architecture name this session serves (it
        names persisted placements) or the device's ``FleetConfig`` grid;
        pass the other via ``grid``.  ``cache_dir`` enables persistence.
        ``seed`` drives manufacture and calibration.  ``placement=False``
        packs onto logical columns even when calibrated (faulty ones
        included).  ``device`` defaults to the GPU and raises when there is
        none.
        """
        arch = None
        if isinstance(arch_or_grid, FleetConfig):
            if grid is not None:
                raise ValueError("grid given twice")
            grid = arch_or_grid
        elif arch_or_grid is not None:
            arch = str(arch_or_grid)
        return cls(
            arch=arch,
            fleet_cfg=grid or FleetConfig(n_channels=1, n_banks=1,
                                          n_subarrays=16, n_cols=2048),
            cache=(CalibrationTableCache(cache_dir)
                   if cache_dir is not None else None),
            device_id=device_id, backend=backend,
            physics=physics or PhysicsParams(),
            calib=calib or CalibrationConfig(),
            seed=int(seed), placement=placement, method=method,
            n_trials_ecr=n_trials_ecr, device=resolve_device(device))

    @classmethod
    def at_operating_point(cls, ecr: float, *, arch: str | None = None,
                           n_fracs_cfg: tuple[int, ...] = (2, 1, 0),
                           backend: str = DEFAULT_BACKEND,
                           device=None) -> "PUDSession":
        """A session pinned to a fixed mean ECR (e.g. a Table-I operating
        point) instead of a measured device, for pricing.  ``device`` as
        ``open``'s (the GPU unless the caller asks for the CPU)."""
        s = cls.open(arch, grid=FleetConfig(frac_counts=n_fracs_cfg),
                     backend=backend, device=device)
        s._operating_point = float(ecr)
        return s

    @classmethod
    def open_fleet(cls, arch_or_grid: "str | FleetConfig | None" = None, *,
                   mesh=None, n_data: int | None = None,
                   n_model: int | None = None,
                   grid: FleetConfig | None = None,
                   cache_dir=None, device_id: str = "dimm0",
                   backend: str = DEFAULT_BACKEND,
                   physics: PhysicsParams | None = None,
                   calib: CalibrationConfig | None = None,
                   seed: int = 0, placement: bool = True,
                   method: str = "fused", n_trials_ecr: int = 1024,
                   device=None) -> "PUDFleetSession":
        """Open one logical session per position of a serving mesh.

        ``mesh`` is a ("data", "model") mesh from ``launch/mesh.py``: its
        "model" axis carries tensor-parallel shards of every packable
        projection, its "data" axis independent serving lanes, and session
        (d, m) runs on ``mesh.devices[d][m]``.  Without a mesh pass
        ``n_data`` / ``n_model``; every session then runs on ``device``
        (the GPU unless the caller asks for the CPU).

        Session (d, m) gets the device id ``f"{device_id}-d{d}m{m}"``, so
        its own calibration-cache entry, placements, canaries and drift
        state, and the seed ``derive_seed(seed, d * n_model + m)``: the
        positions are independent, as physically distinct DIMMs are.
        """
        if mesh is not None:
            if n_data is None:
                n_data = int(mesh.shape["data"])
            if n_model is None:
                n_model = int(mesh.shape["model"])
        if not n_data or not n_model or n_data < 1 or n_model < 1:
            raise ValueError("open_fleet needs a mesh or explicit "
                             "n_data/n_model >= 1")
        if mesh is None:
            base = resolve_device(device)
            grid_devs = [[base] * n_model for _ in range(n_data)]
        else:
            grid_devs = mesh.devices
        sessions = [
            [cls.open(arch_or_grid, grid=grid, cache_dir=cache_dir,
                      device_id=f"{device_id}-d{d}m{m}", backend=backend,
                      physics=physics, calib=calib,
                      seed=derive_seed(int(seed), d * n_model + m),
                      placement=placement, method=method,
                      n_trials_ecr=n_trials_ecr, device=grid_devs[d][m])
             for m in range(n_model)]
            for d in range(n_data)]
        return PUDFleetSession(sessions, mesh=mesh, arch=sessions[0][0].arch)

    # -- calibration --------------------------------------------------------

    @property
    def calibration(self) -> CalibrationState | None:
        return self._state

    @property
    def n_fracs(self) -> int:
        return sum(self.fleet_cfg.frac_counts)

    @property
    def ladder(self):
        return self.fleet_cfg.ladder(self.physics)

    def calibrate(self, force: bool = False) -> CalibrationState:
        """Load the device's persisted table, or identify + persist it."""
        if self._state is not None and not force:
            return self._state
        _sync(self.device)
        t0 = time.time()
        levels, ecr, masks, hit = load_or_calibrate(
            self.cache if self.cache is not None else _NullCache(),
            self.device_id, self.seed, self.fleet_cfg, self.physics,
            config=self.calib_cfg, method=self.method,
            n_trials_ecr=self.n_trials_ecr, device=self.device)
        _sync(self.device)
        self._state = CalibrationState(
            levels=levels, ecr=ecr, masks=masks,
            cache_hit=bool(hit), wall_s=time.time() - t0)
        return self._state

    def baseline_ecr(self, n_trials: int | None = None) -> float:
        """Mean fleet ECR of the uncalibrated B_{3,0,0} baseline on this
        device's manufactured offsets (the before-picture of Table I)."""
        cfg = self.fleet_cfg
        offsets = manufacture_fleet(self.seed, cfg, self.physics, self.device)
        base = baseline_charges(3, cfg.n_cols, self.physics,
                                device=self.device)
        ecr, _ = measure_ecr_fleet(
            derive_seed(self.seed, 0x0ECB), offsets,
            base[None].expand(cfg.n_subarrays_total, 3, cfg.n_cols),
            self.physics, 3, n_trials=n_trials or self.n_trials_ecr)
        return float(ecr.mean())

    # -- canaries + live recalibration --------------------------------------

    @property
    def canaries(self):
        """The reserved ``core/canary.CanarySet``, or None."""
        return self._canaries

    def reserve_canaries(self, n_per_subarray: int = 16):
        """Reserve per-subarray canary columns for the drift monitor.

        Canaries come out of the calibration-time error-free set (evenly
        spread over each subarray) and are OR-ed into the planning masks, so
        no tensor is placed on them.  Call after ``calibrate`` and before
        ``pack``; the reservation also keys persisted placement names.
        """
        if self._state is None:
            raise RuntimeError("reserve_canaries requires calibrate() first")
        from repro_torch.core.canary import CanarySet, reserve_canaries
        cols = reserve_canaries(self._state.masks, n_per_subarray)
        self._canaries = CanarySet(cols=cols, n_cols=self.fleet_cfg.n_cols)
        return self._canaries

    def recalibrate_subarrays(self, subarrays, sense_offsets: torch.Tensor,
                              *, assumed_temp_c: float | None = None
                              ) -> CalibrationState:
        """Partial recalibration against the device's current offsets
        ``sense_offsets`` [G, C].

        Re-runs Algorithm 1 for ``subarrays`` only (one stream per
        subarray, ``core/fleet.recalibrate_subarrays``), re-measures their
        ECR and masks with a stream of its own, merges the refreshed rows
        into the state (every other row is kept as it was) and persists
        the merged table.  The save replaces the whole cache entry, which
        drops its persisted placements: plans made from the old masks may
        sit on columns that went bad, so the next ``pack`` plans again.
        """
        if self._state is None:
            raise RuntimeError(
                "recalibrate_subarrays requires calibrate() first")
        _sync(self.device)
        t0 = time.time()
        idx = sorted(int(s) for s in subarrays)
        offs = sense_offsets.to(self.device)
        sub_levels = recalibrate_subarrays(
            self.seed, offs, idx, self.fleet_cfg, self.physics,
            self.calib_cfg, method=self.method)
        rows = torch.tensor(idx, device=self.device)
        sub_ecr, sub_masks = measure_ecr_fleet(
            derive_seed(self.seed, 0x0EC5), offs[rows],
            fleet_calib_charges(self.ladder, sub_levels, self.physics),
            self.physics, self.n_fracs, n_trials=self.n_trials_ecr)
        levels, ecr, masks = (self._state.levels.clone(),
                              self._state.ecr.clone(),
                              self._state.masks.clone())
        levels[rows], ecr[rows], masks[rows] = sub_levels, sub_ecr, sub_masks
        _sync(self.device)
        self._state = CalibrationState(levels=levels, ecr=ecr, masks=masks,
                                       cache_hit=False,
                                       wall_s=time.time() - t0)
        if self.cache is not None:
            self.cache.save(
                self.device_id, self.fleet_cfg, self.physics,
                levels.cpu().numpy(), ecr=ecr.cpu().numpy(),
                masks=masks.cpu().numpy(),
                metadata={"method": self.method,
                          "recalibrated_subarrays": idx},
                assumed_temp_c=(self.physics.temp_nominal_c
                                if assumed_temp_c is None
                                else assumed_temp_c))
        return self._state

    def calibration_age(self) -> dict | None:
        """Age metadata of the persisted table, or None without a cache or
        a persisted entry."""
        if self.cache is None:
            return None
        table = self.cache.load(self.device_id, self.fleet_cfg, self.physics)
        if table is None:
            return None
        return {"calibrated_at": table.calibrated_at,
                "age_days": table.age_days(),
                "assumed_temp_c": table.assumed_temp_c,
                "params_fingerprint": table.params_fingerprint}

    # -- placement + packing ------------------------------------------------

    @property
    def placement(self) -> Placement | None:
        return self._placement

    @property
    def placement_status(self) -> str | None:
        """After ``pack``: "hit" | "planned" | "skipped" | None (placement
        not attempted: uncalibrated)."""
        return self._placement_status

    @property
    def placement_error(self) -> str | None:
        return self._placement_error

    @property
    def placement_name(self) -> str | None:
        return self._placement_name

    @property
    def packed(self) -> PackedModel | None:
        return self._packed

    def _plan_requests(self, reqs, base_name: str) -> Placement | None:
        """Cache-aware placement planning for an explicit request list:
        a persisted plan of the same name is a hit; otherwise plan from the
        masks and persist.  A plan that does not fit is "skipped".  Reserved
        canaries plan as unusable and their fingerprint suffixes the name."""
        pname = f"{base_name}-{requests_fingerprint(reqs)}"
        masks = self._state.masks.cpu().numpy()
        if self._canaries is not None:
            masks = np.asarray(masks, bool) | self._canaries.mask()
            pname += f"-c{self._canaries.fingerprint()}"
        self._placement_name = pname
        placement = None
        if self.cache is not None:
            placement = self.cache.load_placement(
                self.device_id, self.fleet_cfg, self.physics, pname)
        if placement is not None:
            self._placement_status = "hit"
            self._placement = placement
            return placement
        try:
            placement = plan_for_grid(masks, reqs, self.fleet_cfg.grid_shape)
        except PlacementError as e:
            self._placement_status, self._placement_error = "skipped", str(e)
            return None
        if self.cache is not None:
            self.cache.save_placement(self.device_id, self.fleet_cfg,
                                      self.physics, pname, placement)
        self._placement_status = "planned"
        self._placement = placement
        return placement

    def pack(self, params: dict, cfg: PUDGemvConfig | None = None, *,
             name: str | None = None,
             include_unembed: bool = True) -> PackedModel:
        """Pack a parameter tree for this device, in the placed physical
        layout when placement is enabled, the session is calibrated and
        placement fits.  Packs are stamped with the session backend unless
        ``cfg`` names one."""
        if cfg is None:
            cfg = PUDGemvConfig(backend=self.backend)
        elif cfg.backend is None:
            cfg = dataclasses.replace(cfg, backend=self.backend)
        self._placement_status = self._placement_error = None
        self._placement = None
        if self.placement_enabled and self._state is not None:
            self._placement = self._plan_requests(
                packing_requests(params, cfg, include_unembed),
                name or self.arch or "model")
        pm = pack_model(params, cfg, include_unembed=include_unembed,
                        placement=self._placement)
        self._packed, self._pack_cfg = pm, cfg
        return pm

    # -- kernel autotuning ---------------------------------------------------

    def _tuning_cache(self):
        """The persistent tuning cache beside the calibration table
        (``<cache_dir>/tuning``) for this session's card, or None without a
        cache (the winners then live only in the stamped packs)."""
        if self.cache is None:
            return None
        from repro_torch.runtime.tune import TuningCache, device_tag
        return TuningCache(self.cache.directory / "tuning",
                           device=device_tag(self.device))

    def _plan_fits(self, plan, entry: str, batch: int, planes, pt) -> bool:
        """Does the contract checker accept ``plan`` for this pack?"""
        from repro_torch import devices
        from repro_torch.analysis.contracts import check_tile_plan
        from repro_torch.analysis.errors import ContractViolation
        try:
            check_tile_plan(
                plan, entry, (batch, pt.k), tuple(planes.shape),
                layout=pt.layout, logical_k=pt.logical_k,
                col_ids=pt.n if pt.placed else None,
                window_block=pt.window_block,
                sms=devices.sm_count(self.device))
        except ContractViolation:
            return False
        return True

    def tune(self, names=None, *, batches=(1, 8), force: bool = False,
             warmup: int = 1, reps: int = 5,
             max_candidates: int = MAX_CANDIDATES) -> dict:
        """Autotune the packed projections on the session's card and stamp
        the winners on the packs.

        For every pack (only ``names``, report names or unique path
        suffixes, when given) and every batch in ``batches``, the plan of
        its tuning key loads from the tuning cache; on a miss, with
        ``force``, or when a cached plan does not fit this pack's window,
        ``kernels/autotune.tune_kernel`` searches it (heuristic first,
        every candidate equal to it bit for bit) and the winner is saved.
        Each pack is stamped with one plan per row class of ``batches``
        (``autotune.row_class``), so every later ``linear``, decode step,
        engine and ``save_packed_npz`` carries them.  Needs a CUDA
        session: the plain versions take no plan.

        Returns the report (also ``tuning_report()``): per key its status
        ("hit", "tuned"), the plan, and the heuristic and tuned seconds,
        the speedup and the candidate count.
        """
        if self._packed is None:
            raise RuntimeError("no packed model: call session.pack() first")
        if self.device.type != "cuda":
            raise RuntimeError(
                f"PUDSession.tune: the session runs on {self.device}; "
                "tuning times the CUDA kernels and needs the GPU")
        cache = self._tuning_cache()
        mode = (self._pack_cfg or PUDGemvConfig()).mode
        tensors = self._packed.tensors
        if names is not None:
            tensors = {n: tensors[n] for n in map(self._packed.name_of,
                                                  names)}
        report: dict = {"fingerprint": cache.fingerprint if cache else None,
                        "cache_dir": str(cache.directory) if cache else None,
                        "keys": {}}
        stamped = {}
        for name, pt in tensors.items():
            planes = pt.planes[0] if pt.planes.dim() == 4 else pt.planes
            col_ids = None
            if pt.col_ids is not None:
                col_ids = pt.col_ids[0] if pt.col_ids.dim() == 2 \
                    else pt.col_ids
            plans = {}
            for batch in batches:
                batch = int(batch)
                entry = "gemm" if batch > 1 else "gemv"
                key = tuning_key(entry, batch, pt.k, pt.n, pt.n_bits,
                                 pt.layout, pt.placed)
                row = {"name": name, "entry": entry, "batch": batch,
                       "row_class": row_class(batch)}
                plan = None if (force or cache is None) else cache.load(key)
                if plan is not None and self._plan_fits(plan, entry, batch,
                                                        planes, pt):
                    row.update(status="hit",
                               **cache.load_entry(key)["stats"])
                else:
                    x = ((torch.arange(batch * pt.k, device=self.device)
                          % 255) - 127).to(torch.int8).reshape(batch, pt.k)
                    res = tune_kernel(
                        entry, x, planes, col_ids=col_ids,
                        window_block=pt.window_block, layout=pt.layout,
                        logical_k=pt.logical_k, mode=mode,
                        backend=self.backend, warmup=warmup, reps=reps,
                        max_candidates=max_candidates)
                    plan = res.plan
                    row.update(status="tuned", **res.to_stats())
                    if cache is not None:
                        cache.save(key, plan, res.to_stats())
                row["plan"] = plan.to_dict()
                report["keys"][key] = row
                plans[row_class(batch)] = plan
            stamped[name] = pt.replace(tile_plan=tuple(sorted(plans.items())))
        self._restamp_packs(stamped)
        self._tuning_report = report
        return report

    def _restamp_packs(self, stamped: dict) -> None:
        """Swap tuned packs into the packed tree (a new ``PackedModel``)."""
        self._packed = _restamp_model(self._packed, stamped)

    def tuning_report(self) -> dict | None:
        """The last ``tune`` report, or None when the session never tuned."""
        return self._tuning_report

    # -- execution ------------------------------------------------------------

    def linear(self, x: torch.Tensor, name: str, *,
               backend: str | None = None) -> torch.Tensor:
        """Run one packed projection: x [..., K] -> [..., N] float32 on the
        session's device.  ``name`` is a pack's report name or a unique
        path suffix ("unembed/w"); ``backend`` overrides the session's for
        this call (every backend gives the same integers)."""
        if self._packed is None:
            raise RuntimeError("no packed model: call session.pack() first")
        pt = self._packed.tensor(name)
        cfg = self._pack_cfg or PUDGemvConfig()
        return pud_linear(x.to(self.device), pt, cfg,
                          backend=backend or self.backend)

    # -- rate models and serving ---------------------------------------------

    def baseline_perf_model(self) -> PUDPerfModel:
        """The uncalibrated B_{3,0,0} Table-I operating point."""
        return PUDPerfModel(error_free_frac=1 - ECR_BASELINE_B300)

    def tuned_perf_model(self) -> "FleetPerfModel | PUDPerfModel":
        """The calibrated device's rate model: the pinned operating point
        of an ``at_operating_point`` session, the measured per-subarray
        table when calibrated, the Table-I T_{2,1,0} constant otherwise."""
        if self._operating_point is not None:
            return PUDPerfModel(error_free_frac=1 - self._operating_point)
        if self._state is not None:
            return FleetPerfModel.from_table(self._state.ecr,
                                             n_fracs=self.n_fracs)
        return PUDPerfModel(error_free_frac=1 - ECR_PUDTUNE_T210)

    def placement_perf_model(self) -> FleetPerfModel | None:
        """Rate from the actual column placement (occupied-subarray waves);
        None when serving on logical columns or the placement is empty."""
        if self._placement is None or not self._placement.entries:
            return None
        return FleetPerfModel.from_placement(self._placement,
                                             n_fracs=self.n_fracs)

    def flops_per_token(self) -> float | None:
        """2 x active params of the session's arch (one MAC = 2 flops)."""
        if self.arch is None:
            return None
        from repro_torch.configs import get
        return 2.0 * get(self.arch).n_active_params

    def tokens_per_second(self, flops_per_token: float | None = None) -> float:
        flops = flops_per_token or self.flops_per_token()
        if flops is None:
            raise ValueError("no arch on this session: pass flops_per_token")
        return self.tuned_perf_model().tokens_per_second(flops)

    def optimal_batch_size(self, max_batch: int | None = None) -> int:
        """Occupancy-derived serving batch: the placement-derived (else the
        table-derived) rate model's optimum, 1 without a fleet model."""
        pm = self.placement_perf_model() or self.tuned_perf_model()
        if isinstance(pm, FleetPerfModel):
            return pm.optimal_batch_size(max_batch)
        return 1

    def serving_engine(self, model, *, max_len: int,
                       batch_size: int | None = None,
                       chunk_prefill: int | None = None,
                       prefix_cache=False, slo=None, **kw):
        """A continuous-batching ``ServingEngine`` over this session's
        packed model (``pack`` must have run); ``batch_size`` defaults to
        ``optimal_batch_size()``.

        The scheduler extensions pass through (``runtime/engine.py``):
        ``chunk_prefill`` interleaves fixed-size prefill chunks with decode
        waves, ``prefix_cache`` reuses completed prefills across requests,
        ``slo`` admits by deadline on this session's modeled step time;
        ``**kw`` (``collect_logits``, ``heartbeat``, ``prefill_budget``,
        ...) too."""
        from repro_torch.runtime.engine import ServingEngine
        if self._packed is None:
            raise RuntimeError("no packed model: call session.pack() first")
        return ServingEngine(model, self._packed.params, session=self,
                             max_len=max_len, batch_size=batch_size,
                             chunk_prefill=chunk_prefill,
                             prefix_cache=prefix_cache, slo=slo, **kw)

    def perf_report(self, flops_per_token: float | None = None,
                    batch_size: int | None = None) -> dict:
        """Calibration status, the Eq.-1 rate models, the placement
        occupancy report and, with ``batch_size``, the batch-aware
        aggregate rates."""
        base, tune = self.baseline_perf_model(), self.tuned_perf_model()
        rep: dict = {
            "device_id": self.device_id,
            "backend": self.backend,
            "n_subarrays": self.fleet_cfg.n_subarrays_total,
            "n_fracs": self.n_fracs,
            "calibrated": self._state is not None,
            "cache_hit": (self._state.cache_hit if self._state else None),
            "mean_ecr": (self._state.mean_ecr if self._state
                         else self._operating_point),
            "baseline_model": base,
            "tuned_model": tune,
            "gain": tune.speedup_vs(base),
            "placement": (self._placement.capacity_report()
                          if self._placement is not None else None),
            "placement_status": self._placement_status,
            "placement_model": self.placement_perf_model(),
        }
        flops = flops_per_token or self.flops_per_token()
        if flops is not None:
            rep["flops_per_token"] = flops
            rep["baseline_tok_s"] = base.tokens_per_second(flops)
            rep["tuned_tok_s"] = tune.tokens_per_second(flops)
            if rep["placement_model"] is not None:
                rep["placed_tok_s"] = \
                    rep["placement_model"].tokens_per_second(flops)
            if self._packed is not None and isinstance(tune, FleetPerfModel):
                stored = packed_bytes(self._packed)["stored_bytes"]
                rep["weight_bytes_per_token"] = stored
                rep["staging_bound_tok_s"] = \
                    tune.staging_bound_tokens_per_second(stored)
                rep["traffic_aware_tok_s"] = \
                    tune.traffic_aware_tokens_per_second(flops, stored)
        if batch_size is not None:
            rep["batch_size"] = int(batch_size)
            rep["optimal_batch"] = self.optimal_batch_size()
            pm = self.placement_perf_model() or tune
            if isinstance(pm, FleetPerfModel):
                rep["batch_speedup"] = pm.batch_speedup(batch_size)
                if flops is not None:
                    rep["batched_tok_s"] = pm.batched_tokens_per_second(
                        flops, batch_size)
        return rep

    # -- reporting ------------------------------------------------------------

    def decode_extras(self) -> dict:
        """Decode-path diagnostics of the last ``pack``: layout, byte
        accounting and the packing report."""
        if self._packed is None:
            raise RuntimeError("no packed model: call session.pack() first")
        return {
            "backend": self.backend,
            "layout": ("placed physical" if self._packed.placed
                       else "logical"),
            "weight_bits": self._packed.weight_bits,
            "n_packed": len(self._packed.packed_names),
            "report": self._packed.report,
            **packed_bytes(self._packed),
            **weight_traffic(self._packed),
        }



def _leaves_to(tree: dict, device: torch.device) -> dict:
    """``tree`` with its plain tensors on ``device`` (packs stay put)."""
    out = {}
    for key, sub in tree.items():
        if isinstance(sub, dict):
            out[key] = _leaves_to(sub, device)
        elif isinstance(sub, torch.Tensor):
            out[key] = sub.to(device)
        else:
            out[key] = sub
    return out


class PUDFleetSession:
    """A mesh-shaped grid of ``PUDSession``s serving one sharded model.

    ``sessions[d][m]`` is the device at data lane ``d``, model shard ``m``,
    each with its own device id, and so its own calibration-cache entry,
    placements, canaries and drift state.

    The "model" axis carries tensor parallelism: every packable
    projection's N columns split on full-tensor window-block boundaries
    (``pud.placement.shard_column_slices``, checked by
    ``analysis.contracts.check_shard_slices``), so shard ``m`` owns whole
    placement windows, plans them on its own masks and runs its slice on
    its own device (``kernels.ops.pud_matmul_sharded``, bit-exact against
    the unsharded path).  The "data" axis carries independent serving
    lanes: :meth:`pack` builds one ``PackedModel`` of
    ``ShardedPackedTensor``s per lane (its plain tensors on the lane's
    shard-0 device) and :meth:`serving_engine` runs one ``ServingEngine``
    per lane (``runtime.engine.FleetServingEngine``).

    Build one with :meth:`PUDSession.open_fleet`.
    """

    def __init__(self, sessions, *, mesh=None, arch: str | None = None):
        if not sessions or not sessions[0]:
            raise ValueError("open_fleet needs at least one session")
        self.sessions = sessions
        self.mesh = mesh
        self.arch = arch
        self.n_data = len(sessions)
        self.n_model = len(sessions[0])
        self._packs: "list[PackedModel] | None" = None
        self._pack_cfg: PUDGemvConfig | None = None
        self._pack_args = None          # (params, name, include_unembed)
        self._shard_widths: tuple[int, ...] | None = None
        self._tuning_report: dict | None = None

    # -- grid views ----------------------------------------------------------

    @property
    def n_devices(self) -> int:
        return self.n_data * self.n_model

    @property
    def device_ids(self) -> list:
        return [[s.device_id for s in row] for row in self.sessions]

    @property
    def shard_widths(self) -> "tuple[int, ...] | None":
        """Total N columns each model shard owns (set by :meth:`pack`)."""
        return self._shard_widths

    @property
    def packs(self) -> "list[PackedModel] | None":
        return self._packs

    def shard(self, data_lane: int, model_shard: int) -> PUDSession:
        return self.sessions[data_lane][model_shard]

    # -- lifecycle -----------------------------------------------------------

    def calibrate(self, force: bool = False) -> list:
        """Calibrate every device; returns the [n_data][n_model] states."""
        return [[s.calibrate(force) for s in row] for row in self.sessions]

    def reserve_canaries(self, n_per_subarray: int = 16) -> list:
        return [[s.reserve_canaries(n_per_subarray) for s in row]
                for row in self.sessions]

    def flops_per_token(self) -> float | None:
        return self.sessions[0][0].flops_per_token()

    def optimal_batch_size(self, max_batch: int | None = None) -> int:
        """The minimum over devices, so every lane's engine sustains it."""
        return min(s.optimal_batch_size(max_batch)
                   for row in self.sessions for s in row)

    # -- placement + packing -------------------------------------------------

    def _shard_requests(self, reqs):
        """Per-shard sliced request lists and per-shard total widths.

        Every request splits on its own full-tensor window-block
        boundaries (``shard_column_slices``), checked by
        ``check_shard_slices`` before any planning; a zero-width shard
        gets no request for that tensor.
        """
        from repro_torch.analysis.contracts import check_shard_slices
        sliced = [[] for _ in range(self.n_model)]
        widths = [0] * self.n_model
        for r in reqs:
            spans, bc = shard_column_slices(r.n_cols, self.n_model)
            check_shard_slices(spans, r.n_cols, bc)
            for m, (lo, hi) in enumerate(spans):
                widths[m] += hi - lo
                if hi > lo:
                    sliced[m].append(dataclasses.replace(
                        r, n_cols=hi - lo, block_cols=bc))
        return sliced, tuple(widths)

    def _plan_shard(self, data_lane: int, model_shard: int, sliced,
                    name: str | None) -> Placement | None:
        s = self.sessions[data_lane][model_shard]
        s._placement_status = s._placement_error = None
        s._placement = None
        if not (s.placement_enabled and s._state is not None):
            return None
        base = (f"{name or self.arch or 'model'}"
                f"-shard{model_shard}of{self.n_model}")
        return s._plan_requests(sliced, base)

    def _pack_lane(self, data_lane: int, params: dict, placements,
                   sliced, cfg, include_unembed: bool) -> PackedModel:
        """One lane's sharded pack; a live shard without a placement makes
        the whole lane logical (a lane's shards share one layout)."""
        if placements is not None and any(
                placements[m] is None
                for m in range(self.n_model) if sliced[m]):
            placements = None
        row = self.sessions[data_lane]
        pm = pack_model_sharded(
            params, cfg, n_shards=self.n_model, placements=placements,
            include_unembed=include_unembed,
            devices=[s.device for s in row])
        return dataclasses.replace(pm, params=_leaves_to(pm.params,
                                                         row[0].device))

    def pack(self, params: dict, cfg: PUDGemvConfig | None = None, *,
             name: str | None = None,
             include_unembed: bool = True) -> "list[PackedModel]":
        """Pack one sharded ``PackedModel`` per data lane.

        Each lane's model shards plan their own column slice of every
        request on their own masks (placement names
        ``<name>-shard{m}of{M}-...``).  If any live shard of a lane cannot
        place (uncalibrated, placement off, or the plan does not fit), the
        whole lane packs the logical sharded layout.
        """
        if cfg is None:
            cfg = PUDGemvConfig(backend=self.sessions[0][0].backend)
        elif cfg.backend is None:
            cfg = dataclasses.replace(
                cfg, backend=self.sessions[0][0].backend)
        reqs = packing_requests(params, cfg, include_unembed)
        sliced, self._shard_widths = self._shard_requests(reqs)
        packs = []
        for d in range(self.n_data):
            placements = [self._plan_shard(d, m, sliced[m], name)
                          for m in range(self.n_model)]
            packs.append(self._pack_lane(d, params, placements, sliced, cfg,
                                         include_unembed))
        self._packs, self._pack_cfg = packs, cfg
        self._pack_args = (params, name, include_unembed)
        return packs

    def repack_lane(self, data_lane: int, *,
                    changed_model: int | None = None) -> PackedModel:
        """Rebuild one lane's sharded pack from its shards' current state.

        With ``changed_model`` (the drift-recovery path) only that shard
        plans again; every other shard of the lane reuses its
        ``Placement`` object as it is.
        """
        if self._packs is None or self._pack_args is None:
            raise RuntimeError("no packed fleet: call pack() first")
        params, name, include_unembed = self._pack_args
        cfg = self._pack_cfg
        reqs = packing_requests(params, cfg, include_unembed)
        sliced, self._shard_widths = self._shard_requests(reqs)
        placements = []
        for m in range(self.n_model):
            s = self.sessions[data_lane][m]
            if (changed_model is not None and m != changed_model
                    and s._placement is not None):
                placements.append(s._placement)   # untouched shard: reuse
            else:
                placements.append(
                    self._plan_shard(data_lane, m, sliced[m], name))
        pm = self._pack_lane(data_lane, params, placements, sliced, cfg,
                             include_unembed)
        self._packs[data_lane] = pm
        return pm

    def recalibrate_shard(self, model_shard: int, subarrays, sense_offsets,
                          *, data_lane: int = 0,
                          assumed_temp_c: float | None = None):
        """Route a drift event to the owning shard only.

        Partial recalibration on ``sessions[data_lane][model_shard]``
        (``PUDSession.recalibrate_subarrays``), then that shard's slice
        plans again and the lane's sharded pack is rebuilt.  Every other
        shard's table, placement and canaries are not read.  Returns the
        refreshed lane pack (also in :attr:`packs`), or the refreshed
        ``CalibrationState`` when the fleet has not packed yet.
        """
        s = self.sessions[data_lane][model_shard]
        state = s.recalibrate_subarrays(subarrays, sense_offsets,
                                        assumed_temp_c=assumed_temp_c)
        if self._packs is None:
            return state
        return self.repack_lane(data_lane, changed_model=model_shard)

    # -- kernel autotuning ---------------------------------------------------

    def tune(self, *, batches=(1, 8), force: bool = False, warmup: int = 1,
             reps: int = 5, max_candidates: int = MAX_CANDIDATES) -> dict:
        """Autotune the per-shard kernel geometry and stamp every lane.

        Every shard of a pack has the same padded per-device shape, so one
        search per (pack, batch), on shard (0, 0)'s first layer, covers
        the mesh.  Keys carry the padded per-shard width ``Np``, so they
        differ from the unsharded session's.  Winners persist in shard
        (0, 0)'s tuning cache.  A lane whose placed windows are wider than
        a plan admits keeps the heuristic for that pack (the contract
        checker decides).  Needs the GPU, as ``PUDSession.tune``.
        """
        if self._packs is None:
            raise RuntimeError("no packed fleet: call pack() first")
        s0 = self.sessions[0][0]
        if s0.device.type != "cuda":
            raise RuntimeError(
                f"PUDFleetSession.tune: the fleet runs on {s0.device}; "
                "tuning times the CUDA kernels and needs the GPU")
        cache = s0._tuning_cache()
        mode = (self._pack_cfg or PUDGemvConfig()).mode
        report: dict = {"fingerprint": cache.fingerprint if cache else None,
                        "cache_dir": str(cache.directory) if cache else None,
                        "keys": {}}
        tile_plans: dict[str, tuple] = {}
        for pname, st in self._packs[0].tensors.items():
            pt = st.shards[0]
            if pt.planes.dim() == 4:               # stacked layers
                pt = pt.layer(0)
            plans = {}
            for batch in batches:
                batch = int(batch)
                entry = "gemm" if batch > 1 else "gemv"
                key = tuning_key(entry, batch, pt.k, pt.n, pt.n_bits,
                                 pt.layout, pt.placed)
                row = {"name": pname, "entry": entry, "batch": batch,
                       "row_class": row_class(batch)}
                plan = None if (force or cache is None) else cache.load(key)
                if plan is not None and s0._plan_fits(plan, entry, batch,
                                                      pt.planes, pt):
                    row.update(status="hit",
                               **cache.load_entry(key)["stats"])
                else:
                    x = ((torch.arange(batch * pt.k, device=s0.device)
                          % 255) - 127).to(torch.int8).reshape(batch, pt.k)
                    res = tune_kernel(
                        entry, x, pt.planes, col_ids=pt.col_ids,
                        window_block=pt.window_block, layout=pt.layout,
                        logical_k=pt.logical_k, mode=mode,
                        backend=s0.backend, warmup=warmup, reps=reps,
                        max_candidates=max_candidates)
                    plan = res.plan
                    row.update(status="tuned", **res.to_stats())
                    if cache is not None:
                        cache.save(key, plan, res.to_stats())
                row["plan"] = plan.to_dict()
                report["keys"][key] = row
                plans[row_class(batch)] = (entry, batch, plan)
            tile_plans[pname] = plans
        for d, pm in enumerate(self._packs):
            stamped = {}
            for n, plans in tile_plans.items():
                st = pm.tensor(n)
                pt = st.shards[0]
                pt = pt.layer(0) if pt.planes.dim() == 4 else pt
                fits = tuple(sorted(
                    (cls, plan) for cls, (entry, batch, plan) in plans.items()
                    if s0._plan_fits(plan, entry, batch, pt.planes, pt)))
                stamped[n] = st.replace(tile_plan=fits or None)
            self._packs[d] = _restamp_model(pm, stamped)
        self._tuning_report = report
        return report

    def tuning_report(self) -> dict | None:
        return self._tuning_report

    # -- execution + reporting -----------------------------------------------

    def serving_engine(self, model, *, max_len: int,
                       batch_size: int | None = None,
                       chunk_prefill: int | None = None,
                       prefix_cache=False, slo=None, **kw):
        """A ``FleetServingEngine``: one continuous-batching lane per
        "data" row, tensor parallelism inside each lane's packs.  The
        scheduler extensions pass through to every lane
        (``prefix_cache=True`` builds one cache per lane, and ``submit``
        routes by cache affinity before round-robin)."""
        from repro_torch.runtime.engine import FleetServingEngine
        if self._packs is None:
            raise RuntimeError("no packed fleet: call pack() first")
        return FleetServingEngine(
            model, [pm.params for pm in self._packs], fleet=self,
            max_len=max_len, batch_size=batch_size,
            chunk_prefill=chunk_prefill, prefix_cache=prefix_cache,
            slo=slo, **kw)

    def fleet_perf_model(self) -> FleetPerfAggregate:
        """The aggregate Eq.-1 rate model: the slowest device of each model
        shard bounds that shard, the slowest shard bounds every lane, and
        lanes add up (``pud.gemv.FleetPerfAggregate``)."""
        shards = []
        for m in range(self.n_model):
            worst = None
            for row in self.sessions:
                s = row[m]
                pm = s.placement_perf_model() or s.tuned_perf_model()
                if not isinstance(pm, FleetPerfModel):
                    pm = FleetPerfModel.from_table(
                        [1.0 - pm.error_free_frac])
                if worst is None or \
                        pm.macs_per_second < worst.macs_per_second:
                    worst = pm
            shards.append(worst)
        return FleetPerfAggregate(shards=tuple(shards), n_data=self.n_data,
                                  shard_widths=self._shard_widths)

    def perf_report(self, flops_per_token: float | None = None,
                    batch_size: int | None = None) -> dict:
        """Mesh shape, per-device reports and the aggregate rates: tokens/s
        over the whole fleet and the scaling efficiency against
        ``n_devices`` copies of shard (0, 0)."""
        agg = self.fleet_perf_model()
        flops = flops_per_token or self.flops_per_token()
        rep: dict = {
            "n_data": self.n_data,
            "n_model": self.n_model,
            "n_devices": self.n_devices,
            "device_ids": self.device_ids,
            "shard_widths": self._shard_widths,
            "shard_fraction": agg.shard_fraction,
            "aggregate_model": agg,
            "shards": [[s.perf_report(flops) for s in row]
                       for row in self.sessions],
        }
        if flops is not None:
            rep["flops_per_token"] = flops
            rep["aggregate_tok_s"] = agg.tokens_per_second(flops)
            rep["scaling_efficiency"] = agg.scaling_efficiency(flops)
            if batch_size is not None:
                rep["batch_size"] = int(batch_size)
                rep["aggregate_batched_tok_s"] = \
                    agg.batched_tokens_per_second(flops, batch_size)
        return rep
