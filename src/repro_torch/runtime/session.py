"""PUDSession: the PUD serving lifecycle behind one object (port of
``repro/runtime/session.py``, single device).

    session = PUDSession.open("qwen3-1.7b", grid=FleetConfig(...),
                              cache_dir="~/.pud-cache")
    state  = session.calibrate()            # cache hit or Algorithm 1
    packed = session.pack(params, cfg)      # placement-aware PackedModel
    extras = session.decode_extras()        # layout / bytes diagnostics
    engine = session.serving_engine(model, max_len=...)
    report = session.perf_report(flops_per_token)   # DDR4-PUD rate models

Calibration tables and placements persist in the reference's on-disk
formats, so either package reads what the other wrote.  The session runs
on ``cuda`` unless ``device="cpu"`` is passed; without a GPU it raises.
Per-call execution (``linear``), pinned operating points, canaries, live
recalibration, tuning and the multi-device fleet session are not ported
yet.
"""
from __future__ import annotations

import dataclasses
import time

import torch

from repro_torch.core.calibrate import CalibrationConfig
from repro_torch.core.fleet import FleetConfig, load_or_calibrate
from repro_torch.devices import resolve_device
from repro_torch.kernels.backends import DEFAULT_BACKEND, backend_names
from repro_torch.pud.gemv import (ECR_BASELINE_B300, ECR_PUDTUNE_T210,
                                  FleetPerfModel, PUDGemvConfig,
                                  PUDPerfModel, weight_traffic)
from repro_torch.pud.packed import PackedModel, packed_bytes
from repro_torch.pud.packer import pack_model, packing_requests
from repro_torch.pud.physics import PhysicsParams
from repro_torch.pud.placement import (Placement, PlacementError,
                                       plan_for_grid, requests_fingerprint)
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
        self._packed: PackedModel | None = None
        self._placement: Placement | None = None
        self._placement_name: str | None = None
        self._placement_status: str | None = None   # hit | planned | skipped
        self._placement_error: str | None = None

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

    # -- calibration --------------------------------------------------------

    @property
    def calibration(self) -> CalibrationState | None:
        return self._state

    @property
    def n_fracs(self) -> int:
        return sum(self.fleet_cfg.frac_counts)

    def calibrate(self, force: bool = False) -> CalibrationState:
        """Load the device's persisted table, or identify + persist it."""
        if self._state is not None and not force:
            return self._state
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t0 = time.time()
        levels, ecr, masks, hit = load_or_calibrate(
            self.cache if self.cache is not None else _NullCache(),
            self.device_id, self.seed, self.fleet_cfg, self.physics,
            config=self.calib_cfg, method=self.method,
            n_trials_ecr=self.n_trials_ecr, device=self.device)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._state = CalibrationState(
            levels=levels, ecr=ecr, masks=masks,
            cache_hit=bool(hit), wall_s=time.time() - t0)
        return self._state

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
        masks and persist.  A plan that does not fit is "skipped"."""
        pname = f"{base_name}-{requests_fingerprint(reqs)}"
        self._placement_name = pname
        placement = None
        if self.cache is not None:
            placement = self.cache.load_placement(
                self.device_id, self.fleet_cfg, self.physics, pname)
        if placement is not None:
            self._placement_status = "hit"
            self._placement = placement
            return placement
        masks = self._state.masks.cpu().numpy()
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
        self._packed = pm
        return pm

    # -- rate models and serving ---------------------------------------------

    def baseline_perf_model(self) -> PUDPerfModel:
        """The uncalibrated B_{3,0,0} Table-I operating point."""
        return PUDPerfModel(error_free_frac=1 - ECR_BASELINE_B300)

    def tuned_perf_model(self) -> "FleetPerfModel | PUDPerfModel":
        """The calibrated device's rate model: the measured per-subarray
        table when calibrated, the Table-I T_{2,1,0} constant otherwise."""
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
                       batch_size: int | None = None, **kw):
        """A continuous-batching ``ServingEngine`` over this session's
        packed model (``pack`` must have run); ``batch_size`` defaults to
        ``optimal_batch_size()``."""
        from repro_torch.runtime.engine import ServingEngine
        if self._packed is None:
            raise RuntimeError("no packed model: call session.pack() first")
        return ServingEngine(model, self._packed.params, session=self,
                             max_len=max_len, batch_size=batch_size, **kw)

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
            "mean_ecr": (self._state.mean_ecr if self._state else None),
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

