"""PUDSession: the PUD serving lifecycle behind one object (port of
``repro/runtime/session.py``, single device).

    session = PUDSession.open("qwen3-1.7b", grid=FleetConfig(...),
                              cache_dir="~/.pud-cache")
    state  = session.calibrate()            # cache hit or Algorithm 1
    packed = session.pack(params, cfg)      # placement-aware PackedModel
    extras = session.decode_extras()        # layout / bytes diagnostics

Calibration tables and placements persist in the reference's on-disk
formats, so either package reads what the other wrote.  The session runs
on ``cuda`` unless ``device="cpu"`` is passed; without a GPU it raises.
Rate models, per-call execution (``linear``), canaries, live
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
from repro_torch.pud.gemv import PUDGemvConfig, weight_traffic
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
                 calib: CalibrationConfig, seed: int, method: str, n_trials_ecr: int, device: torch.device):
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
             method: str = "fused",
             n_trials_ecr: int = 1024,
             device=None) -> "PUDSession":
        """Open a session on one device.

        ``arch_or_grid``: the architecture name this session serves (it
        names persisted placements) or the device's ``FleetConfig`` grid;
        pass the other via ``grid``.  ``cache_dir`` enables persistence.
        ``seed`` drives manufacture and calibration.  ``device`` defaults
        to the GPU and raises when there is none.
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
            seed=int(seed), method=method,
            n_trials_ecr=n_trials_ecr, device=resolve_device(device))

    # -- calibration --------------------------------------------------------

    @property
    def calibration(self) -> CalibrationState | None:
        return self._state

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
        layout when the session is calibrated and placement fits.  Packs
        are stamped with the session backend unless ``cfg`` names one."""
        if cfg is None:
            cfg = PUDGemvConfig(backend=self.backend)
        elif cfg.backend is None:
            cfg = dataclasses.replace(cfg, backend=self.backend)
        self._placement_status = self._placement_error = None
        self._placement = None
        if self._state is not None:
            self._placement = self._plan_requests(
                packing_requests(params, cfg, include_unembed),
                name or self.arch or "model")
        pm = pack_model(params, cfg, include_unembed=include_unembed,
                        placement=self._placement)
        self._packed = pm
        return pm

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

