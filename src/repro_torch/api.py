"""Public API surface of the PyTorch/CUDA port (port of ``repro/api.py``).

One import site for the serving stack: the session facade, the typed packs,
the execution-backend registry and the placement and config types they
speak.  ``__all__`` is the reference's, name for name, each bound to its
counterpart in the port.

    from repro_torch.api import PUDSession, PUDGemvConfig

    session = PUDSession.open("qwen3-1.7b", grid=FleetConfig(...),
                              cache_dir="~/.pud-cache")
    session.calibrate()
    packed = session.pack(params, PUDGemvConfig(weight_bits=4))
    y = session.linear(x, "unembed/w")
"""
from __future__ import annotations

from repro_torch.analysis.contracts import check_shard_slices
from repro_torch.core.calibrate import CalibrationConfig
from repro_torch.core.canary import CanarySet, drifted_offsets, probe_ecr
from repro_torch.core.fleet import (FleetConfig, load_or_calibrate,
                                    recalibrate_subarrays)
from repro_torch.core.reliability import DriftSimulator
from repro_torch.kernels.backends import (Backend, backend_names,
                                          get_backend, register_backend)
from repro_torch.pud.gemv import (ATTN_PACKABLE, ECR_BASELINE_B300,
                                  ECR_PUDTUNE_T210, FFN_PACKABLE,
                                  FleetPerfAggregate, FleetPerfModel,
                                  PUDGemvConfig, PUDPerfModel, pack_linear,
                                  pud_linear, weight_traffic)
from repro_torch.pud.packed import (LAYOUT_BITPACK, LAYOUT_DENSE,
                                    PackedModel, PackedTensor,
                                    ShardedPackedTensor, as_packed_tensor,
                                    load_packed_npz, packed_bytes,
                                    save_packed_npz, to_bitpacked, to_dense)
from repro_torch.pud.packer import (pack_for_serving, pack_model,
                                    pack_model_sharded, packing_requests)
from repro_torch.pud.physics import PhysicsParams
from repro_torch.pud.placement import (Placement, PlacementError,
                                       PlacementRequest, TensorPlacement,
                                       inject_read_faults,
                                       refresh_fault_state,
                                       shard_column_slices)
from repro_torch.runtime.calib_cache import CalibrationTableCache
from repro_torch.runtime.drift import (DriftConfig, DriftController,
                                       DriftDetector, DriftEvent,
                                       DriftMonitor, FleetDriftMonitor)
from repro_torch.runtime.engine import (Completion, FleetServingEngine,
                                        Request, ServingEngine, SLOConfig)
from repro_torch.runtime.prefix_cache import PrefixCache
from repro_torch.runtime.session import (CalibrationState, PUDFleetSession,
                                         PUDSession)
from repro_torch.runtime.watchdog import Heartbeat, StepWatchdog

__all__ = [
    # session lifecycle
    "PUDSession", "CalibrationState",
    # sharded multi-device serving fleet
    "PUDFleetSession", "FleetServingEngine", "FleetDriftMonitor",
    "FleetPerfAggregate", "ShardedPackedTensor", "pack_model_sharded",
    "shard_column_slices", "check_shard_slices",
    # batched serving
    "ServingEngine", "Request", "Completion",
    "PrefixCache", "SLOConfig",
    "StepWatchdog", "Heartbeat",
    # drift monitoring + live recalibration
    "DriftMonitor", "DriftController", "DriftDetector", "DriftConfig",
    "DriftEvent", "DriftSimulator", "CanarySet", "probe_ecr",
    "drifted_offsets", "recalibrate_subarrays", "refresh_fault_state",
    # configs
    "PUDGemvConfig", "FleetConfig", "CalibrationConfig", "PhysicsParams",
    "FFN_PACKABLE", "ATTN_PACKABLE",
    # typed packs + storage layouts
    "PackedTensor", "PackedModel", "as_packed_tensor", "packed_bytes",
    "pack_model", "packing_requests",
    "LAYOUT_BITPACK", "LAYOUT_DENSE", "to_bitpacked", "to_dense",
    "save_packed_npz", "load_packed_npz", "weight_traffic",
    # backends
    "Backend", "register_backend", "get_backend", "backend_names",
    # placement
    "Placement", "TensorPlacement", "PlacementRequest", "PlacementError",
    "inject_read_faults",
    # perf models + Table-I operating points
    "PUDPerfModel", "FleetPerfModel",
    "ECR_BASELINE_B300", "ECR_PUDTUNE_T210",
    # persistence + legacy shims
    "CalibrationTableCache", "load_or_calibrate",
    "pack_for_serving", "pack_linear", "pud_linear",
]
