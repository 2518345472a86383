"""PUD GeMV serving path: low-bit linear layers in the bit-plane layout
(port of ``repro/pud/gemv.py``, single device).

Two halves:

  * numerics (``pack_linear``, ``pud_linear``): exact low-bit integer GEMM
    through the bit-plane kernels, plus the weight-traffic accounting;
  * the DDR4 rate models (``PUDPerfModel``, ``FleetPerfModel``): what the
    paper's 4-channel DDR4 system would sustain for those GEMVs, from the
    bit-serial MAC command counts priced on the timing model and scaled by
    the measured error-free column fraction.  Pure host arithmetic, with
    the reference's numbers.  The multi-device aggregate is not ported.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels.ops import pud_matmul
from repro_torch.kernels.ref import pack_bitplanes, pack_plane_words

from .bitserial import add8_counts, mul8_counts
from .packed import LAYOUT_BITPACK, PackedTensor, packed_bytes
from .timing import OpCounts, SystemConfig, wave_latency_ns

# Default packable set: FFN projections.  Entries are "scope.name" (scope =
# any path component) or a bare name.
FFN_PACKABLE = ("mixer.wi", "mixer.wg", "mixer.wo")
# Attention projections (head axes flattened to one column axis).
ATTN_PACKABLE = ("attn.wq", "attn.wk", "attn.wv", "attn.wo")

# Table-I operating points: ECR of the uncalibrated B_{3,0,0} baseline vs
# the calibrated T_{2,1,0} ladder.
ECR_BASELINE_B300 = 0.466
ECR_PUDTUNE_T210 = 0.033


@dataclasses.dataclass(frozen=True)
class PUDGemvConfig:
    weight_bits: int = 4
    mode: str = "folded"         # "planes" (faithful) | "folded" (optimized)
    packable: tuple[str, ...] = FFN_PACKABLE
    # Named execution backend (kernels/backends.py); None = the pack's own.
    backend: str | None = None


def pack_linear(w: torch.Tensor, n_bits: int = 4, backend: str | None = None,
                bitpack: bool = True) -> PackedTensor:
    """[K, N] float weights -> per-output-channel-quantized bit-planes.

    Symmetric per channel in the weights' own dtype: scale = max|w| / qmax,
    q = clip(round(w / scale)) (round half to even), as the reference does
    when it packs eagerly.  ``bitpack=True`` stores [WB, ceil(K/8), N] uint8
    words, otherwise dense [WB, K, N] int8 planes.
    """
    qmax = (1 << (n_bits - 1)) - 1
    eps = torch.tensor(1e-8, dtype=w.dtype, device=w.device)
    div = torch.tensor(float(qmax), dtype=w.dtype, device=w.device)
    scale = torch.maximum(w.abs().amax(dim=0), eps) / div          # [N]
    q = torch.clamp(torch.round(w / scale[None, :]), -qmax - 1, qmax)
    planes = pack_bitplanes(q.to(torch.int32), n_bits)
    if not bitpack:
        return PackedTensor(planes=planes, scale=scale.to(torch.float32),
                            backend=backend)
    return PackedTensor(planes=pack_plane_words(planes),
                        scale=scale.to(torch.float32), backend=backend,
                        layout=LAYOUT_BITPACK, logical_k=w.shape[0])


def pud_linear(x: torch.Tensor, packed: PackedTensor,
               cfg: PUDGemvConfig = PUDGemvConfig(),
               backend: str | None = None) -> torch.Tensor:
    """x [..., K] float -> [..., N] float32 through the bit-plane GEMM.

    Backend resolution: ``backend`` > ``cfg.backend`` > the pack's stamp >
    the default (``cuda``).
    """
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    y = pud_matmul(x2, packed.planes, packed.scale, mode=cfg.mode,
                   col_ids=packed.col_ids,
                   backend=backend or cfg.backend or packed.backend,
                   layout=packed.layout, logical_k=packed.logical_k,
                   window_block=packed.window_block)
    return y.reshape(lead + (y.shape[-1],))


# Peak weight-staging bandwidth of the paper's 4-channel DDR4-2133 system
# (8 B/transfer x 2133 MT/s per channel) — the reference's constant.
WEIGHT_STAGING_BW_BYTES_S = 4 * 8 * 2133e6


def weight_traffic(packed) -> dict:
    """Per-token weight-traffic terms of a packed serving tree."""
    stats = packed_bytes(packed)
    stored = stats["stored_bytes"]
    dense = stats["dense_equiv_bytes"]
    return {
        "stored_bytes_per_token": stored,
        "dense_equiv_bytes_per_token": dense,
        "traffic_reduction": dense / max(1, stored),
        "staging_bound_tok_s": WEIGHT_STAGING_BW_BYTES_S / max(1, stored),
    }


# ---------------------------------------------------------------------------
# DRAM-side performance model (Eq. 1 applied to GeMV).
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PUDPerfModel:
    """Sustained GeMV rate of the PUD system for one calibrated device.

    Each of a [K, N] GeMV's K*N MACs (b-bit weights, 8-bit activations) is
    one column's bit-serial MUL8 + accumulate-ADD8 graph; a 65,536-column
    wave executes error_free_frac * 65,536 MACs per sequence.
    """

    error_free_frac: float
    n_fracs: int = 3                  # T_{2,1,0}
    sys: SystemConfig = dataclasses.field(default_factory=SystemConfig)

    @property
    def macs_per_second(self) -> float:
        mac_counts = mul8_counts(self.n_fracs) + add8_counts(self.n_fracs)
        lat_s = wave_latency_ns(mac_counts, self.sys) * 1e-9
        cols = self.error_free_frac * self.sys.n_cols_per_subarray
        return cols * self.sys.n_banks_parallel * self.sys.n_channels / lat_s

    def gemv_latency_s(self, k: int, n: int) -> float:
        return (k * n) / self.macs_per_second

    def tokens_per_second(self, flops_per_token: float) -> float:
        """flops_per_token = 2 * active params (one MAC = 2 flops)."""
        return self.macs_per_second / (flops_per_token / 2.0)

    def speedup_vs(self, baseline: "PUDPerfModel") -> float:
        return self.macs_per_second / baseline.macs_per_second

    def step_seconds(self, flops_per_token: float, batch: int = 1) -> float:
        """Modeled wall seconds of one batched decode wave (no batching
        gain on a single operating point)."""
        return max(1, int(batch)) / self.tokens_per_second(flops_per_token)


@dataclasses.dataclass(frozen=True)
class FleetPerfModel:
    """Serving-rate model for a whole calibrated device grid.

    Built from the per-subarray ECR of a calibration table (waves rotate
    uniformly over the grid: mean error-free fraction) or from a column
    placement (waves over the occupied subarrays).  Batched decode:

      * replication: a placement occupying ``occupied_subarrays`` of
        ``total_subarrays`` leaves room for ``n_replicas`` copies of the
        placed weights, serving that many requests fully in parallel;
      * operand amortization: within a replica the weight-side staging
        copies of each MAC's partial products are paid once per wave;
      * operand residency: a subarray stages at most ``operand_slots``
        operand vectors per wave, so aggregate throughput stops improving
        past ``n_replicas * operand_slots`` requests
        (``optimal_batch_size``).
    """

    error_free_fracs: tuple[float, ...]      # per subarray
    n_fracs: int = 3
    sys: SystemConfig = dataclasses.field(default_factory=SystemConfig)
    occupied_subarrays: int | None = None
    total_subarrays: int | None = None
    operand_slots: int = 4

    @classmethod
    def from_table(cls, ecr_per_subarray, n_fracs: int = 3,
                   sys: SystemConfig | None = None) -> "FleetPerfModel":
        """From a table's per-subarray ECR; ``1 - ecr`` rounds in the
        table's own dtype (float32), as the reference computes it."""
        ecr = torch.as_tensor(ecr_per_subarray)
        fracs = tuple(float(f) for f in (1.0 - ecr).cpu().tolist())
        return cls(error_free_fracs=fracs, n_fracs=n_fracs,
                   sys=sys or SystemConfig())

    @classmethod
    def from_placement(cls, placement, n_fracs: int = 3,
                       sys: SystemConfig | None = None) -> "FleetPerfModel":
        """Rate from the actual column placement: waves rotate over the
        occupied subarrays, each executing the columns placed there."""
        used = np.asarray(placement.used_per_subarray, np.float64)
        occupied = used[used > 0]
        if occupied.size == 0:
            raise ValueError("placement occupies no subarray")
        fracs = tuple(float(u / placement.n_cols_per_subarray)
                      for u in occupied)
        return cls(error_free_fracs=fracs, n_fracs=n_fracs,
                   sys=sys or SystemConfig(),
                   occupied_subarrays=int(occupied.size),
                   total_subarrays=int(placement.n_subarrays))

    def _point(self, frac: float) -> PUDPerfModel:
        return PUDPerfModel(error_free_frac=frac, n_fracs=self.n_fracs,
                            sys=self.sys)

    @property
    def mean_error_free_frac(self) -> float:
        return sum(self.error_free_fracs) / len(self.error_free_fracs)

    @property
    def macs_per_second(self) -> float:
        return self._point(self.mean_error_free_frac).macs_per_second

    @property
    def worst_subarray_macs_per_second(self) -> float:
        return self._point(min(self.error_free_fracs)).macs_per_second

    def tokens_per_second(self, flops_per_token: float) -> float:
        return self.macs_per_second / (flops_per_token / 2.0)

    def speedup_vs(self, baseline: "PUDPerfModel | FleetPerfModel") -> float:
        return self.macs_per_second / baseline.macs_per_second

    def staging_bound_tokens_per_second(self, weight_bytes: float) -> float:
        """Weight-staging bandwidth ceiling: each decoded token restages
        every packed projection's stored bytes once."""
        return WEIGHT_STAGING_BW_BYTES_S / max(1.0, float(weight_bytes))

    def traffic_aware_tokens_per_second(self, flops_per_token: float,
                                        weight_bytes: float) -> float:
        """Decode rate under both the Eq.-1 compute rate and the
        weight-staging bound."""
        return min(self.tokens_per_second(flops_per_token),
                   self.staging_bound_tokens_per_second(weight_bytes))

    @property
    def n_replicas(self) -> int:
        """Independent weight copies the grid can hold in parallel."""
        if self.occupied_subarrays and self.total_subarrays:
            return max(1, self.total_subarrays // self.occupied_subarrays)
        return 1

    def _mac_counts_split(self) -> tuple[OpCounts, OpCounts]:
        """(shared, per-operand) command counts of one MAC's MUL8+ADD8
        graph: the weight-bit constant copy of each of the 72 AND/OR
        partial-product ops is shared across a batched wave."""
        total = mul8_counts(self.n_fracs) + add8_counts(self.n_fracs)
        n_andor = sum(2 * (8 - j) for j in range(8))
        shared = OpCounts(rowcopies=n_andor)
        per_op = OpCounts(rowcopies=total.rowcopies - n_andor,
                          fracs=total.fracs, simras=total.simras)
        return shared, per_op

    def batch_speedup(self, batch: int) -> float:
        """Aggregate-throughput gain of serving ``batch`` requests vs one:
        increasing up to ``optimal_batch_size()``, flat beyond it."""
        b = max(1, int(batch))
        b_eff = min(b, self.optimal_batch_size())
        active = min(self.n_replicas, b_eff)
        per_rep = b_eff / active
        shared, per_op = self._mac_counts_split()
        lat1 = wave_latency_ns(shared + per_op, self.sys)
        lat_b = wave_latency_ns(shared + per_rep * per_op, self.sys)
        return b_eff * lat1 / lat_b

    def batched_macs_per_second(self, batch: int) -> float:
        return self.macs_per_second * self.batch_speedup(batch)

    def batched_tokens_per_second(self, flops_per_token: float,
                                  batch: int) -> float:
        """Aggregate decode rate (all requests summed) at ``batch``."""
        return self.batched_macs_per_second(batch) / (flops_per_token / 2.0)

    def optimal_batch_size(self, max_batch: int | None = None) -> int:
        """Occupancy-derived optimum: replicas x per-subarray operand
        slots, the smallest batch reaching peak aggregate rate."""
        opt = self.n_replicas * self.operand_slots
        return min(opt, max_batch) if max_batch else opt

    def step_seconds(self, flops_per_token: float, batch: int = 1) -> float:
        """Modeled wall seconds of one batched decode wave."""
        b = max(1, int(batch))
        return b / self.batched_tokens_per_second(flops_per_token, b)
