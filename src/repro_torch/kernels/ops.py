"""Public entry points of the kernels (port of ``repro/kernels/ops.py``):
the six kernel entries under the reference's names and signatures (minus
``interpret``), activation quantization and the quantize -> GEMM ->
dequantize dispatch.

Every entry goes through the backend registry (kernels/backends.py): on the
default ``cuda`` backend a CUDA tensor launches the hand-written kernel and a
CPU tensor runs its plain version.  The GEMM entries keep the reference's
tile keywords (``b_block``, ``n_block``, ``k_block``): they name TPU tiles,
so they are accepted and ignored, as the reference's own oracle backend
ignores them; every tile gives the same integers.  The port's own launch
plans travel as ``tile_plan`` (``kernels/autotune.TunedPlan``) through
``pud_matmul``, which also pre-flights a call through the contract checker
(``analysis/contracts``) on ``check_contracts=True``.
"""
from __future__ import annotations

import torch

from repro_torch import devices
from repro_torch.pud.physics import PhysicsParams

from . import ref
from .autotune import (TunedPlan, plan_for_entry, row_class, tune_kernel,
                       tuning_key)
from .backends import DEFAULT_BACKEND, get_backend
from .placed_gemm import SMS

__all__ = [
    "majx_sense", "calib_iter_fused", "bitplane_gemv",
    "bitplane_gemv_placed", "bitplane_gemm", "bitplane_gemm_placed",
    "pud_matmul", "pud_matmul_sharded", "pud_gemv", "pud_gemv_ref",
    "quantize_activations",
    "N_BLOCK", "largest_divisor",
    # the autotuner's surface (kernels/autotune.py)
    "TunedPlan", "plan_for_entry", "row_class", "tune_kernel", "tuning_key",
]

#: Logical columns per N tile of the reference kernels; placement blocks
#: its windows on the same width (pud/placement.py ``PLACE_BLOCK``).
N_BLOCK = 256


def largest_divisor(dim: int, cap: int) -> int:
    """Largest block size <= cap that divides dim (>= 1)."""
    for d in range(min(dim, cap), 0, -1):
        if dim % d == 0:
            return d
    return 1


def quantize_activations(x: torch.Tensor
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 quantization; returns (q int8, scale in the
    dtype of ``x``).  Round half to even, like the reference.  Constants
    are tensors on ``x``'s device (a CPU-scalar divisor would turn CUDA's
    division into a reciprocal multiply)."""
    eps = torch.tensor(1e-6, dtype=x.dtype, device=x.device)
    d127 = torch.tensor(127.0, dtype=x.dtype, device=x.device)
    scale = torch.maximum(x.abs().amax(dim=-1, keepdim=True), eps) / d127
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def pud_matmul(
    x: torch.Tensor,              # [B, K] float activations
    planes: torch.Tensor,         # [WB, K(/8), N] bit-planes / bit-words
    w_scale: torch.Tensor,        # [N] dequant scale
    mode: str = "folded",
    col_ids: torch.Tensor | None = None,
    backend: str | None = None,
    layout: str = "dense",
    logical_k: int | None = None,
    window_block: int | None = None,
    check_contracts: bool = False,
    tile_plan=None,
) -> torch.Tensor:
    """Quantize -> bit-plane GEMM -> dequantize; returns [B, N] float32.

    B = 1 runs the GEMV entry, B > 1 the batch-tiled GEMM entry; with
    ``col_ids`` the placed entries.  The dequant is ``acc.float() * x_scale
    * w_scale`` in that order, as in the reference.

    ``tile_plan`` is a pack's stamp (a ``TunedPlan``, or ``(row class,
    TunedPlan)`` pairs; ``autotune.row_class`` of B picks one): the plan
    the kernel launches with instead of the heuristic's.  A plan the
    contract checker rejects for this call raises ``ContractViolation``,
    on every backend; it never gives way to the heuristic.
    ``check_contracts=True`` pre-flights every call through the checker,
    ``col_ids`` values included.
    """
    xq, x_scale = quantize_activations(x)
    be = get_backend(backend or DEFAULT_BACKEND)
    batched = xq.shape[0] > 1
    plan = plan_for_entry(tile_plan, row_class(xq.shape[0]))
    if plan is not None and plan.is_default():
        plan = None
    if check_contracts or plan is not None:
        from repro_torch.analysis.contracts import check_kernel_args
        n_cols = col_ids
        if col_ids is not None and not check_contracts:
            n_cols = int(col_ids.shape[-1])     # shapes only: no sync
        check_kernel_args(
            "gemm" if batched else "gemv", xq.shape, planes.shape,
            layout=layout, logical_k=logical_k, col_ids=n_cols,
            window_block=window_block, mode=mode, tuned=plan,
            sms=devices.sm_count(x.device) if x.is_cuda else SMS)
    kw = {"layout": layout, "logical_k": logical_k}
    if plan is not None:
        kw["tile_plan"] = plan
        mode = plan.mode or mode
    if col_ids is not None:
        entry = be.matmul_placed if batched else be.gemv_placed
        acc = entry(xq, planes, col_ids, mode, window_block=window_block,
                    **kw)
    else:
        entry = be.matmul if batched else be.gemv
        acc = entry(xq, planes, mode, **kw)
    return acc.to(torch.float32) * x_scale * w_scale


def pud_matmul_sharded(x: torch.Tensor, st, mode: str = "folded",
                       backend: str | None = None,
                       check_contracts: bool = False) -> torch.Tensor:
    """Tensor-parallel ``pud_matmul`` over a sharded pack: [B, K] float ->
    [B, N] float32 on ``x``'s device.

    ``st`` is a ``pud.packed.ShardedPackedTensor`` (duck-typed, so the
    kernel layer does not import ``pud``).  For each shard that owns
    columns, ``x`` is copied to the shard's device, the ordinary
    ``pud_matmul`` runs on that shard's planes, scale, ``col_ids`` and
    launch plan, and the [B, Np] result comes back to ``x``'s device,
    cut to the shard's width; the parts concatenate in shard order.

    Bit-exact against the unsharded path by construction: activation
    quantization is per row (the same on every shard), each output
    column's integer accumulation reads the same K values, and the
    dequant ``acc * x_scale * w_scale`` is the same expression per column;
    no float crosses a shard boundary.  One process, no collectives: a
    gather by static column slices needs none.
    """
    if st.devices is None:
        raise ValueError(
            "sharded pack carries no devices — build it through "
            "PUDFleetSession.pack / pack_model_sharded(devices=...)")
    parts = []
    for shard, width, dev in zip(st.shards, st.shard_widths, st.devices):
        if not width:
            continue
        y = pud_matmul(x.to(dev), shard.planes, shard.scale, mode=mode,
                       col_ids=shard.col_ids,
                       backend=backend or st.backend, layout=shard.layout,
                       logical_k=shard.logical_k,
                       window_block=shard.window_block,
                       check_contracts=check_contracts,
                       tile_plan=(shard.tile_plan
                                  if shard.tile_plan is not None
                                  else st.tile_plan))
        parts.append(y.to(x.device)[:, :width])
    return torch.cat(parts, dim=-1)


def majx_sense(charge: torch.Tensor, sense_offset: torch.Tensor,
               noise: torch.Tensor, params: PhysicsParams = PhysicsParams(),
               n_fracs: int = 0) -> torch.Tensor:
    """Sensed bits [T, C] float32 of T SiMRA events: charge [T, R, C],
    sense_offset [C], noise [T, C] standard normal, all float32."""
    return get_backend(DEFAULT_BACKEND).majx_sense(charge, sense_offset,
                                                   noise, params, n_fracs)


def calib_iter_fused(inputs: torch.Tensor, noise: torch.Tensor,
                     levels: torch.Tensor, sense_offset: torch.Tensor,
                     params: PhysicsParams, n_fracs: int,
                     level_qsum: tuple[float, ...],
                     level_swing: tuple[float, ...], threshold: float,
                     maj_inputs: int = 5, const_charge_sum: float = 0.0,
                     const_swing_sq: float = 0.0
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """One fused Algorithm-1 iteration; returns (new levels [C] int32, bias
    [C] float32).  ``inputs`` [S, M, C] are operand bits: uint8, or float
    as the reference passes them (cast to uint8 first, exact for 0/1)."""
    if inputs.is_floating_point():
        inputs = inputs.to(torch.uint8)
    return get_backend(DEFAULT_BACKEND).calib_iter(
        inputs, noise, levels, sense_offset, params, n_fracs, level_qsum,
        level_swing, threshold, maj_inputs, const_charge_sum, const_swing_sq)


def bitplane_gemv(x: torch.Tensor, planes: torch.Tensor,
                  mode: str = "planes", layout: str = "dense",
                  logical_k: int | None = None, n_block: int | None = None,
                  k_block: int | None = None) -> torch.Tensor:
    """[B, K] int8 x planes -> [B, N] int32.  B = 1 runs the GEMV kernel;
    a larger block of rows, which the reference's GEMV also takes, runs
    the batch-tiled kernel (the same integers)."""
    be = get_backend(DEFAULT_BACKEND)
    entry = be.gemv if x.shape[0] == 1 else be.matmul
    return entry(x, planes, mode, layout=layout, logical_k=logical_k)


def bitplane_gemv_placed(x: torch.Tensor, planes: torch.Tensor,
                         col_ids: torch.Tensor, mode: str = "planes",
                         layout: str = "dense", logical_k: int | None = None,
                         window_block: int | None = None,
                         n_block: int | None = None,
                         k_block: int | None = None) -> torch.Tensor:
    """Placed GEMV over the physical window; rows as ``bitplane_gemv``."""
    be = get_backend(DEFAULT_BACKEND)
    entry = be.gemv_placed if x.shape[0] == 1 else be.matmul_placed
    return entry(x, planes, col_ids, mode, layout=layout,
                 logical_k=logical_k, window_block=window_block)


def bitplane_gemm(x: torch.Tensor, planes: torch.Tensor,
                  mode: str = "planes", layout: str = "dense",
                  logical_k: int | None = None, b_block: int | None = None,
                  n_block: int | None = None,
                  k_block: int | None = None) -> torch.Tensor:
    """Batch-tiled GEMM: [B, K] int8 x planes -> [B, N] int32."""
    return get_backend(DEFAULT_BACKEND).matmul(x, planes, mode, layout=layout,
                                             logical_k=logical_k)


def bitplane_gemm_placed(x: torch.Tensor, planes: torch.Tensor,
                         col_ids: torch.Tensor, mode: str = "planes",
                         layout: str = "dense", logical_k: int | None = None,
                         window_block: int | None = None,
                         b_block: int | None = None,
                         n_block: int | None = None,
                         k_block: int | None = None) -> torch.Tensor:
    """Batch-tiled placed GEMM over the physical window."""
    return get_backend(DEFAULT_BACKEND).matmul_placed(
        x, planes, col_ids, mode, layout=layout, logical_k=logical_k,
        window_block=window_block)


def pud_gemv(x: torch.Tensor, planes: torch.Tensor, w_scale: torch.Tensor,
             mode: str = "folded", col_ids: torch.Tensor | None = None,
             backend: str | None = None, layout: str = "dense",
             logical_k: int | None = None, window_block: int | None = None,
             check_contracts: bool = False,
             tile_plan=None) -> torch.Tensor:
    """Rank-dispatching shim over ``pud_matmul``: ``x`` [K] returns [N],
    ``x`` [B, K] behaves exactly like ``pud_matmul``."""
    kw = dict(mode=mode, col_ids=col_ids, backend=backend, layout=layout,
              logical_k=logical_k, window_block=window_block,
              check_contracts=check_contracts, tile_plan=tile_plan)
    if x.dim() == 1:
        return pud_matmul(x[None, :], planes, w_scale, **kw)[0]
    return pud_matmul(x, planes, w_scale, **kw)


def pud_gemv_ref(x: torch.Tensor, planes: torch.Tensor,
                 w_scale: torch.Tensor,
                 col_ids: torch.Tensor | None = None) -> torch.Tensor:
    """The oracle of ``pud_matmul`` on dense [WB, K, N|W] planes: quantize,
    the plain bit-plane GEMV (placed through ``col_ids``), dequantize."""
    xq, x_scale = quantize_activations(x)
    if col_ids is not None:
        acc = ref.bitplane_gemv_placed_ref(xq, planes, col_ids)
    else:
        acc = ref.bitplane_gemv_ref(xq, planes)
    return acc.to(torch.float32) * x_scale * w_scale
