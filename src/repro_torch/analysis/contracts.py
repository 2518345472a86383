"""Kernel contract checker: the port's CUDA launch plans, checked without a
launch (port of ``repro/analysis/contracts.py``, retargeted to Hopper).

Given a call's shapes and layout, it recomputes what the four bit-plane
entries (GEMV / GEMM x unplaced / placed) derive on the host and checks
the invariants their kernels assume:

  * **operands**: ``Kw == ceil(K / 8)`` words for bit-packed packs and
    ``logical_k`` consistent with x, dense planes with x's K, 1-8 planes;
  * **placed windows**: ``window_block`` tiles the window, each window
    block holds its logical block, and (when the values are given) every
    ``col_ids`` entry lies in its block's window slice;
  * **the launch plan**: ``kernels/placed_gemm.plan_launch`` or
    ``kernels/plane_gemm.plan_launch``, heuristic or tuned, held to a
    transcription of the kernels' own ``plan_ok`` (``csrc/placed_gemm.cu``,
    ``csrc/plane_gemm.cu``), one named invariant at a time: the compiled
    row instances (dp4a 1/4/8/16 placed and 1/4/16 unplaced, tensor cores
    64/128), tile columns, stage words (a multiple of 4 on tensor cores),
    copies per thread (``MAX_COPIES``), staged row bytes, the split, and
    shared memory at most ``SMEM_MAX`` (232,448 B, the Hopper per-block
    limit) that the Pallas version held to a 4 MiB VMEM budget.

Violations raise :class:`ContractViolation` naming the kernel, the
invariant and, where it localizes, the block.  The wrappers run the plan
check on every tuned plan before it launches (``kernels/placed_gemm.py``,
``kernels/plane_gemm.py``); ``kernels.ops.pud_matmul(check_contracts=
True)`` runs the whole check; ``python -m repro_torch.analysis`` sweeps
:func:`default_matrix`, every autotuner candidate at the main path's
shapes, and :func:`adversarial_fixtures` (each must trip its invariant).

The shared-memory-per-block table in README.md is generated from this
module (``python -m repro_torch.analysis --write-docs``).
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np

from repro_torch.kernels import placed_gemm, plane_gemm
from repro_torch.kernels.ops import N_BLOCK, largest_divisor

from .errors import ContractViolation

LAYOUTS = ("dense", "bitpack8")
ENTRIES = ("gemv", "gemm")
MODES = ("planes", "folded")
SMS = placed_gemm.SMS
SMEM_MAX = placed_gemm.SMEM_MAX

_KERNEL_NAMES = {
    ("gemv", False): "gemv",
    ("gemv", True): "gemv_placed",
    ("gemm", False): "gemm",
    ("gemm", True): "gemm_placed",
}


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class KernelCall:
    """Static description of one kernel call (shapes only, no tensors).

    ``plane_k`` is the planes' K extent as stored: ``Kw`` words for
    ``layout="bitpack8"``, K rows for dense.  ``window`` is the physical
    window length of a placed call (None: unplaced); ``window_block`` its
    stride (None: the whole window is one block).  ``tuned`` is a
    ``kernels/autotune.TunedPlan`` (None: the heuristic plan); ``sms`` the
    SM count the plan fills.
    """

    entry: str                     # "gemv" | "gemm"
    b: int                         # activation rows
    k: int                         # activation (logical) reduction length
    n: int                         # logical output columns
    wb: int = 4                    # bit-planes
    layout: str = "dense"
    plane_k: int | None = None     # planes.shape[-2]; default: derived
    logical_k: int | None = None   # bitpack8 pack metadata
    window: int | None = None      # physical window length W (placed)
    window_block: int | None = None
    mode: str = "folded"
    tuned: object | None = None
    sms: int = SMS

    @property
    def placed(self) -> bool:
        return self.window is not None

    @property
    def kernel(self) -> str:
        return _KERNEL_NAMES.get((self.entry, self.placed), self.entry)

    def resolved_plane_k(self) -> int:
        if self.plane_k is not None:
            return self.plane_k
        return _cdiv(self.k, 8) if self.layout == "bitpack8" else self.k


def _need(cond: bool, kernel: str, invariant: str, message: str,
          tile=None) -> None:
    if not cond:
        raise ContractViolation(kernel, invariant, message, tile=tile)


def _launch_args(kernel, *, b, k, kw, n, wb) -> None:
    """The operand checks the C ``launch`` makes before it reads a plan."""
    _need(1 <= wb <= 8, kernel, "plane-count",
          f"{wb} bit-planes; the kernels take 1..8")
    _need(b >= 1 and n >= 1 and k >= 1, kernel, "shape",
          f"non-positive dimension in B={b} K={k} N={n}")
    _need((kw - 1) * 8 < k <= kw * 8, kernel, "bitpack8-word-count",
          f"Kw={kw} words do not hold K={k}")


def _common(kernel, entry, plan, *, b, kw, tuned) -> None:
    """The checks both kernels share: the GEMV entry's one-row dp4a plan
    and a tuned split count the plan could not make."""
    if entry.startswith("gemv"):
        _need(b == 1 and not plan.tensor_cores and plan.rows == 1, kernel,
              "gemv-plan", f"the GEMV entry takes one row on the one-row "
              f"dp4a plan, got B={b}, rows {plan.rows}, tensor cores "
              f"{plan.tensor_cores}")
    if tuned is not None and tuned.n_split is not None:
        _need(plan.n_split == tuned.n_split, kernel, "tuned-split",
              f"{tuned.n_split} K splits asked, {plan.n_split} possible "
              f"over {kw} words in stages of {plan.stage_words}")
    kc = plan.stage_words
    _need(kc >= 1 and plan.split_words >= kc and plan.split_words % kc == 0
          and plan.n_split == _cdiv(kw, plan.split_words), kernel, "split",
          f"split of {plan.split_words} words x {plan.n_split} does not "
          f"cover Kw={kw} in whole stages of {kc}")


def check_placed_plan(entry: str, plan, *, b: int, k: int, kw: int,
                      w_len: int, n: int, wb: int, window_block: int,
                      block_cols: int, dense: bool, tuned=None) -> None:
    """Hold a ``placed_gemm.Plan`` to ``plan_ok`` of
    ``csrc/placed_gemm.cu`` (and the launch's operand checks), one named
    invariant at a time; raises :class:`ContractViolation`."""
    kern = entry if entry.endswith("_placed") else f"{entry}_placed"
    p = plan
    _launch_args(kern, b=b, k=k, kw=kw, n=n, wb=wb)
    _need(window_block >= 1 and block_cols >= 1 and n % block_cols == 0
          and w_len == (n // block_cols) * window_block, kern,
          "window-tiling", f"window {w_len} / window_block {window_block} "
          f"/ block_cols {block_cols} do not tile N={n}")
    _common(kern, entry, p, b=b, kw=kw, tuned=tuned)
    rpw = 8 if dense else 1
    kc = p.stage_words
    tc = p.tensor_cores
    if tc:
        _need(p.rows in placed_gemm.TC_ROWS, kern, "rows-instantiated",
              f"{p.rows} rows per tensor-core block; compiled: "
              f"{placed_gemm.TC_ROWS}")
        _need(p.tile_cols == placed_gemm.TC_COLS, kern, "tile-cols",
              f"tensor-core tile of {p.tile_cols} columns, not "
              f"{placed_gemm.TC_COLS}")
        _need(kc % 4 == 0, kern, "tc-stage-words",
              f"{kc} stage words on tensor cores, not a multiple of 4")
    else:
        _need(p.rows in placed_gemm.DP4A_ROWS, kern, "rows-instantiated",
              f"{p.rows} rows per dp4a block; compiled: "
              f"{placed_gemm.DP4A_ROWS}")
        _need(p.tile_cols in placed_gemm.DP4A_COLS, kern, "tile-cols",
              f"dp4a tile of {p.tile_cols} columns; compiled: "
              f"{placed_gemm.DP4A_COLS}")
    _need(p.stages == placed_gemm.STAGES, kern, "stages",
          f"{p.stages} stages, the kernel's ring has {placed_gemm.STAGES}")
    tiles = _cdiv(block_cols, p.tile_cols)
    _need(p.tiles_per_block == tiles, kern, "tiles",
          f"{p.tiles_per_block} tiles per window block, {tiles} needed")
    _need(p.x_row >= 8 * kc and p.x_row % 16 == 0, kern, "x-row",
          f"x row of {p.x_row} B for {kc} stage words")
    if p.row_bytes:
        _need(p.row_bytes >= window_block + 15 and p.row_bytes % 16 == 0
              and p.row_bytes // 16 <= 256, kern, "staged-row",
              f"staged row of {p.row_bytes} B for a window block of "
              f"{window_block}")
        copies = wb * rpw * kc * (p.row_bytes // 16)
        limit = placed_gemm.MAX_COPIES * placed_gemm.THREADS
        _need(copies <= limit, kern, "copies",
              f"{copies} 16-byte granules per stage over "
              f"{placed_gemm.THREADS} threads x {placed_gemm.MAX_COPIES}")
        _need(p.w_stage == wb * rpw * kc * p.row_bytes
              and p.tab_bytes >= 4 * wb * rpw * kc
              and (p.pk_row >= window_block + 3 and p.pk_row % 16 == 0
                   if dense else p.pk_row == 0), kern, "stage-layout",
              f"stage rows {p.w_stage} B, table {p.tab_bytes} B, folded "
              f"row {p.pk_row} B")
    else:
        _need(p.w_stage == 0 and p.tab_bytes == 0 and p.pk_row == 0, kern,
              "stage-layout", "an unstaged plan stages weight rows")
    _need(p.tab_bytes % 16 == 0, kern, "stage-layout",
          f"row table of {p.tab_bytes} B not 16-byte aligned")
    _need(p.stage_bytes == p.w_stage + p.rows * p.x_row + p.tab_bytes, kern,
          "stage-bytes", f"stage of {p.stage_bytes} B")
    need = placed_gemm.STAGES * p.stage_bytes + 16 + wb * kc * p.pk_row
    if tc:
        need += (placed_gemm.TC_COLS * (8 * kc + placed_gemm.PAD)
                 + placed_gemm.TC_COLS * 4)
    elif p.tile_cols < placed_gemm.THREADS:
        need = max(need, placed_gemm.THREADS * p.rows * 4)
    _need(p.smem_bytes >= need, kern, "smem-need",
          f"{p.smem_bytes} B of shared memory, the kernel uses {need}")
    _need(p.smem_bytes <= SMEM_MAX, kern, "smem-max",
          f"{p.smem_bytes} B of shared memory over the block limit "
          f"{SMEM_MAX}")
    grid = ((n // block_cols) * tiles, _cdiv(b, p.rows), p.n_split)
    _need(tuple(p.grid) == grid, kern, "grid",
          f"grid {p.grid}, the operands need {grid}")


def check_plane_plan(entry: str, plan, *, b: int, k: int, kw: int, n: int,
                     wb: int, dense: bool, tuned=None) -> None:
    """Hold a ``plane_gemm.Plan`` to ``plan_ok`` of ``csrc/plane_gemm.cu``
    (and the launch's operand checks); raises :class:`ContractViolation`."""
    kern = entry
    p = plan
    _launch_args(kern, b=b, k=k, kw=kw, n=n, wb=wb)
    _common(kern, entry, p, b=b, kw=kw, tuned=tuned)
    rpw = 8 if dense else 1
    kc = p.stage_words
    tc = p.tensor_cores
    rows = plane_gemm.TC_ROWS if tc else plane_gemm.DP4A_ROWS
    _need(p.rows in rows, kern, "rows-instantiated",
          f"{p.rows} rows per {'tensor-core' if tc else 'dp4a'} block; "
          f"compiled: {rows}")
    _need(kc in (4, 8, 16, 32), kern, "stage-words",
          f"{kc} stage words; the kernels take 4, 8, 16 or 32")
    if tc:
        _need(kc <= 16, kern, "tc-stage-words",
              f"{kc} stage words on tensor cores, at most 16")
    else:
        _need((2 if dense else 1) * kc >= plane_gemm.WARPS, kern,
              "dp4a-warps", f"{kc} stage words leave a warp of "
              f"{plane_gemm.WARPS} without work")
    _need(p.stages == plane_gemm.STAGES, kern, "stages",
          f"{p.stages} stages, the kernel's ring has {plane_gemm.STAGES}")
    _need(p.x_row == 8 * kc + plane_gemm.PAD, kern, "x-row",
          f"x row of {p.x_row} B for {kc} stage words")
    _need(p.w_stage == wb * rpw * kc * plane_gemm.TILE_COLS, kern,
          "stage-layout", f"weight rows of {p.w_stage} B per stage")
    _need(p.stage_bytes == p.w_stage + p.rows * p.x_row, kern,
          "stage-bytes", f"stage of {p.stage_bytes} B")
    if tc:
        need = (plane_gemm.STAGES * p.stage_bytes
                + 2 * kc * plane_gemm.WT_STRIDE * 4)
    else:
        need = max(plane_gemm.STAGES * p.stage_bytes,
                   plane_gemm.WARPS * plane_gemm.TILE_COLS * 4)
    _need(p.smem_bytes >= need, kern, "smem-need",
          f"{p.smem_bytes} B of shared memory, the kernel uses {need}")
    _need(p.smem_bytes <= SMEM_MAX, kern, "smem-max",
          f"{p.smem_bytes} B of shared memory over the block limit "
          f"{SMEM_MAX}")
    grid = (_cdiv(n, plane_gemm.TILE_COLS), _cdiv(b, p.rows), p.n_split)
    _need(tuple(p.grid) == grid, kern, "grid",
          f"grid {p.grid}, the operands need {grid}")


def _k_words(call: KernelCall) -> int:
    """Kw of a call after the layout checks (the reference's ``_k_plan``)."""
    kernel = call.kernel
    if call.layout == "bitpack8":
        kw = call.resolved_plane_k()
        _need((call.logical_k or kw * 8) == call.k and call.k <= kw * 8,
              kernel, "bitpack8-logical-k",
              f"x K={call.k} inconsistent with word planes Kw={kw} "
              f"(logical_k={call.logical_k})")
        _need(kw == _cdiv(call.k, 8), kernel, "bitpack8-word-count",
              f"stored word count Kw={kw} != ceil(K/8)={_cdiv(call.k, 8)} "
              f"for K={call.k}: the pack was not built by pack_plane_words")
        return kw
    _need(call.layout == "dense", kernel, "layout",
          f"unknown plane layout {call.layout!r}; one of {LAYOUTS}")
    _need(call.resolved_plane_k() == call.k, kernel, "k-mismatch",
          f"x K={call.k} vs planes K={call.resolved_plane_k()}")
    return _cdiv(call.k, 8)


def window_geometry(call: KernelCall) -> tuple[int, int]:
    """(window stride, logical columns per window block) of a placed call;
    raises on a tiling the kernels cannot address."""
    w_len = call.window
    pwb = call.window_block or w_len
    _need(pwb > 0 and w_len % pwb == 0 and call.n % (w_len // pwb) == 0,
          call.kernel, "window-tiling",
          f"window length {w_len} / window_block {pwb} does not tile "
          f"N={call.n}")
    block_cols = call.n // (w_len // pwb)
    _need(block_cols <= pwb, call.kernel, "window-capacity",
          f"window_block {pwb} cannot hold {block_cols} logical columns "
          f"per block ({w_len // pwb} blocks for N={call.n})")
    return pwb, block_cols


@functools.lru_cache(maxsize=2048)
def plan_kernel(call: KernelCall):
    """Recompute the launch plan of ``call`` and check its invariants.

    Raises :class:`ContractViolation` on the first violated invariant;
    otherwise returns the plan the wrapper launches with
    (``placed_gemm.Plan`` or ``plane_gemm.Plan``).  Shapes only, so the
    result is cached per call.
    """
    kernel = call.kernel
    _need(call.entry in ENTRIES, kernel, "entry",
          f"unknown entry {call.entry!r}; one of {ENTRIES}")
    _need(call.mode in MODES, kernel, "mode",
          f"unknown mode {call.mode!r}; one of {MODES}")
    _need(min(call.b, call.k, call.n) >= 1, kernel, "shape",
          f"non-positive dimension in B={call.b} K={call.k} N={call.n}")
    _need(1 <= call.wb <= 8, kernel, "plane-count",
          f"{call.wb} bit-planes; the kernels take 1..8")
    kw = _k_words(call)
    dense = call.layout == "dense"
    if call.placed:
        pwb, bc = window_geometry(call)
        plan = placed_gemm.plan_launch(call.b, kw, call.n, call.wb, pwb, bc,
                                       dense, call.sms, call.tuned)
        check_placed_plan(call.entry, plan, b=call.b, k=call.k, kw=kw,
                          w_len=call.window, n=call.n, wb=call.wb,
                          window_block=pwb, block_cols=bc, dense=dense,
                          tuned=call.tuned)
        return plan
    plan = plane_gemm.plan_launch(call.b, kw, call.n, call.wb, dense,
                                  call.sms, call.tuned)
    check_plane_plan(call.entry, plan, b=call.b, k=call.k, kw=kw, n=call.n,
                     wb=call.wb, dense=dense, tuned=call.tuned)
    return plan


def _numpy(a):
    if a is None:
        return None
    if hasattr(a, "detach"):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def check_col_ids(col_ids, n: int, window: int, window_block: int | None,
                  block_cols: int, kernel: str) -> None:
    """Check a concrete ``col_ids`` map ([N] or stacked [L, N]) against
    the block-aligned layout: every logical column's window position lies
    in its block's window slice ``[blk * window_block, (blk + 1) *
    window_block)``, the columns a block stages."""
    ids = _numpy(col_ids).reshape(-1, n)
    pwb = window_block or window
    blk = np.arange(n) // block_cols
    lo, hi = blk * pwb, (blk + 1) * pwb
    for sl in ids:
        bad = (sl < 0) | (sl >= window)
        if bad.any():
            i = int(np.argmax(bad))
            raise ContractViolation(
                kernel, "col-ids-range",
                f"col_ids[{i}]={int(sl[i])} outside window [0, {window})")
        out = (sl < lo) | (sl >= hi)
        if out.any():
            i = int(np.argmax(out))
            raise ContractViolation(
                kernel, "col-ids-range",
                f"col_ids[{i}]={int(sl[i])} escapes its window block "
                f"slice [{int(lo[i])}, {int(hi[i])})", tile=int(blk[i]))


def check_shard_slices(spans, n: int, block_cols: int,
                       kernel: str = "sharded_gemm") -> None:
    """Check a model-shard column split against the block-aligned layout
    (``pud.placement.shard_column_slices``'s spans): every span starts and
    ends on a multiple of ``block_cols`` and the spans tile ``[0, n)`` in
    order, so no window block straddles two devices.  Raises
    :class:`ContractViolation` (invariant ``"shard-straddle"``)."""
    if block_cols <= 0 or n % block_cols:
        raise ContractViolation(
            kernel, "shard-straddle",
            f"block_cols {block_cols} does not tile N={n}")
    lo_expect = 0
    for i, (lo, hi) in enumerate(spans):
        if lo != lo_expect or hi < lo:
            raise ContractViolation(
                kernel, "shard-straddle",
                f"shard {i} span [{lo}, {hi}) does not continue the "
                f"previous shard (expected lo={lo_expect})", tile=i)
        if lo % block_cols or hi % block_cols:
            raise ContractViolation(
                kernel, "shard-straddle",
                f"shard {i} span [{lo}, {hi}) straddles a {block_cols}-"
                "column window block: placement windows must stay whole "
                "per shard", tile=i)
        lo_expect = hi
    if lo_expect != n:
        raise ContractViolation(
            kernel, "shard-straddle",
            f"shard spans cover [0, {lo_expect}) but the tensor has "
            f"N={n} columns")


def check_kernel_args(entry: str, x_shape, planes_shape, *,
                      layout: str = "dense", logical_k: int | None = None,
                      col_ids=None, window_block: int | None = None,
                      mode: str = "folded", wb: int | None = None,
                      tuned=None, sms: int = SMS):
    """Pre-flight a kernel call from its argument shapes: the launch plan
    out, :class:`ContractViolation` on any violated invariant.  ``col_ids``
    may be a tensor or array (its values are checked too) or an int column
    count (shapes only); ``tuned`` a ``TunedPlan``."""
    b, k = int(x_shape[-2]), int(x_shape[-1])
    wb_ = int(wb if wb is not None else planes_shape[-3])
    plane_k, last = int(planes_shape[-2]), int(planes_shape[-1])
    if col_ids is None:
        return plan_kernel(KernelCall(
            entry=entry, b=b, k=k, n=last, wb=wb_, layout=layout,
            plane_k=plane_k, logical_k=logical_k, mode=mode, tuned=tuned,
            sms=sms))
    n = col_ids if isinstance(col_ids, int) else int(col_ids.shape[-1])
    call = KernelCall(entry=entry, b=b, k=k, n=n, wb=wb_, layout=layout,
                      plane_k=plane_k, logical_k=logical_k, window=last,
                      window_block=window_block, mode=mode, tuned=tuned,
                      sms=sms)
    plan = plan_kernel(call)
    if not isinstance(col_ids, int):
        _, bc = window_geometry(call)
        check_col_ids(col_ids, n, last, window_block, bc, call.kernel)
    return plan


def check_tile_plan(plan, entry: str, x_shape, planes_shape, *,
                    layout: str = "dense", logical_k: int | None = None,
                    col_ids=None, window_block: int | None = None,
                    mode: str = "folded", wb: int | None = None,
                    sms: int = SMS):
    """Pre-flight a tuned plan (a ``TunedPlan``, e.g. from a tuning-cache
    entry) for one call: :func:`check_kernel_args` with the plan's choices
    in place of the heuristic's; its ``mode`` replaces ``mode``."""
    return check_kernel_args(
        entry, x_shape, planes_shape, layout=layout, logical_k=logical_k,
        col_ids=col_ids, window_block=window_block,
        mode=getattr(plan, "mode", None) or mode, wb=wb, tuned=plan,
        sms=sms)


def check_pack(pt, batch: int = 1, entry: str | None = None,
               mode: str = "folded", sms: int = SMS) -> list:
    """Contract-check a ``PackedTensor`` for the entries it serves at
    ``batch`` rows (the GEMV entry only at one row), under its stamped
    plan where one applies.  Stacked packs check one slice's shapes and
    every slice's ``col_ids``.  Returns the launch plans."""
    from repro_torch.kernels.autotune import plan_for_entry, row_class
    entries = (entry,) if entry else (
        ENTRIES if batch == 1 else ("gemm",))
    x_shape = (batch, pt.k)
    plans = []
    for e in entries:
        cls = row_class(batch) if (e == "gemv") == (batch == 1) else None
        plans.append(check_kernel_args(
            e, x_shape, tuple(pt.planes.shape[-3:]), layout=pt.layout,
            logical_k=pt.logical_k, col_ids=pt.col_ids,
            window_block=pt.window_block, mode=mode,
            tuned=plan_for_entry(pt.tile_plan, cls) if cls else None,
            sms=sms))
    return plans


# ---------------------------------------------------------------------------
# The sweep: configurations the port runs (must all hold), every autotuner
# candidate at the main path's shapes (must all hold) and adversarial
# fixtures (each must trip its invariant).
# ---------------------------------------------------------------------------


def synthetic_placed(n: int, pad: int = 8):
    """A minimal valid block-aligned placement of N logical columns: blocks
    of ``largest_divisor(n, N_BLOCK)`` columns, each spanning ``pad`` more
    window columns (faulty ones, skipped mid-block as first-fit would).
    Returns (window, window_block, col_ids [N])."""
    block_cols = largest_divisor(n, N_BLOCK)
    n_blocks = n // block_cols
    window_block = block_cols + pad
    offs = np.arange(block_cols)
    offs = offs + (offs >= block_cols // 2) * pad     # gap mid-span
    col_ids = (np.arange(n_blocks)[:, None] * window_block
               + offs[None, :]).reshape(-1).astype(np.int32)
    return n_blocks * window_block, window_block, col_ids


#: (B, K, N): the reference's sweep shapes, then the main path's decode and
#: prefill rows (qwen3-1.7b: wi 2048 x 6144, wo 6144 x 2048, attention
#: 2048 x 1024) and the gemma chunk row
SHAPES = [(1, 64, 64), (8, 256, 512), (4, 300, 172), (2, 1024, 256),
          (1, 2048, 6144), (4, 2048, 6144), (32, 2048, 6144),
          (128, 2048, 6144), (4, 6144, 2048), (32, 2048, 1024),
          (32, 3072, 24576)]

#: (B, K, N) of the autotuner sweep: the main path's tuning batches
TUNE_SHAPES = [(b, k, n) for b in (1, 4, 32)
               for k, n in ((2048, 6144), (6144, 2048), (2048, 1024))]


def _entries(b: int) -> tuple[str, ...]:
    return ENTRIES if b == 1 else ("gemm",)


def default_matrix() -> list[tuple[KernelCall, np.ndarray | None]]:
    """(call, col_ids) pairs: every entry each shape dispatches to x both
    layouts x both modes, unplaced and placed."""
    out: list[tuple[KernelCall, np.ndarray | None]] = []
    for b, k, n in SHAPES:
        window, wblk, ids = synthetic_placed(n)
        for layout in LAYOUTS:
            lk = k if layout == "bitpack8" else None
            for entry in _entries(b):
                for mode in MODES:
                    out.append((KernelCall(entry=entry, b=b, k=k, n=n,
                                           layout=layout, logical_k=lk,
                                           mode=mode), None))
                out.append((KernelCall(entry=entry, b=b, k=k, n=n,
                                       layout=layout, logical_k=lk,
                                       window=window, window_block=wblk),
                            ids))
    return out


def candidate_matrix(sms: int = SMS) -> list[KernelCall]:
    """Every autotuner candidate (``kernels/autotune.candidate_plans``) at
    ``TUNE_SHAPES``, bit-packed, unplaced and placed."""
    from repro_torch.kernels.autotune import candidate_plans
    out = []
    for b, k, n in TUNE_SHAPES:
        window, wblk, _ = synthetic_placed(n)
        entry = "gemv" if b == 1 else "gemm"
        for placed in (False, True):
            geo = dict(window=window, window_block=wblk) if placed else {}
            for plan in candidate_plans(entry, b, k, n, layout="bitpack8",
                                        placed_window=geo.get("window"),
                                        pack_window_block=geo.get(
                                            "window_block"), sms=sms):
                out.append(KernelCall(entry=entry, b=b, k=k, n=n,
                                      layout="bitpack8", logical_k=k,
                                      tuned=plan, sms=sms, **geo))
    return out


def adversarial_fixtures() -> list[tuple[str, str, KernelCall,
                                         np.ndarray | None]]:
    """(name, expected invariant, call, col_ids): each must violate."""
    from repro_torch.kernels.autotune import TunedPlan
    window, wblk, ids = synthetic_placed(512)
    bad_ids = ids.copy()
    bad_ids[7] = window + 3                           # escapes the window
    slice_ids = ids.copy()
    slice_ids[300] = 0                                # wrong block's slice
    placed = dict(window=window, window_block=wblk)
    return [
        ("oversized-window-block", "window-tiling",
         KernelCall(entry="gemv", b=1, k=256, n=512, window=window,
                    window_block=wblk + 1), ids),
        ("window-under-capacity", "window-capacity",
         KernelCall(entry="gemm", b=4, k=256, n=512, window=256,
                    window_block=128), None),
        ("inconsistent-logical-k", "bitpack8-logical-k",
         KernelCall(entry="gemm", b=8, k=300, n=128, layout="bitpack8",
                    plane_k=32, logical_k=300), None),
        ("word-count-drift", "bitpack8-word-count",
         KernelCall(entry="gemv", b=1, k=96, n=128, layout="bitpack8",
                    plane_k=16, logical_k=96), None),
        ("col-ids-out-of-window", "col-ids-range",
         KernelCall(entry="gemv", b=1, k=256, n=512, **placed), bad_ids),
        ("col-ids-wrong-block", "col-ids-range",
         KernelCall(entry="gemm", b=4, k=256, n=512, **placed), slice_ids),
        ("unknown-layout", "layout",
         KernelCall(entry="gemv", b=1, k=64, n=64, layout="bitpack4"),
         None),
        ("gemv-takes-one-row", "gemv-plan",
         KernelCall(entry="gemv", b=4, k=256, n=512), None),
        # tuned plans are not exempt: the autotuner's filter rejects these
        ("rows-not-instantiated", "rows-instantiated",
         KernelCall(entry="gemm", b=4, k=2048, n=512, layout="bitpack8",
                    logical_k=2048, tuned=TunedPlan(rows=2), **placed),
         None),
        ("tc-stage-words", "tc-stage-words",
         KernelCall(entry="gemm", b=32, k=2048, n=512, layout="bitpack8",
                    logical_k=2048,
                    tuned=TunedPlan(tensor_cores=True, stage_words=2),
                    **placed), None),
        ("copies-over-the-limit", "copies",
         KernelCall(entry="gemm", b=4, k=2048, n=512, **placed,
                    tuned=TunedPlan(stage_words=16)), None),
        ("smem-over-the-limit", "smem-max",
         KernelCall(entry="gemm", b=128, k=2048, n=512, wb=8,
                    tuned=TunedPlan(stage_words=16)), None),
        ("dp4a-warps-idle", "dp4a-warps",
         KernelCall(entry="gemm", b=4, k=2048, n=512, layout="bitpack8",
                    logical_k=2048, tuned=TunedPlan(stage_words=4)), None),
        ("split-not-possible", "tuned-split",
         KernelCall(entry="gemm", b=4, k=64, n=512, layout="bitpack8",
                    logical_k=64, tuned=TunedPlan(stage_words=8,
                                                  n_split=3)), None),
    ]


def _check_pair(call: KernelCall, ids) -> None:
    plan_kernel(call)
    if ids is not None:
        _, bc = window_geometry(call)
        check_col_ids(ids, call.n, call.window, call.window_block, bc,
                      call.kernel)


def _describe(call: KernelCall) -> str:
    plan = call.tuned.to_dict() if call.tuned is not None else "heuristic"
    return (f"{call.kernel} B={call.b} K={call.k} N={call.n} {call.layout} "
            f"plan {plan}")


def run_contracts(sms: int = SMS) -> list[str]:
    """The contract pass: the valid matrix and every tuning candidate must
    hold; every adversarial fixture must trip its invariant.  Returns
    findings; empty means clean."""
    findings: list[str] = []
    valid = [(dataclasses.replace(c, sms=sms), ids)
             for c, ids in default_matrix()]
    valid += [(c, None) for c in candidate_matrix(sms)]
    for call, ids in valid:
        try:
            _check_pair(call, ids)
        except ContractViolation as e:
            findings.append(f"valid config rejected: {_describe(call)}: {e}")
    for name, invariant, call, ids in adversarial_fixtures():
        try:
            _check_pair(dataclasses.replace(call, sms=sms), ids)
        except ContractViolation as e:
            if e.invariant != invariant:
                findings.append(f"fixture {name!r} tripped {e.invariant!r}, "
                                f"expected {invariant!r}")
        else:
            findings.append(f"adversarial fixture {name!r} did not violate "
                            f"{invariant!r}")
    return findings


# ---------------------------------------------------------------------------
# The generated shared-memory table (README.md): the doc math is this code.
# ---------------------------------------------------------------------------

DOC_BEGIN = ("<!-- BEGIN GENERATED: smem-budget "
             "(python -m repro_torch.analysis --write-docs) -->")
DOC_END = "<!-- END GENERATED: smem-budget -->"

#: the table's operating point: a 2048 x 2048 4-bit projection, placed at
#: the ~3% ECR stride of 264 window columns per 256-column block
_DOC_REF = dict(k=2048, n=2048, wb=4)
_DOC_WINDOW_BLOCK = 264
_DOC_BATCHES = (1, 4, 32, 128)


def _doc_rows():
    k, n, wb = _DOC_REF["k"], _DOC_REF["n"], _DOC_REF["wb"]
    bc = largest_divisor(n, N_BLOCK)
    window = (n // bc) * _DOC_WINDOW_BLOCK
    for placed in (False, True):
        for layout in ("bitpack8", "dense"):
            for b in _DOC_BATCHES:
                call = KernelCall(
                    entry="gemv" if b == 1 else "gemm", b=b, k=k, n=n,
                    wb=wb, layout=layout,
                    logical_k=k if layout == "bitpack8" else None,
                    window=window if placed else None,
                    window_block=_DOC_WINDOW_BLOCK if placed else None)
                yield call, plan_kernel(call)


def render_smem_table() -> str:
    """The markdown block README.md embeds verbatim."""
    rows = [
        f"Derived from `analysis/contracts.py` at K = N = {_DOC_REF['k']}, "
        f"WB = {_DOC_REF['wb']}, {SMS} SMs; placed packs stream window "
        f"blocks of {_DOC_WINDOW_BLOCK} columns (about 3% ECR) per "
        "256-column block. Shared memory per block against the Hopper "
        f"limit `SMEM_MAX` = {SMEM_MAX} B:",
        "",
        "| entry | layout | B | path, rows | stage words x stages | "
        "stage bytes | K split | shared bytes | of `SMEM_MAX` |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for call, p in _doc_rows():
        path = "tensor cores" if p.tensor_cores else "dp4a"
        rows.append(
            f"| {call.kernel} | {call.layout} | {call.b} | {path}, "
            f"{p.rows} | {p.stage_words} x {p.stages} | {p.stage_bytes} | "
            f"{p.n_split} | {p.smem_bytes} | "
            f"{100 * p.smem_bytes / SMEM_MAX:.1f}% |")
    return "\n".join(rows)


def doc_table_block() -> str:
    return f"{DOC_BEGIN}\n{render_smem_table()}\n{DOC_END}"


def _replace_block(text: str, path) -> str:
    start, end = text.find(DOC_BEGIN), text.find(DOC_END)
    if start < 0 or end < 0:
        raise ValueError(f"{path}: generated-block markers not found")
    return text[:start] + doc_table_block() + text[end + len(DOC_END):]


def write_doc_table(path) -> None:
    """Splice the generated block between the markers in ``path``."""
    text = open(path, encoding="utf-8").read()
    with open(path, "w", encoding="utf-8") as f:
        f.write(_replace_block(text, path))


def check_doc_table(path) -> list[str]:
    """The committed table must equal the generated one."""
    try:
        text = open(path, encoding="utf-8").read()
    except OSError:
        return [f"{path}: missing (cannot verify the generated table)"]
    if DOC_BEGIN not in text or DOC_END not in text:
        return [f"{path}: generated-block markers not found"]
    if _replace_block(text, path) != text:
        return [f"{path}: shared-memory table is stale; run "
                "`python -m repro_torch.analysis --write-docs`"]
    return []
