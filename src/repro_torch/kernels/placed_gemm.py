"""Placed bit-plane GEMM/GEMV: CUDA kernel wrappers, launch plan, plain
versions, counters.

Replaces the Pallas kernels ``repro/kernels/bitplane_gemm.py:
bitplane_gemm_placed`` (batch-tiled, ``gemm_placed`` here) and
``repro/kernels/bitplane_gemv.py: bitplane_gemv_placed`` (B = 1,
``gemv_placed`` here).  Both launch ``csrc/placed_gemm.cu``.

A CUDA tensor launches the kernel in either layout: bit-packed words
(``layout="bitpack8"``, [WB, ceil(K/8), W] uint8) or dense 0/1 planes
(``layout="dense"``, [WB, K, W] int8), which the kernel reads itself with
nothing repacked first; a CPU tensor runs the plain version.  ``mode``
("planes" or "folded") selects an execution schedule in the reference; both
give the same integers, so it is validated and otherwise ignored.

Window addressing follows the reference kernel exactly: logical column n
sits in window block ``n // block_cols`` and reads window column
``(n // block_cols) * window_block + col_ids[n] % window_block``.

On the H100 the kernel is bound by bytes at decode batches and by integer
work at prefill.  Like the reference's window-block ``BlockSpec``, a block
stages the window span of its columns through shared memory (16-byte
``cp.async``, a ring of stages) and gathers there; K splits across blocks
until the card is full, partial sums meeting in a zeroed output through
exact integer atomics; decode rows run ``__dp4a``, prefill rows (B >= 17)
int8 tensor-core MMA on a tile unpacked once per stage.  ``plan_launch``
makes every choice of a launch on the host from shapes alone (path, tile,
stage words, K split, shared memory, grid) and the kernel only checks it,
so the CPU tests reach the plan.  Every launch runs with its tensors'
device current, and its plan fills that device's SM count.  Every call of
either entry, on either path, counts in the tracer's ``placed.calls``
keyed by (entry, rows, K, N); ``launches`` counts the CUDA launches.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch import devices
from repro_torch.runtime import tracing

from . import build
from .ref import bitplane_gemv_ref, densify

MODES = ("planes", "folded")
LAYOUTS = ("dense", "bitpack8")

_P = ctypes.c_void_p
_I = ctypes.c_int

SMS = 132                 # default SM count of a plan (an H100 SXM)
THREADS = 256             # threads per block
STAGES = 4                # shared-memory ring depth
TC_MIN_ROWS = 17          # batch rows from which the tensor-core path runs
TC_ROWS = (64, 128)       # batch rows per tensor-core block
TC_COLS = 128             # logical columns per tensor-core block
DP4A_ROWS = (1, 4, 8, 16)  # batch rows per dp4a block
DP4A_COLS = (64, 128, 256)  # logical columns per dp4a block
STAGE_WORDS = (16, 8, 4, 2, 1)  # K words per stage, first choice first
MAX_COPIES = 8            # 16-byte window granules per thread and stage
PAD = 16                  # bytes past 8 * stage words in an int8 row
RING_BUDGET = 112 * 1024  # shared bytes per block that keep two per SM
SMEM_MAX = 232_448        # shared bytes one block may use


def _fn(name: str, argtypes):
    fn = getattr(build.load("placed_gemm"), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def check_mode(mode: str, layout: str) -> None:
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {MODES}")
    if layout not in LAYOUTS:
        raise ValueError(f"layout {layout!r} not in {LAYOUTS}")


def window_tiling(n: int, w_len: int, window_block: int | None,
                  entry: str) -> tuple[int, int]:
    """(window stride, logical columns per window block) of a placed pack;
    ``window_block=None`` treats the whole window as one block."""
    pwb = window_block or w_len
    if w_len % pwb or n % (w_len // pwb):
        raise ValueError(f"{entry}: window length {w_len} / window_block "
                         f"{pwb} does not tile N={n}")
    return pwb, n // (w_len // pwb)


def window_cols(col_ids: torch.Tensor, w_len: int,
                window_block: int | None, entry: str = "placed") -> torch.Tensor:
    """[N] int64 window column each logical column reads (kernel addressing)."""
    (n,) = col_ids.shape
    pwb, bc = window_tiling(n, w_len, window_block, entry)
    blk = torch.arange(n, device=col_ids.device) // bc
    return blk * pwb + col_ids.long() % pwb


def placed_plain(x: torch.Tensor, planes: torch.Tensor,
                 col_ids: torch.Tensor, mode: str = "folded", *,
                 layout: str = "dense", logical_k: int | None = None,
                 window_block: int | None = None) -> torch.Tensor:
    """Plain version of both entries: [B, K] int8 -> [B, N] int32.

    Bit-words densify first (the reference backend's adapter); then the
    window columns are gathered with the kernel's addressing and run
    through the plain bit-plane GeMV.
    """
    check_mode(mode, layout)
    x, planes = densify(x, planes, layout, logical_k)
    cols = window_cols(col_ids, planes.shape[-1], window_block)
    return bitplane_gemv_ref(x, planes.index_select(2, cols))


gemm_placed_plain = placed_plain
gemv_placed_plain = placed_plain


def check_operands(entry: str, x: torch.Tensor, words: torch.Tensor,
                   layout: str, logical_k: int | None) -> int:
    """Validate x [B, K] int8 and the planes of a CUDA launch in either
    layout; returns Kw = ceil(K / 8), the K words the kernel walks."""
    def need(cond, msg):
        if not cond:
            raise ValueError(f"{entry}: {msg}")

    dense = layout == "dense"
    need(x.dtype == torch.int8 and x.dim() == 2,
         f"x must be [B, K] int8, got {x.dtype} {tuple(x.shape)}")
    if dense:
        need(words.dtype in (torch.int8, torch.uint8) and words.dim() == 3,
             f"dense planes must be [WB, K, N] int8, got {words.dtype} "
             f"{tuple(words.shape)}")
    else:
        need(words.dtype == torch.uint8 and words.dim() == 3,
             f"words must be [WB, Kw, N] uint8, got {words.dtype} "
             f"{tuple(words.shape)}")
    need(words.device == x.device, "all tensors on one device")
    need(x.is_contiguous() and words.is_contiguous(),
         "tensors must be contiguous")
    b, k = x.shape
    wb, rows, n = words.shape
    need(b > 0 and n > 0 and k > 0, "empty operand")
    need(1 <= wb <= 8, f"{wb} bit-planes; the kernel takes 1..8")
    if dense:
        need(rows == k and (logical_k or k) == k,
             f"x K={k} inconsistent with dense planes K={rows} "
             f"(logical_k={logical_k})")
        return -(-k // 8)
    need((logical_k or rows * 8) == k and rows * 8 - 8 < k <= rows * 8,
         f"x K={k} inconsistent with words Kw={rows} "
         f"(logical_k={logical_k})")
    return rows


def _geometry(x, words, col_ids, layout, logical_k, window_block, entry):
    """Validate a CUDA launch; returns (B, K, Kw, W, N, WB, pwb, bc)."""
    kw = check_operands(entry, x, words, layout, logical_k)
    if not (col_ids.dtype == torch.int32 and col_ids.dim() == 1):
        raise ValueError(f"{entry}: col_ids must be [N] int32, got "
                         f"{col_ids.dtype}")
    if col_ids.device != x.device or not col_ids.is_contiguous():
        raise ValueError(f"{entry}: col_ids must be contiguous on the "
                         "device of x")
    b, k = x.shape
    wb, _, w_len = words.shape
    (n,) = col_ids.shape
    if n == 0:
        raise ValueError(f"{entry}: empty operand")
    pwb, bc = window_tiling(n, w_len, window_block, entry)
    return b, k, kw, w_len, n, wb, pwb, bc


@dataclasses.dataclass(frozen=True)
class Plan:
    """How one launch of ``csrc/placed_gemm.cu`` covers its operands.

    ``tensor_cores``: the int8 MMA path (prefill rows), else ``__dp4a``.
    ``rows`` batch rows and ``tile_cols`` logical columns per block (a
    window block is ``tiles_per_block`` tiles); ``stage_words`` K words per
    shared-memory stage, ``stages`` in the ring; ``split_words`` K words per
    block along gridDim.z (``n_split`` splits, partial sums added into a
    zeroed output when there is more than one); ``row_bytes`` shared bytes
    per staged window row (0: the span does not fit, lanes read device
    memory directly); ``x_row`` shared bytes per x row; ``w_stage``,
    ``tab_bytes`` and ``stage_bytes`` the window rows, the row table and
    the whole of one stage; ``pk_row`` shared bytes per folded dense word
    row (0 unless dense rows are staged).
    """
    tensor_cores: bool
    rows: int
    tile_cols: int
    tiles_per_block: int
    stage_words: int
    stages: int
    split_words: int
    n_split: int
    row_bytes: int
    x_row: int
    w_stage: int
    tab_bytes: int
    stage_bytes: int
    pk_row: int
    smem_bytes: int
    grid: tuple[int, int, int]

    #: field order of the C ``Plan`` struct
    FIELDS = ("tensor_cores", "rows", "tile_cols", "tiles_per_block",
              "stage_words", "stages", "split_words", "n_split", "row_bytes",
              "x_row", "w_stage", "tab_bytes", "stage_bytes", "pk_row",
              "smem_bytes")

    @property
    def staged(self) -> bool:
        return self.row_bytes > 0

    def c_array(self):
        vals = [int(getattr(self, f)) for f in self.FIELDS] + list(self.grid)
        return (ctypes.c_int * len(vals))(*vals)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def split_k(kw: int, fit, tiles: int, sms: int) -> tuple[int, int, int]:
    """(stage words, split_words, n_split) of ``tiles`` blocks over ``kw``
    K words: K splits, in whole stages, until about ``2 * sms`` blocks are
    in flight; of the stage sizes ``fit`` (largest first), the largest
    that still reaches that many blocks wins, else the one that splits
    most."""
    def split_of(kc):
        chunks = _cdiv(kw, kc)
        split = max(1, min(chunks, _cdiv(2 * sms, tiles)))
        split_words = _cdiv(chunks, split) * kc
        return split_words, _cdiv(kw, split_words)

    kc = next((c for c in fit if tiles * split_of(c)[1] >= 2 * sms),
              max(fit, key=lambda c: (split_of(c)[1], c)))
    return (kc, *split_of(kc))


def fixed_split(kw: int, kc: int, n_split: int) -> tuple[int, int]:
    """(split_words, n_split) of a chosen split count: ``n_split`` blocks
    along K in whole stages of ``kc`` words (fewer when K has fewer
    stages)."""
    split_words = _cdiv(_cdiv(kw, kc), max(1, n_split)) * kc
    return split_words, _cdiv(kw, split_words)


@functools.lru_cache(maxsize=512)
def plan_launch(b: int, kw: int, n: int, wb: int, window_block: int,
                block_cols: int, dense: bool, sms: int = SMS,
                tuned=None) -> Plan:
    """The launch plan of one placed GEMM/GEMV call, from shapes alone.

    ``b`` batch rows, ``kw`` = ceil(K / 8) K words, ``n`` logical columns,
    ``wb`` planes, ``window_block`` / ``block_cols`` the window tiling of
    ``window_tiling``.  The tensor-core path takes ``b >= TC_MIN_ROWS``.
    A stage holds at most ``MAX_COPIES`` granules per thread, and its ring
    fits ``RING_BUDGET`` (two blocks per SM), else the block's shared
    memory at the smallest of ``STAGE_WORDS``; where nothing fits, the span
    is not staged.  K splits, in whole stages, until about ``2 * sms``
    blocks are in flight (``sms``: the device's SM count); of the stage
    sizes that fit, the largest that still reaches that many blocks wins.

    ``tuned`` (``kernels/autotune.TunedPlan``) overrides the free choices:
    the path, rows per block, stage words and the split count; a field
    left as None keeps the heuristic.  The plan is built as told and not
    repaired: ``analysis/contracts`` checks it as the kernel would.
    """
    tc = b >= TC_MIN_ROWS
    if tuned is not None and tuned.tensor_cores is not None:
        tc = tuned.tensor_cores
    if tuned is not None and tuned.rows is not None:
        rows = tuned.rows
    elif tc:
        rows = TC_ROWS[0] if b <= TC_ROWS[0] else TC_ROWS[1]
    else:
        rows = next(r for r in DP4A_ROWS if r >= min(b, DP4A_ROWS[-1]))
    if tc:
        tile = TC_COLS
    else:
        tile = next(t for t in DP4A_COLS if t >= min(block_cols,
                                                     DP4A_COLS[-1]))
    rpw = 8 if dense else 1
    row_bytes = _cdiv(window_block + 15, 16) * 16

    def smem(kc, rb):
        x_row = _cdiv(8 * kc, 16) * 16 + PAD
        w_stage = wb * rpw * kc * rb
        tab = _cdiv(4 * wb * rpw * kc, 16) * 16 if rb else 0
        stage = w_stage + rows * x_row + tab
        pk_row = _cdiv(window_block + 3, 16) * 16 if rb and dense else 0
        total = STAGES * stage + 16 + wb * kc * pk_row
        if tc:
            total += TC_COLS * (8 * kc + PAD) + TC_COLS * 4
        elif tile < THREADS:
            total = max(total, THREADS * rows * 4)   # the K-lane reduction
        return x_row, w_stage, tab, stage, pk_row, total

    def copies_fit(kc):
        return (row_bytes <= 16 * 256
                and wb * rpw * kc * row_bytes // 16 <= MAX_COPIES * THREADS)

    cands = [kc for kc in STAGE_WORDS
             if (not tc or kc % 4 == 0) and copies_fit(kc)]
    fit = [kc for kc in cands if smem(kc, row_bytes)[-1] <= RING_BUDGET]
    if not fit and cands and smem(cands[-1], row_bytes)[-1] <= SMEM_MAX:
        fit = cands[-1:]
    if not fit:
        fit, row_bytes = [8], 0

    if tuned is not None and tuned.stage_words is not None:
        fit = [tuned.stage_words]
    tiles_per_block = _cdiv(block_cols, tile)
    tiles = (n // block_cols) * tiles_per_block * _cdiv(b, rows)
    kc, split_words, n_split = split_k(kw, fit, tiles, sms)
    if tuned is not None and tuned.n_split is not None:
        split_words, n_split = fixed_split(kw, kc, tuned.n_split)
    x_row, w_stage, tab, stage, pk_row, total = smem(kc, row_bytes)
    return Plan(tc, rows, tile, tiles_per_block, kc, STAGES, split_words,
                n_split, row_bytes, x_row, w_stage, tab, stage, pk_row, total,
                ((n // block_cols) * tiles_per_block, _cdiv(b, rows),
                 n_split))


@functools.lru_cache(maxsize=512)
def _plan_array(entry, b, k, kw, w_len, n, wb, pwb, bc, dense, sms, tuned):
    """The plan of one launch and its C array; a tuned plan is held to the
    kernel's invariants first (``analysis/contracts``), and a plan the
    kernel would refuse raises ``ContractViolation`` here."""
    plan = plan_launch(b, kw, n, wb, pwb, bc, dense, sms, tuned)
    if tuned is not None:
        from repro_torch.analysis.contracts import check_placed_plan
        check_placed_plan(entry, plan, b=b, k=k, kw=kw, w_len=w_len, n=n,
                          wb=wb, window_block=pwb, block_cols=bc,
                          dense=dense, tuned=tuned)
    return plan, plan.c_array()


def _plan_of(entry, x, words, col_ids, layout, logical_k, window_block,
             tuned):
    """(plan, C array, geometry) of a launch on ``x``'s device."""
    geom = _geometry(x, words, col_ids, layout, logical_k, window_block,
                     entry)
    b, k, kw, w_len, n, wb, pwb, bc = geom
    sms = devices.sm_count(x.device) if x.is_cuda else SMS
    return (*_plan_array(entry, b, k, kw, w_len, n, wb, pwb, bc,
                         layout == "dense", sms, tuned), geom)


def _launch(entry, x, words, col_ids, mode, layout, logical_k, window_block,
            tuned=None):
    check_mode(mode, layout)
    plan, arr, (b, k, kw, w_len, n, wb, pwb, bc) = _plan_of(
        entry, x, words, col_ids, layout, logical_k, window_block, tuned)
    out = (torch.zeros if plan.n_split > 1 else torch.empty)(
        (b, n), dtype=torch.int32, device=x.device)
    fn = _fn(f"placed_{entry.split('_')[0]}_launch",
             [_P] * 4 + [_I] * 9 + [_P, _I, _P])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), words.data_ptr(), col_ids.data_ptr(),
                out.data_ptr(), b, k, kw, w_len, n, wb, pwb, bc,
                int(layout == "dense"), arr, len(arr), stream)
    if rc != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {rc}")
    return out


def _count(entry: str, x: torch.Tensor, col_ids: torch.Tensor) -> None:
    """Every call of an entry, on either path, keyed by (entry, rows, K,
    N): the tracer's ``placed.calls``."""
    tracing.count("placed.calls", key=(entry, x.shape[0], x.shape[-1],
                                       col_ids.shape[-1]))


def gemm_placed(x: torch.Tensor, words: torch.Tensor, col_ids: torch.Tensor,
                mode: str = "folded", *, layout: str = "bitpack8",
                logical_k: int | None = None,
                window_block: int | None = None,
                tile_plan=None) -> torch.Tensor:
    """Batch-tiled placed GEMM: [B, K] int8 -> [B, N] int32.  ``tile_plan``
    (a ``TunedPlan``) overrides the heuristic launch plan; on the CPU it is
    checked and the plain version runs."""
    _count("gemm_placed", x, col_ids)
    if not x.is_cuda:
        if tile_plan is not None:
            check_mode(mode, layout)
            _plan_of("gemm_placed", x, words, col_ids, layout, logical_k,
                     window_block, tile_plan)
        return gemm_placed_plain(x, words, col_ids, mode, layout=layout,
                                 logical_k=logical_k,
                                 window_block=window_block)
    out = _launch("gemm_placed", x, words, col_ids, mode, layout, logical_k,
                  window_block, tile_plan)
    gemm_placed.launches += 1
    return out


def gemv_placed(x: torch.Tensor, words: torch.Tensor, col_ids: torch.Tensor,
                mode: str = "folded", *, layout: str = "bitpack8",
                logical_k: int | None = None,
                window_block: int | None = None,
                tile_plan=None) -> torch.Tensor:
    """Single-row placed GEMV: [1, K] int8 -> [1, N] int32; ``tile_plan``
    as ``gemm_placed``'s."""
    _count("gemv_placed", x, col_ids)
    if not x.is_cuda:
        if tile_plan is not None:
            check_mode(mode, layout)
            _plan_of("gemv_placed", x, words, col_ids, layout, logical_k,
                     window_block, tile_plan)
        return gemv_placed_plain(x, words, col_ids, mode, layout=layout,
                                 logical_k=logical_k,
                                 window_block=window_block)
    if x.dim() != 2 or x.shape[0] != 1:
        raise ValueError(f"gemv_placed takes one row, got {tuple(x.shape)}")
    out = _launch("gemv_placed", x, words, col_ids, mode, layout, logical_k,
                  window_block, tile_plan)
    gemv_placed.launches += 1
    return out


gemm_placed.launches = 0
gemv_placed.launches = 0
