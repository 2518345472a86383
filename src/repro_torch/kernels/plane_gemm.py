"""Unplaced bit-plane GEMM/GEMV: CUDA kernel wrappers, plain versions,
counters.

Replaces the Pallas kernels ``repro/kernels/bitplane_gemm.py:
bitplane_gemm`` (batch-tiled, ``gemm`` here) and ``repro/kernels/
bitplane_gemv.py: bitplane_gemv`` (B = 1, ``gemv`` here).  Both launch
``csrc/plane_gemm.cu``.  Packs that were not placed (no calibration, a
placement that did not fit, or placement switched off) run through them.

Each takes x [B, K] int8 and either [WB, ceil(K/8), N] uint8 words
(``layout="bitpack8"``, ``logical_k`` = K) or dense [WB, K, N] int8 0/1
planes (``layout="dense"``) and returns [B, N] int32 of x @ (W - 2^(WB-1)).
A CUDA tensor launches the kernel in either layout (the kernel reads dense
planes itself; nothing is repacked first); a CPU tensor runs the plain
version.  ``mode`` ("planes" or "folded") selects an execution schedule in
the reference; both give the same integers, so it is validated and
otherwise ignored.

Decode rows (B <= 16) run ``__dp4a`` on CUDA cores, in a kernel instance
compiled for the pack's plane count (``INSTANCE_WB``; any other runs the
instance that takes it at run time); from ``TC_MIN_ROWS`` = 17 rows
(prefill) the int8 tensor cores run.  Both stage the weight rows and x
through a ring in shared memory with 16-byte ``cp.async`` and split K
across blocks in whole stages.  ``plan_launch`` makes every choice of a
launch on the host from the shapes and the device's SM count (path, rows
per block, stage words, K split, shared memory, grid); the kernel only
checks it, so the CPU tests reach the plan.  Every launch runs with its
tensors' device current.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch import devices

from . import build
from .placed_gemm import (SMS, TC_MIN_ROWS, _cdiv, check_mode,
                          check_operands, fixed_split, split_k)
from .ref import bitplane_gemv_ref, densify

_P = ctypes.c_void_p
_I = ctypes.c_int

TILE_COLS = 128           # output columns per block (both paths)
DP4A_ROWS = (1, 4, 16)    # batch rows per dp4a block
TC_ROWS = (64, 128)       # batch rows per tensor-core block
STAGE_WORDS = (16, 8, 4)  # tensor cores: K words per stage, first choice first
#: dp4a: K words per stage, first choice first, by layout (dense or not).
#: A stage gives each of the 8 warps at least one unit of work: a K word
#: (bit-packed) or four K rows (dense).
DP4A_WORDS = {False: (32, 16, 8), True: (8, 4)}
WARPS = 8                 # warps per block
STAGES = 4                # shared-memory ring depth (both paths)
PAD = 16                  # bytes past 8 * stage words in an x row
WT_STRIDE = TILE_COLS + 8  # 32-bit words per row of the unpacked int8 tile
RING_BUDGET = 112 * 1024  # shared bytes per block that keep two per SM
SMEM_MAX = 232_448        # shared bytes one block may use
INSTANCE_WB = (4, 8)      # dp4a: plane counts compiled in; others at run time


def instance_wb(wb: int) -> int:
    """The plane count the dp4a kernel instance that runs ``wb`` planes is
    compiled for: ``wb`` itself if it is one of ``INSTANCE_WB``, else 0,
    the instance that takes WB at run time."""
    return wb if wb in INSTANCE_WB else 0


def plane_plain(x: torch.Tensor, planes: torch.Tensor, mode: str = "folded",
                *, layout: str = "dense",
                logical_k: int | None = None) -> torch.Tensor:
    """Plain version of both entries: [B, K] int8 -> [B, N] int32.
    Bit-words densify first, then the plain bit-plane GeMV."""
    check_mode(mode, layout)
    x, planes = densify(x, planes, layout, logical_k)
    return bitplane_gemv_ref(x, planes)


gemm_plain = plane_plain
gemv_plain = plane_plain


@dataclasses.dataclass(frozen=True)
class Plan:
    """How one launch of ``csrc/plane_gemm.cu`` covers its operands.

    ``tensor_cores``: the int8 MMA path (prefill rows), else ``__dp4a``.
    ``rows`` batch rows per block (every block owns ``TILE_COLS`` columns);
    ``stage_words`` K words per stage, ``stages`` in the ring (both paths
    stage weight rows and x rows); ``split_words`` K
    words per block along gridDim.z (``n_split`` splits, partial sums added
    into a zeroed output when there is more than one); ``x_row`` shared
    bytes per staged x row; ``w_stage`` and ``stage_bytes`` the weight rows
    and the whole of one stage; ``smem_bytes`` the block's shared memory.
    """
    tensor_cores: bool
    rows: int
    stage_words: int
    stages: int
    split_words: int
    n_split: int
    x_row: int
    w_stage: int
    stage_bytes: int
    smem_bytes: int
    grid: tuple[int, int, int]

    #: field order of the C ``Plan`` struct (the grid follows)
    FIELDS = ("tensor_cores", "rows", "stage_words", "stages",
              "split_words", "n_split", "x_row", "w_stage", "stage_bytes",
              "smem_bytes")

    def c_array(self):
        vals = [int(getattr(self, f)) for f in self.FIELDS] + list(self.grid)
        return (ctypes.c_int * len(vals))(*vals)


@functools.lru_cache(maxsize=512)
def plan_launch(b: int, kw: int, n: int, wb: int, dense: bool,
                sms: int = SMS, tuned=None) -> Plan:
    """The launch plan of one unplaced GEMM/GEMV call, from shapes alone.

    ``b`` batch rows, ``kw`` = ceil(K / 8) K words, ``n`` columns, ``wb``
    planes, ``sms`` the device's SM count.  Below ``TC_MIN_ROWS`` rows the
    dp4a path takes tiles of 1, 4 or 16 rows and stages of
    ``DP4A_WORDS``; from there the tensor-core path takes 64 or 128 rows
    and stages of ``STAGE_WORDS``.  Both stage weight rows and x rows
    through a ring of ``STAGES``, which fits ``RING_BUDGET`` (two blocks per
    SM) at the first stage size that does, else the smallest.  K splits, in
    whole stages, until about ``2 * sms`` blocks are in flight; of the
    stage sizes that fit, the largest that still reaches that many blocks
    wins.

    ``tuned`` (``kernels/autotune.TunedPlan``) overrides the path, rows per
    block, stage words and split count, as in ``placed_gemm.plan_launch``;
    the plan is built as told and ``analysis/contracts`` checks it.
    """
    tiles_n = _cdiv(n, TILE_COLS)
    tc = b >= TC_MIN_ROWS
    if tuned is not None and tuned.tensor_cores is not None:
        tc = tuned.tensor_cores
    if tuned is not None and tuned.rows is not None:
        rows = tuned.rows
    elif tc:
        rows = TC_ROWS[0] if b <= TC_ROWS[0] else TC_ROWS[1]
    else:
        rows = next(r for r in DP4A_ROWS if r >= min(b, DP4A_ROWS[-1]))
    words = STAGE_WORDS if tc else DP4A_WORDS[dense]
    rpw = 8 if dense else 1
    tiles = tiles_n * _cdiv(b, rows)

    def smem(kc):
        x_row = 8 * kc + PAD
        w_stage = wb * rpw * kc * TILE_COLS
        stage = w_stage + rows * x_row
        # tensor cores: the unpacked int8 tile; dp4a: the warps' partial
        # sums of one row, [WARPS, TILE_COLS] int32, in the ring's memory
        total = (STAGES * stage + 2 * kc * WT_STRIDE * 4 if tc else
                 max(STAGES * stage, WARPS * TILE_COLS * 4))
        return x_row, w_stage, stage, total

    fit = [kc for kc in words if smem(kc)[-1] <= RING_BUDGET] or words[-1:]
    if tuned is not None and tuned.stage_words is not None:
        fit = [tuned.stage_words]
    kc, split_words, n_split = split_k(kw, fit, tiles, sms)
    if tuned is not None and tuned.n_split is not None:
        split_words, n_split = fixed_split(kw, kc, tuned.n_split)
    x_row, w_stage, stage, total = smem(kc)
    return Plan(tc, rows, kc, STAGES, split_words, n_split, x_row, w_stage,
                stage, total, (tiles_n, _cdiv(b, rows), n_split))


@functools.lru_cache(maxsize=512)
def _plan_array(entry, b, k, kw, n, wb, dense, sms, tuned):
    """The plan of one launch and its C array; a tuned plan is held to the
    kernel's invariants first (``analysis/contracts``)."""
    plan = plan_launch(b, kw, n, wb, dense, sms, tuned)
    if tuned is not None:
        from repro_torch.analysis.contracts import check_plane_plan
        check_plane_plan(entry, plan, b=b, k=k, kw=kw, n=n, wb=wb,
                         dense=dense, tuned=tuned)
    return plan, plan.c_array()


def _plan_of(entry, x, words, layout, logical_k, tuned):
    """(plan, C array, (B, K, Kw, N, WB)) of a launch on ``x``'s device."""
    kw = check_operands(entry, x, words, layout, logical_k)
    b, k = x.shape
    wb, _, n = words.shape
    sms = devices.sm_count(x.device) if x.is_cuda else SMS
    return (*_plan_array(entry, b, k, kw, n, wb, layout == "dense", sms,
                         tuned), (b, k, kw, n, wb))


def _fn(name: str):
    fn = getattr(build.load("plane_gemm"), name)
    if fn.argtypes is None:
        fn.argtypes = [_P] * 3 + [_I] * 6 + [_P, _I, _P]
        fn.restype = ctypes.c_int
    return fn


def _launch(entry: str, x, words, mode, layout, logical_k,
            tuned=None) -> torch.Tensor:
    check_mode(mode, layout)
    plan, arr, (b, k, kw, n, wb) = _plan_of(entry, x, words, layout,
                                            logical_k, tuned)
    out = (torch.zeros if plan.n_split > 1 else torch.empty)(
        (b, n), dtype=torch.int32, device=x.device)
    fn = _fn(f"plane_{entry}_launch")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), words.data_ptr(), out.data_ptr(), b, k, kw, n,
                wb, int(layout == "dense"), arr, len(arr), stream)
    if rc != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {rc}")
    return out


def gemm(x: torch.Tensor, words: torch.Tensor, mode: str = "folded", *,
         layout: str = "bitpack8", logical_k: int | None = None,
         tile_plan=None) -> torch.Tensor:
    """Batch-tiled unplaced GEMM: [B, K] int8 -> [B, N] int32.
    ``tile_plan`` (a ``TunedPlan``) overrides the heuristic launch plan; on
    the CPU it is checked and the plain version runs."""
    if not x.is_cuda:
        if tile_plan is not None:
            check_mode(mode, layout)
            _plan_of("gemm", x, words, layout, logical_k, tile_plan)
        return gemm_plain(x, words, mode, layout=layout, logical_k=logical_k)
    out = _launch("gemm", x, words, mode, layout, logical_k, tile_plan)
    gemm.launches += 1
    return out


def gemv(x: torch.Tensor, words: torch.Tensor, mode: str = "folded", *,
         layout: str = "bitpack8", logical_k: int | None = None,
         tile_plan=None) -> torch.Tensor:
    """Single-row unplaced GEMV: [1, K] int8 -> [1, N] int32; ``tile_plan``
    as ``gemm``'s."""
    if not x.is_cuda:
        if tile_plan is not None:
            check_mode(mode, layout)
            _plan_of("gemv", x, words, layout, logical_k, tile_plan)
        return gemv_plain(x, words, mode, layout=layout, logical_k=logical_k)
    if x.dim() != 2 or x.shape[0] != 1:
        raise ValueError(f"gemv takes one row, got {tuple(x.shape)}")
    out = _launch("gemv", x, words, mode, layout, logical_k, tile_plan)
    gemv.launches += 1
    return out


gemm.launches = 0
gemv.launches = 0
