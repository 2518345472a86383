"""Placed bit-plane GEMM/GEMV: CUDA kernel wrappers, plain versions, counters.

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
"""
from __future__ import annotations

import ctypes

import torch

from . import build
from .ref import bitplane_gemv_ref, densify

MODES = ("planes", "folded")
LAYOUTS = ("dense", "bitpack8")

_P = ctypes.c_void_p
_I = ctypes.c_int


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


def _launch(entry, x, words, col_ids, mode, layout, logical_k, window_block):
    check_mode(mode, layout)
    b, k, kw, w_len, n, wb, pwb, bc = _geometry(
        x, words, col_ids, layout, logical_k, window_block, entry)
    out = torch.empty((b, n), dtype=torch.int32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _fn(f"placed_{entry.split('_')[0]}_launch",
             [_P] * 4 + [_I] * 9 + [_P])(
        x.data_ptr(), words.data_ptr(), col_ids.data_ptr(), out.data_ptr(),
        b, k, kw, w_len, n, wb, pwb, bc, int(layout == "dense"), stream)
    if rc != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {rc}")
    return out


def gemm_placed(x: torch.Tensor, words: torch.Tensor, col_ids: torch.Tensor,
                mode: str = "folded", *, layout: str = "bitpack8",
                logical_k: int | None = None,
                window_block: int | None = None) -> torch.Tensor:
    """Batch-tiled placed GEMM: [B, K] int8 -> [B, N] int32."""
    if not x.is_cuda:
        return gemm_placed_plain(x, words, col_ids, mode, layout=layout,
                                 logical_k=logical_k,
                                 window_block=window_block)
    out = _launch("gemm_placed", x, words, col_ids, mode, layout, logical_k,
                  window_block)
    gemm_placed.launches += 1
    return out


def gemv_placed(x: torch.Tensor, words: torch.Tensor, col_ids: torch.Tensor,
                mode: str = "folded", *, layout: str = "bitpack8",
                logical_k: int | None = None,
                window_block: int | None = None) -> torch.Tensor:
    """Single-row placed GEMV: [1, K] int8 -> [1, N] int32."""
    if not x.is_cuda:
        return gemv_placed_plain(x, words, col_ids, mode, layout=layout,
                                 logical_k=logical_k,
                                 window_block=window_block)
    if x.dim() != 2 or x.shape[0] != 1:
        raise ValueError(f"gemv_placed takes one row, got {tuple(x.shape)}")
    out = _launch("gemv_placed", x, words, col_ids, mode, layout, logical_k,
                  window_block)
    gemv_placed.launches += 1
    return out


gemm_placed.launches = 0
gemv_placed.launches = 0
