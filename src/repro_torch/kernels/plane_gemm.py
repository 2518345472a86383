"""Unplaced bit-plane GEMM/GEMV: CUDA kernel wrappers, plain versions,
counters.

Replaces the Pallas kernels ``repro/kernels/bitplane_gemm.py:
bitplane_gemm`` (batch-tiled, ``gemm`` here) and ``repro/kernels/
bitplane_gemv.py: bitplane_gemv`` (B = 1, ``gemv`` here).  Both launch
``csrc/plane_gemm.cu``.  Packs that were not placed (no calibration, a
placement that did not fit, or placement switched off) run through them.

Each takes x [B, K] int8 and [WB, ceil(K/8), N] uint8 words (``layout=
"bitpack8"``, ``logical_k`` = K) and returns [B, N] int32 of
x @ (W - 2^(WB-1)).  A CUDA tensor launches the kernel, which takes the
bit-packed layout only and raises on the dense one; a CPU tensor runs the
plain version, which takes both layouts.  ``mode`` ("planes" or "folded")
selects an execution schedule in the reference; both give the same
integers, so it is validated and otherwise ignored.
"""
from __future__ import annotations

import ctypes

import torch

from . import build
from .placed_gemm import check_mode
from .ref import bitplane_gemv_ref, densify

_P = ctypes.c_void_p
_I = ctypes.c_int


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


def _fn(name: str):
    fn = getattr(build.load("plane_gemm"), name)
    if fn.argtypes is None:
        fn.argtypes = [_P] * 3 + [_I] * 5 + [_P]
        fn.restype = ctypes.c_int
    return fn


def _launch(entry: str, x, words, mode, layout, logical_k) -> torch.Tensor:
    check_mode(mode, layout)
    if layout != "bitpack8":
        raise NotImplementedError(
            f"{entry}: the CUDA kernel takes bit-packed words only; the "
            "dense layout has no GPU kernel yet")

    def need(cond, msg):
        if not cond:
            raise ValueError(f"{entry}: {msg}")

    need(x.dtype == torch.int8 and x.dim() == 2,
         f"x must be [B, K] int8, got {x.dtype} {tuple(x.shape)}")
    need(words.dtype == torch.uint8 and words.dim() == 3,
         f"words must be [WB, Kw, N] uint8, got {words.dtype} "
         f"{tuple(words.shape)}")
    need(words.device == x.device, "all tensors on one device")
    need(x.is_contiguous() and words.is_contiguous(),
         "tensors must be contiguous")
    b, k = x.shape
    wb, kw, n = words.shape
    need(b > 0 and n > 0 and k > 0, "empty operand")
    need(1 <= wb <= 8, f"{wb} bit-planes; the kernel takes 1..8")
    need((logical_k or kw * 8) == k and kw * 8 - 8 < k <= kw * 8,
         f"x K={k} inconsistent with words Kw={kw} (logical_k={logical_k})")
    out = torch.zeros((b, n), dtype=torch.int32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _fn(f"plane_{entry}_launch")(x.data_ptr(), words.data_ptr(),
                                      out.data_ptr(), b, k, kw, n, wb, stream)
    if rc != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {rc}")
    return out


def gemm(x: torch.Tensor, words: torch.Tensor, mode: str = "folded", *,
         layout: str = "bitpack8",
         logical_k: int | None = None) -> torch.Tensor:
    """Batch-tiled unplaced GEMM: [B, K] int8 -> [B, N] int32."""
    if not x.is_cuda:
        return gemm_plain(x, words, mode, layout=layout, logical_k=logical_k)
    out = _launch("gemm", x, words, mode, layout, logical_k)
    gemm.launches += 1
    return out


def gemv(x: torch.Tensor, words: torch.Tensor, mode: str = "folded", *,
         layout: str = "bitpack8",
         logical_k: int | None = None) -> torch.Tensor:
    """Single-row unplaced GEMV: [1, K] int8 -> [1, N] int32."""
    if not x.is_cuda:
        return gemv_plain(x, words, mode, layout=layout, logical_k=logical_k)
    if x.dim() != 2 or x.shape[0] != 1:
        raise ValueError(f"gemv takes one row, got {tuple(x.shape)}")
    out = _launch("gemv", x, words, mode, layout, logical_k)
    gemv.launches += 1
    return out


gemm.launches = 0
gemv.launches = 0
