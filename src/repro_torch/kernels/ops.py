"""Public entry points of the bit-plane path (port of ``repro/kernels/ops.py``):
activation quantization and the quantize -> GEMM -> dequantize dispatch."""
from __future__ import annotations

import torch

from .backends import DEFAULT_BACKEND, get_backend

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
) -> torch.Tensor:
    """Quantize -> bit-plane GEMM -> dequantize; returns [B, N] float32.

    B = 1 runs the GEMV entry, B > 1 the batch-tiled GEMM entry; with
    ``col_ids`` the placed entries.  The dequant is ``acc.float() * x_scale
    * w_scale`` in that order, as in the reference.
    """
    xq, x_scale = quantize_activations(x)
    be = get_backend(backend or DEFAULT_BACKEND)
    batched = xq.shape[0] > 1
    kw = {"layout": layout, "logical_k": logical_k}
    if col_ids is not None:
        entry = be.gemm_placed if batched else be.gemv_placed
        acc = entry(xq, planes, col_ids, mode, window_block=window_block,
                    **kw)
    else:
        entry = be.gemm if batched else be.gemv
        acc = entry(xq, planes, mode, **kw)
    return acc.to(torch.float32) * x_scale * w_scale
