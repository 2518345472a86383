"""The 4-bit weight and 8-bit activation quantizers, frozen here (the
port's ``pud/gemv._quantize_weights`` and ``kernels/ops.
quantize_activations`` at the time this benchmark was written), and the
exact product they define."""
from __future__ import annotations

import torch


def quantize_weights(w: torch.Tensor, n_bits: int = 4):
    """(q [K, N] integers in w's dtype, scale [N]): symmetric per output
    column in w's own dtype; scale = max|w| / qmax, q = clip(round(w /
    scale)), round half to even."""
    qmax = (1 << (n_bits - 1)) - 1
    eps = torch.tensor(1e-8, dtype=w.dtype, device=w.device)
    div = torch.tensor(float(qmax), dtype=w.dtype, device=w.device)
    scale = torch.maximum(w.abs().amax(dim=0), eps) / div
    q = torch.clamp(torch.round(w / scale[None, :]), -qmax - 1, qmax)
    return q, scale


def quantize_activations(x: torch.Tensor):
    """(q [B, K] int8, scale [B, 1] in x's dtype): symmetric per row."""
    eps = torch.tensor(1e-6, dtype=x.dtype, device=x.device)
    d127 = torch.tensor(127.0, dtype=x.dtype, device=x.device)
    scale = torch.maximum(x.abs().amax(dim=-1, keepdim=True), eps) / d127
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


class Packed:
    """A 4-bit projection re-derived from its bf16 weight [K, N]: the
    integers as float64 (exact) and the per-column scale as float32."""

    def __init__(self, w: torch.Tensor, n_bits: int = 4):
        q, scale = quantize_weights(w, n_bits)
        self.q = q.to(torch.float64)
        self.scale = scale.to(torch.float32)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """x [..., K] -> [..., N] float32: the integer product, exact in
        float64, times the row scale, then the column scale."""
        lead = x.shape[:-1]
        xq, xs = quantize_activations(x.reshape(-1, x.shape[-1]))
        acc = (xq.to(torch.float64) @ self.q).to(torch.float32)
        y = acc * xs * self.scale[None, :]
        return y.reshape(lead + (y.shape[-1],))
