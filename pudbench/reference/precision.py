"""The precision a reference computes its bf16 products in: the
configuration's (``bf16``: operands in bf16, float32 accumulation), or the
control's one step below it (``fp8``: each operand rounded to float8 e4m3,
scaled per tensor into its range, before the same product)."""
from __future__ import annotations

import torch

_FP8_MAX = 448.0


def _fp8(t: torch.Tensor) -> torch.Tensor:
    amax = t.detach().abs().amax().to(torch.float32).clamp(min=1e-12)
    s = _FP8_MAX / amax
    q = (t.to(torch.float32) * s).to(torch.float8_e4m3fn)
    return (q.to(torch.float32) / s).to(t.dtype)


class Precision:
    def __init__(self, name: str):
        if name not in ("bf16", "fp8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def cast(self, t: torch.Tensor) -> torch.Tensor:
        """An operand of a bf16 product as this precision holds it."""
        return _fp8(t) if self.name == "fp8" else t

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """x [..., K] @ w [K, N] in bf16 (rounded to bf16)."""
        return self.cast(x) @ self.cast(w.to(x.dtype))

    def einsum(self, eq: str, a: torch.Tensor, b: torch.Tensor):
        return torch.einsum(eq, self.cast(a), self.cast(b.to(a.dtype)))
