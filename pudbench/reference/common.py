"""Layers both references share: RMSNorm, RoPE, SiLU, in the dtype flow
the configurations state (norms and rotations in float32, rounded back to
the activations' bf16; SiLU in bf16)."""
from __future__ import annotations

import torch


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.to(torch.float32)
    xf = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (xf * scale).to(x.dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * (1 / (1 + torch.exp(-x)))


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate x [..., S, H, d] at positions pos [..., S]: the two halves
    of the last dim as the real and imaginary parts, in float32."""
    d = x.shape[-1]
    half = d // 2
    exps = -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    freq = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                  device=x.device), exps)
    ang = pos[..., :, None].to(torch.float32) * freq
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def top_k(v: torch.Tensor, k: int):
    """The k largest along the last dim, ties to the lower index."""
    vals, idx = torch.sort(v, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]
