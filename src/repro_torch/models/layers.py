"""Shared layer library (port of ``repro/models/layers.py``): RMSNorm,
projections with PUD dispatch, embeddings, RoPE, the gated FFN.

Plain functions over a parameter dict and tensors, in the reference's
dtype flow: norms compute in float32 and return the input dtype, RoPE
rotates in float32, projections run in the activation dtype.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .params import ParamDef

ACT = {
    "silu": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "relu": F.relu,
}


def rmsnorm_defs(dim: int) -> dict:
    return {"scale": ParamDef((dim,), ("norm",), init="ones")}


def rmsnorm(p, x: torch.Tensor, eps: float = 1e-6,
            zero_centered: bool = False) -> torch.Tensor:
    dtype = x.dtype
    x = x.to(torch.float32)
    var = (x * x).mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    scale = p["scale"] + 1.0 if zero_centered else p["scale"]
    return (x * scale).to(dtype)


def embed_defs(vocab: int, d_model: int, dtype=torch.bfloat16) -> dict:
    return {"table": ParamDef((vocab, d_model), ("vocab_in", "embed"),
                              dtype=dtype, init="normal")}


def embed(p, tokens: torch.Tensor) -> torch.Tensor:
    return p["table"][tokens.long()]


def unembed_defs(d_model: int, vocab: int, dtype=torch.bfloat16) -> dict:
    return {"w": ParamDef((d_model, vocab), ("embed", "vocab"), dtype=dtype,
                          init="scaled")}


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0,
         rotary_dims: int | None = None) -> torch.Tensor:
    """x: [..., S, H, D]; positions: [..., S].  Rotates the first
    ``rotary_dims`` (default all) dims in float32."""
    d = x.shape[-1] if rotary_dims is None else rotary_dims
    half = d // 2
    exps = -torch.arange(0, half, dtype=torch.float32,
                         device=x.device) / half
    freq = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                  device=x.device), exps)
    angles = positions[..., :, None].to(torch.float32) * freq
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x_rot, x_pass = x[..., :d], x[..., d:]
    x1, x2 = x_rot[..., :half], x_rot[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                    dim=-1).to(x.dtype)
    return torch.cat([out, x_pass], dim=-1) if d < x.shape[-1] else out


def ffn_defs(d_model: int, d_ff: int, gated: bool = True,
             dtype=torch.bfloat16) -> dict:
    defs = {
        "wi": ParamDef((d_model, d_ff), ("embed", "mlp"), dtype=dtype,
                       init="scaled"),
        "wo": ParamDef((d_ff, d_model), ("mlp", "embed"), dtype=dtype,
                       init="scaled"),
    }
    if gated:
        defs["wg"] = ParamDef((d_model, d_ff), ("embed", "mlp"), dtype=dtype,
                              init="scaled")
    return defs


def linear(p, name: str, x: torch.Tensor) -> torch.Tensor:
    """Projection dispatch: the PUD bit-plane GEMM when ``<name>_pud``
    (a ``PackedTensor``) is present, a plain matmul otherwise."""
    packed = p.get(name + "_pud")
    if packed is not None:
        from repro_torch.pud.gemv import pud_linear
        return pud_linear(x, packed).to(x.dtype)
    return x @ p[name].to(x.dtype)


def ffn(p, x: torch.Tensor, activation: str = "silu") -> torch.Tensor:
    act = ACT[activation]
    h = linear(p, "wi", x)
    if "wg" in p or "wg_pud" in p:
        h = act(linear(p, "wg", x)) * h
    else:
        h = act(h)
    return linear(p, "wo", h)


def logits_last(unembed_p, h_last: torch.Tensor) -> torch.Tensor:
    """Decode-time logits for the last position only. h_last: [B, D]."""
    return linear(unembed_p, "w", h_last).to(torch.float32)
