"""Weights from the seed, on the device, in the tree the port's
``param_defs()`` names.

One generator on the device, one draw per leaf in sorted-key order, in
the leaf's own dtype (bf16 for the served projections).  Kinds follow each
leaf's ``init``: zeros, ones, normal (std 0.02 x scale) or scaled (a
normal of std scale / sqrt(fan-in)).  The fan-in is what the forward pass
contracts: the model dim of an attention head projection [.., D, H, Dh],
the heads of an output projection [.., H, Dh, D] (H x Dh), the latent of
MLA's up-projections [.., R, H, k], and otherwise the second-to-last dim
([.., K, N]); so every product starts near unit scale.  The same tensors go
to the port and to the reference."""
from __future__ import annotations

import math

import torch

from .seeds import sub_seed

_HEAD_IN = ("wq", "wk", "wv", "wuk", "wuv")


def _fan_in(path: tuple, shape: tuple) -> int:
    key = path[-1]
    if "attn" in path and len(shape) >= 3:
        if key in _HEAD_IN:
            return shape[-3]
        if key == "wo":
            return shape[-3] * shape[-2]
    return shape[-2] if len(shape) >= 2 else shape[-1]


def make(defs: dict, seed: int, device) -> dict:
    """The weight tree of ``defs`` (``ParamDef`` leaves) for ``seed``."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, "weights"))

    def leaf(d, path):
        if d.init == "zeros":
            return torch.zeros(d.shape, dtype=d.dtype, device=device)
        if d.init == "ones":
            return torch.ones(d.shape, dtype=d.dtype, device=device)
        std = (d.scale / math.sqrt(_fan_in(path, d.shape))
               if d.init == "scaled" else 0.02 * d.scale)
        out = torch.randn(d.shape, generator=gen, device=device,
                          dtype=d.dtype)
        return out.mul_(std)

    def walk(tree, path):
        if hasattr(tree, "init") and hasattr(tree, "shape"):
            return leaf(tree, path)
        return {k: walk(tree[k], path + (k,)) for k in sorted(tree)}

    return walk(defs, ())
