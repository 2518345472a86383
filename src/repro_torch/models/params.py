"""Parameter definitions and initialisation (port of ``repro/models/params.py``).

A model is described by a nested dict of ``ParamDef``s (shape, dtype,
initialiser, logical axes); ``init_params`` materialises it on a device from
a seed, one ``torch.Generator`` stream per leaf path.  The tree structure
and leaf names are the reference's, so a parameter tree initialised by the
JAX package carries across with ``from_numpy``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core.rng import generator

#: An initialiser's signature: (generator, shape, dtype) -> tensor.
Initializer = Callable[[torch.Generator, tuple[int, ...], Any], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]          # logical axis per dim
    dtype: torch.dtype = torch.float32
    init: str = "normal"                  # normal | zeros | ones | scaled
    scale: float = 1.0

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes}")


def is_def(x) -> bool:
    return isinstance(x, ParamDef)


#: Leaves of more elements than this draw slice by slice (``_init_one``);
#: every leaf of qwen3-1.7b and gemma-7b draws at once.
_DRAW_ELEMS = 2 ** 30


def _init_one(defn: ParamDef, gen: torch.Generator,
              device: torch.device) -> torch.Tensor:
    if defn.init == "zeros":
        return torch.zeros(defn.shape, dtype=defn.dtype, device=device)
    if defn.init == "ones":
        return torch.ones(defn.shape, dtype=defn.dtype, device=device)
    if defn.init == "scaled":  # fan-in scaled normal
        fan_in = defn.shape[-2] if len(defn.shape) >= 2 else defn.shape[-1]
        std = defn.scale / math.sqrt(max(1, fan_in))
    else:
        std = defn.scale * 0.02
    if math.prod(defn.shape) <= _DRAW_ELEMS:
        x = torch.randn(defn.shape, generator=gen, device=device,
                        dtype=torch.float32)
        return (x * std).to(defn.dtype)
    # a larger leaf (MoE expert banks: deepseek-v2-lite's [26, 64, 2048,
    # 1408]) draws one leading slice at a time, so no float32 copy of the
    # whole leaf is made
    out = torch.empty(defn.shape, dtype=defn.dtype, device=device)
    for i in range(defn.shape[0]):
        x = torch.randn(defn.shape[1:], generator=gen, device=device,
                        dtype=torch.float32)
        out[i] = (x * std).to(defn.dtype)
    return out


def init_params(defs: dict, seed: int, device) -> dict:
    """Materialise a ParamDef tree on ``device``; each leaf draws from its
    own generator seeded by ``(seed, leaf path)``.

    Keys come out sorted at every level, as the reference's pytree
    flattening orders them: the packer's placement requests follow tree
    order, and their order keys persisted placements and decides first-fit
    allocation.
    """
    device = torch.device(device)

    def walk(tree, path):
        if is_def(tree):
            return _init_one(tree, generator(seed, "params", *path,
                                             device=device), device)
        return {k: walk(tree[k], path + (k,)) for k in sorted(tree)}

    return walk(defs, ())


def abstract_params(defs: dict) -> dict:
    """The ParamDef tree as meta tensors: shapes and dtypes, no storage
    (a restore template)."""
    if is_def(defs):
        return torch.empty(defs.shape, dtype=defs.dtype, device="meta")
    return {k: abstract_params(defs[k]) for k in sorted(defs)}


def param_count(defs: dict) -> int:
    if is_def(defs):
        return math.prod(defs.shape)
    return sum(param_count(v) for v in defs.values())


def stack_defs(defs: dict, n: int) -> dict:
    """Prepend a stacked-layer dim of size n to every ParamDef in the tree."""
    if is_def(defs):
        return ParamDef((n,) + defs.shape, ("stack",) + defs.axes,
                        defs.dtype, defs.init, defs.scale)
    return {k: stack_defs(v, n) for k, v in defs.items()}


def _tensor_from_numpy(a: np.ndarray, device) -> torch.Tensor:
    a = np.array(a)          # a writable, contiguous copy
    if a.dtype.name == "bfloat16":   # ml_dtypes bfloat16: reinterpret bits
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def from_numpy(tree, device) -> dict:
    """A parameter tree of numpy arrays (e.g. the reference's tree after
    ``jax.tree.map(np.asarray, params)``) -> the same tree of tensors on
    ``device``, with the same structure and dtypes."""
    if isinstance(tree, dict):
        return {k: from_numpy(v, device) for k, v in tree.items()}
    return _tensor_from_numpy(np.asarray(tree), torch.device(device))
