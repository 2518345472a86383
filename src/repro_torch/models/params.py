"""Parameter definitions, initialisation and partition specs (port of
``repro/models/params.py``).

A model is described by a nested dict of ``ParamDef``s (shape, dtype,
initialiser, logical axes); ``init_params`` materialises it on a device from
a seed, one ``torch.Generator`` stream per leaf path.  The tree structure
and leaf names are the reference's, so a parameter tree initialised by the
JAX package carries across with ``from_numpy``.

``param_pspecs`` maps each leaf's logical axes to mesh axes through a rules
table (``DEFAULT_RULES``: the heads / mlp / vocab / experts / ssm dims on
"model", the "embed" dim on "data"); ``runtime/sharding.py`` cuts leaves
into per-position shards by those specs.
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


def tree_leaves(tree) -> list:
    """The leaves of a nested dict in sorted-key order (the reference's
    pytree order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def abstract_params(defs: dict) -> dict:
    """The ParamDef tree as meta tensors: shapes and dtypes, no storage
    (a restore template)."""
    if is_def(defs):
        return torch.empty(defs.shape, dtype=defs.dtype, device="meta")
    return {k: abstract_params(defs[k]) for k in sorted(defs)}


class PartitionSpec(tuple):
    """One entry per dimension: a mesh axis name, a tuple of them, or None
    (replicated); the port's ``jax.sharding.PartitionSpec``."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec

# Default logical->mesh rules: 2-D FSDP("data") x TP("model").
DEFAULT_RULES: dict[str | None, str | None] = {
    "vocab": "model",
    "vocab_in": None,
    "heads": "model",
    "heads_act": "model",   # attention activations (padded to divisibility)
    "kv_heads": "model",
    "head_dim": None,
    "kv_seq": None,
    "mlp": "model",
    "experts": "model",
    "moe_mlp": None,     # expert FFN hidden: EP already takes "model"
    "frames": None,      # enc-dec cross-attn source length (1500, indivisible)
    "ssm": "model",
    "embed": "data",
    "stack": None,
    "conv": None,
    "norm": None,
    None: None,
}


def param_pspecs(defs, rules: dict | None = None):
    """A ``PartitionSpec`` tree (sorted keys) from the leaves' logical axes
    through ``DEFAULT_RULES`` updated by ``rules``."""
    merged = dict(DEFAULT_RULES)
    merged.update(rules or {})
    return tree_map(lambda d: PartitionSpec(*(merged.get(a, None)
                                              for a in d.axes)), defs)


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
