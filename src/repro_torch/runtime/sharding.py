"""Sharding rules and per-position shards (port of
``repro/runtime/sharding.py``).

Mesh axes (``launch/mesh.py``): ("data", "model") single-pod, ("pod",
"data", "model") multi-pod.  Policy, as the reference's:

  batch                 -> ("pod", "data")   (data parallelism)
  params "embed" dim    -> "data"            (FSDP / ZeRO-3 storage)
  params TP dims        -> "model"           (heads / mlp / experts / vocab)
  optimizer state       -> same as params    (ZeRO)

``mesh_axes``, ``batch_axes``, ``make_rules``, ``model_param_pspecs``,
``cache_pspecs``, ``input_pspecs``, ``named``, ``sharded_pack_specs`` and
``put_sharded_pack`` are the reference's.  In place of
``jax.device_put(tree, named(mesh, specs))``, ``device_put`` cuts every
leaf by its spec into one ``ShardedTensor`` holding a local tensor per
mesh position, on that position's device; ``gather`` puts a leaf back
together.

A dimension mapped to axes of total size k is cut into k blocks of
``ceil(n / k)`` rows, the last ones shorter or empty when k does not
divide n (``shard_bounds``; JAX's uneven shards are padded to that block
size too).  A position holds the blocks its coordinates on the mapped
axes select, and a copy of the whole dimension where no axis maps to it:
positions that differ only on axes a leaf does not use hold equal copies.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.launch.mesh import Mesh
from repro_torch.models.params import DEFAULT_RULES, PartitionSpec, \
    param_pspecs, tree_map

P = PartitionSpec


def mesh_axes(mesh: Mesh) -> tuple[str, ...]:
    return tuple(mesh.axis_names)


def batch_axes(mesh: Mesh):
    return ("pod", "data") if "pod" in mesh.axis_names else "data"


def make_rules(mesh: Mesh, overrides: dict | None = None) -> dict:
    rules = dict(DEFAULT_RULES)
    rules["batch"] = batch_axes(mesh)
    rules.update(overrides or {})
    return rules


def model_param_pspecs(model, mesh: Mesh, overrides: dict | None = None):
    return param_pspecs(model.param_defs(), make_rules(mesh, overrides))


def cache_pspecs(model, mesh: Mesh, batch: int, max_len: int,
                 overrides: dict | None = None):
    return param_pspecs(model.cache_defs(batch, max_len),
                        make_rules(mesh, overrides))


def input_pspecs(specs: dict, mesh: Mesh) -> dict:
    """PartitionSpec per input (anything with ``ndim``): the leading dim on
    the batch axes, the rest replicated; scalars replicate."""
    b = batch_axes(mesh)
    return {name: P() if s.ndim == 0 else P(*((b,) + (None,) * (s.ndim - 1)))
            for name, s in specs.items()}


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the port's ``jax.sharding.NamedSharding``)."""

    mesh: Mesh
    spec: PartitionSpec


def named(mesh: Mesh, spec_tree):
    return tree_map(lambda s: NamedSharding(mesh, s), spec_tree)


# -- per-position shards ------------------------------------------------------

def shard_bounds(n: int, k: int, i: int) -> tuple[int, int]:
    """Rows [start, stop) of block ``i`` of ``k`` over a dimension of
    ``n``: blocks of ``ceil(n / k)``, the trailing ones short or empty."""
    c = -(-n // k)
    return min(i * c, n), min((i + 1) * c, n)


def _dim_axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def _check(sharding: NamedSharding, ndim: int) -> None:
    spec, names = sharding.spec, sharding.mesh.axis_names
    if len(spec) > ndim:
        raise ValueError(f"spec {spec} has more entries than {ndim} dims")
    used = [a for e in spec for a in _dim_axes(e)]
    if len(used) != len(set(used)) or not set(used) <= set(names):
        raise ValueError(f"spec {spec} does not fit mesh axes {names}")


def block_index(sharding: NamedSharding, coord) -> list[tuple[int, int]]:
    """Per dimension of the spec: (block, block count) of the position at
    ``coord`` (count 1 where no axis maps to the dimension)."""
    mesh = sharding.mesh
    at = dict(zip(mesh.axis_names, coord))
    sizes = mesh.shape
    out = []
    for entry in sharding.spec:
        blk, cnt = 0, 1
        for a in _dim_axes(entry):      # row-major over the axes listed
            blk, cnt = blk * sizes[a] + at[a], cnt * sizes[a]
        out.append((blk, cnt))
    return out


def local_slices(sharding: NamedSharding, shape, coord) -> tuple:
    """The slices of a global tensor of ``shape`` that position ``coord``
    holds."""
    sl = [slice(*shard_bounds(shape[d], cnt, blk))
          for d, (blk, cnt) in enumerate(block_index(sharding, coord))]
    return tuple(sl) + (slice(None),) * (len(shape) - len(sl))


@dataclasses.dataclass
class ShardedTensor:
    """One leaf as per-position shards: ``shards[coord]`` is the local
    tensor of the mesh position at ``coord``, on that position's device.
    ``shape`` and ``dtype`` are the global leaf's."""

    sharding: NamedSharding
    shape: tuple[int, ...]
    dtype: torch.dtype
    shards: dict

    @property
    def mesh(self) -> Mesh:
        return self.sharding.mesh

    def canonical(self) -> list:
        """(coord, shard) of one holder of each distinct block: the
        position with coordinate 0 on every axis the spec does not use.
        Sums over a leaf (norms) count each element once over these."""
        used = {a for e in self.sharding.spec for a in _dim_axes(e)}
        names = self.mesh.axis_names
        return [(c, t) for c, t in self.shards.items()
                if all(i == 0 for a, i in zip(names, c) if a not in used)]

    def local_bytes(self) -> dict:
        return {c: t.numel() * t.element_size()
                for c, t in self.shards.items()}


def put(x: torch.Tensor, sharding: NamedSharding) -> ShardedTensor:
    """Cut ``x`` by ``sharding`` into a copy per position (the
    reference's ``device_put`` of one leaf)."""
    _check(sharding, x.dim())
    mesh, shards = sharding.mesh, {}
    for c in mesh.positions():
        part = x[local_slices(sharding, x.shape, c)]
        shards[c] = torch.empty(part.shape, dtype=x.dtype,
                                device=mesh.device(c)).copy_(part)
    return ShardedTensor(sharding, tuple(x.shape), x.dtype, shards)


def zeros(shape, dtype, sharding: NamedSharding) -> ShardedTensor:
    """Zeros of a global ``shape``, created per position in place."""
    _check(sharding, len(shape))
    mesh, shards = sharding.mesh, {}
    for c in mesh.positions():
        sl = local_slices(sharding, shape, c)
        local = tuple(len(range(*s.indices(n))) for s, n in zip(sl, shape))
        shards[c] = torch.zeros(local, dtype=dtype, device=mesh.device(c))
    return ShardedTensor(sharding, tuple(shape), dtype, shards)


def gather(st: ShardedTensor, device) -> torch.Tensor:
    """The whole leaf on ``device`` (an all-gather of its blocks)."""
    full = torch.empty(st.shape, dtype=st.dtype, device=device)
    for c, t in st.canonical():
        full[local_slices(st.sharding, st.shape, c)].copy_(t)
    return full


def is_sharded(x) -> bool:
    return isinstance(x, ShardedTensor)


def device_put(tree, shardings):
    """A tree of tensors -> the same tree of ``ShardedTensor``s
    (``shardings``: a tree of ``NamedSharding`` of the same structure)."""
    return tree_map(put, tree, shardings)


def gather_tree(tree, device):
    """A tree of ``ShardedTensor``s -> the whole leaves on ``device``;
    plain tensors are moved there."""
    return tree_map(lambda x: gather(x, device) if is_sharded(x)
                     else x.to(device), tree)


def bytes_per_position(tree) -> dict:
    """{coord: bytes held} over every ``ShardedTensor`` of ``tree``."""
    out: dict = {}

    def add(x):
        if is_sharded(x):
            for c, n in x.local_bytes().items():
                out[c] = out.get(c, 0) + n
        return x
    tree_map(add, tree)
    return out


def replicated_sum(st: ShardedTensor, fn) -> torch.Tensor:
    """sum over the distinct blocks of ``fn(block)`` (0-d float32 tensors),
    on the first position's device, in position order."""
    dev = st.mesh.device(st.mesh.positions()[0])
    total = torch.zeros((), dtype=torch.float32, device=dev)
    for _, t in st.canonical():
        total = total + fn(t).to(dev)
    return total


# -- sharded PUD packs --------------------------------------------------------

def sharded_pack_specs(st, axis: str = "model") -> dict:
    """PartitionSpecs of a ``pud.packed.ShardedPackedTensor``'s stacked
    children (``st.stacked()``: planes [L?, S, WB, Kw, R], scale and
    col_ids [L?, S, Np]).  The shard axis S maps onto ``axis``, at a fixed
    offset from the end (4 for planes, 2 for the others), which keeps the
    spec right for single and stacked-layer packs; every other dim
    replicates."""
    def spec(ndim: int, s_from_end: int) -> PartitionSpec:
        axes: list = [None] * ndim
        axes[ndim - s_from_end] = axis
        return P(*axes)

    shard = st.shards[0]
    fields = [("planes", 4), ("scale", 2)]
    if shard.col_ids is not None:
        fields.append(("col_ids", 2))
    return {name: spec(getattr(shard, name).dim() + 1, off)
            for name, off in fields}


def put_sharded_pack(st):
    """Every shard of a sharded pack on its position's device (a no-op
    for a pack the fleet built there); the numbers do not change."""
    if st.devices is None:
        raise ValueError("sharded pack carries no mesh — build it through "
                         "PUDFleetSession.pack / pack_model_sharded(mesh=...)")

    def move(pt, dev):
        kw = {n: getattr(pt, n).to(dev) for n in ("planes", "scale",
                                                  "col_ids")
              if getattr(pt, n) is not None}
        return pt.replace(**kw)
    return st.replace(shards=tuple(move(s, d) for s, d in
                                   zip(st.shards, st.devices)))
