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

``count_transfers`` counts, inside its block, the bytes that cross
between positions: what ``gather`` and ``put`` copy from one position to
another, the float32 gradient blocks of the sharded train step's
reduce-scatter (``runtime/steps.reduce_grads_at``), and the collectives of
a lane's "model" group (``models/sharding_ctx.ModelGroup``: "all-reduce"
of partial sums, "all-gather" of split activations), under the
reference's collective kinds.  Positions are told apart by coordinate, not by device:
every position of a one-card or meta mesh shares a device.  Outside the
block nothing is counted.
"""
from __future__ import annotations

import contextlib
import contextvars
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
    reference's ``device_put`` of one leaf).  ``x`` counts as sitting at
    the mesh's first position (where ``optim`` gathers a leaf to compress
    it): the copies to the others count as "collective-permute"."""
    _check(sharding, x.dim())
    mesh, shards = sharding.mesh, {}
    home = mesh.positions()[0]
    for c in mesh.positions():
        part = x[local_slices(sharding, x.shape, c)]
        shards[c] = torch.empty(part.shape, dtype=x.dtype,
                                device=mesh.device(c)).copy_(part)
        moved("collective-permute", home, c,
              part.numel() * part.element_size())
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


def gather(st: ShardedTensor, device, at=None, rows: int | None = None,
           keep: str | None = None) -> torch.Tensor:
    """The whole leaf on ``device`` (an all-gather of its blocks).

    Without ``at`` the blocks come from ``canonical()``'s holders.  With
    ``at``, the receiving position's coordinates, each block comes from
    the holder that agrees with ``at`` on the axes the leaf's spec does
    not use, the blocks from other positions count as "all-gather"
    (``count_transfers``), and a leaf that ``at`` holds whole on
    ``device`` comes back as ``at``'s own shard, not copied.  ``rows`` (a
    dimension) keeps only ``at``'s block along it: a lane's rows of a
    cache.  ``keep`` (a mesh axis) keeps only ``at``'s block of the
    dimension that axis maps to: a position's own "model" block, gathered
    over the other axes."""
    names = st.mesh.axis_names
    ref = (0,) * len(names) if at is None else tuple(at)
    want = local_slices(st.sharding, st.shape, ref)
    own_dims = [] if rows is None else [rows]
    if keep is not None:
        own_dims += [d for d, e in enumerate(st.sharding.spec)
                     if keep in _dim_axes(e)]
    shape = list(st.shape)
    for d in own_dims:
        shape[d] = want[d].stop - want[d].start
    own = None if at is None else st.shards.get(ref)
    if (own is not None and tuple(own.shape) == tuple(shape)
            and own.device == torch.device(device)):
        return own
    used = {a for e in st.sharding.spec for a in _dim_axes(e)}
    full = torch.empty(shape, dtype=st.dtype, device=device)
    for c, t in st.shards.items():
        if any(i != r for a, i, r in zip(names, c, ref) if a not in used):
            continue
        sl = list(local_slices(st.sharding, st.shape, c))
        if any(sl[d] != want[d] for d in own_dims):
            continue
        for d in own_dims:
            sl[d] = slice(0, shape[d])
        full[tuple(sl)].copy_(t)
        if at is not None:
            moved("all-gather", c, ref, t.numel() * t.element_size())
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


# -- bytes that cross between positions -------------------------------------

#: The reference's collective kinds (``repro/launch/hlo_analysis.py``).
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")


@dataclasses.dataclass
class Transfers:
    """Bytes and copies that crossed between positions, by kind."""

    bytes: dict = dataclasses.field(
        default_factory=lambda: dict.fromkeys(COLLECTIVES, 0))
    counts: dict = dataclasses.field(
        default_factory=lambda: dict.fromkeys(COLLECTIVES, 0))


_TRANSFERS: contextvars.ContextVar[Transfers | None] = contextvars.ContextVar(
    "repro_torch_transfers", default=None)


@contextlib.contextmanager
def count_transfers():
    """Count the position-crossing copies made in the block into the
    ``Transfers`` yielded (an enclosing count sees none of them)."""
    rec = Transfers()
    token = _TRANSFERS.set(rec)
    try:
        yield rec
    finally:
        _TRANSFERS.reset(token)


def moved(kind: str, src, dst, nbytes: int) -> None:
    """Record ``nbytes`` copied from position ``src`` to ``dst`` under
    ``kind``, inside ``count_transfers`` and when the two differ."""
    rec = _TRANSFERS.get()
    if rec is not None and nbytes and tuple(src) != tuple(dst):
        rec.bytes[kind] += nbytes
        rec.counts[kind] += 1


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
