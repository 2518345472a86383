"""Logical-axis sharding context (port of ``repro/models/sharding_ctx.py``),
the "model" group of a data lane, and the data lanes' batch statistics.

A launcher installs the logical->mesh rules (``set_rules``: the table of
``models/params.param_pspecs`` plus ``"_mesh_sizes"``); model code reads
them through ``padded_head_count`` (attention pads its heads to a multiple
of the "model" axis) and ``hint``.  The reference's ``hint`` becomes
``jax.lax.with_sharding_constraint``, and GSPMD partitions the compute of
every position from those layouts.  Eager PyTorch has no partitioner: here
``hint`` returns ``x`` unchanged, and the split is written out instead.

``ModelGroup`` is that split (``use_group``; ``runtime/steps.py`` installs
one per data lane): the lane's positions along "model", the ones the code
runs for (all of them, or one when the dry run traces a position's
program), and the collectives between them.  A leaf the rules put on
"model" comes to the model code as ``ModelBlocks``, one block per position;
the model's split blocks (``layers``, ``attention``, ``moe``) run each
position's share on its device and combine the shares with ``psum`` (an
all-reduce: partial sums added in position order one precision above
the compute dtype, ``accum_dtype``, rounded once),
``pmax``, ``all_gather`` or ``permute`` (a block one position sends
another: the SSM's conv channels), each recorded under its collective kind
in ``runtime/sharding.count_transfers``.  Replicated work (norms, the
embedding, the MoE router) runs once per lane, as each position would run
it.

``record_lane_stats`` is the port's own: the sharded train step
(``runtime/steps.py``) runs each data lane's rows through the model on
their own and needs the terms that are global over the whole microbatch.
Inside the block ``layers.chunked_softmax_xent`` records its masked sum and
count, and ``moe.moe_ffn`` each layer's routed-token counts, router
probability sums and token count; the step combines them across lanes.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses

import torch

_RULES: contextvars.ContextVar[dict | None] = contextvars.ContextVar(
    "repro_torch_logical_sharding_rules", default=None)


def set_rules(rules: dict | None) -> None:
    """Install logical->mesh rules (launcher-side); None disables them."""
    _RULES.set(rules)


def get_rules() -> dict | None:
    return _RULES.get()


def hint(x, *logical_axes):
    """The reference's layout hint.  Without a compiler there is nothing
    to constrain: ``x`` comes back as it is, rules or not."""
    return x


def padded_head_count(n_heads: int) -> int:
    """Activation-level head padding target for the "model" axis.

    Archs whose head count does not divide it (llama4: 40 heads on a
    16-way axis; whisper: 20) pad q/k/v with zero heads to the next
    multiple and trim them before the output projection (exact: heads are
    independent).  Requires ``set_rules`` to include "_mesh_sizes"."""
    rules = _RULES.get()
    if not rules:
        return n_heads
    sizes = rules.get("_mesh_sizes") or {}
    ax = rules.get("heads_act", rules.get("heads"))
    m = sizes.get(ax) if isinstance(ax, str) else None
    if not m or n_heads % m == 0:
        return n_heads
    return -(-n_heads // m) * m


def accum_dtype(dtype: torch.dtype) -> torch.dtype:
    """The accumulator one precision above the compute ``dtype``: float64
    for float32 (and for float64, a float32 value in its ``shared`` form,
    so that such an input cannot pick the narrower one), float32 for bf16
    (and float16).  A sum that the "model" split divides
    (``ModelGroup.psum`` of partial products or statistics) and its
    unsplit counterpart accumulate in it and round once to the compute
    dtype, so the two give the same bits (an exact float32 product of two
    float32 values fits in float64, and float64 sums taken in two orders
    round to the same float32 but where they straddle a float32 rounding
    boundary)."""
    return (torch.float64 if dtype in (torch.float32, torch.float64)
            else torch.float32)


def block_bounds(n: int, k: int, i: int) -> tuple[int, int]:
    """Rows [start, stop) of block ``i`` of ``k`` over ``n`` (blocks of
    ``ceil(n / k)``: ``runtime/sharding.shard_bounds``)."""
    c = -(-n // k)
    return min(i * c, n), min((i + 1) * c, n)


@dataclasses.dataclass
class ModelBlocks:
    """One leaf (or activation) split over "model" into ``count`` blocks:
    ``parts[j]`` is the block of the position with model coordinate
    ``index[j]`` along ``dim`` (of a whole length ``size``), on that
    position's device."""

    parts: list
    dim: int
    size: int
    index: tuple
    count: int

    def _like(self, parts: list, dim: int) -> "ModelBlocks":
        return ModelBlocks(parts, dim, self.size, self.index, self.count)

    def layer(self, i: int) -> "ModelBlocks":
        """Layer ``i`` of a stacked leaf (views of the parts)."""
        return self._like([p[i] for p in self.parts], self.dim - 1)

    def layers(self, n: int) -> list:
        """The ``n`` layers, each part unbound once (``layer_slices``)."""
        per = [p.unbind(0) for p in self.parts]
        return [self._like([u[i] for u in per], self.dim - 1)
                for i in range(n)]

    def bounds(self, j: int) -> tuple[int, int]:
        """[start, stop) of part ``j`` in the whole dimension."""
        return block_bounds(self.size, self.count, self.index[j])


def is_blocks(x) -> bool:
    return isinstance(x, ModelBlocks)


def stack(items: list):
    """``torch.stack`` of tensors, or of ``ModelBlocks`` part by part (a
    new leading dim)."""
    if not is_blocks(items[0]):
        return torch.stack(items)
    first = items[0]
    return ModelBlocks([torch.stack(ps) for ps in zip(*(
        it.parts for it in items))], first.dim + 1, first.size, first.index,
        first.count)


def cat(items: list, dim: int):
    """``torch.cat`` along ``dim`` (not the split one) of tensors, or of
    ``ModelBlocks`` part by part."""
    if not is_blocks(items[0]):
        return torch.cat(items, dim=dim)
    return items[0]._like([torch.cat(ps, dim=dim) for ps in zip(*(
        it.parts for it in items))], items[0].dim)


def set_layer(leaf, i: int, value) -> None:
    """Write layer ``i`` of a stacked cache leaf in place: a tensor, or
    ``ModelBlocks`` part by part from a value split alike."""
    if is_blocks(leaf):
        for part, v in zip(leaf.parts, value.parts):
            part[i] = v
    else:
        leaf[i] = value


@dataclasses.dataclass
class ModelGroup:
    """The "model" positions of one data lane: ``positions`` (mesh
    coordinates, in model order), their ``devices``, and ``active``, the
    model coordinates the code runs for: all of them, or one when the dry
    run traces that position's program (``trace``).  ``rules`` decide a
    cache leaf's split (``cache_dim``)."""

    positions: tuple
    devices: tuple
    active: tuple
    rules: dict

    @property
    def size(self) -> int:
        return len(self.positions)

    @property
    def trace(self) -> bool:
        return len(self.active) < self.size

    @property
    def home(self):
        """The device of replicated activations: the first active
        position's (the lane's own position when all run)."""
        return self.devices[self.active[0]]

    def bounds(self, n: int, k: int) -> tuple[int, int]:
        return block_bounds(n, self.size, k)

    def to(self, x: torch.Tensor, k: int) -> torch.Tensor:
        """``x`` on position ``k``'s device (a broadcast of a replicated
        activation; a no-op where the position shares the home device)."""
        return x.to(self.devices[k])

    def split_dim(self, axes: tuple, shape: tuple):
        """The dimension of a leaf with logical ``axes`` that the rules put
        on "model" alone and that splits evenly over the group, or None
        (the leaf stays whole on every position)."""
        for d, a in enumerate(axes):
            if self.rules.get(a) == "model":
                return d if shape[d] % self.size == 0 else None
        return None

    # -- collectives --------------------------------------------------------

    def _record(self, kind: str, nbytes: int, factor: float) -> None:
        """Each active position receives ``factor x nbytes`` from its ring
        neighbour (ring all-reduce: 2 (M - 1) / M of the buffer; ring
        all-gather: (M - 1) / M)."""
        from repro_torch.runtime import sharding as shd
        m = self.size
        for k in self.active:
            shd.moved(kind, self.positions[(k - 1) % m], self.positions[k],
                      int(factor * nbytes * (m - 1) / m))

    def psum(self, parts: list, dtype=None) -> torch.Tensor:
        """The all-reduce of the positions' partial results (aligned with
        ``active``): sums in position order on the home device, in
        ``accum_dtype(dtype)`` (float32 for bf16, float64 for float32),
        rounded once to ``dtype``.  ``dtype`` None: float32 statistics
        summed in the parts' own precision (float64 where the compute dtype
        is float32, float32 under bf16) and rounded once to float32.
        Traced for one position, its own partial stands for the sum."""
        wide = (accum_dtype(dtype) if dtype is not None else
                torch.promote_types(parts[0].dtype, torch.float32))
        acc = None
        for p in parts:
            p = p.to(self.home, wide)
            acc = p if acc is None else acc + p
        self._record("all-reduce", acc.numel() * acc.element_size(), 2.0)
        return acc.to(dtype or torch.float32)

    def pmax(self, parts: list) -> torch.Tensor:
        """The all-reduce max of the positions' float32 parts."""
        acc = None
        for p in parts:
            p = p.to(self.home, torch.float32)
            acc = p if acc is None else torch.maximum(acc, p)
        self._record("all-reduce", acc.numel() * 4, 2.0)
        return acc

    def permute(self, x: torch.Tensor, src: int, dst: int) -> torch.Tensor:
        """Position ``src``'s tensor ``x`` on position ``dst``'s device: a
        "collective-permute" of its bytes where the two differ (what the
        receiving program ``dst`` gets)."""
        if src != dst:
            from repro_torch.runtime import sharding as shd
            shd.moved("collective-permute", self.positions[src],
                      self.positions[dst], x.numel() * x.element_size())
        return x.to(self.devices[dst])

    def all_gather(self, parts: list, dim: int, size: int) -> torch.Tensor:
        """The whole tensor from the positions' blocks along ``dim`` (of
        length ``size``), on the home device.  Traced for one position, the
        other blocks are left unwritten."""
        if not self.trace:
            out = torch.cat([p.to(self.home) for p in parts], dim=dim)
        else:
            p = parts[0]
            shape = list(p.shape)
            shape[dim] = size
            out = p.new_empty(shape)
            lo, hi = self.bounds(size, self.active[0])
            out.narrow(dim, lo, hi - lo).copy_(p)
        self._record("all-gather", out.numel() * out.element_size(), 1.0)
        return out


_GROUP: contextvars.ContextVar[ModelGroup | None] = contextvars.ContextVar(
    "repro_torch_model_group", default=None)


def model_group() -> ModelGroup | None:
    """The enclosing ``use_group``'s group, or None (no split)."""
    return _GROUP.get()


@contextlib.contextmanager
def use_group(group: ModelGroup | None):
    """Run the block as ``group``'s split program (None: unsplit)."""
    token = _GROUP.set(group)
    try:
        yield group
    finally:
        _GROUP.reset(token)


@dataclasses.dataclass
class LaneStats:
    """What one lane's forward pass recorded: ``xent`` [(masked loss sum,
    token count)], ``moe`` [(routed counts [E], probability sums [E],
    tokens, E)] per MoE layer call, in call order."""

    xent: list = dataclasses.field(default_factory=list)
    moe: list = dataclasses.field(default_factory=list)


_LANE: contextvars.ContextVar[LaneStats | None] = contextvars.ContextVar(
    "repro_torch_lane_stats", default=None)


@contextlib.contextmanager
def record_lane_stats():
    """Record the batch-global terms of the forward passes in the block
    into the ``LaneStats`` yielded.  Leave the block before the backward
    pass: a rematerialised layer runs its forward again there."""
    stats = LaneStats()
    token = _LANE.set(stats)
    try:
        yield stats
    finally:
        _LANE.reset(token)


def lane_stats() -> LaneStats | None:
    """The recorder of the enclosing ``record_lane_stats``, or None."""
    return _LANE.get()
