"""Logical-axis sharding context (port of ``repro/models/sharding_ctx.py``)
and the data lanes' batch statistics.

A launcher installs the logical->mesh rules (``set_rules``: the table of
``models/params.param_pspecs`` plus ``"_mesh_sizes"``); model code reads
them through ``padded_head_count`` (attention pads its heads to a multiple
of the "model" axis) and ``hint``.  The reference's ``hint`` becomes
``jax.lax.with_sharding_constraint`` for GSPMD; eager PyTorch has no
compiler to constrain, so here it returns ``x`` unchanged.

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
