"""Train, eval and serving steps (port of ``repro/runtime/steps.py``;
greedy decode only).

``make_train_step`` splits the batch into ``microbatches`` row blocks,
takes each block's gradients with ``torch.autograd.grad`` and sums them in
float32 (activation memory ~ 1 / microbatches), then applies AdamW, as the
reference's scan does.  ``.grad`` is never accumulated across backward
passes: bf16 leaves would sum their microbatches in bf16.

With parameters sharded on a mesh (``runtime/sharding.ShardedTensor``
leaves) the step is data-parallel over the batch axes, in one process:
  * every data lane gathers the whole parameter leaves onto its device
    once a step (an all-gather of the FSDP / model shards);
  * each microbatch's rows go to the lanes in contiguous blocks, as the
    reference's ``_constrain_batch`` lays them out (``shard_bounds``;
    a lane left without rows skips the microbatch);
  * the loss is global over the microbatch, not a mean of lane means:
    every lane's forward pass runs under ``record_lane_stats`` first, and
    the loss is rebuilt from their records -- the masked cross-entropy
    sums over the summed token count, and each MoE layer's Switch loss
    from router statistics summed over the lanes (both of its fractions
    are means over the whole microbatch);
  * one backward pass over every lane's graph then gives each lane's
    gradients, which are summed in float32 into gradient shards laid out
    as the parameters (a reduce-scatter), and AdamW updates every
    position's slices.
For the families whose model sets ``model_split`` (every family) the
"model" axis splits each lane's compute too, as GSPMD splits the
reference's: the lane's positions along "model" form a
``sharding_ctx.ModelGroup`` (``lane_group``); each keeps its own block of
every leaf the rules put on "model" (gathered over the other axes only)
and computes its share, and the model's split blocks combine the shares
(``models/layers``, ``attention``, ``moe``, ``ssm``).  A gradient block of
such a leaf is reduced over the data lanes only.  In float32 the split
gives the unsplit lane's bits: every sum it divides accumulates in float64
on both sides (``models/layers``' module docstring).  Each piece is a
function of its own (``gather_lane_params``, ``lanes_grads``,
``reduce_grads_at``: position by position), so the dry run
(``launch/dryrun.py``) traces one position's program of the same code (a
group whose ``active`` is that position alone); ``make_lane_prefill_step``
/ ``make_lane_decode_step`` are the serving steps of a lane on sharded
parameters and cache.  On several cards the lanes and positions, issued one
after another from the host, still overlap, since CUDA launches are
asynchronous.
"""
from __future__ import annotations

import itertools
from typing import Callable

import torch

from repro_torch.models import sharding_ctx
from repro_torch.models.sharding_ctx import (ModelBlocks, is_blocks,
                                             record_lane_stats, use_group)

from . import sharding as shd
from .optim import OptConfig, adamw_update, tree_leaves, tree_map


def _split_microbatches(batch: dict, k: int) -> dict:
    """Every leaf [B, ...] -> [k, B / k, ...], row-major (0-d leaves stay)."""
    def sp(x):
        if x.ndim == 0:
            return x
        b = x.shape[0]
        if b % k:
            raise ValueError(f"batch {b} does not split into {k} "
                             "microbatches")
        return x.reshape((k, b // k) + tuple(x.shape[1:]))
    return {n: sp(v) for n, v in batch.items()}


def microbatch_grads(model, params, batch: dict, microbatches: int = 1):
    """(mean loss over the microbatches, gradients as float32 tensors
    summed over the microbatches and divided by their count), in the
    parameter tree's structure.  A leaf the loss does not reach gets zeros,
    as ``jax.grad`` gives."""
    mbs = _split_microbatches(batch, microbatches)
    leaves = tree_leaves(params)
    gsum = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for p in leaves]
    loss_sum = 0.0
    for i in range(microbatches):
        mb = {n: v if v.ndim == 0 else v[i] for n, v in mbs.items()}
        req = [p.detach().requires_grad_() for p in leaves]
        it = iter(req)
        with torch.enable_grad():
            loss, _ = model.train_loss(tree_map(lambda _: next(it), params),
                                       mb)
            grads = torch.autograd.grad(loss, req, allow_unused=True)
        for acc, g in zip(gsum, grads):
            if g is not None:
                acc.add_(g)
        loss_sum = loss_sum + loss.detach()
    for g in gsum:
        g.div_(microbatches)
    it = iter(gsum)
    return loss_sum / microbatches, tree_map(lambda _: next(it), params)


def lane_positions(mesh, batch_axes=None) -> list:
    """The data lanes of ``mesh`` in order: the coordinates of the
    position with the lane's coordinates on ``batch_axes`` (an axis name
    or a tuple; default ``sharding.batch_axes``; ``()`` makes one lane
    that runs the whole batch) and 0 on the others."""
    axes = shd.batch_axes(mesh) if batch_axes is None else batch_axes
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    names, sizes = mesh.axis_names, mesh.shape
    out = []
    for lane in itertools.product(*(range(sizes[a]) for a in axes)):
        at = dict(zip(axes, lane))
        out.append(tuple(at.get(a, 0) for a in names))
    return out


def lane_group(model, mesh, lane, at=None):
    """The "model" group of the data lane at ``lane`` (its positions along
    "model"), or None where the lane computes whole: a model without
    ``model_split``, or no "model" axis of two or more positions.
    ``at``: a position of the lane whose program alone runs (the dry
    run's trace); by default all of them.  The group's rules are the
    installed ones (``sharding_ctx.get_rules``), else the mesh's."""
    sizes = mesh.shape
    if not getattr(model, "model_split", False) or sizes.get("model", 1) < 2:
        return None
    names = mesh.axis_names
    mi = names.index("model")
    positions = tuple(tuple(lane[:mi]) + (m,) + tuple(lane[mi + 1:])
                      for m in range(sizes["model"]))
    active = (tuple(range(len(positions))) if at is None
              else (tuple(at)[mi],))
    rules = sharding_ctx.get_rules() or shd.make_rules(mesh)
    return sharding_ctx.ModelGroup(
        positions, tuple(mesh.device(c) for c in positions), active, rules)


def _model_dim(st, m: int):
    """The dimension of a sharded leaf its spec puts on "model" alone, if
    it splits evenly over ``m`` positions, else None."""
    for d, e in enumerate(st.sharding.spec):
        if e == "model":
            return d if st.shape[d] % m == 0 else None
    return None


def gather_lane(st, lane, group=None, rows=None):
    """One sharded leaf for the lane: whole at the lane's position (an
    all-gather; a leaf the position holds whole is its own shard), or,
    inside a "model" group, ``ModelBlocks`` of each active position's own
    "model" block gathered over the other axes.  ``rows``: keep the
    position's block of that dimension (a cache's batch rows)."""
    dim = None if group is None else _model_dim(st, group.size)
    if dim is None:
        home = lane if group is None else group.positions[group.active[0]]
        return shd.gather(st, st.mesh.device(home), at=home, rows=rows)
    parts = [shd.gather(st, group.devices[k], at=group.positions[k],
                        rows=rows, keep="model") for k in group.active]
    return ModelBlocks(parts, dim, st.shape[dim], tuple(group.active),
                       group.size)


def _write_back(st, t, at, own_dims: list, written=None) -> None:
    """Put ``t``, position ``at``'s gather of a leaf that keeps ``at``'s
    blocks along ``own_dims``, back into the shards it was gathered from
    where it is a copy (the leaf is split over an axis the lane gathers
    whole: "model" for a family that computes its lanes whole, or in
    blocks that do not divide; "data" under a replicated batch): every
    holder of those same blocks takes its slice of ``t``, as a
    "collective-permute" from ``at`` where it is another position.
    ``written``: (dim, row) where the step wrote one row of that dim (a
    decode step's cache row), the rest being as gathered."""
    if t is st.shards.get(tuple(at)):
        return
    want = shd.local_slices(st.sharding, st.shape, at)
    for c, part in st.shards.items():
        sl = list(shd.local_slices(st.sharding, st.shape, c))
        if any(sl[d] != want[d] for d in own_dims):
            continue
        dst = [slice(None)] * part.dim()
        if written is not None:
            d, row = written
            if not sl[d].start <= row < sl[d].stop:
                continue
            dst[d] = slice(row - sl[d].start, row - sl[d].start + 1)
            sl[d] = slice(row, row + 1)
        for d in own_dims:
            sl[d] = slice(0, t.shape[d])
        piece = t[tuple(sl)]
        shd.moved("collective-permute", at, c,
                  piece.numel() * piece.element_size())
        part[tuple(dst)] = piece.to(part.device)


def write_back_lane(st, t, lane, group=None, rows=None,
                    written=None) -> None:
    """Undo ``gather_lane``'s copies after a step wrote into them (a
    decode step's cache): ``_write_back`` of the whole leaf, or of each
    active position's ``ModelBlocks`` part."""
    own = [] if rows is None else [rows]
    if not is_blocks(t):
        home = lane if group is None else group.positions[group.active[0]]
        _write_back(st, t, home, own, written)
        return
    for k, part in zip(t.index, t.parts):
        _write_back(st, part, group.positions[k], own + [t.dim], written)


def gather_lane_params(leaves: list, lane, group=None) -> list:
    """Every sharded parameter leaf for the lane (``gather_lane``)."""
    return [gather_lane(p, lane, group) for p in leaves]


def reduce_grads_at(gacc: list, grads: list, lanes: list, at) -> None:
    """Position ``at``'s part of the float32 reduce-scatter: every lane's
    block of each gradient leaf, sent as float32 ("reduce-scatter" in
    ``sharding.count_transfers``), added into ``at``'s accumulator shard
    in lane order.  ``grads``: per lane its leaf gradients or None.  A
    gradient split over "model" (``ModelBlocks``) reaches ``at`` from the
    lane's position with ``at``'s model coordinate: reduced over the data
    lanes only."""
    for j, acc in enumerate(gacc):
        t = acc.shards[at]
        sl = list(shd.local_slices(acc.sharding, acc.shape, at))
        names = acc.mesh.axis_names
        for lane, g in zip(lanes, grads):
            if g is None or g[j] is None:
                continue
            src, gj = lane, g[j]
            if is_blocks(gj):
                mi = names.index("model")
                if at[mi] not in gj.index:
                    continue
                part = gj.parts[gj.index.index(at[mi])]
                if part is None:
                    continue
                own = list(sl)
                own[gj.dim] = slice(0, part.shape[gj.dim])
                blk = part[tuple(own)]
                src = tuple(lane[:mi]) + (at[mi],) + tuple(lane[mi + 1:])
            else:
                blk = gj[tuple(sl)]
            shd.moved("reduce-scatter", src, at, blk.numel() * 4)
            t.add_(blk.to(t.device, torch.float32))


def _aux_weight(model) -> float:
    cfg = getattr(model.cfg, "lm", model.cfg)
    return cfg.aux_loss_weight


def _global_loss(model, stats: list, home) -> torch.Tensor:
    """The microbatch's loss from every lane's ``LaneStats``: the masked
    cross-entropy sum over the total count, plus the aux weight x the
    Switch loss of each MoE layer from statistics summed over lanes."""
    if any(len(st.xent) != 1 for st in stats):
        raise ValueError("a lane's train_loss took the cross-entropy "
                         f"{[len(st.xent) for st in stats]} times, not once")
    tot = sum(st.xent[0][0].to(home) for st in stats)
    cnt = sum(st.xent[0][1].to(home) for st in stats)
    loss = tot / torch.clamp(cnt, min=1.0)
    n_moe = {len(st.moe) for st in stats}
    if n_moe != {0}:
        if len(n_moe) != 1:
            raise ValueError(f"lanes ran {n_moe} MoE layers")
        aux = 0.0
        for layer in zip(*(st.moe for st in stats)):
            routed = sum(r.to(home) for r, _, _, _ in layer)
            probs = sum(p.to(home) for _, p, _, _ in layer)
            n = sum(t for _, _, t, _ in layer)
            aux = aux + layer[0][3] * ((routed / n) * (probs / n)).sum()
        loss = loss + _aux_weight(model) * aux
    return loss


def _tensors(x) -> list:
    return list(x.parts) if is_blocks(x) else [x]


def _device(x):
    return _tensors(x)[0].device


def _requires(x):
    """A leaf to differentiate: detached, requiring grad (each block)."""
    if is_blocks(x):
        return ModelBlocks([t.detach().requires_grad_() for t in x.parts],
                           x.dim, x.size, x.index, x.count)
    return x.detach().requires_grad_()


def lanes_grads(model, params, lane_params: list, lane_batches: list,
                groups=None):
    """(global loss, per lane the gradients of its leaves or None) of one
    microbatch: each lane's forward pass under ``record_lane_stats`` (and
    its "model" group, ``groups``: one per lane or None), then one backward
    pass over all of them.  A split leaf's gradient is ``ModelBlocks``."""
    groups = groups or [None] * len(lane_params)
    req = [[_requires(p) for p in lp] for lp in lane_params]
    stats = []
    with torch.enable_grad():
        for r, mb, g in zip(req, lane_batches, groups):
            if mb is None:
                continue
            it = iter(r)
            with record_lane_stats() as st, use_group(g):
                model.train_loss(tree_map(lambda _: next(it), params), mb)
            stats.append(st)
        loss = _global_loss(model, stats, _device(lane_params[0][0]))
        live = [r for r, mb in zip(req, lane_batches) if mb is not None]
        flat = torch.autograd.grad(
            loss, [t for r in live for p in r for t in _tensors(p)],
            allow_unused=True)
    grads, at = [], 0
    for r, mb in zip(req, lane_batches):
        if mb is None:
            grads.append(None)
            continue
        lane = []
        for p in r:
            n = len(_tensors(p))
            got = flat[at:at + n]
            at += n
            lane.append(ModelBlocks(list(got), p.dim, p.size, p.index,
                                    p.count) if is_blocks(p) else got[0])
        grads.append(lane)
    return loss.detach(), grads


def sharded_microbatch_grads(model, params, batch: dict,
                             microbatches: int = 1, batch_axes=None):
    """``microbatch_grads`` for ``ShardedTensor`` parameters: (the mean
    loss over the microbatches on the first lane's device, float32
    gradients sharded as the parameters)."""
    leaves = tree_leaves(params)
    mesh = leaves[0].mesh
    lanes = lane_positions(mesh, batch_axes)
    groups = [lane_group(model, mesh, c) for c in lanes]
    lane_params = [gather_lane_params(leaves, c, g)
                   for c, g in zip(lanes, groups)]
    gacc = [shd.zeros(p.shape, torch.float32, p.sharding) for p in leaves]
    mbs = _split_microbatches(batch, microbatches)
    loss_sum = 0.0
    for i in range(microbatches):
        mb = {n: v if v.ndim == 0 else v[i] for n, v in mbs.items()}
        rows = next(v.shape[0] for v in mb.values() if v.ndim)
        lane_batches = []
        for k, c in enumerate(lanes):
            lo, hi = shd.shard_bounds(rows, len(lanes), k)
            lane_batches.append(None if hi == lo else {
                n: (v if v.ndim == 0 else v[lo:hi]).to(mesh.device(c))
                for n, v in mb.items()})
        loss, grads = lanes_grads(model, params, lane_params, lane_batches,
                                  groups)
        for c in mesh.positions():
            reduce_grads_at(gacc, grads, lanes, c)
        loss_sum = loss_sum + loss
        del grads
    for acc in gacc:
        for t in acc.shards.values():
            t.div_(microbatches)
    it = iter(gacc)
    return loss_sum / microbatches, tree_map(lambda _: next(it), params)


def make_train_step(model, opt_cfg: OptConfig, microbatches: int = 1,
                    batch_axes=None) -> Callable:
    """``train_step(params, opt_state, batch)`` -> (params, opt_state,
    {"loss", "grad_norm", "lr"}); the parameters and moments are updated
    in place (``optim.adamw_update``).  Sharded parameters take the
    data-parallel step over ``batch_axes`` (default the mesh's
    ``sharding.batch_axes``); plain ones the one-device step."""

    def train_step(params, opt_state, batch):
        if shd.is_sharded(tree_leaves(params)[0]):
            loss, grads = sharded_microbatch_grads(
                model, params, batch, microbatches, batch_axes)
        else:
            loss, grads = microbatch_grads(model, params, batch,
                                           microbatches)
        params, opt_state, om = adamw_update(params, grads, opt_state,
                                             opt_cfg)
        return params, opt_state, {"loss": loss, **om}

    return train_step


def make_eval_loss(model) -> Callable:
    """``eval_loss(params, batch)`` -> the loss, without autograd."""

    def eval_loss(params, batch):
        with torch.no_grad():
            loss, _ = model.train_loss(params, batch)
        return loss

    return eval_loss


def make_prefill_step(model, family: str) -> Callable:
    """``prefill(params, tokens, extras=None, max_len=None)`` -> (last
    logits, cache).  ``extras`` holds the stub frontends' embeddings: the
    VLM's ``"patches"`` [B, n_patches, d_vit], the encoder-decoder's
    ``"frames"`` [B, n_frames, d_model]."""

    def prefill(params, tokens, extras=None, max_len=None):
        if family == "vlm":
            return model.prefill(params, tokens, extras["patches"],
                                 max_len=max_len)
        if family == "encdec":
            return model.prefill(params, tokens, extras["frames"],
                                 max_len=max_len)
        return model.prefill(params, tokens, max_len=max_len)

    return prefill


def make_decode_step(model) -> Callable:
    """``decode(params, cache, tokens, cur_len)`` -> (logits, cache)."""

    def decode(params, cache, tokens, cur_len):
        return model.decode_step(params, cache, tokens, cur_len)

    return decode


def _unflatten(like, leaves: list):
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def make_lane_prefill_step(model, family: str, lane, at=None) -> Callable:
    """``make_prefill_step`` for ``ShardedTensor`` parameters at the data
    lane whose position is ``lane``: the lane gathers them
    (``gather_lane_params``), then prefills its rows, inside its "model"
    group where the family splits (``lane_group``; ``at``: that position's
    program alone).  A split cache leaf comes back as ``ModelBlocks``, each
    position's block (its kv heads, or its block of the sequence)."""
    prefill = make_prefill_step(model, family)

    def lane_prefill(params, tokens, extras=None, max_len=None):
        leaves = tree_leaves(params)
        g = lane_group(model, leaves[0].mesh, lane, at)
        with use_group(g):
            p = _unflatten(params, gather_lane_params(leaves, lane, g))
            return prefill(p, tokens, extras, max_len)

    return lane_prefill


def make_lane_decode_step(model, lane, at=None) -> Callable:
    """``make_decode_step`` for ``ShardedTensor`` parameters and cache at
    the data lane whose position is ``lane``: the lane gathers the
    parameters and its rows of every cache leaf (its block of the
    "batch" dimension; inside a "model" group each position's own block of
    a leaf split over "model"), then decodes them.  A leaf the position
    holds whole is used in place, so its cache rows are written there; a
    gathered copy is written back to its holders (``write_back_lane``)."""
    decode = make_decode_step(model)
    defs = model.cache_defs(1, 1)
    batch_dim = tree_map(lambda d: d.axes.index("batch"), defs)
    seq_dim = tree_map(lambda d: d.axes.index("kv_seq") if "kv_seq" in
                       d.axes else -1, defs)

    def lane_decode(params, cache, tokens, cur_len):
        leaves = tree_leaves(params)
        g = lane_group(model, leaves[0].mesh, lane, at)
        with use_group(g):
            p = _unflatten(params, gather_lane_params(leaves, lane, g))
            rows = tree_map(lambda st, d: gather_lane(st, lane, g, rows=d),
                            cache, batch_dim)
            out = decode(p, rows, tokens, cur_len)
            # a sequence's one new row where the fill is one int
            one = not (isinstance(cur_len, torch.Tensor) and cur_len.dim())
            tree_map(lambda st, t, d, sd: write_back_lane(
                st, t, lane, g, d, (sd, int(cur_len)) if sd >= 0 and one
                else None), cache, rows, batch_dim, seq_dim)
            return out

    return lane_decode


def make_serve_step(model) -> Callable:
    """Greedy decode: ``serve(params, cache, tokens, cur_len)`` returns
    (next token [B, 1] int32, logits [B, V], cache)."""

    def serve(params, cache, tokens, cur_len):
        logits, cache = model.decode_step(params, cache, tokens, cur_len)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        return nxt[:, None], logits, cache

    return serve
