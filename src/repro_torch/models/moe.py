"""Mixture-of-experts layer (port of ``repro/models/moe.py``): top-k
routing, capacity-bounded gather dispatch, DeepSeek-style shared experts
and the Switch load-balance auxiliary loss.

Tokens are grouped by batch row (one group per sequence); each expert
takes its top-C tokens of a group by router score (the capacity-factor
dropping formulation, by gather), runs its gated FFN on them, and the
outputs are combined back at their token positions weighted by the
normalised router scores.  A decode step (S == 1) regroups the batch into
one group, as the reference does.

Where PyTorch's defaults would differ from the reference:
  * top-k keeps the reference's tie order (``jax.lax.top_k``: the lower
    index first).  ``torch.topk`` does not; a stable descending sort does.
    Ties are common: with ``top_k == 1`` every selected token's normalised
    score is exactly 1.0, and at decode a small batch gives every expert a
    capacity of one token or a few.
  * the combine is deterministic: each token's contributions are laid out
    in one slot per selected expert (no two writes meet), then summed in
    float32 in ascending expert order and rounded once to ``x``'s dtype.
    A scatter-add on CUDA adds through atomics in a varying order.
  * groups run one at a time, so every product of a group has the same
    shape whatever the batch: a request's prefill through the engine
    (batch 1) equals its row of a batched prefill.

While a profiler records, ``_group`` adds its routed (token, expert) pairs
and those dropped by capacity to the tracer's ``moe.routed`` and
``moe.dropped`` counters, on the device (``tracing.count_device``), keyed
by the engine step index of the span around the call (None outside one).

Routed expert banks stay plain ``einsum`` products (the reference runs
them outside any Pallas kernel); the shared experts go through
``layers.ffn`` and so through the bit-plane GEMM when packed.

Inside a lane's "model" group the expert banks arrive as ``ModelBlocks``
over their experts: the router runs whole (replicated), each position runs
its own experts on the tokens routed to them, and the positions' float32
outputs are ``psum``'d; the shared experts split as the FFN's "mlp" dim.
The Switch statistics come from the whole routing, as before.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.runtime import tracing

from .layers import ffn, ffn_defs, silu
from .params import ParamDef
from .sharding_ctx import is_blocks, lane_stats, model_group


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared_experts: int = 0
    d_ff_shared: int = 0
    capacity_factor: float = 1.25
    activation: str = "silu"
    router_dtype: torch.dtype = torch.float32


def moe_defs(cfg: MoEConfig, dtype=torch.bfloat16) -> dict:
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff_expert
    defs = {
        "router": ParamDef((d, e), ("embed", None), dtype=torch.float32,
                           init="scaled"),
        "wi": ParamDef((e, d, f), ("experts", "embed", "moe_mlp"),
                       dtype=dtype, init="scaled"),
        "wg": ParamDef((e, d, f), ("experts", "embed", "moe_mlp"),
                       dtype=dtype, init="scaled"),
        "wo": ParamDef((e, f, d), ("experts", "moe_mlp", "embed"),
                       dtype=dtype, init="scaled"),
    }
    if cfg.n_shared_experts:
        defs["shared"] = ffn_defs(
            d, cfg.d_ff_shared or f * cfg.n_shared_experts, gated=True,
            dtype=dtype)
    return defs


def _capacity(cfg: MoEConfig, tokens_per_group: int) -> int:
    c = int(tokens_per_group * cfg.top_k * cfg.capacity_factor
            / cfg.n_experts) + 1
    return min(max(cfg.top_k, c), tokens_per_group)


def _top_k(v: torch.Tensor, k: int):
    """(values, indices) of the ``k`` largest along the last axis, ties
    broken toward the lower index as ``jax.lax.top_k`` does."""
    vals, idx = torch.sort(v, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _group(p, cfg: MoEConfig, x: torch.Tensor):
    """One group x [S, D] -> (routed output [S, D] in x's dtype, probs
    [S, E] float32, routed mask [S, E] bool)."""
    s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    cap = _capacity(cfg, s)
    logits = x.to(cfg.router_dtype) @ p["router"].to(cfg.router_dtype)
    probs = torch.softmax(logits, dim=-1)                     # [S, E]
    topv, topi = _top_k(probs, k)                             # [S, k]
    topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)
    score = torch.zeros_like(probs).scatter_(1, topi, topv)   # [S, E]

    # each expert takes its top-C tokens of the group by score
    gate_c, idx_c = _top_k(score.t(), cap)                    # [E, C]
    keep = gate_c > 0
    if tracing.recording():
        # routed (token, expert) pairs and those past the capacity, summed
        # on the device while a profiler records (no host read, no op else)
        routed = (score > 0).sum()
        step = tracing.current_step()
        tracing.count_device("moe.routed", routed, key=step)
        tracing.count_device("moe.dropped", routed - keep.sum(), key=step)
    # combine: expert e's kept output for token t lands in t's slot j, the
    # rank of e among t's selected experts; dropped entries go to slot k
    ranked = torch.sort(topi, dim=-1).values                  # [S, k]
    experts = torch.arange(e, device=x.device)[:, None].expand(e, cap)
    slot = (ranked[idx_c] < experts[..., None]).sum(-1)       # [E, C]
    slot = torch.where(keep, slot, torch.full_like(slot, k))
    w = p["wi"]
    if not is_blocks(w):
        y = _experts(p["wi"], p["wg"], p["wo"], x, idx_c, gate_c, keep,
                     slot, k)
        return y.to(x.dtype), probs, score > 0
    # experts over "model": each position runs the tokens routed to its
    # own experts, and the outputs are summed over the group
    g = model_group()
    outs = []
    for j, pk in enumerate(w.index):
        lo, hi = w.bounds(j)
        dev = w.parts[j].device
        outs.append(_experts(
            w.parts[j], p["wg"].parts[j], p["wo"].parts[j], g.to(x, pk),
            *(t[lo:hi].to(dev) for t in (idx_c, gate_c, keep, slot)), k))
    return g.psum(outs, x.dtype), probs, score > 0


def _experts(wi, wg, wo, x: torch.Tensor, idx_c, gate_c, keep, slot,
             k: int) -> torch.Tensor:
    """The gated FFN of the experts of ``wi`` / ``wg`` / ``wo`` [E', ...]
    on their tokens ``idx_c`` [E', C] of x [S, D], weighted by ``gate_c``
    (``keep``: kept entries); each token's outputs summed over its slots in
    float32: [S, D] float32."""
    xe = x[idx_c]                                             # [E', C, D]
    h = silu(torch.bmm(xe, wg.to(x.dtype)))
    h = h * torch.bmm(xe, wi.to(x.dtype))
    ye = torch.bmm(h, wo.to(x.dtype))
    ye = ye * (gate_c.to(x.dtype) * keep.to(x.dtype))[..., None]
    parts = torch.zeros((x.shape[0], k + 1, x.shape[1]), dtype=torch.float32,
                        device=x.device)
    parts[idx_c, slot] = ye.to(torch.float32)
    y = parts[:, 0]
    for j in range(1, k):
        y = y + parts[:, j]
    return y


def moe_ffn(p, cfg: MoEConfig, x: torch.Tensor):
    """x: [B, S, D] -> (y [B, S, D], aux_loss float32 scalar).

    B is the group axis; capacity is per (group, expert).  Decode (S == 1,
    B > 1) regroups the batch into one group: per-row grouping would give
    every expert a capacity of ``top_k`` slots per token.
    """
    b, s, d = x.shape
    if s == 1 and b > 1:
        y, aux = moe_ffn(p, cfg, x.reshape(1, b, d))
        return y.reshape(b, s, d), aux
    outs = [_group(p, cfg, x[i]) for i in range(b)]
    y = torch.stack([o[0] for o in outs])
    if cfg.n_shared_experts:
        y = y + ffn(p["shared"], x, cfg.activation)

    # Switch-style load-balance loss
    routed = torch.stack([o[2] for o in outs]).to(torch.float32)
    probs = torch.stack([o[1] for o in outs]).to(torch.float32)
    stats = lane_stats()
    if stats is not None:           # a data lane of the sharded step
        stats.moe.append((routed.sum(dim=(0, 1)), probs.sum(dim=(0, 1)),
                          b * s, cfg.n_experts))
    frac_tokens = routed.mean(dim=(0, 1))
    frac_probs = probs.mean(dim=(0, 1))
    aux = cfg.n_experts * (frac_tokens * frac_probs).sum()
    return y, aux
