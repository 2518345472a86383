"""AdamW with global-norm clipping, a warmup + cosine schedule and optional
int8 gradient compression with error feedback (port of
``repro/runtime/optim.py``).

The optimizer state mirrors the parameter tree: ``{"mu", "nu": float32
moments, "step": int32 0-d[, "residual": float32 compression error]}``.
Every formula is the reference's, in float32 tensors and in its order of
operations (``torch.optim.AdamW`` and ``clip_grad_norm_`` order theirs
differently, which moves results by rounding).

``adamw_update`` updates the parameters and moments in place, as the
reference's launcher donates their buffers to its jitted step: a step at
qwen3-1.7b's full width then holds one copy of the state, not two.

On a mesh (``runtime/sharding.py``) the leaves are ``ShardedTensor``s and
the state mirrors them (``opt_state_pspecs``: the moments sharded like the
parameters, ZeRO; ``step`` replicated).  Each position then updates its
own slices in place; the grad norm sums every distinct block of every
leaf once.  Int8 compression quantises blocks of 256 over the whole
leaf's flat order, so the reduced gradient and residual are gathered,
compressed whole and scattered back: ``--compress-grads`` gives the
single-device numbers on any mesh.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.models.params import tree_leaves, tree_map  # noqa: F401

from . import sharding as shd

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class OptConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    compress_grads: bool = False   # int8 error-feedback compression


def _f32(value: float, device) -> torch.Tensor:
    return torch.tensor(value, dtype=F32, device=device)


def lr_schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (a tensor): linear warmup, then a
    cosine down to ``min_lr_ratio`` of the peak; float32 throughout."""
    step = torch.as_tensor(step).to(F32)
    dev = step.device
    warm = step / _f32(max(1.0, cfg.warmup_steps), dev)
    t = (step - cfg.warmup_steps) / _f32(
        max(1.0, cfg.total_steps - cfg.warmup_steps), dev)
    t = torch.clamp(t, 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(_f32(math.pi, dev) * t))
    return cfg.peak_lr * torch.where(step < cfg.warmup_steps, warm, cos)


def init_opt_state(params, cfg: OptConfig) -> dict:
    """Zero float32 moments (and residuals) beside every parameter, and a
    0-d int32 step on the parameters' device (meta tensors give a
    template for ``CheckpointManager.restore``).  Sharded parameters get
    moments sharded like them and a step replicated on every position."""
    first = tree_leaves(params)[0]
    if shd.is_sharded(first):
        def f32(p):
            return shd.zeros(p.shape, F32, p.sharding)
        step = shd.zeros((), torch.int32,
                         shd.NamedSharding(first.mesh, shd.P()))
    else:
        def f32(p):
            return torch.zeros(p.shape, dtype=F32, device=p.device)
        step = torch.zeros((), dtype=torch.int32, device=first.device)
    state = {"mu": tree_map(f32, params), "nu": tree_map(f32, params),
             "step": step}
    if cfg.compress_grads:
        state["residual"] = tree_map(f32, params)
    return state


def opt_state_pspecs(param_specs, cfg: OptConfig) -> dict:
    """The state's PartitionSpecs: moments (and residuals) as the
    parameters, the step replicated."""
    state = {"mu": param_specs, "nu": param_specs, "step": shd.P()}
    if cfg.compress_grads:
        state["residual"] = param_specs
    return state


def _squares(g) -> torch.Tensor:
    if shd.is_sharded(g):       # each distinct block once
        return shd.replicated_sum(g, lambda t: (t.to(F32) ** 2).sum())
    return (g.to(F32) ** 2).sum()


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves (tree order) of their float32 squares
    (of a sharded leaf, over its distinct blocks, on its first
    position's device)."""
    total = 0
    for g in tree_leaves(tree):
        sq = _squares(g)
        total = total + (sq if isinstance(total, int) else
                         sq.to(total.device))
    return torch.sqrt(torch.as_tensor(total, dtype=F32))


# --- int8 error-feedback gradient compression -------------------------------
# Gradients are quantised to int8 in blocks of 256 before they would be
# synchronised; the quantisation error is fed into the next step's gradient
# (EF-SGD), which keeps convergence.

def _quantize_int8(g: torch.Tensor, block: int = 256):
    """(q [n_blocks, block] int8, scale [n_blocks, 1] float32, pad): each
    block scaled by its absolute max / 127, rounded half to even."""
    flat = g.reshape(-1)
    pad = (-flat.shape[0]) % block
    flat = torch.nn.functional.pad(flat, (0, pad)).reshape(-1, block)
    scale = torch.clamp(flat.abs().amax(dim=1, keepdim=True),
                        min=1e-12) / 127
    q = torch.clamp(torch.round(flat / scale), -127, 127).to(torch.int8)
    return q, scale, pad


def _dequantize_int8(q: torch.Tensor, scale: torch.Tensor, pad: int,
                     shape) -> torch.Tensor:
    flat = (q.to(F32) * scale).reshape(-1)
    if pad:
        flat = flat[:-pad]
    return flat.reshape(shape)


def compress_roundtrip(g: torch.Tensor):
    """int8 quantise -> dequantise; returns (g_hat, g - g_hat)."""
    q, s, pad = _quantize_int8(g)
    g_hat = _dequantize_int8(q, s, pad, g.shape)
    return g_hat, g - g_hat


def _compress_sharded(g, r):
    """Compress a sharded float32 gradient + residual as the whole leaf
    (its 256-blocks in the leaf's flat order), write the error into the
    residual's shards; returns the sharded dequantised gradient."""
    home = g.mesh.device(g.mesh.positions()[0])
    g_hat, err = compress_roundtrip(shd.gather(g, home)
                                    + shd.gather(r, home))
    for c, t in r.shards.items():
        t.copy_(err[shd.local_slices(r.sharding, r.shape, c)])
    return shd.put(g_hat, g.sharding)


def _compress(g, r):
    g_hat, err = compress_roundtrip(g.to(F32) + r)
    r.copy_(err)
    return g_hat


def _update(p, g, m, v, scalars, cfg: OptConfig) -> None:
    """One leaf's AdamW update in place; ``scalars``: (clip scale, lr,
    bias corrections 1 and 2) on the leaf's device."""
    scale, lr, b1c, b2c = scalars
    g = g.to(F32) * scale
    m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
    v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
    mh, vh = m / b1c, v / b2c
    pf = p.to(F32)
    delta = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * pf
    p.copy_((pf - lr * delta).to(p.dtype))


def adamw_update(params, grads, state: dict, cfg: OptConfig):
    """One AdamW step.  Returns (params, state, {"grad_norm", "lr"}); the
    parameter leaves, moments and residuals are updated in place (the
    trees returned hold the same tensors), ``step`` is a new tensor.
    With ``ShardedTensor`` leaves the clip scale, learning rate and bias
    corrections come from the first position's step, are copied to each
    device once, and every position's slices are updated in place."""
    sharded = shd.is_sharded(state["step"])
    if sharded:
        step = shd.ShardedTensor(state["step"].sharding, (), torch.int32,
                                 {c: t + 1 for c, t in
                                  state["step"].shards.items()})
        first = next(iter(step.shards.values()))
    else:
        step = first = state["step"] + 1
    if cfg.compress_grads:
        grads = tree_map(_compress_sharded if sharded else _compress, grads,
                         state["residual"])

    gnorm = global_norm(grads)
    dev = gnorm.device
    first = first.to(dev)
    stepf = first.to(F32)
    scalars = {dev: (
        torch.clamp(_f32(cfg.clip_norm, dev)
                    / torch.clamp(gnorm, min=1e-12), max=1.0),
        lr_schedule(cfg, first),
        1 - torch.pow(_f32(cfg.b1, dev), stepf),
        1 - torch.pow(_f32(cfg.b2, dev), stepf))}

    def on(device):
        if device not in scalars:
            scalars[device] = tuple(x.to(device) for x in scalars[dev])
        return scalars[device]

    def upd(p, g, m, v):
        if not sharded:
            _update(p, g, m, v, on(p.device), cfg)
            return
        for c, pl in p.shards.items():
            _update(pl, g.shards[c], m.shards[c], v.shards[c],
                    on(pl.device), cfg)

    tree_map(upd, params, grads, state["mu"], state["nu"])
    new_state = {"mu": state["mu"], "nu": state["nu"], "step": step}
    if cfg.compress_grads:
        new_state["residual"] = state["residual"]
    return params, new_state, {"grad_norm": gnorm, "lr": scalars[dev][1]}
