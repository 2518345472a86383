"""AdamW with global-norm clipping, a warmup + cosine schedule and optional
int8 gradient compression with error feedback (port of
``repro/runtime/optim.py``; one device, so no partition specs yet).

The optimizer state mirrors the parameter tree: ``{"mu", "nu": float32
moments, "step": int32 0-d[, "residual": float32 compression error]}``.
Every formula is the reference's, in float32 tensors and in its order of
operations (``torch.optim.AdamW`` and ``clip_grad_norm_`` order theirs
differently, which moves results by rounding).

``adamw_update`` updates the parameters and moments in place, as the
reference's launcher donates their buffers to its jitted step: a step at
qwen3-1.7b's full width then holds one copy of the state, not two.
"""
from __future__ import annotations

import dataclasses
import math

import torch

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
    template for ``CheckpointManager.restore``)."""
    def f32(p):
        return torch.zeros(p.shape, dtype=F32, device=p.device)
    dev = tree_leaves(params)[0].device
    state = {"mu": tree_map(f32, params), "nu": tree_map(f32, params),
             "step": torch.zeros((), dtype=torch.int32, device=dev)}
    if cfg.compress_grads:
        state["residual"] = tree_map(f32, params)
    return state


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves (tree order) of their float32 squares."""
    total = 0
    for g in tree_leaves(tree):
        total = total + (g.to(F32) ** 2).sum()
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


def adamw_update(params, grads, state: dict, cfg: OptConfig):
    """One AdamW step.  Returns (params, state, {"grad_norm", "lr"}); the
    parameter leaves, moments and residuals are updated in place (the
    trees returned hold the same tensors), ``step`` is a new tensor."""
    step = state["step"] + 1
    if cfg.compress_grads:
        def comp(g, r):
            g_hat, err = compress_roundtrip(g.to(F32) + r)
            r.copy_(err)
            return g_hat
        grads = tree_map(comp, grads, state["residual"])

    gnorm = global_norm(grads)
    dev = gnorm.device
    scale = torch.clamp(_f32(cfg.clip_norm, dev)
                        / torch.clamp(gnorm, min=1e-12), max=1.0)
    lr = lr_schedule(cfg, step)
    stepf = step.to(F32)
    b1c = 1 - torch.pow(_f32(cfg.b1, dev), stepf)
    b2c = 1 - torch.pow(_f32(cfg.b2, dev), stepf)

    def upd(p, g, m, v):
        g = g.to(F32) * scale
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        mh, vh = m / b1c, v / b2c
        pf = p.to(F32)
        delta = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * pf
        p.copy_((pf - lr * delta).to(p.dtype))

    tree_map(upd, params, grads, state["mu"], state["nu"])
    new_state = {"mu": state["mu"], "nu": state["nu"], "step": step}
    if cfg.compress_grads:
        new_state["residual"] = state["residual"]
    return params, new_state, {"grad_norm": gnorm, "lr": lr}
