"""Train, eval and serving steps (port of ``repro/runtime/steps.py`` on one
device; greedy decode only).

``make_train_step`` splits the batch into ``microbatches`` row blocks,
takes each block's gradients with ``torch.autograd.grad`` and sums them in
float32 (activation memory ~ 1 / microbatches), then applies AdamW, as the
reference's scan does.  ``.grad`` is never accumulated across backward
passes: bf16 leaves would sum their microbatches in bf16.
"""
from __future__ import annotations

from typing import Callable

import torch

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


def make_train_step(model, opt_cfg: OptConfig,
                    microbatches: int = 1) -> Callable:
    """``train_step(params, opt_state, batch)`` -> (params, opt_state,
    {"loss", "grad_norm", "lr"}); the parameters and moments are updated
    in place (``optim.adamw_update``)."""

    def train_step(params, opt_state, batch):
        loss, grads = microbatch_grads(model, params, batch, microbatches)
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


def make_serve_step(model) -> Callable:
    """Greedy decode: ``serve(params, cache, tokens, cur_len)`` returns
    (next token [B, 1] int32, logits [B, V], cache)."""

    def serve(params, cache, tokens, cur_len):
        logits, cache = model.decode_step(params, cache, tokens, cur_len)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        return nxt[:, None], logits, cache

    return serve
