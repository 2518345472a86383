"""Serving steps (port of ``make_prefill_step``, ``make_decode_step`` and
``make_serve_step`` in ``repro/runtime/steps.py``; greedy decode only)."""
from __future__ import annotations

from typing import Callable

import torch


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
