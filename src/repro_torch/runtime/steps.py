"""Serving steps (port of ``make_serve_step`` in ``repro/runtime/steps.py``,
greedy decode only)."""
from __future__ import annotations

from typing import Callable

import torch


def make_serve_step(model) -> Callable:
    """Greedy decode: ``serve(params, cache, tokens, cur_len)`` returns
    (next token [B, 1] int32, logits [B, V], cache)."""

    def serve(params, cache, tokens, cur_len):
        logits, cache = model.decode_step(params, cache, tokens, cur_len)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        return nxt[:, None], logits, cache

    return serve
