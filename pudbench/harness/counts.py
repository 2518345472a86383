"""Operations and bytes, from shapes alone: a configuration's model FLOPs
per token (active parameters, attention or SSD terms) and a placed 4-bit
GEMM call's bytes and int8 operations.  A family's per-token terms
live in ``flops/<family>.py`` (its ``counts(config)``), found by the
configuration's ``family``.

Model FLOPs count two per multiply-add of what the model needs for the
token: each active projection once, the routed experts at ``top_k`` (not
at their capacity slots), attention over the positions a causal query
sees, the SSD as its recurrence (the state's update and read-out).  The
unembed counts only where logits are computed: a prompt's last position
and every decode row."""
from __future__ import annotations

import math

from . import spec


def model_flops(config: dict, prompts=(), decode_positions=(),
                root=spec.ROOT) -> float:
    """FLOPs of prefilling ``prompts`` (lengths) and of decode rows at
    ``decode_positions`` (each row's cache length before it, i.e. the
    position it is fed at)."""
    f = spec.load_module("flops", config["family"], root).counts(config)
    total = 0.0
    for s in prompts:
        total += s * f["per_token"] + f["unembed"]
        total += f["prompt_attn"] * s * (s + 1) / 2
    for p in decode_positions:
        total += f["per_token"] + f["unembed"] + f["decode_attn"] * (p + 1)
    return total


def placed_call(rows: int, k: int, n: int, weight_bits: int) -> dict:
    """One placed GEMM call, x [rows, K] int8 against N placed 4-bit
    columns: each input byte read once (the N columns' bit-plane words,
    their column ids, x) and the int32 output written once; int8
    operations two per multiply-add."""
    planes = n * weight_bits * math.ceil(k / 8)
    nbytes = planes + 4 * n + rows * k + 4 * rows * n
    return {"bytes": nbytes, "ops": 2 * rows * k * n}


def least_seconds(call: dict, peak: dict) -> float:
    """The least time of a call on a chip: bytes at the memory rate or
    operations at the int8 rate, whichever is longer."""
    return max(call["bytes"] / peak["hbm_bytes_s"],
               call["ops"] / peak["int8_ops"])
