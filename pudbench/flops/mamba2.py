"""Model FLOPs of a Mamba2 language model (the SSD as its recurrence),
from the configuration's keys as run; ``harness/counts.model_flops``
reads ``counts``."""


def counts(c: dict) -> dict:
    s = c["ssm_cfg"]
    d = c["d_model"]
    di = s["expand"] * d
    n, hp = s["d_state"], s["headdim"]
    h = di // hp
    proj = d * (2 * di + 2 * n + h) + di * d
    conv = s["d_conv"] * (di + 2 * n)
    recur = 2 * h * hp * n                    # update and read-out
    per_token = 2 * c["n_layer"] * (proj + conv + recur)
    return dict(per_token=per_token, unembed=2 * d * c["vocab_size"],
                prompt_attn=0, decode_attn=0)
