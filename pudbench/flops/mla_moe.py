"""Model FLOPs of a DeepSeek-V2 decoder (MLA attention, a leading dense
FFN, routed and shared experts), from the configuration's keys as run;
``harness/counts.model_flops`` reads ``counts``."""


def counts(c: dict) -> dict:
    d, h = c["hidden_size"], c["num_attention_heads"]
    r, dn, dr, dv = (c["kv_lora_rank"], c["qk_nope_head_dim"],
                     c["qk_rope_head_dim"], c["v_head_dim"])
    attn = d * h * (dn + dr) + d * r + d * dr + r * h * (dn + dv) + h * dv * d
    dense = 3 * d * c["intermediate_size"]
    moe = (d * c["n_routed_experts"]
           + c["num_experts_per_tok"] * 3 * d * c["moe_intermediate_size"]
           + 3 * d * c["n_shared_experts"] * c["moe_intermediate_size"])
    nd = c["first_k_dense_replace"]
    per_token = 2 * (c["num_hidden_layers"] * attn + nd * dense
                     + (c["num_hidden_layers"] - nd) * moe)
    n_l = c["num_hidden_layers"]
    # causal query at position i sees i + 1 positions: scores and values
    prompt_attn = 2 * n_l * h * (dn + dr + dv)          # x sum(i + 1)
    decode_attn = 2 * n_l * h * (r + dr + r)             # x positions seen
    return dict(per_token=per_token, unembed=2 * d * c["vocab_size"],
                prompt_attn=prompt_attn, decode_attn=decode_attn)
