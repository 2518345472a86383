"""The plain references agree with the port's own path (its plain kernel
versions on the CPU) at smoke size, for both families: the logits the
engine computed for every served token of every finished request of a
closed loop, against the reference's replay of the same waves."""
import pytest
import torch

from pudbench.harness import check

from ._smoke import reference_logits, served


# Largest |port - reference| logit allowed: the references take the port's
# bf16 and float32 operations in the port's order (prompts at batch 1,
# decode rows in batches of the engine's width), so on the CPU they agree
# exactly; 1e-3 leaves room for float32 sums that another BLAS orders
# otherwise (logits of unit scale).
TOL = {"dsv2lite-rag": 1e-3, "mamba2-longdoc": 1e-3}


@pytest.mark.parametrize("cell", sorted(TOL))
def test_reference_matches_the_port_at_smoke_size(cell):
    config, sizes, params, traffic, comps, waves = served(cell, 2**31 + 3)
    ref = reference_logits(config, sizes, params, traffic, comps, waves)
    assert len(ref) >= 4
    worst = 0.0
    for k, lg in ref.items():
        port = comps[k].logits.to(torch.float32)
        assert port.shape == lg.shape
        worst = max(worst, float((port - lg).abs().max()))
    assert worst <= TOL[cell], worst
    # a served token's gap below the reference's best is at most the two
    # logits' differences
    g = check.gaps(ref, {k: comps[k].tokens for k in ref})
    assert max(float(v.max()) for v in g.values()) <= 2 * worst


@pytest.mark.parametrize("s", [23, 24, 9])
def test_mla_prompt_attention_covers_every_key(s):
    """The reference's blocked prefill attention is causal softmax
    attention over all S keys, also where S // kv_chunk blocks do not
    divide S: against one softmax in float64 over the same queries, keys
    and values (float32 weights, so no block's weights are rounded)."""
    from pudbench.reference import mla_moe
    from pudbench.reference.precision import Precision
    d, h, r, dn, dr, dv, f = 32, 2, 16, 8, 4, 8, 24
    c = mla_moe._Cfg({
        "hidden_size": d, "num_attention_heads": h, "kv_lora_rank": r,
        "qk_nope_head_dim": dn, "qk_rope_head_dim": dr, "v_head_dim": dv,
        "n_routed_experts": 4, "num_experts_per_tok": 2,
        "capacity_factor": 1.25, "num_hidden_layers": 1,
        "first_k_dense_replace": 1, "rms_norm_eps": 1e-6,
        "rope_theta": 10000, "norm_topk_prob": True,
        "attention_kv_chunk": 4, "rope_scaling": None})
    g = torch.Generator().manual_seed(s)

    def w(*shape):
        return torch.randn(shape, generator=g) / shape[0] ** 0.5
    p = {"attn": {"wq": w(d, h, dn + dr), "wdkv": w(d, r),
                  "kv_norm": {"scale": 1 + 0.1 * w(r)}, "wkr": w(d, dr),
                  "wuk": w(r, h, dn), "wuv": w(r, h, dv), "wo": w(h, dv, d)},
         "mixer": {"wi": w(d, f), "wg": w(d, f), "wo": w(f, d)}}
    lay = mla_moe._Layer(c, p, "layers_0_dense", set(), Precision("bf16"))
    x = torch.randn((s, d), generator=g)
    got, _ = lay.attend_prompt(x)

    pos = torch.arange(s)
    qn, qr = lay._q(x, pos)
    ckv, kr = lay.latents(x, pos)
    q = torch.cat([qn, qr], -1).double()
    k = torch.cat([torch.einsum("sr,rhk->shk", ckv, p["attn"]["wuk"]),
                   kr[:, None, :].expand(-1, h, -1)], -1).double()
    v = torch.einsum("sr,rhk->shk", ckv, p["attn"]["wuv"]).double()
    sc = torch.einsum("qhd,phd->hqp", q, k) * (dn + dr) ** -0.5
    sc = sc.masked_fill(pos[None, :, None] < pos[None, None, :],
                        float("-inf"))
    o = torch.einsum("hqp,phd->qhd", sc.softmax(-1), v)
    want = o.reshape(s, h * dv) @ p["attn"]["wo"].reshape(h * dv, d).double()
    assert float((got.double() - want).abs().max()) < 1e-4
