"""The split blocks of a lane's "model" group (``sharding_ctx.ModelGroup``)
against their unsplit forms at smoke size, on groups of 2 and 4 CPU
positions: column- and row-parallel products and FFN, the vocab-parallel
logits and cross-entropy, GQA (split heads and kv heads, padded heads of a
whole projection, a cache split over its sequence and combined by its
log-sum-exp), MLA, the experts over "model", the Mamba2 mixer (its heads,
its d_state blocks of B and C, conv channel blocks that straddle the head
blocks, the gated RMSNorm's float32 all-reduce), the hybrid's LoRA FFN and
whisper's attention with its heads padded (an encoder pass and
cross-attention decode).

Tolerances, stated once: float32 within ``F32_TOL``; bf16 within one ulp
of the unsplit result (the split product rounds once, as the unsplit one,
after float32 partial sums added in another order) plus ``F32_TOL``.
"""
import math

import _torch_cpu  # noqa: F401
import pytest
import torch

from repro_torch.configs import get
from repro_torch.models import attention as attn
from repro_torch.models import layers, moe, ssm
from repro_torch.models.params import DEFAULT_RULES, init_params
from repro_torch.models.sharding_ctx import (ModelBlocks, ModelGroup,
                                             block_bounds, set_rules,
                                             use_group)
from repro_torch.runtime import sharding as shd

F32_TOL = 1e-5
GROUPS = [2, 4]


def group(m: int, rules=None) -> ModelGroup:
    pos = tuple((0, k) for k in range(m))
    return ModelGroup(pos, (torch.device("cpu"),) * m, tuple(range(m)),
                      dict(rules or DEFAULT_RULES))


def blocks(w: torch.Tensor, dim: int, m: int) -> ModelBlocks:
    n = w.shape[dim]
    return ModelBlocks([w.narrow(dim, lo, hi - lo) for lo, hi in
                        (block_bounds(n, m, k) for k in range(m))],
                       dim, n, tuple(range(m)), m)


def close(got: torch.Tensor, want: torch.Tensor) -> None:
    assert got.shape == want.shape and got.dtype == want.dtype
    diff = (got.detach().float() - want.detach().float()).abs()
    if want.dtype == torch.bfloat16:
        mag = torch.maximum(got.detach().float().abs(),
                            want.detach().float().abs())
        ulp = torch.exp2(torch.floor(torch.log2(mag.clamp(min=1e-30))) - 7)
        assert bool((diff <= ulp + F32_TOL).all()), float((diff - ulp).max())
    else:
        assert float(diff.max()) <= F32_TOL, float(diff.detach().max())


def rand(*shape, dtype=torch.float32, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(shape, generator=g) * 0.5).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", GROUPS)
def test_column_and_row_parallel_products(m, dtype):
    x, w = rand(3, 5, 64, dtype=dtype), rand(64, 96, dtype=dtype, seed=1)
    want = x @ w
    with use_group(group(m)) as g, shd.count_transfers() as rec:
        col = layers.matmul(x, blocks(w, 1, m))
        row = layers.matmul(x, blocks(w, 0, m))
        parts = layers.column_parallel(x, blocks(w, 1, m))
        assert [p.shape[-1] for p in parts] == [96 // m] * m
        assert g.size == m
    close(col, want)
    close(row, want)
    assert rec.bytes["all-reduce"] > 0 and rec.bytes["all-gather"] > 0


@pytest.mark.parametrize("gated", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", GROUPS)
def test_ffn_split(m, dtype, gated):
    p = init_params(layers.ffn_defs(32, 160, gated, dtype), 3, "cpu")
    x = rand(2, 6, 32, dtype=dtype)
    want = layers.ffn(p, x, "gelu")
    sp = {n: blocks(w, 0 if n == "wo" else 1, m) for n, w in p.items()}
    with use_group(group(m)):
        got = layers.ffn(sp, x, "gelu")
    close(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", GROUPS)
def test_vocab_parallel_logits(m, dtype):
    w = rand(32, 256, dtype=dtype)
    h = rand(4, 32, dtype=dtype, seed=2)
    want = layers.logits_last({"w": w}, h)
    with use_group(group(m)):
        got = layers.logits_last({"w": blocks(w, 1, m)}, h)
    close(got, want)


@pytest.mark.parametrize("m", GROUPS)
def test_vocab_parallel_xent_loss_and_grads(m):
    w = rand(32, 256, seed=4).requires_grad_()
    h = rand(2, 40, 32, seed=5).requires_grad_()
    labels = torch.randint(0, 256, (2, 40), generator=torch.Generator()
                           .manual_seed(6))
    mask = (torch.arange(40) < 33).float().expand(2, 40)
    want, n = layers.chunked_softmax_xent({"w": w}, h, labels, mask, 16)
    gw, gh = torch.autograd.grad(want, [w, h])
    parts = [t.detach().requires_grad_() for t in blocks(w, 1, m).parts]
    wb = ModelBlocks(parts, 1, 256, tuple(range(m)), m)
    with use_group(group(m)):
        got, n2 = layers.chunked_softmax_xent({"w": wb}, h, labels, mask, 16)
    grads = torch.autograd.grad(got, parts + [h])
    assert float(n2) == float(n) == 66.0
    close(got, want)
    close(torch.cat(grads[:-1], 1), gw)
    close(grads[-1], gh)


def _gqa(h, kv, dtype, qk_norm=True):
    cfg = attn.AttnConfig(32, h, kv, 8, qk_norm=qk_norm, kv_chunk=8)
    return cfg, init_params(attn.gqa_defs(cfg, dtype), 7, "cpu")


def _split_gqa(p, m, heads: bool, kv: bool):
    out = dict(p)
    if heads:
        out["wq"], out["wo"] = blocks(p["wq"], 1, m), blocks(p["wo"], 0, m)
    if kv:
        out["wk"], out["wv"] = blocks(p["wk"], 1, m), blocks(p["wv"], 1, m)
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,h,kv,heads,kv_split", [
    (2, 4, 2, True, True),       # heads and kv heads split alike
    (4, 8, 2, True, False),      # kv heads whole: split over "embed"
    (4, 6, 2, False, False),     # 6 heads on 4: whole, padded to 8
])
def test_gqa_attention_split(m, h, kv, heads, kv_split, dtype):
    cfg, p = _gqa(h, kv, dtype)
    x = rand(2, 16, 32, dtype=dtype, seed=8)
    pos = torch.arange(16).expand(2, 16)
    rules = {**DEFAULT_RULES, "_mesh_sizes": {"model": m}}
    set_rules(rules)
    try:
        want, (k, v) = attn.gqa_attention(p, cfg, x, pos)
        with use_group(group(m, rules)):
            got, (k2, v2) = attn.gqa_attention(
                _split_gqa(p, m, heads, kv_split), cfg, x, pos)
    finally:
        set_rules(None)
    close(got, want)
    for a, b in ((k2, k), (v2, v)):
        close(torch.cat(a.parts, 2) if kv_split else a, b)


def _seq_cache(c: torch.Tensor, m: int) -> ModelBlocks:
    return blocks(c.clone(), 1, m)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("per_slot", [False, True])
@pytest.mark.parametrize("m,h,kv,heads,layout", [
    (2, 4, 2, True, "kv_heads"),
    (4, 8, 2, True, "kv_seq"),   # the log-sum-exp combine of the blocks
    (4, 6, 2, False, "kv_seq"),  # whole q (6 heads on 4) over the blocks
    (4, 8, 2, True, "whole"),
])
def test_gqa_decode_split(m, h, kv, heads, layout, per_slot, dtype):
    cfg, p = _gqa(h, kv, dtype)
    b, smax = 3, 16
    ck = rand(b, smax, kv, 8, dtype=dtype, seed=9)
    cv = rand(b, smax, kv, 8, dtype=dtype, seed=10)
    x = rand(b, 1, 32, dtype=dtype, seed=11)
    cur = torch.tensor([5, 9, 15]) if per_slot else 11
    ck1, cv1 = ck.clone(), cv.clone()
    want = attn.gqa_decode(p, cfg, x, ck1, cv1, cur)
    if layout == "kv_heads":
        sk, sv = blocks(ck.clone(), 2, m), blocks(cv.clone(), 2, m)
    elif layout == "kv_seq":
        sk, sv = _seq_cache(ck, m), _seq_cache(cv, m)
    else:
        sk, sv = ck.clone(), cv.clone()
    with use_group(group(m)):
        got = attn.gqa_decode(_split_gqa(p, m, heads, layout == "kv_heads"),
                              cfg, x, sk, sv, cur)
    close(got, want)
    for split, whole in ((sk, ck1), (sv, cv1)):      # the rows written
        close(split if isinstance(split, torch.Tensor) else torch.cat(
            split.parts, split.dim), whole)


def _mla(dtype):
    cfg = attn.MLAConfig(32, 4, kv_lora_rank=16, qk_nope_dim=8,
                         qk_rope_dim=4, v_head_dim=8, kv_chunk=8)
    p = init_params(attn.mla_defs(cfg, dtype), 12, "cpu")
    return cfg, p


def _split_mla(p, m):
    out = dict(p)
    out["wq"] = blocks(p["wq"], 1, m)
    out["wuk"], out["wuv"] = blocks(p["wuk"], 1, m), blocks(p["wuv"], 1, m)
    out["wo"] = blocks(p["wo"], 0, m)
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", GROUPS)
def test_mla_attention_and_decode_split(m, dtype):
    cfg, p = _mla(dtype)
    x = rand(2, 16, 32, dtype=dtype, seed=13)
    pos = torch.arange(16).expand(2, 16)
    want, (c, r) = attn.mla_attention(p, cfg, x, pos)
    sp = _split_mla(p, m)
    with use_group(group(m)):
        got, (c2, r2) = attn.mla_attention(sp, cfg, x, pos)
    close(got, want)
    assert torch.equal(c2, c) and torch.equal(r2, r)

    xd = rand(2, 1, 32, dtype=dtype, seed=14)
    ckv, kr = rand(2, 16, 16, dtype=dtype, seed=15), rand(2, 16, 4,
                                                          dtype=dtype)
    for layout in ("kv_seq", "whole"):
        c1, r1 = ckv.clone(), kr.clone()
        want = attn.mla_decode(p, cfg, xd, c1, r1, 9)
        sc, sr = ((_seq_cache(ckv, m), _seq_cache(kr, m)) if
                  layout == "kv_seq" else (ckv.clone(), kr.clone()))
        with use_group(group(m)):
            got = attn.mla_decode(sp, cfg, xd, sc, sr, 9)
        close(got, want)
        if layout == "kv_seq":
            close(torch.cat(sc.parts, 1), c1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", GROUPS)
@pytest.mark.parametrize("s", [12, 1])
def test_experts_over_model(m, s, dtype):
    cfg = moe.MoEConfig(32, 8, 2, 24, n_shared_experts=1, d_ff_shared=48)
    p = init_params(moe.moe_defs(cfg, dtype), 16, "cpu")
    x = rand(3, s, 32, dtype=dtype, seed=17)
    want, aux = moe.moe_ffn(p, cfg, x)
    sp = dict(p, wi=blocks(p["wi"], 0, m), wg=blocks(p["wg"], 0, m),
              wo=blocks(p["wo"], 0, m),
              shared={n: blocks(w, 0 if n == "wo" else 1, m)
                      for n, w in p["shared"].items()})
    with use_group(group(m)):
        got, aux2 = moe.moe_ffn(sp, cfg, x)
    close(got, want)
    assert torch.equal(aux2, aux)


def test_traced_position_runs_its_share_alone():
    """A group whose ``active`` is one position computes that position's
    block only; its collectives stand in for the others' parts."""
    x, w = rand(2, 64), rand(64, 96, seed=1)
    g = ModelGroup(((0, 0), (0, 1), (0, 2), (0, 3)),
                   (torch.device("cpu"),) * 4, (2,), dict(DEFAULT_RULES))
    wb = ModelBlocks([w[:, 48:72]], 1, 96, (2,), 4)
    with use_group(g), shd.count_transfers() as rec:
        y = layers.matmul(x, wb)
    assert y.shape == (2, 96)
    assert torch.equal(y[:, 48:72], x @ w[:, 48:72])
    assert rec.bytes["all-gather"] == math.ceil(2 * 96 * 4 * 3 / 4)


def _mamba(dtype):
    """The smoke mixer (8 heads of 16, d_state 16: conv channels 160) with
    its decay, step bias, skip and norm scale drawn so that they matter."""
    cfg = ssm.SSMConfig(64, 128, 16, 16, chunk=8)
    p = init_params(ssm.mamba2_defs(cfg, dtype), 18, "cpu")
    for i, n in enumerate(("a_log", "dt_bias", "d_skip")):
        p[n] = rand(8, seed=20 + i)
    p["norm"] = {"scale": rand(128, seed=23) + 1}
    return cfg, p


def _split_mamba(p, m):
    out = dict(p)
    for n in ("wz", "wx", "wdt", "conv"):
        out[n] = blocks(p[n], 1, m)
    for n in ("a_log", "dt_bias", "d_skip"):
        out[n] = blocks(p[n], 0, m)
    out["wo"] = blocks(p["wo"], 0, m)
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", GROUPS)
def test_mamba2_mixer_split(m, dtype):
    """Full sequence (20 steps: 2 chunks and a padded one) and a decode
    step from its cache.  The conv's ceil(160 / m) channel blocks straddle
    the positions' channels (xs heads, then B and C blocks): 40 against
    32 + 4 + 4 at m = 4, 80 against 64 + 8 + 8 at m = 2."""
    cfg, p = _mamba(dtype)
    assert cfg.conv_channels // m != cfg.d_inner // m       # they straddle
    x = rand(2, 20, 64, dtype=dtype, seed=24)
    y, (conv, state) = ssm.mamba2_block(p, cfg, x)
    sp = _split_mamba(p, m)
    with use_group(group(m)), shd.count_transfers() as rec:
        y2, (conv2, state2) = ssm.mamba2_block(sp, cfg, x)
    close(y2, y)
    assert torch.equal(torch.cat(conv2.parts, 2), conv)
    close(torch.cat(state2.parts, 1), state)
    # the gated norm's sums, wo's partials; B / C gathered; conv channels
    # (each collective counted at each of the m receiving positions)
    assert rec.counts["all-reduce"] == 2 * m
    assert rec.counts["all-gather"] == 2 * m
    assert rec.bytes["collective-permute"] > 0

    xt = rand(2, 1, 64, dtype=dtype, seed=25)
    yd, (win, st) = ssm.mamba2_decode(p, cfg, xt, (conv, state))
    with use_group(group(m)):
        yd2, (win2, st2) = ssm.mamba2_decode(
            sp, cfg, xt, (blocks(conv, 2, m), blocks(state, 1, m)))
    close(yd2, yd)
    assert torch.equal(torch.cat(win2.parts, 2), win)
    close(torch.cat(st2.parts, 1), st)


def test_mamba2_gated_norm_all_reduces_float32_sums():
    """The gated RMSNorm over the whole d_inner from the positions' float32
    sums of squares, each position scaling its block: one all-reduce of
    [B, L, 1] float32 before wo's."""
    cfg, p = _mamba(torch.bfloat16)
    y = rand(2, 6, 8, 16, seed=26)
    z = rand(2, 6, 128, dtype=torch.bfloat16, seed=27)
    want = ssm._gate_out(p, cfg, y, z, torch.bfloat16)
    sp = _split_mamba(p, 4)
    g = group(4)
    with use_group(g), shd.count_transfers() as rec:
        got = ssm._gate_out_split(
            g, sp, cfg, [y[:, :, 2 * k:2 * k + 2] for k in range(4)],
            [z[..., 32 * k:32 * k + 32] for k in range(4)], torch.bfloat16)
    close(got, want)
    # per position a ring's 2 (M - 1) / M of [2, 6, 1] and of wo's [2, 6, 64]
    assert rec.bytes["all-reduce"] == 4 * (72 + 4608)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", GROUPS)
def test_lora_ffn_split(m, dtype):
    """The shared FFN plus one use's LoRA correction: ``ffn_a`` over its
    contracted D, ``ffn_b`` column-parallel, the correction through wo's
    rows with an all-reduce of its own."""
    model = get("zamba2-7b").make_smoke()
    shared = init_params(layers.ffn_defs(64, 128, True, dtype), 28, "cpu")
    lora = {"ffn_a": rand(64, 8, dtype=dtype, seed=29),
            "ffn_b": rand(8, 128, dtype=dtype, seed=30)}
    hn = rand(2, 6, 64, dtype=dtype, seed=31)
    want = model._ffn_with_lora({"ffn": shared}, lora, hn)
    sf = {n: blocks(w, 0 if n == "wo" else 1, m) for n, w in shared.items()}
    sl = dict(lora, ffn_b=blocks(lora["ffn_b"], 1, m))
    with use_group(group(m)), shd.count_transfers() as rec:
        got = model._ffn_with_lora({"ffn": sf}, sl, hn)
    close(got, want)
    # the FFN's, ffn_a's and the correction's, at each of the m positions
    assert rec.counts["all-reduce"] == 3 * m


def test_whisper_attention_pads_its_heads_on_three_positions():
    """whisper's 4 smoke heads on a (1, 3) group, wq / wk / wv / wo whole
    (their heads do not divide): padded to 6, two a position, the third
    position's all zero heads.  The encoder's non-causal pass over its own
    K/V, then cross-attention decode against a static cache."""
    model = get("whisper-large-v3").make_smoke()
    cfg = model.cfg.attn_config(False)
    p = init_params(attn.gqa_defs(cfg, torch.float32), 32, "cpu")
    mem = rand(2, 16, 64, seed=33)
    pos = torch.arange(16).expand(2, 16)
    kv = attn.encoder_kv(p, cfg, mem)
    want, _ = attn.gqa_attention(p, cfg, mem, pos, kv_override=kv)
    xd = rand(2, 1, 64, seed=34)
    want_d = attn.gqa_decode(p, cfg, xd, kv[0], kv[1], 5, cross=True)
    rules = {**DEFAULT_RULES, "heads": None, "kv_heads": None,
             "_mesh_sizes": {"model": 3}}
    g = group(3, rules)
    seen = []
    real = attn._flash
    with use_group(g):
        kv2 = attn.encoder_kv(p, cfg, mem)
        for a, b in zip(kv2, kv):
            close(a, b)
        try:
            attn._flash = lambda q, *a, **kw: (seen.append(q.shape[2]),
                                               real(q, *a, **kw))[1]
            got, rows = attn.gqa_attention(p, cfg, mem, pos, kv_override=kv2)
        finally:
            attn._flash = real
        got_d = attn.gqa_decode(p, cfg, xd, kv2[0], kv2[1], 5, cross=True)
    assert seen == [2, 2, 2] and rows is kv2
    close(got, want)
    close(got_d, want_d)
