"""The float32 split over a lane's "model" positions gives the unsplit
model's bits.  Every sum the split divides among positions, and its
unsplit counterpart, accumulates in float64 and rounds once to float32
(``sharding_ctx.accum_dtype``), forward and backward: the row- and
contract-parallel products and their ``psum`` (``layers.sum_product``
unsplit), the gradients of an input that several positions' column-parallel
products read (``layers.shared``, ``layers.product``), the gated RMSNorm,
the vocab-parallel loss's sums, the attention's ``wo``, and the Mamba2
mixer's SSD.

  * each split block against its unsplit form on groups of 2 and 4 CPU
    positions, on inputs drawn with numpy from a seed: the outputs and the
    gradients of every input and weight equal bit for bit;
  * zamba2-7b's smoke model: the sharded train step's first gradients on
    (2, 2) and (1, 4) CPU meshes within ``STEP0_TOL`` of each leaf's
    largest magnitude of the one-device step's (the two data lanes of
    (2, 2) add their float32 gradients in another order than one device's
    batch, as a split of the data lanes alone does).
"""
import _torch_cpu  # noqa: F401
import numpy as np
import pytest
import torch

from repro_torch.models import attention as attn
from repro_torch.models import layers, ssm
from repro_torch.models.params import DEFAULT_RULES
from repro_torch.models.sharding_ctx import (ModelBlocks, ModelGroup,
                                             block_bounds, set_rules,
                                             use_group)

GROUPS = [2, 4]
STEP0_TOL = 1e-6


def group(m: int) -> ModelGroup:
    return ModelGroup(tuple((0, k) for k in range(m)),
                      (torch.device("cpu"),) * m, tuple(range(m)),
                      dict(DEFAULT_RULES))


def blocks(w: torch.Tensor, dim: int, m: int) -> ModelBlocks:
    n = w.shape[dim]
    return ModelBlocks([w.narrow(dim, lo, hi - lo) for lo, hi in
                        (block_bounds(n, m, k) for k in range(m))],
                       dim, n, tuple(range(m)), m)


def draw(seed: int, **shapes) -> dict:
    """float32 leaves requiring grad, drawn with numpy from ``seed``."""
    rng = np.random.default_rng(seed)
    return {n: torch.from_numpy(0.5 * rng.standard_normal(s).astype(
        np.float32)).requires_grad_() for n, s in shapes.items()}


def run(fn, leaves: dict, seed: int = 99):
    """(outputs, gradients of every leaf) of ``fn(**leaves)`` under an
    upstream gradient drawn from ``seed``."""
    out = fn(**leaves)
    outs = out if isinstance(out, tuple) else (out,)
    rng = np.random.default_rng(seed)
    ups = [torch.from_numpy(rng.standard_normal(o.shape).astype(np.float32))
           for o in outs]
    grads = torch.autograd.grad(outs, list(leaves.values()), ups)
    return [o.detach() for o in outs], grads


def same(split, whole) -> None:
    (outs, grads), (wouts, wgrads) = split, whole
    for a, b in zip(outs, wouts):
        assert a.dtype == b.dtype == torch.float32 and torch.equal(a, b), \
            float((a - b).abs().max())
    for i, (a, b) in enumerate(zip(grads, wgrads)):
        assert torch.equal(a, b), (i, float((a - b).abs().max()))


@pytest.mark.parametrize("m", GROUPS)
@pytest.mark.parametrize("kind", ["column", "row", "contract"])
def test_products(m, kind):
    leaves = draw(1, x=(3, 5, 64), w=(64, 96))

    def split(x, w):
        with use_group(group(m)):
            if kind == "contract":
                return layers.contract_parallel(x, w)
            return layers.matmul(x, blocks(w, 1 if kind == "column" else 0,
                                           m))
    whole = layers.product if kind == "column" else layers.sum_product
    same(run(split, leaves), run(whole, leaves))


@pytest.mark.parametrize("m", GROUPS)
def test_ffn(m):
    leaves = draw(2, x=(2, 6, 32), wi=(32, 160), wg=(32, 160), wo=(160, 32))

    def split(x, wi, wg, wo):
        p = {"wi": blocks(wi, 1, m), "wg": blocks(wg, 1, m),
             "wo": blocks(wo, 0, m)}
        with use_group(group(m)):
            return layers.ffn(p, x, "silu")
    same(run(split, leaves), run(lambda x, **p: layers.ffn(p, x, "silu"),
                                 leaves))


@pytest.mark.parametrize("m", GROUPS)
def test_gated_norm_and_out_projection(m):
    """``_gate_out`` against ``_gate_out_split``: the gated RMSNorm's
    all-reduced sum of squares, then wo row-parallel."""
    cfg = ssm.SSMConfig(64, 128, 16, 16, chunk=8)
    leaves = draw(3, y=(2, 10, 8, 16), z=(2, 10, 128), scale=(128,),
                  wo=(128, 64))

    def whole(y, z, scale, wo):
        return ssm._gate_out({"norm": {"scale": scale}, "wo": wo}, cfg, y, z,
                             torch.float32)

    def split(y, z, scale, wo):
        p = {"norm": {"scale": scale}, "wo": blocks(wo, 0, m)}
        ys = [t for t in y.chunk(m, dim=2)]
        zs = [t for t in z.chunk(m, dim=-1)]
        with use_group(group(m)) as g:
            return ssm._gate_out_split(g, p, cfg, ys, zs, torch.float32)
    same(run(split, leaves), run(whole, leaves))


@pytest.mark.parametrize("m", GROUPS)
def test_vocab_parallel_loss(m):
    leaves = draw(4, h=(2, 40, 32), w=(32, 256))
    rng = np.random.default_rng(5)
    labels = torch.from_numpy(rng.integers(0, 256, (2, 40)))
    mask = torch.from_numpy((rng.random((2, 40)) < 0.8).astype(np.float32))

    def whole(h, w):
        return layers.chunked_softmax_xent({"w": w}, h, labels, mask, 16)[0]

    def split(h, w):
        with use_group(group(m)):
            return layers.chunked_softmax_xent({"w": blocks(w, 1, m)}, h,
                                               labels, mask, 16)[0]
    same(run(split, leaves), run(whole, leaves))


@pytest.mark.parametrize("m", GROUPS)
def test_gqa_attention(m):
    """Heads and kv heads split alike (the hybrid's shared block): the
    projections read x's shared form, wo row-parallel."""
    cfg = attn.AttnConfig(32, 4, 4, 8, kv_chunk=8)
    leaves = draw(6, x=(2, 16, 32), wq=(32, 4, 8), wk=(32, 4, 8),
                  wv=(32, 4, 8), wo=(4, 8, 32))
    pos = torch.arange(16).expand(2, 16)

    def whole(x, **p):
        out, (k, v) = attn.gqa_attention(p, cfg, x, pos)
        return out, k, v

    def split(x, wq, wk, wv, wo):
        p = {"wq": blocks(wq, 1, m), "wk": blocks(wk, 1, m),
             "wv": blocks(wv, 1, m), "wo": blocks(wo, 0, m)}
        rules = {**DEFAULT_RULES, "_mesh_sizes": {"model": m}}
        set_rules(rules)
        try:
            with use_group(group(m)):
                out, (k, v) = attn.gqa_attention(p, cfg, x, pos)
        finally:
            set_rules(None)
        return out, torch.cat(k.parts, 2), torch.cat(v.parts, 2)
    same(run(split, leaves), run(whole, leaves))


@pytest.mark.parametrize("m", GROUPS)
def test_gqa_decode_over_a_sequence_split_cache(m):
    """One decode step against a cache split over its sequence: the
    softmax's sum and the values' product all-reduced in float64 equal the
    unsplit softmax (forward only: decode)."""
    cfg = attn.AttnConfig(32, 8, 4, 8, kv_chunk=8)
    t = draw(7, x=(3, 1, 32), wq=(32, 8, 8), wk=(32, 4, 8), wv=(32, 4, 8),
             wo=(8, 8, 32), ck=(3, 16, 4, 8), cv=(3, 16, 4, 8))
    t = {n: v.detach() for n, v in t.items()}
    p = {n: t[n] for n in ("wq", "wk", "wv", "wo")}
    ck, cv = t["ck"].clone(), t["cv"].clone()
    want = attn.gqa_decode(p, cfg, t["x"], ck, cv, 11)
    sk, sv = blocks(t["ck"].clone(), 1, m), blocks(t["cv"].clone(), 1, m)
    sp = {n: blocks(w, 0 if n == "wo" else 1, m) for n, w in p.items()}
    with use_group(group(m)):
        got = attn.gqa_decode(sp, cfg, t["x"], sk, sv, 11)
    assert torch.equal(got, want)
    assert torch.equal(torch.cat(sk.parts, 1), ck)


def _mamba_split(p: dict, m: int) -> dict:
    out = dict(p)
    for n in ("wz", "wx", "wdt", "conv"):
        out[n] = blocks(p[n], 1, m)
    for n in ("a_log", "dt_bias", "d_skip"):
        out[n] = blocks(p[n], 0, m)
    out["wo"] = blocks(p["wo"], 0, m)
    return out


@pytest.mark.parametrize("m", GROUPS)
def test_mamba2_mixer(m):
    """The whole mixer (20 steps: two chunks of 8 and a padded one): the
    projections, the conv's channel blocks, the SSD of each position's
    heads on the gathered B and C, the gated norm, wo."""
    cfg = ssm.SSMConfig(64, 128, 16, 16, chunk=8)
    leaves = draw(8, x=(2, 20, 64), wz=(64, 128), wx=(64, 128),
                  wB=(64, 16), wC=(64, 16), wdt=(64, 8), conv=(4, 160),
                  a_log=(8,), dt_bias=(8,), d_skip=(8,), scale=(128,),
                  wo=(128, 64))

    def params(scale, **p):
        return dict(p, norm={"scale": scale})

    def whole(x, **p):
        y, (tail, state) = ssm.mamba2_block(params(**p), cfg, x)
        return y, state

    def split(x, **p):
        with use_group(group(m)):
            y, (tail, state) = ssm.mamba2_block(
                _mamba_split(params(**p), m), cfg, x)
        return y, torch.cat(state.parts, 1)
    same(run(split, leaves), run(whole, leaves))


@pytest.mark.parametrize("m", GROUPS)
def test_hybrid_lora_ffn(m):
    """zamba2's shared FFN with a use's LoRA: ffn_a contract-parallel,
    ffn_b column-parallel, the correction through wo row-parallel."""
    from repro_torch.configs import get
    model = get("zamba2-7b").make_smoke()
    leaves = draw(9, hn=(2, 6, 64), wi=(64, 128), wg=(64, 128),
                  wo=(128, 64), ffn_a=(64, 8), ffn_b=(8, 128))

    def whole(hn, ffn_a, ffn_b, **f):
        return model._ffn_with_lora({"ffn": f}, {"ffn_a": ffn_a,
                                                 "ffn_b": ffn_b}, hn)

    def split(hn, wi, wg, wo, ffn_a, ffn_b):
        f = {"wi": blocks(wi, 1, m), "wg": blocks(wg, 1, m),
             "wo": blocks(wo, 0, m)}
        with use_group(group(m)):
            return model._ffn_with_lora(
                {"ffn": f}, {"ffn_a": ffn_a, "ffn_b": blocks(ffn_b, 1, m)},
                hn)
    same(run(split, leaves), run(whole, leaves))


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)])
def test_zamba2_split_step_gradients_match_one_device(shape):
    """The first step's gradients of zamba2-7b's float32 smoke model,
    sharded with its compute split over "model", against the one-device
    step's on the reference's weights and data stream."""
    from _families import leaves, pair
    from _mesh import on_mesh, ref_batches
    from repro_torch.runtime import sharding as shd
    from repro_torch.runtime import steps

    _, _, model, params = pair("zamba2-7b", f32=True)
    batch = {n: torch.from_numpy(v.copy())
             for n, v in ref_batches("zamba2-7b", model, n=1)[0].items()}
    loss, grads = steps.microbatch_grads(model, params, batch)
    sp, mesh, rules = on_mesh(model, params, shape)
    lane = steps.lane_positions(mesh)[0]
    set_rules(rules)
    try:
        assert steps.lane_group(model, mesh, lane).size == shape[1]
        sloss, sgrads = steps.sharded_microbatch_grads(model, sp, batch)
    finally:
        set_rules(None)
    assert abs(float(sloss) - float(loss)) <= STEP0_TOL * abs(float(loss))
    one = dict(leaves(grads))
    got = dict(leaves(shd.gather_tree(sgrads, "cpu")))
    assert got.keys() == one.keys()
    for path, g in got.items():
        want = one[path]
        if want.numel():
            err = float((g - want).abs().max())
            assert err <= STEP0_TOL * float(want.abs().max()), (path, err)
