"""Parity of the port's encoder-decoder (``models/encdec.py``, the
whisper-large-v3 backbone) and the attention it adds (``encoder_kv``,
``gqa_attention(kv_override=)``, ``gqa_decode(cross=True)``) with the JAX
package.

The full config is compared by its parameter definitions only.  The
attention functions and the smoke model (2 + 2 layers, 16 frames) run in
both packages on the same numpy-drawn inputs and the reference's weights
(``from_numpy``; RMSNorm scales redrawn N(0, 0.5)).

Tolerances:
  * float32: attention outputs within 1e-5, logits within 1e-4 of the
    reference's jitted functions (measured at most 1.0e-6), prefill and
    four chained decode steps, and the caches.
  * bf16: logits within 0.05 plus one bf16 ulp of the jitted reference
    (measured at most 0.0095), teacher-forced from its caches.
  * the packed path (``--pud-attention``: the encoder's four projections
    and the unembed): the reference's packed names and placed columns
    exactly, logits within 0.1 teacher-forced, greedy tokens up to the
    first reference near-tie.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_cpu  # noqa: E402,F401  (one intra-op thread)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _families import (check_packed_decode, frontend, leaves,  # noqa: E402
                       pair, placed_pair, teacher_forced)
from repro.configs import get as j_get  # noqa: E402
from repro.models import attention as j_attn  # noqa: E402
from repro.models import encdec as j_encdec  # noqa: E402
from repro.models.params import param_count as j_count  # noqa: E402
from repro_torch.configs import get  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import encdec  # noqa: E402
from repro_torch.models.params import from_numpy, param_count  # noqa: E402

ARCH = "whisper-large-v3"
B, S, GEN = 2, 12, 4
MAX_LEN = S + GEN + 1
ATOL_F32, ATOL_BF16, RTOL_BF16 = 1e-4, 0.05, 2 ** -7


def _attn_weights(cfg, seed):
    """float32 wq / wk / wv / wo of one attention block, as numpy."""
    rng = np.random.default_rng(seed)
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    w = {"wq": (d, h, hd), "wk": (d, kv, hd), "wv": (d, kv, hd),
         "wo": (h, hd, d)}
    return {k: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
            for k, s in w.items()}


def _cfgs(kv_chunk=1024, n_kv=4):
    kw = dict(d_model=32, n_heads=4, n_kv_heads=n_kv, head_dim=8,
              causal=False, kv_chunk=kv_chunk)
    return j_attn.AttnConfig(**kw), attn.AttnConfig(**kw)


@pytest.mark.parametrize("preset", ["full", "smoke"])
def test_param_defs_match_reference(preset):
    """Encoder and decoder stacks (the decoder's ``self_attn`` /
    ``cross_attn`` / ``lnx``), ungated FFNs; the cache's static cross
    leaves on their own ``frames`` axis."""
    js, spec = j_get(ARCH), get(ARCH)
    jm = js.make_model() if preset == "full" else js.make_smoke()
    m = spec.make_model() if preset == "full" else spec.make_smoke()
    jl, tl = dict(leaves(jm.param_defs())), dict(leaves(m.param_defs()))
    assert sorted(jl) == sorted(tl)
    for path, d in tl.items():
        assert (d.shape, d.axes, d.init) == \
            (jl[path].shape, jl[path].axes, jl[path].init), path
        assert str(d.dtype).split(".")[-1] == \
            jnp.dtype(jl[path].dtype).name, path
    assert param_count(m.param_defs()) == j_count(jm.param_defs())
    jc, tc = dict(leaves(jm.cache_defs(2, 9))), \
        dict(leaves(m.cache_defs(2, 9)))
    assert {p: (d.shape, d.axes) for p, d in tc.items()} == \
        {p: (d.shape, d.axes) for p, d in jc.items()}
    if preset == "full":
        assert param_count(m.param_defs()) == 1_600_990_720
        assert tc[("cross_k",)].shape == (32, 2, 1500, 20, 64)


def test_sinusoid_matches_reference():
    got = encdec._sinusoid(1500, 1280).numpy()
    np.testing.assert_allclose(got, np.asarray(j_encdec._sinusoid(1500,
                                                                  1280)),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(encdec._sinusoid(16, 64).numpy(),
                               np.asarray(j_encdec._sinusoid(16, 64)),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("n_kv", [4, 2])
def test_encoder_kv_and_kv_override_match_reference(n_kv):
    """``encoder_kv`` projects without norm or RoPE; ``gqa_attention``
    with ``kv_override`` ropes nothing, masks nothing (non-causal) and
    returns the override's (k, v) as its cache rows; GQA with 2 KV heads
    too."""
    jcfg, cfg = _cfgs(n_kv=n_kv)
    w = _attn_weights(cfg, seed=n_kv)
    jw, tw = jax.tree.map(jnp.asarray, w), from_numpy(w, "cpu")
    rng = np.random.default_rng(n_kv)
    mem = rng.standard_normal((2, 16, 32)).astype(np.float32)
    x = rng.standard_normal((2, 5, 32)).astype(np.float32)
    pos = np.broadcast_to(np.arange(5), (2, 5)).astype(np.int32)
    jk, jv = j_attn.encoder_kv(jw, jcfg, jnp.asarray(mem))
    k, v = attn.encoder_kv(tw, cfg, torch.from_numpy(mem))
    for got, want in ((k, jk), (v, jv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-5)
    jout, (jk2, _) = j_attn.gqa_attention(jw, jcfg, jnp.asarray(x),
                                          jnp.asarray(pos),
                                          kv_override=(jk, jv))
    out, (k2, v2) = attn.gqa_attention(tw, cfg, torch.from_numpy(x),
                                       torch.from_numpy(pos),
                                       kv_override=(k, v))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=0,
                               atol=1e-5)
    assert k2 is k and v2 is v


def test_ragged_noncausal_flash_matches_reference():
    """16 frames in ``kv_chunk`` 6: the flash loop takes 16 // 6 = 2
    chunks of 8, as the reference's; the result equals one chunk's."""
    jcfg, cfg = _cfgs(kv_chunk=6)
    _, cfg_one = _cfgs(kv_chunk=1024)
    w = _attn_weights(cfg, seed=3)
    jw, tw = jax.tree.map(jnp.asarray, w), from_numpy(w, "cpu")
    rng = np.random.default_rng(3)
    h = rng.standard_normal((2, 16, 32)).astype(np.float32)
    pos = np.broadcast_to(np.arange(16), (2, 16)).astype(np.int32)
    jkv = j_attn.encoder_kv(jw, jcfg, jnp.asarray(h))
    jout, _ = j_attn.gqa_attention(jw, jcfg, jnp.asarray(h),
                                   jnp.asarray(pos), kv_override=jkv)
    kv = attn.encoder_kv(tw, cfg, torch.from_numpy(h))
    out, _ = attn.gqa_attention(tw, cfg, torch.from_numpy(h),
                                torch.from_numpy(pos), kv_override=kv)
    one, _ = attn.gqa_attention(tw, cfg_one, torch.from_numpy(h),
                                torch.from_numpy(pos), kv_override=kv)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(out.numpy(), one.numpy(), rtol=0, atol=1e-5)


@pytest.mark.parametrize("per_slot", [False, True])
def test_cross_decode_matches_reference(per_slot):
    """``gqa_decode(cross=True)``: no RoPE, every one of the 16 frames
    attended, nothing written (the static cache is unchanged); at one
    length for all rows and at a length per row."""
    jcfg, cfg = _cfgs(n_kv=2)
    w = _attn_weights(cfg, seed=5)
    jw, tw = jax.tree.map(jnp.asarray, w), from_numpy(w, "cpu")
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 1, 32)).astype(np.float32)
    ck = rng.standard_normal((3, 16, 2, 8)).astype(np.float32)
    cv = rng.standard_normal((3, 16, 2, 8)).astype(np.float32)
    lens = np.array([3, 9, 15], np.int32)
    cur = lens if per_slot else 7
    jout, jk, _ = j_attn.gqa_decode(jw, jcfg, jnp.asarray(x),
                                    jnp.asarray(ck), jnp.asarray(cv),
                                    jnp.asarray(cur), cross=True)
    tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    out = attn.gqa_decode(tw, cfg, torch.from_numpy(x), tk, tv,
                          torch.from_numpy(lens) if per_slot else 7,
                          cross=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=0,
                               atol=1e-5)
    np.testing.assert_array_equal(tk.numpy(), ck)
    np.testing.assert_array_equal(tv.numpy(), cv)
    np.testing.assert_array_equal(np.asarray(jk), ck)


@pytest.mark.parametrize("seed", [0, 1])
def test_smoke_float32_prefill_decode(seed):
    """float32: encode 16 frames, prefill, four chained decode steps; the
    self and cross caches."""
    jmodel, jparams, model, params = pair(ARCH, seed, f32=True)
    rng = np.random.default_rng(5 + seed)
    extras, _ = frontend(ARCH, model, B, rng)
    toks = rng.integers(0, 256, (B, S)).astype(np.int32)
    feed = rng.integers(0, 256, (GEN, B, 1)).astype(np.int32)
    out, cache, jc = teacher_forced(jmodel, jparams, model, params, toks,
                                    feed, MAX_LEN, extras)
    for got, want in out:
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_F32)
    for n in ("self_k", "self_v", "cross_k", "cross_v"):
        np.testing.assert_allclose(cache[n].numpy(), np.asarray(jc[n]),
                                   rtol=0, atol=ATOL_F32, err_msg=n)


def test_smoke_bf16_near_reference():
    jmodel, jparams, model, params = pair(ARCH)
    rng = np.random.default_rng(9)
    extras, _ = frontend(ARCH, model, B, rng)
    toks = rng.integers(0, 256, (B, S)).astype(np.int32)
    feed = rng.integers(0, 256, (GEN, B, 1)).astype(np.int32)
    out, _, _ = teacher_forced(jmodel, jparams, model, params, toks, feed,
                               MAX_LEN, extras, bf16=True, ref_cache=True)
    for got, want in out:
        np.testing.assert_allclose(got, want, rtol=RTOL_BF16,
                                   atol=ATOL_BF16)


def test_packed_through_the_reference_placement(tmp_path):
    """``--pud-attention``: only the encoder's attention (``enc_layers/
    attn``) and the unembed pack; the decoder's ``self_attn`` /
    ``cross_attn`` and the ungated ``ffn`` are in no packable scope."""
    jmodel, jparams, model, params = pair(ARCH)
    jpacked, packed, s = placed_pair(ARCH, jparams, params, tmp_path,
                                     attention=True)
    assert packed.packed_names == (
        "enc_layers/attn/wk", "enc_layers/attn/wo", "enc_layers/attn/wq",
        "enc_layers/attn/wv", "unembed/w")
    assert s.placement.capacity_report()["used_cols"] == 2 * 4 * 64 + 256
    rng = np.random.default_rng(8)
    extras, _ = frontend(ARCH, model, B, rng)
    toks = rng.integers(0, 256, (B, S)).astype(np.int32)
    check_packed_decode(jmodel, jpacked, model, packed, toks, GEN, MAX_LEN,
                        extras)
