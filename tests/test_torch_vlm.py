"""Parity of the port's VLM (``models/multimodal.py``, the pixtral-12b
backbone) and the transformer's backbone entry it runs through
(``TransformerLM._backbone`` / ``apply_backbone``) with the JAX package.

The full config is compared by its parameter definitions only.  The
smoke model (2 layers, 8 patches of d_vit 32) runs in both packages on
the reference's weights (``from_numpy``; RMSNorm scales redrawn N(0,
0.5)) and numpy-drawn patch embeddings.

Tolerances:
  * float32: the projector's prefix within 1e-5, logits within 1e-4 of
    the reference's jitted model (measured at most 3.9e-6), prefill and
    four chained decode steps at positions after the patch prefix; a
    decode step at position n_patches + S within 1e-5 of a prefill over
    one more token (the same position computed two ways).
  * bf16: logits within 0.05 plus one bf16 ulp of the jitted reference
    (measured at most 0.011), teacher-forced from its caches.
  * the packed path: the reference's packed names and placed columns
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
from repro.models.params import param_count as j_count  # noqa: E402
from repro_torch.configs import get  # noqa: E402
from repro_torch.models.params import param_count  # noqa: E402

ARCH = "pixtral-12b"
B, S, GEN = 2, 12, 4
ATOL_F32, ATOL_BF16, RTOL_BF16 = 1e-4, 0.05, 2 ** -7


def _max_len(model):
    return model.cfg.n_patches + S + GEN + 1


@pytest.mark.parametrize("preset", ["full", "smoke"])
def test_param_defs_match_reference(preset):
    """The text backbone's tree plus the two-layer projector; the cache is
    the backbone's."""
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
    assert (m.cfg.n_patches, m.cfg.d_vit) == (jm.cfg.n_patches,
                                              jm.cfg.d_vit)
    jc, tc = dict(leaves(jm.cache_defs(2, 9))), \
        dict(leaves(m.cache_defs(2, 9)))
    assert {p: d.shape for p, d in tc.items()} == \
        {p: d.shape for p, d in jc.items()}
    if preset == "full":
        assert param_count(m.param_defs()) == 12_279_239_680
        assert tl[("projector", "w1")].shape == (1024, 5120)


def test_projector_prefix_matches_reference():
    """``gelu(patches @ w1) @ w2`` with the tanh GELU (``jax.nn.gelu``'s
    default)."""
    jmodel, jparams, model, params = pair(ARCH, f32=True)
    ex, _ = frontend(ARCH, model, B, np.random.default_rng(1))
    want = jmodel._prefix(jparams, jnp.asarray(ex["patches"]))
    got = model._prefix(params, torch.from_numpy(ex["patches"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def test_apply_backbone_matches_reference():
    """The backbone entry from embeddings (the VLM's patches + text):
    hidden states within 1e-4 of the reference's ``apply_backbone``."""
    jmodel, jparams, model, params = pair(ARCH, f32=True)
    rng = np.random.default_rng(2)
    h = rng.standard_normal((B, 10, 64)).astype(np.float32)
    pos = np.broadcast_to(np.arange(10), (B, 10)).astype(np.int32)
    want, _ = jmodel.lm.apply_backbone(jparams, jnp.asarray(h),
                                       jnp.asarray(pos))
    got, aux = model.lm.apply_backbone(params, torch.from_numpy(h),
                                       torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)
    assert aux == 0.0


@pytest.mark.parametrize("seed", [0, 1])
def test_smoke_float32_prefill_decode_after_the_prefix(seed):
    """float32: prefill over 8 patches + 12 tokens, then four chained
    decode steps at positions 20..23; the cache spans patches + text."""
    jmodel, jparams, model, params = pair(ARCH, seed, f32=True)
    rng = np.random.default_rng(5 + seed)
    extras, prefix = frontend(ARCH, model, B, rng)
    toks = rng.integers(0, 256, (B, S)).astype(np.int32)
    feed = rng.integers(0, 256, (GEN, B, 1)).astype(np.int32)
    out, cache, jc = teacher_forced(jmodel, jparams, model, params, toks,
                                    feed, _max_len(model), extras, prefix)
    for got, want in out:
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_F32)
    k = cache["layers_0_dense"]["k"]
    np.testing.assert_allclose(k.numpy(),
                               np.asarray(jc["layers_0_dense"]["k"]),
                               rtol=0, atol=ATOL_F32)
    filled = k[0].abs().flatten(2).amax(-1) > 0
    assert bool(filled[:, :prefix + S + GEN].all())
    assert not bool(filled[:, prefix + S + GEN:].any())


def test_decode_position_follows_the_patch_prefix():
    """A decode step at cur_len = n_patches + S gives the logits a prefill
    over the S + 1 tokens gives at its last row (float32, 1e-5)."""
    _, _, model, params = pair(ARCH, f32=True)
    rng = np.random.default_rng(3)
    extras, prefix = frontend(ARCH, model, B, rng)
    patches = torch.from_numpy(extras["patches"])
    toks = torch.from_numpy(rng.integers(0, 256, (B, S + 1)).astype(
        np.int32))
    ml = _max_len(model)
    with torch.inference_mode():
        _, cache = model.prefill(params, toks[:, :S], patches, max_len=ml)
        step, _ = model.decode_step(params, cache, toks[:, S:], prefix + S)
        whole, _ = model.prefill(params, toks, patches, max_len=ml)
        wrong, _ = model.decode_step(params, model.prefill(
            params, toks[:, :S], patches, max_len=ml)[1], toks[:, S:], S)
    np.testing.assert_allclose(step.numpy(), whole.numpy(), rtol=0,
                               atol=1e-5)
    assert float((wrong - whole).abs().max()) > 1e-3


def test_smoke_bf16_near_reference():
    jmodel, jparams, model, params = pair(ARCH)
    rng = np.random.default_rng(9)
    extras, prefix = frontend(ARCH, model, B, rng)
    toks = rng.integers(0, 256, (B, S)).astype(np.int32)
    feed = rng.integers(0, 256, (GEN, B, 1)).astype(np.int32)
    out, _, _ = teacher_forced(jmodel, jparams, model, params, toks, feed,
                               _max_len(model), extras, prefix, bf16=True,
                               ref_cache=True)
    for got, want in out:
        np.testing.assert_allclose(got, want, rtol=RTOL_BF16,
                                   atol=ATOL_BF16)


@pytest.mark.parametrize("attention,cols", [(False, 896), (True, 1280)])
def test_packed_through_the_reference_placement(tmp_path, attention, cols):
    """The backbone's ``mixer`` FFN and the unembed pack (and with
    ``--pud-attention`` its ``attn``); the projector stays bf16."""
    jmodel, jparams, model, params = pair(ARCH)
    jpacked, packed, s = placed_pair(ARCH, jparams, params, tmp_path,
                                     attention=attention)
    assert len(packed.packed_names) == (8 if attention else 4)
    assert "w1" in packed.params["projector"]
    assert s.placement.capacity_report()["used_cols"] == cols
    rng = np.random.default_rng(8)
    extras, prefix = frontend(ARCH, model, B, rng)
    toks = rng.integers(0, 256, (B, S)).astype(np.int32)
    check_packed_decode(jmodel, jpacked, model, packed, toks, GEN,
                        _max_len(model), extras, prefix)
