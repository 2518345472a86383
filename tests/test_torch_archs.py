"""Parity of the port's dense architectures with the JAX package:
gemma-7b (GeGLU, sqrt(d) embedding scale, zero-centred RMSNorm, head_dim
256 != d_model / n_heads, as many KV heads as query heads), granite-8b and
deepseek-67b, beside qwen3-1.7b.

The full configs are compared by their parameter definitions only (shapes,
dtypes, counts; nothing is allocated).  The smoke models run in both
packages on the reference's weights, carried across with ``from_numpy``,
with every RMSNorm ``scale`` leaf redrawn N(0, 0.5) from a seed, so that
``scale + 1`` of the zero-centred norm is really exercised.

Tolerances:
  * float32 configs (the same models with ``dtype`` float32 in both
    packages): logits within atol 1e-4, prefill and four chained decode
    steps; measured at most 1.4e-5 (gemma, seeds 0-2), 2.2e-6 for the
    others.  This is the check of the architecture's code.
  * bf16 (the served dtype): logits and the prefill's keys within atol
    0.05, as in ``test_torch_serve.py``, plus one bf16 ulp of the value
    (rtol 2**-7: the keys reach 15, where an ulp is 0.0625), for the
    prefill and for each decode step fed the same token and the
    reference's cache.  Each bf16 operation of the port rounds as the
    reference's does except ``tanh`` inside GeGLU (one ulp on 0.25% of
    outputs: XLA's CPU tanh is its own approximation), and the smoke
    models amplify such ulps: a gemma decode step reaches 0.11 on seed 2,
    its chained decode 0.057 on seed 0 (ROADMAP Queue 3).
  * the packed path (placed session on the reference's table and
    placement): logits within atol 0.1 with the port fed the reference's
    greedy tokens (measured at most 0.04); the port's own greedy tokens
    equal the reference's up to the first step whose reference top-2
    margin is at most twice the measured logits difference, where a tie
    may break either way (bf16 logits of these models tie to the ulp:
    margins of 0 and 0.004 occur).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_cpu  # noqa: E402,F401  (one intra-op thread)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get as j_get  # noqa: E402
from repro.core.calibrate import CalibrationConfig as JCal  # noqa: E402
from repro.core.fleet import FleetConfig as JFleet  # noqa: E402
from repro.launch.serve import greedy_generate as j_generate  # noqa: E402
from repro.models.params import init_params as j_init  # noqa: E402
from repro.models.params import param_count as j_count  # noqa: E402
from repro.pud.gemv import PUDGemvConfig as JGemvCfg  # noqa: E402
from repro.runtime.session import PUDSession as JSession  # noqa: E402
from repro_torch.configs import all_archs, get  # noqa: E402
from repro_torch.core.calibrate import CalibrationConfig  # noqa: E402
from repro_torch.core.fleet import FleetConfig  # noqa: E402
from repro_torch.launch.serve import greedy_generate  # noqa: E402
from repro_torch.models.layers import ACT, rmsnorm  # noqa: E402
from repro_torch.models.params import from_numpy, param_count  # noqa: E402
from repro_torch.runtime.session import PUDSession  # noqa: E402

NEW = ["gemma-7b", "granite-8b", "deepseek-67b"]
B, S, GEN = 2, 12, 4
MAX_LEN = S + GEN + 1
ATOL_BF16, RTOL_BF16, ATOL_PACKED = 0.05, 2 ** -7, 0.1


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def _random_scales(tree, rng, path=()):
    """The tree with every RMSNorm ``scale`` leaf redrawn N(0, 0.5)."""
    if isinstance(tree, dict):
        return {k: _random_scales(v, rng, path + (k,))
                for k, v in tree.items()}
    a = np.asarray(tree)
    if path[-1] == "scale":
        return (0.5 * rng.standard_normal(a.shape)).astype(a.dtype)
    return a


def _smoke(arch, seed=0):
    jmodel = j_get(arch).make_smoke()
    jparams = jax.tree.map(np.asarray,
                           j_init(jmodel.param_defs(), jax.random.key(seed)))
    jparams = _random_scales(jparams, np.random.default_rng(seed))
    params = from_numpy(jparams, "cpu")
    jparams = jax.tree.map(jnp.asarray, jparams)
    return jmodel, jparams, get(arch).make_smoke(), params


def test_registry_lists_the_dense_family():
    assert all_archs() == ["deepseek-67b", "deepseek-v2-lite-16b",
                           "gemma-7b", "granite-8b",
                           "llama4-scout-17b-a16e", "mamba2-1.3b",
                           "pixtral-12b", "qwen3-1.7b", "whisper-large-v3",
                           "zamba2-7b"]
    assert [a for a in all_archs() if get(a).family == "dense"] == \
        ["deepseek-67b", "gemma-7b", "granite-8b", "qwen3-1.7b"]
    with pytest.raises(KeyError, match="not ported yet"):
        get("zamba3-1b")


@pytest.mark.parametrize("arch", NEW + ["qwen3-1.7b"])
@pytest.mark.parametrize("preset", ["full", "smoke"])
def test_param_defs_match_reference(arch, preset):
    """The same tree, leaf shapes, dtypes and parameter count; the full
    config's count near the registry's ``n_params``."""
    js, spec = j_get(arch), get(arch)
    jdefs = (js.make_model() if preset == "full"
             else js.make_smoke()).param_defs()
    defs = (spec.make_model() if preset == "full"
            else spec.make_smoke()).param_defs()
    jl, tl = dict(_leaves(jdefs)), dict(_leaves(defs))
    assert sorted(jl) == sorted(tl)
    for path, d in tl.items():
        assert d.shape == jl[path].shape, path
        assert d.axes == jl[path].axes, path
        assert d.init == jl[path].init, path
        assert str(d.dtype).split(".")[-1] == jnp.dtype(jl[path].dtype).name
    assert param_count(defs) == j_count(jdefs)
    assert (spec.n_params, spec.n_active_params) == \
        (js.n_params, js.n_active_params)
    if preset == "full":
        assert abs(param_count(defs) / spec.n_params - 1) < 0.05


def test_gemma_config_fields():
    """What gemma exercises that qwen3 does not, in both presets."""
    for model in (get("gemma-7b").make_model(), get("gemma-7b").make_smoke()):
        cfg = model.cfg
        assert cfg.activation == "gelu" and cfg.embed_scale
        assert cfg.zero_centered_norm and cfg.n_kv_heads == cfg.n_heads
        assert cfg.hd != cfg.d_model // cfg.n_heads
    full = get("gemma-7b").make_model().cfg
    assert (full.d_model, full.d_ff, full.vocab, full.hd) == \
        (3072, 24576, 256000, 256)


def test_gelu_and_zero_centred_norm_match_reference():
    """``ACT["gelu"]`` is the tanh form and the zero-centred norm adds 1 to
    the scale in float32, as the reference's layers do."""
    from repro.models.layers import ACT as J_ACT
    from repro.models.layers import rmsnorm as j_rmsnorm
    rng = np.random.default_rng(3)
    x = rng.standard_normal((5, 64)).astype(np.float32) * 3
    np.testing.assert_allclose(ACT["gelu"](torch.from_numpy(x)).numpy(),
                               np.asarray(J_ACT["gelu"](jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)
    scale = rng.standard_normal(64).astype(np.float32)
    for zc in (False, True):
        got = rmsnorm({"scale": torch.from_numpy(scale)},
                      torch.from_numpy(x), zero_centered=zc)
        want = j_rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x),
                         zero_centered=zc)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-6)


def test_gemma_embedding_scale_rounds_to_bf16_first():
    """sqrt(d_model) is rounded to bf16 before the multiply (sqrt(64) = 8
    is exact; sqrt(3072) = 55.43 rounds to 55.5)."""
    from repro.models.transformer import LMConfig as JCfg
    from repro.models.transformer import TransformerLM as JLM
    from repro_torch.models.transformer import LMConfig, TransformerLM
    kw = dict(name="t", n_layers=1, d_model=3072, n_heads=12, n_kv_heads=12,
              d_ff=64, vocab=16, head_dim=32, embed_scale=True)
    table = np.random.default_rng(4).standard_normal((16, 3072)).astype(
        np.float32)
    toks = np.arange(16, dtype=np.int32)[None]
    got = TransformerLM(LMConfig(**kw))._embed_tokens(
        {"embed": {"table": torch.from_numpy(table).bfloat16()}},
        torch.from_numpy(toks))
    want = JLM(JCfg(**kw))._embed_tokens(
        {"embed": {"table": jnp.asarray(table, jnp.bfloat16)}},
        jnp.asarray(toks))
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("arch", NEW + ["qwen3-1.7b"])
def test_smoke_float32_logits_match_teacher_forced(arch, seed):
    """The smoke configs in float32: prefill and four chained decode steps
    fed the same tokens in both packages, and the caches."""
    import dataclasses
    from repro.models.transformer import TransformerLM as JLM
    from repro_torch.models.transformer import TransformerLM
    jmodel = JLM(dataclasses.replace(j_get(arch).make_smoke().cfg,
                                     dtype=jnp.float32))
    model = TransformerLM(dataclasses.replace(get(arch).make_smoke().cfg,
                                              dtype=torch.float32))
    jp = jax.tree.map(np.asarray,
                      j_init(jmodel.param_defs(), jax.random.key(seed)))
    jp = _random_scales(jp, np.random.default_rng(seed))
    params, jparams = from_numpy(jp, "cpu"), jax.tree.map(jnp.asarray, jp)
    rng = np.random.default_rng(5)
    toks = rng.integers(0, model.cfg.vocab, (B, S)).astype(np.int32)
    feed = rng.integers(0, model.cfg.vocab, (GEN, B, 1)).astype(np.int32)
    jl, jc = jax.jit(jmodel.prefill, static_argnames=("max_len",))(
        jparams, jnp.asarray(toks), max_len=MAX_LEN)
    with torch.inference_mode():
        logits, cache = model.prefill(params, torch.from_numpy(toks),
                                      max_len=MAX_LEN)
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), rtol=0,
                               atol=1e-4)
    step = jax.jit(jmodel.decode_step)
    for i in range(GEN):
        jl, jc = step(jparams, jc, jnp.asarray(feed[i]), jnp.int32(S + i))
        with torch.inference_mode():
            logits, cache = model.decode_step(
                params, cache, torch.from_numpy(feed[i]), S + i)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jl), rtol=0,
                                   atol=1e-4)
    name = next(iter(cache))
    for n in ("k", "v"):
        np.testing.assert_allclose(cache[name][n].numpy(),
                                   np.asarray(jc[name][n]), rtol=0,
                                   atol=1e-4)


@pytest.mark.parametrize("arch", NEW)
def test_smoke_bf16_logits_allclose_teacher_forced(arch):
    """bf16: the prefill, then four decode steps, each fed the same token
    and the reference's cache of the step before."""
    jmodel, jparams, model, params = _smoke(arch)
    rng = np.random.default_rng(5)
    toks = rng.integers(0, model.cfg.vocab, (B, S)).astype(np.int32)
    feed = rng.integers(0, model.cfg.vocab, (GEN, B, 1)).astype(np.int32)
    jl, jc = jax.jit(jmodel.prefill, static_argnames=("max_len",))(
        jparams, jnp.asarray(toks), max_len=MAX_LEN)
    with torch.inference_mode():
        logits, cache = model.prefill(params, torch.from_numpy(toks),
                                      max_len=MAX_LEN)
    tol = dict(rtol=RTOL_BF16, atol=ATOL_BF16)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **tol)
    name = next(iter(cache))
    np.testing.assert_allclose(cache[name]["k"].float().numpy(),
                               np.asarray(jc[name]["k"], np.float32), **tol)
    step = jax.jit(jmodel.decode_step)
    for i in range(GEN):
        ref_cache = from_numpy(jax.tree.map(np.asarray, jc), "cpu")
        jl, jc = step(jparams, jc, jnp.asarray(feed[i]), jnp.int32(S + i))
        with torch.inference_mode():
            logits, _ = model.decode_step(
                params, ref_cache, torch.from_numpy(feed[i]), S + i)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **tol)


@pytest.mark.parametrize("arch", NEW)
def test_packed_greedy_tokens_identical_through_placed_session(arch,
                                                               tmp_path):
    """The reference calibrates, places and persists; the port's session
    hits both on the same directory and its packed greedy decode equals
    the reference's token for token."""
    jmodel, jparams, model, params = _smoke(arch)
    grid = dict(n_channels=1, n_banks=1, n_subarrays=8, n_cols=512)
    name = f"{arch}-smoke"
    js = JSession.open(arch, grid=JFleet(**grid), cache_dir=tmp_path,
                       calib=JCal(n_iterations=4, n_samples=64),
                       key=jax.random.key(2), n_trials_ecr=128,
                       backend="reference")
    js.calibrate()
    jpacked = js.pack(jparams, JGemvCfg(), name=name)
    s = PUDSession.open(arch, grid=FleetConfig(**grid), cache_dir=tmp_path,
                        calib=CalibrationConfig(n_iterations=4,
                                                n_samples=64),
                        seed=2, n_trials_ecr=128, device="cpu")
    assert s.calibrate().cache_hit
    packed = s.pack(params, name=name)
    assert s.placement_status == "hit" and packed.placed
    toks = np.random.default_rng(6).integers(
        0, model.cfg.vocab, (B, S)).astype(np.int32)
    jt, jl = j_generate(jmodel, jpacked.params, jnp.asarray(toks), GEN,
                        MAX_LEN)
    jt, jl = np.asarray(jt), np.asarray(jl)
    # teacher-forced: the port fed the reference's tokens
    with torch.inference_mode():
        logits, cache = model.prefill(packed.params, torch.from_numpy(toks),
                                      max_len=MAX_LEN)
        forced = [logits]
        for i in range(GEN - 1):
            logits, cache = model.decode_step(
                packed.params, cache, torch.tensor(jt[:, i:i + 1]),
                S + i)
            forced.append(logits)
    forced = torch.stack(forced, dim=1).numpy()
    np.testing.assert_allclose(forced, jl[:, :GEN], rtol=0,
                               atol=ATOL_PACKED)
    # free-running: equal up to the first near-tie of the reference
    delta = float(np.abs(forced - jl[:, :GEN]).max())
    top2 = np.sort(jl[:, :GEN], axis=-1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > 2 * delta
    t, _ = greedy_generate(model, packed.params, torch.from_numpy(toks),
                           GEN, MAX_LEN)
    for row in range(B):
        upto = GEN if clear[row].all() else int(np.argmin(clear[row]))
        np.testing.assert_array_equal(t.numpy()[row, :upto], jt[row, :upto])
