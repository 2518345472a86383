"""Parity of the port's Mamba2 / SSD block and the mamba2-1.3b family with
the JAX package (``models/ssm.py``, ``models/ssm_lm.py``).

The full config is compared by its parameter definitions only (nothing is
allocated).  The blocks and the smoke model run in both packages on the
same numpy-drawn inputs and the reference's weights (``from_numpy``), with
the decay ``a_log``, the step bias ``dt_bias``, the skip ``d_skip`` and
the RMSNorm scales redrawn N(0, 0.5) so that each matters.

Tolerances:
  * softplus: within one float32 ulp of ``jax.nn.softplus`` (2.4e-7 at
    the values drawn here; XLA's CPU ``exp`` and ``log1p`` are their own
    approximations), exactly 0 on the padded tail's dt = -1e9, NaN kept.
  * float32 blocks and models: outputs, conv windows, SSM states and
    logits within 1e-4 of the reference's jitted functions (measured at
    most 2e-6: the SSD's three-operand einsums contract in another order
    than XLA's, which the bound absorbs).
  * bf16, the served dtype: the smoke model's prefill and four decode
    steps equal the reference run op by op (``jax.disable_jit``) bit for
    bit, and lie within 0.05 plus one bf16 ulp of its jitted model (XLA
    fuses the decode conv's products and sum in float32, an ulp away on
    37% of its outputs; measured at most 0.027).
  * the packed path: the reference's packed names and placed columns
    exactly; logits within 0.1 teacher-forced; greedy tokens equal up to
    the first reference near-tie.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_cpu  # noqa: E402,F401  (one intra-op thread)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _families import (check_packed_decode, leaves, pair,  # noqa: E402
                       placed_pair, teacher_forced)
from repro.configs import get as j_get  # noqa: E402
from repro.launch.serve import greedy_generate as j_generate  # noqa: E402
from repro.models import ssm as j_ssm  # noqa: E402
from repro.models.params import param_count as j_count  # noqa: E402
from repro_torch.configs import get  # noqa: E402
from repro_torch.launch.serve import greedy_generate  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.models.layers import softplus  # noqa: E402
from repro_torch.models.params import from_numpy, param_count  # noqa: E402

ARCH = "mamba2-1.3b"
B, S, GEN = 2, 21, 4          # S: one full chunk of 16 and a padded tail
MAX_LEN = S + GEN + 1
ATOL_F32, ATOL_BF16, RTOL_BF16 = 1e-4, 0.05, 2 ** -7
CFG = dict(d_model=32, d_inner=64, d_state=8, head_dim=16, chunk=8)


def _block_params(cfg, seed, dtype=np.float32):
    """Numpy weights of one Mamba2 block (the reference's tree), with
    a_log / dt_bias / d_skip / norm drawn so each matters."""
    rng = np.random.default_rng(seed)
    jdefs = j_ssm.mamba2_defs(j_ssm.SSMConfig(**cfg))
    out = {}
    for path, d in leaves(jdefs):
        if path[-1] in ("a_log", "dt_bias", "d_skip", "scale"):
            a = 0.5 * rng.standard_normal(d.shape)
        else:
            a = rng.standard_normal(d.shape) / np.sqrt(d.shape[0])
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = a.astype(np.float32 if d.dtype == jnp.float32
                                  else dtype)
    return out


def _both(tree):
    return jax.tree.map(jnp.asarray, tree), from_numpy(tree, "cpu")


def test_param_defs_match_reference():
    """Both presets: the same tree, shapes, axes, inits, dtypes (a_log,
    d_skip, dt_bias float32) and counts; the cache's leaves too."""
    for preset in ("full", "smoke"):
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
        jc, tc = dict(leaves(jm.cache_defs(3, 9))), \
            dict(leaves(m.cache_defs(3, 9)))
        assert {p: (d.shape, d.axes) for p, d in tc.items()} == \
            {p: (d.shape, d.axes) for p, d in jc.items()}
    assert param_count(get(ARCH).make_model().param_defs()) == 1_446_505_472
    assert (get(ARCH).family, get(ARCH).shapes) == \
        (j_get(ARCH).family, j_get(ARCH).shapes)


def test_softplus_matches_reference():
    rng = np.random.default_rng(0)
    x = np.concatenate([30 * rng.standard_normal(20000),
                        3 * rng.standard_normal(20000),
                        [-1e9, -100.0, 0.0, 20.0, 21.0, 1e9, np.nan]]
                       ).astype(np.float32)
    got = softplus(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=2 ** -23, atol=2.4e-7)
    assert got[-7] == 0.0 and np.isnan(got[-1])


def test_causal_conv_matches_reference():
    """Depthwise, causal, not flipped: ``F.conv1d`` per channel."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 11, 24)).astype(np.float32)
    k = rng.standard_normal((4, 24)).astype(np.float32)
    got = ssm._causal_conv(torch.from_numpy(x), torch.from_numpy(k))
    want = j_ssm._causal_conv(jnp.asarray(x), jnp.asarray(k))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    # a unit impulse at t = 0 reads the kernel back from its last tap
    imp = torch.zeros((1, 4, 24))
    imp[0, 0] = 1
    out = ssm._causal_conv(imp, torch.from_numpy(k))
    np.testing.assert_allclose(out[0].numpy(), k[::-1], rtol=0, atol=0)


@pytest.mark.parametrize("seq", [5, 8, 21, 32])
def test_mamba2_block_matches_reference(seq):
    """One chunk shorter than ``chunk``, exactly one, a padded tail after
    two (21 = 2 x 8 + 5), and four whole chunks (the inter-chunk
    recurrence): the output, the conv tail and the final state."""
    cfg = CFG
    jp, tp = _both(_block_params(cfg, seed=seq))
    x = np.random.default_rng(seq).standard_normal(
        (2, seq, cfg["d_model"])).astype(np.float32)
    jy, (jconv, jstate) = jax.jit(
        lambda p, x: j_ssm.mamba2_block(p, j_ssm.SSMConfig(**cfg), x))(
        jp, jnp.asarray(x))
    y, (conv, state) = ssm.mamba2_block(tp, ssm.SSMConfig(**cfg),
                                        torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0,
                               atol=ATOL_F32)
    np.testing.assert_allclose(conv.numpy(), np.asarray(jconv), rtol=0,
                               atol=ATOL_F32)
    np.testing.assert_allclose(state.numpy(), np.asarray(jstate), rtol=0,
                               atol=ATOL_F32)
    assert state.dtype == torch.float32 and tuple(state.shape) == (
        2, cfg["d_inner"] // cfg["head_dim"], cfg["head_dim"],
        cfg["d_state"])


def test_mamba2_decode_chained_matches_reference():
    """Four chained one-token steps from a block's prefill state: each
    step's output and the returned (conv window, state); the step does not
    write the cache it is given."""
    cfg = CFG
    jp, tp = _both(_block_params(cfg, seed=3))
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 13, cfg["d_model"])).astype(np.float32)
    _, jcache = j_ssm.mamba2_block(jp, j_ssm.SSMConfig(**cfg),
                                   jnp.asarray(x))
    _, cache = ssm.mamba2_block(tp, ssm.SSMConfig(**cfg),
                                torch.from_numpy(x))
    step = jax.jit(lambda p, x, c: j_ssm.mamba2_decode(
        p, j_ssm.SSMConfig(**cfg), x, c))
    for i in range(4):
        xt = rng.standard_normal((2, 1, cfg["d_model"])).astype(np.float32)
        before = [c.clone() for c in cache]
        jy, jcache = step(jp, jnp.asarray(xt), jcache)
        y, cache_new = ssm.mamba2_decode(tp, ssm.SSMConfig(**cfg),
                                         torch.from_numpy(xt), cache)
        assert all(torch.equal(a, b) for a, b in zip(before, cache))
        cache = cache_new
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0,
                                   atol=ATOL_F32)
        np.testing.assert_allclose(cache[0].numpy(), np.asarray(jcache[0]),
                                   rtol=0, atol=ATOL_F32)
        np.testing.assert_allclose(cache[1].numpy(), np.asarray(jcache[1]),
                                   rtol=0, atol=ATOL_F32)


def test_bf16_decode_conv_equals_reference_op_by_op():
    """The decode conv sums window x kernel over the window in bf16 as
    the reference's ops do one by one: the step's bf16 output and window
    equal the reference's op-by-op step bit for bit, its float32 state
    within 1e-5 (XLA's ``exp`` inside softplus and the decay is an ulp off
    PyTorch's on some values)."""
    cfg = CFG
    tree = _block_params(cfg, seed=4, dtype=jnp.bfloat16)
    jp, tp = _both(tree)
    rng = np.random.default_rng(4)
    conv = rng.standard_normal((3, 3, 80)).astype(jnp.bfloat16)
    state = rng.standard_normal((3, 4, 16, 8)).astype(np.float32)
    xt = rng.standard_normal((3, 1, cfg["d_model"])).astype(jnp.bfloat16)
    with jax.disable_jit():
        jy, (jc, js) = j_ssm.mamba2_decode(
            jp, j_ssm.SSMConfig(**cfg), jnp.asarray(xt),
            (jnp.asarray(conv), jnp.asarray(state)))
    y, (c, s) = ssm.mamba2_decode(
        tp, ssm.SSMConfig(**cfg), from_numpy(xt, "cpu"),
        (from_numpy(conv, "cpu"), from_numpy(state, "cpu")))
    np.testing.assert_array_equal(y.float().numpy(),
                                  np.asarray(jy, np.float32))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=0,
                               atol=1e-5)
    np.testing.assert_array_equal(c.float().numpy(),
                                  np.asarray(jc, np.float32))


@pytest.mark.parametrize("seed", [0, 1])
def test_smoke_float32_prefill_decode(seed):
    """float32: prefill (21 tokens: a padded chunk) and four chained decode
    steps, then the final (conv, state) cache."""
    jmodel, jparams, model, params = pair(ARCH, seed, f32=True)
    rng = np.random.default_rng(5 + seed)
    toks = rng.integers(0, 256, (B, S)).astype(np.int32)
    feed = rng.integers(0, 256, (GEN, B, 1)).astype(np.int32)
    out, cache, jc = teacher_forced(jmodel, jparams, model, params, toks,
                                    feed, MAX_LEN)
    for got, want in out:
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_F32)
    assert set(cache) == {"conv", "state"}
    for n in ("conv", "state"):
        np.testing.assert_allclose(cache[n].numpy(), np.asarray(jc[n]),
                                   rtol=0, atol=ATOL_F32)


def test_smoke_bf16_equals_reference_op_by_op_and_near_jitted():
    """bf16: greedy prefill + four decode steps equal the reference run op
    by op, tokens and logits bit for bit; teacher-forced (each step from
    the reference's cache) within 0.05 + one ulp of its jitted model."""
    jmodel, jparams, model, params = pair(ARCH)
    rng = np.random.default_rng(7)
    toks = rng.integers(0, 256, (B, S)).astype(np.int32)
    with jax.disable_jit():
        jt, jl = j_generate(jmodel, jparams, jnp.asarray(toks), GEN,
                            MAX_LEN)
    t, logits = greedy_generate(model, params, torch.from_numpy(toks), GEN,
                                MAX_LEN)
    np.testing.assert_array_equal(logits.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(t.numpy(), np.asarray(jt))
    feed = rng.integers(0, 256, (GEN, B, 1)).astype(np.int32)
    out, _, _ = teacher_forced(jmodel, jparams, model, params, toks, feed,
                               MAX_LEN, bf16=True, ref_cache=True)
    for got, want in out:
        np.testing.assert_allclose(got, want, rtol=RTOL_BF16,
                                   atol=ATOL_BF16)


def test_packed_through_the_reference_placement(tmp_path):
    """The unembed is the only pack (``mamba.w*`` are bare matmuls, in no
    packable scope): its name and placed columns equal the reference's,
    and the packed decode agrees within the packed tolerance."""
    jmodel, jparams, model, params = pair(ARCH)
    jpacked, packed, s = placed_pair(ARCH, jparams, params, tmp_path)
    assert packed.packed_names == ("unembed/w",)
    assert s.placement.capacity_report()["used_cols"] == 256
    toks = np.random.default_rng(8).integers(0, 256, (B, S)).astype(
        np.int32)
    check_packed_decode(jmodel, jpacked, model, packed, toks, GEN, MAX_LEN)
