"""Parity of the port's MLA (multi-head latent attention) with the JAX
package: full-sequence attention, one prefill chunk resumed into the latent
cache, and the absorbed-matmul decode at one position and at a position per
row, on the same inputs (drawn with numpy from a seed) and the same
weights (the reference's, carried across with ``from_numpy``).

Tolerances:
  * float32: within 1e-4 (measured below 1e-5);
  * bf16: equal bit for bit.  The reference's functions run here op by op,
    as the port does, and every bf16 operation rounds alike; the scores
    stay float32 through the scale and the mask in both.

Plus the reference's own MLA tests, in the port: chunked prefill of the
deepseek smoke model with its MoE stripped equals whole prefill bit for bit
(``tests/test_chunked_prefill.py::test_chunked_mla_dense``), and per-row
decode lengths equal the scalar length (``tests/test_engine.py::
test_mla_vector_cur_len``).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_cpu  # noqa: E402,F401  (one intra-op thread)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import attention as j_attn  # noqa: E402
from repro.models.params import init_params as j_init  # noqa: E402
from repro_torch.configs import get  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models.params import (from_numpy, init_params,  # noqa: E402
                                       stack_defs)
from repro_torch.models.transformer import TransformerLM  # noqa: E402
from repro_torch.runtime.engine import Request, ServingEngine  # noqa: E402

CFG = dict(d_model=64, n_heads=4, kv_lora_rank=32, qk_nope_dim=16,
           qk_rope_dim=8, v_head_dim=16)
B, S, SMAX = 3, 10, 16
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-4),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 0.0)}


def _weights(dtype_name, seed=0):
    jdt, tdt, tol = DTYPES[dtype_name]
    jcfg = j_attn.MLAConfig(**CFG)
    jp = jax.tree.map(np.asarray,
                      j_init(j_attn.mla_defs(jcfg, jdt), jax.random.key(seed)))
    return jcfg, attn.MLAConfig(**CFG), jax.tree.map(jnp.asarray, jp), \
        from_numpy(jp, "cpu"), jdt, tdt, tol


def _close(got, want, tol):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    if tol == 0:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def _x(shape, jdt, tdt, seed=1):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


def test_mla_defs_match_reference():
    jd = j_attn.mla_defs(j_attn.MLAConfig(**CFG))
    d = attn.mla_defs(attn.MLAConfig(**CFG))
    assert list(d) == list(jd)
    for k in ("wq", "wdkv", "wkr", "wuk", "wuv", "wo"):
        assert (d[k].shape, d[k].axes, d[k].init) == \
            (jd[k].shape, jd[k].axes, jd[k].init)
    assert attn.MLAConfig(**CFG).qk_dim == 24


@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
def test_mla_attention_matches_reference(dtype_name):
    jcfg, cfg, jp, p, jdt, tdt, tol = _weights(dtype_name)
    jx, x = _x((B, S, CFG["d_model"]), jdt, tdt)
    pos = np.broadcast_to(np.arange(S), (B, S)).copy()
    jout, (jckv, jkr) = j_attn.mla_attention(jp, jcfg, jx, jnp.asarray(pos))
    with torch.inference_mode():
        out, (ckv, kr) = attn.mla_attention(p, cfg, x, torch.from_numpy(pos))
    assert out.dtype == tdt and tuple(kr.shape) == (B, S, CFG["qk_rope_dim"])
    for got, want in ((out, jout), (ckv, jckv), (kr, jkr)):
        _close(got, want, tol)


@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
def test_mla_prefill_chunk_matches_reference(dtype_name):
    """The second chunk of a prompt resumed into a latent cache that holds
    the first: output and cache equal the reference's."""
    jcfg, cfg, jp, p, jdt, tdt, tol = _weights(dtype_name)
    rng = np.random.default_rng(2)
    ckv0 = rng.standard_normal((B, SMAX, CFG["kv_lora_rank"]))
    kr0 = rng.standard_normal((B, SMAX, CFG["qk_rope_dim"]))
    jx, x = _x((B, 4, CFG["d_model"]), jdt, tdt, seed=3)
    jout, jckv, jkr = j_attn.mla_prefill_chunk(
        jp, jcfg, jx, jnp.asarray(ckv0, jdt), jnp.asarray(kr0, jdt), 4,
        kv_len=8)
    ckv = torch.from_numpy(ckv0).to(tdt)
    kr = torch.from_numpy(kr0).to(tdt)
    with torch.inference_mode():
        out = attn.mla_prefill_chunk(p, cfg, x, ckv, kr, 4, kv_len=8)
    for got, want in ((out, jout), (ckv, jckv), (kr, jkr)):
        _close(got, want, tol)


@pytest.mark.parametrize("per_slot", [False, True])
@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
def test_mla_decode_matches_reference(dtype_name, per_slot):
    """One decode step over a filled latent cache; per slot, one lane sits
    at ``max_len``: the reference drops its write, the port masks it."""
    jcfg, cfg, jp, p, jdt, tdt, tol = _weights(dtype_name)
    rng = np.random.default_rng(4)
    ckv0 = rng.standard_normal((B, SMAX, CFG["kv_lora_rank"]))
    kr0 = rng.standard_normal((B, SMAX, CFG["qk_rope_dim"]))
    jx, x = _x((B, 1, CFG["d_model"]), jdt, tdt, seed=5)
    lens = np.array([5, 11, SMAX], np.int32) if per_slot else 9
    jout, jckv, jkr = j_attn.mla_decode(
        jp, jcfg, jx, jnp.asarray(ckv0, jdt), jnp.asarray(kr0, jdt),
        jnp.asarray(lens))
    ckv = torch.from_numpy(ckv0).to(tdt)
    kr = torch.from_numpy(kr0).to(tdt)
    with torch.inference_mode():
        out = attn.mla_decode(p, cfg, x, ckv, kr,
                              torch.from_numpy(lens) if per_slot else lens)
    assert tuple(out.shape) == (B, 1, CFG["d_model"])
    for got, want in ((out, jout), (ckv, jckv), (kr, jkr)):
        _close(got, want, tol)
    if per_slot:                   # the lane at max_len kept its cache
        np.testing.assert_array_equal(
            ckv[2].float().numpy(),
            torch.from_numpy(ckv0[2]).to(tdt).float().numpy())


def test_mla_layer_stack_defs_keep_reference_order():
    defs = stack_defs(attn.mla_defs(attn.MLAConfig(**CFG)), 3)
    jdefs = j_attn.mla_defs(j_attn.MLAConfig(**CFG))
    assert list(defs) == list(jdefs)
    assert defs["wuk"].shape == (3,) + jdefs["wuk"].shape


# -- the reference's MLA tests, in the port ----------------------------------

MAX_LEN, PROMPT, GEN = 32, 8, 4


def _prompts(vocab, lens, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.integers(0, vocab, n).astype(np.int32))
            for n in lens]


def _requests(prompts):
    return [Request(i, t, GEN) for i, t in enumerate(prompts)]


def test_chunked_mla_dense():
    """The MLA chunk path (latent cache re-expansion) is bit-exact: the
    deepseek smoke config with its MoE stripped (no registered arch is
    dense MLA; MoE routing is sequence-global and stays unchunked)."""
    cfg = dataclasses.replace(get("deepseek-v2-lite-16b").make_smoke().cfg,
                              n_experts=0)
    model = TransformerLM(cfg)
    assert model.supports_chunked_prefill
    params = init_params(model.param_defs(), 2, "cpu")
    prompts = _prompts(cfg.vocab, [5, 11, 8], seed=3)
    whole = ServingEngine(model, params, max_len=MAX_LEN, batch_size=2,
                          collect_logits=True)
    chunked = ServingEngine(model, params, max_len=MAX_LEN, batch_size=2,
                            collect_logits=True, chunk_prefill=4,
                            prefix_cache=True)
    a, b = whole.run(_requests(prompts)), chunked.run(_requests(prompts))
    assert chunked.scheduler_report()["prefill_chunks"] > 3
    for x, y in zip(a, b):
        assert x.tokens == y.tokens
        assert torch.equal(x.logits, y.logits)


def test_mla_vector_cur_len():
    """Per-slot lengths hold for the MLA decode: a [B] vector of equal
    lengths gives the scalar path's logits bit for bit."""
    model = get("deepseek-v2-lite-16b").make_smoke()
    params = init_params(model.param_defs(), 0, "cpu")
    toks = torch.stack(_prompts(model.cfg.vocab, [PROMPT] * 2, seed=1))
    with torch.inference_mode():
        logits, cache = model.prefill(params, toks, max_len=MAX_LEN)
        nxt = torch.argmax(logits, -1).to(torch.int32)[:, None]
        c2 = {g: {n: t.clone() for n, t in kv.items()}
              for g, kv in cache.items()}
        l_s, _ = model.decode_step(params, cache, nxt, PROMPT)
        l_v, _ = model.decode_step(params, c2,
                                   nxt, torch.full((2,), PROMPT,
                                                   dtype=torch.int32))
    assert torch.equal(l_s, l_v)
