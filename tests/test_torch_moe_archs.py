"""Parity of the port's MoE architectures with the JAX package:
deepseek-v2-lite-16b (MLA attention, 64 routed + 2 shared experts, top-6,
one dense layer first) and llama4-scout-17b-a16e (GQA, 16 routed + 1
shared expert, top-1).

The full configs are compared by their parameter definitions and packing
demand only (nothing is allocated: meta tensors stand in for weights).
The smoke models run in both packages on the reference's weights, carried
across with ``from_numpy``.

Tolerances:
  * float32 configs: logits within 1e-4 of the reference's jitted model,
    prefill and four chained decode steps (measured below 5e-5).
  * bf16 and the packed path: equal bit for bit to the reference run op
    by op (``jax.disable_jit``), prefill and decode.  The reference's own
    jitted model is not the yardstick here: XLA fuses bf16 operations with
    float32 excess precision, and MoE routing amplifies such an ulp (a
    token changes experts), so the reference's jitted and op-by-op logits
    differ by up to 0.21 on the deepseek smoke model at seed 0, more than
    the serve tolerance of 0.05; the port equals the op-by-op reference
    exactly.
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
from repro.pud.gemv import ATTN_PACKABLE as J_ATTN  # noqa: E402
from repro.pud.gemv import FFN_PACKABLE as J_FFN  # noqa: E402
from repro.pud.gemv import PUDGemvConfig as JGemvCfg  # noqa: E402
from repro.pud.packer import packing_requests as j_requests  # noqa: E402
from repro.runtime.session import PUDSession as JSession  # noqa: E402
from repro_torch.configs import all_archs, get  # noqa: E402
from repro_torch.core.calibrate import CalibrationConfig  # noqa: E402
from repro_torch.core.fleet import FleetConfig  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models.params import (from_numpy, init_params,  # noqa: E402
                                       param_count)
from repro_torch.pud.gemv import (ATTN_PACKABLE, FFN_PACKABLE,  # noqa: E402
                                  PUDGemvConfig)
from repro_torch.pud.packer import pack_model, packing_requests  # noqa: E402
from repro_torch.runtime.engine import Request, ServingEngine  # noqa: E402
from repro_torch.runtime.session import PUDSession  # noqa: E402

MOE = ["deepseek-v2-lite-16b", "llama4-scout-17b-a16e"]
B, S, GEN = 2, 12, 4
MAX_LEN = S + GEN + 1
PARAMS = {"deepseek-v2-lite-16b": 15_706_484_224,
          "llama4-scout-17b-a16e": 107_769_861_120}


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def _smoke(arch, seed=0, dtype=None):
    """(reference model, its params, port model, port params)."""
    import dataclasses
    from repro.models.transformer import TransformerLM as JLM
    from repro_torch.models.transformer import TransformerLM
    jmodel, model = j_get(arch).make_smoke(), get(arch).make_smoke()
    if dtype is not None:
        jmodel = JLM(dataclasses.replace(jmodel.cfg, dtype=jnp.float32))
        model = TransformerLM(dataclasses.replace(model.cfg,
                                                  dtype=torch.float32))
    jp = jax.tree.map(np.asarray,
                      j_init(jmodel.param_defs(), jax.random.key(seed)))
    return jmodel, jax.tree.map(jnp.asarray, jp), model, \
        from_numpy(jp, "cpu")


def _meta_tree(defs):
    """A parameter tree of meta tensors: shapes and dtypes, no storage."""
    if isinstance(defs, dict):
        return {k: _meta_tree(defs[k]) for k in sorted(defs)}
    return torch.empty(defs.shape, dtype=defs.dtype, device="meta")


def test_registry_lists_the_moe_family():
    assert [a for a in all_archs() if get(a).family == "moe"] == MOE
    assert len(all_archs()) == 10 and sorted(
        {get(a).family for a in all_archs()}) == [
        "dense", "encdec", "hybrid", "moe", "ssm", "vlm"]
    assert (get(MOE[0]).n_active_params, get(MOE[1]).n_active_params) == \
        (2.7e9, 17e9)


@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("preset", ["full", "smoke"])
def test_param_defs_match_reference(arch, preset):
    """The same tree in the reference's sorted key order (``layers_0_dense``
    before ``layers_1_moe``), leaf shapes, axes, dtypes (the router
    float32) and counts; the full configs' counts exactly."""
    js, spec = j_get(arch), get(arch)
    jm = js.make_model() if preset == "full" else js.make_smoke()
    m = spec.make_model() if preset == "full" else spec.make_smoke()
    jdefs, defs = jm.param_defs(), m.param_defs()
    jl, tl = dict(_leaves(jdefs)), dict(_leaves(defs))
    assert sorted(jl) == sorted(tl)
    for path, d in tl.items():
        assert (d.shape, d.axes, d.init) == \
            (jl[path].shape, jl[path].axes, jl[path].init), path
        assert str(d.dtype).split(".")[-1] == jnp.dtype(jl[path].dtype).name
    routers = [d for p, d in tl.items() if p[-1] == "router"]
    assert routers and all(d.dtype == torch.float32 for d in routers)
    assert param_count(defs) == j_count(jdefs)
    assert (spec.n_params, spec.n_active_params) == \
        (js.n_params, js.n_active_params)
    assert m.cfg.groups() == jm.cfg.groups()
    assert m.supports_chunked_prefill is False
    if preset == "full":
        assert param_count(defs) == PARAMS[arch]
    jc = {g: {n: (d.shape, jnp.dtype(d.dtype).name) for n, d in kv.items()}
          for g, kv in jm.cache_defs(2, 8).items()}
    tc = {g: {n: (d.shape, str(d.dtype).split(".")[-1])
              for n, d in kv.items()}
          for g, kv in m.cache_defs(2, 8).items()}
    assert tc == jc


@pytest.mark.parametrize("arch", MOE)
def test_smoke_float32_prefill_decode(arch):
    """float32: prefill and four chained decode steps (scalar and per-row
    lengths) within 1e-4 of the reference's jitted model, and the cache."""
    jmodel, jparams, model, params = _smoke(arch, seed=1, dtype="f32")
    rng = np.random.default_rng(5)
    toks = rng.integers(0, model.cfg.vocab, (B, S)).astype(np.int32)
    feed = rng.integers(0, model.cfg.vocab, (GEN, B, 1)).astype(np.int32)
    jl, jc = jax.jit(jmodel.prefill, static_argnames=("max_len",))(
        jparams, jnp.asarray(toks), max_len=MAX_LEN)
    with torch.inference_mode():
        logits, cache = model.prefill(params, torch.from_numpy(toks),
                                      max_len=MAX_LEN)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), rtol=0,
                               atol=1e-4)
    step = jax.jit(jmodel.decode_step)
    for i in range(GEN):
        lens = np.full((B,), S + i, np.int32)
        jl, jc = step(jparams, jc, jnp.asarray(feed[i]), jnp.asarray(lens))
        with torch.inference_mode():
            logits, cache = model.decode_step(
                params, cache, torch.from_numpy(feed[i]),
                torch.from_numpy(lens) if i % 2 else S + i)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jl), rtol=0,
                                   atol=1e-4)
    for g, leaves in cache.items():
        for n, c in leaves.items():
            np.testing.assert_allclose(c.numpy(), np.asarray(jc[g][n]),
                                       rtol=0, atol=1e-4)


@pytest.mark.parametrize("arch", MOE)
def test_smoke_bf16_equals_reference_op_by_op(arch):
    """bf16, the served dtype: prefill and four greedy decode steps equal
    the reference run op by op, bit for bit."""
    jmodel, jparams, model, params = _smoke(arch)
    toks = np.random.default_rng(5).integers(
        0, model.cfg.vocab, (4, S)).astype(np.int32)
    with jax.disable_jit():
        jt, jl = j_generate(jmodel, jparams, jnp.asarray(toks), GEN,
                            MAX_LEN)
    t, logits = serve.greedy_generate(model, params, torch.from_numpy(toks),
                                      GEN, MAX_LEN)
    np.testing.assert_array_equal(logits.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(t.numpy(), np.asarray(jt))


@pytest.mark.parametrize("attention", [False, True])
@pytest.mark.parametrize("arch", MOE)
def test_packing_requests_match_reference(arch, attention):
    """The same request names, widths and slice counts; routed expert banks
    unpacked, shared experts (and MLA's wq / wo) packed."""
    _, jparams, _, params = _smoke(arch)
    jcfg = JGemvCfg(packable=J_FFN + (J_ATTN if attention else ()))
    cfg = PUDGemvConfig(packable=FFN_PACKABLE
                        + (ATTN_PACKABLE if attention else ()))
    want = [(r.name, r.n_cols, r.n_slices)
            for r in j_requests(jparams, jcfg)]
    got = [(r.name, r.n_cols, r.n_slices)
           for r in packing_requests(params, cfg)]
    assert got == want
    names = {n for n, _, _ in got}
    moe = next(g for g in params if g.endswith("_moe"))
    assert f"{moe}/mixer/shared/wi" in names
    assert not any(n in names for n in (f"{moe}/mixer/wi",
                                        f"{moe}/mixer/wg",
                                        f"{moe}/mixer/wo"))
    if attention and arch == MOE[0]:
        assert f"{moe}/attn/wq" in names and f"{moe}/attn/wo" in names
        assert f"{moe}/attn/wuk" not in names


def test_moe_experts_left_unpacked():
    """The reference's ``tests/test_pud_gemv.py::
    test_moe_experts_left_unpacked``: routed banks keep the bf16 path."""
    _, _, _, params = _smoke(MOE[0])
    pm = pack_model(params)
    moe = next(k for k in pm.params if k.endswith("_moe"))
    assert "wi" in pm.params[moe]["mixer"]
    assert pm.params[moe]["mixer"]["wi"].dim() == 4
    assert "wi_pud" in pm.params[moe]["mixer"]["shared"]
    assert set(pm.skipped_names) == {f"{moe}/mixer/{k}"
                                     for k in ("wg", "wi", "wo")}


def test_mla_attention_packing_runs():
    """The reference's ``tests/test_placement.py::
    test_mla_attention_packing_runs``: MLA wq / wo pack and the model
    prefills and decodes through them."""
    model = get(MOE[0]).make_smoke()
    params = init_params(model.param_defs(), 0, "cpu")
    pm = pack_model(params, PUDGemvConfig(packable=FFN_PACKABLE
                                          + ATTN_PACKABLE))
    assert any(p.endswith("attn/wq") for p in pm.packed_names)
    toks = torch.randint(0, model.cfg.vocab, (2, 8), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        logits, cache = model.prefill(pm.params, toks, max_len=12)
        assert not bool(torch.isnan(logits).any())
        nxt = torch.argmax(logits, -1).to(torch.int32)[:, None]
        step, _ = model.decode_step(pm.params, cache, nxt, 8)
    assert not bool(torch.isnan(step).any())


@pytest.mark.parametrize("attention,want", [(False, 326_016),
                                            (True, 464_256)])
def test_full_config_placed_columns(attention, want):
    """deepseek-v2-lite-16b at full width, from its definitions alone: the
    FFN + unembed packs need 326,016 columns, 464,256 with MLA's wq / wo;
    the reference counts the same from its abstract tree."""
    model = get(MOE[0]).make_model()
    cfg = PUDGemvConfig(packable=FFN_PACKABLE
                        + (ATTN_PACKABLE if attention else ()))
    reqs = packing_requests(_meta_tree(model.param_defs()), cfg)
    assert sum(r.n_cols * max(1, r.n_slices) for r in reqs) == want
    # the reference's requests, traced over abstract arrays
    jm, jreqs = j_get(MOE[0]).make_model(), []
    abstract = jax.tree.map(lambda d: jax.ShapeDtypeStruct(d.shape, d.dtype),
                            jm.param_defs(),
                            is_leaf=lambda d: hasattr(d, "axes"))
    jax.eval_shape(lambda t: jreqs.extend(j_requests(t, JGemvCfg(
        packable=J_FFN + (J_ATTN if attention else ())))), abstract)
    assert [(r.name, r.n_cols, r.n_slices) for r in jreqs] == \
        [(r.name, r.n_cols, r.n_slices) for r in reqs]


@pytest.mark.parametrize("arch", MOE[:1])
def test_packed_greedy_equal_through_placed_session(arch, tmp_path):
    """The reference calibrates, places and packs; the port's session hits
    its table and placement on the same directory, and its packed greedy
    decode equals the reference's run op by op, tokens and logits (on
    deepseek, which has both MLA and MoE; llama4's packing is held to the
    reference's by its requests, its model by the bf16 case)."""
    jmodel, jparams, model, params = _smoke(arch)
    grid = dict(n_channels=1, n_banks=1, n_subarrays=8, n_cols=512)
    js = JSession.open(arch, grid=JFleet(**grid), cache_dir=tmp_path,
                       calib=JCal(n_iterations=4, n_samples=64),
                       key=jax.random.key(2), n_trials_ecr=128,
                       backend="reference")
    js.calibrate()
    jpacked = js.pack(jparams, JGemvCfg(), name="moe")
    s = PUDSession.open(arch, grid=FleetConfig(**grid), cache_dir=tmp_path,
                        calib=CalibrationConfig(n_iterations=4,
                                                n_samples=64),
                        seed=2, n_trials_ecr=128, device="cpu")
    assert s.calibrate().cache_hit
    packed = s.pack(params, name="moe")
    assert s.placement_status == "hit" and packed.placed
    assert s.flops_per_token() == 2 * get(arch).n_active_params
    toks = np.random.default_rng(6).integers(
        0, model.cfg.vocab, (B, S)).astype(np.int32)
    with jax.disable_jit():
        jt, jl = j_generate(jmodel, jpacked.params, jnp.asarray(toks), GEN,
                            MAX_LEN)
    t, logits = serve.greedy_generate(model, packed.params,
                                      torch.from_numpy(toks), GEN, MAX_LEN)
    np.testing.assert_array_equal(logits.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(t.numpy(), np.asarray(jt))


def test_chunk_prefill_raises_on_moe():
    """The reference's ``tests/test_chunked_prefill.py::
    test_moe_rejects_chunk_prefill``, and the model's own chunk entry."""
    model = get(MOE[0]).make_smoke()
    assert not model.supports_chunked_prefill
    params = init_params(model.param_defs(), 0, "cpu")
    with pytest.raises(ValueError, match="sequence-global"):
        ServingEngine(model, params, max_len=32, chunk_prefill=4)
    cache = {g: {n: torch.zeros(d.shape, dtype=d.dtype)
                 for n, d in kv.items()}
             for g, kv in model.cache_defs(1, 16).items()}
    with pytest.raises(NotImplementedError, match="MoE"):
        model.prefill_chunk(params, torch.zeros((1, 4), dtype=torch.int32),
                            cache, 0, kv_len=8)


@pytest.mark.parametrize("prefix_cache", [False, True])
def test_engine_equals_lockstep_deepseek_smoke(prefix_cache):
    """4 prompts of 8 tokens, 4 new tokens each, on 4 slots (capacity =
    the batch: no token dropped at decode), exact-length whole prefill;
    with a prefix cache two repeated prompts hit: tokens and logits equal
    the lockstep decode's, bit for bit."""
    model = get(MOE[0]).make_smoke()
    params = init_params(model.param_defs(), 3, "cpu")
    rng = np.random.default_rng(8)
    toks = torch.from_numpy(rng.integers(0, model.cfg.vocab, (4, 8)).astype(
        np.int32))
    t, logits = serve.greedy_generate(model, params, toks, 4, 13)
    eng = ServingEngine(model, params, max_len=13, batch_size=4,
                        collect_logits=True, prefix_cache=prefix_cache)
    reqs = [Request(i, toks[i % 4], 4) for i in range(6 if prefix_cache
                                                      else 4)]
    comps = eng.run(reqs)
    rep = eng.scheduler_report()
    assert rep["prefill_traces"] == 1          # one exact length, 8
    for c in comps:
        i = c.request_id % 4
        assert c.tokens == t[i].tolist()
        assert torch.equal(c.logits, logits[i, :4])
    if prefix_cache:
        assert rep["prefix_cache"]["hits"] == 2


def test_serve_cli_deepseek_smoke(tmp_path, capsys):
    """``serve --arch deepseek-v2-lite-16b --pud-gemv --pud-attention
    --engine`` at smoke size on the CPU."""
    res = serve.run(serve.parse_args([
        "--arch", MOE[0], "--preset", "smoke", "--batch", "4",
        "--prompt-len", "8", "--gen", "3", "--pud-gemv", "--pud-attention",
        "--engine", "--batch-size", "4", "--calib-cache", str(tmp_path),
        "--fleet-subarrays", "8", "--fleet-cols", "512", "--device", "cpu"]))
    out = capsys.readouterr().out
    assert res["packed"].placed and res["engine_agreement"] == 1.0
    assert "100.0% of requests bit-identical" in out
    assert any(n.endswith("attn/wq") for n in res["packed"].packed_names)
