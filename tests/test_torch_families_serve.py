"""Serving the SSM, hybrid, encoder-decoder and VLM families in the port,
against the JAX package: the registry's ten archs, the serving steps,
``serve``'s paths and skip lines for each family, the full configs'
placement demand, and the continuous-batching engine on them.

Engine behaviour settled by probes of the reference on the CPU:
  * mamba2 (the flat ``{"conv", "state"}`` cache, batch on axis 1) serves
    by exact-length whole-prompt prefill; its tokens equal lockstep's bit
    for bit, and the reference engine's (float32 config, both packages);
    ``chunk_prefill`` raises (no ``prefill_chunk``), as the reference's;
  * a prefix-cache hit on mamba2 raises in the reference (its trim and pad
    of cache axis 2 turn the [L, 1, W - 1, C] conv window into [L, 1,
    max_len, C], which ``dynamic_update_slice`` cannot insert), so the
    port refuses ``prefix_cache`` for a cache without a sequence axis at
    construction;
  * zamba2's engine fails in the reference (its segment caches carry the
    batch on axis 2: "scan got values with different leading axis
    sizes"), so the port's engine refuses the model at construction, and
    ``serve --engine`` prints why and goes on;
  * vlm / encdec: ``serve --engine`` and ``--mesh`` print the reference's
    skip line.

Weights are random (the smoke configs, seeds given); tokens compare
exactly where the same arithmetic runs.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_cpu  # noqa: E402,F401  (one intra-op thread)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _families import frontend, pair  # noqa: E402
from repro.configs import all_archs as j_all  # noqa: E402
from repro.configs import get as j_get  # noqa: E402
from repro.pud.gemv import ATTN_PACKABLE as J_ATTN  # noqa: E402
from repro.pud.gemv import FFN_PACKABLE as J_FFN  # noqa: E402
from repro.pud.gemv import PUDGemvConfig as JGemvCfg  # noqa: E402
from repro.pud.packer import packing_requests as j_requests  # noqa: E402
from repro.runtime.engine import Request as JRequest  # noqa: E402
from repro.runtime.engine import ServingEngine as JEngine  # noqa: E402
from repro_torch.configs import all_archs, get  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models.params import init_params  # noqa: E402
from repro_torch.pud.gemv import (ATTN_PACKABLE, FFN_PACKABLE,  # noqa: E402
                                  PUDGemvConfig)
from repro_torch.pud.packer import packing_requests  # noqa: E402
from repro_torch.runtime import steps  # noqa: E402
from repro_torch.runtime.engine import Request, ServingEngine  # noqa: E402

NEW = ["mamba2-1.3b", "zamba2-7b", "whisper-large-v3", "pixtral-12b"]
SMOKE_ARGV = ["--preset", "smoke", "--batch", "2", "--prompt-len", "8",
              "--gen", "2", "--fleet-subarrays", "8", "--fleet-cols", "512",
              "--device", "cpu"]


def _meta_tree(defs):
    """A parameter tree of meta tensors: shapes and dtypes, no storage."""
    if isinstance(defs, dict):
        return {k: _meta_tree(defs[k]) for k in sorted(defs)}
    return torch.empty(defs.shape, dtype=defs.dtype, device="meta")


def test_registry_lists_the_reference_ten():
    assert all_archs() == sorted(j_all()) and len(all_archs()) == 10
    for arch in all_archs():
        js, spec = j_get(arch), get(arch)
        assert (spec.family, spec.shapes, spec.n_params,
                spec.n_active_params) == (js.family, js.shapes, js.n_params,
                                          js.n_active_params), arch
    assert {get(a).family for a in NEW} == {"ssm", "hybrid", "encdec",
                                            "vlm"}
    with pytest.raises(KeyError, match="not ported yet"):
        get("zamba3-1b")


@pytest.mark.parametrize("arch", NEW)
def test_prefill_and_decode_steps(arch):
    """``make_prefill_step(model, family)`` passes the family's extras (the
    VLM's patches, the encoder-decoder's frames) and equals the model's
    own prefill; ``make_decode_step`` its decode step."""
    model = get(arch).make_smoke()
    params = init_params(model.param_defs(), 0, "cpu")
    rng = np.random.default_rng(0)
    ex, prefix = frontend(arch, model, 2, rng)
    ex = {k: torch.from_numpy(v).bfloat16() for k, v in ex.items()}
    toks = torch.from_numpy(rng.integers(0, 256, (2, 6)).astype(np.int32))
    ml = 6 + 3 + prefix
    pf = steps.make_prefill_step(model, get(arch).family)
    dec = steps.make_decode_step(model)
    with torch.inference_mode():
        lg, cache = pf(params, toks, ex or None, max_len=ml)
        want, _ = model.prefill(params, toks, *ex.values(), max_len=ml)
        nxt = torch.argmax(lg, -1).to(torch.int32)[:, None]
        got, _ = dec(params, cache, nxt, 6 + prefix)
    assert torch.equal(lg, want) and bool(torch.isfinite(got).all())


@pytest.mark.parametrize("arch,n_packed,cols", [
    ("mamba2-1.3b", 1, 256), ("zamba2-7b", 5, 512),
    ("whisper-large-v3", 5, 768), ("pixtral-12b", 8, 1280)])
def test_smoke_packing_requests_match_reference(arch, n_packed, cols):
    """``--pud-attention``'s requests on the smoke trees (the reference's
    serve prints the same counts): names, widths and slice counts."""
    _, jparams, _, params = pair(arch)
    want = [(r.name, r.n_cols, r.n_slices) for r in j_requests(
        jparams, JGemvCfg(packable=J_FFN + J_ATTN))]
    got = [(r.name, r.n_cols, r.n_slices) for r in packing_requests(
        params, PUDGemvConfig(packable=FFN_PACKABLE + ATTN_PACKABLE))]
    assert got == want and len(got) == n_packed
    assert sum(c * max(1, n) for _, c, n in got) == cols


@pytest.mark.parametrize("arch,attention,layers,want", [
    ("zamba2-7b", True, None, 46_336), ("mamba2-1.3b", False, None, 50_280),
    ("whisper-large-v3", True, None, 215_706),
    ("pixtral-12b", False, 4, 266_240), ("pixtral-12b", False, None,
                                         1_482_752)])
def test_full_config_placed_columns(arch, attention, layers, want):
    """The full configs' placement demand, from their definitions alone
    (pixtral also at the 4 layers the GPU run serves); the reference
    counts the same from its abstract tree."""
    import dataclasses
    model = get(arch).make_model()
    jm = j_get(arch).make_model()
    if layers:
        model = type(model)(dataclasses.replace(model.cfg, lm=dataclasses.
                            replace(model.cfg.lm, n_layers=layers)))
        jm = type(jm)(dataclasses.replace(jm.cfg, lm=dataclasses.replace(
            jm.cfg.lm, n_layers=layers)))
    cfg = PUDGemvConfig(packable=FFN_PACKABLE
                        + (ATTN_PACKABLE if attention else ()))
    reqs = packing_requests(_meta_tree(model.param_defs()), cfg)
    assert sum(r.n_cols * max(1, r.n_slices) for r in reqs) == want
    jreqs = []
    abstract = jax.tree.map(lambda d: jax.ShapeDtypeStruct(d.shape, d.dtype),
                            jm.param_defs(),
                            is_leaf=lambda d: hasattr(d, "axes"))
    jax.eval_shape(lambda t: jreqs.extend(j_requests(t, JGemvCfg(
        packable=J_FFN + (J_ATTN if attention else ())))), abstract)
    assert [(r.name, r.n_cols, r.n_slices) for r in jreqs] == \
        [(r.name, r.n_cols, r.n_slices) for r in reqs]


def _ragged(n, lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (ln,)).astype(np.int32) for ln in lens[:n]]


def test_mamba2_engine_equals_lockstep_bit_for_bit():
    """bf16 smoke: 6 requests of 5-14 tokens (whole-prompt prefill at each
    exact length) on 3 slots, admitted mid-run: tokens and logits equal
    to each request's own lockstep decode."""
    model = get("mamba2-1.3b").make_smoke()
    params = init_params(model.param_defs(), 3, "cpu")
    prompts = _ragged(6, [5, 9, 14, 7, 5, 11], 1)
    eng = ServingEngine(model, params, max_len=20, batch_size=3,
                        collect_logits=True)
    comps = eng.run([Request(i, p, 4 + i % 3) for i, p in
                     enumerate(prompts)])
    rep = eng.scheduler_report()
    assert rep["prefill_traces"] == 5 and rep["prefilled_tokens"] == 51
    assert max(c.admitted_step for c in comps) > 0
    for c in comps:
        toks, logits = serve.greedy_generate(
            model, params, torch.from_numpy(prompts[c.request_id])[None],
            4 + c.request_id % 3, 20)
        assert c.tokens == toks[0].tolist(), c.request_id
        assert torch.equal(c.logits, logits[0, :len(c.tokens)])


def test_mamba2_engine_tokens_equal_the_reference_engine():
    """float32 smoke, the same weights and requests in both packages'
    engines (2 slots): the same tokens for every request."""
    jmodel, jparams, model, params = pair("mamba2-1.3b", seed=2, f32=True)
    prompts = _ragged(5, [6, 10, 4, 8, 12], 2)
    jeng = JEngine(jmodel, jparams, max_len=18, batch_size=2)
    jcomps = jeng.run([JRequest(i, p, 5) for i, p in enumerate(prompts)])
    comps = ServingEngine(model, params, max_len=18, batch_size=2).run(
        [Request(i, p, 5) for i, p in enumerate(prompts)])
    assert [c.tokens for c in comps] == [c.tokens for c in jcomps]


def test_mamba2_chunk_prefill_raises():
    model = get("mamba2-1.3b").make_smoke()
    params = init_params(model.param_defs(), 0, "cpu")
    assert not getattr(model, "supports_chunked_prefill", False)
    with pytest.raises(ValueError, match="no prefill_chunk"):
        ServingEngine(model, params, max_len=16, chunk_prefill=4)
    with pytest.raises(ValueError, match="sequence-global"):
        JEngine(j_get("mamba2-1.3b").make_smoke(), {}, max_len=16,
                chunk_prefill=4)


def test_mamba2_prefix_cache_refused_as_the_reference_raises():
    """The probe: a prompt shorter than the model's 8 SSM heads (5 tokens)
    served twice through the reference's engine with a prefix cache
    raises at the hit; the port refuses the prefix cache up front."""
    jmodel, jparams, model, params = pair("mamba2-1.3b")
    assert jmodel.ssm.n_heads == 8
    toks = _ragged(1, [5], 4)[0]
    jeng = JEngine(jmodel, jparams, max_len=10, batch_size=1,
                   prefix_cache=True)
    jeng.run([JRequest(0, toks, 4)])
    with pytest.raises(TypeError, match="dynamic_update_slice"):
        jeng.run([JRequest(1, toks, 4)])
    with pytest.raises(ValueError, match="no sequence axis"):
        ServingEngine(model, params, max_len=10, batch_size=1,
                      prefix_cache=True)


def test_hybrid_engine_fails_in_the_reference_and_is_refused():
    jmodel, jparams, model, params = pair("zamba2-7b")
    toks = _ragged(2, [6, 6], 5)
    # 4 slots: the insert into axis 1 (there per_segment, 3) fits, and
    # the decode step's scan then raises, as the reference's serve does
    jeng = JEngine(jmodel, jparams, max_len=12, batch_size=4)
    with pytest.raises(ValueError, match="different leading axis sizes"):
        jeng.run([JRequest(i, t, 3) for i, t in enumerate(toks)])
    with pytest.raises(ValueError, match="batch on axis 1"):
        ServingEngine(model, params, max_len=12, batch_size=2)


def test_serve_families_through_the_cli(tmp_path, capsys):
    """``serve --pud-gemv --pud-attention --engine`` for each new family:
    the reference's pack counts; mamba2's engine equal to lockstep;
    zamba2's engine refused with the reason; whisper's and pixtral's
    engine skipped with the reference's line."""
    want = {"mamba2-1.3b": "1 projections packed",
            "zamba2-7b": "5 projections packed",
            "whisper-large-v3": "5 projections packed",
            "pixtral-12b": "8 projections packed"}
    for arch, packed in want.items():
        assert serve.main(["--arch", arch, *SMOKE_ARGV, "--pud-gemv",
                           "--pud-attention", "--engine", "--calib-cache",
                           str(tmp_path / arch)]) == 0
        out = capsys.readouterr().out
        assert packed in out, arch
        if arch == "mamba2-1.3b":
            assert "100.0% of requests bit-identical" in out
        elif arch == "zamba2-7b":
            assert "engine: the continuous-batching engine needs the " \
                "batch on axis 1" in out and "skipping" in out
        else:
            assert "engine: vlm/encdec families not supported yet " \
                "(extras require family-specific prefill); skipping" in out


@pytest.mark.parametrize("arch,line", [
    ("whisper-large-v3", "fleet: vlm/encdec families not supported yet"),
    ("pixtral-12b", "fleet: vlm/encdec families not supported yet"),
    # the SSM is served on the fleet; the hybrid keeps its engine's refusal
    ("mamba2-1.3b", "fleet engine: 2 requests over 2 lanes"),
    ("zamba2-7b", "fleet: the continuous-batching engine needs the batch "
     "on axis 1")])
def test_serve_mesh_skips_the_new_families(arch, line, tmp_path, capsys):
    assert serve.main(["--arch", arch, *SMOKE_ARGV, "--pud-gemv",
                       "--engine", "--mesh", "2,2", "--calib-cache",
                       str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert line in out and "bf16 path" in out


def test_vlm_serve_positions_and_frontend_draws():
    """The VLM's cache spans patches + text (``max_len`` grows by
    n_patches), its greedy decode starts after the prefix; the frontends
    draw 0.1 x N(0, 1) in bf16 from the seed."""
    model = get("pixtral-12b").make_smoke()
    ex, prefix = serve.frontend_extras(model, "vlm", 2, 1, "cpu")
    assert prefix == 8 and ex["patches"].shape == (2, 8, 32)
    assert ex["patches"].dtype == torch.bfloat16
    assert 0.05 < float(ex["patches"].float().std()) < 0.2
    again, _ = serve.frontend_extras(model, "vlm", 2, 1, "cpu")
    assert torch.equal(ex["patches"], again["patches"])
    fr, p0 = serve.frontend_extras(get("whisper-large-v3").make_smoke(),
                                   "encdec", 2, 1, "cpu")
    assert p0 == 0 and fr["frames"].shape == (2, 16, 64)
    assert serve.frontend_extras(get("mamba2-1.3b").make_smoke(), "ssm", 2,
                                 1, "cpu") == ({}, 0)
    res = serve.run(serve.parse_args(["--arch", "pixtral-12b", *SMOKE_ARGV]))
    assert res["max_len"] == 8 + 2 + 1 + 8 and res["prefix_len"] == 8
    assert tuple(res["ref_toks"].shape) == (2, 2)
