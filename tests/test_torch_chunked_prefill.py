"""The port's chunked prefill, prefix cache and SLO admission against the
JAX package, and against its own whole-request prefill.

Models are the qwen3-1.7b and gemma-7b smoke configs on the reference's
weights (``from_numpy``).  Tolerances:
  * within the port, the scheduler extensions are invisible: tokens and
    logits of chunked, cached and resumed runs equal whole-request
    prefill's bit for bit (raw bf16 trees, placed packs, logical packs);
  * against the reference's ``prefill_chunk``: float32 configs within
    atol 1e-4 (logits and cache); qwen3 in bf16 within atol 0.05 (logits;
    one bf16 ulp of the value more for the cache, rtol 2**-7).  gemma's
    bf16 smoke model amplifies the one-ulp ``tanh`` differences of GeGLU
    past that (``test_torch_archs.py``), so gemma is held in float32;
  * against the reference's engine (float32 configs, whose logits are not
    rounded to bf16 and so do not tie; ``test_torch_engine.py`` holds the
    bf16 packs): tokens, the schedule, the scheduler and prefix-cache
    counters and every SLO decision exactly equal; logits within atol
    1e-4 (atol 0.1 on the packed path).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_cpu  # noqa: E402,F401  (one intra-op thread)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get as j_get  # noqa: E402
from repro.core.calibrate import CalibrationConfig as JCal  # noqa: E402
from repro.core.fleet import FleetConfig as JFleet  # noqa: E402
from repro.models.params import init_params as j_init  # noqa: E402
from repro.models.transformer import TransformerLM as JLM  # noqa: E402
from repro.pud.gemv import PUDGemvConfig as JGemvCfg  # noqa: E402
from repro.runtime.engine import Request as JRequest  # noqa: E402
from repro.runtime.engine import SLOConfig as JSLO  # noqa: E402
from repro.runtime.engine import ServingEngine as JEngine  # noqa: E402
from repro.runtime.session import PUDSession as JSession  # noqa: E402
from repro_torch.configs import get  # noqa: E402
from repro_torch.core.calibrate import CalibrationConfig  # noqa: E402
from repro_torch.core.fleet import FleetConfig  # noqa: E402
from repro_torch.models.params import from_numpy  # noqa: E402
from repro_torch.models.transformer import TransformerLM  # noqa: E402
from repro_torch.pud.gemv import PUDGemvConfig  # noqa: E402
from repro_torch.runtime.engine import (Request, ServingEngine,  # noqa: E402
                                        SLOConfig)
from repro_torch.runtime.prefix_cache import PrefixCache  # noqa: E402
from repro_torch.runtime.session import PUDSession  # noqa: E402

MAX_LEN, GEN = 32, 4
ATOL_PACKED = 0.1
GRID = dict(n_channels=1, n_banks=1, n_subarrays=8, n_cols=1024)


def _models(arch, dtype="bf16", seed=0):
    jmodel, model = j_get(arch).make_smoke(), get(arch).make_smoke()
    if dtype == "float32":
        jmodel = JLM(dataclasses.replace(jmodel.cfg, dtype=jnp.float32))
        model = TransformerLM(dataclasses.replace(model.cfg,
                                                  dtype=torch.float32))
    jp = jax.tree.map(np.asarray,
                      j_init(jmodel.param_defs(), jax.random.key(seed)))
    return jmodel, jax.tree.map(jnp.asarray, jp), model, from_numpy(jp,
                                                                     "cpu")


@pytest.fixture(scope="module", params=["qwen3-1.7b", "gemma-7b"])
def smoke(request):
    """(reference model, its params, port model, its params), bf16."""
    return _models(request.param)


@pytest.fixture(scope="module", params=[("qwen3-1.7b", "float32"),
                                        ("gemma-7b", "float32")])
def pair(request):
    """The models held against the reference's engine, and the arch."""
    return _models(*request.param), request.param[0]


def _arch(model) -> str:
    return "gemma-7b" if model.cfg.activation == "gelu" else "qwen3-1.7b"


def _prompts(vocab, lens, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (n,)).astype(np.int32) for n in lens]


def _requests(prompts, gen=GEN):
    return [Request(request_id=i, tokens=p, max_new_tokens=gen)
            for i, p in enumerate(prompts)]


def _assert_same(a, b):
    """Tokens and logits bit for bit, request by request."""
    assert [c.request_id for c in a] == [c.request_id for c in b]
    for x, y in zip(a, b):
        assert x.tokens == y.tokens, x.request_id
        if x.logits is not None or y.logits is not None:
            assert torch.equal(x.logits, y.logits), x.request_id


def _whole(model, params, prompts, batch_size=2, gen=GEN, **kw):
    eng = ServingEngine(model, params, max_len=MAX_LEN,
                        batch_size=batch_size, collect_logits=True, **kw)
    return eng.run(_requests(prompts, gen))


# -- prefill_chunk against the reference -------------------------------------

@pytest.mark.parametrize("arch, dtype", [("qwen3-1.7b", "bf16"),
                                         ("qwen3-1.7b", "float32"),
                                         ("gemma-7b", "float32")])
def test_prefill_chunk_matches_reference(arch, dtype):
    """Three 4-row chunks of a 12-token prompt (bucket 16) resumed into
    each package's own cache: the last chunk's logits and the cache."""
    jmodel, jparams, model, params = _models(arch, dtype)
    toks = np.zeros((1, 16), np.int32)
    toks[0, :12] = _prompts(model.cfg.vocab, [12], seed=4)[0]
    jdefs = jmodel.cache_defs(1, MAX_LEN)
    jcache = jax.tree.map(lambda d: jnp.zeros(d.shape, d.dtype), jdefs,
                          is_leaf=lambda d: hasattr(d, "shape"))
    cache = {g: {n: torch.zeros(d.shape, dtype=d.dtype) for n, d in kv.items()}
             for g, kv in model.cache_defs(1, MAX_LEN).items()}
    chunk = jax.jit(jmodel.prefill_chunk, static_argnames=("kv_len",))
    for start in (0, 4, 8):            # the prompt's last token: row 3
        jl, jcache = chunk(jparams, jnp.asarray(toks[:, start:start + 4]),
                           jcache, jnp.int32(start), kv_len=16,
                           last_idx=jnp.int32(3))
        with torch.inference_mode():
            logits, cache = model.prefill_chunk(
                params, torch.from_numpy(toks[:, start:start + 4]), cache,
                start, kv_len=16, last_idx=3)
    tol = (dict(rtol=0, atol=1e-4) if dtype == "float32"
           else dict(rtol=2 ** -7, atol=0.05))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl),
                               **dict(tol, rtol=0))
    for g in cache:
        for n in ("k", "v"):
            np.testing.assert_allclose(
                cache[g][n].float().numpy(),
                np.asarray(jcache[g][n], np.float32), **tol)


def test_prefill_chunk_rows_equal_whole_prefill(smoke):
    """Within the port: the chunks' cache rows and the last row's logits
    equal one whole-bucket prefill's, bit for bit."""
    _, _, model, params = smoke
    p = _prompts(model.cfg.vocab, [11], seed=5)[0]
    toks = torch.zeros((1, 16), dtype=torch.int32)
    toks[0, :11] = torch.from_numpy(p)
    cache = {g: {n: torch.zeros(d.shape, dtype=d.dtype) for n, d in kv.items()}
             for g, kv in model.cache_defs(1, MAX_LEN).items()}
    with torch.inference_mode():
        want, wcache = model.prefill(params, toks, max_len=MAX_LEN,
                                     last_idx=10)
        for start in (0, 4, 8, 12):
            got, cache = model.prefill_chunk(
                params, toks[:, start:start + 4], cache, start, kv_len=16,
                last_idx=2 if start == 8 else None)
            if start == 8:
                assert torch.equal(got, want)
    for g in cache:
        for n in cache[g]:
            assert torch.equal(cache[g][n], wcache[g][n])


# -- chunked + cached == whole, bit for bit -----------------------------------

def test_chunked_cached_equals_whole_raw(smoke):
    _, _, model, params = smoke
    prompts = _prompts(model.cfg.vocab, [5, 8, 11, 4, 16, 9, 3])
    eng = ServingEngine(model, params, max_len=MAX_LEN, batch_size=3,
                        collect_logits=True, chunk_prefill=4,
                        prefix_cache=True)
    _assert_same(_whole(model, params, prompts, batch_size=3),
                 eng.run(_requests(prompts)))
    rep = eng.scheduler_report()
    assert rep["prefill_chunks"] > 0 and rep["prefix_cache"]["inserts"] > 0
    assert rep["chunk_traces"] == 3            # (4, 8), (4, 16), (4, 4)


@pytest.fixture(scope="module")
def packs(smoke, tmp_path_factory):
    """A placed and a logical pack of the smoke model (the port's own
    calibration of a small grid)."""
    _, _, model, params = smoke
    out = {}
    for placement in (True, False):
        s = PUDSession.open(_arch(model), grid=FleetConfig(**GRID),
                            calib=CalibrationConfig(n_iterations=4,
                                                    n_samples=64),
                            seed=7, n_trials_ecr=128, placement=placement,
                            device="cpu")
        s.calibrate()
        out[placement] = (s, s.pack(params, PUDGemvConfig(weight_bits=4)))
    assert out[True][1].placed and not out[False][1].placed
    return out


@pytest.mark.parametrize("placed", [True, False])
def test_chunked_cached_equals_whole_packed(smoke, packs, placed):
    _, _, model, _ = smoke
    session, packed = packs[placed]
    prompts = _prompts(model.cfg.vocab, [4, 9, 6, 13], seed=2)
    eng = session.serving_engine(model, max_len=MAX_LEN, batch_size=2,
                                 collect_logits=True, chunk_prefill=4,
                                 prefix_cache=True)
    _assert_same(_whole(model, packed.params, prompts),
                 eng.run(_requests(prompts)))


def test_chunk_larger_than_prompt_equals_whole(smoke):
    _, _, model, params = smoke
    prompts = _prompts(model.cfg.vocab, [3, 6], seed=16)
    eng = ServingEngine(model, params, max_len=MAX_LEN, batch_size=2,
                        collect_logits=True, chunk_prefill=MAX_LEN)
    got = eng.run(_requests(prompts))
    assert eng.scheduler_report()["prefill_chunks"] == 2
    _assert_same(_whole(model, params, prompts), got)


# -- prefix cache --------------------------------------------------------------

def test_prefix_full_hit_equals_miss(smoke):
    _, _, model, params = smoke
    [p] = _prompts(model.cfg.vocab, [9])
    eng = ServingEngine(model, params, max_len=MAX_LEN, batch_size=1,
                        collect_logits=True, chunk_prefill=4,
                        prefix_cache=True)
    a = eng.run([Request(0, p, GEN)])
    chunks = eng.scheduler_report()["prefill_chunks"]
    b = [c for c in eng.run([Request(1, p, GEN)]) if c.request_id == 1]
    rep = eng.scheduler_report()
    assert rep["prefix_cache"]["hits"] == 1
    assert rep["prefill_chunks"] == chunks     # no prefill for the repeat
    assert a[0].tokens == b[0].tokens and torch.equal(a[0].logits,
                                                      b[0].logits)


def test_prefix_full_hit_without_chunking(smoke):
    """Whole-prefill engines reuse a repeated prompt too."""
    _, _, model, params = smoke
    [p] = _prompts(model.cfg.vocab, [7], seed=3)
    eng = ServingEngine(model, params, max_len=MAX_LEN, batch_size=1,
                        collect_logits=True, prefix_cache=True)
    a = eng.run([Request(0, p, GEN)])
    tokens = eng.scheduler_report()["prefilled_tokens"]
    b = [c for c in eng.run([Request(1, p, GEN)]) if c.request_id == 1]
    assert eng.scheduler_report()["prefilled_tokens"] == tokens
    assert a[0].tokens == b[0].tokens and torch.equal(a[0].logits,
                                                      b[0].logits)


def test_prefix_partial_hit_resumes_equal_to_whole(smoke):
    """A shared 12-token system prompt: the second request resumes after
    the cached 12 rows and finishes as whole-request prefill does."""
    _, _, model, params = smoke
    rng = np.random.default_rng(5)
    sysp = rng.integers(0, model.cfg.vocab, 12).astype(np.int32)
    pa = np.concatenate([sysp, rng.integers(0, model.cfg.vocab,
                                            7).astype(np.int32)])
    pb = np.concatenate([sysp, rng.integers(0, model.cfg.vocab,
                                            5).astype(np.int32)])
    eng = ServingEngine(model, params, max_len=MAX_LEN, batch_size=1,
                        collect_logits=True, chunk_prefill=4,
                        prefix_cache=True)
    eng.run([Request(0, pa, GEN)])
    tokens = eng.scheduler_report()["prefilled_tokens"]
    assert eng.prefix_probe(pb) == 12
    got = [c for c in eng.run([Request(1, pb, GEN)]) if c.request_id == 1]
    rep = eng.scheduler_report()
    assert rep["prefix_cache"]["hits"] == 1
    assert rep["prefilled_tokens"] - tokens == 8     # 17 - 12, in chunks
    _assert_same(_whole(model, params, [pb], batch_size=1)[:1],
                 [dataclasses.replace(got[0], request_id=0)])


def test_prefix_longer_than_prompt_not_misused(smoke):
    """A cached 12-token prompt serves its 6-token prefix only through the
    chunk-aligned 4-token entry, never its longer rows."""
    _, _, model, params = smoke
    [long_p] = _prompts(model.cfg.vocab, [12], seed=9)
    short_p = long_p[:6]
    eng = ServingEngine(model, params, max_len=MAX_LEN, batch_size=1,
                        collect_logits=True, chunk_prefill=4,
                        prefix_cache=True)
    eng.run([Request(0, long_p, GEN)])
    assert eng.prefix_probe(short_p) == 4
    got = [c for c in eng.run([Request(1, short_p, GEN)])
           if c.request_id == 1]
    assert eng.scheduler_report()["prefix_cache"]["hits"] == 1
    _assert_same(_whole(model, params, [short_p], batch_size=1),
                 [dataclasses.replace(got[0], request_id=0)])


def test_stage_params_invalidates_prefix_cache(smoke):
    _, _, model, params = smoke
    [p] = _prompts(model.cfg.vocab, [8])
    eng = ServingEngine(model, params, max_len=MAX_LEN, batch_size=1,
                        chunk_prefill=4, prefix_cache=True)
    eng.run([Request(0, p, GEN)])
    assert eng.scheduler_report()["prefix_cache"]["entries"] > 0
    eng.stage_params(params)
    assert eng.swap_pending
    eng.run([Request(1, p, GEN)])
    assert not eng.swap_pending
    st = eng.scheduler_report()["prefix_cache"]
    assert st["invalidations"] == 1 and st["invalidated_entries"] > 0
    assert st["hits"] == 0


def test_prefix_cache_lru_eviction_while_serving(smoke):
    _, _, model, params = smoke
    prompts = _prompts(model.cfg.vocab, [6, 9, 12, 7], seed=11)
    eng = ServingEngine(model, params, max_len=MAX_LEN, batch_size=2,
                        collect_logits=True, chunk_prefill=4,
                        prefix_cache=PrefixCache(capacity=2))
    got = eng.run(_requests(prompts))
    st = eng.scheduler_report()["prefix_cache"]
    assert st["evictions"] > 0 and st["entries"] <= 2
    _assert_same(_whole(model, params, prompts), got)


def test_entries_are_trimmed_copies(smoke):
    """Stored caches hold exactly their tokens' rows, in storage of their
    own, and count their bytes."""
    _, _, model, params = smoke
    [p] = _prompts(model.cfg.vocab, [10], seed=12)
    pc = PrefixCache()
    eng = ServingEngine(model, params, max_len=MAX_LEN, batch_size=1,
                        chunk_prefill=4, prefix_cache=pc)
    eng.run([Request(0, p, GEN)])
    assert sorted(e.n_tokens for e in pc._entries.values()) == [4, 8, 10]
    total = 0
    for e in pc._entries.values():
        for kv in e.cache.values():
            for c in kv.values():
                assert c.shape[2] == e.n_tokens
                assert c.untyped_storage().nbytes() == c.numel() * \
                    c.element_size()
                total += c.numel() * c.element_size()
    assert pc.stats()["bytes"] == total


# -- scheduler edge cases ------------------------------------------------------

def test_zero_budget_holds_then_completes(smoke):
    _, _, model, params = smoke
    [p] = _prompts(model.cfg.vocab, [10], seed=15)
    eng = ServingEngine(model, params, max_len=MAX_LEN, batch_size=1,
                        collect_logits=True, chunk_prefill=4,
                        prefill_budget=0)
    eng.submit(Request(0, p, GEN))
    eng.step()
    st = eng._slots[0]
    assert st is not None and st.phase == "prefill" and st.pf.pos == 0
    with pytest.raises(RuntimeError, match="stalled"):
        eng.run()
    eng.prefill_budget = None
    _assert_same(_whole(model, params, [p], batch_size=1), eng.run())


def test_shed_while_prefilling_survivor_equals_whole(smoke):
    """Shedding a slot mid-prefill drops its private cache; the other
    request finishes as whole-request prefill gives it.  (The reference's
    test of this compares against a batch-1 cold engine and fails there.)"""
    _, _, model, params = smoke
    prompts = _prompts(model.cfg.vocab, [16, 6], seed=13)
    eng = ServingEngine(model, params, max_len=MAX_LEN, batch_size=2,
                        collect_logits=True, chunk_prefill=4,
                        prefix_cache=True)
    eng.submit_all(_requests(prompts))
    eng.step()
    assert eng._slots[0].phase == "prefill"
    assert eng.shed_request(0)
    comps = eng.run()
    shed = comps[0]
    assert shed.shed and shed.slo_met is False and shed.tokens == []
    whole = _whole(model, params, prompts)
    _assert_same(whole[1:], comps[1:])
    alone = _whole(model, params, prompts[1:], batch_size=1)
    assert alone[0].tokens == comps[1].tokens
    assert torch.equal(alone[0].logits, comps[1].logits)


def test_shed_queued_request(smoke):
    _, _, model, params = smoke
    prompts = _prompts(model.cfg.vocab, [6, 6], seed=14)
    eng = ServingEngine(model, params, max_len=MAX_LEN, batch_size=1,
                        chunk_prefill=4)
    eng.submit_all(_requests(prompts))
    assert eng.shed_request(1) and not eng.shed_request(99)
    comps = eng.run()
    assert [c.request_id for c in comps] == [0, 1]
    assert comps[1].shed and comps[1].tokens == []
    assert len(comps[0].tokens) == GEN


def test_chunk_prefill_needs_exact_padded_prefill(smoke):
    _, _, model, params = smoke

    class ExactOnly(type(model)):
        supports_chunked_prefill = False

    with pytest.raises(ValueError, match="sequence-global"):
        ServingEngine(ExactOnly(model.cfg), params, max_len=MAX_LEN,
                      chunk_prefill=4)


# -- the engine against the reference's ---------------------------------------

def _run_both(models, prompts, budgets, deadlines=None, batch_size=2,
              jsession=None, session=None, packed=None, **kw):
    jmodel, jparams, model, params = models
    if packed is not None:
        jparams, params = packed
    jkw = dict(kw)
    if isinstance(kw.get("slo"), SLOConfig):
        jkw["slo"] = JSLO(**dataclasses.asdict(kw["slo"]))
    deadlines = deadlines or [None] * len(prompts)
    jeng = JEngine(jmodel, jparams, session=jsession, max_len=MAX_LEN,
                   batch_size=batch_size, collect_logits=True, **jkw)
    jcomps = jeng.run([JRequest(i, jnp.asarray(p), g, deadline_ms=d)
                       for i, (p, g, d) in enumerate(zip(prompts, budgets,
                                                         deadlines))])
    eng = ServingEngine(model, params, session=session, max_len=MAX_LEN,
                        batch_size=batch_size, collect_logits=True, **kw)
    comps = eng.run([Request(i, p, g, deadline_ms=d)
                     for i, (p, g, d) in enumerate(zip(prompts, budgets,
                                                       deadlines))])
    assert len(comps) == len(jcomps) == len(prompts)
    for c, jc in zip(comps, jcomps):
        assert c.request_id == jc.request_id
        assert c.tokens == list(jc.tokens), c.request_id
        assert (c.slot, c.admitted_step, c.finished_step, c.slo_met,
                c.shed) == (jc.slot, jc.admitted_step, jc.finished_step,
                            jc.slo_met, jc.shed), c.request_id
        if jc.logits is not None:
            np.testing.assert_allclose(
                c.logits.numpy(), jc.logits, rtol=0,
                atol=ATOL_PACKED if packed is not None else 1e-4)
    rep, jrep = eng.scheduler_report(), jeng.scheduler_report()
    for key in ("steps", "completed", "generated_tokens", "slot_occupancy",
                "prefill_chunks", "prefilled_tokens", "chunk_traces",
                "prefix_cache", "slo"):
        assert rep.get(key) == jrep.get(key), key
    return eng, jeng


def test_engine_with_chunks_and_cache_matches_reference(pair):
    """Ragged prompts, two of them sharing an 8-token system prompt and one
    repeated: the same tokens, schedule and counters as the reference."""
    smoke, _ = pair
    _, _, model, _ = smoke
    rng = np.random.default_rng(21)
    sysp = rng.integers(0, model.cfg.vocab, 8).astype(np.int32)
    prompts = _prompts(model.cfg.vocab, [5, 11, 3], seed=20)
    prompts += [np.concatenate([sysp, p]) for p in
                _prompts(model.cfg.vocab, [6, 3], seed=22)]
    prompts += [prompts[1].copy(), prompts[3].copy()]
    budgets = [4, 2, 5, 3, 4, 3, 2]
    eng, _ = _run_both(smoke, prompts, budgets, chunk_prefill=4,
                       prefix_cache=True)
    pc = eng.scheduler_report()["prefix_cache"]
    assert pc["hits"] >= 2


def test_slo_decisions_match_reference(pair):
    """Deadlines tight and loose on a modeled 10 ms step: the same EDF
    admission order, the same shed at admission and in flight, the same
    ``slo_met`` flags and counts."""
    smoke, _ = pair
    _, _, model, _ = smoke
    prompts = _prompts(model.cfg.vocab, [6, 8, 4, 9, 5, 7], seed=17)
    budgets = [4, 4, 3, 6, 2, 5]
    deadlines = [1000.0, 0.5, 60.0, 55.0, None, 30.0]
    for slo in (SLOConfig(step_time_ms=10.0),
                SLOConfig(step_time_ms=10.0, shed_on_admit=False),
                SLOConfig(step_time_ms=10.0, default_deadline_ms=80.0)):
        for kw in ({}, {"chunk_prefill": 4}):
            eng, _ = _run_both(smoke, prompts, budgets, deadlines, slo=slo,
                               **kw)
            rep = eng.scheduler_report()["slo"]
            assert rep["step_ms"] == 10.0
            assert rep["met"] > 0 and rep["missed"] > 0


def test_slo_edf_admission_order(smoke):
    _, _, model, params = smoke
    prompts = _prompts(model.cfg.vocab, [4, 4, 4], seed=19)
    eng = ServingEngine(model, params, max_len=MAX_LEN, batch_size=1,
                        slo=SLOConfig(step_time_ms=1.0))
    eng.submit(Request(0, prompts[0], GEN, deadline_ms=10_000.0))
    eng.submit(Request(1, prompts[1], GEN, deadline_ms=10_000.0))
    eng.submit(Request(2, prompts[2], GEN, deadline_ms=50.0))
    by_id = {c.request_id: c for c in eng.run()}
    assert by_id[2].admitted_step <= by_id[1].admitted_step
    assert not any(c.shed for c in by_id.values())


def test_slo_step_time_from_the_session_matches_reference(pair, tmp_path):
    """Without an override the virtual clock's step is the placement rate
    model's ``step_seconds`` at the engine's batch, as in the reference;
    with a deadline of a few steps the same requests are shed."""
    smoke, arch = pair
    jmodel, jparams, model, params = smoke
    js = JSession.open(arch, grid=JFleet(**GRID), cache_dir=tmp_path,
                       calib=JCal(n_iterations=4, n_samples=64), key=7,
                       n_trials_ecr=128, backend="reference")
    js.calibrate()
    jpacked = js.pack(jparams, JGemvCfg(weight_bits=4), name="slo")
    s = PUDSession.open(arch, grid=FleetConfig(**GRID), cache_dir=tmp_path,
                        calib=CalibrationConfig(n_iterations=4,
                                                n_samples=64),
                        seed=7, n_trials_ecr=128, device="cpu")
    assert s.calibrate().cache_hit
    packed = s.pack(params, PUDGemvConfig(weight_bits=4), name="slo")
    assert s.placement_status == "hit"
    probe = ServingEngine(model, packed.params, session=s, max_len=MAX_LEN,
                          batch_size=2, slo=SLOConfig())
    step = probe.scheduler_report()["slo"]["step_ms"]
    assert step == pytest.approx(
        s.placement_perf_model().step_seconds(s.flops_per_token(), 2) * 1e3,
        rel=1e-12)
    prompts = _prompts(model.cfg.vocab, [6, 9, 4, 7], seed=23)
    eng, jeng = _run_both(
        smoke, prompts, [4, 3, 4, 2], [6 * step, 2 * step, 9 * step, None],
        jsession=js, session=s, packed=(jpacked.params, packed.params),
        slo=SLOConfig(), chunk_prefill=4)
    assert eng.scheduler_report()["slo"]["step_ms"] == \
        jeng.scheduler_report()["slo"]["step_ms"]
