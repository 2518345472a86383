"""Parity of the port's continuous-batching ``ServingEngine``, per-slot
decode, rate models and the ``--no-placement --engine`` serve path with the
JAX package, on the qwen3-1.7b smoke model (2 layers, d 64, vocab 256).

Weights come from the reference's ``init_params`` and cross over with
``from_numpy``; the reference calibrates a small grid and persists its table,
which the port's session reads (a HIT), and both pack onto logical columns
(``placement=False``) from the same weights.

Tolerances: the packs, the integer GEMMs, the scheduling counters and the
greedy tokens are held exactly equal across the packages.  Logits are held
with the bf16 tolerance of ``test_torch_serve.py`` on the packed path (atol
0.1): XLA keeps float32 excess precision inside fused CPU kernels, PyTorch
rounds every bf16 op.  Within the port, the engine equals lockstep decode
bit for bit (tokens and logits) and the rate models equal the reference's
to rel 1e-9 (the same float64 arithmetic).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get as j_get  # noqa: E402
from repro.core.calibrate import CalibrationConfig as JCal  # noqa: E402
from repro.core.fleet import FleetConfig as JFleet  # noqa: E402
from repro.models.params import init_params as j_init  # noqa: E402
from repro.pud.gemv import FleetPerfModel as JFleetPerf  # noqa: E402
from repro.pud.gemv import PUDGemvConfig as JGemvCfg  # noqa: E402
from repro.pud.gemv import PUDPerfModel as JPerf  # noqa: E402
from repro.runtime.engine import Request as JRequest  # noqa: E402
from repro.runtime.engine import ServingEngine as JEngine  # noqa: E402
from repro.runtime.session import PUDSession as JSession  # noqa: E402
from repro_torch.configs import get  # noqa: E402
from repro_torch.core.calibrate import CalibrationConfig  # noqa: E402
from repro_torch.core.fleet import FleetConfig  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.serve import greedy_generate  # noqa: E402
from repro_torch.models.params import from_numpy  # noqa: E402
from repro_torch.pud.gemv import FleetPerfModel, PUDGemvConfig, PUDPerfModel  # noqa: E402,E501
from repro_torch.runtime.engine import Request, ServingEngine  # noqa: E402
from repro_torch.runtime.session import PUDSession  # noqa: E402

ARCH = "qwen3-1.7b"
MAX_LEN, GEN, PROMPT = 16, 4, 8
ATOL_PACKED = 0.1
GRID = dict(n_channels=1, n_banks=1, n_subarrays=8, n_cols=1024)
LENS, BUDGETS = [4, 8, 6, 10, 3], [4, 2, 5, 3, 4]


@pytest.fixture(scope="module")
def smoke():
    jmodel = j_get(ARCH).make_smoke()
    jparams = j_init(jmodel.param_defs(), jax.random.key(0))
    params = from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jmodel, jparams, get(ARCH).make_smoke(), params


def _sessions(cache_dir, placement):
    js = JSession.open(ARCH, grid=JFleet(**GRID), cache_dir=cache_dir,
                       calib=JCal(n_iterations=4, n_samples=64), key=7,
                       n_trials_ecr=128, backend="reference",
                       placement=placement)
    js.calibrate()
    s = PUDSession.open(ARCH, grid=FleetConfig(**GRID), cache_dir=cache_dir,
                        calib=CalibrationConfig(n_iterations=4,
                                                n_samples=64),
                        seed=7, n_trials_ecr=128, placement=placement,
                        device="cpu")
    assert s.calibrate().cache_hit
    return js, s


@pytest.fixture(scope="module")
def unplaced(smoke, tmp_path_factory):
    jmodel, jparams, model, params = smoke
    js, s = _sessions(tmp_path_factory.mktemp("calib"), placement=False)
    jpacked = js.pack(jparams, JGemvCfg(weight_bits=4), name="eng")
    packed = s.pack(params, PUDGemvConfig(weight_bits=4), name="eng")
    return js, jpacked, s, packed


def _prompts(lens=LENS, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (n,)).astype(np.int32) for n in lens]


def test_unplaced_packs_match_reference(unplaced):
    js, jpacked, s, packed = unplaced
    assert js.placement_status is None and s.placement_status is None
    assert not jpacked.placed and not packed.placed
    assert sorted(packed.tensors) == sorted(jpacked.tensors)
    for name, pt in packed.tensors.items():
        jpt = jpacked.tensor(name)
        assert pt.col_ids is None and jpt.col_ids is None
        assert pt.layout == jpt.layout == "bitpack8"
        assert pt.logical_k == jpt.logical_k
        np.testing.assert_array_equal(pt.planes.numpy(),
                                      np.asarray(jpt.planes))
        np.testing.assert_array_equal(pt.scale.numpy(),
                                      np.asarray(jpt.scale))


def test_engine_matches_reference_engine(smoke, unplaced):
    """Ragged prompts and budgets on 2 slots: the same tokens, the same
    schedule, logits within the bf16 tolerance."""
    jmodel, _, model, _ = smoke
    js, jpacked, s, packed = unplaced
    prompts = _prompts()
    jeng = JEngine(jmodel, jpacked.params, session=js, max_len=MAX_LEN,
                   batch_size=2, collect_logits=True)
    jcomps = jeng.run([JRequest(i, jnp.asarray(p), g)
                       for i, (p, g) in enumerate(zip(prompts, BUDGETS))])
    eng = s.serving_engine(model, max_len=MAX_LEN, batch_size=2,
                           collect_logits=True)
    comps = eng.run([Request(i, p, g)
                     for i, (p, g) in enumerate(zip(prompts, BUDGETS))])
    assert len(comps) == len(jcomps) == len(prompts)
    for c, jc in zip(comps, jcomps):
        assert c.request_id == jc.request_id
        assert c.tokens == list(jc.tokens), c.request_id
        assert (c.slot, c.admitted_step, c.finished_step) == (
            jc.slot, jc.admitted_step, jc.finished_step)
        np.testing.assert_allclose(c.logits.numpy(), jc.logits, rtol=0,
                                   atol=ATOL_PACKED)
    rep, jrep = eng.scheduler_report(), jeng.scheduler_report()
    for key in ("batch_size", "steps", "completed", "generated_tokens",
                "slot_occupancy", "prefill_traces", "prefilled_tokens"):
        assert rep[key] == jrep[key], key


@pytest.mark.parametrize("tree", ["bf16", "packed"])
def test_engine_equals_lockstep_ragged(smoke, unplaced, tree):
    """Each request's engine tokens and logits equal its lockstep decode
    alone, bit for bit, with ragged prompts on 3 slots."""
    _, _, model, params = smoke
    serving = params if tree == "bf16" else unplaced[3].params
    prompts = _prompts(LENS + [12, 5], seed=2)
    eng = ServingEngine(model, serving, max_len=MAX_LEN, batch_size=3,
                        collect_logits=True)
    comps = eng.run([Request(i, p, GEN) for i, p in enumerate(prompts)])
    for c in comps:
        toks, logits = greedy_generate(
            model, serving, torch.from_numpy(prompts[c.request_id])[None],
            GEN, MAX_LEN)
        assert c.tokens == toks[0].tolist(), c.request_id
        assert torch.equal(c.logits, logits[0, :GEN]), c.request_id


def test_exact_length_prefill_without_padded_prefill(smoke):
    """A model that does not declare exact padded prefill is prefilled at
    each prompt's own length (one shape per distinct length)."""
    _, _, model, params = smoke

    class ExactOnly(type(model)):
        supports_chunked_prefill = False

    prompts = _prompts([4, 8, 6, 6])
    eng = ServingEngine(ExactOnly(model.cfg), params, max_len=MAX_LEN,
                        batch_size=2)
    comps = eng.run([Request(i, p, GEN) for i, p in enumerate(prompts)])
    rep = eng.scheduler_report()
    assert rep["prefill_traces"] == 3 and rep["prefilled_tokens"] == 24
    for c in comps:
        toks, _ = greedy_generate(
            model, params, torch.from_numpy(prompts[c.request_id])[None],
            GEN, MAX_LEN)
        assert c.tokens == toks[0].tolist()


def _prefilled(model, params, n=3):
    toks = torch.from_numpy(np.stack(_prompts([PROMPT] * n, seed=3)))
    with torch.inference_mode():
        logits, cache = model.prefill(params, toks, max_len=MAX_LEN)
    nxt = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
    return cache, nxt


def _clone(cache):
    return {g: {k: v.clone() for k, v in kv.items()}
            for g, kv in cache.items()}


def test_vector_cur_len_matches_scalar(smoke):
    _, _, model, params = smoke
    cache, nxt = _prefilled(model, params)
    with torch.inference_mode():
        l_s, c_s = model.decode_step(params, _clone(cache), nxt, PROMPT)
        l_v, c_v = model.decode_step(params, _clone(cache), nxt,
                                     torch.full((3,), PROMPT,
                                                dtype=torch.int32))
    assert torch.equal(l_s, l_v)
    for g in c_s:
        for k in c_s[g]:
            assert torch.equal(c_s[g][k], c_v[g][k])


def test_staggered_rows_independent(smoke):
    """A row at its own position gets exactly what it gets alone; a row
    already at the cache length writes nothing and disturbs no other row."""
    _, _, model, params = smoke
    cache, nxt = _prefilled(model, params)
    lens = torch.tensor([PROMPT, PROMPT + 1, MAX_LEN])
    with torch.inference_mode():
        before = _clone(cache)
        l_g, c_g = model.decode_step(params, _clone(cache), nxt, lens)
        one = {g: {k: v[:, :1].clone() for k, v in kv.items()}
               for g, kv in cache.items()}
        l_1, _ = model.decode_step(params, one, nxt[:1], PROMPT)
    assert torch.equal(l_g[0], l_1[0])
    assert torch.isfinite(l_g).all()
    for g in c_g:
        for k in c_g[g]:
            assert torch.equal(c_g[g][k][:, 2], before[g][k][:, 2])


def test_scheduler_no_slot_leaks_and_fifo(smoke):
    _, _, model, params = smoke
    eng = ServingEngine(model, params, max_len=MAX_LEN, batch_size=3)
    eng.submit_all([Request(i, p, GEN)
                    for i, p in enumerate(_prompts([PROMPT] * 7))])
    assert eng.n_pending == 7 and eng.n_active == 0
    seen_active = []
    while eng.n_pending or eng.n_active:
        eng.step()
        assert eng.n_active <= eng.batch_size
        assert len(eng.free_slots) + eng.n_active == eng.batch_size
        seen_active.append(eng.n_active)
    comps = sorted(eng._completions, key=lambda c: c.request_id)
    assert [c.request_id for c in comps] == list(range(7))
    assert all(len(c.tokens) == GEN for c in comps)
    assert eng.free_slots == [0, 1, 2]
    admits = [c.admitted_step for c in comps]
    assert admits == sorted(admits)
    assert max(seen_active) == 3
    rep = eng.scheduler_report()
    assert rep["completed"] == 7 and rep["generated_tokens"] == 7 * GEN
    # every live slot-step decoded one token; the first comes from prefill
    assert rep["slot_occupancy"] * rep["steps"] * 3 == 7 * (GEN - 1)
    assert 0 < rep["slot_occupancy"] < 1


def test_stage_params_swaps_at_the_next_step(smoke, unplaced):
    """A staged tree (a new tree over the same packs) takes over at the
    top of the next step; tokens are unchanged."""
    _, _, model, _ = smoke
    packed = unplaced[3]
    prompts = _prompts()
    reqs = [Request(i, p, GEN) for i, p in enumerate(prompts)]
    want = ServingEngine(model, packed.params, max_len=MAX_LEN,
                         batch_size=2).run(reqs)
    eng = ServingEngine(model, packed.params, max_len=MAX_LEN, batch_size=2)
    eng.submit_all(reqs)
    eng.step()
    staged = dict(packed.params)
    eng.stage_params(staged)
    assert eng.params is packed.params
    got = eng.run()
    assert eng.params is staged
    rep = eng.scheduler_report()
    assert rep["swaps"] == 1 and rep["swap_steps"] == [1]
    assert [c.tokens for c in got] == [c.tokens for c in want]


def test_engine_rejects_oversized_request(smoke):
    _, _, model, params = smoke
    eng = ServingEngine(model, params, max_len=MAX_LEN, batch_size=2)
    with pytest.raises(ValueError, match="exceeds max_len"):
        eng.submit(Request(0, np.zeros((PROMPT,), np.int32), MAX_LEN))
    with pytest.raises(ValueError, match="batch_size"):
        ServingEngine(model, params, max_len=MAX_LEN, batch_size=0)


def test_perf_models_match_reference():
    ecr = np.random.default_rng(0).uniform(0.01, 0.1, 16).astype(np.float32)
    models = [(JFleetPerf.from_table(jnp.asarray(ecr)),
               FleetPerfModel.from_table(torch.from_numpy(ecr))),
              (JFleetPerf(error_free_fracs=(0.9, 0.95), occupied_subarrays=2,
                          total_subarrays=8),
               FleetPerfModel(error_free_fracs=(0.9, 0.95),
                              occupied_subarrays=2, total_subarrays=8))]
    for jm, m in models:
        assert m.error_free_fracs == jm.error_free_fracs
        assert m.optimal_batch_size() == jm.optimal_batch_size()
        assert m.optimal_batch_size(5) == jm.optimal_batch_size(5)
        for b in range(1, 20):
            assert m.batch_speedup(b) == pytest.approx(
                jm.batch_speedup(b), rel=1e-9)
            assert m.step_seconds(2e9, b) == pytest.approx(
                jm.step_seconds(2e9, b), rel=1e-9)
        assert m.tokens_per_second(2e9) == pytest.approx(
            jm.tokens_per_second(2e9), rel=1e-9)
    p, jp = PUDPerfModel(0.534), JPerf(0.534)
    for fn in ("tokens_per_second", "step_seconds"):
        assert getattr(p, fn)(4.06e9) == pytest.approx(
            getattr(jp, fn)(4.06e9), rel=1e-9)


@pytest.mark.parametrize("placement", [False, True])
def test_session_rates_and_default_batch_match_reference(smoke, tmp_path,
                                                         placement):
    jmodel, jparams, model, params = smoke
    js, s = _sessions(tmp_path, placement)
    js.pack(jparams, JGemvCfg(weight_bits=4), name="rates")
    s.pack(params, PUDGemvConfig(weight_bits=4), name="rates")
    # the reference plans and persists, the port reads its placement
    assert (js.placement_status, s.placement_status) == (
        ("planned", "hit") if placement else (None, None))
    assert s.optimal_batch_size() == js.optimal_batch_size()
    assert s.optimal_batch_size(32) == js.optimal_batch_size(32)
    eng = s.serving_engine(model, max_len=MAX_LEN)
    jeng = js.serving_engine(jmodel, max_len=MAX_LEN)
    assert eng.batch_size == jeng.batch_size
    rep = s.perf_report(batch_size=4)
    jrep = js.perf_report(batch_size=4)
    for key in ("flops_per_token", "baseline_tok_s", "tuned_tok_s", "gain",
                "placed_tok_s", "batch_speedup", "batched_tok_s",
                "optimal_batch", "weight_bytes_per_token",
                "staging_bound_tok_s", "traffic_aware_tok_s"):
        assert (key in rep) == (key in jrep), key
        if key in rep:
            assert rep[key] == pytest.approx(jrep[key], rel=1e-9), key
    assert s.tokens_per_second() == pytest.approx(js.tokens_per_second(),
                                                  rel=1e-9)
    merged = eng.perf_report()
    assert merged["batch_size"] == eng.batch_size and "gain" in merged


def _argv(tmp_path, *extra):
    return ["--preset", "smoke", "--batch", "3", "--prompt-len", "8",
            "--gen", "3", "--pud-gemv", "--calib-cache", str(tmp_path),
            "--device", "cpu", "--engine", *extra]


def test_serve_cli_no_placement_engine(tmp_path, capsys):
    res = serve.run(serve.parse_args(_argv(
        tmp_path, "--no-placement", "--batch-size", "2",
        "--fleet-subarrays", "8", "--fleet-cols", "512")))
    assert res["session"].placement_status is None
    assert not res["packed"].placed
    assert len(res["completions"]) == 3
    assert all(len(c.tokens) == 3 for c in res["completions"])
    assert res["engine_agreement"] == 1.0
    assert res["sched"]["batch_size"] == 2
    out = capsys.readouterr().out
    assert "MISS (identified + persisted)" in out
    assert "logical columns" in out and "DDR4-PUD batched rate" in out
    assert "100.0% of requests bit-identical" in out


def test_serve_cli_skipped_placement_serves(tmp_path, capsys):
    """A grid too small for the model: placement is skipped and the packs
    serve on logical columns, lockstep and engine alike."""
    res = serve.run(serve.parse_args(_argv(
        tmp_path, "--fleet-subarrays", "1", "--fleet-cols", "256")))
    assert res["session"].placement_status == "skipped"
    assert res["engine_agreement"] == 1.0
    out = capsys.readouterr().out
    assert "placement: SKIPPED (" in out and "logical columns" in out
