"""The port's tracer (``runtime/tracing.py``) on the serving path, on the
CPU: the engine's spans nest per request and per wave, with the right
parents and request ids; with no profiler recording a span enters no
profiler annotation, records no CUDA event and dispatches no operation;
under a CPU ``torch.profiler`` each span's event lies within 1 ms of the
program's stamps; the bounded buffer drops its oldest spans and leaves a
gap in the sequence numbers; threads lose no count and no span; the MoE
drop counter equals a recount from the router's scores; a fleet's report
carries the counters once."""
import collections

import pytest

torch = pytest.importorskip("torch")

import _torch_cpu  # noqa: E402,F401  (one intra-op thread)

from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro_torch.configs import get  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.params import init_params  # noqa: E402
from repro_torch.runtime import tracing  # noqa: E402
from repro_torch.runtime.engine import Request, ServingEngine  # noqa: E402

MAX_LEN = 24
LENS, BUDGETS = [4, 8, 6, 10, 3], [4, 2, 5, 3, 4]
NESTED = ("engine.admit", "model.prefill", "engine.first_token",
          "engine.decode", "model.decode_step")


def _engine(arch="qwen3-1.7b", batch=2):
    model = get(arch).make_smoke()
    params = init_params(model.param_defs(), 0, "cpu")
    return ServingEngine(model, params, max_len=MAX_LEN, batch_size=batch)


def _requests(base, vocab=200):
    gen = torch.Generator().manual_seed(base)
    return [Request(base + i, torch.randint(0, vocab, (s,), generator=gen),
                    g) for i, (s, g) in enumerate(zip(LENS, BUDGETS))]


def _spans_since(lo):
    hi = tracing.next_seq()
    got = [s for s in tracing.spans() if lo <= s.seq < hi]
    assert [s.seq for s in got] == list(range(lo, hi))   # none lost or open
    return got


def test_engine_spans_nest_per_request_and_per_wave():
    eng = _engine()
    reqs = _requests(1000)
    lo = tracing.next_seq()
    comps = {c.request_id: c for c in eng.run(reqs)}
    rep = eng.scheduler_report()
    spans = _spans_since(lo)
    assert rep["counters"]["seq"] == tracing.next_seq()
    by_seq = {s.seq: s for s in spans}
    kids = collections.defaultdict(list)
    for s in spans:
        kids[s.parent].append(s)
    of = collections.defaultdict(list)
    for s in spans:
        of[s.name].append(s)

    waves = of["engine.decode"]
    assert [w.step for w in waves] == list(range(rep["steps"]))
    for w in waves:
        assert w.parent is None
        assert [k.name for k in kids[w.seq]] == ["model.decode_step"]
        assert 1 <= w.attrs["rows"] <= eng.batch_size
        assert all(w.start_ns <= k.start_ns <= k.end_ns <= w.end_ns
                   and k.step == w.step for k in kids[w.seq])
    # one clock for the wave: the report's decode wall and the watchdog's
    # baseline (an EMA of the step times, no straggler at this size) both
    # take the spans' durations
    dts = [(w.end_ns - w.start_ns) * 1e-9 for w in waves]
    assert rep["decode_wall_s"] == pytest.approx(sum(dts), rel=1e-12)
    wd = eng.watchdog
    if not wd.stragglers:
        ema = dts[0]
        for dt in dts[1:]:
            ema = (1 - wd.ema_alpha) * ema + wd.ema_alpha * dt
        assert wd.ema_s == pytest.approx(ema, rel=1e-12)

    ids = sorted(r.request_id for r in reqs)
    queues = {q.request: q for q in of["engine.queue"]}
    admits = {a.request: a for a in of["engine.admit"]}
    assert sorted(queues) == sorted(admits) == ids
    assert len(of["engine.queue"]) == len(of["engine.admit"]) == len(ids)
    for rid in ids:
        q, a = queues[rid], admits[rid]
        assert q.parent is None and not q.attrs
        assert q.end_ns <= a.start_ns
        assert a.parent is None
        assert a.step == comps[rid].admitted_step
        children = kids[a.seq]
        assert [k.name for k in children] == ["model.prefill",
                                              "engine.first_token"]
        assert all(k.request == rid and k.step == a.step for k in children)
    for name in ("model.prefill", "engine.first_token"):
        assert all(by_seq[s.parent].name == "engine.admit" for s in of[name])


def test_shed_requests_close_their_queue_span():
    eng = _engine(batch=1)
    reqs = _requests(2000)[:3]
    lo = tracing.next_seq()
    eng.submit_all(reqs)
    eng.step()                               # admits the first
    assert eng.shed_request(reqs[2].request_id)
    eng.run()
    queues = [s for s in _spans_since(lo) if s.name == "engine.queue"]
    assert sorted((q.request, q.attrs.get("shed", False)) for q in queues) \
        == [(2000, False), (2001, False), (2002, True)]


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.seen.append(str(func))
        return func(*args, **(kwargs or {}))


def test_no_profiler_means_no_annotation_event_or_op(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("entered while no profiler records")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse,
                        raising=False)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    assert not tracing.recording()
    with _Ops() as ops:
        with tracing.span("outer", request=3, step=1):
            with tracing.span("inner", rows=2):
                pass
        q = tracing.span("queued", request=4, detached=True).start()
        q.stop(shed=True)
        tracing.count("test.calls", key=("gemm_placed", 2, 64, 64))
        tracing.count("test.total", 5)
    assert ops.seen == []
    # and an engine run end to end under the same patches
    assert len(_engine().run(_requests(3000))) == len(LENS)


def test_profiler_events_match_the_program_stamps():
    eng = _engine()
    lo = tracing.next_seq()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        eng.run(_requests(4000))
    ours = collections.defaultdict(list)
    for s in _spans_since(lo):
        if s.name in NESTED:
            ours[s.name].append((s.start_ns, s.end_ns))
    theirs = collections.defaultdict(list)
    for e in prof.profiler.kineto_results.events():
        if e.name() in NESTED:
            theirs[e.name()].append((e.start_ns(), e.end_ns()))
    assert set(ours) == set(NESTED)
    for name in NESTED:
        a, b = sorted(ours[name]), sorted(theirs[name])
        assert len(a) == len(b), name
        worst = max(max(abs(x[0] - y[0]), abs(x[1] - y[1]))
                    for x, y in zip(a, b))
        assert worst < 1_000_000, (name, worst)


def test_bounded_buffer_drops_the_oldest_and_leaves_a_gap(monkeypatch):
    monkeypatch.setattr(tracing, "_buffer", collections.deque(maxlen=4))
    lo = tracing.next_seq()
    for i in range(6):
        with tracing.span(f"s{i}"):
            pass
    hi = tracing.next_seq()
    got = [s.seq for s in tracing.spans()]
    assert got == list(range(lo + 2, hi))
    assert [s.name for s in tracing.spans()] == ["s2", "s3", "s4", "s5"]
    # a reader of [lo, hi) finds seq lo and lo + 1 missing
    assert sorted(set(range(lo, hi)) - set(got)) == [lo, lo + 1]


def test_counts_and_spans_from_many_threads_lose_nothing():
    """Threads (more than cores) count and open spans at once, with the
    interpreter switching threads as often as it can: every count and
    every sequence number arrives exactly once."""
    import os
    import sys
    import threading
    workers, each = 2 * (os.cpu_count() or 4), 400
    key = ("gemm_placed", 3, 5, 7)
    before = tracing.counters().get("test.threads", {}).get(key, 0)
    lo = tracing.next_seq()

    def work():
        for _ in range(each):
            tracing.count("test.threads", key=key)
            with tracing.span("test.thread"):
                pass
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(workers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    total = workers * each
    assert tracing.counters()["test.threads"][key] - before == total
    assert tracing.next_seq() - lo == total
    got = [s.seq for s in tracing.spans() if s.seq >= lo]
    assert sorted(got) == list(range(lo, lo + total))


def _recount(router, cfg, x):
    """Routed (token, expert) pairs and those past each expert's capacity,
    from the router's scores alone."""
    probs = torch.softmax(x.to(cfg.router_dtype)
                          @ router.to(cfg.router_dtype), dim=-1)
    top = torch.sort(probs, dim=-1, descending=True, stable=True).indices
    per_expert = torch.bincount(top[:, :cfg.top_k].reshape(-1),
                                minlength=cfg.n_experts)
    cap = moe._capacity(cfg, x.shape[0])
    return (int(per_expert.sum()),
            int(torch.clamp(per_expert - cap, min=0).sum()))


def test_moe_drop_counter_equals_a_recount(monkeypatch):
    eng = _engine("deepseek-v2-lite-16b", batch=4)
    seen = []
    group = moe._group

    def grab(p, cfg, x):
        seen.append((p["router"], cfg, x.clone()))
        return group(p, cfg, x)
    monkeypatch.setattr(moe, "_group", grab)
    eng.submit_all(_requests(5000)[:4])
    c0 = tracing.counters()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        eng.step()                         # four prefills and one wave
    c1 = tracing.counters()
    routed = sum(_recount(*g)[0] for g in seen)
    dropped = sum(_recount(*g)[1] for g in seen)
    assert len(seen) > 4 and dropped > 0

    def new(c, name):                      # by step, since c0
        return {k: v - c0.get(name, {}).get(k, 0)
                for k, v in c[name].items()
                if v != c0.get(name, {}).get(k, 0)}
    # the prefills and the wave ran in engine step 0: keyed by it
    assert new(c1, "moe.routed") == {0: routed}
    assert new(c1, "moe.dropped") == {0: dropped}
    # with no profiler recording nothing is counted
    eng.step()
    c2 = tracing.counters()
    assert (c2["moe.routed"], c2["moe.dropped"]) == \
        (c1["moe.routed"], c1["moe.dropped"])


def test_fleet_report_carries_the_counters_once():
    from repro_torch.runtime.engine import FleetServingEngine
    model = get("qwen3-1.7b").make_smoke()
    params = init_params(model.param_defs(), 0, "cpu")
    fleet = FleetServingEngine(model, [params, params], max_len=MAX_LEN,
                               batch_size=2)
    fleet.run(_requests(6000))
    rep = fleet.scheduler_report()
    assert rep["counters"]["seq"] == tracing.next_seq()
    assert all("counters" not in lane for lane in rep["lanes"])


def test_device_counts_outside_a_step_keep_their_counter_keyed():
    """A routed group outside any engine span (a model called alone under
    a profiler) counts under the key None, beside the steps' keys."""
    name = "test.device_keys"
    tracing.count_device(name, torch.tensor(3), key=None)
    with tracing.span("outer", step=5):
        tracing.count_device(name, torch.tensor(4),
                             key=tracing.current_step())
    tracing.count_device(name, torch.tensor(2), key=None)
    assert tracing.current_step() is None
    assert tracing.counters()[name] == {None: 5, 5: 4}
