"""The readers of the program's own spans and counters
(``harness/program.py``, the ``engine.queue_wait_ms`` ...
``engine.first_token_wait_ms`` metrics) on synthetic spans and counters,
and on a smoke-size run of each cell on the CPU: the placed-call counter
over the window equals the reckoning ``placed_gemm_roofline`` makes
(every pack's layers once per decode wave and once per prefill), and the
idle shares read nothing without CUDA intervals."""
import collections
import copy
import time

import pytest

from pudbench.harness import cell, program, spec
from pudbench.harness.loop import Window
from pudbench.harness.trace import Trace
from repro_torch.runtime import tracing

from ._smoke import OVERRIDES

MS = 1_000_000          # ns
T0 = 1_000 * 10**9      # a clock far from any real span's


def _span(name, seq, start_ms, end_ms, request=None, parent=None, step=0):
    return tracing.Span(name, seq, parent, request, step, T0 + start_ms * MS,
                        T0 + end_ms * MS, {})


def _spans(lo):
    """Two steps, seq lo .. lo + 10: request 7 queued before the window
    (its engine.queue has seq lo - 1), request 8 within it."""
    return [
        _span("engine.queue", lo - 1, -30, 2, request=7),
        _span("engine.admit", lo, 2, 52, request=7),
        _span("model.prefill", lo + 1, 3, 10, request=7, parent=lo),
        _span("engine.first_token", lo + 2, 11, 50, request=7, parent=lo),
        _span("engine.decode", lo + 3, 60, 100),
        _span("model.decode_step", lo + 4, 60, 90, parent=lo + 3),
        _span("engine.queue", lo + 5, 101, 110, request=8, step=1),
        _span("engine.admit", lo + 6, 110, 140, request=8, step=1),
        _span("model.prefill", lo + 7, 111, 130, request=8, parent=lo + 6,
              step=1),
        _span("engine.first_token", lo + 8, 131, 139, request=8,
              parent=lo + 6, step=1),
        _span("engine.decode", lo + 9, 150, 200, step=1),
        _span("model.decode_step", lo + 10, 150, 170, parent=lo + 9,
              step=1),
    ]


LO = 50
HI = LO + 11


def _counters(seq, calls, **more):
    return {"placed.calls": {("gemm_placed", 4, 64, 64): calls}, "seq": seq,
            **more}


def _run(trace=None, report0=None, report1=None):
    w = Window(t0=0.0, t1=0.2, steps=[], ttft=[], itl=[], tokens=10,
               admitted=2,
               report0=report0 or {"counters": _counters(LO, 5)},
               report1=report1 or {"counters": _counters(HI, 65)})
    return {"window": w, "trace": trace, "stretch": {"waves": 2}}


@pytest.fixture
def synthetic(monkeypatch):
    buf = collections.deque(_spans(LO), maxlen=tracing.CAPACITY)
    monkeypatch.setattr(tracing, "_buffer", buf)
    monkeypatch.setattr(tracing, "_next", HI)
    monkeypatch.setattr(tracing, "_counters", {})
    monkeypatch.setattr(tracing, "_device", {})
    return buf


def _read(name, run):
    return spec.load_metric(name).read(run)


def test_window_readers(synthetic):
    run = _run()
    # queue waits 32 and 9 ms: p90 between them, numpy's linear rule
    assert _read("engine.queue_wait_ms", run) == pytest.approx(
        9 + 0.9 * (32 - 9))
    assert _read("engine.admit_wall_ms", run) == pytest.approx(40.0)
    assert _read("model.decode_dispatch_ms", run) == pytest.approx(25.0)
    # prefills 7 and 19 ms, first-token waits 39 and 8 ms
    assert _read("model.prefill_dispatch_ms", run) == pytest.approx(13.0)
    assert _read("engine.first_token_wait_ms", run) == pytest.approx(23.5)
    assert _read("kernels.placed_calls_per_token", run) == pytest.approx(6.0)


def test_a_gap_or_a_parent_program_reads_nothing(synthetic, monkeypatch):
    run = _run()
    synthetic.remove(next(s for s in synthetic if s.seq == LO + 4))
    for name in ("engine.queue_wait_ms", "engine.admit_wall_ms",
                 "model.decode_dispatch_ms", "model.prefill_dispatch_ms",
                 "engine.first_token_wait_ms"):
        assert _read(name, run) is None, name
    # the queue span of a request admitted in the window dropped
    synthetic.clear()
    synthetic.extend(s for s in _spans(LO) if s.seq != LO - 1)
    assert _read("engine.queue_wait_ms", run) is None
    assert _read("engine.admit_wall_ms", run) == pytest.approx(40.0)
    # reports without the tracer's counters (a program without it)
    bare = _run(report0={"steps": 1}, report1={"steps": 3})
    names = ("engine.queue_wait_ms", "engine.admit_wall_ms",
             "model.decode_dispatch_ms", "kernels.placed_calls_per_token",
             "model.moe_drop_pct", "device.idle_in_admit",
             "device.idle_in_decode", "model.prefill_dispatch_ms",
             "engine.first_token_wait_ms")
    for name in names:
        assert _read(name, bare) is None, name
    # no tracer module to read spans from (the counter in the reports
    # needs none)
    monkeypatch.setattr(program, "tracer", lambda: None)
    for name in names:
        if name != "kernels.placed_calls_per_token":
            assert _read(name, _run(trace=_trace())) is None, name


def _trace():
    """The stretch covers both steps; the device runs 10-40 ms and 70-80
    ms (inside the first admit and the first wave) and 115-160 ms."""
    s = lambda ms: (T0 + ms * MS) * 1e-9  # noqa: E731
    kernels = [("k", s(10), s(40)), ("k", s(70), s(80)),
               ("k", s(115), s(160))]
    return Trace(kernels=kernels, spans=[("stretch", s(0), s(200))],
                 stretch=(s(0), s(200)))


def test_idle_inside_admit_and_decode(synthetic):
    # the stretch's spans are those opened after the window's end
    run = _run(trace=_trace(), report1={"counters": _counters(LO, 65)})
    # admits 2-52 and 110-140, busy 10-40 and 115-160: idle 2-10, 40-52,
    # 110-115 = 25 ms of 200
    assert _read("device.idle_in_admit", run) == pytest.approx(12.5)
    # waves 60-100 and 150-200, busy 70-80 and 115-160: 30 + 40 ms
    assert _read("device.idle_in_decode", run) == pytest.approx(35.0)
    idle = spec.load_metric("device.idle").read(run)
    assert _read("device.idle_in_admit", run) + \
        _read("device.idle_in_decode", run) <= idle + 1e-9
    # no device interval: nothing to read
    empty = _run(trace=Trace(kernels=[], spans=[], stretch=_trace().stretch),
                 report1={"counters": _counters(LO, 65)})
    assert _read("device.idle_in_admit", empty) is None
    # what the process runs after the stretch's end (the drain) enters no
    # reading, even with spans of it lost to the buffer
    late = [_span("engine.decode", HI + 1, 250, 260),
            _span("engine.admit", HI + 3, 270, 280)]
    synthetic.extend(late)
    assert _read("device.idle_in_admit", run) == pytest.approx(12.5)
    assert _read("device.idle_in_decode", run) == pytest.approx(35.0)
    # a span of the stretch dropped
    synthetic.remove(next(s for s in synthetic if s.seq == LO + 2))
    assert _read("device.idle_in_decode", run) is None


def test_moe_drop_pct_reads_the_stretchs_steps(synthetic, monkeypatch):
    # the window ends at engine step 4; the stretch runs steps 4 and 5
    r1 = {"counters": _counters(HI, 65), "steps": 4}
    run = _run(trace=_trace(), report1=r1)
    monkeypatch.setattr(tracing, "_counters", {
        "moe.routed": {3: 100, 4: 600, 5: 400, 6: 900, None: 7},
        "moe.dropped": {3: 50, 4: 30, 5: 20, 6: 90, None: 7}})
    assert _read("model.moe_drop_pct", run) == pytest.approx(5.0)
    # nothing routed in the stretch's steps (an SSM): nothing to read
    monkeypatch.setattr(tracing, "_counters", {
        "moe.routed": {3: 100, 6: 900}, "moe.dropped": {3: 50, 6: 90}})
    assert _read("model.moe_drop_pct", run) is None
    assert _read("model.moe_drop_pct", _run(report1=r1)) is None


@pytest.mark.parametrize("name", ["dsv2lite-rag", "mamba2-longdoc"])
def test_smoke_run_counts_every_placed_call(name):
    res, rec = cell.run(name, 2**31 + 34, 1.0, True, t_proc=time.time(),
                        device="cpu", overrides=copy.deepcopy(OVERRIDES))
    assert res["correct"], res["compared"]
    w = rec["window"]
    waves = w.report1["steps"] - w.report0["steps"]
    layers = sum(n for _, n, _, _ in rec["packs"])
    calls = program.window_count(rec, "placed.calls")
    assert waves > 0 and w.admitted > 0
    assert calls == layers * (waves + w.admitted)
    m = {k: v["value"] for k, v in res["metrics"].items()}
    assert m["kernels.placed_calls_per_token"] == pytest.approx(
        calls / w.tokens)
    assert 0 < m["model.decode_dispatch_ms"] <= m["model.decode_wave_ms"]
    assert 0 < m["engine.admit_wall_ms"] <= m["engine.admit_ms"]
    assert 0 < m["model.prefill_dispatch_ms"] + \
        m["engine.first_token_wait_ms"] <= m["engine.admit_wall_ms"]
    assert m["engine.queue_wait_ms"] > 0
    # no CUDA intervals on the CPU: the idle shares read nothing
    assert "device.idle_in_admit" not in m
    assert "device.idle_in_decode" not in m
    assert ("model.moe_drop_pct" in m) == (name == "dsv2lite-rag")
