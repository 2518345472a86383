"""What the program records of itself, read back for the per-layer
metrics: the port's tracer (``repro_torch.runtime.tracing``), its spans
by sequence number and on the profiler's clock, its counters as the
window's deltas.

The window is bracketed by the engine's ``scheduler_report()`` at its
start and end (``Window.report0`` / ``report1``): each carries the
tracer's counters and ``seq``, the sequence number of the next span.  The
window's spans are those opened between the two; the traced stretch's
are those opened after the window and before the stretch's end, clipped
to it; its counts are those keyed by its engine steps.  So what the
process runs after the stretch (the drain, the judge) enters no reading.
A range with a sequence number missing lost spans to the tracer's
bounded buffer, and reads as nothing.  A program without the tracer, or
reports without ``counters``, read as nothing too (None), never as 0.
"""
from __future__ import annotations

from .trace import busy_intervals, busy_seconds


def tracer():
    """The port's tracer module, or None where the program has none."""
    try:
        from repro_torch.runtime import tracing
    except ImportError:
        return None
    return tracing


def _seq(report: dict) -> int | None:
    c = report.get("counters")
    return None if c is None else c.get("seq")


def _complete(tr, lo: int, hi: int) -> list | None:
    """Every span with ``lo <= seq < hi``, or None if one is missing."""
    got = [s for s in tr.spans() if lo <= s.seq < hi]
    return got if len(got) == hi - lo else None


def window_spans(run) -> list | None:
    """The spans opened in the measured window, by sequence number."""
    tr = tracer()
    w = run["window"]
    lo, hi = _seq(w.report0), _seq(w.report1)
    if tr is None or lo is None or hi is None:
        return None
    return _complete(tr, lo, hi)


def durations_ms(spans, name: str) -> list:
    return [(s.end_ns - s.start_ns) * 1e-6 for s in spans if s.name == name]


def window_ms_per(run, name: str, per: str) -> float | None:
    """The window's ``name`` spans, summed, in ms, per ``per`` span (its
    parent: ``model.decode_step`` per ``engine.decode`` wave)."""
    spans = window_spans(run)
    if spans is None:
        return None
    n = len(durations_ms(spans, per))
    return sum(durations_ms(spans, name)) / n if n else None


def window_count(run, name: str) -> int | None:
    """The window's delta of counter ``name`` (keyed ones summed over
    their keys)."""
    c0 = run["window"].report0.get("counters")
    c1 = run["window"].report1.get("counters")
    if c0 is None or c1 is None:
        return None

    def total(c):
        v = c.get(name, 0)
        return sum(v.values()) if isinstance(v, dict) else v
    return total(c1) - total(c0)


def stretch_spans(run, name: str) -> list | None:
    """(start_s, end_s) of every ``name`` span opened after the window
    and before the traced stretch's end, clipped to the stretch."""
    tr, trace = tracer(), run["trace"]
    lo = _seq(run["window"].report1)
    if tr is None or trace is None or lo is None:
        return None
    a, b = trace.stretch
    spans = [s for s in tr.spans() if s.seq >= lo and s.start_ns * 1e-9 < b]
    if [s.seq for s in spans] != list(range(lo, lo + len(spans))):
        return None
    out = []
    for s in spans:
        s0, s1 = max(s.start_ns * 1e-9, a), min(s.end_ns * 1e-9, b)
        if s.name == name and s1 > s0:
            out.append((s0, s1))
    return out


def stretch_count(run, name: str) -> int | None:
    """Counter ``name``'s entries keyed by the traced stretch's engine
    steps (one decode wave each, from the window's end), summed."""
    tr, r1 = tracer(), run["window"].report1
    if tr is None or run["trace"] is None or "counters" not in r1:
        return None
    first = r1["steps"]
    by_step = tr.counters().get(name, {})
    return sum(by_step.get(k, 0)
               for k in range(first, first + run["stretch"]["waves"]))


def idle_inside(run, name: str) -> float | None:
    """Share of the traced stretch, in %, in which the host is inside a
    ``name`` span and no device interval runs; None without device
    intervals in the stretch."""
    trace = run["trace"]
    if trace is None or trace.window_s <= 0 or \
            not busy_seconds(trace.kernels, *trace.stretch):
        return None
    spans = stretch_spans(run, name)
    if spans is None:
        return None
    inside = busy_intervals([(name, s, t) for s, t in spans],
                            *trace.stretch)
    idle = sum(t - s - busy_seconds(trace.kernels, s, t) for s, t in inside)
    return 100.0 * idle / trace.window_s
