"""The traced stretch: ``torch.profiler`` (CPU and CUDA activity) over a
few steps inside the window, read back as device intervals and the
harness's own spans.

Spans are ``record_function`` names under ``pudbench.``: ``stretch`` (the
whole traced stretch), ``engine.step`` (one ``ServingEngine.step()``) and
``client loop`` (the harness's work between steps).  Device intervals are
every CUDA event that is not an annotation: kernels, copies, fills.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch

PREFIX = "pudbench."


def span(name: str):
    """A harness span; a no-op where no profiler records."""
    return torch.profiler.record_function(PREFIX + name)


@dataclasses.dataclass
class Trace:
    kernels: list          # (name, start_s, end_s), device events
    spans: list            # (name, start_s, end_s), harness spans
    stretch: tuple         # (start_s, end_s) of the traced stretch

    @property
    def window_s(self) -> float:
        return self.stretch[1] - self.stretch[0]


def _times(e):
    for a, b in (("start_ns", "end_ns"), ("start_ns", "duration_ns")):
        if hasattr(e, a) and hasattr(e, b):
            s = getattr(e, a)() * 1e-9
            v = getattr(e, b)() * 1e-9
            return s, (v if b == "end_ns" else s + v)
    s = e.start_us() * 1e-6
    return s, s + e.duration_us() * 1e-6


def read(prof) -> Trace:
    """Kernels and spans of a finished ``torch.profiler.profile``."""
    from torch.autograd import DeviceType
    kernels, spans = [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        s, t = _times(e)
        if name.startswith(PREFIX):
            if e.device_type() == DeviceType.CPU:
                spans.append((name[len(PREFIX):], s, t))
            continue
        if e.device_type() == DeviceType.CUDA and not \
                name.startswith("ProfilerStep"):
            kernels.append((name, s, t))
    stretch = [(s, t) for n, s, t in spans if n == "stretch"]
    if len(stretch) != 1:
        raise RuntimeError(f"expected one traced stretch, found "
                           f"{len(stretch)}")
    return Trace(kernels=sorted(kernels, key=lambda k: k[1]), spans=spans,
                 stretch=stretch[0])


@contextlib.contextmanager
def profiled():
    """Profile the body; yields a holder whose ``trace`` is set on exit."""
    cuda = torch.cuda.is_available()
    acts = [torch.profiler.ProfilerActivity.CPU] + (
        [torch.profiler.ProfilerActivity.CUDA] if cuda else [])
    holder = type("Held", (), {"trace": None})()
    with torch.profiler.profile(activities=acts) as prof:
        with span("stretch"):
            yield holder
        if cuda:
            torch.cuda.synchronize()
    holder.trace = read(prof)


def busy_intervals(kernels, lo: float, hi: float) -> list:
    """The union of the device intervals, clipped to [lo, hi]."""
    out = []
    for _, s, t in sorted(kernels, key=lambda k: k[1]):
        s, t = max(s, lo), min(t, hi)
        if t <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t)
        else:
            out.append([s, t])
    return out


def busy_seconds(kernels, lo: float, hi: float) -> float:
    return sum(t - s for s, t in busy_intervals(kernels, lo, hi))


def breakdown(tr: Trace, top: int = 10) -> dict:
    """The device operations that took most time (summed by name) and the
    longest idle gaps, each named by the innermost harness span around
    its middle."""
    lo, hi = tr.stretch
    by_name: dict[str, float] = {}
    for name, s, t in tr.kernels:
        s, t = max(s, lo), min(t, hi)
        if t > s:
            by_name[name] = by_name.get(name, 0.0) + (t - s)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    busy = busy_intervals(tr.kernels, lo, hi)
    gaps, prev = [], lo
    for s, t in busy + [[hi, hi]]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, t)
    inner = [x for x in tr.spans if x[0] != "stretch"]

    def label(mid):
        best = None
        for name, s, t in inner:
            if s <= mid <= t and (best is None or t - s < best[1]):
                best = (name, t - s)
        return best[0] if best else "stretch"

    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    return {"device_ops": [[n, v] for n, v in ops],
            "idle_gaps": [[label((s + t) / 2), t - s] for s, t in gaps]}
