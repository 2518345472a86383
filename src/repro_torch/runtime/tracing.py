"""The port's tracer: host spans and counters of the serving path.

  * ``span(name, **attrs)`` is a context manager.  Each span records its
    name, a sequence number (taken when it opens), the sequence number of
    its parent (the innermost span open on the same thread), the request
    id and the engine step index (both inherited from the parent where not
    given), any other attributes, and its start and end in
    ``time.time_ns()``: the Unix epoch, which is the clock ``torch.profiler``
    stamps its host events on.  A closed span goes into a bounded buffer
    (``CAPACITY``); the oldest closed spans drop first, so a reader that
    finds a sequence number missing from a range it needs knows spans were
    lost there.
  * The host stamps are always taken.  While a ``torch.profiler`` session
    records, a span also enters a profiler annotation of its name, so the
    device trace shows it: torch's light C++ one (``_RecordFunctionFast``,
    what compiled code emits, in torch since 2.3; its event starts a few
    microseconds before the span and ends a few after it;
    ``torch.profiler.record_function``'s enter and exit are dispatched
    ops that cost tens of microseconds under the profiler).  At
    no other time does a span enter an annotation, record a CUDA event or
    launch a device operation.  ``detached`` spans (a request's wait in a
    queue: opened and closed in different calls, possibly on different
    stacks) take no parent and are never emitted to the profiler.
  * ``count(name, n, key)`` adds to a host counter (``key``: one counter
    per key under ``name``).  ``count_device(name, t, key)`` adds a device
    tensor to a keyed counter where a host read would stall the stream
    (the MoE router's drops, keyed by ``current_step()``, None outside an
    engine step); those sums are read once, by the next ``counters()``.
  * ``spans()`` and ``counters()`` return plain data; ``next_seq()`` is the
    sequence number the next span will take, so that two reads of it
    bracket the spans opened between them.
"""
from __future__ import annotations

import collections
import threading
import time
from typing import NamedTuple

import torch

CAPACITY = 65_536


class Span(NamedTuple):
    name: str
    seq: int
    parent: int | None
    request: int | None
    step: int | None
    start_ns: int
    end_ns: int
    attrs: dict


class _Stack(threading.local):
    def __init__(self):
        self.open: list[span] = []


_next = 0
_lock = threading.Lock()
_buffer: collections.deque = collections.deque(maxlen=CAPACITY)
_stack = _Stack()
_counters: dict = {}
_device: dict = {}


def _take_seq() -> int:
    global _next
    with _lock:
        n = _next
        _next = n + 1
    return n


def recording() -> bool:
    """Whether a ``torch.profiler`` session records on this thread."""
    return torch._C._autograd._profiler_enabled()


def _annotation(name: str):
    return torch._C._profiler._RecordFunctionFast(name)


class span:
    """A host span; ``with span("engine.admit", request=7): ...``, or
    ``start()`` / ``stop()`` for a ``detached`` span."""

    __slots__ = ("name", "seq", "parent", "request", "step", "attrs",
                 "start_ns", "end_ns", "_rf", "_detached")

    def __init__(self, name: str, *, request: int | None = None,
                 step: int | None = None, detached: bool = False, **attrs):
        self.name = name
        self.request = request
        self.step = step
        self.attrs = attrs
        self._detached = detached
        self._rf = None

    def start(self) -> "span":
        self.parent = None
        if not self._detached:
            stack = _stack.open
            if stack:
                top = stack[-1]
                self.parent = top.seq
                if self.request is None:
                    self.request = top.request
                if self.step is None:
                    self.step = top.step
            stack.append(self)
            if recording():
                self._rf = _annotation(self.name)
                self._rf.__enter__()
        self.seq = _take_seq()
        self.start_ns = time.time_ns()
        return self

    def stop(self, **attrs) -> Span:
        # the annotation's exit stamps its end first and may then run for
        # tens of microseconds (a model call's, under the CUDA profiler):
        # the span's end comes before the exit, as its start after the
        # enter
        self.end_ns = time.time_ns()
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
            self._rf = None
        if not self._detached:
            _stack.open.pop()
        if attrs:
            self.attrs = dict(self.attrs, **attrs)
        rec = Span(self.name, self.seq, self.parent, self.request, self.step,
                   self.start_ns, self.end_ns, self.attrs)
        _buffer.append(rec)
        return rec

    __enter__ = start

    def __exit__(self, *exc) -> None:
        self.stop()


def current_step() -> int | None:
    """The step index of the innermost span open on this thread."""
    stack = _stack.open
    return stack[-1].step if stack else None


def next_seq() -> int:
    """The sequence number the next span opened will take."""
    return _next


def spans() -> list[Span]:
    """The closed spans still in the buffer, by sequence number."""
    return sorted(_buffer.copy(), key=lambda s: s.seq)


def count(name: str, n: int = 1, key=None) -> None:
    """Add ``n`` to counter ``name`` (to its ``key`` entry where given)."""
    with _lock:
        if key is None:
            _counters[name] = _counters.get(name, 0) + n
        else:
            d = _counters.setdefault(name, {})
            d[key] = d.get(key, 0) + n


def count_device(name: str, t: torch.Tensor, key) -> None:
    """Add the integer tensor ``t`` (on any device) to the ``key`` entry
    of the keyed counter ``name`` (a None key is an entry too) without
    reading it; ``counters()`` reads the sums."""
    k = (name, key, t.device)
    t = t.to(torch.int64)
    with _lock:
        acc = _device.get(k)
        _device[k] = t if acc is None else acc + t


def counters() -> dict:
    """Every counter: ``name -> int``, or ``name -> {key: int}`` for keyed
    ones.  Device sums pending since the last call are read here (one
    transfer per device) and join the host counters."""
    with _lock:
        pending = list(_device.items())
        _device.clear()
    if pending:
        by_dev: dict = {}
        for (name, key, dev), t in pending:
            by_dev.setdefault(dev, []).append((name, key, t))
        for group in by_dev.values():
            vals = torch.stack([t.reshape(()) for *_, t in group]).tolist()
            with _lock:
                for (name, key, _), v in zip(group, vals):
                    d = _counters.setdefault(name, {})
                    d[key] = d.get(key, 0) + int(v)
    with _lock:
        return {k: dict(v) if isinstance(v, dict) else v
                for k, v in _counters.items()}

