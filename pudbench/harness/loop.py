"""The closed loop of clients around ``ServingEngine.step()``.

Every client has one request in the engine at a time and submits its
next one as soon as the last completes, at the step boundary where the
harness sees the completion (in the order the engine returns them).  With
as many clients as slots every slot stays live: FIFO admission puts a
client's next request into the slot its last one left.

The loop records host-clock times only at step boundaries: each step's
start and end, how many requests it admitted (the queue's drop), how many
rows its decode wave ran (live slots after it plus the requests it
finished), and each request's submission time and the end of the step
that admitted it (its first token).  Within the measured window nothing
else is timed or traced.
"""
from __future__ import annotations

import collections
import dataclasses
import time

from .trace import span


@dataclasses.dataclass
class Step:
    start: float
    end: float
    admitted: int
    live: int


@dataclasses.dataclass
class Window:
    """What the measured window saw (host clock, seconds)."""
    t0: float
    t1: float
    steps: list                 # Step, in order
    ttft: list                  # seconds, per request submitted in it
    itl: list                   # seconds, every gap between tokens
    tokens: int                 # tokens generated in the window
    admitted: int
    report0: dict               # scheduler_report() at t0 and t1
    report1: dict

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


class ClosedLoop:
    """Drives ``engine`` with ``traffic``'s clients."""

    def __init__(self, engine, traffic, request_cls):
        self.engine = engine
        self.traffic = traffic
        self.Request = request_cls
        self.traced = False            # harness spans around each step
        self.submit_t: dict[int, float] = {}
        self.first_t: dict[int, float] = {}
        self.fifo: collections.deque = collections.deque()
        self.steps: list[Step] = []
        self.completions: dict[int, object] = {}
        self.next_k = 0

    def _submit(self, now: float) -> None:
        k = self.next_k
        it = self.traffic.item(k)
        self.engine.submit(self.Request(k, self.traffic.tokens(k),
                                        it.max_new_tokens))
        self.submit_t[k] = now
        self.fifo.append(k)
        self.next_k += 1

    def start(self) -> None:
        now = time.perf_counter()
        for _ in range(self.traffic.clients):
            self._submit(now)

    def step(self, until: float | None = None) -> Step:
        """One engine step; its completions' clients submit their next
        requests unless the step ended at or after ``until``."""
        eng = self.engine
        pending = eng.n_pending
        start = time.perf_counter()
        if self.traced:
            with span("engine.step"):
                done = eng.step()
        else:
            done = eng.step()
        end = time.perf_counter()
        submit = until is None or end < until
        if self.traced:
            with span("client loop"):
                st = self._after(done, pending, start, end, submit)
        else:
            st = self._after(done, pending, start, end, submit)
        return st

    def _after(self, done, pending, start, end, submit) -> Step:
        admitted = pending - self.engine.n_pending
        for _ in range(admitted):
            self.first_t[self.fifo.popleft()] = end
        st = Step(start, end, admitted, self.engine.n_active + len(done))
        self.steps.append(st)
        for c in done:
            self.completions[c.request_id] = c
            if submit:
                self._submit(time.perf_counter())
        return st

    def run_window(self, seconds: float, steps: int | None = None,
                   last: bool = True) -> Window:
        """Step until ``seconds`` have passed since the window opened (the
        end of the last step before it), or for exactly ``steps`` steps
        where given (a run at a size where the clock should not decide).
        With ``last`` the clients stop submitting at the window's end;
        without, they go on (more steps follow)."""
        eng = self.engine
        t0 = self.steps[-1].end if self.steps else time.perf_counter()
        first = len(self.steps)
        rep0 = eng.scheduler_report()
        i, done = 0, False
        while not done:
            if steps is None:
                st = self.step(until=t0 + seconds if last else None)
                done = st.end - t0 >= seconds
            else:
                done = i + 1 >= steps
                self.step(until=0.0 if done and last else None)
            i += 1
        rep1 = eng.scheduler_report()
        steps = self.steps[first:]
        itl, prev = [], t0
        for st in steps:
            itl += [st.end - prev] * (st.live - st.admitted)
            itl += [0.0] * st.admitted
            prev = st.end
        ttft = [self.first_t[k] - t for k, t in self.submit_t.items()
                if t >= t0 and k in self.first_t]
        return Window(t0=t0, t1=steps[-1].end, steps=steps, ttft=ttft,
                      itl=itl, tokens=sum(s.live + s.admitted for s in steps),
                      admitted=sum(s.admitted for s in steps),
                      report0=rep0, report1=rep1)

    def close(self) -> None:
        """Stop: requests still in flight complete with the tokens they
        have (``shed_request``), so every row of every wave that ran has
        its tokens; no request is left queued."""
        if self.fifo:
            raise RuntimeError(f"requests {list(self.fifo)} still queued")
        for k in range(self.next_k):
            if k not in self.completions and \
                    not self.engine.shed_request(k):
                raise RuntimeError(f"request {k} is nowhere")
        for c in self.engine.run():
            self.completions[c.request_id] = c
