"""Step watchdog for the serving loop (port of ``StepWatchdog`` in
``repro/runtime/watchdog.py``; the file ``Heartbeat`` is not ported).

``ServingEngine`` brackets every decode step with ``start_step`` /
``end_step``: a per-step wall time with an EMA baseline, where a step slower
than ``slow_factor`` x EMA is flagged as a straggler.  With ``on_hang`` set,
a monitor thread calls it when one step runs past ``hang_timeout_s``;
without it no thread is started.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable


@dataclasses.dataclass
class StepWatchdog:
    slow_factor: float = 2.5
    hang_timeout_s: float = 600.0
    ema_alpha: float = 0.1
    on_hang: Callable[[float], None] | None = None

    def __post_init__(self):
        self.ema_s: float | None = None
        self.stragglers: list[tuple[int, float]] = []
        self._step_start: float | None = None
        self._step_idx = 0
        self._stop = threading.Event()
        self._monitor: threading.Thread | None = None

    def start_step(self, step: int) -> None:
        self._step_idx = step
        self._step_start = time.monotonic()
        if self._monitor is None and self.on_hang is not None:
            self._monitor = threading.Thread(target=self._watch, daemon=True)
            self._monitor.start()

    def end_step(self) -> dict:
        if self._step_start is None:
            raise RuntimeError("end_step before start_step")
        dt = time.monotonic() - self._step_start
        self._step_start = None
        is_straggler = (self.ema_s is not None
                        and dt > self.slow_factor * self.ema_s)
        if is_straggler:
            self.stragglers.append((self._step_idx, dt))
        else:
            # flagged steps stay out of the baseline
            self.ema_s = dt if self.ema_s is None else (
                (1 - self.ema_alpha) * self.ema_s + self.ema_alpha * dt)
        return {"step_time_s": dt, "ema_s": self.ema_s,
                "straggler": is_straggler}

    def _watch(self) -> None:
        while not self._stop.wait(1.0):
            start = self._step_start
            if start is None:
                continue
            waited = time.monotonic() - start
            if waited > self.hang_timeout_s:
                self.on_hang(waited)
                return

    def close(self) -> None:
        self._stop.set()
