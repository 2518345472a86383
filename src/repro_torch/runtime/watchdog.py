"""Step watchdog and heartbeat for the serving loop (port of
``repro/runtime/watchdog.py``).

  * ``StepWatchdog``: ``ServingEngine`` brackets every decode step with
    ``start_step`` / ``end_step``: a per-step wall time with an EMA
    baseline, where a step slower than ``slow_factor`` x EMA is flagged as
    a straggler.  With ``on_hang`` set, a monitor thread calls it when one
    step runs past ``hang_timeout_s``; without it no thread is started.
    The hang monitor runs on ``time.monotonic()``; a caller that times the
    step itself hands ``end_step`` the duration (``dt``).
  * ``Heartbeat``: writes ``heartbeat_<host>.json`` (host, step, a counter
    that only grows, wall time, extras) atomically through a rename, so a
    supervisor can tell a slow host from a dead one.  The file is the
    reference's, byte for byte in its keys, so either package reads the
    other's beats.
"""
from __future__ import annotations

import dataclasses
import json
import os
import pathlib
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

    def end_step(self, dt: float | None = None) -> dict:
        if self._step_start is None:
            raise RuntimeError("end_step before start_step")
        if dt is None:
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


@dataclasses.dataclass
class Heartbeat:
    """Per-host liveness file ``<directory>/heartbeat_<host_id>.json``."""

    directory: str | os.PathLike
    host_id: int = 0

    def __post_init__(self):
        self.directory = pathlib.Path(self.directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        self._count = 0

    @property
    def path(self) -> pathlib.Path:
        return self.directory / f"heartbeat_{self.host_id}.json"

    def beat(self, step: int, **extra) -> None:
        """Write the beat to a temporary file, then rename it over the
        last one: a reader sees the old beat or the new, never a torn
        file."""
        self._count += 1
        tmp = self.path.with_suffix(f".tmp-{os.getpid()}")
        tmp.write_text(json.dumps(
            {"host": self.host_id, "step": step, "count": self._count,
             "time": time.time(), **extra}))
        os.replace(tmp, self.path)

    @staticmethod
    def read_all(directory) -> list[dict]:
        """Every host's last beat in ``directory``, by host id (a file
        being replaced or unreadable is skipped until the next poll)."""
        out = []
        for p in pathlib.Path(directory).glob("heartbeat_*.json"):
            try:
                out.append(json.loads(p.read_text()))
            except (json.JSONDecodeError, OSError):
                pass
        return sorted(out, key=lambda h: h["host"])

    @staticmethod
    def stale_hosts(directory, timeout_s: float = 120.0) -> list[int]:
        """Hosts whose last beat is older than ``timeout_s`` seconds."""
        now = time.time()
        return [h["host"] for h in Heartbeat.read_all(directory)
                if now - h["time"] > timeout_s]
