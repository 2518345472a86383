"""Online drift monitor and live recalibration for serving (port of
``repro/runtime/drift.py``, single device).

Temperature and aging drift (``pud/physics`` sigma_temp / time_drift)
slowly turn calibration-time error-free columns error-prone, and a placed
pack built from stale masks starts reading stuck values on the columns
that went bad.  This module closes the loop while the engine keeps
serving:

  1. **Canary probing** (``DriftMonitor``): every ``probe_every`` controller
     ticks, push ``probe_trials`` random MAJ5 patterns through the reserved
     canary columns (``core/canary``) and score per-subarray canary ECR.
     The per-subarray EMA detector (``DriftDetector``; flagged rounds are
     kept out of the baseline) raises ``DriftEvent(subarray, new_ecr,
     severity)`` when the excess over the baseline clears a threshold.
  2. **Background recalibration** (``DriftController``): on a critical
     event, re-identify only the affected subarrays
     (``PUDSession.recalibrate_subarrays`` -> ``core/fleet``, the
     ``calib_iter`` kernel), persist the merged table (which drops the
     entry's stale placements), then re-plan and re-pack so tensors move
     off the columns that went bad.
  3. **Hot swap**: the rebuilt pack is parked with
     ``ServingEngine.stage_params`` and swapped in at the next step
     boundary; the engine decodes on the old pack through every phase, so
     tokens flow on every step.

The controller runs one phase per tick, between engine steps, so
recalibration never runs inside the decode step: the engine and the models
never call it.

Thresholds: canary ECR is quantized to 1/N for N canaries, and re-probing
an error-free column with a fresh finite campaign flips marginal columns
(the re-measurement churn floor, 1-2 of 16 canaries per round at shallow
calibration).  The defaults (16 canaries, warn at +0.15, critical at +0.30
above the EMA) sit above that floor, while a real drift event clears
critical in one round.  After a recovery the affected subarrays
re-baseline: their next probe becomes the EMA.

Probe cost: a probe round is ``probe_trials`` MAJ5 waves (every subarray's
canaries ride the same waves), priced by the ``wave_latency_ns`` model the
serving rates come from; ``DriftMonitor.probe_overhead()`` reports the
modeled share of DRAM time spent probing.

``FleetDriftMonitor`` runs one ``DriftMonitor`` per model shard of a
``PUDFleetSession`` lane, stamps each event with its ``shard`` and routes
a critical one through ``PUDFleetSession.recalibrate_shard``, so only the
raising shard's table and placement move.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core.canary import probe_ecr
from repro_torch.core.rng import derive_seed
from repro_torch.pud.placement import inject_read_faults, refresh_fault_state
from repro_torch.pud.timing import maj5_counts, wave_latency_ns


@dataclasses.dataclass(frozen=True)
class DriftConfig:
    """Monitor schedule and detector thresholds (see module docstring)."""

    n_canary: int = 16            # canary columns per subarray
    probe_every: int = 4          # controller ticks between probe rounds
    probe_trials: int = 64        # MAJ5 patterns per probe round
    ema_alpha: float = 0.25       # churn-baseline EMA weight
    warn_new_ecr: float = 0.15    # excess canary ECR -> warn event
    critical_new_ecr: float = 0.30  # excess canary ECR -> recalibrate


@dataclasses.dataclass(frozen=True)
class DriftEvent:
    """One detector firing: ``new_ecr`` is the canary ECR the probe read."""

    subarray: int
    new_ecr: float
    severity: str                 # "warn" | "critical"
    probe_round: int = 0
    shard: int = 0                # "model"-axis shard that raised it (fleet)


class DriftDetector:
    """Per-subarray EMA detector over canary ECR (numpy, float32).

    The baseline starts at zero (canaries are error-free at calibration)
    and healthy rounds refine it toward the churn floor; rounds that raise
    an event are excluded, so drift cannot poison its own baseline.
    """

    def __init__(self, n_subarrays: int, config: DriftConfig):
        self.config = config
        self.ema = np.zeros(n_subarrays, np.float32)
        self.events: list[DriftEvent] = []
        self._rebaseline: set[int] = set()

    def rebaseline(self, subarrays) -> None:
        """Absorb the next probe of ``subarrays`` directly as their EMA: a
        table recalibrated against drifted offsets has a higher residual
        churn, and the pristine baseline would re-trigger forever."""
        self._rebaseline.update(int(s) for s in subarrays)

    def update(self, canary_ecr, probe_round: int) -> list[DriftEvent]:
        out = []
        a = self.config.ema_alpha
        for g, e in enumerate(np.asarray(canary_ecr, np.float32)):
            if g in self._rebaseline:
                self._rebaseline.discard(g)
                self.ema[g] = float(e)
                continue
            excess = float(e) - float(self.ema[g])
            if excess > self.config.critical_new_ecr:
                out.append(DriftEvent(g, float(e), "critical", probe_round))
            elif excess > self.config.warn_new_ecr:
                out.append(DriftEvent(g, float(e), "warn", probe_round))
            else:
                self.ema[g] = (1 - a) * self.ema[g] + a * float(e)
        self.events.extend(out)
        return out


class DriftMonitor:
    """Canary probing of one device against a session's live table.

    ``device`` is anything with ``sense_offsets() -> [G, n_cols]``: the
    ``core/reliability.DriftSimulator`` under ``--drift-sim``, or an
    adapter to real hardware.  Probes measure against the session's current
    levels, so rounds after a recovery score the refreshed table.
    """

    def __init__(self, session, device, *, config: DriftConfig = DriftConfig()):
        if session.calibration is None:
            raise RuntimeError("DriftMonitor requires a calibrated session")
        if session.canaries is None:
            session.reserve_canaries(config.n_canary)
        self.session = session
        self.device = device
        self.config = config
        self.seed = derive_seed(session.seed, 0x0D41F7)
        self.detector = DriftDetector(
            session.fleet_cfg.n_subarrays_total, config)
        self.probe_rounds = 0
        self.last_canary_ecr: np.ndarray | None = None

    def _charges(self) -> torch.Tensor:
        from repro_torch.core.fleet import fleet_calib_charges
        return fleet_calib_charges(self.session.ladder,
                                   self.session.calibration.levels,
                                   self.session.physics)

    def probe(self) -> list[DriftEvent]:
        """One probe round over the canary columns; returns new events."""
        ecr, _ = probe_ecr(
            derive_seed(self.seed, self.probe_rounds),
            self.device.sense_offsets(), self._charges(),
            self.session.physics, self.session.n_fracs,
            cols=self.session.canaries.cols,
            n_trials=self.config.probe_trials)
        self.last_canary_ecr = ecr.cpu().numpy()
        events = self.detector.update(self.last_canary_ecr,
                                      self.probe_rounds)
        self.probe_rounds += 1
        return events

    def probe_overhead(self) -> float | None:
        """Modeled share of DRAM time the probe schedule costs: one round of
        ``probe_trials`` MAJ5 waves amortized over ``probe_every`` batch-1
        decode steps priced by the session's ``FleetPerfModel``.  None when
        the session cannot price a token."""
        pm = (self.session.placement_perf_model()
              or self.session.tuned_perf_model())
        flops = self.session.flops_per_token()
        if flops is None or not hasattr(pm, "batched_tokens_per_second"):
            return None
        counts = maj5_counts(self.session.fleet_cfg.frac_counts)
        probe_s = (self.config.probe_trials
                   * wave_latency_ns(counts, pm.sys) * 1e-9)
        step_s = 1 / pm.batched_tokens_per_second(flops, 1)
        return probe_s / (probe_s + self.config.probe_every * step_s)

    def report(self) -> dict:
        """Monitor counters: probe progress, detector state, table age."""
        return {
            "probe_rounds": self.probe_rounds,
            "n_canary": (self.session.canaries.n_per_subarray
                         if self.session.canaries else 0),
            "last_canary_ecr": (None if self.last_canary_ecr is None
                                else [float(e)
                                      for e in self.last_canary_ecr]),
            "ema": [float(e) for e in self.detector.ema],
            "events": len(self.detector.events),
            "critical_events": sum(e.severity == "critical"
                                   for e in self.detector.events),
            "probe_overhead": self.probe_overhead(),
            "table_age": self.session.calibration_age(),
        }


class FleetDriftMonitor:
    """Per-shard drift monitoring of one data lane of a ``PUDFleetSession``.

    One ``DriftMonitor`` (its own canaries, detector and EMA baseline) per
    model shard of the lane, each probing its own device (``devices[m]``)
    against its own session's live table.  ``probe()`` rounds every shard
    and stamps each event with the owning ``shard``; ``recover()`` routes
    a critical event through ``PUDFleetSession.recalibrate_shard``, so
    only the raising shard's table and placement move.
    """

    def __init__(self, fleet, devices, *,
                 config: DriftConfig = DriftConfig(), data_lane: int = 0):
        row = fleet.sessions[data_lane]
        if len(devices) != len(row):
            raise ValueError(
                f"need one probe device per model shard: got {len(devices)} "
                f"for {len(row)} shards")
        self.fleet = fleet
        self.data_lane = data_lane
        self.monitors = [DriftMonitor(s, dev, config=config)
                         for s, dev in zip(row, devices)]

    def probe(self) -> list[DriftEvent]:
        """One probe round per shard; events carry the shard index."""
        events: list[DriftEvent] = []
        for m, mon in enumerate(self.monitors):
            events.extend(dataclasses.replace(e, shard=m)
                          for e in mon.probe())
        return events

    def recover(self, event: DriftEvent):
        """Recalibrate and re-plan only the shard that raised ``event``."""
        mon = self.monitors[event.shard]
        out = self.fleet.recalibrate_shard(
            event.shard, [event.subarray], mon.device.sense_offsets(),
            data_lane=self.data_lane,
            assumed_temp_c=getattr(mon.device, "temp_c", None))
        mon.detector.rebaseline([event.subarray])
        return out

    def report(self) -> dict:
        return {"data_lane": self.data_lane,
                "shards": [m.report() for m in self.monitors]}


class DriftController:
    """Recovery state machine driven between engine steps.

    ``step()`` runs one engine step, then one controller phase:

        monitor      probe on schedule; critical events queue subarrays
        recalibrate  partial recalibration through the session
        repack       re-plan placement, rebuild the pack, stage the swap

    The swap happens inside the engine at the top of its next step
    (``stage_params``), so decode continues on the old pack through every
    phase.  ``read_faults``: optional ``f(packed_params) -> packed_params``
    mapping a fresh pack to what the (possibly faulty) device would serve;
    under ``--drift-sim`` it injects the simulator's stuck reads, a numeric
    no-op for a placement that avoids every drifted column.  Each recovery
    records the host walls of its recalibrate and repack phases
    (synchronised on the session's device).
    """

    def __init__(self, engine, monitor: DriftMonitor, model_params, *,
                 pack_name: str | None = None, read_faults=None):
        self.engine = engine
        self.monitor = monitor
        self.session = monitor.session
        self.model_params = model_params
        self.pack_name = pack_name
        self.read_faults = read_faults
        self.phase = "monitor"
        self.tokens_per_step: list[int] = []
        self.swap_step_tokens: list[int] = []   # tokens emitted on swap steps
        self.recoveries: list[dict] = []
        self._pending: set[int] = set()
        self._current: dict | None = None
        self._ticks = 0

    # -- loop ----------------------------------------------------------------

    def step(self):
        """One engine step and one controller phase; returns completions."""
        emitted0 = self.engine._active_slot_steps
        swaps0 = len(self.engine._swap_steps)
        completions = self.engine.step()
        emitted = self.engine._active_slot_steps - emitted0
        self.tokens_per_step.append(emitted)
        if len(self.engine._swap_steps) > swaps0:
            self.swap_step_tokens.append(emitted)
        self._tick()
        return completions

    def run(self, requests=None):
        """Drain requests (and any recovery in flight) to completion."""
        if requests is not None:
            self.engine.submit_all(requests)
        while (self.engine.n_pending or self.engine.n_active
               or self.phase != "monitor" or self.engine.swap_pending):
            self.step()
        return sorted(self.engine._completions,
                      key=lambda c: c.request_id)

    # -- state machine -------------------------------------------------------

    def _wall(self, fn, *args, **kw):
        dev = self.session.device
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return out, time.perf_counter() - t0

    def _tick(self) -> None:
        self._ticks += 1
        if self.phase == "monitor":
            if (self._ticks - 1) % self.monitor.config.probe_every:
                return
            events = self.monitor.probe()
            critical = sorted({e.subarray for e in events
                               if e.severity == "critical"})
            if critical:
                self._pending.update(critical)
                ecr = self.monitor.last_canary_ecr
                self._current = {
                    "detected_step": self.engine._step_idx,
                    "detected_round": self.monitor.probe_rounds - 1,
                    "subarrays": critical,
                    "canary_ecr_at_detection": {
                        g: float(ecr[g]) for g in critical},
                }
                self.phase = "recalibrate"
        elif self.phase == "recalibrate":
            affected = sorted(self._pending)
            self._pending.clear()
            _, wall = self._wall(
                self.session.recalibrate_subarrays, affected,
                self.device.sense_offsets(),
                assumed_temp_c=getattr(self.device, "temp_c", None))
            self._current["recalibrate_wall_s"] = wall
            self.phase = "repack"
        elif self.phase == "repack":
            # the config of the pack the engine serves: the rebuilt pack
            # differs only by placement
            packed, wall = self._wall(self.session.pack, self.model_params,
                                      self.session._pack_cfg,
                                      name=self.pack_name)
            params = packed.params
            if self.read_faults is not None:
                params = self.read_faults(params)
            self.engine.stage_params(params)
            self._current["repack_wall_s"] = wall
            self._current["swap_staged_step"] = self.engine._step_idx
            ecr = self.session.calibration.ecr.cpu().numpy()
            self._current["recalibrated_ecr"] = {
                g: float(ecr[g]) for g in self._current["subarrays"]}
            self.monitor.detector.rebaseline(self._current["subarrays"])
            self.recoveries.append(self._current)
            self._current = None
            self.phase = "monitor"

    @property
    def device(self):
        return self.monitor.device

    # -- reporting -----------------------------------------------------------

    def report(self) -> dict:
        """Controller, monitor and engine-swap counters in one dict."""
        rep = self.monitor.report()
        rep.update({
            "phase": self.phase,
            "ticks": self._ticks,
            "recoveries": list(self.recoveries),
            "swap_steps": list(self.engine._swap_steps),
            "swap_step_tokens": list(self.swap_step_tokens),
            "min_tokens_per_step": (min(self.tokens_per_step)
                                    if self.tokens_per_step else 0),
        })
        # every hot swap drops the engine's prefix cache: a prefix computed
        # under the old pack is stale
        eng_rep = self.engine.scheduler_report()
        if "prefix_cache" in eng_rep:
            rep["prefix_cache"] = eng_rep["prefix_cache"]
        return rep


# -- driving a simulated drift ------------------------------------------------

def sim_read_faults(session, sim):
    """``DriftController``'s ``read_faults`` under a ``DriftSimulator``: a
    fresh pack as the drifted device reads it (faults re-derived from the
    table's masks and the simulator's offsets, injected as stuck reads).
    None when the session serves unplaced packs."""
    if session.placement is None:
        return None

    def read_faults(packed_params):
        pl = refresh_fault_state(session.placement,
                                 session.calibration.masks.cpu().numpy(),
                                 sim.sense_offsets().cpu().numpy())
        return inject_read_faults(packed_params, pl)
    return read_faults


def run_with_drift(ctl: DriftController, requests, sim, *, at, temp_c,
                   days=None, subarrays, seed: int, n_trials: int,
                   max_ticks: int) -> int | None:
    """Serve ``requests`` through ``ctl`` until they drain and no recovery
    is in flight.  With ``at`` set, before tick ``at`` the simulator drifts
    ``subarrays`` (``temp_c``, ``days``) and the live pack is corrupted to
    what the drifted device reads: faults from a ``probe_ecr`` campaign of
    ``n_trials`` patterns over every column (stream ``derive_seed(seed,
    0xD21F)``), injected into the engine's params.  Returns the engine step
    of the drift (None without one); raises RuntimeError when the loop has
    not drained after ``max_ticks`` ticks."""
    engine, session = ctl.engine, ctl.session
    engine.submit_all(requests)
    drift_step, ticks = None, 0
    while (engine.n_pending or engine.n_active or ctl.phase != "monitor"
           or engine.swap_pending):
        if at is not None and drift_step is None and ticks >= at:
            sim.advance(temp_c=temp_c, days=days, subarrays=subarrays)
            offsets = sim.sense_offsets()
            _, masks = probe_ecr(derive_seed(seed, 0xD21F), offsets,
                                 ctl.monitor._charges(), session.physics,
                                 session.n_fracs, n_trials=n_trials)
            if session.placement is not None:
                engine.params = inject_read_faults(
                    engine.params, refresh_fault_state(
                        session.placement, masks.cpu().numpy(),
                        offsets.cpu().numpy()))
            drift_step = engine._step_idx
        ctl.step()
        ticks += 1
        if ticks > max_ticks:
            raise RuntimeError("the drift loop did not drain")
    return drift_step
