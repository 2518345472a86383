"""One run of one cell, from the process's start to its result line.

Set-up: the port's model for the configuration, weights from the seed,
``PUDSession.open`` on the configuration's grid with a fresh calibration
cache under ``TMPDIR`` (a miss: Algorithm 1 runs in every run), placement
and 4-bit packing, ``serving_engine`` with one slot per client, then the
closed loop's warm-up steps.  The window: the closed loop for
``--seconds``; with ``--trace 1`` a stretch of steps at the same load
follows it under the profiler.  After it: in-flight requests close with
their tokens, the device's peak is read, the program's state is freed,
and the reference judges what was served (``check.judge``).
"""
from __future__ import annotations

import copy
import gc
import os
import sys
import tempfile
import time

import torch

from . import check, spec, trace as trace_mod, weights as weights_mod
from .loop import ClosedLoop
from .peaks import peaks
from .seeds import sub_seed
from .traffic import Traffic


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _get(obj, path: str):
    for part in path.split("."):
        obj = getattr(obj, part)
    return obj


def _keys_as_run(config: dict, model) -> dict:
    """The configuration's keys with every mapped key read from the port's
    model (``port.keys``: file key path -> attribute path), so that a
    smoke-size model gives its own sizes; at full size they must agree
    with the file."""
    keys = copy.deepcopy(config)
    for kpath, attr in config["port"]["keys"].items():
        *head, last = kpath.split(".")
        d = keys
        for part in head:
            d = d[part]
        d[last] = _get(model, attr)
    return keys


def _check_keys(config: dict, model) -> None:
    run = _keys_as_run(config, model)
    if run != config:
        diff = {k: (config.get(k), run.get(k)) for k in run
                if run.get(k) != config.get(k)}
        raise ValueError(f"the port's {config['port']['arch']} is not the "
                         f"configuration in its file: {diff}")


def _log(t_proc: float, what: str) -> None:
    print(f"[pudbench {time.time() - t_proc:8.2f}s] {what}", file=sys.stderr,
          flush=True)


def run(name: str, seed: int, seconds: float, trace: bool, *,
        t_proc: float, device=None, overrides: dict | None = None,
        root=spec.ROOT, also=None) -> tuple[dict, dict]:
    """(result line, the run's record for the metric readers).
    ``also(inputs)``, where given, runs after the judge on what it was
    given (``control.py``: the control's reading); its value goes to the
    result's ``also``."""
    from repro_torch.configs import registry
    from repro_torch.core.calibrate import CalibrationConfig
    from repro_torch.core.fleet import FleetConfig
    from repro_torch.pud.gemv import PUDGemvConfig
    from repro_torch.runtime.engine import Request
    from repro_torch.runtime.session import PUDSession

    cell = spec.load_cell(name, root)
    wl, config, mix = cell.workload, cell.config, cell.mix
    ov = overrides or {}
    mix = dict(mix, **ov.get("mix", {}))
    wl = dict(wl, **ov.get("workload", {}))
    device = torch.device(device or "cuda")
    arch = registry.get(config["port"]["arch"])
    model = arch.make_smoke() if ov.get("smoke") else arch.make_model()
    if not ov.get("smoke"):
        _check_keys(config, model)
    sizes = _keys_as_run(config, model)

    _log(t_proc, f"{name}: model {config['port']['arch']}")
    params = weights_mod.make(model.param_defs(), seed, device)
    _sync(device)
    _log(t_proc, "weights made")
    traffic = Traffic(mix, sizes[config["port"]["vocab_key"]], seed)
    grid = dict(config["grid"], **ov.get("grid", {}))
    spans = {}
    with tempfile.TemporaryDirectory(
            prefix="pudbench-calib-", dir=os.environ.get("TMPDIR")) as tmp:
        session = PUDSession.open(
            config["port"]["arch"], grid=FleetConfig(**grid),
            calib=CalibrationConfig(**config["calibration"]),
            cache_dir=tmp, seed=sub_seed(seed, "device"), device=device)
        _sync(device)
        t = time.perf_counter()
        state = session.calibrate()
        _sync(device)
        spans["calibrate"] = time.perf_counter() - t
        if state.cache_hit:
            raise RuntimeError("calibration hit a cache; every run must miss")
        pud = config["pud"]
        t = time.perf_counter()
        packed = session.pack(params, PUDGemvConfig(
            weight_bits=pud["weight_bits"], packable=tuple(pud["packable"])))
        _sync(device)
        spans["pack"] = time.perf_counter() - t
        if session.placement_status != "planned":
            raise RuntimeError(f"placement {session.placement_status}: "
                               f"{session.placement_error}")
        if sorted(packed.packed_names) != sorted(pud["packed"]):
            raise RuntimeError(f"packed {sorted(packed.packed_names)}, the "
                               f"configuration names {sorted(pud['packed'])}")
        _log(t_proc, f"calibrated in {spans['calibrate']:.3f}s, packed in "
             f"{spans['pack']:.3f}s")
        engine = session.serving_engine(
            model, max_len=traffic.max_prompt + traffic.max_output,
            batch_size=traffic.clients, max_batch=traffic.clients)
        del packed
        loop = ClosedLoop(engine, traffic, Request)
        loop.start()
        for _ in range(int(wl["warmup_steps"])):
            loop.step()
        setup_s = time.time() - t_proc
        _log(t_proc, f"warm-up done: {len(loop.steps)} steps")

        window = loop.run_window(seconds, wl.get("window_steps"),
                                 last=not trace)
        tr, stretch_waves = None, None
        if trace:
            # the traced stretch follows the window at the same load, so
            # the profiler perturbs none of the window's steps
            lo = len(loop.steps)
            n = int(wl["trace"]["steps"])
            loop.traced = True
            with trace_mod.profiled() as held:
                for i in range(n):
                    loop.step(until=0.0 if i == n - 1 else None)
            tr, stretch_waves = held.trace, (lo, len(loop.steps))
        n_waves = engine.scheduler_report()["steps"]
        _log(t_proc, f"window closed: {len(window.steps)} steps, "
             f"{window.tokens} tokens in {window.seconds:.3f}s")
        loop.close()
        peak = (torch.cuda.max_memory_allocated(device)
                if device.type == "cuda" else 0)
        completions = loop.completions
        del engine, session, loop, state
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    verdict = check.judge(config, sizes, params, traffic, completions,
                          n_waves, seed, wl["correct"],
                          int(wl["compare_requests"]))
    _log(t_proc, f"judged: {verdict['compared']}")
    extra = None
    if also is not None:
        extra = also(dict(config=config, sizes=sizes, params=params,
                          traffic=traffic, completions=completions,
                          n_waves=n_waves, seed=seed, workload=wl,
                          verdict=verdict))
    stretch = None
    if tr is not None:
        from .schedule import simulate
        sched = simulate(traffic, n_waves)
        lo, hi = stretch_waves
        prompts, positions = [], []
        for k, (slot, adm, fin, n, shed) in sched.items():
            s = traffic.item(k).prompt_len
            if lo <= adm < hi:
                prompts.append(s)
            for w in range(max(adm, lo), min(adm + n - 1, hi)):
                positions.append(s + w - adm)
        stretch = {"waves": hi - lo, "prompts": prompts,
                   "decode_positions": positions}
    name_dev = (torch.cuda.get_device_name(device) if device.type == "cuda"
                else "cpu")
    record = {
        "config": sizes, "workload": wl,
        "batch": traffic.clients, "setup_s": setup_s, "spans": spans,
        "window": window, "trace": tr, "stretch": stretch,
        "packs": _pack_shapes(config, params), "device_name": name_dev,
        "peaks": peaks(name_dev),
    }
    result = {
        "correct": verdict["correct"],
        "attempted": window.admitted,
        "failed": verdict["failed"],
        "metrics": {},
        "device": {"platform": "gpu" if device.type == "cuda" else "cpu",
                   "kind": name_dev,
                   "count": cell.chips, "memory_peak_bytes": int(peak)},
    }
    if tr is not None:
        busy = trace_mod.busy_seconds(tr.kernels, *tr.stretch)
        result["device"].update(busy_s=busy, window_s=tr.window_s)
        result["breakdown"] = trace_mod.breakdown(tr)
    for m in cell.metric_entries(trace):
        v = spec.load_metric(m["name"], cell.root).read(record)
        if v is not None:
            result["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}
    result["samples"] = {"ttft": len(window.ttft), "itl": len(window.itl),
                         "window_steps": len(window.steps),
                         "waves": n_waves,
                         "tokens_compared": verdict["tokens_compared"],
                         "requests_compared": len(verdict["compare"])}
    if extra is not None:
        result["also"] = extra
    result["compared"] = verdict["compared"]
    return result, record


def _pack_shapes(config: dict, params: dict) -> list:
    """(name, layers, K, N) of every 4-bit projection, from the weights'
    shapes: a stacked [L, K, N] leaf is L calls a step."""
    out = []
    for name in config["pud"]["packed"]:
        w = params
        for part in name.split("/"):
            w = w[part]
        shape = tuple(w.shape)
        layers = shape[0] if len(shape) == 3 else 1
        out.append((name, layers, shape[-2], shape[-1]))
    return out
