"""Continuous-batching serving engine: aggregate tokens/s against batch
size, tensor-parallel shard scaling, and the heavy-tail latency trace
(port of ``benchmarks/serving_engine.py``).

    python -m repro_torch.benchmarks.serving_engine [--device cpu]
        [--compare BASELINE.json] [--tolerance 0.15]

Four sections:

  * **DRAM-side model** per batch size: the placement-derived
    ``FleetPerfModel`` batched rate, which must rise monotonically from
    batch 1 up to the occupancy-derived optimum;
  * **measured engine**: the ``ServingEngine`` decoding a queue of
    requests through the placed bit-plane GEMM on the qwen3 smoke model:
    slot occupancy and decode wall tokens/s (on the CPU, the plain
    versions: the scheduler's health, not a device rate);
  * **shard scaling**: the same rate model composed into a
    ``FleetPerfAggregate`` at 1, 2 and 4 model shards, widths from the
    full arch's projections split on window-block boundaries
    (``shard_column_slices``); host arithmetic, no device;
  * **heavy-tail trace**: lognormal arrivals, mixed prompt lengths and a
    repeat mix, replayed on the whole-request engine and on the chunked +
    prefix-cached one.  Latencies come from a deterministic modeled clock
    (one ``STEP_MS`` per decode wave plus the prefill rows computed), so
    they depend on the scheduler alone: the port's rows equal the
    reference's.  The run raises unless chunked + cached beats the
    baseline's p99; ``--compare`` gates the geomean-normalised scores
    against a baseline file (the reference's ``BENCH_serving.json`` reads
    as one).

The payload goes to ``artifacts/bench_torch/BENCH_serving_torch.json``;
the reference's ``BENCH_serving.json`` is read (``--compare``), never
written.
"""
from __future__ import annotations

import argparse
import json
import math
import pathlib

import numpy as np
import torch

from repro_torch.configs import get
from repro_torch.core.calibrate import CalibrationConfig
from repro_torch.core.fleet import FleetConfig
from repro_torch.core.rng import generator
from repro_torch.devices import resolve_device
from repro_torch.models.params import init_params
from repro_torch.pud.gemv import (FleetPerfAggregate, FleetPerfModel,
                                  PUDGemvConfig)
from repro_torch.pud.placement import shard_column_slices
from repro_torch.runtime.engine import Request, ServingEngine
from repro_torch.runtime.session import PUDSession

from . import common
from .common import add_device_arg, emit

ARCH = "qwen3-1.7b"
N_REQUESTS = 6
PROMPT_LEN = 8
GEN = 4
SHARD_COUNTS = (1, 2, 4)
PAYLOAD = "BENCH_serving_torch.json"

# Heavy-tail trace shape
TRACE_REQUESTS = 24
TRACE_GEN = 6
TRACE_MAX_LEN = 48
TRACE_CHUNK = 8
STEP_MS = 5.0           # modeled decode-wave cost (ratios matter, not units)
TOLERANCE = 0.15


def _session(device) -> PUDSession:
    s = PUDSession.open(
        ARCH,
        grid=FleetConfig(n_channels=1, n_banks=1, n_subarrays=8,
                         n_cols=1024),
        calib=CalibrationConfig(n_iterations=6, n_samples=128),
        seed=11, n_trials_ecr=256, device=device)
    s.calibrate()
    return s


def _full_arch_projections(spec) -> list[tuple[int, int]]:
    """(n_cols, n_slices) of every projection the packer packs for the FULL
    arch config (the gated-FFN triplet per layer plus the unembed), from
    the config alone."""
    cfg = spec.make_model().cfg
    return [(cfg.d_ff, cfg.n_layers), (cfg.d_ff, cfg.n_layers),
            (cfg.d_model, cfg.n_layers), (cfg.vocab, 1)]


def shard_scaling_rows(pm, flops_tok: float, spec) -> list[dict]:
    """Aggregate modeled tokens/s at 1/2/4 model shards of one data lane.

    Widths split the full arch's projections as the fleet packs them:
    per-tensor window-block boundaries, remainder blocks to earlier
    shards.  Efficiency below 1 measures only that raggedness (the
    slowest-shard bound of ``FleetPerfAggregate``).
    """
    if not isinstance(pm, FleetPerfModel):
        pm = FleetPerfModel.from_table([1.0 - pm.error_free_frac])
    projections = _full_arch_projections(spec)
    rows = []
    for n_shards in SHARD_COUNTS:
        widths = [0] * n_shards
        for n_cols, n_slices in projections:
            spans, _ = shard_column_slices(n_cols, n_shards)
            for m, (lo, hi) in enumerate(spans):
                widths[m] += (hi - lo) * n_slices
        agg = FleetPerfAggregate(shards=(pm,) * n_shards, n_data=1,
                                 shard_widths=tuple(widths))
        rows.append({
            "n_shards": n_shards,
            "shard_fraction": agg.shard_fraction,
            "aggregate_tok_s": agg.tokens_per_second(flops_tok),
            "scaling_efficiency": agg.scaling_efficiency(flops_tok),
        })
    return rows


# ---------------------------------------------------------------------------
# Heavy-tail latency trace
# ---------------------------------------------------------------------------


def build_trace(vocab: int, n: int = TRACE_REQUESTS, seed: int = 7):
    """The reference's deterministic heavy-tail trace, from numpy's
    generator: [(arrival step, request id, prompt tokens)].

    Lognormal inter-arrival gaps (in scheduler steps), mixed prompt
    lengths, ~1/4 exact repeats of three popular prompts (full prefix
    hits) and ~1/3 fresh questions behind one shared 12-token system
    prompt (chunk-aligned partial hits).
    """
    rng = np.random.default_rng(seed)
    sysp = rng.integers(0, vocab, size=12).astype(np.int32)
    popular = [rng.integers(0, vocab, size=s).astype(np.int32)
               for s in (9, 14, 20)]
    trace, step = [], 0
    for i in range(n):
        step += int(rng.lognormal(mean=0.0, sigma=1.2))
        kind = rng.choice(["repeat", "shared", "cold"], p=[0.25, 0.35, 0.4])
        if kind == "repeat":
            tokens = popular[int(rng.integers(len(popular)))]
        elif kind == "shared":
            tail = rng.integers(0, vocab,
                                size=int(rng.integers(3, 9))).astype(np.int32)
            tokens = np.concatenate([sysp, tail])
        else:
            s = int(np.clip(rng.lognormal(mean=2.2, sigma=0.6), 3,
                            TRACE_MAX_LEN - TRACE_GEN - 1))
            tokens = rng.integers(0, vocab, size=s).astype(np.int32)
        trace.append((step, i, tokens))
    return trace


def _replay(engine, trace) -> dict:
    """Step-driven replay on the modeled clock: each scheduling step costs
    one decode wave (``STEP_MS``) plus the prefill rows it computed at one
    wave-token each (``STEP_MS / batch``); an idle step still costs a
    wave.  Deterministic by construction."""
    per_wave = STEP_MS / engine.batch_size
    rep = engine.scheduler_report()
    waves0, pt0 = rep["steps"], rep["prefilled_tokens"]
    pc0 = rep.get("prefix_cache", {"hits": 0, "misses": 0})
    submit_v, e2e, per_tok = {}, [], []
    i, step, vclock = 0, 0, 0.0
    while i < len(trace) or engine.n_pending or engine.n_active:
        while i < len(trace) and trace[i][0] <= step:
            _, rid, tokens = trace[i]
            submit_v[rid] = vclock
            engine.submit(Request(request_id=rid, tokens=tokens,
                                  max_new_tokens=TRACE_GEN))
            i += 1
        comps = engine.step()
        rep = engine.scheduler_report()
        cost = ((rep["steps"] - waves0) * STEP_MS
                + (rep["prefilled_tokens"] - pt0) * per_wave)
        waves0, pt0 = rep["steps"], rep["prefilled_tokens"]
        vclock += cost if cost > 0 else STEP_MS
        for c in comps:
            lat = vclock - submit_v[c.request_id]
            e2e.append(lat)
            per_tok.append(lat / max(1, len(c.tokens)))
        step += 1
    pc1 = engine.scheduler_report().get("prefix_cache", pc0)
    hits = pc1["hits"] - pc0["hits"]
    misses = pc1["misses"] - pc0["misses"]
    e2e_ms = np.asarray(e2e)
    tok_ms = np.asarray(per_tok)
    return {
        "requests": len(e2e),
        "p50_e2e_ms": float(np.percentile(e2e_ms, 50)),
        "p99_e2e_ms": float(np.percentile(e2e_ms, 99)),
        "p50_tok_ms": float(np.percentile(tok_ms, 50)),
        "p99_tok_ms": float(np.percentile(tok_ms, 99)),
        "hit_rate": hits / (hits + misses) if hits + misses else 0.0,
    }


def run_trace(model, params) -> list[dict]:
    """Replay the same heavy-tail trace on the whole-request baseline and
    on the chunked + prefix-cached engine; one row per mode."""
    trace = build_trace(model.cfg.vocab)
    modes = [
        ("baseline", {}),
        ("chunked_cached", {"chunk_prefill": TRACE_CHUNK,
                            "prefix_cache": True}),
    ]
    rows = []
    for mode, kw in modes:
        engine = ServingEngine(model, params, max_len=TRACE_MAX_LEN,
                               batch_size=4, **kw)
        m = _replay(engine, trace)
        m["mode"] = mode
        # the gate's score: inverse p99 e2e (higher is better)
        m["score"] = 1e3 / m["p99_e2e_ms"]
        rows.append(m)
    return rows


def compare_trace_rows(current: list[dict], baseline: list[dict], *,
                       tolerance: float = TOLERANCE) -> list[str]:
    """Regression gate of the trace scores against a baseline's rows,
    geomean-normalised per run: a uniformly faster or slower machine
    cancels, only a mode's standing relative to the others can regress."""
    cur = {r["mode"]: max(float(r["score"]), 1e-12) for r in current}
    base = {r["mode"]: max(float(r["score"]), 1e-12) for r in baseline}
    failures = [f"baseline mode {m} missing from this run"
                for m in sorted(set(base) - set(cur))]
    shared = sorted(set(base) & set(cur))
    if not shared:
        return failures + ["no modes shared with the baseline"]
    cur_gm = math.exp(sum(math.log(cur[m]) for m in shared) / len(shared))
    base_gm = math.exp(sum(math.log(base[m]) for m in shared) / len(shared))
    for m in shared:
        ratio = (cur[m] / cur_gm) / (base[m] / base_gm)
        if ratio < 1.0 - tolerance:
            failures.append(
                f"{m}: relative p99 score is {ratio:.3f} of the committed "
                f"baseline (gate: >= {1.0 - tolerance:.2f})")
    return failures


def _prompts(vocab: int, device) -> list[torch.Tensor]:
    g = generator(3, "serving-engine-prompts")
    return [torch.randint(0, vocab, (PROMPT_LEN,), generator=g,
                          dtype=torch.int32).to(device)
            for _ in range(N_REQUESTS)]


def run(scale=None, device=None) -> tuple[list[dict], list[dict]]:
    """The batch sweep (model rate and measured engine per batch size) and
    the shard-scaling rows."""
    dev = resolve_device(device)
    spec = get(ARCH)
    model = spec.make_smoke()
    params = init_params(model.param_defs(), 0, dev)

    session = _session(dev)
    session.pack(params, PUDGemvConfig(weight_bits=4), name="engine-bench")
    flops_tok = 2 * spec.n_active_params
    pm = session.placement_perf_model() or session.tuned_perf_model()
    opt = session.optimal_batch_size()
    prompts = _prompts(model.cfg.vocab, dev)

    batches = sorted({1, 2, 4, opt} | {min(opt + 4, 2 * opt)})
    rows = []
    for bs in batches:
        engine = ServingEngine(model, session.packed.params,
                               session=session, max_len=PROMPT_LEN + GEN + 1,
                               batch_size=bs)
        engine.run([Request(request_id=i, tokens=p, max_new_tokens=GEN)
                    for i, p in enumerate(prompts)])
        sched = engine.scheduler_report()
        rows.append({
            "batch_size": bs,
            "is_optimum": bs == opt,
            "model_tok_s": pm.batched_tokens_per_second(flops_tok, bs)
            if hasattr(pm, "batched_tokens_per_second")
            else pm.tokens_per_second(flops_tok),
            "batch_speedup": (pm.batch_speedup(bs)
                              if hasattr(pm, "batch_speedup") else 1.0),
            "steps": sched["steps"],
            "slot_occupancy": sched["slot_occupancy"],
            "wall_tok_s": sched["wall_tok_s"],
        })
    return rows, shard_scaling_rows(pm, flops_tok, spec)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.benchmarks.serving_engine",
        description="Serving-engine benchmark: batch sweep, shard scaling, "
                    "and the heavy-tail latency trace with a baseline "
                    "regression gate.")
    ap.add_argument("--full", action="store_true",
                    help="accepted for benchmark-CLI symmetry")
    ap.add_argument("--compare", metavar="BASELINE.json",
                    help="gate the trace scores against a baseline file "
                         "(rows with mode and score); non-zero exit on "
                         "regression")
    ap.add_argument("--tolerance", type=float, default=TOLERANCE,
                    help="allowed relative score drop (default %(default)s)")
    add_device_arg(ap)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    rows, shard_rows = run(device=dev)
    emit("serving_engine", rows,
         header=f"{ARCH} smoke, {N_REQUESTS} requests x {GEN} tokens, "
                f"placed PUD path on {dev}")
    print("Continuous-batching engine (DRAM-side model + measured "
          "scheduler):")
    for r in rows:
        tag = "  <- occupancy-derived optimum" if r["is_optimum"] else ""
        print(f"  batch {r['batch_size']:>3d}: "
              f"{r['model_tok_s']:8.2f} aggregate tok/s model "
              f"({r['batch_speedup']:5.2f}x), "
              f"{r['steps']:>3d} steps, "
              f"slot occupancy {r['slot_occupancy']:.1%}, "
              f"{r['wall_tok_s']:6.1f} tok/s decode wall on {dev.type}{tag}")
    opt_bs = max(r["batch_size"] for r in rows if r["is_optimum"])
    up_to_opt = [r["model_tok_s"] for r in rows if r["batch_size"] <= opt_bs]
    mono = all(a < b for a, b in zip(up_to_opt, up_to_opt[1:]))
    print(f"  aggregate tokens/s monotone up to the optimum: "
          f"{'OK' if mono else 'VIOLATION'}")
    if not mono:
        raise AssertionError(
            "batched rate must increase monotonically up to the "
            f"occupancy-derived optimum; got {up_to_opt}")

    emit("serving_engine_sharded", shard_rows,
         header=f"{ARCH} FULL geometry, tensor-parallel model shards of "
                "one data lane (FleetPerfAggregate, device-free)")
    print("Tensor-parallel shard scaling (modeled, full arch geometry):")
    for r in shard_rows:
        print(f"  {r['n_shards']} shard(s): "
              f"{r['aggregate_tok_s']:8.2f} aggregate tok/s, "
              f"widest shard {r['shard_fraction']:.1%} of columns, "
              f"scaling efficiency {r['scaling_efficiency']:.1%}")
    agg1 = shard_rows[0]["aggregate_tok_s"]
    agg4 = shard_rows[-1]["aggregate_tok_s"]
    if agg4 < 2.0 * agg1:
        raise AssertionError(
            "4-shard aggregate modeled tokens/s must be at least 2x the "
            f"single-shard rate; got {agg4:.2f} vs {agg1:.2f}")
    print(f"  4-shard aggregate {agg4 / agg1:.2f}x single shard "
          f"(acceptance floor 2.0x): OK")

    model = get(ARCH).make_smoke()
    params = init_params(model.param_defs(), 0, dev)
    trace_rows = run_trace(model, params)
    emit("serving_trace", trace_rows,
         header=f"{ARCH} smoke, {TRACE_REQUESTS}-request heavy-tail trace "
                f"(lognormal arrivals, repeat mix), chunk={TRACE_CHUNK}, "
                f"modeled-clock latencies")
    print("Heavy-tail latency trace (same trace, both engines, modeled "
          "clock):")
    for r in trace_rows:
        print(f"  {r['mode']:>15s}: e2e p50 {r['p50_e2e_ms']:8.1f} ms, "
              f"p99 {r['p99_e2e_ms']:8.1f} ms | per-token p50 "
              f"{r['p50_tok_ms']:6.1f} ms, p99 {r['p99_tok_ms']:6.1f} ms | "
              f"hit rate {r['hit_rate']:.1%}")
    by_mode = {r["mode"]: r for r in trace_rows}
    base_p99 = by_mode["baseline"]["p99_e2e_ms"]
    chunk_p99 = by_mode["chunked_cached"]["p99_e2e_ms"]

    if args.compare:
        baseline = json.loads(pathlib.Path(args.compare).read_text())
        failures = compare_trace_rows(trace_rows, baseline.get("rows", []),
                                      tolerance=args.tolerance)
        if failures:
            for f in failures:
                print(f"  REGRESSION {f}")
            raise SystemExit(
                f"serving_engine: {len(failures)} trace mode(s) regressed "
                f"beyond --tolerance {args.tolerance}")
        print(f"  compare: OK vs {args.compare} "
              f"(tolerance {args.tolerance})")

    out = common.ART / PAYLOAD
    out.write_text(json.dumps({
        "trace": {"requests": TRACE_REQUESTS, "gen": TRACE_GEN,
                  "chunk": TRACE_CHUNK, "max_len": TRACE_MAX_LEN},
        "device": str(dev), "rows": trace_rows}, indent=1, default=str))
    print(f"  wrote {out}")

    if by_mode["chunked_cached"]["hit_rate"] <= 0.0:
        raise AssertionError(
            "heavy-tail trace produced no prefix-cache hits: the repeat "
            "mix is broken")
    if chunk_p99 >= base_p99:
        raise AssertionError(
            "chunked+cached p99 e2e latency must beat the whole-request "
            f"baseline on the same trace; got {chunk_p99:.1f} ms vs "
            f"{base_p99:.1f} ms")
    print(f"  chunked+cached p99 {chunk_p99:.1f} ms < baseline "
          f"{base_p99:.1f} ms ({base_p99 / chunk_p99:.2f}x better): OK")
    return 0


def report(scale=None, device=None) -> None:
    """The harness's entry: no baseline gate."""
    rc = main(["--device", str(device)] if device is not None else [])
    if rc:
        raise RuntimeError(f"serving_engine exited {rc}")


if __name__ == "__main__":
    raise SystemExit(main())
