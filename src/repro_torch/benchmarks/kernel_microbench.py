"""Per-kernel microbenchmark: weight traffic and tokens per second over the
format matrix, with tuned launch plans (port of
``benchmarks/kernel_microbench.py``).

Sweeps the four entries (GEMV / GEMM x unplaced / placed) over both
storage formats (dense one byte per bit, bit-packed words) and both modes
(``planes``, ``folded``; the CUDA kernels run one schedule for both) at
one 2048 x 2048 4-bit projection, B 1 and B 8:

  * ``weight_bytes_per_token``: measured from the weight operand the
    kernel reads per token (planes, plus ``col_ids`` when placed).  The
    bit-packed rows must come in at least 4x under the dense ones, else
    the run raises;
  * ``tokens_per_second`` / ``wall_ms``: on the card, CUDA events with the
    L2 flushed (``autotune.median_time``); on the CPU the plain versions'
    host time, never a device's;
  * ``tuned_tokens_per_second`` / ``tuned_speedup`` / ``tuned_plan``: the
    row again under the tuned plan of its tuning key, loaded from (or
    searched into) a ``TuningCache`` (``--tuning-cache``, default
    ``.pud-tuning-torch/`` at the repository root, per card); a tuned plan
    that times slower than the heuristic here keeps the heuristic.  Tuning
    needs the card: on the CPU these columns are None.

Every output is held to the plain version's on the same inputs.  Writes
its rows to ``artifacts/bench_torch/`` (``kernel_microbench.json`` and
the payload ``BENCH_kernels_torch.json``), never to the reference's
``BENCH_kernels.json``.  ``--compare BASELINE.json`` gates this run
against a baseline payload the caller gives: each row's tokens/s,
normalized by its run's geometric mean unless ``--absolute``, may fall at
most ``--tolerance`` below the baseline's.

    python -m repro_torch.benchmarks.kernel_microbench [--device cpu]
        [--compare FILE] [--no-tune | --tune-only | --force-tune]
"""
from __future__ import annotations

import argparse
import json
import math
import pathlib

import numpy as np
import torch

from repro_torch.core.rng import generator
from repro_torch.devices import resolve_device
from repro_torch.kernels import ref
from repro_torch.kernels.autotune import (MAX_CANDIDATES, median_time,
                                          tune_kernel, tuning_key)
from repro_torch.kernels.backends import get_backend
from repro_torch.pud.gemv import pack_linear
from repro_torch.pud.packed import to_dense
from repro_torch.pud.placement import PlacementRequest, plan_placement
from repro_torch.runtime.tune import TuningCache, device_tag

from . import common
from .common import add_device_arg, emit, hold_to_plain

ROOT = pathlib.Path(__file__).resolve().parents[3]
DEFAULT_TUNING_DIR = ROOT / ".pud-tuning-torch"
PAYLOAD = "BENCH_kernels_torch.json"

K, N, WB = 2048, 2048, 4
MIN_REDUCTION = 4.0
TOLERANCE = 0.15


def _weight_bytes(planes, col_ids=None) -> int:
    """Weight bytes one token reads: the whole weight operand once, and the
    gather map when placed."""
    total = planes.numel() * planes.element_size()
    if col_ids is not None:
        total += col_ids.numel() * 4
    return int(total)


def _placed_fixture(pt, device):
    """A placed pack of the same projection on a ~3%-faulty device:
    (dense window, bit-packed window, col_ids, window_block)."""
    masks = np.random.default_rng(0).random((2, 4096)) < 0.03
    plan = plan_placement(masks, [PlacementRequest("t", N, 0)])
    tp = plan.entries["t"]
    dense = to_dense(pt)
    idx = torch.as_tensor(np.asarray(tp.local_cols), dtype=torch.int32,
                          device=device)
    window = torch.zeros(dense.planes.shape[:2] + (tp.region_size,),
                         dtype=torch.int8, device=device)
    window[:, :, idx.long()] = dense.planes
    return window, ref.pack_plane_words(window), idx, tp.window_block


def problems(device) -> list[dict]:
    """The 8 tuning problems (B 1 and 8 x unplaced / placed x dense /
    bit-packed), each with its operands.  Rows split each by mode; tuning
    keys do not (both modes launch the same kernel)."""
    gen = generator(0, "kernel-microbench", device=device)
    w = 0.05 * torch.randn((K, N), generator=gen, device=device)
    pt = pack_linear(w, WB)                    # bit-packed (default)
    dense = to_dense(pt)
    window_dense, window_words, col_ids, pwb = _placed_fixture(pt, device)
    out = []
    for b, entry in ((1, "gemv"), (8, "gemm")):
        x = torch.randn((b, K), generator=gen, device=device)
        xq = torch.clamp(torch.round(x * 8), -127, 127).to(torch.int8)
        for layout_name, planes, cols, kwargs in (
            ("logical", dense.planes, None, {}),
            ("logical", pt.planes, None,
             {"layout": "bitpack8", "logical_k": K}),
            ("placed", window_dense, col_ids, {"window_block": pwb}),
            ("placed", window_words, col_ids,
             {"layout": "bitpack8", "logical_k": K, "window_block": pwb}),
        ):
            kwargs = {"layout": "dense", **kwargs}
            out.append({
                "b": b, "entry": entry, "layout_name": layout_name,
                "format": ("bitpacked" if kwargs["layout"] == "bitpack8"
                           else "dense"),
                "xq": xq, "planes": planes, "cols": cols, "kwargs": kwargs,
                "key": tuning_key(entry, b, K, N, WB, kwargs["layout"],
                                  cols is not None),
            })
    return out


def tune_all(probs: list[dict], cache: TuningCache | None, *,
             reps: int = 5, max_candidates: int = MAX_CANDIDATES,
             force: bool = False) -> dict:
    """Load or search the tuned plan of every key on the card; returns
    ``{key: TunedPlan}``; winners persist into ``cache``."""
    plans = {}
    for p in probs:
        key = p["key"]
        plan = None if (force or cache is None) else cache.load(key)
        if plan is not None:
            print(f"  tuning hit    {key}: {plan.to_dict() or 'heuristic'}")
        else:
            kw = p["kwargs"]
            res = tune_kernel(
                p["entry"], p["xq"], p["planes"], col_ids=p["cols"],
                window_block=kw.get("window_block"), layout=kw["layout"],
                logical_k=kw.get("logical_k"), reps=reps,
                max_candidates=max_candidates)
            plan = res.plan
            if cache is not None:
                cache.save(key, plan, res.to_stats())
            print(f"  tuning search {key}: {plan.to_dict() or 'heuristic'}"
                  f"  {res.speedup:.2f}x over heuristic "
                  f"({res.n_candidates} candidates)")
        plans[key] = plan
    return plans


def _row_fn(be, p, mode, plan=None):
    """The timed call of one row, optionally under a tuned plan."""
    kwargs = dict(p["kwargs"])
    if plan is not None:
        kwargs["tile_plan"] = plan
        mode = plan.mode or mode
    if p["cols"] is None:
        fn = be.gemv if p["entry"] == "gemv" else be.matmul
        return lambda: fn(p["xq"], p["planes"], mode, **kwargs)
    fn = be.gemv_placed if p["entry"] == "gemv" else be.matmul_placed
    return lambda: fn(p["xq"], p["planes"], p["cols"], mode, **kwargs)


def run(probs: list[dict], plans: dict | None = None, *, reps: int = 5,
        device=None) -> list[dict]:
    """One row per problem and mode; every output (tuned ones too) held to
    the plain version's on the same inputs."""
    dev = resolve_device(device)
    be, plain = get_backend("cuda"), get_backend("reference")
    rows, kernels, plains = [], [], []
    for p in probs:
        b = p["b"]
        tuned_plan = (plans or {}).get(p["key"])
        want = _row_fn(plain, p, "folded")()
        for mode in ("planes", "folded"):
            secs, out = median_time(_row_fn(be, p, mode), dev, reps=reps)
            kernels.append(out)
            plains.append(want)
            tuned_secs, plan_used = secs, None
            if tuned_plan is not None and not tuned_plan.is_default():
                t, tout = median_time(_row_fn(be, p, mode, tuned_plan), dev,
                                      reps=reps)
                kernels.append(tout)
                plains.append(want)
                if t < secs:                   # else: the heuristic stays
                    tuned_secs, plan_used = t, tuned_plan
            tuned = plans is not None
            rows.append({
                "kernel": p["entry"], "layout": p["layout_name"],
                "format": p["format"], "mode": mode, "batch": b,
                "shape": f"{b}x{K}x{N}@{WB}b", "device": str(dev),
                "weight_bytes_per_token": _weight_bytes(p["planes"],
                                                        p["cols"]),
                "ops_per_token": 2 * K * N,
                "tokens_per_second": b / secs,
                "wall_ms": 1e3 * secs,
                "tuned_tokens_per_second": b / tuned_secs if tuned else None,
                "tuned_speedup": secs / tuned_secs if tuned else None,
                "tuned_plan": plan_used.to_dict() if plan_used else None,
            })
    hold_to_plain("kernel_microbench", kernels, plains)
    return rows


def check_reduction(rows: list[dict]) -> dict:
    """Measured packed-vs-dense weight-traffic reduction per (kernel,
    layout); raises under ``MIN_REDUCTION``."""
    out = {}
    for r in rows:
        out.setdefault((r["kernel"], r["layout"], r["format"]),
                       r["weight_bytes_per_token"])
    summary = {}
    for kernel, layout in sorted({(k, lo) for k, lo, _ in out}):
        red = out[(kernel, layout, "dense")] / out[(kernel, layout,
                                                    "bitpacked")]
        summary[f"{kernel}/{layout}"] = red
        if red < MIN_REDUCTION:
            raise AssertionError(
                f"{kernel}/{layout}: measured weight-traffic reduction "
                f"{red:.2f}x < {MIN_REDUCTION}x: the packed path is not "
                "bit-packed")
    return summary


def _row_key(r: dict) -> str:
    return (f"{r['kernel']}/{r['layout']}/{r['format']}/{r['mode']}"
            f"/b{r['batch']}")


def compare_rows(current: list[dict], baseline: list[dict], *,
                 tolerance: float = TOLERANCE,
                 absolute: bool = False) -> tuple[list[str], list[dict]]:
    """Gate ``current`` against a baseline's rows: a failure per missing
    baseline row and per row whose tokens/s (normalized by each run's
    geometric mean over the shared rows, unless ``absolute``) fell below
    ``1 - tolerance`` of the baseline's.  Returns (failures, report)."""
    cur = {_row_key(r): max(float(r["tokens_per_second"]), 1e-12)
           for r in current}
    base = {_row_key(r): max(float(r["tokens_per_second"]), 1e-12)
            for r in baseline}
    failures = [f"baseline row {k} missing from this run"
                for k in sorted(set(base) - set(cur))]
    shared = sorted(set(base) & set(cur))
    if not shared:
        return failures + ["no rows shared with the baseline"], []
    cur_gm = base_gm = 1.0
    if not absolute:
        cur_gm = math.exp(sum(math.log(cur[k]) for k in shared)
                          / len(shared))
        base_gm = math.exp(sum(math.log(base[k]) for k in shared)
                           / len(shared))
    report = []
    for k in shared:
        ratio = (cur[k] / cur_gm) / (base[k] / base_gm)
        ok = ratio >= 1.0 - tolerance
        report.append({"row": k, "ratio": ratio, "ok": ok})
        if not ok:
            failures.append(f"{k}: relative tokens/s is {ratio:.3f} of the "
                            f"baseline (gate: >= {1.0 - tolerance:.2f})")
    return failures, report


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.benchmarks.kernel_microbench",
        description="Kernel microbenchmark with autotuning and a baseline "
                    "gate.")
    ap.add_argument("--full", action="store_true",
                    help="accepted for the harness (the shape is fixed)")
    ap.add_argument("--compare", metavar="BASELINE.json",
                    help="gate this run against a baseline payload; exits "
                         "nonzero on a regression")
    ap.add_argument("--tolerance", type=float, default=TOLERANCE,
                    help="allowed relative tokens/s drop per row "
                         "(default %(default)s)")
    ap.add_argument("--absolute", action="store_true",
                    help="compare raw tokens/s (one machine, A/B only)")
    ap.add_argument("--tuning-cache", metavar="DIR",
                    default=str(DEFAULT_TUNING_DIR),
                    help="TuningCache directory (default %(default)s)")
    g = ap.add_mutually_exclusive_group()
    g.add_argument("--no-tune", action="store_true",
                   help="no tuning: the tuned columns are None")
    g.add_argument("--tune-only", action="store_true",
                   help="search and persist every key's plan, then exit")
    ap.add_argument("--force-tune", action="store_true",
                    help="search again on a cache hit")
    ap.add_argument("--reps", type=int, default=5,
                    help="timed repetitions per measurement "
                         "(default %(default)s)")
    add_device_arg(ap)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    probs = problems(dev)
    tune = dev.type == "cuda" and not args.no_tune
    if not tune and args.tune_only:
        raise SystemExit("kernel_microbench: --tune-only needs the GPU")
    cache = (TuningCache(args.tuning_cache, device=device_tag(dev))
             if tune else None)
    plans = None
    if tune:
        plans = tune_all(probs, cache, reps=args.reps, force=args.force_tune)
        if args.tune_only:
            print(f"  tuned plans persisted under {cache.directory}")
            return 0
    elif dev.type != "cuda":
        print("  tuning needs the GPU: the tuned columns are None on "
              f"{dev}")

    rows = run(probs, plans, reps=args.reps, device=dev)
    reductions = check_reduction(rows)
    emit("kernel_microbench", rows,
         header="measured weight bytes per token; times: CUDA events with "
                "the L2 flushed on a GPU, the plain versions' host time on "
                "the CPU")
    if args.compare:
        baseline = json.loads(pathlib.Path(args.compare).read_text())
        failures, report = compare_rows(
            rows, baseline.get("rows", []) if isinstance(baseline, dict)
            else baseline, tolerance=args.tolerance, absolute=args.absolute)
        if report:
            worst = min(report, key=lambda r: r["ratio"])
            print(f"  compare: {len(report)} rows vs {args.compare}, worst "
                  f"relative ratio {worst['ratio']:.3f} ({worst['row']})")
        if failures:
            for f in failures:
                print(f"  REGRESSION {f}")
            raise SystemExit(f"kernel_microbench: {len(failures)} row(s) "
                             f"regressed beyond --tolerance {args.tolerance}")
        print(f"  compare: OK (tolerance {args.tolerance})")

    out = common.ART / PAYLOAD
    out.write_text(json.dumps({"shape": f"{K}x{N}@{WB}b",
                               "device": device_tag(dev),
                               "traffic_reduction": reductions,
                               "rows": rows}, indent=1, default=str))
    for name, red in sorted(reductions.items()):
        print(f"  {name}: bit-packed reads {red:.2f}x fewer weight "
              f"bytes/token than dense (>= {MIN_REDUCTION}x required)")
    tuned_up = [r for r in rows if r["tuned_plan"]]
    if tuned_up:
        best = max(tuned_up, key=lambda r: r["tuned_speedup"])
        print(f"  tuned plans beat the heuristic on {len(tuned_up)}/"
              f"{len(rows)} rows (best {best['tuned_speedup']:.2f}x on "
              f"{_row_key(best)})")
    print(f"  wrote {out}")
    return 0


def report(scale=None, device=None) -> None:
    """The harness's entry: defaults, tuning through the default cache on
    the card."""
    argv = ["--device", str(device)] if device is not None else []
    rc = main(argv)
    if rc:
        raise RuntimeError(f"kernel_microbench exited {rc}")


if __name__ == "__main__":
    raise SystemExit(main())
