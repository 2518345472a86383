"""Benchmark harness: one benchmark per paper table or figure (port of
``benchmarks/run.py``).

    python -m repro_torch.benchmarks.run [--full] [--only NAME] [--list]
        [--device cpu]

Order: offset ladders (Fig. 3) -> Table I -> Frac sensitivity (Fig. 5) ->
reliability (Fig. 6) -> Algorithm-1 convergence -> fleet calibration ->
CUDA kernels vs plain versions -> kernel microbenchmark (traffic, tuned
plans) -> MVDRAM serving table -> serving engine (batch sweep, shard scaling,
heavy-tail trace) -> drift recovery (canary detect + hot swap) -> MAJX
generalization -> column placement -> roofline summary (reads the dry
run's records if present).

A raising benchmark is reported, the others still run, and the process
exits 1.
"""
from __future__ import annotations

import argparse
import sys
import time
import traceback
from typing import Callable

from .common import BenchScale, add_device_arg


def _fig3(scale, device):
    """Offset ladders (Fig. 3)."""
    from . import fig3_offsets
    fig3_offsets.report(scale, device)


def _table1(scale, device):
    """ECR + arithmetic throughput operating points (Table I)."""
    from . import table1
    table1.report(scale, device)


def _fig5(scale, device):
    """Frac-count sensitivity (Fig. 5)."""
    from . import fig5_frac_sensitivity
    fig5_frac_sensitivity.report(scale, device)


def _fig6(scale, device):
    """Temperature/retention reliability (Fig. 6)."""
    from . import fig6_reliability
    fig6_reliability.report(scale, device)


def _convergence(scale, device):
    """Algorithm-1 convergence trajectory."""
    from . import calibration_convergence
    calibration_convergence.report(scale, device)


def _fleet(scale, device):
    """Whole-grid fleet calibration engine + cached startup."""
    from . import fleet_calibration
    argv = (["--full"] if scale.full else []) + (
        ["--device", str(device)] if device is not None else [])
    rc = fleet_calibration.main(argv)
    if rc:
        raise RuntimeError(f"fleet_calibration exited {rc}")


def _kernels(scale, device):
    """CUDA kernels vs their plain versions (majx_sense, bit-plane GEMM)."""
    from . import kernel_bench
    kernel_bench.report(scale, device)


def _kernel_microbench(scale, device):
    """Per-kernel traffic + tokens/s: GEMV/GEMM x unplaced/placed x
    dense/bit-packed, planes vs folded, tuned plans (writes
    artifacts/bench_torch/BENCH_kernels_torch.json)."""
    from . import kernel_microbench
    kernel_microbench.report(scale, device)


def _serving(scale, device):
    """MVDRAM serving table: per-arch decode rates, baseline vs PUDTune."""
    from . import mvdram_serving
    mvdram_serving.report(scale, device)


def _serving_engine(scale, device):
    """Continuous-batching engine: tokens/s vs batch size, occupancy, shard
    scaling, heavy-tail latency trace (writes
    artifacts/bench_torch/BENCH_serving_torch.json)."""
    from . import serving_engine
    serving_engine.report(scale, device)


def _drift(scale, device):
    """Online drift recovery: detection latency, partial recal scope,
    hot swap without a stalled step (fails on any stalled step)."""
    from . import drift_recovery
    drift_recovery.report(scale, device)


def _majx(scale, device):
    """MAJX generalization (MAJ3/MAJ7)."""
    from . import majx_general
    majx_general.report(scale, device)


def _placement(scale, device):
    """Column placement: occupancy + tokens/s with/without placement."""
    from . import placement
    placement.report(scale, device)


def _roofline(scale, device):
    """Roofline summary from the dry run's records (if present)."""
    from . import roofline
    for mesh in ("single", "multi"):
        rows = roofline.load(mesh, "base")
        if rows:
            print(f"\n-- mesh: {mesh} ({len(rows)} cells)")
            print(roofline.fmt_table(rows))
        else:
            print(f"\n-- mesh: {mesh}: {roofline.hint(mesh)}")


BENCHES: dict[str, Callable[[BenchScale, object], None]] = {
    "fig3": _fig3,
    "table1": _table1,
    "fig5": _fig5,
    "fig6": _fig6,
    "convergence": _convergence,
    "fleet": _fleet,
    "kernels": _kernels,
    "kernel_microbench": _kernel_microbench,
    "serving": _serving,
    "serving_engine": _serving_engine,
    "drift": _drift,
    "majx": _majx,
    "placement": _placement,
    "roofline": _roofline,
}


def run_benches(names, scale: BenchScale, device=None) -> dict:
    """Run ``names`` in order; returns {name: (wall seconds, failed)}.  A
    raising benchmark's traceback is printed and the others still run."""
    out = {}
    for name in names:
        print(f"\n{'=' * 72}\n== {name}\n{'=' * 72}", flush=True)
        t0 = time.time()
        failed = False
        try:
            BENCHES[name](scale, device)
        except Exception:
            failed = True
            traceback.print_exc()
            print(f"[run] benchmark {name!r} FAILED", flush=True)
        out[name] = (time.time() - t0, failed)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--full", action="store_true",
                    help="paper-scale protocol (65536 columns; slower)")
    ap.add_argument("--only", default=None, choices=sorted(BENCHES))
    ap.add_argument("--list", action="store_true",
                    help="list registered benchmarks and exit")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    if args.list:
        for name, fn in BENCHES.items():
            print(f"{name:<14s} {(fn.__doc__ or '').strip()}")
        return 0
    scale = (BenchScale(n_cols=65536, n_cols_arith=4096, full=True)
             if args.full else BenchScale())

    t0 = time.time()
    names = [args.only] if args.only else list(BENCHES)
    walls = run_benches(names, scale, args.device)
    failures = [n for n, (_, failed) in walls.items() if failed]
    status = (f"{len(failures)} FAILED ({', '.join(failures)})" if failures
              else "all passed")
    print(f"\n{len(names)} benchmark(s) in {time.time() - t0:.0f}s: "
          f"{status}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
