"""Shared benchmark plumbing (port of ``benchmarks/common.py``): sizes,
timers and the CSV emitter.

Every benchmark prints a short ``#csv <name>`` block (stable, grep-able)
followed by a summary with the paper's numbers beside the measured ones,
and writes its rows to ``artifacts/bench_torch/<name>.json`` under the
repository root.  ``--full`` runs the paper-scale protocol (65,536
columns, 8,192 trials); the default is a 16,384-column subsample.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import pathlib
import time

ART = pathlib.Path(__file__).resolve().parents[3] / "artifacts" / "bench_torch"


@dataclasses.dataclass
class BenchScale:
    n_cols: int = 16384
    n_trials_maj5: int = 8192
    n_cols_arith: int = 2048
    n_trials_arith: int = 512
    full: bool = False
    # the benchmarks that launch kernels on their own configurations
    # (drift_recovery, placement) run again on the plain PyTorch versions
    # and raise unless every result is equal (``hold_to_plain``)
    check_plain: bool = False


def add_device_arg(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' runs the "
                         "plain PyTorch versions)")


def parse_scale(argv=None, description: str = ""
                ) -> tuple[BenchScale, str | None]:
    """(scale, device) from the reference's ``--full`` / ``--n-cols`` and
    ``--device``."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--full", action="store_true",
                    help="paper-scale protocol (65536 cols, slower)")
    ap.add_argument("--n-cols", type=int, default=None)
    add_device_arg(ap)
    args = ap.parse_args(argv)
    s = BenchScale()
    if args.full:
        s = BenchScale(n_cols=65536, n_cols_arith=4096, full=True)
    if args.n_cols:
        s = dataclasses.replace(s, n_cols=args.n_cols)
    return s, args.device


def plain_backend(plain: bool) -> dict:
    """``PUDSession.open``'s keywords for a run on the plain PyTorch
    versions (the ``reference`` backend and calibration method); none for
    the kernels."""
    return dict(backend="reference", method="reference") if plain else {}


def _same(a, b) -> bool:
    import torch
    if isinstance(a, torch.Tensor):
        return (isinstance(b, torch.Tensor) and a.shape == b.shape
                and a.dtype == b.dtype and torch.equal(a, b))
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(_same(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(_same(x, y) for x, y in zip(a, b)))
    return a == b


def hold_to_plain(name: str, kernels, plain) -> None:
    """Raise unless a benchmark's results on the kernels equal its rerun on
    the plain versions with the same inputs: rows, tables and tensors, bit
    for bit."""
    if not _same(kernels, plain):
        raise RuntimeError(f"{name}: the kernels' run differs from the "
                           "plain versions' on the same inputs")
    print(f"  {name}: kernels == plain versions on the same inputs, bit "
          "for bit", flush=True)


@contextlib.contextmanager
def timed(label: str):
    t0 = time.time()
    yield
    print(f"  [{label}: {time.time() - t0:.1f}s]", flush=True)


def emit(name: str, rows: list[dict], header: str | None = None) -> None:
    """Print a CSV block and persist it under ``ART/<name>.json``."""
    ART.mkdir(parents=True, exist_ok=True)
    (ART / f"{name}.json").write_text(json.dumps(rows, indent=1, default=str))
    if not rows:
        return
    cols = list(rows[0])
    print(f"\n#csv {name}")
    if header:
        print(f"# {header}")
    print(",".join(cols))
    for r in rows:
        print(",".join(_fmt(r[c]) for c in cols))
    print()


def _fmt(v) -> str:
    if isinstance(v, float):
        return f"{v:.6g}"
    return str(v)


def ratio_line(label: str, measured: float, target: float,
               tol: float = 0.15) -> str:
    ok = abs(measured - target) <= tol * abs(target)
    flag = "OK " if ok else "DEV"
    return (f"  {flag} {label}: measured {measured:.3f} vs paper "
            f"{target:.3f} ({measured / target:.2f}x of target)")
