#!/usr/bin/env python3
"""Run one cell of the benchmark once and print its result line.

    python3 pudbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout on a machine with the cell's CUDA devices.
The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, then ``samples`` and last ``compared`` (each number the
check compared, beside its limit; also the last lines of standard error).
Without a CUDA device, without the port beside the benchmark, or with JAX
or the JAX package loaded, it prints no result and exits non-zero.
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys
import time

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def process_start() -> float:
    """Wall-clock time at which this process started (Linux), else now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(x.split()[1]) for x in f if x.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


T_PROC = process_start()
ROOT = pathlib.Path(__file__).resolve().parents[1]


def _cache_env() -> None:
    """Every build and kernel cache at a fixed path inside the checkout;
    one host thread for CPU tensor work (the host drives the card, and
    idle worker threads only take its cores)."""
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "1"
    base = ROOT / ".pudbench-cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(base / sub)
    os.environ["USE_FLAX"] = "0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"no port under {ROOT / 'src'}: the benchmark runs the "
              "checkout's repro_torch", file=sys.stderr)
        return 2
    _cache_env()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from pudbench.harness import spec
    cell = spec.load_cell(args.workload)
    import torch
    torch.set_num_threads(1)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    from pudbench.harness import cell as cell_mod
    result, _ = cell_mod.run(args.workload, args.seed, args.seconds,
                             bool(args.trace), t_proc=T_PROC)
    loaded = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if loaded:
        print(f"forbidden modules loaded: {loaded}", file=sys.stderr)
        return 4
    for key, v in result["compared"].items():
        print(f"compared {key} {v['value']} limit {v['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
