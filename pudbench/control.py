#!/usr/bin/env python3
"""The control of a cell's comparison, and the program's reading beside
it, on the chip at the cell's own size.

    python3 pudbench/control.py --workload <cell> --seeds 11,12,13 \
        --seconds 10

For each seed: one run of the cell (a window of ``--seconds`` at the
cell's load), then the reference twice over the same prompts and served
tokens: in the configuration's precision, and one step below it (``fp8``
operands in every bf16 product).  It prints, per seed, the program's
widest gap (the lower reading of the limit) and the control's: the gap,
in the configuration-precision reference's logits, of the token the
lower precision puts first (the upper reading).  The benchmark's own runs
never run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import run as entry  # noqa: F401  (sets the cache paths, process start)


def control_reading(inp: dict) -> dict:
    import torch

    from pudbench.harness import check
    job = check.job_for(inp["config"], inp["traffic"], inp["completions"],
                        inp["n_waves"], inp["verdict"]["compare"])
    ref = check.reference(inp["config"])
    with torch.inference_mode():
        t = time.perf_counter()
        lb = ref.logits(inp["sizes"], inp["params"], job, "bf16")
        t_ref = time.perf_counter() - t
        lc = ref.logits(inp["sizes"], inp["params"], job, "fp8")
    top = {k: lc[k].argmax(dim=-1).tolist() for k in lc}
    g = check.gaps(lb, top)
    agree = sum(int((lb[k].argmax(-1) == lc[k].argmax(-1)).sum()) for k in lb)
    n = sum(len(v) for v in g.values())
    return {"control_widest_gap": max(float(v.max()) for v in g.values()),
            "control_top_agree": agree, "tokens": n,
            "reference_s": t_ref}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    entry._cache_env()
    sys.path[:0] = [str(entry.ROOT), str(entry.ROOT / "src")]
    from pudbench.harness import cell
    for seed in [int(s) for s in args.seeds.split(",")]:
        t = time.time()
        res, _ = cell.run(args.workload, seed, args.seconds, False,
                          t_proc=t, also=control_reading)
        print(json.dumps({"seed": seed,
                          "program_widest_gap":
                              res["compared"]["widest_gap"]["value"],
                          "bookkeeping": res["compared"]["bookkeeping"]
                          ["value"], **res["also"],
                          "wall_s": time.time() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
