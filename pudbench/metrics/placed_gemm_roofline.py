"""The placed 4-bit GEMM's share of its roofline in the traced stretch:
the least time of every placed call the stretch made (bytes at the HBM
rate or int8 operations at the int8 rate, whichever is longer;
``harness/counts.placed_call``), summed, over the profiler's device time
of the placed kernels (``dp4a_kernel``, ``mma_kernel`` of
``csrc/placed_gemm.cu``), in %.

Calls: each decode wave runs every pack (each of its layers) on the
wave's rows; each prefill runs every pack but the unembed on the prompt's
rows and the unembed on its last row."""
import re

from pudbench.harness.counts import least_seconds, placed_call

PLACED = re.compile(r"(^|[\s:])(dp4a_kernel|mma_kernel)<")


def read(run):
    st, tr, pk = run["stretch"], run["trace"], run["peaks"]
    if st is None or tr is None or pk is None:
        return None
    lo, hi = tr.stretch
    dev = sum(min(t, hi) - max(s, lo) for n, s, t in tr.kernels
              if PLACED.search(n) and t > lo and s < hi)
    if dev <= 0:
        return None
    bits = run["config"]["pud"]["weight_bits"]
    least = 0.0
    for name, layers, k, n in run["packs"]:
        rows = [run["batch"]] * st["waves"]
        if name == "unembed/w":
            rows += [1] * len(st["prompts"])
        else:
            rows += list(st["prompts"])
        for r in rows:
            least += layers * least_seconds(placed_call(r, k, n, bits), pk)
    return 100.0 * least / dev
