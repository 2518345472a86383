"""Share of the traced stretch in which no device operation ran (the
union of the profiler's CUDA intervals), in %."""
from pudbench.harness.trace import busy_seconds


def read(run):
    tr = run["trace"]
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - busy_seconds(tr.kernels, *tr.stretch)
                    / tr.window_s)
