"""Host wall of one decode wave (the engine's ``decode_wall_s`` per
step), over the window's steps outside the traced stretch, in ms."""
from pudbench.harness.counters import counters


def read(run):
    c = counters(run)
    if c["steps"] <= 0:
        return None
    return 1e3 * c["decode_wall_s"] / c["steps"]
