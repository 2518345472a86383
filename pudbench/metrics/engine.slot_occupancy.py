"""Share of decode-wave rows that served a live request, over the
window's steps outside the traced stretch (``scheduler_report``
counters), in %."""
from pudbench.harness.counters import counters


def read(run):
    c = counters(run)
    if c["steps"] <= 0:
        return None
    return 100.0 * c["active_slot_steps"] / (c["steps"] * run["batch"])
