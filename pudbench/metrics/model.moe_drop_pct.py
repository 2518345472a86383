"""Routed (token, expert) pairs dropped by expert capacity over all
routed pairs, in the traced stretch, in %: the port's ``moe.dropped`` and
``moe.routed`` counters, which count only while a profiler records, keyed
by engine step; the stretch's steps follow the window's."""
from pudbench.harness import program


def read(run):
    routed = program.stretch_count(run, "moe.routed")
    if not routed:
        return None
    return 100.0 * program.stretch_count(run, "moe.dropped") / routed
