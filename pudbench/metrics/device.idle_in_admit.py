"""Share of the traced stretch in which the host is inside an
``engine.admit`` span (program span) and no device operation runs (the
union of the profiler's CUDA intervals), in %.  The spans' stamps are on
the profiler's clock (the Unix epoch); None without device intervals."""
from pudbench.harness import program


def read(run):
    return program.idle_inside(run, "engine.admit")
