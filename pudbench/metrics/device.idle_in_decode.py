"""Share of the traced stretch in which the host is inside an
``engine.decode`` span (program span: one decode wave, its enqueue and
its token read) and no device operation runs, in %.  None without device
intervals."""
from pudbench.harness import program


def read(run):
    return program.idle_inside(run, "engine.decode")
