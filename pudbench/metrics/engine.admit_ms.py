"""Host wall a step spends outside its decode wave (admission: the
batch-1 prefills), per admission, over the window's steps outside the
traced stretch: step walls less the engine's ``decode_wall_s``, in ms."""
from pudbench.harness.counters import counters


def read(run):
    c = counters(run)
    if c["admitted"] <= 0:
        return None
    return 1e3 * (c["step_wall_s"] - c["decode_wall_s"]) / c["admitted"]
