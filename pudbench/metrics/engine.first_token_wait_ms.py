"""Host wait for an admission's first token: the ``engine.first_token``
span (the blocking read of the prefill's argmax, so the wait for the
device work the admission enqueued) per ``engine.admit`` over the
measured window, in ms."""
from pudbench.harness import program


def read(run):
    return program.window_ms_per(run, "engine.first_token", "engine.admit")
