"""Placed GEMM / GEMV calls (the port's ``placed.calls`` counter, every
call on either path) in the measured window over the tokens it
generated."""
from pudbench.harness import program


def read(run):
    calls = program.window_count(run, "placed.calls")
    tokens = run["window"].tokens
    if calls is None or tokens <= 0:
        return None
    return calls / tokens
