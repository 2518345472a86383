"""Host wall of enqueueing one admission's batch-1 prefill: the
``model.prefill`` span (the model's prefill call) per ``engine.admit``
over the measured window, in ms.  Beside ``engine.first_token_wait_ms``
it tells a host-bound admission from a device-bound one."""
from pudbench.harness import program


def read(run):
    return program.window_ms_per(run, "model.prefill", "engine.admit")
