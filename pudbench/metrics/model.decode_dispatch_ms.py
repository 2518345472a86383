"""Host wall of enqueueing one decode wave: the ``model.decode_step``
span (the model's decode call, up to the wait for its tokens) per
``engine.decode`` wave over the measured window, in ms.  Beside
``model.decode_wave_ms`` (the whole wave, the token read included), it
tells a host-bound wave from a device-bound one."""
from pudbench.harness import program


def read(run):
    return program.window_ms_per(run, "model.decode_step", "engine.decode")
