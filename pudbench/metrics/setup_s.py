"""Process start to the window's first timed request: imports, CUDA
start-up, kernel libraries, weights from the seed, the calibration miss,
placement and packing, the engine and the warm-up steps."""


def read(run):
    return run["setup_s"]
