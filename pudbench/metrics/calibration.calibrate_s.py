"""Host wall of ``session.calibrate()`` on a cache miss (Algorithm 1 over
the grid, ECR, save), from a synchronised start to a synchronised end."""


def read(run):
    return run["spans"]["calibrate"]
