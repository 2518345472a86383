"""90th percentile, over every request submitted in the window, of the
time from its submission to the end of the step that produced its first
token (host clock), in ms."""
from pudbench.harness.stats import percentile


def read(run):
    v = percentile(run["window"].ttft, 90)
    return None if v is None else v * 1e3
