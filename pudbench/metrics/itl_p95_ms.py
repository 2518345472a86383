"""95th percentile of every gap between consecutive output tokens of a
request in the window (host clock at step ends), in ms.  A request's
first two tokens (its prefill's and its first decode wave's) come out of
one step: their gap is 0."""
from pudbench.harness.stats import percentile


def read(run):
    v = percentile(run["window"].itl, 95)
    return None if v is None else v * 1e3
