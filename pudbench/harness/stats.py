"""Percentiles over all samples and the spread the bounds are set from."""
from __future__ import annotations

import math
import statistics


def percentile(values, q: float) -> float | None:
    """The ``q``-th percentile (0-100) of every sample, linear between the
    two nearest ranks (numpy's default); None without samples."""
    xs = sorted(float(v) for v in values)
    if not xs:
        return None
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def spread(values) -> float:
    """Distance between the first and third quartiles
    (``statistics.quantiles(values, n=4)``) as a share of the median."""
    q1, med, q3 = statistics.quantiles(list(values), n=4)
    return (q3 - q1) / med
