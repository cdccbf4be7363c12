"""The benchmark's statistics."""

from __future__ import annotations

import math
import statistics


def percentile(values: list[float], q: float) -> float:
    """The ``q``-th percentile (0-100) of all ``values``, linear between the
    two nearest ranks (numpy's default, ``statistics.quantiles``'
    "inclusive" method)."""
    if not values:
        raise ValueError("percentile of no values")
    xs = sorted(values)
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def spread(values: list[float]) -> float:
    """The distance between the first and the third quartile as a share of
    the median, by ``statistics.quantiles(values, n=4)`` (its default
    "exclusive" method)."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med
