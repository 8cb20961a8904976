"""Percentiles over all requests and rates over the window.

A tail is a nearest-rank percentile over every sample, never interpolated
and never over a subset: ``p95`` of n values is the value at rank
``ceil(0.95 n)``.  A request that failed counts with the latency it had
waited when the harness gave up, so it misses every limit.
"""

from __future__ import annotations

import math
from typing import Iterable, Sequence


def percentile(values: Iterable[float], q: float) -> float | None:
    """Nearest-rank ``q``-th percentile (0 < q <= 100); None when empty."""
    xs = sorted(values)
    if not xs:
        return None
    rank = max(1, math.ceil(q / 100.0 * len(xs)))
    return float(xs[rank - 1])


def rate(count: float, t0: float, t1: float) -> float | None:
    """``count`` over the seconds from ``t0`` to ``t1``."""
    return None if t1 <= t0 else count / (t1 - t0)


def tokens_in(times: Sequence[float], t0: float, t1: float) -> int:
    """How many of ``times`` fall in the window ``(t0, t1]``."""
    return sum(1 for t in times if t0 < t <= t1)


def gaps(times: Sequence[float]) -> list[float]:
    """The gaps between consecutive token times of one request."""
    return [b - a for a, b in zip(times, times[1:])]


def quartile_spread(values: Sequence[float]) -> float:
    """(Q3 - Q1) / median with ``statistics.quantiles(values, n=4)``."""
    import statistics

    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2
