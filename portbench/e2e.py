"""The end-to-end metrics of a window, from the host clock.

A request is timed from its issue to the synchronize that ends it.  The
window starts before the first request and ends with the last request
that started in it.
"""

from __future__ import annotations

import statistics
from typing import Sequence


def results_per_s(t_start: float, ends: Sequence[float], lanes: int,
                  ok: Sequence[bool]) -> float:
    """Lanes of every completed request over the time from the window's
    start to the end of the last completed request."""
    done = [e for e, good in zip(ends, ok) if good]
    if not done:
        return 0.0
    return lanes * len(done) / (max(done) - t_start)


def percentile(values: Sequence[float], q: int) -> float:
    """The q-th percentile, interpolated between the closest ranks
    (statistics.quantiles, method "inclusive")."""
    if len(values) == 1:
        return float(values[0])
    return statistics.quantiles(values, n=100, method="inclusive")[q - 1]


def request_p95_ms(latencies_s: Sequence[float]) -> float:
    """95th percentile of every request's latency, in milliseconds."""
    return 1e3 * percentile(latencies_s, 95)
