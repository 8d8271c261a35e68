"""Observability counters for the packing service (the port's
`repro.serve.stats`, the same accumulators).

Plain-python accumulators — no locks needed because everything that
mutates them runs on the service's event loop thread (the worker lane
hands results back through futures awaited on the loop).
"""
from __future__ import annotations

import bisect
import math


class LatencyStats:
    """Streaming latency recorder with exact small-N percentiles.

    Keeps a sorted list of samples (bounded by ``cap``; beyond it the
    reservoir keeps every k-th sample, which is more than precise enough
    for a benchmark harness) and answers p50/p99 in O(1).
    """

    def __init__(self, cap: int = 100_000):
        self.cap = cap
        self._sorted: list[float] = []
        self._stride = 1
        self._skip = 0
        self.count = 0
        self.total = 0.0

    def record(self, seconds: float) -> None:
        self.count += 1
        self.total += seconds
        self._skip += 1
        if self._skip < self._stride:
            return
        self._skip = 0
        if len(self._sorted) >= self.cap:
            # halve the resolution instead of dropping the tail: keep every
            # other retained sample so old and new eras stay represented
            self._sorted = self._sorted[::2]
            self._stride *= 2
        bisect.insort(self._sorted, seconds)

    def percentile(self, q: float) -> float:
        if not self._sorted:
            return 0.0
        # nearest-rank: smallest sample with at least ceil(q*n) samples <= it.
        # (round-half-up interpolation overshoots at small N: p50 of two
        # samples must be the lower one, not the upper)
        n = len(self._sorted)
        idx = max(0, min(n - 1, math.ceil(q * n) - 1))
        return self._sorted[idx]

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def summary(self) -> dict:
        return {
            "count": self.count,
            "mean_s": self.mean,
            "p50_s": self.percentile(0.50),
            "p99_s": self.percentile(0.99),
        }


class Histogram:
    """Integer-valued histogram (batch occupancy, queue depth samples)."""

    def __init__(self):
        self.counts: dict[int, int] = {}

    def record(self, value: int) -> None:
        self.counts[int(value)] = self.counts.get(int(value), 0) + 1

    @property
    def total(self) -> int:
        return sum(self.counts.values())

    @property
    def mean(self) -> float:
        n = self.total
        return (
            sum(k * v for k, v in self.counts.items()) / n if n else 0.0
        )

    def summary(self) -> dict:
        return {
            "counts": {str(k): v for k, v in sorted(self.counts.items())},
            "mean": self.mean,
        }
