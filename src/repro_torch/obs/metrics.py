"""Streaming serving metrics: a bounded-memory latency histogram.

The serving engine used to keep every request latency in an unbounded
Python list and run ``np.percentile`` over it — fine for benchmarks, wrong
for a driver meant to survive millions of requests. ``LatencyHistogram``
replaces it: fixed log-spaced buckets (constant memory, independent of
request count), O(1) observe, and **exact merging** — two histograms add
bucket-by-bucket, so merged quantiles are identical to a single histogram
over the concatenated sequence (the property that makes per-replica
histograms aggregatable without a resolution penalty).

Quantiles are bucket-resolved: ``quantile(q)`` returns the upper edge of
the bucket holding rank ``ceil(q * count)`` (clamped to the exact observed
max), so the relative error is bounded by the bucket ratio
(``2**(1/BUCKETS_PER_OCTAVE)`` ≈ 19%).
"""
from __future__ import annotations

import math
from typing import Dict, List

# 1 µs .. ~100 s in log2 buckets, 4 per octave (~19% resolution)
LO = 1e-6
HI = 128.0
BUCKETS_PER_OCTAVE = 4
N_BUCKETS = int(math.log2(HI / LO)) * BUCKETS_PER_OCTAVE + 1


class LatencyHistogram:
    """Fixed-bucket streaming histogram over seconds."""

    __slots__ = ("counts", "count", "sum", "min", "max")

    def __init__(self):
        self.counts: List[int] = [0] * N_BUCKETS
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = 0.0

    @staticmethod
    def bucket_of(seconds: float) -> int:
        if seconds <= LO:
            return 0
        i = int(math.log2(seconds / LO) * BUCKETS_PER_OCTAVE)
        return min(i, N_BUCKETS - 1)

    @staticmethod
    def bucket_upper(i: int) -> float:
        return LO * 2.0 ** ((i + 1) / BUCKETS_PER_OCTAVE)

    def observe(self, seconds: float) -> None:
        self.counts[self.bucket_of(seconds)] += 1
        self.count += 1
        self.sum += seconds
        self.min = min(self.min, seconds)
        self.max = max(self.max, seconds)

    def quantile(self, q: float) -> float:
        """Bucket-resolved quantile in seconds (0.0 when empty)."""
        if self.count == 0:
            return 0.0
        rank = max(1, math.ceil(q * self.count))
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= rank:
                # clamping to the true max keeps tail quantiles honest AND
                # merge-exact (max merges exactly too)
                return min(self.bucket_upper(i), self.max)
        return self.max

    def merge(self, other: "LatencyHistogram") -> "LatencyHistogram":
        """Exact: bucket counts add, so merged quantiles equal a single
        histogram over the concatenated observations."""
        out = LatencyHistogram()
        out.counts = [a + b for a, b in zip(self.counts, other.counts)]
        out.count = self.count + other.count
        out.sum = self.sum + other.sum
        out.min = min(self.min, other.min)
        out.max = max(self.max, other.max)
        return out

    def snapshot(self) -> Dict[str, float]:
        """The structured stats() payload: count, mean, p50/p95/p99, max."""
        return {
            "count": self.count,
            "mean_ms": (self.sum / self.count * 1e3) if self.count else 0.0,
            "p50_ms": self.quantile(0.50) * 1e3,
            "p95_ms": self.quantile(0.95) * 1e3,
            "p99_ms": self.quantile(0.99) * 1e3,
            "max_ms": (self.max * 1e3) if self.count else 0.0,
        }
