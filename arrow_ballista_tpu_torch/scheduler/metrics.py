"""Scheduler metrics of the port: for now only the bucketed ``Histogram``
that the executor's exposition (executor/metrics.py) folds task durations
into.  A copy of the class in arrow_ballista_tpu/scheduler/metrics.py; the
scheduler's collectors come with ROADMAP.md queue 1 item 12 E.
"""
from __future__ import annotations

from typing import List, Optional

_BUCKETS = [0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0]


class Histogram:
    def __init__(self, buckets: Optional[List[float]] = None):
        self.buckets = buckets or _BUCKETS
        self.counts = [0] * (len(self.buckets) + 1)
        self.total = 0.0
        self.n = 0

    def observe(self, v: float) -> None:
        self.n += 1
        self.total += v
        for i, b in enumerate(self.buckets):
            if v <= b:
                self.counts[i] += 1
                return
        self.counts[-1] += 1
