"""Duration accumulators for regeneration phases.

Port of Cilium's pkg/spanstat: Start/End accumulate success and
failure totals separately; pkg/endpoint/policy.go:689-699 logs one
SpanStat per regeneration phase (policy calculation, map sync, table
compile, total).  The port's copy of the reference's module; the record
replay keeps its host_pack / dispatch / drain phases in a SpanStats.
"""

from __future__ import annotations

import time
from typing import Dict, Optional


class SpanStat:
    def __init__(self) -> None:
        self.success_total = 0.0
        self.failure_total = 0.0
        self.num_success = 0
        self.num_failure = 0
        self._start: Optional[float] = None

    def start(self) -> "SpanStat":
        """Begin a measurement window.  A start() while a span is
        already running folds the in-flight elapsed time as a
        SUCCESS first (the old behavior silently discarded it —
        wrong once spans wrap re-entrant regen phases): no wall time
        observed by a start/start/end sequence is ever lost."""
        if self._start is not None:
            self.end(success=True)
        self._start = time.perf_counter()
        return self

    def end(self, success: bool = True) -> "SpanStat":
        if self._start is None:
            return self
        d = time.perf_counter() - self._start
        self._start = None
        return self.observe(d, success=success)

    def observe(self, duration: float, success: bool = True) -> "SpanStat":
        """Fold an externally measured duration — the ONE fold
        implementation shared by end() and tracing.StatSpan, so the
        /debug/profile and /debug/traces planes can't drift."""
        if success:
            self.success_total += duration
            self.num_success += 1
        else:
            self.failure_total += duration
            self.num_failure += 1
        return self

    def total(self) -> float:
        return self.success_total + self.failure_total

    def seconds(self) -> float:
        return self.total()


class SpanStats(dict):
    """Named phase map (regenerationStatistics, pkg/endpoint/policy.go)."""

    def span(self, name: str) -> SpanStat:
        if name not in self:
            self[name] = SpanStat()
        return self[name]

    def report(self) -> Dict[str, float]:
        return {name: s.total() for name, s in self.items()}
