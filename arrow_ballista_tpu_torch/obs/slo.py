"""SLO tracker: declarative latency/error objectives with burn rates.

``ballista.slo.latency.p99.target.ms`` declares the objective: 99% of
completed jobs finish under the target (a failed job always counts
against the objective).  The tracker keeps completed-job samples over a
sliding window and computes MULTI-WINDOW BURN RATES — the rate at which
the error budget (the 1% of jobs allowed to violate) is being consumed:

    burn_rate = observed_violation_fraction / allowed_violation_fraction

1.0 means the budget burns exactly as fast as it refills; a fast-window
burn rate well above 1 while the slow window is still calm is the
classic page-on-burn signal (SRE workbook multi-window multi-burn).  Two
windows are tracked: the configured ``ballista.slo.window.seconds``
(slow) and 1/12 of it (fast) — the 1h/5m ratio scaled to the window.

Fleet correctness: each scheduler shard tracks the jobs IT completed and
can publish ``(count, violations)`` pairs; ``merge_samples`` sums them
into a fleet-wide burn.  The port runs one scheduler, so its snapshot is
that shard's alone.  The port's copy of arrow_ballista_tpu/obs/slo.py.

Null-object pattern (like ``obs/device.py``): an unset target yields a
``NullSloTracker`` whose ``record`` is a no-op — the completed-job path
pays one method call and nothing else, and nothing new rides the wire.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, Iterable, Optional

#: fast window = slow window / _FAST_DIVISOR (the 1h/5m SRE ratio)
_FAST_DIVISOR = 12.0
#: objective implied by a p99 target: 1% of jobs may violate
_ALLOWED_VIOLATION_FRACTION = 0.01


class SloPolicy:
    """Parsed ``ballista.slo.*`` objective."""

    __slots__ = ("p99_target_ms", "window_s")

    def __init__(self, p99_target_ms: float, window_s: float):
        self.p99_target_ms = float(p99_target_ms)
        self.window_s = max(1.0, float(window_s))

    @property
    def fast_window_s(self) -> float:
        return max(1.0, self.window_s / _FAST_DIVISOR)

    def describe(self) -> Dict:
        return {"latency_p99_target_ms": self.p99_target_ms,
                "window_s": self.window_s,
                "fast_window_s": round(self.fast_window_s, 3),
                "allowed_violation_fraction": _ALLOWED_VIOLATION_FRACTION}


def policy_from_config(config) -> Optional[SloPolicy]:
    """An SloPolicy when the session config declares a target, else None
    (caller builds the null tracker)."""
    from ..utils.config import SLO_P99_TARGET_MS, SLO_WINDOW_S

    target = float(config.get(SLO_P99_TARGET_MS))
    if target <= 0:
        return None
    return SloPolicy(target, float(config.get(SLO_WINDOW_S)))


class NullSloTracker:
    """No objective configured: every entry point is a cheap no-op."""

    enabled = False
    policy: Optional[SloPolicy] = None

    def record(self, duration_ms: float, ok: bool = True,
               ts: Optional[float] = None) -> None:
        pass

    def sample(self, now: Optional[float] = None) -> Dict[str, int]:
        return {}

    def snapshot(self, now: Optional[float] = None,
                 shard_samples: Optional[Iterable[Dict]] = None) -> Dict:
        return {"enabled": False}

    def max_burn_rate(self, now: Optional[float] = None,
                      shard_samples: Optional[Iterable[Dict]] = None) -> float:
        return 0.0


class SloTracker:
    """Sliding-window violation accounting for one scheduler shard."""

    enabled = True

    def __init__(self, policy: SloPolicy):
        self.policy = policy
        self._lock = threading.Lock()
        # (ts, violated) pairs, oldest first; pruned past the slow window
        self._samples: deque = deque()

    def record(self, duration_ms: float, ok: bool = True,
               ts: Optional[float] = None) -> None:
        """One completed job: a failure or an over-target duration is a
        violation."""
        now = time.time() if ts is None else float(ts)
        violated = (not ok) or float(duration_ms) > self.policy.p99_target_ms
        with self._lock:
            self._samples.append((now, violated))
            self._prune(now)

    def _prune(self, now: float) -> None:
        cutoff = now - self.policy.window_s
        while self._samples and self._samples[0][0] < cutoff:
            self._samples.popleft()

    def _window_counts(self, now: float, window_s: float) -> Dict[str, int]:
        cutoff = now - window_s
        count = bad = 0
        for ts, violated in self._samples:
            if ts >= cutoff:
                count += 1
                bad += int(violated)
        return {"count": count, "violations": bad}

    def sample(self, now: Optional[float] = None) -> Dict[str, int]:
        """Shard-registry payload: raw counts, mergeable by summation."""
        now = time.time() if now is None else float(now)
        with self._lock:
            self._prune(now)
            fast = self._window_counts(now, self.policy.fast_window_s)
            slow = self._window_counts(now, self.policy.window_s)
        return {"slo_fast_count": fast["count"],
                "slo_fast_violations": fast["violations"],
                "slo_slow_count": slow["count"],
                "slo_slow_violations": slow["violations"]}

    def snapshot(self, now: Optional[float] = None,
                 shard_samples: Optional[Iterable[Dict]] = None) -> Dict:
        """The burn-rate report.  ``shard_samples`` are sibling shards'
        ``sample()`` dicts; local counts are merged in the same
        summation."""
        merged = merge_samples([self.sample(now=now)]
                               + [s for s in (shard_samples or []) if s])
        return {
            "enabled": True,
            "policy": self.policy.describe(),
            "windows": {
                "fast": _window_report(merged["slo_fast_count"],
                                       merged["slo_fast_violations"]),
                "slow": _window_report(merged["slo_slow_count"],
                                       merged["slo_slow_violations"]),
            },
        }

    def max_burn_rate(self, now: Optional[float] = None,
                      shard_samples: Optional[Iterable[Dict]] = None) -> float:
        snap = self.snapshot(now=now, shard_samples=shard_samples)
        return max(snap["windows"]["fast"]["burn_rate"],
                   snap["windows"]["slow"]["burn_rate"])


def _window_report(count: int, violations: int) -> Dict:
    frac = violations / count if count else 0.0
    return {"count": int(count), "violations": int(violations),
            "violation_fraction": round(frac, 4),
            "burn_rate": round(frac / _ALLOWED_VIOLATION_FRACTION, 3)}


def merge_samples(samples: Iterable[Dict]) -> Dict[str, int]:
    """Sum shard samples (violation/count pairs are pure flows)."""
    out = {"slo_fast_count": 0, "slo_fast_violations": 0,
           "slo_slow_count": 0, "slo_slow_violations": 0}
    for s in samples:
        for k in out:
            out[k] += int(s.get(k, 0) or 0)
    return out


def tracker_from_config(config) -> "NullSloTracker":
    """The tracker the scheduler wires in: real when a target is set,
    null otherwise."""
    policy = policy_from_config(config)
    return SloTracker(policy) if policy is not None else NullSloTracker()
