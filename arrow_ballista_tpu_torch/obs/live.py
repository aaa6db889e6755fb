"""In-flight doctor: a budget-capped subset of the doctor's rule catalog
evaluated against RUNNING jobs on a scheduler cadence.

The port's copy of arrow_ballista_tpu/obs/live.py.  The port has no job
deadlines yet, so ``deadline-burn`` finds nothing there.

The post-hoc doctor (``obs/doctor.py``) diagnoses a finished job's
forensics bundle; this module watches jobs while they run and turns
sustained pathologies into journal alerts:

- ``alert.raised`` — a rule tripped for (job, rule); carries the same
  ``rule/severity/stage_id/summary/evidence/remedy`` schema the doctor
  emits, so dashboards parse one shape.
- ``alert.cleared`` — the condition stopped tripping (hysteresis: a rule
  must scan clean ``CLEAR_AFTER`` consecutive times, so a flapping stage
  does not spam raise/clear pairs), or the job finished.

Rules (reused thresholds from ``obs/doctor.py`` — one catalog, two
evaluation times):

- ``straggler`` (live form): a running task's AGE exceeds
  ``STRAGGLER_SPREAD_MIN`` x the stage's completed-task p50 (and the
  ``_STRAGGLER_MIN_MAX_S`` floor) — the post-hoc spread rule cannot see
  a straggler that has not finished yet, its age is the live signal.
- ``partition-skew`` / ``shuffle-hotspot``: the doctor's stage
  predicates over LIVE ``stage_summary`` folds.
- ``control-plane-churn``: the doctor's global predicate over the job's
  live journal timeline + recent cluster history.
- ``journal-drops``: standing global alert (``job_id=""``) while
  ``journal_events_dropped_total > 0`` — backpressure must be seen, not
  discovered in the counters after the fact.
- ``deadline-burn``: a deadlined job consumed 80% of its
  ``ballista.query.deadline.seconds`` budget with unresolved stages —
  the deadline reaper will cancel it; act before it does.

Cost discipline: the scan thread only exists when
``ballista.live.enabled`` is on with a positive interval; each scan is
pure reads over in-memory state (no wire traffic, no graph mutation).
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

from . import journal
from .doctor import (
    STRAGGLER_SPREAD_MIN,
    _STRAGGLER_MIN_MAX_S,
    _global_findings,
    _stage_findings,
)
from .stats import nearest_rank_quantile, stage_summary

#: rules the live scanner evaluates (the budget cap: the full catalog's
#: retrace/fusion/cache rules stay post-hoc)
LIVE_RULES = ("straggler", "partition-skew", "shuffle-hotspot",
              "memory-pressure", "control-plane-churn", "journal-drops",
              "deadline-burn")
#: consecutive tripping scans before an alert raises
RAISE_AFTER = 1
#: consecutive clean scans before a standing alert clears
CLEAR_AFTER = 2


def _live_straggler(graph, now: float) -> List[Dict]:
    """Age-based straggler detection for still-running tasks."""
    out: List[Dict] = []
    for sid in sorted(graph.stages):
        stage = graph.stages[sid]
        if stage.state != "running" or len(stage.durations) < 2:
            continue
        p50 = nearest_rank_quantile([float(d) for d in stage.durations],
                                    0.50) or 0.0
        threshold = max(STRAGGLER_SPREAD_MIN * p50, _STRAGGLER_MIN_MAX_S)
        ages = [now - t.started_at for t in stage.task_infos
                if t is not None and t.state == "running" and t.started_at]
        slow = [a for a in ages if a >= threshold]
        if not slow:
            continue
        out.append({
            "rule": "straggler",
            "severity": round(max(slow) / max(p50, 0.05), 3),
            "stage_id": sid,
            "summary": f"stage {sid}: {len(slow)} running task(s) "
                       f"{max(slow):.1f}s old vs completed p50 "
                       f"{p50:.2f}s",
            "evidence": {"oldest_running_task_s": round(max(slow), 3),
                         "completed_p50_s": round(p50, 3),
                         "age_threshold_s": round(threshold, 3),
                         "running_tasks": len(ages)},
            "remedy": "enable/tune ballista.speculation.enabled so a "
                      "duplicate races the straggler; check the "
                      "executor's journal events",
        })
    return out


#: fraction of the deadline budget consumed before deadline-burn raises
_DEADLINE_BURN_FRACTION = 0.8


def _live_deadline_burn(graph) -> List[Dict]:
    """A deadlined job past 80% of its budget with unresolved stages: the
    server-side deadline reaper WILL cancel it — surface the burn while an
    operator can still act (kill it cleanly, raise the deadline, add
    capacity).  Wall clock on purpose: ``deadline_ts`` is absolute and
    survives failover, so the alert is correct on an adopting shard too."""
    deadline_ts = getattr(graph, "deadline_ts", 0.0)
    deadline_s = getattr(graph, "deadline_s", 0.0)
    if not deadline_ts or deadline_s <= 0:
        return []
    wall = time.time()
    consumed = deadline_s - (deadline_ts - wall)
    if consumed < _DEADLINE_BURN_FRACTION * deadline_s:
        return []
    unresolved = [sid for sid in sorted(graph.stages)
                  if graph.stages[sid].state != "successful"]
    if not unresolved:
        return []  # all stages done: only result capture remains
    remaining = max(0.0, deadline_ts - wall)
    return [{
        "rule": "deadline-burn",
        "severity": round(consumed / deadline_s, 3),
        "summary": f"{consumed:.1f}s of the {deadline_s:.1f}s deadline "
                   f"consumed ({remaining:.1f}s left) with "
                   f"{len(unresolved)} unresolved stage(s)",
        "evidence": {"deadline_s": round(deadline_s, 3),
                     "consumed_s": round(consumed, 3),
                     "remaining_s": round(remaining, 3),
                     "unresolved_stages": unresolved},
        "remedy": "raise ballista.query.deadline.seconds (session or "
                  "per-submit), add executor capacity, or cancel the job "
                  "now to stop burning slots on a query that will be "
                  "deadline-cancelled anyway",
    }]


class LiveDoctor:
    """(job, rule)-deduped alert state machine over running jobs.

    Single-threaded by construction: ``scan`` runs only on the
    scheduler's live-doctor thread (or inline in tests) — the state
    dicts need no lock.
    """

    def __init__(self):
        # (job_id, rule, stage_id) -> standing finding
        self._active: Dict[Tuple[str, str, int], Dict] = {}
        self._trips: Dict[Tuple[str, str, int], int] = {}
        self._clean: Dict[Tuple[str, str, int], int] = {}

    def alerts_active(self) -> int:
        return len(self._active)

    def active_findings(self) -> List[Dict]:
        return [dict(f, job_id=k[0]) for k, f in
                sorted(self._active.items())]

    def scan(self, server, now: Optional[float] = None) -> None:
        """One cadence tick: evaluate live rules for every running job,
        raise/clear with hysteresis, maintain the global journal-drops
        standing alert."""
        now = time.monotonic() if now is None else now
        seen_jobs = set()
        for graph in server.jobs.active_graphs():
            job_id = graph.job_id
            seen_jobs.add(job_id)
            findings = self._evaluate(server, graph, now)
            self._fold(job_id, findings)
        # jobs that left the running set: their standing alerts clear
        # immediately (the post-hoc doctor owns finished jobs)
        for key in [k for k in self._active
                    if k[0] and k[0] not in seen_jobs]:
            self._clear(key, reason="job-finished")
        self._journal_drops_alert()

    # --- internals -------------------------------------------------------
    def _evaluate(self, server, graph, now: float) -> List[Dict]:
        stages = [stage_summary(graph.stages[sid])
                  for sid in sorted(graph.stages)]
        timeline = journal.job_timeline(graph.job_id)
        history = server.cluster_history() \
            if hasattr(server, "cluster_history") else {}
        bundle = {"stages": stages, "journal": timeline,
                  "metrics": {}, "cluster_history": history}
        findings = [f for f in _stage_findings(bundle) + _global_findings(bundle)
                    if f["rule"] in LIVE_RULES]
        findings.extend(_live_straggler(graph, now))
        findings.extend(_live_deadline_burn(graph))
        return findings

    def _fold(self, job_id: str, findings: List[Dict]) -> None:
        tripped = set()
        for f in findings:
            key = (job_id, f["rule"], int(f.get("stage_id", -1)))
            if key in tripped:
                continue  # one alert per (job, rule, stage) per scan
            tripped.add(key)
            self._clean.pop(key, None)
            self._trips[key] = self._trips.get(key, 0) + 1
            if key not in self._active and self._trips[key] >= RAISE_AFTER:
                self._active[key] = f
                journal.emit("alert.raised", job_id=job_id, **_attrs(f))
        for key in [k for k in self._active if k[0] == job_id]:
            if key in tripped:
                continue
            self._trips.pop(key, None)
            self._clean[key] = self._clean.get(key, 0) + 1
            if self._clean[key] >= CLEAR_AFTER:
                self._clear(key, reason="condition-cleared")

    def _clear(self, key: Tuple[str, str, int], reason: str) -> None:
        f = self._active.pop(key, None)
        self._trips.pop(key, None)
        self._clean.pop(key, None)
        if f is None:
            return
        attrs = {"rule": f["rule"], "reason": reason}
        if "stage_id" in f:
            attrs["stage_id"] = f["stage_id"]
        journal.emit("alert.cleared", job_id=key[0], **attrs)

    def _journal_drops_alert(self) -> None:
        emitted, dropped = journal.counters()
        key = ("", "journal-drops", -1)
        if dropped > 0 and key not in self._active:
            f = {
                "rule": "journal-drops",
                "severity": float(dropped),
                "summary": f"flight recorder is shedding events: "
                           f"{dropped} dropped of {emitted} emitted — "
                           "the forensic record has holes",
                "evidence": {"journal_events_dropped_total": dropped,
                             "journal_events_total": emitted},
                "remedy": "raise ballista.journal.capacity or set "
                          "ballista.journal.spill_path so the record "
                          "lands on disk before the ring evicts it",
            }
            self._active[key] = f
            journal.emit("alert.raised", **_attrs(f))
        elif dropped == 0 and key in self._active:
            # counters reset (test hook): the standing alert clears
            self._clear(key, reason="condition-cleared")


def _attrs(f: Dict) -> Dict:
    attrs = {"rule": f["rule"], "severity": f.get("severity", 0.0),
             "summary": f.get("summary", ""),
             "evidence": f.get("evidence", {}),
             "remedy": f.get("remedy", "")}
    if "stage_id" in f:
        attrs["stage_id"] = f["stage_id"]
    return attrs
