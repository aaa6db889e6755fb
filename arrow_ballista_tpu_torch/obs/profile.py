"""Scheduler-side job observability: phase spans + profile retention.

`JobObservability` is the scheduler's single tracing surface.  It opens
a root "job" span per submission with contiguous phase children
(admission -> planning -> execution) so the scheduler-side spans alone
cover the job's full wall time, hands the execution span's context to
`ExecutionGraph.trace` for task propagation, and on the job's terminal
status folds the graph's task statuses (metrics + shipped span trees)
into a structured profile:

    per-stage -> per-task -> per-operator

Finished profiles and span sets live in a ring buffer (capacity
`ballista.observability.profile.retention`), read by the forensics
bundle (obs/doctor.py); spans are also handed to the configured
`SpanCollector` (noop by default).

The port's copy of arrow_ballista_tpu/obs/profile.py.  The failover hooks
(``on_adopted`` / ``on_stand_down``) are kept for the fleet leases still
to be ported; nothing in the port calls them yet.
"""
import threading
from collections import OrderedDict
from typing import Dict, List, Optional

from .trace_event import spans_to_chrome
from .tracing import (
    Span,
    SpanCollector,
    make_collector,
    new_trace_id,
    now_ms,
)

# phase progression; on_finished closes whatever is still open
_PHASES = ("admission", "planning", "execution")


class _JobTrace:
    __slots__ = ("job_id", "root", "phases")

    def __init__(self, job_id: str, root: Span):
        self.job_id = job_id
        self.root = root
        self.phases: "OrderedDict[str, Span]" = OrderedDict()


class ProfileStore:
    """Ring buffer of finished job profiles + their span sets."""

    def __init__(self, capacity: int = 64):
        self.capacity = max(int(capacity), 1)
        self._lock = threading.Lock()
        self._entries: "OrderedDict[str, Dict]" = OrderedDict()

    def put(self, job_id: str, profile: Dict, spans: List[Span]) -> None:
        with self._lock:
            self._entries.pop(job_id, None)
            self._entries[job_id] = {"profile": profile, "spans": spans}
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)

    def get(self, job_id: str) -> Optional[Dict]:
        with self._lock:
            e = self._entries.get(job_id)
            return e["profile"] if e else None

    def get_spans(self, job_id: str) -> Optional[List[Span]]:
        with self._lock:
            e = self._entries.get(job_id)
            return list(e["spans"]) if e else None

    def job_ids(self) -> List[str]:
        with self._lock:
            return list(self._entries)


class JobObservability:
    def __init__(self, collector: Optional[SpanCollector] = None,
                 retention: int = 64, tracing: bool = True):
        self.tracing = tracing
        self.collector = collector if collector is not None \
            else make_collector("noop")
        self.profiles = ProfileStore(retention)
        self._lock = threading.Lock()
        self._jobs: "OrderedDict[str, _JobTrace]" = OrderedDict()
        # live-trace bound: generous vs retention, just an anti-leak net
        # for jobs that never reach a terminal status
        self._max_live = max(256, retention)

    @staticmethod
    def from_config(config) -> "JobObservability":
        from ..utils.config import (
            OBS_COLLECTOR,
            OBS_OTLP_ENDPOINT,
            OBS_PROFILE_RETENTION,
            OBS_TRACING,
        )
        return JobObservability(
            collector=make_collector(config.get(OBS_COLLECTOR),
                                     config.get(OBS_OTLP_ENDPOINT)),
            retention=config.get(OBS_PROFILE_RETENTION),
            tracing=bool(config.get(OBS_TRACING)))

    # --- lifecycle hooks (scheduler threads + event loop) ----------------
    def on_submitted(self, job_id: str,
                     trace: Optional[Dict[str, str]] = None) -> None:
        if not self.tracing:
            return
        trace = trace or {}
        root = Span(f"job {job_id}",
                    trace.get("trace_id") or new_trace_id(),
                    parent_id=trace.get("span_id", ""), kind="scheduler",
                    attrs={"job_id": job_id, "actor": "scheduler",
                           "lane": f"job {job_id}"})
        jt = _JobTrace(job_id, root)
        self._start_phase(jt, "admission")
        with self._lock:
            self._jobs.pop(job_id, None)
            self._jobs[job_id] = jt
            while len(self._jobs) > self._max_live:
                self._jobs.popitem(last=False)

    def on_admitted(self, job_id: str) -> None:
        self._advance(job_id, "planning")

    def on_planned(self, job_id: str) -> None:
        self._advance(job_id, "execution")

    def task_parent(self, job_id: str) -> Dict[str, str]:
        """Propagation context for the job's tasks (-> graph.trace)."""
        with self._lock:
            jt = self._jobs.get(job_id)
        if jt is None:
            return {}
        span = jt.phases.get("execution") or jt.root
        return span.context()

    def on_adopted(self, job_id: str, epoch: int, prev_owner: str = "",
                   scheduler_id: str = "",
                   trace: Optional[Dict[str, str]] = None) -> None:
        """Fleet failover hook: this shard took over a job whose previous owner stopped renewing
        its lease.  Opens a root for the adopted drive — continuing the
        original trace when the checkpointed graph carried its context,
        so the Chrome trace shows both shards on one timeline — with an
        ended "lease adoption" marker span annotated with the fencing
        epoch, then an execution phase for the relaunched tasks."""
        if not self.tracing:
            return
        trace = trace or {}
        root = Span(f"job {job_id} (adopted)",
                    trace.get("trace_id") or new_trace_id(),
                    parent_id=trace.get("span_id", ""), kind="scheduler",
                    attrs={"job_id": job_id, "actor": "scheduler",
                           "lane": f"job {job_id}", "adopted": True,
                           "adoption_epoch": int(epoch),
                           "adopted_by": scheduler_id})
        jt = _JobTrace(job_id, root)
        marker = Span("lease adoption", root.trace_id,
                      parent_id=root.span_id, kind="scheduler",
                      attrs={"job_id": job_id, "actor": "scheduler",
                             "lane": f"job {job_id}",
                             "adoption_epoch": int(epoch),
                             "previous_owner": prev_owner,
                             "adopted_by": scheduler_id})
        marker.end()
        jt.phases[f"adoption@{epoch}"] = marker
        self._start_phase(jt, "execution")
        with self._lock:
            self._jobs.pop(job_id, None)
            self._jobs[job_id] = jt
            while len(self._jobs) > self._max_live:
                self._jobs.popitem(last=False)

    def on_stand_down(self, job_id: str, why: str) -> None:
        """Fleet fencing hook: this shard
        lost the job's lease and is abandoning its drive.  Closes the
        local spans with a "stand-down" marker and retains them, so the
        ex-owner's job trace still shows its half of the
        failover (the adopter records the other half, on the same
        trace_id when the checkpoint carried it)."""
        if not self.tracing:
            return
        with self._lock:
            jt = self._jobs.pop(job_id, None)
        if jt is None:
            return
        marker = Span("lease stand-down", jt.root.trace_id,
                      parent_id=jt.root.span_id, kind="scheduler",
                      attrs={"job_id": job_id, "actor": "scheduler",
                             "lane": f"job {job_id}", "reason": why})
        marker.end()
        jt.phases["stand-down"] = marker
        for span in jt.phases.values():
            if not span.end_ms:
                span.end("stand-down")
        jt.root.end("stand-down")
        spans = self._job_spans(jt, None)
        profile = self._build_profile(jt, None, None)
        profile["state"] = "stood-down"
        profile["stand_down_reason"] = why
        self.profiles.put(job_id, profile, spans)
        try:
            self.collector.export(spans)
        except Exception:
            pass

    def on_finished(self, status, graph=None) -> None:
        """Terminal JobStatus hook: close spans, build + retain the
        profile, export to the collector.  Idempotent per job."""
        if not self.tracing:
            return
        job_id = status.job_id
        with self._lock:
            jt = self._jobs.pop(job_id, None)
        if jt is None:
            if self.profiles.get(job_id) is not None:
                return  # double terminal status
            # job the scheduler adopted without a submit hook (recovery)
            jt = _JobTrace(job_id, Span(
                f"job {job_id}", new_trace_id(), kind="scheduler",
                attrs={"job_id": job_id, "actor": "scheduler",
                       "lane": f"job {job_id}"}))
        ok = status.state == "successful"
        for name, span in jt.phases.items():
            if not span.end_ms:
                span.end("ok" if ok else status.state)
        jt.root.end("ok" if ok else status.state)
        spans = self._job_spans(jt, graph)
        profile = self._build_profile(jt, status, graph)
        self.profiles.put(job_id, profile, spans)
        try:
            self.collector.export(spans)
        except Exception:
            pass

    # --- views -----------------------------------------------------------
    def get_profile(self, job_id: str, graph=None,
                    status=None) -> Optional[Dict]:
        p = self.profiles.get(job_id)
        if p is not None:
            return p
        jt = self._live(job_id)
        if jt is None:
            return None
        return self._build_profile(jt, status, graph)

    def get_trace(self, job_id: str, graph=None) -> Optional[Dict]:
        spans = self.profiles.get_spans(job_id)
        if spans is None:
            jt = self._live(job_id)
            if jt is None:
                return None
            spans = self._job_spans(jt, graph)
        return spans_to_chrome(spans)

    # --- internals -------------------------------------------------------
    def _live(self, job_id: str) -> Optional[_JobTrace]:
        with self._lock:
            return self._jobs.get(job_id)

    def _start_phase(self, jt: _JobTrace, name: str) -> None:
        jt.phases[name] = Span(name, jt.root.trace_id,
                               parent_id=jt.root.span_id, kind="scheduler",
                               attrs=dict(jt.root.attrs))

    def _advance(self, job_id: str, next_phase: str) -> None:
        if not self.tracing:
            return
        with self._lock:
            jt = self._jobs.get(job_id)
            if jt is None or next_phase in jt.phases:
                return
            for span in jt.phases.values():
                span.end()
            self._start_phase(jt, next_phase)

    @staticmethod
    def _task_spans(graph) -> List[Span]:
        spans: List[Span] = []
        if graph is None:
            return spans
        for stage in graph.stages.values():
            for info in stage.task_infos:
                st = getattr(info, "status", None)
                if st is None:
                    continue
                # same attempt guard as _task_profile: a late loser's
                # status must not add duplicate operator spans to the trace
                st_att = getattr(getattr(st, "task", None), "task_attempt",
                                 None)
                if st_att is not None and st_att != getattr(info, "attempt",
                                                            st_att):
                    continue
                spans.extend(getattr(st, "spans", None) or [])
        return spans

    def _job_spans(self, jt: _JobTrace, graph) -> List[Span]:
        return [jt.root] + list(jt.phases.values()) + self._task_spans(graph)

    def _build_profile(self, jt: _JobTrace, status, graph) -> Dict:
        state = getattr(status, "state", None) or \
            (getattr(graph, "status", None) or "running")
        prof = {
            "job_id": jt.job_id,
            "state": state,
            "error": getattr(status, "error", "") or "",
            "trace_id": jt.root.trace_id,
            "submitted_ms": jt.root.start_ms,
            "finished_ms": jt.root.end_ms or None,
            "wall_time_ms": round(jt.root.duration_ms, 3),
            "phases": {name: {"start_ms": s.start_ms,
                              "duration_ms": round(s.duration_ms, 3)}
                       for name, s in jt.phases.items()},
            "stages": [],
        }
        if graph is None:
            return prof
        for sid in sorted(graph.stages):
            stage = graph.stages[sid]
            tasks = []
            for info in stage.task_infos:
                if info is None:
                    continue
                tasks.append(_task_profile(info))
            # in-flight speculative duplicates: shown as their own
            # running entries so the profile explains where a slot went;
            # once the race resolves, only the winner keeps its task entry
            # (the loser's snapshot is excluded by the attempt guard in
            # _task_profile and ExecutionStage.operator_metrics)
            for spec in getattr(stage, "speculative_tasks", {}).values():
                tasks.append(_task_profile(spec))
            prof["stages"].append({
                "stage_id": sid,
                "state": stage.state,
                "attempt": stage.stage_attempt,
                "partitions": stage.partitions,
                "operators": stage.operator_metrics(),
                "tasks": tasks,
            })
        return prof


def _task_profile(info) -> Dict:
    st = getattr(info, "status", None)
    t = {"partition": info.partition,
         "executor_id": info.executor_id,
         "state": info.state,
         "attempt": getattr(info, "attempt", 0),
         "speculative": bool(getattr(info, "speculative", False))}
    if st is None:
        return t
    # attempt-aware dedup: a terminal status absorbed from a different
    # attempt (a cancelled speculative loser reporting late) must not
    # contribute its spans/metrics as if it were this task's run
    st_att = getattr(getattr(st, "task", None), "task_attempt", None)
    if st_att is not None and st_att != t["attempt"]:
        return t
    t.update(launch_ms=st.launch_time_ms, start_ms=st.start_time_ms,
             end_ms=st.end_time_ms,
             duration_ms=max(st.end_time_ms - st.start_time_ms, 0))
    ops = []
    for s in getattr(st, "spans", None) or []:
        if getattr(s, "kind", "") != "operator":
            continue
        ops.append({"op": s.name,
                    "start_ms": s.start_ms,
                    "duration_ms": round(s.duration_ms, 3),
                    "metrics": {k: v for k, v in s.attrs.items()
                                if k not in ("actor", "lane")}})
    t["operators"] = ops
    # cumulative per-operator snapshot keyed by plan path (the raw
    # material of stage['operators']; present even with tracing off)
    t["metrics"] = st.metrics or {}
    # device-observatory fold for this task (obs/device.py; empty when
    # the observatory is off — key omitted to mirror the wire form)
    if getattr(st, "device_stats", None):
        t["device"] = st.device_stats
    return t
