"""Cluster state: the executor pool and the job registry (in memory).

Mirrors the in-memory ``ClusterState`` and ``JobState`` of
arrow_ballista_tpu/scheduler/cluster.py.  Slot reservation is atomic under
a lock, with the reference's two distribution policies: "bias" packs onto
the fewest executors, "round-robin" spreads one slot an executor a cycle
(what makes a two-executor job read shuffle files across executors).
Memory pressure from the heartbeats orders both: a near-full executor is
offered work last.  The KV-backed variants come with the fleet
(ROADMAP.md queue 1 item 12 C).
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

from .execution_graph import ExecutionGraph
from .types import (
    ExecutorHeartbeat,
    ExecutorMetadata,
    ExecutorReservation,
    JobStatus,
)

DEFAULT_EXECUTOR_TIMEOUT_S = 180.0
# offers stop this long before the reaper declares a silent executor lost,
# so a slow-heartbeat executor drains its in-flight tasks instead of
# receiving doomed ones (capped at half the timeout)
OFFER_DRAIN_GRACE_S = 60.0


def alive_cutoff_s(timeout_s: float) -> float:
    """Heartbeat age beyond which an executor stops receiving offers."""
    return timeout_s - min(OFFER_DRAIN_GRACE_S, timeout_s / 2.0)


class ClusterState:
    """Executor slots + metadata + heartbeats."""

    def __init__(self, task_distribution: str = "bias"):
        if task_distribution not in ("bias", "round-robin"):
            raise ValueError(f"unknown task distribution {task_distribution!r}")
        self.task_distribution = task_distribution
        self._lock = threading.Lock()
        self._executors: Dict[str, ExecutorMetadata] = {}
        self._heartbeats: Dict[str, ExecutorHeartbeat] = {}
        self._available: Dict[str, int] = {}  # free task slots
        self._rr_cursor = 0

    # --- registration ----------------------------------------------------
    def register_executor(self, meta: ExecutorMetadata) -> None:
        with self._lock:
            fresh = meta.executor_id not in self._executors
            self._executors[meta.executor_id] = meta
            if fresh:
                self._available[meta.executor_id] = meta.task_slots
            self._heartbeats[meta.executor_id] = ExecutorHeartbeat(meta.executor_id)

    def remove_executor(self, executor_id: str) -> None:
        with self._lock:
            self._executors.pop(executor_id, None)
            self._available.pop(executor_id, None)
            hb = self._heartbeats.get(executor_id)
            if hb is not None:
                hb.status = "dead"

    def save_heartbeat(self, hb: ExecutorHeartbeat) -> None:
        with self._lock:
            self._heartbeats[hb.executor_id] = hb

    def touch_heartbeat(self, executor_id: str) -> None:
        """Refresh the timestamp without touching the status: a status
        report or a poll proves life, but must not flip a terminating
        executor back to active."""
        with self._lock:
            hb = self._heartbeats.get(executor_id)
            if hb is not None:
                hb.timestamp = time.time()
            else:
                self._heartbeats[executor_id] = ExecutorHeartbeat(executor_id)

    def _pressure_locked(self, executor_id: str) -> float:
        hb = self._heartbeats.get(executor_id)
        return hb.memory_pressure if hb is not None else 0.0

    def executors(self) -> List[ExecutorMetadata]:
        with self._lock:
            return list(self._executors.values())

    def get_executor(self, executor_id: str) -> Optional[ExecutorMetadata]:
        with self._lock:
            return self._executors.get(executor_id)

    def alive_executors(self, timeout_s: float = DEFAULT_EXECUTOR_TIMEOUT_S) -> List[str]:
        """Executors eligible for new work: active, with a heartbeat younger
        than ``alive_cutoff_s(timeout_s)``."""
        cutoff = alive_cutoff_s(timeout_s)
        now = time.time()
        with self._lock:
            return [eid for eid, hb in self._heartbeats.items()
                    if hb.status == "active" and now - hb.timestamp <= cutoff
                    and eid in self._executors]

    def expired_executors(self, timeout_s: float = DEFAULT_EXECUTOR_TIMEOUT_S) -> List[str]:
        """Executors with a 'dead' status or a heartbeat older than
        ``timeout_s``."""
        now = time.time()
        with self._lock:
            return [eid for eid in self._executors
                    if (hb := self._heartbeats.get(eid)) is not None
                    and (hb.status == "dead" or now - hb.timestamp > timeout_s)]

    # --- slots -----------------------------------------------------------
    def total_slots(self) -> int:
        with self._lock:
            return sum(m.task_slots for m in self._executors.values())

    def total_available(self) -> int:
        with self._lock:
            return sum(self._available.values())

    def reserve_slots(self, n: int, executors: Optional[List[str]] = None
                      ) -> List[ExecutorReservation]:
        """Atomically grab up to ``n`` free slots."""
        with self._lock:
            pool = executors if executors is not None else list(self._available)
            pool = [e for e in pool if e in self._available]
            out: List[ExecutorReservation] = []
            if self.task_distribution == "bias":
                # pack: drain one executor before touching the next
                for eid in sorted(pool, key=lambda e: (round(self._pressure_locked(e), 1),
                                                       -self._available[e])):
                    take = min(n - len(out), self._available[eid])
                    self._available[eid] -= take
                    out.extend(ExecutorReservation(eid) for _ in range(take))
                    if len(out) >= n:
                        break
                return out
            # round-robin: one slot an executor a cycle, from where the
            # last reservation stopped
            pool = sorted(pool, key=lambda e: (round(self._pressure_locked(e), 1), e))
            while len(out) < n and pool:
                progressed = False
                for i in range(len(pool)):
                    eid = pool[(self._rr_cursor + i) % len(pool)]
                    if self._available[eid] > 0:
                        self._available[eid] -= 1
                        out.append(ExecutorReservation(eid))
                        progressed = True
                        if len(out) >= n:
                            self._rr_cursor = (self._rr_cursor + i + 1) % len(pool)
                            break
                if not progressed:
                    break
            return out

    def cancel_reservations(self, reservations: List[ExecutorReservation]) -> None:
        with self._lock:
            for r in reservations:
                if r.executor_id in self._available:
                    self._available[r.executor_id] += 1

    def free_slots(self, executor_id: str, n: int = 1) -> None:
        with self._lock:
            if executor_id in self._available:
                cap = self._executors[executor_id].task_slots
                self._available[executor_id] = min(cap, self._available[executor_id] + n)


class JobState:
    """Job registry + graph store + completion signalling."""

    def __init__(self):
        self._lock = threading.Lock()
        self._status: Dict[str, JobStatus] = {}
        self._graphs: Dict[str, ExecutionGraph] = {}
        self._done: Dict[str, threading.Event] = {}

    def accept_job(self, job_id: str) -> None:
        with self._lock:
            self._status[job_id] = JobStatus(job_id, "queued")
            self._done[job_id] = threading.Event()

    def submit_job(self, job_id: str, graph: ExecutionGraph) -> None:
        with self._lock:
            self._graphs[job_id] = graph
            self._status[job_id] = JobStatus(job_id, "running")

    def get_graph(self, job_id: str) -> Optional[ExecutionGraph]:
        with self._lock:
            return self._graphs.get(job_id)

    def job_ids(self) -> List[str]:
        with self._lock:
            return sorted(self._graphs)

    def active_graphs(self) -> List[ExecutionGraph]:
        with self._lock:
            return [g for g in self._graphs.values() if g.status == "running"]

    def get_status(self, job_id: str) -> Optional[JobStatus]:
        with self._lock:
            return self._status.get(job_id)

    def set_status(self, status: JobStatus) -> None:
        with self._lock:
            self._status[status.job_id] = status
            done = self._done.get(status.job_id)
        if status.state in ("successful", "failed", "cancelled") and done is not None:
            done.set()

    def wait_for_completion(self, job_id: str, timeout: float = 300.0) -> JobStatus:
        with self._lock:
            done = self._done.get(job_id)
        if done is None:
            raise KeyError(job_id)
        done.wait(timeout)
        return self.get_status(job_id)
