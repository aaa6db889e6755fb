"""SchedulerServer: the event-driven scheduler state machine.

Mirrors the core of arrow_ballista_tpu/scheduler/scheduler.py that the
standalone engine drives:

- events JobQueued -> (planning on a worker) -> JobPlanned, TaskUpdating,
  ExecutorLost, JobCancel and Offer, all handled on one EventLoop, so
  state transitions are single-threaded;
- planning builds the job's ExecutionGraph, installs its AQE policy and
  its CompilePolicy, and fuses the stages that resolved at build time;
- push scheduling: free slots are reserved atomically ("bias" or
  "round-robin", scheduler/cluster.py), filled with pending tasks of the
  active jobs and launched through the ``TaskLauncher`` seam (the
  in-process launcher of standalone.py, or the network launcher of
  netservice.py);
- pull scheduling (``SchedulerConfig(policy="pull")``): executors poll
  (``poll_work``, a ``PollWork`` event on the same loop) with their
  statuses and free slots and get pending tasks back.  Without the
  reference's quarantine and admission gates: those come with ROADMAP.md
  queue 1 items 12 C and 12 D;
- heartbeats re-register an unknown executor from the metadata they
  carry, and reap the tasks an executor still runs for a finished job;
- a reaper thread expires executors whose heartbeats stopped;
- observability (obs/): a job span with its phases per job and the
  retained job profiles (``self.obs``), the flight-recorder journal of the
  job lifecycle, task launches and finishes and AQE rewrites, the cluster
  time series (``cluster_history``), the SLO tracker and, with
  ``ballista.live.enabled``, the in-flight doctor.

Still to be ported (ROADMAP.md queue 1): admission control, speculative
execution, executor quarantine and poison containment, job deadlines, the
serving caches, plan validation (analysis/plan_checks.py), fleet leases
and the KV backends.
"""
from __future__ import annotations

import dataclasses
import logging
import queue
import random
import string
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Tuple

from ..compile.fuse import CompilePolicy, fuse_resolved_stages
from ..obs import journal
from ..obs.profile import JobObservability
from ..obs.stats import ClusterHistory
from .aqe import AqePolicy
from .cluster import DEFAULT_EXECUTOR_TIMEOUT_S, ClusterState, JobState
from .event_loop import EventLoop
from .execution_graph import ExecutionGraph
from .types import (
    ExecutorHeartbeat,
    ExecutorMetadata,
    ExecutorReservation,
    JobStatus,
    TaskDescription,
    TaskId,
    TaskStatus,
)

log = logging.getLogger(__name__)


def random_job_id() -> str:
    """7-character alphanumeric job ids."""
    return "".join(random.choices(string.ascii_lowercase + string.digits, k=7))


class TaskLauncher:
    """Launch seam between the scheduler and its executors."""

    def launch_tasks(self, executor_id: str, tasks: List[TaskDescription]) -> None:
        raise NotImplementedError

    def cancel_tasks(self, executor_id: str, job_id: str) -> None:
        """Best-effort cancellation of a job's running tasks."""

    def cancel_task(self, executor_id: str, task: TaskId) -> None:
        """Best-effort cancellation of one running attempt."""

    def clean_job_data(self, executor_id: str, job_id: str) -> None:
        """Best-effort removal of a finished job's shuffle data."""

    def stop(self) -> None:
        pass


# --- events ----------------------------------------------------------------
@dataclasses.dataclass
class JobQueued:
    job_id: str
    # plan_fn() -> (root physical plan, scalar values); planning runs on a
    # worker thread, a failure becomes a failed JobPlanned
    plan_fn: Callable[[], Tuple[object, Dict[str, object]]]


@dataclasses.dataclass
class JobPlanned:
    job_id: str
    graph: Optional[ExecutionGraph]
    error: str = ""


@dataclasses.dataclass
class TaskUpdating:
    executor_id: str
    # None = drain the executor's status inbox (many reports fold into one
    # event); a list is processed verbatim
    statuses: Optional[List[TaskStatus]]


@dataclasses.dataclass
class ExecutorLost:
    executor_id: str
    reason: str = ""


@dataclasses.dataclass
class JobCancel:
    job_id: str


@dataclasses.dataclass
class Offer:
    """Try to hand out tasks."""


@dataclasses.dataclass
class PollWork:
    """A pull-mode work request: absorb the statuses, then fill the
    executor's free slots; the tasks travel back through ``reply``."""

    executor_id: str
    num_free_slots: int
    statuses: List[TaskStatus]
    reply: "queue.Queue"


class SchedulerConfig:
    def __init__(self, task_distribution: str = "bias",
                 executor_timeout_s: float = DEFAULT_EXECUTOR_TIMEOUT_S,
                 reaper_interval_s: float = 15.0,
                 event_buffer_size: int = 10000,
                 policy: str = "push",
                 job_data_cleanup_delay_s: float = 30.0,
                 stats_history_capacity: int = 512,
                 stats_history_interval_s: float = 5.0,
                 live_enabled: bool = False,
                 live_doctor_interval_s: float = 5.0,
                 slo_p99_target_ms: float = 0.0,
                 slo_window_s: float = 300.0):
        if policy not in ("push", "pull"):
            raise ValueError(f"unknown scheduling policy {policy!r}")
        # "bias" (pack) or "round-robin" (spread) slot reservation
        self.task_distribution = task_distribution
        # "push": the scheduler launches; "pull": executors poll_work
        self.policy = policy
        # one timeout drives "stop offering" (less the drain grace, see
        # cluster.alive_cutoff_s) and "declare lost" (the reaper)
        self.executor_timeout_s = float(executor_timeout_s)
        self.reaper_interval_s = reaper_interval_s
        self.event_buffer_size = event_buffer_size
        # delay before a finished job's shuffle data is removed (long
        # enough for the client to read the final stage); < 0 disables
        self.job_data_cleanup_delay_s = job_data_cleanup_delay_s
        # cluster time series (obs/stats.py ClusterHistory)
        self.stats_history_capacity = int(stats_history_capacity)
        self.stats_history_interval_s = float(stats_history_interval_s)
        # live observability plane (obs/live.py, obs/slo.py)
        self.live_enabled = bool(live_enabled)
        self.live_doctor_interval_s = float(live_doctor_interval_s)
        self.slo_p99_target_ms = float(slo_p99_target_ms)
        self.slo_window_s = float(slo_window_s)

    @staticmethod
    def from_config(cfg) -> "SchedulerConfig":
        """The ``ballista.cluster.executor_timeout_s``,
        ``ballista.stats.*``, ``ballista.live.*`` and ``ballista.slo.*``
        keys of a session's BallistaConfig."""
        from ..utils import config as C

        return SchedulerConfig(
            executor_timeout_s=float(cfg.get(C.CLUSTER_EXECUTOR_TIMEOUT_S)),
            stats_history_capacity=int(cfg.get(C.STATS_HISTORY_CAPACITY)),
            stats_history_interval_s=float(cfg.get(C.STATS_HISTORY_INTERVAL_S)),
            live_enabled=bool(cfg.get(C.LIVE_ENABLED)),
            live_doctor_interval_s=float(cfg.get(C.LIVE_DOCTOR_INTERVAL_S)),
            slo_p99_target_ms=float(cfg.get(C.SLO_P99_TARGET_MS)),
            slo_window_s=float(cfg.get(C.SLO_WINDOW_S)))


class SchedulerServer:
    def __init__(self, launcher: TaskLauncher, config: Optional[SchedulerConfig] = None,
                 observability: Optional[JobObservability] = None):
        self.config = config or SchedulerConfig()
        self.cluster = ClusterState(self.config.task_distribution)
        self.jobs = JobState()
        self.launcher = launcher
        self.scheduler_id = "scheduler-" + "".join(
            random.choices(string.ascii_lowercase + string.digits, k=8))
        # tracing + profile retention (obs/profile.py): phase spans per
        # job, task span intake, the profiles the forensics bundle reads
        self.obs = observability if observability is not None else JobObservability()
        # flight recorder: enable-only (the process-global journal is shared
        # with the in-process executors, which enable it from the session)
        from ..utils.config import (JOURNAL_CAPACITY, JOURNAL_ENABLED, JOURNAL_SPILL_PATH,
                                    BallistaConfig, env_flag)

        defaults = BallistaConfig()
        if env_flag("BALLISTA_JOURNAL") or bool(defaults.get(JOURNAL_ENABLED)):
            journal.set_enabled(True)
        if journal.enabled():
            journal.configure(capacity=int(defaults.get(JOURNAL_CAPACITY)),
                              spill_path=str(defaults.get(JOURNAL_SPILL_PATH)))
            if not journal.actor():
                journal.set_actor(self.scheduler_id)
        from ..obs.live import LiveDoctor
        from ..obs.slo import NullSloTracker, SloPolicy, SloTracker

        self.live_doctor = LiveDoctor()
        self.slo = (SloTracker(SloPolicy(self.config.slo_p99_target_ms,
                                         self.config.slo_window_s))
                    if self.config.slo_p99_target_ms > 0 else NullSloTracker())
        self.history = ClusterHistory(self.config.stats_history_capacity,
                                      self.config.stats_history_interval_s)
        # job_id -> submission wall time (ms): the SLO's queue-to-done time
        self._queued_at_ms: Dict[str, int] = {}
        self._history_sampler: Optional[threading.Thread] = None
        self._live_doctor_thread: Optional[threading.Thread] = None
        # job_id -> the submitting session's BallistaConfig (read at planning)
        self._meta_lock = threading.Lock()
        self._job_configs: Dict[str, object] = {}
        # counters of AQE rewrites and job outcomes
        self.counters: Dict[str, int] = {}
        # status-report coalescing: executors append under the lock; the
        # event loop drains an executor's whole inbox in one TaskUpdating
        self._status_lock = threading.Lock()
        self._status_inbox: Dict[str, List[TaskStatus]] = {}
        self._event_loop = EventLoop("scheduler-events", self._on_event,
                                     self.config.event_buffer_size,
                                     on_error=self._on_event_error)
        self._launch_pool = ThreadPoolExecutor(max_workers=8, thread_name_prefix="launch")
        self._reaper: Optional[threading.Thread] = None
        self._stopped = threading.Event()
        self._cleanup_timers: Dict[str, threading.Timer] = {}
        self._cleanup_lock = threading.Lock()

    def _count(self, name: str, n: int = 1) -> None:
        with self._meta_lock:
            self.counters[name] = self.counters.get(name, 0) + n

    # --- lifecycle -------------------------------------------------------
    def init(self, start_reaper: bool = True) -> None:
        self._event_loop.start()
        if start_reaper:
            self._reaper = threading.Thread(target=self._reap_loop, name="executor-reaper",
                                            daemon=True)
            self._reaper.start()
        self._history_sampler = threading.Thread(target=self._history_loop,
                                                 name="cluster-history-sampler", daemon=True)
        self._history_sampler.start()
        if self.config.live_enabled and self.config.live_doctor_interval_s > 0:
            self._live_doctor_thread = threading.Thread(target=self._live_doctor_loop,
                                                        name="live-doctor", daemon=True)
            self._live_doctor_thread.start()

    def shutdown(self) -> None:
        # stop the event loop before the launch pool, so no handler races a
        # submit against the pool's shutdown
        self._stopped.set()
        for t in (self._reaper, self._history_sampler, self._live_doctor_thread):
            if t is not None:
                t.join(timeout=5.0)
        with self._cleanup_lock:
            timers = list(self._cleanup_timers.values())
            self._cleanup_timers.clear()
        for t in timers:
            t.cancel()
        self._event_loop.stop()
        self._launch_pool.shutdown(wait=False)
        self.launcher.stop()

    def _submit_work(self, fn, *args) -> None:
        """Submit to the launch pool, tolerating shutdown races."""
        if self._stopped.is_set():
            return
        try:
            self._launch_pool.submit(fn, *args)
        except RuntimeError:  # the pool closed between the check and the submit
            log.info("dropping work submitted during shutdown")

    # --- public API ------------------------------------------------------
    def register_executor(self, meta: ExecutorMetadata) -> None:
        self.cluster.register_executor(meta)
        self._event_loop.post(Offer())

    def heartbeat(self, hb: ExecutorHeartbeat) -> None:
        known = self.cluster.get_executor(hb.executor_id) is not None
        self.cluster.save_heartbeat(hb)
        if not known and hb.metadata is not None:
            # a restarted scheduler relearns the executor from its beat
            log.info("re-registering unknown heartbeater %s", hb.executor_id)
            self.register_executor(hb.metadata)
            # registration installs an 'active' beat: keep the reported one
            self.cluster.save_heartbeat(hb)
        for job_id in sorted({entry[0] for entry in hb.running}):
            # the executor still runs tasks of a finished or unknown job (a
            # cancel it never got): cancel them again
            st = self.jobs.get_status(job_id)
            if st is None or st.state in ("successful", "failed", "cancelled"):
                log.warning("reaping zombie tasks of job %s on %s", job_id, hb.executor_id)
                self._submit_work(self.launcher.cancel_tasks, hb.executor_id, job_id)

    def executor_stopped(self, executor_id: str, reason: str = "") -> None:
        self._event_loop.post(ExecutorLost(executor_id, reason))

    def submit_job(self, job_id: str,
                   plan_fn: Callable[[], Tuple[object, Dict[str, object]]],
                   config: Optional[object] = None,
                   trace: Optional[Dict[str, str]] = None) -> None:
        """``config``: the submitting session's BallistaConfig, read at
        planning for ``ballista.aqe.*`` and ``ballista.compile.*`` (None =
        defaults).  ``trace``: the client's propagation context
        (obs/tracing.py ``new_trace_context``), the parent of the job span."""
        self.jobs.accept_job(job_id)
        self.obs.on_submitted(job_id, trace)
        if journal.enabled():
            journal.emit_job("job.submitted", job_id)
        with self._meta_lock:
            if config is not None:
                self._job_configs[job_id] = config
            self._queued_at_ms[job_id] = int(time.time() * 1000)
        # no admission queue in the port: the job is admitted at once
        self.obs.on_admitted(job_id)
        self._event_loop.post(JobQueued(job_id, plan_fn))

    def update_task_status(self, executor_id: str, statuses: List[TaskStatus]) -> None:
        # post a drain event only when the inbox was empty: reports landing
        # while one event is in flight are absorbed by that event
        with self._status_lock:
            box = self._status_inbox.setdefault(executor_id, [])
            was_empty = not box
            box.extend(statuses)
        if was_empty:
            self._event_loop.post(TaskUpdating(executor_id, None))

    def cancel_job(self, job_id: str) -> None:
        self._event_loop.post(JobCancel(job_id))

    def poll_work(self, executor_id: str, num_free_slots: int,
                  statuses: List[TaskStatus], timeout: float = 10.0) -> List[TaskDescription]:
        """Pull mode (blocking): absorb ``statuses`` and return up to
        ``num_free_slots`` tasks for ``executor_id``."""
        reply: "queue.Queue" = queue.Queue(maxsize=1)
        self._event_loop.post(PollWork(executor_id, num_free_slots, statuses, reply))
        try:
            return reply.get(timeout=timeout)
        except queue.Empty:
            return []

    def get_job_status(self, job_id: str) -> Optional[JobStatus]:
        return self.jobs.get_status(job_id)

    def wait_for_job(self, job_id: str, timeout: float = 300.0) -> JobStatus:
        return self.jobs.wait_for_completion(job_id, timeout)

    def pending_task_count(self) -> int:
        return sum(g.available_task_count() for g in self.jobs.active_graphs())

    # --- event machine ---------------------------------------------------
    def _on_event_error(self, event: object, exc: BaseException) -> None:
        """A handler crash fails the affected jobs instead of leaving their
        clients waiting on a forever-running status."""
        job_ids = set()
        jid = getattr(event, "job_id", None)
        if jid:
            job_ids.add(jid)
        statuses = getattr(event, "statuses", None)
        if statuses is None and isinstance(event, TaskUpdating):
            with self._status_lock:
                statuses = self._status_inbox.pop(event.executor_id, [])
        for st in statuses or []:
            job_ids.add(st.task.job_id)
        for job_id in job_ids:
            st = self.jobs.get_status(job_id)
            if st is not None and st.state in ("successful", "failed", "cancelled"):
                continue
            graph = self.jobs.get_graph(job_id)
            if graph is not None and graph.status == "running":
                graph.status = "failed"
            self._finish(JobStatus(
                job_id, "failed",
                error=f"scheduler event handler crashed: {type(exc).__name__}: {exc}"))

    def _on_event(self, event: object) -> None:
        if isinstance(event, JobQueued):
            self._on_job_queued(event)
        elif isinstance(event, JobPlanned):
            self._on_job_planned(event)
        elif isinstance(event, TaskUpdating):
            self._on_task_updating(event)
        elif isinstance(event, ExecutorLost):
            self._on_executor_lost(event)
        elif isinstance(event, JobCancel):
            self._on_job_cancel(event)
        elif isinstance(event, Offer):
            self._offer()
        elif isinstance(event, PollWork):
            self._on_poll_work(event)
        else:
            log.warning("unknown scheduler event %r", event)

    def _on_job_queued(self, ev: JobQueued) -> None:
        # planning (scalar subqueries included) can take seconds: off the loop
        def plan():
            try:
                with self._meta_lock:
                    cfg = self._job_configs.pop(ev.job_id, None)
                plan, scalars = ev.plan_fn()
                graph = ExecutionGraph.build(ev.job_id, plan)
                graph.aqe = AqePolicy.from_config(cfg)
                # the policy arms revive()-time fusion of downstream stages;
                # the leaf stages that resolved during the build fuse here,
                # before any task launches
                graph.compiler = CompilePolicy.from_config(cfg)
                fuse_resolved_stages(graph)
                graph.scalars = scalars
                graph.addr_resolver = self._resolve_addr
                self._event_loop.post(JobPlanned(ev.job_id, graph))
            except Exception as e:  # noqa: BLE001 — a planning failure fails the job
                log.exception("planning failed for job %s", ev.job_id)
                self._event_loop.post(JobPlanned(ev.job_id, None,
                                                 f"planning error: {type(e).__name__}: {e}"))

        self._submit_work(plan)

    def _on_job_planned(self, ev: JobPlanned) -> None:
        if ev.graph is None:
            if journal.enabled():
                journal.emit_job("job.plan_failed", ev.job_id, error=ev.error)
            self._finish(JobStatus(ev.job_id, "failed", error=ev.error))
            return
        self.obs.on_planned(ev.job_id)
        if journal.enabled():
            journal.emit_job("job.planned", ev.job_id, stages=len(ev.graph.stages))
        # hand the execution span's context to every task of this job
        ev.graph.trace = self.obs.task_parent(ev.job_id)
        self.jobs.submit_job(ev.job_id, ev.graph)
        self._offer()

    def _finish(self, status: JobStatus, graph: Optional[ExecutionGraph] = None) -> None:
        """A job's terminal status: its profile is retained (obs/profile.py),
        its wall time recorded against the SLO, its outcome counted, and
        then the status set (which wakes the waiting client)."""
        with self._meta_lock:
            queued_at = self._queued_at_ms.pop(status.job_id, 0)
        try:
            self.obs.on_finished(status, graph or self.jobs.get_graph(status.job_id))
        except Exception:  # noqa: BLE001 — observability is best-effort
            log.exception("profile finalization failed for %s", status.job_id)
        if status.state == "successful":
            if queued_at:
                self.slo.record(int(time.time() * 1000) - queued_at, ok=True)
        elif status.state == "failed":
            # a failed job always burns SLO budget, whatever its wall time
            self.slo.record(int(time.time() * 1000) - queued_at if queued_at else 0.0,
                            ok=False)
        self._count({"successful": "jobs_successful", "failed": "jobs_failed",
                     "cancelled": "jobs_cancelled"}[status.state])
        self.jobs.set_status(status)

    def _on_task_updating(self, ev: TaskUpdating) -> None:
        statuses = ev.statuses
        if statuses is None:
            with self._status_lock:
                statuses = self._status_inbox.pop(ev.executor_id, [])
        if not statuses:
            return  # a sibling event already drained this inbox
        self.cluster.free_slots(ev.executor_id, len(statuses))
        self._absorb_statuses(ev.executor_id, statuses)
        self._offer()

    def _on_poll_work(self, ev: PollWork) -> None:
        tasks: List[TaskDescription] = []
        try:
            # timestamp only: a draining executor's poll keeps it draining
            self.cluster.touch_heartbeat(ev.executor_id)
            if ev.statuses:
                self._absorb_statuses(ev.executor_id, ev.statuses)
            graphs = self.jobs.active_graphs()
            # retry anti-affinity context (see pop_next_task)
            alive = set(self.cluster.alive_executors(self.config.executor_timeout_s))
            while len(tasks) < ev.num_free_slots:
                task = None
                for graph in graphs:
                    task = graph.pop_next_task(ev.executor_id, alive=alive)
                    if task is not None:
                        break
                if task is None:
                    break
                tasks.append(task)
        finally:
            ev.reply.put(tasks)

    def _absorb_statuses(self, executor_id: str, statuses: List[TaskStatus]) -> None:
        """The status intake of push (TaskUpdating) and pull (PollWork)."""
        by_job: Dict[str, List[TaskStatus]] = {}
        for st in statuses:
            if st.journal:
                # the executor's flight-record buffer: merged into the job's
                # timeline (in-process executors' events dedup by seq)
                journal.absorb(st.task.job_id, st.journal)
            if journal.enabled():
                journal.emit("task.finish", job_id=st.task.job_id,
                             parent_key=("task", st.task.job_id, st.task.stage_id,
                                         st.task.partition, st.task.task_attempt),
                             stage_id=st.task.stage_id, partition=st.task.partition,
                             attempt=st.task.task_attempt, state=st.state,
                             executor_id=st.executor_id or executor_id)
            by_job.setdefault(st.task.job_id, []).append(st)
        for job_id, sts in by_job.items():
            graph = self.jobs.get_graph(job_id)
            if graph is None:
                continue
            try:
                self._absorb_job_statuses(job_id, graph, sts)
            except Exception as e:  # noqa: BLE001 — scope the blast radius to the job
                log.exception("status absorption crashed for job %s", job_id)
                st = self.jobs.get_status(job_id)
                if st is not None and st.state in ("successful", "failed", "cancelled"):
                    continue
                if graph.status == "running":
                    graph.status = "failed"
                self._finish(JobStatus(
                    job_id, "failed",
                    error=f"status absorption crashed: {type(e).__name__}: {e}"), graph)

    def _absorb_job_statuses(self, job_id: str, graph: ExecutionGraph,
                             sts: List[TaskStatus]) -> None:
        for kind, payload in graph.update_task_status(sts):
            if kind == "cancel_task":
                executor_id, task_id = payload
                self._submit_work(self._cancel_one, executor_id, task_id)
            elif kind == "job_successful":
                if journal.enabled():
                    journal.emit_job("job.successful", job_id)
                self._finish(JobStatus(job_id, "successful", locations=payload), graph)
                self._schedule_job_data_cleanup(graph)
            elif kind == "job_failed":
                if journal.enabled():
                    journal.emit_job("job.failed", job_id, error=str(payload))
                self._finish(JobStatus(job_id, "failed", error=str(payload)), graph)
                self._cancel_running(graph)
                self._schedule_job_data_cleanup(graph)
        self._drain_aqe_events(graph)

    def _drain_aqe_events(self, graph: ExecutionGraph) -> None:
        """Fold the graph's buffered AQE rewrite events into the counters
        (and the journal)."""
        for kind, n in graph.aqe_events:
            if journal.enabled():
                journal.emit("aqe.rewrite", job_id=graph.job_id, rewrite=kind, partitions=n)
            self._count(f"aqe_{kind}", n)
        graph.aqe_events.clear()

    def _on_executor_lost(self, ev: ExecutorLost) -> None:
        log.info("executor %s lost: %s", ev.executor_id, ev.reason)
        self.cluster.remove_executor(ev.executor_id)
        for graph in self.jobs.active_graphs():
            graph.executor_lost(ev.executor_id)
            self._drain_aqe_events(graph)
        self._offer()

    def _on_job_cancel(self, ev: JobCancel) -> None:
        graph = self.jobs.get_graph(ev.job_id)
        if graph is None or graph.status != "running":
            return
        graph.cancel()
        if journal.enabled():
            journal.emit_job("job.cancelled", ev.job_id)
        self._finish(JobStatus(ev.job_id, "cancelled"), graph)
        self._cancel_running(graph)
        self._schedule_job_data_cleanup(graph)

    # --- job-data cleanup ------------------------------------------------
    def _schedule_job_data_cleanup(self, graph: ExecutionGraph) -> None:
        """A delayed removal of the finished job's shuffle data on every
        executor that holds some (every executor, when the job did not
        succeed: a late task may have written what no stage recorded)."""
        delay = self.config.job_data_cleanup_delay_s
        if delay < 0 or self._stopped.is_set():
            return
        executors = {eid for stage in graph.stages.values()
                     for (eid, _w) in stage.outputs.values()}
        status = self.jobs.get_status(graph.job_id)
        if status is None or status.state != "successful":
            executors |= {m.executor_id for m in self.cluster.executors()}
        executors = sorted(executors)
        if not executors:
            return
        job_id = graph.job_id

        def fanout():
            with self._cleanup_lock:
                self._cleanup_timers.pop(job_id, None)
            if self._stopped.is_set():
                return
            for eid in executors:
                try:
                    self.launcher.clean_job_data(eid, job_id)
                except Exception:  # noqa: BLE001 — best effort
                    log.warning("clean_job_data on %s failed", eid, exc_info=True)

        timer = threading.Timer(delay, fanout)
        timer.daemon = True
        with self._cleanup_lock:
            old = self._cleanup_timers.pop(job_id, None)
            self._cleanup_timers[job_id] = timer
        if old is not None:
            old.cancel()
        timer.start()

    def _cancel_one(self, executor_id: str, task_id: TaskId) -> None:
        try:
            self.launcher.cancel_task(executor_id, task_id)
        except Exception:  # noqa: BLE001 — best effort
            log.warning("cancel_task on %s failed for %s", executor_id, task_id,
                        exc_info=True)

    def _cancel_running(self, graph: ExecutionGraph) -> None:
        for eid in {eid for _, _, eid in graph.running_tasks()}:
            try:
                self.launcher.cancel_tasks(eid, graph.job_id)
            except Exception:  # noqa: BLE001
                log.exception("cancel_tasks failed for %s", eid)

    def _resolve_addr(self, executor_id: str):
        meta = self.cluster.get_executor(executor_id)
        return (meta.host, meta.port, meta.grpc_port) if meta is not None else ("", 0, 0)

    # --- push scheduling -------------------------------------------------
    def _offer(self) -> None:
        """Reserve free slots and fill them with pending tasks."""
        if self.config.policy != "push":
            return  # pull mode: executors come to us through poll_work
        pending = self.pending_task_count()
        alive = set(self.cluster.alive_executors(self.config.executor_timeout_s))
        if pending == 0 or not alive:
            return
        reservations = self.cluster.reserve_slots(pending, sorted(alive))
        if not reservations:
            return
        assignments: Dict[str, List[TaskDescription]] = {}
        graphs = self.jobs.active_graphs()

        def fill(rs: List[ExecutorReservation]) -> List[ExecutorReservation]:
            leftovers: List[ExecutorReservation] = []
            for r in rs:
                task = None
                for graph in graphs:
                    task = graph.pop_next_task(r.executor_id, alive=alive)
                    if task is not None:
                        break
                if task is None:
                    leftovers.append(r)
                else:
                    assignments.setdefault(r.executor_id, []).append(task)
            return leftovers

        unused = fill(reservations)
        if unused:
            # retry anti-affinity can veto every reserved executor while
            # another alive executor could run the task: one bounded second
            # pass over the executors the first round never tried
            vetoed = {r.executor_id for r in unused}
            self.cluster.cancel_reservations(unused)
            retry_pool = sorted(alive - vetoed)
            if retry_pool:
                unused = fill(self.cluster.reserve_slots(len(vetoed), retry_pool))
                if unused:
                    self.cluster.cancel_reservations(unused)
        for executor_id, tasks in assignments.items():
            self._submit_work(self._launch, executor_id, tasks)

    def _launch(self, executor_id: str, tasks: List[TaskDescription]) -> None:
        try:
            self.launcher.launch_tasks(executor_id, tasks)
        except Exception as e:  # noqa: BLE001 — treated as an executor failure
            log.exception("launch on %s failed", executor_id)
            self.cluster.free_slots(executor_id, len(tasks))
            self._event_loop.post(ExecutorLost(executor_id, f"launch failed: {e}"))

    # --- cluster time series and the live plane (obs/) -------------------
    def cluster_sample(self) -> Dict:
        """One utilization/saturation sample (a pure read)."""
        total = self.cluster.total_slots()
        available = self.cluster.total_available()
        ev = self._event_loop.stats()
        return {
            "ts": round(time.time(), 3),
            "executors_alive": len(self.cluster.alive_executors(self.config.executor_timeout_s)),
            "executors_total": len(self.cluster.executors()),
            "total_slots": total,
            "available_slots": available,
            "utilization": round((total - available) / total, 4) if total else 0.0,
            "pending_tasks": self.pending_task_count(),
            "active_jobs": len(self.jobs.active_graphs()),
            "event_queue_depth": ev["queue_depth"],
            "event_loop_lag_s": ev["last_lag_s"],
            "event_loop_max_lag_s": ev["max_lag_s"],
            "event_handler_seconds_mean": ev["handler_seconds_mean"],
            "slow_events": ev["slow_events"],
        }

    def cluster_history(self) -> Dict:
        """The sample ring plus a fresh sample (``now``)."""
        out = self.history.snapshot()
        out["now"] = self.cluster_sample()
        return out

    def slo_report(self) -> Dict:
        """The SLO burn-rate report (``{"enabled": false}`` without a
        target)."""
        return self.slo.snapshot()

    def _history_loop(self) -> None:
        while not self._stopped.wait(self.config.stats_history_interval_s):
            try:
                self.history.record(self.cluster_sample())
            except Exception:  # noqa: BLE001 — sampling must outlive one bad read
                log.exception("cluster history sampling failed")

    def _live_doctor_loop(self) -> None:
        while not self._stopped.wait(self.config.live_doctor_interval_s):
            try:
                self.live_doctor.scan(self)
            except Exception:  # noqa: BLE001 — scan again next interval
                log.exception("live doctor scan failed")

    # --- failure detection ----------------------------------------------
    def _reap_loop(self) -> None:
        while not self._stopped.wait(self.config.reaper_interval_s):
            for eid in self.cluster.expired_executors(self.config.executor_timeout_s):
                self._event_loop.post(ExecutorLost(eid, "heartbeat timeout"))
