"""Executor: runs query-stage tasks on a pool of task slots and reports
their status.

Mirrors arrow_ballista_tpu/executor/executor.py: a ThreadPoolExecutor of
``concurrent_tasks`` slots, cooperative job and task cancellation, and the
mapping of a task's outcome onto the failure taxonomy.  Every task of an
executor runs on its device's current stream.  Its memory governor is
shared by its task slots.  ``run_task`` owns the task's observability —
its span tree (obs/tracing.py), its device-observatory scope
(obs/device.py: the launches of the task's kernels, their event times),
its flight-recorder buffer (obs/journal.py) and the process counters
(executor/metrics.py) — and passes the ``executor.task.before_run`` and
``executor.task.slow`` failpoints (faults/).
"""
from __future__ import annotations

import logging
import os
import shutil
import threading
import time
import traceback
import uuid
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, Optional, Set

import torch

from .. import faults
from ..memory import MemoryGovernor
from ..compile import programs
from ..ops.physical import TaskContext
from ..scheduler.types import (
    EXECUTION_ERROR,
    FETCH_PARTITION_ERROR,
    IO_ERROR,
    RESOURCE_EXHAUSTED,
    ExecutorMetadata,
    FailedReason,
    TaskDescription,
    TaskStatus,
)
from ..utils.config import BallistaConfig
from ..utils.errors import (CancelledError, ExecutorKilled, FetchFailedError, IntegrityError,
                            IOError_, MemoryExhausted, ResourceExhausted)
from .execution_engine import DefaultExecutionEngine, ExecutionEngine

log = logging.getLogger(__name__)

# one id per executor process: the stage's metric fold keys cumulative
# snapshots by it and the plan instance (TaskStatus.process_id)
PROCESS_ID = uuid.uuid4().hex[:12]


def remove_job_data(work_dir: str, job_id: str) -> None:
    """Delete ``<work_dir>/<job_id>`` (guarded against path traversal) and
    drop the job's cached broadcast build sides."""
    from ..ops.operators import clear_job_build_caches

    root = os.path.realpath(work_dir)
    job_dir = os.path.realpath(os.path.join(work_dir, job_id))
    if job_dir != root and os.path.commonpath([job_dir, root]) == root \
            and os.path.isdir(job_dir):
        shutil.rmtree(job_dir, ignore_errors=True)
    clear_job_build_caches(job_id)


class Executor:
    def __init__(self, metadata: ExecutorMetadata, work_dir: str,
                 config: Optional[BallistaConfig] = None,
                 engine: Optional[ExecutionEngine] = None,
                 concurrent_tasks: int = 4, device=None):
        self.metadata = metadata
        self.work_dir = work_dir
        self.config = config or BallistaConfig()
        self.engine = engine or DefaultExecutionEngine()
        self.device = torch.device("cuda" if device is None else device)
        # memory governor: operators holding unbounded state (join builds,
        # aggregation groups) reserve before materializing and spill on a
        # denial; one per executor, shared by its task slots
        self.governor = MemoryGovernor.from_config(self.config)
        self.pool = ThreadPoolExecutor(max_workers=concurrent_tasks,
                                       thread_name_prefix=f"task-{metadata.executor_id}")
        # job-level and single-attempt cancel flags (threads cannot be
        # killed: a cancelled task stops at its next checkpoint, or its
        # result is dropped as 'killed'); bounded
        self._cancelled_jobs: "OrderedDict[str, None]" = OrderedDict()
        self._cancelled_tasks: "OrderedDict[tuple, None]" = OrderedDict()
        self._max_cancelled = 1024
        self._lock = threading.Lock()
        # in-flight tasks, (job, stage, partition, attempt): the heartbeat's
        # running set, the janitor's live jobs and the free-slot count of
        # pull mode (executor/server.py)
        self._inflight: Set[tuple] = set()
        # prometheus-style process counters (always collected: a few ints)
        from .metrics import ExecutorMetrics

        self.metrics = ExecutorMetrics()
        from ..obs import device as device_obs
        from ..obs import journal
        from ..utils.config import (JOURNAL_CAPACITY, JOURNAL_ENABLED, JOURNAL_SPILL_PATH,
                                    OBS_DEVICE_ENABLED, OBS_DEVICE_WATERMARKS, OBS_TRACING,
                                    env_flag)

        self._tracing = bool(self.config.get(OBS_TRACING))
        # the device observatory's switches are process-global (the launch
        # registry and the transfer sites are process-wide); the executors
        # of one process share one config in practice
        device_obs.set_enabled(bool(self.config.get(OBS_DEVICE_ENABLED)))
        device_obs.set_watermarks(bool(self.config.get(OBS_DEVICE_WATERMARKS)))
        # flight recorder: enable-only (in-process executors share the
        # scheduler's process-global journal, and a default-config executor
        # must not turn off a session's explicit enable)
        if env_flag("BALLISTA_JOURNAL") or bool(self.config.get(JOURNAL_ENABLED)):
            journal.set_enabled(True)
            journal.configure(capacity=int(self.config.get(JOURNAL_CAPACITY)),
                              spill_path=str(self.config.get(JOURNAL_SPILL_PATH)))
        if journal.enabled() and not journal.actor():
            journal.set_actor(metadata.executor_id)

    # --- task execution --------------------------------------------------
    def run_task(self, task: TaskDescription) -> TaskStatus:
        """Execute one task synchronously (``submit_task`` runs it on the
        pool).

        This wrapper owns observability — the task span tree (parented on
        the job's execution span via ``task.trace``), the device scope, the
        journal buffer and the process counters; ``_run_task_inner`` owns
        execution and the failure taxonomy.  Spans attach to every outcome,
        so failed tasks profile too."""
        from ..obs import device as device_obs
        from ..obs import journal

        tid = task.task
        launch_ms = int(time.time() * 1000)
        recorder = None
        if self._tracing:
            from ..obs.tracing import TaskSpanRecorder

            trace = task.trace or {}
            recorder = TaskSpanRecorder(
                trace.get("trace_id"), trace.get("span_id", ""),
                name=f"task {tid.job_id}/{tid.stage_id}/{tid.partition}",
                kind="executor",
                attrs={"job_id": tid.job_id, "stage_id": tid.stage_id,
                       "partition": tid.partition, "task_attempt": tid.task_attempt,
                       "executor_id": self.metadata.executor_id,
                       "actor": f"executor {self.metadata.executor_id}",
                       "lane": f"stage {tid.stage_id} / p{tid.partition}"})
        t0 = time.perf_counter()
        with device_obs.task_scope(self.device) as dev_acc, journal.task_scope() as jbuf:
            if jbuf is not None:
                journal.emit("task.run", job_id=tid.job_id, stage_id=tid.stage_id,
                             partition=tid.partition, attempt=tid.task_attempt,
                             executor_id=self.metadata.executor_id, speculative=False)
            status, stage_exec = self._run_task_inner(task, launch_ms, recorder)
        if dev_acc is not None:
            status.device_stats = dev_acc.snapshot()
            if stage_exec is not None and status.device_stats.get("kernel_ms"):
                # the launches' event times resolved as the device scope
                # closed: the operators' snapshot is taken again to hold them
                status.metrics = stage_exec.collect_plan_metrics()
        if jbuf:
            # the task's flight-record buffer rides on its status (merged
            # into the job timeline scheduler-side)
            status.journal = jbuf
        if recorder is not None:
            if status.shuffle_writes:
                recorder.annotate(
                    rows_written=int(sum(w.num_rows for w in status.shuffle_writes)),
                    bytes_shuffled=int(sum(w.num_bytes for w in status.shuffle_writes)),
                    output_partitions=len(status.shuffle_writes))
            status.spans = recorder.finish("ok" if status.state == "success" else status.state)
        self.metrics.record_task(status, time.perf_counter() - t0)
        return status

    def _run_task_inner(self, task: TaskDescription, launch_ms: int, recorder):
        """(status, the stage's exec or None)."""
        tid = task.task
        key = (tid.job_id, tid.stage_id, tid.partition, tid.task_attempt)
        with self._lock:
            self._inflight.add(key)
        try:
            return self._run_task_body(task, launch_ms, recorder)
        finally:
            with self._lock:
                self._inflight.discard(key)

    def _run_task_body(self, task: TaskDescription, launch_ms: int, recorder):
        tid = task.task
        try:
            if self._is_cancelled(tid):
                return TaskStatus(tid, self.metadata.executor_id, "killed"), None
            faults.inject("executor.task.before_run", executor_id=self.metadata.executor_id,
                          job_id=tid.job_id, stage_id=tid.stage_id, partition=tid.partition,
                          task_attempt=tid.task_attempt)
            stage_exec = self.engine.create_query_stage_exec(
                tid.job_id, tid.stage_id, task.plan, self.work_dir)
            ctx = TaskContext(device=self.device, config=self.config,
                              scalars=dict(task.scalars), work_dir=self.work_dir,
                              job_id=tid.job_id, stage_id=tid.stage_id,
                              executor_id=self.metadata.executor_id,
                              executor_host=self.metadata.host,
                              cancelled=lambda: self._is_cancelled(tid),
                              governor=self.governor, span_recorder=recorder)
            # the stage's generated programs, traced and built before its
            # first batch (a no-op on the CPU and once built)
            programs.prepare(task.plan, ctx)
            start_ms = int(time.time() * 1000)
            # deterministic straggler: a 'delay' rule stalls the task here
            faults.inject("executor.task.slow", executor_id=self.metadata.executor_id,
                          job_id=tid.job_id, stage_id=tid.stage_id, partition=tid.partition,
                          task_attempt=tid.task_attempt, speculative=False)
            writes = stage_exec.execute_query_stage(tid.partition, ctx)
            end_ms = int(time.time() * 1000)
            if self._is_cancelled(tid):
                return TaskStatus(tid, self.metadata.executor_id, "killed"), None
            return TaskStatus(tid, self.metadata.executor_id, "success",
                              shuffle_writes=writes, launch_time_ms=launch_ms,
                              start_time_ms=start_ms, end_time_ms=end_ms,
                              metrics=stage_exec.collect_plan_metrics(),
                              # the plan instance: a process may hold several
                              # of one stage (a re-resolved plan decodes anew)
                              process_id=f"{PROCESS_ID}-{id(task.plan):x}"), stage_exec
        except (CancelledError, ExecutorKilled):
            # a cancel noticed between batches, or the faults kill action
            # (the executor simulating SIGKILL): the task unwinds as killed
            return TaskStatus(tid, self.metadata.executor_id, "killed"), None
        except FetchFailedError as e:
            return TaskStatus(tid, self.metadata.executor_id, "failed",
                              failure=FailedReason(FETCH_PARTITION_ERROR, str(e),
                                                   map_stage_id=e.map_stage_id,
                                                   map_partition_id=e.map_partition_id,
                                                   executor_id=e.executor_id)), None
        except (MemoryExhausted, ResourceExhausted) as e:
            # a denial the operator could not degrade to spill (spill
            # disabled): retryable back-pressure, not a task fault
            return TaskStatus(tid, self.metadata.executor_id, "failed",
                              failure=FailedReason(RESOURCE_EXHAUSTED, str(e))), None
        except (OSError, IOError_, IntegrityError) as e:
            # IntegrityError: a spill run's read-back CRC mismatch; the
            # retry recomputes from the task's inputs
            return TaskStatus(tid, self.metadata.executor_id, "failed",
                              failure=FailedReason(IO_ERROR, str(e))), None
        except Exception as e:  # noqa: BLE001 — anything else is fatal to the job
            log.debug("task %s failed:\n%s", tid, traceback.format_exc())
            return TaskStatus(tid, self.metadata.executor_id, "failed",
                              failure=FailedReason(EXECUTION_ERROR,
                                                   f"{type(e).__name__}: {e}")), None

    def submit_task(self, task: TaskDescription,
                    on_done: Callable[[TaskStatus], None]) -> None:
        def run():
            on_done(self.run_task(task))

        self.pool.submit(run)

    # --- cancellation ----------------------------------------------------
    def _is_cancelled(self, tid) -> bool:
        return (tid.job_id in self._cancelled_jobs
                or (tid.job_id, tid.stage_id, tid.partition,
                    tid.task_attempt) in self._cancelled_tasks)

    def cancel_job_tasks(self, job_id: str) -> None:
        with self._lock:
            self._cancelled_jobs[job_id] = None
            while len(self._cancelled_jobs) > self._max_cancelled:
                self._cancelled_jobs.popitem(last=False)

    def cancel_task(self, task_id) -> None:
        """Cancel one attempt: it unwinds as 'killed' and its outputs are
        discarded."""
        with self._lock:
            self._cancelled_tasks[(task_id.job_id, task_id.stage_id, task_id.partition,
                                   task_id.task_attempt)] = None
            while len(self._cancelled_tasks) > self._max_cancelled:
                self._cancelled_tasks.popitem(last=False)

    def active_tasks(self) -> int:
        with self._lock:
            return len(self._inflight)

    def running_task_ids(self) -> List[tuple]:
        """(job, stage, partition, attempt) of the in-flight tasks: the
        heartbeat's running set (empty for an idle executor)."""
        with self._lock:
            return sorted(self._inflight)

    def active_job_ids(self) -> Set[str]:
        """Jobs with a task in flight here (the janitor keeps their data)."""
        with self._lock:
            return {key[0] for key in self._inflight}

    def shutdown(self) -> None:
        self.pool.shutdown(wait=True)
