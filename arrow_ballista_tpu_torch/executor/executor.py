"""Executor: runs query-stage tasks on a pool of task slots and reports
their status.

Mirrors arrow_ballista_tpu/executor/executor.py: a ThreadPoolExecutor of
``concurrent_tasks`` slots, cooperative job and task cancellation, and the
mapping of a task's outcome onto the failure taxonomy.  Every task of an
executor runs on its device's current stream.  Its memory governor is
shared by its task slots; the fault-injection points are still to be
ported (ROADMAP.md queue 1 item 12).
"""
from __future__ import annotations

import logging
import os
import shutil
import threading
import time
import traceback
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional

import torch

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
from ..utils.errors import (CancelledError, FetchFailedError, IOError_, MemoryExhausted,
                            ResourceExhausted)
from .execution_engine import DefaultExecutionEngine, ExecutionEngine

log = logging.getLogger(__name__)


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

    # --- task execution --------------------------------------------------
    def run_task(self, task: TaskDescription) -> TaskStatus:
        """Execute one task synchronously (``submit_task`` runs it on the
        pool)."""
        tid = task.task
        launch_ms = int(time.time() * 1000)
        try:
            if self._is_cancelled(tid):
                return TaskStatus(tid, self.metadata.executor_id, "killed")
            stage_exec = self.engine.create_query_stage_exec(
                tid.job_id, tid.stage_id, task.plan, self.work_dir)
            ctx = TaskContext(device=self.device, config=self.config,
                              scalars=dict(task.scalars), work_dir=self.work_dir,
                              job_id=tid.job_id, stage_id=tid.stage_id,
                              executor_id=self.metadata.executor_id,
                              cancelled=lambda: self._is_cancelled(tid),
                              governor=self.governor)
            # the stage's generated programs, traced and built before its
            # first batch (a no-op on the CPU and once built)
            programs.prepare(task.plan, ctx)
            start_ms = int(time.time() * 1000)
            writes = stage_exec.execute_query_stage(tid.partition, ctx)
            end_ms = int(time.time() * 1000)
            if self._is_cancelled(tid):
                return TaskStatus(tid, self.metadata.executor_id, "killed")
            return TaskStatus(tid, self.metadata.executor_id, "success",
                              shuffle_writes=writes, launch_time_ms=launch_ms,
                              start_time_ms=start_ms, end_time_ms=end_ms,
                              metrics=stage_exec.collect_plan_metrics())
        except CancelledError:
            return TaskStatus(tid, self.metadata.executor_id, "killed")
        except FetchFailedError as e:
            return TaskStatus(tid, self.metadata.executor_id, "failed",
                              failure=FailedReason(FETCH_PARTITION_ERROR, str(e),
                                                   map_stage_id=e.map_stage_id,
                                                   map_partition_id=e.map_partition_id,
                                                   executor_id=e.executor_id))
        except (MemoryExhausted, ResourceExhausted) as e:
            # a denial the operator could not degrade to spill (spill
            # disabled): retryable back-pressure, not a task fault
            return TaskStatus(tid, self.metadata.executor_id, "failed",
                              failure=FailedReason(RESOURCE_EXHAUSTED, str(e)))
        except (OSError, IOError_) as e:
            return TaskStatus(tid, self.metadata.executor_id, "failed",
                              failure=FailedReason(IO_ERROR, str(e)))
        except Exception as e:  # noqa: BLE001 — anything else is fatal to the job
            log.debug("task %s failed:\n%s", tid, traceback.format_exc())
            return TaskStatus(tid, self.metadata.executor_id, "failed",
                              failure=FailedReason(EXECUTION_ERROR,
                                                   f"{type(e).__name__}: {e}"))

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

    def shutdown(self) -> None:
        self.pool.shutdown(wait=True)
