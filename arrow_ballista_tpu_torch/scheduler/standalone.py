"""Standalone mode: the scheduler and its executors in one process.

Mirrors arrow_ballista_tpu/scheduler/standalone.py: the whole stage-DAG
machinery (stage split, AQE, whole-stage fusion, task slots, Arrow IPC
shuffle files, lineage recovery) runs in-process, with the executors
called directly instead of over RPC.  Every executor runs its tasks on
the cluster's device.  The session's config arms the fault plan
(``ballista.faults.plan``), the job profiles (``ballista.observability.*``)
and the scheduler's live plane (``ballista.stats.*``, ``ballista.live.*``,
``ballista.slo.*``), and each job carries a fresh trace context.  The
serving path (plan, result and subplan
caches) is still to be ported (ROADMAP.md queue 1).
"""
from __future__ import annotations

import shutil
import tempfile
import threading
import uuid
from typing import Dict, List, Optional

import torch

from ..executor.executor import Executor, remove_job_data
from ..models.batch import ColumnBatch
from ..models.ipc import read_ipc_files
from ..ops.operators import clear_job_build_caches
from ..ops.physical import TaskContext
from ..utils.config import BallistaConfig
from ..utils.errors import ExecutionError
from .scheduler import SchedulerConfig, SchedulerServer, TaskLauncher, random_job_id
from .types import ExecutorHeartbeat, ExecutorMetadata, TaskDescription


class InProcessTaskLauncher(TaskLauncher):
    """Launch seam wired directly to in-process Executor objects."""

    def __init__(self):
        self.executors: Dict[str, Executor] = {}
        self.scheduler: Optional[SchedulerServer] = None

    def launch_tasks(self, executor_id: str, tasks: List[TaskDescription]) -> None:
        executor = self.executors[executor_id]
        for task in tasks:
            executor.submit_task(
                task, lambda st: self.scheduler.update_task_status(executor_id, [st]))

    def cancel_tasks(self, executor_id: str, job_id: str) -> None:
        self.executors[executor_id].cancel_job_tasks(job_id)

    def cancel_task(self, executor_id: str, task) -> None:
        ex = self.executors.get(executor_id)
        if ex is not None:
            ex.cancel_task(task)

    def clean_job_data(self, executor_id: str, job_id: str) -> None:
        remove_job_data(self.executors[executor_id].work_dir, job_id)

    def stop(self) -> None:
        for ex in self.executors.values():
            ex.shutdown()


class StandaloneCluster:
    """In-process scheduler + N executors sharing a work_dir tree."""

    def __init__(self, config: Optional[BallistaConfig] = None,
                 concurrent_tasks: int = 4, num_executors: int = 1,
                 work_dir: Optional[str] = None,
                 scheduler_config: Optional[SchedulerConfig] = None, device=None):
        self.config = config or BallistaConfig()
        self.device = torch.device("cuda" if device is None else device)
        # arm the failpoints (a no-op unless a plan is configured)
        from .. import faults
        from ..obs.profile import JobObservability

        faults.configure(self.config)
        self.work_dir = work_dir or tempfile.mkdtemp(prefix="ballista-torch-")
        self._owns_work_dir = work_dir is None
        self.launcher = InProcessTaskLauncher()
        if scheduler_config is None:
            scheduler_config = SchedulerConfig.from_config(self.config)
        self.scheduler = SchedulerServer(self.launcher, scheduler_config,
                                         observability=JobObservability.from_config(self.config))
        self.launcher.scheduler = self.scheduler
        self.scheduler.init()
        self.last_job_id: Optional[str] = None
        self.executors: List[Executor] = []
        for i in range(num_executors):
            meta = ExecutorMetadata(executor_id=f"executor-{i}", task_slots=concurrent_tasks)
            ex = Executor(meta, self.work_dir, self.config, concurrent_tasks=concurrent_tasks,
                          device=self.device)
            self.executors.append(ex)
            self.launcher.executors[meta.executor_id] = ex
            self.scheduler.register_executor(meta)
        self._hb_stop = threading.Event()
        self._hb_thread = threading.Thread(target=self._heartbeat_loop,
                                           name="standalone-heartbeat", daemon=True)
        self._hb_thread.start()

    def _heartbeat_loop(self) -> None:
        while not self._hb_stop.wait(10.0):
            for ex in self.executors:
                self.scheduler.heartbeat(ExecutorHeartbeat(ex.metadata.executor_id))

    # --- query execution -------------------------------------------------
    def execute(self, planned) -> List[ColumnBatch]:
        """Run a PlannedQuery through the stage machinery and read the
        final stage's output files."""
        from ..client.context import extract_scalar

        # scalar subqueries first, in this process (single-row reductions)
        scalar_ctx = TaskContext(device=self.device, config=self.config,
                                 work_dir=self.work_dir, job_id=f"scalars-{uuid.uuid4().hex[:7]}")
        scalars: Dict[str, object] = {}
        try:
            for sid, splan in planned.scalars:
                scalar_ctx.scalars = scalars
                scalars[sid] = extract_scalar(splan, scalar_ctx)
        finally:
            clear_job_build_caches(scalar_ctx.job_id)

        from ..obs.tracing import new_trace_context

        job_id = random_job_id()
        # remembered so explain_analyze / forensics / watch find the job
        self.last_job_id = job_id
        self.scheduler.submit_job(job_id, lambda: (planned.plan, scalars), config=self.config,
                                  trace=new_trace_context())
        status = self.scheduler.wait_for_job(job_id, timeout=float(self.config.job_timeout_s))
        if status.state == "failed":
            raise ExecutionError(f"job {job_id} failed: {status.error}")
        if status.state != "successful":
            raise ExecutionError(f"job {job_id} ended as {status.state}")
        schema = planned.plan.schema
        batches: List[ColumnBatch] = []
        for part in sorted(status.locations):
            paths = [loc.path for loc in status.locations[part] if loc.num_rows]
            batches.extend(read_ipc_files(paths, schema, capacity=self.config.batch_size,
                                          device=self.device))
        return batches

    def shutdown(self) -> None:
        self._hb_stop.set()
        self._hb_thread.join(timeout=5.0)
        self.scheduler.shutdown()
        if self._owns_work_dir:
            shutil.rmtree(self.work_dir, ignore_errors=True)
