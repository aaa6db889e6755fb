"""ExecutionGraph: a job's DAG of shuffle stages and its fault tolerance.

Mirrors arrow_ballista_tpu/scheduler/execution_graph.py.  Stages move
through

    UNRESOLVED -> RUNNING -> SUCCESSFUL
         ^            |
         └─ rollback ─┘        (FetchPartitionError / executor lost)

A stage resolves (its ``UnresolvedShuffleExec`` leaves become readers of
its producers' outputs) when every producer is SUCCESSFUL; the AQE rewrites
(scheduler/aqe.py) and whole-stage fusion (compile/fuse.py) apply to the
freshly resolved plan, before any of its tasks launches.  A fetch failure
rolls the consumer back and re-opens the producer's lost map partition;
retryable task errors reset the task; execution errors fail the job.
Every completed task refolds its stage's summary into the graph's runtime
statistics store (``graph.stats``, obs/stats.py: EXPLAIN ANALYZE, the
doctor, progress), and stage resolution and task launches are journaled
(obs/journal.py).  Speculative attempts are still to be ported (ROADMAP.md
queue 1); the speculation fields the observability folds read stay empty.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

from ..obs import journal
from ..obs.stats import RuntimeStatsStore
from ..ops.shuffle import (
    PartitionLocation,
    ShuffleReaderExec,
    ShuffleWritePartition,
    ShuffleWriterExec,
    UnresolvedShuffleExec,
)
from ..utils.errors import InternalError
from .aqe import AqePolicy, maybe_broadcast_switch, rewrite_resolved_stage
from .planner import DistributedPlanner, QueryStage, collect_nodes, remove_unresolved_shuffles
from .types import (
    EXECUTION_ERROR,
    FETCH_PARTITION_ERROR,
    TASK_KILLED,
    FailedReason,
    TaskDescription,
    TaskId,
    TaskStatus,
)

TASK_MAX_FAILURES = 4
STAGE_MAX_FAILURES = 4

UNRESOLVED = "unresolved"
RUNNING = "running"
SUCCESSFUL = "successful"
FAILED = "failed"


@dataclasses.dataclass
class TaskInfo:
    partition: int
    executor_id: str
    state: str  # 'running' | 'success'
    # last TaskStatus (per-operator metrics, launch/end times)
    status: object = None
    # attempt id this info belongs to (TaskId.task_attempt)
    attempt: int = 0
    speculative: bool = False
    # monotonic launch time: a running task's age (the live straggler rule)
    started_at: float = 0.0


class ExecutionStage:
    def __init__(self, stage_id: int, plan: ShuffleWriterExec):
        self.stage_id = stage_id
        self.plan = plan  # with UnresolvedShuffleExec leaves
        self.partitions = plan.output_partition_count()
        self.producer_ids = sorted(
            {u.stage_id for u in collect_nodes(plan, UnresolvedShuffleExec)})
        self.output_links: List[int] = []
        self.state = UNRESOLVED
        # stage_attempt: a monotonic epoch that drops late statuses of
        # rolled-back attempts; failures: the budget against
        # STAGE_MAX_FAILURES (executor loss bumps the epoch, not the budget)
        self.stage_attempt = 0
        self.failures = 0
        self.resolved_plan: Optional[ShuffleWriterExec] = None
        self.task_infos: List[Optional[TaskInfo]] = [None] * self.partitions
        self.task_failures: List[int] = [0] * self.partitions
        # next attempt id per partition (keeps the planned length across
        # adaptive coalescing)
        self.task_attempts: List[int] = [0] * self.partitions
        # partition -> executors where it failed retryably (this attempt):
        # the retry is steered to another executor when one is alive
        self.failed_on: Dict[int, set] = {}
        # speculative duplicates: none until speculation is ported (the
        # progress and profile folds read it)
        self.speculative_tasks: Dict[int, TaskInfo] = {}
        # completed-attempt durations (s): task-duration quantiles
        self.durations: List[float] = []
        # append-only per-attempt history (entries carry their
        # stage_attempt epoch)
        self.attempt_log: List[dict] = []
        # map partition -> (executor_id, [ShuffleWritePartition])
        self.outputs: Dict[int, Tuple[str, List[ShuffleWritePartition]]] = {}
        # AQE rewrite records applied to this stage (append-only, tagged
        # with their stage_attempt)
        self.aqe_rewrites: List[dict] = []
        # whole-stage-fusion decisions (compile/fuse.py): one record per
        # detected chain, fused or rejected, with reasons
        self.fusion_rewrites: List[dict] = []

    def new_attempt(self, partition: int, executor_id: str) -> TaskInfo:
        attempt = self.task_attempts[partition]
        self.task_attempts[partition] = attempt + 1
        self.attempt_log.append({"partition": partition, "attempt": attempt,
                                 "stage_attempt": self.stage_attempt,
                                 "executor_id": executor_id, "speculative": False})
        return TaskInfo(partition, executor_id, "running", attempt=attempt,
                        started_at=time.monotonic())

    # --- metrics ---------------------------------------------------------
    def operator_metrics(self) -> Dict[str, Dict[str, float]]:
        """Completed tasks' per-operator metrics folded per operator, keyed
        by the ``collect_plan_metrics`` path key (``'0.1:HashAggregateExec'``).

        A stage's tasks in one executor share its operator instances, so a
        task's status holds the counters' cumulative snapshot at its end:
        the stage total is the LAST snapshot per plan instance (the largest
        value of each counter, the counters being monotone), summed across
        instances (executors).  Only the recorded winner's own status
        counts: a status carrying another task attempt adds nothing."""
        per_exec: Dict[str, Dict[Tuple[str, str], float]] = {}
        for t in self.task_infos:
            st = getattr(t, "status", None)
            if st is None:
                continue
            st_att = getattr(getattr(st, "task", None), "task_attempt", None)
            if st_att is not None and st_att != getattr(t, "attempt", st_att):
                continue
            dst = per_exec.setdefault(
                getattr(st, "process_id", "") or getattr(t, "executor_id", ""), {})
            for op, mm in (st.metrics or {}).items():
                for k, v in mm.items():
                    if v > dst.get((op, k), float("-inf")):
                        dst[(op, k)] = v
        agg: Dict[str, Dict[str, float]] = {}
        for mm in per_exec.values():
            for (op, k), v in mm.items():
                d = agg.setdefault(op, {})
                d[k] = d.get(k, 0.0) + v
        return agg

    def aggregate_metrics(self) -> Dict[str, float]:
        """``operator_metrics`` flattened to '<op>.<metric>' -> total."""
        return {f"{op}.{k}": v
                for op, mm in self.operator_metrics().items()
                for k, v in mm.items()}

    # --- queries ---------------------------------------------------------
    @property
    def planned_partitions(self) -> int:
        """The partition count the planner asked for, before coalescing."""
        return getattr(self, "_orig_partitions", None) or self.partitions

    def pending_partitions(self) -> List[int]:
        if self.state != RUNNING:
            return []
        return [p for p in range(self.partitions) if self.task_infos[p] is None]

    def all_successful(self) -> bool:
        return all(t is not None and t.state == "success" for t in self.task_infos)

    def output_locations(self, addr_resolver=None) -> Dict[int, List[PartitionLocation]]:
        """output partition -> locations across all map tasks;
        ``addr_resolver(executor_id) -> (host, port, grpc_port)`` stamps
        the data-plane address (None in-process)."""
        locs: Dict[int, List[PartitionLocation]] = {}
        for map_part, (executor_id, writes) in sorted(self.outputs.items()):
            host, port, grpc_port = ("", 0, 0)
            if addr_resolver is not None:
                host, port, grpc_port = addr_resolver(executor_id)
            for w in writes:
                locs.setdefault(w.output_partition, []).append(
                    PartitionLocation(executor_id, map_part, w.output_partition, w.path,
                                      w.num_rows, w.num_bytes, host, port,
                                      checksum=w.checksum, grpc_port=grpc_port,
                                      format="arrow_file"))
        return locs

    # --- static coalescing (with AQE off) --------------------------------
    # when the producers' real output is tiny, the planned N reduce tasks
    # are pure overhead: the stage collapses to one task reading every bucket
    COALESCE_INPUT_ROWS = 8192

    def maybe_coalesce(self) -> None:
        if self.partitions <= 1 or self.resolved_plan is None:
            return
        leaves = []

        def walk(p):
            kids = p.children()
            if not kids:
                leaves.append(p)
            for c in kids:
                walk(c)

        walk(self.resolved_plan)
        readers = [p for p in leaves if isinstance(p, ShuffleReaderExec)]
        if len(readers) != len(leaves):
            return  # a scan leaf owns the partition count
        total = sum(loc.num_rows for r in readers
                    for locs in r.locations.values() for loc in locs)
        if total > self.COALESCE_INPUT_ROWS:
            return
        for r in readers:
            merged = [loc for q in sorted(r.locations) for loc in r.locations[q]]
            r.locations = {0: merged}
            r._orig_partition_count = r.partition_count
            r.partition_count = 1
        self._orig_partitions = self.partitions
        self.partitions = 1
        self.task_infos = [None]

    # --- transitions -----------------------------------------------------
    def rollback(self, count_failure: bool = True) -> None:
        """RUNNING -> UNRESOLVED: outputs discarded, tasks forgotten, the
        resolved readers turned back into placeholders (resolution works in
        place)."""
        from .planner import rollback_resolved_shuffles

        self.plan = rollback_resolved_shuffles(self.plan)
        self.state = UNRESOLVED
        self.resolved_plan = None
        if getattr(self, "_orig_partitions", None):
            self.partitions = self._orig_partitions
            self._orig_partitions = None
        self.task_infos = [None] * self.partitions
        self.failed_on.clear()
        self.outputs.clear()
        self.stage_attempt += 1
        if count_failure:
            self.failures += 1

    def reopen_partitions(self, partitions: List[int], count_attempt: bool = True) -> None:
        """SUCCESSFUL/RUNNING -> RUNNING with the given map partitions
        pending again."""
        reopened = False
        for p in partitions:
            info = self.task_infos[p]
            if p not in self.outputs and (info is None or info.state != "success"):
                continue  # already re-opened; a re-run may be in flight
            self.outputs.pop(p, None)
            self.task_infos[p] = None
            reopened = True
        if reopened and self.state == SUCCESSFUL:
            self.state = RUNNING
            self.stage_attempt += 1
            if count_attempt:
                self.failures += 1

    def __repr__(self):
        done = sum(1 for t in self.task_infos if t and t.state == "success")
        return (f"Stage(id={self.stage_id}, {self.state}, "
                f"{done}/{self.partitions} tasks, attempt={self.stage_attempt})")


class ExecutionGraph:
    def __init__(self, job_id: str, stages: List[QueryStage]):
        self.job_id = job_id
        self.stages: Dict[int, ExecutionStage] = {
            s.stage_id: ExecutionStage(s.stage_id, s.plan) for s in stages}
        for stage in self.stages.values():
            for pid in stage.producer_ids:
                if pid not in self.stages:
                    raise InternalError(f"stage {stage.stage_id} references "
                                        f"unknown producer {pid}")
                self.stages[pid].output_links.append(stage.stage_id)
        finals = [s for s in self.stages.values() if not s.output_links]
        if len(finals) != 1:
            raise InternalError(f"expected exactly one final stage, got {finals}")
        self.final_stage_id = finals[0].stage_id
        self.status = "running"
        self.error = ""
        self.scalars: Dict[str, object] = {}
        # executor_id -> (host, port, grpc_port) of its data plane; None =
        # in-process
        self.addr_resolver = None
        # adaptive query execution: the scheduler installs the job's policy
        # right after build; the flat rewrite log and pending metric events
        self.aqe = AqePolicy()
        self.aqe_log: List[dict] = []
        self.aqe_events: List[Tuple[str, int]] = []
        # whole-stage fusion: the job's CompilePolicy, installed by the
        # scheduler after build (None = off, so the leaf stages resolved by
        # the revive() below stay interpreted until the scheduler decides),
        # and the flat decision log
        self.compiler = None
        self.compile_log: List[dict] = []
        # runtime statistics (obs/stats.py), refolded per completed task
        self.stats = RuntimeStatsStore(job_id)
        # tracing propagation context of the job's execution span
        # (obs/profile.py), handed to every task
        self.trace: Dict[str, str] = {}
        self.revive()

    @staticmethod
    def build(job_id: str, plan) -> "ExecutionGraph":
        stages = DistributedPlanner().plan_query_stages(job_id, plan)
        return ExecutionGraph(job_id, stages)

    # --- scheduling ------------------------------------------------------
    def revive(self) -> bool:
        """Resolve every UNRESOLVED stage whose producers all succeeded."""
        changed = False
        for stage in self.stages.values():
            if stage.state != UNRESOLVED:
                continue
            if all(self.stages[p].state == SUCCESSFUL for p in stage.producer_ids):
                locations = {p: self.stages[p].output_locations(self.addr_resolver)
                             for p in stage.producer_ids}
                stage.resolved_plan = (remove_unresolved_shuffles(stage.plan, locations)
                                       if stage.producer_ids else stage.plan)
                if stage.producer_ids:
                    if self.aqe.enabled:
                        rewrite_resolved_stage(self, stage, self.aqe)
                    else:
                        stage.maybe_coalesce()
                stage.state = RUNNING
                changed = True
                if self.compiler is not None and self.compiler.enabled:
                    # fusion rides the resolve, after AQE and before any
                    # task launches: a rollback re-resolves and re-fuses
                    from ..compile.fuse import fuse_stage

                    fuse_stage(self, stage)
                if journal.enabled():
                    journal.emit("stage.resolved", job_id=self.job_id,
                                 stage_id=stage.stage_id, partitions=stage.partitions,
                                 producers=list(stage.producer_ids))
        return changed

    def available_task_count(self) -> int:
        if self.status != "running":
            return 0
        return sum(len(s.pending_partitions()) for s in self.stages.values())

    def pop_next_task(self, executor_id: str,
                      alive: Optional[set] = None) -> Optional[TaskDescription]:
        """Hand out one pending task.  ``alive`` (the alive executors)
        enables retry anti-affinity: a partition that failed retryably on
        ``executor_id`` is skipped while another alive executor could take
        it."""
        if self.status != "running":
            return None
        for stage in sorted(self.stages.values(), key=lambda s: s.stage_id):
            for p in stage.pending_partitions():
                failed_on = stage.failed_on.get(p)
                if (failed_on and executor_id in failed_on
                        and alive is not None and (alive - failed_on)):
                    continue
                info = stage.new_attempt(p, executor_id)
                stage.task_infos[p] = info
                tid = TaskId(self.job_id, stage.stage_id, info.partition,
                             task_attempt=info.attempt, stage_attempt=stage.stage_attempt)
                if journal.enabled():
                    # registers the causal key the scheduler's task.finish
                    # event chains back to
                    journal.emit("task.launch", job_id=self.job_id,
                                 causal_key=("task", self.job_id, stage.stage_id,
                                             info.partition, info.attempt),
                                 stage_id=stage.stage_id, partition=info.partition,
                                 attempt=info.attempt, executor_id=info.executor_id,
                                 speculative=False)
                return TaskDescription(tid, stage.resolved_plan, scalars=self.scalars,
                                       trace=dict(self.trace))
        return None

    # --- status intake ---------------------------------------------------
    def update_task_status(self, statuses: List[TaskStatus]) -> List[Tuple[str, object]]:
        """Absorb executor task outcomes; returns job-level events:
        ('job_successful', locations) | ('job_failed', message)."""
        events: List[Tuple[str, object]] = []
        if self.status != "running":
            return events
        for st in statuses:
            stage = self.stages.get(st.task.stage_id)
            if stage is None or st.task.stage_attempt != stage.stage_attempt:
                continue  # a late message from a rolled-back attempt
            if st.state == "success":
                self._on_task_success(stage, st, events)
            elif st.state == "failed":
                self._on_task_failed(stage, st, events)
            if self.status != "running":
                break
        return events

    def _on_task_success(self, stage: ExecutionStage, st: TaskStatus,
                         events: List[Tuple[str, object]]) -> None:
        p = st.task.partition
        info = stage.task_infos[p]
        if info is not None and info.state == "success":
            return  # a duplicate report: the recorded outputs stay
        started = info.started_at if info is not None else 0.0
        if started:
            stage.durations.append(time.monotonic() - started)
        stage.task_infos[p] = TaskInfo(p, st.executor_id, "success", st,
                                       attempt=st.task.task_attempt, started_at=started)
        stage.outputs[p] = (st.executor_id, list(st.shuffle_writes))
        completed = stage.all_successful() and stage.state == RUNNING
        if completed:
            stage.state = SUCCESSFUL
        # refold after the state transition (the final summary records the
        # stage as successful) and before downstream stages resolve
        self.stats.fold_stage(stage)
        if completed:
            if stage.stage_id == self.final_stage_id:
                self.status = "successful"
                events.append(("job_successful", stage.output_locations(self.addr_resolver)))
            else:
                # the broadcast switch first: a flipped join changes what
                # revive() resolves
                maybe_broadcast_switch(self, stage, events, self.aqe)
                self.revive()

    def _on_task_failed(self, stage: ExecutionStage, st: TaskStatus,
                        events: List[Tuple[str, object]]) -> None:
        p = st.task.partition
        info = stage.task_infos[p]
        reason = st.failure or FailedReason(EXECUTION_ERROR, "unknown failure")
        if info is not None and info.state == "success":
            return
        if reason.kind == EXECUTION_ERROR:
            self._fail_job(f"task {st.task.job_id}/{stage.stage_id}/{p}: {reason.message}",
                           events)
            return
        if reason.kind == TASK_KILLED:
            return
        if reason.kind == FETCH_PARTITION_ERROR:
            self._on_fetch_failure(stage, reason, events)
            return
        # retryable (IOError / ExecutorLost / ResultLost / ResourceExhausted)
        if reason.count_to_failures:
            stage.task_failures[p] += 1
        if stage.task_failures[p] >= TASK_MAX_FAILURES:
            self._fail_job(f"task {st.task.job_id}/{stage.stage_id}/{p} failed "
                           f"{TASK_MAX_FAILURES} times: {reason.message}", events)
            return
        eid = st.executor_id or (info.executor_id if info is not None else "")
        if eid:
            stage.failed_on.setdefault(p, set()).add(eid)
        stage.task_infos[p] = None  # back to pending

    def _on_fetch_failure(self, stage: ExecutionStage, reason: FailedReason,
                          events: List[Tuple[str, object]]) -> None:
        """Shuffle-lineage retry: roll the reducer back, re-run the
        producer's lost map partition."""
        producer = self.stages.get(reason.map_stage_id)
        if producer is None:
            self._fail_job(f"fetch failure names unknown stage {reason.map_stage_id}", events)
            return
        stage.rollback()
        if stage.failures >= STAGE_MAX_FAILURES:
            self._fail_job(f"stage {stage.stage_id} exceeded {STAGE_MAX_FAILURES} attempts "
                           f"after fetch failures (last: {reason.message})", events)
            return
        producer.reopen_partitions([reason.map_partition_id])
        if producer.failures >= STAGE_MAX_FAILURES:
            self._fail_job(f"stage {producer.stage_id} exceeded {STAGE_MAX_FAILURES} "
                           f"re-runs (last fetch failure: {reason.message})", events)
            return
        self.revive()

    # --- executor loss ---------------------------------------------------
    def executor_lost(self, executor_id: str) -> None:
        """Reset tasks and roll back stages whose outputs lived on the lost
        executor (not charged to any budget)."""
        if self.status != "running":
            return
        for stage in self.stages.values():
            if stage.state != RUNNING:
                continue
            for p, info in enumerate(stage.task_infos):
                if info is not None and info.state == "running" \
                        and info.executor_id == executor_id:
                    stage.task_infos[p] = None
        poisoned: List[int] = []
        for stage in self.stages.values():
            lost = [p for p, (ex, _) in stage.outputs.items() if ex == executor_id]
            if lost:
                stage.reopen_partitions(lost, count_attempt=False)
                poisoned.append(stage.stage_id)
        for sid in poisoned:
            for cid in self.stages[sid].output_links:
                consumer = self.stages[cid]
                if consumer.state == RUNNING:
                    consumer.rollback(count_failure=False)
        self.revive()

    # --- job level -------------------------------------------------------
    def _fail_job(self, message: str, events: List[Tuple[str, object]]) -> None:
        self.status = "failed"
        self.error = message
        events.append(("job_failed", message))

    def cancel(self) -> None:
        self.status = "cancelled"

    def running_tasks(self) -> List[Tuple[int, int, str]]:
        """(stage_id, partition, executor_id) of in-flight tasks."""
        out = []
        for stage in self.stages.values():
            if stage.state != RUNNING:
                continue
            for info in stage.task_infos:
                if info is not None and info.state == "running":
                    out.append((stage.stage_id, info.partition, info.executor_id))
        return out

    def __repr__(self):
        lines = [f"ExecutionGraph(job={self.job_id}, status={self.status})"]
        for sid in sorted(self.stages):
            lines.append("  " + repr(self.stages[sid]))
        return "\n".join(lines)
