"""Control-plane message types of the standalone and remote engines.

Mirrors arrow_ballista_tpu/scheduler/types.py (the reference's protobuf
contract as plain dataclasses): task identity and status with the failure
taxonomy, executor metadata and heartbeats, task definitions and job
status.  A task status carries the task's tracing spans, its device
observatory fold and its flight-recorder events (obs/).  The remote
engine encodes exactly these shapes (serde.py), field for field as the
reference does; the fleet's job leases come with ROADMAP.md queue 1 item
12 C, and the speculative flag stays False until speculation is ported.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

from ..ops.shuffle import PartitionLocation, ShuffleWritePartition

# failure taxonomy
EXECUTION_ERROR = "ExecutionError"      # fatal: fails the job
FETCH_PARTITION_ERROR = "FetchPartitionError"  # re-run the producer stage
IO_ERROR = "IOError"                    # retryable
EXECUTOR_LOST = "ExecutorLost"          # retryable
RESULT_LOST = "ResultLost"              # retryable, outputs discarded
TASK_KILLED = "TaskKilled"              # cancellation
RESOURCE_EXHAUSTED = "ResourceExhausted"  # retryable back-pressure


@dataclasses.dataclass
class TaskId:
    job_id: str
    stage_id: int
    partition: int
    # a fresh attempt id per launch of (stage_attempt, partition)
    task_attempt: int = 0
    stage_attempt: int = 0
    # a speculative duplicate of a straggling attempt (always False until
    # speculation is ported; carried for the wire shape)
    speculative: bool = False


@dataclasses.dataclass
class TaskDescription:
    """A runnable task handed to an executor."""

    task: TaskId
    plan: "object"  # the stage's ShuffleWriterExec root
    task_internal_id: int = 0
    # job-level scalar-subquery values, shipped with every task
    scalars: Dict[str, object] = dataclasses.field(default_factory=dict)
    # tracing propagation context (obs/tracing.py): the job execution
    # span's {trace_id, span_id}, the parent of the task's span tree
    trace: Dict[str, str] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class FailedReason:
    kind: str  # one of the taxonomy constants
    message: str = ""
    # FetchPartitionError details
    map_stage_id: int = -1
    map_partition_id: int = -1
    executor_id: str = ""

    @property
    def count_to_failures(self) -> bool:
        return self.kind in (IO_ERROR, RESOURCE_EXHAUSTED)


@dataclasses.dataclass
class TaskStatus:
    """Executor -> scheduler task outcome."""

    task: TaskId
    executor_id: str
    state: str  # 'success' | 'failed' | 'killed'
    shuffle_writes: List[ShuffleWritePartition] = dataclasses.field(default_factory=list)
    failure: Optional[FailedReason] = None
    launch_time_ms: int = 0
    start_time_ms: int = 0
    end_time_ms: int = 0
    # per-operator metrics of the stage plan at the task's end (cumulative:
    # the tasks of a stage share its operator instances)
    metrics: Dict[str, Dict[str, float]] = dataclasses.field(default_factory=dict)
    # the executing process and plan instance: the stage's metric fold
    # takes the last cumulative snapshot per instance (execution_graph.py)
    process_id: str = ""
    # the task's span tree (obs.tracing.Span list; empty with tracing off)
    spans: List[object] = dataclasses.field(default_factory=list)
    # the task's own device-observatory fold (obs/device.py; empty when
    # the observatory is off)
    device_stats: Dict[str, float] = dataclasses.field(default_factory=dict)
    # flight-recorder events emitted during the task (obs/journal.py;
    # empty when the journal is off)
    journal: List[Dict] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class ExecutorMetadata:
    executor_id: str
    host: str = "localhost"
    port: int = 0
    grpc_port: int = 0
    task_slots: int = 1


@dataclasses.dataclass
class ExecutorHeartbeat:
    executor_id: str
    timestamp: float = dataclasses.field(default_factory=time.time)
    status: str = "active"  # 'active' | 'dead' | 'terminating'
    # carried so a restarted scheduler re-registers an unknown heartbeater
    metadata: Optional[ExecutorMetadata] = None
    # memory governor pressure in [0, 1]; 0.0 is omitted on the wire
    memory_pressure: float = 0.0
    # in-flight (job_id, stage_id, partition, task_attempt) tuples; empty
    # is omitted on the wire
    running: List[tuple] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class ExecutorReservation:
    """A reserved task slot."""

    executor_id: str
    job_id: Optional[str] = None


@dataclasses.dataclass
class JobStatus:
    job_id: str
    state: str  # 'queued' | 'running' | 'successful' | 'failed' | 'cancelled'
    error: str = ""
    # successful: per output-partition locations of the final stage
    locations: Dict[int, List[PartitionLocation]] = dataclasses.field(default_factory=dict)
    # failed and retriable: transient back-pressure (the admission queue,
    # ROADMAP.md queue 1 item 12 D); clients may resubmit
    retriable: bool = False
