"""ExecutionEngine: the seam through which the executor runs a stage.

Mirrors arrow_ballista_tpu/executor/execution_engine.py:
``create_query_stage_exec`` wraps the scheduler-sent stage plan (a
``ShuffleWriterExec``); ``execute_query_stage`` runs one partition of it
and returns the shuffle-write metadata.
"""
from __future__ import annotations

from typing import Dict, List

from ..ops.physical import TaskContext
from ..ops.shuffle import ShuffleWritePartition, ShuffleWriterExec


class QueryStageExecutor:
    def execute_query_stage(self, partition: int, ctx: TaskContext
                            ) -> List[ShuffleWritePartition]:
        raise NotImplementedError

    def collect_plan_metrics(self) -> Dict[str, Dict[str, float]]:
        return {}


class DefaultQueryStageExecutor(QueryStageExecutor):
    def __init__(self, plan: ShuffleWriterExec):
        self.plan = plan

    def execute_query_stage(self, partition: int, ctx: TaskContext
                            ) -> List[ShuffleWritePartition]:
        return self.plan.execute_write(partition, ctx)

    def collect_plan_metrics(self) -> Dict[str, Dict[str, float]]:
        """Per-operator metrics keyed by tree path ('0.1:HashAggregateExec')."""
        out: Dict[str, Dict[str, float]] = {}

        def walk(p, path="0"):
            out[f"{path}:{type(p).__name__}"] = p.metrics().to_dict()
            for i, c in enumerate(p.children()):
                walk(c, f"{path}.{i}")

        walk(self.plan)
        return out


class ExecutionEngine:
    def create_query_stage_exec(self, job_id: str, stage_id: int,
                                plan: ShuffleWriterExec, work_dir: str
                                ) -> QueryStageExecutor:
        raise NotImplementedError


class DefaultExecutionEngine(ExecutionEngine):
    """Stage plans arrive as ShuffleWriterExec trees and run as they are."""

    def create_query_stage_exec(self, job_id, stage_id, plan, work_dir):
        if not isinstance(plan, ShuffleWriterExec):
            raise TypeError(f"stage plan must be a ShuffleWriterExec, "
                            f"got {type(plan).__name__}")
        return DefaultQueryStageExecutor(plan)
