"""DistributedPlanner: split a physical plan into shuffle stages.

Mirrors arrow_ballista_tpu/scheduler/planner.py: every exchange
(``RepartitionExec``, hash or single) becomes a stage boundary — the
subtree below it becomes a stage rooted at a ``ShuffleWriterExec`` with
that partitioning, and the exchange is replaced by an
``UnresolvedShuffleExec`` leaf.  The root plan becomes the final stage, a
``ShuffleWriterExec`` with no partitioning.  ``remove_unresolved_shuffles``
resolves the placeholders into ``ShuffleReaderExec`` leaves once the
producers complete; ``rollback_resolved_shuffles`` undoes that for a
stage re-run.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

from ..ops.physical import ExecutionPlan
from ..ops.shuffle import (
    PartitionLocation,
    RepartitionExec,
    ShuffleReaderExec,
    ShuffleWriterExec,
    UnresolvedShuffleExec,
)
from ..utils.errors import InternalError


def map_children(plan: ExecutionPlan, fn) -> ExecutionPlan:
    """Rebuild ``plan``'s children via ``fn``, in place (every stage owns
    its subtree: no operator node is shared between stages)."""
    if hasattr(plan, "input") and isinstance(plan.input, ExecutionPlan):
        plan.input = fn(plan.input)
    if hasattr(plan, "left") and isinstance(getattr(plan, "left"), ExecutionPlan):
        plan.left = fn(plan.left)
    if hasattr(plan, "right") and isinstance(getattr(plan, "right"), ExecutionPlan):
        plan.right = fn(plan.right)
    return plan


def collect_nodes(plan: ExecutionPlan, cls) -> List[ExecutionPlan]:
    found = []
    if isinstance(plan, cls):
        found.append(plan)
    for c in plan.children():
        found.extend(collect_nodes(c, cls))
    return found


@dataclasses.dataclass
class QueryStage:
    stage_id: int
    plan: ShuffleWriterExec  # every stage is rooted at a shuffle writer


class DistributedPlanner:
    """Stateless except for the per-job stage-id counter."""

    def __init__(self):
        self._next_stage_id = 1

    def _new_stage_id(self) -> int:
        sid = self._next_stage_id
        self._next_stage_id += 1
        return sid

    def plan_query_stages(self, job_id: str, plan: ExecutionPlan) -> List[QueryStage]:
        stages: List[QueryStage] = []
        root = self._split(plan, stages)
        final = ShuffleWriterExec(root, None, stage_id=self._new_stage_id())
        stages.append(QueryStage(final.stage_id, final))
        return stages

    def _split(self, plan: ExecutionPlan, stages: List[QueryStage]) -> ExecutionPlan:
        plan = map_children(plan, lambda c: self._split(c, stages))
        if isinstance(plan, RepartitionExec):
            sid = self._new_stage_id()
            writer = ShuffleWriterExec(plan.input, plan.partitioning, stage_id=sid)
            stages.append(QueryStage(sid, writer))
            return UnresolvedShuffleExec(sid, writer.schema, plan.partitioning.count)
        return plan


def remove_unresolved_shuffles(
    plan: ExecutionPlan,
    locations: Dict[int, Dict[int, List[PartitionLocation]]],
) -> ExecutionPlan:
    """Replace every UnresolvedShuffleExec with a ShuffleReaderExec;
    ``locations[producer_stage_id][output_partition] -> [PartitionLocation]``."""

    def walk(p: ExecutionPlan) -> ExecutionPlan:
        p = map_children(p, walk)
        if isinstance(p, UnresolvedShuffleExec):
            locs = locations.get(p.stage_id)
            if locs is None:
                raise InternalError(f"no output locations for producer stage {p.stage_id}")
            return ShuffleReaderExec(p.stage_id, p.schema, p.output_partition_count(),
                                     dict(locs))
        return p

    return walk(plan)


def rollback_resolved_shuffles(plan: ExecutionPlan) -> ExecutionPlan:
    """Inverse of remove_unresolved_shuffles, for stage re-runs."""

    def walk(p: ExecutionPlan) -> ExecutionPlan:
        p = map_children(p, walk)
        if isinstance(p, ShuffleReaderExec):
            # adaptive coalescing may have collapsed the reader: the re-run
            # restores the planned partitioning
            count = getattr(p, "_orig_partition_count", None) or p.partition_count
            return UnresolvedShuffleExec(p.stage_id, p.schema, count)
        return p

    return walk(plan)
