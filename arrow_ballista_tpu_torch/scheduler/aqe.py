"""Adaptive query execution: re-optimization at stage boundaries.

Mirrors arrow_ballista_tpu/scheduler/aqe.py.  Before a downstream stage
launches, the scheduler knows the actual per-partition rows and bytes its
producers shuffled, so it re-optimizes the not-yet-launched part of the
graph.  Three rewrites, each gated on the observed numbers and on the
``ballista.aqe.*`` keys (on by default):

1. **Partition coalescing** (resolve time): adjacent small reduce
   partitions merge into one task up to a target row/byte size.
2. **Shuffle-join -> broadcast switch** (stage completion): a join whose
   build side's actual output is under the threshold flips to broadcast,
   and a probe-side exchange that feeds only it and has not completed is
   grafted away.
3. **Skew splitting** (resolve time): a hot partition splits into several
   tasks, each reading a contiguous sub-range of the producer's map
   outputs.

Every rewrite runs on the scheduler's event-loop thread, between
resolution and the first task launch.  The ``scheduler.aqe.before_rewrite``
failpoint (faults/) fires between decision and mutation: an injected error
or ``drop`` abandons the rewrite and leaves the graph untouched — AQE is an
optimization, never a correctness dependency.  The reference's
plan-validator re-check is still to be ported (analysis/plan_checks.py,
ROADMAP.md queue 1).
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Dict, List, Optional, Tuple

from .. import faults
from ..ops.operators import (
    CoalescePartitionsExec,
    FilterExec,
    HashAggregateExec,
    JoinExec,
    ProjectionExec,
    RenameExec,
)
from ..ops.shuffle import ShuffleReaderExec, ShuffleWriterExec, UnresolvedShuffleExec
from .planner import collect_nodes
from .types import TaskId

log = logging.getLogger(__name__)

FAILPOINT = "scheduler.aqe.before_rewrite"


@dataclasses.dataclass
class AqePolicy:
    """Per-job AQE knobs, built from the session config by the scheduler
    (defaults apply otherwise)."""

    enabled: bool = True
    coalesce_enabled: bool = True
    coalesce_target_rows: int = 8192
    coalesce_target_bytes: int = 1 << 20
    broadcast_enabled: bool = True
    broadcast_threshold_rows: int = 4_000_000
    skew_enabled: bool = True
    skew_factor: float = 4.0
    skew_min_rows: int = 1_000_000

    @staticmethod
    def from_config(cfg) -> "AqePolicy":
        if cfg is None:
            return AqePolicy()
        from ..utils import config as C

        return AqePolicy(
            enabled=cfg.get(C.AQE_ENABLED),
            coalesce_enabled=cfg.get(C.AQE_COALESCE_ENABLED),
            coalesce_target_rows=cfg.get(C.AQE_COALESCE_TARGET_ROWS),
            coalesce_target_bytes=cfg.get(C.AQE_COALESCE_TARGET_BYTES),
            broadcast_enabled=cfg.get(C.AQE_BROADCAST_ENABLED),
            broadcast_threshold_rows=cfg.get(C.AQE_BROADCAST_THRESHOLD_ROWS),
            skew_enabled=cfg.get(C.AQE_SKEW_ENABLED),
            skew_factor=cfg.get(C.AQE_SKEW_FACTOR),
            skew_min_rows=cfg.get(C.AQE_SKEW_MIN_ROWS),
        )


# --------------------------------------------------------------------------
# plan-shape analysis
# --------------------------------------------------------------------------

#: operators through which a sub-range of input rows is independently
#: processable per task: row-wise transforms plus the stage's root writer
#: (hash partitioning is row-wise; a final passthrough writer keeps slice
#: order because slices stay contiguous and in map order)
_ROW_WISE = (FilterExec, ProjectionExec, RenameExec, ShuffleWriterExec)


def _aligned_readers(plan) -> Tuple[List[ShuffleReaderExec], bool]:
    """Reader leaves whose partition index IS the stage's task partition
    index.  Descends every child except a broadcast join's build side and
    a CoalescePartitionsExec input — those subtrees are driven by their
    own partition counts, not the task index, and must not be remapped.
    ``ok`` is False when an aligned-position leaf is not a shuffle reader
    (a scan owns the stage's partitioning: nothing to rewrite)."""
    aligned: List[ShuffleReaderExec] = []
    ok = [True]

    def walk(node, al: bool) -> None:
        kids = node.children()
        if not kids:
            if not al:
                return
            if isinstance(node, ShuffleReaderExec):
                aligned.append(node)
            else:
                ok[0] = False
            return
        if isinstance(node, JoinExec) and node.dist == "broadcast":
            walk(node.left, al)
            walk(node.right, False)
            return
        if isinstance(node, CoalescePartitionsExec):
            walk(node.input, False)
            return
        for c in kids:
            walk(c, al)

    walk(plan, True)
    return aligned, ok[0]


def _path_to(node, target, path: List) -> bool:
    """Collect the operators strictly above ``target`` (bottom-up)."""
    if node is target:
        return True
    for c in node.children():
        if _path_to(c, target, path):
            path.append(node)
            return True
    return False


def _split_safe(root, reader) -> bool:
    """True when every operator between the stage root and ``reader`` can
    take a sub-range of the reader's rows per task without changing the
    union of the stage's outputs: row-wise ops, partial aggregation
    (partial states over a slice are still valid states — the downstream
    final agg merges them), and joins entered via the probe (left) side —
    each probe row still sees the full build input.  Everything else
    (final/single aggregation, sort, limit, full joins, build sides)
    deduplicates or orders across the whole partition and must see it
    intact."""
    path: List = []
    if not _path_to(root, reader, path):
        return False
    below = reader
    for node in path:
        if isinstance(node, JoinExec):
            if node.join_type == "full" or below is not node.left:
                return False
        elif isinstance(node, HashAggregateExec):
            if node.mode != "partial":
                return False
        elif not isinstance(node, _ROW_WISE):
            return False
        below = node
    return True


def _split_indices(weights: List[int], k: int) -> List[Tuple[int, int]]:
    """Partition ``range(len(weights))`` into ``k`` contiguous slices of
    roughly equal total weight (at least one element each)."""
    n = len(weights)
    k = max(1, min(k, n))
    total = sum(weights) or 1
    out: List[Tuple[int, int]] = []
    lo, acc = 0, 0
    for i, w in enumerate(weights):
        acc += w
        if len(out) < k - 1 and acc * k >= total * (len(out) + 1) \
                and (n - i - 1) >= (k - len(out) - 1):
            out.append((lo, i + 1))
            lo = i + 1
    out.append((lo, n))
    return out


# --------------------------------------------------------------------------
# resolve-time rewrite: dynamic coalescing + skew splitting
# --------------------------------------------------------------------------

def _plan_groups(stage, policy: AqePolicy,
                 readers: List[ShuffleReaderExec]):
    """Decide the stage's new task layout from the observed partition
    sizes.  Returns (groups, splits): ``groups`` is a list of task
    definitions, each a list of ``(source_partition, lo, hi)`` — ``lo/hi``
    are a map-output slice for skew splits, ``None`` for whole partitions;
    ``splits`` maps a hot partition to its target reader."""
    n = stage.partitions
    rows = [0] * n
    byts = [0] * n
    for r in readers:
        for q, locs in r.locations.items():
            if 0 <= q < n:
                rows[q] += sum(l.num_rows for l in locs)
                byts[q] += sum(l.num_bytes for l in locs)
    mean = sum(rows) / n if n else 0.0

    # skew: split the biggest contributor's map-output list for a hot
    # partition, provided the path to the stage root tolerates slicing
    splits: Dict[int, Tuple[ShuffleReaderExec, List[Tuple[int, int]]]] = {}
    if policy.skew_enabled and mean > 0:
        for q in range(n):
            if rows[q] < policy.skew_min_rows \
                    or rows[q] <= policy.skew_factor * mean:
                continue
            target = max(readers, key=lambda r: sum(
                l.num_rows for l in r.locations.get(q, [])))
            locs = target.locations.get(q, [])
            if len(locs) < 2 or not _split_safe(stage.resolved_plan, target):
                continue
            k = min(len(locs), max(2, round(rows[q] / max(mean, 1.0))))
            slices = _split_indices([l.num_rows for l in locs], k)
            if len(slices) > 1:
                splits[q] = (target, slices)

    # coalescing: greedy pack adjacent partitions while the merged task
    # stays under both targets (0 disables that dimension; both 0 = off)
    tgt_r = policy.coalesce_target_rows
    tgt_b = policy.coalesce_target_bytes
    can_coalesce = policy.coalesce_enabled and (tgt_r > 0 or tgt_b > 0)
    groups: List[List[Tuple[int, Optional[int], Optional[int]]]] = []
    cur: List[Tuple[int, Optional[int], Optional[int]]] = []
    cur_rows = cur_bytes = 0

    def flush():
        nonlocal cur, cur_rows, cur_bytes
        if cur:
            groups.append(cur)
        cur, cur_rows, cur_bytes = [], 0, 0

    for q in range(n):
        if q in splits:
            flush()
            for lo, hi in splits[q][1]:
                groups.append([(q, lo, hi)])
            continue
        fits = (not cur
                or ((tgt_r <= 0 or cur_rows + rows[q] <= tgt_r)
                    and (tgt_b <= 0 or cur_bytes + byts[q] <= tgt_b)))
        if not can_coalesce or not fits:
            flush()
        cur.append((q, None, None))
        cur_rows += rows[q]
        cur_bytes += byts[q]
    flush()
    return groups, splits


def _apply_groups(stage, groups, splits,
                  readers: List[ShuffleReaderExec]) -> None:
    """Remap every aligned reader to the new task layout.  The split
    target reader fetches only its slice of a hot partition; every other
    reader replicates the whole source partition into each slice task
    (the join build / secondary input every probe slice must see)."""
    for r in readers:
        new_locs: Dict[int, list] = {}
        for gi, group in enumerate(groups):
            merged = []
            for q, lo, hi in group:
                locs = r.locations.get(q, [])
                if lo is not None and q in splits and splits[q][0] is r:
                    merged.extend(locs[lo:hi])
                else:
                    merged.extend(locs)
            new_locs[gi] = merged
        if getattr(r, "_orig_partition_count", None) is None:
            # rollback rebuilds UnresolvedShuffleExec from this: it must
            # restore the PLANNED partitioning (same contract as the
            # static coalescing path)
            r._orig_partition_count = r.partition_count
        r.partition_count = len(groups)
        r.locations = new_locs


def _resize_stage(stage, n_new: int) -> None:
    if getattr(stage, "_orig_partitions", None) is None:
        stage._orig_partitions = stage.partitions
    stage.partitions = n_new
    stage.task_infos = [None] * n_new
    # budgets/attempt counters keep per-index monotonicity across
    # rollbacks; skew splitting can exceed the planned length, so extend
    # (never truncate — rollback restores the planned count)
    if len(stage.task_failures) < n_new:
        stage.task_failures.extend([0] * (n_new - len(stage.task_failures)))
    if len(stage.task_attempts) < n_new:
        stage.task_attempts.extend([0] * (n_new - len(stage.task_attempts)))


def rewrite_resolved_stage(graph, stage, policy: AqePolicy) -> None:
    """Dynamic coalesce + skew split on a just-resolved stage.  Called
    from ``ExecutionGraph.revive`` after ``resolved_plan`` is built and
    before any of the stage's tasks launch."""
    if not policy.enabled or stage.resolved_plan is None \
            or stage.partitions <= 1:
        return
    readers, ok = _aligned_readers(stage.resolved_plan)
    if not ok or not readers:
        return
    if any(r.partition_count != stage.partitions for r in readers):
        return  # already rewritten, or partition-count mismatch: hands off
    groups, splits = _plan_groups(stage, policy, readers)
    coalesced = sum(len(g) - 1 for g in groups if len(g) > 1)
    if not coalesced and not splits:
        return
    kinds = (["coalesce"] if coalesced else []) + (["skew"] if splits else [])
    if not _fire_failpoint(graph, stage.stage_id, "+".join(kinds)):
        return
    before = stage.partitions
    _apply_groups(stage, groups, splits, readers)
    _resize_stage(stage, len(groups))
    record = {
        "stage_id": stage.stage_id,
        "stage_attempt": stage.stage_attempt,
        "kinds": kinds,
        "partitions_before": before,
        "partitions_after": len(groups),
        "coalesced_partitions": coalesced,
        "skew_splits": [{"partition": q, "tasks": len(s)}
                        for q, (_r, s) in sorted(splits.items())],
    }
    _record(graph, stage, record)
    if coalesced:
        graph.aqe_events.append(("coalesce", coalesced))
    if splits:
        graph.aqe_events.append(("skew", len(splits)))


# --------------------------------------------------------------------------
# completion-time rewrite: shuffle-join -> broadcast switch
# --------------------------------------------------------------------------

def maybe_broadcast_switch(graph, stage, events: List[Tuple[str, object]],
                           policy: AqePolicy) -> None:
    """On completion of ``stage``: if its actual shuffle output is under
    the broadcast threshold, flip every downstream partitioned join that
    builds from it to a broadcast join, and graft away the probe side's
    exchange when that exchange feeds only this join and hasn't finished
    (its in-flight tasks are cancelled via ``events``)."""
    if not (policy.enabled and policy.broadcast_enabled):
        return
    rows = sum(w.num_rows for _ex, writes in stage.outputs.values()
               for w in writes)
    if rows > policy.broadcast_threshold_rows:
        return
    for cid in list(stage.output_links):
        consumer = graph.stages.get(cid)
        if consumer is None or consumer.state != "unresolved":
            continue
        for join in collect_nodes(consumer.plan, JoinExec):
            if join.dist != "partitioned" or join.join_type == "full":
                continue
            if not isinstance(join.right, UnresolvedShuffleExec) \
                    or join.right.stage_id != stage.stage_id:
                continue
            if not _fire_failpoint(graph, cid, "broadcast"):
                continue
            join.dist = "broadcast"
            grafted = _maybe_graft_probe_exchange(graph, consumer, join,
                                                  events)
            record = {
                "stage_id": cid,
                "stage_attempt": consumer.stage_attempt,
                "kinds": ["broadcast"],
                "build_stage_id": stage.stage_id,
                "build_rows": rows,
                "grafted_stage_id": grafted,
            }
            _record(graph, consumer, record)
            graph.aqe_events.append(("broadcast", 1))


def _maybe_graft_probe_exchange(graph, consumer, join,
                                events) -> Optional[int]:
    """Replace the join's probe-side exchange with the exchange's own
    input subtree when nothing else reads it — the broadcast join no
    longer needs the probe co-partitioned, so the (usually big) probe
    shuffle is skipped entirely.  Returns the absorbed stage id."""
    left = join.left
    if not isinstance(left, UnresolvedShuffleExec):
        return None
    producer = graph.stages.get(left.stage_id)
    if producer is None or producer.state == "successful":
        return None  # work already done: keep reading its output
    if producer.state != "unresolved" and producer.producer_ids:
        # resolution mutates stage plans in place: a non-leaf exchange
        # that already resolved reads its upstreams through baked
        # ShuffleReaderExecs, and absorbing that subtree would sever the
        # lineage (orphaned producer stages, stale locations after a
        # rollback).  Keep the exchange — the broadcast flip alone stands.
        return None
    if producer.output_links != [consumer.stage_id]:
        return None  # another stage reads this exchange
    feeds = [u for u in collect_nodes(consumer.plan, UnresolvedShuffleExec)
             if u.stage_id == left.stage_id]
    if len(feeds) != 1:
        return None  # self-join: the exchange feeds the consumer twice
    # cancel the exchange's in-flight attempts before absorbing it
    for info in producer.task_infos:
        if info is not None and info.state == "running":
            events.append(("cancel_task", (
                info.executor_id,
                TaskId(graph.job_id, producer.stage_id, info.partition,
                       task_attempt=info.attempt,
                       stage_attempt=producer.stage_attempt))))
    join.left = producer.plan.input
    del graph.stages[producer.stage_id]
    consumer.producer_ids = sorted(
        {u.stage_id for u in collect_nodes(consumer.plan,
                                           UnresolvedShuffleExec)})
    # the absorbed exchange's producers now feed the consumer directly
    for pid in producer.producer_ids:
        upstream = graph.stages.get(pid)
        if upstream is None:
            continue
        links = [consumer.stage_id if l == producer.stage_id else l
                 for l in upstream.output_links]
        seen = set()
        upstream.output_links = [l for l in links
                                 if not (l in seen or seen.add(l))]
    # the join now emits the grafted subtree's partitioning
    n = consumer.plan.output_partition_count()
    consumer.partitions = n
    consumer._orig_partitions = None
    consumer.task_infos = [None] * n
    if len(consumer.task_failures) < n:
        consumer.task_failures.extend(
            [0] * (n - len(consumer.task_failures)))
    if len(consumer.task_attempts) < n:
        consumer.task_attempts.extend(
            [0] * (n - len(consumer.task_attempts)))
    return producer.stage_id


# --------------------------------------------------------------------------
# shared plumbing
# --------------------------------------------------------------------------

def _fire_failpoint(graph, stage_id: int, kind: str) -> bool:
    """Evaluate the pre-mutation failpoint.  ``drop`` (and any injected
    error) abandons the rewrite — the graph is still unmutated here, so
    skipping is always safe."""
    try:
        rule = faults.inject(FAILPOINT, job_id=graph.job_id,
                             stage_id=stage_id, kind=kind)
    except Exception as e:  # injected raise: AQE degrades to a no-op
        log.warning("aqe: rewrite of %s stage %s abandoned: %s",
                    graph.job_id, stage_id, e)
        return False
    return rule is None or rule.action != "drop"


def _record(graph, stage, record: dict) -> None:
    stage.aqe_rewrites.append(record)
    graph.aqe_log.append(record)
