"""Runtime statistics observatory: per-stage stats + cluster time series.

The port's copy of arrow_ballista_tpu/obs/stats.py.  It folds the raw
material the standalone engine already keeps — per-operator metric
snapshots on every task status, completed-attempt durations, and
``ShuffleWritePartition`` row/byte records — into forms a user (or a
later adaptive decision) can read:

- :class:`RuntimeStatsStore` — per-job store of per-stage summaries
  (per-partition row/byte distribution + histogram, skew coefficient,
  bytes shuffled, task duration quantiles), refreshed as tasks complete
  and kept live on the ExecutionGraph (``graph.stats``).
- :func:`explain_analyze_report` — EXPLAIN ANALYZE: the physical plan
  re-rendered with actual rows/bytes/wall-time per operator and skew per
  stage, in JSON and text forms, from the same ``operator_metrics()``
  fold the job profile uses (so the two cannot disagree);
  :func:`local_explain_report` is the local engine's form.
- :class:`ClusterHistory` — bounded ring buffer of periodic cluster
  samples (executor utilization, event-loop lag) read by the doctor.

The nearest-rank quantile lives here so "p95 task duration" means the same
thing in a profile, a doctor finding and a live straggler alert.

Thread model: folding happens on the scheduler event loop (single
writer); clients read from other threads.  Summaries are plain dicts
swapped in with one atomic assignment — readers always see a complete
snapshot, no lock needed.
"""
from __future__ import annotations

import math
from collections import deque
from typing import Dict, List, Optional, Sequence

# decade buckets for the per-partition row histogram: wide enough to span
# a single-row reduce bucket and a 10^9-row scan without tuning
ROW_HISTOGRAM_EDGES = (1, 10, 100, 1_000, 10_000, 100_000,
                       1_000_000, 10_000_000, 100_000_000)

_QUANTILES = ((0.5, "p50"), (0.75, "p75"), (0.95, "p95"))


def nearest_rank_quantile(xs: Sequence[float], q: float) -> Optional[float]:
    """Nearest-rank quantile (q=0.75 over 4 samples -> 3rd smallest), the
    same estimator the speculation cutoff uses — shared so stats views and
    the straggler policy agree on what "p95" means."""
    if not xs:
        return None
    s = sorted(xs)
    qq = min(max(float(q), 0.0), 1.0)
    rank = max(1, int(math.ceil(qq * len(s))))
    return s[rank - 1]


def row_histogram(values: Sequence[int]) -> Dict[str, List[int]]:
    """Histogram of per-partition row counts over decade buckets; the last
    count is the overflow (> largest edge)."""
    counts = [0] * (len(ROW_HISTOGRAM_EDGES) + 1)
    for v in values:
        for i, edge in enumerate(ROW_HISTOGRAM_EDGES):
            if v <= edge:
                counts[i] += 1
                break
        else:
            counts[-1] += 1
    return {"edges": list(ROW_HISTOGRAM_EDGES), "counts": counts}


def skew_coefficient(values: Sequence[int]) -> float:
    """max/mean over per-partition rows: 1.0 = perfectly balanced, N =
    the hottest partition carries N× its fair share (the AQE trigger for
    splitting hot partitions).  0.0 when the stage produced no rows."""
    if not values:
        return 0.0
    mean = sum(values) / len(values)
    if mean <= 0:
        return 0.0
    return max(values) / mean


def duration_quantiles(durations: Sequence[float]) -> Dict[str, float]:
    """Task-duration summary via the nearest-rank quantile."""
    out: Dict[str, float] = {"count": len(durations)}
    if not durations:
        return out
    for q, name in _QUANTILES:
        out[name] = round(nearest_rank_quantile(durations, q), 4)
    out["max"] = round(max(durations), 4)
    out["mean"] = round(sum(durations) / len(durations), 4)
    return out


_DEVICE_PEAK_KEYS = ("device_mem_peak", "host_mem_peak")


def device_summary(stage) -> Dict:
    """Fold completed tasks' ``TaskStatus.device_stats`` into a per-stage
    device summary: counters sum (each status carries the task's own
    delta, not a cumulative snapshot), watermarks take the max.  Same
    attempt guard as ``operator_metrics`` — a terminal status absorbed
    from a cancelled speculative loser doesn't count.  Empty dict when
    the device observatory was off for every task."""
    totals: Dict[str, float] = {}
    peaks: Dict[str, float] = {}
    for t in stage.task_infos:
        st = getattr(t, "status", None)
        ds = getattr(st, "device_stats", None)
        if not ds:
            continue
        st_att = getattr(getattr(st, "task", None), "task_attempt", None)
        if st_att is not None and st_att != getattr(t, "attempt", st_att):
            continue
        for k, v in ds.items():
            if k in _DEVICE_PEAK_KEYS:
                if v > peaks.get(k, 0):
                    peaks[k] = v
            else:
                totals[k] = totals.get(k, 0) + v
    out = {k: (round(v, 6) if isinstance(v, float) else v)
           for k, v in sorted(totals.items())}
    out.update({k: int(v) for k, v in sorted(peaks.items())})
    return out


def stage_summary(stage) -> Dict:
    """Fold one ExecutionStage's completed-task evidence into a summary.

    Reads ``outputs`` (ShuffleWritePartition records keyed by map
    partition), ``durations`` (completed-attempt seconds), the attempt
    log, and ``operator_metrics()`` (the last-snapshot-per-process fold
    the profile endpoint uses).  Pure read — never mutates the stage.
    """
    part_rows: Dict[int, int] = {}
    part_bytes: Dict[int, int] = {}
    for _map_part, (_executor_id, writes) in sorted(stage.outputs.items()):
        for w in writes:
            part_rows[w.output_partition] = \
                part_rows.get(w.output_partition, 0) + int(w.num_rows)
            part_bytes[w.output_partition] = \
                part_bytes.get(w.output_partition, 0) + int(w.num_bytes)
    rows_list = [part_rows[p] for p in sorted(part_rows)]
    launches = list(getattr(stage, "attempt_log", ()))
    operators = stage.operator_metrics()
    spill_bytes = sum(int(m.get("spill_bytes", 0))
                      for m in operators.values())
    spill_runs = sum(int(m.get("spill_runs", 0))
                     for m in operators.values())
    return {
        "stage_id": stage.stage_id,
        "state": stage.state,
        "stage_attempt": stage.stage_attempt,
        "partitions": stage.partitions,
        "planned_partitions": stage.planned_partitions,
        "tasks_completed": sum(1 for t in stage.task_infos
                               if t is not None and t.state == "success"),
        "task_launches": len(launches),
        "speculative_launches": sum(1 for e in launches if e["speculative"]),
        "output_rows": sum(rows_list),
        "output_bytes": sum(part_bytes.values()),
        "partition_rows": {str(p): part_rows[p] for p in sorted(part_rows)},
        "partition_bytes": {str(p): part_bytes[p]
                            for p in sorted(part_bytes)},
        "skew": round(skew_coefficient(rows_list), 4),
        "row_histogram": row_histogram(rows_list),
        "task_duration_s": duration_quantiles(list(stage.durations)),
        "operators": operators,
        # memory-governor spill totals across this stage's operators
        # (memory/spill.py): nonzero means reservations were denied and
        # joins/aggs degraded to disk
        "spill_bytes": spill_bytes,
        "spill_runs": spill_runs,
        # device-observatory fold (obs/device.py): generated-kernel builds,
        # kernel launches and event times, transfer bytes/seconds, memory
        # watermark peaks
        "device": device_summary(stage),
        # runtime rewrites applied to this stage (scheduler/aqe.py):
        # coalesce / skew-split / broadcast records with before/after
        # partition counts
        "aqe": [dict(r) for r in getattr(stage, "aqe_rewrites", [])],
        # whole-stage fusion decisions (compile/fuse.py): which operator
        # chains fused into one generated kernel and which were rejected,
        # with the rejection reason per operator
        "fusion": [dict(r) for r in getattr(stage, "fusion_rewrites", [])],
    }


class RuntimeStatsStore:
    """Per-job runtime statistics, kept live on the ExecutionGraph.

    ``fold_stage`` is called from the graph's success path (event-loop
    thread) every time a task completes, so the summary tracks a running
    stage and is final the moment the stage turns SUCCESSFUL.  A summary
    survives later rollbacks of its stage (the rolled-back attempt's
    numbers stay queryable until a re-run refolds them) — AQE reads what
    the *last completed* attempt actually produced.
    """

    def __init__(self, job_id: str):
        self.job_id = job_id
        self._stages: Dict[int, Dict] = {}

    def fold_stage(self, stage) -> Dict:
        summary = stage_summary(stage)
        self._stages[stage.stage_id] = summary  # atomic swap (see module doc)
        return summary

    def stage(self, stage_id: int) -> Optional[Dict]:
        return self._stages.get(stage_id)

    def stage_ids(self) -> List[int]:
        return sorted(self._stages)

    def snapshot(self) -> Dict:
        stages = [self._stages[sid] for sid in sorted(self._stages)]
        return {
            "job_id": self.job_id,
            "stages": stages,
            "total_output_rows": sum(s["output_rows"] for s in stages),
            "total_shuffle_bytes": sum(s["output_bytes"] for s in stages),
        }


# --- EXPLAIN ANALYZE ------------------------------------------------------

def _walk_plan(node, path="0", depth=0, out=None):
    """Pre-order walk with the executor-side metric path key convention
    ("0", "0.0", ...; execution_engine.collect_plan_metrics).  Shuffle
    readers are stage leaves — their producers are other stages."""
    if out is None:
        out = []
    out.append((path, depth, node))
    if type(node).__name__ not in ("ShuffleReaderExec",
                                   "UnresolvedShuffleExec"):
        for i, c in enumerate(node.children()):
            _walk_plan(c, f"{path}.{i}", depth + 1, out)
    return out


def _op_entry(path: str, depth: int, node, mm: Dict[str, float]) -> Dict:
    time_ms = sum(v for k, v in mm.items() if k.endswith("_time")) * 1000.0
    # spill bytes are disk traffic, reported separately — not part of the
    # operator's data-flow byte total
    nbytes = sum(v for k, v in mm.items()
                 if k.endswith("_bytes") and k != "spill_bytes")
    # device-observatory split (obs/device.py): host_ms is the accounted
    # non-compute wall time inside this operator — transfer dispatch +
    # nvcc builds of generated sources — and device_ms the remainder of its
    # timed work.  transfer_bytes separates host<->device traffic from the
    # shuffle bytes that also fold into ``bytes``.
    host_ms = (mm.get("h2d_time", 0.0) + mm.get("d2h_time", 0.0)
               + mm.get("jit_compile_time", 0.0)) * 1000.0
    label = node._label() if hasattr(node, "_label") else type(node).__name__
    return {
        "path": path,
        "depth": depth,
        "op": type(node).__name__,
        "label": label,
        "rows": int(mm["output_rows"]) if "output_rows" in mm else None,
        "time_ms": round(time_ms, 3),
        "bytes": int(nbytes),
        "device_ms": round(max(time_ms - host_ms, 0.0), 3),
        "host_ms": round(host_ms, 3),
        "transfer_bytes": int(mm.get("h2d_bytes", 0) + mm.get("d2h_bytes", 0)),
        "compiles": int(mm.get("jit_compiles", 0)),
        "retraces": int(mm.get("jit_retraces", 0)),
        # memory-governor spill (memory/spill.py): disk bytes + run files
        # this operator wrote after a reservation denial
        "spill_bytes": int(mm.get("spill_bytes", 0)),
        "spill_runs": int(mm.get("spill_runs", 0)),
        "metrics": {k: round(v, 6) for k, v in sorted(mm.items())},
    }


def annotate_plan(plan, op_metrics: Dict[str, Dict[str, float]]) -> List[Dict]:
    """Per-operator annotation entries for one stage plan, joined to the
    stage's folded operator metrics by path key."""
    return [
        _op_entry(path, depth, node,
                  op_metrics.get(f"{path}:{type(node).__name__}", {}))
        for path, depth, node in _walk_plan(plan)
    ]


def _fmt_bytes(n: float) -> str:
    for unit in ("B", "KB", "MB", "GB"):
        if abs(n) < 1024.0 or unit == "GB":
            return f"{n:.1f} {unit}" if unit != "B" else f"{int(n)} B"
        n /= 1024.0
    return f"{n:.1f} GB"


def _op_suffix(op: Dict) -> str:
    parts = []
    if op["rows"] is not None:
        parts.append(f"{op['rows']:,} rows")
    if op["time_ms"]:
        parts.append(f"{op['time_ms']:.1f} ms")
    if op["bytes"]:
        parts.append(_fmt_bytes(op["bytes"]))
    if op.get("spill_bytes"):
        parts.append(f"spilled {_fmt_bytes(op['spill_bytes'])} "
                     f"({op.get('spill_runs', 0)} runs)")
    return f"  [{' · '.join(parts)}]" if parts else ""


def _stage_header(s: Dict) -> str:
    dur = s.get("task_duration_s") or {}
    bits = [
        f"Stage {s['stage_id']} [{s['state']}]",
        f"{s['tasks_completed']}/{s['partitions']} tasks",
        f"{s['output_rows']:,} rows out",
        _fmt_bytes(s["output_bytes"]),
        f"skew {s['skew']:.2f}",
    ]
    if s.get("speculative_launches"):
        bits.append(f"{s['speculative_launches']} speculative")
    if s.get("spill_bytes"):
        bits.append(f"spilled {_fmt_bytes(s['spill_bytes'])} "
                    f"({s.get('spill_runs', 0)} runs)")
    for r in s.get("aqe") or ():
        kinds = "+".join(r.get("kinds", ())) or "rewrite"
        if "partitions_before" in r:
            bits.append(f"aqe {kinds} {r['partitions_before']}->"
                        f"{r['partitions_after']}")
        else:
            bits.append(f"aqe {kinds}")
    for r in s.get("fusion") or ():
        if r.get("fused"):
            for run in r.get("fused_ops") or ():
                bits.append("fused " + "+".join(run)
                            + (" (donated)" if r.get("donate") else ""))
    if dur.get("count"):
        bits.append(f"task p50 {dur['p50']:.3f}s p95 {dur['p95']:.3f}s "
                    f"max {dur['max']:.3f}s")
    dev = s.get("device") or {}
    if dev.get("jit_compiles") or dev.get("jit_retraces"):
        # jit_* keys keep the reference's names; in the port they count
        # nvcc builds of generated sources (obs/device.py)
        bits.append(f"nvcc {int(dev.get('jit_compiles', 0))} builds"
                    f"/{int(dev.get('jit_retraces', 0))} rebuilds")
    xfer = dev.get("h2d_bytes", 0) + dev.get("d2h_bytes", 0)
    if xfer:
        bits.append("xfer " + _fmt_bytes(xfer))
    if dev.get("device_mem_peak"):
        bits.append("device mem peak " + _fmt_bytes(dev["device_mem_peak"]))
    return " · ".join(bits)


def render_explain_analyze(report: Dict) -> str:
    """Text form of an explain-analyze report (the JSON is the report
    itself)."""
    head = [f"== EXPLAIN ANALYZE: job {report['job_id']} "
            f"[{report['state']}] =="]
    line2 = [f"wall time: {report['wall_time_ms']:.1f} ms"]
    if report.get("rows_returned") is not None:
        line2.append(f"rows returned: {report['rows_returned']:,}")
    line2.append("bytes shuffled: "
                 + _fmt_bytes(report.get("total_shuffle_bytes", 0)))
    head.append(" · ".join(line2))
    lines = head
    for s in report["stages"]:
        lines.append("")
        lines.append(_stage_header(s))
        for op in s.get("operator_tree", ()):  # pre-order, depth-indented
            lines.append("  " * (op["depth"] + 1) + op["label"].splitlines()[0]
                         + _op_suffix(op))
    return "\n".join(lines)


def explain_analyze_report(graph, wall_time_ms: float = 0.0,
                           rows_returned: Optional[int] = None) -> Dict:
    """EXPLAIN ANALYZE over a (finished or running) ExecutionGraph: the
    per-stage summaries from ``graph.stats`` plus the per-operator
    annotation of each stage's physical plan.  Numbers come from the same
    folds as the job profile (obs/profile.py) — consistent by
    construction."""
    stats = getattr(graph, "stats", None)
    stages = []
    for sid in sorted(graph.stages):
        stage = graph.stages[sid]
        summary = (stats.stage(sid) if stats is not None else None) \
            or stage_summary(stage)
        summary = dict(summary)
        summary["operator_tree"] = annotate_plan(
            stage.resolved_plan or stage.plan, summary["operators"])
        stages.append(summary)
    report = {
        "job_id": graph.job_id,
        "state": graph.status,
        "wall_time_ms": round(float(wall_time_ms), 3),
        "rows_returned": rows_returned,
        "total_output_rows": sum(s["output_rows"] for s in stages),
        "total_shuffle_bytes": sum(s["output_bytes"] for s in stages),
        "stages": stages,
    }
    # the same fraction the watch stream reports — one computation
    # (obs/progress.py), every surface agrees
    from .progress import job_progress

    report["progress"] = job_progress(graph)
    report["text"] = render_explain_analyze(report)
    return report


def local_explain_report(plan, wall_time_ms: float = 0.0,
                         rows_returned: Optional[int] = None,
                         device_stats: Optional[Dict] = None) -> Dict:
    """EXPLAIN ANALYZE for the local (single-process) engine: no stage
    DAG or shuffle files, so the whole plan is one synthetic stage and
    metrics come straight off the executed operator instances.
    ``device_stats`` is the run's device-observatory fold (the local
    analog of ``TaskStatus.device_stats``); when absent the stage-level
    device view is re-derived from the operators' own device metrics
    (which then lacks watermarks — those only exist scope-level)."""
    op_metrics = {
        f"{path}:{type(node).__name__}": node.metrics().to_dict()
        for path, _depth, node in _walk_plan(plan)
        if hasattr(node, "metrics")
    }
    if device_stats is None:
        device_stats = {}
        for mm in op_metrics.values():
            for k in ("jit_compiles", "jit_retraces", "jit_cache_hits",
                      "jit_compile_time", "h2d_bytes", "d2h_bytes",
                      "h2d_time", "d2h_time", "h2d_transfers",
                      "d2h_transfers"):
                if mm.get(k):
                    device_stats[k] = round(
                        device_stats.get(k, 0) + mm[k], 6)
    stage = {
        "stage_id": 0,
        "state": "successful",
        "stage_attempt": 0,
        "partitions": plan.output_partition_count(),
        "planned_partitions": plan.output_partition_count(),
        "tasks_completed": plan.output_partition_count(),
        "task_launches": plan.output_partition_count(),
        "speculative_launches": 0,
        "output_rows": rows_returned or 0,
        "output_bytes": 0,
        "partition_rows": {},
        "partition_bytes": {},
        "skew": 0.0,
        "row_histogram": row_histogram([]),
        "task_duration_s": duration_quantiles([]),
        "operators": op_metrics,
        "device": {k: device_stats[k] for k in sorted(device_stats)},
        "aqe": [],
        "fusion": [],
        "operator_tree": annotate_plan(plan, op_metrics),
    }
    report = {
        "job_id": "local",
        "state": "successful",
        "wall_time_ms": round(float(wall_time_ms), 3),
        "rows_returned": rows_returned,
        "total_output_rows": stage["output_rows"],
        "total_shuffle_bytes": 0,
        "stages": [stage],
    }
    report["text"] = render_explain_analyze(report)
    return report


# --- cluster time series --------------------------------------------------

class ClusterHistory:
    """Bounded ring buffer of periodic cluster samples (utilization,
    queue depths, event-loop lag), the saturation record the doctor's
    control-plane rule reads.  Appends happen on the scheduler's sampler
    thread; ``deque(maxlen)`` appends and list() reads are atomic under
    the GIL, so readers need no lock."""

    def __init__(self, capacity: int = 512, interval_s: float = 5.0):
        self.capacity = max(int(capacity), 1)
        self.interval_s = float(interval_s)
        self._samples: "deque[Dict]" = deque(maxlen=self.capacity)

    def record(self, sample: Dict) -> None:
        self._samples.append(sample)

    def snapshot(self) -> Dict:
        return {
            "capacity": self.capacity,
            "interval_s": self.interval_s,
            "samples": list(self._samples),
        }
