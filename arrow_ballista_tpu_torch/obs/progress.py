"""Live per-job progress and ETA estimation.

One pure function — ``job_progress(graph)`` — folds the live
``ExecutionGraph`` stage states (+ its ``RuntimeStatsStore``) into a
fraction-complete, per-stage task counts, an observed rows/s, and a
quantile-based ETA.  Every surface that reports progress (watch frames,
EXPLAIN ANALYZE, the text bar) calls THIS function, so they cannot
disagree about how far along a job is.  The port's copy of
arrow_ballista_tpu/obs/progress.py.

Estimation notes:

- **Fraction** is completed tasks over total tasks across all stages,
  using each stage's CURRENT partition count (AQE coalescing can shrink
  a stage mid-flight, so the raw fraction may step; streaming consumers
  clamp it monotonically non-decreasing per stream — see
  ``monotonic_fraction``).
- **ETA** reuses ``nearest_rank_quantile`` over completed-attempt
  durations: remaining tasks x p50 (midpoint) .. p95 (high), divided by
  the observed parallelism.  While unresolved stages still dominate the
  remaining work the interval WIDENS (their operators have produced no
  durations yet, so the per-task quantiles say little about them).
- **rows/s** is total folded output rows over total completed task
  seconds — the same figures EXPLAIN ANALYZE prints.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from .stats import nearest_rank_quantile

#: multiplier applied to the ETA upper bound per unit of unresolved
#: share: with every task still behind an unresolved stage the interval
#: stretches to (1 + _UNRESOLVED_WIDEN) x the quantile estimate
_UNRESOLVED_WIDEN = 2.0


def job_progress(graph, now: Optional[float] = None) -> Dict:
    """Fold a live (or finished) ExecutionGraph into one progress dict.

    Pure read: no graph mutation, safe off the event loop (worst case a
    racing task flips ``state`` mid-scan and the count is one off for
    one sample).  Works on running, terminal, and recovered graphs.
    """
    stages: List[Dict] = []
    tasks_total = 0
    tasks_done = 0
    running = 0
    unresolved_tasks = 0
    durations: List[float] = []
    total_rows = 0
    total_task_s = 0.0
    stats = getattr(graph, "stats", None)
    for sid in sorted(graph.stages):
        stage = graph.stages[sid]
        total = max(1, int(stage.partitions))
        if stage.state == "successful":
            done = total
        else:
            done = sum(1 for t in stage.task_infos
                       if t is not None and t.state == "success")
        stage_running = sum(1 for t in stage.task_infos
                            if t is not None and t.state == "running")
        stage_running += sum(1 for t in stage.speculative_tasks.values()
                             if t is not None and t.state == "running")
        tasks_total += total
        tasks_done += min(done, total)
        running += stage_running
        if stage.state == "unresolved":
            unresolved_tasks += total - min(done, total)
        durations.extend(float(d) for d in stage.durations)
        folded = stats.stage(sid) if stats is not None else None
        if folded:
            total_rows += int(folded.get("output_rows", 0) or 0)
            dur = folded.get("task_duration_s") or {}
            total_task_s += (float(dur.get("mean", 0.0) or 0.0)
                             * int(dur.get("count", 0) or 0))
        stages.append({
            "stage_id": sid,
            "state": stage.state,
            "tasks_completed": min(done, total),
            "tasks_total": total,
            "tasks_running": stage_running,
            "fraction": round(min(done, total) / total, 4),
        })
    state = getattr(graph, "status", "running")
    fraction = tasks_done / tasks_total if tasks_total else 0.0
    if state == "successful":
        fraction = 1.0
    out: Dict = {
        "job_id": getattr(graph, "job_id", ""),
        "state": state,
        "fraction": round(fraction, 4),
        "tasks_completed": tasks_done,
        "tasks_total": tasks_total,
        "tasks_running": running,
        "stages": stages,
        "rows_per_sec": round(total_rows / total_task_s, 1)
        if total_task_s > 0 else 0.0,
    }
    remaining = tasks_total - tasks_done
    if state in ("successful", "failed", "cancelled"):
        out["eta_s"] = 0.0
        out["eta_high_s"] = 0.0
    elif durations and remaining > 0:
        p50 = nearest_rank_quantile(durations, 0.50) or 0.0
        p95 = nearest_rank_quantile(durations, 0.95) or p50
        lanes = float(max(1, running))
        unresolved_share = unresolved_tasks / remaining
        widen = 1.0 + _UNRESOLVED_WIDEN * unresolved_share
        out["eta_s"] = round(remaining * p50 / lanes, 3)
        out["eta_high_s"] = round(remaining * p95 * widen / lanes, 3)
        out["eta_basis"] = {"completed_durations": len(durations),
                            "unresolved_share": round(unresolved_share, 4)}
    else:
        # nothing has finished yet: no basis for an estimate
        out["eta_s"] = None
        out["eta_high_s"] = None
    return out


def monotonic_fraction(progress: Dict, floor: float) -> float:
    """Clamp a stream's reported fraction to be non-decreasing: AQE
    partition coalescing (and task-info rollbacks) can step the raw
    fraction backwards mid-flight, which a progress BAR must never show.
    Returns the new floor; callers thread it through their stream."""
    return max(float(floor), float(progress.get("fraction", 0.0) or 0.0))


def render_progress_bar(progress: Dict, width: int = 30) -> str:
    """One-line textual progress view."""
    frac = float(progress.get("fraction", 0.0) or 0.0)
    frac = min(max(frac, 0.0), 1.0)
    filled = int(round(frac * width))
    bar = "#" * filled + "-" * (width - filled)
    bits = [f"[{bar}] {frac * 100:5.1f}%",
            f"{progress.get('tasks_completed', 0)}/"
            f"{progress.get('tasks_total', 0)} tasks"]
    if progress.get("tasks_running"):
        bits.append(f"{progress['tasks_running']} running")
    rps = progress.get("rows_per_sec") or 0.0
    if rps:
        bits.append(f"{rps:,.0f} rows/s")
    eta = progress.get("eta_s")
    if eta is not None and progress.get("state") == "running":
        hi = progress.get("eta_high_s")
        bits.append(f"eta ~{eta:.1f}s" + (f" (<= {hi:.1f}s)" if hi else ""))
    return "  ".join(bits)
