"""Stage-fusion advisor: turn device-observatory evidence into a ranked
work-list for whole-stage fusion.

Fusing an operator pipeline into one generated kernel wins where
per-operator materialization and rebuilds dominate the actual compute.
The advisor walks an EXPLAIN ANALYZE report (obs/stats.py — per-operator
``device_ms`` / ``host_ms`` / ``transfer_bytes`` / build counts from
obs/device.py), finds maximal single-input operator chains inside each
stage plan, and scores each chain by the overhead fusion would eliminate:

- ``host_ms`` of every operator after the chain head (inter-operator
  transfer dispatch + nvcc build time that one fused kernel would not
  pay),
- the head operator's own rebuild time (one fused kernel has one
  generated source instead of N),

producing deterministic, savings-ranked fusion candidates.  Pure
function of the report: usable offline on a saved JSON and through
``ctx.advise``.  The port's copy of arrow_ballista_tpu/obs/advisor.py.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

# ONE candidate finder shared with the whole-stage compiler
# (compile/chains.py): the advisor and compile/fuse.py walk the same
# chains, so every advised chain is one the compiler actually considered
from ..compile.chains import STATIC_REASONS, UNFUSABLE, dict_chains

# backward-compat aliases (the walk used to live here)
_UNFUSABLE = UNFUSABLE
_chains = dict_chains


def _fusion_status(chain: List[Dict],
                   fusion_records) -> Tuple[bool, Optional[str]]:
    """Did the whole-stage compiler actually fuse this chain?  ``(fused,
    reason_if_not)`` — a chain whose operator_tree already contains a
    ``FusedStageExec`` ran compiled; otherwise the stage's recorded
    fusion decisions (compile/fuse.py verdicts, matched by pre-fusion
    path) carry the exact rejection reasons; with no record at all (policy
    off, local engine) fall back to the static per-operator reasons."""
    ops = [op["op"] for op in chain]
    if "FusedStageExec" in ops:
        return True, None
    paths = {op["path"] for op in chain}
    for rec in fusion_records or ():
        if not (paths & set(rec.get("paths", ()))):
            continue
        if rec.get("fused"):
            return True, None
        reasons = [f"{r['op']}: {r['reason']}"
                   for r in rec.get("rejected") or ()]
        return False, "; ".join(reasons) or "rejected by compile policy"
    for op in ops:
        if op in STATIC_REASONS:
            return False, STATIC_REASONS[op]
    return False, "no fusion decision recorded (compiler not enabled)"


def _candidate(stage_id: int, chain: List[Dict],
               fusion_records=()) -> Dict:
    device_ms = sum(op.get("device_ms", 0.0) for op in chain)
    host_ms = sum(op.get("host_ms", 0.0) for op in chain)
    transfer = sum(op.get("transfer_bytes", 0) for op in chain)
    compiles = sum(op.get("compiles", 0) for op in chain)
    retraces = sum(op.get("retraces", 0) for op in chain)
    # fusing keeps ONE program entry: the chain head still pays its own
    # first compile + transfers; everything downstream's host_ms goes away,
    # plus the head's retrace share of its compile time
    tail_host_ms = sum(op.get("host_ms", 0.0) for op in chain[1:])
    head = chain[0]
    head_mm = head.get("metrics") or {}
    head_compile_ms = head_mm.get("jit_compile_time", 0.0) * 1000.0
    head_events = head.get("compiles", 0) + head.get("retraces", 0)
    head_retrace_ms = (head_compile_ms * head.get("retraces", 0)
                       / head_events) if head_events else 0.0
    est_savings_ms = tail_host_ms + head_retrace_ms
    total_ms = device_ms + host_ms
    reasons = []
    if tail_host_ms:
        reasons.append(
            f"{tail_host_ms:.1f} ms of transfer+compile dispatch in "
            f"{len(chain) - 1} downstream operator(s)")
    if head_retrace_ms:
        reasons.append(
            f"{head_retrace_ms:.1f} ms retracing the chain head")
    if transfer:
        reasons.append(f"{transfer} bytes crossing the host boundary "
                       "inside the chain")
    if not reasons:
        reasons.append("no measured overhead; fusion would only save "
                       "per-operator dispatch")
    fused, reject_reason = _fusion_status(chain, fusion_records)
    return {
        # convergence with the whole-stage compiler: did this chain
        # actually run as one kernel, and if not, why it was left
        # interpreted (exact per-operator verdicts from the stage record)
        "fused": fused,
        "reason": reject_reason,
        "stage_id": stage_id,
        "operators": [op["op"] for op in chain],
        "labels": [op["label"].splitlines()[0] for op in chain],
        "paths": [op["path"] for op in chain],
        "device_ms": round(device_ms, 3),
        "host_ms": round(host_ms, 3),
        "transfer_bytes": int(transfer),
        "compiles": int(compiles),
        "retraces": int(retraces),
        "est_savings_ms": round(est_savings_ms, 3),
        "overhead_ratio": round(host_ms / total_ms, 4) if total_ms else 0.0,
        "reasons": reasons,
    }


def advise_report(report: Dict, min_savings_ms: float = 0.0) -> Dict:
    """Rank fusion candidates from an EXPLAIN ANALYZE report.  Pure and
    deterministic: equal inputs produce equal output (ties order by
    (stage_id, head path))."""
    candidates = []
    for stage in report.get("stages", ()):
        sid = stage.get("stage_id", 0)
        recs = stage.get("fusion") or ()
        for chain in dict_chains(stage.get("operator_tree") or []):
            cand = _candidate(sid, chain, recs)
            if cand["est_savings_ms"] >= min_savings_ms:
                candidates.append(cand)
    candidates.sort(key=lambda c: (-c["est_savings_ms"], c["stage_id"],
                                   c["paths"][0]))
    out = {
        "job_id": report.get("job_id", ""),
        "generated_from": "explain_analyze",
        "min_savings_ms": float(min_savings_ms),
        "wall_time_ms": report.get("wall_time_ms", 0.0),
        "candidates": candidates,
        "total_est_savings_ms": round(
            sum(c["est_savings_ms"] for c in candidates), 3),
    }
    out["text"] = render_advice(out)
    return out


def advise_graph(graph, min_savings_ms: float = 0.0) -> Dict:
    """Advisor over a live/finished ExecutionGraph."""
    from .stats import explain_analyze_report

    return advise_report(explain_analyze_report(graph), min_savings_ms)


def render_advice(advice: Dict) -> str:
    lines = [f"== FUSION ADVISOR: job {advice['job_id']} — "
             f"{len(advice['candidates'])} candidate(s), "
             f"~{advice['total_est_savings_ms']:.1f} ms estimated =="]
    if not advice["candidates"]:
        lines.append("no operator chain shows measurable materialization "
                     "or recompilation overhead")
    for i, c in enumerate(advice["candidates"], 1):
        mark = "FUSED" if c.get("fused") else "advised"
        lines.append(
            f"{i}. stage {c['stage_id']} [{mark}]: "
            + " -> ".join(c["operators"])
            + f"  (~{c['est_savings_ms']:.1f} ms, overhead ratio "
              f"{c['overhead_ratio']:.0%})")
        lines.append(f"   device {c['device_ms']:.1f} ms · host "
                     f"{c['host_ms']:.1f} ms · {c['transfer_bytes']} "
                     f"transfer bytes · {c['compiles']} compiles"
                     f"/{c['retraces']} retraces")
        if not c.get("fused") and c.get("reason"):
            lines.append(f"   not fused: {c['reason']}")
        for r in c["reasons"]:
            lines.append(f"   - {r}")
    return "\n".join(lines)
