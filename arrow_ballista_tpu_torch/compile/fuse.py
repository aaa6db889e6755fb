"""Scheduler-side whole-stage fusion rewrite.

Mirrors arrow_ballista_tpu/compile/fuse.py.  ``fuse_stage`` runs right
after a stage's plan resolves and before any of its tasks launch: it finds
the fusable chains (``chains.plan_chains``), trims each to the policy's
operator allowlist, and replaces every surviving run with one
:class:`FusedStageExec`, whose body is one generated kernel (K12, K13).
Each decision — fused or rejected, and why — is recorded on the stage
(``fusion_rewrites``) and the graph (``compile_log``).  An operator whose
expressions the code generator cannot emit is recorded as "no generated
code for <op>" and stays interpreted.  The reference's re-check of the
rewritten stage by its plan validator is still to be ported
(analysis/plan_checks.py, ROADMAP.md queue 1).

Rollback safety comes from where the rewrite applies: only to
``stage.resolved_plan``.  A lineage rollback discards the resolved plan and
re-resolves from the unresolved one, and the fresh resolve fuses again
(``_fused_attempt`` keys on the stage-attempt epoch).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ..obs import journal
from ..ops.operators import FilterExec, HashAggregateExec, ProjectionExec, RenameExec
from ..ops.physical import exprs_sig, has_scalar_subquery
from ..utils.config import COMPILE_DONATE, COMPILE_ENABLED, COMPILE_MIN_OPS, COMPILE_OPERATORS
from ..utils.errors import PlanValidationError
from .chains import STATIC_REASONS, plan_chains, walk_plan_paths
from .fused import FusedStageExec, codegen_doubt

#: operator class names the default policy may fuse; each instance's own
#: doubts are re-checked in :func:`_op_verdict`
DEFAULT_OPERATORS = frozenset(
    {"FilterExec", "ProjectionExec", "RenameExec", "HashAggregateExec"})


class CompilePolicy:
    """Per-job fusion policy resolved from ``ballista.compile.*``.
    ``donate`` is read and recorded for parity with the reference; the
    port's generated kernels never write their inputs, so nothing is
    donated."""

    def __init__(self, enabled: bool = True, min_ops: int = 2,
                 operators=DEFAULT_OPERATORS, donate: bool = True):
        self.enabled = enabled
        self.min_ops = max(2, int(min_ops))
        self.operators = frozenset(operators)
        self.donate = donate

    @staticmethod
    def from_config(cfg) -> "CompilePolicy":
        if cfg is None:
            return CompilePolicy()
        ops = {s.strip() for s in cfg.get(COMPILE_OPERATORS).split(",") if s.strip()}
        return CompilePolicy(enabled=cfg.get(COMPILE_ENABLED),
                             min_ops=cfg.get(COMPILE_MIN_OPS),
                             operators=ops, donate=cfg.get(COMPILE_DONATE))

    def __repr__(self):
        return (f"CompilePolicy(enabled={self.enabled}, min_ops={self.min_ops}, "
                f"operators={sorted(self.operators)}, donate={self.donate})")


def _op_verdict(policy: CompilePolicy, node) -> Tuple[bool, Optional[str]]:
    """(fusable, reason-if-not) for one chain member."""
    name = type(node).__name__
    if name not in policy.operators:
        return False, STATIC_REASONS.get(
            name, f"{name} is not in the ballista.compile.operators allowlist")
    if isinstance(node, FilterExec):
        if node.host_mode:
            return False, "host-mode predicate (runs in numpy float64)"
        if has_scalar_subquery(node.predicate):
            return False, ("scalar subquery in predicate (job-specific "
                           "literal; program not shareable)")
        if exprs_sig([node.predicate]) is None:
            return False, "predicate has no serde signature (unsupported expression)"
    elif isinstance(node, ProjectionExec):
        exprs = [e for e, _ in node.exprs]
        if node.host_mode:
            return False, "host-mode projection (runs in numpy float64)"
        if has_scalar_subquery(*exprs):
            return False, ("scalar subquery in projection (job-specific "
                           "literal; program not shareable)")
        if exprs_sig(exprs) is None:
            return False, "projection has no serde signature (unsupported expression)"
    elif isinstance(node, HashAggregateExec):
        if node.mode != "partial":
            return False, (f"aggregate mode '{node.mode}' (only pre-shuffle "
                           "partial aggregates fuse; single/final carry "
                           "empty-input row semantics)")
        if not node.group_exprs:
            return False, "global aggregate (no group keys)"
        if node.clustered is not None:
            return False, ("clustered aggregate (early-HAVING + runtime "
                           "disorder detection run interpreted)")
        if node._passthrough:
            return False, "adaptive passthrough latched (per-row states)"
        all_exprs = [e for e, _ in node.group_exprs] + [a.operand for a in node.aggs]
        if has_scalar_subquery(*all_exprs):
            return False, ("scalar subquery in aggregate (job-specific "
                           "literal; program not shareable)")
        if exprs_sig(all_exprs) is None:
            return False, "aggregate has no serde signature (unsupported expression)"
    elif not isinstance(node, RenameExec):
        return False, f"{name} has no fused kernel builder"
    doubt = codegen_doubt(node)
    if doubt is not None:
        return False, f"no generated code for {name}: {doubt}"
    return True, None


def _split_runs(policy: CompilePolicy, chain) -> Tuple[List[List], List[Dict]]:
    """Split one detected chain (``(path, node)`` pairs, head first) into
    fusable runs under the allowlist.  An aggregate may only head a fused
    program (the kernel emits group states, not rows), so an allowed
    aggregate mid-walk closes the run above it and opens its own."""
    runs: List[List] = []
    rejected: List[Dict] = []
    cur: List = []

    def close():
        nonlocal cur
        if cur:
            runs.append(cur)
            cur = []

    for path, node in chain:
        ok, reason = _op_verdict(policy, node)
        if not ok:
            rejected.append({"op": type(node).__name__, "path": path, "reason": reason})
            close()
            continue
        if isinstance(node, HashAggregateExec) and cur:
            close()
        cur.append((path, node))
    close()
    return runs, rejected


def _splice(parent, head, fused) -> str:
    for attr in ("input", "left", "right"):
        if getattr(parent, attr, None) is head:
            setattr(parent, attr, fused)
            return attr
    raise PlanValidationError("", [
        f"cannot splice fused chain: {type(parent).__name__} does not "
        f"link to {type(head).__name__}"])


def fuse_stage(graph, stage) -> int:
    """Fuse the allowlisted chains of one resolved stage in place; returns
    the number of fused kernels installed."""
    policy = getattr(graph, "compiler", None)
    if policy is None or not policy.enabled:
        return 0
    plan = stage.resolved_plan
    if plan is None:
        return 0
    if getattr(stage, "_fused_attempt", None) == stage.stage_attempt:
        return 0  # this attempt's resolve already decided
    stage._fused_attempt = stage.stage_attempt

    by_path = dict(walk_plan_paths(plan))
    fused_count = 0
    records: List[dict] = []
    for chain in plan_chains(plan):
        runs, rejected = _split_runs(policy, chain)
        fused_runs: List[List[str]] = []
        for run in runs:
            if len(run) < policy.min_ops:
                rejected.append({
                    "op": type(run[0][1]).__name__, "path": run[0][0],
                    "reason": f"run of {len(run)} allowlisted operator(s) is shorter "
                              "than ballista.compile.min.ops"})
                continue
            ops = [node for _p, node in run]
            parent = by_path[run[0][0].rsplit(".", 1)[0]]
            _splice(parent, ops[0], FusedStageExec(ops))
            fused_count += 1
            fused_runs.append([type(o).__name__ for o in ops])
        records.append({
            "kind": "fusion",
            "stage_id": stage.stage_id,
            "stage_attempt": stage.stage_attempt,
            "operators": [type(n).__name__ for _p, n in chain],
            "paths": [p for p, _n in chain],
            "fused": bool(fused_runs),
            "fused_ops": fused_runs,
            "rejected": rejected,
            "donate": False,
        })
    for rec in records:
        stage.fusion_rewrites.append(rec)
        graph.compile_log.append(rec)
        if rec["fused"] and journal.enabled():
            journal.emit("stage.fused", job_id=graph.job_id, stage_id=stage.stage_id,
                         chains=rec["fused_ops"], donate=rec["donate"])
    return fused_count


def fuse_resolved_stages(graph) -> int:
    """Fuse every resolved, not-yet-launched stage (the leaf stages a fresh
    graph resolves during construction, before the scheduler installs the
    job's CompilePolicy)."""
    policy = getattr(graph, "compiler", None)
    if policy is None or not policy.enabled:
        return 0
    n = 0
    for stage in graph.stages.values():
        if stage.resolved_plan is None:
            continue
        if any(t is not None for t in stage.task_infos):
            continue  # tasks already launched from the interpreted plan
        n += fuse_stage(graph, stage)
    return n
