"""Chain detection for the whole-stage compiler.

Mirrors arrow_ballista_tpu/compile/chains.py: the walk over a live,
resolved stage plan that finds maximal single-child chains of operators
(``plan_chains``), the same walk over an EXPLAIN ANALYZE operator tree
(``dict_chains``, the fusion advisor's view in obs/advisor.py, so the
advisor ranks only chains the compiler considers), the operators that break
a chain (``UNFUSABLE``), the reasons recorded for chain members the
compiler leaves interpreted (``STATIC_REASONS``) and a chain's structural
fingerprint.
"""
from __future__ import annotations

import hashlib
from typing import Callable, Dict, List, Optional, Tuple

#: Operators that can never join a fused program: their execute crosses the
#: device boundary (shuffle materialization) or is another stage's output.
#: A chain breaks at them.
UNFUSABLE = {
    "ShuffleWriterExec", "ShuffleReaderExec", "UnresolvedShuffleExec",
}

#: Why the compiler leaves a chain member interpreted even though the
#: chain-walk included it.  Keyed by operator class name; best-effort
#: (exact reasons come from the fuse-time verdicts the stage records).
STATIC_REASONS = {
    "ParquetScanExec": "scan (IO-bound input producer feeds the fused kernel)",
    "MemoryScanExec": "scan (IO-bound input producer feeds the fused kernel)",
    "CsvScanExec": "scan (IO-bound input producer feeds the fused kernel)",
    "JsonScanExec": "scan (IO-bound input producer feeds the fused kernel)",
    "AvroScanExec": "scan (IO-bound input producer feeds the fused kernel)",
    "SortExec": "sort (data-dependent ordering)",
    "LimitExec": "limit (cross-batch row budget is host-side state)",
    "CoalescePartitionsExec": "coalesce (multi-partition gather)",
    "JoinExec": "join (multi-child operator)",
    "FusedStageExec": "already fused",
}


def _generic_chains(items: List[object], path_of: Callable[[object], str],
                    fusable: Callable[[object], bool]) -> List[List[object]]:
    """Maximal single-child chains over a pre-order item list whose dotted
    paths encode the tree (``a.b`` is a child of ``a``).  A chain is a run
    of fusable items where each has exactly one child, itself fusable."""
    children: Dict[str, List[object]] = {}
    for it in items:
        p = path_of(it)
        if "." in p:
            children.setdefault(p.rsplit(".", 1)[0], []).append(it)

    def single_child(it) -> Optional[object]:
        ch = children.get(path_of(it), ())
        return ch[0] if len(ch) == 1 else None

    chains: List[List[object]] = []
    consumed = set()
    for it in items:  # pre-order: chain heads come first
        if path_of(it) in consumed or not fusable(it):
            continue
        chain = [it]
        nxt = single_child(it)
        while nxt is not None and fusable(nxt):
            chain.append(nxt)
            nxt = single_child(nxt)
        if len(chain) > 1:
            chains.append(chain)
            consumed.update(path_of(c) for c in chain)
    return chains


def dict_chains(tree: List[Dict]) -> List[List[Dict]]:
    """Chains over an EXPLAIN ANALYZE ``operator_tree`` (the advisor's
    view: dicts with ``path``/``op`` keys)."""
    return _generic_chains(
        tree, lambda op: op["path"], lambda op: op["op"] not in UNFUSABLE)


def walk_plan_paths(plan) -> List[Tuple[str, object]]:
    """Pre-order ``(path, node)`` walk of a live stage plan with the
    executor-side metric path convention ("0", "0.0", ... — the keys of
    execution_engine.collect_plan_metrics), stopping below shuffle readers
    (other stages' territory)."""
    out: List[Tuple[str, object]] = []

    def walk(node, path):
        out.append((path, node))
        if type(node).__name__ in ("ShuffleReaderExec",
                                   "UnresolvedShuffleExec"):
            return
        for i, c in enumerate(node.children()):
            walk(c, f"{path}.{i}")

    walk(plan, "0")
    return out


def plan_chains(plan) -> List[List[Tuple[str, object]]]:
    """Chains over a live resolved stage plan (the compiler's view):
    lists of ``(path, node)`` pairs, head (closest to the shuffle writer)
    first, same semantics as :func:`dict_chains`."""
    items = walk_plan_paths(plan)
    return _generic_chains(
        items, lambda it: it[0],
        lambda it: type(it[1]).__name__ not in UNFUSABLE)


def chain_fingerprint(ops: List[object], input_schema_sig: tuple) -> str:
    """Structural digest of a fused chain, the key of its shared program:
    public attributes only (underscore-prefixed lazy state skipped),
    recursion cut at the chain's input edge.  Two jobs with the same chain
    over the same input schema fingerprint identically, so a repeated query
    reuses the traced closures and the built kernel."""
    out: List[str] = []

    def value(v):
        from ..ops.physical import ExecutionPlan

        if isinstance(v, ExecutionPlan):
            out.append("<input>")  # cut: the subtree below is not fused
            return
        if isinstance(v, dict):
            out.append("{")
            for k in sorted(v, key=str):
                out.append(str(k))
                value(v[k])
            out.append("}")
            return
        if isinstance(v, (list, tuple)):
            out.append("[")
            for x in v:
                value(x)
            out.append("]")
            return
        out.append(repr(v) if isinstance(v, (str, int, float, bool,
                                             type(None))) else str(v))

    for node in ops:
        out.append(type(node).__name__)
        for k in sorted(vars(node)):
            if k.startswith("_"):
                continue  # lazy runtime state (compiled closures, caches)
            out.append(k)
            value(vars(node)[k])
    out.append(repr(input_schema_sig))
    return hashlib.sha1("\x1f".join(out).encode()).hexdigest()
