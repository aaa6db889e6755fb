"""Logical plan -> physical plan with exchange (repartition) insertion.

Mirrors arrow_ballista_tpu/scheduler/physical_planner.py for the operators
this package has: scans of in-memory tables and parquet files (filters
pushed into the scan), projection, filter, grouped aggregation (partial ->
hash repartition -> final, with the clustered early-HAVING rewrite over
key-clustered parquet), joins (broadcast or partitioned, inner chains
reordered by estimated build size), sort and limit; with
``ballista.shuffle.mesh`` on, aggregate and join stage pairs fused over the
rank mesh (ops/mesh_exec.py).

Projections producing float64 (division) run host-side, as in the
reference.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from ..catalog import SchemaCatalog
from ..models import expr as E
from ..models import logical as L
from ..ops import operators as O
from ..ops.physical import ExecutionPlan, Partitioning
from ..ops.shuffle import RepartitionExec
from ..utils.config import (BROADCAST_THRESHOLD, MESH_HYBRID, MESH_MIN_ROWS, MESH_SHUFFLE,
                            BallistaConfig, resolve_task_budget)
from ..utils.errors import PlanningError


def _has_float_subexpr(e: E.Expr, schema) -> bool:
    """True if any subexpression is float-typed: such predicates run
    host-side."""
    try:
        if e.dtype(schema).kind in ("float32", "float64"):
            return True
    except Exception:  # noqa: BLE001 — untypable nodes (subquery carriers)
        pass
    return any(_has_float_subexpr(c, schema) for c in e.children())


@dataclasses.dataclass
class PlannedQuery:
    plan: ExecutionPlan
    # scalar subqueries to execute before the main job: (scalar_id, plan)
    scalars: List[Tuple[str, ExecutionPlan]]


def explain_rows(catalog, config, statement, device=None, verbose: bool = False):
    """DataFusion-shaped EXPLAIN rows (logical and physical plan);
    ``verbose`` adds the distributed stage decomposition (the exchange
    boundaries the DistributedPlanner splits at)."""
    from ..sql.optimizer import optimize
    from ..sql.planner import SqlToRel

    optimized = optimize(SqlToRel(catalog).plan(statement))
    planned = PhysicalPlanner(catalog, config, device).plan_query(optimized)
    rows = [
        {"plan_type": "logical_plan", "plan": optimized.display()},
        {"plan_type": "physical_plan", "plan": planned.plan.display()},
    ]
    if verbose:
        from .planner import DistributedPlanner

        stages = DistributedPlanner().plan_query_stages("explain", planned.plan)
        text = "\n".join(f"Stage {s.stage_id}:\n{s.plan.display(1)}" for s in stages)
        rows.append({"plan_type": "distributed_plan", "plan": text})
    return rows


class PhysicalPlanner:
    def __init__(self, catalog: SchemaCatalog, config: BallistaConfig, device=None):
        import torch

        from ..client.context import resolve_device

        self.catalog = catalog
        self.config = config
        # None: the card (raises without one); a named device is taken as is
        self.device = resolve_device() if device is None else torch.device(device)
        self._scalars: List[Tuple[str, ExecutionPlan]] = []
        self._scalar_seq = 0
        self._partitions: Optional[int] = None

    @property
    def partitions(self) -> int:
        """Effective shuffle partition count ('auto' (0) derives it from
        the largest scanned table)."""
        if self._partitions is None:
            self._partitions = self.config.shuffle_partitions or 8
        return self._partitions

    def _resolve_auto_partitions(self, logical: L.LogicalPlan) -> None:
        if self.config.shuffle_partitions != 0:
            self._partitions = self.config.shuffle_partitions
            return
        target = max(1, self.config.batch_size)
        rows = 0
        row_bytes = 0

        def walk(node: L.LogicalPlan):
            nonlocal rows, row_bytes
            if isinstance(node, L.TableScan):
                rc = self.catalog.provider(node.table).row_count()
                if (rc or 0) > rows:
                    rows = rc or 0
                    row_bytes = node.schema.row_byte_width()
            for c in node.children():
                walk(c)

        walk(logical)
        if not rows:
            self._partitions = 8
            return
        base = max(1, -(-rows // target))
        budget = resolve_task_budget(self.config, self.device.type == "cuda")
        if budget:
            need = -(-rows * row_bytes // budget)
            self._partitions = min(256, max(min(64, base), need, 1))
        else:
            self._partitions = min(64, base)

    # --- entry ----------------------------------------------------------
    def plan_query(self, logical: L.LogicalPlan) -> PlannedQuery:
        self._scalars = []
        self._resolve_auto_partitions(logical)
        plan = self.create(logical)
        self._clustered_having_pushdown(plan)
        for _sid, sub in self._scalars:
            self._clustered_having_pushdown(sub)
        return PlannedQuery(plan, list(self._scalars))

    def create(self, node: L.LogicalPlan) -> ExecutionPlan:
        if isinstance(node, L.TableScan):
            provider = self.catalog.provider(node.table)
            filters = [self._prep_expr(f) for f in node.filters]
            return provider.scan(node.projection, filters, self.partitions)

        if isinstance(node, L.SubqueryAlias):
            child = self.create(node.input)
            return O.RenameExec(child, node.schema)

        if isinstance(node, L.Projection):
            child = self.create(node.input)
            exprs = [(self._prep_expr(e), n) for e, n in node.exprs]
            host = any(e.dtype(child.schema).kind == "float64" for e, _ in exprs)
            return O.ProjectionExec(child, exprs, host_mode=host)

        if isinstance(node, L.Filter):
            child = self.create(node.input)
            pred = self._prep_expr(node.predicate)
            return O.FilterExec(child, pred, host_mode=_has_float_subexpr(pred, child.schema))

        if isinstance(node, L.Aggregate):
            return self._plan_aggregate(node)

        if isinstance(node, L.Distinct):
            child_logical = node.input
            groups = [(E.Column(f.name), f.name) for f in child_logical.schema]
            agg = L.Aggregate(child_logical, groups, [])
            return self._plan_aggregate(agg)

        if isinstance(node, L.Join):
            return self._plan_join(node)

        if isinstance(node, L.CrossJoin):
            raise PlanningError("cross joins are not supported yet")

        if isinstance(node, L.Sort):
            child = self.create(node.input)
            child = self._to_single_partition(child)
            keys = [(self._prep_expr(e), asc) for e, asc in node.keys]
            return O.SortExec(child, keys)

        if isinstance(node, L.Limit):
            if isinstance(node.input, L.Sort):
                child = self.create(node.input.input)
                child = self._to_single_partition(child)
                keys = [(self._prep_expr(e), asc) for e, asc in node.input.keys]
                return O.SortExec(child, keys, fetch=node.n)
            child = self.create(node.input)
            return O.LimitExec(child, node.n)

        raise PlanningError(f"cannot create physical plan for {type(node).__name__}")

    # --- pieces ---------------------------------------------------------
    def _prep_expr(self, e: E.Expr) -> E.Expr:
        """Assign stable ids to scalar subqueries and plan them."""
        if isinstance(e, E.ScalarSubquery):
            sid = getattr(e, "scalar_id", None)
            if sid is None:
                sid = f"sq{self._scalar_seq}"
                self._scalar_seq += 1
                object.__setattr__(e, "scalar_id", sid)
                sub_physical = self.create(e.plan)
                sub_physical = self._to_single_partition(sub_physical)
                self._scalars.append((sid, sub_physical))
            return e
        from ..sql.planner import _map_children

        return _map_children(e, self._prep_expr)

    def _to_single_partition(self, plan: ExecutionPlan) -> ExecutionPlan:
        if plan.output_partition_count() <= 1:
            return plan
        return RepartitionExec(plan, Partitioning.single())

    def _plan_aggregate(self, node: L.Aggregate) -> ExecutionPlan:
        node = self._rewrite_distinct_aggs(node)
        child = self.create(node.input)
        groups = [(self._prep_expr(e), n) for e, n in node.group_exprs]
        specs = []
        for a, n in node.agg_exprs:
            if a.distinct:
                raise PlanningError("DISTINCT aggregates not supported yet")
            operand = self._prep_expr(a.operand) if a.operand is not None else None
            specs.append(O.AggSpec(a.func, operand, n))

        if child.output_partition_count() <= 1:
            return O.HashAggregateExec(child, groups, specs, mode="single")

        # the mesh path: partial agg -> exchange -> final agg fused over the
        # ranks of the mesh (ops/mesh_exec.py) instead of a file-shuffle
        # stage pair.  Hybrid mode keeps the stage pair and meshes only the
        # per-task partial.  Small exchanges stay on the file path unless
        # min_rows is 0, gated on the estimates the broadcast decision uses
        if self.config.get(MESH_SHUFFLE) and (
                self.config.get(MESH_HYBRID)
                or self._mesh_worthwhile(self._estimate_rows(node.input))):
            from ..ops.mesh_exec import MeshAggregateExec, MeshPartialAggregateExec

            if MeshAggregateExec.eligible(groups, specs, child.schema):
                if self.config.get(MESH_HYBRID):
                    # eligible() guarantees non-empty groups here
                    partial = MeshPartialAggregateExec(child, groups, specs)
                    key_exprs = tuple(E.Column(n) for _, n in groups)
                    exchange = RepartitionExec(partial,
                                               Partitioning.hash(key_exprs, self.partitions))
                    final_groups = [(E.Column(n), n) for _, n in groups]
                    return O.HashAggregateExec(exchange, final_groups, specs, mode="final")
                return MeshAggregateExec(child, groups, specs)

        partial = O.HashAggregateExec(child, groups, specs, mode="partial")
        if groups:
            key_exprs = tuple(E.Column(n) for _, n in groups)
            exchange = RepartitionExec(partial, Partitioning.hash(key_exprs, self.partitions))
        else:
            exchange = RepartitionExec(partial, Partitioning.single())
        final_groups = [(E.Column(n), n) for _, n in groups]
        return O.HashAggregateExec(exchange, final_groups, specs, mode="final")

    def _rewrite_distinct_aggs(self, node: L.Aggregate) -> L.Aggregate:
        """agg(distinct x) -> dedup-by-(groups, x) aggregate feeding a plain
        aggregate (the classic two-level rewrite)."""
        distincts = [(a, n) for a, n in node.agg_exprs if a.distinct]
        if not distincts:
            return node
        if len(distincts) != len(node.agg_exprs):
            raise PlanningError("mixing DISTINCT and plain aggregates is not supported")
        operands = {str(a.operand) for a, _ in distincts}
        if len(operands) != 1 or distincts[0][0].operand is None:
            raise PlanningError("DISTINCT aggregates must share one operand")
        dkey = "__distinct_key"
        inner_groups = list(node.group_exprs) + [(distincts[0][0].operand, dkey)]
        inner = L.Aggregate(node.input, inner_groups, [])
        outer_groups = [(E.Column(n), n) for _, n in node.group_exprs]
        outer_aggs = [(E.Agg(a.func, E.Column(dkey)), n) for a, n in distincts]
        return L.Aggregate(inner, outer_groups, outer_aggs)

    def _reorder_inner_chain(self, node: L.Join) -> L.Join:
        """Reorder a left-deep chain of INNER equi-joins so the most
        selective builds apply first (greedy ascending build-size estimate,
        subject to key-column availability).  Inner joins commute; applying
        a small filtered dimension first cuts the probe early."""
        chain = []  # (right, on, filter) from the top down
        cur: L.LogicalPlan = node
        while isinstance(cur, L.Join) and cur.join_type == "inner" and cur.on:
            chain.append((cur.right, cur.on, cur.filter))
            cur = cur.left
        if len(chain) < 2:
            return node
        base = cur
        chain.reverse()  # original application order

        def deps(on, filt, right_names):
            refs = set()
            for le, _re in on:
                refs |= le.column_refs()
            if filt is not None:
                refs |= filt.column_refs() - right_names
            return refs

        items = []
        for right, on, filt in chain:
            rnames = {f.name for f in right.schema}
            items.append({"right": right, "on": on, "filter": filt, "names": rnames,
                          "deps": deps(on, filt, rnames), "est": self._estimate_rows(right)})
        available = {f.name for f in base.schema}
        order = []
        remaining = list(items)
        while remaining:
            ready = [it for it in remaining if it["deps"] <= available]
            if not ready:
                return node  # a cross-dependency not modelled: keep SQL order
            pick = min(ready, key=lambda it: it["est"])
            order.append(pick)
            available |= pick["names"]
            remaining.remove(pick)
        # identity comparison: logical nodes are field-less dataclasses whose
        # generated __eq__ calls every instance equal
        if all(a["right"] is b["right"] for a, b in zip(order, items)):
            return node
        out: L.LogicalPlan = base
        for it in order:
            out = L.Join(out, it["right"], it["on"], "inner", it["filter"])
        return out

    def _plan_join(self, node: L.Join) -> ExecutionPlan:
        if node.join_type == "inner":
            node = self._reorder_inner_chain(node)
        left = self.create(node.left)
        right = self.create(node.right)
        on = [(self._prep_expr(l), self._prep_expr(r)) for l, r in node.on]
        filt = self._prep_expr(node.filter) if node.filter is not None else None

        # side ordering (inner joins are symmetric): when either side fits
        # the broadcast threshold, the SMALLER side becomes the build
        # (right), so the big probe side streams with no repartition
        left_est = self._estimate_rows(node.left)
        right_est = self._estimate_rows(node.right)
        threshold = self.config.get(BROADCAST_THRESHOLD)
        if node.join_type == "inner" and min(left_est, right_est) <= threshold \
                and left_est < right_est:
            left, right = right, left
            on = [(r, l) for l, r in on]
            left_est, right_est = right_est, left_est

        if node.join_type != "full" and right_est <= threshold:
            # full joins cannot broadcast: unmatched build rows would be
            # emitted once per probe partition
            right_bc = self._to_single_partition(right)
            return O.JoinExec(left, right_bc, on, node.join_type, filt, dist="broadcast")

        # the mesh path: both hash repartitions and the join fused over the
        # ranks of the mesh (ops/mesh_exec.py MeshJoinExec); hybrid mode
        # keeps the partitioned stage structure and meshes only the
        # per-task join
        if self.config.get(MESH_SHUFFLE) and not self.config.get(MESH_HYBRID) \
                and self._mesh_worthwhile(left_est + right_est):
            from ..ops.mesh_exec import MeshJoinExec

            if MeshJoinExec.eligible(on, node.join_type, filt, left.schema, right.schema):
                return MeshJoinExec(left, right, on, node.join_type)

        p = self.partitions
        lpart = RepartitionExec(left, Partitioning.hash(tuple(l for l, _ in on), p))
        rpart = RepartitionExec(right, Partitioning.hash(tuple(r for _, r in on), p))
        if self.config.get(MESH_SHUFFLE) and self.config.get(MESH_HYBRID):
            from ..ops.mesh_exec import MeshTaskJoinExec

            if MeshTaskJoinExec.eligible(on, node.join_type, filt, left.schema, right.schema):
                return MeshTaskJoinExec(lpart, rpart, on, node.join_type)
        return O.JoinExec(lpart, rpart, on, node.join_type, filt, dist="partitioned")

    def _clustered_having_pushdown(self, plan: ExecutionPlan) -> None:
        """Clustered group-by early-HAVING rewrite.

        Pattern: Filter(pred) <- HashAgg(final) <- Repartition(hash keys)
        <- HashAgg(partial) <- Rename* <- ParquetScan, with ONE int group
        key whose parquet row-group statistics prove the data clustered on
        it.  A partial aggregate over a contiguous partition is then final
        for every key outside the overlap windows of neighbouring
        partitions, so the HAVING predicate applies in the task and the
        exchange ships only survivors and window keys.  Without a HAVING
        (or where it cannot be pushed) the partial still groups without a
        sort (the presorted-only form)."""
        from ..ops.physical import ParquetScanExec, has_scalar_subquery

        def annotate(agg_p, pred) -> bool:
            """Mark a partial aggregate clustered if eligible.  ``pred``:
            the downstream HAVING predicate (early-filter form) or None
            (presorted-only form)."""
            if len(agg_p.group_exprs) != 1:
                return False
            ge, _gname = agg_p.group_exprs[0]
            if not isinstance(ge, E.Column):
                return False
            if any(a.func not in ("sum", "count", "min", "max") for a in agg_p.aggs):
                return False
            if pred is not None:
                if has_scalar_subquery(pred):
                    return False
                if not pred.column_refs() <= set(agg_p.schema.names()):
                    return False
            # resolve the group key through renames down to the scan column
            child, col = agg_p.input, ge.name
            while isinstance(child, O.RenameExec):
                rev = {new: old for old, new in child._mapping}
                if col not in rev:
                    return False
                col = rev[col]
                child = child.input
            if not isinstance(child, ParquetScanExec):
                return False
            if col not in child.schema or \
                    child.schema.field(col).dtype.np_dtype.kind not in "iu":
                return False
            probe = child.clustered_ranges(col)
            if probe is None:
                return False
            groups, ranges = probe
            if not ranges or len(ranges) <= 1:
                # a rejected probe leaves the scan untouched (the regroup
                # would have collapsed its partitions)
                return False
            intervals = [(lo_b, hi_a)
                         for (_lo_a, hi_a), (lo_b, _hi_b) in zip(ranges, ranges[1:])
                         if lo_b <= hi_a]
            field = child.schema.field(col)
            if field.nullable:
                # NULL keys ride the in-band sentinel, which parquet min/max
                # statistics exclude: NULL-group partials can split across
                # partitions, so the sentinel always ships
                sent = int(field.dtype.null_sentinel)
                intervals.append((sent, sent))
            # accepted: commit the contiguous regroup, and carry the declared
            # per-partition key ranges so the runtime can detect stale stats
            child.groups = groups
            agg_p.clustered = (pred, intervals, [tuple(r) for r in ranges])
            return True

        def walk(node):
            for c in node.children():
                walk(c)
            if isinstance(node, O.HashAggregateExec) and node.mode == "partial" \
                    and node.clustered is None:
                annotate(node, None)  # presorted-only; upgraded below
                return
            if not isinstance(node, O.FilterExec) or node.host_mode:
                return
            agg_f = node.input
            if not isinstance(agg_f, O.HashAggregateExec) or agg_f.mode != "final":
                return
            rep = agg_f.input
            if not isinstance(rep, RepartitionExec):
                return
            agg_p = rep.input
            if not isinstance(agg_p, O.HashAggregateExec) or agg_p.mode != "partial":
                return
            cl = agg_p.clustered
            if cl is not None and cl[0] is not None:
                return  # already carries an early-HAVING annotation
            # upgrade a presorted-only annotation to the early-HAVING form
            agg_p.clustered = None
            if not annotate(agg_p, node.predicate):
                agg_p.clustered = cl  # keep the presorted-only form if any

        walk(plan)

    def _mesh_worthwhile(self, est_rows: int) -> bool:
        """The adaptive transport choice per exchange: the mesh only for an
        estimated input of at least ``ballista.shuffle.mesh.min_rows`` rows
        (0 disables the gate: always the mesh)."""
        floor = self.config.get(MESH_MIN_ROWS)
        return floor <= 0 or est_rows >= floor

    def _estimate_rows(self, node: L.LogicalPlan) -> int:
        if isinstance(node, L.TableScan):
            n = self.catalog.provider(node.table).row_count()
            est = n if n is not None else 10_000_000
            return max(1, est // (4 if node.filters else 1))
        if isinstance(node, L.Filter):
            if isinstance(node.input, L.Aggregate):
                # HAVING over an aggregate is selective by design
                return max(1, self._estimate_rows(node.input) // 100)
            return max(1, self._estimate_rows(node.input) // 4)
        if isinstance(node, (L.Projection, L.SubqueryAlias, L.Sort)):
            return self._estimate_rows(node.input)
        if isinstance(node, L.Limit):
            return node.n
        if isinstance(node, L.Aggregate):
            return max(1, self._estimate_rows(node.input) // 8)
        if isinstance(node, L.Distinct):
            return self._estimate_rows(node.input)
        if isinstance(node, L.Join):
            if node.join_type == "semi":
                # bounded by the left side; 1% match selectivity is the
                # working guess for IN/EXISTS over selective subqueries
                return max(1, self._estimate_rows(node.left) // 100)
            if node.join_type == "anti":
                return self._estimate_rows(node.left)
            if node.join_type == "full":
                return self._estimate_rows(node.left) + self._estimate_rows(node.right)
            # inner/left equi-joins in analytic schemas are key-FK: trust the
            # small side only when it is decisively small (a quarter of the
            # broadcast threshold), else the larger side
            left_e = self._estimate_rows(node.left)
            right_e = self._estimate_rows(node.right)
            decisive = self.config.get(BROADCAST_THRESHOLD) // 4
            est = max(left_e, right_e)
            if min(left_e, right_e) <= decisive:
                est = min(left_e, right_e)
            if node.join_type == "left":
                # every left row is emitted at least once
                est = max(est, left_e)
            return est
        if isinstance(node, L.CrossJoin):
            return self._estimate_rows(node.left) * self._estimate_rows(node.right)
        return 10_000_000
