"""Physical operators of the slice: projection, rename, filter, grouped
aggregate, join, sort, limit, coalesce.

Mirrors arrow_ballista_tpu/ops/operators.py.  Each operator works on
fixed-capacity batches with liveness masks.  The grouped aggregate runs K1
(ops/kernels.dense_group_states) on a dense key domain, K2 + K9 + K8 (the
presorted path) on a key-clustered parquet scan, with K10 and K11 for the
early HAVING, and K4 + K8 (the sort path) otherwise; the join K3 + K5
(build), K3 + K6 (probe) and K7 (semi/anti/outer verdicts); the sort K4;
compaction K2.  A partial aggregate that barely reduces a large input
latches the adaptive passthrough: sibling tasks emit per-row states through
K15, a kernel generated per aggregate (compile/fused.py).  Under the memory
governor (memory/) an aggregate or a partitioned inner/semi/anti join whose
reservation is denied spills to Arrow IPC runs on disk; the spilled join
splits its build side by K16's hash partitions.
"""
from __future__ import annotations

import dataclasses
import threading
import weakref
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..models import expr as E
from ..models.batch import ColumnBatch, concat_batches, round_capacity, upload
from ..models.logical import expr_nullable as _expr_nullable
from ..models.schema import BOOL, DataType, Field, INT64, Schema
from ..utils.config import JOIN_MAX_CAPACITY, resolve_task_budget
from ..utils.errors import CapacityError, InternalError
from . import kernels as K
from .kernels import to_host
from .expressions import Compiled, ExprCompiler
from .physical import (ExecutionPlan, Partitioning, TaskContext, deferred_count, deferred_rows,
                       exprs_sig, has_scalar_subquery, schema_sig, shared_program)


# job-keyed weakref registry of join operators holding a materialized
# broadcast build side; the local context clears a job's entries when the
# job ends, so a plan kept for inspection does not pin the build table
_build_cache_registry: Dict[str, list] = {}
_build_cache_lock = threading.Lock()


def _register_build_cache(job_id: str, op) -> None:
    with _build_cache_lock:
        _build_cache_registry.setdefault(job_id, []).append(weakref.ref(op))


def clear_job_build_caches(job_id: str) -> None:
    """Drop materialized broadcast build sides cached for ``job_id``."""
    with _build_cache_lock:
        refs = _build_cache_registry.pop(job_id, [])
    for r in refs:
        op = r()
        if op is None:
            continue
        with op.build_lock():
            cached = getattr(op, "_build_cache", None)
            if cached is not None and cached[0] == job_id:
                op._build_cache = None
            pc = getattr(op, "_prep_cache", None)
            if pc is not None and pc[0] == job_id:
                op._prep_cache = None


def _substitute_scalars(e: E.Expr, scalars: Dict[str, object]) -> E.Expr:
    """Replace ScalarSubquery placeholders with literal values computed
    before the main plan runs (ctx.scalars keyed by scalar id)."""
    if isinstance(e, E.ScalarSubquery):
        key = getattr(e, "scalar_id", None) or id(e.plan)
        if key not in scalars:
            raise InternalError("scalar subquery value missing at execution time")
        v = scalars[key]
        dt = getattr(e, "scalar_dtype", None)
        if dt is None:
            dt = e.plan.schema.fields[0].dtype
        if dt.is_decimal:
            # value arrives as raw scaled int -> keep exact by re-scaling to float
            return E.Lit(v / (10 ** dt.scale) if isinstance(v, int) else v)
        return E.Lit(v)
    from ..sql.planner import _map_children

    return _map_children(e, lambda c: _substitute_scalars(c, scalars))


def _null_transparent(e: E.Expr) -> bool:
    """True when NULL inputs imply a NULL output (plain columns, arithmetic,
    casts).  IS NULL and CASE can launder NULLs into real values."""
    if isinstance(e, (E.IsNull, E.Case)):
        return False
    return all(_null_transparent(c) for c in e.children())


def null_check_of(cc, operand, in_schema: Schema):
    """Value-based NULL test spec for an aggregate operand: None when no
    nullable column feeds the operand; else 'string' (dict code < 0) or the
    computed dtype's in-band sentinel."""
    if cc is None or operand is None:
        return None
    refs_nullable = any(n in in_schema and in_schema.field(n).nullable
                        for n in operand.column_refs())
    if not refs_nullable:
        return None
    return "string" if cc.dtype.is_string else cc.dtype.null_sentinel


def valid_of(v, null_check, xp=torch):
    """Per-row validity under a ``null_check_of`` spec (``xp``: torch, or
    an expression namespace)."""
    if null_check == "string":
        return v >= 0
    if isinstance(null_check, float) and null_check != null_check:  # NaN
        return ~xp.isnan(v)
    return v != _py_scalar(null_check)


def _py_scalar(v):
    """numpy scalars (schema sentinels) as Python numbers for torch ops."""
    return v.item() if isinstance(v, np.generic) else v


def _full_column(v: torch.Tensor, n: int) -> torch.Tensor:
    """Literal operands compile to 0-d tensors; operators work per row."""
    return v.expand(n) if v.dim() == 0 else v


class ProjectionExec(ExecutionPlan):
    """Computes output columns; ``host_mode`` runs in numpy float64 (tiny
    post-aggregation projections containing division)."""

    def __init__(self, input: ExecutionPlan, exprs: List[Tuple[E.Expr, str]],
                 host_mode: bool = False):
        self.input = input
        self.exprs = exprs
        self.host_mode = host_mode
        in_schema = input.schema
        self._schema = Schema(
            Field(n, e.dtype(in_schema), _expr_nullable(e, in_schema)) for e, n in exprs)
        self._compiled = None

    def children(self):
        return [self.input]

    def output_partition_count(self):
        return self.input.output_partition_count()

    def output_partitioning(self):
        return self.input.output_partitioning()

    def _compile(self, scalars, device, xp=None):
        comp = ExprCompiler(self.input.schema, "host" if self.host_mode else "device", device,
                            xp=xp)
        xp = comp.xp
        compiled = []
        for e, n in self.exprs:
            c = comp.compile(_substitute_scalars(e, scalars))
            # NULL propagation: non-bool, non-string outputs re-assert the
            # output dtype's sentinel wherever a nullable input holds its own
            out_f = self._schema.field(n)
            if out_f.nullable and _null_transparent(e) \
                    and not c.dtype.is_string and c.dtype.kind != "bool":
                valid = comp.validity_fn(comp.nullable_refs(e))
                if valid is not None:
                    sent = xp.asarray(out_f.dtype.null_sentinel, dtype=out_f.dtype.np_dtype)
                    c = Compiled(
                        lambda cols, a, f=c.fn, v=valid, s=sent: xp.where(
                            v(cols, a), f(cols, a), s),
                        c.dtype, c.dict_fn, c.lit_value)
            compiled.append((c, n))
        return comp, compiled

    def execute(self, partition: int, ctx: TaskContext) -> List[ColumnBatch]:
        with ctx.op_span(self):
            return self._execute(partition, ctx)

    def _program(self, ctx: TaskContext):
        """(compiler, closures) in host mode; on the device the projection's
        K19 column program."""
        from ..compile.programs import OperatorProgram

        if self.host_mode:
            return self._compile(ctx.scalars, ctx.device)

        def build(xp, dev):
            comp, compiled = self._compile(ctx.scalars, dev, xp=xp)

            def body(_xp, cols, mask, auxs):
                n = mask.shape[0]
                return [(name, _full_column(c.fn(cols, auxs[0]), n)) for c, name in compiled]

            return [comp], body, compiled

        return OperatorProgram("columns", "projection", self.input.schema, build, ctx.device)

    def _prepared(self, ctx: TaskContext):
        with self.build_lock():
            if self._compiled is None:
                if has_scalar_subquery(*[e for e, _ in self.exprs]):
                    self._compiled = self._program(ctx)
                else:
                    self._compiled = shared_program(
                        ("proj", self.host_mode, str(ctx.device),
                         schema_sig(self.input.schema),
                         tuple(n for _, n in self.exprs),
                         exprs_sig([e for e, _ in self.exprs])),
                        lambda: self._program(ctx))
            return self._compiled

    def device_programs(self, ctx: TaskContext):
        return [] if self.host_mode else [self._prepared(ctx)]

    def _execute(self, partition: int, ctx: TaskContext) -> List[ColumnBatch]:
        from ..compile.programs import operator_program

        prog = self._prepared(ctx)
        out = []
        for b in self.input.execute(partition, ctx):
            with self.metrics().timer("compute_time"):
                if self.host_mode:
                    comp, compiled = prog
                    dicts = {n: c.dict_fn(b.dicts) for c, n in compiled
                             if c.dict_fn is not None}
                    aux = comp.aux_arrays(b.dicts)
                    cols_np = {k: K.to_host(v) for k, v in b.columns.items()}
                    with np.errstate(divide="ignore", invalid="ignore"):
                        new_np = [np.broadcast_to(np.asarray(c.fn(cols_np, aux)), (b.capacity,))
                                  for c, _ in compiled]
                    tensors = upload(new_np, b.device)
                    new_cols = {n: t for (_, n), t in zip(compiled, tensors)}
                else:
                    dicts = {n: c.dict_fn(b.dicts) for c, n in prog.extra
                             if c.dict_fn is not None}
                    new_cols = operator_program(prog, b.columns, b.mask,
                                                prog.aux_arrays(b.dicts))
                out.append(ColumnBatch(self._schema, new_cols, b.mask, dicts))
        return out

    def _label(self):
        mode = " (host)" if self.host_mode else ""
        return "ProjectionExec" + mode + ": " + ", ".join(n for _, n in self.exprs)


class RenameExec(ExecutionPlan):
    """Zero-cost column rename (alias qualification): rewraps batches with a
    new schema; no device work."""

    def __init__(self, input: ExecutionPlan, schema: Schema):
        if len(schema) != len(input.schema):
            raise InternalError("rename schema arity mismatch")
        self.input = input
        self._schema = schema
        self._mapping = list(zip(input.schema.names(), schema.names()))

    def children(self):
        return [self.input]

    def output_partition_count(self):
        return self.input.output_partition_count()

    def output_partitioning(self):
        return self.input.output_partitioning()

    def execute(self, partition: int, ctx: TaskContext) -> List[ColumnBatch]:
        with ctx.op_span(self):
            out = []
            for b in self.input.execute(partition, ctx):
                cols = {new: b.columns[old] for old, new in self._mapping}
                dicts = {new: b.dicts[old] for old, new in self._mapping if old in b.dicts}
                out.append(ColumnBatch(self._schema, cols, b.mask, dicts, b._num_rows))
            return out

    def _label(self):
        return "RenameExec: " + ", ".join(n for n in self._schema.names())


class FilterExec(ExecutionPlan):
    """``host_mode`` evaluates the predicate in numpy float64 — used when
    the predicate contains float arithmetic."""

    def __init__(self, input: ExecutionPlan, predicate: E.Expr, host_mode: bool = False):
        self.input = input
        self.predicate = predicate
        self.host_mode = host_mode
        self._schema = input.schema
        self._compiled = None

    def children(self):
        return [self.input]

    def output_partition_count(self):
        return self.input.output_partition_count()

    def output_partitioning(self):
        return self.input.output_partitioning()

    def execute(self, partition: int, ctx: TaskContext) -> List[ColumnBatch]:
        with ctx.op_span(self):
            return self._execute(partition, ctx)

    def _program(self, ctx: TaskContext):
        """(compiler, predicate) in host mode; on the device the filter's
        K19 mask program."""
        from ..compile.programs import mask_program

        if self.host_mode:
            return self._compile(ctx.scalars, ctx.device)
        return mask_program("filter", self.input.schema,
                            lambda xp, dev: self._compile(ctx.scalars, dev, xp=xp), ctx.device)

    def _prepared(self, ctx: TaskContext):
        with self.build_lock():
            if self._compiled is None:
                if has_scalar_subquery(self.predicate):
                    self._compiled = self._program(ctx)
                else:
                    self._compiled = shared_program(
                        ("filter", self.host_mode, str(ctx.device),
                         schema_sig(self.input.schema), exprs_sig([self.predicate])),
                        lambda: self._program(ctx))
            return self._compiled

    def device_programs(self, ctx: TaskContext):
        return [] if self.host_mode else [self._prepared(ctx)]

    def _execute(self, partition: int, ctx: TaskContext) -> List[ColumnBatch]:
        from ..compile.programs import operator_program

        prog = self._prepared(ctx)
        out = []
        for b in self.input.execute(partition, ctx):
            with self.metrics().timer("compute_time"):
                if self.host_mode:
                    comp, pred = prog
                    aux = comp.aux_arrays(b.dicts)
                    cols_np = {k: K.to_host(v) for k, v in b.columns.items()}
                    with np.errstate(divide="ignore", invalid="ignore"):
                        keep = np.broadcast_to(np.asarray(pred.fn(cols_np, aux)), (b.capacity,))
                    mask = b.mask & upload([np.ascontiguousarray(keep)], b.device)[0]
                else:
                    mask = operator_program(prog, b.columns, b.mask, prog.aux_arrays(b.dicts))
                out.append(ColumnBatch(b.schema, b.columns, mask, b.dicts))
        return out

    def _compile(self, scalars, device, xp=None):
        comp = ExprCompiler(self.input.schema, "host" if self.host_mode else "device", device,
                            xp=xp)
        pred = comp.compile_pred(_substitute_scalars(self.predicate, scalars))
        if pred.dtype != BOOL:
            raise InternalError("filter predicate must be boolean")
        return comp, pred

    def _label(self):
        mode = " (host)" if self.host_mode else ""
        return f"FilterExec{mode}: {self.predicate}"


# --------------------------------------------------------------------------
# aggregation
# --------------------------------------------------------------------------


class _SchemaSource:
    """Schema-only plan stub for ephemeral operators (the spill-merge
    aggregation) whose input is never executed."""

    def __init__(self, schema: Schema):
        self.schema = schema

    def output_partition_count(self):
        return 1


def _state_bytes(batches, *schemas: Schema) -> int:
    """Reservation estimate for materializing ``batches`` plus the derived
    state the given schemas describe: total capacity x physical row width
    (4 bytes is the per-column floor, +1 for the mask), as the reference
    counts it."""
    cap = sum(b.capacity for b in batches)
    width = sum(1 + sum(max(f.dtype.np_dtype.itemsize, 4) for f in s) for s in schemas)
    return cap * width


# the adaptive passthrough trigger (reference operators.py:990-1013): a
# partial aggregate whose result keeps more than PASSTHROUGH_RATIO of at
# least PASSTHROUGH_MIN_ROWS input rows latches per-row states
PASSTHROUGH_MIN_ROWS = 1 << 17
PASSTHROUGH_RATIO = 0.6


def poor_reduction(in_rows: Optional[int], in_capacity: int, out_rows: int) -> bool:
    """The passthrough trigger.  An unknown input count is bounded by the
    input capacity, so out_rows > 0.6 x capacity still certifies it."""
    if in_rows is not None:
        return in_rows >= PASSTHROUGH_MIN_ROWS and out_rows > PASSTHROUGH_RATIO * in_rows
    return in_capacity >= PASSTHROUGH_MIN_ROWS and out_rows > PASSTHROUGH_RATIO * in_capacity


@dataclasses.dataclass
class AggSpec:
    func: str  # sum | count | min | max
    operand: Optional[E.Expr]  # None for count(*)
    name: str


class HashAggregateExec(ExecutionPlan):
    """Grouped aggregation with static group capacity.

    ``mode``: 'partial' (per input partition, emits group states),
    'final' (merges states after a hash repartition on the group keys) or
    'single' (both in one).

    ``clustered`` is set by the planner on a partial aggregate over a
    key-clustered parquet scan (scheduler/physical_planner.py
    _clustered_having_pushdown): (HAVING predicate or None, overlap
    intervals, the declared (min, max) key range of each partition).  Such
    a partial groups without a sort, and with a predicate applies the
    HAVING in the task to every key outside the intervals.

    ``_passthrough`` latches when a task of a partial aggregate finds poor
    reduction on a large input (the deferred probe, resolved at the
    metrics snapshot after the task): sibling tasks then emit per-row
    states (K15), which the final aggregate merges to the same result."""

    MERGE = {"sum": "sum", "count": "sum", "min": "min", "max": "max"}

    def __init__(self, input: ExecutionPlan, group_exprs: List[Tuple[E.Expr, str]],
                 aggs: List[AggSpec], mode: str):
        if mode not in ("partial", "final", "single"):
            raise InternalError(f"unknown aggregate mode {mode!r}")
        self.input = input
        self.group_exprs = group_exprs
        self.aggs = aggs
        self.mode = mode
        in_schema = input.schema
        fields = [Field(n, e.dtype(in_schema), _expr_nullable(e, in_schema))
                  for e, n in group_exprs]
        for a in self.aggs:
            fields.append(Field(a.name, self._agg_dtype(a, in_schema),
                                self._agg_nullable(a, in_schema)))
        self._schema = Schema(fields)
        self._compiled = None
        self.clustered = None
        self._no_presort = False  # latched when the input turns out unordered
        self._stale_ranges = False  # latched when the declared ranges are wrong
        self._cl_compiled = None
        self._passthrough = False  # latched by the adaptive passthrough probe
        self._pt_program = None
        self._merge = None
        self._program = None  # K19: the key and value operands

    def _agg_nullable(self, a: AggSpec, in_schema: Schema) -> bool:
        """SQL: sum/min/max yield NULL for an all-NULL group (nullable
        operand) and for a global aggregate over empty input; count never."""
        if a.func == "count":
            return False
        if self.mode == "final":
            return in_schema.field(a.name).nullable
        op_nullable = a.operand is not None and _expr_nullable(a.operand, in_schema)
        return op_nullable or not self.group_exprs

    def _agg_dtype(self, a: AggSpec, in_schema: Schema) -> DataType:
        if self.mode == "final":
            return in_schema.field(a.name).dtype
        if a.func == "count":
            return INT64
        t = a.operand.dtype(in_schema)
        if a.func == "sum" and t.kind == "int32":
            return INT64
        return t

    def children(self):
        return [self.input]

    def output_partition_count(self):
        return self.input.output_partition_count() if self.mode != "single" else 1

    def output_partitioning(self):
        if self.mode == "final":
            return self.input.output_partitioning()
        return Partitioning.unknown(self.output_partition_count())

    def execute(self, partition: int, ctx: TaskContext) -> List[ColumnBatch]:
        with ctx.op_span(self):
            return self._execute(partition, ctx)

    def _execute(self, partition: int, ctx: TaskContext) -> List[ColumnBatch]:
        ctx.check_cancelled()
        in_schema = self.input.schema
        batches = self.input.execute(partition, ctx)
        # memory governor: reserve the concatenated input and group-state
        # footprint before materializing it; a denial takes the spill path
        # (per-batch partial runs on disk, merged by one final-mode pass).
        # The clustered and passthrough paths are exempt, as in the
        # reference: the early filter must see the whole partition, and
        # per-row states hold no groups.
        gov = ctx.governor
        reservation = None
        if gov is not None and self.clustered is None and not self._passthrough:
            reservation = gov.try_reserve(_state_bytes(batches, in_schema, self._schema),
                                          site=f"agg:{self.mode}")
            if reservation is None:
                return self._execute_spilled(ctx, batches, in_schema)
        try:
            return self._execute_inmem(partition, ctx, batches, in_schema)
        finally:
            if reservation is not None:
                reservation.release()

    def _ensure_compiled(self, ctx, in_schema):
        with self.build_lock():
            if self._compiled is None:
                self._compiled = self._make_compiled(ctx, in_schema)
                self._program = self._make_compiled(ctx, in_schema, program=True)

    def device_programs(self, ctx: TaskContext):
        self._ensure_compiled(ctx, self.input.schema)
        progs = [self._program]
        if self.clustered is not None and self.clustered[0] is not None:
            progs.append(self._having_program(ctx)[0])
        return progs

    def _execute_inmem(self, partition: int, ctx: TaskContext, batches, in_schema):
        big = concat_batches(in_schema, batches, device=ctx.device).shrink()
        if self.mode == "partial" and self.group_exprs and self._passthrough \
                and self.clustered is None:
            # a sibling task found near-no reduction: aggregating before the
            # shuffle buys nothing, so emit per-row states (any mix of
            # aggregated and per-row partials merges to the same final)
            return [self._execute_passthrough(ctx, big, in_schema)]
        self._ensure_compiled(ctx, in_schema)
        out, disorder = self._execute_device(big, ctx.device)
        if self.mode != "partial" or self.clustered is None:
            return [out]
        if self.clustered[0] is None:
            # presorted-only: no early filter, but disorder (and a declared
            # range the data left) still sends the partition down the sort
            # path
            if disorder is not None:
                mismatch = self._declared_range_mismatch(big, partition)
                if mismatch is not None:
                    dis_v, mis_v = to_host(torch.stack([disorder, mismatch])).tolist()
                    if mis_v:
                        self.metrics().add("clustered_range_mismatches", 1)
                    bad = dis_v or mis_v
                else:
                    bad = bool(disorder)
                if bad:
                    out = self._latch_sorted_fallback(big, ctx.device)
            return [out]
        if self._stale_ranges:
            # the statistics lied earlier in this stage: the overlap windows
            # are untrustworthy, so full partials ship (the HAVING still
            # applies after the final aggregate)
            return [out]
        mismatch = (self._declared_range_mismatch(big, partition)
                    if disorder is not None else None)
        filtered = self._apply_clustered_filter(ctx, out, disorder, mismatch)
        if filtered is None:
            out = self._latch_sorted_fallback(big, ctx.device)
            if self._stale_ranges:
                return [out]
            filtered = self._apply_clustered_filter(ctx, out, None, None)
        return [filtered]

    def _execute_spilled(self, ctx: TaskContext, batches, in_schema) -> List[ColumnBatch]:
        """Reservation denied: bound the state to one input batch at a time.
        Each batch is aggregated on its own, its result spills to disk as an
        Arrow IPC run, and the runs are merged on read by ONE final-mode
        pass (the MERGE functions are the partial-state merge, NULL
        sentinels included).

        Bit-identical to the in-memory path: groups come out in ascending
        key order from both grouping paths, dictionaries are sorted
        everywhere (the spill read included), and the decimal columns are
        int64, so the partial merges are exact and associative."""
        from ..memory.spill import Spiller

        self._ensure_compiled(ctx, in_schema)
        spiller = Spiller(ctx.work_dir, ctx.job_id, tag="agg")
        try:
            for b in batches:
                ctx.check_cancelled()
                out, _ = self._execute_device(b, ctx.device)
                spiller.write_batch(out)
            self.metrics().add("spill_runs", len(spiller.runs))
            self.metrics().add("spill_bytes", sum(r.num_bytes for r in spiller.runs))
            merged = concat_batches(self._schema, spiller.read(self._schema, device=ctx.device),
                                    device=ctx.device).shrink()
            mop = self._merge_op()
            mop._ensure_compiled(ctx, self._schema)
            out, _ = mop._execute_device(merged, ctx.device)
            deferred_rows(self.metrics(), "output_rows", out)
            return [out]
        finally:
            spiller.cleanup()

    def _merge_op(self) -> "HashAggregateExec":
        """Ephemeral final-mode aggregation over this operator's own output
        schema: merging per-run states is the same computation for every
        mode (sum of sums, min of mins; counts merge by summing)."""
        with self.build_lock():
            if self._merge is None:
                self._merge = HashAggregateExec(
                    _SchemaSource(self._schema),
                    [(E.Column(n), n) for _, n in self.group_exprs], self.aggs, "final")
            return self._merge

    def _build_passthrough(self, ctx, in_schema, xp=None):
        """(compiler, group closures, per-aggregate (closure, func, name,
        NULL check, state dtype)) of the per-row states; ``xp`` (CudaOps)
        traces them into K15's source."""
        comp = ExprCompiler(in_schema, "device", ctx.device, xp=xp)
        group_c = [(comp.compile(_substitute_scalars(e, ctx.scalars)), n)
                   for e, n in self.group_exprs]
        agg_items = []
        for a in self.aggs:
            cc = (comp.compile(_substitute_scalars(a.operand, ctx.scalars))
                  if a.operand is not None else None)
            agg_items.append((cc, a.func, a.name, null_check_of(cc, a.operand, in_schema),
                              self._schema.field(a.name).dtype))
        return comp, group_c, agg_items

    def _execute_passthrough(self, ctx: TaskContext, big: ColumnBatch, in_schema) -> ColumnBatch:
        """Per-row partial states of every live row (K15): the key columns,
        and per aggregate the value (NULL as the state dtype's sentinel)
        for sum/min/max, or 0/1 for count."""
        from ..compile.fused import PassthroughProgram, passthrough_rows

        with self.build_lock():
            if self._pt_program is None:
                self._pt_program = PassthroughProgram(self, ctx)
        prog = self._pt_program
        comp, group_c, _items = prog.compiled
        with self.metrics().timer("agg_time"):
            cols = passthrough_rows(prog, big.columns, big.mask, comp.aux_arrays(big.dicts))
        dicts = {name: cc.dict_fn(big.dicts) for cc, name in group_c if cc.dict_fn is not None}
        result = ColumnBatch(self._schema, cols, big.mask, dicts, num_rows=big._num_rows)
        self.metrics().add("passthrough_partials", 1)
        deferred_rows(self.metrics(), "output_rows", result)
        return result

    def _presorted(self) -> bool:
        """A clustered single-key partial groups without sorting (its input
        is in key order by construction: kernels.grouped_aggregate_presorted)
        until a disorder detection latches it off."""
        return (self.mode == "partial" and self.clustered is not None
                and len(self.group_exprs) == 1 and not self._no_presort)

    def _latch_sorted_fallback(self, big: ColumnBatch, device) -> ColumnBatch:
        """The row groups lied about their order: latch the presorted
        grouping off and re-run on the sort path (query semantics, not a
        fallback of a kernel: both paths run on the device)."""
        self.metrics().add("presort_fallbacks", 1)
        with self.build_lock():
            self._no_presort = True
        out, _ = self._execute_device(big, device)
        return out

    def _declared_range_mismatch(self, big: ColumnBatch, partition: int):
        """Stale-statistics guard (K10): is a live key of this partition
        outside the (min, max) the planner declared from row-group
        statistics?  A 0-d bool on the device, or None when no declared
        range applies to the partition."""
        ranges = self.clustered[2]
        if not 0 <= partition < len(ranges):
            return None
        key_name = self.group_exprs[0][1]
        field = self._schema.field(key_name)
        # NULL keys ride an in-band sentinel that the statistics exclude
        sent = int(field.dtype.null_sentinel) if field.nullable else None
        k = self._agg_inputs(big.columns, big.mask, big.dicts)[0][0]
        lo, hi = ranges[partition]
        return K.key_range_check(k, big.mask, int(lo), int(hi), sent)

    def _having_program(self, ctx):
        """The early HAVING's predicate over the partial states as a K19
        column program (one bool column, ``__having``, which K11 reads),
        and the overlap intervals on the device (``kernels.KeepIntervals``:
        the padded pairs and their merged union)."""
        from ..compile.programs import OperatorProgram

        pred_expr, intervals = self.clustered[0], self.clustered[1]
        with self.build_lock():
            if self._cl_compiled is None:
                def build(xp, dev):
                    comp = ExprCompiler(self._schema, "device", dev, xp=xp)
                    pred = comp.compile_pred(_substitute_scalars(pred_expr, ctx.scalars))

                    def body(_xp, cols, mask, auxs):
                        return [("__having", _full_column(pred.fn(cols, auxs[0]),
                                                          mask.shape[0]))]

                    return [comp], body, pred

                prog = OperatorProgram("columns", "early having", self._schema, build,
                                       ctx.device)
                # padded to a power of two with empty (1, 0) pairs, as in the
                # reference
                padn = round_capacity(max(1, len(intervals)), 4)
                los = np.full(padn, 1, dtype=np.int64)
                his = np.full(padn, 0, dtype=np.int64)
                for i, (lo, hi) in enumerate(intervals):
                    los[i], his[i] = lo, hi
                self._cl_compiled = (prog, K.KeepIntervals(los, his, ctx.device))
            return self._cl_compiled

    def _apply_clustered_filter(self, ctx, result: ColumnBatch, disorder, mismatch):
        """Early HAVING (K11): this partition's partial state is final for
        every key outside the overlap windows, so only survivors of the
        HAVING predicate and window keys ship.  One small device->host copy
        fetches the live count with the disorder and mismatch flags.
        Returns the shrunk batch, or None when the caller must re-run the
        sort path (disorder, or stale declared ranges)."""
        from ..compile.programs import operator_program

        prog, intervals = self._having_program(ctx)
        p = operator_program(prog, result.columns, result.mask,
                             prog.aux_arrays(result.dicts))["__having"]
        keep, live = K.clustered_keep(result.columns[self.group_exprs[0][1]], result.mask, p,
                                      intervals)
        if disorder is not None:
            no = torch.zeros((), dtype=torch.bool, device=live.device)
            flags = torch.stack([live, disorder.to(torch.int64),
                                 (mismatch if mismatch is not None else no).to(torch.int64)])
            live_v, dis_v, mis_v = to_host(flags).tolist()
            if mis_v:
                # the declared ranges are wrong (stale statistics): the
                # early filter itself is invalid; latch it off
                self.metrics().add("clustered_range_mismatches", 1)
                self._stale_ranges = True
                return None
            if dis_v:
                return None
        else:
            live_v = int(live)
        self.metrics().add("clustered_early_filters", 1)
        return ColumnBatch(result.schema, result.columns, keep, result.dicts,
                           num_rows=live_v).shrink()

    def _make_compiled(self, ctx, in_schema, program: bool = False):
        """The compiled closures, or (``program``) the K19 column program
        of the key and value operands; shared across jobs by signature."""
        build = ((lambda: self._operand_program(ctx, in_schema)) if program
                 else (lambda: self._build_compiled(ctx, in_schema)))
        all_exprs = [e for e, _ in self.group_exprs] + [a.operand for a in self.aggs]
        if not has_scalar_subquery(*all_exprs):
            key = ("agg", self.mode, str(ctx.device), schema_sig(in_schema),
                   exprs_sig([e for e, _ in self.group_exprs]),
                   tuple(n for _, n in self.group_exprs),
                   tuple((a.func, a.name) for a in self.aggs),
                   exprs_sig([a.operand for a in self.aggs]), program)
            return shared_program(key, build)
        return build()

    def _operand_program(self, ctx, in_schema):
        """K19: the expression part of the reference's "agg.grouped"
        program (``agg_inputs``) as one column program: the key columns
        ``__key<j>`` and the value columns ``__val<a>``."""
        from ..compile.programs import OperatorProgram

        def build(xp, dev):
            compiled = self._build_compiled(dataclasses.replace(ctx, device=dev), in_schema,
                                            xp=xp)

            def body(xp_, cols, mask, auxs):
                keys, vals = agg_inputs(xp_, compiled, cols, mask, auxs[0])
                return ([(f"__key{j}", k) for j, k in enumerate(keys)]
                        + [(f"__val{a}", v) for a, (v, _how) in enumerate(vals)])

            return [compiled[0]], body, agg_value_hows(compiled)

        return OperatorProgram("columns", f"aggregate operands ({self.mode})", in_schema,
                               build, ctx.device)

    def _build_compiled(self, ctx, in_schema, xp=None):
        comp = ExprCompiler(in_schema, "device", ctx.device, xp=xp)
        group_c = [(comp.compile(_substitute_scalars(e, ctx.scalars)), n)
                   for e, n in self.group_exprs]
        agg_c = []
        for a in self.aggs:
            if self.mode == "final":
                operand = E.Column(a.name)
                how = self.MERGE[a.func]
            else:
                operand = a.operand
                how = a.func
            cc = (comp.compile(_substitute_scalars(operand, ctx.scalars))
                  if operand is not None else None)
            # SQL NULL semantics: aggregates skip NULL inputs
            agg_c.append((cc, how, a.name, null_check_of(cc, operand, in_schema)))
        # nullable sum/min/max also aggregate a hidden per-group valid
        # count, so an all-NULL group can be restored to NULL afterwards
        tracked = [i for i, (cc, how, _, nc) in enumerate(agg_c)
                   if nc is not None and how in ("sum", "min", "max")]
        return comp, group_c, agg_c, tracked

    def _agg_inputs(self, cols, mask, dicts):
        """Key columns and (value, how) pairs of one batch (K19)."""
        from ..compile.programs import operator_program

        if self._program is None:  # the closures were compiled alone
            with self.build_lock():
                self._program = self._make_compiled(TaskContext(device=mask.device),
                                                    self.input.schema, program=True)
        prog = self._program
        out = operator_program(prog, cols, mask, prog.aux_arrays(dicts))
        keys = [out[f"__key{j}"] for j in range(len(self.group_exprs))]
        vals = [(out[f"__val{a}"], how) for a, how in enumerate(prog.extra)]
        return keys, vals

    def _key_ranges(self, group_c, dicts):
        """Static key ranges enable the dense grouping path: dictionary
        codes have host-known ranges (rounded up to a power of two, as in
        the reference, operators.py:893-910), bools are {0,1}."""
        key_ranges = []
        for cc, _n in group_c:
            if cc.dtype.is_string and cc.dict_fn is not None:
                dic = cc.dict_fn(dicts)
                key_ranges.append((-1, round_capacity(len(dic), 16) - 1))
            elif cc.dtype.kind == "bool":
                key_ranges.append((0, 1))
            else:
                key_ranges.append(None)
        return tuple(key_ranges)

    def _execute_device(self, big: ColumnBatch, device):
        """Returns (result batch, disorder flag on the device or None)."""
        comp, group_c, agg_c, tracked = self._compiled
        key_ranges = self._key_ranges(group_c, big.dicts)
        # the group count is bounded by the dense key domain when the ranges
        # are static, else by the input capacity (the sort and presorted
        # paths): out_cap provably holds every group and overflow is None
        out_cap = big.capacity
        domain = K.dense_domain(key_ranges)
        if domain is not None:
            out_cap = min(out_cap, domain)
        disorder = None
        with self.metrics().timer("agg_time"):
            keys, vals = self._agg_inputs(big.columns, big.mask, big.dicts)
            if self._presorted():
                out_keys, out_vals, out_mask, overflow, disorder = \
                    K.grouped_aggregate_presorted(keys, vals, big.mask, big.capacity)
            else:
                out_keys, out_vals, out_mask, overflow = K.grouped_aggregate(
                    keys, vals, big.mask, out_cap, key_ranges=key_ranges)
            if overflow is not None and bool(overflow):
                raise CapacityError(
                    f"aggregation overflowed {out_cap} groups with "
                    f"{big.capacity}-row input; this should be impossible")

        result = self._result_batch(out_keys, out_vals, out_mask, big.dicts, self._compiled)
        # SQL: a global aggregate ('single'/'final' with no keys) over empty
        # input yields one row: count = 0, sum/min/max = NULL
        if not self.group_exprs and self.mode in ("single", "final") and result.num_rows == 0:
            data = {}
            for a in self.aggs:
                f = self._schema.field(a.name)
                fill = f.dtype.null_sentinel if f.nullable else 0
                data[a.name] = np.asarray([fill], dtype=f.dtype.np_dtype)
            result = ColumnBatch.from_numpy(self._schema, data, dicts={}, device=device)
        self._probe_output(result, big)
        return result, disorder

    def _probe_output(self, result: ColumnBatch, big: ColumnBatch) -> None:
        """``output_rows`` and the adaptive passthrough probe, deferred: the
        result's count is on the device here, and the downstream shuffle
        writer's packed copy makes it host-known for free before the task's
        metrics snapshot resolves the probe.  The counts are read through
        ``ColumnBatch.on_count``, so the metrics never pin device buffers.

        The reference reads the count through a weakref to the result,
        which the shuffle writer has dropped by the time of the snapshot:
        its probe resolves to 0 and never latches in the standalone engine
        (ROADMAP.md queue 3).  Here the count outlives the batch."""
        out_count, in_count = deferred_count(result), deferred_count(big)
        inp_cap = big.capacity

        def _finish():
            rn = out_count()
            if not rn:
                return rn  # None: not host-known yet, stays queued
            if self.mode == "partial" and self.group_exprs:
                if poor_reduction(in_count() or None, inp_cap, rn):
                    self._passthrough = True
            return rn

        if result._num_rows is not None:
            self.metrics().add("output_rows", _finish())
        else:
            self.metrics().add_deferred("output_rows", _finish)

    def _result_batch(self, out_keys, out_vals, out_mask, dicts_in, compiled) -> ColumnBatch:
        """The output batch of grouped states: key dictionaries, and NULL
        (the output sentinel) restored in all-NULL groups, where the hidden
        valid count is zero."""
        _comp, group_c, agg_c, tracked = compiled
        cols: Dict[str, torch.Tensor] = {}
        dicts: Dict[str, np.ndarray] = {}
        for (cc, name), arr in zip(group_c, out_keys):
            cols[name] = arr
            if cc.dict_fn is not None:
                dicts[name] = cc.dict_fn(dicts_in)
        for (cc, how, name, _), arr in zip(agg_c, out_vals[: len(agg_c)]):
            cols[name] = arr
        for i, cnt in zip(tracked, out_vals[len(agg_c):]):
            name = agg_c[i][2]
            f = self._schema.field(name)
            sent = torch.full((), _py_scalar(f.dtype.null_sentinel), dtype=cols[name].dtype,
                              device=cnt.device)
            cols[name] = torch.where(cnt > 0, cols[name], sent)
        return ColumnBatch(self._schema, cols, out_mask, dicts)

    def _label(self):
        g = ", ".join(n for _, n in self.group_exprs)
        a = ", ".join(f"{x.func}({x.name})" for x in self.aggs)
        return f"HashAggregateExec({self.mode}): groupBy=[{g}] aggr=[{a}]"


def passthrough_states(xp, pt, cols, mask, aux, names=None):
    """The per-row partial states of the reference's "agg.passthrough"
    program (operators.py:745): [(name, column)] for every key and state
    column, or only those in ``names``.  ``xp`` is TorchOps (K15's twin),
    or the CudaOps that traces the same steps into K15's generated
    source."""
    _comp, group_c, agg_items = pt
    n = mask.shape[0]
    out = [(name, _full_column(c.fn(cols, aux), n)) for c, name in group_c
           if names is None or name in names]
    for cc, how, name, null_check, dt in agg_items:
        if names is not None and name not in names:
            continue
        np_dt = dt.np_dtype
        if cc is None or (how == "count" and null_check is None):
            # count(*), or of a value that is never NULL: one per row
            out.append((name, xp.full((n,), 1, dtype=np_dt)))
            continue
        v = _full_column(cc.fn(cols, aux), n)
        valid = valid_of(v, null_check, xp) if null_check is not None else None
        if how == "count":
            out.append((name, xp.astype(valid, np_dt)))
            continue
        # sum / min / max: the state is the value, NULL its sentinel
        v = xp.astype(v, np_dt)
        if valid is not None:
            v = xp.where(valid, v, xp.full((), _py_scalar(dt.null_sentinel), dtype=np_dt))
        out.append((name, v))
    return out


def agg_value_hows(compiled):
    """The aggregation of each value column ``agg_inputs`` returns, in
    order (known from the compiled closures alone)."""
    _comp, _group_c, agg_c, tracked = compiled
    hows = []
    for cc, how, _name, null_check in agg_c:
        if cc is None:
            hows.append(K.AGG_COUNT)
        elif null_check is not None and how == "count":
            hows.append(K.AGG_SUM)
        else:
            hows.append(how)
    return hows + [K.AGG_SUM] * len(tracked)


def agg_inputs(xp, compiled, cols, mask, aux):
    """Key columns and (value, how) pairs of one batch under an
    aggregate's compiled closures: the expression part of the reference's
    "agg.grouped" program (operators.py:847-885) — key and value
    evaluation, NULL valid masks, identity substitution for skipped NULLs
    and the hidden per-group valid counts.  ``xp`` is TorchOps, or the
    CudaOps of a fused chain (compile/codegen.py), which traces the same
    steps into K13's row function."""
    comp, group_c, agg_c, tracked = compiled
    n = mask.shape[0]
    keys = [_full_column(c.fn(cols, aux), n) for c, _ in group_c]
    vals = []
    valids = {}
    for i, (cc, how, _, null_check) in enumerate(agg_c):
        if cc is None:  # count(*)
            vals.append((xp.zeros(n, dtype=np.int64), K.AGG_COUNT))
            continue
        v = _full_column(cc.fn(cols, aux), n)
        if null_check is not None:
            valid = valid_of(v, null_check, xp)
            valids[i] = valid
            if how == "count":
                vals.append((xp.astype(valid, np.int64), K.AGG_SUM))
                continue
            if how == "sum":
                v = xp.where(valid, v, xp.zeros((), dtype=v.dtype))
            elif how == "min":
                v = xp.where(valid, v, xp.full((), K._max_ident(v.dtype), dtype=v.dtype))
            elif how == "max":
                v = xp.where(valid, v, xp.full((), K._min_ident(v.dtype), dtype=v.dtype))
        vals.append((v, how))
    for i in tracked:
        vals.append((xp.astype(valids[i], np.int64), K.AGG_SUM))
    return keys, vals


# --------------------------------------------------------------------------
# join
# --------------------------------------------------------------------------


def window_counts(offsets: torch.Tensor, chunk_rows: int, n_windows: int) -> torch.Tensor:
    """Candidate pairs per probe window of ``chunk_rows`` rows, from K6's
    inclusive offsets at the window edges (no second reduction)."""
    n = offsets.shape[0]
    ends = torch.clamp(torch.arange(1, n_windows + 1, device=offsets.device) * chunk_rows,
                       max=n)
    upto = torch.cat([torch.zeros(1, dtype=offsets.dtype, device=offsets.device), offsets])
    edge = upto[ends]  # pairs of the rows before each window's end
    return torch.diff(edge, prepend=torch.zeros(1, dtype=edge.dtype, device=edge.device))


class JoinExec(ExecutionPlan):
    """Equi-join: sorted build (K3 + K5) + binary-search probe (K6) +
    fixed-capacity pair expansion.  Probe = left child, build = right child.

    ``dist``: 'partitioned' (both children hash-partitioned on the keys;
    the planner inserts the exchanges) or 'broadcast' (the build side read
    whole by every probe partition, materialized once per job).

    Hash collisions cannot corrupt results: real key equality is
    re-verified on every candidate pair.

    Under the memory governor a partitioned build reserves its footprint
    first: inner, semi and anti joins spill on a denial (``_join_spilled``),
    left and full joins take an over-budget grant."""

    _SPILL_PARTS = 8

    def __init__(self, left: ExecutionPlan, right: ExecutionPlan,
                 on: List[Tuple[E.Expr, E.Expr]], join_type: str = "inner",
                 filter: Optional[E.Expr] = None, dist: str = "partitioned"):
        if join_type not in ("inner", "left", "full", "semi", "anti"):
            raise InternalError(f"unknown join type {join_type!r}")
        if dist not in ("partitioned", "broadcast"):
            raise InternalError(f"unknown join distribution {dist!r}")
        # a broadcast full join would emit each unmatched build row once per
        # probe partition: the planner uses the partitioned path instead
        if join_type == "full" and dist == "broadcast":
            raise InternalError("a full join cannot broadcast its build side")
        self.left = left
        self.right = right
        self.on = on
        self.join_type = join_type
        self.filter = filter
        self.dist = dist
        if join_type in ("semi", "anti"):
            self._schema = left.schema
        elif join_type == "left":
            self._schema = Schema(
                list(left.schema)
                + [Field(f.name, f.dtype, nullable=True) for f in right.schema])
        elif join_type == "full":
            self._schema = Schema(
                [Field(f.name, f.dtype, nullable=True) for f in left.schema]
                + [Field(f.name, f.dtype, nullable=True) for f in right.schema])
        else:
            self._schema = left.schema.merge(right.schema)
        self._compiled = None

    def children(self):
        return [self.left, self.right]

    def output_partition_count(self):
        return self.left.output_partition_count()

    def output_partitioning(self):
        return self.left.output_partitioning()

    def execute(self, partition: int, ctx: TaskContext) -> List[ColumnBatch]:
        with ctx.op_span(self):
            return self._execute(partition, ctx)

    def _execute(self, partition: int, ctx: TaskContext) -> List[ColumnBatch]:
        ctx.check_cancelled()
        probe = concat_batches(self.left.schema, self.left.execute(partition, ctx),
                               device=ctx.device).shrink()
        ctx.check_cancelled()
        lsch, rsch = self.left.schema, self.right.schema
        reservation = None
        if self.dist == "broadcast":
            # materialize the build side once per job: every probe partition
            # shares this operator, and re-running the build subtree per
            # partition would multiply its scans by the partition count
            with self.build_lock():
                cached = getattr(self, "_build_cache", None)
                if cached is None or cached[0] != ctx.job_id:
                    build_parts = []
                    for p in range(self.right.output_partition_count()):
                        build_parts.extend(self.right.execute(p, ctx))
                    build = concat_batches(self.right.schema, build_parts,
                                           device=ctx.device).shrink()
                    cached = (ctx.job_id, build)
                    self._build_cache = cached
                    _register_build_cache(ctx.job_id, self)
                build = cached[1]
        else:
            bparts = self.right.execute(partition, ctx)
            # memory governor: reserve the build side's footprint before
            # concatenating it.  On a denial inner, semi and anti joins spill
            # a hash-partitioned build (partitions on disk, rehydrated one at
            # a time); left and full joins need every build row live for
            # their unmatched-row pass, so they take an over-budget grant.
            # Broadcast builds are exempt: their job-scoped cache outlives
            # the task.
            gov = ctx.governor
            if gov is not None:
                est = _state_bytes(bparts, rsch)
                if self.join_type in ("inner", "semi", "anti"):
                    reservation = gov.try_reserve(est, site=f"join:{self.join_type}")
                    if reservation is None:
                        return self._join_spilled(ctx, probe, bparts, lsch, rsch)
                else:
                    reservation = gov.force_reserve(est, site=f"join:{self.join_type}")
            build = concat_batches(rsch, bparts, device=ctx.device).shrink()
        try:
            with self.build_lock():
                self._ensure_compiled(ctx, lsch, rsch)
            return self._join_device(ctx, probe, build)
        finally:
            if reservation is not None:
                reservation.release()

    def _ensure_compiled(self, ctx, lsch, rsch):
        if self._compiled is None:
            join_exprs = [e for pair in self.on for e in pair] + [self.filter]
            if not has_scalar_subquery(*join_exprs):
                key = ("join", self.join_type, self.dist, str(ctx.device),
                       schema_sig(lsch), schema_sig(rsch),
                       schema_sig(self._schema), exprs_sig(join_exprs))
                self._compiled = shared_program(
                    key, lambda: self._build_join(ctx, lsch, rsch))
            else:
                self._compiled = self._build_join(ctx, lsch, rsch)

    def _build_join(self, ctx, lsch, rsch):
        """The join's programs and closures: K19 column programs of each
        side's keys and key validity, K19's mask program verifying each
        candidate pair (real key equality behind the hashes, build
        liveness, NULL keys) with the residual filter, and the closures
        composing them with K3, K5-K7, K21 and K22."""
        from ..compile.programs import OperatorProgram, operator_program

        dev = ctx.device
        jt = self.join_type
        lnames = [f.name for f in lsch]
        rnames = [f.name for f in rsch]
        rfill = {f.name: _py_scalar(f.dtype.null_sentinel) for f in rsch}
        lfill = {f.name: _py_scalar(f.dtype.null_sentinel) for f in lsch}
        # the pair filter gathers only the columns it references
        fnames = self.filter.column_refs() if self.filter is not None else set()
        null_key = K._s64(int(ExprCompiler.NULL_KEY_SENTINEL))
        nk = len(self.on)

        def side_program(sch, exprs, label):
            # NULL join keys never match (string keys through
            # NULL_KEY_SENTINEL, numeric nullable keys through their validity)
            def build(xp, d):
                comp = ExprCompiler(sch, "device", d, xp=xp)
                keys = [comp.compile_key(e) for e in exprs]
                valid = [comp.validity_fn(comp.nullable_refs(e)) for e in exprs]

                def body(_xp, cols, mask, auxs):
                    n = mask.shape[0]
                    out = [(f"__k{i}", _full_column(c.fn(cols, auxs[0]), n))
                           for i, c in enumerate(keys)]
                    out += [(f"__v{i}", _full_column(v(cols, auxs[0]), n))
                            for i, v in enumerate(valid) if v is not None]
                    return out

                return [comp], body, (keys, [v is not None for v in valid])

            return OperatorProgram("columns", label, sch, build, dev)

        lprog = side_program(lsch, [le for le, _ in self.on], "join probe keys")
        rprog = side_program(rsch, [re_ for _, re_ in self.on], "join build keys")
        lkeys, lvalid = lprog.extra
        _rkeys, rvalid = rprog.extra

        # the pair schema the verification reads: both sides' gathered keys
        # and validities, the build mask, and the filter's columns
        def key_field(name, c, t):
            kind = {torch.int32: "int32", torch.int64: "int64", torch.float32: "float32",
                    torch.float64: "float64", torch.bool: "bool"}[t]
            return Field(name, DataType(kind))

        merged = lsch.merge(rsch) if self.filter is not None else None
        pair_fields = [f for f in (merged or []) if f.name in fnames]
        from ..models.batch import torch_dtype

        def phys(c):
            return torch.int64 if c.dtype.is_string else torch_dtype(c.dtype.np_dtype)

        for i, c in enumerate(lkeys):
            pair_fields.append(key_field(f"__pk{i}", c, phys(c)))
            pair_fields.append(key_field(f"__bk{i}", c, phys(_rkeys[i])))
            if lvalid[i]:
                pair_fields.append(Field(f"__pv{i}", BOOL))
            if rvalid[i]:
                pair_fields.append(Field(f"__bv{i}", BOOL))
        pair_fields.append(Field("__bmask", BOOL))
        pair_schema = Schema(pair_fields)

        def verify_build(xp, d):
            comps, fpred = [], None
            if self.filter is not None:
                fcomp = ExprCompiler(pair_schema, "device", d, xp=xp)
                fpred = fcomp.compile_pred(_substitute_scalars(self.filter, ctx.scalars))
                comps = [fcomp]

            def body(_xp, cols, mask, auxs):
                ok = mask & cols["__bmask"]
                for i in range(nk):
                    a, b = cols[f"__pk{i}"], cols[f"__bk{i}"]
                    ok = ok & (a == b)
                    if lkeys[i].dtype.is_string:
                        ok = ok & (a != null_key)
                    if lvalid[i]:
                        ok = ok & cols[f"__pv{i}"]
                    if rvalid[i]:
                        ok = ok & cols[f"__bv{i}"]
                if fpred is not None:
                    ok = ok & _full_column(fpred.fn(cols, auxs[0]), mask.shape[0])
                return ok

            return comps, body, None

        vprog = OperatorProgram("mask", "join pair verification", pair_schema, verify_build,
                                dev)

        def side_keys(prog, cols, mask, aux):
            out = operator_program(prog, cols, mask, aux)
            return [out[f"__k{i}"] for i in range(nk)], out

        def gather(idx, named):
            # one K21 launch per side; a column gathered under two names
            # (a key that is also an output column) is gathered once
            uniq, alias = {}, {}
            for k, t in named.items():
                alias[k] = uniq.setdefault(id(t), k)
            g = K.gather_columns(idx, {k: named[k] for k in uniq.values()})
            return {k: g[alias[k]] for k in named}

        def prep_fn(bcols, bmask, raux):
            # build-side hash + sort, once per broadcast build (cached)
            bk, _ = side_keys(rprog, bcols, bmask, raux)
            bh_sorted, border, _ = K.build_side_sort(bk, bmask)
            return bh_sorted, border

        def join_fn(pcols, pmask, bcols, bmask, bh_sorted, border, laux, raux, faux, out_cap):
            n_probe, n_build = pmask.shape[0], bmask.shape[0]
            pk, pside = side_keys(lprog, pcols, pmask, laux)
            _bk, bside = side_keys(rprog, bcols, bmask, raux)
            ph = K.hash64(pk)
            pi, bp, pair_valid, total = K.probe_join(ph, pmask, bh_sorted, out_cap)
            bidx = K.gather_columns(bp, {"b": border})["b"]
            # the output-column gathers are data movement (K21)
            out_l = lnames if jt in ("inner", "left", "full") else []
            out_r = rnames if jt in ("inner", "left", "full") else []
            pnamed = {n: pcols[n] for n in lnames if n in out_l or n in fnames}
            bnamed = {n: bcols[n] for n in rnames if n in out_r or n in fnames}
            for i in range(nk):
                pnamed[f"__pk{i}"], bnamed[f"__bk{i}"] = pside[f"__k{i}"], bside[f"__k{i}"]
                if lvalid[i]:
                    pnamed[f"__pv{i}"] = pside[f"__v{i}"]
                if rvalid[i]:
                    bnamed[f"__bv{i}"] = bside[f"__v{i}"]
            bnamed["__bmask"] = bmask
            pg, bg = gather(pi, pnamed), gather(bidx, bnamed)
            # verify real key equality (hash collisions), build liveness and
            # NULL keys, then the residual filter: one mask program
            ok = operator_program(vprog, {**pg, **bg}, pair_valid, faux)

            # each verdict is one K7 launch with the probe mask folded in
            if jt in ("semi", "anti"):
                mask = K.segment_any(ok, pi, n_probe, within=pmask, negate=jt == "anti")
                return pcols, mask, total, None

            out_cols = {n: pg[n] for n in lnames}
            out_cols.update({n: bg[n] for n in rnames})
            out_mask = ok
            if jt in ("left", "full"):
                # unmatched probe rows, build side NULL-filled
                miss = K.segment_any(ok, pi, n_probe, within=pmask, negate=True)
                tail = {n: pcols[n] if n in lnames else torch.full(
                    (n_probe,), rfill[n], dtype=v.dtype, device=v.device)
                    for n, v in out_cols.items()}
                out_cols, out_mask = K.concat_columns([out_cols, tail], [out_mask, miss], 0)
            if jt == "full":
                # unmatched build rows, probe side NULL-filled
                miss_b = K.segment_any(ok, bidx, n_build, within=bmask, negate=True)
                tail = {n: bcols[n] if n in rnames else torch.full(
                    (n_build,), lfill[n], dtype=v.dtype, device=v.device)
                    for n, v in out_cols.items()}
                out_cols, out_mask = K.concat_columns([out_cols, tail], [out_mask, miss_b], 0)
            # an inner join's probe-row index per pair rides along for the
            # spilled path's order-restoring merge (all matches of a probe
            # row share its hash, hence one build partition)
            return out_cols, out_mask, total, (pi if jt == "inner" else None)

        def count_fn(pcols, pmask, bh_sorted, laux):
            # candidate-pair total only: K3 + K6's count step, no gathers
            ph = K.hash64(side_keys(lprog, pcols, pmask, laux)[0])
            return K.probe_counts(ph, pmask, bh_sorted)[1]

        def wcount_fn(pcols, pmask, bh_sorted, laux, chunk_rows, n_windows):
            # per-window candidate counts for the budget-windowed probe, in
            # one pass and one host transfer
            ph = K.hash64(side_keys(lprog, pcols, pmask, laux)[0])
            offsets = K.probe_counts(ph, pmask, bh_sorted, True)[0]  # with the offsets
            return window_counts(offsets, chunk_rows, n_windows)

        return lprog, rprog, vprog, join_fn, count_fn, prep_fn, wcount_fn

    def device_programs(self, ctx: TaskContext):
        with self.build_lock():
            self._ensure_compiled(ctx, self.left.schema, self.right.schema)
        return list(self._compiled[:3])

    def _out_row_bytes(self) -> int:
        return self._schema.row_byte_width()

    def _join_device(self, ctx, probe: ColumnBatch, build: ColumnBatch) -> List[ColumnBatch]:
        lprog, rprog, vprog, jfn, cfn, pfn, _ = self._compiled
        laux = lprog.aux_arrays(probe.dicts)
        raux = rprog.aux_arrays(build.dicts)
        faux = vprog.aux_arrays({**probe.dicts, **build.dicts})

        with self.metrics().timer("join_time"):
            # build-side hash + sort, computed once per broadcast build and
            # shared by every probe partition; partitioned builds prep inline
            if self.dist == "broadcast":
                # under the lock: concurrent probe tasks of one stage prep
                # the shared build once
                with self.build_lock():
                    pc = getattr(self, "_prep_cache", None)
                    if pc is not None and pc[0] == ctx.job_id and pc[1] is build:
                        prep = pc[2]
                    else:
                        prep = pfn(build.columns, build.mask, raux)
                        # install only while this job's build cache is alive,
                        # so a concurrent clear is not followed by a re-install
                        bc = getattr(self, "_build_cache", None)
                        if bc is not None and bc[0] == ctx.job_id:
                            self._prep_cache = (ctx.job_id, build, prep)
            else:
                prep = pfn(build.columns, build.mask, raux)
            bh_sorted, border = prep
            # count pass -> exact candidate total -> capacity bucket: the low
            # floor for selective joins, else a power of two of at least
            # probe.capacity // 4, never above the configured ceiling
            ceiling = ctx.config.get(JOIN_MAX_CAPACITY)
            low_floor = max(64, probe.capacity // 64)
            # capacity-bucket hint: same-shape sibling tasks of this job skip
            # the count pass once one task found the low bucket; the total
            # the join returns is checked below, and a miss reruns the join
            hint_state = getattr(self, "_out_cap_hint", None)
            hint = None
            if hint_state is not None and hint_state[0] == ctx.job_id:
                hint = hint_state[1].get(probe.capacity)
            if hint is not None:
                out_cap = hint
            else:
                total_est = int(cfn(probe.columns, probe.mask, bh_sorted, laux))
                if total_est > ceiling:
                    raise CapacityError(
                        f"join produced {total_est} candidate pairs, above the {ceiling}-row "
                        f"ceiling; likely an accidental near-cross join — check join keys, "
                        f"or raise {JOIN_MAX_CAPACITY}")
                if total_est <= low_floor:
                    out_cap = low_floor
                else:
                    out_cap = max(1 << max(0, total_est - 1).bit_length(), probe.capacity // 4)
                if out_cap > ceiling:
                    out_cap = max(total_est, 64)
            # memory control: when the expansion would exceed the per-task
            # budget, probe in bounded windows instead of one allocation
            # (inner/semi/anti only: a full join's unmatched-build pass needs
            # every probe row's hits, a left join's miss block is
            # probe-sized per window)
            budget = resolve_task_budget(ctx.config, probe.device.type == "cuda")
            windowed = (budget and self.join_type in ("inner", "semi", "anti")
                        and probe.capacity >= 2048)
            if windowed and out_cap * self._out_row_bytes() > budget:
                return self._join_chunked(ctx, probe, build, bh_sorted, border,
                                          laux, raux, faux, budget, ceiling, out_cap)
            out_cols, out_mask, total, _pi = jfn(probe.columns, probe.mask, build.columns,
                                            build.mask, bh_sorted, border, laux, raux, faux,
                                            out_cap)
            # out_cap >= the counted total by construction; a hinted bucket
            # may be too small, and then the join reruns at the size it needs
            if int(total) > out_cap:
                need = 1 << (int(total) - 1).bit_length()
                if need > ceiling:
                    raise CapacityError(
                        f"join produced {int(total)} candidate pairs, above the "
                        f"{ceiling}-row ceiling; raise {JOIN_MAX_CAPACITY}")
                if windowed and need * self._out_row_bytes() > budget:
                    return self._join_chunked(ctx, probe, build, bh_sorted, border,
                                              laux, raux, faux, budget, ceiling, need)
                self.metrics().add("capacity_recompiles", 1)
                out_cols, out_mask, total, _pi = jfn(probe.columns, probe.mask, build.columns,
                                                build.mask, bh_sorted, border, laux, raux,
                                                faux, need)
                out_cap = need
            if out_cap == low_floor:
                # latch only the selective low bucket (job-scoped)
                hint_state = getattr(self, "_out_cap_hint", None)
                if hint_state is None or hint_state[0] != ctx.job_id:
                    self._out_cap_hint = hint_state = (ctx.job_id, {})
                hint_state[1][probe.capacity] = out_cap

        dicts = dict(probe.dicts)
        if self.join_type in ("inner", "left", "full"):
            dicts.update(build.dicts)
        result = ColumnBatch(self._schema, dict(out_cols), out_mask, dicts)
        deferred_rows(self.metrics(), "output_rows", result)
        return [result]

    def _join_spilled(self, ctx, probe: ColumnBatch, build_parts, lsch, rsch
                      ) -> List[ColumnBatch]:
        """Reservation denied: partitioned-build spill for inner, semi and
        anti joins.  Build batches split by the top bits of the join-key
        hash into ``_SPILL_PARTS`` disk partitions (IPC runs); each
        partition then rehydrates alone and the whole probe runs against it.
        K16 (``spill_order``) gives a batch's partitions and the pack's
        order in one pass: the live rows grouped by partition, in row order
        within one, so each partition's run is a slice of the host columns.

        Bit-identical to the single in-memory build:

        - every candidate match of a probe row shares that row's key hash,
          so all of its matches live in exactly one partition;
        - build rows keep their relative order within a partition (batches
          split in order, runs read in write order), and K5 breaks equal-
          hash ties by position, so each probe row's match order equals the
          single build's;
        - inner outputs carry the probe-row index ``pi``: a stable host sort
          on it re-interleaves the partitions' outputs into exactly the
          single build's probe-major order;
        - semi and anti are mask algebra over the probe (OR / AND of the
          partitions' verdicts), free of order by construction.
        """
        from ..memory.spill import Spiller

        from ..compile.programs import operator_program

        with self.build_lock():
            self._ensure_compiled(ctx, lsch, rsch)
        lprog, rprog, vprog, jfn, cfn, pfn, _ = self._compiled
        nparts = self._SPILL_PARTS
        spiller = Spiller(ctx.work_dir, ctx.job_id, tag="join")
        runs: List[list] = [[] for _ in range(nparts)]
        try:
            with self.metrics().timer("join_time"):
                for b in build_parts:
                    ctx.check_cancelled()
                    side = operator_program(rprog, b.columns, b.mask,
                                            rprog.aux_arrays(b.dicts))
                    keys = [side[f"__k{i}"] for i in range(len(self.on))]
                    part, order, count = K.spill_order(keys, b.mask, nparts)
                    cols, _n = b.packed_numpy(extra32={"__part": part}, order=(order, count))
                    # the live rows come grouped by partition, ascending
                    bounds = np.searchsorted(cols.pop("__part"), np.arange(nparts + 1))
                    for p in range(nparts):
                        lo, hi = int(bounds[p]), int(bounds[p + 1])
                        if lo == hi:
                            continue
                        runs[p].append(spiller.write_run(
                            rsch, {f.name: cols[f.name][lo:hi] for f in rsch}, b.dicts))
                self.metrics().add("spill_runs", len(spiller.runs))
                self.metrics().add("spill_bytes", sum(r.num_bytes for r in spiller.runs))

                laux = lprog.aux_arrays(probe.dicts)
                ceiling = ctx.config.get(JOIN_MAX_CAPACITY)
                low_floor = max(64, probe.capacity // 64)
                grand_total = 0
                inner_parts = []  # (host columns with __pi, the partition's dicts)
                mask_acc = None
                for p in range(nparts):
                    if not runs[p]:
                        # no build row hashes here: inner and semi add
                        # nothing, anti keeps the probe mask (AND identity)
                        continue
                    ctx.check_cancelled()
                    build_p = concat_batches(
                        rsch, spiller.read(rsch, runs=runs[p], device=ctx.device),
                        device=ctx.device).shrink()
                    raux = rprog.aux_arrays(build_p.dicts)
                    faux = vprog.aux_arrays({**probe.dicts, **build_p.dicts})
                    bh_sorted, border = pfn(build_p.columns, build_p.mask, raux)
                    # the exact candidate count of this partition sizes the
                    # output; the cross-join guard sees the partitions' sum
                    total_est = int(cfn(probe.columns, probe.mask, bh_sorted, laux))
                    grand_total += total_est
                    if grand_total > ceiling:
                        raise CapacityError(
                            f"join produced {grand_total}+ candidate pairs, above the "
                            f"{ceiling}-row ceiling; likely an accidental near-cross join "
                            f"— check join keys, or raise {JOIN_MAX_CAPACITY}")
                    out_cap = max(low_floor, 1 << max(0, total_est - 1).bit_length())
                    out_cols, out_mask, _total, pi = jfn(
                        probe.columns, probe.mask, build_p.columns, build_p.mask, bh_sorted,
                        border, laux, raux, faux, out_cap)
                    if self.join_type in ("semi", "anti"):
                        if mask_acc is None:
                            mask_acc = out_mask
                        elif self.join_type == "semi":
                            mask_acc = K.mask_or(mask_acc, out_mask)
                        else:
                            mask_acc = K.mask_and(mask_acc, out_mask)
                        continue
                    pb = ColumnBatch(self._schema, dict(out_cols), out_mask,
                                     {**probe.dicts, **build_p.dicts})
                    cols, _n = pb.packed_numpy(extra32={"__pi": pi.to(torch.int32)})
                    inner_parts.append((cols, build_p.dicts))
            if self.join_type in ("semi", "anti"):
                if mask_acc is None:  # an empty build side
                    mask_acc = probe.mask if self.join_type == "anti" \
                        else torch.zeros_like(probe.mask)
                out = ColumnBatch(self._schema, dict(probe.columns), mask_acc, dict(probe.dicts))
                deferred_rows(self.metrics(), "output_rows", out)
                return [out]
            return [self._merge_spilled_inner(probe, inner_parts, rsch, ctx.device)]
        finally:
            spiller.cleanup()

    def _merge_spilled_inner(self, probe: ColumnBatch, inner_parts, rsch, device) -> ColumnBatch:
        """Order-restoring merge of the partitions' inner outputs: remap each
        partition's build-side dictionary codes onto the sorted union
        dictionary, concatenate, stable-sort by probe-row index."""
        rstr = [f.name for f in rsch if f.dtype.is_string]
        union: Dict[str, np.ndarray] = {}
        for n in rstr:
            vals = [d.get(n) for _c, d in inner_parts
                    if d.get(n) is not None and len(d.get(n))]
            union[n] = np.unique(np.concatenate(vals)) if vals else np.array([], dtype=object)
        cols: Dict[str, list] = {f.name: [] for f in self._schema}
        pis = []
        for cols_np, dicts_p in inner_parts:
            for n in rstr:
                dic = dicts_p.get(n)
                codes = cols_np[n]
                if dic is not None and len(dic):
                    idx = np.searchsorted(union[n], dic).astype(np.int32)
                    live = codes >= 0
                    codes = codes.copy()
                    codes[live] = idx[codes[live]]
                    cols_np[n] = codes
            for f in self._schema:
                cols[f.name].append(cols_np[f.name])
            pis.append(cols_np["__pi"])
        pi = np.concatenate(pis) if pis else np.array([], dtype=np.int32)
        if pi.size == 0:
            self.metrics().add("output_rows", 0)
            return ColumnBatch.empty(self._schema, 64, device=device)
        order = np.argsort(pi, kind="stable")
        data = {n: np.concatenate(v)[order] for n, v in cols.items()}
        dicts = {}
        for f in self._schema:
            if f.dtype.is_string:
                d = union[f.name] if f.name in union else probe.dicts.get(f.name)
                if d is not None:
                    dicts[f.name] = d
        self.metrics().add("output_rows", int(pi.size))
        return ColumnBatch.from_numpy(self._schema, data, dicts=dicts, device=device)

    def _join_chunked(self, ctx, probe, build, bh_sorted, border, laux, raux, faux,
                      budget: int, ceiling: int, planned_cap: int) -> List[ColumnBatch]:
        """Bounded-footprint probe loop: the probe is windowed by row-range
        masks and each window's expansion is sized by its own count.  Exact
        for inner/semi/anti: a probe row's matches depend only on that row
        and the build side.  Semi/anti windows OR their verdict masks into
        one output batch; inner windows each emit a batch."""
        _lprog, _rprog, _vprog, jfn, cfn, pfn, wcfn = self._compiled
        cap = probe.capacity
        width = self._out_row_bytes()
        want = max(1, -(-planned_cap * width // budget))
        chunks = 1 << (want - 1).bit_length()
        chunks = min(chunks, max(1, cap // 1024))
        chunk_rows = -(-cap // chunks)
        # windows whose counts fit half the budget share one bucket size
        bucket_floor = 64
        half_budget_rows = budget // (2 * width)
        if half_budget_rows > 64:
            bucket_floor = 1 << (half_budget_rows.bit_length() - 1)
        bucket_floor = min(bucket_floor, max(64, chunk_rows))
        self.metrics().add("join_probe_chunks", chunks)
        out_batches: List[ColumnBatch] = []
        mask_acc = None  # semi/anti: accumulated verdict mask
        dicts = dict(probe.dicts)
        if self.join_type == "inner":
            dicts.update(build.dicts)
        # all window counts in one pass and one host transfer
        window_counts_h = K.to_host(wcfn(probe.columns, probe.mask, bh_sorted, laux,
                                         chunk_rows, chunks))
        grand_total = 0  # the cross-join guard sees the sum of the windows
        for i in range(chunks):
            ctx.check_cancelled()
            pmask_c = K.window_mask(probe.mask, i * chunk_rows, min((i + 1) * chunk_rows, cap))
            total_c = int(window_counts_h[i])
            grand_total += total_c
            if grand_total > ceiling:
                raise CapacityError(
                    f"join produced {grand_total}+ candidate pairs, above the {ceiling}-row "
                    f"ceiling; likely an accidental near-cross join — check join keys, or "
                    f"raise {JOIN_MAX_CAPACITY}")
            out_cap = max(64, 1 << max(0, total_c - 1).bit_length(), bucket_floor)
            if out_cap > ceiling:
                out_cap = max(total_c, 64)
            out_cols, out_mask, total, _pi = jfn(probe.columns, pmask_c, build.columns, build.mask,
                                            bh_sorted, border, laux, raux, faux, out_cap)
            if int(total) > out_cap:
                need = 1 << (int(total) - 1).bit_length()
                if need > ceiling:
                    raise CapacityError(
                        f"join window produced {int(total)} candidate pairs, above the "
                        f"{ceiling}-row ceiling; raise {JOIN_MAX_CAPACITY}")
                self.metrics().add("capacity_recompiles", 1)
                out_cols, out_mask, total, _pi = jfn(probe.columns, pmask_c, build.columns,
                                                build.mask, bh_sorted, border, laux, raux,
                                                faux, need)
            if self.join_type in ("semi", "anti"):
                mask_acc = out_mask if mask_acc is None else K.mask_or(mask_acc, out_mask)
            else:
                out_batches.append(ColumnBatch(self._schema, dict(out_cols), out_mask, dicts))
        if self.join_type in ("semi", "anti"):
            return [ColumnBatch(self._schema, dict(probe.columns), mask_acc, dicts)]
        return out_batches

    def _label(self):
        on = ", ".join(f"{l} = {r}" for l, r in self.on)
        f = f" filter={self.filter}" if self.filter is not None else ""
        return f"JoinExec({self.join_type}, {self.dist}): on=[{on}]{f}"


# --------------------------------------------------------------------------
# sort / limit / coalesce
# --------------------------------------------------------------------------


class SortExec(ExecutionPlan):
    """Total sort of a single-partition input (K4).  ``fetch`` fuses LIMIT
    into the sort."""

    def __init__(self, input: ExecutionPlan, keys: List[Tuple[E.Expr, bool]],
                 fetch: Optional[int] = None):
        self.input = input
        self.keys = keys
        self.fetch = fetch
        self._schema = input.schema
        self._compiled = None

    def children(self):
        return [self.input]

    def output_partition_count(self):
        return 1

    def output_partitioning(self):
        return Partitioning.single()

    def execute(self, partition: int, ctx: TaskContext) -> List[ColumnBatch]:
        with ctx.op_span(self):
            return self._execute(partition, ctx)

    def _execute(self, partition: int, ctx: TaskContext) -> List[ColumnBatch]:
        parts = []
        for p in range(self.input.output_partition_count()):
            ctx.check_cancelled()
            parts.extend(self.input.execute(p, ctx))
        big = concat_batches(self.input.schema, parts, device=ctx.device).shrink()
        from ..compile.programs import operator_program

        prog = self._prepared(ctx)
        with self.metrics().timer("sort_time"):
            keys = operator_program(prog, big.columns, big.mask, prog.aux_arrays(big.dicts))
            key_arrays = [(keys[f"__k{j}"], asc) for j, (_e, asc) in enumerate(self.keys)]
            order = K.sort_order(key_arrays, big.mask)
            if self.fetch is not None and self.fetch < big.capacity:
                order = order[:max(self.fetch, 1)]
            out = K.gather_columns(order, {**big.columns, "__mask": big.mask})
            mask = out.pop("__mask")
            if self.fetch is not None and self.fetch < big.capacity:
                mask = K.window_mask(mask, 0, self.fetch)
        return [ColumnBatch(self._schema, out, mask, big.dicts)]

    def _prepared(self, ctx: TaskContext):
        """The sort keys as one K19 column program (``__k<j>``)."""
        from ..compile.programs import OperatorProgram

        def program():
            def build(xp, dev):
                comp = ExprCompiler(self.input.schema, "device", dev, xp=xp)
                keys_c = [comp.compile(_substitute_scalars(e, ctx.scalars)) for e, _ in self.keys]

                def body(_xp, cols, mask, auxs):
                    n = mask.shape[0]
                    return [(f"__k{j}", _full_column(c.fn(cols, auxs[0]), n))
                            for j, c in enumerate(keys_c)]

                return [comp], body, None

            return OperatorProgram("columns", "sort keys", self.input.schema, build, ctx.device)

        with self.build_lock():
            if self._compiled is None:
                if has_scalar_subquery(*[e for e, _ in self.keys]):
                    self._compiled = program()
                else:
                    self._compiled = shared_program(
                        ("sort", str(ctx.device), schema_sig(self.input.schema),
                         tuple(asc for _, asc in self.keys),
                         exprs_sig([e for e, _ in self.keys])), program)
            return self._compiled

    def device_programs(self, ctx: TaskContext):
        return [self._prepared(ctx)]

    def _label(self):
        k = ", ".join(f"{e} {'ASC' if asc else 'DESC'}" for e, asc in self.keys)
        f = f" fetch={self.fetch}" if self.fetch is not None else ""
        return f"SortExec: [{k}]{f}"


class LimitExec(ExecutionPlan):
    def __init__(self, input: ExecutionPlan, n: int):
        self.input = input
        self.n = n
        self._schema = input.schema

    def children(self):
        return [self.input]

    def output_partition_count(self):
        return 1

    def execute(self, partition: int, ctx: TaskContext) -> List[ColumnBatch]:
        with ctx.op_span(self):
            parts = []
            for p in range(self.input.output_partition_count()):
                parts.extend(self.input.execute(p, ctx))
            big = concat_batches(self.input.schema, parts, device=ctx.device)
            order = K.compaction_order(big.mask)[:max(self.n, 1)]
            cols = K.gather_columns(order, {**big.columns, "__mask": big.mask})
            mask = K.window_mask(cols.pop("__mask"), 0, self.n)
            return [ColumnBatch(self._schema, cols, mask, big.dicts)]

    def _label(self):
        return f"LimitExec: {self.n}"


class CoalescePartitionsExec(ExecutionPlan):
    """Merges all input partitions into one."""

    def __init__(self, input: ExecutionPlan):
        self.input = input
        self._schema = input.schema

    def children(self):
        return [self.input]

    def output_partition_count(self):
        return 1

    def output_partitioning(self):
        return Partitioning.single()

    def execute(self, partition: int, ctx: TaskContext) -> List[ColumnBatch]:
        with ctx.op_span(self):
            out = []
            for p in range(self.input.output_partition_count()):
                out.extend(self.input.execute(p, ctx))
            return out
