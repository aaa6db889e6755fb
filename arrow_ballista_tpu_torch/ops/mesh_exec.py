"""Mesh-fused operators: whole stage pairs as one program over the ranks of
the in-process mesh.

Mirrors arrow_ballista_tpu/ops/mesh_exec.py.  Where the file-shuffle path
materializes the exchange (partial-agg tasks -> shuffle files -> final-agg
tasks), the mesh path runs

    derive keys/values -> partial agg -> all_to_all -> final agg

over the ranks of a mesh (parallel/distributed.py), and no byte touches
the host or disk.  Enabled per session by ``ballista.shuffle.mesh``; the
planner keeps the file-shuffle stage pair wherever the pattern does not
fit.  On the card the derive is one generated kernel per rank batch
(compile/fused.py ``mesh_derive``), traced when the operator is planned.

The reference collapses each mesh-sharded result to one device with a
host hop (its ``_unshard``); here the ranks' outputs are concatenated in
rank order on the session's device, which is the reference's row order.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from ..compile import fused as F
from ..models import expr as E
from ..models.batch import ColumnBatch, concat_batches, torch_dtype
from ..models.schema import Field, Schema
from ..utils.config import AGG_CAPACITY, JOIN_OUTPUT_FACTOR, MESH_BROADCAST_ROWS
from ..utils.errors import CapacityError
from . import kernels as K
from .expressions import ExprCompiler
from .operators import (AggSpec, HashAggregateExec, _full_column, _py_scalar, null_check_of,
                        valid_of)
from .physical import ExecutionPlan, Partitioning, TaskContext, deferred_rows


def _pow2(n: int) -> int:
    """A capacity rounded up to a power of two (at least 64), so skewed
    partitions share the few capacities a stage's runs are keyed on."""
    return max(64, 1 << max(0, int(n) - 1).bit_length())


def _unshard(x, device) -> torch.Tensor:
    """A rank-listed output concatenated in rank order on ``device`` (a
    replicated output is one tensor already)."""
    if isinstance(x, (list, tuple)):
        return torch.cat([t.to(device) for t in x])
    return x.to(device)


# --- shared pieces of the two mesh aggregate operators ---------------------


_HIDDEN_PREFIX = "__vld_"


def _hidden_name(agg_name: str) -> str:
    return _HIDDEN_PREFIX + agg_name


def _hidden_base(hname: str) -> str:
    return hname[len(_HIDDEN_PREFIX):]


def compile_agg_exprs(in_schema, group_exprs, aggs, device, xp=None):
    """(compiler, key closures, value closures) of a mesh aggregate, over
    TorchOps on ``device`` or, with ``xp`` (CudaOps), traced into C."""
    comp = ExprCompiler(in_schema, "device", device, xp=xp)
    key_c = [(comp.compile(e), n) for e, n in group_exprs]
    val_c = []
    for a in aggs:
        cc = comp.compile(a.operand) if a.operand is not None else None
        val_c.append((cc, a, null_check_of(cc, a.operand, in_schema)))
    return comp, key_c, val_c


def _agg_specs(val_c):
    """(name, how) pairs to feed the distributed aggregate, plus the hidden
    per-group valid-count states that let all-NULL sum/min/max groups be
    restored to NULL after the exchange."""
    specs, hidden = [], []
    for cc, a, nc in val_c:
        if a.func == "count":
            # count(*) counts live rows; a nullable count(col) sums the
            # validity indicator instead
            specs.append((a.name, "sum" if nc is not None else "count"))
        else:
            specs.append((a.name, a.func))
            if nc is not None:
                hidden.append((_hidden_name(a.name), "sum"))
    return specs, hidden


def derive_columns(xp, key_c, val_c, cols, mask, aux, names=None):
    """The reference's per-shard derive (mesh_exec.py:98): group keys and
    aggregate operand columns, NULL operand rows neutralized per aggregate
    (0 for sum, the fold identity for min/max, a 0/1 indicator for count)
    and tracked in hidden validity columns -> [(name, column)], or only
    those in ``names``.  ``xp`` is TorchOps (the twin), or the CudaOps that
    traces the same steps into the generated kernel."""
    n = mask.shape[0]
    out = []

    def emit(name, v):
        if names is None or name in names:
            out.append((name, v))

    for kc, name in key_c:
        emit(name, _full_column(kc.fn(cols, aux), n))
    for cc, a, nc in val_c:
        if cc is None:
            emit(a.name, xp.full((n,), 1, dtype=np.int64))
            continue
        v = _full_column(cc.fn(cols, aux), n)
        if nc is None:
            emit(a.name, xp.full((n,), 1, dtype=np.int64) if a.func == "count" else v)
            continue
        valid = valid_of(v, nc, xp)
        if a.func == "count":
            emit(a.name, xp.astype(valid, np.int64))
        elif a.func == "sum":
            emit(a.name, xp.where(valid, v, xp.zeros((), dtype=v.dtype)))
        elif a.func == "min":
            emit(a.name, xp.where(valid, v, xp.full((), K._max_ident(v.dtype), dtype=v.dtype)))
        else:  # max
            emit(a.name, xp.where(valid, v, xp.full((), K._min_ident(v.dtype), dtype=v.dtype)))
        if a.func in ("sum", "min", "max"):
            emit(_hidden_name(a.name), xp.astype(valid, np.int64))
    return out


def _make_derive(program: "F.MeshDeriveProgram", compiled, aux):
    """Per-rank projection: the derived columns of one rank batch (the
    generated kernel on the card), its lookup tables on the rank's
    device."""
    by_device: Dict[torch.device, dict] = {}

    def derive(cols, mask):
        dev = mask.device
        a = by_device.get(dev)
        if a is None:
            a = by_device[dev] = {k: v.to(dev) for k, v in aux.items()}
        return F.mesh_derive(program, compiled, cols, mask, a), mask

    return derive


def _shard_batch(columns, mask, mesh, n_dev: int):
    """Rows data-parallel over the mesh, padded to a rank-count multiple:
    padded rows are masked out, and the capacities count them.  Returns
    (cols, mask, padded_rows), each column and the mask listed over the
    ranks."""
    from ..parallel.mesh import shard_rows

    padded = -(-mask.shape[0] // n_dev) * n_dev
    return ({k: shard_rows(v, mesh) for k, v in columns.items()},
            shard_rows(mask, mesh, fill=False), padded)


def _agg_key_ranges(key_c, dicts):
    """Static per-key bounds for the dense grouping path: dictionary-code
    ranges for strings, {0,1} for bools, None otherwise."""
    return tuple(
        (-1, int(len(kc.dict_fn(dicts))) - 1)
        if kc.dtype.is_string and kc.dict_fn is not None
        else ((0, 1) if kc.dtype.kind == "bool" else None)
        for kc, _n in key_c)


def _finish_states(schema, key_c, val_c, ks, vs, msk, big_dicts, device, hidden_specs=()):
    """The mesh program's outputs as one ColumnBatch on ``device``, values
    cast to the operator's declared dtypes.  ``vs`` carries the main states
    followed by the hidden valid counts (``hidden_specs`` order); all-NULL
    groups are restored to the output sentinel here, after the exchange."""
    n_main = len(val_c)
    out_cols: Dict[str, torch.Tensor] = {}
    dicts: Dict[str, np.ndarray] = {}
    for (kc, name), arr in zip(key_c, ks):
        out_cols[name] = _unshard(arr, device)
        if kc.dict_fn is not None:
            dicts[name] = kc.dict_fn(big_dicts)
    for (_cc, a, _nc), arr in zip(val_c, vs[:n_main]):
        want = torch_dtype(schema.field(a.name).dtype.np_dtype)
        out_cols[a.name] = _unshard(arr, device).to(want)
    for (hname, _how), cnt in zip(hidden_specs, vs[n_main:]):
        name = _hidden_base(hname)
        f = schema.field(name)
        col = out_cols[name]
        sent = torch.full((), _py_scalar(f.dtype.null_sentinel), dtype=col.dtype, device=device)
        out_cols[name] = torch.where(_unshard(cnt, device) > 0, col, sent)
    return ColumnBatch(schema, out_cols, _unshard(msk, device), dicts)


def _gather_input(plan: ExecutionPlan, ctx: TaskContext) -> List[ColumnBatch]:
    batches = []
    for p in range(plan.output_partition_count()):
        batches.extend(plan.execute(p, ctx))
    return batches


class MeshAggregateExec(ExecutionPlan):
    """Fused grouped aggregation over every rank of the mesh.

    Replaces HashAggregateExec(final) <- Repartition(hash) <-
    HashAggregateExec(partial) when the mesh path is enabled.  Output is a
    single partition holding all groups (rank d owns the key-hash bucket
    d; results are concatenated in rank order)."""

    def __init__(self, input: ExecutionPlan, group_exprs: List[Tuple[E.Expr, str]],
                 aggs: List[AggSpec]):
        self.input = input
        self.group_exprs = group_exprs
        self.aggs = aggs
        in_schema = input.schema
        fields = [Field(n, e.dtype(in_schema)) for e, n in group_exprs]
        ref = HashAggregateExec(input, group_exprs, aggs, mode="single")
        for a in aggs:
            fields.append(ref.schema.field(a.name))
        self._schema = Schema(fields)
        self._compiled = None
        self._derive = F.MeshDeriveProgram(in_schema, group_exprs, aggs, self._label())

    @staticmethod
    def eligible(group_exprs, aggs, in_schema) -> bool:
        if not group_exprs:
            return False  # global aggregates: the plain path is already cheap
        for a in aggs:
            if a.name.startswith(_HIDDEN_PREFIX):
                # the hidden validity columns ride in-band under this prefix;
                # a user aggregate aliased into it would collide with them
                return False
            if a.func not in ("sum", "count", "min", "max"):
                return False
            if a.operand is not None:
                # nullable operands are fused (derive neutralizes NULL rows,
                # hidden valid counts ride the exchange); floats stay off the
                # mesh path (the partial+merge sum order differs from the
                # file path's)
                try:
                    if a.operand.dtype(in_schema).is_float:
                        return False
                except Exception:  # noqa: BLE001
                    return False
        for e, _ in group_exprs:
            try:
                if e.dtype(in_schema).is_float:
                    return False
            except Exception:  # noqa: BLE001
                return False
        return True

    def children(self):
        return [self.input]

    def output_partition_count(self):
        return 1

    def output_partitioning(self):
        return Partitioning.single()

    def execute(self, partition: int, ctx: TaskContext) -> List[ColumnBatch]:
        with ctx.op_span(self):
            return self._execute(partition, ctx)

    def _compile(self, ctx):
        with self.build_lock():
            if self._compiled is None:
                self._compiled = compile_agg_exprs(self.input.schema, self.group_exprs,
                                                   self.aggs, ctx.device)
            return self._compiled

    def _execute(self, partition: int, ctx: TaskContext) -> List[ColumnBatch]:
        from ..parallel.distributed import (distributed_dense_aggregate,
                                            distributed_filter_aggregate)
        from ..parallel.mesh import MESH_DISPATCH_LOCK, make_mesh, mesh_axis_size

        assert partition == 0
        in_schema = self.input.schema
        big = concat_batches(in_schema, _gather_input(self.input, ctx), device=ctx.device)

        mesh = make_mesh()
        n_dev = mesh_axis_size(mesh)
        comp, key_c, val_c = compiled = self._compile(ctx)
        aux = comp.aux_arrays(big.dicts)

        key_names = [n for _, n in key_c]
        specs, hidden = _agg_specs(val_c)
        agg_specs = specs + hidden
        derive = _make_derive(self._derive, compiled, aux)
        cols, mask, padded = _shard_batch(big.columns, big.mask, mesh, n_dev)

        cap = ctx.config.get(AGG_CAPACITY)
        # partial states are bounded by the rank's rows; the final aggregate
        # is NOT (hash skew can land every group on one rank), so its bound
        # follows the config knob
        partial_cap = max(256, min(cap, padded // n_dev + 1))
        final_cap = max(256, min(cap, padded + 1))
        key_ranges = _agg_key_ranges(key_c, big.dicts)
        domain = K.dense_domain(key_ranges)
        if domain is not None:
            # dense domain: slot-aligned states merge by one sum/min/max per
            # aggregate (K18); overflow here can only mean a key escaped its
            # declared range
            run = distributed_dense_aggregate(mesh, derive, key_names, agg_specs, key_ranges,
                                              domain)
            with MESH_DISPATCH_LOCK:
                fk, fv, fmask, overflow = run(cols, mask)
            if bool(overflow):
                raise CapacityError(
                    "mesh dense aggregation saw keys outside their declared "
                    "ranges (dictionary/batch mismatch)")
            self.metrics().add("dense_reduce_collective", 1)
        else:
            run = distributed_filter_aggregate(
                mesh, derive, key_names, agg_specs,
                partial_capacity=partial_cap, final_capacity=final_cap,
                key_ranges=key_ranges)
            with MESH_DISPATCH_LOCK:
                fk, fv, fmask, overflow = run(cols, mask)
            if bool(overflow):
                raise CapacityError(
                    f"mesh aggregation exceeded its group capacity "
                    f"(partial {partial_cap}/device, final {final_cap}/device); "
                    f"raise {AGG_CAPACITY}")

        result = _finish_states(self._schema, key_c, val_c, fk, fv, fmask, big.dicts,
                                ctx.device, hidden_specs=hidden)
        # deferred: the count becomes host-known when a downstream copy
        # materializes this batch
        deferred_rows(self.metrics(), "output_rows", result)
        self.metrics().add("mesh_devices", n_dev)
        return [result]

    def _label(self):
        g = ", ".join(n for _, n in self.group_exprs)
        a = ", ".join(f"{x.func}({x.name})" for x in self.aggs)
        return f"MeshAggregateExec(fused partial+all_to_all+final): groupBy=[{g}] aggr=[{a}]"


class MeshPartialAggregateExec(ExecutionPlan):
    """The hybrid composition: the partial aggregate of a file-shuffled
    stage pair, fused over the executing process's mesh.

    Where MeshAggregateExec fuses the whole exchange in one task, this
    operator keeps the stage structure (one task per input partition, file
    shuffle between stages) and uses the mesh only within each task: rows
    shard across the ranks, every rank reduces its rows to group states,
    and the states ship through the ordinary shuffle to the final
    aggregate.  Output schema and dtypes are HashAggregateExec(partial)'s,
    so the downstream RepartitionExec and final HashAggregateExec are
    untouched."""

    def __init__(self, input: ExecutionPlan, group_exprs: List[Tuple[E.Expr, str]],
                 aggs: List[AggSpec]):
        self.input = input
        self.group_exprs = group_exprs
        self.aggs = aggs
        ref = HashAggregateExec(input, group_exprs, aggs, mode="partial")
        self._schema = ref.schema
        self._compiled = None
        self._runs: Dict[tuple, object] = {}
        self._derive = F.MeshDeriveProgram(input.schema, group_exprs, aggs, self._label())

    eligible = MeshAggregateExec.eligible
    _compile = MeshAggregateExec._compile

    def children(self):
        return [self.input]

    def output_partition_count(self):
        return self.input.output_partition_count()

    def execute(self, partition: int, ctx: TaskContext) -> List[ColumnBatch]:
        with ctx.op_span(self):
            return self._execute(partition, ctx)

    def _execute(self, partition: int, ctx: TaskContext) -> List[ColumnBatch]:
        from ..parallel.distributed import distributed_partial_aggregate
        from ..parallel.mesh import MESH_DISPATCH_LOCK, make_mesh, mesh_axis_size

        in_schema = self.input.schema
        big = concat_batches(in_schema, self.input.execute(partition, ctx), device=ctx.device)

        mesh = make_mesh()
        n_dev = mesh_axis_size(mesh)
        comp, key_c, val_c = compiled = self._compile(ctx)
        aux = comp.aux_arrays(big.dicts)

        key_names = [n for _, n in key_c]
        specs, hidden = _agg_specs(val_c)
        agg_specs = specs + hidden
        cols, mask, padded = _shard_batch(big.columns, big.mask, mesh, n_dev)

        cap = ctx.config.get(AGG_CAPACITY)
        per_dev_cap = max(64, min(cap, padded // n_dev + 1))
        key_ranges = _agg_key_ranges(key_c, big.dicts)
        domain = K.dense_domain(key_ranges)
        if domain is not None:
            per_dev_cap = min(per_dev_cap, domain)
        # one run per (capacity, key ranges, mesh, lookup tables) serves a
        # stage's partition tasks, which share this operator
        aux_key = tuple(sorted((k, id(v)) for k, v in aux.items()))
        run_key = (padded, per_dev_cap, key_ranges, mesh, aux_key)
        with self.build_lock():
            run = self._runs.get(run_key)
            if run is None:
                run = distributed_partial_aggregate(
                    mesh, _make_derive(self._derive, compiled, aux), key_names, agg_specs,
                    per_dev_cap, key_ranges=key_ranges)
                self._runs[run_key] = run
        with MESH_DISPATCH_LOCK:
            pk, pv, pmask, overflow = run(cols, mask)
        if bool(overflow):
            raise CapacityError(
                f"mesh partial aggregation exceeded {per_dev_cap} "
                f"groups/device; raise {AGG_CAPACITY}")

        # all-NULL partial states become sentinels here, as in the file
        # partial mode: the downstream final aggregate's value-based NULL
        # check then skips them
        result = _finish_states(self._schema, key_c, val_c, pk, pv, pmask, big.dicts,
                                ctx.device, hidden_specs=hidden)
        deferred_rows(self.metrics(), "output_rows", result)
        self.metrics().add("mesh_devices", n_dev)
        return [result]

    def _label(self):
        g = ", ".join(n for _, n in self.group_exprs)
        a = ", ".join(f"{x.func}({x.name})" for x in self.aggs)
        return (f"MeshPartialAggregateExec(per-host mesh, file exchange): "
                f"groupBy=[{g}] aggr=[{a}]")


class MeshJoinExec(ExecutionPlan):
    """Fused partitioned equi-join over every rank of the mesh.

    Replaces JoinExec(partitioned) <- Repartition(hash) x2 when the mesh
    path is enabled: both sides all_to_all by key bucket (or the small
    build side all_gathered), then a per-rank sorted-build / probe join.
    Results equal the file-shuffle JoinExec path's."""

    def __init__(self, left: ExecutionPlan, right: ExecutionPlan,
                 on: List[Tuple[E.Expr, E.Expr]], join_type: str = "inner"):
        assert join_type in ("inner", "left", "semi", "anti")
        self.left = left
        self.right = right
        self.on = on
        self.join_type = join_type
        if join_type in ("semi", "anti"):
            self._schema = left.schema
        elif join_type == "left":
            self._schema = Schema(
                list(left.schema)
                + [Field(f.name, f.dtype, nullable=True) for f in right.schema])
        else:
            self._schema = left.schema.merge(right.schema)
        self._compiled = None
        self._runs: Dict[tuple, object] = {}

    @staticmethod
    def eligible(on, join_type, filter, lsch, rsch) -> bool:
        if join_type not in ("inner", "left", "semi", "anti"):
            return False
        if filter is not None:
            return False  # pair filters not fused yet
        for le, re_ in on:
            for e, sch in ((le, lsch), (re_, rsch)):
                try:
                    dt = e.dtype(sch)
                except Exception:  # noqa: BLE001
                    return False
                if dt.is_float:
                    return False
        return True

    def children(self):
        return [self.left, self.right]

    def output_partition_count(self):
        return 1

    def output_partitioning(self):
        return Partitioning.single()

    def _programs(self, ctx: TaskContext):
        """K19: each side's join keys (``__jk<i>``, string keys as value
        hashes) as a column program, and each side's key validity (NULL
        numeric keys never match) as a mask program, None where no key
        column is nullable.  Shared across a stage's tasks (MeshTaskJoinExec
        runs one task per partition)."""
        from ..compile.programs import OperatorProgram

        def keys(sch, exprs, label):
            def build(xp, dev):
                comp = ExprCompiler(sch, "device", dev, xp=xp)
                ks = [comp.compile_key(e) for e in exprs]

                def body(_xp, cols, mask, auxs):
                    return [(f"__jk{i}", _full_column(kc.fn(cols, auxs[0]), mask.shape[0]))
                            for i, kc in enumerate(ks)]

                return [comp], body, [kc.dtype.is_string for kc in ks]

            return OperatorProgram("columns", label, sch, build, ctx.device)

        def valid(sch, exprs, label):
            if not any(ExprCompiler(sch, "device", ctx.device).nullable_refs(e) for e in exprs):
                return None

            def build(xp, dev):
                comp = ExprCompiler(sch, "device", dev, xp=xp)
                fns = [f for f in (comp.validity_fn(comp.nullable_refs(e)) for e in exprs)
                       if f is not None]

                def body(_xp, cols, mask, auxs):
                    for f in fns:
                        mask = mask & f(cols, auxs[0])
                    return mask

                return [comp], body, None

            return OperatorProgram("mask", label, sch, build, ctx.device)

        with self.build_lock():
            if self._compiled is None:
                lsch, rsch = self.left.schema, self.right.schema
                lex, rex = [le for le, _ in self.on], [re_ for _, re_ in self.on]
                self._compiled = (keys(lsch, lex, "mesh join probe keys"),
                                  keys(rsch, rex, "mesh join build keys"),
                                  valid(lsch, lex, "mesh join probe key validity"),
                                  valid(rsch, rex, "mesh join build key validity"))
            return self._compiled

    def device_programs(self, ctx: TaskContext):
        return [p for p in self._programs(ctx) if p is not None]

    def execute(self, partition: int, ctx: TaskContext) -> List[ColumnBatch]:
        with ctx.op_span(self):
            return self._execute(partition, ctx)

    def _execute(self, partition: int, ctx: TaskContext) -> List[ColumnBatch]:
        assert partition == 0
        lsch, rsch = self.left.schema, self.right.schema
        probe = concat_batches(lsch, _gather_input(self.left, ctx), device=ctx.device).shrink()
        build = concat_batches(rsch, _gather_input(self.right, ctx), device=ctx.device).shrink()
        return self._join_batches(probe, build, ctx)

    def _join_batches(self, probe: ColumnBatch, build: ColumnBatch,
                      ctx: TaskContext) -> List[ColumnBatch]:
        from ..parallel.distributed import distributed_broadcast_join, distributed_hash_join
        from ..parallel.mesh import MESH_DISPATCH_LOCK, make_mesh, mesh_axis_size

        lsch, rsch = self.left.schema, self.right.schema
        mesh = make_mesh()
        n_dev = mesh_axis_size(mesh)

        from ..compile.programs import operator_program

        lkeys, rkeys, lvalid, rvalid = self._programs(ctx)
        sflags = list(lkeys.extra)

        def with_keys(batch, prog):
            return {**batch.columns, **operator_program(prog, batch.columns, batch.mask,
                                                        prog.aux_arrays(batch.dicts))}

        pcols = with_keys(probe, lkeys)
        bcols = with_keys(build, rkeys)

        # NULL join keys never match (SQL): drop NULL-key build rows always;
        # drop NULL-key probe rows too for inner/semi (left/anti keep them:
        # they surface as unmatched).  String-key NULLs are excluded in the
        # join through the NULL_KEY_SENTINEL; this covers nullable numerics.
        def key_valid(prog, batch):
            if prog is None:  # no nullable key column
                return batch.mask
            return operator_program(prog, batch.columns, batch.mask,
                                    prog.aux_arrays(batch.dicts))

        bmask_in = key_valid(rvalid, build)
        pmask_in = probe.mask
        if self.join_type in ("inner", "semi"):
            pmask_in = key_valid(lvalid, probe)

        dp, dpm, p_rows = _shard_batch(pcols, pmask_in, mesh, n_dev)
        db, dbm, b_rows = _shard_batch(bcols, bmask_in, mesh, n_dev)

        out_factor = ctx.config.get(JOIN_OUTPUT_FACTOR)
        rfill = {f.name: _py_scalar(f.dtype.null_sentinel) for f in rsch}
        sentinel = K._s64(int(ExprCompiler.NULL_KEY_SENTINEL))
        broadcast = build.num_rows <= ctx.config.get(MESH_BROADCAST_ROWS)

        if broadcast:
            # small build side: all_gather it, probe rows never move; the
            # output bound is the rank's probe rows x the fan-out factor
            out_cap = _pow2(out_factor * (p_rows // n_dev))
            attempts = 0
            while True:
                with self.build_lock():
                    run = self._runs.get(("bc", mesh, out_cap))
                    if run is None:
                        run = distributed_broadcast_join(
                            mesh, len(self.on), list(lsch.names()),
                            list(rsch.names()), self.join_type, out_cap,
                            rfill, string_key_flags=sflags,
                            null_key_sentinel=sentinel)
                        self._runs[("bc", mesh, out_cap)] = run
                with MESH_DISPATCH_LOCK:
                    out_cols, out_mask, overflow = run((dp, dpm), (db, dbm))
                if not bool(overflow):
                    break
                attempts += 1
                if attempts > 3:
                    raise CapacityError(
                        f"mesh broadcast join overflowed its output capacity "
                        f"({out_cap}) after retries")
                out_cap *= 2
                self.metrics().add("capacity_recompiles", 1)
            self.metrics().add("broadcast_joins", 1)
        else:
            # per-rank shuffle capacity: worst case every row of a side
            # hashes to one bucket of one rank's send buffer; factor 2 covers
            # skew, an overflow re-runs at twice the capacity
            shuf_cap = _pow2(2 * max(p_rows, b_rows) // n_dev)
            # per-rank output bound: the EXPECTED per-rank probe share x the
            # fan-out factor; too small re-runs through the doubling, too
            # large allocates outputs far past the result every run
            out_cap = _pow2(out_factor * (p_rows // n_dev))

            attempts = 0
            while True:
                with self.build_lock():
                    run = self._runs.get(("part", mesh, shuf_cap, out_cap))
                    if run is None:
                        run = distributed_hash_join(
                            mesh, len(self.on), list(lsch.names()),
                            list(rsch.names()), self.join_type, shuf_cap,
                            out_cap, rfill, string_key_flags=sflags,
                            null_key_sentinel=sentinel)
                        self._runs[("part", mesh, shuf_cap, out_cap)] = run
                with MESH_DISPATCH_LOCK:
                    out_cols, out_mask, overflow = run((dp, dpm), (db, dbm))
                if not bool(overflow):
                    break
                attempts += 1
                if attempts > 3:
                    raise CapacityError(
                        "mesh join overflowed its shuffle/output capacity "
                        f"(shuffle {shuf_cap}, out {out_cap}) after retries")
                shuf_cap *= 2
                out_cap *= 2
                self.metrics().add("capacity_recompiles", 1)
            self.metrics().add("partitioned_joins", 1)

        dicts = dict(probe.dicts)
        if self.join_type in ("inner", "left"):
            dicts.update(build.dicts)
        result = ColumnBatch(self._schema,
                             {k: _unshard(v, ctx.device) for k, v in out_cols.items()},
                             _unshard(out_mask, ctx.device), dicts)
        deferred_rows(self.metrics(), "output_rows", result)
        self.metrics().add("mesh_devices", n_dev)
        return [result]

    def _label(self):
        on = ", ".join(f"{l} = {r}" for l, r in self.on)
        return (f"MeshJoinExec({self.join_type}, fused all_to_all both sides): "
                f"on=[{on}]")


class MeshTaskJoinExec(MeshJoinExec):
    """The hybrid join composition: the per-partition join of a
    file-shuffled stage, fused over the executing process's mesh.

    Keeps the partitioned stage structure (both sides hash-repartitioned
    by the ordinary shuffle, one join task per partition) and uses the mesh
    only within each task: the partition's probe rows shard across the
    ranks and its build side is all_gathered (or all_to_all'd when large).
    It joins MeshPartialAggregateExec on the aggregate side."""

    def output_partition_count(self):
        return self.left.output_partition_count()

    def output_partitioning(self):
        return self.left.output_partitioning()

    def _execute(self, partition: int, ctx: TaskContext) -> List[ColumnBatch]:
        probe = concat_batches(self.left.schema, self.left.execute(partition, ctx),
                               device=ctx.device).shrink()
        build = concat_batches(self.right.schema, self.right.execute(partition, ctx),
                               device=ctx.device).shrink()
        return self._join_batches(probe, build, ctx)

    def _label(self):
        on = ", ".join(f"{l} = {r}" for l, r in self.on)
        return (f"MeshTaskJoinExec({self.join_type}, per-task mesh, "
                f"file exchange): on=[{on}]")
