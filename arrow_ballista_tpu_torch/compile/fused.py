"""FusedStageExec: one generated kernel for a whole operator chain.

Mirrors arrow_ballista_tpu/compile/fused.py.  A fused chain's row steps
(filter masks, projection columns, renames) and, for an aggregate-headed
chain, the partial aggregate's own key and value evaluation run as one
kernel generated for the chain (compile/codegen.py), so the intermediate
batches of the interpreted chain never exist:

- K12 ``fused_rows``: one elementwise pass writes every output column and
  the mask (csrc/fused_rows.cuh + the generated row function);
- K13 ``fused_agg``, dense path: the generated row function feeds K1's
  accumulator core directly (csrc/dense_agg.cuh), each aggregate's fold
  fixed at compile time, so the key and value columns never exist in
  device memory; the same launch compacts the groups;
- K13 ``fused_agg``, sort path (no dense key domain): the generated
  kernel writes the key and value columns in K12's form, then K4 orders
  them and K8 aggregates, as ``kernels.grouped_aggregate`` does.

``fused_rows_plain`` and ``fused_agg_plain`` are the interpreted chain:
the same closures over TorchOps, then the K1, K2, K4 and K8 twins.  A
wrapper takes its twin only for tensors on the CPU; on the card it
launches the generated kernel, and a build or launch error raises.  Unlike
the reference, no error latches the interpreted chain: the port's fused
stage never falls back on an error (its ``fused_fallbacks`` metric stays
0).  Two things hand a partition to the interpreted chain, as in the
reference: the adaptive passthrough probe, which latches the aggregate's
per-row states and the stage's interpreted path for sibling tasks
(``fused_passthrough_fallbacks``), and a memory-governor denial, which
delegates that one partition to the interpreted aggregate's spill path
(``fused_spill_delegations``).

K15 ``passthrough_rows`` lives here too: the per-row partial states of a
latched aggregate (``ops/operators.py`` ``passthrough_states``), traced
over ``CudaOps`` into a K12-form kernel generated per aggregate.  So does
``mesh_derive``: the mesh aggregate's key and value columns
(``ops/mesh_exec.py`` ``derive_columns``), generated the same way.

Plan-shape contract: ``ops[0]`` is the chain head (closest to the shuffle
writer), ``ops[-1]`` the tail, and the ops keep their ``.input`` links, so
``self.input`` is a property over ``ops[-1].input`` and the planner walks,
AQE grafts and rollbacks treat a fused stage like any single-input
operator.
"""
from __future__ import annotations

import ctypes
import weakref
from typing import Dict, List, Optional

import numpy as np
import torch

from ..models.batch import ColumnBatch, concat_batches
from ..ops import _cuda
from ..ops import kernels as K
from ..ops.expressions import TorchOps
from ..ops.operators import (FilterExec, HashAggregateExec, ProjectionExec, RenameExec,
                             _full_column, _state_bytes, agg_inputs, passthrough_states,
                             poor_reduction)
from ..ops.physical import (ExecutionPlan, TaskContext, deferred_count, deferred_rows,
                            schema_sig, shared_program)
from ..utils.errors import CapacityError, InternalError
from . import codegen as G
from .chains import chain_fingerprint
from .programs import GeneratedProgram, _FusedIn, _FusedOut, generate_aliased  # noqa: F401


def _row_step(op: ExecutionPlan, scalars, device, xp=None):
    """(trace_fn, compiler or None, dict_transform) of one row operator;
    ``trace_fn(cols, mask, aux) -> (cols, mask)``.  With ``xp`` (CudaOps)
    the same closures trace into generated C."""
    if isinstance(op, FilterExec):
        comp, pred = op._compile(scalars, device, xp=xp)

        def tr_filter(cols, mask, aux, pred=pred):
            return cols, mask & pred.fn(cols, aux)

        return tr_filter, comp, lambda dicts: dicts
    if isinstance(op, ProjectionExec):
        comp, compiled = op._compile(scalars, device, xp=xp)

        def tr_proj(cols, mask, aux, compiled=compiled):
            n = mask.shape[0]
            return {name: _full_column(c.fn(cols, aux), n) for c, name in compiled}, mask

        def dicts_proj(dicts, compiled=compiled):
            return {n: c.dict_fn(dicts) for c, n in compiled if c.dict_fn is not None}

        return tr_proj, comp, dicts_proj
    if isinstance(op, RenameExec):
        mapping = list(op._mapping)

        def tr_rename(cols, mask, aux, mapping=mapping):
            if xp is not None:
                return G.RenamedColumns(cols, mapping), mask
            return {new: cols[old] for old, new in mapping}, mask

        def dicts_rename(dicts, mapping=mapping):
            return {new: dicts[old] for old, new in mapping if old in dicts}

        return tr_rename, None, dicts_rename
    raise InternalError(f"operator {type(op).__name__} is not fusable as a row step")


def _label_of(ops) -> str:
    return " <- ".join(type(o).__name__ for o in ops)


def generate(ops: List[ExecutionPlan], ctx: TaskContext) -> G.GeneratedChain:
    """Trace a chain (head first) into its generated source."""
    agg = ops[0] if isinstance(ops[0], HashAggregateExec) else None
    row_ops = ops[1:] if agg is not None else ops
    trace = G.Trace()
    xp = G.CudaOps(trace, ctx.device)
    cols = G.InputColumns(trace, ops[-1].input.schema)
    mask = trace.bind("in.mask[i]", torch.bool, 1)
    for step, op in enumerate(reversed(row_ops)):
        tr, comp, _ = _row_step(op, ctx.scalars, ctx.device, xp)
        cols, mask = tr(cols, mask, G.trace_aux(trace, step, comp))
    if agg is None:
        outputs = [(f.name, cols[f.name]) for f in ops[0].schema]
        return G.render(trace, _label_of(ops), outputs, mask)
    compiled = agg._build_compiled(ctx, agg.input.schema, xp=xp)
    aux = G.trace_aux(trace, len(row_ops), compiled[0])
    keys, vals = agg_inputs(xp, compiled, cols, mask, aux)
    outputs = [(f"__key{j}", k) for j, k in enumerate(keys)] + \
        [(f"__val{a}", v) for a, (v, _how) in enumerate(vals)]
    return G.render(trace, _label_of(ops), outputs, mask, keys, vals)


def codegen_doubt(node: ExecutionPlan) -> Optional[str]:
    """Why the code generator cannot emit ``node`` alone (None: it can).
    Plan time: nothing is built and nothing runs on a device."""
    if isinstance(node, RenameExec):
        return None
    try:
        generate([node], TaskContext(device=torch.device("cpu")))
    except Exception as e:  # noqa: BLE001 — any doubt keeps the operator interpreted
        return f"{type(e).__name__}: {e}"
    return None


def generate_passthrough(agg: HashAggregateExec, ctx: TaskContext):
    """Trace an aggregate's per-row states into K15's source -> (chain,
    aliases).  A state or key that is a plain read of an input column of
    its own type (a key, the sum of a non-null column of the state's type)
    is that column: ``aliases`` maps its name to the column, and the kernel
    writes only the states it must compute (casts, NULL sentinels, count
    0/1 columns), in K12's form without the mask."""
    def trace_states(names=None):
        trace = G.Trace()
        xp = G.CudaOps(trace, ctx.device)
        pt = agg._build_passthrough(ctx, agg.input.schema, xp=xp)
        cols = G.InputColumns(trace, agg.input.schema)
        mask = G.CVal(trace, "in.mask[i]", torch.bool, 1)  # its shape only
        return trace, passthrough_states(xp, pt, cols, mask, G.trace_aux(trace, 0, pt[0]),
                                         names)

    gen, aliases, _names = generate_aliased(trace_states, f"passthrough {agg._label()}")
    return gen, aliases


class PassthroughProgram(GeneratedProgram):
    """K15 for one aggregate: the per-row state closures (the twin) and,
    traced at the first call on the card, the generated source and the
    states that alias an input column."""

    launch_name = "passthrough_rows"

    def __init__(self, agg: HashAggregateExec, ctx: TaskContext):
        self.agg = agg
        self._ctx = ctx
        self.compiled = agg._build_passthrough(ctx, agg.input.schema)
        self.names = [n for _c, n in self.compiled[1]] + [it[2] for it in self.compiled[2]]
        self._gen: Optional[G.GeneratedChain] = None
        self._aliases: Dict[str, str] = {}

    @property
    def gen(self) -> G.GeneratedChain:
        if self._gen is None:
            self._gen, self._aliases = generate_passthrough(self.agg, self._ctx)
        return self._gen

    @property
    def aliases(self) -> Dict[str, str]:
        """State name -> the input column it is (none computed)."""
        _ = self.gen
        return self._aliases


def passthrough_rows_plain(program: PassthroughProgram, cols, mask, aux):
    """K15's twin: the per-row states over TorchOps -> {name: column}."""
    return dict(passthrough_states(TorchOps(mask.device), program.compiled, cols, mask, aux))


def passthrough_rows(program: PassthroughProgram, cols, mask, aux):
    """K15: the per-row partial states -> {name: column}.  A state that is
    an input column is that column, as in the twin; one generated pass
    writes the rest, and none runs when nothing is left to compute."""
    if K._is_cpu(mask):
        return passthrough_rows_plain(program, cols, mask, aux)
    written = {}
    if program.gen.outputs:
        outs, _ = program.launch_rows(cols, mask, [aux], with_mask=False)
        written = {name: t for (name, _dt), t in zip(program.gen.outputs, outs)}
    return {name: written[name] if name in written else cols[program.aliases[name]]
            for name in program.names}


class MeshDeriveProgram(GeneratedProgram):
    """The mesh aggregate's derive (ops/mesh_exec.py ``derive_columns``:
    key and value expressions over columns and lookup tables, NULL rows
    neutralized per aggregate, hidden valid counts) as one kernel in K12's
    form without the mask, generated per aggregate.  It is traced when the
    operator is planned, so a chain the tracer does not cover raises
    ``CodegenError`` there.  An output that is a plain input column of its
    own type is that column (``aliases``); the kernel writes the rest."""

    launch_name = "mesh_derive"

    def __init__(self, in_schema, group_exprs, aggs, label: str):
        from ..ops.mesh_exec import compile_agg_exprs, derive_columns

        def trace_states(names=None):
            trace = G.Trace()
            xp = G.CudaOps(trace)
            comp, key_c, val_c = compile_agg_exprs(in_schema, group_exprs, aggs, "cpu", xp=xp)
            cols = G.InputColumns(trace, in_schema)
            mask = G.CVal(trace, "in.mask[i]", torch.bool, 1)  # its shape only
            return trace, derive_columns(xp, key_c, val_c, cols, mask,
                                         G.trace_aux(trace, 0, comp), names)

        self.gen, self.aliases, self.names = generate_aliased(trace_states,
                                                               f"mesh derive {label}")


def mesh_derive_plain(program: MeshDeriveProgram, compiled, cols, mask, aux):
    """The mesh derive's twin: the interpreted closures over TorchOps ->
    {name: column}."""
    from ..ops.mesh_exec import derive_columns

    _comp, key_c, val_c = compiled
    return dict(derive_columns(TorchOps(mask.device), key_c, val_c, cols, mask, aux))


def mesh_derive(program: MeshDeriveProgram, compiled, cols, mask, aux):
    """The mesh aggregate's derived key and value columns of one rank batch
    -> {name: column}: one generated pass writes the computed ones (none
    runs when every output is an input column)."""
    if K._is_cpu(mask):
        return mesh_derive_plain(program, compiled, cols, mask, aux)
    written = {}
    if program.gen.outputs:
        outs, _ = program.launch_rows(cols, mask, [aux], with_mask=False)
        written = {name: t for (name, _dt), t in zip(program.gen.outputs, outs)}
    return {name: written[name] if name in written else cols[program.aliases[name]]
            for name in program.names}


class FusedProgram(GeneratedProgram):
    """One fused chain built for one device: the interpreted steps (the
    twin) and the generated source of its kernel."""

    def __init__(self, ops: List[ExecutionPlan], ctx: TaskContext):
        self.ops = ops
        self.agg = ops[0] if isinstance(ops[0], HashAggregateExec) else None
        row_ops = ops[1:] if self.agg is not None else ops
        self.schema = ops[0].schema
        self.steps = [_row_step(op, ctx.scalars, ctx.device) for op in reversed(row_ops)]
        self.agg_compiled = (self.agg._build_compiled(ctx, self.agg.input.schema)
                             if self.agg is not None else None)
        self.gen = generate(ops, ctx)
        self.launch_name = "fused_agg" if self.agg is not None else "fused_rows"

    def auxs_and_dicts(self, dicts: Dict[str, np.ndarray]):
        """Per-step lookup tables and the dictionary threading the
        interpreted chain does batch by batch, on the host, bottom-up; for
        an aggregate the aggregate's tables come last."""
        auxs = []
        for _tr, comp, dict_tr in self.steps:
            auxs.append(comp.aux_arrays(dicts) if comp is not None else {})
            dicts = dict_tr(dicts)
        if self.agg_compiled is not None:
            auxs.append(self.agg_compiled[0].aux_arrays(dicts))
        return auxs, dicts

    # --- the interpreted chain (the twin) --------------------------------
    def rows_plain(self, cols, mask, auxs):
        for i, (tr, _comp, _dt) in enumerate(self.steps):
            cols, mask = tr(cols, mask, auxs[i])
        return cols, mask

    # --- the generated kernel --------------------------------------------
    def launch_dense(self, cols, mask, auxs, key_ranges, domain, out_cap):
        """K13's dense form: K1's core over the generated row function, its
        compacted groups in the same launch -> (keys, vals, mask, overflow
        or None)."""
        gen = self.gen
        fin, keep = self._fill_in(cols, mask, auxs)
        spec, out_dtypes = K.dense_spec(gen.key_dtypes, key_ranges, gen.vals)
        outs, stream, _state = K.dense_prepare(spec, gen.key_dtypes, out_dtypes, mask.device,
                                               mask.shape[0], domain, out_cap)
        err = self.library().ab_fused_dense(ctypes.byref(fin), ctypes.byref(spec), stream)
        _cuda.check(err, "fused_agg (dense)")
        K.count_launch(self.launch_name)
        K.count_launch("fused_agg_dense")
        return outs


# --------------------------------------------------------------------------
# the wrappers: K12 and K13, each beside its twin
# --------------------------------------------------------------------------


def fused_rows_plain(program: FusedProgram, cols, mask, auxs):
    """The interpreted row chain: (output columns, mask)."""
    cols, mask = program.rows_plain(cols, mask, auxs)
    n = mask.shape[0]
    return {f.name: _full_column(cols[f.name], n) for f in program.schema}, mask


def fused_rows(program: FusedProgram, cols, mask, auxs):
    """K12: the row chain as one generated kernel -> (columns, mask)."""
    if K._is_cpu(mask):
        return fused_rows_plain(program, cols, mask, auxs)
    outs, omask = program.launch_rows(cols, mask, auxs)
    return {name: t for (name, _dt), t in zip(program.gen.outputs, outs)}, omask


def _agg_key_vals_plain(program: FusedProgram, cols, mask, auxs):
    cols, mask = program.rows_plain(cols, mask, auxs)
    keys, vals = agg_inputs(TorchOps(mask.device), program.agg_compiled, cols, mask,
                            auxs[-1])
    return keys, vals, mask


def fused_agg_plain(program: FusedProgram, cols, mask, auxs, out_cap: int, key_ranges):
    """The interpreted aggregate chain, then the K1/K2 or K4/K8 twins:
    (out_keys, out_vals, out_mask, overflow or None)."""
    keys, vals, mask = _agg_key_vals_plain(program, cols, mask, auxs)
    return K.grouped_aggregate(keys, vals, mask, out_cap, key_ranges=key_ranges, plain=True)


def fused_agg(program: FusedProgram, cols, mask, auxs, out_cap: int, key_ranges):
    """K13: the aggregate chain's partial states.  Dense key domain: the
    generated row function inside K1's accumulator core, the groups
    compacted in the same launch; otherwise the generated kernel writes the
    key and value columns, then K4 and K8 group them."""
    if K._is_cpu(mask):
        return fused_agg_plain(program, cols, mask, auxs, out_cap, key_ranges)
    gen = program.gen
    domain = K.dense_domain(key_ranges)
    if domain is not None:
        return program.launch_dense(cols, mask, auxs, key_ranges, domain, out_cap)
    outs, omask = program.launch_rows(cols, mask, auxs)
    nk = len(gen.key_dtypes)
    vals = [(v, how) for v, (_dt, how) in zip(outs[nk:], gen.vals)]
    return K.grouped_aggregate(outs[:nk], vals, omask, out_cap, key_ranges=key_ranges)


# --------------------------------------------------------------------------
# the operator
# --------------------------------------------------------------------------


class FusedStageExec(ExecutionPlan):
    """A fused operator chain executing as one generated kernel.
    ``ops``: chain operators head first, with intact ``.input`` links."""

    def __init__(self, ops: List[ExecutionPlan]):
        if len(ops) < 2:
            raise InternalError("fused chain needs at least 2 operators")
        for a, b in zip(ops, ops[1:]):
            if a.input is not b:
                raise InternalError("fused chain ops must be input-linked")
        self.ops = list(ops)
        self._schema = ops[0].schema
        self._program: Optional[FusedProgram] = None
        # latched by the adaptive passthrough probe: later partitions run
        # the interpreted chain, whose aggregate emits per-row states
        self._fallback = False

    # --- plan-shape interface (single-input operator) --------------------
    @property
    def input(self) -> ExecutionPlan:
        return self.ops[-1].input

    @input.setter
    def input(self, node: ExecutionPlan) -> None:
        self.ops[-1].input = node

    def children(self):
        return [self.input]

    def output_partition_count(self):
        return self.ops[0].output_partition_count()

    def output_partitioning(self):
        return self.ops[0].output_partitioning()

    def program(self, ctx: TaskContext) -> FusedProgram:
        """The chain's program for ``ctx.device``, shared process-wide under
        the chain's structural fingerprint (the chain is free of scalar
        subqueries, so it does not depend on the job)."""
        with self.build_lock():
            if self._program is None:
                key = ("fused", str(ctx.device), tuple(type(o).__name__ for o in self.ops),
                       chain_fingerprint(self.ops, schema_sig(self.input.schema)))
                self._program = shared_program(key, lambda: FusedProgram(self.ops, ctx))
            return self._program

    def device_programs(self, ctx: TaskContext):
        return [] if self._fallback else [self.program(ctx)]

    # --- execution -------------------------------------------------------
    def execute(self, partition: int, ctx: TaskContext) -> List[ColumnBatch]:
        with ctx.op_span(self):
            if self._fallback:
                return self.ops[0].execute(partition, ctx)
            prog = self.program(ctx)
            if prog.agg is not None:
                return self._execute_agg(prog, partition, ctx)
            return self._execute_rows(prog, partition, ctx)

    def _execute_rows(self, prog: FusedProgram, partition: int, ctx: TaskContext):
        out = []
        for b in self.input.execute(partition, ctx):
            ctx.check_cancelled()
            with self.metrics().timer("compute_time"):
                auxs, dicts = prog.auxs_and_dicts(b.dicts)
                cols, mask = fused_rows(prog, b.columns, b.mask, auxs)
                result = ColumnBatch(self._schema, cols, mask, dicts)
                deferred_rows(self.metrics(), "output_rows", result)
                out.append(result)
        return out

    def _execute_agg(self, prog: FusedProgram, partition: int, ctx: TaskContext):
        """HashAggregateExec._execute_device with the row chain fused in
        front of the aggregate: the same dense-domain bound, plan-ahead
        capacity and NULL restore."""
        agg = prog.agg
        batches = self.input.execute(partition, ctx)
        ctx.check_cancelled()
        # memory governor: the interpreted aggregate's reserve-before-
        # materialize protocol.  A denial delegates this partition to the
        # interpreted chain, whose aggregate is denied again and spills,
        # without latching: the next partition may be granted and fuse.
        gov = ctx.governor
        reservation = None
        if gov is not None:
            reservation = gov.try_reserve(_state_bytes(batches, self.input.schema, agg.schema),
                                          site="fused-agg")
            if reservation is None:
                self.metrics().add("fused_spill_delegations", 1)
                return self.ops[0].execute(partition, ctx)
        try:
            return self._execute_agg_inmem(prog, ctx, batches)
        finally:
            if reservation is not None:
                reservation.release()

    def _execute_agg_inmem(self, prog: FusedProgram, ctx: TaskContext, batches):
        agg = prog.agg
        big = concat_batches(self.input.schema, batches, device=ctx.device).shrink()
        comp_a, group_c, agg_c, tracked = prog.agg_compiled
        with self.metrics().timer("agg_time"):
            auxs, dicts_in = prog.auxs_and_dicts(big.dicts)
            key_ranges = agg._key_ranges(group_c, dicts_in)
            # the input capacity (or the dense key domain) bounds the group
            # count: overflow is impossible and the kernel runs once
            out_cap = big.capacity
            domain = K.dense_domain(key_ranges)
            if domain is not None:
                out_cap = min(out_cap, domain)
            out_keys, out_vals, out_mask, overflow = fused_agg(
                prog, big.columns, big.mask, auxs, out_cap, key_ranges)
            if overflow is not None and bool(overflow):
                raise CapacityError(f"fused aggregation overflowed {out_cap} groups with "
                                    f"{big.capacity}-row input; this should be impossible")
        result = agg._result_batch(out_keys, out_vals, out_mask, dicts_in, prog.agg_compiled)
        # the adaptive passthrough probe (the interpreted aggregate's
        # thresholds), deferred to the task's metrics snapshot: poor
        # reduction on a large input latches both the aggregate's per-row
        # states and this stage's interpreted path, so sibling tasks emit
        # per-row states (K15).  The latch goes on this stage's own
        # aggregate: the program, and its ``agg``, are shared across jobs.
        out_count = deferred_count(result)
        self_ref, agg_ref = weakref.ref(self), weakref.ref(self.ops[0])
        inp_rows, inp_cap = big._num_rows, big.capacity

        def _finish():
            rn = out_count()
            if not rn:
                return rn
            if poor_reduction(inp_rows, inp_cap, rn):
                me, ag = self_ref(), agg_ref()
                if me is not None and ag is not None:
                    ag._passthrough = True
                    me._fallback = True
                    me.metrics().add("fused_passthrough_fallbacks", 1)
            return rn

        if result._num_rows is not None:
            self.metrics().add("output_rows", _finish())
        else:
            self.metrics().add_deferred("output_rows", _finish)
        return [result]

    def _label(self):
        return f"FusedStageExec[{len(self.ops)} ops, 1 kernel]: {_label_of(self.ops)}"
