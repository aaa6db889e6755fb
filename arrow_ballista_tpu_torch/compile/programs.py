"""K19: the operators' expression programs as generated kernels, and the
launch form every generated kernel shares.

The reference runs each operator's expression program as one compiled
device program (arrow_ballista_tpu/ops/physical.py:630 "scan.filter",
ops/operators.py:183 "project", :317 the filter, :885 "agg.grouped" operands,
:1319 "join.probe" residual, :1794 "sort.order" keys, ops/shuffle.py:157
"shuffle.bucket" and :499 "repartition.bucket" keys).  Here each is one
kernel in K12's form (csrc/fused_rows.cuh), generated per program from the
operator's own closures traced over ``CudaOps`` (compile/codegen.py), so
its types, scales and NULL rules are the interpreted operators' own.  Two
shapes:

- a **mask program** writes ``mask & pred(cols, aux)``: the scan filter,
  ``FilterExec`` and the join's pair verification and residual;
- a **column program** writes full-capacity columns: projections, an
  aggregate's key and value operands, sort keys, join keys, shuffle and
  repartition keys.  An output that is a plain read of an input column of
  its own type is that column (no copy); a rank-0 value is written to
  every row.  When every output aliases an input, nothing launches.

The twin is the operator's closure over ``TorchOps``, unchanged, run by
``operator_program_plain``; ``operator_program`` takes it only for
tensors on the CPU.  On the card a program is traced when its plan is
prepared (``prepare``, before the first batch runs), so an expression the
tracer cannot emit raises ``CodegenError`` there: the card has no
interpreted fallback.  ``prepare`` then builds every source of the plan
that is not built yet in one parallel ``nvcc`` batch
(``_cuda.LIBRARIES.build_generated``); the builds are keyed by the
source's hash, so a warm run builds nothing.
"""
from __future__ import annotations

import ctypes
from typing import Callable, Dict, List, Optional

import torch

from ..obs import device as device_obs
from ..ops import _cuda
from ..ops import kernels as K
from . import codegen as G


class _FusedIn(ctypes.Structure):
    """csrc/fused_rows.cuh ``AbFusedIn``."""

    _fields_ = [("col", ctypes.c_void_p * G.MAX_IN), ("mask", ctypes.c_void_p),
                ("aux", ctypes.c_void_p * G.MAX_AUX), ("aux_len", ctypes.c_longlong * G.MAX_AUX)]


class _FusedOut(ctypes.Structure):
    """csrc/fused_rows.cuh ``AbFusedOut``."""

    _fields_ = [("col", ctypes.c_void_p * G.MAX_OUT), ("mask", ctypes.c_void_p)]


def _full_column(v, n):
    """Literal operands compile to 0-d values; programs write per row."""
    return v.expand(n) if v.dim() == 0 else v


class GeneratedProgram:
    """What a generated kernel's launches share: the library of ``gen``'s
    source and K12's launch form, counted under ``launch_name``."""

    gen: G.GeneratedChain
    launch_name: str

    def library(self) -> ctypes.CDLL:
        return _cuda.LIBRARIES.get_generated(self.gen.source)

    def launches(self) -> bool:
        """Whether a call launches the generated kernel (else it has no
        source to build)."""
        return True

    def _fill_in(self, cols, mask, auxs):
        from ..utils.errors import InternalError

        gen = self.gen
        keep = []
        fin = _FusedIn()
        for k, (name, dt) in enumerate(gen.inputs):
            t = cols[name]
            if t.dtype == torch.int32 and dt == torch.int64:
                # an int32 sum under an int64 schema field (K1 and K8 keep
                # int32 sums in int32, as the reference does): the program
                # reads it as its schema says, sign-extended
                t = t.to(torch.int64)
            if t.dtype != dt or t.shape[0] != mask.shape[0]:
                raise InternalError(f"fused input {name}: {t.dtype}{tuple(t.shape)}, the "
                                    f"generated kernel reads {dt}[{mask.shape[0]}]")
            t = t.contiguous()
            keep.append(t)
            fin.col[k] = t.data_ptr()
        m = mask.contiguous()
        keep.append(m)
        fin.mask = m.data_ptr()
        for k, (step, slot, dt) in enumerate(gen.aux):
            t = auxs[step][slot]
            if t.dtype != dt:
                raise InternalError(f"fused lookup table {slot}: {t.dtype}, the generated "
                                    f"kernel reads {dt}")
            t = t.contiguous()
            keep.append(t)
            fin.aux[k] = t.data_ptr()
            fin.aux_len[k] = t.shape[0]
        K._require_cuda(mask, *keep)
        return fin, keep

    def launch_rows(self, cols, mask, auxs, with_mask: bool = True):
        """K12's form: fresh output columns and (``with_mask``) mask."""
        n = mask.shape[0]
        dev = mask.device
        outs = [torch.empty(n, dtype=dt, device=dev) for _name, dt in self.gen.outputs]
        omask = torch.empty(n, dtype=torch.bool, device=dev) if with_mask else None
        if n == 0:
            return outs, omask
        fin, keep = self._fill_in(cols, mask, auxs)
        fout = _FusedOut()
        for k, t in enumerate(outs):
            fout.col[k] = t.data_ptr()
        fout.mask = omask.data_ptr() if with_mask else None
        err = self.library().ab_fused_rows(ctypes.byref(fin), ctypes.byref(fout), n,
                                           K._stream(dev))
        _cuda.check(err, f"fused_rows ({self.launch_name})")
        K.count_launch(self.launch_name)
        return outs, omask


def generate_aliased(trace_states, label: str):
    """Trace ``trace_states(names) -> (trace, [(name, value)])`` twice:
    once to find the outputs that are a plain read of an input column of
    their own type (they alias it), then only the rest.  Returns (chain in
    K12's form without the mask, aliases, every output's name)."""
    trace, states = trace_states(None)
    aliases = {name: trace.column_of(v) for name, v in states if trace.column_of(v)}
    trace, computed = trace_states([name for name, _v in states if name not in aliases])
    return G.render(trace, label, computed, None), aliases, [name for name, _v in states]


class OperatorProgram(GeneratedProgram):
    """K19: one operator program.  ``kind`` is "mask" or "columns";
    ``schema`` is the schema of the columns it reads.  ``build(xp, device)
    -> (compilers, body, extra)``: ``compilers`` are the program's
    ExprCompilers (their lookup tables are the launch's aux steps, in
    order), ``body(xp, cols, mask, auxs)`` returns the new mask (a mask
    program) or [(name, value)] (a column program), ``extra`` is whatever
    the operator keeps of its closures (dictionary functions, aggregations).
    The twin's closures are compiled for ``device`` now; the generated
    source is traced at its first use (``gen``), which on the card is
    ``prepare``."""

    launch_name = "operator_program"

    def __init__(self, kind: str, label: str, schema, build: Callable, device):
        if kind not in ("mask", "columns"):
            raise ValueError(f"unknown program kind {kind!r}")
        self.kind = kind
        self.label = label
        self.schema = schema
        self._build = build
        self.compilers, self.body, self.extra = build(None, device)
        self.xp = self.compilers[0].xp if self.compilers else None
        self._gen: Optional[G.GeneratedChain] = None
        self._aliases: Dict[str, str] = {}
        self._names: List[str] = []

    def launches(self) -> bool:
        return self.kind == "mask" or bool(self.gen.outputs)

    def aux_arrays(self, *dicts) -> list:
        """The lookup tables of one launch: compiler k's over ``dicts[k]``
        (the last one serves the rest)."""
        return [c.aux_arrays(dicts[min(k, len(dicts) - 1)])
                for k, c in enumerate(self.compilers)]

    def _trace(self, names=None):
        trace = G.Trace()
        xp = G.CudaOps(trace)
        compilers, body, _extra = self._build(xp, torch.device("cpu"))
        cols = G.InputColumns(trace, self.schema)
        mask = (trace.bind("in.mask[i]", torch.bool, 1) if self.kind == "mask"
                else G.CVal(trace, "in.mask[i]", torch.bool, 1))  # a column program: its shape
        auxs = [G.trace_aux(trace, k, c) for k, c in enumerate(compilers)]
        out = body(xp, cols, mask, auxs)
        if self.kind == "mask":
            return trace, out
        if names is not None:
            out = [(n, v) for n, v in out if n in names]
        for n, v in out:
            if not isinstance(v, G.CVal):
                raise G.CodegenError(f"no generated code for output {n} of {self.label}")
        return trace, out

    @property
    def gen(self) -> G.GeneratedChain:
        if self._gen is None:
            try:
                self._gen = self._generate()
            except G.CodegenError:
                raise
            except Exception as e:  # a closure the tracer cannot run (a UDF's torch call)
                raise G.CodegenError(f"no generated code for the {self.label}: "
                                     f"{type(e).__name__}: {e}") from e
        return self._gen

    def _generate(self) -> G.GeneratedChain:
        if self.kind == "mask":
            trace, m = self._trace()
            if not isinstance(m, G.CVal) or m.dtype != torch.bool:
                raise G.CodegenError(f"{self.label}: the predicate is not a bool row value")
            return G.render(trace, self.label, [], m)
        gen, self._aliases, self._names = generate_aliased(self._trace, self.label)
        return gen


def operator_program_plain(program: OperatorProgram, cols, mask, auxs):
    """K19's twin: the operator's closures over TorchOps -> the new mask,
    or {name: full-capacity column}."""
    out = program.body(program.xp, cols, mask, auxs)
    if program.kind == "mask":
        return out
    n = mask.shape[0]
    return {name: _full_column(v, n) for name, v in out}


def operator_program(program: OperatorProgram, cols, mask, auxs):
    """K19: one operator program over one batch -> the new mask (a mask
    program) or {name: column} (a column program, aliased outputs being
    the input columns themselves)."""
    if K._is_cpu(mask):
        return operator_program_plain(program, cols, mask, auxs)
    gen = program.gen
    if program.kind == "mask":
        return program.launch_rows(cols, mask, auxs)[1]
    written = {}
    if gen.outputs:
        outs, _ = program.launch_rows(cols, mask, auxs, with_mask=False)
        written = {name: t for (name, _dt), t in zip(gen.outputs, outs)}
    return {name: written[name] if name in written else cols[program._aliases[name]]
            for name in program._names}


def mask_program(label: str, schema, compile_pred, device) -> OperatorProgram:
    """A mask program from ``compile_pred(xp, device) -> (compiler, pred)``:
    ``mask & pred``."""
    def build(xp, dev):
        comp, pred = compile_pred(xp, dev)
        return [comp], lambda _xp, cols, mask, auxs: mask & pred.fn(cols, auxs[0]), pred

    return OperatorProgram("mask", label, schema, build, device)


def key_program(label: str, schema, exprs, device) -> OperatorProgram:
    """A column program of key expressions (``compile_key``: string keys as
    value hashes), outputs ``__k0``, ``__k1``, ..."""
    from ..ops.expressions import ExprCompiler

    def build(xp, dev):
        comp = ExprCompiler(schema, "device", dev, xp=xp)
        keys = [comp.compile_key(e) for e in exprs]

        def body(_xp, cols, mask, auxs):
            n = mask.shape[0]
            return [(f"__k{j}", _full_column(c.fn(cols, auxs[0]), n))
                    for j, c in enumerate(keys)]

        return [comp], body, keys

    return OperatorProgram("columns", label, schema, build, device)


# --------------------------------------------------------------------------
# a plan's programs: traced and built before its first batch
# --------------------------------------------------------------------------


def _node_programs(plan, ctx):
    """(operator, its generated programs for ``ctx``) of every operator of
    ``plan`` that has any (``device_programs``)."""
    seen = set()
    stack = [plan]
    while stack:
        node = stack.pop()
        if id(node) in seen:
            continue
        seen.add(id(node))
        fn = getattr(node, "device_programs", None)
        progs = fn(ctx) if fn is not None else []
        if progs:
            yield node, progs
        stack.extend(node.children())


def trace(plan, ctx) -> List[GeneratedProgram]:
    """Every generated program of ``plan``'s operators for ``ctx``,
    traced: an expression the tracer cannot emit raises ``CodegenError``
    here."""
    progs = [p for _node, ps in _node_programs(plan, ctx) for p in ps]
    for p in progs:
        _ = p.gen
    return progs


def prepare(plan, ctx) -> List[GeneratedProgram]:
    """On the card: trace every program of ``plan`` and build the sources
    not built yet, all ``nvcc`` runs started together; each operator counts
    its programs in its ``generated_programs`` metric.  On the CPU the
    twins run and nothing is traced."""
    if ctx.device.type != "cuda":
        return []
    progs = []
    owners = []
    for node, ps in _node_programs(plan, ctx):
        for p in ps:
            _ = p.gen
        node.metrics().add("generated_programs", len(ps))
        progs.extend(ps)
        owners.extend((node, p) for p in ps)
    built = len(_cuda.LIBRARIES.generated_builds)
    _cuda.LIBRARIES.build_generated([p.gen.source for p in progs if p.launches()])
    if device_obs._enabled:
        # each launching program's lookup: an nvcc build of its source now,
        # or a library already built (obs/device.py jit_* keys)
        secs = dict(_cuda.LIBRARIES.generated_builds[built:])
        for node, p in owners:
            if p.launches():
                name = _cuda.generated_path(p.gen.source).name
                device_obs.record_generated(node, f"{type(node).__name__}:{getattr(p, 'label', '')}", name,
                                            secs.pop(name, None))
    return progs
