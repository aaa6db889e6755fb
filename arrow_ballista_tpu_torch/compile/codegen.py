"""Generated CUDA C++ for fused operator chains: the tracer behind K12
``fused_rows`` and K13 ``fused_agg``.

There is no second expression compiler here.  A fused chain's operators
compile their expressions with the same ``ExprCompiler`` the interpreted
operators use, but over ``CudaOps`` in place of ``TorchOps``; running those
closures on symbolic values (``CVal``: one C expression and its torch
dtype) emits the straight-line C++ of one row of the whole chain, so its
types, scales and NULL rules are the interpreted operators' own.

The C follows torch's semantics, not C's:

- result dtypes come from ``torch.result_type`` on the same kinds of
  operands (row values, 0-d constants, Python and numpy scalars);
- integer + - * and negation wrap (emitted on unsigned types);
- ``%`` and ``//`` take the divisor's sign (a zero divisor gives 0 where
  C has no result);
- comparisons with NaN are false (``!=`` true), as IEEE and torch have it;
- casts follow C (float to int truncates, to bool is ``!= 0``);
- a lookup-table gather clamps its index into the table (TorchOps.take);
- EXTRACT calls K14's row function (csrc/civil.cuh), shared with the
  interpreted kernel.

Any method or operator the tracer does not cover raises
``CodegenError`` when the chain is traced, at plan time: the compiler then
records "no generated code for <op>" and leaves the operator interpreted.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

C_TYPES = {torch.bool: "bool", torch.int32: "int", torch.int64: "long long",
           torch.float32: "float", torch.float64: "double"}
_UNSIGNED = {torch.int32: "unsigned int", torch.int64: "unsigned long long"}
_INTS = (torch.int32, torch.int64)
_FLOATS = (torch.float32, torch.float64)


class CodegenError(Exception):
    """An expression the tracer cannot emit C for."""


def _torch_dtype(dtype) -> torch.dtype:
    from ..ops.expressions import TorchOps

    return TorchOps._dtype(dtype)


def c_literal(value, dtype: torch.dtype) -> str:
    """``value`` converted to ``dtype`` as torch converts a scalar, as a C
    expression of that type."""
    if dtype == torch.bool:
        return "true" if bool(value) else "false"
    if dtype in _INTS:
        bits = 32 if dtype == torch.int32 else 64
        v = int(value) & ((1 << bits) - 1)
        if v >= 1 << (bits - 1):
            v -= 1 << bits
        if bits == 32:
            return "(-2147483647 - 1)" if v == -(1 << 31) else f"({v})"
        return "(-9223372036854775807LL - 1LL)" if v == -(1 << 63) else f"({v}LL)"
    if dtype == torch.float64:
        return f"ab_f64({int(np.float64(value).view(np.uint64))}ULL)"
    if dtype == torch.float32:
        return f"ab_f32({int(np.float32(value).view(np.uint32))}U)"
    raise CodegenError(f"no C literal of type {dtype}")


class Trace:
    """The statements of one traced row: every value is bound once to a
    ``const`` local (``v<n>``), with common subexpressions shared."""

    def __init__(self):
        self.lines: List[str] = []
        self._cse: Dict[Tuple[str, torch.dtype], str] = {}
        self._n = 0
        self.inputs: List[Tuple[str, torch.dtype]] = []  # columns read, in slot order
        self._input_slot: Dict[str, int] = {}
        self._reads: Dict[str, str] = {}  # local bound to a column read -> column
        self.aux: List[Tuple[int, str, torch.dtype]] = []  # (step, slot, dtype), in order

    def bind(self, expr: str, dtype: torch.dtype, rank: int) -> "CVal":
        key = (expr, dtype)
        name = self._cse.get(key)
        if name is None:
            name = f"v{self._n}"
            self._n += 1
            self.lines.append(f"const {C_TYPES[dtype]} {name} = {expr};")
            self._cse[key] = name
        return CVal(self, name, dtype, rank)

    def const(self, value, dtype: torch.dtype, rank: int = 0) -> "CVal":
        return CVal(self, c_literal(value, dtype), dtype, rank)

    def column(self, name: str, dtype: torch.dtype) -> "CVal":
        slot = self._input_slot.get(name)
        if slot is None:
            slot = len(self.inputs)
            self._input_slot[name] = slot
            self.inputs.append((name, dtype))
        v = self.bind(f"((const {C_TYPES[dtype]}*)in.col[{slot}])[i]", dtype, 1)
        self._reads[v.expr] = name
        return v

    def column_of(self, v: "CVal") -> Optional[str]:
        """The input column ``v`` is a plain read of (same type), or None."""
        return self._reads.get(v.expr) if isinstance(v, CVal) else None

    def aux_table(self, step: int, slot: str, dtype: torch.dtype) -> "CAux":
        self.aux.append((step, slot, dtype))
        return CAux(len(self.aux) - 1, dtype)


class InputColumns(dict):
    """The chain's input columns, read on first use."""

    def __init__(self, trace: Trace, schema):
        super().__init__()
        self._trace = trace
        self._schema = schema

    def __missing__(self, name):
        if name not in self._schema:
            raise KeyError(name)
        from ..models.batch import torch_dtype

        v = self._trace.column(name, torch_dtype(self._schema.field(name).dtype.np_dtype))
        self[name] = v
        return v


class RenamedColumns(dict):
    """A rename over symbolic columns: an output column reads its input
    column on first use, so a rename does not read every column."""

    def __init__(self, source, mapping):
        super().__init__()
        self._source = source
        self._old = {new: old for old, new in mapping}

    def __missing__(self, name):
        if name not in self._old:
            raise KeyError(name)
        v = self._source[self._old[name]]
        self[name] = v
        return v


@dataclasses.dataclass
class CAux:
    """A lookup table (an aux array): a device pointer and its length."""

    index: int
    dtype: torch.dtype


def _probe(x):
    """What torch.result_type should see for an operand."""
    if isinstance(x, CVal):
        return torch.empty((1,) if x.rank else (), dtype=x.dtype)
    if isinstance(x, (bool, int, float, np.generic)):
        return x
    raise CodegenError(f"no generated code for an operand of type {type(x).__name__}")


def _result_type(*xs) -> torch.dtype:
    """torch's result dtype for these operands (a third operand, clamp's,
    folds in after the first two)."""
    probes = [_probe(x) for x in xs]
    r = torch.result_type(probes[0], probes[1])
    if len(probes) == 3:
        rank1 = any(isinstance(p, torch.Tensor) and p.dim() for p in probes[:2])
        r = torch.result_type(torch.empty((1,) if rank1 else (), dtype=r), probes[2])
    return r


def _rank(*xs) -> int:
    return max((x.rank for x in xs if isinstance(x, CVal)), default=0)


def _as(x, dtype: torch.dtype) -> str:
    """Operand ``x`` converted to ``dtype``, as C."""
    if isinstance(x, CVal):
        return x.expr if x.dtype == dtype else f"(({C_TYPES[dtype]}){x.expr})"
    return c_literal(x.item() if isinstance(x, np.generic) else x, dtype)


class CVal:
    """A symbolic column value: one C expression of one torch dtype.
    ``rank`` is 1 for a per-row value, 0 for a constant (torch's type
    promotion treats the two differently)."""

    __array_ufunc__ = None  # numpy scalars defer to the reflected operators

    def __init__(self, trace: Trace, expr: str, dtype: torch.dtype, rank: int):
        self.trace = trace
        self.expr = expr
        self.dtype = dtype
        self.rank = rank

    # --- shape protocol of the closures ---------------------------------
    @property
    def shape(self):
        return ("n",) if self.rank else ()

    @property
    def ndim(self) -> int:
        return self.rank

    def dim(self) -> int:
        return self.rank

    def expand(self, *_n) -> "CVal":
        return CVal(self.trace, self.expr, self.dtype, 1)

    def to(self, dtype) -> "CVal":
        return _astype(self, _torch_dtype(dtype))

    def __bool__(self):
        raise CodegenError("no generated code for a branch on a row value")

    __hash__ = object.__hash__

    # --- arithmetic -----------------------------------------------------
    def _arith(self, op: str, other, reflected: bool) -> "CVal":
        a, b = (other, self) if reflected else (self, other)
        r = _result_type(a, b)
        x, y = _as(a, r), _as(b, r)
        if r in _INTS:
            ct, ut = C_TYPES[r], _UNSIGNED[r]
            suffix = "i64" if r == torch.int64 else "i32"
            if op in "+-*":
                expr = f"(({ct})(({ut}){x} {op} ({ut}){y}))"
            elif op == "%":
                expr = f"ab_mod_{suffix}({x}, {y})"
            else:
                expr = f"ab_floordiv_{suffix}({x}, {y})"
        elif r in _FLOATS:
            suffix = "f64" if r == torch.float64 else "f32"
            if op in "+-*":
                expr = f"({x} {op} {y})"
            elif op == "%":
                expr = f"ab_mod_{suffix}({x}, {y})"
            else:
                expr = f"ab_floordiv_{suffix}({x}, {y})"
        else:
            raise CodegenError(f"no generated code for {op} on {r}")
        return self.trace.bind(expr, r, _rank(a, b))

    def __add__(self, o):
        return self._arith("+", o, False)

    def __radd__(self, o):
        return self._arith("+", o, True)

    def __sub__(self, o):
        return self._arith("-", o, False)

    def __rsub__(self, o):
        return self._arith("-", o, True)

    def __mul__(self, o):
        return self._arith("*", o, False)

    def __rmul__(self, o):
        return self._arith("*", o, True)

    def __mod__(self, o):
        return self._arith("%", o, False)

    def __rmod__(self, o):
        return self._arith("%", o, True)

    def __floordiv__(self, o):
        return self._arith("//", o, False)

    def __rfloordiv__(self, o):
        return self._arith("//", o, True)

    def __neg__(self):
        if self.dtype in _INTS:
            ct, ut = C_TYPES[self.dtype], _UNSIGNED[self.dtype]
            return self.trace.bind(f"(({ct})(({ut})0 - ({ut}){self.expr}))", self.dtype,
                                   self.rank)
        if self.dtype in _FLOATS:
            return self.trace.bind(f"(-{self.expr})", self.dtype, self.rank)
        raise CodegenError(f"no generated code for negation of {self.dtype}")

    def __invert__(self):
        if self.dtype == torch.bool:
            return self.trace.bind(f"(!{self.expr})", torch.bool, self.rank)
        if self.dtype in _INTS:
            return self.trace.bind(f"(({C_TYPES[self.dtype]})(~{self.expr}))", self.dtype,
                                   self.rank)
        raise CodegenError(f"no generated code for ~ on {self.dtype}")

    # --- bitwise and logical ---------------------------------------------
    def _bitwise(self, op: str, other) -> "CVal":
        r = _result_type(self, other)
        if r not in (torch.bool, *_INTS):
            raise CodegenError(f"no generated code for {op} on {r}")
        expr = f"(({C_TYPES[r]})({_as(self, r)} {op} {_as(other, r)}))"
        return self.trace.bind(expr, r, _rank(self, other))

    def __and__(self, o):
        return self._bitwise("&", o)

    __rand__ = __and__

    def __or__(self, o):
        return self._bitwise("|", o)

    __ror__ = __or__

    def __xor__(self, o):
        return self._bitwise("^", o)

    __rxor__ = __xor__

    # --- comparisons ------------------------------------------------------
    def _compare(self, op: str, other) -> "CVal":
        r = _result_type(self, other)
        expr = f"({_as(self, r)} {op} {_as(other, r)})"
        return self.trace.bind(expr, torch.bool, _rank(self, other))

    def __eq__(self, o):  # noqa: D105
        return self._compare("==", o)

    def __ne__(self, o):
        return self._compare("!=", o)

    def __lt__(self, o):
        return self._compare("<", o)

    def __le__(self, o):
        return self._compare("<=", o)

    def __gt__(self, o):
        return self._compare(">", o)

    def __ge__(self, o):
        return self._compare(">=", o)

    def __repr__(self):
        return f"CVal({self.expr}: {self.dtype}, rank {self.rank})"


def _astype(x, dtype: torch.dtype) -> CVal:
    if not isinstance(x, CVal):
        raise CodegenError("no generated code for astype of a host value")
    if dtype not in C_TYPES:
        raise CodegenError(f"no generated code for astype to {dtype}")
    if x.dtype == dtype:
        return x
    if dtype == torch.bool:
        return x.trace.bind(f"({x.expr} != 0)", torch.bool, x.rank)
    return x.trace.bind(f"(({C_TYPES[dtype]}){x.expr})", dtype, x.rank)


class CudaOps:
    """The ``TorchOps`` namespace over symbolic values: the same methods,
    emitting C into ``trace`` instead of computing tensors.  ``upload``
    (the lookup tables of ``ExprCompiler.aux_arrays``) still uploads to
    ``device``."""

    int64 = np.int64

    def __init__(self, trace: Trace, device="cpu"):
        from ..ops.expressions import TorchOps

        self.trace = trace
        self._host = TorchOps("cpu")  # constants: torch's own dtype rules
        self._device = TorchOps(device)

    def asarray(self, v, dtype=None):
        if isinstance(v, CVal):
            return v if dtype is None else _astype(v, _torch_dtype(dtype))
        t = self._host.asarray(v, dtype)
        if t.dim() != 0:
            raise CodegenError("no generated code for an array constant")
        return self.trace.const(t.item(), t.dtype)

    def zeros(self, shape, dtype=None):
        dt = _torch_dtype(dtype) if dtype is not None else torch.float32
        return self.trace.const(0, dt, 0 if shape == () else 1)

    def full(self, shape, value, dtype=None):
        dt = (_torch_dtype(dtype) if dtype is not None
              else torch.full((), value).dtype)
        return self.trace.const(value, dt, 0 if shape == () else 1)

    def where(self, cond, a, b):
        if not isinstance(cond, CVal) or cond.dtype != torch.bool:
            raise CodegenError("no generated code for where on a non-bool condition")
        r = _result_type(a, b)
        expr = f"({cond.expr} ? {_as(a, r)} : {_as(b, r)})"
        return self.trace.bind(expr, r, _rank(cond, a, b))

    def clip(self, x, lo, hi):
        r = _result_type(x, lo, hi)
        if r not in C_TYPES or r == torch.bool:
            raise CodegenError(f"no generated code for clip on {r}")
        expr = f"ab_clamp<{C_TYPES[r]}>({_as(x, r)}, {_as(lo, r)}, {_as(hi, r)})"
        return self.trace.bind(expr, r, _rank(x, lo, hi))

    def isnan(self, x):
        if not isinstance(x, CVal):
            raise CodegenError("no generated code for isnan of a host value")
        if x.dtype in _FLOATS:
            return x.trace.bind(f"({x.expr} != {x.expr})", torch.bool, x.rank)
        return x.trace.const(False, torch.bool, x.rank)

    def astype(self, x, dtype):
        return _astype(x, _torch_dtype(dtype))

    def take(self, lut, codes):
        if not isinstance(lut, CAux) or not isinstance(codes, CVal) \
                or codes.dtype not in _INTS:
            raise CodegenError("no generated code for take outside a lookup table")
        ct = C_TYPES[lut.dtype]
        expr = (f"((const {ct}*)in.aux[{lut.index}])"
                f"[ab_clamp_idx((long long){codes.expr}, in.aux_len[{lut.index}])]")
        return self.trace.bind(expr, lut.dtype, codes.rank)

    def extract_field(self, days, field: str):
        """K14's body (csrc/civil.cuh) inline in the generated row."""
        from ..ops.kernels import EXTRACT_FIELDS

        if not isinstance(days, CVal) or days.dtype != torch.int32:
            raise CodegenError("no generated code for EXTRACT outside an int32 day column")
        if field not in EXTRACT_FIELDS:
            raise CodegenError(f"no generated code for EXTRACT({field})")
        return self.trace.bind(f"ab_civil_field({days.expr}, {EXTRACT_FIELDS[field]})",
                               torch.int32, days.rank)

    def upload(self, v: np.ndarray):
        return self._device.upload(v)


def aux_dtype(arr) -> torch.dtype:
    """The torch dtype an aux array travels as (TorchOps.upload: uint64 as
    int64 bits)."""
    a = np.asarray(arr)
    if a.dtype == np.uint64:
        return torch.int64
    return _torch_dtype(a.dtype)


def trace_aux(trace: Trace, step: int, comp) -> Dict[str, CAux]:
    """Symbolic lookup tables of one step's compiler; their dtypes come from
    the builders run over empty dictionaries (a builder's dtype never
    depends on the dictionary)."""
    if comp is None:
        return {}
    return {slot: trace.aux_table(step, slot, aux_dtype(arr))
            for slot, arr in comp.build_aux({}).items()}


# --------------------------------------------------------------------------
# rendering
# --------------------------------------------------------------------------


@dataclasses.dataclass
class GeneratedChain:
    """One chain's generated source and the interface its launches fill."""

    source: str
    inputs: List[Tuple[str, torch.dtype]]  # columns read, in AbFusedIn.col order
    outputs: List[Tuple[str, torch.dtype]]  # columns written, in AbFusedOut.col order
    aux: List[Tuple[int, str, torch.dtype]]  # (step, slot, dtype), AbFusedIn.aux order
    # agg chains: the key dtypes and (value dtype, how) of K13's dense form
    key_dtypes: Optional[List[torch.dtype]] = None
    vals: Optional[List[Tuple[torch.dtype, str]]] = None

    @property
    def digest(self) -> str:
        return hashlib.sha256(self.source.encode()).hexdigest()[:16]


MAX_IN, MAX_OUT, MAX_AUX = 64, 64, 32  # csrc/fused_rows.cuh AB_FUSED_MAX_*


_WORD_DTYPES = (torch.int32, torch.int64, torch.float32, torch.float64)


def _word(v: CVal) -> str:
    """A value word of K1's accumulator body."""
    if v.dtype == torch.int64:
        return f"(unsigned long long){v.expr}"
    if v.dtype == torch.int32:
        return f"(unsigned long long)(unsigned int){v.expr}"
    if v.dtype == torch.float64:
        return f"ab_f64_bits({v.expr})"
    if v.dtype == torch.float32:
        return f"(unsigned long long)ab_f32_bits({v.expr})"
    raise CodegenError(f"no dense aggregation word for {v.dtype}")


def _fold(v: CVal, how: str) -> str:
    """A value word's compile-time fold in K13's dense form: K1's codes of
    the aggregate and of the value's kind (a count folds as int64)."""
    from ..ops.kernels import _HOW, _KIND

    dt = torch.int64 if how == "count" else v.dtype
    if how not in _HOW or dt not in _WORD_DTYPES:
        raise CodegenError(f"no dense {how} over {v.dtype}")
    return f"AbFold<{_HOW[how]}, {_KIND[dt]}>"


def render(trace: Trace, label: str, outputs: Sequence[Tuple[str, CVal]],
           mask: Optional[CVal], keys: Optional[Sequence[CVal]] = None,
           vals: Optional[Sequence[Tuple[CVal, str]]] = None) -> GeneratedChain:
    """The source of one chain: ``rows`` writes ``outputs`` and, unless
    ``mask`` is None, the mask; with ``keys`` and ``vals`` also
    ``keys_words`` for K13's dense form."""
    if len(trace.inputs) > MAX_IN or len(outputs) > MAX_OUT or len(trace.aux) > MAX_AUX:
        raise CodegenError(f"chain exceeds the generated kernel's {MAX_IN} inputs, "
                           f"{MAX_OUT} outputs or {MAX_AUX} lookup tables")
    body = ["    " + line for line in trace.lines]
    rows = ["  static AB_HD void rows(const AbFusedIn& in, const AbFusedOut& out, long long i) {"]
    rows += body
    for k, (_name, v) in enumerate(outputs):
        rows.append(f"    (({C_TYPES[v.dtype]}*)out.col[{k}])[i] = {v.expr};")
    if mask is not None:
        rows.append(f"    out.mask[i] = {mask.expr};")
    rows.append("  }")
    parts = [f"// generated by arrow_ballista_tpu_torch/compile/codegen.py: {label}",
             '#include "fused_rows.cuh"', "", "struct AbRow {", *rows]
    key_dtypes = val_meta = None
    if keys is not None:
        for k in keys:
            if k.dtype not in (torch.int32, torch.int64, torch.bool):
                raise CodegenError(f"no dense key of type {k.dtype}")
        kw = ["  static AB_HD bool keys_words(const AbFusedIn& in, long long i, int* keys,",
              "                               unsigned long long* words) {"]
        kw += body
        for j, k in enumerate(keys):
            kw.append(f"    keys[{j}] = (int){k.expr};")
        for a, (v, how) in enumerate(vals):
            kw.append(f"    words[{a}] = {'1ULL' if how == 'count' else _word(v)};")
        kw.append(f"    return {mask.expr};")
        kw.append("  }")
        parts += [""] + kw
        key_dtypes = [k.dtype for k in keys]
        val_meta = [(v.dtype, how) for v, how in vals]
    parts += ["};", "", "AB_FUSED_ROWS_ENTRY(AbRow)"]
    if keys is not None:
        folds = ", ".join(_fold(v, how) for v, how in vals)
        parts += ["", "// each value word's fold (K13's dense form)",
                  f"using AbFoldList = AbFolds<{folds}>;",
                  f"AB_FUSED_AGG_ENTRY(AbRow, {len(keys)}, {len(vals)})"]
    source = "\n".join(parts) + "\n"
    return GeneratedChain(source, list(trace.inputs), [(n, v.dtype) for n, v in outputs],
                          list(trace.aux), key_dtypes, val_meta)
