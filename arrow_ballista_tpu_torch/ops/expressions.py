"""Expression compilation: typed logical Expr -> executable column functions.

Two modes:

- **device**: emits a function over ``(cols: dict[str, torch.Tensor],
  aux: dict[str, torch.Tensor])`` built from torch elementwise ops on the
  batch's device.  String predicates (=, LIKE, IN over dictionary-encoded
  columns) are evaluated once per dictionary over the (small) host
  dictionary, producing lookup tables shipped in ``aux`` — the device does
  a gather, never touches bytes.  Inside a fused stage the same closures
  run over compile/codegen.py's ``CudaOps`` and become one generated
  kernel (K12, K13).
- **host**: same semantics with numpy float64 — used for tiny
  post-aggregation projections containing division.

Both modes reach their arrays through a small namespace (``NumpyOps`` /
``TorchOps``), so the compiled closures are shared text: torch lacks
``.astype`` and needs a device for every constant.

Constant folding happens first (date/interval arithmetic, literal math), so
the device never sees calendar logic except EXTRACT over columns, which uses
the integer civil-from-days kernel.
"""
from __future__ import annotations

import dataclasses
import datetime
import re
import threading
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..models import expr as E
from ..models.schema import BOOL, DataType, DATE32, FLOAT64, INT32, INT64, Schema
from ..utils.errors import InternalError, PlanningError


class NumpyOps:
    """Host-mode array namespace (numpy)."""

    int64 = np.int64
    asarray = staticmethod(np.asarray)
    zeros = staticmethod(np.zeros)
    full = staticmethod(np.full)
    where = staticmethod(np.where)
    clip = staticmethod(np.clip)
    isnan = staticmethod(np.isnan)

    @staticmethod
    def astype(x, dtype):
        return np.asarray(x).astype(dtype)

    @staticmethod
    def take(lut, codes):
        """Lookup-table gather; a code below 0 reads entry 0."""
        return lut[np.clip(codes, 0, None)]

    @staticmethod
    def extract_field(days, field: str):
        """EXTRACT on the host: the reference's civil_from_days over numpy."""
        z = np.asarray(days).astype(np.int64) + 719468
        era = np.floor_divide(z, 146097)
        doe = z - era * 146097
        yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365
        doy = doe - (365 * yoe + yoe // 4 - yoe // 100)
        mp = (5 * doy + 2) // 153
        d = doy - (153 * mp + 2) // 5 + 1
        m = mp + np.where(mp < 10, 3, -9)
        y = yoe + era * 400 + (m <= 2)
        parts = {"year": y, "month": m, "day": d}
        if field not in parts:
            raise ValueError(f"unsupported EXTRACT field {field}")
        return parts[field].astype(np.int32)


class TorchOps:
    """Device-mode array namespace: torch tensors on one device.  Host
    numpy dtypes map to torch dtypes; uint64 values (string-key hashes)
    travel as int64 bits, as everywhere in the port."""

    int64 = np.int64

    def __init__(self, device):
        self.device = torch.device(device)

    @staticmethod
    def _dtype(dtype):
        from ..models.batch import torch_dtype

        if dtype is None or isinstance(dtype, torch.dtype):
            return dtype
        if dtype is bool:
            return torch.bool
        return torch_dtype(np.dtype(dtype))

    def asarray(self, v, dtype=None):
        if isinstance(v, np.uint64):
            v = int(np.asarray(v).view(np.int64))
            dtype = dtype or np.int64
        return torch.as_tensor(v, dtype=self._dtype(dtype), device=self.device)

    def zeros(self, shape, dtype=None):
        return torch.zeros(shape, dtype=self._dtype(dtype), device=self.device)

    def full(self, shape, value, dtype=None):
        return torch.full(shape, value, dtype=self._dtype(dtype), device=self.device)

    @staticmethod
    def where(cond, a, b):
        return torch.where(cond, a, b)

    @staticmethod
    def clip(x, lo, hi):
        return torch.clamp(x, min=lo, max=hi)

    @staticmethod
    def isnan(x):
        return torch.isnan(x)

    def astype(self, x, dtype):
        return x.to(self._dtype(dtype))

    @staticmethod
    def extract_field(days, field: str):
        """EXTRACT(field FROM days) in plain torch (K14's twin), on either
        device: on the card EXTRACT runs inside the generated programs, and
        these closures are their plain twins."""
        from . import kernels as K

        return K.extract_field_plain(days, field)

    @staticmethod
    def take(lut, codes):
        """Lookup-table gather with codes clamped into the table, as the
        reference's device gathers clamp (dead rows may carry any code; an
        out-of-range index would fault the card)."""
        return lut[torch.clamp(codes, 0, lut.shape[0] - 1)]

    def upload(self, v: np.ndarray):
        from ..models.batch import upload

        if v.dtype == np.uint64:
            v = v.view(np.int64)
        return upload([v], self.device)[0]


# --------------------------------------------------------------------------
# constant folding
# --------------------------------------------------------------------------


def _parse_date(s: str) -> int:
    d = datetime.date.fromisoformat(s)
    return (d - datetime.date(1970, 1, 1)).days


def _add_months(days: int, months: int) -> int:
    d = datetime.date(1970, 1, 1) + datetime.timedelta(days=days)
    y, m = divmod((d.year * 12 + d.month - 1) + months, 12)
    leap = y % 4 == 0 and (y % 100 != 0 or y % 400 == 0)
    month_len = [31, 29 if leap else 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31][m]
    clamped = datetime.date(y, m + 1, min(d.day, month_len))
    return (clamped - datetime.date(1970, 1, 1)).days


def fold_constants(e: E.Expr) -> E.Expr:
    """Evaluate literal-only subtrees on the host (incl. date/interval math)."""
    if isinstance(e, E.Lit):
        if e.kind == "date" and isinstance(e.value, str):
            return E.Lit(_parse_date(e.value), kind="date")
        return e
    from ..sql.planner import _map_children

    e = _map_children(e, fold_constants)

    if isinstance(e, E.BinOp) and isinstance(e.left, E.Lit) and isinstance(e.right, E.Lit):
        lv, rv = e.left.value, e.right.value
        lk, rk = e.left.kind, e.right.kind
        if e.op in ("+", "-") and lk == "date":
            sign = 1 if e.op == "+" else -1
            if rk == "interval_day":
                return E.Lit(lv + sign * rv, kind="date")
            if rk == "interval_month":
                return E.Lit(_add_months(lv, sign * rv), kind="date")
        if lk == "auto" and rk == "auto" and e.op in ("+", "-", "*", "/"):
            try:
                v = {"+": lv + rv, "-": lv - rv, "*": lv * rv,
                     "/": lv / rv if isinstance(lv, float) or isinstance(rv, float) or lv % rv else lv // rv}[e.op]
            except Exception:
                return e
            return E.Lit(v)
    if isinstance(e, E.Negate) and isinstance(e.operand, E.Lit) and e.operand.kind == "auto":
        return E.Lit(-e.operand.value)
    return e


# --------------------------------------------------------------------------
# LIKE -> regex over dictionary
# --------------------------------------------------------------------------


def _pad_pow2(v: np.ndarray, minimum: int = 16) -> np.ndarray:
    """Pad a 1-D LUT to the next power-of-two length (shape bucketing; the
    pad values are never read — LUTs are indexed by dictionary codes which
    are always < the original length)."""
    from ..models.batch import round_capacity

    if v.ndim != 1:
        return v
    cap = round_capacity(v.shape[0], minimum)
    if cap == v.shape[0]:
        return v
    return np.concatenate([v, np.zeros(cap - v.shape[0], dtype=v.dtype)])


def _fnv1a64(s) -> int:
    """Deterministic 64-bit string hash (stable across processes/hosts —
    python's builtin hash() is salted and unusable for shuffles)."""
    h = 0xCBF29CE484222325
    for b in str(s).encode("utf-8"):
        h = ((h ^ b) * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h


def _fnv1a64_many(strings) -> np.ndarray:
    """Vectorized _fnv1a64 over a sequence of strings: bit-identical to the
    scalar version, but O(max_len) numpy passes instead of a Python loop
    per character.  Matters because hash LUTs are rebuilt per merged
    dictionary — a 150k-entry c_name dictionary took ~3 s/task scalar
    (measured dominating q18's shuffle write)."""
    enc = [str(s).encode("utf-8") for s in strings]
    n = len(enc)
    if n == 0:
        return np.zeros(0, dtype=np.uint64)
    lens = np.fromiter((len(b) for b in enc), dtype=np.int64, count=n)
    if int(lens.max()) == 0:
        return np.full(n, 0xCBF29CE484222325, dtype=np.uint64)
    flat = np.frombuffer(b"".join(enc), dtype=np.uint8)
    offsets = np.zeros(n, dtype=np.int64)
    np.cumsum(lens[:-1], out=offsets[1:])
    h = np.full(n, 0xCBF29CE484222325, dtype=np.uint64)
    prime = np.uint64(0x100000001B3)
    live = np.arange(n)
    pos = 0
    with np.errstate(over="ignore"):
        while live.size:
            sel = live[lens[live] > pos]
            if sel.size == 0:
                break
            h[sel] = (h[sel] ^ flat[offsets[sel] + pos].astype(np.uint64)) * prime
            live = sel
            pos += 1
    return h


def like_to_regex(pattern: str) -> "re.Pattern":
    out = []
    for ch in pattern:
        if ch == "%":
            out.append(".*")
        elif ch == "_":
            out.append(".")
        else:
            out.append(re.escape(ch))
    return re.compile("^" + "".join(out) + "$", re.DOTALL)


# --------------------------------------------------------------------------
# compiled expression
# --------------------------------------------------------------------------


@dataclasses.dataclass
class Compiled:
    fn: Callable  # (cols, aux) -> array
    dtype: DataType
    # for string-valued results: dictionary derivation from input dicts
    dict_fn: Optional[Callable] = None  # (dicts) -> np.ndarray of str
    # for literal sources: the python value, so coercions (e.g. float literal
    # against a decimal column) happen at compile time, never on device
    lit_value: Optional[object] = None


class ExprCompiler:
    """Compiles expressions against a fixed input schema.

    ``aux_builders`` maps aux-slot names to host functions
    ``(dicts: {col: np.ndarray}) -> np.ndarray`` evaluated per batch (cached
    by the operator on dictionary identity).
    """

    def __init__(self, schema: Schema, mode: str = "device", device=None, xp=None):
        if mode not in ("device", "host"):
            raise InternalError(f"unknown expression mode {mode!r}")
        if mode == "device" and device is None:
            raise InternalError("device-mode expressions need a device")
        self.schema = schema
        self.mode = mode
        # ``xp`` replaces the device namespace: compile/codegen.py's CudaOps
        # traces the same closures into generated C
        self.xp = xp or (TorchOps(device) if mode == "device" else NumpyOps())
        self.aux_builders: Dict[str, Callable] = {}
        self._aux_cache: Dict = {}
        self._aux_lock = threading.Lock()
        self._n = 0

    # --- public ---------------------------------------------------------
    def compile(self, expr: E.Expr) -> Compiled:
        return self._c(fold_constants(expr))

    # sentinel for NULL string keys: joins must treat NULL <> NULL, so this
    # value is excluded from matching by JoinExec (group-by, which wants
    # NULLs grouped together, sees them all map to this one value)
    NULL_KEY_SENTINEL = np.uint64(0x9E3779B97F4A7C15)

    def compile_key(self, expr: E.Expr) -> Compiled:
        """Compile an expression for use as a shuffle/join key: the result is
        comparable **across batches and processes**.  Numeric keys pass
        through (joins on them are exact); string keys become stable 64-bit
        value hashes (FNV-1a over UTF-8 evaluated on the dictionary), since
        dictionary codes are only meaningful within one batch's encoding.
        String-key equality is therefore hash-based (collision odds ~2^-64
        per joined pair); the compiled dtype reports is_string so consumers
        can apply NULL-exclusion via NULL_KEY_SENTINEL."""
        c = self.compile(expr)
        if not c.dtype.is_string:
            return c
        xp = self.xp

        def hash_lut(d, df=c.dict_fn):
            dic = df(d)
            if len(dic) == 0:
                return np.zeros(1, dtype=np.uint64)
            return _fnv1a64_many(dic)

        slot = self._slot(hash_lut)
        sent = xp.asarray(self.NULL_KEY_SENTINEL)
        return Compiled(
            lambda cols, a, s=slot: xp.where(
                c.fn(cols, a) >= 0,
                xp.take(a[s], c.fn(cols, a)),
                sent,
            ),
            DataType("string"),  # marks hash-keyed string; physical is uint64
        )

    def build_aux(self, dicts: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        return {name: b(dicts) for name, b in self.aux_builders.items()}

    def aux_arrays(self, dicts: Dict[str, np.ndarray]) -> Dict[str, object]:
        """build_aux + device upload, memoized on dictionary identity (scans
        share one dictionary across all their batches, so LIKE/regex LUTs are
        computed and uploaded once per operator, not per batch).  Locked:
        concurrent same-stage tasks call this outside the operator's
        xla_lock, and an unguarded miss would rebuild + re-upload the LUTs
        per task (or clear() away a neighbour's fresh entry)."""
        key = tuple(sorted((k, id(v)) for k, v in dicts.items()))
        with self._aux_lock:
            entry = self._aux_cache.get(key)
            if entry is None:
                raw = self.build_aux(dicts)
                if self.mode == "device":
                    # pad LUTs to power-of-two lengths: every distinct aux
                    # shape is a distinct XLA program, and per-task
                    # dictionaries (shuffled string columns) vary in size —
                    # unpadded, a 46-task stage compiled its repartition
                    # kernel 46 times (measured 157 task-seconds on q18's
                    # 58-row agg output).  Safe: every builder's array is
                    # only indexed by codes < len.
                    hit = {k: self.xp.upload(_pad_pow2(np.asarray(v)))
                           for k, v in raw.items()}
                else:
                    hit = raw
                # LRU-bounded: entries pin the keyed dictionary arrays (the
                # key uses id(), and a collected dictionary would let an
                # unrelated array reuse the address and hit a STALE LUT —
                # observed as a flaky wrong-result under memory churn), and
                # compilers now live process-long in the cross-job program
                # cache (ops/physical.py shared_program), so a generous
                # bound would retain dictionaries from many finished jobs.
                while len(self._aux_cache) >= 16:
                    self._aux_cache.pop(next(iter(self._aux_cache)))
                entry = (tuple(dicts.values()), hit)
                self._aux_cache[key] = entry
        return entry[1]

    # --- helpers --------------------------------------------------------
    def _slot(self, builder: Callable) -> str:
        name = f"aux{self._n}"
        self._n += 1
        self.aux_builders[name] = builder
        return name

    def _coerce(self, fn, src: DataType, dst: DataType):
        xp = self.xp
        if src == dst:
            return fn
        if dst.is_decimal:
            if src.is_decimal:
                if dst.scale < src.scale:
                    raise InternalError(f"cannot narrow decimal {src} -> {dst}")
                mul = 10 ** (dst.scale - src.scale)
                return lambda c, a: fn(c, a) * mul
            if src.kind in ("int32", "int64"):
                mul = 10 ** dst.scale
                return lambda c, a: xp.astype(fn(c, a), "int64") * mul
            if src.is_float and self.mode == "host":
                mul = 10 ** dst.scale
                return lambda c, a: np.round(fn(c, a) * mul).astype("int64")
        if dst.kind == "float64":
            if self.mode == "device":
                raise PlanningError(
                    "float64 expression reached the device compiler; the planner "
                    "must mark this projection host-finalize"
                )
            if src.is_decimal:
                div = 10.0 ** src.scale
                return lambda c, a: fn(c, a).astype(np.float64) / div
            return lambda c, a: fn(c, a).astype(np.float64)
        if dst.kind == "int64" and src.kind in ("int32", "date32", "bool"):
            return lambda c, a: xp.astype(fn(c, a), "int64")
        if dst.kind == "int32" and src.kind in ("bool",):
            return lambda c, a: xp.astype(fn(c, a), "int32")
        if dst.kind == "float32":
            return lambda c, a: xp.astype(fn(c, a), "float32")
        raise PlanningError(f"unsupported coercion {src} -> {dst} ({self.mode} mode)")

    def _lit_physical(self, lit: E.Lit, target: DataType):
        v = lit.value
        if target.is_decimal:
            return int(round(float(v) * 10 ** target.scale))
        if target.kind == "date32":
            return int(v)
        if target.kind in ("int32", "int64"):
            return int(v)
        if target.is_float:
            return float(v)
        if target.kind == "bool":
            return bool(v)
        raise PlanningError(f"cannot make literal {v!r} of type {target}")

    # --- core recursive compile ----------------------------------------
    def _c(self, e: E.Expr) -> Compiled:
        xp = self.xp
        sch = self.schema

        if isinstance(e, E.Column):
            name = e.name
            dt = sch.field(name).dtype
            if dt.is_string:
                return Compiled(lambda c, a, n=name: c[n], dt,
                                dict_fn=lambda d, n=name: d.get(n, np.array([], dtype=object)))
            return Compiled(lambda c, a, n=name: c[n], dt)

        if isinstance(e, E.Lit):
            dt = e.dtype(sch)
            if dt.is_string:
                # constant string column: one-entry dictionary, code 0
                val = str(e.value)
                code0 = xp.zeros((), dtype=xp.int64)
                return Compiled(
                    lambda c, a: code0, dt,
                    dict_fn=lambda d, v=val: np.array([v], dtype=object),
                    lit_value=e.value)
            v = self._lit_physical(e, dt) if not dt.is_float else float(e.value)
            const = xp.asarray(v, dtype=dt.np_dtype)  # built once, at compile time
            return Compiled(lambda c, a, k=const: k, dt, lit_value=e.value)

        if isinstance(e, E.BinOp):
            if e.op in E.BinOp.BOOLEANS:
                lc, rc = self._c(e.left), self._c(e.right)
                op = e.op
                return Compiled(
                    lambda c, a: (lc.fn(c, a) & rc.fn(c, a)) if op == "and" else (lc.fn(c, a) | rc.fn(c, a)),
                    BOOL,
                )
            if e.op in E.BinOp.COMPARISONS:
                return self._compile_comparison(e)
            return self._compile_arith(e)

        if isinstance(e, E.Not):
            oc = self._c(e.operand)
            # NOT over a NULL comparison is still NULL -> false in WHERE:
            # re-apply the validity term outside the negation (the inner
            # compile already made the NULL case false, which ~ would flip)
            if isinstance(e.operand, (E.InList,)) or (
                isinstance(e.operand, E.BinOp) and e.operand.op in E.BinOp.COMPARISONS
            ):
                valid = self.validity_fn(self.nullable_refs(e.operand))
                if valid is not None:
                    return Compiled(lambda c, a: ~oc.fn(c, a) & valid(c, a), BOOL)
            return Compiled(lambda c, a: ~oc.fn(c, a), BOOL)

        if isinstance(e, E.Negate):
            oc = self._c(e.operand)
            return Compiled(lambda c, a: -oc.fn(c, a), oc.dtype)

        if isinstance(e, E.Case):
            out_t = e.dtype(sch)
            whens = [(self._c(cond), self._coerce_compiled(self._c(val), out_t)) for cond, val in e.whens]
            else_c = (
                self._coerce_compiled(self._c(e.else_), out_t)
                if e.else_ is not None
                else None
            )
            zero = xp.asarray(0.0 if out_t.is_float else 0, dtype=out_t.np_dtype)

            def case_fn(c, a):
                result = else_c.fn(c, a) if else_c is not None else zero
                for cond, val in reversed(whens):
                    result = xp.where(cond.fn(c, a), val.fn(c, a), result)
                return result

            return Compiled(case_fn, out_t)

        if isinstance(e, E.Cast):
            oc = self._c(e.operand)
            return self._coerce_compiled(oc, e.to)

        if isinstance(e, E.InList):
            oc = self._c(e.operand)
            if oc.dtype.is_string:
                values = sorted(set(e.values))
                neg = e.negated

                def in_lut(d, df=oc.dict_fn):
                    dic = df(d)
                    if len(dic) == 0:
                        return np.zeros(1, dtype=bool)
                    return np.isin(np.asarray(dic, dtype=object), values, invert=neg)

                slot = self._slot(in_lut)
                return Compiled(
                    lambda c, a, s=slot: xp.take(a[s], oc.fn(c, a)) & (oc.fn(c, a) >= 0),
                    BOOL,
                )
            vals = [self._lit_physical(E.Lit(v), oc.dtype) for v in e.values]

            valid = self.validity_fn(self.nullable_refs(e.operand))

            def inlist_fn(c, a):
                x = oc.fn(c, a)
                m = xp.zeros(x.shape, dtype=bool)
                for v in vals:
                    m = m | (x == v)
                m = ~m if e.negated else m
                # NULL IN (...) and NULL NOT IN (...) are both NULL -> false
                if valid is not None:
                    m = m & valid(c, a)
                return m

            return Compiled(inlist_fn, BOOL)

        if isinstance(e, E.Like):
            oc = self._c(e.operand)
            if not oc.dtype.is_string:
                raise PlanningError("LIKE requires a string operand")
            rx = like_to_regex(e.pattern)
            neg = e.negated
            slot = self._slot(
                lambda d, df=oc.dict_fn: np.array(
                    [(rx.match(s) is None) == neg if s is not None else neg for s in df(d)],
                    dtype=bool,
                )
                if len(df(d))
                else np.zeros(1, dtype=bool)
            )
            return Compiled(
                lambda c, a, s=slot: xp.take(a[s], oc.fn(c, a)) & (oc.fn(c, a) >= 0),
                BOOL,
            )

        if isinstance(e, E.IsNull):
            oc = self._c(e.operand)
            if oc.dtype.is_string:
                if e.negated:
                    return Compiled(lambda c, a: oc.fn(c, a) >= 0, BOOL)
                return Compiled(lambda c, a: oc.fn(c, a) < 0, BOOL)
            # nullable numerics (outer-join columns) carry in-band sentinels
            if isinstance(e.operand, E.Column) and e.operand.name in self.schema \
                    and self.schema.field(e.operand.name).nullable:
                sent = self.schema.field(e.operand.name).dtype.null_sentinel
                if isinstance(sent, float) and sent != sent:  # NaN
                    isnull = lambda c, a: xp.isnan(oc.fn(c, a))  # noqa: E731
                else:
                    isnull = lambda c, a: oc.fn(c, a) == sent  # noqa: E731
                if e.negated:
                    return Compiled(lambda c, a: ~isnull(c, a), BOOL)
                return Compiled(isnull, BOOL)
            val = e.negated
            return Compiled(lambda c, a: xp.full(oc.fn(c, a).shape, val, dtype=bool), BOOL)

        if isinstance(e, E.Extract):
            oc = self._c(e.operand)
            if oc.dtype.kind != "date32":
                raise PlanningError("EXTRACT requires a date operand")
            field = e.field
            return Compiled(lambda c, a: xp.extract_field(oc.fn(c, a), field), INT32)

        if isinstance(e, E.Udf):
            from ..udf import GLOBAL_UDFS

            udf = GLOBAL_UDFS.get(e.name)
            if udf is None:
                raise PlanningError(f"unknown function {e.name!r} (not in the "
                                    "UDF registry on this node)")
            arg_c = [self._c(a) for a in e.args]
            out_t = udf.result_dtype([c.dtype for c in arg_c])
            f = udf.fn
            return Compiled(
                lambda c, a, f=f, arg_c=arg_c: f(*[ac.fn(c, a) for ac in arg_c]),
                out_t)

        if isinstance(e, E.Substring):
            oc = self._c(e.operand)
            if not oc.dtype.is_string:
                raise PlanningError("SUBSTRING requires a string operand")
            start, length = e.start, e.length

            def remap_builder(d, df=oc.dict_fn):
                src = df(d)
                subs = [None if s is None else s[start - 1 : (None if length is None else start - 1 + length)] for s in src]
                uniq = sorted({s for s in subs if s is not None})
                index = {s: i for i, s in enumerate(uniq)}
                return np.array([(-1 if s is None else index[s]) for s in subs], dtype=np.int32)

            def out_dict_fn(d, df=oc.dict_fn):
                src = df(d)
                subs = {None if s is None else s[start - 1 : (None if length is None else start - 1 + length)] for s in src}
                return np.array(sorted(s for s in subs if s is not None), dtype=object)

            slot = self._slot(remap_builder)
            return Compiled(
                lambda c, a, s=slot: xp.where(
                    oc.fn(c, a) >= 0, xp.take(a[s], oc.fn(c, a)), -1
                ),
                DataType("string"),
                dict_fn=out_dict_fn,
            )

        if isinstance(e, E.ScalarSubquery):
            raise InternalError(
                "scalar subquery must be substituted with its value before compilation"
            )
        if isinstance(e, E.Agg):
            raise InternalError("aggregate reached the expression compiler")
        raise PlanningError(f"cannot compile {type(e).__name__}")

    def _coerce_compiled(self, c: Compiled, to: DataType) -> Compiled:
        if c.dtype == to:
            return c
        if c.lit_value is not None:
            # re-materialize the literal directly in the target representation
            xp = self.xp
            v = self._lit_physical(E.Lit(c.lit_value), to)
            const = xp.asarray(v, dtype=to.np_dtype)
            return Compiled(lambda cc, a, k=const: k, to, lit_value=c.lit_value)
        return Compiled(self._coerce(c.fn, c.dtype, to), to, c.dict_fn if to.is_string else None)

    # --- NULL validity --------------------------------------------------
    def nullable_refs(self, e: E.Expr) -> list:
        """Nullable non-string column refs of ``e`` (strings carry NULL as
        code -1 and every string predicate path already excludes it)."""
        return sorted(
            n for n in e.column_refs()
            if n in self.schema
            and self.schema.field(n).nullable
            and not self.schema.field(n).dtype.is_string
        )

    def validity_fn(self, names) -> Optional[Callable]:
        """(cols, aux) -> bool mask, True where every named column is
        non-NULL (sentinel-free).  None when nothing is nullable."""
        if not names:
            return None
        xp = self.xp
        terms = []
        for n in names:
            sent = self.schema.field(n).dtype.null_sentinel
            if isinstance(sent, float) and sent != sent:  # NaN
                terms.append(lambda c, a, n=n: ~xp.isnan(c[n]))
            else:
                terms.append(lambda c, a, n=n, s=sent: c[n] != s)

        def valid(c, a):
            m = terms[0](c, a)
            for t in terms[1:]:
                m = m & t(c, a)
            return m

        return valid

    # --- three-valued predicate compilation ------------------------------
    def compile_pred(self, expr: E.Expr) -> Compiled:
        """Compile a WHERE/HAVING/join predicate under SQL three-valued
        logic, collapsed to its TRUE-mask (rows kept).  Kleene composition:
        the collapsed value at every node is exactly "this subtree is TRUE",
        and a parallel validity ("not NULL") stream makes NOT correct over
        arbitrary boolean combinations — ``NOT (x < 50 or x > 100)`` with
        NULL x is NULL, not TRUE.  (The reference gets this from Arrow
        validity bitmaps flowing through DataFusion's kernels.)"""
        coll, _valid = self._pred3(fold_constants(expr))
        return Compiled(coll, BOOL)

    def _pred3(self, e: E.Expr):
        """Returns (true_mask_fn, valid_fn).  valid_fn None means
        never-NULL."""
        xp = self.xp
        if isinstance(e, E.BinOp) and e.op in E.BinOp.BOOLEANS:
            lc, lv = self._pred3(e.left)
            rc, rv = self._pred3(e.right)
            if e.op == "and":
                coll = lambda c, a: lc(c, a) & rc(c, a)  # noqa: E731
                if lv is None and rv is None:
                    valid = None
                else:
                    # Kleene AND: valid iff both valid, or either is
                    # (validly) FALSE — FALSE dominates NULL
                    def valid(c, a, lc=lc, rc=rc, lv=lv, rv=rv):
                        l_ok = lv(c, a) if lv is not None else True
                        r_ok = rv(c, a) if rv is not None else True
                        return (l_ok & r_ok) | (l_ok & ~lc(c, a)) | (r_ok & ~rc(c, a))
            else:
                coll = lambda c, a: lc(c, a) | rc(c, a)  # noqa: E731
                if lv is None and rv is None:
                    valid = None
                else:
                    # Kleene OR: TRUE dominates NULL
                    def valid(c, a, lc=lc, rc=rc, lv=lv, rv=rv):
                        l_ok = lv(c, a) if lv is not None else True
                        r_ok = rv(c, a) if rv is not None else True
                        return (l_ok & r_ok) | lc(c, a) | rc(c, a)
            return coll, valid
        if isinstance(e, E.Not):
            oc, ov = self._pred3(e.operand)
            if ov is None:
                return (lambda c, a: ~oc(c, a)), None
            # NOT NULL is NULL: TRUE-mask = valid AND (validly) not-TRUE
            return (lambda c, a: ov(c, a) & ~oc(c, a)), ov
        if isinstance(e, E.IsNull):
            # IS [NOT] NULL is itself never NULL
            return self._c(e).fn, None
        # leaves (comparisons, IN, LIKE, boolean columns): _c already
        # collapses NULL -> FALSE; validity covers every nullable ref
        coll = self._c(e).fn
        valid = self._leaf_validity(e)
        return coll, valid

    def _leaf_validity(self, e: E.Expr):
        """Validity over every nullable column a leaf predicate references,
        including nullable *string* columns (NULL string = code -1)."""
        terms = []
        xp = self.xp
        for n in sorted(e.column_refs()):
            if n not in self.schema or not self.schema.field(n).nullable:
                continue
            f = self.schema.field(n)
            if f.dtype.is_string:
                terms.append(lambda c, a, n=n: c[n] >= 0)
            else:
                sent = f.dtype.null_sentinel
                if isinstance(sent, float) and sent != sent:
                    terms.append(lambda c, a, n=n: ~xp.isnan(c[n]))
                else:
                    terms.append(lambda c, a, n=n, s=sent: c[n] != s)
        if not terms:
            return None

        def valid(c, a):
            m = terms[0](c, a)
            for t in terms[1:]:
                m = m & t(c, a)
            return m

        return valid

    # --- comparisons ----------------------------------------------------
    def _compile_comparison(self, e: E.BinOp) -> Compiled:
        """SQL comparison: NULL operands compare as false (the WHERE-clause
        collapse of three-valued logic) — the result is ANDed with a
        validity term over every nullable column referenced (in-band
        sentinels are otherwise ordinary values; reference semantics come
        from Arrow validity bitmaps, which this engine replaces with
        sentinels + masks)."""
        c = self._compile_comparison_raw(e)
        valid = self.validity_fn(self.nullable_refs(e))
        if valid is None:
            return c
        return Compiled(lambda cols, a: c.fn(cols, a) & valid(cols, a), BOOL)

    def _compile_comparison_raw(self, e: E.BinOp) -> Compiled:
        xp = self.xp
        sch = self.schema
        lt = e.left.dtype(sch)
        rt = e.right.dtype(sch)

        # string comparisons via dictionary lookup tables
        if lt.is_string or rt.is_string:
            if lt.is_string and isinstance(e.right, E.Lit) and isinstance(e.right.value, str):
                return self._string_cmp(self._c(e.left), e.op, e.right.value)
            if rt.is_string and isinstance(e.left, E.Lit) and isinstance(e.left.value, str):
                flipped = {"<": ">", "<=": ">=", ">": "<", ">=": "<=", "=": "=", "<>": "<>"}[e.op]
                return self._string_cmp(self._c(e.right), flipped, e.left.value)
            raise PlanningError(f"unsupported string comparison {e}")

        # numeric/date: unify to a common physical representation
        target = self._cmp_target(lt, rt)
        lc = self._coerce_compiled(self._c(e.left), target)
        rc = self._coerce_compiled(self._c(e.right), target)
        op = e.op

        def cmp_fn(c, a):
            l, r = lc.fn(c, a), rc.fn(c, a)
            if op == "=":
                return l == r
            if op == "<>":
                return l != r
            if op == "<":
                return l < r
            if op == "<=":
                return l <= r
            if op == ">":
                return l > r
            return l >= r

        return Compiled(cmp_fn, BOOL)

    def _cmp_target(self, lt: DataType, rt: DataType) -> DataType:
        if lt == rt:
            return lt
        if lt.kind == "date32" or rt.kind == "date32":
            return DATE32
        if lt.is_float or rt.is_float:
            if self.mode == "device":
                # comparing a decimal/int column against a float literal:
                # scale into the decimal domain instead of floating point
                if lt.is_decimal or rt.is_decimal:
                    return lt if lt.is_decimal else rt
                return FLOAT64  # ints vs float in device mode -> error in _coerce
            return FLOAT64
        if lt.is_decimal or rt.is_decimal:
            ls = lt.scale if lt.is_decimal else 0
            rs = rt.scale if rt.is_decimal else 0
            from ..models.schema import decimal

            return decimal(max(ls, rs))
        if lt.kind == "int64" or rt.kind == "int64":
            return INT64
        return INT32

    def _string_cmp(self, oc: Compiled, op: str, value: str) -> Compiled:
        xp = self.xp

        def lut_builder(d, df=oc.dict_fn):
            dic = df(d)
            if len(dic) == 0:
                return np.zeros(1, dtype=bool)
            arr = np.array([s if s is not None else "" for s in dic], dtype=object)
            if op == "=":
                out = arr == value
            elif op == "<>":
                out = arr != value
            elif op == "<":
                out = arr < value
            elif op == "<=":
                out = arr <= value
            elif op == ">":
                out = arr > value
            else:
                out = arr >= value
            return out.astype(bool)

        slot = self._slot(lut_builder)
        return Compiled(
            lambda c, a, s=slot: xp.take(a[s], oc.fn(c, a)) & (oc.fn(c, a) >= 0),
            BOOL,
        )

    # --- arithmetic -----------------------------------------------------
    def _compile_arith(self, e: E.BinOp) -> Compiled:
        sch = self.schema
        lt, rt = e.left.dtype(sch), e.right.dtype(sch)
        out_t = E.unify_arith(e.op, lt, rt)
        xp = self.xp
        op = e.op

        # date +/- interval days
        if lt.kind == "date32" and rt.kind == "int32":
            lc, rc = self._c(e.left), self._c(e.right)
            if isinstance(e.right, E.Lit) and e.right.kind == "interval_month":
                raise PlanningError("month interval arithmetic on a column is unsupported")
            sign = 1 if op == "+" else -1
            return Compiled(lambda c, a: xp.astype(lc.fn(c, a) + sign * rc.fn(c, a), "int32"),
                            DATE32)

        if op == "/":
            if self.mode == "device":
                raise PlanningError(
                    "division reached the device compiler; divisions must be in "
                    "host-finalize projections"
                )
            lc = self._coerce_compiled(self._c(e.left), FLOAT64)
            rc = self._coerce_compiled(self._c(e.right), FLOAT64)
            return Compiled(lambda c, a: lc.fn(c, a) / rc.fn(c, a), FLOAT64)

        if op == "%":
            lc = self._coerce_compiled(self._c(e.left), out_t)
            rc = self._coerce_compiled(self._c(e.right), out_t)
            return Compiled(lambda c, a: lc.fn(c, a) % rc.fn(c, a), out_t)

        if out_t.is_decimal and op == "*":
            # scales add: compute in raw int64 without rescaling operands
            lc, rc = self._c(e.left), self._c(e.right)
            lfn = lc.fn if lc.dtype.is_decimal else self._coerce(lc.fn, lc.dtype, DataType("decimal", 0))
            rfn = rc.fn if rc.dtype.is_decimal else self._coerce(rc.fn, rc.dtype, DataType("decimal", 0))
            return Compiled(lambda c, a: xp.astype(lfn(c, a), "int64") * xp.astype(rfn(c, a), "int64"),
                            out_t)

        lc = self._coerce_compiled(self._c(e.left), out_t)
        rc = self._coerce_compiled(self._c(e.right), out_t)
        if op == "+":
            return Compiled(lambda c, a: lc.fn(c, a) + rc.fn(c, a), out_t)
        if op == "-":
            return Compiled(lambda c, a: lc.fn(c, a) - rc.fn(c, a), out_t)
        if op == "*":
            # float multiply (decimal*decimal is handled above): both sides
            # coerced to the float result type
            return Compiled(lambda c, a: lc.fn(c, a) * rc.fn(c, a), out_t)
        raise PlanningError(f"unsupported arithmetic {op}")
