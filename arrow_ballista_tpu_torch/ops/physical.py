"""Physical plan base + scan operators.

Mirrors arrow_ballista_tpu/ops/physical.py: ``execute(partition)`` returns
a list of fixed-capacity ColumnBatches on the task's device.  The scans
are the in-memory scan, the row-group-granular parquet scan (statistics
pruning, the double-buffered cold read, the clustered-key probe) and the
whole-file csv (``.tbl`` too), newline-delimited json and avro scans; every
path resolves through the object-store registry (utils/object_store.py).
Parquet scans keep their converted batches in the device-resident scan
cache (utils/table_cache.py).  A scan's pushed-down filters run as one K19
mask program (compile/programs.py).
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models import expr as E
from ..models.batch import ColumnBatch
from ..models.ipc import int64_decimal_storage_scale
from ..models.schema import DataType, Schema
from ..obs import device as device_obs
from ..utils.config import BallistaConfig
from ..utils.errors import CancelledError, ExecutionError
from .expressions import ExprCompiler


# --------------------------------------------------------------------------
# execution context & metrics
# --------------------------------------------------------------------------


class MetricsSet:
    """Per-operator metrics (name -> accumulated value), thread-safe."""

    def __init__(self):
        self.values: Dict[str, float] = {}
        # RLock: deferred resolvers run under the lock in to_dict and may
        # record metrics themselves (the fused aggregate's passthrough latch)
        self._lock = threading.RLock()
        self._deferred = []  # [(name, fn)], resolved in to_dict

    def add(self, name: str, v: float):
        with self._lock:
            self.values[name] = self.values.get(name, 0) + v

    def add_deferred(self, name: str, fn):
        """A metric whose value would cost a device->host sync now: ``fn()``
        returns it, or None while it is not host-known yet (it then stays
        queued for the next snapshot).  The shuffle writer's packed copy
        normally makes the value free before any snapshot."""
        with self._lock:
            self._deferred.append((name, fn))

    def timer(self, name: str):
        return _Timer(self, name)

    def peek(self) -> Dict[str, float]:
        """The values recorded so far, deferred ones left unresolved (a
        tracing span's before/after snapshot: resolving them mid-task would
        move the passthrough latch, which resolves at the task's metrics
        snapshot)."""
        with self._lock:
            return dict(self.values)

    def to_dict(self):
        with self._lock:
            pending = []
            for name, fn in self._deferred:
                v = fn()
                if v is None:
                    pending.append((name, fn))
                else:
                    self.values[name] = self.values.get(name, 0) + v
            self._deferred = pending
            return dict(self.values)


def deferred_count(batch):
    """A resolver of ``batch``'s live-row count for a deferred metric:
    the count once it is host-known (``ColumnBatch.on_count``), None while
    the batch lives uncounted, 0 for a batch collected uncounted.  Holds
    the batch only weakly, so no device buffer is pinned."""
    import weakref

    counted = []
    batch.on_count(counted.append)
    ref = weakref.ref(batch)

    def count():
        if counted:
            return counted[0]
        return None if ref() is not None else 0

    return count


def deferred_rows(ms: MetricsSet, name: str, batch) -> None:
    """Record ``batch``'s row count as a deferred metric."""
    ms.add_deferred(name, deferred_count(batch))


class _Timer:
    """Host wall time of a block.  Device work is asynchronous, so the time
    is what the host spent, including any synchronising copy inside."""

    def __init__(self, ms: MetricsSet, name: str):
        self.ms, self.name = ms, name

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.ms.add(self.name, time.perf_counter() - self.t0)


# --------------------------------------------------------------------------
# cross-job compiled-program cache
# --------------------------------------------------------------------------
#
# Operators build their expression closures (and upload literal constants
# and lookup tables) per plan instance, and plan instances are per query.
# Closures whose behaviour depends only on (exprs, input schema, device)
# are shared process-wide here, so a repeated query reuses its constants
# and its dictionary LUTs.

_program_cache = collections.OrderedDict()
_PROGRAM_CACHE_MAX = 256
_program_cache_lock = threading.Lock()


def shared_program(key, build):
    """Memoize ``build()`` under ``key``.  A key containing None (an
    expression with no stable signature) disables sharing."""
    if any(k is None for k in key):
        return build()
    with _program_cache_lock:
        hit = _program_cache.get(key)
        if hit is not None:
            _program_cache.move_to_end(key)
    if hit is not None:
        device_obs.record_program_cache(True)
        return hit
    device_obs.record_program_cache(False)
    built = build()
    with _program_cache_lock:
        now = _program_cache.get(key)
        if now is not None:
            return now
        _program_cache[key] = built
        while len(_program_cache) > _PROGRAM_CACHE_MAX:
            _program_cache.popitem(last=False)
    return built


def schema_sig(s) -> tuple:
    return tuple((f.name, f.dtype.kind, f.dtype.scale, f.nullable) for f in s)


def exprs_sig(exprs) -> Optional[str]:
    """Stable signature of expressions (their dataclass repr); None when an
    expression calls a UDF, whose function the closure bakes in."""

    def has_udf(e):
        if e is None:
            return False
        return isinstance(e, E.Udf) or any(has_udf(c) for c in e.children())

    if any(has_udf(e) for e in exprs):
        return None
    return repr(list(exprs))


def has_scalar_subquery(*exprs) -> bool:
    """True when any expression embeds a ScalarSubquery: its value is
    substituted per job, so the compiled closure must not be shared."""

    def walk(e):
        if e is None:
            return False
        if isinstance(e, E.ScalarSubquery):
            return True
        return any(walk(c) for c in e.children())

    return any(walk(e) for e in exprs)


@dataclasses.dataclass
class TaskContext:
    device: torch.device = dataclasses.field(default_factory=lambda: torch.device("cuda"))
    config: BallistaConfig = dataclasses.field(default_factory=BallistaConfig)
    scalars: Dict[str, object] = dataclasses.field(default_factory=dict)
    work_dir: str = ""
    job_id: str = ""
    stage_id: int = 0
    executor_id: str = ""  # identity of the executing node (shuffle locality)
    # the executor's advertised host: a shuffle reader maps a co-located
    # producer's file when its host matches ("" = no host match)
    executor_host: str = ""
    # shuffle partition locations: (stage_id, partition) -> [PartitionLocation]
    shuffle_locations: Dict = dataclasses.field(default_factory=dict)
    # cooperative cancellation probe; operators call check_cancelled() at
    # batch/operator boundaries
    cancelled: Optional[Callable[[], bool]] = None
    # memory governor (memory/governor.py): operators holding unbounded
    # state reserve before materializing it and spill on a denial; None
    # means no accounting
    governor: Optional[object] = None
    # obs.tracing.TaskSpanRecorder of the running task; None = tracing off
    span_recorder: Optional[object] = None

    def check_cancelled(self) -> None:
        if self.cancelled is not None and self.cancelled():
            from .. import faults

            # delay failpoint: widens the window between the cancel and the
            # raise, so a test can race cancellation against completion
            faults.inject("executor.task.cancel.checkpoint",
                          job_id=self.job_id, stage_id=self.stage_id)
            raise CancelledError(f"job {self.job_id} cancelled")

    def op_span(self, op):
        """Spans one operator's execute call: times it into its
        ``elapsed_time`` metric (host wall time, children included), enters
        the device observatory's attribution scope when that is on
        (obs/device.py: the kernels launched inside count against this
        operator) and the tracing span when a recorder rides along.  With
        both off it is the timer alone."""
        if self.span_recorder is None:
            if not device_obs._enabled:
                return op.metrics().timer("elapsed_time")
            return device_obs.op_scope(op, timed=True)
        return _span_and_device(self.span_recorder.op_span(op), op)


@contextlib.contextmanager
def _span_and_device(span_cm, op):
    """Tracing span around the timed device-attribution scope of one
    operator execute: the span's metric-delta snapshot
    (TaskSpanRecorder.op_span) sees the time and the launches this call
    added."""
    with span_cm:
        if device_obs._enabled:
            with device_obs.op_scope(op, timed=True):
                yield
        else:
            with op.metrics().timer("elapsed_time"):
                yield


# --------------------------------------------------------------------------
# partitioning descriptors
# --------------------------------------------------------------------------


@dataclasses.dataclass
class Partitioning:
    kind: str  # 'unknown' | 'hash' | 'single'
    count: int
    exprs: Sequence[E.Expr] = ()

    @staticmethod
    def unknown(n: int) -> "Partitioning":
        return Partitioning("unknown", n)

    @staticmethod
    def hash(exprs: Sequence[E.Expr], n: int) -> "Partitioning":
        return Partitioning("hash", n, tuple(exprs))

    @staticmethod
    def single() -> "Partitioning":
        return Partitioning("single", 1)


_LOCK_CREATE = threading.Lock()


class ExecutionPlan:
    """Base physical operator."""

    _schema: Schema

    @property
    def schema(self) -> Schema:
        return self._schema

    def build_lock(self) -> threading.Lock:
        """Per-operator lock guarding the lazy build of compiled closures."""
        lock = getattr(self, "_build_lock", None)
        if lock is None:
            with _LOCK_CREATE:
                lock = getattr(self, "_build_lock", None)
                if lock is None:
                    self._build_lock = lock = threading.Lock()
        return lock

    def children(self) -> List["ExecutionPlan"]:
        return []

    def output_partitioning(self) -> Partitioning:
        return Partitioning.unknown(self.output_partition_count())

    def output_partition_count(self) -> int:
        raise NotImplementedError

    def execute(self, partition: int, ctx: TaskContext) -> List[ColumnBatch]:
        raise NotImplementedError

    def metrics(self) -> MetricsSet:
        ms = getattr(self, "_metrics", None)
        if ms is None:
            with _LOCK_CREATE:
                ms = getattr(self, "_metrics", None)
                if ms is None:
                    self._metrics = ms = MetricsSet()
        return ms

    # display
    def display(self, indent: int = 0) -> str:
        s = "  " * indent + self._label()
        for c in self.children():
            s += "\n" + c.display(indent + 1)
        return s

    def _label(self) -> str:
        return type(self).__name__

    def __repr__(self):
        return self.display()


# --------------------------------------------------------------------------
# arrow -> physical conversion (host, numpy)
# --------------------------------------------------------------------------


def _sorted_dictionary(dic: np.ndarray, codes: np.ndarray):
    """Re-sort a dictionary lexicographically and remap codes (engine
    invariant: dictionaries are sorted, so code order == string order)."""
    order = np.argsort(dic)
    rank = np.empty(len(order), dtype=np.int32)
    rank[order] = np.arange(len(order), dtype=np.int32)
    new_codes = np.where(codes >= 0, rank[np.clip(codes, 0, None)], -1).astype(np.int32)
    return dic[order], new_codes


def table_to_physical(table, schema: Schema):
    """pyarrow Table -> (numpy cols dict, dicts dict) in physical repr."""
    import pyarrow as pa
    import pyarrow.compute as pc

    cols: Dict[str, np.ndarray] = {}
    dicts: Dict[str, np.ndarray] = {}
    for f in schema:
        arr = table.column(f.name)
        if f.dtype.is_string:
            combined = arr.combine_chunks() if isinstance(arr, pa.ChunkedArray) else arr
            if not pa.types.is_dictionary(combined.type):
                combined = pc.dictionary_encode(combined)
            if isinstance(combined, pa.ChunkedArray):
                combined = combined.combine_chunks()
            indices = pc.fill_null(combined.indices, -1)
            codes = indices.to_numpy(zero_copy_only=False).astype(np.int32)
            dic = np.asarray(combined.dictionary.to_pylist(), dtype=object)
            dic_sorted, codes = _sorted_dictionary(dic, codes) if len(dic) else (dic, codes)
            cols[f.name] = codes
            dicts[f.name] = dic_sorted if len(dic) else dic
        elif f.dtype.kind == "date32":
            a = arr
            if not pa.types.is_date32(a.type):
                a = a.cast(pa.date32())
            a = a.cast(pa.int32())
            if a.null_count:
                a = pc.fill_null(a, int(f.dtype.null_sentinel))
            cols[f.name] = a.to_numpy(zero_copy_only=False).astype(np.int32)
        elif f.dtype.is_decimal:
            ftype = table.schema.field(f.name)
            if pa.types.is_integer(ftype.type):
                # int64-stored decimal (unscaled values; metadata carries
                # the storage scale): already the physical representation,
                # up to a power-of-ten rescale when schemas disagree
                sscale = int64_decimal_storage_scale(ftype) or 0
                nulls = None
                a = arr
                if a.null_count:
                    if isinstance(a, pa.ChunkedArray):
                        a = a.combine_chunks()
                    nulls = pc.is_null(a).to_numpy(zero_copy_only=False)
                    a = pc.fill_null(a, 0)
                vals = a.cast(pa.int64()).to_numpy(zero_copy_only=False)
                if sscale != f.dtype.scale:
                    if f.dtype.scale > sscale:
                        factor = np.int64(10 ** (f.dtype.scale - sscale))
                        if len(vals) and np.abs(vals).max() > (2**63 - 1) // int(factor):
                            raise ExecutionError(
                                f"decimal column {f.name} exceeds int64 range after rescale")
                        vals = vals * factor
                    else:
                        vals = vals // np.int64(10 ** (sscale - f.dtype.scale))
                vals = vals.astype(np.int64, copy=False)
                if nulls is not None:
                    vals = vals.copy()
                    vals[nulls] = np.int64(f.dtype.null_sentinel)
                cols[f.name] = vals
                continue
            # NULLs can't ride the float64 conversion (the int64-min
            # sentinel exceeds the 2^52 exact range): remember them, fill
            # with 0 for conversion, then stamp the sentinel back in
            nulls = None
            a = arr
            if a.null_count:
                if isinstance(a, pa.ChunkedArray):
                    a = a.combine_chunks()
                nulls = pc.is_null(a).to_numpy(zero_copy_only=False)
                a = pc.fill_null(a, 0)
            fl = a.cast(pa.float64()).to_numpy(zero_copy_only=False)
            scaled = np.round(fl * (10 ** f.dtype.scale))
            if np.any(np.abs(scaled) > 2**52):
                raise ExecutionError(
                    f"decimal column {f.name} exceeds exact float64 conversion range")
            out = scaled.astype(np.int64)
            if nulls is not None:
                out[nulls] = np.int64(f.dtype.null_sentinel)
            cols[f.name] = out
        else:
            a = arr
            if a.null_count:
                # real input NULLs -> the per-dtype in-band sentinel
                sent = f.dtype.null_sentinel
                if isinstance(sent, float):
                    a = a.cast(pa.float64())
                    vals = a.to_numpy(zero_copy_only=False)  # nulls -> NaN
                    cols[f.name] = vals.astype(f.dtype.np_dtype)
                    continue
                a = pc.fill_null(a, int(sent) if not isinstance(sent, bool) else sent)
            cols[f.name] = a.to_numpy(zero_copy_only=False).astype(f.dtype.np_dtype)
    return cols, dicts


def table_to_batches(table, schema: Schema, capacity: int, device) -> List[ColumnBatch]:
    """Split an arrow table into fixed-capacity batches on ``device``
    (shared, sorted dictionaries across all batches of this table)."""
    from ..models.batch import round_capacity

    cols, dicts = table_to_physical(table, schema)
    n = table.num_rows
    if n == 0:
        return [ColumnBatch.empty(schema, min(capacity, 1024), device=device)]
    out = []
    for start in range(0, n, capacity):
        end = min(start + capacity, n)
        chunk = {k: v[start:end] for k, v in cols.items()}
        cap = capacity if end - start == capacity else round_capacity(end - start)
        out.append(ColumnBatch.from_numpy(schema, chunk, dicts=dicts, capacity=cap,
                                          device=device))
    return out


# --------------------------------------------------------------------------
# scans
# --------------------------------------------------------------------------


class ScanExec(ExecutionPlan):
    """Base: reads arrow tables per partition, converts to device batches,
    applies pushed-down filters inside the scan ("scan.filter")."""

    def __init__(self, schema: Schema, filters: Sequence[E.Expr] = ()):
        self._schema = schema
        self.filters = list(filters)
        self._compiled = None

    def _read_partition(self, partition: int):  # -> pyarrow table
        raise NotImplementedError

    def _cache_key(self, partition: int, capacity: int):
        """Key for the device-resident scan cache, or None when this scan
        cannot be cached (a volatile source).  Must embed source
        versioning (file mtime and size) so stale data is never served."""
        return None

    def output_partition_count(self) -> int:
        raise NotImplementedError

    def _produce_batches(self, partition: int, ctx: TaskContext,
                         capacity: int) -> List[ColumnBatch]:
        """Read and convert one partition to device batches (pre-filter)."""
        with self.metrics().timer("scan_read_time"):
            table = self._read_partition(partition)
        ctx.check_cancelled()
        with self.metrics().timer("scan_convert_time"):
            return table_to_batches(table, self._schema, capacity, ctx.device)

    def execute(self, partition: int, ctx: TaskContext) -> List[ColumnBatch]:
        with ctx.op_span(self):
            return self._execute(partition, ctx)

    def _execute(self, partition: int, ctx: TaskContext) -> List[ColumnBatch]:
        from ..utils import table_cache
        from ..utils.config import SCAN_CACHE_BYTES

        ctx.check_cancelled()
        capacity = ctx.config.batch_size
        budget = table_cache.resolve_budget(ctx.config.get(SCAN_CACHE_BYTES), ctx.device)
        key = self._cache_key(partition, capacity) if budget else None
        if key is not None:
            key = (str(ctx.device),) + key  # a CPU and a card context never share
        batches = table_cache.CACHE.get(key) if key is not None else None
        if batches is None:
            batches = self._produce_batches(partition, ctx, capacity)
            if key is not None:
                table_cache.CACHE.set_budget(budget)
                table_cache.CACHE.put(key, batches)
        else:
            self.metrics().add("scan_cache_hits", 1)
        self.metrics().add("output_rows", sum(b.num_rows for b in batches))
        if not self.filters:
            return batches
        from ..compile.programs import operator_program

        prog = self._filter_program(ctx)
        out = []
        with self.metrics().timer("scan_filter_time"):
            for b in batches:
                # a new mask on top: cached batches are never written
                new_mask = operator_program(prog, b.columns, b.mask, prog.aux_arrays(b.dicts))
                out.append(ColumnBatch(b.schema, b.columns, new_mask, b.dicts))
        return out

    def _filter_program(self, ctx: TaskContext):
        """The pushed-down filters as one K19 mask program, shared across
        jobs by signature."""
        from ..compile.programs import mask_program

        with self.build_lock():
            if self._compiled is None:
                def compile_pred(xp, dev):
                    comp = ExprCompiler(self._schema, "device", dev, xp=xp)
                    return comp, comp.compile_pred(E.and_all(self.filters))

                self._compiled = shared_program(
                    ("scanfilter", str(ctx.device), schema_sig(self._schema),
                     exprs_sig(self.filters)),
                    lambda: mask_program("scan filter", self._schema, compile_pred, ctx.device))
            return self._compiled

    def device_programs(self, ctx: TaskContext):
        return [self._filter_program(ctx)] if self.filters else []


class MemoryScanExec(ScanExec):
    """In-memory table scan, row-sliced into partitions."""

    def __init__(self, schema: Schema, table, partitions: int = 1,
                 filters: Sequence[E.Expr] = ()):
        super().__init__(schema, filters)
        self.table = table.select(schema.names())
        self.partitions = max(1, min(partitions, max(1, self.table.num_rows)))

    def output_partition_count(self) -> int:
        return self.partitions

    def _read_partition(self, partition: int):
        n = self.table.num_rows
        per = (n + self.partitions - 1) // self.partitions
        start = partition * per
        return self.table.slice(start, per)

    def _label(self):
        return f"MemoryScanExec: {self.table.num_rows} rows, {self.partitions} partitions"


def _simple_predicates(filters: Sequence[E.Expr], schema: Schema):
    """``column <op> literal`` conjuncts usable against parquet row-group
    statistics: [(col_name, op, value, dtype)] with the literal in the
    column's physical domain (dates as epoch days, decimals as scaled ints,
    by the rounding of ExprCompiler._lit_physical) — the domain the
    executed predicate compares in, so pruning never disagrees with
    execution."""
    from .expressions import fold_constants

    conv = ExprCompiler(schema, "host")
    out = []
    for f in filters:
        for c in E.conjuncts(f):
            c = fold_constants(c)
            if not (isinstance(c, E.BinOp) and c.op in ("=", "<", "<=", ">", ">=")):
                continue
            col, lit, op = None, None, c.op
            if isinstance(c.left, E.Column) and isinstance(c.right, E.Lit):
                col, lit = c.left, c.right
            elif isinstance(c.right, E.Column) and isinstance(c.left, E.Lit):
                col, lit = c.right, c.left
                op = {"<": ">", "<=": ">=", ">": "<", ">=": "<=", "=": "="}[op]
            if col is None or col.name not in schema:
                continue
            v = lit.value
            if isinstance(v, bool) or v is None:
                continue
            dt = schema.field(col.name).dtype
            if not isinstance(v, str):
                try:
                    v = conv._lit_physical(lit, dt)
                except Exception:  # noqa: BLE001 — a literal the column can't take: no pruning
                    continue
            out.append((col.name, op, v, dt))
    return out


def _stats_refute(stats, op: str, value, dt: DataType,
                  stats_scale: Optional[int] = None) -> bool:
    """True iff row-group statistics prove no row can satisfy
    ``col op value``.  ``value`` is in the column's physical domain;
    min/max are converted into it before comparing.  ``stats_scale``: the
    storage scale of an int64-stored decimal column, whose integer
    statistics are already scaled by 10^stats_scale and must not be scaled
    again (double scaling would wrongly refute matching row groups)."""
    if stats is None or not stats.has_min_max:
        return False
    lo, hi = stats.min, stats.max
    try:
        if isinstance(value, str):
            if not isinstance(lo, (str, bytes)):
                return False
            if isinstance(lo, bytes):
                lo, hi = lo.decode("utf-8", "replace"), hi.decode("utf-8", "replace")
        else:
            import datetime
            import decimal as pydec

            def phys(x):
                # datetime.datetime before datetime.date (a subclass): both
                # map to epoch days
                if isinstance(x, datetime.datetime):
                    return (x.date() - datetime.date(1970, 1, 1)).days
                if isinstance(x, datetime.date):
                    return (x - datetime.date(1970, 1, 1)).days
                if dt.is_decimal:
                    if stats_scale is not None and isinstance(x, int):
                        # exact; floor division as in the row conversion
                        if dt.scale >= stats_scale:
                            return x * (10 ** (dt.scale - stats_scale))
                        return x // (10 ** (stats_scale - dt.scale))
                    if isinstance(x, pydec.Decimal):
                        return int(x.scaleb(dt.scale))
                    return float(x) * (10 ** dt.scale)
                if isinstance(x, (int, float, pydec.Decimal)):
                    return float(x)
                raise TypeError(f"unusable stats value {x!r}")

            lo, hi = phys(lo), phys(hi)
        if op == "=":
            return value < lo or value > hi
        if op == "<":
            return lo >= value
        if op == "<=":
            return lo > value
        if op == ">":
            return hi <= value
        if op == ">=":
            return hi < value
    except (TypeError, ValueError, ArithmeticError):
        return False
    return False


Unit = Tuple[str, int, int]  # (file, row group, rows)


class ParquetScanExec(ScanExec):
    """Parquet scan at row-group granularity: the partition unit is a
    (file, row group) pair, balanced across ``target_partitions`` by row
    count, so a single large file still scans in parallel.

    Pushdown: simple ``col <op> literal`` conjuncts are checked against
    row-group min/max statistics at plan time, and refuted row groups are
    never read.  Every predicate is applied again on the device (pruning
    only over-approximates)."""

    def __init__(self, schema: Schema, paths: List[str], target_partitions: int,
                 filters: Sequence[E.Expr] = (), table_schema: Optional[Schema] = None):
        super().__init__(schema, filters)
        from ..utils import object_store

        self.table_schema = table_schema or schema
        files = []
        for p in paths:
            files.extend(object_store.list_files(p, (".parquet",)))
        if not files:
            raise ExecutionError(f"no parquet files found in {paths}")
        self.files = files

        preds = _simple_predicates(self.filters, self.table_schema)
        units: List[Unit] = []
        self.pruned_row_groups = 0
        for f in files:
            with object_store.parquet_file(f) as pf:
                meta = pf.metadata
                # int64-stored decimals: integer statistics in the
                # storage-scaled domain
                stats_scales = {}
                for af in pf.schema_arrow:
                    s = int64_decimal_storage_scale(af)
                    if s is not None:
                        stats_scales[af.name] = s
            name_to_idx = {meta.schema.column(i).name: i for i in range(meta.num_columns)}
            for rg in range(meta.num_row_groups):
                g = meta.row_group(rg)
                refuted = False
                for col, op, v, dt in preds:
                    ci = name_to_idx.get(col)
                    if ci is None:
                        continue
                    if _stats_refute(g.column(ci).statistics, op, v, dt,
                                     stats_scale=stats_scales.get(col)):
                        refuted = True
                        break
                if refuted:
                    self.pruned_row_groups += 1
                else:
                    units.append((f, rg, g.num_rows))
        self._total_rows = sum(u[2] for u in units)
        if not units:  # everything pruned: one empty partition
            self.groups: List[List[Unit]] = [[]]
        else:
            import heapq

            # greedy row-count balancing into k partitions
            k = max(1, min(target_partitions, len(units)))
            heap = [(0, i) for i in range(k)]
            groups: List[List[Unit]] = [[] for _ in range(k)]
            heapq.heapify(heap)
            for u in sorted(units, key=lambda u: -u[2]):
                rows, i = heapq.heappop(heap)
                groups[i].append(u)
                heapq.heappush(heap, (rows + u[2], i))
            self.groups = [g for g in groups if g]

    def output_partition_count(self) -> int:
        return len(self.groups)

    def _cache_key(self, partition: int, capacity: int):
        """(file, row group, mtime, size) units + projection + capacity."""
        import os

        units = self.groups[partition]
        if not units:
            return None
        versioned = []
        for f, rg, _rows in units:
            try:
                st = os.stat(f)
            except OSError:
                return None
            versioned.append((f, rg, st.st_mtime_ns, st.st_size))
        return ("parquet", tuple(versioned), tuple(self._schema.names()), capacity)

    def _read_units(self, units: Sequence[Unit]):
        """Arrow table of ``units``.  Runs on the scan's reader thread:
        it touches files and arrow only, never the device."""
        import pyarrow as pa

        from ..utils import object_store

        if not units:
            return self._schema.to_arrow_empty()
        by_file: Dict[str, List[int]] = {}
        for f, rg, _ in units:
            by_file.setdefault(f, []).append(rg)
        cols = self._schema.names()
        # string columns come back dictionary-coded straight from the pages
        rd = [f.name for f in self._schema if f.dtype.is_string] or None
        def read(item):
            f, rgs = item
            return object_store.read_parquet_row_groups(f, sorted(rgs), cols, read_dictionary=rd)

        if len(by_file) == 1:
            return read(next(iter(by_file.items())))
        from concurrent.futures import ThreadPoolExecutor

        # overlap the files' reads (each pyarrow read releases the GIL)
        with ThreadPoolExecutor(max_workers=min(8, len(by_file))) as pool:
            return pa.concat_tables(list(pool.map(read, by_file.items())))

    def _read_partition(self, partition: int):
        return self._read_units(self.groups[partition])

    def _produce_batches(self, partition: int, ctx: TaskContext,
                         capacity: int) -> List[ColumnBatch]:
        """Double-buffered cold path: one reader thread reads chunk i+1
        while the calling thread converts chunk i and copies it to the
        device, so a cold scan costs about max(read, convert + H2D) and not
        their sum.  Chunks group row-group units to at least ``capacity``
        rows, so the batch shapes match the unpipelined path.  Chunk-local
        string dictionaries may differ; consumers unify them on demand
        (models/batch.py _unify_string_dicts)."""
        units = self.groups[partition]
        chunks: List[List[Unit]] = []
        cur, cur_rows = [], 0
        for u in sorted(units):
            cur.append(u)
            cur_rows += u[2]
            if cur_rows >= capacity:
                chunks.append(cur)
                cur, cur_rows = [], 0
        if cur:
            chunks.append(cur)
        if len(chunks) <= 1:
            return super()._produce_batches(partition, ctx, capacity)
        from concurrent.futures import ThreadPoolExecutor

        batches: List[ColumnBatch] = []
        pool = ThreadPoolExecutor(max_workers=1)
        try:
            fut = pool.submit(self._read_units, chunks[0])
            for i in range(len(chunks)):
                ctx.check_cancelled()
                # time blocked on the read; overlapped reads hide behind
                # the previous chunk's conversion
                with self.metrics().timer("scan_read_time"):
                    table = fut.result()
                if i + 1 < len(chunks):
                    fut = pool.submit(self._read_units, chunks[i + 1])
                with self.metrics().timer("scan_convert_time"):
                    batches.extend(table_to_batches(table, self._schema, capacity, ctx.device))
        finally:
            pool.shutdown(wait=False, cancel_futures=True)
        return batches

    def row_count_estimate(self) -> int:
        return self._total_rows

    def clustered_ranges(self, col_name: str):
        """If the data is clustered on ``col_name`` (per-row-group min/max
        statistics non-decreasing in row order), a regroup of this scan's
        row groups into contiguous runs at the same partition count:
        ``(groups, ranges)`` with each new partition's (min, max) key range;
        else None.

        Side-effect free: the planner commits ``groups`` only when it
        accepts the annotation.  Memoized per column (the planner probes
        twice: the presorted-only form, then the early-HAVING upgrade)."""
        cache = getattr(self, "_clustered_cache", None)
        if cache is None:
            self._clustered_cache = cache = {}
        if col_name not in cache:
            cache[col_name] = self._clustered_ranges_impl(col_name)
        return cache[col_name]

    def _clustered_ranges_impl(self, col_name: str):
        from ..utils import object_store

        units = sorted(u for g in self.groups for u in g)
        if len(units) <= 1:
            return None
        metas = {}
        stats_per_unit = []
        for f, rg, _rows in units:
            meta = metas.get(f)
            if meta is None:
                with object_store.parquet_file(f) as pf:
                    meta = metas[f] = pf.metadata
            idx = None
            for i in range(meta.num_columns):
                if meta.schema.column(i).name == col_name:
                    idx = i
                    break
            if idx is None:
                return None
            st = meta.row_group(rg).column(idx).statistics
            if st is None or not st.has_min_max:
                return None
            if not isinstance(st.min, int) or not isinstance(st.max, int):
                return None  # int keys only (exact, order-stable)
            stats_per_unit.append((st.min, st.max))
        # clustered iff unit ranges are non-decreasing in row order
        for (_lo_a, hi_a), (lo_b, _hi_b) in zip(stats_per_unit, stats_per_unit[1:]):
            if hi_a > lo_b:
                return None
        # contiguous regroup at the same partition count, row-balanced
        k = len(self.groups)
        total = sum(u[2] for u in units)
        per = max(1, -(-total // k))
        new_groups, new_ranges = [], []
        cur, cur_rows, cur_lo, cur_hi = [], 0, None, None
        for u, (lo, hi) in zip(units, stats_per_unit):
            cur.append(u)
            cur_rows += u[2]
            cur_lo = lo if cur_lo is None else min(cur_lo, lo)
            cur_hi = hi if cur_hi is None else max(cur_hi, hi)
            if cur_rows >= per and len(new_groups) < k - 1:
                new_groups.append(cur)
                new_ranges.append((cur_lo, cur_hi))
                cur, cur_rows, cur_lo, cur_hi = [], 0, None, None
        if cur:
            new_groups.append(cur)
            new_ranges.append((cur_lo, cur_hi))
        return new_groups, new_ranges

    def _label(self):
        pruned = f", {self.pruned_row_groups} row-groups pruned" if self.pruned_row_groups else ""
        n_units = sum(len(g) for g in self.groups)
        return (f"ParquetScanExec: {len(self.files)} files, {n_units} row-groups, "
                f"{len(self.groups)} partitions{pruned}")


def _arrow_type_of(dt: DataType):
    """Engine dtype -> the arrow type file readers should parse into."""
    import pyarrow as pa

    return {
        "int32": pa.int32(), "int64": pa.int64(), "float32": pa.float32(),
        "float64": pa.float64(), "bool": pa.bool_(), "date32": pa.date32(),
        "decimal": pa.float64(), "string": pa.string(),
    }[dt.kind]


class FileListScanExec(ScanExec):
    """Shared scaffolding for whole-file scans (csv/json/avro): object-store
    listing, round-robin file grouping into partitions, per-file read on
    the host with pyarrow + concat.  The batches convert as the parquet
    scan's do (``table_to_batches``) and take the inherited scan filter
    (K19).  Parquet scans stay separate (row-group granularity)."""

    SUFFIXES: Tuple[str, ...] = ()
    FORMAT = "file"

    def __init__(self, schema: Schema, paths: List[str], target_partitions: int,
                 filters: Sequence[E.Expr] = (), table_schema: Optional[Schema] = None):
        super().__init__(schema, filters)
        from ..utils import object_store as obs

        self.table_schema = table_schema or schema
        files = []
        for p in paths:
            files.extend(obs.list_files(p, self.SUFFIXES))
        if not files:
            raise ExecutionError(f"no {self.FORMAT} files found in {paths}")
        self.files = files
        k = max(1, min(target_partitions, len(files)))
        self.groups = [files[i::k] for i in range(k)]

    def output_partition_count(self) -> int:
        return len(self.groups)

    def _read_one(self, path: str):
        raise NotImplementedError

    def _read_partition(self, partition: int):
        import pyarrow as pa

        tables = [self._read_one(f) for f in self.groups[partition]]
        return pa.concat_tables(tables) if len(tables) > 1 else tables[0]

    def _label(self):
        return (f"{type(self).__name__}: {len(self.files)} files, "
                f"{len(self.groups)} partitions")


class CsvScanExec(FileListScanExec):
    """CSV scan (including TPC-H ``.tbl`` pipe-delimited files)."""

    SUFFIXES = (".csv", ".tbl")
    FORMAT = "csv"

    def __init__(self, schema: Schema, paths: List[str], target_partitions: int,
                 filters: Sequence[E.Expr] = (), table_schema: Optional[Schema] = None,
                 delimiter: str = ",", has_header: bool = True):
        super().__init__(schema, paths, target_partitions, filters, table_schema)
        self.delimiter = delimiter
        self.has_header = has_header

    def _read_one(self, path: str):
        import pyarrow.csv as pacsv

        from ..utils import object_store as obs

        names = self.table_schema.names()
        column_types = {f.name: _arrow_type_of(f.dtype) for f in self.table_schema}
        trailing = _has_trailing_delimiter(path, self.delimiter)
        read_names = None if self.has_header else names + (["__trail"] if trailing else [])
        ropts = pacsv.ReadOptions(column_names=read_names)
        popts = pacsv.ParseOptions(delimiter=self.delimiter)
        copts = pacsv.ConvertOptions(
            column_types=column_types, include_columns=self._schema.names()
        )
        with obs.open_input(path) as fh:
            return pacsv.read_csv(fh, read_options=ropts, parse_options=popts,
                                  convert_options=copts)


class JsonScanExec(FileListScanExec):
    """Newline-delimited JSON scan (reference reads json via DataFusion's
    NdJson reader, client context.rs register_json).  Parsing uses the
    TABLE schema explicitly — per-file type inference would let two files
    of one table disagree (int vs null vs double) and break the concat."""

    SUFFIXES = (".json", ".jsonl", ".ndjson")
    FORMAT = "json"

    def _read_one(self, path: str):
        import pyarrow as pa
        import pyarrow.json as pajson

        from ..utils import object_store as obs

        explicit = pa.schema([
            pa.field(f.name, _arrow_type_of(f.dtype))
            for f in self.table_schema])
        popts = pajson.ParseOptions(explicit_schema=explicit)
        with obs.open_input(path) as fh:
            table = pajson.read_json(fh, parse_options=popts)
        return table.select(self._schema.names())


class AvroScanExec(FileListScanExec):
    """Avro object-container-file scan (reference reads avro via DataFusion;
    the container codec lives in utils/avro.py — no external avro library
    exists in this image)."""

    SUFFIXES = (".avro",)
    FORMAT = "avro"

    def _read_one(self, path: str):
        from ..utils import object_store as obs
        from ..utils.avro import avro_to_arrow

        with obs.open_input(path) as fh:
            return avro_to_arrow(fh).select(self._schema.names())


def _has_trailing_delimiter(path: str, delim: str) -> bool:
    from ..utils import object_store as obs

    buf = b""
    with obs.open_input(path) as fh:
        # read until the first newline (or EOF) — never misjudge a first
        # line longer than one chunk
        while b"\n" not in buf:
            chunk = fh.read(1 << 16)
            if not chunk:
                break
            buf += chunk
    line = buf.split(b"\n", 1)[0].rstrip(b"\r")
    return line.endswith(delim.encode())
