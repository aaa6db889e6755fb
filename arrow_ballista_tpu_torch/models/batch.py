"""ColumnBatch: the unit of data flowing through the engine, on torch.

As in the reference (arrow_ballista_tpu/models/batch.py), a batch is

- ``columns``: dict name -> 1-D tensor of a fixed *capacity* rows (padded),
- ``mask``: bool[capacity] tensor marking live rows (filters clear bits),
- ``dicts``: host-side numpy string dictionaries for dictionary-encoded
  string columns (the tensor holds int32 codes).

Every tensor of a batch lies on one device, which the caller names.
Host->device copies go through one pinned staging buffer per batch;
device->host copies through one packed buffer (ops/kernels.pack_for_host)
into pinned memory.  Concatenation runs on K20 and compaction on K2 with
K21 (csrc/gather.cu).  Tensors are never updated in place: batches share
columns and masks freely (a repartition hands the same columns to every
bucket).
"""
from __future__ import annotations

import json
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..obs import device as device_obs
from .schema import DataType, Field, Schema

_TORCH_DTYPES = {
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
    np.dtype(np.bool_): torch.bool,
    np.dtype(np.uint8): torch.uint8,
}


def torch_dtype(np_dtype) -> torch.dtype:
    return _TORCH_DTYPES[np.dtype(np_dtype)]


def _pad_to(arr: np.ndarray, capacity: int) -> np.ndarray:
    n = arr.shape[0]
    if n > capacity:
        raise ValueError(f"array of {n} rows exceeds capacity {capacity}")
    if n == capacity:
        return arr
    pad = np.zeros(capacity - n, dtype=arr.dtype)
    return np.concatenate([arr, pad])


def round_capacity(n: int, minimum: int = 1024) -> int:
    """Round a row count up to the next power of two (>= minimum), so the
    set of distinct batch shapes stays small."""
    cap = minimum
    while cap < n:
        cap <<= 1
    return cap


def upload(arrays: Sequence[np.ndarray], device) -> list:
    """Copy host arrays to ``device`` through ONE pinned staging buffer and
    one host->device copy; returns one tensor per array (views of a shared
    device buffer).  On the CPU the staging buffer is the result."""
    device = torch.device(device)
    observed = device_obs._enabled and device.type == "cuda"
    t0 = time.perf_counter() if observed else 0.0
    arrays = [np.ascontiguousarray(a) for a in arrays]
    offsets, total = [], 0
    for a in arrays:
        total = -(-total // 8) * 8  # 8-byte aligned views
        offsets.append(total)
        total += a.nbytes
    host = torch.empty(max(total, 1), dtype=torch.uint8,
                       pin_memory=device.type == "cuda")
    host_np = host.numpy()
    for a, off in zip(arrays, offsets):
        host_np[off:off + a.nbytes] = a.view(np.uint8).reshape(-1)
    buf = host.to(device, non_blocking=True) if device.type != "cpu" else host
    out = []
    for a, off in zip(arrays, offsets):
        out.append(buf[off:off + a.nbytes].view(torch_dtype(a.dtype)))
    if observed:
        device_obs.record_transfer("h2d", total, time.perf_counter() - t0)
    return out


def _null_mask(f, arr: np.ndarray):
    """Boolean mask of NULL (in-band sentinel) positions for a nullable
    non-string field; None when the field can't hold NULLs."""
    if not f.nullable or f.dtype.is_string:
        return None
    sent = f.dtype.null_sentinel
    if isinstance(sent, float) and sent != sent:  # NaN
        return np.isnan(arr)
    return arr == sent


def _schema_from_parts(schema) -> Schema:
    """A port Schema from a port Schema, a JSON list, or fields of either
    package (objects with name / dtype.kind / dtype.scale / nullable, or
    (name, kind, scale, nullable) tuples)."""
    if isinstance(schema, Schema):
        return schema
    if isinstance(schema, str):
        schema = json.loads(schema)
    fields = []
    for f in schema:
        if isinstance(f, (list, tuple)):
            name, kind, scale, nullable = f
        else:
            name, kind, scale, nullable = f.name, f.dtype.kind, f.dtype.scale, f.nullable
        fields.append(Field(name, DataType(kind, scale), bool(nullable)))
    return Schema(fields)


class ColumnBatch:
    def __init__(
        self,
        schema: Schema,
        columns: Dict[str, torch.Tensor],
        mask: torch.Tensor,
        dicts: Optional[Dict[str, np.ndarray]] = None,
        num_rows: Optional[int] = None,
    ):
        self.schema = schema
        self.columns = columns
        self.mask = mask
        self.dicts = dicts or {}
        self._num_rows = num_rows  # computed on first use if None
        self._count_sinks: Optional[list] = None  # see on_count

    def on_count(self, sink) -> None:
        """Call ``sink(n)`` once the live-row count is host-known (now, if
        it is).  The deferred metrics read counts this way: the batch holds
        the sink, the sink does not hold the batch, so a count that a
        downstream operator makes known reaches the metrics even after the
        batch is gone, and no device buffer is pinned."""
        if self._num_rows is not None:
            sink(self._num_rows)
        elif self._count_sinks is None:
            self._count_sinks = [sink]
        else:
            self._count_sinks.append(sink)

    def _known(self, n: int) -> None:
        self._num_rows = n
        sinks, self._count_sinks = self._count_sinks, None
        for sink in sinks or ():
            sink(n)

    # --- construction ---------------------------------------------------
    @staticmethod
    def from_numpy(
        schema: Schema,
        data: Dict[str, np.ndarray],
        dicts: Optional[Dict[str, np.ndarray]] = None,
        capacity: Optional[int] = None,
        device="cuda",
    ) -> "ColumnBatch":
        """Build a batch on ``device`` from host numpy columns (already
        physical: string columns passed as int32 codes + dicts)."""
        lengths = {f.name: np.asarray(data[f.name]).shape[0] for f in schema}
        if len(set(lengths.values())) > 1:
            raise ValueError(f"column lengths differ: {lengths}")
        n = next(iter(lengths.values())) if lengths else 0
        cap = capacity or round_capacity(n)
        host = []
        for f in schema:
            raw = np.asarray(data[f.name])
            if raw.dtype.kind == "f" and f.dtype.np_dtype.kind in ("i", "u"):
                raise TypeError(
                    f"column {f.name!r}: float data passed for {f.dtype} "
                    "(int-backed); convert to the physical representation first "
                    "(e.g. scaled int64 for decimals)"
                )
            host.append(_pad_to(raw.astype(f.dtype.np_dtype, copy=False), cap))
        mask = np.zeros(cap, dtype=np.bool_)
        mask[:n] = True
        tensors = upload(host + [mask], device)
        cols = {f.name: t for f, t in zip(schema, tensors)}
        return ColumnBatch(schema, cols, tensors[-1], dicts, num_rows=n)

    @staticmethod
    def from_reference_parts(schema_json_or_fields, columns: Dict[str, np.ndarray],
                             mask: np.ndarray, dicts, device) -> "ColumnBatch":
        """A batch holding exactly the arrays a JAX ColumnBatch exposes
        (``np.asarray(col)`` per column, the mask, the dicts): same
        capacity, same padding, same codes."""
        schema = _schema_from_parts(schema_json_or_fields)
        host = [np.asarray(columns[f.name]).astype(f.dtype.np_dtype, copy=False)
                for f in schema]
        m = np.asarray(mask, dtype=np.bool_)
        tensors = upload(host + [m], device)
        cols = {f.name: t for f, t in zip(schema, tensors)}
        return ColumnBatch(schema, cols, tensors[-1],
                           {k: np.asarray(v, dtype=object) for k, v in (dicts or {}).items()})

    @staticmethod
    def empty(schema: Schema, capacity: int = 1024, device="cuda") -> "ColumnBatch":
        cols = {f.name: torch.zeros(capacity, dtype=torch_dtype(f.dtype.np_dtype),
                                    device=device) for f in schema}
        return ColumnBatch(schema, cols, torch.zeros(capacity, dtype=torch.bool, device=device),
                           {}, num_rows=0)

    # --- basic properties ----------------------------------------------
    @property
    def device(self) -> torch.device:
        return self.mask.device

    @property
    def capacity(self) -> int:
        return int(self.mask.shape[0])

    @property
    def num_rows(self) -> int:
        if self._num_rows is None:
            self._known(int(self.mask.sum()))
        return self._num_rows

    def shrink(self) -> "ColumnBatch":
        """Compact live rows to the front (K2's order, every column and the
        mask gathered by K21) and drop to the smallest power-of-two
        capacity.  Syncs on num_rows."""
        from ..ops.kernels import compaction_order, gather_columns

        n = self.num_rows
        target = round_capacity(n)
        if target >= self.capacity:
            return self
        order = compaction_order(self.mask)[:target]
        out = gather_columns(order, {**self.columns, "__mask": self.mask})
        mask = out.pop("__mask")
        return ColumnBatch(self.schema, out, mask, self.dicts, num_rows=n)

    # --- host materialization ------------------------------------------
    def _pack_layout(self, extra32: Sequence[str] = ()):
        """Pack layout for this schema: int64 / float64 / 32-bit column
        groups (see kernels.pack_for_host)."""
        i64, f64, f32 = [], [], []
        for f in self.schema:
            dt = f.dtype.np_dtype
            if dt.itemsize == 8:
                (f64 if dt.kind == "f" else i64).append((f.name, dt))
            else:
                f32.append((f.name, dt))
        for name in extra32:
            f32.append((name, np.dtype(np.int32)))
        return tuple(i64), tuple(f64), tuple(f32)

    def packed_numpy(self, hint: Optional[int] = None,
                     extra32: Optional[Dict[str, torch.Tensor]] = None,
                     order: Optional[tuple] = None) -> tuple:
        """Host numpy columns of live rows only, via ONE packed
        device->host copy that also carries the live-row count.  Returns
        (cols, n).  When the count exceeds ``hint``, one more exact-size
        fetch happens.  ``order`` is an optional precomputed (int32
        permutation with the live rows first, int32[1] live count), as K16's
        ``spill_order`` gives it: the rows come out in its order and K2 does
        not run."""
        from ..ops.kernels import pack_for_host, to_host, unpack_from_host

        extra32 = extra32 or {}
        i64, f64, f32 = self._pack_layout(tuple(extra32))
        namesi64 = tuple(n for n, _ in i64)
        namesf64 = tuple(n for n, _ in f64)
        names32 = tuple(n for n, _ in f32)
        cap = self.capacity
        if self._num_rows is not None:
            target = min(round_capacity(self._num_rows), cap)
        else:
            target = min(hint if hint else max(1024, cap >> 2), cap)
        cols = dict(self.columns)
        cols.update(extra32)
        observed = device_obs._enabled and self.mask.device.type == "cuda"
        while True:
            buf, fbuf = pack_for_host(cols, self.mask, target, namesi64, namesf64, names32,
                                      order)
            t0 = time.perf_counter() if observed else 0.0
            hbuf = to_host(buf)
            hfbuf = to_host(fbuf) if fbuf is not None else None
            if observed:
                device_obs.record_transfer(
                    "d2h", hbuf.nbytes + (hfbuf.nbytes if hfbuf is not None else 0),
                    time.perf_counter() - t0)
            out, n = unpack_from_host(hbuf, hfbuf, target, i64, f64, f32)
            if out is not None:
                break
            target = min(round_capacity(n), cap)
        self._known(n)
        return out, n

    def compacted_numpy(self, hint: Optional[int] = None) -> Dict[str, np.ndarray]:
        """Host numpy columns containing only live rows, in order."""
        out, _ = self.packed_numpy(hint=hint)
        return out

    def to_arrow(self):
        """Decode to a pyarrow Table with logical types restored: strings from
        dictionaries, date32, decimal128(38, scale) from fixed-point int64."""
        import pyarrow as pa

        from ..utils.errors import InternalError

        data = self.compacted_numpy()
        arrays, fields = [], []
        for f in self.schema:
            arr = data[f.name]
            null_mask = _null_mask(f, arr)
            if f.dtype.is_string:
                dic = self.dicts.get(f.name)
                if dic is None or len(dic) == 0:
                    if len(arr) and arr.max(initial=-1) >= 0:
                        raise InternalError(
                            f"string column {f.name!r} has live codes but no dictionary")
                    dic = np.array([], dtype=object)
                pa_arr = pa.DictionaryArray.from_arrays(
                    pa.array(arr, type=pa.int32()), pa.array(dic, type=pa.string()))
                fields.append(pa.field(f.name, pa_arr.type))
            elif f.dtype.kind == "date32":
                pa_arr = pa.array(arr, type=pa.date32(), mask=null_mask)
                fields.append(pa.field(f.name, pa.date32()))
            elif f.dtype.is_decimal:
                import decimal as pydec

                t = pa.decimal128(38, f.dtype.scale)
                scale_exp = -f.dtype.scale
                vals = [pydec.Decimal(int(v)).scaleb(scale_exp) for v in arr]
                if null_mask is not None:
                    vals = [None if m else v for v, m in zip(vals, null_mask)]
                pa_arr = pa.array(vals, type=t)
                fields.append(pa.field(f.name, t))
            else:
                pa_arr = pa.array(arr, mask=null_mask)
                fields.append(pa.field(f.name, pa_arr.type))
            arrays.append(pa_arr)
        return pa.table(arrays, schema=pa.schema(fields))

    def to_pandas(self):
        """Decode to pandas with logical values (decimals -> float)."""
        import pandas as pd

        data = self.compacted_numpy()
        out = {}
        for f in self.schema:
            arr = data[f.name]
            if f.dtype.is_string:
                dic = np.asarray(self.dicts.get(f.name, np.array([], dtype=object)), dtype=object)
                if len(dic) == 0:
                    out[f.name] = np.full(len(arr), None, dtype=object)
                else:
                    vals = dic[np.clip(arr, 0, len(dic) - 1)]
                    out[f.name] = np.where((arr >= 0) & (arr < len(dic)), vals, None)
            elif f.dtype.is_decimal:
                vals = arr.astype(np.float64) / (10.0 ** f.dtype.scale)
                m = _null_mask(f, arr)
                if m is not None:
                    vals = np.where(m, np.nan, vals)
                out[f.name] = vals
            elif f.dtype.kind == "date32":
                vals = arr.astype("datetime64[D]")
                m = _null_mask(f, arr)
                if m is not None:
                    vals = vals.copy()
                    vals[m] = np.datetime64("NaT")
                out[f.name] = vals
            else:
                m = _null_mask(f, arr)
                if m is not None and m.any() and arr.dtype.kind in ("i", "u"):
                    out[f.name] = np.where(m, np.nan, arr.astype(np.float64))
                else:
                    out[f.name] = arr
        return pd.DataFrame(out)

    def __repr__(self):
        return f"ColumnBatch({self.num_rows}/{self.capacity} rows, {len(self.schema)} cols)"


def _unify_string_dicts(schema: Schema, batches: "list[ColumnBatch]") -> "list[ColumnBatch]":
    """Re-encode string columns against one union dictionary when batches
    disagree.  The fast path is an identity check."""
    string_fields = [f.name for f in schema if f.dtype.is_string]
    if not string_fields:
        return batches
    out = list(batches)
    for name in string_fields:
        dicts = [b.dicts.get(name) for b in out]
        first = dicts[0]
        if all(d is first or (d is not None and first is not None and np.array_equal(d, first))
               for d in dicts):
            continue
        union = np.asarray(
            sorted(set().union(*[set(d.tolist()) for d in dicts if d is not None])),
            dtype=object,
        )
        for i, b in enumerate(out):
            d = b.dicts.get(name)
            if d is None or len(d) == 0:
                lut = np.zeros(1, dtype=np.int32)
            else:
                lut = np.searchsorted(union, d).astype(np.int32)
            codes = b.columns[name]
            lut_t = upload([lut], b.device)[0]
            # clamped like the reference's gather: dead rows may hold any code
            new_codes = torch.where(codes >= 0, lut_t[torch.clamp(codes, 0, len(lut) - 1).long()],
                                    torch.full((), -1, dtype=torch.int32, device=b.device))
            new_cols = dict(b.columns)
            new_cols[name] = new_codes.to(torch.int32)
            new_dicts = dict(b.dicts)
            new_dicts[name] = union
            out[i] = ColumnBatch(b.schema, new_cols, b.mask, new_dicts)
    return out


def concat_batches(schema: Schema, batches: Sequence[ColumnBatch],
                   capacity: Optional[int] = None, device=None) -> ColumnBatch:
    """Concatenate batches (a padded concat: K20, one launch for every
    column and the mask), unifying string dictionaries across inputs when
    they differ.  ``device`` is needed only when there are no batches."""
    batches = list(batches)
    if not batches:
        if device is None:
            raise ValueError("concat of no batches needs a device")
        return ColumnBatch.empty(schema, capacity or 1024, device=device)
    if len(batches) == 1 and (capacity is None or batches[0].capacity == capacity):
        return batches[0]
    batches = _unify_string_dicts(schema, batches)
    total_cap = sum(b.capacity for b in batches)
    if capacity is not None and capacity < total_cap:
        raise ValueError(
            f"requested capacity {capacity} < combined batch capacity {total_cap}; "
            "compact batches before concatenating to a smaller shape")
    pad = (capacity - total_cap) if capacity is not None else 0
    from ..ops.kernels import concat_columns

    cols, mask = concat_columns([{f.name: b.columns[f.name] for f in schema} for b in batches],
                                [b.mask for b in batches], pad)
    dicts = {}
    for b in batches:
        dicts.update(b.dicts)
    known = [b._num_rows for b in batches]
    total = sum(known) if all(k is not None for k in known) else None
    return ColumnBatch(schema, cols, mask, dicts, num_rows=total)
