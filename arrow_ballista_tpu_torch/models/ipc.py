"""Arrow IPC shuffle files in the physical representation.

Mirrors arrow_ballista_tpu/models/ipc.py byte for byte, so each package
reads the other's shuffle output: decimals stay scaled int64 (field
metadata carries the scale), dates int32, strings dictionary arrays; an
int64 column whose slice fits int32 travels as int32.  A read unifies each
string column's dictionaries once (sorted) and uploads the rows to the
batch's device through the pinned staging buffer the scans use
(``ColumnBatch.from_numpy``).
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..utils.errors import InternalError
from .batch import ColumnBatch, round_capacity
from .schema import Schema


def _physical_arrow_schema(schema: Schema):
    import pyarrow as pa

    fields = []
    for f in schema:
        meta = {b"kind": f.dtype.kind.encode()}
        if f.dtype.is_decimal:
            meta[b"scale"] = str(f.dtype.scale).encode()
        if f.dtype.is_string:
            t = pa.dictionary(pa.int32(), pa.string())
        else:
            t = {
                "int32": pa.int32(), "int64": pa.int64(), "float32": pa.float32(),
                "float64": pa.float64(), "bool": pa.bool_(),
                "date32": pa.int32(), "decimal": pa.int64(),
            }[f.dtype.kind]
        fields.append(pa.field(f.name, t, metadata=meta))
    return pa.schema(fields)


def int64_decimal_storage_scale(field) -> Optional[int]:
    """Storage scale of an int64-stored decimal arrow field (the
    ``{kind: decimal, scale}`` field-metadata convention); None when the
    field is not an int-backed decimal."""
    import pyarrow as pa

    meta = field.metadata or {}
    if meta.get(b"kind") == b"decimal" and pa.types.is_integer(field.type):
        return int(meta.get(b"scale", b"0"))
    return None


def physical_table_from_numpy(schema: Schema, data: Dict[str, np.ndarray],
                              dicts: Dict[str, np.ndarray]):
    """Compact host numpy columns -> physical arrow table (no decoding).
    Non-string columns wrap zero-copy."""
    import pyarrow as pa

    pa_schema = _physical_arrow_schema(schema)
    arrays = []
    for f in schema:
        arr = data[f.name]
        if f.dtype.is_string:
            dic = dicts.get(f.name)
            if dic is None:
                if len(arr) and arr.max(initial=-1) >= 0:
                    raise InternalError(f"string column {f.name!r} missing dictionary")
                dic = np.array([], dtype=object)
            elif len(dic) > 2 * max(len(arr), 16):
                # prune the dictionary to the codes present: a hash shuffle
                # slices a batch many ways, and the parent's full dictionary
                # in every slice multiplies the shuffle bytes; the read side
                # re-unifies and re-sorts dictionaries
                codes = np.asarray(arr)
                used = np.unique(codes[codes >= 0])
                if len(used) < len(dic):
                    remap = np.full(len(dic), -1, dtype=np.int32)
                    remap[used] = np.arange(len(used), dtype=np.int32)
                    arr = np.where(codes >= 0,
                                   remap[np.clip(codes, 0, None)], codes)
                    dic = np.asarray(dic, dtype=object)[used]
            codes = np.asarray(arr)
            # a NULL string (code -1) is written as a NULL index; the
            # reference passes -1 through and fails to write it (ROADMAP.md
            # queue 3)
            nulls = codes < 0
            idx = pa.array(np.where(nulls, 0, codes) if nulls.any() else codes,
                           type=pa.int32(), mask=nulls if nulls.any() else None)
            arrays.append(pa.DictionaryArray.from_arrays(idx, pa.array(dic, type=pa.string())))
        else:
            want = pa_schema.field(f.name).type
            if want == pa.int64() and len(arr):
                # int64 columns travel as int32 when the slice fits (NULL
                # sentinels are int64-min, so NULL-bearing slices never do);
                # the read side upcasts
                lo, hi = arr.min(), arr.max()
                if -(2**31) < lo and hi < 2**31 - 1:
                    want = pa.int32()
                    arr = arr.astype(np.int32)
            arrays.append(pa.array(arr, type=want))
    fields = [pa.field(f.name, a.type, metadata=pa_schema.field(f.name).metadata)
              for f, a in zip(schema, arrays)]
    return pa.table(arrays, schema=pa.schema(fields))


def batch_to_physical_table(batch: ColumnBatch):
    """Live rows only, physical representation (no decimal/date decoding)."""
    return physical_table_from_numpy(batch.schema, batch.compacted_numpy(), batch.dicts)


def _write_table_ipc(table, path: str) -> tuple:
    import pyarrow as pa
    import pyarrow.ipc as ipc

    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    with pa.OSFile(tmp, "wb") as sink:
        with ipc.new_file(sink, table.schema) as writer:
            writer.write_table(table)
    os.replace(tmp, path)
    return table.num_rows, os.path.getsize(path)


def crc32_file(path: str) -> int:
    """CRC-32 of a file's bytes (the shuffle-partition integrity checksum
    a writer records)."""
    import zlib

    crc = 0
    with open(path, "rb") as fh:
        while True:
            chunk = fh.read(1 << 20)
            if not chunk:
                return crc
            crc = zlib.crc32(chunk, crc)


def write_ipc_file(batch: ColumnBatch, path: str) -> tuple:
    """Returns (num_rows, num_bytes)."""
    return _write_table_ipc(batch_to_physical_table(batch), path)


def write_ipc_rows(schema: Schema, data: Dict[str, np.ndarray],
                   dicts: Dict[str, np.ndarray], path: str) -> tuple:
    """Write already-compacted host rows (numpy slices wrap zero-copy).
    Returns (num_rows, num_bytes)."""
    return _write_table_ipc(physical_table_from_numpy(schema, data, dicts), path)


def read_ipc_files(paths: Sequence[str], schema: Schema, capacity: Optional[int] = None,
                   device="cuda") -> List[ColumnBatch]:
    """Read shuffle files into batches on ``device`` with one unified,
    sorted dictionary per string column across all inputs."""
    import pyarrow as pa
    import pyarrow.ipc as ipc

    tables = []
    for p in paths:
        with pa.memory_map(p, "r") as source:
            tables.append(ipc.open_file(source).read_all())
    return _tables_to_batches(tables, schema, capacity, device)


def read_ipc_buffers(buffers: Sequence[bytes], schema: Schema,
                     capacity: Optional[int] = None, device="cuda") -> List[ColumnBatch]:
    """:func:`read_ipc_files` over IPC file bytes held in memory."""
    import io

    import pyarrow.ipc as ipc

    tables = [ipc.open_file(io.BytesIO(b)).read_all() for b in buffers]
    return _tables_to_batches(tables, schema, capacity, device)


def _tables_to_batches(tables, schema: Schema, capacity, device) -> List[ColumnBatch]:
    import pyarrow as pa

    if not tables:
        return [ColumnBatch.empty(schema, capacity or 1024, device=device)]
    table = (pa.concat_tables(tables, promote_options="permissive") if len(tables) > 1
             else tables[0])
    return physical_table_to_batches(table, schema, capacity, device)


def physical_table_to_batches(table, schema: Schema, capacity: Optional[int] = None,
                              device="cuda") -> List[ColumnBatch]:
    import pyarrow as pa
    import pyarrow.compute as pc

    n = table.num_rows
    cols: Dict[str, np.ndarray] = {}
    dicts: Dict[str, np.ndarray] = {}
    for f in schema:
        arr = table.column(f.name)
        if f.dtype.is_string:
            combined = arr.combine_chunks() if isinstance(arr, pa.ChunkedArray) else arr
            if isinstance(combined, pa.ChunkedArray):  # zero-chunk edge
                combined = pa.array([], type=pa.dictionary(pa.int32(), pa.string()))
            if not pa.types.is_dictionary(combined.type):
                combined = pc.dictionary_encode(combined)
            indices = pc.fill_null(combined.indices, -1)
            codes = indices.to_numpy(zero_copy_only=False).astype(np.int32)
            dic = np.asarray(combined.dictionary.to_pylist(), dtype=object)
            if len(dic):
                order = np.argsort(dic)
                rank = np.empty(len(order), dtype=np.int32)
                rank[order] = np.arange(len(order), dtype=np.int32)
                codes = np.where(codes >= 0, rank[np.clip(codes, 0, None)], -1).astype(np.int32)
                dic = dic[order]
            cols[f.name] = codes
            dicts[f.name] = dic
        else:
            cols[f.name] = arr.to_numpy(zero_copy_only=False).astype(f.dtype.np_dtype)

    if n == 0:
        return [ColumnBatch.empty(schema, capacity or 1024, device=device)]
    cap = capacity or round_capacity(n)
    out = []
    for start in range(0, n, cap):
        end = min(start + cap, n)
        chunk = {k: v[start:end] for k, v in cols.items()}
        c = cap if end - start == cap else round_capacity(end - start)
        out.append(ColumnBatch.from_numpy(schema, chunk, dicts=dicts, capacity=c, device=device))
    return out
