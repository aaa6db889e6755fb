"""Minimal Avro Object Container File codec (pure Python, no deps).

The port's own copy of arrow_ballista_tpu/utils/avro.py (upstream
Ballista reads avro through DataFusion's avro reader, ballista/client/
src/context.rs:358-530 register_avro).  No avro library is installed, so
this module implements the container format directly:

- spec: magic 'Obj\\x01', file metadata map (avro.schema JSON, avro.codec),
  16-byte sync marker, then blocks of (row_count, byte_len, payload, sync);
- binary encoding: zigzag varints for int/long, little-endian IEEE for
  float/double, length-prefixed utf8 for string/bytes;
- supported schema shape: a top-level record of primitive fields
  (null/boolean/int/long/float/double/string/bytes) and nullable unions
  ``["null", prim]`` — the tabular subset; codecs: null, deflate.

Both directions are implemented (the writer exists so tests and datagen
can produce real files), and the reader returns a pyarrow Table so avro
scans ride the same physical path as parquet/csv/json.
"""
from __future__ import annotations

import io
import json
import os
import struct
import zlib
from typing import Any, Dict, List, Optional, Tuple

from .errors import ExecutionError

MAGIC = b"Obj\x01"

_PRIMITIVES = ("null", "boolean", "int", "long", "float", "double",
               "string", "bytes")


# --------------------------------------------------------------------------
# binary primitives
# --------------------------------------------------------------------------


def _zigzag_encode(n: int) -> int:
    return (n << 1) ^ (n >> 63)


def _zigzag_decode(n: int) -> int:
    return (n >> 1) ^ -(n & 1)


def _write_varint(out: io.BytesIO, n: int) -> None:
    n = _zigzag_encode(n) & 0xFFFFFFFFFFFFFFFF
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.write(bytes([b | 0x80]))
        else:
            out.write(bytes([b]))
            return


class _Reader:
    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def read_varint(self) -> int:
        shift = 0
        acc = 0
        while True:
            b = self.buf[self.pos]
            self.pos += 1
            acc |= (b & 0x7F) << shift
            if not b & 0x80:
                return _zigzag_decode(acc)
            shift += 7

    def read_bytes(self) -> bytes:
        n = self.read_varint()
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def read(self, n: int) -> bytes:
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out


def _read_value(r: _Reader, schema) -> Any:
    if isinstance(schema, list):  # union
        idx = r.read_varint()
        return _read_value(r, schema[idx])
    if isinstance(schema, dict):
        t = schema["type"]
        if t == "record":
            return {f["name"]: _read_value(r, f["type"])
                    for f in schema["fields"]}
        schema = t
    if schema == "null":
        return None
    if schema == "boolean":
        b = r.read(1)
        return b == b"\x01"
    if schema in ("int", "long"):
        return r.read_varint()
    if schema == "float":
        return struct.unpack("<f", r.read(4))[0]
    if schema == "double":
        return struct.unpack("<d", r.read(8))[0]
    if schema == "string":
        return r.read_bytes().decode("utf-8")
    if schema == "bytes":
        return r.read_bytes()
    raise ExecutionError(f"unsupported avro type {schema!r} (supported: "
                         f"records of {_PRIMITIVES} and nullable unions)")


def _write_value(out: io.BytesIO, schema, v: Any) -> None:
    if isinstance(schema, list):  # union: pick the branch by value
        idx = 0 if v is None else next(
            i for i, s in enumerate(schema) if s != "null")
        _write_varint(out, idx)
        _write_value(out, schema[idx], v)
        return
    if isinstance(schema, dict):
        t = schema["type"]
        if t == "record":
            for f in schema["fields"]:
                _write_value(out, f["type"], v[f["name"]])
            return
        schema = t
    if schema == "null":
        return
    if schema == "boolean":
        out.write(b"\x01" if v else b"\x00")
    elif schema in ("int", "long"):
        _write_varint(out, int(v))
    elif schema == "float":
        out.write(struct.pack("<f", float(v)))
    elif schema == "double":
        out.write(struct.pack("<d", float(v)))
    elif schema == "string":
        b = str(v).encode("utf-8")
        _write_varint(out, len(b))
        out.write(b)
    elif schema == "bytes":
        _write_varint(out, len(v))
        out.write(v)
    else:
        raise ExecutionError(f"unsupported avro type {schema!r}")


# --------------------------------------------------------------------------
# container files
# --------------------------------------------------------------------------


def read_avro(path_or_file) -> Tuple[dict, List[dict]]:
    """Read a container file -> (schema_json, list of row dicts)."""
    if hasattr(path_or_file, "read"):
        data = path_or_file.read()
    else:
        with open(path_or_file, "rb") as f:
            data = f.read()
    r = _Reader(data)
    if r.read(4) != MAGIC:
        raise ExecutionError("not an avro object container file")
    meta: Dict[str, bytes] = {}
    while True:
        n = r.read_varint()
        if n == 0:
            break
        if n < 0:  # negative block count: size prefix follows
            r.read_varint()
            n = -n
        for _ in range(n):
            k = r.read_bytes().decode("utf-8")
            meta[k] = r.read_bytes()
    if "avro.schema" not in meta:
        raise ExecutionError("avro file missing avro.schema metadata")
    schema = json.loads(meta["avro.schema"].decode("utf-8"))
    codec = meta.get("avro.codec", b"null").decode("utf-8")
    sync = r.read(16)
    rows: List[dict] = []
    while r.pos < len(r.buf):
        count = r.read_varint()
        blen = r.read_varint()
        payload = r.read(blen)
        if codec == "deflate":
            payload = zlib.decompress(payload, -15)
        elif codec != "null":
            raise ExecutionError(f"unsupported avro codec {codec!r}")
        br = _Reader(payload)
        for _ in range(count):
            rows.append(_read_value(br, schema))
        if r.read(16) != sync:
            raise ExecutionError("avro sync marker mismatch (corrupt file)")
    return schema, rows


def write_avro(path: str, schema: dict, rows: List[dict],
               codec: str = "null", sync: Optional[bytes] = None) -> None:
    """Write rows as an avro object container file."""
    sync = sync or os.urandom(16)
    out = io.BytesIO()
    out.write(MAGIC)
    meta = {"avro.schema": json.dumps(schema).encode(),
            "avro.codec": codec.encode()}
    _write_varint(out, len(meta))
    for k, v in meta.items():
        kb = k.encode()
        _write_varint(out, len(kb))
        out.write(kb)
        _write_varint(out, len(v))
        out.write(v)
    out.write(b"\x00")  # end of metadata map
    out.write(sync)
    body = io.BytesIO()
    for row in rows:
        _write_value(body, schema, row)
    payload = body.getvalue()
    if codec == "deflate":
        c = zlib.compressobj(9, zlib.DEFLATED, -15)
        payload = c.compress(payload) + c.flush()
    elif codec != "null":
        raise ExecutionError(f"unsupported avro codec {codec!r}")
    _write_varint(out, len(rows))
    _write_varint(out, len(payload))
    out.write(payload)
    out.write(sync)
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(out.getvalue())


def read_avro_schema(path_or_file) -> dict:
    """Header-only read: the writer schema from the file metadata map.
    O(header bytes) — registration/schema-inference must not decode the
    whole file."""
    if hasattr(path_or_file, "read"):
        data = path_or_file.read(1 << 16)
    else:
        with open(path_or_file, "rb") as f:
            data = f.read(1 << 16)
    r = _Reader(data)
    if r.read(4) != MAGIC:
        raise ExecutionError("not an avro object container file")
    while True:
        n = r.read_varint()
        if n == 0:
            break
        if n < 0:
            r.read_varint()
            n = -n
        for _ in range(n):
            k = r.read_bytes().decode("utf-8")
            v = r.read_bytes()
            if k == "avro.schema":
                return json.loads(v.decode("utf-8"))
    raise ExecutionError("avro file missing avro.schema metadata")


def _avro_arrow_type(s):
    import pyarrow as pa

    if isinstance(s, list):
        non_null = [x for x in s if x != "null"]
        return _avro_arrow_type(non_null[0]) if non_null else pa.null()
    if isinstance(s, dict):
        return _avro_arrow_type(s["type"])
    return {"boolean": pa.bool_(), "int": pa.int32(), "long": pa.int64(),
            "float": pa.float32(), "double": pa.float64(),
            "string": pa.string(), "bytes": pa.binary(),
            "null": pa.null()}[s]


def avro_arrow_schema(schema: dict):
    """Avro record schema -> (pyarrow schema, nullable-by-column map)."""
    import pyarrow as pa

    if not (isinstance(schema, dict) and schema.get("type") == "record"):
        raise ExecutionError("avro scans need a top-level record schema")
    fields = [pa.field(f["name"], _avro_arrow_type(f["type"]))
              for f in schema["fields"]]
    nullable = {f["name"]: isinstance(f["type"], list) and "null" in f["type"]
                for f in schema["fields"]}
    return pa.schema(fields), nullable


def avro_to_arrow(path_or_file):
    """Container file -> pyarrow Table (the scan entry point)."""
    import pyarrow as pa

    schema, rows = read_avro(path_or_file)
    pa_schema, _ = avro_arrow_schema(schema)
    names = [f["name"] for f in schema["fields"]]
    cols = {n: [] for n in names}
    for row in rows:
        for n in names:
            cols[n].append(row.get(n))
    arrays = [pa.array(cols[name], type=pa_schema.field(name).type)
              for name in names]
    return pa.table(arrays, names=names)
