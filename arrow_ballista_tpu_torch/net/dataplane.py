"""Shared data-plane fetch: partition bytes -> batches on a device.

Mirrors arrow_ballista_tpu/net/dataplane.py.  One implementation serves
both consumers, the shuffle reader (ops/shuffle.py) and the remote
client's result fetch (client/remote.py): bounded retries with capped
jittered exponential backoff (``net.retry.RetryPolicy``), and the
``shuffle.fetch.recv`` failpoint (faults/) per attempt and, on the
streaming path, per chunk (raise, delay, drop, and deterministic payload
corruption).  Every fetch decodes into the port's ``ColumnBatch`` on the
caller's ``device`` (models/ipc.py ``physical_table_to_batches``).

Two wire formats coexist:

- **whole-file** (``fetch_partition``): one request, one binary response
  holding the complete Arrow IPC file, served by both the native C++ data
  plane (native.py) and the Python RPC server.  File-level CRC-32 check.
- **chunked stream** (``fetch_partition_stream``): the server re-frames
  the partition as self-contained Arrow IPC *stream* segments of
  ``chunk_rows`` rows each (dictionaries kept, optional lz4/zstd buffer
  compression), each with its own CRC-32.  The client decodes chunk *k*
  while chunk *k+1* is in flight, and a retry resumes at the first
  unverified chunk.  Chunk boundaries are the row offsets
  ``i * chunk_rows``, so resumed streams splice exactly.

The server half (:func:`stream_partition`) lives here too, so the
protocol's two ends stay in one file.  ``STATS`` counts the bytes and
fetches of each path (``local_mmap``, ``local_copy``, ``remote``); the
executor's prometheus exposition (executor/metrics.py) reads it.
"""
from __future__ import annotations

import io
import json
import logging
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from .. import faults
from ..models.batch import ColumnBatch
from ..models.schema import Schema
from . import wire
from .retry import RetryPolicy

log = logging.getLogger(__name__)

FETCH_RETRIES = 3
RETRY_BACKOFF_S = 3.0

# convert/upload workers for the streaming path: chunk k's
# IPC-table -> device-batch conversion runs here while the socket reads
# chunk k+1 (at most one in flight per stream, so ordering and resume
# bookkeeping stay trivial).  Module-level + lazy: threads are shared by
# every concurrent fetch in the process and never spawned for
# non-streaming workloads.
_CONVERT_POOL = None
_CONVERT_POOL_LOCK = threading.Lock()


def _convert_pool():
    global _CONVERT_POOL
    if _CONVERT_POOL is None:
        with _CONVERT_POOL_LOCK:
            if _CONVERT_POOL is None:
                from concurrent.futures import ThreadPoolExecutor

                _CONVERT_POOL = ThreadPoolExecutor(
                    max_workers=4, thread_name_prefix="dp-convert")
    return _CONVERT_POOL

#: codecs the streaming path may negotiate ("none" disables compression)
WIRE_CODECS = ("lz4", "zstd")
DEFAULT_CHUNK_ROWS = 1 << 16


class StreamUnsupported(Exception):
    """The peer does not speak ``fetch_partition_stream`` (pre-upgrade
    executor or native-only data plane); callers fall back to the
    whole-file protocol."""


class DataPlaneStats:
    """Process-wide shuffle transfer accounting, labelled by path.

    Folded into the executor's prometheus exposition
    (``shuffle_bytes_fetched_total{path=...}``,
    ``shuffle_wire_compression_ratio``, executor/metrics.py).  ``raw_bytes``/``wire_bytes`` compare
    the on-disk partition size with what actually crossed the network, so
    the compression ratio is measured, not assumed.
    """

    PATHS = ("local_mmap", "local_copy", "remote")

    def __init__(self):
        self._lock = threading.Lock()
        self.bytes_fetched: Dict[str, int] = {p: 0 for p in self.PATHS}
        self.fetches: Dict[str, int] = {p: 0 for p in self.PATHS}
        self.chunks = 0
        self.streams = 0
        self.resumed_chunks = 0  # chunks skipped via start_chunk on retry
        self.raw_bytes = 0       # on-disk bytes of streamed partitions
        self.wire_bytes = 0      # bytes that actually crossed the wire

    def record(self, path: str, nbytes: int) -> None:
        with self._lock:
            self.bytes_fetched[path] += int(nbytes)
            self.fetches[path] += 1

    def record_stream(self, chunks: int, raw_bytes: int, wire_bytes: int,
                      resumed: int = 0) -> None:
        with self._lock:
            self.streams += 1
            self.chunks += int(chunks)
            self.raw_bytes += int(raw_bytes)
            self.wire_bytes += int(wire_bytes)
            self.resumed_chunks += int(resumed)

    def compression_ratio(self) -> float:
        """raw/wire of all streamed fetches (1.0 = incompressible or no
        streams yet; >1 = the wire carried fewer bytes than the files)."""
        with self._lock:
            return (self.raw_bytes / self.wire_bytes) if self.wire_bytes else 1.0

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            return {
                "bytes_fetched": dict(self.bytes_fetched),
                "fetches": dict(self.fetches),
                "chunks": self.chunks,
                "streams": self.streams,
                "resumed_chunks": self.resumed_chunks,
                "raw_bytes": self.raw_bytes,
                "wire_bytes": self.wire_bytes,
            }


#: module singleton: every reader in the process folds into one view
STATS = DataPlaneStats()


def negotiate_codec(requested: str) -> Optional[str]:
    """Map a requested wire codec onto what this build of Arrow provides.
    Unknown or unavailable codecs degrade to None (uncompressed) rather
    than failing the fetch — compression is an optimization, not a
    contract."""
    import pyarrow as pa

    codec = str(requested or "none").lower()
    if codec not in WIRE_CODECS:
        return None
    try:
        return codec if pa.Codec.is_available(codec) else None
    except Exception:  # noqa: BLE001 — ancient Arrow without is_available
        return None


def _sleep_for_retry(policy: RetryPolicy, attempt: int, err: Exception) -> None:
    """Backoff split: a corrupt payload
    (``IntegrityError``) re-fetches immediately — fresh bytes may be clean
    and the peer is demonstrably reachable — while connection failures
    keep the jittered backoff so a restarted executor is not hammered."""
    from ..utils.errors import IntegrityError

    if isinstance(err, IntegrityError):
        return
    time.sleep(policy.backoff_s(attempt))


def fetch_partition_batches(host: str, port: int, path: str, schema: Schema,
                            capacity: int,
                            retries: int = FETCH_RETRIES,
                            backoff_s: float = RETRY_BACKOFF_S,
                            policy: Optional[RetryPolicy] = None,
                            expected_checksum: int = -1,
                            fault_ctx: Optional[dict] = None,
                            device="cuda") -> List[ColumnBatch]:
    """Fetch one shuffle/result file from an executor data plane and decode
    it into batches on ``device``.  Raises the last error after ``retries``.

    ``policy`` supplies connect/read deadlines and the backoff curve; when
    absent, legacy defaults (linear-ish ``backoff_s`` base, 3s cap) apply.
    ``expected_checksum`` >= 0 is the producer-recorded CRC-32 of the file:
    the payload is verified BEFORE Arrow deserialization and a mismatch
    raises ``IntegrityError`` — retried in-loop immediately, with no
    backoff (a re-fetch heals transient wire corruption and the peer is
    reachable); connection failures back off between attempts.  After
    ``retries`` the caller escalates to ``FetchFailedError`` and lineage
    recovery re-runs the producer.  An undecodable payload surfaces the
    same way rather than as an opaque Arrow traceback.
    ``fault_ctx`` adds caller-known match keys (producer stage/partition/
    executor) to the ``shuffle.fetch.recv`` failpoint context, so a chaos
    plan can pin a rule to ONE logical fetch rather than racing the hit
    counter across concurrent fetches.
    """
    import pyarrow.ipc as ipc

    from ..models.ipc import physical_table_to_batches
    from ..utils.errors import IntegrityError

    import os
    import zlib

    policy = policy or RetryPolicy(base_backoff_s=backoff_s,
                                   max_backoff_s=backoff_s * retries,
                                   read_timeout_s=60.0)
    req = {"path": path}
    token = os.environ.get("BALLISTA_DATA_PLANE_TOKEN", "")
    if token:
        req["token"] = token
    err: Exception = RuntimeError("unreachable")
    for attempt in range(retries):
        try:
            rule = faults.inject("shuffle.fetch.recv", host=host, port=port,
                                 path=path, attempt=attempt,
                                 **(fault_ctx or {}))
            if rule is not None and rule.action == "drop":
                raise ConnectionError(
                    "failpoint shuffle.fetch.recv dropped the payload")
            _, data = wire.call(host, port, "fetch_partition", req,
                                timeout=policy.read_timeout_s,
                                connect_timeout=policy.connect_timeout_s)
            if rule is not None and rule.action == "corrupt":
                data = faults.corrupt_bytes(data)
            if expected_checksum >= 0:
                got = zlib.crc32(data)
                if got != expected_checksum:
                    raise IntegrityError(
                        "shuffle.fetch.recv",
                        f"checksum mismatch: expected crc32 "
                        f"{expected_checksum:#010x}, got {got:#010x} "
                        f"({len(data)} bytes)",
                        host=host, port=port, path=path,
                        **(fault_ctx or {}))
            try:
                table = ipc.open_file(io.BytesIO(data)).read_all()
            except Exception as decode_err:
                # undecodable frame == corruption the checksum did not (or
                # could not) catch; surface it as the same diagnosable,
                # retryable integrity failure instead of an Arrow traceback
                raise IntegrityError(
                    "shuffle.fetch.recv",
                    f"undecodable partition payload ({len(data)} bytes): "
                    f"{decode_err}",
                    host=host, port=port, path=path,
                    **(fault_ctx or {})) from decode_err
            STATS.record("remote", len(data))
            return physical_table_to_batches(table, schema, capacity=capacity,
                                             device=device)
        except Exception as e:  # noqa: BLE001 — caller maps to its taxonomy
            err = e
            if attempt + 1 < retries:
                _sleep_for_retry(policy, attempt, e)
    raise err


# --------------------------------------------------------------------------
# chunked streaming protocol
# --------------------------------------------------------------------------


def stream_partition(path: str, payload: dict,
                     send: Callable[[dict, bytes], None],
                     default_chunk_rows: int = DEFAULT_CHUNK_ROWS) -> None:
    """Server half of ``fetch_partition_stream``: re-frame one on-disk
    Arrow IPC partition file as CRC'd IPC-stream chunks.

    The caller (executor RPC handler, or a bare test server) has already
    authenticated the request and resolved ``path`` inside its work dir.
    ``payload`` fields:

    - ``expected_checksum`` (int, optional): producer-recorded file CRC-32;
      verified against the on-disk bytes (page-cache hot) before anything
      streams, so a corrupt disk file fails fast with ``IntegrityError``
      instead of shipping garbage.
    - ``chunk_rows`` (int, optional): rows per chunk; must match across
      resume attempts for boundaries to line up (the client always sends
      its configured value).
    - ``start_chunk`` (int, optional): first chunk to emit — a resumed
      fetch skips chunks the client already verified and decoded.
    - ``compression`` (str, optional): requested wire codec; negotiated
      down to what this Arrow build provides.

    Every chunk frame is ``{"ok": True, "payload": {chunk, rows, crc,
    chunks}}`` + the chunk bytes; the terminal frame carries ``eos`` with
    raw/wire byte totals and the codec actually used.  Each chunk is a
    self-contained IPC stream (schema + dictionaries + one batch slice):
    dictionary encoding rides the wire unmodified and any chunk decodes
    independently of the others — what makes exact resume possible.
    """
    import os
    import zlib

    import pyarrow as pa
    import pyarrow.ipc as ipc

    from ..models.ipc import crc32_file
    from ..utils.errors import IntegrityError

    expected = int(payload.get("expected_checksum", -1))
    if expected >= 0:
        got = crc32_file(path)
        if got != expected:
            raise IntegrityError(
                "shuffle.fetch.stream",
                f"on-disk partition corrupt: expected crc32 "
                f"{expected:#010x}, got {got:#010x}", path=path)
    with pa.memory_map(path, "r") as source:
        table = ipc.open_file(source).read_all()
    chunk_rows = max(1, int(payload.get("chunk_rows") or default_chunk_rows))
    codec = negotiate_codec(payload.get("compression", "none"))
    opts = ipc.IpcWriteOptions(compression=codec) if codec \
        else ipc.IpcWriteOptions()
    total = max(1, -(-table.num_rows // chunk_rows))
    start = max(0, int(payload.get("start_chunk", 0)))
    wire_bytes = 0
    for i in range(start, total):
        sl = table.slice(i * chunk_rows, chunk_rows)
        sink = pa.BufferOutputStream()
        with ipc.new_stream(sink, table.schema, options=opts) as w:
            w.write_table(sl)
        chunk = sink.getvalue().to_pybytes()
        wire_bytes += len(chunk)
        send({"ok": True, "payload": {
            "chunk": i, "rows": sl.num_rows, "chunks": total,
            "crc": zlib.crc32(chunk)}}, chunk)
    send({"ok": True, "payload": {
        "eos": True, "chunks": total, "start_chunk": start,
        "raw_bytes": os.path.getsize(path), "wire_bytes": wire_bytes,
        "codec": codec or "none"}}, b"")


def fetch_partition_stream(host: str, port: int, path: str, schema: Schema,
                           capacity: int,
                           retries: int = FETCH_RETRIES,
                           policy: Optional[RetryPolicy] = None,
                           expected_checksum: int = -1,
                           chunk_rows: int = DEFAULT_CHUNK_ROWS,
                           compression: str = "lz4",
                           fault_ctx: Optional[dict] = None,
                           device="cuda",
                           ) -> Tuple[List[ColumnBatch], Dict[str, int]]:
    """Client half of the chunked protocol: fetch one partition as a
    pipelined chunk stream, decoding each verified chunk immediately.

    Returns ``(batches, stats)`` where stats carries ``chunks`` /
    ``raw_bytes`` / ``wire_bytes`` / ``resumed_chunks`` for the caller's
    operator metrics.  Retry semantics:

    - a corrupt chunk (CRC mismatch or undecodable) raises
      ``IntegrityError`` and re-fetches IMMEDIATELY from the first
      unverified chunk — already-decoded chunks are kept;
    - connection failures back off (jittered) and also resume;
    - a server-reported ``IntegrityError`` (the on-disk file itself is
      corrupt) is NOT retried — re-fetching cannot heal a bad disk file,
      so it escalates straight to the caller's ``FetchFailedError`` ->
      lineage rollback;
    - an ``unknown method`` answer raises :class:`StreamUnsupported` so
      the caller falls back to the whole-file protocol.
    """
    import os
    import zlib

    import pyarrow.ipc as ipc

    from ..models.ipc import physical_table_to_batches
    from ..utils.errors import IntegrityError

    policy = policy or RetryPolicy(read_timeout_s=60.0)
    token = os.environ.get("BALLISTA_DATA_PLANE_TOKEN", "")
    batches: List[ColumnBatch] = []
    state = {"next_chunk": 0, "wire_bytes": 0, "resumed": 0,
             "raw_bytes": 0, "chunks": 0, "codec": "none"}

    def _stream_once(attempt: int) -> None:
        req = {"path": path, "chunk_rows": int(chunk_rows),
               "compression": compression,
               "start_chunk": state["next_chunk"]}
        if expected_checksum >= 0:
            req["expected_checksum"] = expected_checksum
        if token:
            req["token"] = token
        if state["next_chunk"]:
            state["resumed"] = state["next_chunk"]
        # decode/upload pipeline: at most ONE chunk's
        # physical_table_to_batches (the device-transfer half) runs on the
        # convert pool while this thread reads + CRC-checks + IPC-decodes
        # the next frame off the socket.  next_chunk/wire_bytes commit only
        # when the convert completes, so a mid-stream failure still resumes
        # at the first chunk whose batches aren't in `batches`.
        pending = None  # (chunk_idx, Future[List[ColumnBatch]], wire_len)

        def _commit_pending() -> None:
            nonlocal pending
            if pending is None:
                return
            pidx, fut, wlen = pending
            pending = None
            batches.extend(fut.result())
            state["next_chunk"] = pidx + 1
            state["wire_bytes"] += wlen

        sock = wire.connect(host, port, policy.connect_timeout_s)
        try:
            sock.settimeout(policy.read_timeout_s)
            wire.send_frame(sock, {"method": "fetch_partition_stream",
                                   "payload": req})
            while True:
                jbytes, chunk = wire.recv_frame_raw(sock)
                try:
                    resp = json.loads(jbytes) if jbytes else {}
                except Exception as e:
                    raise IntegrityError(
                        "shuffle.fetch.recv",
                        f"undecodable stream frame ({len(jbytes)} bytes): {e}",
                        host=host, port=port, path=path,
                        **(fault_ctx or {})) from e
                if not resp.get("ok"):
                    raise wire.RemoteError(
                        resp.get("error", "unknown remote error"),
                        resp.get("error_kind", ""))
                p = resp.get("payload", {})
                if p.get("eos"):
                    _commit_pending()
                    state["raw_bytes"] = int(p.get("raw_bytes", 0))
                    state["chunks"] = int(p.get("chunks", 0))
                    state["codec"] = p.get("codec", "none")
                    return
                idx = int(p["chunk"])
                # per-CHUNK failpoint: a chaos plan matching {"chunk": k}
                # corrupts or drops exactly one mid-stream chunk
                rule = faults.inject("shuffle.fetch.recv", host=host,
                                     port=port, path=path, attempt=attempt,
                                     chunk=idx, **(fault_ctx or {}))
                if rule is not None and rule.action == "drop":
                    raise ConnectionError(
                        "failpoint shuffle.fetch.recv dropped chunk "
                        f"{idx} mid-stream")
                if rule is not None and rule.action == "corrupt":
                    chunk = faults.corrupt_bytes(chunk)
                got_crc = zlib.crc32(chunk)
                if got_crc != int(p.get("crc", -1)):
                    raise IntegrityError(
                        "shuffle.fetch.recv",
                        f"chunk {idx} checksum mismatch: expected crc32 "
                        f"{int(p.get('crc', -1)):#010x}, got {got_crc:#010x} "
                        f"({len(chunk)} bytes)",
                        host=host, port=port, path=path, chunk=idx,
                        **(fault_ctx or {}))
                try:
                    table = ipc.open_stream(io.BytesIO(chunk)).read_all()
                except Exception as decode_err:
                    raise IntegrityError(
                        "shuffle.fetch.recv",
                        f"undecodable chunk {idx} ({len(chunk)} bytes): "
                        f"{decode_err}",
                        host=host, port=port, path=path, chunk=idx,
                        **(fault_ctx or {})) from decode_err
                # chunk verified + decoded: retire the previous chunk's
                # convert (ordered commit), then hand this one to the pool
                # and go straight back to the socket
                _commit_pending()
                if table.num_rows:
                    pending = (idx, _convert_pool().submit(
                        physical_table_to_batches, table, schema,
                        capacity=capacity, device=device), len(chunk))
                else:
                    state["next_chunk"] = idx + 1
                    state["wire_bytes"] += len(chunk)
        finally:
            if pending is not None:
                # unwinding on error with a convert in flight: commit it if
                # it succeeds (it was verified) so the resume skips it; if
                # the CONVERT itself failed, leave next_chunk pointing at it
                # so the retry re-fetches and re-converts
                pidx, fut, wlen = pending
                pending = None
                try:
                    batches.extend(fut.result())
                    state["next_chunk"] = pidx + 1
                    state["wire_bytes"] += wlen
                except Exception:  # noqa: BLE001
                    log.warning("chunk %s convert failed during unwind; "
                                "retry will re-fetch it", pidx, exc_info=True)
            sock.close()

    err: Exception = RuntimeError("unreachable")
    for attempt in range(retries):
        try:
            _stream_once(attempt)
            stats = {"chunks": state["chunks"],
                     "raw_bytes": state["raw_bytes"],
                     "wire_bytes": state["wire_bytes"],
                     "resumed_chunks": state["resumed"],
                     "codec": state["codec"]}
            STATS.record("remote", state["wire_bytes"])
            STATS.record_stream(state["chunks"], state["raw_bytes"],
                                state["wire_bytes"], state["resumed"])
            return batches, stats
        except wire.RemoteError as e:
            if "unknown method" in str(e):
                raise StreamUnsupported(str(e)) from e
            if e.kind == "IntegrityError":
                # the server verified the DISK file against the producer
                # checksum and it failed: no re-fetch can heal that —
                # escalate now so lineage re-runs the producer
                from ..utils.errors import IntegrityError as IErr

                raise IErr("shuffle.fetch.stream",
                           f"producer file corrupt on disk: {e}",
                           host=host, port=port, path=path,
                           **(fault_ctx or {})) from e
            raise
        except Exception as e:  # noqa: BLE001 — caller maps to its taxonomy
            err = e
            if attempt + 1 < retries:
                _sleep_for_retry(policy, attempt, e)
    raise err
