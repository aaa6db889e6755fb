"""Exchange operators: the shuffle between stages, and the in-process
repartition of the local engine.

Mirrors arrow_ballista_tpu/ops/shuffle.py:

- ``ShuffleWriterExec`` (a stage's root): runs its child for one input
  partition and writes one Arrow IPC file per output partition under
  ``<work_dir>/<job>/<stage>/<input_partition>/data-<q>.arrow``.  For a
  hash exchange the bucket of each row is the partition keys' compiled
  closures followed by K3 (``kernels.bucket_of``) on the device; one
  packed device->host copy brings back the live rows with their bucket
  ids, and a host-side stable grouping sort hands the writer one
  contiguous slice per output partition.
- ``ShuffleReaderExec`` (a stage's leaf): reads one output partition's
  files from every map task.  Three paths, as in the reference: the
  producer's own files (the same executor, or port 0: an in-process
  deployment), a co-located producer's file mapped through ``mmap`` (the
  same advertised host, ``ballista.shuffle.local.host_match``; its size
  and CRC checked, any doubt falls back to the fetch), and the remote
  fetch through the producer's data plane (net/dataplane.py: streamed
  lz4 chunks or the whole file, at most
  ``ballista.shuffle.max_concurrent_fetches`` at once on a process-wide
  pool).  Every path decodes on the task's device.
- ``UnresolvedShuffleExec``: placeholder leaf for a producer stage that
  has not run yet; the scheduler resolves it into a reader.
- ``RepartitionExec``: the local engine's in-memory exchange (K3, then
  K22's bucket form: every output partition's mask of a batch in one
  launch).

The partition keys of both are one K19 column program
(compile/programs.py) ahead of K3.
"""
from __future__ import annotations

import dataclasses
import os
import threading
from typing import Dict, List, Optional

import numpy as np

from ..models.batch import ColumnBatch, concat_batches
from ..models.batch import round_capacity as _round_capacity
from ..models.ipc import crc32_file, read_ipc_files, write_ipc_file, write_ipc_rows
from ..models.schema import Schema
from ..utils.errors import InternalError
from . import kernels as K
from .physical import (ExecutionPlan, Partitioning, TaskContext, exprs_sig, schema_sig,
                       shared_program)


def _key_program(op, ctx: TaskContext, label: str):
    """An exchange's partition keys as one K19 column program (``__k0``,
    ...) ahead of K3, shared across jobs by signature."""
    from ..compile.programs import key_program

    with op.build_lock():
        if op._compiled is None:
            op._compiled = shared_program(
                (label, str(ctx.device), schema_sig(op.input.schema),
                 exprs_sig(op.partitioning.exprs)),
                lambda: key_program(label, op.input.schema, op.partitioning.exprs,
                                    ctx.device))
        return op._compiled


@dataclasses.dataclass
class ShuffleWritePartition:
    """Metadata of one written shuffle partition."""

    output_partition: int
    path: str
    num_rows: int
    num_bytes: int
    # CRC-32 of the file bytes; -1 = not recorded
    checksum: int = -1


@dataclasses.dataclass
class PartitionLocation:
    """Where a map output lives.  ``host``/``port`` address the owning
    executor's data plane (0 = in-process: the path is authoritative)."""

    executor_id: str
    map_partition: int
    output_partition: int
    path: str
    num_rows: int = 0
    num_bytes: int = 0
    host: str = ""
    port: int = 0
    checksum: int = -1
    grpc_port: int = 0
    format: str = ""


class ShuffleWriterExec(ExecutionPlan):
    """``partitioning=None`` marks a final stage: the input partition's rows
    are written verbatim to one file whose output_partition is the input
    partition index."""

    def __init__(self, input: ExecutionPlan, partitioning: Optional[Partitioning],
                 stage_id: int = 0):
        self.input = input
        self.partitioning = partitioning
        self.stage_id = stage_id
        self._schema = input.schema
        self._compiled = None

    def children(self):
        return [self.input]

    def output_partition_count(self):
        # input partition count == number of map tasks
        return self.input.output_partition_count()

    def output_partitioning(self):
        return self.partitioning or Partitioning.unknown(self.output_partition_count())

    def device_programs(self, ctx: TaskContext):
        if self.partitioning is not None and self.partitioning.kind == "hash" \
                and self.partitioning.count > 1:
            return [_key_program(self, ctx, "shuffle keys")]
        return []

    def execute_write(self, partition: int, ctx: TaskContext) -> List[ShuffleWritePartition]:
        with ctx.op_span(self):
            return self._execute_write(partition, ctx)

    def _execute_write(self, partition: int, ctx: TaskContext) -> List[ShuffleWritePartition]:
        ctx.check_cancelled()
        batches = self.input.execute(partition, ctx)
        ctx.check_cancelled()
        big = concat_batches(self.input.schema, batches, device=ctx.device).shrink()
        base = os.path.join(ctx.work_dir, ctx.job_id, str(self.stage_id), str(partition))

        if self.partitioning is None:
            path = os.path.join(base, "data-0.arrow")
            with self.metrics().timer("write_time"):
                rows, nbytes = write_ipc_file(big, path)
            self.metrics().add("input_rows", big.num_rows)
            self.metrics().add("output_rows", rows)
            return [ShuffleWritePartition(partition, path, rows, nbytes,
                                          checksum=crc32_file(path))]

        num_out = self.partitioning.count
        if self.partitioning.kind == "hash" and num_out > 1:
            from ..compile.programs import operator_program

            prog = _key_program(self, ctx, "shuffle keys")
            with self.metrics().timer("repart_time"):
                keys = operator_program(prog, big.columns, big.mask, prog.aux_arrays(big.dicts))
                bucket = K.bucket_of(list(keys.values()), num_out)
                # ONE packed device->host copy of the live rows, their
                # bucket ids and the live count
                host_cols, n = big.packed_numpy(hint=getattr(self, "_pack_hint", None),
                                                extra32={"__bucket__": bucket})
                self._pack_hint = _round_capacity(n)
                buckets = host_cols.pop("__bucket__")
                order = np.argsort(buckets, kind="stable")
                counts = np.bincount(buckets, minlength=num_out)[:num_out]
                host_cols = {k: v[order] for k, v in host_cols.items()}
            offsets = np.concatenate([[0], np.cumsum(counts)])
            out: List[ShuffleWritePartition] = []
            with self.metrics().timer("write_time"):
                for q in range(num_out):
                    lo, hi = int(offsets[q]), int(offsets[q + 1])
                    data = {k: v[lo:hi] for k, v in host_cols.items()}
                    path = os.path.join(base, f"data-{q}.arrow")
                    rows, nbytes = write_ipc_rows(big.schema, data, big.dicts, path)
                    out.append(ShuffleWritePartition(q, path, rows, nbytes,
                                                     checksum=crc32_file(path)))
            self.metrics().add("input_rows", n)
            self.metrics().add("output_rows", sum(p.num_rows for p in out))
            return out

        # single (or one-partition) exchange: every row to partition 0
        out = []
        with self.metrics().timer("write_time"):
            for q in range(num_out):
                pb = big if q == 0 else ColumnBatch(big.schema, big.columns,
                                                    big.mask.new_zeros(big.mask.shape),
                                                    big.dicts, num_rows=0)
                path = os.path.join(base, f"data-{q}.arrow")
                rows, nbytes = write_ipc_file(pb, path)
                out.append(ShuffleWritePartition(q, path, rows, nbytes,
                                                 checksum=crc32_file(path)))
        self.metrics().add("input_rows", big.num_rows)
        self.metrics().add("output_rows", sum(p.num_rows for p in out))
        return out

    def execute(self, partition: int, ctx: TaskContext) -> List[ColumnBatch]:
        # as a plain operator: write, return nothing (the executor calls
        # execute_write)
        self.execute_write(partition, ctx)
        return []

    def _label(self):
        part = ("final" if self.partitioning is None
                else f"{self.partitioning.kind}[{self.partitioning.count}]")
        return f"ShuffleWriterExec: stage={self.stage_id} {part}"


class ShuffleReaderExec(ExecutionPlan):
    """Reads one reduce partition's inputs from all map tasks.
    ``locations[q]`` lists the PartitionLocations of output partition q,
    installed by the scheduler when the producer stage completes."""

    def __init__(self, stage_id: int, schema: Schema, partition_count: int,
                 locations: Optional[Dict[int, List[PartitionLocation]]] = None):
        self.stage_id = stage_id
        self._schema = schema
        self.partition_count = partition_count
        self.locations = locations or {}

    def output_partition_count(self):
        return self.partition_count

    def execute(self, partition: int, ctx: TaskContext) -> List[ColumnBatch]:
        with ctx.op_span(self):
            return self._execute(partition, ctx)

    def _execute(self, partition: int, ctx: TaskContext) -> List[ColumnBatch]:
        from ..utils.config import SHUFFLE_LOCAL_HOST_MATCH
        from ..utils.errors import FetchFailedError

        locs = self.locations.get(partition)
        if locs is None:
            locs = ctx.shuffle_locations.get((self.stage_id, partition))
        if locs is None:
            raise InternalError(
                f"no shuffle locations for stage {self.stage_id} partition {partition}")
        host_match = bool(ctx.config.get(SHUFFLE_LOCAL_HOST_MATCH)) and bool(ctx.executor_host)
        paths = []
        colocated: List[PartitionLocation] = []
        remote: List[PartitionLocation] = []
        for loc in locs:
            if loc.num_rows == 0:
                continue  # skip empty map outputs
            # the local path, gated on executor identity (a same-named path
            # on another machine may be a stale leftover); port 0 means an
            # in-process deployment, where the path is authoritative
            if loc.executor_id == ctx.executor_id or loc.port == 0:
                if not os.path.exists(loc.path):
                    raise FetchFailedError(loc.executor_id, self.stage_id, loc.map_partition,
                                           f"shuffle file missing: {loc.path}")
                paths.append(loc.path)
            elif (host_match and loc.host == ctx.executor_host
                  and loc.format in ("", "arrow_file") and os.path.exists(loc.path)):
                # a co-located producer on the same advertised host: map
                # its file instead of fetching the bytes through its data
                # plane (the host comes from the cluster's metadata; the
                # size and CRC check rejects a stale same-named file)
                colocated.append(loc)
            else:
                remote.append(loc)
        with self.metrics().timer("fetch_time"):
            batches = read_ipc_files(paths, self._schema, capacity=ctx.config.batch_size,
                                     device=ctx.device)
            for loc in colocated:
                got = self._read_colocated(loc, ctx)
                if got is None:
                    remote.append(loc)  # verification failed: fetch instead
                else:
                    batches.extend(got)
            batches.extend(self._fetch_remote_all(remote, ctx))
        self.metrics().add("output_rows", sum(b.num_rows for b in batches))
        return batches

    def _read_colocated(self, loc: PartitionLocation,
                        ctx: TaskContext) -> Optional[List[ColumnBatch]]:
        """A co-located producer's file through ``mmap``: its size checked
        against the producer's recorded bytes, then (with
        ``ballista.shuffle.integrity.verify``) its CRC-32 over the mapped
        buffer.  None when anything disagrees (a stale file, a checksum
        mismatch, a failed map): the caller fetches it instead."""
        import zlib

        import pyarrow as pa
        import pyarrow.ipc as ipc

        from ..models.ipc import physical_table_to_batches
        from ..net.dataplane import STATS
        from ..utils.config import SHUFFLE_INTEGRITY

        try:
            st = os.stat(loc.path)
            if loc.num_bytes > 0 and st.st_size != loc.num_bytes:
                return None  # stale or partially written same-named file
            path_label = "local_mmap"
            try:
                source = pa.memory_map(loc.path, "r")
            except OSError:
                # a filesystem that refuses mmap: a plain read
                source = pa.OSFile(loc.path, "rb")
                path_label = "local_copy"
            with source:
                if ctx.config.get(SHUFFLE_INTEGRITY) and loc.checksum >= 0:
                    buf = source.read_buffer()  # a view of the map
                    if zlib.crc32(memoryview(buf)) != loc.checksum:
                        return None
                    source.seek(0)
                table = ipc.open_file(source).read_all()
            batches = physical_table_to_batches(table, self._schema,
                                                capacity=ctx.config.batch_size,
                                                device=ctx.device)
        except Exception:  # noqa: BLE001 — any local doubt: the remote fetch
            return None
        STATS.record(path_label, st.st_size)
        self.metrics().add(f"bytes_{path_label}", st.st_size)
        return batches

    # one bounded pool for every concurrent reduce task of the process; the
    # per-call semaphore (ballista.shuffle.max_concurrent_fetches) bounds a
    # task's fetches in flight
    _FETCH_POOL = None
    _FETCH_POOL_LOCK = threading.Lock()
    _FETCH_POOL_WORKERS = 64

    @classmethod
    def _fetch_pool(cls):
        if cls._FETCH_POOL is None:
            from concurrent.futures import ThreadPoolExecutor

            with cls._FETCH_POOL_LOCK:
                if cls._FETCH_POOL is None:
                    cls._FETCH_POOL = ThreadPoolExecutor(max_workers=cls._FETCH_POOL_WORKERS,
                                                         thread_name_prefix="shuffle-fetch")
        return cls._FETCH_POOL

    def _fetch_remote_all(self, remote: List[PartitionLocation],
                          ctx: TaskContext) -> List[ColumnBatch]:
        """Bounded-concurrency remote fetch, the locations shuffled so that
        simultaneous readers do not all start on the same executor."""
        if not remote:
            return []
        if len(remote) == 1:
            return self._fetch_remote(remote[0], ctx)
        import random

        from ..utils.config import SHUFFLE_MAX_CONCURRENT_FETCHES

        limit = max(1, int(ctx.config.get(SHUFFLE_MAX_CONCURRENT_FETCHES)))
        gate = threading.Semaphore(min(limit, len(remote)))
        order = list(remote)
        random.shuffle(order)

        def fetch(loc: PartitionLocation) -> List[ColumnBatch]:
            with gate:
                return self._fetch_remote(loc, ctx)

        out: List[ColumnBatch] = []
        for got in self._fetch_pool().map(fetch, order):
            out.extend(got)
        return out

    def _fetch_remote(self, loc: PartitionLocation, ctx: TaskContext) -> List[ColumnBatch]:
        from ..net.dataplane import (StreamUnsupported, fetch_partition_batches,
                                     fetch_partition_stream)
        from ..net.retry import RetryPolicy
        from ..utils.config import (SHUFFLE_INTEGRITY, SHUFFLE_WIRE_CHUNK_ROWS,
                                    SHUFFLE_WIRE_COMPRESSION, SHUFFLE_WIRE_STREAMING)
        from ..utils.errors import FetchFailedError

        policy = RetryPolicy.from_config(ctx.config)
        expected = loc.checksum if ctx.config.get(SHUFFLE_INTEGRITY) else -1
        fault_ctx = {"stage_id": self.stage_id, "map_partition": loc.map_partition,
                     "executor_id": loc.executor_id}
        try:
            if ctx.config.get(SHUFFLE_WIRE_STREAMING) and loc.grpc_port > 0:
                try:
                    batches, stats = fetch_partition_stream(
                        loc.host, loc.grpc_port, loc.path, self._schema, ctx.config.batch_size,
                        policy=policy, expected_checksum=expected,
                        chunk_rows=int(ctx.config.get(SHUFFLE_WIRE_CHUNK_ROWS)),
                        compression=str(ctx.config.get(SHUFFLE_WIRE_COMPRESSION)),
                        fault_ctx=fault_ctx, device=ctx.device)
                    self.metrics().add("remote_fetches", 1)
                    self.metrics().add("fetch_chunks", stats["chunks"])
                    self.metrics().add("wire_bytes", stats["wire_bytes"])
                    self.metrics().add("raw_bytes", stats["raw_bytes"])
                    return batches
                except StreamUnsupported:
                    pass  # a peer without the stream: the whole file
            batches = fetch_partition_batches(
                loc.host, loc.port, loc.path, self._schema, ctx.config.batch_size,
                policy=policy, expected_checksum=expected, fault_ctx=fault_ctx,
                device=ctx.device)
            self.metrics().add("remote_fetches", 1)
            return batches
        except Exception as err:  # noqa: BLE001 — retries exhausted
            raise FetchFailedError(loc.executor_id, self.stage_id, loc.map_partition,
                                   f"remote fetch failed: {err}") from err

    def _label(self):
        return f"ShuffleReaderExec: stage={self.stage_id} partitions={self.partition_count}"


class UnresolvedShuffleExec(ExecutionPlan):
    def __init__(self, stage_id: int, schema: Schema, output_partition_count: int):
        self.stage_id = stage_id
        self._schema = schema
        self._count = output_partition_count

    def output_partition_count(self):
        return self._count

    def execute(self, partition: int, ctx: TaskContext):
        raise InternalError(
            f"UnresolvedShuffleExec(stage={self.stage_id}) cannot execute; "
            "the scheduler must resolve it to a ShuffleReaderExec first")

    def _label(self):
        return f"UnresolvedShuffleExec: stage={self.stage_id}"


class RepartitionExec(ExecutionPlan):
    """Exchange marker.  The distributed planner replaces it with a
    ShuffleWriter/Reader stage pair; the local engine executes it
    in-process: the child runs once (all partitions, cached) and every
    output partition gets every input batch with a mask of the rows that
    hash to it (K3).  The buckets share the input's columns (tensors are
    never updated in place)."""

    def __init__(self, input: ExecutionPlan, partitioning: Partitioning):
        self.input = input
        self.partitioning = partitioning
        self._schema = input.schema
        self._cache: Optional[List[List[ColumnBatch]]] = None
        self._compiled = None


    def device_programs(self, ctx: TaskContext):
        if self.partitioning.kind == "hash" and self.partitioning.count > 1:
            return [_key_program(self, ctx, "repartition keys")]
        return []

    def children(self):
        return [self.input]

    def output_partition_count(self):
        return self.partitioning.count

    def output_partitioning(self):
        return self.partitioning

    def _materialize(self, ctx: TaskContext):
        num_out = self.partitioning.count
        parts: List[List[ColumnBatch]] = [[] for _ in range(num_out)]
        if self.partitioning.kind == "hash" and num_out > 1:
            from ..compile.programs import operator_program

            prog = _key_program(self, ctx, "repartition keys")
            for p in range(self.input.output_partition_count()):
                for b in self.input.execute(p, ctx):
                    with self.metrics().timer("repartition_time"):
                        keys = operator_program(prog, b.columns, b.mask,
                                                prog.aux_arrays(b.dicts))
                        bucket = K.bucket_of(list(keys.values()), num_out)
                        masks = K.bucket_masks(b.mask, bucket, num_out)
                        for q in range(num_out):
                            parts[q].append(ColumnBatch(b.schema, b.columns, masks[q], b.dicts))
        else:
            for p in range(self.input.output_partition_count()):
                parts[0].extend(self.input.execute(p, ctx))
        self._cache = parts

    def execute(self, partition: int, ctx: TaskContext) -> List[ColumnBatch]:
        with ctx.op_span(self):
            if self._cache is None:
                self._materialize(ctx)
            return self._cache[partition]

    def _label(self):
        return f"RepartitionExec: {self.partitioning.kind}[{self.partitioning.count}]"
