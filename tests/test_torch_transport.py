"""The port's shuffle transport (net/dataplane.py, the shuffle reader's
three paths, native.py) against the JAX package's.

The counterparts of tests/test_shuffle_transport.py: every wire format
(chunk sizes x lz4 / zstd / none, and the whole file) decodes to the same
logical table as the reference's direct read of the same partition file,
an unknown codec degrades to none, a corrupt or dropped chunk resumes at
the first unverified chunk, a corrupt payload re-fetches at once while a
dropped connection backs off, a file corrupt on the producer's disk fails
fast, the co-located ``mmap`` path equals the wire, a stale local file
falls back to the fetch, executor identity still wins, and
``ballista.shuffle.max_concurrent_fetches`` bounds the fetches in flight.
Then two processes that build the port's native data plane at once both
load a whole library, and nothing is written under native/.
"""
import multiprocessing
import os
import threading
import time

import numpy as np
import pyarrow as pa
import pytest
import torch

from arrow_ballista_tpu.models.ipc import read_ipc_files as jread_ipc_files
from arrow_ballista_tpu.models.schema import DataType as JDataType
from arrow_ballista_tpu.models.schema import Field as JField
from arrow_ballista_tpu.models.schema import Schema as JSchema
from arrow_ballista_tpu_torch import faults
from arrow_ballista_tpu_torch.models.ipc import crc32_file, write_ipc_rows
from arrow_ballista_tpu_torch.models.schema import DataType, Field, Schema
from arrow_ballista_tpu_torch.net import dataplane as dp
from arrow_ballista_tpu_torch.net.retry import RetryPolicy
from arrow_ballista_tpu_torch.net.rpc import RpcServer
from arrow_ballista_tpu_torch.ops.physical import TaskContext
from arrow_ballista_tpu_torch.ops.shuffle import PartitionLocation, ShuffleReaderExec
from arrow_ballista_tpu_torch.utils.config import BallistaConfig
from arrow_ballista_tpu_torch.utils.errors import FetchFailedError, IntegrityError

torch.set_num_threads(1)
CPU = torch.device("cpu")
FIELDS = [("s", "string", 0), ("small", "int64", 0), ("big", "int64", 0),
          ("d", "decimal", 2), ("f", "float64", 0)]
SCHEMA = Schema([Field(n, DataType(k, sc)) for n, k, sc in FIELDS])
JSCHEMA = JSchema([JField(n, JDataType(k, sc)) for n, k, sc in FIELDS])
N_ROWS = 50_000
N_KEYS = 40
FAST = RetryPolicy(connect_timeout_s=2.0, read_timeout_s=20.0, base_backoff_s=0.01,
                   max_backoff_s=0.02, jitter=0.0)


def _write_partition(path: str, n: int = N_ROWS, seed: int = 7):
    rng = np.random.default_rng(seed)
    data = {"s": rng.integers(0, N_KEYS, n).astype(np.int32),
            "small": rng.integers(-10_000, 10_000, n),
            "big": rng.integers(1, 9) * (1 << 40) + rng.integers(0, 1000, n),
            "d": rng.integers(-500_000, 500_000, n),
            "f": rng.standard_normal(n)}
    dicts = {"s": np.asarray([f"key-{i:05d}" for i in range(N_KEYS)], dtype=object)}
    rows, nbytes = write_ipc_rows(SCHEMA, data, dicts, path)
    assert rows == n
    return nbytes, crc32_file(path)


def _table_of(batches):
    return pa.concat_tables([b.to_arrow() for b in batches])


def _reference(path):
    """The reference's decode of the file: the bit-identity currency."""
    return _table_of(jread_ipc_files([path], JSCHEMA, capacity=8192))


@pytest.fixture()
def partition(tmp_path):
    path = str(tmp_path / "data-0.arrow")
    nbytes, crc = _write_partition(path)
    return path, nbytes, crc


@pytest.fixture()
def stream_server():
    """A bare RPC server speaking both fetch protocols."""
    srv = RpcServer("127.0.0.1", 0)

    def whole_file(payload, _bin):
        with open(payload["path"], "rb") as f:
            data = f.read()
        return {"num_bytes": len(data)}, data

    srv.register("fetch_partition", whole_file)
    srv.register_stream("fetch_partition_stream",
                        lambda p, b, send: dp.stream_partition(p["path"], p, send))
    srv.start()
    yield srv
    srv.stop()


@pytest.mark.parametrize("codec", ["lz4", "zstd", "none"])
@pytest.mark.parametrize("chunk_rows", [1 << 16, 7_000])
def test_stream_matrix_equals_the_references_decode(partition, stream_server, codec,
                                                    chunk_rows):
    path, nbytes, crc = partition
    batches, stats = dp.fetch_partition_stream(
        "127.0.0.1", stream_server.port, path, SCHEMA, capacity=8192, policy=FAST,
        expected_checksum=crc, chunk_rows=chunk_rows, compression=codec, device=CPU)
    assert all(b.mask.device == CPU for b in batches)
    assert _table_of(batches).equals(_reference(path))
    assert stats["chunks"] == -(-N_ROWS // chunk_rows) and stats["raw_bytes"] == nbytes
    if codec in ("lz4", "zstd") and pa.Codec.is_available(codec):
        assert stats["codec"] == codec and stats["wire_bytes"] < nbytes
    else:
        assert stats["codec"] == "none"


def test_unknown_codec_degrades_to_uncompressed(partition, stream_server):
    path, _, crc = partition
    batches, stats = dp.fetch_partition_stream(
        "127.0.0.1", stream_server.port, path, SCHEMA, capacity=8192, policy=FAST,
        expected_checksum=crc, compression="brotli-9000", device=CPU)
    assert stats["codec"] == "none"
    assert _table_of(batches).equals(_reference(path))


def test_whole_file_equals_the_references_decode(partition, stream_server):
    path, _, crc = partition
    batches = dp.fetch_partition_batches("127.0.0.1", stream_server.port, path, SCHEMA,
                                         capacity=8192, policy=FAST, expected_checksum=crc,
                                         device=CPU)
    assert _table_of(batches).equals(_reference(path))


def test_stream_unsupported_peer_raises(partition):
    path, _, _ = partition
    srv = RpcServer("127.0.0.1", 0)
    srv.start()
    try:
        with pytest.raises(dp.StreamUnsupported):
            dp.fetch_partition_stream("127.0.0.1", srv.port, path, SCHEMA, capacity=8192,
                                      policy=FAST, retries=1, device=CPU)
    finally:
        srv.stop()


@pytest.mark.parametrize("action, chunk", [("corrupt", 3), ("drop", 2)])
def test_a_bad_chunk_resumes_without_refetching_verified_chunks(partition, stream_server,
                                                                action, chunk):
    path, _, crc = partition
    plan = faults.FaultPlan.from_obj({"rules": [{
        "site": "shuffle.fetch.recv", "action": action, "times": 1,
        "match": {"chunk": chunk}}]})
    with faults.use_plan(plan):
        batches, stats = dp.fetch_partition_stream(
            "127.0.0.1", stream_server.port, path, SCHEMA, capacity=8192, policy=FAST,
            expected_checksum=crc, chunk_rows=7_000, device=CPU)
    assert plan.schedule() == (("shuffle.fetch.recv", 0, 1, action),)
    assert _table_of(batches).equals(_reference(path))
    assert stats["resumed_chunks"] == chunk


def test_integrity_retries_at_once_a_connection_backs_off(partition, stream_server,
                                                          monkeypatch):
    path, _, crc = partition
    sleeps = []
    monkeypatch.setattr(dp.time, "sleep", lambda s: sleeps.append(s))
    plan = faults.FaultPlan.from_obj({"rules": [{
        "site": "shuffle.fetch.recv", "action": "corrupt", "times": 2}]})
    with faults.use_plan(plan):
        dp.fetch_partition_batches("127.0.0.1", stream_server.port, path, SCHEMA,
                                   capacity=8192, policy=FAST, expected_checksum=crc,
                                   device=CPU)
    assert len(plan.events) == 2 and sleeps == []
    plan = faults.FaultPlan.from_obj({"rules": [{
        "site": "shuffle.fetch.recv", "action": "drop", "times": 2}]})
    with faults.use_plan(plan):
        dp.fetch_partition_batches("127.0.0.1", stream_server.port, path, SCHEMA,
                                   capacity=8192, policy=FAST, expected_checksum=crc,
                                   device=CPU)
    assert len(sleeps) == 2 and all(s > 0 for s in sleeps)


def test_on_disk_corruption_fails_fast_without_refetch(tmp_path, stream_server):
    path = str(tmp_path / "data-0.arrow")
    _, crc = _write_partition(path, n=5_000)
    with open(path, "r+b") as f:  # one byte flipped on the producer's disk
        f.seek(100)
        b = f.read(1)
        f.seek(100)
        f.write(bytes([b[0] ^ 0xFF]))
    calls = []
    stream_server.register_stream(
        "fetch_partition_stream",
        lambda p, b, send: (calls.append(1), dp.stream_partition(p["path"], p, send)))
    with pytest.raises(IntegrityError, match="corrupt"):
        dp.fetch_partition_stream("127.0.0.1", stream_server.port, path, SCHEMA,
                                  capacity=8192, policy=FAST, expected_checksum=crc,
                                  device=CPU)
    assert len(calls) == 1


# --------------------------------------------------------------------------
# the reader's three paths
# --------------------------------------------------------------------------


def _reader_for(path, crc, nbytes, *, host="node-a", port=1, grpc_port=0, conf=None,
                exec_host="node-a"):
    reader = ShuffleReaderExec(stage_id=1, schema=SCHEMA, partition_count=1, locations={
        0: [PartitionLocation("producer-exec", 0, 0, path, num_rows=N_ROWS, num_bytes=nbytes,
                              host=host, port=port, checksum=crc, grpc_port=grpc_port,
                              format="arrow_file")]})
    ctx = TaskContext(device=CPU, config=BallistaConfig(conf or {}),
                      executor_id="consumer-exec", executor_host=exec_host)
    return reader, ctx


def test_host_match_mmap_equals_the_references_decode(partition):
    path, nbytes, crc = partition
    before = dp.STATS.snapshot()
    reader, ctx = _reader_for(path, crc, nbytes)
    assert _table_of(reader.execute(0, ctx)).equals(_reference(path))
    after = dp.STATS.snapshot()
    assert after["bytes_fetched"]["local_mmap"] - before["bytes_fetched"]["local_mmap"] \
        == nbytes
    m = reader.metrics().to_dict()
    assert m.get("bytes_local_mmap") == nbytes and "remote_fetches" not in m


def test_host_match_mmap_equals_the_wire(partition, stream_server):
    path, nbytes, crc = partition
    reader, ctx = _reader_for(path, crc, nbytes)
    via_mmap = _table_of(reader.execute(0, ctx))
    via_wire, _ = dp.fetch_partition_stream(
        "127.0.0.1", stream_server.port, path, SCHEMA, capacity=ctx.config.batch_size,
        policy=FAST, expected_checksum=crc, chunk_rows=7_000, compression="zstd",
        device=CPU)
    assert via_mmap.equals(_table_of(via_wire))


@pytest.mark.parametrize("how", ["other_host", "host_match_off"])
def test_the_wire_when_the_host_differs_or_host_match_is_off(partition, stream_server, how):
    path, nbytes, crc = partition
    kw = dict(host="127.0.0.1", port=stream_server.port, grpc_port=stream_server.port)
    if how == "other_host":
        reader, ctx = _reader_for(path, crc, nbytes, exec_host="node-a", **kw)
    else:
        reader, ctx = _reader_for(path, crc, nbytes, exec_host="127.0.0.1",
                                  conf={"ballista.shuffle.local.host_match": "false"}, **kw)
    assert _table_of(reader.execute(0, ctx)).equals(_reference(path))
    m = reader.metrics().to_dict()
    assert m.get("remote_fetches") == 1 and m.get("fetch_chunks", 0) >= 1
    assert "bytes_local_mmap" not in m


def test_stale_local_file_falls_back_to_the_fetch(partition, stream_server):
    path, nbytes, crc = partition
    kw = dict(host="127.0.0.1", exec_host="127.0.0.1", port=stream_server.port,
              grpc_port=stream_server.port)
    # a wrong recorded checksum: the mmap check rejects it, and so does the
    # fetch's own check: corruption is accepted on no path
    reader, ctx = _reader_for(path, crc ^ 0x1, nbytes, **kw)
    with pytest.raises(FetchFailedError):
        reader.execute(0, ctx)
    # a wrong recorded size: the mmap path rejects it, the fetch serves it
    reader, ctx = _reader_for(path, -1, nbytes + 1, **kw)
    assert _table_of(reader.execute(0, ctx)).equals(_reference(path))
    assert reader.metrics().to_dict().get("remote_fetches") == 1


def test_executor_identity_still_wins_over_host_match(partition):
    path, nbytes, crc = partition
    reader = ShuffleReaderExec(stage_id=1, schema=SCHEMA, partition_count=1, locations={
        0: [PartitionLocation("exec-a", 0, 0, path, num_rows=N_ROWS, num_bytes=nbytes,
                              host="node-a", port=9, checksum=crc)]})
    ctx = TaskContext(device=CPU, executor_id="exec-a", executor_host="node-a")
    assert sum(b.num_rows for b in reader.execute(0, ctx)) == N_ROWS
    assert "bytes_local_mmap" not in reader.metrics().to_dict()


def test_the_fetch_pool_is_process_shared():
    assert ShuffleReaderExec._fetch_pool() is ShuffleReaderExec._fetch_pool()


def test_max_concurrent_fetches_bounds_the_fetches(tmp_path, stream_server):
    locs = []
    for i in range(6):
        p = str(tmp_path / f"data-{i}.arrow")
        nb, c = _write_partition(p, n=2_000, seed=i)
        locs.append(PartitionLocation("producer-exec", i, 0, p, num_rows=2_000, num_bytes=nb,
                                      host="127.0.0.1", port=stream_server.port, checksum=c,
                                      grpc_port=stream_server.port))
    reader = ShuffleReaderExec(stage_id=1, schema=SCHEMA, partition_count=1,
                               locations={0: locs})
    ctx = TaskContext(device=CPU,
                      config=BallistaConfig({"ballista.shuffle.max_concurrent_fetches": "2"}),
                      executor_id="consumer-exec", executor_host="node-a")
    active, peak = [0], [0]
    lock = threading.Lock()
    orig = ShuffleReaderExec._fetch_remote

    def spy(self, loc, c):
        with lock:
            active[0] += 1
            peak[0] = max(peak[0], active[0])
        try:
            time.sleep(0.02)
            return orig(self, loc, c)
        finally:
            with lock:
                active[0] -= 1

    ShuffleReaderExec._fetch_remote = spy
    try:
        batches = reader.execute(0, ctx)
    finally:
        ShuffleReaderExec._fetch_remote = orig
    assert sum(b.num_rows for b in batches) == 6 * 2_000
    assert 2 >= peak[0] >= 1


def test_location_serde_tolerates_newer_and_older_peers():
    from arrow_ballista_tpu_torch import serde

    loc = PartitionLocation("e1", 2, 3, "/w/j/1/2/data-3.arrow", num_rows=10, num_bytes=999,
                            host="node-a", port=50051, checksum=123, grpc_port=50052,
                            format="arrow_file")
    obj = serde.location_to_obj(loc)
    assert serde.location_from_obj({**obj, "hypothetical_v9_field": {"x": 1}}) == loc
    old = {k: v for k, v in obj.items() if k not in ("grpc_port", "format")}
    got = serde.location_from_obj(old)
    assert got.grpc_port == 0 and got.format == ""


# --------------------------------------------------------------------------
# the native data plane
# --------------------------------------------------------------------------


def _build_and_serve(build_dir, out):
    """Child process: build the native data plane into ``build_dir`` and
    call it."""
    from pathlib import Path

    from arrow_ballista_tpu_torch import native

    native.BUILD_DIR = Path(build_dir)
    lib = native.dataplane()
    out.put((os.getpid(), None if lib is None else int(lib.dp_bytes_served()),
             str(native.dataplane_path())))


def test_two_processes_building_the_native_plane_both_load_a_whole_library(tmp_path):
    import shutil

    if shutil.which("g++") is None:
        pytest.skip("no g++: the executor serves through the Python RPC handler")
    native_dir = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                              "native")
    before = {f: os.stat(os.path.join(native_dir, "build", f)).st_mtime_ns
              for f in os.listdir(os.path.join(native_dir, "build"))}
    spawn = multiprocessing.get_context("spawn")
    out = spawn.Queue()
    procs = [spawn.Process(target=_build_and_serve, args=(str(tmp_path), out))
             for _ in range(2)]
    for p in procs:
        p.start()
    got = [out.get(timeout=240) for _ in procs]
    for p in procs:
        p.join(timeout=30)
        assert p.exitcode == 0
    assert [served for _pid, served, _path in got] == [0, 0]
    assert len({path for _pid, _served, path in got}) == 1
    assert os.listdir(tmp_path) == [os.path.basename(got[0][2])]  # no partial file left
    after = {f: os.stat(os.path.join(native_dir, "build", f)).st_mtime_ns
             for f in os.listdir(os.path.join(native_dir, "build"))}
    assert after == before, "the port wrote under native/"


def test_the_executor_serves_through_the_native_plane_or_the_rpc_handler(tmp_path):
    """One native server per process: the first executor of a process
    that builds it gets it, the next serves through the Python RPC
    handler; both answer a whole-file fetch of the same bytes."""
    from arrow_ballista_tpu_torch.executor.server import ExecutorServer
    from arrow_ballista_tpu_torch.scheduler.netservice import SchedulerNetService

    sched = SchedulerNetService("127.0.0.1", 0, device="cpu")
    sched.start()
    exs = [ExecutorServer("127.0.0.1", sched.port, work_dir=str(tmp_path / f"w{i}"),
                          device="cpu") for i in range(2)]
    try:
        for ex in exs:
            ex.start()
        planes = [ex.data_plane for ex in exs]
        assert planes[1] == "python" and planes[0] in ("native", "python")
        for ex in exs:
            path = os.path.join(ex.work_dir, "job", "1", "0", "data-0.arrow")
            os.makedirs(os.path.dirname(path))
            _nb, crc = _write_partition(path, n=3_000)
            batches = dp.fetch_partition_batches("127.0.0.1", ex.metadata.port, path, SCHEMA,
                                                 capacity=8192, policy=FAST,
                                                 expected_checksum=crc, device=CPU)
            assert _table_of(batches).equals(_reference(path))
            with pytest.raises(Exception, match="escapes the work dir|no such"):
                dp.fetch_partition_batches("127.0.0.1", ex.metadata.grpc_port, "/etc/passwd",
                                           SCHEMA, capacity=8192, policy=FAST, retries=1,
                                           device=CPU)
    finally:
        for ex in exs:
            ex.stop(notify=False)
        sched.stop()


def test_a_burst_of_connections_waits_for_no_dropped_syn(monkeypatch):
    """64 connections opened at once to one RPC server: every connect
    returns at once.  With socketserver's listen backlog of 5 (the
    reference's), the kernel drops SYNs of such a burst and each waits a
    second to be sent again, which a stage's reduce tasks opening their
    fetch streams together met as 1 s stalls."""
    from arrow_ballista_tpu_torch.net import wire

    srv = RpcServer("127.0.0.1", 0)
    srv.register("ping", lambda p, b: ({}, b""))
    srv.start()
    barrier = threading.Barrier(64)
    waits = []
    lock = threading.Lock()

    def dial():
        barrier.wait()
        t0 = time.perf_counter()
        sock = wire.connect("127.0.0.1", srv.port, timeout=5.0)
        with lock:
            waits.append(time.perf_counter() - t0)
        time.sleep(0.2)  # held open while the others connect
        sock.close()

    try:
        threads = [threading.Thread(target=dial) for _ in range(64)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    finally:
        srv.stop()
    assert len(waits) == 64 and max(waits) < 0.9, sorted(waits)[-5:]
