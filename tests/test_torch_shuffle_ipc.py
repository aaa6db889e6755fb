"""The port's Arrow IPC shuffle files against the JAX package's (the port
on the CPU, JAX on the CPU).

A hash[4] ``ShuffleWriterExec`` of each package runs over the same
in-memory table (int64 keys with NULLs, dictionary strings, a decimal with
NULLs, a date, floats with NaN, an int64 column whose slices narrow to
int32 on the wire): both write byte-identical files (so the bucket of
every row is the same and ``crc32_file`` agrees), each package reads the
other's files into the same rows and dictionaries, and a single exchange
and a final stage are byte-identical too.  NULL strings: the reference's
writer fails on them (ROADMAP.md queue 3); the port writes them as NULL
indices, which both readers read back.
"""
import decimal
import os

import numpy as np
import pyarrow as pa
import pytest
import torch

from arrow_ballista_tpu.catalog import MemoryTable as JMemoryTable
from arrow_ballista_tpu.models import expr as JE
from arrow_ballista_tpu.models import ipc as JIPC
from arrow_ballista_tpu.ops import physical as JP
from arrow_ballista_tpu.ops import shuffle as JS
from arrow_ballista_tpu_torch.catalog import MemoryTable as TMemoryTable
from arrow_ballista_tpu_torch.models import expr as TE
from arrow_ballista_tpu_torch.models import ipc as TIPC
from arrow_ballista_tpu_torch.ops import physical as TP
from arrow_ballista_tpu_torch.ops import shuffle as TS

torch.set_num_threads(1)
N = 20_000
MAPS = 3


def _table(seed=0, null_strings=False):
    rng = np.random.default_rng(seed)
    k = rng.integers(-50, 400, N).astype(np.int64)
    k_null = rng.random(N) < 0.05
    names = np.array(["alpha", "beta", "gamma", "delta", "epsilon", "zeta"], dtype=object)
    s = names[rng.integers(0, len(names), N)]
    s_null = (rng.random(N) < 0.03) if null_strings else None
    f = rng.normal(size=N)
    f[rng.random(N) < 0.02] = np.nan
    return pa.table({
        "k": pa.array(k, mask=k_null),
        "s": pa.array(s, mask=s_null).dictionary_encode(),
        "price": pa.array([None if i % 97 == 0 else decimal.Decimal(int(v)).scaleb(-2)
                           for i, v in enumerate(rng.integers(-10**6, 10**6, N))],
                          type=pa.decimal128(12, 2)),
        "day": pa.array(rng.integers(8000, 10500, N).astype(np.int32), type=pa.date32()),
        "f": pa.array(f),
        "small": pa.array(rng.integers(-1000, 1000, N).astype(np.int64)),
        "big": pa.array(rng.integers(-2**62, 2**62, N, dtype=np.int64)),
    })


def _write(pkg, tmp, kind, stage_id=1, table=None):
    """Run the package's writer over every map partition of the table;
    returns {output partition: [paths]} and the writer."""
    table = _table() if table is None else table
    if pkg == "jax":
        scan = JMemoryTable("t", table).scan(None, [], MAPS)
        part = {"hash": JP.Partitioning.hash([JE.Column("s"), JE.Column("k")], 4),
                "single": JP.Partitioning.single(), "final": None}[kind]
        writer = JS.ShuffleWriterExec(scan, part, stage_id=stage_id)
        ctx = JP.TaskContext(work_dir=str(tmp / pkg), job_id="job")
    else:
        scan = TMemoryTable("t", table).scan(None, [], MAPS)
        part = {"hash": TP.Partitioning.hash([TE.Column("s"), TE.Column("k")], 4),
                "single": TP.Partitioning.single(), "final": None}[kind]
        writer = TS.ShuffleWriterExec(scan, part, stage_id=stage_id)
        ctx = TP.TaskContext(device=torch.device("cpu"), work_dir=str(tmp / pkg),
                             job_id="job")
    out = {}
    for m in range(MAPS):
        for w in writer.execute_write(m, ctx):
            assert w.checksum == (JIPC if pkg == "jax" else TIPC).crc32_file(w.path)
            out.setdefault(w.output_partition, []).append(w.path)
    return out, writer


def _rows(batches, schema):
    """Live rows of batches as sorted tuples, strings decoded."""
    rows = []
    for b in batches:
        data = b.compacted_numpy()
        cols = []
        for f in schema:
            v = np.asarray(data[f.name])
            if f.name in b.dicts:
                dic = np.asarray(b.dicts[f.name], dtype=object)
                v = np.array([dic[c] if c >= 0 else None for c in v], dtype=object)
            elif v.dtype.kind == "f":
                v = np.where(np.isnan(v), None, v.astype(object))  # NaN == NaN here
            cols.append(v.tolist())
        rows.extend(zip(*cols))
    return sorted(rows, key=repr)


@pytest.mark.parametrize("kind", ["hash", "single", "final"])
def test_writers_write_byte_identical_files(tmp_path, kind):
    jfiles, _ = _write("jax", tmp_path, kind)
    tfiles, _ = _write("torch", tmp_path, kind)
    assert sorted(jfiles) == sorted(tfiles)
    for q in jfiles:
        # a final stage writes one file a map task, its output partition
        assert len(jfiles[q]) == len(tfiles[q]) == (1 if kind == "final" else MAPS)
        for jp, tp in zip(sorted(jfiles[q]), sorted(tfiles[q])):
            assert os.path.relpath(jp, tmp_path / "jax") == os.path.relpath(tp, tmp_path / "torch")
            with open(jp, "rb") as a, open(tp, "rb") as b:
                assert a.read() == b.read(), (kind, q, jp)
            assert JIPC.crc32_file(jp) == TIPC.crc32_file(tp)


@pytest.mark.parametrize("direction", ["jax_writes_torch_reads", "torch_writes_jax_reads"])
def test_each_package_reads_the_others_files(tmp_path, direction):
    writer_pkg = "jax" if direction.startswith("jax") else "torch"
    files, writer = _write(writer_pkg, tmp_path, "hash")
    jschema = JMemoryTable("t", _table()).schema
    tschema = TMemoryTable("t", _table()).schema
    total = 0
    for q, paths in sorted(files.items()):
        jb = JIPC.read_ipc_files(paths, jschema, capacity=4096)
        tb = TIPC.read_ipc_files(paths, tschema, capacity=4096, device="cpu")
        # the same batch layout: capacities, codes, sorted dictionaries
        assert [b.capacity for b in jb] == [b.capacity for b in tb]
        for a, b in zip(jb, tb):
            for f in tschema:
                np.testing.assert_array_equal(np.asarray(a.columns[f.name]),
                                              b.columns[f.name].numpy())
                if f.name in a.dicts:
                    assert list(a.dicts[f.name]) == list(b.dicts[f.name])
            np.testing.assert_array_equal(np.asarray(a.mask), b.mask.numpy())
        rows = _rows(tb, tschema)
        assert rows == _rows(jb, jschema)
        total += len(rows)
    assert total == N


def test_reader_reads_one_partition_from_every_map_task(tmp_path):
    """ShuffleReaderExec over the writer's locations: the union of its
    partitions is the table, each row in the partition its bucket names."""
    files, writer = _write("torch", tmp_path, "hash")
    locs = {q: [TS.PartitionLocation("executor-0", m, q, p, num_rows=1)
                for m, p in enumerate(sorted(paths))] for q, paths in files.items()}
    reader = TS.ShuffleReaderExec(1, writer.schema, 4, locs)
    ctx = TP.TaskContext(device=torch.device("cpu"), executor_id="executor-0")
    got = []
    for q in range(4):
        got.extend(_rows(reader.execute(q, ctx), writer.schema))
    want = _rows(TMemoryTable("t", _table()).scan(None, [], 1).execute(0, ctx), writer.schema)
    assert sorted(got, key=repr) == want


def test_reader_refuses_a_remote_location(tmp_path):
    """A location on another host (``host`` / ``port`` of its executor's
    data plane), which the reader refused before the remote engine was
    ported, is fetched through the running data plane, streamed in chunks
    and as the whole file, into the rows the local read gives."""
    from arrow_ballista_tpu_torch.executor.server import ExecutorServer
    from arrow_ballista_tpu_torch.utils.config import BallistaConfig

    files, writer = _write("torch", tmp_path, "hash")
    server = ExecutorServer("127.0.0.1", 1, work_dir=str(tmp_path / "torch"),
                            executor_id="executor-9", device="cpu")
    server.start(register=False)
    try:
        for streaming, q in [(st, q) for st in ("true", "false") for q in sorted(files)]:
            paths = files[q]
            conf = BallistaConfig({"ballista.shuffle.wire.streaming": streaming})
            locs = [TS.PartitionLocation("executor-9", m, q, path, num_rows=1,
                                         host="127.0.0.1", port=server.metadata.port,
                                         grpc_port=server.metadata.grpc_port,
                                         checksum=TIPC.crc32_file(path))
                    for m, path in enumerate(sorted(paths))]
            remote = TS.ShuffleReaderExec(1, writer.schema, 4, {q: locs})
            ctx = TP.TaskContext(device=torch.device("cpu"), config=conf,
                                 executor_id="executor-0", executor_host="elsewhere")
            got = _rows(remote.execute(q, ctx), writer.schema)
            local = TS.ShuffleReaderExec(1, writer.schema, 4, {q: [
                TS.PartitionLocation("executor-0", m, q, path, num_rows=1)
                for m, path in enumerate(sorted(paths))]})
            want = _rows(local.execute(q, TP.TaskContext(device=torch.device("cpu"),
                                                         executor_id="executor-0")),
                         writer.schema)
            assert got == want and len(got) > 0
            assert remote.metrics().to_dict()["remote_fetches"] == len(locs)
    finally:
        server.stop(notify=False)


def test_null_strings_round_trip_through_the_ports_files(tmp_path):
    table = _table(null_strings=True)
    with pytest.raises(pa.ArrowIndexError):  # the reference's writer (ROADMAP.md queue 3)
        _write("jax", tmp_path, "hash", table=table)
    files, writer = _write("torch", tmp_path, "hash", table=table)
    jschema = JMemoryTable("t", table).schema
    ctx = TP.TaskContext(device=torch.device("cpu"))
    got, nulls = [], 0
    for q, paths in sorted(files.items()):
        rows = _rows(TIPC.read_ipc_files(paths, writer.schema, device="cpu"), writer.schema)
        assert rows == _rows(JIPC.read_ipc_files(paths, jschema), jschema)
        nulls += sum(r[1] is None for r in rows)
        got.extend(rows)
    assert nulls == table.column("s").null_count > 0
    want = _rows(TMemoryTable("t", table).scan(None, [], 1).execute(0, ctx), writer.schema)
    assert sorted(got, key=repr) == want


def test_writer_bucket_ids_are_bit_identical():
    """The writer's bucket program (the partition keys' compile_key
    closures, then bucket_of) gives every row the reference's bucket, dead
    rows included, for a string and an int64 key with NULLs."""
    from arrow_ballista_tpu.ops import kernels as JK
    from arrow_ballista_tpu.ops.expressions import ExprCompiler as JCompiler
    from arrow_ballista_tpu_torch.ops import kernels as TK
    from arrow_ballista_tpu_torch.ops.expressions import ExprCompiler as TCompiler

    table = _table()
    jscan = JMemoryTable("t", table).scan(None, [], MAPS)
    tscan = TMemoryTable("t", table).scan(None, [], MAPS)
    cpu = torch.device("cpu")
    for m in range(MAPS):
        for jb, tb in zip(jscan.execute(m, JP.TaskContext()),
                          tscan.execute(m, TP.TaskContext(device=cpu))):
            jc = JCompiler(jscan.schema, "device")
            tc = TCompiler(tscan.schema, "device", cpu)
            jkeys = [jc.compile_key(e) for e in (JE.Column("s"), JE.Column("k"))]
            tkeys = [tc.compile_key(e) for e in (TE.Column("s"), TE.Column("k"))]
            jaux, taux = jc.aux_arrays(jb.dicts), tc.aux_arrays(tb.dicts)
            want = np.asarray(JK.bucket_of([c.fn(jb.columns, jaux) for c in jkeys], 4))
            got = TK.bucket_of([c.fn(tb.columns, taux) for c in tkeys], 4).numpy()
            np.testing.assert_array_equal(got, want)
