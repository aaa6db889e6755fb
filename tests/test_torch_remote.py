"""The port's remote engine against the JAX package's: a scheduler service,
two executor servers with separate work directories and a remote session
of each package, side by side on 127.0.0.1, the same tables and SQL.

The counterparts of tests/test_remote.py (the aggregate, the join whose
shuffle crosses executors, remote against local, an external table and
SHOW, error propagation, EXPLAIN over the wire, the scheduler-driven
job-data cleanup) and of tests/test_formats.py's get_file_metadata RPC and
avro table through a remote context; then TPC-H q1, q3 and q18 at SF0.01
over parquet, and csv, json and avro tables registered through the
session, each equal to the reference's cluster.  The port's executors
exchange shuffle partitions both ways: through the co-located ``mmap``
path (the default host match; every executor advertises 127.0.0.1) and
through the wire (host match off: lz4 chunks through the data plane).
"""
import os
import time

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import arrow_ballista_tpu_torch as tab
from arrow_ballista_tpu_torch.net.dataplane import STATS
from benchmarks.queries import QUERIES
from tests.torch_cases import (assert_frames_equal, remote_cluster, remote_context)

torch.set_num_threads(1)
TPCH_TABLES = ("lineitem", "orders", "customer")
TPCH_SQL = {1: QUERIES[1], 3: QUERIES[3], 18: QUERIES[18].replace("> 300", "> 200")}


def _sales(n=10_000, seed=3):
    rng = np.random.default_rng(seed)
    return pa.table({"region": pa.array(rng.integers(0, 6, n).astype(np.int64)),
                     "amount": pa.array(rng.integers(1, 500, n).astype(np.int64)),
                     "item": pa.array(rng.integers(0, 50, n).astype(np.int64))})


def _items():
    return pa.table({"item": pa.array(np.arange(50, dtype=np.int64)),
                     "grp": pa.array((np.arange(50) % 7).astype(np.int64))})


@pytest.fixture(scope="module")
def tpch_dir(tmp_path_factory):
    from benchmarks.datagen import generate_tables
    from benchmarks.tpch import decimal_to_int64_storage

    d = tmp_path_factory.mktemp("tpch_remote")
    tables = generate_tables(0.01, seed=0)
    for name in TPCH_TABLES:
        pq.write_table(decimal_to_int64_storage(tables[name]), str(d / f"{name}.parquet"),
                       row_group_size=8192)
    return str(d)


@pytest.fixture(scope="module")
def clusters(tmp_path_factory, tpch_dir):
    """{pkg: (service, executors, session)} with the sales, items and
    TPC-H tables registered; the port's pair twice: 'torch' with the
    default host match (mmap), 'torch_wire' with it off."""
    work = str(tmp_path_factory.mktemp("remote"))
    out = {}
    import contextlib

    with contextlib.ExitStack() as stack:
        for key, pkg, exec_settings in (("jax", "jax", None), ("torch", "torch", None),
                                        ("torch_wire", "torch",
                                         {"ballista.shuffle.local.host_match": "false"})):
            sched, exs = stack.enter_context(remote_cluster(
                pkg, os.path.join(work, key), executor_settings=exec_settings))
            ctx = remote_context(pkg, sched)
            stack.callback(ctx.shutdown)
            ctx.register_table("sales", _sales())
            ctx.register_table("items", _items())
            for name in TPCH_TABLES:
                ctx.register_parquet(name, os.path.join(tpch_dir, f"{name}.parquet"))
            out[key] = (sched, exs, ctx)
        yield out


def _reader_metrics(cluster) -> dict:
    """The shuffle readers' fetch metrics of the session's last job, summed
    over its stages."""
    sched, _exs, ctx = cluster
    graph = sched.server.jobs.get_graph(ctx._remote.last_job_id)
    out = {"bytes_local_mmap": 0, "remote_fetches": 0, "wire_bytes": 0}
    for stage in graph.stages.values():
        for name, v in stage.aggregate_metrics().items():
            metric = name.rsplit(".", 1)[1]
            if "ShuffleReaderExec" in name and metric in out:
                out[metric] += v
    return out


def _both(clusters, sql, key="torch"):
    want = clusters["jax"][2].sql(sql).to_pandas()
    got = clusters[key][2].sql(sql).to_pandas()
    return got, want


def test_remote_aggregate(clusters):
    got, want = _both(clusters, "select region, sum(amount) as s, count(*) as n "
                                "from sales group by region order by region")
    assert len(got) == 6 and int(got.n.sum()) == 10_000
    assert_frames_equal(got, want, exact=True)


@pytest.mark.parametrize("key", ["torch", "torch_wire"])
def test_remote_join_and_shuffle_crosses_executors(clusters, key):
    """A join and a group-by whose shuffle partitions are read across the
    two executors: through the mmap path, or through the wire."""
    before = STATS.snapshot()
    sql = ("select grp, count(*) as n, sum(amount) as s from sales join items "
           "on sales.item = items.item where amount > 250 group by grp order by grp")
    got, want = _both(clusters, sql, key)
    assert len(got) == 7
    assert_frames_equal(got, want, exact=True)
    # the readers' own counts, folded from the executors' task statuses
    # (the process-wide STATS also counts this client's result fetch)
    reads = _reader_metrics(clusters[key])
    if key == "torch":
        assert reads["bytes_local_mmap"] > 0 and reads["remote_fetches"] == 0, reads
    else:
        assert reads["remote_fetches"] > 0 and reads["bytes_local_mmap"] == 0, reads
        assert reads["wire_bytes"] > 0 and STATS.snapshot()["wire_bytes"] > before["wire_bytes"]
    _sched, exs, _ctx = clusters[key]
    assert all(any(os.scandir(ex.work_dir)) for ex in exs), "expected tasks on every executor"


def test_remote_matches_local(clusters):
    sql = ("select region, min(amount) as lo, max(amount) as hi from sales "
           "group by region order by region")
    remote = clusters["torch"][2].sql(sql).to_pandas()
    local = tab.BallistaContext.local(device="cpu")
    local.register_table("sales", _sales())
    assert_frames_equal(remote, local.sql(sql).to_pandas(), exact=True)
    assert_frames_equal(remote, clusters["jax"][2].sql(sql).to_pandas(), exact=True)


def test_remote_external_table_and_show(clusters, tmp_path):
    path = str(tmp_path / "ext.parquet")
    pq.write_table(pa.table({"x": pa.array([1, 2, 3], type=pa.int64())}), path)
    for key in ("torch", "jax"):
        ctx = clusters[key][2]
        ctx.sql(f"create external table ext stored as parquet location '{path}'")
        assert int(ctx.sql("select sum(x) as s from ext").to_pandas().s[0]) == 6
    t = clusters["torch"][2]
    assert "ext" in t._remote.list_tables()
    tables = t.sql("show tables").to_pandas()
    assert tables.equals(clusters["jax"][2].sql("show tables").to_pandas())
    cols = t.sql("show columns from ext").to_pandas()
    assert cols["column_name"].tolist() == ["x"]


def test_remote_error_propagates(clusters):
    from arrow_ballista_tpu_torch.utils.errors import BallistaError

    with pytest.raises(BallistaError):
        clusters["torch"][2].sql("select nope from sales").to_pandas()


def test_explain_over_the_wire(clusters):
    sql = "EXPLAIN select region, sum(amount) s from sales group by region"
    got, want = _both(clusters, sql)
    assert got.plan_type.tolist() == want.plan_type.tolist() == ["logical_plan",
                                                                  "physical_plan"]
    assert got.plan.iloc[0] == want.plan.iloc[0]
    assert "HashAggregateExec" in got.plan.iloc[1]


def test_set_and_show_reach_the_session(clusters):
    ctx = clusters["torch"][2]
    ctx.sql("set ballista.shuffle.partitions = 3")
    try:
        assert ctx.sql("show ballista.shuffle.partitions").to_pandas()["value"].tolist() == ["3"]
        got = ctx.sql("select item, count(*) as n from sales group by item order by item")
        assert len(got.to_pandas()) == 50
    finally:
        ctx.sql("set ballista.shuffle.partitions = 4")


def test_watch_and_cancel_over_the_wire(clusters):
    ctx = clusters["torch"][2]
    ctx.sql("select count(*) as n from sales").to_pandas()
    frames = list(ctx.watch(timeout=30.0))
    assert frames[-1] == {"t": "end", "state": "successful", "error": ""}
    ctx.cancel()  # a finished job: a no-op
    with pytest.raises(NotImplementedError, match="queue 1 item 12 E"):
        ctx.forensics()
    with pytest.raises(NotImplementedError, match="queue 1 item 12 E"):
        ctx.explain_analyze("select count(*) from sales")


@pytest.mark.parametrize("key", ["torch", "torch_wire"])
@pytest.mark.parametrize("q", sorted(TPCH_SQL))
def test_tpch_over_parquet_matches_the_reference(clusters, q, key):
    got, want = _both(clusters, TPCH_SQL[q], key)
    assert len(got) > 0
    assert_frames_equal(got, want)


def test_csv_json_and_avro_tables_through_remote_sessions(clusters, tmp_path):
    import json

    import pyarrow.csv as pacsv

    from arrow_ballista_tpu_torch.utils import avro as tavro

    rng = np.random.default_rng(4)
    n = 600
    rows = [{"k": int(rng.integers(0, 7)), "v": float(rng.random()),
             "s": str(rng.choice(["x", "y", "z"]))} for _ in range(n)]
    frame = pd.DataFrame(rows)
    pacsv.write_csv(pa.Table.from_pandas(frame), str(tmp_path / "t.csv"))
    with open(tmp_path / "t.json", "w") as fh:
        for r in rows:
            fh.write(json.dumps(r) + "\n")
    tavro.write_avro(str(tmp_path / "t.avro"), {
        "type": "record", "name": "row",
        "fields": [{"name": "k", "type": "long"}, {"name": "v", "type": "double"},
                   {"name": "s", "type": "string"}]}, rows)
    sql = "select s, count(*) as c, sum(k) as sk, sum(v) as sv from {t} group by s order by s"
    for key in ("torch", "jax"):
        ctx = clusters[key][2]
        ctx.register_csv("t_csv", str(tmp_path / "t.csv"))
        ctx.register_json("t_json", str(tmp_path / "t.json"))
        ctx.register_avro("t_avro", str(tmp_path / "t.avro"))
    for t in ("t_csv", "t_json", "t_avro"):
        got, want = _both(clusters, sql.format(t=t))
        assert got["c"].tolist() == frame.groupby("s").size().tolist()
        assert_frames_equal(got, want)


def test_get_file_metadata_rpc(tmp_path):
    """The scheduler infers a file's format and schema, as the
    reference's does (tests/test_formats.py::test_get_file_metadata_rpc)."""
    from arrow_ballista_tpu.net import wire as jwire
    from arrow_ballista_tpu.scheduler.netservice import SchedulerNetService as JService
    from arrow_ballista_tpu_torch.net import wire
    from arrow_ballista_tpu_torch.scheduler.netservice import SchedulerNetService
    from arrow_ballista_tpu_torch.utils import avro as tavro

    pq.write_table(pa.table({"a": [1, 2], "b": ["x", "y"]}), str(tmp_path / "f.parquet"))
    tavro.write_avro(str(tmp_path / "f.avro"), {
        "type": "record", "name": "row",
        "fields": [{"name": "k", "type": "long"}, {"name": "v", "type": "double"}]},
        [{"k": i, "v": i / 2} for i in range(5)])
    with open(tmp_path / "f.json", "w") as fh:
        fh.write('{"a": 1, "b": "x"}\n')
    pacsv_path = tmp_path / "f.csv"
    pacsv_path.write_text("a,b\n1,x\n")
    tsched = SchedulerNetService("127.0.0.1", 0, device="cpu")
    jsched = JService("127.0.0.1", 0, rest_port=None)
    tsched.start()
    jsched.start()
    try:
        for name in ("f.parquet", "f.avro", "f.json", "f.csv"):
            req = {"path": str(tmp_path / name)}
            got, _ = wire.call("127.0.0.1", tsched.port, "get_file_metadata", req)
            want, _ = jwire.call("127.0.0.1", jsched.port, "get_file_metadata", req)
            assert got == want, name
        assert got["format"] == "csv"
    finally:
        tsched.stop()
        jsched.stop()


def test_avro_through_remote_context(tmp_path):
    from arrow_ballista_tpu_torch.utils import avro as tavro

    rng = np.random.default_rng(4)
    rows = [{"k": int(rng.integers(0, 7)), "flag": bool(rng.integers(0, 2))}
            for _ in range(800)]
    tavro.write_avro(str(tmp_path / "t.avro"), {
        "type": "record", "name": "row",
        "fields": [{"name": "k", "type": "long"}, {"name": "flag", "type": "boolean"}]}, rows)
    with remote_cluster("torch", str(tmp_path), executors=1) as (sched, _exs):
        ctx = remote_context("torch", sched)
        ctx.register_avro("t", str(tmp_path / "t.avro"))
        got = ctx.sql("SELECT COUNT(*) AS c FROM t WHERE flag").to_pandas()
        ctx.shutdown()
    assert got["c"].tolist() == [sum(1 for r in rows if r["flag"])]


def test_scheduler_driven_job_data_cleanup(tmp_path):
    """A finished job's shuffle directories are removed by the scheduler's
    delayed remove_job_data fan-out, well before the executor's janitor."""
    with remote_cluster("torch", str(tmp_path), executors=1, slots=2,
                        job_data_cleanup_delay_s=0.5) as (sched, exs):
        ctx = remote_context("torch", sched, {"ballista.shuffle.partitions": "2"})
        rng = np.random.default_rng(7)
        ctx.register_table("t", pa.table({
            "g": pa.array(rng.integers(0, 4, 2000).astype(np.int64)),
            "v": pa.array(rng.integers(0, 9, 2000).astype(np.int64))}))
        out = ctx.sql("select g, sum(v) s from t group by g order by g").to_pandas()
        assert len(out) == 4
        work = exs[0].work_dir
        deadline = time.monotonic() + 15
        leftovers = None
        while time.monotonic() < deadline:
            leftovers = [d for d in os.listdir(work) if os.path.isdir(os.path.join(work, d))]
            if not leftovers:
                break
            time.sleep(0.2)
        assert not leftovers, f"job dirs survived cleanup: {leftovers}"
        ctx.shutdown()


def test_the_janitor_removes_stale_job_data(tmp_path):
    """The executor's TTL janitor removes a job directory nobody runs."""
    with remote_cluster("torch", str(tmp_path), executors=1) as (_sched, exs):
        ex = exs[0]
        stale = os.path.join(ex.work_dir, "stalejob", "1", "0")
        os.makedirs(stale)
        with open(os.path.join(stale, "data-0.arrow"), "wb") as fh:
            fh.write(b"x")
        old = time.time() - 7200
        os.utime(os.path.join(stale, "data-0.arrow"), (old, old))
        for d in (stale, os.path.dirname(stale), os.path.join(ex.work_dir, "stalejob")):
            os.utime(d, (old, old))
        ex.job_data_ttl_s, ex.janitor_interval_s = 60.0, 0.1
        ex._stop.set()
        ex._janitor_thread.join(timeout=5)
        ex._stop.clear()
        import threading

        ex._janitor_thread = threading.Thread(target=ex._janitor_loop, daemon=True)
        ex._janitor_thread.start()
        deadline = time.monotonic() + 10
        while os.path.exists(os.path.join(ex.work_dir, "stalejob")) \
                and time.monotonic() < deadline:
            time.sleep(0.1)
        assert not os.path.exists(os.path.join(ex.work_dir, "stalejob"))


def test_remote_context_needs_the_card_unless_told_otherwise(clusters):
    sched = clusters["torch"][0]
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is the card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tab.BallistaContext.remote("127.0.0.1", sched.port)
    from arrow_ballista_tpu_torch.executor.server import ExecutorServer
    from arrow_ballista_tpu_torch.scheduler.netservice import SchedulerNetService

    with pytest.raises(RuntimeError, match="no CUDA device"):
        ExecutorServer("127.0.0.1", sched.port)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SchedulerNetService("127.0.0.1", 0)


def test_metrics_and_health_of_a_remote_executor(tmp_path):
    import json
    import urllib.request

    from arrow_ballista_tpu_torch.executor.server import ExecutorServer
    from arrow_ballista_tpu_torch.scheduler.netservice import SchedulerNetService

    sched = SchedulerNetService("127.0.0.1", 0, device="cpu")
    sched.start()
    ex = ExecutorServer("127.0.0.1", sched.port, work_dir=str(tmp_path), metrics_port=0,
                        device="cpu")
    ex.start()
    try:
        port = ex.obs_http.port
        body = urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=5).read()
        assert b'shuffle_bytes_fetched_total{path="remote"}' in body
        assert b"device_kernel_launches_total" in body
        health = json.loads(urllib.request.urlopen(f"http://127.0.0.1:{port}/health",
                                                   timeout=5).read())
        assert health["status"] == "ok" and health["executor_id"] == ex.metadata.executor_id
    finally:
        ex.stop(notify=False)
        sched.stop()


def test_heartbeats_re_register_and_reap_zombie_tasks():
    """A heartbeat from an executor the scheduler does not know carries
    its metadata and re-registers it (a restarted scheduler); one whose
    running set holds tasks of a finished or unknown job gets those
    cancelled again (a lost cancel), as in the reference's scheduler."""
    from arrow_ballista_tpu_torch.scheduler.scheduler import (SchedulerConfig, SchedulerServer,
                                                              TaskLauncher)
    from arrow_ballista_tpu_torch.scheduler.types import (ExecutorHeartbeat, ExecutorMetadata,
                                                          JobStatus)

    cancelled = []

    class Launcher(TaskLauncher):
        def cancel_tasks(self, executor_id, job_id):
            cancelled.append((executor_id, job_id))

    server = SchedulerServer(Launcher(), SchedulerConfig())
    server.init(start_reaper=False)
    try:
        meta = ExecutorMetadata("exec-x", host="10.0.0.9", port=7000, task_slots=3)
        server.heartbeat(ExecutorHeartbeat("exec-x", metadata=meta, status="terminating"))
        assert server.cluster.get_executor("exec-x") == meta
        assert "exec-x" not in server.cluster.alive_executors()  # still terminating
        server.jobs.accept_job("done-job")
        server.jobs.set_status(JobStatus("done-job", "successful"))
        server.jobs.accept_job("live-job")
        server.heartbeat(ExecutorHeartbeat("exec-x", running=[
            ("done-job", 1, 0, 0), ("live-job", 1, 0, 0), ("gone-job", 2, 1, 0)]))
        deadline = time.monotonic() + 5
        while len(cancelled) < 2 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert sorted(cancelled) == [("exec-x", "done-job"), ("exec-x", "gone-job")]
    finally:
        server.shutdown()
