"""The port's executor Arrow Flight door: a stock ``pyarrow.flight``
client fetches a shuffle partition straight off an executor.  The
counterparts of tests/test_executor_flight.py: the raw-path and JSON
tickets give the reference's own decode of the file, a path outside the
work directory is refused, and a data-plane token is enforced."""
import json
import os

import numpy as np
import pyarrow as pa
import pyarrow.flight as fl
import pytest
import torch

from tests.torch_cases import remote_context

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    from arrow_ballista_tpu_torch.executor.server import ExecutorServer
    from arrow_ballista_tpu_torch.scheduler.netservice import SchedulerNetService
    from arrow_ballista_tpu_torch.utils.config import BallistaConfig

    sched = SchedulerNetService("127.0.0.1", 0,
                                config=BallistaConfig({"ballista.shuffle.partitions": "2"}),
                                device="cpu")
    sched.start()
    ex = ExecutorServer("127.0.0.1", sched.port, "127.0.0.1", 0,
                        work_dir=str(tmp_path_factory.mktemp("exec-flight")),
                        concurrent_tasks=2, executor_id="flight-dp-exec", flight_port=0,
                        device="cpu")
    ex.start()
    yield sched, ex
    ex.stop(notify=False)
    sched.stop()


def _one_shuffle_file(sched):
    jobs = sched.server.jobs.job_ids()
    graph = sched.server.jobs.get_graph(jobs[-1])
    for sid in sorted(graph.stages):
        for locs in graph.stages[sid].output_locations().values():
            for loc in locs:
                if loc.num_rows and os.path.exists(loc.path):
                    return loc.path
    raise AssertionError("no shuffle file found")


def test_stock_flight_client_fetches_partition(cluster):
    from arrow_ballista_tpu.models.ipc import read_ipc_files as jread
    from arrow_ballista_tpu.models.schema import INT64, Field, Schema

    sched, ex = cluster
    ctx = remote_context("torch", sched, {"ballista.shuffle.partitions": "2"})
    rng = np.random.default_rng(9)
    ctx.register_table("t", pa.table({
        "g": pa.array(rng.integers(0, 5, 5000).astype(np.int64)),
        "v": pa.array(rng.integers(0, 100, 5000).astype(np.int64))}))
    assert len(ctx.sql("select g, sum(v) as s from t group by g order by g").to_pandas()) == 5
    path = _one_shuffle_file(sched)
    client = fl.connect(f"grpc://127.0.0.1:{ex.flight.port}")
    table = client.do_get(fl.Ticket(path.encode())).read_all()
    assert table.num_rows > 0
    table2 = client.do_get(fl.Ticket(json.dumps({"path": path}).encode())).read_all()
    assert table2.equals(table)
    # the same bytes the reference reads: its decode of the file agrees
    with pa.memory_map(path) as src:
        assert pa.ipc.open_file(src).read_all().equals(table)
    names = table.schema.names
    jschema = Schema([Field(n, INT64) for n in names])
    want = pa.concat_tables([b.to_arrow() for b in jread([path], jschema)])
    assert want.column(0).to_pylist() == table.column(0).to_pylist()
    ctx.shutdown()


def test_traversal_guard(cluster):
    _, ex = cluster
    client = fl.connect(f"grpc://127.0.0.1:{ex.flight.port}")
    with pytest.raises(fl.FlightServerError):
        client.do_get(fl.Ticket(b"/etc/passwd")).read_all()


def test_token_auth(tmp_path):
    from arrow_ballista_tpu_torch.executor.flight_service import ExecutorFlightServer
    from arrow_ballista_tpu_torch.models.batch import ColumnBatch
    from arrow_ballista_tpu_torch.models.ipc import write_ipc_file
    from arrow_ballista_tpu_torch.models.schema import INT64, Field, Schema

    sch = Schema([Field("x", INT64)])
    b = ColumnBatch.from_numpy(sch, {"x": np.arange(10, dtype=np.int64)}, device="cpu")
    path = str(tmp_path / "part.arrow")
    write_ipc_file(b, path)
    srv = ExecutorFlightServer(str(tmp_path), token="sekrit")
    srv.start()
    try:
        client = fl.connect(f"grpc://127.0.0.1:{srv.port}")
        with pytest.raises(fl.FlightError):
            client.do_get(fl.Ticket(path.encode())).read_all()
        t = client.do_get(fl.Ticket(json.dumps({"path": path, "token": "sekrit"})
                                    .encode())).read_all()
        assert t.num_rows == 10
    finally:
        srv.stop()
