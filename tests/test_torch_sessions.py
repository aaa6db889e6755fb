"""Per-session isolation on the port's scheduler service, and the wire
surface a client without the library uses.

The counterparts of tests/test_sessions.py, each held against the JAX
package's service where the answer can differ: two sessions see their own
tables and plan with their own ``ballista.shuffle.partitions``, a prepared
statement runs by its id, a removed session is refused, and the repo's
examples/external_sql_client.py (stdlib and pyarrow only) runs SQL
end to end against the port's service.
"""
import os
import time

import numpy as np
import pyarrow as pa
import pytest
import torch

from arrow_ballista_tpu_torch.net import wire
from tests.torch_cases import remote_cluster, remote_context

torch.set_num_threads(1)
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def clusters(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("sessions"))
    with remote_cluster("torch", work, executors=1) as (tsched, _), \
            remote_cluster("jax", work, executors=1) as (jsched, _):
        yield {"torch": tsched, "jax": jsched}


def test_session_table_isolation(clusters):
    a = remote_context("torch", clusters["torch"])
    b = remote_context("torch", clusters["torch"])
    a.register_table("mine", pa.table({"x": pa.array([1, 2, 3], type=pa.int64())}))
    assert "mine" in a.sql("show tables").to_pandas().table_name.tolist()
    assert "mine" not in b.sql("show tables").to_pandas().table_name.tolist()
    assert a.sql("select sum(x) as s from mine").to_pandas().s[0] == 6
    a.shutdown()
    b.shutdown()


@pytest.mark.parametrize("pkg", ["torch", "jax"])
def test_session_config_isolation(clusters, pkg):
    sched = clusters[pkg]
    a = remote_context(pkg, sched, {"ballista.shuffle.partitions": "2"})
    b = remote_context(pkg, sched, {"ballista.shuffle.partitions": "5"})
    rng = np.random.default_rng(5)
    t = pa.table({"g": pa.array(rng.integers(0, 40, 4000).astype(np.int64)),
                  "v": pa.array(np.ones(4000, dtype=np.int64))})
    a.register_table("t", t)
    b.register_table("t", t)
    sql = "select g, sum(v) as s from t group by g order by g"
    ga, gb = a.sql(sql).to_pandas(), b.sql(sql).to_pandas()
    assert ga.s.sum() == 4000 and gb.s.sum() == 4000 and ga.equals(gb)
    graphs = [sched.server.jobs.get_graph(j) for j in sched.server.jobs.job_ids()]
    parts = sorted({g.stages[2].planned_partitions
                    for g in graphs if g is not None and len(g.stages) >= 2})
    assert 2 in parts and 5 in parts, parts
    a.shutdown()
    b.shutdown()


def test_prepared_statements(clusters):
    port = clusters["torch"].port
    ctx = remote_context("torch", clusters["torch"])
    ctx.register_table("p", pa.table({"x": pa.array([5, 7], type=pa.int64())}))
    sid = ctx._remote.session_id
    prep, _ = wire.call("127.0.0.1", port, "prepare",
                        {"session_id": sid, "sql": "select sum(x) as s from p"})
    assert prep["schema"] == [{"name": "s", "dtype": {"kind": "int64", "scale": 0},
                               "nullable": prep["schema"][0]["nullable"]}]
    payload, _ = wire.call("127.0.0.1", port, "execute_query",
                           {"session_id": sid, "statement_id": prep["statement_id"]})
    deadline = time.time() + 30
    while time.time() < deadline:
        st, _ = wire.call("127.0.0.1", port, "get_job_status", {"job_id": payload["job_id"]})
        if st["state"] == "successful":
            break
        assert st["state"] not in ("failed", "cancelled"), st
        time.sleep(0.05)
    assert st["state"] == "successful"
    with pytest.raises(wire.RemoteError, match="unknown prepared statement"):
        wire.call("127.0.0.1", port, "execute_query",
                  {"session_id": sid, "statement_id": "stmt-nope"})
    ctx.shutdown()


def test_expired_session_rejected(clusters):
    port = clusters["torch"].port
    payload, _ = wire.call("127.0.0.1", port, "create_session", {})
    sid = payload["session_id"]
    wire.call("127.0.0.1", port, "remove_session", {"session_id": sid})
    with pytest.raises(wire.RemoteError, match="unknown or expired session"):
        wire.call("127.0.0.1", port, "list_tables", {"session_id": sid})


@pytest.mark.parametrize("pkg", ["torch", "jax"])
def test_external_client_script(clusters, tmp_path, pkg):
    """The examples/ client, written against the reference's wire, runs
    SQL through either package's service."""
    import subprocess
    import sys

    import pyarrow.parquet as pq

    data = tmp_path / "nums.parquet"
    pq.write_table(pa.table({"v": pa.array(range(100), type=pa.int64())}), str(data))
    out = subprocess.run(
        [sys.executable, "examples/external_sql_client.py", "127.0.0.1",
         str(clusters[pkg].port),
         f"create external table nums stored as parquet location '{data}'",
         "select count(*) as n, sum(v) as s from nums"],
        capture_output=True, text=True, timeout=120, cwd=REPO_ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "4950" in out.stdout and "100" in out.stdout
