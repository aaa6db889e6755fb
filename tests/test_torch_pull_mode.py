"""Pull-mode scheduling in the port: executors poll the scheduler for work
(``SchedulerConfig(policy="pull")``, ``poll_work``), the counterparts of
tests/test_pull_mode.py, each held against the JAX package's pull-mode
cluster on the same tables."""
import numpy as np
import pyarrow as pa
import pytest
import torch

from tests.torch_cases import assert_frames_equal, remote_cluster, remote_context

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def clusters(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("pull"))
    with remote_cluster("torch", work, policy="pull") as (tsched, texs), \
            remote_cluster("jax", work, policy="pull") as (jsched, _):
        yield {"torch": (tsched, texs), "jax": (jsched, None)}


def test_pull_mode_query(clusters):
    rng = np.random.default_rng(5)
    n = 8000
    t = pa.table({"k": pa.array(rng.integers(0, 9, n).astype(np.int64)),
                  "v": pa.array(rng.integers(0, 100, n).astype(np.int64))})
    frames = {}
    for pkg in ("torch", "jax"):
        ctx = remote_context(pkg, clusters[pkg][0])
        ctx.register_table("t", t)
        frames[pkg] = ctx.sql("select k, sum(v) as s, count(*) as c from t "
                              "group by k order by k").to_pandas()
        ctx.shutdown()
    assert len(frames["torch"]) == 9 and int(frames["torch"].c.sum()) == n
    assert_frames_equal(frames["torch"], frames["jax"], exact=True)
    sched, executors = clusters["torch"]
    assert sched.server.config.policy == "pull"
    assert all(ex.policy == "pull" and ex._reporter_thread is None for ex in executors)


def test_pull_mode_consecutive_jobs(clusters):
    ctx = remote_context("torch", clusters["torch"][0])
    ctx.register_table("u", pa.table({"x": pa.array(range(100), type=pa.int64())}))
    for _ in range(3):
        assert int(ctx.sql("select sum(x) as s from u").to_pandas().s[0]) == 4950
    ctx.shutdown()


def test_poll_work_hands_out_pending_tasks_and_absorbs_statuses():
    """The scheduler alone: a poll with free slots gets the job's pending
    tasks, and a poll carrying their statuses completes the job."""
    import pyarrow as pa

    from arrow_ballista_tpu_torch.executor.executor import Executor
    from arrow_ballista_tpu_torch.ops.physical import MemoryScanExec
    from arrow_ballista_tpu_torch.scheduler.scheduler import (SchedulerConfig, SchedulerServer,
                                                              TaskLauncher)
    from arrow_ballista_tpu_torch.scheduler.types import ExecutorMetadata
    from arrow_ballista_tpu_torch.models.schema import INT64, Field, Schema

    import tempfile

    server = SchedulerServer(TaskLauncher(), SchedulerConfig(policy="pull"))
    server.init(start_reaper=False)
    try:
        meta = ExecutorMetadata("poller", task_slots=2)
        server.register_executor(meta)
        scan = MemoryScanExec(Schema([Field("x", INT64)]),
                              pa.table({"x": pa.array(range(10), type=pa.int64())}), 2)
        server.submit_job("pulljob", lambda: (scan, {}))
        tasks = []
        for _ in range(50):
            tasks = server.poll_work("poller", 2, [])
            if tasks:
                break
        assert len(tasks) == 2 and {t.task.partition for t in tasks} == {0, 1}
        assert server.poll_work("poller", 2, []) == []  # nothing left to hand out
        ex = Executor(meta, tempfile.mkdtemp(), device="cpu")
        statuses = [ex.run_task(t) for t in tasks]
        assert server.poll_work("poller", 2, statuses) == []
        assert server.wait_for_job("pulljob", timeout=10).state == "successful"
        ex.shutdown()
    finally:
        server.shutdown()
