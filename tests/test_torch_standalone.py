"""The port's standalone engine against the JAX package's (the port on the
CPU, JAX on the CPU), TPC-H at SF0.01 with four shuffle partitions and four
task slots.

For q1, q3, q4 and q18 over parquet, and q1 and q18 over in-memory tables:
the same rows (exact on integer, decimal, date and dictionary columns,
rtol 1e-12 on floating averages), the same stages with the same partition
counts, the same fused-chain labels per stage and the same fused operator
runs in the compile log; the same rows as the port's local engine; and the
same rows with whole-stage fusion off; EXPLAIN VERBOSE's stages.  Also:
the context needs the card unless told otherwise, the task threads count
kernel launches exactly, and a lost shuffle file re-runs its producer.
"""
import os
import sys
import threading

import pyarrow.parquet as pq
import pytest
import torch

import arrow_ballista_tpu as jab
import arrow_ballista_tpu_torch as tab
from arrow_ballista_tpu.utils.config import BallistaConfig as JConfig
from arrow_ballista_tpu_torch.ops import kernels as TK
from arrow_ballista_tpu_torch.utils.config import BallistaConfig as TConfig
from tests.torch_cases import (STANDALONE_CASES, STANDALONE_SETTINGS, STANDALONE_SQL,
                               assert_frames_equal, fused_labels, stage_summary)

torch.set_num_threads(1)
TABLES = ("lineitem", "orders", "customer")


@pytest.fixture(scope="module")
def tpch(tmp_path_factory):
    from benchmarks.datagen import generate_tables
    from benchmarks.tpch import decimal_to_int64_storage

    d = tmp_path_factory.mktemp("tpch_sa")
    tables = generate_tables(0.01, seed=0)
    for name in TABLES:
        pq.write_table(decimal_to_int64_storage(tables[name]), str(d / f"{name}.parquet"),
                       row_group_size=8192)
    return tables, str(d)


def _register(ctx, tpch, source):
    tables, d = tpch
    for name in TABLES:
        if source == "pq":
            ctx.register_parquet(name, os.path.join(d, f"{name}.parquet"))
        else:
            ctx.register_table(name, tables[name])


@pytest.fixture(scope="module")
def contexts(tpch):
    """One standalone context per package and source, shut down at the end."""
    made = {}

    def get(pkg, source, **settings):
        key = (pkg, source, tuple(sorted(settings.items())))
        if key not in made:
            conf = {**STANDALONE_SETTINGS, **settings}
            if pkg == "jax":
                ctx = jab.BallistaContext.standalone(JConfig(conf), concurrent_tasks=4)
            else:
                ctx = tab.BallistaContext.standalone(TConfig(conf), concurrent_tasks=4,
                                                     device="cpu")
            _register(ctx, tpch, source)
            made[key] = ctx
        return made[key]

    yield get
    for ctx in made.values():
        ctx.shutdown()


def _run(ctx, sql):
    frame = ctx.sql(sql).to_pandas()
    graph = ctx._standalone.scheduler.jobs.get_graph(ctx._standalone.last_job_id)
    return frame, graph


@pytest.mark.parametrize("source,query", STANDALONE_CASES)
def test_standalone_matches_the_reference(contexts, source, query):
    sql = STANDALONE_SQL[query]
    want, jgraph = _run(contexts("jax", source), sql)
    got, tgraph = _run(contexts("torch", source), sql)
    assert len(got) > 0
    assert_frames_equal(got, want)
    assert stage_summary(tgraph) == stage_summary(jgraph)
    assert fused_labels(tgraph) == fused_labels(jgraph)
    assert [r["fused_ops"] for r in tgraph.compile_log] == \
        [r["fused_ops"] for r in jgraph.compile_log]


@pytest.mark.parametrize("source,query", STANDALONE_CASES)
def test_standalone_matches_the_local_engine(contexts, tpch, source, query):
    sql = STANDALONE_SQL[query]
    got, _ = _run(contexts("torch", source), sql)
    local = tab.BallistaContext.local(TConfig(STANDALONE_SETTINGS), device="cpu")
    _register(local, tpch, source)
    assert_frames_equal(got, local.sql(sql).to_pandas())


@pytest.mark.parametrize("source,query", [("pq", "q1"), ("pq", "q18"), ("mem", "q18")])
def test_fusion_off_gives_the_same_rows(contexts, source, query):
    sql = STANDALONE_SQL[query]
    fused, graph = _run(contexts("torch", source), sql)
    plain, plain_graph = _run(contexts("torch", source, **{"ballista.compile.enabled": "false"}),
                              sql)
    assert any(fused_labels(graph).values())
    assert not any(fused_labels(plain_graph).values()) and not plain_graph.compile_log
    assert_frames_equal(fused, plain)


def test_standalone_runs_on_the_card_unless_told_otherwise():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is the card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tab.BallistaContext.standalone()


def test_launch_counts_are_exact_across_task_threads():
    """More threads than cores and a short switch interval: a lost update
    of an unlocked read-modify-write would show in the total."""
    barrier = threading.Barrier(16)

    def bump():
        barrier.wait()
        for _ in range(5000):
            TK.count_launch("fused_agg")

    TK.reset_launch_counts()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=bump) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert TK.LAUNCHES["fused_agg"] == 80_000


def test_q1_twice_on_four_task_threads_same_rows_and_launch_totals(contexts, monkeypatch):
    """The wrappers' launch counting under four concurrent task slots: each
    twin counts as its kernel would (on the CPU no kernel launches), and two
    runs of q1 give the same rows and the same totals."""
    from arrow_ballista_tpu_torch.compile import fused as F

    def counting(name, fn):
        def wrapper(*args, **kwargs):
            TK.count_launch(name)
            return fn(*args, **kwargs)
        return wrapper

    for name in ("compaction_order", "sort_order", "dense_group_states"):
        monkeypatch.setattr(TK, name, counting(name, getattr(TK, name)))
    monkeypatch.setattr(TK, "bucket_of", counting("hash64", TK.bucket_of))
    monkeypatch.setattr(F, "fused_agg", counting("fused_agg", F.fused_agg))
    ctx = contexts("torch", "mem")
    runs = []
    for _ in range(2):
        TK.reset_launch_counts()
        frame, _ = _run(ctx, STANDALONE_SQL["q1"])
        runs.append((frame, dict(TK.LAUNCHES)))
    assert_frames_equal(runs[0][0], runs[1][0])
    assert runs[0][1] == runs[1][1]
    assert runs[0][1]["fused_agg"] == 4 and runs[0][1]["hash64"] == 4


def test_a_lost_shuffle_file_reruns_its_producer(contexts, monkeypatch):
    """A reader that finds a map output missing fails with a fetch failure;
    the graph rolls the reader back, re-runs the producer's partition and
    the job still returns the same rows."""
    from arrow_ballista_tpu_torch.ops import shuffle as S

    ctx = contexts("torch", "mem")
    want, _ = _run(ctx, STANDALONE_SQL["q1"])
    real = S.ShuffleReaderExec._execute
    lost = []

    def lose_once(self, partition, tctx):
        if not lost:
            locs = [loc for loc in self.locations.get(partition, []) if loc.num_rows]
            os.remove(locs[0].path)
            lost.append(locs[0].path)
        return real(self, partition, tctx)

    monkeypatch.setattr(S.ShuffleReaderExec, "_execute", lose_once)
    got, graph = _run(ctx, STANDALONE_SQL["q1"])
    assert lost
    assert_frames_equal(got, want)
    assert any(s.stage_attempt > 0 for s in graph.stages.values())


@pytest.mark.parametrize("source", ["pq", "mem"])
def test_explain_verbose_shows_the_reference_stages(contexts, source):
    """EXPLAIN VERBOSE adds the distributed stage decomposition, as the
    reference prints it."""
    sql = "explain verbose " + STANDALONE_SQL["q18"]
    want = contexts("jax", source).sql(sql).to_pandas()
    got = contexts("torch", source).sql(sql).to_pandas()
    assert list(got["plan_type"]) == ["logical_plan", "physical_plan", "distributed_plan"]
    assert list(got["plan_type"]) == list(want["plan_type"])
    assert got["plan"].iloc[2] == want["plan"].iloc[2]
    assert got["plan"].iloc[2].count("Stage ") >= 5
