"""Joins and the sort-path aggregate through both packages' local contexts
on the same generated tables (SF0.01, seed 0): the port on the CPU against
the JAX package.  TPC-H q3 and q4 (the slice's main path), q6 (a global
aggregate), q12 and q13, an anti join, a full outer join, a left join with
a residual filter, and q3 on the partitioned path and under a task budget
small enough to window the probe.

Frames must be equal: integers, decimals, dates and strings exact, floats
at rtol 1e-12.  Frames are sorted first only where the SQL has no ORDER BY.
"""
import pytest
import torch

import arrow_ballista_tpu as jab
import arrow_ballista_tpu_torch as tab
from benchmarks.datagen import generate_tables
from benchmarks.queries import QUERIES
from tests.torch_cases import JOIN_QUERIES, SETTINGS, UNORDERED, assert_frames_equal

# the suite runs in parallel worker processes: one core per worker for torch
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def tables():
    return generate_tables(0.01, seed=0)


def _contexts(tables, setting=None):
    jctx = jab.BallistaContext.local()
    tctx = tab.BallistaContext.local(device="cpu")
    for name, t in tables.items():
        jctx.register_table(name, t)
        tctx.register_table(name, t)
    if setting is not None:
        jctx.sql(setting)
        tctx.sql(setting)
    return jctx, tctx


@pytest.fixture(scope="module")
def contexts(tables):
    return _contexts(tables)


def _joins_of(plan):
    found = [plan] if type(plan).__name__ == "JoinExec" else []
    for c in plan.children():
        found.extend(_joins_of(c))
    return found


@pytest.mark.parametrize("name", list(JOIN_QUERIES))
def test_join_query_matches_reference(contexts, name):
    jctx, tctx = contexts
    sql = JOIN_QUERIES[name]
    want = jctx.sql(sql).to_pandas()
    got = tctx.sql(sql).to_pandas()
    assert len(want) > 0
    assert_frames_equal(got, want, ordered=name not in UNORDERED)


@pytest.mark.parametrize("setting", list(SETTINGS))
def test_q3_join_paths_match_reference(tables, setting):
    jctx, tctx = _contexts(tables, SETTINGS[setting])
    want = jctx.sql(QUERIES[3]).to_pandas()
    got = tctx.sql(QUERIES[3]).to_pandas()
    assert_frames_equal(got, want)
    joins = _joins_of(tctx.last_plan)
    if setting == "partitioned":
        assert [j.dist for j in joins] == ["partitioned", "partitioned"]
    else:
        assert any(j.metrics().to_dict().get("join_probe_chunks", 0) > 1 for j in joins)


def test_q3_groups_without_limit_match_reference(contexts):
    """Every group of q3's sort-path aggregate, not only the top 10."""
    jctx, tctx = contexts
    sql = QUERIES[3].split("order by")[0] + " order by l_orderkey"
    want = jctx.sql(sql).to_pandas()
    assert len(want) > 10
    assert_frames_equal(tctx.sql(sql).to_pandas(), want)


def test_global_aggregate_over_no_rows_yields_one_row(contexts):
    jctx, tctx = contexts
    sql = ("select count(*) as n, sum(l_quantity) as s, min(l_discount) as lo "
           "from lineitem where l_quantity < 0")
    want = jctx.sql(sql).to_pandas()
    got = tctx.sql(sql).to_pandas()
    assert len(got) == len(want) == 1
    assert int(got["n"][0]) == int(want["n"][0]) == 0
    assert got["s"].isna().all() and want["s"].isna().all()
    assert got["lo"].isna().all() and want["lo"].isna().all()


def test_each_query_gets_its_own_job_id(contexts, monkeypatch):
    """The broadcast build caches are keyed by the job id: each query gets
    a fresh one, and a job's caches are dropped when it ends."""
    from arrow_ballista_tpu_torch.ops import operators as O

    _, tctx = contexts
    seen = []
    register = O._register_build_cache
    monkeypatch.setattr(O, "_register_build_cache",
                        lambda job_id, op: (seen.append(job_id), register(job_id, op)))
    for _ in range(2):
        tctx.sql(QUERIES[4]).to_pandas()
        assert [j._build_cache for j in _joins_of(tctx.last_plan)] == [None]
    assert len(seen) == 2 and seen[0] != seen[1]
