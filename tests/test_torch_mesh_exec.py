"""The port's mesh operators (ops/mesh_exec.py) against the JAX package's.

Counterparts of the 14 cases of tests/test_mesh_exec.py and of
tests/test_nulls.py::test_mesh_join_null_keys_never_match: each runs the
same SQL over the same tables through the reference's mesh (its 8 virtual
CPU devices) and the port's (``use_local_devices`` with 1, 2, 4 and 8 CPU
ranks) and compares the rows: exact on integer, decimal and string
columns, rtol 1e-12 on floating averages.  The fused operators' own
outputs are compared row for row in rank order, not only sorted.

The hybrid exchange also runs through the port's network scheduler with
two executors (the mesh-fused partial tasks on both, their states crossing
executors through the data plane), and a plan holding a task-mesh join
round-trips the port's serde into the reference's encoding.
"""
import contextlib
import functools
from decimal import Decimal

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import arrow_ballista_tpu as jab
import arrow_ballista_tpu_torch as tab
from arrow_ballista_tpu.ops import mesh_exec as JM
from arrow_ballista_tpu.ops.physical import TaskContext as JTaskContext
from arrow_ballista_tpu.scheduler.physical_planner import PhysicalPlanner as JPlanner
from arrow_ballista_tpu.scheduler.planner import collect_nodes as j_collect
from arrow_ballista_tpu.sql.optimizer import optimize as j_optimize
from arrow_ballista_tpu_torch.ops import mesh_exec as TM
from arrow_ballista_tpu_torch.ops.physical import TaskContext as TTaskContext
from arrow_ballista_tpu_torch.parallel import use_local_devices
from arrow_ballista_tpu_torch.scheduler.physical_planner import PhysicalPlanner as TPlanner
from arrow_ballista_tpu_torch.scheduler.planner import collect_nodes as t_collect
from arrow_ballista_tpu_torch.sql.optimizer import optimize as t_optimize
from tests.torch_cases import assert_frames_equal

torch.set_num_threads(1)
CPU = torch.device("cpu")
RANKS = [1, 2, 4, 8]
MESH = {"ballista.shuffle.mesh": "true", "ballista.shuffle.mesh.min_rows": "0"}
HYBRID = {**MESH, "ballista.shuffle.mesh.hybrid": "true"}
BASE = {"ballista.shuffle.partitions": "4"}
JOIN_BASE = {**BASE, "ballista.join.broadcast_threshold": "0"}


@contextlib.contextmanager
def _ranks(n):
    with use_local_devices([CPU] * n):
        yield


def _contexts(settings, tables, standalone=False):
    """(reference context, port context) over the same tables."""
    if standalone:
        j = jab.BallistaContext.standalone(jab.BallistaConfig(settings), concurrent_tasks=4)
        t = tab.BallistaContext.standalone(tab.BallistaConfig(settings), concurrent_tasks=4,
                                           device="cpu")
    else:
        j = jab.BallistaContext.local(jab.BallistaConfig(settings))
        t = tab.BallistaContext.local(tab.BallistaConfig(settings), device="cpu")
    for ctx in (j, t):
        for name, table in tables.items():
            ctx.register_table(name, table)
    return j, t


def _plans(j, t, sql):
    jp = JPlanner(j.catalog, j.config).plan_query(j_optimize(j.sql(sql).logical)).plan
    tp = TPlanner(t.catalog, t.config, "cpu").plan_query(t_optimize(t.sql(sql).logical)).plan
    return jp, tp


@functools.lru_cache(maxsize=None)
def _reference(settings_items, table_key, sql, standalone=False):
    """The reference's rows, once per (settings, tables, query)."""
    ctx = jab.BallistaContext.standalone(jab.BallistaConfig(dict(settings_items)),
                                         concurrent_tasks=4) if standalone else \
        jab.BallistaContext.local(jab.BallistaConfig(dict(settings_items)))
    try:
        for name, table in TABLES[table_key]().items():
            ctx.register_table(name, table)
        return ctx.sql(sql).to_pandas()
    finally:
        ctx.shutdown()


def _port(settings, table_key, sql, n, standalone=False):
    if standalone:
        ctx = tab.BallistaContext.standalone(tab.BallistaConfig(settings), concurrent_tasks=4,
                                             device="cpu")
    else:
        ctx = tab.BallistaContext.local(tab.BallistaConfig(settings), device="cpu")
    try:
        for name, table in TABLES[table_key]().items():
            ctx.register_table(name, table)
        with _ranks(n):
            return ctx.sql(sql).to_pandas(), ctx
    finally:
        ctx.shutdown()


def _check(settings, table_key, sql, n, standalone=False):
    got, ctx = _port(settings, table_key, sql, n, standalone)
    want = _reference(tuple(sorted(settings.items())), table_key, sql, standalone)
    assert_frames_equal(got, want)
    return got, ctx


# --------------------------------------------------------------------------
# tables (the reference test's own)
# --------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _agg_table():
    rng = np.random.default_rng(11)
    n = 50_000
    return {"t": pa.table({
        "g": pa.array(rng.integers(0, 100, n).astype(np.int64)),
        "s": pa.array(rng.choice(["aa", "bb", "cc"], n)),
        "v": pa.array(rng.integers(-50, 100, n).astype(np.int64)),
        "w": pa.array(rng.integers(0, 10, n).astype(np.int32)),
    })}


@functools.lru_cache(maxsize=None)
def _nullable_table():
    rng = np.random.default_rng(7)
    n = 20_000
    v = rng.integers(-50, 100, n).astype(np.float64)
    g = rng.integers(0, 20, n)
    null_at = (rng.random(n) < 0.3) | (g == 0)  # group 0: every row NULL
    return {"t": pa.table({
        "g": pa.array(g.astype(np.int64)),
        "v": pa.array([None if m else int(x) for m, x in zip(null_at, v)], type=pa.int64()),
        "d": pa.array([None if m else Decimal(int(x)) / 4 for m, x in zip(null_at, v)],
                      type=pa.decimal128(12, 2)),
    })}


@functools.lru_cache(maxsize=None)
def _hybrid_nullable_table():
    rng = np.random.default_rng(5)
    n = 30_000
    g = rng.integers(0, 15, n)
    null_at = (rng.random(n) < 0.4) | (g == 3)
    return {"t": pa.table({
        "g": pa.array(g.astype(np.int64)),
        "v": pa.array([None if m else int(x) for m, x in zip(null_at, rng.integers(-9, 99, n))],
                      type=pa.int64()),
    })}


@functools.lru_cache(maxsize=None)
def _join_tables():
    rng = np.random.default_rng(23)
    n_fact, n_dim = 30_000, 2_000
    return {
        "fact": pa.table({
            "fk": pa.array(rng.integers(0, n_dim * 2, n_fact).astype(np.int64)),
            "val": pa.array(rng.integers(0, 1000, n_fact).astype(np.int64)),
            "tag": pa.array(rng.choice(["x", "y", "z"], n_fact)),
        }),
        "dim": pa.table({
            "dk": pa.array(np.arange(n_dim, dtype=np.int64)),
            "name": pa.array(rng.choice(["aa", "bb", "cc", "dd"], n_dim)),
            "weight": pa.array(rng.integers(1, 5, n_dim).astype(np.int64)),
        }),
    }


@functools.lru_cache(maxsize=None)
def _null_key_tables():
    return {
        "t": pa.table({"k": pa.array([1, 1, 2, 2, 3], type=pa.int64()),
                       "x": pa.array([10, None, 30, None, None], type=pa.int64())}),
        "u": pa.table({"x": pa.array([10, None, 77], type=pa.int64()),
                       "tag": pa.array(["ten", "null", "sevenseven"])}),
    }


WIDE = 34  # int64 columns past one K17 launch's 32 of a width


@functools.lru_cache(maxsize=None)
def _wide_tables():
    rng = np.random.default_rng(31)
    n_fact, n_dim = 4_000, 300
    fact = {"fk": rng.integers(0, n_dim * 2, n_fact).astype(np.int64)}
    fact.update({f"c{i}": rng.integers(-1000, 1000, n_fact).astype(np.int64)
                 for i in range(WIDE)})
    return {
        "fact": pa.table({k: pa.array(v) for k, v in fact.items()}),
        "dim": pa.table({"dk": pa.array(np.arange(n_dim, dtype=np.int64)),
                         "weight": pa.array(rng.integers(1, 5, n_dim).astype(np.int64))}),
    }


TABLES = {"agg": _agg_table, "nullable": _nullable_table, "hybrid_nullable": _hybrid_nullable_table,
          "join": _join_tables, "null_keys": _null_key_tables, "wide": _wide_tables}

QUERIES = [
    "select g, sum(v) as sv, count(*) as n, min(v) as lo, max(v) as hi "
    "from t group by g order by g",
    "select s, g, sum(w) as sw from t where v > 0 group by s, g order by s, g",
    "select s, avg(v) as a from t group by s order by s",
]

JOIN_QUERIES = [
    # inner equi-join + aggregate (the TPC-H q3 shape)
    "select name, sum(val) as sv, count(*) as n from fact "
    "join dim on fk = dk group by name order by name",
    # plain inner join, row-level output
    "select fk, val, name, weight from fact join dim on fk = dk "
    "order by fk, val, name, weight limit 500",
    # string keys
    "select tag, name, count(*) as n from fact join dim on tag = name "
    "group by tag, name order by tag, name",
]


def _join_settings(strategy):
    s = {**JOIN_BASE, **MESH}
    if strategy == "partitioned":  # both sides through the all_to_all exchange
        s["ballista.shuffle.mesh.broadcast_rows"] = "0"
    return s


# --------------------------------------------------------------------------
# the mesh aggregate
# --------------------------------------------------------------------------


@pytest.mark.parametrize("n", RANKS)
@pytest.mark.parametrize("q", range(len(QUERIES)))
def test_mesh_aggregate_matches_the_reference(q, n):
    _got, ctx = _check({**BASE, **MESH}, "agg", QUERIES[q], n)
    assert t_collect(ctx.last_plan, TM.MeshAggregateExec), ctx.last_plan.display()


@pytest.mark.parametrize("n", RANKS)
def test_mesh_standalone_cluster_matches_the_reference(n):
    _check({**BASE, **MESH}, "agg", "select g, sum(v) as sv from t group by g order by g", n,
           standalone=True)


@pytest.mark.parametrize("n", RANKS)
def test_mesh_nullable_operands_match_the_reference(n):
    sql = ("select g, sum(v) as sv, count(v) as cv, min(v) as lo, "
           "max(v) as hi, sum(d) as sd, count(*) as n "
           "from t group by g order by g")
    got, ctx = _check({**BASE, **MESH}, "nullable", sql, n)
    assert t_collect(ctx.last_plan, TM.MeshAggregateExec), ctx.last_plan.display()
    row0 = got[got.g == 0].iloc[0]  # all-NULL: sum/min/max NULL, count(v) 0
    assert np.isnan(row0.sv) and np.isnan(row0.lo) and np.isnan(row0.hi)
    assert row0.cv == 0 and row0.n > 0


# --------------------------------------------------------------------------
# the mesh joins
# --------------------------------------------------------------------------


@pytest.mark.parametrize("n", RANKS)
@pytest.mark.parametrize("strategy", ["partitioned", "broadcast"])
@pytest.mark.parametrize("q", range(len(JOIN_QUERIES)))
def test_mesh_join_matches_the_reference(q, strategy, n):
    _got, ctx = _check(_join_settings(strategy), "join", JOIN_QUERIES[q], n)
    assert t_collect(ctx.last_plan, TM.MeshJoinExec), ctx.last_plan.display()


@pytest.mark.parametrize("n", RANKS)
@pytest.mark.parametrize("strategy", ["partitioned", "broadcast"])
def test_mesh_semi_join_matches_the_reference(strategy, n):
    _check(_join_settings(strategy), "join",
           "select count(*) as n from fact where fk in (select dk from dim)", n)


def test_mesh_broadcast_join_metric_matches_the_reference():
    """The size gate routes the small build side through the all_gather
    variant, and the forced-partitioned config does not: the same
    ``broadcast_joins`` as the reference's."""
    for strategy, want_broadcast in (("broadcast", 1), ("partitioned", 0)):
        j, t = _contexts(_join_settings(strategy), _join_tables())
        jp, tp = _plans(j, t, JOIN_QUERIES[0])
        for p in range(jp.output_partition_count()):
            jp.execute(p, JTaskContext(j.config))
        with _ranks(8):
            for p in range(tp.output_partition_count()):
                tp.execute(p, TTaskContext(device=CPU, config=t.config))
        jv = j_collect(jp, JM.MeshJoinExec)[0].metrics().values.get("broadcast_joins", 0)
        tv = t_collect(tp, TM.MeshJoinExec)[0].metrics().values.get("broadcast_joins", 0)
        assert tv == jv == want_broadcast, (strategy, tv, jv)


@pytest.mark.parametrize("n", RANKS)
def test_mesh_join_null_keys_never_match_as_in_the_reference(n):
    got, _ctx = _check({**BASE, **MESH, "ballista.join.broadcast_threshold": "0"}, "null_keys",
                       "select t.k, u.tag from t join u on t.x = u.x", n)
    assert got.tag.tolist() == ["ten"]


_SUMS = ", ".join(f"sum(c{i}) as s{i}" for i in range(WIDE))
WIDE_QUERIES = {
    # the partial states (the key and 34 sums) cross the exchange
    "aggregate": f"select fk, {_SUMS} from fact group by fk order by fk",
    # the probe side (the key, its copy and 34 payload columns) crosses it
    "join": f"select weight, {_SUMS} from fact join dim on fk = dk "
            "group by weight order by weight",
}


@pytest.mark.parametrize("n", [2, 8])
@pytest.mark.parametrize("kind", list(WIDE_QUERIES))
def test_mesh_exchange_wider_than_one_dispatch_launch_matches_the_reference(kind, n,
                                                                           monkeypatch):
    """More than 32 columns of one width cross the exchange: the plan runs
    as the reference's does, and K17's wrapper splits such a dispatch
    into launches of at most 32 columns a width."""
    from arrow_ballista_tpu_torch.ops import kernels as TK

    widest = []
    dispatch = TK.dispatch_to_buckets

    def spy(cols, *args):
        widest.append(sum(c.dtype.itemsize == 8 for c in cols.values()))
        groups = TK._dispatch_groups(cols)
        assert sorted(sum(groups, [])) == sorted(cols)
        assert all(sum(cols[k].dtype.itemsize == w for k in g) <= 32
                   for g in groups for w in (8, 4, 1))
        return dispatch(cols, *args)

    monkeypatch.setattr(TK, "dispatch_to_buckets", spy)
    settings = _join_settings("partitioned") if kind == "join" else {**BASE, **MESH}
    _got, ctx = _check(settings, "wide", WIDE_QUERIES[kind], n)
    assert t_collect(ctx.last_plan, TM.MeshJoinExec if kind == "join" else TM.MeshAggregateExec)
    assert max(widest) > 32, widest


# --------------------------------------------------------------------------
# the fused operators' own rows, in rank order
# --------------------------------------------------------------------------


def _operator_rows(sql, settings, table_key, j_cls, t_cls, n):
    j, t = _contexts(settings, TABLES[table_key]())
    jp, tp = _plans(j, t, sql)
    jnode, tnode = j_collect(jp, j_cls)[0], t_collect(tp, t_cls)[0]
    (jb,) = jnode.execute(0, JTaskContext(j.config))
    with _ranks(n):
        (tb,) = tnode.execute(0, TTaskContext(device=CPU, config=t.config))
    assert tb.capacity == jb.capacity  # the same rank-major layout
    return tb.to_pandas(), jb.to_pandas()


@pytest.mark.parametrize("q", range(len(QUERIES)))
def test_mesh_aggregate_emits_the_references_rows_in_rank_order(q):
    got, want = _operator_rows(QUERIES[q], {**BASE, **MESH}, "agg", JM.MeshAggregateExec,
                               TM.MeshAggregateExec, 8)
    assert_frames_equal(got, want, exact=True)


@pytest.mark.parametrize("strategy", ["partitioned", "broadcast"])
@pytest.mark.parametrize("q", [0, 2])
def test_mesh_join_emits_the_references_rows_in_rank_order(q, strategy):
    got, want = _operator_rows(JOIN_QUERIES[q], _join_settings(strategy), "join",
                               JM.MeshJoinExec, TM.MeshJoinExec, 8)
    assert_frames_equal(got, want, exact=True)


# --------------------------------------------------------------------------
# the hybrid composition: the mesh within a task, the file shuffle between
# --------------------------------------------------------------------------


def test_mesh_hybrid_plan_shape_matches_the_reference():
    j, t = _contexts({**HYBRID, **BASE}, _agg_table())
    jp, tp = _plans(j, t, QUERIES[0])
    partials = t_collect(tp, TM.MeshPartialAggregateExec)
    assert partials and partials[0].output_partition_count() > 1, tp.display()
    assert tp.display() == jp.display()


@pytest.mark.parametrize("n", RANKS)
@pytest.mark.parametrize("q", range(len(QUERIES)))
def test_mesh_hybrid_matches_the_reference(q, n):
    _check({**HYBRID, **BASE}, "agg", QUERIES[q], n)


@pytest.mark.parametrize("n", RANKS)
def test_mesh_hybrid_nullable_operands_match_the_reference(n):
    sql = ("select g, sum(v) sv, count(v) cv, min(v) lo, max(v) hi "
           "from t group by g order by g")
    got, ctx = _check({**HYBRID, **BASE}, "hybrid_nullable", sql, n)
    assert t_collect(ctx.last_plan, TM.MeshPartialAggregateExec), ctx.last_plan.display()
    assert np.isnan(got[got.g == 3].sv.iloc[0]) and got[got.g == 3].cv.iloc[0] == 0


@pytest.mark.parametrize("n", RANKS)
@pytest.mark.parametrize("q", range(len(JOIN_QUERIES)))
def test_mesh_hybrid_join_matches_the_reference(q, n):
    _got, ctx = _check({**JOIN_BASE, **HYBRID}, "join", JOIN_QUERIES[q], n)
    assert t_collect(ctx.last_plan, TM.MeshTaskJoinExec), ctx.last_plan.display()


@pytest.mark.parametrize("n", RANKS)
def test_mesh_hybrid_join_through_standalone_cluster_matches_the_reference(n):
    _check({**JOIN_BASE, **HYBRID}, "join", JOIN_QUERIES[0], n, standalone=True)


def test_adaptive_transport_gate_matches_the_reference(tmp_path):
    """Mesh or file per exchange, from the row estimates: a 4000-row table
    stays on the file path under a high floor; min_rows 0 forces the
    mesh; a low floor lets the estimate clear the gate."""
    path = str(tmp_path / "t.parquet")
    pq.write_table(pa.table({"k": np.arange(4000, dtype=np.int64) % 50,
                             "v": np.arange(4000, dtype=np.int64)}), path, row_group_size=1000)

    def physical_plan(pkg, settings, **kw):
        ctx = pkg.BallistaContext.local(pkg.BallistaConfig(settings), **kw)
        ctx.register_parquet("t", path)
        df = ctx.sql("explain select k, sum(v) from t group by k").to_pandas()
        return df[df.plan_type == "physical_plan"].plan.iloc[0]

    for floor, meshed in (("1000000", False), ("0", True), ("100", True)):
        settings = {"ballista.shuffle.mesh": "true", "ballista.shuffle.partitions": "4",
                    "ballista.shuffle.mesh.min_rows": floor}
        got = physical_plan(tab, settings, device="cpu")
        assert got == physical_plan(jab, settings)
        assert ("MeshAggregate" in got) == meshed


@pytest.mark.parametrize("key, value", [("ballista.shuffle.mesh.hybrid", "true"),
                                        ("ballista.shuffle.mesh.broadcast_rows", "0"),
                                        ("ballista.shuffle.mesh.min_rows", "0"),
                                        ("ballista.agg.capacity", "2097152"),
                                        ("ballista.join.output_factor", "3")])
def test_the_mesh_keys_set_and_show_as_in_the_reference(key, value):
    """SET of each mesh key is accepted and SHOW reads it back as the
    reference's does; the defaults are the reference's."""
    j, t = _contexts({}, {})
    assert t.config.get(key) == j.config.get(key)
    for ctx in (j, t):
        ctx.sql(f"set {key} = {value}")
    assert t.sql(f"show {key}").to_pandas().equals(j.sql(f"show {key}").to_pandas())


@pytest.mark.parametrize("n", [1, 4])
def test_mesh_hybrid_through_network_scheduler_matches_the_reference(n, tmp_path):
    from tests.torch_cases import remote_cluster, remote_context

    settings = {**HYBRID, **BASE}
    with remote_cluster("torch", str(tmp_path), slots=2) as (sched, exs), _ranks(n):
        ctx = remote_context("torch", sched, settings)
        for name, table in _agg_table().items():
            ctx.register_table(name, table)
        got = ctx.sql(QUERIES[0]).to_pandas()
        graph = sched.server.jobs.get_graph(ctx._remote.last_job_id)
        ctx.shutdown()
    assert_frames_equal(got, _reference(tuple(sorted(settings.items())), "agg", QUERIES[0]))
    plans = [st.resolved_plan for st in graph.stages.values()]
    assert any(t_collect(p, TM.MeshPartialAggregateExec) for p in plans)
    ran_on = {t.executor_id for st in graph.stages.values() for t in st.task_infos if t}
    assert ran_on == {ex.metadata.executor_id for ex in exs}, ran_on


def test_mesh_task_join_serde_roundtrip_matches_the_reference():
    from arrow_ballista_tpu import serde as JS
    from arrow_ballista_tpu_torch import serde as TS

    j, t = _contexts({**JOIN_BASE, **HYBRID}, _join_tables())
    jp, tp = _plans(j, t, JOIN_QUERIES[0])
    obj = TS.plan_to_obj(tp)
    back = TS.plan_from_obj(obj)
    assert t_collect(back, TM.MeshTaskJoinExec)
    assert back.display() == tp.display() == jp.display()
    assert TS.plan_to_obj(back) == obj == JS.plan_to_obj(jp)
