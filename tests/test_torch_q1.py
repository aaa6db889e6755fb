"""TPC-H q1 (and a few queries of the same operator set) through both
packages' local contexts on the same generated tables (SF0.01, seed 0):
the port on the CPU against the JAX package."""
import numpy as np
import pandas as pd
import pytest
import torch

import arrow_ballista_tpu as jab
import arrow_ballista_tpu_torch as tab
from benchmarks.datagen import generate_tables
from benchmarks.queries import QUERIES

# the suite runs in parallel worker processes: one core per worker for torch
torch.set_num_threads(1)

# queries whose plans stay inside the port's operator set (dense grouping
# over dictionary-coded keys, filters, host projections, sort, limit)
SLICE_QUERIES = {
    "q1": QUERIES[1],
    "shipmode_desc_limit": """
        select l_shipmode, count(*) as c, min(l_quantity) as lo_qty,
               max(l_discount) as hi_disc, sum(l_tax) as tax
        from lineitem where l_quantity > 10
        group by l_shipmode order by c desc, l_shipmode limit 3""",
    "having_two_keys": """
        select l_returnflag, l_shipinstruct, sum(l_extendedprice * l_discount) as rev,
               avg(l_quantity) as aq
        from lineitem where l_shipdate < date '1996-01-01'
        group by l_returnflag, l_shipinstruct having count(*) > 100
        order by l_returnflag desc, l_shipinstruct""",
    "orders_priority": """
        select o_orderpriority, o_orderstatus, count(*) as n, max(o_totalprice) as top
        from orders group by o_orderpriority, o_orderstatus
        order by o_orderpriority, o_orderstatus""",
}


@pytest.fixture(scope="module")
def contexts():
    tables = generate_tables(0.01, seed=0)
    jctx = jab.BallistaContext.local()
    tctx = tab.BallistaContext.local(device="cpu")
    for name, t in tables.items():
        jctx.register_table(name, t)
        tctx.register_table(name, t)
    return jctx, tctx


def _assert_frames(got: pd.DataFrame, want: pd.DataFrame):
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want)
    for c in want.columns:
        g, w = got[c].to_numpy(), want[c].to_numpy()
        if c.startswith("avg") or c in ("aq",):
            np.testing.assert_allclose(g.astype(float), w.astype(float), rtol=1e-12)
        else:
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("name", list(SLICE_QUERIES))
def test_query_matches_reference(contexts, name):
    jctx, tctx = contexts
    sql = SLICE_QUERIES[name]
    _assert_frames(tctx.sql(sql).to_pandas(), jctx.sql(sql).to_pandas())


def test_q1_raw_states_match_reference(contexts):
    """Decimal sums compared as the scaled int64 the engines hold."""
    jctx, tctx = contexts
    jb = [b for b in jctx.sql(QUERIES[1]).collect() if b.num_rows]
    tb = [b for b in tctx.sql(QUERIES[1]).collect() if b.num_rows]
    assert len(jb) == len(tb) == 1
    jd, td = jb[0].compacted_numpy(), tb[0].compacted_numpy()
    assert set(jd) == set(td)
    for k in jd:
        if jd[k].dtype.kind == "f":
            np.testing.assert_allclose(td[k], jd[k], rtol=1e-12)
        else:
            assert td[k].dtype == jd[k].dtype
            np.testing.assert_array_equal(td[k], jd[k])
    def fields(b):
        return [(f.name, f.dtype.kind, f.dtype.scale, f.nullable) for f in b.schema]

    assert fields(tb[0]) == fields(jb[0])


@pytest.mark.parametrize("name", ["q1", "shipmode_desc_limit", "q3", "q4"])
def test_explain_plans_are_the_same_operator_tree(contexts, name):
    """The same operators, down to each join's type, distribution
    (broadcast or partitioned) and ``on`` pairs."""
    jctx, tctx = contexts
    sql = "EXPLAIN " + {**SLICE_QUERIES, "q3": QUERIES[3], "q4": QUERIES[4]}[name]
    jrows = jctx.sql(sql).to_pandas()
    trows = tctx.sql(sql).to_pandas()
    assert list(trows["plan_type"]) == list(jrows["plan_type"])
    assert list(trows["plan"]) == list(jrows["plan"])


def test_set_and_show_settings(contexts):
    _, tctx = contexts
    tctx.sql("set ballista.shuffle.partitions = 4")
    try:
        df = tctx.sql("show ballista.shuffle.partitions").to_pandas()
        assert df["value"].tolist() == ["4"]
    finally:
        tctx.sql("set ballista.shuffle.partitions = 16")


@pytest.mark.parametrize("setting, sql, item", [
    # cancelling a job from a session waits for the remote engine's cancel
    # fan-out (EXPLAIN ANALYZE, which raised here before, is held against
    # the reference in tests/test_torch_explain_analyze.py; the mesh in
    # tests/test_torch_mesh_exec.py)
    (None, lambda ctx: ctx.cancel(), "queue 1 item 12 C"),
    # the csv, json and avro scans, which raised here before, are held
    # against the reference in tests/test_torch_formats.py, and their
    # registration with a remote scheduler in tests/test_torch_remote.py; a
    # fleet of schedulers waits for the fleet
    (None, lambda ctx: type(ctx).remote(endpoints=[("127.0.0.1", 50050),
                                                   ("127.0.0.1", 50051)], device="cpu"),
     "queue 1 item 12 C"),
])
def test_unported_paths_raise_naming_their_roadmap_item(contexts, setting, sql, item):
    """q6 and q3, which raised here before joins and the sort-path
    aggregate were ported, are held against the reference in
    tests/test_torch_joins.py.  ``sql`` is a statement, or a call on the
    context."""
    _, tctx = contexts
    if setting is not None:
        tctx.sql(f"set {setting} = true")
    try:
        with pytest.raises(NotImplementedError, match=item):
            sql(tctx) if callable(sql) else tctx.sql(sql).to_pandas()
    finally:
        if setting is not None:
            tctx.sql(f"set {setting} = false")


@pytest.mark.parametrize("key", ["ballista.memory.device.budget.bytes",
                                 "ballista.speculation.enabled",
                                 "ballista.executor.task_slots"])
def test_set_of_a_key_the_port_does_not_read_raises(contexts, key):
    from arrow_ballista_tpu_torch.utils.errors import ConfigurationError

    _, tctx = contexts
    with pytest.raises(ConfigurationError, match="unknown configuration key"):
        tctx.sql(f"set {key} = 0")
    with pytest.raises(ConfigurationError):
        tctx.sql(f"show {key}")


def test_port_config_carries_the_reference_values_of_its_keys():
    """Every key the port reads exists in the reference with the same
    default, and the reference's ``to_dict()`` values carry across."""
    jcfg = jab.BallistaConfig({"ballista.shuffle.partitions": "auto",
                               "ballista.batch.size": 4096})
    tdefaults = tab.BallistaConfig().to_dict()
    jdefaults = jab.BallistaConfig().to_dict()
    assert {k: jdefaults[k] for k in tdefaults} == tdefaults
    jd = jcfg.to_dict()
    tcfg = tab.BallistaConfig({k: jd[k] for k in tdefaults})
    assert tcfg.to_dict() == {k: jd[k] for k in tdefaults}
    assert tcfg.shuffle_partitions == 0 and tcfg.batch_size == 4096
