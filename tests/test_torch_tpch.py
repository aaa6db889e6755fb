"""All 22 TPC-H queries through the port on the CPU, in both engines,
against a sqlite3 oracle over the same generated tables (SF0.01, seed 1,
as tests/test_tpch.py holds the JAX package): every row's content (numbers
at rtol 1e-6, as there) and the ORDER BY.  The local engine runs with four
shuffle partitions; the standalone engine with four partitions and four
task slots, where stages, shuffle files and fused chains run.

The memory sweep (the JAX package's tools/memory_sweep.py, on the port):
the 22 queries through the local engine with every join partitioned and a
host budget that denies every join build and aggregation state, each
equal bit for bit to the same settings with no budget, and to the sqlite
oracle; each query denies and spills, and leaves no reservation behind."""
import pandas as pd
import pytest
import torch

import arrow_ballista_tpu_torch as tab
from arrow_ballista_tpu_torch.memory import STATS
from benchmarks.queries import QUERIES
from tests.torch_cases import check_against_sqlite, sqlite_answer, sqlite_oracle

torch.set_num_threads(1)
SETTINGS = {"ballista.shuffle.partitions": "4"}
# partitioned joins (a broadcast build is exempt from the governor, as in
# the reference); 2 KiB is below every reservation at SF0.01
SWEEP_SETTINGS = {**SETTINGS, "ballista.join.broadcast_threshold": "0"}
SWEEP_BUDGET = {"ballista.memory.host.budget.bytes": "2048"}


@pytest.fixture(scope="module")
def data():
    from benchmarks.datagen import generate_tables

    return generate_tables(0.01, seed=1)


@pytest.fixture(scope="module")
def oracle(data):
    """The sqlite answer of each query, computed once for both engines."""
    conn = sqlite_oracle(data)
    answers = {}

    def answer(q):
        if q not in answers:
            answers[q] = sqlite_answer(conn, QUERIES[q])
        return answers[q]

    yield answer
    conn.close()


@pytest.fixture(scope="module")
def engines(data):
    local = tab.BallistaContext.local(tab.BallistaConfig(SETTINGS), device="cpu")
    sa = tab.BallistaContext.standalone(tab.BallistaConfig(SETTINGS), concurrent_tasks=4,
                                        device="cpu")
    for name, table in data.items():
        local.register_table(name, table)
        sa.register_table(name, table)
    yield {"local": local, "standalone": sa}
    sa.shutdown()


@pytest.mark.parametrize("q", sorted(QUERIES))
@pytest.mark.parametrize("engine", ["local", "standalone"])
def test_tpch_query_matches_sqlite(engines, oracle, engine, q):
    sql = QUERIES[q]
    check_against_sqlite(oracle(q), sql, engines[engine].sql(sql).to_pandas())


@pytest.fixture(scope="module")
def sweep(data):
    legs = {"unlimited": SWEEP_SETTINGS, "budget": {**SWEEP_SETTINGS, **SWEEP_BUDGET}}
    out = {}
    for leg, settings in legs.items():
        out[leg] = tab.BallistaContext.local(tab.BallistaConfig(settings), device="cpu")
        for name, table in data.items():
            out[leg].register_table(name, table)
    return out


@pytest.mark.parametrize("q", sorted(QUERIES))
def test_tpch_query_under_a_host_budget_equals_the_unlimited_run(sweep, oracle, q):
    sql = QUERIES[q]
    STATS.reset()
    got = sweep["budget"].sql(sql).to_pandas()
    snap = STATS.snapshot()
    assert snap.get("reserve_denied_total", 0) > 0 and snap.get("spill_runs_total", 0) > 0, snap
    assert snap["reserved_bytes.host"] == 0, "no reservation leaks"
    pd.testing.assert_frame_equal(got, sweep["unlimited"].sql(sql).to_pandas(), check_exact=True)
    check_against_sqlite(oracle(q), sql, got)
