"""The port's parquet scan and device-resident scan cache against the JAX
package, on the same files (the port on the CPU, JAX on the CPU).

Mirrors tests/test_parquet_scan.py case by case (pruning by range and by
string statistics, pruning never changes results, an empty result after
pruning, int64-stored decimals equal to decimal128, the pipelined cold
scan equal to the plain one), adds CREATE EXTERNAL TABLE, and the scan
cache: a second scan hits, filters apply on top of cached batches, a
rewritten file invalidates its entries, LRU eviction, ``0`` disables it,
``'auto'`` is keyed on the device, and no query writes into a cached
tensor (TPC-H q1, q3, q4 and q18 at SF0.01).

Frames must be equal: integers, decimals, dates and strings exact, floats
at rtol 1e-12.
"""
import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import arrow_ballista_tpu as jab
import arrow_ballista_tpu_torch as tab
from arrow_ballista_tpu.catalog import ParquetTable as JParquetTable
from arrow_ballista_tpu.models import expr as JE
from arrow_ballista_tpu_torch.catalog import ParquetTable as TParquetTable
from arrow_ballista_tpu_torch.models import expr as TE
from arrow_ballista_tpu_torch.ops.physical import TaskContext
from arrow_ballista_tpu_torch.utils import table_cache
from arrow_ballista_tpu_torch.utils.config import BallistaConfig
from benchmarks.datagen import generate_tables
from benchmarks.queries import QUERIES
from benchmarks.tpch import decimal_to_int64_storage
from tests.torch_cases import assert_frames_equal

# the suite runs in parallel worker processes: one core per worker for torch
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def sorted_parquet(tmp_path_factory):
    # x ascending across row groups: min/max statistics prune range predicates
    path = str(tmp_path_factory.mktemp("rg") / "t.parquet")
    n = 10_000
    t = pa.table({
        "x": pa.array(np.arange(n, dtype=np.int64)),
        "y": pa.array(np.arange(n, dtype=np.float64) * 0.5),
        "s": pa.array(np.where(np.arange(n) < 5000, "low", "high")),
    })
    pq.write_table(t, path, row_group_size=1000)  # 10 row groups
    return path


@pytest.fixture(scope="module")
def tpch_dir(tmp_path_factory):
    """TPC-H SF0.01 as the benchmark writes it: one file per table,
    decimals in int64 storage, lineitem in 8 row groups of 8,192 rows."""
    d = tmp_path_factory.mktemp("tpch")
    for name, t in generate_tables(0.01, seed=0).items():
        pq.write_table(decimal_to_int64_storage(t), str(d / f"{name}.parquet"),
                       row_group_size=8192)
    return str(d)


def _contexts(path, name="t", config=None):
    jctx = jab.BallistaContext.local()
    tctx = tab.BallistaContext.local(config, device="cpu")
    jctx.register_parquet(name, path)
    tctx.register_parquet(name, path)
    return jctx, tctx


def _same_sql(jctx, tctx, sql, ordered=True):
    want = jctx.sql(sql).to_pandas()
    got = tctx.sql(sql).to_pandas()
    assert_frames_equal(got, want, ordered=ordered)
    return got


def _scans(path, filters, partitions):
    """The same scan from both packages' providers."""
    def lit(M, e):
        return [M.BinOp(op, M.Column(c), M.Lit(v)) for op, c, v in e]

    j = JParquetTable("t", path).scan(None, lit(JE, filters), partitions)
    t = TParquetTable("t", path).scan(None, lit(TE, filters), partitions)
    return j, t


def test_single_file_scans_in_parallel(sorted_parquet):
    j, t = _scans(sorted_parquet, [], 8)
    assert t.output_partition_count() == j.output_partition_count() == 8
    assert t.groups == j.groups
    assert t.row_count_estimate() == j.row_count_estimate() == 10_000


@pytest.mark.parametrize("filters, pruned", [
    ([("<", "x", 2500)], 7),              # keeps row groups [0..2500): 3 of 10
    ([("<", "x", -1)], 10),               # everything: one empty partition
    ([(">=", "x", 9995)], 9),
    ([("=", "s", "high")], 5),            # string statistics: min=max='low' refutes
    ([(">", "y", 4000.0), ("<", "x", 9000)], 9),  # y > 4000 means x > 8000
])
def test_row_group_pruning_matches_reference(sorted_parquet, filters, pruned):
    j, t = _scans(sorted_parquet, filters, 8)
    assert t.pruned_row_groups == j.pruned_row_groups == pruned
    assert t.groups == j.groups
    assert t.row_count_estimate() == j.row_count_estimate()
    assert t.output_partition_count() == j.output_partition_count()


@pytest.mark.parametrize("sql", [
    "select count(*) as n, sum(x) as s from t where x < 2500",
    "select count(*) as n from t where x >= 9995",
    "select count(*) as n from t where s = 'high'",
    "select s, count(*) as n, sum(y) as sy from t where x > 4321 group by s order by s",
    # an empty result after pruning every row group
    "select count(*) as n from t where x > 1000000",
    "select x, y from t where x > 1000000",
])
def test_pruning_never_changes_results(sorted_parquet, sql):
    jctx, tctx = _contexts(sorted_parquet)
    got = _same_sql(jctx, tctx, sql)
    if "1000000" in sql and "count" in sql:
        assert got["n"][0] == 0


def test_int64_stored_decimals_match_decimal128(tmp_path):
    """int64-unscaled decimal storage (field metadata kind/scale) gives the
    results of decimal128 files, pruning on the decimal column included:
    its integer statistics are in the scaled domain."""
    import decimal as pydec

    n = 5000
    rng = np.random.default_rng(9)
    cents = rng.integers(100, 10_000_000, n)
    vals = pa.array([pydec.Decimal(int(c)).scaleb(-2) for c in cents],
                    type=pa.decimal128(15, 2))
    t128 = pa.table({"id": pa.array(np.arange(n), type=pa.int64()), "price": vals})
    t64 = decimal_to_int64_storage(t128)
    p128, p64 = str(tmp_path / "d128.parquet"), str(tmp_path / "d64.parquet")
    pq.write_table(t128, p128, row_group_size=1000)
    pq.write_table(t64, p64, row_group_size=1000)
    sql = ("SELECT count(*) AS c, sum(price) AS s, avg(price) AS a "
           "FROM t WHERE price > 50000.00")
    out = {}
    for tag, path in (("d128", p128), ("d64", p64)):
        jctx, tctx = _contexts(path)
        sch = tctx.catalog.provider("t").schema
        assert sch.field("price").dtype.is_decimal and sch.field("price").dtype.scale == 2
        out[tag] = _same_sql(jctx, tctx, sql)
    assert out["d128"].equals(out["d64"]), (out["d128"], out["d64"])
    assert 0 < int(out["d64"]["c"][0]) < n
    j, t = _scans(p64, [(">", "price", 99000.0)], 4)
    assert t.pruned_row_groups == j.pruned_row_groups
    assert t.groups == j.groups


def test_pipelined_cold_scan_matches_plain(sorted_parquet):
    """The double-buffered cold scan (chunk i+1 read while chunk i
    converts) gives exactly the rows of the unpipelined read."""
    cfg = BallistaConfig({"ballista.batch.size": "1024", "ballista.scan.cache.bytes": "0"})
    scan = TParquetTable("t", sorted_parquet).scan(None, [], 1)  # 10 row groups, one partition
    batches = scan.execute(0, TaskContext(device=torch.device("cpu"), config=cfg))
    assert len(batches) > 1  # chunking engaged
    plain = scan._read_partition(0)
    xs = np.concatenate([b.columns["x"][b.mask].numpy() for b in batches])
    assert xs.tolist() == plain.column("x").to_pylist()
    svals = []
    for b in batches:  # chunk-local dictionaries decode the same strings
        svals.extend(b.dicts["s"][b.columns["s"][b.mask].numpy()].tolist())
    assert svals == plain.column("s").to_pylist()
    assert scan.metrics().to_dict()["scan_read_time"] > 0


def test_create_external_table(sorted_parquet, tmp_path):
    jctx, tctx = jab.BallistaContext.local(), tab.BallistaContext.local(device="cpu")
    for ctx in (jctx, tctx):
        ctx.sql(f"create external table t stored as parquet location '{sorted_parquet}'")
    _same_sql(jctx, tctx, "select s, count(*) as n, max(x) as mx from t group by s order by s")
    # a directory of parquet files registers as one table
    d = tmp_path / "dir"
    d.mkdir()
    for i in range(3):
        pq.write_table(pa.table({"x": np.arange(i * 10, i * 10 + 10, dtype=np.int64)}),
                       str(d / f"part{i}.parquet"))
    for ctx in (jctx, tctx):
        ctx.sql(f"create external table d stored as parquet location '{d}'")
    _same_sql(jctx, tctx, "select count(*) as n, sum(x) as s from d")
    # csv is ported too: a directory without csv files raises in both
    for ctx in (jctx, tctx):
        with pytest.raises(Exception, match="no csv files"):
            ctx.sql(f"create external table c stored as csv location '{d}'")


def test_object_store_paths_raise_naming_their_item():
    """Object-store URLs resolve through the port's registry
    (utils/object_store.py, held against the JAX package's in
    tests/test_torch_formats.py): a scheme nothing resolves raises naming
    the scheme, as in the JAX package."""
    from arrow_ballista_tpu_torch.utils.errors import ExecutionError

    ctx = tab.BallistaContext.local(device="cpu")
    with pytest.raises(ExecutionError, match="no object store registered for scheme 'nosuch'"):
        ctx.register_parquet("t", "nosuch://bucket/t.parquet")


# --------------------------------------------------------------------------
# the device-resident scan cache
# --------------------------------------------------------------------------


def _scan_metric(plan, name):
    total = plan.metrics().to_dict().get(name, 0) if type(plan).__name__ == "ParquetScanExec" \
        else 0
    return total + sum(_scan_metric(c, name) for c in plan.children())


def test_second_scan_hits_and_filters_apply_on_top(sorted_parquet):
    table_cache.CACHE.clear()
    tctx = tab.BallistaContext.local(device="cpu")
    tctx.register_parquet("t", sorted_parquet)
    jctx = jab.BallistaContext.local()
    jctx.register_parquet("t", sorted_parquet)
    # x - 1 > c is no simple predicate: no row group is pruned
    sql = "select count(*) as n, sum(x) as s from t where x - 1 > {}"
    _same_sql(jctx, tctx, sql.format(100))
    assert _scan_metric(tctx.last_plan, "scan_cache_hits") == 0
    entries = table_cache.CACHE.entries()
    assert entries and all(k[0] == "cpu" for k, _ in entries)
    before = _fingerprints()
    # the same partitions (pruning keeps them all) with another filter
    _same_sql(jctx, tctx, sql.format(2500))
    plan = tctx.last_plan
    assert _scan_metric(plan, "scan_cache_hits") == 10  # every row group its own partition
    assert _scan_metric(plan, "scan_read_time") == 0  # no row group read again
    assert _fingerprints() == before  # the filter made new masks


def test_rewritten_file_invalidates(tmp_path):
    table_cache.CACHE.clear()
    path = str(tmp_path / "t.parquet")
    pq.write_table(pa.table({"x": np.arange(100, dtype=np.int64)}), path)
    tctx = tab.BallistaContext.local(device="cpu")
    tctx.register_parquet("t", path)
    assert tctx.sql("select sum(x) as s from t").to_pandas()["s"][0] == 4950
    st = os.stat(path)
    pq.write_table(pa.table({"x": np.arange(100, 300, dtype=np.int64)}), path)
    os.utime(path, ns=(st.st_atime_ns, st.st_mtime_ns + 10**9))
    tctx.register_parquet("t", path)
    assert tctx.sql("select sum(x) as s from t").to_pandas()["s"][0] == sum(range(100, 300))
    assert _scan_metric(tctx.last_plan, "scan_cache_hits") == 0


def test_lru_eviction_and_disabled_cache(sorted_parquet):
    table_cache.CACHE.clear()
    before = table_cache.CACHE.stats()
    # room for three of the 8 partitions (a partition of x, y and s is
    # 1024 * (8 + 8 + 4) bytes of columns and a 1024-byte mask)
    budget = 3 * 21504
    tctx = tab.BallistaContext.local(
        BallistaConfig({"ballista.scan.cache.bytes": str(budget)}), device="cpu")
    tctx.register_parquet("t", sorted_parquet)
    tctx.sql("select count(*) as n, sum(x) as sx, sum(y) as sy, max(s) as ms from t").to_pandas()
    stats = table_cache.CACHE.stats()
    assert stats["evictions"] > before["evictions"]
    assert stats["entries"] == 3 and stats["bytes"] <= budget
    table_cache.CACHE.clear()
    off = tab.BallistaContext.local(BallistaConfig({"ballista.scan.cache.bytes": "0"}),
                                    device="cpu")
    off.register_parquet("t", sorted_parquet)
    for _ in range(2):
        assert off.sql("select count(*) as n from t").to_pandas()["n"][0] == 10_000
        assert _scan_metric(off.last_plan, "scan_cache_hits") == 0
    assert table_cache.CACHE.stats()["entries"] == 0


def test_auto_budget_is_keyed_on_the_device():
    assert table_cache.resolve_budget("auto", torch.device("cpu")) == 1 << 30
    assert table_cache.resolve_budget("auto", torch.device("cuda")) == 6 << 30
    assert table_cache.resolve_budget("0", "cpu") == 0
    assert table_cache.resolve_budget("12345", "cuda") == 12345
    # the same defaults as the reference on its CPU and accelerator backends
    from arrow_ballista_tpu.utils import table_cache as jcache

    assert (jcache.DEFAULT_BUDGET_CPU, jcache.DEFAULT_BUDGET) == (1 << 30, 6 << 30)


def _fingerprints():
    """(dtype, shape, data pointer, wrapping sum of the int64 view) of
    every tensor in the scan cache."""
    out = {}
    for key, batches in table_cache.CACHE.entries():
        for i, b in enumerate(batches):
            for name, t in [*b.columns.items(), ("__mask", b.mask)]:
                out[(key, i, name)] = (t.dtype, tuple(t.shape), t.data_ptr(),
                                       int(t.view(torch.int64).sum()))
    return out


def test_queries_never_write_into_cached_tensors(tpch_dir):
    """Batches in the scan cache are shared by every later query: q1, q3,
    q4 and q18 (cold, then warm) leave every cached tensor as it was, and
    the warm runs equal the reference."""
    table_cache.CACHE.clear()
    jctx, tctx = jab.BallistaContext.local(), tab.BallistaContext.local(device="cpu")
    for name in ("lineitem", "orders", "customer"):
        path = os.path.join(tpch_dir, f"{name}.parquet")
        jctx.register_parquet(name, path)
        tctx.register_parquet(name, path)
    sqls = [QUERIES[1], QUERIES[3], QUERIES[4], QUERIES[18].replace("> 300", "> 200")]
    for sql in sqls:
        tctx.sql(sql).to_pandas()
    before = _fingerprints()
    assert before
    for sql in sqls:
        _same_sql(jctx, tctx, sql)
        assert _scan_metric(tctx.last_plan, "scan_cache_hits") > 0
        assert _scan_metric(tctx.last_plan, "scan_read_time") == 0
    assert _fingerprints() == before
