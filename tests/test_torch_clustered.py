"""The port's clustered (presorted) partial aggregate and its early HAVING
against the JAX package, on the same parquet files (both local contexts on
the CPU).

Mirrors tests/test_clustered_groupby.py case by case: clustered HAVING
equals the oracle (at 4 and 'auto' partitions), unclustered data bails,
disorder inside row groups falls back to the sort path, NULL keys are
never early-filtered, a single-range probe is rejected without collapsing
the scan, and stale declared ranges turn the early filter off.  The
planner's annotation (predicate, overlap intervals, declared ranges) and
the contiguous regroup equal the reference's; the twins of K9 (through
grouped_aggregate_presorted), K10 (the range check) and K11 (the keep
mask) equal the reference's programs, and so do K10's row fold and K11's
merged intervals and search (numpy, step for step) at extreme keys and
over interval sets that overlap, touch, nest and reach int64's bounds; TPC-H q18 at SF0.01 over parquet
equals the reference as written, with ``> 200`` and without its LIMIT.
"""
import copy

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import jax.numpy as jnp

import arrow_ballista_tpu as jab
import arrow_ballista_tpu_torch as tab
from arrow_ballista_tpu.ops import kernels as JK
from arrow_ballista_tpu.ops.physical import TaskContext as JCtx
from arrow_ballista_tpu_torch.catalog import ParquetTable as TParquetTable
from arrow_ballista_tpu_torch.ops import kernels as TK
from arrow_ballista_tpu_torch.ops.physical import TaskContext as TCtx
from benchmarks.datagen import generate_tables
from benchmarks.queries import QUERIES
from benchmarks.tpch import decimal_to_int64_storage
from tests.torch_cases import (DISORDER_CASES, I64_MAX, I64_MIN, INTERVAL_CASES,
                               PRESORTED_CASES, disorder_case,
                               assert_frames_equal, interval_case, interval_keys, pad_intervals,
                               presorted_case)

# the suite runs in parallel worker processes: one core per worker for torch
torch.set_num_threads(1)

SQL = ("select k, sum(q) as sq from t group by k "
       "having sum(q) > 150 order by k")


def _write_clustered(path, n_keys=5000, seed=3):
    rng = np.random.default_rng(seed)
    # 1-7 rows a key, rows sorted by key (lineitem-like clustering); small
    # row groups so keys straddle row-group boundaries
    reps = rng.integers(1, 8, n_keys)
    keys = np.repeat(np.arange(n_keys, dtype=np.int64), reps)
    qty = rng.integers(1, 50, len(keys)).astype(np.int64)
    pq.write_table(pa.table({"k": keys, "q": qty}), path, row_group_size=1000)
    return pd.DataFrame({"k": keys, "q": qty})


def _write_null_keys(path):
    """NULL keys scattered through clustered data: each partition's NULL
    partial sum stays under the HAVING threshold, the merged one passes."""
    rng = np.random.default_rng(17)
    keys = np.repeat(np.arange(4000, dtype=np.float64), rng.integers(1, 4, 4000))
    null_pos = np.arange(50, len(keys), len(keys) // 16)
    keys[null_pos] = np.nan
    qty = np.full(len(keys), 1, dtype=np.int64)
    qty[null_pos] = 40  # 16 nulls x 40 = 640 in all, ~160 a partition
    pa_keys = pa.array([None if np.isnan(v) else int(v) for v in keys], type=pa.int64())
    pq.write_table(pa.table({"k": pa_keys, "q": pa.array(qty)}), path, row_group_size=1000)


def _write_disordered(path):
    """Disjoint row-group key ranges, rows unsorted inside each group."""
    rng = np.random.default_rng(11)
    parts = []
    for lo in range(0, 5000, 1000):
        block = np.repeat(np.arange(lo, lo + 1000, dtype=np.int64), rng.integers(1, 4, 1000))
        rng.shuffle(block)
        parts.append(block)
    keys = np.concatenate(parts)
    qty = rng.integers(1, 50, len(keys)).astype(np.int64)
    writer = pq.ParquetWriter(path, pa.schema([("k", pa.int64()), ("q", pa.int64())]))
    off = 0
    for block in parts:
        writer.write_table(pa.table({"k": keys[off:off + len(block)],
                                     "q": qty[off:off + len(block)]}))
        off += len(block)
    writer.close()
    return pd.DataFrame({"k": keys, "q": qty})


def _oracle(df, threshold=150):
    g = df.groupby("k").q.sum()
    return g[g > threshold]


def _contexts(path, partitions="4"):
    settings = {"ballista.shuffle.partitions": partitions}
    jctx = jab.BallistaContext.local(jab.BallistaConfig(settings))
    tctx = tab.BallistaContext.local(tab.BallistaConfig(settings), device="cpu")
    jctx.register_parquet("t", path)
    tctx.register_parquet("t", path)
    return jctx, tctx


def _find(plan, pred):
    if pred(plan):
        return plan
    for c in plan.children():
        got = _find(c, pred)
        if got is not None:
            return got
    return None


def _clustered_agg(plan):
    return _find(plan, lambda p: type(p).__name__ == "HashAggregateExec"
                 and getattr(p, "clustered", None) is not None)


def _scan(plan):
    return _find(plan, lambda p: type(p).__name__ == "ParquetScanExec")


def _metric(plan, name):
    return plan.metrics().to_dict().get(name, 0) + sum(_metric(c, name)
                                                       for c in plan.children())


def _run_both(jctx, tctx, sql):
    want = jctx.sql(sql).to_pandas()
    got = tctx.sql(sql).to_pandas()
    assert_frames_equal(got, want)
    return got


def _annotation(agg):
    pred, intervals, ranges = agg.clustered
    return (None if pred is None else str(pred), [tuple(i) for i in intervals],
            [tuple(r) for r in ranges])


@pytest.mark.parametrize("partitions", ["4", "auto"])
def test_clustered_having_matches_oracle(tmp_path, partitions):
    path = str(tmp_path / "t.parquet")
    df = _write_clustered(path)
    jctx, tctx = _contexts(path, partitions)
    out = _run_both(jctx, tctx, SQL)
    ora = _oracle(df)
    assert out.k.tolist() == ora.index.tolist()
    assert out.sq.tolist() == ora.values.tolist()
    plan = tctx.last_plan
    assert _metric(plan, "presort_fallbacks") == 0
    if partitions == "4":  # 'auto' collapses this small table to one partition
        assert _metric(plan, "clustered_early_filters") > 0
        # the partial aggregates ship only survivors and window keys, not
        # every one of the ~5000 states
        agg = _clustered_agg(plan)
        ctx = TCtx(device=torch.device("cpu"), config=tctx.config)
        shipped = sum(b.num_rows for p in range(agg.output_partition_count())
                      for b in agg.execute(p, ctx))
        assert shipped < len(ora) + 200


def test_unclustered_data_bails_and_stays_correct(tmp_path):
    path = str(tmp_path / "t.parquet")
    rng = np.random.default_rng(5)
    keys = rng.integers(0, 5000, 20_000).astype(np.int64)  # NOT sorted
    qty = rng.integers(1, 50, len(keys)).astype(np.int64)
    pq.write_table(pa.table({"k": keys, "q": qty}), path, row_group_size=1000)
    jctx, tctx = _contexts(path)
    out = _run_both(jctx, tctx, SQL)
    ora = _oracle(pd.DataFrame({"k": keys, "q": qty}))
    assert out.k.tolist() == ora.index.tolist()
    assert out.sq.tolist() == ora.values.tolist()
    assert _clustered_agg(tctx.last_plan) is None
    assert _metric(tctx.last_plan, "clustered_early_filters") == 0


@pytest.mark.parametrize("data", ["clustered", "null_keys", "disordered"])
def test_annotation_and_regroup_match_reference(tmp_path, data):
    """The planner's (predicate, overlap intervals, declared ranges) and the
    scan's contiguous regroup equal the reference's: they decide which
    keys are early-filtered."""
    path = str(tmp_path / "t.parquet")
    {"clustered": _write_clustered, "null_keys": _write_null_keys,
     "disordered": _write_disordered}[data](path)
    jctx, tctx = _contexts(path)
    sql = SQL.replace("> 150", "> 300") if data == "null_keys" else SQL
    jp = _plan(jab, jctx, sql).plan
    tp = _plan(tab, tctx, sql).plan
    ja, ta = _clustered_agg(jp), _clustered_agg(tp)
    assert ja is not None and ta is not None
    assert _annotation(ta) == _annotation(ja)
    assert _scan(tp).groups == _scan(jp).groups
    if data == "null_keys":  # the NULL sentinel interval always ships
        sent = int(np.iinfo(np.int64).min)
        assert (sent, sent) in _annotation(ta)[1]


def _plan(pkg, ctx, sql):
    """The PlannedQuery of ``sql`` in ``pkg``'s planner."""
    import importlib

    def mod(name):
        return importlib.import_module(f"{pkg.__name__}.{name}")

    logical = mod("sql.optimizer").optimize(
        mod("sql.planner").SqlToRel(ctx.catalog).plan(mod("sql.parser").parse_sql(sql)))
    args = (ctx.catalog, ctx.config) + ((ctx.device,) if pkg is tab else ())
    return mod("scheduler.physical_planner").PhysicalPlanner(*args).plan_query(logical)


def test_within_rowgroup_disorder_falls_back(tmp_path):
    """Row-group statistics prove disjoint ranges while rows inside a group
    are unordered: the presorted grouping detects the disorder (K9) and
    re-runs the sort path; results stay exact."""
    path = str(tmp_path / "t.parquet")
    df = _write_disordered(path)
    jctx, tctx = _contexts(path)
    out = _run_both(jctx, tctx, SQL)
    ora = _oracle(df)
    assert out.k.tolist() == ora.index.tolist()
    assert out.sq.tolist() == ora.values.tolist()
    assert _metric(tctx.last_plan, "presort_fallbacks") > 0


def test_null_keys_never_early_filtered(tmp_path):
    path = str(tmp_path / "t.parquet")
    _write_null_keys(path)
    jctx, tctx = _contexts(path)
    out = _run_both(jctx, tctx, "select k, sum(q) as sq from t group by k "
                                "having sum(q) > 300 order by k")
    assert len(out) == 1 and np.isnan(out.k.iloc[0]) and out.sq.iloc[0] == 16 * 40
    assert _metric(tctx.last_plan, "clustered_range_mismatches") == 0


def test_single_range_probe_rejected_without_partition_collapse(tmp_path):
    """A probe whose contiguous regroup collapses to ONE range (a huge
    trailing row group absorbs it) is rejected, and leaves the scan's
    partitions as they were."""
    rng = np.random.default_rng(3)
    keys = np.repeat(np.arange(2000, dtype=np.int64), rng.integers(1, 8, 2000))
    qty = rng.integers(1, 50, len(keys)).astype(np.int64)
    table = pa.table({"k": keys, "q": qty})
    path = str(tmp_path / "t.parquet")
    writer = pq.ParquetWriter(path, table.schema)
    writer.write_table(table.slice(0, 10))   # a tiny row group ...
    writer.write_table(table.slice(10))      # ... then one huge one
    writer.close()
    scan = TParquetTable("t", path).scan(None, [], 2)
    before = [list(g) for g in scan.groups]
    assert len(before) == 2
    groups, ranges = scan.clustered_ranges("k")
    assert len(ranges) == 1
    assert [list(g) for g in scan.groups] == before
    jctx, tctx = _contexts(path, partitions="2")
    tp = _plan(tab, tctx, SQL).plan
    assert _clustered_agg(tp) is None
    assert len(_scan(tp).groups) == 2
    out = _run_both(jctx, tctx, SQL)
    ora = _oracle(pd.DataFrame({"k": keys, "q": qty}))
    assert out.k.tolist() == ora.index.tolist()
    assert out.sq.tolist() == ora.values.tolist()


def test_stale_declared_ranges_disable_early_filter(tmp_path):
    """When a partition's observed key range leaves the declared one (a
    file rewritten after planning), K10 trips and the early filter is
    dropped: trusting stale windows would drop boundary groups."""
    path = str(tmp_path / "t.parquet")
    df = _write_clustered(path)
    _jctx, tctx = _contexts(path)
    planned = _plan(tab, tctx, SQL)
    agg = _clustered_agg(planned.plan)
    pred, _intervals, ranges = agg.clustered
    agg.clustered = (pred, [], [(lo + 10_000_000, hi + 10_000_000) for lo, hi in ranges])
    batches = tctx._execute_local(planned)
    out = pd.concat([b.to_pandas() for b in batches], ignore_index=True).sort_values("k")
    ora = _oracle(df)
    assert out.k.tolist() == ora.index.tolist()
    assert out.sq.tolist() == ora.values.tolist()
    assert _metric(planned.plan, "clustered_range_mismatches") > 0
    assert _metric(planned.plan, "clustered_early_filters") == 0


# --------------------------------------------------------------------------
# the programs: K9 (inside grouped_aggregate_presorted), K10, K11
# --------------------------------------------------------------------------


@pytest.mark.parametrize("case", list(DISORDER_CASES))
def test_disorder_twin_over_row_order_matches_the_reference(case):
    """K9's twin reads the rows as they are (the live keys in row order must
    not decrease); the reference compares adjacent live rows in K2's
    compaction order, from grouped_aggregate_presorted: the same flag on
    decreases across dead runs and at rows 2,047 / 2,048 and 2,048 / 2,049,
    equal keys across a dead row, dead keys that decrease, int32 and int64
    extremes, one and two live rows and every row dead."""
    keys, mask = disorder_case(case, 4099, np.random.default_rng(22))
    n = keys.shape[0]
    jd = JK.grouped_aggregate_presorted([jnp.asarray(keys)], [(jnp.zeros(n, jnp.int64), "count")],
                                        jnp.asarray(mask), n)[4]
    td = TK.presorted_disorder(torch.from_numpy(keys), torch.from_numpy(mask))
    assert bool(td) == bool(jd) == DISORDER_CASES[case]


def test_disorder_twin_over_no_rows():
    """No rows, and one row: no pair, no disorder (the reference's grouping
    needs a row, so this one is held against the definition)."""
    for n in (0, 1):
        keys, mask = np.zeros(n, np.int64), np.ones(n, bool)
        assert not bool(TK.presorted_disorder(torch.from_numpy(keys), torch.from_numpy(mask)))


@pytest.mark.parametrize("case", PRESORTED_CASES)
def test_grouped_aggregate_presorted_matches_reference(case):
    keys, vals, mask = presorted_case(case, 5003, np.random.default_rng(21))
    jk, jv, jm, jo, jd = JK.grouped_aggregate_presorted(
        [jnp.asarray(keys)], [(jnp.asarray(v), h) for v, h in vals], jnp.asarray(mask), 5003)
    tk, tv, tm, to, td = TK.grouped_aggregate_presorted(
        [torch.from_numpy(keys)], [(torch.from_numpy(v), h) for v, h in vals],
        torch.from_numpy(mask), 5003)
    assert bool(td) == bool(jd) == (case == "disordered")
    assert (to is None) == (jo is None)
    live = np.asarray(jm)
    np.testing.assert_array_equal(tm.numpy(), live)
    np.testing.assert_array_equal(tk[0].numpy()[live], np.asarray(jk[0])[live])
    for g, w in zip(tv, jv):
        np.testing.assert_array_equal(g.numpy()[live], np.asarray(w)[live])


@pytest.fixture(scope="module")
def planned_aggs(tmp_path_factory):
    """The clustered partial aggregate of SQL as each package plans it,
    over a file whose key is nullable (the NULL sentinel interval)."""
    path = str(tmp_path_factory.mktemp("cl") / "t.parquet")
    _write_null_keys(path)
    jctx, tctx = _contexts(path)
    ja = _clustered_agg(_plan(jab, jctx, SQL).plan)
    ta = _clustered_agg(_plan(tab, tctx, SQL).plan)
    return ja, ta


def _batches(which, op, arrays, mask):
    """The same batch of ``op``'s input or output schema in each package;
    ``arrays`` in schema order."""
    from arrow_ballista_tpu.models.batch import ColumnBatch as JB
    from arrow_ballista_tpu_torch.models.batch import ColumnBatch as TB

    schema = op.schema if which == "out" else op.input.schema
    cols = dict(zip(schema.names(), arrays))
    n = len(mask)
    jb = JB.from_numpy(schema, cols, dicts={}, capacity=n)
    jb = JB(jb.schema, jb.columns, jnp.asarray(mask), jb.dicts)
    tb = TB.from_numpy(_tschema(schema), cols, dicts={}, capacity=n, device="cpu")
    tb = TB(tb.schema, tb.columns, torch.from_numpy(mask), tb.dicts)
    return jb, tb


def _tschema(jschema):
    from arrow_ballista_tpu_torch.models.batch import _schema_from_parts

    return _schema_from_parts(list(jschema))


@pytest.mark.parametrize("case", ["inside", "above", "below", "null_keys_only_outside",
                                  "dead_rows_outside"])
def test_range_check_matches_reference(planned_aggs, case):
    """K10's twin against the reference's "sort.range_check" program, run
    through both operators on the same batch of the partial's input."""
    ja, ta = planned_aggs
    lo, hi = ja.clustered[2][1]
    rng = np.random.default_rng(5)
    n = 2048
    k = rng.integers(lo, hi + 1, n).astype(np.int64)
    mask = rng.random(n) < 0.9
    sent = np.iinfo(np.int64).min
    if case == "above":
        k[7], mask[7] = hi + 1, True
    elif case == "below":
        k[9], mask[9] = lo - 3, True
    elif case == "null_keys_only_outside":
        k[::5] = sent
    elif case == "dead_rows_outside":
        k[~mask] = hi + 1000
    jb, tb = _batches("in", ja, [k, np.ones(n, np.int64)], mask)
    ja._ensure_compiled(JCtx(), ja.input.schema)
    if ta._compiled is None:
        ta._compiled = ta._make_compiled(TCtx(device=torch.device("cpu")),
                                         ta.input.schema)
    want = bool(ja._declared_range_mismatch(JCtx(), jb, 1))
    got = bool(ta._declared_range_mismatch(tb, 1))
    assert got == want == (case in ("above", "below"))


@pytest.mark.parametrize("case", ["mixed", "all_pass_having", "window_keys_only", "null_keys"])
def test_clustered_keep_matches_reference(planned_aggs, case):
    """K11's twin against the reference's "agg.clustered_keep": the same
    partial result, filtered by both operators, keeps the same rows."""
    ja, ta = planned_aggs
    intervals = ja.clustered[1]
    rng = np.random.default_rng(6)
    n = 4096
    k = rng.integers(0, 4000, n).astype(np.int64)
    sq = rng.integers(0, 200, n).astype(np.int64)
    mask = rng.random(n) < 0.8
    if case == "all_pass_having":
        sq[:] = 1000
    elif case == "window_keys_only":
        sq[:] = 0
        k[: len(intervals)] = [lo for lo, _ in intervals]
    elif case == "null_keys":
        k[::7] = np.iinfo(np.int64).min
    jb, tb = _batches("out", ja, [k, sq], mask)
    want = ja._apply_clustered_filter(JCtx(), jb, None, None)
    got = ta._apply_clustered_filter(TCtx(device=torch.device("cpu")),
                                     tb, None, None)
    wd, gd = want.compacted_numpy(), got.compacted_numpy()
    for name in ja.schema.names():
        assert gd[name].tolist() == wd[name].tolist()
    assert got.num_rows == want.num_rows > 0


# --------------------------------------------------------------------------
# K10's fold and K11's merged intervals (the Hopper kernels' arithmetic,
# step for step in numpy, against the reference)
# --------------------------------------------------------------------------

# the merged union of each fixed case (K11's input)
MERGED = {"overlapping": [(0, 30), (100, 110)], "touching": [(-5, 20), (22, 30)],
          "nested": [(0, 100), (200, 300)], "pads_only": [],
          "null_sentinel_pair": [(int(I64_MIN), int(I64_MIN) + 1), (5, 12)],
          "at_int64_max": [(0, 3), (int(I64_MAX) - 10, int(I64_MAX))]}


def _reference_shared(keys, los, his, chunk=2048):
    """The reference's interval test (the body of "agg.clustered_keep")
    over the padded pairs, in key chunks."""
    jl, jh = jnp.asarray(los)[None, :], jnp.asarray(his)[None, :]
    out = []
    for i in range(0, len(keys), chunk):
        k = jnp.asarray(keys[i:i + chunk])[:, None]
        out.append(np.asarray(jnp.any((k >= jl) & (k <= jh), axis=1)))
    return np.concatenate(out)


def _search_like_k11(starts, ends, keys, group):
    """K11's membership test (csrc/clustered.cu ab_in_union), step for
    step, for a lane of ``group`` rows at a time: how many merged starts lie
    at or below the lane's lowest and highest key (a, b) by steps of top,
    top/2, .., 1; then one compare with ends[a - 1] when a == b, else a
    search of each key over the starts in (a, b]."""
    s, e = starts.tolist(), ends.tolist()
    m = len(s)
    top = 1 << (m.bit_length() - 1) if m else 0
    out = np.zeros(len(keys), dtype=bool)
    for g in range(0, len(keys), group):
        v = keys[g:g + group].tolist()
        lo, hi = min(v), max(v)
        a = b = 0
        step = top
        while step:
            if a + step <= m and s[a + step - 1] <= lo:
                a += step
            if b + step <= m and s[b + step - 1] <= hi:
                b += step
            step >>= 1
        if a == b:
            out[g:g + len(v)] = [a > 0 and x <= e[a - 1] for x in v]
            continue
        for i, x in enumerate(v):
            pos, step = a, 1 << ((b - a).bit_length() - 1)
            while step:
                if pos + step <= b and s[pos + step - 1] <= x:
                    pos += step
                step >>= 1
            out[g + i] = pos > 0 and x <= e[pos - 1]
    return out


@pytest.mark.parametrize("case", INTERVAL_CASES)
def test_merged_intervals_select_the_reference_keys(case):
    """KeepIntervals' merged union selects exactly the keys that the
    reference's formula selects over the padded pairs, searched as K11
    searches it; the wrapper's CPU route (the twin, over the padded pairs)
    keeps the same rows."""
    rng = np.random.default_rng(23)
    pairs = interval_case(case, rng)
    los, his = pad_intervals(pairs)
    keys = interval_keys(pairs, 4096, rng)
    want = _reference_shared(keys, los, his)
    iv = TK.KeepIntervals(los, his, "cpu")
    assert torch.equal(iv.los, torch.from_numpy(los)) and torch.equal(iv.his, torch.from_numpy(his))
    starts, ends = iv.starts.numpy(), iv.ends.numpy()
    merged = list(zip(starts.tolist(), ends.tolist()))
    if case in MERGED:
        assert merged == MERGED[case]
    if case == "random_5000":
        assert len(merged) == 5000
    # sorted, disjoint and apart: no two pairs would merge further
    assert all(a <= b for a, b in merged)
    assert all(b + 1 < a for (_, b), (a, _) in zip(merged, merged[1:]))
    for group in (1, 8):  # a row alone (the row-by-row path) and a lane's 8
        np.testing.assert_array_equal(_search_like_k11(starts, ends, keys, group), want)
    # in key order a lane's keys mostly share their interval (a == b)
    order = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(_search_like_k11(starts, ends, keys[order], 8), want[order])
    assert want.any() == bool(pairs and case != "pads_only")
    n = len(keys)
    mask = rng.random(n) < 0.8
    pred = rng.random(n) < 0.05
    keep, live = TK.clustered_keep(torch.from_numpy(keys), torch.from_numpy(mask),
                                   torch.from_numpy(pred), iv)
    np.testing.assert_array_equal(keep.numpy(), mask & (want | pred))
    assert int(live) == int((mask & (want | pred)).sum())


@pytest.mark.parametrize("case", INTERVAL_CASES)
def test_clustered_filter_over_interval_sets_matches_reference(planned_aggs, case):
    """Both operators' early HAVING with each interval set in place of the
    planner's: the same rows survive."""
    ja, ta = planned_aggs
    rng = np.random.default_rng(24)
    pairs = interval_case(case, rng)
    jop, top = copy.copy(ja), copy.copy(ta)
    for op in (jop, top):
        op.clustered = (op.clustered[0], pairs, *op.clustered[2:])
        op._cl_compiled = None
    keys = interval_keys(pairs, 4096, rng)[:4096]
    n = len(keys)
    sq = rng.integers(0, 200, n).astype(np.int64)
    mask = rng.random(n) < 0.8
    jb, tb = _batches("out", ja, [keys, sq], mask)
    want = jop._apply_clustered_filter(JCtx(), jb, None, None)
    got = top._apply_clustered_filter(TCtx(device=torch.device("cpu")), tb, None, None)
    wd, gd = want.compacted_numpy(), got.compacted_numpy()
    for name in ja.schema.names():
        assert gd[name].tolist() == wd[name].tolist()
    assert got.num_rows == want.num_rows > 0


RANGE_EXTREMES = ["int64_bounds_inside", "int64_max_above", "int64_min_below",
                  "sentinel_only_outside", "all_dead", "one_row_above", "int32_extremes"]


@pytest.mark.parametrize("case", RANGE_EXTREMES)
def test_range_check_fold_matches_reference(planned_aggs, case):
    """K10 folds live & (k < lo | k > hi) over the rows instead of a live
    min and max: the same flag as the reference's "sort.range_check" (run
    through the JAX operator) and as the port's operator on the CPU."""
    ja, ta = planned_aggs
    rng = np.random.default_rng(25)
    n = 4096
    lo, hi = int(I64_MIN) + 1, int(I64_MAX)
    k = rng.integers(I64_MIN, I64_MAX, n, dtype=np.int64)
    k[k == I64_MIN] = 0
    mask = rng.random(n) < 0.9
    if case == "int64_max_above":
        hi = int(I64_MAX) - 1
        k[11], mask[11] = I64_MAX, True
    elif case == "int64_min_below":
        lo = int(I64_MIN) + 2
        k[13], mask[13] = I64_MIN + 1, True
    elif case == "sentinel_only_outside":  # NULL keys (the sentinel) never count
        lo = int(I64_MIN) + 2
        k[::3] = I64_MIN
    elif case == "all_dead":
        lo, hi = 0, 0
        mask[:] = False
    elif case == "one_row_above":
        lo, hi = -5, 5
        k[:] = 3
        k[n - 1], mask[n - 1] = 6, True
    elif case == "int32_extremes":  # int32 keys reach the kernel widened
        lo, hi = int(np.iinfo(np.int32).min), int(np.iinfo(np.int32).max) - 1
        k = rng.integers(lo, hi, n).astype(np.int64)
        k[17], mask[17] = hi + 1, True
    sent = int(I64_MIN)  # the key is nullable
    live = mask & (k != sent)
    fold = bool((live & ((k < lo) | (k > hi))).any())
    jb, tb = _batches("in", ja, [k, np.ones(n, np.int64)], mask)
    ja._ensure_compiled(JCtx(), ja.input.schema)
    if ta._compiled is None:
        ta._compiled = ta._make_compiled(TCtx(device=torch.device("cpu")), ta.input.schema)
    jop, top = copy.copy(ja), copy.copy(ta)
    for op in (jop, top):
        op.clustered = (*op.clustered[:2], [(lo, hi), (lo, hi)])
    want = bool(jop._declared_range_mismatch(JCtx(), jb, 1))
    got = bool(top._declared_range_mismatch(tb, 1))
    assert fold == want == got == (case in ("int64_max_above", "int64_min_below",
                                            "one_row_above", "int32_extremes"))


# --------------------------------------------------------------------------
# TPC-H q18 over parquet (SF0.01, lineitem in 8 row groups)
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def q18_contexts(tmp_path_factory):
    d = tmp_path_factory.mktemp("tpch18")
    jctx, tctx = jab.BallistaContext.local(), tab.BallistaContext.local(device="cpu")
    for name, t in generate_tables(0.01, seed=0).items():
        if name not in ("lineitem", "orders", "customer"):
            continue
        path = str(d / f"{name}.parquet")
        pq.write_table(decimal_to_int64_storage(t), path, row_group_size=8192)
        jctx.register_parquet(name, path)
        tctx.register_parquet(name, path)
    return jctx, tctx


@pytest.mark.parametrize("variant", ["as_written", "having_200", "having_200_no_limit"])
def test_q18_over_parquet_matches_reference(q18_contexts, variant):
    jctx, tctx = q18_contexts
    sql = QUERIES[18]
    if variant != "as_written":
        sql = sql.replace("> 300", "> 200")
    if variant.endswith("no_limit"):
        sql = sql.replace("limit 100", "")
    got = _run_both(jctx, tctx, sql)
    want_rows = {"as_written": 0, "having_200": 100}.get(variant)
    if want_rows is not None:
        assert len(got) == want_rows
    else:
        assert len(got) > 100
    plan = tctx.last_plan
    assert _metric(plan, "clustered_early_filters") > 0
    assert _metric(plan, "presort_fallbacks") == 0
