"""The port's mesh layer (parallel/, K17, K18) against the JAX package's.

The JAX side runs on its 8 virtual CPU devices (tests/conftest.py), the
port's on CPU ranks (``make_mesh(devices=[cpu] * n)``), both from the same
numpy-seeded inputs:

- K17's twin against ``ici_shuffle.dispatch_to_buckets``: send buffers,
  masks, counts and the overflow flag bit for bit, at 1, 2, 3 and 8
  destinations, with and without overflow;
- K18's twin against ``lax.psum`` / ``pmin`` / ``pmax`` over shard_map
  (integers exact, wrapping sums included; float64 sums rtol 1e-12; the
  ``bad`` flags' OR), one column at a time and as one many-column merge
  (int32, int64, float64 and bool columns, NaN in float min and max, int64
  sums that wrap, the exists counts' ``psum(...) > 0``) at 1, 2, 4 and 8
  ranks;
- ``distributed_dense_aggregate`` against the reference's at 1, 2, 4 and 8
  ranks, in rows and rejected rows, its merge one collective;
- the five cases of tests/test_parallel.py at 1, 2, 4 and 8 ranks (the
  skewed one at the reference's 8), the programs' outputs compared row for
  row in rank order;
- ``entry.dryrun_multichip(8)`` against ``__graft_entry__._dryrun_impl(8)``;
- the root exports, ``PhysicalPlanner`` / ``resolve_budget`` defaulting to
  the card, and ``ExecutionStage.aggregate_metrics`` against the
  reference's on a clustered q18.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import PartitionSpec as P

from arrow_ballista_tpu.parallel import (PART_AXIS, distributed_filter_aggregate as
                                         j_filter_aggregate,
                                         distributed_grouped_aggregate as j_grouped_aggregate,
                                         make_mesh as j_make_mesh, row_sharding, shuffle_rows as
                                         j_shuffle_rows)
from arrow_ballista_tpu.parallel.ici_shuffle import dispatch_to_buckets as j_dispatch
from arrow_ballista_tpu_torch.ops import kernels as TK
from arrow_ballista_tpu_torch.parallel import (distributed_filter_aggregate,
                                               distributed_grouped_aggregate, make_mesh,
                                               shard_rows, shuffle_rows)
from arrow_ballista_tpu.parallel.distributed import (distributed_dense_aggregate as
                                                     j_dense_aggregate)
from arrow_ballista_tpu_torch.parallel import collectives as TC
from arrow_ballista_tpu_torch.parallel.distributed import _run_ranks, distributed_dense_aggregate

torch.set_num_threads(1)
CPU = torch.device("cpu")
RANKS = [1, 2, 4, 8]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _cat(x):
    return torch.cat(x).numpy() if isinstance(x, list) else x.numpy()


def _jplace(mesh, arr):
    return jax.device_put(jnp.asarray(arr), row_sharding(mesh))


def _tmesh(n):
    return make_mesh(devices=[CPU] * n)


def _tsharded(cols, mask, mesh):
    return ({k: shard_rows(_t(v), mesh) for k, v in cols.items()},
            shard_rows(_t(mask), mesh, fill=False))


# --------------------------------------------------------------------------
# K17 and K18: the twins against the reference's programs
# --------------------------------------------------------------------------


@pytest.mark.parametrize("overflow", [False, True], ids=["fits", "overflows"])
@pytest.mark.parametrize("n_dest", [1, 2, 3, 8])
def test_dispatch_twin_matches_the_reference_bit_for_bit(n_dest, overflow):
    rng = np.random.default_rng(100 + n_dest)
    n = 5000
    dest = rng.integers(0, n_dest, n).astype(np.int32)
    mask = rng.random(n) < 0.8
    cols = {"i64": rng.integers(-2**62, 2**62, n), "f64": rng.random(n),
            "i32": rng.integers(-9, 9, n).astype(np.int32), "b": rng.random(n) < 0.5}
    counts = np.bincount(dest[mask], minlength=n_dest)
    cap = int(counts.max()) - 7 if overflow else int(counts.max()) + 3
    js, jm, jo = j_dispatch({k: jnp.asarray(v) for k, v in cols.items()}, jnp.asarray(dest),
                            jnp.asarray(mask), n_dest, cap)
    ts, tm, to, tc = TK.dispatch_to_buckets_plain({k: _t(v) for k, v in cols.items()}, _t(dest),
                                                  _t(mask), n_dest, cap)
    for k in cols:
        np.testing.assert_array_equal(ts[k].numpy(), np.asarray(js[k]), err_msg=k)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert bool(to) == bool(jo) == overflow
    np.testing.assert_array_equal(tc.numpy(), counts)


def _j_reduce(xs, how):
    """The reference's psum / pmin / pmax over len(xs) devices."""
    n = len(xs)
    mesh = j_make_mesh(n)
    fn = {"sum": lax.psum, "min": lax.pmin, "max": lax.pmax}[how]
    prog = jax.jit(jax.shard_map(lambda x: fn(x, PART_AXIS), mesh=mesh,
                                 in_specs=P(PART_AXIS), out_specs=P()))
    return np.asarray(prog(_jplace(mesh, np.concatenate(xs))))


@pytest.mark.parametrize("n", [1, 3, 8])
@pytest.mark.parametrize("dtype, how", [("int64", "sum"), ("int64", "min"), ("int64", "max"),
                                        ("int32", "sum"), ("float64", "sum"), ("float64", "max"),
                                        ("bool", "or")])
def test_rank_merge_twin_matches_psum_pmin_pmax(n, dtype, how):
    rng = np.random.default_rng(7)
    domain = 4099
    if dtype == "int64":  # near the edges: the sums wrap, as XLA's do
        xs = [rng.integers(2**62, 2**63 - 1, domain) * rng.choice([-1, 1], domain)
              for _ in range(n)]
    elif dtype == "int32":
        xs = [rng.integers(0, 1000, domain).astype(np.int32) for _ in range(n)]
    elif dtype == "float64":
        xs = [rng.normal(size=domain) * 1e6 for _ in range(n)]
    else:
        xs = [rng.random(domain) < 0.01 for _ in range(n)]
    got = TK.merge_rank_states_plain([_t(x) for x in xs], how).numpy()
    if dtype == "bool":  # the reference's psum(bad.astype(int32)) > 0
        want = _j_reduce([x.astype(np.int32) for x in xs], "sum") > 0
    else:
        want = _j_reduce(xs, how)
    if dtype == "float64" and how == "sum":
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    else:
        np.testing.assert_array_equal(got, want)


def _merge_columns(n, rng, domain):
    """One dense merge's columns over n ranks, numpy: (arrays, how) each."""
    nan = lambda a: np.where(rng.random(domain) < 0.05, np.nan, a)  # noqa: E731
    return [
        ([rng.integers(2**62, 2**63 - 1, domain) * rng.choice([-1, 1], domain)
          for _ in range(n)], "sum"),
        ([rng.integers(-2**63, 2**63 - 1, domain, dtype=np.int64) for _ in range(n)], "min"),
        ([rng.integers(-2**31, 2**31 - 1, domain).astype(np.int32) for _ in range(n)], "sum"),
        ([rng.integers(-9, 9, domain).astype(np.int32) for _ in range(n)], "max"),
        ([rng.normal(size=domain) * 1e6 for _ in range(n)], "sum"),
        ([rng.normal(size=domain) for _ in range(n)], "min"),
        ([rng.normal(size=domain) for _ in range(n)], "max"),
        ([nan(rng.normal(size=domain)) for _ in range(n)], "min"),
        ([nan(rng.normal(size=domain)) for _ in range(n)], "max"),
        ([rng.integers(0, 2**31 - 1, domain).astype(np.int32) * (rng.random(domain) < 0.3)
          for _ in range(n)], TK.MERGE_EXISTS),
        ([rng.random(1) < 0.2 for _ in range(n)], "or"),
    ]


@pytest.mark.parametrize("n", RANKS)
def test_many_column_merge_twin_matches_psum_pmin_pmax(n):
    """K18's many-column twin, each column against the reference's own
    collective: psum / pmin / pmax, ``psum(exists_cnt) > 0`` (its int32
    sums wrap before the compare) and ``psum(bad.astype(int32)) > 0``.
    A float min or max with NaN is held against the collective's reduction
    computation, ``lax.min`` / ``lax.max`` folded in rank order, which
    propagates NaN: XLA's CPU all-reduce runtime skips NaN instead (a slot
    NaN on every rank comes out as the identity, +-inf)."""
    import functools

    rng = np.random.default_rng(40 + n)
    columns = _merge_columns(n, rng, 1031)
    got = TK.merge_rank_columns([([_t(x) for x in xs], how) for xs, how in columns])
    assert len(got) == len(columns)
    for (xs, how), g in zip(columns, got):
        if xs[0].dtype == np.float64 and how in ("min", "max") and np.isnan(xs).any():
            fold = lax.min if how == "min" else lax.max
            want = np.asarray(functools.reduce(fold, [jnp.asarray(x) for x in xs]))
        elif how == TK.MERGE_EXISTS:
            want = _j_reduce(xs, "sum") > 0
        elif how == "or":
            want = _j_reduce([x.astype(np.int32) for x in xs], "sum") > 0
        else:
            want = _j_reduce(xs, how)
        assert g.dtype == (torch.bool if how in ("or", TK.MERGE_EXISTS) else _t(xs[0]).dtype)
        if xs[0].dtype == np.float64 and how == "sum":
            np.testing.assert_allclose(g.numpy(), want, rtol=1e-12, atol=0)
        else:
            np.testing.assert_array_equal(g.numpy(), want, err_msg=f"{xs[0].dtype} {how}")


@pytest.mark.parametrize("how", ["min", "max"])
@pytest.mark.parametrize("n", RANKS)
def test_merge_of_nan_slots_differs_from_the_cpu_collective_as_recorded(n, how):
    """The one known difference from the reference, pinned: a slot NaN on
    every rank, one NaN on rank 0 only, one finite.  K18's twin propagates
    NaN in rank order; the reference's ``pmin`` / ``pmax`` on XLA's CPU
    runtime skip NaN over two or more ranks, so the first slot comes out
    as the identity (+inf for min, -inf for max) and the second as the
    other ranks' value."""
    xs = [np.array([np.nan, np.nan if r == 0 else 1.0, 2.0 + r]) for r in range(n)]
    got = TK.merge_rank_columns([([_t(x) for x in xs], how)])[0].numpy()
    last = 2.0 if how == "min" else 1.0 + n
    np.testing.assert_array_equal(got, [np.nan, np.nan, last])
    want = ([np.nan, np.nan, last] if n == 1
            else [np.inf if how == "min" else -np.inf, 1.0, last])
    np.testing.assert_array_equal(_j_reduce(xs, how), want)


@pytest.mark.parametrize("bad", [False, True], ids=["in_range", "bad_rows"])
@pytest.mark.parametrize("n", RANKS)
def test_distributed_dense_aggregate_matches_the_reference_in_one_merge(n, bad, monkeypatch):
    rng = np.random.default_rng(60 + n)
    rows = 256 * n
    cols = {"f": rng.integers(0, 3, rows).astype(np.int64),
            "s": rng.integers(0, 2, rows).astype(np.int64),
            "q": rng.integers(-2**62, 2**62, rows),
            "p": rng.normal(size=rows) * 1e3,
            "i": rng.integers(-2**31, 2**31 - 1, rows).astype(np.int32)}
    mask = rng.random(rows) < 0.9
    if bad:  # a live row outside the declared key range: the overflow flag
        cols["f"][rows // 2], mask[rows // 2] = 7, True
    specs = [("q", "sum"), ("q", "count"), ("p", "min"), ("p", "max"), ("p", "sum"),
             ("i", "sum"), ("i", "max")]
    ranges, domain = ((0, 2), (0, 1)), 6
    reduces = []
    real = TC.reduce_columns

    def counted(columns, hows, mesh):
        reduces.append(len(columns[0]))
        return real(columns, hows, mesh)

    monkeypatch.setattr(TC, "reduce_columns", counted)
    run = distributed_dense_aggregate(_tmesh(n), lambda c, m: (c, m), ["f", "s"], specs,
                                      ranges, domain)
    jmesh = j_make_mesh(n)
    jrun = j_dense_aggregate(jmesh, lambda c, m: (c, m), ["f", "s"], specs, ranges, domain)
    got = run(*_tsharded(cols, mask, _tmesh(n)))
    want = jrun({k: _jplace(jmesh, v) for k, v in cols.items()}, _jplace(jmesh, mask))
    assert reduces == [len(specs) + 2]  # one collective: every state, exists and bad
    assert bool(got[3]) == bad
    _compare_states(got, want, rtol_cols=(4,))


# --------------------------------------------------------------------------
# tests/test_parallel.py's five cases, port against reference
# --------------------------------------------------------------------------


def _j_shuffle(n, vals, dest, mask, cap):
    mesh = j_make_mesh(n)
    prog = jax.jit(jax.shard_map(
        lambda c, d, m: j_shuffle_rows(c, d, m, PART_AXIS, n, cap), mesh=mesh,
        in_specs=({"v": P(PART_AXIS)}, P(PART_AXIS), P(PART_AXIS)),
        out_specs=({"v": P(PART_AXIS)}, P(PART_AXIS), P(PART_AXIS))))
    rc, rm, ovf = prog({"v": _jplace(mesh, vals)}, _jplace(mesh, dest), _jplace(mesh, mask))
    return np.asarray(rc["v"]), np.asarray(rm), np.asarray(ovf)


def _t_shuffle(n, vals, dest, mask, cap):
    mesh = _tmesh(n)

    def per_shard(cols, d, m):
        return (yield from shuffle_rows(cols, d, m, n, cap))

    args = [({"v": v}, d, m) for v, d, m in zip(shard_rows(_t(vals), mesh),
                                               shard_rows(_t(dest), mesh),
                                               shard_rows(_t(mask), mesh, fill=False))]
    outs = _run_ranks(per_shard, mesh, args)
    return (np.concatenate([o[0]["v"].numpy() for o in outs]),
            np.concatenate([o[1].numpy() for o in outs]),
            np.concatenate([o[2].numpy() for o in outs]))


@pytest.mark.parametrize("n", RANKS)
def test_shuffle_rows_matches_the_reference_row_for_row(n):
    rng = np.random.default_rng(42)
    rows = 128 * n
    vals = rng.permutation(rows).astype(np.int64)  # unique: routing is checkable
    dest = rng.integers(0, n, rows).astype(np.int32)
    mask = rng.random(rows) < 0.8
    got = _t_shuffle(n, vals, dest, mask, 128)
    want = _j_shuffle(n, vals, dest, mask, 128)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert not got[2].any()
    np.testing.assert_array_equal(np.sort(got[0][got[1]]), np.sort(vals[mask]))
    # rows for destination d land on rank d
    val_to_dest = {int(v): int(d) for v, d, m in zip(vals, dest, mask) if m}
    for rank, (rv, rm) in enumerate(zip(got[0].reshape(n, -1), got[1].reshape(n, -1))):
        assert all(val_to_dest[int(v)] == rank for v in rv[rm])


@pytest.mark.parametrize("n", RANKS)
def test_shuffle_overflow_flags_match_the_reference(n):
    rows = 64 * n
    vals = np.arange(rows, dtype=np.int64)
    dest = np.zeros(rows, dtype=np.int32)  # every row to rank 0
    mask = np.ones(rows, dtype=bool)
    got = _t_shuffle(n, vals, dest, mask, 8)
    want = _j_shuffle(n, vals, dest, mask, 8)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[2].any()


def _compare_states(got, want, rtol_cols=()):
    """(keys, vals, mask, overflow): every rank's rows, in rank order."""
    (tk, tv, tm, to), (jk, jv, jm, jo) = got, want
    assert bool(to) == bool(np.asarray(jo).any())
    np.testing.assert_array_equal(_cat(tm), np.asarray(jm))
    live = np.asarray(jm)
    for a, b in zip(tk, jk):
        np.testing.assert_array_equal(_cat(a)[live], np.asarray(b)[live])
    for i, (a, b) in enumerate(zip(tv, jv)):
        if i in rtol_cols:
            np.testing.assert_allclose(_cat(a)[live], np.asarray(b)[live], rtol=1e-12)
        else:
            np.testing.assert_array_equal(_cat(a)[live], np.asarray(b)[live])


def _grouped_case(n, rows_per_rank, n_groups, skew, seed):
    rng = np.random.default_rng(seed)
    rows = rows_per_rank * n
    g = rng.integers(0, n_groups, rows).astype(np.int64)
    if skew:  # ~25% of the rows pile into group 0
        g = np.where(rng.random(rows) < 0.25, 0, g)
    x = rng.integers(1, 100, rows).astype(np.int64)
    mask = rng.random(rows) < 0.9
    return {"g": g, "x": x}, mask


@pytest.mark.parametrize("n", RANKS)
def test_distributed_aggregate_matches_the_reference(n):
    cols, mask = _grouped_case(n, 512, 23, False, 1)
    specs = [("x", "sum"), ("x", "count"), ("x", "min")]
    run = distributed_grouped_aggregate(_tmesh(n), ["g"], specs, partial_capacity=64,
                                        final_capacity=16)
    jmesh = j_make_mesh(n)
    jrun = j_grouped_aggregate(jmesh, ["g"], specs, partial_capacity=64, final_capacity=16)
    got = run(*_tsharded(cols, mask, _tmesh(n)))
    want = jrun({k: _jplace(jmesh, v) for k, v in cols.items()}, _jplace(jmesh, mask))
    _compare_states(got, want)
    if n > 1:  # one rank's 16 final slots cannot hold the 23 groups: both flag it
        assert _cat(got[2]).sum() == len(np.unique(cols["g"][mask]))
    else:
        assert bool(got[3])


@pytest.mark.parametrize("n", RANKS)
def test_distributed_filter_aggregate_q1_shape_matches_the_reference(n):
    rng = np.random.default_rng(2)
    rows = 256 * n
    cols = {"flag": rng.integers(0, 3, rows).astype(np.int64),
            "status": rng.integers(0, 2, rows).astype(np.int64),
            "qty": rng.integers(1, 50, rows).astype(np.float64),
            "price": rng.random(rows) * 1000,
            "ship": rng.integers(0, 2500, rows).astype(np.int32)}
    mask = np.ones(rows, dtype=bool)
    specs = [("qty", "sum"), ("disc_price", "sum"), ("qty", "count")]

    def tfilt(c, m):
        c = dict(c)
        c["disc_price"] = c["price"] * 0.95
        return c, m & (c["ship"] <= 2000)

    def jfilt(c, m):
        c = dict(c)
        c["disc_price"] = c["price"] * 0.95
        return c, m & (c["ship"] <= 2000)

    run = distributed_filter_aggregate(_tmesh(n), tfilt, ["flag", "status"], specs,
                                       partial_capacity=16, final_capacity=8)
    jmesh = j_make_mesh(n)
    jrun = j_filter_aggregate(jmesh, jfilt, ["flag", "status"], specs, partial_capacity=16,
                              final_capacity=8)
    got = run(*_tsharded(cols, mask, _tmesh(n)))
    want = jrun({k: _jplace(jmesh, v) for k, v in cols.items()}, _jplace(jmesh, mask))
    _compare_states(got, want, rtol_cols=(0, 1))


@pytest.mark.parametrize("factor", [0.5, 2.0], ids=["tight_overflows", "retry_fits"])
def test_distributed_aggregate_at_scale_with_skew_matches_the_reference(factor):
    n = 8
    cols, mask = _grouped_case(n, 131_072, 60_000, True, 5)
    specs = [("x", "sum"), ("x", "count")]
    run = distributed_grouped_aggregate(_tmesh(n), ["g"], specs, partial_capacity=1 << 16,
                                        final_capacity=1 << 14, skew_factor=factor)
    jmesh = j_make_mesh(n)
    jrun = j_grouped_aggregate(jmesh, ["g"], specs, partial_capacity=1 << 16,
                               final_capacity=1 << 14, skew_factor=factor)
    got = run(*_tsharded(cols, mask, _tmesh(n)))
    want = jrun({k: _jplace(jmesh, v) for k, v in cols.items()}, _jplace(jmesh, mask))
    assert bool(got[3]) == (factor < 1)
    if factor < 1:  # overflowed: the host re-runs; only the flag is defined
        assert bool(np.asarray(want[3]).any())
        return
    _compare_states(got, want)
    assert _cat(got[2]).sum() == len(np.unique(cols["g"][mask]))


# --------------------------------------------------------------------------
# dryrun_multichip
# --------------------------------------------------------------------------


def test_dryrun_multichip_matches_the_references_sections(capsys):
    import __graft_entry__ as g
    from arrow_ballista_tpu_torch import entry

    g._dryrun_impl(8)
    want = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("[dryrun]")]
    got = entry.dryrun_multichip(8, device="cpu")
    assert set(got) == {"ok", "skipped", "n_devices", "sections"}
    assert got["ok"] and not got["skipped"] and got["n_devices"] == 8
    assert len(want) == 5 and got["sections"] == want


# --------------------------------------------------------------------------
# the API repairs: root exports, the card by default, the stage metric fold
# --------------------------------------------------------------------------

ROOT_NAMES = ["BOOL", "DATE32", "FLOAT32", "FLOAT64", "INT32", "INT64", "STRING", "DataType",
              "Field", "Schema", "decimal", "ColumnBatch", "concat_batches", "BallistaConfig",
              "BallistaContext", "__version__"]


def test_root_exports_the_references_names_from_the_ports_own_modules():
    import arrow_ballista_tpu as jab
    import arrow_ballista_tpu_torch as tab
    from arrow_ballista_tpu_torch import ColumnBatch, Schema, concat_batches, decimal  # noqa: F401

    for name in ROOT_NAMES:
        j, t = getattr(jab, name), getattr(tab, name)
        if name == "__version__":
            assert t == j
            continue
        assert getattr(t, "__module__", "").startswith("arrow_ballista_tpu_torch") or \
            type(t).__module__.startswith("arrow_ballista_tpu_torch"), name
    assert str(tab.decimal(2)) == str(jab.decimal(2)) and tab.INT64.kind == jab.INT64.kind


def test_planner_and_scan_budget_default_to_the_card():
    from arrow_ballista_tpu_torch.catalog import SchemaCatalog
    from arrow_ballista_tpu_torch.scheduler.physical_planner import PhysicalPlanner
    from arrow_ballista_tpu_torch.utils import table_cache
    from arrow_ballista_tpu_torch.utils.config import BallistaConfig

    cat, cfg = SchemaCatalog(), BallistaConfig()
    if torch.cuda.is_available():
        assert PhysicalPlanner(cat, cfg).device.type == "cuda"
        assert table_cache.resolve_budget("auto") == table_cache.DEFAULT_BUDGET
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PhysicalPlanner(cat, cfg)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            table_cache.resolve_budget("auto")
    assert PhysicalPlanner(cat, cfg, "cpu").device.type == "cpu"
    assert table_cache.resolve_budget("auto", "cpu") == table_cache.DEFAULT_BUDGET_CPU
    assert table_cache.resolve_budget("12345") == 12345 and table_cache.resolve_budget(0) == 0


def _stage_fold(cls, infos):
    """``cls.operator_metrics`` / ``aggregate_metrics`` over task infos
    (the fold reads nothing of a stage but its task infos)."""
    from types import SimpleNamespace

    stage = SimpleNamespace(task_infos=infos)
    stage.operator_metrics = lambda: cls.operator_metrics(stage)
    return cls.operator_metrics(stage), cls.aggregate_metrics(stage)


def test_stage_metric_fold_matches_the_reference_on_the_same_statuses():
    """Last snapshot per plan instance (executor), summed across
    instances; a status of another attempt than the recorded winner's
    (a cancelled speculative loser) adds nothing."""
    from types import SimpleNamespace as NS

    from arrow_ballista_tpu.scheduler.execution_graph import ExecutionStage as JStage
    from arrow_ballista_tpu_torch.scheduler.execution_graph import ExecutionStage as TStage

    def info(executor, attempt, status_attempt, metrics):
        status = NS(task=NS(task_attempt=status_attempt), metrics=metrics)
        return NS(status=status, attempt=attempt, executor_id=executor)

    infos = [
        info("e1", 0, 0, {"0:ShuffleWriterExec": {"output_rows": 10.0, "write_time": 0.5}}),
        info("e1", 0, 0, {"0:ShuffleWriterExec": {"output_rows": 25.0, "write_time": 0.9},
                          "0.0:HashAggregateExec": {"clustered_early_filters": 2.0}}),
        info("e2", 0, 0, {"0:ShuffleWriterExec": {"output_rows": 7.0, "write_time": 0.2}}),
        info("e2", 1, 0, {"0:ShuffleWriterExec": {"output_rows": 1000.0}}),  # a loser's status
        NS(status=None, attempt=0, executor_id="e3"),
        None,
    ]
    j_ops, j_flat = _stage_fold(JStage, infos)
    t_ops, t_flat = _stage_fold(TStage, infos)
    assert t_ops == j_ops and t_flat == j_flat
    assert t_flat["0:ShuffleWriterExec.output_rows"] == 32.0
    assert t_flat["0.0:HashAggregateExec.clustered_early_filters"] == 2.0


def test_clustered_q18_aggregate_metrics_match_the_reference(tmp_path):
    """Every counter both standalone engines record eagerly (scan, shuffle
    and clustered counters; not the timers, the reference's device
    counters, or its weakref-deferred operator row counts, ROADMAP.md
    queue 3) folds to the same stage totals."""
    import os

    import pyarrow.parquet as pq

    import arrow_ballista_tpu as jab
    import arrow_ballista_tpu_torch as tab
    from benchmarks.datagen import generate_tables
    from benchmarks.queries import QUERIES
    from benchmarks.tpch import decimal_to_int64_storage

    tables = generate_tables(0.01, seed=0)
    names = ("lineitem", "orders", "customer")
    for n in names:
        pq.write_table(decimal_to_int64_storage(tables[n]), str(tmp_path / f"{n}.parquet"),
                       row_group_size=8192)
    sql = QUERIES[18].replace("> 300", "> 200")
    folds = {}
    for key, pkg, kw in (("jax", jab, {}), ("torch", tab, {"device": "cpu"})):
        ctx = pkg.BallistaContext.standalone(
            pkg.BallistaConfig({"ballista.shuffle.partitions": "4"}), concurrent_tasks=4, **kw)
        try:
            for n in names:
                ctx.register_parquet(n, os.path.join(str(tmp_path), f"{n}.parquet"))
            assert len(ctx.sql(sql).to_pandas()) > 0
            sched = ctx._standalone.scheduler
            graph = sched.jobs.get_graph(list(sched.jobs._status)[-1])
            folds[key] = {sid: st.aggregate_metrics() for sid, st in graph.stages.items()}
        finally:
            ctx.shutdown()

    def eager(k):
        return (k.endswith((".clustered_early_filters", "ShuffleWriterExec.input_rows",
                            "ShuffleWriterExec.output_rows", "ScanExec.output_rows",
                            "ShuffleReaderExec.output_rows")))

    assert folds["torch"].keys() == folds["jax"].keys()
    early = 0
    for sid, j in folds["jax"].items():
        t = folds["torch"][sid]
        assert {k: v for k, v in t.items() if eager(k)} == {k: v for k, v in j.items() if eager(k)}
        early += sum(v for k, v in t.items() if k.endswith("clustered_early_filters"))
    assert early > 0  # the clustered rewrite engaged
