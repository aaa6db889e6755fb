"""The port's adaptive passthrough partial (K15 ``passthrough_rows``)
against the JAX package's, on the CPU.

- the reference's ``test_partial_agg_passthrough_activates_for_siblings``
  on the port, interpreted and fused: a partial aggregate (or a fused
  aggregate chain) that barely reduces a 2^17-row partition latches per-row
  states once the task's metrics snapshot resolves the deferred probe; the
  sibling partition then emits per-row states; rows and the latch equal
  the JAX package's;
- a latched aggregate no longer fuses (the fuse verdict), and the
  reservation protocol skips it;
- K15's twin equals the reference's per-row states (NULL keys and values:
  the sentinel for sum/min/max, 0/1 for count), and its generated source,
  compiled by g++ as tests/test_torch_fused.py does, equals the twin bit
  for bit;
- in the standalone engine a poorly reducing GROUP BY latches on the first
  task and merges to the same rows as the JAX package's.  The JAX
  package's standalone engine never latches: its probe reads the count
  through a weakref to a batch the shuffle writer has dropped by the time
  of the task's metrics snapshot (ROADMAP.md queue 3); the port's probe
  reads the count the writer made known.
"""
import shutil

import numpy as np
import pandas as pd
import pyarrow as pa
import pytest
import torch

import arrow_ballista_tpu as jab
from arrow_ballista_tpu.compile.fused import FusedStageExec as JFused
from arrow_ballista_tpu.models import expr as JE
from arrow_ballista_tpu.models import schema as JS
from arrow_ballista_tpu.ops import operators as JO
from arrow_ballista_tpu.ops.physical import MemoryScanExec as JScan
from arrow_ballista_tpu.ops.physical import TaskContext as JContext
from arrow_ballista_tpu_torch import BallistaConfig as TConfig
from arrow_ballista_tpu_torch import BallistaContext as TContext
from arrow_ballista_tpu_torch.compile import fused as F
from arrow_ballista_tpu_torch.compile.fuse import CompilePolicy, _op_verdict
from arrow_ballista_tpu_torch.models import expr as TE
from arrow_ballista_tpu_torch.models import schema as TS
from arrow_ballista_tpu_torch.ops import operators as TO
from arrow_ballista_tpu_torch.ops.physical import MemoryScanExec as TScan
from arrow_ballista_tpu_torch.ops.physical import TaskContext as TContextT
from tests.test_torch_fused import _gxx_library, _host_rows
from tests.torch_cases import assert_frames_equal, plan_nodes

torch.set_num_threads(1)
CPU = torch.device("cpu")
N = 1 << 18  # 2 partitions x 2^17 rows: the large-input threshold each


def _table(null_rows=False, seed=5, n=N):
    rng = np.random.default_rng(seed)
    v = rng.integers(-50, 50, n)
    x = rng.random(n)
    k2 = rng.integers(0, 3, n).astype(np.int32)
    cols = {"k": pa.array(np.arange(n), type=pa.int64()),
            "k2": pa.array(k2, type=pa.int32()),
            "v": pa.array(v, type=pa.int64()),
            "x": pa.array(x, type=pa.float64())}
    if null_rows:
        nv = rng.random(n) < 0.1
        cols["k2"] = pa.array(np.where(rng.random(n) < 0.1, None, k2), type=pa.int32())
        cols["v"] = pa.array(np.where(nv, None, v), type=pa.int64())
        cols["x"] = pa.array(np.where(rng.random(n) < 0.1, None, x), type=pa.float64())
    return pa.table(cols)


def _agg(pkg, table, fused=False):
    S, E, O = (JS, JE, JO) if pkg == "jax" else (TS, TE, TO)
    nullable = table.column("v").null_count > 0
    schema = S.Schema([S.Field("k", S.INT64, False), S.Field("k2", S.INT32, nullable),
                       S.Field("v", S.INT64, nullable), S.Field("x", S.FLOAT64, nullable)])
    scan = (JScan if pkg == "jax" else TScan)(schema, table, partitions=2)
    inp = scan
    if fused:
        inp = O.FilterExec(scan, E.BinOp(">=", E.Column("k"), E.Lit(0)))
    aggs = [O.AggSpec("sum", E.Column("v"), "s"), O.AggSpec("count", None, "n"),
            O.AggSpec("count", E.Column("v"), "nv"), O.AggSpec("min", E.Column("x"), "lo"),
            O.AggSpec("max", E.Column("v"), "hi")]
    agg = O.HashAggregateExec(inp, [(E.Column("k"), "k"), (E.Column("k2"), "k2")], aggs,
                              mode="partial")
    if not fused:
        return agg, agg
    return agg, (JFused if pkg == "jax" else F.FusedStageExec)([agg, inp])


def _frame(batches):
    return pd.concat([b.to_pandas() for b in batches], ignore_index=True)


def _run_siblings(pkg, table, fused):
    agg, top = _agg(pkg, table, fused)
    ctx = JContext() if pkg == "jax" else TContextT(device=CPU)
    out0 = top.execute(0, ctx)
    for b in out0:  # the packed copy makes the count host-known
        b.compacted_numpy()
    top.metrics().to_dict()  # the task's metrics snapshot resolves the probe
    latched = bool(getattr(agg, "_passthrough", False))
    out1 = top.execute(1, ctx)
    return agg, top, latched, _frame(out0), _frame(out1)


@pytest.mark.parametrize("nulls", [False, True], ids=["plain", "nulls"])
@pytest.mark.parametrize("fused", [False, True], ids=["interpreted", "fused"])
def test_partial_agg_passthrough_activates_for_siblings(fused, nulls):
    table = _table(nulls)
    agg, top, latched, f0, f1 = _run_siblings("torch", table, fused)
    jagg, jtop, jlatched, j0, j1 = _run_siblings("jax", table, fused)
    assert latched and jlatched, "all-distinct keys on 2^17 rows must latch"
    assert agg.metrics().to_dict().get("passthrough_partials", 0) == 1
    if fused:
        assert top._fallback and jtop._fallback
        assert top.metrics().to_dict()["fused_passthrough_fallbacks"] == 1
    # the first partition aggregated, the second emitted per-row states:
    # the same rows, key order in the first, input order in the second
    assert_frames_equal(f0, j0)
    assert_frames_equal(f1, j1)
    assert len(f0) + len(f1) == N


def test_no_latch_below_the_row_threshold_or_on_good_reduction():
    small = _table().slice(0, (1 << 17) - 2)
    agg, _top, latched, *_ = _run_siblings("torch", small, False)
    assert not latched
    rng = np.random.default_rng(2)
    few = pa.table({"k": pa.array(rng.integers(0, 100, N), type=pa.int64()),
                    "k2": pa.array(np.zeros(N, dtype=np.int32)),
                    "v": pa.array(np.ones(N, dtype=np.int64)),
                    "x": pa.array(np.ones(N))})
    agg, _top, latched, *_ = _run_siblings("torch", few, False)
    assert not latched
    assert TO.poor_reduction(None, 1 << 17, 80_000) and not TO.poor_reduction(
        1 << 17, 1 << 18, 70_000)


def test_a_latched_aggregate_does_not_fuse():
    agg, _ = _agg("torch", _table(), fused=True)
    ok, _why = _op_verdict(CompilePolicy(), agg)
    assert ok
    agg._passthrough = True
    ok, why = _op_verdict(CompilePolicy(), agg)
    assert not ok and "passthrough" in why


def test_passthrough_twin_equals_the_reference_states():
    """K15's twin on one partition of NULL keys and values, against the
    JAX package's ``_execute_passthrough`` on the same partition."""
    table = _table(null_rows=True)
    tagg, _ = _agg("torch", table)
    jagg, _ = _agg("jax", table)
    tagg._passthrough = jagg._passthrough = True
    got = _frame(tagg.execute(1, TContextT(device=CPU)))
    want = _frame(jagg.execute(1, JContext()))
    assert_frames_equal(got, want)
    assert got["s"].isna().any() and got["k2"].isna().any()


@pytest.mark.skipif(shutil.which("g++") is None, reason="no g++ on the PATH")
@pytest.mark.parametrize("nulls", [False, True], ids=["plain", "nulls"])
def test_generated_passthrough_source_compiled_by_gxx_equals_the_twin(nulls, tmp_path):
    agg, _ = _agg("torch", _table(nulls))
    ctx = TContextT(device=CPU)
    prog = F.PassthroughProgram(agg, ctx)
    assert "AB_FUSED_ROWS_ENTRY" in prog.gen.source
    lib = _gxx_library(prog.gen.source, tmp_path)
    batch = agg.input.execute(0, ctx)[0]
    aux = prog.compiled[0].aux_arrays(batch.dicts)
    want = F.passthrough_rows_plain(prog, batch.columns, batch.mask, aux)
    n = batch.mask.shape[0]
    outs, _ = _host_rows(lib, prog, batch.columns, batch.mask, [aux])
    # the keys and every state that is an input column of its type are
    # that column, in the twin too; the kernel writes the rest
    want_aliases = {"k": "k", "k2": "k2"} if nulls else \
        {"k": "k", "k2": "k2", "s": "v", "lo": "x", "hi": "v"}
    assert prog.aliases == want_aliases
    for name, column in prog.aliases.items():
        assert want[name] is batch.columns[column], name
    assert [name for name, _dt in prog.gen.outputs] == \
        [name for name in want if name not in want_aliases]
    for (name, _dt), g in zip(prog.gen.outputs, outs):
        w = want[name].expand(n)
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g.numpy(), w.numpy(), err_msg=name)


SA_SQL = "select k, k2, sum(v) as s, count(*) as n, min(x) as lo from t group by k, k2"


def _sa_run(pkg, table, partitions, runs=1):
    """[(sorted frame, passthrough metrics)] of ``runs`` runs of SA_SQL in
    one standalone context (each run is a new job with its own plan)."""
    conf = {"ballista.shuffle.partitions": str(partitions)}
    if pkg == "jax":
        ctx = jab.BallistaContext.standalone(jab.BallistaConfig(conf), concurrent_tasks=1)
    else:
        ctx = TContext.standalone(TConfig(conf), concurrent_tasks=1, device="cpu")
    out = []
    try:
        ctx.register_table("t", table)
        for _ in range(runs):
            df = ctx.sql(SA_SQL).to_pandas()
            graph = ctx._standalone.scheduler.jobs.get_graph(ctx._standalone.last_job_id)
            metrics = {}
            for st in graph.stages.values():
                for node in plan_nodes(st.resolved_plan or st.plan):
                    for op in [node, *getattr(node, "ops", [])[:1]]:  # a fused chain's head
                        for k, v in op.metrics().to_dict().items():
                            if k in ("passthrough_partials", "fused_passthrough_fallbacks"):
                                metrics[k] = metrics.get(k, 0) + v
            out.append((df.sort_values(["k", "k2"]).reset_index(drop=True), metrics))
        return out
    finally:
        ctx.shutdown()


def test_standalone_latches_on_the_first_task_and_merges_to_the_same_rows():
    """One task slot: the first map task's snapshot latches the fused
    stage, so the later tasks run the interpreted aggregate's per-row
    states (K15's twin here)."""
    table = _table(null_rows=True, n=3 * (1 << 17) + 30)
    [(want, jmetrics)] = _sa_run("jax", table, 3)
    assert not jmetrics, jmetrics
    # a second job reuses the first one's fused program, and still latches
    # its own aggregate
    for got, metrics in _sa_run("torch", table, 3, runs=2):
        assert_frames_equal(got, want)
        assert metrics == {"fused_passthrough_fallbacks": 1, "passthrough_partials": 2}, metrics
