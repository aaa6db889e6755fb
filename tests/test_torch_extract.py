"""EXTRACT in the port (K14 ``extract_field``) against the JAX package's,
on the CPU.

- ``extract_field_plain`` (K14's twin) and the host-mode numpy EXTRACT
  equal the JAX package's ``extract_field`` exactly on the edge days: days
  spanning 1900-2100, the leap days of 1900 (none), 2000 and 2100 (none),
  negative days and the int32-minimum NULL sentinel, whose garbage year
  the reference computes with a floor division;
- K14's C body (csrc/civil.cuh), compiled by the host's g++, equals the
  twin on the same days;
- the civil core's 32-bit form after the era: the header under g++ and the
  twin equal the JAX package's ``extract_field`` at every era boundary in
  the int32 range (k * 146097 - 719468 + {-1, 0, 1}, every 100th era), at
  the first and last 65,536 int32 days and at 200,000 seeded days;
- a fused chain with EXTRACT: its generated source calls the header, and
  compiled by g++ (as tests/test_torch_fused.py does) equals the twin bit
  for bit;
- TPC-H q7, q8 and q9 at SF0.01 equal the JAX package's local and
  standalone engines; the standalone runs have the same stages and fused
  chains, and EXTRACT is traced into the generated sources.
"""
import ctypes
import shutil

import numpy as np
import pytest
import torch

import arrow_ballista_tpu as jab
import arrow_ballista_tpu_torch as tab
from arrow_ballista_tpu.ops import kernels as JK
from arrow_ballista_tpu_torch.compile import fused as F
from arrow_ballista_tpu_torch.models import expr as TE
from arrow_ballista_tpu_torch.ops import kernels as TK
from arrow_ballista_tpu_torch.ops import operators as TO
from arrow_ballista_tpu_torch.ops.expressions import NumpyOps
from arrow_ballista_tpu_torch.ops.physical import TaskContext
from benchmarks.queries import QUERIES
from tests.test_torch_fused import _bits, _gxx_library, _host_rows
from tests.torch_cases import (STANDALONE_SETTINGS, assert_frames_equal, edge_days, era_days,
                               fused_labels, hand_table, plan_nodes, stage_summary)

torch.set_num_threads(1)
CPU = torch.device("cpu")
FIELDS = ["year", "month", "day"]


def _jax(days, field):
    import jax.numpy as jnp

    return np.asarray(JK.extract_field(jnp.asarray(days), field))


@pytest.mark.parametrize("field", FIELDS)
def test_extract_twin_equals_the_reference_on_the_edge_days(field):
    days = edge_days()
    want = _jax(days, field)
    got = TK.extract_field(torch.from_numpy(days), field)  # the twin, on the CPU
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(NumpyOps.extract_field(days, field), want)


def test_the_null_sentinel_gives_the_reference_garbage_date():
    null = torch.tensor([-(2 ** 31)], dtype=torch.int32)
    got = [int(TK.extract_field_plain(null, f)[0]) for f in FIELDS]
    assert got == [-5877641, 6, 23]


def test_extract_of_a_bad_field_raises():
    with pytest.raises(ValueError):
        TK.extract_field(torch.zeros(3, dtype=torch.int32), "hour")


SHIM = """#include "civil.cuh"
extern "C" void civil_host(const int* days, long long n, int field, int* out) {
  for (long long i = 0; i < n; ++i) out[i] = ab_civil_field(days[i], field);
}
"""


@pytest.mark.skipif(shutil.which("g++") is None, reason="no g++ on the PATH")
@pytest.mark.parametrize("field", FIELDS)
def test_civil_header_compiled_by_gxx_equals_the_twin(field, tmp_path):
    lib = _gxx_library(SHIM, tmp_path)
    days = edge_days()
    out = np.zeros_like(days)
    lib.civil_host(days.ctypes.data_as(ctypes.c_void_p), ctypes.c_longlong(len(days)),
                   ctypes.c_int(TK.EXTRACT_FIELDS[field]), out.ctypes.data_as(ctypes.c_void_p))
    np.testing.assert_array_equal(out, TK.extract_field_plain(torch.from_numpy(days),
                                                              field).numpy())


@pytest.mark.parametrize("field", FIELDS)
def test_extract_twin_equals_the_reference_on_the_era_days(field):
    days = era_days()
    got = TK.extract_field(torch.from_numpy(days), field)
    np.testing.assert_array_equal(got.numpy(), _jax(days, field))


@pytest.mark.skipif(shutil.which("g++") is None, reason="no g++ on the PATH")
@pytest.mark.parametrize("field", FIELDS)
def test_civil_header_compiled_by_gxx_equals_the_reference_on_the_era_days(field, tmp_path):
    lib = _gxx_library(SHIM, tmp_path)
    days = era_days()
    out = np.zeros_like(days)
    lib.civil_host(days.ctypes.data_as(ctypes.c_void_p), ctypes.c_longlong(len(days)),
                   ctypes.c_int(TK.EXTRACT_FIELDS[field]), out.ctypes.data_as(ctypes.c_void_p))
    np.testing.assert_array_equal(out, _jax(days, field))


def _extract_chain(agg: bool):
    """hand_table's scan under a projection of EXTRACT(year/month/day) of a
    nullable date (and, with ``agg``, a partial aggregate grouped on the
    year)."""
    import pyarrow as pa

    table = hand_table()
    rng = np.random.default_rng(9)
    days = np.concatenate([edge_days(), rng.integers(-30000, 50000, table.num_rows)])
    days = days[: table.num_rows].astype(np.int32)
    nulls = rng.random(table.num_rows) < 0.1
    table = table.append_column("day", pa.array(np.where(nulls, None, days),
                                                type=pa.int32()).cast(pa.date32()))
    scan = tab.catalog.MemoryTable("t", table).scan(None, [], 2)
    proj = TO.ProjectionExec(scan, [(TE.Extract("year", TE.Column("day")), "y"),
                                    (TE.Extract("month", TE.Column("day")), "m"),
                                    (TE.Extract("day", TE.Column("day")), "dd"),
                                    (TE.Extract("year", TE.Column("d")), "y2"),
                                    (TE.Column("k"), "v")])
    if not agg:
        filt = TO.FilterExec(proj, TE.BinOp(">", TE.Column("m"), TE.Lit(2)))
        return [filt, proj]
    a = TO.HashAggregateExec(proj, [(TE.Column("y"), "y")],
                             [TO.AggSpec("sum", TE.Column("v"), "s"),
                              TO.AggSpec("max", TE.Column("dd"), "hi")], mode="partial")
    return [a, proj]


@pytest.mark.skipif(shutil.which("g++") is None, reason="no g++ on the PATH")
@pytest.mark.parametrize("agg", [False, True], ids=["rows", "agg"])
def test_extract_chain_compiled_by_gxx_equals_the_twin(agg, tmp_path):
    ops = _extract_chain(agg)
    ctx = TaskContext(device=CPU)
    stage = F.FusedStageExec(ops)
    prog = stage.program(ctx)
    assert "ab_civil_field(" in prog.gen.source
    lib = _gxx_library(prog.gen.source, tmp_path)
    checked = 0
    for p in range(stage.output_partition_count()):
        for batch in stage.input.execute(p, ctx):
            auxs, _dicts = prog.auxs_and_dicts(batch.dicts)
            outs, omask = _host_rows(lib, prog, batch.columns, batch.mask, auxs)
            if prog.agg is None:
                cols, mask = F.fused_rows_plain(prog, batch.columns, batch.mask, auxs)
                want = [cols[n] for n, _dt in prog.gen.outputs]
            else:
                keys, vals, mask = F._agg_key_vals_plain(prog, batch.columns, batch.mask, auxs)
                want = list(keys) + [v for v, _how in vals]
            assert torch.equal(omask, mask)
            for (name, _dt), g, w in zip(prog.gen.outputs, outs, want):
                assert torch.equal(_bits(g), _bits(w.expand(g.shape[0]))), name
            checked += int(mask.sum())
    assert checked > 0


# --------------------------------------------------------------------------
# q7, q8, q9 against the JAX package, both engines
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tables():
    from benchmarks.datagen import generate_tables

    return generate_tables(0.01, seed=0)


@pytest.fixture(scope="module")
def standalone(tables):
    made = {}
    for pkg in ("jax", "torch"):
        if pkg == "jax":
            c = jab.BallistaContext.standalone(jab.BallistaConfig(STANDALONE_SETTINGS),
                                               concurrent_tasks=4)
        else:
            c = tab.BallistaContext.standalone(tab.BallistaConfig(STANDALONE_SETTINGS),
                                               concurrent_tasks=4, device="cpu")
        for name, t in tables.items():
            c.register_table(name, t)
        made[pkg] = c
    yield made
    for c in made.values():
        c.shutdown()


@pytest.mark.parametrize("q", [7, 8, 9])
def test_local_engine_matches_the_reference(tables, q):
    jctx = jab.BallistaContext.local()
    tctx = tab.BallistaContext.local(device="cpu")
    for name, t in tables.items():
        jctx.register_table(name, t)
        tctx.register_table(name, t)
    got = tctx.sql(QUERIES[q]).to_pandas()
    assert len(got) > 0
    assert_frames_equal(got, jctx.sql(QUERIES[q]).to_pandas())


@pytest.mark.parametrize("q", [7, 8, 9])
def test_standalone_engine_matches_the_reference(standalone, q):
    def run(pkg):
        c = standalone[pkg]
        df = c.sql(QUERIES[q]).to_pandas()
        return df, c._standalone.scheduler.jobs.get_graph(c._standalone.last_job_id)

    want, jgraph = run("jax")
    got, tgraph = run("torch")
    assert_frames_equal(got, want)
    assert stage_summary(tgraph) == stage_summary(jgraph)
    assert fused_labels(tgraph) == fused_labels(jgraph)
    # each query's fused chain holds its EXTRACT: traced into the source
    sources = [n.program(TaskContext(device=CPU)).gen.source
               for st in tgraph.stages.values()
               for n in plan_nodes(st.resolved_plan or st.plan)
               if type(n).__name__ == "FusedStageExec"]
    assert any("ab_civil_field(" in s for s in sources), sources
