"""K19: the local engine's operator programs as generated kernels
(compile/programs.py), on the CPU.

- Every operator program of the 22 TPC-H queries at SF0.01 in the local
  engine traces (no ``CodegenError``), and its generated source, compiled
  by the host's g++ (``-ffp-contract=off -I csrc -x c++``, the host branch
  of ``csrc/fused_rows.cuh``, as tests/test_torch_fused.py builds K12) and
  driven over the same columns through ctypes, equals the program's twin
  bit for bit on every batch the query runs.
- Each program kind over a hand table with NULL strings and integers, NaN
  and wrapping products (a projection, a filter, a scan filter, aggregate
  operands, sort keys, a join residual, repartition keys) gives the JAX
  package's rows exactly, with the g++ build checked on every call.
- Tracing is deterministic, including programs that read a scalar
  subquery's value (q11, q15, q22), so a warm run finds every source
  built; an expression the tracer cannot emit raises ``CodegenError``
  when the plan is prepared.
"""
import collections
import contextlib
import ctypes
import hashlib
import shutil
import subprocess

import pytest
import torch

import arrow_ballista_tpu as jab
import arrow_ballista_tpu_torch as tab
from arrow_ballista_tpu_torch.client.context import extract_scalar
from arrow_ballista_tpu_torch.compile import fused as F
from arrow_ballista_tpu_torch.compile import programs as P
from arrow_ballista_tpu_torch.compile.codegen import CodegenError
from arrow_ballista_tpu_torch.models import expr as TE
from arrow_ballista_tpu_torch.ops import operators as TO
from arrow_ballista_tpu_torch.ops.physical import TaskContext
from arrow_ballista_tpu_torch.scheduler.physical_planner import PhysicalPlanner
from arrow_ballista_tpu_torch.sql.optimizer import optimize
from benchmarks.datagen import generate_tables
from benchmarks.queries import QUERIES
from tests.torch_cases import assert_frames_equal, hand_table

torch.set_num_threads(1)
CPU = torch.device("cpu")
CSRC = str(__import__("pathlib").Path(F.__file__).resolve().parent.parent / "csrc")
needs_gxx = pytest.mark.skipif(shutil.which("g++") is None, reason="no g++ on the PATH")


@pytest.fixture(scope="module")
def tables():
    return generate_tables(0.01, seed=0)


@pytest.fixture(scope="module")
def gxx(tmp_path_factory):
    """source -> the library g++ built from it (each source once)."""
    d = tmp_path_factory.mktemp("k19")
    built = {}

    def build(source):
        if source not in built:
            h = hashlib.sha256(source.encode()).hexdigest()[:16]
            cu, so = d / f"{h}.cu", d / f"lib{h}.so"
            cu.write_text(source)
            proc = subprocess.run(["g++", "-std=c++17", "-O1", "-shared", "-fPIC",
                                   "-ffp-contract=off", "-I", CSRC, "-x", "c++", str(cu),
                                   "-o", str(so)], capture_output=True, text=True)
            assert proc.returncode == 0, proc.stderr[:4000]
            built[source] = ctypes.CDLL(str(so))
        return built[source]

    return build


def _bits(t):
    if t.dtype == torch.float64:
        return t.view(torch.int64)
    if t.dtype == torch.float32:
        return t.view(torch.int32)
    return t


def _host_launch(lib, program, cols, mask, auxs):
    """The generated row function over every row, as the kernel runs it."""
    gen = program.gen
    n = mask.shape[0]
    fin, keep = F._FusedIn(), []
    for k, (name, dt) in enumerate(gen.inputs):
        t = cols[name].contiguous()
        assert t.dtype == dt, (name, t.dtype, dt)
        keep.append(t)
        fin.col[k] = t.data_ptr()
    m = mask.contiguous()
    keep.append(m)
    fin.mask = m.data_ptr()
    for k, (step, slot, dt) in enumerate(gen.aux):
        t = auxs[step][slot].contiguous()
        assert t.dtype == dt
        keep.append(t)
        fin.aux[k] = t.data_ptr()
        fin.aux_len[k] = t.shape[0]
    outs = [torch.empty(n, dtype=dt) for _name, dt in gen.outputs]
    omask = torch.empty(n, dtype=torch.bool)
    fout = F._FusedOut()
    for k, t in enumerate(outs):
        fout.col[k] = t.data_ptr()
    fout.mask = omask.data_ptr()
    lib.ab_fused_rows_host(ctypes.byref(fin), ctypes.byref(fout), ctypes.c_longlong(n))
    return outs, omask


@contextlib.contextmanager
def held_against_gxx(gxx):
    """Every K19 call also runs the g++ build of its source over the same
    inputs, which must equal the twin bit for bit; yields a Counter of the
    programs checked, by label."""
    checked = collections.Counter()
    kernel = P.operator_program

    def check(program, cols, mask, auxs):
        want = P.operator_program_plain(program, cols, mask, auxs)
        n = mask.shape[0]
        gen = program.gen
        if program.kind == "mask" or gen.outputs:
            outs, omask = _host_launch(gxx(gen.source), program, cols, mask, auxs)
            if program.kind == "mask":
                assert torch.equal(omask, want.expand(n)), program.label
            else:
                for (name, _dt), t in zip(gen.outputs, outs):
                    assert torch.equal(_bits(t), _bits(want[name].expand(n).contiguous())), \
                        (program.label, name)
        checked[program.label] += 1
        return want

    P.operator_program = check
    try:
        yield checked
    finally:
        P.operator_program = kernel


def _planned(ctx, sql):
    return PhysicalPlanner(ctx.catalog, ctx.config, CPU).plan_query(
        optimize(ctx.sql(sql).logical))


def _traced_sources(ctx, sql):
    """Every generated source of the query's plans, traced as the card's
    ``prepare`` traces them (scalar subqueries first)."""
    planned = _planned(ctx, sql)
    tctx = TaskContext(device=CPU, config=ctx.config, work_dir=ctx.work_dir, job_id="trace")
    sources = []
    for sid, splan in planned.scalars:
        sources += [p.gen.source for p in P.trace(splan, tctx) if p.launches()]
        tctx.scalars[sid] = extract_scalar(splan, tctx)
    sources += [p.gen.source for p in P.trace(planned.plan, tctx) if p.launches()]
    return sources


@needs_gxx
@pytest.mark.parametrize("q", range(1, 23))
def test_tpch_programs_trace_and_their_gxx_builds_equal_the_twins(tables, gxx, q):
    ctx = tab.BallistaContext.local(device="cpu")
    for name, t in tables.items():
        ctx.register_table(name, t)
    sources = _traced_sources(ctx, QUERIES[q])
    assert sources, "every TPC-H query reads a filter, a key or an operand"
    for s in sources:
        gxx(s)
    with held_against_gxx(gxx) as checked:
        frame = ctx.sql(QUERIES[q]).to_pandas()
    assert sum(checked.values()) > 0
    assert len(frame.columns) > 0


def test_tracing_is_deterministic_so_warm_runs_build_nothing(tables):
    """The same query traced twice gives the same sources, also where a
    program reads a scalar subquery's value (q11, q15, q22)."""
    ctx = tab.BallistaContext.local(device="cpu")
    for name, t in tables.items():
        ctx.register_table(name, t)
    for q in (1, 3, 11, 15, 22):
        first = _traced_sources(ctx, QUERIES[q])
        assert _traced_sources(ctx, QUERIES[q]) == first, q


# --------------------------------------------------------------------------
# each program kind against the JAX package
# --------------------------------------------------------------------------

def _null_strings(df):
    """NULL strings as one marker (None and NaN both read as NULL; NaN
    never equals itself)."""
    for c in df.columns:
        if df[c].dtype.kind not in "biufcmM":
            df[c] = df[c].astype(object).where(df[c].notna(), "<NULL>")
    return df


HAND_SQL = {
    "projection": ("select big, k, big * 3 as wrap, k % 7 as m7, k % -7 as mn7, "
                   "case when k > 100 then big else k end as pick, f <> 0.5 as fne, "
                   "d + interval '30' day as later, s from t order by big", "projection"),
    "filter": ("select k, s, f from (select k, s, f, k * 2 as k2 from t) x "
               "where s like 'a%' or (k2 > 10 and k % 3 <> 1) order by k, s, f",
               "filter"),
    "scan_filter": ("select big, k from t where k > 5 and s in ('beta', 'gamma') "
                    "order by big", "scan filter"),
    "agg_operands": ("select s, sum(k * 2) as sk, min(f) as mf, count(k) as ck, "
                     "max(big - k) as mb from t group by s order by s",
                     "aggregate operands (partial)"),
    "sort_keys": ("select k % 5 as km, big, s from t order by km desc, big", "sort keys"),
    "join_residual": ("select a.big, b.k from t a join t b on a.s = b.s "
                      "where a.k < b.k - 350 order by a.big, b.k", "join pair verification"),
    "shuffle_keys": ("select d, count(*) as n from t group by d order by d",
                     "repartition keys"),
}


@needs_gxx
@pytest.mark.parametrize("name", list(HAND_SQL))
def test_each_program_kind_equals_the_reference(gxx, name):
    sql, label = HAND_SQL[name]
    data = hand_table()
    jctx = jab.BallistaContext.local()
    tctx = tab.BallistaContext.local(device="cpu")
    jctx.register_table("t", data)
    tctx.register_table("t", data)
    want = jctx.sql(sql).to_pandas()
    with held_against_gxx(gxx) as checked:
        got = tctx.sql(sql).to_pandas()
    assert len(want) > 0
    assert checked[label] > 0, dict(checked)
    assert_frames_equal(_null_strings(got), _null_strings(want), exact=True)


# --------------------------------------------------------------------------
# the tracer's gaps raise when the plan is prepared
# --------------------------------------------------------------------------


def test_an_untraceable_expression_raises_codegen_error_when_the_plan_is_prepared():
    from arrow_ballista_tpu_torch.models.schema import INT64
    from arrow_ballista_tpu_torch.udf import GLOBAL_UDFS, register_udf

    ctx = tab.BallistaContext.local(device="cpu")
    ctx.register_table("t", hand_table())
    # a UDF's torch call has no generated code
    register_udf("neg_k19", lambda x: torch.neg(x), INT64)
    try:
        planned = _planned(ctx, "select neg_k19(big) as r from t")
        with pytest.raises(CodegenError, match="projection"):
            P.trace(planned.plan, TaskContext(device=CPU))
        # the CPU runs the twin: the same query answers there
        assert len(ctx.sql("select neg_k19(big) as r from t").to_pandas()) == 5000
    finally:
        GLOBAL_UDFS.deregister("neg_k19")
    # the tracer emits no negation of a bool
    scan = ctx.catalog.provider("t").scan(None, [], 1)
    bad = TO.FilterExec(scan, TE.BinOp("=", TE.Negate(TE.IsNull(TE.Column("k"))),
                                       TE.Lit(True)))
    with pytest.raises(CodegenError):
        P.trace(bad, TaskContext(device=CPU))


def test_prepare_traces_nothing_on_the_cpu():
    """The CPU runs the twins: ``prepare`` neither traces nor builds, so a
    plan with a tracer gap still runs there."""
    ctx = tab.BallistaContext.local(device="cpu")
    ctx.register_table("t", hand_table())
    scan = ctx.catalog.provider("t").scan(None, [], 1)
    bad = TO.FilterExec(scan, TE.BinOp("=", TE.Negate(TE.IsNull(TE.Column("k"))),
                                       TE.Lit(True)))
    assert P.prepare(bad, TaskContext(device=CPU)) == []
