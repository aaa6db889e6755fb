"""Whole-stage fusion of the port (K12 ``fused_rows``, K13 ``fused_agg``)
against the JAX package's ``FusedStageExec`` (the port on the CPU, JAX on
the CPU), and the generated C compiled by the host's g++.

Chains, taken from each package's own physical plan of the same SQL at
SF0.01: q1's ``HashAggregateExec <- RenameExec`` (the dense path), q18's
subquery partial on l_orderkey (the sort path), q18's HAVING and q21's
``ProjectionExec <- FilterExec``; plus a chain built by hand over a table
with NULL strings and integers, NaN, a string LIKE / IN / SUBSTRING, an
int64 product that wraps and ``%`` of negative numbers.

- ``fused_rows_plain`` / ``fused_agg_plain`` (what the port's fused stage
  runs on the CPU) equal the reference's fused program, which ran without
  falling back;
- the generated source is the same for every build of a chain;
- the generated row function, compiled by g++ and driven over the same
  numpy columns through ctypes, equals the twin bit for bit (skipped only
  when no g++ is on the PATH).
"""
import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from arrow_ballista_tpu.catalog import MemoryTable as JMemoryTable
from arrow_ballista_tpu.catalog import SchemaCatalog as JCatalog
from arrow_ballista_tpu.compile.fused import FusedStageExec as JFused
from arrow_ballista_tpu.models import expr as JE
from arrow_ballista_tpu.ops import operators as JO
from arrow_ballista_tpu.ops.physical import TaskContext as JContext
from arrow_ballista_tpu.scheduler.physical_planner import PhysicalPlanner as JPlanner
from arrow_ballista_tpu.sql.optimizer import optimize as joptimize
from arrow_ballista_tpu.sql.parser import parse_sql as jparse
from arrow_ballista_tpu.sql.planner import SqlToRel as JSqlToRel
from arrow_ballista_tpu.utils.config import BallistaConfig as JConfig
from arrow_ballista_tpu_torch.catalog import MemoryTable as TMemoryTable
from arrow_ballista_tpu_torch.catalog import SchemaCatalog as TCatalog
from arrow_ballista_tpu_torch.compile import fused as F
from arrow_ballista_tpu_torch.compile.fuse import CompilePolicy, _op_verdict
from arrow_ballista_tpu_torch.models import expr as TE
from arrow_ballista_tpu_torch.ops import kernels as TK
from arrow_ballista_tpu_torch.ops import operators as TO
from arrow_ballista_tpu_torch.ops.physical import TaskContext as TContext
from arrow_ballista_tpu_torch.scheduler.physical_planner import PhysicalPlanner as TPlanner
from arrow_ballista_tpu_torch.sql.optimizer import optimize as toptimize
from arrow_ballista_tpu_torch.sql.parser import parse_sql as tparse
from arrow_ballista_tpu_torch.sql.planner import SqlToRel as TSqlToRel
from arrow_ballista_tpu_torch.utils.config import BallistaConfig as TConfig
from tests.torch_cases import (FUSED_CHAINS, assert_frames_equal, find_chain, hand_chain,
                               hand_table)

torch.set_num_threads(1)
CPU = torch.device("cpu")
CSRC = str(__import__("pathlib").Path(F.__file__).resolve().parent.parent / "csrc")
SETTINGS = {"ballista.shuffle.partitions": "4"}


@pytest.fixture(scope="module")
def tables():
    from benchmarks.datagen import generate_tables

    return {**generate_tables(0.01, seed=0), "t": hand_table()}


def _plan(pkg, tables, sql):
    if pkg == "jax":
        cat = JCatalog()
        for name, t in tables.items():
            cat.register(JMemoryTable(name, t))
        return JPlanner(cat, JConfig(SETTINGS)).plan_query(
            joptimize(JSqlToRel(cat).plan(jparse(sql)))).plan
    cat = TCatalog()
    for name, t in tables.items():
        cat.register(TMemoryTable(name, t))
    return TPlanner(cat, TConfig(SETTINGS), CPU).plan_query(
        toptimize(TSqlToRel(cat).plan(tparse(sql)))).plan


def _chain(pkg, tables, name):
    sql, kind = FUSED_CHAINS[name]
    if sql is None:
        E, O = (JE, JO) if pkg == "jax" else (TE, TO)
        table = tables["t"]
        scan = (JMemoryTable if pkg == "jax" else TMemoryTable)("t", table).scan(None, [], 2)
        return hand_chain(E, O, scan)
    return find_chain(_plan(pkg, tables, sql), kind)


def _frames(batches):
    import pandas as pd

    frames = [b.to_pandas() for b in batches]
    return pd.concat(frames, ignore_index=True) if frames else pd.DataFrame()


def _nulls_marked(df):
    """NULL strings as a marker: object columns compare with ==."""
    import pandas as pd

    df = df.copy()
    for c in df.columns:
        if not (pd.api.types.is_numeric_dtype(df[c]) or pd.api.types.is_bool_dtype(df[c])):
            df[c] = df[c].astype(object).where(df[c].notna(), "<NULL>")
    return df


@pytest.mark.parametrize("name", list(FUSED_CHAINS))
def test_fused_twins_match_the_reference_fused_program(tables, name):
    jops, tops = _chain("jax", tables, name), _chain("torch", tables, name)
    assert [type(o).__name__ for o in jops] == [type(o).__name__ for o in tops]
    jf, tf = JFused(jops), F.FusedStageExec(tops)
    is_agg = type(tops[0]).__name__ == "HashAggregateExec"
    jctx, tctx = JContext(), TContext(device=CPU)
    for p in range(tf.output_partition_count()):
        want = _frames(jf.execute(p, jctx))
        got = _frames(tf.execute(p, tctx))
        # groups come out in key order, and filtered rows in input order
        assert_frames_equal(_nulls_marked(got), _nulls_marked(want))
    assert not jf.metrics().to_dict().get("fused_fallbacks")
    prog = tf.program(tctx)
    assert prog.launch_name == ("fused_agg" if is_agg else "fused_rows")
    if name == "q1_dense_agg":
        assert prog.gen.key_dtypes and len(prog.gen.vals) >= 6


def test_dense_and_sort_paths_are_the_ones_expected(tables):
    """q1's agg chain groups on dictionary codes (a dense domain: K13 in
    K1's body); q18's on l_orderkey (no range: K13's rows form, K4, K8)."""
    ctx = TContext(device=CPU)
    for name, dense in (("q1_dense_agg", True), ("q18_sort_agg", False)):
        tf = F.FusedStageExec(_chain("torch", tables, name))
        prog = tf.program(ctx)
        batch = tf.input.execute(0, ctx)[0]
        _auxs, dicts = prog.auxs_and_dicts(batch.dicts)
        ranges = prog.agg._key_ranges(prog.agg_compiled[1], dicts)
        assert (TK.dense_domain(ranges) is not None) == dense


@pytest.mark.parametrize("name", ["q1_dense_agg", "q18_having_rows", "hand_rows"])
def test_generated_source_is_deterministic(tables, name):
    sources = {F.FusedProgram(_chain("torch", tables, name), TContext(device=CPU)).gen.source
               for _ in range(3)}
    assert len(sources) == 1
    src = sources.pop()
    assert "AB_FUSED_ROWS_ENTRY(AbRow)" in src
    assert ("AB_FUSED_AGG_ENTRY" in src) == name.endswith("agg")


def test_an_operator_without_generated_code_stays_interpreted(tables):
    """A tracer gap is a plan-time doubt, recorded like the reference's."""
    scan = TMemoryTable("t", tables["t"]).scan(None, [], 1)
    udf_like = TO.FilterExec(scan, TE.BinOp(">", TE.Column("f"), TE.Column("f")))
    assert _op_verdict(CompilePolicy(), udf_like) == (True, None)
    # the tracer emits no negation of a bool (EXTRACT, the earlier example,
    # now traces into K14's row function)
    bad = TO.FilterExec(scan, TE.BinOp("=", TE.Negate(TE.IsNull(TE.Column("k"))), TE.Lit(True)))
    ok, reason = _op_verdict(CompilePolicy(), bad)
    assert not ok and reason.startswith("no generated code for FilterExec")


# --------------------------------------------------------------------------
# the generated C under the host compiler
# --------------------------------------------------------------------------


def _gxx_library(source, tmp_path):
    cu = tmp_path / "chain.cu"
    cu.write_text(source)
    so = tmp_path / "libchain.so"
    proc = subprocess.run(["g++", "-std=c++17", "-O2", "-shared", "-fPIC", "-ffp-contract=off",
                           "-I", CSRC, "-x", "c++", str(cu), "-o", str(so)],
                          capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    return ctypes.CDLL(str(so))


def _host_in(prog, cols, mask, auxs):
    fin = F._FusedIn()
    keep = []
    for k, (name, dt) in enumerate(prog.gen.inputs):
        t = cols[name].contiguous()
        assert t.dtype == dt
        keep.append(t)
        fin.col[k] = t.data_ptr()
    m = mask.contiguous()
    keep.append(m)
    fin.mask = m.data_ptr()
    for k, (step, slot, dt) in enumerate(prog.gen.aux):
        t = auxs[step][slot].contiguous()
        assert t.dtype == dt
        keep.append(t)
        fin.aux[k] = t.data_ptr()
        fin.aux_len[k] = t.shape[0]
    return fin, keep


def _host_rows(lib, prog, cols, mask, auxs):
    n = mask.shape[0]
    fin, keep = _host_in(prog, cols, mask, auxs)
    outs = [torch.empty(n, dtype=dt) for _name, dt in prog.gen.outputs]
    omask = torch.empty(n, dtype=torch.bool)
    fout = F._FusedOut()
    for k, t in enumerate(outs):
        fout.col[k] = t.data_ptr()
    fout.mask = omask.data_ptr()
    lib.ab_fused_rows_host(ctypes.byref(fin), ctypes.byref(fout), ctypes.c_longlong(n))
    return outs, omask


def _bits(t):
    """Each value's bits as int64 (floats by their bit pattern)."""
    if t.dtype == torch.float64:
        return t.view(torch.int64)
    if t.dtype == torch.float32:
        return t.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return t.to(torch.int64)


@pytest.mark.skipif(shutil.which("g++") is None, reason="no g++ on the PATH")
@pytest.mark.parametrize("name", list(FUSED_CHAINS))
def test_generated_row_function_compiled_by_gxx_equals_the_twin(tables, name, tmp_path):
    ops = _chain("torch", tables, name)
    ctx = TContext(device=CPU)
    tf = F.FusedStageExec(ops)
    prog = tf.program(ctx)
    lib = _gxx_library(prog.gen.source, tmp_path)
    checked = 0
    for p in range(tf.output_partition_count()):
        for batch in tf.input.execute(p, ctx):
            auxs, _dicts = prog.auxs_and_dicts(batch.dicts)
            outs, omask = _host_rows(lib, prog, batch.columns, batch.mask, auxs)
            if prog.agg is None:
                cols, mask = F.fused_rows_plain(prog, batch.columns, batch.mask, auxs)
                want = [cols[n] for n, _dt in prog.gen.outputs]
            else:
                keys, vals, mask = F._agg_key_vals_plain(prog, batch.columns, batch.mask, auxs)
                want = list(keys) + [v for v, _how in vals]
                _check_keys_words(lib, prog, batch, auxs, keys, vals, mask)
            assert torch.equal(omask, mask)
            for (oname, _dt), g, w in zip(prog.gen.outputs, outs, want):
                assert g.dtype == w.dtype, oname
                assert torch.equal(_bits(g), _bits(w.expand(g.shape[0]))), oname
            checked += int(mask.sum())
    assert checked > 0


def _check_keys_words(lib, prog, batch, auxs, keys, vals, mask):
    n = batch.mask.shape[0]
    fin, keep = _host_in(prog, batch.columns, batch.mask, auxs)
    k, m = len(keys), max(len(vals), 1)
    live = np.zeros(n, dtype=np.bool_)
    got_keys = np.zeros((n, k), dtype=np.int32)
    words = np.zeros((n, m), dtype=np.uint64)
    fn = lib.ab_fused_keys_words_host
    fn(ctypes.byref(fin), ctypes.c_longlong(n), live.ctypes.data_as(ctypes.c_void_p),
       got_keys.ctypes.data_as(ctypes.c_void_p), words.ctypes.data_as(ctypes.c_void_p))
    np.testing.assert_array_equal(live, mask.numpy())
    for j, key in enumerate(keys):
        np.testing.assert_array_equal(got_keys[:, j], key.to(torch.int32).numpy())
    for a, (v, how) in enumerate(vals):
        if how == "count":
            assert (words[:, a] == 1).all()
            continue
        want = _bits(v.expand(n)).numpy().view(np.uint64)
        np.testing.assert_array_equal(words[:, a], want)
