"""The port's csv, json and avro scans and its object-store registry
against the JAX package (the port on the CPU, JAX on the CPU), on the same
files.

- csv with a header and an inferred schema, without a header under a
  given schema, TPC-H ``.tbl`` (``|`` and a trailing delimiter), a
  directory of files;
- newline-delimited json, inferred and given schemas;
- avro under the null and deflate codecs, written by each package's codec
  and read by the other's;
- ``CREATE EXTERNAL TABLE ... STORED AS CSV|JSON|AVRO``;
- object-store URLs through an fsspec ``mem://`` store (parquet, csv,
  json, avro);
- TPC-H q1 and q3 at SF0.01 over csv under the TPC-H schema equal the
  same queries over parquet bit for bit, and over csv with an inferred
  schema they equal the JAX package over the same csv; the standalone
  engine over csv equals the local one.

Rows must be equal exactly (floats bit for bit).  Inputs are made with
numpy from a seed.
"""
import json

import numpy as np
import pyarrow as pa
import pyarrow.csv as pacsv
import pyarrow.parquet as pq
import pytest
import torch

import arrow_ballista_tpu as jab
import arrow_ballista_tpu_torch as tab
from arrow_ballista_tpu.utils import avro as javro
from arrow_ballista_tpu.utils import object_store as jobs
from arrow_ballista_tpu_torch.catalog import arrow_schema_to_engine
from arrow_ballista_tpu_torch.utils import avro as tavro
from arrow_ballista_tpu_torch.utils import object_store as tobs
from arrow_ballista_tpu_torch.utils.config import BallistaConfig
from benchmarks.datagen import generate_tables
from benchmarks.queries import QUERIES
from benchmarks.tpch import decimal_to_int64_storage
from tests.torch_cases import assert_frames_equal

torch.set_num_threads(1)


def _table(n=3000, seed=11):
    """ints, floats (with NULLs), strings (with NULLs), dates, bools."""
    rng = np.random.default_rng(seed)
    f = rng.standard_normal(n) * 100
    s = rng.choice(["alpha", "beta", "gamma", "delta"], n).astype(object)
    s[rng.random(n) < 0.05] = None
    fl = pa.array(f, mask=rng.random(n) < 0.05)
    return pa.table({
        "id": pa.array(np.arange(n, dtype=np.int64)),
        "k": pa.array(rng.integers(-50, 50, n).astype(np.int32)),
        "f": fl,
        "s": pa.array(s, type=pa.string()),
        "d": pa.array(rng.integers(8000, 12000, n).astype(np.int32)).cast(pa.date32()),
        "b": pa.array(rng.random(n) < 0.3),
    })


QUERY = ("select id, k, f, s, d, b from t where k > -20 order by id")
AGG = ("select s, count(*) as n, sum(k) as sk, min(d) as md, max(f) as mf "
       "from t group by s order by s")


def _both(register):
    """A JAX and a port context with ``register(ctx)`` applied to each."""
    jctx = jab.BallistaContext.local()
    tctx = tab.BallistaContext.local(device="cpu")
    register(jctx)
    register(tctx)
    return jctx, tctx


def _nulls_as_none(df):
    """A NULL string reads back as None or NaN: both are NULL, compared as
    one marker (NaN never equals itself)."""
    for c in df.columns:
        if df[c].dtype.kind not in "biufcmM":  # strings (object or pandas' str)
            df[c] = df[c].astype(object).where(df[c].notna(), "<NULL>")
    return df


def _same(jctx, tctx, sql=QUERY):
    want = _nulls_as_none(jctx.sql(sql).to_pandas())
    got = _nulls_as_none(tctx.sql(sql).to_pandas())
    assert len(want) > 0
    assert_frames_equal(got, want, exact=True)


def _schemas_equal(jctx, tctx, name="t"):
    js, ts = jctx.catalog.table_schema(name), tctx.catalog.table_schema(name)
    assert [(f.name, f.dtype.kind, f.dtype.scale, f.nullable) for f in ts] == \
        [(f.name, f.dtype.kind, f.dtype.scale, f.nullable) for f in js]


# --------------------------------------------------------------------------
# csv
# --------------------------------------------------------------------------


def test_csv_with_header_and_an_inferred_schema(tmp_path):
    path = str(tmp_path / "t.csv")
    pacsv.write_csv(_table(), path)
    jctx, tctx = _both(lambda c: c.register_csv("t", path))
    _schemas_equal(jctx, tctx)
    _same(jctx, tctx)
    _same(jctx, tctx, AGG)


def test_csv_without_a_header_under_a_given_schema(tmp_path):
    t = _table().drop(["b"])
    path = str(tmp_path / "t.csv")
    pacsv.write_csv(t, path, pacsv.WriteOptions(include_header=False))
    jschema = jab.Schema([jab.Field("id", jab.INT64), jab.Field("k", jab.INT32),
                          jab.Field("f", jab.FLOAT64, True), jab.Field("s", jab.STRING, True),
                          jab.Field("d", jab.DATE32)])
    tschema = tab.Schema([tab.Field("id", tab.INT64), tab.Field("k", tab.INT32),
                          tab.Field("f", tab.FLOAT64, True), tab.Field("s", tab.STRING, True),
                          tab.Field("d", tab.DATE32)])
    jctx = jab.BallistaContext.local()
    tctx = tab.BallistaContext.local(device="cpu")
    jctx.register_csv("t", path, schema=jschema, has_header=False)
    tctx.register_csv("t", path, schema=tschema, has_header=False)
    _same(jctx, tctx, "select id, k, f, s, d from t where k > -20 order by id")
    _same(jctx, tctx, "select s, count(*) as n, sum(k) as sk, min(d) as md from t "
                      "group by s order by s")


def _tbl(t: pa.Table, path):
    """dbgen's layout: ``|`` between fields and after the last, no header."""
    cols = [c.to_pylist() for c in t.columns]
    with open(path, "w") as fh:
        for row in zip(*cols):
            fh.write("|".join("" if v is None else str(v) for v in row) + "|\n")


def test_tpch_tbl_files_with_a_trailing_delimiter(tmp_path):
    tables = generate_tables(0.01, seed=0)
    d = tmp_path / "tbl"
    d.mkdir()
    _tbl(tables["nation"], d / "nation.tbl")
    _tbl(tables["region"], d / "region.tbl")
    jsch = {n: jab.catalog.arrow_schema_to_engine(tables[n].schema) for n in ("nation", "region")}
    tsch = {n: arrow_schema_to_engine(tables[n].schema) for n in ("nation", "region")}

    def reg(ctx, sch):
        for n in ("nation", "region"):
            ctx.register_csv(n, str(d / f"{n}.tbl"), schema=sch[n], delimiter="|",
                             has_header=False)

    jctx, tctx = jab.BallistaContext.local(), tab.BallistaContext.local(device="cpu")
    reg(jctx, jsch)
    reg(tctx, tsch)
    _same(jctx, tctx, "select n_name, r_name, n_nationkey from nation, region "
                      "where n_regionkey = r_regionkey order by n_nationkey")


def test_a_directory_of_csv_files_is_one_table(tmp_path):
    t = _table()
    d = tmp_path / "parts"
    d.mkdir()
    for i in range(3):
        pacsv.write_csv(t.slice(i * 1000, 1000), str(d / f"part{i}.csv"))
    jctx, tctx = _both(lambda c: c.register_csv("t", str(d)))
    _schemas_equal(jctx, tctx)
    _same(jctx, tctx)


# --------------------------------------------------------------------------
# json
# --------------------------------------------------------------------------


def _write_ndjson(t: pa.Table, path):
    with open(path, "w") as fh:
        for row in t.to_pylist():
            fh.write(json.dumps({k: (str(v) if hasattr(v, "isoformat") else v)
                                 for k, v in row.items()}) + "\n")


@pytest.mark.parametrize("given", [False, True], ids=["inferred", "given"])
def test_json_lines(tmp_path, given):
    t = _table().drop(["d"])
    path = str(tmp_path / "t.json")
    _write_ndjson(t, path)
    sql = "select id, k, f, s, b from t where k > -20 order by id"
    if given:
        jctx = jab.BallistaContext.local()
        tctx = tab.BallistaContext.local(device="cpu")
        jctx.register_json("t", path, schema=jab.Schema(
            [jab.Field("id", jab.INT64), jab.Field("k", jab.INT64),
             jab.Field("f", jab.FLOAT64, True), jab.Field("s", jab.STRING, True),
             jab.Field("b", jab.BOOL)]))
        tctx.register_json("t", path, schema=tab.Schema(
            [tab.Field("id", tab.INT64), tab.Field("k", tab.INT64),
             tab.Field("f", tab.FLOAT64, True), tab.Field("s", tab.STRING, True),
             tab.Field("b", tab.BOOL)]))
    else:
        jctx, tctx = _both(lambda c: c.register_json("t", path))
        _schemas_equal(jctx, tctx)
    _same(jctx, tctx, sql)


# --------------------------------------------------------------------------
# avro
# --------------------------------------------------------------------------

AVRO_SCHEMA = {"type": "record", "name": "t", "fields": [
    {"name": "id", "type": "long"},
    {"name": "k", "type": "int"},
    {"name": "f", "type": ["null", "double"]},
    {"name": "s", "type": ["null", "string"]},
    {"name": "b", "type": "boolean"},
]}


def _avro_rows(n=2000, seed=5):
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        rows.append({"id": i, "k": int(rng.integers(-50, 50)),
                     "f": None if rng.random() < 0.05 else float(rng.standard_normal() * 10),
                     "s": None if rng.random() < 0.05 else str(rng.choice(["x", "yy", "zzz"])),
                     "b": bool(rng.random() < 0.5)})
    return rows


@pytest.mark.parametrize("codec", ["null", "deflate"])
@pytest.mark.parametrize("writer", ["port", "reference"])
def test_avro_files(tmp_path, codec, writer):
    rows = _avro_rows()
    path = str(tmp_path / "t.avro")
    (tavro if writer == "port" else javro).write_avro(path, AVRO_SCHEMA, rows, codec=codec)
    # each codec reads what the other writes, the same records
    assert tavro.read_avro(path)[1] == javro.read_avro(path)[1] == rows
    jctx, tctx = _both(lambda c: c.register_avro("t", path))
    _schemas_equal(jctx, tctx)
    _same(jctx, tctx, "select id, k, f, s, b from t where k > -20 order by id")
    _same(jctx, tctx, "select s, count(*) as n, sum(k) as sk, max(f) as mf from t "
                      "group by s order by s")


# --------------------------------------------------------------------------
# CREATE EXTERNAL TABLE
# --------------------------------------------------------------------------


def test_create_external_table_stored_as_csv_json_avro(tmp_path):
    t = _table().drop(["d"])
    csv_path, json_path, avro_path = (str(tmp_path / f"t.{x}") for x in ("csv", "json", "avro"))
    pacsv.write_csv(t, csv_path)
    _write_ndjson(t, json_path)
    tavro.write_avro(avro_path, AVRO_SCHEMA, _avro_rows())
    jctx = jab.BallistaContext.local()
    tctx = tab.BallistaContext.local(device="cpu")
    for ctx in (jctx, tctx):
        ctx.sql(f"create external table c stored as csv with header row location '{csv_path}'")
    _same(jctx, tctx, "select id, k, f, s from c where k > 10 order by id")
    # the JAX package's CREATE EXTERNAL TABLE takes parquet and csv; the
    # port's also json and avro, equal to the JAX package's registration
    jctx.register_json("j", json_path)
    jctx.register_avro("a", avro_path)
    tctx.sql(f"create external table j stored as json location '{json_path}'")
    tctx.sql(f"create external table a stored as avro location '{avro_path}'")
    _same(jctx, tctx, "select id, k, f, s from j where k > 10 order by id")
    _same(jctx, tctx, "select id, k, f, s from a where k > 10 order by id")


# --------------------------------------------------------------------------
# object stores
# --------------------------------------------------------------------------


@pytest.fixture
def memfs():
    fsspec = pytest.importorskip("fsspec")
    fs = fsspec.filesystem("memory")
    tobs.register_fsspec("mem", fs)
    jobs.register_fsspec("mem", fs)
    yield fs
    fs.store.clear()


def _put(fs, path, data: bytes):
    with fs.open(path, "wb") as fh:
        fh.write(data)


def test_object_store_resolution_matches_the_reference(memfs, tmp_path):
    local = tmp_path / "x.parquet"
    pq.write_table(pa.table({"a": [1]}), str(local))
    for url in (str(local), f"file://{local}"):
        assert tobs.resolve(url)[1] == jobs.resolve(url)[1]
        assert tobs.list_files(url, (".parquet",)) == jobs.list_files(url, (".parquet",))
    for i in range(3):
        _put(memfs, f"/bucket/d/p{i}.csv", b"a\n1\n")
    _put(memfs, "/bucket/d/skip.txt", b"x")
    listed = tobs.list_files("mem://bucket/d", (".csv",))
    assert listed == jobs.list_files("mem://bucket/d", (".csv",))
    assert [u.rsplit("/", 1)[1] for u in listed] == [f"p{i}.csv" for i in range(3)]
    assert all(u.startswith("mem://") for u in listed)
    assert tobs.is_dir("mem://bucket/d") and not tobs.is_dir("mem://bucket/d/p0.csv")
    with pytest.raises(Exception, match="no object store registered"):
        tobs.resolve("nosuch://b/x")


@pytest.mark.parametrize("fmt", ["parquet", "csv", "json", "avro"])
def test_tables_on_an_object_store(memfs, tmp_path, fmt):
    t = _table().drop(["d"])
    if fmt == "parquet":
        buf = pa.BufferOutputStream()
        pq.write_table(t, buf, row_group_size=500)
        data = buf.getvalue().to_pybytes()
    elif fmt == "csv":
        buf = pa.BufferOutputStream()
        pacsv.write_csv(t, buf)
        data = buf.getvalue().to_pybytes()
    elif fmt == "json":
        p = tmp_path / "t.json"
        _write_ndjson(t, p)
        data = p.read_bytes()
    else:
        p = tmp_path / "t.avro"
        tavro.write_avro(str(p), AVRO_SCHEMA, _avro_rows(), codec="deflate")
        data = p.read_bytes()
    _put(memfs, f"/store/{fmt}/part0.{fmt}", data)
    url = f"mem://store/{fmt}"
    jctx, tctx = _both(lambda c: getattr(c, f"register_{fmt}")("t", url))
    _schemas_equal(jctx, tctx)
    _same(jctx, tctx, "select id, k, f, s from t where k > -20 order by id")


# --------------------------------------------------------------------------
# TPC-H over csv
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tpch_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("tpch_csv")
    tables = generate_tables(0.01, seed=0)
    for name, t in tables.items():
        pacsv.write_csv(t, str(d / f"{name}.csv"))
        pq.write_table(decimal_to_int64_storage(t), str(d / f"{name}.parquet"),
                       row_group_size=8192)
    return str(d), tables


@pytest.mark.parametrize("q", [1, 3])
def test_tpch_over_csv_equals_parquet(tpch_files, q):
    d, tables = tpch_files
    csv_ctx = tab.BallistaContext.local(device="cpu")
    pq_ctx = tab.BallistaContext.local(device="cpu")
    for name, t in tables.items():
        csv_ctx.register_csv(name, f"{d}/{name}.csv", schema=arrow_schema_to_engine(t.schema))
        pq_ctx.register_parquet(name, f"{d}/{name}.parquet")
    got = csv_ctx.sql(QUERIES[q]).to_pandas()
    want = pq_ctx.sql(QUERIES[q]).to_pandas()
    assert len(want) > 0
    assert_frames_equal(got, want, exact=True)


@pytest.mark.parametrize("q", [1, 3])
def test_tpch_over_csv_with_inferred_schemas_equals_the_reference(tpch_files, q):
    d, tables = tpch_files
    jctx, tctx = _both(lambda c: [c.register_csv(n, f"{d}/{n}.csv") for n in tables])
    for n in tables:
        _schemas_equal(jctx, tctx, n)
    want = jctx.sql(QUERIES[q]).to_pandas()
    got = tctx.sql(QUERIES[q]).to_pandas()
    assert_frames_equal(got, want, ordered=True)


def test_standalone_over_csv_equals_local(tpch_files):
    d, tables = tpch_files
    local = tab.BallistaContext.local(device="cpu")
    sa = tab.BallistaContext.standalone(BallistaConfig({"ballista.shuffle.partitions": "4"}),
                                        concurrent_tasks=4, device="cpu")
    try:
        for c in (local, sa):
            for n, t in tables.items():
                c.register_csv(n, f"{d}/{n}.csv", schema=arrow_schema_to_engine(t.schema))
        for q in (1, 3):
            assert_frames_equal(sa.sql(QUERIES[q]).to_pandas(),
                                local.sql(QUERIES[q]).to_pandas(), exact=True)
    finally:
        sa.shutdown()
