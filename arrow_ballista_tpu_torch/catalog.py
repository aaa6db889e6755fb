"""Table providers: named datasets resolvable to schemas and scans.

Providers serve both the SQL planner (schemas) and the physical planner
(scans, row-count estimates): in-memory tables, and parquet, csv (``.tbl``
too), newline-delimited json and avro files, each a path or an
object-store URL (utils/object_store.py), as the JAX package's catalog has
them.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from .models import expr as E
from .models.ipc import int64_decimal_storage_scale
from .models.schema import DataType, Field, Schema, decimal
from .sql.planner import Catalog
from .utils.errors import PlanningError


def arrow_schema_to_engine(pa_schema, nullable_by_col=None) -> Schema:
    """``nullable_by_col`` marks fields whose data actually contains NULLs
    (from null statistics) — engine nullability means "carries the in-band
    NULL sentinel", not arrow's everything-nullable default."""
    import pyarrow as pa

    nullable_by_col = nullable_by_col or {}
    fields = []
    for f in pa_schema:
        t = f.type
        meta = f.metadata or {}
        if pa.types.is_dictionary(t):
            t = t.value_type
        if pa.types.is_string(t) or pa.types.is_large_string(t):
            dt = DataType("string")
        elif pa.types.is_date32(t):
            dt = DataType("date32")
        elif pa.types.is_decimal(t):
            dt = decimal(t.scale)
        elif (pa.types.is_int64(t)
              and int64_decimal_storage_scale(f) is not None):
            # int64-stored decimals (unscaled values + metadata scale): the
            # physical-storage convention shared with the engine's shuffle
            # IPC files and the benchmark converter (benchmarks/tpch.py
            # decimal_to_int64_storage)
            dt = decimal(int64_decimal_storage_scale(f))
        elif pa.types.is_int64(t) or pa.types.is_uint64(t):
            dt = DataType("int64")
        elif pa.types.is_integer(t):
            dt = DataType("int32")
        elif pa.types.is_float64(t):
            dt = DataType("float64")
        elif pa.types.is_float32(t):
            dt = DataType("float32")
        elif pa.types.is_boolean(t):
            dt = DataType("bool")
        elif pa.types.is_timestamp(t) or pa.types.is_date64(t):
            dt = DataType("date32")
        else:
            raise PlanningError(f"unsupported arrow type {t} for column {f.name}")
        fields.append(Field(f.name, dt, bool(nullable_by_col.get(f.name, False))))
    return Schema(fields)


def _table_null_stats(table) -> dict:
    return {name: bool(col.null_count)
            for name, col in zip(table.column_names, table.columns)}


class TableProvider:
    name: str
    schema: Schema

    def scan(self, projection: Optional[List[str]], filters: Sequence[E.Expr],
             target_partitions: int):
        raise NotImplementedError

    def row_count(self) -> Optional[int]:
        return None


class MemoryTable(TableProvider):
    def __init__(self, name: str, table, schema: Optional[Schema] = None):
        import pyarrow as pa

        if not isinstance(table, pa.Table):
            table = pa.Table.from_pandas(table)
        self.name = name
        self.table = table
        self.schema = schema or arrow_schema_to_engine(
            table.schema, _table_null_stats(table))

    def scan(self, projection, filters, target_partitions):
        from .ops.physical import MemoryScanExec

        schema = self.schema if projection is None else self.schema.project(projection)
        return MemoryScanExec(schema, self.table, target_partitions, filters)

    def row_count(self):
        return self.table.num_rows


class ParquetTable(TableProvider):
    """Parquet files (a file, a directory of ``*.parquet`` or a list of
    either; paths or object-store URLs), schema from the first file's
    footer.  Nullability comes from
    the row-group statistics of every file: a column with no statistics,
    or with NULLs anywhere, is nullable."""

    def __init__(self, name: str, paths, schema: Optional[Schema] = None):
        from .utils import object_store

        self.name = name
        self.paths = [paths] if isinstance(paths, str) else list(paths)
        if schema is None:
            files = []
            for p in self.paths:
                files.extend(object_store.list_files(p, (".parquet",)))
            if not files:
                raise PlanningError(f"no parquet files in {self.paths}")
            nullable: Dict[str, bool] = {}
            arrow_schema = None
            for fpath in files:
                with object_store.parquet_file(fpath) as pf:
                    meta = pf.metadata
                    if arrow_schema is None:
                        arrow_schema = pf.schema_arrow
                for ci in range(meta.num_columns):
                    col_name = meta.schema.column(ci).name
                    if nullable.get(col_name):
                        continue
                    has_nulls = False
                    for rg in range(meta.num_row_groups):
                        st = meta.row_group(rg).column(ci).statistics
                        if st is None or st.null_count is None or st.null_count > 0:
                            has_nulls = True
                            break
                    nullable[col_name] = has_nulls
            schema = arrow_schema_to_engine(arrow_schema, nullable)
        self.schema = schema
        self._rows: Optional[int] = None

    def scan(self, projection, filters, target_partitions):
        from .ops.physical import ParquetScanExec

        schema = self.schema if projection is None else self.schema.project(projection)
        return ParquetScanExec(schema, self.paths, target_partitions, filters,
                               table_schema=self.schema)

    def row_count(self):
        """Rows in the footers (for the planner's estimates)."""
        if self._rows is None:
            from .ops.physical import ParquetScanExec

            self._rows = ParquetScanExec(self.schema, self.paths, 1,
                                         table_schema=self.schema).row_count_estimate()
        return self._rows


class CsvTable(TableProvider):
    """CSV files (``.csv``, or TPC-H ``.tbl`` with its trailing
    delimiter).  Without a schema the first file is read and its types
    inferred; nullability comes from that file's NULL counts when it is the
    only file, else every column is nullable."""

    def __init__(self, name: str, paths, schema: Optional[Schema] = None,
                 delimiter: str = ",", has_header: bool = True):
        self.name = name
        self.paths = [paths] if isinstance(paths, str) else list(paths)
        self.delimiter = delimiter
        self.has_header = has_header
        if schema is None:
            import pyarrow.csv as pacsv

            from .utils import object_store as obs

            samples = obs.list_files(self.paths[0], (".csv", ".tbl"))
            if not samples:
                raise PlanningError(f"no csv files in {self.paths[0]}")
            sample = samples[0]
            with obs.open_input(sample) as fh:
                table = pacsv.read_csv(
                    fh, parse_options=pacsv.ParseOptions(delimiter=delimiter),
                )

            multi = len(self.paths) > 1 or obs.is_dir(self.paths[0])
            if multi:
                # only the first file was sampled; other files may hold
                # NULLs, so be conservative
                nulls = {name: True for name in table.column_names}
            else:
                nulls = _table_null_stats(table)
            schema = arrow_schema_to_engine(table.schema, nulls)
        self.schema = schema

    def scan(self, projection, filters, target_partitions):
        from .ops.physical import CsvScanExec

        schema = self.schema if projection is None else self.schema.project(projection)
        return CsvScanExec(schema, self.paths, target_partitions, filters,
                           table_schema=self.schema, delimiter=self.delimiter,
                           has_header=self.has_header)


class JsonTable(TableProvider):
    """Newline-delimited JSON (reference register_json, context.rs:358-530)."""

    def __init__(self, name: str, paths, schema: Optional[Schema] = None):
        from .utils import object_store as obs

        self.name = name
        self.paths = [paths] if isinstance(paths, str) else list(paths)
        if schema is None:
            import pyarrow.json as pajson

            files = obs.list_files(self.paths[0], (".json", ".jsonl", ".ndjson"))
            if not files:
                raise PlanningError(f"no json files in {self.paths[0]}")
            with obs.open_input(files[0]) as fh:
                sample = pajson.read_json(fh)
            multi = len(files) > 1 or len(self.paths) > 1
            nulls = ({n: True for n in sample.column_names} if multi
                     else _table_null_stats(sample))
            schema = arrow_schema_to_engine(sample.schema, nulls)
        self.schema = schema

    def scan(self, projection, filters, target_partitions):
        from .ops.physical import JsonScanExec

        schema = self.schema if projection is None else self.schema.project(projection)
        return JsonScanExec(schema, self.paths, target_partitions, filters,
                            table_schema=self.schema)


class AvroTable(TableProvider):
    """Avro object container files (reference register_avro; codec in
    utils/avro.py since no avro library ships in this image)."""

    def __init__(self, name: str, paths, schema: Optional[Schema] = None):
        from .utils import object_store as obs

        self.name = name
        self.paths = [paths] if isinstance(paths, str) else list(paths)
        if schema is None:
            from .utils.avro import avro_arrow_schema, read_avro_schema

            files = obs.list_files(self.paths[0], (".avro",))
            if not files:
                raise PlanningError(f"no avro files in {self.paths[0]}")
            # header-only: the writer schema (and union nullability) lives
            # in the container metadata — never decode the file to infer
            with obs.open_input(files[0]) as fh:
                avro_schema = read_avro_schema(fh)
            pa_schema, nulls = avro_arrow_schema(avro_schema)
            schema = arrow_schema_to_engine(pa_schema, nulls)
        self.schema = schema

    def scan(self, projection, filters, target_partitions):
        from .ops.physical import AvroScanExec

        schema = self.schema if projection is None else self.schema.project(projection)
        return AvroScanExec(schema, self.paths, target_partitions, filters,
                            table_schema=self.schema)


class SchemaCatalog(Catalog):
    """Mutable in-memory catalog of providers (per session)."""

    def __init__(self):
        self.tables: Dict[str, TableProvider] = {}

    def register(self, provider: TableProvider):
        self.tables[provider.name] = provider

    def deregister(self, name: str):
        self.tables.pop(name, None)

    def table_schema(self, name: str) -> Schema:
        p = self.tables.get(name)
        if p is None:
            raise PlanningError(f"table not found: {name}")
        return p.schema

    def table_names(self):
        return sorted(self.tables)

    def provider(self, name: str) -> TableProvider:
        p = self.tables.get(name)
        if p is None:
            raise PlanningError(f"table not found: {name}")
        return p
