"""BallistaContext: the user entry point of the port.

Mirrors arrow_ballista_tpu/client/context.py for two engines on one
device: ``local()``, a single-process operator tree walk (RepartitionExec
materializes exchanges in memory), and ``standalone()``, the scheduler and
its executors in process (scheduler/standalone.py: stages, task slots,
Arrow IPC shuffle files, whole-stage fusion).  Both run on the card unless
the caller names another device; without a card they raise and never fall
back to the CPU.  The remote engine is still to be ported (ROADMAP.md
queue 1 item 12).
"""
from __future__ import annotations

import os
import tempfile
import uuid
from collections import OrderedDict
from typing import Dict, List, Optional

import torch

from ..catalog import AvroTable, CsvTable, JsonTable, MemoryTable, ParquetTable, SchemaCatalog
from ..compile import programs
from ..models import logical as L
from ..models.batch import ColumnBatch
from ..models.schema import Field, Schema
from ..ops.kernels import to_host
from ..ops.operators import clear_job_build_caches
from ..ops.physical import ExecutionPlan, TaskContext
from ..scheduler.physical_planner import PhysicalPlanner, PlannedQuery
from ..sql import ast
from ..sql.optimizer import optimize
from ..sql.parser import parse_sql
from ..sql.planner import SqlToRel, parse_type_name
from ..utils.config import BallistaConfig
from ..utils.errors import PlanningError


def resolve_device(device=None) -> torch.device:
    """``None`` means the card; a CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' explicitly to run "
            "the plain PyTorch versions of the kernels")
    return dev


class BallistaDataFrame:
    """A planned query, lazily executed.  ``static`` carries an immediate
    result for statements with no plan to execute (SET / SHOW / EXPLAIN)."""

    def __init__(self, ctx: "BallistaContext", logical: Optional[L.LogicalPlan], static=None):
        self.ctx = ctx
        self.logical = logical
        self._static = static

    @property
    def schema(self) -> Schema:
        if self.logical is None:
            return Schema([])
        return self.logical.schema

    def explain(self) -> str:
        if self.logical is None:
            return ""
        return optimize(self.logical).display()

    def collect(self) -> List[ColumnBatch]:
        if self.logical is None:
            return []
        return self.ctx._execute_logical(self.logical)

    def to_arrow(self):
        import pyarrow as pa

        if self._static is not None:
            return pa.Table.from_pandas(self._static)
        batches = self.collect()
        tables = [b.to_arrow() for b in batches if b.num_rows > 0]
        if not tables:
            return batches[0].to_arrow() if batches else pa.table({})
        return pa.concat_tables(tables)

    def to_pandas(self):
        import pandas as pd

        if self._static is not None:
            return self._static
        frames = [b.to_pandas() for b in self.collect()]
        return pd.concat(frames, ignore_index=True) if frames else pd.DataFrame()


class BallistaContext:
    def __init__(self, config: Optional[BallistaConfig] = None, device=None,
                 work_dir: Optional[str] = None, engine: str = "local"):
        self.config = config or BallistaConfig()
        self.device = resolve_device(device)
        self.engine = engine
        self._standalone = None
        self.catalog = SchemaCatalog()
        self.work_dir = work_dir or os.path.join(tempfile.gettempdir(), "ballista_torch")
        self.last_plan: Optional[ExecutionPlan] = None
        self._ast_memo: "OrderedDict[str, object]" = OrderedDict()

    def _parse_cached(self, sql: str):
        stmt = self._ast_memo.get(sql)
        if stmt is not None:
            self._ast_memo.move_to_end(sql)
            return stmt
        stmt = parse_sql(sql)
        self._ast_memo[sql] = stmt
        while len(self._ast_memo) > 256:
            self._ast_memo.popitem(last=False)
        return stmt

    # --- constructors ---------------------------------------------------
    @staticmethod
    def local(config: Optional[BallistaConfig] = None, device=None) -> "BallistaContext":
        return BallistaContext(config, device=device)

    @staticmethod
    def standalone(config: Optional[BallistaConfig] = None, concurrent_tasks: int = 4,
                   num_executors: int = 1, device=None) -> "BallistaContext":
        """A scheduler and ``num_executors`` executors of
        ``concurrent_tasks`` task slots each, in this process, on
        ``device`` (the card by default)."""
        from ..scheduler.standalone import StandaloneCluster

        ctx = BallistaContext(config, device=device, engine="standalone")
        ctx._standalone = StandaloneCluster(ctx.config, concurrent_tasks, num_executors,
                                            device=ctx.device)
        return ctx

    def shutdown(self) -> None:
        """Stop a standalone context's scheduler and executors."""
        if self._standalone is not None:
            self._standalone.shutdown()
            self._standalone = None

    @staticmethod
    def remote(*_args, **_kwargs) -> "BallistaContext":
        raise NotImplementedError(
            "remote sessions are not ported yet (ROADMAP.md queue 1 item 12)")

    # --- registration ---------------------------------------------------
    def register_table(self, name: str, table) -> None:
        self.catalog.register(MemoryTable(name, table))

    def register_parquet(self, name: str, path, schema: Optional[Schema] = None) -> None:
        """A parquet file, a directory of them, or a list of either: paths
        or object-store URLs (utils/object_store.py)."""
        self.catalog.register(ParquetTable(name, path, schema))

    def register_csv(self, name: str, path, schema: Optional[Schema] = None,
                     delimiter: str = ",", has_header: bool = True) -> None:
        """CSV files (``.csv``, or ``.tbl`` with a trailing delimiter); the
        schema is inferred from the first file when none is given."""
        self.catalog.register(CsvTable(name, path, schema, delimiter, has_header))

    def register_json(self, name: str, path, schema: Optional[Schema] = None) -> None:
        """Newline-delimited JSON files."""
        self.catalog.register(JsonTable(name, path, schema))

    def register_avro(self, name: str, path, schema: Optional[Schema] = None) -> None:
        """Avro object container files (null or deflate codec)."""
        self.catalog.register(AvroTable(name, path, schema))

    def deregister_table(self, name: str) -> None:
        self.catalog.deregister(name)

    # --- SQL ------------------------------------------------------------
    def sql(self, sql: str) -> BallistaDataFrame:
        stmt = self._parse_cached(sql)
        if isinstance(stmt, ast.SetVariable):
            self.config.set(stmt.key, stmt.value)  # unported keys raise
            return self._static_df(None)
        if isinstance(stmt, ast.ShowSettings):
            return self._show_settings(stmt.key, self.config.to_dict())
        if isinstance(stmt, ast.Explain):
            return self._explain(stmt)
        if isinstance(stmt, ast.CreateExternalTable):
            return self._create_external_table(stmt)
        if isinstance(stmt, ast.ShowTables):
            import pyarrow as pa

            t = pa.table({"table_name": self.catalog.table_names()})
            name = f"__show_{uuid.uuid4().hex[:6]}"
            self.register_table(name, t)
            return self.sql(f"select table_name from {name}")
        if isinstance(stmt, ast.ShowColumns):
            import pyarrow as pa

            schema = self.catalog.table_schema(stmt.table)
            t = pa.table({"column_name": [f.name for f in schema],
                          "data_type": [str(f.dtype) for f in schema]})
            name = f"__cols_{uuid.uuid4().hex[:6]}"
            self.register_table(name, t)
            return self.sql(f"select column_name, data_type from {name}")
        return BallistaDataFrame(self, SqlToRel(self.catalog).plan(stmt))

    def _create_external_table(self, stmt: "ast.CreateExternalTable") -> BallistaDataFrame:
        schema = None
        if stmt.columns:
            schema = Schema(Field(n, parse_type_name(t)) for n, t in stmt.columns)
        if stmt.file_format == "parquet":
            self.register_parquet(stmt.name, stmt.location, schema)
        elif stmt.file_format == "csv":
            self.register_csv(stmt.name, stmt.location, schema,
                              delimiter=stmt.delimiter, has_header=stmt.has_header)
        elif stmt.file_format == "json":
            self.register_json(stmt.name, stmt.location, schema)
        elif stmt.file_format == "avro":
            self.register_avro(stmt.name, stmt.location, schema)
        else:
            raise PlanningError(f"unsupported format {stmt.file_format}")
        return self._static_df(None)

    def _static_df(self, frame) -> BallistaDataFrame:
        import pandas as pd

        return BallistaDataFrame(self, None, static=pd.DataFrame() if frame is None else frame)

    def _show_settings(self, key: str, settings: Dict[str, object]) -> BallistaDataFrame:
        import pandas as pd

        if key:
            self.config.get(key)  # raises ConfigurationError on unknown keys
            settings = {key: settings[key]}
        rows = sorted(settings.items())
        return self._static_df(pd.DataFrame({"name": [k for k, _ in rows],
                                             "value": [str(v) for _, v in rows]}))

    def _explain(self, stmt: "ast.Explain") -> BallistaDataFrame:
        import pandas as pd

        from ..scheduler.physical_planner import explain_rows

        if stmt.analyze:
            raise NotImplementedError(
                "EXPLAIN ANALYZE needs the runtime statistics store, not ported yet "
                "(ROADMAP.md queue 1 item 11)")
        rows = explain_rows(self.catalog, self.config, stmt.statement, self.device,
                            verbose=stmt.verbose)
        return self._static_df(pd.DataFrame(rows, columns=["plan_type", "plan"]))

    # --- execution ------------------------------------------------------
    def _execute_logical(self, logical: L.LogicalPlan) -> List[ColumnBatch]:
        planner = PhysicalPlanner(self.catalog, self.config, self.device)
        planned = planner.plan_query(optimize(logical))
        self.last_plan = planned.plan
        if self.engine == "standalone":
            if self._standalone is None:
                raise PlanningError("this standalone context was shut down")
            return self._standalone.execute(planned)
        return self._execute_local(planned)

    def _execute_local(self, planned: PlannedQuery) -> List[ColumnBatch]:
        # a fresh job id per query: the joins' broadcast build caches are
        # keyed by it, and dropped when the job ends
        from ..memory import MemoryGovernor

        ctx = TaskContext(device=self.device, config=self.config, work_dir=self.work_dir,
                          job_id=uuid.uuid4().hex[:7],
                          governor=MemoryGovernor.from_config(self.config))
        try:
            # each plan's generated programs are traced and built before its
            # first batch; a scalar subquery's value is part of the programs
            # that read it, so the main plan is prepared after the scalars
            for sid, splan in planned.scalars:
                programs.prepare(splan, ctx)
                ctx.scalars[sid] = extract_scalar(splan, ctx)
            programs.prepare(planned.plan, ctx)
            out: List[ColumnBatch] = []
            for p in range(planned.plan.output_partition_count()):
                out.extend(planned.plan.execute(p, ctx))
            return out
        finally:
            clear_job_build_caches(ctx.job_id)


def extract_scalar(plan: ExecutionPlan, ctx: TaskContext):
    """Run a scalar-subquery plan to a single python value (raw physical
    repr: decimals stay scaled ints)."""
    vals = []
    for p in range(plan.output_partition_count()):
        for b in plan.execute(p, ctx):
            if b.num_rows:
                mask = to_host(b.mask)
                col = to_host(b.columns[b.schema.fields[0].name])
                vals.extend(col[mask].tolist())
    if len(vals) > 1:
        raise PlanningError("scalar subquery returned more than one row")
    if not vals:
        return 0
    return vals[0]
