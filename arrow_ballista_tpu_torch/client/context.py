"""BallistaContext: the user entry point of the port.

Mirrors arrow_ballista_tpu/client/context.py for three engines:
``local()``, a single-process operator tree walk (RepartitionExec
materializes exchanges in memory); ``standalone()``, the scheduler and its
executors in process (scheduler/standalone.py: stages, task slots, Arrow
IPC shuffle files, whole-stage fusion); and ``remote(host, port)``, a
session on a scheduler service (scheduler/netservice.py) whose executors
(executor/server.py) run the tasks and exchange shuffle partitions through
their data planes (client/remote.py).  Results land on the context's
device: the card unless the caller names another; without a card a
context raises and never falls back to the CPU.  The local and standalone
engines answer ``EXPLAIN ANALYZE`` (``explain_analyze``) and the fusion
advisor (``advise``); a standalone session also assembles a job's
forensics bundle (``forensics``), diagnoses it (``doctor``) and streams a
running job's journal and progress (``watch``), all from obs/.  A remote
session streams ``watch`` from the scheduler and cancels (``cancel``); its
forensics and EXPLAIN ANALYZE come with the scheduler's REST API
(ROADMAP.md queue 1 item 12 E).
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


class RemoteDataFrame:
    """A remote query, lazily executed: ``collect`` submits the SQL text to
    the scheduler, waits for the job and fetches the final partitions onto
    the context's device.  ``static`` carries an immediate result (SET,
    SHOW, EXPLAIN, DDL)."""

    def __init__(self, ctx: "BallistaContext", sql: Optional[str], static=None):
        self.ctx = ctx
        self._sql = sql
        self._static = static

    def collect(self) -> List[ColumnBatch]:
        if self._sql is None:
            return []
        return self.ctx._remote.execute_sql(self._sql)

    def to_pandas(self):
        import pandas as pd

        if self._static is not None:
            return self._static
        frames = [b.to_pandas() for b in self.collect()]
        return pd.concat(frames, ignore_index=True) if frames else pd.DataFrame()

    def to_arrow(self):
        import pyarrow as pa

        if self._static is not None:
            return pa.Table.from_pandas(self._static)
        batches = self.collect()
        tables = [b.to_arrow() for b in batches if b.num_rows > 0]
        if not tables:
            return batches[0].to_arrow() if batches else pa.table({})
        return pa.concat_tables(tables)


class BallistaContext:
    def __init__(self, config: Optional[BallistaConfig] = None, device=None,
                 work_dir: Optional[str] = None, engine: str = "local"):
        self.config = config or BallistaConfig()
        self.device = resolve_device(device)
        self.engine = engine
        self._standalone = None
        self._remote = None
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
        """Stop a standalone context's scheduler and executors, or close a
        remote context's session."""
        if self._standalone is not None:
            self._standalone.shutdown()
            self._standalone = None
        if self._remote is not None:
            self._remote.close()
            self._remote = None

    @staticmethod
    def remote(host: Optional[str] = None, port: Optional[int] = None,
               config: Optional[BallistaConfig] = None, endpoints=None,
               device=None) -> "BallistaContext":
        """A session on the scheduler service at ``host:port``
        (scheduler/netservice.py): SQL text ships to the scheduler, results
        come back from the executors' data planes onto ``device`` (the
        card by default).  ``endpoints`` with more than one scheduler (a
        fleet) is ROADMAP.md queue 1 item 12 C."""
        from .remote import RemoteCluster

        ctx = BallistaContext(config, device=device, engine="remote")
        ctx._remote = RemoteCluster(host, port, ctx.config, endpoints=endpoints,
                                    device=ctx.device)
        return ctx

    # --- registration ---------------------------------------------------
    def register_table(self, name: str, table) -> None:
        if self._remote is not None:
            import pyarrow as pa

            if not isinstance(table, pa.Table):
                table = pa.Table.from_pandas(table)
            self._remote.register_table(name, table)
            return
        self.catalog.register(MemoryTable(name, table))

    def register_parquet(self, name: str, path, schema: Optional[Schema] = None) -> None:
        """A parquet file, a directory of them, or a list of either: paths
        or object-store URLs (utils/object_store.py)."""
        if self._remote is not None:
            self._remote.register_external_table(name, "parquet", path, schema)
            return
        self.catalog.register(ParquetTable(name, path, schema))

    def register_csv(self, name: str, path, schema: Optional[Schema] = None,
                     delimiter: str = ",", has_header: bool = True) -> None:
        """CSV files (``.csv``, or ``.tbl`` with a trailing delimiter); the
        schema is inferred from the first file when none is given."""
        if self._remote is not None:
            self._remote.register_external_table(name, "csv", path, schema, delimiter,
                                                 has_header)
            return
        self.catalog.register(CsvTable(name, path, schema, delimiter, has_header))

    def register_json(self, name: str, path, schema: Optional[Schema] = None) -> None:
        """Newline-delimited JSON files."""
        if self._remote is not None:
            self._remote.register_external_table(name, "json", path, schema)
            return
        self.catalog.register(JsonTable(name, path, schema))

    def register_avro(self, name: str, path, schema: Optional[Schema] = None) -> None:
        """Avro object container files (null or deflate codec)."""
        if self._remote is not None:
            self._remote.register_external_table(name, "avro", path, schema)
            return
        self.catalog.register(AvroTable(name, path, schema))

    def deregister_table(self, name: str) -> None:
        if self._remote is not None:
            self._remote.deregister_table(name)
            return
        self.catalog.deregister(name)

    # --- SQL ------------------------------------------------------------
    def sql(self, sql: str):
        if self._remote is not None:
            return self._remote_sql(sql)
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

    def _remote_sql(self, sql: str) -> RemoteDataFrame:
        """DDL, SET and SHOW go to the scheduler by RPC; a SELECT ships as
        its text."""
        import pandas as pd

        stmt = self._parse_cached(sql)
        if isinstance(stmt, ast.SetVariable):
            # validated here, then set on both ends: the scheduler plans
            # with the session's config, the client reads its own copy
            self.config.set(stmt.key, stmt.value)
            self._remote.update_session({stmt.key: stmt.value})
            return RemoteDataFrame(self, None, static=pd.DataFrame())
        if isinstance(stmt, ast.ShowSettings):
            return RemoteDataFrame(self, None, static=self._show_settings(
                stmt.key, self.config.to_dict()).to_pandas())
        if isinstance(stmt, ast.Explain):
            return RemoteDataFrame(self, None, static=pd.DataFrame(self._remote.explain(sql)))
        if isinstance(stmt, ast.CreateExternalTable):
            schema = None
            if stmt.columns:
                schema = Schema(Field(n, parse_type_name(t)) for n, t in stmt.columns)
            self._remote.register_external_table(stmt.name, stmt.file_format, stmt.location,
                                                 schema, delimiter=stmt.delimiter,
                                                 has_header=stmt.has_header)
            return RemoteDataFrame(self, None, static=pd.DataFrame())
        if isinstance(stmt, ast.ShowTables):
            return RemoteDataFrame(self, None, static=pd.DataFrame(
                {"table_name": sorted(self._remote.list_tables())}))
        if isinstance(stmt, ast.ShowColumns):
            schema = self._remote.table_schema(stmt.table)
            return RemoteDataFrame(self, None, static=pd.DataFrame({
                "column_name": [f.name for f in schema],
                "data_type": [str(f.dtype) for f in schema]}))
        return RemoteDataFrame(self, sql)

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
        """EXPLAIN [ANALYZE] [VERBOSE] <select>: (plan_type, plan) rows;
        ANALYZE runs the query and appends a row with the runtime-annotated
        plan (obs/stats.py)."""
        import pandas as pd

        from ..scheduler.physical_planner import explain_rows

        rows = explain_rows(self.catalog, self.config, stmt.statement, self.device,
                            verbose=stmt.verbose)
        if stmt.analyze:
            report = self._explain_analyze_statement(stmt.statement)
            rows = rows + [{"plan_type": "explain_analyze", "plan": report["text"]}]
        return self._static_df(pd.DataFrame(rows, columns=["plan_type", "plan"]))

    # --- observability (obs/) -------------------------------------------
    def explain_analyze(self, sql: str) -> Dict:
        """Run ``sql`` and return the EXPLAIN ANALYZE report: the physical
        plan annotated with observed rows/bytes/wall time per operator (and,
        with the device observatory on, each operator's kernel launches and
        their event times) and skew/duration quantiles per stage.  The dict
        is the JSON form; its ``"text"`` key holds the rendered report.
        Accepts a bare SELECT or a full ``EXPLAIN ANALYZE <select>``."""
        if self._remote is not None:
            raise NotImplementedError(
                "EXPLAIN ANALYZE of a remote job comes with the scheduler's REST API "
                "(ROADMAP.md queue 1 item 12 E)")
        stmt = parse_sql(sql)
        if isinstance(stmt, ast.Explain):
            stmt = stmt.statement
        if not isinstance(stmt, ast.Select):
            raise PlanningError("explain_analyze requires a SELECT query")
        return self._explain_analyze_statement(stmt)

    def advise(self, sql: str) -> Dict:
        """Run ``sql`` and return the stage-fusion advisor report
        (obs/advisor.py): operator chains ranked by the transfer and build
        overhead one fused kernel would eliminate.  The ``"text"`` key holds
        the rendered report."""
        from ..obs.advisor import advise_report
        from ..utils.config import OBS_DEVICE_ADVISOR_MIN_SAVINGS_MS

        return advise_report(
            self.explain_analyze(sql),
            min_savings_ms=float(self.config.get(OBS_DEVICE_ADVISOR_MIN_SAVINGS_MS)))

    def _last_job(self, what: str, job_id: Optional[str]) -> str:
        if self._remote is not None:
            job_id = job_id or self._remote.last_job_id
            if not job_id:
                raise PlanningError("no job has run in this session yet")
            return job_id
        if self._standalone is None:
            raise PlanningError(f"{what} requires a standalone session")
        job_id = job_id or self._standalone.last_job_id
        if not job_id:
            raise PlanningError("no job has run in this session yet")
        return job_id

    def forensics(self, job_id: Optional[str] = None) -> Dict:
        """The self-contained forensics bundle of ``job_id`` (default: the
        last job this session ran): flight-recorder timeline, stage stats,
        device stats, profile and trace, AQE records, scheduler counters and
        cluster history in one JSON artifact (obs/doctor.py).  Standalone
        sessions only."""
        from ..obs.doctor import assemble_forensics

        if self._remote is not None:
            raise NotImplementedError(
                "the forensics bundle of a remote job comes with the scheduler's REST API "
                "(ROADMAP.md queue 1 item 12 E)")
        job_id = self._last_job("forensics", job_id)
        bundle = assemble_forensics(self._standalone.scheduler, job_id)
        if bundle is None:
            raise PlanningError(f"job {job_id!r} is not known to the scheduler")
        return bundle

    def doctor(self, job_id: Optional[str] = None) -> Dict:
        """The query doctor (obs/doctor.py) over ``job_id``'s forensics
        bundle: ranked pathology findings with their metric evidence and
        config-knob remedies; the ``"text"`` key holds the rendered
        diagnosis."""
        from ..obs.doctor import diagnose

        return diagnose(self.forensics(job_id))

    def cancel(self, job_id: Optional[str] = None) -> None:
        """Cancel ``job_id`` (default: the last job this session ran) on a
        remote scheduler: its running tasks get a cancel fan-out."""
        if self._remote is not None:
            self._remote.cancel_job(self._last_job("cancel", job_id))
            return
        raise NotImplementedError(
            "job cancellation from a session is not ported yet (ROADMAP.md queue 1 item 12 C)")

    def watch(self, job_id: Optional[str] = None, timeout: Optional[float] = None):
        """Live watch stream of ``job_id`` (default: the last job this
        session ran): a generator of frames tagged ``{"t": "event" |
        "progress" | "end"}`` — journal events as they happen, progress
        snapshots (a non-decreasing ``fraction``, rows/s, a quantile ETA)
        every ``ballista.live.watch.poll.seconds``, and one terminal frame.
        Event frames need the flight recorder (``ballista.journal.enabled``);
        progress and terminal frames flow either way.  Standalone sessions
        and remote sessions (a remote one long-polls the scheduler)."""
        if self._remote is not None:
            return self._remote.watch(self._last_job("watch", job_id), timeout=timeout)
        return self._watch_standalone(self._last_job("watch", job_id), timeout)

    def _watch_standalone(self, job_id: str, timeout: Optional[float]):
        import time

        from ..obs import journal
        from ..obs.progress import job_progress, monotonic_fraction
        from ..utils.config import LIVE_WATCH_POLL_S, LIVE_WATCH_QUEUE_EVENTS
        from ..utils.errors import ExecutionError

        sched = self._standalone.scheduler
        if sched.jobs.get_status(job_id) is None:
            raise PlanningError(f"job {job_id!r} is not known to the scheduler")
        poll_s = float(self.config.get(LIVE_WATCH_POLL_S))
        capacity = int(self.config.get(LIVE_WATCH_QUEUE_EVENTS))
        deadline = time.monotonic() + (timeout if timeout is not None
                                       else float(self.config.job_timeout_s))
        floor = 0.0
        with journal.subscribe(job_id=job_id, capacity=capacity) as sub:
            # subscribe BEFORE replaying the retained timeline, then dedup
            # on (actor, seq): nothing emitted during the handoff is lost,
            # nothing is shown twice
            replayed = set()
            for ev in journal.job_timeline(job_id):
                replayed.add((ev.get("actor"), ev.get("seq")))
                yield {"t": "event", "event": ev}
            while time.monotonic() < deadline:
                for ev in sub.poll(timeout=poll_s):
                    key = (ev.get("actor"), ev.get("seq"))
                    if ev.get("kind") != "watch.gap" and key in replayed:
                        continue
                    yield {"t": "event", "event": ev}
                replayed.clear()  # only the handoff window needs it
                st = sched.jobs.get_status(job_id)
                graph = sched.jobs.get_graph(job_id)
                if graph is not None:
                    prog = job_progress(graph)
                    floor = monotonic_fraction(prog, floor)
                    prog["fraction"] = floor
                    yield {"t": "progress", "progress": prog,
                           "state": st.state if st else None}
                if st is not None and st.state in ("successful", "failed", "cancelled"):
                    yield {"t": "end", "state": st.state, "error": st.error}
                    return
        raise ExecutionError(f"watch of job {job_id} timed out")

    def _apply_device_obs(self) -> None:
        """The device observatory's process-wide switches, from this
        session's config (obs/device.py)."""
        from ..obs import device as device_obs
        from ..utils.config import OBS_DEVICE_ENABLED, OBS_DEVICE_WATERMARKS

        device_obs.set_enabled(bool(self.config.get(OBS_DEVICE_ENABLED)))
        device_obs.set_watermarks(bool(self.config.get(OBS_DEVICE_WATERMARKS)))

    def _explain_analyze_statement(self, stmt) -> Dict:
        """Plan and run one SELECT and build the annotated report.  The
        standalone engine reads the job's ExecutionGraph and its stats
        store; the local engine reads the executed operators' metrics, its
        device fold coming from one task scope around the whole run (so
        its launches are timed on the card)."""
        import time

        from ..obs import device as device_obs
        from ..obs.stats import explain_analyze_report, local_explain_report

        planner = PhysicalPlanner(self.catalog, self.config, self.device)
        planned = planner.plan_query(optimize(SqlToRel(self.catalog).plan(stmt)))
        self.last_plan = planned.plan
        t0 = time.monotonic()
        if self.engine != "standalone":
            self._apply_device_obs()
            with device_obs.task_scope(self.device) as dev_acc:
                batches = self._execute_local(planned)
                # counting the rows may launch a kernel: inside the scope
                rows = sum(b.num_rows for b in batches)
            wall_ms = (time.monotonic() - t0) * 1000.0
            return local_explain_report(
                planned.plan, wall_ms, rows_returned=rows,
                device_stats=dev_acc.snapshot() if dev_acc is not None else None)
        if self._standalone is None:
            raise PlanningError("this standalone context was shut down")
        batches = self._standalone.execute(planned)
        wall_ms = (time.monotonic() - t0) * 1000.0
        graph = self._standalone.scheduler.jobs.get_graph(self._standalone.last_job_id)
        if graph is None:
            raise PlanningError(f"job {self._standalone.last_job_id} has no retained graph")
        return explain_analyze_report(graph, wall_ms,
                                      rows_returned=sum(b.num_rows for b in batches))

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
        from .. import faults
        from ..memory import MemoryGovernor

        self._apply_device_obs()
        # arm the session's fault plan (a no-op unless ballista.faults.plan or
        # BALLISTA_FAULTS_PLAN names one, and once a plan is installed)
        faults.configure(self.config)

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
