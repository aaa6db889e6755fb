"""Scheduler network service: the scheduler's RPC surface over the wire.

Mirrors arrow_ballista_tpu/scheduler/netservice.py: sessions, prepared
statements, EXPLAIN, query submission and status, the watch stream,
cancellation, executor registration, heartbeats, task statuses, pull-mode
``poll_work``, and the catalog (memory tables, and parquet, csv, json and
avro tables registered by path, with ``get_file_metadata`` inferring a
file's schema).  The scheduler owns the catalog: SQL text arrives, the
scheduler plans it (scalar subqueries run here, on the service's device:
the card unless the caller passes another) and executors receive
serialized stage plans.  ``NetTaskLauncher`` pushes them to executors'
``launch_multi_task``; in pull mode executors poll.

A query is planned with the caches off, as the standalone engine plans it
(parse, optimize, plan, scalars); the serving caches and the result-cache
short cut come with ROADMAP.md queue 1 item 12 E, admission with 12 D.
The shared KV (``cluster_url``) and job persistence (``state_dir``) are
12 C; the REST API (``rest_port``) and Flight SQL (``flight_port``) are
12 E.  The ``scheduler.heartbeat.receive``, ``scheduler.status.receive``
and ``scheduler.cancel.fanout`` failpoints (faults/) fire here.
"""
from __future__ import annotations

import logging
import threading
from typing import Dict, List, Optional

from .. import faults, serde
from ..catalog import AvroTable, CsvTable, JsonTable, MemoryTable, ParquetTable, SchemaCatalog
from ..models.schema import Schema
from ..net.retry import RetryPolicy, call_with_retry
from ..net.rpc import RpcServer
from ..utils.config import BallistaConfig
from ..utils.errors import PlanningError
from .scheduler import SchedulerConfig, SchedulerServer, TaskLauncher, random_job_id
from .types import ExecutorHeartbeat, TaskDescription

log = logging.getLogger(__name__)

# guards plan encoding (see serialize_tasks_or_fail)
_ENCODE_LOCK = threading.Lock()


def serialize_tasks_or_fail(scheduler, executor_id: str,
                            tasks: List[TaskDescription]) -> List[dict]:
    """Serialize tasks one by one: a task whose plan cannot serialize fails
    the same way on every executor, so it is reported as a fatal task
    failure (its job fails fast) instead of a launch retried forever, and
    the other jobs' tasks of the batch go on.  Shared by the push launcher
    and the pull reply.  Same-stage tasks share one plan instance, so a
    stage's plan is encoded once a batch."""
    objs: List[dict] = []
    failed = []
    plan_cache: dict = {}
    for t in tasks:
        try:
            plan_obj = plan_cache.get(id(t.plan))
            if plan_obj is None:
                # one encode at a time process-wide: two launch threads
                # writing the same MemoryScanExec table through pyarrow's
                # IPC writer at once is not safe
                with _ENCODE_LOCK:
                    plan_obj = serde.plan_to_obj(t.plan)
                plan_cache[id(t.plan)] = plan_obj
            objs.append(serde.task_to_obj(t, plan_obj=plan_obj))
        except Exception as e:  # noqa: BLE001 — deterministic plan defect
            from .types import EXECUTION_ERROR, FailedReason, TaskStatus

            log.exception("task %s failed to serialize", t.task)
            failed.append(TaskStatus(t.task, executor_id, "failed",
                                     failure=FailedReason(
                                         EXECUTION_ERROR,
                                         f"plan serialization failed: {e}")))
    if failed:
        scheduler.update_task_status(executor_id, failed)
    return objs


def group_tasks_by_plan(objs: List[dict]) -> List[dict]:
    """Flat task objects -> MultiTaskDefinition groups (one plan dict + N
    task envelopes).  Same-stage tasks share the plan OBJECT, so identity
    grouping is exact and the plan is JSON-encoded onto the wire once."""
    groups: dict = {}
    for o in objs:
        g = groups.setdefault(id(o["plan"]), {"plan": o["plan"], "tasks": []})
        g["tasks"].append({"task": o["task"],
                           "internal_id": o["internal_id"],
                           "scalars": o["scalars"],
                           "trace": o.get("trace", {})})
    return list(groups.values())


def ungroup_tasks(payload: dict) -> List[dict]:
    """Inverse of group_tasks_by_plan; accepts the legacy flat shape too."""
    if "stages" not in payload:
        return list(payload.get("tasks", []))
    out = []
    for st in payload["stages"]:
        for env in st["tasks"]:
            out.append({"task": env["task"], "plan": st["plan"],
                        "internal_id": env.get("internal_id", 0),
                        "scalars": env.get("scalars", {}),
                        "trace": env.get("trace", {})})
    return out


class NetTaskLauncher(TaskLauncher):
    """Pushes tasks to executors over the wire (``launch_multi_task``)."""

    def __init__(self, policy: Optional[RetryPolicy] = None):
        self.scheduler: Optional[SchedulerServer] = None
        # deadlines and bounded backoff for every scheduler -> executor
        # call; a launch past the give-up deadline raises a ConnectionError,
        # which the scheduler turns into ExecutorLost (the tasks re-run
        # elsewhere)
        self.policy = policy or RetryPolicy()

    def _addr(self, executor_id: str):
        meta = self.scheduler.cluster.get_executor(executor_id)
        if meta is None:
            raise PlanningError(f"unknown executor {executor_id}")
        return meta.host, meta.grpc_port or meta.port

    def launch_tasks(self, executor_id: str, tasks: List[TaskDescription]) -> None:
        objs = serialize_tasks_or_fail(self.scheduler, executor_id, tasks)
        if not objs:
            return
        # one encoded stage plan and N task envelopes: a plan crosses the
        # wire once a stage, not once a task
        host, port = self._addr(executor_id)
        call_with_retry(host, port, "launch_multi_task",
                        {"stages": group_tasks_by_plan(objs)}, policy=self.policy)

    def cancel_tasks(self, executor_id: str, job_id: str) -> None:
        if faults.dropped("scheduler.cancel.fanout",
                          executor_id=executor_id, job_id=job_id):
            # a lost cancel RPC: the heartbeat's running set reaps it later
            return
        try:
            host, port = self._addr(executor_id)
            call_with_retry(host, port, "cancel_tasks", {"job_id": job_id},
                            policy=self.policy)
        except Exception:  # noqa: BLE001 — best effort: delivery failures
            # are logged and swallowed; the executor's heartbeat `running`
            # set lets the scheduler re-issue the kill (zombie reaping)
            log.warning("cancel_tasks on %s failed", executor_id, exc_info=True)

    def cancel_task(self, executor_id: str, task) -> None:
        if faults.dropped("scheduler.cancel.fanout",
                          executor_id=executor_id, job_id=task.job_id):
            return
        try:
            host, port = self._addr(executor_id)
            call_with_retry(host, port, "cancel_task",
                            {"task": serde.taskid_to_obj(task)},
                            policy=self.policy)
        except Exception:  # noqa: BLE001 — best effort (the loser's late
            # result is discarded by the graph's attempt bookkeeping anyway)
            log.warning("cancel_task on %s failed", executor_id, exc_info=True)

    def clean_job_data(self, executor_id: str, job_id: str) -> None:
        host, port = self._addr(executor_id)
        call_with_retry(host, port, "remove_job_data", {"job_id": job_id},
                        policy=self.policy)


class SchedulerNetService:
    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 config: Optional[BallistaConfig] = None,
                 scheduler_config: Optional[SchedulerConfig] = None,
                 rest_port: Optional[int] = None,
                 state_dir: Optional[str] = None,
                 cluster_url: Optional[str] = None,
                 flight_port: Optional[int] = None,
                 device=None):
        from ..client.context import resolve_device

        if cluster_url or state_dir:
            raise NotImplementedError(
                "the shared KV (cluster_url) and job persistence (state_dir) are not ported "
                "yet (ROADMAP.md queue 1 item 12 C)")
        if rest_port is not None or flight_port is not None:
            raise NotImplementedError(
                "the REST API (rest_port) and Flight SQL (flight_port) are not ported yet "
                "(ROADMAP.md queue 1 item 12 E)")
        self.config = config or BallistaConfig()
        # planning runs scalar subqueries here
        self.device = resolve_device(device)
        # arm the failpoint plan (a no-op unless ballista.faults.plan or
        # BALLISTA_FAULTS_PLAN names one)
        faults.configure(self.config)
        # the flight recorder, from the session config (enable-only, and
        # before SchedulerServer is built so its init names the actor)
        from ..utils.config import JOURNAL_CAPACITY, JOURNAL_ENABLED, JOURNAL_SPILL_PATH

        if bool(self.config.get(JOURNAL_ENABLED)):
            from ..obs import journal

            journal.set_enabled(True)
            journal.configure(capacity=int(self.config.get(JOURNAL_CAPACITY)),
                              spill_path=str(self.config.get(JOURNAL_SPILL_PATH)))
        if scheduler_config is None:
            # the session config's cluster, stats, live and SLO keys
            scheduler_config = SchedulerConfig.from_config(self.config)
        self.catalog = SchemaCatalog()
        launcher = NetTaskLauncher(RetryPolicy.from_config(self.config))
        from ..obs.profile import JobObservability

        self.server = SchedulerServer(launcher, scheduler_config,
                                      observability=JobObservability.from_config(self.config))
        launcher.scheduler = self.server
        self.rpc = RpcServer(host, port)
        self.host, self.port = self.rpc.host, self.rpc.port
        # job -> result schema, LRU-bounded (clients fetch results right
        # after completion)
        from collections import OrderedDict

        self._final_schemas: "OrderedDict[str, Schema]" = OrderedDict()
        self._max_schemas = 1024
        self._lock = threading.Lock()
        self._default_prepared: Dict[str, tuple] = {}

        # per-session isolation (scheduler/session.py)
        from .session import SessionManager

        self.sessions = SessionManager(self.config, self.catalog)

        r = self.rpc.register
        r("create_session", self._create_session)
        r("update_session", self._update_session)
        r("remove_session", self._remove_session)
        r("prepare", self._prepare)
        r("explain", self._explain)
        r("execute_query", self._execute_query)
        r("get_job_status", self._get_job_status)
        r("watch_job", self._watch_job)
        r("fetch_result", self._fetch_result)
        r("cancel_job", self._cancel_job)
        r("register_executor", self._register_executor)
        r("heartbeat", self._heartbeat)
        r("update_task_status", self._update_task_status)
        r("poll_work", self._poll_work)
        r("executor_stopped", self._executor_stopped)
        r("register_table", self._register_table)
        r("register_external_table", self._register_external_table)
        r("get_file_metadata", self._get_file_metadata)
        r("list_tables", self._list_tables)
        r("table_schema", self._table_schema)
        r("deregister_table", self._deregister_table)
        r("ping", lambda p, b: ({}, b""))

    def start(self) -> None:
        self.server.init()
        self.rpc.start()

    def stop(self) -> None:
        self.server.shutdown()
        self.rpc.stop()

    # --- sessions -------------------------------------------------------
    def _session_ctx(self, payload: dict):
        """(session, catalog, config) of a request: its session's when a
        session_id is given, the shared defaults otherwise; the request's
        config overrides apply on top either way."""
        session = self.sessions.get(payload.get("session_id"))
        base_catalog = session.catalog if session else self.catalog
        base_settings = (session.config if session else self.config)._settings
        overrides = payload.get("config", {})
        config = BallistaConfig({**base_settings, **overrides}) \
            if overrides or session else self.config
        return session, base_catalog, config

    def _create_session(self, payload: dict, _bin: bytes):
        s = self.sessions.create_session(payload.get("settings"))
        return {"session_id": s.id, "settings": dict(s.config._settings)}, b""

    def _update_session(self, payload: dict, _bin: bytes):
        s = self.sessions.update_session(payload["session_id"], payload.get("settings", {}))
        return {"settings": dict(s.config._settings)}, b""

    def _remove_session(self, payload: dict, _bin: bytes):
        self.sessions.remove_session(payload["session_id"])
        return {}, b""

    def _prepare(self, payload: dict, _bin: bytes):
        """A prepared statement: validated and planned once, its result
        schema returned; run later by execute_query with its
        ``statement_id``."""
        import uuid as uuidmod

        from ..sql.optimizer import optimize
        from ..sql.parser import parse_sql
        from ..sql.planner import SqlToRel

        session, catalog, _config = self._session_ctx(payload)
        sql = payload["sql"]
        logical = optimize(SqlToRel(catalog).plan(parse_sql(sql)))
        stmt_id = f"stmt-{uuidmod.uuid4().hex[:12]}"
        holder = session.prepared if session else self._default_prepared
        holder[stmt_id] = (sql, logical.schema)
        while len(holder) > 256:
            holder.pop(next(iter(holder)))
        return {"statement_id": stmt_id, "schema": serde.schema_to_obj(logical.schema)}, b""

    def _explain(self, payload: dict, _bin: bytes):
        """EXPLAIN over the wire: the scheduler owns the catalog, so it
        plans; the client gets the plan rows."""
        from ..sql import ast as sqlast
        from ..sql.parser import parse_sql
        from .physical_planner import explain_rows

        _session, catalog, config = self._session_ctx(payload)
        stmt = parse_sql(payload["sql"])
        verbose = False
        if isinstance(stmt, sqlast.Explain):
            if stmt.analyze:
                raise PlanningError(
                    "EXPLAIN ANALYZE is not supported over the wire: its report over a "
                    "remote job comes with the scheduler's REST API (ROADMAP.md queue 1 "
                    "item 12 E)")
            verbose = stmt.verbose
            stmt = stmt.statement
        return {"rows": explain_rows(catalog, config, stmt, self.device, verbose=verbose)}, b""

    # --- query handling --------------------------------------------------
    def _execute_query(self, payload: dict, _bin: bytes):
        session, catalog, session_config = self._session_ctx(payload)
        if "statement_id" in payload:
            holder = session.prepared if session else self._default_prepared
            entry = holder.get(payload["statement_id"])
            if entry is None:
                raise PlanningError(f"unknown prepared statement {payload['statement_id']!r}")
            sql = entry[0]
        else:
            sql = payload["sql"]
        job_id = random_job_id()

        def plan_fn():
            """Parse, optimize and plan the SQL, and run its scalar
            subqueries here (on the service's device), as the standalone
            engine does; the serving caches come with item 12 E."""
            from ..client.context import extract_scalar
            from ..ops.operators import clear_job_build_caches
            from ..ops.physical import TaskContext
            from ..sql.optimizer import optimize
            from ..sql.parser import parse_sql
            from ..sql.planner import SqlToRel
            from .physical_planner import PhysicalPlanner

            logical = optimize(SqlToRel(catalog).plan(parse_sql(sql)))
            planned = PhysicalPlanner(catalog, session_config, self.device).plan_query(logical)
            ctx = TaskContext(device=self.device, config=session_config,
                              job_id=f"{job_id}-scalars")
            scalars: Dict[str, object] = {}
            try:
                for sid, splan in planned.scalars:
                    ctx.scalars = scalars
                    scalars[sid] = extract_scalar(splan, ctx)
            finally:
                clear_job_build_caches(ctx.job_id)
            with self._lock:
                self._final_schemas[job_id] = planned.plan.schema
                while len(self._final_schemas) > self._max_schemas:
                    self._final_schemas.popitem(last=False)
            return planned.plan, scalars

        self.server.submit_job(job_id, plan_fn, config=session_config,
                               trace=payload.get("trace"))
        return {"job_id": job_id}, b""

    def _get_job_status(self, payload: dict, _bin: bytes):
        job_id = payload["job_id"]
        status = self.server.get_job_status(job_id)
        if status is None:
            return {"state": "not_found"}, b""
        out = {"state": status.state, "error": status.error, "retriable": status.retriable}
        if status.state == "successful":
            out["locations"] = {str(part): [serde.location_to_obj(l) for l in locs]
                                for part, locs in status.locations.items()}
            with self._lock:
                schema = self._final_schemas.get(job_id)
            if schema is None:
                graph = self.server.jobs.get_graph(job_id)
                if graph is not None:
                    final = graph.stages[graph.final_stage_id]
                    schema = (final.resolved_plan or final.plan).schema
            if schema is not None:
                out["schema"] = serde.schema_to_obj(schema)
        return out, b""

    def _watch_job(self, payload: dict, _bin: bytes):
        """One long-poll watch frame: the job's journal events past
        ``cursor``, a progress snapshot and the current state.  Blocking
        here is fine: the RPC server runs a thread a connection."""
        import time as _time

        from ..obs import journal
        from ..obs.progress import job_progress

        job_id = payload["job_id"]
        cursor = max(0, int(payload.get("cursor", 0)))
        timeout_s = min(max(float(payload.get("timeout_s", 0.25)), 0.0), 5.0)
        deadline = _time.monotonic() + timeout_s
        while True:
            status = self.server.get_job_status(job_id)
            if status is None:
                return {"state": "not_found"}, b""
            timeline = journal.job_timeline(job_id)
            if cursor > len(timeline):
                cursor = 0  # the timeline restarted
            events = timeline[cursor:]
            terminal = status.state in ("successful", "failed", "cancelled")
            if events or terminal or _time.monotonic() >= deadline:
                graph = self.server.jobs.get_graph(job_id)
                progress = job_progress(graph) if graph is not None else None
                return {"state": status.state, "error": status.error,
                        "scheduler_id": self.server.scheduler_id,
                        "cursor": cursor + len(events),
                        "events": events, "progress": progress}, b""
            _time.sleep(0.05)

    def _fetch_result(self, payload: dict, _bin: bytes):
        """The result-cache pull: no result is parked until the serving
        caches are ported."""
        raise PlanningError(
            f"no cached result parked for job {payload['job_id']} (the result cache comes "
            "with ROADMAP.md queue 1 item 12 E)")

    def _cancel_job(self, payload: dict, _bin: bytes):
        self.server.cancel_job(payload["job_id"])
        return {}, b""

    # --- executor control ------------------------------------------------
    def _register_executor(self, payload: dict, _bin: bytes):
        self.server.register_executor(
            serde.executor_metadata_from_obj(payload["meta"]))
        return {}, b""

    def _heartbeat(self, payload: dict, _bin: bytes):
        # failpoint: the heartbeat arrived but is discarded before it
        # touches cluster state, as if the packet were lost
        if faults.dropped("scheduler.heartbeat.receive",
                          executor_id=payload.get("executor_id")):
            return {}, b""
        meta = payload.get("meta")
        self.server.heartbeat(ExecutorHeartbeat(
            payload["executor_id"], status=payload.get("status", "active"),
            metadata=serde.executor_metadata_from_obj(meta) if meta else None,
            memory_pressure=float(payload.get("memory_pressure", 0.0)),
            running=[tuple(t) for t in payload.get("running", [])]))
        return {}, b""

    def _update_task_status(self, payload: dict, _bin: bytes):
        if faults.dropped("scheduler.status.receive",
                          executor_id=payload.get("executor_id"),
                          count=len(payload.get("statuses", []))):
            # the executor's reporter keeps the statuses and retries
            raise ConnectionError(
                "failpoint scheduler.status.receive dropped the report")
        statuses = [serde.status_from_obj(s) for s in payload["statuses"]]
        # a status report is proof of life: refresh the heartbeat's
        # timestamp (not its status)
        self.server.cluster.touch_heartbeat(payload["executor_id"])
        self.server.update_task_status(payload["executor_id"], statuses)
        return {}, b""

    def _poll_work(self, payload: dict, _bin: bytes):
        statuses = [serde.status_from_obj(s) for s in payload.get("statuses", [])]
        executor_id = payload["executor_id"]
        tasks = self.server.poll_work(executor_id,
                                      payload.get("num_free_slots", 0), statuses)
        # an unserializable plan fails its job instead of stranding the
        # popped tasks; a stage's plan is encoded once
        objs = serialize_tasks_or_fail(self.server, executor_id, tasks)
        return {"stages": group_tasks_by_plan(objs)}, b""

    def _executor_stopped(self, payload: dict, _bin: bytes):
        self.server.executor_stopped(payload["executor_id"],
                                     payload.get("reason", ""))
        return {}, b""

    # --- catalog (session-scoped when a session_id is supplied) -----------
    def _register_table(self, payload: dict, binary: bytes):
        import io

        import pyarrow.ipc as ipc

        _session, catalog, _ = self._session_ctx(payload)
        table = ipc.open_stream(io.BytesIO(binary)).read_all()
        catalog.register(MemoryTable(payload["name"], table))
        return {}, b""

    def _register_external_table(self, payload: dict, _bin: bytes):
        _session, catalog, _ = self._session_ctx(payload)
        name, fmt, path = payload["name"], payload["format"], payload["path"]
        schema = serde.schema_from_obj(payload["schema"]) if payload.get("schema") else None
        if fmt == "parquet":
            catalog.register(ParquetTable(name, path, schema))
        elif fmt == "csv":
            catalog.register(CsvTable(
                name, path, schema, payload.get("delimiter", ","),
                payload.get("has_header", True)))
        elif fmt == "json":
            catalog.register(JsonTable(name, path, schema))
        elif fmt == "avro":
            catalog.register(AvroTable(name, path, schema))
        else:
            raise PlanningError(f"unsupported format {fmt!r}")
        return {}, b""

    def _get_file_metadata(self, payload: dict, _bin: bytes):
        """Schema inference for a file path."""
        path = payload["path"]
        fmt = payload.get("format") or (
            "parquet" if path.endswith(".parquet") else
            "avro" if path.endswith(".avro") else
            "json" if path.endswith((".json", ".jsonl", ".ndjson")) else "csv")
        provider = {"parquet": ParquetTable, "csv": CsvTable,
                    "json": JsonTable, "avro": AvroTable}[fmt]
        schema = provider("__meta", path).schema
        return {"format": fmt, "schema": serde.schema_to_obj(schema)}, b""

    def _list_tables(self, payload: dict, _bin: bytes):
        _session, catalog, _ = self._session_ctx(payload)
        return {"tables": catalog.table_names()}, b""

    def _table_schema(self, payload: dict, _bin: bytes):
        _session, catalog, _ = self._session_ctx(payload)
        schema = catalog.table_schema(payload["name"])
        return {"schema": serde.schema_to_obj(schema)}, b""

    def _deregister_table(self, payload: dict, _bin: bytes):
        _session, catalog, _ = self._session_ctx(payload)
        catalog.deregister(payload["name"])
        return {}, b""
