"""Remote cluster client: submit SQL to a scheduler, poll, fetch the result.

Mirrors arrow_ballista_tpu/client/remote.py for one scheduler: the client
opens a session on the scheduler (its private table namespace and
config), submits the SQL text with a fresh trace context, polls the job's
status every 100 ms, and fetches the final stage's partitions from the
executors' data planes (net/dataplane.py: streamed lz4 chunks, or the
whole file) onto the context's device.  Tables register by RPC: memory
tables as Arrow IPC, parquet, csv, json and avro tables by path (the
scheduler and its executors read the files).  ``watch`` long-polls the
scheduler's watch_job RPC.  A fleet of schedulers (more than one
endpoint) is ROADMAP.md queue 1 item 12 C.
"""
from __future__ import annotations

import io
import time
from typing import List, Optional, Tuple

from .. import serde
from ..models.batch import ColumnBatch
from ..net import wire
from ..utils.config import BallistaConfig
from ..utils.errors import ExecutionError, ResourceExhausted

POLL_INTERVAL_S = 0.1


class RemoteCluster:
    def __init__(self, host: Optional[str] = None, port: Optional[int] = None,
                 config: Optional[BallistaConfig] = None,
                 endpoints: Optional[List[Tuple[str, int]]] = None, device="cuda"):
        self.config = config or BallistaConfig()
        eps = [(h, int(p)) for h, p in (endpoints or [])]
        if host is not None and (host, int(port)) not in eps:
            eps.insert(0, (host, int(port)))
        if not eps:
            raise ValueError("RemoteCluster needs host/port or endpoints")
        if len(eps) > 1:
            raise NotImplementedError(
                "a scheduler fleet (more than one endpoint) is not ported yet "
                "(ROADMAP.md queue 1 item 12 C)")
        self.host, self.port = eps[0]
        self.device = device
        #: the id of the last job this client submitted
        self.last_job_id: Optional[str] = None
        # one scheduler session per client context: a private table
        # namespace and this client's config
        payload, _ = wire.call(self.host, self.port, "create_session",
                               {"settings": dict(self.config._settings)})
        self.session_id: Optional[str] = payload["session_id"]

    def close(self) -> None:
        if self.session_id is not None:
            try:
                wire.call(self.host, self.port, "remove_session",
                          {"session_id": self.session_id})
            except Exception:  # noqa: BLE001 — the scheduler may be gone
                pass
        self.session_id = None

    def _call(self, method: str, payload: dict = None, binary: bytes = b""):
        p = dict(payload or {})
        p.setdefault("session_id", self.session_id)
        return wire.call(self.host, self.port, method, p, binary)

    # --- catalog ---------------------------------------------------------
    def register_table(self, name: str, table) -> None:
        import pyarrow.ipc as ipc

        buf = io.BytesIO()
        with ipc.new_stream(buf, table.schema) as w:
            w.write_table(table)
        self._call("register_table", {"name": name}, buf.getvalue())

    def register_external_table(self, name: str, fmt: str, path: str, schema=None,
                                delimiter: str = ",", has_header: bool = True) -> None:
        self._call("register_external_table", {
            "name": name, "format": fmt, "path": path,
            "schema": serde.schema_to_obj(schema) if schema is not None else None,
            "delimiter": delimiter, "has_header": has_header})

    def list_tables(self) -> List[str]:
        payload, _ = self._call("list_tables")
        return payload["tables"]

    def table_schema(self, name: str):
        payload, _ = self._call("table_schema", {"name": name})
        return serde.schema_from_obj(payload["schema"])

    def deregister_table(self, name: str) -> None:
        self._call("deregister_table", {"name": name})

    def explain(self, sql: str) -> List[dict]:
        payload, _ = self._call("explain", {"sql": sql})
        return payload["rows"]

    def update_session(self, settings: dict) -> dict:
        payload, _ = self._call("update_session", {"settings": settings})
        return payload["settings"]

    # --- query execution -------------------------------------------------
    def execute_sql(self, sql: str, timeout: Optional[float] = None) -> List[ColumnBatch]:
        from ..obs import new_trace_context

        if timeout is None:
            timeout = float(self.config.job_timeout_s)
        deadline = time.monotonic() + timeout
        # the client owns the trace root: the scheduler parents the job
        # span on it, the executors their task spans below that
        payload, _ = self._call("execute_query", {"sql": sql,
                                                  "config": dict(self.config._settings),
                                                  "trace": new_trace_context()})
        job_id = payload["job_id"]
        self.last_job_id = job_id
        while True:
            status, _ = self._call("get_job_status", {"job_id": job_id})
            state = status["state"]
            if state == "successful":
                break
            if state in ("failed", "cancelled", "not_found"):
                if status.get("retriable"):
                    raise ResourceExhausted(f"job {job_id} shed: {status.get('error', '')}")
                raise ExecutionError(f"job {job_id} {state}: {status.get('error', '')}")
            if time.monotonic() > deadline:
                self._call("cancel_job", {"job_id": job_id})
                raise ExecutionError(f"job {job_id} timed out")
            time.sleep(POLL_INTERVAL_S)

        schema = serde.schema_from_obj(status["schema"])
        batches: List[ColumnBatch] = []
        for part in sorted(status["locations"], key=int):
            for obj in status["locations"][part]:
                loc = serde.location_from_obj(obj)
                if loc.num_rows:
                    batches.extend(self._fetch(loc, schema))
        return batches

    def cancel_job(self, job_id: str) -> None:
        """Ask the scheduler to cancel ``job_id``: its running tasks get a
        cancel fan-out and its state is released with the terminal
        status."""
        self._call("cancel_job", {"job_id": job_id})

    # --- live watch ------------------------------------------------------
    def watch(self, job_id: str, timeout: Optional[float] = None):
        """Generator of live watch frames of ``job_id``, dicts tagged
        ``{"t": "event" | "progress" | "end"}``: journal events past a
        cursor (deduplicated on (actor, seq)), progress snapshots with a
        non-decreasing fraction, and one terminal frame."""
        from ..obs.progress import monotonic_fraction
        from ..utils.config import LIVE_WATCH_POLL_S

        if timeout is None:
            timeout = float(self.config.job_timeout_s)
        poll_s = float(self.config.get(LIVE_WATCH_POLL_S))
        deadline = time.monotonic() + timeout
        cursor = 0
        seen: set = set()
        floor = 0.0
        while time.monotonic() < deadline:
            payload, _ = self._call("watch_job", {"job_id": job_id, "cursor": cursor,
                                                  "timeout_s": poll_s})
            state = payload.get("state")
            if state == "not_found":
                raise ExecutionError(f"job {job_id} is not known to the scheduler")
            for ev in payload.get("events", []):
                key = (ev.get("actor"), ev.get("seq"))
                if ev.get("kind") != "watch.gap":  # gap markers never dedup
                    if key in seen:
                        continue
                    seen.add(key)
                yield {"t": "event", "event": ev}
            cursor = int(payload.get("cursor", cursor))
            prog = payload.get("progress")
            if prog:
                floor = monotonic_fraction(prog, floor)
                prog["fraction"] = floor
                yield {"t": "progress", "progress": prog, "state": state}
            if state in ("successful", "failed", "cancelled"):
                yield {"t": "end", "state": state, "error": payload.get("error", "")}
                return
        raise ExecutionError(f"watch of job {job_id} timed out")

    def _fetch(self, loc, schema) -> List[ColumnBatch]:
        from ..net.dataplane import (StreamUnsupported, fetch_partition_batches,
                                     fetch_partition_stream)
        from ..utils.config import (SHUFFLE_INTEGRITY, SHUFFLE_WIRE_CHUNK_ROWS,
                                    SHUFFLE_WIRE_COMPRESSION, SHUFFLE_WIRE_STREAMING)

        expected = int(loc.checksum) if (bool(self.config.get(SHUFFLE_INTEGRITY))
                                         and loc.checksum >= 0) else -1
        # the result rides the same chunked protocol as the shuffle between
        # executors; grpc_port 0 keeps the whole-file path
        if bool(self.config.get(SHUFFLE_WIRE_STREAMING)) and loc.grpc_port > 0:
            try:
                batches, _ = fetch_partition_stream(
                    loc.host, loc.grpc_port, loc.path, schema, self.config.batch_size,
                    expected_checksum=expected,
                    chunk_rows=int(self.config.get(SHUFFLE_WIRE_CHUNK_ROWS)),
                    compression=str(self.config.get(SHUFFLE_WIRE_COMPRESSION)),
                    device=self.device)
                return batches
            except StreamUnsupported:
                pass
        return fetch_partition_batches(loc.host, loc.port, loc.path, schema,
                                       self.config.batch_size, expected_checksum=expected,
                                       device=self.device)
