"""Standard Arrow Flight door on the executor.

Mirrors arrow_ballista_tpu/executor/flight_service.py: any Arrow client
can ``do_get`` a shuffle partition with no Ballista code, because the
shuffle files on disk are plain Arrow IPC in the physical representation
(models/ipc.py), streamed batch by batch off a memory map.  The engine's
own peers keep to the native or RPC data plane (executor/server.py).

Tickets: JSON ``{"path": ..., "token": ...}`` or the raw path bytes, the
scheme a stock ``pyarrow.flight`` client builds from the
``PartitionLocation`` the scheduler hands out.  When
``BALLISTA_DATA_PLANE_TOKEN`` is set, tickets must carry it; a path
outside the work directory is refused.
"""
from __future__ import annotations

import json
import logging
import os
import threading
from typing import Optional

log = logging.getLogger(__name__)


class ExecutorFlightServer:
    """Flight door over an ExecutorServer's work dir (pyarrow.flight is
    imported when the server is built)."""

    def __init__(self, work_dir: str, token: str = "",
                 host: str = "127.0.0.1", port: int = 0):
        import pyarrow.flight as fl

        outer = self
        self.work_dir = work_dir
        self._token = token

        class _Server(fl.FlightServerBase):
            def __init__(self):
                super().__init__(location=f"grpc://{host}:{port}")

            def do_get(self, context, ticket):
                return outer._do_get(bytes(ticket.ticket))

        self._fl = fl
        self._server = _Server()
        self.host = host
        self.port = self._server.port
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._thread = threading.Thread(target=self._server.serve,
                                        name=f"exec-flight-{self.port}",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        try:
            self._server.shutdown()
        except Exception:  # noqa: BLE001 — shutdown is best-effort
            log.debug("executor flight shutdown", exc_info=True)
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    # --- serving ---------------------------------------------------------
    def _resolve(self, raw: bytes) -> str:
        token = ""
        try:
            obj = json.loads(raw.decode("utf-8"))
            path = obj["path"]
            token = obj.get("token", "")
        # a ticket that is not JSON is the raw shuffle-file path
        except Exception:  # noqa: BLE001 — raw path ticket
            path = raw.decode("utf-8")
        if self._token and token != self._token:
            raise self._fl.FlightUnauthorizedError("data plane auth failed")
        base = os.path.realpath(self.work_dir)
        target = os.path.realpath(path)
        if os.path.commonpath([base, target]) != base:
            raise self._fl.FlightServerError(
                f"path {path!r} escapes the work dir")
        if not os.path.exists(target):
            raise self._fl.FlightServerError(f"no such shuffle file: {path}")
        return target

    def _do_get(self, raw: bytes):
        import pyarrow as pa

        path = self._resolve(raw)
        reader = pa.ipc.open_file(pa.memory_map(path))
        # batch by batch off the memory map: read_all() would hold the
        # whole partition in host memory per concurrent fetch
        batches = (reader.get_batch(i)
                   for i in range(reader.num_record_batches))
        return self._fl.GeneratorStream(reader.schema, batches)
