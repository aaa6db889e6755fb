"""Minimal observability HTTP listener (executor /metrics + /health).

The executor-side analog of the scheduler's RestApi: a
ThreadingHTTPServer over closured GET routes, each returning
``(body, content_type)``.  Kept generic so any daemon role can expose a
scrape surface without dragging in the scheduler package.  The port's copy
of arrow_ballista_tpu/obs/http.py; the remote executor serves it
(executor/server.py ``metrics_port``).
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Tuple

PROM_CTYPE = "text/plain; version=0.0.4; charset=utf-8"


class ObsHttpServer:
    def __init__(self, host: str, port: int,
                 routes: Dict[str, Callable[[], Tuple[str, str]]]):
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, code: int, body: str, ctype: str):
                data = body.encode()
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                route = outer.routes.get(self.path.split("?", 1)[0])
                if route is None:
                    self._send(404, json.dumps({"error": "not found"}),
                               "application/json")
                    return
                try:
                    body, ctype = route()
                    self._send(200, body, ctype)
                except Exception as e:  # noqa: BLE001
                    self._send(500, json.dumps({"error": str(e)}),
                               "application/json")

        self.routes = dict(routes)
        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.host, self.port = self._httpd.server_address
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name=f"obs-http-{self.port}",
                                        daemon=True)

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        if self._thread.is_alive():
            self._httpd.shutdown()
            self._thread.join(timeout=5.0)
        self._httpd.server_close()
