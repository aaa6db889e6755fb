"""Threaded RPC server: dispatches wire frames to registered handlers.

Mirrors arrow_ballista_tpu/net/rpc.py: one thread per connection (handlers
are short; long work goes to the scheduler's event loop or the executor's
task pool), plain handlers that answer one frame, and streaming handlers
that push many (the chunked shuffle fetch).  ``stop`` severs the live
connections, so a stopped server looks like a dead process to its clients.
"""
from __future__ import annotations

import logging
import socket
import socketserver
import threading
from typing import Callable, Dict, Tuple

from ..utils.errors import BallistaError
from .wire import recv_frame, send_frame

log = logging.getLogger(__name__)

Handler = Callable[[dict, bytes], Tuple[dict, bytes]]
#: streaming handler: pushes 0+ frames itself via ``send(frame, binary)``
#: and returns when the stream is complete (the shuffle chunk protocol)
StreamHandler = Callable[[dict, bytes, Callable[[dict, bytes], None]], None]


class RpcServer:
    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self.handlers: Dict[str, Handler] = {}
        self.stream_handlers: Dict[str, StreamHandler] = {}
        # live connection sockets, severed on stop(): a stopped (or killed)
        # in-process server must look like a dead process to its clients,
        # not keep answering them off orphaned handler threads
        self._conns: set = set()
        self._conns_lock = threading.Lock()
        outer = self

        class _Conn(socketserver.BaseRequestHandler):
            def handle(self):
                sock = self.request
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                with outer._conns_lock:
                    outer._conns.add(sock)
                try:
                    while True:
                        req, binary = recv_frame(sock)
                        outer._dispatch(sock, req, binary)
                except (ConnectionError, OSError):
                    return
                finally:
                    with outer._conns_lock:
                        outer._conns.discard(sock)

        class _Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True
            # the listen backlog: socketserver's default of 5 overflows when
            # a stage's reduce tasks open their fetch streams at once, and a
            # dropped SYN waits a whole second to be sent again
            request_queue_size = 1024

        self._server = _Server((host, port), _Conn)
        self.host, self.port = self._server.server_address
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        name=f"rpc-{self.port}", daemon=True)

    def register(self, method: str, fn: Handler) -> None:
        self.handlers[method] = fn

    def register_stream(self, method: str, fn: StreamHandler) -> None:
        """Register a handler that writes its OWN response frames (many per
        request) through the ``send`` callback — the chunked shuffle fetch.
        Frame ordering is the handler thread's: one connection, one handler
        at a time, so chunks arrive in emission order."""
        self.stream_handlers[method] = fn

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        # socketserver.shutdown() waits on an event that only serve_forever
        # sets: calling it before start() would block forever
        if self._thread.is_alive():
            self._server.shutdown()
            # bounded: serve_forever returns once shutdown() is seen; the
            # timeout keeps a wedged accept loop from hanging teardown
            self._thread.join(timeout=5.0)
        self._server.server_close()
        # sever established connections: daemon handler threads would
        # otherwise keep serving pooled client sockets off this "dead"
        # server forever (a restart on the same port would go unnoticed)
        with self._conns_lock:
            conns = list(self._conns)
        for sock in conns:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass

    def _dispatch(self, sock, req: dict, binary: bytes) -> None:
        method = req.get("method", "")
        sfn = self.stream_handlers.get(method)
        if sfn is not None:
            try:
                sfn(req.get("payload", {}), binary,
                    lambda frame, rbin=b"": send_frame(sock, frame, rbin))
            except BallistaError as e:
                # mid-stream failure: the error frame takes the slot of the
                # next chunk; the client sees ok=false and maps error_kind
                # back to its exception taxonomy
                send_frame(sock, {"ok": False, "error": str(e),
                                  "error_kind": type(e).__name__})
            except Exception as e:  # noqa: BLE001 — report, keep serving
                log.exception("rpc stream handler %s failed", method)
                send_frame(sock, {"ok": False,
                                  "error": f"{type(e).__name__}: {e}"})
            return
        fn = self.handlers.get(method)
        if fn is None:
            send_frame(sock, {"ok": False, "error": f"unknown method {method!r}"})
            return
        try:
            payload, rbin = fn(req.get("payload", {}), binary)
            send_frame(sock, {"ok": True, "payload": payload}, rbin)
        except BallistaError as e:
            send_frame(sock, {"ok": False, "error": str(e),
                              "error_kind": type(e).__name__})
        except Exception as e:  # noqa: BLE001 — report, keep serving
            log.exception("rpc handler %s failed", method)
            send_frame(sock, {"ok": False, "error": f"{type(e).__name__}: {e}"})
