"""Length-prefixed JSON+binary framing over TCP.

Mirrors arrow_ballista_tpu/net/wire.py.  The control plane and the data
plane of the remote engine share one framing:

    frame := u32 json_len | u64 bin_len | json bytes | bin bytes

Control messages put everything in the JSON part; the data plane returns
Arrow IPC bytes in the binary part (no base64).  The binary length is
64-bit, so shuffle partitions past 4 GiB cross whole.  Requests carry a
``method`` field; responses carry ``ok`` and either ``payload`` or
``error``.  Every socket sets TCP_NODELAY (small control frames must not
wait on Nagle).  ``call`` passes the ``rpc.client.send`` failpoint
(faults/): a drop raises before the connect, a corrupt mangles both parts
of the response.
"""
from __future__ import annotations

import json
import socket
import struct
from typing import Optional, Tuple

from .. import faults

_HDR = struct.Struct("!IQ")
MAX_FRAME = 1 << 30  # 1 GiB guard for the JSON part
MAX_BIN = 1 << 40  # 1 TiB guard for the binary part


def send_frame(sock: socket.socket, obj: dict, binary: bytes = b"") -> None:
    payload = json.dumps(obj, separators=(",", ":")).encode()
    sock.sendall(_HDR.pack(len(payload), len(binary)) + payload + binary)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    chunks = []
    got = 0
    while got < n:
        b = sock.recv(min(n - got, 1 << 20))
        if not b:
            raise ConnectionError("peer closed mid-frame")
        chunks.append(b)
        got += len(b)
    return b"".join(chunks)


def recv_frame_raw(sock: socket.socket) -> Tuple[bytes, bytes]:
    """Receive one frame without parsing the JSON part (the client path
    parses separately so injected corruption surfaces as a diagnosable
    ``IntegrityError`` instead of a bare ``json.JSONDecodeError``)."""
    hdr = _recv_exact(sock, _HDR.size)
    jlen, blen = _HDR.unpack(hdr)
    if jlen > MAX_FRAME or blen > MAX_BIN:
        raise ConnectionError(f"oversized frame ({jlen}/{blen})")
    jbytes = _recv_exact(sock, jlen) if jlen else b""
    binary = _recv_exact(sock, blen) if blen else b""
    return jbytes, binary


def recv_frame(sock: socket.socket) -> Tuple[dict, bytes]:
    jbytes, binary = recv_frame_raw(sock)
    return (json.loads(jbytes) if jbytes else {}), binary


def connect(host: str, port: int, timeout: float = 20.0) -> socket.socket:
    sock = socket.create_connection((host, port), timeout=timeout)
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    return sock


def call(host: str, port: int, method: str, payload: Optional[dict] = None,
         binary: bytes = b"", timeout: float = 60.0,
         connect_timeout: Optional[float] = None) -> Tuple[dict, bytes]:
    """One-shot RPC: connect, send request, read response, close.

    ``connect_timeout`` bounds TCP establishment separately from the read
    deadline (``timeout``); it defaults to the read deadline for backwards
    compatibility — ``net.retry.RetryPolicy`` callers pass both.
    """
    rule = faults.inject("rpc.client.send", method=method, host=host,
                         port=port)
    if rule is not None and rule.action == "drop":
        raise ConnectionError(
            f"failpoint rpc.client.send dropped {method} request")
    sock = connect(host, port,
                   connect_timeout if connect_timeout is not None else timeout)
    try:
        sock.settimeout(timeout)
        req = {"method": method, "payload": payload or {}}
        send_frame(sock, req, binary)
        jbytes, rbin = recv_frame_raw(sock)
        if rule is not None and rule.action == "corrupt":
            # deterministic wire-frame corruption: both response parts, as a
            # flaky NIC would deliver
            jbytes = faults.corrupt_bytes(jbytes)
            rbin = faults.corrupt_bytes(rbin)
        try:
            resp = json.loads(jbytes) if jbytes else {}
        except Exception as e:
            from ..utils.errors import IntegrityError

            raise IntegrityError(
                "rpc.client.send",
                f"undecodable response frame ({len(jbytes)} bytes): {e}",
                method=method, host=host, port=port) from e
        if not resp.get("ok"):
            raise RemoteError(resp.get("error", "unknown remote error"),
                              resp.get("error_kind", ""))
        return resp.get("payload", {}), rbin
    finally:
        sock.close()


class RemoteError(Exception):
    def __init__(self, message: str, kind: str = ""):
        super().__init__(message)
        self.kind = kind
