"""ctypes binding of the native shuffle data plane (native/dataplane.cpp).

The port's own copy of arrow_ballista_tpu/native.py, changed in where and
how it builds: ``g++`` with the reference's flags compiles the repo's
``native/dataplane.cpp`` into ``arrow_ballista_tpu_torch/_build/``, under a
name that carries the hash of the source and the flags.  The compiler
writes a per-process temporary file that ``os.replace`` renames into
place, so a process loading the library while another builds it sees the
whole file or none, and nothing under ``native/`` is ever written.

The native server is an optional acceleration (shuffle bytes go
kernel -> socket through ``sendfile``, with no GIL): where it cannot build
or start, the executor serves its partitions through the Python RPC
handler (executor/server.py).
"""
from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

log = logging.getLogger(__name__)

_PKG = Path(__file__).resolve().parent
SOURCE = _PKG.parent / "native" / "dataplane.cpp"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ["-O2", "-std=c++17", "-fPIC", "-shared"]
LIBS = ["-lpthread"]

_lock = threading.Lock()
_dataplane_lib: Optional[ctypes.CDLL] = None
_dataplane_failed = False


def dataplane_path() -> Path:
    """Where the library of the current source and flags lives."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS + LIBS).encode())
    return BUILD_DIR / f"libdataplane-{h.hexdigest()[:16]}.so"


def _build() -> Optional[Path]:
    path = dataplane_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = ["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE), *LIBS]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (subprocess.SubprocessError, OSError) as e:
        stderr = getattr(e, "stderr", b"") or b""
        log.warning("native data plane build failed: %s %s", e,
                    stderr.decode(errors="replace")[-2000:])
        tmp.unlink(missing_ok=True)
        return None
    os.replace(tmp, path)  # atomic: a concurrent loader sees all or nothing
    return path


def dataplane() -> Optional[ctypes.CDLL]:
    """The native shuffle data-plane server, built on first use; None when
    it cannot be built or loaded."""
    global _dataplane_lib, _dataplane_failed
    with _lock:
        if _dataplane_lib is not None or _dataplane_failed:
            return _dataplane_lib
        so = _build() if SOURCE.exists() else None
        if so is None:
            _dataplane_failed = True
            return None
        try:
            lib = ctypes.CDLL(str(so))
        except OSError as e:
            log.warning("native data plane load failed: %s", e)
            _dataplane_failed = True
            return None
        lib.dp_start.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_int]
        lib.dp_start.restype = ctypes.c_int
        lib.dp_stop.argtypes = []
        lib.dp_stop.restype = None
        lib.dp_bytes_served.argtypes = []
        lib.dp_bytes_served.restype = ctypes.c_uint64
        _dataplane_lib = lib
        return lib
