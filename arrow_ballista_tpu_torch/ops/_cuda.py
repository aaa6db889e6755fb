"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled on its own by ``nvcc`` for ``sm_90a``
into a shared library with a plain C interface, at first use, into
``arrow_ballista_tpu_torch/_build/``.  The file name carries a hash of the
sources (and the shared headers), so an edited kernel is rebuilt and an
unchanged one is loaded as it is.  All missing libraries are compiled in
parallel, one ``nvcc`` each.  A build error raises; nothing falls back.

The libraries are bound with ``ctypes``: every pointer and the stream go
as ``c_void_p`` and every C function returns a ``cudaError_t`` that the
wrapper in ``ops/kernels.py`` checks (``check``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong

# C signatures: library -> {function: (argtypes, restype)}
SIGNATURES = {
    "hash": {
        "ab_hash64": ([_P, _P, _I, _LL, _I, _P, _P], _I),
        "ab_bucket_of": ([_P, _P, _I, _LL, _I, _I, _P, _P], _I),
    },
    "compact": {
        "ab_compact_tile": ([], _I),
        "ab_compaction_order": ([_P, _LL, _P, _P, _P], _I),
    },
    "sort": {
        "ab_sort_order": ([_P, _P, _P, _I, _P, _LL, _P, _P, _P, _P, _P], _I),
    },
    "dense_agg": {
        "ab_dense_group_states": ([_P, _P, _LL, _I, _P, _P, _P, _P], _I),
    },
    "join_build": {
        "ab_build_scratch_bytes": ([_LL], _LL),
        "ab_build_side_sort": ([_P, _P, _I, _P, _LL, _I, _P, _P, _P, _P, _P], _I),
    },
    "probe": {
        "ab_probe_scratch_bytes": ([_LL], _LL),
        "ab_probe_counts": ([_P, _P, _LL, _P, _LL, _P, _P, _P, _P, _P, _P], _I),
        "ab_probe_expand": ([_P, _P, _P, _P, _LL, _LL, _LL, _P, _P, _P, _P], _I),
    },
    "segment": {
        "ab_segment_any": ([_P, _I, _P, _LL, _LL, _P, _P], _I),
    },
    "seg_agg": {
        "ab_seg_scratch_bytes": ([_LL], _LL),
        "ab_grouped_on_order": ([_P, _P, _LL, _LL, _P, _P, _P, _P], _I),
    },
    "clustered": {
        "ab_presorted_disorder": ([_P, _I, _P, _LL, _P, _P], _I),
        "ab_key_range_check": ([_P, _I, _P, _LL, _I, _LL, _LL, _LL, _P, _P], _I),
        "ab_clustered_keep": ([_P, _I, _P, _P, _LL, _P, _P, _I, _P, _P, _P], _I),
    },
}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the port's kernels")


def _source_digest(name: str) -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_source_digest(name)}.so"


class KernelLibraries:
    """The loaded kernel libraries of one process, built on first use."""

    def __init__(self):
        self._lock = threading.Lock()
        self._libs: Dict[str, ctypes.CDLL] = {}
        self.build_seconds = 0.0

    def build_all(self) -> Dict[str, Path]:
        """Compile every library that is missing, all ``nvcc`` processes
        started together; returns name -> path."""
        import time

        paths = {name: library_path(name) for name in SIGNATURES}
        todo = {n: p for n, p in paths.items() if not p.exists()}
        if not todo:
            return paths
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = nvcc_path()
        t0 = time.perf_counter()
        procs = {}
        for name, path in todo.items():
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True),
                           tmp, path)
        failures = []
        for name, (proc, tmp, path) in procs.items():
            out, _ = proc.communicate()
            if proc.returncode != 0:
                failures.append(f"{name}.cu (exit {proc.returncode}):\n{out}")
                continue
            os.replace(tmp, path)  # atomic: a concurrent loader sees all or nothing
        self.build_seconds += time.perf_counter() - t0
        if failures:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
        return paths

    def get(self, name: str) -> ctypes.CDLL:
        with self._lock:
            lib = self._libs.get(name)
            if lib is not None:
                return lib
            paths = self.build_all()
            for lname, path in paths.items():
                if lname in self._libs:
                    continue
                loaded = ctypes.CDLL(str(path))
                for fn, (argtypes, restype) in SIGNATURES[lname].items():
                    f = getattr(loaded, fn)
                    f.argtypes = argtypes
                    f.restype = restype
                self._libs[lname] = loaded
            return self._libs[name]


LIBRARIES = KernelLibraries()


def check(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {what} failed to launch: cudaError_t {err}")
