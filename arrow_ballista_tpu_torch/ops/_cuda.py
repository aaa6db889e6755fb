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

Generated sources (K12 and K13, one per fused chain, K15, one per
passthrough aggregate, K19, one per operator program, and the mesh derive,
one per mesh aggregate; compile/codegen.py) build the same way, by source:
a plan's K19 programs together before its first batch (``build_generated``,
one ``nvcc`` each, all started together), any other at first use.  The
``.cu`` is written into
``_build/`` under the hash of the source, the headers and the flags, and
built once per hash — under a per-hash lock, renamed into place when
finished, so task threads resolving the same chain build it once and a
file already built is loaded as it is.  They build with ``--fmad=false``:
a contracted multiply-add would round differently from the interpreted
chain.
"""
from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

log = logging.getLogger(__name__)

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
        "ab_spill_partition": ([_P, _P, _I, _LL, _I, _I, _P, _P], _I),
    },
    "compact": {
        "ab_compact_launches": ([_LL], _I),
        "ab_compact_tiles": ([_LL], _LL),
        "ab_compaction_order": ([_P, _LL, _P, _P, _P, _P, _P], _I),
        "ab_spill_launches": ([_LL], _I),
        "ab_spill_scratch_bytes": ([_LL, _I], _LL),
        "ab_spill_order": ([_P, _P, _I, _P, _LL, _I, _I, _P, _P, _P, _P, _P], _I),
    },
    "sort": {
        "ab_sort_minmax_blocks": ([_LL], _I),
        "ab_sort_minmax": ([_P, _P, _P, _I, _P, _LL, _P, _P], _I),
        "ab_sort_scratch_bytes": ([_LL, _I], _LL),
        "ab_sort_order": ([_P, _P, _P, _I, _P, _LL, _P, _P, _P, _I, _P, _P, _P], _I),
        "ab_sort_block_bytes": ([_LL, _I], _LL),
        "ab_sort_order_block": ([_P, _P, _P, _I, _P, _LL, _I, _P, _P, _P], _I),
    },
    "dense_agg": {
        "ab_dense_state_words": ([_I, _I], _LL),
        "ab_dense_group_states": ([_P, _P], _I),
    },
    "join_build": {
        "ab_build_is_block": ([_LL], _I),
        "ab_build_scratch_bytes": ([_LL], _LL),
        "ab_build_side_sort": ([_P, _P, _I, _P, _LL, _I, _P, _P, _P, _P, _P], _I),
    },
    "probe": {
        "ab_probe_state_words": ([_LL], _LL),
        "ab_probe_join": ([_P, _P, _LL, _P, _LL, _I, _LL, _P, _P, _P, _P, _P, _P, _P], _I),
    },
    "segment": {
        "ab_segment_state_words": ([_LL], _LL),
        "ab_segment_any": ([_P, _I, _P, _LL, _LL, _P, _I, _P, _P, _P], _I),
    },
    "seg_agg": {
        "ab_seg_state_words": ([_LL], _LL),
        "ab_seg_payload_words": ([_LL, _I], _LL),
        "ab_grouped_on_order": ([_P, _P, _P, _LL, _LL, _P, _P, _P, _P, _P], _I),
    },
    "clustered": {
        "ab_disorder_state_words": ([_LL], _LL),
        "ab_presorted_disorder": ([_P, _I, _P, _LL, _P, _P, _P], _I),
        "ab_key_range_check": ([_P, _I, _P, _LL, _I, _LL, _LL, _LL, _P, _P, _P], _I),
        "ab_clustered_keep": ([_P, _I, _P, _P, _LL, _P, _P, _I, _P, _P, _P, _P], _I),
    },
    "extract": {
        "ab_extract_field": ([_P, _LL, _I, _P, _P], _I),
    },
    "dispatch": {
        "ab_dispatch_scratch_ints": ([_LL, _I], _LL),
        "ab_dispatch_count": ([_P, _P, _LL, _I, _LL, _P, _P, _P, _P, _P], _I),
        "ab_dispatch_scatter": ([_P, _P, _LL, _I, _LL, _P, _P, _P, _P, _P], _I),
    },
    "rank_merge": {
        "ab_merge_spec_bytes": ([], _I),
        "ab_merge_columns": ([_P, _P], _I),
    },
    "gather": {
        "ab_concat_spec_bytes": ([_I], _I),
        "ab_concat_columns": ([_P, _I, _P], _I),
        "ab_gather_columns": ([_P, _LL, _P, _P], _I),
        "ab_mask_ops": ([_I, _P, _P, _LL, _LL, _LL, _P, _P], _I),
        "ab_bucket_masks": ([_P, _P, _LL, _I, _LL, _P, _P], _I),
    },
}


# the C interface of every generated source (csrc/fused_rows.cuh)
GENERATED_SIGNATURES = {
    "ab_fused_rows": ([_P, _P, _LL, _P], _I),
    "ab_fused_dense": ([_P, _P, _P], _I),
}
GENERATED_FLAGS = NVCC_FLAGS + ["--fmad=false", "-I", str(CSRC)]


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


def generated_path(source: str) -> Path:
    h = hashlib.sha256(source.encode())
    for p in sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(GENERATED_FLAGS).encode())
    return BUILD_DIR / f"libfused-{h.hexdigest()[:16]}.so"


class KernelLibraries:
    """The loaded kernel libraries of one process, built on first use."""

    def __init__(self):
        self._lock = threading.Lock()
        self._libs: Dict[str, ctypes.CDLL] = {}
        self.build_seconds = 0.0
        self._generated: Dict[Path, ctypes.CDLL] = {}
        self._by_source: Dict[str, ctypes.CDLL] = {}
        self._generated_locks: Dict[Path, threading.Lock] = {}
        # (library file name, nvcc seconds) of each generated source built
        self.generated_builds = []

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


    def _write_source(self, source: str, path: Path) -> Path:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        cu = path.with_suffix(".cu")
        tmp_cu = path.with_suffix(f".{os.getpid()}.{threading.get_ident()}.cu")
        tmp_cu.write_text(source)
        os.replace(tmp_cu, cu)
        return cu

    def _start_nvcc(self, source: str, path: Path):
        import time

        cu = self._write_source(source, path)
        tmp = path.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        proc = subprocess.Popen([nvcc_path(), *GENERATED_FLAGS, "-o", str(tmp), str(cu)],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        return proc, tmp, cu, time.perf_counter()

    def _finish_nvcc(self, job, path: Path) -> None:
        import time

        proc, tmp, cu, t0 = job
        out, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the generated source {cu} "
                               f"(exit {proc.returncode}):\n{out}")
        os.replace(tmp, path)
        with self._lock:
            self.generated_builds.append((path.name, seconds))
        log.info("built generated kernel %s in %.2f s", path.name, seconds)

    def build_generated(self, sources) -> None:
        """Build every generated source not built yet, all ``nvcc``
        processes started together (a plan's K19 programs, before its
        first batch).  A source already on disk or loaded builds nothing."""
        todo = {}
        for source in sources:
            if source in self._by_source:
                continue
            path = generated_path(source)
            if not path.exists():
                todo[path] = source
        if not todo:
            return
        locks = []
        with self._lock:
            for path in todo:
                locks.append(self._generated_locks.setdefault(path, threading.Lock()))
        for lock in locks:
            lock.acquire()
        try:
            jobs = {path: self._start_nvcc(source, path) for path, source in todo.items()
                    if not path.exists()}
            failures = []
            for path, job in jobs.items():
                try:
                    self._finish_nvcc(job, path)
                except RuntimeError as e:
                    failures.append(str(e))
            if failures:
                raise RuntimeError("\n".join(failures))
        finally:
            for lock in locks:
                lock.release()

    def get_generated(self, source: str) -> ctypes.CDLL:
        """The library of one generated source, built at first use."""
        lib = self._by_source.get(source)  # the launch path: one dict lookup
        if lib is not None:
            return lib
        path = generated_path(source)
        with self._lock:
            lib = self._generated.get(path)
            if lib is not None:
                self._by_source[source] = lib
                return lib
            lock = self._generated_locks.setdefault(path, threading.Lock())
        with lock:
            with self._lock:
                lib = self._generated.get(path)
            if lib is not None:
                return lib
            if not path.exists():
                self._finish_nvcc(self._start_nvcc(source, path), path)
                # built at its first launch (a fused chain): the build
                # counts against the operator whose scope is open
                from ..obs import device as device_obs

                device_obs.record_generated(None, device_obs.current_op_name(), path.name,
                                            self.generated_builds[-1][1])
            loaded = ctypes.CDLL(str(path))
            for fn, (argtypes, restype) in GENERATED_SIGNATURES.items():
                f = getattr(loaded, fn, None)
                if f is not None:
                    f.argtypes = argtypes
                    f.restype = restype
            with self._lock:
                self._generated[path] = loaded
                self._by_source[source] = loaded
            return loaded


LIBRARIES = KernelLibraries()


def check(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {what} failed to launch: cudaError_t {err}")
