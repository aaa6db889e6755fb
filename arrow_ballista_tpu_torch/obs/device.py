"""Device observatory of the port: a launch registry over its own kernels.

The operator observability stack (obs/stats.py, obs/tracing.py) stops at
the operator boundary — rows, bytes, wall time.  This module observes the
layer underneath, the hand-written and generated CUDA kernels of the port:

- **Kernel launches.**  ``ops/kernels.py`` ``count_launch`` is the single
  point every launch goes through (the hand-written wrappers and the
  generated K12 / K13 / K15 / K19 programs).  Besides the process counter
  it keeps (``kernels.LAUNCHES``), it hands each launch here, which
  attributes it by kernel name to the open operator scope and task scope
  (``launches.<kernel>`` and ``kernel_launches``).
- **Kernel event times.**  Inside a task scope on a CUDA device, each
  launch is bracketed by two CUDA events on its stream: the first is
  recorded when the wrapper fetches the launch stream (``kernels._stream``
  calls ``launch_begin``), the second when it counts the launch.  Nothing
  synchronizes per launch: the events are resolved once, when the task
  scope closes, into ``kernel_ms.<kernel>`` and ``kernel_ms`` of the task
  and of the operator that launched it.  A wrapper whose one launch call
  queues several kernels (K4's onesweep passes, K6's fill) is timed as one
  bracket; a wrapper that reads a value back between its launches (K4's
  onesweep form reads the key range) has that wait inside its bracket.  On
  an idle card a start event completes as soon as the host records it, so
  a bracket times the host's span from the stream fetch to the count, the
  kernel's time being its lower bound: it nears the kernel's time only
  where the kernel is long or the stream busy (the profiler gives kernel
  times).
  Outside a task scope, and on the CPU, launches are counted and never
  timed: there are no kernel times to report, and none are made up.
- **Generated-source builds** keep the reference's key names:
  ``jit_compiles`` / ``jit_compile_time`` count the nvcc builds of
  generated sources under an operator (``ops/_cuda.py``
  ``generated_builds``), ``jit_retraces`` a second distinct generated
  source built for the same operator signature, ``jit_cache_hits`` the
  program lookups served by a built library (``compile/programs.py``).
- **Host<->device transfers** through the two materialization sites,
  ``models/batch.py`` ``upload`` (h2d) and ``ColumnBatch.packed_numpy``
  (d2h), on a CUDA device only (on the CPU nothing crosses a bus).
- **Memory watermarks**: ``torch.cuda.memory_allocated`` of the task's
  device and the host RSS peak, sampled at task boundaries and at the
  operator boundaries inside a task.

Attribution is scope-based and thread-local: ``TaskContext.op_span``
enters an *op scope* (the operator's MetricsSet), the executor's
``run_task`` (and the local engine's EXPLAIN ANALYZE) enters a *task
scope* (a per-task accumulator that becomes ``TaskStatus.device_stats``),
and a process-global ``STATS`` feeds the executor's exposition.  The
standalone engine's task threads each see their own scopes.  Keys reuse
the ``_time`` / ``_bytes`` suffix conventions of the reference's
observatory so stage summaries, EXPLAIN ANALYZE, the doctor and the
advisor fold them unchanged; the launch keys carry neither suffix, so they
add to no operator's time or byte total.

Everything is behind ``ballista.observability.device.enabled``; when off
every entry point is one predicate check and the scopes are a shared null
context manager.
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, Optional, Tuple

# process-wide switches; flipped from config by Executor.__init__ and the
# local engine's entry points (module default matches the config default)
_enabled = True
_watermarks = True
# open task scopes that time launches (CUDA device), process-wide: the
# launch path's one predicate (kernels._stream) reads it
_timing = False
_timed_scopes = 0
_timed_lock = threading.Lock()


def set_enabled(on: bool) -> None:
    global _enabled
    _enabled = bool(on)


def enabled() -> bool:
    return _enabled


def set_watermarks(on: bool) -> None:
    global _watermarks
    _watermarks = bool(on)


# --------------------------------------------------------------------------
# process-global counters (executor exposition)
# --------------------------------------------------------------------------

_COUNTER_KEYS = (
    "jit_compiles", "jit_retraces", "jit_cache_hits", "jit_compile_time",
    "h2d_bytes", "d2h_bytes", "h2d_transfers", "d2h_transfers",
    "h2d_time", "d2h_time",
    "program_cache_hits", "program_cache_misses",
    "kernel_ms",
)
_PEAK_KEYS = ("device_live_peak_bytes", "host_rss_peak_bytes")


class _ProcessStats:
    """Monotone process totals + watermark maxima (one per process; the
    standalone engine's in-process executors share it).  Launch counts are
    not kept here: ``kernels.LAUNCHES`` is the process counter."""

    def __init__(self):
        self._lock = threading.Lock()
        self._c: Dict[str, float] = {k: 0 for k in _COUNTER_KEYS}
        self._p: Dict[str, int] = {k: 0 for k in _PEAK_KEYS}

    def add(self, key: str, v: float) -> None:
        with self._lock:
            self._c[key] = self._c.get(key, 0) + v

    def peak(self, key: str, v: int) -> None:
        with self._lock:
            if v > self._p.get(key, 0):
                self._p[key] = v

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            out = dict(self._c)
            out.update(self._p)
            return out

    def reset(self) -> None:  # test hook
        with self._lock:
            self._c = {k: 0 for k in _COUNTER_KEYS}
            self._p = {k: 0 for k in _PEAK_KEYS}
        _BUILT.clear()


STATS = _ProcessStats()

# operator signature -> the generated sources built for it (jit_retraces)
_BUILT: Dict[str, set] = {}

# --------------------------------------------------------------------------
# scope stacks (thread-local: a task runs on one pool thread; work an
# operator farms to helper threads is attributed to process totals only)
# --------------------------------------------------------------------------

_tls = threading.local()

_NULL = contextlib.nullcontext()


def _op_stack(create: bool = False):
    s = getattr(_tls, "ops", None)
    if s is None and create:
        s = _tls.ops = []
    return s


def _task_stack(create: bool = False):
    s = getattr(_tls, "tasks", None)
    if s is None and create:
        s = _tls.tasks = []
    return s


def _record(key: str, v: float) -> None:
    """Fold one device event into every open scope + the process totals."""
    STATS.add(key, v)
    ops = _op_stack()
    if ops:
        ops[-1].ms.add(key, v)
    tasks = _task_stack()
    if tasks:
        tasks[-1].acc.add(key, v)


class _OpScope:
    """Binds an operator's MetricsSet as the attribution target for the
    device events recorded inside its execute call.  Launch counts gather
    in a plain dict on the scope (one thread writes it) and fold into the
    MetricsSet once, at exit.  ``timed`` also times the call into the
    operator's ``elapsed_time`` (TaskContext.op_span's timer)."""

    __slots__ = ("ms", "name", "launches", "_timed", "_t0")

    def __init__(self, op, timed: bool = False):
        self.ms = op.metrics()
        self.name = type(op).__name__
        self.launches: Optional[Dict[str, int]] = None
        self._timed = timed
        self._t0 = 0.0

    def __enter__(self):
        _op_stack(create=True).append(self)
        if self._timed:
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._timed:
            self.ms.add("elapsed_time", time.perf_counter() - self._t0)
        stack = _op_stack()
        if stack:
            stack.pop()
        if self.launches:
            for name, n in self.launches.items():
                self.ms.add("launches." + name, n)
            self.ms.add("kernel_launches", sum(self.launches.values()))
        if _task_stack():
            sample_watermarks()
        return False


def op_scope(op, timed: bool = False):
    """Device-attribution scope for one operator execute call (entered by
    ``TaskContext.op_span``; a shared null context when the observatory is
    off)."""
    if not _enabled:
        return _NULL
    return _OpScope(op, timed)


class TaskAccumulator:
    """Per-task device-event fold; ``snapshot()`` becomes
    ``TaskStatus.device_stats`` (only when non-empty, so disabled mode
    adds no keys)."""

    __slots__ = ("_lock", "values")

    def __init__(self):
        self._lock = threading.Lock()
        self.values: Dict[str, float] = {}

    def add(self, key: str, v: float) -> None:
        with self._lock:
            self.values[key] = self.values.get(key, 0) + v

    def peak(self, key: str, v: int) -> None:
        with self._lock:
            if v > self.values.get(key, 0):
                self.values[key] = v

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            out = {}
            for k, v in sorted(self.values.items()):
                out[k] = round(v, 6) if isinstance(v, float) else v
            return out


# CUDA events are reused across launches: creating one costs a driver call
_EVENT_POOL: Dict[int, list] = {}


def _event(index: int):
    pool = _EVENT_POOL.get(index)
    if pool:
        try:
            return pool.pop()
        except IndexError:
            pass
    import torch

    with torch.cuda.device(index):
        return torch.cuda.Event(enable_timing=True)


class _TaskScope:
    __slots__ = ("acc", "device", "index", "launches", "start", "pending")

    def __init__(self, device):
        self.acc = TaskAccumulator()
        self.device = device
        # events only on a CUDA device: the CPU has no kernel times
        self.index = None
        if device is not None and getattr(device, "type", "") == "cuda":
            import torch

            self.index = device.index if device.index is not None \
                else torch.cuda.current_device()
        self.launches: Dict[str, int] = {}
        self.start = None      # the open bracket's first event
        self.pending = []      # [(kernel, op scope or None, start, end)]

    def __enter__(self):
        global _timing, _timed_scopes
        _task_stack(create=True).append(self)
        if self.index is not None:
            with _timed_lock:
                _timed_scopes += 1
                _timing = True
        sample_watermarks()
        return self.acc

    def __exit__(self, *exc):
        global _timing, _timed_scopes
        if self.index is not None:
            with _timed_lock:
                _timed_scopes -= 1
                _timing = _timed_scopes > 0
        try:
            self._resolve()
        finally:
            if self.launches:
                for name, n in self.launches.items():
                    self.acc.add("launches." + name, n)
                self.acc.add("kernel_launches", sum(self.launches.values()))
            sample_watermarks(final=True)
            stack = _task_stack()
            if stack:
                stack.pop()
        return False

    def _resolve(self) -> None:
        """The task's event pairs, resolved once: one wait on the last end
        event, then every elapsed time."""
        pending, self.pending = self.pending, []
        if self.start is not None:
            _EVENT_POOL.setdefault(self.index, []).append(self.start)
            self.start = None
        if not pending:
            return
        pending[-1][3].synchronize()
        per_op: Dict[int, Tuple[object, Dict[str, float]]] = {}
        total = 0.0
        for name, op, start, end in pending:
            ms = start.elapsed_time(end)
            total += ms
            self.acc.add("kernel_ms." + name, ms)
            if op is not None:
                d = per_op.setdefault(id(op), (op, {}))[1]
                d[name] = d.get(name, 0.0) + ms
            _EVENT_POOL.setdefault(self.index, []).extend((start, end))
        self.acc.add("kernel_ms", total)
        STATS.add("kernel_ms", total)
        for op, d in per_op.values():
            for name, ms in d.items():
                op.ms.add("kernel_ms." + name, ms)
            op.ms.add("kernel_ms", sum(d.values()))


class _NullTaskScope:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL_TASK = _NullTaskScope()


def task_scope(device=None):
    """Device-accounting scope for one task on ``device`` (a
    ``torch.device``; launches are timed on a CUDA one); yields the
    accumulator, or None when the observatory is off."""
    if not _enabled:
        return _NULL_TASK
    return _TaskScope(device)


# --------------------------------------------------------------------------
# the launch registry (ops/kernels.py calls these)
# --------------------------------------------------------------------------

def launch_begin() -> None:
    """The launch stream was fetched for a launch: open its bracket with a
    start event, unless one is already open on this thread's task.  Called
    only while some task scope times launches (``_timing``)."""
    tasks = _task_stack()
    if not tasks:
        return
    sc = tasks[-1]
    if sc.index is None or sc.start is not None:
        return
    import torch

    ev = _event(sc.index)
    ev.record(torch.cuda.current_stream(sc.index))
    sc.start = ev


def record_launch(name: str) -> None:
    """One launch of kernel ``name`` (``kernels.count_launch``, with the
    observatory on): attributed to the open op and task scopes, and its
    bracket closed with an end event when one is open."""
    ops = _op_stack()
    op = ops[-1] if ops else None
    if op is not None:
        if op.launches is None:
            op.launches = {}
        op.launches[name] = op.launches.get(name, 0) + 1
    tasks = _task_stack()
    if not tasks:
        return
    sc = tasks[-1]
    sc.launches[name] = sc.launches.get(name, 0) + 1
    if sc.start is not None:
        import torch

        end = _event(sc.index)
        end.record(torch.cuda.current_stream(sc.index))
        sc.pending.append((name, op, sc.start, end))
        sc.start = None


# --------------------------------------------------------------------------
# event recorders
# --------------------------------------------------------------------------

def record_transfer(direction: str, nbytes: int, seconds: float = 0.0) -> None:
    """Account one host<->device materialization.  ``direction`` is
    ``"h2d"`` (the batch upload: ``seconds`` is its enqueue cost, the copy
    being asynchronous) or ``"d2h"`` (the packed host collect, synchronous:
    ``seconds`` is the whole transfer)."""
    if not _enabled:
        return
    _record(f"{direction}_bytes", int(nbytes))
    _record(f"{direction}_transfers", 1)
    if seconds:
        _record(f"{direction}_time", seconds)


def record_program_cache(hit: bool) -> None:
    """Hit/miss accounting for the process-wide shared_program cache
    (ops/physical.py)."""
    if not _enabled:
        return
    _record("program_cache_hits" if hit else "program_cache_misses", 1)


def record_generated(op, signature: str, source: str, seconds: Optional[float]) -> None:
    """One generated program of operator ``op`` (a plan node, or None for
    the open op scope's) looked up before a launch: ``seconds`` is its nvcc
    build time when this lookup built it, None when a built library served
    it.  A build is a compile when it is the first source of ``signature``,
    a retrace when the signature already built another source."""
    if not _enabled:
        return
    if seconds is None:
        key, secs = "jit_cache_hits", 0.0
    else:
        seen = _BUILT.setdefault(signature, set())
        key = "jit_retraces" if seen and source not in seen else "jit_compiles"
        seen.add(source)
        secs = float(seconds)
    targets = [op.metrics()] if op is not None else \
        [s.ms for s in (_op_stack() or [])[-1:]]
    for ms in targets:
        ms.add(key, 1)
        if secs:
            ms.add("jit_compile_time", secs)
    STATS.add(key, 1)
    if secs:
        STATS.add("jit_compile_time", secs)
    tasks = _task_stack()
    if tasks:
        tasks[-1].acc.add(key, 1)
        if secs:
            tasks[-1].acc.add("jit_compile_time", secs)


def current_op_name() -> str:
    """Class name of the operator whose scope is open on this thread ('' when
    none): the signature of a generated source built at its first launch."""
    ops = _op_stack()
    return ops[-1].name if ops else ""


def sample_watermarks(final: bool = False) -> Optional[Tuple[int, int]]:
    """Sample the allocated bytes of the open task's device and the host
    RSS peak, and fold the maxima into the open task scope and the process
    stats.  ``final`` (a task scope's exit) also folds the device's
    ``max_memory_allocated`` into the process peak.  Returns the sample
    (device_bytes, host_rss_bytes) or None when off."""
    if not (_enabled and _watermarks):
        return None
    tasks = _task_stack()
    sc = tasks[-1] if tasks else None
    dev = 0
    if sc is not None and sc.index is not None:
        try:
            import torch

            dev = int(torch.cuda.memory_allocated(sc.index))
            if final:
                STATS.peak("device_live_peak_bytes",
                           int(torch.cuda.max_memory_allocated(sc.index)))
        except Exception:  # noqa: BLE001 — watermarks are best-effort
            dev = 0
    rss = 0
    try:
        import resource

        # ru_maxrss is KB on Linux
        rss = int(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss) * 1024
    except Exception:  # noqa: BLE001
        rss = 0
    STATS.peak("device_live_peak_bytes", dev)
    STATS.peak("host_rss_peak_bytes", rss)
    if sc is not None:
        sc.acc.peak("device_mem_peak", dev)
        sc.acc.peak("host_mem_peak", rss)
        sc.acc.add("watermark_samples", 1)
    return dev, rss
