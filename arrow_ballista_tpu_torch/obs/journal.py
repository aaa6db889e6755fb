"""Flight recorder: an append-only, causally-ordered event journal.

The engine's telemetry (spans, stage stats, device accounting) answers
"how long did things take"; the journal answers "what actually happened,
in what order, and why" — every consequential control-plane decision is
one event: job lifecycle transitions, stage resolution, task
launch/finish/cancel per attempt, AQE rewrites, speculation launches and
wins, plan/result-cache hits and misses, quarantine and lease
transitions, failpoint firings.

The port's copy of the reference engine's flight recorder
(arrow_ballista_tpu/obs/journal.py), emitted from the counterparts of the
reference's sites on the local and standalone engines.

Design (the same cost discipline as obs/device.py):

- **Near-zero cost when off.**  Every entry point is one module-global
  predicate check; call sites guard with ``journal.enabled()`` before
  building attrs, so the disabled hot path allocates nothing.
- **Lock-free ring.**  Events are plain dicts appended to a bounded
  ``deque(maxlen=...)`` — append/evict is GIL-atomic, same idiom as
  ``ClusterHistory``.  Seq numbers come from ``itertools.count`` (also
  GIL-atomic), monotonic per process.
- **Causal order.**  Each event carries ``seq`` (monotonic per actor)
  and an optional ``parent`` seq: lifecycle events chain per job, and a
  task-finish event points at its launch via the causal-key registry
  (``causal_key=`` on the start event, ``parent_key=`` on the end).
- **Per-job timelines.**  The scheduler keeps one bounded timeline per
  job (merged from its own events plus executor events shipped
  piggyback on ``TaskStatus.journal``); ``job_timeline()`` feeds the
  forensics bundle.  Events can be epoch-tagged (``set_job_epoch``),
  marking the fencing epoch each decision ran under; the port has no
  fleet leases yet, so its events carry none.
- **Optional JSONL spill.**  ``ballista.journal.spill_path`` appends
  every event as one JSON line (file writes take a small lock; the ring
  stays lock-free).
- **Watch subscriptions.**  ``subscribe()`` returns a bounded
  per-subscriber queue fanned out from the emit path behind a single
  ``if _subs:`` predicate — no subscribers means no extra work, and a
  slow subscriber NEVER blocks ``emit()``: its queue drops the oldest
  events and the next ``drain()`` leads with an explicit ``watch.gap``
  event carrying the drop count.  This is the push half of the live
  observability plane (``ctx.watch``).

Config: ``ballista.journal.enabled`` / ``.capacity`` / ``.spill_path``.
Wire: executor events ride ``TaskStatus.journal`` only when non-empty,
so disabled mode is byte-identical to the pre-journal format (same
contract as ``device_stats``).
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

# process-wide switches; flipped from config by Executor.__init__ /
# SchedulerServer wiring (module default matches the config default)
_enabled = False
_capacity = 4096
_actor = ""           # scheduler_id / executor process identity
_spill_path = ""
_spill_lock = threading.Lock()
_spill_fh = None

#: most recent jobs whose timelines are retained (forensics window)
_JOB_RETAIN = 256

_seq = itertools.count(1)
# counters behind journal_events_total / journal_events_dropped_total;
# plain int += under the GIL — a lost increment under a pathological race
# is acceptable for monitoring counters
_emitted = 0
_dropped = 0

_ring: deque = deque(maxlen=_capacity)
# job_id -> bounded timeline (insertion order doubles as LRU for retention)
_jobs: Dict[str, deque] = {}
# job_id -> current lease/fencing epoch stamped onto that job's events
_job_epochs: Dict[str, int] = {}
# causal-key registry: (job_id, ...) -> seq of the "start" event
_causal: Dict[tuple, int] = {}
# live watch subscribers; fan-out is one predicate check when empty
_subs: List["Subscription"] = []

_tls = threading.local()


@dataclasses.dataclass
class JournalEvent:
    """Typed shape of one journal event.

    Internally the journal stores plain dicts (one allocation per event,
    wire-ready); this dataclass is the schema contract a serde layer
    round-trips."""

    seq: int
    ts_ms: int
    kind: str
    actor: str = ""
    job_id: str = ""
    epoch: int = 0
    parent: int = 0
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)


def set_enabled(on: bool) -> None:
    global _enabled
    _enabled = bool(on)


def enabled() -> bool:
    return _enabled


def configure(capacity: Optional[int] = None,
              spill_path: Optional[str] = None,
              actor: Optional[str] = None) -> None:
    """Apply config-derived settings (idempotent; resizing the ring keeps
    the newest events)."""
    global _capacity, _ring, _spill_path, _spill_fh, _actor
    if capacity is not None and int(capacity) != _capacity:
        _capacity = max(1, int(capacity))
        _ring = deque(_ring, maxlen=_capacity)
    if actor is not None:
        _actor = str(actor)
    if spill_path is not None and str(spill_path) != _spill_path:
        with _spill_lock:
            if _spill_fh is not None:
                try:
                    _spill_fh.close()
                except Exception:  # noqa: BLE001 — spill is best-effort
                    pass
                _spill_fh = None
            _spill_path = str(spill_path)


def set_actor(name: str) -> None:
    global _actor
    _actor = str(name)


def actor() -> str:
    return _actor


def counters() -> Tuple[int, int]:
    """(events_total, events_dropped_total) for the metrics exposition."""
    return _emitted, _dropped


def reset() -> None:
    """Test hook: drop all state, keep the enable flag."""
    global _emitted, _dropped, _ring, _seq
    _emitted = 0
    _dropped = 0
    _seq = itertools.count(1)
    _ring = deque(maxlen=_capacity)
    _jobs.clear()
    _job_epochs.clear()
    _causal.clear()
    for sub in list(_subs):
        sub.close()


# --------------------------------------------------------------------------
# emission
# --------------------------------------------------------------------------

def emit(kind: str, job_id: str = "", parent: Optional[int] = None,
         causal_key: Optional[tuple] = None,
         parent_key: Optional[tuple] = None,
         epoch: Optional[int] = None, **attrs) -> Optional[int]:
    """Record one event; returns its seq (None when the journal is off).

    ``causal_key`` registers this event's seq so a later event can chain
    to it with ``parent_key``; lifecycle chains pass the same tuple as
    both (each event becomes the next one's parent)."""
    if not _enabled:
        return None
    if parent is None and parent_key is not None:
        parent = _causal.get(parent_key)
    seq = next(_seq)
    ev: Dict[str, Any] = {"seq": seq, "ts_ms": int(time.time() * 1000),
                          "kind": kind}
    if _actor:
        ev["actor"] = _actor
    if job_id:
        ev["job_id"] = job_id
        ep = epoch if epoch is not None else _job_epochs.get(job_id, 0)
        if ep:
            ev["epoch"] = ep
    if parent:
        ev["parent"] = parent
    if attrs:
        ev["attrs"] = attrs
    if causal_key is not None:
        _causal[causal_key] = seq
    _append(ev, job_id)
    buf = getattr(_tls, "buf", None)
    if buf is not None:
        buf.append(ev)
    return seq


def emit_job(kind: str, job_id: str, **attrs) -> Optional[int]:
    """A job-lifecycle event: chained to the job's previous lifecycle
    event and registered as the next one's parent."""
    key = ("job", job_id)
    return emit(kind, job_id=job_id, causal_key=key, parent_key=key, **attrs)


def _append(ev: Dict[str, Any], job_id: str) -> None:
    global _emitted, _dropped
    _emitted += 1
    if len(_ring) >= _capacity:
        _dropped += 1
    _ring.append(ev)
    if job_id:
        tl = _jobs.get(job_id)
        if tl is None:
            tl = _jobs[job_id] = deque(maxlen=_capacity)
            _evict_jobs()
        elif len(tl) >= _capacity:
            _dropped += 1
        tl.append(ev)
    if _spill_path:
        _spill(ev)
    if _subs:
        _fanout(ev, job_id)


def _evict_jobs() -> None:
    while len(_jobs) > _JOB_RETAIN:
        victim = next(iter(_jobs))
        _jobs.pop(victim, None)
        _job_epochs.pop(victim, None)
        # causal keys always embed the job id (("job", jid) /
        # ("task", jid, ...)), so membership is the prune predicate
        for k in [k for k in _causal if victim in k]:
            _causal.pop(k, None)


def _spill(ev: Dict[str, Any]) -> None:
    global _spill_fh
    with _spill_lock:
        try:
            if _spill_fh is None:
                _spill_fh = open(_spill_path, "a", encoding="utf-8")
            _spill_fh.write(json.dumps(ev, separators=(",", ":"),
                                       default=str) + "\n")
            _spill_fh.flush()
        except Exception:  # noqa: BLE001 — spill is best-effort
            _spill_fh = None


# --------------------------------------------------------------------------
# per-job timelines (scheduler side) + executor piggyback intake
# --------------------------------------------------------------------------

def job_timeline(job_id: str) -> List[Dict[str, Any]]:
    """The merged per-job timeline (own events + absorbed executor
    events), oldest first.  Empty when the journal is off or the job has
    aged out of the retention window."""
    tl = _jobs.get(job_id)
    return list(tl) if tl is not None else []


def seed_job(job_id: str, events: List[Dict[str, Any]]) -> None:
    """Restore a checkpointed timeline (a new owner of the job continues
    the previous owner's record under the same job id)."""
    if not _enabled or not events:
        return
    tl = _jobs.get(job_id)
    if tl is None:
        tl = _jobs[job_id] = deque(maxlen=_capacity)
        _evict_jobs()
    have = {(e.get("actor", ""), e.get("seq", 0)) for e in tl}
    for ev in events:
        if (ev.get("actor", ""), ev.get("seq", 0)) not in have:
            tl.append(dict(ev))


def absorb(job_id: str, events: List[Dict[str, Any]]) -> int:
    """Merge executor-shipped events (``TaskStatus.journal``) into the
    job's timeline + the global ring.  Returns the number absorbed.

    Dedups on (actor, seq): in-proc standalone executors share this
    process-global journal, so their events already landed in the
    timeline at emit time — the piggyback copy must not double them.
    Remote executors carry a different actor, so theirs always merge."""
    if not _enabled or not events:
        return 0
    global _emitted, _dropped
    tl = _jobs.get(job_id)
    if tl is None:
        tl = _jobs[job_id] = deque(maxlen=_capacity)
        _evict_jobs()
    have = {(e.get("actor", ""), e.get("seq", 0)) for e in tl}
    n = 0
    for ev in events:
        if (ev.get("actor", ""), ev.get("seq", 0)) in have:
            continue
        _emitted += 1
        if len(tl) >= _capacity:
            _dropped += 1
        tl.append(ev)
        _ring.append(ev)
        if _subs:
            _fanout(ev, job_id)
        n += 1
    return n


def set_job_epoch(job_id: str, epoch: int) -> None:
    """Stamp subsequent events for ``job_id`` with the given fencing
    epoch (0 clears)."""
    if not _enabled:
        return
    if epoch:
        _job_epochs[job_id] = int(epoch)
    else:
        _job_epochs.pop(job_id, None)


# --------------------------------------------------------------------------
# executor task scope: buffer events for the TaskStatus piggyback
# --------------------------------------------------------------------------

class _TaskScope:
    __slots__ = ("events",)

    def __init__(self):
        self.events: List[Dict[str, Any]] = []

    def __enter__(self) -> List[Dict[str, Any]]:
        _tls.buf = self.events
        return self.events

    def __exit__(self, *exc) -> bool:
        _tls.buf = None
        return False


class _NullTaskScope:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc) -> bool:
        return False


_NULL_TASK = _NullTaskScope()


def task_scope():
    """Collect events emitted on this thread for one task run; yields the
    buffer (``TaskStatus.journal`` when non-empty) or None when off."""
    if not _enabled:
        return _NULL_TASK
    return _TaskScope()


# --------------------------------------------------------------------------
# watch subscriptions (live observability plane)
# --------------------------------------------------------------------------

class Subscription:
    """A bounded live tail of the journal for one consumer.

    The emit path offers events with plain GIL-atomic deque ops and a
    ``threading.Event`` set — it never blocks and never raises, whatever
    the consumer is doing.  When the consumer falls behind, the OLDEST
    queued events are discarded and the next ``drain()`` starts with one
    synthetic ``watch.gap`` event (``attrs.dropped`` = how many); gap
    events carry ``seq=0`` and must not be deduped on (actor, seq).
    """

    __slots__ = ("job_id", "capacity", "_q", "_gap", "_wake", "_closed")

    def __init__(self, job_id: Optional[str] = None, capacity: int = 1024):
        self.job_id = job_id or None
        self.capacity = max(1, int(capacity))
        self._q: deque = deque()
        self._gap = 0
        self._wake = threading.Event()
        self._closed = False

    def _offer(self, ev: Dict[str, Any]) -> None:
        # emitter side: bound the queue by shedding oldest (a best-effort
        # stale len() under a concurrent drain at worst sheds one event
        # early — it is counted in the gap either way)
        if self._closed:
            return
        if len(self._q) >= self.capacity:
            try:
                self._q.popleft()
                self._gap += 1
            except IndexError:
                pass
        self._q.append(ev)
        self._wake.set()

    def drain(self) -> List[Dict[str, Any]]:
        """All queued events, oldest first; a pending gap becomes one
        leading ``watch.gap`` event.  Never blocks."""
        self._wake.clear()
        out: List[Dict[str, Any]] = []
        gap, self._gap = self._gap, 0
        if gap:
            out.append({"seq": 0, "ts_ms": int(time.time() * 1000),
                        "kind": "watch.gap", "attrs": {"dropped": gap}})
        while True:
            try:
                out.append(self._q.popleft())
            except IndexError:
                break
        return out

    def poll(self, timeout: Optional[float] = None) -> List[Dict[str, Any]]:
        """Wait up to ``timeout`` for at least one event, then drain."""
        if not self._q and not self._gap and not self._closed:
            self._wake.wait(timeout)
        return self.drain()

    @property
    def closed(self) -> bool:
        return self._closed

    def close(self) -> None:
        self._closed = True
        try:
            _subs.remove(self)
        except ValueError:
            pass
        self._wake.set()

    def __enter__(self) -> "Subscription":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False


def subscribe(job_id: Optional[str] = None,
              capacity: int = 1024) -> Subscription:
    """Attach a live subscriber (``job_id=None`` follows every event).
    Close it (or use as a context manager) to detach; an attached
    subscriber costs the emit path one list scan per event."""
    sub = Subscription(job_id=job_id, capacity=capacity)
    _subs.append(sub)
    return sub


def _fanout(ev: Dict[str, Any], job_id: str) -> None:
    for sub in list(_subs):
        if sub.job_id is None or sub.job_id == job_id:
            sub._offer(ev)


def watcher_count() -> int:
    return len(_subs)


# --------------------------------------------------------------------------
# snapshot / exposition
# --------------------------------------------------------------------------

def snapshot(limit: Optional[int] = None) -> List[Dict[str, Any]]:
    """The newest ``limit`` events of the process-global ring (all when
    None), oldest first."""
    out = list(_ring)
    if limit is not None and len(out) > limit:
        out = out[-limit:]
    return out
