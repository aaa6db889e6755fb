"""Per-executor memory governor: reserve -> grant -> release accounting.

Mirrors the host pool of arrow_ballista_tpu/memory/governor.py.  The data
plane's two unbounded-state consumers — hash-join build sides and grouped-
aggregation state — ask the governor for a reservation *before*
materializing.  A grant means "proceed in memory"; a denial means "degrade
to spill" (memory/spill.py), never "crash the executor".  The budget is
``ballista.memory.host.budget.bytes``, pure reservation accounting: the
governor is the only admission gate, so reserved bytes are the model of
operator-held state.

The reference's device pool waits for the admission controller that reads
it (ROADMAP.md queue 1 item 12 D); the host pool's ``pressure`` rides the
remote executor's heartbeats (executor/server.py).
Every reservation passes the ``executor.memory.reserve`` failpoint
(faults/) first.

A denial raises :class:`~..utils.errors.MemoryExhausted`, retryable
back-pressure by taxonomy.  Process-global :data:`STATS` counts denials,
spill runs and bytes, and the reserved bytes.
"""
from __future__ import annotations

import threading
from typing import Dict, Optional

from .. import faults
from ..utils.config import MEM_HOST_BUDGET, MEM_SPILL_ENABLED, resolve_pool_budget
from ..utils.errors import MemoryExhausted

#: the one pool the port reserves from; named as the reference names it
POOL = "host"


class _MemoryStats:
    """Process-global memory-plane totals (one per process; the standalone
    engine's in-process executors share it)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._c: Dict[str, float] = {}
        self._reserved = 0

    def add(self, key: str, v: float = 1) -> None:
        with self._lock:
            self._c[key] = self._c.get(key, 0) + v

    def reserve_delta(self, delta: int) -> None:
        with self._lock:
            self._reserved += delta

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            out = dict(self._c)
            out[f"reserved_bytes.{POOL}"] = self._reserved
            return out

    def reset(self) -> None:
        with self._lock:
            self._c.clear()
            self._reserved = 0


STATS = _MemoryStats()


class Reservation:
    """A granted byte reservation; context-managed or released explicitly.
    ``release()`` is idempotent."""

    __slots__ = ("nbytes", "_gov")

    def __init__(self, gov: "MemoryGovernor", nbytes: int):
        self._gov = gov
        self.nbytes = int(nbytes)

    def release(self) -> None:
        gov, self._gov = self._gov, None
        if gov is not None:
            gov._release(self.nbytes)

    def __enter__(self) -> "Reservation":
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self):
        state = "released" if self._gov is None else "held"
        return f"Reservation({self.nbytes} bytes, {state})"


class MemoryGovernor:
    """Reserve/grant/release accounting over the host budget.

    Budget 0 means *unlimited* (the default): every reservation is granted
    and only the accounting runs.  Thread-safe: task threads reserve
    concurrently."""

    def __init__(self, host_budget: int = 0, spill_enabled: bool = True):
        self._lock = threading.Lock()
        self._budget = int(host_budget)
        self._reserved = 0
        self.spill_enabled = bool(spill_enabled)

    @staticmethod
    def from_config(cfg) -> "MemoryGovernor":
        return MemoryGovernor(host_budget=resolve_pool_budget(cfg, MEM_HOST_BUDGET),
                              spill_enabled=cfg.get(MEM_SPILL_ENABLED))

    # --- introspection --------------------------------------------------
    def budget(self) -> int:
        return self._budget

    def reserved(self) -> int:
        with self._lock:
            return self._reserved

    def available(self) -> Optional[int]:
        """Grantable bytes, or None when the budget is unlimited."""
        if self._budget <= 0:
            return None
        with self._lock:
            return self._budget - self._reserved

    def pressure(self) -> float:
        """Fraction of the host budget reserved (0.0 when unlimited): rides
        the remote executor's heartbeats (executor/server.py)."""
        if self._budget <= 0:
            return 0.0
        with self._lock:
            return self._reserved / self._budget

    # --- reserve / release ----------------------------------------------
    def reserve(self, nbytes: int, *, site: str = "") -> Reservation:
        """Grant ``nbytes`` or raise :class:`MemoryExhausted`.  The
        failpoint fires first, so a fault plan can deny (``error=resource``)
        or delay any grant."""
        nbytes = int(nbytes)
        faults.inject("executor.memory.reserve", pool=POOL, nbytes=nbytes, op=site)
        with self._lock:
            if self._budget > 0:
                avail = self._budget - self._reserved
                if nbytes > avail:
                    raise MemoryExhausted(POOL, nbytes, max(0, avail), site)
            self._reserved += nbytes
        STATS.reserve_delta(nbytes)
        return Reservation(self, nbytes)

    def try_reserve(self, nbytes: int, *, site: str = "") -> Optional[Reservation]:
        """Grant-or-None: the operator protocol.  None tells the caller to
        take its spill path (with spill disabled, the denial re-raises so
        the scheduler retries the task)."""
        try:
            return self.reserve(nbytes, site=site)
        except MemoryExhausted:
            STATS.add("reserve_denied_total")
            if not self.spill_enabled:
                raise
            return None

    def force_reserve(self, nbytes: int, *, site: str = "") -> Reservation:
        """Over-budget grant for operators with a hard single-pass need
        (left/full outer joins must see the whole build side).  Never
        denies; the overshoot shows in ``reserved()`` and the
        ``over_budget_grants_total`` counter."""
        nbytes = int(nbytes)
        with self._lock:
            if 0 < self._budget < self._reserved + nbytes:
                STATS.add("over_budget_grants_total")
            self._reserved += nbytes
        STATS.reserve_delta(nbytes)
        return Reservation(self, nbytes)

    def _release(self, nbytes: int) -> None:
        with self._lock:
            self._reserved -= nbytes
        STATS.reserve_delta(-nbytes)
