"""Per-session isolation on a shared scheduler.

Mirrors arrow_ballista_tpu/scheduler/session.py: each client gets its own
validated ``BallistaConfig`` and its own table namespace, so two clients
with different ``ballista.shuffle.partitions`` see neither each other's
settings nor each other's tables.  ``OverlayCatalog`` gives a session a
private namespace that falls back to the scheduler's shared catalog;
``SessionManager`` creates, updates and lazily expires sessions.  A
session's admission identity (its tenant and quota request) comes with
the admission controller, ROADMAP.md queue 1 item 12 D.
"""
from __future__ import annotations

import threading
import time
import uuid
from typing import Dict, Optional

from ..catalog import SchemaCatalog, TableProvider
from ..utils.config import BallistaConfig
from ..utils.errors import PlanningError


class OverlayCatalog(SchemaCatalog):
    def __init__(self, parent: SchemaCatalog):
        super().__init__()
        self.parent = parent

    def table_schema(self, name: str):
        p = self.tables.get(name)
        if p is not None:
            return p.schema
        return self.parent.table_schema(name)

    def table_names(self):
        return sorted(set(self.parent.table_names()) | set(self.tables))

    def provider(self, name: str) -> TableProvider:
        p = self.tables.get(name)
        if p is not None:
            return p
        return self.parent.provider(name)


class Session:
    def __init__(self, session_id: str, config: BallistaConfig,
                 catalog: OverlayCatalog):
        self.id = session_id
        self.config = config
        self.catalog = catalog
        self.created = time.time()
        self.last_used = self.created
        # prepared statements: id -> (sql, result schema)
        self.prepared: Dict[str, tuple] = {}

    def touch(self):
        self.last_used = time.time()

    @property
    def tenant(self) -> str:
        """The admission identity: the session id (the shared
        ``ballista.admission.tenant`` key comes with the admission
        controller)."""
        return self.id

    def admission_request(self, config: Optional[BallistaConfig] = None):
        """The admission request of a submission from this session: not
        called until the admission controller is ported."""
        raise NotImplementedError(
            "admission control is not ported yet (ROADMAP.md queue 1 item 12 D)")


class SessionManager:
    """Create, update and expire sessions; a session idle beyond ``ttl_s``
    is evicted lazily."""

    def __init__(self, default_config: BallistaConfig,
                 shared_catalog: SchemaCatalog, ttl_s: float = 3600.0):
        self.default_config = default_config
        self.shared_catalog = shared_catalog
        self.ttl_s = ttl_s
        self._sessions: Dict[str, Session] = {}
        self._lock = threading.Lock()

    def create_session(self, settings: Optional[Dict[str, str]] = None) -> Session:
        sid = f"sess-{uuid.uuid4().hex[:12]}"
        config = BallistaConfig({**self.default_config._settings,
                                 **(settings or {})})
        session = Session(sid, config, OverlayCatalog(self.shared_catalog))
        with self._lock:
            self._evict_expired_locked()
            self._sessions[sid] = session
        return session

    def update_session(self, session_id: str,
                       settings: Dict[str, str]) -> Session:
        s = self.get(session_id)
        s.config = BallistaConfig({**s.config._settings, **settings})
        return s

    def get(self, session_id: Optional[str]) -> Optional[Session]:
        if session_id is None:
            return None
        with self._lock:
            s = self._sessions.get(session_id)
        if s is None:
            raise PlanningError(f"unknown or expired session {session_id!r}")
        s.touch()
        return s

    def remove_session(self, session_id: str) -> None:
        with self._lock:
            self._sessions.pop(session_id, None)

    def _evict_expired_locked(self) -> None:
        # the caller holds self._lock
        now = time.time()
        for sid in [sid for sid, s in self._sessions.items()
                    if now - s.last_used > self.ttl_s]:
            del self._sessions[sid]

    def count(self) -> int:
        with self._lock:
            return len(self._sessions)
