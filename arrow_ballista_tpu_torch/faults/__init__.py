"""Deterministic fault injection (failpoints).

The port's copy of arrow_ballista_tpu/faults.  Named injection sites are
compiled into the executor/scheduler code paths (catalog in
``KNOWN_SITES``, the reference's whole catalog: plans naming the sites of
modules the port still lacks — RPC, heartbeats, leases, the KV store, the
cancel fan-out and the remote shuffle fetch — load, and those sites fire
once their modules are ported); a :class:`FaultPlan` — seeded, loaded
from the ``ballista.faults.plan`` config key or the ``BALLISTA_FAULTS_PLAN``
environment variable — maps sites to actions:

- ``raise``   raise a chosen error kind (``error``/``message`` fields),
- ``delay``   sleep ``delay_ms`` before proceeding,
- ``drop``    make the caller discard the payload (site-specific),
- ``corrupt`` deterministically flip bytes in the payload,
- ``kill``    abruptly stop the matching executor (k-th hit, via the
  kill-target registry) — or the whole process with ``scope: "process"``.

Rules select the k-th hit (``on_hit``), a fire budget (``times``), a
probability (``p``, drawn from the plan's seeded RNG so the schedule is
reproducible), and a context ``match`` (e.g. ``executor_id``/``stage_id``).
Every fire is appended to ``FaultPlan.events`` so tests can assert the
injection schedule (same seed + same hit sequence => same schedule).

With no plan installed every site is a no-op behind a single module-global
``None`` check — no locks, no allocation, no config lookup.

Plan JSON shape::

    {"seed": 42,
     "rules": [{"site": "executor.task.before_run", "action": "kill",
                "match": {"executor_id": "exec-0", "stage_id": 2},
                "on_hit": 1, "times": 1}]}
"""
from __future__ import annotations

import json
import logging
import os
import random
import threading
import time
from typing import Any, Callable, Dict, List, Optional

log = logging.getLogger(__name__)

ENV_PLAN = "BALLISTA_FAULTS_PLAN"

#: every failpoint compiled into the codebase (site -> where it lives)
KNOWN_SITES = frozenset({
    "executor.task.before_run",     # executor/executor.py, per task start
    "executor.task.slow",           # executor/executor.py, inside task run
                                    # (delay => deterministic straggler)
    "executor.status.report",       # executor/server.py reporter -> scheduler
    "executor.heartbeat.send",      # executor/server.py heartbeat -> scheduler
    "rpc.client.send",              # net/wire.py, every client-side RPC
    "shuffle.fetch.recv",           # net/dataplane.py, per fetch attempt
                                    # (+ per chunk on the streaming path,
                                    # with "chunk" in the match context)
    "scheduler.heartbeat.receive",  # scheduler/netservice.py handler
    "scheduler.status.receive",     # scheduler/netservice.py handler
    "scheduler.aqe.before_rewrite",  # scheduler/aqe.py, between an AQE
                                     # rewrite decision and the graph
                                     # mutation (drop => skip the rewrite)
    "scheduler.lease.renew",        # scheduler/scheduler.py lease loop, per
                                    # job renewal (raise => shard stops
                                    # renewing: simulated partition/hang)
    "scheduler.kv.txn",             # scheduler/kv.py fenced job writes,
                                    # before the guarded KV transaction
    "scheduler.adopt.before_resume",  # scheduler/scheduler.py adoption,
                                      # between lease takeover and graph
                                      # resume (delay => widen the race
                                      # window against completion)
    "executor.memory.reserve",      # memory/governor.py, per reservation
                                    # request (raise error=resource =>
                                    # denied grant -> operator spills;
                                    # delay => slow grant)
    "executor.spill.write",         # memory/spill.py, per spill-run write
                                    # (raise => spill I/O failure;
                                    # corrupt => flip bytes on disk so the
                                    # read-back CRC must catch it)
    "scheduler.cancel.fanout",      # scheduler/netservice.py cancel RPCs
                                    # (drop => simulate the lost cancel
                                    # that leaves zombie tasks; heartbeat
                                    # reconciliation must reap them)
    "executor.task.cancel.checkpoint",  # ops/physical.py cooperative
                                        # cancellation checkpoint, fires
                                        # only when a cancel has landed
                                        # (delay => widen the cancel-vs-
                                        # completion race window)
})

ACTIONS = frozenset({"raise", "delay", "drop", "corrupt", "kill"})


def _make_error(kind: str, message: str) -> Exception:
    from ..utils.errors import (ExecutionError, ExecutorKilled, IOError_,
                                MemoryExhausted)

    factories: Dict[str, Callable[[str], Exception]] = {
        "io": IOError_,
        "oserror": OSError,
        "connection": ConnectionError,
        "timeout": TimeoutError,
        "execution": ExecutionError,
        "killed": ExecutorKilled,
        "resource": lambda m: MemoryExhausted("injected", 0, 0, m),
    }
    try:
        return factories[kind](message)
    except KeyError:
        raise ValueError(f"unknown fault error kind {kind!r} "
                         f"(known: {sorted(factories)})") from None


class FaultRule:
    """One (site, match) -> action binding with hit/fire accounting."""

    def __init__(self, site: str, action: str, *,
                 error: str = "io", message: str = "injected fault",
                 delay_ms: float = 0.0, on_hit: int = 1, times: int = 1,
                 p: float = 1.0, match: Optional[Dict[str, Any]] = None,
                 scope: str = "executor"):
        if site not in KNOWN_SITES:
            raise ValueError(f"unknown failpoint site {site!r} "
                             f"(known: {sorted(KNOWN_SITES)})")
        if action not in ACTIONS:
            raise ValueError(f"unknown fault action {action!r} "
                             f"(known: {sorted(ACTIONS)})")
        self.site = site
        self.action = action
        self.error = error
        self.message = message
        self.delay_ms = float(delay_ms)
        self.on_hit = int(on_hit)       # 1-based hit index at which to start
        self.times = int(times)         # fire budget; -1 = unlimited
        self.p = float(p)               # per-hit probability (plan RNG)
        self.match = dict(match or {})
        self.scope = scope              # "executor" | "process" (kill only)
        self.hits = 0                   # matching invocations seen
        self.fired = 0                  # injections performed

    def matches(self, ctx: Dict[str, Any]) -> bool:
        # string-compare so JSON plans can say {"stage_id": 2} or "2"
        return all(str(ctx.get(k)) == str(v) for k, v in self.match.items())

    @classmethod
    def from_obj(cls, obj: Dict[str, Any]) -> "FaultRule":
        known = {"site", "action", "error", "message", "delay_ms", "on_hit",
                 "times", "p", "match", "scope"}
        unknown = set(obj) - known
        if unknown:
            raise ValueError(f"unknown fault rule field(s) {sorted(unknown)}")
        kw = {k: v for k, v in obj.items() if k not in ("site", "action")}
        return cls(obj["site"], obj["action"], **kw)


class FaultPlan:
    """A seeded set of rules plus the log of what actually fired."""

    def __init__(self, rules: List[FaultRule], seed: int = 0):
        self.rules = list(rules)
        self.seed = int(seed)
        self._rng = random.Random(self.seed)
        self._lock = threading.Lock()
        self.events: List[Dict[str, Any]] = []

    @classmethod
    def from_obj(cls, obj: Dict[str, Any]) -> "FaultPlan":
        rules = [FaultRule.from_obj(r) for r in obj.get("rules", [])]
        return cls(rules, seed=int(obj.get("seed", 0)))

    @classmethod
    def from_json(cls, text: str) -> "FaultPlan":
        return cls.from_obj(json.loads(text))

    def evaluate(self, site: str, ctx: Dict[str, Any]) -> Optional[FaultRule]:
        """Account a hit against every matching rule; return the first rule
        that fires (k-th hit reached, budget left, probability draw)."""
        with self._lock:
            winner = None
            for i, rule in enumerate(self.rules):
                if rule.site != site or not rule.matches(ctx):
                    continue
                rule.hits += 1
                if winner is not None:
                    continue
                if rule.hits < rule.on_hit:
                    continue
                if rule.times >= 0 and rule.fired >= rule.times:
                    continue
                if rule.p < 1.0 and self._rng.random() >= rule.p:
                    continue
                rule.fired += 1
                self.events.append({"site": site, "rule": i,
                                    "hit": rule.hits, "action": rule.action})
                winner = rule
            return winner

    def schedule(self):
        """Hashable injection schedule for reproducibility checks."""
        with self._lock:
            return tuple((e["site"], e["rule"], e["hit"], e["action"])
                         for e in self.events)


# --------------------------------------------------------------------------
# module-global plan + kill-target registry
# --------------------------------------------------------------------------

_PLAN: Optional[FaultPlan] = None
_KILL_TARGETS: Dict[str, Callable[[], None]] = {}


def install(plan: FaultPlan) -> None:
    global _PLAN
    _PLAN = plan


def clear() -> None:
    global _PLAN
    _PLAN = None


def active() -> Optional[FaultPlan]:
    return _PLAN


class use_plan:
    """``with faults.use_plan(plan): ...`` — test-scoped installation."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan

    def __enter__(self) -> FaultPlan:
        install(self.plan)
        return self.plan

    def __exit__(self, *exc) -> None:
        clear()


def register_kill_target(name: str, fn: Callable[[], None]) -> None:
    """Register how to abruptly stop ``name`` (an executor_id) for the
    ``kill`` action.  ExecutorServer registers its ``kill()`` here."""
    _KILL_TARGETS[name] = fn


def unregister_kill_target(name: str) -> None:
    _KILL_TARGETS.pop(name, None)


def configure(config=None) -> Optional[FaultPlan]:
    """Install a plan from config (``ballista.faults.plan``) or the
    environment.  Idempotent; a no-op when neither source is set.  A value
    starting with ``@`` names a JSON file."""
    if _PLAN is not None:
        return _PLAN
    spec = ""
    if config is not None:
        from ..utils.config import FAULTS_PLAN

        spec = str(config.get(FAULTS_PLAN) or "")
    if not spec:
        spec = os.environ.get(ENV_PLAN, "")
    if not spec:
        return None
    if spec.startswith("@"):
        with open(spec[1:], "r", encoding="utf-8") as fh:
            spec = fh.read()
    plan = FaultPlan.from_json(spec)
    install(plan)
    log.warning("fault plan installed: %d rule(s), seed=%d",
                len(plan.rules), plan.seed)
    return plan


# --------------------------------------------------------------------------
# injection API (call sites use these three)
# --------------------------------------------------------------------------

def inject(site: str, **ctx) -> Optional[FaultRule]:
    """Evaluate failpoint ``site``.

    Disabled path is a single global-``None`` check.  ``raise``/``kill``
    rules raise from here; ``delay`` sleeps then returns the rule;
    ``drop``/``corrupt`` return the rule for the caller to apply (payload
    handling is site-specific)."""
    plan = _PLAN
    if plan is None:
        return None
    rule = plan.evaluate(site, ctx)
    if rule is None:
        return None
    _journal_fire(site, rule, ctx)
    if rule.action == "delay":
        time.sleep(rule.delay_ms / 1000.0)
        return rule
    if rule.action == "raise":
        raise _make_error(rule.error, f"{rule.message} [failpoint {site}]")
    if rule.action == "kill":
        _do_kill(site, rule, ctx)
    return rule  # drop / corrupt: caller's responsibility


def _journal_fire(site: str, rule: FaultRule, ctx: Dict[str, Any]) -> None:
    """Record a fired injection in the flight recorder (chaos postmortems
    correlate the fault schedule with the decisions it provoked).  Emitted
    BEFORE the action executes, so raise/kill firings are recorded too."""
    from ..obs import journal

    if not journal.enabled():
        return
    attrs: Dict[str, Any] = {"site": site, "action": rule.action,
                             "hit": rule.hits}
    for k in ("executor_id", "stage_id", "scheduler_id"):
        if k in ctx:
            attrs[k] = ctx[k]
    journal.emit("fault.fired", job_id=str(ctx.get("job_id", "") or ""),
                 **attrs)


def dropped(site: str, **ctx) -> bool:
    """Evaluate ``site``; True when a ``drop`` rule fired (caller discards
    the payload).  ``raise``/``kill``/``delay`` behave as in inject()."""
    rule = inject(site, **ctx)
    return rule is not None and rule.action == "drop"


def corrupt_bytes(data: bytes, stride: int = 97) -> bytes:
    """Deterministic corruption: XOR every ``stride``-th byte (including
    byte 0, so framed/magic-prefixed payloads fail fast)."""
    buf = bytearray(data)
    for i in range(0, len(buf), stride):
        buf[i] ^= 0xFF
    return bytes(buf)


def _do_kill(site: str, rule: FaultRule, ctx: Dict[str, Any]) -> None:
    from ..utils.errors import ExecutorKilled

    if rule.scope == "process":
        log.error("failpoint %s: killing process (scope=process)", site)
        os._exit(137)
    target = str(ctx.get("executor_id") or rule.match.get("executor_id") or "")
    fn = _KILL_TARGETS.get(target)
    if fn is not None:
        threading.Thread(target=fn, name=f"fault-kill-{target}",
                         daemon=True).start()
    raise ExecutorKilled(f"failpoint {site} killed executor {target!r}")
