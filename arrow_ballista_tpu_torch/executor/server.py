"""Executor network service: task intake and the shuffle data plane.

Mirrors arrow_ballista_tpu/executor/server.py for one scheduler: push mode
(``launch_multi_task`` / ``cancel_tasks`` / ``remove_job_data`` /
``stop_executor``, task statuses batched back to the scheduler by a
reporter loop) or pull mode (a ``poll_work`` loop), heartbeats that carry
the executor's metadata, memory pressure and running tasks, a janitor that
removes stale job data, and the data plane: the native ``sendfile`` server
(native.py, one per process) or, where it is taken or cannot build, the
Python RPC handler, plus the chunked ``fetch_partition_stream`` on the RPC
port.  Every task runs on the server's device (the card unless the caller
passes another; without a card the server raises).  Statuses carry the
tasks' device-observatory folds, spans and journal events (obs/), and
``metrics_port`` serves the prometheus exposition (obs/http.py).  The
``executor.heartbeat.send`` and ``executor.status.report`` failpoints
(faults/) fire on the way out.  A fleet of schedulers
(``scheduler_endpoints``) is ROADMAP.md queue 1 item 12 C.
"""
from __future__ import annotations

import logging
import os
import queue
import threading
import time
from collections import OrderedDict
from typing import List, Optional, Tuple

from .. import faults, serde
from ..net import wire
from ..net.retry import RetryPolicy, call_with_retry
from ..net.rpc import RpcServer
from ..scheduler.types import ExecutorMetadata, TaskStatus
from ..utils.config import BallistaConfig
from ..utils.errors import ExecutionError
from ..utils.logsetup import ThrottledLogger
from .executor import Executor

log = logging.getLogger(__name__)

HEARTBEAT_INTERVAL_S = 60.0
# one record per retry-loop kind per this many seconds, the suppressed
# occurrences counted
RETRY_LOG_INTERVAL_S = 60.0


class StagePlanCache:
    """Tasks of one stage share one decoded plan instance, so its
    operators' programs (K19, fused chains, build caches) are prepared once
    a stage, not once a task.  Keyed by the plan's content as well as
    (job, stage): a stage re-run after a lineage rollback carries new
    shuffle locations and must not reuse the stale instance."""

    def __init__(self, max_entries: int = 64):
        self._cache: "OrderedDict[tuple, object]" = OrderedDict()
        self._max = max_entries
        self._lock = threading.Lock()

    def decode(self, t: dict):
        import hashlib
        import json

        from ..scheduler.types import TaskDescription, TaskId

        tid = t.get("task", {})
        blob = json.dumps(t.get("plan"), sort_keys=True, separators=(",", ":")).encode()
        key = (tid.get("job_id"), tid.get("stage_id"), hashlib.sha256(blob).hexdigest())
        with self._lock:
            cached = self._cache.get(key)
            if cached is not None:
                self._cache.move_to_end(key)
        if cached is not None:
            # a hit decodes only the task envelope
            return TaskDescription(TaskId(**t["task"]), cached,
                                   task_internal_id=t.get("internal_id", 0),
                                   scalars=dict(t.get("scalars", {})),
                                   trace=dict(t.get("trace", {})))
        td = serde.task_from_obj(t)
        with self._lock:
            now = self._cache.get(key)  # a racing decode of the stage wins
            if now is not None:
                td.plan = now
            else:
                self._cache[key] = td.plan
                while len(self._cache) > self._max:
                    self._cache.popitem(last=False)
        return td


class SchedulerClient:
    """Executor -> scheduler control-plane client: every call through
    ``net.retry.call_with_retry`` (deadlines, capped jittered backoff, a
    give-up deadline raising the retryable ``GiveUpError``)."""

    def __init__(self, host: str, port: int, policy: Optional[RetryPolicy] = None):
        self.host, self.port = host, port
        self.policy = policy or RetryPolicy()

    def _call(self, method: str, payload: dict) -> dict:
        resp, _ = call_with_retry(self.host, self.port, method, payload, policy=self.policy)
        return resp

    def register_executor(self, meta: ExecutorMetadata) -> None:
        self._call("register_executor", {"meta": serde.executor_metadata_to_obj(meta)})

    def heartbeat(self, executor_id: str, status: str = "active",
                  meta: Optional[ExecutorMetadata] = None, pressure: float = 0.0,
                  running: Optional[List[tuple]] = None) -> None:
        if faults.dropped("executor.heartbeat.send", executor_id=executor_id, status=status):
            raise ConnectionError("failpoint executor.heartbeat.send dropped the heartbeat")
        payload = {"executor_id": executor_id, "status": status}
        if meta is not None:
            payload["meta"] = serde.executor_metadata_to_obj(meta)
        # 0.0 (no host budget) and an idle executor omit their keys
        if pressure:
            payload["memory_pressure"] = pressure
        if running:
            payload["running"] = [list(t) for t in running]
        self._call("heartbeat", payload)

    def update_task_status(self, executor_id: str, statuses: List[TaskStatus]) -> None:
        # the drop fires before the retrying transport: the report is lost
        # and the reporter loop's own retry must redeem it
        if faults.dropped("executor.status.report", executor_id=executor_id,
                          count=len(statuses)):
            raise ConnectionError("failpoint executor.status.report dropped the payload")
        self._call("update_task_status",
                   {"executor_id": executor_id,
                    "statuses": [serde.status_to_obj(s) for s in statuses]})

    def poll_work(self, executor_id: str, num_free_slots: int, statuses: List[TaskStatus],
                  decode=serde.task_from_obj):
        # one shot: the scheduler pops tasks into the reply, so a transport
        # retry after a lost reply would leak them; the poll loop retries
        payload, _ = wire.call(self.host, self.port, "poll_work", {
            "executor_id": executor_id, "num_free_slots": num_free_slots,
            "statuses": [serde.status_to_obj(s) for s in statuses]},
            timeout=self.policy.read_timeout_s, connect_timeout=self.policy.connect_timeout_s)
        from ..scheduler.netservice import ungroup_tasks

        return [decode(t) for t in ungroup_tasks(payload)]

    def executor_stopped(self, executor_id: str, reason: str = "") -> None:
        self._call("executor_stopped", {"executor_id": executor_id, "reason": reason})


class ExecutorServer:
    def __init__(self, scheduler_host: str, scheduler_port: int,
                 host: str = "127.0.0.1", port: int = 0,
                 work_dir: Optional[str] = None, concurrent_tasks: int = 4,
                 executor_id: Optional[str] = None,
                 config: Optional[BallistaConfig] = None,
                 external_host: Optional[str] = None,
                 policy: str = "push",
                 job_data_ttl_s: float = 3600.0,
                 janitor_interval_s: float = 300.0,
                 flight_port: int = -1,
                 metrics_port: int = -1,
                 heartbeat_interval_s: float = HEARTBEAT_INTERVAL_S,
                 scheduler_endpoints: Optional[List[Tuple[str, int]]] = None,
                 device=None):
        import socket as socketmod
        import tempfile
        import uuid

        from ..client.context import resolve_device

        if scheduler_endpoints and {(h, int(p)) for h, p in scheduler_endpoints} \
                - {(scheduler_host, int(scheduler_port))}:
            raise NotImplementedError(
                "an executor of a scheduler fleet (one client per shard) is not ported yet "
                "(ROADMAP.md queue 1 item 12 C)")
        if policy not in ("push", "pull"):
            raise ValueError(f"unknown scheduling policy {policy!r}")
        self.device = resolve_device(device)
        faults.configure(config)
        self.work_dir = work_dir or tempfile.mkdtemp(prefix="ballista-torch-exec-")
        executor_id = executor_id or f"exec-{uuid.uuid4().hex[:8]}"
        self.rpc = RpcServer(host, port)
        # the advertised address peers dial for shuffle fetches (0.0.0.0
        # is not routable: the machine's hostname then)
        if external_host is None:
            external_host = host if host not in ("0.0.0.0", "::") else socketmod.gethostname()
        # the data plane: the native server when this process has none yet
        # (one per process), else the Python RPC handler on the RPC port
        self._native_dp = None
        data_port = self.rpc.port
        # shared-secret auth of the data plane (BALLISTA_DATA_PLANE_TOKEN)
        self._dp_token = os.environ.get("BALLISTA_DATA_PLANE_TOKEN", "")
        from .. import native as native_mod

        lib = native_mod.dataplane()
        if lib is not None:
            p = lib.dp_start(self.work_dir.encode(), 0, self._dp_token.encode(), 64)
            if p > 0:
                self._native_dp = lib
                data_port = p
                log.info("native data plane on port %d", p)
        #: "native" or "python": which server answers fetch_partition
        self.data_plane = "native" if self._native_dp is not None else "python"
        self.metadata = ExecutorMetadata(executor_id=executor_id, host=external_host,
                                         port=data_port, grpc_port=self.rpc.port,
                                         task_slots=concurrent_tasks)
        self.executor = Executor(self.metadata, self.work_dir, config,
                                 concurrent_tasks=concurrent_tasks, device=self.device)
        self.retry_policy = RetryPolicy.from_config(config) if config is not None \
            else RetryPolicy()
        self.scheduler = SchedulerClient(scheduler_host, scheduler_port,
                                         policy=self.retry_policy)
        self.policy = policy
        self.heartbeat_interval_s = heartbeat_interval_s
        self._stop = threading.Event()
        # set once by drain_and_stop(); read by the poll loop and /health
        self._draining = False
        # serializes stop() against kill(): each claims the shared servers
        self._teardown_lock = threading.Lock()
        self._killed = False
        # one transition log when the scheduler becomes unreachable; the
        # first call that succeeds afterwards re-registers (it may have
        # restarted meanwhile)
        self._sched_state_lock = threading.Lock()
        self._scheduler_down = False
        self._log_throttle = ThrottledLogger(log, interval_s=RETRY_LOG_INTERVAL_S)
        faults.register_kill_target(self.metadata.executor_id, self.kill)
        self._hb_thread: Optional[threading.Thread] = None
        self._poll_thread: Optional[threading.Thread] = None
        self._reporter_thread: Optional[threading.Thread] = None
        self._status_queue: "queue.Queue[TaskStatus]" = queue.Queue()
        self.job_data_ttl_s = job_data_ttl_s
        self.janitor_interval_s = janitor_interval_s
        self._janitor_thread: Optional[threading.Thread] = None
        self._plan_cache = StagePlanCache()

        # a standard Arrow Flight door: a stock client can do_get a
        # shuffle partition (peers keep to the native or RPC plane)
        self.flight = None
        if flight_port >= 0:
            from .flight_service import ExecutorFlightServer

            self.flight = ExecutorFlightServer(self.work_dir, self._dp_token, host, flight_port)

        # prometheus /metrics and /health (-1 = off, 0 = an ephemeral port)
        self.obs_http = None
        if metrics_port >= 0:
            import json as jsonmod

            from ..obs.http import PROM_CTYPE, ObsHttpServer

            def _metrics():
                return (self.executor.metrics.gather(self.executor.active_tasks()),
                        PROM_CTYPE)

            def _health():
                return (jsonmod.dumps({
                    "status": "draining" if self._draining else "ok",
                    "executor_id": self.metadata.executor_id,
                    "policy": self.policy,
                    "task_slots": self.metadata.task_slots,
                    "active_tasks": self.executor.active_tasks(),
                }), "application/json")

            self.obs_http = ObsHttpServer(host, metrics_port,
                                          {"/metrics": _metrics, "/health": _health})

        self.rpc.register("launch_multi_task", self._launch_multi_task)
        self.rpc.register("cancel_tasks", self._cancel_tasks)
        self.rpc.register("cancel_task", self._cancel_task)
        self.rpc.register("fetch_partition", self._fetch_partition)
        self.rpc.register_stream("fetch_partition_stream", self._fetch_partition_stream)
        self.rpc.register("remove_job_data", self._remove_job_data)
        self.rpc.register("stop_executor", self._stop_executor)
        self.rpc.register("ping", lambda p, b: ({"executor_id": executor_id}, b""))

    # --- lifecycle -------------------------------------------------------
    def start(self, register: bool = True) -> None:
        self.rpc.start()
        if self.flight is not None:
            self.flight.start()
        if self.obs_http is not None:
            self.obs_http.start()
        if register:
            self.scheduler.register_executor(self.metadata)
        self._hb_thread = threading.Thread(target=self._heartbeat_loop,
                                           name="executor-heartbeat", daemon=True)
        self._hb_thread.start()
        if self.policy == "pull":
            self._poll_thread = threading.Thread(target=self._poll_loop, name="executor-poll",
                                                 daemon=True)
            self._poll_thread.start()
        else:
            self._reporter_thread = threading.Thread(target=self._reporter_loop,
                                                     name="status-reporter", daemon=True)
            self._reporter_thread.start()
        self._janitor_thread = threading.Thread(target=self._janitor_loop,
                                                name="shuffle-janitor", daemon=True)
        self._janitor_thread.start()

    def _janitor_loop(self) -> None:
        """Delete the job directories untouched for longer than the TTL
        (a job with a task running here is alive whatever its mtimes)."""
        while not self._stop.wait(self.janitor_interval_s):
            try:
                now = time.time()
                live = self.executor.active_job_ids()
                for entry in os.scandir(self.work_dir):
                    if not entry.is_dir() or entry.name in live:
                        continue
                    newest = entry.stat().st_mtime
                    for root, _dirs, files in os.walk(entry.path):
                        for fn in files:
                            try:
                                newest = max(newest, os.stat(os.path.join(root, fn)).st_mtime)
                            except OSError:
                                pass
                    if now - newest > self.job_data_ttl_s:
                        log.info("janitor removing stale job data %s", entry.path)
                        from .executor import remove_job_data

                        remove_job_data(self.work_dir, entry.name)
            except Exception:  # noqa: BLE001 — the janitor must survive
                log.exception("shuffle janitor iteration failed")

    def _poll_loop(self) -> None:
        """Pull mode: report the drained statuses, ask for as many tasks as
        there are free slots, sleep 100 ms when nothing came back."""
        while not self._stop.is_set():
            statuses: List[TaskStatus] = []
            while True:
                try:
                    statuses.append(self._status_queue.get_nowait())
                except queue.Empty:
                    break
            # draining: keep polling to report, but take no new work
            free = 0 if self._draining else \
                self.metadata.task_slots - self.executor.active_tasks()
            try:
                tasks = self.scheduler.poll_work(self.metadata.executor_id, max(0, free),
                                                 statuses, decode=self._plan_cache.decode)
            except Exception:  # noqa: BLE001 — the scheduler briefly unreachable
                self._mark_scheduler_down("poll_work")
                self._log_throttle.warning("poll", "poll_work failed", exc_info=True)
                for st in statuses:  # reported on the next poll
                    self._status_queue.put(st)
                self._stop.wait(1.0)
                continue
            self._mark_scheduler_up()
            for task in tasks:
                self.executor.submit_task(task, self._status_queue.put)
            if not tasks and not statuses:
                self._stop.wait(0.1)

    def drain_and_stop(self, grace_s: float = 30.0) -> None:
        """Graceful shutdown: a terminating heartbeat (the scheduler stops
        assigning), the in-flight tasks waited for (at most ``grace_s``),
        then stop."""
        self._draining = True
        try:
            self.scheduler.heartbeat(self.metadata.executor_id, status="terminating",
                                     meta=self.metadata)
        except Exception:  # noqa: BLE001 — the scheduler may already be gone
            pass
        deadline = time.monotonic() + grace_s
        while self.executor.active_tasks() > 0 and time.monotonic() < deadline:
            time.sleep(0.1)
        for _ in range(20):  # the reporter's last chance to flush
            if self._status_queue.empty():
                break
            time.sleep(0.1)
        self.stop(notify=True)

    def stop(self, notify: bool = True) -> None:
        with self._teardown_lock:
            self._stop.set()
            if self._killed:
                return  # kill() already tore the sockets down
            obs_http, self.obs_http = self.obs_http, None
            native_dp, self._native_dp = self._native_dp, None
        faults.unregister_kill_target(self.metadata.executor_id)
        if notify:
            try:
                self.scheduler.executor_stopped(self.metadata.executor_id, "shutdown")
            except Exception:  # noqa: BLE001 — the scheduler may be gone
                pass
        self.executor.shutdown()
        self.rpc.stop()
        if self.flight is not None:
            self.flight.stop()
        if obs_http is not None:
            obs_http.stop()
        if native_dp is not None:
            native_dp.dp_stop()
        self._join_threads()

    def _join_threads(self) -> None:
        """Bounded join of the loops (each exits within one interval once
        ``_stop`` is set), skipping the calling thread."""
        cur = threading.current_thread()
        for t in (self._hb_thread, self._poll_thread, self._reporter_thread,
                  self._janitor_thread):
            if t is not None and t is not cur:
                t.join(timeout=5.0)

    def kill(self) -> None:
        """Abrupt death (the faults kill action): off the network at once,
        with no terminating heartbeat, no goodbye and no final status
        flush; in-flight tasks unwind as killed and are never reported."""
        with self._teardown_lock:
            if self._killed:
                return
            self._killed = True
            self._stop.set()
            obs_http, self.obs_http = self.obs_http, None
            native_dp, self._native_dp = self._native_dp, None
        faults.unregister_kill_target(self.metadata.executor_id)
        log.warning("executor %s killed by fault injection", self.metadata.executor_id)
        self.rpc.stop()
        if self.flight is not None:
            self.flight.stop()
        if obs_http is not None:
            obs_http.stop()
        if native_dp is not None:
            native_dp.dp_stop()
        # no wait: this may run on the pool thread that tripped the failpoint
        self.executor.pool.shutdown(wait=False)

    def _mark_scheduler_down(self, what: str) -> None:
        with self._sched_state_lock:
            if self._scheduler_down:
                return
            self._scheduler_down = True
        log.warning("scheduler unreachable (%s failed past the %.1fs give-up deadline); will "
                    "re-register on reconnect", what, self.retry_policy.give_up_after_s)

    def _mark_scheduler_up(self) -> None:
        """The first successful call after an outage re-registers."""
        with self._sched_state_lock:
            if not self._scheduler_down:
                return
            self._scheduler_down = False
        log.info("scheduler reachable again; re-registering executor %s",
                 self.metadata.executor_id)
        try:
            self.scheduler.register_executor(self.metadata)
        except Exception:  # noqa: BLE001 — the next loop pass re-detects
            self._log_throttle.warning("re-register", "re-register after reconnect failed",
                                       exc_info=True)
            with self._sched_state_lock:
                self._scheduler_down = True

    def _heartbeat_loop(self) -> None:
        while not self._stop.wait(self.heartbeat_interval_s):
            try:
                # the metadata rides along, so a restarted scheduler
                # re-registers this executor
                self.scheduler.heartbeat(self.metadata.executor_id, meta=self.metadata,
                                         pressure=self.executor.governor.pressure(),
                                         running=self.executor.running_task_ids())
                self._mark_scheduler_up()
            except Exception:  # noqa: BLE001 — retried next interval
                self._mark_scheduler_down("heartbeat")
                self._log_throttle.warning("heartbeat", "heartbeat to scheduler failed",
                                           exc_info=True)

    # --- RPC handlers ----------------------------------------------------
    def _launch_multi_task(self, payload: dict, _bin: bytes):
        from ..scheduler.netservice import ungroup_tasks

        # one plan and N task envelopes a stage (or the flat shape)
        tasks = [self._plan_cache.decode(t) for t in ungroup_tasks(payload)]
        for task in tasks:
            self.executor.submit_task(task, self._status_queue.put)
        return {"accepted": len(tasks)}, b""

    def _reporter_loop(self) -> None:
        """Push mode: batch the finished tasks' statuses to the scheduler;
        a failed report keeps them for the next round, so a transient
        outage loses none."""
        pending: List[TaskStatus] = []
        while not self._stop.is_set():
            try:
                pending.append(self._status_queue.get(timeout=0.2))
            except queue.Empty:
                pass
            while True:
                try:
                    pending.append(self._status_queue.get_nowait())
                except queue.Empty:
                    break
            if not pending:
                continue
            try:
                self.scheduler.update_task_status(self.metadata.executor_id, list(pending))
                pending = []
                self._mark_scheduler_up()
            except Exception:  # noqa: BLE001 — kept and retried next round
                self._mark_scheduler_down("status report")
                self._log_throttle.warning(
                    "status-report", "status report failed (%d pending, will retry)",
                    len(pending), exc_info=True)
                self._stop.wait(1.0)
        # a last best-effort flush on shutdown, but not after kill(): a
        # killed executor reports nothing
        with self._teardown_lock:
            killed = self._killed
        if pending and not killed:
            try:
                self.scheduler.update_task_status(self.metadata.executor_id, pending)
            except Exception:  # noqa: BLE001 — nothing listens to a failure now
                pass

    def _cancel_tasks(self, payload: dict, _bin: bytes):
        self.executor.cancel_job_tasks(payload["job_id"])
        return {}, b""

    def _cancel_task(self, payload: dict, _bin: bytes):
        self.executor.cancel_task(serde.taskid_from_obj(payload["task"]))
        return {}, b""

    def _checked_path(self, payload: dict) -> str:
        """The request's path, after the data plane's token and the guard
        that keeps it inside the work directory."""
        if self._dp_token and payload.get("token", "") != self._dp_token:
            raise ExecutionError("data plane auth failed")
        path = payload["path"]
        base = os.path.realpath(self.work_dir)
        if os.path.commonpath([base, os.path.realpath(path)]) != base:
            raise ExecutionError(f"path {path!r} escapes the work dir")
        if not os.path.exists(path):
            raise ExecutionError(f"no such shuffle file: {path}")
        return path

    def _fetch_partition(self, payload: dict, _bin: bytes):
        with open(self._checked_path(payload), "rb") as f:
            data = f.read()
        return {"num_bytes": len(data)}, data

    def _fetch_partition_stream(self, payload: dict, _bin: bytes, send):
        """The chunked fetch: the same guard as the whole file, then the
        framing of net/dataplane.stream_partition."""
        from ..net.dataplane import stream_partition

        stream_partition(self._checked_path(payload), payload, send)

    def _remove_job_data(self, payload: dict, _bin: bytes):
        from .executor import remove_job_data

        remove_job_data(self.work_dir, payload["job_id"])
        return {}, b""

    def _stop_executor(self, payload: dict, _bin: bytes):
        threading.Thread(target=self.stop, kwargs={"notify": False}, daemon=True).start()
        return {}, b""
