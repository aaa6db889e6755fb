"""Generic single-consumer event loop.

Mirrors arrow_ballista_tpu/scheduler/event_loop.py: a daemon thread
draining a bounded queue.  Everything that mutates scheduler state flows
through it, so state transitions are single-threaded by construction.
"""
from __future__ import annotations

import logging
import queue
import threading
import time
from typing import Callable, Optional

log = logging.getLogger(__name__)


class EventLoop:
    def __init__(self, name: str, on_receive: Callable[[object], None],
                 buffer_size: int = 10000,
                 slow_event_threshold_s: float = 1.0,
                 on_error: Optional[Callable[[object, BaseException], None]] = None):
        self.name = name
        self._on_receive = on_receive
        # on_error: last-resort hook when a handler raises — the loop itself
        # must survive, but its owner may need to fail the affected job so
        # a waiting client is not left with a forever-"running" status
        self._on_error = on_error
        # entries are (enqueue_monotonic, event) so the consumer can measure
        # queue lag
        self._queue: "queue.Queue[object]" = queue.Queue(maxsize=buffer_size)
        self._thread: Optional[threading.Thread] = None
        self._stopped = threading.Event()
        self.slow_event_threshold_s = slow_event_threshold_s
        # lag/latency counters: written only by the consumer thread, read by
        # the metrics sampler — single-writer, so plain attributes suffice
        self._events_processed = 0
        self._slow_events = 0
        self._last_lag_s = 0.0
        self._max_lag_s = 0.0
        self._handler_seconds_total = 0.0
        self._handler_seconds_max = 0.0

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stopped.clear()
        self._thread = threading.Thread(target=self._run, name=self.name,
                                        daemon=True)
        self._thread.start()

    def stop(self, timeout: float = 5.0) -> None:
        self._stopped.set()
        self._queue.put(None)  # wake the consumer
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            self._thread = None

    def post(self, event: object) -> None:
        if self._stopped.is_set():
            return
        self._queue.put((time.monotonic(), event))

    def queue_depth(self) -> int:
        return self._queue.qsize()

    def stats(self) -> dict:
        """Lag/latency snapshot for the metrics sampler and
        ``/api/cluster/history`` (lag = dequeue time - enqueue time)."""
        n = self._events_processed
        return {
            "queue_depth": self._queue.qsize(),
            "events_processed": n,
            "slow_events": self._slow_events,
            "last_lag_s": round(self._last_lag_s, 6),
            "max_lag_s": round(self._max_lag_s, 6),
            "handler_seconds_total": round(self._handler_seconds_total, 6),
            "handler_seconds_max": round(self._handler_seconds_max, 6),
            "handler_seconds_mean":
                round(self._handler_seconds_total / n, 6) if n else 0.0,
        }

    def _run(self) -> None:
        while not self._stopped.is_set():
            item = self._queue.get()
            if item is None:
                continue
            enqueued_at, event = item
            t0 = time.monotonic()
            self._last_lag_s = t0 - enqueued_at
            if self._last_lag_s > self._max_lag_s:
                self._max_lag_s = self._last_lag_s
            try:
                self._on_receive(event)
            except Exception as exc:  # noqa: BLE001 — the loop must survive
                log.exception("%s: event handler raised", self.name)
                if self._on_error is not None:
                    try:
                        self._on_error(event, exc)
                    except Exception:  # noqa: BLE001
                        log.exception("%s: on_error hook raised", self.name)
            dt = time.monotonic() - t0
            self._events_processed += 1
            self._handler_seconds_total += dt
            if dt > self._handler_seconds_max:
                self._handler_seconds_max = dt
            if dt > self.slow_event_threshold_s:
                self._slow_events += 1
                log.warning("%s: slow event %r took %.2fs", self.name, event, dt)

    def drain(self, timeout: float = 10.0) -> bool:
        """Wait until the queue is empty (test helper)."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self._queue.empty():
                return True
            time.sleep(0.005)
        return False
