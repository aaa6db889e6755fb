"""Span layer: trace ids, span trees, and pluggable collectors.

A Span is a named wall-clock interval in a trace.  The scheduler opens a
root "job" span per query (plus admission/planning/execution phase
children); each executor task opens a task span parented on the job's
execution span, and `TaskSpanRecorder.op_span` nests one child span per
operator `execute` call.  Spans serialize to plain JSON dicts so they
ride the existing wire format back with task status updates.

Collectors are the export seam: Noop (default), a bounded in-memory
buffer, and an OTLP/HTTP-JSON-shaped exporter (stdlib urllib only; the
payload matches the opentelemetry-proto JSON mapping closely enough for
a generic OTLP gateway, and a custom `sink` callable can divert it).

The port's copy of arrow_ballista_tpu/obs/tracing.py: the span shapes and
the OTLP payload are the reference's, scope name included, so one
collector groups both engines' spans alike.
"""
import contextlib
import threading
import time
import urllib.request
import uuid
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional


def now_ms() -> float:
    return time.time() * 1000.0


def new_trace_id() -> str:
    return uuid.uuid4().hex  # 32 hex chars, W3C-sized


def new_span_id() -> str:
    return uuid.uuid4().hex[:16]


def new_trace_context() -> Dict[str, str]:
    """Fresh propagation context: what a client attaches to a submission."""
    return {"trace_id": new_trace_id(), "span_id": new_span_id()}


@dataclass
class Span:
    name: str
    trace_id: str = ""
    span_id: str = field(default_factory=new_span_id)
    parent_id: str = ""
    kind: str = "internal"  # scheduler | executor | operator | internal
    start_ms: float = field(default_factory=now_ms)
    end_ms: float = 0.0
    status: str = "ok"
    attrs: Dict = field(default_factory=dict)

    def end(self, status: Optional[str] = None) -> "Span":
        if not self.end_ms:
            self.end_ms = now_ms()
        if status is not None:
            self.status = status
        return self

    @property
    def duration_ms(self) -> float:
        return max((self.end_ms or now_ms()) - self.start_ms, 0.0)

    def context(self) -> Dict[str, str]:
        """Propagation context for children of this span."""
        return {"trace_id": self.trace_id, "span_id": self.span_id}


_SPAN_FIELDS = ("name", "trace_id", "span_id", "parent_id", "kind",
                "start_ms", "end_ms", "status")


def span_to_obj(s: Span) -> Dict:
    o = {k: getattr(s, k) for k in _SPAN_FIELDS}
    o["attrs"] = dict(s.attrs)
    return o


def span_from_obj(o: Dict) -> Span:
    return Span(attrs=dict(o.get("attrs", {})),
                **{k: o[k] for k in _SPAN_FIELDS if k in o})


class SpanCollector:
    """Export seam for finished span batches."""

    def export(self, spans: List[Span]) -> None:
        raise NotImplementedError

    def snapshot(self, trace_id: Optional[str] = None) -> List[Span]:
        return []


class NoopSpanCollector(SpanCollector):
    def export(self, spans: List[Span]) -> None:
        pass


class InMemorySpanCollector(SpanCollector):
    """Bounded buffer of exported spans (oldest dropped first)."""

    def __init__(self, capacity: int = 8192):
        self.capacity = max(int(capacity), 1)
        self._spans: List[Span] = []
        self._lock = threading.Lock()

    def export(self, spans: List[Span]) -> None:
        with self._lock:
            self._spans.extend(spans)
            if len(self._spans) > self.capacity:
                del self._spans[:len(self._spans) - self.capacity]

    def snapshot(self, trace_id: Optional[str] = None) -> List[Span]:
        with self._lock:
            return [s for s in self._spans
                    if trace_id is None or s.trace_id == trace_id]


def otlp_payload(spans: List[Span], service_name: str) -> Dict:
    """OTLP/HTTP JSON-shaped resourceSpans payload (nanosecond epochs)."""
    def attrs(d):
        out = []
        for k, v in d.items():
            if isinstance(v, bool):
                val = {"boolValue": v}
            elif isinstance(v, int):
                val = {"intValue": str(v)}
            elif isinstance(v, float):
                val = {"doubleValue": v}
            else:
                val = {"stringValue": str(v)}
            out.append({"key": str(k), "value": val})
        return out

    return {"resourceSpans": [{
        "resource": {"attributes": attrs({"service.name": service_name})},
        "scopeSpans": [{
            "scope": {"name": "arrow_ballista_tpu.obs"},
            "spans": [{
                "traceId": s.trace_id,
                "spanId": s.span_id,
                "parentSpanId": s.parent_id,
                "name": s.name,
                "kind": 1,
                "startTimeUnixNano": str(int(s.start_ms * 1e6)),
                "endTimeUnixNano": str(int((s.end_ms or now_ms()) * 1e6)),
                "status": {"code": 2 if s.status not in ("ok", "success")
                           else 1},
                "attributes": attrs(s.attrs),
            } for s in spans],
        }],
    }]}


class OtlpSpanCollector(SpanCollector):
    """Best-effort OTLP-shaped export hook.

    Builds the JSON payload and hands it to `sink` (default: POST to
    `endpoint` with a short timeout).  Failures are swallowed — tracing
    must never take a query down.
    """

    def __init__(self, endpoint: str = "",
                 service_name: str = "arrow-ballista-tpu",
                 sink: Optional[Callable[[Dict], None]] = None):
        self.endpoint = endpoint
        self.service_name = service_name
        self.sink = sink

    def export(self, spans: List[Span]) -> None:
        if not spans:
            return
        payload = otlp_payload(spans, self.service_name)
        try:
            if self.sink is not None:
                self.sink(payload)
            elif self.endpoint:
                import json as _json
                req = urllib.request.Request(
                    self.endpoint, data=_json.dumps(payload).encode(),
                    headers={"Content-Type": "application/json"})
                urllib.request.urlopen(req, timeout=2).close()
        except Exception:
            pass


def make_collector(kind: str, endpoint: str = "") -> SpanCollector:
    kind = (kind or "noop").strip().lower()
    if kind == "memory":
        return InMemorySpanCollector()
    if kind == "otlp":
        return OtlpSpanCollector(endpoint)
    return NoopSpanCollector()


def _values(metrics) -> Dict[str, float]:
    """An operator's metric values for a span delta: ``peek()`` where the
    MetricsSet has it (deferred values stay unresolved until the task's
    own snapshot), else ``to_dict()``."""
    peek = getattr(metrics, "peek", None)
    return peek() if callable(peek) else metrics.to_dict()


class TaskSpanRecorder:
    """Builds one task's span tree on the task's executing thread.

    A task runs its operator tree depth-first on a single thread, so a
    plain stack gives correct parenting for nested `op_span` calls.
    Operator MetricsSets are cumulative per plan instance and shared by
    same-stage tasks; the recorder snapshots `to_dict()` around each
    execute call and attaches the *delta* as span attributes, which is
    this task's contribution (up to interleaving with concurrent tasks
    of the same stage on this executor).
    """

    def __init__(self, trace_id: Optional[str] = None, parent_id: str = "",
                 name: str = "task", kind: str = "executor",
                 attrs: Optional[Dict] = None):
        self.root = Span(name, trace_id or new_trace_id(),
                         parent_id=parent_id or "", kind=kind,
                         attrs=dict(attrs or {}))
        self._done: List[Span] = []
        self._stack: List[Span] = [self.root]

    def annotate(self, **attrs) -> None:
        self.root.attrs.update(attrs)

    @contextlib.contextmanager
    def op_span(self, op, **attrs):
        name = op if isinstance(op, str) else type(op).__name__
        before: Dict[str, float] = {}
        ms = getattr(op, "metrics", None)
        if callable(ms):
            try:
                before = _values(ms())
            except Exception:
                ms = None
        span = Span(name, self.root.trace_id,
                    parent_id=self._stack[-1].span_id, kind="operator",
                    attrs=dict(attrs))
        for k in ("actor", "lane"):  # inherit the task's trace lanes
            if k in self.root.attrs:
                span.attrs.setdefault(k, self.root.attrs[k])
        self._stack.append(span)
        try:
            yield span
        except BaseException:
            span.status = "error"
            raise
        finally:
            self._stack.pop()
            if callable(ms):
                try:
                    for k, v in _values(ms()).items():
                        delta = v - before.get(k, 0.0)
                        if delta:
                            span.attrs[k] = round(float(delta), 6)
                except Exception:
                    pass
            span.end()
            self._done.append(span)

    def finish(self, status: str = "ok") -> List[Span]:
        self.root.end(status)
        return [self.root] + list(self._done)
