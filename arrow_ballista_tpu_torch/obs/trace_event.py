"""Chrome trace-event JSON rendering (Perfetto / chrome://tracing).

Each span becomes a complete ("X") event; processes (pid) are the
scheduler and each executor, threads (tid) are lanes within them (the
job on the scheduler, stage/partition on executors), named via "M"
metadata events so Perfetto shows readable tracks.  Timestamps are
microseconds since the epoch, as the format requires.  The port's copy
of arrow_ballista_tpu/obs/trace_event.py.
"""
from typing import Dict, List

from .tracing import Span, now_ms


def spans_to_chrome(spans: List[Span]) -> Dict:
    pids: Dict[str, int] = {}
    tids: Dict[tuple, int] = {}
    meta: List[Dict] = []
    events: List[Dict] = []
    now = now_ms()

    def pid_of(actor: str) -> int:
        if actor not in pids:
            pids[actor] = len(pids) + 1
            meta.append({"ph": "M", "name": "process_name",
                         "pid": pids[actor], "tid": 0,
                         "args": {"name": actor}})
        return pids[actor]

    def tid_of(pid: int, lane: str) -> int:
        key = (pid, lane)
        if key not in tids:
            tids[key] = sum(1 for p, _ in tids if p == pid) + 1
            meta.append({"ph": "M", "name": "thread_name",
                         "pid": pid, "tid": tids[key],
                         "args": {"name": lane}})
        return tids[key]

    for s in sorted(spans, key=lambda s: s.start_ms):
        actor = str(s.attrs.get("actor") or s.kind or "process")
        lane = str(s.attrs.get("lane") or s.name)
        pid = pid_of(actor)
        args = {k: v for k, v in s.attrs.items()
                if k not in ("actor", "lane")}
        args.update(span_id=s.span_id, parent_id=s.parent_id,
                    status=s.status)
        events.append({
            "ph": "X", "cat": s.kind or "span", "name": s.name,
            "ts": round(s.start_ms * 1000.0, 1),
            "dur": max(round(((s.end_ms or now) - s.start_ms) * 1000.0, 1),
                       1.0),
            "pid": pid, "tid": tid_of(pid, lane), "args": args,
        })

    return {"displayTimeUnit": "ms",
            "traceId": spans[0].trace_id if spans else "",
            "traceEvents": meta + events}
