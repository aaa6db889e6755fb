"""The port's observability host functions (arrow_ballista_tpu_torch/obs)
against the JAX package's (arrow_ballista_tpu/obs): the same fixed inputs
through both packages' functions, and the outputs equal.

The cases: the nearest-rank quantile, the row histogram, the skew
coefficient and the duration quantiles; the Chrome trace and the OTLP
payload of one fixed span set; ``job_progress`` / ``monotonic_fraction``
and the progress bar on a fixed graph; the SLO burn-rate math over fixed
samples; ``diagnose`` on one fixed forensics bundle and ``validate_bundle``
on it; ``advise_report`` on one fixed EXPLAIN ANALYZE report; the flight
recorder's timeline, ring and counters after one fixed sequence of emits.
"""
import importlib

import pytest

PACKAGES = ("arrow_ballista_tpu", "arrow_ballista_tpu_torch")


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.obs.{name}")


# --- fixed inputs --------------------------------------------------------

_DURATIONS = [0.31, 0.05, 1.7, 0.2, 0.2, 0.9, 0.44, 3.1, 0.07, 0.52, 0.6]
_ROWS = [0, 1, 7, 10, 11, 99, 100, 5_000, 123_456, 9_999_999, 10**9]


def _spans(pkg):
    tr = _mod(pkg, "tracing")
    objs = [
        {"name": "job j1", "trace_id": "t" * 32, "span_id": "a" * 16, "parent_id": "",
         "kind": "scheduler", "start_ms": 1000.0, "end_ms": 1900.5, "status": "ok",
         "attrs": {"actor": "scheduler", "lane": "job j1", "job_id": "j1"}},
        {"name": "execution", "trace_id": "t" * 32, "span_id": "b" * 16,
         "parent_id": "a" * 16, "kind": "scheduler", "start_ms": 1010.25,
         "end_ms": 1890.0, "status": "ok", "attrs": {"actor": "scheduler"}},
        {"name": "task j1/1/0", "trace_id": "t" * 32, "span_id": "c" * 16,
         "parent_id": "b" * 16, "kind": "executor", "start_ms": 1020.0, "end_ms": 1500.0,
         "status": "failed", "attrs": {"actor": "executor e0", "lane": "stage 1 / p0",
                                       "rows_written": 42, "ratio": 0.5, "spec": False}},
        {"name": "HashAggregateExec", "trace_id": "t" * 32, "span_id": "d" * 16,
         "parent_id": "c" * 16, "kind": "operator", "start_ms": 1030.0, "end_ms": 1030.0,
         "status": "ok", "attrs": {"actor": "executor e0", "lane": "stage 1 / p0",
                                   "elapsed_time": 0.0125}},
    ]
    return [tr.span_from_obj(o) for o in objs]


class _Task:
    def __init__(self, state, started_at=100.0):
        self.state = state
        self.started_at = started_at


class _Stage:
    def __init__(self, state, partitions, done=0, running=0, durations=(), stage_id=1):
        self.state = state
        self.partitions = partitions
        self.task_infos = ([_Task("success")] * done + [_Task("running")] * running
                           + [None] * (partitions - done - running))
        self.speculative_tasks = {}
        self.durations = list(durations)
        self.stage_id = stage_id


class _Graph:
    def __init__(self, stages, status="running", job_id="synth"):
        self.stages = stages
        self.status = status
        self.job_id = job_id
        self.stats = None


def _graphs():
    return [
        _Graph({1: _Stage("successful", 4, done=4, durations=[0.1] * 4),
                2: _Stage("running", 4, done=0, running=2)}),
        _Graph({1: _Stage("successful", 8, done=8, durations=[0.2] * 8),
                2: _Stage("running", 4, done=4, durations=[0.2, 0.3, 0.25, 0.9]),
                3: _Stage("unresolved", 4)}),
        _Graph({1: _Stage("running", 4, running=2)}),
        _Graph({1: _Stage("successful", 4, done=4)}, status="successful"),
    ]


def _bundle():
    """A forensics bundle on which most of the catalog fires: skew, a
    straggler, a retrace storm, a missed fusion, spill, a shuffle hotspot,
    plan-cache churn and control-plane churn."""
    stage = {
        "stage_id": 2, "state": "successful", "output_rows": 90_000,
        "tasks_completed": 4, "skew": 3.5,
        "partition_rows": {"0": 80_000, "1": 4_000, "2": 3_000, "3": 3_000},
        "partition_bytes": {"0": 8 << 20, "1": 1 << 16, "2": 1 << 16, "3": 1 << 16},
        "task_duration_s": {"count": 4, "p50": 0.2, "p75": 0.3, "p95": 2.4,
                            "max": 2.4, "mean": 0.8},
        "speculative_launches": 0,
        "device": {"jit_retraces": 40, "jit_compiles": 2, "jit_compile_time": 0.1},
        "operators": {"0.0:FilterExec": {"jit_retraces": 30, "jit_compiles": 1,
                                         "jit_compile_time": 0.05, "h2d_time": 0.08},
                      "0.0.0:ProjectionExec": {"jit_retraces": 10, "h2d_time": 0.02,
                                               "spill_runs": 2}},
        "fusion": [{"fused": False, "paths": ["0", "0.0", "0.0.0"],
                    "operators": ["HashAggregateExec", "FilterExec", "ProjectionExec"],
                    "rejected": [{"op": "HashAggregateExec", "reason": "no kernel"}]}],
        "spill_runs": 2, "spill_bytes": 3 << 20,
    }
    return {
        "schema": "ballista.forensics/v1", "job_id": "j42", "generated_ts_ms": 1,
        "status": {"state": "successful", "error": ""},
        "journal": [{"seq": 1, "kind": "job.submitted", "job_id": "j42"},
                    {"seq": 2, "kind": "speculation.win", "attrs": {"stage_id": 2}},
                    {"seq": 3, "kind": "quarantine.enter"}],
        "stages": [stage, {"stage_id": 3, "state": "successful", "output_rows": 4,
                           "tasks_completed": 1, "skew": 1.0}],
        "aqe_log": [], "metrics": {"plan_cache_hits": 1, "plan_cache_misses": 9},
        "cluster_history": {"samples": [{"event_loop_lag_s": 0.08},
                                        {"event_loop_lag_s": 0.3}]},
    }


def _report():
    """An EXPLAIN ANALYZE report with two stages and chains of measured
    host overhead (no operator the two packages' static fusion reasons
    word differently)."""
    def op(path, depth, name, rows, dev, host, xfer=0, compiles=0, retraces=0, ct=0.0):
        return {"path": path, "depth": depth, "op": name, "label": f"{name}: x\nmore",
                "rows": rows, "time_ms": dev + host, "bytes": 100, "device_ms": dev,
                "host_ms": host, "transfer_bytes": xfer, "compiles": compiles,
                "retraces": retraces, "spill_bytes": 0, "spill_runs": 0,
                "metrics": {"jit_compile_time": ct}}

    s1 = {"stage_id": 1, "state": "successful", "tasks_completed": 4, "partitions": 4,
          "output_rows": 16, "output_bytes": 2048, "skew": 1.0, "speculative_launches": 2,
          "spill_bytes": 5000, "spill_runs": 1,
          "aqe": [{"kinds": ["coalesce"], "partitions_before": 4, "partitions_after": 1}],
          "fusion": [{"fused": True, "fused_ops": [["HashAggregateExec", "RenameExec"]],
                      "donate": True, "paths": ["0.0"]}],
          "task_duration_s": {"count": 4, "p50": 0.05, "p75": 0.06, "p95": 0.07,
                              "max": 0.07, "mean": 0.06},
          "device": {"jit_compiles": 2, "jit_retraces": 1, "h2d_bytes": 4096,
                     "d2h_bytes": 1024, "device_mem_peak": 1 << 20},
          "operator_tree": [
              op("0", 0, "ShuffleWriterExec", 16, 1.0, 0.5),
              op("0.0", 1, "ProjectionExec", 16, 2.0, 3.0, xfer=500, compiles=1, retraces=2,
                 ct=0.003),
              op("0.0.0", 2, "FilterExec", 40, 1.5, 4.0, xfer=100),
              op("0.0.0.0", 3, "RenameExec", None, 0.5, 2.0),
              op("0.0.0.0.0", 4, "MemoryScanExec", 100, 0.2, 0.1)]}
    s2 = {"stage_id": 2, "state": "running", "tasks_completed": 0, "partitions": 1,
          "output_rows": 0, "output_bytes": 0, "skew": 0.0, "fusion": [],
          "task_duration_s": {"count": 0}, "device": {},
          "operator_tree": [
              op("0", 0, "ShuffleWriterExec", None, 0.1, 0.0),
              op("0.0", 1, "ProjectionExec", 4, 0.3, 1.25),
              op("0.0.0", 2, "FilterExec", 4, 0.2, 0.75),
              op("0.0.0.0", 3, "ShuffleReaderExec", 4, 0.1, 0.0)]}
    return {"job_id": "j7", "state": "running", "wall_time_ms": 123.4, "rows_returned": 16,
            "total_output_rows": 16, "total_shuffle_bytes": 2048, "stages": [s1, s2]}


# --- the cases -----------------------------------------------------------

def _quantiles(pkg):
    st = _mod(pkg, "stats")
    return ([st.nearest_rank_quantile(_DURATIONS, q) for q in (0, 0.25, 0.5, 0.75, 0.95, 1)]
            + [st.nearest_rank_quantile([], 0.5), st.nearest_rank_quantile([3.0], 1.5)])


def _histogram(pkg):
    st = _mod(pkg, "stats")
    return st.row_histogram(_ROWS), st.row_histogram([])


def _skew(pkg):
    st = _mod(pkg, "stats")
    return [st.skew_coefficient(v) for v in ([], [0, 0], [5, 5, 5], [1, 2, 97], _ROWS)]


def _duration_summary(pkg):
    st = _mod(pkg, "stats")
    return st.duration_quantiles(_DURATIONS), st.duration_quantiles([])


def _chrome(pkg):
    return _mod(pkg, "trace_event").spans_to_chrome(_spans(pkg))


def _otlp(pkg):
    return _mod(pkg, "tracing").otlp_payload(_spans(pkg), "svc")


def _progress(pkg):
    pr = _mod(pkg, "progress")
    out, floor = [], 0.0
    for g in _graphs():
        p = pr.job_progress(g)
        floor = pr.monotonic_fraction(p, floor)
        out.append((p, floor, pr.render_progress_bar(p)))
    return out


def _slo(pkg):
    slo = _mod(pkg, "slo")
    tr = slo.SloTracker(slo.SloPolicy(100.0, 120.0))
    for i, (ms, ok) in enumerate([(50, True), (150, True), (80, False), (20, True),
                                  (99, True), (101, True), (10, True), (500, True)]):
        tr.record(ms, ok=ok, ts=1000.0 + 15.0 * i)
    shards = [{"slo_fast_count": 3, "slo_fast_violations": 1, "slo_slow_count": 9,
               "slo_slow_violations": 2}]
    return (tr.sample(now=1110.0), tr.snapshot(now=1110.0, shard_samples=shards),
            tr.max_burn_rate(now=1110.0), tr.snapshot(now=2000.0),
            slo.merge_samples(shards * 2), slo.NullSloTracker().snapshot())


def _diagnose(pkg):
    doc = _mod(pkg, "doctor")
    b = _bundle()
    return doc.diagnose(b), doc.validate_bundle(b), doc.validate_bundle({"schema": "x"})


def _advise(pkg):
    adv = _mod(pkg, "advisor")
    return adv.advise_report(_report()), adv.advise_report(_report(), min_savings_ms=3.0)


def _journal(pkg):
    """A job's lifecycle chain, a task launch/finish pair joined by causal
    key, an absorbed executor event and the ring's counters (timestamps
    left out: they are wall-clock)."""
    j = _mod(pkg, "journal")
    j.reset()
    j.set_enabled(True)
    j.configure(capacity=8, actor="sched")
    try:
        j.emit_job("job.submitted", "j1")
        j.emit_job("job.planned", "j1", stages=3)
        j.emit("task.launch", job_id="j1", causal_key=("task", "j1", 1, 0, 0), stage_id=1)
        j.emit("task.finish", job_id="j1", parent_key=("task", "j1", 1, 0, 0), state="success")
        j.absorb("j1", [{"seq": 99, "ts_ms": 5, "kind": "task.run", "actor": "e0"},
                        {"seq": 4, "ts_ms": 5, "kind": "dup", "actor": "sched"}])
        j.emit_job("job.successful", "j1")
        for i in range(6):
            j.emit("noise", n=i)
        strip = lambda evs: [{k: v for k, v in e.items() if k != "ts_ms"} for e in evs]  # noqa: E731
        return strip(j.job_timeline("j1")), strip(j.snapshot()), j.counters()
    finally:
        j.reset()
        j.set_enabled(False)
        j.configure(capacity=4096, actor="")


CASES = {
    "nearest_rank_quantile": _quantiles,
    "row_histogram": _histogram,
    "skew_coefficient": _skew,
    "duration_quantiles": _duration_summary,
    "spans_to_chrome": _chrome,
    "otlp_payload": _otlp,
    "job_progress": _progress,
    "slo_burn_rate": _slo,
    "diagnose": _diagnose,
    "advise_report": _advise,
    "journal_timeline": _journal,
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_host_function_matches_the_reference(case):
    ref, port = (CASES[case](pkg) for pkg in PACKAGES)
    assert port == ref
