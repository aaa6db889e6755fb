"""The port's device observatory (arrow_ballista_tpu_torch/obs/device.py):
a launch registry over the port's kernels, with the reference's public
surface and key names.

The scope, summary and advisor cases of tests/test_device_obs.py, with its
``observed_jit`` cases replaced by their launch-registry counterparts:
``count_launch`` attributes each launch by kernel name to the open operator
and task scopes of its own thread (nested scopes, task threads apart),
disabled mode attributes nothing and keeps the process counter, the CPU
times nothing, generated-source lookups count as compiles, retraces and
cache hits; ``device_summary`` folds task statuses exactly as the JAX
package's does; a local EXPLAIN ANALYZE carries each operator's launches;
the advisor's report schema; the job profile's failover hooks against the
JAX package's.
"""
import threading

import pytest
import torch

import arrow_ballista_tpu.obs.device as jdev
import arrow_ballista_tpu.obs.stats as jstats
import arrow_ballista_tpu_torch as tab
import arrow_ballista_tpu_torch.obs.device as dev
import arrow_ballista_tpu_torch.obs.stats as tstats
from arrow_ballista_tpu_torch.ops import kernels as TK
from arrow_ballista_tpu_torch.ops.physical import MetricsSet, TaskContext

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _fresh():
    dev.set_enabled(True)
    dev.set_watermarks(True)
    dev.STATS.reset()
    TK.reset_launch_counts()
    yield
    dev.set_enabled(True)
    dev.set_watermarks(True)
    dev.STATS.reset()
    TK.reset_launch_counts()


class _Op:
    def __init__(self):
        self._ms = MetricsSet()

    def metrics(self):
        return self._ms


# --- the launch registry -------------------------------------------------

def test_count_launch_attributes_to_the_open_op_and_task_scopes():
    outer, inner = _Op(), _Op()
    with dev.task_scope(torch.device("cpu")) as acc:
        with dev.op_scope(outer):
            TK.count_launch("hash64")
            with dev.op_scope(inner):
                TK.count_launch("sort_order")
                TK.count_launch("sort_order")
            TK.count_launch("gather_columns")
        TK.count_launch("hash64")  # no op scope open: the task only
    snap = acc.snapshot()
    assert snap["launches.hash64"] == 2 and snap["launches.sort_order"] == 2
    assert snap["launches.gather_columns"] == 1 and snap["kernel_launches"] == 5
    assert outer.metrics().to_dict() == {"launches.hash64": 1, "launches.gather_columns": 1,
                                         "kernel_launches": 2}
    assert inner.metrics().to_dict() == {"launches.sort_order": 2, "kernel_launches": 2}
    assert TK.LAUNCHES["hash64"] == 2 and TK.LAUNCHES["sort_order"] == 2
    # on the CPU nothing is timed: no kernel_ms is made up
    assert not any(k.startswith("kernel_ms") for k in snap)
    assert snap["watermark_samples"] >= 2 and "host_mem_peak" in snap


def test_task_threads_see_their_own_scopes():
    ops = [_Op() for _ in range(4)]
    accs = [None] * 4
    barrier = threading.Barrier(4)

    def task(i):
        with dev.task_scope(torch.device("cpu")) as acc:
            accs[i] = acc
            with dev.op_scope(ops[i]):
                barrier.wait()
                for _ in range(100 * (i + 1)):
                    TK.count_launch("probe_join")

    threads = [threading.Thread(target=task, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    for i in range(4):
        assert accs[i].snapshot()["launches.probe_join"] == 100 * (i + 1)
        assert ops[i].metrics().to_dict()["launches.probe_join"] == 100 * (i + 1)
    assert TK.LAUNCHES["probe_join"] == 1000


def test_disabled_observatory_attributes_nothing_and_keeps_the_process_counter():
    dev.set_enabled(False)
    op = _Op()
    assert dev.op_scope(op) is dev._NULL
    assert dev.task_scope(torch.device("cpu")) is dev._NULL_TASK
    with dev.task_scope(torch.device("cpu")) as acc, dev.op_scope(op):
        TK.count_launch("bucket_masks")
        dev.record_transfer("h2d", 1 << 20, 0.01)
        dev.record_program_cache(True)
    assert acc is None and op.metrics().to_dict() == {}
    assert TK.LAUNCHES["bucket_masks"] == 1
    assert dev.sample_watermarks() is None
    assert dev.STATS.snapshot()["h2d_bytes"] == 0
    # op_span is then the elapsed_time timer alone
    span = TaskContext(device=torch.device("cpu")).op_span(op)
    assert type(span).__name__ == "_Timer"


def test_cpu_task_scope_never_times_launches():
    with dev.task_scope(torch.device("cpu")):
        assert dev._timing is False
        dev.launch_begin()  # a no-op without a CUDA task
        TK.count_launch("mask_ops")
    assert dev._timing is False and dev._timed_scopes == 0


def test_op_span_times_and_attributes_in_one_scope():
    op = _Op()
    ctx = TaskContext(device=torch.device("cpu"))
    with dev.task_scope(torch.device("cpu")) as acc:
        with ctx.op_span(op):
            TK.count_launch("concat_columns")
    mm = op.metrics().to_dict()
    assert mm["launches.concat_columns"] == 1 and mm["elapsed_time"] > 0
    assert acc.snapshot()["launches.concat_columns"] == 1


def test_generated_lookups_count_compiles_retraces_and_hits():
    op = _Op()
    with dev.task_scope(torch.device("cpu")) as acc:
        dev.record_generated(op, "FilterExec:l_shipdate", "libfused-a.so", 1.5)
        dev.record_generated(op, "FilterExec:l_shipdate", "libfused-a.so", None)
        dev.record_generated(op, "FilterExec:l_shipdate", "libfused-b.so", 0.5)
        dev.record_generated(op, "ProjectionExec:x", "libfused-c.so", 0.25)
    mm = op.metrics().to_dict()
    assert (mm["jit_compiles"], mm["jit_retraces"], mm["jit_cache_hits"]) == (2, 1, 1)
    assert mm["jit_compile_time"] == pytest.approx(2.25)
    snap = acc.snapshot()
    assert (snap["jit_compiles"], snap["jit_retraces"], snap["jit_cache_hits"]) == (2, 1, 1)
    stats = dev.STATS.snapshot()
    assert stats["jit_compiles"] == 2 and stats["jit_compile_time"] == pytest.approx(2.25)


def test_transfers_and_program_cache_land_in_the_open_scopes():
    op = _Op()
    with dev.task_scope(torch.device("cpu")) as acc, dev.op_scope(op):
        dev.record_transfer("h2d", 4096, 0.002)
        dev.record_transfer("d2h", 1024)
        dev.record_program_cache(False)
    mm = op.metrics().to_dict()
    assert mm["h2d_bytes"] == 4096 and mm["h2d_transfers"] == 1 and mm["d2h_bytes"] == 1024
    assert "d2h_time" not in mm and mm["program_cache_misses"] == 1
    snap = acc.snapshot()
    assert snap["h2d_bytes"] == 4096 and snap["h2d_time"] == pytest.approx(0.002)


def test_device_stats_ride_the_status_only_when_present():
    from arrow_ballista_tpu_torch.scheduler.types import TaskId, TaskStatus

    st = TaskStatus(TaskId("j", 1, 0), "e0", "success")
    assert st.device_stats == {} and st.journal == [] and st.spans == []


# --- the folds, against the JAX package ----------------------------------

class _St:
    def __init__(self, ds, attempt):
        self.device_stats = ds
        self.task = type("T", (), {"task_attempt": attempt})()


class _Info:
    def __init__(self, ds, attempt, status_attempt=None):
        self.status = _St(ds, attempt if status_attempt is None else status_attempt)
        self.attempt = attempt


class _Stage:
    def __init__(self):
        self.task_infos = [
            _Info({"jit_compiles": 2, "h2d_bytes": 100, "device_mem_peak": 5000,
                   "launches.hash64": 3, "kernel_ms": 1.25}, 0),
            _Info({"jit_compiles": 1, "h2d_time": 0.5, "host_mem_peak": 7000,
                   "device_mem_peak": 4000, "kernel_ms": 0.5}, 1),
            _Info({"jit_compiles": 50, "device_mem_peak": 10 ** 9}, 2, status_attempt=1),
            _Info({}, 3),
        ]


def test_device_summary_sums_counters_maxes_peaks_and_guards_attempts():
    got = tstats.device_summary(_Stage())
    assert got == jstats.device_summary(_Stage())
    assert got["jit_compiles"] == 3 and got["device_mem_peak"] == 5000
    assert got["launches.hash64"] == 3 and got["kernel_ms"] == 1.75


def test_public_surface_matches_the_reference():
    for name in ("set_enabled", "enabled", "set_watermarks", "op_scope", "task_scope",
                 "record_transfer", "record_program_cache", "sample_watermarks", "STATS",
                 "TaskAccumulator"):
        assert hasattr(dev, name) and hasattr(jdev, name), name
    assert set(jdev._COUNTER_KEYS) <= set(dev._COUNTER_KEYS)
    assert dev._PEAK_KEYS == jdev._PEAK_KEYS


def test_local_explain_analyze_carries_each_operators_launches(monkeypatch):
    """On the CPU the wrappers run their twins, which launch nothing: here
    the sort and gather twins are made to count as their kernels would, so
    the report's operators carry their launches."""
    import pyarrow as pa

    def counting(name, fn):
        def wrapper(*args, **kwargs):
            TK.count_launch(name)
            return fn(*args, **kwargs)
        return wrapper

    monkeypatch.setattr(TK, "sort_order", counting("sort_order", TK.sort_order))
    monkeypatch.setattr(TK, "gather_columns", counting("gather_columns", TK.gather_columns))
    ctx = tab.BallistaContext.local(device="cpu")
    ctx.register_table("t", pa.table({"a": list(range(50))[::-1], "b": [1.5] * 50}))
    report = ctx.explain_analyze("select a, b from t order by a")
    sort = [o for o in report["stages"][0]["operator_tree"] if o["op"] == "SortExec"]
    assert sort and sort[0]["metrics"]["launches.sort_order"] >= 1
    assert sort[0]["metrics"]["launches.gather_columns"] >= 1
    device = report["stages"][0]["device"]
    assert device["launches.sort_order"] == TK.LAUNCHES["sort_order"]
    assert device["kernel_launches"] >= 2 and "kernel_ms" not in device


# --- the advisor and the job profile -------------------------------------

def test_advisor_report_schema_and_min_savings_filter():
    from arrow_ballista_tpu_torch.obs.advisor import advise_report

    tree = [{"path": "0", "depth": 0, "op": "ProjectionExec", "label": "p", "device_ms": 1.0,
             "host_ms": 0.5, "transfer_bytes": 10, "compiles": 1, "retraces": 0,
             "metrics": {}},
            {"path": "0.0", "depth": 1, "op": "FilterExec", "label": "f", "device_ms": 2.0,
             "host_ms": 4.0, "transfer_bytes": 0, "compiles": 1, "retraces": 3,
             "metrics": {"jit_compile_time": 0.004}}]
    rep = {"job_id": "j", "wall_time_ms": 9.0, "stages": [{"stage_id": 1,
                                                           "operator_tree": tree}]}
    out = advise_report(rep)
    assert [c["operators"] for c in out["candidates"]] == [["ProjectionExec", "FilterExec"]]
    c = out["candidates"][0]
    assert set(c) >= {"fused", "reason", "stage_id", "paths", "device_ms", "host_ms",
                      "est_savings_ms", "overhead_ratio", "reasons"}
    assert c["est_savings_ms"] == 4.0 and "FUSION ADVISOR" in out["text"]
    assert advise_report(rep, min_savings_ms=10.0)["candidates"] == []


def test_job_profile_failover_hooks_match_the_reference():
    from arrow_ballista_tpu.obs.profile import JobObservability as JObs
    from arrow_ballista_tpu_torch.obs.profile import JobObservability as TObs

    def drive(cls):
        obs = cls(retention=4)
        obs.on_adopted("j1", 3, prev_owner="s-a", scheduler_id="s-b",
                       trace={"trace_id": "t" * 32, "span_id": "p" * 16})
        ctx = obs.task_parent("j1")
        obs.on_stand_down("j1", "lease lost")
        prof = obs.get_profile("j1")
        trace = obs.get_trace("j1")
        names = sorted(e["name"] for e in trace["traceEvents"] if e["ph"] == "X")
        return (sorted(prof["phases"]), prof["state"], prof["stand_down_reason"],
                prof["trace_id"], len(ctx["span_id"]), names)

    assert drive(TObs) == drive(JObs)
