"""The port's forensics, query doctor and live plane (obs/doctor.py,
obs/live.py, obs/slo.py, journal watch streams) on the standalone engine
on the CPU: the non-REST, non-remote, non-failover cases of
tests/test_doctor.py and tests/test_live_obs.py.

- A clean run: a valid bundle whose timeline records the job lifecycle,
  stage resolution and every task's launch, run and finish (each finish
  chained to its launch), and zero findings; an unknown job raises.
- A straggler made by the ``executor.task.slow`` failpoint is diagnosed
  as one (without speculation, which the port lacks, from the duration
  spread), and the in-flight doctor raises an alert while the job runs
  and clears it after.
- The in-flight doctor's hysteresis on a synthetic graph and its standing
  ``journal-drops`` alert; watch subscriptions (order, job filter, the gap
  event of an overflow, detach); the SLO tracker fed by completed jobs.
- ``ctx.watch`` on a finished job and on a running one: ordered events, a
  non-decreasing fraction and one terminal frame, ``successful``.
"""
import json
import threading
import time
import types

import numpy as np
import pyarrow as pa
import pytest
import torch

import arrow_ballista_tpu_torch as tab
from arrow_ballista_tpu_torch import faults
from arrow_ballista_tpu_torch.obs import journal
from arrow_ballista_tpu_torch.obs.doctor import diagnose, validate_bundle
from arrow_ballista_tpu_torch.obs.live import CLEAR_AFTER, LiveDoctor
from arrow_ballista_tpu_torch.obs.slo import NullSloTracker, SloTracker
from arrow_ballista_tpu_torch.utils.errors import PlanningError

torch.set_num_threads(1)

SQL = "select g, sum(v) as s, count(*) as n from t group by g order by g"


@pytest.fixture(autouse=True)
def _journal_on():
    """A fresh, enabled journal per test; no fault plan before or after."""
    journal.reset()
    journal.set_enabled(True)
    journal.configure(capacity=4096)
    faults.clear()
    yield
    faults.clear()
    journal.reset()
    journal.set_enabled(False)
    journal.configure(capacity=4096)


def _table(rng, n, groups=7):
    return pa.table({"g": pa.array(rng.integers(0, groups, n).astype(np.int64)),
                     "v": pa.array(rng.integers(0, 100, n).astype(np.int64))})


def _standalone(conf=None, concurrent_tasks=2, num_executors=2):
    base = {"ballista.shuffle.partitions": "4", "ballista.journal.enabled": "true"}
    base.update(conf or {})
    return tab.BallistaContext.standalone(tab.BallistaConfig(base),
                                          concurrent_tasks=concurrent_tasks,
                                          num_executors=num_executors, device="cpu")


def _wait_for(pred, timeout, msg):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.05)
    raise AssertionError(msg)


def _slow_plan(delay_ms, times=1):
    return faults.FaultPlan.from_obj({"seed": 21, "rules": [{
        "site": "executor.task.slow", "action": "delay", "delay_ms": delay_ms,
        "times": times, "match": {"stage_id": 1, "executor_id": "executor-0"}}]})


# --- forensics and the doctor --------------------------------------------

def test_clean_run_bundle_timeline_and_zero_findings():
    ctx = _standalone()
    try:
        ctx.register_table("t", _table(np.random.default_rng(3), 4000))
        assert len(ctx.sql(SQL).to_pandas()) == 7
        bundle = ctx.forensics()
        assert validate_bundle(bundle) == [] and bundle["journal_enabled"]
        tl = bundle["journal"]
        kinds = [e["kind"] for e in tl]
        for k in ("job.submitted", "job.planned", "stage.resolved", "task.launch",
                  "task.run", "task.finish", "job.successful"):
            assert k in kinds, f"the timeline records {k}: {kinds}"
        assert kinds[0] == "job.submitted" and kinds[-1] == "job.successful"
        launches = {e["seq"]: e for e in tl if e["kind"] == "task.launch"}
        finishes = [e for e in tl if e["kind"] == "task.finish"]
        assert finishes and all(e.get("parent") in launches for e in finishes)
        for e in finishes:
            la = launches[e["parent"]]["attrs"]
            assert (la["stage_id"], la["partition"]) == \
                (e["attrs"]["stage_id"], e["attrs"]["partition"])
        assert len([e for e in tl if e["kind"] == "task.run"]) == len(finishes)
        assert bundle["profile"]["state"] == "successful"
        assert set(bundle["profile"]["phases"]) == {"admission", "planning", "execution"}
        assert bundle["trace"]["traceEvents"] and bundle["stages"]
        diag = ctx.doctor()
        assert diag["findings"] == [], diag["text"]
        assert "no pathology detected" in diag["text"]
        json.dumps(bundle)  # one self-contained JSON document
    finally:
        ctx.shutdown()


def test_forensics_unknown_job_and_local_session_raise():
    ctx = _standalone()
    try:
        with pytest.raises(PlanningError, match="no job has run"):
            ctx.forensics()
        with pytest.raises(PlanningError, match="not known"):
            ctx.forensics("nosuchjob")
    finally:
        ctx.shutdown()
    with pytest.raises(PlanningError, match="standalone"):
        tab.BallistaContext.local(device="cpu").doctor()


def test_straggler_failpoint_diagnosed():
    """One stage-1 task stalls 1.5 s (``executor.task.slow``): the doctor
    diagnoses exactly a straggler on stage 1, and the firing is in the
    journal."""
    ctx = _standalone({"ballista.shuffle.partitions": "8"})
    try:
        ctx.register_table("t", _table(np.random.default_rng(23), 4000))
        plan = _slow_plan(1500)
        with faults.use_plan(plan):
            ctx.sql(SQL).to_pandas()
        assert plan.events, "the slow failpoint fired"
        bundle = ctx.forensics()
        assert "fault.fired" in [e["kind"] for e in bundle["journal"]]
        diag = diagnose(bundle)
        assert [f["rule"] for f in diag["findings"]] == ["straggler"], diag["text"]
        f = diag["findings"][0]
        assert f["stage_id"] == 1 and f["evidence"]["duration_spread_p95_p50"] >= 3.0
        assert f["evidence"]["task_duration_s"]["max"] >= 1.5
    finally:
        ctx.shutdown()


def test_live_straggler_alert_raised_then_cleared():
    ctx = _standalone({"ballista.shuffle.partitions": "8", "ballista.live.enabled": "true",
                       "ballista.live.doctor.interval.seconds": "0.15"})
    try:
        ctx.register_table("t", _table(np.random.default_rng(23), 4000))
        sched = ctx._standalone.scheduler
        assert sched._live_doctor_thread is not None and sched._live_doctor_thread.is_alive()
        plan = _slow_plan(2000)
        with faults.use_plan(plan):
            ctx.sql(SQL).to_pandas()
        assert plan.events
        job_id = ctx._standalone.last_job_id

        def kinds():
            return [e["kind"] for e in journal.job_timeline(job_id)]

        raised = [e for e in journal.job_timeline(job_id) if e["kind"] == "alert.raised"]
        assert any(e["attrs"]["rule"] == "straggler" for e in raised), kinds()
        f = [e for e in raised if e["attrs"]["rule"] == "straggler"][0]
        assert f["attrs"]["evidence"]["oldest_running_task_s"] > 0.4
        _wait_for(lambda: "alert.cleared" in kinds(), 5.0, "the alert clears after the job")
        cleared = [e for e in journal.job_timeline(job_id) if e["kind"] == "alert.cleared"][0]
        assert cleared["attrs"]["reason"] == "job-finished"
        _wait_for(lambda: sched.live_doctor.alerts_active() == 0, 5.0, "no standing alerts")
    finally:
        ctx.shutdown()


def test_live_plane_off_starts_no_thread_and_null_slo():
    ctx = _standalone()
    try:
        sched = ctx._standalone.scheduler
        assert sched._live_doctor_thread is None
        assert isinstance(sched.slo, NullSloTracker) and sched.slo_report() == {"enabled": False}
        assert journal.watcher_count() == 0
    finally:
        ctx.shutdown()


def test_slo_feeds_from_completed_jobs():
    """A sub-millisecond p99 target makes every real job a violation: the
    burn rate moves."""
    ctx = _standalone({"ballista.slo.latency.p99.target.ms": "0.001",
                       "ballista.slo.window.seconds": "300"})
    try:
        ctx.register_table("t", _table(np.random.default_rng(11), 2000))
        ctx.sql(SQL).to_pandas()
        sched = ctx._standalone.scheduler
        assert isinstance(sched.slo, SloTracker)
        snap = sched.slo_report()
        assert snap["enabled"] and snap["windows"]["fast"]["violations"] >= 1
        assert snap["windows"]["fast"]["burn_rate"] > 1.0
        assert sched.cluster_history()["now"]["total_slots"] == 4
    finally:
        ctx.shutdown()


# --- the in-flight doctor on synthetic graphs ----------------------------

class _Task:
    def __init__(self, state, started_at=None):
        self.state = state
        self.started_at = started_at if started_at is not None else time.monotonic()


class _Stage:
    def __init__(self, state, partitions, done=0, running=0, durations=(), stage_id=1):
        self.state = state
        self.partitions = partitions
        self.task_infos = ([_Task("success")] * done + [_Task("running")] * running
                           + [None] * (partitions - done - running))
        self.speculative_tasks = {}
        self.durations = list(durations)
        self.stage_id = stage_id
        self.stage_attempt = 0
        self.planned_partitions = partitions
        self.outputs = {}
        self.attempt_log = []

    def operator_metrics(self):
        return {}


class _Graph:
    def __init__(self, stages, status="running", job_id="synth"):
        self.stages = stages
        self.status = status
        self.job_id = job_id
        self.stats = None


def _stub_server(graphs=()):
    jobs = types.SimpleNamespace(active_graphs=lambda: list(graphs))
    return types.SimpleNamespace(jobs=jobs, cluster_history=lambda: {})


def test_live_doctor_clear_hysteresis_inline():
    stage = _Stage("running", 4, done=2, running=1, durations=[0.05, 0.06])
    stage.task_infos[2].started_at = time.monotonic() - 10.0
    g = _Graph({1: stage}, job_id="live-synth")
    doc = LiveDoctor()
    doc.scan(_stub_server([g]))
    assert doc.alerts_active() == 1 and doc.active_findings()[0]["rule"] == "straggler"
    assert [e["kind"] for e in journal.job_timeline("live-synth")] == ["alert.raised"]
    doc.scan(_stub_server([g]))
    assert len(journal.job_timeline("live-synth")) == 1  # deduped
    stage.task_infos[2] = _Task("success")
    for _ in range(CLEAR_AFTER):
        assert doc.alerts_active() == 1
        doc.scan(_stub_server([g]))
    assert doc.alerts_active() == 0
    assert [e["kind"] for e in journal.job_timeline("live-synth")] == \
        ["alert.raised", "alert.cleared"]


def test_journal_drops_standing_alert():
    journal.configure(capacity=8)
    doc = LiveDoctor()
    doc.scan(_stub_server())
    assert doc.alerts_active() == 0
    for i in range(50):
        journal.emit("ev", i=i)
    assert journal.counters()[1] > 0
    doc.scan(_stub_server())
    f = doc.active_findings()[0]
    assert doc.alerts_active() == 1 and f["rule"] == "journal-drops" and f["job_id"] == ""
    assert "ballista.journal.capacity" in f["remedy"]
    journal.reset()
    doc.scan(_stub_server())
    assert doc.alerts_active() == 0


# --- watch subscriptions and streams -------------------------------------

def test_watch_subscriptions_order_filter_overflow_and_detach():
    with journal.subscribe(job_id="j1") as sub:
        for i in range(10):
            journal.emit("task.launch", job_id="j1", partition=i)
        journal.emit("other", job_id="j2")
        got = sub.drain()
    assert [e["attrs"]["partition"] for e in got] == list(range(10))
    with journal.subscribe(job_id="j1", capacity=4) as sub:
        for i in range(20):
            journal.emit("ev", job_id="j1", i=i)
        got = sub.poll(timeout=0)
    assert got[0]["kind"] == "watch.gap" and got[0]["seq"] == 0
    assert got[0]["attrs"]["dropped"] == 16
    assert [e["attrs"]["i"] for e in got[1:]] == [16, 17, 18, 19]
    assert journal.watcher_count() == 0
    sub2 = journal.subscribe()
    journal.reset()
    assert sub2.closed and journal.watcher_count() == 0


def _assert_watch_frames(frames):
    assert frames and frames[-1]["t"] == "end"
    assert sum(1 for f in frames if f["t"] == "end") == 1
    seqs = [f["event"]["seq"] for f in frames
            if f["t"] == "event" and f["event"]["kind"] != "watch.gap"]
    assert len(seqs) == len(set(seqs)), "no event shown twice"
    fracs = [f["progress"]["fraction"] for f in frames if f["t"] == "progress"]
    assert fracs and all(a <= b for a, b in zip(fracs, fracs[1:])), fracs
    return frames[-1]


def test_standalone_watch_stream_end_to_end():
    ctx = _standalone()
    try:
        ctx.register_table("t", _table(np.random.default_rng(5), 4000))
        ctx.sql(SQL).to_pandas()
        frames = list(ctx.watch())
        end = _assert_watch_frames(frames)
        assert end["state"] == "successful" and not end["error"]
        assert "job.submitted" in {f["event"]["kind"] for f in frames if f["t"] == "event"}
        assert journal.watcher_count() == 0
    finally:
        ctx.shutdown()


def test_standalone_watch_live_during_run():
    ctx = _standalone({"ballista.live.watch.poll.seconds": "0.05"}, concurrent_tasks=1,
                      num_executors=1)
    try:
        ctx.register_table("t", _table(np.random.default_rng(7), 4000))
        plan = faults.FaultPlan.from_obj({"seed": 3, "rules": [{
            "site": "executor.task.slow", "action": "delay", "delay_ms": 150,
            "times": -1}]})
        frames, errs = [], []

        def run():
            try:
                ctx.sql(SQL).to_pandas()
            except Exception as e:  # noqa: BLE001 — asserted below
                errs.append(e)

        with faults.use_plan(plan):
            q = threading.Thread(target=run, daemon=True)
            q.start()
            _wait_for(lambda: ctx._standalone.last_job_id is not None, 10.0, "submitted")
            frames.extend(ctx.watch(ctx._standalone.last_job_id, timeout=60.0))
            q.join(timeout=30.0)
        assert not errs, errs
        assert _assert_watch_frames(frames)["state"] == "successful"
        fracs = [f["progress"]["fraction"] for f in frames if f["t"] == "progress"]
        assert fracs[0] < 1.0, "a progress frame came while the job ran"
    finally:
        ctx.shutdown()
