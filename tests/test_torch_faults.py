"""The port's fault injection (arrow_ballista_tpu_torch/faults) against the
JAX package's (arrow_ballista_tpu/faults), and its failpoints in the port.

- The same plan and seed fire the same schedule in both packages over the
  same hit sequence (k-th hit, fire budgets, seeded probabilities, context
  matches, raise kinds), and each firing is journaled as ``fault.fired``
  with the same attributes.
- The counterparts of tests/test_memory.py's failpoint cases: the
  ``executor.memory.reserve`` failpoint denies an unlimited pool and
  filters on the operator, and ``executor.spill.write`` corrupts a run
  after its CRC so the read-back check catches it.
- ``scheduler.aqe.before_rewrite`` abandons a rewrite (``drop`` and
  ``raise``) with the graph unmutated and the rows unchanged.
- ``executor.task.before_run`` (a retried IO error and the kill action)
  and ``executor.task.cancel.checkpoint``, and the config key
  ``ballista.faults.plan`` arming a standalone session and a local one.
"""
import json

import numpy as np
import pyarrow as pa
import pytest
import torch

import arrow_ballista_tpu.faults as jfaults
import arrow_ballista_tpu.obs.journal as jjournal
import arrow_ballista_tpu_torch as tab
import arrow_ballista_tpu_torch.faults as tfaults
import arrow_ballista_tpu_torch.obs.journal as tjournal
from arrow_ballista_tpu_torch.memory import STATS, MemoryGovernor
from arrow_ballista_tpu_torch.memory.spill import Spiller
from arrow_ballista_tpu_torch.models.schema import INT64, Field, Schema
from arrow_ballista_tpu_torch.utils.errors import IntegrityError
from tests.torch_cases import assert_frames_equal

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _clean():
    """Plans, journals and memory counters are process-global in each
    package: every test starts and ends with none of them."""
    for f, j in ((jfaults, jjournal), (tfaults, tjournal)):
        f.clear()
        j.reset()
        j.set_enabled(False)
    STATS.reset()
    yield
    for f, j in ((jfaults, jjournal), (tfaults, tjournal)):
        f.clear()
        j.reset()
        j.set_enabled(False)
    STATS.reset()


PLANS = {
    "kth_hit_and_budget": {"seed": 7, "rules": [
        {"site": "executor.task.before_run", "action": "raise", "error": "io",
         "on_hit": 2, "times": 2},
        {"site": "executor.spill.write", "action": "corrupt", "times": -1}]},
    "seeded_probability": {"seed": 42, "rules": [
        {"site": "executor.memory.reserve", "action": "raise", "error": "resource",
         "p": 0.35, "times": -1},
        {"site": "executor.task.slow", "action": "delay", "delay_ms": 0, "p": 0.5,
         "times": -1}]},
    "context_match": {"seed": 3, "rules": [
        {"site": "executor.task.before_run", "action": "raise", "error": "execution",
         "match": {"executor_id": "e1", "stage_id": 2}, "times": -1},
        {"site": "scheduler.aqe.before_rewrite", "action": "drop", "times": 3},
        {"site": "executor.task.before_run", "action": "raise", "error": "timeout",
         "match": {"stage_id": "3"}}]},
}

_HITS = ([("executor.task.before_run", {"executor_id": f"e{i % 3}", "stage_id": i % 4,
                                        "job_id": "j1"}) for i in range(12)]
         + [("executor.memory.reserve", {"op": "agg", "nbytes": i}) for i in range(20)]
         + [("executor.task.slow", {"stage_id": 1, "job_id": "j1"}) for _ in range(10)]
         + [("executor.spill.write", {"path": f"run-{i}"}) for i in range(3)]
         + [("scheduler.aqe.before_rewrite", {"job_id": "j1", "stage_id": 2})] * 5)


def _drive(faults, journal, plan_obj):
    journal.set_enabled(True)
    plan = faults.FaultPlan.from_obj(plan_obj)
    outcomes = []
    with faults.use_plan(plan):
        for site, ctx in _HITS:
            try:
                rule = faults.inject(site, **ctx)
                outcomes.append(None if rule is None else rule.action)
            except Exception as e:  # noqa: BLE001 — the injected kinds are compared
                outcomes.append(type(e).__name__)
    fired = [{k: v for k, v in e.items() if k not in ("seq", "ts_ms", "parent", "actor")}
             for e in journal.snapshot() if e["kind"] == "fault.fired"]
    return plan.schedule(), outcomes, [(r.hits, r.fired) for r in plan.rules], fired


@pytest.mark.parametrize("name", sorted(PLANS))
def test_same_plan_and_seed_fire_the_same_schedule(name):
    ref = _drive(jfaults, jjournal, PLANS[name])
    port = _drive(tfaults, tjournal, PLANS[name])
    assert port == ref
    assert port[0], "the plan fired"
    assert len(port[3]) == len(port[0]), "every firing journaled as fault.fired"


def test_unknown_sites_actions_and_fields_are_refused_alike():
    for bad in ({"site": "no.such.site", "action": "raise"},
                {"site": "executor.task.slow", "action": "explode"},
                {"site": "executor.task.slow", "action": "delay", "when": 1}):
        msgs = []
        for faults in (jfaults, tfaults):
            with pytest.raises(ValueError) as exc:
                faults.FaultRule.from_obj(bad)
            msgs.append(str(exc.value))
        assert msgs[0] == msgs[1]
    assert tfaults.KNOWN_SITES == jfaults.KNOWN_SITES
    assert tfaults.corrupt_bytes(b"abcdefgh" * 40) == jfaults.corrupt_bytes(b"abcdefgh" * 40)


# --- tests/test_memory.py's failpoint cases ------------------------------

def test_reserve_failpoint_denies_an_unlimited_pool():
    """error=resource at the failpoint IS a governor denial: the operator
    takes its spill path with no budget configured."""
    gov = MemoryGovernor()  # unlimited
    plan = tfaults.FaultPlan.from_obj({"seed": 5, "rules": [{
        "site": "executor.memory.reserve", "action": "raise", "error": "resource",
        "times": 1}]})
    with tfaults.use_plan(plan):
        assert gov.try_reserve(1024, site="agg-state") is None
        assert gov.try_reserve(1024, site="agg-state") is not None
    assert plan.schedule() == (("executor.memory.reserve", 0, 1, "raise"),)
    assert STATS.snapshot()["reserve_denied_total"] == 1
    assert gov.reserved() == 1024, "the denied attempt reserved nothing"


def test_reserve_failpoint_match_filters_on_op():
    plan = tfaults.FaultPlan.from_obj({"seed": 5, "rules": [{
        "site": "executor.memory.reserve", "action": "raise", "error": "resource",
        "times": -1, "match": {"op": "join-build"}}]})
    gov = MemoryGovernor()
    with tfaults.use_plan(plan):
        assert gov.try_reserve(10, site="agg-state") is not None
        assert gov.try_reserve(10, site="join-build") is None


def test_spill_write_failpoint_corrupts_after_crc(tmp_path):
    plan = tfaults.FaultPlan.from_obj({"seed": 3, "rules": [{
        "site": "executor.spill.write", "action": "corrupt", "times": 1}]})
    sp = Spiller(str(tmp_path), job_id="j1", tag="agg")
    schema = Schema([Field("g", INT64), Field("v", INT64)])
    with tfaults.use_plan(plan):
        sp.write_run(schema, {"g": np.arange(50, dtype=np.int64),
                              "v": np.arange(50, dtype=np.int64)}, {})
    assert plan.schedule() == (("executor.spill.write", 0, 1, "corrupt"),)
    with pytest.raises(IntegrityError):
        sp.read(schema, device="cpu")


# --- the port's control-plane failpoints ---------------------------------

SQL = "select g, sum(v) as s, count(*) as n from t group by g order by g"


def _table():
    rng = np.random.default_rng(11)
    n = 20_000
    return pa.table({"g": pa.array(rng.integers(0, 7, n).astype(np.int64)),
                     "v": pa.array(rng.integers(0, 100, n).astype(np.int64))})


def _standalone(extra=None):
    conf = {"ballista.shuffle.partitions": "8", "ballista.journal.enabled": "true",
            "ballista.aqe.coalesce.target.rows": "100000"}
    conf.update(extra or {})
    ctx = tab.BallistaContext.standalone(tab.BallistaConfig(conf), concurrent_tasks=2,
                                         device="cpu")
    ctx.register_table("t", _table())
    return ctx


def _graph(ctx):
    return ctx._standalone.scheduler.jobs.get_graph(ctx._standalone.last_job_id)


def _reference_rows():
    """SQL's rows through the JAX package's standalone engine."""
    import arrow_ballista_tpu as jab

    ctx = jab.BallistaContext.standalone(jab.BallistaConfig({
        "ballista.shuffle.partitions": "8",
        "ballista.aqe.coalesce.target.rows": "100000"}), concurrent_tasks=2)
    try:
        ctx.register_table("t", _table())
        return ctx.sql(SQL).to_pandas()
    finally:
        ctx.shutdown()


@pytest.mark.parametrize("action", ["drop", "raise"])
def test_aqe_failpoint_abandons_the_rewrite_with_unchanged_rows(action):
    want = _reference_rows()
    ctx = _standalone()
    try:
        base = ctx.sql(SQL).to_pandas()
        assert _graph(ctx).aqe_log, "without a plan the coalesce rewrite applies"
        plan = tfaults.FaultPlan.from_obj({"seed": 1, "rules": [{
            "site": "scheduler.aqe.before_rewrite", "action": action, "times": -1}]})
        with tfaults.use_plan(plan):
            got = ctx.sql(SQL).to_pandas()
        graph = _graph(ctx)
        assert graph.aqe_log == [] and all(not s.aqe_rewrites for s in graph.stages.values())
        assert plan.schedule() and all(e[0] == "scheduler.aqe.before_rewrite"
                                       for e in plan.schedule())
        fired = [e for e in tjournal.job_timeline(graph.job_id) if e["kind"] == "fault.fired"]
        assert fired and fired[0]["attrs"]["site"] == "scheduler.aqe.before_rewrite"
        assert_frames_equal(got, base)
        assert_frames_equal(got, want)
    finally:
        ctx.shutdown()


def test_faults_plan_key_arms_a_standalone_session_and_retries_an_injected_io_error():
    plan = {"seed": 2, "rules": [{"site": "executor.task.before_run", "action": "raise",
                                  "error": "io", "match": {"stage_id": 1, "partition": 0},
                                  "times": 1}]}
    ctx = _standalone({"ballista.faults.plan": json.dumps(plan)})
    try:
        installed = tfaults.active()
        assert installed is not None and installed.seed == 2
        got = ctx.sql(SQL).to_pandas()
        assert installed.schedule() == (("executor.task.before_run", 0, 1, "raise"),)
        kinds = [e["kind"] for e in tjournal.job_timeline(ctx._standalone.last_job_id)]
        assert "fault.fired" in kinds and kinds[-1] == "job.successful"
        assert ctx.sql("show ballista.faults.plan").to_pandas()["value"].tolist() == [
            json.dumps(plan)]
    finally:
        ctx.shutdown()
    local = tab.BallistaContext.local(tab.BallistaConfig(), device="cpu")
    local.register_table("t", _table())
    assert_frames_equal(got, local.sql(SQL).to_pandas())


def test_faults_plan_key_arms_a_local_session():
    """A denial injected at every reservation sends the local engine's
    aggregate down its spill path, with the same rows."""
    plan = {"seed": 9, "rules": [{"site": "executor.memory.reserve", "action": "raise",
                                  "error": "resource", "times": -1}]}
    plain = tab.BallistaContext.local(tab.BallistaConfig(), device="cpu")
    plain.register_table("t", _table())
    want = plain.sql(SQL).to_pandas()
    ctx = tab.BallistaContext.local(tab.BallistaConfig({
        "ballista.faults.plan": json.dumps(plan),
        "ballista.memory.host.budget.bytes": str(1 << 30)}), device="cpu")
    ctx.register_table("t", _table())
    got = ctx.sql(SQL).to_pandas()
    assert tfaults.active() is not None and tfaults.active().schedule()
    assert STATS.snapshot().get("spill_runs_total", 0) > 0
    assert_frames_equal(got, want)


def test_kill_action_unwinds_the_task_as_killed():
    from arrow_ballista_tpu_torch.executor.executor import Executor
    from arrow_ballista_tpu_torch.scheduler.types import (ExecutorMetadata, TaskDescription,
                                                          TaskId)

    ex = Executor(ExecutorMetadata("e0"), "/nonexistent", concurrent_tasks=1, device="cpu")
    try:
        plan = tfaults.FaultPlan.from_obj({"seed": 1, "rules": [{
            "site": "executor.task.before_run", "action": "kill"}]})
        tjournal.set_enabled(True)
        with tfaults.use_plan(plan):
            st = ex.run_task(TaskDescription(TaskId("j9", 1, 0), plan=None))
        assert st.state == "killed"
        assert [e["kind"] for e in st.journal] == ["task.run", "fault.fired"]
        assert st.journal[1]["attrs"]["action"] == "kill"
    finally:
        ex.shutdown()


def test_cancel_checkpoint_failpoint_fires_only_once_a_cancel_landed():
    from arrow_ballista_tpu_torch.ops.physical import TaskContext
    from arrow_ballista_tpu_torch.utils.errors import CancelledError

    plan = tfaults.FaultPlan.from_obj({"seed": 1, "rules": [{
        "site": "executor.task.cancel.checkpoint", "action": "delay", "delay_ms": 1,
        "times": -1}]})
    flag = []
    ctx = TaskContext(device=torch.device("cpu"), job_id="j5", stage_id=3,
                      cancelled=lambda: bool(flag))
    with tfaults.use_plan(plan):
        ctx.check_cancelled()
        assert plan.schedule() == ()
        flag.append(1)
        with pytest.raises(CancelledError):
            ctx.check_cancelled()
    assert plan.schedule() == (("executor.task.cancel.checkpoint", 0, 1, "delay"),)


@pytest.fixture(scope="module")
def remote_q3(tmp_path_factory):
    """A port cluster of two executors that exchange every shuffle
    partition through the wire (host match off), a session with q3's
    tables, and q3's rows without faults."""
    from benchmarks.datagen import generate_tables
    from benchmarks.queries import QUERIES
    from tests.torch_cases import remote_cluster, remote_context

    work = str(tmp_path_factory.mktemp("remote_faults"))
    tables = generate_tables(0.01, seed=0)
    with remote_cluster("torch", work,
                        executor_settings={"ballista.shuffle.local.host_match": "false"}) \
            as (sched, _exs):
        ctx = remote_context("torch", sched)
        for name in ("lineitem", "orders", "customer"):
            ctx.register_table(name, tables[name])
        want = ctx.sql(QUERIES[3]).to_pandas()
        yield ctx, QUERIES[3], want
        ctx.shutdown()


@pytest.mark.parametrize("site, action, match", [
    # a lost launch: the scheduler's retrying client sends it again
    ("rpc.client.send", "drop", {"method": "launch_multi_task"}),
    # a corrupt shuffle chunk: its CRC fails and the fetch resumes at it
    ("shuffle.fetch.recv", "corrupt", {}),
])
def test_remote_q3_survives_a_fault_bit_for_bit(remote_q3, site, action, match):
    ctx, sql, want = remote_q3
    tjournal.set_enabled(True)
    plan = tfaults.FaultPlan.from_obj({"seed": 17, "rules": [
        {"site": site, "action": action, "times": 1, "match": match}]})
    with tfaults.use_plan(plan):
        got = ctx.sql(sql).to_pandas()
    assert [(s, a) for s, _i, _h, a in plan.schedule()] == [(site, action)]
    assert_frames_equal(got, want, exact=True)
    fired = [e for e in tjournal.snapshot() if e["kind"] == "fault.fired"]
    assert [(e["attrs"]["site"], e["attrs"]["action"]) for e in fired] == [(site, action)]
