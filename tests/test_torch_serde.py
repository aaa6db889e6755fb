"""The port's wire serde (serde.py) against the JAX package's, and over
every stage plan the port's scheduler ships.

The counterparts of tests/test_serde_wire.py: every registered wire type
round-trips stably through JSON, value types decode equal, and for the
message types both packages carry (task ids and descriptions, task
statuses, failure reasons, shuffle writes, partition locations, executor
metadata, heartbeats and reservations, job status, journal events) the
port's dict equals the reference's for the same field values.

Then every stage plan of the 22 TPC-H queries at SF0.01, as the port's
standalone engine ran it (after stage split, AQE and whole-stage fusion),
round-trips (``plan_to_obj(plan_from_obj(o)) == o``); the deserialized
stage, executed partition by partition over the original job's shuffle
inputs, writes the same files as the original; and a fused stage
regenerates the same source (same hash, so an executor builds nothing
new).
"""
import json

import numpy as np
import pyarrow as pa
import pyarrow.ipc as ipc
import pytest
import torch

import arrow_ballista_tpu.serde as JS
import arrow_ballista_tpu_torch as tab
from arrow_ballista_tpu.obs.journal import JournalEvent as JJournalEvent
from arrow_ballista_tpu.obs.tracing import Span as JSpan
from arrow_ballista_tpu.ops import shuffle as JSH
from arrow_ballista_tpu.scheduler import types as JT
from arrow_ballista_tpu_torch import serde as TS
from arrow_ballista_tpu_torch.models import expr as E
from arrow_ballista_tpu_torch.models.schema import INT64, DataType, Field, Schema
from arrow_ballista_tpu_torch.obs.journal import JournalEvent
from arrow_ballista_tpu_torch.obs.tracing import Span
from arrow_ballista_tpu_torch.ops.physical import MemoryScanExec, Partitioning, TaskContext
from arrow_ballista_tpu_torch.ops.shuffle import (PartitionLocation, ShuffleWritePartition,
                                                  ShuffleWriterExec)
from arrow_ballista_tpu_torch.scheduler.types import (EXECUTION_ERROR, FETCH_PARTITION_ERROR,
                                                      ExecutorHeartbeat, ExecutorMetadata,
                                                      ExecutorReservation, FailedReason,
                                                      JobStatus, TaskDescription, TaskId,
                                                      TaskStatus)
from benchmarks.queries import QUERIES

torch.set_num_threads(1)
SCHEMA = Schema([Field("k", INT64), Field("v", INT64)])


def _plan():
    table = pa.table({"k": pa.array(np.arange(8, dtype=np.int64)),
                      "v": pa.array(np.arange(8, dtype=np.int64))})
    return ShuffleWriterExec(MemoryScanExec(SCHEMA, table, partitions=2),
                             Partitioning.hash([E.Column("k")], 4), stage_id=3)


LOCATION = dict(executor_id="exec-1", map_partition=2, output_partition=5,
                path="/tmp/shuffle/data-5.arrow", num_rows=100, num_bytes=4096,
                host="10.0.0.2", port=50051)
TRACE = {"trace_id": "t" * 32, "span_id": "s" * 16}


def _samples(pkg):
    """Representative payloads of every wire type, built with ``pkg``'s
    dataclasses ('torch' or 'jax') from the same field values."""
    T = JT if pkg == "jax" else None
    if pkg == "jax":
        TaskId_, TD, TSt, FR, SWP, PL, EM, EH, ER, JSt = (
            T.TaskId, T.TaskDescription, T.TaskStatus, T.FailedReason, JSH.ShuffleWritePartition,
            JSH.PartitionLocation, T.ExecutorMetadata, T.ExecutorHeartbeat,
            T.ExecutorReservation, T.JobStatus)
        Span_, JE = JSpan, JJournalEvent
    else:
        TaskId_, TD, TSt, FR, SWP, PL, EM, EH, ER, JSt = (
            TaskId, TaskDescription, TaskStatus, FailedReason, ShuffleWritePartition,
            PartitionLocation, ExecutorMetadata, ExecutorHeartbeat, ExecutorReservation,
            JobStatus)
        Span_, JE = Span, JournalEvent
    loc = PL(**LOCATION)
    return {
        "TaskId": [TaskId_("job-1", 2, 7), TaskId_("job-1", 2, 7, task_attempt=3,
                                                   stage_attempt=1)],
        "TaskDescription": [(TaskId_("job-1", 3, 1), 42, {"sq0": 12.5}, TRACE)],
        "TaskStatus": [
            TSt(TaskId_("job-1", 1, 0), "exec-1", "success"),
            TSt(TaskId_("job-1", 1, 1), "exec-2", "failed",
                shuffle_writes=[SWP(0, "/tmp/d0", 5, 64)],
                failure=FR(FETCH_PARTITION_ERROR, "gone", map_stage_id=1,
                           map_partition_id=4, executor_id="exec-3"),
                launch_time_ms=1, start_time_ms=2, end_time_ms=3,
                metrics={"0:ScanExec": {"output_rows": 8}}, process_id="pid-1",
                spans=[Span_("task", trace_id="t" * 32, span_id="s" * 16, kind="executor",
                             start_ms=1.0, end_ms=2.0)]),
            TSt(TaskId_("job-1", 1, 2), "exec-1", "success",
                device_stats={"launches.hash64": 3, "kernel_ms": 0.5, "h2d_bytes": 17408},
                journal=[{"seq": 3, "ts_ms": 1700000000789, "kind": "task.run",
                          "actor": "exec-1", "job_id": "job-1",
                          "attrs": {"stage_id": 4, "partition": 0}}]),
        ],
        "FailedReason": [FR(EXECUTION_ERROR, "boom"),
                         FR(FETCH_PARTITION_ERROR, "lost", map_stage_id=2, map_partition_id=9,
                            executor_id="exec-9")],
        "ShuffleWritePartition": [SWP(3, "/tmp/shuffle/data-3.arrow", 128, 8192),
                                  SWP(4, "/tmp/shuffle/data-4.arrow", 128, 8192,
                                      checksum=0xDEADBEEF)],
        "PartitionLocation": [PL("exec-1", 0, 1, "/tmp/p"),
                              PL("exec-1", 1, 3, "/tmp/p3", num_rows=9, num_bytes=512,
                                 host="10.0.0.3", port=50051, checksum=0x1234,
                                 grpc_port=50052, format="arrow_file"), loc],
        "ExecutorMetadata": [EM("exec-1"), EM("exec-2", host="10.0.0.9", port=7000,
                                              grpc_port=7001, task_slots=8)],
        "ExecutorHeartbeat": [EH("exec-1", timestamp=123.5),
                              EH("exec-2", timestamp=124.0, status="terminating",
                                 metadata=EM("exec-2", port=7000)),
                              EH("exec-3", timestamp=125.0, memory_pressure=0.7,
                                 running=[("job-1", 1, 0, 0)])],
        "ExecutorReservation": [ER("exec-1"), ER("exec-2", job_id="job-9")],
        "JobStatus": [JSt("job-1", "running"),
                      JSt("job-2", "failed", error="shed", retriable=True),
                      JSt("job-3", "successful", locations={0: [loc], 3: [loc, loc]})],
        "JournalEvent": [JE(seq=1, ts_ms=1700000000123, kind="job.submitted"),
                         JE(seq=9, ts_ms=1700000000456, kind="task.finish",
                            actor="scheduler-a1b2", job_id="job-1", epoch=3, parent=4,
                            attrs={"stage_id": 2, "partition": 0, "state": "success"})],
    }


def _wire_types(serde_mod):
    return {t.__name__: pair for t, pair in serde_mod.WIRE_TYPES.items()}


def test_every_wire_type_has_samples():
    names = set(_wire_types(TS))
    assert names == set(_samples("torch")), names ^ set(_samples("torch"))
    # the reference's registry, less the fleet's job lease (item 12 C)
    assert names == set(_wire_types(JS)) - {"JobLease"}


@pytest.mark.parametrize("name", sorted(_samples("torch")))
def test_round_trip_stability_and_json_safety(name):
    to_obj, from_obj = _wire_types(TS)[name]
    for sample in _samples("torch")[name]:
        if name == "TaskDescription":
            tid, internal, scalars, trace = sample
            sample = TaskDescription(tid, _plan(), task_internal_id=internal, scalars=scalars,
                                     trace=trace)
        encoded = to_obj(sample)
        decoded = from_obj(json.loads(json.dumps(encoded)))
        assert type(decoded).__name__ == name
        assert to_obj(decoded) == encoded


@pytest.mark.parametrize("name", ["TaskId", "FailedReason", "ShuffleWritePartition",
                                  "PartitionLocation", "ExecutorMetadata",
                                  "ExecutorReservation"])
def test_decoded_fields_match_for_value_types(name):
    to_obj, from_obj = _wire_types(TS)[name]
    for sample in _samples("torch")[name]:
        assert from_obj(json.loads(json.dumps(to_obj(sample)))) == sample


@pytest.mark.parametrize("name", ["TaskId", "TaskStatus", "FailedReason",
                                  "ShuffleWritePartition", "PartitionLocation",
                                  "ExecutorMetadata", "ExecutorHeartbeat", "ExecutorReservation",
                                  "JobStatus", "JournalEvent"])
def test_the_ports_dicts_equal_the_references(name):
    """The same field values encode to the same dict in both packages, so
    the two engines' processes could read each other's control plane."""
    t_to, t_from = _wire_types(TS)[name]
    j_to, _ = _wire_types(JS)[name]
    for t_sample, j_sample in zip(_samples("torch")[name], _samples("jax")[name]):
        assert t_to(t_sample) == j_to(j_sample)
        # and the port decodes the reference's encoding to the same dict
        assert t_to(t_from(json.loads(json.dumps(j_to(j_sample))))) == j_to(j_sample)


def test_task_envelope_equals_the_references():
    """A task's envelope (everything but its plan) encodes as the
    reference's does."""
    from arrow_ballista_tpu.models import expr as JE
    from arrow_ballista_tpu.models.schema import INT64 as JINT64
    from arrow_ballista_tpu.models.schema import Field as JField
    from arrow_ballista_tpu.models.schema import Schema as JSchema
    from arrow_ballista_tpu.ops.physical import MemoryScanExec as JMemoryScanExec
    from arrow_ballista_tpu.ops.physical import Partitioning as JPartitioning

    (tid, internal, scalars, trace), = _samples("torch")["TaskDescription"]
    (jtid, _, _, _), = _samples("jax")["TaskDescription"]
    table = pa.table({"k": pa.array(np.arange(8, dtype=np.int64)),
                      "v": pa.array(np.arange(8, dtype=np.int64))})
    jplan = JSH.ShuffleWriterExec(JMemoryScanExec(JSchema([JField("k", JINT64),
                                                           JField("v", JINT64)]), table, 2),
                                  JPartitioning.hash([JE.Column("k")], 4), stage_id=3)
    got = TS.task_to_obj(TaskDescription(tid, _plan(), task_internal_id=internal,
                                         scalars=scalars, trace=trace))
    want = JS.task_to_obj(JT.TaskDescription(jtid, jplan, internal, scalars, trace=trace))
    assert got == want  # the plan of a memory scan and a hash writer too


def test_job_status_locations_rekeyed_to_int():
    to_obj, from_obj = _wire_types(TS)["JobStatus"]
    decoded = from_obj(json.loads(json.dumps(to_obj(_samples("torch")["JobStatus"][2]))))
    assert set(decoded.locations) == {0, 3}
    assert decoded.locations[3][1] == PartitionLocation(**LOCATION)


def test_optional_keys_stay_off_the_wire():
    """Pressure 0.0, an idle executor's running set, an empty device fold
    and an empty journal add no key, as in the reference."""
    calm = TS.executor_heartbeat_to_obj(ExecutorHeartbeat("e", timestamp=1.0))
    assert "memory_pressure" not in calm and "running" not in calm
    bare = TS.status_to_obj(TaskStatus(TaskId("j", 4, 0), "e", "success"))
    assert "device_stats" not in bare and "journal" not in bare
    assert TS.status_from_obj(bare).device_stats == {}


def test_scalarref_carries_dtype_for_planless_substitution():
    from arrow_ballista_tpu_torch.ops.operators import _substitute_scalars

    dec = Schema([Field("s", DataType("decimal", 2))])

    class _Plan:  # serialization reads only plan.schema
        schema = dec

    ref = E.ScalarSubquery(_Plan())
    object.__setattr__(ref, "scalar_id", "sq7")
    obj = json.loads(json.dumps(TS.expr_to_obj(ref)))
    from arrow_ballista_tpu.models import expr as JE
    from arrow_ballista_tpu.models.schema import DataType as JDataType
    from arrow_ballista_tpu.models.schema import Field as JField
    from arrow_ballista_tpu.models.schema import Schema as JSchema

    class _JPlan:
        schema = JSchema([JField("s", JDataType("decimal", 2))])

    jref = JE.ScalarSubquery(_JPlan())
    object.__setattr__(jref, "scalar_id", "sq7")
    assert obj == JS.expr_to_obj(jref)  # the same tags as the reference's
    decoded = TS.expr_from_obj(obj)
    assert decoded.plan is None and decoded.scalar_dtype == DataType("decimal", 2)
    lit = _substitute_scalars(decoded, {"sq7": 12345})
    assert isinstance(lit, E.Lit) and lit.value == 123.45


# --------------------------------------------------------------------------
# every stage plan of the 22 TPC-H queries
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def standalone():
    from benchmarks.datagen import generate_tables

    ctx = tab.BallistaContext.standalone(
        tab.BallistaConfig({"ballista.shuffle.partitions": "4"}), concurrent_tasks=4,
        device="cpu")
    for name, table in generate_tables(0.01, seed=1).items():
        ctx.register_table(name, table)
    yield ctx
    ctx.shutdown()


FUSED_STAGES = {}  # query -> fused stages regenerated


def _fused(plan):
    if type(plan).__name__ == "FusedStageExec":
        yield plan
    for c in plan.children():
        yield from _fused(c)


def _file_table(path):
    with pa.memory_map(path, "r") as src:
        return ipc.open_file(src).read_all()


@pytest.mark.parametrize("q", sorted(QUERIES))
def test_every_stage_plan_round_trips_and_runs_the_same(standalone, q, tmp_path):
    from arrow_ballista_tpu_torch.ops import _cuda

    standalone.sql(QUERIES[q]).to_pandas()
    sa = standalone._standalone
    graph = sa.scheduler.jobs.get_graph(sa.last_job_id)
    ctx_dev = TaskContext(device=torch.device("cpu"))
    fused = 0
    for sid in sorted(graph.stages):
        stage = graph.stages[sid]
        plan = stage.resolved_plan
        obj = json.loads(json.dumps(TS.plan_to_obj(plan)))
        back = TS.plan_from_obj(obj)
        assert TS.plan_to_obj(back) == obj, f"q{q} stage {sid}"
        assert back.schema.names() == plan.schema.names()
        for a, b in zip(_fused(plan), _fused(back)):
            fused += 1
            assert _cuda.generated_path(a.program(ctx_dev).gen.source) == \
                _cuda.generated_path(b.program(ctx_dev).gen.source), f"q{q} stage {sid}"
        # the deserialized stage over the original job's shuffle inputs
        ctx = TaskContext(device=torch.device("cpu"), config=sa.config,
                          scalars=dict(graph.scalars), work_dir=str(tmp_path),
                          job_id=graph.job_id, stage_id=sid, executor_id="executor-0")
        for p, (_eid, writes) in sorted(stage.outputs.items()):
            got = {w.output_partition: w for w in back.execute_write(p, ctx)}
            for w in writes:
                g = got[w.output_partition]
                assert g.num_rows == w.num_rows, f"q{q} stage {sid} partition {p}"
                assert _file_table(g.path).equals(_file_table(w.path)), \
                    f"q{q} stage {sid} partition {p} -> {w.output_partition}"
    FUSED_STAGES[q] = fused


def test_fused_stages_were_regenerated():
    """Runs after the queries (same module, one worker): q1's partial
    aggregate chain at least fused and regenerated the same source."""
    if len(FUSED_STAGES) == len(QUERIES):
        assert FUSED_STAGES[1] and sum(FUSED_STAGES.values()) >= 5, FUSED_STAGES


@pytest.mark.parametrize("q", [3, 18])
def test_the_job_checkpoint_round_trips(standalone, q):
    """``graph_to_obj`` / ``graph_from_obj`` (the job checkpoint the
    fleet's KV and persistence will store) over a finished job: the
    decoded graph encodes to the same dict, its stages keep their states,
    partition counts and outputs, and its final locations are the
    original's."""
    standalone.sql(QUERIES[q]).to_pandas()
    sa = standalone._standalone
    graph = sa.scheduler.jobs.get_graph(sa.last_job_id)
    obj = json.loads(json.dumps(TS.graph_to_obj(graph)))
    back = TS.graph_from_obj(obj)
    assert TS.graph_to_obj(back) == obj
    assert back.status == "successful" and sorted(back.stages) == sorted(graph.stages)
    for sid, st in graph.stages.items():
        b = back.stages[sid]
        assert (b.state, b.partitions, sorted(b.outputs)) == (st.state, st.partitions,
                                                              sorted(st.outputs))
    final = graph.final_stage_id
    assert back.stages[final].output_locations() == graph.stages[final].output_locations()
