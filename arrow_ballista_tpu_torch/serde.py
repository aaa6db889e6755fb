"""Plan, expression and schema serde: the wire contract between processes.

Mirrors arrow_ballista_tpu/serde.py: tagged JSON-safe dicts (stable,
versioned, no pickle across a trust boundary); Arrow IPC bytes ride in
the separate binary frame of net/wire.py, except a memory scan's table,
which travels base64-encoded inside its plan.

Covers DataType/Field/Schema, every Expr node, every physical operator of
the port (the 24 plan-node classes, the mesh nodes and the fused stage),
Partitioning, PartitionLocation, TaskDescription/TaskStatus, the executor
messages, job status, journal events and the execution graph checkpoint
(``graph_to_obj`` / ``graph_from_obj``, for the fleet's KV backends of
ROADMAP.md queue 1 item 12 C).  A serialized plan carries no tensor and no
device state: broadcast build caches, the scan cache, the passthrough
latch and generated libraries are rebuilt on the executor's device from
the plan, and a fused stage regenerates the same source (same hash, so no
second nvcc build).
"""
from __future__ import annotations

import base64
from typing import Optional

from .models import expr as E
from .models.schema import DataType, Field, Schema
from .obs.journal import JournalEvent
from .ops import operators as O
from .ops.mesh_exec import (
    MeshAggregateExec,
    MeshPartialAggregateExec,
    MeshTaskJoinExec,
)
from .ops import physical as P
from .ops import shuffle as SH
from .ops.shuffle import PartitionLocation, ShuffleWritePartition
from .scheduler.types import (
    ExecutorHeartbeat,
    ExecutorMetadata,
    ExecutorReservation,
    FailedReason,
    JobStatus,
    TaskDescription,
    TaskId,
    TaskStatus,
)
from .utils.errors import InternalError

SERDE_VERSION = 1


# --------------------------------------------------------------------------
# schema
# --------------------------------------------------------------------------

def dtype_to_obj(t: DataType) -> dict:
    return {"kind": t.kind, "scale": t.scale}


def dtype_from_obj(o: dict) -> DataType:
    return DataType(o["kind"], o.get("scale", 0))


def schema_to_obj(s: Schema) -> list:
    return [{"name": f.name, "dtype": dtype_to_obj(f.dtype),
             "nullable": f.nullable} for f in s]


def schema_from_obj(o: list) -> Schema:
    return Schema(Field(f["name"], dtype_from_obj(f["dtype"]),
                        f.get("nullable", False)) for f in o)


# --------------------------------------------------------------------------
# expressions
# --------------------------------------------------------------------------

def expr_to_obj(e: Optional[E.Expr]):
    if e is None:
        return None
    if isinstance(e, E.Column):
        return {"t": "col", "name": e.name}
    if isinstance(e, E.Lit):
        return {"t": "lit", "v": e.value, "kind": e.kind}
    if isinstance(e, E.BinOp):
        return {"t": "bin", "op": e.op, "l": expr_to_obj(e.left),
                "r": expr_to_obj(e.right)}
    if isinstance(e, E.Not):
        return {"t": "not", "o": expr_to_obj(e.operand)}
    if isinstance(e, E.Negate):
        return {"t": "neg", "o": expr_to_obj(e.operand)}
    if isinstance(e, E.Case):
        return {"t": "case",
                "whens": [[expr_to_obj(c), expr_to_obj(v)] for c, v in e.whens],
                "else": expr_to_obj(e.else_)}
    if isinstance(e, E.Cast):
        return {"t": "cast", "o": expr_to_obj(e.operand), "to": dtype_to_obj(e.to)}
    if isinstance(e, E.InList):
        return {"t": "inlist", "o": expr_to_obj(e.operand), "vs": list(e.values),
                "neg": e.negated}
    if isinstance(e, E.Like):
        return {"t": "like", "o": expr_to_obj(e.operand), "p": e.pattern,
                "neg": e.negated}
    if isinstance(e, E.IsNull):
        return {"t": "isnull", "o": expr_to_obj(e.operand), "neg": e.negated}
    if isinstance(e, E.Extract):
        return {"t": "extract", "f": e.field, "o": expr_to_obj(e.operand)}
    if isinstance(e, E.Substring):
        return {"t": "substr", "o": expr_to_obj(e.operand), "start": e.start,
                "len": e.length}
    if isinstance(e, E.Udf):
        return {"t": "udf", "name": e.name,
                "args": [expr_to_obj(a) for a in e.args]}
    if isinstance(e, E.Agg):
        return {"t": "agg", "f": e.func, "o": expr_to_obj(e.operand),
                "distinct": e.distinct}
    if isinstance(e, E.ScalarSubquery):
        # scalar subqueries are evaluated before tasks ship; only the id
        # reference crosses the wire (values ride in TaskDescription.scalars)
        sid = getattr(e, "scalar_id", None)
        if sid is None:
            raise InternalError("unplanned scalar subquery cannot be serialized")
        # the result dtype must cross too: executors re-scale decimal
        # scaled-int values at substitution time and have no plan to ask
        dt = (e.plan.schema.fields[0].dtype if e.plan is not None
              else getattr(e, "scalar_dtype", None))
        obj = {"t": "scalarref", "id": sid}
        if dt is not None:
            obj["dt"] = dtype_to_obj(dt)
        return obj
    raise InternalError(f"cannot serialize expr {type(e).__name__}")


def expr_from_obj(o) -> Optional[E.Expr]:
    if o is None:
        return None
    t = o["t"]
    if t == "col":
        return E.Column(o["name"])
    if t == "lit":
        return E.Lit(o["v"], o.get("kind", "auto"))
    if t == "bin":
        return E.BinOp(o["op"], expr_from_obj(o["l"]), expr_from_obj(o["r"]))
    if t == "not":
        return E.Not(expr_from_obj(o["o"]))
    if t == "neg":
        return E.Negate(expr_from_obj(o["o"]))
    if t == "case":
        return E.Case([(expr_from_obj(c), expr_from_obj(v)) for c, v in o["whens"]],
                      expr_from_obj(o["else"]))
    if t == "cast":
        return E.Cast(expr_from_obj(o["o"]), dtype_from_obj(o["to"]))
    if t == "inlist":
        return E.InList(expr_from_obj(o["o"]), list(o["vs"]), o["neg"])
    if t == "like":
        return E.Like(expr_from_obj(o["o"]), o["p"], o["neg"])
    if t == "isnull":
        return E.IsNull(expr_from_obj(o["o"]), o["neg"])
    if t == "extract":
        return E.Extract(o["f"], expr_from_obj(o["o"]))
    if t == "substr":
        return E.Substring(expr_from_obj(o["o"]), o["start"], o["len"])
    if t == "udf":
        return E.Udf(o["name"], tuple(expr_from_obj(a) for a in o["args"]))
    if t == "agg":
        return E.Agg(o["f"], expr_from_obj(o["o"]), o.get("distinct", False))
    if t == "scalarref":
        sq = E.ScalarSubquery(None)
        object.__setattr__(sq, "scalar_id", o["id"])
        if o.get("dt") is not None:
            object.__setattr__(sq, "scalar_dtype", dtype_from_obj(o["dt"]))
        return sq
    raise InternalError(f"cannot deserialize expr tag {t!r}")


# --------------------------------------------------------------------------
# partitioning / locations
# --------------------------------------------------------------------------

def partitioning_to_obj(p: Optional[P.Partitioning]):
    if p is None:
        return None
    return {"kind": p.kind, "count": p.count,
            "exprs": [expr_to_obj(e) for e in p.exprs]}


def partitioning_from_obj(o) -> Optional[P.Partitioning]:
    if o is None:
        return None
    return P.Partitioning(o["kind"], o["count"],
                          tuple(expr_from_obj(e) for e in o["exprs"]))


def location_to_obj(l: PartitionLocation) -> dict:
    return dict(vars(l))


def location_from_obj(o: dict) -> PartitionLocation:
    # tolerant across wire versions: unknown keys (from a NEWER peer) are
    # dropped, missing keys (from an OLDER peer) take dataclass defaults —
    # a rolling upgrade must not wedge on shuffle metadata
    import dataclasses as _dc

    known = {f.name for f in _dc.fields(PartitionLocation)}
    return PartitionLocation(**{k: v for k, v in o.items() if k in known})


# --------------------------------------------------------------------------
# physical plans
# --------------------------------------------------------------------------

def plan_to_obj(p: P.ExecutionPlan) -> dict:
    if isinstance(p, P.MemoryScanExec):
        import io

        import pyarrow.ipc as ipc

        buf = io.BytesIO()
        with ipc.new_stream(buf, p.table.schema) as w:
            w.write_table(p.table)
        return {"t": "memscan", "schema": schema_to_obj(p.schema),
                "table_b64": base64.b64encode(buf.getvalue()).decode(),
                "partitions": p.partitions,
                "filters": [expr_to_obj(f) for f in p.filters]}
    if isinstance(p, P.ParquetScanExec):
        return {"t": "parquetscan", "schema": schema_to_obj(p.schema),
                "files": p.files, "partitions": len(p.groups),
                "filters": [expr_to_obj(f) for f in p.filters],
                "table_schema": schema_to_obj(p.table_schema),
                # explicit (file, row-group, rows) grouping: the clustered
                # group-by rewrite regroups partitions CONTIGUOUSLY and its
                # range annotations are only valid for that exact grouping,
                # so the executor must not re-derive a heap-balanced one
                "groups": [[list(u) for u in g] for g in p.groups]}
    if isinstance(p, P.CsvScanExec):
        return {"t": "csvscan", "schema": schema_to_obj(p.schema),
                "files": p.files, "partitions": p.output_partition_count(),
                "filters": [expr_to_obj(f) for f in p.filters],
                "table_schema": schema_to_obj(p.table_schema),
                "delimiter": p.delimiter, "has_header": p.has_header}
    if isinstance(p, P.JsonScanExec):
        return {"t": "jsonscan", "schema": schema_to_obj(p.schema),
                "files": p.files, "partitions": p.output_partition_count(),
                "filters": [expr_to_obj(f) for f in p.filters],
                "table_schema": schema_to_obj(p.table_schema)}
    if isinstance(p, P.AvroScanExec):
        return {"t": "avroscan", "schema": schema_to_obj(p.schema),
                "files": p.files, "partitions": p.output_partition_count(),
                "filters": [expr_to_obj(f) for f in p.filters],
                "table_schema": schema_to_obj(p.table_schema)}
    if isinstance(p, O.ProjectionExec):
        return {"t": "proj", "input": plan_to_obj(p.input),
                "exprs": [[expr_to_obj(e), n] for e, n in p.exprs],
                "host": p.host_mode}
    if isinstance(p, O.RenameExec):
        return {"t": "rename", "input": plan_to_obj(p.input),
                "schema": schema_to_obj(p.schema)}
    if isinstance(p, O.FilterExec):
        return {"t": "filter", "input": plan_to_obj(p.input),
                "pred": expr_to_obj(p.predicate), "host": p.host_mode}
    if isinstance(p, O.HashAggregateExec):
        out = {"t": "agg", "input": plan_to_obj(p.input),
               "groups": [[expr_to_obj(e), n] for e, n in p.group_exprs],
               "aggs": [{"func": a.func, "operand": expr_to_obj(a.operand),
                         "name": a.name} for a in p.aggs],
               "mode": p.mode}
        cl = getattr(p, "clustered", None)
        if cl is not None:  # clustered early-HAVING annotation
            out["clustered"] = {"pred": expr_to_obj(cl[0]),
                                "intervals": [list(iv) for iv in cl[1]]}
            if len(cl) > 2 and cl[2]:
                # declared per-partition key ranges: the runtime stale-
                # stats guard (operators.py) compares observed min/max
                # against these
                out["clustered"]["ranges"] = [list(r) for r in cl[2]]
        return out
    if isinstance(p, O.JoinExec):
        return {"t": "join", "left": plan_to_obj(p.left),
                "right": plan_to_obj(p.right),
                "on": [[expr_to_obj(l), expr_to_obj(r)] for l, r in p.on],
                "jt": p.join_type, "filter": expr_to_obj(p.filter),
                "dist": p.dist}
    if isinstance(p, O.SortExec):
        return {"t": "sort", "input": plan_to_obj(p.input),
                "keys": [[expr_to_obj(e), asc] for e, asc in p.keys],
                "fetch": p.fetch}
    if isinstance(p, O.LimitExec):
        return {"t": "limit", "input": plan_to_obj(p.input), "n": p.n}
    if isinstance(p, O.CoalescePartitionsExec):
        return {"t": "coalesce", "input": plan_to_obj(p.input)}
    if isinstance(p, MeshTaskJoinExec):
        return {"t": "meshtaskjoin", "left": plan_to_obj(p.left),
                "right": plan_to_obj(p.right),
                "on": [[expr_to_obj(l), expr_to_obj(r)] for l, r in p.on],
                "jt": p.join_type}
    if isinstance(p, MeshPartialAggregateExec):
        return {"t": "meshpartial", "input": plan_to_obj(p.input),
                "groups": [[expr_to_obj(e), n] for e, n in p.group_exprs],
                "aggs": [{"func": a.func, "operand": expr_to_obj(a.operand),
                          "name": a.name} for a in p.aggs]}
    if isinstance(p, MeshAggregateExec):
        return {"t": "meshagg", "input": plan_to_obj(p.input),
                "groups": [[expr_to_obj(e), n] for e, n in p.group_exprs],
                "aggs": [{"func": a.func, "operand": expr_to_obj(a.operand),
                          "name": a.name} for a in p.aggs]}
    if isinstance(p, SH.ShuffleWriterExec):
        return {"t": "shufflewrite", "input": plan_to_obj(p.input),
                "partitioning": partitioning_to_obj(p.partitioning),
                "stage_id": p.stage_id}
    if isinstance(p, SH.ShuffleReaderExec):
        out = {"t": "shuffleread", "stage_id": p.stage_id,
               "schema": schema_to_obj(p.schema),
               "partition_count": p.partition_count,
               "locations": {str(k): [location_to_obj(l) for l in v]
                             for k, v in p.locations.items()}}
        # adaptive coalescing/skew rewrites remap the reader; a recovered
        # graph must be able to roll it back to the PLANNED partitioning
        orig = getattr(p, "_orig_partition_count", None)
        if orig is not None:
            out["orig_partition_count"] = orig
        return out
    if isinstance(p, SH.UnresolvedShuffleExec):
        return {"t": "unresolvedshuffle", "stage_id": p.stage_id,
                "schema": schema_to_obj(p.schema),
                "partition_count": p.output_partition_count()}
    if isinstance(p, SH.RepartitionExec):
        return {"t": "repart", "input": plan_to_obj(p.input),
                "partitioning": partitioning_to_obj(p.partitioning)}
    from .compile.fused import FusedStageExec
    if isinstance(p, FusedStageExec):
        # the chain head already encodes the whole chain recursively
        # (ops[i].input is ops[i+1]); "n" says how many linked operators
        # the deserializer re-wraps into the fused node
        return {"t": "fusedstage", "n": len(p.ops), "chain": plan_to_obj(p.ops[0])}
    raise InternalError(f"cannot serialize plan node {type(p).__name__}")


def plan_from_obj(o: dict) -> P.ExecutionPlan:
    t = o["t"]
    if t == "memscan":
        import io

        import pyarrow.ipc as ipc

        table = ipc.open_stream(io.BytesIO(base64.b64decode(o["table_b64"]))).read_all()
        return P.MemoryScanExec(schema_from_obj(o["schema"]), table,
                                o["partitions"],
                                [expr_from_obj(f) for f in o["filters"]])
    if t == "parquetscan":
        scan = P.ParquetScanExec(schema_from_obj(o["schema"]), o["files"],
                                 o["partitions"],
                                 [expr_from_obj(f) for f in o["filters"]],
                                 table_schema=schema_from_obj(o["table_schema"]))
        if o.get("groups"):
            scan.groups = [[tuple(u) for u in g] for g in o["groups"]]
        return scan
    if t == "csvscan":
        return P.CsvScanExec(schema_from_obj(o["schema"]), o["files"],
                             o["partitions"],
                             [expr_from_obj(f) for f in o["filters"]],
                             table_schema=schema_from_obj(o["table_schema"]),
                             delimiter=o["delimiter"], has_header=o["has_header"])
    if t == "jsonscan":
        return P.JsonScanExec(schema_from_obj(o["schema"]), o["files"],
                              o["partitions"],
                              [expr_from_obj(f) for f in o["filters"]],
                              table_schema=schema_from_obj(o["table_schema"]))
    if t == "avroscan":
        return P.AvroScanExec(schema_from_obj(o["schema"]), o["files"],
                              o["partitions"],
                              [expr_from_obj(f) for f in o["filters"]],
                              table_schema=schema_from_obj(o["table_schema"]))
    if t == "proj":
        return O.ProjectionExec(plan_from_obj(o["input"]),
                                [(expr_from_obj(e), n) for e, n in o["exprs"]],
                                host_mode=o["host"])
    if t == "rename":
        return O.RenameExec(plan_from_obj(o["input"]), schema_from_obj(o["schema"]))
    if t == "filter":
        return O.FilterExec(plan_from_obj(o["input"]), expr_from_obj(o["pred"]),
                            host_mode=o.get("host", False))
    if t == "agg":
        agg = O.HashAggregateExec(
            plan_from_obj(o["input"]),
            [(expr_from_obj(e), n) for e, n in o["groups"]],
            [O.AggSpec(a["func"], expr_from_obj(a["operand"]), a["name"])
             for a in o["aggs"]],
            o["mode"])
        if "clustered" in o:
            cl = o["clustered"]
            agg.clustered = (expr_from_obj(cl["pred"]),
                             [tuple(iv) for iv in cl["intervals"]],
                             [tuple(r) for r in cl["ranges"]]
                             if cl.get("ranges") else None)
        return agg
    if t == "join":
        return O.JoinExec(plan_from_obj(o["left"]), plan_from_obj(o["right"]),
                          [(expr_from_obj(l), expr_from_obj(r)) for l, r in o["on"]],
                          o["jt"], expr_from_obj(o["filter"]), o["dist"])
    if t == "sort":
        return O.SortExec(plan_from_obj(o["input"]),
                          [(expr_from_obj(e), asc) for e, asc in o["keys"]],
                          fetch=o["fetch"])
    if t == "limit":
        return O.LimitExec(plan_from_obj(o["input"]), o["n"])
    if t == "coalesce":
        return O.CoalescePartitionsExec(plan_from_obj(o["input"]))
    if t == "meshtaskjoin":
        return MeshTaskJoinExec(
            plan_from_obj(o["left"]), plan_from_obj(o["right"]),
            [(expr_from_obj(l), expr_from_obj(r)) for l, r in o["on"]],
            o["jt"])
    if t == "meshpartial":
        return MeshPartialAggregateExec(
            plan_from_obj(o["input"]),
            [(expr_from_obj(e), n) for e, n in o["groups"]],
            [O.AggSpec(a["func"], expr_from_obj(a["operand"]), a["name"])
             for a in o["aggs"]])
    if t == "meshagg":
        return MeshAggregateExec(
            plan_from_obj(o["input"]),
            [(expr_from_obj(e), n) for e, n in o["groups"]],
            [O.AggSpec(a["func"], expr_from_obj(a["operand"]), a["name"])
             for a in o["aggs"]])
    if t == "shufflewrite":
        return SH.ShuffleWriterExec(plan_from_obj(o["input"]),
                                    partitioning_from_obj(o["partitioning"]),
                                    stage_id=o["stage_id"])
    if t == "shuffleread":
        reader = SH.ShuffleReaderExec(
            o["stage_id"], schema_from_obj(o["schema"]), o["partition_count"],
            {int(k): [location_from_obj(l) for l in v]
             for k, v in o["locations"].items()})
        if o.get("orig_partition_count") is not None:
            reader._orig_partition_count = o["orig_partition_count"]
        return reader
    if t == "unresolvedshuffle":
        return SH.UnresolvedShuffleExec(o["stage_id"], schema_from_obj(o["schema"]),
                                        o["partition_count"])
    if t == "repart":
        return SH.RepartitionExec(plan_from_obj(o["input"]),
                                  partitioning_from_obj(o["partitioning"]))
    if t == "fusedstage":
        from .compile.fused import FusedStageExec

        head = plan_from_obj(o["chain"])
        ops = [head]
        for _ in range(o["n"] - 1):
            ops.append(ops[-1].input)
        return FusedStageExec(ops)
    raise InternalError(f"cannot deserialize plan tag {t!r}")


# --------------------------------------------------------------------------
# execution graph (job checkpoint)
# --------------------------------------------------------------------------

def graph_to_obj(graph) -> dict:
    """Checkpoint an ExecutionGraph, as the reference's ``graph_to_obj``
    does.  Running task slots are not persisted: a recovering scheduler
    re-issues them."""
    stages = []
    for sid in sorted(graph.stages):
        s = graph.stages[sid]
        stages.append({
            "stage_id": sid,
            "plan": plan_to_obj(s.resolved_plan or s.plan),
            "resolved": s.resolved_plan is not None,
            "state": s.state,
            "stage_attempt": s.stage_attempt,
            "failures": s.failures,
            "task_failures": list(s.task_failures),
            # AQE rewrites change the live partition count away from the
            # planner-derived one; a recovered graph must resume with the
            # MUTATED shape, not re-derive the original from the plan
            "partitions": s.partitions,
            "orig_partitions": getattr(s, "_orig_partitions", None),
            "aqe_rewrites": [dict(r) for r in getattr(s, "aqe_rewrites", [])],
            "fusion_rewrites": [dict(r) for r in
                                getattr(s, "fusion_rewrites", [])],
            # retry anti-affinity memory (wire-silent: omitted while empty
            # so statuses for unaffected jobs stay byte-identical)
            **({"failed_on": {str(p): sorted(eids)
                              for p, eids in s.failed_on.items()}}
               if getattr(s, "failed_on", None) else {}),
            "successes": {
                str(p): {"executor_id": ex,
                         "writes": [vars(w) for w in writes]}
                for p, (ex, writes) in s.outputs.items()},
        })
    import dataclasses as _dc
    aqe = getattr(graph, "aqe", None)
    out = {"job_id": graph.job_id, "status": graph.status,
           "error": graph.error, "scalars": dict(graph.scalars),
           "aqe": _dc.asdict(aqe) if aqe is not None else None,
           "aqe_log": [dict(r) for r in getattr(graph, "aqe_log", [])],
           "compile_log": [dict(r) for r in
                           getattr(graph, "compile_log", [])],
           # task-propagation trace context: an adopting shard continues
           # the original trace, so a failed-over job's Chrome trace
           # shows both shards on one timeline (obs/profile.on_adopted)
           "trace": dict(getattr(graph, "trace", {}) or {}),
           "stages": stages}
    # flight-recorder timeline (obs/journal.py): checkpointed so the
    # epoch-tagged causal record survives fleet failover — the adopter
    # seeds its own journal from this and appends under the new epoch.
    # Key present only when events exist (journal-off checkpoints are
    # byte-identical to pre-journal ones)
    journal = getattr(graph, "journal", None)
    if journal:
        out["journal"] = [dict(e) for e in journal]
    # server-side deadline: the ABSOLUTE wall-clock expiry rides the
    # checkpoint so an adopting shard enforces the submitter's original
    # clock, not a restarted one.  Keys present only when a deadline is
    # set (deadline-off checkpoints stay byte-identical to older ones)
    if getattr(graph, "deadline_ts", 0.0):
        out["deadline_ts"] = graph.deadline_ts
        out["deadline_s"] = getattr(graph, "deadline_s", 0.0)
    return out


def graph_from_obj(o: dict):
    from .ops.shuffle import ShuffleWritePartition
    from .scheduler.execution_graph import (
        RUNNING,
        SUCCESSFUL,
        ExecutionGraph,
        TaskInfo,
    )
    from .scheduler.planner import QueryStage, rollback_resolved_shuffles

    qstages = []
    meta = {}
    for st in o["stages"]:
        plan = plan_from_obj(st["plan"])
        if st["resolved"]:
            # the persisted plan may carry resolved readers; the graph
            # constructor expects unresolved leaves for linking
            plan_resolved = plan
            plan = rollback_resolved_shuffles(plan_from_obj(st["plan"]))
        else:
            plan_resolved = None
        qstages.append(QueryStage(st["stage_id"], plan))
        meta[st["stage_id"]] = (st, plan_resolved)
    graph = ExecutionGraph(o["job_id"], qstages)
    graph.status = o["status"]
    graph.error = o.get("error", "")
    graph.scalars = dict(o.get("scalars", {}))
    if o.get("aqe") is not None:
        from .scheduler.aqe import AqePolicy
        graph.aqe = AqePolicy(**o["aqe"])
    graph.aqe_log = [dict(r) for r in o.get("aqe_log", [])]
    graph.compile_log = [dict(r) for r in o.get("compile_log", [])]
    graph.trace = dict(o.get("trace", {}))
    graph.journal = [dict(e) for e in o.get("journal", [])]
    graph.deadline_ts = float(o.get("deadline_ts", 0.0))
    graph.deadline_s = float(o.get("deadline_s", 0.0))
    for sid, (st, plan_resolved) in meta.items():
        stage = graph.stages[sid]
        stage.state = st["state"]
        stage.stage_attempt = st["stage_attempt"]
        stage.failures = st.get("failures", 0)
        stage.task_failures = list(st["task_failures"])
        stage.failed_on = {int(p): set(eids) for p, eids in
                           st.get("failed_on", {}).items()}
        if plan_resolved is not None and stage.state in (RUNNING, SUCCESSFUL):
            stage.resolved_plan = plan_resolved
        # AQE rewrites mutate the live partition count; resume with the
        # checkpointed shape, not the planner-derived one (pre-AQE
        # checkpoints carry neither key and keep the constructor's count)
        if st.get("partitions") is not None:
            stage.partitions = st["partitions"]
        if st.get("orig_partitions") is not None:
            stage._orig_partitions = st["orig_partitions"]
        stage.aqe_rewrites = [dict(r) for r in st.get("aqe_rewrites", [])]
        stage.fusion_rewrites = [dict(r) for r in
                                 st.get("fusion_rewrites", [])]
        stage.task_infos = [None] * stage.partitions
        if len(stage.task_attempts) < stage.partitions:
            stage.task_attempts.extend(
                [0] * (stage.partitions - len(stage.task_attempts)))
        if len(stage.task_failures) < stage.partitions:
            stage.task_failures.extend(
                [0] * (stage.partitions - len(stage.task_failures)))
        for p_str, rec in st["successes"].items():
            p = int(p_str)
            stage.outputs[p] = (rec["executor_id"],
                                [ShuffleWritePartition(**w) for w in rec["writes"]])
            stage.task_infos[p] = TaskInfo(p, rec["executor_id"], "success")
    graph.revive()
    return graph


# --------------------------------------------------------------------------
# task messages
# --------------------------------------------------------------------------

def task_to_obj(td: TaskDescription, plan_obj: dict = None) -> dict:
    """``plan_obj``: pre-encoded plan to reuse (same-stage tasks share one
    plan instance; callers encode it once — see
    netservice.serialize_tasks_or_fail)."""
    return {"task": vars(td.task),
            "plan": plan_obj if plan_obj is not None else plan_to_obj(td.plan),
            "internal_id": td.task_internal_id, "scalars": dict(td.scalars),
            "trace": dict(td.trace)}


def task_from_obj(o: dict) -> TaskDescription:
    return TaskDescription(TaskId(**o["task"]), plan_from_obj(o["plan"]),
                           task_internal_id=o.get("internal_id", 0),
                           scalars=dict(o.get("scalars", {})),
                           trace=dict(o.get("trace", {})))


def status_to_obj(st: TaskStatus) -> dict:
    from .obs.tracing import span_to_obj

    o = {
        "task": vars(st.task), "executor_id": st.executor_id, "state": st.state,
        "writes": [vars(w) for w in st.shuffle_writes],
        "failure": vars(st.failure) if st.failure else None,
        "launch_ms": st.launch_time_ms, "start_ms": st.start_time_ms,
        "end_ms": st.end_time_ms, "metrics": st.metrics,
        "process_id": st.process_id,
        "spans": [span_to_obj(s) for s in (st.spans or [])],
    }
    # only when the device observatory recorded something: disabled mode
    # must stay byte-identical on the wire (test_serde_wire.py)
    if st.device_stats:
        o["device_stats"] = st.device_stats
    # same contract for the flight recorder: executor journal events ride
    # piggyback only when the journal recorded something
    if st.journal:
        o["journal"] = st.journal
    return o


def status_from_obj(o: dict) -> TaskStatus:
    from .obs.tracing import span_from_obj

    return TaskStatus(
        TaskId(**o["task"]), o["executor_id"], o["state"],
        [ShuffleWritePartition(**w) for w in o["writes"]],
        FailedReason(**o["failure"]) if o.get("failure") else None,
        o.get("launch_ms", 0), o.get("start_ms", 0), o.get("end_ms", 0),
        o.get("metrics", {}), process_id=o.get("process_id", ""),
        spans=[span_from_obj(s) for s in o.get("spans", [])],
        device_stats=dict(o.get("device_stats", {})),
        journal=[dict(e) for e in o.get("journal", [])])


# --------------------------------------------------------------------------
# wire-type registry
# --------------------------------------------------------------------------

def taskid_to_obj(t: TaskId) -> dict:
    return vars(t)


def taskid_from_obj(o: dict) -> TaskId:
    return TaskId(**o)


def failed_reason_to_obj(r: FailedReason) -> dict:
    return vars(r)


def failed_reason_from_obj(o: dict) -> FailedReason:
    return FailedReason(**o)


def shuffle_write_to_obj(w: ShuffleWritePartition) -> dict:
    return vars(w)


def shuffle_write_from_obj(o: dict) -> ShuffleWritePartition:
    return ShuffleWritePartition(**o)


def executor_metadata_to_obj(m: ExecutorMetadata) -> dict:
    return vars(m)


def executor_metadata_from_obj(o: dict) -> ExecutorMetadata:
    return ExecutorMetadata(**o)


def executor_heartbeat_to_obj(h: ExecutorHeartbeat) -> dict:
    out = {"executor_id": h.executor_id, "timestamp": h.timestamp,
           "status": h.status,
           "metadata": (executor_metadata_to_obj(h.metadata)
                        if h.metadata is not None else None)}
    # pressure 0.0 (the unbudgeted default) omits the key — old-wire
    # peers and idle fleets pay nothing
    if h.memory_pressure:
        out["memory_pressure"] = h.memory_pressure
    # running-task set (zombie reconciliation): an idle executor omits the
    # key, keeping the quiescent heartbeat byte-identical to the old wire
    if h.running:
        out["running"] = [list(t) for t in h.running]
    return out


def executor_heartbeat_from_obj(o: dict) -> ExecutorHeartbeat:
    meta = o.get("metadata")
    return ExecutorHeartbeat(
        o["executor_id"], o.get("timestamp", 0.0), o.get("status", "active"),
        executor_metadata_from_obj(meta) if meta else None,
        memory_pressure=float(o.get("memory_pressure", 0.0)),
        running=[tuple(t) for t in o.get("running", [])])


def executor_reservation_to_obj(r: ExecutorReservation) -> dict:
    return vars(r)


def executor_reservation_from_obj(o: dict) -> ExecutorReservation:
    return ExecutorReservation(**o)


def job_status_to_obj(js: JobStatus) -> dict:
    # JSON object keys are strings; partition ids re-int on decode
    return {"job_id": js.job_id, "state": js.state, "error": js.error,
            "locations": {str(p): [location_to_obj(l) for l in locs]
                          for p, locs in js.locations.items()},
            "retriable": js.retriable}


def job_status_from_obj(o: dict) -> JobStatus:
    return JobStatus(
        o["job_id"], o["state"], o.get("error", ""),
        {int(p): [location_from_obj(l) for l in locs]
         for p, locs in o.get("locations", {}).items()},
        o.get("retriable", False))


def journal_event_to_obj(ev: JournalEvent) -> dict:
    # compact: zero/empty fields are omitted, mirroring what the journal's
    # in-memory dicts carry (emit() builds the same sparse shape)
    o = {"seq": ev.seq, "ts_ms": ev.ts_ms, "kind": ev.kind}
    if ev.actor:
        o["actor"] = ev.actor
    if ev.job_id:
        o["job_id"] = ev.job_id
    if ev.epoch:
        o["epoch"] = ev.epoch
    if ev.parent:
        o["parent"] = ev.parent
    if ev.attrs:
        o["attrs"] = dict(ev.attrs)
    return o


def journal_event_from_obj(o: dict) -> JournalEvent:
    return JournalEvent(
        int(o["seq"]), int(o["ts_ms"]), o["kind"], o.get("actor", ""),
        o.get("job_id", ""), int(o.get("epoch", 0)),
        int(o.get("parent", 0)), dict(o.get("attrs", {})))


# Every control-plane dataclass that crosses a process boundary, with its
# to/from pair (tests/test_torch_serde.py round-trips every entry against
# the reference's encoding).  The fleet's JobLease joins with ROADMAP.md
# queue 1 item 12 C.
WIRE_TYPES = {
    TaskId: (taskid_to_obj, taskid_from_obj),
    TaskDescription: (task_to_obj, task_from_obj),
    TaskStatus: (status_to_obj, status_from_obj),
    FailedReason: (failed_reason_to_obj, failed_reason_from_obj),
    ShuffleWritePartition: (shuffle_write_to_obj, shuffle_write_from_obj),
    PartitionLocation: (location_to_obj, location_from_obj),
    ExecutorMetadata: (executor_metadata_to_obj, executor_metadata_from_obj),
    ExecutorHeartbeat: (executor_heartbeat_to_obj, executor_heartbeat_from_obj),
    ExecutorReservation: (executor_reservation_to_obj,
                          executor_reservation_from_obj),
    JobStatus: (job_status_to_obj, job_status_from_obj),
    JournalEvent: (journal_event_to_obj, journal_event_from_obj),
}
