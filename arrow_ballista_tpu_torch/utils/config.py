"""Session configuration: typed, validated key-value settings.

The port's cut of the reference engine's ``BallistaConfig``: the same
string-KV shape with typed validation and defaults, holding only the keys
that the port's code reads.  Setting any other key raises
``ConfigurationError``; each later slice adds back the keys its code reads
(ROADMAP.md queue 1).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

from .errors import ConfigurationError

SHUFFLE_PARTITIONS = "ballista.shuffle.partitions"
BATCH_SIZE = "ballista.batch.size"
# per-task device working-set bound ('auto' | bytes | 0=unlimited)
MEM_TASK_BUDGET = "ballista.memory.task.budget.bytes"
# memory governor (memory/): reserve -> grant -> release accounting over a
# host budget; operators that hold unbounded state reserve before
# materializing and spill on denial.  The reference's device budget waits
# for the admission controller that reads it (ROADMAP.md queue 1 item 12 D)
MEM_HOST_BUDGET = "ballista.memory.host.budget.bytes"
MEM_SPILL_ENABLED = "ballista.memory.spill.enabled"
# the mesh (parallel/, ops/mesh_exec.py): stage pairs fused over the ranks
# of an in-process mesh, the exchange a copy between the ranks' tensors
MESH_SHUFFLE = "ballista.shuffle.mesh"
MESH_HYBRID = "ballista.shuffle.mesh.hybrid"  # mesh within a task, file shuffle across tasks
MESH_BROADCAST_ROWS = "ballista.shuffle.mesh.broadcast_rows"  # build rows <= this: all_gather
MESH_MIN_ROWS = "ballista.shuffle.mesh.min_rows"  # mesh only exchanges of at least this many rows
AGG_CAPACITY = "ballista.agg.capacity"  # static max distinct groups of a mesh aggregate
JOIN_OUTPUT_FACTOR = "ballista.join.output_factor"  # mesh joins: out_cap = factor * rank probe rows
# rows; join build sides estimated at or under it are broadcast (no shuffle)
BROADCAST_THRESHOLD = "ballista.join.broadcast_threshold"
# ceiling on a join's candidate pairs (CapacityError above it)
JOIN_MAX_CAPACITY = "ballista.join.max_capacity"
# device-resident scan cache budget ('auto' | bytes | 0 = off)
SCAN_CACHE_BYTES = "ballista.scan.cache.bytes"
# seconds a standalone client waits for a submitted job
JOB_TIMEOUT_S = "ballista.job.timeout.seconds"
# adaptive query execution at stage boundaries (scheduler/aqe.py)
AQE_ENABLED = "ballista.aqe.enabled"
AQE_COALESCE_ENABLED = "ballista.aqe.coalesce.enabled"
AQE_COALESCE_TARGET_ROWS = "ballista.aqe.coalesce.target.rows"
AQE_COALESCE_TARGET_BYTES = "ballista.aqe.coalesce.target.bytes"
AQE_BROADCAST_ENABLED = "ballista.aqe.broadcast.enabled"
AQE_BROADCAST_THRESHOLD_ROWS = "ballista.aqe.broadcast.threshold.rows"
AQE_SKEW_ENABLED = "ballista.aqe.skew.enabled"
AQE_SKEW_FACTOR = "ballista.aqe.skew.factor"
AQE_SKEW_MIN_ROWS = "ballista.aqe.skew.min.rows"
# whole-stage fusion (compile/)
COMPILE_ENABLED = "ballista.compile.enabled"
COMPILE_MIN_OPS = "ballista.compile.min.ops"
COMPILE_OPERATORS = "ballista.compile.operators"
COMPILE_DONATE = "ballista.compile.donate"
# observability (obs/): tracing spans and job profiles, the device
# observatory (a launch registry over the port's kernels, obs/device.py),
# the flight-recorder journal, the cluster time series, the live doctor and
# the SLO tracker
OBS_TRACING = "ballista.observability.tracing"
OBS_PROFILE_RETENTION = "ballista.observability.profile.retention"
OBS_COLLECTOR = "ballista.observability.collector"
OBS_OTLP_ENDPOINT = "ballista.observability.otlp.endpoint"
OBS_DEVICE_ENABLED = "ballista.observability.device.enabled"
OBS_DEVICE_WATERMARKS = "ballista.observability.device.watermarks"
OBS_DEVICE_ADVISOR_MIN_SAVINGS_MS = "ballista.observability.device.advisor.min_savings_ms"
JOURNAL_ENABLED = "ballista.journal.enabled"
JOURNAL_CAPACITY = "ballista.journal.capacity"
JOURNAL_SPILL_PATH = "ballista.journal.spill_path"
STATS_HISTORY_CAPACITY = "ballista.stats.history.capacity"
STATS_HISTORY_INTERVAL_S = "ballista.stats.history.interval.seconds"
LIVE_ENABLED = "ballista.live.enabled"
LIVE_DOCTOR_INTERVAL_S = "ballista.live.doctor.interval.seconds"
LIVE_WATCH_QUEUE_EVENTS = "ballista.live.watch.queue.events"
LIVE_WATCH_POLL_S = "ballista.live.watch.poll.seconds"
SLO_P99_TARGET_MS = "ballista.slo.latency.p99.target.ms"
SLO_WINDOW_S = "ballista.slo.window.seconds"
# deterministic fault injection (faults/)
FAULTS_PLAN = "ballista.faults.plan"
# the remote engine: client-side RPC deadlines and bounded backoff
# (net/retry.py), executor liveness (scheduler/cluster.py), and the shuffle
# transport between executors (ops/shuffle.py, net/dataplane.py)
RPC_CONNECT_TIMEOUT_S = "ballista.rpc.connect.timeout.seconds"
RPC_READ_TIMEOUT_S = "ballista.rpc.read.timeout.seconds"
RPC_RETRY_BASE_S = "ballista.rpc.retry.base.seconds"
RPC_RETRY_CAP_S = "ballista.rpc.retry.cap.seconds"
RPC_RETRY_DEADLINE_S = "ballista.rpc.retry.deadline.seconds"
CLUSTER_EXECUTOR_TIMEOUT_S = "ballista.cluster.executor_timeout_s"
SHUFFLE_INTEGRITY = "ballista.shuffle.integrity.verify"
SHUFFLE_LOCAL_HOST_MATCH = "ballista.shuffle.local.host_match"
SHUFFLE_MAX_CONCURRENT_FETCHES = "ballista.shuffle.max_concurrent_fetches"
SHUFFLE_WIRE_STREAMING = "ballista.shuffle.wire.streaming"
SHUFFLE_WIRE_CHUNK_ROWS = "ballista.shuffle.wire.chunk_rows"
SHUFFLE_WIRE_COMPRESSION = "ballista.shuffle.wire.compression"


@dataclasses.dataclass
class ConfigEntry:
    key: str
    default: Any
    parse: Callable[[str], Any]
    doc: str = ""


def env_flag(name: str) -> bool:
    """Shared truthiness rule for boolean env overrides
    (BALLISTA_FORCE_HASH_COLLISIONS):
    unset/''/'0'/'false'/'no' are False, anything else True.
    Returns None when the variable is unset/blank so callers can
    distinguish 'explicitly 0' from 'not set'."""
    import os

    v = os.environ.get(name)
    if v is None or v.strip() == "":
        return None
    return v.strip().lower() not in ("0", "false", "no")


def _parse_bool(s: str) -> bool:
    if str(s).lower() in ("true", "1", "yes"):
        return True
    if str(s).lower() in ("false", "0", "no"):
        return False
    raise ValueError(f"not a bool: {s!r}")


def _parse_partitions(s) -> int:
    """Shuffle partition count; 0 means 'auto' (derived at plan time from
    input row counts — the memory-control heuristic the reference leaves as
    a TODO grid, SURVEY §7 hard-parts)."""
    if str(s).lower() == "auto":
        return 0
    n = int(s)
    if n < 0:
        raise ValueError(f"partition count must be >= 0: {s!r}")
    return n


_ENTRIES: Dict[str, ConfigEntry] = {
    e.key: e
    for e in [
        ConfigEntry(SHUFFLE_PARTITIONS, 16, _parse_partitions,
                    "number of output partitions for shuffles, or 'auto' to "
                    "derive from input row counts at plan time"),
        ConfigEntry(BATCH_SIZE, 1 << 17, int, "static row capacity of a device ColumnBatch"),
        ConfigEntry(MEM_TASK_BUDGET, "auto", str,
                    "per-task device working-set budget in bytes: 'auto' "
                    "shuffle partition counts scale to keep task state "
                    "under it.  'auto' = 4 GiB on the card, unlimited on "
                    "the CPU; 0 = unlimited"),
        ConfigEntry(MEM_HOST_BUDGET, "0", str,
                    "memory governor: host pool budget in bytes for "
                    "operator state (join build sides, aggregation "
                    "groups).  Reservations beyond the budget are denied "
                    "and the operator spills its state to disk as Arrow "
                    "IPC runs (bit-identical results).  'auto' = 16 GiB; "
                    "0 = unlimited (governor grants everything, spill "
                    "never triggers)"),
        ConfigEntry(MEM_SPILL_ENABLED, True, _parse_bool,
                    "degrade to disk spill when the governor denies a "
                    "reservation (aggs: partial runs + sort-merge "
                    "finalize; joins: partitioned build rehydrate).  "
                    "False = a denial raises retryable MemoryExhausted "
                    "instead of spilling"),
        ConfigEntry(MESH_SHUFFLE, False, _parse_bool,
                    "fuse eligible aggregate and join stage pairs over the "
                    "in-process rank mesh (parallel/mesh.py): the exchange "
                    "is a copy between the ranks' tensors"),
        ConfigEntry(MESH_HYBRID, False, _parse_bool,
                    "hybrid exchange: mesh-fused partials and joins within "
                    "a task, file shuffle between tasks"),
        ConfigEntry(MESH_BROADCAST_ROWS, 1 << 18, int,
                    "mesh joins all_gather the build side instead of "
                    "all_to_all-ing both sides when its live rows fit here "
                    "(CollectLeft analog)"),
        ConfigEntry(MESH_MIN_ROWS, 8_000_000, int,
                    "adaptive transport: mesh-fuse an exchange only when "
                    "its estimated input rows reach this; 0 forces the "
                    "mesh for every eligible exchange"),
        ConfigEntry(AGG_CAPACITY, 1 << 16, int,
                    "static max distinct groups of a mesh aggregate (per "
                    "rank for the partial, in all for the final)"),
        ConfigEntry(JOIN_OUTPUT_FACTOR, 2, int,
                    "mesh-join output capacity = factor * per-rank probe "
                    "rows (plain joins size outputs by a count pass)"),
        ConfigEntry(BROADCAST_THRESHOLD, 4_000_000, int,
                    "broadcast join build sides with at most this many "
                    "estimated rows (no shuffle of either side)"),
        ConfigEntry(JOIN_MAX_CAPACITY, 1 << 26, int,
                    "ceiling on a join's candidate pairs (rows); above it the "
                    "join raises CapacityError"),
        ConfigEntry(SCAN_CACHE_BYTES, "auto", str,
                    "device-resident scan cache budget: 'auto' (6 GiB on the "
                    "card, 1 GiB on the CPU), a byte count, or 0 to disable; "
                    "see utils/table_cache.py"),
        ConfigEntry(JOB_TIMEOUT_S, 3600, int,
                    "seconds a standalone client waits for a submitted job "
                    "before giving up"),
        ConfigEntry(AQE_ENABLED, True, _parse_bool,
                    "adaptive query execution: re-optimize not-yet-resolved "
                    "downstream stages from the observed shuffle statistics "
                    "of completed producers (partition coalescing, the "
                    "shuffle-join -> broadcast switch, skew splitting); "
                    "results are identical either way"),
        ConfigEntry(AQE_COALESCE_ENABLED, True, _parse_bool,
                    "merge tiny reduce partitions of a resolving stage up "
                    "to the coalesce targets"),
        ConfigEntry(AQE_COALESCE_TARGET_ROWS, 8192, int,
                    "coalesced-partition target in observed rows (0 "
                    "disables the row target)"),
        ConfigEntry(AQE_COALESCE_TARGET_BYTES, 1 << 20, int,
                    "coalesced-partition target in observed shuffle bytes "
                    "(0 disables the byte target)"),
        ConfigEntry(AQE_BROADCAST_ENABLED, True, _parse_bool,
                    "flip a downstream partitioned join to broadcast when "
                    "its build stage's observed output is under the "
                    "threshold, grafting away the probe exchange where "
                    "the plan allows"),
        ConfigEntry(AQE_BROADCAST_THRESHOLD_ROWS, 4_000_000, int,
                    "observed build-side rows at or under which the "
                    "broadcast switch fires"),
        ConfigEntry(AQE_SKEW_ENABLED, True, _parse_bool,
                    "split a hot reduce partition into several tasks, each "
                    "reading a sub-range of the producer's map outputs"),
        ConfigEntry(AQE_SKEW_FACTOR, 4.0, float,
                    "a partition is hot when its observed rows exceed "
                    "factor x the stage's mean partition rows"),
        ConfigEntry(AQE_SKEW_MIN_ROWS, 1_000_000, int,
                    "never skew-split a partition of fewer observed rows"),
        ConfigEntry(COMPILE_ENABLED, True, _parse_bool,
                    "whole-stage fusion: at stage resolution, replace each "
                    "maximal chain of allowlisted operators with one "
                    "generated kernel (compile/)"),
        ConfigEntry(COMPILE_MIN_OPS, 2, int,
                    "minimum operators in an allowlisted run before it "
                    "fuses"),
        ConfigEntry(COMPILE_OPERATORS, "FilterExec,ProjectionExec,"
                    "RenameExec,HashAggregateExec", str,
                    "comma-separated operator allowlist for whole-stage "
                    "fusion"),
        ConfigEntry(COMPILE_DONATE, True, _parse_bool,
                    "read and recorded for parity with the reference; does "
                    "nothing in the port: a generated kernel never writes "
                    "its inputs, so there is no buffer to donate"),
        ConfigEntry(OBS_TRACING, True, _parse_bool,
                    "tracing spans: a job span per standalone job with its "
                    "phases, a task span per task and an operator span per "
                    "execute call, folded into the job profile the forensics "
                    "bundle carries (False = no spans, no profile)"),
        ConfigEntry(OBS_PROFILE_RETENTION, 64, int,
                    "finished job profiles (and their span sets) the "
                    "scheduler retains in a ring buffer"),
        ConfigEntry(OBS_COLLECTOR, "noop", str,
                    "span export collector: 'noop' (default), 'memory' "
                    "(bounded in-process buffer), or 'otlp' (best-effort "
                    "OTLP/HTTP JSON POST to "
                    "ballista.observability.otlp.endpoint)"),
        ConfigEntry(OBS_OTLP_ENDPOINT, "", str,
                    "OTLP/HTTP endpoint (e.g. "
                    "http://localhost:4318/v1/traces) used when the 'otlp' "
                    "collector is selected"),
        ConfigEntry(OBS_DEVICE_ENABLED, True, _parse_bool,
                    "device observatory (obs/device.py): every kernel launch "
                    "attributed to its operator and task, CUDA event times "
                    "per launch inside a task scope, nvcc builds of "
                    "generated sources, host<->device transfer bytes and "
                    "memory watermarks (False = every probe is a single "
                    "predicate check)"),
        ConfigEntry(OBS_DEVICE_WATERMARKS, True, _parse_bool,
                    "sample allocated device bytes and the host RSS peak at "
                    "task/operator boundaries (requires "
                    "ballista.observability.device.enabled)"),
        ConfigEntry(OBS_DEVICE_ADVISOR_MIN_SAVINGS_MS, 1.0, float,
                    "fusion advisor (obs/advisor.py): drop stage operator "
                    "chains whose estimated fusion savings fall below this "
                    "many milliseconds"),
        ConfigEntry(JOURNAL_ENABLED, False, _parse_bool,
                    "flight recorder (obs/journal.py): causally-ordered "
                    "journal of job lifecycle, task attempts, stage "
                    "resolution, AQE rewrites, fusion and failpoint firings, "
                    "feeding the forensics bundle and the query doctor "
                    "(False = every probe is a single predicate check)"),
        ConfigEntry(JOURNAL_CAPACITY, 4096, int,
                    "events retained in the process-global journal ring "
                    "and in each per-job timeline"),
        ConfigEntry(JOURNAL_SPILL_PATH, "", str,
                    "append every journal event as one JSON line to this "
                    "file; empty = no spill"),
        ConfigEntry(STATS_HISTORY_CAPACITY, 512, int,
                    "ring-buffer capacity of the scheduler's cluster time "
                    "series (oldest samples are evicted)"),
        ConfigEntry(STATS_HISTORY_INTERVAL_S, 5.0, float,
                    "seconds between cluster-history samples (executor "
                    "utilization, event-loop lag)"),
        ConfigEntry(LIVE_ENABLED, False, _parse_bool,
                    "live observability plane: run the in-flight doctor "
                    "scan thread against running jobs (obs/live.py)"),
        ConfigEntry(LIVE_DOCTOR_INTERVAL_S, 5.0, float,
                    "cadence of the in-flight doctor scan over running "
                    "jobs; <= 0 disables the scan thread even when live "
                    "is on"),
        ConfigEntry(LIVE_WATCH_QUEUE_EVENTS, 1024, int,
                    "bound of each watch subscriber's event queue; a "
                    "consumer that falls behind sheds oldest events and "
                    "receives one watch.gap event with the drop count"),
        ConfigEntry(LIVE_WATCH_POLL_S, 0.25, float,
                    "how often ctx.watch() re-checks a quiet job's state "
                    "and emits a progress frame"),
        ConfigEntry(SLO_P99_TARGET_MS, 0.0, float,
                    "latency SLO: 99% of completed jobs must finish under "
                    "this wall time (a failed job always counts as a "
                    "violation); 0 disables SLO tracking"),
        ConfigEntry(SLO_WINDOW_S, 300.0, float,
                    "slow burn-rate window of the SLO tracker in seconds; "
                    "the fast window is 1/12 of it"),
        ConfigEntry(FAULTS_PLAN, "", str,
                    "deterministic fault-injection plan: inline JSON or "
                    "'@/path/to/plan.json' (faults/); empty = disabled, all "
                    "failpoint sites are no-ops"),
        ConfigEntry(RPC_CONNECT_TIMEOUT_S, 5.0, float,
                    "TCP connect deadline for client-side control-plane "
                    "RPCs (net/retry.py)"),
        ConfigEntry(RPC_READ_TIMEOUT_S, 60.0, float,
                    "read deadline for client-side control-plane RPCs "
                    "(net/retry.py)"),
        ConfigEntry(RPC_RETRY_BASE_S, 0.2, float,
                    "base backoff between RPC retries; doubles per attempt "
                    "(jittered, capped at ballista.rpc.retry.cap.seconds)"),
        ConfigEntry(RPC_RETRY_CAP_S, 5.0, float,
                    "upper bound on a single RPC retry backoff"),
        ConfigEntry(RPC_RETRY_DEADLINE_S, 30.0, float,
                    "give-up deadline across all retries of one RPC; on "
                    "expiry a retryable failure surfaces (the executor marks "
                    "the scheduler unreachable; a failed launch becomes "
                    "ExecutorLost)"),
        ConfigEntry(CLUSTER_EXECUTOR_TIMEOUT_S, 180.0, float,
                    "seconds without a heartbeat before an executor is "
                    "declared lost (reaper -> ExecutorLost).  Work offers "
                    "stop earlier, at timeout minus a drain grace of "
                    "min(60s, timeout/2)"),
        ConfigEntry(SHUFFLE_INTEGRITY, True, _parse_bool,
                    "verify the producer-recorded CRC-32 of every remotely "
                    "fetched or co-located shuffle partition before "
                    "decoding it; a mismatch raises a retryable "
                    "IntegrityError (re-fetch, then lineage rollback)"),
        ConfigEntry(SHUFFLE_LOCAL_HOST_MATCH, True, _parse_bool,
                    "a reader whose executor advertises the same host as a "
                    "shuffle producer maps the producer's IPC file (mmap) "
                    "instead of fetching it over the data plane; any size "
                    "or CRC doubt falls back to the remote fetch"),
        ConfigEntry(SHUFFLE_MAX_CONCURRENT_FETCHES, 50, int,
                    "per reduce-task cap on concurrent remote shuffle "
                    "fetches (on one process-wide pool)"),
        ConfigEntry(SHUFFLE_WIRE_STREAMING, True, _parse_bool,
                    "remote shuffle fetches stream as CRC'd Arrow IPC "
                    "chunks decoded while later chunks are in flight; a "
                    "retry resumes at the first unverified chunk.  False = "
                    "whole-file fetch_partition blobs"),
        ConfigEntry(SHUFFLE_WIRE_CHUNK_ROWS, 1 << 16, int,
                    "rows per streamed shuffle chunk (chunk boundaries are "
                    "multiples of it, so a resume is exact)"),
        ConfigEntry(SHUFFLE_WIRE_COMPRESSION, "lz4", str,
                    "Arrow IPC buffer compression of the streamed remote "
                    "fetch: 'lz4', 'zstd' or 'none'; an unavailable codec "
                    "degrades to 'none'"),
    ]
}


def resolve_task_budget(cfg: "BallistaConfig", accelerator: bool) -> int:
    """MEM_TASK_BUDGET -> bytes (0 = unlimited).  ``accelerator`` says
    whether the plan runs on a card ('auto' = 4 GiB there, unlimited on
    the CPU).  The budget is enforced before allocation: 'auto' shuffle
    partition counts scale so no task's working set is planned above it."""
    v = cfg.get(MEM_TASK_BUDGET)
    if isinstance(v, str):
        if v.strip().lower() == "auto":
            return (4 << 30) if accelerator else 0
        v = int(v)
    return int(v)


def resolve_pool_budget(cfg: "BallistaConfig", key: str) -> int:
    """MEM_HOST_BUDGET -> bytes (0 = unlimited; 'auto' = 16 GiB)."""
    v = cfg.get(key)
    if isinstance(v, str):
        if v.strip().lower() == "auto":
            return 16 << 30
        v = int(v)
    return int(v)


class BallistaConfig:
    def __init__(self, settings: Optional[Dict[str, Any]] = None):
        self._settings: Dict[str, Any] = {}
        for k, v in (settings or {}).items():
            self.set(k, v)

    def set(self, key: str, value: Any) -> None:
        entry = _ENTRIES.get(key)
        if entry is None:
            raise ConfigurationError(
                f"unknown configuration key {key!r} (the port holds only the "
                f"keys its code reads: {', '.join(sorted(_ENTRIES))})")
        if isinstance(value, str) and not isinstance(entry.default, str):
            try:
                value = entry.parse(value)
            except Exception as e:
                raise ConfigurationError(f"invalid value for {key}: {e}") from e
        expected = type(entry.default)
        if expected is float and isinstance(value, int) and not isinstance(value, bool):
            value = float(value)
        if not isinstance(value, expected) or (expected is int and isinstance(value, bool)):
            raise ConfigurationError(
                f"invalid value for {key}: expected {expected.__name__}, got {type(value).__name__} ({value!r})"
            )
        self._settings[key] = value

    def get(self, key: str) -> Any:
        entry = _ENTRIES.get(key)
        if entry is None:
            raise ConfigurationError(
                f"unknown configuration key {key!r} (the port holds only the "
                f"keys its code reads: {', '.join(sorted(_ENTRIES))})")
        return self._settings.get(key, entry.default)

    # typed accessors
    @property
    def shuffle_partitions(self) -> int:
        return self.get(SHUFFLE_PARTITIONS)

    @property
    def batch_size(self) -> int:
        return self.get(BATCH_SIZE)

    @property
    def job_timeout_s(self) -> int:
        return self.get(JOB_TIMEOUT_S)

    def to_dict(self) -> Dict[str, Any]:
        d = {k: e.default for k, e in _ENTRIES.items()}
        d.update(self._settings)
        return d

    def __repr__(self):
        return f"BallistaConfig({self._settings})"
