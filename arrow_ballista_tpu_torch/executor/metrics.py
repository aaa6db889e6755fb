"""Executor metrics: process counters + prometheus text exposition.

The port's copy of arrow_ballista_tpu/executor/metrics.py: the same
exposition format, so one scrape config covers both engines.  The remote
executor serves it (executor/server.py ``metrics_port``, obs/http.py); the
shuffle fetch counters by transport path come from the data plane's
process-wide ``STATS`` (net/dataplane.py).
"""
from __future__ import annotations

import threading

from ..scheduler.metrics import Histogram


class ExecutorMetrics:
    def __init__(self):
        self._lock = threading.Lock()
        self.launched = 0
        self.completed = 0
        self.failed = 0
        self.killed = 0
        self.shuffle_bytes = 0
        self.shuffle_rows = 0
        self.task_duration = Histogram([0.01, 0.05, 0.1, 0.5, 1.0, 5.0,
                                        30.0, 120.0])

    def record_task(self, status, duration_s: float) -> None:
        """Fold one finished task's outcome (every run_task return path)."""
        with self._lock:
            self.launched += 1
            if status.state == "success":
                self.completed += 1
            elif status.state == "killed":
                self.killed += 1
            else:
                self.failed += 1
            for w in status.shuffle_writes or []:
                self.shuffle_bytes += int(w.num_bytes)
                self.shuffle_rows += int(w.num_rows)
            self.task_duration.observe(max(0.0, duration_s))

    def gather(self, active_tasks: int = 0) -> str:
        with self._lock:
            lines = []

            def counter(name, v, help_):
                lines.append(f"# HELP {name} {help_}")
                lines.append(f"# TYPE {name} counter")
                lines.append(f"{name} {v}")

            counter("executor_tasks_launched_total", self.launched,
                    "tasks this executor started")
            counter("executor_tasks_completed_total", self.completed,
                    "tasks that finished successfully")
            counter("executor_tasks_failed_total", self.failed,
                    "tasks that finished in failure")
            counter("executor_tasks_killed_total", self.killed,
                    "tasks killed by job cancellation")
            counter("executor_shuffle_bytes_written_total",
                    self.shuffle_bytes, "shuffle bytes written")
            counter("executor_shuffle_rows_written_total",
                    self.shuffle_rows, "shuffle rows written")
            # read-side data-plane accounting: process-global (one view per
            # executor process; in-process executors share it)
            from ..net.dataplane import STATS as dp_stats

            snap = dp_stats.snapshot()
            name = "shuffle_bytes_fetched_total"
            lines.append(f"# HELP {name} shuffle bytes read by this process, "
                         "by transport path (local_mmap = zero-copy "
                         "co-located read, local_copy = non-mmap local read, "
                         "remote = data-plane fetch; remote counts "
                         "bytes-on-wire, post-compression)")
            lines.append(f"# TYPE {name} counter")
            for p, v in sorted(snap["bytes_fetched"].items()):
                lines.append(f'{name}{{path="{p}"}} {v}')
            counter("shuffle_fetch_chunks_total", snap["chunks"],
                    "chunks received over the streaming shuffle protocol")
            counter("shuffle_fetch_chunks_resumed_total",
                    snap["resumed_chunks"],
                    "chunks skipped by resuming a retried stream at the "
                    "first unverified chunk")
            lines.append("# HELP shuffle_wire_compression_ratio raw/wire "
                         "byte ratio of streamed shuffle fetches (>1 = "
                         "compression shrank the wire; 1.0 = none yet)")
            lines.append("# TYPE shuffle_wire_compression_ratio gauge")
            lines.append("shuffle_wire_compression_ratio "
                         f"{dp_stats.compression_ratio():.4f}")
            # device-observatory process totals (obs/device.py STATS):
            # process-global like the data-plane counters above
            from ..obs.device import STATS as dev_stats

            dsnap = dev_stats.snapshot()
            counter("device_jit_compiles_total",
                    int(dsnap["jit_compiles"]),
                    "nvcc builds of generated kernel sources (first source "
                    "of an operator signature)")
            counter("device_jit_retraces_total",
                    int(dsnap["jit_retraces"]),
                    "nvcc builds of a second distinct generated source for "
                    "an operator signature that already built one")
            counter("device_jit_cache_hits_total",
                    int(dsnap["jit_cache_hits"]),
                    "generated programs served by an already-loaded library")
            counter("device_jit_compile_seconds_total",
                    round(float(dsnap["jit_compile_time"]), 6),
                    "wall time of the nvcc builds of generated sources")
            counter("device_program_cache_hits_total",
                    int(dsnap["program_cache_hits"]),
                    "cross-job shared_program closure-cache hits "
                    "(ops/physical.py)")
            counter("device_program_cache_misses_total",
                    int(dsnap["program_cache_misses"]),
                    "shared_program closure-cache misses (a closure was "
                    "built and inserted)")
            # the process's launch counter (ops/kernels.py LAUNCHES; the
            # observatory keeps no process total), K13's dense tag left out
            from ..ops import kernels as K

            counter("device_kernel_launches_total",
                    sum(v for k, v in K.LAUNCHES.items() if k != "fused_agg_dense"),
                    "launches of the port's kernels (ops/kernels.py "
                    "count_launch)")
            counter("device_h2d_bytes_total", int(dsnap["h2d_bytes"]),
                    "bytes moved host->device through the batch upload "
                    "(models/batch.py upload)")
            counter("device_d2h_bytes_total", int(dsnap["d2h_bytes"]),
                    "bytes moved device->host through the packed host "
                    "collect (ColumnBatch.packed_numpy)")
            lines.append("# HELP device_live_bytes_peak high-water mark of "
                         "allocated device bytes sampled at task/operator "
                         "boundaries (torch.cuda.memory_allocated)")
            lines.append("# TYPE device_live_bytes_peak gauge")
            lines.append(
                f"device_live_bytes_peak {int(dsnap['device_live_peak_bytes'])}")
            lines.append("# HELP host_rss_bytes_peak high-water mark of "
                         "this process's resident set (ru_maxrss; "
                         "KB-granular on Linux)")
            lines.append("# TYPE host_rss_bytes_peak gauge")
            lines.append(
                f"host_rss_bytes_peak {int(dsnap['host_rss_peak_bytes'])}")
            # memory-governor process totals (memory/governor.py STATS):
            # reservation accounting + spill volume, process-global
            from ..memory import STATS as mem_stats

            msnap = mem_stats.snapshot()
            name = "memory_reserved_bytes"
            lines.append(f"# HELP {name} bytes currently reserved from the "
                         "memory governor by running operators, per pool")
            lines.append(f"# TYPE {name} gauge")
            for pool in ("host", "device"):
                v = int(msnap.get(f"reserved_bytes.{pool}", 0))
                lines.append(f'{name}{{pool="{pool}"}} {v}')
            counter("memory_spill_bytes_total",
                    int(msnap.get("spill_bytes_total", 0)),
                    "bytes written to disk as Arrow IPC spill runs by "
                    "operators the governor denied an in-memory grant")
            counter("memory_spill_runs_total",
                    int(msnap.get("spill_runs_total", 0)),
                    "spill run files written (agg partial runs + join "
                    "build partitions)")
            counter("memory_reserve_denied_total",
                    int(msnap.get("reserve_denied_total", 0)),
                    "governor reservation denials (each degraded an "
                    "operator to its spill path, or failed the task "
                    "retriably with spill disabled)")
            counter("memory_over_budget_grants_total",
                    int(msnap.get("over_budget_grants_total", 0)),
                    "forced over-budget grants to operators with a hard "
                    "single-pass requirement (left/full outer join build "
                    "sides)")
            lines.append("# HELP executor_active_tasks tasks currently "
                         "executing")
            lines.append("# TYPE executor_active_tasks gauge")
            lines.append(f"executor_active_tasks {active_tasks}")
            h = self.task_duration
            name = "executor_task_duration_seconds"
            lines.append(f"# HELP {name} wall time per task")
            lines.append(f"# TYPE {name} histogram")
            acc = 0
            for b, c in zip(h.buckets, h.counts):
                acc += c
                lines.append(f'{name}_bucket{{le="{b}"}} {acc}')
            lines.append(f'{name}_bucket{{le="+Inf"}} {h.n}')
            lines.append(f"{name}_sum {h.total}")
            lines.append(f"{name}_count {h.n}")
            return "\n".join(lines) + "\n"
