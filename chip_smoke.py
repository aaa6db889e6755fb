#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (arrow_ballista_tpu_torch) on
one NVIDIA card.  Run from the repository root: ``python3 chip_smoke.py``.

Phases (any failure exits non-zero and prints no result line):

1. the card's name and power limit, as nvidia-smi reports them;
2. build of the port's CUDA kernels from ``arrow_ballista_tpu_torch/csrc``
   (one nvcc per source, all started together; set-up time);
3. the main paths, on the TPC-H tables at SF1 (``benchmarks.datagen``, seed
   0, generated once) through ``BallistaContext.local()`` -> ``sql`` ->
   ``to_pandas``: q1 (K1-K4), q3 (two broadcast inner joins and the
   sort-path aggregate: K2-K6, K8) and q4 (a semi join and a dense
   aggregate: K1, K5-K7) over in-memory tables; then the same three and
   q18 over parquet files (``pq_*`` paths: the tables written once with
   decimals in int64 storage and 2^19-row row groups at SF1, as
   ``benchmarks/tpch.py convert`` writes them, into an ignored directory
   removed at exit), through ``register_parquet``: the row-group scan, the
   device-resident scan cache and, on q18's subquery, the clustered
   presorted aggregate with its early HAVING (K2, K9, K8, K10, K11).  Each
   path runs once cold and then warm (q1 five times, the others three),
   with every launch counter reset just before the cold run and read just
   after it: each path must launch its own kernels, and every tensor a
   kernel gets must lie on the card.  Every warm parquet run must hit the
   scan cache and read no row group again; q18 must early-filter and never
   fall back to the sort path; no query may write into a cached tensor.
   Then the standalone engine (``BallistaContext.standalone``, bench.py's
   base config: 'auto' shuffle partitions, 2^20-row batches, four task
   slots; stages, Arrow IPC shuffle files and whole-stage fusion) on the
   same tables: ``sa_pq_q1`` (K13 dense on q1's partial, the writers' K3
   and K2), ``sa_pq_q3`` and ``sa_pq_q4`` (the stage, task and shuffle
   machinery), ``sa_pq_q18`` (K12 on the HAVING chain, K9-K11 in the clustered
   partial) over parquet, and
   ``sa_q18`` over in-memory tables (K13's sort path, then K4 + K8); each
   prints its stages, fused chains, ``fused_fallbacks`` (must be 0) and
   where its time went (writer, reader, fused chains, outside the tasks).
   Then, one warm run each: ``pq_q7``, ``pq_q8``, ``pq_q9`` (EXTRACT
   through K14 in the local engine over parquet); ``sa_q7``, ``sa_q8``,
   ``sa_q9`` (standalone over in-memory tables: EXTRACT traced into the
   generated K13 sources, checked on the sources); ``sa_q20`` (q20's
   lineitem partial barely reduces its ~159k rows a partition at SF1: the
   first task's metrics snapshot latches the adaptive passthrough, and the
   later tasks emit per-row states, which are all input columns there, so
   K15 has nothing to write); ``sa_pt`` (a GROUP BY on lineitem's key,
   which never reduces: the later tasks' per-row states include a computed
   sum and count(*), which K15 writes; both paths must latch on every
   run); ``spill_q3``, ``spill_q4``,
   ``spill_q9``, ``spill_q18``, ``spill_q21`` (the local engine over parquet
   at SF0.25 (``SPILL_SF``), cold only,
   with every join partitioned, under a 1 MiB host budget: aggregates and
   the inner and semi joins spill to
   Arrow IPC runs, the joins' build sides split by K16; each result equals
   its unlimited run bit for bit, both operators spill, and no reservation
   is left); ``memsweep`` (the JAX package's tools/memory_sweep.py leg: the
   22 queries through the local engine over the SF1 parquet with
   2^20-row batches,
   the scan cache off, under the 1 MiB budget, each equal bit for bit to
   the same settings with no budget; denials and spill runs, no
   reservation left); and
   ``tpch22``: all 22 TPC-H queries through the standalone
   engine over parquet, cold and warm, held against the port on the CPU
   (a child process running the plain twins over the same files beside the
   card's later paths), as are the q7-q9, q20 and sa_pt paths; at SF0.01 the 22
   queries also run on the card in both engines against a sqlite3 oracle.
   The mesh paths (``ballista.shuffle.mesh`` with no row floor, over
   parquet): ``mesh_q1`` on the default mesh (every card: one), the dense
   reduce (the generated derive, K1, K18); ``mesh4_q1``, ``mesh4_q3``
   (orders all_gathered, lineitem partitioned: K17), ``mesh4_q3_part``
   (every join partitioned), ``mesh4_q18`` (the hashed mesh aggregate over
   1.5M groups, K17) and ``sa_hybrid_q3`` (the standalone engine's hybrid
   mode: the mesh inside each task) on four ranks over ``cuda:0``; each
   prints its mesh metrics and the bytes its exchange copied, and the two
   q3 runs together must show a broadcast and a partitioned mesh join.
   ``dryrun_multichip(4)`` runs on the card.
   The scans of csv, json and avro: ``csv_q1`` and ``csv_q3`` (the local
   engine over SF1 csv files of lineitem, orders and customer registered
   under the TPC-H schema, one file one scan partition, read on every
   query) and ``sa_csv_q1`` (the standalone engine), each bit for bit
   against its parquet path and the numpy oracles; ``json_q1`` and
   ``avro_q1`` (SF0.01 lineitem, the avro codec being pure Python) against
   the port on the CPU.  On every local path the operator programs run as
   generated kernels (K19), concat on K20, shrink, pack and the sort and
   join gathers on K2 + K21, the join masks on K22 and the repartition's
   masks on K22's bucket form, which must launch once a repartitioned
   batch (not once a batch and partition: counted on every path, and on
   q1 and pq_q1 it must launch); no warm run may build a generated source,
   and at SF0.01 the 22 queries' programs must all trace
   (``tpch22_local``: no ``CodegenError``).
   The inputs of each wrapper's largest call on each path are captured;
4. each kernel held against its plain PyTorch twin on the card: on every
   path that launched it, at the inputs of that path's largest call of each
   of its wrappers (K3: bucket_of and hash64; K6: probe_join and
   probe_counts), and at stress shapes of 6M rows (sums that
   wrap, negative and NULL-sentinel keys; for the sort ties, desc keys,
   bools, NaN and dead rows, one full-range int64 key and eight keys over
   64 bits; for the join build and probe duplicate keys with fan-out,
   all-dead rows, forced equal hashes and truncation at the pair capacity,
   and K5 at 2^23 rows in both hash modes; for K6 tests/torch_cases.py's
   probe cases (one build row, an all-dead probe, live all-ones probe
   hashes against the dead build tail, forced equal hashes past the 2^20
   cap, row n-1 dead and live) at 1, 255, 257, 135,168 -+1 and 2^23 + 5
   probe rows,
   both count modes and masks viewed at byte offsets 1-15; for K2 0, 1,
   8,191, 8,193, 2^17 -+1, 2^17 + 8,192 -+1 and 2^23 + 5 rows, all live
   and all dead, views at byte offsets 1-15, each in the form its size
   takes, with its live count; K6 and K2 100 calls back to back on one stream and
   from four threads at once, on one stream and on a stream each; one
   segment hit by every row; for the sort-path
   aggregate (K8) empty slots, one 6M-row group (across every tile), no
   keys and float columns, a tile -+1 rows, a group across two tiles,
   every row its own group, dead rows inside and before the groups, a
   capacity below the group count, the same read through an order, and
   300 calls back to back on one stream and calls from four threads at
   once, on one stream and on a stream each;
   for K1 int32 sums that wrap and int32 and float32 min and max; for K9
   keys in row order with dead gaps and tile edges (tests/torch_cases.py
   DISORDER_CASES) and shuffled keys, each with its expected flag; for K10
   keys out of range and NULL keys; for
   K11 1,000 intervals and 5,000 merged ones; for K10 and K11 0, 1, 15, 17,
   255, 257, 2,047, 2,049 and 2^20 + 5 rows of int32 and int64 keys at their
   extremes, all rows dead, inputs viewed at byte offsets 1-15, 100 calls
   back to back on one stream and calls from four threads at once, on one
   stream and on a stream each; for K17 2, 4 and 8 destinations with capacities
   that fit and that overflow, and 40 int64 columns (two launches); for
   K18 2, 4 and 8 rank arrays (int64 sums that wrap, float64 sums), and
   its many-column form (one dense merge's columns of every dtype, NaN in
   float min and max, exists counts, a bool flag) over 1 and 4 ranks and
   72 columns over 8 ranks (nine launches); for the mesh derive NULL keys
   and values;
   for K12 and K13 a row chain and a dense and a
   sort-path aggregate chain with NULL keys and values, int64 sums and
   products that wrap, float64 sums and a dictionary predicate; for K14
   days over 1900-2100, the leap days of 1900 / 2000 / 2100, negative days
   and the NULL sentinel, and every int32 day, each field; for K15 NULL
   keys and values; for K16 forced
   collisions and the values dead rows may carry; for K19 a filter, a
   projection and computed sort keys over NULL strings and integers, NaN
   and products that wrap; for K20 40 columns of every dtype and 70
   sources; for K21 a random index with repeats and a packed copy; for K22
   each of its four binary ops, and its bucket form at 1, 2, 16 and 64
   partitions over 1, 15, 16, 17 and 131,072 -+1 rows and 6M rows, views at
   byte offsets 1-15 and buckets outside the range).  K19 is also held
   against its twin at the
   largest call of each program kind.  Integers
   exact; float sums at rtol 1e-12 (the kernels' summation order, atomic
   or by tiles, differs from the twin's) or exact on quarter values;
5. results held against independent numpy computations on the same
   generated arrays, on both the in-memory and the parquet paths: q1
   (decimal sums and counts exact, averages at rtol 1e-12), q3's top 10
   and q3 without its LIMIT (every group, by l_orderkey), both exact in
   scaled-decimal revenue, date and priority, q4's five counts, exact,
   and q18's top 100 and every q18 row without the LIMIT, exact; the
   standalone paths against the same oracles;
6. times (warm): kernel, plain twin and library call at the main path's
   shapes, each as device time per call (torch.profiler: the card's own
   time for everything one call launches; where it records nothing, or
   less than the bound (it lost launches), CUDA events around calls queued
   behind a spin kernel) and as wall time per
   call (CUDA events around back-to-back calls, host work included), with
   each kernel's least time (bytes moved at 3.35 TB/s), and for K12 / K13
   the interpreted chain's times (no one PyTorch call computes a fused
   chain) and the nvcc seconds of their generated sources; K7, K15, K17,
   K18 and the mesh derive timed over copies of their inputs that rotate
   through more than the 50 MB L2; the exchange copies' bytes and times
   (over rotating copies, beside one ``copy_`` of the same bytes, from the
   profiler and from queued events);
   K1's device time over 1 to 289 hot groups; each query's cold/warm wall time and profiled
   device busy share; the device time and bytes bound of the expression
   programs, the host packing and the batch concat/shrink on q3's path
   (kernel timings at the largest call over the paths);
   the device time per q3 query of K19, K20, K21, K2 and K22 (by kernel
   name); ``topk_order`` against ``torch.topk`` at 6M keys (no caller);
   K4 and K5 (the radix core) at their stress shapes and at a 131,072-row
   K4 call beside ``torch.sort``, each call's plan (single block or
   onesweep, composite bits, passes) on every path and at every check, and
   their kernels' device ms per profiled query; K10's and K11's kernels,
   launches and the memsets before them per profiled query (on pq_q18 one
   kernel a call and no memset, or the run fails); what one call queues at
   the largest K17 call of mesh4_q3, mesh4_q3_part and mesh4_q18 (K17's
   count and scatter kernels and nothing else) and at the largest presorted
   grouping of pq_q18 and sa_pq_q18 (K2's, K9's and K8's kernels, no cast,
   gather or memset) and at the largest dense merge of mesh_q1 and
   mesh4_q1 (one K18 kernel: every state, the exists counts' ``> 0`` and
   the bad flag in one launch), on the host and by the profiler after a
   spin kernel, or the run fails; each generated program that inlines
   K14's civil core (K19 on pq_q7-q9, K13 on sa_q7-q9) at its largest
   call, held against its twin and timed; K6's and K2's kernels,
   device ms and the memsets and copies before them per profiled query (on
   q3 and pq_q18 K6's fused kernel and at most its fill a call, K2's one
   kernel or its count and scatter, and no memset or copy, or the run
   fails), the rows of their calls per path by power of two, and the live
   probe share, total and cap of K6's largest call; K8's kernels likewise
   (on q3 and pq_q18 its fused kernel and its fill a call, no memset), and
   at its largest call K8 read through the order beside the same call with
   the columns gathered first and the gathers; K22's bucket form's
   launches per profiled query;
   the ``entry()`` step's rows/s at 4096 and 6M rows; per parquet query
   the scan's read and convert times cold and warm, the scan cache's
   resident bytes and the peak device memory.

7. ``obs`` (last, on the SF1 tables already loaded): q1's and q3's EXPLAIN ANALYZE
   in the local engine with the device observatory on, under the profiler
   (rows against the oracle, every operator's output_rows against an
   unobserved run, every launched kernel attributed to its operators with
   the process counter's launches and, on the card, an event time; the
   event times per kernel and their sum beside the profiler's device ms of
   the same query); standalone q1 and q3 over parquet with the journal and
   tracing on (a valid forensics bundle, no doctor finding, a watch stream
   ending successful, each task's launches and event times); one
   ``executor.task.slow`` straggler that the doctor must report; and the
   warm q1 wall with the observatory off, on, and on through EXPLAIN
   ANALYZE (CUDA events on every launch), five runs each, alternating,
   with the card's name and power limit, without a gate.
   ``python3 chip_smoke.py --obs-only [FILE]`` runs the build, the data and
   this phase alone (its report as JSON to FILE).

8. ``remote`` (after obs, on the SF1 parquet files): the remote engine.  A
   SchedulerNetService (round-robin distribution, the standalone paths'
   base config), two ExecutorServers of four task slots with separate work
   directories, one in this process and one in a child process
   (``python3 -c``, its own CUDA context), and ``BallistaContext.remote``.
   rm_pq_q1, rm_pq_q3 and rm_pq_q18 run cold then warm, first with the
   default host match (co-located partitions through mmap), then with
   ``ballista.shuffle.local.host_match=false`` (the wire: lz4 chunks; the
   child restarts with it).  Every run's rows equal sa_pq's bit for bit and
   the numpy oracles; both executors run on the card and launch kernels
   (the child's counted from its task statuses); every kernel call of the
   in-process executor's cold run equals its twin; the readers fetch
   through the path asked for; no fused chain falls back; a warm run
   builds no generated source in either process; the work directories end
   empty after the scheduler's cleanup delay and the child exits 0.  It
   prints each run's wall beside the standalone walls, each executor's
   data plane (native or python) and the bytes fetched by path, with the
   card's name and power limit; the phase must stay under 120 s.  Each
   kernel's entry adds the remote paths' launches and checks.
   ``python3 chip_smoke.py --remote-only [FILE]`` runs the build, the data,
   the standalone runs of q1, q3 and q18 and this phase alone.

Each phase's seconds are printed on a line of their own as it ends
(``phase <name>: <s> s``: the build, the data, each group of paths, the
memory sweep, tpch22, the sqlite check, the oracles, each kernel's checks
and timings, and the CPU answers' child process, which runs beside the
paths), then all of them on one line.  The last lines are the nvidia-smi
line, a JSON object with one entry per kernel, the total seconds, and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import atexit
import contextlib
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
SF = 1.0
STRESS_ROWS = 6_000_000
WARM_RUNS = {"q1": 5, "q3": 3, "q4": 3, "pq_q1": 3, "pq_q3": 3, "pq_q4": 3, "pq_q18": 3,
             "sa_pq_q1": 3, "sa_pq_q3": 3, "sa_pq_q4": 3, "sa_pq_q18": 3, "sa_q18": 3}
# the paths of EXTRACT, the passthrough partial and the spill (one warm run
# each), and the 22 TPC-H queries
EXTRACT_QUERIES = (7, 8, 9)
SPILL_QUERIES = (3, 4, 9, 18, 21)
# the spill paths: every join partitioned (at SF1 the default 4M-row
# threshold broadcasts every join of these five queries, and a broadcast
# build is exempt from the governor, as in the reference), under a 1 MiB
# host budget; each held against the same settings with no budget
SPILL_SETTINGS = {"ballista.join.broadcast_threshold": "0"}
SPILL_BUDGET = {"ballista.memory.host.budget.bytes": str(1 << 20)}
# the memory sweep (the JAX package's tools/memory_sweep.py leg): the 22
# queries through the local engine over parquet with its settings, 2^20-row
# batches, under SPILL_BUDGET, each held bit for bit against no budget.
# Both legs read the files (scan cache off): batches of 2^20 rows would
# be new cache entries and evict those the other paths' check holds
MEMSWEEP_SETTINGS = {"ballista.batch.size": str(1 << 20), "ballista.scan.cache.bytes": "0"}
for _q in EXTRACT_QUERIES:
    WARM_RUNS[f"pq_q{_q}"] = WARM_RUNS[f"sa_q{_q}"] = 3
WARM_RUNS["sa_q20"] = WARM_RUNS["sa_pt"] = 3
# the spill paths run cold only: their check is the cold run against its
# unlimited run, bit for bit, and a warm run each cost about 112 s at SF1
# of a script whose limit is 1200 s
for _q in SPILL_QUERIES:
    WARM_RUNS[f"spill_q{_q}"] = 0
# the spill paths read TPC-H at this scale factor (at most the run's): at
# SF1 their cold runs took 27-74 s each; a quarter of the rows still spill
# every operator they did under the 1 MiB budget, and every result is held
# against the same query with no budget (the memory sweep stays at the
# run's scale: at 2^20-row batches a quarter of SF1 lineitem is about two
# batches, too few for its multi-batch spills)
SPILL_SF = 0.25
# kernels (launch counters of ops/kernels.py) each main path must launch
PATH_KERNELS = {
    "q1": ("dense_group_states", "compaction_order", "hash64", "sort_order"),
    "q3": ("compaction_order", "hash64", "sort_order", "build_side_sort", "probe_join",
           "grouped_on_order"),
    "q4": ("dense_group_states", "build_side_sort", "probe_join", "segment_any"),
    "pq_q18": ("compaction_order", "hash64", "sort_order", "build_side_sort", "probe_join",
               "segment_any", "grouped_on_order", "presorted_disorder", "key_range_check",
               "clustered_keep"),
}
for _q in ("q1", "q3", "q4"):
    PATH_KERNELS[f"pq_{_q}"] = PATH_KERNELS[_q]
# the standalone engine: K13 on q1's partial (dense) and on q18's subquery
# partial over in-memory tables (sort path, then K4 + K8), K12 on q18's
# HAVING; K3 buckets and K2 compacts every shuffle writer's rows
PATH_KERNELS.update({
    "sa_pq_q1": ("fused_agg", "dense_group_states", "compaction_order", "hash64",
                 "sort_order"),
    "sa_pq_q3": PATH_KERNELS["q3"],
    "sa_pq_q4": ("dense_group_states", "build_side_sort", "probe_join", "segment_any",
                 "compaction_order"),
    "sa_pq_q18": ("fused_rows", "compaction_order", "hash64", "sort_order", "build_side_sort",
                  "probe_join", "grouped_on_order", "presorted_disorder", "key_range_check",
                  "clustered_keep"),
    "sa_q18": ("fused_agg", "fused_rows", "compaction_order", "hash64", "sort_order",
               "build_side_sort", "probe_join", "grouped_on_order"),
})
# EXTRACT: in the standalone engine it is traced into the generated K13
# source (checked on the source), so K13 must launch;
# in the local engine it is traced into K19's generated programs,
# checked on the sources, as K14's row function; K14 itself then launches
# on no path and is held against its twin at its stress shapes
for _q in EXTRACT_QUERIES:
    PATH_KERNELS[f"pq_q{_q}"] = ("build_side_sort", "probe_join")
    PATH_KERNELS[f"sa_q{_q}"] = ("fused_agg", "hash64", "compaction_order")
# q20's lineitem partial barely reduces (SF1, six partitions): the first
# task latches, the later tasks emit per-row states; every state of q20's
# partial is an input column (two int64 keys, the sum of a non-null
# int64), so K15 has nothing to write and does not launch there
PATH_KERNELS["sa_q20"] = ("fused_agg", "hash64")
# a GROUP BY on lineitem's key (l_orderkey, l_linenumber) never reduces:
# the later tasks' per-row states include a computed sum and count(*),
# which K15 writes
PT_QUERY = """select count(*) as groups, sum(rev) as rev, sum(n) as n, min(first_ship) as first_ship
from (select l_orderkey, l_linenumber, sum(l_extendedprice * (1 - l_discount)) as rev,
             count(*) as n, min(l_shipdate) as first_ship
      from lineitem group by l_orderkey, l_linenumber) as per_line"""
PATH_KERNELS["sa_pt"] = ("fused_agg", "passthrough_rows", "hash64")
PASSTHROUGH_PATHS = ("sa_q20", "sa_pt")
for _q in SPILL_QUERIES:
    PATH_KERNELS[f"spill_q{_q}"] = ("compaction_order",)
# the spilled joins' partitions and pack order (K16's ordered form) must
# launch on at least one spill path; its first form (spill_partition)
# launches on no path and is held against its twin at its stress shapes
SPILL_KERNELS = ("spill_order",)
# the paths whose largest folded verdict (K7 with the probe mask) must
# queue K7's two kernels and nothing else
FOLDED_VERDICT_PATHS = ("q4", "pq_q4", "mesh4_q18")
# the paths whose largest K17 call must queue K17's two kernels and nothing
# else (the parent queued four: count, scan, tail and scatter)
DISPATCH_CALL_PATHS = ("mesh4_q3", "mesh4_q3_part", "mesh4_q18")
# the paths whose largest presorted grouping must queue K2's, K9's and K8's
# kernels and nothing else (the parent cast K2's order, gathered the mask
# and the keys, and cleared K9's flag by a memset)
PRESORTED_CALL_PATHS = ("pq_q18", "sa_pq_q18")
# the paths whose dense merge (the mesh's dense aggregate: every state, the
# exists counts and the bad flag) must queue one K18 kernel and nothing
# else (the parent queued one K18 kernel a column and a torch compare)
MERGE_CALL_PATHS = ("mesh_q1", "mesh4_q1")
PATH_KERNELS["memsweep"] = ("compaction_order",)
# K19-K22 on every path of the local engine: the scan filters, projections,
# aggregate operands, join verification and repartition keys as generated
# programs (K19), concat (K20), shrink / pack / sort and join gathers (K21)
# and the repartition's bucket masks (K22); the standalone writers pack
# through K21
_LOCAL_NEW = ("operator_program", "concat_columns", "gather_columns", "bucket_masks")
for _p in ("q1", "q3", "q4", "pq_q1", "pq_q3", "pq_q4", "pq_q18"):
    PATH_KERNELS[_p] = PATH_KERNELS[_p] + _LOCAL_NEW
# K22's binary forms: q3's and q18's LIMIT (the window); a semi or anti
# verdict folds its mask into K7, so q4 launches none, and the and /
# or forms run where a spilled semi or anti join merges its partitions'
# verdicts (spill_q4, spill_q21)
for _p in ("q3", "pq_q3", "pq_q18"):
    PATH_KERNELS[_p] = PATH_KERNELS[_p] + ("mask_ops",)
# q7-q9 repartition nothing over parquet at these partitions (no K22)
for _q in EXTRACT_QUERIES:
    PATH_KERNELS[f"pq_q{_q}"] = PATH_KERNELS[f"pq_q{_q}"] + _LOCAL_NEW[:3]
for _p in ("sa_pq_q1", "sa_pq_q3", "sa_pq_q4", "sa_pq_q18", "sa_q18"):
    PATH_KERNELS[_p] = PATH_KERNELS[_p] + ("gather_columns",)
# csv (SF1, the TPC-H schema given), json and avro (SF0.01, pure-Python
# avro): the local engine over the new scans; the standalone engine over csv
CSV_TABLES = ("lineitem", "orders", "customer")
# One csv file is one scan partition (as in the JAX package: a partition a
# file), so q1 over csv plans no repartition (no K3 or K22) and q3 none on
# lineitem's side
PATH_KERNELS.update({
    "csv_q1": ("dense_group_states", "compaction_order", "sort_order", "operator_program",
               "gather_columns"),
    "csv_q3": ("compaction_order", "hash64", "sort_order", "build_side_sort", "probe_join",
               "grouped_on_order", "operator_program", "gather_columns"),
    "sa_csv_q1": ("compaction_order", "sort_order")})
WARM_RUNS.update({"csv_q1": 3, "csv_q3": 3, "sa_csv_q1": 3})
SCAN_TYPES = ("ParquetScanExec", "CsvScanExec", "JsonScanExec", "AvroScanExec")
PATH_KERNELS["tpch22"] = ("fused_agg", "fused_rows", "hash64", "compaction_order",
                          "sort_order", "build_side_sort", "probe_join", "segment_any")
# the mesh (ballista.shuffle.mesh with no row floor, over parquet): on the
# default mesh (every card; the machine has one) and on MESH_RANKS ranks
# over cuda:0, which measures the exchange's overhead and no speed-up
# across cards.  q1 takes the dense reduce (K1 per rank, K18 merges); q3
# with every join on the mesh, once with the default broadcast_rows (small
# build sides all_gathered) and once with 0 (every join partitioned, K17 on
# both sides); q18's GROUP BY l_orderkey (1.5M groups at SF1) the hashed
# path (K17), with agg.capacity raised as the reference needs; and the
# standalone engine's hybrid mode (the mesh inside each task: the partial
# aggregate and the partitioned joins)
MESH_SETTINGS = {"ballista.shuffle.mesh": "true", "ballista.shuffle.mesh.min_rows": "0"}
MESH_JOINS = {**MESH_SETTINGS, "ballista.join.broadcast_threshold": "0"}
# q3's first mesh run: with the broadcast threshold at 0 no join swaps its
# sides, so q3's build sides are orders (~727k rows after the date filter
# at SF1) and lineitem (~3.2M): at the default broadcast_rows (2^18) both
# are partitioned; at 2^20 orders is all_gathered and lineitem partitioned
# (scaled with the scale factor, so a rehearsal at a small one keeps both)
MESH_Q3_BROADCAST_ROWS = 1 << 20
MESH_RANKS = 4
MESH_PARQUET = ("mesh_q1", "mesh4_q1", "mesh4_q3", "mesh4_q3_part", "mesh4_q18", "sa_hybrid_q3")
MESH4_PATHS = ("mesh4_q1", "mesh4_q3", "mesh4_q3_part", "mesh4_q18", "sa_hybrid_q3")
MESH_METRICS = ("mesh_devices", "dense_reduce_collective", "broadcast_joins",
                "partitioned_joins", "capacity_recompiles")
_MESH_Q1 = ("mesh_derive", "dense_group_states", "merge_rank_states", "compaction_order",
            "sort_order")
PATH_KERNELS.update({
    "mesh_q1": _MESH_Q1, "mesh4_q1": _MESH_Q1,
    "mesh4_q3": ("dispatch_to_buckets", "hash64", "build_side_sort", "probe_join", "sort_order",
                 "grouped_on_order"),
    "mesh4_q3_part": ("dispatch_to_buckets", "hash64", "build_side_sort", "probe_join"),
    "mesh4_q18": ("dispatch_to_buckets", "sort_order", "grouped_on_order", "build_side_sort",
                  "probe_join", "segment_any"),
    "sa_hybrid_q3": ("mesh_derive", "hash64", "build_side_sort", "probe_join"),
})
for _p in ("mesh_q1", *MESH4_PATHS):
    WARM_RUNS[_p] = 3
# the form K13 must take on a path (dense key domain, or the sort path)
K13_FORM = {"sa_pq_q1": "dense", "sa_q18": "sort"}
# rows a parquet row group holds at SF1 (benchmarks/tpch.py convert's
# default: lineitem in 12 row groups); scaled with the scale factor so a
# rehearsal at a small one keeps the same partitions
ROW_GROUP_ROWS = 1 << 19
PARQUET_TABLES = ("lineitem", "orders", "customer", "part", "partsupp", "supplier", "nation",
                  "region")
ROOT = os.path.dirname(os.path.abspath(__file__))


# seconds of each phase of the run, in the order they end
PHASE_S = {}


def phase_done(name: str, t0: float) -> float:
    """Logs (on a line of its own) and adds up the seconds since ``t0`` of
    the phase ``name``; returns them."""
    secs = time.perf_counter() - t0
    PHASE_S[name] = PHASE_S.get(name, 0.0) + secs
    log(f"phase {name}: {secs:.1f} s")
    return secs


def path_group(path: str) -> str:
    """The phase a main path's seconds count under."""
    if path.startswith("spill_"):
        return "paths_spill"
    if path.startswith(("mesh", "sa_hybrid")):
        return "paths_mesh"
    if "csv" in path:
        return "paths_csv"
    if path in ("sa_q20", "sa_pt"):
        return "paths_passthrough"
    if path in {p for q in EXTRACT_QUERIES for p in (f"pq_q{q}", f"sa_q{q}")}:
        return "paths_extract"
    return "paths_standalone" if path.startswith("sa_") else "paths_local"


class RepartitionBatches:
    """Counts, while active, the batches each local hash repartition
    splits and the partitions it splits them into (wrapping
    ``RepartitionExec._materialize``): K22's bucket form must launch once a
    batch, not once a batch and partition."""

    def __enter__(self):
        from arrow_ballista_tpu_torch.ops import shuffle

        self.cls = shuffle.RepartitionExec
        self.orig = self.cls._materialize
        self.splits = []  # (batches, partitions) of each hash repartition
        orig, splits = self.orig, self.splits

        def materialize(op, ctx):
            orig(op, ctx)
            if op.partitioning.kind == "hash" and op.partitioning.count > 1:
                splits.append((len(op._cache[0]), op.partitioning.count))

        self.cls._materialize = materialize
        return self

    def __exit__(self, *exc):
        self.cls._materialize = self.orig


class SpillSplitCheck:
    """Watches, while active, the spilled joins' build split: the batch of
    each ``spill_order`` call (K16's ordered form) must be packed through
    the order it returned (the next ``pack_for_host`` call on the thread
    gets it) with no K2 call in between; counts the calls, the packs that
    got the order and the K2 calls in the split."""

    NAMES = ("spill_order", "pack_for_host", "compaction_order")

    def __enter__(self):
        import threading

        from arrow_ballista_tpu_torch.ops import kernels as K

        self.K = K
        self.orig = {n: getattr(K, n) for n in self.NAMES}
        self.calls = self.packed = self.k2 = 0
        lock, local, orig = threading.Lock(), threading.local(), self.orig

        def spill_order(*a, **kw):
            out = orig["spill_order"](*a, **kw)
            local.open = True
            with lock:
                self.calls += 1
            return out

        def pack_for_host(*a, **kw):
            if getattr(local, "open", False):
                local.open = False
                given = (len(a) > 6 and a[6] is not None) or kw.get("order") is not None
                with lock:
                    self.packed += int(given)
            return orig["pack_for_host"](*a, **kw)

        def compaction_order(*a, **kw):
            if getattr(local, "open", False):
                with lock:
                    self.k2 += 1
            return orig["compaction_order"](*a, **kw)

        for name, fn in (("spill_order", spill_order), ("pack_for_host", pack_for_host),
                         ("compaction_order", compaction_order)):
            setattr(K, name, fn)
        return self

    def __exit__(self, *exc):
        for name, fn in self.orig.items():
            setattr(self.K, name, fn)


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


# K4 and K5, on the shared radix core (csrc/radix.cuh): their wrappers'
# CUDA kernels by name (the k4_radix / k5_radix namespaces of radix.cuh),
# so that a profile gives each one's device time, and the names of the
# kernels this core replaced (K4's merge sort; K5's LSD radix sort, whose
# scans are the ab_scan kernels of <int, int> arguments, which nothing
# else launches), so that tools/torch_wall_compare.py reads an older tree
# too; their plans (form, composite bits, passes) are recorded
RADIX_PLANS = []  # every call held against its twin: its plan
RADIX_KERNELS = {
    "sort_order": ("sort_minmax", "sort_pack", "sort_block", "sort_identity", "k4_radix::",
                   "sort_prepare", "merge_pass"),
    "build_side_sort": ("build_upfront", "build_block", "k5_radix::", "build_hash_kernel",
                        "radix_histogram", "radix_scatter", "zero_u64",
                        "ab_scan_tile_sums<int, int>", "ab_scan_tile_apply<int, int, int>"),
}


# K10 and K11 by CUDA kernel name (the same in the parent of their
# redesign), for their launches and device ms per profiled query and the
# memsets queued right before them on their stream: since the redesign a
# call is one kernel and no memset
CLUSTERED_KERNELS = {"key_range_check": "key_range_check<", "clustered_keep": "clustered_keep<"}


def clustered_trace(prof) -> dict:
    """K10's and K11's kernels in a torch.profiler trace: per kernel its
    launches, their device ms, and the memsets (count and device ms) that
    sit on the same stream right before one of them."""
    import torch

    streams = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            streams.setdefault(ev.device_resource_id, []).append(ev)
    out = {name: {"launches": 0, "ms": 0.0, "memsets": 0, "memset_ms": 0.0}
           for name in CLUSTERED_KERNELS}
    for evs in streams.values():
        evs.sort(key=lambda e: e.time_range.start)
        for prev, ev in zip([None] + evs[:-1], evs):
            for name, part in CLUSTERED_KERNELS.items():
                if part not in ev.name:
                    continue
                rec = out[name]
                rec["launches"] += 1
                rec["ms"] += ev.time_range.elapsed_us() / 1000
                if prev is not None and "memset" in prev.name.lower():
                    rec["memsets"] += 1
                    rec["memset_ms"] += prev.time_range.elapsed_us() / 1000
    return out


# K6, K2, K8 and K22's bucket form by CUDA kernel name, this tree's and
# those of the parent of their redesign (K6: probe_bounds, the <long long>
# scans, a D2D copy, probe_expand and probe_fill; K2: two scan kernels of
# <unsigned char, int> and <int> and tile_scatter; K8: seg_init,
# seg_boundary, the same two scans and ab_scan_tile_apply, seg_accumulate
# and seg_finish; K22's bucket form: mask_kernel<4>, one a partition), so
# that tools/torch_wall_compare.py reads both trees.  "shared" kernels
# count as the kernel's only right before one of its "shared_before"
# kernels on its stream, in the same call.
CALL_KERNELS = {
    "probe_join": {"own": ("k6_probe_", "probe_bounds", "probe_expand", "probe_fill",
                           "ab_scan_tile_sums<long long", "ab_scan_tile_offsets<long long",
                           "ab_scan_tile_apply<long long"), "shared": (), "shared_before": ()},
    "compaction_order": {"own": ("k2_compact_", "tile_scatter"),
                         "shared": ("ab_scan_tile_sums<unsigned char, int>",
                                    "ab_scan_tile_offsets<int>"),
                         "shared_before": ("tile_scatter",)},
    "grouped_on_order": {"own": ("k8_seg_", "seg_init", "seg_boundary", "seg_keyless_first",
                                 "seg_accumulate", "seg_finish",
                                 "ab_scan_tile_apply<unsigned char, int, int>"),
                         "shared": ("ab_scan_tile_sums<unsigned char, int>",
                                    "ab_scan_tile_offsets<int>"),
                         "shared_before": ("ab_scan_tile_apply<unsigned char, int, int>",)},
    "bucket_masks": {"own": ("bucket_masks_kernel", "mask_kernel<4>"), "shared": (),
                     "shared_before": ()},
}


# K1's and K13's dense form by CUDA kernel name: the one-launch kernel and
# the parent's init and accumulate kernels (the parent's finish, K2 and
# torch glue, runs after them under other names)
DENSE_KERNELS = {
    "dense_group_states": ("k1_dense<ColumnSource", "dense_init<ColumnSource",
                           "dense_shared<ColumnSource", "dense_global<ColumnSource"),
    "fused_agg_dense": ("k1_dense<AbGenSource", "dense_init<AbGenSource",
                        "dense_shared<AbGenSource", "dense_global<AbGenSource"),
}
DENSE_PATHS = ("q1", "pq_q1", "q4", "sa_pq_q1", "sa_csv_q1")  # and memsweep's q1
# the parent of the one-launch redesign, as its own chip_smoke.py read it
# on an H100 80GB HBM3 at 700.00 W (its last chip call): printed beside
# this run's times; tools/dense_timing.py times both trees in one call
PARENT_DENSE_MS = {"dense_group_states": (0.4368, "K1's kernels alone at sa_csv_q1's "
                                                  "6,291,456-row call, its finish not counted"),
                   "fused_agg": (0.2306, "K13's dense form at sa_pq_q1's 1,048,576-row call")}
DENSE_ONE_LAUNCH = ("q1", "pq_q1", "sa_pq_q1")


def dense_trace(prof) -> dict:
    """K1's (``dense_group_states``) and K13's dense form's
    (``fused_agg_dense``) kernels in a torch.profiler trace: per form its
    launches, their device ms, the parent's init kernels among them, the
    memsets right before one on its stream and the K2 kernels right after
    one."""
    import torch

    streams = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            streams.setdefault(ev.device_resource_id, []).append(ev)
    out = {name: {"launches": 0, "ms": 0.0, "inits": 0, "memsets": 0, "k2_after": 0}
           for name in DENSE_KERNELS}
    for evs in streams.values():
        evs.sort(key=lambda e: e.time_range.start)
        for i, ev in enumerate(evs):
            for name, parts in DENSE_KERNELS.items():
                if not any(p in ev.name for p in parts):
                    continue
                rec = out[name]
                rec["launches"] += 1
                rec["ms"] += ev.time_range.elapsed_us() / 1000
                rec["inits"] += "dense_init<" in ev.name
                if i > 0 and "memset" in evs[i - 1].name.lower():
                    rec["memsets"] += 1
                if i + 1 < len(evs) and "k2_compact_" in evs[i + 1].name:
                    rec["k2_after"] += 1
    return out


def check_dense_trace(trace: dict, label: str) -> None:
    """Fails unless each K1 and K13 dense call of the profiled query was one
    kernel, with no init kernel or memset before it (a K2 kernel right
    after one is reported, not failed: the next operator may compact the
    aggregate's output; ``dense_call_activities`` counts what one call
    queues)."""
    bad = [f"{name}: {json.dumps(rec)}" for name, rec in trace.items()
           if rec["launches"] != rec["wrapper_calls"] or rec["inits"] or rec["memsets"]]
    if not any(rec["wrapper_calls"] for rec in trace.values()):
        bad.append("no dense aggregate call")
    if bad:
        fail(f"{label}'s profiled query: one kernel a dense aggregate call expected: "
             + "; ".join(bad))


def queued_torch_ops():
    """A TorchDispatchMode that records, while active, every aten op that
    may queue device work: all but allocations (``empty``) and views.  The
    kernels' own launches go through ctypes and are not aten ops."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class QueuedOps(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if not (func.is_view or func.overloadpacket.__name__ in
                    ("empty", "empty_strided", "empty_like")):
                self.ops.append(str(func))
            return func(*args, **(kwargs or {}))

    return QueuedOps()


DENSE_CALL_ITERS, DENSE_CALL_TRIES = 20, 3


def one_call_activities(K, fn, own: dict, kernels: tuple, label: str) -> tuple:
    """What one warm call of ``fn`` queues.  On the host: the aten ops that
    may queue device work (``queued_torch_ops``) and the wrapper counts
    that rose; at fault unless there is no such op and the counts that rose
    are ``own``.  On the card: the device activities by name from
    torch.profiler over ``DENSE_CALL_ITERS`` warm calls, after a spin
    kernel and a sync inside the profiled window (the profiler has lost the
    first launches of a window: 4 of 5 calls recorded on one machine, none
    of 5 on another), up to ``DENSE_CALL_TRIES`` windows until one records
    a call's activity; at fault unless every activity's name holds one of
    ``kernels`` and each comes at most once a call (the profiler may miss a
    launch; it never invents one), or when the spin was recorded but no
    call's activity in any window.  A profiler that recorded nothing at all
    is logged, and the host check stands.  Returns (record, at fault)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    before = dict(K.LAUNCHES)
    with queued_torch_ops() as host:
        fn()
    torch.cuda.synchronize()
    rose = {k: v - before.get(k, 0) for k, v in K.LAUNCHES.items() if v != before.get(k, 0)}
    rec = {"torch_ops": host.ops, "wrapper_counts": rose}
    bad = bool(host.ops) or rose != own
    for attempt in range(1, DENSE_CALL_TRIES + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(20_000_000)  # ~10 ms at 2 GHz
            torch.cuda.synchronize()
            for _ in range(DENSE_CALL_ITERS):
                fn()
            torch.cuda.synchronize()
        rows = device_rows(prof)
        spun = any("spin_kernel" in key for _ms, _c, key in rows)
        by = {key.split("(")[0][:60]: count / DENSE_CALL_ITERS
              for _ms, count, key in rows if "spin_kernel" not in key}
        rec.update(device=by, profiler_windows=attempt, spin_recorded=spun)
        if by:
            break
    if by and any(not any(k in key for k in kernels) or c > 1.0 for key, c in by.items()):
        bad = True
    elif not by and spun:
        bad = True
    elif not by:
        log(f"{label}: torch.profiler recorded no device activity in {DENSE_CALL_TRIES} "
            "windows of the call: the host check stands")
    return rec, bad


def dense_call_activities(K, F, calls: dict, label: str) -> dict:
    """``one_call_activities`` at the path's largest dense aggregate call
    of each form (K1's compacted form, K13's dense form): one K1 kernel a
    call (no memset, init, K2 or torch glue) and only the form's own
    launch counts."""
    out, bad = {}, []
    if "dense_grouped" in calls:
        args = calls["dense_grouped"][1]
        out["dense_grouped"], fault = one_call_activities(
            K, lambda: K.dense_grouped(*args), {"dense_group_states": 1}, ("k1_dense<",),
            f"{label} dense_grouped")
        if fault:
            bad.append("dense_grouped")
    if "fused_agg" in calls and K.dense_domain(calls["fused_agg"][1][5]) is not None:
        fargs = calls["fused_agg"][1]
        out["fused_agg"], fault = one_call_activities(
            K, lambda: F.fused_agg(*fargs), {"fused_agg": 1, "fused_agg_dense": 1}, ("k1_dense<",),
            f"{label} fused_agg")
        if fault:
            bad.append("fused_agg")
    if not out or bad:
        fail(f"{label}: dense aggregate calls queued {json.dumps(out)} (one K1 kernel a call, "
             f"no torch op that may queue device work, and only the form's own launch counts "
             f"expected; at fault: {', '.join(bad) or 'no call captured'})")
    return out


def verdict_call_activities(K, calls: dict, label: str) -> dict:
    """``one_call_activities`` at the path's largest folded verdict (K7
    with the probe mask of a semi, anti or left join): K7's two kernels,
    each at most once a call, no torch op and only K7's count.  The parent
    queued three activities (clear, mark, K22's and), on the mesh four
    (clear, mark and two torch ops)."""
    if "segment_any" not in calls or calls["segment_any"][1][3] is None:
        fail(f"{label}: no folded verdict captured (K7 with the probe mask)")
    args = calls["segment_any"][1]
    rec, bad = one_call_activities(K, lambda: K.segment_any(*args), {"segment_any": 1},
                                   ("k7_mark<", "k7_verdict"), label)
    rec.update(rows=int(args[0].shape[0]), segments=int(args[2]), negate=bool(args[4]))
    if bad:
        fail(f"{label}: a folded verdict queued {json.dumps(rec)} (K7's two kernels, no torch "
             "op and only K7's count expected)")
    return rec


def dispatch_call_activities(K, calls: dict, label: str) -> dict:
    """``one_call_activities`` at the path's largest K17 call: its count
    and its scatter kernel, each at most once a call, two launches on the
    host, no torch op that may queue device work and only K17's count."""
    if "dispatch_to_buckets" not in calls:
        fail(f"{label}: no K17 call captured")
    args = calls["dispatch_to_buckets"][1]
    rec, bad = one_call_activities(K, lambda: K.dispatch_to_buckets(*args),
                                   {"dispatch_to_buckets": 1}, ("k17_count<", "k17_scatter<"),
                                   label)
    rec.update(rows=int(args[2].shape[0]), destinations=int(args[3]), capacity=int(args[4]),
               plan=K.kernel_plan("dispatch_to_buckets"))
    if bad or rec["plan"].get("launches") != 2 or sum(rec["device"].values()) > 2:
        fail(f"{label}: a K17 call queued {json.dumps(rec)} (its count and scatter kernels, "
             "no memset or torch op, and only K17's count expected)")
    return rec


def merge_call_activities(K, calls: dict, label: str) -> dict:
    """``one_call_activities`` at the path's largest dense merge (the
    ``reduce_columns`` collective: every aggregate state, the exists counts
    and the bad flag): one K18 kernel, one launch on the host, no torch op
    that may queue device work (the parent's compare ``exists > 0``
    included) and only K18's count."""
    from arrow_ballista_tpu_torch.parallel import collectives as C

    if "reduce_columns" not in calls:
        fail(f"{label}: no dense merge captured")
    args = calls["reduce_columns"][1]
    rec, bad = one_call_activities(K, lambda: C.reduce_columns(*args), {"merge_rank_states": 1},
                                   ("k18_merge",), label)
    rec.update(ranks=len(args[0]), columns=len(args[0][0]),
               slots=int(sum(x.numel() for x in args[0][0])),
               plan=K.kernel_plan("merge_rank_columns"))
    if bad or rec["plan"].get("launches") != 1 or sum(rec["device"].values()) > 1:
        fail(f"{label}: a dense merge queued {json.dumps(rec)} (one K18 kernel, no memset, copy "
             "or torch op, and only K18's count expected)")
    return rec


def presorted_call_activities(K, calls: dict, label: str) -> dict:
    """``one_call_activities`` at the path's largest presorted grouping:
    K2's, K9's and K8's kernels and nothing else (no cast, gather or
    memset for K9), and only the three wrappers' counts, one each."""
    if "grouped_aggregate_presorted" not in calls:
        fail(f"{label}: no presorted grouping captured")
    args = calls["grouped_aggregate_presorted"][1]
    own = {"compaction_order": 1, "presorted_disorder": 1, "grouped_on_order": 1}
    rec, bad = one_call_activities(K, lambda: K.grouped_aggregate_presorted(*args), own,
                                   ("k2_compact_", "k9_disorder<", "k8_seg_"), label)
    rec.update(rows=int(args[2].shape[0]))
    if bad:
        fail(f"{label}: a presorted grouping queued {json.dumps(rec)} (K2's, K9's and K8's "
             "kernels, no cast, gather, memset or other torch op expected)")
    return rec


def call_trace(prof) -> dict:
    """K6's and K2's kernels in a torch.profiler trace: per kernel its
    launches and device ms (a shared scan kernel counted only right before
    one of its own on the same stream), by kernel name, and the memsets and
    device-to-device copies (the parent's K6 copied its total so) that sit
    on that stream right before one of its kernels (a table's upload before
    a query's first compaction is not the kernel's)."""
    import torch

    streams = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            streams.setdefault(ev.device_resource_id, []).append(ev)
    out = {name: {"launches": 0, "ms": 0.0, "memsets": 0, "memset_ms": 0.0, "copies": 0,
                  "copy_ms": 0.0, "by_kernel": {}} for name in CALL_KERNELS}
    for evs in streams.values():
        evs.sort(key=lambda e: e.time_range.start)
        taken = set()
        for i, ev in enumerate(evs):
            for name, parts in CALL_KERNELS.items():
                if not any(p in ev.name for p in parts["own"]):
                    continue
                rec = out[name]
                group = [i]
                j = i - 1  # the call's shared kernels run right before its own
                shares = any(p in ev.name for p in parts["shared_before"])
                while shares and j >= 0 and j not in taken and any(p in evs[j].name
                                                                    for p in parts["shared"]):
                    group.append(j)
                    j -= 1
                for k in group:
                    taken.add(k)
                    key = evs[k].name.split("(")[0][:60]
                    ms = evs[k].time_range.elapsed_us() / 1000
                    rec["launches"] += 1
                    rec["ms"] += ms
                    cnt, tot = rec["by_kernel"].get(key, (0, 0.0))
                    rec["by_kernel"][key] = (cnt + 1, tot + ms)
                if j >= 0 and j not in taken:
                    lower = evs[j].name.lower()
                    kind = ("memsets", "memset_ms") if "memset" in lower else \
                        ("copies", "copy_ms") if "memcpy dtod" in lower else None
                    if kind is not None:
                        taken.add(j)
                        rec[kind[0]] += 1
                        rec[kind[1]] += evs[j].time_range.elapsed_us() / 1000
    return out


def check_call_trace(trace: dict, label: str) -> None:
    """Fails unless each K6 call was its fused kernel and at most the fill
    (probe_join), each K2 call one kernel (one launch) or a count pass and
    its scatter, and each K8 call its fused kernel and its fill, with no
    memset or copy before them."""
    k6, k2, k8 = trace["probe_join"], trace["compaction_order"], trace["grouped_on_order"]
    by6, by2, by8 = k6["by_kernel"], k2["by_kernel"], k8["by_kernel"]

    def launches(by, part):  # K6's fused kernel is a template: one name per tile size
        return sum(v[0] for k, v in by.items() if part in k)

    fused, fill = launches(by6, "k6_probe_fused"), launches(by6, "k6_probe_fill")
    one = launches(by2, "k2_compact_one")
    count, scatter = launches(by2, "k2_compact_count"), launches(by2, "k2_compact_scatter")
    bad = []
    if k6["launches"] != fused + fill or fused != k6.get("wrapper_calls", fused) or fill > fused:
        bad.append(f"K6 ran {json.dumps(by6)} for {k6.get('wrapper_calls')} calls")
    if k2["launches"] != one + count + scatter or count != scatter or \
            one + count != k2.get("wrapper_calls", one + count):
        bad.append(f"K2 ran {json.dumps(by2)} for {k2.get('wrapper_calls')} calls")
    fused8, fill8 = launches(by8, "k8_seg_fused"), launches(by8, "k8_seg_fill")
    if k8["launches"] != fused8 + fill8 or fused8 != fill8 or \
            fused8 != k8.get("wrapper_calls", fused8):
        bad.append(f"K8 ran {json.dumps(by8)} for {k8.get('wrapper_calls')} calls")
    for name, rec in trace.items():
        if rec["memsets"] or rec["copies"]:
            bad.append(f"{name}: {rec['memsets']} memsets and {rec['copies']} copies right "
                       "before its kernels")
    if bad:
        fail(f"{label}'s profiled query: " + "; ".join(bad))


# --------------------------------------------------------------------------
# timing
# --------------------------------------------------------------------------


def time_ms(fn, device, iters: int = 20, reps: int = 5) -> float:
    """Wall time per call: median over ``reps`` of the mean time of
    ``iters`` back-to-back calls (warm), host work and launches included."""
    import torch

    fn()
    if device.type != "cuda":
        samples = []
        for _ in range(reps):
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            samples.append((time.perf_counter() - t0) * 1000 / iters)
        return statistics.median(samples)
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / iters)
    return statistics.median(samples)


def device_rows(prof):
    """(device ms, count, name) of each device-side activity (kernels,
    copies, memsets) of a torch.profiler run, largest first.  Operator
    rows are left out: they carry their children's device time again."""
    import torch

    rows = []
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0)
        if dev_us:
            rows.append((dev_us / 1000, ev.count, ev.key))
    return sorted(rows, reverse=True)


def device_ms(fn, iters: int = 20):
    """Device time per call, host time and launch gaps left out, as
    (ms, source).  First from torch.profiler: everything the card ran
    during ``iters`` warm calls (all the kernels, copies and memsets a call
    launches), over ``iters``.  When the profiler records no device time,
    from CUDA events around ``iters`` calls queued behind a spin kernel:
    the host enqueues them all while the card spins, so the card runs them
    back to back (checked: the spin must outlast the enqueueing).  Else
    (None, None)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = sum(r[0] for r in device_rows(prof))
    if total:
        return total / iters, "profiler"
    ms = queued_events_ms(fn, iters)
    return (ms, "queued_events") if ms is not None else (None, None)


def queued_events_ms(fn, iters: int = 20):
    """Device time per call from CUDA events around ``iters`` calls queued
    behind a spin kernel, or None when the host could not enqueue them all
    before the spin ended (the card would then have idled between calls)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)  # ~25 ms of spinning at 2 GHz
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    queued = not start.query()  # the card was still spinning: no gaps
    end.synchronize()
    return start.elapsed_time(end) / iters if queued else None


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def dense_bytes(keys, vals, mask, rows, compacted=True) -> int:
    """The bytes K1 must move: the keys, the values (a count reads none)
    and the mask once; the compacted form writes ``rows`` rows of keys,
    values and mask once, the slot-aligned one ``rows`` (the domain) slots
    of values and exists counts and its flag."""
    read = nbytes(*keys, mask) + sum(nbytes(v) for v, how in vals if how != "count")
    widths = sum(8 if how == "count" else v.element_size() for v, how in vals)
    if compacted:
        return read + rows * (sum(k.element_size() for k in keys) + widths + 1)
    return read + rows * (widths + 4) + 1


def grouped_on_order_bytes(keys, vals, mask, cap, n, order) -> int:
    """The bytes K8 must move: the order (int32) read once; through it the
    mask of every row, the keys of the live rows and of the rows before
    them (a live row opens a group when its key differs from the row
    before), and the values (not the counts) of the live rows; each slot's
    keys, values and mask bit written once, and the group count.  Read
    through the order, a column costs the 32-byte sectors that the needed
    rows touch, each once."""
    import torch

    rows = order.long()
    live = mask[rows]
    near = live.clone()
    near[:-1] |= live[1:]

    def sectors(col, needed):
        return 32 * torch.unique(rows[needed] * col.element_size() // 32).numel()

    out_w = sum(k.element_size() for k in keys) + sum(
        8 if how == "count" else v.element_size() for v, how in vals) + 1
    moved = nbytes(order) + sectors(mask, torch.ones_like(live)) + sum(
        sectors(k, near) for k in keys) + sum(
        sectors(v, live) for v, how in vals if how != "count")
    return moved + cap * out_w + 8


def bucket_masks_bytes(mask, num_out) -> int:
    """The bytes K22's bucket form must move: the mask and the int32
    buckets read once (5 bytes a row), and each partition's mask written
    once."""
    n = mask.shape[0]
    return 5 * n + num_out * n


def probe_join_bytes(ph, pm, bh, cap) -> int:
    """The bytes K6's ``probe_join`` must move on these inputs: the mask,
    the hashes of the live probe rows and of row n-1 (whose lower bound the
    slots past the total need), each build row whose hash a live probe row
    matches, read once, 9 bytes a pair slot written, and the total."""
    import torch

    live = int(pm.sum())
    searched = live + (0 if bool(pm[-1]) else 1)
    matched = int(torch.isin(bh, ph[pm]).sum()) if live else 0
    return nbytes(pm) + 8 * (searched + matched) + 9 * cap + 8


# --------------------------------------------------------------------------
# capture of the main path's kernel inputs
# --------------------------------------------------------------------------


def _clone(x):
    import torch

    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, (list, tuple)):
        return type(x)(_clone(v) for v in x)
    if isinstance(x, dict):
        return {k: _clone(v) for k, v in x.items()}
    return x


def _tensors(x):
    import torch

    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _tensors(v)]
    return []


# the wrappers whose call sizes each path reports, by power of two: how far
# the largest call stands for the rest
SIZED_CALLS = ("compaction_order", "probe_join", "probe_counts", "spill_order")
# wrappers whose keyword arguments are kept, bound into positional ones
# (K7's fold; the pack's precomputed order)
BOUND_KWARGS = ("segment_any", "pack_for_host")


def civil_key(wrapper: str, prog) -> str:
    """A generated program that inlines EXTRACT: its wrapper, its label (a
    K19 program) and its source's digest."""
    import hashlib

    digest = hashlib.sha256(prog.gen.source.encode()).hexdigest()[:10]
    return f"{wrapper}:{getattr(prog, 'label', '')}:{digest}"


def log_call_sizes(report, path, cap) -> None:
    if cap.sizes:
        sizes = {w: dict(sorted(h.items())) for w, h in cap.sizes.items()}
        report.setdefault("call_sizes", {})[path] = sizes
        log(f"{path} K2 / K6 calls by rows (rounded up to a power of two): {json.dumps(sizes)}")


class Capture:
    """Wraps the kernel wrappers of ops/kernels.py (and K12 / K13 of
    compile/fused.py) to keep (clones of) the arguments of the largest call
    each one gets, and to check that every tensor handed to a kernel on the
    path lies on the card.  The standalone engine calls them from its task
    threads: the records are taken under a lock.  For K13 it also records
    which form each call took (the dense key domain, or the sort path)."""

    # wrapper -> index of the argument whose first dimension sizes the call
    NAMES = {"dense_group_states": 2, "dense_grouped": 2, "compaction_order": 0, "bucket_of": 0,
             "hash64": 0, "sort_order": 1, "build_side_sort": 1, "probe_join": 0,
             "probe_counts": 0,
             "segment_any": 0, "grouped_on_order": 2, "presorted_disorder": 1,
             "grouped_aggregate_presorted": 2,
             "key_range_check": 1, "clustered_keep": 1, "extract_field": 0,
             "spill_partition": 0, "spill_order": 1, "dispatch_to_buckets": 2,
             "merge_rank_states": 0, "merge_rank_columns": 0,
             "concat_columns": 1, "gather_columns": 0, "pack_for_host": 1, "window_mask": 0,
             "mask_or": 0, "mask_and": 0, "mask_andnot": 0, "bucket_masks": 0}
    FUSED = {"fused_rows": 2, "fused_agg": 2, "passthrough_rows": 2, "mesh_derive": 3}
    # K19: recorded once overall and once per program (its label)
    PROGRAMS = {"operator_program": 2}
    # the mesh exchange's copies (parallel/collectives.py), sized by bytes,
    # and the dense merge, sized by slots
    COLLECTIVES = {"all_to_all": 0, "reduce_columns": 0}
    # the generated programs whose source inlines K14's civil core
    CIVIL = ("operator_program", "fused_rows", "fused_agg")

    def __init__(self, K, F, device):
        import threading

        from arrow_ballista_tpu_torch.compile import programs as P
        from arrow_ballista_tpu_torch.parallel import collectives as C

        self.K, self.F, self.C, self.P = K, F, C, P
        self.device = device
        self.calls = {}
        self.orig = {}
        self.off_device = []
        self.forms = {}  # K13 form -> calls
        self.radix = {}  # K4 / K5 -> "form bits/passes" -> calls
        self.sizes = {}  # K2 / K6 wrapper -> rows rounded up to a power of two -> calls
        self.civil = {}  # generated program with EXTRACT -> (rows, args) of its largest call
        self._lock = threading.Lock()

    def __enter__(self):
        sizes = {**self.NAMES, **self.FUSED, **self.COLLECTIVES, **self.PROGRAMS}
        for mod, names in ((self.K, self.NAMES), (self.F, self.FUSED),
                           (self.C, self.COLLECTIVES), (self.P, self.PROGRAMS)):
            for name in names:
                self.orig[name] = (mod, getattr(mod, name))
                setattr(mod, name, self._wrap(name, getattr(mod, name), sizes))
        return self

    def _wrap(self, name, fn, sizes):
        import inspect

        sig = inspect.signature(fn) if name in BOUND_KWARGS else None

        def wrapper(*args, **kwargs):
            if sig is not None:
                bound = sig.bind(*args, **kwargs)
                bound.apply_defaults()
                args, kwargs = tuple(bound.args), {}
            with self._lock:
                for t in _tensors(args):
                    if t.device.type != self.device.type:
                        self.off_device.append((name, str(t.device)))
                sized = args[sizes[name]]
                if name == "merge_rank_columns":  # slots over the columns
                    n = sum(xs[0].numel() for xs, _how in sized)
                elif name == "reduce_columns":  # slots over the first rank's columns
                    n = sum(x.numel() for x in sized[0])
                else:
                    n = (sized[0] if isinstance(sized, (list, tuple)) else sized).shape[0]
                if name == "all_to_all":
                    n = nbytes(*sized)
                if name == "concat_columns":  # every source's rows and the pad
                    n = sum(m.shape[0] for m in sized) + args[2]
                if name == "operator_program":
                    if args[0].kind == "columns" and not args[0].gen.outputs:
                        n = -1  # every output is an input column: no launch to check
                    key = f"operator_program:{args[0].label}"
                    if n >= 0 and (key not in self.calls or n > self.calls[key][0]):
                        self.calls[key] = (n, _clone(args))
                if name in ("passthrough_rows", "mesh_derive") and not args[0].gen.outputs:
                    n = -1  # every output is an input column: no launch to check
                if name in self.CIVIL and n >= 0 and "ab_civil_field(" in args[0].gen.source:
                    key = civil_key(name, args[0])
                    if key not in self.civil or n > self.civil[key][0]:
                        self.civil[key] = (n, _clone(args))
                if name == "fused_agg":
                    form = "dense" if self.K.dense_domain(args[5]) is not None else "sort"
                    self.forms[form] = self.forms.get(form, 0) + 1
                if name in SIZED_CALLS:
                    seen = self.sizes.setdefault(name, {})
                    bucket = 1 << max(n - 1, 0).bit_length()
                    seen[bucket] = seen.get(bucket, 0) + 1
                if n >= 0 and (name not in self.calls or n > self.calls[name][0]):
                    self.calls[name] = (n, _clone(args))
            out = fn(*args, **kwargs)
            plan = self.K.radix_plan(name, read_device=False) if name in RADIX_KERNELS else {}
            if plan:  # this thread's call (none on the CPU); no device read
                form = f"{plan['form']} {plan['steps']} steps" if "steps" in plan else \
                    f"{plan['form']} {plan['bits']} bits / {plan['passes']} passes"
                with self._lock:
                    seen = self.radix.setdefault(name, {})
                    seen[form] = seen.get(form, 0) + 1
            return out

        return wrapper

    def __exit__(self, *exc):
        for name, (mod, fn) in self.orig.items():
            setattr(mod, name, fn)


# --------------------------------------------------------------------------
# q1 and its numpy oracle
# --------------------------------------------------------------------------


def q1_oracle(lineitem):
    """q1 by numpy on the same generated arrays, in the engine's physical
    units: decimal sums as scaled int64, counts, float64 averages."""
    import numpy as np
    import pyarrow.compute as pc

    def cents(name, scale=2):
        fl = lineitem.column(name).cast("float64").to_numpy()
        return np.round(fl * 10 ** scale).astype(np.int64)

    qty, price, disc, tax = cents("l_quantity"), cents("l_extendedprice"), \
        cents("l_discount"), cents("l_tax")
    ship = lineitem.column("l_shipdate").cast("int32").to_numpy()
    rf = np.asarray(pc.cast(lineitem.column("l_returnflag"), "string").to_pylist(), dtype=object)
    ls = np.asarray(pc.cast(lineitem.column("l_linestatus"), "string").to_pylist(), dtype=object)
    keep = ship <= 10471  # date '1998-12-01' - interval '90' day
    out = {}
    for key in sorted(set(zip(rf[keep], ls[keep]))):
        m = keep & (rf == key[0]) & (ls == key[1])
        cnt = int(m.sum())
        disc_price = price[m] * (100 - disc[m])
        out[key] = {
            "sum_qty": int(qty[m].sum()),
            "sum_base_price": int(price[m].sum()),
            "sum_disc_price": int(disc_price.sum()),
            "sum_charge": int((disc_price * (100 + tax[m])).sum()),
            "avg_qty": float(qty[m].sum()) / 100.0 / cnt,
            "avg_price": float(price[m].sum()) / 100.0 / cnt,
            "avg_disc": float(disc[m].sum()) / 100.0 / cnt,
            "count_order": cnt,
        }
    return out


def check_q1(ctx, sql, oracle):
    """Run q1 through collect() and compare the raw physical columns."""
    return check_q1_batches(ctx.sql(sql).collect(), ctx.device, oracle)


def check_q1_batches(batches, device, oracle):
    """q1's result batches against the oracle (raw physical columns)."""
    import numpy as np

    rows = {}
    for b in batches:
        if b.device.type != device.type:
            fail(f"q1 result batch on {b.device}")
        data = b.compacted_numpy()
        rf = b.dicts["l_returnflag"][data["l_returnflag"]]
        ls = b.dicts["l_linestatus"][data["l_linestatus"]]
        for i in range(len(rf)):
            rows[(rf[i], ls[i])] = {k: data[k][i] for k in data}
    if list(rows) != list(oracle):
        fail(f"q1 groups {list(rows)} != oracle {list(oracle)}")
    worst = 0.0
    for key, want in oracle.items():
        got = rows[key]
        for col, v in want.items():
            if isinstance(v, int):
                if int(got[col]) != v:
                    fail(f"q1 {key} {col}: {int(got[col])} != {v}")
            else:
                rel = abs(float(got[col]) - v) / abs(v)
                worst = max(worst, rel)
                if not np.isfinite(got[col]) or rel > 1e-12:
                    fail(f"q1 {key} {col}: {got[col]} vs {v} (rel {rel:.3g})")
    return len(rows), worst


# --------------------------------------------------------------------------
# q3 and q4 and their numpy oracles
# --------------------------------------------------------------------------


def _days(iso: str) -> int:
    import numpy as np

    return int((np.datetime64(iso) - np.datetime64("1970-01-01")).astype(int))


def _cents(table, name):
    import numpy as np

    fl = table.column(name).cast("float64").to_numpy()
    return np.round(fl * 100).astype(np.int64)


def q3_oracle(tables):
    """q3's groups by numpy on the same generated arrays: {l_orderkey:
    (revenue as scale-4 int64, o_orderdate days, o_shippriority)}."""
    import numpy as np
    import pyarrow.compute as pc

    cust, orders, li = tables["customer"], tables["orders"], tables["lineitem"]
    cutoff = _days("1995-03-15")
    building = np.zeros(int(pc.max(cust.column("c_custkey")).as_py()) + 1, dtype=bool)
    seg = pc.equal(cust.column("c_mktsegment").cast("string"), "BUILDING").to_numpy(
        zero_copy_only=False)
    building[cust.column("c_custkey").to_numpy()[seg]] = True
    okey = orders.column("o_orderkey").to_numpy()
    odate = orders.column("o_orderdate").cast("int32").to_numpy()
    oship = orders.column("o_shippriority").to_numpy()
    keep_o = (odate < cutoff) & building[orders.column("o_custkey").to_numpy()]
    size = int(max(okey.max(), li.column("l_orderkey").to_numpy().max())) + 1
    order_ok = np.zeros(size, dtype=bool)
    order_ok[okey[keep_o]] = True
    date_of = np.zeros(size, dtype=np.int32)
    date_of[okey] = odate
    ship_of = np.zeros(size, dtype=np.int32)
    ship_of[okey] = oship
    lkey = li.column("l_orderkey").to_numpy()
    keep_l = (li.column("l_shipdate").cast("int32").to_numpy() > cutoff) & order_ok[lkey]
    rev = _cents(li, "l_extendedprice")[keep_l] * (100 - _cents(li, "l_discount")[keep_l])
    keys, inv = np.unique(lkey[keep_l], return_inverse=True)
    sums = np.zeros(keys.shape[0], dtype=np.int64)
    np.add.at(sums, inv, rev)
    return {int(k): (int(r), int(date_of[k]), int(ship_of[k])) for k, r in zip(keys, sums)}


def q3_rows(ctx, sql):
    """The engine's q3 rows in its physical units, in result order."""
    rows = []
    for b in ctx.sql(sql).collect():
        if b.device.type != ctx.device.type:
            fail(f"q3 result batch on {b.device}")
        scale = b.schema.field("revenue").dtype.scale
        if scale != 4:
            fail(f"q3 revenue has scale {scale}, the oracle computes scale 4")
        d = b.compacted_numpy()
        rows.extend(zip(d["l_orderkey"].tolist(), d["revenue"].tolist(),
                        d["o_orderdate"].tolist(), d["o_shippriority"].tolist()))
    return rows


def check_q3(ctx, sql, oracle):
    """Top 10 (revenue desc, date asc) and every group without the LIMIT
    (ordered by l_orderkey), exact."""
    top = q3_rows(ctx, sql)
    want_top = sorted(oracle.items(), key=lambda kv: (-kv[1][0], kv[1][1], kv[0]))[:10]
    # rows tied in (revenue, date) may come in either order: compare the
    # order of the sort keys and the set of rows
    if [(r, d) for _, r, d, _ in top] != [(v[0], v[1]) for _, v in want_top] or \
            sorted(top) != sorted((k, *v) for k, v in want_top):
        fail(f"q3 top 10 differs from the numpy oracle:\n{top}\n{want_top}")
    every = q3_rows(ctx, sql.split("order by")[0] + " order by l_orderkey")
    want = [(k, *oracle[k]) for k in sorted(oracle)]
    if every != want:
        bad = next(i for i, (a, b) in enumerate(zip(every + [None] * len(want), want)) if a != b)
        fail(f"q3 groups differ from the numpy oracle: {len(every)} vs {len(want)} groups, "
             f"first difference at {bad}: {every[bad] if bad < len(every) else None} vs "
             f"{want[bad]}")
    return len(every)


def q4_oracle(tables):
    """q4 by numpy: {o_orderpriority: count}."""
    import numpy as np

    orders, li = tables["orders"], tables["lineitem"]
    lkey = li.column("l_orderkey").to_numpy()
    late = li.column("l_commitdate").cast("int32").to_numpy() < \
        li.column("l_receiptdate").cast("int32").to_numpy()
    okey = orders.column("o_orderkey").to_numpy()
    has = np.zeros(int(max(okey.max(), lkey.max())) + 1, dtype=bool)
    has[lkey[late]] = True
    odate = orders.column("o_orderdate").cast("int32").to_numpy()
    keep = (odate >= _days("1993-07-01")) & (odate < _days("1993-10-01")) & has[okey]
    prio = np.asarray(orders.column("o_orderpriority").cast("string").to_pylist(), dtype=object)
    names, counts = np.unique(prio[keep], return_counts=True)
    return {str(n): int(c) for n, c in zip(names, counts)}


def check_q4(ctx, sql, oracle):
    df = ctx.sql(sql).to_pandas()
    got = {str(p): int(c) for p, c in zip(df["o_orderpriority"], df["order_count"])}
    if list(df["o_orderpriority"]) != sorted(oracle) or got != oracle:
        fail(f"q4 differs from the numpy oracle: {got} vs {oracle}")
    return got


def q18_oracle(tables, having=300):
    """q18 by numpy: the orders whose lines sum to more than ``having`` in
    l_quantity, {o_orderkey: (c_name, c_custkey, o_orderdate days,
    o_totalprice as scale-2 int64, sum(l_quantity) as scale-2 int64)}."""
    import numpy as np

    cust, orders, li = tables["customer"], tables["orders"], tables["lineitem"]
    lkey = li.column("l_orderkey").to_numpy()
    qty = np.zeros(int(lkey.max()) + 1, dtype=np.int64)
    np.add.at(qty, lkey, _cents(li, "l_quantity"))
    okey = orders.column("o_orderkey").to_numpy()
    keep = qty[okey] > having * 100
    name_of = dict(zip(cust.column("c_custkey").to_numpy().tolist(),
                       cust.column("c_name").cast("string").to_pylist()))
    ocust = orders.column("o_custkey").to_numpy()[keep]
    odate = orders.column("o_orderdate").cast("int32").to_numpy()[keep]
    price = _cents(orders, "o_totalprice")[keep]
    return {int(k): (name_of[int(c)], int(c), int(d), int(p), int(qty[k]))
            for k, c, d, p in zip(okey[keep], ocust, odate, price)}


def q18_rows(ctx, sql):
    """The engine's q18 rows in its physical units, in result order."""
    rows = []
    for b in ctx.sql(sql).collect():
        if b.device.type != ctx.device.type:
            fail(f"q18 result batch on {b.device}")
        names = [f.name for f in b.schema]
        for f in (b.schema.fields[4], b.schema.fields[5]):
            if f.dtype.scale != 2:
                fail(f"q18 {f.name} has scale {f.dtype.scale}, the oracle computes scale 2")
        d = b.compacted_numpy()
        cname = b.dicts[names[0]][d[names[0]]].tolist() if len(d[names[0]]) else []
        rows.extend(zip(d[names[2]].tolist(), cname, d[names[1]].tolist(),
                        d[names[3]].tolist(), d[names[4]].tolist(), d[names[5]].tolist()))
    return rows


def check_q18(ctx, sql, oracle):
    """Top 100 (o_totalprice desc, o_orderdate asc) and every row without
    the LIMIT (ordered by o_orderkey), exact."""
    top = q18_rows(ctx, sql)
    want_top = sorted(oracle.items(), key=lambda kv: (-kv[1][3], kv[1][2], kv[0]))[:100]
    # rows tied in (price, date) may come in either order: compare the order
    # of the sort keys and the set of rows
    if [(r[4], r[3]) for r in top] != [(v[3], v[2]) for _, v in want_top] or \
            sorted(top) != sorted((k, *v) for k, v in want_top):
        fail(f"q18 top 100 differs from the numpy oracle:\n{top[:5]}\n{want_top[:5]}")
    every = q18_rows(ctx, sql.split("order by")[0] + " order by o_orderkey")
    want = [(k, *oracle[k]) for k in sorted(oracle)]
    if every != want:
        fail(f"q18 rows differ from the numpy oracle: {len(every)} vs {len(want)} rows")
    return len(top), len(every)


def write_parquet(tables, sf, directory):
    """The tables as ``benchmarks/tpch.py convert`` writes them: one file a
    table, decimals in int64 storage, zstd, 2^19-row row groups at SF1."""
    import pyarrow.parquet as pq

    from benchmarks.tpch import decimal_to_int64_storage

    rows = max(1024, int(ROW_GROUP_ROWS * sf))
    paths = {}
    for name in PARQUET_TABLES:
        paths[name] = os.path.join(directory, f"{name}.parquet")
        pq.write_table(decimal_to_int64_storage(tables[name]), paths[name],
                       compression="zstd", row_group_size=rows)
    return paths, rows


def write_csv(tables, names, directory):
    """``names``' tables as csv with a header, as ``benchmarks/tpch.py
    convert --format csv`` writes them -> {table: path}."""
    import pyarrow.csv as pacsv

    out = {}
    for name in names:
        out[name] = os.path.join(directory, f"{name}.csv")
        pacsv.write_csv(tables[name], out[name])
    return out


def json_avro_paths(device, directory):
    """``json_q1`` and ``avro_q1``: TPC-H q1 at SF0.01 over lineitem as
    newline-delimited json and as an avro container (deflate; the codec is
    pure Python, so the scale stays small), registered under the TPC-H
    schema, on the card against the port on the CPU over the same file.
    Cold and warm walls, the scan's read and convert times, and K19-K21
    launched."""
    import json as _json

    import pyarrow as pa
    import torch

    from arrow_ballista_tpu_torch import BallistaContext
    from arrow_ballista_tpu_torch.catalog import arrow_schema_to_engine
    from arrow_ballista_tpu_torch.ops import kernels as K
    from arrow_ballista_tpu_torch.utils import avro
    from benchmarks.datagen import generate_tables
    from benchmarks.queries import QUERIES
    from tests.torch_cases import assert_frames_equal

    li = generate_tables(0.01, seed=0)["lineitem"]
    schema = arrow_schema_to_engine(li.schema)
    # decimals as doubles, dates as day numbers (the json reader's date32)
    plain = li.cast(pa.schema([pa.field(f.name, pa.float64() if pa.types.is_decimal(f.type)
                                        else pa.int32() if pa.types.is_date32(f.type)
                                        else f.type) for f in li.schema]))
    rows = plain.to_pylist()
    files = {"json": os.path.join(directory, "lineitem.json"),
             "avro": os.path.join(directory, "lineitem.avro")}
    with open(files["json"], "w") as fh:
        for r in rows:
            fh.write(_json.dumps(r) + "\n")
    kinds = {"int64": "long", "int32": "int", "double": "double", "string": "string",
             "bool": "boolean"}
    avro.write_avro(files["avro"], {"type": "record", "name": "lineitem", "fields": [
        {"name": f.name, "type": kinds[str(f.type)]} for f in plain.schema]}, rows,
        codec="deflate")
    out = {}
    for fmt, path in files.items():
        label = f"{fmt}_q1"
        frames = {}
        for side, dev in (("cpu", "cpu"), ("card", device)):
            c = BallistaContext.local(device=dev)
            getattr(c, f"register_{fmt}")("lineitem", path, schema=schema)
            K.reset_launch_counts()
            t0 = time.perf_counter()
            frames[side] = c.sql(QUERIES[1]).to_pandas()
            if side == "card":
                sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
                sync()
                cold = time.perf_counter() - t0
                launches = {k: v for k, v in K.LAUNCHES.items() if v}
                warm = []
                for _ in range(3):
                    t0 = time.perf_counter()
                    c.sql(QUERIES[1]).to_pandas()
                    sync()
                    warm.append(time.perf_counter() - t0)
                scan = scan_metrics(job_plans(c))
        # one file is one partition and, at SF0.01, one batch: no concat
        missing = [k for k in ("operator_program", "gather_columns", "dense_group_states")
                   if not launches.get(k)]
        if missing:
            fail(f"{label}: kernels not launched: {missing} ({launches})")
        try:
            assert_frames_equal(frames["card"], frames["cpu"], exact=True)
        except AssertionError as e:
            fail(f"{label} differs from the port on the CPU: {e}")
        out[label] = {"rows": li.num_rows, "cold_ms": cold * 1000,
                      "warm_ms": statistics.median(warm) * 1000,
                      "scan_read_ms": scan.get("scan_read_time", 0) * 1000,
                      "scan_convert_ms": scan.get("scan_convert_time", 0) * 1000,
                      "launches": launches}
        log(f"{label} SF0.01 ({li.num_rows} lineitem rows): equals the port on the CPU "
            f"bit for bit; cold {cold * 1000:.1f} ms, warm median of 3 "
            f"{statistics.median(warm) * 1000:.1f} ms; last warm scan read "
            f"{out[label]['scan_read_ms']:.1f} ms, convert {out[label]['scan_convert_ms']:.1f} "
            f"ms; launches {json.dumps(launches)}")
    return out


def job_plans(ctx):
    """The operator trees of the context's last query: the plan of a local
    context, every stage's resolved plan of a standalone one."""
    if getattr(ctx, "_standalone", None) is None:
        return [ctx.last_plan]
    graph = standalone_graph(ctx)
    return [graph.stages[sid].resolved_plan or graph.stages[sid].plan
            for sid in sorted(graph.stages)]


def standalone_graph(ctx):
    sa = ctx._standalone
    return sa.scheduler.jobs.get_graph(sa.last_job_id)


def scan_metrics(plans):
    """Summed metrics of the file scans (parquet, csv, json, avro) of a list
    of plans."""
    out = {}
    for plan in plans:
        if type(plan).__name__ in SCAN_TYPES:
            for k, v in plan.metrics().to_dict().items():
                out[k] = out.get(k, 0) + v
        for k, v in scan_metrics(plan.children()).items():
            out[k] = out.get(k, 0) + v
    return out


def plan_metric(plans, name):
    if not isinstance(plans, list):
        plans = [plans]
    return sum(p.metrics().to_dict().get(name, 0) + plan_metric(p.children(), name)
               for p in plans)


def check_clustered(plans, label):
    """q18's subquery went through the clustered aggregate: it early-filtered
    and never fell back to the sort path."""
    got = {k: plan_metric(plans, k) for k in ("clustered_early_filters", "presort_fallbacks",
                                               "clustered_range_mismatches")}
    if not got["clustered_early_filters"] or got["presort_fallbacks"]:
        fail(f"q18 over parquet ({label}): {got}")
    log(f"pq_q18 clustered aggregate ({label}): {json.dumps(got)}")


def cache_fingerprints(table_cache):
    """(data pointer, wrapping sum of the int64 view) of every tensor the
    scan cache holds, keyed by (entry, batch, column)."""
    import torch

    return {(key, i, name): (t.data_ptr(), int(t.view(torch.int64).sum()))
            for key, batches in table_cache.CACHE.entries()
            for i, b in enumerate(batches)
            for name, t in [*b.columns.items(), ("__mask", b.mask)]}


def fused_labels(ctx):
    """{stage id: labels of the stage's fused chains} of the last job."""
    graph = standalone_graph(ctx)

    def walk(p):
        yield p
        for c in p.children():
            yield from walk(c)

    return {sid: [n._label() for n in walk(st.resolved_plan or st.plan)
                  if type(n).__name__ == "FusedStageExec"]
            for sid, st in sorted(graph.stages.items())}


def check_passthrough(K, ctx, path: str, run: str) -> dict:
    """A passthrough path's latch, on every run: the run counted a
    passthrough partial, the fused stage fell back to its interpreted form
    for it, and where the path needs K15, K15 launched."""
    pt = op_metrics(job_plans(ctx), ("passthrough_partials", "fused_passthrough_fallbacks"))
    pt["passthrough_rows_launches"] = K.LAUNCHES["passthrough_rows"]
    need = [k for k in pt if k != "passthrough_rows_launches"
            or "passthrough_rows" in PATH_KERNELS[path]]
    if not all(pt[k] for k in need):
        fail(f"{path} ({run}): the passthrough partial did not latch: {pt}")
    log(f"{path} passthrough ({run}): {json.dumps(pt)}")
    return pt


def standalone_split(ctx, wall_s):
    """Where a standalone job's wall time went: its stages and tasks, the
    shuffle writer (bucket program, packed copy, grouping sort and file
    writes), the reader (file reads and upload), the fused chains, the
    task span (first launch to last end), the launch gaps (a stage's last
    producer end to its first task's start, summed over stages) and what
    lies outside the span (planning, scalar subqueries, the final read by
    the client).  Task sums are host wall ms summed over tasks (four run
    at once)."""
    graph = standalone_graph(ctx)
    plans = job_plans(ctx)
    statuses = [t.status for st in graph.stages.values() for t in st.task_infos
                if t is not None and t.status is not None]
    launch = min(st.launch_time_ms for st in statuses)
    end = max(st.end_time_ms for st in statuses)
    span_ms = end - launch

    def stage_times(stage):
        sts = [t.status for t in stage.task_infos if t is not None and t.status is not None]
        return (min(x.launch_time_ms for x in sts), max(x.end_time_ms for x in sts)) \
            if sts else None

    # scheduling: from a stage's last producer end to its first task's start
    gaps = 0
    for st in graph.stages.values():
        mine = stage_times(st)
        ends = [stage_times(graph.stages[p]) for p in st.producer_ids if p in graph.stages]
        if mine and ends and all(ends):
            gaps += max(0, mine[0] - max(e[1] for e in ends))
    return {
        "stages": len(graph.stages), "tasks": len(statuses),
        "planned_partitions": {sid: st.planned_partitions
                               for sid, st in sorted(graph.stages.items())},
        "task_ms_sum": sum(st.end_time_ms - st.launch_time_ms for st in statuses),
        "write_ms_sum": (plan_metric(plans, "write_time") + plan_metric(plans, "repart_time"))
        * 1000,
        "fetch_ms_sum": plan_metric(plans, "fetch_time") * 1000,
        "fused_ms_sum": sum(n.metrics().to_dict().get("agg_time", 0)
                            + n.metrics().to_dict().get("compute_time", 0)
                            for p in plans for n in _walk_fused(p)) * 1000,
        "task_span_ms": span_ms, "launch_gap_ms_sum": gaps, "wall_ms": wall_s * 1000,
        "outside_tasks_ms": wall_s * 1000 - span_ms,
        "fused_fallbacks": plan_metric(plans, "fused_fallbacks"),
        **{k: sum(v.values()) for k, v in op_metrics(
            plans, ("passthrough_partials", "fused_passthrough_fallbacks")).items()},
        "aqe": [r["kinds"] for r in graph.aqe_log],
    }


def _walk_fused(plan):
    if type(plan).__name__ == "FusedStageExec":
        yield plan
    for c in plan.children():
        yield from _walk_fused(c)


def plan_breakdown(plan, indent=0):
    """Per-operator host wall times of the last query (children included
    in a parent's elapsed_time), one line per operator."""
    ms = {k: (round(v * 1000, 3) if k.endswith("_time") else v)
          for k, v in plan.metrics().to_dict().items()}
    lines = ["  " * indent + plan._label()[:90] + f"  {json.dumps(ms)}"]
    for c in plan.children():
        lines.extend(plan_breakdown(c, indent + 1))
    return lines


def profile_query(ctx, sql, label, K=None):
    """One warm query under torch.profiler: device time by kernel name, the
    device's busy share of the wall time, the device time and launches of
    K4's and K5's kernels (RADIX_KERNELS), K10's and K11's
    (``clustered_trace``) and K6's and K2's (``call_trace``; with ``K``,
    each one's launch counter over the query beside the trace's kernels)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    before = dict(K.LAUNCHES) if K is not None else None
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ctx.sql(sql).to_pandas()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1000
    rows = device_rows(prof)
    radix = {name: {"ms": sum(r[0] for r in rows if any(p in r[2] for p in parts)),
                    "launches": sum(r[1] for r in rows if any(p in r[2] for p in parts))}
             for name, parts in RADIX_KERNELS.items()}
    clustered = clustered_trace(prof)
    calls = call_trace(prof)
    dense = dense_trace(prof)
    if before is not None:
        for name, rec in (*clustered.items(), *calls.items(), *dense.items()):
            rec["wrapper_calls"] = K.LAUNCHES[name] - before[name]
    busy_ms = sum(r[0] for r in rows)
    if not rows:
        log(f"profile {label}: no device time recorded (device busy share not measured)")
        return None
    log(f"profile {label} (warm, profiled): wall {wall_ms:.1f} ms, device busy {busy_ms:.2f} ms "
        f"= {busy_ms / wall_ms:.4f} of wall (idle share {1 - busy_ms / wall_ms:.4f})")
    for dev_ms, count, key in rows[:15]:
        log(f"  device {dev_ms:9.3f} ms  x{count:<5d} {key[:100]}")
    log(f"  K4 sort_order / K5 build_side_sort kernels per query: {json.dumps(radix)}")
    log(f"  K10 key_range_check / K11 clustered_keep kernels per query (memsets right before "
        f"them on their stream): {json.dumps(clustered)}")
    log(f"  K6 probe_join / K2 compaction_order kernels per query (memsets and copies right "
        f"before them on their stream): {json.dumps(calls)}")
    log(f"  K1 dense_group_states / K13 dense form kernels per query (device ms, launches, "
        f"init kernels, memsets before, K2 after): {json.dumps(dense)}")
    return {"wall_ms": wall_ms, "busy_ms": busy_ms, "busy_share": busy_ms / wall_ms,
            "radix_ms": radix, "clustered": clustered, "calls": calls, "dense": dense}


def profile_programs(ctx, sql, device):
    """Rows 5-7 of the kernel table on one warm run of ``sql``: the
    operator programs (K19, ``programs.operator_program``), the host packing
    (``kernels.pack_for_host``: K2 + K21) and the batch concat and shrink
    (K20; K2 + K21), each inside a torch.profiler range.  Returns {row:
    (device ms per query, bytes the calls must move, calls, wall ms)};
    device ms is None where the profiler gives none.  Bytes: a program
    reads its input columns (and the mask, a mask program) and writes its
    computed columns or mask (``program_bytes``); the packing reads the
    mask and ``target`` rows of each column and writes its buffers; a
    concat of several batches reads and writes its output once each; a
    shrink reads the mask and moves the kept rows."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from arrow_ballista_tpu_torch.compile import programs as PR
    from arrow_ballista_tpu_torch.models import batch as B
    from arrow_ballista_tpu_torch.ops import kernels as K
    from arrow_ballista_tpu_torch.ops import operators as O

    names = {"expr": "ab.row5.operator_programs", "pack": "ab.row6.pack_for_host",
             "concat": "ab.row7.concat_shrink"}
    moved = {k: 0 for k in names}
    calls = {k: 0 for k in names}
    wall = {k: 0.0 for k in names}  # host ms of the calls, each synchronized, third run
    active = [False]
    timing = [False]

    def timed(row, fn):
        if not timing[0]:
            return fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall[row] += (time.perf_counter() - t0) * 1000
        return out

    def cuda_bytes(ts):
        return sum(nbytes(t) for t in ts if isinstance(t, torch.Tensor) and t.is_cuda)

    def account(row, b):
        if active[0]:
            moved[row] += b
            calls[row] += 1

    orig = {"program": PR.operator_program, "pack": K.pack_for_host,
            "concat": O.concat_batches, "shrink": B.ColumnBatch.shrink}

    def program(prog, cols, mask, auxs):
        with record_function(names["expr"]):
            out = timed("expr", lambda: orig["program"](prog, cols, mask, auxs))
        if prog.launches():
            account("expr", program_bytes(prog, cols, mask, auxs))
        return out

    def pack(cols, mask, target, namesi64, namesf64, names32, order=None):
        with record_function(names["pack"]):
            buf, fbuf = timed("pack", lambda: orig["pack"](cols, mask, target, namesi64,
                                                           namesf64, names32, order))
        read = sum(cols[k].element_size() * min(target, cols[k].shape[0])
                   for k in (*namesi64, *namesf64, *names32))
        account("pack", nbytes(mask) + read + cuda_bytes([buf, fbuf]))
        return buf, fbuf

    def concat(schema, batches, capacity=None, device=None):
        batches = list(batches)
        with record_function(names["concat"]):
            out = timed("concat", lambda: orig["concat"](schema, batches, capacity=capacity,
                                                         device=device))
        if len(batches) > 1:
            account("concat", 2 * cuda_bytes([*out.columns.values(), out.mask]))
        return out

    def shrink(self):
        with record_function(names["concat"]):
            out = timed("concat", lambda: orig["shrink"](self))
        if out is not self:
            account("concat", nbytes(self.mask) + 2 * cuda_bytes(out.columns.values()))
        return out

    PR.operator_program = program
    K.pack_for_host, O.concat_batches, B.ColumnBatch.shrink = pack, concat, shrink
    try:
        ctx.sql(sql).to_pandas()
        torch.cuda.synchronize()
        active[0] = True
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            ctx.sql(sql).to_pandas()
            torch.cuda.synchronize()
        active[0] = False
        timing[0] = True
        ctx.sql(sql).to_pandas()
        timing[0] = False
    finally:
        PR.operator_program = orig["program"]
        K.pack_for_host, O.concat_batches, B.ColumnBatch.shrink = \
            orig["pack"], orig["concat"], orig["shrink"]
    out = {row: (range_device_ms(prof, label), moved[row], calls[row], wall[row])
           for row, label in names.items()}
    # the ranges' own device-timeline rows are spans, not work: left out
    rows = [r for r in device_rows(prof) if r[2] not in names.values()]
    out["whole query"] = (sum(r[0] for r in rows), 0, 1, None)
    # the profiler attributes no device time to the ranges of kernels that
    # ctypes launches (K19-K22, K2), so their device time per query is read
    # by kernel name: (ms, launches)
    for label, prefixes in KERNEL_NAMES.items():
        hit = [r for r in rows if r[2].startswith(prefixes)]
        out[label] = (sum(r[0] for r in hit), 0, sum(r[1] for r in hit), None)
    return out


# the device kernels of rows 5-7 in the profiler's rows, by name prefix
KERNEL_NAMES = {
    "K19 operator programs": ("ab_fused_rows_kernel",),
    "K20 concat": ("concat_kernel", "void concat_kernel<"),
    "K21 gathers (shrink, pack, sort, join pairs)": ("gather_kernel",),
    "K2 compaction order": ("k2_compact_",),
    "K22 mask ops": ("mask_kernel", "void mask_kernel<", "bucket_masks_kernel"),
}


def range_device_ms(prof, label):
    """Device time of the kernels and copies launched inside the host-side
    profiler ranges named ``label`` (outermost ranges only), in ms; None
    when the profiler attributes none.  The ranges' device-timeline spans
    are left out: they include the card's idle gaps between launches."""
    import torch

    total_us = 0.0
    for ev in prof.events():
        if ev.name != label or ev.device_type != torch.autograd.DeviceType.CPU:
            continue
        parent = ev.cpu_parent
        while parent is not None and parent.name != label:
            parent = parent.cpu_parent
        if parent is None:
            total_us += ev.device_time_total
    return total_us / 1000 if total_us else None


# --------------------------------------------------------------------------
# kernels against their twins
# --------------------------------------------------------------------------


def max_err(a, b, rtol=0.0) -> float:
    """Max |a - b|; fails unless exact (rtol 0) or within rtol."""
    import torch

    a, b = a.cpu(), b.cpu()
    if a.dtype != b.dtype or a.shape != b.shape:
        fail(f"dtype/shape differ: {a.dtype}{tuple(a.shape)} vs {b.dtype}{tuple(b.shape)}")
    if a.dtype.is_floating_point:
        if not torch.equal(torch.isnan(a), torch.isnan(b)):
            raise AssertionError("NaN positions differ")
        same = (a == b) | torch.isnan(a)
        diff = torch.where(same, torch.zeros_like(a), (a - b).abs())
        if not bool(((diff == 0) | (diff <= rtol * b.abs())).all()):
            raise AssertionError(f"float difference above rtol {rtol}: {float(diff.max())}")
        return float(diff.max()) if diff.numel() else 0.0
    if not torch.equal(a, b):
        raise AssertionError("integer results differ")
    return 0.0


def dense_check(K, args):
    import torch

    key_cols, val_cols, mask, key_ranges, domain = args
    gv, ge, gb = K.dense_group_states(key_cols, val_cols, mask, key_ranges, domain)
    pv, pe, pb = K.dense_group_states_plain(key_cols, val_cols, mask, key_ranges, domain)
    err = max_err(ge, pe)
    if bool(gb) != bool(pb):
        raise AssertionError("bad-rows flags differ")
    for (v, how), g, p in zip(val_cols, gv, pv):
        f64_sum = how == "sum" and v.dtype == torch.float64
        err = max(err, max_err(g, p, rtol=1e-12 if f64_sum else 0.0))
    return err


def grouped_err(got, want, vals):
    """Max abs error of a compacted grouped result (keys, values, mask,
    overflow or None) against the twin's: integers, keys, masks and flags
    exact, float sums at rtol 1e-12."""
    if (got[3] is None) != (want[3] is None) or (got[3] is not None and
                                                  bool(got[3]) != bool(want[3])):
        raise AssertionError("overflow flags differ")
    err = max_err(got[2], want[2])
    for g, w in zip(got[0], want[0]):
        err = max(err, max_err(g, w))
    for (_v, how), g, w in zip(vals, got[1], want[1]):
        err = max(err, max_err(g, w, rtol=1e-12 if how == "sum" and w.dtype.is_floating_point
                               else 0.0))
    return err


def dense_grouped_check(K, args):
    """K1's compacted form against its twin (the slot-aligned twin, then
    the twin's compaction)."""
    return grouped_err(K.dense_grouped(*args), K.dense_grouped_plain(*args), args[1])


def stress_inputs(K, device, n, seed=1):
    """6M-row stress inputs for each kernel, made from a seed with numpy."""
    import numpy as np
    import torch

    from arrow_ballista_tpu_torch.ops.kernels import dense_domain

    rng = np.random.default_rng(seed)
    big = (1 << 23) + 5 if n >= STRESS_ROWS else n + 5  # K2's and K6's largest shape

    def t(a):
        return torch.from_numpy(a).to(device)

    mask = t(rng.random(n) < 0.9)
    k1 = t(rng.integers(-1, 4, n).astype(np.int32))   # -1 is the NULL string code
    k2 = t(rng.integers(-1, 3, n).astype(np.int32))
    wrap = t(rng.integers(2**61, 2**62, n).astype(np.int64))  # sums wrap mod 2^64
    neg = t(rng.integers(-2**63, 2**63 - 1, n, dtype=np.int64))
    fv = t(rng.normal(size=n))
    i32 = t(rng.integers(2**29, 2**31 - 1, n).astype(np.int32))  # int32 sums wrap mod 2^32
    i32s = t(rng.integers(-2**31, 2**31 - 1, n).astype(np.int32))
    # quarter values of at most 8 in magnitude: every partial sum of a slot
    # stays exact in float32, so the atomic order cannot change a bit
    f32 = t((rng.integers(-32, 32, n) / 4).astype(np.float32))
    dense_vals = [(wrap, "sum"), (neg, "min"), (neg, "max"),
                  (torch.zeros(n, dtype=torch.int64, device=device), "count"), (fv, "sum"),
                  (fv, "min"), (fv, "max"), (i32, "sum"), (i32s, "min"), (i32s, "max"),
                  (f32, "sum"), (f32, "min"), (f32, "max")]
    sort_f = rng.integers(-3, 3, n).astype(np.float64)
    sort_f[rng.random(n) < 0.01] = np.nan
    sort_f[rng.random(n) < 0.01] = -0.0
    sort_keys = [(t(rng.integers(-2, 3, n).astype(np.int32)), True),
                 (t(sort_f), False),
                 (t(rng.random(n) < 0.5), False),
                 (t(np.where(rng.random(n) < 0.01, np.iinfo(np.int64).min,
                             rng.integers(-5, 5, n)).astype(np.int64)), False)]
    hash_keys = [t(rng.integers(-3, 20, n).astype(np.int32)),
                 t(rng.integers(-2**63, 2**63 - 1, n, dtype=np.int64)),
                 t(rng.random(n) < 0.5)]
    # K4's radix form at its widest: one full-range int64 key (65 composite
    # bits with the dead flag), and eight keys over 64 bits (251 bits, fields
    # straddling limbs, NaN and -0.0 under desc)
    full = rng.integers(-2**63, 2**63 - 1, n, dtype=np.int64)
    full[:2] = [np.iinfo(np.int64).min, np.iinfo(np.int64).max]
    wide_f = rng.normal(size=n)
    wide_f[rng.random(n) < 0.05] = np.nan
    wide_f[rng.random(n) < 0.05] = -0.0
    wide_keys = [(t(rng.integers(0, 5, n).astype(np.int32)), True),
                 (t(rng.integers(-2**63, 2**63 - 1, n, dtype=np.int64)), False),
                 (t(rng.random(n) < 0.5), False), (t(wide_f), True),
                 (t(wide_f.astype(np.float32)), False),
                 (t(rng.integers(-2**31, 2**31 - 1, n).astype(np.int32)), True),
                 (t(rng.integers(-2**19, 2**19, n).astype(np.int64)), False),
                 (t(rng.integers(-1, 3, n).astype(np.int32)), True)]
    # the sort path's group keys at the sizes the local engine sorts them:
    # five over 1,024 rows (q18's, one block) and seven over 262,144
    # (sa_q10's, two limbs)
    group_keys = [([(t(rng.integers(0, 1 << (40 - 4 * j), rows, dtype=np.int64)), j % 2 == 0)
                    for j in range(nkeys)], t(rng.random(rows) < 0.9))
                  for rows, nkeys in ((1024, 5), (262_144, 7))]
    # K1's compacted form: the q1 domain cut (overflow), exact and padded,
    # ranges that leave the -1 codes out (bad rows), one hot slot, and the
    # wide domain (the device-memory form)
    q1r, badr, wider = ((-1, 15), (-1, 15)), ((0, 15), (0, 15)), ((-1, 127), (-1, 255))
    hot = torch.full_like(k1, 2)
    compacted = [Wrapped("dense_grouped", (keys, dense_vals, mask, cap, r, dense_domain(r)))
                 for keys, r, cap in (([k1, k2], q1r, 7), ([k1, k2], q1r, 289),
                                      ([k1, k2], q1r, 300), ([k1, k2], badr, 100),
                                      ([hot, hot], q1r, 289), ([k1, k2], wider, 33153))]
    return {
        # the q1 domain (shared-memory form) and one too wide for shared
        # memory, in both forms
        "dense_group_states": [([k1, k2], dense_vals, mask, r, dense_domain(r))
                               for r in (q1r, wider)] + compacted,
        "compaction_order": [(mask,), *compaction_stress(t, rng, big)],
        "bucket_of": [(hash_keys, 16), (hash_keys, 7)],
        "sort_order": [(sort_keys, mask), ([(t(full), True)], mask), (wide_keys, mask),
                       *group_keys],
        **join_stress(K, t, rng, n, big),
        "grouped_on_order": seg_agg_stress(t, rng, n),
        **clustered_stress(t, rng, n),
    }


def view_at(t, a, offset):
    """A card copy of numpy array ``a`` viewed ``offset`` bytes past a 16-byte
    boundary, inside a buffer of ones (so a kernel that reads the bytes
    around the view would see live rows)."""
    import numpy as np
    import torch

    x = t(np.ascontiguousarray(a))
    big = torch.ones(x.numel() + 32, dtype=x.dtype, device=x.device)
    big[offset:offset + x.numel()] = x
    out = big[offset:offset + x.numel()]
    if out.data_ptr() % 16 != offset * x.element_size() % 16:
        fail(f"a view at byte offset {offset} is not where it should be")
    return out


def compaction_stress(t, rng, big):
    """K2 at 0 and 1 rows, 8,192 rows +-1, the one-launch limit (2^17)
    +-1 (all live and all dead there too), the first two-launch tile (8,192
    rows) past it +-1 and 2^23 + 5 rows, and masks viewed at byte offsets
    1-15 in both forms; check_kernel holds each and its live count."""
    import numpy as np

    one = 1 << 17  # csrc/compact.cu CP_ONE_ROWS
    out = [(t(rng.random(n) < 0.4),) for n in (0, 1, 8191, 8193, one - 1, one, one + 1,
                                                 one + 8191, one + 8193, big)]
    out += [(t(np.ones((1 << 17) + 1, bool)),), (t(np.zeros((1 << 17) + 1, bool)),)]
    out += [(view_at(t, rng.random(n) < 0.4, off),) for off in range(1, 16)
            for n in (100_003, one + 8193)]
    return out


def probe_stress(K, t, rng, big):
    """K6 over tests/torch_cases.py's probe cases (one build row, an
    all-dead probe, live all-ones probe hashes against the dead build tail,
    forced equal hashes, row n-1 dead and live) at 1, a 256-row tile +-1,
    the switch to 1,024-row tiles (135,168 rows) +-1 and 2^23 + 5 probe
    rows, caps that truncate and that run past the total
    (at most 2^22; forced: the 2^20 cap), both count modes; masks viewed at
    byte offsets 1-15."""
    import numpy as np

    from tests.torch_cases import PROBE_CASES, probe_case

    joins, counts = [], []
    for n in (1, 255, 257, 135_168, 135_169, big):
        for case in PROBE_CASES:
            ph, pm, bh = probe_case(case, n, rng)
            args = (t(ph.view(np.int64)), t(pm), t(bh.view(np.int64)))
            total = int(K.probe_counts_plain(*args)[1])
            most = 1 << 22  # all-ones probe hashes against the dead tail: totals past 10^11
            caps = [1 << 20] if case == "forced_collisions" else \
                sorted({max(1, min(total // 2, most)), min(total + 1000, most)})
            joins += [(*args, cap) for cap in caps]
            counts += [Wrapped("probe_counts", (*args, True)), Wrapped("probe_counts", args)]
    ph, pm, bh = probe_case("dup_fanout", 100_003, rng)
    for off in range(1, 16):
        args = (t(ph.view(np.int64)), view_at(t, pm, off), t(bh.view(np.int64)))
        joins.append((*args, 150_000))
        counts.append(Wrapped("probe_counts", (*args, True)))
    return joins + counts


def probe_compact_reset_check(K, device, calls=100, seed=14):
    """K6 and K2 with no memset between calls: ``calls`` calls of K6's two
    wrappers and of K2 queued back to back on one stream, then 25 from each
    of four threads at once on the stream they share, then on a stream
    each; sizes, totals and caps differ from call to call, so a status
    word, tile counter or ticket left behind would show.  Every result
    against the twin; returns the calls checked."""
    import threading

    import numpy as np
    import torch

    from tests.torch_cases import probe_case

    rng = np.random.default_rng(seed)

    def inputs(count):
        out = []
        for _ in range(count):
            n = int(rng.integers(1, 300_000))
            ph, pm, bh = probe_case("dup_fanout", n, rng, n_build=int(rng.integers(1, 60_000)))
            out.append((ph.view(np.int64), pm, bh.view(np.int64), int(rng.integers(0, 3 * n))))
        return out

    def launch(batch):
        staged = [tuple(torch.from_numpy(a).to(device) for a in (ph, pm, bh)) + (cap,)
                  for ph, pm, bh, cap in batch]
        return [(K.probe_join(*a), K.probe_counts(*a[:3], True),
                 K.compaction_order(a[1], with_count=True)) for a in staged]

    def check(batch, results):
        for (ph, pm, bh, cap), (join, counts, compact) in zip(batch, results):
            host = tuple(torch.from_numpy(a) for a in (ph, pm, bh))
            want = K.probe_join_plain(*host, cap)
            if any(not torch.equal(g.cpu(), w) for g, w in zip(join[:3], want[:3])) or \
                    int(join[3]) != int(want[3]) or int(counts[1]) != int(want[3]):
                raise AssertionError("probe_join: a result differs after back-to-back calls")
            if not torch.equal(counts[0].cpu(), K.probe_counts_plain(*host, True)[0]):
                raise AssertionError("probe_counts: offsets differ after back-to-back calls")
            if not torch.equal(compact[0].cpu(), K.compaction_order_plain(host[1])) or \
                    int(compact[1]) != int(pm.sum()):
                raise AssertionError("compaction_order: a result differs after back-to-back "
                                     "calls")

    batch = inputs(calls)
    results = launch(batch)
    torch.cuda.synchronize()
    check(batch, results)
    checked = calls
    for own_streams in (False, True):
        batches = [inputs(25) for _ in range(4)]
        out = [None] * 4
        start = threading.Barrier(4)

        def work(i):
            scope = (torch.cuda.stream(torch.cuda.Stream(device)) if own_streams
                     else contextlib.nullcontext())
            with scope:
                start.wait()
                out[i] = launch(batches[i])
                torch.cuda.current_stream(device).synchronize()

        threads = [threading.Thread(target=work, args=(i,)) for i in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        torch.cuda.synchronize()
        for b, r in zip(batches, out):
            check(b, r)
            checked += len(b)
    return checked


def seg_reset_check(K, device, calls=300, seed=15):
    """K8 with no memset between calls: ``calls`` calls queued back to back
    on one stream, then 25 from each of four threads at once on the stream
    they share, then on a stream each; sizes (one tile to 150 tiles), group
    widths, keys or none, and the order form differ from call to call, so a
    status word, tile counter or ticket left behind would show.  Every
    result against the twin; returns the calls checked."""
    import threading

    import numpy as np
    import torch

    rng = np.random.default_rng(seed)

    def inputs(count):
        out = []
        for i in range(count):
            n = int(rng.choice([100, 2049, 40_000, 300_000]))
            width = int(rng.choice([1, 3, 50, n]))
            keys = [np.sort(rng.integers(0, max(1, n // width), n)).astype(np.int64)] \
                if i % 5 else []
            vals = [(rng.integers(-10**9, 10**9, n).astype(np.int64), "sum"),
                    (np.zeros(n, np.int64), "count"),
                    (rng.integers(-99, 99, n).astype(np.int32), "min")]
            order = rng.permutation(n) if i % 3 == 0 else np.arange(n)
            out.append((keys, vals, rng.random(n) < 0.7, n, order))
        return out

    def launch(batch):
        staged = []
        for keys, vals, mask, n, order in batch:
            staged.append(([torch.from_numpy(k).to(device) for k in keys],
                           [(torch.from_numpy(v).to(device), h) for v, h in vals],
                           torch.from_numpy(mask).to(device), n, n,
                           torch.from_numpy(order.astype(np.int32)).to(device)))
        return staged, [K.grouped_on_order(*a) for a in staged]

    def check(staged, results):
        for a, got in zip(staged, results):
            want = K.grouped_on_order_plain(*a)
            if not torch.equal(got[2], want[2]) or any(
                    not torch.equal(g, w) for g, w in zip([*got[0], *got[1]],
                                                          [*want[0], *want[1]])):
                raise AssertionError("grouped_on_order: a result differs after back-to-back "
                                     "calls")

    staged, results = launch(inputs(calls))
    torch.cuda.synchronize()
    check(staged, results)
    checked = calls
    for own_streams in (False, True):
        batches = [inputs(25) for _ in range(4)]
        out = [None] * 4
        start = threading.Barrier(4)

        def work(i):
            scope = (torch.cuda.stream(torch.cuda.Stream(device)) if own_streams
                     else contextlib.nullcontext())
            with scope:
                start.wait()
                out[i] = launch(batches[i])
                torch.cuda.current_stream(device).synchronize()

        threads = [threading.Thread(target=work, args=(i,)) for i in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        torch.cuda.synchronize()
        for st, res in out:
            check(st, res)
            checked += len(st)
    return checked


def clustered_stress(t, rng, n):
    """K9-K11 inputs: K9 over the rows as they are (tests/torch_cases.py
    DISORDER_CASES at 2^20 + 5 rows: decreases hidden across a run of dead
    rows and at the 2,048-row tile edge, equal keys across a dead row, only
    dead keys decreasing, int32 and int64 extremes, one and two live rows,
    every row dead; and sorted, shuffled and a decrease across dead rows at
    n rows), each with the flag it must give; range
    checks with a key above the range in the last row, one below, NULL
    sentinel keys that must not count, and only dead rows outside; keep
    masks over q18-like 16 intervals, over 1,000 with NULL keys and over
    5,000 merged ones (searched in device memory).  Then K10 and K11 at the
    sizes around a 256-row warp tile and a 2,048-row block tile (0, 1, 15,
    17, 255, 257, 2,047, 2,049, 2^20 + 5) over int32 and int64 keys at their extremes, with
    every row dead, and on masks, predicates and keys viewed at byte
    offsets 1-15 (the row-by-row path)."""
    import numpy as np
    import torch

    from arrow_ballista_tpu_torch.ops.kernels import KeepIntervals
    from tests.torch_cases import DISORDER_CASES, disorder_case

    device = t(np.zeros(1)).device
    i64_min = np.iinfo(np.int64).min
    mask = t(rng.random(n) < 0.9)
    sorted_k = np.sort(rng.integers(0, n // 4, n)).astype(np.int64)
    disorder, disorder_flags = [], []
    for case, rows in [(c, (1 << 20) + 5) for c in DISORDER_CASES] + \
            [("sorted", n), ("shuffled", n), ("decrease_across_dead_run", n)]:
        k9_keys, k9_mask = disorder_case(case, rows, rng)
        disorder.append((t(k9_keys), t(k9_mask)))
        disorder_flags.append(DISORDER_CASES[case])
    lo, hi = int(sorted_k[0]), int(sorted_k[-1])
    above = sorted_k.copy()
    above[-1] = hi + 1
    below = sorted_k.copy()
    below[n // 3] = lo - 1
    nulls = sorted_k.copy()
    nulls[::9] = i64_min
    live = torch.ones_like(mask)
    outside_dead = np.where(rng.random(n) < 0.5, hi + 5, sorted_k)
    ranges = [(t(sorted_k), mask, lo, hi, None), (t(above), live, lo, hi, None),
              (t(below), live, lo, hi, None), (t(nulls), live, lo, hi, int(i64_min)),
              (t(outside_dead), t(outside_dead == sorted_k), lo, hi, None),
              (t(above.astype(np.int32)), live, lo, hi, None)]
    flags = [False, True, True, False, False, True]
    keeps = []
    for m in (16, 1000, 5000):
        starts = np.sort(rng.choice(n // 4, m, replace=False)).astype(np.int64)
        if m == 5000:  # apart: 5,000 merged pairs, past the 2,048 in shared memory
            starts = np.sort(rng.choice(max(n // 32, m), m, replace=False)).astype(np.int64) * 8
        los = np.concatenate([starts, [i64_min]])
        his = np.concatenate([starts + rng.integers(0, 3, m), [i64_min]])
        pad = 1 << int(np.ceil(np.log2(len(los))))
        los = np.concatenate([los, np.ones(pad - len(los), np.int64)])
        his = np.concatenate([his, np.zeros(pad - len(his), np.int64)])
        keys = nulls if m == 1000 else sorted_k
        keeps.append((t(keys), mask, t(rng.random(n) < 0.01), KeepIntervals(los, his, device)))

    def view_at(a, offset):
        """``a`` on the card, ``offset`` bytes past a 16-byte boundary."""
        size = a.dtype.itemsize
        big = torch.zeros(a.shape[0] + 16 // size + 1, dtype=t(a[:0]).dtype, device=device)
        view = big[offset // size:offset // size + a.shape[0]]
        view.copy_(t(a))
        return view

    def add(k, m, p, lo, hi, sent, iv, kv=None, mv=None, pv=None):
        ranges.append((t(k) if kv is None else kv, t(m) if mv is None else mv, lo, hi, sent))
        lv = m if sent is None else m & (k != sent)
        flags.append(bool((lv & ((k < lo) | (k > hi))).any()))
        keeps.append((t(k) if kv is None else kv, t(m) if mv is None else mv,
                      t(p) if pv is None else pv, iv))

    for dtype in (np.int32, np.int64):
        info = np.iinfo(dtype)
        for rows in (0, 1, 15, 17, 255, 257, 2047, 2049, (1 << 20) + 5):
            k = rng.integers(info.min, info.max, rows, dtype=dtype, endpoint=True)
            k[:min(rows, 2)] = [info.min, info.max][:min(rows, 2)]
            m = rng.random(rows) < 0.7
            p = rng.random(rows) < 0.05
            picks = rng.choice(k, 16).astype(np.int64) if rows else np.zeros(16, np.int64)
            iv = KeepIntervals(np.append(picks, i64_min), np.append(picks, i64_min), device)
            add(k, m, p, int(info.min) + 1, int(info.max), None, iv)
            add(k, np.zeros(rows, dtype=bool), p, 0, 0, None, iv)  # every row dead
        rows = 100_003
        k = rng.integers(info.min, info.max, rows, dtype=dtype, endpoint=True)
        m, p = rng.random(rows) < 0.7, rng.random(rows) < 0.05
        k[rows // 2], m[rows // 2] = info.max, True  # above the range below
        picks = rng.choice(k, 16).astype(np.int64)
        iv = KeepIntervals(picks, picks + 3, device)
        for offset in range(1, 16):
            add(k, m, p, int(info.min), int(info.max) - 1, None, iv,
                kv=view_at(k, (offset * np.dtype(dtype).itemsize) % 16),
                mv=view_at(m, offset), pv=view_at(p, 15 - offset))
    return {"presorted_disorder": disorder, "key_range_check": ranges,
            "clustered_keep": keeps,
            # what K9 and K10 must report on each input above
            "expected_flags": {"presorted_disorder": disorder_flags,
                               "key_range_check": flags}}


def clustered_reset_check(K, device, calls=100, seed=13):
    """K10 and K11 without a memset: ``calls`` calls of each queued back to
    back on one stream, then 25 from each of four threads at once on the
    stream they share, then on a stream each; flags alternate and counts
    differ from call to call, so a stale accumulator or ticket would show.
    Every result against the twin; returns the calls checked."""
    import threading

    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    i64 = np.iinfo(np.int64)

    def inputs(count):
        out = []
        for i in range(count):
            rows = int(rng.integers(0, 200_000))
            k = rng.integers(i64.min, i64.max, rows, dtype=np.int64)
            m = rng.random(rows) < rng.random()
            p = rng.random(rows) < 0.05
            picks = rng.choice(k, 16) if rows else np.zeros(16, np.int64)
            lo, hi = (int(i64.min), int(i64.max)) if i % 2 else (int(i64.min) + 1, int(i64.max) - 1)
            if rows:
                k[int(rng.integers(0, rows))] = i64.max
            out.append((k, m, p, picks, lo, hi))
        return out

    def launch(batch):
        staged = [(torch.from_numpy(k).to(device), torch.from_numpy(m).to(device),
                   torch.from_numpy(p).to(device), K.KeepIntervals(picks, picks + 2, device), lo, hi)
                  for k, m, p, picks, lo, hi in batch]
        return [(K.key_range_check(kd, md, lo, hi), *K.clustered_keep(kd, md, pd_, iv))
                for kd, md, pd_, iv, lo, hi in staged]

    def check(batch, results):
        for (k, m, p, picks, lo, hi), (flag, keep, live) in zip(batch, results):
            want_flag = bool((m & ((k < lo) | (k > hi))).any())
            wk, wl = K.clustered_keep_plain(*(torch.from_numpy(a) for a in (k, m, p)),
                                            K.KeepIntervals(picks, picks + 2, "cpu"))
            if bool(flag) != want_flag:
                raise AssertionError("key_range_check: a flag differs after back-to-back calls")
            if not torch.equal(keep.cpu(), wk) or int(live) != int(wl):
                raise AssertionError("clustered_keep: a result differs after back-to-back calls")

    batch = inputs(calls)
    results = launch(batch)
    torch.cuda.synchronize()
    check(batch, results)
    checked = calls
    for own_streams in (False, True):
        batches = [inputs(25) for _ in range(4)]
        out = [None] * 4
        start = threading.Barrier(4)

        def work(i):
            scope = (torch.cuda.stream(torch.cuda.Stream(device)) if own_streams
                     else contextlib.nullcontext())
            with scope:
                start.wait()
                out[i] = launch(batches[i])
                torch.cuda.current_stream(device).synchronize()

        threads = [threading.Thread(target=work, args=(i,)) for i in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        torch.cuda.synchronize()
        for b, r in zip(batches, out):
            check(b, r)
            checked += len(b)
    return checked


def join_stress(K, t, rng, n, big):
    """K5, K6 and K7 stress inputs: duplicate keys with fan-out (about 3
    live build rows a key), all-dead build rows, and pair capacities that
    truncate the total and that leave dead slots; one segment hit by every
    row, and signed int32 values with out-of-range segment ids."""
    import numpy as np
    import torch

    bkeys = [t(rng.integers(0, n // 6, n).astype(np.int64)), t(rng.integers(0, 2, n).astype(np.int32))]
    bmask = t(rng.random(n) < 0.9)
    dead = torch.zeros_like(bmask)
    pkeys = [t(rng.integers(0, n // 5, n).astype(np.int64)), t(rng.integers(0, 2, n).astype(np.int32))]
    pmask = t(rng.random(n) < 0.8)
    ph = K.hash64_plain(pkeys)
    probes = []
    for mask in (bmask, dead):
        bh = K.build_side_sort_plain(bkeys, mask)[0]
        total = int(K.probe_counts_plain(ph, pmask, bh)[1])
        for cap in sorted({max(64, total // 2), total + 1000}):
            probes.append((ph, pmask, bh, cap))
    ns = 1 << 20
    # K7 over K6-shaped ids (the fill tail, runs many tiles long whose only
    # true value comes late, ids out of range, signed int32 values) and over
    # unordered ids, each with a mask folded in
    from tests.torch_cases import k6_segment_case

    folded = []
    for case, segs, negate in (("fill_tail", n // 4, True), ("long_runs_late_hit", 400, False),
                               ("out_of_range_ids", n // 2, True), ("int32_signed", 1000, False)):
        v, seg = k6_segment_case(case, n, segs, rng)
        folded.append((t(v), t(seg), segs, t(rng.random(segs) < 0.7), negate))
    folded.append((t(rng.random(n) < 0.2), t(rng.integers(0, ns, n).astype(np.int32)), ns,
                   t(rng.random(ns) < 0.7), True))
    return {
        "build_side_sort": [(bkeys, bmask), (bkeys, dead)],
        "probe_join": probes + probe_stress(K, t, rng, big),
        "segment_any": [(torch.ones(n, dtype=torch.bool, device=bmask.device),
                         torch.full((n,), ns // 2, dtype=torch.int32, device=bmask.device), ns),
                        (t(rng.integers(-3, 3, n).astype(np.int32)),
                         t(rng.integers(-5, ns + 5, n).astype(np.int32)), ns), *folded],
    }


def radix_build_stress(device, n=1 << 23, seed=9):
    """K5 at 2^23 rows (mesh4_q3's largest build), held against its twin in
    both hash modes: duplicate keys with fan-out and a 0.9 live mask."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    keys = [torch.from_numpy(rng.integers(0, n // 6, n).astype(np.int64)).to(device),
            torch.from_numpy(rng.integers(0, 2, n).astype(np.int32)).to(device)]
    return keys, torch.from_numpy(rng.random(n) < 0.9).to(device)


def forced_collision_inputs(K, device, n, seed=2):
    """Build and probe under forced equal hashes (every live hash 0): call
    with kernels._FORCE_COLLISIONS set.  A 4096-row probe against n build
    rows: every live probe row matches every live build row, far past the
    2^20 pair slots."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    bkeys = [torch.from_numpy(rng.integers(0, 1000, n).astype(np.int64)).to(device)]
    bmask = torch.from_numpy(rng.random(n) < 0.9).to(device)
    pkeys = [torch.from_numpy(rng.integers(0, 1000, 4096).astype(np.int64)).to(device)]
    pmask = torch.from_numpy(rng.random(4096) < 0.8).to(device)
    bh = K.build_side_sort_plain(bkeys, bmask)[0]
    return {"build_side_sort": (bkeys, bmask),
            "probe_join": (K.hash64_plain(pkeys), pmask, bh, 1 << 20),
            "spill_partition": (bkeys, 8), "spill_order": (bkeys, bmask, 8)}


def seg_agg_stress(t, rng, n):
    """K8 inputs with the columns in group order, read through the identity
    order: many small groups (sums that wrap, every value type, empty slots
    past the groups), one n-row group (across every tile), no keys, and a
    capacity below the group count (overflow); a tile -+1 rows, a group
    across two tiles, every row its own group, dead rows inside the groups
    (a dead row of another key splits one) and before the first; and the
    first four through a random order (the columns in another row order,
    read at order[i])."""
    import numpy as np

    from tests.torch_cases import SEG_TILE

    keys = [t(np.sort(rng.integers(0, n // 4, n)).astype(np.int64))]
    mask = t(rng.random(n) < 0.9)
    quarter = t((rng.integers(-256, 256, n) / 4).astype(np.float32))  # small groups: exact sums
    pos = t(rng.random(n) * 100)  # positive: float64 sums without cancellation
    i64 = t(rng.integers(-2**63, 2**63 - 1, n, dtype=np.int64))
    i32 = t(rng.integers(-1000, 1000, n).astype(np.int32))
    wrap = t(rng.integers(2**61, 2**62, n).astype(np.int64))
    count = t(np.zeros(n, np.int64))
    many = [(wrap, "sum"), (count, "count"), (i64, "min"), (i64, "max"), (i32, "sum"),
            (i32, "min"), (i32, "max"), (pos, "sum"), (pos, "min"), (quarter, "sum"),
            (quarter, "max")]
    one = [t(np.full(n, 7, np.int64))]
    out = [(keys, many, mask, n, n),
           (one, [(wrap, "sum"), (count, "count"), (pos, "sum"), (i64, "min")], mask, n, n),
           ([], [(wrap, "sum"), (count, "count"), (pos, "max"), (i32, "min")], mask, n, n),
           (keys, many[:2], mask, 100_000, n)]
    small = [(wrap, "sum"), (count, "count"), (quarter, "sum"), (i32, "max")]
    for rows in (SEG_TILE - 1, SEG_TILE + 1):
        out.append(([k[:rows] for k in keys], [(v[:rows], h) for v, h in small], mask[:rows],
                    rows, rows))
    across = np.sort(rng.integers(0, n // 5, n)).astype(np.int64)
    across[SEG_TILE - 900:SEG_TILE + 1100] = across[SEG_TILE - 901]
    across = np.maximum.accumulate(across)
    out.append(([t(across)], small, mask, n, n))
    own = t(np.arange(n, dtype=np.int64))
    out.append(([own], small, t(np.ones(n, bool)), n, n))
    inside = np.sort(rng.integers(0, n // 40, n)).astype(np.int64)
    dead = rng.random(n) < 0.5
    inside[dead & (rng.random(n) < 0.03)] += 10**9
    inside[:500] = inside[500]
    dead[:200] = True
    out.append(([t(inside)], small, t(~dead), n, n))
    order = t(rng.permutation(n).astype(np.int32))
    inv = torch_argsort(order)
    shuffled = [([k[inv] for k in ks], [(v[inv], h) for v, h in vs], m[inv], cap, rows, order)
                for ks, vs, m, cap, rows in out[:4]]
    ident = t(np.arange(n, dtype=np.int32))
    return [(*a, ident[:a[4]]) for a in out] + shuffled


def torch_argsort(order):
    """The inverse of a permutation: a column ``c`` in group order is
    ``c[inv]`` in the row order that ``order`` reads it from."""
    import torch

    inv = torch.empty_like(order, dtype=torch.int64)
    inv[order.long()] = torch.arange(order.shape[0], device=order.device)
    return inv


class Wrapped:
    """A stress input of one of a kernel's wrappers (K21: pack_for_host;
    K22: each mask op), checked through that wrapper."""

    def __init__(self, wrapper, args):
        self.wrapper, self.args = wrapper, args


def k19_k22_stress(device, n, seed=7):
    """6M-row stress inputs of K19-K22, made from a seed with numpy: K19's
    mask and column programs of a filter, a projection and computed sort
    keys over a table with NULL strings and integers, NaN and int64
    products that wrap (the projection: %, CASE, IN, SUBSTRING, IS NULL,
    dates and a literal); K20
    over 40 columns of every dtype in 3 sources with a pad, and over 70
    sources (two launches); K21 over 10 columns at a random index with
    repeats and the packed copy with an odd count of 32-bit words; K22's
    five mask ops."""
    import numpy as np
    import torch

    from arrow_ballista_tpu_torch.catalog import MemoryTable
    from arrow_ballista_tpu_torch.models import expr as E
    from arrow_ballista_tpu_torch.ops import operators as O
    from arrow_ballista_tpu_torch.ops.physical import TaskContext, table_to_batches
    from tests.torch_cases import hand_chain, hand_table, move_column

    rng = np.random.default_rng(seed)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    table = hand_table(n, seed)
    scan = MemoryTable("t", table).scan(None, [], 1)
    proj, filt = hand_chain(E, O, scan)
    tctx = TaskContext(device=device)
    (batch,) = table_to_batches(table, scan.schema, 1 << 23, device)
    # and sort keys that are computed (TPC-H's sort keys are all columns,
    # which alias and launch nothing)
    sort = O.SortExec(scan, [(E.BinOp("%", E.Column("k"), E.Lit(5)), False),
                             (E.BinOp("*", E.Column("big"), E.Lit(3)), True)])
    programs = []
    for op in (filt, proj, sort):
        prog = op._prepared(tctx)
        programs.append((prog, batch.columns, batch.mask, prog.aux_arrays(batch.dicts)))
    dts = [np.int32, np.int64, np.float32, np.float64, np.bool_]

    def sources(ncols, caps):
        cols = [{f"c{c}": t(move_column(dts[c % 5], cap, rng)) for c in range(ncols)}
                for cap in caps]
        return cols, [t(rng.random(cap) < 0.6) for cap in caps]

    wide, wmasks = sources(40, [1 << 21] * 3)
    many, mmasks = sources(3, [n // 70] * 70)
    gcols = {f"g{c}": t(move_column(dts[c % 5], n, rng)) for c in range(10)}
    mask = t(rng.random(n) < 0.4)
    pack_cols = {"a": gcols["g1"], "f": gcols["g3"], "i": gcols["g0"], "g": gcols["g2"],
                 "k": gcols["g4"]}
    a, b = t(rng.random(n) < 0.5), t(rng.random(n) < 0.5)
    return {
        "operator_program": programs,
        "concat_columns": [(wide, wmasks, 1000), (many, mmasks, 64)],
        "gather_columns": [(t(rng.integers(0, n, n).astype(np.int32)), gcols),
                           Wrapped("pack_for_host", (pack_cols, mask, 1 << 22, ("a",), ("f",),
                                                     ("i", "g", "k")))],
        "mask_ops": [Wrapped("window_mask", (a, n // 5, n // 2)), Wrapped("mask_or", (a, b)),
                     Wrapped("mask_and", (a, b)), Wrapped("mask_andnot", (a, b))],
        "bucket_masks": bucket_stress(t, rng, n),
    }


def bucket_stress(t, rng, n):
    """K22's bucket form: 1, 2, 16 and 64 partitions at 1, 15, 16, 17 and
    131,072 -+1 rows (ragged and whole 16-byte words), 16 partitions at n
    rows, masks and buckets viewed at byte offsets 1-15 (the row-by-row
    path) and buckets outside [0, num_out) (no row)."""
    import numpy as np

    out = []
    for num_out in (1, 2, 16, 64):
        for rows in (1, 15, 16, 17, (1 << 17) - 1, 1 << 17, (1 << 17) + 1):
            out.append((t(rng.random(rows) < 0.7),
                        t(rng.integers(0, num_out, rows).astype(np.int32)), num_out))
    out.append((t(rng.random(n) < 0.7), t(rng.integers(0, 16, n).astype(np.int32)), 16))
    for offset in range(1, 16):
        rows = 5003 + offset
        out.append((t(rng.random(rows) < 0.6)[offset:],
                    t(rng.integers(0, 16, rows).astype(np.int32))[offset:], 16))
    for num_out in (16, 64):
        b = rng.integers(-3, num_out + 3, 100_003).astype(np.int32)
        b[:7] = (np.iinfo(np.int32).min, -1, num_out, num_out + 1, np.iinfo(np.int32).max, 0,
                 num_out - 1)
        out.append((t(rng.random(100_003) < 0.7), t(b), num_out))
    return out


def new_kernel_stress(device, n, seed=5):
    """K14-K16 at n rows, made from a seed with numpy: K14 over days
    spanning 1900-2100 with the leap days of 1900 / 2000 / 2100, negative
    days and the NULL sentinel, for each field; K15 over an aggregate of
    NULL keys and values (count(*), count, sum, min, max); K16 over int32
    keys with NULL codes and int64 extremes, where dead rows carry any
    value (the kernel hashes every row), into 8 partitions.  Forced
    collisions for K16 are checked by the caller."""
    import numpy as np
    import pyarrow as pa
    import torch

    from arrow_ballista_tpu_torch.compile import fused as F
    from arrow_ballista_tpu_torch.models import expr as E
    from arrow_ballista_tpu_torch.models.schema import FLOAT64, INT32, INT64, Field, Schema
    from arrow_ballista_tpu_torch.ops import operators as O
    from arrow_ballista_tpu_torch.ops.physical import MemoryScanExec, TaskContext
    from tests.torch_cases import edge_days

    rng = np.random.default_rng(seed)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    edges = edge_days()
    days = rng.integers(-25567, 47482, n).astype(np.int32)  # 1900-01-01 .. 2099-12-31
    days[rng.random(n) < 0.02] = np.iinfo(np.int32).min  # NULL dates
    neg = rng.random(n) < 0.01  # any negative day
    days[neg] = rng.integers(-2**31 + 1, 0, int(neg.sum()))
    days[: len(edges)] = edges
    day_t = t(days)

    def nullable(values, typ, share=0.1):
        return pa.array(np.where(rng.random(n) < share, None, values), type=typ)

    table = pa.table({"k": nullable(rng.integers(-5, 2**40, n), pa.int64()),
                      "k2": nullable(rng.integers(0, 9, n).astype(np.int32), pa.int32()),
                      "v": nullable(rng.integers(-2**62, 2**62, n), pa.int64()),
                      "x": nullable(rng.normal(size=n), pa.float64())})
    schema = Schema([Field("k", INT64, True), Field("k2", INT32, True), Field("v", INT64, True),
                     Field("x", FLOAT64, True)])
    agg = O.HashAggregateExec(
        MemoryScanExec(schema, table, partitions=1),
        [(E.Column("k"), "k"), (E.Column("k2"), "k2")],
        [O.AggSpec("count", None, "n"), O.AggSpec("count", E.Column("v"), "nv"),
         O.AggSpec("sum", E.Column("v"), "s"), O.AggSpec("min", E.Column("x"), "lo"),
         O.AggSpec("max", E.Column("k2"), "hi")], "partial")
    ctx = TaskContext(device=device)
    prog = F.PassthroughProgram(agg, ctx)
    batch = agg.input.execute(0, ctx)[0]
    aux = prog.compiled[0].aux_arrays(batch.dicts)
    keys = [t(rng.integers(-1, 50, n).astype(np.int32)),
            t(np.where(rng.random(n) < 0.05, np.iinfo(np.int64).min,
                       rng.integers(-2**63, 2**63 - 1, n, dtype=np.int64)))]
    live = t(rng.random(n) < 0.6)
    one = 1 << 17  # K16's one-launch limit
    return {"extract_field": [(day_t, f) for f in ("year", "month", "day")],
            "passthrough_rows": [(prog, batch.columns, batch.mask, aux)],
            "spill_partition": [(keys, 8)],
            "spill_order": [(keys, live, 8), (keys, torch.zeros_like(live), 8),
                            ([k[:one] for k in keys], live[:one], 4),
                            ([k[:one + 1] for k in keys], live[:one + 1], 2)]}


ALL_DAYS_CHUNK = 1 << 27


def extract_all_days_check(K, device) -> dict:
    """K14 against its twin over every int32 day, each field, in chunks of
    ``ALL_DAYS_CHUNK`` consecutive days made on the card; exact."""
    import torch

    lo, hi = -(2 ** 31), 2 ** 31
    checked = 0
    for start in range(lo, hi, ALL_DAYS_CHUNK):
        days = torch.arange(start, min(start + ALL_DAYS_CHUNK, hi), dtype=torch.int64,
                            device=device).to(torch.int32)
        want = K.civil_from_days_plain(days)
        for field, code in K.EXTRACT_FIELDS.items():
            if not torch.equal(K.extract_field(days, field), want[code]):
                raise AssertionError(f"EXTRACT({field}) differs from the twin in the days "
                                     f"[{start}, {start + days.numel()})")
        checked += days.numel()
        del days, want
    torch.cuda.synchronize()
    return {"days": checked, "fields": len(K.EXTRACT_FIELDS), "max_abs_err": 0}


def civil_launch(wrapper: str):
    """The wrapper (K19's, K12's or K13's) that launches a generated
    program."""
    from arrow_ballista_tpu_torch.compile import fused as F
    from arrow_ballista_tpu_torch.compile import programs as P

    return getattr(P if wrapper == "operator_program" else F, wrapper)


def civil_program_time(K, key: str, args, device) -> dict:
    """One generated program that inlines K14's civil core (``civil_key``)
    at one call: held against its twin (exact but float sums), its device
    ms (everything one call queues, the inputs rotating past the L2), wall
    ms and bound (``program_bytes`` / ``fused_bytes``)."""
    from arrow_ballista_tpu_torch.compile import fused as F

    wrapper = key.split(":")[0]
    prog, cols, mask = args[:3]
    if wrapper == "operator_program":
        err = check_kernel(K, f"operator_program:{prog.label}", args)
        moved = program_bytes(*args)
    else:
        err = fused_check(F, wrapper, args)
        moved = fused_bytes(prog, cols, mask, args[4] if wrapper == "fused_agg" else 0)
    nxt = rotating(args, moved)
    launch = civil_launch(wrapper)
    fn = lambda: launch(*nxt())  # noqa: E731
    wall = time_ms(fn, device)
    ms, source = device_ms(fn) if device.type == "cuda" else (None, None)
    return {"program": key, "rows": int(mask.shape[0]), "max_abs_err": err,
            "ms": wall if ms is None else ms, "ms_source": source or "wall", "wall_ms": wall,
            "bound_ms": moved / HBM_BYTES_PER_S * 1000}


def extract_program_timings(K, civil: dict, device) -> dict:
    """Each generated program that inlines K14's civil core (K19 on pq_q7-q9,
    K13 / K12 on sa_q7-q9) at its largest call on its path
    (``civil_program_time``); per path the sum over its programs."""
    out = {}
    for path, calls in civil.items():
        progs = [civil_program_time(K, key, args, device)
                 for key, (_n, args) in sorted(calls.items())]
        total = sum(p["ms"] for p in progs)
        out[path] = {"programs": progs, "ms_sum": total}
        log(f"{path}: the generated programs that inline the civil core, largest call each: "
            f"device ms sum {total}; {json.dumps(progs)}")
    return out


def mesh_stress(device, n, seed=6):
    """K17, K18 and the mesh derive at n rows, made from a seed with numpy:
    K17 with 2, 4 and 8 destinations, the capacities fitting (10% over the
    even share) and overflowing (10% under it), over int64, float64,
    int32, float32 and bool columns with dead rows, and 40 int64 columns
    at n / 8 rows (past one launch's 32 of a width); K18 over 2, 4 and 8
    rank arrays of n slots (int64 sums that wrap, int64 min, int32 sums,
    float64 sums and max, bool OR), and its many-column form over 1 and 4
    ranks of n slots and 8 ranks of 72 columns (nine launches), each merge
    with int64 sums that wrap and min, int32 max, float64 sums, float64
    min and max with NaN, float32 counts, exists counts and a bool flag;
    the derive of an aggregate with NULL keys and values (count(*), count,
    sum, min, max)."""
    import math

    import numpy as np
    import pyarrow as pa
    import torch

    from arrow_ballista_tpu_torch.compile import fused as F
    from arrow_ballista_tpu_torch.models import expr as E
    from arrow_ballista_tpu_torch.models.schema import INT32, INT64, Field, Schema
    from arrow_ballista_tpu_torch.ops import mesh_exec as M
    from arrow_ballista_tpu_torch.ops import operators as O
    from arrow_ballista_tpu_torch.ops.kernels import MERGE_EXISTS
    from arrow_ballista_tpu_torch.ops.physical import MemoryScanExec, TaskContext

    rng = np.random.default_rng(seed)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    mask = t(rng.random(n) < 0.9)
    cols = {"i64": t(rng.integers(-2**63, 2**63 - 1, n, dtype=np.int64)),
            "f64": t(rng.normal(size=n)), "i32": t(rng.integers(-9, 9, n).astype(np.int32)),
            "f32": t(rng.random(n).astype(np.float32)), "b": t(rng.random(n) < 0.5)}
    dispatch = []
    for n_dest in (2, 4, 8):
        dest = t(rng.integers(0, n_dest, n).astype(np.int32))
        share = n * 0.9 / n_dest
        for factor in (1.1, 0.9):
            dispatch.append((cols, dest, mask, n_dest, math.ceil(share * factor)))
    # 40 int64 columns: past one launch's 32 of a width, so two launches
    n_wide = n // 8
    wide = {f"w{i}": t(rng.integers(-2**62, 2**62, n_wide)) for i in range(40)}
    dispatch.append((wide, t(rng.integers(0, 4, n_wide).astype(np.int32)), mask[:n_wide], 4,
                     math.ceil(n_wide * 0.9 / 4 * 1.1)))
    merge = []
    for ranks in (2, 4, 8):
        wrap = [t(rng.integers(2**62, 2**63 - 1, n, dtype=np.int64)) for _ in range(ranks)]
        merge += [(wrap, "sum"), (wrap, "min"),
                  ([t(rng.integers(0, 1000, n).astype(np.int32)) for _ in range(ranks)], "sum"),
                  ([t(rng.normal(size=n) * 1e6) for _ in range(ranks)], "sum"),
                  ([t(rng.normal(size=n)) for _ in range(ranks)], "max"),
                  ([t(rng.random(n) < 0.01) for _ in range(ranks)], "or")]

    def columns(ranks, slots):  # one dense merge's columns of every dtype and merge
        nan = lambda a: np.where(rng.random(slots) < 0.05, np.nan, a)  # noqa: E731
        return [([t(rng.integers(2**62, 2**63 - 1, slots, dtype=np.int64)) for _ in range(ranks)],
                 "sum"),
                ([t(rng.integers(-2**63, 2**63 - 1, slots, dtype=np.int64))
                  for _ in range(ranks)], "min"),
                ([t(rng.integers(-2**31, 2**31 - 1, slots).astype(np.int32))
                  for _ in range(ranks)], "max"),
                ([t(rng.normal(size=slots) * 1e6) for _ in range(ranks)], "sum"),
                ([t(nan(rng.normal(size=slots))) for _ in range(ranks)], "min"),
                ([t(nan(rng.normal(size=slots))) for _ in range(ranks)], "max"),
                ([t(rng.random(slots).astype(np.float32)) for _ in range(ranks)], "count"),
                ([t((rng.integers(0, 2**31 - 1, slots) * (rng.random(slots) < 0.3))
                    .astype(np.int32)) for _ in range(ranks)], MERGE_EXISTS),
                ([t(rng.random(1) < 0.2) for _ in range(ranks)], "or")]

    # the many-column form: nine columns of every dtype in one launch, and
    # 72 columns over 8 ranks (past one table's 64 rank arrays: nine launches)
    merge += [Wrapped("merge_rank_columns", (columns(ranks, n),)) for ranks in (1, 4)]
    merge.append(Wrapped("merge_rank_columns", ([c for _ in range(8) for c in columns(8, 4099)],)))

    def nullable(values, typ, share=0.1):
        return pa.array(np.where(rng.random(n) < share, None, values), type=typ)

    table = pa.table({"k": nullable(rng.integers(0, 9, n).astype(np.int32), pa.int32()),
                      "v": nullable(rng.integers(-2**62, 2**62, n), pa.int64())})
    schema = Schema([Field("k", INT32, True), Field("v", INT64, True)])
    groups = [(E.Column("k"), "k")]
    aggs = [O.AggSpec("count", None, "n"), O.AggSpec("count", E.Column("v"), "nv"),
            O.AggSpec("sum", E.Column("v"), "s"), O.AggSpec("min", E.Column("v"), "lo"),
            O.AggSpec("max", E.Column("k"), "hi")]
    ctx = TaskContext(device=device)
    batch = MemoryScanExec(schema, table, partitions=1).execute(0, ctx)[0]
    prog = F.MeshDeriveProgram(schema, groups, aggs, "stress")
    compiled = M.compile_agg_exprs(schema, groups, aggs, device)
    aux = compiled[0].aux_arrays(batch.dicts)
    return {"dispatch_to_buckets": dispatch, "merge_rank_states": merge,
            "mesh_derive": [(prog, compiled, batch.columns, batch.mask, aux)]}


def fused_stress(device, n, seed=4):
    """K12 and K13 at n rows, made from a seed with numpy: a row chain and
    two aggregate chains (a dictionary-code key, which takes the dense path,
    and an int64 key, which takes the sort path) over one table with NULL
    keys and values, int64 values whose sums and products wrap, float64
    values with NULLs and a dictionary predicate.  Returns {kernel:
    [(program, cols, mask, auxs[, out_cap, key_ranges])]}."""
    import numpy as np
    import pyarrow as pa

    from arrow_ballista_tpu_torch.catalog import MemoryTable
    from arrow_ballista_tpu_torch.compile import fused as F
    from arrow_ballista_tpu_torch.models import expr as E
    from arrow_ballista_tpu_torch.models.batch import concat_batches
    from arrow_ballista_tpu_torch.ops import kernels as K
    from arrow_ballista_tpu_torch.ops import operators as O
    from arrow_ballista_tpu_torch.ops.physical import TaskContext

    rng = np.random.default_rng(seed)

    def dict_col(words, null_share):
        codes = rng.integers(0, len(words), n).astype(np.int32)
        return pa.DictionaryArray.from_arrays(
            pa.array(codes, mask=rng.random(n) < null_share), pa.array(words))

    table = pa.table({
        "s": dict_col(["apple", "apricot", "beta", "gamma", "avocado", "delta", "zeta"], 0.02),
        "s2": dict_col(["alpha", "omega", "zeta", "kappa"], 0.0),
        "g2": pa.array(rng.integers(0, n // 4, n).astype(np.int64), mask=rng.random(n) < 0.01),
        "v": pa.array(rng.integers(2**61, 2**62, n).astype(np.int64),
                      mask=rng.random(n) < 0.02),
        "f": pa.array(rng.random(n) * 100, mask=rng.random(n) < 0.02),
    })
    ctx = TaskContext(device=device)
    scan = MemoryTable("stress", table).scan(None, [], 1)
    big = concat_batches(scan.schema, scan.execute(0, ctx), device=device).shrink()
    rows = [O.FilterExec(scan, E.BinOp("or", E.Like(E.Column("s"), "a%"),
                                       E.BinOp(">", E.Column("g2"), E.Lit(1000))))]
    rows.insert(0, O.ProjectionExec(rows[0], [
        (E.Column("s"), "s"), (E.BinOp("*", E.Column("v"), E.Lit(3)), "wrap"),
        (E.BinOp("%", E.Column("g2"), E.Lit(-7)), "mod"),
        (E.BinOp("-", E.Column("g2"), E.Column("v")), "diff"),
        (E.IsNull(E.Column("g2")), "null_key"), (E.InList(E.Column("s"), ["beta", "zeta"]),
                                                 "in_list")]))
    out = {"fused_rows": [], "fused_agg": []}
    prog = F.FusedStageExec(rows).program(ctx)
    auxs, _ = prog.auxs_and_dicts(big.dicts)
    out["fused_rows"].append((prog, big.columns, big.mask, auxs))
    for key in ("s", "g2"):
        filt = O.FilterExec(scan, E.BinOp("<>", E.Column("s2"), E.Lit("zeta")))
        aggs = [O.AggSpec("sum", E.Column("v"), "sv"), O.AggSpec("sum", E.Column("f"), "sf"),
                O.AggSpec("min", E.Column("v"), "mnv"), O.AggSpec("max", E.Column("f"), "mxf"),
                O.AggSpec("count", E.Column("v"), "cv"), O.AggSpec("count", None, "c")]
        agg = O.HashAggregateExec(filt, [(E.Column(key), key)], aggs, "partial")
        prog = F.FusedStageExec([agg, filt]).program(ctx)
        auxs, dicts = prog.auxs_and_dicts(big.dicts)
        ranges = agg._key_ranges(prog.agg_compiled[1], dicts)
        cap = big.capacity
        domain = K.dense_domain(ranges)
        if (domain is not None) != (key == "s"):
            fail(f"fused stress: the {key} chain took the wrong K13 form")
        out["fused_agg"].append((prog, big.columns, big.mask, auxs,
                                 min(cap, domain) if domain else cap, ranges))
    return out


def dense_sweep_chain(device, n, slots, seed=11):
    """K13's dense form over a synthetic chain of n rows whose live rows
    fall evenly on ``slots`` key pairs (of 256: two dictionary keys of 16
    words each, a 289-slot domain as q1's): a filter, then a partial
    aggregate of an int64 sum, a float64 sum, a count, an int64 min and a
    float64 max.  Returns K13's arguments (program, cols, mask, auxs,
    out_cap, key_ranges)."""
    import numpy as np
    import pyarrow as pa

    from arrow_ballista_tpu_torch.catalog import MemoryTable
    from arrow_ballista_tpu_torch.compile import fused as F
    from arrow_ballista_tpu_torch.models import expr as E
    from arrow_ballista_tpu_torch.models.batch import concat_batches
    from arrow_ballista_tpu_torch.ops import kernels as K
    from arrow_ballista_tpu_torch.ops import operators as O
    from arrow_ballista_tpu_torch.ops.physical import TaskContext

    rng = np.random.default_rng(seed)
    words = [f"w{i:02d}" for i in range(16)]
    pairs = rng.permutation(256)[:slots]
    pick = pairs[rng.integers(0, slots, n)]
    table = pa.table({
        "a": pa.DictionaryArray.from_arrays(pa.array((pick // 16).astype(np.int32)),
                                            pa.array(words)),
        "b": pa.DictionaryArray.from_arrays(pa.array((pick % 16).astype(np.int32)),
                                            pa.array(words)),
        "v": pa.array(rng.integers(-10**6, 10**6, n).astype(np.int64)),
        "f": pa.array(rng.random(n) * 100),
    })
    ctx = TaskContext(device=device)
    scan = MemoryTable("sweep", table).scan(None, [], 1)
    big = concat_batches(scan.schema, scan.execute(0, ctx), device=device).shrink()
    filt = O.FilterExec(scan, E.BinOp(">", E.Column("v"), E.Lit(-990_000)))
    aggs = [O.AggSpec("sum", E.Column("v"), "sv"), O.AggSpec("sum", E.Column("f"), "sf"),
            O.AggSpec("count", None, "c"), O.AggSpec("min", E.Column("v"), "mnv"),
            O.AggSpec("max", E.Column("f"), "mxf")]
    agg = O.HashAggregateExec(filt, [(E.Column("a"), "a"), (E.Column("b"), "b")], aggs,
                              "partial")
    prog = F.FusedStageExec([agg, filt]).program(ctx)
    auxs, dicts = prog.auxs_and_dicts(big.dicts)
    ranges = agg._key_ranges(prog.agg_compiled[1], dicts)
    domain = K.dense_domain(ranges)
    if domain is None:
        fail("dense sweep chain: no dense key domain")
    return prog, big.columns, big.mask, auxs, min(big.capacity, domain), ranges


def fused_check(F, name, args):
    """K12 or K13 against its twin on the same inputs: every column and the
    mask (K12, NaN where the twin has NaN), every group (K13; float sums at
    rtol 1e-12, the atomic order differs)."""
    if name == "fused_rows":
        (got_cols, got_mask), (want_cols, want_mask) = F.fused_rows(*args), \
            F.fused_rows_plain(*args)
        err = max_err(got_mask, want_mask)
        for col, t in want_cols.items():
            err = max(err, max_err(got_cols[col], t.expand(got_mask.shape[0]).contiguous()))
        return err
    got, want = F.fused_agg(*args), F.fused_agg_plain(*args)
    if (got[3] is None) != (want[3] is None) or (got[3] is not None and
                                                  bool(got[3]) != bool(want[3])):
        raise AssertionError("overflow flags differ")
    err = max_err(got[2], want[2])
    for g, w in zip(got[0], want[0]):
        err = max(err, max_err(g, w))
    for (_dt, how), g, w in zip(args[0].gen.vals, got[1], want[1]):
        err = max(err, max_err(g, w, rtol=1e-12 if how == "sum" and w.dtype.is_floating_point
                               else 0.0))
    return err


def merge_err(xs, how, got, want) -> float:
    """One merged column against its twin: exact, but a float sum within
    1e-12 (float32: 1e-6) of its terms' summed magnitude (the twin adds in
    its own order; a float sum's rounding scales with its terms, not with
    its result, which may cancel to ~0)."""
    import torch

    if how in ("sum", "count") and xs[0].dtype.is_floating_point:
        tol = 1e-6 if xs[0].dtype == torch.float32 else 1e-12
        got, want = got.cpu(), want.cpu()
        if got.dtype != want.dtype or got.shape != want.shape:
            raise AssertionError(f"merged {got.dtype}{tuple(got.shape)}, the twin "
                                 f"{want.dtype}{tuple(want.shape)}")
        diff = (got - want).abs()
        scale = torch.stack([x.abs().cpu() for x in xs]).sum(0)
        if not bool((diff <= tol * scale).all()):
            raise AssertionError(f"float sums differ beyond {tol} of the terms' "
                                 f"magnitude: {float(diff.max())}")
        return float(diff.max()) if diff.numel() else 0.0
    return max_err(got, want)


def check_kernel(K, name, args):
    if name.startswith("operator_program"):  # K19: the new mask, or every column, exact
        from arrow_ballista_tpu_torch.compile import programs as P

        got, want = P.operator_program(*args), P.operator_program_plain(*args)
        n = args[2].shape[0]
        if args[0].kind == "mask":
            return max_err(got, want.expand(n).contiguous())
        if list(got) != list(want):
            raise AssertionError(f"program columns differ: {list(got)} vs {list(want)}")
        return max(max_err(got[c], w.expand(n).contiguous()) for c, w in want.items())
    if name == "concat_columns":
        (gc, gm), (wc, wm) = K.concat_columns(*args), K.concat_columns_plain(*args)
        return max([max_err(gm, wm)] + [max_err(gc[c], w) for c, w in wc.items()])
    if name == "gather_columns":
        got, want = K.gather_columns(*args), K.gather_columns_plain(*args)
        return max([0.0] + [max_err(got[c], w) for c, w in want.items()])
    if name == "pack_for_host":
        (gb, gf), (wb, wf) = K.pack_for_host(*args), K.pack_for_host_plain(*args)
        return max(max_err(gb, wb), max_err(gf, wf) if wf is not None else 0.0)
    if name in ("window_mask", "mask_or", "mask_and", "mask_andnot", "bucket_masks"):
        return max_err(getattr(K, name)(*args), getattr(K, f"{name}_plain")(*args))
    if name == "dispatch_to_buckets":  # every buffer slot, the mask, the counts, the flag
        (gc, gm, go, gn), (wc, wm, wo, wn) = (K.dispatch_to_buckets(*args),
                                              K.dispatch_to_buckets_plain(*args))
        if bool(go) != bool(wo):
            raise AssertionError("overflow flags differ")
        err = max(max_err(gm, wm), max_err(gn, wn))
        return max(err, max(max_err(gc[c], w) for c, w in wc.items()))
    if name == "merge_rank_states":
        xs, how = args
        return merge_err(xs, how, K.merge_rank_states(*args), K.merge_rank_states_plain(*args))
    if name == "merge_rank_columns":  # every column
        (columns,) = args
        got, want = K.merge_rank_columns(columns), K.merge_rank_columns_plain(columns)
        if len(got) != len(want):
            raise AssertionError(f"{len(got)} merged columns, the twin {len(want)}")
        return max([0.0] + [merge_err(xs, how, g, w)
                            for (xs, how), g, w in zip(columns, got, want)])
    if name == "mesh_derive":  # every derived column, exact
        from arrow_ballista_tpu_torch.compile import fused as F

        got, want = F.mesh_derive(*args), F.mesh_derive_plain(*args)
        if list(got) != list(want):
            raise AssertionError(f"derived columns differ: {list(got)} vs {list(want)}")
        return max(max_err(got[c], w) for c, w in want.items())
    if name in ("fused_rows", "fused_agg"):
        from arrow_ballista_tpu_torch.compile import fused as F

        return fused_check(F, name, args)
    if name == "passthrough_rows":  # every key and state column, exact
        from arrow_ballista_tpu_torch.compile import fused as F

        got, want = F.passthrough_rows(*args), F.passthrough_rows_plain(*args)
        n = args[2].shape[0]
        if list(got) != list(want):
            raise AssertionError(f"state columns differ: {list(got)} vs {list(want)}")
        return max(max_err(got[c], w.expand(n).contiguous()) for c, w in want.items())
    if name == "extract_field":
        return max_err(K.extract_field(*args), K.extract_field_plain(*args))
    if name == "spill_partition":
        return max_err(K.spill_partition(*args), K.spill_partition_plain(*args))
    if name == "spill_order":  # the partitions, the order and the live count
        got, want = K.spill_order(*args), K.spill_order_plain(*args)
        if int(got[2]) != int(want[2]):
            raise AssertionError(f"live counts differ: {int(got[2])} vs {int(want[2])}")
        return max(max_err(got[0], want[0]), max_err(got[1], want[1]))
    if name == "dense_group_states":
        return dense_check(K, args)
    if name == "dense_grouped":
        return dense_grouped_check(K, args)
    if name == "compaction_order":  # with its live count
        (mask,) = args
        got, count = K.compaction_order(mask, with_count=True)
        if int(count) != int(mask.sum()):
            raise AssertionError("live counts differ")
        return max_err(got, K.compaction_order_plain(mask))
    if name == "bucket_of":
        keys, n = args
        err = max_err(K.bucket_of(keys, n), K.bucket_of_plain(keys, n))
        return max(err, max_err(K.hash64(keys), K.hash64_plain(keys)))
    if name == "hash64":
        return max_err(K.hash64(*args), K.hash64_plain(*args))
    if name == "sort_order":
        got = K.sort_order(*args)
        plan = K.radix_plan(name)
        RADIX_PLANS.append({"kernel": name, **{k: v for k, v in plan.items() if k != "layout"}})
        if plan and plan["layout"] != K.sort_layout_of(*args):  # the device's, in one block
            raise AssertionError(f"sort_order's {plan['form']} layout {plan['layout']} is not "
                                 f"sort_layout's {K.sort_layout_of(*args)}")
        return max_err(got, K.sort_order_plain(*args))
    if name == "build_side_sort":
        got, want = K.build_side_sort(*args), K.build_side_sort_plain(*args)
        RADIX_PLANS.append({"kernel": name, "forced_collisions": bool(K._FORCE_COLLISIONS),
                            **K.radix_plan(name)})
        err = max_err(got[0], want[0]) + max_err(got[1], want[1])
        if int(got[2]) != int(want[2]):
            raise AssertionError("live build row counts differ")
        return err
    if name == "probe_join":  # every slot: the twin mirrors the invalid ones too
        got, want = K.probe_join(*args), K.probe_join_plain(*args)
        err = max(max_err(g, w) for g, w in zip(got[:3], want[:3]))
        if int(got[3]) != int(want[3]):
            raise AssertionError(f"pair totals differ: {int(got[3])} vs {int(want[3])}")
        return err
    if name == "probe_counts":  # (inclusive offsets when asked, else None; total)
        got, want = K.probe_counts(*args), K.probe_counts_plain(*args)
        if (got[0] is None) != (want[0] is None):
            raise AssertionError("offsets returned by one side only")
        if int(got[1]) != int(want[1]):
            raise AssertionError(f"pair totals differ: {int(got[1])} vs {int(want[1])}")
        return 0.0 if want[0] is None else max_err(got[0], want[0])
    if name == "segment_any":
        return max_err(K.segment_any(*args), K.segment_any_plain(*args))
    if name == "presorted_disorder":
        if bool(K.presorted_disorder(*args)) != bool(K.presorted_disorder_plain(*args)):
            raise AssertionError("disorder flags differ")
        return 0.0
    if name == "key_range_check":
        if bool(K.key_range_check(*args)) != bool(K.key_range_check_plain(*args)):
            raise AssertionError("range-check flags differ")
        return 0.0
    if name == "clustered_keep":
        (gk, gl), (wk, wl) = K.clustered_keep(*args), K.clustered_keep_plain(*args)
        if int(gl) != int(wl):
            raise AssertionError(f"live counts differ: {int(gl)} vs {int(wl)}")
        return max_err(gk, wk)
    if name == "grouped_on_order":
        vals = args[1]
        got, want = K.grouped_on_order(*args), K.grouped_on_order_plain(*args)
        err = max_err(got[2], want[2])
        if (got[3] is None) != (want[3] is None) or \
                (got[3] is not None and bool(got[3]) != bool(want[3])):
            raise AssertionError("overflow flags differ")
        for g, w in zip(got[0], want[0]):
            err = max(err, max_err(g, w))
        for (v, how), g, w in zip(vals, got[1], want[1]):
            float_sum = how == "sum" and v.dtype.is_floating_point
            err = max(err, max_err(g, w, rtol=1e-12 if float_sum else 0.0))
        return err
    raise KeyError(name)


# --------------------------------------------------------------------------
# per-kernel timing at the main path's shapes
# --------------------------------------------------------------------------


def fused_bytes(prog, cols, mask, out_rows):
    """Bytes a fused chain must move: each input column it reads and the
    mask once, its lookup tables, and its output once — K12's columns and
    mask; K13's groups (``out_rows`` of keys, values and mask)."""
    n = mask.shape[0]
    read = sum(cols[name].element_size() * n for name, _dt in prog.gen.inputs) + n
    if prog.agg is None:
        written = sum(dt.itemsize * n for _name, dt in prog.gen.outputs) + n
    else:
        written = out_rows * (sum(dt.itemsize for dt in prog.gen.key_dtypes)
                              + sum(8 if how == "count" else dt.itemsize
                                    for dt, how in prog.gen.vals) + 1)
    return read + written


def program_bytes(prog, cols, mask, auxs) -> int:
    """Bytes a K19 program must move: each input column it reads, the mask
    where it is read (a mask program), the lookup tables, each computed
    column or the new mask written once (an output that is an input column
    aliases it and moves nothing)."""
    n = mask.shape[0]
    gen = prog.gen
    return (sum(cols[c].element_size() * n for c, _dt in gen.inputs)
            + sum(auxs[step][slot].numel() * auxs[step][slot].element_size()
                  for step, slot, _dt in gen.aux)
            + sum(dt.itemsize * n for _c, dt in gen.outputs)
            + (2 * n if prog.kind == "mask" else 0))


def rotating(args, moved, span=64 << 20, most=64):
    """A function returning ``args`` and clones of them in turn: enough
    copies (at least two, at most ``most``) that back-to-back calls move
    more than the 50 MB L2, so a timing loop reads device memory, not the
    cache (a call that moves more than the L2 alone may still find its
    randomly read columns there when the next call reads the same ones)."""
    import itertools

    copies = [args] + [_clone(args) for _ in range(max(1, min(most, span // max(moved, 1))))]
    return itertools.cycle(copies).__next__


def kernel_timings(K, name, args, device):
    """(times, bytes moved); times: kernel, plain twin and library call (or
    for K12 / K13 the interpreted chain: the same closures on TorchOps, then
    the K1/K2 or K4/K8 kernels) as device ms and wall ms."""
    import torch

    extra = {}  # more timed functions, by label
    if name == "operator_program":
        from arrow_ballista_tpu_torch.compile import programs as P

        moved = program_bytes(*args)
        nxt = rotating(args, moved)
        kern = lambda: P.operator_program(*nxt())  # noqa: E731
        plain = lambda: P.operator_program_plain(*nxt())  # noqa: E731
        library = None  # no one PyTorch call computes an expression tree
        extra["interpreted_"] = plain  # the twin is the interpreted closures
    elif name == "concat_columns":
        cols_list, masks, pad = args
        out_rows = sum(m.shape[0] for m in masks) + pad
        row_bytes = sum(c.element_size() for c in cols_list[0].values()) + 1
        # every source element read once, every destination element (the
        # pad too) written once
        moved = (out_rows - pad) * row_bytes + out_rows * row_bytes
        nxt = rotating(args, moved)
        kern = lambda: K.concat_columns(*nxt())  # noqa: E731
        plain = lambda: K.concat_columns_plain(*nxt())  # noqa: E731
        names = list(cols_list[0])

        def library():  # torch.cat of each column and of the masks
            c, m, _p = nxt()
            return [torch.cat([x[k] for x in c]) for k in names], torch.cat(list(m))
    elif name in ("gather_columns", "pack_for_host"):
        if name == "pack_for_host":
            cols, mask, target, n64, nf64, n32 = args[:6]
            order = args[6] if len(args) > 6 else None
            idx = (K.compaction_order(mask) if order is None else order[0])[:target]
            sel = {k: cols[k] for k in (*n64, *nf64, *n32)}
            args = (idx, sel)
        idx, sel = args
        m = idx.shape[0]
        # the index read once, each gathered element read and written once
        moved = nbytes(idx) + 2 * m * sum(c.element_size() for c in sel.values())
        nxt = rotating(args, moved)
        kern = lambda: K.gather_columns(*nxt())  # noqa: E731
        plain = lambda: K.gather_columns_plain(*nxt())  # noqa: E731

        def library():  # index_select of each column at the int64 index
            i, c = nxt()
            li = i.long()
            return [v.index_select(0, li) for v in c.values()]
    elif name in ("window_mask", "mask_or", "mask_and", "mask_andnot"):
        a, b = args[0], args[1] if name != "window_mask" else None
        moved = 2 * nbytes(a) + (nbytes(b) if b is not None else 0)
        nxt = rotating(args, moved)
        kern = lambda: getattr(K, name)(*nxt())  # noqa: E731
        plain = lambda: getattr(K, f"{name}_plain")(*nxt())  # noqa: E731
        # one PyTorch call for each two-mask op (a & ~b is a > b on bools);
        # none for the window
        library = {"mask_or": lambda: torch.bitwise_or(*nxt()),
                   "mask_and": lambda: torch.bitwise_and(*nxt()),
                   "mask_andnot": lambda: torch.gt(*nxt())}.get(name)
    elif name == "bucket_masks":
        mask, bucket, num_out = args
        moved = bucket_masks_bytes(mask, num_out)
        nxt = rotating(args, moved)
        kern = lambda: K.bucket_masks(*nxt())  # noqa: E731
        plain = lambda: K.bucket_masks_plain(*nxt())  # noqa: E731
        parts = torch.arange(num_out, dtype=torch.int32, device=device)[:, None]

        def library():  # a composite, not one call: compare and AND, broadcast
            m, b, _q = nxt()
            return (b[None] == parts) & m
    elif name == "dispatch_to_buckets":
        cols, dest, mask, n_dest, cap = args
        # dest and mask read once, each column's live rows once (a dead row
        # goes nowhere); every slot of every send buffer and of the send
        # mask written once, and the counts
        live = int(mask.sum())
        moved = nbytes(dest, mask) + live * sum(c.element_size() for c in cols.values()) \
            + n_dest * cap * (sum(c.element_size() for c in cols.values()) + 1) + n_dest * 4 + 1
        nxt = rotating(args, moved)
        kern = lambda: K.dispatch_to_buckets(*nxt())  # noqa: E731
        plain = lambda: K.dispatch_to_buckets_plain(*nxt())  # noqa: E731
        library = None  # no one PyTorch call ranks rows within their bucket
    elif name == "merge_rank_states":
        xs, how = args
        moved = nbytes(*xs) + nbytes(xs[0])
        nxt = rotating(args, moved)
        kern = lambda: K.merge_rank_states(*nxt())  # noqa: E731
        plain = lambda: K.merge_rank_states_plain(*nxt())  # noqa: E731
        library = None  # the twin's stack + reduce is two calls
    elif name == "merge_rank_columns":
        (columns,) = args
        # every rank array read once, every merged column written once (an
        # exists column as bools)
        moved = sum(nbytes(*xs) + xs[0].numel() * (1 if how == K.MERGE_EXISTS
                                                    else xs[0].element_size())
                    for xs, how in columns)
        nxt = rotating(args, moved)
        kern = lambda: K.merge_rank_columns(*nxt())  # noqa: E731
        plain = lambda: K.merge_rank_columns_plain(*nxt())  # noqa: E731
        library = None  # one stack + reduce a column

        def per_column():  # the parent's form: a launch a column, then the compare
            (cols,) = nxt()
            outs = [K.merge_rank_states(xs, K.AGG_SUM if how == K.MERGE_EXISTS else how)
                    for xs, how in cols]
            return [o > 0 if how == K.MERGE_EXISTS else o for o, (_xs, how) in zip(outs, cols)]
        extra["per_column_"] = per_column
    elif name == "mesh_derive":
        from arrow_ballista_tpu_torch.compile import fused as F

        prog, compiled, cols, mask, aux = args
        n = mask.shape[0]
        # the input columns the computed outputs read and the lookup tables
        # once, each computed output written once (an output that is an
        # input column aliases it)
        moved = (sum(cols[c].element_size() * n for c, _dt in prog.gen.inputs)
                 + sum(aux[slot].numel() * aux[slot].element_size()
                       for _step, slot, _dt in prog.gen.aux)
                 + sum(dt.itemsize * n for _c, dt in prog.gen.outputs))
        nxt = rotating(args, moved)
        kern = lambda: F.mesh_derive(*nxt())  # noqa: E731
        plain = lambda: F.mesh_derive_plain(*nxt())  # noqa: E731
        library = None  # no one PyTorch call computes a derive
        extra["interpreted_"] = plain
    elif name == "passthrough_rows":
        from arrow_ballista_tpu_torch.compile import fused as F

        prog, cols, mask, aux = args
        n = mask.shape[0]
        # each input column the computed states read and the lookup tables
        # once; each computed state written once (the keys and the states
        # that are an input column alias it and move no byte)
        moved = (sum(cols[c].element_size() * n for c, _dt in prog.gen.inputs)
                 + sum(aux[slot].numel() * aux[slot].element_size()
                       for _step, slot, _dt in prog.gen.aux)
                 + sum(dt.itemsize * n for _c, dt in prog.gen.outputs))
        nxt = rotating(args, moved)
        kern = lambda: F.passthrough_rows(*nxt())  # noqa: E731
        plain = lambda: F.passthrough_rows_plain(*nxt())  # noqa: E731
        library = None  # no one PyTorch call computes the per-row states
    elif name == "extract_field":
        days, field = args
        moved = nbytes(days) * 2  # int32 days in, int32 fields out
        kern = lambda: K.extract_field(days, field)  # noqa: E731
        plain = lambda: K.extract_field_plain(days, field)  # noqa: E731
        library = None  # PyTorch has no calendar arithmetic on integer days
    elif name == "spill_order":
        keys, mask, parts = args
        # the keys and the mask read once, the partition of every row and
        # the live part of the order written once
        moved = nbytes(*keys, mask) + 4 * mask.shape[0] + 4 * int(mask.sum())
        nxt = rotating(args, moved)
        kern = lambda: K.spill_order(*nxt())  # noqa: E731
        plain = lambda: K.spill_order_plain(*nxt())  # noqa: E731
        library = None  # no PyTorch call computes this hash

        def parent_pair():  # the parent's split: K16's first form, then the pack's K2
            k, m, p = nxt()
            return K.spill_partition(k, p), K.compaction_order(m, with_count=True)
        extra["parent_pair_"] = parent_pair
    elif name == "spill_partition":
        keys, parts = args
        moved = nbytes(*keys) + keys[0].shape[0] * 4
        kern = lambda: K.spill_partition(keys, parts)  # noqa: E731
        plain = lambda: K.spill_partition_plain(keys, parts)  # noqa: E731
        library = None  # no PyTorch call computes this hash
    elif name in ("fused_rows", "fused_agg"):
        from arrow_ballista_tpu_torch.compile import fused as F

        prog, cols, mask, auxs = args[:4]
        if name == "fused_rows":
            moved = fused_bytes(prog, cols, mask, 0)
            kern = lambda: F.fused_rows(*args)  # noqa: E731
            plain = lambda: F.fused_rows_plain(*args)  # noqa: E731
            interpreted = plain  # no kernel runs in an interpreted row chain
        else:
            out_cap, ranges = args[4], args[5]
            moved = fused_bytes(prog, cols, mask, out_cap)
            kern = lambda: F.fused_agg(*args)  # noqa: E731
            plain = lambda: F.fused_agg_plain(*args)  # noqa: E731

            def interpreted():
                keys, vals, m = F._agg_key_vals_plain(prog, cols, mask, auxs)
                return K.grouped_aggregate(keys, vals, m, out_cap, key_ranges=ranges)
        library = None  # no one PyTorch call computes a fused chain
        extra["interpreted_"] = interpreted
    elif name in ("dense_group_states", "dense_grouped"):
        if name == "dense_grouped":
            key_cols, val_cols, mask, out_cap, key_ranges, domain = args
            moved = dense_bytes(key_cols, val_cols, mask, out_cap)
            kern = lambda: K.dense_grouped(*args)  # noqa: E731
            plain = lambda: K.dense_grouped_plain(*args)  # noqa: E731
        else:
            key_cols, val_cols, mask, key_ranges, domain = args
            moved = dense_bytes(key_cols, val_cols, mask, domain, compacted=False)
            kern = lambda: K.dense_group_states(*args)  # noqa: E731
            plain = lambda: K.dense_group_states_plain(*args)  # noqa: E731
        # one library call for the same sums and counts: index_add_ of the
        # stacked value matrix at precomputed slot ids
        sizes, strides = K._dense_strides(key_ranges)
        seg = torch.zeros(mask.shape, dtype=torch.int64, device=device)
        ok = mask.clone()
        for k, (lo, hi), st in zip(key_cols, key_ranges, strides):
            ki = k.to(torch.int64)
            ok &= (ki >= lo) & (ki <= hi)
            seg += (ki - lo) * st
        seg = torch.where(ok, seg, domain)
        mat = torch.stack([(v if how != "count" else torch.ones_like(v)) * ok
                           for v, how in val_cols], dim=1)
        if all(how in ("sum", "count") for _, how in val_cols):
            def library():
                return torch.zeros(domain + 1, mat.shape[1], dtype=mat.dtype,
                                   device=device).index_add_(0, seg, mat)
        else:
            library = None
    elif name == "compaction_order":
        (mask,) = args
        moved = nbytes(mask) + mask.numel() * 4
        kern = lambda: K.compaction_order(mask)  # noqa: E731
        plain = lambda: K.compaction_order_plain(mask)  # noqa: E731
        library = lambda: torch.argsort(~mask, stable=True)  # noqa: E731
    elif name == "bucket_of":
        keys, n = args
        moved = nbytes(*keys) + keys[0].numel() * 4
        kern = lambda: K.bucket_of(keys, n)  # noqa: E731
        plain = lambda: K.bucket_of_plain(keys, n)  # noqa: E731
        library = None  # no PyTorch call computes this hash
    elif name == "sort_order":
        keys, mask = args
        moved = nbytes(mask, *[k for k, _ in keys]) + mask.numel() * 4
        kern = lambda: K.sort_order(keys, mask)  # noqa: E731
        plain = lambda: K.sort_order_plain(keys, mask)  # noqa: E731
        # the same permutation from one stable sort of a composite word,
        # valid for the main path's small dictionary codes
        word = (~mask).to(torch.int64)
        small = all(k.dtype == torch.int32 and int(k.min()) >= -1 and int(k.max()) < 2**19
                    for k, _ in keys)
        if small:
            for k, asc in keys:
                w = k.to(torch.int64) + 1
                word = word * (1 << 20) + (w if asc else (1 << 20) - 1 - w)
            library = lambda: torch.sort(word, stable=True)  # noqa: E731
        elif len(keys) == 1:
            # one key: one stable sort of its order words with the dead rows
            # last (the word computation left out)
            word1 = torch.where(mask, K.sort_words(*keys[0]), torch.iinfo(torch.int64).max)
            library = lambda: torch.sort(word1, stable=True)  # noqa: E731
        else:
            library = None
    elif name == "build_side_sort":
        keys, mask = args
        n = mask.shape[0]
        moved = nbytes(*keys, mask) + n * 8 + n * 4 + 8
        kern = lambda: K.build_side_sort(keys, mask)  # noqa: E731
        plain = lambda: K.build_side_sort_plain(keys, mask)  # noqa: E731
        # one stable sort of the sign-flipped, dead-masked hashes (the
        # hashing itself left out)
        flipped = torch.where(mask, K.hash64(keys), -1) ^ K._SIGN
        library = lambda: torch.sort(flipped, stable=True)  # noqa: E731
    elif name == "probe_join":
        ph, pm, bh, cap = args
        moved = probe_join_bytes(ph, pm, bh, cap)
        kern = lambda: K.probe_join(ph, pm, bh, cap)  # noqa: E731
        plain = lambda: K.probe_join_plain(ph, pm, bh, cap)  # noqa: E731
        pf, bf = ph ^ K._SIGN, bh ^ K._SIGN
        rows = torch.arange(ph.shape[0], device=device)
        total = int(K.probe_counts_plain(ph, pm, bh)[1])

        def library():  # searchsorted x2 + cumsum + repeat_interleave
            lo = torch.searchsorted(bf, pf, side="left")
            hi = torch.searchsorted(bf, pf, side="right")
            counts = torch.where(pm, hi - lo, 0)
            return torch.cumsum(counts, 0), torch.repeat_interleave(rows, counts,
                                                                    output_size=total)
    elif name == "segment_any":
        v, seg, ns = args[:3]
        within = args[3] if len(args) > 3 else None
        # the values read once, the segment id of each true value, the
        # mask folded in read once, the verdicts written once
        moved = nbytes(v) + int((v > 0).sum()) * seg.element_size() + ns \
            + (nbytes(within) if within is not None else 0)
        nxt = rotating(args, moved)
        kern = lambda: K.segment_any(*nxt())  # noqa: E731
        plain = lambda: K.segment_any_plain(*nxt())  # noqa: E731
        v32 = v.to(torch.int32)
        seg64 = torch.where((seg >= 0) & (seg < ns), seg, ns).long()
        library = lambda: torch.zeros(ns + 1, dtype=torch.int32, device=device).scatter_reduce_(  # noqa: E731
            0, seg64, v32, "amax")
    elif name == "grouped_on_order":
        keys, vals, mask, cap, n, order = args
        moved = grouped_on_order_bytes(*args)
        nxt = rotating(args, moved)
        kern = lambda: K.grouped_on_order(*nxt())  # noqa: E731
        plain = lambda: K.grouped_on_order_plain(*nxt())  # noqa: E731
        # the library's calls run on the columns in group order
        idx = order.long()
        keys, vals, mask = [k[idx] for k in keys], [(v[idx], how) for v, how in vals], mask[idx]
        # index_add_ / scatter_reduce_ of each column at the twin's segment
        # ids (the K4 order, the gathers and the boundary scan left out)
        first = torch.arange(n, device=device) == 0
        diff = torch.zeros(n, dtype=torch.bool, device=device)
        for k in keys:
            diff |= k != torch.roll(k, 1)
        boundary = mask & (first | diff) if keys else first & mask.any()
        seg = torch.cumsum(boundary.to(torch.int64), 0) - 1
        ok = mask & (seg >= 0) & (seg < cap)
        seg = torch.where(ok, seg, cap)
        prepared = [(torch.where(ok, v, torch.zeros((), dtype=v.dtype, device=device))
                     if how != "count" else ok.to(torch.int64), how, v.dtype) for v, how in vals]

        def library():
            out = []
            for v, how, dt in prepared:
                if how in ("sum", "count"):
                    out.append(torch.zeros(cap + 1, dtype=v.dtype, device=device).index_add_(
                        0, seg, v))
                else:
                    out.append(torch.zeros(cap + 1, dtype=v.dtype, device=device).scatter_reduce_(
                        0, seg, v, "amin" if how == "min" else "amax", include_self=False))
            return out
    elif name == "presorted_disorder":
        keys, mask = args
        # the mask read once and the keys of the live rows (a dead row's key
        # decides nothing)
        moved = nbytes(mask) + int(mask.sum()) * keys.element_size() + 1
        nxt = rotating(args, moved)
        kern = lambda: K.presorted_disorder(*nxt())  # noqa: E731
        plain = lambda: K.presorted_disorder_plain(*nxt())  # noqa: E731
        library = None  # no one PyTorch call computes the flag
    elif name == "key_range_check":
        keys, mask, lo, hi, sent = args
        moved = nbytes(mask) + int(mask.sum()) * keys.element_size() + 1
        nxt = rotating(args, moved)
        kern = lambda: K.key_range_check(*nxt())  # noqa: E731
        plain = lambda: K.key_range_check_plain(*nxt())  # noqa: E731
        # the min and max of the live keys in one call (the masking and the
        # compare with the range left out)
        live = mask if sent is None else mask & (keys != sent)
        masked = torch.where(live, keys.to(torch.int64), keys.to(torch.int64)[0])
        library = lambda: torch.aminmax(masked)  # noqa: E731
    elif name == "clustered_keep":
        keys, mask, pred, iv = args
        # mask and predicate read once, the live rows' keys, the merged
        # intervals, the keep bytes written once
        moved = nbytes(mask, pred, iv.starts, iv.ends) + int(mask.sum()) * keys.element_size() \
            + mask.numel() + 8
        nxt = rotating(args, moved)
        kern = lambda: K.clustered_keep(*nxt())  # noqa: E731
        plain = lambda: K.clustered_keep_plain(*nxt())  # noqa: E731
        # the interval search in one call: bucketize of the keys into the
        # sorted interval starts (the padded ones, as before the merge; the
        # end compare and the keep left out)
        starts = torch.sort(iv.los).values
        library = lambda: torch.bucketize(keys, starts, right=True)  # noqa: E731
    else:
        raise KeyError(name)
    times = {}
    for label, fn in (("", kern), ("plain_", plain), ("library_", library),
                      *extra.items()):
        if fn is None:
            times[label + "ms"] = times[label + "wall_ms"] = times[label + "ms_source"] = None
            continue
        times[label + "wall_ms"] = time_ms(fn, device)
        ms, source = None, None
        if device.type == "cuda" and times.get("ms_source") == "queued_events":
            # the kernel's time came from queued events (the profiler saw
            # none of its launches): its yardsticks are read the same way,
            # launch gaps included on both sides
            ms = queued_events_ms(fn)
            source = "queued_events" if ms is not None else None
        if ms is None and device.type == "cuda":
            ms, source = device_ms(fn)
        if source == "profiler" and ms < moved / HBM_BYTES_PER_S * 1000:
            # below the least time the card could take for this work: the
            # profiler lost launches of its window; read queued events
            queued = queued_events_ms(fn)
            if queued is not None:
                ms, source = queued, "queued_events"
        if ms is None:
            ms, source = times[label + "wall_ms"], "wall"
        times[label + "ms"], times[label + "ms_source"] = ms, source
    return times, moved


def topk_timings(K, device, n, k=100, seed=8):
    """Row 9 of the kernel table, ``kernels.topk_order`` (K4 and a slice;
    no caller in either package), at a synthetic shape: ``n`` int64 keys,
    a 0.9 live mask, the first ``k`` positions; beside ``torch.topk`` of the
    masked keys, and the bound (keys and mask read once, ``k`` int32
    positions written)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    keys = torch.from_numpy(rng.integers(-2**40, 2**40, n)).to(device)
    mask = torch.from_numpy(rng.random(n) < 0.9).to(device)
    masked = torch.where(mask, keys, torch.iinfo(torch.int64).max)
    moved = nbytes(keys, mask) + 4 * k
    out = {"rows": n, "k": k, "bound_ms": moved / HBM_BYTES_PER_S * 1000, "bound_bytes": moved}
    for label, fn in (("", lambda: K.topk_order([(keys, True)], mask, k)),
                      ("library_", lambda: torch.topk(masked, k, largest=False, sorted=True))):
        out[label + "wall_ms"] = time_ms(fn, device)
        out[label + "ms"], out[label + "ms_source"] = device_ms(fn)
    log(f"topk_order (K4 + slice) at {n} int64 keys, k={k}: device {out['ms']} ms, wall "
        f"{out['wall_ms']:.4f} ms; torch.topk device {out['library_ms']} ms, wall "
        f"{out['library_wall_ms']:.4f} ms; bound {out['bound_ms']:.6f} ms ({moved} bytes)")
    return out


def radix_stress_timings(K, device, sort_inputs, build_inputs):
    """K4 and K5 at their stress shapes beside their yardsticks: K4 at 6M
    rows of one full-range int64 key and of eight keys over 64 bits, at
    five group keys over 1,024 rows and seven over 262,144, and at 131,072
    rows of one key (the local engine's batch: wall against device time is
    the host's share, the read-back of the layout included); K5 at 2^23
    rows in both hash modes.  Device and wall ms of the kernel, its twin and
    (one key, K5) one torch.sort, the bound, and the call's plan."""
    import numpy as np
    import torch

    out = {}

    def timed(label, kern, plain, library, moved, plan_of):
        kern()
        rec = {"plan": K.radix_plan(plan_of), "bound_ms": moved / HBM_BYTES_PER_S * 1000,
               "bound_bytes": moved}
        for key, fn in (("", kern), ("plain_", plain), ("library_", library)):
            if fn is None:
                rec[key + "ms"] = rec[key + "wall_ms"] = None
                continue
            rec[key + "wall_ms"] = time_ms(fn, device)
            rec[key + "ms"], rec[key + "ms_source"] = device_ms(fn)
        out[label] = rec
        log(f"radix stress {label}: plan {json.dumps(rec['plan'])}; device kernel "
            f"{rec['ms']} ms, plain {rec['plain_ms']}, library {rec['library_ms']}; wall kernel "
            f"{rec['wall_ms']:.4f} ms; bound {rec['bound_ms']:.6f} ms ({moved} bytes)")

    for label, (keys, mask) in zip(("k4_full_range_6m", "k4_eight_keys_6m", "k4_five_keys_1024",
                                    "k4_seven_keys_262144"), sort_inputs):
        moved = nbytes(mask, *[k for k, _ in keys]) + mask.numel() * 4
        word = None
        if len(keys) == 1:  # one stable sort of the key's words, dead rows last
            word = torch.where(mask, K.sort_words(*keys[0]), torch.iinfo(torch.int64).max)
        timed(label, lambda: K.sort_order(keys, mask), lambda: K.sort_order_plain(keys, mask),
              (lambda: torch.sort(word, stable=True)) if word is not None else None, moved,
              "sort_order")
    rng = np.random.default_rng(10)
    small = torch.from_numpy(rng.integers(1, 6_000_000, 1 << 17)).to(device)
    smask = torch.from_numpy(rng.random(1 << 17) < 0.9).to(device)
    sword = torch.where(smask, K.sort_words(small, True), torch.iinfo(torch.int64).max)
    timed("k4_one_key_131072", lambda: K.sort_order([(small, True)], smask),
          lambda: K.sort_order_plain([(small, True)], smask),
          lambda: torch.sort(sword, stable=True), nbytes(small, smask) + smask.numel() * 4,
          "sort_order")
    keys, mask = build_inputs
    n = mask.shape[0]
    moved = nbytes(*keys, mask) + n * 8 + n * 4 + 8
    flipped = torch.where(mask, K.hash64(keys), -1) ^ K._SIGN
    timed("k5_2p23", lambda: K.build_side_sort(keys, mask),
          lambda: K.build_side_sort_plain(keys, mask), lambda: torch.sort(flipped, stable=True),
          moved, "build_side_sort")
    was = K._FORCE_COLLISIONS
    K._FORCE_COLLISIONS = True
    try:
        timed("k5_2p23_forced_collisions", lambda: K.build_side_sort(keys, mask),
              lambda: K.build_side_sort_plain(keys, mask), None, moved, "build_side_sort")
    finally:
        K._FORCE_COLLISIONS = was
    return out


def dense_hot_slot_sweep(K, args, device, slots=(1, 4, 64, 289)):
    """K1's compacted form on the main path's largest call with its live
    rows spread evenly over ``slots`` groups instead of q1's four, each
    held against its twin: a test of whether a few hot slots set K1's
    time.  Returns {slots: device ms}."""
    import torch

    key_cols, val_cols, mask, out_cap, key_ranges, domain = args
    sizes, strides = K._dense_strides(key_ranges)
    g = torch.Generator(device=device).manual_seed(7)
    out = {}
    for h in slots:
        if h > domain:
            continue
        chosen = torch.randperm(domain, generator=g, device=device)[:h]
        slot = chosen[torch.randint(0, h, mask.shape, generator=g, device=device)]
        keys = []
        for k, (lo, _hi), size, st in zip(key_cols, key_ranges, sizes, strides):
            keys.append(((slot // st) % size + lo).to(k.dtype))
        sargs = (keys, val_cols, mask, out_cap, key_ranges, domain)
        dense_grouped_check(K, sargs)
        out[h] = device_ms(lambda: K.dense_grouped(*sargs))[0]
    return out


def k13_hot_slot_sweep(F, device, n, slots=(1, 4, 64, 256)):
    """K13's dense form over ``dense_sweep_chain`` at n rows, live rows on
    each count of key pairs, each held against the interpreted chain.
    Returns {slots: device ms}."""
    out = {}
    for h in slots:
        args = dense_sweep_chain(device, n, h)
        fused_check(F, "fused_agg", args)
        nxt = rotating(args, fused_bytes(args[0], args[1], args[2], args[4]))
        out[h] = device_ms(lambda: F.fused_agg(*nxt()))[0]
    return out


KERNEL_META = {
    "fused_rows": ("arrow_ballista_tpu_torch/csrc/fused_rows.cuh",
                   "arrow_ballista_tpu/compile/fused.py:188"),
    "fused_agg": ("arrow_ballista_tpu_torch/csrc/fused_rows.cuh",
                  "arrow_ballista_tpu/compile/fused.py:204"),
    "dense_group_states": ("arrow_ballista_tpu_torch/csrc/dense_agg.cu",
                           "arrow_ballista_tpu/ops/kernels.py:564"),
    "compaction_order": ("arrow_ballista_tpu_torch/csrc/compact.cu",
                         "arrow_ballista_tpu/ops/kernels.py:88"),
    "bucket_of": ("arrow_ballista_tpu_torch/csrc/hash.cu",
                  "arrow_ballista_tpu/ops/kernels.py:77"),
    "sort_order": ("arrow_ballista_tpu_torch/csrc/sort.cu",
                   "arrow_ballista_tpu/ops/kernels.py:195"),
    "build_side_sort": ("arrow_ballista_tpu_torch/csrc/join_build.cu",
                        "arrow_ballista_tpu/ops/kernels.py:728"),
    "probe_join": ("arrow_ballista_tpu_torch/csrc/probe.cu",
                   "arrow_ballista_tpu/ops/kernels.py:739"),
    "segment_any": ("arrow_ballista_tpu_torch/csrc/segment.cu",
                    "arrow_ballista_tpu/ops/kernels.py:772"),
    "grouped_on_order": ("arrow_ballista_tpu_torch/csrc/seg_agg.cu",
                         "arrow_ballista_tpu/ops/kernels.py:314"),
    "presorted_disorder": ("arrow_ballista_tpu_torch/csrc/clustered.cu",
                           "arrow_ballista_tpu/ops/kernels.py:237"),
    "key_range_check": ("arrow_ballista_tpu_torch/csrc/clustered.cu",
                        "arrow_ballista_tpu/ops/operators.py:632"),
    "clustered_keep": ("arrow_ballista_tpu_torch/csrc/clustered.cu",
                       "arrow_ballista_tpu/ops/operators.py:672"),
    "extract_field": ("arrow_ballista_tpu_torch/csrc/extract.cu",
                      "arrow_ballista_tpu/ops/kernels.py:800"),
    "passthrough_rows": ("arrow_ballista_tpu_torch/csrc/fused_rows.cuh",
                         "arrow_ballista_tpu/ops/operators.py:745"),
    "spill_partition": ("arrow_ballista_tpu_torch/csrc/hash.cu",
                        "arrow_ballista_tpu/ops/operators.py:1512"),
    "spill_order": ("arrow_ballista_tpu_torch/csrc/compact.cu",
                    "arrow_ballista_tpu/ops/operators.py:1512"),
    "dispatch_to_buckets": ("arrow_ballista_tpu_torch/csrc/dispatch.cu",
                            "arrow_ballista_tpu/parallel/ici_shuffle.py:33"),
    "merge_rank_states": ("arrow_ballista_tpu_torch/csrc/rank_merge.cu",
                          "arrow_ballista_tpu/parallel/distributed.py:136"),
    "mesh_derive": ("arrow_ballista_tpu_torch/csrc/fused_rows.cuh",
                    "arrow_ballista_tpu/ops/mesh_exec.py:98"),
    "operator_program": ("arrow_ballista_tpu_torch/csrc/fused_rows.cuh",
                         "arrow_ballista_tpu/ops/physical.py:630"),
    "concat_columns": ("arrow_ballista_tpu_torch/csrc/gather.cu",
                       "arrow_ballista_tpu/models/batch.py:435"),
    "gather_columns": ("arrow_ballista_tpu_torch/csrc/gather.cu",
                       "arrow_ballista_tpu/models/batch.py:439"),
    "bucket_masks": ("arrow_ballista_tpu_torch/csrc/gather.cu",
                     "arrow_ballista_tpu/ops/shuffle.py:493"),
    "mask_ops": ("arrow_ballista_tpu_torch/csrc/gather.cu",
                 "arrow_ballista_tpu/ops/operators.py:1029"),
}
# K19 replaces one program at each of these sites (KERNEL_META names the
# first); K21 also replaces pack_for_host's gathers, K22 all three mask
# programs
REPLACES_ALL = {
    "operator_program": ["arrow_ballista_tpu/ops/physical.py:630",
                         "arrow_ballista_tpu/ops/operators.py:183",
                         "arrow_ballista_tpu/ops/operators.py:317",
                         "arrow_ballista_tpu/ops/operators.py:885",
                         "arrow_ballista_tpu/ops/operators.py:1319",
                         "arrow_ballista_tpu/ops/operators.py:1794",
                         "arrow_ballista_tpu/ops/shuffle.py:157",
                         "arrow_ballista_tpu/ops/shuffle.py:499"],
    "gather_columns": ["arrow_ballista_tpu/models/batch.py:439",
                       "arrow_ballista_tpu/ops/kernels.py:122"],
    "mask_ops": ["arrow_ballista_tpu/ops/operators.py:1029",
                 "arrow_ballista_tpu/ops/operators.py:1037",
                 "arrow_ballista_tpu/ops/operators.py:1040"],
}
# the one PyTorch call each kernel's library_ms times (yardsticks only)
LIBRARY_CALL = {
    "fused_rows": None,
    "fused_agg": None,
    "dense_group_states": "index_add_ of the stacked values at precomputed slot ids",
    "compaction_order": "argsort(~mask, stable=True)",
    "bucket_of": None,
    "sort_order": "sort(stable=True) of a composite word of small codes, or of a single "
                  "key's words",
    "build_side_sort": "sort(stable=True) of the sign-flipped hashes",
    "probe_join": "a composite, not one call: searchsorted x2 + cumsum + repeat_interleave",
    "segment_any": "scatter_reduce_(amax) (the hit alone; the mask folded in is left out)",
    "grouped_on_order": "index_add_ / scatter_reduce_ at the twin's segment ids",
    "presorted_disorder": None,
    "key_range_check": "aminmax of the masked keys",
    "clustered_keep": "bucketize of the keys into the sorted interval starts",
    "extract_field": None,
    "passthrough_rows": None,
    "spill_partition": None,
    "spill_order": None,
    "dispatch_to_buckets": None,
    "merge_rank_states": None,
    "mesh_derive": None,
    "operator_program": None,
    "concat_columns": "torch.cat of each column and of the masks",
    "gather_columns": "index_select of each column at the int64 index",
    "mask_ops": "per op: a | b (mask_or), a & b (mask_and), a > b (mask_andnot: a & ~b on "
                "bools); none for the window",
    "bucket_masks": "a composite, not one call: (bucket[None] == arange(Q)[:, None]) & mask",
}
LAUNCH_KEY = {name: name for name in KERNEL_META}
LAUNCH_KEY["bucket_of"] = "hash64"
# kernel -> the wrappers that launch it, each held against its twin
WRAPPERS = {name: (name,) for name in KERNEL_META}
WRAPPERS["bucket_of"] = ("bucket_of", "hash64")
WRAPPERS["probe_join"] = ("probe_join", "probe_counts")
# K1: the compacted form (grouped_aggregate's dense path) and the
# slot-aligned one (the mesh's dense reduce); timed at the compacted form's
# largest call, the slot-aligned form's beside it
WRAPPERS["dense_group_states"] = ("dense_grouped", "dense_group_states")
WRAPPERS["gather_columns"] = ("gather_columns", "pack_for_host")
WRAPPERS["mask_ops"] = ("window_mask", "mask_or", "mask_and", "mask_andnot")
# K18: the many-column form (the mesh's dense merge) and its one-column case
WRAPPERS["merge_rank_states"] = ("merge_rank_states", "merge_rank_columns")


# --------------------------------------------------------------------------
# main
# --------------------------------------------------------------------------


def run(device_name: str = "cuda", sf: float = SF, stress_rows: int = STRESS_ROWS,
        sa_partitions: str = "auto", save_calls: str = None, obs_only: bool = False,
        remote_only: bool = False) -> dict:
    """The whole check.  ``sa_partitions``: the standalone engine's shuffle
    partitions ('auto' as bench.py runs it; a CPU rehearsal at a small scale
    factor passes a count, as 'auto' then plans one stage and fuses nothing).
    ``obs_only`` / ``remote_only``: the build, the data and phase obs /
    phase remote alone."""
    import torch

    sys.path.insert(0, ROOT)
    try:
        from arrow_ballista_tpu_torch import BallistaConfig, BallistaContext
        from arrow_ballista_tpu_torch import entry as port_entry
        from arrow_ballista_tpu_torch.compile import fused as F
        from arrow_ballista_tpu_torch.memory import STATS as MEMORY_STATS
        from arrow_ballista_tpu_torch.ops import _cuda
        from arrow_ballista_tpu_torch.ops import kernels as K
        from arrow_ballista_tpu_torch.ops.physical import TaskContext
        from arrow_ballista_tpu_torch.parallel import collectives as C
        from arrow_ballista_tpu_torch.parallel import use_local_devices
        from arrow_ballista_tpu_torch.utils import table_cache
        from benchmarks.datagen import generate_tables
        from benchmarks.queries import QUERIES
        from tests.torch_cases import (assert_frames_equal, check_against_sqlite,
                                       check_ordering, sqlite_answer, sqlite_oracle)
    except ImportError as e:
        fail(f"cannot import the port from {ROOT}: {e}")
    if any(m == "jax" or m.startswith("jax.") or m.startswith("arrow_ballista_tpu.")
           or m == "arrow_ballista_tpu" for m in sys.modules):
        fail("the port imported JAX or the JAX package")
    device = torch.device(device_name)
    cuda = device.type == "cuda"
    report = {"kernels": []}

    # phase 2: build
    if cuda:
        t0 = time.perf_counter()
        _cuda.LIBRARIES.build_all()
        for name in _cuda.SIGNATURES:
            _cuda.LIBRARIES.get(name)
        log(f"build: {time.perf_counter() - t0:.3f} s for {len(_cuda.SIGNATURES)} kernel "
            f"libraries (nvcc {_cuda.LIBRARIES.build_seconds:.3f} s, parallel)")
        phase_done("build", t0)

    # phase 3: the main paths
    t0 = time.perf_counter()
    tables = generate_tables(sf, seed=0)
    lineitem = tables["lineitem"]
    log(f"datagen: SF{sf} lineitem {lineitem.num_rows} rows in "
        f"{time.perf_counter() - t0:.1f} s (set-up)")
    phase_done("datagen", t0)
    ctx = BallistaContext.local(device=device)
    for name, table in tables.items():
        ctx.register_table(name, table)
    t0 = time.perf_counter()
    os.makedirs(os.path.join(ROOT, "tmp"), exist_ok=True)  # ignored by git
    pq_dir = tempfile.mkdtemp(prefix="chip_smoke_parquet_", dir=os.path.join(ROOT, "tmp"))
    atexit.register(shutil.rmtree, pq_dir, True)
    pq_paths, rg_rows = write_parquet(tables, sf, pq_dir)
    log(f"parquet: {', '.join(PARQUET_TABLES)} written with {rg_rows}-row row groups in "
        f"{time.perf_counter() - t0:.1f} s (set-up), "
        f"{sum(os.path.getsize(p) for p in pq_paths.values())} bytes")
    phase_done("parquet_write", t0)
    pctx = BallistaContext.local(device=device)
    for name, path in pq_paths.items():
        pctx.register_parquet(name, path)
    spill_sf = min(sf, SPILL_SF)
    spill_pq = pq_paths
    if spill_sf < sf:  # the spill paths' own tables
        t0 = time.perf_counter()
        spill_dir = os.path.join(pq_dir, "spill")
        os.makedirs(spill_dir)
        spill_pq, spill_rg = write_parquet(generate_tables(spill_sf, seed=0), spill_sf, spill_dir)
        log(f"parquet at SF{spill_sf} (the spill paths): "
            f"{spill_rg}-row row groups, written in {time.perf_counter() - t0:.1f} s (set-up)")
        phase_done("spill_data", t0)
    sqls = {"q1": QUERIES[1], "q3": QUERIES[3], "q4": QUERIES[4]}
    # the standalone engine with bench.py's base config: 'auto' shuffle
    # partitions, 2^20-row batches, four task slots
    sa_cfg = {"ballista.shuffle.partitions": sa_partitions,
              "ballista.batch.size": str(1 << 20)}
    sa_pq = BallistaContext.standalone(BallistaConfig(sa_cfg), concurrent_tasks=4,
                                       device=device)
    sa_mem = BallistaContext.standalone(BallistaConfig(sa_cfg), concurrent_tasks=4,
                                        device=device)
    atexit.register(sa_pq.shutdown)
    atexit.register(sa_mem.shutdown)
    for name, path in pq_paths.items():
        sa_pq.register_parquet(name, path)
    for name, table in tables.items():
        sa_mem.register_table(name, table)
    if obs_only:
        t_phase = time.perf_counter()
        report["obs"] = obs_phase(device, ctx, sa_pq, sqls, {"q1": q1_oracle(lineitem),
                                                             "q3": q3_oracle(tables)}, K)
        phase_done("obs", t_phase)
        report["phase_s"] = dict(PHASE_S)
        return report
    # no order of the small scale factors' rehearsals passes q18's 300
    q18_having = 300 if sf >= 1 else 200
    q18 = QUERIES[18].replace("> 300", f"> {q18_having}")
    if remote_only:
        # the standalone paths' rows and walls the remote runs are held
        # against, then the phase
        rm_sqls = {"q1": sqls["q1"], "q3": sqls["q3"], "q18": q18}
        sa_frames, sa_walls = {}, {}
        for q, sql in rm_sqls.items():
            walls = []
            for _ in range(2):
                t0 = time.perf_counter()
                frame = sa_pq.sql(sql).to_pandas()
                if cuda:
                    torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1000)
            sa_frames[q] = frame
            sa_walls[q] = {"cold_ms": walls[0], "warm_ms": walls[1]}
        t_phase = time.perf_counter()
        report["remote"] = remote_phase(
            device, pq_paths, rm_sqls, {"q1": q1_oracle(lineitem), "q3": q3_oracle(tables),
                                        "q18": q18_oracle(tables, q18_having)},
            K, F, sa_cfg, sa_walls, sa_frames)
        phase_done("remote", t_phase)
        report["phase_s"] = dict(PHASE_S)
        return report
    paths = {**{p: (ctx, q) for p, q in sqls.items()},
             **{f"pq_{p}": (pctx, q) for p, q in sqls.items()}, "pq_q18": (pctx, q18),
             **{f"sa_pq_{p}": (sa_pq, q) for p, q in sqls.items()}, "sa_pq_q18": (sa_pq, q18),
             "sa_q18": (sa_mem, q18)}

    # the mesh paths, over the parquet files
    def mesh_context(settings, standalone=False):
        if standalone:
            c = BallistaContext.standalone(BallistaConfig({**sa_cfg, **settings}),
                                           concurrent_tasks=4, device=device)
            atexit.register(c.shutdown)
        else:
            c = BallistaContext.local(BallistaConfig(settings), device=device)
        for name, path in pq_paths.items():
            c.register_parquet(name, path)
        return c

    def mesh_scope(path):
        """The ranks a mesh path runs on: MESH_RANKS over the first card,
        or the default mesh (every card; on a CPU rehearsal, the CPU)."""
        if path in MESH4_PATHS:
            rank = torch.device("cuda", 0) if cuda else device
            return use_local_devices([rank] * MESH_RANKS)
        if path.startswith("mesh") and not cuda:
            return use_local_devices([device])
        return contextlib.nullcontext()

    mesh_ctx = mesh_context(MESH_SETTINGS)
    paths.update({
        "mesh_q1": (mesh_ctx, sqls["q1"]), "mesh4_q1": (mesh_ctx, sqls["q1"]),
        "mesh4_q3": (mesh_context({**MESH_JOINS, "ballista.shuffle.mesh.broadcast_rows":
                                   str(round(MESH_Q3_BROADCAST_ROWS * sf))}), sqls["q3"]),
        "mesh4_q3_part": (mesh_context({**MESH_JOINS,
                                        "ballista.shuffle.mesh.broadcast_rows": "0"}),
                          sqls["q3"]),
        "mesh4_q18": (mesh_context({**MESH_SETTINGS, "ballista.agg.capacity": str(1 << 21)}),
                      q18),
        "sa_hybrid_q3": (mesh_context({**MESH_JOINS, "ballista.shuffle.mesh.hybrid": "true"},
                                      standalone=True), sqls["q3"]),
    })
    mesh_report = {}  # mesh path -> its cold run's mesh metrics and exchange bytes
    base_paths = set(paths)
    # csv at the scale factor under the TPC-H schema (the arrow types of the
    # generated tables, as the parquet registration infers them), so its
    # rows equal the parquet paths' bit for bit; the local engine and the
    # standalone one
    from arrow_ballista_tpu_torch.catalog import arrow_schema_to_engine

    t0 = time.perf_counter()
    csv_paths = write_csv(tables, CSV_TABLES, pq_dir)
    log(f"csv: {', '.join(CSV_TABLES)} written in {time.perf_counter() - t0:.1f} s (set-up), "
        f"{sum(os.path.getsize(p) for p in csv_paths.values())} bytes")
    phase_done("csv_write", t0)
    csv_ctx = BallistaContext.local(device=device)
    sa_csv = BallistaContext.standalone(BallistaConfig(sa_cfg), concurrent_tasks=4,
                                        device=device)
    atexit.register(sa_csv.shutdown)
    for c in (csv_ctx, sa_csv):
        for name, path in csv_paths.items():
            c.register_csv(name, path, schema=arrow_schema_to_engine(tables[name].schema))
    paths.update({"csv_q1": (csv_ctx, sqls["q1"]), "csv_q3": (csv_ctx, sqls["q3"]),
                  "sa_csv_q1": (sa_csv, sqls["q1"])})
    # EXTRACT (local over parquet: K14; standalone in memory: inside K13),
    # the passthrough partial (q20's lineitem partial, standalone in
    # memory), and the spill paths: the local engine over parquet under a
    # 1 MiB host budget, each held bit for bit against its unlimited run
    spctx = BallistaContext.local(BallistaConfig({**SPILL_SETTINGS, **SPILL_BUDGET}),
                                  device=device)
    unlimited = BallistaContext.local(BallistaConfig(SPILL_SETTINGS), device=device)
    for name, path in spill_pq.items():
        spctx.register_parquet(name, path)
        unlimited.register_parquet(name, path)
    paths.update({f"pq_q{q}": (pctx, QUERIES[q]) for q in EXTRACT_QUERIES})
    paths.update({f"sa_q{q}": (sa_mem, QUERIES[q]) for q in EXTRACT_QUERIES})
    paths["sa_q20"] = (sa_mem, QUERIES[20])
    paths["sa_pt"] = (sa_mem, PT_QUERY)
    paths.update({f"spill_q{q}": (spctx, q18 if q == 18 else QUERIES[q]) for q in SPILL_QUERIES})
    # the 22 queries on the port's CPU path, in a child process beside the
    # card's later paths (started after the first twelve, whose times stay
    # clean): the reference answers of the tpch22 path
    answers_path = os.path.join(pq_dir, "cpu_answers.pkl")
    cpu_proc = None

    def start_cpu_answers():
        with open(os.path.join(pq_dir, "cpu_answers.log"), "w") as log_fh:
            proc = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                     "--cpu-answers", pq_dir, answers_path], cwd=ROOT,
                                    stdout=log_fh, stderr=subprocess.STDOUT)
        atexit.register(lambda: proc.poll() is None and proc.kill())
        return proc

    def cpu_answer_frames():
        import pickle

        t0 = time.perf_counter()
        rc = cpu_proc.wait(timeout=900)
        if rc != 0:
            with open(os.path.join(pq_dir, "cpu_answers.log")) as fh:
                fail(f"the CPU answers failed (exit {rc}):\n{fh.read()[-3000:]}")
        log(f"CPU answers: waited {time.perf_counter() - t0:.1f} s for the child process")
        with open(answers_path, "rb") as fh:
            answers = pickle.load(fh)
        # beside the card's paths: not part of the run's sequence of phases
        log(f"phase cpu_answers_child (beside the paths, not added to the total): "
            f"{sum(v[1] for v in answers.values()):.1f} s")
        return answers

    path_frames = {}  # path -> its cold run's frame
    spill_tags = {}  # spill path -> {operator: spill runs} of its cold run

    def once(c, sql):
        t = time.perf_counter()
        df = c.sql(sql).to_pandas()
        if cuda:
            torch.cuda.synchronize()
        return df, time.perf_counter() - t

    captured = {}  # path -> wrapper -> (rows, args) of the path's largest call
    launches = {}  # path -> launch counts of its cold run
    cached = {}  # scan-cache fingerprints after each parquet path's cold run
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    k13_forms = {}  # path -> K13 form -> calls
    civil_calls = {}  # EXTRACT path -> generated program with the civil core -> (rows, args)
    for path, (c, sql) in paths.items():
        t_path = time.perf_counter()
        scope = contextlib.ExitStack()
        scope.enter_context(mesh_scope(path))
        parquet = "pq_" in path or path in MESH_PARQUET
        standalone = path.startswith("sa_")
        if path not in base_paths and cpu_proc is None:
            cpu_proc = start_cpu_answers()
        if path == "mesh4_q3_part" and cuda:
            peak_before = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        C.reset_bytes()
        K.reset_launch_counts()
        builds0 = len(_cuda.LIBRARIES.generated_builds)
        with Capture(K, F, device) as cap, RepartitionBatches() as split, \
                SpillSplitCheck() as spill_split:
            df, cold_s = once(c, sql)
        launches[path] = dict(K.LAUNCHES)
        if spill_split.calls != launches[path]["spill_order"] \
                or spill_split.packed != spill_split.calls or spill_split.k2:
            fail(f"{path}: the spill split made {spill_split.calls} K16 calls "
                 f"({launches[path]['spill_order']} counted), packed {spill_split.packed} "
                 f"batches through K16's order and called K2 {spill_split.k2} times in it "
                 "(every batch through its order and no K2 expected)")
        if spill_split.calls:
            sizes = cap.sizes.get("spill_order", {})
            kernels = sum(c * (1 if rows <= 1 << 17 else 2) for rows, c in sizes.items())
            # the parent's, derived, not measured: one K16 launch a build
            # batch, then the pack's K2 over it (one launch up to 2^17 rows,
            # two above, as this tree's own K2)
            report.setdefault("k16_split", {})[path] = {
                "calls": spill_split.calls, "kernels": kernels, "k2_in_split": 0,
                "parent_derived": {"k16_launches": spill_split.calls,
                                   "k2_kernels": kernels}}
            log(f"{path}: K16 split {spill_split.calls} build batches in {kernels} kernel "
                f"launches and no K2 (the parent, derived: {spill_split.calls} K16 launches "
                f"and {kernels} K2 kernels)")
        batches = sum(b for b, _q in split.splits)
        if launches[path]["bucket_masks"] != batches or (path in ("q1", "pq_q1")
                                                         and not batches):
            fail(f"{path}: K22's bucket form launched {launches[path]['bucket_masks']} times for "
                 f"{batches} repartitioned batches ({split.splits}: (batches, partitions))")
        if split.splits:
            log(f"{path}: K22's bucket form launched {batches} times for {batches} batches "
                f"split into {sorted({q for _b, q in split.splits})} partitions (the parent: "
                f"{sum(b * q for b, q in split.splits)} launches, one a batch and partition)")
            report.setdefault("bucket_launches", {})[path] = {
                "launches": batches, "splits": split.splits}
        cold_builds = len(_cuda.LIBRARIES.generated_builds) - builds0
        if path.startswith("mesh") or path == "sa_hybrid_q3":
            mesh_report[path] = {
                **{k: sum(v.values()) for k, v in op_metrics(job_plans(c), MESH_METRICS).items()},
                "exchange_bytes": dict(C.BYTES)}
            log(f"{path} mesh (cold run): {json.dumps(mesh_report[path])}")
            if not mesh_report[path]["mesh_devices"]:
                fail(f"{path}: no operator ran on the mesh")
            if path == "mesh4_q3_part" and cuda:
                mesh_report[path]["peak_bytes"] = torch.cuda.max_memory_allocated()
                torch.cuda.reset_peak_memory_stats()
        if cap.off_device:
            fail(f"{path}: tensors off the card on the main path: {cap.off_device[:5]}")
        missing = [k for k in PATH_KERNELS[path] if launches[path][k] == 0]
        if missing:
            fail(f"{path}: kernels not launched on its path: {missing} ({launches[path]})")
        captured[path] = cap.calls
        if path in {p for q in EXTRACT_QUERIES for p in (f"pq_q{q}", f"sa_q{q}")}:
            if not cap.civil:
                fail(f"{path}: no call of a generated program with EXTRACT was captured")
            civil_calls[path] = dict(cap.civil)
        log_call_sizes(report, path, cap)
        k13_forms[path] = dict(cap.forms)
        if cap.radix:
            report.setdefault("radix_forms", {})[path] = cap.radix
            log(f"{path} (cold run) K4 / K5 calls by form: {json.dumps(cap.radix)}")
        want_form = K13_FORM.get(path)
        if want_form is not None and not k13_forms[path].get(want_form):
            fail(f"{path}: K13 never took its {want_form} form ({k13_forms[path]})")
        if df.empty or (path in base_paths and df.isna().any().any()) \
                or (path.endswith("q1") and len(df) != 4):
            fail(f"{path} result malformed:\n{df}")
        path_frames[path] = df
        if path.startswith("spill_"):
            spill_tags[path] = op_metrics(job_plans(c), ("spill_runs",))["spill_runs"]
            want, unlimited_s = once(unlimited, sql)
            try:
                assert_frames_equal(df, want, exact=True)
            except AssertionError as e:
                fail(f"{path}: the spilled run differs from the unlimited run: {e}")
            log(f"{path}: equals its unlimited run bit for bit ({len(df)} rows; the unlimited "
                f"run took {unlimited_s * 1000:.1f} ms, first on its context); spill runs by "
                f"operator {json.dumps(spill_tags[path])}")
            report[f"{path}_unlimited_ms"] = unlimited_s * 1000
        if path in {f"pq_q{q}" for q in EXTRACT_QUERIES}:
            from arrow_ballista_tpu_torch.compile import programs as PR

            sources = [p.gen.source for p in PR.trace(job_plans(c)[0], TaskContext(device=device))
                       if p.launches()]
            if not any("ab_civil_field(" in s for s in sources):
                fail(f"{path}: EXTRACT is in no generated program ({len(sources)} programs)")
            log(f"{path}: EXTRACT traced into {sum('ab_civil_field(' in s for s in sources)} "
                f"of {len(sources)} generated K19 programs")
        if path in {f"sa_q{q}" for q in EXTRACT_QUERIES}:
            plans = job_plans(c)
            sources = [n.program(TaskContext(device=device)).gen.source
                       for p in plans for n in _walk_fused(p)]
            if not any("ab_civil_field(" in s for s in sources):
                fail(f"{path}: EXTRACT is in no generated source ({len(sources)} fused chains)")
            log(f"{path}: EXTRACT traced into {sum('ab_civil_field(' in s for s in sources)} "
                f"of {len(sources)} generated sources")
        if path in PASSTHROUGH_PATHS:
            report[f"{path}_passthrough"] = {"cold": check_passthrough(K, c, path, "cold")}
        cold_scan = scan_metrics(job_plans(c))
        if parquet:
            cached.update(cache_fingerprints(table_cache))
        if path == "pq_q18":
            check_clustered(job_plans(c), "cold")
        if standalone:
            split = standalone_split(c, cold_s)
            labels = fused_labels(c)
            log(f"{path} cold: {split['stages']} stages, planned partitions "
                f"{json.dumps(split['planned_partitions'])}, fused chains {json.dumps(labels)}, "
                f"K13 forms {json.dumps(k13_forms[path])}")
            if split["fused_fallbacks"]:
                fail(f"{path}: fused_fallbacks {split['fused_fallbacks']}")
            report[f"{path}_fused_chains"] = labels
            report[f"{path}_cold_split"] = split
        warm = []
        for _ in range(WARM_RUNS[path]):
            K.reset_launch_counts()
            misses = table_cache.CACHE.stats()["misses"]
            _, s = once(c, sql)
            warm.append(s)
            if dict(K.LAUNCHES) != launches[path]:
                # the standalone engine's task threads share a join's
                # capacity hint (ops/operators.py _out_cap_hint): whether a
                # sibling task finds it set decides one count pass (K3 +
                # K6, and K19 where the join keys are computed) more or
                # less, or a rerun of the join at a larger capacity (K3,
                # K6, K7, the pair gathers K21, the verification K19 and a
                # semi or anti verdict K22).  Every other count must repeat.
                # On the passthrough paths the tasks that start after the
                # first one ends emit per-row states: how many do varies
                # with the timing.
                varied = {k for k, v in K.LAUNCHES.items() if v != launches[path][k]}
                allowed = {"hash64", "probe_join", "segment_any", "operator_program",
                           "gather_columns", "mask_ops"}
                if path in PASSTHROUGH_PATHS:
                    allowed |= {"fused_agg", "fused_agg_dense", "passthrough_rows",
                                "sort_order", "grouped_on_order", "compaction_order"}
                if not standalone or not varied <= allowed:
                    fail(f"{path}: warm run launched {dict(K.LAUNCHES)} != cold "
                         f"{launches[path]}")
                log(f"{path}: a warm run's join launches differ from the cold run's: "
                    f"{ {k: (launches[path][k], K.LAUNCHES[k]) for k in sorted(varied)} }")
            if path in PASSTHROUGH_PATHS:
                # the split may vary, the latch may not: every run emits
                # per-row states
                report[f"{path}_passthrough"]["warm"] = check_passthrough(K, c, path, "warm")
            if parquet:
                warm_scan = scan_metrics(job_plans(c))
                if not warm_scan.get("scan_cache_hits") or warm_scan.get("scan_read_time") \
                        or table_cache.CACHE.stats()["misses"] != misses:
                    fail(f"{path}: a warm run missed the scan cache or read a row group "
                         f"again: {warm_scan}")
        warm_builds = len(_cuda.LIBRARIES.generated_builds) - builds0 - cold_builds
        log(f"{path} generated sources built with nvcc: cold run {cold_builds}, warm runs "
            f"{warm_builds}")
        report[f"{path}_generated_builds"] = {"cold": cold_builds, "warm": warm_builds}
        if warm_builds:
            fail(f"{path}: a warm run built {warm_builds} generated sources")
        if path == "pq_q18":
            check_clustered(job_plans(c), "warm")
        if standalone:
            split = standalone_split(c, warm[-1])
            if split["fused_fallbacks"]:
                fail(f"{path}: fused_fallbacks {split['fused_fallbacks']}")
            log(f"{path} time split (last warm run, ms; sums over tasks): "
                f"{json.dumps({k: v for k, v in split.items() if k != 'planned_partitions'})}")
            report[f"{path}_warm_split"] = split
        warm_s = statistics.median(warm) if warm else None
        rows = lineitem.num_rows
        log(f"{path} SF{sf}: cold {cold_s * 1000:.1f} ms ({rows / cold_s:.0f} lineitem rows/s), "
            + (f"warm median of {len(warm)} {warm_s * 1000:.1f} ms ({rows / warm_s:.0f} rows/s) "
               f"[runs ms: {', '.join(f'{w * 1000:.1f}' for w in warm)}]; " if warm else
               "no warm run; ")
            + ("parquet through the scan cache" if parquet else "in-memory tables uploaded "
               "per query (the scan cache holds parquet scans only)"))
        if warm and (parquet or "csv" in path):
            if not parquet:
                warm_scan = scan_metrics(job_plans(c))
            log(f"{path} scan times ms: cold read {cold_scan.get('scan_read_time', 0) * 1000:.1f}, "
                f"convert {cold_scan.get('scan_convert_time', 0) * 1000:.1f}; warm read "
                f"{warm_scan.get('scan_read_time', 0) * 1000:.1f}, convert "
                f"{warm_scan.get('scan_convert_time', 0) * 1000:.1f}, filter "
                f"{warm_scan.get('scan_filter_time', 0) * 1000:.1f}; warm cache hits "
                f"{warm_scan.get('scan_cache_hits')}")
            report[f"{path}_scan"] = {"cold": cold_scan, "warm": warm_scan}
        log(f"{path} launches per query: "
            f"{json.dumps({k: v for k, v in launches[path].items() if v})}")
        log(df.head(10).to_string())
        log(f"{path} operator host times ({'last warm' if warm else 'cold'} run, ms; "
            "elapsed_time includes children):")
        for plan in job_plans(c):
            for line in plan_breakdown(plan):
                log("  " + line)
        report[f"{path}_cold_ms"] = cold_s * 1000
        report[f"{path}_warm_ms"] = warm_s * 1000 if warm else None
        if cuda and not path.startswith("spill_"):
            prof_q = report[f"{path}_profile"] = profile_query(c, sql, path, K)
            if path in ("q3", "pq_q18") and prof_q is None:
                fail(f"{path}'s profiled query recorded no device time: its kernels unchecked")
            if path in ("q3", "pq_q18"):  # K6 and K2: their kernels a call, no memset
                check_call_trace(prof_q["calls"], path)
            if path in FOLDED_VERDICT_PATHS:  # K7: its kernels alone a folded verdict
                acts = report.setdefault("verdict_call_activities", {})[path] = \
                    verdict_call_activities(K, captured[path], path)
                log(f"{path}: device activities one folded verdict queues at its largest K7 "
                    f"call: {json.dumps(acts)}")
            if path in DISPATCH_CALL_PATHS:  # K17: its two kernels alone a call
                acts = report.setdefault("dispatch_call_activities", {})[path] = \
                    dispatch_call_activities(K, captured[path], path)
                log(f"{path}: device activities one K17 call queues at its largest call: "
                    f"{json.dumps(acts)}")
            if path in MERGE_CALL_PATHS:  # K18: one kernel a dense merge
                acts = report.setdefault("merge_call_activities", {})[path] = \
                    merge_call_activities(K, captured[path], path)
                log(f"{path}: device activities one dense merge queues at its largest merge: "
                    f"{json.dumps(acts)}")
            if path in PRESORTED_CALL_PATHS:  # K9 on the rows as they are
                acts = report.setdefault("presorted_call_activities", {})[path] = \
                    presorted_call_activities(K, captured[path], path)
                log(f"{path}: device activities one presorted grouping queues at its largest "
                    f"call: {json.dumps(acts)}")
            if path in DENSE_ONE_LAUNCH:  # K1 / K13 dense: one kernel a call
                if prof_q is None:
                    fail(f"{path}'s profiled query recorded no device time: K1 unchecked")
                check_dense_trace(prof_q["dense"], path)
                acts = report.setdefault("dense_call_activities", {})[path] = \
                    dense_call_activities(K, F, captured[path], path)
                log(f"{path}: device activities one dense aggregate call queues at its largest "
                    f"call: {json.dumps(acts)}")
            if path == "pq_q18":  # K10 and K11: one kernel a call, no memset before it
                for kname, rec in prof_q["clustered"].items():
                    if not rec["launches"] or rec["launches"] != rec["wrapper_calls"] \
                            or rec["memsets"]:
                        fail(f"pq_q18's profiled query: {kname} ran {rec['launches']} kernels "
                             f"for {rec['wrapper_calls']} calls with {rec['memsets']} memsets "
                             "right before them (one kernel a call and no memset expected)")
        scope.close()
        secs = time.perf_counter() - t_path
        PHASE_S[path_group(path)] = PHASE_S.get(path_group(path), 0.0) + secs
        log(f"path {path}: {secs:.1f} s")
    for group in sorted({path_group(p) for p in paths}):
        log(f"phase {group}: {PHASE_S[group]:.1f} s")
    # K1's and K13's dense device ms per profiled warm query
    dense_q = {p: {form: {k: rec[k] for k in ("ms", "launches", "wrapper_calls")}
                   for form, rec in (report.get(f"{p}_profile") or {}).get("dense", {}).items()}
               for p in DENSE_PATHS if p in paths}
    report["dense_ms_per_query"] = dense_q
    log(f"K1 (dense_group_states) / K13 dense (fused_agg_dense) device ms, launches and calls "
        f"per warm query: {json.dumps(dense_q)}")
    # csv: the same rows as the parquet paths, bit for bit
    for a, b in (("csv_q1", "pq_q1"), ("csv_q3", "pq_q3"), ("sa_csv_q1", "sa_pq_q1")):
        try:
            assert_frames_equal(path_frames[a], path_frames[b], exact=True)
        except AssertionError as e:
            fail(f"{a} differs from {b}: {e}")
    log("csv_q1, csv_q3 and sa_csv_q1 equal pq_q1, pq_q3 and sa_pq_q1 bit for bit")
    t_phase = time.perf_counter()
    report["json_avro"] = json_avro_paths(device, pq_dir)
    phase_done("paths_json_avro", t_phase)

    # the mesh paths together: the dense reduce on q1's paths, and across
    # the two q3 runs at least one broadcast and one partitioned mesh join
    for path in ("mesh_q1", "mesh4_q1"):
        if not mesh_report[path]["dense_reduce_collective"]:
            fail(f"{path}: q1 did not take the dense reduce ({mesh_report[path]})")
    q3_joins = {k: sum(mesh_report[p][k] for p in ("mesh4_q3", "mesh4_q3_part"))
                for k in ("broadcast_joins", "partitioned_joins")}
    log(f"mesh q3 joins: broadcast_rows 2^20 "
        f"{json.dumps({k: mesh_report['mesh4_q3'][k] for k in q3_joins})}, broadcast_rows 0 "
        f"{json.dumps({k: mesh_report['mesh4_q3_part'][k] for k in q3_joins})}")
    if not all(q3_joins.values()):
        fail(f"the q3 mesh runs lack a broadcast or a partitioned join: {q3_joins}")
    if cuda:
        # the partitioned q3 join's send buffers, reckoned from its largest
        # dispatch: every rank's [n_dest, capacity] buffers of every column
        # and the mask, alive together, and as many receive buffers
        dcols, _dest, _dmask, n_dest, cap = captured["mesh4_q3_part"]["dispatch_to_buckets"][1]
        per_rank = n_dest * cap * (sum(t.element_size() for t in dcols.values()) + 1)
        reckoned = 2 * MESH_RANKS * per_rank
        mesh_report["mesh4_q3_part"]["send_buffers_reckoned_bytes"] = reckoned
        log(f"mesh4_q3_part peak device memory (cold run): "
            f"{mesh_report['mesh4_q3_part']['peak_bytes']} bytes; the largest dispatch's "
            f"send and receive buffers reckoned at {reckoned} bytes ({MESH_RANKS} ranks x "
            f"[{n_dest}, {cap}] x {len(dcols)} columns and the mask, twice)")
        peak_carry = max(peak_before, mesh_report["mesh4_q3_part"]["peak_bytes"])
    report["mesh"] = mesh_report
    # the spill paths together: denials, both operators spilled, K16
    # launched, and no reservation left behind
    mem = MEMORY_STATS.snapshot()
    spilled = {op: sum(t.get(op, 0) for t in spill_tags.values())
               for op in ("HashAggregateExec", "JoinExec")}
    k16 = {p: launches[p]["spill_order"] for p in spill_tags}
    log(f"spill paths: memory stats {json.dumps(mem)}; spill runs by operator "
        f"{json.dumps(spilled)}; K16 launches per path {json.dumps(k16)}")
    if not mem.get("reserve_denied_total") or not all(spilled.values()) \
            or not any(k16.values()) or mem["reserved_bytes.host"]:
        fail(f"spill paths: {mem}, {spilled}, {k16}")
    report["spill"] = {"memory_stats": mem, "spill_runs": spilled, "k16_launches": k16}

    # memsweep: the 22 queries through the local engine over parquet with
    # the reference sweep's settings under the 1 MiB budget, each bit for
    # bit against the same settings with no budget; denials and spill
    # runs, and no reservation left
    t_phase = time.perf_counter()
    msweep = BallistaContext.local(BallistaConfig({**MEMSWEEP_SETTINGS, **SPILL_BUDGET}),
                                   device=device)
    mfree = BallistaContext.local(BallistaConfig(MEMSWEEP_SETTINGS), device=device)
    for name, path in pq_paths.items():
        msweep.register_parquet(name, path)
        mfree.register_parquet(name, path)
    MEMORY_STATS.reset()
    sweep = {}
    K.reset_launch_counts()
    with Capture(K, F, device) as cap:
        for q in sorted(QUERIES):
            df, s = once(msweep, QUERIES[q])
            sweep[q] = {"frame": df, "budget_ms": s * 1000,
                        "spill_runs": op_metrics(job_plans(msweep), ("spill_runs",))["spill_runs"]}
    launches["memsweep"] = dict(K.LAUNCHES)
    captured["memsweep"] = cap.calls
    log_call_sizes(report, "memsweep", cap)
    if cap.radix:
        report.setdefault("radix_forms", {})["memsweep"] = cap.radix
    if cap.off_device:
        fail(f"memsweep: tensors off the card: {cap.off_device[:5]}")
    missing = [k for k in PATH_KERNELS["memsweep"] if launches["memsweep"][k] == 0]
    if missing:
        fail(f"memsweep: kernels not launched: {missing} ({launches['memsweep']})")
    mem = MEMORY_STATS.snapshot()
    for q in sorted(QUERIES):
        want, s = once(mfree, QUERIES[q])
        try:
            assert_frames_equal(sweep[q]["frame"], want, exact=True)
        except AssertionError as e:
            fail(f"memsweep q{q}: the budgeted run differs from the unlimited run: {e}")
        log(f"memsweep q{q}: {len(want)} rows, bit for bit; budget {sweep[q]['budget_ms']:.1f} ms, "
            f"unlimited {s * 1000:.1f} ms; spill runs {json.dumps(sweep[q]['spill_runs'])}")
        sweep[q]["unlimited_ms"] = s * 1000
    log(f"memsweep: 22 of 22 equal their unlimited runs bit for bit under "
        f"{SPILL_BUDGET}; memory stats {json.dumps(mem)}")
    if not mem.get("reserve_denied_total") or not mem.get("spill_runs_total") \
            or mem["reserved_bytes.host"]:
        fail(f"memsweep: nothing denied or spilled, or a reservation was left: {mem}")
    report["memsweep"] = {"memory_stats": mem, **{
        q: {k: v for k, v in r.items() if k != "frame"} for q, r in sweep.items()}}
    if cuda:  # K1's dense device ms on memsweep's q1 (2^20-row batches, the budget)
        prof_m = profile_query(msweep, QUERIES[1], "memsweep q1", K)
        if prof_m is not None:
            report["dense_ms_per_query"]["memsweep"] = {
                form: {k: rec[k] for k in ("ms", "launches", "wrapper_calls")}
                for form, rec in prof_m["dense"].items()}
            log(f"memsweep q1: K1 / K13 dense device ms, launches and calls: "
                f"{json.dumps(report['dense_ms_per_query']['memsweep'])}")
    paths["memsweep"] = (msweep, None)
    phase_done("memsweep", t_phase)
    if save_calls:  # the largest K16, K7 and K9 calls over the paths and K17's
        import torch  # largest on each mesh path with a dispatch, for the timing tools

        def on_host(a):
            if isinstance(a, torch.Tensor):
                return a.cpu()
            if isinstance(a, (list, tuple)):
                return [on_host(x) for x in a]
            if isinstance(a, dict):
                return {k: on_host(x) for k, x in a.items()}
            return a

        saved = {}
        for name in ("spill_order", "segment_any", "presorted_disorder"):
            seen = [(captured[p][name][0], p) for p in captured if name in captured[p]]
            if seen:
                n, p = max(seen)
                saved[name] = {"path": p, "rows": n, "args": on_host(captured[p][name][1])}
        saved["dispatch_by_path"] = {p: on_host(captured[p]["dispatch_to_buckets"][1])
                                     for p in DISPATCH_CALL_PATHS
                                     if "dispatch_to_buckets" in captured.get(p, {})}
        torch.save(saved, save_calls)
        log(f"saved the largest K16 / K7 / K9 calls and K17's by path to {save_calls}: "
            f"{ {k: (v['path'], v['rows']) for k, v in saved.items() if 'path' in v} }, "
            f"K17 on {sorted(saved['dispatch_by_path'])}")

    # tpch22: the 22 queries through the standalone engine over parquet,
    # cold then warm, held against the port on the CPU (the child's answers)
    t_phase = time.perf_counter()
    tp = {}
    K.reset_launch_counts()
    with Capture(K, F, device) as cap:
        for q in sorted(QUERIES):
            df, s = once(sa_pq, QUERIES[q])
            tp[q] = {"frame": df, "cold_ms": s * 1000}
    launches["tpch22"] = dict(K.LAUNCHES)
    captured["tpch22"] = cap.calls
    log_call_sizes(report, "tpch22", cap)
    if cap.radix:
        report.setdefault("radix_forms", {})["tpch22"] = cap.radix
        log(f"tpch22 (cold runs) K4 / K5 calls by form: {json.dumps(cap.radix)}")
    if cap.off_device:
        fail(f"tpch22: tensors off the card: {cap.off_device[:5]}")
    missing = [k for k in PATH_KERNELS["tpch22"] if launches["tpch22"][k] == 0]
    if missing:
        fail(f"tpch22: kernels not launched: {missing} ({launches['tpch22']})")
    for q in sorted(QUERIES):
        _, s = once(sa_pq, QUERIES[q])
        tp[q]["warm_ms"] = s * 1000
    answers = cpu_answer_frames()
    checks = [(f"tpch22 q{q}", tp[q]["frame"], q) for q in sorted(QUERIES)]
    checks += [(p, path_frames[p], q) for q in EXTRACT_QUERIES for p in (f"pq_q{q}", f"sa_q{q}")]
    checks += [("sa_q20", path_frames["sa_q20"], 20), ("sa_pt", path_frames["sa_pt"], "pt")]
    for label, df, q in checks:
        try:
            assert_frames_equal(df, answers[q][0], ordered=False)
            check_ordering(QUERIES.get(q, PT_QUERY), df)
        except AssertionError as e:
            fail(f"{label} differs from the port on the CPU: {e}")
    for q in sorted(QUERIES):
        log(f"tpch22 q{q}: {len(tp[q]['frame'])} rows, cold {tp[q]['cold_ms']:.1f} ms, warm "
            f"{tp[q]['warm_ms']:.1f} ms (CPU port {answers[q][1] * 1000:.1f} ms)")
    log("tpch22: all 22 standalone results, and pq_q7-9, sa_q7-9, sa_q20 and sa_pt, equal the "
        "port on "
        "the CPU (exact; floats at rtol 1e-12; as multisets, with the ORDER BY checked)")
    log(f"tpch22 launches: {json.dumps({k: v for k, v in launches['tpch22'].items() if v})}")
    report["tpch22"] = {q: {"rows": len(v["frame"]), "cold_ms": v["cold_ms"],
                            "warm_ms": v["warm_ms"], "cpu_ms": answers[q][1] * 1000}
                        for q, v in tp.items()}
    paths["tpch22"] = (sa_pq, None)
    phase_done("tpch22", t_phase)

    # SF0.01: the 22 queries on the card, both engines, against sqlite3
    t_phase = time.perf_counter()
    small = generate_tables(0.01, seed=1)
    conn = sqlite_oracle(small)
    small_cfg = BallistaConfig({"ballista.shuffle.partitions": "4"})
    small_ctx = {"local": BallistaContext.local(small_cfg, device=device),
                 "standalone": BallistaContext.standalone(small_cfg, concurrent_tasks=4,
                                                          device=device)}
    try:
        for c in small_ctx.values():
            for name, table in small.items():
                c.register_table(name, table)
        # tpch22_local: the local engine's operator programs are all
        # generated kernels (K19): no CodegenError, and their count
        from arrow_ballista_tpu_torch.compile.codegen import CodegenError

        programs_per_query, codegen_errors = {}, []
        K.reset_launch_counts()
        for q in sorted(QUERIES):
            want = sqlite_answer(conn, QUERIES[q])
            for engine, c in small_ctx.items():
                try:
                    got = c.sql(QUERIES[q]).to_pandas()
                except CodegenError as e:
                    codegen_errors.append((q, engine, str(e)))
                    continue
                try:
                    check_against_sqlite(want, QUERIES[q], got)
                except AssertionError as e:
                    fail(f"SF0.01 q{q} ({engine}) differs from sqlite: {e}")
                if engine == "local":
                    programs_per_query[q] = sum(op_metrics(
                        job_plans(c), ("generated_programs",))["generated_programs"].values())
    finally:
        small_ctx["standalone"].shutdown()
        conn.close()
    if codegen_errors:
        fail(f"tpch22_local: CodegenError on {codegen_errors}")
    log(f"tpch22_local: generated programs per query {json.dumps(programs_per_query)}, "
        f"{sum(programs_per_query.values())} in all, CodegenError count 0; K19 launches over "
        f"both engines {K.LAUNCHES['operator_program']}")
    if cuda and not all(programs_per_query.values()):  # the CPU traces nothing
        fail(f"tpch22_local: a query ran no generated program: {programs_per_query}")
    report["tpch22_local"] = {"generated_programs": programs_per_query,
                              "codegen_errors": 0}
    log("SF0.01: all 22 queries equal the sqlite3 oracle on the card, local and standalone")

    now = cache_fingerprints(table_cache)
    changed = [k for k, v in cached.items() if now.get(k) != v]
    if changed:
        fail(f"a query wrote into (or evicted) cached scan tensors: {changed[:5]}")
    stats = table_cache.CACHE.stats()
    log(f"scan cache: {stats['entries']} entries, {stats['bytes']} resident bytes of a "
        f"{stats['budget']}-byte budget, {stats['hits']} hits, {stats['misses']} misses, "
        f"{stats['evictions']} evictions; every cached tensor unchanged after all runs")
    report["scan_cache"] = stats
    if cuda:
        peak = max(peak_carry, torch.cuda.max_memory_allocated())
        log(f"peak device memory (torch.cuda.max_memory_allocated over the query paths): "
            f"{peak} bytes")
        report["max_memory_allocated"] = peak
    phase_done("sf001_sqlite", t_phase)

    # phase 5: results against the numpy oracles
    t_phase = time.perf_counter()
    oracles = {"q1": q1_oracle(lineitem), "q3": q3_oracle(tables), "q4": q4_oracle(tables)}
    for label, c in (("", ctx), ("pq_", pctx), ("csv_", csv_ctx)):
        n_groups, worst = check_q1(c, sqls["q1"], oracles["q1"])
        log(f"{label}q1 vs numpy oracle: {n_groups} groups, sums and counts exact, avg max rel "
            f"err {worst:.3g}")
        n_groups = check_q3(c, sqls["q3"], oracles["q3"])
        log(f"{label}q3 vs numpy oracle: top 10 exact, and all {n_groups} groups without the "
            "LIMIT exact")
        if label != "csv_":  # csv holds lineitem, orders and customer only
            counts = check_q4(c, sqls["q4"], oracles["q4"])
            log(f"{label}q4 vs numpy oracle: {json.dumps(counts)} exact")
    q18_want = q18_oracle(tables, q18_having)
    n_top, n_all = check_q18(pctx, q18, q18_want)
    log(f"pq_q18 vs numpy oracle: top {n_top} exact, and all {n_all} rows without the LIMIT exact")
    n_groups, worst = check_q1(sa_pq, sqls["q1"], oracles["q1"])
    log(f"sa_pq_q1 vs numpy oracle: {n_groups} groups, sums and counts exact, avg max rel "
        f"err {worst:.3g}")
    n_groups = check_q3(sa_pq, sqls["q3"], oracles["q3"])
    log(f"sa_pq_q3 vs numpy oracle: top 10 exact, and all {n_groups} groups without the LIMIT "
        "exact")
    log(f"sa_pq_q4 vs numpy oracle: {json.dumps(check_q4(sa_pq, sqls['q4'], oracles['q4']))} "
        "exact")
    for label, c in (("sa_pq_q18", sa_pq), ("sa_q18", sa_mem)):
        n_top, n_all = check_q18(c, q18, q18_want)
        log(f"{label} vs numpy oracle: top {n_top} exact, and all {n_all} rows without the "
            "LIMIT exact")
    for path, check in (("mesh_q1", "q1"), ("mesh4_q1", "q1"), ("mesh4_q3", "q3"),
                        ("mesh4_q3_part", "q3"), ("mesh4_q18", "q18"), ("sa_hybrid_q3", "q3")):
        c = paths[path][0]
        with mesh_scope(path):
            if check == "q1":
                n_groups, worst = check_q1(c, sqls["q1"], oracles["q1"])
                log(f"{path} vs numpy oracle: {n_groups} groups, sums and counts exact, avg "
                    f"max rel err {worst:.3g}")
            elif check == "q3":
                n_groups = check_q3(c, sqls["q3"], oracles["q3"])
                log(f"{path} vs numpy oracle: top 10 exact, and all {n_groups} groups without "
                    "the LIMIT exact")
            else:
                n_top, n_all = check_q18(c, q18, q18_want)
                log(f"{path} vs numpy oracle: top {n_top} exact, and all {n_all} rows without "
                    "the LIMIT exact")
    builds = list(_cuda.LIBRARIES.generated_builds)
    log(f"generated kernels (K12 / K13) built with nvcc at first use: "
        f"{json.dumps(builds)} ({sum(b[1] for b in builds):.3f} s, inside the cold walls)")
    report["generated_builds"] = builds
    phase_done("oracles", t_phase)

    # table rows 5-7 on q3's path
    t_phase = time.perf_counter()
    if cuda:
        programs = profile_programs(ctx, sqls["q3"], device)
        for row, (dev_ms, moved, calls, wall_ms) in programs.items():
            bound = moved / HBM_BYTES_PER_S * 1000
            log(f"q3 programs {row}: device {'not measured' if dev_ms is None else f'{dev_ms:.4f} ms'}"
                f" per query over {calls} calls, bound {bound:.6f} ms ({moved} bytes), wall "
                f"{'not measured' if wall_ms is None else f'{wall_ms:.4f} ms'} per query "
                "(each call synchronized)")
        report["q3_programs"] = {row: {"ms": v[0], "bytes": v[1], "calls": v[2], "wall_ms": v[3],
                                       "bound_ms": v[1] / HBM_BYTES_PER_S * 1000}
                                 for row, v in programs.items()}
        phase_done("q3_programs", t_phase)

    # phase 4 + 6: kernels against their twins at each path's own shapes and
    # at the stress shapes; timings at the largest call over the paths
    t_phase = time.perf_counter()
    stress = stress_inputs(K, device, stress_rows)
    stress.update(fused_stress(device, stress_rows))
    stress.update(new_kernel_stress(device, stress_rows))
    stress.update(mesh_stress(device, stress_rows))
    stress.update(k19_k22_stress(device, stress_rows))
    radix_build = radix_build_stress(device)
    phase_done("stress_inputs", t_phase)
    for name in KERNEL_META:
        t_kernel = time.perf_counter()
        per_path = {p: launches[p][LAUNCH_KEY[name]] for p in paths}
        checked = {}  # path -> wrapper -> rows and max abs err of that path's largest call
        try:
            for path in paths:
                calls = {w: captured[path][w] for w in WRAPPERS[name] if w in captured[path]}
                if per_path[path] and not calls:
                    fail(f"{name}: launched on {path} but no call of it was captured")
                if calls:
                    checked[path] = {w: {"rows": n, "max_abs_err": check_kernel(K, w, args)}
                                     for w, (n, args) in calls.items()}
            if name == "operator_program":  # K19: every program at its largest call per path
                for path in paths:
                    for key, (n, args) in captured[path].items():
                        if key.startswith("operator_program:"):
                            checked.setdefault(path, {})[key] = {
                                "rows": n, "max_abs_err": check_kernel(K, key, args)}
            err = max((c["max_abs_err"] for w in checked.values() for c in w.values()),
                      default=0.0)
            for sargs in stress[name]:
                if isinstance(sargs, Wrapped):
                    err = max(err, check_kernel(K, sargs.wrapper, sargs.args))
                else:
                    err = max(err, check_kernel(K, name, sargs))
            expected = stress["expected_flags"].get(name)
            if expected is not None:
                got = [bool(getattr(K, name)(*sargs)) for sargs in stress[name]]
                if got != expected:
                    fail(f"{name}: flags {got} at the stress shapes, expected {expected}")
            if name == "build_side_sort":  # 2^23 rows, then again with every hash 0
                err = max(err, check_kernel(K, name, radix_build))
            if name == "extract_field" and cuda:  # K14 over every int32 day
                report["extract_all_days"] = extract_all_days_check(K, device)
                log(f"K14 over every int32 day: {json.dumps(report['extract_all_days'])}")
            if name == "clustered_keep" and cuda:  # K10 and K11 with no memset between calls
                report["clustered_reset_calls"] = clustered_reset_check(K, device)
                log(f"K10 / K11 back to back on one stream and from four threads: "
                    f"{report['clustered_reset_calls']} calls of each equal their twins")
            if name == "grouped_on_order" and cuda:  # K8 with no memset between calls
                report["seg_reset_calls"] = seg_reset_check(K, device)
                log(f"K8 back to back on one stream and from four threads: "
                    f"{report['seg_reset_calls']} calls equal their twins")
            if name == "probe_join" and cuda:  # K6 and K2 with no memset between calls
                report["probe_compact_reset_calls"] = probe_compact_reset_check(K, device)
                log(f"K6 / K2 back to back on one stream and from four threads: "
                    f"{report['probe_compact_reset_calls']} calls of each equal their twins")
            if name in ("build_side_sort", "probe_join", "spill_partition", "spill_order"):
                was = K._FORCE_COLLISIONS
                K._FORCE_COLLISIONS = True
                try:
                    forced = forced_collision_inputs(K, device, stress_rows)
                    err = max(err, check_kernel(K, name, forced[name]))
                    if name == "build_side_sort":
                        err = max(err, check_kernel(K, name, radix_build))
                finally:
                    K._FORCE_COLLISIONS = was
        except AssertionError as e:
            fail(f"{name}: kernel disagrees with its plain twin: {e}")
        if cuda:
            torch.cuda.synchronize()
        # the largest call of the kernel's own wrapper, or of any of its
        # wrappers where it has none of its own name (K22)
        wrappers = [w for p in paths for w in WRAPPERS[name] if w in captured[p]]
        if not wrappers:
            # launched on no path (K14: EXTRACT runs inside the generated
            # programs): timed at its first stress input
            timed, path, args = name, "stress", stress[name][0]
            n = (args[0][0] if isinstance(args[0], (list, tuple)) else args[0]).shape[0]
        else:
            timed = name if name in wrappers and name != "dense_group_states" else max(
                wrappers, key=lambda w: (w == "dense_grouped",
                                         max(captured[p][w][0] for p in paths
                                             if w in captured[p])))
            path = max((p for p in paths if timed in captured[p]),
                       key=lambda p: captured[p][timed][0])
            n, args = captured[path][timed]
        forms = {}  # K13: form -> (path, rows, args) of its largest call
        if name == "fused_agg":
            for p in paths:
                if name in captured[p]:
                    n_p, a_p = captured[p][name]
                    form = "dense" if K.dense_domain(a_p[5]) is not None else "sort"
                    if form not in forms or n_p > forms[form][1]:
                        forms[form] = (p, n_p, a_p)
            path, n, args = forms.get("dense", (path, n, args))
        times, moved = kernel_timings(K, timed, args, device)
        bound_ms = moved / HBM_BYTES_PER_S * 1000
        call_shape = {}
        if timed == "probe_join":  # how selective the largest call is
            ph, pm, bh, cap = args
            call_shape = {"live_share": float(pm.float().mean()), "build_rows": bh.shape[0],
                          "total": int(K.probe_counts_plain(ph, pm, bh)[1]), "cap": cap}
            log(f"kernel probe_join: the largest call ({path}, {n} probe rows): "
                f"{json.dumps(call_shape)}")
        elif timed == "grouped_on_order":  # how much of the largest call is live
            gmask, gcap, gorder = args[2], args[3], args[5]
            call_shape = {"live_share": float(gmask[gorder.long()].float().mean()), "cap": gcap,
                          "groups_in_cap": int(K.grouped_on_order_plain(*args)[2].sum())}
            log(f"kernel grouped_on_order: the largest call ({path}, {n} rows): "
                f"{json.dumps(call_shape)}")
        src, replaces = KERNEL_META[name]
        report["kernels"].append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": sum(per_path.values()), "max_abs_err": err,
            "ms": times["ms"], "plain_ms": times["plain_ms"], "bound_ms": bound_ms,
            "bound_by": "bytes", "library_ms": times["library_ms"],
            "library_call": LIBRARY_CALL[name], "bound_bytes": moved, "rows": n,
            "captured_on": path, "launches_per_path": per_path, "checked_per_path": checked,
            "wall_ms": times["wall_ms"], "plain_wall_ms": times["plain_wall_ms"],
            "library_wall_ms": times["library_wall_ms"],
            **({"interpreted_ms": times["interpreted_ms"],
                "interpreted_wall_ms": times["interpreted_wall_ms"],
                "generated_by": "arrow_ballista_tpu_torch/compile/codegen.py",
                "k13_forms_per_path": {p: f for p, f in k13_forms.items() if f}}
               if name.startswith("fused_") else {}),
            **({"generated_by": "arrow_ballista_tpu_torch/compile/codegen.py"}
               if name in ("mesh_derive", "operator_program") else {}),
            **({"interpreted_ms": times["interpreted_ms"],
                "interpreted_wall_ms": times["interpreted_wall_ms"]}
               if name == "operator_program" else {}),
            **{k: v for k, v in times.items() if k.startswith(("parent_", "per_column_"))},
            **({"all_days": report.get("extract_all_days")} if name == "extract_field" else {}),
            **({"timed_wrapper": timed} if timed != name else {}),
            **({"timed_call": call_shape} if call_shape else {}),
            **({"replaces_all": REPLACES_ALL[name]} if name in REPLACES_ALL else {}),
            "ms_source": [times[k] for k in ("ms_source", "plain_ms_source",
                                             "library_ms_source")]})

        def fmt(v):
            return "n/a" if v is None else f"{v:.4f} ms"

        log(f"kernel {name}: held against its twin per path at that path's largest call "
            f"{json.dumps(checked)}")
        log(f"kernel {name}: main-path rows {n} (largest call, {path}); device time per call "
            f"(kernel/plain/library from {'/'.join(map(str, report['kernels'][-1]['ms_source']))}): "
            f"kernel {fmt(times['ms'])}, bound {bound_ms:.6f} ms ({moved} bytes), plain "
            f"{fmt(times['plain_ms'])}, library {fmt(times['library_ms'])}; wall per call: "
            f"kernel {fmt(times['wall_ms'])}, plain {fmt(times['plain_wall_ms'])}, library "
            f"{fmt(times['library_wall_ms'])}"
            + (f"; interpreted chain {fmt(times['interpreted_ms'])} device, "
               f"{fmt(times['interpreted_wall_ms'])} wall" if name.startswith("fused_") else "")
            + f"; stress {stress_rows} rows ok; "
            f"max abs err {err:.3g}; launches per query {json.dumps(per_path)}"
            + (f"; the parent's recorded time: {PARENT_DENSE_MS[name][0]} ms "
               f"({PARENT_DENSE_MS[name][1]})" if name in PARENT_DENSE_MS else "")
            + (f"; one launch a column (the parent's form, this tree's kernel): device "
               f"{fmt(times['per_column_ms'])}, wall {fmt(times['per_column_wall_ms'])}"
               if "per_column_ms" in times else ""))
        if name == "bucket_masks" and "bucket_masks" in captured.get("q1", {}):
            # q1's call (the local engine's batch into its 16 partitions)
            qn, qargs = captured["q1"]["bucket_masks"]
            qt, qmoved = kernel_timings(K, name, qargs, device)
            report["kernels"][-1]["at_q1"] = {
                "rows": qn, "partitions": qargs[2], "ms": qt["ms"], "wall_ms": qt["wall_ms"],
                "plain_ms": qt["plain_ms"], "library_ms": qt["library_ms"],
                "bound_ms": qmoved / HBM_BYTES_PER_S * 1000}
            log(f"kernel {name} at q1's largest call ({qn} rows, {qargs[2]} partitions): device "
                f"kernel {fmt(qt['ms'])}, plain {fmt(qt['plain_ms'])}, composite "
                f"{fmt(qt['library_ms'])}, bound {qmoved / HBM_BYTES_PER_S * 1000:.6f} ms; wall "
                f"kernel {fmt(qt['wall_ms'])}")
        if name == "mask_ops":  # K22: every op at its own largest call
            per_op = {}
            for w in WRAPPERS[name]:
                seen = [p for p in paths if w in captured[p]]
                if not seen:
                    continue
                wp = max(seen, key=lambda p: captured[p][w][0])
                wn, wargs = captured[wp][w]
                wt, wmoved = (times, moved) if w == timed else kernel_timings(K, w, wargs, device)
                per_op[w] = {"captured_on": wp, "rows": wn, "ms": wt["ms"],
                             "wall_ms": wt["wall_ms"], "plain_ms": wt["plain_ms"],
                             "library_ms": wt["library_ms"],
                             "bound_ms": wmoved / HBM_BYTES_PER_S * 1000}
                log(f"kernel {name} {w}: rows {wn} ({wp}); device kernel {fmt(wt['ms'])}, "
                    f"plain {fmt(wt['plain_ms'])}, library {fmt(wt['library_ms'])}, bound "
                    f"{per_op[w]['bound_ms']:.6f} ms; wall kernel {fmt(wt['wall_ms'])}")
            report["kernels"][-1]["per_op"] = per_op
        if "sort" in forms:
            sp, sn, sargs = forms["sort"]
            stimes, smoved = kernel_timings(K, name, sargs, device)
            report["kernels"][-1]["sort_path"] = {
                "captured_on": sp, "rows": sn, "ms": stimes["ms"], "wall_ms": stimes["wall_ms"],
                "plain_ms": stimes["plain_ms"], "interpreted_ms": stimes["interpreted_ms"],
                "interpreted_wall_ms": stimes["interpreted_wall_ms"],
                "bound_ms": smoved / HBM_BYTES_PER_S * 1000, "bound_bytes": smoved}
            log(f"kernel fused_agg, sort path: rows {sn} (largest call, {sp}); device time per "
                f"call: kernel {fmt(stimes['ms'])} (the generated pass, K4 and K8), bound "
                f"{smoved / HBM_BYTES_PER_S * 1000:.6f} ms ({smoved} bytes), plain "
                f"{fmt(stimes['plain_ms'])}, interpreted chain {fmt(stimes['interpreted_ms'])}; "
                f"wall per call: kernel {fmt(stimes['wall_ms'])}, interpreted chain "
                f"{fmt(stimes['interpreted_wall_ms'])}")
        if name == "operator_program":
            # each program at its largest call over the paths: device and
            # wall ms, the interpreted closures' beside it, and its bound
            per_prog = {}
            for key in sorted({k for p in paths for k in captured[p]
                               if k.startswith("operator_program:")}):
                pp = max((p for p in paths if key in captured[p]),
                         key=lambda p: captured[p][key][0])
                pn, pargs = captured[pp][key]
                ptimes, pmoved = kernel_timings(K, "operator_program", pargs, device)
                per_prog[key.split(":", 1)[1]] = {
                    "captured_on": pp, "rows": pn, "ms": ptimes["ms"],
                    "wall_ms": ptimes["wall_ms"], "interpreted_ms": ptimes["interpreted_ms"],
                    "interpreted_wall_ms": ptimes["interpreted_wall_ms"],
                    "bound_ms": pmoved / HBM_BYTES_PER_S * 1000, "bound_bytes": pmoved,
                    "kind": pargs[0].kind}
                log(f"kernel operator_program [{key.split(':', 1)[1]}] ({pargs[0].kind}): rows "
                    f"{pn} ({pp}); device {fmt(ptimes['ms'])}, wall {fmt(ptimes['wall_ms'])}, "
                    f"interpreted {fmt(ptimes['interpreted_ms'])} device, "
                    f"{fmt(ptimes['interpreted_wall_ms'])} wall, bound "
                    f"{pmoved / HBM_BYTES_PER_S * 1000:.6f} ms ({pmoved} bytes)")
            report["kernels"][-1]["per_program"] = per_prog
        if name == "sort_order" and cuda:
            report["topk"] = topk_timings(K, device, stress_rows)
        if name == "build_side_sort" and cuda:  # K4 and K5 at their stress shapes
            t_radix = time.perf_counter()
            report["radix_stress"] = radix_stress_timings(K, device, stress["sort_order"][1:],
                                                          radix_build)
            report["radix_stress"]["seconds"] = time.perf_counter() - t_radix
            log(f"radix stress timings: {report['radix_stress']['seconds']:.1f} s")
        report.setdefault("kernel_check_s", {})[name] = time.perf_counter() - t_kernel
        if name == "dense_group_states" and cuda and timed == "dense_grouped":
            sweep = dense_hot_slot_sweep(K, args, device)
            report["kernels"][-1]["hot_slot_sweep_ms"] = sweep
            log("kernel dense_group_states hot-slot sweep (compacted form, device ms per call, "
                f"{n} rows): " + ", ".join(
                    f"{h} slots {fmt(v)}" for h, v in sweep.items()))
            seen = [p for p in paths if "dense_group_states" in captured[p]]
            if seen:  # the slot-aligned form at its own largest call (the mesh's)
                sp = max(seen, key=lambda p: captured[p]["dense_group_states"][0])
                sn, sargs = captured[sp]["dense_group_states"]
                st, smoved = kernel_timings(K, "dense_group_states", sargs, device)
                report["kernels"][-1]["slot_aligned"] = {
                    "captured_on": sp, "rows": sn, "ms": st["ms"], "wall_ms": st["wall_ms"],
                    "plain_ms": st["plain_ms"], "library_ms": st["library_ms"],
                    "bound_ms": smoved / HBM_BYTES_PER_S * 1000, "bound_bytes": smoved}
                log(f"kernel dense_group_states, slot-aligned form: rows {sn} ({sp}); device "
                    f"kernel {fmt(st['ms'])}, plain {fmt(st['plain_ms'])}, library "
                    f"{fmt(st['library_ms'])}, bound {smoved / HBM_BYTES_PER_S * 1000:.6f} ms; "
                    f"wall kernel {fmt(st['wall_ms'])}")
        if name == "fused_agg" and cuda:
            sweep = k13_hot_slot_sweep(F, device, min(stress_rows, 1 << 20))
            report["kernels"][-1]["dense_hot_slot_sweep_ms"] = sweep
            log(f"kernel fused_agg, dense form: hot-slot sweep over a synthetic chain "
                f"({min(stress_rows, 1 << 20)} rows, device ms per call): " + ", ".join(
                    f"{h} key pairs {fmt(v)}" for h, v in sweep.items()))
        phase_done(f"kernel_checks/{name}", t_kernel)

    PHASE_S["kernel_checks"] = sum(v for k, v in PHASE_S.items()
                                   if k.startswith("kernel_checks/"))
    log(f"phase kernel_checks: {PHASE_S['kernel_checks']:.1f} s")
    t_phase = time.perf_counter()
    report["extract_programs"] = extract_program_timings(K, civil_calls, device)
    phase_done("extract_programs", t_phase)
    log("radix plans (K4 sort_order / K5 build_side_sort: form, composite bits, passes, "
        f"launches) of every call held against its twin: {json.dumps(RADIX_PLANS)}")
    report["radix_plans"] = list(RADIX_PLANS)

    # the mesh exchange's copies at the largest all_to_all of the mesh paths,
    # over rotating copies of the blocks (as the kernels are timed), beside
    # one copy_ of the same bytes; device time from the profiler and from
    # queued CUDA events, so that a reading past the HBM peak shows which
    # source gave it
    t_phase = time.perf_counter()
    a2a = [(captured[p]["all_to_all"], p) for p in paths if "all_to_all" in captured.get(p, {})]
    if a2a:
        (n_bytes, (blocks, mesh)), a2a_path = max(a2a, key=lambda x: x[0][0])
        moved = 2 * n_bytes  # every block read once, every received byte written once
        nxt = rotating((blocks, mesh), moved)
        exchange = lambda: C.all_to_all(*nxt())  # noqa: E731
        flat = torch.cat([b.reshape(-1) for b in blocks])
        nxt_one = rotating((flat, torch.empty_like(flat)), moved)
        one_copy = lambda: (lambda src, dst: dst.copy_(src))(*nxt_one())  # noqa: E731
        ex = {"path": a2a_path, "bytes": n_bytes, "bound_ms": moved / HBM_BYTES_PER_S * 1000,
              "wall_ms": time_ms(exchange, device), "one_copy_wall_ms": time_ms(one_copy, device)}
        if cuda:
            ex["ms"], ex["ms_source"] = device_ms(exchange)
            ex["events_ms"] = queued_events_ms(exchange)
            ex["one_copy_ms"], ex["one_copy_ms_source"] = device_ms(one_copy)
            ex["one_copy_events_ms"] = queued_events_ms(one_copy)
        del flat, nxt_one, one_copy
        ex["bytes_per_path"] = {p: r["exchange_bytes"] for p, r in mesh_report.items()}
        report["exchange"] = ex

        def shown(key):
            v = ex.get(key)
            return "not measured" if v is None else f"{v:.4f} ms"

        log(f"mesh exchange copies: largest all_to_all ({a2a_path}, {len(blocks)} ranks on one "
            f"card) {n_bytes} bytes over rotating copies; device {shown('ms')} "
            f"({ex.get('ms_source')}), {shown('events_ms')} (queued events), "
            f"wall {shown('wall_ms')}; "
            f"one copy_ of the same bytes: device {shown('one_copy_ms')} "
            f"({ex.get('one_copy_ms_source')}), {shown('one_copy_events_ms')} (queued events), "
            f"wall {shown('one_copy_wall_ms')}; bound {ex['bound_ms']:.6f} ms (read and written "
            f"once); bytes copied per mesh path {json.dumps(ex['bytes_per_path'])}")
    dryrun = port_entry.dryrun_multichip(MESH_RANKS, device=device)
    log(f"dryrun_multichip({MESH_RANKS}) on {device}: {json.dumps(dryrun)}")
    report["dryrun_multichip"] = dryrun
    phase_done("exchange_dryrun", t_phase)
    t_phase = time.perf_counter()

    # entry(): the flagship step, held against its twins on the CPU
    for n_rows in (4096, stress_rows):
        step, (cols, mask) = port_entry.entry(n_rows, device=device)
        gk, gv, gm, _ = step(cols, mask)
        ck, cv, cm, _ = step({k: v.cpu() for k, v in cols.items()}, mask.cpu())
        live = cm
        try:
            max_err(gm, cm)
            for a, b in zip(list(gk) + list(gv), list(ck) + list(cv)):
                max_err(a.cpu()[live], b[live])
        except AssertionError as e:
            fail(f"entry step at {n_rows} rows disagrees with its CPU twin: {e}")
        ms = time_ms(lambda: step(cols, mask), device, iters=10, reps=5)
        log(f"entry step: {n_rows} rows in {ms:.4f} ms = {n_rows / ms * 1000:.0f} rows/s")
        report[f"entry_rows_per_s_{n_rows}"] = n_rows / ms * 1000
    phase_done("entry", t_phase)
    t_phase = time.perf_counter()
    report["obs"] = obs_phase(device, ctx, sa_pq, sqls, oracles, K)
    phase_done("obs", t_phase)
    t_phase = time.perf_counter()
    rm_sqls = {"q1": sqls["q1"], "q3": sqls["q3"], "q18": q18}
    report["remote"] = remote_phase(
        device, pq_paths, rm_sqls, {"q1": oracles["q1"], "q3": oracles["q3"], "q18": q18_want},
        K, F, sa_cfg,
        {q: {"cold_ms": report[f"sa_pq_{q}_cold_ms"], "warm_ms": report[f"sa_pq_{q}_warm_ms"]
             or report[f"sa_pq_{q}_cold_ms"]} for q in rm_sqls},
        {q: path_frames[f"sa_pq_{q}"] for q in rm_sqls})
    # the remote paths beside the others in each kernel's launches (both
    # executors' cold runs with the host match) and its per-path checks
    for entry in report["kernels"]:
        name = entry["name"]
        for rm_path, launched in report["remote"]["kernel_launches"].items():
            if rm_path.endswith("_wire"):
                continue
            entry["launches_per_path"][rm_path] = launched.get(LAUNCH_KEY[name], 0)
            errs = {w: e for w, e in report["remote"]["checked"].get(rm_path, {}).items()
                    if w in WRAPPERS[name] or (name == "operator_program"
                                               and w.startswith("operator_program"))}
            if errs:
                entry["checked_per_path"][rm_path] = errs
                entry["max_abs_err"] = max([entry["max_abs_err"], *errs.values()])
        entry["launches"] = sum(entry["launches_per_path"].values())
    phase_done("remote", t_phase)
    report["phase_s"] = dict(PHASE_S)
    return report


# --------------------------------------------------------------------------
# phase obs: EXPLAIN ANALYZE with the device observatory, forensics, the
# doctor and the watch stream
# --------------------------------------------------------------------------

# the registry's kernels whose profiler kernel names this script already
# tells apart (RADIX_KERNELS, CALL_KERNELS, DENSE_KERNELS, CLUSTERED_KERNELS):
# their device ms per profiled query beside the registry's event ms
OBS_PROFILED_KERNELS = ("sort_order", "build_side_sort", "probe_join", "compaction_order",
                        "grouped_on_order", "bucket_masks", "dense_group_states",
                        "key_range_check", "clustered_keep")
OBS_WALL_RUNS = 5
# counter names that tag a launch another name already counted (K13's dense
# form: each is also one of fused_agg, whose event bracket holds its time)
OBS_TAG_COUNTS = ("fused_agg_dense",)


def profiler_kernel_ms(prof) -> dict:
    """Device ms per profiled query of the kernels in OBS_PROFILED_KERNELS."""
    rows = device_rows(prof)
    out = {name: sum(r[0] for r in rows if any(p in r[2] for p in parts))
           for name, parts in RADIX_KERNELS.items()}
    calls = call_trace(prof)
    out.update({name: rec["ms"] for name, rec in calls.items()})
    out.update({name: rec["ms"] for name, rec in clustered_trace(prof).items()})
    out["dense_group_states"] = dense_trace(prof)["dense_group_states"]["ms"]
    return {k: out[k] for k in OBS_PROFILED_KERNELS}


def registry_kernels(device_stats: dict) -> tuple:
    """({kernel: launches}, {kernel: event ms}) of a device-observatory fold."""
    launches = {k.split(".", 1)[1]: int(v) for k, v in device_stats.items()
                if k.startswith("launches.")}
    event_ms = {k.split(".", 1)[1]: float(v) for k, v in device_stats.items()
                if k.startswith("kernel_ms.")}
    return launches, event_ms


def obs_phase(device, ctx, sa, sqls, oracles, K) -> dict:
    """Phase obs, on the SF1 tables already loaded: q1's and q3's EXPLAIN
    ANALYZE in the local engine with the device observatory on (q1's rows
    against the oracle, every operator's output_rows against an unobserved
    run, every launched kernel with its launches attributed to operators and
    an event time, per kernel and in all beside the profiler's device ms of
    the same query);
    standalone q1 and q3 with the journal and tracing on (a valid forensics
    bundle, no doctor finding, a watch stream ending successful); one
    ``executor.task.slow`` straggler the doctor must report; and, without a
    gate, the warm q1 wall with the observatory off and on, alternating."""
    import contextlib

    import torch
    from torch.profiler import ProfilerActivity, profile

    from arrow_ballista_tpu_torch import faults
    from arrow_ballista_tpu_torch.obs import journal
    from arrow_ballista_tpu_torch.obs.doctor import validate_bundle
    from arrow_ballista_tpu_torch.obs.stats import local_explain_report

    cuda = device.type == "cuda"
    out = {"card": smi("name,power.limit") if cuda else "cpu"}
    q1, key = sqls["q1"], "ballista.observability.device.enabled"

    def observe(on: bool) -> None:
        ctx.config.set(key, "true" if on else "false")

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def local_explain(name: str) -> dict:
        """One local EXPLAIN ANALYZE under the profiler, held against an
        unobserved run of the same query (q1's rows also against its
        oracle)."""
        sql = sqls[name]
        observe(False)
        if name == "q1":
            check_q1(ctx, sql, oracles["q1"])
        else:
            want_rows = sum(b.num_rows for b in ctx.sql(sql).collect())
        plain = {(o["path"], o["op"]): o["rows"]
                 for o in local_explain_report(ctx.last_plan)["stages"][0]["operator_tree"]}
        observe(True)
        captured = []
        real = ctx._execute_local

        def keep(planned):
            got = real(planned)
            captured.extend(got)
            return got

        ctx._execute_local = keep
        try:
            before = dict(K.LAUNCHES)
            with (profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) if cuda
                  else contextlib.nullcontext()) as prof:
                t0 = time.perf_counter()
                report = ctx.explain_analyze(sql)
                sync()
                wall_ms = (time.perf_counter() - t0) * 1000
        finally:
            del ctx._execute_local
        delta = {k: K.LAUNCHES[k] - before.get(k, 0) for k in K.LAUNCHES
                 if K.LAUNCHES[k] != before.get(k, 0)}
        if name == "q1":
            want_rows, worst = check_q1_batches(captured, device, oracles["q1"])
        if report["rows_returned"] != want_rows:
            fail(f"obs: {name}'s report returned {report['rows_returned']} rows, "
                 f"not {want_rows}")
        stage = report["stages"][0]
        observed = {(o["path"], o["op"]): o["rows"] for o in stage["operator_tree"]}
        if observed != plain:
            bad = {f"{p}:{op}": (observed.get((p, op)), plain.get((p, op)))
                   for p, op in set(observed) | set(plain)
                   if observed.get((p, op)) != plain.get((p, op))}
            fail(f"obs: {name}'s observed output_rows differ from an unobserved run: {bad}")
        launches, event_ms = registry_kernels(stage["device"])
        per_op = {}
        for o in stage["operator_tree"]:
            for k, v in o["metrics"].items():
                if k.startswith("launches."):
                    per_op[k.split(".", 1)[1]] = per_op.get(k.split(".", 1)[1], 0) + int(v)
        if not launches or launches != delta or per_op != launches:
            fail(f"obs: {name}'s launches: registry {launches}, process counter {delta}, "
                 f"operators {per_op}")
        if cuda:
            untimed = sorted(k for k in launches
                             if event_ms.get(k, 0.0) <= 0.0 and k not in OBS_TAG_COUNTS)
            if untimed:
                fail(f"obs: {name}'s kernels launched with no event time: {untimed}")
        prof_total = sum(r[0] for r in device_rows(prof)) if cuda else None
        prof_kernels = profiler_kernel_ms(prof) if cuda else {}
        rec = {"wall_ms": wall_ms, "rows": want_rows, "launches": launches,
               "event_ms": event_ms, "event_ms_total": sum(event_ms.values()),
               "profiler_device_ms_total": prof_total, "profiler_kernel_ms": prof_kernels,
               "operators": {f"{o['path']}:{o['op']}": {
                   k: v for k, v in o["metrics"].items()
                   if k.startswith(("launches.", "kernel_ms."))}
                   for o in stage["operator_tree"]}}
        if name == "q1":
            rec["worst_rel_err"] = worst
        log(f"obs {name} local EXPLAIN ANALYZE ({out['card']}): wall {wall_ms:.1f} ms "
            f"profiled, {want_rows} rows{' equal to the oracle' if name == 'q1' else ''}, "
            f"output_rows equal to an unobserved run; kernel event ms total "
            f"{sum(event_ms.values()):.4f}, profiler device ms total "
            f"{'not measured' if prof_total is None else f'{prof_total:.4f}'} (all kernels, "
            f"copies and memsets of the query)")
        for k in sorted(launches):
            pk = prof_kernels.get(k)
            log(f"  obs kernel {name} {k}: launches {launches[k]}, event ms "
                f"{event_ms.get(k, 'not measured')}, profiler ms "
                f"{'not mapped' if pk is None else f'{pk:.4f}'}")
        return rec

    for name in ("q1", "q3"):
        out[f"{name}_local"] = local_explain(name)

    # standalone q1 and q3 with the journal and tracing on
    journal.set_enabled(True)
    try:
        for name in ("q1", "q3"):
            t0 = time.perf_counter()
            before = dict(K.LAUNCHES)
            if name == "q1":
                check_q1(sa, sqls["q1"], oracles["q1"])
            else:
                check_q3(sa, sqls["q3"], oracles["q3"])
            job_wall = (time.perf_counter() - t0) * 1000
            bundle = sa.forensics()
            problems = validate_bundle(bundle)
            if problems:
                fail(f"obs: sa_pq_{name}'s forensics bundle: {problems}")
            diag = sa.doctor()
            if diag["findings"]:
                fail(f"obs: sa_pq_{name}: the doctor found {diag['text']}")
            frames = list(sa.watch(timeout=60.0))
            fracs = [f["progress"]["fraction"] for f in frames if f["t"] == "progress"]
            if frames[-1].get("t") != "end" or frames[-1].get("state") != "successful" \
                    or any(a > b for a, b in zip(fracs, fracs[1:])):
                fail(f"obs: sa_pq_{name}'s watch stream: {frames[-1]}, fractions {fracs}")
            dev = {}
            for st in bundle["stages"]:
                for k, v in st["device"].items():
                    dev[k] = dev.get(k, 0) + v
            tl, te = registry_kernels(dev)
            if cuda:
                untimed = sorted(k for k in tl
                                 if te.get(k, 0.0) <= 0.0 and k not in OBS_TAG_COUNTS)
                if untimed:
                    fail(f"obs: sa_pq_{name}'s kernels launched in tasks with no event "
                         f"time: {untimed}")
            delta = {k: K.LAUNCHES[k] - before.get(k, 0) for k in K.LAUNCHES
                     if K.LAUNCHES[k] != before.get(k, 0)}
            kinds = [e["kind"] for e in bundle["journal"]]
            spans = len(bundle["trace"]["traceEvents"]) if bundle.get("trace") else 0
            out[f"sa_{name}"] = {"wall_ms": job_wall, "journal_events": len(kinds),
                                 "trace_events": spans, "task_launches": tl,
                                 "task_event_ms": te, "process_launches": delta,
                                 "stages": len(bundle["stages"])}
            log(f"obs sa_pq_{name}: {len(bundle['stages'])} stages, {len(kinds)} journal "
                f"events ({kinds[0]} .. {kinds[-1]}), {spans} trace events, doctor clean, "
                f"watch ended successful; the last job's launches in tasks {json.dumps(tl)}, "
                f"their event ms {json.dumps({k: round(v, 4) for k, v in te.items()})}; "
                f"launches in the process over the check ({'two queries: with and without '
                'its LIMIT' if name == 'q3' else 'one query'}) {json.dumps(delta)}")
        # one straggler: a stage-1 task stalls 2 s
        plan = faults.FaultPlan.from_obj({"seed": 16, "rules": [{
            "site": "executor.task.slow", "action": "delay", "delay_ms": 2000, "times": 1,
            "match": {"stage_id": 1}}]})
        with faults.use_plan(plan):
            check_q1(sa, sqls["q1"], oracles["q1"])
        rules = [f["rule"] for f in sa.doctor()["findings"]]
        if not plan.schedule() or "straggler" not in rules:
            fail(f"obs: the executor.task.slow straggler was not diagnosed: fired "
                 f"{plan.schedule()}, findings {rules}")
        out["straggler"] = {"fired": list(plan.schedule()), "findings": rules}
        log(f"obs straggler: executor.task.slow fired {plan.schedule()}, doctor findings "
            f"{rules}")
    finally:
        journal.set_enabled(False)
        faults.clear()

    # the warm q1 wall with the observatory off and on, alternating
    walls = {"off": [], "on": [], "on_explain_analyze": []}
    for _ in range(OBS_WALL_RUNS):
        for mode in walls:
            observe(mode != "off")
            t0 = time.perf_counter()
            if mode == "on_explain_analyze":
                ctx.explain_analyze(q1)
            else:
                ctx.sql(q1).collect()
            sync()
            walls[mode].append((time.perf_counter() - t0) * 1000)
    observe(True)
    out["q1_wall_ms"] = walls
    log(f"obs q1 warm wall ms ({out['card']}), {OBS_WALL_RUNS} runs each, alternating: "
        + "; ".join(f"{m} {[round(v, 2) for v in w]} (median {sorted(w)[len(w) // 2]:.2f})"
                    for m, w in walls.items()))
    return out


# --------------------------------------------------------------------------
# phase remote: the remote engine (a scheduler service, two executor servers,
# one of them in a child process, and a remote session)
# --------------------------------------------------------------------------

REMOTE_QUERIES = ("q1", "q3", "q18")
REMOTE_SLOTS = 4
# the scheduler removes a finished job's shuffle data this long after it ends
REMOTE_CLEANUP_DELAY_S = 1.0
REMOTE_PHASE_LIMIT_S = 120.0

# the child executor: the port's ExecutorServer in a process of its own (its
# own CUDA context), stopped when the parent closes its stdin
REMOTE_CHILD = r"""
import json, os, sys
sys.path.insert(0, {root!r})
from arrow_ballista_tpu_torch.executor.server import ExecutorServer
from arrow_ballista_tpu_torch.utils.config import BallistaConfig
ex = ExecutorServer("127.0.0.1", {port}, "127.0.0.1", 0, work_dir={work!r},
                    concurrent_tasks={slots}, executor_id={eid!r},
                    config=BallistaConfig({settings!r}), metrics_port=0, device={device!r})
ex.start()
with open({ready!r} + ".tmp", "w") as fh:
    json.dump({{"pid": os.getpid(), "data_plane": ex.data_plane,
               "metrics_port": ex.obs_http.port, "device": str(ex.device)}}, fh)
os.replace({ready!r} + ".tmp", {ready!r})
sys.stdin.read()
ex.stop(notify=True)
print("STOPPED", flush=True)
"""


def prom_values(text: str, name: str) -> dict:
    """{label set or '': value} of one metric in a prometheus exposition."""
    out = {}
    for line in text.splitlines():
        if line.startswith(name + "{") or line.startswith(name + " "):
            key, _, val = line.rpartition(" ")
            out[key[len(name):]] = float(val)
    return out


def remote_phase(device, pq_paths, sqls, oracles, K, F, sa_cfg, sa_walls, sa_frames) -> dict:
    """Phase remote, on the SF1 parquet files ``pq_paths``: a SchedulerNetService with
    round-robin distribution and the standalone paths' base config, two
    ExecutorServers of REMOTE_SLOTS task slots and separate work
    directories (one in this process, one in a child process), and
    ``BallistaContext.remote``.  rm_pq_q1 / q3 / q18 each run cold then warm,
    first with the default host match (co-located partitions through mmap),
    then with ``ballista.shuffle.local.host_match=false`` (the wire, lz4
    chunks; the child restarts with it).  Fails unless every run's rows
    equal the standalone path's bit for bit and the numpy oracles, every
    task ran on the device with each executor launching kernels, every
    kernel launch of the in-process executor equals its twin, the fetch
    paths are the ones asked for, no fused chain falls back, a warm run
    builds no generated source, the child stops cleanly and the work
    directories end empty."""
    import torch

    from arrow_ballista_tpu_torch import BallistaConfig, BallistaContext
    from arrow_ballista_tpu_torch.executor.server import ExecutorServer
    from arrow_ballista_tpu_torch.net.dataplane import STATS as DP_STATS
    from arrow_ballista_tpu_torch.ops import _cuda
    from arrow_ballista_tpu_torch.scheduler.netservice import SchedulerNetService
    from arrow_ballista_tpu_torch.scheduler.scheduler import SchedulerConfig
    from tests.torch_cases import assert_frames_equal

    t_phase = time.perf_counter()
    cuda = device.type == "cuda"
    out = {"card": smi("name,power.limit") if cuda else "cpu", "runs": {}}
    root = tempfile.mkdtemp(prefix="chip_smoke_remote_", dir=os.path.join(ROOT, "tmp"))
    atexit.register(shutil.rmtree, root, True)
    svc = SchedulerNetService("127.0.0.1", 0, config=BallistaConfig(sa_cfg),
                              scheduler_config=SchedulerConfig(
                                  task_distribution="round-robin",
                                  job_data_cleanup_delay_s=REMOTE_CLEANUP_DELAY_S),
                              device=device)
    svc.start()
    atexit.register(svc.stop)
    work = {eid: os.path.join(root, eid) for eid in ("rm-exec-0", "rm-exec-1")}
    local_ex = ExecutorServer("127.0.0.1", svc.port, "127.0.0.1", 0,
                              work_dir=work["rm-exec-0"], concurrent_tasks=REMOTE_SLOTS,
                              executor_id="rm-exec-0", config=BallistaConfig(sa_cfg),
                              device=device)
    local_ex.start()
    atexit.register(local_ex.stop, notify=False)

    def start_child(settings, tag):
        ready = os.path.join(root, f"child-{tag}.json")
        log_path = os.path.join(root, f"child-{tag}.log")
        fh = open(log_path, "w")
        proc = subprocess.Popen(
            [sys.executable, "-c", REMOTE_CHILD.format(
                root=ROOT, port=svc.port, work=work["rm-exec-1"], slots=REMOTE_SLOTS,
                eid="rm-exec-1", settings=settings, ready=ready, device=str(device))],
            stdin=subprocess.PIPE, stdout=fh, stderr=subprocess.STDOUT, cwd=ROOT)
        atexit.register(lambda: proc.poll() is None and proc.kill())
        t0 = time.perf_counter()
        while not os.path.exists(ready):
            if proc.poll() is not None or time.perf_counter() - t0 > 120:
                proc.kill()
                with open(log_path) as lf:
                    fail(f"remote: the child executor did not start (exit {proc.poll()}):\n"
                         f"{lf.read()[-3000:]}")
            time.sleep(0.05)
        with open(ready) as rf:
            info = json.load(rf)
        # registered once its server answers a ping and the scheduler knows it
        while svc.server.cluster.get_executor("rm-exec-1") is None:
            if time.perf_counter() - t0 > 120:
                fail("remote: the child executor never registered")
            time.sleep(0.05)
        info["start_s"] = time.perf_counter() - t0
        return proc, fh, log_path, info

    def stop_child(proc, fh, log_path):
        proc.stdin.close()
        try:
            rc = proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            fail("remote: the child executor did not stop within 60 s")
        fh.close()
        with open(log_path) as lf:
            text = lf.read()
        if rc != 0 or "STOPPED" not in text:
            fail(f"remote: the child executor exited {rc}:\n{text[-3000:]}")
        return rc

    def child_metrics(port, log_path):
        import urllib.request

        try:
            text = urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=10) \
                .read().decode()
        except OSError as e:
            with open(log_path) as lf:
                fail(f"remote: the child executor's /metrics does not answer ({e}):\n"
                     f"{lf.read()[-3000:]}")
        return {"bytes": {k.split('"')[1]: v for k, v in
                          prom_values(text, "shuffle_bytes_fetched_total").items()}}

    def task_folds(job_id):
        """Per executor: the tasks, their devices' launches, nvcc builds,
        and the readers' fetch metrics of one job (from the statuses)."""
        graph = svc.server.jobs.get_graph(job_id)
        per = {}
        fallbacks = 0
        reads = {"bytes_local_mmap": 0, "remote_fetches": 0, "wire_bytes": 0,
                 "raw_bytes": 0}
        for stage in graph.stages.values():
            for name, v in stage.aggregate_metrics().items():
                metric = name.rsplit(".", 1)[1]
                if metric == "fused_fallbacks":
                    fallbacks += v
                if "ShuffleReaderExec" in name and metric in reads:
                    reads[metric] += v
            for t in stage.task_infos:
                if t is None or t.status is None:
                    continue
                rec = per.setdefault(t.executor_id, {"tasks": 0, "launches": {}, "builds": 0})
                rec["tasks"] += 1
                for k, v in (t.status.device_stats or {}).items():
                    if k.startswith("launches."):
                        name = k.split(".", 1)[1]
                        rec["launches"][name] = rec["launches"].get(name, 0) + int(v)
                    elif k in ("jit_compiles", "jit_retraces"):
                        rec["builds"] += int(v)
        return per, reads, fallbacks

    def sync():
        if cuda:
            torch.cuda.synchronize()

    kernel_launches = {}  # rm path -> kernel -> launches (both executors, cold, host match)
    checked = {}  # rm path -> wrapper -> max abs err of the in-process executor's call
    for mode, settings in (("mmap", {}), ("wire",
                                          {"ballista.shuffle.local.host_match": "false"})):
        for k, v in settings.items():
            local_ex.executor.config.set(k, v)
        proc, fh, log_path, child = start_child({**sa_cfg, **settings}, mode)
        planes = {"rm-exec-0": local_ex.data_plane, "rm-exec-1": child["data_plane"]}
        devices = {"rm-exec-0": str(local_ex.device), "rm-exec-1": child["device"]}
        if any(torch.device(d).type != device.type for d in devices.values()):
            fail(f"remote: an executor runs on the wrong device: {devices}")
        ctx = BallistaContext.remote("127.0.0.1", svc.port, BallistaConfig(sa_cfg),
                                     device=device)
        for name in ("lineitem", "orders", "customer"):
            ctx.register_parquet(name, pq_paths[name])
        for q in REMOTE_QUERIES:
            path = f"rm_pq_{q}" + ("_wire" if mode == "wire" else "")
            rec = {"mode": mode, "data_planes": planes, "devices": devices,
                   "child_start_s": child["start_s"]}
            runs = []
            for run in ("cold", "warm"):
                dp_before = DP_STATS.snapshot()
                child_before = child_metrics(child["metrics_port"], log_path)
                K.reset_launch_counts()
                builds0 = len(_cuda.LIBRARIES.generated_builds)
                scope = Capture(K, F, device) if run == "cold" else contextlib.nullcontext()
                with scope as cap:
                    t0 = time.perf_counter()
                    df = ctx.sql(sqls[q]).to_pandas()
                    sync()
                    wall = time.perf_counter() - t0
                job_id = ctx._remote.last_job_id
                per, reads, fallbacks = task_folds(job_id)
                dp_after = DP_STATS.snapshot()
                child_after = child_metrics(child["metrics_port"], log_path)
                moved = {
                    "in_process": {p: dp_after["bytes_fetched"][p] - dp_before["bytes_fetched"][p]
                                   for p in dp_after["bytes_fetched"]},
                    "child": {p: child_after["bytes"].get(p, 0) - child_before["bytes"].get(p, 0)
                              for p in child_after["bytes"]}}
                try:
                    assert_frames_equal(df, sa_frames[q], exact=True)
                except AssertionError as e:
                    fail(f"{path} {run}: rows differ from sa_pq_{q}: {e}")
                if set(per) != {"rm-exec-0", "rm-exec-1"}:
                    fail(f"{path} {run}: tasks ran on {sorted(per)}, not on both executors")
                if cuda and any(not r["launches"] for r in per.values()):
                    fail(f"{path} {run}: an executor's tasks launched no kernel: "
                         f"{ {e: r['launches'] for e, r in per.items()} }")
                if fallbacks:
                    fail(f"{path} {run}: fused_fallbacks {fallbacks}")
                if mode == "wire" and (reads["remote_fetches"] <= 0 or reads["wire_bytes"] <= 0
                                       or reads["bytes_local_mmap"]):
                    fail(f"{path} {run}: host match off, but the readers fetched {reads}")
                if mode == "mmap" and (reads["remote_fetches"] or reads["bytes_local_mmap"] <= 0):
                    fail(f"{path} {run}: host match on, but the readers fetched {reads}")
                builds = len(_cuda.LIBRARIES.generated_builds) - builds0
                if run == "warm" and (builds or any(r["builds"] for r in per.values())):
                    fail(f"{path} warm: generated sources built again (this process {builds}, "
                         f"tasks { {e: r['builds'] for e, r in per.items()} })")
                if run == "cold":
                    if cap.off_device:
                        fail(f"{path}: tensors off the device: {cap.off_device[:5]}")
                    errs = {}
                    try:
                        for name in KERNEL_META:
                            for w in WRAPPERS[name]:
                                if w in cap.calls:
                                    errs[w] = check_kernel(K, w, cap.calls[w][1])
                        for key, (_n, args) in cap.calls.items():
                            if key.startswith("operator_program:"):
                                errs[key] = check_kernel(K, key, args)
                    except AssertionError as e:
                        fail(f"{path}: a kernel of the in-process executor disagrees with its "
                             f"twin: {e}")
                    checked[path] = errs
                    launched = {}
                    for r in per.values():
                        for k, v in r["launches"].items():
                            launched[k] = launched.get(k, 0) + v
                    kernel_launches[path] = launched
                    missing = [k for k in PATH_KERNELS.get(f"sa_pq_{q}", ())
                               if cuda and not launched.get(k)]
                    if missing:
                        fail(f"{path}: kernels of sa_pq_{q} launched by neither executor: "
                             f"{missing} ({launched})")
                runs.append({"run": run, "wall_ms": wall * 1000, "reads": reads,
                             "bytes_fetched": moved, "tasks": {e: r["tasks"] for e, r in
                                                               per.items()},
                             "launches": {e: r["launches"] for e, r in per.items()},
                             "builds": {"this_process": builds,
                                        **{e: r["builds"] for e, r in per.items()}}})
                log(f"{path} {run} ({out['card']}): wall {wall * 1000:.1f} ms (standalone "
                    f"sa_pq_{q} cold {sa_walls[q]['cold_ms']:.1f} ms, warm "
                    f"{sa_walls[q]['warm_ms']:.1f} ms); data planes {json.dumps(planes)}; "
                    f"readers {json.dumps(reads)}; bytes fetched by path {json.dumps(moved)}; "
                    f"tasks {json.dumps({e: r['tasks'] for e, r in per.items()})}")
            # the numpy oracles (more queries: q3 and q18 also without LIMIT)
            if q == "q1":
                check_q1(ctx, sqls[q], oracles[q])
            elif q == "q3":
                check_q3(ctx, sqls[q], oracles[q])
            else:
                check_q18(ctx, sqls[q], oracles[q])
            rec["runs"] = runs
            out["runs"][path] = rec
        ctx.shutdown()
        # the scheduler's delayed cleanup empties both work directories
        t0 = time.perf_counter()
        left = None
        while time.perf_counter() - t0 < 10 * REMOTE_CLEANUP_DELAY_S + 10:
            left = {e: [d for d in os.listdir(w) if os.path.isdir(os.path.join(w, d))]
                    for e, w in work.items() if os.path.isdir(w)}
            if not any(left.values()):
                break
            time.sleep(0.2)
        if any(left.values()):
            fail(f"remote ({mode}): job data left after the cleanup delay: {left}")
        out.setdefault("child_exit", {})[mode] = stop_child(proc, fh, log_path)
    local_ex.stop(notify=False)
    svc.stop()
    out["kernel_launches"] = kernel_launches
    out["checked"] = checked
    out["seconds"] = time.perf_counter() - t_phase
    log(f"remote: kernels held against their twins in the in-process executor "
        f"{json.dumps({p: {w: round(e, 6) for w, e in c.items()} for p, c in checked.items()})}")
    log(f"phase remote: {out['seconds']:.1f} s (limit {REMOTE_PHASE_LIMIT_S:.0f} s), "
        f"{out['card']}")
    if out["seconds"] > REMOTE_PHASE_LIMIT_S and cuda:
        fail(f"remote: the phase took {out['seconds']:.1f} s, over {REMOTE_PHASE_LIMIT_S} s")
    return out


# --------------------------------------------------------------------------
# the 22 TPC-H queries: the port on the CPU as the reference answers
# --------------------------------------------------------------------------


def cpu_answers(pq_dir: str, out_path: str, threads: int = 4) -> None:
    """``chip_smoke.py --cpu-answers DIR OUT``: the 22 queries and PT_QUERY
    (key "pt") through the port's local engine on the CPU (the plain twins)
    over the parquet files in DIR, pickled to OUT as {query: frame}.  Run as a child process
    by the card's run, beside its own work."""
    import pickle

    import torch

    sys.path.insert(0, ROOT)
    from arrow_ballista_tpu_torch import BallistaContext
    from benchmarks.queries import QUERIES

    torch.set_num_threads(threads)
    ctx = BallistaContext.local(device="cpu")
    for name in PARQUET_TABLES:
        ctx.register_parquet(name, os.path.join(pq_dir, f"{name}.parquet"))
    out = {}
    for q, sql in [*sorted(QUERIES.items()), ("pt", PT_QUERY)]:
        t0 = time.perf_counter()
        out[q] = (ctx.sql(sql).to_pandas(), time.perf_counter() - t0)
    with open(out_path + ".tmp", "wb") as fh:
        pickle.dump(out, fh)
    os.replace(out_path + ".tmp", out_path)


def op_metrics(plans, names):
    """Sums of the metrics ``names`` over the operators of ``plans``,
    the operators inside fused chains included, keyed by metric and then
    by operator class."""
    out = {n: {} for n in names}

    def walk(p):
        for op in [p, *getattr(p, "ops", [])]:
            m = op.metrics().to_dict()
            for n in names:
                if m.get(n):
                    out[n][type(op).__name__] = out[n].get(type(op).__name__, 0) + m[n]
        for c in p.children():
            walk(c)

    for plan in plans:
        walk(plan)
    return out


def smi(query: str) -> str:
    """One nvidia-smi reading of ``query`` (e.g. ``name,power.limit``)."""
    try:
        return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                              capture_output=True, text=True,
                              timeout=60).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        fail(f"nvidia-smi failed: {e}")


def main() -> None:
    if len(sys.argv) == 4 and sys.argv[1] == "--cpu-answers":
        cpu_answers(sys.argv[2], sys.argv[3])
        return
    try:
        import torch
    except ImportError as e:
        fail(f"torch is not importable: {e}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA card")
    card = smi("name,power.limit")
    log(f"card: {card}")
    t0 = time.perf_counter()
    # --save-calls FILE: also write the largest K16, K7 and K9 calls and K17's
    # by mesh path (for tools/spill_segment_timing.py and
    # tools/dispatch_disorder_timing.py --calls)
    save = sys.argv[2] if len(sys.argv) == 3 and sys.argv[1] == "--save-calls" else None
    # --obs-only [FILE]: the build, the data and phase obs alone (its report
    # as JSON to FILE)
    obs_only = len(sys.argv) in (2, 3) and sys.argv[1] == "--obs-only"
    # --remote-only [FILE]: the build, the data, the standalone runs of q1,
    # q3 and q18 and phase remote alone (its report as JSON to FILE)
    remote_only = len(sys.argv) in (2, 3) and sys.argv[1] == "--remote-only"
    report = run("cuda", save_calls=save, obs_only=obs_only, remote_only=remote_only)
    if (obs_only or remote_only) and len(sys.argv) == 3:
        with open(sys.argv[2], "w") as fh:
            json.dump(report["obs" if obs_only else "remote"], fh, indent=1, default=str)
    total = time.perf_counter() - t0
    log(f"phases (s): {json.dumps({k: round(v, 1) for k, v in report['phase_s'].items()})}")
    print(card, flush=True)
    print(json.dumps({"kernels": report["kernels"]}), flush=True)
    log(f"total: {total:.1f} s")
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
