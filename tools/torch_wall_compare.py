"""Warm walls of chosen ``chip_smoke.py`` paths for checkouts of the
PyTorch/CUDA port, so that two commits can be compared in one call on one
card.

    python3 tools/torch_wall_compare.py --root DIR --data DIR [--runs 7]
        [--paths q3,pq_q4,pq_q7,sa_pq_q18] [--profile OUT] [--kernels]
    python3 tools/torch_wall_compare.py --pair PARENT,CHANGE --data DIR
        [--pairs 10] [--paths q3,q4] [--profile OUT] [--profile-runs 5]

``--root`` is a checkout whose ``arrow_ballista_tpu_torch`` is imported
(this tree, or a parent commit unpacked with ``git archive``); the data
and the queries come from this repo's ``benchmarks/``.  TPC-H SF1 from
seed 0 is generated on the first run and kept in ``--data`` (the tables
as Arrow IPC for the in-memory paths, parquet as ``chip_smoke.py`` writes
it), so later runs read it back.  Each path runs once cold and ``--runs``
times warm (``sql`` -> ``to_pandas``, then a device synchronize, on the
host clock), with the contexts and configurations of ``chip_smoke.py``:
the local engine with its defaults, and the standalone one with 'auto'
shuffle partitions, 2^20-row batches and four task slots.  A path is
``q<n>`` (local, in memory), ``pq_q<n>`` (local, parquet), ``sa_q<n>``
(standalone, in memory), ``sa_pq_q<n>`` (standalone, parquet),
``mesh4_q3`` / ``mesh4_q3_part`` / ``mesh4_q18`` (the local engine over
parquet on a mesh of four ranks over the first card, ``chip_smoke.py``'s
settings) or ``spill_q<n>`` (the local engine over parquet with every join
partitioned under a 1 MiB host budget, ``chip_smoke.py``'s spill settings;
``chip_smoke.py`` runs them over SF0.25: pass ``--sf 0.25``).  Prints one JSON line: ``{"root", "device", "paths": {path:
{"cold_ms", "warm_ms", "median_ms", "rows"}}}``.  With ``--profile OUT``
the warm runs of each path also run under cProfile, and OUT gets the 30
functions with the most
own time, per path (host time: where the walls go when the card idles),
and the spilled join's own time (``_join_spilled``, the build split's
host work).
With ``--kernels`` one more warm run of each path runs under
torch.profiler, and each path gets ``kernels``: the device ms and
launches of K4's (``sort_order``) and K5's (``build_side_sort``) CUDA
kernels in that query, by kernel name (``chip_smoke.RADIX_KERNELS``
names them in this tree and in the parent of the radix redesign), K10's
(``key_range_check``) and K11's (``clustered_keep``) launches and device
ms with the memsets queued right before them (``chip_smoke.
clustered_trace``; the parent of their redesign queued one a call), K6's
(``probe_join``) and K2's (``compaction_order``) launches, device ms by
kernel, the memsets and copies right before them and their wrappers' calls
(``chip_smoke.call_trace``, which names the kernels of this tree and of the
parent of their redesign, and counts the shared scan kernels as K2's only
in a K2 call), K8's (``grouped_on_order``) and K22's bucket form
(``bucket_masks``, one launch a partition in the parent of its redesign)
likewise, ``dense``: K1's and K13's own kernels (``chip_smoke.dense_trace``:
launches and device ms by name, the parent's init kernel among them) and
``device_ms``, the device time of what torch ops queued inside the dense
aggregate calls (a profiler range around each call: in the parent of the
one-launch redesign its K2 and the compaction's torch glue; None when a
call queued none; a kernel launched through ctypes is not attributed to
the range, and the standalone engine's task threads record no range),
so the dense device ms of a query is the kernels' plus ``device_ms``;
``calls`` counts the ranges, host and device side; and the device ms of
all kernels.  Run parent, change,
change, parent in one call and compare the medians.

``--pair PARENT,CHANGE`` keeps one process of each tree alive (this
script with ``--serve``: the same contexts, each query on request) and
alternates them query by query: after one cold run of each path in each,
``--pairs`` rounds of every path, the parent first in even rounds and the
change first in odd ones, so that drift over the call falls on both
sides alike.  Only one process runs a query at a time.  Prints one JSON
line: per path both sides' warm walls in round order, their medians and
ranges, the change / parent ratio of each round and of the medians, and
the rounds in which the change was slower.  With ``--profile OUT`` each
process then runs ``--profile-runs`` more warm runs of each path under
cProfile (outside the timed rounds), and OUT gets, per tree and path, the
30 functions with the most own time and the cumulative time of the port's
kernel wrappers (``ops/kernels.py``).  Needs a card.
"""
from __future__ import annotations

import argparse
import contextlib
import cProfile
import io
import json
import os
import pstats
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)  # benchmarks/ and chip_smoke
from chip_smoke import (RADIX_KERNELS, call_trace, clustered_trace, dense_trace,  # noqa: E402
                        range_device_ms)

TABLES = ("lineitem", "orders", "customer", "part", "partsupp", "supplier", "nation",
          "region")
ROW_GROUP_ROWS = 1 << 19  # chip_smoke.py ROW_GROUP_ROWS at SF1
REPLY = "@@ "  # the prefix of a --serve process's replies on its stdout


def _make_data(directory: str, sf: float) -> None:
    """TPC-H at ``sf`` from seed 0 in ``directory``, unless it is there."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    os.makedirs(directory, exist_ok=True)
    done = os.path.join(directory, "done")
    if os.path.exists(done):
        return
    from benchmarks.datagen import generate_tables
    from benchmarks.tpch import decimal_to_int64_storage

    tables = generate_tables(sf, seed=0)
    for name in TABLES:
        with pa.ipc.new_file(os.path.join(directory, f"{name}.arrow"), tables[name].schema) as w:
            w.write_table(tables[name])
        pq.write_table(decimal_to_int64_storage(tables[name]),
                       os.path.join(directory, f"{name}.parquet"), compression="zstd",
                       row_group_size=max(1024, int(ROW_GROUP_ROWS * sf)))
    open(done, "w").close()


def _data(directory: str, sf: float):
    """{table: in-memory arrow table}, {table: parquet path}."""
    import pyarrow as pa

    _make_data(directory, sf)
    mem = {n: pa.ipc.open_file(os.path.join(directory, f"{n}.arrow")).read_all()
           for n in TABLES}
    return mem, {n: os.path.join(directory, f"{n}.parquet") for n in TABLES}


DENSE_RANGE = "ab_dense_aggregate"


@contextlib.contextmanager
def _dense_ranges():
    """Each dense aggregate call inside a torch.profiler range: the local
    and standalone dense path (``kernels._grouped_aggregate_dense``), the
    mesh's slot-aligned states (``kernels.dense_group_states``) and K13's
    dense form (``fused.fused_agg`` over a dense key domain), so that its
    device time counts with all it queues (in a tree before the one-launch
    redesign, K2 and the torch glue of the compaction too)."""
    from torch.profiler import record_function

    from arrow_ballista_tpu_torch.compile import fused as F
    from arrow_ballista_tpu_torch.ops import kernels as K

    def ranged(fn, dense=lambda *a: True):
        def call(*a, **kw):
            if not dense(*a):
                return fn(*a, **kw)
            with record_function(DENSE_RANGE):
                return fn(*a, **kw)
        return call

    saved = [(K, "_grouped_aggregate_dense"), (K, "dense_group_states"), (F, "fused_agg")]
    orig = [getattr(mod, name) for mod, name in saved]
    K._grouped_aggregate_dense = ranged(orig[0])
    K.dense_group_states = ranged(orig[1])
    F.fused_agg = ranged(orig[2], lambda *a: K.dense_domain(a[5]) is not None)
    try:
        yield
    finally:
        for (mod, name), fn in zip(saved, orig):
            setattr(mod, name, fn)


def _kernel_times(ctx, sql):
    """One more warm run under torch.profiler: the device ms of K4's and
    K5's kernels in it (RADIX_KERNELS), their launches, K10's and K11's
    launches, device ms and the memsets before them (``clustered_trace``),
    K6's and K2's, by kernel, with the memsets and copies before them and
    their wrappers' calls (``call_trace``), and the device ms of all
    kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from arrow_ballista_tpu_torch.ops import kernels as K

    before = dict(K.LAUNCHES)
    with _dense_ranges(), profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA]) as prof:
        ctx.sql(sql).to_pandas()
        torch.cuda.synchronize()
    by_name = {}
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0)
        if us:
            by_name[ev.key] = (us / 1000, ev.count)
    out = {}
    for name, parts in RADIX_KERNELS.items():
        rows = {k: v for k, v in by_name.items() if any(p in k for p in parts)}
        out[name] = {"device_ms": sum(v[0] for v in rows.values()),
                     "launches": sum(v[1] for v in rows.values()),
                     "by_kernel": {k[:80]: round(v[0], 4) for k, v in rows.items()}}
    # K10 and K11 (the same kernel names in the parent of their redesign),
    # with the memsets queued right before them
    out.update(clustered_trace(prof))
    for name, rec in call_trace(prof).items():
        # a tree without the wrapper (K22's bucket form before its redesign
        # counted under mask_ops) has no count of its calls
        rec["wrapper_calls"] = K.LAUNCHES[name] - before[name] if name in K.LAUNCHES else None
        out[name] = rec
    # the dense aggregate: its calls' device ms with all they queue, and
    # K1's and K13's own kernels by name (dense_trace)
    out["dense"] = {"device_ms": range_device_ms(prof, DENSE_RANGE),
                    "calls": sum(1 for ev in prof.events() if ev.name == DENSE_RANGE),
                    **dense_trace(prof)}
    out["all_device_ms"] = sum(v[0] for v in by_name.values())
    return out


class Tree:
    """One checkout's port over the data, its contexts made as a path first
    needs them; ``run(path)`` runs the path's query once."""

    def __init__(self, root: str, data: str, sf: float):
        self.root = os.path.abspath(root)
        sys.path.insert(0, self.root)  # the port under test comes first
        import torch

        if not torch.cuda.is_available():
            sys.exit("no CUDA device: this comparison runs on the card")
        import arrow_ballista_tpu_torch as port
        from arrow_ballista_tpu_torch.ops import _cuda

        if not os.path.abspath(port.__file__).startswith(self.root + os.sep):
            sys.exit(f"imported the port from {port.__file__}, not from {self.root}")
        from benchmarks.queries import QUERIES

        _cuda.LIBRARIES.build_all()  # the hand-written kernels, outside the walls
        self.torch = torch
        self.device = torch.device("cuda")
        self.mem, self.pq_paths = _data(os.path.abspath(data), sf)
        self.sf = sf
        self.queries = QUERIES
        self.q18 = QUERIES[18].replace("> 300", "> 300" if sf >= 1 else "> 200")
        self.contexts = {}
        self.standalone = []

    def _context(self, engine: str, path: str):
        from arrow_ballista_tpu_torch import BallistaConfig, BallistaContext

        key = path if engine == "mesh4" else engine
        if key in self.contexts:
            return self.contexts[key]
        sa_cfg = {"ballista.shuffle.partitions": "auto", "ballista.batch.size": str(1 << 20)}
        mesh_on = {"ballista.shuffle.mesh": "true", "ballista.shuffle.mesh.min_rows": "0"}
        mesh_cfg = {"mesh4_q3": {**mesh_on, "ballista.join.broadcast_threshold": "0",
                                 "ballista.shuffle.mesh.broadcast_rows":
                                     str(round((1 << 20) * self.sf))},
                    "mesh4_q3_part": {**mesh_on, "ballista.join.broadcast_threshold": "0",
                                      "ballista.shuffle.mesh.broadcast_rows": "0"},
                    "mesh4_q18": {**mesh_on, "ballista.agg.capacity": str(1 << 21)}}
        spill_cfg = {"ballista.join.broadcast_threshold": "0",
                     "ballista.memory.host.budget.bytes": str(1 << 20)}
        if engine in ("sa", "sa_pq"):
            ctx = BallistaContext.standalone(BallistaConfig(sa_cfg), concurrent_tasks=4,
                                             device=self.device)
            self.standalone.append(ctx)
        elif engine == "mesh4":
            ctx = BallistaContext.local(BallistaConfig(mesh_cfg[path]), device=self.device)
        elif engine == "spill":
            ctx = BallistaContext.local(BallistaConfig(spill_cfg), device=self.device)
        else:
            ctx = BallistaContext.local(device=self.device)
        for name, table in self.mem.items():
            if engine in ("", "sa"):
                ctx.register_table(name, table)
            else:
                ctx.register_parquet(name, self.pq_paths[name])
        self.contexts[key] = ctx
        return ctx

    def query(self, path: str):
        """(context, sql, scope) of a path."""
        engine, _, q = path.removesuffix("_part").rpartition("_")
        ctx = self._context(engine, path)
        scope = contextlib.nullcontext()
        if engine == "mesh4":
            from arrow_ballista_tpu_torch.parallel import use_local_devices

            scope = use_local_devices([self.torch.device("cuda", 0)] * 4)
        return ctx, (self.q18 if q == "q18" else self.queries[int(q[1:])]), scope

    def run(self, path: str):
        """One run of the path's query: (wall ms, result rows)."""
        ctx, sql, scope = self.query(path)
        with scope:
            t0 = time.perf_counter()
            df = ctx.sql(sql).to_pandas()
            self.torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1000, len(df)

    def profile(self, path: str, runs: int) -> str:
        """``runs`` warm runs under cProfile: the 30 functions with the most
        own time and the cumulative time of ops/kernels.py's functions."""
        prof = cProfile.Profile()
        prof.enable()
        for _ in range(runs):
            self.run(path)
        prof.disable()
        text = io.StringIO()
        stats = pstats.Stats(prof, stream=text)
        stats.sort_stats("tottime").print_stats(30)
        stats.sort_stats("cumulative").print_stats("ops/kernels.py", 25)
        return text.getvalue()

    def close(self) -> None:
        for ctx in self.standalone:
            ctx.shutdown()


def single(args) -> None:
    tree = Tree(args.root, args.data, args.sf)
    out = {"root": tree.root, "device": tree.torch.cuda.get_device_name(0), "paths": {}}
    try:
        for path in args.paths.split(","):
            walls, rows = [tree.run(path)[0]], None
            prof = cProfile.Profile() if args.profile else None
            for _ in range(args.runs):
                if prof is not None:
                    prof.enable()
                ms, rows = tree.run(path)
                if prof is not None:
                    prof.disable()
                walls.append(ms)
            kernels = None
            if args.kernels:
                ctx, sql, scope = tree.query(path)
                with scope:
                    kernels = _kernel_times(ctx, sql)
            if prof is not None:
                text = io.StringIO()
                stats = pstats.Stats(prof, stream=text).sort_stats("tottime")
                stats.print_stats(30)
                stats.print_stats("_join_spilled")
                with open(args.profile, "a") as f:
                    f.write(f"== {tree.root} {path}: {args.runs} warm runs\n{text.getvalue()}\n")
            out["paths"][path] = {"cold_ms": walls[0], "warm_ms": walls[1:],
                                  "median_ms": statistics.median(walls[1:]), "rows": rows,
                                  **({"kernels": kernels} if kernels is not None else {})}
    finally:
        tree.close()
    print(json.dumps(out))


def serve(args) -> None:
    """Answer one JSON request a line on stdin: {"run": path} -> {"ms",
    "rows"}, {"profile": path, "runs": n} -> {"text"}; EOF ends it."""
    tree = Tree(args.root, args.data, args.sf)

    def reply(obj):
        sys.stdout.write(REPLY + json.dumps(obj) + "\n")
        sys.stdout.flush()

    reply({"ready": tree.root, "device": tree.torch.cuda.get_device_name(0)})
    try:
        for line in sys.stdin:
            req = json.loads(line)
            if "run" in req:
                ms, rows = tree.run(req["run"])
                reply({"ms": ms, "rows": rows})
            else:
                reply({"text": tree.profile(req["profile"], req["runs"])})
    finally:
        tree.close()


class Worker:
    """A --serve process of one tree."""

    def __init__(self, root: str, args):
        self.root = os.path.abspath(root)
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--serve", "--root", self.root,
             "--data", args.data, "--sf", str(args.sf)],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)

    def read(self) -> dict:
        for line in self.proc.stdout:
            if line.startswith(REPLY):
                return json.loads(line[len(REPLY):])
            sys.stderr.write(line)  # the tree's own output
        raise RuntimeError(f"the process of {self.root} ended (rc {self.proc.wait()})")

    def ask(self, req: dict) -> dict:
        self.proc.stdin.write(json.dumps(req) + "\n")
        self.proc.stdin.flush()
        return self.read()

    def close(self) -> None:
        if self.proc.poll() is None:
            self.proc.stdin.close()
            try:
                self.proc.wait(timeout=120)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()


def pair(args) -> None:
    parent_root, change_root = args.pair.split(",")
    _make_data(os.path.abspath(args.data), args.sf)  # once, before both read it
    paths = args.paths.split(",")
    workers, device = {}, None
    try:
        for side, root in (("parent", parent_root), ("change", change_root)):
            workers[side] = Worker(root, args)
            device = workers[side].read()["device"]  # ready: one sets up at a time
        out = {"parent": workers["parent"].root, "change": workers["change"].root,
               "device": device, "pairs": args.pairs, "paths": {}}
        walls = {p: {"parent": [], "change": []} for p in paths}
        cold = {p: {} for p in paths}
        rows = {p: {} for p in paths}
        for p in paths:
            for side in ("parent", "change"):
                r = workers[side].ask({"run": p})
                cold[p][side], rows[p][side] = r["ms"], r["rows"]
        for i in range(args.pairs):
            order = ("parent", "change") if i % 2 == 0 else ("change", "parent")
            for p in paths:
                for side in order:
                    walls[p][side].append(workers[side].ask({"run": p})["ms"])
        for p in paths:
            w = walls[p]
            ratios = [c / q for c, q in zip(w["change"], w["parent"])]
            med = {s: statistics.median(w[s]) for s in ("parent", "change")}
            out["paths"][p] = {
                "rows": rows[p], "cold_ms": cold[p], "warm_ms": w,
                "median_ms": med, "range_ms": {s: [min(w[s]), max(w[s])] for s in w},
                "ratio_of_medians": med["change"] / med["parent"],
                "round_ratios": ratios, "median_round_ratio": statistics.median(ratios),
                "rounds_change_slower": sum(r > 1 for r in ratios)}
        if args.profile:
            with open(args.profile, "a") as f:
                for p in paths:
                    for side in ("parent", "change"):
                        text = workers[side].ask({"profile": p, "runs": args.profile_runs})["text"]
                        f.write(f"== {side} {workers[side].root} {p}: {args.profile_runs} warm "
                                f"runs\n{text}\n")
    finally:
        for w in workers.values():
            w.close()
    print(json.dumps(out))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root")
    ap.add_argument("--pair", help="PARENT,CHANGE: alternate two trees query by query")
    ap.add_argument("--serve", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--data", required=True)
    ap.add_argument("--runs", type=int, default=7)
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--sf", type=float, default=1.0)
    ap.add_argument("--paths", default="q1,q3,q4,pq_q1,pq_q3,pq_q4,pq_q7,pq_q18,sa_pq_q1,"
                                       "sa_pq_q18")
    ap.add_argument("--profile", default=None)
    ap.add_argument("--profile-runs", type=int, default=5)
    ap.add_argument("--kernels", action="store_true")
    args = ap.parse_args()
    if args.serve:
        serve(args)
    elif args.pair:
        pair(args)
    elif args.root:
        single(args)
    else:
        ap.error("give --root or --pair")


if __name__ == "__main__":
    main()
