"""K14 (EXTRACT's civil core) and K18 (the mesh's dense merge) of a checkout
of the PyTorch/CUDA port on one card, at the main path's shapes, so that
two commits can be compared in one call.

    python3 tools/civil_merge_timing.py [--root DIR] --data DIR [--seed 0]
        [--ptxas OUT]

``--root`` is the checkout whose ``arrow_ballista_tpu_torch`` is imported
(this tree, or a parent commit unpacked with ``git archive``); ``--data``
holds TPC-H SF1 from seed 0, generated on the first run as
``tools/torch_wall_compare.py`` keeps it (the tables as Arrow IPC and as
parquet), so later runs read it back.  What each part times:

- ``k14``: ``extract_field`` at ``chip_smoke.py``'s stress shape (6,000,000
  days over 1900-2099 with NULL and negative days), each field, held
  against its twin: device ms on the same input every call (as
  ``chip_smoke.py`` times it, ``fixed``) and over copies that rotate past
  the 50 MB L2 (``rotating``).  Bound: 4 bytes read and 4 written a row
  over 3.35 TB/s.
- ``extract_programs``: the generated programs that inline the civil core
  (``ab_civil_field``), K19's on pq_q7, pq_q8 and pq_q9 (the local engine
  over parquet) and K13's or K12's on sa_q7, sa_q8 and sa_q9 (the
  standalone engine over in-memory tables, ``chip_smoke.py``'s
  settings): each query runs once cold, then once warm with the programs'
  calls recorded; each program's largest call is held against its twin and
  timed (device ms of everything one call queues, its inputs rotating past
  the L2; bound: ``chip_smoke.program_bytes`` / ``fused_bytes``), and each
  path gets the sum over its programs.
- ``k18``: q1 on the mesh over parquet (``chip_smoke.py``'s ``mesh_q1``: the
  default mesh, one rank a card; ``mesh4_q1``: four ranks over the first
  card): one warm query with the dense merge's collectives recorded (the
  parent's one ``psum`` / ``pmin`` / ``pmax`` a state, the exists counts
  and the bad flag, then the compare ``exists > 0`` that its caller
  queued; this tree's one ``reduce_columns``), then the recorded merges
  replayed as the tree runs them: device ms and device activities a merge
  and a query (torch.profiler, or queued events), the host's enqueue time
  of a merge (host clock around calls, no sync) and its wall ms (CUDA
  events around back-to-back merges).  Every replayed result is held
  against the recorded query's own.

Prints one JSON line.  ``--ptxas OUT`` writes ``nvcc -Xptxas -v`` of
csrc/extract.cu and csrc/rank_merge.cu.  Needs a card.
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import importlib.util
import json
import os
import subprocess
import sys
import threading
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXTRACT_PATHS = ("pq_q7", "pq_q8", "pq_q9", "sa_q7", "sa_q8", "sa_q9")
MERGE_PATHS = ("mesh_q1", "mesh4_q1")


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = sys.modules[name] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _activities(cs, fn, iters=20):
    """Device activities (kernels, copies, memsets) a call queues: their
    number and, by name, how many a call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    rows = [(c, key.split("(")[0][:60]) for _ms, c, key in cs.device_rows(prof)]
    return sum(c for c, _k in rows) / iters, {k: c / iters for c, k in rows}


def _host_ms(fn, iters=200):
    """The host's time to enqueue one call: host clock around ``iters``
    back-to-back calls, no sync inside, over ``iters``."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host = (time.perf_counter() - t0) * 1000 / iters
    torch.cuda.synchronize()
    return host


def k14(K, cs, dev, seed):
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    n = cs.STRESS_ROWS
    days = rng.integers(-25567, 47482, n).astype(np.int32)  # 1900-01-01 .. 2099-12-31
    days[rng.random(n) < 0.02] = np.iinfo(np.int32).min  # NULL dates
    neg = rng.random(n) < 0.01
    days[neg] = rng.integers(-2**31 + 1, 0, int(neg.sum()))
    dd = torch.from_numpy(days).to(dev)
    moved = 8 * n
    out = {"rows": n, "bound_ms": moved / cs.HBM_BYTES_PER_S * 1000, "fields": {}}
    for field in ("year", "month", "day"):
        want = K.extract_field_plain(dd, field)
        if not torch.equal(K.extract_field(dd, field), want):
            raise AssertionError(f"EXTRACT({field}) differs from its twin")
        nxt = cs.rotating((dd,), moved)
        rec = {}
        for label, fn in (("fixed", lambda: K.extract_field(dd, field)),
                          ("rotating", lambda: K.extract_field(*nxt(), field))):
            ms, source = cs.device_ms(fn)
            rec[label] = {"ms": ms, "ms_source": source, "wall_ms": cs.time_ms(fn, dev)}
        out["fields"][field] = rec
    return out


class CivilCalls:
    """While active, the largest call of each generated program whose
    source inlines the civil core (K19's, K12's and K13's wrappers)."""

    def __init__(self, cs):
        from arrow_ballista_tpu_torch.compile import fused as F
        from arrow_ballista_tpu_torch.compile import programs as P

        self.cs = cs
        self.mods = {"operator_program": P, "fused_rows": F, "fused_agg": F}
        self.calls = {}
        self.orig = {}
        self.lock = threading.Lock()

    def __enter__(self):
        for name, mod in self.mods.items():
            self.orig[name] = getattr(mod, name)
            setattr(mod, name, self._wrap(name, self.orig[name]))
        return self

    def _wrap(self, name, fn):
        cs = self.cs

        @functools.wraps(fn)
        def wrapper(*args):
            prog, mask = args[0], args[2]
            if "ab_civil_field(" in prog.gen.source and (name != "operator_program"
                                                         or prog.launches()):
                key = cs.civil_key(name, prog)
                with self.lock:
                    if key not in self.calls or mask.shape[0] > self.calls[key][0]:
                        self.calls[key] = (mask.shape[0], cs._clone(args))
            return fn(*args)

        return wrapper

    def __exit__(self, *exc):
        for name, mod in self.mods.items():
            setattr(mod, name, self.orig[name])


def extract_programs(K, cs, tree, dev):
    import torch

    out = {}
    for path in EXTRACT_PATHS:
        tree.run(path)  # cold: builds the generated sources
        with CivilCalls(cs) as cap:
            tree.run(path)
        progs = []
        for key, (_n, args) in sorted(cap.calls.items()):
            rec = cs.civil_program_time(K, key, args, dev)
            launch = functools.partial(cs.civil_launch(key.split(":")[0]), *args)
            rec["device_activities_per_call"], rec["by_name"] = _activities(cs, launch)
            progs.append(rec)
        torch.cuda.synchronize()
        out[path] = {"programs": progs, "ms_sum": sum(p["ms"] for p in progs)}
    return out


def _merge_groups(calls):
    """The recorded collectives of a query as merges: this tree's
    ``reduce_columns`` calls one a merge; the parent's ``psum`` / ``pmin`` /
    ``pmax`` calls split after each bad flag (a one-slot bool array)."""
    groups, cur = [], []
    for fname, args in calls:
        if fname == "reduce_columns":
            groups.append([(fname, args)])
            continue
        cur.append((fname, args))
        xs = args[0]
        if str(xs[0].dtype) == "torch.bool" and xs[0].numel() == 1:
            groups.append(cur)
            cur = []
    if cur:
        raise AssertionError(f"{len(cur)} collectives after the last bad flag")
    return groups


def _replay(C, group):
    """One merge as the tree queues it: the results, as the dense
    aggregate's gather reads them (the parent's exists count compared with
    0 there)."""
    if group[0][0] == "reduce_columns":
        return list(C.reduce_columns(*group[0][1]))
    outs = [getattr(C, fname)(*args) for fname, args in group]
    outs[-2] = outs[-2] > 0  # the exists counts, then the bad flag
    return outs


def k18(K, C, cs, tree, dev):
    import torch

    from arrow_ballista_tpu_torch.parallel import distributed as D
    from arrow_ballista_tpu_torch.parallel import use_local_devices
    from benchmarks.queries import QUERIES

    names = [n for n in ("reduce_columns", "psum", "pmin", "pmax") if hasattr(C, n)]
    ctx = _mesh_context(tree, cs)
    out = {}
    for path in MERGE_PATHS:
        scope = (use_local_devices([torch.device("cuda", 0)] * cs.MESH_RANKS)
                 if path == "mesh4_q1" else contextlib.nullcontext())
        with scope:
            ctx.sql(QUERIES[1]).to_pandas()  # cold
            calls, orig = [], {n: getattr(C, n) for n in names}

            def recorder(fname):
                def rec(*args):
                    res = orig[fname](*args)
                    calls.append((fname, cs._clone(args), cs._clone(res)))
                    return res
                return rec

            recorders = {n: recorder(n) for n in names}
            # the parent's dense aggregate took its state reductions from a
            # table made at import
            table = getattr(D, "_REDUCE", {})
            kept = dict(table)
            for n in names:
                setattr(C, n, recorders[n])
            for how, fn in kept.items():
                table[how] = recorders[fn.__name__]
            try:
                K.reset_launch_counts()
                ctx.sql(QUERIES[1]).to_pandas()
                launches = K.LAUNCHES["merge_rank_states"]
            finally:
                for n in names:
                    setattr(C, n, orig[n])
                table.update(kept)
        groups = _merge_groups([(f, a) for f, a, _r in calls])
        recorded = [r for _f, _a, r in calls]
        # each replayed merge equals the query's own collectives' results
        at = 0
        for g in groups:
            got = _replay(C, g)
            if g[0][0] == "reduce_columns":
                want = list(recorded[at])
            else:
                want = list(recorded[at:at + len(g)])
                want[-2] = want[-2] > 0
            at += len(g)
            for a, b in zip(got, want):
                if not torch.equal(a.cpu(), b.cpu()) and not (
                        a.dtype.is_floating_point and torch.allclose(a.cpu(), b.cpu(),
                                                                     rtol=1e-12, atol=0,
                                                                     equal_nan=True)):
                    raise AssertionError(f"{path}: a replayed merge differs from the query's")

        def merge():
            return _replay(C, groups[0])

        def query_merges():
            return [_replay(C, g) for g in groups]

        ms, source = cs.device_ms(merge)
        per_call, by_name = _activities(cs, merge)
        q_ms, q_source = cs.device_ms(query_merges)
        first = groups[0][0][1][0]  # the first collective's per-rank argument
        columns = first[0] if groups[0][0][0] == "reduce_columns" else None
        out[path] = {"merges_per_query": len(groups),
                     "collectives_per_merge": len(groups[0]),
                     "columns": len(columns) if columns is not None else len(groups[0]),
                     "slots": int((columns[0] if columns is not None else first[0]).numel()),
                     "k18_launches_per_query": launches,
                     "merge_ms": ms, "merge_ms_source": source,
                     "device_activities_per_merge": per_call, "by_name": by_name,
                     "query_merges_ms": q_ms, "query_merges_ms_source": q_source,
                     "merge_host_ms": _host_ms(merge), "merge_wall_ms": cs.time_ms(merge, dev)}
    return out


def _mesh_context(tree, cs):
    from arrow_ballista_tpu_torch import BallistaConfig, BallistaContext

    ctx = BallistaContext.local(BallistaConfig(dict(cs.MESH_SETTINGS)), device=tree.device)
    for name, path in tree.pq_paths.items():
        ctx.register_parquet(name, path)
    return ctx


def ptxas(out_path):
    """nvcc -Xptxas -v of csrc/extract.cu and csrc/rank_merge.cu."""
    from arrow_ballista_tpu_torch.ops import _cuda

    text = []
    for name in ("extract", "rank_merge"):
        path = str(_cuda.CSRC / f"{name}.cu")
        flags = [f for f in _cuda.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
        res = subprocess.run([_cuda.nvcc_path(), *flags, "-Xptxas", "-v", "-c", path, "-o",
                              os.devnull], capture_output=True, text=True)
        text.append(f"== {path} (exit {res.returncode})\n{res.stdout}{res.stderr}")
    with open(out_path, "w") as f:
        f.write("\n".join(text))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--data", required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ptxas", default=None)
    args = ap.parse_args()
    # this tree's chip_smoke (its bounds, timers and checks) and wall tool
    # (data and contexts), whatever --root is; the port from --root
    cs = _load("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    wall = _load("torch_wall_compare", os.path.join(HERE, "tools", "torch_wall_compare.py"))
    tree = wall.Tree(args.root, args.data, 1.0)  # exits without a card
    from arrow_ballista_tpu_torch.ops import kernels as K
    from arrow_ballista_tpu_torch.parallel import collectives as C

    out = {"root": tree.root, "device": tree.torch.cuda.get_device_name(0),
           "power_limit": cs.smi("power.limit")}
    try:
        out["k14"] = k14(K, cs, tree.device, args.seed)
        out["extract_programs"] = extract_programs(K, cs, tree, tree.device)
        out["k18"] = k18(K, C, cs, tree, tree.device)
    finally:
        tree.close()
    if args.ptxas:
        ptxas(args.ptxas)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
