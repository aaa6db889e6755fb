"""K1 (the dense grouped aggregate) and K13's dense form of a checkout of
the PyTorch/CUDA port at the main path's shapes on one card, beside their
yardsticks, so that two commits can be compared in one call.

    python3 tools/dense_timing.py [--root DIR] [--seed 0] [--ptxas OUT]

``--root`` is the checkout whose ``arrow_ballista_tpu_torch`` is imported
(this tree, or a parent commit unpacked with ``git archive``); inputs are
made from ``--seed`` with numpy.  Every shape goes through the calls both
trees have: ``kernels.grouped_aggregate`` (the dense path: in a tree
before the one-launch redesign K1's states, then K2 and the torch glue of
its compaction; after it, K1's compacted form), ``kernels.dense_group_states``
(the mesh's slot-aligned states) and ``compile.fused.fused_agg`` (K13).

- ``q1_real``: sa_csv_q1's largest call, 6,291,456 rows: TPC-H SF1
  lineitem in its row order, q1's two dictionary-code keys over (-1, 15)
  each (289 slots, four live), q1's date filter as the mask, five int64
  sums and four counts (49 bytes a row, as q1's partial reads them);
- ``q1_like``: the same shape from the seed, the keys drawn in
  lineitem's shares, 98.6% live; ``q1_like_slots`` the same through the
  slot-aligned form;
- ``sweep_<h>``: the same rows spread evenly over h of the 289 slots
  (1, 4, 64, 289): what a few hot slots cost;
- ``wide``: 6,000,000 rows over a 33,153-slot domain (too wide for shared
  memory), both forms;
- ``k13_q1``: q1's partial aggregate chain (the filter, the projection and
  the aggregate fused) over 1,048,576 rows of TPC-H lineitem (sa_pq_q1's
  call), beside the interpreted chain (the closures over TorchOps, then
  ``grouped_aggregate``'s kernels);
- ``k13_sweep_<h>``: K13 over ``chip_smoke.dense_sweep_chain`` at
  1,048,576 rows, live rows on h of 256 key pairs (1, 4, 64, 256).

Device ms a call from torch.profiler (``chip_smoke.device_ms``: every
kernel, copy and memset the call queues), launches a call from the same
profile, wall ms from CUDA events around back-to-back calls
(``chip_smoke.time_ms``); K13's inputs rotate past the 50 MB L2
(``chip_smoke.rotating``), the 6M-row ones exceed it.  Bounds: bytes (each
key, value and mask byte read once, the compacted groups or the slot-aligned
states written once) over 3.35 TB/s.  Every result is held against its
twin (integers, keys, masks and flags exact, float sums at rtol 1e-12).
``--ptxas OUT`` also writes ``nvcc -Xptxas -v`` for csrc/dense_agg.cu and
for the generated source of ``k13_q1``'s chain into OUT.  Prints one JSON
line.  Needs a card.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SLOTS = (1, 4, 64, 289)
K13_SLOTS = (1, 4, 64, 256)
Q1_SHARES = {(0, 0): 0.2466, (1, 0): 0.0064, (1, 1): 0.5004, (2, 0): 0.2466}  # A-F N-F N-O R-F


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = sys.modules[name] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def q1_like(rng, n, slots=None):
    """(keys, vals, mask, key_ranges) as numpy: q1's codes in lineitem's
    shares, or spread evenly over ``slots`` of the 289."""
    import numpy as np

    if slots is None:
        pairs = np.array(list(Q1_SHARES))
        pick = pairs[rng.choice(len(pairs), n, p=np.array(list(Q1_SHARES.values())) /
                                sum(Q1_SHARES.values()))]
        k1, k2 = pick[:, 0], pick[:, 1]
    else:
        chosen = rng.permutation(289)[:slots]
        slot = chosen[rng.integers(0, slots, n)]
        k1, k2 = slot // 17 - 1, slot % 17 - 1
    vals = [(rng.integers(0, 10**7, n).astype(np.int64), "sum") for _ in range(5)]
    vals += [(np.zeros(n, np.int64), "count") for _ in range(4)]
    return ([k1.astype(np.int32), k2.astype(np.int32)], vals, rng.random(n) < 0.986,
            ((-1, 15), (-1, 15)))


def q1_real(n=6_291_456):
    """sa_csv_q1's call from TPC-H SF1 lineitem (seed 0) in its row order:
    the return flag's and line status's dictionary codes, q1's date filter
    as the mask, the quantity, price, discounted price, charge and discount
    as scaled int64 sums and four counts, padded with dead rows to n."""
    import numpy as np
    import pyarrow as pa
    import pyarrow.compute as pc

    from benchmarks.datagen import generate_tables

    li = generate_tables(1.0, seed=0)["lineitem"]
    rows = li.num_rows

    def padded(a, fill=0):
        out = np.full(n, fill, dtype=a.dtype)
        out[:rows] = a
        return out

    def codes(name):
        return pc.dictionary_encode(li[name]).combine_chunks().indices.to_numpy().astype(np.int32)

    def cents(name):
        return np.round(pc.cast(li[name], pa.float64()).to_numpy() * 100).astype(np.int64)

    ship = li["l_shipdate"].combine_chunks().cast(pa.int32()).to_numpy()
    q, p, d, t = cents("l_quantity"), cents("l_extendedprice"), cents("l_discount"), cents("l_tax")
    disc = p * (100 - d)
    vals = [(padded(v), "sum") for v in (q, p, disc, disc * (100 + t), d)]
    vals += [(np.zeros(n, np.int64), "count") for _ in range(4)]
    return ([padded(codes("l_returnflag")), padded(codes("l_linestatus"))], vals,
            padded(ship <= 10471, False), ((-1, 15), (-1, 15)))  # 1998-09-02


def wide(rng, n):
    import numpy as np

    return ([rng.integers(-1, 128, n).astype(np.int32), rng.integers(-1, 256, n).astype(np.int32)],
            [(rng.integers(0, 10**7, n).astype(np.int64), "sum"), (rng.random(n) * 100, "sum"),
             (np.zeros(n, np.int64), "count"), (rng.integers(-10**6, 10**6, n).astype(np.int64),
                                                "min")],
            rng.random(n) < 0.9, ((-1, 127), (-1, 255)))


def _launches(cs, fn, iters=10):
    """Device activities (kernels, copies, memsets) a call queues, by name."""
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


def _time(cs, fn, moved, device):
    ms, source = cs.device_ms(fn)
    per_call, by_name = _launches(cs, fn)
    return {"ms": ms, "ms_source": source, "wall_ms": cs.time_ms(fn, device),
            "bound_ms": moved / cs.HBM_BYTES_PER_S * 1000, "bound_bytes": moved,
            "device_activities_per_call": per_call, "by_name": by_name}


def time_k1(K, cs, dev, rng):
    import numpy as np
    import torch

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    out = {}
    n = 6_291_456
    shapes = {"q1_real": q1_real(n), "q1_like": q1_like(rng, n)}
    shapes.update({f"sweep_{h}": q1_like(rng, n, h) for h in SLOTS})
    shapes["wide"] = wide(rng, 6_000_000)
    for name, (keys, vals, mask, ranges) in shapes.items():
        kc, vc, mk = [t(k) for k in keys], [(t(v), h) for v, h in vals], t(mask)
        domain = K.dense_domain(ranges)
        cap = domain
        rec = {"rows": len(mask), "domain": domain}
        try:
            want = K.grouped_aggregate(kc, vc, mk, cap, key_ranges=ranges, plain=True)
            rec["max_abs_err"] = cs.grouped_err(
                K.grouped_aggregate(kc, vc, mk, cap, key_ranges=ranges), want, vc)
            rec["groups"] = int(want[2].sum())
            rec.update(_time(cs, lambda: K.grouped_aggregate(kc, vc, mk, cap, key_ranges=ranges),
                             cs.dense_bytes(kc, vc, mk, cap), dev))
            if name in ("q1_like", "wide"):
                slots = {"rows": len(mask), "domain": domain,
                         "max_abs_err": cs.dense_check(K, (kc, vc, mk, ranges, domain))}
                slots.update(_time(cs, lambda: K.dense_group_states(kc, vc, mk, ranges, domain),
                                   cs.dense_bytes(kc, vc, mk, domain, compacted=False), dev))
                out[f"{name}_slots"] = slots
            if name == "q1_like":
                # the one library call for the same sums and counts:
                # index_add_ of the stacked values at precomputed slot ids
                seg = ((kc[0].long() + 1) * 17 + kc[1].long() + 1).masked_fill(~mk, domain)
                mat = torch.stack([v if h != "count" else torch.ones_like(v) for v, h in vc], 1)
                lib = lambda: torch.zeros(domain + 1, mat.shape[1], dtype=mat.dtype,  # noqa: E731
                                          device=dev).index_add_(0, seg, mat)
                rec["library_ms"], rec["library_ms_source"] = cs.device_ms(lib)
                rec["library_wall_ms"] = cs.time_ms(lib, dev)
        except (AssertionError, RuntimeError, ValueError, TypeError) as e:
            rec["error"] = f"{type(e).__name__}: {e}"
        out[name] = rec
    return out


def q1_chain(dev, n):
    """K13's arguments for q1's partial aggregate chain (the aggregate and
    the row operators under it down to the scan, as the standalone engine
    fuses them) over n rows of TPC-H lineitem."""
    import torch

    from arrow_ballista_tpu_torch.catalog import MemoryTable, SchemaCatalog
    from arrow_ballista_tpu_torch.compile import fused as F
    from arrow_ballista_tpu_torch.models.batch import concat_batches
    from arrow_ballista_tpu_torch.ops import kernels as K
    from arrow_ballista_tpu_torch.ops import operators as O
    from arrow_ballista_tpu_torch.ops.physical import TaskContext
    from arrow_ballista_tpu_torch.scheduler.physical_planner import PhysicalPlanner
    from arrow_ballista_tpu_torch.sql.optimizer import optimize
    from arrow_ballista_tpu_torch.sql.parser import parse_sql
    from arrow_ballista_tpu_torch.sql.planner import SqlToRel
    from arrow_ballista_tpu_torch.utils.config import BallistaConfig
    from benchmarks.datagen import generate_tables
    from benchmarks.queries import QUERIES
    from tests.torch_cases import plan_nodes

    lineitem = generate_tables(n / 6_000_000 * 1.05, seed=0)["lineitem"].slice(0, n)
    cat = SchemaCatalog()
    cat.register(MemoryTable("lineitem", lineitem))
    plan = PhysicalPlanner(cat, BallistaConfig({"ballista.shuffle.partitions": "4"}),
                           dev).plan_query(
        optimize(SqlToRel(cat).plan(parse_sql(QUERIES[1])))).plan
    ops = [next(p for p in plan_nodes(plan)
                if isinstance(p, O.HashAggregateExec) and p.mode == "partial")]
    while isinstance(ops[-1].input, (O.RenameExec, O.ProjectionExec, O.FilterExec)) \
            and not getattr(ops[-1].input, "host_mode", False):
        ops.append(ops[-1].input)
    ctx = TaskContext(device=dev)
    scan = ops[-1].input
    big = concat_batches(scan.schema, [b for p in range(scan.output_partition_count())
                                       for b in scan.execute(p, ctx)], device=dev).shrink()
    prog = F.FusedStageExec(ops).program(ctx)
    auxs, dicts = prog.auxs_and_dicts(big.dicts)
    ranges = ops[0]._key_ranges(prog.agg_compiled[1], dicts)
    domain = K.dense_domain(ranges)
    return prog, big.columns, big.mask, auxs, min(big.capacity, domain), ranges


def time_k13(K, cs, dev, n=1 << 20):
    from arrow_ballista_tpu_torch.compile import fused as F

    out = {}
    chains = {"k13_q1": q1_chain(dev, n)}
    chains.update({f"k13_sweep_{h}": cs.dense_sweep_chain(dev, n, h) for h in K13_SLOTS})
    for name, args in chains.items():
        prog, cols, mask, auxs, cap, ranges = args
        rec = {"rows": int(mask.shape[0]), "domain": K.dense_domain(ranges), "out_cap": cap,
               "source_digest": prog.gen.digest}
        try:
            rec["max_abs_err"] = cs.fused_check(F, "fused_agg", args)
            moved = cs.fused_bytes(prog, cols, mask, cap)
            nxt = cs.rotating(args, moved)
            rec.update(_time(cs, lambda: F.fused_agg(*nxt()), moved, dev))
            if name == "k13_q1":

                def interpreted():
                    a = nxt()
                    keys, vals, m = F._agg_key_vals_plain(a[0], a[1], a[2], a[3])
                    return K.grouped_aggregate(keys, vals, m, a[4], key_ranges=a[5])
                rec["interpreted"] = _time(cs, interpreted, moved, dev)
        except (AssertionError, RuntimeError, ValueError, TypeError) as e:
            rec["error"] = f"{type(e).__name__}: {e}"
        out[name] = rec
    return out


def ptxas(out_path, prog):
    """nvcc -Xptxas -v of csrc/dense_agg.cu and of ``prog``'s generated source."""
    from arrow_ballista_tpu_torch.ops import _cuda

    src = os.path.join(os.path.dirname(out_path) or ".", "dense_timing_gen.cu")
    with open(src, "w") as f:
        f.write(prog.gen.source)
    text = []
    for path, flags in ((str(_cuda.CSRC / "dense_agg.cu"), _cuda.NVCC_FLAGS),
                        (src, _cuda.GENERATED_FLAGS)):
        flags = [f for f in flags if f not in ("-shared", "-Xcompiler", "-fPIC")]
        res = subprocess.run([_cuda.nvcc_path(), *flags, "-Xptxas", "-v", "-c", path, "-o",
                              os.devnull], capture_output=True, text=True)
        text.append(f"== {path} (exit {res.returncode})\n{res.stdout}{res.stderr}")
    with open(out_path, "w") as f:
        f.write("\n".join(text))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ptxas", default=None)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    sys.path.insert(1, HERE)  # benchmarks/ and tests/ of this tree
    import numpy as np
    import torch

    from arrow_ballista_tpu_torch.ops import _cuda
    from arrow_ballista_tpu_torch.ops import kernels as K

    # this tree's chip_smoke (its bounds and timers), whatever --root is
    cs = _load("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA card")
    dev = torch.device("cuda")
    _cuda.LIBRARIES.build_all()
    rng = np.random.default_rng(args.seed)
    out = {"root": os.path.abspath(args.root), "device": torch.cuda.get_device_name(0),
           "power_limit": cs.smi("power.limit")}
    out["k1"] = time_k1(K, cs, dev, rng)
    out["k13"] = time_k13(K, cs, dev)
    out["generated_builds"] = len(_cuda.LIBRARIES.generated_builds)
    if args.ptxas:
        ptxas(args.ptxas, q1_chain(dev, 1 << 16)[0])
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
