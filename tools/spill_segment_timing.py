"""K16 (the spilled join's build split) and K7 (the join verdicts) of a
checkout of the PyTorch/CUDA port on one card, at the main path's shapes,
so that two commits can be compared in one call.

    python3 tools/spill_segment_timing.py [--root DIR] [--seed 0] [--calls FILE]
        [--ptxas OUT]

``--root`` is the checkout whose ``arrow_ballista_tpu_torch`` is imported
(this tree, or a parent commit unpacked with ``git archive``); inputs are
made from ``--seed`` with numpy.  Each shape goes through what the tree's
callers launch:

- K16: a tree with ``kernels.spill_order`` (one partition-grouped
  compaction) times it; every tree also times ``spill_partition`` followed
  by the pack's ``compaction_order`` over the same mask (the split before
  ``spill_order``: two calls, K16 then K2).  Shapes: ``q21_like``, the
  524,288-row build batch of spill_q21 (TPC-H lineitem's l_orderkey at
  SF0.25 in row order, q21's l_receiptdate > l_commitdate as the mask), and
  ``rows_<n>``, random int64 keys with a 0.6 live mask at 131,072 (the
  local engine's batch, one launch), 524,288 and 2,097,152 rows; eight
  partitions.
- K7: a semi and an anti verdict with the probe mask: in a tree whose
  ``segment_any`` takes ``within`` the one folded call, else
  ``segment_any`` then K22's ``mask_and`` / ``mask_andnot``; beside them
  the tree's ``segment_any`` with no mask (the hit alone).  Shapes: ``memsweep_like``,
  2,097,152 pairs in K6's layout over 1,048,576 probe rows (the memory
  sweep's 2^20-row batches: probe-major runs of 0-4 pairs, 40% of the slots
  K6's fill past the total, 30% of the pairs true), and ``pairs_<n>`` in
  the same layout at 131,072, 524,288 and 2,097,152 pairs over n / 2 probe
  rows.

``--calls FILE`` adds the ``captured`` shape of each: the largest K16 and
K7 calls over ``chip_smoke.py``'s paths, as ``python3 chip_smoke.py
--save-calls FILE`` writes them (K7's with its mask and negation; a tree
without the fold runs ``segment_any`` and then K22 on them).

Device ms a call from torch.profiler, or from CUDA events around calls
queued behind a spin kernel (``chip_smoke.device_ms``: every kernel, copy
and memset the call queues); device activities a call from the same
profile; wall ms from CUDA events around back-to-back calls; inputs rotate
past the 50 MB L2 (``chip_smoke.rotating``).  Bounds: bytes over 3.35 TB/s
(K16: the keys and mask read, the partitions and the live part of the
order written; K7: the values, the id of each true value and the probe
mask read, the verdicts written).  Every result is held against its twin
(exact).  ``--ptxas OUT`` writes ``nvcc -Xptxas -v`` of csrc/compact.cu and
csrc/segment.cu.  Prints one JSON line.  Needs a card.
"""
from __future__ import annotations

import argparse
import importlib.util
import inspect
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARTS = 8
K16_ROWS = (131_072, 524_288, 2_097_152)
K7_PAIRS = (131_072, 524_288, 2_097_152)


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = sys.modules[name] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def q21_like(n=524_288):
    """spill_q21's build batch: SF0.25 lineitem's l_orderkey in row order,
    q21's l_receiptdate > l_commitdate as the live mask."""
    import numpy as np

    from benchmarks.datagen import generate_tables

    li = generate_tables(0.25, seed=0)["lineitem"].slice(0, n)
    keys = li["l_orderkey"].to_numpy().astype(np.int64)
    mask = (li["l_receiptdate"].combine_chunks().cast("int32").to_numpy()
            > li["l_commitdate"].combine_chunks().cast("int32").to_numpy())
    return [keys], mask


def k6_pairs(rng, n, n_probe, fill=0.4):
    """K6's pair layout: (values, probe index, probe mask) for n slots over
    n_probe probe rows, probe-major runs of 0-4 pairs, the slots past the
    total on probe row n_probe - 1 and false."""
    import numpy as np

    total = int(n * (1 - fill))
    counts = rng.integers(0, 5, n_probe)
    pi = np.repeat(np.arange(n_probe, dtype=np.int32), counts)[:total]
    pi = np.concatenate([pi, np.full(n - len(pi), n_probe - 1, np.int32)])
    values = rng.random(n) < 0.3
    values[total:] = False
    return values, pi, rng.random(n_probe) < 0.8


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


def _same(a, b):
    import torch

    if not torch.equal(a.cpu(), b.cpu()):
        raise AssertionError("differs from the twin")


def time_k16(K, cs, dev, rng, calls):
    import numpy as np
    import torch

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    shapes = {}
    if "spill_order" in calls:
        keys, mask, _parts = calls["spill_order"]["args"]
        shapes["captured"] = ([k.numpy() for k in keys], mask.numpy())
    shapes["q21_like"] = q21_like()
    for n in K16_ROWS:
        shapes[f"rows_{n}"] = ([rng.integers(-2**40, 2**40, n).astype(np.int64)],
                               rng.random(n) < 0.6)
    out = {}
    for name, (keys, mask) in shapes.items():
        kd, md = [t(k) for k in keys], t(mask)
        n, live = len(mask), int(mask.sum())
        rec = {"rows": n, "live": live}
        moved = sum(k.nbytes for k in keys) + n + 4 * n + 4 * live
        args = (kd, md)
        nxt = cs.rotating(args, moved)
        try:
            want = K.spill_partition_plain([k.cpu() for k in kd], PARTS)
            _same(K.spill_partition(kd, PARTS), want)
            _same(K.compaction_order(md), K.compaction_order_plain(md.cpu()))

            def pair():
                k, m = nxt()
                return K.spill_partition(k, PARTS), K.compaction_order(m, with_count=True)
            rec["partition_then_k2"] = _time(cs, pair, moved, dev)
            if hasattr(K, "spill_order"):
                got = K.spill_order(kd, md, PARTS)
                plain = K.spill_order_plain([k.cpu() for k in kd], md.cpu(), PARTS)
                for g, w in zip(got, plain):
                    _same(g, w)
                rec["spill_order"] = _time(cs, lambda: K.spill_order(*nxt(), PARTS), moved, dev)
                rec["spill_order"]["plan"] = K.kernel_plan("spill_order")
        except (AssertionError, RuntimeError, ValueError, TypeError) as e:
            rec["error"] = f"{type(e).__name__}: {e}"
        out[name] = rec
    return out


def _k7_verdict(K, cs, dev, rec, label, shape, negate, folds):
    """One verdict (semi: negate False, anti: True) of a shape, as the tree
    computes it, held against the twin and timed."""
    vd, sd, md, ns = shape
    true = int((vd > 0).sum())
    moved = vd.numel() * vd.element_size() + 4 * true + 2 * ns
    nxt = cs.rotating((vd, sd, md), moved)
    hit = K.segment_any_plain(vd.cpu(), sd.cpu(), ns)
    want = md.cpu() & (~hit if negate else hit)
    if folds:
        _same(K.segment_any(vd, sd, ns, within=md, negate=negate), want)

        def fold():
            v, s, m = nxt()
            return K.segment_any(v, s, ns, within=m, negate=negate)
        rec[label] = _time(cs, fold, moved, dev)
    else:
        glue = K.mask_andnot if negate else K.mask_and
        _same(glue(md, K.segment_any(vd, sd, ns)), want)

        def unfolded():
            v, s, m = nxt()
            return glue(m, K.segment_any(v, s, ns))
        rec[label] = _time(cs, unfolded, moved, dev)


def time_k7(K, cs, dev, rng, calls):
    import numpy as np
    import torch

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    folds = "within" in inspect.signature(K.segment_any).parameters
    shapes = {}
    if "segment_any" in calls:
        a = calls["segment_any"]["args"]
        within = a[3] if len(a) > 3 and a[3] is not None else torch.ones(a[2], dtype=torch.bool)
        shapes["captured"] = (a[0].numpy(), a[1].numpy(), within.numpy(),
                              bool(a[4]) if len(a) > 4 else False)
    v, pi, pm = k6_pairs(rng, 2_097_152, 1_048_576)
    shapes["memsweep_like"] = (v, pi, pm, None)
    for n in K7_PAIRS:
        shapes[f"pairs_{n}"] = (*k6_pairs(rng, n, n // 2), None)
    out = {}
    for name, (values, pi, pmask, negate) in shapes.items():
        vd, sd, md = t(values), t(pi), t(pmask)
        ns = len(pmask)
        rec = {"pairs": len(values), "segments": ns, "true": int((values > 0).sum())}
        try:
            for label, neg in (("semi", False), ("anti", True)):
                if negate is None or neg == negate:
                    _k7_verdict(K, cs, dev, rec, label, (vd, sd, md, ns), neg, folds)
            # the hit alone, as each tree computes it for a caller with no mask
            hit = K.segment_any_plain(vd.cpu(), sd.cpu(), ns)
            hit_moved = values.nbytes + 4 * rec["true"] + ns
            _same(K.segment_any(vd, sd, ns), hit)
            nxt = cs.rotating((vd, sd), hit_moved)
            rec["hit"] = _time(cs, lambda: K.segment_any(*nxt(), ns), hit_moved, dev)
        except (AssertionError, RuntimeError, ValueError, TypeError) as e:
            rec["error"] = f"{type(e).__name__}: {e}"
        out[name] = rec
    return out


def ptxas(out_path):
    """nvcc -Xptxas -v of csrc/compact.cu and csrc/segment.cu."""
    from arrow_ballista_tpu_torch.ops import _cuda

    text = []
    for name in ("compact", "segment"):
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
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--calls", default=None)
    ap.add_argument("--ptxas", default=None)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    sys.path.insert(1, HERE)  # benchmarks/ of this tree
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
    calls = torch.load(args.calls) if args.calls else {}
    out["captured_on"] = {k: (v["path"], v["rows"]) for k, v in calls.items()}
    out["k16"] = time_k16(K, cs, dev, rng, calls)
    out["k7"] = time_k7(K, cs, dev, rng, calls)
    if args.ptxas:
        ptxas(args.ptxas)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
