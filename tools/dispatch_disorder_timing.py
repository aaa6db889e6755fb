"""K17 (the mesh exchange's send buffers) and K9 (the presorted grouping's
disorder flag) of a checkout of the PyTorch/CUDA port on one card, at the
main path's shapes, so that two commits can be compared in one call.

    python3 tools/dispatch_disorder_timing.py [--root DIR] [--seed 0]
        [--calls FILE] [--ptxas OUT]

``--root`` is the checkout whose ``arrow_ballista_tpu_torch`` is imported
(this tree, or a parent commit unpacked with ``git archive``); inputs are
made from ``--seed`` with numpy.  Each shape goes through what the tree's
callers launch:

- K17 ``dispatch_to_buckets``: ``mesh4_q18_like``, the shape of the
  largest dispatch of the mesh4_q18 path at SF1 (1,507,329 rows, 376,881
  of them live, two int64 columns over 4 destinations, 753,665 slots a
  destination: the mesh's skew factor 2) and ``mesh4_q3_like``, that of
  mesh4_q3's (2^20 live rows, four int64 columns and an int32 one, 2^21
  slots a destination); ``rows_<n>``, every row live, an int64 and an
  int32 column at 2^18, 2^20 and 2^22 rows; ``dest8`` and ``dest64`` at
  2^20 rows over 8 and 64 destinations; ``wide``, 40 int64 columns at
  2^18 rows (two column groups).
- K9 ``presorted_disorder``: ``sa_pq_q18_like``, sa_pq_q18's 1,048,576-row
  call (sorted int64 keys, every row live), ``half_dead`` (a random half of
  the rows dead), ``dead_tail`` (the last three quarters dead, as a padded
  partial), ``rows_8388608`` (sorted, every row live).  A tree whose
  presorted grouping gathers the rows into K2's compaction order for K9
  (the parent) times K9 on the gathered rows and, as ``with_glue``, the
  cast, the two gathers and K9 that its caller queues for the flag (the
  order is K2's, which K8 needs anyway, and is made once outside the timed
  calls); a tree whose K9 reads the rows as they are times K9 alone for
  both.  Beside it, K10 (``key_range_check``, the same lane layout and
  bytes) on the same rows.

``--calls FILE`` adds the ``captured`` shape of each: the largest calls
over ``chip_smoke.py``'s paths, as ``python3 chip_smoke.py --save-calls
FILE`` writes them (K17 at mesh4_q3, mesh4_q3_part and mesh4_q18; K9 at
its largest call).

Device ms a call from torch.profiler, or from CUDA events around calls
queued behind a spin kernel (``chip_smoke.device_ms``: every kernel, copy
and memset the call queues); device activities a call from the same
profile; wall ms from CUDA events around back-to-back calls; inputs rotate
past the 50 MB L2 (``chip_smoke.rotating``).  Bounds: bytes over 3.35 TB/s
(K17: dest and mask read once, each column's live rows once, every slot of
every buffer and of the send mask written once, the counts; K9: the mask
and the live rows' keys read, the flag written).  Every result is held
against its twin (exact).  ``--ptxas OUT`` writes ``nvcc -Xptxas -v`` of
csrc/dispatch.cu and csrc/clustered.cu.  Prints one JSON line.  Needs a
card.
"""
from __future__ import annotations

import argparse
import importlib.util
import inspect
import json
import math
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
Q18_ROWS, Q18_LIVE, Q18_CAP = 1_507_329, 376_881, 753_665
K17_ROWS = (1 << 18, 1 << 20, 1 << 22)
K9_ROWS = 1 << 20


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = sys.modules[name] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _launches(cs, fn, iters=10):
    """Device activities (kernels, copies, memsets) a call queues: their
    number, and by name how many and their device ms a call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    rows = [(ms, c, key.split("(")[0][:60]) for ms, c, key in cs.device_rows(prof)]
    return sum(c for _ms, c, _k in rows) / iters, {k: [c / iters, ms / iters]
                                                   for ms, c, k in rows}


def _time(cs, fn, moved, device):
    ms, source = cs.device_ms(fn)
    per_call, by_name = _launches(cs, fn)
    return {"ms": ms, "ms_source": source, "wall_ms": cs.time_ms(fn, device),
            "bound_ms": moved / cs.HBM_BYTES_PER_S * 1000, "bound_bytes": moved,
            "device_activities_per_call": per_call, "by_name": by_name}


def _same(got, want):
    """Every buffer slot, the mask, the counts and the flag, exact."""
    import torch

    for k, w in want[0].items():
        if not torch.equal(got[0][k].cpu(), w.cpu()):
            raise AssertionError(f"column {k} differs from the twin")
    if not (torch.equal(got[1].cpu(), want[1].cpu()) and torch.equal(got[3].cpu(), want[3].cpu())
            and bool(got[2]) == bool(want[2])):
        raise AssertionError("mask, counts or flag differ from the twin")


def k17_shapes(rng, calls):
    import numpy as np

    def columns(n, live_share=1.0, n_dest=4, cap=None, wide=0, int64s=1, int32s=1):
        cols = {f"w{i}": rng.integers(-2**62, 2**62, n) for i in range(wide or int64s)}
        cols.update({f"h{i}": rng.integers(0, 50, n).astype(np.int32)
                     for i in range(0 if wide else int32s)})
        dest = rng.integers(0, n_dest, n).astype(np.int32)
        mask = np.zeros(n, dtype=bool)
        mask[rng.choice(n, int(round(n * live_share)), replace=False)] = True
        cap = cap or 2 * math.ceil(n / n_dest)
        return cols, dest, mask, n_dest, cap

    shapes = {}
    for path, (cols, dest, mask, n_dest, cap) in calls.get("dispatch_by_path", {}).items():
        shapes[f"captured_{path}"] = ({k: v.numpy() for k, v in cols.items()}, dest.numpy(),
                                      mask.numpy(), n_dest, cap)
    shapes["mesh4_q18_like"] = columns(Q18_ROWS, Q18_LIVE / Q18_ROWS, cap=Q18_CAP, int64s=2,
                                       int32s=0)
    shapes["mesh4_q3_like"] = columns(1 << 20, cap=1 << 21, int64s=4, int32s=1)
    for n in K17_ROWS:
        shapes[f"rows_{n}"] = columns(n)
    shapes["dest8"] = columns(1 << 20, 0.9, 8)
    shapes["dest64"] = columns(1 << 20, 0.9, 64)
    shapes["wide"] = columns(1 << 18, 0.9, wide=40)
    return shapes


def time_k17(K, cs, dev, rng, calls):
    import torch

    out = {}
    for name, (cols, dest, mask, n_dest, cap) in k17_shapes(rng, calls).items():
        cd = {k: torch.from_numpy(v).to(dev) for k, v in cols.items()}
        dd, md = torch.from_numpy(dest).to(dev), torch.from_numpy(mask).to(dev)
        n, live = len(mask), int(mask.sum())
        width = sum(v.element_size() for v in cd.values())
        moved = 5 * n + live * width + n_dest * cap * (width + 1) + 4 * n_dest + 1
        rec = {"rows": n, "live": live, "destinations": n_dest, "capacity": cap,
               "columns": len(cols)}
        args = (cd, dd, md, n_dest, cap)
        try:
            _same(K.dispatch_to_buckets(*args),
                  K.dispatch_to_buckets_plain({k: v.cpu() for k, v in cd.items()}, dd.cpu(),
                                              md.cpu(), n_dest, cap))
            nxt = cs.rotating(args, moved)
            rec["kernel"] = _time(cs, lambda: K.dispatch_to_buckets(*nxt()), moved, dev)
            if hasattr(K, "kernel_plan"):
                rec["kernel"]["plan"] = K.kernel_plan("dispatch_to_buckets")
        except (AssertionError, RuntimeError, ValueError, TypeError) as e:
            rec["error"] = f"{type(e).__name__}: {e}"
        out[name] = rec
    return out


def k9_shapes(rng, calls):
    import numpy as np

    n = K9_ROWS
    keys = np.sort(rng.integers(0, n // 4, n)).astype(np.int64)
    shapes = {}
    if "presorted_disorder" in calls:
        k, m = calls["presorted_disorder"]["args"]
        shapes["captured"] = (k.numpy(), m.numpy())
    shapes["sa_pq_q18_like"] = (keys, np.ones(n, dtype=bool))
    shapes["half_dead"] = (keys, rng.random(n) < 0.5)
    tail = np.ones(n, dtype=bool)
    tail[n // 4:] = False
    shapes["dead_tail"] = (keys, tail)
    big = 1 << 23
    shapes[f"rows_{big}"] = (np.sort(rng.integers(0, big // 4, big)).astype(np.int64),
                             np.ones(big, dtype=bool))
    return shapes


def time_k9(K, cs, dev, rng, calls):
    """In a tree whose caller gathers for K9 (``grouped_aggregate_presorted``
    casts K2's order and gathers the mask and the keys), K9 on the gathered
    rows and the glue beside it; else K9 on the rows as they are."""
    import torch

    gathers = "mask[idx]" in inspect.getsource(K.grouped_aggregate_presorted)
    out = {"caller_gathers": gathers}
    for name, (keys, mask) in k9_shapes(rng, calls).items():
        kd, md = torch.from_numpy(keys).to(dev), torch.from_numpy(mask).to(dev)
        n, live = len(mask), int(mask.sum())
        moved = n + live * kd.element_size() + 1
        rec = {"rows": n, "live": live}
        live_keys = torch.from_numpy(keys[mask])
        want = bool((live_keys[1:] < live_keys[:-1]).any()) if live > 1 else False
        try:
            if gathers:
                order = K.compaction_order(md)

                def glue(k_, m_, o_):
                    idx = o_.long()
                    return K.presorted_disorder(k_[idx], m_[idx])
                if bool(glue(kd, md, order)) != want:
                    raise AssertionError("the flag differs from the definition")
                idx = order.long()
                ks, ms = kd[idx], md[idx]
                nxt = cs.rotating((ks, ms), moved)
                rec["kernel"] = _time(cs, lambda: K.presorted_disorder(*nxt()), moved, dev)
                gl = cs.rotating((kd, md, order), moved + 4 * n)
                rec["with_glue"] = _time(cs, lambda: glue(*gl()), moved, dev)
            else:
                if bool(K.presorted_disorder(kd, md)) != want:
                    raise AssertionError("the flag differs from the definition")
                nxt = cs.rotating((kd, md), moved)
                rec["kernel"] = _time(cs, lambda: K.presorted_disorder(*nxt()), moved, dev)
                rec["with_glue"] = rec["kernel"]
            # K10 on the same rows and bytes (its lane layout, one flag): K9's yardstick
            rows = cs.rotating((kd, md), moved)
            lo, hi = int(keys.min()), int(keys.max())
            rec["k10_same_rows"] = _time(cs, lambda: K.key_range_check(*rows(), lo, hi), moved,
                                         dev)
        except (AssertionError, RuntimeError, ValueError, TypeError) as e:
            rec["error"] = f"{type(e).__name__}: {e}"
        out[name] = rec
    return out


def ptxas(out_path):
    """nvcc -Xptxas -v of csrc/dispatch.cu and csrc/clustered.cu."""
    from arrow_ballista_tpu_torch.ops import _cuda

    text = []
    for name in ("dispatch", "clustered"):
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
    import numpy as np
    import torch

    from arrow_ballista_tpu_torch.ops import kernels as K

    # this tree's chip_smoke (its bounds and timers), whatever --root is
    cs = _load("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA card")
    dev = torch.device("cuda")
    out = {"root": os.path.abspath(args.root), "device": torch.cuda.get_device_name(0),
           "power_limit": cs.smi("power.limit")}
    calls = torch.load(args.calls) if args.calls else {}
    out["captured_on"] = {k: (v["path"], v["rows"]) for k, v in calls.items()
                          if isinstance(v, dict) and "path" in v}
    out["k17"] = time_k17(K, cs, dev, np.random.default_rng(args.seed), calls)
    out["k9"] = time_k9(K, cs, dev, np.random.default_rng(args.seed + 1), calls)
    if args.ptxas:
        ptxas(args.ptxas)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
