"""K8 (``grouped_on_order``) and K22 (its bucket form and its four binary
mask ops) of a checkout of the PyTorch/CUDA port at synthetic shapes on one
card, beside their yardsticks, so that two commits can be compared in one
call.

    python3 tools/seg_bucket_timing.py [--root DIR] [--seed 0]

``--root`` is the checkout whose ``arrow_ballista_tpu_torch`` is imported
(this tree, or a parent commit unpacked with ``git archive``); inputs are
made from ``--seed`` with numpy.  K8 shapes: ``mesh4_q18_like`` (3,014,660
rows, one int64 key in groups of about two rows, an int64 sum and a count,
2^21 slots: the shape of the main path's largest call; and
``mesh4_q18_in_order``, the same with the columns in group order, as
lineitem's l_orderkey order leaves them), ``sa_q18_like_1m``
(2^20 rows, groups of about four), ``q3_like_4096`` (4,096 rows, q3's three
keys; timed five times over, as one call of a q3 query), ``few_groups_6m``
(64 groups over 6,000,000 rows: segments across many tiles) and
``global_6m`` (no keys: one group over 6,000,000 rows).  The columns lie
in a random row order but for ``mesh4_q18_in_order``; a checkout whose
K8 reads through an order (``grouped_on_order(..., order)``) is timed on
them as they lie
(``k8_ms``); an older one, whose K8 takes its columns in group order, is
timed on the gathered columns (``k8_ms``) beside the gathers its caller
ran first (``gathers_ms``: each key and value column and the mask through
the order).  ``k8_fresh_out_ms`` holds every result, so that each timed
call writes new output addresses rather than lines the last call left in
L2.  K22's bucket form at 131,072 rows (the local engine's batch)
and 2^20 rows into 16 partitions and at 131,072 into 64: one launch a
batch (``bucket_masks``) where the checkout has it, else a launch a
partition (``bucket_mask``), beside
``(bucket[None] == arange(Q)[:, None]) & mask`` (a composite, not one
call).  K22's window, or, and and and-not at 131,072 and 1,048,576 rows
beside ``a | b``, ``a & b`` and ``a > b`` (and-not on bools), with an empty
kernel's launch (``torch.cuda._sleep(0)``) as the floor.  Device ms a call
from torch.profiler (``chip_smoke.device_ms``) over inputs that rotate past
the 50 MB L2, wall ms from CUDA events around back-to-back calls
(``chip_smoke.time_ms``), kernels and yardsticks alike; bounds from the bytes
each function must move (``chip_smoke.grouped_on_order_bytes``,
``bucket_masks_bytes``); every kernel result is held against its twin.
Prints one JSON line.  Needs a card.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = sys.modules[name] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def k8_shapes(rng):
    """name -> (keys, vals, mask, cap, shuffled) in group order, numpy;
    ``shuffled``: the columns are timed in a random row order, else in
    group order (the identity order)."""
    import numpy as np

    def grouped(n, width):
        return np.sort(rng.integers(0, max(1, n // width), n)).astype(np.int64)

    out = {}
    n = 3_014_660
    out["mesh4_q18_like"] = ([grouped(n, 2)], [(rng.integers(1, 51, n).astype(np.int64), "sum"),
                                               (np.zeros(n, np.int64), "count")],
                             rng.random(n) < 0.99, 1 << 21, True)
    # lineitem arrives in l_orderkey order, so the sort order of the main
    # path's largest call is close to the identity
    out["mesh4_q18_in_order"] = out["mesh4_q18_like"][:4] + (False,)
    n = 1 << 20
    out["sa_q18_like_1m"] = ([grouped(n, 4)], [(rng.integers(1, 51, n).astype(np.int64), "sum")],
                             rng.random(n) < 0.95, n, True)
    n = 4096
    ok = grouped(n, 4)
    out["q3_like_4096"] = ([ok, (9000 + ok % 700).astype(np.int32), np.zeros(n, np.int32)],
                           [(rng.integers(0, 10**9, n).astype(np.int64), "sum")],
                           rng.random(n) < 0.9, n, True)
    n = 6_000_000
    out["few_groups_6m"] = ([np.sort(rng.integers(0, 64, n)).astype(np.int64)],
                            [(rng.integers(2**61, 2**62, n).astype(np.int64), "sum"),
                             (np.zeros(n, np.int64), "count")], rng.random(n) < 0.9, n, True)
    out["global_6m"] = ([], [(rng.integers(-10**12, 10**12, n).astype(np.int64), "sum"),
                             (np.zeros(n, np.int64), "count"), (rng.normal(size=n), "max")],
                        rng.random(n) < 0.9, 1, True)
    return out


def _same_groups(got, want):
    import torch

    return torch.equal(got[2], want[2]) and all(
        torch.equal(g, w) for g, w in zip([*got[0], *got[1]], [*want[0], *want[1]]))


def by_kernel(cs, fn, iters=20):
    """Device ms a call of each kernel, copy and memset ``fn`` launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return {key.split("(")[0][:60]: round(ms / iters, 6) for ms, _c, key in cs.device_rows(prof)}


def time_k8(K, cs, dev, rng, has_order):
    import numpy as np
    import torch

    out = {}
    for name, (keys, vals, mask, cap, shuffled) in k8_shapes(rng).items():
        n = len(mask)

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        order = t((rng.permutation(n) if shuffled else np.arange(n)).astype(np.int32))
        inv = cs.torch_argsort(order)
        through = ([t(k)[inv] for k in keys], [(t(v)[inv], h) for v, h in vals], t(mask)[inv],
                   cap, n, order)
        floats = any(v.dtype.kind == "f" and h == "sum" for v, h in vals)
        moved = cs.grouped_on_order_bytes(*through)
        nxt = cs.rotating(through, moved)
        reps = 5 if n <= 4096 else 1
        rec = {"rows": n, "groups_cap": cap, "bound_ms": moved / cs.HBM_BYTES_PER_S * 1000}
        args = through
        if not has_order:  # the columns gathered first, as the caller of this K8 did

            def gathers():
                ks, vs, m, _c, _n, o = nxt()
                i = o.long()
                return [k[i] for k in ks], [v[i] for v, _h in vs], m[i]

            rec["gathers_ms"] = cs.device_ms(gathers)[0]
            idx = order.long()
            args = ([k[idx] for k in through[0]], [(v[idx], h) for v, h in through[1]],
                    through[2][idx], cap, n)
            nxt = cs.rotating(args, moved)
        if not floats and not _same_groups(K.grouped_on_order(*args),
                                           K.grouped_on_order_plain(*args)):
            sys.exit(f"grouped_on_order differs from its twin at {name}")
        call = K.grouped_on_order
        kept = []  # results held, so that every timed call writes new addresses

        def fresh_out():
            kept.append(call(*nxt()))

        rec.update({"k8_ms": [cs.device_ms(lambda: call(*nxt()))[0] for _ in range(reps)],
                    "k8_fresh_out_ms": cs.device_ms(fresh_out)[0],
                    "k8_wall_ms": cs.time_ms(lambda: call(*nxt()), dev),
                    "k8_by_kernel": by_kernel(cs, lambda: call(*nxt()))})
        kept.clear()
        out[name] = rec
    return out


def time_k22(K, cs, dev, rng):
    import numpy as np
    import torch

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    out = {"floor": {"empty_launch_ms": cs.device_ms(lambda: torch.cuda._sleep(0))[0],
                     "empty_launch_wall_ms": cs.time_ms(lambda: torch.cuda._sleep(0), dev)}}
    for n, num_out in ((1 << 17, 16), (1 << 20, 16), (1 << 17, 64)):
        mask = t(rng.random(n) < 0.7)
        bucket = t(rng.integers(0, num_out, n).astype(np.int32))
        moved = cs.bucket_masks_bytes(mask, num_out)
        nxt = cs.rotating((mask, bucket, num_out), moved)
        parts = torch.arange(num_out, dtype=torch.int32, device=dev)[:, None]

        def composite():
            m, b, _q = nxt()
            return (b[None] == parts) & m

        rec = {"bound_ms": moved / cs.HBM_BYTES_PER_S * 1000,
               "composite_ms": cs.device_ms(composite)[0],
               "composite_wall_ms": cs.time_ms(composite, dev)}
        if hasattr(K, "bucket_masks"):
            want = K.bucket_masks_plain(mask, bucket, num_out)
            if not torch.equal(K.bucket_masks(mask, bucket, num_out), want):
                sys.exit(f"bucket_masks differs from its twin at {n} x {num_out}")
            rec["one_launch_ms"] = cs.device_ms(lambda: K.bucket_masks(*nxt()))[0]
            rec["one_launch_wall_ms"] = cs.time_ms(lambda: K.bucket_masks(*nxt()), dev)
        if hasattr(K, "bucket_mask"):  # the parent: a launch a partition

            def per_partition():
                m, b, q = nxt()
                return [K.bucket_mask(m, b, p) for p in range(q)]

            rec["per_partition_ms"] = cs.device_ms(per_partition)[0]
            rec["per_partition_wall_ms"] = cs.time_ms(per_partition, dev)
        out[f"bucket_{n}x{num_out}"] = rec
    for n in (1 << 17, 1 << 20):
        a, b = t(rng.random(n) < 0.5), t(rng.random(n) < 0.5)
        for op, kern, lib in (("window", lambda x, y: K.window_mask(x, n // 5, n // 2), None),
                              ("or", K.mask_or, torch.bitwise_or),
                              ("and", K.mask_and, torch.bitwise_and),
                              ("andnot", K.mask_andnot, torch.gt)):
            moved = (2 if op == "window" else 3) * n
            nxt = cs.rotating((a, b), moved)
            plain = {"window": lambda x, y: K.window_mask_plain(x, n // 5, n // 2),
                     "or": K.mask_or_plain, "and": K.mask_and_plain,
                     "andnot": K.mask_andnot_plain}[op]
            if not torch.equal(kern(a, b), plain(a, b)):
                sys.exit(f"mask op {op} differs from its twin at {n}")
            rec = {"ms": cs.device_ms(lambda: kern(*nxt()))[0],
                   "wall_ms": cs.time_ms(lambda: kern(*nxt()), dev),
                   "bound_ms": moved / cs.HBM_BYTES_PER_S * 1000}
            if lib is not None:
                rec["library_ms"] = cs.device_ms(lambda: lib(*nxt()))[0]
                rec["library_wall_ms"] = cs.time_ms(lambda: lib(*nxt()), dev)
            out[f"{op}_{n}"] = rec
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import inspect

    import numpy as np
    import torch

    from arrow_ballista_tpu_torch.ops import kernels as K

    # this tree's chip_smoke (its bounds and timers), whatever --root is
    cs = _load("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA card")
    dev = torch.device("cuda")
    rng = np.random.default_rng(args.seed)
    out = {"root": os.path.abspath(args.root), "device": torch.cuda.get_device_name(0)}
    has_order = "order" in inspect.signature(K.grouped_on_order).parameters
    out["k8"] = time_k8(K, cs, dev, rng, has_order)
    out["k22"] = time_k22(K, cs, dev, rng)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
