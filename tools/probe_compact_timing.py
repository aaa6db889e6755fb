"""K6 (``probe_join``) and K2 (``compaction_order``) of a checkout of the
PyTorch/CUDA port at synthetic shapes on one card, beside the PyTorch
yardsticks that ``chip_smoke.py`` times them against (K6: a composite, not
one call: searchsorted x2 + cumsum + repeat_interleave; K2: ``argsort(~mask,
stable=True)``), so that two commits can be compared in one call.

    python3 tools/probe_compact_timing.py [--root DIR] [--seed 0]

``--root`` is the checkout whose ``arrow_ballista_tpu_torch`` is imported
(this tree, or a parent commit unpacked with ``git archive``; both wrappers
keep their signatures across the redesign).  Every input is made from
``--seed`` with numpy; build hashes are sorted as uint64 with the dead rows'
all-ones at the tail, as K5 leaves them.  K6 shapes: ``selective_8m`` (the
shares of the main path's largest call, mesh4_q3's, which ``chip_smoke.py``
captures: 8,388,608 probe rows of which 0.46% live, a fifth of those
matching about one build row, against an 8,388,608-row build 9.2% live,
cap 131,072), ``one_to_one_1m`` (every probe row live and matching one
build row of 1,048,576), ``fanout_3_1m`` (about three build rows a key),
``build_in_l2`` (8,388,608 probe rows, half live, against a 1,048,576-row,
8 MB build), ``q3_like_65k`` and ``q3_like_262k`` (q3's local calls: 65,536
and 262,144 probe rows, 54% live, a tenth of them matching one row of a
147,456-row build); cap = the total where not given.  K2 shapes: live shares 0,
0.27 at the front (a padded batch) and 1 at 131,072 and 8,388,608 rows.
Device ms a call from torch.profiler (every kernel, copy and memset of 20
calls, over 20; ``chip_smoke.device_ms``), kernel and yardstick alike, over
copies of the inputs that rotate past the 50 MB L2, and each kernel's share
(``by_kernel``); the bound from the bytes each function must move
(``chip_smoke.probe_join_bytes`` for K6); every result is held against the
twin.  Prints one JSON line.
Needs a card.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ONES = 0xFFFFFFFFFFFFFFFF


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import numpy as np
    import torch

    from arrow_ballista_tpu_torch.ops import kernels as K

    # this tree's chip_smoke (its bounds and timers), whatever --root is
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = sys.modules["chip_smoke"] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA card")
    dev = torch.device("cuda")
    rng = np.random.default_rng(args.seed)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def build(nb, keys, dead_share=0.15):
        """nb build hashes over ``keys`` (uint64), dead rows all ones, sorted."""
        h = keys[rng.integers(0, len(keys), nb)] if len(keys) < nb else keys[:nb].copy()
        h[rng.random(nb) < dead_share] = np.uint64(ONES)
        return np.sort(h)

    def probe_shape(n, nb, live, hit, key_pool, dead_share=0.15):
        keys = rng.integers(0, 2**64 - 1, key_pool, dtype=np.uint64)
        bh = build(nb, keys, dead_share)
        ph = rng.integers(0, 2**64 - 1, n, dtype=np.uint64)
        match = rng.random(n) < hit
        ph[match] = keys[rng.integers(0, len(keys), int(match.sum()))]
        pm = rng.random(n) < live
        return ph.view(np.int64), pm, bh.view(np.int64)

    def by_kernel(fn, iters=20):
        """Device ms a call of each kernel, copy and memset ``fn`` launches."""
        from torch.profiler import ProfilerActivity, profile

        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        return {key.split("(")[0][:60]: round(ms / iters, 6)
                for ms, _count, key in cs.device_rows(prof)}

    n8, n1 = 1 << 23, 1 << 20
    k6_shapes = {
        # mesh4_q3's largest call: 38,460 of 8,388,608 probe rows live, 7,832
        # pairs; 772,545 of 8,388,608 build rows live
        "selective_8m": (*probe_shape(n8, n8, 38_460 / n8, 7_832 / 38_460, 772_545,
                                      dead_share=1 - 772_545 / n8), 131_072),
        "one_to_one_1m": (*probe_shape(n1, n1, 1.0, 1.0, n1, dead_share=0.0), None),
        "fanout_3_1m": (*probe_shape(n1, n1, 0.9, 0.9, n1 // 3, dead_share=0.0), None),
        "build_in_l2": (*probe_shape(n8, n1, 0.5, 0.1, n1), None),
        # q3's local calls: 65,536 and 262,144 lineitem rows (54% live) against
        # the 147,456-row orders x customer build, a tenth of them matching
        "q3_like_65k": (*probe_shape(1 << 16, 147_456, 0.54, 0.1, 147_456, dead_share=0.0),
                        None),
        "q3_like_262k": (*probe_shape(1 << 18, 147_456, 0.54, 0.1, 147_456, dead_share=0.0),
                         None),
    }
    out = {"root": os.path.abspath(args.root), "device": torch.cuda.get_device_name(0),
           "k6": {}, "k2": {}}
    for name, (ph, pm, bh, cap) in k6_shapes.items():
        card = (t(ph), t(pm), t(bh))
        total = int(K.probe_join(*card, 1)[3])
        cap = total if cap is None else cap
        got = K.probe_join(*card, cap)
        want = K.probe_join_plain(*card, cap)
        if any(not torch.equal(g, w) for g, w in zip(got[:3], want[:3])) or \
                int(got[3]) != int(want[3]):
            sys.exit(f"probe_join differs from its twin at {name}")
        moved = cs.probe_join_bytes(*card, cap)
        nxt = cs.rotating((*card, cap), moved)
        pf, bf = card[0] ^ K._SIGN, card[2] ^ K._SIGN
        rows = torch.arange(ph.shape[0], device=dev)
        lib_in = cs.rotating((pf, card[1], bf), cs.nbytes(pf, bf) + ph.shape[0])

        def library():  # searchsorted x2 + cumsum + repeat_interleave
            p, m, b = lib_in()
            counts = torch.where(m, torch.searchsorted(b, p, side="right")
                                 - torch.searchsorted(b, p, side="left"), 0)
            return torch.cumsum(counts, 0), torch.repeat_interleave(rows, counts,
                                                                    output_size=total)

        out["k6"][name] = {
            "probe_rows": ph.shape[0], "build_rows": bh.shape[0],
            "live_share": float(pm.mean()), "total": total, "cap": cap,
            "ms": cs.device_ms(lambda: K.probe_join(*nxt()))[0],
            "counts_ms": cs.device_ms(lambda: K.probe_counts(*nxt()[:3]))[0],
            "library_ms": cs.device_ms(library)[0],
            "bound_ms": moved / cs.HBM_BYTES_PER_S * 1000,
            "by_kernel": by_kernel(lambda: K.probe_join(*nxt()))}

    def compact_ms(mask):
        got = K.compaction_order(mask)
        if not torch.equal(got, K.compaction_order_plain(mask)):
            sys.exit(f"compaction_order differs from its twin at {mask.numel()} rows")
        nxt = cs.rotating((mask,), mask.numel() * 5)
        return cs.device_ms(lambda: K.compaction_order(*nxt()))[0]

    def front(n, share):
        m = np.zeros(n, dtype=bool)
        m[: int(n * share)] = True
        return m

    for n in (1 << 17, n8):
        for label, m in (("dead", front(n, 0.0)), ("front_0.27", front(n, 0.27)),
                         ("live", front(n, 1.0))):
            mask = t(m)
            lib = cs.rotating((mask,), n * 9)
            out["k2"][f"{label}_{n}"] = {
                "ms": compact_ms(mask),
                "library_ms": cs.device_ms(lambda: torch.argsort(~lib()[0], stable=True))[0],
                "bound_ms": n * 5 / cs.HBM_BYTES_PER_S * 1000,
                "by_kernel": by_kernel(lambda: K.compaction_order(mask))}
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
