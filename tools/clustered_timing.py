"""K10 (``key_range_check``) and K11 (``clustered_keep``) of a checkout of
the PyTorch/CUDA port at synthetic shapes on one card, beside the PyTorch
call that ``chip_smoke.py`` holds each against (``aminmax`` of the masked
keys; ``bucketize`` of the keys into the sorted interval starts), so that
two commits can be compared in one call.

    python3 tools/clustered_timing.py [--root DIR] [--rows 1048576] [--seed 0]

``--root`` is the checkout whose ``arrow_ballista_tpu_torch`` is imported
(this tree, or a parent commit unpacked with ``git archive``; K11's
wrapper took the padded interval tensors before its redesign and takes
``kernels.KeepIntervals`` since).  Every input is made from ``--seed``
with numpy: int64 keys in key order over six times as many values as rows
(a clustered partial's group keys), 16 windows of up to three keys and
the NULL-sentinel pair, padded to 32 with empty (1, 0) pairs as the
operator pads them.  Shapes: ``front_live`` (the main path's: the first
27% of the rows live, the HAVING predicate true for 0.1% of them, a dead
tail), ``scattered_live`` (27% of the rows live at random), ``unsorted``
(the same keys in random order), ``having_true`` (every live row passes
HAVING: no search), ``windows_5000`` (random keys, 5,000 windows: searched
in device memory); K10 ``front_live`` and ``all_live``.  Device ms a call
from CUDA events around 20 calls queued behind a spin kernel
(``chip_smoke.queued_events_ms``), kernel and library alike, over copies
of the inputs that rotate past the 50 MB L2; every result is held against
the twin.  Prints one JSON line.  Needs a card.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--rows", type=int, default=1 << 20)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    sys.path.insert(1, HERE)
    import numpy as np
    import torch

    import chip_smoke as cs
    from arrow_ballista_tpu_torch.ops import kernels as K

    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA card")
    dev = torch.device("cuda")
    n, rng = args.rows, np.random.default_rng(args.seed)
    i64 = np.iinfo(np.int64)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def windows(m, span):
        starts = np.sort(rng.choice(span, m, replace=False)).astype(np.int64)
        los = np.concatenate([starts, [i64.min]])
        his = np.concatenate([starts + rng.integers(0, 3, m), [i64.min]])
        pad = 1 << int(np.ceil(np.log2(max(len(los), 4))))
        return (np.concatenate([los, np.ones(pad - len(los), np.int64)]),
                np.concatenate([his, np.zeros(pad - len(his), np.int64)]))

    new_form = hasattr(K, "KeepIntervals")

    def keep_args(keys, mask, pred, los, his, device):
        iv = K.KeepIntervals(los, his, device) if new_form else None
        tail = (iv,) if new_form else ((t(los), t(his)) if device == dev
                                       else (torch.from_numpy(los), torch.from_numpy(his)))
        conv = t if device == dev else torch.from_numpy
        return (conv(keys), conv(mask), conv(pred), *tail)

    span = 6 * n
    keys = np.sort(rng.integers(0, span, n)).astype(np.int64)
    front = np.zeros(n, dtype=bool)
    front[: int(n * 0.27)] = True
    scattered = rng.random(n) < 0.27
    rare = rng.random(n) < 0.001
    shapes = {
        "front_live": (keys, front, front & rare, windows(16, span)),
        "scattered_live": (keys, scattered, scattered & rare, windows(16, span)),
        "unsorted": (rng.permutation(keys), scattered, scattered & rare, windows(16, span)),
        "having_true": (keys, scattered, scattered.copy(), windows(16, span)),
        "windows_5000": (rng.integers(0, 8 * 5000 * 8, n).astype(np.int64), scattered,
                         scattered & rare, windows(5000, 8 * 5000 * 8)),
    }
    out = {"root": os.path.abspath(args.root), "device": torch.cuda.get_device_name(0),
           "rows": n, "k11": {}, "k10": {}}
    for name, (k, m, p, (los, his)) in shapes.items():
        on_card = keep_args(k, m, p, los, his, dev)
        gk, gl = K.clustered_keep(*on_card)
        wk, wl = K.clustered_keep_plain(*keep_args(k, m, p, los, his, "cpu"))
        if not torch.equal(gk.cpu(), wk) or int(gl) != int(wl):
            sys.exit(f"clustered_keep differs from its twin at {name}")
        nxt = cs.rotating(on_card, 11 << 20)
        starts = torch.sort(t(los)).values
        lib = cs.rotating((t(k),), 8 << 20)
        out["k11"][name] = {
            "ms": cs.queued_events_ms(lambda: K.clustered_keep(*nxt())),
            "library_ms": cs.queued_events_ms(
                lambda: torch.bucketize(lib()[0], starts, right=True)),
            "live": int(wl)}
    for name, m in (("front_live", front), ("all_live", np.ones(n, dtype=bool))):
        lo, hi = 0, span
        kd, md = t(keys), t(m)
        if bool(K.key_range_check(kd, md, lo, hi)) != bool(
                K.key_range_check_plain(torch.from_numpy(keys), torch.from_numpy(m), lo, hi)):
            sys.exit(f"key_range_check differs from its twin at {name}")
        nxt = cs.rotating((kd, md, lo, hi), 9 << 20)
        masked = cs.rotating((torch.where(md, kd, kd[0]),), 8 << 20)
        out["k10"][name] = {
            "ms": cs.queued_events_ms(lambda: K.key_range_check(*nxt())),
            "library_ms": cs.queued_events_ms(lambda: torch.aminmax(masked()[0]))}
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
