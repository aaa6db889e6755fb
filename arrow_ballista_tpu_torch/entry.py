"""The port's counterpart of ``__graft_entry__.entry()``: the flagship q1
step (scan filter -> augment -> dense grouped aggregate, K1) on a
synthetic lineitem slice in physical representation.

``entry(rows, device)`` returns ``(step, (cols, mask))``; ``step(cols,
mask)`` returns ``(group_keys, group_values, group_mask, overflow)``
like the reference step.  The reference groups on the sort path; this
step takes the dense path over the example's known key ranges, which
yields the same groups in the same (ascending key) order.

``dryrun_multichip(n)`` runs the same step, and the q3-shaped joins, over
an n-rank mesh (parallel/).
"""
from __future__ import annotations

import numpy as np
import torch

from .ops import kernels as K


def q1_example(rows: int, seed: int = 0):
    """Synthetic lineitem slice in physical (device) representation, the
    same numbers as ``__graft_entry__._q1_example``."""
    rng = np.random.default_rng(seed)
    cols = {
        # decimal(15,2) columns are fixed-point int64
        "l_quantity": rng.integers(100, 5100, rows).astype(np.int64),
        "l_extendedprice": rng.integers(100_00, 10_000_00, rows).astype(np.int64),
        "l_discount": rng.integers(0, 11, rows).astype(np.int64),
        "l_tax": rng.integers(0, 9, rows).astype(np.int64),
        "l_returnflag": rng.integers(0, 3, rows).astype(np.int64),
        "l_linestatus": rng.integers(0, 2, rows).astype(np.int64),
        "l_shipdate": rng.integers(8035, 10500, rows).astype(np.int64),
    }
    mask = np.ones(rows, dtype=bool)
    return cols, mask


Q1_KEYS = ["l_returnflag", "l_linestatus"]
Q1_KEY_RANGES = ((0, 2), (0, 1))  # the example's code ranges
CUTOFF = 10471  # 1998-09-02 in days-since-epoch (q1: shipdate <= date - 90d)
Q1_AGGS = [
    ("l_quantity", "sum"),
    ("l_extendedprice", "sum"),
    ("__disc_price", "sum"),
    ("__charge", "sum"),
    ("l_discount", "sum"),
    ("__ones", "sum"),  # count(*) per group
]
OUT_CAPACITY = 16


def q1_filter(cols, mask):
    return cols, mask & (cols["l_shipdate"] <= CUTOFF)


def q1_augment(cols):
    """Derived aggregate inputs in scaled fixed point."""
    disc_price = cols["l_extendedprice"] * (100 - cols["l_discount"])  # scale 4
    charge = torch.div(disc_price * (100 + cols["l_tax"]), 100,
                       rounding_mode="floor")  # scale 4, floor like jnp //
    out = dict(cols)
    out["__disc_price"] = disc_price
    out["__charge"] = charge
    out["__ones"] = torch.ones_like(cols["l_quantity"])
    return out


def step(cols, mask):
    cols, mask = q1_filter(cols, mask)
    cols = q1_augment(cols)
    keys = [cols[k] for k in Q1_KEYS]
    vals = [(cols[v], how) for v, how in Q1_AGGS]
    return K.grouped_aggregate(keys, vals, mask, OUT_CAPACITY, key_ranges=Q1_KEY_RANGES)


def entry(rows: int = 4096, device=None):
    """The q1 step and its inputs on ``device`` (the card by default)."""
    from .client.context import resolve_device

    dev = resolve_device(device)
    cols, mask = q1_example(rows)
    return step, ({k: torch.from_numpy(v).to(dev) for k, v in cols.items()},
                  torch.from_numpy(mask).to(dev))


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """The counterpart of ``__graft_entry__.dryrun_multichip``: the q1 fused
    step and the q3-shaped joins over an ``n_devices``-rank mesh, with the
    reference's five sections and evidence lines.  The reference re-execs
    itself in a CPU subprocess to get virtual devices; here the ranks are
    in process, all on ``device`` (the card by default).  Returns
    ``{"ok", "skipped", "n_devices", "sections"}``; a wrong result raises."""
    from .client.context import resolve_device
    from .parallel.distributed import (distributed_broadcast_join,
                                       distributed_dense_aggregate,
                                       distributed_filter_aggregate,
                                       distributed_grouped_aggregate, distributed_hash_join,
                                       distributed_partial_aggregate)
    from .parallel.mesh import make_mesh, shard_rows

    dev = resolve_device(device)
    n = int(n_devices)
    mesh = make_mesh(devices=[dev] * n)
    sections = []

    def say(line):
        sections.append(line)
        print(line, flush=True)

    def sharded(cols, mask, m):
        return ({k: shard_rows(torch.from_numpy(np.ascontiguousarray(v)).to(dev), m)
                 for k, v in cols.items()},
                shard_rows(torch.from_numpy(np.ascontiguousarray(mask)).to(dev), m, fill=False))

    def filter_and_derive(cols, mask):
        cols, mask = q1_filter(cols, mask)
        return q1_augment(cols), mask

    def cat(x):
        return torch.cat(x) if isinstance(x, list) else x

    def states(keys, vals, msk):
        out = {}
        keys = [cat(k).cpu().numpy() for k in keys]
        vals = [cat(v).cpu().numpy() for v in vals]
        msk = cat(msk).cpu().numpy()
        for i in np.flatnonzero(msk):
            kk = tuple(int(k[i]) for k in keys)
            out[kk] = out.get(kk, 0) + np.array([v[i] for v in vals], dtype=np.int64)
        return {k: v.tolist() for k, v in out.items()}

    # 1) fused filter -> partial agg -> all_to_all -> final agg
    cols, mask = q1_example(128 * n)
    run = distributed_filter_aggregate(mesh, filter_and_derive, Q1_KEYS, Q1_AGGS,
                                       partial_capacity=32, final_capacity=32)
    _fk, _fv, fmask, overflow = run(*sharded(cols, mask, mesh))
    assert not bool(overflow), "capacity overflow on dryrun shapes"
    n_groups = int(cat(fmask).sum())
    assert n_groups >= 1, "distributed aggregate produced no groups"
    say(f"[dryrun] 1/5 fused filter+all_to_all aggregate: "
        f"{n_groups} groups over {n} devices")

    # 2) the TPC-H q3 shape: partitioned hash join over the mesh
    rng = np.random.default_rng(3)
    n_fact, n_dim = 64 * n, 16 * n
    fk = rng.integers(0, n_dim * 2, n_fact).astype(np.int64)
    dk = np.arange(n_dim, dtype=np.int64)
    pcols, pmask = sharded({"__jk0": fk, "val": rng.integers(0, 100, n_fact).astype(np.int64)},
                           np.ones(n_fact, dtype=bool), mesh)
    bcols, bmask = sharded({"__jk0": dk, "weight": rng.integers(1, 5, n_dim).astype(np.int64)},
                           np.ones(n_dim, dtype=bool), mesh)
    join = distributed_hash_join(mesh, 1, ["val"], ["weight"], "inner",
                                 shuffle_capacity=2 * max(n_fact, n_dim) // n,
                                 out_capacity=2 * n_fact // n, build_fill={})
    _jcols, jmask, joverflow = join((pcols, pmask), (bcols, bmask))
    assert not bool(joverflow), "mesh join capacity overflow on dryrun shapes"
    matched = int(cat(jmask).sum())
    expected = int((fk < n_dim).sum())  # dim keys are dense [0, n_dim)
    assert matched == expected, f"mesh join matched {matched}, want {expected}"
    say(f"[dryrun] 2/5 partitioned hash join: {matched} matches")

    if n >= 2:
        # 3) two "hosts", each a mesh of half the ranks running the partial
        #    aggregate; the states cross over a host copy (the file-shuffle
        #    stand-in) and the final aggregate runs on one host's mesh
        half = n // 2
        mesh_a = make_mesh(devices=[dev] * half)
        mesh_b = make_mesh(devices=[dev] * half)
        rows_h = 128 * half
        cols_np, mask_np = q1_example(2 * rows_h, seed=5)
        parts = []
        for hi, m in enumerate((mesh_a, mesh_b)):
            sl = slice(hi * rows_h, (hi + 1) * rows_h)
            run_p = distributed_partial_aggregate(m, filter_and_derive, Q1_KEYS, Q1_AGGS,
                                                  capacity=32)
            hpk, hpv, hpmask, ovf = run_p(*sharded({k: v[sl] for k, v in cols_np.items()},
                                                   mask_np[sl], m))
            assert not bool(ovf)
            parts.append(([cat(k).cpu().numpy() for k in hpk],
                          [cat(v).cpu().numpy() for v in hpv], cat(hpmask).cpu().numpy()))
        merged = {name: np.concatenate([p[0][i] for p in parts]) for i, name in enumerate(Q1_KEYS)}
        merged.update({v: np.concatenate([p[1][i] for p in parts])
                       for i, (v, _how) in enumerate(Q1_AGGS)})
        run_f = distributed_grouped_aggregate(mesh_a, Q1_KEYS, [(v, "sum") for v, _ in Q1_AGGS],
                                              32, 32)
        hk, hv, hmask, hovf = run_f(*sharded(merged, np.concatenate([p[2] for p in parts]),
                                             mesh_a))
        assert not bool(hovf)
        run_all = distributed_filter_aggregate(mesh, filter_and_derive, Q1_KEYS, Q1_AGGS,
                                               partial_capacity=32, final_capacity=32)
        acols, amask = sharded(cols_np, mask_np, mesh)
        ak, av, am, aovf = run_all(acols, amask)
        assert not bool(aovf)
        hybrid, oracle = states(hk, hv, hmask), states(ak, av, am)
        assert hybrid == oracle, (f"hybrid 2-host result diverges from single-mesh:\n"
                                  f"{hybrid}\nvs\n{oracle}")
        say(f"[dryrun] 3/5 hybrid 2-host exchange: "
            f"{len(hybrid)} groups match single-mesh oracle")

        # 4) the dense reduce (K18) must equal the all_to_all path
        run_dense = distributed_dense_aggregate(mesh, filter_and_derive, Q1_KEYS, Q1_AGGS,
                                                key_ranges=((0, 2), (0, 1)), domain=6)
        dk_, dv_, dm_, dovf = run_dense(acols, amask)
        assert not bool(dovf)
        assert states(dk_, dv_, dm_) == oracle, \
            "dense reduce-collective diverges from all_to_all path"
        say("[dryrun] 4/5 dense reduce-collective matches all_to_all path")

    # 5) broadcast join: the build side all_gathered, probe rows stay
    bjoin = distributed_broadcast_join(mesh, 1, ["val"], ["weight"], "inner",
                                       out_capacity=2 * n_fact // n, build_fill={})
    _bjc, bjm, bjovf = bjoin((pcols, pmask), (bcols, bmask))
    assert not bool(bjovf), "broadcast join capacity overflow on dryrun shapes"
    bmatched = int(cat(bjm).sum())
    assert bmatched == expected, f"broadcast join matched {bmatched}, want {expected}"
    say(f"[dryrun] 5/5 broadcast join: {bmatched} matches")
    print(f"DRYRUN_MULTICHIP_OK n_devices={n} sections={len(sections)}", flush=True)
    return {"ok": True, "skipped": False, "n_devices": n, "sections": sections}
