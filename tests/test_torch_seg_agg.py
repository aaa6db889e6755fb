"""K8 ``grouped_on_order`` (csrc/seg_agg.cu) on the CPU: a numpy model of
the kernel's tile decomposition, step for step at its tile size, and the
port's twin, each held against the JAX package's
``_grouped_aggregate_on_order`` over ``tests/torch_cases.py``'s SEG_CASES
(a tile -+1 rows, a group across two tiles and one across every tile,
every row its own group, dead rows inside and before the groups, a
capacity below the group count, every value and key type, no keys).

The model follows the kernel: per-row boundary flags; per tile its
boundary count, last boundary and trailing fold (the live rows from its
last boundary on), published as an aggregate; a look-back that sums the
counts up to the nearest inclusive word and folds the trailing folds up to
the nearest tile with a boundary, 32 tiles a step; then the segments that
close in the tile, by threads of SG_ITEMS rows and a segmented scan over
them that starts from the carried fold; the last tile writes the final
segment; the fill writes the slots past the groups.  Which earlier tiles
have published an inclusive word when a tile looks back is a parameter: the
result must not depend on it.  Every slot is written once.

Integers, keys and the mask exact; float min and max exact (NaN where the
reference has NaN); float sums at rtol 1e-12 (the model, the twin and the
reference add in different orders; float32 sums are of quarter values,
exact in any order).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arrow_ballista_tpu.ops import kernels as JK
from arrow_ballista_tpu_torch.ops import kernels as TK
from tests.torch_cases import SEG_CASES, SEG_TILE, seg_case

torch.set_num_threads(1)

ITEMS = 8  # csrc/seg_agg.cu SG_ITEMS: rows a thread


def _ident(dtype, how):
    if how in ("sum", "count"):
        return dtype.type(0)
    if dtype.kind == "f":
        return dtype.type(np.inf if how == "min" else -np.inf)
    info = np.iinfo(dtype)
    return dtype.type(info.max if how == "min" else info.min)


def _comb(dtype, how, a, b):
    """The kernel's sg_comb: wrapping integer sums, NaN-propagating float
    min and max."""
    if how in ("sum", "count"):
        if dtype.kind == "f":
            return dtype.type(a + b)
        bits = 8 * dtype.itemsize
        x = (int(a) + int(b)) % (1 << bits)
        return dtype.type(x - (1 << bits) if x >= 1 << (bits - 1) else x)
    if dtype.kind == "f" and (math.isnan(a) or math.isnan(b)):
        return a if math.isnan(a) else b
    return min(a, b) if how == "min" else max(a, b)


def k8_mirror(keys, vals, mask, cap, order=None, inc_every=1, tile=SEG_TILE):
    """csrc/seg_agg.cu on numpy inputs: (out_keys, out_vals, out_mask,
    num_groups).  Row i of the grouping is row order[i] of the inputs.
    ``inc_every``: tile t has published an inclusive word when a later tile
    looks back only if t % inc_every == 0 (tile 0 always); the others show
    their aggregate."""
    n = len(mask) if order is None else len(order)
    src = np.arange(n) if order is None else np.asarray(order, np.int64)
    live = np.asarray(mask, bool)[src]
    if keys:
        opens = np.zeros(n, bool)
        opens[0] = True
        for k in keys:
            ks = k[src]
            opens[1:] |= ks[1:] != ks[:-1]  # floats by value: NaN differs, -0.0 == 0.0
        flag = live & opens
    else:
        flag = np.zeros(n, bool)
    forms = [(np.dtype(np.int64) if how == "count" else v.dtype, how) for v, how in vals]

    def value(a, i):
        v, how = vals[a]
        return forms[a][0].type(1) if how == "count" else v[src[i]]

    tiles = -(-n // tile)
    out_vals = [np.empty(cap, dt) for dt, _ in forms]
    written = [np.zeros(cap, int) for _ in forms]
    out_keys = [np.zeros(cap, k.dtype) for k in keys]
    out_mask = np.zeros(cap, bool)
    agg, incl = [], []  # per tile: (count, live, folds)
    groups = 0
    for t in range(tiles):
        r0, r1 = t * tile, min((t + 1) * tile, n)
        f = flag[r0:r1]
        count = int(f.sum())
        last = int(np.flatnonzero(f)[-1]) if count else -1
        t_live = bool(live[r0:r1].any())
        # phase 1: the trailing fold, live rows at or after the last boundary
        fold = []
        for a, (dt, how) in enumerate(forms):
            x = _ident(dt, how)
            for i in range(r0 + max(last, 0), r1):
                if live[i]:
                    x = _comb(dt, how, x, value(a, i))
            fold.append(x)
        agg.append((count, t_live, fold))
        # phase 2: look back, 32 tiles a step, nearest first
        pre_count, pre_live = 0, False
        carry = [_ident(dt, how) for dt, how in forms]
        carry_open = True
        near = t - 1
        while near >= 0:
            window = [near - q for q in range(32) if near - q >= 0]
            words = [incl[w] if w % inc_every == 0 else None for w in window]
            nearest = next((q for q, w in enumerate(words) if w is not None), 32)
            for q, w in enumerate(window[:nearest + 1]):
                c, lv, _ = words[q] if q == nearest else agg[w]
                pre_count += c
                pre_live |= lv
            if carry_open:
                stop = next((q for q, w in enumerate(window)
                             if words[q] is not None or agg[w][0] > 0), None)
                for q in range(len(window) if stop is None else stop + 1):
                    far = (words[q] if words[q] is not None else agg[window[q]])[2]
                    carry = [_comb(dt, how, far[a], carry[a]) for a, (dt, how) in enumerate(forms)]
                carry_open = stop is None
            if nearest < 32:
                break
            near -= 32
        inclusive = fold if count else [_comb(dt, how, carry[a], fold[a])
                                         for a, (dt, how) in enumerate(forms)]
        incl.append((pre_count + count, pre_live or t_live, inclusive))
        # phase 3: keys and mask of the groups that open here; the segments
        # that close here, by threads and a segmented scan from the carry
        if count:
            for j in np.flatnonzero(f):
                g = pre_count + int(f[:j].sum())
                if g < cap:
                    for kk, k in enumerate(keys):
                        out_keys[kk][g] = k[src[r0 + j]]
                    out_mask[g] = True
            for a, (dt, how) in enumerate(forms):
                run_x = carry[a]  # the scan: the open segment so far
                for l0 in range(0, r1 - r0, ITEMS):
                    g = pre_count + int(f[:l0].sum()) - 1
                    head_g = g
                    x, h, seen = _ident(dt, how), None, False
                    for l in range(l0, min(l0 + ITEMS, r1 - r0)):
                        if f[l]:
                            if seen:
                                if 0 <= g < cap:
                                    out_vals[a][g] = x
                                    written[a][g] += 1
                            else:
                                h = x
                            seen = True
                            x = _ident(dt, how)
                            g += 1
                        if live[r0 + l] and l < last:
                            x = _comb(dt, how, x, value(a, r0 + l))
                    if not seen:
                        h = x
                    if seen and 0 <= head_g < cap:
                        out_vals[a][head_g] = _comb(dt, how, run_x, h)
                        written[a][head_g] += 1
                    run_x = x if seen else _comb(dt, how, run_x, x)
        if t == tiles - 1:
            total, any_live, fin = incl[-1]
            groups = total if keys else int(any_live)
            if 0 <= groups - 1 < cap:
                for a in range(len(forms)):
                    out_vals[a][groups - 1] = fin[a]
                    written[a][groups - 1] += 1
                if not keys:
                    out_mask[0] = True
    # the fill: the slots past the groups
    for a, (dt, how) in enumerate(forms):
        out_vals[a][min(groups, cap):] = _ident(dt, how)
        assert (written[a][:min(groups, cap)] == 1).all(), "a group's slot written other than once"
        assert not written[a][min(groups, cap):].any()
    return out_keys, out_vals, out_mask, groups


def _reference(keys, vals, mask, cap):
    n = len(mask)
    jk, jv, jm, jo = JK._grouped_aggregate_on_order(
        [jnp.asarray(k) for k in keys], [(jnp.asarray(v), h) for v, h in vals],
        jnp.asarray(mask), cap, n)
    return ([np.asarray(k) for k in jk], [np.asarray(v) for v in jv], np.asarray(jm),
            None if jo is None else bool(jo))


def _assert_same(got_keys, got_vals, got_mask, want, vals):
    wk, wv, wm, _ = want
    np.testing.assert_array_equal(got_mask, wm)
    for g, w in zip(got_keys, wk):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    for (v, how), g, w in zip(vals, got_vals, wv):
        assert g.dtype == w.dtype
        if v.dtype.kind == "f" and how == "sum":
            np.testing.assert_allclose(g, w, rtol=1e-12, atol=0)
        else:
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("case", SEG_CASES)
def test_k8_tile_decomposition_matches_reference(case):
    """The model at the kernel's tile size, with every earlier tile
    inclusive, every third, and only tile 0 (the look-back walks past 32
    aggregates), against the JAX package's grouping on every slot."""
    keys, vals, mask, cap = seg_case(case, np.random.default_rng(41))
    want = _reference(keys, vals, mask, cap)
    n = len(mask)
    # the group count the reference's overflow flag compares with the capacity
    groups_want = int(np.asarray(JK._grouped_aggregate_on_order(
        [jnp.asarray(k) for k in keys], [], jnp.asarray(mask), n, n)[2]).sum())
    for inc_every in (1, 3, 10**9):
        gk, gv, gm, groups = k8_mirror(keys, vals, mask, cap, inc_every=inc_every)
        _assert_same(gk, gv, gm, want, vals)
        assert groups == groups_want


@pytest.mark.parametrize("case", SEG_CASES)
def test_k8_twin_and_model_read_through_the_order(case):
    """The same groups from inputs held in another row order and read at
    ``order[i]`` (K8's order form): the model, and the port's twin and its
    wrapper on the CPU, against the reference on the rows in group order;
    the twin's overflow flag is the reference's."""
    rng = np.random.default_rng(42)
    keys, vals, mask, cap = seg_case(case, rng)
    n = len(mask)
    want = _reference(keys, vals, mask, cap)
    order = rng.permutation(n).astype(np.int32)

    def scatter(a):  # a[i] lands at row order[i]
        out = np.empty_like(a)
        out[order] = a
        return out

    skeys, svals, smask = [scatter(k) for k in keys], [(scatter(v), h) for v, h in vals], \
        scatter(mask)
    gk, gv, gm, _ = k8_mirror(skeys, svals, smask, cap, order=order, inc_every=3)
    _assert_same(gk, gv, gm, want, vals)
    tk = [torch.from_numpy(k) for k in skeys]
    tv = [(torch.from_numpy(v), h) for v, h in svals]
    for fn in (TK.grouped_on_order_plain, TK.grouped_on_order):
        ok, ov, om, oflow = fn(tk, tv, torch.from_numpy(smask), cap, n, torch.from_numpy(order))
        _assert_same([k.numpy() for k in ok], [v.numpy() for v in ov], om.numpy(), want, vals)
        assert (oflow is None) == (want[3] is None)
        if oflow is not None:
            assert bool(oflow) == want[3]


def test_grouped_aggregate_reads_the_sort_order_through_k8():
    """The sort path hands K8 K4's order, not gathered columns: the
    wrapper's arguments are the operator's own columns and the order."""
    rng = np.random.default_rng(43)
    n = 3001
    keys = [rng.integers(0, 50, n).astype(np.int64), rng.integers(0, 3, n).astype(np.int32)]
    vals = [(rng.integers(-10**9, 10**9, n).astype(np.int64), "sum"),
            (np.zeros(n, np.int64), "count")]
    mask = rng.random(n) < 0.8
    tk = [torch.from_numpy(k) for k in keys]
    tv = [(torch.from_numpy(v), h) for v, h in vals]
    seen = []
    real = TK.grouped_on_order

    def spy(*args):
        seen.append(args)
        return real(*args)

    TK.grouped_on_order = spy
    try:
        got = TK.grouped_aggregate(tk, tv, torch.from_numpy(mask), n)
    finally:
        TK.grouped_on_order = real
    (k_arg, v_arg, m_arg, cap, rows, order), = seen
    assert all(a is b for a, b in zip(k_arg, tk)) and v_arg is tv and cap == n and rows == n
    assert order.dtype == torch.int32 and order.shape == (n,)
    jk, jv, jm, jo = JK.grouped_aggregate([jnp.asarray(k) for k in keys],
                                          [(jnp.asarray(v), h) for v, h in vals],
                                          jnp.asarray(mask), n)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(jm))
    for g, w in zip(got[0] + got[1], list(jk) + list(jv)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
