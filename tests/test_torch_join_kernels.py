"""The twins of the port's join and sort-path kernels (K5-K8,
arrow_ballista_tpu_torch/ops/kernels.py, on the CPU) against the JAX
package's functions on the same numpy inputs: build_side_sort,
probe_join, segment_any and the sort branch of grouped_aggregate.

Orders, indices and integers must match bit for bit; float sums at rtol
1e-12 (both sides sum in the input's type, in different orders).  The
CUDA kernels themselves are held against these twins on the card by
chip_smoke.py and tests/test_torch_cuda.py.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from arrow_ballista_tpu.ops import kernels as JK
from arrow_ballista_tpu_torch.ops import kernels as TK
from tests.torch_cases import (JOIN_CASES, PROBE_CASES, SEG_AGG_CASES, SEGMENT_CASES,
                               K6_SEGMENT_CASES, join_case, probe_case, seg_agg_case,
                               segment_case, k6_segment_case)

# the suite runs in parallel worker processes: one core per worker for torch
torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(x):
    return np.asarray(x)


@pytest.fixture(params=[False, True], ids=["hashed", "forced_collisions"])
def collisions(request, monkeypatch):
    """BALLISTA_FORCE_HASH_COLLISIONS in both packages: every live hash 0."""
    monkeypatch.setenv("BALLISTA_FORCE_HASH_COLLISIONS", "1" if request.param else "0")
    monkeypatch.setattr(JK, "_FORCE_COLLISIONS", None)
    monkeypatch.setattr(TK, "_FORCE_COLLISIONS", None)
    return request.param


# --------------------------------------------------------------------------
# K5: build_side_sort
# --------------------------------------------------------------------------


@pytest.mark.parametrize("case", JOIN_CASES)
def test_build_side_sort_matches(case, collisions):
    bk, bmask, _, _ = join_case(case, 3001, 10, np.random.default_rng(21))
    jh, jo, jn = JK.build_side_sort([jnp.asarray(k) for k in bk], jnp.asarray(bmask))
    th, to, tn = TK.build_side_sort([_t(k) for k in bk], _t(bmask))
    assert to.dtype == torch.int32
    np.testing.assert_array_equal(th.numpy(), _np(jh).view(np.int64))
    # equal hashes keep the build-row order (the reference's argsort is stable)
    np.testing.assert_array_equal(to.numpy().astype(np.int64), _np(jo))
    assert int(tn) == int(jn) == int(bmask.sum())


# --------------------------------------------------------------------------
# K6: probe_join
# --------------------------------------------------------------------------


def _probe_inputs(case, rng):
    bk, bmask, pk, pmask = join_case(case, 2003, 1500, rng)
    jh, _, _ = JK.build_side_sort([jnp.asarray(k) for k in bk], jnp.asarray(bmask))
    th, _, _ = TK.build_side_sort([_t(k) for k in bk], _t(bmask))
    jp = JK.hash64([jnp.asarray(k) for k in pk])
    tp = TK.hash64([_t(k) for k in pk])
    return (jp, jnp.asarray(pmask), jh), (tp, _t(pmask), th)


@pytest.mark.parametrize("case", JOIN_CASES)
def test_probe_join_matches(case, collisions):
    jargs, targs = _probe_inputs(case, np.random.default_rng(22))
    total = int(JK.probe_join(*jargs, 1)[3])
    # short (total > out_cap: truncated), exact, and with dead slots
    for out_cap in sorted({max(1, total // 3), max(1, total), total + 37}):
        jpi, jbp, jv, jt = JK.probe_join(*jargs, out_cap)
        tpi, tbp, tv, tt = TK.probe_join(*targs, out_cap)
        assert int(tt) == int(jt) == total
        assert tpi.dtype == tbp.dtype == torch.int32
        np.testing.assert_array_equal(tv.numpy(), _np(jv))
        # every slot, the invalid ones' clipped indices included
        np.testing.assert_array_equal(tpi.numpy(), _np(jpi))
        np.testing.assert_array_equal(tbp.numpy(), _np(jbp))


@pytest.mark.parametrize("case", ["dup_keys", "heavy_fanout"])
def test_probe_counts_give_the_totals_of_the_count_passes(case):
    """count_fn's total and wcount_fn's per-window sums from the inclusive
    offsets, against the reference's hi - lo arithmetic; without the
    offsets, the total alone."""
    from arrow_ballista_tpu_torch.ops.operators import window_counts

    (jp, jm, jh), (tp, tm, th) = _probe_inputs(case, np.random.default_rng(23))
    lo = jnp.searchsorted(jh, jp, side="left")
    hi = jnp.searchsorted(jh, jp, side="right")
    per_row = _np(jnp.where(jm, hi - lo, 0)).astype(np.int64)
    offsets, total = TK.probe_counts(tp, tm, th, offsets=True)
    assert int(total) == int(per_row.sum())
    np.testing.assert_array_equal(offsets.numpy(), np.cumsum(per_row))
    none, total_only = TK.probe_counts(tp, tm, th)
    assert none is None and total_only.dtype == torch.int64 and int(total_only) == int(total)
    chunk_rows, windows = 400, 4  # 1600 >= 1500 rows
    want = np.bincount(np.arange(per_row.shape[0]) // chunk_rows, weights=per_row,
                       minlength=windows).astype(np.int64)
    np.testing.assert_array_equal(window_counts(offsets, chunk_rows, windows).numpy(), want)


# --------------------------------------------------------------------------
# K6's fused kernel (csrc/probe.cu), step for step in numpy
# --------------------------------------------------------------------------

# (tile rows, threads a block, sampled build hashes, mask address & 15): the
# kernel's tiles for small and large calls, and small ones that give several
# tiles, several warp runs, a strided sample and a shifted first tile at the
# tests' sizes
K6_PARAMS = {"kernel_256": (256, 256, 2048, 0), "kernel_1024": (1024, 256, 2048, 0),
             "small": (128, 64, 16, 5)}


def _top(x):
    """pj_top: the largest power of two <= x, or 0."""
    return 0 if x < 1 else 1 << (int(x).bit_length() - 1)


def _lower_bounds(a, top, h, base, length):
    """pj_lower_bound, every entry at once: halving steps from ``top`` (the
    largest power of two <= every length); b counts the hashes below h in
    a[base, base + length)."""
    b = np.zeros(len(h), np.int64)
    step = top
    while step > 0:
        ok = b + step <= length
        idx = np.where(ok, base + b + step - 1, 0)
        below = ok & (a[idx] < h) if len(a) else np.zeros(len(h), bool)
        b = np.where(below, b + step, b)
        step >>= 1
    return b


def _run_end(bh, lo, h):
    """pj_run_end: the end of the run of h from lo, galloping, then bisecting."""
    p, d = lo, 1
    while p + d < len(bh) and bh[p + d] == h:
        p, d = p + d, d * 2
    a, b = p + 1, min(p + d, len(bh))
    while a < b:
        mid = (a + b) // 2
        a, b = (mid + 1, b) if bh[mid] == h else (a, mid)
    return a


def _bounded_search(incl, local, lo):
    """The expansion's search from the entry of a thread's previous slot: the
    first list entry whose inclusive count exceeds ``local``, in [lo, end)."""
    hi = np.full_like(lo, len(incl) - 1)
    lo = lo.copy()
    while (lo < hi).any():
        go = lo < hi
        mid = (lo + hi) >> 1
        up = go & (incl[mid] <= local)
        lo = np.where(up, mid + 1, lo)
        hi = np.where(go & ~up, mid, hi)
    return lo


def k6_mirror(ph, pm, bh, cap, tile=4096, threads=256, sample=2048, shift=0):
    """csrc/probe.cu on uint64 numpy inputs: (probe_idx, build_pos, valid,
    total, inclusive offsets).  A tile lists its rows that search (live,
    and row n-1) in row order; a search finds its stride of the build in
    the sample, then its lower bound inside it, by fixed halving steps;
    one compare, then a gallop on a match; the list's counts are scanned
    over the warps' runs; a tile takes its first slot from the tiles before
    it (the look-back's sum) and finds each slot's entry by a search over
    the list's inclusive counts; the fill writes the slots past the total."""
    n, nb = len(ph), len(bh)
    stride = -(-nb // sample) if nb > sample else 1
    m = -(-nb // stride)
    need = pm.copy()
    need[n - 1] = True
    rows = np.flatnonzero(need)
    h = ph[rows]
    si = _lower_bounds(bh[::stride][:m], _top(m), h, np.zeros(len(h), np.int64), m)
    lo_g = np.where(si == 0, 0, (si - 1) * stride + 1)
    hi_g = np.where(si < m, si * stride, nb)
    assert (hi_g - lo_g <= max(stride - 1, 0)).all()
    lo_rows = lo_g + _lower_bounds(bh, _top(stride - 1), h, lo_g, hi_g - lo_g)
    lo = np.zeros(n, np.int64)
    lo[rows] = lo_rows
    # the narrowed search finds the reference's lower bound
    np.testing.assert_array_equal(lo_rows, np.searchsorted(bh, h, side="left"))
    count = np.zeros(n, np.int64)
    for i in np.flatnonzero(pm & (lo < nb)):
        if bh[lo[i]] == ph[i]:
            count[i] = _run_end(bh, lo[i], ph[i]) - lo[i]
    tiles = -(-(n + shift) // tile)
    tile_of = (rows + shift) // tile
    totals = np.bincount(tile_of, weights=count[rows], minlength=tiles).astype(np.int64)
    prefix = np.concatenate([[0], np.cumsum(totals)[:-1]])  # the look-back's sum
    total = int(totals.sum())
    probe_idx = np.zeros(cap, np.int64)
    build_pos = np.zeros(cap, np.int64)
    valid = np.zeros(cap, bool)
    offsets = np.zeros(n, np.int64)
    warps = threads // 32
    for t in range(tiles):
        listed = rows[tile_of == t]  # the tile's list, in row order
        c = count[listed]
        run = max(32, -(-len(listed) // (warps * 32)) * 32)  # a warp's run of the list
        within = np.concatenate([np.cumsum(c[w * run:(w + 1) * run]) for w in range(warps)])
        wsum = np.concatenate([[0], np.cumsum([c[w * run:(w + 1) * run].sum()
                                               for w in range(warps)])[:-1]])
        incl = wsum[np.arange(len(listed)) // run] + within[:len(listed)]
        np.testing.assert_array_equal(incl, np.cumsum(c))
        # the offsets: each row takes the inclusive count of the last entry at or before it
        row_lo, row_hi = max(t * tile - shift, 0), min((t + 1) * tile - shift, n)
        pos = np.searchsorted(listed, np.arange(row_lo, row_hi), side="right")
        offsets[row_lo:row_hi] = prefix[t] + np.concatenate([[0], incl])[pos]
        end = min(prefix[t] + totals[t], cap)
        j = np.arange(prefix[t], end)
        if not len(j):
            continue
        local = j - prefix[t]
        e = np.searchsorted(incl, local, side="right")
        # a thread's previous slot is `threads` slots back: its entry bounds the search
        start_at = np.where(local >= threads, np.roll(e, threads), 0)
        np.testing.assert_array_equal(_bounded_search(incl, local, start_at), e)
        start = np.where(e == 0, 0, incl[np.maximum(e - 1, 0)])
        probe_idx[j], build_pos[j], valid[j] = listed[e], lo[listed[e]] + (local - start), True
    j = np.arange(max(total, 0), cap)
    probe_idx[j] = n - 1
    build_pos[j] = np.clip(lo[n - 1] + j - (total - count[n - 1]), 0, nb - 1)
    return probe_idx, build_pos, valid, total, offsets


_K6_REFERENCE = {}  # (case, hash mode, last row) -> inputs and the JAX package's slots


def _k6_reference(case, last_row, collisions):
    key = (case, collisions, last_row)
    if key not in _K6_REFERENCE:
        (jp, jm, jh), _ = _probe_inputs(case, np.random.default_rng(31))
        pm = _np(jm).copy()
        pm[-1] = last_row == "live"
        ph, bh = _np(jp), _np(jh)
        if last_row == "live" and case != "all_dead_build":  # a match in the last row
            ph = ph.copy()
            ph[-1] = bh[len(bh) // 3]
        jargs = (jnp.asarray(ph), jnp.asarray(pm), jh)
        total = int(JK.probe_join(*jargs, 1)[3])
        caps = sorted({max(1, total // 3), total, total + 37} - {0})
        _K6_REFERENCE[key] = (ph, pm, bh, total,
                              {cap: [_np(x) for x in JK.probe_join(*jargs, cap)[:3]]
                               for cap in caps})
    return _K6_REFERENCE[key]


@pytest.mark.parametrize("params", list(K6_PARAMS))
@pytest.mark.parametrize("last_row", ["dead", "live"])
@pytest.mark.parametrize("case", JOIN_CASES)
def test_k6_fused_arithmetic_matches_reference(case, last_row, params, collisions):
    """The fused kernel's early-exit count and tile-local expansion, mirrored
    in numpy, against the JAX package's probe_join on every slot, with caps
    that truncate, are exact and run past the total (and cap 0)."""
    tile, threads, sample, shift = K6_PARAMS[params]
    ph, pm, bh, total, slots = _k6_reference(case, last_row, collisions)
    assert k6_mirror(ph, pm, bh, 0, tile, threads, sample, shift)[3] == total
    for cap, want in slots.items():
        got = k6_mirror(ph, pm, bh, cap, tile, threads, sample, shift)
        assert got[3] == total
        for g, w in zip(got[:3], want):
            np.testing.assert_array_equal(g, w)
    lo = np.searchsorted(bh, ph, side="left")
    hi = np.searchsorted(bh, ph, side="right")
    np.testing.assert_array_equal(got[4], np.cumsum(np.where(pm, hi - lo, 0)))


@pytest.mark.parametrize("case", PROBE_CASES)
def test_k6_fused_arithmetic_on_probe_cases(case):
    """The same mirror over K6's edge inputs (one build row, an all-dead
    probe, live all-ones probe hashes against the dead build tail, forced
    collisions, row n-1 dead and live) and the twins on them, against the
    JAX package; the forced case's fan-out passes a small tile's slots."""
    ph, pm, bh = probe_case(case, 700, np.random.default_rng(32))
    jargs = (jnp.asarray(ph), jnp.asarray(pm), jnp.asarray(bh))
    targs = (_t(ph.view(np.int64)), _t(pm), _t(bh.view(np.int64)))
    total = int(JK.probe_join(*jargs, 1)[3])
    for cap in sorted({1, max(1, total // 2), total + 5}):
        want = [_np(x) for x in JK.probe_join(*jargs, cap)]
        for tile, threads, sample, shift in K6_PARAMS.values():
            got = k6_mirror(ph, pm, bh, cap, tile, threads, sample, shift)
            for g, w in zip(got[:3], want[:3]):
                np.testing.assert_array_equal(g, w)
            assert got[3] == total
        tw = TK.probe_join(*targs, cap)
        for g, w in zip(tw[:3], want[:3]):
            np.testing.assert_array_equal(g.numpy(), w)
        assert int(tw[3]) == total
    offsets, t_total = TK.probe_counts(*targs, offsets=True)
    np.testing.assert_array_equal(offsets.numpy(), got[4])
    assert int(t_total) == total


# --------------------------------------------------------------------------
# K7: segment_any
# --------------------------------------------------------------------------


@pytest.mark.parametrize("case", SEGMENT_CASES)
def test_segment_any_matches(case):
    v, seg = segment_case(case, 5000, 257, np.random.default_rng(24))
    want = _np(JK.segment_any(jnp.asarray(v), jnp.asarray(seg), 257))
    got = TK.segment_any(_t(v), _t(seg), 257)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)


# within / negate: the join's mask folded into the verdict, as the
# reference's join program composes it (p_mask & hit, p_mask & ~hit)
FOLDS = [(False, False), (True, False), (True, True), (False, True)]


def _reference_fold(v, seg, ns, within, negate):
    hit = _np(JK.segment_any(jnp.asarray(v), jnp.asarray(seg), ns))
    if negate:
        hit = ~hit
    return hit if within is None else within & hit


@pytest.mark.parametrize("within, negate", FOLDS)
@pytest.mark.parametrize("case", SEGMENT_CASES)
def test_segment_any_folded_matches(case, within, negate):
    rng = np.random.default_rng(25)
    v, seg = segment_case(case, 5000, 257, rng)
    w = rng.random(257) < 0.7 if within else None
    want = _reference_fold(v, seg, 257, w, negate)
    got = TK.segment_any(_t(v), _t(seg), 257, within=None if w is None else _t(w), negate=negate)
    np.testing.assert_array_equal(got.numpy(), want)
    plain = TK.segment_any_plain(_t(v), _t(seg), 257, None if w is None else _t(w), negate)
    np.testing.assert_array_equal(plain.numpy(), want)


@pytest.mark.parametrize("within, negate", FOLDS)
@pytest.mark.parametrize("case", K6_SEGMENT_CASES)
def test_segment_any_k6_ids_folded_matches(case, within, negate):
    """K6-shaped ids (probe-major runs, the fill tail, runs many tiles long,
    ids out of range, no pairs) with the mask folded in."""
    rng = np.random.default_rng(26)
    v, seg = k6_segment_case(case, 20_000, 301, rng)
    assert (np.diff(seg.astype(np.int64)) >= 0).all()
    w = rng.random(301) < 0.7 if within else None
    want = _reference_fold(v, seg, 301, w, negate) if len(seg) else \
        (np.zeros(301, bool) ^ negate) & (w if w is not None else True)
    got = TK.segment_any(_t(v), _t(seg), 301, within=None if w is None else _t(w),
                         negate=negate)
    np.testing.assert_array_equal(got.numpy(), want)


def _k7_model(values, seg, ns, within, negate, threads, rng, hit=None):
    """csrc/segment.cu step for step in numpy, with its block size as an
    argument: k7_mark's blocks in a random order, each lane storing 1 at
    the hit byte of each true pair's segment (8 pairs a lane) once a run of
    equal ids; then k7_verdict's blocks in a random order, 16 segments a
    lane, each verdict written once from the hit bytes, within and negate,
    and the hit bytes put back to zero.  ``hit`` is the per-stream state
    (zero between calls)."""
    n = len(seg)
    true = values > 0
    hit = np.zeros(-(-ns // 16) * 16, np.uint8) if hit is None else hit
    assert not hit.any(), "the hit bytes must be zero between calls"
    stores = 0
    for t in rng.permutation(-(-n // (threads * 8))):
        for th in range(threads):
            j0 = (t * threads + th) * 8
            last = -1
            for j in range(j0, min(j0 + 8, n)):
                s_ = int(seg[j])
                if not true[j] or s_ < 0 or s_ >= ns or s_ == last:
                    continue
                hit[s_] = 1
                last = s_
                stores += 1
    out = np.full(len(hit), 255, np.uint8)
    for t in rng.permutation(-(-ns // (threads * 16))):
        for th in range(threads):
            s0 = 16 * (t * threads + th)
            if s0 >= ns:
                continue
            h = hit[s0:s0 + 16].copy()
            m = np.ones(16, np.uint8) if within is None else \
                np.pad(within[s0:s0 + 16].astype(np.uint8), (0, max(0, s0 + 16 - ns)))
            assert (out[s0:s0 + 16] == 255).all(), f"segments from {s0} written twice"
            out[s0:s0 + 16] = (h ^ int(negate)) & m
            if h.any():
                hit[s0:s0 + 16] = 0
    assert not hit.any(), "the hit bytes must be zero for the next call"
    assert (out[:ns] != 255).all()
    return out[:ns].astype(bool), stores


@pytest.mark.parametrize("sizes", [128, 8], ids=["card", "small"])
@pytest.mark.parametrize("case", K6_SEGMENT_CASES + SEGMENT_CASES)
def test_k7_kernel_model_matches_reference(case, sizes):
    """The kernels' marking runs, hit bytes and verdict words in numpy, at
    the card's block sizes and at small ones, one state over every fold,
    against the reference's verdict and mask; K6-shaped ids take about one
    store a lane."""
    rng = np.random.default_rng(27)
    if case in K6_SEGMENT_CASES:
        v, seg = k6_segment_case(case, 30_000, 301, rng)
    else:
        v, seg = segment_case(case, 30_000, 301, rng)
    w = rng.random(301) < 0.6
    hit = np.zeros(304, np.uint8)
    for within, negate in FOLDS:
        mask = w if within else None
        got, stores = _k7_model(v, seg, 301, mask, negate, sizes, rng, hit)
        want = _reference_fold(v, seg, 301, mask, negate) if len(seg) else \
            (np.zeros(301, bool) ^ negate) & (mask if mask is not None else True)
        np.testing.assert_array_equal(got, want)
        if case == "k6_pairs" and sizes == 128:
            assert stores <= len(seg) // 8 + 1 + 301, stores  # a lane's runs


# --------------------------------------------------------------------------
# K8: the sort branch of grouped_aggregate
# --------------------------------------------------------------------------


def _assert_agg(got, want, how, dtype):
    if dtype.kind == "f" and how == "sum":
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    else:
        np.testing.assert_array_equal(got, want)


def _run_sort_path(keys, vals, mask, out_capacity):
    jk, jv, jm, jo = JK.grouped_aggregate([jnp.asarray(k) for k in keys],
                                          [(jnp.asarray(v), h) for v, h in vals],
                                          jnp.asarray(mask), out_capacity)
    tk, tv, tm, to = TK.grouped_aggregate([_t(k) for k in keys], [(_t(v), h) for v, h in vals],
                                          _t(mask), out_capacity)
    np.testing.assert_array_equal(tm.numpy(), _np(jm))
    assert (to is None) == (jo is None)
    for g, w in zip(tk, jk):
        assert g.numpy().dtype == _np(w).dtype
        np.testing.assert_array_equal(g.numpy(), _np(w))
    for (v, how), g, w in zip(vals, tv, jv):
        assert g.numpy().dtype == _np(w).dtype
        _assert_agg(g.numpy(), _np(w), how, v.dtype)
    return to, jo


@pytest.mark.parametrize("case", SEG_AGG_CASES)
def test_grouped_aggregate_sort_path_matches(case):
    n = 3001
    keys, vals, mask = seg_agg_case(case, n, np.random.default_rng(25))
    # the operator's size: out_capacity = input capacity, overflow impossible
    to, jo = _run_sort_path(keys, vals, mask, n)
    assert to is None and jo is None


@pytest.mark.parametrize("case", ["q3_keys_decimal_sums", "empty_slots_identities"])
def test_grouped_aggregate_sort_path_overflow_flag(case):
    """out_capacity < n: the flag is raised exactly when the groups do not
    fit (q3's keys give ~700 groups, the other case 6)."""
    keys, vals, mask = seg_agg_case(case, 3001, np.random.default_rng(26))
    for out_capacity in (5, 64, 1024):
        to, jo = _run_sort_path(keys, vals, mask, out_capacity)
        assert bool(to) == bool(jo)


def test_overflow_flag_and_topk_order():
    assert TK.overflow_flag(None).dtype == torch.bool and not bool(TK.overflow_flag(None))
    flag = torch.tensor(True)
    assert TK.overflow_flag(flag) is flag
    rng = np.random.default_rng(27)
    a = rng.integers(-5, 5, 500).astype(np.int64)
    m = rng.random(500) < 0.8
    want = _np(JK.topk_order([(jnp.asarray(a), False)], jnp.asarray(m), 17))
    got = TK.topk_order([(_t(a), False)], _t(m), 17)
    np.testing.assert_array_equal(got.numpy().astype(np.int64), want)


def test_pair_totals_past_int32_stay_exact(monkeypatch):
    """Divergence kept on purpose (ROADMAP.md queue 3): the reference's
    probe_join sums its pair counts in int32, so 50,000 x 50,000 forced
    collisions (2.5e9 pairs) wrap its total negative and mark every slot
    invalid; the port counts in int64.  Both engines' count passes sum in
    int64 and raise CapacityError at JOIN_MAX_CAPACITY (2^26) first, so no
    query reaches the difference."""
    monkeypatch.setenv("BALLISTA_FORCE_HASH_COLLISIONS", "1")
    monkeypatch.setattr(JK, "_FORCE_COLLISIONS", None)
    monkeypatch.setattr(TK, "_FORCE_COLLISIONS", None)
    n = 50_000
    keys = np.arange(n, dtype=np.int64)
    live = np.ones(n, dtype=bool)
    jh, _, _ = JK.build_side_sort([jnp.asarray(keys)], jnp.asarray(live))
    th, _, _ = TK.build_side_sort([_t(keys)], _t(live))
    jr = JK.probe_join(JK.hash64([jnp.asarray(keys)]), jnp.asarray(live), jh, 8)
    tr = TK.probe_join(TK.hash64([_t(keys)]), _t(live), th, 8)
    assert int(tr[3]) == n * n
    assert int(jr[3]) == n * n - (1 << 32)  # int32 wrap
    assert tr[2].all() and not _np(jr[2]).any()
    np.testing.assert_array_equal(tr[0].numpy(), _np(jr[0]))
    np.testing.assert_array_equal(tr[1].numpy(), _np(jr[1]))
