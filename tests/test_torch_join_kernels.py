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
from tests.torch_cases import (JOIN_CASES, SEG_AGG_CASES, SEGMENT_CASES, join_case,
                               seg_agg_case, segment_case)

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
    offsets, against the reference's hi - lo arithmetic."""
    from arrow_ballista_tpu_torch.ops.operators import window_counts

    (jp, jm, jh), (tp, tm, th) = _probe_inputs(case, np.random.default_rng(23))
    lo = jnp.searchsorted(jh, jp, side="left")
    hi = jnp.searchsorted(jh, jp, side="right")
    per_row = _np(jnp.where(jm, hi - lo, 0)).astype(np.int64)
    _, _, offsets, total = TK.probe_counts(tp, tm, th)
    assert int(total) == int(per_row.sum())
    chunk_rows, windows = 400, 4  # 1600 >= 1500 rows
    want = np.bincount(np.arange(per_row.shape[0]) // chunk_rows, weights=per_row,
                       minlength=windows).astype(np.int64)
    np.testing.assert_array_equal(window_counts(offsets, chunk_rows, windows).numpy(), want)


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
