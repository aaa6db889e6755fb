"""The port's CUDA kernels against their plain twins, on the card.

Imports no JAX (the machine with the card has none); run there with
``python -m pytest --noconftest tests/test_torch_cuda.py -q``.  Skips
where torch sees no card: a CUDA kernel has no CPU mode.
"""
import contextlib
import functools

import numpy as np
import pytest
import torch

from arrow_ballista_tpu_torch.ops import kernels as TK
from tests.torch_cases import (BUCKET_CASES, CONCAT_CASES, DENSE_CASES, DISORDER_CASES,
                               FUSED_CHAINS, disorder_case,
                               GATHER_CASES, SEG_CASES, SEG_TILE, bucket_case, seg_case,
                               HASH_CASES, I64_MAX, I64_MIN, INTERVAL_CASES, JOIN_CASES,
                               JOIN_QUERIES, KEEP_CASES, MASK_OPS_CASES,
                               PACK_CASES, PRESORTED_CASES, PROBE_CASES, RADIX_CASES,
                               RANGE_CASES,
                               SEG_AGG_CASES, K6_SEGMENT_CASES, k6_segment_case,
                               SEGMENT_CASES, SETTINGS, SORT_CASES, STANDALONE_SETTINGS,
                               STANDALONE_SQL, UNORDERED, assert_frames_equal, dense_case,
                               edge_days, era_days, find_chain, hand_chain, hand_table,
                               hash_cols,
                               interval_case, interval_keys, join_case, keep_case, mask_case,
                               pad_intervals, presorted_case, probe_case, radix_case,
                               range_case,
                               seg_agg_case,
                               segment_case, sort_case, concat_case, gather_case, pack_case,
                               mask_ops_case)

N = 100_003


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.cuda
@pytest.mark.parametrize("buckets", [None, 7, 16])
def test_hash_kernel_matches_twin(dev, buckets):
    cols = hash_cols("three_mixed", N, np.random.default_rng(1))
    on_card = [_t(c).to(dev) for c in cols]
    if buckets is None:
        got, want = TK.hash64(on_card), TK.hash64_plain([_t(c) for c in cols])
    else:
        got, want = TK.bucket_of(on_card, buckets), TK.bucket_of_plain([_t(c) for c in cols],
                                                                       buckets)
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["random", "all_live", "all_dead", "alternating", "tail_dead"])
def test_compaction_kernel_matches_twin(dev, case):
    m = mask_case(case, N, np.random.default_rng(2))
    assert torch.equal(TK.compaction_order(_t(m).to(dev)).cpu(),
                       TK.compaction_order_plain(_t(m)))


@pytest.mark.cuda
@pytest.mark.parametrize("case", SORT_CASES)
def test_sort_kernel_matches_twin(dev, case):
    keys, mask = sort_case(case, N, np.random.default_rng(3))
    got = TK.sort_order([(_t(a).to(dev), asc) for a, asc in keys], _t(mask).to(dev))
    assert torch.equal(got.cpu(), TK.sort_order_plain([(_t(a), asc) for a, asc in keys], _t(mask)))


# K4 and K5 sizes: 1, 2, half a block, the single-block form's limit and
# an 8,192-row onesweep tile +-1, two and three tiles +-1, and 2^20 past
RADIX_SIZES = [1, 2, 4095, 4097, 8191, 8192, 8193, 2 * 8192 - 1, 2 * 8192 + 1,
               3 * 8192 + 1, 100_003, 1_000_003]


def _sort_on_card(dev, keys, mask):
    """K4 against its twin; the layout it used (computed on the device in
    the single-block form) against sort_layout's."""
    got = TK.sort_order([(_t(a).to(dev), asc) for a, asc in keys], _t(mask).to(dev))
    want = TK.sort_order_plain([(_t(a), asc) for a, asc in keys], _t(mask))
    assert torch.equal(got.cpu(), want)
    plan = TK.radix_plan("sort_order")
    assert plan["layout"] == TK.sort_layout_of([(_t(a), asc) for a, asc in keys], _t(mask))
    return plan


@pytest.mark.cuda
@pytest.mark.parametrize("n", RADIX_SIZES)
def test_sort_kernel_matches_twin_at_every_size(dev, n):
    for case in ("q18_orderkey", "straddle_64"):
        keys, mask, _ = radix_case(case, n, np.random.default_rng(n))
        plan = _sort_on_card(dev, keys, mask)
        assert plan["form"] == ("single_block" if n <= 8192 else "onesweep")
        assert plan["launches"] <= (1 if n <= 8192 else 3 + plan["passes"])


@pytest.mark.cuda
@pytest.mark.parametrize("n", [5000, N])
@pytest.mark.parametrize("case", RADIX_CASES)
def test_sort_kernel_matches_twin_on_wide_and_degenerate_keys(dev, case, n):
    keys, mask, n = radix_case(case, n, np.random.default_rng(11))
    plan = _sort_on_card(dev, keys, mask)
    if case == "all_rows_equal":
        assert plan["bits"] == 0 and plan["passes"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("n", RADIX_SIZES)
@pytest.mark.parametrize("mode", ["random", "forced_collisions", "all_dead"])
def test_build_sort_kernel_matches_twin_at_every_size(dev, monkeypatch, mode, n):
    monkeypatch.setattr(TK, "_FORCE_COLLISIONS", mode == "forced_collisions")
    rng = np.random.default_rng(n)
    keys = [rng.integers(0, max(2, n // 3), n).astype(np.int64),
            rng.integers(-1, 3, n).astype(np.int32)]
    mask = rng.random(n) < (0.0 if mode == "all_dead" else 0.85)
    gh, go, gn = TK.build_side_sort([_t(k).to(dev) for k in keys], _t(mask).to(dev))
    ph, po, pn = TK.build_side_sort_plain([_t(k) for k in keys], _t(mask))
    assert torch.equal(gh.cpu(), ph) and torch.equal(go.cpu(), po) and int(gn) == int(pn)
    plan = TK.radix_plan("build_side_sort")
    assert plan["launches"] <= (1 if n <= 8192 else 2 + plan["passes"])


@pytest.mark.cuda
@pytest.mark.parametrize("case", DENSE_CASES)
def test_dense_kernel_matches_twin(dev, case):
    keys, vals, mask, ranges = dense_case(case, N, np.random.default_rng(4))
    d = TK.dense_domain(ranges)
    gv, ge, gb = TK.dense_group_states([_t(k).to(dev) for k in keys],
                                       [(_t(v).to(dev), h) for v, h in vals],
                                       _t(mask).to(dev), ranges, d)
    pv, pe, pb = TK.dense_group_states_plain([_t(k) for k in keys], [(_t(v), h) for v, h in vals],
                                             _t(mask), ranges, d)
    assert torch.equal(ge.cpu(), pe) and bool(gb) == bool(pb)
    for (v, how), g, p in zip(vals, gv, pv):
        if v.dtype.kind == "f" and how == "sum":  # atomic order differs from the twin's
            np.testing.assert_allclose(g.cpu().numpy(), p.numpy(), rtol=1e-12, atol=0)
        else:  # exact, NaN slots in the same places
            np.testing.assert_array_equal(g.cpu().numpy(), p.numpy())


def _dense_same(got, want, vals):
    """K1's compacted result (keys, values, mask, overflow or None) against
    its twin's: integers, keys, masks and flags exact, float sums at rtol
    1e-12 (the order of additions differs), NaN in the same places."""
    assert (got[3] is None) == (want[3] is None)
    if got[3] is not None:
        assert bool(got[3]) == bool(want[3])
    assert torch.equal(got[2].cpu(), want[2])
    for g, w in zip(got[0], want[0]):
        assert g.dtype == w.dtype and torch.equal(g.cpu(), w)
    for (v, how), g, w in zip(vals, got[1], want[1]):
        assert g.dtype == w.dtype
        if w.dtype.is_floating_point and how == "sum":
            np.testing.assert_allclose(g.cpu().numpy(), w.numpy(), rtol=1e-12, atol=0)
        else:
            np.testing.assert_array_equal(g.cpu().numpy(), w.numpy())


def _dense_grouped_on_card(dev, keys, vals, mask, ranges, cap):
    d = TK.dense_domain(ranges)
    got = TK.dense_grouped([_t(k).to(dev) for k in keys], [(_t(v).to(dev), h) for v, h in vals],
                           _t(mask).to(dev), cap, ranges, d)
    want = TK.dense_grouped_plain([_t(k) for k in keys], [(_t(v), h) for v, h in vals],
                                  _t(mask), cap, ranges, d)
    return got, want


@pytest.mark.cuda
@pytest.mark.parametrize("cap", ["small", "domain", "padded"])
@pytest.mark.parametrize("case", DENSE_CASES)
def test_dense_compacted_kernel_matches_twin(dev, case, cap):
    """K1's compacted form (grouped_aggregate's dense path in one launch):
    out_capacity below the domain (cut, overflow | bad rows), equal to it
    and above it (zero padding)."""
    keys, vals, mask, ranges = dense_case(case, N, np.random.default_rng(41))
    d = TK.dense_domain(ranges)
    out_cap = {"small": max(1, d // 3), "domain": d, "padded": d + 37}[cap]
    got, want = _dense_grouped_on_card(dev, keys, vals, mask, ranges, out_cap)
    _dense_same(got, want, [(_t(v), h) for v, h in vals])


def _dense_shape(rng, n, slots=None, wide=False):
    """Keys, values (every fold), mask and ranges; live rows on ``slots``
    slots of a 289-slot domain (or a 33,153-slot one, too wide for shared
    memory)."""
    ranges = ((-1, 127), (-1, 255)) if wide else ((-1, 15), (-1, 15))
    sizes = [hi - lo + 1 for lo, hi in ranges]
    d = sizes[0] * sizes[1]
    chosen = rng.permutation(d)[:slots or d]
    slot = chosen[rng.integers(0, len(chosen), n)]
    keys = [(slot // sizes[1] + ranges[0][0]).astype(np.int32),
            (slot % sizes[1] + ranges[1][0]).astype(np.int64)]
    # float sums of non-negative values: no cancellation, so the order of
    # additions moves a sum by a few ulps, within rtol 1e-12
    f = rng.random(n) * 100
    f[rng.random(n) < 0.001] = np.nan
    q = (rng.integers(-64, 64, n) / 4).astype(np.float32)
    vals = [(rng.integers(-10**12, 10**12, n).astype(np.int64), "sum"),
            (rng.integers(2**29, 2**31 - 1, n).astype(np.int32), "sum"),
            (f, "sum"), (q, "sum"), (np.zeros(n, np.int64), "count"),
            (rng.integers(-10**12, 10**12, n).astype(np.int64), "min"),
            (rng.integers(-2**31, 2**31 - 1, n).astype(np.int32), "max"), (f, "min"), (f, "max"),
            (q, "min"), (q, "max")]
    return keys, vals, rng.random(n) < 0.8, ranges


@pytest.mark.cuda
@pytest.mark.parametrize("n", [0, 1, 31, 255, 256, 257, 1023, 1025, 4097, 100_003])
def test_dense_kernel_at_edge_sizes(dev, n):
    """No rows, one row, fewer rows than a warp and than a block's pass,
    a pass +-1 and several passes; both forms."""
    rng = np.random.default_rng(42 + n)
    keys, vals, mask, ranges = _dense_shape(rng, n)
    got, want = _dense_grouped_on_card(dev, keys, vals, mask, ranges, 289)
    _dense_same(got, want, [(_t(v), h) for v, h in vals])
    gv, ge, gb = TK.dense_group_states([_t(k).to(dev) for k in keys],
                                       [(_t(v).to(dev), h) for v, h in vals],
                                       _t(mask).to(dev), ranges, 289)
    pv, pe, pb = TK.dense_group_states_plain([_t(k) for k in keys],
                                             [(_t(v), h) for v, h in vals], _t(mask), ranges, 289)
    assert torch.equal(ge.cpu(), pe) and bool(gb) == bool(pb)
    _dense_same(([], gv, ge.cpu() > 0, None), ([], pv, pe > 0, None),
                [(_t(v), h) for v, h in vals])


@pytest.mark.cuda
@pytest.mark.parametrize("slots", [1, 2, 4, 289])
@pytest.mark.parametrize("wide", [False, True], ids=["shared", "global"])
def test_dense_kernel_on_hot_slots(dev, slots, wide):
    """Every live row on one slot (a warp's 32 lanes one group), a few, or
    spread: the warp's combining tree at every depth, in block-private
    shared accumulators and straight in the state."""
    rng = np.random.default_rng(43 + slots)
    keys, vals, mask, ranges = _dense_shape(rng, 300_007, slots, wide)
    d = TK.dense_domain(ranges)
    got, want = _dense_grouped_on_card(dev, keys, vals, mask, ranges, d)
    _dense_same(got, want, [(_t(v), h) for v, h in vals])


def _dense_reset_inputs(rng, count):
    """Calls whose domain, aggregate count, capacity and form shrink and
    grow, so a word one call left behind would show in the next."""
    out = []
    for i in range(count):
        n = int(rng.choice([0, 1, 900, 40_000, 200_000]))
        keys, vals, mask, ranges = _dense_shape(rng, n, int(rng.choice([1, 4, 300])),
                                                wide=i % 7 == 3)
        pick = rng.permutation(len(vals))[:int(rng.integers(0, len(vals) + 1))]
        vals = [vals[j] for j in sorted(pick)]
        if i % 3 == 1:  # a one-key domain of five slots
            keys, ranges = [keys[0] % 5 - 1], ((-1, 3),)
        d = TK.dense_domain(ranges)
        cap = None if i % 4 == 0 else int(rng.choice([1, max(1, d // 2), d, d + 9]))
        out.append((keys, vals, mask, ranges, cap))
    return out


def _dense_reset_launch(dev, inputs):
    results = []
    for keys, vals, mask, ranges, cap in inputs:
        args = ([_t(k).to(dev) for k in keys], [(_t(v).to(dev), h) for v, h in vals],
                _t(mask).to(dev))
        d = TK.dense_domain(ranges)
        results.append(TK.dense_group_states(*args, ranges, d) if cap is None
                       else TK.dense_grouped(*args, cap, ranges, d))
    return results


def _dense_reset_check(inputs, results):
    for (keys, vals, mask, ranges, cap), got in zip(inputs, results):
        args = ([_t(k) for k in keys], [(_t(v), h) for v, h in vals], _t(mask))
        d = TK.dense_domain(ranges)
        tv = [(_t(v), h) for v, h in vals]
        if cap is None:
            pv, pe, pb = TK.dense_group_states_plain(*args, ranges, d)
            assert torch.equal(got[1].cpu(), pe) and bool(got[2]) == bool(pb)
            _dense_same(([], got[0], got[1].cpu() > 0, None), ([], pv, pe > 0, None), tv)
        else:
            _dense_same(got, TK.dense_grouped_plain(*args, cap, ranges, d), tv)


@pytest.mark.cuda
def test_dense_kernel_back_to_back_on_one_stream(dev):
    """200 calls of both forms queued back to back, their domains,
    aggregates and capacities shrinking and growing: each launch's last
    block leaves the stream's state zero for the next."""
    inputs = _dense_reset_inputs(np.random.default_rng(44), 200)
    results = _dense_reset_launch(dev, inputs)
    torch.cuda.synchronize()
    _dense_reset_check(inputs, results)


@pytest.mark.cuda
@pytest.mark.parametrize("own_streams", [False, True])
def test_dense_kernel_from_four_threads(dev, own_streams):
    import threading

    rng = np.random.default_rng(45)
    inputs = [_dense_reset_inputs(rng, 30) for _ in range(4)]
    results = [None] * 4
    start = threading.Barrier(4)

    def work(i):
        ctx = torch.cuda.stream(torch.cuda.Stream(dev)) if own_streams else \
            contextlib.nullcontext()
        with ctx:
            start.wait()
            results[i] = _dense_reset_launch(dev, inputs[i])
            torch.cuda.current_stream(dev).synchronize()

    threads = [threading.Thread(target=work, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    torch.cuda.synchronize()
    for inp, res in zip(inputs, results):
        _dense_reset_check(inp, res)


@pytest.mark.cuda
@pytest.mark.parametrize("case", JOIN_CASES)
def test_build_sort_and_probe_kernels_match_twins(dev, case):
    bk, bmask, pk, pmask = join_case(case, N, N // 2, np.random.default_rng(5))
    gh, go, gn = TK.build_side_sort([_t(k).to(dev) for k in bk], _t(bmask).to(dev))
    ph, po, pn = TK.build_side_sort_plain([_t(k) for k in bk], _t(bmask))
    assert torch.equal(gh.cpu(), ph) and torch.equal(go.cpu(), po) and int(gn) == int(pn)
    probe_hash = TK.hash64([_t(k) for k in pk])
    total = int(TK.probe_counts_plain(probe_hash, _t(pmask), ph)[1])
    for out_cap in sorted({max(1, total // 3), max(1, total), total + 37}):
        got = TK.probe_join(probe_hash.to(dev), _t(pmask).to(dev), gh, out_cap)
        want = TK.probe_join_plain(probe_hash, _t(pmask), ph, out_cap)
        for g, w in zip(got[:3], want[:3]):
            assert torch.equal(g.cpu(), w)
        assert int(got[3]) == int(want[3]) == total


@pytest.mark.cuda
@pytest.mark.parametrize("case", SEGMENT_CASES)
def test_segment_any_kernel_matches_twin(dev, case):
    v, seg = segment_case(case, N, 4099, np.random.default_rng(6))
    got = TK.segment_any(_t(v).to(dev), _t(seg).to(dev), 4099)
    assert torch.equal(got.cpu(), TK.segment_any_plain(_t(v), _t(seg), 4099))


@pytest.mark.cuda
@pytest.mark.parametrize("case", SEG_AGG_CASES)
def test_sort_path_aggregate_kernel_matches_twin(dev, case):
    keys, vals, mask = seg_agg_case(case, N, np.random.default_rng(7))
    for out_cap in (N, 100):  # the operator's size, then one that overflows
        got = TK.grouped_aggregate([_t(k).to(dev) for k in keys],
                                   [(_t(v).to(dev), h) for v, h in vals], _t(mask).to(dev), out_cap)
        want = TK.grouped_aggregate([_t(k) for k in keys], [(_t(v), h) for v, h in vals],
                                    _t(mask), out_cap)
        assert torch.equal(got[2].cpu(), want[2])
        assert (got[3] is None) == (want[3] is None)
        if got[3] is not None:
            assert bool(got[3]) == bool(want[3])
        for g, w in zip(got[0], want[0]):  # NaN keys compare equal here
            np.testing.assert_array_equal(g.cpu().numpy(), w.numpy())
        for (v, how), g, w in zip(vals, got[1], want[1]):
            if v.dtype.kind == "f" and how == "sum":  # atomic order differs from the twin's
                np.testing.assert_allclose(g.cpu().numpy(), w.numpy(), rtol=1e-12, atol=0)
            else:
                assert torch.equal(g.cpu(), w)


@functools.lru_cache(maxsize=1)
def _sf001_tables():
    from benchmarks.datagen import generate_tables

    return generate_tables(0.01, seed=0)


@pytest.mark.cuda
@pytest.mark.parametrize("name, setting", [(q, None) for q in JOIN_QUERIES]
                         + [("q3", s) for s in SETTINGS])
def test_join_queries_on_the_card_match_the_cpu(dev, name, setting):
    """Every join type and the sort-path aggregate, on the card against the
    port on the CPU (which tests/test_torch_joins.py holds against the JAX
    package) at SF0.01."""
    from arrow_ballista_tpu_torch import BallistaContext

    frames = []
    for device in (dev, "cpu"):
        ctx = BallistaContext.local(device=device)
        for table, data in _sf001_tables().items():
            ctx.register_table(table, data)
        if setting is not None:
            ctx.sql(SETTINGS[setting])
        frames.append(ctx.sql(JOIN_QUERIES[name]).to_pandas())
    assert len(frames[1]) > 0
    assert_frames_equal(frames[0], frames[1], ordered=name not in UNORDERED)


@pytest.mark.cuda
@pytest.mark.parametrize("case", PRESORTED_CASES)
def test_presorted_aggregate_kernels_match_twins(dev, case):
    """K2 + K9 + K8: the disorder flag and the groups."""
    keys, vals, mask = presorted_case(case, N, np.random.default_rng(8))
    got = TK.grouped_aggregate_presorted([_t(keys).to(dev)], [(_t(v).to(dev), h) for v, h in vals],
                                         _t(mask).to(dev), N)
    want = TK.grouped_aggregate_presorted([_t(keys)], [(_t(v), h) for v, h in vals], _t(mask), N)
    assert bool(got[4]) == bool(want[4]) == (case == "disordered")
    assert torch.equal(got[2].cpu(), want[2]) and torch.equal(got[0][0].cpu(), want[0][0])
    for (v, how), g, w in zip(vals, got[1], want[1]):
        assert torch.equal(g.cpu(), w)  # quarter values: float sums exact in any order


def _view(dev, a, shift):
    """``a`` on the card, ``shift`` elements past a 16-byte boundary."""
    big = torch.zeros(a.shape[0] + 16, dtype=_t(a).dtype, device=dev)
    big[shift:shift + a.shape[0]] = _t(a).to(dev)
    return big[shift:shift + a.shape[0]]


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2050, 4099, (1 << 20) + 5])
@pytest.mark.parametrize("case", list(DISORDER_CASES))
def test_disorder_kernel_matches_twin(dev, case, n):
    """K9 over the rows as they are: decreases across dead runs and at the
    2,048-row tile edge, dead keys that decrease, extremes, one and two
    live rows, every row dead."""
    keys, mask = disorder_case(case, n, np.random.default_rng(n))
    got = TK.presorted_disorder(_t(keys).to(dev), _t(mask).to(dev))
    want = TK.presorted_disorder_plain(_t(keys), _t(mask))
    assert bool(got) == bool(want) == DISORDER_CASES[case]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_disorder_kernel_at_small_sizes(dev, dtype):
    """0, 1 and 2 rows (one block), and the warp and block tile edges."""
    rng = np.random.default_rng(7)
    for n in (0, 1, 2, 3, 255, 256, 257, 511, 512, 513, 2047, 2048, 2049, 4095, 4096, 4097,
              8193):
        for trial in range(4):
            keys = np.sort(rng.integers(-50, 50, n)).astype(dtype)
            mask = rng.random(n) < (0.5, 0.9, 1.0, 0.1)[trial]
            if n >= 2 and trial % 2:
                i = int(rng.integers(0, n - 1))
                keys[i + 1] = keys[i] - 1
                mask[i:i + 2] = True
            got = TK.presorted_disorder(_t(keys).to(dev), _t(mask).to(dev))
            assert bool(got) == bool(TK.presorted_disorder_plain(_t(keys), _t(mask))), (n, trial)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", range(1, 16))
def test_disorder_kernel_on_views_at_byte_offsets(dev, offset):
    """The mask at byte offsets 1-15 and the keys 4 or 8 bytes off a 16-byte
    boundary (the row-by-row path)."""
    n = 100_003
    for case in ("sorted", "decrease_across_dead_run", "int32_extremes_decrease",
                 "equal_across_dead_row"):
        keys, mask = disorder_case(case, n, np.random.default_rng(offset))
        shift = offset % (16 // keys.dtype.itemsize)
        views = (_view(dev, keys, shift), _view(dev, mask, offset))
        assert views[1].data_ptr() % 16 == offset
        got = TK.presorted_disorder(*views)
        assert bool(got) == bool(TK.presorted_disorder_plain(_t(keys), _t(mask))) == \
            DISORDER_CASES[case]


def _disorder_inputs(rng, calls):
    """Inputs whose flags alternate and whose tile counts change."""
    out = []
    for i in range(calls):
        n = int(rng.integers(0, 300_000))
        keys = np.sort(rng.integers(-2**40, 2**40, n))
        mask = rng.random(n) < rng.random()
        if i % 2 and n > 1:
            j = int(rng.integers(0, n - 1))
            keys[j + 1] = keys[j] - 1
            mask[j:j + 2] = True
        out.append((keys, mask))
    return out


def _disorder_all(dev, inputs):
    staged = [(_t(k).to(dev), _t(m).to(dev)) for k, m in inputs]
    return [TK.presorted_disorder(k, m) for k, m in staged]


def _check_disorder(inputs, results):
    for (k, m), flag in zip(inputs, results):
        assert bool(flag) == bool(TK.presorted_disorder_plain(_t(k), _t(m)))


@pytest.mark.cuda
def test_disorder_kernel_back_to_back_on_one_stream(dev):
    """100 calls queued back to back: each launch's last block puts the
    stream's ticket back, and each tile's record is written before read."""
    inputs = _disorder_inputs(np.random.default_rng(41), 100)
    results = _disorder_all(dev, inputs)
    torch.cuda.synchronize()
    assert len({bool(r) for r in results}) == 2
    _check_disorder(inputs, results)


@pytest.mark.cuda
@pytest.mark.parametrize("own_streams", [False, True])
def test_disorder_kernel_from_four_threads(dev, own_streams):
    """Four threads at once, on the stream they share or a stream each."""
    import threading

    rng = np.random.default_rng(42)
    inputs = [_disorder_inputs(rng, 25) for _ in range(4)]
    results = [None] * 4
    start = threading.Barrier(4)

    def work(i):
        ctx = torch.cuda.stream(torch.cuda.Stream(dev)) if own_streams else \
            contextlib.nullcontext()
        with ctx:
            start.wait()
            results[i] = _disorder_all(dev, inputs[i])
            torch.cuda.current_stream(dev).synchronize()

    threads = [threading.Thread(target=work, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    torch.cuda.synchronize()
    for inp, res in zip(inputs, results):
        _check_disorder(inp, res)


@pytest.mark.cuda
@pytest.mark.parametrize("case", RANGE_CASES)
def test_key_range_check_kernel_matches_twin(dev, case):
    k, mask, lo, hi, sent = range_case(case, N, np.random.default_rng(9))
    got = TK.key_range_check(_t(k).to(dev), _t(mask).to(dev), lo, hi, sent)
    want = TK.key_range_check_plain(_t(k), _t(mask), lo, hi, sent)
    assert bool(got) == bool(want) == (case in ("above", "below", "int32_keys"))


@pytest.mark.cuda
@pytest.mark.parametrize("case", KEEP_CASES)
def test_clustered_keep_kernel_matches_twin(dev, case):
    k, mask, pred, los, his = keep_case(case, N, np.random.default_rng(10))
    gk, gl = TK.clustered_keep(_t(k).to(dev), _t(mask).to(dev), _t(pred).to(dev),
                               TK.KeepIntervals(los, his, dev))
    wk, wl = TK.clustered_keep_plain(_t(k), _t(mask), _t(pred), TK.KeepIntervals(los, his, "cpu"))
    assert torch.equal(gk.cpu(), wk) and int(gl) == int(wl) > 0


# K10 and K11: no rows, less than a lane's 8 rows, a 256-row warp tile -+1
# and a 2,048-row block tile -+1 (the tail row by row), and 2^20 + 5
CLUSTERED_SIZES = [0, 1, 15, 17, 255, 257, 2047, 2049, (1 << 20) + 5]


def _clustered_inputs(n, dtype, rng, live_share=0.7):
    """Keys at their dtype's extremes, a mask, a HAVING predicate and 17
    windows around live keys (with the NULL-sentinel pair), padded."""
    info = np.iinfo(dtype)
    k = rng.integers(info.min, info.max, n, dtype=dtype, endpoint=True)
    k[: min(n, 2)] = [info.min, info.max][: min(n, 2)]
    mask = rng.random(n) < live_share
    pred = rng.random(n) < 0.05
    picks = rng.choice(k, 17).tolist() if n else [0]
    pairs = [(int(a), min(int(a) + 3, int(I64_MAX))) for a in picks] + [(int(I64_MIN),) * 2]
    return k, mask, pred, pad_intervals(pairs)


def _k10_k11_on_card(dev, k, mask, pred, los, his, lo, hi, sent=None, views=None):
    """K10 and K11 on the card (on ``views`` of the inputs when given) and
    their twins on the CPU: ((flag, twin flag), (keep, twin keep), (live,
    twin live))."""
    kd, md, pd_ = views if views is not None else (_t(k).to(dev), _t(mask).to(dev),
                                                    _t(pred).to(dev))
    flag = TK.key_range_check(kd, md, lo, hi, sent)
    keep, live = TK.clustered_keep(kd, md, pd_, TK.KeepIntervals(los, his, dev))
    wflag = TK.key_range_check_plain(_t(k), _t(mask), lo, hi, sent)
    wkeep, wlive = TK.clustered_keep_plain(_t(k), _t(mask), _t(pred),
                                           TK.KeepIntervals(los, his, "cpu"))
    return (bool(flag), bool(wflag)), (keep.cpu(), wkeep), (int(live), int(wlive))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("n", CLUSTERED_SIZES)
def test_clustered_kernels_at_edge_sizes(dev, n, dtype):
    rng = np.random.default_rng(n + 7)
    k, mask, pred, (los, his) = _clustered_inputs(n, dtype, rng)
    info = np.iinfo(dtype)
    live_keys = k[mask]
    for lo, hi in ((int(info.min), int(info.max)), (int(info.min) + 1, int(info.max)),
                   (int(info.min), int(info.max) - 1), (0, 0)):
        (f, wf), (g, w), (c, wc) = _k10_k11_on_card(dev, k, mask, pred, los, his, lo, hi)
        assert f == wf == bool(((live_keys < lo) | (live_keys > hi)).any())
        assert torch.equal(g, w) and c == wc
    dead = np.zeros(n, dtype=bool)  # every row dead: no flag, nothing kept
    (f, wf), (g, w), (c, wc) = _k10_k11_on_card(dev, k, dead, pred, los, his, 0, 0)
    assert f == wf is False and torch.equal(g, w) and c == wc == 0


@pytest.mark.cuda
@pytest.mark.parametrize("offset", range(1, 16))
def test_clustered_kernels_on_views_at_byte_offsets(dev, offset):
    """Mask and predicate at byte offsets 1-15 and keys 4 or 8 bytes off a
    16-byte boundary (the row-by-row path), against the twins."""
    n = 100_003
    for dtype in (np.int32, np.int64):
        rng = np.random.default_rng(offset)
        k, mask, pred, (los, his) = _clustered_inputs(n, dtype, rng)
        kshift = offset % (16 // np.dtype(dtype).itemsize)

        def view(a, shift):
            big = torch.zeros(a.shape[0] + 16, dtype=_t(a).dtype, device=dev)
            big[shift:shift + a.shape[0]] = _t(a).to(dev)
            return big[shift:shift + a.shape[0]]

        views = (view(k, kshift), view(mask, offset), view(pred, 15 - offset))
        assert views[1].data_ptr() % 16 == offset
        info = np.iinfo(dtype)
        for lo, hi in ((int(info.min), int(info.max)), (int(info.min), int(info.max) - 1)):
            (f, wf), (g, w), (c, wc) = _k10_k11_on_card(dev, k, mask, pred, los, his, lo, hi,
                                                        views=views)
            assert f == wf and torch.equal(g, w) and c == wc > 0


@pytest.mark.cuda
@pytest.mark.parametrize("case", INTERVAL_CASES)
def test_clustered_keep_kernel_over_interval_sets(dev, case):
    """Overlapping, touching and nested windows, the pads only, the NULL
    pair, int64's top, and 5,000 merged windows (searched in device memory,
    past the 2,048 in shared memory)."""
    rng = np.random.default_rng(12)
    pairs = interval_case(case, rng)
    los, his = pad_intervals(pairs)
    k = interval_keys(pairs, N, rng)
    n = k.shape[0]
    mask, pred = rng.random(n) < 0.8, rng.random(n) < 0.01
    iv = TK.KeepIntervals(los, his, dev)
    if case == "random_5000":
        assert iv.starts.shape[0] == 5000
    gk, gl = TK.clustered_keep(_t(k).to(dev), _t(mask).to(dev), _t(pred).to(dev), iv)
    wk, wl = TK.clustered_keep_plain(_t(k), _t(mask), _t(pred), TK.KeepIntervals(los, his, "cpu"))
    assert torch.equal(gk.cpu(), wk) and int(gl) == int(wl)


def _reset_inputs(rng, calls):
    """Inputs whose results change from call to call: flags alternate and
    counts differ, so a stale accumulator or ticket would show."""
    out = []
    for i in range(calls):
        n = int(rng.integers(0, 200_000))
        k, mask, pred, (los, his) = _clustered_inputs(n, np.int64, rng, live_share=rng.random())
        lo, hi = (int(I64_MIN), int(I64_MAX)) if i % 2 else (int(I64_MIN) + 1, int(I64_MAX) - 1)
        out.append((k, mask, pred, los, his, lo, hi))
    return out


def _launch_all(dev, inputs):
    """Every call queued with no synchronisation between them."""
    staged = [(_t(k).to(dev), _t(m).to(dev), _t(p).to(dev), TK.KeepIntervals(los, his, dev),
               lo, hi) for k, m, p, los, his, lo, hi in inputs]
    results = []
    for kd, md, pd_, iv, lo, hi in staged:
        results.append((TK.key_range_check(kd, md, lo, hi), *TK.clustered_keep(kd, md, pd_, iv)))
    return results


def _check_reset(inputs, results):
    for (k, m, p, los, his, lo, hi), (flag, keep, live) in zip(inputs, results):
        wk, wl = TK.clustered_keep_plain(_t(k), _t(m), _t(p), TK.KeepIntervals(los, his, "cpu"))
        assert bool(flag) == bool(TK.key_range_check_plain(_t(k), _t(m), lo, hi))
        assert torch.equal(keep.cpu(), wk) and int(live) == int(wl)


@pytest.mark.cuda
def test_clustered_kernels_back_to_back_on_one_stream(dev):
    """100 calls of each, queued back to back: each launch's last block
    puts the stream's accumulator and ticket back for the next."""
    inputs = _reset_inputs(np.random.default_rng(31), 100)
    results = _launch_all(dev, inputs)
    torch.cuda.synchronize()
    assert len({bool(r[0]) for r in results}) == 2 and len({int(r[2]) for r in results}) > 50
    _check_reset(inputs, results)


@pytest.mark.cuda
@pytest.mark.parametrize("own_streams", [False, True])
def test_clustered_kernels_from_four_threads(dev, own_streams):
    """Four threads at once (as the standalone engine's task threads): on
    the one stream they share, or each on a stream of its own (then each
    stream has its own accumulator)."""
    import threading

    rng = np.random.default_rng(32)
    inputs = [_reset_inputs(rng, 25) for _ in range(4)]
    results = [None] * 4
    start = threading.Barrier(4)

    def work(i):
        ctx = torch.cuda.stream(torch.cuda.Stream(dev)) if own_streams else \
            contextlib.nullcontext()
        with ctx:
            start.wait()
            results[i] = _launch_all(dev, inputs[i])
            torch.cuda.current_stream(dev).synchronize()

    threads = [threading.Thread(target=work, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    torch.cuda.synchronize()
    for inp, res in zip(inputs, results):
        _check_reset(inp, res)


# K2: no rows, one, a 16-row word and 8,192 +-1 rows in one launch, the
# one-launch limit (2^17) +-1, the first two-launch tile (8,192 rows) past
# it +-1, 2^18 + 1 and 2^23 + 5
COMPACT_ONE_ROWS = 1 << 17  # csrc/compact.cu CP_ONE_ROWS
COMPACT_SIZES = [0, 1, 17, 8191, 8193, COMPACT_ONE_ROWS - 1, COMPACT_ONE_ROWS,
                 COMPACT_ONE_ROWS + 1, COMPACT_ONE_ROWS + 8191, COMPACT_ONE_ROWS + 8193,
                 (1 << 18) + 1, (1 << 23) + 5]


def _compact_on_card(dev, md):
    """K2 on a card mask (any view) against its twin on the card: the
    permutation, with_count's count, and the call's plan."""
    got, count = TK.compaction_order(md, with_count=True)
    assert count.dtype == torch.int32 and count.device == md.device
    assert torch.equal(got, TK.compaction_order_plain(md)), "permutation differs"
    assert int(count) == int(md.sum())
    return TK.kernel_plan("compaction_order")


def _compact_form(n):
    return "one_launch" if n <= COMPACT_ONE_ROWS else "two_launch"


@pytest.mark.cuda
@pytest.mark.parametrize("n", COMPACT_SIZES)
def test_compaction_kernel_at_every_size(dev, n):
    for case in ("random", "all_live", "all_dead"):
        plan = _compact_on_card(dev, _t(mask_case(case, n, np.random.default_rng(n))).to(dev))
        if n == 0:
            continue
        one = n <= COMPACT_ONE_ROWS
        assert plan == {"form": _compact_form(n), "rows": n, "launches": 1 if one else 2}


@pytest.mark.cuda
@pytest.mark.parametrize("offset", range(1, 16))
def test_compaction_kernel_on_views_at_byte_offsets(dev, offset):
    """Masks viewed at byte offsets 1-15 inside live bytes (the clipped
    first and last words), in both forms."""
    for n in (1, 100_003, COMPACT_ONE_ROWS + 8193):
        m = np.random.default_rng(offset).random(n) < 0.4
        big = torch.ones(n + 32, dtype=torch.bool, device=dev)
        big[offset:offset + n] = _t(m).to(dev)
        view = big[offset:offset + n]
        assert view.data_ptr() % 16 == offset
        assert _compact_on_card(dev, view)["form"] == _compact_form(n)


def _probe_on_card(dev, ph, pm, bh, caps):
    """K6's two wrappers on the card against their twins on the card, at
    each cap: every slot, the total, the offsets; the launches a call."""
    ph, pm, bh = (x.to(dev) if isinstance(x, torch.Tensor) else _t(x).to(dev)
                  for x in (ph, pm, bh))
    for cap in caps:
        got = TK.probe_join(ph, pm, bh, cap)
        assert TK.kernel_plan("probe_join")["launches"] == (2 if cap else 1)
        want = TK.probe_join_plain(ph, pm, bh, cap)
        for g, w in zip(got[:3], want[:3]):
            assert torch.equal(g, w)
        assert int(got[3]) == int(want[3])
    offsets, total = TK.probe_counts(ph, pm, bh, offsets=True)
    woff, wtotal = TK.probe_counts_plain(ph, pm, bh, offsets=True)
    assert torch.equal(offsets, woff) and int(total) == int(wtotal)
    none, only = TK.probe_counts(ph, pm, bh)
    assert none is None and int(only) == int(wtotal)
    assert TK.kernel_plan("probe_join")["launches"] == 1
    return int(wtotal)


def _caps(total):
    return sorted({0, max(1, total // 3), total, total + 37})


# K6: one probe row, a 256-row tile +-1, the switch to 1,024-row tiles
# (135,168 rows) +-1, and 2^23 + 5
PROBE_SIZES = [1, 255, 257, 135_168, 135_169, (1 << 23) + 5]


@pytest.mark.cuda
@pytest.mark.parametrize("n", PROBE_SIZES)
@pytest.mark.parametrize("case", PROBE_CASES)
def test_probe_kernel_at_every_size(dev, case, n):
    """Every edge input (one build row, an all-dead probe, live all-ones
    probe hashes against the dead build tail, forced collisions, row n-1
    dead and live) at each size, caps that truncate, are exact, run past
    the total, and 0."""
    ph, pm, bh = probe_case(case, n, np.random.default_rng(n))
    ph, bh = ph.view(np.int64), bh.view(np.int64)
    total = int(TK.probe_counts_plain(_t(ph).to(dev), _t(pm).to(dev), _t(bh).to(dev))[1])
    caps = _caps(min(total, 1 << 22)) if case != "forced_collisions" else [0, 1 << 20]
    _probe_on_card(dev, ph, pm, bh, caps)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", range(1, 16))
def test_probe_kernel_on_mask_views_at_byte_offsets(dev, offset):
    ph, pm, bh = probe_case("dup_fanout", N, np.random.default_rng(offset))
    big = torch.ones(N + 32, dtype=torch.bool, device=dev)
    big[offset:offset + N] = _t(pm).to(dev)
    view = big[offset:offset + N]
    assert view.data_ptr() % 16 == offset
    total = int(TK.probe_counts_plain(_t(ph.view(np.int64)), _t(pm), _t(bh.view(np.int64)))[1])
    _probe_on_card(dev, _t(ph.view(np.int64)), view, _t(bh.view(np.int64)), _caps(total))


@pytest.mark.cuda
@pytest.mark.parametrize("fanout", [5000, 1 << 20])
def test_probe_kernel_under_forced_collisions(dev, fanout):
    """Every live probe row matches every live build row: one row's pairs
    outnumber its 256-row tile's rows many times over (and, with 2^20 build rows, fill the 2^20 cap
    alone); caps past and short of the total."""
    rng = np.random.default_rng(fanout)
    n_probe = 300
    pm = rng.random(n_probe) < 0.8
    live_b = np.sort(rng.random(fanout) < 0.95)[::-1]  # live first, the dead tail
    bh = np.where(live_b, 0, -1).astype(np.int64)
    ph = np.zeros(n_probe, np.int64)
    total = int(pm.sum()) * int(live_b.sum())
    caps = [1 << 20, total + 11] if total + 11 <= 1 << 23 else [1 << 20]
    assert _probe_on_card(dev, ph, pm, bh, caps) == total


def _k2_k6_inputs(rng, calls):
    """Inputs whose results change from call to call, so that a status word,
    tile counter or ticket left behind would show."""
    out = []
    for _ in range(calls):
        n = int(rng.integers(1, 200_000))
        ph, pm, bh = probe_case("dup_fanout", n, rng, n_build=int(rng.integers(1, 50_000)))
        out.append((ph.view(np.int64), pm, bh.view(np.int64), int(rng.integers(0, 3 * n))))
    return out


def _k2_k6_launch(dev, inputs):
    staged = [(_t(a).to(dev), _t(m).to(dev), _t(b).to(dev), cap) for a, m, b, cap in inputs]
    return [(TK.probe_join(a, m, b, cap), TK.probe_counts(a, m, b, offsets=True),
             TK.compaction_order(m, with_count=True)) for a, m, b, cap in staged]


def _k2_k6_check(inputs, results):
    for (a, m, b, cap), (join, counts, compact) in zip(inputs, results):
        want = TK.probe_join_plain(_t(a), _t(m), _t(b), cap)
        for g, w in zip(join[:3], want[:3]):
            assert torch.equal(g.cpu(), w)
        assert int(join[3]) == int(want[3]) == int(counts[1])
        assert torch.equal(counts[0].cpu(), TK.probe_counts_plain(_t(a), _t(m), _t(b), True)[0])
        assert torch.equal(compact[0].cpu(), TK.compaction_order_plain(_t(m)))
        assert int(compact[1]) == int(m.sum())


@pytest.mark.cuda
def test_probe_and_compaction_back_to_back_on_one_stream(dev):
    """100 calls of each, queued back to back: each K6 launch's last block
    leaves the stream's state zero for the next, K2's count pass writes
    every status word it reads."""
    inputs = _k2_k6_inputs(np.random.default_rng(41), 100)
    results = _k2_k6_launch(dev, inputs)
    torch.cuda.synchronize()
    _k2_k6_check(inputs, results)


@pytest.mark.cuda
@pytest.mark.parametrize("own_streams", [False, True])
def test_probe_and_compaction_from_four_threads(dev, own_streams):
    import threading

    rng = np.random.default_rng(42)
    inputs = [_k2_k6_inputs(rng, 25) for _ in range(4)]
    results = [None] * 4
    start = threading.Barrier(4)

    def work(i):
        ctx = torch.cuda.stream(torch.cuda.Stream(dev)) if own_streams else \
            contextlib.nullcontext()
        with ctx:
            start.wait()
            results[i] = _k2_k6_launch(dev, inputs[i])
            torch.cuda.current_stream(dev).synchronize()

    threads = [threading.Thread(target=work, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    torch.cuda.synchronize()
    for inp, res in zip(inputs, results):
        _k2_k6_check(inp, res)


@pytest.fixture(scope="module")
def sf001_parquet(tmp_path_factory):
    import pyarrow.parquet as pq

    from benchmarks.tpch import decimal_to_int64_storage

    d = tmp_path_factory.mktemp("tpch")
    for name, t in _sf001_tables().items():
        pq.write_table(decimal_to_int64_storage(t), str(d / f"{name}.parquet"),
                       row_group_size=8192)
    return str(d)


def _cached_fingerprints(dev):
    from arrow_ballista_tpu_torch.utils import table_cache

    return {(key, i, name): (t.data_ptr(), int(t.view(torch.int64).sum()))
            for key, bs in table_cache.CACHE.entries() if key[0] == str(dev)
            for i, b in enumerate(bs) for name, t in [*b.columns.items(), ("mask", b.mask)]}


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["q1", "q3", "q4", "q18"])
def test_parquet_queries_on_the_card_match_the_cpu(dev, sf001_parquet, name):
    """The parquet scan, the scan cache and (q18) the clustered aggregate
    on the card against the port on the CPU (which tests/test_torch_parquet.py
    and tests/test_torch_clustered.py hold against the JAX package); the
    warm run hits the cache and leaves the cached tensors as they were."""
    import os

    from arrow_ballista_tpu_torch import BallistaContext
    from benchmarks.queries import QUERIES

    sql = QUERIES[int(name[1:])].replace("> 300", "> 200")
    frames = []
    for device in (dev, "cpu"):
        ctx = BallistaContext.local(device=device)
        for table in ("lineitem", "orders", "customer"):
            ctx.register_parquet(table, os.path.join(sf001_parquet, f"{table}.parquet"))
        frames.append(ctx.sql(sql).to_pandas())
        if device is dev:
            before = _cached_fingerprints(dev)
            assert_frames_equal(ctx.sql(sql).to_pandas(), frames[0])
            assert _cached_fingerprints(dev) == before
    assert len(frames[1]) > 0
    assert_frames_equal(frames[0], frames[1])


# --------------------------------------------------------------------------
# K12 / K13: the kernels generated per fused chain, and the standalone engine
# --------------------------------------------------------------------------


def _port_chain(name, device):
    from arrow_ballista_tpu_torch.catalog import MemoryTable, SchemaCatalog
    from arrow_ballista_tpu_torch.models import expr as E
    from arrow_ballista_tpu_torch.ops import operators as O
    from arrow_ballista_tpu_torch.scheduler.physical_planner import PhysicalPlanner
    from arrow_ballista_tpu_torch.sql.optimizer import optimize
    from arrow_ballista_tpu_torch.sql.parser import parse_sql
    from arrow_ballista_tpu_torch.sql.planner import SqlToRel
    from arrow_ballista_tpu_torch.utils.config import BallistaConfig

    sql, kind = FUSED_CHAINS[name]
    if sql is None:
        return hand_chain(E, O, MemoryTable("t", hand_table()).scan(None, [], 2))
    cat = SchemaCatalog()
    for t, table in _sf001_tables().items():
        cat.register(MemoryTable(t, table))
    planned = PhysicalPlanner(cat, BallistaConfig(STANDALONE_SETTINGS), device).plan_query(
        optimize(SqlToRel(cat).plan(parse_sql(sql))))
    return find_chain(planned.plan, kind)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(FUSED_CHAINS))
def test_fused_kernels_match_their_twins(dev, name):
    """K12 (row chains) and K13 (aggregate chains: q1 on the dense path,
    q18 on the sort path) against the interpreted chain on the same inputs
    on the card: every output column and the mask (K12), every group
    (K13); exact (no float sums in these chains)."""
    from arrow_ballista_tpu_torch.compile import fused as F
    from arrow_ballista_tpu_torch.ops.physical import TaskContext

    ops = _port_chain(name, dev)
    ctx = TaskContext(device=dev)
    tf = F.FusedStageExec(ops)
    prog = tf.program(ctx)
    TK.reset_launch_counts()
    for p in range(tf.output_partition_count()):
        batches = tf.input.execute(p, ctx)
        if prog.agg is None:
            for b in batches:
                auxs, _ = prog.auxs_and_dicts(b.dicts)
                got_cols, got_mask = F.fused_rows(prog, b.columns, b.mask, auxs)
                want_cols, want_mask = F.fused_rows_plain(prog, b.columns, b.mask, auxs)
                assert torch.equal(got_mask, want_mask)
                for col, t in want_cols.items():
                    assert torch.equal(got_cols[col], t) or (
                        t.dtype.is_floating_point and torch.equal(got_cols[col].isnan(), t.isnan())
                        and torch.equal(got_cols[col][~t.isnan()], t[~t.isnan()])), col
        else:
            from arrow_ballista_tpu_torch.models.batch import concat_batches

            big = concat_batches(tf.input.schema, batches, device=dev).shrink()
            auxs, dicts = prog.auxs_and_dicts(big.dicts)
            ranges = prog.agg._key_ranges(prog.agg_compiled[1], dicts)
            cap = big.capacity
            got = F.fused_agg(prog, big.columns, big.mask, auxs, cap, ranges)
            want = F.fused_agg_plain(prog, big.columns, big.mask, auxs, cap, ranges)
            assert torch.equal(got[2], want[2])
            for g, w in zip(list(got[0]) + list(got[1]), list(want[0]) + list(want[1])):
                assert torch.equal(g, w)
    assert TK.LAUNCHES[prog.launch_name] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("source", ["mem", "pq"])
def test_standalone_q1_on_the_card_matches_the_cpu(dev, sf001_parquet, source):
    """The standalone engine (stages, shuffle files, K13 on q1's partial)
    on the card against the same engine on the CPU."""
    import os

    from arrow_ballista_tpu_torch import BallistaConfig, BallistaContext

    frames = []
    for device in (dev, "cpu"):
        ctx = BallistaContext.standalone(BallistaConfig(STANDALONE_SETTINGS), device=device)
        try:
            for table in ("lineitem", "orders", "customer"):
                if source == "pq":
                    ctx.register_parquet(table, os.path.join(sf001_parquet, f"{table}.parquet"))
                else:
                    ctx.register_table(table, _sf001_tables()[table])
            TK.reset_launch_counts()
            frames.append(ctx.sql(STANDALONE_SQL["q1"]).to_pandas())
            if device is dev:
                assert TK.LAUNCHES["fused_agg"] == 4
        finally:
            ctx.shutdown()
    assert_frames_equal(frames[0], frames[1])


# --------------------------------------------------------------------------
# K14 EXTRACT, K15 passthrough states, K16 spill partitions
# --------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("field", ["year", "month", "day"])
def test_extract_kernel_matches_twin(dev, field):
    rng = np.random.default_rng(14)
    days = np.concatenate([edge_days(), rng.integers(-2 ** 31, 2 ** 31 - 1, N)]).astype(np.int32)
    TK.reset_launch_counts()
    got = TK.extract_field(_t(days).to(dev), field)
    assert TK.LAUNCHES["extract_field"] == 1 and got.dtype == torch.int32
    assert torch.equal(got.cpu(), TK.extract_field_plain(_t(days), field))


@pytest.mark.cuda
@pytest.mark.parametrize("field", ["year", "month", "day"])
def test_extract_kernel_matches_twin_on_the_era_days(dev, field):
    """The civil core's 32-bit form after the era, at every 100th era
    boundary and both ends of int32: the whole array, a view one row in,
    and its first and last 1-9 rows."""
    days = _t(era_days())
    want = TK.extract_field_plain(days, field)
    on_card = days.to(dev)
    assert torch.equal(TK.extract_field(on_card, field).cpu(), want)
    assert torch.equal(TK.extract_field(on_card[1:], field).cpu(), want[1:])
    for n in range(1, 10):
        assert torch.equal(TK.extract_field(on_card[-n:], field).cpu(), want[-n:])
        assert torch.equal(TK.extract_field(on_card[:n], field).cpu(), want[:n])


@pytest.mark.cuda
@pytest.mark.parametrize("forced", [False, True])
@pytest.mark.parametrize("case", HASH_CASES)
def test_spill_partition_kernel_matches_twin(dev, case, forced):
    cols = hash_cols(case, N, np.random.default_rng(16))
    was = TK._FORCE_COLLISIONS
    TK._FORCE_COLLISIONS = forced
    try:
        got = TK.spill_partition([_t(c).to(dev) for c in cols], 8)
        want = TK.spill_partition_plain([_t(c) for c in cols], 8)
    finally:
        TK._FORCE_COLLISIONS = was
    assert torch.equal(got.cpu(), want)


# K16's ordered form: one row, a word, the one-launch limit (2^17) +-1 and
# 2^20 + 3 (the standalone engine's batch, two launches)
SPILL_ORDER_SIZES = [1, 17, COMPACT_ONE_ROWS - 1, COMPACT_ONE_ROWS, COMPACT_ONE_ROWS + 1,
                     (1 << 20) + 3]


def _spill_order_on_card(dev, cols, mask, parts):
    """K16's ordered form on the card against its twin on the CPU: the
    partitions, the order, the count; the call's plan."""
    got = TK.spill_order([_t(c).to(dev) for c in cols], _t(mask).to(dev), parts)
    plan = TK.kernel_plan("spill_order")
    want = TK.spill_order_plain([_t(c) for c in cols], _t(mask), parts)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and torch.equal(g.cpu(), w)
    return plan


@pytest.mark.cuda
@pytest.mark.parametrize("n", SPILL_ORDER_SIZES)
def test_spill_order_kernel_at_every_size(dev, n):
    rng = np.random.default_rng(n)
    cols = [rng.integers(-2**40, 2**40, n).astype(np.int64)]
    for case in ("random", "all_live", "all_dead"):
        for parts in (2, 8):
            plan = _spill_order_on_card(dev, cols, mask_case(case, n, rng), parts)
            one = n <= COMPACT_ONE_ROWS
            assert plan == {"form": _compact_form(n), "rows": n, "launches": 1 if one else 2}


@pytest.mark.cuda
@pytest.mark.parametrize("forced", [False, True])
@pytest.mark.parametrize("case", HASH_CASES)
def test_spill_order_kernel_matches_twin(dev, case, forced):
    """Keys of every kind K3 hashes (NULL codes, int64 extremes, bools,
    three columns), forced collisions (every row in partition 0), in both
    forms."""
    was = TK._FORCE_COLLISIONS
    TK._FORCE_COLLISIONS = forced
    try:
        for n in (N, COMPACT_ONE_ROWS + 8193):
            rng = np.random.default_rng(17)
            _spill_order_on_card(dev, hash_cols(case, n, rng), rng.random(n) < 0.6, 8)
    finally:
        TK._FORCE_COLLISIONS = was


@pytest.mark.cuda
def test_spill_order_on_mask_and_key_views_at_byte_offsets(dev):
    for offset in (1, 7, 15):
        for n in (1000, COMPACT_ONE_ROWS + 5):
            rng = np.random.default_rng(offset)
            m = rng.random(n) < 0.5
            big = torch.ones(n + 32, dtype=torch.bool, device=dev)
            big[offset:offset + n] = _t(m).to(dev)
            keys = _t(rng.integers(0, 99, n + 1).astype(np.int32)).to(dev)[1:]
            got = TK.spill_order([keys], big[offset:offset + n], 4)
            want = TK.spill_order_plain([keys.cpu()], _t(m), 4)
            for g, w in zip(got, want):
                assert torch.equal(g.cpu(), w)


# K7: the verdict with the mask folded in (within, negate)
FOLDS = [(False, False), (True, False), (True, True), (False, True)]


def _segment_on_card(dev, v, seg, ns, within, negate, w_mask=None):
    w = w_mask if w_mask is not None else (
        np.random.default_rng(ns).random(ns) < 0.7 if within else None)
    wd = None if w is None else (w if isinstance(w, torch.Tensor) else _t(w).to(dev))
    vd = v if isinstance(v, torch.Tensor) else _t(v).to(dev)
    got = TK.segment_any(vd, _t(seg).to(dev), ns, within=wd, negate=negate)
    assert TK.kernel_plan("segment_any")["launches"] == (2 if len(seg) else 1)
    want = TK.segment_any_plain(vd.cpu(), _t(seg), ns, None if wd is None else wd.cpu(), negate)
    assert got.shape == (ns,) and torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("within, negate", FOLDS)
@pytest.mark.parametrize("case", SEGMENT_CASES)
def test_segment_any_kernel_folded_matches_twin(dev, case, within, negate):
    for n, ns in ((N, 4099), ((1 << 20) + 5, 100_003), (7, 1)):
        v, seg = segment_case(case, n, ns, np.random.default_rng(n))
        _segment_on_card(dev, v, seg, ns, within, negate)


@pytest.mark.cuda
@pytest.mark.parametrize("within, negate", FOLDS)
@pytest.mark.parametrize("case", K6_SEGMENT_CASES)
def test_segment_any_kernel_on_k6_ids_matches_twin(dev, case, within, negate):
    """K6-shaped ids: probe-major pairs and the fill tail, runs many tiles
    long whose only true value comes late, ids out of range, few pairs over
    many segments (more words than the writing tiles take in one round), no
    pairs."""
    for n, ns in ((N, 4099), ((1 << 21) + 5, 100_003), ((1 << 20) + 5, 300), (5, 1),
                  (70_000, 1_000_003)):
        v, seg = k6_segment_case(case, n, ns, np.random.default_rng(n))
        _segment_on_card(dev, v, seg, ns, within, negate)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["k6_pairs", "out_of_range_ids"])
def test_segment_any_on_views_at_byte_offsets(dev, case):
    rng = np.random.default_rng(3)
    n, ns = 50_000, 20_011
    v, seg = k6_segment_case(case, n, ns, rng)
    for offset in (1, 4, 9, 15):
        vb = torch.zeros(n + 32, dtype=torch.bool, device=dev)
        vb[offset:offset + n] = _t(v).to(dev)
        wb = torch.zeros(ns + 32, dtype=torch.bool, device=dev)
        wm = rng.random(ns) < 0.5
        wb[offset:offset + ns] = _t(wm).to(dev)
        _segment_on_card(dev, vb[offset:offset + n], seg, ns, True, offset % 2 == 1,
                         w_mask=wb[offset:offset + ns])


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["k6_pairs", "unordered"])
def test_folded_verdict_queues_only_k7(dev, case):
    """A folded verdict queues K7's two kernels and nothing else: no clear
    kernel, no memset, no K22 launch and no torch op after it."""
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import queued_torch_ops

    rng = np.random.default_rng(5)
    v, seg = k6_segment_case("k6_pairs", 1 << 20, 300_000, rng)
    if case == "unordered":
        seg = rng.permutation(seg)
    vd, sd = _t(v).to(dev), _t(seg).to(dev)
    wd = _t(np.random.default_rng(6).random(300_000) < 0.5).to(dev)

    def call():
        return TK.segment_any(vd, sd, 300_000, within=wd, negate=True)

    call()
    torch.cuda.synchronize()
    before = dict(TK.LAUNCHES)
    with queued_torch_ops() as host:
        call()
    assert host.ops == []
    assert {k: v - before[k] for k, v in TK.LAUNCHES.items() if v != before[k]} == \
        {"segment_any": 1}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(20_000_000)
        torch.cuda.synchronize()
        for _ in range(10):
            call()
        torch.cuda.synchronize()
    rows = [(e.key, e.count) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and "spin_kernel" not in e.key
            and (getattr(e, "self_device_time_total", 0) or 0) > 0]
    assert all(("k7_mark" in k or "k7_verdict" in k) and c <= 10 for k, c in rows), rows


def _k16_k7_inputs(rng, calls):
    """Growing and shrinking sizes, partition counts and segment counts, so
    that a hit byte or a count left behind would show."""
    sizes = [(1 << 20) + 3, 5, COMPACT_ONE_ROWS + 1, 1000, 1 << 19, 3, (1 << 18) + 7, 64]
    out = []
    for i in range(calls):
        n = sizes[i % len(sizes)] if i % 3 else int(rng.integers(1, 300_000))
        parts = (2, 4, 8)[i % 3]
        keys = rng.integers(0, 5000, n).astype(np.int64)
        mask = rng.random(n) < 0.6
        ns = int(rng.integers(1, max(2, n // 2)))
        v, seg = k6_segment_case("long_runs_late_hit" if i % 4 == 0 else "k6_pairs", n, ns,
                                     rng)
        w = rng.random(ns) < 0.5
        out.append((keys, mask, parts, v, seg, ns, w, bool(i % 2)))
    return out


def _k16_k7_launch(dev, inputs):
    staged = [(_t(k).to(dev), _t(m).to(dev), p, _t(v).to(dev), _t(s).to(dev), ns, _t(w).to(dev),
               neg) for k, m, p, v, s, ns, w, neg in inputs]
    return [(TK.spill_order([k], m, p),
             TK.segment_any(v, s, ns, within=w, negate=neg))
            for k, m, p, v, s, ns, w, neg in staged]


def _k16_k7_check(inputs, results):
    for (k, m, p, v, s, ns, w, neg), (order, verdict) in zip(inputs, results):
        want = TK.spill_order_plain([_t(k)], _t(m), p)
        for g, x in zip(order, want):
            assert torch.equal(g.cpu(), x)
        assert torch.equal(verdict.cpu(), TK.segment_any_plain(_t(v), _t(s), ns, _t(w), neg))


@pytest.mark.cuda
def test_spill_order_and_segment_any_back_to_back_on_one_stream(dev):
    """60 calls of each, queued back to back on one stream: K7 leaves the
    stream's hit bytes zero, and neither kernel reads what a call before
    it wrote, for a larger or smaller call next."""
    inputs = _k16_k7_inputs(np.random.default_rng(43), 60)
    results = _k16_k7_launch(dev, inputs)
    torch.cuda.synchronize()
    _k16_k7_check(inputs, results)


@pytest.mark.cuda
@pytest.mark.parametrize("own_streams", [False, True])
def test_spill_order_and_segment_any_from_four_threads(dev, own_streams):
    import threading

    rng = np.random.default_rng(44)
    inputs = [_k16_k7_inputs(rng, 12) for _ in range(4)]
    results = [None] * 4
    start = threading.Barrier(4)

    def work(i):
        ctx = torch.cuda.stream(torch.cuda.Stream(dev)) if own_streams else \
            contextlib.nullcontext()
        with ctx:
            start.wait()
            results[i] = _k16_k7_launch(dev, inputs[i])
            torch.cuda.current_stream(dev).synchronize()

    threads = [threading.Thread(target=work, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    torch.cuda.synchronize()
    for inp, res in zip(inputs, results):
        _k16_k7_check(inp, res)


@pytest.mark.cuda
def test_segment_any_from_eight_streams_at_once(dev):
    """Eight threads, each on its own stream, queue large K7 calls at once
    (the standalone engine's task streams): each stream's hit bytes are
    its own."""
    import threading

    rng = np.random.default_rng(45)
    inputs = []
    for i in range(8):
        ns = 1_000_003 + i
        v, seg = k6_segment_case("k6_pairs", (1 << 21) + i, ns, rng)
        if i % 2:
            seg = rng.permutation(seg)
        inputs.append((v, seg, ns, rng.random(ns) < 0.5, bool(i % 3)))
    results = [None] * 8
    start = threading.Barrier(8)

    def work(i):
        v, seg, ns, w, neg = inputs[i]
        with torch.cuda.stream(torch.cuda.Stream(dev)):
            vd, sd, wd = _t(v).to(dev), _t(seg).to(dev), _t(w).to(dev)
            start.wait()
            results[i] = [TK.segment_any(vd, sd, ns, within=wd, negate=neg) for _ in range(4)]
            torch.cuda.current_stream(dev).synchronize()

    threads = [threading.Thread(target=work, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for (v, seg, ns, w, neg), got in zip(inputs, results):
        want = TK.segment_any_plain(_t(v), _t(seg), ns, _t(w), neg)
        for g in got:
            assert torch.equal(g.cpu(), want)


@pytest.mark.cuda
def test_spill_split_is_one_launch_and_no_compaction(dev):
    """The spill split of a 2^17-row build batch: one K16 launch and the
    pack's gather, no K2; the runs' rows as the CPU's."""
    from arrow_ballista_tpu_torch.models.batch import ColumnBatch
    from arrow_ballista_tpu_torch.models.schema import FLOAT64, INT64, Field, Schema

    rng = np.random.default_rng(8)
    n = COMPACT_ONE_ROWS
    schema = Schema([Field("k", INT64), Field("x", FLOAT64)])
    host = {"k": rng.integers(0, 10**6, n).astype(np.int64), "x": rng.normal(size=n)}
    mask = rng.random(n) < 0.7
    frames = []
    for device in (dev, torch.device("cpu")):
        cols = {k: _t(a).to(device) for k, a in host.items()}
        batch = ColumnBatch(schema, cols, _t(mask).to(device), {})
        TK.reset_launch_counts()
        part, order, count = TK.spill_order([cols["k"]], batch.mask, 8)
        out, rows = batch.packed_numpy(extra32={"__part": part}, order=(order, count))
        if device.type == "cuda":
            assert TK.LAUNCHES["spill_order"] == 1 and TK.LAUNCHES["compaction_order"] == 0
            assert TK.kernel_plan("spill_order")["launches"] == 1
        frames.append((out, rows))
    (a, na), (b, nb) = frames
    assert na == nb == int(mask.sum())
    for name in ("k", "x", "__part"):
        np.testing.assert_array_equal(a[name], b[name])


@pytest.mark.cuda
@pytest.mark.parametrize("nulls", [False, True], ids=["plain", "nulls"])
def test_passthrough_kernel_matches_twin(dev, nulls):
    """K15, generated for an aggregate with count(*), count, sum, min and
    max over NULL keys and values, against its twin on the same batch."""
    import pyarrow as pa

    from arrow_ballista_tpu_torch.compile import fused as F
    from arrow_ballista_tpu_torch.models import expr as E
    from arrow_ballista_tpu_torch.models.schema import FLOAT64, INT32, INT64, Field, Schema
    from arrow_ballista_tpu_torch.ops import operators as O
    from arrow_ballista_tpu_torch.ops.physical import MemoryScanExec, TaskContext

    rng = np.random.default_rng(15)
    n = 200_000

    def col(values, typ):
        return pa.array(np.where(rng.random(n) < 0.1, None, values) if nulls else values,
                        type=typ)

    table = pa.table({"k": col(rng.integers(-5, 2 ** 40, n), pa.int64()),
                      "k2": col(rng.integers(0, 9, n).astype(np.int32), pa.int32()),
                      "v": col(rng.integers(-100, 100, n), pa.int64()),
                      "x": col(rng.normal(size=n), pa.float64())})
    schema = Schema([Field("k", INT64, nulls), Field("k2", INT32, nulls),
                     Field("v", INT64, nulls), Field("x", FLOAT64, nulls)])
    agg = O.HashAggregateExec(
        MemoryScanExec(schema, table, partitions=1), [(E.Column("k"), "k"), (E.Column("k2"), "k2")],
        [O.AggSpec("count", None, "n"), O.AggSpec("count", E.Column("v"), "nv"),
         O.AggSpec("sum", E.Column("v"), "s"), O.AggSpec("min", E.Column("x"), "lo"),
         O.AggSpec("max", E.Column("k2"), "hi")], mode="partial")
    ctx = TaskContext(device=dev)
    prog = F.PassthroughProgram(agg, ctx)
    batch = agg.input.execute(0, ctx)[0]
    aux = prog.compiled[0].aux_arrays(batch.dicts)
    TK.reset_launch_counts()
    got = F.passthrough_rows(prog, batch.columns, batch.mask, aux)
    want = F.passthrough_rows_plain(prog, batch.columns, batch.mask, aux)
    assert TK.LAUNCHES["passthrough_rows"] == 1
    assert list(got) == list(want)
    for name, column in prog.aliases.items():  # the keys, and states that are a column
        assert got[name] is batch.columns[column] and want[name] is got[name], name
    for name, w in want.items():
        np.testing.assert_array_equal(got[name].cpu().numpy(),
                                      w.expand(batch.capacity).cpu().numpy(), err_msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("q", [3, 18, 21])
def test_spilled_queries_on_the_card_match_the_cpu(dev, q):
    """A 1 MiB host budget with partitioned joins: the aggregates and the
    joins spill (K16's ordered form on the joins' build sides) on the card
    and equal the unlimited run on the CPU."""
    from arrow_ballista_tpu_torch import BallistaConfig, BallistaContext
    from arrow_ballista_tpu_torch.memory import STATS
    from benchmarks.queries import QUERIES

    conf = {"ballista.shuffle.partitions": "4", "ballista.join.broadcast_threshold": "0"}
    frames = []
    for device, budget in ((dev, "1048576"), ("cpu", "0")):
        ctx = BallistaContext.local(BallistaConfig({**conf, "ballista.memory.host.budget.bytes":
                                                    budget}), device=device)
        for name, table in _sf001_tables().items():
            ctx.register_table(name, table)
        STATS.reset()
        TK.reset_launch_counts()
        frames.append(ctx.sql(QUERIES[q]).to_pandas())
        if device is dev:
            snap = STATS.snapshot()
            assert snap.get("spill_runs_total", 0) > 0 and snap["reserved_bytes.host"] == 0
            assert TK.LAUNCHES["spill_order"] > 0
    assert_frames_equal(frames[0], frames[1])


def _dispatch_cols(rng, n):
    return {"i64": rng.integers(-2**62, 2**62, n), "f64": rng.random(n),
            "i32": rng.integers(-9, 9, n).astype(np.int32), "b": rng.random(n) < 0.5,
            "f32": rng.random(n).astype(np.float32)}


def _dispatch_on_card(dev, cols, dest, mask, n_dest, cap):
    return TK.dispatch_to_buckets({k: _t(v).to(dev) for k, v in cols.items()}, _t(dest).to(dev),
                                  _t(mask).to(dev), n_dest, cap)


def _assert_dispatch(got, cols, dest, mask, n_dest, cap):
    """Every buffer slot, the mask, the counts and the flag, bit for bit
    (the floats compared as their bits)."""
    want = TK.dispatch_to_buckets_plain({k: _t(v) for k, v in cols.items()}, _t(dest), _t(mask),
                                        n_dest, cap)
    for k, w in want[0].items():
        g = got[0][k].cpu()
        if w.dtype.is_floating_point:
            g, w = g.view(torch.int64 if w.element_size() == 8 else torch.int32), \
                w.view(torch.int64 if w.element_size() == 8 else torch.int32)
        assert torch.equal(g, w), k
    assert torch.equal(got[1].cpu(), want[1]) and torch.equal(got[3].cpu(), want[3])
    assert bool(got[2]) == bool(want[2])
    return want


@pytest.mark.cuda
@pytest.mark.parametrize("overflow", [False, True], ids=["fits", "overflows"])
@pytest.mark.parametrize("n_dest", [1, 2, 3, 4, 8, 64])
def test_dispatch_kernel_matches_twin(dev, n_dest, overflow):
    """K17: send buffers, masks, counts and the overflow flag bit for bit;
    one count launch and one scatter launch a call."""
    rng = np.random.default_rng(n_dest)
    n = 300_007
    dest = rng.integers(0, n_dest, n).astype(np.int32)
    mask = rng.random(n) < 0.8
    cols = _dispatch_cols(rng, n)
    counts = np.bincount(dest[mask], minlength=n_dest)
    cap = int(counts.max()) - 5 if overflow else int(counts.max()) + 11
    got = _dispatch_on_card(dev, cols, dest, mask, n_dest, cap)
    assert TK.kernel_plan("dispatch_to_buckets")["launches"] == 2
    _assert_dispatch(got, cols, dest, mask, n_dest, cap)
    assert bool(got[2]) == overflow


@pytest.mark.cuda
@pytest.mark.parametrize("cap", ["below", "above"])
@pytest.mark.parametrize("n_dest", [1, 3, 64])
@pytest.mark.parametrize("n", [0, 1, 4095, 4096, 4097, 8193])
def test_dispatch_kernel_at_tile_edges(dev, n, n_dest, cap):
    """Zero rows, one, and the 2,048-row tile's multiples +-1; capacities
    below and above the largest count; destinations outside [0, n_dest)
    dropped."""
    rng = np.random.default_rng(n + n_dest)
    dest = rng.integers(-1, n_dest + 1, n).astype(np.int32)
    mask = rng.random(n) < 0.9
    cols = _dispatch_cols(rng, n)
    most = int(np.bincount(dest[mask & (dest >= 0) & (dest < n_dest)], minlength=n_dest).max()) \
        if n else 0
    c = max(1, most - 2) if cap == "below" else most + 3
    _assert_dispatch(_dispatch_on_card(dev, cols, dest, mask, n_dest, c), cols, dest, mask,
                     n_dest, c)


@pytest.mark.cuda
@pytest.mark.parametrize("n_dest", [1, 4, 64])
def test_dispatch_kernel_with_every_row_dead(dev, n_dest):
    """No row lands: every slot and the mask zero, the counts zero."""
    rng = np.random.default_rng(9)
    n = 10_007
    dest = rng.integers(0, n_dest, n).astype(np.int32)
    cols = _dispatch_cols(rng, n)
    mask = np.zeros(n, dtype=bool)
    want = _assert_dispatch(_dispatch_on_card(dev, cols, dest, mask, n_dest, 777), cols, dest,
                            mask, n_dest, 777)
    assert not bool(want[1].any())


@pytest.mark.cuda
@pytest.mark.parametrize("offset", range(1, 16))
def test_dispatch_kernel_on_views_at_byte_offsets(dev, offset):
    """The mask and the 1-byte column at byte offsets 1-15, dest and the
    4-byte column 4, 8 or 12 bytes off a 16-byte boundary (the row-by-row
    loads and the column stage's element path)."""
    rng = np.random.default_rng(100 + offset)
    n, n_dest = 50_001, 4
    dest = rng.integers(0, n_dest, n).astype(np.int32)
    mask = rng.random(n) < 0.7
    cols = _dispatch_cols(rng, n)
    cap = int(np.bincount(dest[mask], minlength=n_dest).max()) + 5
    shift4 = offset % 4
    views = {"i64": _t(cols["i64"]).to(dev), "f64": _t(cols["f64"]).to(dev),
             "i32": _view(dev, cols["i32"], shift4), "b": _view(dev, cols["b"], offset),
             "f32": _view(dev, cols["f32"], 3 - shift4)}
    dv, mv = _view(dev, dest, 3 - shift4), _view(dev, mask, 15 - offset)
    assert views["b"].data_ptr() % 16 == offset
    got = TK.dispatch_to_buckets(views, dv, mv, n_dest, cap)
    _assert_dispatch(got, cols, dest, mask, n_dest, cap)


@pytest.mark.cuda
def test_dispatch_kernel_takes_more_than_32_columns_of_a_width(dev):
    """K17 past 32 columns of a width: the count launched once, one scatter
    launch per group of 32, the same slots as the twin's."""
    rng = np.random.default_rng(5)
    n, n_dest = 100_003, 4
    dest = rng.integers(0, n_dest, n).astype(np.int32)
    mask = rng.random(n) < 0.7
    cols = {f"i{i}": rng.integers(-2**62, 2**62, n) for i in range(70)}
    cols.update({f"h{i}": rng.integers(-9, 9, n).astype(np.int32) for i in range(33)})
    cols["b"] = rng.random(n) < 0.5
    cap = int(np.bincount(dest[mask], minlength=n_dest).max()) - 3
    TK.reset_launch_counts()
    got = TK.dispatch_to_buckets({k: _t(v).to(dev) for k, v in cols.items()}, _t(dest).to(dev),
                                 _t(mask).to(dev), n_dest, cap)
    assert TK.LAUNCHES["dispatch_to_buckets"] == 3
    plan = TK.kernel_plan("dispatch_to_buckets")
    assert plan["count_launches"] == 1 and plan["scatter_launches"] == 3
    want = TK.dispatch_to_buckets_plain({k: _t(v) for k, v in cols.items()}, _t(dest), _t(mask),
                                        n_dest, cap)
    for k in cols:
        assert torch.equal(got[0][k].cpu(), want[0][k]), k
    assert torch.equal(got[1].cpu(), want[1]) and torch.equal(got[3].cpu(), want[3])
    assert bool(got[2]) and bool(want[2])


def _dispatch_inputs(rng, calls):
    """Calls of changing sizes, destinations and capacities."""
    out = []
    for _ in range(calls):
        n = int(rng.integers(0, 200_000))
        n_dest = int(rng.choice([1, 2, 4, 8, 17, 64]))
        dest = rng.integers(0, n_dest, n).astype(np.int32)
        mask = rng.random(n) < rng.random()
        cols = {"k": rng.integers(-2**62, 2**62, n), "v": rng.integers(0, 9, n).astype(np.int32)}
        most = int(np.bincount(dest[mask], minlength=n_dest).max()) if n else 0
        out.append((cols, dest, mask, n_dest, max(1, int(most * rng.uniform(0.8, 2.0)))))
    return out


def _dispatch_all(dev, inputs):
    staged = [({k: _t(v).to(dev) for k, v in c.items()}, _t(d).to(dev), _t(m).to(dev), nd, cap)
              for c, d, m, nd, cap in inputs]
    return [TK.dispatch_to_buckets(*a) for a in staged]


@pytest.mark.cuda
def test_dispatch_kernel_back_to_back_on_one_stream(dev):
    """60 calls queued back to back: the count's ticket is back to zero for
    the next call, and each call's scatter reads its own tile ranks."""
    inputs = _dispatch_inputs(np.random.default_rng(51), 60)
    results = _dispatch_all(dev, inputs)
    torch.cuda.synchronize()
    for args, got in zip(inputs, results):
        _assert_dispatch(got, *args)


@pytest.mark.cuda
def test_dispatch_kernel_from_four_threads_on_one_stream(dev):
    """Four threads on the stream they share: another call's launches may
    fall between a call's count and its scatter."""
    import threading

    rng = np.random.default_rng(52)
    inputs = [_dispatch_inputs(rng, 12) for _ in range(4)]
    results = [None] * 4
    start = threading.Barrier(4)

    def work(i):
        start.wait()
        results[i] = _dispatch_all(dev, inputs[i])
        torch.cuda.current_stream(dev).synchronize()

    threads = [threading.Thread(target=work, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    torch.cuda.synchronize()
    for inp, res in zip(inputs, results):
        for args, got in zip(inp, res):
            _assert_dispatch(got, *args)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 4, 8])
@pytest.mark.parametrize("dtype, how", [(torch.int64, "sum"), (torch.int64, "min"),
                                        (torch.int32, "sum"), (torch.float64, "sum"),
                                        (torch.float64, "max"), (torch.bool, "or")])
def test_rank_merge_kernel_matches_twin(dev, n, dtype, how):
    """K18: integers exact (wrapping sums); float64 sums within 1e-12 of
    the terms' summed magnitude (the twin adds in its own order, and a sum
    of normals may cancel to near 0)."""
    rng = np.random.default_rng(n)
    domain = 65_537
    if dtype == torch.int64:
        xs = [_t(rng.integers(2**62, 2**63 - 1, domain) * rng.choice([-1, 1], domain))
              for _ in range(n)]
    elif dtype == torch.bool:
        xs = [_t(rng.random(domain) < 0.01) for _ in range(n)]
    else:
        xs = [_t(rng.normal(size=domain) * 1e6).to(dtype) for _ in range(n)]
    got = TK.merge_rank_states([x.to(dev) for x in xs], how).cpu()
    want = TK.merge_rank_states_plain(xs, how)
    if dtype == torch.float64 and how == "sum":
        scale = torch.stack([x.abs() for x in xs]).sum(0)
        assert bool(((got - want).abs() <= 1e-12 * scale).all())
    else:
        assert torch.equal(got, want)


def _merge_case(n, rng, domain, columns=1):
    """``columns`` rounds of a dense merge's columns over n ranks (CPU
    tensors): int64 sums that wrap and min, int32 sums and max, float64
    sums, float64 min and max with NaN, float32 sums, exists counts, a bool
    flag."""
    nan = lambda a: np.where(rng.random(domain) < 0.05, np.nan, a)  # noqa: E731
    out = []
    for _ in range(columns):
        out += [
            ([_t(rng.integers(2**62, 2**63 - 1, domain) * rng.choice([-1, 1], domain))
              for _ in range(n)], "sum"),
            ([_t(rng.integers(-2**63, 2**63 - 1, domain, dtype=np.int64)) for _ in range(n)],
             "min"),
            ([_t(rng.integers(-2**31, 2**31 - 1, domain).astype(np.int32)) for _ in range(n)],
             "sum"),
            ([_t(rng.integers(-9, 9, domain).astype(np.int32)) for _ in range(n)], "max"),
            ([_t(rng.normal(size=domain) * 1e6) for _ in range(n)], "sum"),
            ([_t(nan(rng.normal(size=domain))) for _ in range(n)], "min"),
            ([_t(nan(rng.normal(size=domain))) for _ in range(n)], "max"),
            ([_t(rng.random(domain).astype(np.float32)) for _ in range(n)], "count"),
            ([_t((rng.integers(0, 2**31 - 1, domain) * (rng.random(domain) < 0.3))
                 .astype(np.int32)) for _ in range(n)], TK.MERGE_EXISTS),
            ([_t(rng.random(1) < 0.2) for _ in range(n)], "or"),
        ]
    return out


def _assert_merged(columns, got):
    """Integers, bools and float min / max exact; float sums within 1e-12
    (float32: 1e-6) of the terms' summed magnitude."""
    want = TK.merge_rank_columns_plain(columns)
    assert len(got) == len(want)
    for (xs, how), g, w in zip(columns, got, want):
        g = g.cpu()
        assert g.dtype == w.dtype and g.shape == w.shape
        if how in ("sum", "count") and xs[0].dtype.is_floating_point:
            tol = 1e-6 if xs[0].dtype == torch.float32 else 1e-12
            scale = torch.stack([x.abs() for x in xs]).sum(0)
            assert bool(((g - w).abs() <= tol * scale).all())
        else:
            np.testing.assert_array_equal(g.numpy(), w.numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2, 4, 6])
@pytest.mark.parametrize("domain", [1, 12, 65_537])
def test_many_column_merge_kernel_matches_twin_in_one_launch(dev, n, domain):
    """K18's many-column form: ten columns of every dtype in one launch
    (up to 6 ranks: 60 of the table's 64 rank arrays)."""
    columns = _merge_case(n, np.random.default_rng(n * 7 + domain), domain)
    TK.reset_launch_counts()
    got = TK.merge_rank_columns([([x.to(dev) for x in xs], how) for xs, how in columns])
    assert TK.LAUNCHES["merge_rank_states"] == 1
    assert TK.kernel_plan("merge_rank_columns")["launches"] == 1
    _assert_merged(columns, got)


@pytest.mark.cuda
@pytest.mark.parametrize("n, rounds", [(1, 2), (1, 7), (8, 1), (64, 1)])
def test_many_column_merge_past_one_table_takes_more_launches(dev, n, rounds):
    """20 or 70 columns (past a table's 16), or 8 and 64 ranks x 10 columns
    (past its 64 rank arrays): one launch a group of whole columns."""
    columns = _merge_case(n, np.random.default_rng(n), 300, rounds)
    per_launch = min(TK.MERGE_MAX_COLS, TK.MERGE_MAX_PTRS // n)
    TK.reset_launch_counts()
    got = TK.merge_rank_columns([([x.to(dev) for x in xs], how) for xs, how in columns])
    launches = -(-len(columns) // per_launch)
    assert launches > 1
    assert TK.LAUNCHES["merge_rank_states"] == launches
    _assert_merged(columns, got)


@pytest.mark.cuda
def test_many_column_merge_reads_views_at_byte_offsets(dev):
    """Rank arrays that are views into larger buffers, 1-15 bytes in (bool
    and the int32 exists counts), 4 or 8 bytes in (the rest)."""
    rng = np.random.default_rng(3)
    columns = _merge_case(4, rng, 4099)
    views = []
    for c, (xs, how) in enumerate(columns):
        row = []
        for r, x in enumerate(xs):
            off = 1 + (c + r) % 15 if x.dtype == torch.bool else 1 + (c + r) % 3
            buf = torch.zeros(x.numel() + off + 5, dtype=x.dtype, device=dev)
            buf[off:off + x.numel()] = x.to(dev)
            row.append(buf[off:off + x.numel()])
        views.append((row, how))
    _assert_merged(columns, TK.merge_rank_columns(views))


@pytest.mark.cuda
def test_many_column_merge_takes_strided_rank_arrays(dev):
    """Rank arrays that are every other element of a buffer: merged from
    contiguous copies the wrapper holds until its launch is queued, while
    the outputs are allocated around them."""
    columns = _merge_case(4, np.random.default_rng(4), 2053)
    strided = []
    for xs, how in columns:
        row = []
        for x in xs:
            buf = torch.zeros(2 * x.numel(), dtype=x.dtype, device=dev)
            buf[::2] = x.to(dev)
            row.append(buf[::2])
        strided.append((row, how))
    _assert_merged(columns, TK.merge_rank_columns(strided))


@pytest.mark.cuda
def test_many_column_merge_back_to_back_on_one_stream(dev):
    """100 merges queued back to back, then each held against its twin."""
    rng = np.random.default_rng(5)
    cases = [_merge_case(1 + i % 8, rng, 1 + (i * 37) % 700) for i in range(100)]
    on_card = [[([x.to(dev) for x in xs], how) for xs, how in c] for c in cases]
    torch.cuda.synchronize()
    results = [TK.merge_rank_columns(c) for c in on_card]
    torch.cuda.synchronize()
    for c, got in zip(cases, results):
        _assert_merged(c, got)


@pytest.mark.cuda
@pytest.mark.parametrize("ranks", [None, 4])
@pytest.mark.parametrize("q, broadcast_rows", [(1, None), (3, None), (3, "0"), (18, None)])
def test_mesh_queries_on_the_card_match_the_cpu(dev, ranks, q, broadcast_rows):
    """The mesh on the default mesh (every card) and on four ranks over
    cuda:0, against the port's plain path on the CPU at SF0.01; K17 or
    K18 and the generated derive launch where the path has them."""
    from arrow_ballista_tpu_torch import BallistaConfig, BallistaContext
    from arrow_ballista_tpu_torch.parallel import use_local_devices
    from benchmarks.queries import QUERIES

    conf = {"ballista.shuffle.mesh": "true", "ballista.shuffle.mesh.min_rows": "0",
            "ballista.join.broadcast_threshold": "0", "ballista.agg.capacity": "2097152"}
    if broadcast_rows is not None:
        conf["ballista.shuffle.mesh.broadcast_rows"] = broadcast_rows
    sql = QUERIES[q].replace("> 300", "> 200")
    ctx = BallistaContext.local(BallistaConfig(conf), device=dev)
    cpu = BallistaContext.local(device="cpu")
    for name, table in _sf001_tables().items():
        ctx.register_table(name, table)
        cpu.register_table(name, table)
    TK.reset_launch_counts()
    with (use_local_devices([torch.device("cuda", 0)] * ranks) if ranks
          else contextlib.nullcontext()):
        got = ctx.sql(sql).to_pandas()
    want = cpu.sql(sql).to_pandas()
    assert len(want) > 0
    assert_frames_equal(got, want)
    if q == 1:
        assert TK.LAUNCHES["merge_rank_states"] > 0 and TK.LAUNCHES["mesh_derive"] > 0
    if q == 18 or (ranks and broadcast_rows == "0"):  # one rank's join exchange is skipped
        assert TK.LAUNCHES["dispatch_to_buckets"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["q1", "q18", "nullable"])
def test_mesh_derive_kernel_matches_twin(dev, case):
    """The mesh aggregate's generated derive (keys, values, NULL
    neutralization, hidden valid counts) against its interpreted twin."""
    import pyarrow as pa

    from arrow_ballista_tpu_torch import BallistaConfig, BallistaContext
    from arrow_ballista_tpu_torch.compile.fused import mesh_derive, mesh_derive_plain
    from arrow_ballista_tpu_torch.models.batch import concat_batches
    from arrow_ballista_tpu_torch.ops import mesh_exec as TM
    from arrow_ballista_tpu_torch.ops.physical import TaskContext
    from arrow_ballista_tpu_torch.scheduler.planner import collect_nodes
    from benchmarks.queries import QUERIES

    ctx = BallistaContext.local(BallistaConfig({"ballista.shuffle.mesh": "true",
                                                "ballista.shuffle.mesh.min_rows": "0"}),
                                device=dev)
    if case == "nullable":
        rng = np.random.default_rng(7)
        n = 20_000
        null_at = rng.random(n) < 0.3
        ctx.register_table("t", pa.table({
            "g": pa.array(rng.integers(0, 20, n)),
            "v": pa.array([None if m else int(x) for m, x in
                           zip(null_at, rng.integers(-50, 100, n))], type=pa.int64())}))
        sql = "select g, sum(v), count(v), min(v), max(v), count(*) from t group by g"
    else:
        for name, table in _sf001_tables().items():
            ctx.register_table(name, table)
        sql = QUERIES[int(case[1:])]
    ctx.sql(sql).to_pandas()
    node = collect_nodes(ctx.last_plan, TM.MeshAggregateExec)[0]
    tctx = TaskContext(device=dev, config=ctx.config)
    big = concat_batches(node.input.schema, TM._gather_input(node.input, tctx), device=dev)
    compiled = node._compile(tctx)
    aux = compiled[0].aux_arrays(big.dicts)
    TK.reset_launch_counts()
    got = mesh_derive(node._derive, compiled, big.columns, big.mask, aux)
    assert TK.LAUNCHES["mesh_derive"] == (1 if node._derive.gen.outputs else 0)
    want = mesh_derive_plain(node._derive, compiled, big.columns, big.mask, aux)
    assert list(got) == list(want)
    for name, w in want.items():
        np.testing.assert_array_equal(got[name].cpu().numpy(), w.cpu().numpy(), err_msg=name)


# --------------------------------------------------------------------------
# K19 operator programs, K20 concat, K21 gather, K22 mask ops
# --------------------------------------------------------------------------


def _bits(t):
    """Each value's bits, so NaN and -0.0 compare exactly."""
    if t.dtype == torch.float64:
        return t.view(torch.int64)
    if t.dtype == torch.float32:
        return t.view(torch.int32)
    return t


def _same(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(_bits(got.contiguous()), _bits(want.contiguous()))


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CONCAT_CASES))
def test_concat_kernel_matches_twin(dev, case):
    cols_list, masks, pad = concat_case(case, np.random.default_rng(7))
    tc = [{k: _t(v).to(dev) for k, v in c.items()} for c in cols_list]
    tm = [_t(m).to(dev) for m in masks]
    before = TK.LAUNCHES["concat_columns"]
    got, gm = TK.concat_columns(tc, tm, pad)
    want, wm = TK.concat_columns_plain(tc, tm, pad)
    torch.cuda.synchronize()
    assert TK.LAUNCHES["concat_columns"] > before
    assert list(got) == list(want)
    for k in want:
        _same(got[k], want[k])
    _same(gm, wm)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(GATHER_CASES))
def test_gather_kernel_matches_twin(dev, case):
    cols, _mask, idx = gather_case(case, np.random.default_rng(8))
    tcols = {k: _t(v).to(dev) for k, v in cols.items()}
    tidx = _t(idx).to(dev)
    before = TK.LAUNCHES["gather_columns"]
    got = TK.gather_columns(tidx, tcols)
    want = TK.gather_columns_plain(tidx, tcols)
    torch.cuda.synchronize()
    assert TK.LAUNCHES["gather_columns"] == before + -(-len(cols) // TK.GATHER_MAX_COLS)
    for k in want:
        _same(got[k], want[k])


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(PACK_CASES))
def test_pack_for_host_kernel_matches_twin(dev, case):
    cols, mask, target, i64, f64, n32 = pack_case(case, np.random.default_rng(9))
    tcols = {k: _t(v).to(dev) for k, v in cols.items()}
    tmask = _t(mask).to(dev)
    buf, fbuf = TK.pack_for_host(tcols, tmask, target, i64, f64, n32)
    wbuf, wfbuf = TK.pack_for_host_plain(tcols, tmask, target, i64, f64, n32)
    torch.cuda.synchronize()
    _same(buf, wbuf)
    if f64:
        _same(fbuf, wfbuf)
    else:
        assert fbuf is None and wfbuf is None


@pytest.mark.cuda
@pytest.mark.parametrize("case", MASK_OPS_CASES)
def test_mask_ops_kernel_matches_twin(dev, case):
    op, a, b, lo, hi = mask_ops_case(case, np.random.default_rng(10))
    ta = _t(a).to(dev)
    tb = _t(b).to(dev) if b is not None else None
    kernel, plain = {"window": (TK.window_mask, TK.window_mask_plain),
                     "or": (TK.mask_or, TK.mask_or_plain),
                     "and": (TK.mask_and, TK.mask_and_plain),
                     "andnot": (TK.mask_andnot, TK.mask_andnot_plain)}[op]
    args = (ta, lo, hi) if op == "window" else (ta, tb)
    before = TK.LAUNCHES["mask_ops"]
    got = kernel(*args)
    want = plain(*args)
    torch.cuda.synchronize()
    assert TK.LAUNCHES["mask_ops"] == before + 1
    _same(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["window_middle", "or", "and", "andnot"])
def test_mask_ops_kernel_takes_unaligned_views(dev, case):
    """Views three rows in are not 16-byte aligned: K22 goes row by row."""
    op, a, b, lo, hi = mask_ops_case(case, np.random.default_rng(12))
    ta = _t(a).to(dev)[3:]
    tb = _t(b).to(dev)[3:] if b is not None else None
    kernel, plain = {"window": (TK.window_mask, TK.window_mask_plain),
                     "or": (TK.mask_or, TK.mask_or_plain),
                     "and": (TK.mask_and, TK.mask_and_plain),
                     "andnot": (TK.mask_andnot, TK.mask_andnot_plain)}[op]
    args = (ta, lo, hi) if op == "window" else (ta, tb)
    got = kernel(*args)
    want = plain(*args)
    torch.cuda.synchronize()
    _same(got, want)


# K22's bucket form: 1, 2, 16 and 64 partitions at 1, 15, 16 and 17 rows
# (ragged and whole 16-byte words) and a batch of 131,072 -+1 rows
BUCKET_SIZES = [1, 15, 16, 17, (1 << 17) - 1, 1 << 17, (1 << 17) + 1]


def _bucket_on_card(dev, mask, bucket, num_out):
    """K22's bucket form against its twin: one launch, every partition's
    row a 16-byte-aligned view of one allocation."""
    before = TK.LAUNCHES["bucket_masks"]
    got = TK.bucket_masks(mask, bucket, num_out)
    want = TK.bucket_masks_plain(mask, bucket, num_out)
    torch.cuda.synchronize()
    assert TK.LAUNCHES["bucket_masks"] == before + 1
    _same(got, want)
    for q in range(num_out):
        assert got[q].is_contiguous() and got[q].data_ptr() % 16 == 0
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("n", BUCKET_SIZES)
@pytest.mark.parametrize("num_out", [1, 2, 16, 64])
def test_bucket_masks_kernel_matches_twin(dev, num_out, n):
    rng = np.random.default_rng(n + num_out)
    mask = _t(rng.random(n) < 0.7).to(dev)
    bucket = TK.bucket_of([_t(rng.integers(-10**6, 10**6, n).astype(np.int64)).to(dev)], num_out)
    _bucket_on_card(dev, mask, bucket, num_out)


@pytest.mark.cuda
@pytest.mark.parametrize("case", BUCKET_CASES)
def test_bucket_masks_kernel_over_the_cpu_cases(dev, case):
    """The CPU test's cases (out-of-range buckets select no row, one bucket
    holding every row) on the card."""
    keys, mask, num_out, given = bucket_case(case, np.random.default_rng(8))
    bucket = TK.bucket_of([_t(k).to(dev) for k in keys], num_out) if given is None \
        else _t(given).to(dev)
    _bucket_on_card(dev, _t(mask).to(dev), bucket, num_out)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", range(1, 16))
def test_bucket_masks_kernel_on_views_at_byte_offsets(dev, offset):
    """A mask viewed at a byte offset (and its buckets at the same row) is
    not 16-byte aligned: the rows go one by one."""
    n = 5003 + offset
    rng = np.random.default_rng(offset)
    mask = _t(rng.random(n) < 0.6).to(dev)[offset:]
    bucket = _t(rng.integers(-2, 18, n).astype(np.int32)).to(dev)[offset:]
    _bucket_on_card(dev, mask, bucket, 16)


# K8: the CPU model's cases, then a tile -+1, two tiles -+1 and 2^20 + 5 rows
SEG_SIZES = [1, 2, SEG_TILE - 1, SEG_TILE, SEG_TILE + 1, 2 * SEG_TILE - 1, 2 * SEG_TILE + 1,
             (1 << 20) + 5]


def _seg_on_card(dev, keys, vals, mask, cap, order=None):
    """K8 read through ``order`` (the identity when none is given: rows in
    group order) against its twin on the same card tensors; integers
    exact, float sums at rtol 1e-12 (the kernel adds in its tile order, the
    twin in its own)."""
    if order is None:
        order = np.arange(len(mask), dtype=np.int32)
    n = len(order)
    args = ([_t(k).to(dev) for k in keys], [(_t(v).to(dev), h) for v, h in vals],
            _t(mask).to(dev), cap, n, _t(order).to(dev))
    before = TK.LAUNCHES["grouped_on_order"]
    got = TK.grouped_on_order(*args)
    want = TK.grouped_on_order_plain(*args)
    torch.cuda.synchronize()
    assert TK.LAUNCHES["grouped_on_order"] == before + 1
    assert torch.equal(got[2], want[2])
    assert (got[3] is None) == (want[3] is None)
    if got[3] is not None:
        assert bool(got[3]) == bool(want[3])
    for g, w in zip(got[0], want[0]):  # NaN keys compare equal here
        np.testing.assert_array_equal(g.cpu().numpy(), w.cpu().numpy())
    for (v, how), g, w in zip(vals, got[1], want[1]):
        if v.dtype.kind == "f" and how == "sum":
            np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), rtol=1e-12, atol=0)
        else:
            np.testing.assert_array_equal(g.cpu().numpy(), w.cpu().numpy())
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["in_order", "through_order"])
@pytest.mark.parametrize("case", SEG_CASES)
def test_k8_kernel_matches_twin_on_the_tile_cases(dev, case, form):
    rng = np.random.default_rng(51)
    keys, vals, mask, cap = seg_case(case, rng)
    if form == "in_order":
        _seg_on_card(dev, keys, vals, mask, cap)
        return
    order = rng.permutation(len(mask)).astype(np.int32)

    def scatter(a):
        out = np.empty_like(a)
        out[order] = a
        return out

    _seg_on_card(dev, [scatter(k) for k in keys], [(scatter(v), h) for v, h in vals],
                 scatter(mask), cap, order)


@pytest.mark.cuda
@pytest.mark.parametrize("n", SEG_SIZES)
def test_k8_kernel_at_tile_sizes(dev, n):
    """Small groups, one group over every row, and no keys, at each size."""
    rng = np.random.default_rng(n)
    mask = rng.random(n) < 0.8
    vals = [(rng.integers(2**61, 2**62, n).astype(np.int64), "sum"),
            (np.zeros(n, np.int64), "count"), (rng.normal(size=n), "max"),
            (rng.integers(-99, 99, n).astype(np.int32), "min")]
    _seg_on_card(dev, [np.sort(rng.integers(0, max(1, n // 6), n)).astype(np.int64)], vals,
                 mask, n)
    _seg_on_card(dev, [np.full(n, 3, np.int32)], vals, mask, n)
    _seg_on_card(dev, [], vals, mask, 1)


def _seg_reset_inputs(rng, count):
    """Calls of several sizes and group shapes for the state-reset checks."""
    out = []
    for i in range(count):
        n = int(rng.choice([100, SEG_TILE + 3, 40_000, 300_000]))
        keys = [np.sort(rng.integers(0, max(1, n // int(rng.choice([2, 50, n]))), n))
                .astype(np.int64)]
        vals = [(rng.integers(-10**9, 10**9, n).astype(np.int64), "sum"),
                (np.zeros(n, np.int64), "count")]
        out.append((keys if i % 5 else [], vals, rng.random(n) < 0.7, n))
    return out


def _seg_reset_launch(dev, inputs):
    args = [([_t(k).to(dev) for k in keys], [(_t(v).to(dev), h) for v, h in vals],
             _t(mask).to(dev), cap, cap, torch.arange(cap, dtype=torch.int32, device=dev))
            for keys, vals, mask, cap in inputs]
    return args, [TK.grouped_on_order(*a) for a in args]


def _seg_reset_check(args, results):
    for a, got in zip(args, results):
        want = TK.grouped_on_order_plain(*a)
        assert torch.equal(got[2], want[2])
        for g, w in zip(list(got[0]) + list(got[1]), list(want[0]) + list(want[1])):
            assert torch.equal(g, w)


@pytest.mark.cuda
def test_k8_back_to_back_on_one_stream(dev):
    """300 calls queued back to back: each launch's last block leaves the
    stream's state words zero for the next."""
    args, results = _seg_reset_launch(dev, _seg_reset_inputs(np.random.default_rng(52), 300))
    torch.cuda.synchronize()
    _seg_reset_check(args, results)


@pytest.mark.cuda
@pytest.mark.parametrize("own_streams", [False, True])
def test_k8_from_four_threads(dev, own_streams):
    import threading

    rng = np.random.default_rng(53)
    inputs = [_seg_reset_inputs(rng, 25) for _ in range(4)]
    results = [None] * 4
    start = threading.Barrier(4)

    def work(i):
        ctx = torch.cuda.stream(torch.cuda.Stream(dev)) if own_streams else \
            contextlib.nullcontext()
        with ctx:
            start.wait()
            results[i] = _seg_reset_launch(dev, inputs[i])
            torch.cuda.current_stream(dev).synchronize()

    threads = [threading.Thread(target=work, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    torch.cuda.synchronize()
    for args, res in results:
        _seg_reset_check(args, res)


@contextlib.contextmanager
def _programs_held_against_twins(calls):
    """Every K19 call also runs its twin on the same inputs and must equal
    it bit for bit; ``calls`` counts them by program label."""
    from arrow_ballista_tpu_torch.compile import programs as P

    kernel = P.operator_program

    def checked(program, cols, mask, auxs):
        got = kernel(program, cols, mask, auxs)
        want = P.operator_program_plain(program, cols, mask, auxs)
        if program.kind == "mask":
            _same(got, want.expand(mask.shape[0]) if want.dim() == 0 else want)
        else:
            assert list(got) == list(want)
            for k in want:
                _same(got[k], want[k].expand(mask.shape[0]))
        calls[program.label] = calls.get(program.label, 0) + 1
        return got

    P.operator_program = checked
    try:
        yield
    finally:
        P.operator_program = kernel


@pytest.mark.cuda
@pytest.mark.parametrize("q", range(1, 23))
def test_tpch_on_the_card_runs_its_programs_through_k19(dev, q):
    """Each of the 22 queries at SF0.01 in the local engine on the card:
    every operator program is a generated kernel (K19) equal to its twin,
    concat, shrink, pack and the gathers run on K20 and K21, and the rows
    equal the port on the CPU (which tests/test_torch_tpch.py holds against
    sqlite)."""
    from arrow_ballista_tpu_torch import BallistaContext
    from benchmarks.queries import QUERIES

    frames, calls = [], {}
    for device in ("cpu", dev):
        ctx = BallistaContext.local(device=device)
        for table, data in _sf001_tables().items():
            ctx.register_table(table, data)
        if device == "cpu":
            frames.append(ctx.sql(QUERIES[q]).to_pandas())
            continue
        TK.reset_launch_counts()
        with _programs_held_against_twins(calls):
            frames.append(ctx.sql(QUERIES[q]).to_pandas())
        torch.cuda.synchronize()
    assert TK.LAUNCHES["operator_program"] > 0 and calls
    assert TK.LAUNCHES["gather_columns"] > 0 and TK.LAUNCHES["concat_columns"] > 0
    assert_frames_equal(frames[1], frames[0], ordered="order by" in QUERIES[q].lower())


@pytest.mark.cuda
def test_an_untraceable_expression_raises_when_the_plan_is_prepared(dev):
    from arrow_ballista_tpu_torch import BallistaContext
    from arrow_ballista_tpu_torch.compile.codegen import CodegenError
    from arrow_ballista_tpu_torch.models.schema import INT64
    from arrow_ballista_tpu_torch.udf import GLOBAL_UDFS, register_udf

    # a UDF's torch call has no generated code, and the card no fallback
    register_udf("plus_one_card", lambda x: torch.neg(x), INT64)
    try:
        ctx = BallistaContext.local(device=dev)
        ctx.register_table("t", __import__("pyarrow").table({"x": np.arange(10)}))
        with pytest.raises(CodegenError):
            ctx.sql("select plus_one_card(x) as y from t").to_pandas()
    finally:
        GLOBAL_UDFS.deregister("plus_one_card")


@pytest.mark.cuda
def test_concat_kernel_promotes_mixed_dtypes_as_torch_cat(dev):
    """An int32 sum's batches beside int64 ones (per-row states) concat to
    int64, as torch.cat promotes them."""
    rng = np.random.default_rng(11)
    a = {"s": _t(rng.integers(-9, 9, 1024).astype(np.int32)).to(dev)}
    b = {"s": _t(rng.integers(-2**40, 2**40, 2048)).to(dev)}
    masks = [_t(rng.random(1024) < 0.5).to(dev), _t(rng.random(2048) < 0.5).to(dev)]
    got, gm = TK.concat_columns([a, b], masks, 64)
    want, wm = TK.concat_columns_plain([a, b], masks, 64)
    torch.cuda.synchronize()
    _same(got["s"], want["s"])
    _same(gm, wm)


@pytest.mark.cuda
def test_a_program_over_an_int32_sum_matches_the_cpu(dev):
    """A projection over sum(int32), whose column is int32 under an int64
    schema field: K19 reads it sign-extended."""
    from arrow_ballista_tpu_torch import BallistaContext

    sql = ("select o_orderpriority, sum(o_shippriority) * 3 + 1 as s3 from orders "
           "group by o_orderpriority order by o_orderpriority")
    frames = []
    for device in (dev, "cpu"):
        ctx = BallistaContext.local(device=device)
        ctx.register_table("orders", _sf001_tables()["orders"])
        frames.append(ctx.sql(sql).to_pandas())
    assert_frames_equal(frames[0], frames[1])


# --------------------------------------------------------------------------
# the remote engine on the card
# --------------------------------------------------------------------------

# wrappers with a plain twin of the same arguments, checked call by call
REMOTE_TWINS = ("hash64", "bucket_of", "compaction_order", "bucket_masks")


@pytest.mark.cuda
@pytest.mark.parametrize("host_match", ["true", "false"])
def test_remote_q3_on_the_card_matches_the_cpu(dev, tmp_path, monkeypatch, host_match):
    """q3 through a scheduler service and two in-process executor servers
    on cuda:0 (eight task threads launching at once), the shuffle through
    the mmap path or the wire: the rows equal the port's local engine on the
    CPU, every task ran on the card and launched kernels, and every call of
    the wrappers in REMOTE_TWINS equals its plain twin."""
    import threading

    from arrow_ballista_tpu_torch import BallistaContext
    from tests.torch_cases import remote_cluster, remote_context

    checked, bad, lock = {}, [], threading.Lock()

    def twin_checked(name, real, plain):
        def run(*args, **kw):
            got = real(*args, **kw)
            host = [[a.cpu() for a in x] if isinstance(x, (list, tuple)) else
                    (x.cpu() if isinstance(x, torch.Tensor) else x) for x in args]
            want = plain(*host)
            order = got[0] if kw.get("with_count") else got  # K2: (order, count)
            same = torch.equal(order.cpu(), want)
            with lock:
                checked[name] = checked.get(name, 0) + 1
                if not same:
                    bad.append(name)
            return got
        return run

    for name in REMOTE_TWINS:
        monkeypatch.setattr(TK, name, twin_checked(name, getattr(TK, name),
                                                   getattr(TK, f"{name}_plain")))
    tables = _sf001_tables()
    sql = STANDALONE_SQL["q3"]
    settings = {"ballista.shuffle.local.host_match": host_match}
    with remote_cluster("torch", str(tmp_path), device=dev,
                        executor_settings=settings) as (sched, exs):
        ctx = remote_context("torch", sched, device=dev)
        for name in ("lineitem", "orders", "customer"):
            ctx.register_table(name, tables[name])
        TK.reset_launch_counts()
        got = ctx.sql(sql).to_pandas()
        graph = sched.server.jobs.get_graph(ctx._remote.last_job_id)
        ctx.shutdown()
        assert all(ex.device.type == "cuda" for ex in exs)
    local = BallistaContext.local(device="cpu")
    for name in ("lineitem", "orders", "customer"):
        local.register_table(name, tables[name])
    want = local.sql(sql).to_pandas()
    assert len(want) > 0
    assert_frames_equal(got, want)
    assert not bad, bad
    assert checked.get("bucket_of"), checked
    launched = {}
    for st in graph.stages.values():
        for t in st.task_infos:
            for k, v in (t.status.device_stats or {}).items():
                if k.startswith("launches."):
                    launched.setdefault(t.executor_id, {})[k] = v
    assert set(launched) == {ex.metadata.executor_id for ex in exs}, launched
