"""The port's kernel twins (arrow_ballista_tpu_torch/ops/kernels.py, on the
CPU) against the JAX package's functions on the same numpy inputs.

Integer, decimal, date and dictionary-coded outputs must match bit for
bit; float64 sums at rtol 1e-12 (both sides sum in float64, in different
orders).  The CUDA kernels themselves are held against these twins on the
card by chip_smoke.py and tests/test_torch_cuda.py.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from arrow_ballista_tpu.ops import kernels as JK
from arrow_ballista_tpu_torch.ops import kernels as TK
from tests.torch_cases import (DENSE_CASES, HASH_CASES, SORT_CASES,
                               dense_case as _dense_case, hash_cols as _hash_cols,
                               mask_case as _mask, sort_case as _sort_case)

# the suite runs in parallel worker processes: one core per worker for torch
torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(x):
    return np.asarray(x)


# --------------------------------------------------------------------------
# K3: hash64 / bucket_of
# --------------------------------------------------------------------------


@pytest.mark.parametrize("case", HASH_CASES)
def test_hash64_bit_identical(case):
    cols = _hash_cols(case, 3001, np.random.default_rng(7))
    want = _np(JK.hash64([jnp.asarray(c) for c in cols])).view(np.int64)
    got = TK.hash64([_t(c) for c in cols]).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("buckets", [1, 7, 16, 64])
@pytest.mark.parametrize("case", ["null_code_and_int64", "three_mixed"])
def test_bucket_of_bit_identical(case, buckets):
    cols = _hash_cols(case, 2048, np.random.default_rng(11))
    want = _np(JK.bucket_of([jnp.asarray(c) for c in cols], buckets))
    got = TK.bucket_of([_t(c) for c in cols], buckets)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_string_key_hashes_travel_as_int64_bits():
    """compile_key turns string keys into uint64 FNV hashes; the port hands
    the same bits to the hash as int64."""
    rng = np.random.default_rng(3)
    u = rng.integers(0, 2**63, 512, dtype=np.int64).view(np.uint64) * np.uint64(3)
    want = _np(JK.bucket_of([jnp.asarray(u)], 16))
    got = TK.bucket_of([_t(u.view(np.int64))], 16).numpy()
    np.testing.assert_array_equal(got, want)


def test_force_hash_collisions_zeroes_every_hash(monkeypatch):
    monkeypatch.setattr(TK, "_FORCE_COLLISIONS", True)
    cols = [_t(np.arange(100, dtype=np.int64))]
    assert int(TK.hash64(cols).abs().sum()) == 0
    assert int(TK.bucket_of(cols, 16).abs().sum()) == 0


# --------------------------------------------------------------------------
# K2: compaction_order
# --------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 1024, 5000])
@pytest.mark.parametrize("case", ["random", "all_live", "all_dead", "alternating", "tail_dead"])
def test_compaction_order_matches(case, n):
    m = _mask(case, n, np.random.default_rng(n))
    want = _np(JK.compaction_order(jnp.asarray(m)))
    got = TK.compaction_order(_t(m))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


# K2's forms (csrc/compact.cu), step for step in numpy.  Parameters:
# (threads of a two-launch block, its rounds a tile, threads of a one-launch
# block, its cluster's blocks at most, rows the one-launch form takes at
# most): the kernel's, and small ones that give several rounds, tiles and
# cluster blocks at test sizes.
K2_PARAMS = {"kernel": (256, 2, 1024, 8, 1 << 17), "small": (4, 2, 8, 8, 1024)}


def _k2_round(mask, words, r0, n, n_live, live_before, dead_before, perm):
    """cp_round: thread t holds word t (rows r0 + 16 t ..); a block scan of
    (valid, live) packed in one int; live rows staged first, then dead ones,
    each in row order; written out in two runs."""
    t = len(words)
    rows = r0 + np.arange(t * 16)
    valid = (rows >= 0) & (rows < n)
    live_b = words.reshape(-1).astype(bool) & valid
    live = live_b.reshape(t, 16).sum(1)
    nvalid = valid.reshape(t, 16).sum(1)
    packed = (nvalid << 16) | live
    ex = np.concatenate([[0], np.cumsum(packed)[:-1]])
    tot = int(packed.sum())
    nl, nv = tot & 0xFFFF, tot >> 16
    stage = np.full(t * 16, -1, np.int64)
    li, di = ex & 0xFFFF, nl + (ex >> 16) - (ex & 0xFFFF)
    for b in range(16):
        idx = np.arange(t) * 16 + b
        ok = valid[idx]
        lv = ok & live_b[idx]
        stage[li[lv]] = rows[idx][lv]
        stage[di[ok & ~lv]] = rows[idx][ok & ~lv]
        li, di = li + lv, di + (ok & ~lv)
    i = np.arange(nv)
    dest = np.where(i < nl, live_before + i, n_live + dead_before + (i - nl))
    perm[dest] = stage[:nv]
    return live_before + nl, dead_before + nv - nl


def k2_mirror(mask, shift, params):
    """csrc/compact.cu on a numpy mask whose address is ``shift`` bytes past
    a 16-byte boundary: (perm, live count, launches)."""
    threads, rounds, one_threads, cluster, one_rows = params
    n = len(mask)
    nwords = (n + shift + 15) // 16
    words = np.zeros(nwords * 16, np.uint8)  # bytes of rows outside [0, n) clear
    words[shift:shift + n] = mask
    words = words.reshape(nwords, 16)
    perm = np.full(n, -1, np.int64)
    if n <= one_rows:  # a cluster: block counts, then each block's rounds
        per = -(-nwords // one_threads)
        wb = -(-per // min(cluster, per)) * one_threads
        blocks = -(-nwords // wb)
        assert blocks <= cluster
        block_live = [int(words[b * wb:(b + 1) * wb].astype(bool).sum()) for b in range(blocks)]
        n_live = sum(block_live)
        for b in range(blocks):
            live_before = sum(block_live[:b])
            dead_before = max(b * wb * 16 - shift, 0) - live_before
            for w0 in range(b * wb, min((b + 1) * wb, nwords), one_threads):
                chunk = np.zeros((one_threads, 16), np.uint8)
                part = words[w0:min(w0 + one_threads, nwords, (b + 1) * wb)]
                chunk[:len(part)] = part
                live_before, dead_before = _k2_round(chunk, chunk, w0 * 16 - shift, n, n_live,
                                                     live_before, dead_before, perm)
        return perm, n_live, 1
    tile_words = threads * rounds
    tiles = -(-nwords // tile_words)
    padded = np.zeros((tiles * tile_words, 16), np.uint8)
    padded[:nwords] = words
    counts = padded.reshape(tiles, -1).astype(bool).sum(1)
    n_live = int(counts.sum())
    # the look-back, tiles finishing in a shuffled order: windows of
    # `threads` words, nearest first, up to and with the nearest inclusive one
    status = [("agg", int(c)) for c in counts]
    for t in np.random.default_rng(tiles).permutation(tiles):
        excl, end = 0, t
        while end > 0:
            window = [status[k] for k in range(end - 1, max(end - 1 - threads, -1), -1)]
            first = next((i for i, (f, _) in enumerate(window) if f == "inc"), None)
            excl += sum(v for _, v in window[:len(window) if first is None else first + 1])
            if first is not None:
                break
            end -= threads
        assert excl == int(counts[:t].sum())
        status[t] = ("inc", excl + int(counts[t]))
        row0 = t * tile_words * 16 - shift
        live_before, dead_before = excl, max(row0, 0) - excl
        for k in range(rounds):
            w0 = t * tile_words + k * threads
            chunk = padded[w0:w0 + threads]
            live_before, dead_before = _k2_round(chunk, chunk, row0 + k * threads * 16, n,
                                                 n_live, live_before, dead_before, perm)
    return perm, n_live, 2


def _k2_sizes(params):
    """Sizes around a tile's rows, the one-launch limit and the first
    two-launch tile past it, each +-1."""
    threads, rounds, one_threads, cluster, one_rows = params
    tile = threads * rounds * 16
    return [1, tile - 1, tile, tile + 1, one_rows - 1, one_rows, one_rows + 1,
            one_rows + tile - 1, one_rows + tile + 1]


@pytest.mark.parametrize("shift", [0, 7, 15])
@pytest.mark.parametrize("params", list(K2_PARAMS))
@pytest.mark.parametrize("case", ["random", "all_live", "all_dead"])
def test_k2_forms_match_reference(case, params, shift):
    """Both forms, mirrored in numpy, each on its side of the one-launch
    limit (a tile +-1 and the limit in one launch, the limit + 1 and a
    tile past it +-1 in two), with the mask at a byte offset: the JAX
    package's permutation and live count."""
    p = K2_PARAMS[params]
    for n in _k2_sizes(p):
        m = _mask(case, n, np.random.default_rng(n + shift))
        want = _np(JK.compaction_order(jnp.asarray(m))).astype(np.int64)
        perm, live, launches = k2_mirror(m, shift, p)
        np.testing.assert_array_equal(perm, want)
        assert live == int(m.sum())
        assert launches == (1 if n <= p[4] else 2)


# --------------------------------------------------------------------------
# K4: sort_order
# --------------------------------------------------------------------------


@pytest.mark.parametrize("case", SORT_CASES)
def test_sort_order_matches_reference_order(case):
    """The reference's lexsort fixes the order of the key tuples; it leaves
    ties to XLA's sort.  The twin must give the reference's key sequence
    (bit for bit, NaN and -0.0 included) and be stable."""
    rng = np.random.default_rng(len(case))
    n = 777
    keys, mask = _sort_case(case, n, rng)
    jperm = _np(JK.sort_order([(jnp.asarray(a), asc) for a, asc in keys], jnp.asarray(mask)))
    tperm = TK.sort_order([(_t(a), asc) for a, asc in keys], _t(mask))
    assert tperm.dtype == torch.int32
    tperm = tperm.numpy().astype(np.int64)
    np.testing.assert_array_equal(mask[tperm], mask[jperm])
    for a, _ in keys:
        bits = a.view(np.int64 if a.itemsize == 8 else np.int32) if a.dtype.kind == "f" else a
        np.testing.assert_array_equal(bits[tperm], bits[jperm])
    # stable: equal to numpy's stable lexsort of the same sort words
    words = [TK.sort_words(_t(a), asc).numpy() for a, asc in keys]
    want = np.lexsort(list(reversed(words)) + [~mask])
    np.testing.assert_array_equal(tperm, want)


# --------------------------------------------------------------------------
# K1: dense grouped aggregation
# --------------------------------------------------------------------------


def _assert_vals(got, want, how, dtype):
    if dtype.kind == "f" and how == "sum":
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", DENSE_CASES)
def test_dense_group_states_matches(case):
    keys, vals, mask, ranges = _dense_case(case, 4099, np.random.default_rng(5))
    domain = TK.dense_domain(ranges)
    assert domain == JK.dense_domain(ranges)
    jv, je, jb = JK.dense_group_states([jnp.asarray(k) for k in keys],
                                       [(jnp.asarray(v), h) for v, h in vals],
                                       jnp.asarray(mask), ranges, domain)
    tv, te, tb = TK.dense_group_states([_t(k) for k in keys], [(_t(v), h) for v, h in vals],
                                       _t(mask), ranges, domain)
    np.testing.assert_array_equal(te.numpy(), _np(je))
    assert bool(tb) == bool(jb)
    for (v, how), g, w in zip(vals, tv, jv):
        _assert_vals(g.numpy(), _np(w), how, v.dtype)


@pytest.mark.parametrize("out_capacity", [8, 16, 2048])
@pytest.mark.parametrize("case", ["q1_dict_codes", "bool_and_int64_keys", "out_of_range_rows"])
def test_grouped_aggregate_dense_matches(case, out_capacity):
    keys, vals, mask, ranges = _dense_case(case, 3000, np.random.default_rng(9))
    domain = TK.dense_domain(ranges)
    jk, jv, jm, jo = JK.grouped_aggregate([jnp.asarray(k) for k in keys],
                                          [(jnp.asarray(v), h) for v, h in vals],
                                          jnp.asarray(mask), out_capacity, key_ranges=ranges)
    tk, tv, tm, to = TK.grouped_aggregate([_t(k) for k in keys], [(_t(v), h) for v, h in vals],
                                          _t(mask), out_capacity, key_ranges=ranges)
    np.testing.assert_array_equal(tm.numpy(), _np(jm))
    assert (to is None) == (jo is None)
    if to is not None:
        assert bool(to) == bool(jo)
    for g, w in zip(tk, jk):
        assert g.numpy().dtype == _np(w).dtype
        np.testing.assert_array_equal(g.numpy(), _np(w))
    for (v, how), g, w in zip(vals, tv, jv):
        _assert_vals(g.numpy(), _np(w), how, v.dtype)
    assert domain is not None


def test_grouping_without_dense_domain_raises():
    """Keys without a dense domain take the sort path (K4 order + K8),
    which matches the reference (more cases: tests/test_torch_join_kernels.py)."""
    rng = np.random.default_rng(13)
    k = rng.integers(0, 5, 40).astype(np.int64)
    mask = rng.random(40) < 0.8
    jk, jv, jm, jo = JK.grouped_aggregate([jnp.asarray(k)], [(jnp.asarray(k), "sum")],
                                          jnp.asarray(mask), 64, key_ranges=(None,))
    tk, tv, tm, to = TK.grouped_aggregate([_t(k)], [(_t(k), "sum")], _t(mask), 64,
                                          key_ranges=(None,))
    assert to is None and jo is None
    np.testing.assert_array_equal(tm.numpy(), _np(jm))
    np.testing.assert_array_equal(tk[0].numpy(), _np(jk[0]))
    np.testing.assert_array_equal(tv[0].numpy(), _np(jv[0]))


# --------------------------------------------------------------------------
# wire packing
# --------------------------------------------------------------------------


def test_pack_for_host_layout_matches():
    rng = np.random.default_rng(2)
    n = 2048
    cols = {"a": rng.integers(-9, 9, n).astype(np.int64),
            "b": rng.integers(-9, 9, n).astype(np.int32),
            "c": rng.normal(size=n).astype(np.float32),
            "d": rng.random(n) < 0.5,
            "e": rng.normal(size=n)}
    mask = rng.random(n) < 0.4
    args = (1024, ("a",), ("e",), ("b", "c", "d"))
    jbuf, jf = JK.pack_for_host({k: jnp.asarray(v) for k, v in cols.items()},
                                jnp.asarray(mask), *args)
    tbuf, tf = TK.pack_for_host({k: _t(v) for k, v in cols.items()}, _t(mask), *args)
    np.testing.assert_array_equal(tbuf.numpy(), _np(jbuf))
    np.testing.assert_array_equal(tf.numpy(), _np(jf))


# --------------------------------------------------------------------------
# the flagship step: port entry() against __graft_entry__.entry()
# --------------------------------------------------------------------------


def test_entry_step_bit_exact_against_reference():
    import __graft_entry__ as g

    from arrow_ballista_tpu_torch import entry as port_entry

    jstep, (jcols, jmask) = g.entry()
    jk, jv, jm, _ = jstep(jcols, jmask)
    tstep, (tcols, tmask) = port_entry.entry(4096, device="cpu")
    for k in jcols:
        np.testing.assert_array_equal(tcols[k].numpy(), _np(jcols[k]))
    tk, tv, tm, _ = tstep(tcols, tmask)
    jm = _np(jm)
    np.testing.assert_array_equal(tm.numpy(), jm)
    assert jm.sum() == 6
    for g_, w in zip(list(tk) + list(tv), list(jk) + list(jv)):
        np.testing.assert_array_equal(g_.numpy()[jm], _np(w)[jm])
