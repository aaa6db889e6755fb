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
