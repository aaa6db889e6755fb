"""K1's two forms and K13's dense form (csrc/dense_agg.cuh, one launch a
call) on the CPU, against the JAX package.

- The compacted form's twin (``dense_grouped_plain``, grouped_aggregate's
  dense path on the CPU) against the JAX package's ``grouped_aggregate``:
  bad rows, a domain above out_capacity (overflow), below it (padding),
  int32 sums that wrap, NaN min and max, one live slot, every slot live,
  count-only aggregates.
- A numpy model of the kernel, step for step: each fold's zero-identity
  word (DenseFold), the warp's groups over 32-row warp steps and their
  combining tree (dense_group / dense_reduce: the kernel reduces integer
  words in one warp reduction, whose result the tree's equals, and float
  sums along the tree, in the tree's order), the leaders' folds into the
  slots, and the last block's finish (dense_finish) in both forms, against
  the JAX package's ``grouped_aggregate`` and ``dense_group_states``.
- K13's generated source with its compile-time folds (``AbFoldList``)
  compiled by g++ (the header's host branch): its keys and value words
  through the same model against the interpreted chain's aggregate.

Integers, keys, masks and flags bit for bit; float sums at rtol 1e-12 (the
orders of addition differ).  The kernels themselves are held against the
twins on the card by tests/test_torch_cuda.py and chip_smoke.py.
"""
import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from arrow_ballista_tpu.ops import kernels as JK
from arrow_ballista_tpu_torch.compile import fused as F
from arrow_ballista_tpu_torch.ops import kernels as TK
from arrow_ballista_tpu_torch.ops.physical import TaskContext

torch.set_num_threads(1)

I64_MIN, I64_MAX = np.iinfo(np.int64).min, np.iinfo(np.int64).max

CASES = ["bad_rows", "overflow", "padding", "int32_sums_wrap", "nan_min_max", "one_live_slot",
         "every_slot_live", "count_only"]
CAPS = ["below", "domain", "above"]


def case_inputs(case, n, rng):
    """(keys, vals, mask, ranges, out_capacity kinds the case is about)."""
    mask = rng.random(n) < 0.85
    k1 = rng.integers(-1, 4, n).astype(np.int32)
    k2 = rng.integers(0, 3, n).astype(np.int64)
    ranges = ((-1, 3), (0, 2))
    f = rng.normal(size=n) * 1e3
    vals = [(rng.integers(-10**12, 10**12, n).astype(np.int64), "sum"), (f, "sum"),
            (np.zeros(n, np.int64), "count"),
            (rng.integers(I64_MIN, I64_MAX, n, dtype=np.int64), "min"), (f, "max")]
    if case == "bad_rows":  # codes -1 and 3 of k1 lie outside
        ranges = ((0, 2), (0, 2))
    elif case == "overflow":  # 15 slots, most live, into fewer rows
        pass
    elif case == "padding":
        ranges = ((-1, 3),)
        k2 = None
    elif case == "int32_sums_wrap":
        big = rng.integers(2**29, 2**31 - 1, n).astype(np.int32)
        vals = [(big, "sum"), (rng.integers(-2**31, 2**31 - 1, n).astype(np.int32), "min"),
                (rng.integers(-2**31, 2**31 - 1, n).astype(np.int32), "max")]
    elif case == "nan_min_max":
        f[rng.random(n) < 0.02] = np.nan
        q = (rng.integers(-256, 256, n) / 4).astype(np.float32)
        q[rng.random(n) < 0.02] = np.nan
        q[rng.random(n) < 0.05] = -0.0
        vals = [(f, "min"), (f, "max"), (q, "min"), (q, "max"), (q, "sum")]
    elif case == "one_live_slot":
        k1, k2 = np.full(n, 2, np.int32), np.full(n, 1, np.int64)
    elif case == "every_slot_live":
        slot = np.arange(n) % 15
        k1, k2 = (slot // 3 - 1).astype(np.int32), (slot % 3).astype(np.int64)
        mask = np.ones(n, bool)
    elif case == "count_only":
        vals = [(np.zeros(n, np.int64), "count"), (np.zeros(n, np.int64), "count")]
    else:
        raise KeyError(case)
    keys = [k1] if k2 is None else [k1, k2]
    return keys, vals, mask, ranges


def _cap(kind, domain):
    return {"below": max(1, domain // 2), "domain": domain, "above": domain + 11}[kind]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _jax_grouped(keys, vals, mask, cap, ranges):
    return JK.grouped_aggregate([jnp.asarray(k) for k in keys],
                                [(jnp.asarray(v), h) for v, h in vals], jnp.asarray(mask), cap,
                                key_ranges=ranges)


def assert_grouped(got, want, vals):
    """(keys, vals, mask, overflow or None), numpy-convertible, against the
    JAX package's."""
    gk, gv, gm, go = got
    jk, jv, jm, jo = want
    np.testing.assert_array_equal(np.asarray(gm), np.asarray(jm))
    assert (go is None) == (jo is None)
    if go is not None:
        assert bool(go) == bool(jo)
    for g, w in zip(gk, jk):
        assert np.asarray(g).dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    for (v, how), g, w in zip(vals, gv, jv):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype
        if w.dtype.kind == "f" and how == "sum":
            np.testing.assert_allclose(g, w, rtol=1e-12, atol=0)
        else:
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("cap", CAPS)
@pytest.mark.parametrize("case", CASES)
def test_compacted_twin_matches_jax(case, cap):
    keys, vals, mask, ranges = case_inputs(case, 3001, np.random.default_rng(3))
    domain = TK.dense_domain(ranges)
    out_cap = _cap(cap, domain)
    got = TK.dense_grouped([_t(k) for k in keys], [(_t(v), h) for v, h in vals], _t(mask),
                           out_cap, ranges, domain)
    want = _jax_grouped(keys, vals, mask, out_cap, ranges)
    assert_grouped([[x.numpy() for x in got[0]], [x.numpy() for x in got[1]], got[2].numpy(),
                    got[3]], want, vals)
    # the dense path of grouped_aggregate is the compacted form
    again = TK.grouped_aggregate([_t(k) for k in keys], [(_t(v), h) for v, h in vals], _t(mask),
                                 out_cap, key_ranges=ranges)
    assert all(torch.equal(a, b) for a, b in zip(again[2:3] + tuple(again[0]),
                                                 got[2:3] + tuple(got[0])))


# --------------------------------------------------------------------------
# the numpy model of csrc/dense_agg.cuh
# --------------------------------------------------------------------------

_SIGN = {8: np.uint64(1 << 63), 4: np.uint32(1 << 31)}
_UINT = {8: np.uint64, 4: np.uint32}
_FLOAT = {8: np.float64, 4: np.float32}


def _width(how, dt):
    return 8 if how == "count" else np.dtype(dt).itemsize


def encode(how, dt, v):
    """DenseFold::encode: a value's bits -> its word (zero the identity;
    NaN above everything for min and max)."""
    w = _width(how, dt)
    if how == "count":
        return np.ones(len(v), np.uint64)
    b = np.ascontiguousarray(v).view(_UINT[w])
    if how == "sum":
        return b.copy()
    sign = _SIGN[w]
    if np.dtype(dt).kind == "f":
        key = np.where(b >> _UINT[w](8 * w - 1), ~b, b | sign)
        word = key if how == "max" else ~key
        return np.where(np.isnan(v), ~_UINT[w](0), word)
    return b ^ sign if how == "max" else ~(b ^ sign)


def combine(how, dt, a, b):
    """DenseFold::combine: + (wrapping, or in the float type) or max."""
    w = _width(how, dt)
    if how in ("min", "max"):
        return np.maximum(a, b)
    if how == "sum" and np.dtype(dt).kind == "f":
        return (a.view(_FLOAT[w]) + b.view(_FLOAT[w])).view(_UINT[w])
    return a + b


def decode(how, dt, words):
    """dense_decode: words -> values in the dtype (identities for zero)."""
    out_dt = np.int64 if how == "count" else np.dtype(dt)
    w = _width(how, dt)
    x = words.astype(_UINT[w])
    if how in ("sum", "count"):
        return x.view(out_dt)
    sign = _SIGN[w]
    if out_dt.kind == "i":
        return (x ^ sign if how == "max" else ~x ^ sign).view(out_dt)
    key = x if how == "max" else ~x
    bits = np.where(key >> _UINT[w](8 * w - 1), key ^ sign, ~key)
    out = bits.view(out_dt).copy()
    out[x == 0] = -np.inf if how == "max" else np.inf
    out[x == ~_UINT[w](0)] = np.nan
    return out


def warp_tree(slots):
    """dense_group: each lane's peers, whether it leads, and the combining
    tree's source lane (or -1) per level."""
    lanes = len(slots)
    peers = [np.flatnonzero(slots == s) for s in slots]
    leader = np.array([p[0] == i for i, p in enumerate(peers)])
    rest = [set(p[p > i]) for i, p in enumerate(peers)]
    rank = np.array([int(np.sum(p < i)) for i, p in enumerate(peers)])
    levels = []
    while any(rest):
        src = np.array([min(r) if r else -1 for r in rest])
        levels.append(src)
        done = {i for i in range(lanes) if rank[i] & 1}
        rest = [r - done for r in rest]
        rank >>= 1
    assert len(levels) <= 5
    return peers, leader, levels


def k1_model(keys, vals, mask, ranges, out_capacity=None):
    """The kernel's result, step for step: (keys, vals, mask, overflow or
    None) for the compacted form, (vals, exists, bad) for the slot-aligned
    one."""
    sizes = [hi - lo + 1 for lo, hi in ranges]
    strides = [int(np.prod(sizes[j + 1:])) for j in range(len(sizes))]
    domain = int(np.prod(sizes))
    n = len(mask)
    ints = [np.asarray(k).astype(np.int64).astype(np.int32) for k in keys]  # (int) truncates
    in_range = np.ones(n, bool)
    fused = np.zeros(n, np.int64)
    for k, (lo, hi), st in zip(ints, ranges, strides):
        in_range &= (k >= lo) & (k <= hi)
        fused += (k.astype(np.int64) - lo) * st
    bad = bool((mask & ~in_range).any())
    slot = np.where(mask & in_range, fused, -1)
    words = [np.zeros(domain, _UINT[_width(h, v.dtype)]) for v, h in vals]
    exists = np.zeros(domain, np.int64)
    enc = [encode(h, v.dtype, v) for v, h in vals]
    for base in range(0, n, 32):  # one warp step: 32 consecutive rows
        s = slot[base:base + 32]
        s = np.concatenate([s, np.full(32 - len(s), -1)])
        peers, leader, levels = warp_tree(s)
        for lane in np.flatnonzero(leader & (s >= 0)):
            exists[s[lane]] += len(peers[lane])
        for a, (v, how) in enumerate(vals):
            x = np.concatenate([enc[a][base:base + 32],
                                np.zeros(32 - len(enc[a][base:base + 32]), enc[a].dtype)])
            if how == "count":
                x = np.array([len(p) for p in peers], np.uint64)
            else:
                for src in levels:  # every lane reads its source before any adds
                    t = x[np.maximum(src, 0)]
                    x = np.where(src >= 0, combine(how, v.dtype, x, t), x)
            for lane in np.flatnonzero(leader & (s >= 0)):
                acc = words[a][s[lane]:s[lane] + 1]
                words[a][s[lane]] = combine(how, v.dtype, acc, x[lane:lane + 1])[0]
    values = [decode(h, v.dtype, w) for (v, h), w in zip(vals, words)]
    if out_capacity is None:
        return values, exists.astype(np.int32), bad
    # dense_finish: the groups in slot order, then the empty slots
    live = exists > 0
    order = np.concatenate([np.flatnonzero(live), np.flatnonzero(~live)])
    rows = min(domain, out_capacity)
    order = order[:rows]
    out_keys = []
    for (lo, _hi), st, size, k in zip(ranges, strides, sizes, keys):
        out_keys.append(np.zeros(out_capacity, np.asarray(k).dtype))
        out_keys[-1][:rows] = (lo + (order // st) % size).astype(np.asarray(k).dtype)
    out_mask = np.zeros(out_capacity, bool)
    out_mask[:rows] = live[order]
    out_vals = []
    for v in values:
        col = np.zeros(out_capacity, v.dtype)
        col[:rows] = v[order]
        out_vals.append(col)
    overflow = None if domain <= out_capacity else (int(live.sum()) > out_capacity) | bad
    return out_keys, out_vals, out_mask, overflow


@pytest.mark.parametrize("cap", CAPS)
@pytest.mark.parametrize("case", CASES)
def test_kernel_model_compacted_matches_jax(case, cap):
    keys, vals, mask, ranges = case_inputs(case, 1500, np.random.default_rng(4))
    out_cap = _cap(cap, TK.dense_domain(ranges))
    assert_grouped(k1_model(keys, vals, mask, ranges, out_cap),
                   _jax_grouped(keys, vals, mask, out_cap, ranges), vals)


@pytest.mark.parametrize("case", CASES)
def test_kernel_model_slot_aligned_matches_jax(case):
    keys, vals, mask, ranges = case_inputs(case, 1500, np.random.default_rng(5))
    domain = TK.dense_domain(ranges)
    values, exists, bad = k1_model(keys, vals, mask, ranges)
    jv, je, jb = JK.dense_group_states([jnp.asarray(k) for k in keys],
                                       [(jnp.asarray(v), h) for v, h in vals],
                                       jnp.asarray(mask), ranges, domain)
    np.testing.assert_array_equal(exists, np.asarray(je))
    assert bad == bool(jb)
    assert_grouped([[], values, exists > 0, None], [[], jv, np.asarray(je) > 0, None], vals)


@pytest.mark.parametrize("group", [[5] * 32, list(range(32)), [1, 2] * 16, [7] * 31 + [-1],
                                   [0, 0, 1, 0, 2, 2, 2, 0] * 4])
def test_warp_tree_sums_every_group_at_its_leader(group):
    """dense_group's tree: at most five levels, and each leader ends with
    its group's sum whatever the lanes' pattern."""
    s = np.array(group)
    peers, leader, levels = warp_tree(s)
    x = np.arange(1, 33, dtype=np.int64) ** 2
    for src in levels:
        x = np.where(src >= 0, x + x[np.maximum(src, 0)], x)
    for lane in np.flatnonzero(leader):
        assert x[lane] == sum((np.arange(1, 33) ** 2)[peers[lane]])


# --------------------------------------------------------------------------
# K13's generated source under g++
# --------------------------------------------------------------------------

CSRC = str(__import__("pathlib").Path(F.__file__).resolve().parent.parent / "csrc")


def _fold_chain(n, rng):
    """A filter and a partial aggregate over two dictionary keys with every
    fold the engine's aggregates produce: int64, int32 (dates) and float64
    sums, mins and maxes, counts."""
    import pyarrow as pa

    from arrow_ballista_tpu_torch.catalog import MemoryTable
    from arrow_ballista_tpu_torch.models import expr as E
    from arrow_ballista_tpu_torch.models.batch import concat_batches
    from arrow_ballista_tpu_torch.ops import operators as O

    words = ["a", "b", "c", "d", "e"]
    f = rng.normal(size=n) * 100
    f[rng.random(n) < 0.01] = np.nan
    table = pa.table({
        "s": pa.DictionaryArray.from_arrays(pa.array(rng.integers(0, 5, n).astype(np.int32),
                                                     mask=rng.random(n) < 0.05),
                                            pa.array(words)),
        "t": pa.DictionaryArray.from_arrays(pa.array(rng.integers(0, 3, n).astype(np.int32)),
                                            pa.array(words[:3])),
        "v": pa.array(rng.integers(-10**12, 10**12, n).astype(np.int64)),
        "d": pa.array(rng.integers(8000, 10500, n).astype(np.int32), type=pa.int32()),
        "f": pa.array(f),
    })
    ctx = TaskContext(device=torch.device("cpu"))
    scan = MemoryTable("folds", table).scan(None, [], 1)
    big = concat_batches(scan.schema, scan.execute(0, ctx), device=torch.device("cpu"))
    filt = O.FilterExec(scan, E.BinOp(">", E.Column("v"), E.Lit(-9 * 10**11)))
    aggs = [O.AggSpec(how, E.Column(col), f"{how}_{col}") for how in ("sum", "min", "max")
            for col in ("v", "d", "f")] + [O.AggSpec("count", None, "c")]
    agg = O.HashAggregateExec(filt, [(E.Column("s"), "s"), (E.Column("t"), "t")], aggs, "partial")
    prog = F.FusedStageExec([agg, filt]).program(ctx)
    auxs, dicts = prog.auxs_and_dicts(big.dicts)
    ranges = agg._key_ranges(prog.agg_compiled[1], dicts)
    return prog, big, auxs, ranges


def _keys_words(lib, prog, cols, mask, auxs):
    fin = F._FusedIn()
    keep = []
    for k, (name, dt) in enumerate(prog.gen.inputs):
        t = cols[name].contiguous()
        keep.append(t)
        fin.col[k] = t.data_ptr()
    m = mask.contiguous()
    keep.append(m)
    fin.mask = m.data_ptr()
    for k, (step, slot, _dt) in enumerate(prog.gen.aux):
        t = auxs[step][slot].contiguous()
        keep.append(t)
        fin.aux[k] = t.data_ptr()
        fin.aux_len[k] = t.shape[0]
    n = mask.shape[0]
    live = np.zeros(n, np.bool_)
    keys = np.zeros((n, len(prog.gen.key_dtypes)), np.int32)
    words = np.zeros((n, max(len(prog.gen.vals), 1)), np.uint64)
    lib.ab_fused_keys_words_host(ctypes.byref(fin), ctypes.c_longlong(n),
                                 live.ctypes.data_as(ctypes.c_void_p),
                                 keys.ctypes.data_as(ctypes.c_void_p),
                                 words.ctypes.data_as(ctypes.c_void_p))
    return live, keys, words


@pytest.mark.skipif(shutil.which("g++") is None, reason="no g++ on the PATH")
def test_generated_folds_compiled_by_gxx_match_the_interpreted_chain(tmp_path):
    rng = np.random.default_rng(6)
    prog, big, auxs, ranges = _fold_chain(4000, rng)
    gen = prog.gen
    how_code = {"sum": 0, "count": 1, "min": 2, "max": 3}
    kind_code = {torch.int32: 0, torch.int64: 1, torch.float32: 3, torch.float64: 4}
    folds = ", ".join(f"AbFold<{how_code[h]}, {1 if h == 'count' else kind_code[dt]}>"
                      for dt, h in gen.vals)
    assert f"using AbFoldList = AbFolds<{folds}>;" in gen.source
    assert {h for _dt, h in gen.vals} == {"sum", "min", "max", "count"}
    assert {dt for dt, h in gen.vals if h != "count"} >= {torch.int32, torch.int64,
                                                          torch.float64}
    cu = tmp_path / "chain.cu"
    cu.write_text(gen.source)
    so = tmp_path / "libchain.so"
    proc = subprocess.run(["g++", "-std=c++17", "-O2", "-shared", "-fPIC", "-ffp-contract=off",
                           "-I", CSRC, "-x", "c++", str(cu), "-o", str(so)],
                          capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    live, keys, words = _keys_words(ctypes.CDLL(str(so)), prog, big.columns, big.mask, auxs)
    # the value words as the columns the kernel folds (a count's word is 1)
    vals = []
    for a, (dt, how) in enumerate(gen.vals):
        np_dt = {torch.int32: np.int32, torch.int64: np.int64, torch.float64: np.float64}[
            torch.int64 if how == "count" else dt]
        col = words[:, a].astype(np.uint64)
        col = (col.astype(np.uint32) if np.dtype(np_dt).itemsize == 4 else col).view(np_dt)
        vals.append((col, how))
    domain = TK.dense_domain(ranges)
    got = k1_model([keys[:, j] for j in range(keys.shape[1])], vals, live, ranges, domain)
    want = F.fused_agg_plain(prog, big.columns, big.mask, auxs, domain, ranges)
    assert int(want[2].sum()) > 1
    # the generated keys are int32 values; the chain's key dtypes decide the output's
    got = ([g.astype(w.numpy().dtype) for g, w in zip(got[0], want[0])], *got[1:])
    assert_grouped(got, [[w.numpy() for w in want[0]], [w.numpy() for w in want[1]],
                         want[2].numpy(), want[3]], vals)
