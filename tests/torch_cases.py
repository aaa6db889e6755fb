"""Input cases shared by the port's tests (numpy only, no JAX):
tests/test_torch_kernels.py and tests/test_torch_join_kernels.py hold the
twins against the JAX package on the CPU, tests/test_torch_joins.py the
port's SQL against the JAX package, and tests/test_torch_cuda.py the CUDA
kernels against the twins and the port's SQL on the card against the port
on the CPU.  ``remote_cluster`` starts either package's scheduler service
and executors in process (the reference's only when a test asks for it,
so this module imports no JAX)."""
import contextlib
import os

import numpy as np

from benchmarks.queries import QUERIES

I64_MIN, I64_MAX = np.iinfo(np.int64).min, np.iinfo(np.int64).max

HASH_CASES = ["int32_negative", "int64_extremes", "bool", "null_code_and_int64", "three_mixed"]


def hash_cols(case, n, rng):
    if case == "int32_negative":
        return [rng.integers(-5, 40, n).astype(np.int32)]
    if case == "int64_extremes":
        a = rng.integers(I64_MIN, I64_MAX, n, dtype=np.int64)
        a[:4] = [I64_MIN, I64_MAX, -1, 0]
        return [a]
    if case == "bool":
        return [rng.random(n) < 0.5]
    if case == "null_code_and_int64":
        codes = rng.integers(-1, 16, n).astype(np.int32)  # -1 = NULL string code
        return [codes, rng.integers(-2**40, 2**40, n).astype(np.int64)]
    if case == "three_mixed":
        return [rng.integers(-3, 3, n).astype(np.int32), rng.random(n) < 0.3,
                rng.integers(I64_MIN, I64_MAX, n, dtype=np.int64)]
    raise KeyError(case)


def mask_case(case, n, rng):
    if case == "random":
        return rng.random(n) < 0.37
    if case == "all_live":
        return np.ones(n, dtype=bool)
    if case == "all_dead":
        return np.zeros(n, dtype=bool)
    if case == "alternating":
        return (np.arange(n) % 2) == 0
    if case == "tail_dead":
        m = np.ones(n, dtype=bool)
        m[n // 3:] = False
        return m
    raise KeyError(case)


SORT_CASES = ["ties_int32_asc", "desc_int64_with_min", "bool_desc_then_int_asc",
              "float_nan_signed_zero", "float_desc", "float32_keys", "dict_codes_q1"]


def sort_case(case, n, rng):
    mask = rng.random(n) < 0.8
    if case == "ties_int32_asc":
        return [(rng.integers(-3, 3, n).astype(np.int32), True)], mask
    if case == "desc_int64_with_min":
        a = rng.integers(-5, 5, n).astype(np.int64)
        a[rng.random(n) < 0.05] = I64_MIN  # negation wraps: INT64_MIN stays put
        a[rng.random(n) < 0.05] = I64_MAX
        return [(a, False)], mask
    if case == "bool_desc_then_int_asc":
        return [(rng.random(n) < 0.5, False), (rng.integers(0, 4, n).astype(np.int32), True)], mask
    if case == "float_nan_signed_zero":
        f = rng.integers(-2, 3, n).astype(np.float64)
        f[rng.random(n) < 0.1] = np.nan
        f[rng.random(n) < 0.1] = -0.0
        f[rng.random(n) < 0.05] = np.inf
        return [(f, True), (rng.integers(0, 3, n).astype(np.int32), False)], mask
    if case == "float_desc":
        f = np.round(rng.normal(size=n), 1)
        f[rng.random(n) < 0.1] = np.nan
        return [(f, False)], mask
    if case == "float32_keys":
        f = np.round(rng.normal(size=n), 1).astype(np.float32)
        f[rng.random(n) < 0.1] = np.nan
        return [(f, True), (f, False)], mask
    if case == "dict_codes_q1":  # the main path: two dictionary-code keys
        return [(rng.integers(-1, 3, n).astype(np.int32), True),
                (rng.integers(-1, 2, n).astype(np.int32), True)], mask
    raise KeyError(case)


# K4's radix form: composites wider than one limb, fields that straddle bit
# 64, spans past 2^63, constant words and degenerate sizes
RADIX_CASES = ["straddle_64", "eight_keys", "constant_keys_random_mask", "all_rows_equal",
               "full_range_int64", "nan_signed_zero_desc", "int64_min_desc_small",
               "nan_against_negative", "one_row", "all_dead", "q18_orderkey"]


def radix_case(case, n, rng):
    """(keys, mask, n) for K4's radix form; ``n`` may be overridden."""
    mask = rng.random(n) < 0.8
    if case == "straddle_64":  # dead 1 + 41 + 32 bits: the 41-bit field crosses bit 64
        return [(rng.integers(0, 2**41, n).astype(np.int64), True),
                (rng.integers(-2**31, 2**31, n).astype(np.int32), False)], mask, n
    if case == "eight_keys":  # 1 + 3 + 64 + 1 + 64 + 64 + 32 + 20 + 2 bits: four limbs
        f = rng.normal(size=n)
        f[rng.random(n) < 0.05] = np.nan
        return [(rng.integers(0, 5, n).astype(np.int32), True),
                (rng.integers(I64_MIN, I64_MAX, n, dtype=np.int64), False),
                (rng.random(n) < 0.5, False),
                (f, True),
                (f.astype(np.float32), False),
                (rng.integers(-2**31, 2**31, n).astype(np.int32), True),
                (rng.integers(-2**19, 2**19, n).astype(np.int64), False),
                (rng.integers(-1, 3, n).astype(np.int32), True)], mask, n
    if case == "constant_keys_random_mask":  # only the dead flag is left: one bit
        return [(np.full(n, 7, np.int32), True), (np.full(n, -3.5), False)], mask, n
    if case == "all_rows_equal":  # every word constant: the identity
        return [(np.full(n, 11, np.int64), False), (np.zeros(n, bool), True)], \
            np.ones(n, bool), n
    if case == "full_range_int64":  # the span is 2^64 - 1
        a = rng.integers(I64_MIN, I64_MAX, n, dtype=np.int64)
        a[:2] = [I64_MIN, I64_MAX]
        a[rng.random(n) < 0.1] = 0
        return [(a, True)], mask, n
    if case == "nan_signed_zero_desc":
        f = rng.integers(-2, 3, n).astype(np.float64)
        f[rng.random(n) < 0.1] = np.nan
        f[rng.random(n) < 0.1] = -0.0
        f[rng.random(n) < 0.05] = -np.inf
        f[rng.random(n) < 0.05] = np.inf
        return [(f, False), (f.astype(np.float32), False)], mask, n
    if case == "int64_min_desc_small":  # INT64_MIN stays put under desc: span past 2^63
        a = rng.integers(-3, 4, n).astype(np.int64)
        a[rng.random(n) < 0.05] = I64_MIN
        return [(a, False)], mask, n
    if case == "nan_against_negative":  # the NaN word against negative floats
        f = -rng.random(n) * 1e300
        f[rng.random(n) < 0.2] = np.nan
        return [(f, True)], mask, n
    if case == "one_row":
        return [(rng.integers(-5, 5, 1).astype(np.int64), True)], rng.random(1) < 0.5, 1
    if case == "all_dead":  # dead rows still order by their keys
        return [(rng.integers(-3, 3, n).astype(np.int32), True),
                (rng.integers(0, 1000, n).astype(np.int64), False)], np.zeros(n, bool), n
    if case == "q18_orderkey":  # about 23 bits and the dead flag: one limb, 3 passes
        return [(rng.integers(1, 6_000_000, n).astype(np.int64), True)], mask, n
    raise KeyError(case)


DENSE_CASES = ["q1_dict_codes", "sums_wrap", "empty_slots_keep_identities",
               "bool_and_int64_keys", "float64_values", "out_of_range_rows",
               "int32_sums_wrap", "int32_float32_values"]


def dense_case(case, n, rng):
    mask = rng.random(n) < 0.9
    k1 = rng.integers(-1, 4, n).astype(np.int32)  # dict codes with the NULL code -1
    k2 = rng.integers(0, 2, n).astype(np.int32)
    if case == "q1_dict_codes":
        ranges = ((-1, 15), (-1, 15))
        keys = [k1, k2]
        vals = [(rng.integers(0, 10**9, n).astype(np.int64), "sum"),
                (np.zeros(n, np.int64), "count"),
                (rng.integers(-10**6, 10**6, n).astype(np.int64), "min"),
                (rng.integers(-10**6, 10**6, n).astype(np.int64), "max")]
    elif case == "sums_wrap":
        ranges = ((-1, 3), (0, 1))
        keys = [k1, k2]
        vals = [(rng.integers(2**61, 2**62, n).astype(np.int64), "sum"),
                (rng.integers(I64_MIN, I64_MAX, n, dtype=np.int64), "min"),
                (rng.integers(I64_MIN, I64_MAX, n, dtype=np.int64), "max")]
    elif case == "empty_slots_keep_identities":
        ranges = ((-1, 63),)
        keys = [k1]
        vals = [(rng.integers(-50, 50, n).astype(np.int64), "min"),
                (rng.integers(-50, 50, n).astype(np.int64), "max"),
                (rng.integers(-50, 50, n).astype(np.int64), "sum")]
    elif case == "bool_and_int64_keys":
        ranges = ((0, 1), (-1, 3))
        keys = [rng.random(n) < 0.5, k1.astype(np.int64)]
        vals = [(rng.integers(0, 100, n).astype(np.int64), "sum"),
                (np.zeros(n, np.int64), "count")]
    elif case == "float64_values":
        ranges = ((-1, 3),)
        keys = [k1]
        f = rng.normal(size=n) * 1e3
        vals = [(f, "sum"), (f, "min"), (f, "max")]
    elif case == "out_of_range_rows":
        ranges = ((0, 2),)  # the -1 and 3 codes lie outside
        keys = [k1]
        vals = [(rng.integers(0, 100, n).astype(np.int64), "sum"),
                (np.zeros(n, np.int64), "count")]
    elif case == "int32_sums_wrap":  # int32 sums stay int32 and wrap mod 2^32
        ranges = ((-1, 15), (-1, 15))
        keys = [k1, k2]
        big = rng.integers(2**29, 2**31 - 1, n).astype(np.int32)
        vals = [(big, "sum"), (rng.integers(-2**31, 2**31 - 1, n).astype(np.int32), "min"),
                (rng.integers(-2**31, 2**31 - 1, n).astype(np.int32), "max")]
    elif case == "int32_float32_values":  # a date max and float32 quarters (exact sums)
        ranges = ((-1, 63),)  # empty slots keep the iinfo / finfo identities
        keys = [k1]
        quarter = (rng.integers(-256, 256, n) / 4).astype(np.float32)
        quarter[rng.random(n) < 0.01] = np.nan
        dates = rng.integers(8000, 10500, n).astype(np.int32)
        vals = [(dates, "max"), (dates, "min"), (dates, "sum"), (quarter, "sum"),
                (quarter, "min"), (quarter, "max"), (np.zeros(n, np.int64), "count")]
    else:
        raise KeyError(case)
    return keys, vals, mask, ranges


# --------------------------------------------------------------------------
# joins (K5 build_side_sort, K6 probe_join, K7 segment_any)
# --------------------------------------------------------------------------

JOIN_CASES = ["dup_keys", "null_code_keys", "all_dead_build", "all_dead_probe", "heavy_fanout"]


def join_case(case, n_build, n_probe, rng):
    """(build_keys, build_mask, probe_keys, probe_mask): two key columns
    each side, int64 and int32 (the int32 side sign-extends in the hash)."""
    bmask = rng.random(n_build) < 0.85
    pmask = rng.random(n_probe) < 0.75
    if case == "dup_keys":  # several build rows per key, fan-out 1-10
        bk = [rng.integers(0, n_build // 5, n_build).astype(np.int64),
              rng.integers(0, 2, n_build).astype(np.int32)]
        pk = [rng.integers(0, n_build // 4, n_probe).astype(np.int64),
              rng.integers(0, 2, n_probe).astype(np.int32)]
    elif case == "null_code_keys":
        bk = [rng.integers(-1, 30, n_build).astype(np.int32)]
        pk = [rng.integers(-1, 40, n_probe).astype(np.int32)]
    elif case == "all_dead_build":
        bk = [rng.integers(0, 50, n_build).astype(np.int64)]
        pk = [rng.integers(0, 50, n_probe).astype(np.int64)]
        bmask[:] = False
    elif case == "all_dead_probe":
        bk = [rng.integers(0, 50, n_build).astype(np.int64)]
        pk = [rng.integers(0, 50, n_probe).astype(np.int64)]
        pmask[:] = False
    elif case == "heavy_fanout":  # a handful of keys: hundreds of pairs a probe row
        bk = [rng.integers(0, 8, n_build).astype(np.int64)]
        pk = [rng.integers(0, 9, n_probe).astype(np.int64)]
    else:
        raise KeyError(case)
    return bk, bmask, pk, pmask


PROBE_CASES = ["dup_fanout", "selective", "all_dead_probe", "ones_probe_dead_tail",
               "forced_collisions", "one_build_row", "last_row_dead", "last_row_live"]


def probe_case(case, n_probe, rng, n_build=None):
    """(probe hashes, probe mask, sorted build hashes) for K6 as numpy uint64,
    made directly (no hash): build hashes sorted as uint64 with the dead rows'
    all-ones at the tail, as K5 leaves them."""
    ones = np.uint64(0xFFFFFFFFFFFFFFFF)
    nb = n_build if n_build is not None else max(1, n_probe // 2)
    pmask = rng.random(n_probe) < 0.75
    if case == "one_build_row":
        nb = 1
    if case == "forced_collisions":  # every hash 0; dead build rows all ones
        live_b = rng.random(nb) < 0.9
        bh = np.where(np.sort(~live_b), ones, np.uint64(0))
        return np.zeros(n_probe, np.uint64), pmask, bh
    pool = rng.integers(0, 2**64, max(4, nb // 3), dtype=np.uint64)
    if case == "selective":  # unique build keys, few probe rows match
        build = rng.integers(0, 2**64, nb, dtype=np.uint64)
        probe = rng.integers(0, 2**64, n_probe, dtype=np.uint64)
        hit = rng.random(n_probe) < 0.05
        probe[hit] = build[rng.integers(0, nb, int(hit.sum()))]
        pmask = rng.random(n_probe) < 0.3
    else:  # about three build rows a key; probe keys half from the pool
        build = pool[rng.integers(0, len(pool), nb)]
        probe = np.where(rng.random(n_probe) < 0.5, pool[rng.integers(0, len(pool), n_probe)],
                         rng.integers(0, 2**64, n_probe, dtype=np.uint64))
    dead_b = rng.random(nb) < 0.15
    build = np.sort(np.where(dead_b, ones, build))
    if case == "all_dead_probe":
        pmask[:] = False
    elif case == "ones_probe_dead_tail":  # live all-ones probe hashes meet the dead tail
        probe[rng.random(n_probe) < 0.2] = ones
        build[-max(1, nb // 10):] = ones
    elif case == "last_row_dead":
        pmask[-1] = False
        probe[-1] = build[nb // 2]
    elif case == "last_row_live":
        pmask[-1] = True
        probe[-1] = build[nb // 2]
    return probe, pmask, build


def segment_case(case, n, num_segments, rng):
    """(values, seg_ids) for segment_any."""
    if case == "bool_random":
        return rng.random(n) < 0.2, rng.integers(0, num_segments, n).astype(np.int32)
    if case == "int32_signed_out_of_range":  # only values > 0 count; bad ids drop
        return (rng.integers(-3, 3, n).astype(np.int32),
                rng.integers(-5, num_segments + 5, n).astype(np.int32))
    if case == "one_segment_all_rows":
        return np.ones(n, dtype=bool), np.full(n, num_segments // 2, dtype=np.int32)
    raise KeyError(case)


SEGMENT_CASES = ["bool_random", "int32_signed_out_of_range", "one_segment_all_rows"]

# K7 over K6's probe index: ids non-decreasing (probe-major pairs, then
# np - 1 in every slot past the total)
K6_SEGMENT_CASES = ["k6_pairs", "long_runs_late_hit", "fill_tail", "out_of_range_ids",
                    "few_pairs_many_segments", "int32_signed", "no_pairs"]


def k6_segment_case(case, n, num_segments, rng):
    """(values, non-decreasing seg_ids) for segment_any over K6-shaped
    ids, n pairs over num_segments segments."""
    ns = num_segments
    if case == "no_pairs":
        return np.zeros(0, dtype=bool), np.zeros(0, dtype=np.int32)
    if case == "few_pairs_many_segments":
        n = max(1, n // 64)
    if case in ("k6_pairs", "few_pairs_many_segments", "int32_signed", "fill_tail"):
        total = n * 3 // 5 if case == "fill_tail" else n
        seg = np.sort(rng.integers(0, ns, total)).astype(np.int32)
        seg = np.concatenate([seg, np.full(n - total, ns - 1, np.int32)])
        values = rng.random(n) < 0.3
        if case == "fill_tail":  # slots past the total are invalid pairs
            values[total:] = False
        if case == "int32_signed":
            return rng.integers(-3, 3, n).astype(np.int32), seg
        return values, seg
    if case == "long_runs_late_hit":
        # runs many tiles long, each true only near its end or nowhere
        lengths = rng.integers(1, 3 * 4096, ns)
        seg = np.repeat(np.arange(ns, dtype=np.int32), lengths)[:n]
        values = np.zeros(len(seg), dtype=bool)
        ends = np.cumsum(lengths)
        for s in range(0, ns, 3):
            if ends[s] - 1 < len(seg):
                values[ends[s] - 1] = True
        return values, seg
    if case == "out_of_range_ids":
        seg = np.sort(rng.integers(-5, ns + 5, n)).astype(np.int32)
        return rng.random(n) < 0.4, seg
    raise KeyError(case)

# --------------------------------------------------------------------------
# K8: the sort-path grouped aggregate
# --------------------------------------------------------------------------

SEG_AGG_CASES = ["q3_keys_decimal_sums", "sums_wrap", "empty_slots_identities", "keyless",
                 "keyless_all_dead", "int32_f32_f64_values", "float_keys", "one_big_group"]


def seg_agg_case(case, n, rng):
    """(keys, vals, mask) for grouped_aggregate with no key ranges."""
    mask = rng.random(n) < 0.9
    okey = rng.integers(0, n // 4, n).astype(np.int64)
    if case == "q3_keys_decimal_sums":  # (l_orderkey, o_orderdate, o_shippriority)
        keys = [okey, (9000 + okey % 700).astype(np.int32), np.zeros(n, np.int32)]
        vals = [(rng.integers(0, 10**9, n).astype(np.int64), "sum"),
                (np.zeros(n, np.int64), "count")]
    elif case == "sums_wrap":
        keys = [rng.integers(0, 40, n).astype(np.int64)]
        vals = [(rng.integers(2**61, 2**62, n).astype(np.int64), "sum"),
                (rng.integers(I64_MIN, I64_MAX, n, dtype=np.int64), "min"),
                (rng.integers(I64_MIN, I64_MAX, n, dtype=np.int64), "max")]
    elif case == "empty_slots_identities":  # few groups in many slots
        keys = [rng.integers(-3, 3, n).astype(np.int32)]
        vals = [(rng.integers(-50, 50, n).astype(np.int64), "min"),
                (rng.integers(-50, 50, n).astype(np.int64), "max"),
                (rng.integers(-50, 50, n).astype(np.int32), "min"),
                (rng.integers(-50, 50, n).astype(np.int32), "max"),
                (rng.normal(size=n), "min"), (rng.normal(size=n), "max")]
    elif case == "keyless":
        keys = []
        vals = [(rng.integers(-10**12, 10**12, n).astype(np.int64), "sum"),
                (np.zeros(n, np.int64), "count"),
                (rng.integers(-10**6, 10**6, n).astype(np.int64), "min"),
                (rng.normal(size=n), "max")]
    elif case == "keyless_all_dead":
        keys = []
        mask[:] = False
        vals = [(rng.integers(0, 9, n).astype(np.int64), "sum"), (np.zeros(n, np.int64), "count"),
                (rng.integers(0, 9, n).astype(np.int64), "min"),
                (rng.normal(size=n), "max")]
    elif case == "int32_f32_f64_values":
        keys = [rng.integers(0, 64, n).astype(np.int32)]
        quarter = (rng.integers(-256, 256, n) / 4).astype(np.float32)  # sums exact in any order
        vals = [(rng.integers(-1000, 1000, n).astype(np.int32), "sum"),
                (rng.integers(-1000, 1000, n).astype(np.int32), "min"),
                (quarter, "sum"), (quarter, "max"),
                (rng.normal(size=n) * 1e3, "sum"), (rng.normal(size=n), "min")]
    elif case == "float_keys":  # -0.0 groups with 0.0; every NaN row opens a group
        f = rng.integers(-2, 3, n).astype(np.float64)
        f[rng.random(n) < 0.05] = np.nan
        f[rng.random(n) < 0.1] = -0.0
        keys = [f]
        vals = [(rng.integers(0, 100, n).astype(np.int64), "sum"),
                (np.zeros(n, np.int64), "count")]
    elif case == "one_big_group":
        keys = [np.full(n, 7, np.int64)]
        vals = [(rng.integers(2**61, 2**62, n).astype(np.int64), "sum"),
                (np.zeros(n, np.int64), "count"),
                (rng.normal(size=n), "sum")]
    else:
        raise KeyError(case)
    return keys, vals, mask


# --------------------------------------------------------------------------
# SQL through the joins and the sort-path aggregate (SF0.01, seed 0)
# --------------------------------------------------------------------------

JOIN_QUERIES = {
    "q3": QUERIES[3],
    "q4": QUERIES[4],
    # q18 as written keeps no order at SF0.01 (no sum(l_quantity) > 300)
    "q18": QUERIES[18].replace("> 300", "> 200"),
    # int32 sums and int32 (date) min/max on the dense path (K1)
    "dense_int32_date_values": """
        select o_orderpriority, sum(o_shippriority) as s, min(o_shippriority) as mn,
               max(o_orderdate) as mx, min(o_orderdate) as first_day
        from orders group by o_orderpriority order by o_orderpriority""",
    "q6": QUERIES[6],
    "q12": QUERIES[12],
    "q13": QUERIES[13],
    "anti_not_exists": """
        select c_mktsegment, count(*) as n from customer
        where not exists (select * from orders where o_custkey = c_custkey)
        group by c_mktsegment order by c_mktsegment""",
    "full_outer": """
        select c_custkey, o_orderkey, o_totalprice
        from (select c_custkey from customer where c_custkey < 60) c
        full outer join (select o_orderkey, o_custkey, o_totalprice from orders
                         where o_orderkey < 300) o on c_custkey = o_custkey""",
    "left_residual": """
        select c_custkey, count(o_orderkey) as n, sum(o_totalprice) as tp
        from customer left join orders on c_custkey = o_custkey and o_totalprice > 100000
        where c_custkey < 300 group by c_custkey order by c_custkey""",
}
UNORDERED = {"full_outer"}

# settings applied to both packages: the partitioned join path, and a task
# budget (bytes) that windows q3's lineitem probe (_join_chunked)
SETTINGS = {
    "partitioned": "set ballista.join.broadcast_threshold = 0",
    "windowed": "set ballista.memory.task.budget.bytes = 4096",
}


def assert_frames_equal(got, want, ordered: bool = True, exact: bool = False):
    """Exact on integer, decimal, date and string columns, rtol 1e-12 on
    floats (bit for bit with ``exact``); with ``ordered`` False as
    multisets (ties of an ORDER BY may break either way between two
    engines)."""
    assert list(got.columns) == list(want.columns) and len(got) == len(want), \
        f"shape/columns differ: {list(got.columns)} {len(got)} vs {list(want.columns)} {len(want)}"
    if not ordered:
        cols = list(want.columns)
        got = got.sort_values(cols, kind="mergesort").reset_index(drop=True)
        want = want.sort_values(cols, kind="mergesort").reset_index(drop=True)
    for c in want.columns:
        g, w = got[c].to_numpy(), want[c].to_numpy()
        if w.dtype.kind == "f" and not exact:
            np.testing.assert_allclose(g.astype(float), w.astype(float), rtol=1e-12,
                                       equal_nan=True, err_msg=c)
        else:
            np.testing.assert_array_equal(g, w, err_msg=c)


# --------------------------------------------------------------------------
# K9-K11: the clustered (presorted) partial aggregate
# --------------------------------------------------------------------------

PRESORTED_CASES = ["sorted", "disordered", "disorder_only_across_dead_rows", "int32_keys"]


def presorted_case(case, n, rng):
    """(keys, vals, mask) in key order, for grouped_aggregate_presorted
    (K2 + K9 + K8); ``disordered`` swaps one adjacent live pair."""
    mask = rng.random(n) < 0.85
    keys = np.sort(rng.integers(-50, 400, n)).astype(np.int64)
    if case == "disordered":
        keys[n // 2], keys[n // 2 + 1] = keys[n // 2 + 1] + 5, keys[n // 2]
        mask[n // 2:n // 2 + 2] = True
    elif case == "disorder_only_across_dead_rows":  # dead rows never count
        keys[10] = 10_000
        mask[10] = False
    elif case == "int32_keys":
        keys = keys.astype(np.int32)
    vals = [(rng.integers(-10**9, 10**9, n).astype(np.int64), "sum"),
            (np.zeros(n, np.int64), "count"),
            (rng.integers(-1000, 1000, n).astype(np.int32), "max"),
            ((rng.integers(-64, 64, n) / 4).astype(np.float64), "sum")]
    return keys, vals, mask


# K9 over the rows as they are: the flag is True exactly when the live
# keys, in row order, ever decrease (the reference compares adjacent live
# rows in K2's compaction order).  Each case with the flag it must give;
# the decreases at rows 2,047 / 2,048 and 2,048 / 2,049 straddle K9's
# 2,048-row tile edge.
DISORDER_CASES = {"sorted": False, "shuffled": True, "decrease_across_dead_run": True,
                  "equal_across_dead_row": False, "only_dead_decrease": False,
                  "decrease_at_2047_2048": True, "decrease_at_2048_2049": True,
                  "int32_extremes": False, "int32_extremes_decrease": True,
                  "int64_extremes": False, "int64_extremes_decrease": True,
                  "one_live": False, "two_live": False, "two_live_decrease": True,
                  "all_dead": False}


def disorder_case(case, n, rng):
    """(keys, mask) for K9 at n rows (n >= 2,050): keys sorted with ties
    and 20% of the rows dead unless the case says otherwise."""
    dtype = np.int32 if case.startswith("int32") else np.int64
    mask = rng.random(n) < 0.8
    keys = np.sort(rng.integers(-1000, 1000 + n // 4, n)).astype(dtype)
    if case == "shuffled":
        keys = rng.permutation(keys)
    elif case == "decrease_across_dead_run":  # live i, 40 dead rows, live i + 41
        i = n // 3
        mask[i], mask[i + 1:i + 41], mask[i + 41] = True, False, True
        keys[i + 1:i + 41] = I64_MAX  # dead keys above both decide nothing
        keys[i + 41] = keys[i] - 1
    elif case == "equal_across_dead_row":  # live k, dead k - 100, live k
        i = n // 3
        mask[i:i + 3] = [True, False, True]
        keys[i + 1], keys[i + 2] = keys[i] - 100, keys[i]
    elif case == "only_dead_decrease":
        dead = ~mask
        keys[dead] = -np.arange(int(dead.sum()), dtype=dtype) * 7
    elif case.startswith("decrease_at_"):
        i = int(case.split("_")[2])  # rows i and i + 1
        mask[i:i + 2] = True
        keys[i + 1] = keys[i] - 1
    elif "extremes" in case:
        info = np.iinfo(dtype)
        keys = np.sort(rng.integers(info.min, info.max, n, dtype=dtype, endpoint=True))
        keys[0], keys[-1] = info.min, info.max
        mask[0] = mask[-1] = True
        if case.endswith("_decrease"):  # max, then min
            i = n // 2
            mask[i:i + 2] = True
            keys[i], keys[i + 1] = info.max, info.min
    elif case in ("one_live", "two_live", "two_live_decrease", "all_dead"):
        keys = rng.integers(-1000, 1000, n).astype(dtype)  # any order among dead rows
        mask[:] = False
        live = {"one_live": 1, "two_live": 2, "two_live_decrease": 2, "all_dead": 0}[case]
        at = np.sort(rng.choice(n, live, replace=False))
        mask[at] = True
        if live == 2:
            keys[at] = [5, 9] if case == "two_live" else [9, 5]
    elif case != "sorted":
        raise KeyError(case)
    return keys, mask


RANGE_CASES = ["inside", "above", "below", "null_keys_only_outside", "dead_rows_outside",
               "int32_keys", "all_dead"]


def range_case(case, n, rng):
    """(keys, mask, lo, hi, sentinel or None) for the declared-range check
    (K10)."""
    lo, hi = 1000, 5000
    k = rng.integers(lo, hi + 1, n).astype(np.int64)
    mask = rng.random(n) < 0.9
    sent = None
    if case == "above":
        k[n - 1], mask[n - 1] = hi + 1, True  # the last row: a block edge of its own
    elif case == "below":
        k[9], mask[9] = lo - 3, True
    elif case == "null_keys_only_outside":
        sent = int(I64_MIN)
        k[::5] = sent
    elif case == "dead_rows_outside":
        k[~mask] = hi + 1000
    elif case == "int32_keys":
        k = k.astype(np.int32)
        k[n // 3], mask[n // 3] = hi + 7, True
    elif case == "all_dead":
        mask[:] = False
        k[:] = hi + 1
    return k, mask, lo, hi, sent


KEEP_CASES = ["q18_few_intervals", "one_thousand_intervals", "three_thousand_intervals",
              "int32_keys", "null_sentinel_interval"]


def keep_case(case, n, rng):
    """(keys, mask, pred, los, his) for the early-HAVING keep mask (K11):
    sorted disjoint overlap intervals, padded to a power of two with empty
    (1, 0) pairs as the operator pads them."""
    counts = {"q18_few_intervals": 11, "one_thousand_intervals": 1000,
              "three_thousand_intervals": 3000, "int32_keys": 40,
              "null_sentinel_interval": 16}
    m = counts[case]
    span = 6 * n
    starts = np.sort(rng.choice(span, m, replace=False)).astype(np.int64) * 4
    los, his = starts, starts + rng.integers(0, 3, m)
    k = rng.integers(0, 4 * span, n).astype(np.int64)
    k[: n // 10] = los[rng.integers(0, m, n // 10)]  # some keys in the windows
    if case == "null_sentinel_interval":
        los = np.append(los, I64_MIN)
        his = np.append(his, I64_MIN)
        k[::7] = I64_MIN
    if case == "int32_keys":
        k = k.astype(np.int32)
    pad = 1
    while pad < len(los):
        pad *= 2
    los = np.concatenate([los, np.ones(pad - len(los), np.int64)])
    his = np.concatenate([his, np.zeros(pad - len(his), np.int64)])
    mask = rng.random(n) < 0.8
    pred = rng.random(n) < 0.01
    return k, mask, pred, los, his


# K11's interval sets (the early HAVING's overlap windows): overlapping,
# touching, nested, none (the empty (1, 0) pads only), the NULL-sentinel
# pair, pairs at int64 max, and random sets of 1, 17, 1,000 and 5,000 pairs
# (overlaps and touches among them; 5,000 merged pairs exceed the 2,048 the
# kernel keeps in shared memory)
INTERVAL_CASES = ["overlapping", "touching", "nested", "pads_only", "null_sentinel_pair",
                  "at_int64_max", "random_1", "random_17", "random_1000", "random_5000"]


def interval_case(case, rng):
    """The overlap windows as (lo, hi) pairs of Python ints, unpadded."""
    fixed = {
        "overlapping": [(0, 10), (5, 20), (18, 30), (100, 110), (105, 105), (3, 2)],
        "touching": [(0, 9), (10, 19), (20, 20), (22, 30), (-5, -1)],
        "nested": [(0, 100), (10, 20), (50, 50), (99, 100), (200, 300), (250, 260)],
        "pads_only": [],
        "null_sentinel_pair": [(I64_MIN, I64_MIN), (5, 9), (7, 12), (I64_MIN + 1, I64_MIN + 1)],
        "at_int64_max": [(I64_MAX - 5, I64_MAX), (I64_MAX - 10, I64_MAX - 6),
                         (I64_MAX, I64_MAX), (0, 3)],
    }
    if case in fixed:
        return [(int(a), int(b)) for a, b in fixed[case]]
    m = int(case.split("_")[1])
    if case == "random_5000":  # 5,000 pairs that stay apart: 5,000 merged
        starts = np.sort(rng.choice(20 * m, m, replace=False)) * 8
        return [(int(a), int(a + w)) for a, w in zip(starts, rng.integers(0, 6, m))]
    starts = rng.integers(-4 * m, 4 * m, m)
    return [(int(a), int(a + w)) for a, w in zip(starts, rng.integers(0, 4, m))]


def pad_intervals(pairs, minimum=4):
    """The pairs as the operator holds them: padded to a power of two (at
    least ``minimum``) with empty (1, 0) pairs; (los, his) int64 arrays."""
    pad = minimum
    while pad < len(pairs):
        pad *= 2
    los, his = np.ones(pad, dtype=np.int64), np.zeros(pad, dtype=np.int64)
    for i, (lo, hi) in enumerate(pairs):
        los[i], his[i] = lo, hi
    return los, his


def interval_keys(pairs, n, rng):
    """At least ``n`` int64 keys in random order: every bound and its
    neighbours (within int64), int64's extremes, and random keys around
    the pairs."""
    edge = {int(I64_MIN), int(I64_MAX), 0}
    for lo, hi in pairs:
        edge.update(v for v in (lo - 1, lo, lo + 1, hi - 1, hi, hi + 1)
                    if I64_MIN <= v <= I64_MAX)
    edge = np.array(sorted(edge), dtype=np.int64)
    span = 8 * max(1, len(pairs)) + 16
    finite = [v for p in pairs for v in p if abs(v) < 2**62]
    lo = min(finite, default=0) - span
    hi = max(finite, default=0) + span
    rest = rng.integers(lo, hi, max(n - len(edge), 1024), dtype=np.int64)
    return rng.permutation(np.concatenate([edge, rest]))


# --------------------------------------------------------------------------
# the standalone engine (stages, shuffle files, whole-stage fusion)
# --------------------------------------------------------------------------

# four shuffle partitions: with 'auto' and one batch of input the planner
# collapses a small query into one stage, and nothing fuses
STANDALONE_SETTINGS = {"ballista.shuffle.partitions": "4"}
STANDALONE_SQL = {"q1": QUERIES[1], "q3": QUERIES[3], "q4": QUERIES[4],
                  # q18 as written keeps no order at SF0.01
                  "q18": QUERIES[18].replace("> 300", "> 200")}
STANDALONE_CASES = [("pq", "q1"), ("pq", "q3"), ("pq", "q4"), ("pq", "q18"),
                    ("mem", "q1"), ("mem", "q18")]


def fused_labels(graph):
    """{stage id: sorted FusedStageExec labels of its resolved plan}, for a
    graph of either package."""
    return {sid: sorted(n._label() for n in plan_nodes(st.resolved_plan or st.plan)
                        if type(n).__name__ == "FusedStageExec")
            for sid, st in graph.stages.items()}


def stage_summary(graph):
    """{stage id: (planned partitions, partitions run, state, producers)}."""
    return {sid: (st.planned_partitions, st.partitions, st.state, list(st.producer_ids))
            for sid, st in graph.stages.items()}


# --------------------------------------------------------------------------
# whole-stage fusion: the chains K12 and K13 run
# --------------------------------------------------------------------------


def hand_table(n=5000, seed=3):
    """NULL strings and integers, NaN, int64 values whose products wrap."""
    import pyarrow as pa

    rng = np.random.default_rng(seed)
    words = np.array(["apple", "apricot", "beta", "gamma", "avocado", "delta"], dtype=object)
    f = rng.normal(size=n)
    f[rng.random(n) < 0.05] = np.nan
    return pa.table({
        "k": pa.array(rng.integers(-200, 200, n).astype(np.int64), mask=rng.random(n) < 0.05),
        "s": pa.array(words[rng.integers(0, len(words), n)], mask=rng.random(n) < 0.05),
        "big": pa.array(rng.integers(2**61, 2**62, n).astype(np.int64)),
        "f": pa.array(f),
        "d": pa.array(rng.integers(8000, 10500, n).astype(np.int32), type=pa.date32()),
    })


def hand_chain(E, O, scan):
    """Filter (a LIKE on a nullable string, a comparison on a nullable int,
    NaN in a float) then a projection of wrapping products, Python-style
    remainders, IN / SUBSTRING / CASE / IS NULL over nullable columns."""
    pred = E.BinOp("or", E.Like(E.Column("s"), "a%"),
                   E.BinOp("and", E.BinOp(">", E.Column("k"), E.Lit(5)),
                           E.Not(E.BinOp("<", E.Column("f"), E.Lit(0.25)))))
    filt = O.FilterExec(scan, pred)
    proj = O.ProjectionExec(filt, [
        (E.Column("s"), "s"),
        (E.BinOp("*", E.Column("big"), E.Lit(3)), "wrap"),
        (E.BinOp("%", E.Column("k"), E.Lit(7)), "mod7"),
        (E.BinOp("%", E.Column("k"), E.Lit(-7)), "mod_neg7"),
        (E.BinOp("-", E.Column("k"), E.Column("big")), "diff"),
        (E.BinOp("<>", E.Column("f"), E.Lit(0.5)), "f_ne"),
        (E.InList(E.Column("s"), ["beta", "gamma"]), "s_in"),
        (E.Substring(E.Column("s"), 2, 3), "s_sub"),
        (E.IsNull(E.Column("k")), "k_null"),
        (E.Case([(E.BinOp(">", E.Column("k"), E.Lit(100)), E.Column("big"))], E.Column("k")),
         "pick"),
        (E.BinOp("+", E.Column("d"), E.Lit(30, kind="interval_day")), "later"),
        (E.Lit(7), "seven"),
    ])
    return [proj, filt]


def plan_nodes(plan):
    yield plan
    for c in plan.children():
        yield from plan_nodes(c)


def find_chain(plan, kind):
    """The first chain of ``kind`` in pre-order: 'agg' — a partial
    aggregate over a RenameExec — or 'proj_filter'."""
    for n in plan_nodes(plan):
        name = type(n).__name__
        child = type(getattr(n, "input", None)).__name__
        if kind == "agg" and name == "HashAggregateExec" and n.mode == "partial" \
                and child == "RenameExec":
            return [n, n.input]
        if kind == "proj_filter" and name == "ProjectionExec" and child == "FilterExec" \
                and not n.host_mode and not n.input.host_mode:
            return [n, n.input]
    raise LookupError(kind)


# chain name -> (SQL whose plan holds the chain, find_chain kind); the hand
# chain is built by hand_chain over hand_table
FUSED_CHAINS = {
    "q1_dense_agg": (QUERIES[1], "agg"),
    "q18_sort_agg": (QUERIES[18].replace("> 300", "> 200"), "agg"),
    "q18_having_rows": (QUERIES[18].replace("> 300", "> 200"), "proj_filter"),
    "q21_rows": (QUERIES[21], "proj_filter"),
    "hand_rows": (None, None),
}




# --------------------------------------------------------------------------
# K14: EXTRACT
# --------------------------------------------------------------------------


def edge_days():
    """Epoch days: 1900-2100 every 7th day, the days around the leap days
    of 1900 (none), 2000 and 2100 (none), negative and extreme days, and
    the NULL sentinel (the int32 minimum)."""
    import datetime

    def days(*isos):
        return [(datetime.date.fromisoformat(s) - datetime.date(1970, 1, 1)).days
                for s in isos]

    span = np.arange(days("1900-01-01")[0], days("2100-12-31")[0] + 1, 7)
    edges = days("1900-02-28", "1900-03-01", "2000-02-28", "2000-02-29", "2000-03-01",
                 "2100-02-28", "2100-03-01", "1969-12-31", "1970-01-01", "1600-03-01",
                 "0001-01-01", "9999-12-31")
    extremes = [-(2 ** 31), -(2 ** 31) + 1, 2 ** 31 - 1, -719468, -719469, -1, 0, 1]
    return np.concatenate([span, edges, extremes]).astype(np.int32)


def era_days():
    """``edge_days()``, the era boundaries every 100th era over int32 (the
    day before, at and after k * 146097 - 719468), the first and last
    65,536 int32 days and 200,000 days from a seeded generator."""
    lo, hi = -(2 ** 31), 2 ** 31 - 1
    eras = np.arange(-14_700, 14_701, 100, dtype=np.int64) * 146_097 - 719_468
    bounds = (eras[:, None] + np.array([-1, 0, 1])).reshape(-1)
    rng = np.random.default_rng(15)
    days = np.concatenate([edge_days(), bounds[(bounds >= lo) & (bounds <= hi)],
                           np.arange(lo, lo + 65_536), np.arange(hi - 65_535, hi + 1),
                           rng.integers(lo, hi, 200_000, endpoint=True)])
    return days.astype(np.int32)


# --------------------------------------------------------------------------
# TPC-H against a sqlite3 oracle (the comparators of tests/test_tpch.py,
# with the port's parser: no JAX, so chip_smoke.py uses them on the card)
# --------------------------------------------------------------------------

_EPOCH = __import__("datetime").date(1970, 1, 1)
_DATE_ARITH = __import__("re").compile(
    r"date\s+'(\d{4})-(\d{2})-(\d{2})'"
    r"(?:\s*([+-])\s*interval\s+'(\d+)'\s+(day|month|year))?",
    __import__("re").IGNORECASE)


def _add_interval(d, sign: str, n: int, unit: str):
    import datetime

    n = n if sign == "+" else -n
    if unit == "day":
        return d + datetime.timedelta(days=n)
    if unit == "month":
        m = d.month - 1 + n
        return d.replace(year=d.year + m // 12, month=m % 12 + 1)
    return d.replace(year=d.year + n)


def to_sqlite(sql: str) -> str:
    """The query in sqlite's dialect: date literals as epoch days, EXTRACT
    through strftime, SUBSTRING as substr."""
    import datetime
    import re

    def date_repl(m):
        d = datetime.date(int(m.group(1)), int(m.group(2)), int(m.group(3)))
        if m.group(4):
            d = _add_interval(d, m.group(4), int(m.group(5)), m.group(6).lower())
        return str((d - _EPOCH).days)

    sql = _DATE_ARITH.sub(date_repl, sql)
    sql = re.sub(r"extract\s*\(\s*year\s+from\s+([A-Za-z0-9_.]+)\s*\)",
                 r"CAST(strftime('%Y', (\1)*86400.0, 'unixepoch') AS INTEGER)",
                 sql, flags=re.IGNORECASE)
    sql = re.sub(r"substring\s*\(\s*([A-Za-z0-9_.]+)\s+from\s+(\d+)\s+for\s+(\d+)\s*\)",
                 r"substr(\1, \2, \3)", sql, flags=re.IGNORECASE)
    return sql


def _arrow_to_oracle_df(table):
    import pandas as pd
    import pyarrow as pa

    cols = {}
    for name, col in zip(table.column_names, table.columns):
        t = col.type
        meta = table.schema.field(name).metadata or {}
        if pa.types.is_decimal(t):
            cols[name] = np.asarray(col.cast(pa.float64()))
        elif pa.types.is_integer(t) and meta.get(b"kind") == b"decimal":
            scale = int(meta.get(b"scale", b"0"))
            cols[name] = np.asarray(col.cast(pa.int64())).astype(np.float64) / (10 ** scale)
        elif pa.types.is_date32(t):
            cols[name] = np.asarray(col.cast(pa.int32()))
        else:
            cols[name] = col.to_pandas()
    return pd.DataFrame(cols)


# join-key indexes (benchmarks/sf1_correctness.py's): without them sqlite
# nested-loops q21's correlated subqueries for minutes even at SF0.01
_ORACLE_INDEXES = [("lineitem", "l_orderkey"), ("lineitem", "l_partkey"),
                   ("lineitem", "l_suppkey"), ("orders", "o_orderkey"), ("orders", "o_custkey"),
                   ("customer", "c_custkey"), ("customer", "c_nationkey"),
                   ("supplier", "s_suppkey"), ("supplier", "s_nationkey"),
                   ("part", "p_partkey"), ("partsupp", "ps_partkey"),
                   ("partsupp", "ps_suppkey"), ("nation", "n_nationkey"),
                   ("nation", "n_regionkey"), ("region", "r_regionkey")]


def sqlite_oracle(tables):
    """An in-memory sqlite3 database of the tables (case-sensitive LIKE),
    with join-key indexes."""
    import sqlite3

    conn = sqlite3.connect(":memory:", check_same_thread=False)
    conn.execute("PRAGMA case_sensitive_like = ON")
    for name, table in tables.items():
        _arrow_to_oracle_df(table).to_sql(name, conn, index=False)
    for i, (table, col) in enumerate(_ORACLE_INDEXES):
        if table in tables:
            conn.execute(f"CREATE INDEX ix{i} ON {table}({col})")
    conn.commit()
    return conn


def normalize(df):
    import datetime

    import pandas as pd

    out = {}
    for i, col in enumerate(df.columns):
        s = df[col]
        if pd.api.types.is_datetime64_any_dtype(s):
            s = (s - pd.Timestamp(_EPOCH)).dt.days
        elif s.dtype == object and len(s) and isinstance(
                s.dropna().iloc[0] if len(s.dropna()) else None, datetime.date):
            s = s.map(lambda d: (d - _EPOCH).days if d is not None else None)
        out[f"c{i}"] = s.reset_index(drop=True)
    return pd.DataFrame(out)


def compare_content(got, want):
    """Multiset equality (both frames fully sorted; ORDER BY ties may break
    either way, so ``check_ordering`` checks the order)."""
    import pandas as pd

    g, w = normalize(got), normalize(want)
    assert g.shape == w.shape, f"shape {g.shape} != {w.shape}\n{g}\n{w}"
    cols = list(g.columns)
    g = g.sort_values(cols, kind="mergesort").reset_index(drop=True)
    w = w.sort_values(cols, kind="mergesort").reset_index(drop=True)
    for col in cols:
        gc, wc = g[col], w[col]
        if pd.api.types.is_numeric_dtype(gc) and pd.api.types.is_numeric_dtype(wc):
            np.testing.assert_allclose(gc.to_numpy(dtype=np.float64), wc.to_numpy(dtype=np.float64),
                                       rtol=1e-6, atol=1e-6, err_msg=f"column {col}")
        else:
            assert gc.astype(str).tolist() == wc.astype(str).tolist(), \
                f"column {col}:\n{gc}\n{wc}"


def check_ordering(sql: str, got):
    """Rows monotone in every ORDER BY key that is an output column."""
    from arrow_ballista_tpu_torch.sql import ast as qast
    from arrow_ballista_tpu_torch.sql.parser import parse_sql

    stmt = parse_sql(sql)
    if not isinstance(stmt, qast.Select) or not stmt.order_by or len(got) < 2:
        return
    keys = []
    for item in stmt.order_by:
        e = item.expr
        if isinstance(e, qast.ColumnRef) and e.table is None and e.name in got.columns:
            keys.append((e.name, item.ascending))
        else:
            return  # expression keys: content check only
    g = normalize(got[[k for k, _ in keys]])
    g.columns = [k for k, _ in keys]

    def le(r1, r2):
        for k, asc in keys:
            v1, v2 = r1[k], r2[k]
            if v1 == v2:
                continue
            return (v1 < v2) if asc else (v1 > v2)
        return True

    recs = g.to_dict("records")
    for i in range(len(recs) - 1):
        assert le(recs[i], recs[i + 1]), \
            f"ORDER BY violated at row {i}: {recs[i]} !<= {recs[i + 1]} for {keys}"


def sqlite_answer(conn, sql: str):
    """The oracle's frame of ``sql``."""
    import pandas as pd

    return pd.read_sql_query(to_sqlite(sql), conn)


def check_against_sqlite(want, sql: str, got):
    """``got`` (the engine's frame of ``sql``) against the oracle's ``want``."""
    compare_content(got.copy(), want.copy())
    check_ordering(sql, got)


# --------------------------------------------------------------------------
# K20 concat, K21 gather / pack, K22 mask ops
# --------------------------------------------------------------------------

_MOVE_DTYPES = [np.int32, np.int64, np.float32, np.float64, np.bool_]


def move_column(dt, n, rng):
    """A column of ``dt`` with its edge values: int extremes, NaN, -0.0."""
    if dt == np.bool_:
        return rng.random(n) < 0.5
    if np.dtype(dt).kind == "f":
        a = rng.standard_normal(n).astype(dt) * 1e6
        a[::97] = np.nan
        a[1::89] = -0.0
        return a
    info = np.iinfo(dt)
    a = rng.integers(info.min, info.max, n, dtype=dt)
    a[:2] = [info.min, info.max][:min(2, n)]
    return a


# (columns, sources, capacities or None for random powers of two, pad)
CONCAT_CASES = {
    "mixed_capacities": (5, [1024, 4096, 64, 2048], 0),
    "pad": (5, [1024, 1024, 2048], 1000),
    "one_source_padded": (3, [4096], 4096),
    "forty_columns": (40, [2048, 1024, 1024], 0),
    "seventy_sources": (3, [64] * 35 + [128] * 35, 64),
    "wider_than_a_launch": (60, [1024, 2048], 16),
}


def concat_case(case, rng):
    """(per-source {name: array}, per-source masks, pad): every dtype in
    turn across the columns."""
    ncols, caps, pad = CONCAT_CASES[case]
    dts = [_MOVE_DTYPES[c % len(_MOVE_DTYPES)] for c in range(ncols)]
    cols_list, masks = [], []
    for cap in caps:
        cols_list.append({f"c{c}": move_column(dt, cap, rng) for c, dt in enumerate(dts)})
        masks.append(rng.random(cap) < 0.6)
    return cols_list, masks, pad


# (columns, rows, index kind)
GATHER_CASES = {
    "compaction_order": (5, 100_003, "compact"),
    "reverse": (5, 65_536, "reverse"),
    "random_with_repeats": (10, 50_000, "random"),
    "seventy_columns": (70, 8192, "random"),
    "prefix": (5, 100_003, "prefix"),
}


def gather_case(case, rng):
    """({name: array}, mask, int32 index)."""
    ncols, n, kind = GATHER_CASES[case]
    cols = {f"c{c}": move_column(_MOVE_DTYPES[c % len(_MOVE_DTYPES)], n, rng)
            for c in range(ncols)}
    mask = rng.random(n) < 0.4
    if kind == "compact":
        idx = np.concatenate([np.flatnonzero(mask), np.flatnonzero(~mask)])
    elif kind == "reverse":
        idx = np.arange(n)[::-1]
    elif kind == "random":
        idx = rng.integers(0, n, n)
    else:  # the live prefix of a compaction, as shrink and pack take it
        idx = np.flatnonzero(mask)[: n // 3]
    return cols, mask, np.ascontiguousarray(idx.astype(np.int32))


# (int64 names, float64 names, 32-bit names, target): pack_for_host layouts
PACK_CASES = {
    "all_kinds_even": (["a", "b"], ["f"], ["i", "g", "x", "k"], 65_536),
    "odd_32_bit_words": (["a"], [], ["i", "g", "x"], 40_000),
    "no_32_bit": (["a", "b"], ["f", "h"], [], 2048),
    "only_bool": ([], [], ["k"], 1024),
    "target_below_count": (["a"], ["f"], ["i"], 1024),
    # an int32 column in an int64 slot (an int32 sum whose schema says
    # int64): the concatenation promotes it, K21 sign-extends it
    "int32_in_an_int64_slot": (["a", "i"], [], ["g"], 4096),
}


def pack_case(case, rng):
    """(cols, mask, target, namesi64, namesf64, names32) with int64 ``a``,
    ``b``, float64 ``f``, ``h``, int32 ``i``, float32 ``g``, bool ``k`` and
    an extra int32 ``x``."""
    i64, f64, n32, target = PACK_CASES[case]
    n = 100_000
    cols = {"a": move_column(np.int64, n, rng), "b": move_column(np.int64, n, rng),
            "f": move_column(np.float64, n, rng), "h": move_column(np.float64, n, rng),
            "i": move_column(np.int32, n, rng), "g": move_column(np.float32, n, rng),
            "k": move_column(np.bool_, n, rng), "x": move_column(np.int32, n, rng)}
    mask = rng.random(n) < 0.3
    return cols, mask, target, tuple(i64), tuple(f64), tuple(n32)


MASK_OPS_CASES = ["window_middle", "window_past_end", "window_empty", "or", "and", "andnot"]


def mask_ops_case(case, rng, n=100_003):
    """(op, a, b or None, lo, hi)."""
    a = rng.random(n) < 0.5
    b = rng.random(n) < 0.5
    if case == "window_middle":
        return "window", a, None, n // 5, n // 2
    if case == "window_past_end":
        return "window", a, None, n - 100, n + 5000
    if case == "window_empty":
        return "window", a, None, 70, 70
    return case, a, b, 0, 0


# K22's bucket form: "<partitions>x<rows>", ragged and whole 16-row words;
# "_out_of_range": buckets past both ends, which select no row
BUCKET_CASES = ["1x1", "2x15", "16x16", "16x17", "64x1000", "2x4099", "16x100003",
                "16_out_of_range", "64_out_of_range", "7_seven_of_one_bucket"]


def bucket_case(case, rng):
    """(key columns for bucket_of, mask, num_out, buckets or None): None
    takes the buckets from bucket_of over the keys; otherwise the int32
    buckets given, some outside [0, num_out)."""
    if "x" in case:
        num_out, n = (int(v) for v in case.split("x"))
    else:
        num_out, n = int(case.split("_")[0]), 5003
    keys = [rng.integers(-10**6, 10**6, n).astype(np.int64),
            rng.integers(0, 50, n).astype(np.int32)]
    mask = rng.random(n) < 0.7
    if case.endswith("out_of_range"):
        b = rng.integers(-3, num_out + 3, n).astype(np.int32)
        b[rng.random(n) < 0.05] = np.iinfo(np.int32).min
        b[rng.random(n) < 0.05] = np.iinfo(np.int32).max
        return keys, mask, num_out, b
    if case.startswith("7_seven"):  # every row in one bucket, the others empty
        return keys, mask, num_out, np.full(n, 6, np.int32)
    return keys, mask, num_out, None


# --------------------------------------------------------------------------
# K8's tile decomposition (csrc/seg_agg.cu): edge shapes at its tile size
# --------------------------------------------------------------------------

SEG_TILE = 2048  # csrc/seg_agg.cu SG_TILE
SEG_CASES = ["tile_minus_1", "tile", "tile_plus_1", "group_across_two_tiles",
             "group_across_every_tile", "every_row_its_own_group", "dead_rows_inside_groups",
             "dead_rows_before_the_first_group", "cap_below_the_groups", "every_value_type",
             "float_keys_nan", "keyless", "keyless_all_dead", "keys_only", "all_dead"]


def seg_case(case, rng):
    """(keys, vals, mask, cap) in group order for K8 (no sort: the rows are
    given in the order the kernel groups them)."""
    t = SEG_TILE
    n = {"tile_minus_1": t - 1, "tile": t, "tile_plus_1": t + 1,
         "group_across_two_tiles": 3 * t, "group_across_every_tile": 5 * t + 17,
         "every_row_its_own_group": 2 * t + 5}.get(case, 3 * t + 101)
    mask = rng.random(n) < 0.85

    def grouped(width):  # sorted keys, groups of about `width` rows
        return np.sort(rng.integers(0, max(1, n // width), n)).astype(np.int64)

    quarter = (rng.integers(-256, 256, n) / 4).astype(np.float32)  # sums exact in any order
    i64 = rng.integers(-2**63, 2**63 - 1, n, dtype=np.int64)
    wrap = rng.integers(2**61, 2**62, n).astype(np.int64)
    vals = [(wrap, "sum"), (np.zeros(n, np.int64), "count"), (i64, "min"), (i64, "max")]
    cap = n
    keys = [grouped(7)]
    if case == "group_across_two_tiles":
        k = grouped(5)
        k[t - 600:t + 700] = k[t - 601]  # one group from 600 rows before the edge to 700 past
        keys = [np.maximum.accumulate(k)]
    elif case == "group_across_every_tile":
        keys = [np.full(n, 41, np.int64)]
        vals = [(wrap, "sum"), (np.zeros(n, np.int64), "count"), (rng.normal(size=n), "sum"),
                (quarter, "min")]
    elif case == "every_row_its_own_group":
        keys = [np.arange(n, dtype=np.int64)]
        mask[:] = True
    elif case == "dead_rows_inside_groups":
        # dead rows with their group's key continue it; dead rows with another
        # key between two live rows of one key split it (the reference's rule)
        k = grouped(40)
        mask = rng.random(n) < 0.5
        odd = rng.random(n) < 0.03
        k[odd & ~mask] += 1000
        keys = [k]
    elif case == "dead_rows_before_the_first_group":
        k = grouped(9)
        k[:300] = k[300]
        mask[:150] = False  # row 0 dead: live rows up to the next key opened nowhere
        keys = [k]
    elif case == "cap_below_the_groups":
        cap = max(1, len(np.unique(keys[0])) // 3)
    elif case == "every_value_type":
        k32 = np.sort(rng.integers(-5, 60, n)).astype(np.int32)
        keys = [k32, (rng.random(n) < 0.5) & (k32 % 2 == 0), (k32 // 7).astype(np.float32)]
        i32 = rng.integers(-2**31, 2**31 - 1, n, dtype=np.int64).astype(np.int32)
        f64 = rng.normal(size=n)
        f64[rng.random(n) < 0.01] = np.nan
        f32 = rng.normal(size=n).astype(np.float32)
        f32[rng.random(n) < 0.01] = np.nan
        vals = [(i32, "sum"), (i32, "min"), (i32, "max"), (wrap, "sum"), (i64, "min"),
                (i64, "max"), (quarter, "sum"), (f32, "min"), (f32, "max"),
                (rng.normal(size=n) * 1e3, "sum"), (f64, "min"), (f64, "max"),
                (np.zeros(n, np.int64), "count")]
    elif case == "float_keys_nan":  # -0.0 groups with 0.0; every NaN row opens a group
        f = np.sort(rng.integers(-3, 4, n)).astype(np.float64)
        f[rng.random(n) < 0.05] = np.nan
        f[(f == 0) & (rng.random(n) < 0.5)] = -0.0
        keys = [f]
    elif case == "keyless":
        keys = []
        vals.append((rng.normal(size=n), "max"))
    elif case == "keyless_all_dead":
        keys = []
        mask[:] = False
    elif case == "keys_only":
        vals = []
    elif case == "all_dead":
        mask[:] = False
    elif case not in ("tile_minus_1", "tile", "tile_plus_1"):
        raise KeyError(case)
    return keys, vals, mask, cap


# --------------------------------------------------------------------------
# the remote engine: a scheduler service and its executors, in process
# --------------------------------------------------------------------------

# short RPC deadlines: no test waits on a socket for more than seconds
RPC_SETTINGS = {"ballista.rpc.connect.timeout.seconds": "2",
                "ballista.rpc.read.timeout.seconds": "20",
                "ballista.rpc.retry.base.seconds": "0.05",
                "ballista.rpc.retry.cap.seconds": "0.5",
                "ballista.rpc.retry.deadline.seconds": "5"}
REMOTE_SETTINGS = {"ballista.shuffle.partitions": "4", **RPC_SETTINGS}


@contextlib.contextmanager
def remote_cluster(pkg: str, work_dir: str, executors: int = 2, settings=None,
                   executor_settings=None, slots: int = 4, device="cpu", **scheduler_kw):
    """A ``pkg`` ('torch' or 'jax') scheduler service on 127.0.0.1 port 0
    and ``executors`` executor servers with separate work directories,
    round-robin task distribution unless ``scheduler_kw`` says otherwise;
    yields (service, [executor servers]).  The port's run on ``device``.  The
    reference's executors serve through its Python RPC handler: building
    its native data plane rewrites a tracked file under native/ while
    other test processes may load it."""
    if pkg == "jax":
        from arrow_ballista_tpu import native as jnative
        from arrow_ballista_tpu.executor.server import ExecutorServer
        from arrow_ballista_tpu.scheduler.netservice import SchedulerNetService
        from arrow_ballista_tpu.scheduler.scheduler import SchedulerConfig
        from arrow_ballista_tpu.utils.config import BallistaConfig

        dev = {}
    else:
        from arrow_ballista_tpu_torch.executor.server import ExecutorServer
        from arrow_ballista_tpu_torch.scheduler.netservice import SchedulerNetService
        from arrow_ballista_tpu_torch.scheduler.scheduler import SchedulerConfig
        from arrow_ballista_tpu_torch.utils.config import BallistaConfig

        dev = {"device": device}
    scheduler_kw.setdefault("task_distribution", "round-robin")
    policy = scheduler_kw.get("policy", "push")
    with contextlib.ExitStack() as stack:
        if pkg == "jax":
            mp = stack.enter_context(__import__("pytest").MonkeyPatch.context())
            mp.setattr(jnative, "dataplane", lambda: None)
        sched = SchedulerNetService("127.0.0.1", 0,
                                    config=BallistaConfig({**REMOTE_SETTINGS, **(settings or {})}),
                                    scheduler_config=SchedulerConfig(**scheduler_kw), **dev)
        sched.start()
        stack.callback(sched.stop)
        servers = []
        for i in range(executors):
            ex = ExecutorServer("127.0.0.1", sched.port, "127.0.0.1", 0,
                                work_dir=os.path.join(work_dir, f"{pkg}-exec{i}"),
                                concurrent_tasks=slots, executor_id=f"{pkg}-exec-{i}",
                                config=BallistaConfig({**RPC_SETTINGS,
                                                       **(executor_settings or {})}),
                                policy=policy, **dev)
            ex.start()
            stack.callback(ex.stop, notify=False)
            servers.append(ex)
        yield sched, servers


def remote_context(pkg: str, sched, settings=None, device="cpu"):
    """A remote session on ``sched`` (the port's on ``device``)."""
    conf = {**REMOTE_SETTINGS, **(settings or {})}
    if pkg == "jax":
        import arrow_ballista_tpu as jab

        return jab.BallistaContext.remote("127.0.0.1", sched.port, jab.BallistaConfig(conf))
    import arrow_ballista_tpu_torch as tab

    return tab.BallistaContext.remote("127.0.0.1", sched.port, tab.BallistaConfig(conf),
                                      device=device)
