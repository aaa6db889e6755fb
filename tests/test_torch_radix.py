"""K4's radix form on the CPU: the composite key layout that the card's
sort_order uses (``kernels.sort_layout``, through ``sort_layout_of``),
packed here with numpy and sorted by a plain stable LSD radix sort over
its 8-bit digits (csrc/radix.cuh RX_BITS), against the
port's twin (``sort_order_plain``, bit for bit) and the JAX package's
``sort_order`` (the same key sequence; its ties are XLA's).  The CUDA
kernels themselves are held against the twins on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from arrow_ballista_tpu.ops import kernels as JK
from arrow_ballista_tpu_torch.ops import kernels as TK
from tests.torch_cases import (I64_MAX, I64_MIN, RADIX_CASES, SORT_CASES, radix_case,
                               sort_case)

torch.set_num_threads(1)

_U64 = (1 << 64) - 1


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _words(keys, mask):
    """The sort words the kernel packs: the dead flag, then each key's."""
    return [(~mask).astype(np.int64)] + [TK.sort_words(_t(a), asc).numpy() for a, asc in keys]


def pack(keys, mask):
    """The composite key's limbs (uint64[limbs][n], limb 0 least
    significant) and its bit count, laid out by ``kernels.sort_layout``."""
    words = _words(keys, mask)
    lay = TK.sort_layout_of([(_t(a), asc) for a, asc in keys], _t(mask))
    total = lay["bits"]
    out = np.zeros((-(-total // 64), mask.shape[0]), np.uint64)
    for w, lo, width, off in zip(words, lay["lo"], lay["widths"], lay["offsets"]):
        if width == 0:
            continue
        f = w.view(np.uint64) - np.uint64(lo & _U64)  # wraps as uint64
        m, sh = divmod(off, 64)
        out[m] |= f << np.uint64(sh)
        if sh + width > 64:  # the field straddles into the next limb
            out[m + 1] |= f >> np.uint64(64 - sh)
    return out, total


def lsd_sort(limbs, total, digit_bits=8):
    """A plain stable LSD radix sort of the composite: one stable sort of
    each digit, lowest first (digits may straddle two limbs)."""
    order = np.arange(limbs.shape[1])
    mask = np.uint64((1 << digit_bits) - 1)
    for p in range(-(-total // digit_bits)):
        m, sh = divmod(p * digit_bits, 64)
        d = limbs[m][order] >> np.uint64(sh)
        if sh + digit_bits > 64 and m + 1 < limbs.shape[0]:
            d |= limbs[m + 1][order] << np.uint64(64 - sh)
        order = order[np.argsort(d & mask, kind="stable")]
    return order


def _check(keys, mask):
    n = mask.shape[0]
    limbs, total = pack(keys, mask)
    got = lsd_sort(limbs, total)
    plain = TK.sort_order_plain([(_t(a), asc) for a, asc in keys], _t(mask)).numpy()
    np.testing.assert_array_equal(got, plain.astype(np.int64))
    jperm = np.asarray(JK.sort_order([(jnp.asarray(a), asc) for a, asc in keys],
                                     jnp.asarray(mask)))
    np.testing.assert_array_equal(mask[got], mask[jperm])
    for a, _ in keys:  # the reference's key sequence, NaN and -0.0 bits included
        bits = a.view(np.int64 if a.itemsize == 8 else np.int32) if a.dtype.kind == "f" else a
        np.testing.assert_array_equal(bits[got], bits[jperm])
    assert got.shape == (n,)
    return total


@pytest.mark.parametrize("case", SORT_CASES)
def test_packed_radix_sort_of_sort_cases_equals_twin_and_reference(case):
    keys, mask = sort_case(case, 1000, np.random.default_rng(len(case)))
    _check(keys, mask)


@pytest.mark.parametrize("case", RADIX_CASES)
def test_packed_radix_sort_of_wide_and_degenerate_cases_equals_twin_and_reference(case):
    keys, mask, _n = radix_case(case, 1000, np.random.default_rng(17 + len(case)))
    total = _check(keys, mask)
    expected_bits = {"constant_keys_random_mask": 1, "all_rows_equal": 0,
                     "full_range_int64": 65, "straddle_64": 74, "eight_keys": 251,
                     "int64_min_desc_small": 65, "nan_against_negative": 65}
    if case in expected_bits:
        assert total == expected_bits[case]


@pytest.mark.parametrize("mins,maxs,widths,offsets,total,limbs", [
    # q18's orderkey and a dead flag that varies: one limb, 3 passes of 8 bits
    ([0, 1], [1, 6_000_000], [1, 23], [23, 0], 24, 1),
    # every word constant: nothing to sort
    ([0, 5, -2], [0, 5, -2], [0, 0, 0], [0, 0, 0], 0, 0),
    # a constant word drops out between two that do not
    ([0, 9, 0], [1, 9, 255], [1, 0, 8], [8, 8, 0], 9, 1),
    # spans past 2^63 taken as uint64: full range, and INT64_MIN against 3
    ([0, I64_MIN], [1, I64_MAX], [1, 64], [64, 0], 65, 2),
    ([0, int(I64_MIN)], [0, 3], [0, 64], [64, 0], 64, 1),
    # a field straddling bit 64
    ([0, 0, -2**31], [1, 2**41 - 1, 2**31 - 1], [1, 41, 32], [73, 32, 0], 74, 2),
    # the widest composite: the dead flag and eight full-range words, 9 limbs
    ([0] + [I64_MIN] * 8, [1] + [I64_MAX] * 8, [1] + [64] * 8,
     [512 - 64 * j for j in range(9)], 513, 9),
    # one bool under desc beside a dead flag that never varies
    ([0, 0], [0, 1], [0, 1], [1, 0], 1, 1),
])
def test_sort_layout_packs_fields_msb_first(mins, maxs, widths, offsets, total, limbs):
    got = TK.sort_layout(mins, maxs)
    assert got[0] == widths and got[2] == total and got[3] == limbs
    assert [o for o, w in zip(got[1], got[0]) if w] == [o for o, w in zip(offsets, widths) if w]


@pytest.mark.parametrize("case", [f"sort:{c}" for c in SORT_CASES] + RADIX_CASES)
def test_packed_order_is_the_lexicographic_order_of_the_words(case):
    """Comparing two composites compares the words in order, dead flag
    first: the packing keeps each word's order and nests them MSB-first."""
    rng = np.random.default_rng(3)
    if case.startswith("sort:"):
        keys, mask = sort_case(case[5:], 300, rng)
        n = mask.shape[0]
    else:
        keys, mask, n = radix_case(case, 300, rng)
    words = _words(keys, mask)
    limbs, _total = pack(keys, mask)
    big = [sum(int(limbs[m][i]) << (64 * m) for m in range(limbs.shape[0])) for i in range(n)]
    for i, j in zip(rng.integers(0, n, 2000), rng.integers(0, n, 2000)):
        wi, wj = tuple(int(w[i]) for w in words), tuple(int(w[j]) for w in words)
        assert (big[i] < big[j]) == (wi < wj) and (big[i] == big[j]) == (wi == wj)
