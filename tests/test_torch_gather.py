"""The twins of K20 ``concat_columns``, K21 ``gather_columns`` (shrink,
``pack_for_host``) and K22 (the join's mask programs and the
repartition's bucket masks) against the JAX package's programs on the
CPU: ``batch.concat`` (``_concat_impl``), ``batch.shrink``
(``_shrink_device``), ``kernels.pack_for_host``, ``join.window_mask`` /
``join.mask_or`` / ``join.mask_and`` and ``repartition.bucket`` (with the
local repartition itself through both packages).  The cases
cover mixed capacities, a pad, more than 32 columns (and more than one
launch's worth), every dtype with its edge values (int extremes, NaN,
-0.0), and more sources than one launch takes.  Exact, floats by their
bits.  On the CPU the wrappers take their twins, so each wrapper is what
runs here; tests/test_torch_cuda.py holds the kernels against them."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arrow_ballista_tpu.models.batch import _concat_impl, _shrink_device
from arrow_ballista_tpu.ops import kernels as JK
from arrow_ballista_tpu.ops.operators import _mask_and, _mask_or, _window_mask
from arrow_ballista_tpu_torch.models import batch as TB
from arrow_ballista_tpu_torch.ops import kernels as TK
from tests.torch_cases import (BUCKET_CASES, CONCAT_CASES, GATHER_CASES, MASK_OPS_CASES,
                               PACK_CASES, bucket_case, concat_case, gather_case, mask_ops_case,
                               pack_case)

torch.set_num_threads(1)


def _bits(a):
    a = np.asarray(a)
    if a.dtype.kind == "f":
        return a.view(np.int64 if a.itemsize == 8 else np.int32)
    return a


def _equal(got: torch.Tensor, want):
    want = np.asarray(want)
    assert got.numpy().dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


@pytest.mark.parametrize("case", list(CONCAT_CASES))
def test_concat_twin_matches_the_reference(case):
    cols_list, masks, pad = concat_case(case, np.random.default_rng(1))
    want, wmask = _concat_impl([{k: jnp.asarray(v) for k, v in c.items()} for c in cols_list],
                               [jnp.asarray(m) for m in masks], pad)
    got, gmask = TK.concat_columns([{k: torch.from_numpy(v) for k, v in c.items()}
                                    for c in cols_list],
                                   [torch.from_numpy(m) for m in masks], pad)
    assert list(got) == list(want)
    for k in want:
        _equal(got[k], want[k])
    _equal(gmask, wmask)


@pytest.mark.parametrize("case", list(GATHER_CASES))
def test_shrink_twin_matches_the_reference(case):
    cols, mask, _idx = gather_case(case, np.random.default_rng(2))
    target = TB.round_capacity(int(mask.sum()))
    want, wmask = _shrink_device({k: jnp.asarray(v) for k, v in cols.items()},
                                 jnp.asarray(mask), target=target)
    tm = torch.from_numpy(mask)
    got = TK.gather_columns(TK.compaction_order(tm)[:target],
                            {**{k: torch.from_numpy(v) for k, v in cols.items()}, "__m": tm})
    for k in want:
        _equal(got[k], want[k])
    _equal(got["__m"], wmask)


@pytest.mark.parametrize("case", list(GATHER_CASES))
def test_gather_twin_matches_the_reference_take(case):
    cols, _mask, idx = gather_case(case, np.random.default_rng(3))
    got = TK.gather_columns(torch.from_numpy(idx), {k: torch.from_numpy(v)
                                                    for k, v in cols.items()})
    for k, v in cols.items():
        _equal(got[k], jnp.asarray(v)[jnp.asarray(idx)])


@pytest.mark.parametrize("case", list(PACK_CASES))
def test_pack_for_host_twin_matches_the_reference(case):
    cols, mask, target, i64, f64, n32 = pack_case(case, np.random.default_rng(4))
    jbuf, jf = JK.pack_for_host({k: jnp.asarray(v) for k, v in cols.items()},
                                jnp.asarray(mask), target=target, namesi64=i64, namesf64=f64,
                                names32=n32)
    tbuf, tf = TK.pack_for_host({k: torch.from_numpy(v) for k, v in cols.items()},
                                torch.from_numpy(mask), target, i64, f64, n32)
    _equal(tbuf, jbuf)
    if f64:
        _equal(tf, jf)
    else:
        assert tf is None and jf is None


@pytest.mark.parametrize("case", MASK_OPS_CASES)
def test_mask_ops_twins_match_the_reference(case):
    op, a, b, lo, hi = mask_ops_case(case, np.random.default_rng(5))
    ta = torch.from_numpy(a)
    tb = torch.from_numpy(b) if b is not None else None
    if op == "window":
        got, want = TK.window_mask(ta, lo, hi), _window_mask(jnp.asarray(a), lo, hi)
    elif op == "or":
        got, want = TK.mask_or(ta, tb), _mask_or(jnp.asarray(a), jnp.asarray(b))
    elif op == "and":
        got, want = TK.mask_and(ta, tb), _mask_and(jnp.asarray(a), jnp.asarray(b))
    else:
        # the anti join's verdict (reference operators.py ``pmask & ~hit``)
        got, want = TK.mask_andnot(ta, tb), jnp.asarray(a) & ~jnp.asarray(b)
    _equal(got, want)


@pytest.mark.parametrize("case", BUCKET_CASES)
def test_bucket_masks_twin_matches_the_reference(case):
    """K22's bucket form (all the partitions of a batch at once) against the
    reference's "repartition.bucket" (shuffle.py:493-497: ``[mask & (b ==
    q) for q in range(num_out)]``), with the buckets from both packages'
    bucket_of on the same keys, or given (out of range: no row)."""
    keys, mask, num_out, given = bucket_case(case, np.random.default_rng(7))
    if given is None:
        jb = JK.bucket_of([jnp.asarray(k) for k in keys], num_out)
        tb = TK.bucket_of([torch.from_numpy(k) for k in keys], num_out)
        _equal(tb, jb)
    else:
        jb, tb = jnp.asarray(given), torch.from_numpy(given)
    jm = jnp.asarray(mask)
    want = [jm & (jb == q) for q in range(num_out)]
    got = TK.bucket_masks(torch.from_numpy(mask), tb, num_out)
    assert got.shape == (num_out, len(mask)) and got.dtype == torch.bool
    for q in range(num_out):
        _equal(got[q], want[q])
    if given is not None:  # a row whose bucket is outside [0, num_out) is in no partition
        outside = (given < 0) | (given >= num_out)
        assert not got.numpy()[:, outside].any()
    assert int(got.sum()) == int(((np.asarray(jb) >= 0) & (np.asarray(jb) < num_out)
                                  & mask).sum())


@pytest.mark.parametrize("num_out", [2, 16])
def test_local_repartition_matches_the_reference(num_out):
    """RepartitionExec (the local engine's exchange) in both packages over
    the same table, hashed on a nullable int64 and a date: every output
    partition's batches carry the same masks over the same columns (NULL
    string codes included, which to_arrow refuses in both packages)."""
    from arrow_ballista_tpu import catalog as JC
    from arrow_ballista_tpu.models import expr as JE
    from arrow_ballista_tpu.ops import physical as JP
    from arrow_ballista_tpu.ops.shuffle import RepartitionExec as JR
    from arrow_ballista_tpu_torch import catalog as TC
    from arrow_ballista_tpu_torch.models import expr as TE
    from arrow_ballista_tpu_torch.ops import physical as TP
    from arrow_ballista_tpu_torch.ops.shuffle import RepartitionExec as TR
    from tests.torch_cases import hand_table

    table = hand_table(7000, seed=11)
    jrep = JR(JC.MemoryTable("t", table).scan(None, [], 3),
              JP.Partitioning.hash([JE.Column("k"), JE.Column("d")], num_out))
    trep = TR(TC.MemoryTable("t", table).scan(None, [], 3),
              TP.Partitioning.hash([TE.Column("k"), TE.Column("d")], num_out))
    jctx, tctx = JP.TaskContext(), TP.TaskContext(device=torch.device("cpu"))
    live = 0
    for q in range(num_out):
        jbs, tbs = jrep.execute(q, jctx), trep.execute(q, tctx)
        assert len(jbs) == len(tbs) == 3
        for jb, tb in zip(jbs, tbs):
            _equal(tb.mask, jb.mask)
            assert sorted(tb.columns) == sorted(jb.columns)
            for c in tb.columns:
                _equal(tb.columns[c], jb.columns[c])
            live += tb.num_rows
    assert live == table.num_rows  # every row in exactly one partition


def test_concat_batches_and_shrink_of_mixed_capacities_match_the_reference():
    """Through the batch API: concat of three batches of different
    capacities, a pad, then shrink, against the JAX package's."""
    from arrow_ballista_tpu.models import batch as JB
    from arrow_ballista_tpu.models.schema import Field as JField, Schema as JSchema
    from arrow_ballista_tpu.models.schema import DataType as JDataType
    from arrow_ballista_tpu_torch.models.schema import DataType, Field, Schema

    rng = np.random.default_rng(6)
    kinds = ["int32", "int64", "float32", "float64", "bool"]
    tsch = Schema([Field(f"c{i}", DataType(k)) for i, k in enumerate(kinds)])
    jsch = JSchema([JField(f"c{i}", JDataType(k)) for i, k in enumerate(kinds)])
    tb, jb = [], []
    for n in (100, 3000, 40):
        data = {f"c{i}": v for i, v in enumerate(
            [rng.integers(-9, 9, n).astype(np.int32), rng.integers(-9, 9, n),
             rng.standard_normal(n).astype(np.float32), rng.standard_normal(n),
             rng.random(n) < 0.5])}
        tb.append(TB.ColumnBatch.from_numpy(tsch, data, device="cpu"))
        jb.append(JB.ColumnBatch.from_numpy(jsch, data))
        mask = rng.random(tb[-1].capacity) < 0.5
        tb[-1] = TB.ColumnBatch(tsch, tb[-1].columns, torch.from_numpy(mask))
        jb[-1] = JB.ColumnBatch(jsch, jb[-1].columns, jnp.asarray(mask))
    cap = sum(b.capacity for b in tb) + 1024
    tc = TB.concat_batches(tsch, tb, capacity=cap)
    jc = JB.concat_batches(jsch, jb, capacity=cap)
    for f in tsch:
        _equal(tc.columns[f.name], jc.columns[f.name])
    _equal(tc.mask, jc.mask)
    ts, js = tc.shrink(), jc.shrink()
    assert ts.capacity == js.capacity
    for f in tsch:
        _equal(ts.columns[f.name], js.columns[f.name])
    _equal(ts.mask, js.mask)
