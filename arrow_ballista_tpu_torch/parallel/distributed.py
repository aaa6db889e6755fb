"""Distributed operators over the rank mesh: whole stage pairs as one
program.

Mirrors arrow_ballista_tpu/parallel/distributed.py.  Where the reference
runs partial-agg tasks, materializes shuffle files, then runs final-agg
tasks as a separate stage, the mesh path runs partial agg -> exchange ->
final agg over the ranks of one mesh, and nothing touches the host.  The
two-phase plan shape is kept (partial by every rank over its rows,
exchange by key hash, final by the bucket owner), so results equal the
file-shuffle path's.

Each program is a ``per_shard`` body, the reference's own, run on every
rank by ``_run_ranks`` (the counterpart of ``jax.shard_map``): the ranks
run in turn, each on its own device, up to their next collective, which a
body reaches by yielding a ``collectives.Collective`` (``recv = yield
Collective(...)``, or ``yield from shuffle_rows(...)``); the collective
then runs over every rank's arguments (parallel/collectives.py) and each
rank resumes with its share.  The kernels a body launches are the port's
K1-K8 and K17, its reductions K18.

Inputs are row-sharded: a dict of per-rank column lists and a per-rank
mask list (``mesh.shard_rows``).  Row outputs come back per rank, in rank
order; the overflow flags of the ranks are OR-ed into one 0-d bool on the
device, read with one host sync by the caller (the reference's
``bool(overflow)`` after its overflow ``psum``).
"""
from __future__ import annotations

import inspect
import math
from typing import Dict, List, Sequence, Tuple

import torch

from ..ops import kernels as K
from ..utils.errors import InternalError
from . import collectives as C
from .collectives import Collective
from .ici_shuffle import shuffle_rows
from .mesh import Mesh, mesh_axis_size

# aggregate merge rule: partial counts merge by summation, rest by themselves
_MERGE = {"sum": "sum", "count": "sum", "min": "min", "max": "max"}


def _shuffle_capacity(rows_per_shard: int, n: int, factor: float) -> int:
    return max(1, math.ceil(rows_per_shard / n * factor))


def _identity_filter(cols, mask):
    return cols, mask


def _run_ranks(per_shard, mesh: Mesh, rank_args: Sequence[tuple]) -> list:
    """``per_shard(*rank_args[r])`` on every rank r; returns the ranks'
    results in rank order.  A body without collectives is a plain
    function; one with collectives is a generator that yields them."""
    n = len(rank_args)
    outs: list = [None] * n
    running = {}
    for r, args in enumerate(rank_args):
        out = per_shard(*args)
        if inspect.isgenerator(out):
            running[r] = out
        else:
            outs[r] = out
    sends: list = [None] * n
    while running:
        reqs = {}
        for r, body in list(running.items()):
            try:
                reqs[r] = body.send(sends[r])
            except StopIteration as stop:
                outs[r] = stop.value
                del running[r]
        if not reqs:
            break
        if len(reqs) != n or len({reqs[r].fn for r in reqs}) != 1:
            raise InternalError("the mesh ranks disagree on their next collective")
        per_arg = [list(a) for a in zip(*(reqs[r].args for r in range(n)))]
        res = reqs[0].fn(*per_arg, mesh)
        sends = res if isinstance(res, list) else [res] * n
    return outs


def _any_rank(flags: Sequence[torch.Tensor]) -> torch.Tensor:
    """The ranks' overflow flags OR-ed into one 0-d bool (14c-v)."""
    dev = flags[0].device
    return torch.stack([f.reshape(()).to(dev) for f in flags]).any()


def _rank_args(cols: Dict[str, List[torch.Tensor]], mask: List[torch.Tensor]):
    return [({k: v[r] for k, v in cols.items()}, m) for r, m in enumerate(mask)]


def _state_rows(outs):
    """Per-rank (keys, vals, mask, flag) -> (keys, vals, mask) listed over
    the ranks, and the OR of the flags."""
    nk, nv = len(outs[0][0]), len(outs[0][1])
    return ([[o[0][i] for o in outs] for i in range(nk)],
            [[o[1][i] for o in outs] for i in range(nv)],
            [o[2] for o in outs], _any_rank([o[3] for o in outs]))


def _join_rows(outs):
    names = list(outs[0][0])
    return ({m: [o[0][m] for o in outs] for m in names}, [o[1] for o in outs],
            _any_rank([o[2] for o in outs]))


def _make_runner(per_shard, mesh: Mesh, gather):
    """``run(cols, mask)`` over row-sharded inputs: ``per_shard`` on every
    rank, then ``gather`` assembles the ranks' outputs (the reference's
    out_specs).  The reference's ``_compile_once`` exists only because
    ``jax.jit`` compiles lazily at the first call; nothing compiles at a
    call here (a generated source keeps its own build cache)."""

    def run(cols, mask):
        return gather(_run_ranks(per_shard, mesh, _rank_args(cols, mask)))

    return run


def _make_join_runner(per_shard, mesh: Mesh):
    """``run((pcols, pmask), (bcols, bmask))`` for the two join variants."""

    def run(probe, build):
        pcols, pmask = probe
        bcols, bmask = build
        args = [(pc, pm, bc, bm) for (pc, pm), (bc, bm)
                in zip(_rank_args(pcols, pmask), _rank_args(bcols, bmask))]
        return _join_rows(_run_ranks(per_shard, mesh, args))

    return run


def distributed_filter_aggregate(
    mesh: Mesh,
    filter_fn,
    key_names: Sequence[str],
    agg_specs: Sequence[Tuple[str, str]],
    partial_capacity: int,
    final_capacity: int,
    skew_factor: float = 2.0,
    key_ranges=None,
):
    """Fused filter -> partial agg -> exchange -> final agg.

    ``filter_fn(cols, mask) -> (cols, mask)`` runs per rank first.
    ``agg_specs``: (value_column, how), how in sum/count/min/max.
    ``key_ranges`` (static per-key (lo, hi) bounds or None) selects the
    dense grouping path on both sides of the exchange.

    Returns ``run(cols, mask) -> (out_keys, out_vals, out_mask, overflow)``:
    rank d owns the groups whose key-hash bucket is d, each output listed
    over the ranks with ``final_capacity`` rows a rank."""
    n = mesh_axis_size(mesh)
    cap = _shuffle_capacity(partial_capacity, n, skew_factor)

    def per_shard(cols: Dict[str, torch.Tensor], mask: torch.Tensor):
        cols, mask = filter_fn(cols, mask)
        keys = [cols[k] for k in key_names]
        vals = [(cols[v], how) for v, how in agg_specs]
        pk, pv, pmask, ovf1 = K.grouped_aggregate(keys, vals, mask, partial_capacity,
                                                  key_ranges=key_ranges)
        shuffled = {f"k{i}": a for i, a in enumerate(pk)}
        shuffled.update({f"v{i}": a for i, a in enumerate(pv)})
        dest = K.bucket_of(pk, n)
        recv, rmask, ovf2 = yield from shuffle_rows(shuffled, dest, pmask, n, cap)
        rk = [recv[f"k{i}"] for i in range(len(pk))]
        rv = [(recv[f"v{i}"], _MERGE[agg_specs[i][1]]) for i in range(len(pv))]
        fk, fv, fmask, ovf3 = K.grouped_aggregate(rk, rv, rmask, final_capacity,
                                                  key_ranges=key_ranges)
        flags = K.overflow_flag(ovf1) | ovf2[0] | K.overflow_flag(ovf3)
        return fk, fv, fmask, flags

    return _make_runner(per_shard, mesh, _state_rows)


def distributed_dense_aggregate(
    mesh: Mesh,
    filter_fn,
    key_names: Sequence[str],
    agg_specs: Sequence[Tuple[str, str]],
    key_ranges,
    domain: int,
):
    """Reduce-collective aggregate for dense key domains: every rank
    reduces its rows into slot-aligned dense states (K1: slot d IS key
    combination d), then the merge across ranks is one element-wise sum,
    min or max per aggregate over ``[domain]`` arrays, the exists counts'
    sum written as ``> 0`` and the bad flags' OR: one collective, one K18
    launch (the reference's ``len(agg_specs) + 2`` collectives and its
    compare).  No all_to_all, no shuffle capacity, no skew sensitivity.

    Returns ``run(cols, mask) -> (keys, vals, mask, overflow)``, each one
    ``[domain]`` tensor (the reference's replicated outputs): groups
    compacted to the front in ascending fused-key order.  The compaction
    after the merge runs once, not once per rank."""

    def per_shard(cols: Dict[str, torch.Tensor], mask: torch.Tensor):
        cols, mask = filter_fn(cols, mask)
        keys = [cols[k] for k in key_names]
        vals = [(cols[v], how) for v, how in agg_specs]
        dense_vals, exists_cnt, bad = K.dense_group_states(keys, vals, mask, key_ranges, domain)
        hows = [_MERGE[how] for _, how in agg_specs] + [K.MERGE_EXISTS, "or"]
        merged = yield Collective(C.reduce_columns, [*dense_vals, exists_cnt, bad.reshape(1)],
                                  hows)
        return [k.dtype for k in keys], merged

    def gather(outs):
        key_dtypes, (*merged, exists, bad) = outs[0]  # replicated
        fk, fv, fmask, ovf = K.compact_dense_states(key_dtypes, merged, exists, domain,
                                                    key_ranges, domain)
        return fk, fv, fmask, ovf | bad[0]

    return _make_runner(per_shard, mesh, gather)


def distributed_partial_aggregate(
    mesh: Mesh,
    derive_fn,
    key_names: Sequence[str],
    agg_specs: Sequence[Tuple[str, str]],
    capacity: int,
    key_ranges=None,
):
    """The mesh-local half of the hybrid exchange: derive -> per-rank
    grouped aggregate, no collective.  Each rank reduces its rows to group
    states; the merge across tasks happens in the ordinary file shuffle
    and final aggregate.

    Returns ``run(cols, mask) -> (keys, vals, mask, overflow)``, each output
    listed over the ranks with ``capacity`` state rows a rank."""

    def per_shard(cols: Dict[str, torch.Tensor], mask: torch.Tensor):
        cols, mask = derive_fn(cols, mask)
        keys = [cols[k] for k in key_names]
        vals = [(cols[v], how) for v, how in agg_specs]
        pk, pv, pmask, ovf = K.grouped_aggregate(keys, vals, mask, capacity,
                                                 key_ranges=key_ranges)
        return pk, pv, pmask, K.overflow_flag(ovf)

    return _make_runner(per_shard, mesh, _state_rows)


def _probe_emit(join_type, key_names, sflags, null_key_sentinel, probe_names,
                build_names, build_fill, out_capacity,
                p_cols, p_mask, b_cols, b_mask):
    """One rank's local hash join, shared by the partitioned and broadcast
    variants: sorted build (K5), probe (K3 + K6), key re-verification
    (hash collisions), then emit by join type (K7 verdicts).  Both sides
    are already on the rank (shuffled to the bucket owner, or the build
    side all_gathered)."""
    rpk = [p_cols[k] for k in key_names]
    rbk = [b_cols[k] for k in key_names]

    bh_sorted, border, _ = K.build_side_sort(rbk, b_mask)
    ph = K.hash64(rpk)
    pi, bp, pair_valid, total = K.probe_join(ph, p_mask, bh_sorted, out_capacity)
    pil = pi.long()
    bidx = border[bp.long()]
    bil = bidx.long()
    ok = pair_valid & b_mask[bil]
    for i, (a, b) in enumerate(zip(rpk, rbk)):
        ok = ok & (a[pil] == b[bil])
        if sflags[i]:
            ok = ok & (a[pil] != null_key_sentinel)
    ovf_j = total > out_capacity

    # a verdict and its probe mask are one K7 launch
    if join_type in ("semi", "anti"):
        out_mask = K.segment_any(ok, pi, p_mask.shape[0], within=p_mask,
                                 negate=join_type == "anti")
        out_cols = {m: p_cols[m] for m in probe_names}
    else:
        out_cols = {m: p_cols[m][pil] for m in probe_names}
        out_cols.update({m: b_cols[m][bil] for m in build_names})
        out_mask = ok
        if join_type == "left":
            miss = K.segment_any(ok, pi, p_mask.shape[0], within=p_mask, negate=True)
            out_cols = {
                m: torch.cat([
                    out_cols[m],
                    p_cols[m] if m in probe_names else torch.full(
                        (p_mask.shape[0],), build_fill[m], dtype=out_cols[m].dtype,
                        device=out_cols[m].device),
                ])
                for m in out_cols
            }
            out_mask = torch.cat([out_mask, miss])
    return out_cols, out_mask, ovf_j


def _all_gather_rows(cols: Sequence[Dict[str, torch.Tensor]], masks: Sequence[torch.Tensor],
                     mesh: Mesh):
    """Every rank gets every rank's rows, in rank order."""
    names = list(cols[0])
    gathered = {m: C.all_gather([c[m] for c in cols], mesh) for m in names}
    gmask = C.all_gather(list(masks), mesh)
    return [({m: gathered[m][r] for m in names}, gmask[r]) for r in range(len(mesh.devices))]


def distributed_broadcast_join(
    mesh: Mesh,
    n_keys: int,
    probe_names: Sequence[str],
    build_names: Sequence[str],
    join_type: str,
    out_capacity: int,
    build_fill: Dict[str, object],
    string_key_flags: Sequence[bool] = (),
    null_key_sentinel: int = 0,
):
    """Broadcast hash join: all_gather the (small) build side onto every
    rank; probe rows never move.  No all_to_all and no shuffle-capacity
    skew risk; the build side costs ``n x build_rows`` memory (ranks on
    one device share it), so the planner gates it on build-side size.

    Returns ``run((pcols, pmask), (bcols, bmask))`` like
    ``distributed_hash_join``; outputs stay probe-sharded."""
    key_names = [f"__jk{i}" for i in range(n_keys)]
    sflags = list(string_key_flags) or [False] * n_keys

    def per_shard(pcols, pmask, bcols, bmask):
        b_all, bm_all = yield Collective(_all_gather_rows, bcols, bmask)
        return _probe_emit(join_type, key_names, sflags, null_key_sentinel, probe_names,
                           build_names, build_fill, out_capacity, pcols, pmask, b_all, bm_all)

    return _make_join_runner(per_shard, mesh)


def distributed_hash_join(
    mesh: Mesh,
    n_keys: int,
    probe_names: Sequence[str],
    build_names: Sequence[str],
    join_type: str,
    shuffle_capacity: int,
    out_capacity: int,
    build_fill: Dict[str, object],
    string_key_flags: Sequence[bool] = (),
    null_key_sentinel: int = 0,
):
    """Partitioned hash join over the mesh: key-bucket all_to_all of BOTH
    sides (K3 + K17), then a per-rank sorted-build / probe join.

    Input cols carry join keys as ``__jk{i}`` (numeric pass-through or
    stable string hashes, ExprCompiler.compile_key) plus payload columns.
    ``join_type``: inner | left | semi | anti.

    Returns ``run((pcols, pmask), (bcols, bmask)) -> (out_cols, out_mask,
    overflow)``, outputs listed over the ranks with ``out_capacity`` rows a
    rank (inner/left add the probe rows for the unmatched-row append)."""
    n = mesh_axis_size(mesh)
    key_names = [f"__jk{i}" for i in range(n_keys)]
    sflags = list(string_key_flags) or [False] * n_keys

    def per_shard(pcols, pmask, bcols, bmask):
        if n == 1:
            # one rank: the exchange is an identity, so the dispatch and its
            # worst-case send buffers are skipped
            p_recv, p_rmask = pcols, pmask
            b_recv, b_rmask = bcols, bmask
            ovf_exchange = torch.zeros((), dtype=torch.bool, device=pmask.device)
        else:
            pk = [pcols[k] for k in key_names]
            bk = [bcols[k] for k in key_names]
            # ship rows to their key-hash bucket owner (both sides agree)
            pdest = K.bucket_of(pk, n)
            bdest = K.bucket_of(bk, n)
            p_recv, p_rmask, ovf_p = yield from shuffle_rows(pcols, pdest, pmask, n,
                                                             shuffle_capacity)
            b_recv, b_rmask, ovf_b = yield from shuffle_rows(bcols, bdest, bmask, n,
                                                             shuffle_capacity)
            ovf_exchange = ovf_p[0] | ovf_b[0]
        out_cols, out_mask, ovf_j = _probe_emit(
            join_type, key_names, sflags, null_key_sentinel, probe_names,
            build_names, build_fill, out_capacity,
            p_recv, p_rmask, b_recv, b_rmask)
        return out_cols, out_mask, ovf_exchange | ovf_j

    return _make_join_runner(per_shard, mesh)


def distributed_grouped_aggregate(
    mesh: Mesh,
    key_names: Sequence[str],
    agg_specs: Sequence[Tuple[str, str]],
    partial_capacity: int,
    final_capacity: int,
    skew_factor: float = 2.0,
):
    """Distributed GROUP BY without a fused filter stage."""
    return distributed_filter_aggregate(
        mesh, _identity_filter, key_names, agg_specs, partial_capacity,
        final_capacity, skew_factor=skew_factor)
