"""Device kernels of the port: eighteen hand-written CUDA kernels, each
beside its plain PyTorch twin (K12 and K13, the kernels generated per fused
chain, K15, generated per passthrough aggregate, K19, generated per
operator program, and the mesh derive, generated per mesh aggregate, live
in compile/fused.py and count their launches here).

| kernel | source | replaces (arrow_ballista_tpu/ops/kernels.py) |
| --- | --- | --- |
| K1 ``dense_grouped`` / ``dense_group_states`` | ``csrc/dense_agg.cu`` + ``dense_agg.cuh`` | ``dense_group_states`` l.564 and its compaction l.638, l.677 |
| K2 ``compaction_order`` | ``csrc/compact.cu`` | ``compaction_order`` l.88 |
| K3 ``hash64`` / ``bucket_of`` | ``csrc/hash.cu`` | ``hash64`` l.62, ``bucket_of`` l.77 |
| K4 ``sort_order`` | ``csrc/sort.cu`` | ``sort_order`` l.195 |
| K5 ``build_side_sort`` | ``csrc/join_build.cu`` | ``build_side_sort`` l.728 |
| K6 ``probe_join`` / ``probe_counts`` | ``csrc/probe.cu`` | ``probe_join`` l.739 |
| K7 ``segment_any`` (the join's mask folded in) | ``csrc/segment.cu`` | ``segment_any`` l.772 and its mask in the join program, operators.py:1319 |
| K8 ``grouped_on_order`` | ``csrc/seg_agg.cu`` | ``_grouped_aggregate_on_order`` l.314 |
| K9 ``presorted_disorder`` | ``csrc/clustered.cu`` | ``grouped_aggregate_presorted`` l.237 |
| K10 ``key_range_check`` | ``csrc/clustered.cu`` | operators.py:632-654 "sort.range_check" |
| K11 ``clustered_keep`` | ``csrc/clustered.cu`` | operators.py:672-697 "agg.clustered_keep" |
| K14 ``extract_field`` | ``csrc/extract.cu`` + ``civil.cuh`` | ``extract_field`` l.800, ``civil_from_days`` l.782 |
| K16 ``spill_order`` (and ``spill_partition``) | ``csrc/compact.cu`` (``csrc/hash.cu``) | operators.py:1512 "join.spill_part" and the pack's compaction l.122 |
| K17 ``dispatch_to_buckets`` | ``csrc/dispatch.cu`` | parallel/ici_shuffle.py:33 |
| K18 ``merge_rank_columns`` (and its one-column case ``merge_rank_states``) | ``csrc/rank_merge.cu`` | parallel/distributed.py:136-145 psum/pmin/pmax and the ``> 0`` |
| K20 ``concat_columns`` | ``csrc/gather.cu`` | models/batch.py:435 "batch.concat" |
| K21 ``gather_columns`` | ``csrc/gather.cu`` | models/batch.py:439 "batch.shrink", ``pack_for_host`` l.122 |
| K22 ``window_mask`` / ``mask_or`` / ``mask_and`` | ``csrc/gather.cu`` | operators.py:1029-1040 "join.window_mask", "join.mask_or", "join.mask_and" |
| K22 ``bucket_masks`` | ``csrc/gather.cu`` | shuffle.py:493-497 "repartition.bucket" |

A wrapper takes the twin only for a tensor that lies on the CPU (the
tests); for a CUDA tensor it launches its kernel or raises.  ``LAUNCHES``
counts each wrapper's launches, so a run can show that its path went
through the kernels (K1 counts both its forms under ``dense_group_states``,
K18 both its wrappers' launches under ``merge_rank_states``;
``fused_agg_dense`` counts the K13 launches that took the dense form,
each also one of ``fused_agg``).  Shapes stay static as in the reference: data-
dependent counts live in fixed capacities with liveness masks.

torch has no full uint64 arithmetic, so 64-bit hashes travel as int64 bit
patterns (the same bits the reference's uint64 arrays hold).

In-place updates: only on tensors a function has just allocated (the
twins' ``index_add_`` / ``scatter_reduce_`` accumulators and the
compaction scatter; the kernels' own outputs).  Inputs, which batches
share freely, are never written.
"""
from __future__ import annotations

import ctypes
import itertools
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..obs import device as _obs
from ..utils.config import env_flag
from . import _cuda

LAUNCHES: Dict[str, int] = {"dense_group_states": 0, "compaction_order": 0,
                            "hash64": 0, "sort_order": 0, "build_side_sort": 0,
                            "probe_join": 0, "segment_any": 0, "grouped_on_order": 0,
                            "presorted_disorder": 0, "key_range_check": 0,
                            "clustered_keep": 0, "fused_rows": 0, "fused_agg": 0,
                            "extract_field": 0, "passthrough_rows": 0,
                            "spill_partition": 0, "spill_order": 0,
                            "dispatch_to_buckets": 0,
                            "merge_rank_states": 0, "mesh_derive": 0,
                            "operator_program": 0, "concat_columns": 0,
                            "fused_agg_dense": 0,
                            "gather_columns": 0, "mask_ops": 0, "bucket_masks": 0}
# the standalone engine launches from several task threads at once
_LAUNCH_LOCK = threading.Lock()


def count_launch(name: str) -> None:
    """One launch of kernel ``name``; wrappers call it where they launch.
    The single point every launch goes through: with the device
    observatory on (obs/device.py), it also attributes the launch to the
    open operator and task scopes of this thread and closes its event
    bracket; off, that costs one predicate."""
    with _LAUNCH_LOCK:
        LAUNCHES[name] += 1
    if _obs._enabled:
        _obs.record_launch(name)


def reset_launch_counts() -> None:
    with _LAUNCH_LOCK:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


# element kinds of csrc/common.cuh
_KIND = {torch.int32: 0, torch.int64: 1, torch.bool: 2, torch.float32: 3,
         torch.float64: 4}


def _is_cpu(t: torch.Tensor) -> bool:
    return t.device.type == "cpu"


def _require_cuda(*tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"kernel inputs must share one CUDA device, got {t.device}")


def _stream(device: torch.device) -> ctypes.c_void_p:
    """The device's current CUDA stream.  The raw getter skips the Stream
    object that ``torch.cuda.current_stream`` builds on every launch."""
    if _obs._timing:  # a task scope times launches: open this launch's bracket
        _obs.launch_begin()
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is None:
        return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
    index = device.index if device.index is not None else torch.cuda.current_device()
    return ctypes.c_void_p(raw(index))


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _flat(t: torch.Tensor) -> torch.Tensor:
    """Contiguous 1-D view with bool as its uint8 bytes."""
    t = t.contiguous()
    return t.view(torch.uint8) if t.dtype == torch.bool else t


def _s64(u: int) -> int:
    """uint64 constant -> the int64 with the same bits."""
    return u - (1 << 64) if u >= (1 << 63) else u


# --------------------------------------------------------------------------
# K3: hashing
# --------------------------------------------------------------------------


def force_hash_collisions() -> bool:
    """Collision-stress mode: ``BALLISTA_FORCE_HASH_COLLISIONS=1`` makes
    every hash 0, so all rows share one shuffle bucket.  Read once per
    process, so every launch agrees on it."""
    global _FORCE_COLLISIONS
    if _FORCE_COLLISIONS is None:
        _FORCE_COLLISIONS = bool(env_flag("BALLISTA_FORCE_HASH_COLLISIONS"))
    return _FORCE_COLLISIONS


_FORCE_COLLISIONS: Optional[bool] = None

_MIX1 = _s64(0xBF58476D1CE4E5B9)
_MIX2 = _s64(0x94D049BB133111EB)
_GOLDEN = _s64(0x9E3779B97F4A7C15)


def _shr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bit patterns."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def _hash_widen(a: torch.Tensor) -> torch.Tensor:
    """XLA's astype(uint64) as int64 bits: ints sign-extend, bools are 0/1."""
    if a.dtype in (torch.int32, torch.int64, torch.bool):
        return a.to(torch.int64)
    if a.dtype == torch.uint64:
        return a.view(torch.int64)
    raise TypeError(f"hash keys must be int32, int64 or bool, got {a.dtype}")


def hash64_plain(arrays: Sequence[torch.Tensor]) -> torch.Tensor:
    """Plain twin of K3's hash: splitmix64 per column, combined."""
    h = torch.zeros(arrays[0].shape, dtype=torch.int64, device=arrays[0].device)
    if force_hash_collisions():
        return h
    for a in arrays:
        x = _hash_widen(a)
        x = (x ^ _shr(x, 30)) * _MIX1
        x = (x ^ _shr(x, 27)) * _MIX2
        x = x ^ _shr(x, 31)
        h = h * _GOLDEN + x
        h = h ^ _shr(h, 29)
    return h


def _umod(h: torch.Tensor, n: int) -> torch.Tensor:
    """uint64 % n of int64 bit patterns (torch has no unsigned modulo)."""
    r = torch.remainder(h, n)
    wrap = (1 << 64) % n
    return torch.where(h < 0, torch.remainder(r + wrap, n), r)


def bucket_of_plain(key_arrays: Sequence[torch.Tensor], num_buckets: int) -> torch.Tensor:
    return _umod(hash64_plain(key_arrays), num_buckets).to(torch.int32)


def _hash_columns(arrays: Sequence[torch.Tensor]):
    """Key columns as the hash kernels (K3, K5) take them: contiguous, with
    pointer and kind arrays for ctypes.  Returns (cols, ptrs, kinds); the
    caller keeps ``cols`` alive until the launch is queued."""
    if not 1 <= len(arrays) <= 16:
        raise ValueError(f"hash kernels take 1-16 key columns, got {len(arrays)}")
    cols, kind_list = [], []
    for a in arrays:
        if a.dtype == torch.uint64:
            a = a.view(torch.int64)
        if a.dtype not in (torch.int32, torch.int64, torch.bool):
            raise TypeError(f"hash keys must be int32, int64 or bool, got {a.dtype}")
        cols.append(_flat(a))
        kind_list.append(_KIND[a.dtype])
    k = len(cols)
    ptrs = (ctypes.c_void_p * k)(*[c.data_ptr() for c in cols])
    kinds = (ctypes.c_int * k)(*kind_list)
    return cols, ctypes.cast(ptrs, ctypes.c_void_p), ctypes.cast(kinds, ctypes.c_void_p)


def _hash_launch(arrays: Sequence[torch.Tensor], num_buckets: Optional[int]) -> torch.Tensor:
    _require_cuda(*arrays)
    cols, ptrs, kinds = _hash_columns(arrays)
    n = cols[0].shape[0]
    dev = cols[0].device
    out = torch.empty(n, dtype=torch.int64 if num_buckets is None else torch.int32,
                      device=dev)
    if n == 0:
        return out
    k = len(cols)
    lib = _cuda.LIBRARIES.get("hash")
    zero = int(force_hash_collisions())
    if num_buckets is None:
        err = lib.ab_hash64(ptrs, kinds, k, n, zero, _ptr(out), _stream(dev))
    else:
        err = lib.ab_bucket_of(ptrs, kinds, k, n, zero, int(num_buckets), _ptr(out),
                               _stream(dev))
    _cuda.check(err, "hash")
    count_launch("hash64")
    return out


def hash64(arrays: Sequence[torch.Tensor]) -> torch.Tensor:
    """Combine columns into a 64-bit mixed hash (int64 bits)."""
    if _is_cpu(arrays[0]):
        return hash64_plain(arrays)
    return _hash_launch(arrays, None)


def bucket_of(key_arrays: Sequence[torch.Tensor], num_buckets: int) -> torch.Tensor:
    """Shuffle partition id per row: hash64 % num_buckets as int32."""
    if _is_cpu(key_arrays[0]):
        return bucket_of_plain(key_arrays, num_buckets)
    return _hash_launch(key_arrays, num_buckets)


# --------------------------------------------------------------------------
# K16: the spilled join's build partitions
# --------------------------------------------------------------------------


def _spill_bits(num_parts: int) -> int:
    if num_parts < 2 or num_parts & (num_parts - 1) or num_parts > (1 << 30):
        raise ValueError(f"spill partitions must be a power of two >= 2, got {num_parts}")
    return (num_parts - 1).bit_length()


def spill_partition_plain(key_arrays: Sequence[torch.Tensor], num_parts: int) -> torch.Tensor:
    """Plain twin of K16: the top bits of hash64, as int32."""
    bits = _spill_bits(num_parts)
    return (_shr(hash64_plain(key_arrays), 64 - bits) & (num_parts - 1)).to(torch.int32)


def spill_partition(key_arrays: Sequence[torch.Tensor], num_parts: int) -> torch.Tensor:
    """Build partition (int32 in [0, num_parts)) of each row: the top
    log2(num_parts) bits of the rows' hash64."""
    if _is_cpu(key_arrays[0]):
        return spill_partition_plain(key_arrays, num_parts)
    bits = _spill_bits(num_parts)
    _require_cuda(*key_arrays)
    cols, ptrs, kinds = _hash_columns(key_arrays)
    n = cols[0].shape[0]
    dev = cols[0].device
    out = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return out
    lib = _cuda.LIBRARIES.get("hash")
    _cuda.check(lib.ab_spill_partition(ptrs, kinds, len(cols), n, int(force_hash_collisions()),
                                       bits, _ptr(out), _stream(dev)), "spill_partition")
    count_launch("spill_partition")
    return out


SPILL_ORDER_MAX_PARTS = 8  # csrc/compact.cu SO_PARTS_MAX


def spill_order_plain(key_arrays: Sequence[torch.Tensor], mask: torch.Tensor, num_parts: int):
    """Plain twin of K16's ordered form: ``spill_partition_plain``, then a
    stable argsort on (dead, partition)."""
    part = spill_partition_plain(key_arrays, num_parts)
    key = (~mask).to(torch.int64) * num_parts + part.to(torch.int64)
    order = torch.sort(key, stable=True).indices.to(torch.int32)
    return part, order, mask.sum().to(torch.int32).reshape(1)


def spill_order(key_arrays: Sequence[torch.Tensor], mask: torch.Tensor, num_parts: int):
    """A spilled build batch's partitions and the pack's order in one pass:
    (part, order, count).  ``part`` is ``spill_partition``'s int32
    partition of every row; ``order`` the stable int32 permutation that
    puts the live rows first, grouped by partition in ascending order and
    in row order within one, then the dead rows likewise; ``count`` the
    live rows as an int32 tensor of one element (``compaction_order(...,
    with_count=True)``'s).  ``order[:count]`` is what the pack gathers.
    One launch up to 2^17 rows (a cooperative grid of 2,048-row tiles),
    two above (csrc/compact.cu)."""
    if _is_cpu(mask):
        return spill_order_plain(key_arrays, mask, num_parts)
    bits = _spill_bits(num_parts)
    if num_parts > SPILL_ORDER_MAX_PARTS:
        raise ValueError(f"spill_order takes at most {SPILL_ORDER_MAX_PARTS} partitions on the "
                         f"card, got {num_parts}")
    _require_cuda(mask, *key_arrays)
    if mask.dtype != torch.bool:
        raise TypeError(f"mask must be bool, got {mask.dtype}")
    cols, ptrs, kinds = _hash_columns(key_arrays)
    m = _flat(mask)
    n = m.shape[0]
    if cols[0].shape[0] != n:
        raise ValueError("keys and mask must have one length")
    dev = m.device
    part = torch.empty(n, dtype=torch.int32, device=dev)
    order = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return part, order, torch.zeros(1, dtype=torch.int32, device=dev)
    count = torch.empty(1, dtype=torch.int32, device=dev)
    lib = _cuda.LIBRARIES.get("compact")
    launches = lib.ab_spill_launches(n)
    stream = _stream(dev)
    # each form writes every byte of the scratch it reads
    scratch = torch.empty(lib.ab_spill_scratch_bytes(n, num_parts), dtype=torch.uint8, device=dev)
    _cuda.check(lib.ab_spill_order(ptrs, kinds, len(cols), _ptr(m), n,
                                   int(force_hash_collisions()), bits, _ptr(part), _ptr(order),
                                   _ptr(count), _ptr(scratch), stream), "spill_order")
    count_launch("spill_order")
    _PLANS.spill_order = {"form": "one_launch" if launches == 1 else "two_launch", "rows": n,
                          "launches": launches}
    return part, order, count


# --------------------------------------------------------------------------
# K2: compaction
# --------------------------------------------------------------------------


def compaction_order_plain(mask: torch.Tensor) -> torch.Tensor:
    """Plain twin of K2: destinations from two cumsums, one scatter."""
    n = mask.shape[0]
    m = mask.to(torch.int64)
    live_pos = torch.cumsum(m, 0) - 1
    dead_pos = m.sum() + torch.cumsum(1 - m, 0) - 1
    dest = torch.where(mask, live_pos, dead_pos)
    out = torch.empty(n, dtype=torch.int32, device=mask.device)
    out[dest] = torch.arange(n, dtype=torch.int32, device=mask.device)
    return out


def compaction_order(mask: torch.Tensor, with_count: bool = False):
    """Stable permutation (int32) moving live rows to the front; with
    ``with_count`` also the live-row count as an int32 tensor of one
    element (K2 computes it anyway)."""
    if _is_cpu(mask):
        perm = compaction_order_plain(mask)
        return (perm, mask.sum().to(torch.int32).reshape(1)) if with_count else perm
    _require_cuda(mask)
    if mask.dtype != torch.bool:
        raise TypeError(f"mask must be bool, got {mask.dtype}")
    m = _flat(mask)
    n = m.shape[0]
    dev = m.device
    perm = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        zero = torch.zeros(1, dtype=torch.int32, device=dev)
        return (perm, zero) if with_count else perm
    count = torch.empty(1, dtype=torch.int32, device=dev)
    lib = _cuda.LIBRARIES.get("compact")
    launches = lib.ab_compact_launches(n)  # one up to 2^17 rows, two above
    # the two-launch form's status words: its count pass writes every one
    status = (torch.empty(lib.ab_compact_tiles(n), dtype=torch.int64, device=dev)
              if launches == 2 else None)
    stream = _stream(dev)
    _cuda.check(lib.ab_compaction_order(_ptr(m), n, _ptr(perm), _ptr(count),
                                        None if status is None else _ptr(status),
                                        _ptr(_accumulator(dev, stream)), stream),
                "compaction_order")
    count_launch("compaction_order")
    _PLANS.compaction_order = {"form": "one_launch" if launches == 1 else "two_launch",
                               "rows": n, "launches": launches}
    return (perm, count) if with_count else perm


# --------------------------------------------------------------------------
# K20 and K21: the batches' data movement (csrc/gather.cu)
# --------------------------------------------------------------------------

GATHER_MAX_COLS = 64  # csrc/gather.cu AB_GATHER_MAX_COLS


def _cat_spec(max_src: int, max_cols: int):
    """csrc/gather.cu ``CatSpecT<max_src, max_cols>``."""

    class Spec(ctypes.Structure):
        _fields_ = [("off", ctypes.c_longlong * (max_src + 1)), ("end", ctypes.c_longlong),
                    ("n_src", ctypes.c_int), ("n_cols", ctypes.c_int),
                    ("width", ctypes.c_int * max_cols), ("dst", ctypes.c_void_p * max_cols),
                    ("src", ctypes.c_void_p * (max_src * max_cols))]

    return Spec


# csrc/gather.cu CatSpec0-2 as (sources, columns, struct): the first form
# that holds a launch carries it; the last bounds one launch
_CAT_FORMS = [(ns, nc, _cat_spec(ns, nc)) for ns, nc in ((16, 16), (64, 8), (64, 48))]
CAT_MAX_SRC, CAT_MAX_COLS = _CAT_FORMS[-1][:2]
_GATHER_CHECKED = None  # the gather library whose structs were checked


class _GatherSpec(ctypes.Structure):
    """csrc/gather.cu ``GatherSpec``."""

    _fields_ = [("n_cols", ctypes.c_int), ("width", ctypes.c_int * GATHER_MAX_COLS),
                ("widen", ctypes.c_int * GATHER_MAX_COLS),
                ("src", ctypes.c_void_p * GATHER_MAX_COLS),
                ("dst", ctypes.c_void_p * GATHER_MAX_COLS),
                ("count_src", ctypes.c_void_p), ("count_dst", ctypes.c_void_p),
                ("zero_dst", ctypes.c_void_p)]


def _gather_lib():
    global _GATHER_CHECKED
    lib = _cuda.LIBRARIES.get("gather")
    if lib is not _GATHER_CHECKED:
        for form, (_ns, _nc, spec) in enumerate(_CAT_FORMS):
            if lib.ab_concat_spec_bytes(form) != ctypes.sizeof(spec):
                raise RuntimeError("csrc/gather.cu CatSpecT and ops/kernels.py _cat_spec differ")
        _GATHER_CHECKED = lib
    return lib


def _width(t: torch.Tensor, what: str) -> int:
    w = t.dtype.itemsize
    if w not in (1, 4, 8):
        raise TypeError(f"{what}: no kernel moves {t.dtype}")
    return w


def concat_columns_plain(cols_list: Sequence[Dict[str, torch.Tensor]],
                         masks: Sequence[torch.Tensor], pad: int):
    """Plain twin of K20, the reference's ``_concat_impl``: each column and
    the mask concatenated, then ``pad`` zero rows."""
    dev = masks[0].device
    cols = {}
    for k in cols_list[0]:
        parts = [c[k] for c in cols_list]
        if pad:
            parts.append(torch.zeros(pad, dtype=parts[0].dtype, device=dev))
        cols[k] = torch.cat(parts)
    mparts = list(masks)
    if pad:
        mparts.append(torch.zeros(pad, dtype=torch.bool, device=dev))
    return cols, torch.cat(mparts)


def concat_columns(cols_list: Sequence[Dict[str, torch.Tensor]],
                   masks: Sequence[torch.Tensor], pad: int):
    """K20: N batches' columns (``cols_list``, the same names in each) and
    masks concatenated into fresh tensors of sum(capacities) + ``pad`` rows,
    the pad zero -> (cols, mask).  One launch per group of up to
    ``CAT_MAX_SRC`` sources and ``CAT_MAX_COLS`` columns (the mask counts
    as a column), each in the smallest parameter struct that holds it."""
    if _is_cpu(masks[0]):
        return concat_columns_plain(cols_list, masks, pad)
    names = list(cols_list[0])
    # a column whose batches differ in dtype (an int32 sum beside its int64
    # per-row states) takes the promoted one, as torch.cat does
    dtypes = []
    for k in names:
        dt = cols_list[0][k].dtype
        for cols in cols_list[1:]:
            if cols[k].dtype != dt:
                dt = torch.promote_types(dt, cols[k].dtype)
        dtypes.append(dt)
    dtypes.append(torch.bool)
    _require_cuda(masks[0])
    dev = masks[0].device
    caps = [m.shape[0] for m in masks]
    off = [0, *itertools.accumulate(caps)]
    total = off[-1] + int(pad)
    outs = [torch.empty(total, dtype=dt, device=dev) for dt in dtypes]
    srcs = []  # [source][column], held until the launches are queued
    for s, (cols, m) in enumerate(zip(cols_list, masks)):
        row = [cols[k] if cols[k].dtype == dt else cols[k].to(dt)
               for k, dt in zip(names, dtypes)] + [m]
        for c, t in enumerate(row):
            if t.device != dev or t.dtype != dtypes[c] or t.shape != (caps[s],):
                raise ValueError(f"concat source {s}: column {c} is {t.dtype}{tuple(t.shape)} "
                                 f"on {t.device}, expected {dtypes[c]}[{caps[s]}] on {dev}")
        srcs.append([t if t.is_contiguous() else t.contiguous() for t in row])
    if total:
        lib = _gather_lib()
        flat_out = [_flat(o) for o in outs]
        widths = [_width(o, "concat") for o in flat_out]
        n_cols = len(outs)
        for c0 in range(0, n_cols, CAT_MAX_COLS):
            cs = list(range(c0, min(n_cols, c0 + CAT_MAX_COLS)))
            groups = list(range(0, len(srcs), CAT_MAX_SRC)) or [0]
            for g, s0 in enumerate(groups):
                ss = list(range(s0, min(len(srcs), s0 + CAT_MAX_SRC)))
                form = next(f for f, (ns, nc, _s) in enumerate(_CAT_FORMS)
                            if len(ss) <= ns and len(cs) <= nc)
                spec = _CAT_FORMS[form][2]()
                spec.n_src, spec.n_cols = len(ss), len(cs)
                spec.off[:len(ss) + 1] = off[ss[0]:ss[-1] + 2]
                spec.end = total if g == len(groups) - 1 else off[ss[-1] + 1]
                spec.width[:len(cs)] = [widths[c] for c in cs]
                spec.dst[:len(cs)] = [flat_out[c].data_ptr() for c in cs]
                # [source * n_cols + column], whole slices: a per-element
                # fill of this struct costs more than the launch
                ptrs = [srcs[s][c].data_ptr() for s in ss for c in cs]
                spec.src[:len(ptrs)] = ptrs
                _cuda.check(lib.ab_concat_columns(ctypes.byref(spec), form, _stream(dev)),
                            "concat_columns")
                count_launch("concat_columns")
    return dict(zip(names, outs[:-1])), outs[-1]


def gather_columns_plain(idx: torch.Tensor, cols: Dict[str, torch.Tensor]):
    """Plain twin of K21: ``v[idx]`` per column."""
    i = idx.long()
    return {k: v[i] for k, v in cols.items()}


def _gather_launch(idx: torch.Tensor, pairs, count=None, zero=None) -> None:
    """One K21 pass: ``pairs`` is [(source, destination)] with the
    destination holding ``len(idx)`` elements of the source's width, or
    int32 for a 1-byte source, or int64 for an int32 one; ``count`` (int32[1] source, int64[1]
    destination) and ``zero`` (an int32[1] destination) ride the first
    launch."""
    idx = idx.contiguous()
    if idx.dtype != torch.int32:
        raise TypeError(f"gather index must be int32, got {idx.dtype}")
    m = idx.shape[0]
    dev = idx.device
    flat = []
    for src, dst in pairs:
        s, d = _flat(src), dst.view(torch.uint8) if dst.dtype == torch.bool else dst
        if not d.is_contiguous() or d.shape[0] != m:
            raise ValueError(f"gather destination must hold {m} contiguous elements")
        w = _width(s, "gather")
        if w == 1 and d.dtype.itemsize == 4:
            widen = 1  # bool -> int32
        elif s.dtype == torch.int32 and d.dtype == torch.int64:
            widen = 2  # sign-extended, as torch.cat promotes it
        elif d.dtype.itemsize == w:
            widen = 0
        else:
            raise TypeError(f"gather: {src.dtype} source into a {dst.dtype} destination")
        flat.append((s, d, w, widen))
    _require_cuda(idx, *[t for s, d, _w, _x in flat for t in (s, d)])
    if m == 0 and count is None and zero is None:
        return
    lib = _gather_lib()
    groups = [flat[i:i + GATHER_MAX_COLS] for i in range(0, len(flat), GATHER_MAX_COLS)] or [[]]
    for g, group in enumerate(groups):
        spec = _GatherSpec()
        k = spec.n_cols = len(group)
        spec.width[:k] = [w for _s, _d, w, _x in group]
        spec.widen[:k] = [x for _s, _d, _w, x in group]
        spec.src[:k] = [s.data_ptr() for s, _d, _w, _x in group]
        spec.dst[:k] = [d.data_ptr() for _s, d, _w, _x in group]
        if g == 0 and count is not None:
            spec.count_src, spec.count_dst = count[0].data_ptr(), count[1].data_ptr()
        if g == 0 and zero is not None:
            spec.zero_dst = zero.data_ptr()
        _cuda.check(lib.ab_gather_columns(_ptr(idx), m, ctypes.byref(spec), _stream(dev)),
                    "gather_columns")
        count_launch("gather_columns")


def gather_columns(idx: torch.Tensor, cols: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """K21: every column gathered by one int32 index (from K2, K4 or K6)
    into fresh tensors, in one launch per ``GATHER_MAX_COLS`` columns."""
    if _is_cpu(idx):
        return gather_columns_plain(idx, cols)
    m = idx.shape[0]
    out = {k: torch.empty(m, dtype=v.dtype, device=idx.device) for k, v in cols.items()}
    if cols:
        _gather_launch(idx, [(cols[k], out[k]) for k in cols])
    return out


# --------------------------------------------------------------------------
# K22: the join's mask glue (csrc/gather.cu)
# --------------------------------------------------------------------------

_MASK_OPS = {"window": 0, "or": 1, "and": 2, "andnot": 3}  # csrc/gather.cu AB_MASK_*


def window_mask_plain(mask: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """Plain twin of K22's window: live AND row index in [lo, hi)."""
    idx = torch.arange(mask.shape[0], device=mask.device)
    return mask & (idx >= lo) & (idx < hi)


def mask_or_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a | b


def mask_and_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a & b


def mask_andnot_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a & ~b


def _mask_launch(op: str, a: torch.Tensor, b: Optional[torch.Tensor], lo: int = 0,
                 hi: int = 0) -> torch.Tensor:
    _require_cuda(a, *([b] if b is not None else []))
    if a.dtype != torch.bool or (b is not None and (b.dtype != torch.bool or b.shape != a.shape)):
        raise TypeError("mask ops take bool masks of one shape")
    fa = _flat(a)
    fb = _flat(b) if b is not None else fa
    out = torch.empty(a.shape, dtype=torch.bool, device=a.device)
    n = fa.shape[0]
    if n == 0:
        return out
    lib = _gather_lib()
    _cuda.check(lib.ab_mask_ops(_MASK_OPS[op], _ptr(fa), _ptr(fb), n, int(lo), int(hi),
                                _ptr(_flat(out)), _stream(a.device)), "mask_ops")
    count_launch("mask_ops")
    return out


def window_mask(mask: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """K22: the probe window's liveness, ``mask`` AND lo <= row < hi."""
    if _is_cpu(mask):
        return window_mask_plain(mask, lo, hi)
    return _mask_launch("window", mask, None, lo, hi)


def mask_or(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K22: ``a | b`` of two masks (a spilled semi join's verdicts)."""
    if _is_cpu(a):
        return mask_or_plain(a, b)
    return _mask_launch("or", a, b)


def mask_and(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K22: ``a & b`` of two masks (a spilled anti join's verdicts)."""
    if _is_cpu(a):
        return mask_and_plain(a, b)
    return _mask_launch("and", a, b)


def mask_andnot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K22: ``a & ~b``.  No join path calls it since the joins fold their
    masks into K7 (``segment_any(..., within, negate=True)``); it stays as
    the andnot mode of K22's one binary kernel (a mode switch in
    csrc/gather.cu), held against its twin with the other modes."""
    if _is_cpu(a):
        return mask_andnot_plain(a, b)
    return _mask_launch("andnot", a, b)


def bucket_masks_plain(mask: torch.Tensor, bucket: torch.Tensor, num_out: int) -> torch.Tensor:
    """Plain twin of K22's bucket form (the reference's
    ``[mask & (b == q) for q in range(num_out)]``), stacked."""
    return torch.stack([mask & (bucket == q) for q in range(num_out)])


def bucket_masks(mask: torch.Tensor, bucket: torch.Tensor, num_out: int) -> torch.Tensor:
    """K22's bucket form: the masks of the ``num_out`` output partitions of
    a local repartition, row q = ``mask & (bucket == q)``, in one launch.
    A bucket outside [0, num_out) selects no row.  Returns a [num_out, n]
    view of one [num_out, stride] allocation, stride = n rounded up to 16,
    so that every row ``out[q]`` is a contiguous, 16-byte-aligned mask (the
    full-width vector paths of K2 and K22 take it).  The rows share one
    allocation and, like every batch tensor, are never written again."""
    if _is_cpu(mask):
        return bucket_masks_plain(mask, bucket, num_out)
    _require_cuda(mask, bucket)
    if mask.dtype != torch.bool or bucket.dtype != torch.int32 or mask.dim() != 1 \
            or bucket.shape != mask.shape:
        raise TypeError("bucket masks take a 1-D bool mask and int32 buckets of its shape")
    if num_out < 1:
        raise ValueError(f"bucket masks need at least one partition, got {num_out}")
    n = mask.shape[0]
    stride = max(16, (n + 15) // 16 * 16)
    out = torch.empty((num_out, stride), dtype=torch.bool, device=mask.device)
    if n == 0:
        return out[:, :0]
    lib = _gather_lib()
    _cuda.check(lib.ab_bucket_masks(_ptr(_flat(mask)), _ptr(_flat(bucket)), n, int(num_out),
                                    stride, _ptr(out), _stream(mask.device)),
                "bucket_masks")
    count_launch("bucket_masks")
    return out[:, :n]


# --------------------------------------------------------------------------
# wire packing: one device->host copy per materialization boundary
# --------------------------------------------------------------------------


def pack_for_host_plain(cols, mask, target: int, namesi64, namesf64, names32, order=None):
    """Plain twin of pack_for_host: K2's twin (or the given order and
    count), gathers, ``torch.cat`` and ``torch.stack``, as the reference
    writes it."""
    if order is None:
        order = (compaction_order(mask), mask.sum().to(torch.int32).reshape(1))
    perm, count = order
    order = perm[:target].long()
    parts = [count.to(torch.int64).reshape(1)]
    for k in namesi64:
        parts.append(cols[k][order])
    if names32:
        w32 = []
        for k in names32:
            v = cols[k]
            if v.dtype == torch.float32:
                v = v.view(torch.int32)
            else:
                v = v.to(torch.int32)
            w32.append(v[order])
        w = torch.cat(w32)
        if w.shape[0] % 2:
            w = torch.cat([w, torch.zeros(1, dtype=torch.int32, device=w.device)])
        parts.append(w.view(torch.int64))
    buf = torch.cat(parts)
    fbuf = torch.stack([cols[k][order] for k in namesf64]) if namesf64 else None
    return buf, fbuf


def pack_for_host(cols, mask, target: int, namesi64, namesf64, names32, order=None):
    """Compact live rows to the front and pack columns + live-row count.

    Same layout as the reference (arrow_ballista_tpu/ops/kernels.py:122):
    ``buf`` is one int64 buffer [count:1][each int64 column:target][all
    32-bit columns, bit-paired into int64]; ``fbuf`` stacks float64 columns
    (or None).  K2 orders the rows and counts them, unless ``order`` gives
    a precomputed (int32 permutation with the live rows first, int32[1]
    live count), as K16's ``spill_order`` does; one K21 pass gathers every
    column through it straight into its slice of ``buf`` or its row of
    ``fbuf`` (bools widened to int32) and writes the count."""
    if _is_cpu(mask):
        return pack_for_host_plain(cols, mask, target, namesi64, namesf64, names32, order)
    perm, count = compaction_order(mask, with_count=True) if order is None else order
    idx = perm[:target]
    dev = mask.device
    n32 = len(names32) * target
    buf = torch.empty(1 + len(namesi64) * target + (n32 + 1) // 2, dtype=torch.int64,
                      device=dev)
    fbuf = (torch.empty((len(namesf64), target), dtype=torch.float64, device=dev)
            if namesf64 else None)
    pairs = []
    for j, k in enumerate(namesi64):
        pairs.append((cols[k], buf[1 + j * target:1 + (j + 1) * target]))
    w = buf[1 + len(namesi64) * target:].view(torch.int32)
    for j, k in enumerate(names32):
        v = cols[k]
        if v.dtype == torch.float32:
            v = v.view(torch.int32)
        elif v.dtype not in (torch.int32, torch.bool):
            v = v.to(torch.int32)
        pairs.append((v, w[j * target:(j + 1) * target]))
    for j, k in enumerate(namesf64):
        pairs.append((cols[k], fbuf[j]))
    _gather_launch(idx, pairs, count=(count, buf[:1]), zero=w[n32:] if n32 % 2 else None)
    return buf, fbuf


def unpack_from_host(buf, fbuf, target: int, fieldsi64, fieldsf64, fields32):
    """Host half of pack_for_host: slice the fetched buffers back into
    per-column numpy arrays (views where possible).  ``fields*`` are
    [(name, np_dtype)] in pack order.  Returns (cols, n) or (None, n) when
    the packed target was too small and the caller must refetch."""
    n = int(buf[0])
    if n > target:
        return None, n
    out = {}
    off = 1
    for name, _dt in fieldsi64:
        out[name] = buf[off:off + target][:n]
        off += target
    if fields32:
        w = buf[off:].view(np.int32)[: len(fields32) * target]
        for i, (name, dt) in enumerate(fields32):
            seg = w[i * target:i * target + target][:n]
            if dt.kind == "f":
                out[name] = seg.view(dt)
            elif dt == np.bool_:
                out[name] = seg.astype(np.bool_)
            else:
                out[name] = seg.astype(dt, copy=False)
    for i, (name, _dt) in enumerate(fieldsf64):
        out[name] = fbuf[i][:n]
    return out, n


def to_host(t: torch.Tensor) -> np.ndarray:
    """One device->host copy into pinned memory; CPU tensors pass through."""
    if _is_cpu(t):
        return t.numpy()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    return host.numpy()


# --------------------------------------------------------------------------
# K4: sorting
# --------------------------------------------------------------------------


def sort_words(a: torch.Tensor, asc: bool) -> torch.Tensor:
    """int64 words whose signed order is the reference's order of ``a``:
    desc ints negated in int64 (wrapping), desc bools inverted, desc floats
    negated; floats compare as XLA's sort does: -0.0 equals +0.0 and every
    NaN sorts greatest (after the negation, so in both directions)."""
    if a.dtype == torch.bool:
        w = a.to(torch.int64)
        return w if asc else 1 - w
    if a.dtype in (torch.int32, torch.int64):
        w = a.to(torch.int64)
        return w if asc else torch.neg(w)
    if a.dtype in (torch.float32, torch.float64):
        f = a.to(torch.float64)  # exact for float32; the order is the same
        if not asc:
            f = -f
        f = torch.where(torch.isnan(f), torch.full_like(f, float("nan")), f + 0.0)
        b = f.contiguous().view(torch.int64)
        b = torch.where(torch.isnan(f), torch.full_like(b, 0x7FF8000000000000), b)
        return b ^ ((b >> 63) & ((1 << 63) - 1))
    raise TypeError(f"unsupported sort key dtype {a.dtype}")


def sort_order_plain(keys: Sequence[Tuple[torch.Tensor, bool]],
                     mask: torch.Tensor) -> torch.Tensor:
    """Plain twin of K4: a chain of stable sorts from the last key to the
    first, then live before dead."""
    n = mask.shape[0]
    order = torch.arange(n, device=mask.device)
    words = [sort_words(a, asc) for a, asc in keys]
    words.insert(0, (~mask).to(torch.int64))
    for w in reversed(words):
        order = order[torch.sort(w[order], stable=True).indices]
    return order.to(torch.int32)


_RADIX_DIGIT_BITS = 8  # csrc/radix.cuh RX_BITS
_MASK64 = (1 << 64) - 1
# widest span of one sort word of each key dtype, in bits (sort_words)
_WORD_BITS = {torch.int32: 32, torch.int64: 64, torch.bool: 1, torch.float32: 64,
              torch.float64: 64}
# K4's and K5's form, composite bits, layout and passes of this thread's
# last call of each (for reports and checks; a single-block K4 call's
# layout is a device tensor)
_PLANS = threading.local()


def sort_layout(mins: Sequence[int], maxs: Sequence[int]):
    """K4's composite key layout from each sort word's min and max (the
    dead flag first, then the keys' ``sort_words``): a word keeps the bit
    length of its span ``max - min`` taken as uint64 (0 for a constant
    word, which drops out); the words are packed MSB-first, as ``word -
    min`` unsigned, into one unsigned integer of ``total`` bits, held in
    ``ceil(total / 64)`` uint64 limbs (limb 0 least significant; a field
    may straddle two limbs).  Returns (widths, offsets, total, limbs):
    field j occupies bits [offsets[j], offsets[j] + widths[j])."""
    widths = [((int(hi) - int(lo)) & _MASK64).bit_length() for lo, hi in zip(mins, maxs)]
    total = sum(widths)
    offsets, off = [], total
    for w in widths:
        off -= w
        offsets.append(off)
    return widths, offsets, total, (total + 63) // 64


def sort_layout_of(keys: Sequence[Tuple[torch.Tensor, bool]], mask: torch.Tensor) -> dict:
    """``sort_layout`` of these keys' sort words over all rows, the dead
    flag first, as ``radix_plan`` reports K4's layout: {"lo", "widths",
    "offsets", "bits"}.  K4's single-block form computes it on the device;
    the card tests hold the two together."""
    words = [(~mask.reshape(-1)).to(torch.int64)] + [sort_words(a.reshape(-1), asc)
                                                     for a, asc in keys]
    mins = [int(w.min()) for w in words]
    widths, offsets, total, _limbs = sort_layout(mins, [int(w.max()) for w in words])
    return {"lo": mins, "widths": widths, "offsets": offsets, "bits": total}


def _bitonic_steps(n: int) -> int:
    """Compare-exchange steps of the single-block form's bitonic network
    over the power of two >= n (csrc/radix.cuh rx_block_sort)."""
    log = max(n - 1, 0).bit_length()
    return log * (log + 1) // 2


def kernel_plan(name: str) -> dict:
    """This thread's last call's plan of K2 (``compaction_order``: form,
    rows, launches), K6 (``probe_join``, either wrapper: mode, rows,
    launches), K16's ordered form (``spill_order``: form, rows, launches),
    K7 (``segment_any``: rows, segments, launches), K17
    (``dispatch_to_buckets``: rows, count and scatter launches) or K18
    (``merge_rank_columns``: columns, ranks, slots, launches)."""
    return dict(getattr(_PLANS, name, {}))


def radix_plan(name: str, read_device: bool = True) -> dict:
    """This thread's last call's plan of K4 (``sort_order``) or K5
    (``build_side_sort``): form ("single_block", "onesweep" or "identity"),
    rows, composite bits, radix passes (0 in the single-block form, which
    takes "steps" of a bitonic network) and launches; K4's also its layout
    (``sort_layout_of``'s keys).  A K4 single-block call's layout and
    bits are read back from the card, or left as None without
    ``read_device``."""
    plan = dict(getattr(_PLANS, name, {}))
    dev_layout = plan.pop("device_layout", None)
    if dev_layout is not None:
        plan["layout"] = plan["bits"] = None
        if read_device:
            v, f = dev_layout.tolist(), (dev_layout.numel() - 1) // 3
            plan["layout"] = {"lo": v[:f], "widths": v[f:2 * f], "offsets": v[2 * f:3 * f],
                              "bits": v[3 * f]}
            plan["bits"] = v[3 * f]
    return plan


def sort_order(keys: Sequence[Tuple[torch.Tensor, bool]], mask: torch.Tensor) -> torch.Tensor:
    """Permutation (int32) sorting live rows by (k1, k2, ...) with per-key
    ascending flags; dead rows sort to the end; stable."""
    if _is_cpu(mask):
        return sort_order_plain(keys, mask)
    _require_cuda(mask, *[a for a, _ in keys])
    k = len(keys)
    if k > 8:
        raise ValueError(f"sort_order takes at most 8 keys, got {k}")
    cols = [_flat(a) for a, _ in keys]
    m = _flat(mask)
    n = m.shape[0]
    dev = m.device
    perm = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return perm
    for a, _ in keys:
        if a.dtype not in _KIND:
            raise TypeError(f"unsupported sort key dtype {a.dtype}")
    ptrs = (ctypes.c_void_p * max(k, 1))(*[c.data_ptr() for c in cols])
    kinds = (ctypes.c_int * max(k, 1))(*[_KIND[a.dtype] for a, _ in keys])
    desc = (ctypes.c_int * max(k, 1))(*[0 if asc else 1 for _, asc in keys])
    args = (ctypes.cast(ptrs, ctypes.c_void_p), ctypes.cast(kinds, ctypes.c_void_p),
            ctypes.cast(desc, ctypes.c_void_p), k, _ptr(m), n)
    lib = _cuda.LIBRARIES.get("sort")
    # the single-block form where the widest composite these dtypes allow fits
    wmax = (1 + sum(_WORD_BITS[a.dtype] for a, _ in keys) + 63) // 64
    if lib.ab_sort_block_bytes(n, wmax) > 0:
        layout = torch.empty(3 * (k + 1) + 1, dtype=torch.int64, device=dev)
        _cuda.check(lib.ab_sort_order_block(*args, wmax, _ptr(perm), _ptr(layout), _stream(dev)),
                    "sort_order")
        count_launch("sort_order")
        _PLANS.sort_order = {"form": "single_block", "rows": n, "device_layout": layout,
                             "passes": 0, "steps": _bitonic_steps(n), "launches": 1}
        return perm
    # each sort word's min and max over all rows, read back for the layout
    partial = torch.empty((lib.ab_sort_minmax_blocks(n), k + 1, 2), dtype=torch.int64, device=dev)
    _cuda.check(lib.ab_sort_minmax(*args, _ptr(partial), _stream(dev)), "sort_order")
    host = partial.cpu().numpy()
    mins = host[:, :, 0].min(0).tolist()
    widths, offsets, total, _limbs = sort_layout(mins, host[:, :, 1].max(0).tolist())
    scratch = torch.empty(lib.ab_sort_scratch_bytes(n, total), dtype=torch.uint8, device=dev)
    lo = (ctypes.c_longlong * (k + 1))(*mins)
    bits = (ctypes.c_int * (k + 1))(*widths)
    offs = (ctypes.c_int * (k + 1))(*offsets)
    _cuda.check(lib.ab_sort_order(*args, ctypes.cast(lo, ctypes.c_void_p),
                                  ctypes.cast(bits, ctypes.c_void_p),
                                  ctypes.cast(offs, ctypes.c_void_p), total, _ptr(scratch),
                                  _ptr(perm), _stream(dev)), "sort_order")
    count_launch("sort_order")
    passes = -(-total // _RADIX_DIGIT_BITS)
    _PLANS.sort_order = {"form": "onesweep" if passes else "identity", "rows": n, "bits": total,
                         "layout": {"lo": mins, "widths": widths, "offsets": offsets,
                                    "bits": total},
                         "passes": passes, "launches": 3 + passes if passes else 2}
    return perm


# --------------------------------------------------------------------------
# K1: dense grouped aggregation
# --------------------------------------------------------------------------

AGG_SUM = "sum"
AGG_COUNT = "count"
AGG_MIN = "min"
AGG_MAX = "max"
_HOW = {AGG_SUM: 0, AGG_COUNT: 1, AGG_MIN: 2, AGG_MAX: 3}

DENSE_DOMAIN_LIMIT = 1 << 16  # max enumerable key-combination count


def dense_domain(key_ranges) -> Optional[int]:
    """Enumerable key-combination count when EVERY key has static (lo, hi)
    bounds and the product is within DENSE_DOMAIN_LIMIT; else None."""
    if not key_ranges or any(r is None for r in key_ranges):
        return None
    domain = 1
    for lo, hi in key_ranges:
        domain *= max(0, hi - lo + 1)
    return domain if 0 < domain <= DENSE_DOMAIN_LIMIT else None


def _dense_strides(key_ranges):
    """Row-major packing of a dense key domain: per-key sizes and strides.
    dense_group_states encodes fused keys with it and compact_dense_states
    decodes them."""
    sizes = [hi - lo + 1 for lo, hi in key_ranges]
    strides = [1] * len(sizes)
    for i in range(len(sizes) - 2, -1, -1):
        strides[i] = strides[i + 1] * sizes[i + 1]
    return sizes, strides


def _max_ident(dtype: torch.dtype):
    if dtype.is_floating_point:
        return float("inf")
    return torch.iinfo(dtype).max


def _min_ident(dtype: torch.dtype):
    if dtype.is_floating_point:
        return float("-inf")
    return torch.iinfo(dtype).min


def dense_group_states_plain(key_cols, val_cols, mask, key_ranges, domain):
    """Plain twin of K1 (the reference's formulation: out-of-range rows
    fold into the scratch slot ``domain``, which is sliced off)."""
    _sizes, strides = _dense_strides(key_ranges)
    dev = mask.device
    fused = torch.zeros(mask.shape, dtype=torch.int32, device=dev)
    in_range = mask.clone()
    for k, (lo, hi), stride in zip(key_cols, key_ranges, strides):
        ki = k.to(torch.int32)
        in_range = in_range & (ki >= lo) & (ki <= hi)
        fused = fused + (ki - lo) * stride
    bad_rows = (mask & ~in_range).any()
    seg = torch.where(in_range, fused, domain).long()
    exists = torch.zeros(domain + 1, dtype=torch.int32, device=dev).index_add_(
        0, seg, in_range.to(torch.int32))[:domain]
    dense_vals = []
    for arr, how in val_cols:
        if how == AGG_COUNT:
            v = torch.zeros(domain + 1, dtype=torch.int64, device=dev).index_add_(
                0, seg, in_range.to(torch.int64))
        elif how == AGG_SUM:
            v = torch.zeros(domain + 1, dtype=arr.dtype, device=dev).index_add_(
                0, seg, torch.where(in_range, arr, torch.zeros((), dtype=arr.dtype, device=dev)))
        elif how in (AGG_MIN, AGG_MAX):
            ident = _max_ident(arr.dtype) if how == AGG_MIN else _min_ident(arr.dtype)
            v = torch.full((domain + 1,), ident, dtype=arr.dtype, device=dev).scatter_reduce_(
                0, seg, torch.where(in_range, arr, torch.full((), ident, dtype=arr.dtype,
                                                              device=dev)),
                "amin" if how == AGG_MIN else "amax", include_self=True)
        else:
            raise ValueError(f"unknown agg {how}")
        dense_vals.append(v[:domain])
    return dense_vals, exists, bad_rows


class _DenseSpec(ctypes.Structure):
    """csrc/dense_agg.cuh ``DenseSpec`` (AB_MAX_KEYS 8, AB_MAX_AGGS 32)."""

    _fields_ = [("key", ctypes.c_void_p * 8), ("key_kind", ctypes.c_int * 8),
                ("lo", ctypes.c_int * 8), ("hi", ctypes.c_int * 8),
                ("stride", ctypes.c_int * 8), ("k", ctypes.c_int),
                ("val", ctypes.c_void_p * 32), ("val_kind", ctypes.c_int * 32),
                ("how", ctypes.c_int * 32), ("m", ctypes.c_int),
                ("mask", ctypes.c_void_p), ("n", ctypes.c_longlong), ("domain", ctypes.c_int),
                ("form", ctypes.c_int), ("out_capacity", ctypes.c_int),
                ("out_key", ctypes.c_void_p * 8), ("out_val", ctypes.c_void_p * 32),
                ("out_mask", ctypes.c_void_p), ("out_exists", ctypes.c_void_p),
                ("out_flag", ctypes.c_void_p), ("state", ctypes.c_void_p)]


DENSE_SLOTS, DENSE_COMPACT = 0, 1  # csrc/dense_agg.cuh AB_DENSE_SLOTS / AB_DENSE_COMPACT


def dense_spec(key_dtypes, key_ranges, vals) -> Tuple[_DenseSpec, List[torch.dtype]]:
    """K1's (and K13's dense form's) plan: the keys' dtypes and ranges and
    each aggregate's (value dtype, how) -> (spec, output dtypes)."""
    k, m = len(key_dtypes), len(vals)
    if not 1 <= k <= 8 or m > 32:
        raise ValueError(f"dense aggregation takes 1-8 keys and at most 32 aggregates "
                         f"(got {k}, {m})")
    _sizes, strides = _dense_strides(key_ranges)
    spec = _DenseSpec()
    for j, (dt, (lo, hi), stride) in enumerate(zip(key_dtypes, key_ranges, strides)):
        if dt not in (torch.int32, torch.int64, torch.bool):
            raise TypeError(f"dense keys must be int32, int64 or bool, got {dt}")
        spec.key_kind[j] = _KIND[dt]
        spec.lo[j], spec.hi[j], spec.stride[j] = lo, hi, stride
    spec.k = k
    out_dtypes = []
    for a, (dt, how) in enumerate(vals):
        spec.how[a] = _HOW[how]
        if how != AGG_COUNT and dt not in (torch.int32, torch.int64, torch.float32,
                                           torch.float64):
            raise TypeError(f"dense {how} over {dt} has no kernel")
        out = torch.int64 if how == AGG_COUNT else dt
        spec.val_kind[a] = _KIND[out]
        out_dtypes.append(out)
    spec.m = m
    return spec, out_dtypes


# K1's and K13's state per (device, stream): a ticket, the bad-rows word,
# the exists counts and the accumulators, all zero between calls (the last
# block of each launch resets what it touched), grown to the largest call
_DENSE_STATES: Dict[Tuple[int, int], torch.Tensor] = {}


def _carve(dev: torch.device, parts):
    """One allocation for a call's outputs: ``parts`` are (dtype, count);
    each view starts 16-byte aligned."""
    offs, total = [], 0
    for dt, count in parts:
        offs.append(total)
        total += -(-count * dt.itemsize // 16) * 16
    buf = torch.empty(max(total, 16), dtype=torch.uint8, device=dev)
    return [buf[o:o + count * dt.itemsize].view(dt) for o, (dt, count) in zip(offs, parts)]


def dense_prepare(spec: _DenseSpec, key_dtypes, out_dtypes, dev: torch.device, n: int,
                  domain: int, out_capacity: Optional[int]):
    """Fills the call's part of ``spec`` (rows, domain, form, fresh outputs,
    the stream's state) -> (outputs, stream, state).  ``out_capacity``
    None: the slot-aligned form, outputs (values, exists, bad-rows flag);
    else the compacted form, outputs (keys, values, mask, overflow flag).
    The caller holds ``state`` until it has launched: a thread that grows
    the stream's state meanwhile must not free this one under the launch."""
    stream = _stream(dev)
    words = _cuda.LIBRARIES.get("dense_agg").ab_dense_state_words(len(out_dtypes), domain)
    state = _stream_words(_DENSE_STATES, dev, stream, words)
    spec.state = state.data_ptr()
    spec.n, spec.domain = n, domain
    m = len(out_dtypes)
    if out_capacity is None:
        spec.form = DENSE_SLOTS
        *vals, exists, flag = _carve(dev, [(dt, domain) for dt in out_dtypes]
                                     + [(torch.int32, domain), (torch.bool, 1)])
        outs = (vals, exists, flag[0])
        spec.out_exists = exists.data_ptr()
    else:
        spec.form = DENSE_COMPACT
        spec.out_capacity = out_capacity
        parts = _carve(dev, [(dt, out_capacity) for dt in (*key_dtypes, *out_dtypes)]
                       + [(torch.bool, out_capacity), (torch.bool, 1)])
        keys, vals, (mask, flag) = parts[:len(key_dtypes)], parts[len(key_dtypes):-2], parts[-2:]
        for j, t in enumerate(keys):
            spec.out_key[j] = t.data_ptr()
        spec.out_mask = mask.data_ptr()
        # overflow is impossible when every slot fits (and bad rows are
        # structurally excluded for engine-built ranges)
        outs = (keys, vals, mask, flag[0] if domain > out_capacity else None)
    for a in range(m):
        spec.out_val[a] = vals[a].data_ptr()
    spec.out_flag = flag.data_ptr()
    return outs, stream, state


def _dense_launch(key_cols, val_cols, mask, key_ranges, domain, out_capacity=None):
    _require_cuda(mask, *key_cols, *[a for a, _ in val_cols])
    key_dtypes = [c.dtype for c in key_cols]
    spec, out_dtypes = dense_spec(key_dtypes, key_ranges,
                                  [(arr.dtype, how) for arr, how in val_cols])
    keep = []  # contiguous copies whose pointers the launch reads
    for j, col in enumerate(key_cols):
        c = _flat(col)
        keep.append(c)
        spec.key[j] = c.data_ptr()
    for a, (arr, how) in enumerate(val_cols):
        if how != AGG_COUNT:
            c = _flat(arr)
            keep.append(c)
            spec.val[a] = c.data_ptr()
    mk = _flat(mask)
    spec.mask = mk.data_ptr()
    dev = mask.device
    outs, stream, _state = dense_prepare(spec, key_dtypes, out_dtypes, dev, mk.shape[0],
                                         domain, out_capacity)
    lib = _cuda.LIBRARIES.get("dense_agg")
    _cuda.check(lib.ab_dense_group_states(ctypes.byref(spec), stream), "dense_group_states")
    count_launch("dense_group_states")
    return outs


def dense_group_states(
    key_cols: List[torch.Tensor],
    val_cols: List[Tuple[torch.Tensor, str]],
    mask: torch.Tensor,
    key_ranges: Tuple[Tuple[int, int], ...],
    domain: int,
):
    """K1's slot-aligned form: slot d holds key combination d (row-major
    packing over ``key_ranges``), for EVERY d in the domain.

    Returns (dense_vals: list, exists_cnt: int32[domain], bad_rows: bool
    tensor)."""
    if _is_cpu(mask):
        return dense_group_states_plain(key_cols, val_cols, mask, key_ranges, domain)
    return _dense_launch(key_cols, val_cols, mask, key_ranges, domain)


def dense_grouped_plain(key_cols, val_cols, mask, out_capacity: int, key_ranges, domain: int):
    """Plain twin of K1's compacted form: the slot-aligned twin, then the
    compaction (K2's twin) and the key decoding."""
    dense_vals, exists_cnt, bad_rows = dense_group_states_plain(key_cols, val_cols, mask,
                                                                key_ranges, domain)
    return finish_dense([k.dtype for k in key_cols], dense_vals, exists_cnt, bad_rows,
                        out_capacity, key_ranges, domain, plain=True)


def dense_grouped(key_cols, val_cols, mask, out_capacity: int, key_ranges, domain: int):
    """K1's compacted form, grouped_aggregate's dense path in one launch:
    (out_keys, out_vals, out_mask, overflow or None), the groups in
    ascending fused-key order, then the empty slots, cut or padded to
    ``out_capacity``."""
    if _is_cpu(mask):
        return dense_grouped_plain(key_cols, val_cols, mask, out_capacity, key_ranges, domain)
    return _dense_launch(key_cols, val_cols, mask, key_ranges, domain, out_capacity)


def compact_dense_states(key_cols_dtypes, dense_vals, exists, out_capacity: int,
                         key_ranges, domain: int, plain: bool = False):
    """Compact slot-aligned dense states into (keys, vals, mask, overflow):
    non-empty groups first, in ascending fused-key order, padded/truncated
    to ``out_capacity``.  The stable compaction is K2 over ``exists``."""
    sizes, strides = _dense_strides(key_ranges)
    order = (compaction_order_plain if plain else compaction_order)(exists)
    if domain > out_capacity:
        order = order[:out_capacity]
    num_groups = exists.sum()
    idx = order.long()
    out_mask = exists[idx]
    out_vals = [v[idx] for v in dense_vals]
    out_keys = []
    for (lo, _hi), stride, size, dt in zip(key_ranges, strides, sizes, key_cols_dtypes):
        dk = lo + torch.remainder(torch.div(order, stride, rounding_mode="floor"), size)
        out_keys.append(dk.to(dt))
    if domain < out_capacity:
        pad = out_capacity - domain
        dev = exists.device
        out_mask = torch.cat([out_mask, torch.zeros(pad, dtype=torch.bool, device=dev)])
        out_vals = [torch.cat([v, torch.zeros(pad, dtype=v.dtype, device=dev)])
                    for v in out_vals]
        out_keys = [torch.cat([k, torch.zeros(pad, dtype=k.dtype, device=dev)])
                    for k in out_keys]
    overflow = num_groups > out_capacity
    return out_keys, out_vals, out_mask, overflow


def finish_dense(key_dtypes, dense_vals, exists_cnt, bad_rows, out_capacity, key_ranges,
                 domain, plain: bool = False):
    """Slot-aligned dense states -> grouped_aggregate's result (the twins'
    finish; the kernels' compacted form writes it in their launch)."""
    out_keys, out_vals, out_mask, overflow = compact_dense_states(
        key_dtypes, dense_vals, exists_cnt > 0, out_capacity, key_ranges, domain, plain=plain)
    if domain <= out_capacity:
        # overflow is impossible (num_groups <= domain) and bad rows are
        # structurally excluded for engine-built ranges
        return out_keys, out_vals, out_mask, None
    return out_keys, out_vals, out_mask, overflow | bad_rows


def _grouped_aggregate_dense(key_cols, val_cols, mask, out_capacity, key_ranges, domain,
                             plain: bool = False):
    grouped = dense_grouped_plain if plain else dense_grouped
    return grouped(key_cols, val_cols, mask, out_capacity, key_ranges, domain)


def grouped_aggregate(key_cols, val_cols, mask, out_capacity: int, key_ranges=None,
                      plain: bool = False):
    """Group by ``key_cols`` and reduce ``val_cols`` (list of (array, how)).

    Returns (out_keys, out_vals, out_mask, overflow or None).  When every
    key has a static (lo, hi) range and the domain stays within
    DENSE_DOMAIN_LIMIT, the dense path (K1's compacted form); otherwise the sort path:
    K4's order over the keys (K2's live-first order when there are no
    keys), then K8 over the reordered rows.  Groups come out in ascending
    key order on both paths.  CONTRACT (as in the reference): every live
    row's key lies inside its declared range; when the domain fits
    ``out_capacity`` out-of-range rows are dropped silently.  ``plain``
    takes every kernel's twin, whatever the device."""
    if key_cols:
        domain = dense_domain(key_ranges)
        if domain is not None:
            return _grouped_aggregate_dense(key_cols, val_cols, mask, out_capacity,
                                            key_ranges, domain, plain=plain)
    n = mask.shape[0]
    if key_cols:
        order = (sort_order_plain if plain else sort_order)([(k, True) for k in key_cols], mask)
    else:
        order = (compaction_order_plain if plain else compaction_order)(mask)
    on_order = grouped_on_order_plain if plain else grouped_on_order
    return on_order(key_cols, val_cols, mask, out_capacity, n, order)


# --------------------------------------------------------------------------
# K8: grouped aggregation over rows in group order (the sort path)
# --------------------------------------------------------------------------


def overflow_flag(x):
    """A grouped_aggregate overflow result as a tensor: None (statically
    impossible) becomes a constant False."""
    return torch.zeros((), dtype=torch.bool) if x is None else x


def grouped_on_order_plain(keys_s, val_cols, mask_s, out_capacity: int, n: int, order):
    """Plain twin of K8 (the reference's formulation): the gathers through
    ``order``, then boundary flags -> cumsum segment ids -> index_add_ /
    scatter_reduce_ into a dump-slotted accumulator -> each group's first
    row scatters its keys."""
    idx = order.long()
    keys_s = [k[idx] for k in keys_s]
    val_cols = [(v[idx], how) for v, how in val_cols]
    mask_s = mask_s[idx]
    n_rows = mask_s.shape[0]
    dev = mask_s.device
    cap = out_capacity
    first = torch.arange(n_rows, device=dev) == 0
    if keys_s:
        diff = torch.zeros(n_rows, dtype=torch.bool, device=dev)
        for k in keys_s:
            diff = diff | (k != torch.roll(k, 1))
        boundary = mask_s & (first | diff)
    else:
        boundary = first & mask_s.any()
    seg = torch.cumsum(boundary.to(torch.int64), 0) - 1
    num_groups = boundary.sum()
    seg_ok = mask_s & (seg >= 0) & (seg < cap)
    seg_ids = torch.where(seg_ok, seg, cap)
    out_vals = []
    for a, how in val_cols:
        if how == AGG_COUNT:
            v = torch.zeros(cap + 1, dtype=torch.int64, device=dev).index_add_(
                0, seg_ids, seg_ok.to(torch.int64))
        elif how == AGG_SUM:
            v = torch.zeros(cap + 1, dtype=a.dtype, device=dev).index_add_(
                0, seg_ids, torch.where(seg_ok, a, torch.zeros((), dtype=a.dtype, device=dev)))
        elif how in (AGG_MIN, AGG_MAX):
            ident = _max_ident(a.dtype) if how == AGG_MIN else _min_ident(a.dtype)
            fill = torch.full((), ident, dtype=a.dtype, device=dev)
            v = torch.full((cap + 1,), ident, dtype=a.dtype, device=dev).scatter_reduce_(
                0, seg_ids, torch.where(seg_ok, a, fill), "amin" if how == AGG_MIN else "amax",
                include_self=True)
        else:
            raise ValueError(f"unknown agg {how}")
        out_vals.append(v[:cap])
    opens = torch.where(boundary & seg_ok, seg, cap)
    out_keys = []
    for k in keys_s:
        ok = torch.zeros(cap + 1, dtype=k.dtype, device=dev)
        ok[opens] = k  # only the dump slot sees more than one row
        out_keys.append(ok[:cap])
    out_mask = torch.arange(cap, device=dev) < torch.clamp(num_groups, max=cap)
    overflow = (num_groups > cap) if cap < n else None
    return out_keys, out_vals, out_mask, overflow


class _SegSpec(ctypes.Structure):
    """csrc/seg_agg.cu ``SegSpec`` (SEG_MAX_KEYS 8, SEG_MAX_AGGS 32)."""

    _fields_ = [("key", ctypes.c_void_p * 8), ("key_kind", ctypes.c_int * 8),
                ("key_out", ctypes.c_void_p * 8), ("k", ctypes.c_int),
                ("val", ctypes.c_void_p * 32), ("val_kind", ctypes.c_int * 32),
                ("how", ctypes.c_int * 32), ("val_out", ctypes.c_void_p * 32),
                ("m", ctypes.c_int)]


def grouped_on_order(keys_s, val_cols, mask_s, out_capacity: int, n: int, order):
    """Grouping over rows ``order[i]`` (int32, K4's or K2's permutation,
    which puts equal keys next to each other) of the keys, values and mask
    as given: the kernel reads through the order, and no column is
    gathered first.  Returns (out_keys, out_vals, out_mask, overflow or
    None); ``overflow`` is a device flag only when ``out_capacity < n``."""
    if _is_cpu(mask_s):
        return grouped_on_order_plain(keys_s, val_cols, mask_s, out_capacity, n, order)
    _require_cuda(mask_s, order, *keys_s, *[a for a, how in val_cols if how != AGG_COUNT])
    if order.dtype != torch.int32 or order.dim() != 1:
        raise TypeError(f"the grouping order must be 1-D int32, got {order.dtype}")
    k, m = len(keys_s), len(val_cols)
    if k > 8 or m > 32:
        raise ValueError(f"sort-path grouping takes at most 8 keys and 32 aggregates "
                         f"(got {k}, {m})")
    mk = _flat(mask_s)
    rows = order.shape[0]
    if rows == 0:
        raise ValueError("grouped aggregation over an empty batch")
    dev = mk.device
    cap = int(out_capacity)
    keep = []  # contiguous copies whose pointers the launch reads
    spec = _SegSpec()
    out_keys = []
    for j, col in enumerate(keys_s):
        if col.dtype not in _KIND:
            raise TypeError(f"unsupported group key dtype {col.dtype}")
        c = _flat(col)
        out = torch.empty(cap, dtype=col.dtype, device=dev)
        keep.append(c)
        out_keys.append(out)
        spec.key[j] = c.data_ptr()
        spec.key_kind[j] = _KIND[col.dtype]
        spec.key_out[j] = _flat(out).data_ptr()
    spec.k = k
    out_vals = []
    for a, (arr, how) in enumerate(val_cols):
        spec.how[a] = _HOW[how]
        if how == AGG_COUNT:
            out = torch.empty(cap, dtype=torch.int64, device=dev)
            spec.val_kind[a] = _KIND[torch.int64]
        else:
            if arr.dtype not in (torch.int32, torch.int64, torch.float32, torch.float64):
                raise TypeError(f"sort-path {how} over {arr.dtype} has no kernel")
            c = _flat(arr)
            keep.append(c)
            out = torch.empty(cap, dtype=arr.dtype, device=dev)
            spec.val[a] = c.data_ptr()
            spec.val_kind[a] = _KIND[arr.dtype]
        spec.val_out[a] = out.data_ptr()
        out_vals.append(out)
    spec.m = m
    out_mask = torch.empty(cap, dtype=torch.bool, device=dev)
    num_groups = torch.empty(1, dtype=torch.int64, device=dev)
    lib = _cuda.LIBRARIES.get("seg_agg")
    stream = _stream(dev)
    state = _stream_words(_SEG_STATES, dev, stream, lib.ab_seg_state_words(rows))
    payload = _stream_words(_SEG_PAYLOADS, dev, stream, lib.ab_seg_payload_words(rows, m))
    oc = order.contiguous()
    err = lib.ab_grouped_on_order(ctypes.byref(spec), _ptr(mk), _ptr(oc), rows, cap,
                                  _ptr(_flat(out_mask)), _ptr(num_groups), _ptr(state),
                                  _ptr(payload), stream)
    _cuda.check(err, "grouped_on_order")
    count_launch("grouped_on_order")
    overflow = (num_groups[0] > cap) if cap < n else None
    return out_keys, out_vals, out_mask, overflow


# --------------------------------------------------------------------------
# K9-K11: the clustered (presorted) partial aggregate
# --------------------------------------------------------------------------


def _key_kind(k: torch.Tensor, mask: torch.Tensor) -> int:
    """The kernel kind of a clustered key column, which must match the mask."""
    if k.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"clustered keys must be int32 or int64, got {k.dtype}")
    if k.shape != mask.shape or k.dim() != 1:
        raise ValueError(f"keys {tuple(k.shape)} and mask {tuple(mask.shape)} must be one 1-D "
                         "length")
    return _KIND[k.dtype]


def presorted_disorder_plain(keys: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Plain twin of K9: the reference's flag (any adjacent live pair, in
    K2's compaction order, whose key decreases) written over row order,
    where those pairs are the consecutive live rows."""
    k = keys[mask]
    return (k[1:] < k[:-1]).any()


def presorted_disorder(keys: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """0-d bool on the device: True when the live keys, in row order, are
    NOT non-decreasing.  One launch, no memset: each tile leaves a record in
    a per-stream state (``_DISORDER_STATES``) and the block that draws the
    last ticket folds them in tile order."""
    if _is_cpu(mask):
        return presorted_disorder_plain(keys, mask)
    _require_cuda(keys, mask)
    kind = _key_kind(keys, mask)
    k, m = _flat(keys), _flat(mask)
    n = m.shape[0]
    flag = torch.empty(1, dtype=torch.bool, device=m.device)
    lib = _cuda.LIBRARIES.get("clustered")
    stream = _stream(m.device)
    state = _stream_words(_DISORDER_STATES, m.device, stream, lib.ab_disorder_state_words(n))
    _cuda.check(lib.ab_presorted_disorder(_ptr(k), kind, _ptr(m), n, _ptr(_flat(flag)),
                                          _ptr(state), stream),
                "presorted_disorder")
    count_launch("presorted_disorder")
    return flag[0]


def grouped_aggregate_presorted(key_cols, val_cols, mask, out_capacity: int):
    """Sort-free grouping for input already ordered by its single group key
    (clustered scans): K2's compaction order replaces the sort, K9 flags
    disorder over the rows as they are, K8 groups through the order.
    Returns (out_keys, out_vals, out_mask, overflow, disorder); on disorder
    the caller discards the result and re-runs the sort path (split runs of
    one key would emit duplicate partial states, which break early-HAVING
    filters)."""
    if len(key_cols) != 1:
        raise ValueError("presorted grouping takes exactly one key")
    order = compaction_order(mask)
    disorder = presorted_disorder(key_cols[0], mask)
    out_keys, out_vals, out_mask, overflow = grouped_on_order(
        key_cols, val_cols, mask, out_capacity, mask.shape[0], order)
    return out_keys, out_vals, out_mask, overflow, disorder


def key_range_check_plain(keys: torch.Tensor, mask: torch.Tensor, lo: int, hi: int,
                          sentinel: Optional[int] = None) -> torch.Tensor:
    """Plain twin of K10 (the reference's "sort.range_check")."""
    k = keys.to(torch.int64)
    if k.shape[0] == 0:  # no rows: no live key (torch has no min of nothing)
        return torch.zeros((), dtype=torch.bool, device=k.device)
    live = mask if sentinel is None else mask & (k != sentinel)
    big, small = torch.iinfo(torch.int64).max, torch.iinfo(torch.int64).min
    kmin = torch.where(live, k, torch.full((), big, dtype=torch.int64, device=k.device)).min()
    kmax = torch.where(live, k, torch.full((), small, dtype=torch.int64, device=k.device)).max()
    return live.any() & ((kmin < lo) | (kmax > hi))


# Buffers kept per (device, stream) for the kernels that leave them as
# they found them, so that a call queues no memset: zeroed once here, on the
# stream that will use them, and put back to zero by the last block of
# every launch (csrc/common.cuh ab_last_block).  Launches on one stream run
# in order, so back-to-back calls and task threads that share a stream
# share them safely; two streams never do.  The accumulator (uint64[2], a
# block partial and a ticket) serves K10, K11 and K2's two-launch form;
# K6's and K8's states (a ticket, a tile counter and a look-back status
# word a tile) grow to the next power of two when a call has more tiles.
# K8's look-back payloads (two folds a tile and aggregate) are a buffer of
# their own, kept apart so that one call's folds never lie where a later
# call expects a zero status word; a status word guards each fold, so
# they need no reset.  K7 keeps one hit byte a segment, which its verdict
# kernel reads and puts back to zero.  K9's state is a ticket and one
# record a tile, each written before it is read (the ticket reset by the
# last block).  K17's count takes its ticket from the accumulator.
_ACCUMULATORS: Dict[Tuple[int, int], torch.Tensor] = {}
_PROBE_STATES: Dict[Tuple[int, int], torch.Tensor] = {}
_SEG_STATES: Dict[Tuple[int, int], torch.Tensor] = {}
_SEG_PAYLOADS: Dict[Tuple[int, int], torch.Tensor] = {}
_SEG_ANY_STATES: Dict[Tuple[int, int], torch.Tensor] = {}
_DISORDER_STATES: Dict[Tuple[int, int], torch.Tensor] = {}
_SEG_ANY_LOCK = threading.Lock()
_ACCUMULATORS_LOCK = threading.Lock()


def _stream_words(table: Dict[Tuple[int, int], torch.Tensor], device: torch.device,
                  stream: ctypes.c_void_p, words: int) -> torch.Tensor:
    index = device.index if device.index is not None else torch.cuda.current_device()
    key = (index, stream.value or 0)
    with _ACCUMULATORS_LOCK:
        buf = table.get(key)
        if buf is None or buf.shape[0] < words:
            buf = table[key] = torch.zeros(1 << max(words - 1, 1).bit_length(),
                                           dtype=torch.int64, device=device)
    return buf


def _accumulator(device: torch.device, stream: ctypes.c_void_p) -> torch.Tensor:
    return _stream_words(_ACCUMULATORS, device, stream, 2)


def key_range_check(keys: torch.Tensor, mask: torch.Tensor, lo: int, hi: int,
                    sentinel: Optional[int] = None) -> torch.Tensor:
    """0-d bool on the device: True when a live key (NULL sentinel keys
    excluded) lies outside the declared [lo, hi]."""
    if _is_cpu(mask):
        return key_range_check_plain(keys, mask, lo, hi, sentinel)
    _require_cuda(keys, mask)
    k, m = _flat(keys), _flat(mask)
    flag = torch.empty(1, dtype=torch.bool, device=m.device)
    stream = _stream(m.device)
    lib = _cuda.LIBRARIES.get("clustered")
    _cuda.check(lib.ab_key_range_check(_ptr(k), _key_kind(keys, mask), _ptr(m), m.shape[0],
                                       int(sentinel is not None),
                                       0 if sentinel is None else int(sentinel), int(lo),
                                       int(hi), _ptr(_flat(flag)),
                                       _ptr(_accumulator(m.device, stream)), stream),
                "key_range_check")
    count_launch("key_range_check")
    return flag[0]


def merge_intervals(los, his) -> Tuple[np.ndarray, np.ndarray]:
    """The sorted, disjoint union of the non-empty closed integer intervals
    [los[j], his[j]]: empty pairs (lo > hi) dropped, overlapping and
    touching ones (hi_a + 1 >= lo_b, in Python ints: no overflow at int64
    max) merged.  Returns (starts, ends) as int64 arrays."""
    pairs = sorted((a, b) for a, b in zip(np.asarray(los, dtype=np.int64).tolist(),
                                          np.asarray(his, dtype=np.int64).tolist()) if a <= b)
    starts: List[int] = []
    ends: List[int] = []
    for a, b in pairs:
        if ends and ends[-1] + 1 >= a:
            ends[-1] = max(ends[-1], b)
        else:
            starts.append(a)
            ends.append(b)
    return np.asarray(starts, dtype=np.int64), np.asarray(ends, dtype=np.int64)


class KeepIntervals:
    """K11's overlap intervals, prepared once per operator on one device:
    ``los`` / ``his``, the pairs as the reference holds them (padded to a
    power of two with empty (1, 0) pairs; the twin's input), and ``starts``
    / ``ends``, their sorted, merged union (``merge_intervals``; the
    kernel's input: the same set of keys)."""

    def __init__(self, los, his, device):
        from ..models.batch import upload

        los = np.asarray(los, dtype=np.int64)
        his = np.asarray(his, dtype=np.int64)
        if los.ndim != 1 or los.shape != his.shape:
            raise ValueError("interval bounds must be two 1-D arrays of one length")
        starts, ends = merge_intervals(los, his)
        self.los, self.his, self.starts, self.ends = upload([los, his, starts, ends], device)


def clustered_keep_plain(keys, mask, pred, intervals: KeepIntervals):
    """Plain twin of K11 (the reference's "agg.clustered_keep") over the
    padded pairs, in row chunks so the rows x intervals compare stays small."""
    los, his = intervals.los, intervals.his
    k = keys.to(torch.int64)
    step = max(1, (1 << 24) // max(1, los.shape[0]))
    shared = torch.cat([((c[:, None] >= los[None, :]) & (c[:, None] <= his[None, :])).any(dim=1)
                        for c in k.split(step)]) if k.shape[0] else torch.zeros_like(mask)
    keep = mask & (shared | pred)
    return keep, keep.sum()


def clustered_keep(keys: torch.Tensor, mask: torch.Tensor, pred: torch.Tensor,
                   intervals: KeepIntervals):
    """Early-HAVING keep mask of a clustered partial aggregate: live rows
    whose key lies in an overlap interval or that pass the HAVING
    predicate.  Returns (keep, live count as a 0-d int64 on the device)."""
    if _is_cpu(mask):
        return clustered_keep_plain(keys, mask, pred, intervals)
    starts, ends = intervals.starts, intervals.ends
    _require_cuda(keys, mask, pred, starts, ends)
    k, m, p = _flat(keys), _flat(mask), _flat(pred)
    n = m.shape[0]
    if p.shape[0] != n:
        raise ValueError("keys, mask and predicate must have one length")
    keep = torch.empty(n, dtype=torch.bool, device=m.device)
    live = torch.empty(1, dtype=torch.int64, device=m.device)
    stream = _stream(m.device)
    lib = _cuda.LIBRARIES.get("clustered")
    _cuda.check(lib.ab_clustered_keep(_ptr(k), _key_kind(keys, mask), _ptr(m), _ptr(p), n,
                                      _ptr(starts), _ptr(ends), starts.shape[0],
                                      _ptr(_flat(keep)), _ptr(live),
                                      _ptr(_accumulator(m.device, stream)), stream),
                "clustered_keep")
    count_launch("clustered_keep")
    return keep, live[0]


# --------------------------------------------------------------------------
# top-k (sort + limit)
# --------------------------------------------------------------------------


def topk_order(keys, mask, k: int) -> torch.Tensor:
    """First k positions of the sort order (K4), as the reference
    computes it.  The JAX package defines it and never calls it; SortExec
    slices its own order."""
    return sort_order(keys, mask)[:k]


# --------------------------------------------------------------------------
# K5-K7: joins (sorted build + binary-search probe + pair expansion)
# --------------------------------------------------------------------------

# int64 with only the sign bit set: x ^ _SIGN maps unsigned order of the
# 64-bit hash bits onto signed int64 order (torch on the CPU cannot sort or
# search uint64)
_SIGN = -(1 << 63)


def build_side_sort_plain(build_keys, build_mask):
    """Plain twin of K5: hash, dead rows to 0xFFFF...FFFF, stable sort of
    the sign-flipped hashes."""
    h = hash64_plain(build_keys)
    h = torch.where(build_mask, h, torch.full((), -1, dtype=torch.int64, device=h.device))
    order = torch.sort(h ^ _SIGN, stable=True).indices
    return h[order], order.to(torch.int32), build_mask.sum()


def build_side_sort(build_keys: List[torch.Tensor], build_mask: torch.Tensor):
    """Sort the build side by its 64-bit key hash (int64 bits; dead rows
    carry 0xFFFF...FFFF and sort last).  Returns (hash_sorted, order:
    int32 stable permutation, live row count)."""
    if _is_cpu(build_mask):
        return build_side_sort_plain(build_keys, build_mask)
    _require_cuda(build_mask, *build_keys)
    cols, ptrs, kinds = _hash_columns(build_keys)
    m = _flat(build_mask)
    n = m.shape[0]
    if n == 0:
        raise ValueError("build_side_sort over an empty batch")
    dev = m.device
    hash_out = torch.empty(n, dtype=torch.int64, device=dev)
    order = torch.empty(n, dtype=torch.int32, device=dev)
    n_live = torch.empty(1, dtype=torch.int64, device=dev)
    lib = _cuda.LIBRARIES.get("join_build")
    scratch = torch.empty(lib.ab_build_scratch_bytes(n), dtype=torch.uint8, device=dev)
    err = lib.ab_build_side_sort(ptrs, kinds, len(cols), _ptr(m), n,
                                 int(force_hash_collisions()), _ptr(hash_out), _ptr(order),
                                 _ptr(n_live), _ptr(scratch), _stream(dev))
    _cuda.check(err, "build_side_sort")
    count_launch("build_side_sort")
    if lib.ab_build_is_block(n):
        _PLANS.build_side_sort = {"form": "single_block", "rows": n, "bits": 64, "passes": 0,
                                  "steps": _bitonic_steps(n), "launches": 1}
    else:
        passes = 64 // _RADIX_DIGIT_BITS
        _PLANS.build_side_sort = {"form": "onesweep", "rows": n, "bits": 64, "passes": passes,
                                  "launches": 2 + passes}
    return hash_out, order, n_live[0]


def _probe_bounds_plain(probe_hash, probe_mask, build_hash_sorted):
    """The reference's count arithmetic: (lo, count, inclusive offsets,
    total), lo and count as int64."""
    b = build_hash_sorted ^ _SIGN
    p = probe_hash ^ _SIGN
    lo = torch.searchsorted(b, p, side="left")
    hi = torch.searchsorted(b, p, side="right")
    count = torch.where(probe_mask, hi - lo, 0)
    offsets = torch.cumsum(count, 0)
    return lo, count, offsets, offsets[-1]


def probe_counts_plain(probe_hash, probe_mask, build_hash_sorted, offsets: bool = False):
    """Plain twin of K6's count pass: (inclusive offsets (int64) with
    ``offsets``, else None; total)."""
    _, _, incl, total = _probe_bounds_plain(probe_hash, probe_mask, build_hash_sorted)
    return (incl if offsets else None), total


# csrc/probe.cu's modes: the total alone, with the inclusive offsets, or
# the pair slots
_PROBE_TOTAL, _PROBE_OFFSETS, _PROBE_EXPAND = 0, 1, 2


def _probe_launch(probe_hash, probe_mask, build_hash_sorted, mode: int, cap: int = 0):
    """K6's fused kernel (and, for pair slots, its fill): (out, offsets,
    (probe_idx, build_pos, pair_valid)); out[0] is the total."""
    _require_cuda(probe_hash, probe_mask, build_hash_sorted)
    if probe_hash.dtype != torch.int64 or build_hash_sorted.dtype != torch.int64:
        raise TypeError("probe and build hashes travel as int64 bits")
    if probe_mask.dtype != torch.bool or probe_mask.shape != probe_hash.shape:
        raise ValueError("the probe mask must be bool, one flag a probe row")
    ph, pm, bh = _flat(probe_hash), _flat(probe_mask), _flat(build_hash_sorted)
    n, nb = ph.shape[0], bh.shape[0]
    if n == 0:
        raise ValueError("probe over an empty batch")
    if mode == _PROBE_EXPAND and nb == 0:
        raise ValueError("probe against an empty build side")
    dev = ph.device
    out = torch.empty(3, dtype=torch.int64, device=dev)
    offsets = torch.empty(n, dtype=torch.int64, device=dev) if mode == _PROBE_OFFSETS else None
    pairs = (None, None, None)
    if mode == _PROBE_EXPAND:  # every slot is written
        pairs = (torch.empty(cap, dtype=torch.int32, device=dev),
                 torch.empty(cap, dtype=torch.int32, device=dev),
                 torch.empty(cap, dtype=torch.bool, device=dev))
    lib = _cuda.LIBRARIES.get("probe")
    stream = _stream(dev)
    state = _stream_words(_PROBE_STATES, dev, stream, lib.ab_probe_state_words(n))
    ptrs = [None if t is None else _ptr(_flat(t)) for t in (offsets, *pairs)]
    _cuda.check(lib.ab_probe_join(_ptr(ph), _ptr(pm), n, _ptr(bh), nb, mode, cap, *ptrs,
                                  _ptr(out), _ptr(state), stream), "probe_join")
    count_launch("probe_join")
    _PLANS.probe_join = {"mode": ("total", "offsets", "pairs")[mode], "rows": n,
                         "launches": 2 if mode == _PROBE_EXPAND and cap > 0 else 1}
    return out, offsets, pairs


def probe_counts(probe_hash, probe_mask, build_hash_sorted, offsets: bool = False):
    """Candidate pairs of the probe rows against the sorted build hashes:
    (inclusive offsets (int64) with ``offsets``, else None; total as a 0-d
    int64 tensor).  JoinExec's count pass reads the total; its windowed
    count pass the per-window counts from the offsets at window edges.
    One launch."""
    if _is_cpu(probe_hash):
        return probe_counts_plain(probe_hash, probe_mask, build_hash_sorted, offsets)
    out, incl, _ = _probe_launch(probe_hash, probe_mask, build_hash_sorted,
                                 _PROBE_OFFSETS if offsets else _PROBE_TOTAL)
    return incl, out[0]


def probe_join_plain(probe_hash, probe_mask, build_hash_sorted, out_capacity: int):
    """Plain twin of K6 (the reference's formulation): pair slot j belongs
    to the first probe row whose inclusive offset exceeds j."""
    lo, count, offsets, total = _probe_bounds_plain(probe_hash, probe_mask, build_hash_sorted)
    starts = offsets - count
    j = torch.arange(out_capacity, device=probe_hash.device)
    probe_idx = torch.clamp(torch.searchsorted(offsets, j, side="right"), 0,
                            probe_hash.shape[0] - 1)
    k = j - starts[probe_idx]
    build_pos = lo[probe_idx] + k
    pair_valid = (j < total) & (k >= 0) & (k < count[probe_idx])
    build_pos = torch.clamp(build_pos, 0, build_hash_sorted.shape[0] - 1)
    return probe_idx.to(torch.int32), build_pos.to(torch.int32), pair_valid, total


def probe_join(probe_hash: torch.Tensor, probe_mask: torch.Tensor,
               build_hash_sorted: torch.Tensor, out_capacity: int):
    """Match probe rows against the sorted build hashes.

    Returns (probe_idx: int32, build_pos: int32 position in the *sorted*
    build, pair_valid, total pairs).  Slots at or past the total are
    invalid.  Callers MUST verify real key equality afterwards (hash
    collisions).  At most two launches (csrc/probe.cu)."""
    if _is_cpu(probe_hash):
        return probe_join_plain(probe_hash, probe_mask, build_hash_sorted, out_capacity)
    out, _, (probe_idx, build_pos, pair_valid) = _probe_launch(
        probe_hash, probe_mask, build_hash_sorted, _PROBE_EXPAND, int(out_capacity))
    return probe_idx, build_pos, pair_valid, out[0]


def segment_any_plain(values, seg_ids, num_segments: int, within=None,
                      negate: bool = False) -> torch.Tensor:
    """Plain twin of K7: segment_max(values as int32) > 0, out-of-range
    ids dropped; then ``hit ^ negate``, ANDed with ``within`` when given."""
    v = values.to(torch.int32)
    seg = seg_ids.long()
    ok = (seg >= 0) & (seg < num_segments)
    idx = torch.where(ok, seg, num_segments)
    best = torch.full((num_segments + 1,), torch.iinfo(torch.int32).min, dtype=torch.int32,
                      device=v.device).scatter_reduce_(0, idx, v, "amax", include_self=True)
    hit = best[:num_segments] > 0
    if negate:
        hit = ~hit
    return hit if within is None else within & hit


def segment_any(values: torch.Tensor, seg_ids: torch.Tensor, num_segments: int, within=None,
                negate: bool = False) -> torch.Tensor:
    """Per-segment logical OR of ``values`` (bool, or int32 > 0) by int32
    ``seg_ids``, ids outside [0, num_segments) dropped: the semi, anti,
    left and full join verdicts.  With ``within`` (a bool mask of
    num_segments) the result is ``within & hit``, or ``within & ~hit`` with
    ``negate``; so a join's verdict and its mask are one launch, with no
    clearing pass or mask kernel (csrc/segment.cu: two launches over a
    per-stream byte a segment, zero between calls)."""
    if _is_cpu(values):
        return segment_any_plain(values, seg_ids, num_segments, within, negate)
    _require_cuda(values, seg_ids, *([within] if within is not None else []))
    if values.dtype not in (torch.bool, torch.int32) or seg_ids.dtype != torch.int32:
        raise TypeError(f"segment_any takes bool or int32 values and int32 ids, got "
                        f"{values.dtype}, {seg_ids.dtype}")
    ns = int(num_segments)
    if ns < 1:
        raise ValueError(f"segment_any needs at least one segment, got {ns}")
    v, sg = _flat(values), _flat(seg_ids)
    if sg.shape[0] != v.shape[0]:
        raise ValueError("values and segment ids must have one length")
    w = None
    if within is not None:
        if within.dtype != torch.bool or within.numel() != ns:
            raise ValueError("within must be a bool mask of num_segments")
        w = _flat(within)
    dev = v.device
    # rounded up to 16 bytes: the kernel stores 16-byte words
    out = torch.empty((ns + 15) // 16 * 16, dtype=torch.bool, device=dev)
    lib = _cuda.LIBRARIES.get("segment")
    stream = _stream(dev)
    # the stream's hit bytes are marked by one launch and read back to zero
    # by the next: no other call may queue its launches between them
    with _SEG_ANY_LOCK:
        state = _stream_words(_SEG_ANY_STATES, dev, stream, lib.ab_segment_state_words(ns))
        _cuda.check(lib.ab_segment_any(_ptr(v), _KIND[values.dtype], _ptr(sg), v.shape[0], ns,
                                       None if w is None else _ptr(w), int(bool(negate)),
                                       _ptr(_flat(out)), _ptr(state), stream), "segment_any")
    count_launch("segment_any")
    _PLANS.segment_any = {"rows": v.shape[0], "segments": ns,
                          "launches": 2 if v.shape[0] else 1}
    return out[:ns]


# --------------------------------------------------------------------------
# K14: EXTRACT (civil from days)
# --------------------------------------------------------------------------

EXTRACT_FIELDS = {"year": 0, "month": 1, "day": 2}  # csrc/civil.cuh AB_EXTRACT_*


def _field_code(field: str) -> int:
    code = EXTRACT_FIELDS.get(field)
    if code is None:
        raise ValueError(f"unsupported EXTRACT field {field}")
    return code


def civil_from_days_plain(days: torch.Tensor):
    """Epoch days -> (year, month, day) as int32, Howard Hinnant's integer
    algorithm as the reference writes it; the era floors (a NULL date, the
    int32 minimum, has a negative z)."""
    z = days.to(torch.int64) + 719468
    era = torch.div(z, 146097, rounding_mode="floor")
    doe = z - era * 146097
    yoe = torch.div(doe - torch.div(doe, 1460, rounding_mode="floor")
                    + torch.div(doe, 36524, rounding_mode="floor")
                    - torch.div(doe, 146096, rounding_mode="floor"), 365, rounding_mode="floor")
    y = yoe + era * 400
    doy = doe - (365 * yoe + torch.div(yoe, 4, rounding_mode="floor")
                 - torch.div(yoe, 100, rounding_mode="floor"))
    mp = torch.div(5 * doy + 2, 153, rounding_mode="floor")
    d = doy - torch.div(153 * mp + 2, 5, rounding_mode="floor") + 1
    m = mp + torch.where(mp < 10, 3, -9)
    y = y + (m <= 2).to(torch.int64)
    return y.to(torch.int32), m.to(torch.int32), d.to(torch.int32)


def extract_field_plain(days: torch.Tensor, field: str) -> torch.Tensor:
    """Plain twin of K14."""
    return civil_from_days_plain(days)[_field_code(field)]


def extract_field(days: torch.Tensor, field: str) -> torch.Tensor:
    """EXTRACT(field FROM date32 days) -> int32, same shape."""
    if _is_cpu(days):
        return extract_field_plain(days, field)
    code = _field_code(field)
    _require_cuda(days)
    if days.dtype != torch.int32:
        raise TypeError(f"extract_field takes int32 epoch days, got {days.dtype}")
    d = days.reshape(-1).contiguous()
    out = torch.empty(d.shape[0], dtype=torch.int32, device=d.device)
    if d.shape[0] == 0:
        return out.reshape(days.shape)
    lib = _cuda.LIBRARIES.get("extract")
    _cuda.check(lib.ab_extract_field(_ptr(d), d.shape[0], code, _ptr(out), _stream(d.device)),
                "extract_field")
    count_launch("extract_field")
    return out.reshape(days.shape)


# --------------------------------------------------------------------------
# K17: the mesh exchange's send buffers
# --------------------------------------------------------------------------

DISPATCH_MAX_DEST = 64  # csrc/dispatch.cu AB_DISPATCH_MAX_DEST
_DISPATCH_MAX_COLS = 32


def dispatch_to_buckets_plain(cols: Dict[str, torch.Tensor], dest: torch.Tensor,
                              mask: torch.Tensor, num_dest: int, capacity: int):
    """Plain twin of K17, the reference's formulation: one cumsum per
    destination ranks the rows, one scatter per column.  Returns
    (send_cols of [num_dest, capacity], send_mask, overflow, counts)."""
    dev = mask.device
    dkey = torch.where(mask, dest.to(torch.int32), num_dest)
    rank = torch.zeros(mask.shape, dtype=torch.int64, device=dev)
    counts = []
    for b in range(num_dest):
        is_b = dkey == b
        within = torch.cumsum(is_b.to(torch.int64), 0)
        rank = torch.where(is_b, within - 1, rank)
        counts.append(within[-1] if within.numel() else torch.zeros((), dtype=torch.int64,
                                                                      device=dev))
    counts = torch.stack(counts).to(torch.int32)
    slot_ok = (dkey >= 0) & (dkey < num_dest) & (rank < capacity)
    size = num_dest * capacity
    flat = torch.where(slot_ok, dkey.to(torch.int64) * capacity + rank, size)
    send_cols = {}
    for name, col in cols.items():
        buf = torch.zeros(size + 1, dtype=col.dtype, device=dev)
        buf[flat] = col  # only the dump slot sees more than one row
        send_cols[name] = buf[:-1].reshape(num_dest, capacity)
    mbuf = torch.zeros(size + 1, dtype=torch.bool, device=dev)
    mbuf[flat] = slot_ok
    overflow = (counts > capacity).any()
    return send_cols, mbuf[:-1].reshape(num_dest, capacity), overflow, counts


class _DispatchCols(ctypes.Structure):
    """csrc/dispatch.cu ``DispatchCols`` (AB_DISPATCH_MAX_COLS 32)."""

    _fields_ = [("in8", ctypes.c_void_p * 32), ("out8", ctypes.c_void_p * 32),
                ("n8", ctypes.c_int),
                ("in4", ctypes.c_void_p * 32), ("out4", ctypes.c_void_p * 32),
                ("n4", ctypes.c_int),
                ("in1", ctypes.c_void_p * 32), ("out1", ctypes.c_void_p * 32),
                ("n1", ctypes.c_int)]


def _dispatch_groups(cols: Dict[str, torch.Tensor]) -> List[List[str]]:
    """The columns of a dispatch split into scatter launches of at most
    ``_DISPATCH_MAX_COLS`` columns of each element width, in column order;
    always at least one launch (the mask needs one)."""
    groups: List[List[str]] = [[]]
    seen: Dict[int, int] = {}
    for name, col in cols.items():
        w = col.dtype.itemsize
        g = seen.get(w, 0) // _DISPATCH_MAX_COLS
        seen[w] = seen.get(w, 0) + 1
        while len(groups) <= g:
            groups.append([])
        groups[g].append(name)
    return groups


def dispatch_to_buckets(cols: Dict[str, torch.Tensor], dest: torch.Tensor,
                        mask: torch.Tensor, num_dest: int, capacity: int):
    """Scatter the live rows into a ``[num_dest, capacity]`` send buffer per
    column: a row's slot is its bucket ``dest`` times ``capacity`` plus its
    rank among the earlier rows of that bucket; rows ranked past
    ``capacity`` are dropped and flag ``overflow``.  Returns (send_cols,
    send_mask, overflow: 0-d bool, counts: int32[num_dest]).

    Two launches: the count (each tile's rows a bucket, scanned into each
    tile's first rank, the counts and the flag) and the scatter (each tile
    sorted by bucket on chip and written as contiguous runs, the empty
    slots zeroed by the same launch).  The scatter takes up to
    ``_DISPATCH_MAX_COLS`` columns of each width; more go through further
    scatter launches over the same count, each counted as a launch of the
    wrapper.  The tile ranks live in the call's own scratch, so another
    call's launches may fall between the two on a stream."""
    if _is_cpu(mask):
        return dispatch_to_buckets_plain(cols, dest, mask, num_dest, capacity)
    _require_cuda(mask, dest, *cols.values())
    if dest.dtype != torch.int32 or mask.dtype != torch.bool:
        raise TypeError(f"dispatch takes int32 destinations and a bool mask, got {dest.dtype}, "
                        f"{mask.dtype}")
    if not 1 <= num_dest <= DISPATCH_MAX_DEST or capacity < 1:
        raise ValueError(f"dispatch takes 1-{DISPATCH_MAX_DEST} destinations and a positive "
                         f"capacity, got {num_dest}, {capacity}")
    m, d = _flat(mask), _flat(dest)
    n = m.shape[0]
    dev = m.device
    size = int(num_dest) * int(capacity)
    flat_cols = {}  # contiguous inputs whose pointers the launches read
    send_cols = {}
    for name, col in cols.items():
        if col.dtype not in (torch.int64, torch.float64, torch.int32, torch.float32, torch.bool):
            raise TypeError(f"dispatch column {name}: no kernel for {col.dtype}")
        if col.shape != mask.shape:
            raise ValueError(f"dispatch column {name}: shape {tuple(col.shape)}, mask "
                             f"{tuple(mask.shape)}")
        flat_cols[name] = _flat(col)
        send_cols[name] = torch.empty(size, dtype=col.dtype, device=dev).view(num_dest,
                                                                              capacity)
    send_mask = torch.empty(size, dtype=torch.bool, device=dev)
    counts = torch.empty(num_dest, dtype=torch.int32, device=dev)
    overflow = torch.empty(1, dtype=torch.bool, device=dev)
    lib = _cuda.LIBRARIES.get("dispatch")
    scratch = torch.empty(max(1, lib.ab_dispatch_scratch_ints(n, num_dest)), dtype=torch.int32,
                          device=dev)
    stream = _stream(dev)
    _cuda.check(lib.ab_dispatch_count(_ptr(d), _ptr(m), n, int(num_dest), int(capacity),
                                      _ptr(counts), _ptr(_flat(overflow)), _ptr(scratch),
                                      _ptr(_accumulator(dev, stream)), stream),
                "dispatch_to_buckets")
    widths = {8: ("in8", "out8", "n8"), 4: ("in4", "out4", "n4"), 1: ("in1", "out1", "n1")}
    groups = _dispatch_groups(flat_cols)
    for g, group in enumerate(groups):
        spec = _DispatchCols()
        for name in group:
            fin, fout, fn = widths[flat_cols[name].dtype.itemsize]
            k = getattr(spec, fn)
            getattr(spec, fin)[k] = flat_cols[name].data_ptr()
            getattr(spec, fout)[k] = send_cols[name].data_ptr()
            setattr(spec, fn, k + 1)
        out_mask = _ptr(_flat(send_mask)) if g == 0 else None  # the first group writes it
        err = lib.ab_dispatch_scatter(_ptr(d), _ptr(m), n, int(num_dest), int(capacity),
                                      ctypes.byref(spec), out_mask, _ptr(counts), _ptr(scratch),
                                      stream)
        _cuda.check(err, "dispatch_to_buckets")
        count_launch("dispatch_to_buckets")
    _PLANS.dispatch_to_buckets = {"rows": n, "count_launches": 1,
                                  "scatter_launches": len(groups), "launches": 1 + len(groups)}
    return send_cols, send_mask.view(num_dest, capacity), overflow[0], counts


# --------------------------------------------------------------------------
# K18: the mesh ranks' slot-aligned states, merged
# --------------------------------------------------------------------------

MERGE_MAX_RANKS = 64  # csrc/rank_merge.cu AB_MERGE_MAX_RANKS
# how -> csrc/rank_merge.cu AB_HOW_* ("or" merges bool arrays; "exists" is
# the wrapped integer sum written as the bool sum > 0)
MERGE_EXISTS = "exists"
_MERGE_HOW = {AGG_SUM: 0, AGG_COUNT: 0, AGG_MIN: 2, AGG_MAX: 3, "or": 3, MERGE_EXISTS: 5}
# (dtype, how) -> (kind, how code, merged dtype), for every merge K18 takes
_MERGE_CODES = {
    **{(dt, how): (_KIND[dt], code, dt) for dt in (torch.int32, torch.int64, torch.float32,
                                                   torch.float64)
       for how, code in _MERGE_HOW.items() if how != MERGE_EXISTS},
    **{(dt, MERGE_EXISTS): (_KIND[dt], _MERGE_HOW[MERGE_EXISTS], torch.bool)
       for dt in (torch.int32, torch.int64)},
    **{(torch.bool, how): (_KIND[torch.bool], _MERGE_HOW[how], torch.bool)
       for how in (AGG_MAX, "or")},
}


MERGE_MAX_COLS, MERGE_MAX_PTRS = 16, 64  # csrc/rank_merge.cu AB_MERGE_MAX_COLS / _PTRS


class _MergeSpec(ctypes.Structure):
    """csrc/rank_merge.cu ``MergeSpec``: one launch's column table."""
    _fields_ = [("start", ctypes.c_longlong * (MERGE_MAX_COLS + 1)),
                ("out", ctypes.c_void_p * MERGE_MAX_COLS),
                ("src", ctypes.c_void_p * MERGE_MAX_PTRS),
                ("n_cols", ctypes.c_int), ("n_ranks", ctypes.c_int),
                ("kind", ctypes.c_ubyte * MERGE_MAX_COLS),
                ("how", ctypes.c_ubyte * MERGE_MAX_COLS)]


_MERGE_CHECKED = None  # the rank_merge library whose struct was checked


def _merge_lib():
    global _MERGE_CHECKED
    lib = _cuda.LIBRARIES.get("rank_merge")
    if lib is not _MERGE_CHECKED:
        if lib.ab_merge_spec_bytes() != ctypes.sizeof(_MergeSpec):
            raise RuntimeError("csrc/rank_merge.cu MergeSpec and ops/kernels.py _MergeSpec "
                               "differ")
        _MERGE_CHECKED = lib
    return lib


def merge_rank_states_plain(xs: Sequence[torch.Tensor], how: str) -> torch.Tensor:
    """Plain twin of K18's one column: ``torch.stack(xs)`` summed, or its
    min or max (a bool array merges by OR), over the ranks; ``exists`` is
    the sum compared with 0."""
    s = torch.stack(list(xs))
    if s.dtype == torch.bool:
        return s.any(0)
    if how in (AGG_SUM, AGG_COUNT, MERGE_EXISTS):
        total = s.sum(0, dtype=s.dtype)
        return total > 0 if how == MERGE_EXISTS else total
    return s.amin(0) if how == AGG_MIN else s.amax(0)


def merge_rank_columns_plain(columns) -> List[torch.Tensor]:
    """Plain twin of K18: each (rank arrays, how) column merged by
    ``merge_rank_states_plain``."""
    return [merge_rank_states_plain(xs, how) for xs, how in columns]


def merge_rank_columns(columns) -> List[torch.Tensor]:
    """K18: every column of a dense merge over the ranks in one launch.
    ``columns`` is [(xs, how)]: xs the ranks' arrays of one dtype and
    shape, in rank order, on one device (the same ranks in every column);
    how sum or count (integer sums wrap), min or max (float NaN
    propagates), "or" (bool arrays; max too) or ``MERGE_EXISTS`` (an
    integer sum, written as the bool ``sum > 0``).  Returns the merged
    arrays, one a column.  One launch takes up to ``MERGE_MAX_COLS``
    columns and ``MERGE_MAX_PTRS`` rank arrays (csrc/rank_merge.cu's
    parameter struct); a wider merge takes one launch a group of whole
    columns."""
    if not columns:
        return []
    if _is_cpu(columns[0][0][0]):
        return merge_rank_columns_plain(columns)
    n = len(columns[0][0])
    if not 1 <= n <= MERGE_MAX_RANKS:
        raise ValueError(f"a rank merge takes 1-{MERGE_MAX_RANKS} ranks, got {n}")
    dev = columns[0][0][0].device
    if dev.type != "cuda":
        raise ValueError(f"kernel inputs must share one CUDA device, got {dev}")
    outs, srcs, kinds, hows, starts = [], [], [], [], [0]
    keep = []  # contiguous copies of strided inputs, held until the launches are queued
    for xs, how in columns:
        x0 = xs[0]
        dt, shape = x0.dtype, x0.shape
        if len(xs) != n:
            raise ValueError(f"every column of a rank merge takes {n} ranks, got {len(xs)}")
        for x in xs:
            if x.dtype != dt or x.shape != shape:
                raise TypeError("rank states must share one dtype and shape")
            if x.device != dev:
                raise ValueError(f"kernel inputs must share one CUDA device, got {x.device}")
            if not x.is_contiguous():
                x = x.contiguous()
                keep.append(x)
            srcs.append(x.data_ptr())
        code = _MERGE_CODES.get((dt, how))
        if code is None:
            raise ValueError(f"no rank merge {how!r} over {dt}")
        kinds.append(code[0])
        hows.append(code[1])
        outs.append(torch.empty(shape, dtype=code[2], device=dev))
        starts.append(starts[-1] + x0.numel())
    if starts[-1] == 0:
        return outs
    lib = _merge_lib()
    per_launch = min(MERGE_MAX_COLS, MERGE_MAX_PTRS // n)
    stream = _stream(dev)
    launches = 0
    for c0 in range(0, len(columns), per_launch):
        c1 = min(len(columns), c0 + per_launch)
        k = c1 - c0
        spec = _MergeSpec()
        spec.n_cols, spec.n_ranks = k, n
        spec.start[:k + 1] = [s - starts[c0] for s in starts[c0:c1 + 1]]
        spec.out[:k] = [o.data_ptr() for o in outs[c0:c1]]
        spec.src[:k * n] = srcs[c0 * n:c1 * n]
        spec.kind[:k] = kinds[c0:c1]
        spec.how[:k] = hows[c0:c1]
        _cuda.check(lib.ab_merge_columns(ctypes.byref(spec), stream), "merge_rank_columns")
        count_launch("merge_rank_states")
        launches += 1
    _PLANS.merge_rank_columns = {"columns": len(columns), "ranks": n, "slots": starts[-1],
                                 "launches": launches}
    return outs


def merge_rank_states(xs: Sequence[torch.Tensor], how: str) -> torch.Tensor:
    """Element-wise sum (``how`` sum or count), min or max of the ranks'
    slot-aligned arrays, which lie on one device; bool arrays merge by OR.
    Integer sums wrap.  K18's one-column case."""
    return merge_rank_columns([(list(xs), how)])[0]
