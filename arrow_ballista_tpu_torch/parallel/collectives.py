"""The mesh's collectives: the port's form of the ``lax`` collectives the
reference's shard_map programs call (arrow_ballista_tpu/parallel/
ici_shuffle.py:73, distributed.py:136-145 and :361-363).

The ranks live in one process (parallel/mesh.py), so moving data between
them is a copy between their tensors: ``copy_`` into a buffer on the
receiving rank's device, which is a peer copy between cards and a device
copy on one card.  It is data movement, as NCCL's would be, so no hand
kernel does it; ``BYTES`` counts what each collective copies.  The
element-wise reduction (``reduce_columns``: the reference's ``psum``,
``pmin`` and ``pmax`` of every column of a dense merge, and its
``psum(...) > 0``) gathers the ranks' arrays onto the first rank's device
and merges every column there in one K18 launch
(``kernels.merge_rank_columns``); its result is the replicated value,
held once.

Each collective takes one entry per rank, in rank order, and returns one
entry per rank (the reduction: the one tuple of merged tensors).  Inside a
rank's ``per_shard`` body (parallel/distributed.py) a collective is reached
by yielding a ``Collective``.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Sequence

import torch

from ..ops import kernels as K
from .mesh import Mesh

BYTES: Dict[str, int] = {"all_to_all": 0, "all_gather": 0, "psum": 0}
_bytes_lock = threading.Lock()


class Collective:
    """What a rank's ``per_shard`` yields at a collective: the list-form
    function and this rank's arguments.  The runner calls ``fn`` with each
    argument listed over the ranks (and the mesh) and sends each rank its
    entry of the result; a reduction's one result goes to every rank."""

    def __init__(self, fn, *args):
        self.fn = fn
        self.args = args


def _count(kind: str, nbytes: int) -> None:
    with _bytes_lock:
        BYTES[kind] += int(nbytes)


def reset_bytes() -> None:
    with _bytes_lock:
        for k in BYTES:
            BYTES[k] = 0


def all_to_all(blocks: Sequence[torch.Tensor], mesh: Mesh) -> List[torch.Tensor]:
    """``blocks[s]`` is rank s's ``[n, capacity]`` send buffer, row r bound
    for rank r.  Rank r receives ``blocks[s][r]`` from every source s, in
    source order, flattened: ``lax.all_to_all(..., split_axis=0,
    concat_axis=0, tiled=True)`` then ``reshape(-1)``."""
    n = len(blocks)
    out = []
    for r, dev in enumerate(mesh.devices):
        cap = blocks[0].shape[1]
        recv = torch.empty((n, cap), dtype=blocks[0].dtype, device=dev)
        for s in range(n):
            recv[s].copy_(blocks[s][r], non_blocking=True)
        _count("all_to_all", recv.numel() * recv.element_size())
        out.append(recv.reshape(-1))
    return out


def all_gather(parts: Sequence[torch.Tensor], mesh: Mesh) -> List[torch.Tensor]:
    """Every rank receives the concatenation of all ranks' parts, in rank
    order (``lax.all_gather(..., tiled=True)``).  Ranks on one device share
    one read-only buffer."""
    total = sum(p.shape[0] for p in parts)
    by_device: Dict[torch.device, torch.Tensor] = {}
    out = []
    for dev in mesh.devices:
        buf = by_device.get(dev)
        if buf is None:
            buf = torch.empty(total, dtype=parts[0].dtype, device=dev)
            at = 0
            for p in parts:
                buf[at:at + p.shape[0]].copy_(p, non_blocking=True)
                at += p.shape[0]
            _count("all_gather", buf.numel() * buf.element_size())
            by_device[dev] = buf
        out.append(buf)
    return out


def reduce_columns(columns: Sequence[Sequence[torch.Tensor]], hows: Sequence[Sequence[str]],
                   mesh: Mesh) -> tuple:
    """``columns[r]`` is rank r's list of slot-aligned arrays and
    ``hows[r]`` their merges (the same on every rank: sum or count, min,
    max, "or" for bool arrays, ``kernels.MERGE_EXISTS`` for the integer
    sum written as ``sum > 0``).  Returns the merged arrays, one a column,
    replicated: every column in one K18 launch."""
    dev = mesh.devices[0]
    moved = []
    for rank_cols in columns:
        row = []
        for x in rank_cols:
            if x.device != dev:
                _count("psum", x.numel() * x.element_size())
                x = x.to(dev, non_blocking=True)
            row.append(x)
        moved.append(row)
    per_column = zip(zip(*moved), hows[0])
    return tuple(K.merge_rank_columns([(list(xs), how) for xs, how in per_column]))
