"""The mesh's collectives: the port's form of the ``lax`` collectives the
reference's shard_map programs call (arrow_ballista_tpu/parallel/
ici_shuffle.py:73, distributed.py:136-145 and :361-363).

The ranks live in one process (parallel/mesh.py), so moving data between
them is a copy between their tensors: ``copy_`` into a buffer on the
receiving rank's device, which is a peer copy between cards and a device
copy on one card.  It is data movement, as NCCL's would be, so no hand
kernel does it; ``BYTES`` counts what each collective copies.  The
element-wise reductions (``psum``, ``pmin``, ``pmax``) gather the ranks'
arrays onto the first rank's device and merge them there with K18
(``kernels.merge_rank_states``); their result is the replicated value,
held once.

Each collective takes one entry per rank, in rank order, and returns one
entry per rank (the reductions: the one merged tensor).  Inside a rank's
``per_shard`` body (parallel/distributed.py) a collective is reached by
yielding a ``Collective``.
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


def _reduce(xs: Sequence[torch.Tensor], mesh: Mesh, how: str) -> torch.Tensor:
    dev = mesh.devices[0]
    moved = []
    for x in xs:
        if x.device != dev:
            _count("psum", x.numel() * x.element_size())
            x = x.to(dev, non_blocking=True)
        moved.append(x)
    return K.merge_rank_states(moved, how)


def psum(xs: Sequence[torch.Tensor], mesh: Mesh) -> torch.Tensor:
    """Slot-wise sum over the ranks (integer sums wrap); bool arrays OR."""
    return _reduce(xs, mesh, K.AGG_SUM if xs[0].dtype != torch.bool else "or")


def pmin(xs: Sequence[torch.Tensor], mesh: Mesh) -> torch.Tensor:
    return _reduce(xs, mesh, K.AGG_MIN)


def pmax(xs: Sequence[torch.Tensor], mesh: Mesh) -> torch.Tensor:
    return _reduce(xs, mesh, K.AGG_MAX)
