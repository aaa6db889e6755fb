"""The mesh shuffle: hash repartition as one all_to_all between ranks.

Mirrors arrow_ballista_tpu/parallel/ici_shuffle.py.  Static-shape
discipline, as in the reference:

- each rank ranks its live rows within their destination bucket and
  scatters them into a ``[n_dest, capacity]`` send buffer (K17,
  ``kernels.dispatch_to_buckets``);
- ``capacity = ceil(rows/n * factor)`` bounds skew; rows past capacity set
  an ``overflow`` flag the host checks (the host re-runs with a bigger
  capacity);
- the all_to_all swaps the leading axis, so rank d ends up with every
  source's bucket-d block; flattened, that is rows + mask again.

``shuffle_rows`` is the per-rank half a rank's ``per_shard`` body runs
(parallel/distributed.py): it dispatches, then yields the exchange to the
runner, which runs ``all_to_all_rows`` over every rank's send buffers.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

from ..ops import kernels as K
from . import collectives as C
from .collectives import Collective
from .mesh import Mesh


def dispatch_to_buckets(
    cols: Dict[str, torch.Tensor],
    dest: torch.Tensor,
    mask: torch.Tensor,
    num_dest: int,
    capacity: int,
) -> Tuple[Dict[str, torch.Tensor], torch.Tensor, torch.Tensor]:
    """Scatter one rank's rows into a ``[num_dest, capacity]`` send buffer
    per column (K17).  Returns (send_cols, send_mask, overflow)."""
    send_cols, send_mask, overflow, _counts = K.dispatch_to_buckets(
        cols, dest, mask, num_dest, capacity)
    return send_cols, send_mask, overflow


def all_to_all_rows(
    send_cols: Sequence[Dict[str, torch.Tensor]],
    send_mask: Sequence[torch.Tensor],
    mesh: Mesh,
) -> List[Tuple[Dict[str, torch.Tensor], torch.Tensor]]:
    """Swap bucket blocks across the ranks and flatten to rows: one
    ``(recv_cols, recv_mask)`` per rank, each ``[n * capacity]``, source
    blocks in rank order."""
    names = list(send_cols[0])
    recv = {name: C.all_to_all([sc[name] for sc in send_cols], mesh) for name in names}
    rmask = C.all_to_all(list(send_mask), mesh)
    return [({name: recv[name][r] for name in names}, rmask[r])
            for r in range(len(mesh.devices))]


def shuffle_rows(
    cols: Dict[str, torch.Tensor],
    dest: torch.Tensor,
    mask: torch.Tensor,
    num_partitions: int,
    capacity: int,
):
    """One rank's shuffle at a stage boundary, inside its ``per_shard``
    body (``recv_cols, recv_mask, overflow = yield from shuffle_rows(...)``):
    the rank sends row i to rank ``dest[i]`` and gets the rows it received
    (``num_partitions * capacity`` of them, masked), plus its own overflow
    flag as a shape-(1,) bool."""
    send_cols, send_mask, overflow = dispatch_to_buckets(cols, dest, mask, num_partitions,
                                                         capacity)
    recv_cols, recv_mask = yield Collective(all_to_all_rows, send_cols, send_mask)
    return recv_cols, recv_mask, overflow.reshape(1)

