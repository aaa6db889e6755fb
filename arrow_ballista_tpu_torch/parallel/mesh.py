"""The rank mesh the mesh exchange rides on.

Mirrors arrow_ballista_tpu/parallel/mesh.py.  The reference's mesh is one
process over N local JAX devices (``jax.sharding.Mesh``); here a mesh is
an ordered list of torch devices, one entry per rank, in one process.
Repeats are allowed: a four-rank mesh over ``cuda:0`` runs four ranks on
one card, so the exchange really moves rows between ranks there (it then
measures the exchange's overhead, not a speed-up across cards).  The
default mesh is every card ``torch.cuda.device_count()`` reports; a
caller without a card passes CPU devices.

``use_local_devices`` is the one process-wide seam that sets what the
operators see in place of that default: the counterpart of the tests'
``--xla_force_host_platform_device_count=8``.  No config key or
environment variable reads it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import List, Optional, Sequence, Tuple

import torch

# the reference's mesh axis name; the port's mesh is a plain list of ranks
PART_AXIS = "part"

# process-wide serialization of mesh programs: a stage's tasks share one
# runner (MeshTaskJoinExec), and every rank's kernels already run on the
# mesh's devices, so running two mesh programs at once buys nothing
MESH_DISPATCH_LOCK = threading.Lock()

_local_devices: Optional[Tuple[torch.device, ...]] = None
_local_lock = threading.Lock()


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: the ranks' devices, in rank order."""

    devices: Tuple[torch.device, ...]


def local_devices() -> List[torch.device]:
    """What ``jax.devices()`` is to the reference: the devices set by
    ``use_local_devices``, else every card."""
    with _local_lock:
        if _local_devices is not None:
            return list(_local_devices)
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


@contextlib.contextmanager
def use_local_devices(devices: Sequence):
    """Within the block, meshes default to ``devices`` (one per rank;
    repeats allowed), e.g. ``[torch.device("cpu")] * 8`` for eight ranks on
    the CPU or ``[torch.device("cuda", 0)] * 4`` for four on one card."""
    global _local_devices
    devs = tuple(torch.device(d) for d in devices)
    if not devs:
        raise ValueError("a mesh needs at least one device")
    with _local_lock:
        before = _local_devices
        _local_devices = devs
    try:
        yield list(devs)
    finally:
        with _local_lock:
            _local_devices = before


def make_mesh(n_devices: Optional[int] = None, devices: Optional[Sequence] = None) -> Mesh:
    """A 1-D mesh over the first ``n_devices`` local devices."""
    if devices is None:
        devices = local_devices()
    devices = [torch.device(d) for d in devices]
    if n_devices is not None:
        if len(devices) < n_devices:
            raise ValueError(f"requested {n_devices} devices, only {len(devices)} available")
        devices = devices[:n_devices]
    if not devices:
        raise RuntimeError("no CUDA device is available for the mesh; a caller without a "
                           "card passes CPU devices (parallel.mesh.use_local_devices)")
    return Mesh(tuple(devices))


def mesh_axis_size(mesh: Mesh) -> int:
    """The rank count (the reference's size of its one mesh axis)."""
    return len(mesh.devices)


def shard_rows(tensor: torch.Tensor, mesh: Mesh, fill=0) -> List[torch.Tensor]:
    """Rows (axis 0) split over the ranks, padded with ``fill`` to a
    multiple of the rank count: one contiguous slice per rank, on its
    rank's device (a view where the device is the tensor's own).  The
    reference's ``row_sharding`` placement."""
    n = mesh_axis_size(mesh)
    rows = tensor.shape[0]
    per = -(-rows // n)
    padded = per * n
    if padded != rows:
        tensor = torch.cat([tensor, torch.full((padded - rows,), fill, dtype=tensor.dtype,
                                               device=tensor.device)])
    return [tensor[r * per:(r + 1) * per].to(dev) for r, dev in enumerate(mesh.devices)]
