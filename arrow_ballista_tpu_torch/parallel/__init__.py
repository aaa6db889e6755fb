"""Mesh-parallel execution: the mesh shuffle and distributed stage programs.

Mirrors arrow_ballista_tpu/parallel/.  The reference's mesh is one process
over N local JAX devices; the port's is one process over an ordered list
of torch devices, one per rank (``mesh.py``), whose collectives are copies
between the ranks' tensors (``collectives.py``).  ``shard_rows`` takes the
place of the reference's ``row_sharding``; a replicated value is one
tensor, so ``replicated`` has no counterpart.
"""
from .mesh import PART_AXIS, make_mesh, mesh_axis_size, shard_rows, use_local_devices
from .ici_shuffle import all_to_all_rows, dispatch_to_buckets, shuffle_rows
from .distributed import (
    distributed_broadcast_join,
    distributed_filter_aggregate,
    distributed_grouped_aggregate,
    distributed_hash_join,
)

__all__ = [
    "PART_AXIS",
    "make_mesh",
    "mesh_axis_size",
    "shard_rows",
    "use_local_devices",
    "all_to_all_rows",
    "dispatch_to_buckets",
    "shuffle_rows",
    "distributed_broadcast_join",
    "distributed_filter_aggregate",
    "distributed_grouped_aggregate",
    "distributed_hash_join",
]
