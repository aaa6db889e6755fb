"""arrow_ballista_tpu_torch: the PyTorch/CUDA port of arrow_ballista_tpu.

The JAX package ``arrow_ballista_tpu`` is the reference; this package runs
the same engine with its columns as torch tensors on an NVIDIA H100, its
device kernels written by hand in CUDA C++ for sm_90a (``csrc/``, built at
first use by ``ops/_cuda.py``).  It imports neither JAX nor anything of the
reference package.

Quick start::

    from arrow_ballista_tpu_torch import BallistaContext
    ctx = BallistaContext.local()          # on the card; raises without one
    ctx.register_table("lineitem", table)  # a pyarrow Table
    ctx.sql("select ...").to_pandas()
"""
from __future__ import annotations

import os as _os
import sys as _sys

# pyarrow's bundled mimalloc pool crashes the remote executor (SIGSEGV in
# the IPC stream writer of a chunked shuffle fetch, in about half the runs
# of a two-executor q1; none in ten with the system allocator), as it did
# the reference's scheduler.  The system pool is set before pyarrow first
# allocates, or switched live when pyarrow came first.
_os.environ.setdefault("ARROW_DEFAULT_MEMORY_POOL", "system")
if "pyarrow" in _sys.modules:
    try:
        _sys.modules["pyarrow"].set_memory_pool(_sys.modules["pyarrow"].system_memory_pool())
    except Exception:  # noqa: BLE001 — the allocator choice is a mitigation
        pass

__version__ = "0.1.0"

from .client.context import BallistaContext, BallistaDataFrame
from .models.batch import ColumnBatch, concat_batches
from .models.schema import (BOOL, DATE32, FLOAT32, FLOAT64, INT32, INT64, STRING, DataType, Field,
                            Schema, decimal)
from .utils.config import BallistaConfig

__all__ = ["BOOL", "DATE32", "FLOAT32", "FLOAT64", "INT32", "INT64", "STRING", "BallistaConfig",
           "BallistaContext", "BallistaDataFrame", "ColumnBatch", "DataType", "Field", "Schema",
           "concat_batches", "decimal", "__version__"]
