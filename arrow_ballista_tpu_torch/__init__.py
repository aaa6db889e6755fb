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

__version__ = "0.1.0"

from .client.context import BallistaContext, BallistaDataFrame
from .models.batch import ColumnBatch, concat_batches
from .models.schema import (BOOL, DATE32, FLOAT32, FLOAT64, INT32, INT64, STRING, DataType, Field,
                            Schema, decimal)
from .utils.config import BallistaConfig

__all__ = ["BOOL", "DATE32", "FLOAT32", "FLOAT64", "INT32", "INT64", "STRING", "BallistaConfig",
           "BallistaContext", "BallistaDataFrame", "ColumnBatch", "DataType", "Field", "Schema",
           "concat_batches", "decimal", "__version__"]
