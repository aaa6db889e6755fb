"""Whole-stage compiler of the port.

At stage-plan resolution the scheduler finds the maximal single-child
chains of fusable operators (``chains.py``) and replaces each allowlisted
run with one :class:`~arrow_ballista_tpu_torch.compile.fused.FusedStageExec`
(``fuse.py``), whose body is one kernel generated for the chain:
``codegen.py`` traces the operators' own expression closures into CUDA C++
(K12 ``fused_rows``, K13 ``fused_agg``), built by ``ops/_cuda.py``.
"""
from .chains import UNFUSABLE, plan_chains  # noqa: F401
from .fuse import CompilePolicy, fuse_resolved_stages, fuse_stage  # noqa: F401
from .fused import FusedStageExec  # noqa: F401
