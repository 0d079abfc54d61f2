"""Multi-process scale-out: scenario sharding, the runtime, the Schur-coupled
two-stage solver and the tensor-parallel Cholesky. Counterpart of
``diffopt_tpu/parallel``."""

from .sharding import batch_pad, make_mesh, shard_batch
from .runtime import global_mesh, hybrid_mesh, initialize_multihost, profile_trace, scenario_sharding
from . import schur, tp_chol

__all__ = [
    "make_mesh",
    "shard_batch",
    "batch_pad",
    "schur",
    "tp_chol",
    "initialize_multihost",
    "global_mesh",
    "hybrid_mesh",
    "scenario_sharding",
    "profile_trace",
]
