"""diffopt_tpu_torch — the PyTorch / CUDA port of ``diffopt_tpu``.

Same layout and names as the JAX package so a reader finds the counterpart
of every module; batch-first (every function takes ``(B, ...)`` tensors and
calls the batched kernel directly — there is no ``vmap`` and no dispatch
layer). The kernels are hand-written CUDA C++ for Hopper (``csrc/``), built
at first use; on CPU tensors each wrapper runs the plain PyTorch version that
sits beside it.

Ported so far: the batched QP main path — ``solve_qp_batched`` (fused PDIP
forward, active-set polish, KKT metrics, LDL' adjoint VJP).
"""

from .ir import QPSolution, QPTangent, QuadProgram
from .solve import solve_qp_batched
from .solvers.qp import QPSolveInfo, kkt_metrics
from .utils.config import DiffOptConfig, get_config, set_config, use_config
from . import convert, utils

__version__ = "0.1.0"

__all__ = [
    "QuadProgram",
    "QPSolution",
    "QPTangent",
    "QPSolveInfo",
    "solve_qp_batched",
    "kkt_metrics",
    "DiffOptConfig",
    "get_config",
    "set_config",
    "use_config",
    "convert",
    "utils",
]
