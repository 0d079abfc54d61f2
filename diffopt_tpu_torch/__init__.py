"""diffopt_tpu_torch — the PyTorch / CUDA port of ``diffopt_tpu``.

Same layout and names as the JAX package so a reader finds the counterpart
of every module; batch-first (every function takes ``(B, ...)`` tensors and
calls the batched kernel directly — there is no ``vmap`` and no dispatch
layer). The kernels are hand-written CUDA C++ for Hopper (``csrc/``), built
at first use; on CPU tensors each wrapper runs the plain PyTorch version that
sits beside it.

Ported so far: everything the JAX package does with a ``QuadProgram`` — the
batched main path ``solve_qp_batched`` (fused PDIP forward, active-set polish,
KKT metrics, LDL' adjoint VJP); the staged path ``solve_qp`` (Mehrotra solver
on the batched Cholesky kernels, reverse and forward rules, the
``auto``/``lstsq``/``qr`` KKT routes for LPs); the differentiation verbs, the
``QPDiffContext`` session, ``ParametricProgram(kind="qp")`` and QP padding;
and the symmetric-cone path — ``solve_conic_batched`` (the fused NT-scaled
IPM kernel, ``gram`` polish and VJP), ``solve_conic`` (staged conic IPM,
reverse and forward rules), the cones and their projections, ``conic_diff``,
``ConicDiffContext``, ``ParametricProgram(kind="conic")`` and conic padding.
The exp/pow cones, the DR splitting and the NLP path come with later slices.
"""

from .ir import ConeProgram, ConeSolution, ConeTangent, QPSolution, QPTangent, QuadProgram
from .cones import ConeSpec
from .qp_diff import forward_differentiate, reverse_differentiate
from .solve import solve_conic, solve_conic_batched, solve_qp, solve_qp_batched
from .solvers.conic import ConicSolveInfo
from .solvers.qp import QPSolveInfo, kkt_metrics
from .api import ConicDiffContext, NotSolvedError, QPDiffContext
from .parameters import ParametricProgram
from .utils.config import DiffOptConfig, get_config, set_config, use_config
from . import conic_diff, convert, parameters, qp_diff, utils

__version__ = "0.1.0"

__all__ = [
    "QuadProgram",
    "QPSolution",
    "QPTangent",
    "QPSolveInfo",
    "ConeProgram",
    "ConeSolution",
    "ConeTangent",
    "ConeSpec",
    "ConicSolveInfo",
    "conic_diff",
    "solve_conic",
    "solve_conic_batched",
    "ConicDiffContext",
    "forward_differentiate",
    "reverse_differentiate",
    "solve_qp",
    "solve_qp_batched",
    "QPDiffContext",
    "NotSolvedError",
    "ParametricProgram",
    "kkt_metrics",
    "DiffOptConfig",
    "get_config",
    "set_config",
    "use_config",
    "convert",
    "parameters",
    "qp_diff",
    "utils",
]
