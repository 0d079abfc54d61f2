"""Typed configuration (own copy of the part of ``diffopt_tpu/utils/config.py``
that the ported modules read; the port imports nothing of the JAX package).

Public entry points resolve their ``None`` defaults from the active config
(:func:`get_config`), so the per-dtype tolerances live in one place. Swap the
whole config with :func:`set_config` or scoped-ly with :func:`use_config`::

    with use_config(dataclasses.replace(get_config(), nan_on_unconverged=True)):
        sol = solve_qp_batched(qp)  # unconverged instances come back as NaN

A field is added here by the module that first reads it. The fused solver
keeps its per-dtype ``tol / reg`` as constants beside its code, as the JAX
package does.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class DiffOptConfig:
    # --- QP/KKT differentiation (qp_diff / ops/kkt) -------------------------
    # read by qp_diff._resolve_method and solve.solve_qp. 'auto' routes LPs
    # (||Q|| == 0, singular KKT matrix) to the least-squares solve
    kkt_method: str = "auto"  # 'auto' | 'lu' | 'lstsq' | 'qr' | 'ldl'
    kkt_refine_iters: int = 0  # read by solve.solve_qp
    # read by ops/kkt.py::qp_kkt_solve_ldl
    ldl_lam_floor_f64: float = 1e-12
    ldl_lam_floor_f32: float = 1e-6
    ldl_reg_f64: float = 1e-11
    ldl_reg_f32: float = 1e-6

    # --- embedded QP interior-point solver ----------------------------------
    # read by solvers/qp.py::solve_batched (the staged solver)
    qp_max_iters: int = 50
    # read by solvers/qp.py::solve_batched and ::kkt_metrics (converged =
    # residuals <= 10 * tol)
    qp_tol_f64: float = 1e-9
    qp_tol_f32: float = 5e-6  # complementarity floors at ~sqrt(eps_f32)
    qp_reg_f64: float = 1e-11
    qp_reg_f32: float = 1e-7

    # --- solve-status semantics ----------------------------------------------
    # NaN-poison the solution (and hence anything differentiated through it)
    # of non-converged instances in the solve_* AD entry points. Off by default
    # (degenerate-but-usable boundary solves would otherwise poison training
    # loops); pair with solve_*(..., with_info=True) to inspect instead.
    nan_on_unconverged: bool = False

    # ------------------------------------------------------------------------
    def qp_tol(self, dtype) -> float:
        return self.qp_tol_f64 if dtype == torch.float64 else self.qp_tol_f32

    def qp_reg(self, dtype) -> float:
        return self.qp_reg_f64 if dtype == torch.float64 else self.qp_reg_f32

    def ldl_lam_floor(self, dtype) -> float:
        return self.ldl_lam_floor_f64 if dtype == torch.float64 else self.ldl_lam_floor_f32

    def ldl_reg(self, dtype) -> float:
        return self.ldl_reg_f64 if dtype == torch.float64 else self.ldl_reg_f32


DEFAULT_CONFIG = DiffOptConfig()

_active_config: DiffOptConfig = DEFAULT_CONFIG


def get_config() -> DiffOptConfig:
    """The config whose values resolve ``None`` defaults at call time."""
    return _active_config


def set_config(cfg: DiffOptConfig) -> None:
    """Install ``cfg`` globally."""
    global _active_config
    if not isinstance(cfg, DiffOptConfig):
        raise TypeError(f"expected DiffOptConfig, got {type(cfg)!r}")
    _active_config = cfg


@contextlib.contextmanager
def use_config(cfg: DiffOptConfig):
    """Scoped :func:`set_config` (restores the previous config on exit)."""
    global _active_config
    prev = _active_config
    set_config(cfg)
    try:
        yield cfg
    finally:
        _active_config = prev
