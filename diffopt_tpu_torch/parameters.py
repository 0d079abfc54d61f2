"""Named-parameter front end — the parameter layer as function composition.

Counterpart of ``diffopt_tpu/parameters.py``: the user writes
``build(theta) -> QuadProgram`` in plain torch (bilinear ``theta * x``
coefficient terms and quadratic ``theta ** 2`` constants included), and the
chain rule through ``build`` composes with the solution-map rules under
``torch.autograd`` (reverse mode) and ``torch.autograd.forward_ad`` (forward
mode) — every op in ``build`` must support the mode that is used.

    layer = ParametricProgram(build, kind="qp")
    sol   = layer.solve(theta)                       # differentiable
    dsol  = layer.forward_differentiate(theta, dtheta)
    dtheta = layer.reverse_differentiate(theta, dz=...)

``theta`` is a tensor or any nesting of dicts, lists and tuples of tensors.
``kind="conic"`` and ``kind="nlp"`` come with the cone and NLP slices of the
port.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.autograd.forward_ad as fwAD
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

from .ir import QPSolution
from .solve import solve_qp

_WAITING = {
    "conic": "kind='conic' waits for the cone slice of the port (cones.py, conic_diff.py, solve_conic)",
    "nlp": "kind='nlp' waits for the NLP slice of the port (nlp_diff.py, solvers/nlp.py, solve_nlp)",
}


class ParametricProgram:
    """A program whose data is an arbitrary differentiable function of
    parameters. ``build(theta)`` must return a
    :class:`~diffopt_tpu_torch.ir.QuadProgram` (``kind='qp'``), one instance
    or a batch; ``solve_options`` go to :func:`~diffopt_tpu_torch.solve_qp`.
    """

    def __init__(self, build: Callable, kind: str = "qp", **solve_options):
        if kind not in ("qp", "conic", "nlp"):
            raise ValueError("kind must be 'qp', 'conic' or 'nlp'")
        if kind != "qp":
            raise NotImplementedError(_WAITING[kind])
        self.build = build
        self.kind = kind
        self.solve_options = dict(solve_options)

    def _solve(self, theta, mode: str):
        return solve_qp(self.build(theta), mode=mode, **self.solve_options)

    def solve(self, theta):
        """Differentiable solve (reverse-mode ready: call ``backward`` on a
        function of the result)."""
        return self._solve(theta, "vjp")

    def forward_differentiate(self, theta, dtheta) -> QPSolution:
        """JVP: tangent of the full primal-dual solution along ``dtheta``
        (same structure as ``theta``)."""
        with fwAD.dual_level():
            dual = tree_map(lambda t, d: fwAD.make_dual(t.detach(), d), theta, dtheta)
            sol = self._solve(dual, "jvp")

            def tangent(t):
                d = fwAD.unpack_dual(t).tangent
                return torch.zeros_like(t) if d is None else d

            return sol.map(tangent)

    def reverse_differentiate(self, theta, **seeds):
        """VJP: parameter cotangents (same structure as ``theta``) for
        solution seeds ``dz=...`` and optionally ``dlam=`` / ``dnu=``."""
        leaves, spec = tree_flatten(theta)
        leaves = [t.detach().requires_grad_() for t in leaves]
        sol = self._solve(tree_unflatten(leaves, spec), "vjp")
        outs, cots = [], []
        for out, name in zip(sol.tensors(), ("dz", "dlam", "dnu")):
            if name in seeds and out.requires_grad:
                outs.append(out)
                cots.append(seeds[name])
        grads = torch.autograd.grad(outs, leaves, cots, allow_unused=True) if outs else [None] * len(leaves)
        grads = [torch.zeros_like(t) if g is None else g for t, g in zip(leaves, grads)]
        return tree_unflatten(grads, spec)
