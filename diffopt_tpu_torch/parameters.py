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
``kind="conic"`` takes ``build(theta) -> ConeProgram`` and solves through
:func:`~diffopt_tpu_torch.solve_conic` (seeds ``dx=``, ``dy=``, ``ds=``).
NLP programs take ``build(theta) -> p``, the parameter vector of the static
:class:`~diffopt_tpu_torch.nlp_diff.NLPProblem` given as ``nlp=``, and solve
through :func:`~diffopt_tpu_torch.solve_nlp` (seeds ``dx=``, ``dy=``,
``dzL=``, ``dzU=``)::

    layer = ParametricProgram(build, kind="nlp", nlp=my_nlp_problem)
    sol   = layer.solve(theta)                       # NLPSolution, differentiable
    dth   = layer.reverse_differentiate(theta, dx=...)
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.autograd.forward_ad as fwAD
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

from .solve import solve_conic, solve_nlp, solve_qp

_SEEDS = {"qp": ("dz", "dlam", "dnu"), "conic": ("dx", "dy", "ds"), "nlp": ("dx", "dy", "dzL", "dzU")}


class ParametricProgram:
    """A program whose data is an arbitrary differentiable function of
    parameters. ``build(theta)`` must return a
    :class:`~diffopt_tpu_torch.ir.QuadProgram` (``kind='qp'``), a
    :class:`~diffopt_tpu_torch.ir.ConeProgram` (``kind='conic'``), one
    instance or a batch, or the NLP parameter vector ``p`` (``kind='nlp'``,
    which also needs the static ``nlp=``
    :class:`~diffopt_tpu_torch.nlp_diff.NLPProblem`); ``solve_options`` go to
    :func:`~diffopt_tpu_torch.solve_qp` / :func:`~diffopt_tpu_torch.solve_conic`
    / :func:`~diffopt_tpu_torch.solve_nlp`.
    """

    def __init__(self, build: Callable, kind: str = "qp", nlp=None, **solve_options):
        if kind not in ("qp", "conic", "nlp"):
            raise ValueError("kind must be 'qp', 'conic' or 'nlp'")
        if kind == "nlp" and nlp is None:
            raise ValueError("kind='nlp' needs the static nlp=NLPProblem(...)")
        if kind != "nlp" and nlp is not None:
            raise ValueError("nlp= is only meaningful with kind='nlp'")
        self.build = build
        self.kind = kind
        self.nlp = nlp
        self.solve_options = dict(solve_options)

    def _solve(self, theta, mode: str):
        prog = self.build(theta)
        if self.kind == "nlp":
            return solve_nlp(self.nlp, prog, mode=mode, **self.solve_options)
        solve = solve_qp if self.kind == "qp" else solve_conic
        return solve(prog, mode=mode, **self.solve_options)

    def solve(self, theta):
        """Differentiable solve (reverse-mode ready: call ``backward`` on a
        function of the result)."""
        return self._solve(theta, "vjp")

    def forward_differentiate(self, theta, dtheta):
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
        solution seeds ``dz=...`` and optionally ``dlam=`` / ``dnu=`` (QP),
        ``dx=`` / ``dy=`` / ``ds=`` (conic), or ``dx=`` / ``dy=`` / ``dzL=`` /
        ``dzU=`` (NLP)."""
        leaves, spec = tree_flatten(theta)
        leaves = [t.detach().requires_grad_() for t in leaves]
        sol = self._solve(tree_unflatten(leaves, spec), "vjp")
        outs, cots = [], []
        for out, name in zip(sol.tensors(), _SEEDS[self.kind]):
            if name in seeds and out.requires_grad:
                outs.append(out)
                cots.append(seeds[name])
        grads = torch.autograd.grad(outs, leaves, cots, allow_unused=True) if outs else [None] * len(leaves)
        grads = [torch.zeros_like(t) if g is None else g for t, g in zip(leaves, grads)]
        return tree_unflatten(grads, spec)
