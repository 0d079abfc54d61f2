"""Problem intermediate representation: dataclasses of tensors.

Counterpart of ``diffopt_tpu/ir.py``. Conventions (AK17 / Amos-Kolter,
arXiv:1703.00443)::

    min_z  1/2 z'Qz + q'z
    s.t.   A z = b          (dual nu, Lagrangian term + nu.(Az - b))
           G z <= h         (dual lam >= 0, Lagrangian term + lam.(Gz - h))

The port is batch-first: every field carries a leading batch dimension,
``Q (B, n, n)``, ``q (B, n)``, ``A (B, p, n)``, ``b (B, p)``, ``G (B, m, n)``,
``h (B, m)``.

Conic programs (SCS geometric form)::

    min c'x   s.t.  Ax + s = b,  s in K

with ``A (B, m, n)``, ``b (B, m)``, ``c (B, n)`` and ``cones`` a static
:class:`~diffopt_tpu_torch.cones.ConeSpec` describing the row layout of K.
"""

from __future__ import annotations

import dataclasses

import torch

Tensor = torch.Tensor


class _TensorStruct:
    """Shared ``.to`` / field iteration for the dataclasses below."""

    def tensors(self):
        return tuple(getattr(self, f.name) for f in dataclasses.fields(self))

    def map(self, fn):
        """A new struct with ``fn`` applied to every field."""
        return type(self)(*(fn(t) for t in self.tensors()))

    def to(self, device=None, dtype=None):
        return self.map(lambda t: t.to(device=device, dtype=dtype))


@dataclasses.dataclass(frozen=True)
class QuadProgram(_TensorStruct):
    """Quadratic program ``min 1/2 z'Qz + q'z  s.t.  Az = b, Gz <= h``.
    ``p`` or ``m`` may be zero (size-0 tensors)."""

    Q: Tensor
    q: Tensor
    A: Tensor
    b: Tensor
    G: Tensor
    h: Tensor

    @property
    def num_vars(self) -> int:
        return self.q.shape[-1]

    @property
    def num_eq(self) -> int:
        return self.b.shape[-1]

    @property
    def num_ineq(self) -> int:
        return self.h.shape[-1]

    @property
    def batch_size(self) -> int:
        return self.q.shape[0]

    @staticmethod
    def make(
        Q=None, q=None, A=None, b=None, G=None, h=None, *, n=None,
        dtype=None, device=None,
    ) -> "QuadProgram":
        """Build a QuadProgram, filling absent pieces with empty (or zero)
        tensors. Leading dims of ``q`` (or ``Q``) are the batch dims.

        Lands where the data lives: on ``device`` if given, else on the device
        of the first argument that is a tensor, else (lists, numpy arrays) on
        the card, as ``make_batch`` does — and raises where there is none;
        name ``device="cpu"`` to build on the host."""
        if device is None:
            given = [x for x in (q, Q, A, b, G, h) if isinstance(x, torch.Tensor)]
            if given:
                device = given[0].device
            elif torch.cuda.is_available():
                device = torch.device("cuda")
            else:
                raise RuntimeError(
                    "QuadProgram.make: no device given and no CUDA device available; "
                    'pass device="cpu" to build on the host'
                )
        as_t = lambda x: torch.as_tensor(x, dtype=dtype, device=device)
        if q is not None:
            q = as_t(q)
            n = q.shape[-1]
            lead = q.shape[:-1]
        elif Q is not None:
            Q = as_t(Q)
            n = Q.shape[-1]
            lead = Q.shape[:-2]
        elif n is None:
            raise ValueError("need q, Q or n to infer the variable count")
        else:
            lead = ()
        dt = dtype or (q.dtype if q is not None else Q.dtype if Q is not None else torch.float64)
        kw = dict(dtype=dt, device=device)
        fill = lambda x, shape: torch.zeros(lead + shape, **kw) if x is None else torch.as_tensor(x, **kw)
        return QuadProgram(
            Q=fill(Q, (n, n)),
            q=fill(q, (n,)),
            A=fill(A, (0, n)),
            b=fill(b, (0,)),
            G=fill(G, (0, n)),
            h=fill(h, (0,)),
        )


@dataclasses.dataclass(frozen=True)
class QPSolution(_TensorStruct):
    """Primal-dual solution in AK17 convention: ``z (B, n)`` primal,
    ``lam (B, m) >= 0`` inequality duals, ``nu (B, p)`` equality duals."""

    z: Tensor
    lam: Tensor
    nu: Tensor


@dataclasses.dataclass(frozen=True)
class QPTangent(_TensorStruct):
    """Perturbation (or cotangent) of QuadProgram data."""

    dQ: Tensor
    dq: Tensor
    dA: Tensor
    db: Tensor
    dG: Tensor
    dh: Tensor

    @staticmethod
    def zeros_like(qp: QuadProgram) -> "QPTangent":
        return QPTangent(*(torch.zeros_like(getattr(qp, k)) for k in ("Q", "q", "A", "b", "G", "h")))


@dataclasses.dataclass(frozen=True)
class ConeProgram(_TensorStruct):
    """Conic program ``min c'x  s.t.  Ax + s = b, s in K``: ``A (B, m, n)``,
    ``b (B, m)``, ``c (B, n)`` (one instance drops the batch dimension);
    ``cones`` is static metadata, carried along by :meth:`map` and
    :meth:`to`, never a tensor."""

    A: Tensor
    b: Tensor
    c: Tensor
    cones: "ConeSpec"

    def tensors(self):
        return (self.A, self.b, self.c)

    def map(self, fn):
        return ConeProgram(fn(self.A), fn(self.b), fn(self.c), self.cones)

    @property
    def num_vars(self) -> int:
        return self.c.shape[-1]

    @property
    def num_rows(self) -> int:
        return self.b.shape[-1]

    @property
    def batch_size(self) -> int:
        return self.c.shape[0]


@dataclasses.dataclass(frozen=True)
class ConeSolution(_TensorStruct):
    """Primal-dual-slack solution: ``x (B, n)``, ``y (B, m)`` dual in K*,
    ``s (B, m)`` slack in K."""

    x: Tensor
    y: Tensor
    s: Tensor


@dataclasses.dataclass(frozen=True)
class ConeTangent(_TensorStruct):
    """Perturbations (or cotangents) ``(dA, db, dc)`` of ConeProgram data."""

    dA: Tensor
    db: Tensor
    dc: Tensor

    @staticmethod
    def zeros_like(cp: ConeProgram) -> "ConeTangent":
        return ConeTangent(*(torch.zeros_like(t) for t in cp.tensors()))
