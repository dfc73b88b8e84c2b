"""Chebyshev polynomial preconditioner (counterpart of
``krylov_tpu/precond.py``).

``ChebyshevPreconditioner`` applies the degree-d Chebyshev semi-iteration
polynomial for A z = r, the optimal ∞-norm polynomial approximation of
A⁻¹ on [lmin, lmax]; each application costs d − 1 operator matvecs (the
DIA SpMV kernel for a DIA operator on the card).  For a Hermitian
positive-definite A with spectrum inside [lmin, lmax] the polynomial is
Hermitian positive definite, so it is a valid centered M for cg, cr and
minres.  ``cg(A, b, M=ChebyshevPreconditioner(A))`` with A one DIA
operator runs the whole preconditioned solve in the Chebyshev CG kernel
(ops/cuda_fused.py).
"""

import numpy as np
import torch

from ._dtypes import real_dtype
from ._runtime import as_device_tensor
from .operators import AbstractLinearOperator, as_operator
from .ops.cuda_fused import cheby_constants


def power_bound(A, iters=20, seed=0, inflate=1.05):
    """Upper bound on the spectral radius of ``A`` by power iteration.

    ``iters`` matvecs on the operator's device with one host read at the
    end, from the same numpy start vector as the JAX package's, inflated
    by ``inflate`` so that the Chebyshev interval certainly covers λmax.
    For a Hermitian A this bounds λmax(A).
    """
    A = as_operator(A)
    n = A.shape[0]
    dtype = A.dtype if A.dtype is not None else torch.float32
    v = as_device_tensor(np.random.default_rng(seed).standard_normal(n),
                         A).to(dtype)
    v = v / torch.linalg.vector_norm(v).to(dtype)
    lam = torch.zeros((), dtype=real_dtype(dtype), device=v.device)
    for _ in range(iters):
        w = A.matvec(v)
        lam = torch.sqrt(torch.sum(torch.abs(w) ** 2))
        safe = torch.where(lam == 0, torch.ones_like(lam), lam)
        v = w / safe.to(w.dtype)
    return float(lam) * float(inflate)


class ChebyshevPreconditioner(AbstractLinearOperator):
    """M = p_d(A) ≈ A⁻¹, the degree-``degree`` Chebyshev polynomial on
    [lmin, lmax] (Chebyshev semi-iteration for A z = r started from 0).

    Args:
      A: Hermitian positive-definite operator (any port operator).
      degree: polynomial degree d ≥ 1; one application = d − 1 matvecs.
      lmax: upper spectral bound; estimated by :func:`power_bound` when
        omitted (a one-time cost at construction).
      lmin: lower spectral bound; defaults to ``lmax / 30``.  If the true
        λmin lies below ``lmin``, shrink it: an interval that misses
        spectrum can make M indefinite.

    ``lmin`` and ``lmax`` are Python floats.  The operator is Hermitian
    by construction: ``rmatvec``, ``solve`` and ``rsolve`` are the same
    application, so both ``ldiv`` modes behave identically.
    """

    def __init__(self, A, degree=8, lmin=None, lmax=None):
        self.A = as_operator(A)
        self.degree = int(degree)
        if self.degree < 1:
            raise ValueError("degree must be >= 1")
        if lmax is None:
            lmax = power_bound(self.A)
        if lmin is None:
            lmin = lmax / 30.0
        self.lmin = float(lmin)
        self.lmax = float(lmax)
        self.shape = self.A.shape
        self.dtype = self.A.dtype
        self.device = self.A.device

    def matvec(self, r):
        """z = p_d(A) r, rounding θ, δ and the step coefficients as
        krylov_tpu's ``ChebyshevPreconditioner.matvec`` does."""
        theta, steps = cheby_constants(self.lmin, self.lmax, self.degree,
                                       real_dtype(r.dtype),
                                       round_bounds=False)
        d = r / theta
        z = d
        for c1, c2 in steps:
            d = c1 * d + c2 * (r - self.A.matvec(z))
            z = z + d
        return z

    def rmatvec(self, r):
        return self.matvec(r)

    def solve(self, r):
        return self.matvec(r)

    def rsolve(self, r):
        return self.matvec(r)
