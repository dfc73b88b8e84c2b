"""L1 operator protocol (counterpart of ``krylov_tpu/operators.py``).

Any object with ``matvec(x)``/``rmatvec(x)`` (rmatvec = Aᴴx), ``shape``
and ``dtype`` works.  Preconditioners follow the same protocol; when a
solver is called with ``ldiv=True`` the preconditioner's ``solve(x)`` is
used instead of ``matvec`` (reference mulorldiv!:
src/krylov_utils.jl:305-307).
"""

import numpy as np
import torch

from ._runtime import as_device_tensor, full_fp32
from .ops.cuda_dia import (DIASpMV, dia_align, dia_align_adjoint,
                           offsets_tensor)
from .ops.cuda_spmv import bell_spmm, bell_spmv
from .ops.dia import DIAMatrix, dia_spmm, dia_spmv, resolve_device
from .ops.hybrid import hybrid_from_csr, hybrid_spmv
from .ops.sparse import CSRMatrix, spmm, spmv


class AbstractLinearOperator:
    """Protocol: matvec, rmatvec, shape, dtype; optionally solve/rsolve.

    ``device`` is the device of the operator's data, or None where it
    holds no tensor (a solver then puts non-tensor inputs on the card).
    """

    shape = None
    dtype = None
    device = None

    def matvec(self, x):
        raise NotImplementedError

    def rmatvec(self, x):
        """y = Aᴴ x (the reference's A' apply)."""
        raise NotImplementedError

    def solve(self, x):
        """y = A⁻¹ x — preconditioner ldiv-mode apply."""
        raise NotImplementedError(
            f"{type(self).__name__} does not support ldiv-mode application"
        )

    def rsolve(self, x):
        """y = A⁻ᴴ x."""
        raise NotImplementedError

    @property
    def H(self):
        return AdjointOperator(self)

    @property
    def T(self):
        return self.H

    def __matmul__(self, x):
        if getattr(x, "ndim", 1) == 2:
            return self.matmat(x)
        return self.matvec(x)

    def matmat(self, X):
        # columns made contiguous: the SpMV kernel takes no strided vector
        return torch.stack([self.matvec(X[:, j].contiguous())
                            for j in range(X.shape[1])], dim=1)

    def rmatmat(self, X):
        return torch.stack([self.rmatvec(X[:, j].contiguous())
                            for j in range(X.shape[1])], dim=1)


class AdjointOperator(AbstractLinearOperator):
    """Aᴴ of an operator: its products are the base's adjoint products."""

    def __init__(self, base):
        self.base = base
        self.shape = (base.shape[1], base.shape[0])
        self.dtype = base.dtype
        self.device = getattr(base, "device", None)

    def matvec(self, x):
        return self.base.rmatvec(x)

    def rmatvec(self, x):
        return self.base.matvec(x)

    def matmat(self, X):
        return self.base.rmatmat(X)

    def rmatmat(self, X):
        return self.base.matmat(X)

    def solve(self, x):
        return self.base.rsolve(x)

    @property
    def H(self):
        return self.base


class IdentityOperator(AbstractLinearOperator):
    def __init__(self, n=None, dtype=None):
        self.shape = (n, n) if n is not None else None
        self.dtype = dtype

    def matvec(self, x):
        return x

    rmatvec = matvec
    solve = matvec
    rsolve = matvec

    def matmat(self, X):
        return X

    rmatmat = matmat

    @property
    def H(self):
        return self


def _placed(v, device):
    """A tensor stays where it is; other data goes to ``device``, by
    default the card (raising when there is none)."""
    if isinstance(v, torch.Tensor):
        return v
    return torch.as_tensor(v, device=resolve_device(
        "cuda" if device is None else device))


class DiagonalOperator(AbstractLinearOperator):
    """diag(d) — the Jacobi preconditioner building block.  A tensor d
    stays where it is; numpy data goes to ``device``, by default the
    card."""

    def __init__(self, d, device=None):
        self.d = _placed(d, device)
        self.shape = (self.d.shape[0], self.d.shape[0])
        self.dtype = self.d.dtype
        self.device = self.d.device

    def matvec(self, x):
        return self.d * x

    def rmatvec(self, x):
        return torch.conj(self.d) * x

    def solve(self, x):
        return x / self.d

    def rsolve(self, x):
        return x / torch.conj(self.d)

    def matmat(self, X):
        return self.d[:, None] * X

    def rmatmat(self, X):
        return torch.conj(self.d)[:, None] * X


class MatrixOperator(AbstractLinearOperator):
    """Dense matrix operator.  Products run in full fp32, never TF32
    (the counterpart of precision=HIGHEST in the JAX package).  A tensor
    stays where it is; numpy data goes to ``device``, by default the
    card."""

    def __init__(self, A, device=None):
        self.A = _placed(A, device)
        self.shape = tuple(self.A.shape)
        self.dtype = self.A.dtype
        self.device = self.A.device

    def matvec(self, x):
        with full_fp32():
            return torch.matmul(self.A, x)

    def rmatvec(self, x):
        with full_fp32():
            return torch.matmul(self.A.conj().T, x)

    def matmat(self, X):
        with full_fp32():
            return torch.matmul(self.A, X)

    def rmatmat(self, X):
        with full_fp32():
            return torch.matmul(self.A.conj().T, X)


class CSROperator(AbstractLinearOperator):
    """CSR sparse operator; the storage of Aᴴ is built on the host when
    ``with_adjoint()`` asks for it."""

    def __init__(self, csr, csr_h=None):
        self.csr = csr
        self.csr_h = csr_h
        self.shape = csr.shape
        self.dtype = csr.dtype
        self.device = csr.device

    def with_adjoint(self):
        if self.csr_h is None:
            return CSROperator(self.csr, self.csr.transpose_conj())
        return self

    def _adjoint(self):
        if self.csr_h is None:
            raise ValueError(
                "CSROperator needs adjoint storage: build with .with_adjoint()"
            )
        return self.csr_h

    def matvec(self, x):
        return spmv(self.csr, x)

    def rmatvec(self, x):
        return spmv(self._adjoint(), x)

    def matmat(self, X):
        return spmm(self.csr, X)

    def rmatmat(self, X):
        return spmm(self._adjoint(), X)


class FunctionOperator(AbstractLinearOperator):
    """Matrix-free operator from callables (the matrix-free contract)."""

    def __init__(self, matvec, shape, dtype, rmatvec=None, solve=None,
                 rsolve=None):
        self._matvec = matvec
        self._rmatvec = rmatvec
        self._solve = solve
        self._rsolve = rsolve
        self.shape = tuple(shape)
        self.dtype = dtype

    def matvec(self, x):
        return self._matvec(x)

    def rmatvec(self, x):
        if self._rmatvec is None:
            raise ValueError("FunctionOperator built without rmatvec")
        return self._rmatvec(x)

    def solve(self, x):
        if self._solve is None:
            raise NotImplementedError("FunctionOperator built without solve")
        return self._solve(x)

    def rsolve(self, x):
        if self._rsolve is None:
            raise NotImplementedError("FunctionOperator built without rsolve")
        return self._rsolve(x)


class DIAOperator(AbstractLinearOperator):
    """Banded (DIA) operator — the fast path for stencil matrices.

    ``use_kernel=True`` (the default for a matrix on the card) aligns the
    diagonals once, at construction, and routes matvecs (and, through
    the cached ``aligned_adjoint``, rmatvecs) through the DIA SpMV kernel
    (ops/cuda_dia.py) and eligible solves through the whole-solve
    kernels (ops/cuda_fused.py).  On the CPU both take their plain
    versions.  ``use_kernel=False`` uses the plain shift-and-add product
    on the stored diagonals.
    """

    def __init__(self, dia, use_kernel=None):
        self.dia = dia
        self.shape = dia.shape
        self.dtype = dia.dtype
        self.device = dia.device
        if use_kernel is None:
            use_kernel = dia.data.is_cuda
        self.use_kernel = bool(use_kernel)
        self._pd = None
        self._pd_adj = self._offsets_adj = None
        self._spmv = self._spmv_adj = None
        if self.use_kernel:
            self._pd = dia_align(dia.data, dia.offsets, dia.shape[0])
            self._offsets = offsets_tensor(dia.offsets, dia.data.device)
            self._spmv = DIASpMV(self._pd, self._offsets, dia.offsets)

    def matvec(self, x):
        if self.use_kernel:
            return self._spmv(x)
        return dia_spmv(self.dia.data, self.dia.offsets, x)

    def matmat(self, X):
        """A X: on the card the SpMV kernel once per column (the JAX
        package's ``dia_spmm`` runs outside any kernel); elsewhere the
        plain ``dia_spmm``."""
        if self.use_kernel and X.is_cuda:
            return super().matmat(X)
        return dia_spmm(self.dia.data, self.dia.offsets, X)

    def adjoint_dia(self):
        """(data, offsets) of Aᴴ in DIA layout: conjugate data, negate
        offsets, shift the stored diagonals.  A[i, i+k] = data[d, i+k] ⇒
        Aᴴ[j, j−k] = conj(data[d, j]) stored at position (j − k)."""
        return (dia_align(torch.conj(self.dia.data), self.dia.offsets,
                          self.shape[0]),
                tuple(-k for k in self.dia.offsets))

    def aligned_adjoint(self):
        """(pd_adj, offsets_adj): the output-aligned diagonals of Aᴴ and
        their offsets (ops/cuda_dia.dia_align_adjoint), computed once and
        cached."""
        if self._pd_adj is None:
            pd = self._pd if self._pd is not None else dia_align(
                self.dia.data, self.dia.offsets, self.shape[0])
            self._pd_adj = dia_align_adjoint(pd, self.dia.offsets,
                                             self.shape[0])
        return self._pd_adj

    def aligned_adjoint_kernel_args(self):
        """(pd_adj, offsets_adj as a tensor on pd_adj's device): what the
        kernels that apply Aᴴ take; the tensor is made once and cached."""
        pd_adj, offs = self.aligned_adjoint()
        if self._offsets_adj is None:
            self._offsets_adj = offsets_tensor(offs, pd_adj.device)
        return pd_adj, self._offsets_adj

    def rmatvec(self, x):
        if self.use_kernel:
            if self._spmv_adj is None:
                pd_adj, ot_adj = self.aligned_adjoint_kernel_args()
                self._spmv_adj = DIASpMV(pd_adj, ot_adj,
                                         self.aligned_adjoint()[1])
            return self._spmv_adj(x)
        data, offs = self.adjoint_dia()
        return dia_spmv(data, offs, x)


class BELLOperator(AbstractLinearOperator):
    """Block-ELL operator on the BELL kernels (ops/cuda_spmv.py): matvec
    through ``bell_spmv``, matmat (the block solvers') through
    ``bell_spmm``.  Hermitian systems need only A's storage; the
    unsymmetric methods take the adjoint's, built by the caller:
    ``BELLOperator(bell, bell_h)``."""

    def __init__(self, bell, bell_h=None):
        self.bell = bell
        self.bell_h = bell_h
        self.shape = bell.shape
        self.dtype = bell.dtype
        self.device = bell.device

    def _adjoint(self):
        if self.bell_h is None:
            raise ValueError(
                "BELLOperator needs adjoint storage: pass bell_h")
        return self.bell_h

    def matvec(self, x):
        return bell_spmv(self.bell, x)

    def rmatvec(self, x):
        return bell_spmv(self._adjoint(), x)

    def matmat(self, X):
        return bell_spmm(self.bell, X)

    def rmatmat(self, X):
        return bell_spmm(self._adjoint(), X)


class HybridOperator(AbstractLinearOperator):
    """General-sparse operator: the DIA + SELL-C-128 decomposition of a
    CSRMatrix (``ops/hybrid.hybrid_from_csr``).

    Dense diagonals go through the DIA SpMV kernel, the remainder through
    the SELL kernel (on the card; their plain versions on the CPU).  The
    adjoint is a second analysed decomposition, of Aᴴ, built by
    ``with_adjoint()``.
    """

    def __init__(self, hyb, hyb_h=None, _csr=None):
        self.hyb = hyb
        self.hyb_h = hyb_h
        self._csr = _csr            # kept for the adjoint's analysis
        # the source's arrays as analysed: ``as_operator`` analyses again
        # when they have changed since (torch tensors are mutable)
        self._stamp = None if _csr is None else _stamp(_csr)
        self.shape = hyb.shape
        self.dtype = hyb.dtype
        self.device = hyb.device

    @classmethod
    def analyze(cls, csr, diag_fill=0.5, max_diags=256):
        return cls(hybrid_from_csr(csr, diag_fill, max_diags), _csr=csr)

    def with_adjoint(self):
        """This operator with the analysis of Aᴴ beside it.  Where the
        source matrix caches this operator (``as_operator``), the new one
        replaces it."""
        if self.hyb_h is not None:
            return self
        if self._csr is None:
            raise ValueError("HybridOperator needs the source CSRMatrix "
                             "to build adjoint storage")
        # a source changed since this analysis is analysed anew, so that
        # A's and Aᴴ's storage hold the same matrix
        hyb = self.hyb if self._stamp == _stamp(self._csr) \
            else hybrid_from_csr(self._csr)
        op = HybridOperator(hyb, hybrid_from_csr(self._csr.transpose_conj()),
                            self._csr)
        if getattr(self._csr, "_hybrid_op", None) is self:
            self._csr._hybrid_op = op
        return op

    def matvec(self, x):
        return hybrid_spmv(self.hyb, x)

    def rmatvec(self, x):
        if self.hyb_h is None:
            raise ValueError(
                "HybridOperator needs adjoint storage: build with "
                ".with_adjoint()")
        return hybrid_spmv(self.hyb_h, x)


def _stamp(csr):
    """What an in-place update of a CSRMatrix's tensors changes: each one's
    version counter (None for an inference tensor, which keeps none) and
    storage address; an array's identity."""
    return tuple((None if t.is_inference() else t._version, t.data_ptr())
                 if isinstance(t, torch.Tensor) else id(t)
                 for t in (csr.data, csr.indices, csr.indptr, csr.rows))


def _cached_hybrid(A):
    """The HybridOperator cached on CSRMatrix ``A``, analysed anew when
    there is none or ``A``'s tensors have changed since its analysis."""
    op = getattr(A, "_hybrid_op", None)
    if op is None or op._stamp != _stamp(A):
        op = HybridOperator.analyze(A)
        A._hybrid_op = op
    return op


def with_adjoint(A):
    """A CSR-backed operator with the storage of Aᴴ (the JAX package's
    ``as_operator(A, need_adjoint=True)``); any other operator as it is."""
    if isinstance(A, (CSROperator, HybridOperator)):
        return A.with_adjoint()
    return A


def as_operator(A, device=None):
    """Coerce A (operator | DIAMatrix | CSRMatrix | dense tensor or array)
    to the operator protocol.  A tensor stays where it is; a numpy array
    goes to ``device``, by default the card (raising when there is none,
    as the constructors do).

    A CSRMatrix on the card is analysed once into a ``HybridOperator``,
    cached on the matrix (``A._hybrid_op``), so that repeated solves pay
    the analysis once, and analysed again after an in-place change of its
    tensors; on the CPU it stays a ``CSROperator``."""
    if A is None:
        return None
    if isinstance(A, AbstractLinearOperator):
        return A
    if isinstance(A, DIAMatrix):
        return DIAOperator(A)
    if isinstance(A, CSRMatrix):
        if A.data.is_cuda:
            return _cached_hybrid(A)
        return CSROperator(A)
    if isinstance(A, (torch.Tensor, np.ndarray)):
        if A.ndim != 2:
            raise ValueError(f"expected a 2-D array, got ndim={A.ndim}")
        return MatrixOperator(A, device=device)
    raise TypeError(
        f"cannot interpret {type(A).__name__} as a linear operator; "
        "wrap callables in FunctionOperator(matvec, shape, dtype)"
    )


def solve_inputs(A, b, x0=None, M=None):
    """(A, b, x0, M) of a solve, coerced to operators and tensors.

    A numpy A goes where a tensor b lies, else to the card; b and x0
    follow ``_runtime.as_device_tensor`` (a tensor stays where it is;
    anything else goes to the operator's device, else to the card); x0
    takes b's dtype, and a numpy M goes to b's device.
    """
    A = as_operator(A, device=b.device if isinstance(b, torch.Tensor)
                    else None)
    b = as_device_tensor(b, A)
    if x0 is not None:
        x0 = as_device_tensor(x0, b).to(b.dtype)
    return A, b, x0, as_operator(M, device=b.device)


def precond_apply(M, x, ldiv=False):
    """Apply preconditioner: identity if M is None (reference mulorldiv!)."""
    if M is None or isinstance(M, IdentityOperator):
        return x
    return M.solve(x) if ldiv else M.matvec(x)
