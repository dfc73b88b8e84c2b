"""Standalone Krylov processes (counterpart of ``krylov_tpu/processes.py``).

The six basis-building factorisations of reference
src/krylov_processes.jl and their six block variants of
src/block_krylov_processes.jl, with dense coefficient matrices (built on
the host, returned on b's device) and QR normalisation of the blocks by
``torch.linalg.qr`` in place of the reference's LAPACK Householder calls.
Each runs an eager k-step loop; a breakdown raises unless
``allow_breakdown=True``, with the reference's text.  The products run
under ``_runtime.full_fp32``, never TF32: the processes exist to give an
orthogonal basis.
"""

import functools

import numpy as np
import torch

from ._dtypes import real_dtype
from ._runtime import as_device_tensor, full_fp32
from .operators import as_operator, with_adjoint
from .ops.kops import kdot, kdotr, knorm


def _fp32(fn):
    """Run a process under IEEE fp32 products (the JAX package's ``_hi``)."""
    @functools.wraps(fn)
    def wrapper(*a, **k):
        with full_fp32():
            return fn(*a, **k)
    return wrapper


def _chk(val, allow, what):
    if not allow and float(val) == 0:
        raise ValueError(f"Exact breakdown {what} == 0.")


def _inputs(A, b, *more, adjoint=False):
    """A as an operator (with its adjoint storage where ``adjoint``), b as
    a tensor on A's device, and each of ``more`` on b's device in b's
    dtype."""
    A = as_operator(A, device=b.device if isinstance(b, torch.Tensor)
                    else None)
    if adjoint:
        A = with_adjoint(A)
    b = as_device_tensor(b, A)
    return (A, b) + tuple(as_device_tensor(v, b).to(b.dtype) for v in more)


def _np_dtype(dtype):
    return torch.empty(0, dtype=dtype).numpy().dtype


def _entry(v, cplx):
    """A host scalar for a coefficient matrix: complex where the matrix is,
    else the real part."""
    v = v.item() if torch.is_tensor(v) else v
    return complex(v) if cplx else float(v.real)


def _out(M, like):
    return torch.as_tensor(M, device=like.device)


def _unit(v, nrm, FC):
    """v / nrm, with nrm = 0 read as 1."""
    return v / torch.where(nrm == 0, torch.ones_like(nrm), nrm).to(FC)


@_fp32
def hermitian_lanczos(A, b, k, allow_breakdown=False,
                      reorthogonalization=False):
    """V, β₁, T with A Vₖ = Vₖ₊₁ Tₖ₊₁.ₖ (reference :28-103).

    Returns V (n, k+1), β₁ and T (k+1, k), real tridiagonal."""
    A, b = _inputs(A, b)
    n = b.shape[0]
    FC = b.dtype
    Tm = np.zeros((k + 1, k), dtype=_np_dtype(real_dtype(FC)))
    beta1 = knorm(b)
    _chk(beta1, allow_breakdown, "β₁")
    V = [torch.zeros(n, dtype=FC, device=b.device) if float(beta1) == 0
         else b / beta1.to(FC)]
    for i in range(k):
        q = A.matvec(V[i])
        if i >= 1:
            beta_i = Tm[i, i - 1]
            Tm[i - 1, i] = beta_i
            q = q - float(beta_i) * V[i - 1]
        alpha = kdotr(V[i], q)
        q = q - alpha.to(FC) * V[i]
        if reorthogonalization:
            if i >= 1:
                btmp = kdotr(V[i - 1], q)
                Tm[i, i - 1] += float(btmp)
                Tm[i - 1, i] += float(btmp)
                q = q - btmp.to(FC) * V[i - 1]
            atmp = kdotr(V[i], q)
            alpha = alpha + atmp
            q = q - atmp.to(FC) * V[i]
        Tm[i, i] = float(alpha)
        beta = knorm(q)
        _chk(beta, allow_breakdown, f"β{i + 2}")
        Tm[i + 1, i] = float(beta)
        V.append(torch.zeros(n, dtype=FC, device=b.device)
                 if float(beta) == 0 else q / beta.to(FC))
    return torch.stack(V, dim=1), float(beta1), _out(Tm, b)


@_fp32
def nonhermitian_lanczos(A, b, c, k, allow_breakdown=False):
    """V, β₁, T, U, γ₁ᴴ, Tᴴ: Lanczos biorthogonalisation (reference
    :133-224)."""
    A, b, c = _inputs(A, b, c, adjoint=True)
    n = b.shape[0]
    FC = b.dtype
    cplx = FC.is_complex
    Tm = np.zeros((k + 1, k), dtype=_np_dtype(FC))
    Th = np.zeros((k + 1, k), dtype=_np_dtype(FC))
    one = torch.ones((), dtype=real_dtype(FC), device=b.device)

    cHb = kdot(c, b)
    _chk(torch.abs(cHb), allow_breakdown, "β₁γ₁")
    beta1 = torch.sqrt(torch.abs(cHb))
    gamma1 = torch.where(beta1 == 0, torch.zeros_like(cHb),
                         cHb / torch.where(beta1 == 0, one, beta1).to(FC))
    V = [b / torch.where(beta1 == 0, one, beta1).to(FC)]
    U = [c / torch.where(gamma1 == 0, torch.ones_like(gamma1),
                         torch.conj(gamma1))]
    beta, gamma = beta1.to(FC), gamma1
    for i in range(k):
        q = A.matvec(V[i])
        p = A.rmatvec(U[i])
        if i >= 1:
            q = q - gamma * V[i - 1]
            p = p - torch.conj(beta) * U[i - 1]
        alpha = kdot(U[i], q)
        q = q - alpha * V[i]
        p = p - torch.conj(alpha) * U[i]
        pHq = kdot(p, q)
        if i < k - 1:
            _chk(torch.abs(pHq), allow_breakdown, f"β{i + 2}γ{i + 2}")
        beta_n = torch.sqrt(torch.abs(pHq))
        gamma_n = torch.where(
            beta_n == 0, torch.zeros_like(pHq),
            pHq / torch.where(beta_n == 0, one, beta_n).to(FC))
        Tm[i, i] = _entry(alpha, cplx)
        Th[i, i] = np.conj(Tm[i, i])
        Tm[i + 1, i] = _entry(beta_n, cplx)
        Th[i + 1, i] = (np.conj(_entry(gamma_n, True)) if cplx
                        else _entry(gamma_n, False))
        if i + 1 < k:
            Tm[i, i + 1] = _entry(gamma_n, cplx)
            Th[i, i + 1] = (np.conj(_entry(beta_n, True)) if cplx
                            else _entry(beta_n, False))
        nz = float(torch.abs(pHq)) != 0
        V.append(q / beta_n.to(FC) if nz
                 else torch.zeros(n, dtype=FC, device=b.device))
        U.append(p / torch.conj(gamma_n) if nz
                 else torch.zeros(n, dtype=FC, device=b.device))
        beta, gamma = beta_n.to(FC), gamma_n
    return (torch.stack(V, dim=1), float(beta1), _out(Tm, b),
            torch.stack(U, dim=1), _entry(torch.conj(gamma1), True),
            _out(Th, b))


@_fp32
def arnoldi(A, b, k, allow_breakdown=False, reorthogonalization=False):
    """V, β, H with A Vₖ = Vₖ₊₁ Hₖ₊₁.ₖ (reference :250-296)."""
    A, b = _inputs(A, b)
    FC = b.dtype
    cplx = FC.is_complex
    H = np.zeros((k + 1, k), dtype=_np_dtype(FC))
    beta = knorm(b)
    _chk(beta, allow_breakdown, "β")
    V = [_unit(b, beta, FC)]
    for j in range(k):
        q = A.matvec(V[j])
        for i in range(j + 1):
            hij = kdot(V[i], q)
            H[i, j] = _entry(hij, cplx)
            q = q - hij * V[i]
        if reorthogonalization:
            for i in range(j + 1):
                htmp = kdot(V[i], q)
                H[i, j] += _entry(htmp, cplx)
                q = q - htmp * V[i]
        hj = knorm(q)
        _chk(hj, allow_breakdown, f"h_{j + 2}.{j + 1}")
        H[j + 1, j] = float(hj)
        V.append(_unit(q, hj, FC))
    return torch.stack(V, dim=1), float(beta), _out(H, b)


@_fp32
def golub_kahan(A, b, k, allow_breakdown=False):
    """V, U, β₁, L: Golub–Kahan bidiagonalisation (reference :323-402),
    L the (k+1) × (k+1) lower bidiagonal [α₁; β₂ α₂; ...]."""
    A, b = _inputs(A, b, adjoint=True)
    FC = b.dtype
    L = np.zeros((k + 1, k + 1), dtype=_np_dtype(real_dtype(FC)))
    beta1 = knorm(b)
    _chk(beta1, allow_breakdown, "β₁")
    U = [_unit(b, beta1, FC)]
    V = []
    beta = beta1
    for i in range(k + 1):
        p = A.rmatvec(U[i])
        if i >= 1:
            p = p - beta.to(FC) * V[i - 1]
        alpha = knorm(p)
        if i < k:
            _chk(alpha, allow_breakdown, f"α{i + 1}")
        L[i, i] = float(alpha)
        v = _unit(p, alpha, FC)
        V.append(v)
        if i < k:
            q = A.matvec(v) - alpha.to(FC) * U[i]
            beta = knorm(q)
            _chk(beta, allow_breakdown, f"β{i + 2}")
            L[i + 1, i] = float(beta)
            U.append(_unit(q, beta, FC))
    return (torch.stack(V, dim=1), torch.stack(U, dim=1), float(beta1),
            _out(L, b))


@_fp32
def saunders_simon_yip(A, b, c, k, allow_breakdown=False):
    """V, β₁, T, U, γ₁ᴴ, Tᴴ: orthogonal tridiagonalisation (reference
    :431-524)."""
    A, b, c = _inputs(A, b, c, adjoint=True)
    FC = b.dtype
    cplx = FC.is_complex
    Tm = np.zeros((k + 1, k), dtype=_np_dtype(FC))
    Th = np.zeros((k + 1, k), dtype=_np_dtype(FC))
    beta1 = knorm(b)
    gamma1 = knorm(c)
    _chk(beta1, allow_breakdown, "β₁")
    _chk(gamma1, allow_breakdown, "γ₁")
    V = [_unit(b, beta1, FC)]
    U = [_unit(c, gamma1, FC)]
    beta, gamma = beta1, gamma1
    for i in range(k):
        q = A.matvec(U[i])
        p = A.rmatvec(V[i])
        if i >= 1:
            q = q - gamma.to(FC) * V[i - 1]
            p = p - beta.to(FC) * U[i - 1]
        alpha = kdot(V[i], q)
        q = q - alpha * V[i]
        p = p - torch.conj(alpha) * U[i]
        beta_n = knorm(q)
        gamma_n = knorm(p)
        if i < k - 1:
            _chk(beta_n, allow_breakdown, f"β{i + 2}")
            _chk(gamma_n, allow_breakdown, f"γ{i + 2}")
        Tm[i, i] = _entry(alpha, cplx)
        Th[i, i] = np.conj(Tm[i, i])
        Tm[i + 1, i] = float(beta_n)
        Th[i + 1, i] = float(gamma_n)
        if i + 1 < k:
            Tm[i, i + 1] = float(gamma_n)
            Th[i, i + 1] = float(beta_n)
        V.append(_unit(q, beta_n, FC))
        U.append(_unit(p, gamma_n, FC))
        beta, gamma = beta_n, gamma_n
    return (torch.stack(V, dim=1), float(beta1), _out(Tm, b),
            torch.stack(U, dim=1), float(gamma1), _out(Th, b))


@_fp32
def montoison_orban(A, B, b, c, k, allow_breakdown=False,
                    reorthogonalization=False):
    """V, β, H, U, γ, F: orthogonal Hessenberg reduction of [0 A; B 0]
    (reference :555-627)."""
    A, b, c = _inputs(A, b, c)
    B = as_operator(B, device=b.device)
    FC = b.dtype
    cplx = FC.is_complex
    H = np.zeros((k + 1, k), dtype=_np_dtype(FC))
    F = np.zeros((k + 1, k), dtype=_np_dtype(FC))
    beta = knorm(b)
    gamma = knorm(c)
    _chk(beta, allow_breakdown, "β")
    _chk(gamma, allow_breakdown, "γ")
    V = [_unit(b, beta, FC)]
    U = [_unit(c, gamma, FC)]
    for j in range(k):
        q = A.matvec(U[j])
        p = B.matvec(V[j])
        for i in range(j + 1):
            hij = kdot(V[i], q)
            fij = kdot(U[i], p)
            H[i, j] = _entry(hij, cplx)
            F[i, j] = _entry(fij, cplx)
            q = q - hij * V[i]
            p = p - fij * U[i]
        if reorthogonalization:
            for i in range(j + 1):
                htmp = kdot(V[i], q)
                ftmp = kdot(U[i], p)
                H[i, j] += _entry(htmp, cplx)
                F[i, j] += _entry(ftmp, cplx)
                q = q - htmp * V[i]
                p = p - ftmp * U[i]
        hj = knorm(q)
        fj = knorm(p)
        _chk(hj, allow_breakdown, f"h_{j + 2}.{j + 1}")
        _chk(fj, allow_breakdown, f"f_{j + 2}.{j + 1}")
        H[j + 1, j] = float(hj)
        F[j + 1, j] = float(fj)
        V.append(_unit(q, hj, FC))
        U.append(_unit(p, fj, FC))
    return (torch.stack(V, dim=1), float(beta), _out(H, b),
            torch.stack(U, dim=1), float(gamma), _out(F, b))


# ---------------------------------------------------------------------------
# the block variants (reference src/block_krylov_processes.jl)
# ---------------------------------------------------------------------------

def _block_qr(W, algo="householder"):
    """Reduced QR of a tall n × p block (reference block_krylov_utils.jl:
    125-160).

    ``algo``: "householder" (the default; also "givens", which gives the
    same factors) takes ``torch.linalg.qr``; "gs" (classical) and "mgs"
    (modified Gram–Schmidt) loop over the p columns."""
    if algo in ("householder", "givens"):
        return torch.linalg.qr(W)
    if algo not in ("gs", "mgs"):
        raise ValueError(f"unknown block QR algo: {algo!r}")
    p = W.shape[1]
    FC = W.dtype
    cols, rows = [], []
    for j in range(p):
        v = W[:, j]
        rj = torch.zeros(p, dtype=FC, device=W.device)
        if j > 0:
            if algo == "gs":
                Qj = torch.stack(cols, dim=1)
                coef = Qj.conj().T @ v
                v = v - Qj @ coef
            else:
                coefs = []
                for i in range(j):
                    ci = kdot(cols[i], v)
                    v = v - ci * cols[i]
                    coefs.append(ci)
                coef = torch.stack(coefs)
            rj[:j] = coef
        nrm = torch.linalg.norm(v)
        rj[j] = nrm.to(FC)
        cols.append(_unit(v, nrm, FC))
        rows.append(rj)
    return torch.stack(cols, dim=1), torch.stack(rows, dim=0).T


def _blk(M):
    return M.resolve_conj().cpu().numpy()


@_fp32
def block_hermitian_lanczos(A, B, k, algo="householder"):
    """V (n, (k+1)p), Ψ₁ (p, p), T ((k+1)p, kp) (reference :20-117)."""
    A, B = _inputs(A, B)
    p = B.shape[1]
    T = np.zeros(((k + 1) * p, k * p), dtype=_np_dtype(B.dtype))
    V1, Psi1 = _block_qr(B, algo)
    Vs = [V1]
    Psi_prev = None
    for i in range(k):
        Q = A.matmat(Vs[i])
        if i >= 1:
            Q = Q - Vs[i - 1] @ Psi_prev.mH
        Omega = Vs[i].mH @ Q
        Q = Q - Vs[i] @ Omega
        Vn, Psi = _block_qr(Q, algo)
        T[i * p:(i + 1) * p, i * p:(i + 1) * p] = _blk(Omega)
        T[(i + 1) * p:(i + 2) * p, i * p:(i + 1) * p] = _blk(Psi)
        if i + 1 < k:
            T[i * p:(i + 1) * p, (i + 1) * p:(i + 2) * p] = _blk(Psi.mH)
        Vs.append(Vn)
        Psi_prev = Psi
    return torch.cat(Vs, dim=1), Psi1, _out(T, B)


@_fp32
def block_arnoldi(A, B, k, algo="householder", reorthogonalization=False):
    """V, Γ, H: block Arnoldi (reference :249-325)."""
    A, B = _inputs(A, B)
    p = B.shape[1]
    H = np.zeros(((k + 1) * p, k * p), dtype=_np_dtype(B.dtype))
    V1, Gamma = _block_qr(B, algo)
    Vs = [V1]
    for j in range(k):
        Q = A.matmat(Vs[j])
        for i in range(j + 1):
            Hij = Vs[i].mH @ Q
            H[i * p:(i + 1) * p, j * p:(j + 1) * p] = _blk(Hij)
            Q = Q - Vs[i] @ Hij
        if reorthogonalization:
            for i in range(j + 1):
                Htmp = Vs[i].mH @ Q
                H[i * p:(i + 1) * p, j * p:(j + 1) * p] += _blk(Htmp)
                Q = Q - Vs[i] @ Htmp
        Vn, Hj = _block_qr(Q, algo)
        H[(j + 1) * p:(j + 2) * p, j * p:(j + 1) * p] = _blk(Hj)
        Vs.append(Vn)
    return torch.cat(Vs, dim=1), Gamma, _out(H, B)


@_fp32
def block_golub_kahan(A, B, k, algo="householder"):
    """V, U, Ψ₁, L: block Golub–Kahan (reference :326-441)."""
    A, B = _inputs(A, B, adjoint=True)
    p = B.shape[1]
    L = np.zeros(((k + 1) * p, (k + 1) * p), dtype=_np_dtype(B.dtype))
    U1, Psi1 = _block_qr(B, algo)
    Us = [U1]
    Vs = []
    TT = None
    for i in range(k + 1):
        P = A.rmatmat(Us[i])
        if i >= 1:
            P = P - Vs[i - 1] @ TT.mH
        Vn, Omega = _block_qr(P, algo)
        L[i * p:(i + 1) * p, i * p:(i + 1) * p] = _blk(Omega.mH)
        Vs.append(Vn)
        if i < k:
            Q = A.matmat(Vn) - Us[i] @ Omega.mH
            Un, TT = _block_qr(Q, algo)
            L[(i + 1) * p:(i + 2) * p, i * p:(i + 1) * p] = _blk(TT)
            Us.append(Un)
    return torch.cat(Vs, dim=1), torch.cat(Us, dim=1), Psi1, _out(L, B)


@_fp32
def block_nonhermitian_lanczos(A, B, C, k, algo="householder"):
    """Block bi-Lanczos (reference :118-248): V blocks orthonormal by QR,
    U blocks scaled so that UᵢᴴVᵢ = I, the off-diagonal coefficients as
    explicit biorthogonal projections."""
    A, B, C = _inputs(A, B, C, adjoint=True)
    p = B.shape[1]
    T = np.zeros(((k + 1) * p, k * p), dtype=_np_dtype(B.dtype))
    Th = np.zeros_like(T)
    V1, Psi1 = _block_qr(B, algo)
    D1 = C.mH @ V1
    U1 = C @ torch.linalg.inv(D1.mH)
    Vs, Us = [V1], [U1]
    for i in range(k):
        Q = A.matmat(Vs[i])
        P = A.rmatmat(Us[i])
        if i >= 1:
            Gm = Us[i - 1].mH @ Q
            Bm = Vs[i - 1].mH @ P
            Q = Q - Vs[i - 1] @ Gm
            P = P - Us[i - 1] @ Bm
            T[(i - 1) * p:i * p, i * p:(i + 1) * p] = _blk(Gm)
            Th[(i - 1) * p:i * p, i * p:(i + 1) * p] = _blk(Bm)
        Omega = Us[i].mH @ Q
        OmegaH = Vs[i].mH @ P
        Q = Q - Vs[i] @ Omega
        P = P - Us[i] @ OmegaH
        T[i * p:(i + 1) * p, i * p:(i + 1) * p] = _blk(Omega)
        Th[i * p:(i + 1) * p, i * p:(i + 1) * p] = _blk(OmegaH)
        Vn, beta_n = _block_qr(Q, algo)
        Dn = P.mH @ Vn
        Un = P @ torch.linalg.inv(Dn.mH)
        T[(i + 1) * p:(i + 2) * p, i * p:(i + 1) * p] = _blk(beta_n)
        Th[(i + 1) * p:(i + 2) * p, i * p:(i + 1) * p] = _blk(Dn.mH)
        Vs.append(Vn)
        Us.append(Un)
    return (torch.cat(Vs, dim=1), Psi1, _out(T, B), torch.cat(Us, dim=1),
            D1.mH, _out(Th, B))


@_fp32
def block_saunders_simon_yip(A, B, C, k, algo="householder"):
    """Block SSY tridiagonalisation (reference :442-582)."""
    A, B, C = _inputs(A, B, C, adjoint=True)
    p = B.shape[1]
    T = np.zeros(((k + 1) * p, k * p), dtype=_np_dtype(B.dtype))
    Th = np.zeros_like(T)
    V1, Psi1 = _block_qr(B, algo)
    U1, Phi1 = _block_qr(C, algo)
    Vs, Us = [V1], [U1]
    beta_prev = gamma_prev = None
    for i in range(k):
        Q = A.matmat(Us[i])
        P = A.rmatmat(Vs[i])
        if i >= 1:
            Q = Q - Vs[i - 1] @ gamma_prev.mH
            P = P - Us[i - 1] @ beta_prev.mH
        Omega = Vs[i].mH @ Q
        Q = Q - Vs[i] @ Omega
        P = P - Us[i] @ Omega.mH
        Vn, beta_n = _block_qr(Q, algo)
        Un, gamma_n = _block_qr(P, algo)
        T[i * p:(i + 1) * p, i * p:(i + 1) * p] = _blk(Omega)
        Th[i * p:(i + 1) * p, i * p:(i + 1) * p] = _blk(Omega.mH)
        T[(i + 1) * p:(i + 2) * p, i * p:(i + 1) * p] = _blk(beta_n)
        Th[(i + 1) * p:(i + 2) * p, i * p:(i + 1) * p] = _blk(gamma_n)
        if i + 1 < k:
            T[i * p:(i + 1) * p, (i + 1) * p:(i + 2) * p] = _blk(
                gamma_n.mH)
            Th[i * p:(i + 1) * p, (i + 1) * p:(i + 2) * p] = _blk(
                beta_n.mH)
        beta_prev, gamma_prev = beta_n, gamma_n
        Vs.append(Vn)
        Us.append(Un)
    return (torch.cat(Vs, dim=1), Psi1, _out(T, B), torch.cat(Us, dim=1),
            Phi1, _out(Th, B))


@_fp32
def block_montoison_orban(A, B, D, C, k, algo="householder",
                          reorthogonalization=False):
    """Block orthogonal Hessenberg reduction (reference :583-666).  The
    arguments are (A, B, D, C): the operators A and B, then the blocks D
    (for V) and C (for U).  ``reorthogonalization`` is accepted and, as
    in the JAX package, not used."""
    A, D, C = _inputs(A, D, C)
    B = as_operator(B, device=D.device)
    p = D.shape[1]
    H = np.zeros(((k + 1) * p, k * p), dtype=_np_dtype(D.dtype))
    F = np.zeros_like(H)
    V1, Gamma = _block_qr(D, algo)
    U1, Lambda = _block_qr(C, algo)
    Vs, Us = [V1], [U1]
    for j in range(k):
        Q = A.matmat(Us[j])
        P = B.matmat(Vs[j])
        for i in range(j + 1):
            Hij = Vs[i].mH @ Q
            Fij = Us[i].mH @ P
            H[i * p:(i + 1) * p, j * p:(j + 1) * p] = _blk(Hij)
            F[i * p:(i + 1) * p, j * p:(j + 1) * p] = _blk(Fij)
            Q = Q - Vs[i] @ Hij
            P = P - Us[i] @ Fij
        Vn, Hj = _block_qr(Q, algo)
        Un, Fj = _block_qr(P, algo)
        H[(j + 1) * p:(j + 2) * p, j * p:(j + 1) * p] = _blk(Hj)
        F[(j + 1) * p:(j + 2) * p, j * p:(j + 1) * p] = _blk(Fj)
        Vs.append(Vn)
        Us.append(Un)
    return (torch.cat(Vs, dim=1), Gamma, _out(H, D), torch.cat(Us, dim=1),
            Lambda, _out(F, D))
