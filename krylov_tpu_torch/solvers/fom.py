"""FOM, DIOM and DQGMRES for square non-Hermitian Ax = b.

Counterpart of ``krylov_tpu/solvers/fom.py``.  FOM (reference
src/fom.jl): the full orthogonalization method, Arnoldi with
an LU factorisation of the Hessenberg (uᵢ.ₖ = hᵢ.ₖ − lᵢ₋₁uᵢ₋₁.ₖ,
reference src/fom.jl:274-280), M and N preconditioning, restarts,
reorthogonalization, warm start, history, callback, verbose and the
breakdown status "inconsistent linear system".  The general route
shares the Arnoldi process of ``solvers/gmres.py`` (CGS2 against the
whole panel, the factorisation's scalars on the host); a DIA operator
with M = N = I and the default options goes to the whole-solve kernel
(ops/cuda_fused.py).

DIOM and DQGMRES (reference src/diom.jl, src/dqgmres.jl): truncated
FOM and GMRES over circular rings of mem = max(memory, 2) basis vectors
V and mem − 1 (DIOM) or mem (DQGMRES) update directions P.  Each
iteration orthogonalises A vₖ against the ring by classical
Gram-Schmidt over its valid slots (dots against the unmodified w, then
one subtraction), runs the diagonal-indexed Hessenberg column through
DIOM's LU pivots or DQGMRES's rotation ring on the host (one read of
the column per iteration, as GMRES's general route), and moves x along
the new direction pₖ.  A DIA operator with M = N = I and the default
options goes to the whole-solve kernel ``trunc_dia_fused``.
"""

import time
from typing import NamedTuple

import numpy as np
import torch

from .. import _runtime as rt
from .._dtypes import real_dtype
from ..operators import as_operator, precond_apply, solve_inputs
from ..ops.cuda_fused import (INCONS_FOM, fom_dia_fused,
                               fom_dia_fused_supported, trunc_dia_fused,
                               trunc_dia_fused_supported)
from ..ops.kops import knorm, sym_givens
from ..stats import SimpleStats
from .cr import _check_square, _fused_ready, _no_double_word, _trim
from .gmres import (arnoldi_drive, back_substitute, fc_round, first_basis,
                    host_dtype, host_dtypes, host_numpy, orthogonalize)

_FOM_STATUS = {INCONS_FOM: "inconsistent linear system"}


class FomState(NamedTuple):
    x: torch.Tensor
    V: torch.Tensor          # (mem, n) Krylov basis
    U: torch.Tensor          # (mem, mem) upper factor, host
    l: torch.Tensor          # (mem,) subdiagonal multipliers, host
    z: torch.Tensor          # (mem,) forward-substituted rhs, host
    inner_k: int
    iter: int
    npass: int
    rNorm: float
    eps_lim: float
    status: int
    inconsistent: bool
    hist_r: torch.Tensor
    f_resid: bool
    f_break: bool


def _fom_core(
    A, M, N, b, x0, state_in, iter_cap, steps, itmax, atol, rtol,
    *, mem, ldiv, restart, reorthogonalization, history, hist_len,
    callback, verbose, NisI,
):
    """``steps`` FOM iterations from ``state_in`` (None: start)."""
    n = b.shape[0]
    FC = b.dtype
    T = real_dtype(FC)
    dev = b.device
    btol = torch.finfo(T).eps ** 0.75
    np_fc, np_t = host_dtypes(FC)
    HC = host_dtype(FC)

    def rnd(v):
        return fc_round(v, FC)

    def M_apply(u):
        return precond_apply(M, u, ldiv)

    def N_apply(u):
        return precond_apply(N, u, ldiv)

    if state_in is None:
        x = x0.clone() if (restart and x0 is not None) else \
            torch.zeros(n, dtype=FC, device=dev)
        V, beta = first_basis(M_apply, b if x0 is None else
                              b - A.matvec(x0), mem)
        eps_lim = float(np_t.type(atol) + np_t.type(rtol) * np_t.type(beta))
        status = (rt.ZERO_RESIDUAL if beta == 0
                  else rt.SOLVED if beta <= eps_lim else rt.RUNNING)
        z = torch.zeros(mem, dtype=HC)
        z[0] = beta
        hist = rt.hist_init(hist_len, T, dev)
        rt.hist_write(hist, torch.tensor(0, device=dev),
                      torch.tensor(beta, dtype=T, device=dev), history)
        state_in = FomState(
            x=x, V=V, U=torch.zeros((mem, mem), dtype=HC),
            l=torch.zeros(mem, dtype=HC), z=z, inner_k=0, iter=0, npass=1,
            rNorm=beta, eps_lim=eps_lim, status=status, inconsistent=False,
            hist_r=hist, f_resid=False, f_break=False)

    def step(s):
        k = s.inner_k
        q = M_apply(A.matvec(N_apply(s.V[k])))
        q, hcol = orthogonalize(s.V, q, reorthogonalization)
        hbis = knorm(q)
        u = host_numpy(torch.cat([hcol, hbis.reshape(1).to(FC)]))
        hbis = u[mem].real.astype(np_t)
        l, z, U = s.l.numpy(), s.z.numpy(), s.U.numpy()
        for i in range(1, k + 1):
            u[i] = rnd(u[i] - l[i - 1] * u[i - 1])
        safe_u = u[k] if u[k] != 0 else np_fc.type(1)
        if k >= 1:
            z[k] = rnd(-l[k - 1] * z[k - 1])
        l[k] = rnd(np_fc.type(hbis) / safe_u)
        U[:k + 1, k] = u[:k + 1]
        rnorm = float(hbis * np.abs(z[k] / safe_u).astype(np_t))
        it, kk = s.iter + 1, k + 1
        resid = rnorm <= s.eps_lim or (np_t.type(rnorm) + 1) <= 1
        brk = bool(hbis <= btol)
        inner_done = resid or brk or it >= itmax or kk >= mem
        V = s.V
        if not inner_done:
            V[kk % mem] = q / torch.tensor(1 if hbis == 0 else hbis,
                                           dtype=T).to(FC)
        rt.hist_write(s.hist_r, torch.tensor(it, device=dev),
                      torch.tensor(rnorm, dtype=T, device=dev), history)
        if verbose > 0:
            rt.debug_row(verbose, it, "{:5d}  {:5.0f}  {:7.1e}", s.npass,
                         rnorm)
        return s._replace(V=V, inner_k=kk, iter=it, rNorm=rnorm,
                          f_resid=resid, f_break=brk), inner_done

    def epilogue(s):
        tired = s.iter >= itmax
        glob_done = s.f_resid or s.f_break or tired
        y, _ = back_substitute(s.U, s.z, s.inner_k, FC=FC)
        xr = s.V.T @ y.to(dev, FC)
        if not NisI:
            xr = N_apply(xr)
        x = s.x + xr
        out = dict(x=x, inner_k=0, f_resid=False, f_break=False,
                   inconsistent=s.inconsistent
                   or (s.f_break and not s.f_resid))
        if glob_done:
            code = rt.TIRED
            code = INCONS_FOM if s.f_break else code
            out["status"] = rt.SOLVED if s.f_resid else code
        else:
            V, beta = first_basis(M_apply, b - A.matvec(x), mem)
            z = torch.zeros_like(s.z)
            z[0] = beta
            out.update(V=V, z=z, U=torch.zeros_like(s.U),
                       l=torch.zeros_like(s.l), npass=s.npass + 1,
                       rNorm=beta)
        return s._replace(**out)

    return arnoldi_drive(state_in, iter_cap, steps, step, epilogue, callback)


def _fom_solve(
    A, b, x0=None, *, M=None, N=None, ldiv=False, restart=False,
    reorthogonalization=False, memory=20, atol=None, rtol=None, itmax=0,
    timemax=float("inf"), verbose=0, history=False, callback=None,
    memory_cap=512,
):
    start = time.perf_counter()
    A, b, x0, M = solve_inputs(A, b, x0, M)
    N = as_operator(N, device=b.device)
    n = b.shape[0]
    _check_square(A, n)
    T = real_dtype(b.dtype)
    atol = rt.default_tol(atol, T)
    rtol = rt.default_tol(rtol, T)
    itmax = rt.resolve_itmax(itmax, 2 * n)
    rt.debug_table(verbose, "FOM", ("k", "pass", "‖rₖ‖"), n)
    mem = min(int(memory), itmax) if restart else min(itmax, memory_cap)
    mem = max(mem, 2)
    hist_len = itmax + 1 if history else 0
    eff_restart = bool(restart) or mem < itmax

    # Fast path: DIA stencil + default config → whole-solve kernel.
    if (M is None and N is None and not history and callback is None
            and verbose == 0 and not reorthogonalization
            and timemax == float("inf")
            and _fused_ready(A, n, b.dtype, fom_dia_fused_supported)):
        b_eff = (b if x0 is None else b - A.matvec(x0)).contiguous()
        x, niter, _, code_d, incons, _ = fom_dia_fused(
            A._pd, A._offsets, b_eff, atol, rtol, itmax, mem)
        niter, code, incons = torch.stack([niter, code_d, incons]).tolist()
        code = rt.final_status_code(code, niter, itmax, False)
        if x0 is not None:
            x = x + x0
        stats = SimpleStats(
            niter=niter,
            solved=rt.is_solved_code(code),
            inconsistent=bool(incons),
            residuals=np.zeros(0),
            timer=time.perf_counter() - start,
            status=rt.decode_status(code, _FOM_STATUS),
        )
        return x, stats, None

    def run(state, cap, steps):
        return _fom_core(
            A, M, N, b, x0, state, cap, steps, itmax, atol, rtol, mem=mem,
            ldiv=bool(ldiv), restart=eff_restart,
            reorthogonalization=bool(reorthogonalization),
            history=bool(history), hist_len=hist_len, callback=callback,
            verbose=int(verbose), NisI=N is None,
        )

    state, overtimed = rt.drive(run, itmax, timemax, start)
    niter = state.iter
    code = rt.final_status_code(state.status, niter, itmax, overtimed)
    x = state.x
    if x0 is not None and not eff_restart:
        x = x + x0
    stats = SimpleStats(
        niter=niter,
        solved=rt.is_solved_code(code),
        inconsistent=bool(state.inconsistent),
        residuals=_trim(state.hist_r, niter, history),
        timer=time.perf_counter() - start,
        status=rt.decode_status(code, _FOM_STATUS),
    )
    return x, stats, state


def fom(A, b, x0=None, *, precision=None, **kwargs):
    """x, stats = fom(A, b; memory=20, restart=False, ...).

    ``precision="double_word"`` raises NotImplementedError until the
    iterative refinement (solvers/_refine.py, ROADMAP.md Queue 1 item 8)
    is ported."""
    _no_double_word("FOM", precision)
    x, stats, _ = _fom_solve(A, b, x0, **kwargs)
    return x, stats


# ---------------------------------------------------------------------------
# DIOM / DQGMRES — truncated-memory methods with circular rings.
# ---------------------------------------------------------------------------

class TruncState(NamedTuple):
    x: torch.Tensor
    V: torch.Tensor          # (mem, n) circular basis
    P: torch.Tensor          # (mP, n) circular update directions
    L: np.ndarray            # diom: (mem,) pivots; dqgmres: (mem,) cosines
    Ssin: np.ndarray         # dqgmres: (mem,) sines; diom: unused (0,)
    xi: object               # diom: ξₖ; dqgmres: γₖ (host scalar, FC)
    rNorm: float
    eps_lim: float
    iter: int
    status: int
    hist_r: torch.Tensor


def _ring_window_dots(V, w, k, mem):
    """⟨vᵢ, w⟩ for every valid ring slot (the slot's index i = k − ((k
    mod mem) − j) mod mem is ≥ 0), zero elsewhere; returns (h_slots,
    i_idx, valid), h on w's device, i_idx and valid on the host."""
    j = np.arange(mem)
    i_idx = k - np.mod(np.mod(k, mem) - j, mem)
    valid = i_idx >= 0
    h = torch.conj(V) @ w
    h = torch.where(torch.as_tensor(valid, device=w.device), h,
                    torch.zeros_like(h))
    return h, i_idx, valid


def _trunc_column(diom, H, Haux, L, Ssin, xi, k, mem, np_fc, np_t, FC):
    """The Hessenberg column's recurrence on the host, in place on the
    column H (mem + 2, diagonal-indexed: H[k − i + 1] is row i) and the
    rings L, Ssin (krylov_tpu/solvers/fom.py:467-541, as a sequential
    loop), each stored value rounded to FC (``fc_round``).  Returns
    (gamma_step, rNorm, xi_next, denom)."""
    def rnd(v):
        return fc_round(v, FC)

    it1 = k + 1
    if diom:
        # LU column update (reference src/diom.jl:251-266)
        for i in range(max(2, it1 - mem + 2), it1 + 1):
            diag = it1 - i + 1
            H[diag] = rnd(H[diag] - L[(i - 1) % (mem - 1)] * H[diag + 1])
        if it1 >= 2:
            xi = rnd(-L[(it1 - 1) % (mem - 1)] * xi)
        ukk = H[1]
        safe_u = np_fc.type(1) if ukk == 0 else ukk
        L[it1 % (mem - 1)] = rnd(np_fc.type(Haux) / safe_u)
        rnorm = Haux * np.abs(xi / safe_u).astype(np_t)
        return xi, rnorm, xi, safe_u
    # previous rotations (reference src/dqgmres.jl:257-266): row i sits
    # at diag + 1 and row i + 1 at diag
    for i in range(max(1, it1 - mem), it1):
        slot = (i - 1) % mem
        diag = it1 - i
        ci, si = L[slot], Ssin[slot]
        hi, hi1 = H[diag + 1], H[diag]
        H[diag + 1] = rnd(ci * hi + si * hi1)
        H[diag] = rnd(np.conj(si) * hi - ci * hi1)
    ck, sk, rkk = sym_givens(torch.tensor(H[1]).to(FC),
                             torch.tensor(np_fc.type(Haux)).to(FC))
    ck, sk, rkk = ck.real.item(), sk.item(), rkk.item()
    H[1] = rkk
    L[k % mem] = ck
    Ssin[k % mem] = sk
    gamma_next = rnd(np.conj(np_fc.type(sk)) * xi)
    gamma_k = rnd(np_fc.type(ck) * xi)
    rnorm = np.abs(gamma_next).astype(np_t)
    denom = np_fc.type(1) if H[1] == 0 else H[1]
    return gamma_k, rnorm, gamma_next, denom


def _trunc_core(
    A, M, N, b, x0, state_in, iter_cap, steps, atol, rtol,
    *, mem, ldiv, variant, reorthogonalization, history, hist_len,
    callback, verbose,
):
    """``steps`` DIOM or DQGMRES iterations from ``state_in`` (None:
    start); variant is 'diom' or 'dqgmres'."""
    n = b.shape[0]
    FC = b.dtype
    T = real_dtype(FC)
    dev = b.device
    np_fc, np_t = host_dtypes(FC)
    diom = variant == "diom"
    mP = (mem - 1) if diom else mem

    def M_apply(u):
        return precond_apply(M, u, ldiv)

    def N_apply(u):
        return precond_apply(N, u, ldiv)

    if state_in is None:
        V, beta = first_basis(M_apply, b if x0 is None else
                              b - A.matvec(x0), mem)
        eps_lim = float(np_t.type(atol) + np_t.type(rtol) * np_t.type(beta))
        status = (rt.ZERO_RESIDUAL if beta == 0
                  else rt.SOLVED if beta <= eps_lim else rt.RUNNING)
        hist = rt.hist_init(hist_len, T, dev)
        rt.hist_write(hist, torch.tensor(0, device=dev),
                      torch.tensor(beta, dtype=T, device=dev), history)
        state_in = TruncState(
            x=torch.zeros(n, dtype=FC, device=dev), V=V,
            P=torch.zeros((mP, n), dtype=FC, device=dev),
            L=np.zeros(mem, np_fc if diom else np_t),
            Ssin=np.zeros(0 if diom else mem, np_fc),
            xi=np_fc.type(beta), rNorm=beta, eps_lim=eps_lim, iter=0,
            status=status, hist_r=hist)

    def body(s):
        k = s.iter
        pos = k % mem
        vk = s.V[pos]
        z = N_apply(vk)
        w = M_apply(A.matvec(z))

        # window orthogonalization: CGS over the valid ring slots
        h_slots, i_idx, valid = _ring_window_dots(s.V, w, k, mem)
        w = w - s.V.T @ h_slots
        if reorthogonalization:
            h2, _, _ = _ring_window_dots(s.V, w, k, mem)
            h_slots = h_slots + h2
            w = w - s.V.T @ h2
        Haux = knorm(w)
        hv = host_numpy(torch.cat([h_slots, Haux.reshape(1).to(FC)]))
        Haux = hv[mem].real.astype(np_t)

        # diagonal-indexed column H[diag], diag = k − i + 1 ∈ [1, mem]
        H = np.zeros(mem + 2, np_fc)
        for j in range(mem):
            if valid[j]:
                H[k - i_idx[j] + 1] = fc_round(H[k - i_idx[j] + 1] + hv[j],
                                               FC)
        gamma_step, rnorm, xi_next, denom = _trunc_column(
            diom, H, Haux, s.L, s.Ssin, s.xi, k, mem, np_fc, np_t, FC)

        # direction pₖ from the P ring (sum over the window)
        jP = np.arange(mP)
        iP = (k - 1) - np.mod((k - 1) - jP, mP)
        lowP = (k - mem + 1) if diom else (k - mem)
        validP = (iP >= 0) & (iP >= lowP) & (iP <= k - 1)
        coef = np.where(validP, H[np.where(validP, k - iP + 1, 0)], 0)
        psum = s.P.T @ torch.as_tensor(coef.astype(np_fc), device=dev).to(FC)
        p_new = (z - psum) / torch.tensor(denom, device=dev)
        s.P[k % mP] = p_new
        x = s.x + torch.tensor(gamma_step, device=dev) * p_new

        # next basis vector (a lucky breakdown keeps the slot)
        if Haux != 0:
            s.V[(k + 1) % mem] = w / torch.tensor(Haux, dtype=T,
                                                  device=dev).to(FC)
        it = k + 1
        rnorm = float(rnorm)
        solved = rnorm <= s.eps_lim or (np_t.type(rnorm) + 1) <= 1
        rt.hist_write(s.hist_r, torch.tensor(it, device=dev),
                      torch.tensor(rnorm, dtype=T, device=dev), history)
        s_new = s._replace(x=x, xi=xi_next, rNorm=rnorm, iter=it,
                           status=rt.SOLVED if solved else rt.RUNNING)
        if verbose > 0:
            rt.debug_row(verbose, it, "{:5d}  {:7.1e}", rnorm)
        if callback is not None and bool(callback(s_new)) \
                and s_new.status == rt.RUNNING:
            s_new = s_new._replace(status=rt.USER_EXIT)
        return s_new

    s = state_in
    for _ in range(steps):
        if s.status != rt.RUNNING or s.iter >= iter_cap:
            break
        s = body(s)
    return s


def _trunc_solve(
    variant, A, b, x0=None, *, M=None, N=None, ldiv=False,
    reorthogonalization=False, memory=20, atol=None, rtol=None, itmax=0,
    timemax=float("inf"), verbose=0, history=False, callback=None,
):
    start = time.perf_counter()
    A, b, x0, M = solve_inputs(A, b, x0, M)
    N = as_operator(N, device=b.device)
    n = b.shape[0]
    _check_square(A, n)
    T = real_dtype(b.dtype)
    atol = rt.default_tol(atol, T)
    rtol = rt.default_tol(rtol, T)
    itmax = rt.resolve_itmax(itmax, 2 * n)
    rt.debug_table(verbose, variant.upper(), ("k", "‖rₖ‖"), n)
    mem = max(int(memory), 2)
    hist_len = itmax + 1 if history else 0

    # Fast path: DIA stencil + default config → whole-solve kernel.
    if (M is None and N is None and not history and callback is None
            and verbose == 0 and not reorthogonalization
            and timemax == float("inf")
            and _fused_ready(A, n, b.dtype, trunc_dia_fused_supported)):
        b_eff = (b if x0 is None else b - A.matvec(x0)).contiguous()
        x, niter, _, code_d = trunc_dia_fused(
            A._pd, A._offsets, b_eff, atol, rtol, itmax, mem=mem,
            variant=variant)
        niter, code = torch.stack([niter, code_d]).tolist()
        code = rt.final_status_code(code, niter, itmax, False)
        if x0 is not None:
            x = x + x0
        stats = SimpleStats(
            niter=niter,
            solved=rt.is_solved_code(code),
            inconsistent=False,
            residuals=np.zeros(0),
            timer=time.perf_counter() - start,
            status=rt.decode_status(code),
        )
        return x, stats, None

    def run(state, cap, steps):
        return _trunc_core(
            A, M, N, b, x0, state, cap, steps, atol, rtol, mem=mem,
            ldiv=bool(ldiv), variant=variant,
            reorthogonalization=bool(reorthogonalization),
            history=bool(history), hist_len=hist_len, callback=callback,
            verbose=int(verbose),
        )

    state, overtimed = rt.drive(run, itmax, timemax, start)
    niter = state.iter
    code = rt.final_status_code(state.status, niter, itmax, overtimed)
    x = state.x
    if x0 is not None:
        x = x + x0
    stats = SimpleStats(
        niter=niter,
        solved=rt.is_solved_code(code),
        inconsistent=False,
        residuals=_trim(state.hist_r, niter, history),
        timer=time.perf_counter() - start,
        status=rt.decode_status(code),
    )
    return x, stats, state


def diom(A, b, x0=None, *, precision=None, **kwargs):
    """x, stats = diom(A, b; memory=20, ...) — truncated FOM.

    ``precision="double_word"`` raises NotImplementedError until the
    iterative refinement (solvers/_refine.py, ROADMAP.md Queue 1 item 8)
    is ported."""
    _no_double_word("DIOM", precision)
    x, stats, _ = _trunc_solve("diom", A, b, x0, **kwargs)
    return x, stats


def dqgmres(A, b, x0=None, *, precision=None, **kwargs):
    """x, stats = dqgmres(A, b; memory=20, ...) — truncated GMRES.

    ``precision="double_word"`` raises NotImplementedError until the
    iterative refinement (solvers/_refine.py, ROADMAP.md Queue 1 item 8)
    is ported."""
    _no_double_word("DQGMRES", precision)
    x, stats, _ = _trunc_solve("dqgmres", A, b, x0, **kwargs)
    return x, stats
