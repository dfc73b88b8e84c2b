"""CGLS, CRLS and CGLS-Lanczos-shift: min ‖b − Ax‖² + λ‖x‖² through the
normal equations.

Counterpart of ``krylov_tpu/solvers/cgls.py`` and of reference
src/cgls.jl (λ Tikhonov, the trust-region ``radius``, the M
preconditioner; the stop on ‖Aᴴr‖ ≤ atol + rtol‖Aᴴr₀‖), src/crls.jl
(with the zero-curvature "psd" analysis of the trust region) and
src/cgls_lanczos_shift.jl (every min ‖b − Ax‖² + λᵢ‖x‖² from one Lanczos
stream on AᴴA, over the shift axis).  A may be rectangular or complex.
A DIA operator on the card with the default options goes to a
whole-solve kernel (ops/cuda_fused.py) on Aᴴ's aligned diagonals; every
other configuration runs the general core, whose iterations
``_runtime.drive`` takes in chunks with masked updates.
"""

import time
from typing import NamedTuple

import numpy as np
import torch

from .. import _runtime as rt
from .._dtypes import real_dtype
from ..operators import precond_apply
from ..ops.cuda_fused import (cgls_dia_fused, cgls_dia_fused_supported,
                              cgls_lanczos_shift_dia_fused,
                              cgls_lanczos_shift_dia_fused_supported,
                              crls_dia_fused, crls_dia_fused_supported)
from ..ops.kops import kdotr, knorm, to_boundary
from ..stats import LanczosShiftStats, SimpleStats
from .bilq import _exit, _safe
from .cr import _fused_ready, _i32, _masked, _no_double_word, _trim
from .lsqr import _ls_inputs
from .usymlq import _tol

PSD = 31  # "zero-curvature encountered"
_CRLS_STATUS = {PSD: "zero-curvature encountered"}


def _setup(name, A, b, M, atol, rtol, itmax, verbose):
    """(A, b, M, m, n, atol, rtol, itmax) of a CGLS or CRLS solve, with the
    verbose table's header."""
    A, b, M, _, m, n, _ = _ls_inputs(A, b, M, None, False, 0.0)
    T = real_dtype(b.dtype)
    rt.debug_table(verbose, name, ("k", "‖Aᴴr‖", "‖r‖"), m, n)
    return (A, b, M, m, n, rt.default_tol(atol, T), rt.default_tol(rtol, T),
            rt.resolve_itmax(itmax, m + n))


def _kernel_stats(code, niter, itmax, start, overrides=None):
    code = rt.final_status_code(code, niter, itmax, False)
    return SimpleStats(
        niter=niter, solved=rt.is_solved_code(code), inconsistent=False,
        residuals=np.zeros(0), Aresiduals=np.zeros(0),
        timer=time.perf_counter() - start,
        status=rt.decode_status(code, overrides))


# ---------------------------------------------------------------------------
# CGLS (reference src/cgls.jl)
# ---------------------------------------------------------------------------

class CglsState(NamedTuple):
    x: torch.Tensor
    r: torch.Tensor
    p: torch.Tensor
    s: torch.Tensor
    gamma: torch.Tensor
    rNorm: torch.Tensor
    ArNorm: torch.Tensor
    eps_lim: torch.Tensor
    iter: torch.Tensor
    status: torch.Tensor
    hist_r: torch.Tensor
    hist_ar: torch.Tensor


def _cgls_core(
    A, M, b, state_in, iter_cap, steps, atol, rtol, lam, radius,
    *, ldiv, history, hist_len, callback, verbose, use_radius,
):
    """``steps`` CGLS iterations from ``state_in`` (None: start), each with
    its updates masked by ``status == RUNNING and iter < iter_cap``
    (krylov_tpu/solvers/cgls.py:50-150)."""
    n = A.shape[1]
    FC = b.dtype
    T = real_dtype(FC)
    dev = b.device
    zero = torch.zeros((), dtype=T, device=dev)
    lam = _tol(lam, T, dev)
    lam_eff = torch.where(lam > 0, lam, zero)
    radius = _tol(radius, T, dev)

    def M_apply(t):
        return precond_apply(M, t, ldiv)

    if state_in is None:
        bNorm = knorm(b)
        sv = A.rmatvec(M_apply(b))
        gamma = kdotr(sv, sv)
        ArNorm = torch.sqrt(gamma)
        eps_lim = _tol(atol, T, dev) + _tol(rtol, T, dev) * ArNorm
        status = torch.where(bNorm == 0, rt.ZERO_RESIDUAL, torch.where(
            ArNorm <= eps_lim, rt.SOLVED, rt.RUNNING)).to(torch.int32)
        state_in = CglsState(
            x=torch.zeros(n, dtype=FC, device=dev), r=b, p=sv, s=sv,
            gamma=gamma, rNorm=bNorm, ArNorm=ArNorm, eps_lim=eps_lim,
            iter=_i32(0, dev), status=status,
            hist_r=rt.hist_write(rt.hist_init(hist_len, T, dev),
                                 _i32(0, dev), bNorm, history),
            hist_ar=rt.hist_write(rt.hist_init(hist_len, T, dev),
                                  _i32(0, dev), ArNorm, history))

    def body(s):
        active = (s.status == rt.RUNNING) & (s.iter < iter_cap)
        q = A.matvec(s.p)
        delta = kdotr(q, M_apply(q)) + torch.where(
            lam > 0, lam * kdotr(s.p, s.p), zero)
        alpha = s.gamma / _safe(delta)
        on_boundary = torch.zeros((), dtype=torch.bool, device=dev)
        if use_radius:
            t1, t2 = to_boundary(s.x, s.p, radius)
            sigma = torch.maximum(t1, t2)
            on_boundary = alpha > sigma
            alpha = torch.where(on_boundary, sigma, alpha)
        x = s.x + alpha.to(FC) * s.p
        r = s.r - alpha.to(FC) * q
        sv = A.rmatvec(M_apply(r)) - lam_eff.to(FC) * x
        gamma = kdotr(sv, sv)
        p = sv + (gamma / _safe(s.gamma)).to(FC) * s.p
        rNorm = knorm(r)
        ArNorm = torch.sqrt(gamma)
        it = s.iter + 1
        code = torch.where(on_boundary, rt.ON_BOUNDARY, torch.where(
            ArNorm <= s.eps_lim, rt.SOLVED, rt.RUNNING)).to(torch.int32)
        rt.hist_write_masked(s.hist_r, active, it, rNorm, history)
        rt.hist_write_masked(s.hist_ar, active, it, ArNorm, history)
        s_new = s._replace(x=x, r=r, p=p, s=sv, gamma=gamma, rNorm=rNorm,
                           ArNorm=ArNorm, iter=it, status=code)
        if verbose > 0 and bool(active):
            rt.debug_row(verbose, it, "{:5d}  {:8.1e}  {:8.1e}", ArNorm,
                         rNorm)
        if callback is not None:
            s_new = _exit(callback, s_new, dev)
        return _masked(CglsState._fields, active, s_new, s)

    return rt.take_steps(body, state_in, steps, iter_cap, callback)


def _cgls_solve(
    A, b, *, M=None, ldiv=False, lam=0.0, radius=0.0, atol=None, rtol=None,
    itmax=0, timemax=float("inf"), verbose=0, history=False, callback=None,
):
    start = time.perf_counter()
    A, b, M, m, n, atol, rtol, itmax = _setup("CGLS", A, b, M, atol, rtol,
                                              itmax, verbose)
    hist_len = itmax + 1 if history else 0

    # Fast path: DIA stencil + default config → whole-solve kernel.
    if (M is None and radius == 0 and not history and callback is None
            and verbose == 0 and timemax == float("inf")
            and _fused_ready(A, m, b.dtype, cgls_dia_fused_supported)):
        pd_adj, ot_adj = A.aligned_adjoint_kernel_args()
        x, niter, _, _, code_d = cgls_dia_fused(
            A._pd, pd_adj, A._offsets, ot_adj, b.contiguous(), float(lam),
            atol, rtol, itmax)
        niter, code = torch.stack([niter, code_d]).tolist()
        return x, _kernel_stats(code, niter, itmax, start), None

    def run(state, cap, steps):
        return _cgls_core(
            A, M, b, state, cap, steps, atol, rtol, float(lam),
            float(radius), ldiv=bool(ldiv), history=bool(history),
            hist_len=hist_len, callback=callback, verbose=int(verbose),
            use_radius=radius > 0)

    state, overtimed = rt.drive(run, itmax, timemax, start)
    niter = int(state.iter)
    code = rt.final_status_code(state.status, niter, itmax, overtimed)
    stats = SimpleStats(
        niter=niter, solved=rt.is_solved_code(code), inconsistent=False,
        residuals=_trim(state.hist_r, niter, history),
        Aresiduals=_trim(state.hist_ar, niter, history),
        timer=time.perf_counter() - start, status=rt.decode_status(code))
    return state.x, stats, state


def cgls(A, b, *, precision=None, **kwargs):
    """x, stats = cgls(A, b; λ, radius, M, ...) — min ‖b − Ax‖² + λ‖x‖².

    ``precision="double_word"`` raises NotImplementedError until the
    iterative refinement (solvers/_refine.py, ROADMAP.md Queue 1 item 8)
    is ported."""
    _no_double_word("CGLS", precision)
    x, stats, _ = _cgls_solve(A, b, **kwargs)
    return x, stats


# ---------------------------------------------------------------------------
# CRLS (reference src/crls.jl)
# ---------------------------------------------------------------------------

class CrlsState(NamedTuple):
    x: torch.Tensor
    r: torch.Tensor
    Ar: torch.Tensor
    p: torch.Tensor
    Ap: torch.Tensor
    q: torch.Tensor
    s: torch.Tensor
    gamma: torch.Tensor
    rNorm: torch.Tensor
    ArNorm: torch.Tensor
    eps_lim: torch.Tensor
    iter: torch.Tensor
    status: torch.Tensor
    hist_r: torch.Tensor
    hist_ar: torch.Tensor


def _crls_core(
    A, M, b, state_in, iter_cap, steps, atol, rtol, lam, radius,
    *, ldiv, history, hist_len, callback, verbose, use_radius,
):
    """``steps`` CRLS iterations from ``state_in`` (None: start), each with
    its updates masked by ``status == RUNNING and iter < iter_cap``; a
    trust-region exit (psd or the boundary) skips the continuation
    updates, as the reference's ``continue`` (krylov_tpu/solvers/
    cgls.py:255-385)."""
    n = A.shape[1]
    FC = b.dtype
    T = real_dtype(FC)
    dev = b.device
    zero = torch.zeros((), dtype=T, device=dev)
    lam = _tol(lam, T, dev)
    lam_eff = torch.where(lam > 0, lam, zero)
    radius = _tol(radius, T, dev)

    def M_apply(t):
        return precond_apply(M, t, ldiv)

    if state_in is None:
        rNorm = knorm(b)
        Ar = A.rmatvec(M_apply(b))
        sv = A.matvec(Ar)
        Ms = M_apply(sv)
        q = A.rmatvec(Ms) + lam_eff.to(FC) * Ar
        ArNorm = knorm(Ar)
        gamma = kdotr(sv, Ms) + torch.where(lam > 0, lam * ArNorm * ArNorm,
                                            zero)
        eps_lim = _tol(atol, T, dev) + _tol(rtol, T, dev) * ArNorm
        status = torch.where(rNorm == 0, rt.ZERO_RESIDUAL, torch.where(
            ArNorm <= eps_lim, rt.SOLVED, rt.RUNNING)).to(torch.int32)
        state_in = CrlsState(
            x=torch.zeros(n, dtype=FC, device=dev), r=b, Ar=Ar, p=Ar, Ap=sv,
            q=q, s=sv, gamma=gamma, rNorm=rNorm, ArNorm=ArNorm,
            eps_lim=eps_lim, iter=_i32(0, dev), status=status,
            hist_r=rt.hist_write(rt.hist_init(hist_len, T, dev),
                                 _i32(0, dev), rNorm, history),
            hist_ar=rt.hist_write(rt.hist_init(hist_len, T, dev),
                                  _i32(0, dev), ArNorm, history))

    def body(s):
        active = (s.status == rt.RUNNING) & (s.iter < iter_cap)
        qNorm2 = kdotr(s.q, s.q)
        alpha = s.gamma / _safe(qNorm2)
        p_sel, q_sel = s.p, s.q
        false = torch.zeros((), dtype=torch.bool, device=dev)
        psd = on_boundary = false
        if use_radius:
            pNorm = knorm(s.p)
            psd = kdotr(s.Ap, s.Ap) <= s.eps_lim * torch.sqrt(qNorm2) * pNorm
            # the flat branch follows Aᴴr to the boundary
            t1f, t2f = to_boundary(s.x, s.Ar, radius,
                                   dNorm2=s.ArNorm * s.ArNorm)
            alpha_flat = torch.minimum(s.ArNorm * s.ArNorm / _safe(s.gamma),
                                       torch.maximum(t1f, t2f))
            t1r, t2r = to_boundary(s.x, s.p, radius, dNorm2=pNorm * pNorm)
            sigma = torch.maximum(t1r, t2r)
            hit = alpha >= sigma
            on_boundary = ~psd & hit
            alpha = torch.where(psd, alpha_flat,
                                torch.where(hit, sigma, alpha))
            p_sel = torch.where(psd, s.Ar, s.p)
            q_sel = torch.where(psd, A.rmatvec(s.s), s.q)

        x = s.x + alpha.to(FC) * p_sel
        Ar = s.Ar - alpha.to(FC) * q_sel
        ArNorm = knorm(Ar)
        early = psd | on_boundary
        r = s.r - alpha.to(FC) * s.Ap
        sv = A.matvec(Ar)
        Ms = M_apply(sv)
        gamma = kdotr(sv, Ms) + torch.where(lam > 0, lam * ArNorm * ArNorm,
                                            zero)
        beta = (gamma / _safe(s.gamma)).to(FC)
        p = Ar + beta * s.p
        Ap = sv + beta * s.Ap
        q = A.rmatvec(M_apply(Ap)) + lam_eff.to(FC) * p
        rNorm = torch.where(lam > 0,
                            torch.sqrt(kdotr(r, r) + lam * kdotr(x, x)),
                            knorm(r))
        it = s.iter + 1
        code = torch.where(on_boundary, rt.ON_BOUNDARY, torch.where(
            psd, PSD, torch.where((ArNorm <= s.eps_lim) | early, rt.SOLVED,
                                  rt.RUNNING))).to(torch.int32)
        # an early exit skips the continuation updates
        rNorm = torch.where(early, s.rNorm, rNorm)
        rt.hist_write_masked(s.hist_r, active, it, rNorm, history)
        rt.hist_write_masked(s.hist_ar, active, it, ArNorm, history)
        s_new = s._replace(
            x=x, r=torch.where(early, s.r, r), Ar=Ar,
            p=torch.where(early, p_sel, p), Ap=torch.where(early, s.Ap, Ap),
            q=torch.where(early, q_sel, q), s=torch.where(early, s.s, sv),
            gamma=torch.where(early, s.gamma, gamma), rNorm=rNorm,
            ArNorm=ArNorm, iter=it, status=code)
        if verbose > 0 and bool(active):
            rt.debug_row(verbose, it, "{:5d}  {:8.1e}  {:8.1e}", ArNorm,
                         rNorm)
        if callback is not None:
            s_new = _exit(callback, s_new, dev)
        return _masked(CrlsState._fields, active, s_new, s)

    return rt.take_steps(body, state_in, steps, iter_cap, callback)


def _crls_solve(
    A, b, *, M=None, ldiv=False, lam=0.0, radius=0.0, atol=None, rtol=None,
    itmax=0, timemax=float("inf"), verbose=0, history=False, callback=None,
):
    start = time.perf_counter()
    A, b, M, m, n, atol, rtol, itmax = _setup("CRLS", A, b, M, atol, rtol,
                                              itmax, verbose)
    hist_len = itmax + 1 if history else 0

    # Fast path: DIA stencil + default config → whole-solve kernel.
    if (M is None and radius == 0 and not history and callback is None
            and verbose == 0 and timemax == float("inf")
            and _fused_ready(A, m, b.dtype, crls_dia_fused_supported)):
        pd_adj, ot_adj = A.aligned_adjoint_kernel_args()
        x, niter, _, _, code_d = crls_dia_fused(
            A._pd, pd_adj, A._offsets, ot_adj, b.contiguous(), float(lam),
            atol, rtol, itmax)
        niter, code = torch.stack([niter, code_d]).tolist()
        return x, _kernel_stats(code, niter, itmax, start,
                                _CRLS_STATUS), None

    def run(state, cap, steps):
        return _crls_core(
            A, M, b, state, cap, steps, atol, rtol, float(lam),
            float(radius), ldiv=bool(ldiv), history=bool(history),
            hist_len=hist_len, callback=callback, verbose=int(verbose),
            use_radius=radius > 0)

    state, overtimed = rt.drive(run, itmax, timemax, start)
    niter = int(state.iter)
    code = rt.final_status_code(state.status, niter, itmax, overtimed)
    stats = SimpleStats(
        niter=niter, solved=rt.is_solved_code(code) or code == PSD,
        inconsistent=False,
        residuals=_trim(state.hist_r, niter, history),
        Aresiduals=_trim(state.hist_ar, niter, history),
        timer=time.perf_counter() - start,
        status=rt.decode_status(code, _CRLS_STATUS))
    return state.x, stats, state


def crls(A, b, **kwargs):
    """x, stats = crls(A, b; λ, radius, M, ...) — min ‖b − Ax‖² + λ‖x‖².

    CRLS takes no ``precision`` keyword, as in the JAX package: passing
    one raises ``TypeError``."""
    x, stats, _ = _crls_solve(A, b, **kwargs)
    return x, stats


# ---------------------------------------------------------------------------
# CGLS-LANCZOS-SHIFT (reference src/cgls_lanczos_shift.jl)
# ---------------------------------------------------------------------------

class CglsShiftState(NamedTuple):
    x: torch.Tensor          # (nshifts, n)
    Mv: torch.Tensor
    Mv_prev: torch.Tensor
    v: torch.Tensor
    u: torch.Tensor          # (m,) the right-hand side
    p: torch.Tensor          # (nshifts, n)
    beta: torch.Tensor
    sigma: torch.Tensor      # (nshifts,)
    omega: torch.Tensor
    gamma: torch.Tensor
    rNorms: torch.Tensor
    converged: torch.Tensor
    indefinite: torch.Tensor
    eps_lim: torch.Tensor
    iter: torch.Tensor
    status: torch.Tensor
    hist_r: torch.Tensor     # (hist_len, nshifts)


def _cgls_shift_core(
    A, b, shifts, state_in, iter_cap, steps, atol, rtol,
    *, history, hist_len, callback,
):
    """``steps`` iterations of Lanczos on AᴴA, shifted by each λᵢ, from
    ``state_in`` (None: start), each with its updates masked by
    ``status == RUNNING and iter < iter_cap`` (krylov_tpu/solvers/
    cgls.py:460-569)."""
    n = A.shape[1]
    ns = shifts.shape[0]
    FC = b.dtype
    T = real_dtype(FC)
    dev = b.device

    if state_in is None:
        Mv = A.rmatvec(b)
        beta = knorm(Mv)
        rNorms = beta.expand(ns).clone()
        eps_lim = _tol(atol, T, dev) + _tol(rtol, T, dev) * beta
        converged = rNorms <= eps_lim
        status = torch.where(beta == 0, rt.ZERO_RESIDUAL, torch.where(
            converged.all(), rt.SOLVED, rt.RUNNING)).to(torch.int32)
        v = Mv / _safe(beta).to(FC)
        hist = torch.full((max(hist_len, 1), ns), float("nan"), dtype=T,
                          device=dev)
        if history:
            hist[0] = rNorms
        state_in = CglsShiftState(
            x=torch.zeros((ns, n), dtype=FC, device=dev), Mv=v, Mv_prev=v,
            v=v, u=b, p=Mv.expand(ns, n).clone(), beta=beta,
            sigma=beta.expand(ns).clone(),
            omega=torch.zeros(ns, dtype=T, device=dev),
            gamma=torch.ones(ns, dtype=T, device=dev), rNorms=rNorms,
            converged=converged,
            indefinite=torch.zeros(ns, dtype=torch.bool, device=dev),
            eps_lim=eps_lim, iter=_i32(0, dev), status=status, hist_r=hist)

    def body(s):
        active = (s.status == rt.RUNNING) & (s.iter < iter_cap)
        Mv_next = A.rmatvec(A.matvec(s.v))
        delta = kdotr(s.v, Mv_next)
        Mv_next = Mv_next - delta.to(FC) * s.Mv
        Mv_next = torch.where(s.iter > 0,
                              Mv_next - s.beta.to(FC) * s.Mv_prev, Mv_next)
        beta = knorm(Mv_next)
        v = Mv_next / _safe(beta).to(FC)

        gamma = 1.0 / ((delta + shifts) - s.omega / s.gamma)
        mask = ~s.converged
        col = mask[:, None]
        om = beta * gamma
        sigma = torch.where(mask, -om * s.sigma, s.sigma)
        om2 = torch.where(mask, om * om, s.omega)
        rNorms = torch.where(mask, torch.abs(sigma), s.rNorms)
        converged = torch.where(mask, rNorms <= s.eps_lim, s.converged)
        it = s.iter + 1
        if history:
            # an inactive step writes row 0 back unchanged
            row = torch.where(active, it, torch.zeros_like(it)).long()
            s.hist_r[row] = torch.where(
                active, torch.where(mask, rNorms, float("nan")),
                s.hist_r[row])
        s_new = s._replace(
            x=torch.where(col, s.x + gamma[:, None].to(FC) * s.p, s.x),
            Mv=v, Mv_prev=s.Mv, v=v,
            p=torch.where(col, sigma[:, None].to(FC) * v[None, :]
                          + om2[:, None].to(FC) * s.p, s.p),
            beta=beta, sigma=sigma, omega=om2,
            gamma=torch.where(mask, gamma, s.gamma), rNorms=rNorms,
            converged=converged, indefinite=s.indefinite | (gamma <= 0),
            iter=it, status=torch.where(converged.all(), rt.SOLVED,
                                        rt.RUNNING).to(torch.int32))
        if callback is not None:
            s_new = _exit(callback, s_new, dev)
        return _masked(CglsShiftState._fields, active, s_new, s,
                       keep=("hist_r",))

    return rt.take_steps(body, state_in, steps, iter_cap, callback)


def _cgls_lanczos_shift_solve(
    A, b, shifts, *, atol=None, rtol=None, itmax=0, timemax=float("inf"),
    verbose=0, history=False, callback=None,
):
    start = time.perf_counter()
    A, b, _, _, m, n, _ = _ls_inputs(A, b, None, None, False, 0.0)
    T = real_dtype(b.dtype)
    shifts = torch.as_tensor(shifts, dtype=T, device=b.device)
    nshifts = shifts.shape[0]
    atol = rt.default_tol(atol, T)
    rtol = rt.default_tol(rtol, T)
    itmax = rt.resolve_itmax(itmax, m + n)
    hist_len = itmax + 1 if history else 0

    # Fast path: DIA stencil + default config → whole-solve kernel (one
    # AᴴA Lanczos stream, every shift's x and p on the card).
    if (callback is None and verbose == 0 and not history
            and timemax == float("inf")
            and _fused_ready(A, m, b.dtype,
                             cgls_lanczos_shift_dia_fused_supported)):
        pd_adj, ot_adj = A.aligned_adjoint_kernel_args()
        X, niter, _, code_d, indef = cgls_lanczos_shift_dia_fused(
            A._pd, pd_adj, A._offsets, ot_adj, b.contiguous(), shifts, atol,
            rtol, itmax)
        niter, code = torch.stack([niter, code_d]).tolist()
        code = rt.final_status_code(code, niter, itmax, False)
        stats = LanczosShiftStats(
            niter=niter, solved=rt.is_solved_code(code), residuals=[],
            indefinite=indef.cpu().numpy().astype(bool),
            timer=time.perf_counter() - start,
            status=rt.decode_status(code))
        return X, stats, None

    def run(state, cap, steps):
        return _cgls_shift_core(
            A, b, shifts, state, cap, steps, atol, rtol,
            history=bool(history), hist_len=hist_len, callback=callback)

    state, overtimed = rt.drive(run, itmax, timemax, start)
    niter = int(state.iter)
    code = rt.final_status_code(state.status, niter, itmax, overtimed)
    residuals = []
    if history:
        h = state.hist_r[: niter + 1].cpu().numpy()
        residuals = [h[:, i][~np.isnan(h[:, i])] for i in range(nshifts)]
    stats = LanczosShiftStats(
        niter=niter, solved=rt.is_solved_code(code), residuals=residuals,
        indefinite=state.indefinite.cpu().numpy(),
        timer=time.perf_counter() - start, status=rt.decode_status(code))
    return state.x, stats, state


def cgls_lanczos_shift(A, b, shifts, *, precision=None, **kwargs):
    """X, stats = cgls_lanczos_shift(A, b, shifts) — X has shape
    (nshifts, n): row i solves min ‖b − Ax‖² + shifts[i]‖x‖².

    ``precision`` may be None or "working"; CGLS-Lanczos-shift has no
    double-word path, so any other value raises ``ValueError`` (the JAX
    package ignores the keyword and solves in working precision)."""
    if precision not in (None, "working"):
        raise ValueError(
            f"precision={precision!r}: CGLS-LANCZOS-SHIFT has no "
            "double-word path; precision must be None or 'working'")
    X, stats, _ = _cgls_lanczos_shift_solve(A, b, shifts, **kwargs)
    return X, stats
