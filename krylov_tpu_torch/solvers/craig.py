"""CRAIG, CRAIGMR and LNLQ: minimum-norm solutions of consistent Ax = b.

Counterpart of ``krylov_tpu/solvers/craig.py``.  All three ride the
Golub–Kahan bidiagonalisation and return (x, y) with x = Aᴴy: reference
src/craig.jl (λ regularisation by the two-rotation scheme,
backward-error stopping, conlim), src/craigmr.jl (QR of the lower
bidiagonal; "found approximate minimum-norm solution") and src/lnlq.jl
(LQ factorisation, ``transfer_to_craig``, ``LNLQStats``).  M and N give
the elliptic norms, applied or divided by; sqd sets λ = 1.  A may be
rectangular or complex.  A DIA operator on the card with the default
options goes to a whole-solve kernel (ops/cuda_fused.py); every other
configuration runs the method's core in chunks of masked steps.
"""

import time
from typing import NamedTuple

import numpy as np
import torch

from .. import _runtime as rt
from .._dtypes import real_dtype
from ..operators import precond_apply
from ..ops.cuda_fused import (INCONS_CRAIG, SOLVED_CRAIG, SOLVED_LNLQ_CG,
                              SOLVED_LNLQ_LQ, SOLVED_MN, craig_dia_fused,
                              craig_dia_fused_supported, craigmr_dia_fused,
                              craigmr_dia_fused_supported, lnlq_dia_fused,
                              lnlq_dia_fused_supported)
from ..ops.kops import kdotr, knorm, sym_givens
from ..stats import LNLQStats, SimpleStats
from .bilq import _exit, _safe
from .cr import _fused_ready, _i32, _masked, _no_double_word, _trim
from .lsqr import _ls_inputs

_STATUS = {
    SOLVED_CRAIG: "solution good enough for the tolerances given",
    SOLVED_MN: "found approximate minimum-norm solution",
    INCONS_CRAIG: "system may be inconsistent",
    SOLVED_LNLQ_LQ: "solutions (xᴸ, yᴸ) good enough for the tolerances "
                    "given",
    SOLVED_LNLQ_CG: "solutions (xᶜ, yᶜ) good enough for the tolerances "
                    "given",
}


def _gk_norm(u, Mu):
    return torch.sqrt(torch.clamp(kdotr(u, Mu), min=0))


def _start_u(b, M_apply, MisI):
    """β₁u₁ = b in the M norm: (u, Mu, β₁)."""
    Mu = b
    u = M_apply(Mu)
    beta1 = _gk_norm(u, Mu)
    sb = _safe(beta1).to(b.dtype)
    u = u / sb
    return u, (u if MisI else Mu / sb), beta1


def _next_u(A, v, alpha, Mu_old, M_apply, MisI, FC):
    """βu = Av − αu in the M norm, normalised where β ≠ 0: (u, Mu, β)."""
    Mu = A.matvec(v) - alpha.to(FC) * Mu_old
    u = M_apply(Mu)
    beta = _gk_norm(u, Mu)
    bnz = beta != 0
    sb = _safe(beta).to(FC)
    u = torch.where(bnz, u / sb, u)
    return u, (u if MisI else torch.where(bnz, Mu / sb, Mu)), beta


def _next_v(A, u, beta, Nv_old, N_apply, NisI, FC):
    """αv = Aᴴu − βv in the N norm, normalised where α ≠ 0: (v, Nv, α)."""
    Nv = A.rmatvec(u) - beta.to(FC) * Nv_old
    v = N_apply(Nv)
    alpha = _gk_norm(v, Nv)
    anz = alpha != 0
    sa = _safe(alpha).to(FC)
    v = torch.where(anz, v / sa, v)
    return v, (v if NisI else torch.where(anz, Nv / sa, Nv)), alpha


def _lam_rotation(alpha, lam, use_lam, one):
    """(cp, sp, α̂) of the rotation of (α, λ), or (1, 1, α) without λ
    (krylov_tpu/solvers/craig.py:437-443)."""
    if use_lam:
        return sym_givens(alpha, lam)
    return one, one, alpha


def _preconditioners(M, N, ldiv):
    return (lambda t: precond_apply(M, t, ldiv),
            lambda t: precond_apply(N, t, ldiv))


# ---------------------------------------------------------------------------
# CRAIG
# ---------------------------------------------------------------------------

class CraigState(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    u: torch.Tensor
    Mu: torch.Tensor
    v: torch.Tensor
    Nv: torch.Tensor
    w: torch.Tensor
    w2: torch.Tensor
    beta: torch.Tensor
    theta: torch.Tensor
    xi: torch.Tensor
    delta: torch.Tensor
    rho_prev: torch.Tensor
    anorm2: torch.Tensor
    dnorm2: torch.Tensor
    xnorm2: torch.Tensor
    rNorm: torch.Tensor
    beta1: torch.Tensor
    eps_c: torch.Tensor
    iter: torch.Tensor
    status: torch.Tensor
    hist_r: torch.Tensor


def _craig_core(
    A, M, N, b, state_in, iter_cap, steps, itmax, atol, rtol, btol, conlim,
    lam, *, ldiv, use_lam, history, hist_len, callback, verbose, MisI, NisI,
):
    """``steps`` CRAIG iterations from ``state_in`` (None: start), each
    with its updates masked by ``status == RUNNING and iter < iter_cap``
    (krylov_tpu/solvers/craig.py:82-241)."""
    m, n = A.shape
    FC = b.dtype
    T = real_dtype(FC)
    dev = b.device
    tiny = torch.finfo(T).tiny

    def t_(v):
        return torch.tensor(v, dtype=T, device=dev)

    zero, one = t_(0.0), t_(1.0)
    lam = t_(lam)
    ctol = torch.where(t_(conlim) > 0, 1.0 / t_(conlim), zero)
    M_apply, N_apply = _preconditioners(M, N, ldiv)

    if state_in is None:
        u, Mu, beta1 = _start_u(b, M_apply, MisI)
        hr = rt.hist_write(rt.hist_init(hist_len, T, dev), _i32(0, dev),
                           beta1, history)
        zn = torch.zeros(n, dtype=FC, device=dev)
        state_in = CraigState(
            x=zn, y=torch.zeros(m, dtype=FC, device=dev), u=u, Mu=Mu, v=zn,
            Nv=zn, w=torch.zeros(m, dtype=FC, device=dev), w2=zn,
            beta=beta1, theta=beta1, xi=-one, delta=lam, rho_prev=one,
            anorm2=zero, dnorm2=zero, xnorm2=zero, rNorm=beta1, beta1=beta1,
            eps_c=atol + rtol * beta1, iter=_i32(0, dev),
            status=torch.where(beta1 == 0, rt.ZERO_RESIDUAL,
                               rt.RUNNING).to(torch.int32), hist_r=hr)

    def body(s):
        active = (s.status == rt.RUNNING) & (s.iter < iter_cap)
        it = s.iter + 1
        v, Nv, alpha = _next_v(A, s.u, s.beta, s.Nv, N_apply, NisI, FC)
        incons = alpha == 0

        anorm2 = s.anorm2 + alpha * alpha + lam * lam
        if use_lam:
            c1, s1, rho = sym_givens(alpha, s.delta)
        else:
            c1, s1, rho = one, zero, alpha
        xi = -s.theta / _safe(rho) * s.xi
        if use_lam:
            x = s.x + (xi * c1).to(FC) * v + (xi * s1).to(FC) * s.w2
            w2 = s1.to(FC) * v - c1.to(FC) * s.w2
        else:
            x = s.x + xi.to(FC) * v
            w2 = s.w2
        w = s.u - (s.theta / s.rho_prev).to(FC) * s.w
        y = s.y + (xi / rho).to(FC) * w
        dnorm2 = s.dnorm2 + knorm(w)

        u, Mu, beta = _next_u(A, v, alpha, s.Mu, M_apply, MisI, FC)
        if use_lam:
            theta = beta * c1
            _, s2, delta = sym_givens(lam, beta * s1)
            w2 = s2.to(FC) * w2
        else:
            theta, delta = beta, s.delta

        anorm2 = anorm2 + beta * beta
        anorm = torch.sqrt(anorm2)
        acond = anorm * torch.sqrt(dnorm2)
        xnorm2 = s.xnorm2 + xi * xi
        xnorm = torch.sqrt(xnorm2)
        rNorm = beta * torch.abs(xi)
        if use_lam:
            rNorm = rNorm * torch.abs(c1)
        bkwerr = rNorm / torch.sqrt(s.beta1 ** 2 + anorm2 * xnorm2 + tiny)
        solved = (((1.0 + bkwerr) <= 1.0) | (bkwerr <= btol)
                  | (rNorm <= s.eps_c)
                  | (rNorm <= btol + atol * anorm * xnorm / s.beta1))
        inv_acond = 1.0 / torch.clamp(acond, min=tiny)
        code = _i32(rt.RUNNING, dev)
        for cond, k in ((it >= itmax, rt.TIRED), (solved, SOLVED_CRAIG),
                        ((1.0 + inv_acond) <= 1.0, rt.ILL_COND_MACH),
                        (inv_acond <= ctol, rt.COND_EXCEEDED),
                        (incons, INCONS_CRAIG)):
            code = torch.where(cond, k, code)

        # on the inconsistency exit the iteration's updates never happened
        def keep(old, new):
            return torch.where(incons, old, new)

        it_out = keep(s.iter, it)
        rNorm = keep(s.rNorm, rNorm)
        rt.hist_write_masked(s.hist_r, active, it_out, rNorm, history)
        s_new = s._replace(
            x=keep(s.x, x), y=keep(s.y, y), u=u, Mu=Mu, v=v, Nv=Nv,
            w=keep(s.w, w), w2=keep(s.w2, w2), beta=keep(s.beta, beta),
            theta=keep(s.theta, theta), xi=keep(s.xi, xi),
            delta=keep(s.delta, delta), rho_prev=keep(s.rho_prev, rho),
            anorm2=keep(s.anorm2, anorm2), dnorm2=keep(s.dnorm2, dnorm2),
            xnorm2=keep(s.xnorm2, xnorm2), rNorm=rNorm, iter=it_out,
            status=code.to(torch.int32))
        if verbose > 0 and bool(active):
            # the reference's columns (src/craig.jl:256-257) without its
            # timer
            anorm_d = torch.sqrt(s_new.anorm2)
            rt.debug_row(verbose, it_out,
                         "{:5d}  {:8.1e}  {:8.1e}  {:8.1e}  {:8.1e}  "
                         "{:8.1e}  {:7.1e}",
                         rNorm, torch.sqrt(s_new.xnorm2), anorm_d,
                         anorm_d * torch.sqrt(s_new.dnorm2), alpha, beta)
        if callback is not None:
            s_new = _exit(callback, s_new, dev)
        return _masked(CraigState._fields, active, s_new, s)

    return rt.take_steps(body, state_in, steps, iter_cap, callback)


def _craig_solve(
    A, b, *, M=None, N=None, ldiv=False, sqd=False, lam=0.0, atol=None,
    rtol=None, btol=None, conlim=1.0e8, itmax=0, timemax=float("inf"),
    verbose=0, history=False, callback=None, transfer_to_lsqr=False,
):
    # transfer_to_lsqr is accepted and ignored, as by the JAX package
    start = time.perf_counter()
    A, b, M, N, m, n, lam = _ls_inputs(A, b, M, N, sqd, lam)
    T = real_dtype(b.dtype)
    atol = rt.default_tol(atol, T)
    rtol = rt.default_tol(rtol, T)
    btol = rt.default_tol(btol, T)
    itmax = rt.resolve_itmax(itmax, m + n)
    rt.debug_table(verbose, "CRAIG",
                   ("k", "‖r‖", "‖x‖", "‖A‖", "κ(A)", "α", "β"), m, n)
    hist_len = itmax + 1 if history else 0

    # Fast path: DIA stencil + default config → whole-solve kernel.
    if (M is None and N is None and not history and callback is None
            and verbose == 0 and timemax == float("inf")
            and _fused_ready(A, m, b.dtype, craig_dia_fused_supported)):
        pd_adj, ot_adj = A.aligned_adjoint_kernel_args()
        x, y, niter, _, code_d = craig_dia_fused(
            A._pd, pd_adj, A._offsets, ot_adj, b.contiguous(), float(lam),
            atol, rtol, btol, float(conlim), itmax, use_lam=bool(lam > 0))
        niter, code = torch.stack([niter, code_d]).tolist()
        code = rt.final_status_code(code, niter, itmax, False)
        stats = SimpleStats(
            niter=niter,
            solved=rt.is_solved_code(code) or code == SOLVED_CRAIG,
            inconsistent=code == INCONS_CRAIG, residuals=np.zeros(0),
            timer=time.perf_counter() - start,
            status=rt.decode_status(code, _STATUS))
        return x, y, stats, None

    def run(state, cap, steps):
        return _craig_core(
            A, M, N, b, state, cap, steps, itmax, atol, rtol, btol,
            float(conlim), float(lam), ldiv=bool(ldiv),
            use_lam=bool(lam > 0), history=bool(history), hist_len=hist_len,
            callback=callback, verbose=int(verbose), MisI=M is None,
            NisI=N is None)

    state, overtimed = rt.drive(run, itmax, timemax, start)
    niter = int(state.iter)
    code = rt.final_status_code(state.status, niter, itmax, overtimed)
    stats = SimpleStats(
        niter=niter, solved=rt.is_solved_code(code) or code == SOLVED_CRAIG,
        inconsistent=code == INCONS_CRAIG,
        residuals=_trim(state.hist_r, niter, history),
        timer=time.perf_counter() - start,
        status=rt.decode_status(code, _STATUS))
    return state.x, state.y, stats, state


def craig(A, b, *, precision=None, **kwargs):
    """x, y, stats = craig(A, b; λ, sqd, M, N, ...) — min ‖x‖ s.t. Ax = b.

    ``precision="double_word"`` raises NotImplementedError until the
    iterative refinement (solvers/_refine.py, ROADMAP.md Queue 1 item 8)
    is ported."""
    _no_double_word("CRAIG", precision)
    x, y, stats, _ = _craig_solve(A, b, **kwargs)
    return x, y, stats


# ---------------------------------------------------------------------------
# CRAIGMR
# ---------------------------------------------------------------------------

class CraigmrState(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    u: torch.Tensor
    Mu: torch.Tensor
    v: torch.Tensor
    Nv: torch.Tensor
    w: torch.Tensor
    wbar: torch.Tensor
    d: torch.Tensor
    q: torch.Tensor
    alpha: torch.Tensor
    beta: torch.Tensor
    zetabar: torch.Tensor
    rhobar: torch.Tensor
    theta: torch.Tensor
    cp: torch.Tensor
    sp: torch.Tensor
    lam_k: torch.Tensor
    anorm2: torch.Tensor      # the Frobenius estimate (a verbose column)
    rNorm: torch.Tensor
    ArNorm: torch.Tensor
    eps_c: torch.Tensor
    eps_i: torch.Tensor
    iter: torch.Tensor
    status: torch.Tensor
    hist_r: torch.Tensor
    hist_ar: torch.Tensor


def _craigmr_core(
    A, M, N, b, state_in, iter_cap, steps, atol, rtol, lam,
    *, ldiv, use_lam, history, hist_len, callback, verbose, MisI, NisI,
):
    """``steps`` CRAIGMR iterations from ``state_in`` (None: start), each
    with its updates masked by ``status == RUNNING and iter < iter_cap``
    (krylov_tpu/solvers/craig.py:403-569)."""
    m, n = A.shape
    FC = b.dtype
    T = real_dtype(FC)
    dev = b.device

    def t_(v):
        return torch.tensor(v, dtype=T, device=dev)

    zero, one = t_(0.0), t_(1.0)
    lam = t_(lam)
    M_apply, N_apply = _preconditioners(M, N, ldiv)

    if state_in is None:
        u, Mu, beta = _start_u(b, M_apply, MisI)
        v, Nv, alpha = _next_v(A, u, zero, torch.zeros(n, dtype=FC,
                                                       device=dev),
                               N_apply, NisI, FC)
        cp, sp, alphahat = _lam_rotation(alpha, lam, use_lam, one)
        q = sp.to(FC) * v if use_lam else torch.zeros(n, dtype=FC,
                                                      device=dev)
        hr = rt.hist_write(rt.hist_init(hist_len, T, dev), _i32(0, dev),
                           beta, history)
        har = rt.hist_write(rt.hist_init(hist_len, T, dev), _i32(0, dev),
                            alpha, history)
        state_in = CraigmrState(
            x=torch.zeros(n, dtype=FC, device=dev),
            y=torch.zeros(m, dtype=FC, device=dev), u=u, Mu=Mu, v=v, Nv=Nv,
            w=torch.zeros(m, dtype=FC, device=dev),
            wbar=u / _safe(alphahat).to(FC),
            d=torch.zeros(n, dtype=FC, device=dev), q=q, alpha=alpha,
            beta=beta, zetabar=beta, rhobar=alphahat, theta=zero, cp=cp,
            sp=sp, lam_k=lam, anorm2=alpha * alpha + lam * lam, rNorm=beta,
            ArNorm=alpha, eps_c=atol + rtol * beta, eps_i=atol + rtol * alpha,
            iter=_i32(0, dev),
            status=torch.where(beta == 0, rt.ZERO_RESIDUAL, torch.where(
                alpha == 0, rt.MIN_LSQ_X, rt.RUNNING)).to(torch.int32),
            hist_r=hr, hist_ar=har)

    def body(s):
        active = (s.status == rt.RUNNING) & (s.iter < iter_cap)
        it = s.iter + 1
        u, Mu, beta = _next_u(A, s.v, s.alpha, s.Mu, M_apply, MisI, FC)
        if use_lam:
            betahat = s.cp * beta
            lam_aux = s.sp * beta
        else:
            betahat, lam_aux = beta, zero

        c, sg, rho = sym_givens(s.rhobar, betahat)
        zeta = c * s.zetabar
        zetabar = sg * s.zetabar
        rNorm = torch.abs(zetabar)
        sr = _safe(rho)
        w = s.wbar / sr.to(FC) - (s.theta / sr).to(FC) * s.w
        y = s.y + zeta.to(FC) * w

        first = it == 1
        if use_lam:
            d1 = (s.cp / rho).to(FC) * s.v
            dk = d1 - (s.theta / rho).to(FC) * s.d + (s.sp / rho).to(FC) * s.q
            d = torch.where(first, d1, dk)
            q = torch.where(first, s.q,
                            s.sp.to(FC) * s.v - s.cp.to(FC) * s.q)
        else:
            d1 = s.v / sr.to(FC)
            d = torch.where(first, d1, d1 - (s.theta / sr).to(FC) * s.d)
            q = s.q
        x = s.x + zeta.to(FC) * d

        v, Nv, alpha = _next_v(A, u, beta, s.Nv, N_apply, NisI, FC)
        ArNorm = alpha * beta * torch.abs(zeta / sr)
        if use_lam:
            _, sd, lam_next = sym_givens(s.lam_k, lam_aux)
            q = sd.to(FC) * q
            cp, sp, alphahat = sym_givens(alpha, lam_next)
        else:
            cp, sp, lam_next, alphahat = s.cp, s.sp, s.lam_k, alpha
        wbar = torch.where(
            alpha != 0,
            (u - betahat.to(FC) * s.wbar) / _safe(alphahat).to(FC), s.wbar)

        solved = rNorm <= s.eps_c
        inconsistent = (rNorm > 100 * s.eps_c) & (ArNorm <= s.eps_i)
        code = torch.where(solved, SOLVED_MN, torch.where(
            inconsistent, rt.SOLVED_LSQ, rt.RUNNING)).to(torch.int32)
        rt.hist_write_masked(s.hist_r, active, it, rNorm, history)
        rt.hist_write_masked(s.hist_ar, active, it, ArNorm, history)
        s_new = s._replace(
            x=x, y=y, u=u, Mu=Mu, v=v, Nv=Nv, w=w, wbar=wbar, d=d, q=q,
            alpha=alpha, beta=beta, zetabar=zetabar, rhobar=-c * alphahat,
            theta=sg * alphahat, cp=cp, sp=sp, lam_k=lam_next,
            anorm2=s.anorm2 + alpha * alpha + beta * beta, rNorm=rNorm,
            ArNorm=ArNorm, iter=it, status=code)
        if verbose > 0 and bool(active):
            # the reference's columns (src/craigmr.jl:228) without its
            # timer
            rt.debug_row(verbose, it,
                         "{:5d}  {:7.1e}  {:7.1e}  {:7.1e}  {:7.1e}  "
                         "{:8.1e}  {:8.1e}  {:7.1e}",
                         rNorm, ArNorm, beta, alpha, c, sg, s_new.anorm2)
        if callback is not None:
            s_new = _exit(callback, s_new, dev)
        return _masked(CraigmrState._fields, active, s_new, s)

    return rt.take_steps(body, state_in, steps, iter_cap, callback)


def _craigmr_solve(
    A, b, *, M=None, N=None, ldiv=False, sqd=False, lam=0.0, atol=None,
    rtol=None, itmax=0, timemax=float("inf"), verbose=0, history=False,
    callback=None,
):
    start = time.perf_counter()
    A, b, M, N, m, n, lam = _ls_inputs(A, b, M, N, sqd, lam)
    T = real_dtype(b.dtype)
    atol = rt.default_tol(atol, T)
    rtol = rt.default_tol(rtol, T)
    itmax = rt.resolve_itmax(itmax, m + n)
    rt.debug_table(verbose, "CRAIGMR",
                   ("k", "‖r‖", "‖Aᴴr‖", "β", "α", "cos", "sin", "‖A‖²"),
                   m, n)
    hist_len = itmax + 1 if history else 0

    # Fast path: DIA stencil + default config → whole-solve kernel.
    if (M is None and N is None and not history and callback is None
            and verbose == 0 and timemax == float("inf")
            and _fused_ready(A, m, b.dtype, craigmr_dia_fused_supported)):
        pd_adj, ot_adj = A.aligned_adjoint_kernel_args()
        x, y, niter, _, _, code_d = craigmr_dia_fused(
            A._pd, pd_adj, A._offsets, ot_adj, b.contiguous(), float(lam),
            atol, rtol, itmax, use_lam=bool(lam > 0))
        niter, code = torch.stack([niter, code_d]).tolist()
        code = rt.final_status_code(code, niter, itmax, False)
        stats = SimpleStats(
            niter=niter, solved=rt.is_solved_code(code) or code == SOLVED_MN,
            inconsistent=code == rt.SOLVED_LSQ, residuals=np.zeros(0),
            timer=time.perf_counter() - start,
            status=rt.decode_status(code, _STATUS))
        return x, y, stats, None

    def run(state, cap, steps):
        return _craigmr_core(
            A, M, N, b, state, cap, steps, atol, rtol, float(lam),
            ldiv=bool(ldiv), use_lam=bool(lam > 0), history=bool(history),
            hist_len=hist_len, callback=callback, verbose=int(verbose),
            MisI=M is None, NisI=N is None)

    state, overtimed = rt.drive(run, itmax, timemax, start)
    niter = int(state.iter)
    code = rt.final_status_code(state.status, niter, itmax, overtimed)
    stats = SimpleStats(
        niter=niter, solved=rt.is_solved_code(code) or code == SOLVED_MN,
        inconsistent=code == rt.SOLVED_LSQ,
        residuals=_trim(state.hist_r, niter, history),
        Aresiduals=_trim(state.hist_ar, niter, history),
        timer=time.perf_counter() - start,
        status=rt.decode_status(code, _STATUS))
    return state.x, state.y, stats, state


def craigmr(A, b, *, precision=None, **kwargs):
    """x, y, stats = craigmr(A, b; λ, sqd, M, N, ...).

    ``precision="double_word"`` raises NotImplementedError until the
    iterative refinement (solvers/_refine.py, ROADMAP.md Queue 1 item 8)
    is ported."""
    _no_double_word("CRAIGMR", precision)
    x, y, stats, _ = _craigmr_solve(A, b, **kwargs)
    return x, y, stats


# ---------------------------------------------------------------------------
# LNLQ
# ---------------------------------------------------------------------------

class LnlqState(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    u: torch.Tensor
    Mu: torch.Tensor
    v: torch.Tensor
    Nv: torch.Tensor
    wbar: torch.Tensor
    q: torch.Tensor
    alpha: torch.Tensor
    alphahat: torch.Tensor
    beta: torch.Tensor
    c_k: torch.Tensor
    s_k: torch.Tensor
    zeta_km1: torch.Tensor
    zetabar: torch.Tensor
    eta: torch.Tensor
    theta: torch.Tensor
    epsbar: torch.Tensor
    tau: torch.Tensor
    cp: torch.Tensor
    sp: torch.Tensor
    lam_k: torch.Tensor
    rNorm: torch.Tensor
    eps_lim: torch.Tensor
    iter: torch.Tensor
    status: torch.Tensor
    solved_cg_flag: torch.Tensor
    hist_r: torch.Tensor


def _lnlq_core(
    A, M, N, b, state_in, iter_cap, steps, atol, rtol, lam,
    *, ldiv, use_lam, transfer_to_craig, history, hist_len, callback,
    verbose, MisI, NisI,
):
    """``steps`` LNLQ iterations from ``state_in`` (None: start), each
    with its updates masked by ``status == RUNNING and iter < iter_cap``
    (krylov_tpu/solvers/craig.py:701-863); the CRAIG-point transfer
    follows the loop (``_lnlq_transfer``)."""
    m, n = A.shape
    FC = b.dtype
    T = real_dtype(FC)
    dev = b.device
    eps = torch.finfo(T).eps

    def t_(v):
        return torch.tensor(v, dtype=T, device=dev)

    zero, one = t_(0.0), t_(1.0)
    lam = t_(lam)
    M_apply, N_apply = _preconditioners(M, N, ldiv)

    if state_in is None:
        u, Mu, beta = _start_u(b, M_apply, MisI)
        v, Nv, alpha = _next_v(A, u, zero, torch.zeros(n, dtype=FC,
                                                       device=dev),
                               N_apply, NisI, FC)
        cp, sp, alphahat = _lam_rotation(alpha, lam, use_lam, one)
        q = sp.to(FC) * v if use_lam else torch.zeros(n, dtype=FC,
                                                      device=dev)
        tau = beta / _safe(alphahat)
        hr = rt.hist_write(rt.hist_init(hist_len, T, dev), _i32(0, dev),
                           beta, history)
        state_in = LnlqState(
            x=torch.zeros(n, dtype=FC, device=dev),
            y=torch.zeros(m, dtype=FC, device=dev), u=u, Mu=Mu, v=v, Nv=Nv,
            wbar=u, q=q, alpha=alpha, alphahat=alphahat, beta=beta,
            c_k=zero, s_k=zero, zeta_km1=zero,
            zetabar=tau / _safe(alphahat), eta=zero, theta=tau,
            epsbar=alphahat, tau=tau, cp=cp, sp=sp, lam_k=lam, rNorm=beta,
            eps_lim=atol + rtol * beta, iter=_i32(0, dev),
            status=torch.where(beta == 0, rt.ZERO_RESIDUAL,
                               rt.RUNNING).to(torch.int32),
            solved_cg_flag=torch.zeros((), dtype=torch.bool, device=dev),
            hist_r=hr)

    def body(s):
        active = (s.status == rt.RUNNING) & (s.iter < iter_cap)
        it = s.iter + 1
        # the x update (reference src/lnlq.jl:293-303)
        if use_lam:
            second = it >= 2
            x = s.x + (s.tau * s.cp).to(FC) * s.v
            x = torch.where(second, x + (s.tau * s.sp).to(FC) * s.q, x)
            q = torch.where(second, s.sp.to(FC) * s.v - s.cp.to(FC) * s.q,
                            s.q)
        else:
            x = s.x + s.tau.to(FC) * s.v
            q = s.q

        u, Mu, beta = _next_u(A, s.v, s.alpha, s.Mu, M_apply, MisI, FC)
        v, Nv, alpha = _next_v(A, u, beta, s.Nv, N_apply, NisI, FC)

        if use_lam:
            betahat = s.cp * beta
            _, sd, lam_next = sym_givens(lam, s.sp * beta)
            q = sd.to(FC) * q
            cp, sp, alphahat = sym_givens(alpha, lam_next)
        else:
            betahat, alphahat = beta, alpha
            cp, sp, lam_next = s.cp, s.sp, s.lam_k

        tau = -betahat * s.tau / _safe(alphahat)
        c, sk, eps_k = sym_givens(s.epsbar, betahat)
        eta = alphahat * sk
        epsbar = -alphahat * c
        zeta = s.theta / _safe(eps_k)
        theta = tau - eta * zeta
        zetabar = theta / _safe(epsbar)

        y = s.y + (zeta * c).to(FC) * s.wbar + (zeta * sk).to(FC) * u
        wbar = sk.to(FC) * s.wbar - c.to(FC) * u

        rNorm = torch.where(it == 1, s.rNorm, torch.abs(s.alphahat)
                            * torch.sqrt((s.epsbar * s.zetabar) ** 2
                                         + (betahat * s.s_k * s.zeta_km1)
                                         ** 2))
        rNorm_cg = torch.abs(betahat * s.tau)
        solved_lq = rNorm <= s.eps_lim
        solved_cg = ((torch.abs(s.zetabar) > eps) & (rNorm_cg <= s.eps_lim)
                     & transfer_to_craig)
        cg_stop = solved_cg & ~solved_lq
        code = torch.where(solved_lq, SOLVED_LNLQ_LQ, torch.where(
            cg_stop, SOLVED_LNLQ_CG, rt.RUNNING)).to(torch.int32)

        rt.hist_write_masked(s.hist_r, active, it, rNorm, history)
        s_new = s._replace(
            x=x, y=y, u=u, Mu=Mu, v=v, Nv=Nv, wbar=wbar, q=q, alpha=alpha,
            alphahat=alphahat, beta=beta, c_k=c, s_k=sk, zeta_km1=zeta,
            zetabar=zetabar, eta=eta, theta=theta, epsbar=epsbar, tau=tau,
            cp=cp, sp=sp, lam_k=lam_next, rNorm=rNorm, iter=it, status=code,
            solved_cg_flag=cg_stop)
        if verbose > 0 and bool(active):
            rt.debug_row(verbose, it, "{:5d}  {:7.1e}", rNorm)
        if callback is not None:
            s_new = _exit(callback, s_new, dev)
        return _masked(LnlqState._fields, active, s_new, s)

    return rt.take_steps(body, state_in, steps, iter_cap, callback)


def _lnlq_transfer(state, use_lam):
    """The CRAIG point after a stop on the CG branch, where ζ̄ > eps,
    signed (reference src/lnlq.jl:569-585; krylov_tpu/solvers/craig.py:
    864-878)."""
    eps = torch.finfo(state.zetabar.dtype).eps
    if not bool(state.solved_cg_flag & (state.zetabar > eps)):
        return state
    FC = state.x.dtype
    if use_lam:
        x = (state.x + (state.tau * state.cp).to(FC) * state.v
             + (state.tau * state.sp).to(FC) * state.q)
    else:
        x = state.x + state.tau.to(FC) * state.v
    return state._replace(x=x, y=state.y + state.zetabar.to(FC) * state.wbar)


def _lnlq_solve(
    A, b, *, M=None, N=None, ldiv=False, sqd=False, lam=0.0,
    transfer_to_craig=True, atol=None, rtol=None, itmax=0,
    timemax=float("inf"), verbose=0, history=False, callback=None,
):
    start = time.perf_counter()
    A, b, M, N, m, n, lam = _ls_inputs(A, b, M, N, sqd, lam)
    T = real_dtype(b.dtype)
    atol = rt.default_tol(atol, T)
    rtol = rt.default_tol(rtol, T)
    itmax = rt.resolve_itmax(itmax, m + n)
    rt.debug_table(verbose, "LNLQ", ("k", "‖rₖ‖"), m, n)
    hist_len = itmax + 1 if history else 0

    # Fast path: DIA stencil + default config → whole-solve kernel.  It
    # returns SimpleStats, as the JAX package's kernel route does
    # (krylov_tpu/solvers/craig.py:923-931); the general route LNLQStats.
    if (M is None and N is None and not history and callback is None
            and verbose == 0 and timemax == float("inf")
            and _fused_ready(A, m, b.dtype, lnlq_dia_fused_supported)):
        pd_adj, ot_adj = A.aligned_adjoint_kernel_args()
        x, y, niter, _, code_d = lnlq_dia_fused(
            A._pd, pd_adj, A._offsets, ot_adj, b.contiguous(), float(lam),
            atol, rtol, itmax, use_lam=bool(lam > 0),
            transfer_to_craig=bool(transfer_to_craig))
        niter, code = torch.stack([niter, code_d]).tolist()
        code = rt.final_status_code(code, niter, itmax, False)
        stats = SimpleStats(
            niter=niter, solved=rt.is_solved_code(code) or code in (
                SOLVED_LNLQ_LQ, SOLVED_LNLQ_CG),
            inconsistent=False, residuals=np.zeros(0),
            timer=time.perf_counter() - start,
            status=rt.decode_status(code, _STATUS))
        return x, y, stats, None

    def run(state, cap, steps):
        return _lnlq_core(
            A, M, N, b, state, cap, steps, atol, rtol, float(lam),
            ldiv=bool(ldiv), use_lam=bool(lam > 0),
            transfer_to_craig=bool(transfer_to_craig), history=bool(history),
            hist_len=hist_len, callback=callback, verbose=int(verbose),
            MisI=M is None, NisI=N is None)

    state, overtimed = rt.drive(run, itmax, timemax, start)
    state = _lnlq_transfer(state, bool(lam > 0))
    niter = int(state.iter)
    code = rt.final_status_code(state.status, niter, itmax, overtimed)
    stats = LNLQStats(
        niter=niter, solved=rt.is_solved_code(code) or code in (
            SOLVED_LNLQ_LQ, SOLVED_LNLQ_CG),
        residuals=_trim(state.hist_r, niter, history),
        timer=time.perf_counter() - start,
        status=rt.decode_status(code, _STATUS))
    return state.x, state.y, stats, state


def lnlq(A, b, *, precision=None, **kwargs):
    """x, y, stats = lnlq(A, b; λ, sqd, transfer_to_craig, M, N, ...).

    ``precision="double_word"`` raises NotImplementedError until the
    iterative refinement (solvers/_refine.py, ROADMAP.md Queue 1 item 8)
    is ported."""
    _no_double_word("LNLQ", precision)
    x, y, stats, _ = _lnlq_solve(A, b, **kwargs)
    return x, y, stats
