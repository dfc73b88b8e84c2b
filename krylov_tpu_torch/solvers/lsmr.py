"""LSMR: min ‖b − Ax‖ (+ λ) with ‖Aᴴrₖ‖ minimised at each step.

Counterpart of ``krylov_tpu/solvers/lsmr.py`` and of reference
src/lsmr.jl: λ/sqd regularisation, M/N elliptic norms, ``radius``, the
Paige–Saunders stopping rules, the ‖r‖, ‖A‖, cond(A) and ‖x‖ estimate
recurrences and ``LsmrStats``.  A DIA operator on the card with the
default options goes to a whole-solve kernel (ops/cuda_fused.py); every
other configuration runs ``_lsmr_core`` in chunks of masked steps.
"""

import time
from typing import NamedTuple

import numpy as np
import torch

from .. import _runtime as rt
from .._dtypes import real_dtype
from ..operators import precond_apply
from ..ops.cuda_fused import lsmr_dia_fused, lsmr_dia_fused_supported
from ..ops.kops import kdotr, knorm, sym_givens, to_boundary
from ..stats import LsmrStats
from .cr import _fused_ready, _i32, _masked, _no_double_word
from .lsqr import (_gk_start, _gk_step, _inconsistent, _ls_inputs,
                   _ls_stats, _ls_status, _user_exit)


class LsmrState(NamedTuple):
    x: torch.Tensor
    u: torch.Tensor
    Mu: torch.Tensor
    v: torch.Tensor
    Nv: torch.Tensor
    h: torch.Tensor
    hbar: torch.Tensor
    alpha: torch.Tensor
    beta: torch.Tensor
    zetabar: torch.Tensor
    alphabar: torch.Tensor
    rho: torch.Tensor
    rhobar: torch.Tensor
    cbar: torch.Tensor
    sbar: torch.Tensor
    betadd: torch.Tensor
    betad: torch.Tensor
    rhodold: torch.Tensor
    tautildeold: torch.Tensor
    thetatilde: torch.Tensor
    zeta: torch.Tensor
    dd: torch.Tensor
    anorm2: torch.Tensor
    maxrbar: torch.Tensor
    minrbar: torch.Tensor
    xenorm2: torch.Tensor
    err_vec: torch.Tensor
    rNorm: torch.Tensor
    ArNorm: torch.Tensor
    ArNorm0: torch.Tensor
    beta1: torch.Tensor
    acond: torch.Tensor
    anorm: torch.Tensor
    xnorm: torch.Tensor
    iter: torch.Tensor
    status: torch.Tensor
    zero_resid: torch.Tensor
    hist_r: torch.Tensor
    hist_ar: torch.Tensor


def _lsmr_core(
    A, M, N, b, state_in, iter_cap, steps, itmax, lam, axtol, btol, atol,
    rtol, etol, conlim, radius,
    *, ldiv, history, hist_len, callback, verbose, window, use_radius,
    MisI, NisI,
):
    """``steps`` LSMR iterations from ``state_in`` (None: start), each with
    its updates masked by ``status == RUNNING and iter < iter_cap``
    (krylov_tpu/solvers/lsmr.py:70-285)."""
    n = A.shape[1]
    FC = b.dtype
    T = real_dtype(FC)
    dev = b.device
    tiny = torch.finfo(T).tiny

    def t_(v):
        return torch.tensor(v, dtype=T, device=dev)

    zero, one = t_(0.0), t_(1.0)
    lam = t_(lam)
    radius = t_(radius)
    ctol = torch.where(t_(conlim) > 0, 1.0 / t_(conlim), zero)
    axtol, btol, atol, rtol, etol = map(t_, (axtol, btol, atol, rtol, etol))

    def M_apply(t):
        return precond_apply(M, t, ldiv)

    def N_apply(t):
        return precond_apply(N, t, ldiv)

    if state_in is None:
        u, Mu, v, Nv, alpha, beta1, _ = _gk_start(A, b, M_apply, N_apply,
                                                  kdotr, MisI, NisI)
        ArNorm0 = alpha * beta1
        status = torch.where(beta1 == 0, rt.ZERO_RESIDUAL, torch.where(
            alpha == 0, rt.MIN_LSQ_X, torch.where(
                beta1 <= axtol, rt.SOLVED_LSQ, rt.RUNNING))).to(torch.int32)
        hr = rt.hist_write(rt.hist_init(hist_len, T, dev), _i32(0, dev),
                           beta1, history)
        har = rt.hist_write(rt.hist_init(hist_len, T, dev), _i32(0, dev),
                            ArNorm0, history)
        state_in = LsmrState(
            x=torch.zeros(n, dtype=FC, device=dev), u=u, Mu=Mu, v=v, Nv=Nv,
            h=v, hbar=torch.zeros(n, dtype=FC, device=dev), alpha=alpha,
            beta=beta1, zetabar=alpha * beta1, alphabar=alpha, rho=one,
            rhobar=one, cbar=one, sbar=zero, betadd=beta1, betad=zero,
            rhodold=one, tautildeold=zero, thetatilde=zero, zeta=zero,
            dd=zero, anorm2=alpha * alpha, maxrbar=zero,
            # reference lsmr.jl's 1e100 sentinel overflows narrow dtypes;
            # finfo.max is the same "larger than any real rbar" bound
            minrbar=t_(min(1.0e100, float(torch.finfo(T).max))),
            xenorm2=zero, err_vec=torch.zeros(window, dtype=T, device=dev),
            rNorm=beta1, ArNorm=ArNorm0, ArNorm0=ArNorm0, beta1=beta1,
            acond=zero, anorm=alpha, xnorm=zero, iter=_i32(0, dev),
            status=status,
            zero_resid=torch.zeros((), dtype=torch.bool, device=dev),
            hist_r=hr, hist_ar=har)

    def body(s):
        active = (s.status == rt.RUNNING) & (s.iter < iter_cap)
        it = s.iter + 1
        u, Mu, v, Nv, alpha, beta, _ = _gk_step(A, s, M_apply, N_apply,
                                                kdotr, MisI, NisI, FC)

        chat, shat, alphahat = sym_givens(s.alphabar, lam)
        rhoold = s.rho
        c, sg, rho = sym_givens(alphahat, beta)
        thetanew = sg * alpha
        alphabar = c * alpha

        rhobarold = s.rhobar
        zetaold = s.zeta
        thetabar = s.sbar * rho
        rhotemp = s.cbar * rho
        cbar, sbar, rhobar = sym_givens(rhotemp, thetanew)
        zeta = cbar * s.zetabar
        zetabar = -sbar * s.zetabar

        xenorm2 = s.xenorm2 + zeta * zeta
        err_vec = s.err_vec.index_put(((it % window).long().reshape(1),),
                                      zeta.reshape(1))
        err_lbnd = torch.linalg.vector_norm(err_vec)

        delta = thetabar * rho / torch.clamp(rhoold * rhobarold, min=tiny)
        hbar = s.h - delta.to(FC) * s.hbar

        sigma = zeta / torch.clamp(rho * rhobar, min=tiny)
        on_boundary = torch.zeros((), dtype=torch.bool, device=dev)
        if use_radius:
            t1b, t2b = to_boundary(s.x, hbar, radius)
            tmax = torch.maximum(t1b, t2b)
            tmin = torch.minimum(t1b, t2b)
            on_boundary = (sigma > tmax) | (sigma < tmin)
            sigma = torch.where(sigma > 0, torch.minimum(sigma, tmax),
                                torch.maximum(sigma, tmin))

        x = s.x + sigma.to(FC) * hbar
        h = v - (thetanew / torch.clamp(rho, min=tiny)).to(FC) * s.h

        # the ‖r‖ estimate recurrences
        betaacute = chat * s.betadd
        betacheck = -shat * s.betadd
        betahat = c * betaacute
        betadd = -sg * betaacute

        thetatildeold = s.thetatilde
        ctildeold, stildeold, rhotildeold = sym_givens(s.rhodold, thetabar)
        thetatilde = stildeold * rhobar
        rhodold = ctildeold * rhobar
        betad = -stildeold * s.betad + ctildeold * betahat

        tautildeold = (zetaold - thetatildeold * s.tautildeold) \
            / torch.clamp(rhotildeold, min=tiny)
        taud = (zeta - thetatilde * tautildeold) / torch.clamp(rhodold,
                                                               min=tiny)
        dd = s.dd + betacheck * betacheck
        rNorm = torch.sqrt(dd + (betad - taud) ** 2 + betadd * betadd)

        anorm2 = s.anorm2 + beta * beta
        anorm = torch.sqrt(anorm2)
        anorm2 = anorm2 + alpha * alpha

        maxrbar = torch.maximum(s.maxrbar, rhobarold)
        minrbar = torch.where(it > 1, torch.minimum(s.minrbar, rhobarold),
                              s.minrbar)
        acond = torch.maximum(maxrbar, rhotemp) / torch.clamp(
            torch.minimum(minrbar, rhotemp), min=tiny)

        ArNorm = torch.abs(zetabar)
        xnorm = knorm(x)

        test1 = rNorm / s.beta1
        test2 = ArNorm / torch.clamp(anorm * rNorm, min=tiny)
        test3 = 1.0 / torch.clamp(acond, min=tiny)
        t1 = test1 / (1.0 + anorm * xnorm / s.beta1)
        rNormtol = btol + axtol * anorm * xnorm / s.beta1

        zero_resid = ((1.0 + t1) <= 1.0) | (test1 <= rNormtol)
        fwd_err = (it >= window) & (err_lbnd <= etol * torch.sqrt(xenorm2))
        solved = (((1.0 + test2) <= 1.0) | (test2 <= axtol)
                  | (ArNorm <= atol + rtol * s.ArNorm0) | zero_resid
                  | fwd_err | on_boundary)
        code = _ls_status(it >= itmax, (1.0 + test3) <= 1.0, test3 <= ctol,
                          solved, zero_resid, fwd_err, on_boundary, dev)

        rt.hist_write_masked(s.hist_r, active, it, rNorm, history)
        rt.hist_write_masked(s.hist_ar, active, it, ArNorm, history)
        s_new = s._replace(
            x=x, u=u, Mu=Mu, v=v, Nv=Nv, h=h, hbar=hbar, alpha=alpha,
            beta=beta, zetabar=zetabar, alphabar=alphabar, rho=rho,
            rhobar=rhobar, cbar=cbar, sbar=sbar, betadd=betadd, betad=betad,
            rhodold=rhodold, tautildeold=tautildeold, thetatilde=thetatilde,
            zeta=zeta, dd=dd, anorm2=anorm2, maxrbar=maxrbar,
            minrbar=minrbar, xenorm2=xenorm2, err_vec=err_vec, rNorm=rNorm,
            ArNorm=ArNorm, acond=acond, anorm=anorm, xnorm=xnorm, iter=it,
            status=code, zero_resid=zero_resid)
        if callback is not None:
            s_new = _user_exit(callback, s_new, dev)
        if verbose > 0 and bool(active):
            rt.debug_row(
                verbose, it,
                "{:5d}  {:7.1e}  {:7.1e}  {:7.1e}  {:7.1e}  {:8.1e}  "
                "{:8.1e}  {:7.1e}",
                rNorm, ArNorm, beta, alpha, c, sg, anorm2)
        return _masked(LsmrState._fields, active, s_new, s)

    return rt.take_steps(body, state_in, steps, iter_cap, callback)


def _lsmr_solve(
    A, b, *, M=None, N=None, ldiv=False, sqd=False, lam=0.0, radius=0.0,
    axtol=None, btol=None, atol=0.0, rtol=0.0, etol=None, conlim=1.0e8,
    window=5, itmax=0, timemax=float("inf"), verbose=0, history=False,
    callback=None,
):
    start = time.perf_counter()
    A, b, M, N, m, n, lam = _ls_inputs(A, b, M, N, sqd, lam)
    T = real_dtype(b.dtype)
    axtol = rt.default_tol(axtol, T)
    btol = rt.default_tol(btol, T)
    etol = rt.default_tol(etol, T)
    itmax = rt.resolve_itmax(itmax, m + n)
    hist_len = itmax + 1 if history else 0
    rt.debug_header(verbose, f"LSMR: system of {m} equations in {n} variables")
    rt.debug_header(
        verbose,
        f"{'k':>5s}  {'‖r‖':>7s}  {'‖Aᴴr‖':>7s}  {'β':>7s}  {'α':>7s}  "
        f"{'cos':>8s}  {'sin':>8s}  {'‖A‖²':>7s}")

    # Fast path: DIA stencil + default config → whole-solve kernel.
    if (M is None and N is None and radius == 0 and not history
            and callback is None and verbose == 0
            and timemax == float("inf")
            and _fused_ready(A, m, b.dtype, lsmr_dia_fused_supported)):
        pd_adj, ot_adj = A.aligned_adjoint_kernel_args()
        (x, niter, rnorm, arnorm, acond, anorm, xnorm, code_d,
         zr) = lsmr_dia_fused(
            A._pd, pd_adj, A._offsets, ot_adj, b.contiguous(), float(lam),
            axtol, btol, float(atol), float(rtol), etol, float(conlim),
            itmax, window=int(window))
        niter, code, zr = torch.stack([niter, code_d, zr]).tolist()
        rnorm, arnorm, acond, anorm, xnorm = torch.stack(
            [rnorm, arnorm, acond, anorm, xnorm]).tolist()
        code = rt.final_status_code(code, niter, itmax, False)
        stats = LsmrStats(
            niter=niter, solved=rt.is_solved_code(code),
            inconsistent=_inconsistent(bool(zr), code),
            residuals=np.zeros(0), Aresiduals=np.zeros(0), residual=rnorm,
            Aresidual=arnorm, Acond=acond, Anorm=anorm, xNorm=xnorm,
            timer=time.perf_counter() - start,
            status=rt.decode_status(code))
        return x, stats, None

    def run(state, cap, steps):
        return _lsmr_core(
            A, M, N, b, state, cap, steps, itmax, float(lam), axtol, btol,
            float(atol), float(rtol), etol, float(conlim), float(radius),
            ldiv=bool(ldiv), history=bool(history), hist_len=hist_len,
            callback=callback, verbose=int(verbose), window=int(window),
            use_radius=bool(radius > 0), MisI=M is None, NisI=N is None)

    state, overtimed = rt.drive(run, itmax, timemax, start)
    niter = int(state.iter)
    code = rt.final_status_code(state.status, niter, itmax, overtimed)
    return state.x, _ls_stats(
        LsmrStats, state, niter, code, history, start,
        residual=float(state.rNorm), Aresidual=float(state.ArNorm),
        Acond=float(state.acond), Anorm=float(state.anorm),
        xNorm=float(state.xnorm)), state


def lsmr(A, b, *, precision=None, **kwargs):
    """x, stats = lsmr(A, b; λ, sqd, M, N, radius, ...).

    ``precision="double_word"`` raises NotImplementedError until the
    iterative refinement (solvers/_refine.py, ROADMAP.md Queue 1 item 8)
    is ported."""
    _no_double_word("LSMR", precision)
    x, stats, _ = _lsmr_solve(A, b, **kwargs)
    return x, stats
