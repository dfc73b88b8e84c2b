"""LSLQ: min ‖b − Ax‖ by the LQ form of Golub–Kahan bidiagonalisation.

Counterpart of ``krylov_tpu/solvers/lslq.py`` and of reference
src/lslq.jl: λ/sqd regularisation, σ (an underestimate of σmin) giving
the forward-error upper bounds with the ``utol`` stop, the ``etol``
window lower bound, btol/conlim, ``transfer_to_lsqr`` and
``LSLQStats``.  A DIA operator on the card with the default options
goes to a whole-solve kernel (ops/cuda_fused.py), σ, the transfer and
the window included; every other configuration runs ``_lslq_core`` in
chunks of masked steps.
"""

import time
from typing import NamedTuple

import numpy as np
import torch

from .. import _runtime as rt
from .._dtypes import real_dtype
from ..operators import precond_apply
from ..ops.cuda_fused import (FWD_LBND, FWD_UBND, lslq_dia_fused,
                              lslq_dia_fused_supported)
from ..ops.kops import kdotr, sym_givens
from ..stats import LSLQStats
from .bilq import _safe
from .cr import _fused_ready, _i32, _masked, _no_double_word, _trim
from .lsqr import (_gk_start, _gk_step, _inconsistent, _ls_inputs,
                   _user_exit)

_STATUS = {
    FWD_LBND: "forward error lower bound small enough",
    FWD_UBND: "forward error upper bound small enough",
}


class LslqState(NamedTuple):
    x: torch.Tensor
    u: torch.Tensor
    Mu: torch.Tensor
    v: torch.Tensor
    Nv: torch.Tensor
    wbar: torch.Tensor
    alpha: torch.Tensor
    beta: torch.Tensor
    lam_k: torch.Tensor
    anorm2: torch.Tensor
    smax: torch.Tensor
    smin: torch.Tensor
    gbar: torch.Tensor
    psi: torch.Tensor
    c: torch.Tensor
    s: torch.Tensor
    delta: torch.Tensor
    tau: torch.Tensor
    zeta: torch.Tensor
    zetabar: torch.Tensor
    zetatilde: torch.Tensor
    rhobar_sig: torch.Tensor
    csig: torch.Tensor
    omega: torch.Tensor
    complex_bnd: torch.Tensor
    xlqnorm2: torch.Tensor
    err_vec: torch.Tensor
    rNorm: torch.Tensor
    ArNorm: torch.Tensor
    beta1: torch.Tensor
    eps_lim: torch.Tensor
    iter: torch.Tensor
    status: torch.Tensor
    zero_resid: torch.Tensor
    hist_r: torch.Tensor
    hist_ar: torch.Tensor


def _lslq_core(
    A, M, N, b, state_in, iter_cap, steps, itmax, atol, rtol, btol, etol,
    utol, conlim, lam, sigma,
    *, ldiv, use_sigma, history, hist_len, callback, verbose, window,
    MisI, NisI,
):
    """``steps`` LSLQ iterations from ``state_in`` (None: start), each with
    its updates masked by ``status == RUNNING and iter < iter_cap``
    (krylov_tpu/solvers/lslq.py:78-299)."""
    n = A.shape[1]
    FC = b.dtype
    T = real_dtype(FC)
    dev = b.device
    tiny = torch.finfo(T).tiny

    def t_(v):
        return torch.tensor(v, dtype=T, device=dev)

    zero, one = t_(0.0), t_(1.0)
    sigma_v = t_(sigma)
    ctol = torch.where(t_(conlim) > 0, 1.0 / t_(conlim), zero)
    atol, rtol, btol, etol, utol = map(t_, (atol, rtol, btol, etol, utol))
    false = torch.zeros((), dtype=torch.bool, device=dev)

    def M_apply(t):
        return precond_apply(M, t, ldiv)

    def N_apply(t):
        return precond_apply(N, t, ldiv)

    if state_in is None:
        u, Mu, v, Nv, alpha, beta1, _ = _gk_start(A, b, M_apply, N_apply,
                                                  kdotr, MisI, NisI)
        eps_lim = atol + rtol * beta1
        status = torch.where(beta1 == 0, rt.ZERO_RESIDUAL, torch.where(
            alpha == 0, rt.MIN_LSQ_X, torch.where(
                beta1 <= eps_lim, rt.SOLVED_ZERO, rt.RUNNING)))
        hr = rt.hist_write(rt.hist_init(hist_len, T, dev), _i32(0, dev),
                           beta1, history)
        har = rt.hist_write(rt.hist_init(hist_len, T, dev), _i32(0, dev),
                            alpha * beta1, history)
        state_in = LslqState(
            x=torch.zeros(n, dtype=FC, device=dev), u=u, Mu=Mu, v=v, Nv=Nv,
            wbar=v, alpha=alpha, beta=beta1, lam_k=t_(lam),
            anorm2=alpha * alpha, smax=zero, smin=t_(float("inf")),
            gbar=alpha, psi=beta1, c=-one, s=zero, delta=-one,
            tau=alpha * beta1, zeta=zero, zetabar=zero, zetatilde=zero,
            rhobar_sig=-sigma_v, csig=-one, omega=zero, complex_bnd=false,
            xlqnorm2=zero, err_vec=torch.zeros(window, dtype=T, device=dev),
            rNorm=beta1, ArNorm=alpha * beta1, beta1=beta1, eps_lim=eps_lim,
            iter=_i32(0, dev), status=status.to(torch.int32),
            zero_resid=false, hist_r=hr, hist_ar=har)

    def body(s_):
        active = (s_.status == rt.RUNNING) & (s_.iter < iter_cap)
        u, Mu, v, Nv, alpha, beta, bnz = _gk_step(A, s_, M_apply, N_apply,
                                                  kdotr, MisI, NisI, FC)

        lam_k = s_.lam_k
        lam_on = (lam_k != 0) & bnz
        cL, sL, bLr = sym_givens(beta, lam_k)
        aL = torch.where(lam_on, cL * alpha, alpha)
        bL = torch.where(lam_on, bLr, beta)
        lam_k = torch.where(lam_on, torch.sqrt(lam_k * lam_k
                                               + (sL * alpha) ** 2), lam_k)
        anorm2 = torch.where(bnz, s_.anorm2 + aL * aL + bL * bL, s_.anorm2)
        anorm = torch.sqrt(anorm2)

        cp, sp, gamma = sym_givens(s_.gbar, bL)
        tau = -s_.tau * s_.delta / _safe(gamma)
        delta = sp * aL
        gbar = -cp * aL

        # the σ error-bound machinery (reference :363-376)
        if use_sigma:
            mubar = -s_.csig * gamma
            csig1, ssig1, _ = sym_givens(s_.rhobar_sig, gamma)
            rhobar_sig = ssig1 * mubar + csig1 * sigma_v
            mubar = -csig1 * delta
            h = delta * csig1 / _safe(rhobar_sig)
            disc = sigma_v * (sigma_v - delta * h)
            complex_bnd = s_.complex_bnd | (disc < 0)
            omega = torch.where(disc >= 0, torch.sqrt(torch.clamp(disc,
                                                                  min=0)),
                                s_.omega)
            csig2, ssig2, _ = sym_givens(rhobar_sig, delta)
            rhobar_sig = ssig2 * mubar + csig2 * sigma_v
            csig = csig2
        else:
            rhobar_sig, csig, omega = s_.rhobar_sig, s_.csig, s_.omega
            complex_bnd = s_.complex_bnd

        ebar = -gamma * s_.c
        eta = gamma * s_.s
        c, s, eps_ = sym_givens(ebar, delta)
        smax = torch.maximum(s_.smax, torch.maximum(eps_, torch.abs(ebar)))
        smin = torch.minimum(s_.smin, torch.minimum(eps_, torch.abs(ebar)))
        acond = smax / torch.clamp(smin, min=tiny)

        zold = s_.zeta
        zeta = (tau - s_.zeta * eta) / _safe(eps_)
        zetabar = zeta / _safe(c)
        rNorm = torch.sqrt((s_.psi * cp - zold * eta) ** 2
                           + (s_.psi * sp) ** 2)
        ArNorm = torch.sqrt((gamma * eps_ * zeta) ** 2
                            + (delta * eta * zold) ** 2)
        psi = s_.psi * sp

        x = s_.x + (c * zeta).to(FC) * s_.wbar + (s * zeta).to(FC) * v
        wbar = s.to(FC) * s_.wbar - c.to(FC) * v
        xlqnorm2 = s_.xlqnorm2 + zeta * zeta
        xlqnorm = torch.sqrt(xlqnorm2)
        xcgnorm2 = xlqnorm2 + zetabar * zetabar

        it = s_.iter + 1
        err_vec = s_.err_vec.index_put(
            ((s_.iter % window).long().reshape(1),), zeta.reshape(1))
        err_lbnd = torch.linalg.vector_norm(err_vec)
        fwd_err_lbnd = (s_.iter >= window) & (err_lbnd <= etol * xlqnorm)

        if use_sigma:
            etat = omega * s
            epst = -omega * c
            taut = -tau * delta / _safe(omega)
            zetatilde = (taut - zeta * etat) / _safe(epst)
            disc_cg = s_.zetatilde ** 2 - zetabar ** 2
            complex_bnd = complex_bnd | ((s_.iter > 0) & (disc_cg < 0))
            err_ubnd_cg = torch.sqrt(torch.clamp(disc_cg, min=0))
            fwd_err_ubnd = (s_.iter > 0) & (disc_cg >= 0) & (
                err_ubnd_cg <= utol * torch.sqrt(xcgnorm2))
        else:
            zetatilde = s_.zetatilde
            fwd_err_ubnd = false

        test2 = ArNorm / torch.clamp(anorm * rNorm, min=tiny)
        test3 = 1.0 / torch.clamp(acond, min=tiny)
        t1 = rNorm / (1.0 + anorm * xlqnorm)

        zero_resid = ((1.0 + t1) <= 1.0) | (rNorm <= s_.eps_lim)
        solved = ((1.0 + test2) <= 1.0) | (test2 <= atol) | zero_resid \
            | fwd_err_lbnd | fwd_err_ubnd

        code = _i32(rt.RUNNING, dev)
        for cond, k in ((it >= itmax, rt.TIRED),
                        ((1.0 + test3) <= 1.0, rt.ILL_COND_MACH),
                        (test3 <= ctol, rt.COND_EXCEEDED),
                        (solved, rt.SOLVED_LSQ),
                        (zero_resid, rt.SOLVED_ZERO),
                        (fwd_err_lbnd, FWD_LBND),
                        (fwd_err_ubnd, FWD_UBND)):
            code = torch.where(cond, k, code)

        rt.hist_write_masked(s_.hist_r, active, it, rNorm, history)
        rt.hist_write_masked(s_.hist_ar, active, it, ArNorm, history)
        s_new = s_._replace(
            x=x, u=u, Mu=Mu, v=v, Nv=Nv, wbar=wbar, alpha=alpha, beta=beta,
            lam_k=lam_k, anorm2=anorm2, smax=smax, smin=smin, gbar=gbar,
            psi=psi, c=c, s=s, delta=delta, tau=tau, zeta=zeta,
            zetabar=zetabar, zetatilde=zetatilde, rhobar_sig=rhobar_sig,
            csig=csig, omega=omega, complex_bnd=complex_bnd,
            xlqnorm2=xlqnorm2, err_vec=err_vec, rNorm=rNorm, ArNorm=ArNorm,
            iter=it, status=code.to(torch.int32), zero_resid=zero_resid)
        if verbose > 0 and bool(active):
            # the reference's columns (src/lslq.jl:324) without its timer
            rt.debug_row(verbose, it,
                         "{:5d}  {:7.1e}  {:7.1e}  {:7.1e}  {:7.1e}  "
                         "{:8.1e}  {:8.1e}  {:7.1e}  {:7.1e}  {:7.1e}",
                         rNorm, ArNorm, beta, alpha, c, s, anorm2,
                         smax / smin, xlqnorm)
        if callback is not None:
            s_new = _user_exit(callback, s_new, dev)
        return _masked(LslqState._fields, active, s_new, s_)

    return rt.take_steps(body, state_in, steps, iter_cap, callback)


def _lslq_solve(
    A, b, *, M=None, N=None, ldiv=False, sqd=False, lam=0.0, sigma=0.0,
    transfer_to_lsqr=False, atol=None, rtol=None, btol=None, etol=None,
    utol=None, conlim=1.0e8, window=5, itmax=0, timemax=float("inf"),
    verbose=0, history=False, callback=None,
):
    start = time.perf_counter()
    A, b, M, N, m, n, lam = _ls_inputs(A, b, M, N, sqd, lam)
    T = real_dtype(b.dtype)
    atol = rt.default_tol(atol, T)
    rtol = rt.default_tol(rtol, T)
    btol = rt.default_tol(btol, T)
    etol = rt.default_tol(etol, T)
    utol = rt.default_tol(utol, T)
    itmax = rt.resolve_itmax(itmax, m + n)
    rt.debug_table(verbose, "LSLQ",
                   ("k", "‖r‖", "‖Aᴴr‖", "β", "α", "cos", "sin", "‖A‖²",
                    "κ(A)", "‖xL‖"), m, n)
    hist_len = itmax + 1 if history else 0

    # Fast path: DIA stencil + default config → whole-solve kernel.
    if (M is None and N is None and not history and callback is None
            and verbose == 0 and timemax == float("inf")
            and _fused_ready(A, m, b.dtype, lslq_dia_fused_supported)):
        pd_adj, ot_adj = A.aligned_adjoint_kernel_args()
        x, niter, _, _, code_d, zr, cbnd = lslq_dia_fused(
            A._pd, pd_adj, A._offsets, ot_adj, b.contiguous(), float(lam),
            float(sigma), atol, rtol, btol, etol, utol, float(conlim),
            itmax, use_sigma=bool(sigma > 0),
            transfer_to_lsqr=bool(transfer_to_lsqr), window=int(window))
        niter, code, zr, cbnd = torch.stack([niter, code_d, zr,
                                             cbnd]).tolist()
        code = rt.final_status_code(code, niter, itmax, False)
        stats = LSLQStats(
            niter=niter,
            solved=rt.is_solved_code(code) or code in (FWD_LBND, FWD_UBND),
            inconsistent=_inconsistent(bool(zr), code),
            residuals=np.zeros(0), Aresiduals=np.zeros(0),
            error_with_bnd=bool(cbnd), timer=time.perf_counter() - start,
            status=rt.decode_status(code, _STATUS))
        return x, stats, None

    def run(state, cap, steps):
        return _lslq_core(
            A, M, N, b, state, cap, steps, itmax, atol, rtol, btol, etol,
            utol, float(conlim), float(lam), float(sigma), ldiv=bool(ldiv),
            use_sigma=bool(sigma > 0), history=bool(history),
            hist_len=hist_len, callback=callback, verbose=int(verbose),
            window=int(window), MisI=M is None, NisI=N is None)

    state, overtimed = rt.drive(run, itmax, timemax, start)
    niter = int(state.iter)
    code = rt.final_status_code(state.status, niter, itmax, overtimed)
    x = state.x
    if transfer_to_lsqr and code not in (rt.ZERO_RESIDUAL, rt.MIN_LSQ_X):
        x = x + state.zetabar.to(x.dtype) * state.wbar
    stats = LSLQStats(
        niter=niter,
        solved=rt.is_solved_code(code) or code in (FWD_LBND, FWD_UBND),
        inconsistent=_inconsistent(bool(state.zero_resid), code),
        residuals=_trim(state.hist_r, niter, history),
        Aresiduals=_trim(state.hist_ar, niter, history),
        error_with_bnd=bool(state.complex_bnd),
        timer=time.perf_counter() - start,
        status=rt.decode_status(code, _STATUS))
    return x, stats, state


def lslq(A, b, *, precision=None, **kwargs):
    """x, stats = lslq(A, b; λ, σ, sqd, transfer_to_lsqr, etol, utol, ...).

    ``precision="double_word"`` raises NotImplementedError until the
    iterative refinement (solvers/_refine.py, ROADMAP.md Queue 1 item 8)
    is ported."""
    _no_double_word("LSLQ", precision)
    x, stats, _ = _lslq_solve(A, b, **kwargs)
    return x, stats
