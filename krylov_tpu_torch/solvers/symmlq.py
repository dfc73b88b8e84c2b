"""SYMMLQ for Hermitian (indefinite) Ax = b.

Counterpart of ``krylov_tpu/solvers/symmlq.py`` and of reference
src/symmlq.jl: λ shift (in operator form, (A + λI)v, the JAX package's
documented deviation), λest-based forward-error bounds (err/errcg)
including the retrospective window correction of the recorded errorscg
history (src/symmlq.jl:342-374), transfer_to_cg, conlim, etol,
Anorm/Acond estimates, SymmlqStats with LQ and CG-point residual and
error histories.  A DIA operator with the default options, M = I and
λest = 0 goes to the whole-solve kernel (ops/cuda_fused.py); every other
configuration runs ``_symmlq_core``, whose iterations ``_runtime.drive``
takes in chunks with masked updates.
"""

import math
import time
from typing import NamedTuple

import numpy as np
import torch

from .. import _runtime as rt
from .._dtypes import real_dtype
from ..operators import precond_apply, solve_inputs
from ..ops.cuda_fused import (SOLVED_CG_PT, SOLVED_GEN, SOLVED_LQ,
                              symmlq_dia_fused, symmlq_dia_fused_supported)
from ..ops.kops import kdotr, sym_givens
from ..stats import SymmlqStats
from .cr import _check_square, _fused_ready, _i32, _masked, _no_double_word

_STATUS = {
    SOLVED_GEN: "found approximate solution",
    SOLVED_LQ: "solution xᴸ good enough given atol and rtol",
    SOLVED_CG_PT: "solution xᶜ good enough given atol and rtol",
}
_HIST = ("hist_r", "hist_rcg", "hist_err", "hist_errcg")


class SymmlqState(NamedTuple):
    x: torch.Tensor
    wbar: torch.Tensor
    Mvold: torch.Tensor
    Mv: torch.Tensor
    vold: torch.Tensor
    v: torch.Tensor
    beta: torch.Tensor
    gbar: torch.Tensor
    dbar: torch.Tensor
    eps_old: torch.Tensor
    cold: torch.Tensor
    eta: torch.Tensor
    zold: torch.Tensor
    zetabar: torch.Tensor
    anorm2: torch.Tensor
    gmax: torch.Tensor
    gmin: torch.Tensor
    xnorm2: torch.Tensor
    rNorm: torch.Tensor
    rcgNorm: torch.Tensor
    # λest machinery
    rhobar: torch.Tensor
    sigbar: torch.Tensor
    cw: torch.Tensor
    sw: torch.Tensor
    cwold: torch.Tensor
    err: torch.Tensor
    errcg: torch.Tensor
    clist: torch.Tensor      # (window,) ring of Givens cosines (λest window)
    zlist: torch.Tensor      # (window,) ring of ζ values
    sprod: torch.Tensor      # (window,) running sine products
    tol: torch.Tensor
    iter: torch.Tensor
    status: torch.Tensor
    solved_cg_flag: torch.Tensor
    precond_violation: torch.Tensor
    hist_r: torch.Tensor
    hist_rcg: torch.Tensor
    hist_err: torch.Tensor
    hist_errcg: torch.Tensor


def _safe(d):
    return torch.where(d == 0, torch.ones_like(d), d)


def _set(ring, idx, value):
    """ring with ring[idx] = value (functional; idx a 0-d tensor)."""
    return ring.index_put((idx.reshape(1).long(),), value.reshape(1))


def _symmlq_core(
    A, M, b, x0, state_in, iter_cap, steps, itmax, atol, rtol, etol,
    conlim, lam, lambda_est,
    *, ldiv, transfer_to_cg, use_lambda_est, history, hist_len, callback,
    verbose, MisI, window=5,
):
    """``steps`` SYMMLQ iterations from ``state_in`` (None: start), each
    with its updates masked by ``status == RUNNING and iter <
    iter_cap``."""
    n = b.shape[0]
    FC = b.dtype
    T = real_dtype(FC)
    dev = b.device
    tiny = torch.finfo(T).tiny

    def t_(v):
        return torch.tensor(v, dtype=T, device=dev)

    lam = t_(lam)
    lest = t_(lambda_est)
    ctol = torch.where(t_(conlim) > 0, 1.0 / t_(conlim), t_(0.0))
    nan = t_(math.nan)

    def M_apply(u):
        return precond_apply(M, u, ldiv)

    def op(u):
        # the shifted operator (A + λI)u, as reference src/minres.jl:296
        return A.matvec(u) + lam.to(FC) * u

    def normalise(Mv):
        """β² = ⟨M Mv, Mv⟩, β = √max(β², 0), v = M Mv / β and Mv / β."""
        v = M_apply(Mv)
        beta_sq = kdotr(v, Mv)
        beta = torch.sqrt(torch.clamp(beta_sq, min=0))
        safe_b = _safe(beta).to(FC)
        v = v / safe_b
        return beta_sq, beta, v, (v if MisI else Mv / safe_b)

    if state_in is None:
        beta1_sq, beta1, vold, Mvold = normalise(
            b if x0 is None else b - op(x0))
        wbar = vold
        Mv = op(vold)
        alpha = kdotr(vold, Mv)
        beta_sq, beta, v, Mv = normalise(Mv - alpha.to(FC) * Mvold)
        precond_violation = (beta1_sq < 0) | (beta_sq < 0)

        gbar = alpha
        zetabar = beta1 / _safe(gbar)
        rcgNorm = beta1 * torch.abs(zetabar)
        tol = t_(atol) + t_(rtol) * beta1
        solved_cg0 = (gbar != 0) & transfer_to_cg & (rcgNorm <= tol)
        status = torch.where(
            beta1_sq == 0, rt.ZERO_RESIDUAL,
            torch.where(beta1 <= tol, SOLVED_LQ,
                        torch.where(solved_cg0, SOLVED_CG_PT,
                                    rt.RUNNING))).to(torch.int32)

        # λest init
        rhobar = alpha - lest
        rho = torch.sqrt(rhobar * rhobar + beta * beta)

        hists = [rt.hist_init(hist_len, T, dev) for _ in _HIST]
        zero_i = _i32(0, dev)
        rt.hist_write(hists[0], zero_i, beta1, history)
        rt.hist_write(hists[1], zero_i,
                      torch.where(gbar != 0, rcgNorm, nan), history)
        if use_lambda_est:
            # reference src/symmlq.jl:257-259 pre-loop error bounds
            e0 = torch.abs(beta1 / _safe(lest))
            rt.hist_write(hists[2], zero_i, e0, history)
            rt.hist_write(hists[3], zero_i, torch.where(
                gbar != 0,
                torch.sqrt(torch.clamp(e0 * e0 - zetabar * zetabar, min=0)),
                nan), history)
        state = SymmlqState(
            x=torch.zeros(n, dtype=FC, device=dev), wbar=wbar, Mvold=Mvold,
            Mv=Mv, vold=vold, v=v, beta=beta, gbar=gbar, dbar=beta,
            eps_old=t_(0.0), cold=t_(1.0), eta=beta1, zold=t_(0.0),
            zetabar=zetabar, anorm2=alpha * alpha + beta * beta,
            gmax=t_(-math.inf), gmin=t_(math.inf), xnorm2=t_(0.0),
            rNorm=beta1, rcgNorm=rcgNorm, rhobar=rhobar, sigbar=beta,
            cw=rhobar / _safe(rho), sw=beta / _safe(rho), cwold=t_(-1.0),
            err=t_(math.inf), errcg=t_(math.inf),
            clist=torch.zeros(window, dtype=T, device=dev),
            zlist=torch.zeros(window, dtype=T, device=dev),
            sprod=torch.ones(window, dtype=T, device=dev),
            tol=tol, iter=_i32(0, dev), status=status,
            solved_cg_flag=solved_cg0, precond_violation=precond_violation,
            hist_r=hists[0], hist_rcg=hists[1], hist_err=hists[2],
            hist_errcg=hists[3])
    else:
        state = state_in

    def body(s):
        active = (s.status == rt.RUNNING) & (s.iter < iter_cap)
        it = s.iter + 1
        c, sn, gamma = sym_givens(s.gbar, s.beta)

        zeta = s.eta / _safe(gamma)
        x = s.x + (c * zeta).to(FC) * s.wbar + (sn * zeta).to(FC) * s.v
        wbar = sn.to(FC) * s.wbar - c.to(FC) * s.v

        # Next Lanczos vector.
        oldbeta = s.beta
        Mv_next = op(s.v)
        alpha = kdotr(s.v, Mv_next)
        Mv_next = Mv_next - oldbeta.to(FC) * s.Mvold
        Mv_next = Mv_next - alpha.to(FC) * s.Mv
        beta_sq, beta, v, Mv = normalise(Mv_next)
        precond_violation = s.precond_violation | (beta_sq < 0)

        anorm2 = s.anorm2 + alpha * alpha + oldbeta * oldbeta + beta * beta

        delta = s.dbar * c + alpha * sn
        gbar = s.dbar * sn - alpha * c
        eps_new = beta * sn
        dbar = -beta * c
        eta = -s.eps_old * s.zold - delta * zeta

        rNorm = torch.sqrt(gamma * gamma * zeta * zeta
                           + s.eps_old * s.eps_old * s.zold * s.zold)
        xnorm2 = s.xnorm2 + zeta * zeta

        gbar_nz = gbar != 0
        zetabar = torch.where(gbar_nz, eta / _safe(gbar), s.zetabar)
        rcgNorm = torch.where(
            gbar_nz, beta * torch.abs(sn * zeta - c * zetabar), s.rcgNorm)

        lam_state = {}
        if use_lambda_est:
            eta_w = -oldbeta * oldbeta * s.cwold / _safe(s.rhobar)
            omega = lest + eta_w
            psi = c * s.dbar + sn * omega
            omegabar = sn * s.dbar - c * omega
            # Retrospective window correction of the recorded errorscg
            # history (reference src/symmlq.jl:342-374): the ζ/c/s rings
            # refine the entry written `window` iterations ago.
            idxs = torch.arange(window, device=dev)
            sprod = torch.where((it < window) & (idxs >= it),
                                s.sprod * sn, s.sprod) if window > 1 \
                else s.sprod
            ix = torch.remainder(it - 1, window)
            clist = _set(s.clist, ix, c)
            zlist = _set(s.zlist, ix, zeta)
            if history and window > 0:
                jx = torch.remainder(it, window).long()
                zetabark = zlist[jx] / _safe(clist[jx])
                theta0 = torch.sum(clist * sprod * zlist)
                theta = (zetabark * torch.abs(theta0)
                         + torch.abs(zetabark * zetabar * sprod[ix.long()]
                                     * sn)
                         - zetabark * zetabark)
                back = torch.clamp(it - window, min=0)
                old = s.hist_errcg[back.long()]
                corr = torch.where(
                    gbar_nz, torch.sqrt(torch.abs(old * old - 2 * theta)),
                    nan)
                rt.hist_write_masked(s.hist_errcg, active, back,
                                     torch.where(it >= window, corr, old),
                                     history)
            if window > 1:
                ixp = torch.remainder(it, window)
                q = torch.remainder(ixp + 1, window).long()
                sprod_n = sprod / _safe(sprod[q])
                sprod_n = _set(sprod_n, ixp, sprod_n[torch.remainder(
                    ixp - 1, window).long()] * sn)
                sprod = torch.where(it >= window, sprod_n, sprod)

            err = torch.abs((s.eps_old * s.zold + psi * zeta)
                            / _safe(omegabar))
            errcg = torch.where(
                gbar_nz, torch.sqrt(torch.abs(err * err - zetabar * zetabar)),
                s.errcg)
            rt.hist_write_masked(s.hist_err, active, it, err, history)
            rt.hist_write_masked(s.hist_errcg, active, it,
                                 torch.where(gbar_nz, errcg, nan), history)
            rhobar = s.sw * s.sigbar - s.cw * (alpha - lest)
            rho = torch.sqrt(rhobar * rhobar + beta * beta)
            lam_state = dict(
                clist=clist, zlist=zlist, sprod=sprod, err=err, errcg=errcg,
                rhobar=rhobar, sigbar=-s.cw * beta, cwold=s.cw,
                cw=rhobar / _safe(rho), sw=beta / _safe(rho))
        err = lam_state.get("err", s.err)
        errcg = lam_state.get("errcg", s.errcg)

        gmax = torch.maximum(s.gmax, gamma)
        gmin = torch.minimum(s.gmin, gamma)
        acond = gmax / torch.clamp(gmin, min=tiny)
        anorm = torch.sqrt(anorm2)
        test1 = rNorm / torch.clamp(anorm * torch.sqrt(xnorm2), min=tiny)
        acond_t = torch.clamp(acond, min=tiny)

        resid_decrease_mach = (1.0 + rNorm) <= 1.0
        ill_cond_mach = (1.0 + 1.0 / acond_t) <= 1.0
        zero_resid_mach = (1.0 + test1) <= 1.0
        tired = it >= itmax
        ill_cond_lim = (1.0 / acond_t) <= ctol
        zero_resid_lim = test1 <= s.tol
        fwd_err = (err <= etol) | (gbar_nz & (errcg <= etol))
        solved_lq = rNorm <= s.tol
        solved_cg = gbar_nz & (rcgNorm <= s.tol) & transfer_to_cg
        solved = (resid_decrease_mach | solved_lq | solved_cg
                  | zero_resid_mach | zero_resid_lim | fwd_err)

        code = _i32(rt.RUNNING, dev)
        for cond, value in ((tired, rt.TIRED), (ill_cond_mach,
                                                rt.ILL_COND_MACH),
                            (ill_cond_lim, rt.COND_EXCEEDED),
                            (solved, SOLVED_GEN),
                            (solved & solved_lq, SOLVED_LQ),
                            (solved & solved_cg, SOLVED_CG_PT)):
            code = torch.where(cond, value, code)

        rt.hist_write_masked(s.hist_r, active, it, rNorm, history)
        rt.hist_write_masked(s.hist_rcg, active, it,
                             torch.where(gbar_nz, rcgNorm, nan), history)
        s_new = s._replace(
            x=x, wbar=wbar, Mvold=s.Mv, Mv=Mv, vold=s.v, v=v, beta=beta,
            gbar=gbar, dbar=dbar, eps_old=eps_new, cold=c, eta=eta,
            zold=zeta, zetabar=zetabar, anorm2=anorm2, gmax=gmax, gmin=gmin,
            xnorm2=xnorm2, rNorm=rNorm, rcgNorm=rcgNorm, iter=it,
            status=code.to(torch.int32), solved_cg_flag=solved_cg,
            precond_violation=precond_violation, **lam_state)
        if callback is not None:
            user_exit = torch.as_tensor(callback(s_new), device=dev)
            s_new = s_new._replace(status=torch.where(
                user_exit, rt.USER_EXIT, s_new.status).to(torch.int32))
        if verbose > 0 and bool(active):
            rt.debug_row(
                verbose, it,
                "{:5d}  {:7.1e}  {:7.1e}  {:8.1e}  {:8.1e}  {:7.1e}  "
                "{:7.1e}  {:7.1e}",
                rNorm, beta, c, sn, anorm, acond, test1)
        return _masked(SymmlqState._fields, active, s_new, s, keep=_HIST)

    return rt.take_steps(body, state, steps, iter_cap, callback)


def _acond(gmax, gmin):
    return (gmax / max(gmin, 1e-300) if np.isfinite(gmax) and gmax >= 0
            else float("nan"))


def _symmlq_solve(
    A, b, x0=None, *, M=None, ldiv=False, lam=0.0, lambda_est=0.0,
    transfer_to_cg=True, atol=None, rtol=None, etol=None, conlim=1.0e8,
    window=5, itmax=0, timemax=float("inf"), verbose=0, history=False,
    callback=None,
):
    start = time.perf_counter()
    A, b, x0, M = solve_inputs(A, b, x0, M)
    n = b.shape[0]
    _check_square(A, n)
    T = real_dtype(b.dtype)
    atol = rt.default_tol(atol, T)
    rtol = rt.default_tol(rtol, T)
    etol = rt.default_tol(etol, T)
    itmax = rt.resolve_itmax(itmax, 2 * n)
    hist_len = itmax + 1 if history else 0
    rt.debug_header(verbose, f"SYMMLQ: system of size {n}")
    rt.debug_header(
        verbose,
        f"{'k':>5s}  {'‖r‖':>7s}  {'β':>7s}  {'cos':>8s}  {'sin':>8s}  "
        f"{'‖A‖':>7s}  {'κ(A)':>7s}  {'test1':>7s}")

    # Fast path: DIA stencil + default config → whole-solve kernel.
    if (M is None and lambda_est == 0 and callback is None and verbose == 0
            and not history and timemax == float("inf")
            and _fused_ready(A, n, b.dtype, symmlq_dia_fused_supported)):
        ctol = 1.0 / conlim if conlim > 0 else 0.0
        b_eff = b if x0 is None else \
            b - (A.matvec(x0) + torch.tensor(lam, dtype=b.dtype,
                                             device=b.device) * x0)
        x, niter, _, code_d, anorm2, gmax, gmin = symmlq_dia_fused(
            A._pd, A._offsets, b_eff.contiguous(), atol, rtol, ctol,
            float(lam), itmax, transfer_to_cg=bool(transfer_to_cg))
        niter, code = torch.stack([niter, code_d]).tolist()
        anorm2, gmax, gmin = torch.stack([anorm2, gmax, gmin]).tolist()
        code = rt.final_status_code(code, niter, itmax, False)
        if x0 is not None:
            x = x + x0
        stats = SymmlqStats(
            niter=niter,
            solved=rt.is_solved_code(code) or code in _STATUS,
            residuals=np.zeros(0), residualscg=np.zeros(0),
            errors=np.zeros(0), errorscg=np.zeros(0),
            Anorm=math.sqrt(anorm2), Acond=_acond(gmax, gmin),
            timer=time.perf_counter() - start,
            status=rt.decode_status(code, _STATUS),
        )
        return x, stats, None

    def run(state, cap, steps):
        return _symmlq_core(
            A, M, b, x0, state, cap, steps, itmax, atol, rtol, etol,
            float(conlim), float(lam), float(lambda_est),
            ldiv=bool(ldiv), transfer_to_cg=bool(transfer_to_cg),
            use_lambda_est=bool(lambda_est != 0), history=bool(history),
            hist_len=hist_len, callback=callback, verbose=int(verbose),
            MisI=M is None, window=int(window),
        )

    state, overtimed = rt.drive(run, itmax, timemax, start)
    if bool(state.precond_violation):
        raise ValueError("Preconditioner is not positive definite")
    niter = int(state.iter)
    code = rt.final_status_code(state.status, niter, itmax, overtimed)
    # Transfer to the CG point when it triggered the stop
    # (reference src/symmlq.jl:437-440).
    x = torch.where(state.solved_cg_flag,
                    state.x + state.zetabar.to(b.dtype) * state.wbar,
                    state.x)
    if x0 is not None:
        x = x + x0
    use_lest = history and lambda_est != 0
    stats = SymmlqStats(
        niter=niter,
        solved=rt.is_solved_code(code) or code in _STATUS,
        residuals=rt.hist_trim(state.hist_r, niter) if history
        else np.zeros(0),
        residualscg=rt.hist_trim(state.hist_rcg, niter) if history
        else np.zeros(0),
        errors=rt.hist_trim(state.hist_err, niter) if use_lest
        else np.zeros(0),
        errorscg=rt.hist_trim(state.hist_errcg, niter) if use_lest
        else np.zeros(0),
        Anorm=float(torch.sqrt(state.anorm2)),
        Acond=_acond(float(state.gmax), float(state.gmin)),
        timer=time.perf_counter() - start,
        status=rt.decode_status(code, _STATUS),
    )
    return x, stats, state


def symmlq(A, b, x0=None, *, precision=None, **kwargs):
    """x, stats = symmlq(A, b; λ, λest, transfer_to_cg, ...).

    ``precision="double_word"`` raises NotImplementedError until the
    iterative refinement (solvers/_refine.py, ROADMAP.md Queue 1) is
    ported."""
    _no_double_word("SYMMLQ", precision)
    x, stats, _ = _symmlq_solve(A, b, x0, **kwargs)
    return x, stats
