"""MINRES-QLP for Hermitian (singular or indefinite) Ax = b.

Counterpart of ``krylov_tpu/solvers/minres_qlp.py`` and of reference
src/minres_qlp.jl: the minimum-norm least-squares solution of singular
systems, with the λ shift (solves A + λI), M preconditioning (ldiv), the
Artol inconsistency test, the linesearch nonpositive-curvature exit, the
QLP (QR then LQ) factorisation of the Lanczos tridiagonal with its
three-term direction recurrences, the μmin/μmax condition estimate,
warm start, history, callback and verbose.  The reference's iter == 1 /
2 / ≥ 3 branches are where-selects over 0-d tensors.  A DIA operator
with the default options and M = I goes to the whole-solve kernel
(ops/cuda_fused.py); every other configuration runs
``_minres_qlp_core``, whose iterations ``_runtime.drive`` takes in chunks
with masked updates.
"""

import time
from typing import NamedTuple

import numpy as np
import torch

from .. import _runtime as rt
from .._dtypes import real_dtype
from ..operators import precond_apply, solve_inputs
from ..ops.cuda_fused import (minres_qlp_dia_fused,
                              minres_qlp_dia_fused_supported)
from ..ops.kops import kdotr, knorm, sym_givens
from ..stats import SimpleStats
from .cr import (_check_square, _fused_ready, _i32, _masked,
                 _no_double_word, _trim)


class MinresQlpState(NamedTuple):
    x: torch.Tensor
    vk: torch.Tensor            # normalised Lanczos vector vₖ (M-image)
    Minv_vk: torch.Tensor
    Minv_vkm1: torch.Tensor
    w_km1: torch.Tensor
    w_k: torch.Tensor
    npc_dir: torch.Tensor
    beta_k: torch.Tensor
    zetabar: torch.Tensor
    xi_km1: torch.Tensor
    tau_km2: torch.Tensor
    tau_km1: torch.Tensor
    tau_k: torch.Tensor
    psibar_km2: torch.Tensor
    mubis_km2: torch.Tensor
    mubar_km1: torch.Tensor
    c_km2: torch.Tensor
    c_km1: torch.Tensor
    s_km2: torch.Tensor
    s_km1: torch.Tensor
    mumin: torch.Tensor
    mumax: torch.Tensor
    anorm2: torch.Tensor
    rNorm: torch.Tensor
    ArNorm: torch.Tensor
    kappa: torch.Tensor
    eps_lim: torch.Tensor
    iter: torch.Tensor
    status: torch.Tensor
    inconsistent: torch.Tensor
    indefinite: torch.Tensor
    npc_count: torch.Tensor
    hist_r: torch.Tensor
    hist_ar: torch.Tensor


def _safe(d):
    return torch.where(d == 0, torch.ones_like(d), d)


def _minres_qlp_core(
    A, M, b, x0, state_in, iter_cap, steps, itmax, atol, rtol, Artol, lam,
    *, ldiv, linesearch, history, hist_len, callback, verbose, MisI,
):
    """``steps`` MINRES-QLP iterations from ``state_in`` (None: start),
    each with its updates masked by ``status == RUNNING and iter <
    iter_cap``."""
    n = b.shape[0]
    FC = b.dtype
    T = real_dtype(FC)
    dev = b.device
    eps_T = torch.finfo(T).eps
    tiny = torch.finfo(T).tiny

    def t_(v):
        return torch.tensor(v, dtype=T, device=dev)

    zero = t_(0.0)
    lam = t_(lam)
    btol = t_(eps_T ** 0.75)
    atol_t, Artol_t = t_(atol), t_(Artol)

    def M_apply(u):
        return precond_apply(M, u, ldiv)

    if state_in is None:
        x = torch.zeros(n, dtype=FC, device=dev)
        Minv_v = b if x0 is None else b - (A.matvec(x0) + lam.to(FC) * x0)
        vk = M_apply(Minv_v)
        beta = torch.sqrt(torch.clamp(kdotr(vk, Minv_v), min=0))
        safe_b = _safe(beta).to(FC)
        Minv_v = torch.where(beta != 0, Minv_v / safe_b, Minv_v)
        vk = Minv_v if MisI else torch.where(beta != 0, vk / safe_b, vk)
        eps_lim = atol_t + t_(rtol) * beta
        status = torch.where(
            beta == 0, rt.ZERO_RESIDUAL,
            torch.where(beta <= eps_lim, rt.SOLVED, rt.RUNNING)).to(
                torch.int32)
        hr = rt.hist_write(rt.hist_init(hist_len, T, dev), _i32(0, dev),
                           beta, history)
        false = torch.zeros((), dtype=torch.bool, device=dev)
        state = MinresQlpState(
            x=x, vk=vk, Minv_vk=Minv_v,
            Minv_vkm1=torch.zeros(n, dtype=FC, device=dev),
            w_km1=torch.zeros(n, dtype=FC, device=dev),
            w_k=torch.zeros(n, dtype=FC, device=dev),
            npc_dir=vk if linesearch else vk[:0],
            beta_k=beta, zetabar=beta,
            xi_km1=zero, tau_km2=zero, tau_km1=zero, tau_k=zero,
            psibar_km2=zero, mubis_km2=zero, mubar_km1=zero,
            c_km2=t_(1.0), c_km1=t_(1.0), s_km2=zero, s_km1=zero,
            mumin=zero, mumax=zero, anorm2=zero, rNorm=beta,
            ArNorm=zero, kappa=zero, eps_lim=eps_lim,
            iter=_i32(0, dev), status=status, inconsistent=false,
            indefinite=false, npc_count=_i32(0, dev),
            hist_r=hr, hist_ar=rt.hist_init(hist_len, T, dev),
        )
    else:
        state = state_in

    def body(s):
        active = (s.status == rt.RUNNING) & (s.iter < iter_cap)
        it = s.iter + 1
        is1, is2, ge2, ge3 = it == 1, it == 2, it >= 2, it >= 3

        # Lanczos step.
        p = A.matvec(s.vk) + lam.to(FC) * s.vk
        p = torch.where(ge2, p - s.beta_k.to(FC) * s.Minv_vkm1, p)
        alpha = kdotr(s.vk, p)
        p = p - alpha.to(FC) * s.Minv_vk
        vkp1 = M_apply(p)
        beta_kp1 = torch.sqrt(torch.clamp(kdotr(vkp1, p), min=0))
        norm_ok = beta_kp1 > btol
        safe_bk = _safe(beta_kp1).to(FC)
        vkp1 = torch.where(norm_ok, vkp1 / safe_bk, vkp1)
        p_scaled = vkp1 if MisI else torch.where(norm_ok, p / safe_bk, p)
        anorm2 = s.anorm2 + alpha * alpha + s.beta_k * s.beta_k \
            + beta_kp1 * beta_kp1

        # Apply the previous reflections.
        eps_km2 = torch.where(ge3, s.s_km2 * s.beta_k, zero)
        gbar_km1 = torch.where(ge3, -s.c_km2 * s.beta_k,
                               torch.where(is2, s.beta_k, zero))
        g_km1 = s.c_km1 * gbar_km1 + s.s_km1 * alpha
        lbar_k = torch.where(is1, alpha, s.s_km1 * gbar_km1 - s.c_km1 * alpha)

        # Nonpositive-curvature exit (reference :304-327).
        if linesearch:
            cgam = torch.where(is1, -alpha, s.c_km1 * lbar_k)
            npc_exit = cgam >= 0
        else:
            npc_exit = torch.zeros((), dtype=torch.bool, device=dev)

        ck, sk, l_k = sym_givens(lbar_k, beta_kp1)
        zeta = ck * s.zetabar
        zetabar_next = sk * s.zetabar

        npc_dir = s.npc_dir
        if linesearch:
            npc_dir_new = (sk * sk).to(FC) * s.npc_dir \
                - (zetabar_next * ck).to(FC) * vkp1
            npc_dir = torch.where(npc_exit, s.npc_dir, npc_dir_new)

        # LQ update of Rₖ.
        cp2, sp2, mubis2 = sym_givens(s.mubar_km1, g_km1)    # it == 2
        cp3, sp3, mu_km2 = sym_givens(s.mubis_km2, eps_km2)  # it ≥ 3
        psi_km2 = cp3 * s.psibar_km2 + sp3 * g_km1
        theta_k = sp3 * s.psibar_km2 - cp3 * g_km1
        rho_km2 = sp3 * l_k
        eta_k = -cp3 * l_k
        cd, sd, mubis3 = sym_givens(s.mubar_km1, theta_k)
        psibar3 = sd * eta_k
        mubar3 = -cd * eta_k

        mubar_k = torch.where(is1, l_k, torch.where(is2, -cp2 * l_k, mubar3))
        psibar_km1 = torch.where(is2, sp2 * l_k,
                                 torch.where(ge3, psibar3, zero))
        mubis_km1 = torch.where(is2, mubis2, torch.where(ge3, mubis3, zero))
        cp = torch.where(is2, cp2, cp3)
        sp = torch.where(is2, sp2, sp3)

        # Solve Lₖ tₖ = zₖ.
        tau_km2_new = torch.where(
            ge3, s.tau_km1 * s.mubis_km2 / _safe(mu_km2), s.tau_km2)
        tau_km1_new = torch.where(
            is2, s.tau_k * s.mubar_km1 / _safe(mubis2),
            torch.where(ge3,
                        (s.xi_km1 - psi_km2 * tau_km2_new) / _safe(mubis3),
                        s.tau_km1))
        xi_k = torch.where(ge3, zeta - rho_km2 * tau_km2_new, zeta)
        tau_k_new = torch.where(
            is1, zeta / _safe(mubar_k),
            (xi_k - psibar_km1 * tau_km1_new) / _safe(mubar_k))

        # Direction updates (columns of Wₖ = Vₖ Pₖᴴ).
        cpc, spc, cdc, sdc = (v.to(FC) for v in (cp, sp, cd, sd))
        waux = spc * s.w_km1 - cpc * s.vk
        w_km1_new = torch.where(
            is1, s.w_km1, torch.where(is2, cpc * s.w_k + spc * s.vk,
                                      cdc * s.w_k + sdc * waux))
        w_k_new = torch.where(
            is1, s.vk, torch.where(is2, spc * s.w_k - cpc * s.vk,
                                   sdc * s.w_k - cdc * waux))
        x_add3 = (cp * tau_km2_new).to(FC) * s.w_km1 \
            + (sp * tau_km2_new).to(FC) * s.vk
        x_new = torch.where(ge3, s.x + x_add3, s.x)

        # npc exit: x ← b when iter == 1 (reference :313-315).
        if linesearch:
            x_new = torch.where(npc_exit, torch.where(is1, b, s.x), x_new)

        rNorm = torch.abs(zetabar_next)
        ArNorm = torch.abs(s.zetabar) * torch.sqrt(
            lbar_k * lbar_k + (s.c_km1 * beta_kp1) ** 2)
        kappa = torch.where(is1, atol_t + Artol_t * ArNorm, s.kappa)

        abs_mubar = torch.abs(mubar_k)
        lo = torch.minimum(mubis_km1, abs_mubar)
        hi = torch.maximum(mubis_km1, abs_mubar)
        mumin = torch.where(is1, abs_mubar, torch.where(
            is2, torch.minimum(s.mumin, lo),
            torch.minimum(s.mumin, torch.minimum(mu_km2, lo))))
        mumax = torch.where(is1, abs_mubar, torch.where(
            is2, torch.maximum(s.mumax, hi),
            torch.maximum(s.mumax, torch.maximum(mu_km2, hi))))
        acond = mumax / torch.clamp(mumin, min=tiny)
        anorm = torch.sqrt(anorm2)
        xnorm = knorm(x_new)
        backward = rNorm / torch.clamp(anorm * xnorm, min=tiny)

        ill_cond_mach = (1.0 + 1.0 / torch.clamp(acond, min=tiny)) <= 1.0
        resid_decrease_mach = (1.0 + rNorm) <= 1.0
        zero_resid_mach = (1.0 + backward) <= 1.0
        tired = it >= itmax
        resid_decrease_lim = rNorm <= s.eps_lim
        zero_resid_lim = (backward <= eps_T) & MisI
        breakdown = beta_kp1 <= btol
        zero_resid = zero_resid_mach | zero_resid_lim
        solved = resid_decrease_mach | resid_decrease_lim | zero_resid
        inconsistent = ((ArNorm <= kappa) & (abs_mubar <= Artol_t)) \
            | (breakdown & ~solved)

        # Status chain (reference :518-524, later assignment wins).
        code = _i32(rt.RUNNING, dev)
        for cond, c in ((tired, rt.TIRED), (ill_cond_mach, rt.ILL_COND_MACH),
                        (inconsistent, rt.SOLVED_LSQ),
                        (zero_resid, rt.SOLVED_ZERO), (solved, rt.SOLVED),
                        (npc_exit, rt.NPC)):
            code = torch.where(cond, c, code)

        rt.hist_write_masked(s.hist_r, active, it, rNorm, history)
        rt.hist_write_masked(s.hist_ar, active, it, ArNorm, history)
        s_new = s._replace(
            x=x_new,
            vk=torch.where(npc_exit, s.vk, p_scaled if MisI else vkp1),
            Minv_vk=torch.where(npc_exit, s.Minv_vk, p_scaled),
            Minv_vkm1=torch.where(npc_exit, s.Minv_vkm1, s.Minv_vk),
            w_km1=w_km1_new, w_k=w_k_new, npc_dir=npc_dir,
            beta_k=torch.where(npc_exit, s.beta_k, beta_kp1),
            zetabar=torch.where(npc_exit, s.zetabar, zetabar_next),
            xi_km1=xi_k, tau_km2=tau_km2_new, tau_km1=tau_km1_new,
            tau_k=tau_k_new,
            psibar_km2=torch.where(ge2, psibar_km1, s.psibar_km2),
            mubis_km2=torch.where(ge2, mubis_km1, s.mubis_km2),
            mubar_km1=mubar_k,
            c_km2=torch.where(ge2, s.c_km1, s.c_km2),
            s_km2=torch.where(ge2, s.s_km1, s.s_km2),
            c_km1=ck, s_km1=sk,
            mumin=mumin, mumax=mumax, anorm2=anorm2,
            rNorm=rNorm, ArNorm=ArNorm, kappa=kappa,
            iter=it, status=code.to(torch.int32), inconsistent=inconsistent,
            indefinite=s.indefinite | npc_exit,
            npc_count=torch.where(npc_exit, 1, s.npc_count).to(torch.int32),
        )
        if verbose > 0 and bool(active):
            # reference column set src/minres_qlp.jl:208 (timer omitted)
            rt.debug_row(verbose, it,
                         "{:5d}  {:7.1e}  {:7.1e}  {:7.1e}  {:7.1e}  "
                         "{:8.1e}  {:7.1e}  {:7.1e}  {:8.1e}",
                         rNorm, ArNorm, beta_kp1, l_k, mubar_k, anorm,
                         kappa, backward)
        if callback is not None:
            user_exit = torch.as_tensor(callback(s_new), device=dev)
            s_new = s_new._replace(status=torch.where(
                user_exit & (s_new.status == rt.RUNNING), rt.USER_EXIT,
                s_new.status).to(torch.int32))
        return _masked(MinresQlpState._fields, active, s_new, s)

    return rt.take_steps(body, state, steps, iter_cap, callback)


def _minres_qlp_solve(
    A, b, x0=None, *, M=None, ldiv=False, linesearch=False, lam=0.0,
    Artol=None, atol=None, rtol=None, itmax=0, timemax=float("inf"),
    verbose=0, history=False, callback=None,
):
    start = time.perf_counter()
    A, b, x0, M = solve_inputs(A, b, x0, M)
    n = b.shape[0]
    _check_square(A, n)
    if x0 is not None and linesearch:
        raise ValueError("warm_start and linesearch cannot be used together")
    T = real_dtype(b.dtype)
    atol = rt.default_tol(atol, T)
    rtol = rt.default_tol(rtol, T)
    Artol = rt.default_tol(Artol, T)
    itmax = rt.resolve_itmax(itmax, 2 * n)
    rt.debug_table(verbose, "MINRES-QLP",
                   ("k", "‖rₖ‖", "‖Arₖ₋₁‖", "βₖ₊₁", "Rₖ.ₖ", "Lₖ.ₖ",
                    "‖A‖", "κ(A)", "backward"), n)
    hist_len = itmax + 1 if history else 0

    # Fast path: DIA stencil + default config → whole-solve kernel.
    if (M is None and not linesearch and callback is None and verbose == 0
            and not history and timemax == float("inf")
            and _fused_ready(A, n, b.dtype, minres_qlp_dia_fused_supported)):
        b_eff = b if x0 is None else \
            b - (A.matvec(x0) + torch.tensor(lam, dtype=b.dtype,
                                             device=b.device) * x0)
        x, niter, _, code_d, incon, _ = minres_qlp_dia_fused(
            A._pd, A._offsets, b_eff.contiguous(), atol, rtol, Artol,
            float(lam), itmax)
        niter, code, incon = torch.stack([niter, code_d, incon]).tolist()
        code = rt.final_status_code(code, niter, itmax, False)
        if x0 is not None:
            x = x + x0
        stats = SimpleStats(
            niter=niter,
            solved=rt.is_solved_code(code),
            inconsistent=bool(incon) and code != rt.ZERO_RESIDUAL,
            indefinite=False,
            npc_count=0,
            residuals=np.zeros(0),
            timer=time.perf_counter() - start,
            status=rt.decode_status(code),
        )
        return x, stats, None

    def run(state, cap, steps):
        return _minres_qlp_core(
            A, M, b, x0, state, cap, steps, itmax, atol, rtol, Artol,
            float(lam), ldiv=bool(ldiv), linesearch=bool(linesearch),
            history=bool(history), hist_len=hist_len, callback=callback,
            verbose=int(verbose), MisI=M is None,
        )

    state, overtimed = rt.drive(run, itmax, timemax, start)
    niter = int(state.iter)
    code = rt.final_status_code(state.status, niter, itmax, overtimed)

    # Finalize x (reference :509-515), skipped on the npc exit.
    x = state.x
    if code != rt.NPC:
        if niter >= 2:
            x = x + state.tau_km1.to(b.dtype) * state.w_km1
        if not bool(state.inconsistent):
            x = x + state.tau_k.to(b.dtype) * state.w_k
    if x0 is not None and code != rt.NPC:
        x = x + x0

    stats = SimpleStats(
        niter=niter,
        solved=rt.is_solved_code(code),
        inconsistent=(bool(state.inconsistent)
                      and code not in (rt.ZERO_RESIDUAL, rt.NPC)),
        indefinite=bool(state.indefinite),
        npc_count=int(state.npc_count),
        residuals=_trim(state.hist_r, niter, history),
        Aresiduals=_trim(state.hist_ar, niter, history),
        timer=time.perf_counter() - start,
        status=rt.decode_status(code),
    )
    return x, stats, state


def minres_qlp(A, b, x0=None, *, precision=None, **kwargs):
    """x, stats = minres_qlp(A, b; λ, Artol, linesearch, ...).

    ``precision="double_word"`` raises NotImplementedError until the
    iterative refinement (solvers/_refine.py, ROADMAP.md Queue 1 item 8)
    is ported."""
    _no_double_word("MINRES-QLP", precision)
    x, stats, _ = _minres_qlp_solve(A, b, x0, **kwargs)
    return x, stats
