"""MINARES for Hermitian Ax = b: minimises ‖Arₖ‖ over the Krylov space.

Counterpart of ``krylov_tpu/solvers/minares.py`` and of reference
src/minares.jl: the λ shift (solves A + λI), the Artol stop on ‖Arₖ‖,
the QR-within-QR (Tₖ₊₁.ₖ, then Nₖ) reflection cascade, the Wₖ and Dₖ
direction recurrences, the π/τ residual estimates and the ℓ
bookkeeping that stops the Lanczos process at its breakdown while the
iteration goes on, with warm start, history, callback and verbose.  The
iter == 1 / 2 / ≥ 3 branches are where-selects over 0-d tensors.  A DIA
operator with the default options goes to the whole-solve kernel
(ops/cuda_fused.py); every other configuration runs ``_minares_core``,
whose iterations ``_runtime.drive`` takes in chunks with masked updates.
"""

import time
from typing import NamedTuple

import numpy as np
import torch

from .. import _runtime as rt
from .._dtypes import real_dtype
from ..operators import solve_inputs
from ..ops.cuda_fused import (SOLVED_ARTOL, minares_dia_fused,
                              minares_dia_fused_supported)
from ..ops.kops import kdotr, knorm, sym_givens
from ..stats import SimpleStats
from .cr import _check_square, _fused_ready, _i32, _masked, \
    _no_double_word, _trim

_STATUS = {SOLVED_ARTOL: "solution good enough given atol, rtol and Artol"}


class MinaresState(NamedTuple):
    x: torch.Tensor
    vk: torch.Tensor
    vkp1: torch.Tensor
    w_km2: torch.Tensor
    w_km1: torch.Tensor
    d_km2: torch.Tensor
    d_km1: torch.Tensor
    alpha_k: torch.Tensor
    beta_k: torch.Tensor
    beta_kp1: torch.Tensor
    gamma_km1: torch.Tensor
    lambdabar_k: torch.Tensor
    gammabar_k: torch.Tensor
    eps_km2: torch.Tensor
    eps_km1: torch.Tensor
    xi_km1: torch.Tensor
    tau_km2: torch.Tensor
    tau_km1: torch.Tensor
    tau_k: torch.Tensor
    thetabar_km2: torch.Tensor
    psibis_km2: torch.Tensor
    psibar_km1: torch.Tensor
    pi_km2: torch.Tensor
    pi_km1: torch.Tensor
    chibar_k: torch.Tensor
    zetabis_k: torch.Tensor
    zetabar_kp1: torch.Tensor
    ct4: torch.Tensor   # c̃₂ₖ₋₄
    st4: torch.Tensor
    ct3: torch.Tensor   # c̃₂ₖ₋₃
    st3: torch.Tensor
    ct2: torch.Tensor   # c̃₂ₖ₋₂
    st2: torch.Tensor
    ell: torch.Tensor
    rNorm: torch.Tensor
    ArNorm: torch.Tensor
    kappa: torch.Tensor
    eps_lim: torch.Tensor
    iter: torch.Tensor
    status: torch.Tensor
    hist_r: torch.Tensor
    hist_ar: torch.Tensor


def _safe(d):
    return torch.where(d == 0, torch.ones_like(d), d)


def _minares_core(
    A, b, x0, state_in, iter_cap, steps, itmax, atol, rtol, Artol, lam,
    *, history, hist_len, callback, verbose,
):
    """``steps`` MINARES iterations from ``state_in`` (None: start), each
    with its updates masked by ``status == RUNNING and iter <
    iter_cap``."""
    n = b.shape[0]
    FC = b.dtype
    T = real_dtype(FC)
    dev = b.device

    def t_(v):
        return torch.tensor(v, dtype=T, device=dev)

    zero, one = t_(0.0), t_(1.0)
    lam = t_(lam)
    btol = t_(torch.finfo(T).eps ** 0.75)

    def Ashift(u):
        return A.matvec(u) + lam.to(FC) * u

    if state_in is None:
        x = torch.zeros(n, dtype=FC, device=dev)
        r0 = b if x0 is None else b - Ashift(x0)
        beta1 = knorm(r0)
        vk = r0 / _safe(beta1).to(FC)
        # First Lanczos step (reference :160-170).
        q = Ashift(vk)
        alpha1 = kdotr(vk, q)
        q = q - alpha1.to(FC) * vk
        beta2 = knorm(q)
        vkp1 = torch.where(beta2 != 0, q / _safe(beta2).to(FC), q)

        b1a1 = beta1 * alpha1
        b1b2 = beta1 * beta2
        ArNorm0 = torch.sqrt(b1a1 * b1a1 + b1b2 * b1b2)
        eps_lim = t_(atol) + t_(rtol) * beta1
        kappa = t_(atol) + t_(Artol) * ArNorm0
        status = torch.where(
            beta1 == 0, rt.ZERO_RESIDUAL,
            torch.where((beta1 <= eps_lim) | (ArNorm0 <= kappa),
                        SOLVED_ARTOL, rt.RUNNING)).to(torch.int32)
        hr = rt.hist_write(rt.hist_init(hist_len, T, dev), _i32(0, dev),
                           beta1, history)
        har = rt.hist_write(rt.hist_init(hist_len, T, dev), _i32(0, dev),
                            ArNorm0, history)
        vecs = {k: torch.zeros(n, dtype=FC, device=dev)
                for k in ("w_km2", "w_km1", "d_km2", "d_km1")}
        scal = {k: zero for k in (
            "gamma_km1", "lambdabar_k", "gammabar_k", "eps_km2", "eps_km1",
            "xi_km1", "tau_km2", "tau_km1", "tau_k", "thetabar_km2",
            "psibis_km2", "psibar_km1", "pi_km2", "pi_km1", "chibar_k",
            "ct4", "st4", "ct3", "st3", "ct2", "st2")}
        state = MinaresState(
            x=x, vk=vk, vkp1=vkp1, **vecs, **scal,
            alpha_k=alpha1, beta_k=beta1, beta_kp1=beta2,
            zetabis_k=b1a1, zetabar_kp1=b1b2, ell=_i32(itmax + 2, dev),
            rNorm=beta1, ArNorm=ArNorm0, kappa=kappa, eps_lim=eps_lim,
            iter=_i32(0, dev), status=status, hist_r=hr, hist_ar=har,
        )
    else:
        state = state_in

    def body(s):
        active = (s.status == rt.RUNNING) & (s.iter < iter_cap)
        it = s.iter + 1
        is1, is2, ge2, ge3 = it == 1, it == 2, it >= 2, it >= 3
        lambdabar_k = torch.where(is1, s.alpha_k, s.lambdabar_k)
        gammabar_k = torch.where(is1, s.beta_kp1, s.gammabar_k)
        chibar_k = torch.where(is1, s.beta_k, s.chibar_k)
        zetabis_k = s.zetabis_k
        zetabar_kp1 = s.zetabar_kp1

        ck, sk, l_k = sym_givens(lambdabar_k, s.beta_kp1)

        # Direction wₖ (columns of Wₖ = VₖRₖ⁻¹).
        lk_c = _safe(l_k).to(FC)
        w1 = s.vk / lk_c
        w2 = (s.vk - s.gamma_km1.to(FC) * s.w_km1) / lk_c
        w3 = (s.vk - s.gamma_km1.to(FC) * s.w_km1
              - s.eps_km2.to(FC) * s.w_km2) / lk_c
        w_k = torch.where(is1, w1, torch.where(is2, w2, w3))

        # Continue the Lanczos process (when it ≤ ℓ − 1).
        lan_ok = it <= s.ell - 1
        q = Ashift(s.vkp1) - s.beta_kp1.to(FC) * s.vk
        alpha_kp1 = kdotr(q, s.vkp1)
        q = q - alpha_kp1.to(FC) * s.vkp1
        beta_kp2 = knorm(q)
        brk = beta_kp2 <= btol
        ell = torch.where(lan_ok & brk, it + 1, s.ell).to(torch.int32)
        v_next = torch.where(lan_ok & ~brk, q / _safe(beta_kp2).to(FC), q)
        alpha_kp1 = torch.where(lan_ok, alpha_kp1, s.alpha_k)
        beta_kp2 = torch.where(lan_ok, beta_kp2, zero)

        # Apply Qₖ.ₖ₊₁ (gated on ℓ).
        two_ok = it <= ell - 2
        one_ok = it <= ell - 1
        eps_k = torch.where(two_ok, sk * beta_kp2, zero)
        gammabar_kp1 = torch.where(two_ok, -ck * beta_kp2, zero)
        gamma_k = torch.where(one_ok, ck * gammabar_k + sk * alpha_kp1, zero)
        lambdabar_kp1 = torch.where(one_ok, sk * gammabar_k - ck * alpha_kp1,
                                    zero)

        # QR of Nₖ: previous reflections.
        rho_km2 = torch.where(ge3, s.st4 * l_k, zero)
        lhat_k = torch.where(ge3, -s.ct4 * l_k, torch.where(is2, l_k, zero))
        phibar_km1 = torch.where(ge2, s.st3 * lhat_k, zero)
        mubar_k = torch.where(ge2, -s.ct3 * lhat_k, l_k)
        phi_km1 = torch.where(
            ge2, torch.where(one_ok, s.ct2 * phibar_km1 + s.st2 * gamma_k,
                             phibar_km1), zero)
        ghat_k = torch.where(
            ge2, torch.where(one_ok, s.st2 * phibar_km1 - s.ct2 * gamma_k,
                             zero), gamma_k)

        ct1n, st1n, mubis_k_g = sym_givens(mubar_k, ghat_k)
        ct1 = torch.where(one_ok, ct1n, one)
        st1 = torch.where(one_ok, st1n, zero)
        mubis_k = torch.where(one_ok, mubis_k_g, mubar_k)

        ct0n, st0n, mu_k_g = sym_givens(mubis_k, eps_k)
        ct0 = torch.where(two_ok, ct0n, one)
        st0 = torch.where(two_ok, st0n, zero)
        mu_k = torch.where(two_ok, mu_k_g, mubis_k)

        # zₖ updates.
        zring_k = torch.where(one_ok, ct1 * zetabis_k + st1 * zetabar_kp1,
                              zetabis_k)
        zetabis_kp1 = torch.where(one_ok, st1 * zetabis_k
                                  - ct1 * zetabar_kp1, zero)
        zeta_k = torch.where(two_ok, ct0 * zring_k, zring_k)
        zetabar_kp2 = torch.where(two_ok, st0 * zring_k, zero)

        # Direction dₖ.
        mu_c = _safe(mu_k).to(FC)
        d1 = w_k / mu_c
        d2 = (w_k - phi_km1.to(FC) * s.d_km1) / mu_c
        d3 = (w_k - phi_km1.to(FC) * s.d_km1
              - rho_km2.to(FC) * s.d_km2) / mu_c
        d_k = torch.where(is1, d1, torch.where(is2, d2, d3))

        x = s.x + zeta_k.to(FC) * d_k

        ArNorm = torch.where(
            two_ok, torch.sqrt(zetabis_kp1 ** 2 + zetabar_kp2 ** 2),
            torch.where(it == ell - 1, torch.abs(zetabis_kp1), zero))

        # LQ of Uₖ.
        chm3_2, shm3_2, psibis2 = sym_givens(s.psibar_km1, phi_km1)  # it = 2
        chm4, shm4, psi_km2 = sym_givens(s.psibis_km2, rho_km2)      # it ≥ 3
        theta_km2 = chm4 * s.thetabar_km2 + shm4 * phi_km1
        delta_k = shm4 * s.thetabar_km2 - chm4 * phi_km1
        omega_km2 = shm4 * mu_k
        eta_k = -chm4 * mu_k
        chm3_3, shm3_3, psibis3 = sym_givens(s.psibar_km1, delta_k)

        psibar_k = torch.where(is1, mu_k, torch.where(
            is2, -chm3_2 * mu_k, -chm3_3 * eta_k))
        thetabar_km1 = torch.where(is2, shm3_2 * mu_k, torch.where(
            ge3, shm3_3 * eta_k, zero))
        psibis_km1 = torch.where(is2, psibis2,
                                 torch.where(ge3, psibis3, zero))

        # Solve L̂ₖtₖ = zₖ.
        tau_km2_new = torch.where(
            ge3, s.tau_km1 * s.psibis_km2 / _safe(psi_km2), s.tau_km2)
        tau_km1_new = torch.where(
            is2, s.tau_k * s.psibar_km1 / _safe(psibis2),
            torch.where(ge3, (s.xi_km1 - theta_km2 * tau_km2_new)
                        / _safe(psibis3), s.tau_km1))
        xi_k = torch.where(ge3, zeta_k - omega_km2 * tau_km2_new, zeta_k)
        tau_k_new = torch.where(
            is1, zeta_k / _safe(psibar_k),
            (xi_k - thetabar_km1 * tau_km1_new) / _safe(psibar_k))

        # (Qₖ)ᵀβ₁e₁ components and the π updates.
        chi_k = ck * chibar_k
        chibar_kp1 = sk * chibar_k
        pi2_km1 = chm3_2 * s.pi_km1 + shm3_2 * chi_k
        pi2_k = shm3_2 * s.pi_km1 - chm3_2 * chi_k
        pi3a_km2 = chm4 * s.pi_km2 + shm4 * chi_k
        pi3a_k = shm4 * s.pi_km2 - chm4 * chi_k
        pi3_km1 = chm3_3 * s.pi_km1 + shm3_3 * pi3a_k
        pi3_k = shm3_3 * s.pi_km1 - chm3_3 * pi3a_k
        pi_km2_new = torch.where(ge3, pi3a_km2, s.pi_km2)
        pi_km1_mid = torch.where(is2, pi2_km1,
                                 torch.where(ge3, pi3_km1, s.pi_km1))
        pi_k_new = torch.where(is1, chi_k, torch.where(is2, pi2_k, pi3_k))
        pi_kp1 = chibar_kp1

        rNorm = torch.where(
            is1, torch.sqrt((pi_k_new - tau_k_new) ** 2 + pi_kp1 ** 2),
            torch.sqrt((pi_km1_mid - tau_km1_new) ** 2
                       + (pi_k_new - tau_k_new) ** 2 + pi_kp1 ** 2))

        solved = (rNorm <= s.eps_lim) | (ArNorm <= s.kappa)
        breakdown = s.beta_kp1 <= btol
        code = torch.where(solved, SOLVED_ARTOL, torch.where(
            breakdown, rt.BREAKDOWN, rt.RUNNING)).to(torch.int32)

        rt.hist_write_masked(s.hist_r, active, it, rNorm, history)
        rt.hist_write_masked(s.hist_ar, active, it, ArNorm, history)
        s_new = s._replace(
            x=x, vk=s.vkp1, vkp1=v_next,
            w_km2=torch.where(ge2, s.w_km1, s.w_km2), w_km1=w_k,
            d_km2=torch.where(ge2, s.d_km1, s.d_km2), d_km1=d_k,
            alpha_k=torch.where(one_ok, alpha_kp1, s.alpha_k),
            beta_k=s.beta_kp1,
            beta_kp1=torch.where(one_ok, beta_kp2, s.beta_kp1),
            gamma_km1=torch.where(one_ok, gamma_k, s.gamma_km1),
            lambdabar_k=torch.where(one_ok, lambdabar_kp1, lambdabar_k),
            gammabar_k=torch.where(two_ok, gammabar_kp1, gammabar_k),
            eps_km2=torch.where(ge2, s.eps_km1, s.eps_km2),
            eps_km1=torch.where(two_ok, eps_k, s.eps_km1),
            xi_km1=xi_k,
            tau_km2=tau_km2_new, tau_km1=tau_km1_new, tau_k=tau_k_new,
            thetabar_km2=torch.where(ge2, thetabar_km1, s.thetabar_km2),
            psibis_km2=torch.where(ge2, psibis_km1, s.psibis_km2),
            psibar_km1=psibar_k,
            pi_km2=torch.where(ge2, pi_km1_mid, pi_km2_new),
            pi_km1=pi_k_new,
            chibar_k=chibar_kp1,
            zetabis_k=torch.where(one_ok, zetabis_kp1, zetabis_k),
            zetabar_kp1=torch.where(two_ok, zetabar_kp2, zetabar_kp1),
            ct4=torch.where(ge2, s.ct2, s.ct4),
            st4=torch.where(ge2, s.st2, s.st4),
            ct3=ct1, st3=st1, ct2=ct0, st2=st0,
            ell=ell, rNorm=rNorm, ArNorm=ArNorm,
            iter=it, status=code,
        )
        if callback is not None:
            user_exit = torch.as_tensor(callback(s_new), device=dev)
            s_new = s_new._replace(status=torch.where(
                user_exit & (s_new.status == rt.RUNNING), rt.USER_EXIT,
                s_new.status).to(torch.int32))
        if verbose > 0 and bool(active):
            rt.debug_row(verbose, it,
                         "{:5d}  {:7.1e}  {:7.1e}  {:7.1e}  {:8.1e}",
                         rNorm, ArNorm, beta_kp2, zeta_k)
        return _masked(MinaresState._fields, active, s_new, s)

    return rt.take_steps(body, state, steps, iter_cap, callback)


def _minares_solve(
    A, b, x0=None, *, lam=0.0, Artol=None, atol=None, rtol=None, itmax=0,
    timemax=float("inf"), verbose=0, history=False, callback=None,
):
    start = time.perf_counter()
    A, b, x0, _ = solve_inputs(A, b, x0)
    n = b.shape[0]
    _check_square(A, n)
    T = real_dtype(b.dtype)
    atol = rt.default_tol(atol, T)
    rtol = rt.default_tol(rtol, T)
    Artol = rt.default_tol(Artol, T)
    itmax = rt.resolve_itmax(itmax, 2 * n)
    rt.debug_table(verbose, "MINARES", ("k", "‖rₖ‖", "‖Arₖ‖", "βₖ₊₁", "ζₖ"),
                   n)
    hist_len = itmax + 1 if history else 0

    # Fast path: DIA stencil + default config → whole-solve kernel.
    if (callback is None and verbose == 0 and not history
            and timemax == float("inf")
            and _fused_ready(A, n, b.dtype, minares_dia_fused_supported)):
        b_eff = b if x0 is None else \
            b - (A.matvec(x0) + torch.tensor(lam, dtype=b.dtype,
                                             device=b.device) * x0)
        x, niter, _, _, code_d = minares_dia_fused(
            A._pd, A._offsets, b_eff.contiguous(), atol, rtol, Artol,
            float(lam), itmax)
        niter, code = torch.stack([niter, code_d]).tolist()
        code = rt.final_status_code(code, niter, itmax, False)
        if x0 is not None:
            x = x + x0
        stats = SimpleStats(
            niter=niter,
            solved=rt.is_solved_code(code) or code == SOLVED_ARTOL,
            inconsistent=False,
            residuals=np.zeros(0),
            timer=time.perf_counter() - start,
            status=rt.decode_status(code, _STATUS),
        )
        return x, stats, None

    def run(state, cap, steps):
        return _minares_core(
            A, b, x0, state, cap, steps, itmax, atol, rtol, Artol,
            float(lam), history=bool(history), hist_len=hist_len,
            callback=callback, verbose=int(verbose),
        )

    state, overtimed = rt.drive(run, itmax, timemax, start)
    niter = int(state.iter)
    code = rt.final_status_code(state.status, niter, itmax, overtimed)
    x = state.x
    if x0 is not None:
        x = x + x0
    stats = SimpleStats(
        niter=niter,
        solved=rt.is_solved_code(code) or code == SOLVED_ARTOL,
        inconsistent=False,
        residuals=_trim(state.hist_r, niter, history),
        Aresiduals=_trim(state.hist_ar, niter, history),
        timer=time.perf_counter() - start,
        status=rt.decode_status(code, _STATUS),
    )
    return x, stats, state


def minares(A, b, x0=None, *, precision=None, **kwargs):
    """x, stats = minares(A, b; λ, Artol, ...) — minimises ‖Aᴴr‖.

    ``precision="double_word"`` raises NotImplementedError until the
    iterative refinement (solvers/_refine.py, ROADMAP.md Queue 1 item 8)
    is ported."""
    _no_double_word("MINARES", precision)
    x, stats, _ = _minares_solve(A, b, x0, **kwargs)
    return x, stats
