"""USYMLQ, USYMQR, TriLQR and USYMLQR — the Saunders–Simon–Yip process.

Counterpart of ``krylov_tpu/solvers/usymlq.py`` and of reference
src/usymlq.jl (LQ of Tₖ, transfer_to_usymcg), src/usymqr.jl (QR of
Tₖ₊₁.ₖ, the ‖Aᴴr‖ inconsistency test), src/trilqr.jl (the adjoint
systems Ax = b and Aᴴy = c, with ``AdjointStats``) and src/usymlqr.jl
(the saddle-point system [I A; Aᴴ 0][x; y] = [b; c]).  The SSY process
builds two orthonormal bases, AUₖ = Vₖ₊₁Tₖ₊₁.ₖ and AᴴVₖ = Uₖ₊₁(Tₖ.ₖ₊₁)ᴴ,
with v ∈ ℂᵐ driven by b and u ∈ ℂⁿ driven by c; A may be rectangular.
A square DIA operator on the card with no warm start and the default
options goes to a whole-solve kernel (ops/cuda_fused.py) on Aᴴ's
aligned diagonals; every other configuration runs the general core,
whose iterations ``_runtime.drive`` takes in chunks with masked updates.
"""

import time
from typing import NamedTuple

import numpy as np
import torch

from .. import _runtime as rt
from .._dtypes import real_dtype
from ..operators import solve_inputs
from ..ops.cuda_fused import (SOLVED_CG_PT, SOLVED_LQ, trilqr_dia_fused,
                              trilqr_dia_fused_supported, usymlq_dia_fused,
                              usymlq_dia_fused_supported, usymlqr_dia_fused,
                              usymlqr_dia_fused_supported, usymqr_dia_fused,
                              usymqr_dia_fused_supported)
from ..ops.kops import kdot, knorm, sym_givens
from ..stats import AdjointStats, SimpleStats
from .bilq import _STATUS as _BILQ_STATUS
from .bilq import (_bilqr_status, _exit, _nan_trim, _real, _safe,
                   _with_adjoint)
from .cr import _fused_ready, _i32, _masked, _no_double_word, _trim

# USYMLQ's solved codes are BiLQ's, with the same strings
# (krylov_tpu/solvers/usymlq.py:25-30)
_STATUS = {code: _BILQ_STATUS[code] for code in (SOLVED_LQ, SOLVED_CG_PT)}


def _ssy_step(A, vk, uk, vkm1, ukm1, beta_k, gamma_k, it, FC):
    """One SSY tridiagonalisation step (reference usymlq :204-224):
    (q, p, α, βₖ₊₁, γₖ₊₁) with q = Auₖ − γₖvₖ₋₁ − αvₖ and
    p = Aᴴvₖ − βₖuₖ₋₁ − ᾱuₖ, α = ⟨vₖ, q⟩."""
    q = A.matvec(uk)
    p = A.rmatvec(vk)
    q = torch.where(it >= 2, q - gamma_k.to(FC) * vkm1, q)
    p = torch.where(it >= 2, p - beta_k.to(FC) * ukm1, p)
    alpha = kdot(vk, q)
    q = q - alpha * vk
    p = p - torch.conj(alpha) * uk
    return q, p, alpha, knorm(q), knorm(p)


def _tol(v, T, dev):
    return torch.tensor(v, dtype=T, device=dev)


def _inputs(A, b, c, x0, y0=None):
    """(A with its adjoint, b, c, x0, y0, m, n) of an SSY solve: c and y0
    go where b lies, in b's dtype."""
    A, b, x0, _ = solve_inputs(A, b, x0)
    A = _with_adjoint(A)
    c = rt.as_device_tensor(c, b).to(b.dtype)
    if y0 is not None:
        y0 = rt.as_device_tensor(y0, b).to(b.dtype)
    m, n = A.shape if A.shape is not None else (b.shape[0], c.shape[0])
    return A, b, c, x0, y0, m, n


def _lq_step(s, it, alpha, FC, T):
    """The LQ factorisation of Tₖ shared by USYMLQ and TriLQR (reference
    usymlq :226-247); no rotation at iteration 1: c, s keep (-1, 0).
    Returns (ck, sk, d_{k-1}, λ_{k-1}, ε_{k-2}, d̄ₖ)."""
    dev = alpha.device
    ck_g, sk_g, d_km1 = sym_givens(s.dbar_km1, s.gamma.to(FC))
    ck = torch.where(it == 1, -torch.ones((), dtype=T, device=dev),
                     _real(ck_g).to(T))
    sk = torch.where(it == 1, torch.zeros((), dtype=FC, device=dev),
                     sk_g.to(FC))
    beta = s.beta.to(FC)
    eps_km2 = s.s_km1 * beta
    lam2 = ck * beta + sk * alpha
    dbar2 = torch.conj(sk) * beta - ck * alpha
    lam3 = -s.c_km1 * ck * beta + sk * alpha
    dbar3 = -s.c_km1 * torch.conj(sk) * beta - ck * alpha
    lam_km1 = torch.where(it == 2, lam2, lam3)
    dbar_k = torch.where(it == 1, alpha, torch.where(it == 2, dbar2, dbar3))
    return ck, sk, d_km1.to(FC), lam_km1, eps_km2, dbar_k


def _advance(q, p, beta_kp1, gamma_kp1, vk, uk, FC):
    """vₖ₊₁ = q/βₖ₊₁ and uₖ₊₁ = p/γₖ₊₁, keeping vₖ or uₖ where the norm
    is 0 (reference usymlq :156-157)."""
    return (torch.where(beta_kp1 != 0, q / _safe(beta_kp1).to(FC), vk),
            torch.where(gamma_kp1 != 0, p / _safe(gamma_kp1).to(FC), uk))


# ---------------------------------------------------------------------------
# USYMLQ
# ---------------------------------------------------------------------------

class UsymlqState(NamedTuple):
    x: torch.Tensor
    vk: torch.Tensor
    vkm1: torch.Tensor
    uk: torch.Tensor
    ukm1: torch.Tensor
    dbar_vec: torch.Tensor
    beta: torch.Tensor
    gamma: torch.Tensor
    c_km1: torch.Tensor
    s_km1: torch.Tensor
    dbar_km1: torch.Tensor
    zeta_km1: torch.Tensor
    zeta_km2: torch.Tensor
    eta_km1: torch.Tensor
    zetabar: torch.Tensor
    rNorm: torch.Tensor
    eps_lim: torch.Tensor
    iter: torch.Tensor
    status: torch.Tensor
    solved_cg_flag: torch.Tensor
    hist_r: torch.Tensor


def _usymlq_core(
    A, b, c, x0, state_in, iter_cap, steps, atol, rtol,
    *, transfer_to_usymcg, history, hist_len, callback, verbose,
):
    """``steps`` USYMLQ iterations from ``state_in`` (None: start), each
    with its updates masked by ``status == RUNNING and iter < iter_cap``;
    the state returned has x at the USYMCG point once that point solved
    (krylov_tpu/solvers/usymlq.py:198-201)."""
    FC = b.dtype
    T = real_dtype(FC)
    dev = b.device
    eps_T = torch.finfo(T).eps

    if state_in is None:
        r0 = b if x0 is None else b - A.matvec(x0)
        bNorm = knorm(r0)
        gamma = knorm(c)
        eps_lim = _tol(atol, T, dev) + _tol(rtol, T, dev) * bNorm
        status = torch.where(bNorm == 0, rt.ZERO_RESIDUAL, torch.where(
            bNorm <= eps_lim, SOLVED_LQ, rt.RUNNING)).to(torch.int32)
        zc = torch.zeros((), dtype=FC, device=dev)
        hist = rt.hist_write(rt.hist_init(hist_len, T, dev), _i32(0, dev),
                             bNorm, history)
        state_in = UsymlqState(
            x=torch.zeros_like(c), vk=r0 / _safe(bNorm).to(FC),
            vkm1=torch.zeros_like(b), uk=c / _safe(gamma).to(FC),
            ukm1=torch.zeros_like(c), dbar_vec=torch.zeros_like(c),
            beta=bNorm, gamma=gamma,
            c_km1=-torch.ones((), dtype=T, device=dev), s_km1=zc,
            dbar_km1=zc, zeta_km1=zc, zeta_km2=zc, eta_km1=zc, zetabar=zc,
            rNorm=bNorm, eps_lim=eps_lim, iter=_i32(0, dev), status=status,
            solved_cg_flag=torch.zeros((), dtype=torch.bool, device=dev),
            hist_r=hist)

    def body(s):
        active = (s.status == rt.RUNNING) & (s.iter < iter_cap)
        it = s.iter + 1
        q, p, alpha, beta_kp1, gamma_kp1 = _ssy_step(
            A, s.vk, s.uk, s.vkm1, s.ukm1, s.beta, s.gamma, it, FC)
        ck, sk, d_km1, lam_km1, eps_km2, dbar_k = _lq_step(s, it, alpha, FC,
                                                           T)
        beta = s.beta.to(FC)
        zeta_km1 = torch.where(it >= 2, s.eta_km1 / _safe(d_km1), s.zeta_km1)
        zeta_km2 = torch.where(it >= 3, s.zeta_km1, s.zeta_km2)
        eta_k = torch.where(it == 1, beta, torch.where(
            it == 2, -lam_km1 * zeta_km1,
            -eps_km2 * zeta_km2 - lam_km1 * zeta_km1))
        x_new = torch.where(
            it >= 2, s.x + (zeta_km1 * ck).to(FC) * s.dbar_vec
            + (zeta_km1 * sk) * s.uk, s.x)
        dbar_vec = torch.where(it == 1, s.uk, torch.conj(sk) * s.dbar_vec
                               - ck.to(FC) * s.uk)
        vk_new, uk_new = _advance(q, p, beta_kp1, gamma_kp1, s.vk, s.uk, FC)
        mu = beta * (s.s_km1 * zeta_km2 - s.c_km1 * ck * zeta_km1) \
            + alpha * sk * zeta_km1
        om = beta_kp1.to(FC) * sk * zeta_km1
        rNorm_lq = torch.where(it == 1, s.rNorm, torch.sqrt(
            torch.abs(mu) ** 2 + torch.abs(om) ** 2))
        dbar_ok = torch.abs(dbar_k) > eps_T
        zetabar = torch.where(dbar_ok, eta_k / _safe(dbar_k), s.zetabar)
        rho = beta_kp1.to(FC) * (sk * zeta_km1 - ck * zetabar)
        solved_lq = rNorm_lq <= s.eps_lim
        solved_cg = bool(transfer_to_usymcg) & dbar_ok \
            & (torch.abs(rho) <= s.eps_lim)
        code = torch.where(solved_lq, SOLVED_LQ, torch.where(
            solved_cg, SOLVED_CG_PT, rt.RUNNING)).to(torch.int32)
        rt.hist_write_masked(s.hist_r, active, it, rNorm_lq, history)
        s_new = s._replace(
            x=x_new, vk=vk_new, vkm1=s.vk, uk=uk_new, ukm1=s.uk,
            dbar_vec=dbar_vec, beta=beta_kp1, gamma=gamma_kp1, c_km1=ck,
            s_km1=sk, dbar_km1=dbar_k, zeta_km1=zeta_km1, zeta_km2=zeta_km2,
            eta_km1=eta_k, zetabar=zetabar, rNorm=rNorm_lq, iter=it,
            status=code, solved_cg_flag=solved_cg & ~solved_lq)
        if verbose > 0 and bool(active):
            rt.debug_row(verbose, it, "{:5d}  {:7.1e}", rNorm_lq)
        if callback is not None:
            s_new = _exit(callback, s_new, dev)
        return _masked(UsymlqState._fields, active, s_new, s,
                       keep=("hist_r",))

    s = rt.take_steps(body, state_in, steps, iter_cap, callback)
    return s._replace(x=torch.where(s.solved_cg_flag,
                                    s.x + s.zetabar * s.dbar_vec, s.x))


def _usymlq_stats(niter, code, residuals, start):
    return SimpleStats(
        niter=niter,
        solved=rt.is_solved_code(code) or code in (SOLVED_LQ, SOLVED_CG_PT),
        inconsistent=False, residuals=residuals,
        timer=time.perf_counter() - start,
        status=rt.decode_status(code, _STATUS))


def _usymlq_solve(
    A, b, c, x0=None, *, transfer_to_usymcg=True, atol=None, rtol=None,
    itmax=0, timemax=float("inf"), verbose=0, history=False, callback=None,
):
    start = time.perf_counter()
    A, b, c, x0, _, m, n = _inputs(A, b, c, x0)
    T = real_dtype(b.dtype)
    atol = rt.default_tol(atol, T)
    rtol = rt.default_tol(rtol, T)
    itmax = rt.resolve_itmax(itmax, m + n)
    rt.debug_table(verbose, "USYMLQ", ("k", "‖rₖ‖"), m, n)
    hist_len = itmax + 1 if history else 0

    # Fast path: DIA stencil + default config (no warm start: the kernel
    # seeds v₁ from b) → whole-solve kernel.
    if (x0 is None and not history and callback is None and verbose == 0
            and timemax == float("inf")
            and _fused_ready(A, n, b.dtype, usymlq_dia_fused_supported)):
        pd_adj, ot_adj = A.aligned_adjoint_kernel_args()
        x, niter, _, code_d = usymlq_dia_fused(
            A._pd, pd_adj, A._offsets, ot_adj, b.contiguous(),
            c.contiguous(), atol, rtol, itmax,
            transfer_to_usymcg=bool(transfer_to_usymcg))
        niter, code = torch.stack([niter, code_d]).tolist()
        code = rt.final_status_code(code, niter, itmax, False)
        return x, _usymlq_stats(niter, code, np.zeros(0), start), None

    def run(state, cap, steps):
        return _usymlq_core(
            A, b, c, x0, state, cap, steps, atol, rtol,
            transfer_to_usymcg=bool(transfer_to_usymcg),
            history=bool(history), hist_len=hist_len, callback=callback,
            verbose=int(verbose))

    state, overtimed = rt.drive(run, itmax, timemax, start)
    niter = int(state.iter)
    code = rt.final_status_code(state.status, niter, itmax, overtimed)
    x = state.x if x0 is None else state.x + x0
    return x, _usymlq_stats(niter, code, _trim(state.hist_r, niter, history),
                            start), state


def usymlq(A, b, c, x0=None, *, precision=None, **kwargs):
    """x, stats = usymlq(A, b, c; transfer_to_usymcg=True, ...).

    ``precision="double_word"`` raises NotImplementedError until the
    iterative refinement (solvers/_refine.py, ROADMAP.md Queue 1 item 8)
    is ported."""
    _no_double_word("USYMLQ", precision)
    x, stats, _ = _usymlq_solve(A, b, c, x0, **kwargs)
    return x, stats


# ---------------------------------------------------------------------------
# USYMQR
# ---------------------------------------------------------------------------

class UsymqrState(NamedTuple):
    x: torch.Tensor
    vk: torch.Tensor
    vkm1: torch.Tensor
    uk: torch.Tensor
    ukm1: torch.Tensor
    w_km2: torch.Tensor
    w_km1: torch.Tensor
    beta: torch.Tensor
    gamma: torch.Tensor
    c_km2: torch.Tensor
    s_km2: torch.Tensor
    c_km1: torch.Tensor
    s_km1: torch.Tensor
    zetabar: torch.Tensor
    kappa: torch.Tensor
    rNorm: torch.Tensor
    ArNorm: torch.Tensor
    eps_lim: torch.Tensor
    iter: torch.Tensor
    status: torch.Tensor
    inconsistent: torch.Tensor
    hist_r: torch.Tensor
    hist_ar: torch.Tensor


def _usymqr_core(
    A, b, c, x0, state_in, iter_cap, steps, atol, rtol,
    *, history, hist_len, callback, verbose,
):
    """``steps`` USYMQR iterations from ``state_in`` (None: start), each
    with its updates masked by ``status == RUNNING and iter < iter_cap``
    (krylov_tpu/solvers/usymlq.py:328-435)."""
    FC = b.dtype
    T = real_dtype(FC)
    dev = b.device

    if state_in is None:
        r0 = b if x0 is None else b - A.matvec(x0)
        bNorm = knorm(r0)
        gamma = knorm(c)
        eps_lim = _tol(atol, T, dev) + _tol(rtol, T, dev) * bNorm
        status = torch.where(bNorm == 0, rt.ZERO_RESIDUAL, torch.where(
            bNorm <= eps_lim, rt.SOLVED, rt.RUNNING)).to(torch.int32)
        zc = torch.zeros((), dtype=FC, device=dev)
        zt = torch.zeros((), dtype=T, device=dev)
        hr = rt.hist_write(rt.hist_init(hist_len, T, dev), _i32(0, dev),
                           bNorm, history)
        state_in = UsymqrState(
            x=torch.zeros_like(c), vk=r0 / _safe(bNorm).to(FC),
            vkm1=torch.zeros_like(b), uk=c / _safe(gamma).to(FC),
            ukm1=torch.zeros_like(c), w_km2=torch.zeros_like(c),
            w_km1=torch.zeros_like(c), beta=bNorm, gamma=gamma, c_km2=zt,
            s_km2=zc, c_km1=zt, s_km1=zc, zetabar=bNorm.to(FC), kappa=zt,
            rNorm=bNorm, ArNorm=zt, eps_lim=eps_lim, iter=_i32(0, dev),
            status=status,
            inconsistent=torch.zeros((), dtype=torch.bool, device=dev),
            hist_r=hr, hist_ar=rt.hist_init(hist_len, T, dev))

    def body(s):
        active = (s.status == rt.RUNNING) & (s.iter < iter_cap)
        it = s.iter + 1
        zc = torch.zeros((), dtype=FC, device=dev)
        q, p, alpha, beta_kp1, gamma_kp1 = _ssy_step(
            A, s.vk, s.uk, s.vkm1, s.ukm1, s.beta, s.gamma, it, FC)
        # QR of Tₖ₊₁.ₖ (reference usymqr :218-243)
        gam = s.gamma.to(FC)
        eps_km2 = torch.where(it >= 3, s.s_km2 * gam, zc)
        lbar_km1 = torch.where(it >= 3, -s.c_km2.to(FC) * gam,
                               torch.where(it == 2, gam, zc))
        lam_km1 = torch.where(it >= 2, s.c_km1.to(FC) * lbar_km1
                              + s.s_km1 * alpha, zc)
        dbar_k = torch.where(it >= 2, torch.conj(s.s_km1) * lbar_km1
                             - s.c_km1.to(FC) * alpha, alpha)
        ck, sk, d_k = sym_givens(dbar_k, beta_kp1.to(FC))
        d_k = d_k.to(FC)
        zeta_k = ck.to(FC) * s.zetabar
        zetabar_next = torch.conj(sk.to(FC)) * s.zetabar
        w1 = s.uk / _safe(d_k)
        w2 = (s.uk - lam_km1 * s.w_km1) / _safe(d_k)
        w3 = (s.uk - lam_km1 * s.w_km1 - eps_km2 * s.w_km2) / _safe(d_k)
        w_k = torch.where(it == 1, w1, torch.where(it == 2, w2, w3))
        rNorm = torch.abs(zetabar_next)
        ArNorm = torch.abs(s.zetabar) * torch.sqrt(
            torch.abs(dbar_k) ** 2 + torch.abs(s.c_km1 * gamma_kp1) ** 2)
        kappa = torch.where(it == 1, _tol(atol, T, dev)
                            + _tol(rtol, T, dev) * ArNorm, s.kappa)
        vk_new, uk_new = _advance(q, p, beta_kp1, gamma_kp1, s.vk, s.uk, FC)
        solved = rNorm <= s.eps_lim
        inconsistent = ~solved & (ArNorm <= kappa)
        code = torch.where(solved, rt.SOLVED, torch.where(
            inconsistent, rt.INCONSISTENT, rt.RUNNING)).to(torch.int32)
        rt.hist_write_masked(s.hist_r, active, it, rNorm, history)
        rt.hist_write_masked(s.hist_ar, active, it, ArNorm, history)
        s_new = s._replace(
            x=s.x + zeta_k * w_k, vk=vk_new, vkm1=s.vk, uk=uk_new,
            ukm1=s.uk, w_km2=torch.where(it >= 2, s.w_km1, s.w_km2),
            w_km1=w_k, beta=beta_kp1, gamma=gamma_kp1,
            c_km2=torch.where(it >= 2, s.c_km1, s.c_km2),
            s_km2=torch.where(it >= 2, s.s_km1, s.s_km2),
            c_km1=_real(ck).to(T), s_km1=sk.to(FC), zetabar=zetabar_next,
            kappa=kappa, rNorm=rNorm, ArNorm=ArNorm, iter=it, status=code,
            inconsistent=inconsistent)
        if verbose > 0 and bool(active):
            rt.debug_row(verbose, it, "{:5d}  {:7.1e}  {:8.1e}", rNorm,
                         ArNorm)
        if callback is not None:
            s_new = _exit(callback, s_new, dev)
        return _masked(UsymqrState._fields, active, s_new, s)

    return rt.take_steps(body, state_in, steps, iter_cap, callback)


def _usymqr_solve(
    A, b, c, x0=None, *, atol=None, rtol=None, itmax=0,
    timemax=float("inf"), verbose=0, history=False, callback=None,
):
    start = time.perf_counter()
    A, b, c, x0, _, m, n = _inputs(A, b, c, x0)
    T = real_dtype(b.dtype)
    atol = rt.default_tol(atol, T)
    rtol = rt.default_tol(rtol, T)
    itmax = rt.resolve_itmax(itmax, m + n)
    rt.debug_table(verbose, "USYMQR", ("k", "‖rₖ‖", "‖Aᴴrₖ₋₁‖"), m, n)
    hist_len = itmax + 1 if history else 0

    # Fast path: DIA stencil + default config → whole-solve kernel.
    if (x0 is None and not history and callback is None and verbose == 0
            and timemax == float("inf")
            and _fused_ready(A, n, b.dtype, usymqr_dia_fused_supported)):
        pd_adj, ot_adj = A.aligned_adjoint_kernel_args()
        x, niter, _, _, code_d, incon = usymqr_dia_fused(
            A._pd, pd_adj, A._offsets, ot_adj, b.contiguous(),
            c.contiguous(), atol, rtol, itmax)
        niter, code, incon = torch.stack([niter, code_d, incon]).tolist()
        code = rt.final_status_code(code, niter, itmax, False)
        stats = SimpleStats(
            niter=niter, solved=rt.is_solved_code(code),
            inconsistent=bool(incon), residuals=np.zeros(0),
            timer=time.perf_counter() - start,
            status=rt.decode_status(code, _STATUS))
        return x, stats, None

    def run(state, cap, steps):
        return _usymqr_core(
            A, b, c, x0, state, cap, steps, atol, rtol,
            history=bool(history), hist_len=hist_len, callback=callback,
            verbose=int(verbose))

    state, overtimed = rt.drive(run, itmax, timemax, start)
    niter = int(state.iter)
    code = rt.final_status_code(state.status, niter, itmax, overtimed)
    x = state.x if x0 is None else state.x + x0
    stats = SimpleStats(
        niter=niter, solved=rt.is_solved_code(code),
        inconsistent=bool(state.inconsistent),
        residuals=_trim(state.hist_r, niter, history),
        Aresiduals=_trim(state.hist_ar, niter, history),
        timer=time.perf_counter() - start,
        status=rt.decode_status(code))
    return x, stats, state


def usymqr(A, b, c, x0=None, *, precision=None, **kwargs):
    """x, stats = usymqr(A, b, c; ...) — rectangular systems supported.

    ``precision="double_word"`` raises NotImplementedError until the
    iterative refinement (solvers/_refine.py, ROADMAP.md Queue 1 item 8)
    is ported."""
    _no_double_word("USYMQR", precision)
    x, stats, _ = _usymqr_solve(A, b, c, x0, **kwargs)
    return x, stats


# ---------------------------------------------------------------------------
# TriLQR — Ax = b (USYMLQ) and Aᴴy = c (QR dual) from one process.
# ---------------------------------------------------------------------------

class TrilqrState(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    vk: torch.Tensor
    vkm1: torch.Tensor
    uk: torch.Tensor
    ukm1: torch.Tensor
    dbar_vec: torch.Tensor
    w_km3: torch.Tensor
    w_km2: torch.Tensor
    beta: torch.Tensor
    gamma: torch.Tensor
    c_km1: torch.Tensor
    s_km1: torch.Tensor
    dbar_km1: torch.Tensor
    zeta_km1: torch.Tensor
    zeta_km2: torch.Tensor
    eta_km1: torch.Tensor
    zetabar: torch.Tensor
    psibar_km1: torch.Tensor
    eps_km3: torch.Tensor
    lam_km2: torch.Tensor
    kappa: torch.Tensor
    rNorm: torch.Tensor
    sNorm: torch.Tensor
    epsL: torch.Tensor
    epsQ: torch.Tensor
    solved_primal: torch.Tensor
    solved_dual: torch.Tensor
    solved_lq_tol: torch.Tensor
    solved_lq_mach: torch.Tensor
    solved_cg_tol: torch.Tensor
    solved_cg_mach: torch.Tensor
    solved_qr_tol: torch.Tensor
    solved_qr_mach: torch.Tensor
    solved_cg_flag: torch.Tensor
    inconsistent_dual: torch.Tensor
    iter: torch.Tensor
    status: torch.Tensor
    hist_r: torch.Tensor
    hist_s: torch.Tensor


def _trilqr_core(
    A, b, c, x0, y0, state_in, iter_cap, steps, atol, rtol,
    *, transfer_to_usymcg, history, hist_len, callback, verbose,
):
    """``steps`` TriLQR iterations from ``state_in`` (None: start), each
    with its updates masked by ``status == RUNNING and iter < iter_cap``;
    the primal and dual blocks are each frozen once their own system is
    solved, and the state returned has x at the USYMCG point once that
    point solved the primal system (krylov_tpu/solvers/usymlq.py:
    582-770)."""
    FC = b.dtype
    T = real_dtype(FC)
    dev = b.device
    eps_T = torch.finfo(T).eps

    def flag(v=False):
        return torch.full((), v, dtype=torch.bool, device=dev)

    if state_in is None:
        r0 = b if x0 is None else b - A.matvec(x0)
        s0 = c if y0 is None else c - A.rmatvec(y0)
        bNorm, cNorm = knorm(r0), knorm(s0)
        epsL = _tol(atol, T, dev) + _tol(rtol, T, dev) * bNorm
        epsQ = _tol(atol, T, dev) + _tol(rtol, T, dev) * cNorm
        status = torch.where((bNorm == 0) & (cNorm == 0), rt.ZERO_RESIDUAL,
                             rt.RUNNING).to(torch.int32)
        zc = torch.zeros((), dtype=FC, device=dev)
        hr = rt.hist_write(rt.hist_init(hist_len, T, dev), _i32(0, dev),
                           bNorm, history)
        hs = rt.hist_write(rt.hist_init(hist_len, T, dev), _i32(0, dev),
                           cNorm, history)
        state_in = TrilqrState(
            x=torch.zeros_like(c), y=torch.zeros_like(b),
            vk=r0 / _safe(bNorm).to(FC), vkm1=torch.zeros_like(b),
            uk=s0 / _safe(cNorm).to(FC), ukm1=torch.zeros_like(c),
            dbar_vec=torch.zeros_like(c), w_km3=torch.zeros_like(b),
            w_km2=torch.zeros_like(b), beta=bNorm, gamma=cNorm,
            c_km1=-torch.ones((), dtype=T, device=dev), s_km1=zc,
            dbar_km1=zc, zeta_km1=zc, zeta_km2=zc, eta_km1=zc, zetabar=zc,
            psibar_km1=zc, eps_km3=zc, lam_km2=zc,
            kappa=torch.zeros((), dtype=T, device=dev), rNorm=bNorm,
            sNorm=cNorm, epsL=epsL, epsQ=epsQ, solved_primal=bNorm == 0,
            solved_dual=cNorm == 0, solved_lq_tol=flag(),
            solved_lq_mach=flag(), solved_cg_tol=flag(),
            solved_cg_mach=flag(), solved_qr_tol=flag(),
            solved_qr_mach=flag(), solved_cg_flag=flag(),
            inconsistent_dual=flag(), iter=_i32(0, dev), status=status,
            hist_r=hr, hist_s=hs)

    def body(s):
        active = (s.status == rt.RUNNING) & (s.iter < iter_cap)
        it = s.iter + 1
        zc = torch.zeros((), dtype=FC, device=dev)
        q, p, alpha, beta_kp1, gamma_kp1 = _ssy_step(
            A, s.vk, s.uk, s.vkm1, s.ukm1, s.beta, s.gamma, it, FC)
        ck, sk, d_km1, lam_km1, eps_km2, dbar_k = _lq_step(s, it, alpha, FC,
                                                           T)
        beta = s.beta.to(FC)
        # primal (USYMLQ), frozen once solved
        pm = ~s.solved_primal
        zeta_km1 = torch.where(pm & (it >= 2), s.eta_km1 / _safe(d_km1),
                               s.zeta_km1)
        zeta_km2 = torch.where(pm & (it >= 3), s.zeta_km1, s.zeta_km2)
        eta_k = torch.where(pm, torch.where(it == 1, beta, torch.where(
            it == 2, -lam_km1 * zeta_km1,
            -eps_km2 * zeta_km2 - lam_km1 * zeta_km1)), s.eta_km1)
        x_new = torch.where(
            pm & (it >= 2), s.x + (zeta_km1 * ck).to(FC) * s.dbar_vec
            + (zeta_km1 * sk) * s.uk, s.x)
        dbar_vec = torch.where(pm, torch.where(
            it == 1, s.uk, torch.conj(sk) * s.dbar_vec - ck.to(FC) * s.uk),
            s.dbar_vec)
        mu = beta * (s.s_km1 * zeta_km2 - s.c_km1 * ck * zeta_km1) \
            + alpha * sk * zeta_km1
        om = beta_kp1.to(FC) * sk * zeta_km1
        rNorm_lq = torch.where(it == 1, s.rNorm, torch.sqrt(
            torch.abs(mu) ** 2 + torch.abs(om) ** 2))
        rNorm_lq = torch.where(pm, rNorm_lq, s.rNorm)
        dbar_ok = torch.abs(dbar_k) > eps_T
        zetabar = torch.where(pm & dbar_ok, eta_k / _safe(dbar_k), s.zetabar)
        rNorm_cg = torch.abs(beta_kp1.to(FC) * (sk * zeta_km1
                                                - ck * zetabar))
        tr = bool(transfer_to_usymcg)
        solved_lq_tol = torch.where(pm, rNorm_lq <= s.epsL, s.solved_lq_tol)
        solved_lq_mach = torch.where(pm, (rNorm_lq + 1.0) <= 1.0,
                                     s.solved_lq_mach)
        solved_cg_tol = torch.where(pm, dbar_ok & (rNorm_cg <= s.epsL) & tr,
                                    s.solved_cg_tol)
        solved_cg_mach = torch.where(
            pm, dbar_ok & ((rNorm_cg + 1.0) <= 1.0) & tr, s.solved_cg_mach)
        solved_lq = solved_lq_tol | solved_lq_mach
        solved_cg = solved_cg_tol | solved_cg_mach
        solved_primal = s.solved_primal | solved_lq | solved_cg
        # dual (QR on Aᴴy = c; reference trilqr :325-385), directions from
        # the old vₖ₋₁
        dm = ~s.solved_dual
        psi_km1 = torch.where(it == 1, zc, ck.to(FC) * s.psibar_km1)
        psibar_k = torch.where(it == 1, s.gamma.to(FC), sk * s.psibar_km1)
        dc = _safe(torch.conj(d_km1))
        w2 = s.vkm1 / dc
        w3 = (s.vkm1 - torch.conj(s.lam_km2) * s.w_km2) / dc
        w4 = (s.vkm1 - torch.conj(s.lam_km2) * s.w_km2
              - torch.conj(s.eps_km3) * s.w_km3) / dc
        w_km1 = torch.where(it == 2, w2, torch.where(it == 3, w3, w4))
        y_new = torch.where(dm & (it >= 2), s.y + psi_km1 * w_km1, s.y)
        sNorm = torch.where(dm, torch.abs(psibar_k), s.sNorm)
        AsNorm = torch.abs(psibar_k) * torch.sqrt(
            torch.abs(dbar_k) ** 2 + torch.abs(ck * beta_kp1) ** 2)
        kappa = torch.where(it == 1, _tol(atol, T, dev)
                            + _tol(rtol, T, dev) * AsNorm, s.kappa)
        solved_qr_tol = torch.where(dm, sNorm <= s.epsQ, s.solved_qr_tol)
        solved_qr_mach = torch.where(dm, (sNorm + 1.0) <= 1.0,
                                     s.solved_qr_mach)
        inconsistent_dual = torch.where(dm, AsNorm <= kappa,
                                        s.inconsistent_dual)
        solved_dual = s.solved_dual | solved_qr_tol | solved_qr_mach \
            | inconsistent_dual
        vk_new, uk_new = _advance(q, p, beta_kp1, gamma_kp1, s.vk, s.uk, FC)
        code = torch.where(solved_primal & solved_dual,
                           rt.SOLVED_PRIMAL_DUAL, rt.RUNNING).to(torch.int32)
        nan = torch.full((), float("nan"), dtype=T, device=dev)
        rt.hist_write_masked(s.hist_r, active, it,
                             torch.where(pm, rNorm_lq, nan), history)
        rt.hist_write_masked(s.hist_s, active, it,
                             torch.where(dm, sNorm, nan), history)
        s_new = s._replace(
            x=x_new, y=y_new, vk=vk_new, vkm1=s.vk, uk=uk_new, ukm1=s.uk,
            dbar_vec=dbar_vec,
            w_km3=torch.where(it >= 2, s.w_km2, s.w_km3),
            w_km2=torch.where(it >= 2, w_km1, s.w_km2),
            beta=beta_kp1, gamma=gamma_kp1, c_km1=ck, s_km1=sk,
            dbar_km1=dbar_k, zeta_km1=zeta_km1, zeta_km2=zeta_km2,
            eta_km1=eta_k, zetabar=zetabar, psibar_km1=psibar_k,
            eps_km3=torch.where(it >= 3, eps_km2, s.eps_km3),
            lam_km2=torch.where(it >= 2, lam_km1, s.lam_km2),
            kappa=kappa, rNorm=rNorm_lq, sNorm=sNorm,
            solved_primal=solved_primal, solved_dual=solved_dual,
            solved_lq_tol=solved_lq_tol, solved_lq_mach=solved_lq_mach,
            solved_cg_tol=solved_cg_tol, solved_cg_mach=solved_cg_mach,
            solved_qr_tol=solved_qr_tol, solved_qr_mach=solved_qr_mach,
            solved_cg_flag=s.solved_cg_flag
            | (solved_cg & ~s.solved_primal & ~solved_lq),
            inconsistent_dual=inconsistent_dual, iter=it, status=code)
        if verbose > 0 and bool(active):
            rt.debug_row(verbose, it, "{:5d}  {:7.1e}  {:7.1e}", rNorm_lq,
                         sNorm)
        if callback is not None:
            s_new = _exit(callback, s_new, dev)
        return _masked(TrilqrState._fields, active, s_new, s,
                       keep=("hist_r", "hist_s"))

    s = rt.take_steps(body, state_in, steps, iter_cap, callback)
    return s._replace(x=torch.where(s.solved_cg_flag,
                                    s.x + s.zetabar * s.dbar_vec, s.x))


class _Flags(NamedTuple):
    """The nine flags of the TriLQR kernel, under the state's names, and
    the breakdown ``_bilqr_status`` reads (SSY has none)."""
    solved_lq_tol: bool
    solved_lq_mach: bool
    solved_cg_tol: bool
    solved_cg_mach: bool
    solved_qr_tol: bool
    solved_qr_mach: bool
    solved_primal: bool
    solved_dual: bool
    inconsistent_dual: bool
    breakdown: bool = False


def _trilqr_status(state, code):
    """BiLQR's status chain, then TriLQR's own inconsistent-dual branch
    (krylov_tpu/solvers/usymlq.py:773-793, reference src/trilqr.jl:
    429-444, whose chain leaves "unknown" there)."""
    status = _bilqr_status(state, code)
    if status != "unknown":
        return status
    if bool(state.inconsistent_dual):
        lq = bool(state.solved_lq_tol) or bool(state.solved_lq_mach)
        cg = bool(state.solved_cg_tol) or bool(state.solved_cg_mach)
        if lq or cg:
            pt = "xᶜ" if cg and not lq else "xᴸ"
            return (f"Found a primal solution {pt} and an approximate "
                    "least-squares dual solution t (dual system inconsistent)")
        return ("Only found an approximate least-squares dual solution t "
                "(dual system inconsistent)")
    return status


def _trilqr_solve(
    A, b, c, x0=None, y0=None, *, transfer_to_usymcg=True, atol=None,
    rtol=None, itmax=0, timemax=float("inf"), verbose=0, history=False,
    callback=None,
):
    start = time.perf_counter()
    A, b, c, x0, y0, m, n = _inputs(A, b, c, x0, y0)
    T = real_dtype(b.dtype)
    atol = rt.default_tol(atol, T)
    rtol = rt.default_tol(rtol, T)
    itmax = rt.resolve_itmax(itmax, m + n)
    rt.debug_table(verbose, "TRILQR", ("k", "‖rₖ‖", "‖sₖ‖"), m, n)
    hist_len = itmax + 1 if history else 0

    # Fast path: square DIA stencil + default config → whole-solve kernel.
    if (x0 is None and y0 is None and not history and callback is None
            and verbose == 0 and timemax == float("inf") and m == n
            and _fused_ready(A, n, b.dtype, trilqr_dia_fused_supported)):
        pd_adj, ot_adj = A.aligned_adjoint_kernel_args()
        x, y, niter, _, _, code_d, flags = trilqr_dia_fused(
            A._pd, pd_adj, A._offsets, ot_adj, b.contiguous(),
            c.contiguous(), atol, rtol, itmax,
            transfer_to_usymcg=bool(transfer_to_usymcg))
        niter, code, *fl = torch.cat([niter.reshape(1), code_d.reshape(1),
                                      flags]).tolist()
        code = rt.final_status_code(code, niter, itmax, False)
        flags = _Flags(*(bool(v) for v in fl))
        stats = AdjointStats(
            niter=niter, solved_primal=flags.solved_primal,
            solved_dual=flags.solved_dual, residuals_primal=np.zeros(0),
            residuals_dual=np.zeros(0), timer=time.perf_counter() - start,
            status=_trilqr_status(flags, code))
        return x, y, stats, None

    def run(state, cap, steps):
        return _trilqr_core(
            A, b, c, x0, y0, state, cap, steps, atol, rtol,
            transfer_to_usymcg=bool(transfer_to_usymcg),
            history=bool(history), hist_len=hist_len, callback=callback,
            verbose=int(verbose))

    state, overtimed = rt.drive(run, itmax, timemax, start)
    niter = int(state.iter)
    code = rt.final_status_code(state.status, niter, itmax, overtimed)
    x = state.x if x0 is None else state.x + x0
    y = state.y if y0 is None else state.y + y0
    flags = _Flags(*(bool(getattr(state, f)) for f in _Flags._fields[:9]))
    stats = AdjointStats(
        niter=niter, solved_primal=flags.solved_primal,
        solved_dual=flags.solved_dual,
        residuals_primal=_nan_trim(state.hist_r, niter, history),
        residuals_dual=_nan_trim(state.hist_s, niter, history),
        timer=time.perf_counter() - start,
        status=_trilqr_status(flags, code))
    return x, y, stats, state


def trilqr(A, b, c, x0=None, y0=None, *, precision=None, **kwargs):
    """x, y, stats = trilqr(A, b, c) — Ax = b and Aᴴy = c, A rectangular.

    ``precision="double_word"`` raises NotImplementedError until the
    iterative refinement (solvers/_refine.py, ROADMAP.md Queue 1 item 8)
    is ported."""
    _no_double_word("TRILQR", precision)
    x, y, stats, _ = _trilqr_solve(A, b, c, x0, y0, **kwargs)
    return x, y, stats


# ---------------------------------------------------------------------------
# USYMLQR — the saddle point [I A; Aᴴ 0][x; y] = [b; c] (reference
# src/usymlqr.jl): one SSY process drives a USYMQR-like least-squares
# sweep of [I A; Aᴴ 0][r; s] = [b; 0] (ls) and a USYMLQ-like least-norm
# sweep of [I A; Aᴴ 0][w; z] = [0; c] (ln); the solution is their sum.
# ---------------------------------------------------------------------------

class UsymlqrState(NamedTuple):
    x: torch.Tensor          # LN primal accumulator xᴸ (length m)
    r: torch.Tensor          # LS residual vector rₖ (length m)
    y: torch.Tensor          # LS solution accumulator yₖ (length n)
    z: torch.Tensor          # LN accumulator zᴸ (length n)
    vk: torch.Tensor
    vkm1: torch.Tensor
    uk: torch.Tensor
    ukm1: torch.Tensor
    w_km1: torch.Tensor
    w_km2: torch.Tensor
    dbar_vec: torch.Tensor
    beta: torch.Tensor
    gamma: torch.Tensor
    c_km2: torch.Tensor
    s_km2: torch.Tensor
    c_km1: torch.Tensor
    s_km1: torch.Tensor
    phibar: torch.Tensor
    zeta_km1: torch.Tensor
    zeta_km2: torch.Tensor
    eta_km1: torch.Tensor
    delta_km1: torch.Tensor
    kappa: torch.Tensor
    rNorm_ls: torch.Tensor
    rNorm_ln: torch.Tensor
    AHrNorm: torch.Tensor
    eps_ls: torch.Tensor
    eps_ln: torch.Tensor
    solved_ls: torch.Tensor
    solved_ln: torch.Tensor
    inconsistent: torch.Tensor
    iter: torch.Tensor
    status: torch.Tensor
    hist_r: torch.Tensor
    hist_ar: torch.Tensor


def _usymlqr_core(
    A, b, c, x0, y0, state_in, iter_cap, steps, atol, rtol,
    *, ls, ln, history, hist_len, callback, verbose,
):
    """``steps`` USYMLQR iterations from ``state_in`` (None: start), each
    with its updates masked by ``status == RUNNING and iter < iter_cap``;
    each sweep is frozen by its own mask (krylov_tpu/solvers/usymlq.py:
    962-1146).  The saddle-point composition is left to the caller, once
    after the last chunk."""
    FC = b.dtype
    T = real_dtype(FC)
    dev = b.device

    if state_in is None:
        # a warm start folds the guess into the right-hand sides:
        # b₀ = b − Δx − AΔy, c₀ = c − AᴴΔx (reference usymlqr.jl:178-185)
        b0, c0 = b, c
        if y0 is not None:
            b0 = b0 - A.matvec(y0)
        if x0 is not None:
            b0 = b0 - x0
            c0 = c0 - A.rmatvec(x0)
        beta, gamma = knorm(b0), knorm(c0)
        eps_ls = _tol(atol, T, dev) + _tol(rtol, T, dev) * beta
        eps_ln = _tol(atol, T, dev) + _tol(rtol, T, dev) * gamma
        solved_ls = (beta <= eps_ls) | (not ls)
        solved_ln = (gamma <= eps_ln) | (not ln)
        status = torch.where(solved_ls & solved_ln, rt.SOLVED,
                             rt.RUNNING).to(torch.int32)
        zc = torch.zeros((), dtype=FC, device=dev)
        one = -torch.ones((), dtype=T, device=dev)
        hr = rt.hist_write(rt.hist_init(hist_len, T, dev), _i32(0, dev),
                           beta if ls else gamma, history)
        state_in = UsymlqrState(
            x=torch.zeros_like(b0), r=b0 if ls else torch.zeros_like(b0),
            y=torch.zeros_like(c0), z=torch.zeros_like(c0),
            vk=torch.where(beta != 0, b0 / _safe(beta).to(FC),
                           torch.zeros_like(b0)),
            vkm1=torch.zeros_like(b0),
            uk=torch.where(gamma != 0, c0 / _safe(gamma).to(FC),
                           torch.zeros_like(c0)),
            ukm1=torch.zeros_like(c0), w_km1=torch.zeros_like(c0),
            w_km2=torch.zeros_like(c0), dbar_vec=torch.zeros_like(b0),
            beta=beta, gamma=gamma, c_km2=one, s_km2=zc, c_km1=one,
            s_km1=zc, phibar=beta.to(FC), zeta_km1=zc, zeta_km2=zc,
            eta_km1=zc, delta_km1=zc,
            kappa=torch.zeros((), dtype=T, device=dev), rNorm_ls=beta,
            rNorm_ln=gamma,
            AHrNorm=torch.full((), float("inf"), dtype=T, device=dev),
            eps_ls=eps_ls, eps_ln=eps_ln, solved_ls=solved_ls,
            solved_ln=solved_ln,
            inconsistent=torch.zeros((), dtype=torch.bool, device=dev),
            iter=_i32(0, dev), status=status, hist_r=hr,
            hist_ar=rt.hist_init(hist_len, T, dev))

    def body(s):
        active = (s.status == rt.RUNNING) & (s.iter < iter_cap)
        it = s.iter + 1
        q, p, alpha, beta_kp1, gamma_kp1 = _ssy_step(
            A, s.vk, s.uk, s.vkm1, s.ukm1, s.beta, s.gamma, it, FC)
        # QR of Tₖ₊₁.ₖ, two previous reflections then a new one
        # (reference usymlqr.jl:286-313); the (-1, 0) initial reflections
        # make the k = 1, 2 cases branchless
        gam = s.gamma.to(FC)
        c_km1, c_km2 = s.c_km1.to(FC), s.c_km2.to(FC)
        eps_km2 = s.s_km2 * gam
        lambdabar = -c_km2 * gam
        lam_km1 = c_km1 * lambdabar + s.s_km1 * alpha
        deltabar = torch.conj(s.s_km1) * lambdabar - c_km1 * alpha
        ck, sk, delta = sym_givens(deltabar, beta_kp1.to(FC))
        ck, sk, delta = _real(ck).to(T), sk.to(FC), delta.to(FC)
        w_new = (s.uk - lam_km1 * s.w_km1 - eps_km2 * s.w_km2) \
            / _safe(delta)
        # least-squares sweep (reference usymlqr.jl:334-367)
        als = ~s.solved_ls & ls
        phi = ck.to(FC) * s.phibar
        phibar_next = torch.conj(sk) * s.phibar
        y_new = torch.where(als, s.y + phi * w_new, s.y)
        rfac = torch.where(beta_kp1 != 0, -ck.to(FC) * phibar_next
                           / _safe(beta_kp1).to(FC), torch.zeros_like(phi))
        r_new = torch.where(als, torch.abs(sk) ** 2 * s.r + rfac * q, s.r)
        rNorm_ls = torch.where(als, torch.abs(phibar_next), s.rNorm_ls)
        AHrNorm = torch.where(als, torch.abs(s.phibar) * torch.sqrt(
            torch.abs(deltabar) ** 2 + torch.abs(s.c_km1 * gamma_kp1) ** 2),
            s.AHrNorm)
        kappa = torch.where((it == 1) & ls, _tol(atol, T, dev)
                            + _tol(rtol, T, dev) * AHrNorm, s.kappa)
        solved_ls = s.solved_ls | (als & (rNorm_ls <= s.eps_ls))
        inconsistent = torch.where(
            als, ~(rNorm_ls <= s.eps_ls) & (AHrNorm <= kappa),
            s.inconsistent)
        # least-norm sweep (reference usymlqr.jl:370-436)
        aln = ~s.solved_ln & ln
        zeta_km1 = torch.where(aln & (it >= 2), s.eta_km1
                               / torch.conj(_safe(s.delta_km1)), s.zeta_km1)
        zeta_km2 = torch.where(aln & (it >= 3), s.zeta_km1, s.zeta_km2)
        eta = torch.where(aln, torch.where(
            it == 1, gam, -torch.conj(eps_km2) * zeta_km2
            - torch.conj(lam_km1) * zeta_km1), s.eta_km1)
        x_new = torch.where(
            aln & (it >= 2), s.x + zeta_km1 * c_km1 * s.dbar_vec
            + zeta_km1 * torch.conj(s.s_km1) * s.vk, s.x)
        z_new = torch.where(aln & (it >= 2), s.z - zeta_km1 * s.w_km1, s.z)
        dbar_vec = torch.where(aln, torch.where(
            it == 1, s.vk, s.s_km1 * s.dbar_vec - c_km1 * s.vk), s.dbar_vec)
        mu = gam * (torch.conj(s.s_km2) * zeta_km2 - c_km2 * c_km1
                    * zeta_km1) + torch.conj(alpha * s.s_km1) * zeta_km1
        om = gamma_kp1.to(FC) * torch.conj(s.s_km1) * zeta_km1
        rNorm_ln = torch.where(aln & (it >= 2), torch.sqrt(
            torch.abs(mu) ** 2 + torch.abs(om) ** 2), s.rNorm_ln)
        solved_ln = s.solved_ln | (aln & (rNorm_ln <= s.eps_ln))
        # advance the basis; zero on breakdown keeps orthogonality
        # (reference usymlqr.jl:440-455)
        vk_new = torch.where(beta_kp1 != 0, q / _safe(beta_kp1).to(FC),
                             torch.zeros_like(q))
        uk_new = torch.where(gamma_kp1 != 0, p / _safe(gamma_kp1).to(FC),
                             torch.zeros_like(p))
        code = torch.where(solved_ls & solved_ln, rt.SOLVED, torch.where(
            inconsistent, rt.INCONSISTENT, rt.RUNNING)).to(torch.int32)
        rt.hist_write_masked(s.hist_r, active, it,
                             rNorm_ls if ls else rNorm_ln, history)
        rt.hist_write_masked(
            s.hist_ar, active, it, AHrNorm if ls else torch.full_like(
                AHrNorm, float("nan")), history)
        s_new = s._replace(
            x=x_new, r=r_new, y=y_new, z=z_new, vk=vk_new, vkm1=s.vk,
            uk=uk_new, ukm1=s.uk, w_km1=w_new, w_km2=s.w_km1,
            dbar_vec=dbar_vec, beta=beta_kp1, gamma=gamma_kp1,
            c_km2=s.c_km1, s_km2=s.s_km1, c_km1=ck, s_km1=sk,
            phibar=torch.where(als, phibar_next, s.phibar),
            zeta_km1=zeta_km1, zeta_km2=zeta_km2,
            eta_km1=torch.where(aln, eta, s.eta_km1), delta_km1=delta,
            kappa=kappa, rNorm_ls=rNorm_ls, rNorm_ln=rNorm_ln,
            AHrNorm=AHrNorm, solved_ls=solved_ls, solved_ln=solved_ln,
            inconsistent=inconsistent, iter=it, status=code)
        if verbose > 0 and bool(active):
            # reference column set src/usymlqr.jl:239 (timer omitted)
            rt.debug_row(verbose, it,
                         "{:5d}  {:7.1e}  {:7.1e}  {:7.1e}  {:7.1e}",
                         beta_kp1, gamma_kp1, rNorm_ls, rNorm_ln)
        if callback is not None:
            s_new = _exit(callback, s_new, dev)
        return _masked(UsymlqrState._fields, active, s_new, s)

    return rt.take_steps(body, state_in, steps, iter_cap, callback)


def _usymlqr_solve(
    A, b, c, x0=None, y0=None, *, ls=True, ln=True, atol=None, rtol=None,
    itmax=0, timemax=float("inf"), verbose=0, history=False, callback=None,
):
    """Solves [I A; Aᴴ 0][x; y] = [b; c] with x ∈ ℂᵐ, y ∈ ℂⁿ; ``ls`` and
    ``ln`` select the least-squares and least-norm sweeps, and the pair
    returned is the sum of the selected parts (reference src/usymlqr.jl:
    136-510, krylov_tpu/solvers/usymlq.py:1152-1244)."""
    start = time.perf_counter()
    if not (ls or ln):
        raise ValueError(
            "The keyword arguments `ls` and `ln` can't be both `false`.")
    A, b, c, x0, y0, m, n = _inputs(A, b, c, x0, y0)
    if b.shape[0] != m or c.shape[0] != n:
        raise ValueError("Inconsistent problem size")
    T = real_dtype(b.dtype)
    atol = rt.default_tol(atol, T)
    rtol = rt.default_tol(rtol, T)
    itmax = rt.resolve_itmax(itmax, m + n)
    rt.debug_table(verbose, "USYMLQR",
                   ("k", "βₖ₊₁", "γₖ₊₁", "‖rₖ‖_LS", "‖rₖ‖_LN"), m, n)
    hist_len = itmax + 1 if history else 0

    # Fast path: square DIA stencil + default config → whole-solve kernel.
    if (x0 is None and y0 is None and not history and callback is None
            and verbose == 0 and timemax == float("inf") and m == n
            and _fused_ready(A, n, b.dtype, usymlqr_dia_fused_supported)):
        pd_adj, ot_adj = A.aligned_adjoint_kernel_args()
        x, y, niter, _, _, code_d, _ = usymlqr_dia_fused(
            A._pd, pd_adj, A._offsets, ot_adj, b.contiguous(),
            c.contiguous(), atol, rtol, itmax, ls=bool(ls), ln=bool(ln))
        niter, code = torch.stack([niter, code_d]).tolist()
        code = rt.final_status_code(code, niter, itmax, False)
        stats = SimpleStats(
            niter=niter, solved=rt.is_solved_code(code),
            inconsistent=code == rt.INCONSISTENT, residuals=np.zeros(0),
            Aresiduals=np.zeros(0), timer=time.perf_counter() - start,
            status=rt.decode_status(code))
        return x, y, stats, None

    def run(state, cap, steps):
        return _usymlqr_core(
            A, b, c, x0, y0, state, cap, steps, atol, rtol, ls=bool(ls),
            ln=bool(ln), history=bool(history), hist_len=hist_len,
            callback=callback, verbose=int(verbose))

    state, overtimed = rt.drive(run, itmax, timemax, start)
    niter = int(state.iter)
    code = rt.final_status_code(state.status, niter, itmax, overtimed)
    # the saddle-point composition x ← xᴸ + r, y ← yₖ + zᴸ (reference
    # usymlqr.jl:494-497), then the warm start
    x, y = state.x + state.r, state.y + state.z
    if x0 is not None:
        x = x + x0
    if y0 is not None:
        y = y + y0
    stats = SimpleStats(
        niter=niter, solved=rt.is_solved_code(code),
        inconsistent=code == rt.INCONSISTENT,
        residuals=_nan_trim(state.hist_r, niter, history),
        Aresiduals=_nan_trim(state.hist_ar, niter, history),
        timer=time.perf_counter() - start,
        status=rt.decode_status(code))
    return x, y, stats, state


def usymlqr(A, b, c, x0=None, y0=None, *, precision=None, **kwargs):
    """x, y, stats = usymlqr(A, b, c; ls=True, ln=True) — the saddle-point
    system [I A; Aᴴ 0][x; y] = [b; c] through one SSY process.

    ``precision="double_word"`` raises NotImplementedError until the
    iterative refinement (solvers/_refine.py, ROADMAP.md Queue 1 item 8)
    and the TriMR inner solves it runs (Queue 1 item 6) are ported."""
    _no_double_word("USYMLQR", precision)
    x, y, stats, _ = _usymlqr_solve(A, b, c, x0, y0, **kwargs)
    return x, y, stats
