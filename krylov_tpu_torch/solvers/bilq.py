"""BiLQ, QMR and BiLQR — Lanczos biorthogonalization methods.

Counterpart of ``krylov_tpu/solvers/bilq.py`` and of reference
src/bilq.jl (LQ of Tₖ, transfer_to_bicg), src/qmr.jl (QR of Tₖ₊₁.ₖ) and
src/bilqr.jl (the adjoint systems Ax = b and Aᴴy = c from one process,
with ``AdjointStats`` and the combined status vocabulary).  All three
share the two-sided Lanczos step (one A and one Aᴴ product per
iteration), with the shadow vector c (b by default), warm start,
history, callback, verbose and timemax.  A DIA operator on the card with
c = b (BiLQR: any c), no warm start and the default options goes to a
whole-solve kernel (ops/cuda_fused.py) on Aᴴ's aligned diagonals
(``DIAOperator.aligned_adjoint``); every other configuration runs the
general core, whose iterations ``_runtime.drive`` takes in chunks with
masked updates.
"""

import time
from typing import NamedTuple

import numpy as np
import torch

from .. import _runtime as rt
from .._dtypes import real_dtype
from ..operators import solve_inputs, with_adjoint as _with_adjoint
from ..ops.cuda_fused import (BC_BREAKDOWN, SOLVED_CG_PT, SOLVED_LQ,
                              UV_BREAKDOWN, bilq_dia_fused,
                              bilq_dia_fused_supported, bilqr_dia_fused,
                              bilqr_dia_fused_supported, qmr_dia_fused,
                              qmr_dia_fused_supported)
from ..ops.kops import kdot, kdotr, knorm, sym_givens
from ..stats import AdjointStats, SimpleStats
from .cr import _check_square, _fused_ready, _i32, _masked, _no_double_word, \
    _trim

# BiLQ's solved codes are SYMMLQ's numbers with BiLQ's own strings,
# decoded through this table (krylov_tpu/solvers/bilq.py:23-33)
_STATUS = {
    BC_BREAKDOWN: "Breakdown bᴴc = 0",
    UV_BREAKDOWN: "Breakdown ⟨uₖ₊₁,vₖ₊₁⟩ = 0",
    SOLVED_LQ: "solution xᴸ good enough given atol and rtol",
    SOLVED_CG_PT: "solution xᶜ good enough given atol and rtol",
}


def _safe(d):
    return torch.where(d == 0, torch.ones_like(d), d)


def _real(v):
    return v.real if v.is_complex() else v


def _bi_lanczos_step(A, vk, uk, vkm1, ukm1, beta_k, gamma_k, FC):
    """One step of the two-sided Lanczos process (reference bilq :230-260).
    Returns (q, p, alpha, pHq, beta_kp1, gamma_kp1)."""
    q = A.matvec(vk)
    p = A.rmatvec(uk)
    q = q - gamma_k * vkm1
    p = p - torch.conj(beta_k) * ukm1
    alpha = kdot(uk, q)
    q = q - alpha * vk
    p = p - torch.conj(alpha) * uk
    pHq = kdot(p, q)
    beta_kp1 = torch.sqrt(torch.abs(pHq))
    gamma_kp1 = pHq / _safe(beta_kp1).to(FC)
    return q, p, alpha, pHq, beta_kp1, gamma_kp1


def _start(A, b, c, x0, atol, rtol):
    """r₀, ‖r₀‖, cᴴr₀, β₁, γ₁, v₁, u₁ and ε (krylov_tpu/solvers/bilq.py:
    101-108)."""
    FC = b.dtype
    T = real_dtype(FC)
    r0 = b if x0 is None else b - A.matvec(x0)
    bNorm = knorm(r0)
    cHb = kdot(c, r0)
    beta = torch.sqrt(torch.abs(cHb)).to(FC)
    gamma = cHb / _safe(beta)
    vk = r0 / _safe(beta)
    uk = c / _safe(torch.conj(gamma))
    eps_lim = torch.tensor(atol, dtype=T, device=b.device) \
        + torch.tensor(rtol, dtype=T, device=b.device) * bNorm
    return bNorm, cHb, beta, gamma, vk, uk, eps_lim


def _lq_step(s, it, alpha, FC, T):
    """The LQ factorisation of Tₖ shared by BiLQ and BiLQR (reference
    :262-288); no rotation at iteration 1: c, s keep (-1, 0).  Returns
    (ck, sk, d_km1, lam_km1, eps_km2, dbar_k)."""
    dev = alpha.device
    ck_g, sk_g, d_km1 = sym_givens(s.dbar_km1, s.gamma)
    ck = torch.where(it == 1, -torch.ones((), dtype=T, device=dev),
                     ck_g.to(T))
    sk = torch.where(it == 1, torch.zeros((), dtype=FC, device=dev),
                     sk_g.to(FC))
    eps_km2 = s.s_km1 * s.beta
    lam2 = ck * s.beta + sk * alpha
    dbar2 = torch.conj(sk) * s.beta - ck * alpha
    lam3 = -s.c_km1 * ck * s.beta + sk * alpha
    dbar3 = -s.c_km1 * torch.conj(sk) * s.beta - ck * alpha
    lam_km1 = torch.where(it == 2, lam2, lam3)
    dbar_k = torch.where(it == 1, alpha, torch.where(it == 2, dbar2, dbar3))
    return ck, sk, d_km1.to(FC), lam_km1, eps_km2, dbar_k


def _lq_residual(s, it, alpha, ck, sk, zeta_km1, zeta_km2, beta_kp1,
                 vHv, norm_vkp1, FC):
    """The LQ point's residual estimate (reference :296-303)."""
    mu = s.beta * (s.s_km1 * zeta_km2 - s.c_km1 * ck * zeta_km1) \
        + alpha * sk * zeta_km1
    om = beta_kp1.to(FC) * sk * zeta_km1
    th = torch.conj(mu) * om * vHv
    return torch.where(it == 1, s.rNorm, torch.sqrt(
        torch.abs(mu) ** 2 * s.norm_vk ** 2
        + torch.abs(om) ** 2 * norm_vkp1 ** 2 + 2 * _real(th)))


def _nan_trim(hist, niter, history):
    """The history without the NaN entries of the iterations in which its
    system was already solved (krylov_tpu/solvers/bilq.py:920-922)."""
    if not history:
        return np.zeros(0)
    h = rt.hist_trim(hist, niter)
    return h[~np.isnan(h)]


def _exit(callback, s_new, dev):
    """A callback's exit while the solve runs."""
    user_exit = torch.as_tensor(callback(s_new), device=dev)
    return s_new._replace(status=torch.where(
        user_exit & (s_new.status == rt.RUNNING), rt.USER_EXIT,
        s_new.status).to(torch.int32))


# ---------------------------------------------------------------------------
# BiLQ
# ---------------------------------------------------------------------------

class BilqState(NamedTuple):
    x: torch.Tensor
    vk: torch.Tensor
    vkm1: torch.Tensor
    uk: torch.Tensor
    ukm1: torch.Tensor
    dbar_vec: torch.Tensor
    beta: torch.Tensor          # βₖ (FC: carries the complex phase convention)
    gamma: torch.Tensor
    c_km1: torch.Tensor
    s_km1: torch.Tensor
    dbar_km1: torch.Tensor
    zeta_km1: torch.Tensor
    zeta_km2: torch.Tensor
    eta_km1: torch.Tensor
    zetabar: torch.Tensor
    norm_vk: torch.Tensor
    rNorm: torch.Tensor
    eps_lim: torch.Tensor
    iter: torch.Tensor
    status: torch.Tensor
    solved_cg_flag: torch.Tensor
    hist_r: torch.Tensor


def _bilq_core(
    A, b, c, x0, state_in, iter_cap, steps, atol, rtol,
    *, transfer_to_bicg, history, hist_len, callback, verbose,
):
    """``steps`` BiLQ iterations from ``state_in`` (None: start), each
    with its updates masked by ``status == RUNNING and iter < iter_cap``;
    the state returned has x at the BiCG point once that point solved
    (krylov_tpu/solvers/bilq.py:226-232)."""
    FC = b.dtype
    T = real_dtype(FC)
    dev = b.device
    eps_T = torch.finfo(T).eps

    if state_in is None:
        bNorm, cHb, beta, gamma, vk, uk, eps_lim = _start(A, b, c, x0, atol,
                                                          rtol)
        status = torch.where(
            bNorm == 0, rt.ZERO_RESIDUAL, torch.where(
                cHb == 0, BC_BREAKDOWN, torch.where(
                    bNorm <= eps_lim, SOLVED_LQ, rt.RUNNING))).to(
                        torch.int32)
        hist = rt.hist_write(rt.hist_init(hist_len, T, dev), _i32(0, dev),
                             bNorm, history)
        zc = torch.zeros((), dtype=FC, device=dev)
        state_in = BilqState(
            x=torch.zeros_like(b), vk=vk, vkm1=torch.zeros_like(b), uk=uk,
            ukm1=torch.zeros_like(b), dbar_vec=torch.zeros_like(b),
            beta=beta, gamma=gamma,
            c_km1=-torch.ones((), dtype=T, device=dev), s_km1=zc,
            dbar_km1=zc, zeta_km1=zc, zeta_km2=zc, eta_km1=zc, zetabar=zc,
            norm_vk=bNorm / _safe(torch.abs(beta)), rNorm=bNorm,
            eps_lim=eps_lim, iter=_i32(0, dev), status=status,
            solved_cg_flag=torch.zeros((), dtype=torch.bool, device=dev),
            hist_r=hist)

    def body(s):
        active = (s.status == rt.RUNNING) & (s.iter < iter_cap)
        it = s.iter + 1
        q, p, alpha, pHq, beta_kp1, gamma_kp1 = _bi_lanczos_step(
            A, s.vk, s.uk, s.vkm1, s.ukm1, s.beta, s.gamma, FC)
        ck, sk, d_km1, lam_km1, eps_km2, dbar_k = _lq_step(s, it, alpha, FC,
                                                           T)
        # z̅ₖ components
        zeta_km1 = torch.where(it >= 2, s.eta_km1 / _safe(d_km1), s.zeta_km1)
        zeta_km2 = torch.where(it >= 3, s.zeta_km1, s.zeta_km2)
        eta_k = torch.where(it == 1, s.beta, torch.where(
            it == 2, -lam_km1 * zeta_km1,
            -eps_km2 * zeta_km2 - lam_km1 * zeta_km1))
        # directions and x update
        x_new = torch.where(
            it >= 2, s.x + (zeta_km1 * ck).to(FC) * s.dbar_vec
            + (zeta_km1 * sk).to(FC) * s.vk, s.x)
        dbar_vec = torch.where(it == 1, s.vk, torch.conj(sk) * s.dbar_vec
                               - ck.to(FC) * s.vk)
        # advance the Lanczos vectors
        nz = pHq != 0
        vk_new = torch.where(nz, q / _safe(beta_kp1).to(FC), s.vk)
        uk_new = torch.where(nz, p / _safe(torch.conj(gamma_kp1)), s.uk)
        vHv = kdot(s.vk, vk_new)
        norm_vkp1 = knorm(vk_new)
        rNorm_lq = _lq_residual(s, it, alpha, ck, sk, zeta_km1, zeta_km2,
                                beta_kp1, vHv, norm_vkp1, FC)
        dbar_ok = torch.abs(dbar_k) > eps_T
        zetabar = torch.where(dbar_ok, eta_k / _safe(dbar_k), s.zetabar)
        rho = beta_kp1.to(FC) * (sk * zeta_km1 - ck * zetabar)
        rNorm_cg = torch.abs(rho) * norm_vkp1
        solved_lq = rNorm_lq <= s.eps_lim
        solved_cg = bool(transfer_to_bicg) & dbar_ok \
            & (rNorm_cg <= s.eps_lim)
        breakdown = ~solved_lq & ~solved_cg & (pHq == 0)
        code = torch.where(solved_cg & ~solved_lq, SOLVED_CG_PT, torch.where(
            solved_lq, SOLVED_LQ, torch.where(
                breakdown, UV_BREAKDOWN, rt.RUNNING))).to(torch.int32)
        rt.hist_write_masked(s.hist_r, active, it, rNorm_lq, history)
        s_new = s._replace(
            x=x_new, vk=vk_new, vkm1=s.vk, uk=uk_new, ukm1=s.uk,
            dbar_vec=dbar_vec, beta=beta_kp1.to(FC), gamma=gamma_kp1,
            c_km1=ck, s_km1=sk, dbar_km1=dbar_k, zeta_km1=zeta_km1,
            zeta_km2=zeta_km2, eta_km1=eta_k, zetabar=zetabar,
            norm_vk=norm_vkp1, rNorm=rNorm_lq, iter=it, status=code,
            solved_cg_flag=solved_cg & ~solved_lq)
        if verbose > 0 and bool(active):
            rt.debug_row(verbose, it, "{:5d}  {:7.1e}  {:7.1e}",
                         torch.abs(alpha), rNorm_lq)
        if callback is not None:
            s_new = _exit(callback, s_new, dev)
        return _masked(BilqState._fields, active, s_new, s, keep=("hist_r",))

    s = rt.take_steps(body, state_in, steps, iter_cap, callback)
    return s._replace(x=torch.where(s.solved_cg_flag,
                                    s.x + s.zetabar * s.dbar_vec, s.x))


def _bilq_solve(
    A, b, x0=None, *, c=None, transfer_to_bicg=True, atol=None, rtol=None,
    itmax=0, timemax=float("inf"), verbose=0, history=False, callback=None,
):
    start = time.perf_counter()
    A, b, x0, _ = solve_inputs(A, b, x0)
    A = _with_adjoint(A)
    n = b.shape[0]
    _check_square(A, n)
    T = real_dtype(b.dtype)
    atol = rt.default_tol(atol, T)
    rtol = rt.default_tol(rtol, T)
    itmax = rt.resolve_itmax(itmax, 2 * n)
    rt.debug_table(verbose, "BILQ", ("k", "αₖ", "‖rₖ‖"), n)
    hist_len = itmax + 1 if history else 0

    # Fast path: DIA stencil + default config (c = b, no warm start: the
    # kernel's shadow vector is its initial residual) → whole-solve kernel.
    if (c is None and x0 is None and callback is None and verbose == 0
            and not history and timemax == float("inf")
            and _fused_ready(A, n, b.dtype, bilq_dia_fused_supported)):
        pd_adj, ot_adj = A.aligned_adjoint_kernel_args()
        x, niter, _, code_d = bilq_dia_fused(
            A._pd, pd_adj, A._offsets, ot_adj, b.contiguous(), atol, rtol,
            itmax, transfer_to_bicg=bool(transfer_to_bicg))
        niter, code = torch.stack([niter, code_d]).tolist()
        code = rt.final_status_code(code, niter, itmax, False)
        stats = SimpleStats(
            niter=niter,
            solved=rt.is_solved_code(code) or code in (SOLVED_LQ,
                                                       SOLVED_CG_PT),
            inconsistent=False,
            residuals=np.zeros(0),
            timer=time.perf_counter() - start,
            status=rt.decode_status(code, _STATUS),
        )
        return x, stats, None

    c = b if c is None else rt.as_device_tensor(c, b).to(b.dtype)

    def run(state, cap, steps):
        return _bilq_core(
            A, b, c, x0, state, cap, steps, atol, rtol,
            transfer_to_bicg=bool(transfer_to_bicg), history=bool(history),
            hist_len=hist_len, callback=callback, verbose=int(verbose),
        )

    state, overtimed = rt.drive(run, itmax, timemax, start)
    niter = int(state.iter)
    code = rt.final_status_code(state.status, niter, itmax, overtimed)
    x = state.x
    if x0 is not None:
        x = x + x0
    stats = SimpleStats(
        niter=niter,
        solved=rt.is_solved_code(code) or code in (SOLVED_LQ,
                                                   SOLVED_CG_PT),
        inconsistent=False,
        residuals=_trim(state.hist_r, niter, history),
        timer=time.perf_counter() - start,
        status=rt.decode_status(code, _STATUS),
    )
    return x, stats, state


def bilq(A, b, x0=None, *, precision=None, **kwargs):
    """x, stats = bilq(A, b; c=b, transfer_to_bicg=True, ...).

    ``precision="double_word"`` raises NotImplementedError until the
    iterative refinement (solvers/_refine.py, ROADMAP.md Queue 1 item 8)
    is ported."""
    _no_double_word("BILQ", precision)
    x, stats, _ = _bilq_solve(A, b, x0, **kwargs)
    return x, stats


# ---------------------------------------------------------------------------
# QMR
# ---------------------------------------------------------------------------

class QmrState(NamedTuple):
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
    tau: torch.Tensor
    rNorm: torch.Tensor
    eps_lim: torch.Tensor
    iter: torch.Tensor
    status: torch.Tensor
    hist_r: torch.Tensor


def _qmr_core(
    A, b, c, x0, state_in, iter_cap, steps, atol, rtol,
    *, history, hist_len, callback, verbose,
):
    """``steps`` QMR iterations from ``state_in`` (None: start), each with
    its updates masked by ``status == RUNNING and iter < iter_cap``."""
    FC = b.dtype
    T = real_dtype(FC)
    dev = b.device

    if state_in is None:
        bNorm, cHb, beta, gamma, vk, uk, eps_lim = _start(A, b, c, x0, atol,
                                                          rtol)
        status = torch.where(
            bNorm == 0, rt.ZERO_RESIDUAL, torch.where(
                cHb == 0, BC_BREAKDOWN, torch.where(
                    bNorm <= eps_lim, rt.SOLVED, rt.RUNNING))).to(
                        torch.int32)
        hist = rt.hist_write(rt.hist_init(hist_len, T, dev), _i32(0, dev),
                             bNorm, history)
        zc = torch.zeros((), dtype=FC, device=dev)
        zt = torch.zeros((), dtype=T, device=dev)
        state_in = QmrState(
            x=torch.zeros_like(b), vk=vk, vkm1=torch.zeros_like(b), uk=uk,
            ukm1=torch.zeros_like(b), w_km2=torch.zeros_like(b),
            w_km1=torch.zeros_like(b), beta=beta, gamma=gamma,
            c_km2=zt, s_km2=zc, c_km1=zt, s_km1=zc,
            # r₀ = β₁v₁ exactly, so ζbar₁ = β₁ (≠ ‖r₀‖ when c ≠ r₀)
            zetabar=beta, tau=bNorm * bNorm / torch.abs(_safe(beta)) ** 2,
            rNorm=bNorm, eps_lim=eps_lim, iter=_i32(0, dev), status=status,
            hist_r=hist)

    def body(s):
        active = (s.status == rt.RUNNING) & (s.iter < iter_cap)
        it = s.iter + 1
        q, p, alpha, pHq, beta_kp1, gamma_kp1 = _bi_lanczos_step(
            A, s.vk, s.uk, s.vkm1, s.ukm1, s.beta, s.gamma, FC)
        zc = torch.zeros((), dtype=FC, device=dev)
        # QR of Tₖ₊₁.ₖ (reference :276-300)
        eps_km2 = torch.where(it >= 3, s.s_km2 * s.gamma, zc)
        lbar_km1 = torch.where(it >= 3, -s.c_km2.to(FC) * s.gamma,
                               torch.where(it == 2, s.gamma, zc))
        lam_km1 = torch.where(it >= 2, s.c_km1.to(FC) * lbar_km1
                              + s.s_km1 * alpha, zc)
        dbar_k = torch.where(it >= 2, torch.conj(s.s_km1) * lbar_km1
                             - s.c_km1.to(FC) * alpha, alpha)
        ck, sk, d_k = sym_givens(dbar_k, beta_kp1.to(FC))
        d_k = d_k.to(FC)
        zeta_k = ck.to(FC) * s.zetabar
        zetabar_next = torch.conj(sk.to(FC)) * s.zetabar
        # direction wₖ
        w1 = s.vk / _safe(d_k)
        w2 = (s.vk - lam_km1 * s.w_km1) / _safe(d_k)
        w3 = (s.vk - lam_km1 * s.w_km1 - eps_km2 * s.w_km2) / _safe(d_k)
        w_k = torch.where(it == 1, w1, torch.where(it == 2, w2, w3))
        x_new = s.x + zeta_k * w_k
        nz = pHq != 0
        vk_new = torch.where(nz, q / _safe(beta_kp1).to(FC), s.vk)
        uk_new = torch.where(nz, p / _safe(torch.conj(gamma_kp1)), s.uk)
        tau = s.tau + kdotr(vk_new, vk_new)
        rNorm = torch.abs(zetabar_next) * torch.sqrt(tau)
        solved = (rNorm <= s.eps_lim) | ((rNorm + 1.0) <= 1.0)
        breakdown = ~solved & (pHq == 0)
        code = torch.where(solved, rt.SOLVED, torch.where(
            breakdown, UV_BREAKDOWN, rt.RUNNING)).to(torch.int32)
        rt.hist_write_masked(s.hist_r, active, it, rNorm, history)
        s_new = s._replace(
            x=x_new, vk=vk_new, vkm1=s.vk, uk=uk_new, ukm1=s.uk,
            w_km2=torch.where(it >= 2, s.w_km1, s.w_km2), w_km1=w_k,
            beta=beta_kp1.to(FC), gamma=gamma_kp1, c_km2=s.c_km1,
            s_km2=s.s_km1, c_km1=_real(ck).to(T), s_km1=sk.to(FC),
            zetabar=zetabar_next, tau=tau, rNorm=rNorm, iter=it,
            status=code)
        if verbose > 0 and bool(active):
            rt.debug_row(verbose, it, "{:5d}  {:7.1e}  {:7.1e}",
                         torch.abs(alpha), rNorm)
        if callback is not None:
            s_new = _exit(callback, s_new, dev)
        return _masked(QmrState._fields, active, s_new, s, keep=("hist_r",))

    return rt.take_steps(body, state_in, steps, iter_cap, callback)


def _qmr_solve(
    A, b, x0=None, *, c=None, atol=None, rtol=None, itmax=0,
    timemax=float("inf"), verbose=0, history=False, callback=None,
):
    start = time.perf_counter()
    A, b, x0, _ = solve_inputs(A, b, x0)
    A = _with_adjoint(A)
    n = b.shape[0]
    _check_square(A, n)
    T = real_dtype(b.dtype)
    atol = rt.default_tol(atol, T)
    rtol = rt.default_tol(rtol, T)
    itmax = rt.resolve_itmax(itmax, 2 * n)
    rt.debug_table(verbose, "QMR", ("k", "αₖ", "‖rₖ‖"), n)
    hist_len = itmax + 1 if history else 0

    # Fast path: DIA stencil + default config (c = b, no warm start) →
    # whole-solve kernel.
    if (c is None and x0 is None and callback is None and verbose == 0
            and not history and timemax == float("inf")
            and _fused_ready(A, n, b.dtype, qmr_dia_fused_supported)):
        pd_adj, ot_adj = A.aligned_adjoint_kernel_args()
        x, niter, _, code_d = qmr_dia_fused(
            A._pd, pd_adj, A._offsets, ot_adj, b.contiguous(), atol, rtol,
            itmax)
        niter, code = torch.stack([niter, code_d]).tolist()
        code = rt.final_status_code(code, niter, itmax, False)
        stats = SimpleStats(
            niter=niter,
            solved=rt.is_solved_code(code),
            inconsistent=False,
            residuals=np.zeros(0),
            timer=time.perf_counter() - start,
            status=rt.decode_status(code, _STATUS),
        )
        return x, stats, None

    c = b if c is None else rt.as_device_tensor(c, b).to(b.dtype)

    def run(state, cap, steps):
        return _qmr_core(
            A, b, c, x0, state, cap, steps, atol, rtol,
            history=bool(history), hist_len=hist_len, callback=callback,
            verbose=int(verbose),
        )

    state, overtimed = rt.drive(run, itmax, timemax, start)
    niter = int(state.iter)
    code = rt.final_status_code(state.status, niter, itmax, overtimed)
    x = state.x
    if x0 is not None:
        x = x + x0
    stats = SimpleStats(
        niter=niter, solved=rt.is_solved_code(code), inconsistent=False,
        residuals=_trim(state.hist_r, niter, history),
        timer=time.perf_counter() - start,
        status=rt.decode_status(code, _STATUS),
    )
    return x, stats, state


def qmr(A, b, x0=None, *, precision=None, **kwargs):
    """x, stats = qmr(A, b; c=b, ...).

    ``precision="double_word"`` raises NotImplementedError until the
    iterative refinement (solvers/_refine.py, ROADMAP.md Queue 1 item 8)
    is ported."""
    _no_double_word("QMR", precision)
    x, stats, _ = _qmr_solve(A, b, x0, **kwargs)
    return x, stats


# ---------------------------------------------------------------------------
# BiLQR — Ax = b (BiLQ) and Aᴴy = c (QMR-style dual) simultaneously.
# ---------------------------------------------------------------------------

class BilqrState(NamedTuple):
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
    norm_vk: torch.Tensor
    tau: torch.Tensor
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
    breakdown: torch.Tensor
    iter: torch.Tensor
    status: torch.Tensor
    hist_r: torch.Tensor
    hist_s: torch.Tensor


def _bilqr_core(
    A, b, c, x0, y0, state_in, iter_cap, steps, atol, rtol,
    *, transfer_to_bicg, history, hist_len, callback, verbose,
):
    """``steps`` BiLQR iterations from ``state_in`` (None: start), each
    with its updates masked by ``status == RUNNING and iter < iter_cap``;
    the state returned has x at the BiCG point once that point solved
    the primal system (krylov_tpu/solvers/bilq.py:797-801)."""
    FC = b.dtype
    T = real_dtype(FC)
    dev = b.device
    eps_T = torch.finfo(T).eps

    def flag(v=False):
        return torch.full((), v, dtype=torch.bool, device=dev)

    if state_in is None:
        s0 = c if y0 is None else c - A.rmatvec(y0)
        bNorm, cHb, beta, gamma, vk, uk, epsL = _start(A, b, s0, x0, atol,
                                                       rtol)
        cNorm = knorm(s0)
        epsQ = torch.tensor(atol, dtype=T, device=dev) \
            + torch.tensor(rtol, dtype=T, device=dev) * cNorm
        solved_primal0 = bNorm == 0
        solved_dual0 = cNorm == 0
        status = torch.where(
            cHb == 0, BC_BREAKDOWN, torch.where(
                solved_primal0 & solved_dual0, rt.ZERO_RESIDUAL,
                rt.RUNNING)).to(torch.int32)
        zc = torch.zeros((), dtype=FC, device=dev)
        hr = rt.hist_write(rt.hist_init(hist_len, T, dev), _i32(0, dev),
                           bNorm, history)
        hs = rt.hist_write(rt.hist_init(hist_len, T, dev), _i32(0, dev),
                           cNorm, history)
        state_in = BilqrState(
            x=torch.zeros_like(b), y=torch.zeros_like(b), vk=vk,
            vkm1=torch.zeros_like(b), uk=uk, ukm1=torch.zeros_like(b),
            dbar_vec=torch.zeros_like(b), w_km3=torch.zeros_like(b),
            w_km2=torch.zeros_like(b), beta=beta, gamma=gamma,
            c_km1=-torch.ones((), dtype=T, device=dev), s_km1=zc,
            dbar_km1=zc, zeta_km1=zc, zeta_km2=zc, eta_km1=zc, zetabar=zc,
            psibar_km1=zc, eps_km3=zc, lam_km2=zc,
            norm_vk=bNorm / torch.abs(_safe(beta)),
            tau=torch.zeros((), dtype=T, device=dev), rNorm=bNorm,
            sNorm=cNorm, epsL=epsL, epsQ=epsQ, solved_primal=solved_primal0,
            solved_dual=solved_dual0, solved_lq_tol=flag(),
            solved_lq_mach=flag(), solved_cg_tol=flag(),
            solved_cg_mach=flag(), solved_qr_tol=flag(),
            solved_qr_mach=flag(), solved_cg_flag=flag(), breakdown=flag(),
            iter=_i32(0, dev), status=status, hist_r=hr, hist_s=hs)

    def body(s):
        active = (s.status == rt.RUNNING) & (s.iter < iter_cap)
        it = s.iter + 1
        zc = torch.zeros((), dtype=FC, device=dev)
        q, p, alpha, pHq, beta_kp1, gamma_kp1 = _bi_lanczos_step(
            A, s.vk, s.uk, s.vkm1, s.ukm1, s.beta, s.gamma, FC)
        ck, sk, d_km1, lam_km1, eps_km2, dbar_k = _lq_step(s, it, alpha, FC,
                                                           T)
        # primal block (skipped once solved)
        pm = ~s.solved_primal
        zeta_km1 = torch.where(pm & (it >= 2), s.eta_km1 / _safe(d_km1),
                               s.zeta_km1)
        zeta_km2 = torch.where(pm & (it >= 3), s.zeta_km1, s.zeta_km2)
        eta_k = torch.where(pm, torch.where(it == 1, s.beta, torch.where(
            it == 2, -lam_km1 * zeta_km1,
            -eps_km2 * zeta_km2 - lam_km1 * zeta_km1)), s.eta_km1)
        x_new = torch.where(
            pm & (it >= 2), s.x + (zeta_km1 * ck).to(FC) * s.dbar_vec
            + (zeta_km1 * sk).to(FC) * s.vk, s.x)
        dbar_vec = torch.where(pm, torch.where(
            it == 1, s.vk, torch.conj(sk) * s.dbar_vec - ck.to(FC) * s.vk),
            s.dbar_vec)
        # dual block (uses the *old* uₖ₋₁/uₖ buffers)
        dm = ~s.solved_dual
        psi_km1 = torch.where(it == 1, zc, ck.to(FC) * s.psibar_km1)
        psibar_k = torch.where(it == 1, torch.conj(s.gamma),
                               sk * s.psibar_km1)
        dc = _safe(torch.conj(d_km1))
        w2 = s.ukm1 / dc
        w3 = (s.ukm1 - torch.conj(s.lam_km2) * s.w_km2) / dc
        w4 = (s.ukm1 - torch.conj(s.lam_km2) * s.w_km2
              - torch.conj(s.eps_km3) * s.w_km3) / dc
        w_km1 = torch.where(it == 2, w2, torch.where(it == 3, w3, w4))
        y_new = torch.where(dm & (it >= 2), s.y + psi_km1 * w_km1, s.y)
        tau = torch.where(dm, s.tau + kdotr(s.uk, s.uk), s.tau)
        sNorm = torch.where(dm, torch.abs(psibar_k) * torch.sqrt(tau),
                            s.sNorm)
        # advance the Lanczos vectors
        nz = pHq != 0
        vk_new = torch.where(nz, q / _safe(beta_kp1).to(FC), s.vk)
        uk_new = torch.where(nz, p / _safe(torch.conj(gamma_kp1)), s.uk)
        vHv = kdot(s.vk, vk_new)
        norm_vkp1 = knorm(vk_new)
        rNorm_lq = _lq_residual(s, it, alpha, ck, sk, zeta_km1, zeta_km2,
                                beta_kp1, vHv, norm_vkp1, FC)
        rNorm_lq = torch.where(pm, rNorm_lq, s.rNorm)
        dbar_ok = torch.abs(dbar_k) > eps_T
        zetabar = torch.where(pm & dbar_ok, eta_k / _safe(dbar_k), s.zetabar)
        rho = beta_kp1.to(FC) * (sk * zeta_km1 - ck * zetabar)
        rNorm_cg = torch.abs(rho) * norm_vkp1
        tr = bool(transfer_to_bicg)
        solved_lq_tol = torch.where(pm, rNorm_lq <= s.epsL, s.solved_lq_tol)
        solved_lq_mach = torch.where(pm, (rNorm_lq + 1.0) <= 1.0,
                                     s.solved_lq_mach)
        solved_cg_tol = torch.where(pm, tr & dbar_ok & (rNorm_cg <= s.epsL),
                                    s.solved_cg_tol)
        solved_cg_mach = torch.where(
            pm, tr & dbar_ok & ((rNorm_cg + 1.0) <= 1.0), s.solved_cg_mach)
        solved_lq = solved_lq_tol | solved_lq_mach
        solved_cg = solved_cg_tol | solved_cg_mach
        solved_primal = s.solved_primal | solved_lq | solved_cg
        solved_qr_tol = torch.where(dm, sNorm <= s.epsQ, s.solved_qr_tol)
        solved_qr_mach = torch.where(dm, (sNorm + 1.0) <= 1.0,
                                     s.solved_qr_mach)
        solved_dual = s.solved_dual | solved_qr_tol | solved_qr_mach
        breakdown = ~solved_lq & ~solved_cg & (pHq == 0)
        code = torch.where(breakdown, UV_BREAKDOWN, torch.where(
            solved_primal & solved_dual, rt.SOLVED_PRIMAL_DUAL,
            rt.RUNNING)).to(torch.int32)
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
            beta=beta_kp1.to(FC), gamma=gamma_kp1, c_km1=ck, s_km1=sk,
            dbar_km1=dbar_k, zeta_km1=zeta_km1, zeta_km2=zeta_km2,
            eta_km1=eta_k, zetabar=zetabar, psibar_km1=psibar_k,
            eps_km3=torch.where(it >= 3, eps_km2, s.eps_km3),
            lam_km2=torch.where(it >= 2, lam_km1, s.lam_km2),
            norm_vk=norm_vkp1, tau=tau, rNorm=rNorm_lq, sNorm=sNorm,
            solved_primal=solved_primal, solved_dual=solved_dual,
            solved_lq_tol=solved_lq_tol, solved_lq_mach=solved_lq_mach,
            solved_cg_tol=solved_cg_tol, solved_cg_mach=solved_cg_mach,
            solved_qr_tol=solved_qr_tol, solved_qr_mach=solved_qr_mach,
            solved_cg_flag=s.solved_cg_flag
            | (solved_cg & ~s.solved_primal & ~solved_lq),
            breakdown=breakdown, iter=it, status=code)
        if verbose > 0 and bool(active):
            rt.debug_row(verbose, it, "{:5d}  {:7.1e}  {:7.1e}", rNorm_lq,
                         sNorm)
        if callback is not None:
            s_new = _exit(callback, s_new, dev)
        return _masked(BilqrState._fields, active, s_new, s,
                       keep=("hist_r", "hist_s"))

    s = rt.take_steps(body, state_in, steps, iter_cap, callback)
    return s._replace(x=torch.where(s.solved_cg_flag,
                                    s.x + s.zetabar * s.dbar_vec, s.x))


def _bilqr_status(state, code):
    """The status string from the flags (reference src/bilqr.jl:453-467,
    krylov_tpu/solvers/bilq.py:804-845); ``state`` has the flag
    attributes (tensors or bools)."""
    if code in (rt.TIRED, rt.OVERTIMED, rt.USER_EXIT, BC_BREAKDOWN,
                rt.ZERO_RESIDUAL):
        return rt.decode_status(code, _STATUS)
    if bool(state.breakdown):
        return _STATUS[UV_BREAKDOWN]
    lq_t, lq_m = bool(state.solved_lq_tol), bool(state.solved_lq_mach)
    cg_t, cg_m = bool(state.solved_cg_tol), bool(state.solved_cg_mach)
    qr_t, qr_m = bool(state.solved_qr_tol), bool(state.solved_qr_mach)
    sp, sd = bool(state.solved_primal), bool(state.solved_dual)
    # reference src/bilqr.jl:453-467 precedence chain (later wins)
    status = "unknown"
    if lq_t and not sd:
        status = "Only the primal solution xᴸ is good enough given atol and rtol"
    if cg_t and not sd:
        status = "Only the primal solution xᶜ is good enough given atol and rtol"
    if (not sp) and qr_t:
        status = "Only the dual solution t is good enough given atol and rtol"
    if lq_t and qr_t:
        status = "Both primal and dual solutions (xᴸ, t) are good enough given atol and rtol"
    if cg_t and qr_t:
        status = "Both primal and dual solutions (xᶜ, t) are good enough given atol and rtol"
    if lq_m and not sd:
        status = "Only found approximate zero-residual primal solution xᴸ"
    if cg_m and not sd:
        status = "Only found approximate zero-residual primal solution xᶜ"
    if (not sp) and qr_m:
        status = "Only found approximate zero-residual dual solution t"
    if lq_m and qr_m:
        status = "Found approximate zero-residual primal and dual solutions (xᴸ, t)"
    if cg_m and qr_m:
        status = "Found approximate zero-residual primal and dual solutions (xᶜ, t)"
    if lq_m and qr_t:
        status = "Found approximate zero-residual primal solutions xᴸ and a dual solution t good enough given atol and rtol"
    if cg_m and qr_t:
        status = "Found approximate zero-residual primal solutions xᶜ and a dual solution t good enough given atol and rtol"
    if lq_t and qr_m:
        status = "Found a primal solution xᴸ good enough given atol and rtol and an approximate zero-residual dual solutions t"
    if cg_t and qr_m:
        status = "Found a primal solution xᶜ good enough given atol and rtol and an approximate zero-residual dual solutions t"
    return status


class _Flags(NamedTuple):
    """The nine flags of the BiLQR kernel, under the state's names."""
    solved_lq_tol: bool
    solved_lq_mach: bool
    solved_cg_tol: bool
    solved_cg_mach: bool
    solved_qr_tol: bool
    solved_qr_mach: bool
    solved_primal: bool
    solved_dual: bool
    breakdown: bool


def _bilqr_solve(
    A, b, c, x0=None, y0=None, *, transfer_to_bicg=True, atol=None,
    rtol=None, itmax=0, timemax=float("inf"), verbose=0, history=False,
    callback=None,
):
    start = time.perf_counter()
    A, b, x0, _ = solve_inputs(A, b, x0)
    A = _with_adjoint(A)
    c = rt.as_device_tensor(c, b).to(b.dtype)
    if y0 is not None:
        y0 = rt.as_device_tensor(y0, b).to(b.dtype)
    n = b.shape[0]
    if A.shape is not None and A.shape[0] != A.shape[1]:
        raise ValueError("Systems must be square")
    T = real_dtype(b.dtype)
    atol = rt.default_tol(atol, T)
    rtol = rt.default_tol(rtol, T)
    itmax = rt.resolve_itmax(itmax, 2 * n)
    rt.debug_table(verbose, "BILQR", ("k", "‖rₖ‖", "‖sₖ‖"), n)
    hist_len = itmax + 1 if history else 0

    # Fast path: square DIA stencil + default config → whole-solve kernel.
    if (x0 is None and y0 is None and not history and callback is None
            and verbose == 0 and timemax == float("inf")
            and _fused_ready(A, n, b.dtype, bilqr_dia_fused_supported)):
        pd_adj, ot_adj = A.aligned_adjoint_kernel_args()
        x, y, niter, _, _, code_d, flags = bilqr_dia_fused(
            A._pd, pd_adj, A._offsets, ot_adj, b.contiguous(),
            c.contiguous(), atol, rtol, itmax,
            transfer_to_bicg=bool(transfer_to_bicg))
        niter, code, *fl = torch.cat([niter.reshape(1), code_d.reshape(1),
                                      flags]).tolist()
        code = rt.final_status_code(code, niter, itmax, False)
        flags = _Flags(*(bool(v) for v in fl))
        stats = AdjointStats(
            niter=niter,
            solved_primal=flags.solved_primal,
            solved_dual=flags.solved_dual,
            residuals_primal=np.zeros(0),
            residuals_dual=np.zeros(0),
            timer=time.perf_counter() - start,
            status=_bilqr_status(flags, code),
        )
        return x, y, stats, None

    def run(state, cap, steps):
        return _bilqr_core(
            A, b, c, x0, y0, state, cap, steps, atol, rtol,
            transfer_to_bicg=bool(transfer_to_bicg), history=bool(history),
            hist_len=hist_len, callback=callback, verbose=int(verbose),
        )

    state, overtimed = rt.drive(run, itmax, timemax, start)
    niter = int(state.iter)
    code = rt.final_status_code(state.status, niter, itmax, overtimed)
    x, y = state.x, state.y
    if x0 is not None:
        x = x + x0
    if y0 is not None:
        y = y + y0

    stats = AdjointStats(
        niter=niter,
        solved_primal=bool(state.solved_primal),
        solved_dual=bool(state.solved_dual),
        residuals_primal=_nan_trim(state.hist_r, niter, history),
        residuals_dual=_nan_trim(state.hist_s, niter, history),
        timer=time.perf_counter() - start,
        status=_bilqr_status(state, code),
    )
    return x, y, stats, state


def bilqr(A, b, c, x0=None, y0=None, *, precision=None, **kwargs):
    """x, y, stats = bilqr(A, b, c) — solves Ax = b and Aᴴy = c.

    ``precision="double_word"`` raises NotImplementedError until the
    iterative refinement (solvers/_refine.py, ROADMAP.md Queue 1 item 8)
    is ported."""
    _no_double_word("BILQR", precision)
    x, y, stats, _ = _bilqr_solve(A, b, c, x0, y0, **kwargs)
    return x, y, stats
