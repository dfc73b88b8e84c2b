"""TriCG and TriMR for symmetric quasi-definite systems
[τE A; Aᴴ νF][x; y] = [b; c].

Counterpart of ``krylov_tpu/solvers/tricg.py`` and of reference
src/tricg.jl and src/trimr.jl: the orthogonal Saunders–Simon–Yip
tridiagonalisation, then for TriCG the LDLᴴ factorisation of the
block-tridiagonal Sₖ.ₖ and the odd and even direction recurrences, for
TriMR the QR factorisation of Sₖ₊₁.ₖ by a cascade of four reflections per
iteration and four-deep direction recurrences; the presets spd (τ = 1,
ν = 1), snd (τ = −1, ν = −1), flip (τ = −1, ν = 1) and sp (τ = 1, ν = 0);
M and N (centred preconditioning, applied or divided by); a warm start
(x0, y0).  A may be rectangular or complex.  A square DIA operator on
the card with a real b, no M, N or warm start and the default options
goes to a whole-solve kernel (ops/cuda_fused.py) on Aᴴ's aligned
diagonals; every other configuration runs the general core, whose
iterations ``_runtime.drive`` takes in chunks with masked updates.
"""

import time
from typing import NamedTuple

import numpy as np
import torch

from .. import _runtime as rt
from .._dtypes import real_dtype
from ..operators import as_operator, precond_apply
from ..ops.cuda_fused import (INCONS_TRI, tricg_dia_fused,
                              tricg_dia_fused_supported, trimr_dia_fused,
                              trimr_dia_fused_supported)
from ..ops.kops import kdot, sym_givens
from ..stats import SimpleStats
from .bilq import _exit, _safe
from .cr import _fused_ready, _i32, _masked, _no_double_word, _trim
from .usymlq import _inputs, _tol

_STATUS = {INCONS_TRI: "inconsistent linear system"}


def _resolve_tau_nu(tau, nu, spd, snd, flip, sp):
    """(τ, ν) of a preset, else the caller's (krylov_tpu/solvers/
    tricg.py:32-41)."""
    if spd:
        return 1.0, 1.0
    if snd:
        return -1.0, -1.0
    if flip:
        return -1.0, 1.0
    if sp:
        return 1.0, 0.0
    return tau, nu


class TricgState(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    Minv_vk: torch.Tensor
    Minv_vkm1: torch.Tensor
    Ninv_uk: torch.Tensor
    Ninv_ukm1: torch.Tensor
    vk: torch.Tensor
    uk: torch.Tensor
    gx_odd: torch.Tensor      # gx₂ₖ₋₁
    gx_even: torch.Tensor     # gx₂ₖ
    gy_odd: torch.Tensor
    gy_even: torch.Tensor
    beta: torch.Tensor
    gamma: torch.Tensor
    d_m3: torch.Tensor        # d₂ₖ₋₃
    d_m2: torch.Tensor        # d₂ₖ₋₂
    pi_m3: torch.Tensor
    pi_m2: torch.Tensor
    delta_km1: torch.Tensor
    rNorm: torch.Tensor
    eps_lim: torch.Tensor
    iter: torch.Tensor
    status: torch.Tensor
    hist_r: torch.Tensor


def _normalised(w, Mw, MisI, FC):
    """(√⟨w, Mw⟩, w/norm, Mw/norm): each 0 where the norm is 0."""
    norm = torch.sqrt(torch.clamp(kdot(Mw, w).real, min=0))
    nz = norm != 0
    w = torch.where(nz, w / _safe(norm).to(FC), torch.zeros_like(w))
    Mw = w if MisI else torch.where(nz, Mw / _safe(norm).to(FC),
                                    torch.zeros_like(Mw))
    return norm, w, Mw


def _tricg_core(
    A, M, N, b, c, x0, y0, state_in, iter_cap, steps, atol, rtol, tau, nu,
    *, ldiv, history, hist_len, callback, verbose, MisI, NisI,
):
    """``steps`` TriCG iterations from ``state_in`` (None: start), each
    with its updates masked by ``status == RUNNING and iter < iter_cap``
    (krylov_tpu/solvers/tricg.py:75-269).  A warm start folds (x0, y0)
    into the right-hand sides; the caller adds it back."""
    FC = b.dtype
    T = real_dtype(FC)
    dev = b.device
    tau = _tol(tau, T, dev)
    nu = _tol(nu, T, dev)
    btol = _tol(torch.finfo(T).eps ** 0.75, T, dev)

    def M_apply(t):
        return precond_apply(M, t, ldiv)

    def N_apply(t):
        return precond_apply(N, t, ldiv)

    if state_in is None:
        if x0 is None:
            b0, c0 = b, c
        else:
            b0 = b - A.matvec(y0) - tau.to(FC) * x0
            c0 = c - A.rmatvec(x0) - nu.to(FC) * y0
        beta, Minv_v, vk = _normalised(b0, M_apply(b0), MisI, FC)
        gamma, Ninv_u, uk = _normalised(c0, N_apply(c0), NisI, FC)
        rNorm = torch.sqrt(gamma * gamma + beta * beta)
        eps_lim = _tol(atol, T, dev) + _tol(rtol, T, dev) * rNorm
        status = torch.where(rNorm == 0, rt.ZERO_RESIDUAL, torch.where(
            rNorm <= eps_lim, rt.SOLVED, rt.RUNNING)).to(torch.int32)
        zc = torch.zeros((), dtype=FC, device=dev)
        zr = torch.zeros((), dtype=T, device=dev)
        zm, zn = torch.zeros_like(b0), torch.zeros_like(c0)
        state_in = TricgState(
            x=zm, y=zn, Minv_vk=Minv_v, Minv_vkm1=zm, Ninv_uk=Ninv_u,
            Ninv_ukm1=zn, vk=vk, uk=uk, gx_odd=zm, gx_even=zm, gy_odd=zn,
            gy_even=zn, beta=beta, gamma=gamma, d_m3=zr, d_m2=zr, pi_m3=zc,
            pi_m2=zc, delta_km1=zc, rNorm=rNorm, eps_lim=eps_lim,
            iter=_i32(0, dev), status=status,
            hist_r=rt.hist_write(rt.hist_init(hist_len, T, dev),
                                 _i32(0, dev), rNorm, history))

    def body(s):
        active = (s.status == rt.RUNNING) & (s.iter < iter_cap)
        it = s.iter + 1
        is1 = it == 1
        q = A.matvec(s.uk)
        p = A.rmatvec(s.vk)
        q = torch.where(it >= 2, q - s.gamma.to(FC) * s.Minv_vkm1, q)
        p = torch.where(it >= 2, p - s.beta.to(FC) * s.Ninv_ukm1, p)
        alpha = kdot(s.vk, q)
        q = q - alpha * s.Minv_vk
        p = p - torch.conj(alpha) * s.Ninv_uk

        # the LDLᴴ of Sₖ.ₖ (reference :331-349)
        d_m2, d_m3 = _safe(s.d_m2).to(FC), _safe(s.d_m3).to(FC)
        delta1 = torch.conj(alpha) / _safe(tau).to(FC)
        d_even1 = nu - torch.abs(delta1) ** 2 * tau
        sigma = s.beta.to(FC) / d_m2
        eta = s.gamma.to(FC) / d_m3
        lam = -(eta * torch.conj(s.delta_km1) * s.d_m3) / d_m2
        d_oddk = tau - torch.abs(sigma) ** 2 * s.d_m2
        deltak = (torch.conj(alpha) - lam * torch.conj(sigma) * s.d_m2) \
            / _safe(d_oddk).to(FC)
        d_evenk = nu - torch.abs(eta) ** 2 * s.d_m3 \
            - torch.abs(lam) ** 2 * s.d_m2 - torch.abs(deltak) ** 2 * d_oddk
        d_odd = torch.where(is1, tau, d_oddk)
        delta = torch.where(is1, delta1, deltak)
        d_even = torch.where(is1, d_even1, d_evenk)

        # LₖDₖπₖ = β₁e₁ + γ₁e₂ (reference :351-372)
        s_odd, s_even = _safe(d_odd).to(FC), _safe(d_even).to(FC)
        pi_oddk = -(sigma * s.d_m2 * s.pi_m2) / s_odd
        pi_odd = torch.where(is1, s.beta.to(FC) / s_odd, pi_oddk)
        pi_even = torch.where(
            is1, (s.gamma.to(FC) - delta * s.beta.to(FC)) / s_even,
            -(delta * d_odd * pi_oddk + lam * s.d_m2 * s.pi_m2
              + eta * s.d_m3 * s.pi_m3) / s_even)

        # the directions (reference :374-410), after the reference's swap
        gx_evenk = s.vk - torch.conj(sigma) * s.gx_even
        gy_evenk = -torch.conj(sigma) * s.gy_even
        gx_oddk = -(torch.conj(eta) * s.gx_odd + torch.conj(lam) * s.gx_even) \
            - torch.conj(delta) * gx_evenk
        gy_oddk = s.uk - (torch.conj(eta) * s.gy_odd
                          + torch.conj(lam) * s.gy_even) \
            - torch.conj(delta) * gy_evenk
        gx_odd = torch.where(is1, s.vk, gx_evenk)
        gx_even = torch.where(is1, -torch.conj(delta) * s.vk, gx_oddk)
        gy_odd = torch.where(is1, torch.zeros_like(s.uk), gy_evenk)
        gy_even = torch.where(is1, s.uk, gy_oddk)
        x = s.x + pi_odd * gx_odd + pi_even * gx_even
        y = s.y + pi_odd * gy_odd + pi_even * gy_even

        # the next basis vectors, left un-normalised at a norm ≤ eps^¾
        vkp1, ukp1 = M_apply(q), N_apply(p)
        beta_kp1 = torch.sqrt(torch.clamp(kdot(vkp1, q).real, min=0))
        gamma_kp1 = torch.sqrt(torch.clamp(kdot(ukp1, p).real, min=0))
        bok, gok = beta_kp1 > btol, gamma_kp1 > btol
        sb, sg = _safe(beta_kp1).to(FC), _safe(gamma_kp1).to(FC)
        q = torch.where(bok, q / sb, q)
        vkp1 = q if MisI else torch.where(bok, vkp1 / sb, vkp1)
        p = torch.where(gok, p / sg, p)
        ukp1 = p if NisI else torch.where(gok, ukp1 / sg, ukp1)

        zeta_odd = pi_odd - torch.conj(delta) * pi_even
        rNorm = torch.sqrt(torch.abs(gamma_kp1 * zeta_odd) ** 2
                           + torch.abs(beta_kp1 * pi_even) ** 2)
        solved = (rNorm <= s.eps_lim) | ((rNorm + 1.0) <= 1.0)
        code = torch.where(solved, rt.SOLVED, torch.where(
            (beta_kp1 <= btol) & (gamma_kp1 <= btol), INCONS_TRI,
            rt.RUNNING)).to(torch.int32)
        rt.hist_write_masked(s.hist_r, active, it, rNorm, history)
        s_new = s._replace(
            x=x, y=y, Minv_vk=q, Minv_vkm1=s.Minv_vk, Ninv_uk=p,
            Ninv_ukm1=s.Ninv_uk, vk=vkp1, uk=ukp1, gx_odd=gx_odd,
            gx_even=gx_even, gy_odd=gy_odd, gy_even=gy_even, beta=beta_kp1,
            gamma=gamma_kp1, d_m3=d_odd, d_m2=d_even, pi_m3=pi_odd,
            pi_m2=pi_even, delta_km1=delta, rNorm=rNorm, iter=it,
            status=code)
        if verbose > 0 and bool(active):
            rt.debug_row(verbose, it, "{:5d}  {:7.1e}  {:7.1e}  {:7.1e}",
                         rNorm, beta_kp1, gamma_kp1)
        if callback is not None:
            s_new = _exit(callback, s_new, dev)
        return _masked(TricgState._fields, active, s_new, s)

    return rt.take_steps(body, state_in, steps, iter_cap, callback)


def _tri_solve(
    name, A, b, c, x0=None, y0=None, *, M=None, N=None, ldiv=False,
    spd=False, snd=False, flip=False, sp=False, tau=1.0, nu=-1.0,
    atol=None, rtol=None, itmax=0, timemax=float("inf"), verbose=0,
    history=False, callback=None,
):
    """Solves [τE A; Aᴴ νF][x; y] = [b; c] by TriCG or TriMR (``name``);
    a warm start needs x0 and y0, and, as in the JAX package, y0 without
    x0 is not used (krylov_tpu/solvers/tricg.py:92-96, 346-348,
    437-442)."""
    start = time.perf_counter()
    core, fused, supported = _METHODS[name]
    A, b, c, x0, y0, m, n = _inputs(A, b, c, x0, y0)
    if x0 is not None and y0 is None:
        raise ValueError(f"a warm start of {name} needs x0 and y0")
    if b.shape[0] != m or c.shape[0] != n:
        raise ValueError("Inconsistent problem size")
    M = as_operator(M, device=b.device)
    N = as_operator(N, device=b.device)
    tau, nu = _resolve_tau_nu(tau, nu, spd, snd, flip, sp)
    T = real_dtype(b.dtype)
    atol = rt.default_tol(atol, T)
    rtol = rt.default_tol(rtol, T)
    itmax = rt.resolve_itmax(itmax, m + n)
    rt.debug_table(verbose, name.upper(), ("k", "‖rₖ‖", "βₖ₊₁", "γₖ₊₁"),
                   m, n)
    hist_len = itmax + 1 if history else 0

    # Fast path: square DIA stencil + default config → whole-solve kernel.
    if (M is None and N is None and x0 is None and y0 is None
            and not history and callback is None and verbose == 0
            and timemax == float("inf") and m == n
            and _fused_ready(A, n, b.dtype, supported)):
        pd_adj, ot_adj = A.aligned_adjoint_kernel_args()
        x, y, niter, _, code_d = fused(
            A._pd, pd_adj, A._offsets, ot_adj, b.contiguous(),
            c.contiguous(), float(tau), float(nu), atol, rtol, itmax)
        niter, code = torch.stack([niter, code_d]).tolist()
        code = rt.final_status_code(code, niter, itmax, False)
        stats = SimpleStats(
            niter=niter, solved=rt.is_solved_code(code),
            inconsistent=code == INCONS_TRI, residuals=np.zeros(0),
            timer=time.perf_counter() - start,
            status=rt.decode_status(code, _STATUS))
        return x, y, stats, None

    def run(state, cap, steps):
        return core(
            A, M, N, b, c, x0, y0, state, cap, steps, atol, rtol, float(tau),
            float(nu), ldiv=bool(ldiv), history=bool(history),
            hist_len=hist_len, callback=callback, verbose=int(verbose),
            MisI=M is None, NisI=N is None)

    state, overtimed = rt.drive(run, itmax, timemax, start)
    niter = int(state.iter)
    code = rt.final_status_code(state.status, niter, itmax, overtimed)
    x, y = state.x, state.y
    if x0 is not None:
        x, y = x + x0, y + y0
    stats = SimpleStats(
        niter=niter, solved=rt.is_solved_code(code),
        inconsistent=code == INCONS_TRI,
        residuals=_trim(state.hist_r, niter, history),
        timer=time.perf_counter() - start,
        status=rt.decode_status(code, _STATUS))
    return x, y, stats, state


def _tricg_solve(A, b, c, x0=None, y0=None, **kwargs):
    return _tri_solve("TriCG", A, b, c, x0, y0, **kwargs)


def tricg(A, b, c, x0=None, y0=None, *, precision=None, **kwargs):
    """x, y, stats = tricg(A, b, c; spd/snd/flip/sp, τ, ν, M, N, ...).

    ``precision="double_word"`` raises NotImplementedError until the
    iterative refinement (solvers/_refine.py, ROADMAP.md Queue 1 item 8)
    is ported."""
    _no_double_word("TRICG", precision)
    x, y, stats, _ = _tricg_solve(A, b, c, x0, y0, **kwargs)
    return x, y, stats


# ---------------------------------------------------------------------------
# TriMR: the QR of Sₖ₊₁.ₖ with a cascade of four reflections per iteration
# ---------------------------------------------------------------------------

class TrimrState(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    Minv_vk: torch.Tensor
    Minv_vkm1: torch.Tensor
    Ninv_uk: torch.Tensor
    Ninv_ukm1: torch.Tensor
    vk: torch.Tensor
    uk: torch.Tensor
    gx: torch.Tensor          # (4, m): [gx₂ₖ₋₃ gx₂ₖ₋₂ gx₂ₖ₋₁ gx₂ₖ]
    gy: torch.Tensor          # (4, n)
    beta: torch.Tensor
    gamma: torch.Tensor
    # the four reflections of iteration k − 1
    oc1: torch.Tensor
    os1: torch.Tensor
    oc2: torch.Tensor
    os2: torch.Tensor
    oc3: torch.Tensor
    os3: torch.Tensor
    oc4: torch.Tensor
    os4: torch.Tensor
    sbar_m2: torch.Tensor     # σbar₂ₖ₋₂
    ebar_m3: torch.Tensor     # ηbar₂ₖ₋₃
    lbar_m3: torch.Tensor     # λbar₂ₖ₋₃
    mu_m5: torch.Tensor
    mu_m4: torch.Tensor
    lam_m4: torch.Tensor
    pibar_odd: torch.Tensor
    pibar_even: torch.Tensor
    rNorm: torch.Tensor
    eps_lim: torch.Tensor
    iter: torch.Tensor
    status: torch.Tensor
    hist_r: torch.Tensor


def _trimr_core(
    A, M, N, b, c, x0, y0, state_in, iter_cap, steps, atol, rtol, tau, nu,
    *, ldiv, history, hist_len, callback, verbose, MisI, NisI,
):
    """``steps`` TriMR iterations from ``state_in`` (None: start), each
    with its updates masked by ``status == RUNNING and iter < iter_cap``
    (krylov_tpu/solvers/tricg.py:416-657).  A warm start folds (x0, y0)
    into the right-hand sides; the caller adds it back."""
    m, n = b.shape[0], c.shape[0]
    FC = b.dtype
    T = real_dtype(FC)
    dev = b.device
    tau_c = _tol(tau, T, dev).to(FC)
    nu_c = _tol(nu, T, dev).to(FC)
    btol = _tol(torch.finfo(T).eps ** 0.75, T, dev)

    def M_apply(t):
        return precond_apply(M, t, ldiv)

    def N_apply(t):
        return precond_apply(N, t, ldiv)

    if state_in is None:
        if x0 is None:
            b0, c0 = b, c
        else:
            b0 = b - A.matvec(y0) - tau_c * x0
            c0 = c - A.rmatvec(x0) - nu_c * y0
        beta, Minv_v, vk = _normalised(b0, M_apply(b0), MisI, FC)
        gamma, Ninv_u, uk = _normalised(c0, N_apply(c0), NisI, FC)
        rNorm = torch.sqrt(gamma * gamma + beta * beta)
        eps_lim = _tol(atol, T, dev) + _tol(rtol, T, dev) * rNorm
        status = torch.where(rNorm == 0, rt.ZERO_RESIDUAL, torch.where(
            rNorm <= eps_lim, rt.SOLVED, rt.RUNNING)).to(torch.int32)
        zc = torch.zeros((), dtype=FC, device=dev)
        zr = torch.zeros((), dtype=T, device=dev)
        state_in = TrimrState(
            x=torch.zeros(m, dtype=FC, device=dev),
            y=torch.zeros(n, dtype=FC, device=dev), Minv_vk=Minv_v,
            Minv_vkm1=torch.zeros(m, dtype=FC, device=dev), Ninv_uk=Ninv_u,
            Ninv_ukm1=torch.zeros(n, dtype=FC, device=dev), vk=vk, uk=uk,
            gx=torch.zeros((4, m), dtype=FC, device=dev),
            gy=torch.zeros((4, n), dtype=FC, device=dev), beta=beta,
            gamma=gamma, oc1=zr, os1=zc, oc2=zr, os2=zc, oc3=zr, os3=zc,
            oc4=zr, os4=zc, sbar_m2=zc, ebar_m3=zc, lbar_m3=zc, mu_m5=zc,
            mu_m4=zc, lam_m4=zc, pibar_odd=beta.to(FC),
            pibar_even=gamma.to(FC), rNorm=rNorm, eps_lim=eps_lim,
            iter=_i32(0, dev), status=status,
            hist_r=rt.hist_write(rt.hist_init(hist_len, T, dev),
                                 _i32(0, dev), rNorm, history))

    def body(s):
        active = (s.status == rt.RUNNING) & (s.iter < iter_cap)
        it = s.iter + 1
        first = it == 1
        q = A.matvec(s.uk)
        p = A.rmatvec(s.vk)
        q = torch.where(it >= 2, q - s.gamma.to(FC) * s.Minv_vkm1, q)
        p = torch.where(it >= 2, p - s.beta.to(FC) * s.Ninv_ukm1, p)
        alpha = kdot(s.vk, q)
        q = q - alpha * s.Minv_vk
        p = p - torch.conj(alpha) * s.Ninv_uk

        vkp1, ukp1 = M_apply(q), N_apply(p)
        beta_kp1 = torch.sqrt(torch.clamp(kdot(vkp1, q).real, min=0))
        gamma_kp1 = torch.sqrt(torch.clamp(kdot(ukp1, p).real, min=0))
        bok, gok = beta_kp1 > btol, gamma_kp1 > btol
        sb, sg = _safe(beta_kp1).to(FC), _safe(gamma_kp1).to(FC)
        q = torch.where(bok, q / sb, q)
        vkp1 = q if MisI else torch.where(bok, vkp1 / sb, vkp1)
        p = torch.where(gok, p / sg, p)
        ukp1 = p if NisI else torch.where(gok, ukp1 / sg, ukp1)
        bc, gc = beta_kp1.to(FC), gamma_kp1.to(FC)
        cj = torch.conj
        oc1, oc2, oc3, oc4 = (v.to(FC) for v in (s.oc1, s.oc2, s.oc3,
                                                 s.oc4))

        # iter ≥ 2: the four previous reflections (reference :370-404)
        sbis_m2 = oc1 * s.sbar_m2 + s.os1 * cj(alpha)
        ebis_m2 = s.os1 * nu_c
        lbis_m2 = s.os1 * bc
        thbis = cj(s.os1) * s.sbar_m2 - oc1 * cj(alpha)
        dbis_even = -oc1 * nu_c
        sbis_even = -oc1 * bc

        e_m3 = oc2 * s.ebar_m3 + s.os2 * sbis_m2
        l_m3 = oc2 * s.lbar_m3 + s.os2 * ebis_m2
        mu_m3 = s.os2 * lbis_m2
        shat_m2 = cj(s.os2) * s.ebar_m3 - oc2 * sbis_m2
        ehat_m2 = cj(s.os2) * s.lbar_m3 - oc2 * ebis_m2
        lhat_m2 = -oc2 * lbis_m2

        stmp_m2 = oc3 * shat_m2 + s.os3 * thbis
        etmp_m2 = oc3 * ehat_m2 + s.os3 * dbis_even
        ltmp_m2 = oc3 * lhat_m2 + s.os3 * sbis_even
        thetabar_k = cj(s.os3) * shat_m2 - oc3 * thbis
        dbar_even_k = cj(s.os3) * ehat_m2 - oc3 * dbis_even
        sbar_even_k = cj(s.os3) * lhat_m2 - oc3 * sbis_even

        s_m2 = oc4 * stmp_m2 + s.os4 * tau_c
        e_m2 = oc4 * etmp_m2 + s.os4 * alpha
        l_m2 = oc4 * ltmp_m2
        mu_m2 = s.os4 * gc
        dbar_odd_k = cj(s.os4) * stmp_m2 - oc4 * tau_c
        sbar_odd_k = cj(s.os4) * etmp_m2 - oc4 * alpha
        ebar_odd_k = cj(s.os4) * ltmp_m2
        lbar_odd_k = -oc4 * gc

        zc = torch.zeros((), dtype=FC, device=dev)
        thetabar = torch.where(first, cj(alpha), thetabar_k)
        dbar_odd = torch.where(first, tau_c, dbar_odd_k)
        dbar_even = torch.where(first, nu_c, dbar_even_k)
        sbar_odd = torch.where(first, alpha, sbar_odd_k)
        sbar_even = torch.where(first, bc, sbar_even_k)
        lbar_odd = torch.where(first, gc, lbar_odd_k)
        ebar_odd = torch.where(first, zc, ebar_odd_k)
        e_m3, l_m3, mu_m3, s_m2, e_m2, l_m2, mu_m2 = (
            torch.where(first, zc, v)
            for v in (e_m3, l_m3, mu_m3, s_m2, e_m2, l_m2, mu_m2))

        # the current cascade (reference :406-443)
        c1, s1, theta_k = sym_givens(thetabar, gc)
        g_k = cj(s1) * dbar_even
        dbar_even2 = c1.to(FC) * dbar_even
        c2, s2, d_odd = sym_givens(dbar_odd, theta_k)
        s_odd = c2.to(FC) * sbar_odd + s2 * dbar_even2
        dbis_even2 = cj(s2) * sbar_odd - c2.to(FC) * dbar_even2
        c3, s3, dhat_even = sym_givens(dbis_even2, g_k)
        c4, s4, d_even = sym_givens(dhat_even, bc)

        # the directions (reference :445-480): the rows of gx are
        # [g₂ₖ₋₃ g₂ₖ₋₂ g₂ₖ₋₁ g₂ₖ] of the last iteration
        sd_odd, sd_even = _safe(d_odd), _safe(d_even)
        gx, gy = s.gx, s.gy
        gx1_odd = s.vk / sd_odd
        gx1_even = (-s_odd * gx1_odd) / sd_even
        gy1_odd = torch.zeros_like(s.uk)
        gy1_even = s.uk / sd_even
        gx2_odd = (s.vk - e_m3 * gx[2] - s_m2 * gx[3]) / sd_odd
        gx2_even = (-l_m3 * gx[2] - e_m2 * gx[3] - s_odd * gx2_odd) / sd_even
        gy2_odd = (-e_m3 * gy[2] - s_m2 * gy[3]) / sd_odd
        gy2_even = (s.uk - l_m3 * gy[2] - e_m2 * gy[3]
                    - s_odd * gy2_odd) / sd_even
        gx3_odd = (s.vk - s.mu_m5 * gx[0] - s.lam_m4 * gx[1]
                   - e_m3 * gx[2] - s_m2 * gx[3]) / sd_odd
        gx3_even = (-s.mu_m4 * gx[1] - l_m3 * gx[2] - e_m2 * gx[3]
                    - s_odd * gx3_odd) / sd_even
        gy3_odd = (-s.mu_m5 * gy[0] - s.lam_m4 * gy[1]
                   - e_m3 * gy[2] - s_m2 * gy[3]) / sd_odd
        gy3_even = (s.uk - s.mu_m4 * gy[1] - l_m3 * gy[2] - e_m2 * gy[3]
                    - s_odd * gy3_odd) / sd_even
        two = it == 2
        gx_odd = torch.where(first, gx1_odd,
                             torch.where(two, gx2_odd, gx3_odd))
        gx_even = torch.where(first, gx1_even,
                              torch.where(two, gx2_even, gx3_even))
        gy_odd = torch.where(first, gy1_odd,
                             torch.where(two, gy2_odd, gy3_odd))
        gy_even = torch.where(first, gy1_even,
                              torch.where(two, gy2_even, gy3_even))

        # the π updates (reference :482-494)
        pibis_even = c1.to(FC) * s.pibar_even
        pibis_next_even = cj(s1) * s.pibar_even
        pi_odd = c2.to(FC) * s.pibar_odd + s2 * pibis_even
        pihat_even = cj(s2) * s.pibar_odd - c2.to(FC) * pibis_even
        pitmp = c3.to(FC) * pihat_even + s3 * pibis_next_even
        pibar_next_even = cj(s3) * pihat_even - c3.to(FC) * pibis_next_even
        pi_even = c4.to(FC) * pitmp
        pibar_next_odd = cj(s4) * pitmp

        rNorm = torch.sqrt(torch.abs(pibar_next_odd) ** 2
                           + torch.abs(pibar_next_even) ** 2)
        solved = (rNorm <= s.eps_lim) | ((rNorm + 1.0) <= 1.0)
        code = torch.where(solved, rt.SOLVED, torch.where(
            (beta_kp1 <= btol) & (gamma_kp1 <= btol), INCONS_TRI,
            rt.RUNNING)).to(torch.int32)
        rt.hist_write_masked(s.hist_r, active, it, rNorm, history)
        ge2 = it >= 2
        s_new = s._replace(
            x=s.x + pi_odd * gx_odd + pi_even * gx_even,
            y=s.y + pi_odd * gy_odd + pi_even * gy_even,
            Minv_vk=q, Minv_vkm1=s.Minv_vk, Ninv_uk=p, Ninv_ukm1=s.Ninv_uk,
            vk=vkp1, uk=ukp1,
            gx=torch.stack([gx[2], gx[3], gx_odd, gx_even]),
            gy=torch.stack([gy[2], gy[3], gy_odd, gy_even]),
            beta=beta_kp1, gamma=gamma_kp1, oc1=c1.real.to(T), os1=s1.to(FC),
            oc2=c2.real.to(T), os2=s2.to(FC), oc3=c3.real.to(T),
            os3=s3.to(FC), oc4=c4.real.to(T), os4=s4.to(FC),
            sbar_m2=sbar_even, ebar_m3=ebar_odd, lbar_m3=lbar_odd,
            mu_m5=torch.where(ge2, mu_m3, s.mu_m5),
            mu_m4=torch.where(ge2, mu_m2, s.mu_m4),
            lam_m4=torch.where(ge2, l_m2, s.lam_m4),
            pibar_odd=pibar_next_odd, pibar_even=pibar_next_even,
            rNorm=rNorm, iter=it, status=code)
        if verbose > 0 and bool(active):
            rt.debug_row(verbose, it, "{:5d}  {:7.1e}  {:7.1e}  {:7.1e}",
                         rNorm, beta_kp1, gamma_kp1)
        if callback is not None:
            s_new = _exit(callback, s_new, dev)
        return _masked(TrimrState._fields, active, s_new, s)

    return rt.take_steps(body, state_in, steps, iter_cap, callback)


def _trimr_solve(A, b, c, x0=None, y0=None, **kwargs):
    return _tri_solve("TriMR", A, b, c, x0, y0, **kwargs)


def trimr(A, b, c, x0=None, y0=None, *, precision=None, **kwargs):
    """x, y, stats = trimr(A, b, c; spd/snd/flip/sp, τ, ν, M, N, ...).

    ``precision="double_word"`` raises NotImplementedError until the
    iterative refinement (solvers/_refine.py, ROADMAP.md Queue 1 item 8)
    is ported."""
    _no_double_word("TRIMR", precision)
    x, y, stats, _ = _trimr_solve(A, b, c, x0, y0, **kwargs)
    return x, y, stats


# name → (general core, whole-solve kernel, its dtype gate)
_METHODS = {"TriCG": (_tricg_core, tricg_dia_fused,
                      tricg_dia_fused_supported),
            "TriMR": (_trimr_core, trimr_dia_fused,
                      trimr_dia_fused_supported)}
