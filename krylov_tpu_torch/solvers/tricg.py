"""TriCG for symmetric quasi-definite systems [τE A; Aᴴ νF][x; y] = [b; c].

Counterpart of the TriCG half of ``krylov_tpu/solvers/tricg.py`` and of
reference src/tricg.jl: the orthogonal Saunders–Simon–Yip
tridiagonalisation, the LDLᴴ factorisation of the block-tridiagonal
Sₖ.ₖ and the odd and even direction recurrences; the presets spd (τ = 1,
ν = 1), snd (τ = −1, ν = −1), flip (τ = −1, ν = 1) and sp (τ = 1, ν = 0);
M and N (centred preconditioning, applied or divided by); a warm start
(x0, y0).  A may be rectangular or complex.  A square DIA operator on
the card with a real b, no M, N or warm start and the default options
goes to a whole-solve kernel (ops/cuda_fused.py) on Aᴴ's aligned
diagonals; every other configuration runs the general core, whose
iterations ``_runtime.drive`` takes in chunks with masked updates.
TriMR, the other half of the JAX module, is ROADMAP.md Queue 1 item 6b.
"""

import time
from typing import NamedTuple

import numpy as np
import torch

from .. import _runtime as rt
from .._dtypes import real_dtype
from ..operators import as_operator, precond_apply
from ..ops.cuda_fused import (INCONS_TRI, tricg_dia_fused,
                              tricg_dia_fused_supported)
from ..ops.kops import kdot
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


def _tricg_solve(
    A, b, c, x0=None, y0=None, *, M=None, N=None, ldiv=False,
    spd=False, snd=False, flip=False, sp=False, tau=1.0, nu=-1.0,
    atol=None, rtol=None, itmax=0, timemax=float("inf"), verbose=0,
    history=False, callback=None,
):
    """Solves [τE A; Aᴴ νF][x; y] = [b; c]; a warm start needs x0 and y0,
    and, as in the JAX package, y0 without x0 is not used
    (krylov_tpu/solvers/tricg.py:92-96, 346-348)."""
    start = time.perf_counter()
    A, b, c, x0, y0, m, n = _inputs(A, b, c, x0, y0)
    if x0 is not None and y0 is None:
        raise ValueError("a warm start of TriCG needs x0 and y0")
    if b.shape[0] != m or c.shape[0] != n:
        raise ValueError("Inconsistent problem size")
    M = as_operator(M, device=b.device)
    N = as_operator(N, device=b.device)
    tau, nu = _resolve_tau_nu(tau, nu, spd, snd, flip, sp)
    T = real_dtype(b.dtype)
    atol = rt.default_tol(atol, T)
    rtol = rt.default_tol(rtol, T)
    itmax = rt.resolve_itmax(itmax, m + n)
    rt.debug_table(verbose, "TRICG", ("k", "‖rₖ‖", "βₖ₊₁", "γₖ₊₁"), m, n)
    hist_len = itmax + 1 if history else 0

    # Fast path: square DIA stencil + default config → whole-solve kernel.
    if (M is None and N is None and x0 is None and y0 is None
            and not history and callback is None and verbose == 0
            and timemax == float("inf") and m == n
            and _fused_ready(A, n, b.dtype, tricg_dia_fused_supported)):
        pd_adj, ot_adj = A.aligned_adjoint_kernel_args()
        x, y, niter, _, code_d = tricg_dia_fused(
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
        return _tricg_core(
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


def tricg(A, b, c, x0=None, y0=None, *, precision=None, **kwargs):
    """x, y, stats = tricg(A, b, c; spd/snd/flip/sp, τ, ν, M, N, ...).

    ``precision="double_word"`` raises NotImplementedError until the
    iterative refinement (solvers/_refine.py, ROADMAP.md Queue 1 item 8)
    is ported."""
    _no_double_word("TRICG", precision)
    x, y, stats, _ = _tricg_solve(A, b, c, x0, y0, **kwargs)
    return x, y, stats
