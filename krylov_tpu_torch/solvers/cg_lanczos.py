"""CG-LANCZOS and CG-LANCZOS-SHIFT for Hermitian systems.

Counterpart of ``krylov_tpu/solvers/cg_lanczos.py`` and of reference
src/cg_lanczos.jl (check_curvature exit, Anorm estimate via ‖Tₖ‖,
LanczosStats) and src/cg_lanczos_shift.jl (every shifted system
(A + σᵢI)xᵢ = b from one Lanczos stream, per-shift γ/σ/ω recurrences and
convergence masks, LanczosShiftStats).  A DIA operator with the default
options and M = I goes to a whole-solve kernel (ops/cuda_fused.py); every
other configuration runs ``_cg_lanczos_core`` or
``_cg_lanczos_shift_core``, whose iterations ``_runtime.drive`` takes in
chunks with masked updates.
"""

import time
from typing import NamedTuple

import numpy as np
import torch

from .. import _runtime as rt
from .._dtypes import real_dtype
from ..operators import precond_apply, solve_inputs
from ..ops.cuda_fused import (NEG_CURV, cg_lanczos_dia_fused,
                              cg_lanczos_dia_fused_supported,
                              cg_lanczos_shift_dia_fused,
                              cg_lanczos_shift_dia_fused_supported)
from ..ops.kops import kdotr
from ..stats import LanczosShiftStats, LanczosStats
from .cr import _check_square, _fused_ready, _i32, _masked, _no_double_word

_CGL_STATUS = {NEG_CURV: "negative curvature"}


class CgLanczosState(NamedTuple):
    x: torch.Tensor
    Mv: torch.Tensor
    Mv_prev: torch.Tensor
    v: torch.Tensor
    p: torch.Tensor
    beta: torch.Tensor
    sigma: torch.Tensor
    omega: torch.Tensor
    gamma: torch.Tensor
    anorm2: torch.Tensor
    beta_prev: torch.Tensor
    rNorm: torch.Tensor
    eps_lim: torch.Tensor
    iter: torch.Tensor
    status: torch.Tensor
    indefinite: torch.Tensor
    hist_r: torch.Tensor


def _safe(v):
    return torch.where(v == 0, torch.ones_like(v), v)


def _normalise(v, Mv, MisI, FC):
    """β = √max(⟨v, Mv⟩, 0), then v/β and Mv/β (Mv is v when M = I)."""
    beta = torch.sqrt(torch.clamp(kdotr(v, Mv), min=0))
    safe_b = _safe(beta).to(FC)
    v = v / safe_b
    return beta, v, (v if MisI else Mv / safe_b)


def _cg_lanczos_core(
    A, M, b, x0, state_in, iter_cap, steps, atol, rtol,
    *, ldiv, check_curvature, history, hist_len, callback, verbose, MisI,
):
    """``steps`` CG-Lanczos iterations from ``state_in`` (None: start),
    each with its updates masked by ``status == RUNNING and iter <
    iter_cap``."""
    n = b.shape[0]
    FC = b.dtype
    T = real_dtype(FC)
    dev = b.device

    def t_(v):
        return torch.tensor(v, dtype=T, device=dev)

    def M_apply(u):
        return precond_apply(M, u, ldiv)

    if state_in is None:
        Mv = b if x0 is None else b - A.matvec(x0)
        p = M_apply(Mv)
        beta, v, Mv = _normalise(p, Mv, MisI, FC)
        eps_lim = t_(atol) + t_(rtol) * beta
        status = torch.where(
            beta == 0, rt.ZERO_RESIDUAL,
            torch.where(beta <= eps_lim, rt.SOLVED, rt.RUNNING)).to(
                torch.int32)
        hist = rt.hist_write(rt.hist_init(hist_len, T, dev), _i32(0, dev),
                             beta, history)
        state = CgLanczosState(
            x=torch.zeros(n, dtype=FC, device=dev), Mv=Mv, Mv_prev=Mv, v=v,
            p=p, beta=beta, sigma=beta, omega=t_(0.0), gamma=t_(1.0),
            anorm2=t_(0.0), beta_prev=t_(0.0), rNorm=beta, eps_lim=eps_lim,
            iter=_i32(0, dev), status=status,
            indefinite=torch.zeros((), dtype=torch.bool, device=dev),
            hist_r=hist)
    else:
        state = state_in

    def body(s):
        active = (s.status == rt.RUNNING) & (s.iter < iter_cap)
        Mv_next = A.matvec(s.v)
        delta = kdotr(s.v, Mv_next)
        gamma = 1.0 / (delta - s.omega / s.gamma)
        indefinite = s.indefinite | (gamma <= 0)
        # check_curvature exit skips the whole update (reference `continue`)
        skip = indefinite & check_curvature

        Mv_next = Mv_next - delta.to(FC) * s.Mv
        Mv_next = torch.where(s.iter > 0,
                              Mv_next - s.beta.to(FC) * s.Mv_prev, Mv_next)
        beta, v, Mv = _normalise(M_apply(Mv_next), Mv_next, MisI, FC)
        anorm2 = s.anorm2 + s.beta_prev ** 2 + beta ** 2 + delta ** 2

        om = beta * gamma
        sigma = -om * s.sigma
        om2 = om * om
        rNorm = torch.abs(sigma)
        solved = (rNorm <= s.eps_lim) | ((rNorm + 1.0) <= 1.0)

        new = dict(x=s.x + gamma.to(FC) * s.p,
                   p=sigma.to(FC) * v + om2.to(FC) * s.p, v=v, Mv=Mv,
                   Mv_prev=s.Mv, iter=s.iter + 1, beta=beta, sigma=sigma,
                   omega=om2, gamma=gamma, anorm2=anorm2, beta_prev=beta,
                   rNorm=rNorm)
        new = {k: torch.where(skip, getattr(s, k), val)
               for k, val in new.items()}
        code = torch.where(skip, NEG_CURV,
                           torch.where(solved, rt.SOLVED, rt.RUNNING))
        rt.hist_write_masked(s.hist_r, active, new["iter"], new["rNorm"],
                             history)
        s_new = s._replace(**new, status=code.to(torch.int32),
                           indefinite=indefinite)
        if callback is not None:
            user_exit = torch.as_tensor(callback(s_new), device=dev)
            stop = user_exit & ((s_new.status == rt.RUNNING)
                                | (s_new.status == rt.SOLVED))
            s_new = s_new._replace(status=torch.where(
                stop, rt.USER_EXIT, s_new.status).to(torch.int32))
        if verbose > 0 and bool(active):
            rt.debug_row(verbose, s_new.iter, "{:5d}  {:7.1e}", s_new.rNorm)
        return _masked(CgLanczosState._fields, active, s_new, s,
                       keep=("hist_r",))

    return rt.take_steps(body, state, steps, iter_cap, callback)


def _cg_lanczos_solve(
    A, b, x0=None, *, M=None, ldiv=False, check_curvature=False,
    atol=None, rtol=None, itmax=0, timemax=float("inf"), verbose=0,
    history=False, callback=None,
):
    start = time.perf_counter()
    A, b, x0, M = solve_inputs(A, b, x0, M)
    n = b.shape[0]
    _check_square(A, n)
    T = real_dtype(b.dtype)
    atol = rt.default_tol(atol, T)
    rtol = rt.default_tol(rtol, T)
    itmax = rt.resolve_itmax(itmax, 2 * n)
    rt.debug_table(verbose, "CG-LANCZOS", ("k", "‖rₖ‖"), n)
    hist_len = itmax + 1 if history else 0

    # Fast path: DIA stencil + default config → whole-solve kernel.
    if (M is None and callback is None and verbose == 0 and not history
            and timemax == float("inf")
            and _fused_ready(A, n, b.dtype, cg_lanczos_dia_fused_supported)):
        b_eff = b if x0 is None else b - A.matvec(x0)
        x, niter, _, anorm, code_d, indef = cg_lanczos_dia_fused(
            A._pd, A._offsets, b_eff.contiguous(), atol, rtol, itmax,
            check_curvature=bool(check_curvature))
        niter, code, indef = torch.stack([niter, code_d, indef]).tolist()
        code = rt.final_status_code(code, niter, itmax, False)
        if x0 is not None:
            x = x + x0
        stats = LanczosStats(
            niter=niter,
            solved=rt.is_solved_code(code),
            residuals=np.zeros(0),
            indefinite=bool(indef),
            Anorm=float(anorm),
            timer=time.perf_counter() - start,
            status=rt.decode_status(code, _CGL_STATUS),
        )
        return x, stats, None

    def run(state, cap, steps):
        return _cg_lanczos_core(
            A, M, b, x0, state, cap, steps, atol, rtol,
            ldiv=bool(ldiv), check_curvature=bool(check_curvature),
            history=bool(history), hist_len=hist_len, callback=callback,
            verbose=int(verbose), MisI=M is None,
        )

    state, overtimed = rt.drive(run, itmax, timemax, start)
    niter = int(state.iter)
    code = rt.final_status_code(state.status, niter, itmax, overtimed)
    x = state.x
    if x0 is not None:
        x = x + x0
    stats = LanczosStats(
        niter=niter,
        solved=rt.is_solved_code(code),
        residuals=rt.hist_trim(state.hist_r, niter) if history
        else np.zeros(0),
        indefinite=bool(state.indefinite),
        Anorm=float(torch.sqrt(state.anorm2)),
        timer=time.perf_counter() - start,
        status=rt.decode_status(code, _CGL_STATUS),
    )
    return x, stats, state


def cg_lanczos(A, b, x0=None, *, precision=None, **kwargs):
    """x, stats = cg_lanczos(A, b; ...) — CG via the Lanczos process.

    ``precision="double_word"`` raises NotImplementedError until the
    iterative refinement (solvers/_refine.py, ROADMAP.md Queue 1) is
    ported."""
    _no_double_word("CG-LANCZOS", precision)
    x, stats, _ = _cg_lanczos_solve(A, b, x0, **kwargs)
    return x, stats


# ---------------------------------------------------------------------------
# CG-LANCZOS-SHIFT: (A + σᵢ I) xᵢ = b for all shifts from one Lanczos stream.
# ---------------------------------------------------------------------------

class CgLanczosShiftState(NamedTuple):
    x: torch.Tensor          # (nshifts, n)
    Mv: torch.Tensor
    Mv_prev: torch.Tensor
    v: torch.Tensor
    p: torch.Tensor          # (nshifts, n)
    beta: torch.Tensor
    sigma: torch.Tensor      # (nshifts,)
    omega: torch.Tensor
    gamma: torch.Tensor
    rNorms: torch.Tensor
    converged: torch.Tensor
    indefinite: torch.Tensor
    eps_lim: torch.Tensor
    iter: torch.Tensor
    status: torch.Tensor
    hist_r: torch.Tensor     # (hist_len, nshifts)


def _cg_lanczos_shift_core(
    A, M, b, shifts, state_in, iter_cap, steps, atol, rtol,
    *, ldiv, check_curvature, history, hist_len, callback, MisI,
):
    """``steps`` CG-Lanczos-shift iterations from ``state_in`` (None:
    start), each with its updates masked by ``status == RUNNING and iter
    < iter_cap``."""
    n = b.shape[0]
    ns = shifts.shape[0]
    FC = b.dtype
    T = real_dtype(FC)
    dev = b.device

    def M_apply(u):
        return precond_apply(M, u, ldiv)

    if state_in is None:
        p = M_apply(b)
        beta, v, Mv = _normalise(p, b, MisI, FC)
        rNorms = beta.expand(ns).clone()
        eps_lim = torch.tensor(atol, dtype=T, device=dev) \
            + torch.tensor(rtol, dtype=T, device=dev) * beta
        converged = rNorms <= eps_lim
        status = torch.where(
            beta == 0, rt.ZERO_RESIDUAL,
            torch.where(converged.all(), rt.SOLVED, rt.RUNNING)).to(
                torch.int32)
        hist = torch.full((max(hist_len, 1), ns), float("nan"), dtype=T,
                          device=dev)
        if history:
            hist[0] = rNorms
        state = CgLanczosShiftState(
            x=torch.zeros((ns, n), dtype=FC, device=dev), Mv=Mv, Mv_prev=Mv,
            v=v, p=p.expand(ns, n).clone(), beta=beta,
            sigma=beta.expand(ns).clone(),
            omega=torch.zeros(ns, dtype=T, device=dev),
            gamma=torch.ones(ns, dtype=T, device=dev),
            rNorms=rNorms, converged=converged,
            indefinite=torch.zeros(ns, dtype=torch.bool, device=dev),
            eps_lim=eps_lim, iter=_i32(0, dev), status=status, hist_r=hist)
    else:
        state = state_in

    def body(s):
        active = (s.status == rt.RUNNING) & (s.iter < iter_cap)
        Mv_next = A.matvec(s.v)
        delta = kdotr(s.v, Mv_next)
        Mv_next = Mv_next - delta.to(FC) * s.Mv
        Mv_next = torch.where(s.iter > 0,
                              Mv_next - s.beta.to(FC) * s.Mv_prev, Mv_next)
        beta, v, Mv = _normalise(M_apply(Mv_next), Mv_next, MisI, FC)

        rho = torch.ones((), dtype=T, device=dev) if MisI else kdotr(v, v)
        gamma = 1.0 / ((delta + rho * shifts) - s.omega / s.gamma)
        indefinite = s.indefinite | (gamma <= 0)
        mask = ~(s.converged | (indefinite & check_curvature))
        col = mask[:, None]

        om = beta * gamma
        sigma = torch.where(mask, -om * s.sigma, s.sigma)
        om2 = torch.where(mask, om * om, s.omega)
        rNorms = torch.where(mask, torch.abs(sigma), s.rNorms)
        converged = torch.where(mask, rNorms <= s.eps_lim, s.converged)
        solved = (converged | (indefinite & check_curvature)).all()
        it = s.iter + 1
        if history:
            # an inactive step writes row 0 back unchanged
            row = torch.where(active, it, torch.zeros_like(it)).long()
            s.hist_r[row] = torch.where(
                active, torch.where(mask, rNorms, float("nan")),
                s.hist_r[row])

        s_new = s._replace(
            x=torch.where(col, s.x + gamma[:, None].to(FC) * s.p, s.x),
            Mv=Mv, Mv_prev=s.Mv, v=v,
            p=torch.where(col, sigma[:, None].to(FC) * v[None, :]
                          + om2[:, None].to(FC) * s.p, s.p),
            beta=beta, sigma=sigma, omega=om2,
            gamma=torch.where(mask, gamma, s.gamma), rNorms=rNorms,
            converged=converged, indefinite=indefinite, iter=it,
            status=torch.where(solved, rt.SOLVED, rt.RUNNING).to(
                torch.int32))
        if callback is not None:
            user_exit = torch.as_tensor(callback(s_new), device=dev)
            s_new = s_new._replace(status=torch.where(
                user_exit & (s_new.status == rt.RUNNING), rt.USER_EXIT,
                s_new.status).to(torch.int32))
        return _masked(CgLanczosShiftState._fields, active, s_new, s,
                       keep=("hist_r",))

    return rt.take_steps(body, state, steps, iter_cap, callback)


def _cg_lanczos_shift_solve(
    A, b, shifts, *, M=None, ldiv=False, check_curvature=False,
    atol=None, rtol=None, itmax=0, timemax=float("inf"), verbose=0,
    history=False, callback=None,
):
    start = time.perf_counter()
    A, b, _, M = solve_inputs(A, b, None, M)
    n = b.shape[0]
    _check_square(A, n)
    T = real_dtype(b.dtype)
    shifts = torch.as_tensor(shifts, dtype=T, device=b.device)
    nshifts = shifts.shape[0]
    atol = rt.default_tol(atol, T)
    rtol = rt.default_tol(rtol, T)
    itmax = rt.resolve_itmax(itmax, 2 * n)
    hist_len = itmax + 1 if history else 0

    # Fast path: DIA stencil + default config on a real b → whole-solve
    # kernel (one Lanczos stream, every shift's x and p on the card).
    if (M is None and callback is None and verbose == 0 and not history
            and timemax == float("inf") and b.dtype == T
            and _fused_ready(A, n, b.dtype,
                             cg_lanczos_shift_dia_fused_supported)):
        X, niter, _, code_d, indef = cg_lanczos_shift_dia_fused(
            A._pd, A._offsets, b.contiguous(), shifts, atol, rtol, itmax,
            check_curvature=bool(check_curvature))
        niter, code = torch.stack([niter, code_d]).tolist()
        code = rt.final_status_code(code, niter, itmax, False)
        stats = LanczosShiftStats(
            niter=niter,
            solved=rt.is_solved_code(code),
            residuals=[],
            indefinite=indef.cpu().numpy().astype(bool),
            timer=time.perf_counter() - start,
            status=rt.decode_status(code),
        )
        return X, stats, None

    def run(state, cap, steps):
        return _cg_lanczos_shift_core(
            A, M, b, shifts, state, cap, steps, atol, rtol,
            ldiv=bool(ldiv), check_curvature=bool(check_curvature),
            history=bool(history), hist_len=hist_len, callback=callback,
            MisI=M is None,
        )

    state, overtimed = rt.drive(run, itmax, timemax, start)
    niter = int(state.iter)
    code = rt.final_status_code(state.status, niter, itmax, overtimed)
    residuals = []
    if history:
        h = state.hist_r[: niter + 1].cpu().numpy()
        residuals = [h[:, i][~np.isnan(h[:, i])] for i in range(nshifts)]
    stats = LanczosShiftStats(
        niter=niter,
        solved=rt.is_solved_code(code),
        residuals=residuals,
        indefinite=state.indefinite.cpu().numpy(),
        timer=time.perf_counter() - start,
        status=rt.decode_status(code),
    )
    return state.x, stats, state


def cg_lanczos_shift(A, b, shifts, **kwargs):
    """X, stats = cg_lanczos_shift(A, b, shifts) — X has shape
    (nshifts, n): row i solves (A + shifts[i] I) x = b."""
    X, stats, _ = _cg_lanczos_shift_solve(A, b, shifts, **kwargs)
    return X, stats
