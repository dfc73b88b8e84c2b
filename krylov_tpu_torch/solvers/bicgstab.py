"""BiCGSTAB and CGS for square non-Hermitian Ax = b.

Counterpart of ``krylov_tpu/solvers/bicgstab.py`` and of reference
src/bicgstab.jl and src/cgs.jl: the shadow vector ``c`` (b by default),
left and right preconditioning M/N, the breakdown statuses
("Breakdown bᴴc = 0", "breakdown αₖ == 0"), warm start, history,
callback and verbose; two operator applications per iteration each.  A
DIA operator with M = N = I, c = b, no warm start and the default
options goes to a whole-solve kernel (ops/cuda_fused.py); every other
configuration runs the general core, whose iterations
``_runtime.drive`` takes in chunks with masked updates.
"""

import time
from typing import NamedTuple

import numpy as np
import torch

from .. import _runtime as rt
from .._dtypes import real_dtype
from ..operators import as_operator, precond_apply, solve_inputs
from ..ops.cuda_fused import (ALPHA_BREAKDOWN, BC_BREAKDOWN,
                              bicgstab_dia_fused, bicgstab_dia_fused_supported,
                              cgs_dia_fused, cgs_dia_fused_supported)
from ..ops.kops import kdot, knorm
from ..stats import SimpleStats
from .cr import _check_square, _fused_ready, _i32, _masked, _no_double_word, \
    _trim

_STATUS = {
    BC_BREAKDOWN: "Breakdown bᴴc = 0",
    ALPHA_BREAKDOWN: "breakdown αₖ == 0",
}


class BicgstabState(NamedTuple):
    x: torch.Tensor
    r: torch.Tensor
    p: torch.Tensor
    v: torch.Tensor
    next_rho: torch.Tensor
    rNorm: torch.Tensor
    eps_lim: torch.Tensor
    iter: torch.Tensor
    status: torch.Tensor
    hist_r: torch.Tensor


class CgsState(NamedTuple):
    x: torch.Tensor
    r: torch.Tensor
    u: torch.Tensor
    p: torch.Tensor
    q: torch.Tensor
    rho: torch.Tensor
    rNorm: torch.Tensor
    eps_lim: torch.Tensor
    iter: torch.Tensor
    status: torch.Tensor
    hist_r: torch.Tensor


def _safe(d):
    return torch.where(d == 0, torch.ones_like(d), d)


def _start(A, M_apply, b, c, x0, atol, rtol, history, hist_len):
    """r = M(b − A x0), ‖r‖, ε, ρ = ⟨c, r⟩, the first status and the
    history buffer (krylov_tpu/solvers/bicgstab.py:62-80)."""
    T = real_dtype(b.dtype)
    dev = b.device
    r = M_apply(b if x0 is None else b - A.matvec(x0))
    rNorm = knorm(r)
    eps_lim = torch.tensor(atol, dtype=T, device=dev) \
        + torch.tensor(rtol, dtype=T, device=dev) * rNorm
    rho = kdot(c, r)
    status = torch.where(
        rNorm == 0, rt.ZERO_RESIDUAL,
        torch.where(rho == 0, BC_BREAKDOWN,
                    torch.where(rNorm <= eps_lim, rt.SOLVED, rt.RUNNING))
    ).to(torch.int32)
    hist = rt.hist_write(rt.hist_init(hist_len, T, dev), _i32(0, dev), rNorm,
                         history)
    return r, rNorm, eps_lim, rho, status, hist


def _code(rNorm, eps_lim, alpha):
    """Solved, else the α breakdown, else running (later wins)."""
    solved = (rNorm <= eps_lim) | ((rNorm + 1.0) <= 1.0)
    breakdown = (alpha == 0) | torch.isnan(torch.abs(alpha))
    return torch.where(solved, rt.SOLVED, torch.where(
        breakdown, ALPHA_BREAKDOWN, rt.RUNNING)).to(torch.int32)


def _user_exit(callback, s_new, dev):
    """A callback's exit while the solve runs or has just solved."""
    user_exit = torch.as_tensor(callback(s_new), device=dev)
    return s_new._replace(status=torch.where(
        user_exit & ((s_new.status == rt.RUNNING)
                     | (s_new.status == rt.SOLVED)),
        rt.USER_EXIT, s_new.status).to(torch.int32))


def _bicgstab_core(
    A, M, N, b, c, x0, state_in, iter_cap, steps, atol, rtol,
    *, ldiv, history, hist_len, callback, verbose,
):
    """``steps`` BiCGSTAB iterations from ``state_in`` (None: start), each
    with its updates masked by ``status == RUNNING and iter < iter_cap``."""
    dev = b.device

    def M_apply(u):
        return precond_apply(M, u, ldiv)

    def N_apply(u):
        return precond_apply(N, u, ldiv)

    if state_in is None:
        r, rNorm, eps_lim, rho, status, hist = _start(
            A, M_apply, b, c, x0, atol, rtol, history, hist_len)
        state_in = BicgstabState(
            x=torch.zeros_like(b), r=r, p=r, v=torch.zeros_like(b),
            next_rho=rho, rNorm=rNorm, eps_lim=eps_lim, iter=_i32(0, dev),
            status=status, hist_r=hist)

    def body(s):
        active = (s.status == rt.RUNNING) & (s.iter < iter_cap)
        rho = s.next_rho
        y = N_apply(s.p)
        v = M_apply(A.matvec(y))
        alpha = rho / _safe(kdot(c, v))
        sv = s.r - alpha * v
        x_aux = s.x + alpha * y
        z = N_apply(sv)
        t = M_apply(A.matvec(z))
        omega = kdot(t, sv) / _safe(kdot(t, t))
        r_new = sv - omega * t
        next_rho = kdot(c, r_new)
        beta = (next_rho / _safe(rho)) * (alpha / _safe(omega))
        rNorm = knorm(r_new)
        it = s.iter + 1
        rt.hist_write_masked(s.hist_r, active, it, rNorm, history)
        s_new = s._replace(
            x=x_aux + omega * z, r=r_new, p=r_new + beta * (s.p - omega * v),
            v=v, next_rho=next_rho, rNorm=rNorm, iter=it,
            status=_code(rNorm, s.eps_lim, alpha))
        if callback is not None:
            s_new = _user_exit(callback, s_new, dev)
        if verbose > 0 and bool(active):
            rt.debug_row(verbose, it, "{:5d}  {:7.1e}  {:8.1e}  {:8.1e}",
                         rNorm, torch.abs(alpha), torch.abs(omega))
        return _masked(BicgstabState._fields, active, s_new, s,
                       keep=("hist_r",))

    return rt.take_steps(body, state_in, steps, iter_cap, callback)


def _cgs_core(
    A, M, N, b, c, x0, state_in, iter_cap, steps, atol, rtol,
    *, ldiv, history, hist_len, callback, verbose,
):
    """``steps`` CGS iterations from ``state_in`` (None: start), each with
    its updates masked by ``status == RUNNING and iter < iter_cap``."""
    dev = b.device

    def M_apply(u):
        return precond_apply(M, u, ldiv)

    def N_apply(u):
        return precond_apply(N, u, ldiv)

    if state_in is None:
        r, rNorm, eps_lim, rho, status, hist = _start(
            A, M_apply, b, c, x0, atol, rtol, history, hist_len)
        state_in = CgsState(
            x=torch.zeros_like(b), r=r, u=r, p=r, q=torch.zeros_like(b),
            rho=rho, rNorm=rNorm, eps_lim=eps_lim, iter=_i32(0, dev),
            status=status, hist_r=hist)

    def body(s):
        active = (s.status == rt.RUNNING) & (s.iter < iter_cap)
        v = M_apply(A.matvec(N_apply(s.p)))
        alpha = s.rho / _safe(kdot(c, v))
        q = s.u - alpha * v
        z = N_apply(s.u + q)
        w = M_apply(A.matvec(z))
        r_new = s.r - alpha * w
        rho_next = kdot(c, r_new)
        beta = rho_next / _safe(s.rho)
        u_new = r_new + beta * q
        rNorm = knorm(r_new)
        it = s.iter + 1
        rt.hist_write_masked(s.hist_r, active, it, rNorm, history)
        s_new = s._replace(
            x=s.x + alpha * z, r=r_new, u=u_new,
            p=u_new + beta * (q + beta * s.p), q=q, rho=rho_next,
            rNorm=rNorm, iter=it, status=_code(rNorm, s.eps_lim, alpha))
        if callback is not None:
            s_new = _user_exit(callback, s_new, dev)
        if verbose > 0 and bool(active):
            rt.debug_row(verbose, it, "{:5d}  {:7.1e}", rNorm)
        return _masked(CgsState._fields, active, s_new, s, keep=("hist_r",))

    return rt.take_steps(body, state_in, steps, iter_cap, callback)


def _biortho_solve(
    core, A, b, x0=None, *, c=None, M=None, N=None, ldiv=False,
    atol=None, rtol=None, itmax=0, timemax=float("inf"), verbose=0,
    history=False, callback=None,
):
    start = time.perf_counter()
    A, b, x0, M = solve_inputs(A, b, x0, M)
    N = as_operator(N, device=b.device)
    n = b.shape[0]
    _check_square(A, n)
    T = real_dtype(b.dtype)
    atol = rt.default_tol(atol, T)
    rtol = rt.default_tol(rtol, T)
    itmax = rt.resolve_itmax(itmax, 2 * n)
    hist_len = itmax + 1 if history else 0
    c_is_b = c is None
    c = b if c is None else rt.as_device_tensor(c, b).to(b.dtype)
    is_bicgstab = core is _bicgstab_core

    # Fast path: DIA stencil + default config → whole-solve kernel.
    fused, gate = ((bicgstab_dia_fused, bicgstab_dia_fused_supported)
                   if is_bicgstab else (cgs_dia_fused, cgs_dia_fused_supported))
    if (M is None and N is None and c_is_b and x0 is None and not history
            and callback is None and verbose == 0
            and timemax == float("inf") and _fused_ready(A, n, b.dtype, gate)):
        x, niter, _, code_d = fused(A._pd, A._offsets, b.contiguous(), atol,
                                    rtol, itmax)
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

    name = "BICGSTAB" if is_bicgstab else "CGS"
    rt.debug_header(verbose, f"{name}: system of size {n}")
    if is_bicgstab:
        rt.debug_header(verbose, f"{'k':>5s}  {'‖rₖ‖':>7s}  {'|αₖ|':>8s}  "
                                 f"{'|ωₖ|':>8s}")
    else:
        rt.debug_header(verbose, f"{'k':>5s}  {'‖rₖ‖':>7s}")

    def run(state, cap, steps):
        return core(
            A, M, N, b, c, x0, state, cap, steps, atol, rtol,
            ldiv=bool(ldiv), history=bool(history), hist_len=hist_len,
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
        solved=rt.is_solved_code(code),
        inconsistent=False,
        residuals=_trim(state.hist_r, niter, history),
        timer=time.perf_counter() - start,
        status=rt.decode_status(code, _STATUS),
    )
    return x, stats, state


def _bicgstab_solve(A, b, x0=None, **kwargs):
    return _biortho_solve(_bicgstab_core, A, b, x0, **kwargs)


def _cgs_solve(A, b, x0=None, **kwargs):
    return _biortho_solve(_cgs_core, A, b, x0, **kwargs)


def bicgstab(A, b, x0=None, *, precision=None, **kwargs):
    """x, stats = bicgstab(A, b; c=b, M=None, N=None, ...).

    ``precision="double_word"`` raises NotImplementedError until the
    iterative refinement (solvers/_refine.py, ROADMAP.md Queue 1 item 8)
    is ported."""
    _no_double_word("BICGSTAB", precision)
    x, stats, _ = _bicgstab_solve(A, b, x0, **kwargs)
    return x, stats


def cgs(A, b, x0=None, *, precision=None, **kwargs):
    """x, stats = cgs(A, b; c=b, M=None, N=None, ...).

    ``precision="double_word"`` raises NotImplementedError until the
    iterative refinement (solvers/_refine.py, ROADMAP.md Queue 1 item 8)
    is ported."""
    _no_double_word("CGS", precision)
    x, stats, _ = _cgs_solve(A, b, x0, **kwargs)
    return x, stats
