"""Conjugate Gradient for Hermitian positive-definite Ax = b.

Counterpart of ``krylov_tpu/solvers/cg.py`` and of reference src/cg.jl:
M-preconditioning, ldiv, trust-region ``radius`` via to_boundary,
``linesearch`` nonpositive-curvature exit with npc_dir capture, warm
start, history, callback, verbose, ``precision="compensated"`` (Dot2
reductions) and the status vocabulary of src/cg.jl:272-278.  A DIA
operator with the default options and M = I, a diagonal (Jacobi) M or a
``ChebyshevPreconditioner`` on the same operator object goes to a
whole-solve kernel (ops/cuda_fused.py); every other configuration runs
``_cg_core``, whose iterations ``_runtime.drive`` takes in chunks with
masked updates.
"""

import time
from typing import NamedTuple

import numpy as np
import torch

from .. import _runtime as rt
from .._dtypes import real_dtype
from ..operators import DiagonalOperator, precond_apply, solve_inputs
from ..ops.cuda_fused import (cg_cheby_dia_fused,
                              cg_cheby_dia_fused_supported, cg_dia_fused,
                              cg_dia_fused_supported)
from ..precond import ChebyshevPreconditioner
from ..ops.kops import kdotr, kdotr2, to_boundary
from ..stats import SimpleStats


class CgState(NamedTuple):
    x: torch.Tensor
    r: torch.Tensor
    p: torch.Tensor
    npc_dir: torch.Tensor     # shape (n,) when linesearch/radius, else (0,)
    gamma: torch.Tensor
    pNorm2: torch.Tensor
    rNorm: torch.Tensor
    eps_lim: torch.Tensor     # ε = atol + rtol·‖r₀‖
    iter: torch.Tensor
    status: torch.Tensor
    indefinite: torch.Tensor
    inconsistent: torch.Tensor
    npc_count: torch.Tensor
    posdef_violation: torch.Tensor
    hist: torch.Tensor


def _i32(v, device):
    return torch.tensor(v, dtype=torch.int32, device=device)


def _cg_core(
    A, M, b, x0, state_in, iter_cap, steps, atol, rtol, radius,
    *, ldiv, linesearch, history, hist_len, callback, verbose, use_radius,
    dot2=False,
):
    """``steps`` CG iterations from ``state_in`` (None: start), each with
    its updates masked by ``status == RUNNING and iter < iter_cap``."""
    n = b.shape[0]
    FC = b.dtype
    T = real_dtype(FC)
    dev = b.device
    eps_T = torch.finfo(T).eps
    radius = torch.tensor(radius, dtype=T, device=dev)
    zero, one = torch.zeros((), dtype=T, device=dev), \
        torch.ones((), dtype=T, device=dev)
    npc_shape = (n,) if (linesearch or use_radius) else (0,)
    # precision="compensated": Ogita-Rump-Oishi Dot2 reductions recover
    # fp64-grade dot accuracy from f32 arithmetic (ops/kops.py).
    kdotr_ = kdotr2 if dot2 else kdotr

    def M_apply(v):
        return precond_apply(M, v, ldiv)

    if state_in is None:
        x = torch.zeros(n, dtype=FC, device=dev)
        r = b if x0 is None else b - A.matvec(x0)
        z = M_apply(r)
        p = z
        gamma = kdotr_(r, z)
        posdef_violation = gamma < 0
        rNorm = torch.sqrt(torch.clamp(gamma, min=0))
        eps_lim = torch.tensor(atol, dtype=T, device=dev) \
            + torch.tensor(rtol, dtype=T, device=dev) * rNorm
        status = torch.where(
            gamma == 0, rt.ZERO_RESIDUAL,
            torch.where(rNorm <= eps_lim, rt.SOLVED, rt.RUNNING),
        ).to(torch.int32)
        hist = rt.hist_init(hist_len, T, dev)
        hist = rt.hist_write(hist, _i32(0, dev), rNorm, history)
        false = torch.zeros((), dtype=torch.bool, device=dev)
        state = CgState(
            x=x, r=r, p=p,
            npc_dir=torch.zeros(npc_shape, dtype=FC, device=dev),
            gamma=gamma, pNorm2=gamma, rNorm=rNorm, eps_lim=eps_lim,
            iter=_i32(0, dev), status=status,
            indefinite=false, inconsistent=false,
            npc_count=_i32(0, dev),
            posdef_violation=posdef_violation,
            hist=hist,
        )
    else:
        state = state_in

    def body(s):
        active = (s.status == rt.RUNNING) & (s.iter < iter_cap)
        Ap = A.matvec(s.p)
        pAp = kdotr_(s.p, Ap)

        # Curvature exits (reference src/cg.jl:198-211); only when radius == 0.
        if use_radius:
            curv_small = torch.zeros((), dtype=torch.bool, device=dev)
        else:
            curv_small = pAp <= eps_T * s.pNorm2
        zero_curv = curv_small & (torch.abs(pAp) <= eps_T * s.pNorm2)
        npc_exit = curv_small & linesearch

        alpha = s.gamma / torch.where(pAp == 0, one, pAp)

        on_boundary = torch.zeros((), dtype=torch.bool, device=dev)
        neg_curv_tr = on_boundary
        if use_radius:
            # Step to the trust-region boundary (reference src/cg.jl:216-237).
            if M is None:
                s1, s2 = to_boundary(s.x, s.p, radius, dNorm2=s.pNorm2)
            else:
                s1, s2 = to_boundary(s.x, s.p, radius, M_apply=M_apply)
            sigma = torch.maximum(s1, s2)
            neg_curv_tr = pAp <= 0
            hit = neg_curv_tr | (alpha > sigma)
            alpha = torch.where(hit, sigma, alpha)
            on_boundary = hit

        x_new = s.x + alpha.to(FC) * s.p
        r_new = s.r - alpha.to(FC) * Ap
        z_new = M_apply(r_new)
        gamma_next = kdotr_(r_new, z_new)
        posdef_violation = s.posdef_violation | (gamma_next < 0)
        rNorm_new = torch.sqrt(torch.clamp(gamma_next, min=0))

        resid_decrease_mach = (rNorm_new + 1) <= 1
        solved = (rNorm_new <= s.eps_lim) | resid_decrease_mach | on_boundary

        beta = gamma_next / torch.where(s.gamma == 0, one, s.gamma)
        p_new = torch.where(solved, s.p, z_new + beta.to(FC) * s.p)
        pNorm2_new = torch.where(solved, s.pNorm2,
                                 gamma_next + beta * beta * s.pNorm2)
        gamma_new = torch.where(solved, s.gamma, gamma_next)

        # The curvature-exit iteration skips the x/r update entirely
        # (reference `continue` at src/cg.jl:211).
        skip = zero_curv | npc_exit
        # linesearch at iter 0: x ← p (= M b) before exiting (src/cg.jl:204).
        x_ls0 = torch.where(npc_exit & (s.iter == 0), s.p, s.x)
        x_new = torch.where(skip, x_ls0, x_new)
        r_new = torch.where(skip, s.r, r_new)
        p_new = torch.where(skip, s.p, p_new)
        rNorm_new = torch.where(skip, s.rNorm, rNorm_new)
        gamma_new = torch.where(skip, s.gamma, gamma_new)
        pNorm2_new = torch.where(skip, s.pNorm2, pNorm2_new)
        posdef_violation = torch.where(skip, s.posdef_violation,
                                       posdef_violation)

        npc_dir = s.npc_dir
        npc_hit = npc_exit | neg_curv_tr
        if linesearch or use_radius:
            npc_dir = torch.where(npc_hit, s.p, s.npc_dir)
        indefinite = s.indefinite | npc_hit
        npc_count = s.npc_count + npc_hit.to(torch.int32)
        inconsistent = s.inconsistent | (zero_curv & (not linesearch))

        iter_new = s.iter + (~skip).to(torch.int32)

        # Status precedence mirrors src/cg.jl:272-278 (later assignment wins):
        # boundary < indefinite(npc) < solved < zero_curvature.
        solved_any = (solved & ~skip) | npc_exit
        code = torch.zeros((), dtype=torch.int32, device=dev)
        code = torch.where(solved_any & on_boundary, rt.ON_BOUNDARY, code)
        code = torch.where(solved_any & indefinite, rt.NPC, code)
        code = torch.where(solved_any & (code == rt.RUNNING), rt.SOLVED, code)
        code = torch.where(zero_curv, rt.ZERO_CURVATURE, code).to(torch.int32)

        if history:
            # An inactive step writes history[iter] back unchanged.
            h_idx = torch.where(active, iter_new, s.iter)
            rt.hist_write(s.hist, h_idx, torch.where(
                active, rNorm_new, s.hist[h_idx.long()]), history)

        s_new = CgState(
            x=x_new, r=r_new, p=p_new, npc_dir=npc_dir,
            gamma=gamma_new, pNorm2=pNorm2_new, rNorm=rNorm_new,
            eps_lim=s.eps_lim, iter=iter_new, status=code,
            indefinite=indefinite, inconsistent=inconsistent,
            npc_count=npc_count, posdef_violation=posdef_violation,
            hist=s.hist,
        )
        if callback is not None:
            user_exit = torch.as_tensor(callback(s_new), device=dev)
            s_new = s_new._replace(status=torch.where(
                user_exit, rt.USER_EXIT, s_new.status).to(torch.int32))
        if verbose > 0 and bool(active):
            sigma_v = sigma if use_radius else alpha
            rt.debug_row(verbose, s.iter,
                         "{:5d}  {:7.1e}  {:8.1e}  {:8.1e}  {:8.1e}",
                         s.rNorm, pAp, alpha, sigma_v)
        return CgState(*(
            old if name == "hist" else torch.where(active, new, old)
            for name, new, old in zip(CgState._fields, s_new, s)))

    return rt.take_steps(body, state, steps, iter_cap, callback)


def _cg_fused_path(A, b, x0, atol, rtol, itmax, start, dinv=None,
                   cheby=None):
    """A whole-solve kernel (ops/cuda_fused.py): M = I or z = dinv·r
    (Jacobi), or ``cheby`` a ChebyshevPreconditioner applied inside the
    solve; the host reads the status once per chunk."""
    b_eff = (b if x0 is None else b - A.matvec(x0)).contiguous()
    if cheby is not None:
        x, niter, rnorm, status, viol = cg_cheby_dia_fused(
            A._pd, A._offsets, b_eff, atol, rtol, itmax, cheby.lmin,
            cheby.lmax, cheby.degree)
    else:
        x, niter, rnorm, status, viol = cg_dia_fused(
            A._pd, A._offsets, b_eff, atol, rtol, itmax, dinv=dinv)
    niter, code, viol = torch.stack([niter, status, viol]).tolist()
    if viol:
        raise ValueError(
            "The linear operator `A` or the preconditioner `M` is not "
            "symmetric positive definite.")
    code = rt.final_status_code(code, niter, itmax, False)
    if x0 is not None:
        x = x + x0
    stats = SimpleStats(
        niter=niter,
        solved=rt.is_solved_code(code),
        inconsistent=code == rt.ZERO_CURVATURE,
        indefinite=False,
        npc_count=0,
        residuals=np.zeros(0),
        timer=time.perf_counter() - start,
        status=rt.decode_status(code),
    )
    return x, stats, None


def _cg_solve(
    A, b, x0=None, *, M=None, ldiv=False, radius=0.0, linesearch=False,
    atol=None, rtol=None, itmax=0, timemax=float("inf"), verbose=0,
    history=False, callback=None, precision=None,
):
    start = time.perf_counter()
    A, b, x0, M = solve_inputs(A, b, x0, M)
    n = b.shape[0]
    if A.shape is not None:
        if A.shape[0] != A.shape[1]:
            raise ValueError("System must be square")
        if A.shape[1] != n:
            raise ValueError("Inconsistent problem size")
    if linesearch and radius > 0:
        raise ValueError("`linesearch` set to `true` but trust-region radius > 0")
    if x0 is not None and linesearch:
        raise ValueError("warm_start and linesearch cannot be used together")
    if precision not in (None, "working", "compensated", "double_word"):
        raise ValueError(
            "precision must be None, 'working', 'compensated' or "
            "'double_word'")

    T = real_dtype(b.dtype)
    atol = rt.default_tol(atol, T)
    rtol = rt.default_tol(rtol, T)
    itmax = rt.resolve_itmax(itmax, 2 * n)
    hist_len = itmax + 1 if history else 0

    if precision == "double_word":
        raise NotImplementedError(
            "precision='double_word' is not ported yet (ROADMAP.md Queue 1 "
            "item 8, solvers/_refine.py)")
    dot2 = precision == "compensated"

    # Fast path: DIA stencil + default config → whole-solve kernel (M = I,
    # a diagonal/Jacobi preconditioner, or a Chebyshev polynomial built on
    # this very operator object: as_operator(DIAMatrix) makes a new one
    # each call, so only a caller-held operator matches).
    diag_M = isinstance(M, DiagonalOperator)
    cheb_M = isinstance(M, ChebyshevPreconditioner) and M.A is A
    if ((M is None or diag_M or cheb_M) and not linesearch and radius == 0
            and callback is None and verbose == 0 and not history
            and not dot2
            and timemax == float("inf")
            and getattr(A, "use_kernel", False)
            and getattr(A, "_pd", None) is not None):
        if cheb_M:
            if cg_cheby_dia_fused_supported(A.dia.offsets, n, b.dtype,
                                            stencil_dtype=A._pd.dtype):
                return _cg_fused_path(A, b, x0, atol, rtol, itmax, start,
                                      cheby=M)
        elif cg_dia_fused_supported(A.dia.offsets, n, b.dtype,
                                    stencil_dtype=A._pd.dtype):
            dinv = None
            if diag_M:
                dinv = (1.0 / M.d if ldiv else M.d).to(b.dtype).contiguous()
            return _cg_fused_path(A, b, x0, atol, rtol, itmax, start,
                                  dinv=dinv)

    if verbose > 0:
        rt.debug_header(verbose, f"CG: system of {n} equations in {n} variables")
        rt.debug_header(verbose, f"{'k':>5s}  {'‖r‖':>7s}  {'pAp':>8s}  "
                                 f"{'α':>8s}  {'σ':>8s}")

    def run(state, cap, steps):
        return _cg_core(
            A, M, b, x0, state, cap, steps, atol, rtol, float(radius),
            ldiv=bool(ldiv), linesearch=bool(linesearch),
            history=bool(history), hist_len=hist_len, callback=callback,
            verbose=int(verbose), use_radius=bool(radius > 0), dot2=dot2,
        )

    state, overtimed = rt.drive(run, itmax, timemax, start)
    if bool(state.posdef_violation):
        raise ValueError(
            "The linear operator `A` or the preconditioner `M` is not "
            "symmetric positive definite."
        )

    niter = int(state.iter)
    code = rt.final_status_code(state.status, niter, itmax, overtimed)
    x = state.x
    if x0 is not None:
        x = x + x0

    stats = SimpleStats(
        niter=niter,
        solved=rt.is_solved_code(code),
        inconsistent=bool(state.inconsistent),
        indefinite=bool(state.indefinite),
        npc_count=int(state.npc_count),
        residuals=rt.hist_trim(state.hist, niter) if history else np.zeros(0),
        timer=time.perf_counter() - start,
        status=rt.decode_status(code),
    )
    return x, stats, state


def cg(A, b, x0=None, **kwargs):
    """x, stats = cg(A, b; ...) — see module docstring for options."""
    x, stats, _ = _cg_solve(A, b, x0, **kwargs)
    return x, stats
