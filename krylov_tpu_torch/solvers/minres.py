"""MINRES for Hermitian (possibly indefinite or singular) Ax = b.

Counterpart of ``krylov_tpu/solvers/minres.py`` and of reference
src/minres.jl: λ-shift (solves A + λI), M preconditioning (ldiv),
linesearch nonpositive-curvature exit with npc_dir capture, the etol
forward-error window stop, the conlim ill-conditioning stop, Anorm and
Acond estimates, warm start, history, callback and the status vocabulary
of src/minres.jl:469-478.  A DIA operator with the default options and
M = I or a diagonal (Jacobi) M goes to the whole-solve kernel
(ops/cuda_fused.py); every other configuration runs ``_minres_core``,
whose iterations ``_runtime.drive`` takes in chunks with masked updates.
"""

import time
from typing import NamedTuple

import numpy as np
import torch

from .. import _runtime as rt
from .._dtypes import real_dtype
from ..operators import DiagonalOperator, precond_apply, solve_inputs
from ..ops.cuda_fused import minres_dia_fused, minres_dia_fused_supported
from ..ops.kops import kdotr, knorm
from ..stats import SimpleStats
from .cr import (_check_square, _fused_ready, _i32, _masked,
                 _no_double_word, _trim)


class MinresState(NamedTuple):
    x: torch.Tensor
    r1: torch.Tensor          # Lanczos vectors (unnormalised)
    r2: torch.Tensor
    v: torch.Tensor           # v = M r2 (r2 itself when M is None)
    w1: torch.Tensor          # wₖ₋₂ direction
    w2: torch.Tensor          # wₖ₋₁ direction
    npc_dir: torch.Tensor
    oldbeta: torch.Tensor
    beta: torch.Tensor
    beta1: torch.Tensor
    dbar: torch.Tensor
    eps_prev: torch.Tensor    # ϵ of the previous iteration (w recurrence)
    phibar: torch.Tensor
    gmax: torch.Tensor
    gmin: torch.Tensor
    cs: torch.Tensor
    sn: torch.Tensor
    anorm2: torch.Tensor
    xenorm2: torch.Tensor
    rNorm: torch.Tensor
    eps_lim: torch.Tensor
    err_vec: torch.Tensor
    zeta_k: torch.Tensor
    delta_w: torch.Tensor
    iter: torch.Tensor
    status: torch.Tensor
    indefinite: torch.Tensor
    inconsistent: torch.Tensor
    npc_count: torch.Tensor
    precond_violation: torch.Tensor
    hist_r: torch.Tensor
    hist_ar: torch.Tensor
    hist_acond: torch.Tensor


_HIST = ("hist_r", "hist_ar", "hist_acond")


def _minres_core(
    A, M, b, x0, state_in, iter_cap, steps, atol, rtol, etol, conlim, lam,
    *, ldiv, linesearch, history, hist_len, callback, verbose, window, MisI,
):
    """``steps`` MINRES iterations from ``state_in`` (None: start), each
    with its updates masked by ``status == RUNNING and iter < iter_cap``."""
    n = b.shape[0]
    FC = b.dtype
    T = real_dtype(FC)
    dev = b.device
    eps_T = torch.finfo(T).eps
    tiny = torch.finfo(T).tiny

    def t_(v):
        return torch.tensor(v, dtype=T, device=dev)

    zero, one = t_(0.0), t_(1.0)
    lam = t_(lam)
    ctol = torch.where(t_(conlim) > 0, 1.0 / t_(conlim), zero)
    etol = t_(etol)
    npc_shape = (n,) if linesearch else (0,)

    def M_apply(u):
        return precond_apply(M, u, ldiv)

    if state_in is None:
        x = torch.zeros(n, dtype=FC, device=dev)
        r1 = b if x0 is None else b - (A.matvec(x0) + lam.to(FC) * x0)
        v = M_apply(r1)
        beta1_sq = kdotr(r1, v)
        beta1 = torch.sqrt(torch.clamp(beta1_sq, min=0))
        eps_lim = t_(atol) + t_(rtol) * beta1
        # β₁ = 0 → zero-residual exit (the reference sets niter = 1 here).
        status = torch.where(
            beta1_sq == 0, rt.ZERO_RESIDUAL,
            torch.where(beta1 <= eps_lim, rt.SOLVED_ZERO,
                        rt.RUNNING)).to(torch.int32)
        hists = []
        for first in (beta1, zero, zero):
            h = rt.hist_init(hist_len, T, dev)
            hists.append(rt.hist_write(h, _i32(0, dev), first, history))
        false = torch.zeros((), dtype=torch.bool, device=dev)
        state = MinresState(
            x=x, r1=r1, r2=r1, v=v,
            w1=torch.zeros(n, dtype=FC, device=dev),
            w2=torch.zeros(n, dtype=FC, device=dev),
            npc_dir=v if linesearch else v[:0],
            oldbeta=zero, beta=beta1, beta1=beta1,
            dbar=zero, eps_prev=zero, phibar=beta1,
            gmax=zero, gmin=t_(float("inf")), cs=-one, sn=zero,
            anorm2=zero, xenorm2=zero, rNorm=beta1, eps_lim=eps_lim,
            err_vec=torch.zeros(window, dtype=T, device=dev),
            zeta_k=zero, delta_w=zero, iter=_i32(0, dev), status=status,
            indefinite=false, inconsistent=false, npc_count=_i32(0, dev),
            precond_violation=beta1_sq < 0,
            hist_r=hists[0], hist_ar=hists[1], hist_acond=hists[2],
        )
    else:
        state = state_in

    def body(s):
        active = (s.status == rt.RUNNING) & (s.iter < iter_cap)
        it = s.iter + 1
        beta_c = s.beta.to(FC)

        # Lanczos step on unnormalised vectors (reference :295-316).
        y = A.matvec(s.v) + lam.to(FC) * s.v
        y = y / beta_c
        y = torch.where(it >= 2, y - (s.beta / torch.where(
            s.oldbeta == 0, one, s.oldbeta)).to(FC) * s.r1, y)
        alpha = kdotr(s.v, y) / s.beta
        y = y - (alpha / s.beta).to(FC) * s.r2

        # Direction w before the final 1/γ scaling.
        delta = s.cs * s.dbar + s.sn * alpha
        w_unscaled = s.v / beta_c - delta.to(FC) * s.w2 \
            - s.eps_prev.to(FC) * s.w1

        v_new = M_apply(y)
        beta_sq = kdotr(y, v_new)
        precond_violation = s.precond_violation | (beta_sq < 0)
        beta = torch.sqrt(torch.clamp(beta_sq, min=0))
        anorm2 = s.anorm2 + alpha * alpha + s.beta * s.beta + beta * beta

        # Rotation part 1 (old cs/sn).
        gbar = s.sn * s.dbar - s.cs * alpha
        eps_new = s.sn * beta
        dbar_new = -s.cs * beta
        root = torch.sqrt(gbar * gbar + dbar_new * dbar_new)
        ArNorm = s.phibar * root
        gamma = torch.clamp(torch.sqrt(gbar * gbar + beta * beta), min=eps_T)
        w = w_unscaled / gamma.to(FC)

        # Nonpositive-curvature check (reference :336-373).
        cgamma = s.cs * gbar
        if linesearch:
            zeta_km1 = s.zeta_k
            zeta_k = torch.where(it > 1, -cgamma * s.rNorm * s.rNorm,
                                 s.zeta_k)
            beta_w = torch.where(
                zeta_km1 != 0,
                zeta_k / torch.where(zeta_km1 == 0, one, zeta_km1), zeta_k)
            delta_w = torch.where(it > 1, zeta_k + beta_w * beta_w
                                  * s.delta_w, s.delta_w)
            npc_exit = cgamma >= 0
            npc_count = torch.where(
                npc_exit, torch.where((it > 1) & (delta_w < 0), 2, 1),
                s.npc_count).to(torch.int32)
        else:
            zeta_k, delta_w = s.zeta_k, s.delta_w
            npc_exit = torch.zeros((), dtype=torch.bool, device=dev)
            npc_count = s.npc_count

        # Rotation part 2.
        cs = gbar / gamma
        sn = beta / gamma
        phi = cs * s.phibar
        phibar = sn * s.phibar

        npc_dir = s.npc_dir
        if linesearch:
            npc_dir = (sn * sn).to(FC) * s.npc_dir \
                - (phibar * cs / beta).to(FC) * v_new
            # On npc exit keep the previous direction buffer.
            npc_dir = torch.where(npc_exit, s.npc_dir, npc_dir)

        x_new = s.x + phi.to(FC) * w
        xenorm2 = s.xenorm2 + phi * phi

        slot = torch.remainder(it, window).long().reshape(1)
        err_vec = s.err_vec.index_put((slot,), phi.reshape(1))
        err_lbnd = torch.linalg.vector_norm(err_vec)

        gmax = torch.maximum(s.gmax, gamma)
        gmin = torch.minimum(s.gmin, gamma)

        anorm = torch.sqrt(anorm2)
        xnorm = knorm(x_new)
        rNorm = phibar
        test1 = rNorm / torch.clamp(anorm * xnorm, min=tiny)
        test2 = root / torch.clamp(anorm, min=tiny)
        acond = gmax / torch.where(gmin == 0, t_(tiny), gmin)

        # iteration 1 early exit: Aᴴb ≈ 0 → x = 0 is a min least-squares
        # solution.
        min_lsq_early = (it == 1) & (beta / s.beta1 <= 10 * eps_T)

        ill_cond_mach = (1.0 + 1.0 / acond) <= 1.0
        solved_mach = (1.0 + test2) <= 1.0
        zero_resid_mach = (1.0 + test1) <= 1.0
        resid_decrease_mach = (rNorm + 1.0) <= 1.0

        ill_cond_lim = (1.0 / acond) <= ctol
        solved_lim = test2 <= s.eps_lim
        zero_resid_lim = (test1 <= eps_T) & MisI
        resid_decrease_lim = rNorm <= s.eps_lim
        fwd_err = (it >= window) & (err_lbnd <= etol * torch.sqrt(xenorm2))

        zero_resid = zero_resid_mach | zero_resid_lim
        resid_decrease = resid_decrease_mach | resid_decrease_lim
        solved = (solved_mach | solved_lim | zero_resid | fwd_err
                  | resid_decrease)

        # Status chain (reference :469-478, later assignment wins).
        code = _i32(rt.RUNNING, dev)
        for cond, c in ((ill_cond_mach, rt.ILL_COND_MACH),
                        (ill_cond_lim, rt.COND_EXCEEDED),
                        (solved, rt.SOLVED_LSQ),
                        (zero_resid, rt.SOLVED_ZERO), (fwd_err, rt.FWD_ERR),
                        (min_lsq_early, rt.MIN_LSQ_X), (npc_exit, rt.NPC)):
            code = torch.where(cond, c, code)

        # npc exit: x ← b when iter == 1, else keep x (reference :356-361).
        if linesearch:
            x_new = torch.where(npc_exit, torch.where(it == 1, b, s.x), x_new)

        rt.hist_write_masked(s.hist_r, active, it, rNorm, history)
        rt.hist_write_masked(s.hist_ar, active, it, ArNorm, history)
        rt.hist_write_masked(s.hist_acond, active, it, acond, history)

        s_new = s._replace(
            x=x_new, r1=s.r2, r2=y, v=v_new, w1=s.w2, w2=w, npc_dir=npc_dir,
            oldbeta=s.beta, beta=beta, dbar=dbar_new, eps_prev=eps_new,
            phibar=phibar, gmax=gmax, gmin=gmin, cs=cs, sn=sn,
            anorm2=anorm2, xenorm2=xenorm2, rNorm=rNorm, err_vec=err_vec,
            zeta_k=zeta_k, delta_w=delta_w, iter=it,
            status=code.to(torch.int32),
            indefinite=s.indefinite | npc_exit,
            inconsistent=min_lsq_early | ~zero_resid,
            npc_count=npc_count, precond_violation=precond_violation,
        )
        if callback is not None:
            user_exit = torch.as_tensor(callback(s_new), device=dev)
            s_new = s_new._replace(status=torch.where(
                user_exit, rt.USER_EXIT, s_new.status).to(torch.int32))
        if verbose > 0 and bool(active):
            rt.debug_row(
                verbose, it,
                "{:5d}  {:7.1e}  {:7.1e}  {:7.1e}  {:8.1e}  {:8.1e}  "
                "{:7.1e}  {:7.1e}  {:7.1e}  {:7.1e}",
                rNorm, ArNorm, beta, cs, sn, anorm, acond, test1, test2)
        return _masked(MinresState._fields, active, s_new, s, keep=_HIST)

    return rt.take_steps(body, state, steps, iter_cap, callback)


def _minres_solve(
    A, b, x0=None, *, M=None, ldiv=False, linesearch=False, lam=0.0,
    atol=None, rtol=None, etol=None, conlim=1.0e8, window=5,
    itmax=0, timemax=float("inf"), verbose=0, history=False, callback=None,
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
    etol = rt.default_tol(etol, T)
    itmax = rt.resolve_itmax(itmax, 2 * n)
    hist_len = itmax + 1 if history else 0

    if verbose > 0:
        rt.debug_header(verbose, f"MINRES: system of size {n}")
        rt.debug_header(
            verbose,
            f"{'k':>5s}  {'‖r‖':>7s}  {'‖Aᴴr‖':>7s}  {'β':>7s}  {'cos':>8s}"
            f"  {'sin':>8s}  {'‖A‖':>7s}  {'κ(A)':>7s}  {'test1':>7s}"
            f"  {'test2':>7s}")

    # Fast path: DIA stencil + default config → whole-solve kernel (M = I
    # or a diagonal/Jacobi centered preconditioner).
    diag_M = isinstance(M, DiagonalOperator)
    if ((M is None or diag_M) and not linesearch and callback is None
            and verbose == 0 and not history and timemax == float("inf")
            and _fused_ready(A, n, b.dtype, minres_dia_fused_supported)):
        ctol = 1.0 / conlim if conlim > 0 else 0.0
        b_eff = b if x0 is None else \
            b - (A.matvec(x0) + torch.tensor(lam, dtype=b.dtype,
                                             device=b.device) * x0)
        dinv = None
        if diag_M:
            dinv = (1.0 / M.d if ldiv else M.d).to(b.dtype).contiguous()
        x, niter, _, code_d, incon, viol = minres_dia_fused(
            A._pd, A._offsets, b_eff.contiguous(), atol, rtol, etol, ctol,
            float(lam), itmax, window=int(window), dinv=dinv)
        niter, code, incon, viol = torch.stack(
            [niter, code_d, incon, viol]).tolist()
        if viol:
            raise ValueError(
                "The linear operator `A` or the preconditioner `M` is not "
                "symmetric positive definite.")
        code = rt.final_status_code(code, niter, itmax, False)
        if code == rt.ZERO_RESIDUAL:
            niter = 1          # reference parity: src/minres.jl:219
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
        return _minres_core(
            A, M, b, x0, state, cap, steps, atol, rtol, etol,
            float(conlim), float(lam),
            ldiv=bool(ldiv), linesearch=bool(linesearch),
            history=bool(history), hist_len=hist_len, callback=callback,
            verbose=int(verbose), window=int(window), MisI=M is None,
        )

    state, overtimed = rt.drive(run, itmax, timemax, start)
    if bool(state.precond_violation):
        raise ValueError("Preconditioner is not positive definite")

    niter = int(state.iter)
    code = rt.final_status_code(state.status, niter, itmax, overtimed)
    if code == rt.ZERO_RESIDUAL:
        niter = 1  # reference parity: src/minres.jl:219

    x = state.x
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
        Acond=_trim(state.hist_acond, niter, history),
        timer=time.perf_counter() - start,
        status=rt.decode_status(code),
    )
    return x, stats, state


def minres(A, b, x0=None, *, precision=None, **kwargs):
    """x, stats = minres(A, b; ...) — Hermitian (indefinite) systems.

    ``precision="double_word"`` raises NotImplementedError until the
    iterative refinement (solvers/_refine.py, ROADMAP.md Queue 1
    item 8) is ported."""
    _no_double_word("MINRES", precision)
    x, stats, _ = _minres_solve(A, b, x0, **kwargs)
    return x, stats
