"""CR and CAR for Hermitian positive-definite Ax = b.

Counterpart of ``krylov_tpu/solvers/cr.py``.  CR (conjugate residuals)
with reference src/cr.jl's options: trust-region ``radius`` with the
full nonpositive-curvature case analysis (src/cr.jl:272-390),
``linesearch`` exits, the γ curvature tolerance, M preconditioning,
warm start, history, callback and verbose.  CAR (conjugate A-residuals,
minimises ‖Arₖ‖) mirrors reference src/car.jl.  A DIA operator with the
default options goes to a whole-solve kernel (ops/cuda_fused.py); every
other configuration runs the general core, whose iterations
``_runtime.drive`` takes in chunks with masked updates.
"""

import time
from typing import NamedTuple

import numpy as np
import torch

from .. import _runtime as rt
from .._dtypes import real_dtype, sqrt_eps
from ..operators import precond_apply, solve_inputs
from ..ops.cuda_fused import (NUMERICAL, ZERO_CURV_B, car_dia_fused,
                              car_dia_fused_supported, cr_dia_fused,
                              cr_dia_fused_supported)
from ..ops.kops import kdotr, knorm, roots_quadratic
from ..stats import SimpleStats

# CR-specific status codes, decoded as overrides of _runtime.BASE_STATUS
_CR_STATUS = {
    ZERO_CURV_B: "b is a zero-curvature direction",
    NUMERICAL: "solver encountered numerical issues",
}


class CrState(NamedTuple):
    x: torch.Tensor
    r: torch.Tensor
    p: torch.Tensor
    q: torch.Tensor
    Ar: torch.Tensor
    npc_dir: torch.Tensor
    rho: torch.Tensor
    quad: torch.Tensor    # quadratic model value m (verbose col, src/cr.jl:411)
    rNorm: torch.Tensor
    rNorm2: torch.Tensor
    pNorm: torch.Tensor
    pNorm2: torch.Tensor
    pr: torch.Tensor
    pAp: torch.Tensor
    xNorm: torch.Tensor
    ArNorm: torch.Tensor
    eps_lim: torch.Tensor
    descent: torch.Tensor
    iter: torch.Tensor
    status: torch.Tensor
    indefinite: torch.Tensor
    npc_count: torch.Tensor
    indef_error: torch.Tensor
    hist_r: torch.Tensor
    hist_ar: torch.Tensor


def _safe(x, pred):
    return torch.where(pred, torch.ones_like(x), x)


def _i32(v, device):
    return torch.tensor(v, dtype=torch.int32, device=device)


def _masked(fields, active, new, old, keep=("hist_r", "hist_ar")):
    """The state with ``new`` where ``active``; history buffers are
    written in place and carried as they are."""
    return type(old)(*(
        o if name in keep else torch.where(active, nw, o)
        for name, nw, o in zip(fields, new, old)))


def _cr_core(
    A, M, b, x0, state_in, iter_cap, steps, atol, rtol, radius, gamma_tol,
    *, ldiv, linesearch, history, hist_len, callback, verbose,
    use_radius, MisI,
):
    """``steps`` CR iterations from ``state_in`` (None: start), each with
    its updates masked by ``status == RUNNING and iter < iter_cap``."""
    n = b.shape[0]
    FC = b.dtype
    T = real_dtype(FC)
    dev = b.device
    eps_T = torch.finfo(T).eps
    sqeps = eps_T ** 0.5
    radius = torch.tensor(radius, dtype=T, device=dev)
    gamma_tol = torch.tensor(gamma_tol, dtype=T, device=dev)
    zero = torch.zeros((), dtype=T, device=dev)
    false = torch.zeros((), dtype=torch.bool, device=dev)
    npc_shape = (n,) if (linesearch or use_radius) else (0,)

    def M_apply(u):
        return precond_apply(M, u, ldiv)

    if state_in is None:
        x = torch.zeros(n, dtype=FC, device=dev)
        p0 = b if x0 is None else b - A.matvec(x0)
        r = M_apply(p0)
        rNorm = torch.sqrt(torch.clamp(kdotr(r, p0), min=0))
        Ar = A.matvec(r)
        rho = kdotr(r, Ar)
        eps_lim = torch.tensor(atol, dtype=T, device=dev) \
            + torch.tensor(rtol, dtype=T, device=dev) * rNorm
        zero_resid = rNorm == 0
        zero_curv = (~zero_resid) & (rho == 0)
        status = torch.where(
            zero_resid, rt.ZERO_RESIDUAL,
            torch.where(zero_curv, ZERO_CURV_B,
                        torch.where(rNorm <= eps_lim, rt.SOLVED,
                                    rt.RUNNING))).to(torch.int32)
        npc_dir = torch.zeros(npc_shape, dtype=FC, device=dev)
        indefinite = false
        npc_count = _i32(0, dev)
        if linesearch or use_radius:
            # On the zero-curvature init exit: x ← M⁻¹b, npc_dir ← M⁻¹b.
            x = torch.where(zero_curv, r, x)
            npc_dir = torch.where(zero_curv, r, npc_dir)
            indefinite = indefinite | zero_curv
            npc_count = torch.where(zero_curv, 1, npc_count).to(torch.int32)
        hr = rt.hist_init(hist_len, T, dev)
        rt.hist_write(hr, _i32(0, dev), rNorm, history)
        har = rt.hist_init(hist_len, T, dev)
        rt.hist_write(har, _i32(0, dev), torch.where(
            zero_resid | zero_curv, zero, knorm(Ar)), history)
        state = CrState(
            x=x, r=r, p=r, q=Ar, Ar=Ar, npc_dir=npc_dir,
            rho=rho, rNorm=rNorm, rNorm2=rNorm * rNorm,
            pNorm=rNorm, pNorm2=rNorm * rNorm,
            pr=rNorm * rNorm, pAp=rho, quad=zero,
            xNorm=zero, ArNorm=knorm(Ar), eps_lim=eps_lim,
            descent=rNorm * rNorm > 0,
            iter=_i32(0, dev), status=status,
            indefinite=indefinite, npc_count=npc_count,
            indef_error=false, hist_r=hr, hist_ar=har,
        )
    else:
        state = state_in

    def body(s):
        active = (s.status == rt.RUNNING) & (s.iter < iter_cap)
        code = _i32(rt.RUNNING, dev)
        x, p, q, npc_dir = s.x, s.p, s.q, s.npc_dir
        npc_count, indefinite = s.npc_count, s.indefinite
        on_boundary = false
        npcurv = false
        indef_error = s.indef_error

        # --- linesearch nonpositive-curvature exit (src/cr.jl:237-267) ---
        if linesearch:
            p_curv = s.pAp <= gamma_tol * s.pNorm * s.pNorm
            r_curv = s.rho <= gamma_tol * s.rNorm * s.rNorm
            ls_exit = p_curv | r_curv
            first = s.iter == 0
            npc_dir = torch.where(
                ls_exit, torch.where(first, p, torch.where(r_curv, s.r, p)),
                npc_dir)
            x = torch.where(ls_exit & first, p, x)
            add = torch.where(first, 1, r_curv.to(torch.int32)
                              + p_curv.to(torch.int32))
            npc_count = torch.where(ls_exit, npc_count + add,
                                    npc_count).to(torch.int32)
            indefinite = indefinite | ls_exit
            code = torch.where(ls_exit, rt.NPC, code).to(torch.int32)
        else:
            ls_exit = false
            if not use_radius:
                indef_error = indef_error | (s.pAp <= 0)

        # --- step selection ---
        if use_radius:
            xNorm2 = s.xNorm * s.xNorm
            t1_, t2_ = roots_quadratic(s.pNorm2, 2 * kdotr(x, p),
                                       xNorm2 - radius * radius)
            t1 = torch.maximum(t1_, t2_)
            t2 = torch.minimum(t1_, t2_)
            tr1, tr2 = roots_quadratic(s.rNorm2, 2 * kdotr(x, s.r),
                                       xNorm2 - radius * radius)
            tr = torch.maximum(tr1, tr2)

            qn = knorm(q)
            zero_pAp = torch.abs(s.pAp) <= gamma_tol * s.pNorm * qn
            zero_pr = torch.abs(s.pr) <= gamma_tol * s.pNorm * s.rNorm
            safe_rho = _safe(s.rho, s.rho == 0)

            # Candidate steps per case (src/cr.jl:272-390).
            alpha_desc = torch.where(s.descent, t1, t2)
            tr_cvx = torch.where(s.rho > 0,
                                 torch.minimum(tr, s.rNorm2 / safe_rho), tr)
            # case A: pᴴAp ≈ 0, pᴴr ≈ 0 → p := r
            aA = tr_cvx
            # case B: pᴴAp ≈ 0, pᴴr ≠ 0
            dB = -alpha_desc * s.pr + tr_cvx * s.rNorm2 \
                - tr_cvx * tr_cvx * s.rho / 2
            # case PN: pAp > 0, ρ < 0
            safe_pAp = _safe(s.pAp, s.pAp == 0)
            aPN = torch.where(s.descent, torch.minimum(t1, s.pr / safe_pAp),
                              torch.maximum(t2, s.pr / safe_pAp))

            def delta(al, trv):
                # Δ shared by PN/NP/NN with their tr variant
                return (-al * s.pr + trv * s.rNorm2
                        + (al * al * s.pAp - trv * trv * s.rho) / 2)

            Mq = M_apply(q)
            qMq = kdotr(q, Mq)
            aPP = s.rho / _safe(qMq, qMq == 0)
            pp_boundary = aPP >= t1

            casePP = (~zero_pAp) & (s.pAp > 0) & (s.rho > 0)
            casePN = (~zero_pAp) & (s.pAp > 0) & (s.rho < 0)
            caseNP = (~zero_pAp) & (s.pAp < 0) & (s.rho > 0)
            caseNN = (~zero_pAp) & (s.pAp < 0) & (s.rho < 0)

            # Redefinition decisions (Δ > 0 → follow r instead of p).
            redefA = zero_pAp & zero_pr
            redefB = zero_pAp & (~zero_pr) & (dB > 0)
            redefPN = casePN & (delta(aPN, tr) > 0)
            trNP = torch.minimum(tr, s.rNorm2 / safe_rho)
            redefNP = caseNP & (delta(alpha_desc, trNP) > 0)
            redefNN = caseNN & (delta(alpha_desc, tr) > 0)
            redef = redefA | redefB | redefPN | redefNP | redefNN

            alpha = torch.where(
                zero_pAp,
                torch.where(zero_pr, aA,
                            torch.where(dB > 0, tr_cvx, alpha_desc)),
                torch.where(
                    casePP, torch.where(pp_boundary, t1, aPP),
                    torch.where(
                        casePN, torch.where(redefPN, tr, aPN),
                        torch.where(caseNP,
                                    torch.where(redefNP, trNP, alpha_desc),
                                    torch.where(redefNN, tr, alpha_desc)))))
            on_boundary = casePP & pp_boundary
            npcurv = zero_pAp | casePN | caseNP | caseNN
            indefinite = indefinite | npcurv

            # npc_dir and count bookkeeping per case.
            npcA_two = redefA & (s.rho <= 0) & (s.iter > 0)
            new_npc_dir = torch.where(
                zero_pAp, torch.where(npcA_two, s.r, p),
                torch.where(casePN | caseNN, s.r, p))
            npc_dir = torch.where(npcurv, new_npc_dir, npc_dir)
            npc_count = torch.where(
                npcurv, torch.where(caseNN | npcA_two, 2, 1),
                npc_count).to(torch.int32)

            p_sel = torch.where(redef, s.r, p)
            q_sel = torch.where(redef, s.Ar, q)
        else:
            qMq = kdotr(q, M_apply(q))
            alpha = s.rho / _safe(qMq, qMq == 0)
            p_sel, q_sel = p, q

        Mq_sel = M_apply(q_sel)
        alpha_c = alpha.to(FC)
        x_new = x + alpha_c * p_sel
        xNorm = knorm(x_new)
        if use_radius:
            on_boundary = on_boundary | (
                torch.abs(xNorm - radius) <= sqeps * radius)
        r_new = s.r - alpha_c * Mq_sel
        if MisI:
            rNorm2 = kdotr(r_new, r_new)
            rNorm = torch.sqrt(rNorm2)
        else:
            omega = torch.sqrt(torch.abs(alpha)) \
                * torch.sqrt(torch.abs(s.rho))
            rNorm = torch.sqrt(torch.abs(s.rNorm + omega)) \
                * torch.sqrt(torch.abs(s.rNorm - omega))
            rNorm2 = rNorm * rNorm
        Ar_new = A.matvec(r_new)
        ArNorm = knorm(Ar_new)

        it = s.iter + 1
        resid_decrease = (rNorm <= s.eps_lim) | ((rNorm + 1.0) <= 1.0)
        solved = resid_decrease | npcurv | on_boundary

        # Continuation updates (skipped when exiting).
        rho_next = kdotr(r_new, Ar_new)
        beta = rho_next / _safe(s.rho, s.rho == 0)
        p_next = r_new + beta.to(FC) * p_sel
        q_next = Ar_new + beta.to(FC) * q_sel
        pNorm2_next = (rNorm2 + 2 * beta * s.pr - 2 * beta * alpha * s.pAp
                       + beta * beta * s.pNorm2)
        pnorm_bad = pNorm2_next <= -sqeps
        pNorm_next = torch.where(pNorm2_next > sqeps,
                                 torch.sqrt(torch.abs(pNorm2_next)), zero)
        pr_next = rNorm2 + beta * s.pr - beta * alpha * s.pAp
        pAp_next = rho_next + beta * beta * s.pAp

        exiting = solved | ls_exit
        # Status chain (src/cr.jl:460-466, later wins; boundary > npc).
        code = torch.where(solved, rt.SOLVED, code)
        code = torch.where(npcurv, rt.NPC, code)
        code = torch.where(on_boundary, rt.ON_BOUNDARY, code)
        code = torch.where(ls_exit, rt.NPC, code)
        code = torch.where((~exiting) & pnorm_bad, NUMERICAL,
                           code).to(torch.int32)

        # On ls_exit the x/r updates never happened (reference returns early).
        it_out = torch.where(ls_exit, s.iter, it)
        rNorm_out = torch.where(ls_exit, s.rNorm, rNorm)
        rt.hist_write_masked(s.hist_r, active, it_out, rNorm_out, history)
        rt.hist_write_masked(s.hist_ar, active, it_out, ArNorm, history)

        s_new = s._replace(
            x=torch.where(ls_exit, x, x_new),
            r=torch.where(ls_exit, s.r, r_new),
            p=torch.where(exiting, p_sel, p_next),
            q=torch.where(exiting, q_sel, q_next),
            Ar=torch.where(ls_exit, s.Ar, Ar_new), npc_dir=npc_dir,
            rho=torch.where(exiting, s.rho, rho_next),
            rNorm=rNorm_out, rNorm2=torch.where(ls_exit, s.rNorm2, rNorm2),
            pNorm=torch.where(exiting, s.pNorm, pNorm_next),
            pNorm2=torch.where(exiting, s.pNorm2, pNorm2_next),
            pr=torch.where(exiting, s.pr, pr_next),
            pAp=torch.where(exiting, s.pAp, pAp_next),
            quad=torch.where(ls_exit, s.quad, s.quad - alpha * s.pr
                             + alpha * alpha * s.pAp / 2),
            xNorm=torch.where(ls_exit, s.xNorm, xNorm),
            ArNorm=ArNorm,
            descent=torch.where(exiting, s.descent, pr_next > 0),
            iter=it_out, status=code,
            indefinite=indefinite, npc_count=npc_count,
            indef_error=indef_error,
        )
        if callback is not None:
            user_exit = torch.as_tensor(callback(s_new), device=dev)
            running_or_solved = (s_new.status == rt.RUNNING) \
                | (s_new.status == rt.SOLVED)
            s_new = s_new._replace(status=torch.where(
                user_exit & running_or_solved, rt.USER_EXIT,
                s_new.status).to(torch.int32))
        if verbose > 0 and bool(active):
            rt.debug_row(verbose, it_out, "{:5d}  {:8.1e}  {:8.1e}  {:8.1e}",
                         xNorm, rNorm_out, s_new.quad)
        return _masked(CrState._fields, active, s_new, s)

    return rt.take_steps(body, state, steps, iter_cap, callback)


def _trim(hist, niter, history):
    return rt.hist_trim(hist, niter) if history else np.zeros(0)


def _check_square(A, n):
    if A.shape is not None:
        if A.shape[0] != A.shape[1]:
            raise ValueError("System must be square")
        if A.shape[1] != n:
            raise ValueError("Inconsistent problem size")


def _fused_ready(A, n, dtype, supported):
    return (getattr(A, "use_kernel", False)
            and getattr(A, "_pd", None) is not None
            and supported(A.dia.offsets, n, dtype,
                          stencil_dtype=A._pd.dtype))


def _cr_solve(
    A, b, x0=None, *, M=None, ldiv=False, radius=0.0, linesearch=False,
    gamma_tol=None, atol=None, rtol=None, itmax=0, timemax=float("inf"),
    verbose=0, history=False, callback=None,
):
    start = time.perf_counter()
    A, b, x0, M = solve_inputs(A, b, x0, M)
    n = b.shape[0]
    _check_square(A, n)
    if linesearch and radius > 0:
        raise ValueError("`linesearch` set to `true` but trust-region radius > 0")
    if x0 is not None and linesearch:
        raise ValueError("warm_start and linesearch cannot be used together")

    T = real_dtype(b.dtype)
    atol = rt.default_tol(atol, T)
    rtol = rt.default_tol(rtol, T)
    gamma_tol = sqrt_eps(T) if gamma_tol is None else float(gamma_tol)
    itmax = rt.resolve_itmax(itmax, 2 * n)
    rt.debug_table(verbose, "CR", ("k", "‖x‖", "‖r‖", "quad"), n)
    hist_len = itmax + 1 if history else 0

    # Fast path: DIA stencil + default config → whole-solve kernel.
    if (M is None and not linesearch and radius == 0 and callback is None
            and verbose == 0 and not history and timemax == float("inf")
            and _fused_ready(A, n, b.dtype, cr_dia_fused_supported)):
        b_eff = (b if x0 is None else b - A.matvec(x0)).contiguous()
        x, niter, _, status, indef = cr_dia_fused(
            A._pd, A._offsets, b_eff, atol, rtol, itmax)
        niter, code, indef = torch.stack([niter, status, indef]).tolist()
        if indef:
            raise ValueError("Indefinite system and no trust region")
        code = rt.final_status_code(code, niter, itmax, False)
        if x0 is not None and code not in (rt.NPC, ZERO_CURV_B):
            x = x + x0
        stats = SimpleStats(
            niter=niter,
            solved=rt.is_solved_code(code) or code == ZERO_CURV_B,
            inconsistent=False, indefinite=False, npc_count=0,
            residuals=np.zeros(0),
            timer=time.perf_counter() - start,
            status=rt.decode_status(code, _CR_STATUS),
        )
        return x, stats, None

    def run(state, cap, steps):
        return _cr_core(
            A, M, b, x0, state, cap, steps, atol, rtol, float(radius),
            gamma_tol,
            ldiv=bool(ldiv), linesearch=bool(linesearch),
            history=bool(history), hist_len=hist_len, callback=callback,
            verbose=int(verbose), use_radius=bool(radius > 0),
            MisI=M is None,
        )

    state, overtimed = rt.drive(run, itmax, timemax, start)
    if bool(state.indef_error):
        raise ValueError("Indefinite system and no trust region")

    niter = int(state.iter)
    code = rt.final_status_code(state.status, niter, itmax, overtimed)
    x = state.x
    if x0 is not None and code not in (rt.NPC, ZERO_CURV_B):
        x = x + x0

    stats = SimpleStats(
        niter=niter,
        solved=rt.is_solved_code(code) or code == ZERO_CURV_B,
        inconsistent=False,
        indefinite=bool(state.indefinite),
        npc_count=int(state.npc_count),
        residuals=_trim(state.hist_r, niter, history),
        Aresiduals=_trim(state.hist_ar, niter, history),
        timer=time.perf_counter() - start,
        status=rt.decode_status(code, _CR_STATUS),
    )
    return x, stats, state


def _no_double_word(method, precision):
    if precision not in (None, "working", "double_word"):
        raise ValueError(f"precision must be one of (None, 'working', "
                         f"'double_word') for {method}")
    if precision == "double_word":
        raise NotImplementedError(
            "precision='double_word' is not ported yet (ROADMAP.md Queue 1 "
            "item 8, solvers/_refine.py)")


def cr(A, b, x0=None, *, precision=None, **kwargs):
    """x, stats = cr(A, b; ...) — conjugate residuals (Hermitian definite).

    ``precision="double_word"`` raises NotImplementedError until the
    iterative refinement (solvers/_refine.py, ROADMAP.md Queue 1
    item 8) is ported."""
    _no_double_word("CR", precision)
    x, stats, _ = _cr_solve(A, b, x0, **kwargs)
    return x, stats


# ---------------------------------------------------------------------------
# CAR (reference src/car.jl): minimises ‖Arₖ‖ over the Krylov subspace.
# ---------------------------------------------------------------------------

class CarState(NamedTuple):
    x: torch.Tensor
    r: torch.Tensor
    p: torch.Tensor
    s: torch.Tensor
    q: torch.Tensor
    t: torch.Tensor
    u: torch.Tensor
    rho: torch.Tensor
    rNorm: torch.Tensor
    ArNorm: torch.Tensor
    eps_lim: torch.Tensor
    iter: torch.Tensor
    status: torch.Tensor
    hist_r: torch.Tensor
    hist_ar: torch.Tensor


def _car_core(
    A, M, b, x0, state_in, iter_cap, steps, atol, rtol,
    *, ldiv, history, hist_len, callback, verbose, MisI,
):
    """``steps`` CAR iterations from ``state_in`` (None: start), each with
    its updates masked by ``status == RUNNING and iter < iter_cap``."""
    n = b.shape[0]
    FC = b.dtype
    T = real_dtype(FC)
    dev = b.device

    def M_apply(u):
        return precond_apply(M, u, ldiv)

    def ar_norm(r, u, s):
        if MisI:
            return knorm(s)
        return torch.sqrt(torch.clamp(kdotr(r, u), min=0))

    if state_in is None:
        r0 = b if x0 is None else b - A.matvec(x0)
        r = M_apply(r0)
        s = M_apply(A.matvec(r))
        t = A.matvec(s)
        rho = kdotr(t, s)
        rNorm = knorm(r)
        ArNorm = ar_norm(r, t, s)
        eps_lim = torch.tensor(atol, dtype=T, device=dev) \
            + torch.tensor(rtol, dtype=T, device=dev) * rNorm
        status = torch.where(
            rNorm == 0, rt.ZERO_RESIDUAL,
            torch.where(rNorm <= eps_lim, rt.SOLVED,
                        rt.RUNNING)).to(torch.int32)
        hr = rt.hist_init(hist_len, T, dev)
        rt.hist_write(hr, _i32(0, dev), rNorm, history)
        har = rt.hist_init(hist_len, T, dev)
        rt.hist_write(har, _i32(0, dev), ArNorm, history)
        state = CarState(torch.zeros(n, dtype=FC, device=dev), r, r, s, s,
                         t, t, rho, rNorm, ArNorm, eps_lim, _i32(0, dev),
                         status, hr, har)
    else:
        state = state_in

    def body(st):
        active = (st.status == rt.RUNNING) & (st.iter < iter_cap)
        Mu = M_apply(st.u)
        uMu = kdotr(st.u, Mu)
        alpha = st.rho / _safe(uMu, uMu == 0)
        ac = alpha.to(FC)
        x = st.x + ac * st.p
        r = st.r - ac * st.q
        s_v = st.s - ac * Mu
        rNorm = knorm(r)
        it = st.iter + 1
        solved = (rNorm <= st.eps_lim) | ((rNorm + 1.0) <= 1.0)

        t_v = A.matvec(s_v)
        rho_next = kdotr(t_v, s_v)
        beta = rho_next / _safe(st.rho, st.rho == 0)
        bc = beta.to(FC)
        p = torch.where(solved, st.p, r + bc * st.p)
        q = torch.where(solved, st.q, s_v + bc * st.q)
        u = torch.where(solved, st.u, t_v + bc * st.u)
        ArNorm = torch.where(solved, st.ArNorm, ar_norm(r, u, s_v))
        code = torch.where(solved, rt.SOLVED, rt.RUNNING).to(torch.int32)
        rt.hist_write_masked(st.hist_r, active, it, rNorm, history)
        rt.hist_write_masked(st.hist_ar, active, it, ArNorm, history)
        s_new = st._replace(
            x=x, r=r, p=p, s=s_v, q=q, t=t_v, u=u,
            rho=torch.where(solved, st.rho, rho_next),
            rNorm=rNorm, ArNorm=ArNorm, iter=it, status=code)
        if callback is not None:
            user_exit = torch.as_tensor(callback(s_new), device=dev)
            s_new = s_new._replace(status=torch.where(
                user_exit, rt.USER_EXIT, s_new.status).to(torch.int32))
        if verbose > 0 and bool(active):
            rt.debug_row(verbose, it,
                         "{:5d}  {:7.1e}  {:7.1e}  {:7.1e}  {:7.1e}",
                         rNorm, ArNorm, alpha, beta)
        return _masked(CarState._fields, active, s_new, st)

    return rt.take_steps(body, state, steps, iter_cap, callback)


def _car_solve(
    A, b, x0=None, *, M=None, ldiv=False, atol=None, rtol=None, itmax=0,
    timemax=float("inf"), verbose=0, history=False, callback=None,
):
    start = time.perf_counter()
    A, b, x0, M = solve_inputs(A, b, x0, M)
    n = b.shape[0]
    _check_square(A, n)
    T = real_dtype(b.dtype)
    atol = rt.default_tol(atol, T)
    rtol = rt.default_tol(rtol, T)
    itmax = rt.resolve_itmax(itmax, 2 * n)
    rt.debug_table(verbose, "CAR", ("k", "‖rₖ‖", "‖Arₖ‖", "α", "β"), n)
    hist_len = itmax + 1 if history else 0

    # Fast path: DIA stencil + default config → whole-solve kernel.
    if (M is None and callback is None and verbose == 0 and not history
            and timemax == float("inf")
            and _fused_ready(A, n, b.dtype, car_dia_fused_supported)):
        b_eff = (b if x0 is None else b - A.matvec(x0)).contiguous()
        x, niter, _, _, status = car_dia_fused(
            A._pd, A._offsets, b_eff, atol, rtol, itmax)
        niter, code = torch.stack([niter, status]).tolist()
        code = rt.final_status_code(code, niter, itmax, False)
        if x0 is not None:
            x = x + x0
        stats = SimpleStats(
            niter=niter,
            solved=rt.is_solved_code(code),
            inconsistent=False,
            residuals=np.zeros(0),
            Aresiduals=np.zeros(0),
            timer=time.perf_counter() - start,
            status=rt.decode_status(code),
        )
        return x, stats, None

    def run(state, cap, steps):
        return _car_core(
            A, M, b, x0, state, cap, steps, atol, rtol,
            ldiv=bool(ldiv), history=bool(history), hist_len=hist_len,
            callback=callback, verbose=int(verbose), MisI=M is None,
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
        Aresiduals=_trim(state.hist_ar, niter, history),
        timer=time.perf_counter() - start,
        status=rt.decode_status(code),
    )
    return x, stats, state


def car(A, b, x0=None, *, precision=None, **kwargs):
    """x, stats = car(A, b; ...) — minimises ‖Ar‖ (Hermitian definite).

    ``precision="double_word"`` raises NotImplementedError until the
    iterative refinement (solvers/_refine.py, ROADMAP.md Queue 1
    item 8) is ported."""
    _no_double_word("CAR", precision)
    x, stats, _ = _car_solve(A, b, x0, **kwargs)
    return x, stats
