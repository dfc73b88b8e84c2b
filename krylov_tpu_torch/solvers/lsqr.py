"""LSQR: min ‖b − Ax‖ (+ λ regularisation) by Golub–Kahan bidiagonalisation.

Counterpart of ``krylov_tpu/solvers/lsqr.py`` and of reference
src/lsqr.jl: λ/sqd regularisation, M/N elliptic norms, the ``radius``
trust region, the Paige–Saunders stopping rules (axtol/btol/conlim/etol
and atol/rtol on ‖Aᴴr‖), the forward-error window, ``precision=
"compensated"`` (Dot2 reductions) and the status vocabulary of
src/lsqr.jl:414-423.  One A product and one Aᴴ product per iteration;
A may be rectangular or complex.  A DIA operator on the card with the
default options goes to a whole-solve kernel (ops/cuda_fused.py) on Aᴴ's
aligned diagonals; every other configuration runs ``_lsqr_core``, whose
iterations ``_runtime.drive`` takes in chunks with masked updates.

The Golub–Kahan step and the start shared with LSMR and LSLQ live here.
"""

import time
from typing import NamedTuple

import numpy as np
import torch

from .. import _runtime as rt
from .._dtypes import real_dtype
from ..operators import as_operator, precond_apply, solve_inputs
from ..ops.cuda_fused import lsqr_dia_fused, lsqr_dia_fused_supported
from ..ops.kops import kdotr, kdotr2, sym_givens, to_boundary
from ..stats import SimpleStats
from .bilq import _safe, _with_adjoint
from .cr import _fused_ready, _i32, _masked, _trim


def _ls_inputs(A, b, M, N, sqd, lam):
    """(A with its adjoint, b, M, N, m, n, λ) of a Golub–Kahan solve; sqd
    sets λ = 1 and refuses a λ of its own."""
    A, b, _, M = solve_inputs(A, b, None, M)
    A = _with_adjoint(A)
    N = as_operator(N, device=b.device)
    m, n = A.shape
    if b.shape[0] != m:
        raise ValueError("Inconsistent problem size")
    if sqd and lam != 0:
        raise ValueError("sqd cannot be set to true if λ ≠ 0 !")
    return A, b, M, N, m, n, 1.0 if sqd else lam


def _gk_start(A, b, M_apply, N_apply, kdotr_, MisI, NisI):
    """β₁u₁ = b and α₁v₁ = Aᴴu₁ in the M and N norms (reference
    src/lsqr.jl:253-273).  Returns (u, Mu, v, Nv, α₁, β₁, ⟨v, Nv⟩), the
    last before v is normalised."""
    Mu = b
    u = M_apply(Mu)
    beta1 = torch.sqrt(torch.clamp(kdotr_(u, Mu), min=0))
    sb = _safe(beta1).to(b.dtype)
    u = u / sb
    Mu = u if MisI else Mu / sb
    Nv = A.rmatvec(u)
    v = N_apply(Nv)
    alpha2 = kdotr_(v, Nv)
    alpha = torch.sqrt(torch.clamp(alpha2, min=0))
    sa = _safe(alpha).to(b.dtype)
    v = v / sa
    Nv = v if NisI else Nv / sa
    return u, Mu, v, Nv, alpha, beta1, alpha2


def _gk_step(A, s, M_apply, N_apply, kdotr_, MisI, NisI, FC):
    """One Golub–Kahan step from the state's u, Mu, v, Nv and α
    (krylov_tpu/solvers/lsqr.py:138-158): βu = Av − αu, then
    αv = Aᴴu − βv unless β = 0, each vector normalised only where its
    norm is not 0.  Returns (u, Mu, v, Nv, α, β, β ≠ 0)."""
    Mu = A.matvec(s.v) - s.alpha.to(FC) * s.Mu
    u = M_apply(Mu)
    beta = torch.sqrt(torch.clamp(kdotr_(u, Mu), min=0))
    bnz = beta != 0
    sb = _safe(beta).to(FC)
    u = torch.where(bnz, u / sb, u)
    Mu = u if MisI else torch.where(bnz, Mu / sb, Mu)
    Nv = torch.where(bnz, A.rmatvec(u) - beta.to(FC) * s.Nv, s.Nv)
    v = torch.where(bnz, N_apply(Nv), s.v)
    alpha = torch.where(bnz, torch.sqrt(torch.clamp(kdotr_(v, Nv), min=0)),
                        s.alpha)
    anz = bnz & (alpha != 0)
    sa = torch.where(anz, alpha, torch.ones_like(alpha)).to(FC)
    v = torch.where(anz, v / sa, v)
    Nv = v if NisI else torch.where(anz, Nv / sa, Nv)
    return u, Mu, v, Nv, alpha, beta, bnz


def _ls_status(tired, ill_cond_mach, ill_cond_lim, solved, zero_resid,
               fwd_err, on_boundary, dev):
    """The Paige–Saunders status chain (reference src/lsqr.jl:414-423, a
    later condition wins) shared by LSQR and LSMR."""
    code = _i32(rt.RUNNING, dev)
    for cond, c in ((tired, rt.TIRED), (ill_cond_mach, rt.ILL_COND_MACH),
                    (ill_cond_lim, rt.COND_EXCEEDED),
                    (solved, rt.SOLVED_LSQ),
                    (solved & zero_resid, rt.SOLVED_ZERO),
                    (solved & fwd_err, rt.FWD_ERR),
                    (solved & on_boundary, rt.ON_BOUNDARY)):
        code = torch.where(cond, c, code)
    return code.to(torch.int32)


def _user_exit(callback, s_new, dev):
    """A callback's exit overrides the step's status, as in the JAX
    package's Golub–Kahan cores."""
    user_exit = torch.as_tensor(callback(s_new), device=dev)
    return s_new._replace(status=torch.where(
        user_exit, rt.USER_EXIT, s_new.status).to(torch.int32))


def _ls_stats(cls, state, niter, code, history, start, **extra):
    """The stats of a Golub–Kahan solve's general route: ``inconsistent``
    from the last zero-residual test, cleared for the codes that settle
    it (krylov_tpu/solvers/lsqr.py:361-363)."""
    return cls(
        niter=niter, solved=rt.is_solved_code(code),
        inconsistent=_inconsistent(bool(state.zero_resid), code),
        residuals=_trim(state.hist_r, niter, history),
        Aresiduals=_trim(state.hist_ar, niter, history),
        timer=time.perf_counter() - start, status=rt.decode_status(code),
        **extra)


def _inconsistent(zero_resid, code):
    return not zero_resid and code not in (rt.ZERO_RESIDUAL, rt.MIN_LSQ_X)


class LsqrState(NamedTuple):
    x: torch.Tensor
    u: torch.Tensor
    Mu: torch.Tensor
    v: torch.Tensor
    Nv: torch.Tensor
    w: torch.Tensor
    alpha: torch.Tensor
    beta: torch.Tensor
    phibar: torch.Tensor
    rhobar: torch.Tensor
    anorm2: torch.Tensor
    dnorm2: torch.Tensor
    xnorm2: torch.Tensor
    res2: torch.Tensor
    c2: torch.Tensor
    s2: torch.Tensor
    zsc: torch.Tensor
    xenorm2: torch.Tensor
    err_vec: torch.Tensor
    rNorm: torch.Tensor
    ArNorm: torch.Tensor
    ArNorm0: torch.Tensor
    beta1: torch.Tensor
    iter: torch.Tensor
    status: torch.Tensor
    zero_resid: torch.Tensor
    hist_r: torch.Tensor
    hist_ar: torch.Tensor


def _lsqr_core(
    A, M, N, b, state_in, iter_cap, steps, itmax, lam, axtol, btol, atol,
    rtol, etol, conlim, radius,
    *, ldiv, history, hist_len, callback, verbose, window, use_radius,
    MisI, NisI, dot2=False,
):
    """``steps`` LSQR iterations from ``state_in`` (None: start), each with
    its updates masked by ``status == RUNNING and iter < iter_cap``
    (krylov_tpu/solvers/lsqr.py:61-268)."""
    # precision="compensated": Dot2 reductions for the Golub–Kahan norms
    kdotr_ = kdotr2 if dot2 else kdotr
    n = A.shape[1]
    FC = b.dtype
    T = real_dtype(FC)
    dev = b.device
    tiny = torch.finfo(T).tiny

    def t_(v):
        return torch.tensor(v, dtype=T, device=dev)

    zero, one = t_(0.0), t_(1.0)
    lam = t_(lam)
    lam2 = lam * lam
    radius = t_(radius)
    ctol = torch.where(t_(conlim) > 0, 1.0 / t_(conlim), zero)
    axtol, btol, atol, rtol, etol = map(t_, (axtol, btol, atol, rtol, etol))

    def M_apply(t):
        return precond_apply(M, t, ldiv)

    def N_apply(t):
        return precond_apply(N, t, ldiv)

    if state_in is None:
        u, Mu, v, Nv, alpha, beta1, anorm2 = _gk_start(
            A, b, M_apply, N_apply, kdotr_, MisI, NisI)
        ArNorm0 = alpha * beta1
        status = torch.where(beta1 == 0, rt.ZERO_RESIDUAL, torch.where(
            alpha == 0, rt.MIN_LSQ_X, rt.RUNNING))
        # the solved tests before the loop (reference :283-296)
        t2 = ArNorm0 / (torch.sqrt(torch.clamp(anorm2, min=tiny))
                        * _safe(beta1))
        solved0 = (t2 <= axtol) | ((1.0 + t2) <= 1.0)
        status = torch.where((status == rt.RUNNING) & solved0,
                             rt.SOLVED_LSQ, status).to(torch.int32)
        hr = rt.hist_write(rt.hist_init(hist_len, T, dev), _i32(0, dev),
                           beta1, history)
        har = rt.hist_write(rt.hist_init(hist_len, T, dev), _i32(0, dev),
                            ArNorm0, history)
        state_in = LsqrState(
            x=torch.zeros(n, dtype=FC, device=dev), u=u, Mu=Mu, v=v, Nv=Nv,
            w=v, alpha=alpha, beta=beta1, phibar=beta1, rhobar=alpha,
            anorm2=anorm2, dnorm2=zero, xnorm2=zero, res2=zero, c2=-one,
            s2=zero, zsc=zero, xenorm2=zero,
            err_vec=torch.zeros(window, dtype=T, device=dev), rNorm=beta1,
            ArNorm=ArNorm0, ArNorm0=ArNorm0, beta1=beta1, iter=_i32(0, dev),
            status=status,
            zero_resid=torch.zeros((), dtype=torch.bool, device=dev),
            hist_r=hr, hist_ar=har)

    def body(s):
        active = (s.status == rt.RUNNING) & (s.iter < iter_cap)
        it = s.iter + 1
        u, Mu, v, Nv, alpha, beta, bnz = _gk_step(A, s, M_apply, N_apply,
                                                  kdotr_, MisI, NisI, FC)
        anorm2 = torch.where(
            bnz, s.anorm2 + s.alpha * s.alpha + beta * beta
            + torch.where(lam > 0, lam2, zero), s.anorm2)

        # rotation 1 eliminates λ, rotation 2 eliminates β
        c1, s1, rhobar1 = sym_givens(s.rhobar, lam)
        psi = s1 * s.phibar
        phibar_mid = c1 * s.phibar
        c, sg, rho = sym_givens(rhobar1, beta)
        phi = c * phibar_mid
        phibar = sg * phibar_mid

        xenorm2 = s.xenorm2 + phi * phi
        err_vec = s.err_vec.index_put(((it % window).long().reshape(1),),
                                      phi.reshape(1))
        err_lbnd = torch.linalg.vector_norm(err_vec)

        tau = sg * phi
        theta = sg * alpha
        rhobar = -c * alpha
        safe_rho = _safe(rho)
        dnorm2 = s.dnorm2 + kdotr_(s.w, s.w) / (safe_rho * safe_rho)

        sigma = phi / safe_rho
        on_boundary = torch.zeros((), dtype=torch.bool, device=dev)
        if use_radius:
            t1b, t2b = to_boundary(s.x, s.w, radius)
            tmax = torch.maximum(t1b, t2b)
            tmin = torch.minimum(t1b, t2b)
            on_boundary = (sigma > tmax) | (sigma < tmin)
            sigma = torch.where(sigma > 0, torch.minimum(sigma, tmax),
                                torch.maximum(sigma, tmin))

        x = s.x + sigma.to(FC) * s.w
        w = v - (theta / safe_rho).to(FC) * s.w

        # the right rotation that estimates ‖x‖
        delta = s.s2 * rho
        gbar = -s.c2 * rho
        rhs = phi - delta * s.zsc
        zbar = rhs / _safe(gbar)
        xNorm = torch.sqrt(s.xnorm2 + zbar * zbar)
        c2, s2, gamma = sym_givens(gbar, theta)
        zsc = rhs / _safe(gamma)
        xnorm2 = s.xnorm2 + zsc * zsc

        anorm = torch.sqrt(anorm2)
        acond = anorm * torch.sqrt(dnorm2)
        res2 = s.res2 + psi * psi
        rNorm = torch.sqrt(phibar * phibar + res2)
        ArNorm = alpha * torch.abs(tau)

        test1 = rNorm / s.beta1
        test2 = ArNorm / torch.clamp(anorm * rNorm, min=tiny)
        test3 = 1.0 / torch.clamp(acond, min=tiny)
        t1 = test1 / (1.0 + anorm * xNorm / s.beta1)
        rNormtol = btol + axtol * anorm * xNorm / s.beta1

        ill_cond_mach = (1.0 + test3) <= 1.0
        zero_resid = ((1.0 + t1) <= 1.0) | (test1 <= rNormtol)
        fwd_err = (it >= window) & (err_lbnd <= etol * torch.sqrt(xenorm2))
        solved = (((1.0 + test2) <= 1.0) | (test2 <= axtol)
                  | (ArNorm <= atol + rtol * s.ArNorm0) | zero_resid
                  | fwd_err | on_boundary)
        code = _ls_status(it >= itmax, ill_cond_mach, test3 <= ctol, solved,
                          zero_resid, fwd_err, on_boundary, dev)

        rt.hist_write_masked(s.hist_r, active, it, rNorm, history)
        rt.hist_write_masked(s.hist_ar, active, it, ArNorm, history)
        s_new = s._replace(
            x=x, u=u, Mu=Mu, v=v, Nv=Nv, w=w, alpha=alpha, beta=beta,
            phibar=phibar, rhobar=rhobar, anorm2=anorm2, dnorm2=dnorm2,
            xnorm2=xnorm2, res2=res2, c2=c2, s2=s2, zsc=zsc,
            xenorm2=xenorm2, err_vec=err_vec, rNorm=rNorm, ArNorm=ArNorm,
            iter=it, status=code, zero_resid=zero_resid)
        if callback is not None:
            s_new = _user_exit(callback, s_new, dev)
        if verbose > 0 and bool(active):
            rt.debug_row(
                verbose, it,
                "{:5d}  {:7.1e}  {:7.1e}  {:7.1e}  {:7.1e}  {:7.1e}  "
                "{:7.1e}  {:7.1e}  {:7.1e}",
                alpha, beta, rNorm, ArNorm, test1, test2, anorm, acond)
        return _masked(LsqrState._fields, active, s_new, s)

    return rt.take_steps(body, state_in, steps, iter_cap, callback)


def _lsqr_solve(
    A, b, *, M=None, N=None, ldiv=False, sqd=False, lam=0.0, radius=0.0,
    axtol=None, btol=None, atol=0.0, rtol=0.0, etol=None, conlim=1.0e8,
    window=5, itmax=0, timemax=float("inf"), verbose=0, history=False,
    callback=None, precision=None,
):
    start = time.perf_counter()
    if precision not in (None, "working", "compensated"):
        raise ValueError(
            "lsqr precision must be None, 'working' or 'compensated'")
    A, b, M, N, m, n, lam = _ls_inputs(A, b, M, N, sqd, lam)
    T = real_dtype(b.dtype)
    axtol = rt.default_tol(axtol, T)
    btol = rt.default_tol(btol, T)
    etol = rt.default_tol(etol, T)
    itmax = rt.resolve_itmax(itmax, m + n)
    hist_len = itmax + 1 if history else 0
    rt.debug_header(verbose, f"LSQR: system of {m} equations in {n} variables")
    rt.debug_header(
        verbose,
        f"{'k':>5s}  {'α':>7s}  {'β':>7s}  {'‖r‖':>7s}  {'‖Aᴴr‖':>7s}  "
        f"{'compat':>7s}  {'backwrd':>7s}  {'‖A‖':>7s}  {'κ(A)':>7s}")

    # Fast path: DIA stencil + default config → whole-solve kernel.
    if (M is None and N is None and radius == 0 and not history
            and callback is None and verbose == 0
            and precision != "compensated" and timemax == float("inf")
            and _fused_ready(A, m, b.dtype, lsqr_dia_fused_supported)):
        pd_adj, ot_adj = A.aligned_adjoint_kernel_args()
        x, niter, _, _, code_d, zr = lsqr_dia_fused(
            A._pd, pd_adj, A._offsets, ot_adj, b.contiguous(), float(lam),
            axtol, btol, float(atol), float(rtol), etol, float(conlim),
            itmax, window=int(window))
        niter, code, zr = torch.stack([niter, code_d, zr]).tolist()
        code = rt.final_status_code(code, niter, itmax, False)
        stats = SimpleStats(
            niter=niter, solved=rt.is_solved_code(code),
            inconsistent=_inconsistent(bool(zr), code),
            residuals=np.zeros(0), Aresiduals=np.zeros(0),
            timer=time.perf_counter() - start,
            status=rt.decode_status(code))
        return x, stats, None

    def run(state, cap, steps):
        return _lsqr_core(
            A, M, N, b, state, cap, steps, itmax, float(lam), axtol, btol,
            float(atol), float(rtol), etol, float(conlim), float(radius),
            ldiv=bool(ldiv), history=bool(history), hist_len=hist_len,
            callback=callback, verbose=int(verbose), window=int(window),
            use_radius=bool(radius > 0), MisI=M is None, NisI=N is None,
            dot2=precision == "compensated")

    state, overtimed = rt.drive(run, itmax, timemax, start)
    niter = int(state.iter)
    code = rt.final_status_code(state.status, niter, itmax, overtimed)
    return state.x, _ls_stats(SimpleStats, state, niter, code, history,
                              start), state


def lsqr(A, b, *, precision=None, **kwargs):
    """x, stats = lsqr(A, b; λ, sqd, M, N, radius, ...).

    ``precision="compensated"`` runs the Golub–Kahan reductions as Dot2;
    ``precision="double_word"`` raises NotImplementedError until the
    iterative refinement (solvers/_refine.py, ROADMAP.md Queue 1 item 8)
    is ported."""
    if precision == "double_word":
        raise NotImplementedError(
            "precision='double_word' is not ported yet (ROADMAP.md Queue 1 "
            "item 8, solvers/_refine.py)")
    x, stats, _ = _lsqr_solve(A, b, precision=precision, **kwargs)
    return x, stats
