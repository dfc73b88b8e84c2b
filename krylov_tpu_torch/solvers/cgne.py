"""CGNE and CRMR: minimum-norm solutions of consistent Ax = b.

Counterpart of ``krylov_tpu/solvers/cgne.py`` and of reference
src/cgne.jl (CG on AAᴴy = b with x = Aᴴy; the "system probably
inconsistent" exit on ‖p‖) and src/crmr.jl (CR on AAᴴ; the exit on
‖Aᴴr‖): λ regularisation through the s vector, the N preconditioner
(applied or divided by), and the status vocabulary of both.  A may be
rectangular or complex.  A DIA operator on the card with the default
options goes to one whole-solve kernel for both (ops/cuda_fused.py);
every other configuration runs ``_cgne_like_core`` in chunks of masked
steps.
"""

import functools
import time
from typing import NamedTuple

import numpy as np
import torch

from .. import _runtime as rt
from .._dtypes import real_dtype
from ..operators import precond_apply
from ..ops.cuda_fused import (INCONS_CGNE, INCONS_CRMR, cgne_crmr_dia_fused,
                              cgne_crmr_dia_fused_supported)
from ..ops.kops import kdotr, knorm
from ..stats import SimpleStats
from .bilq import _exit, _safe
from .cr import _fused_ready, _i32, _masked, _no_double_word, _trim
from .lsqr import _ls_inputs

_STATUS = {
    INCONS_CGNE: "system probably inconsistent",
    INCONS_CRMR: "system probably inconsistent but least squares/norm "
                 "solution found",
}


class CgneState(NamedTuple):
    x: torch.Tensor
    r: torch.Tensor
    p: torch.Tensor
    s: torch.Tensor
    gamma: torch.Tensor
    rNorm: torch.Tensor
    pNorm: torch.Tensor
    eps_c: torch.Tensor
    eps_i: torch.Tensor
    iter: torch.Tensor
    status: torch.Tensor
    hist_r: torch.Tensor


def _cgne_like_core(
    A, N, b, state_in, iter_cap, steps, atol, rtol, lam,
    *, ldiv, history, hist_len, callback, verbose, variant,
):
    """``steps`` CGNE or CRMR (``variant``) iterations from ``state_in``
    (None: start), each with its updates masked by ``status == RUNNING
    and iter < iter_cap`` (krylov_tpu/solvers/cgne.py:54-155)."""
    n = A.shape[1]
    FC = b.dtype
    T = real_dtype(FC)
    dev = b.device
    cgne = variant == "cgne"
    incons_code = INCONS_CGNE if cgne else INCONS_CRMR
    zero = torch.zeros((), dtype=T, device=dev)
    lam = torch.tensor(lam, dtype=T, device=dev)
    lam_eff = torch.where(lam > 0, lam, zero)

    def N_apply(t):
        return precond_apply(N, t, ldiv)

    if state_in is None:
        r = b
        z = N_apply(r)
        rNorm = knorm(r)
        if cgne:
            p = A.rmatvec(z)
            gamma = kdotr(r, z)
            indNorm = knorm(p)
        else:
            p = A.rmatvec(r)
            gamma = kdotr(p, p) + lam_eff * rNorm * rNorm
            indNorm = torch.sqrt(gamma)
        eps_c = atol + rtol * rNorm
        eps_i = atol + rtol * indNorm
        status = torch.where(rNorm == 0, rt.ZERO_RESIDUAL, torch.where(
            rNorm <= eps_c, rt.SOLVED, torch.where(
                (rNorm > 100 * eps_c) & (indNorm <= eps_i), incons_code,
                rt.RUNNING)))
        hr = rt.hist_write(rt.hist_init(hist_len, T, dev), _i32(0, dev),
                           rNorm, history)
        state_in = CgneState(
            x=torch.zeros(n, dtype=FC, device=dev), r=r, p=p, s=r,
            gamma=gamma, rNorm=rNorm, pNorm=indNorm, eps_c=eps_c,
            eps_i=eps_i, iter=_i32(0, dev), status=status.to(torch.int32),
            hist_r=hr)

    def body(s):
        active = (s.status == rt.RUNNING) & (s.iter < iter_cap)
        q = A.matvec(s.p) + lam_eff.to(FC) * s.s
        if cgne:
            delta = kdotr(s.p, s.p) + lam_eff * kdotr(s.s, s.s)
            alpha = s.gamma / _safe(delta)
            x = s.x + alpha.to(FC) * s.p
            r = s.r - alpha.to(FC) * q
            z = N_apply(r)
            gamma = kdotr(r, z)
            beta = gamma / _safe(s.gamma)
            p = A.rmatvec(z) + beta.to(FC) * s.p
            indNorm = knorm(p)
            rNorm = torch.sqrt(torch.clamp(gamma, min=0))
        else:
            Nq = N_apply(q)
            alpha = s.gamma / _safe(kdotr(q, Nq))
            x = s.x + alpha.to(FC) * s.p
            r = s.r - alpha.to(FC) * Nq
            rNorm = knorm(r)
            Ahr = A.rmatvec(r)
            gamma = kdotr(Ahr, Ahr) + lam_eff * rNorm * rNorm
            beta = gamma / _safe(s.gamma)
            p = Ahr + beta.to(FC) * s.p
            indNorm = torch.sqrt(torch.clamp(gamma, min=0))
        it = s.iter + 1
        solved = (rNorm <= s.eps_c) | ((rNorm + 1.0) <= 1.0)
        inconsistent = (rNorm > 100 * s.eps_c) & (indNorm <= s.eps_i)
        code = torch.where(solved, rt.SOLVED, torch.where(
            inconsistent, incons_code, rt.RUNNING)).to(torch.int32)
        rt.hist_write_masked(s.hist_r, active, it, rNorm, history)
        # the s ring takes part only when λ > 0 (harmless otherwise)
        s_new = s._replace(x=x, r=r, p=p, s=r + beta.to(FC) * s.s,
                           gamma=gamma, rNorm=rNorm, pNorm=indNorm, iter=it,
                           status=code)
        if verbose > 0 and bool(active):
            if cgne:
                rt.debug_row(verbose, it, "{:5d}  {:8.1e}", rNorm)
            else:
                rt.debug_row(verbose, it, "{:5d}  {:8.1e}  {:8.1e}", indNorm,
                             rNorm)
        if callback is not None:
            s_new = _exit(callback, s_new, dev)
        return _masked(CgneState._fields, active, s_new, s)

    return rt.take_steps(body, state_in, steps, iter_cap, callback)


def _cgne_like_solve(
    variant, A, b, *, N=None, ldiv=False, lam=0.0, atol=None, rtol=None,
    itmax=0, timemax=float("inf"), verbose=0, history=False, callback=None,
):
    start = time.perf_counter()
    A, b, _, N, m, n, lam = _ls_inputs(A, b, None, N, False, lam)
    T = real_dtype(b.dtype)
    atol = rt.default_tol(atol, T)
    rtol = rt.default_tol(rtol, T)
    itmax = rt.resolve_itmax(itmax, m + n)
    rt.debug_table(verbose, variant.upper(),
                   ("k", "‖Aᴴr‖", "‖r‖") if variant == "crmr"
                   else ("k", "‖r‖"), m, n)
    hist_len = itmax + 1 if history else 0

    # Fast path: DIA stencil + default config → whole-solve kernel.
    if (N is None and not history and callback is None and verbose == 0
            and timemax == float("inf")
            and _fused_ready(A, m, b.dtype, cgne_crmr_dia_fused_supported)):
        pd_adj, ot_adj = A.aligned_adjoint_kernel_args()
        x, niter, _, code_d = cgne_crmr_dia_fused(
            A._pd, pd_adj, A._offsets, ot_adj, b.contiguous(), float(lam),
            atol, rtol, itmax, variant=variant)
        niter, code = torch.stack([niter, code_d]).tolist()
        code = rt.final_status_code(code, niter, itmax, False)
        stats = SimpleStats(
            niter=niter, solved=rt.is_solved_code(code),
            inconsistent=code in (INCONS_CGNE, INCONS_CRMR),
            residuals=np.zeros(0), timer=time.perf_counter() - start,
            status=rt.decode_status(code, _STATUS))
        return x, stats, None

    def run(state, cap, steps):
        return _cgne_like_core(
            A, N, b, state, cap, steps, atol, rtol, float(lam),
            ldiv=bool(ldiv), history=bool(history), hist_len=hist_len,
            callback=callback, verbose=int(verbose), variant=variant)

    state, overtimed = rt.drive(run, itmax, timemax, start)
    niter = int(state.iter)
    code = rt.final_status_code(state.status, niter, itmax, overtimed)
    stats = SimpleStats(
        niter=niter, solved=rt.is_solved_code(code),
        inconsistent=code in (INCONS_CGNE, INCONS_CRMR),
        residuals=_trim(state.hist_r, niter, history),
        timer=time.perf_counter() - start,
        status=rt.decode_status(code, _STATUS))
    return state.x, stats, state


_cgne_solve = functools.partial(_cgne_like_solve, "cgne")
_crmr_solve = functools.partial(_cgne_like_solve, "crmr")


def cgne(A, b, *, precision=None, **kwargs):
    """x, stats = cgne(A, b; λ, N, ...) — minimum-norm solution.

    ``precision="double_word"`` raises NotImplementedError until the
    iterative refinement (solvers/_refine.py, ROADMAP.md Queue 1 item 8)
    is ported."""
    _no_double_word("CGNE", precision)
    x, stats, _ = _cgne_solve(A, b, **kwargs)
    return x, stats


def crmr(A, b, *, precision=None, **kwargs):
    """x, stats = crmr(A, b; λ, N, ...) — minimum-norm solution.

    ``precision="double_word"`` raises NotImplementedError until the
    iterative refinement (solvers/_refine.py, ROADMAP.md Queue 1 item 8)
    is ported."""
    _no_double_word("CRMR", precision)
    x, stats, _ = _crmr_solve(A, b, **kwargs)
    return x, stats
