"""GMRES and FGMRES for square non-Hermitian Ax = b.

Counterpart of ``krylov_tpu/solvers/gmres.py`` and of reference
src/gmres.jl / src/fgmres.jl: left and right preconditioning (M, N),
GMRES(k) restarts, the Givens QR of the Hessenberg, the singular-R
inconsistency test, breakdown detection (h_{k+1,k} ≤ eps^(3/4)), warm
start, history, callback and verbose.  As in the JAX package the
general route orthogonalises by classical Gram-Schmidt with a second
pass (CGS2, a third with ``reorthogonalization``) against the whole
(mem, n) panel, whose rows past the current one are zero within a
pass, and preallocates the basis at min(itmax, memory_cap) when
``restart`` is off.  Its products run under ``_runtime.full_fp32``; the
Hessenberg's rotations, R and the back substitution run on the host in
b's dtype, which reads one column of h per iteration.

A DIA operator with M = N = I and the default options goes to the
whole-solve kernel (ops/cuda_fused.py, sequential MGS as the TPU
kernel); FGMRES with N = I is the same iteration and goes there too.
``basis_dtype`` (bf16 or f16) stores that kernel's Krylov panel
compressed; off that route it raises ``ValueError``.
"""

import time
from typing import NamedTuple

import numpy as np
import torch

from .. import _runtime as rt
from .._dtypes import real_dtype
from ..operators import as_operator, precond_apply, solve_inputs
from ..ops.cuda_fused import gmres_dia_fused, gmres_dia_fused_supported
from ..ops.kops import knorm, sym_givens
from ..stats import SimpleStats
from .cr import _check_square, _fused_ready, _no_double_word, _trim


class GmresState(NamedTuple):
    x: torch.Tensor          # accumulated solution (origin 0, or x0)
    V: torch.Tensor          # (mem, n) Krylov basis
    Z: torch.Tensor          # (mem, n) flexible directions (fgmres) or (0,)
    R: torch.Tensor          # (mem, mem) upper-triangular factor, host
    c: torch.Tensor          # (mem,) Givens cosines (real), host
    s: torch.Tensor          # (mem,) Givens sines, host
    z: torch.Tensor          # (mem+1,) transformed rhs, host
    inner_k: int             # 0-based position in the current pass
    iter: int
    npass: int
    rNorm: float
    eps_lim: float
    status: int
    inconsistent: bool
    hist_r: torch.Tensor
    f_resid: bool            # the pass ended on the residual test
    f_break: bool            # the pass ended on a breakdown


def orthogonalize(V, q, extra_pass):
    """CGS2 (+ an optional third pass): project q against the rows of V
    (krylov_tpu/solvers/gmres.py:57-77).  Returns (q, h) with h on
    q's device."""
    h = torch.conj(V) @ q
    q = q - V.T @ h
    h2 = torch.conj(V) @ q
    q = q - V.T @ h2
    h = h + h2
    if extra_pass:
        h3 = torch.conj(V) @ q
        q = q - V.T @ h3
        h = h + h3
    return q, h


def back_substitute(R, z, k, btol=None, FC=None):
    """Solve R[:k, :k] y = z[:k] from the last row up, on the host; the
    result has R's length with zeros past k.  With ``btol`` a pivot of
    modulus ≤ btol gives yᵢ = 0 and sets the returned flag (reference
    src/gmres.jl:330-345); without it a zero pivot divides by 1 (FOM).
    Each yᵢ is rounded to ``FC`` (``fc_round``)."""
    Rn, zn = R.numpy(), z.numpy()
    y = np.zeros(R.shape[0], dtype=Rn.dtype)
    sing = False
    for i in reversed(range(k)):
        acc = zn[i] - np.sum(Rn[i, i + 1:k] * y[i + 1:k])
        diag = Rn[i, i]
        if btol is not None and abs(diag) <= btol:
            y[i] = 0
            sing = True
        else:
            y[i] = fc_round(acc / (1 if diag == 0 else diag), FC)
    return torch.from_numpy(y), sing


def arnoldi_drive(state, cap, steps, step, epilogue, callback):
    """Up to ``steps`` iterations of a restarted Arnoldi method from
    ``state``, the pass end included, as the JAX package's two-level
    loop runs them (krylov_tpu/solvers/gmres.py:_gmres_core).

    ``step(s)`` takes one Arnoldi iteration and returns (state,
    inner_done); ``epilogue(s)`` ends the pass: it back-substitutes,
    moves x, restarts or sets the status.  The host holds the scalars,
    so an iteration runs only while the solve does; a callback sees the
    state after every mid-pass iteration and after every pass end, and
    its exit takes effect while the solve runs."""
    for _ in range(steps):
        if state.status != rt.RUNNING or state.iter >= cap:
            break
        state, inner_done = step(state)
        if inner_done:
            state = epilogue(state)
        if callback is not None and bool(callback(state)) \
                and state.status == rt.RUNNING:
            state = state._replace(status=rt.USER_EXIT)
    return state


def first_basis(M_apply, w, mem):
    """V = [r/‖r‖; 0; ...] (mem rows) and ‖r‖ for r = M w."""
    r0 = M_apply(w)
    beta = knorm(r0)
    V = torch.zeros((mem, w.shape[0]), dtype=w.dtype, device=w.device)
    V[0] = r0 / torch.where(beta == 0, torch.ones_like(beta), beta).to(
        w.dtype)
    return V, float(beta)


def host_dtypes(FC):
    """numpy's (FC, T) for the scalars the host keeps.  numpy has no
    bfloat16, so a bf16 solve keeps them in float32 and rounds each to
    bf16 where the JAX core stores it in FC (``fc_round``)."""
    if FC == torch.bfloat16:
        return np.dtype(np.float32), np.dtype(np.float32)
    np_fc = torch.empty(0, dtype=FC).numpy().dtype
    return np_fc, np.empty(0, np_fc).real.dtype


def host_dtype(FC):
    """The torch dtype of the host's tensors of FC scalars (float32 for
    bfloat16, as ``host_dtypes``)."""
    return torch.float32 if FC == torch.bfloat16 else FC


def host_numpy(t):
    """A tensor's values on the host as numpy, in ``host_dtype``."""
    return t.cpu().to(host_dtype(t.dtype)).numpy()


def fc_round(v, FC):
    """v (a numpy scalar or array the host keeps for FC) rounded to FC
    where the host's type is wider (bfloat16 in float32); else v."""
    if FC != torch.bfloat16:
        return v
    r = torch.as_tensor(np.asarray(v, np.float32)).to(FC).float().numpy()
    return r if np.ndim(v) else np.float32(r)


def _gmres_core(
    A, M, N, b, x0, state_in, iter_cap, steps, itmax, atol, rtol,
    *, mem, ldiv, restart, flexible, reorthogonalization,
    history, hist_len, callback, verbose, NisI,
):
    """``steps`` GMRES iterations from ``state_in`` (None: start)."""
    n = b.shape[0]
    FC = b.dtype
    T = real_dtype(FC)
    dev = b.device
    btol = torch.finfo(T).eps ** 0.75
    np_fc, np_t = host_dtypes(FC)
    HC, HT = host_dtype(FC), host_dtype(T)

    def rnd(v):
        return fc_round(v, FC)

    def M_apply(u):
        return precond_apply(M, u, ldiv)

    def N_apply(u):
        return precond_apply(N, u, ldiv)

    if state_in is None:
        x = x0.clone() if (restart and x0 is not None) else \
            torch.zeros(n, dtype=FC, device=dev)
        V, beta = first_basis(M_apply, b if x0 is None else
                              b - A.matvec(x0), mem)
        eps_lim = float(np_t.type(atol) + np_t.type(rtol) * np_t.type(beta))
        status = (rt.ZERO_RESIDUAL if beta == 0
                  else rt.SOLVED if beta <= eps_lim else rt.RUNNING)
        z = torch.zeros(mem + 1, dtype=HC)
        z[0] = beta
        hist = rt.hist_init(hist_len, T, dev)
        rt.hist_write(hist, torch.tensor(0, device=dev),
                      torch.tensor(beta, dtype=T, device=dev), history)
        state_in = GmresState(
            x=x, V=V,
            Z=torch.zeros((mem, n) if flexible else (0,), dtype=FC,
                          device=dev),
            R=torch.zeros((mem, mem), dtype=HC),
            c=torch.zeros(mem, dtype=HT), s=torch.zeros(mem, dtype=HC),
            z=z, inner_k=0, iter=0, npass=1, rNorm=beta, eps_lim=eps_lim,
            status=status, inconsistent=False, hist_r=hist,
            f_resid=False, f_break=False)

    def step(s):
        k = s.inner_k
        p = N_apply(s.V[k])
        q = M_apply(A.matvec(p))
        q, hcol = orthogonalize(s.V, q, reorthogonalization)
        hbis = knorm(q)
        h = host_numpy(torch.cat([hcol, hbis.reshape(1).to(FC)]))
        hbis = h[mem].real.astype(np_t)
        c, sn, z, R = s.c.numpy(), s.s.numpy(), s.z.numpy(), s.R.numpy()
        # previous rotations Ω₀..Ω_{k-1} on the new column
        for i in range(k):
            hi, hi1 = h[i], h[i + 1]
            h[i] = rnd(c[i] * hi + sn[i] * hi1)
            h[i + 1] = rnd(np.conj(sn[i]) * hi - c[i] * hi1)
        ck, sk, rkk = sym_givens(torch.tensor(h[k]).to(FC),
                                 torch.tensor(hbis).to(FC))
        c[k], sn[k], h[k] = ck.real.item(), sk.item(), rkk.item()
        R[:k + 1, k] = h[:k + 1]
        zeta_next = rnd(np.conj(sn[k]) * z[k])
        z[k] = rnd(np_fc.type(c[k]) * z[k])
        rnorm = float(np.abs(zeta_next).astype(np_t))
        it, kk = s.iter + 1, k + 1
        resid = rnorm <= s.eps_lim or (np_t.type(rnorm) + 1) <= 1
        brk = bool(hbis <= btol)
        inner_done = resid or brk or it >= itmax or kk >= mem
        Z = s.Z
        if flexible:
            Z[k] = p
        V = s.V
        if not inner_done:
            V[kk % mem] = q / torch.tensor(1 if hbis == 0 else hbis,
                                           dtype=T).to(FC)
            z[kk] = zeta_next
        rt.hist_write(s.hist_r, torch.tensor(it, device=dev),
                      torch.tensor(rnorm, dtype=T, device=dev), history)
        if verbose > 0:
            rt.debug_row(verbose, it, "{:5d}  {:5.0f}  {:7.1e}  {:7.1e}",
                         s.npass, rnorm, float(hbis))
        return s._replace(V=V, Z=Z, inner_k=kk, iter=it, rNorm=rnorm,
                          f_resid=resid, f_break=brk), inner_done

    def epilogue(s):
        tired = s.iter >= itmax
        glob_done = s.f_resid or s.f_break or tired
        y, sing = back_substitute(s.R, s.z, s.inner_k, btol, FC)
        y = y.to(dev, FC)
        if flexible:
            xr = s.Z.T @ y
        else:
            xr = s.V.T @ y
            if not NisI:
                xr = N_apply(xr)
        x = s.x + xr
        inconsistent = s.inconsistent or sing
        out = dict(x=x, inner_k=0, inconsistent=inconsistent,
                   f_resid=False, f_break=False)
        if glob_done:
            code = rt.BREAKDOWN
            code = rt.TIRED if tired else code
            code = rt.SOLVED if s.f_resid else code
            out["status"] = rt.INCONSISTENT if inconsistent else code
        else:
            V, beta = first_basis(M_apply, b - A.matvec(x), mem)
            z = torch.zeros_like(s.z)
            z[0] = beta
            out.update(V=V, z=z, R=torch.zeros_like(s.R),
                       c=torch.zeros_like(s.c), s=torch.zeros_like(s.s),
                       npass=s.npass + 1, rNorm=beta)
        return s._replace(**out)

    return arnoldi_drive(state_in, iter_cap, steps, step, epilogue, callback)


def _gmres_like_solve(
    flexible, A, b, x0=None, *, M=None, N=None, ldiv=False, restart=False,
    reorthogonalization=False, memory=20, atol=None, rtol=None, itmax=0,
    timemax=float("inf"), verbose=0, history=False, callback=None,
    memory_cap=512, basis_dtype=None,
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
    rt.debug_table(verbose, "FGMRES" if flexible else "GMRES",
                   ("k", "pass", "‖rₖ‖", "hₖ₊₁.ₖ"), n)
    mem = min(int(memory), itmax) if restart else min(itmax, memory_cap)
    mem = max(mem, 1)
    hist_len = itmax + 1 if history else 0
    eff_restart = bool(restart) or mem < itmax

    # Fast path: DIA stencil + default config → whole-solve kernel.
    # FGMRES with N = I is the same iteration (its Z ring holds z = v).
    if (M is None and N is None and not history and callback is None
            and verbose == 0 and not reorthogonalization
            and timemax == float("inf")
            and _fused_ready(A, n, b.dtype, lambda *a, **k:
                             gmres_dia_fused_supported(
                                 *a, **k, basis_dtype=basis_dtype))):
        b_eff = (b if x0 is None else b - A.matvec(x0)).contiguous()
        x, niter, _, code_d, incons, _ = gmres_dia_fused(
            A._pd, A._offsets, b_eff, atol, rtol, itmax, mem, basis_dtype)
        niter, code, incons = torch.stack([niter, code_d, incons]).tolist()
        code = rt.final_status_code(code, niter, itmax, False)
        if x0 is not None:
            x = x + x0
        stats = SimpleStats(
            niter=niter,
            solved=rt.is_solved_code(code),
            inconsistent=bool(incons),
            residuals=np.zeros(0),
            timer=time.perf_counter() - start,
            status=rt.decode_status(code),
        )
        return x, stats, None

    if basis_dtype is not None:
        raise ValueError(
            "basis_dtype (compressed-basis GMRES) is a fused-path feature: "
            "it requires a DIA-stencil operator with use_kernel=True, "
            "M = N = None, no history/callback/verbose/timemax, and a "
            "kernel for the panel's dtype")

    def run(state, cap, steps):
        return _gmres_core(
            A, M, N, b, x0, state, cap, steps, itmax, atol, rtol,
            mem=mem, ldiv=bool(ldiv), restart=eff_restart,
            flexible=bool(flexible),
            reorthogonalization=bool(reorthogonalization),
            history=bool(history), hist_len=hist_len, callback=callback,
            verbose=int(verbose), NisI=N is None,
        )

    state, overtimed = rt.drive(run, itmax, timemax, start)
    niter = state.iter
    code = rt.final_status_code(state.status, niter, itmax, overtimed)
    x = state.x
    if x0 is not None and not eff_restart:
        x = x + x0
    stats = SimpleStats(
        niter=niter,
        solved=rt.is_solved_code(code),
        inconsistent=bool(state.inconsistent),
        residuals=_trim(state.hist_r, niter, history),
        timer=time.perf_counter() - start,
        status=rt.decode_status(code),
    )
    return x, stats, state


def gmres(A, b, x0=None, *, precision=None, **kwargs):
    """x, stats = gmres(A, b; memory=20, restart=False, ...).

    ``basis_dtype=torch.bfloat16`` (or float16) stores the Krylov panel
    of the whole-solve kernel compressed, with the arithmetic in b's
    dtype.  ``precision="double_word"`` raises NotImplementedError until
    the iterative refinement (solvers/_refine.py, ROADMAP.md Queue 1
    item 8) is ported."""
    _no_double_word("GMRES", precision)
    x, stats, _ = _gmres_like_solve(False, A, b, x0, **kwargs)
    return x, stats


def fgmres(A, b, x0=None, *, precision=None, **kwargs):
    """x, stats = fgmres(A, b; ...) — flexible right preconditioning.

    ``precision="double_word"`` raises NotImplementedError until the
    iterative refinement (ROADMAP.md Queue 1 item 8) is ported."""
    _no_double_word("FGMRES", precision)
    x, stats, _ = _gmres_like_solve(True, A, b, x0, **kwargs)
    return x, stats
