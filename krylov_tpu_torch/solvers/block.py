"""Block MINRES and block GMRES for multiple right-hand sides AX = B.

Counterpart of ``krylov_tpu/solvers/block.py`` and of reference
src/block_minres.jl:95-317 and src/block_gmres.jl.

Block MINRES is the O(1)-memory block-tridiagonal recurrence of the block
Lanczos process, its normalisations by QR, the reflections Θₖ as
complete 2p × 2p QR factors applied by products, and the direction blocks
Wₖ = (Vₖ − Wₖ₋₁Γₖ₋₁ − Wₖ₋₂Πₖ₋₂)Λₖ⁻¹.

Block GMRES keeps the (mem+1)-panel basis, orthogonalises by block CGS2
(a third pass with ``reorthogonalization``), normalises by CholQR2 with a
NaN-safe breakdown test, and factors the block Hessenberg incrementally
through the accumulated orthogonal factor Qacc (one 2p × p complete QR
per iteration); Y is back-solved once per pass, and the pass end checks
its claim on the true residual B − AX: confirmed (solved), progress
(restart), or no progress (stop).  ``memory`` applies with ``restart``;
without it the basis holds min(itmax, memory_cap) panels.

A DIA operator on the card with a real B of at most 8 columns (and, for
block GMRES, mem ≥ 2 and mem·p ≤ 128), no M or N, callback, history,
verbose, reorthogonalization or finite timemax goes to a whole-solve
kernel (ops/cuda_fused.py) when B − AX₀ has full rank; every other
configuration runs the general core, whose iterations ``_runtime.drive``
takes in chunks, under ``_runtime.full_fp32``.
"""

import time
from typing import NamedTuple

import numpy as np
import torch

from .. import _runtime as rt
from .._dtypes import real_dtype
from ..operators import as_operator, precond_apply
from ..ops.cuda_fused import (block_gmres_dia_fused,
                              block_gmres_dia_fused_supported,
                              block_minres_dia_fused,
                              block_minres_dia_fused_supported)
from ..stats import SimpleStats
from .bilq import _exit
from .cr import _i32, _masked, _no_double_word, _trim
from .gmres import host_dtypes
from .usymlq import _tol


class BlockMinresState(NamedTuple):
    X: torch.Tensor          # (n, p)
    Vkm1: torch.Tensor       # (n, p)
    Vk: torch.Tensor         # (n, p)
    w_km2: torch.Tensor      # (n, p)
    w_km1: torch.Tensor      # (n, p)
    Psi_k: torch.Tensor      # (p, p) the subdiagonal block Ψₖ
    Phibar: torch.Tensor     # (p, p) Φbarₖ
    Q2_km2: torch.Tensor     # (2p, 2p) the reflection Θₖ₋₂
    Q2_km1: torch.Tensor     # (2p, 2p) the reflection Θₖ₋₁
    rNorm: torch.Tensor
    eps_lim: torch.Tensor
    iter: torch.Tensor
    status: torch.Tensor
    hist_r: torch.Tensor


def _block_minres_core(
    A, B, X0, state_in, iter_cap, steps, atol, rtol,
    *, history, hist_len, callback, verbose,
):
    """``steps`` block MINRES iterations from ``state_in`` (None: start),
    each with its updates masked by ``status == RUNNING and iter <
    iter_cap`` (krylov_tpu/solvers/block.py:493-591)."""
    n, p = B.shape
    FC = B.dtype
    T = real_dtype(FC)
    dev = B.device
    zp = torch.zeros((p, p), dtype=FC, device=dev)

    if state_in is None:
        R0 = B if X0 is None else B - A.matmat(X0)
        V1, Gamma = torch.linalg.qr(R0)
        beta = torch.linalg.norm(Gamma)
        eps_lim = _tol(atol, T, dev) + _tol(rtol, T, dev) * beta
        status = torch.where(beta == 0, rt.ZERO_RESIDUAL, torch.where(
            beta <= eps_lim, rt.SOLVED, rt.RUNNING)).to(torch.int32)
        zb = torch.zeros((n, p), dtype=FC, device=dev)
        eye = torch.eye(2 * p, dtype=FC, device=dev)
        state_in = BlockMinresState(
            X=zb, Vkm1=zb, Vk=V1, w_km2=zb, w_km1=zb, Psi_k=zp, Phibar=Gamma,
            Q2_km2=eye, Q2_km1=eye, rNorm=beta, eps_lim=eps_lim,
            iter=_i32(0, dev), status=status,
            hist_r=rt.hist_write(rt.hist_init(hist_len, T, dev),
                                 _i32(0, dev), beta, history))

    def body(s):
        active = (s.status == rt.RUNNING) & (s.iter < iter_cap)
        it = s.iter + 1
        # the block Lanczos step
        Q = A.matmat(s.Vk)
        Omega = s.Vk.mH @ Q
        Q = torch.where(it >= 2, Q - s.Vkm1 @ s.Psi_k.mH, Q)
        Q = Q - s.Vk @ Omega

        PsiH = s.Psi_k.mH
        # Θₖ₋₂ applied to [0; Ψₖᴴ] (it ≥ 3)
        st2 = s.Q2_km2.mH @ torch.cat([zp, PsiH])
        Pi_km2 = torch.where(it >= 3, st2[:p], zp)
        Gbar_mid = torch.where(it >= 3, st2[p:], PsiH)
        # Θₖ₋₁ applied to [Γbarₖ₋₁; Ωₖ] (it ≥ 2)
        st1 = s.Q2_km1.mH @ torch.cat([Gbar_mid, Omega])
        Gamma_km1 = torch.where(it >= 2, st1[:p], zp)
        Lambda_bar = torch.where(it >= 2, st1[p:], Omega)

        # Vₖ₊₁ and Ψₖ₊₁ from the QR of Q
        Vkp1, Psi_kp1 = torch.linalg.qr(Q)
        # the reflection Θₖ: the complete QR of [Λbarₖ; Ψₖ₊₁]
        Q2, R2 = torch.linalg.qr(torch.cat([Lambda_bar, Psi_kp1]),
                                 mode="complete")
        Lambda_k = R2[:p]
        # [Φₖ; Φbarₖ₊₁] = Θₖᴴ [Φbarₖ; 0]
        z = Q2.mH @ torch.cat([s.Phibar, zp])
        Phi_k, Phibar_kp1 = z[:p], z[p:]

        # wₖ = (Vₖ − wₖ₋₁Γₖ₋₁ − wₖ₋₂Πₖ₋₂) Λₖ⁻¹, a zero pivot read as 1
        Wnum = s.Vk - s.w_km1 @ Gamma_km1 - s.w_km2 @ Pi_km2
        diag = torch.diagonal(Lambda_k)
        Lsafe = Lambda_k + torch.diag((diag == 0).to(FC))
        w_k = torch.linalg.solve_triangular(Lsafe, Wnum, upper=True,
                                            left=False)

        X = s.X + w_k @ Phi_k
        rNorm = torch.linalg.norm(Phibar_kp1)
        solved = (rNorm <= s.eps_lim) | ((rNorm + 1.0) <= 1.0)
        code = torch.where(solved, rt.SOLVED, rt.RUNNING).to(torch.int32)
        rt.hist_write_masked(s.hist_r, active, it, rNorm, history)
        s_new = s._replace(
            X=X, Vkm1=s.Vk, Vk=Vkp1, w_km2=s.w_km1, w_km1=w_k,
            Psi_k=Psi_kp1, Phibar=Phibar_kp1, Q2_km2=s.Q2_km1, Q2_km1=Q2,
            rNorm=rNorm, iter=it, status=code)
        if verbose > 0 and bool(active):
            rt.debug_row(verbose, it, "{:5d}  {:7.1e}", rNorm)
        if callback is not None:
            s_new = _exit(callback, s_new, dev)
        return _masked(BlockMinresState._fields, active, s_new, s)

    return rt.take_steps(body, state_in, steps, iter_cap, callback)


def _full_rank(B_eff, T):
    """The JAX package's probe (krylov_tpu/solvers/block.py:629-633): every
    |diag R| of a QR of B − AX₀ above eps^¾ · max(max |diag R|, 1).  The
    QR runs in IEEE fp32 for f32, as the JAX package's under
    ``default_matmul_precision("highest")``."""
    with rt.full_fp32():
        Rdiag = torch.abs(torch.diagonal(torch.linalg.qr(B_eff,
                                                         mode="r").R))
    lim = float(torch.finfo(T).eps) ** 0.75
    return bool(torch.all(Rdiag > lim * torch.clamp(torch.max(Rdiag),
                                                    min=1.0)))


def _block_minres_solve(
    A, B, X0=None, *, M=None, ldiv=False, atol=None, rtol=None, itmax=0,
    timemax=float("inf"), verbose=0, history=False, callback=None, p=None,
):
    """Solves AX = B (krylov_tpu/solvers/block.py:594-671); ``p``, a block
    workspace's width (``BlockMinresWorkspace(n, n, dtype, p=4)``), must
    be B's."""
    start = time.perf_counter()
    if M is not None:
        raise ValueError("Block-MINRES doesn't support preconditioning yet.")
    A = as_operator(A, device=B.device if isinstance(B, torch.Tensor)
                    else None)
    B = rt.as_device_tensor(B, A)
    if p is not None and p != B.shape[1]:
        raise ValueError(f"B has {B.shape[1]} columns, the workspace {p}")
    n, p = B.shape
    if A.shape is not None and A.shape[0] != A.shape[1]:
        raise ValueError("System must be square")
    if X0 is not None:
        X0 = rt.as_device_tensor(X0, B).to(B.dtype)
    T = real_dtype(B.dtype)
    atol = rt.default_tol(atol, T)
    rtol = rt.default_tol(rtol, T)
    itmax = rt.resolve_itmax(itmax, max(2 * (n // p), 2))
    rt.debug_table(verbose, "BLOCK-MINRES", ("k", "‖Rₖ‖"), n)
    hist_len = itmax + 1 if history else 0

    # Fast path: DIA stencil + default config → whole-solve kernel, for a
    # block B − AX₀ of full rank (a rank-deficient block takes the general
    # core, as in the JAX package)
    if (callback is None and verbose == 0 and not history
            and timemax == float("inf")
            and getattr(A, "use_kernel", False)
            and getattr(A, "_pd", None) is not None
            and block_minres_dia_fused_supported(
                A.dia.offsets, n, p, B.dtype, stencil_dtype=A._pd.dtype)):
        B_eff = B if X0 is None else B - A.matmat(X0)
        if _full_rank(B_eff, T):
            X, niter, _, code_d = block_minres_dia_fused(
                A._pd, A._offsets, B_eff.contiguous(), atol, rtol, itmax)
            niter, code = torch.stack([niter, code_d]).tolist()
            code = rt.final_status_code(code, niter, itmax, False)
            if X0 is not None:
                X = X + X0
            return X, _stats(code, niter, start), None

    def run(state, cap, steps):
        return _block_minres_core(
            A, B, X0, state, cap, steps, atol, rtol, history=bool(history),
            hist_len=hist_len, callback=callback, verbose=int(verbose))

    state, overtimed = rt.drive(run, itmax, timemax, start)
    niter = int(state.iter)
    code = rt.final_status_code(state.status, niter, itmax, overtimed)
    X = state.X if X0 is None else state.X + X0
    return X, _stats(code, niter, start, _trim(state.hist_r, niter,
                                                history)), state


def _stats(code, niter, start, residuals=None, incons=False):
    """The SimpleStats of a block solve."""
    return SimpleStats(
        niter=niter, solved=rt.is_solved_code(code), inconsistent=incons,
        residuals=np.zeros(0) if residuals is None else residuals,
        timer=time.perf_counter() - start, status=rt.decode_status(code))


def block_minres(A, B, X0=None, *, precision=None, **kwargs):
    """X, stats = block_minres(A, B; ...): Hermitian A, several right-hand
    sides, O(1) memory.

    ``precision="double_word"`` raises NotImplementedError until the
    iterative refinement (solvers/_refine.py, ROADMAP.md Queue 1 item 8)
    is ported."""
    _no_double_word("BLOCK-MINRES", precision)
    X, stats, _ = _block_minres_solve(A, B, X0, **kwargs)
    return X, stats


# ---------------------------------------------------------------------------
# block GMRES
# ---------------------------------------------------------------------------

class BlockState(NamedTuple):
    X: torch.Tensor          # (n, p) the solution (from X₀)
    V: torch.Tensor          # (mem+1, p, n) the block basis, panel by panel
    R: torch.Tensor          # ((mem+1)p, mem·p) the transformed Hessenberg
    g: torch.Tensor          # ((mem+1)p, p) the transformed rhs Qᴴ E₁Γ
    Qacc: torch.Tensor       # ((mem+1)p, (mem+1)p) the accumulated QR factor
    inner_k: int             # panels of the current pass
    iter: int
    rNorm: float
    eps_lim: float
    status: int
    hist_r: torch.Tensor
    f_resid: bool            # the pass ended on the residual estimate
    f_break: bool            # the pass ended on a breakdown
    pass_beta: float         # the true residual at the pass's start
    npass: int               # 1-based pass count (the verbose column)


def _solve_Y(R, g, k, mem, p):
    """Y of the pass after k panels: the triangle R[:kp, :kp] against
    g[:kp], the other columns held at the identity (krylov_tpu/solvers/
    block.py:49-66)."""
    cols = mem * p
    cidx = torch.arange(cols, device=R.device)
    cmask = cidx < k * p
    act = cmask[:, None] & cmask[None, :]
    Rsq = torch.where(act, R[:cols], torch.zeros((), dtype=R.dtype,
                                                 device=R.device)) \
        + ((~cmask)[:, None] & (cidx[:, None] == cidx[None, :])).to(R.dtype)
    g_m = torch.where(cmask[:, None], g[:cols], torch.zeros(
        (), dtype=g.dtype, device=g.device))
    return torch.linalg.solve_triangular(Rsq, g_m, upper=True)


def _chol_upper(G):
    """The upper Cholesky factor of G, NaN where G is not (numerically)
    positive definite, as the JAX package's ``jnp.linalg.cholesky``."""
    R, info = torch.linalg.cholesky_ex(G, upper=True)
    return torch.where(info == 0, R, torch.full_like(R, float("nan")))


def _block_core(
    A, M, N, B, X0, state_in, iter_cap, steps, itmax, atol, rtol,
    *, mem, ldiv, reorthogonalization, history, hist_len, callback, verbose,
):
    """``steps`` block GMRES iterations from ``state_in`` (None: start),
    pass ends included (krylov_tpu/solvers/block.py:69-354).  The host
    reads each iteration's stop flags; a callback sees the state after
    every iteration (its exit holds mid-pass) and again after every pass
    end."""
    n, p = B.shape
    FC = B.dtype
    T = real_dtype(FC)
    dev = B.device
    np_fc, np_t = host_dtypes(FC)
    btol = float(torch.finfo(T).eps) ** 0.75
    rows = (mem + 1) * p

    def M_apply(W):
        return precond_apply(M, W, ldiv) if (M is None or ldiv) \
            else M.matmat(W)

    def N_apply(W):
        return precond_apply(N, W, ldiv) if (N is None or ldiv) \
            else N.matmat(W)

    def init_pass(X):
        R0 = M_apply(B - A.matmat(X))
        V1, Gamma = torch.linalg.qr(R0)
        V = torch.zeros((mem + 1, p, n), dtype=FC, device=dev)
        V[0] = V1.T
        rhs = torch.zeros((rows, p), dtype=FC, device=dev)
        rhs[:p] = Gamma
        return V, rhs, np_t.type(torch.linalg.norm(Gamma).item())

    if state_in is None:
        X = torch.zeros((n, p), dtype=FC, device=dev) if X0 is None \
            else X0.clone()
        V, rhs, beta = init_pass(X)
        eps_lim = np_t.type(atol) + np_t.type(rtol) * beta
        status = (rt.ZERO_RESIDUAL if beta == 0
                  else rt.SOLVED if beta <= eps_lim else rt.RUNNING)
        hist = rt.hist_init(hist_len, T, dev)
        rt.hist_write(hist, torch.tensor(0, device=dev),
                      torch.tensor(float(beta), dtype=T, device=dev),
                      history)
        state_in = BlockState(
            X=X, V=V, R=torch.zeros((rows, mem * p), dtype=FC, device=dev),
            g=rhs, Qacc=torch.eye(rows, dtype=FC, device=dev), inner_k=0,
            iter=0, rNorm=beta, eps_lim=eps_lim, status=status,
            hist_r=hist, f_resid=False, f_break=False, pass_beta=beta,
            npass=1)

    def cgs_pass(Vm, W):
        H = Vm.conj() @ W
        return H, W - Vm.T @ H

    def step(s):
        k = s.inner_k
        W = M_apply(A.matmat(N_apply(s.V[k].T)))
        # block CGS2 over the basis (its panels past k are 0 in a pass)
        Vm = s.V[:mem].reshape(mem * p, n)
        Hcol, W = cgs_pass(Vm, W)
        H2, W = cgs_pass(Vm, W)
        Hcol = Hcol + H2
        if reorthogonalization:
            H3, W = cgs_pass(Vm, W)
            Hcol = Hcol + H3
        # CholQR2; a rank-deficient panel NaNs the Cholesky, and a
        # breakdown commits a zero panel and a zero subdiagonal block
        R1 = _chol_upper(W.mH @ W)
        Q1 = torch.linalg.solve_triangular(R1, W, upper=True, left=False)
        R2 = _chol_upper(Q1.mH @ Q1)
        Vn = torch.linalg.solve_triangular(R2, Q1, upper=True, left=False)
        Hk1 = R2 @ R1
        hbis = torch.linalg.norm(Hk1).item()
        if not np.isfinite(hbis):
            Hk1, hbis, Vn = torch.zeros_like(Hk1), 0.0, torch.zeros_like(Vn)
        # the incremental block QR: Qaccᴴ on the new column block, then one
        # 2p × p complete QR eliminates the subdiagonal block
        Hfull = torch.zeros((rows, p), dtype=FC, device=dev)
        Hfull[:rows - p] = Hcol
        Hfull[(k + 1) * p:(k + 2) * p] = Hk1
        Z = s.Qacc.mH @ Hfull
        Qs, Rs = torch.linalg.qr(Z[k * p:(k + 2) * p], mode="complete")
        Z[k * p:(k + 2) * p] = Rs
        s.R[:, k * p:(k + 1) * p] = Z
        s.g[k * p:(k + 2) * p] = Qs.mH @ s.g[k * p:(k + 2) * p]
        s.Qacc[:, k * p:(k + 2) * p] = s.Qacc[:, k * p:(k + 2) * p] @ Qs
        kk, it = k + 1, s.iter + 1
        rnorm = np_t.type(torch.linalg.norm(
            s.g[kk * p:(kk + 1) * p]).item())
        resid = bool(rnorm <= s.eps_lim or rnorm + np_t.type(1) <= 1)
        brk = not hbis > btol
        inner_done = resid or brk or it >= itmax or kk >= mem
        s.V[k + 1] = Vn.T
        rt.hist_write(s.hist_r, torch.tensor(it, device=dev),
                      torch.tensor(float(rnorm), dtype=T, device=dev),
                      history)
        out = s._replace(inner_k=kk, iter=it, rNorm=rnorm, f_resid=resid,
                         f_break=brk)
        # the reference's columns (src/block_gmres.jl:181): pass, k, ‖R‖;
        # the cadence follows the iteration count
        rt.debug_row_vals(verbose, it, "{:5d}  {:5d}  {:7.1e}", out.npass,
                          it, float(rnorm))
        return out, inner_done

    def epilogue(s):
        """X += N V Y; the true residual confirms the pass's claim
        (solved), or shows progress (restart), or none (stop)."""
        tired = s.iter >= itmax
        Y = _solve_Y(s.R, s.g, s.inner_k, mem, p)
        XR = N_apply(s.V[:mem].reshape(mem * p, n).T @ Y)
        X = s.X + XR
        Vr, rhsr, beta_r = init_pass(X)
        true_conv = beta_r <= s.eps_lim
        progress = beta_r <= np_t.type(0.9) * s.pass_beta
        claimed = s.f_resid or s.f_break
        glob_done = tired or true_conv or (claimed and not progress)
        code = rt.BREAKDOWN
        code = rt.TIRED if tired else code
        code = rt.SOLVED if true_conv else code
        code = rt.RUNNING if not glob_done else code
        out = s._replace(X=X, inner_k=0, rNorm=beta_r, status=code,
                         f_resid=False, f_break=False)
        if not glob_done:
            out = out._replace(
                V=Vr, g=rhsr, R=torch.zeros_like(s.R),
                Qacc=torch.eye(rows, dtype=FC, device=dev),
                pass_beta=beta_r, npass=s.npass + 1)
        return out

    state = state_in
    for _ in range(steps):
        if state.status != rt.RUNNING or state.iter >= iter_cap:
            break
        state, inner_done = step(state)
        if callback is not None and bool(callback(state)) \
                and not inner_done:
            state = state._replace(status=rt.USER_EXIT)
        if inner_done:
            state = epilogue(state)
            if callback is not None and bool(callback(state)) \
                    and state.status == rt.RUNNING:
                state = state._replace(status=rt.USER_EXIT)
    return state


def _block_gmres_solve(
    A, B, X0=None, *, M=None, N=None, ldiv=False, restart=False,
    reorthogonalization=False, memory=5, atol=None, rtol=None, itmax=0,
    timemax=float("inf"), verbose=0, history=False, callback=None,
    memory_cap=128, basis_dtype=None, p=None,
):
    """Solves AX = B (krylov_tpu/solvers/block.py:357-461); ``p``, a block
    workspace's width, must be B's."""
    start = time.perf_counter()
    A = as_operator(A, device=B.device if isinstance(B, torch.Tensor)
                    else None)
    B = rt.as_device_tensor(B, A)
    if p is not None and p != B.shape[1]:
        raise ValueError(f"B has {B.shape[1]} columns, the workspace {p}")
    M = as_operator(M, device=B.device)
    N = as_operator(N, device=B.device)
    n, p = B.shape
    if A.shape is not None and A.shape[0] != A.shape[1]:
        raise ValueError("System must be square")
    if X0 is not None:
        X0 = rt.as_device_tensor(X0, B).to(B.dtype)
    T = real_dtype(B.dtype)
    atol = rt.default_tol(atol, T)
    rtol = rt.default_tol(rtol, T)
    itmax = rt.resolve_itmax(itmax, max(2 * (n // p), 2))
    rt.debug_table(verbose, "BLOCK-GMRES", ("pass", "k", "‖Rₖ‖"), n)
    mem = min(int(memory), itmax) if restart else min(itmax, memory_cap)
    mem = max(mem, 2)
    hist_len = itmax + 1 if history else 0

    # Fast path: DIA stencil + default config → whole-solve kernel, for a
    # block B − AX₀ of full rank (a rank-deficient block takes the general
    # core, whose Householder QR completes it, as in the JAX package)
    if (M is None and N is None and not reorthogonalization
            and callback is None and verbose == 0 and not history
            and timemax == float("inf")
            and getattr(A, "use_kernel", False)
            and getattr(A, "_pd", None) is not None
            and block_gmres_dia_fused_supported(
                A.dia.offsets, n, p, B.dtype, mem,
                stencil_dtype=A._pd.dtype, basis_dtype=basis_dtype)):
        B_eff = B if X0 is None else B - A.matmat(X0)
        if _full_rank(B_eff, T):
            X, niter, _, code_d, incons, _ = block_gmres_dia_fused(
                A._pd, A._offsets, B_eff.contiguous(), atol, rtol, itmax,
                mem, basis_dtype)
            niter, code, incons = torch.stack([niter, code_d,
                                               incons]).tolist()
            code = rt.final_status_code(code, niter, itmax, False)
            if X0 is not None:
                X = X + X0
            return X, _stats(code, niter, start, incons=bool(incons)), None

    if basis_dtype is not None:
        raise ValueError(
            "basis_dtype (compressed-basis block-GMRES) is a fused-path "
            "feature: it requires a DIA-stencil operator with "
            "use_kernel=True, a full-rank rhs block, M = N = None, no "
            "history/callback/verbose/timemax/reorthogonalization, and a "
            "kernel for the basis's dtype (B's own or bfloat16)")

    def run(state, cap, steps):
        return _block_core(
            A, M, N, B, X0, state, cap, steps, itmax, atol, rtol, mem=mem,
            ldiv=bool(ldiv), reorthogonalization=bool(reorthogonalization),
            history=bool(history), hist_len=hist_len, callback=callback,
            verbose=int(verbose))

    state, overtimed = rt.drive(run, itmax, timemax, start)
    niter = state.iter
    code = rt.final_status_code(state.status, niter, itmax, overtimed)
    return state.X, _stats(code, niter, start, _trim(state.hist_r, niter,
                                                      history)), state


def block_gmres(A, B, X0=None, *, precision=None, **kwargs):
    """X, stats = block_gmres(A, B; memory=5, restart, M, N, ...): several
    right-hand sides, the (mem+1)-panel block Arnoldi basis.

    ``basis_dtype=torch.bfloat16`` stores the whole-solve kernel's basis
    compressed, with the arithmetic in B's dtype.
    ``precision="double_word"`` raises NotImplementedError until the
    iterative refinement (solvers/_refine.py, ROADMAP.md Queue 1 item 8)
    is ported."""
    _no_double_word("BLOCK-GMRES", precision)
    X, stats, _ = _block_gmres_solve(A, B, X0, **kwargs)
    return X, stats
