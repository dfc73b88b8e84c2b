"""Block MINRES for multiple right-hand sides AX = B, A Hermitian.

Counterpart of the block MINRES half of ``krylov_tpu/solvers/block.py``
and of reference src/block_minres.jl:95-317: the O(1)-memory
block-tridiagonal recurrence of the block Lanczos process, its
normalisations by QR, the reflections Θₖ as complete 2p × 2p QR factors
applied by products, and the direction blocks Wₖ = (Vₖ − Wₖ₋₁Γₖ₋₁ −
Wₖ₋₂Πₖ₋₂)Λₖ⁻¹.  A DIA operator on the card with a real B of at most 8
columns, no callback, history, verbose or finite timemax goes to a
whole-solve kernel (ops/cuda_fused.py) when B − AX₀ has full rank;
every other configuration runs the general core, whose iterations
``_runtime.drive`` takes in chunks with masked updates.  Block GMRES,
the other half of the JAX module, is ROADMAP.md Queue 1 item 7b.
"""

import time
from typing import NamedTuple

import numpy as np
import torch

from .. import _runtime as rt
from .._dtypes import real_dtype
from ..operators import as_operator
from ..ops.cuda_fused import (block_minres_dia_fused,
                              block_minres_dia_fused_supported)
from ..stats import SimpleStats
from .bilq import _exit
from .cr import _i32, _masked, _no_double_word, _trim
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


def _stats(code, niter, start, residuals=None):
    """The SimpleStats of a block MINRES solve."""
    return SimpleStats(
        niter=niter, solved=rt.is_solved_code(code), inconsistent=False,
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
