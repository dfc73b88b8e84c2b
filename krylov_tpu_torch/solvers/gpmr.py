"""GPMR for generalized partitioned systems [λI A; B μI][x; y] = [b; c].

Counterpart of ``krylov_tpu/solvers/gpmr.py`` and of reference
src/gpmr.jl: the only method that applies two independent operators, A
(m × n) and B (n × m); the four preconditioners C, D, E and F (the CAF
and DBE splits, applied or divided by); the block scalars λ and μ (``gsp``
sets λ = 1, μ = 0); the orthogonal Hessenberg reduction of the
Montoison–Orban process with classical Gram–Schmidt (and an optional
second pass), a cascade of four reflections per iteration, and the
inconsistency test of the back substitution on R.  The basis holds
min(itmax, memory_cap) slots, as the JAX package's (its ``memory`` is
read but does not size the basis: gpmr.py:366).  Square DIA operators A
and B on the card with a real b, no preconditioner, warm start or
second pass and the default options go to a whole-solve kernel
(ops/cuda_fused.py) when the basis has at most 64 slots; every other
configuration runs the general core, whose iterations
``_runtime.drive`` takes in chunks with masked updates, then the back
substitution on the host.
"""

import time
from typing import NamedTuple

import numpy as np
import torch

from .. import _runtime as rt
from .._dtypes import real_dtype
from ..operators import as_operator, precond_apply
from ..ops.cuda_fused import (_back_substitute_ref, gpmr_dia_fused,
                              gpmr_dia_fused_supported)
from ..ops.kops import knorm, sym_givens
from ..stats import SimpleStats
from .bilq import _exit, _safe
from .cr import _i32, _masked, _no_double_word, _trim
from .usymlq import _tol


class GpmrState(NamedTuple):
    V: torch.Tensor           # (mem + 1, m)
    U: torch.Tensor           # (mem + 1, n)
    R: torch.Tensor           # (2 mem + 2, 2 mem) columns of the QR factor
    zt: torch.Tensor          # (2 mem + 2,)
    gc: torch.Tensor          # (4 mem,)
    gs: torch.Tensor          # (4 mem,)
    rNorm: torch.Tensor
    eps_lim: torch.Tensor
    iter: torch.Tensor
    status: torch.Tensor
    hist_r: torch.Tensor


def _prefix_compose(M, d):
    """Inclusive prefix of the affine maps v ↦ Mᵢ v + dᵢ (M (mem, 2, 2), d
    (mem, 2)): entry i is the composition of maps 0..i, map i applied
    last; log₂(mem) doubling steps, the counterpart of the JAX package's
    ``lax.associative_scan``."""
    mem = M.shape[0]
    off = 1
    while off < mem:
        Mp, dp = M[:-off], d[:-off]
        Mq, dq = M[off:], d[off:]
        M = torch.cat([M[:off], Mq @ Mp])
        d = torch.cat([d[:off], (Mq @ dp[..., None])[..., 0] + dq])
        off *= 2
    return M, d


def _apply_quad_rotations(col_o, col_e, gc, gs, k, mem):
    """The stored reflection quadruples i = 1..k−1 applied to the two new
    columns of Sₖ₊₁.ₖ (krylov_tpu/solvers/gpmr.py:45-135, reference
    src/gpmr.jl:381-409).

    Step i rotates rows (2i−1, 2i, 2i+1, 2i+2) with (c1..c4, s1..s4); the
    pair it leaves at rows (2i+1, 2i+2) is what step i+1 reads first, so
    the chain is the 2-vector affine recurrence carry' = Mᵢ carry + dᵢ
    (Mᵢ from the quadruple, dᵢ from the column's original rows 2i+1 and
    2i+2), run as a prefix composition."""
    FC = col_o.dtype
    dev = col_o.device
    rows = col_o.shape[0] // 2          # mem + 1
    i0 = torch.arange(mem, device=dev)
    act = (i0 + 1) <= (k - 1)
    one = torch.ones((), dtype=FC, device=dev)
    zero = torch.zeros((), dtype=FC, device=dev)
    c1, c2, c3, c4 = (gc[4 * i0 + j].to(FC) for j in range(4))
    s1, s2, s3, s4 = (gs[4 * i0 + j] for j in range(4))
    cj = torch.conj
    a_r2b_r1 = c3 * cj(s2) * c1 + s3 * cj(s1)
    a_r2b_r2 = -c3 * c2
    b_r2b_r4 = c3 * cj(s2) * s1 - s3 * c1
    m00 = cj(s4) * a_r2b_r1
    m01 = cj(s4) * a_r2b_r2
    m10 = cj(s3) * cj(s2) * c1 - c3 * cj(s1)
    m11 = -cj(s3) * c2
    b_r4b_r4 = cj(s3) * cj(s2) * s1 + c3 * c1
    o1_r1 = c2 * c1
    o1_r2 = s2
    o1_r4 = c2 * s1
    o2_r1 = c4 * a_r2b_r1
    o2_r2 = c4 * a_r2b_r2
    o2_r3 = s4
    o2_r4 = c4 * b_r2b_r4
    M = torch.stack([
        torch.stack([torch.where(act, m00, one), torch.where(act, m01, zero)],
                    -1),
        torch.stack([torch.where(act, m10, zero), torch.where(act, m11, one)],
                    -1),
    ], -2)                                    # (mem, 2, 2)

    def run(col):
        C = col.reshape(rows, 2)
        r3 = C[1:mem + 1, 0]
        r4 = C[1:mem + 1, 1]
        d = torch.stack([
            torch.where(act, cj(s4) * b_r2b_r4 * r4 - c4 * r3, zero),
            torch.where(act, b_r4b_r4 * r4, zero),
        ], -1)                                # (mem, 2)
        Mc, dc = _prefix_compose(M, d)
        carries = torch.cat([C[0][None],
                             (Mc @ C[0][:, None])[..., 0] + dc])
        cr1 = carries[:mem, 0]
        cr2 = carries[:mem, 1]
        out1 = o1_r1 * cr1 + o1_r2 * cr2 + o1_r4 * r4
        out2 = o2_r1 * cr1 + o2_r2 * cr2 + o2_r3 * r3 + o2_r4 * r4
        new_rows = torch.where(act[:, None], torch.stack([out1, out2], -1),
                               C[:mem])
        newC = torch.cat([new_rows, C[mem:mem + 1]], 0)
        # the last active step (k − 1) leaves its carry pair at row k − 1
        sel = carries[torch.clamp(k - 1, 0, mem).long()]
        newC = torch.where((torch.arange(rows, device=dev) == (k - 1))[:, None],
                           sel[None], newC)
        return newC.reshape(-1)

    return run(col_o), run(col_e)


def _gpmr_core(
    A, B, C, D, E, F, b, c, x0, y0, state_in, iter_cap, steps, atol, rtol,
    lam, mu, *, mem, ldiv, reorthogonalization, history, hist_len,
    callback, verbose,
):
    """``steps`` GPMR iterations from ``state_in`` (None: start), each with
    its updates masked by ``status == RUNNING and iter < iter_cap``
    (krylov_tpu/solvers/gpmr.py:138-334)."""
    m, n = b.shape[0], c.shape[0]
    FC = b.dtype
    T = real_dtype(FC)
    dev = b.device
    lam_c = _tol(lam, T, dev).to(FC)
    mu_c = _tol(mu, T, dev).to(FC)
    btol = _tol(torch.finfo(T).eps ** 0.75, T, dev)
    two = 2 * mem

    def ap(P, v):
        return precond_apply(P, v, ldiv)

    if state_in is None:
        if x0 is None:
            b0, c0 = b, c
        else:
            b0 = b - A.matvec(y0)
            c0 = c - B.matvec(x0)
        b0 = ap(C, b0)
        c0 = ap(D, c0)
        if x0 is not None:
            b0 = b0 - lam_c * x0
            c0 = c0 - mu_c * y0
        beta = knorm(b0)
        gamma = knorm(c0)
        V = torch.zeros((mem + 1, m), dtype=FC, device=dev)
        U = torch.zeros((mem + 1, n), dtype=FC, device=dev)
        V[0] = torch.where(beta != 0, b0 / _safe(beta).to(FC),
                           torch.zeros_like(b0))
        U[0] = torch.where(gamma != 0, c0 / _safe(gamma).to(FC),
                           torch.zeros_like(c0))
        rNorm = torch.sqrt(beta * beta + gamma * gamma)
        eps_lim = _tol(atol, T, dev) + _tol(rtol, T, dev) * rNorm
        zt = torch.zeros(two + 2, dtype=FC, device=dev)
        zt[0], zt[1] = beta.to(FC), gamma.to(FC)
        status = torch.where(rNorm == 0, rt.ZERO_RESIDUAL, torch.where(
            rNorm <= eps_lim, rt.SOLVED, rt.RUNNING)).to(torch.int32)
        state_in = GpmrState(
            V=V, U=U, R=torch.zeros((two + 2, two), dtype=FC, device=dev),
            zt=zt, gc=torch.zeros(4 * mem, dtype=T, device=dev),
            gs=torch.zeros(4 * mem, dtype=FC, device=dev), rNorm=rNorm,
            eps_lim=eps_lim, iter=_i32(0, dev), status=status,
            hist_r=rt.hist_write(rt.hist_init(hist_len, T, dev),
                                 _i32(0, dev), rNorm, history))

    slots = torch.arange(mem + 1, device=dev)

    def body(s):
        active = (s.status == rt.RUNNING) & (s.iter < iter_cap)
        it = s.iter + 1
        # an inactive step may run one past the basis: its indices are
        # clamped, and its result is masked away
        k = torch.clamp(it, max=mem)
        ki = (k - 1).long()
        vk, uk = s.V[ki], s.U[ki]
        q = ap(C, A.matvec(ap(F, uk)))
        p = ap(D, B.matvec(ap(E, vk)))

        # CGS against V[0..k−1] and U[0..k−1] (and a second pass)
        maskV = (slots < k)[:, None]
        Vm = torch.where(maskV, s.V, torch.zeros((), dtype=FC, device=dev))
        Um = torch.where(maskV, s.U, torch.zeros((), dtype=FC, device=dev))
        h = torch.conj(Vm) @ q
        f = torch.conj(Um) @ p
        q = q - Vm.T @ h
        p = p - Um.T @ f
        if reorthogonalization:
            h2 = torch.conj(Vm) @ q
            f2 = torch.conj(Um) @ p
            q = q - Vm.T @ h2
            p = p - Um.T @ f2
            h = h + h2
            f = f + f2
        Haux = knorm(q)
        Faux = knorm(p)

        # the two new columns of Sₖ₊₁.ₖ: f at rows 2i, h at rows 2i − 1
        # (1-based, i = 1..k), λ and μ on the diagonal
        zc = torch.zeros((), dtype=FC, device=dev)
        live = slots < k
        col_o = torch.zeros(two + 2, dtype=FC, device=dev)
        col_e = torch.zeros(two + 2, dtype=FC, device=dev)
        col_o[1::2] = torch.where(live, f, zc)
        col_e[0::2] = torch.where(live, h, zc)
        col_o[two + 1] = 0
        col_e[two + 1] = 0
        r_o, r_e = (2 * k - 2).long(), (2 * k - 1).long()
        col_o = col_o.index_put((r_o[None],), lam_c[None])
        col_e = col_e.index_put((r_e[None],), mu_c[None])
        col_o, col_e = _apply_quad_rotations(col_o, col_e, s.gc, s.gs, k,
                                             mem)

        # the current reflections (reference :411-443)
        do, om, de1, de2 = col_o[r_o], col_o[r_e], col_e[r_o], col_e[r_e]
        c1k, s1k, do = sym_givens(do, Faux.to(FC))
        c1k, s1k = c1k.to(FC), s1k.to(FC)
        theta = torch.conj(s1k) * de1
        de1 = c1k * de1
        c2k, s2k, do = sym_givens(do, om)
        c2k, s2k = c2k.to(FC), s2k.to(FC)
        t = c2k * de1 + s2k * de2
        de2 = torch.conj(s2k) * de1 - c2k * de2
        de1 = t
        c3k, s3k, de2 = sym_givens(de2, theta)
        c3k, s3k = c3k.to(FC), s3k.to(FC)
        c4k, s4k, de2 = sym_givens(de2, Haux.to(FC))
        c4k, s4k = c4k.to(FC), s4k.to(FC)
        col_o = col_o.index_put((r_o[None],), do.to(FC)[None])
        col_o = col_o.index_put((r_e[None],), zc[None])
        col_e = col_e.index_put((r_o[None],), de1[None])
        col_e = col_e.index_put((r_e[None],), de2.to(FC)[None])
        R = s.R.index_copy(1, torch.stack([r_o, r_e]),
                           torch.stack([col_o, col_e], 1))

        # t̄ₖ (reference :445-466)
        z1, z2 = s.zt[r_o], s.zt[r_e]
        tbar_pp = torch.conj(s1k) * z1
        z1 = c1k * z1
        t = c2k * z1 + s2k * z2
        z2 = torch.conj(s2k) * z1 - c2k * z2
        z1 = t
        t = c3k * z2 + s3k * tbar_pp
        tbar_pp = torch.conj(s3k) * z2 - c3k * tbar_pp
        z2 = t
        tbar_p = torch.conj(s4k) * z2
        z2 = c4k * z2
        zt = s.zt.index_put((r_o[None],), z1[None])
        zt = zt.index_put((r_e[None],), z2[None])
        quad = (4 * k - 4).long() + torch.arange(4, device=dev)
        gc = s.gc.index_copy(0, quad, torch.stack([c1k, c2k, c3k,
                                                   c4k]).real.to(T))
        gs = s.gs.index_copy(0, quad, torch.stack([s1k, s2k, s3k, s4k]))

        rNorm = torch.sqrt(torch.abs(tbar_p) ** 2 + torch.abs(tbar_pp) ** 2)
        solved = (rNorm <= s.eps_lim) | ((rNorm + 1.0) <= 1.0)
        breakdown = (Faux <= btol) & (Haux <= btol)
        code = torch.where(solved, rt.SOLVED, torch.where(
            breakdown, rt.BREAKDOWN, torch.where(
                it >= mem, rt.TIRED, rt.RUNNING))).to(torch.int32)
        cont = code == rt.RUNNING
        kn = torch.clamp(it, max=mem).long()
        V = s.V.index_copy(0, kn[None], torch.where(
            cont & (Haux > btol), q / _safe(Haux).to(FC),
            torch.zeros_like(q))[None])
        U = s.U.index_copy(0, kn[None], torch.where(
            cont & (Faux > btol), p / _safe(Faux).to(FC),
            torch.zeros_like(p))[None])
        r_n = (2 * k).long()
        zt = zt.index_put((r_n[None],), torch.where(cont, tbar_p,
                                                    zt[r_n])[None])
        zt = zt.index_put(((r_n + 1)[None],), torch.where(
            cont, tbar_pp, zt[r_n + 1])[None])

        rt.hist_write_masked(s.hist_r, active, it, rNorm, history)
        s_new = s._replace(V=V, U=U, R=R, zt=zt, gc=gc, gs=gs, rNorm=rNorm,
                           iter=it, status=code)
        if verbose > 0 and bool(active):
            rt.debug_row(verbose, it, "{:5d}  {:7.1e}  {:7.1e}  {:7.1e}",
                         rNorm, Haux, Faux)
        if callback is not None:
            s_new = _exit(callback, s_new, dev)
        return _masked(GpmrState._fields, active, s_new, s)

    return rt.take_steps(body, state_in, steps, iter_cap, callback)


def _gpmr_solve(
    A, B, b, c, x0=None, y0=None, *, C=None, D=None, E=None, F=None,
    ldiv=False, gsp=False, lam=1.0, mu=1.0, memory=20,
    reorthogonalization=False, atol=None, rtol=None, itmax=0,
    timemax=float("inf"), verbose=0, history=False, callback=None,
    memory_cap=256,
):
    """Solves [λI A; B μI][x; y] = [b; c] (krylov_tpu/solvers/gpmr.py:
    337-454); a warm start needs x0 and y0."""
    start = time.perf_counter()
    A = as_operator(A, device=b.device if isinstance(b, torch.Tensor)
                    else None)
    b = rt.as_device_tensor(b, A)
    B = as_operator(B, device=b.device)
    c = rt.as_device_tensor(c, b).to(b.dtype)
    C, D, E, F = (as_operator(P, device=b.device) for P in (C, D, E, F))
    x0, y0 = (None if v is None else rt.as_device_tensor(v, b).to(b.dtype)
              for v in (x0, y0))
    if x0 is not None and y0 is None:
        raise ValueError("a warm start of GPMR needs x0 and y0")
    m, n = b.shape[0], c.shape[0]
    if gsp:
        lam, mu = 1.0, 0.0
    T = real_dtype(b.dtype)
    atol = rt.default_tol(atol, T)
    rtol = rt.default_tol(rtol, T)
    itmax = rt.resolve_itmax(itmax, m + n)
    rt.debug_table(verbose, "GPMR", ("k", "‖rₖ‖", "hₖ₊₁.ₖ", "fₖ₊₁.ₖ"), m, n)
    mem = max(2, min(max(int(memory), itmax), memory_cap, itmax))
    hist_len = itmax + 1 if history else 0

    # Fast path: A and B both square DIA stencils + default config →
    # whole-solve kernel (the basis in device memory, mem ≤ 64).
    if (all(P is None for P in (C, D, E, F)) and x0 is None and y0 is None
            and not history and callback is None and verbose == 0
            and not reorthogonalization and timemax == float("inf")
            and m == n
            and all(getattr(P, "use_kernel", False)
                    and getattr(P, "_pd", None) is not None for P in (A, B))
            and gpmr_dia_fused_supported(A.dia.offsets, B.dia.offsets, n,
                                         b.dtype, mem,
                                         stencil_dtype=A._pd.dtype)
            and B._pd.dtype == A._pd.dtype):
        x, y, niter, _, code_d, incon = gpmr_dia_fused(
            A._pd, B._pd, A._offsets, B._offsets, b.contiguous(),
            c.contiguous(), float(lam), float(mu), atol, rtol, itmax,
            mem=mem)
        niter, code, incon = torch.stack([niter, code_d, incon]).tolist()
        code = rt.final_status_code(code, niter, itmax, False)
        inconsistent = bool(incon)
        if inconsistent and code != rt.SOLVED:
            code = rt.INCONSISTENT
        stats = SimpleStats(
            niter=niter, solved=rt.is_solved_code(code),
            inconsistent=inconsistent, residuals=np.zeros(0),
            timer=time.perf_counter() - start,
            status=rt.decode_status(code))
        return x, y, stats, None

    def run(state, cap, steps):
        return _gpmr_core(
            A, B, C, D, E, F, b, c, x0, y0, state, cap, steps, atol, rtol,
            float(lam), float(mu), mem=mem, ldiv=bool(ldiv),
            reorthogonalization=bool(reorthogonalization),
            history=bool(history), hist_len=hist_len, callback=callback,
            verbose=int(verbose))

    state, overtimed = rt.drive(run, itmax, timemax, start)
    niter = int(state.iter)
    code = rt.final_status_code(state.status, niter, itmax, overtimed)

    # the back substitution on the 2k × 2k triangle, on the host, a
    # pivot of modulus at most eps^¾ giving 0 and the inconsistent flag
    # (reference src/gpmr.jl:507-520, krylov_tpu/solvers/gpmr.py:414-428)
    zt, inconsistent = _back_substitute_ref(
        state.R.cpu(), state.zt.cpu(), 2 * niter,
        float(torch.finfo(T).eps) ** 0.75)
    zt = zt.to(b.device)
    x = torch.zeros(m, dtype=b.dtype, device=b.device)
    y = torch.zeros(n, dtype=b.dtype, device=b.device)
    for i in range(niter):
        x = x + zt[2 * i] * state.V[i]
        y = y + zt[2 * i + 1] * state.U[i]
    if E is not None:
        x = precond_apply(E, x, ldiv)
    if F is not None:
        y = precond_apply(F, y, ldiv)
    if x0 is not None:
        x, y = x + x0, y + y0
    if inconsistent and code != rt.SOLVED:
        code = rt.INCONSISTENT
    stats = SimpleStats(
        niter=niter, solved=rt.is_solved_code(code),
        inconsistent=inconsistent,
        residuals=_trim(state.hist_r, niter, history),
        timer=time.perf_counter() - start, status=rt.decode_status(code))
    return x, y, stats, state


def gpmr(A, B, b, c, x0=None, y0=None, *, precision=None, **kwargs):
    """x, y, stats = gpmr(A, B, b, c; C, D, E, F, λ, μ, gsp, ...).

    ``precision="double_word"`` raises NotImplementedError until the
    iterative refinement (solvers/_refine.py, ROADMAP.md Queue 1 item 8)
    is ported."""
    _no_double_word("GPMR", precision)
    x, y, stats, _ = _gpmr_solve(A, B, b, c, x0, y0, **kwargs)
    return x, y, stats
