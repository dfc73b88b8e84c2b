"""Whole solves on a DIA matrix: the CUDA kernels and their plain versions
(counterpart of ``krylov_tpu/ops/pallas_fused.py``).

Each wrapper runs its solve on the card for CUDA tensors, through the
kernels of one ``csrc/*.cu`` file: a fixed sequence of launches per
iteration, no grid-wide barrier, the scalar state on the device, and the
host reading the status once per chunk of iterations
(``_runtime.drive``).  For CPU tensors it takes its plain version, the
``*_ref`` function beside it, which runs the same arithmetic with the
same chunked, masked semantics, so that niter is exact across chunks.

* ``cg_dia_fused``: CG with M = I or Jacobi (``csrc/cg_dia.cu``).
* ``cg_cheby_dia_fused``: CG with a degree-d Chebyshev polynomial M
  (``csrc/cg_cheby_dia.cu``).
* ``cr_dia_fused``: conjugate residuals (``csrc/cr_dia.cu``).
* ``car_dia_fused``: conjugate A-residuals (``csrc/car_dia.cu``).
* ``minres_dia_fused``: MINRES for (A + λI)x = b, M = I or Jacobi
  (``csrc/minres_dia.cu``).
* ``cg_lanczos_dia_fused``: CG-Lanczos, M = I, with the check_curvature
  exit and the Anorm estimate (``csrc/cg_lanczos_dia.cu``).
* ``cg_lanczos_shift_dia_fused``: every (A + σᵢI)xᵢ = b from one Lanczos
  stream (``csrc/cg_lanczos_shift_dia.cu``).
* ``symmlq_dia_fused``: SYMMLQ for (A + λI)x = b, M = I, with the CG-point
  transfer (``csrc/symmlq_dia.cu``).
* ``minres_qlp_dia_fused``: MINRES-QLP for (A + λI)x = b, M = I, with the
  final direction correction (``csrc/minres_qlp_dia.cu``).
* ``minares_dia_fused``: MINARES for (A + λI)x = b, with the Lanczos
  stream one step ahead and stopped at its breakdown
  (``csrc/minares_dia.cu``).
* ``gmres_dia_fused``: restarted GMRES(mem), sequential MGS Arnoldi,
  Givens QR, optionally a bf16 or f16 Krylov panel whose stops the true
  residual confirms (``csrc/gmres_dia.cu``).
* ``fom_dia_fused``: restarted FOM(mem), the same Arnoldi launches
  (``csrc/arnoldi.cuh``) with the LU of the Hessenberg
  (``csrc/fom_dia.cu``).
* ``bicgstab_dia_fused`` and ``cgs_dia_fused``: BiCGSTAB and CGS with
  the shadow vector c = b (``csrc/bicgstab_dia.cu``, ``csrc/cgs_dia.cu``).
* ``trunc_dia_fused``: DIOM or DQGMRES over circular V and P rings, with
  the window dots of one launch summed in one block
  (``csrc/trunc_dia.cu``).
* ``bilq_dia_fused``, ``qmr_dia_fused`` and ``bilqr_dia_fused``: BiLQ and
  QMR with the shadow vector c = b, and BiLQR for A x = b and Aᴴ y = c,
  on the two-sided Lanczos launches of ``csrc/bilanczos.cuh``
  (``csrc/bilq_dia.cu``, ``csrc/qmr_dia.cu``, ``csrc/bilqr_dia.cu``).
* ``usymlq_dia_fused``, ``usymqr_dia_fused``, ``trilqr_dia_fused`` and
  ``usymlqr_dia_fused``: USYMLQ, USYMQR, TriLQR and USYMLQR on the
  Saunders–Simon–Yip launches of ``csrc/ssy.cuh`` (``csrc/usymlq_dia.cu``,
  ``csrc/usymqr_dia.cu``, ``csrc/trilqr_dia.cu``,
  ``csrc/usymlqr_dia.cu``).
* ``lsqr_dia_fused``, ``lsmr_dia_fused`` and ``lslq_dia_fused``: LSQR,
  LSMR and LSLQ for min ‖b − Ax‖ (+ λ) on the Golub–Kahan launches of
  ``csrc/gk.cuh`` (``csrc/lsqr_dia.cu``, ``csrc/lsmr_dia.cu``,
  ``csrc/lslq_dia.cu``).
* ``craig_dia_fused``, ``craigmr_dia_fused`` and ``lnlq_dia_fused``:
  CRAIG, CRAIGMR and LNLQ for min ‖x‖ subject to Ax = b (+ λ), on the
  same launches with their row hooks (``csrc/craig_dia.cu``,
  ``csrc/craigmr_dia.cu``, ``csrc/lnlq_dia.cu``).
* ``cgne_crmr_dia_fused``: CGNE or CRMR for the same problem, CG or CR on
  AAᴴ (``csrc/cgne_crmr_dia.cu``).
* ``cgls_dia_fused`` and ``crls_dia_fused``: CGLS and CRLS for
  min ‖b − Ax‖² + λ‖x‖², CG and CR on AᴴA (``csrc/cgls_dia.cu``,
  ``csrc/crls_dia.cu``).
* ``cgls_lanczos_shift_dia_fused``: every min ‖b − Ax‖² + λᵢ‖x‖² from
  one Lanczos stream on AᴴA (``csrc/cgls_lanczos_shift_dia.cu``).
* ``tricg_dia_fused`` and ``trimr_dia_fused``: TriCG and TriMR for
  [τI A; Aᴴ νI][x; y] = [b; c] on the Saunders–Simon–Yip launches
  (``csrc/tricg_dia.cu``, ``csrc/trimr_dia.cu``).
* ``gpmr_dia_fused``: GPMR for [λI A; B μI][x; y] = [b; c] with two DIA
  matrices, CGS over a basis of at most 64 slots and the back
  substitution on the card (``csrc/gpmr_dia.cu``).
* ``block_minres_dia_fused``: block MINRES for AX = B, B of 1 to 8
  columns, with CholQR2 panels (``csrc/block_minres.cuh`` on
  ``csrc/block.cuh``, instantiated in ``csrc/block_minres_dia.cu`` and
  ``csrc/block_minres_dia_f64.cu``).
* ``block_gmres_dia_fused``: restarted block GMRES(mem) for AX = B, B of
  1 to 8 columns, mem·p ≤ 128: block CGS2, CholQR2 panels, the banded
  block Hessenberg's Givens QR in one block, restarts decided on the
  card, optionally a bf16 basis (``csrc/block_gmres.cuh`` on
  ``csrc/block.cuh``, instantiated in ``csrc/block_gmres_dia.cu``,
  ``csrc/block_gmres_dia_bf16.cu`` and ``csrc/block_gmres_dia_f64.cu``).
"""

import math
import types

import numpy as np
import torch

from .. import _build
from .._runtime import (BREAKDOWN, COND_EXCEEDED, FWD_ERR, ILL_COND_MACH,
                        INCONSISTENT, MIN_LSQ_X, RUNNING, SOLVED, SOLVED_LSQ,
                        SOLVED_PRIMAL_DUAL, SOLVED_ZERO, TIRED,
                        ZERO_CURVATURE, ZERO_RESIDUAL, drive,
                        full_fp32)
from .cuda_dia import _check as _check_spmv
from .cuda_dia import _tensor_span, dia_spmv_aligned_ref
from .kops import sym_givens

# CR-specific status codes (krylov_tpu/solvers/cr.py)
NUMERICAL = 25
ZERO_CURV_B = 26
# CG-LANCZOS negative curvature (krylov_tpu/solvers/cg_lanczos.py)
NEG_CURV = 27
# SYMMLQ-specific status codes (krylov_tpu/solvers/symmlq.py)
SOLVED_GEN = 34
SOLVED_LQ = 35
SOLVED_CG_PT = 36
# MINARES's solved code (krylov_tpu/solvers/minares.py)
SOLVED_ARTOL = 37
# FOM's breakdown code (krylov_tpu/solvers/fom.py)
INCONS_FOM = 28
# BiCGSTAB and CGS codes (krylov_tpu/solvers/bicgstab.py)
BC_BREAKDOWN = 29
ALPHA_BREAKDOWN = 30
# BiLQ, QMR and BiLQR's own code (krylov_tpu/solvers/bilq.py; BiLQ's
# solved codes are 35 and 36, decoded by its own strings)
UV_BREAKDOWN = 38
# LSLQ's forward-error codes (krylov_tpu/solvers/lslq.py:22-28)
FWD_LBND = 44
FWD_UBND = 45
# the least-norm family's codes (krylov_tpu/solvers/cgne.py:22-23,
# craig.py:26-30)
INCONS_CGNE = 32
INCONS_CRMR = 33
SOLVED_CRAIG = 39
SOLVED_MN = 40
INCONS_CRAIG = 41
SOLVED_LNLQ_LQ = 42
SOLVED_LNLQ_CG = 43
# TriCG's breakdown code (krylov_tpu/solvers/tricg.py:24), FOM's number
INCONS_TRI = 28

# (b dtype, pd dtype) → the name suffix of the C entry points
_PAIR = {
    (torch.float32, torch.float32): "f32_f32",
    (torch.float32, torch.bfloat16): "f32_bf16",
    (torch.float32, torch.float16): "f32_f16",
    (torch.float64, torch.float64): "f64_f64",
}
_THREADS = 256
_BLOCKS_PER_SM = 8
# slots of the kernels' scalar arrays (the ScalarSlot and IntSlot enums of
# each csrc file); every int array has it in slot 0 and status in slot 1
_IT, _STATUS = 0, 1
_CG_RNORM, _CG_NSC, _CG_VIOL, _CG_NST = 2, 7, 2, 5
_CR_RNORM, _CR_ATOL, _CR_NSC, _CR_INDEF, _CR_NST = 2, 9, 11, 2, 5
_CAR_RNORM, _CAR_ARNORM, _CAR_ATOL, _CAR_NSC, _CAR_NST = 1, 2, 6, 8, 4
_MR_RNORM, _MR_NSC, _MR_INCON, _MR_VIOL, _MR_NST = 18, 24, 2, 3, 5
_CGL_RNORM, _CGL_ANORM2, _CGL_NSC, _CGL_INDEF, _CGL_NST = 9, 7, 11, 2, 5
# shift kernel: NSC scalars, then nshifts each of (shift, σ, ω, γ, rnorm);
# NST ints, then nshifts each of (converged, indefinite, mask)
_CGLS_NSC, _CGLS_NBLK, _CGLS_RNORM, _CGLS_NST, _CGLS_INDEF = 5, 5, 4, 4, 1
_SQ_RNORM, _SQ_ANORM2, _SQ_GMAX, _SQ_GMIN, _SQ_NSC, _SQ_NST = \
    18, 14, 15, 16, 24, 5
_QLP_RNORM, _QLP_ARNORM, _QLP_NSC, _QLP_INCON, _QLP_NST = 23, 24, 31, 2, 6
_MNA_RNORM, _MNA_ARNORM, _MNA_NSC, _MNA_NST = 34, 35, 45, 7
# GMRES and FOM (csrc/arnoldi.cuh): NSC fixed scalars, then the Hessenberg
# column h (mem + 1), the rotations or LU multipliers c, s (mem each), zz
# (mem + 1), y (mem) and R by rows (mem * mem); the scratch array is
# ``_ar_layout``'s
_AR_RNORM, _AR_NSC = 4, 8
_AR_INCONS, _AR_NPASS, _AR_NST = 5, 6, 11
_BS_RNORM, _BS_NSC, _BS_NST, _BS_NPART = 4, 8, 3, 5
_CGS_RNORM, _CGS_NSC, _CGS_NST, _CGS_NPART = 4, 7, 3, 3
# DIOM and DQGMRES (csrc/trunc_dia.cu): NSC fixed scalars, then the window
# dots hs (mem), the column H (mem + 2), L and S (mem each) and the P-ring
# coefficients (mem); the blocks per SM of the grid launches on wide rows
# (trunc_dia.cu, arnoldi.cuh)
_TR_RNORM, _TR_NSC, _TR_NST = 3, 8, 4
_WIDE_BLOCKS_PER_SM = 4
# BiLQ, QMR and BiLQR (csrc/bilanczos.cuh): the partial rows, and the work
# row of x (after v and u, three rows each); BiLQR's y follows x and its
# snorm follows rnorm.
_BI_NPART, _BI_X = 6, 6
_BQ_RNORM, _BQ_NSC, _BQ_NST = 17, 21, 4
_QM_RNORM, _QM_NSC, _QM_NST = 15, 20, 3
_BR_RNORM, _BR_NSC, _BR_NST = 22, 27, 13
# BiLQR's int slots of lq_tol, lq_mach, cg_tol, cg_mach, qr_tol, qr_mach,
# solved_primal, solved_dual and breakdown
_BR_FLAGS = (5, 6, 7, 8, 9, 10, 3, 4, 12)
# USYMLQ, USYMQR, TriLQR and USYMLQR (csrc/ssy.cuh): the partial rows, and
# the first work row of the method's own (after v and u, three rows
# each): x, then TriLQR's and USYMLQR's y; each scalar and int array ends
# in the staging copy of its state, which the commit launch copies in
_SSY_NPART, _SSY_X = 3, 6
_UL_RNORM, _UL_NSC, _UL_NST = 13, 25, 7
_UQ_RNORM, _UQ_ARNORM, _UQ_INCON, _UQ_NSC, _UQ_NST = 12, 13, 3, 33, 7
_TL_RNORM, _TL_NSC, _TL_NST = 18, 37, 25
# TriLQR's int slots of lq_tol, lq_mach, cg_tol, cg_mach, qr_tol, qr_mach,
# solved_primal, solved_dual and inconsistent_dual
_TL_FLAGS = (5, 6, 7, 8, 9, 10, 3, 4, 12)
_ULR_RNORM, _ULR_INCON, _ULR_NSC, _ULR_NST = 18, 5, 37, 11
# LSQR, LSMR and LSLQ (csrc/gk.cuh): the partial rows, the work row of x
# (after u and v), the int slot of the last zero-residual test; each
# scalar array holds the host's parameters, the state and its staging
# copy, then the error window (``window`` more slots)
_GK_NPART, _GK_X, _GK_ZR = 4, 2, 3
_LQ_RNORM, _LQ_ARNORM, _LQ_NSC, _LQ_NST = 22, 23, 41, 7
# LSMR's rnorm, arnorm, acond, anorm and xnorm slots
_LM_NORMS, _LM_NSC, _LM_NST = (29, 30, 31, 32, 33), 63, 7
_LL_RNORM, _LL_ARNORM, _LL_CBND, _LL_NSC, _LL_NST = 29, 30, 4, 55, 9
# CRAIG, CRAIGMR and LNLQ (csrc/gk.cuh, no error window): the work rows of
# y (after u, v and x), and the rnorm (and CRAIGMR's arnorm) slots
_LN_Y = 3
_CRAIG_RNORM, _CRAIG_NSC, _CRAIG_NST = 18, 33, 7
_CMR_RNORM, _CMR_ARNORM, _CMR_NSC, _CMR_NST = 16, 17, 31, 7
_LNLQ_RNORM, _LNLQ_NSC, _LNLQ_NST = 19, 33, 9
# CGNE and CRMR (csrc/cgne_crmr_dia.cu): the partial rows, the work rows
# (x first), and the rnorm slot
_NE_NPART, _NE_NROWS, _NE_RNORM, _NE_NSC, _NE_NST = 6, 6, 4, 9, 3
# CGLS and CRLS (csrc/cgls_dia.cu, csrc/crls_dia.cu): the partial rows,
# the work rows (x first), and the rnorm and arnorm slots
_GLS_NPART, _GLS_NROWS, _RLS_NPART, _RLS_NROWS = 5, 5, 6, 7
_NQ_RNORM, _NQ_ARNORM, _NQ_NSC, _NQ_NST = 4, 5, 7, 3
# CGLS-Lanczos-shift (csrc/cgls_lanczos_shift_dia.cu): as the
# CG-Lanczos-shift kernel's arrays, with t in work row 3 and X from row 4
_LZS_NSC, _LZS_NBLK, _LZS_RNORM, _LZS_NST, _LZS_INDEF = 5, 5, 4, 4, 1
_LZS_X, _LZS_NPART = 4, 2
# TriCG (csrc/tricg_dia.cu, on csrc/ssy.cuh): the rnorm slot, τ and ν
# after the staging copy, and the work rows of x and y
_TCG_RNORM, _TCG_TAU, _TCG_NSC, _TCG_NST, _TCG_NROWS = 11, 21, 23, 5, 12
# TriMR (csrc/trimr_dia.cu, on csrc/ssy.cuh): as TriCG's, with the four
# direction panels of x and of y after y
_TMR_RNORM, _TMR_TAU, _TMR_NSC, _TMR_NST, _TMR_NROWS = 22, 43, 45, 5, 16
# GPMR (csrc/gpmr_dia.cu): the fixed scalar slots (ATOL, RTOL, LAM, MU,
# EPS_LIM, RNORM), then arrays sized by mem (``_gp_layout``); the int
# slots of the inconsistent flag and the array's size; the largest mem
_GP_RNORM, _GP_H, _GP_INCON, _GP_NST, _GP_MAXMEM = 5, 6, 4, 5, 64
# block MINRES (csrc/block_minres.cuh, on csrc/block.cuh): the rnorm
# slot and the first state slot (Ψ), the int array's size, the largest p;
# the arrays are sized by p (``_bm_layout``)
_BM_RNORM, _BM_PSI, _BM_NST, _BM_MAXP = 3, 4, 4, 8
# block GMRES (csrc/block_gmres.cuh): the fixed scalar slots (ATOL, RTOL,
# BTOL, ..., RNORM), then arrays sized by mem and p (``_bg_layout``); the
# int slots of the inconsistent flag and the pass count, the int array's
# size, the largest mem * p, and the rows per thread of its row launches
_BG_RNORM, _BG_NSC = 4, 8
_BG_INCONS, _BG_NPASS, _BG_NST = 5, 6, 13
_BG_MAXMP, _BG_ROWS = 128, 4


def cg_dia_fused_supported(offsets, n, dtype, stencil_dtype=None):
    """Static gate: is there a kernel for these dtypes?

    The TPU kernels' gate is their ~100 MB of VMEM.  Here the vectors
    live in device memory and every iteration streams them, so no size
    is too large; the kernels exist for f32 vectors with f32/bf16/f16
    diagonals and for f64 with f64.  Any other dtype takes the general
    route.  The same gate serves every whole-solve kernel here.
    """
    sd = dtype if stencil_dtype is None else stencil_dtype
    return (dtype, sd) in _PAIR


cg_cheby_dia_fused_supported = cg_dia_fused_supported
cr_dia_fused_supported = cg_dia_fused_supported
car_dia_fused_supported = cg_dia_fused_supported
minres_dia_fused_supported = cg_dia_fused_supported
cg_lanczos_dia_fused_supported = cg_dia_fused_supported
cg_lanczos_shift_dia_fused_supported = cg_dia_fused_supported
symmlq_dia_fused_supported = cg_dia_fused_supported
minres_qlp_dia_fused_supported = cg_dia_fused_supported
minares_dia_fused_supported = cg_dia_fused_supported
fom_dia_fused_supported = cg_dia_fused_supported
bicgstab_dia_fused_supported = cg_dia_fused_supported
cgs_dia_fused_supported = cg_dia_fused_supported
bilq_dia_fused_supported = cg_dia_fused_supported
qmr_dia_fused_supported = cg_dia_fused_supported
bilqr_dia_fused_supported = cg_dia_fused_supported
usymlq_dia_fused_supported = cg_dia_fused_supported
usymqr_dia_fused_supported = cg_dia_fused_supported
trilqr_dia_fused_supported = cg_dia_fused_supported
usymlqr_dia_fused_supported = cg_dia_fused_supported
lsqr_dia_fused_supported = cg_dia_fused_supported
lsmr_dia_fused_supported = cg_dia_fused_supported
lslq_dia_fused_supported = cg_dia_fused_supported
craig_dia_fused_supported = cg_dia_fused_supported
craigmr_dia_fused_supported = cg_dia_fused_supported
lnlq_dia_fused_supported = cg_dia_fused_supported
cgne_crmr_dia_fused_supported = cg_dia_fused_supported
cgls_dia_fused_supported = cg_dia_fused_supported
crls_dia_fused_supported = cg_dia_fused_supported
cgls_lanczos_shift_dia_fused_supported = cg_dia_fused_supported
tricg_dia_fused_supported = cg_dia_fused_supported
trimr_dia_fused_supported = cg_dia_fused_supported


def block_minres_dia_fused_supported(offsets, n, p, dtype,
                                     stencil_dtype=None):
    """The dtype gate of ``cg_dia_fused_supported``, and 1 ≤ p ≤ 8 (the
    TPU kernel's gate, pallas_fused.py:2999)."""
    return (cg_dia_fused_supported(offsets, n, dtype, stencil_dtype)
            and 1 <= p <= _BM_MAXP)


def block_gmres_dia_fused_supported(offsets, n, p, dtype, mem,
                                    stencil_dtype=None, basis_dtype=None):
    """The dtype gate of ``cg_dia_fused_supported``, the TPU kernel's
    limits 1 ≤ p ≤ 8, mem ≥ 2 and mem·p ≤ 128 (pallas_fused.py:
    2655-2665), and a basis type the kernel stores: B's own or bf16."""
    return (cg_dia_fused_supported(offsets, n, dtype, stencil_dtype)
            and 1 <= p <= _BM_MAXP and mem >= 2 and mem * p <= _BG_MAXMP
            and basis_dtype in (None, dtype, torch.bfloat16))


def gpmr_dia_fused_supported(offsets_a, offsets_b, n, dtype, mem,
                             stencil_dtype=None):
    """The dtype gate of ``cg_dia_fused_supported``, and mem ≤ 64: the
    kernel keeps the 2k × 2k triangle's scalar work in one thread per
    block (the TPU kernel's SMEM bound, pallas_fused.py:8553)."""
    return (cg_dia_fused_supported(offsets_a, n, dtype, stencil_dtype)
            and 2 <= mem <= _GP_MAXMEM)


# the rings live in device memory, so any mem ≥ 2 has a kernel
trunc_dia_fused_supported = cg_dia_fused_supported


# the Krylov panel's types the GMRES kernel stores (None: b's own)
_BASIS = {torch.float32: "f32", torch.float64: "f64",
          torch.bfloat16: "bf16", torch.float16: "f16"}


def _basis_ok(dtype, basis_dtype):
    return basis_dtype in (None, dtype, torch.bfloat16, torch.float16)


def gmres_dia_fused_supported(offsets, n, dtype, stencil_dtype=None,
                              basis_dtype=None):
    """The dtype gate of ``cg_dia_fused_supported``, and a panel type the
    kernel stores: b's own, bf16 or f16."""
    return (cg_dia_fused_supported(offsets, n, dtype, stencil_dtype)
            and _basis_ok(dtype, basis_dtype))


def _scalar(v, like):
    return torch.as_tensor(v, dtype=like.dtype, device=like.device)


def _drive_ref(state, step, itmax):
    """Run ``step`` in chunks of masked iterations from ``state``.

    ``step(s)`` returns every field of the next state; each is kept only
    where ``status == RUNNING and iter < cap``, so a chunk that runs past
    the stop leaves the state bit-for-bit frozen."""
    def run(s, cap, steps):
        s = state if s is None else s
        for _ in range(steps):
            go = (s.status == RUNNING) & (s.iter < cap)
            s = types.SimpleNamespace(**{
                k: torch.where(go, v, getattr(s, k))
                for k, v in step(s).items()})
        return s

    s, _ = drive(run, itmax, float("inf"))
    return s


def _i32(v, like):
    return torch.as_tensor(v, dtype=torch.int32, device=like.device)


# ---------------------------------------------------------------------------
# CG, M = I, Jacobi or Chebyshev: the plain versions
# ---------------------------------------------------------------------------

def _cg_ref(pd, offsets, b, atol, rtol, itmax, apply_m):
    """Plain CG of A x = b with z = apply_m(r) (pallas_fused.py:141-185)."""
    eps = torch.finfo(b.dtype).eps
    zero, one = _scalar(0, b), _scalar(1, b)
    z0 = apply_m(b)
    gamma0 = torch.sum(b * z0)
    rnorm0 = torch.sqrt(torch.clamp(gamma0, min=0))
    eps_lim = _scalar(atol, b) + _scalar(rtol, b) * rnorm0
    status0 = torch.where(
        gamma0 == 0, ZERO_RESIDUAL,
        torch.where(rnorm0 <= eps_lim, SOLVED, RUNNING)).to(torch.int32)
    s0 = types.SimpleNamespace(
        x=torch.zeros_like(b), r=b.clone(), p=z0.clone(), gamma=gamma0,
        pNorm2=gamma0, rnorm=rnorm0, iter=_i32(0, b), status=status0,
        viol=gamma0 < 0)

    def step(s):
        ap = dia_spmv_aligned_ref(pd, offsets, s.p)
        pAp = torch.sum(s.p * ap)
        curv_small = pAp <= eps * s.pNorm2
        zero_curv = curv_small & (torch.abs(pAp) <= eps * s.pNorm2)
        skip = zero_curv
        alpha = s.gamma / torch.where(pAp == 0, one, pAp)
        a_eff = torch.where(skip, zero, alpha)
        x = s.x + a_eff * s.p
        r = s.r - a_eff * ap
        z = apply_m(r)
        gamma_next = torch.sum(r * z)
        viol = s.viol | (gamma_next < 0)
        rnorm_next = torch.sqrt(torch.clamp(gamma_next, min=0))
        resid_mach = (rnorm_next + 1) <= 1
        solved = (rnorm_next <= eps_lim) | resid_mach
        beta = gamma_next / torch.where(s.gamma == 0, one, s.gamma)
        stay = ~(solved | skip)
        cr = torch.where(stay, one, zero)
        cp = torch.where(stay, beta, one)
        return dict(
            x=x, r=r, p=cr * z + cp * s.p,
            gamma=torch.where(stay, gamma_next, s.gamma),
            pNorm2=torch.where(stay, gamma_next + beta * beta * s.pNorm2,
                               s.pNorm2),
            rnorm=torch.where(skip, s.rnorm, rnorm_next),
            iter=s.iter + (~skip).to(torch.int32),
            status=torch.where(
                zero_curv, ZERO_CURVATURE,
                torch.where(solved, SOLVED, RUNNING)).to(torch.int32),
            viol=viol)

    s = _drive_ref(s0, step, itmax)
    return s.x, s.iter, s.rnorm, s.status, s.viol.to(torch.int32)


def cg_dia_fused_ref(pd, offsets, b, atol, rtol, itmax, dinv=None):
    """Plain PyTorch CG of A x = b with M = I or z = dinv·r.

    Returns (x, niter, rnorm, status, posdef_violation) as tensors, as
    ``cg_dia_fused`` does.
    """
    return _cg_ref(pd, offsets, b, atol, rtol, itmax,
                   (lambda r: r) if dinv is None else (lambda r: dinv * r))


def cheby_constants(lmin, lmax, degree, dtype, round_bounds=True):
    """θ and the (c₁, c₂) of each of the degree − 1 Chebyshev steps.

    They depend only on the interval and the degree, so they are computed
    once, as 0-d tensors of ``dtype`` on the host and returned as Python
    floats that hold those values exactly.  ``round_bounds=True`` rounds
    lmin and lmax to ``dtype`` first, as the TPU kernel does
    (pallas_fused.py:312-315); False takes θ and δ from the f64 bounds, as
    ``ChebyshevPreconditioner.matvec`` does (precond.py:100-116).  Each
    step is d = c₁d + c₂(r − A z), z = z + d.
    """
    def t(v):
        return torch.tensor(v, dtype=dtype)

    if round_bounds:
        lo, hi = t(lmin), t(lmax)
        theta = (hi + lo) * 0.5
        delta = (hi - lo) * 0.5
    else:
        theta = t((lmax + lmin) / 2)
        delta = t((lmax - lmin) / 2)
    sigma = theta / delta
    rho = 1.0 / sigma
    steps = []
    for _ in range(degree - 1):
        rho_n = 1.0 / (2.0 * sigma - rho)
        steps.append(((rho_n * rho).item(), (2.0 * rho_n / delta).item()))
        rho = rho_n
    return theta.item(), steps


def _cheby_apply(pd, offsets, theta, steps):
    def apply_m(r):
        d = r / theta
        z = d
        for c1, c2 in steps:
            w = dia_spmv_aligned_ref(pd, offsets, z)
            d = c1 * d + c2 * (r - w)
            z = z + d
        return z
    return apply_m


def cg_cheby_dia_fused_ref(pd, offsets, b, atol, rtol, itmax, lmin, lmax,
                           degree):
    """Plain PyTorch CG with the degree-``degree`` Chebyshev M on
    [lmin, lmax] applied as the TPU kernel applies it
    (pallas_fused.py:309-406).  Returns (x, niter, rnorm, status,
    posdef_violation)."""
    theta, steps = cheby_constants(lmin, lmax, int(degree), b.dtype)
    return _cg_ref(pd, offsets, b, atol, rtol, itmax,
                   _cheby_apply(pd, offsets, theta, steps))


# ---------------------------------------------------------------------------
# CR, CAR and MINRES: the plain versions
# ---------------------------------------------------------------------------

def cr_dia_fused_ref(pd, offsets, b, atol, rtol, itmax):
    """Plain PyTorch CR of A x = b, M = I (pallas_fused.py:754-820).

    Returns (x, niter, rnorm, status, indef_error) as tensors, as
    ``cr_dia_fused`` does."""
    sqeps = math.sqrt(torch.finfo(b.dtype).eps)
    one = _scalar(1, b)
    rnorm2_0 = torch.sum(b * b)
    rnorm0 = torch.sqrt(rnorm2_0)
    ar0 = dia_spmv_aligned_ref(pd, offsets, b)
    rho0 = torch.sum(b * ar0)
    eps_lim = _scalar(atol, b) + _scalar(rtol, b) * rnorm0
    status0 = torch.where(
        rnorm0 == 0, ZERO_RESIDUAL,
        torch.where(rho0 == 0, ZERO_CURV_B,
                    torch.where(rnorm0 <= eps_lim, SOLVED, RUNNING))
    ).to(torch.int32)
    s0 = types.SimpleNamespace(
        x=torch.zeros_like(b), r=b.clone(), p=b.clone(), q=ar0,
        iter=_i32(0, b), rho=rho0, rnorm2=rnorm2_0, rnorm=rnorm0,
        pNorm2=rnorm2_0, pr=rnorm2_0, pAp=rho0, status=status0,
        indef=torch.zeros((), dtype=torch.bool, device=b.device))

    def step(s):
        indef = s.indef | (s.pAp <= 0)
        qq = torch.sum(s.q * s.q)
        alpha = s.rho / torch.where(qq == 0, one, qq)
        x = s.x + alpha * s.p
        r = s.r - alpha * s.q
        rnorm2 = torch.sum(r * r)
        rnorm = torch.sqrt(rnorm2)
        ar = dia_spmv_aligned_ref(pd, offsets, r)
        solved = (rnorm <= eps_lim) | ((rnorm + 1.0) <= 1.0)
        rho_n = torch.sum(r * ar)
        beta = rho_n / torch.where(s.rho == 0, one, s.rho)
        pNorm2 = rnorm2 + 2 * beta * s.pr - 2 * beta * alpha * s.pAp \
            + beta * beta * s.pNorm2
        pr = rnorm2 + beta * s.pr - beta * alpha * s.pAp
        pAp = rho_n + beta * beta * s.pAp
        code = torch.where(solved, SOLVED,
                           torch.where(pNorm2 <= -sqeps, NUMERICAL, RUNNING))
        return dict(
            x=x, r=r,
            p=torch.where(solved, s.p, r + beta * s.p),
            q=torch.where(solved, s.q, ar + beta * s.q),
            iter=s.iter + 1,
            rho=torch.where(solved, s.rho, rho_n), rnorm2=rnorm2,
            rnorm=rnorm, pNorm2=torch.where(solved, s.pNorm2, pNorm2),
            pr=torch.where(solved, s.pr, pr),
            pAp=torch.where(solved, s.pAp, pAp),
            status=code.to(torch.int32), indef=indef)

    s = _drive_ref(s0, step, itmax)
    return s.x, s.iter, s.rnorm, s.status, s.indef.to(torch.int32)


def car_dia_fused_ref(pd, offsets, b, atol, rtol, itmax):
    """Plain PyTorch CAR of A x = b, M = I (pallas_fused.py:903-960).

    Returns (x, niter, rnorm, arnorm, status) as tensors, as
    ``car_dia_fused`` does."""
    one = _scalar(1, b)
    rnorm0 = torch.sqrt(torch.sum(b * b))
    s_ = dia_spmv_aligned_ref(pd, offsets, b)
    t = dia_spmv_aligned_ref(pd, offsets, s_)
    eps_lim = _scalar(atol, b) + _scalar(rtol, b) * rnorm0
    status0 = torch.where(
        rnorm0 == 0, ZERO_RESIDUAL,
        torch.where(rnorm0 <= eps_lim, SOLVED, RUNNING)).to(torch.int32)
    s0 = types.SimpleNamespace(
        x=torch.zeros_like(b), r=b.clone(), p=b.clone(), s=s_, q=s_,
        u=t, iter=_i32(0, b), rho=torch.sum(t * s_), rnorm=rnorm0,
        arnorm=torch.sqrt(torch.sum(s_ * s_)), status=status0)

    def step(st):
        uu = torch.sum(st.u * st.u)
        alpha = st.rho / torch.where(uu == 0, one, uu)
        x = st.x + alpha * st.p
        r = st.r - alpha * st.q
        s_new = st.s - alpha * st.u
        rnorm = torch.sqrt(torch.sum(r * r))
        solved = (rnorm <= eps_lim) | ((rnorm + 1.0) <= 1.0)
        t = dia_spmv_aligned_ref(pd, offsets, s_new)
        rho_next = torch.sum(t * s_new)
        beta = rho_next / torch.where(st.rho == 0, one, st.rho)
        return dict(
            x=x, r=r, s=s_new,
            p=torch.where(solved, st.p, r + beta * st.p),
            q=torch.where(solved, st.q, s_new + beta * st.q),
            u=torch.where(solved, st.u, t + beta * st.u),
            iter=st.iter + 1,
            rho=torch.where(solved, st.rho, rho_next), rnorm=rnorm,
            arnorm=torch.where(solved, st.arnorm,
                               torch.sqrt(torch.sum(s_new * s_new))),
            status=torch.where(solved, SOLVED, RUNNING).to(torch.int32))

    s = _drive_ref(s0, step, itmax)
    return s.x, s.iter, s.rnorm, s.arnorm, s.status


def minres_dia_fused_ref(pd, offsets, b, atol, rtol, etol, ctol, lam, itmax,
                         window=5, dinv=None):
    """Plain PyTorch MINRES of (A + λI) x = b, M = I or v = dinv·r₂
    (pallas_fused.py:500-645).

    Returns (x, niter, rnorm, status, inconsistent, precond_violation) as
    tensors, as ``minres_dia_fused`` does."""
    eps = torch.finfo(b.dtype).eps
    tiny = torch.finfo(b.dtype).tiny
    one = _scalar(1, b)
    atol_v, rtol_v, etol_v, ctol_v, lam_v = (
        _scalar(v, b) for v in (atol, rtol, etol, ctol, lam))
    precond = dinv is not None
    v0 = dinv * b if precond else b
    beta1_sq = torch.sum(b * v0)
    beta1 = torch.sqrt(torch.clamp(beta1_sq, min=0))
    eps_lim = atol_v + rtol_v * beta1
    status0 = torch.where(
        beta1 == 0, ZERO_RESIDUAL,
        torch.where(beta1 <= eps_lim, SOLVED_ZERO, RUNNING)).to(torch.int32)
    zero = _scalar(0, b)
    s0 = types.SimpleNamespace(
        x=torch.zeros_like(b), r1=b.clone(), r2=b.clone(), v=v0.clone(),
        w1=torch.zeros_like(b), w2=torch.zeros_like(b), iter=_i32(0, b),
        oldbeta=zero, beta=beta1, dbar=zero, eps_prev=zero, phibar=beta1,
        gmax=zero, gmin=_scalar(math.inf, b), cs=-one, sn=zero,
        anorm2=zero, xenorm2=zero, rnorm=beta1,
        incon=torch.ones((), dtype=torch.bool, device=b.device),
        status=status0, viol=beta1_sq < 0,
        phis=torch.zeros(window, dtype=b.dtype, device=b.device))

    def step(s):
        it = s.iter + 1
        y = dia_spmv_aligned_ref(pd, offsets, s.v) + lam_v * s.v
        y = y / s.beta
        safe_ob = torch.where(s.oldbeta == 0, one, s.oldbeta)
        y = torch.where(it >= 2, y - (s.beta / safe_ob) * s.r1, y)
        alpha = torch.sum(s.v * y) / s.beta
        r2c = s.r2 if precond else s.v
        y = y - (alpha / s.beta) * r2c
        delta = s.cs * s.dbar + s.sn * alpha
        w_unscaled = s.v / s.beta - delta * s.w2 - s.eps_prev * s.w1
        if precond:
            v = dinv * y
            beta_sq = torch.sum(y * v)
            viol = s.viol | (beta_sq < 0)
            beta_sq = torch.clamp(beta_sq, min=0)
        else:
            v = y
            beta_sq = torch.sum(y * y)
            viol = s.viol
        beta = torch.sqrt(beta_sq)
        anorm2 = s.anorm2 + alpha * alpha + s.beta * s.beta + beta_sq
        gbar = s.sn * s.dbar - s.cs * alpha
        dbar = -s.cs * beta
        root = torch.sqrt(gbar * gbar + dbar * dbar)
        gamma = torch.clamp(torch.sqrt(gbar * gbar + beta_sq), min=eps)
        w = w_unscaled / gamma
        cs = gbar / gamma
        sn = beta / gamma
        phi = cs * s.phibar
        phibar = sn * s.phibar
        x = s.x + phi * w
        xenorm2 = s.xenorm2 + phi * phi
        phis = torch.cat([s.phis[1:], phi.reshape(1)])
        err2 = zero
        for j in range(window):
            err2 = err2 + phis[j] * phis[j]
        err_lbnd = torch.sqrt(err2)
        gmax = torch.maximum(s.gmax, gamma)
        gmin = torch.minimum(s.gmin, gamma)
        anorm = torch.sqrt(anorm2)
        xnorm = torch.sqrt(torch.sum(x * x))
        rnorm = phibar
        test1 = rnorm / torch.clamp(anorm * xnorm, min=tiny)
        test2 = root / torch.clamp(anorm, min=tiny)
        acond = gmax / torch.where(gmin == 0, _scalar(tiny, b), gmin)

        min_lsq_early = (it == 1) & (beta / beta1 <= 10 * eps)
        ill_cond_mach = (1.0 + 1.0 / acond) <= 1.0
        solved_mach = (1.0 + test2) <= 1.0
        zero_resid_mach = (1.0 + test1) <= 1.0
        resid_mach = (rnorm + 1.0) <= 1.0
        ill_cond_lim = (1.0 / acond) <= ctol_v
        solved_lim = test2 <= eps_lim
        zero_resid_lim = (test1 <= eps) & (not precond)
        resid_lim = rnorm <= eps_lim
        fwd_err = (it >= window) & (err_lbnd <= etol_v * torch.sqrt(xenorm2))
        zero_resid = zero_resid_mach | zero_resid_lim
        solved = (solved_mach | solved_lim | zero_resid | fwd_err
                  | resid_mach | resid_lim)
        code = _i32(RUNNING, b)
        for cond, c in ((ill_cond_mach, ILL_COND_MACH),
                        (ill_cond_lim, COND_EXCEEDED), (solved, SOLVED_LSQ),
                        (zero_resid, SOLVED_ZERO), (fwd_err, FWD_ERR),
                        (min_lsq_early, MIN_LSQ_X)):
            code = torch.where(cond, c, code)
        return dict(
            x=x, r1=r2c, r2=y if precond else s.r2, v=v, w1=s.w2, w2=w,
            iter=it, oldbeta=s.beta, beta=beta, dbar=dbar,
            eps_prev=s.sn * beta, phibar=phibar, gmax=gmax, gmin=gmin,
            cs=cs, sn=sn, anorm2=anorm2, xenorm2=xenorm2, rnorm=rnorm,
            incon=min_lsq_early | ~zero_resid, status=code.to(torch.int32),
            viol=viol, phis=phis)

    s = _drive_ref(s0, step, itmax)
    return (s.x, s.iter, s.rnorm, s.status, s.incon.to(torch.int32),
            s.viol.to(torch.int32))


# ---------------------------------------------------------------------------
# CG-Lanczos, CG-Lanczos-shift and SYMMLQ: the plain versions
# ---------------------------------------------------------------------------

def _safe(d, one):
    return torch.where(d == 0, one, d)


def _lanczos_start(b, atol, rtol):
    """β₀ = ‖b‖, ε = atol + rtol·β₀ and v = b/β₀ (b where β₀ = 0)."""
    one = _scalar(1, b)
    beta0 = torch.sqrt(torch.sum(b * b))
    eps_lim = _scalar(atol, b) + _scalar(rtol, b) * beta0
    return beta0, eps_lim, b / _safe(beta0, one)


def _lanczos_next(pd, offsets, s, one):
    """One normalised Lanczos step from v (and vprev from the second
    iteration on), in the TPU kernels' order: δ = vᴴAv, w = Av − δv −
    βvprev, β' = ‖w‖ (pallas_fused.py:1076-1096)."""
    av = dia_spmv_aligned_ref(pd, offsets, s.v)
    delta = torch.sum(s.v * av)
    w = av - delta * s.v
    w = torch.where(s.iter > 0, w - s.beta * s.vprev, w)
    beta = torch.sqrt(torch.sum(w * w))
    return delta, beta, w / _safe(beta, one)


def cg_lanczos_dia_fused_ref(pd, offsets, b, atol, rtol, itmax,
                             check_curvature=False):
    """Plain PyTorch CG-Lanczos of A x = b, M = I (pallas_fused.py:
    1050-1129); with check_curvature an indefinite step is not applied
    and stops the solve with status 27.

    Returns (x, niter, rnorm, anorm, status, indefinite) as tensors, as
    ``cg_lanczos_dia_fused`` does."""
    zero, one = _scalar(0, b), _scalar(1, b)
    beta0, eps_lim, v0 = _lanczos_start(b, atol, rtol)
    status0 = torch.where(
        beta0 == 0, ZERO_RESIDUAL,
        torch.where(beta0 <= eps_lim, SOLVED, RUNNING)).to(torch.int32)
    s0 = types.SimpleNamespace(
        x=torch.zeros_like(b), p=b.clone(), v=v0, vprev=v0, iter=_i32(0, b),
        beta=beta0, sigma=beta0, omega=zero, gamma=one, anorm2=zero,
        beta_prev=zero, rnorm=beta0, status=status0,
        indef=torch.zeros((), dtype=torch.bool, device=b.device))

    def step(s):
        delta, beta, v_new = _lanczos_next(pd, offsets, s, one)
        gamma = 1.0 / (delta - s.omega / s.gamma)
        indef = s.indef | (gamma <= 0)
        skip = indef & check_curvature
        anorm2 = s.anorm2 + s.beta_prev * s.beta_prev + beta * beta \
            + delta * delta
        om = beta * gamma
        sigma = -om * s.sigma
        rnorm = torch.abs(sigma)
        solved = (rnorm <= eps_lim) | ((rnorm + 1.0) <= 1.0)
        new = dict(x=s.x + gamma * s.p, p=sigma * v_new + om * om * s.p,
                   v=v_new, vprev=s.v, iter=s.iter + 1, beta=beta,
                   sigma=sigma, omega=om * om, gamma=gamma, anorm2=anorm2,
                   beta_prev=beta, rnorm=rnorm)
        new = {k: torch.where(skip, getattr(s, k), v)
               for k, v in new.items()}
        new["status"] = torch.where(
            skip, NEG_CURV, torch.where(solved, SOLVED, RUNNING)).to(
                torch.int32)
        new["indef"] = indef
        return new

    s = _drive_ref(s0, step, itmax)
    return (s.x, s.iter, s.rnorm, torch.sqrt(s.anorm2), s.status,
            s.indef.to(torch.int32))


def cg_lanczos_shift_dia_fused_ref(pd, offsets, b, shifts, atol, rtol,
                                   itmax, check_curvature=False):
    """Plain PyTorch CG-Lanczos of every (A + σᵢI) xᵢ = b from one
    Lanczos stream, M = I (pallas_fused.py:1215-1309).  ``shifts`` is a
    1-D tensor on b's device.  A converged shift, and with
    check_curvature an indefinite one, freezes; the solve stops when
    every shift is done.

    Returns (X (nshifts, n), niter, rnorms, status, indefinite) as
    tensors, as ``cg_lanczos_shift_dia_fused`` does."""
    one = _scalar(1, b)
    ns = shifts.shape[0]
    beta0, eps_lim, v0 = _lanczos_start(b, atol, rtol)
    conv0 = (beta0 <= eps_lim).expand(ns).clone()
    status0 = torch.where(
        beta0 == 0, ZERO_RESIDUAL,
        torch.where(conv0.all(), SOLVED, RUNNING)).to(torch.int32)
    s0 = types.SimpleNamespace(
        X=torch.zeros((ns, b.shape[0]), dtype=b.dtype, device=b.device),
        P=b.expand(ns, -1).clone(), v=v0, vprev=v0, iter=_i32(0, b),
        beta=beta0, sigma=beta0.expand(ns).clone(),
        omega=torch.zeros_like(shifts), gamma=torch.ones_like(shifts),
        rnorm=beta0.expand(ns).clone(), conv=conv0,
        indef=torch.zeros(ns, dtype=torch.bool, device=b.device),
        status=status0)

    def step(s):
        delta, beta, v_new = _lanczos_next(pd, offsets, s, one)
        gamma = 1.0 / ((delta + shifts) - s.omega / s.gamma)
        indef = s.indef | (gamma <= 0)
        mask = ~(s.conv | (indef & check_curvature))
        col = mask[:, None]
        om = beta * gamma
        sigma = torch.where(mask, -om * s.sigma, s.sigma)
        om2 = torch.where(mask, om * om, s.omega)
        rnorm = torch.where(mask, torch.abs(sigma), s.rnorm)
        conv = torch.where(mask, rnorm <= eps_lim, s.conv)
        done = (conv | (indef & check_curvature)).all()
        return dict(
            X=torch.where(col, s.X + gamma[:, None] * s.P, s.X),
            P=torch.where(col, sigma[:, None] * v_new + om2[:, None] * s.P,
                          s.P),
            v=v_new, vprev=s.v, iter=s.iter + 1, beta=beta, sigma=sigma,
            omega=om2, gamma=torch.where(mask, gamma, s.gamma),
            rnorm=rnorm, conv=conv, indef=indef,
            status=torch.where(done, SOLVED, RUNNING).to(torch.int32))

    s = _drive_ref(s0, step, itmax)
    return s.X, s.iter, s.rnorm, s.status, s.indef.to(torch.int32)


def symmlq_dia_fused_ref(pd, offsets, b, atol, rtol, ctol, lam, itmax,
                         transfer_to_cg=True):
    """Plain PyTorch SYMMLQ of (A + λI) x = b, M = I (pallas_fused.py:
    3755-3881), with the CG-point transfer x += ζ̄·w̄ after the stop when
    the CG test stopped the solve.

    Returns (x, niter, rnorm, status, anorm2, gmax, gmin) as tensors, as
    ``symmlq_dia_fused`` does."""
    tiny = torch.finfo(b.dtype).tiny
    zero, one = _scalar(0, b), _scalar(1, b)
    ctol_v, lam_v = _scalar(ctol, b), _scalar(lam, b)
    beta1, tol, vold = _lanczos_start(b, atol, rtol)
    y = dia_spmv_aligned_ref(pd, offsets, vold) + lam_v * vold
    alpha = torch.sum(vold * y)
    y = y - alpha * vold
    beta = torch.sqrt(torch.sum(y * y))
    zetabar = beta1 / _safe(alpha, one)
    rcg = beta1 * torch.abs(zetabar)
    solved_cg0 = (alpha != 0) & (rcg <= tol) & transfer_to_cg
    status0 = torch.where(
        beta1 == 0, ZERO_RESIDUAL,
        torch.where(beta1 <= tol, SOLVED_LQ,
                    torch.where(solved_cg0, SOLVED_CG_PT, RUNNING))).to(
                        torch.int32)
    s0 = types.SimpleNamespace(
        x=torch.zeros_like(b), wbar=vold.clone(), vold=vold,
        v=y / _safe(beta, one), iter=_i32(0, b), beta=beta, gbar=alpha,
        dbar=beta, eps_old=zero, eta=beta1, zold=zero, zetabar=zetabar,
        anorm2=alpha * alpha + beta * beta, gmax=_scalar(-math.inf, b),
        gmin=_scalar(math.inf, b), xnorm2=zero, rnorm=beta1, rcg=rcg,
        cgflag=solved_cg0, status=status0)

    def step(s):
        cs, sn, gamma = sym_givens(s.gbar, s.beta)
        zeta = s.eta / _safe(gamma, one)
        x = s.x + (cs * zeta) * s.wbar + (sn * zeta) * s.v
        wbar = sn * s.wbar - cs * s.v
        y = dia_spmv_aligned_ref(pd, offsets, s.v) + lam_v * s.v
        alpha = torch.sum(s.v * y)
        y = y - s.beta * s.vold - alpha * s.v
        beta = torch.sqrt(torch.sum(y * y))
        anorm2 = s.anorm2 + alpha * alpha + s.beta * s.beta + beta * beta
        delta = s.dbar * cs + alpha * sn
        gbar = s.dbar * sn - alpha * cs
        eta = -s.eps_old * s.zold - delta * zeta
        rnorm = torch.sqrt(gamma * gamma * zeta * zeta
                           + s.eps_old * s.eps_old * s.zold * s.zold)
        xnorm2 = s.xnorm2 + zeta * zeta
        gbar_nz = gbar != 0
        zetabar = torch.where(gbar_nz, eta / _safe(gbar, one), s.zetabar)
        rcg = torch.where(gbar_nz, beta * torch.abs(sn * zeta - cs * zetabar),
                          s.rcg)
        gmax = torch.maximum(s.gmax, gamma)
        gmin = torch.minimum(s.gmin, gamma)
        acond = torch.clamp(gmax / torch.clamp(gmin, min=tiny), min=tiny)
        test1 = rnorm / torch.clamp(torch.sqrt(anorm2) * torch.sqrt(xnorm2),
                                    min=tiny)
        solved_lq = rnorm <= tol
        solved_cg = gbar_nz & (rcg <= tol) & transfer_to_cg
        solved = (((1.0 + rnorm) <= 1.0) | solved_lq | solved_cg
                  | ((1.0 + test1) <= 1.0) | (test1 <= tol))
        code = _i32(RUNNING, b)
        for cond, c in ((((1.0 + 1.0 / acond) <= 1.0), ILL_COND_MACH),
                        ((1.0 / acond) <= ctol_v, COND_EXCEEDED),
                        (solved, SOLVED_GEN), (solved & solved_lq, SOLVED_LQ),
                        (solved & solved_cg, SOLVED_CG_PT)):
            code = torch.where(cond, c, code)
        return dict(
            x=x, wbar=wbar, vold=s.v, v=y / _safe(beta, one),
            iter=s.iter + 1, beta=beta, gbar=gbar, dbar=-beta * cs,
            eps_old=beta * sn, eta=eta, zold=zeta, zetabar=zetabar,
            anorm2=anorm2, gmax=gmax, gmin=gmin, xnorm2=xnorm2, rnorm=rnorm,
            rcg=rcg, cgflag=solved_cg, status=code.to(torch.int32))

    s = _drive_ref(s0, step, itmax)
    x = torch.where(s.cgflag, s.x + s.zetabar * s.wbar, s.x)
    return x, s.iter, s.rnorm, s.status, s.anorm2, s.gmax, s.gmin


# ---------------------------------------------------------------------------
# MINRES-QLP and MINARES: the plain versions
# ---------------------------------------------------------------------------

def minres_qlp_dia_fused_ref(pd, offsets, b, atol, rtol, artol, lam, itmax):
    """Plain PyTorch MINRES-QLP of (A + λI) x = b, M = I (pallas_fused.py:
    3966-4160): the Lanczos stream, the QR and LQ rotations with the
    iter == 1 / 2 / ≥ 3 selects, the μmin/μmax and Artol tests, and the
    final correction x += τₖ₋₁wₖ₋₁ + τₖwₖ after the stop (τₖ dropped
    when the last iteration found the system inconsistent).

    Returns (x, niter, rnorm, status, inconsistent, arnorm) as tensors,
    as ``minres_qlp_dia_fused`` does."""
    eps = torch.finfo(b.dtype).eps
    tiny = torch.finfo(b.dtype).tiny
    btol = _scalar(eps ** 0.75, b)
    zero, one = _scalar(0, b), _scalar(1, b)
    artol_v, lam_v = _scalar(artol, b), _scalar(lam, b)
    beta1, eps_lim, v0 = _lanczos_start(b, atol, rtol)
    status0 = torch.where(
        beta1 == 0, ZERO_RESIDUAL,
        torch.where(beta1 <= eps_lim, SOLVED, RUNNING)).to(torch.int32)
    s0 = types.SimpleNamespace(
        x=torch.zeros_like(b), v=v0, vkm1=torch.zeros_like(b),
        wkm1=torch.zeros_like(b), wk=torch.zeros_like(b), iter=_i32(0, b),
        beta_k=beta1, zetabar=beta1, xi_km1=zero, tau_km2=zero,
        tau_km1=zero, tau_k=zero, psibar_km2=zero, mubis_km2=zero,
        mubar_km1=zero, c_km2=one, c_km1=one, s_km2=zero, s_km1=zero,
        mumin=zero, mumax=zero, anorm2=zero, rnorm=beta1, arnorm=zero,
        kappa=zero, incon=torch.zeros((), dtype=torch.bool, device=b.device),
        status=status0)

    def step(s):
        it = s.iter + 1
        is1, is2, ge2, ge3 = it == 1, it == 2, it >= 2, it >= 3
        p = dia_spmv_aligned_ref(pd, offsets, s.v) + lam_v * s.v
        p = p - torch.where(ge2, s.beta_k, zero) * s.vkm1
        alpha = torch.sum(s.v * p)
        p = p - alpha * s.v
        beta_kp1 = torch.sqrt(torch.sum(p * p))
        vkp1 = torch.where(beta_kp1 > btol, p / _safe(beta_kp1, one), p)
        anorm2 = s.anorm2 + alpha * alpha + s.beta_k * s.beta_k \
            + beta_kp1 * beta_kp1

        eps_km2 = torch.where(ge3, s.s_km2 * s.beta_k, zero)
        gbar_km1 = torch.where(ge3, -s.c_km2 * s.beta_k,
                               torch.where(is2, s.beta_k, zero))
        g_km1 = s.c_km1 * gbar_km1 + s.s_km1 * alpha
        lbar_k = torch.where(is1, alpha, s.s_km1 * gbar_km1 - s.c_km1 * alpha)
        ck, sk, l_k = sym_givens(lbar_k, beta_kp1)
        zeta = ck * s.zetabar
        zetabar_next = sk * s.zetabar

        cp2, sp2, mubis2 = sym_givens(s.mubar_km1, g_km1)
        cp3, sp3, mu_km2 = sym_givens(s.mubis_km2, eps_km2)
        psi_km2 = cp3 * s.psibar_km2 + sp3 * g_km1
        theta_k = sp3 * s.psibar_km2 - cp3 * g_km1
        rho_km2 = sp3 * l_k
        eta_k = -cp3 * l_k
        cd, sd, mubis3 = sym_givens(s.mubar_km1, theta_k)
        mubar_k = torch.where(is1, l_k,
                              torch.where(is2, -cp2 * l_k, -cd * eta_k))
        psibar_km1 = torch.where(is2, sp2 * l_k,
                                 torch.where(ge3, sd * eta_k, zero))
        mubis_km1 = torch.where(is2, mubis2, torch.where(ge3, mubis3, zero))
        cp = torch.where(is2, cp2, cp3)
        sp = torch.where(is2, sp2, sp3)

        tau_km2 = torch.where(ge3, s.tau_km1 * s.mubis_km2
                              / _safe(mu_km2, one), s.tau_km2)
        tau_km1 = torch.where(
            is2, s.tau_k * s.mubar_km1 / _safe(mubis2, one),
            torch.where(ge3, (s.xi_km1 - psi_km2 * tau_km2)
                        / _safe(mubis3, one), s.tau_km1))
        xi_k = torch.where(ge3, zeta - rho_km2 * tau_km2, zeta)
        tau_k = torch.where(
            is1, zeta / _safe(mubar_k, one),
            (xi_k - psibar_km1 * tau_km1) / _safe(mubar_k, one))

        waux = sp * s.wkm1 - cp * s.v
        wkm1 = torch.where(is1, s.wkm1, torch.where(
            is2, cp * s.wk + sp * s.v, cd * s.wk + sd * waux))
        wk = torch.where(is1, s.v, torch.where(
            is2, sp * s.wk - cp * s.v, sd * s.wk - cd * waux))
        x_add = torch.where(ge3, tau_km2, zero)
        x = s.x + (x_add * cp) * s.wkm1 + (x_add * sp) * s.v

        rnorm = torch.abs(zetabar_next)
        arnorm = torch.abs(s.zetabar) * torch.sqrt(
            lbar_k * lbar_k + (s.c_km1 * beta_kp1) ** 2)
        kappa = torch.where(is1, _scalar(atol, b) + artol_v * arnorm,
                            s.kappa)
        abs_mubar = torch.abs(mubar_k)
        lo = torch.minimum(mubis_km1, abs_mubar)
        hi = torch.maximum(mubis_km1, abs_mubar)
        mumin = torch.where(is1, abs_mubar, torch.where(
            is2, torch.minimum(s.mumin, lo),
            torch.minimum(s.mumin, torch.minimum(mu_km2, lo))))
        mumax = torch.where(is1, abs_mubar, torch.where(
            is2, torch.maximum(s.mumax, hi),
            torch.maximum(s.mumax, torch.maximum(mu_km2, hi))))
        acond = mumax / torch.clamp(mumin, min=tiny)
        xnorm = torch.sqrt(torch.sum(x * x))
        backward = rnorm / torch.clamp(torch.sqrt(anorm2) * xnorm, min=tiny)

        zero_resid = ((1.0 + backward) <= 1.0) | (backward <= eps)
        solved = ((1.0 + rnorm) <= 1.0) | (rnorm <= eps_lim) | zero_resid
        incon = ((arnorm <= kappa) & (abs_mubar <= artol_v)) \
            | ((beta_kp1 <= btol) & ~solved)
        code = _i32(RUNNING, b)
        for cond, c in (((1.0 + 1.0 / torch.clamp(acond, min=tiny)) <= 1.0,
                         ILL_COND_MACH), (incon, SOLVED_LSQ),
                        (zero_resid, SOLVED_ZERO), (solved, SOLVED)):
            code = torch.where(cond, c, code)
        return dict(
            x=x, v=vkp1, vkm1=s.v, wkm1=wkm1, wk=wk, iter=it,
            beta_k=beta_kp1, zetabar=zetabar_next, xi_km1=xi_k,
            tau_km2=tau_km2, tau_km1=tau_km1, tau_k=tau_k,
            psibar_km2=torch.where(ge2, psibar_km1, s.psibar_km2),
            mubis_km2=torch.where(ge2, mubis_km1, s.mubis_km2),
            mubar_km1=mubar_k, c_km2=torch.where(ge2, s.c_km1, s.c_km2),
            c_km1=ck, s_km2=torch.where(ge2, s.s_km1, s.s_km2), s_km1=sk,
            mumin=mumin, mumax=mumax, anorm2=anorm2, rnorm=rnorm,
            arnorm=arnorm, kappa=kappa, incon=incon,
            status=code.to(torch.int32))

    s = _drive_ref(s0, step, itmax)
    add1 = torch.where(s.iter >= 2, s.tau_km1, zero)
    add2 = torch.where(s.incon, zero, s.tau_k)
    x = torch.where(s.iter >= 1, s.x + add1 * s.wkm1 + add2 * s.wk, s.x)
    return x, s.iter, s.rnorm, s.status, s.incon.to(torch.int32), s.arnorm


def minares_dia_fused_ref(pd, offsets, b, atol, rtol, artol, lam, itmax):
    """Plain PyTorch MINARES of (A + λI) x = b (pallas_fused.py:
    4248-4485): the Lanczos stream one step ahead of the iteration,
    stopped at its breakdown (it ≤ ℓ − 1) while the iteration goes on,
    the QR-within-QR reflection cascade, the W and D recurrences and the
    π/τ residual estimates.

    Returns (x, niter, rnorm, arnorm, status) as tensors, as
    ``minares_dia_fused`` does; the status codes are 0 running, 2 zero
    residual, 7 breakdown and 37 solved."""
    btol = _scalar(torch.finfo(b.dtype).eps ** 0.75, b)
    zero, one = _scalar(0, b), _scalar(1, b)
    lam_v = _scalar(lam, b)
    beta1, eps_lim, vk = _lanczos_start(b, atol, rtol)
    q = dia_spmv_aligned_ref(pd, offsets, vk) + lam_v * vk
    alpha1 = torch.sum(vk * q)
    q = q - alpha1 * vk
    beta2 = torch.sqrt(torch.sum(q * q))
    b1a1, b1b2 = beta1 * alpha1, beta1 * beta2
    arnorm0 = torch.sqrt(b1a1 * b1a1 + b1b2 * b1b2)
    kappa = _scalar(atol, b) + _scalar(artol, b) * arnorm0
    status0 = torch.where(
        beta1 == 0, ZERO_RESIDUAL,
        torch.where((beta1 <= eps_lim) | (arnorm0 <= kappa), SOLVED_ARTOL,
                    RUNNING)).to(torch.int32)
    s0 = types.SimpleNamespace(
        x=torch.zeros_like(b), vk=vk,
        vkp1=torch.where(beta2 != 0, q / _safe(beta2, one), q),
        **{k: torch.zeros_like(b) for k in ("wkm2", "wkm1", "dkm2", "dkm1")},
        **{k: zero for k in (
            "gamma_km1", "lambdabar_k", "gammabar_k", "eps_km2", "eps_km1",
            "xi_km1", "tau_km2", "tau_km1", "tau_k", "thetabar_km2",
            "psibis_km2", "psibar_km1", "pi_km2", "pi_km1", "chibar_k",
            "ct4", "st4", "ct3", "st3", "ct2", "st2")},
        iter=_i32(0, b), alpha_k=alpha1, beta_k=beta1, beta_kp1=beta2,
        zetabis_k=b1a1, zetabar_kp1=b1b2, ell=_i32(itmax + 2, b),
        rnorm=beta1, arnorm=arnorm0, status=status0)

    def step(s):
        it = s.iter + 1
        is1, is2, ge2, ge3 = it == 1, it == 2, it >= 2, it >= 3
        lambdabar_k = torch.where(is1, s.alpha_k, s.lambdabar_k)
        gammabar_k = torch.where(is1, s.beta_kp1, s.gammabar_k)
        chibar_k = torch.where(is1, s.beta_k, s.chibar_k)
        ck, sk, l_k = sym_givens(lambdabar_k, s.beta_kp1)
        w_k = (s.vk - s.gamma_km1 * s.wkm1 - s.eps_km2 * s.wkm2) \
            / _safe(l_k, one)

        lan_ok = it <= s.ell - 1
        q = dia_spmv_aligned_ref(pd, offsets, s.vkp1) + lam_v * s.vkp1 \
            - s.beta_kp1 * s.vk
        alpha_kp1 = torch.sum(q * s.vkp1)
        q = q - alpha_kp1 * s.vkp1
        beta_kp2 = torch.sqrt(torch.sum(q * q))
        brk = beta_kp2 <= btol
        ell = torch.where(lan_ok & brk, it + 1, s.ell).to(torch.int32)
        v_next = torch.where(lan_ok & ~brk, q / _safe(beta_kp2, one), q)
        alpha_kp1 = torch.where(lan_ok, alpha_kp1, s.alpha_k)
        beta_kp2 = torch.where(lan_ok, beta_kp2, zero)

        two_ok = it <= ell - 2
        one_ok = it <= ell - 1
        eps_k = torch.where(two_ok, sk * beta_kp2, zero)
        gammabar_kp1 = torch.where(two_ok, -ck * beta_kp2, zero)
        gamma_k = torch.where(one_ok, ck * gammabar_k + sk * alpha_kp1, zero)
        lambdabar_kp1 = torch.where(one_ok, sk * gammabar_k - ck * alpha_kp1,
                                    zero)

        rho_km2 = torch.where(ge3, s.st4 * l_k, zero)
        lhat_k = torch.where(ge3, -s.ct4 * l_k, torch.where(is2, l_k, zero))
        phibar_km1 = torch.where(ge2, s.st3 * lhat_k, zero)
        mubar_k = torch.where(ge2, -s.ct3 * lhat_k, l_k)
        phi_km1 = torch.where(ge2, torch.where(
            one_ok, s.ct2 * phibar_km1 + s.st2 * gamma_k, phibar_km1), zero)
        ghat_k = torch.where(ge2, torch.where(
            one_ok, s.st2 * phibar_km1 - s.ct2 * gamma_k, zero), gamma_k)

        ct1n, st1n, mubis_k_g = sym_givens(mubar_k, ghat_k)
        ct1 = torch.where(one_ok, ct1n, one)
        st1 = torch.where(one_ok, st1n, zero)
        mubis_k = torch.where(one_ok, mubis_k_g, mubar_k)
        ct0n, st0n, mu_k_g = sym_givens(mubis_k, eps_k)
        ct0 = torch.where(two_ok, ct0n, one)
        st0 = torch.where(two_ok, st0n, zero)
        mu_k = torch.where(two_ok, mu_k_g, mubis_k)

        zring_k = torch.where(one_ok, ct1 * s.zetabis_k
                              + st1 * s.zetabar_kp1, s.zetabis_k)
        zetabis_kp1 = torch.where(one_ok, st1 * s.zetabis_k
                                  - ct1 * s.zetabar_kp1, zero)
        zeta_k = torch.where(two_ok, ct0 * zring_k, zring_k)
        zetabar_kp2 = torch.where(two_ok, st0 * zring_k, zero)

        d_k = (w_k - phi_km1 * s.dkm1 - rho_km2 * s.dkm2) / _safe(mu_k, one)
        x = s.x + zeta_k * d_k
        arnorm = torch.where(
            two_ok, torch.sqrt(zetabis_kp1 ** 2 + zetabar_kp2 ** 2),
            torch.where(it == ell - 1, torch.abs(zetabis_kp1), zero))

        chm3_2, shm3_2, psibis2 = sym_givens(s.psibar_km1, phi_km1)
        chm4, shm4, psi_km2 = sym_givens(s.psibis_km2, rho_km2)
        theta_km2 = chm4 * s.thetabar_km2 + shm4 * phi_km1
        delta_k = shm4 * s.thetabar_km2 - chm4 * phi_km1
        omega_km2 = shm4 * mu_k
        eta_k = -chm4 * mu_k
        chm3_3, shm3_3, psibis3 = sym_givens(s.psibar_km1, delta_k)
        psibar_k = torch.where(is1, mu_k, torch.where(
            is2, -chm3_2 * mu_k, -chm3_3 * eta_k))
        thetabar_km1 = torch.where(is2, shm3_2 * mu_k, torch.where(
            ge3, shm3_3 * eta_k, zero))
        psibis_km1 = torch.where(is2, psibis2,
                                 torch.where(ge3, psibis3, zero))

        tau_km2 = torch.where(ge3, s.tau_km1 * s.psibis_km2
                              / _safe(psi_km2, one), s.tau_km2)
        tau_km1 = torch.where(
            is2, s.tau_k * s.psibar_km1 / _safe(psibis2, one),
            torch.where(ge3, (s.xi_km1 - theta_km2 * tau_km2)
                        / _safe(psibis3, one), s.tau_km1))
        xi_k = torch.where(ge3, zeta_k - omega_km2 * tau_km2, zeta_k)
        tau_k = torch.where(
            is1, zeta_k / _safe(psibar_k, one),
            (xi_k - thetabar_km1 * tau_km1) / _safe(psibar_k, one))

        chi_k = ck * chibar_k
        chibar_kp1 = sk * chibar_k
        pi3a_k = shm4 * s.pi_km2 - chm4 * chi_k
        pi_km1_mid = torch.where(
            is2, chm3_2 * s.pi_km1 + shm3_2 * chi_k,
            torch.where(ge3, chm3_3 * s.pi_km1 + shm3_3 * pi3a_k, s.pi_km1))
        pi_k = torch.where(is1, chi_k, torch.where(
            is2, shm3_2 * s.pi_km1 - chm3_2 * chi_k,
            shm3_3 * s.pi_km1 - chm3_3 * pi3a_k))
        pi_km2 = torch.where(ge3, chm4 * s.pi_km2 + shm4 * chi_k, s.pi_km2)
        rnorm = torch.where(
            is1, torch.sqrt((pi_k - tau_k) ** 2 + chibar_kp1 ** 2),
            torch.sqrt((pi_km1_mid - tau_km1) ** 2 + (pi_k - tau_k) ** 2
                       + chibar_kp1 ** 2))

        solved = (rnorm <= eps_lim) | (arnorm <= kappa)
        code = torch.where(solved, SOLVED_ARTOL, torch.where(
            s.beta_kp1 <= btol, BREAKDOWN, RUNNING)).to(torch.int32)
        return dict(
            x=x, vk=s.vkp1, vkp1=v_next,
            wkm2=torch.where(ge2, s.wkm1, s.wkm2), wkm1=w_k,
            dkm2=torch.where(ge2, s.dkm1, s.dkm2), dkm1=d_k, iter=it,
            alpha_k=torch.where(one_ok, alpha_kp1, s.alpha_k),
            beta_k=s.beta_kp1,
            beta_kp1=torch.where(one_ok, beta_kp2, s.beta_kp1),
            gamma_km1=torch.where(one_ok, gamma_k, s.gamma_km1),
            lambdabar_k=torch.where(one_ok, lambdabar_kp1, lambdabar_k),
            gammabar_k=torch.where(two_ok, gammabar_kp1, gammabar_k),
            eps_km2=torch.where(ge2, s.eps_km1, s.eps_km2),
            eps_km1=torch.where(two_ok, eps_k, s.eps_km1),
            xi_km1=xi_k, tau_km2=tau_km2, tau_km1=tau_km1, tau_k=tau_k,
            thetabar_km2=torch.where(ge2, thetabar_km1, s.thetabar_km2),
            psibis_km2=torch.where(ge2, psibis_km1, s.psibis_km2),
            psibar_km1=psibar_k,
            pi_km2=torch.where(ge2, pi_km1_mid, pi_km2), pi_km1=pi_k,
            chibar_k=chibar_kp1,
            zetabis_k=torch.where(one_ok, zetabis_kp1, s.zetabis_k),
            zetabar_kp1=torch.where(two_ok, zetabar_kp2, s.zetabar_kp1),
            ct4=torch.where(ge2, s.ct2, s.ct4),
            st4=torch.where(ge2, s.st2, s.st4),
            ct3=ct1, st3=st1, ct2=ct0, st2=st0, ell=ell, rnorm=rnorm,
            arnorm=arnorm, status=code)

    s = _drive_ref(s0, step, itmax)
    return s.x, s.iter, s.rnorm, s.arnorm, s.status


# ---------------------------------------------------------------------------
# GMRES and FOM: the plain versions
# ---------------------------------------------------------------------------

def _mgs_ref(V, k, w, T):
    """w orthogonalised against v₀..vₖ by sequential MGS in T
    (pallas_fused.py:1995-2010): (h₀..hₖ, w′)."""
    hs = []
    for i in range(k + 1):
        vi = V[i].to(T)
        hij = torch.sum(vi * w)
        hs.append(hij)
        w = w - hij * vi
    return torch.stack(hs), w


class _GramMGS:
    """MGS's coefficients as ``csrc/arnoldi.cuh`` computes them, in plain
    PyTorch: cⱼ = ⟨vⱼ, w⟩ against the unmodified w (j ≤ k), the Gram row
    G[k, j] = ⟨vₖ, vⱼ⟩ (j < k; the rows of the pass's earlier iterations
    kept), hᵢ = cᵢ − Σ_{j<i} G[i, j] hⱼ by forward substitution, then
    w −= hⱼvⱼ for j = 0..k in order: the same h and w′ as ``_mgs_ref`` in
    exact arithmetic.  A step function of ``_arnoldi_ref``; nothing on
    the card's path uses it."""

    def __init__(self, mem):
        self.mem, self.G = mem, None

    def __call__(self, V, k, w, T):
        if self.G is None:
            self.G = torch.zeros((self.mem, self.mem), dtype=T,
                                 device=w.device)
        vs = [V[j].to(T) for j in range(k + 1)]
        c = [torch.sum(v * w) for v in vs]
        for j in range(k):
            self.G[k, j] = torch.sum(vs[k] * vs[j])
        h = []
        for i in range(k + 1):
            acc = c[i]
            for j in range(i):
                acc = acc - self.G[i, j] * h[j]
            h.append(acc)
        for j in range(k + 1):
            w = w - h[j] * vs[j]
        return torch.stack(h), w


def _arnoldi_step_ref(pd, offsets, V, k, T, step=_mgs_ref):
    """w = A vₖ, orthogonalised against v₀..vₖ in T by ``step`` (sequential
    MGS by default); V[k+1] = w/‖w‖ in the panel's type.  Returns the
    column h₀..hₖ and ‖w‖ as 0-d tensors on the host, where the
    Hessenberg's scalar recurrences run."""
    w = dia_spmv_aligned_ref(pd, offsets, V[k].to(T))
    h, w = step(V, k, w, T)
    hbis = torch.sqrt(torch.sum(w * w))
    V[k + 1] = (w / _safe(hbis, _scalar(1, w))).to(V.dtype)
    return h.cpu(), hbis.cpu()


def _restart_ref(pd, offsets, b, x, V):
    """V[0] = r/‖r‖ with r = b − Ax, the true residual; returns ‖r‖ on
    the host."""
    r = b - dia_spmv_aligned_ref(pd, offsets, x)
    beta = torch.sqrt(torch.sum(r * r))
    V[0] = (r / _safe(beta, _scalar(1, r))).to(V.dtype)
    return beta.cpu()


def _xacc_ref(x, V, y):
    """x + Σᵢ yᵢvᵢ, one term after another (pallas_fused.py:2073-2077)."""
    for i in range(y.shape[0]):
        x = x + y[i].to(x.device) * V[i].to(x.dtype)
    return x


def _back_substitute_ref(R, zz, kk, btol=None):
    """Solve R[:kk, :kk] y = zz[:kk] from the last row up, each row's sum
    in the order of the TPU kernel; with ``btol`` a pivot of modulus ≤
    btol gives yᵢ = 0 and sets the returned flag (GMRES), without it a
    zero pivot divides by 1 (FOM)."""
    one = torch.ones((), dtype=R.dtype)
    y = torch.zeros(kk, dtype=R.dtype)
    sing = False
    for i in reversed(range(kk)):
        acc = zz[i]
        for j in range(i + 1, kk):
            acc = acc - R[i, j] * y[j]
        diag = R[i, i]
        if btol is None:
            y[i] = acc / _safe(diag, one)
        elif torch.abs(diag) <= btol:
            y[i] = 0
            sing = True
        else:
            y[i] = acc / diag
    return y, sing


def _arnoldi_ref(pd, offsets, b, atol, rtol, itmax, mem, basis_dtype,
                 column, step=_mgs_ref):
    """The restarted Arnoldi solve shared by GMRES and FOM, as the TPU
    kernels run it (pallas_fused.py:1956-2136, 4970-5090).  The vectors
    stay on b's device; the Hessenberg column's scalars run on the host
    in b's dtype, which reads the state once per iteration, and an
    iteration runs only while status == RUNNING and it < itmax, so
    niter is what the kernel's chunks give.  ``column(k, h, hbis)``
    updates the factorisation and returns ‖rₖ‖; ``column.finish(kk)``
    back-substitutes and returns (y, singular).  ``step`` orthogonalises
    w (``_arnoldi_step_ref``): sequential MGS, or ``_GramMGS(mem)``, the
    kernel's arithmetic."""
    T = b.dtype
    BT = T if basis_dtype is None else basis_dtype
    confirm = basis_dtype is not None
    n = b.shape[0]
    btol = torch.tensor(torch.finfo(T).eps ** 0.75, dtype=T)
    V = torch.zeros((mem + 1, n), dtype=BT, device=b.device)
    x = torch.zeros_like(b)
    beta0 = torch.sqrt(torch.sum(b * b))
    V[0] = (b / _safe(beta0, _scalar(1, b))).to(BT)
    beta0 = beta0.cpu()
    eps_lim = torch.tensor(atol, dtype=T) + torch.tensor(rtol, dtype=T) \
        * beta0
    status = (ZERO_RESIDUAL if beta0 == 0
              else SOLVED if beta0 <= eps_lim else RUNNING)
    it, k, rnorm, incons, npass = 0, 0, beta0, False, 1
    prev_tr = torch.tensor(math.inf, dtype=T)
    column.zz[0] = beta0
    while status == RUNNING and it < itmax:
        h, hbis = _arnoldi_step_ref(pd, offsets, V, k, T, step)
        rnorm_n = column(k, h, hbis)
        it, kk = it + 1, k + 1
        resid = bool((rnorm_n <= eps_lim) | ((rnorm_n + 1.0) <= 1.0))
        brk = bool(hbis <= btol)
        tired = it >= itmax
        inner_done = resid or brk or tired or kk >= mem
        glob_done = resid or brk or tired
        tmp0, sing, confirmed = rnorm_n, False, False
        if inner_done:
            y, sing = column.finish(kk)
            x = _xacc_ref(x, V, y)
            if confirm or not glob_done:
                beta_r = _restart_ref(pd, offsets, b, x, V)
                column.zz[0] = tmp0 = beta_r
                confirmed = bool((beta_r <= eps_lim)
                                 | ((beta_r + 1.0) <= 1.0))
        if confirm:
            final = resid and (confirmed or bool(tmp0 > 0.5 * prev_tr))
            if inner_done and resid and not final:
                prev_tr = tmp0
        else:
            final = resid
        glob_final = final or brk or tired
        incons_now = column.incons(inner_done, resid, brk, sing)
        incons = incons or incons_now
        status = column.code(tired, final, brk, incons) \
            if inner_done and glob_final else RUNNING
        k = 0 if inner_done else kk
        if inner_done and not glob_final:
            npass += 1
            rnorm = tmp0
        else:
            rnorm = rnorm_n
    dev = b.device
    return (x, _i32(it, b), rnorm.to(dev, T), _i32(status, b),
            _i32(int(incons), b), _i32(npass, b))


class _GmresColumn:
    """Givens QR of the Hessenberg (pallas_fused.py:2012-2035)."""

    def __init__(self, mem, T, btol):
        self.c = torch.zeros(mem, dtype=T)
        self.s = torch.zeros(mem, dtype=T)
        self.zz = torch.zeros(mem + 1, dtype=T)
        self.R = torch.zeros((mem, mem), dtype=T)
        self.btol = btol

    def __call__(self, k, h, hbis):
        for i in range(k):
            hi, hi1 = h[i].clone(), h[i + 1].clone()
            h[i] = self.c[i] * hi + self.s[i] * hi1
            h[i + 1] = self.s[i] * hi - self.c[i] * hi1
        ck, sk, rkk = sym_givens(h[k], hbis)
        self.c[k], self.s[k], h[k] = ck, sk, rkk
        self.R[:k + 1, k] = h
        zeta_next = sk * self.zz[k]
        self.zz[k] = ck * self.zz[k]
        self.zz[k + 1] = zeta_next
        return torch.abs(zeta_next)

    def finish(self, kk):
        return _back_substitute_ref(self.R, self.zz, kk, self.btol)

    @staticmethod
    def incons(inner_done, resid, brk, sing):
        return inner_done and sing

    @staticmethod
    def code(tired, final, brk, incons):
        code = BREAKDOWN
        code = TIRED if tired else code
        code = SOLVED if final else code
        return INCONSISTENT if incons else code


class _FomColumn:
    """LU of the Hessenberg (pallas_fused.py:5013-5036)."""

    def __init__(self, mem, T):
        self.l = torch.zeros(mem, dtype=T)
        self.zz = torch.zeros(mem + 1, dtype=T)
        self.U = torch.zeros((mem, mem), dtype=T)

    def __call__(self, k, h, hbis):
        for i in range(1, k + 1):
            h[i] = h[i] - self.l[i - 1] * h[i - 1]
        safe_u = _safe(h[k], torch.ones_like(h[k]))
        if k >= 1:
            self.zz[k] = -self.l[k - 1] * self.zz[k - 1]
        self.l[k] = hbis / safe_u
        self.U[:k + 1, k] = h
        return hbis * torch.abs(self.zz[k] / safe_u)

    def finish(self, kk):
        return _back_substitute_ref(self.U, self.zz, kk)

    @staticmethod
    def incons(inner_done, resid, brk, sing):
        return inner_done and brk and not resid

    @staticmethod
    def code(tired, final, brk, incons):
        code = TIRED
        code = INCONS_FOM if brk else code
        return SOLVED if final else code


def gmres_dia_fused_ref(pd, offsets, b, atol, rtol, itmax, mem=20,
                        basis_dtype=None):
    """Plain PyTorch restarted GMRES(mem) of A x = b (pallas_fused.py:
    1956-2136): sequential MGS Arnoldi, Givens QR, the back substitution
    with its singular-pivot flag and restarts from the true residual.
    With ``basis_dtype`` the Krylov panel is stored in that type, all
    arithmetic stays in b's, and a stop on the residual estimate holds
    only when the true residual confirms it or a confirmed pass
    stagnated.

    Returns (x, niter, rnorm, status, inconsistent, npass) as tensors, as
    ``gmres_dia_fused`` does."""
    btol = torch.tensor(torch.finfo(b.dtype).eps ** 0.75, dtype=b.dtype)
    col = _GmresColumn(mem, b.dtype, btol)
    return _arnoldi_ref(pd, offsets, b, atol, rtol, itmax, mem, basis_dtype,
                        col)


def fom_dia_fused_ref(pd, offsets, b, atol, rtol, itmax, mem=20):
    """Plain PyTorch restarted FOM(mem) of A x = b (pallas_fused.py:
    4970-5090): the Arnoldi process of GMRES with the LU of the
    Hessenberg; a breakdown without convergence stops with status 28.

    Returns (x, niter, rnorm, status, inconsistent, npass) as tensors, as
    ``fom_dia_fused`` does."""
    col = _FomColumn(mem, b.dtype)
    return _arnoldi_ref(pd, offsets, b, atol, rtol, itmax, mem, None, col)


# ---------------------------------------------------------------------------
# BiCGSTAB and CGS: the plain versions
# ---------------------------------------------------------------------------

def _biortho_start(b, atol, rtol):
    """‖b‖, ⟨b, b⟩ (ρ₀ with the shadow c = b), ε and the first status."""
    rho0 = torch.sum(b * b)
    rnorm0 = torch.sqrt(torch.sum(b * b))
    eps_lim = _scalar(atol, b) + _scalar(rtol, b) * rnorm0
    status0 = torch.where(
        rnorm0 == 0, ZERO_RESIDUAL,
        torch.where(rho0 == 0, BC_BREAKDOWN,
                    torch.where(rnorm0 <= eps_lim, SOLVED, RUNNING))).to(
                        torch.int32)
    return rho0, rnorm0, eps_lim, status0


def _biortho_code(rnorm, eps_lim, alpha):
    solved = (rnorm <= eps_lim) | ((rnorm + 1.0) <= 1.0)
    breakdown = (alpha == 0) | torch.isnan(alpha)
    return torch.where(solved, SOLVED, torch.where(
        breakdown, ALPHA_BREAKDOWN, RUNNING)).to(torch.int32)


def bicgstab_dia_fused_ref(pd, offsets, b, atol, rtol, itmax):
    """Plain PyTorch BiCGSTAB of A x = b with the shadow c = b
    (pallas_fused.py:3049-3090), x updated as (x + αp) + ωs.

    Returns (x, niter, rnorm, status) as tensors, as
    ``bicgstab_dia_fused`` does."""
    one = _scalar(1, b)
    rho0, rnorm0, eps_lim, status0 = _biortho_start(b, atol, rtol)
    s0 = types.SimpleNamespace(
        x=torch.zeros_like(b), r=b.clone(), p=b.clone(), iter=_i32(0, b),
        rho=rho0, rnorm=rnorm0, status=status0)

    def step(s):
        v = dia_spmv_aligned_ref(pd, offsets, s.p)
        alpha = s.rho / _safe(torch.sum(b * v), one)
        sv = s.r - alpha * v
        x_aux = s.x + alpha * s.p
        t = dia_spmv_aligned_ref(pd, offsets, sv)
        omega = torch.sum(t * sv) / _safe(torch.sum(t * t), one)
        r = sv - omega * t
        next_rho = torch.sum(b * r)
        beta = (next_rho / _safe(s.rho, one)) * (alpha / _safe(omega, one))
        rnorm = torch.sqrt(torch.sum(r * r))
        return dict(x=x_aux + omega * sv, r=r,
                    p=r + beta * (s.p - omega * v), iter=s.iter + 1,
                    rho=next_rho, rnorm=rnorm,
                    status=_biortho_code(rnorm, eps_lim, alpha))

    s = _drive_ref(s0, step, itmax)
    return s.x, s.iter, s.rnorm, s.status


def cgs_dia_fused_ref(pd, offsets, b, atol, rtol, itmax):
    """Plain PyTorch CGS of A x = b with the shadow c = b
    (pallas_fused.py:3180-3230).

    Returns (x, niter, rnorm, status) as tensors, as ``cgs_dia_fused``
    does."""
    one = _scalar(1, b)
    rho0, rnorm0, eps_lim, status0 = _biortho_start(b, atol, rtol)
    s0 = types.SimpleNamespace(
        x=torch.zeros_like(b), r=b.clone(), u=b.clone(), p=b.clone(),
        iter=_i32(0, b), rho=rho0, rnorm=rnorm0, status=status0)

    def step(s):
        t = dia_spmv_aligned_ref(pd, offsets, s.p)
        alpha = s.rho / _safe(torch.sum(b * t), one)
        q = s.u - alpha * t
        u_half = s.u + q
        r = s.r - alpha * dia_spmv_aligned_ref(pd, offsets, u_half)
        rho_next = torch.sum(b * r)
        beta = rho_next / _safe(s.rho, one)
        u = r + beta * q
        rnorm = torch.sqrt(torch.sum(r * r))
        return dict(x=s.x + alpha * u_half, r=r, u=u,
                    p=u + beta * (q + beta * s.p), iter=s.iter + 1,
                    rho=rho_next, rnorm=rnorm,
                    status=_biortho_code(rnorm, eps_lim, alpha))

    s = _drive_ref(s0, step, itmax)
    return s.x, s.iter, s.rnorm, s.status


# ---------------------------------------------------------------------------
# DIOM and DQGMRES: the plain version
# ---------------------------------------------------------------------------

def _pmod(a, m):
    """a mod m in [0, m), as jnp.mod for m > 0."""
    return ((a % m) + m) % m


def trunc_dia_fused_ref(pd, offsets, b, atol, rtol, itmax, mem=20,
                        variant="dqgmres"):
    """Plain PyTorch DIOM or DQGMRES of A x = b (pallas_fused.py:
    5160-5350): circular V (mem) and P (mem − 1 for DIOM, mem for
    DQGMRES) rings, window classical Gram-Schmidt (every dot against the
    unmodified w, then the subtractions in slot order), the
    diagonal-indexed Hessenberg column with DIOM's LU pivots or
    DQGMRES's rotation ring, p = (vₖ − Σ coef P)/denom and x += γ p.  The
    vectors stay on b's device; the column's scalars run on the host in
    b's dtype, which reads the state once per iteration, and an
    iteration runs only while status == RUNNING and it < itmax.

    Returns (x, niter, rnorm, status) as tensors, as ``trunc_dia_fused``
    does."""
    diom = variant == "diom"
    mP = mem - 1 if diom else mem
    T = b.dtype
    np_t = torch.empty(0, dtype=T).numpy().dtype.type
    n = b.shape[0]
    x = torch.zeros_like(b)
    V = torch.zeros((mem, n), dtype=T, device=b.device)
    P = torch.zeros((mP, n), dtype=T, device=b.device)
    beta0 = torch.sqrt(torch.sum(b * b))
    V[0] = b / _safe(beta0, _scalar(1, b))
    beta0 = np_t(beta0.item())
    eps_lim = np_t(atol) + np_t(rtol) * beta0
    L = np.zeros(mem, np_t)
    S = np.zeros(mem, np_t)
    status = (ZERO_RESIDUAL if beta0 == 0
              else SOLVED if beta0 <= eps_lim else RUNNING)
    k, xi, rnorm = 0, beta0, beta0
    while status == RUNNING and k < itmax:
        it1, pos = k + 1, k % mem
        vk = V[pos]
        w = dia_spmv_aligned_ref(pd, offsets, vk)
        # window CGS: every dot against the unmodified w, then subtract
        hs = torch.stack([torch.sum(V[j] * w) for j in range(mem)])
        valid = [k - _pmod(pos - j, mem) >= 0 for j in range(mem)]
        hs = torch.where(torch.tensor(valid, device=b.device), hs,
                         torch.zeros_like(hs))
        for j in range(mem):
            w = w - hs[j] * V[j]
        haux = torch.sqrt(torch.sum(w * w))
        hv = torch.cat([hs, haux.reshape(1)]).cpu().numpy()
        haux = hv[mem]
        H = np.zeros(mem + 2, np_t)
        for j in range(mem):
            i_idx = k - _pmod(pos - j, mem)
            if i_idx >= 0:
                H[k - i_idx + 1] = H[k - i_idx + 1] + hv[j]
        if diom:
            for i in range(max(2, it1 - mem + 2), it1 + 1):
                lslot, diag = (i - 1) % (mem - 1), it1 - i + 1
                H[diag] = H[diag] - L[lslot] * H[diag + 1]
                if i == it1:
                    xi = -L[lslot] * xi
            safe_u = np_t(1) if H[1] == 0 else H[1]
            L[it1 % (mem - 1)] = haux / safe_u
            gamma_step, rnorm, denom = xi, haux * np.abs(xi / safe_u), safe_u
        else:
            for i in range(max(1, it1 - mem), it1):
                slot, diag = (i - 1) % mem, it1 - i
                ci, si = L[slot], S[slot]
                hi1, hi0 = H[diag + 1], H[diag]
                H[diag] = si * hi1 - ci * hi0
                H[diag + 1] = ci * hi1 + si * hi0
            ck, sk, rkk = (v.item() for v in sym_givens(
                torch.tensor(H[1]), torch.tensor(haux)))
            H[1] = rkk
            L[pos], S[pos] = ck, sk
            gamma_step, xi = np_t(ck) * xi, np_t(sk) * xi
            rnorm = np.abs(xi)
            denom = np_t(1) if H[1] == 0 else H[1]
        lowP = k - mem + 1 if diom else k - mem
        psum = torch.zeros_like(b)
        for jp in range(mP):
            iP = (k - 1) - _pmod((k - 1) - jp, mP)
            ok = iP >= 0 and iP >= lowP and iP <= k - 1
            coef = H[k - iP + 1] if ok else np_t(0)
            psum = psum + _scalar(coef, b) * P[jp]
        p_new = (vk - psum) / _scalar(denom, b)
        P[k % mP] = p_new
        x = x + _scalar(gamma_step, b) * p_new
        if haux != 0:
            V[(k + 1) % mem] = w / _scalar(haux, b)
        solved = rnorm <= eps_lim or rnorm + np_t(1) <= np_t(1)
        status = SOLVED if solved else RUNNING
        k = it1
    return x, _i32(k, b), _scalar(rnorm, b), _i32(status, b)


# ---------------------------------------------------------------------------
# BiLQ, QMR and BiLQR: the plain versions
# ---------------------------------------------------------------------------

def _bi_start(b, c):
    """‖b‖, cᴴb (‖b‖² when c is None: the shadow c = b, as the TPU
    kernels take it), β₁ = √|cᴴb|, γ₁ = cᴴb/β₁, v₁ = b/β₁, u₁ = c/γ₁."""
    one = _scalar(1, b)
    bnorm = torch.sqrt(torch.sum(b * b))
    chb = bnorm * bnorm if c is None else torch.sum(c * b)
    beta = torch.sqrt(torch.abs(chb))
    gamma = chb / _safe(beta, one)
    return (bnorm, chb, beta, gamma, b / _safe(beta, one),
            (b if c is None else c) / _safe(gamma, one))


def _bi_lanczos_ref(pd, offsets, pd_adj, offsets_adj, s, one):
    """q = A vₖ − γ vₖ₋₁, p = Aᴴuₖ − β uₖ₋₁, α = ⟨uₖ, q⟩, q −= αvₖ,
    p −= αuₖ, pᴴq (after both updates), β' = √|pᴴq|, γ' = pᴴq/β'
    (pallas_fused.py:4617-4632)."""
    q = dia_spmv_aligned_ref(pd, offsets, s.vk) - s.gamma * s.vkm1
    p = dia_spmv_aligned_ref(pd_adj, offsets_adj, s.uk) - s.beta * s.ukm1
    alpha = torch.sum(s.uk * q)
    q = q - alpha * s.vk
    p = p - alpha * s.uk
    phq = torch.sum(p * q)
    beta1 = torch.sqrt(torch.abs(phq))
    gamma1 = phq / _safe(beta1, one)
    nz = phq != 0
    vk1 = torch.where(nz, q / _safe(beta1, one), s.vk)
    uk1 = torch.where(nz, p / _safe(gamma1, one), s.uk)
    return alpha, phq, beta1, gamma1, vk1, uk1


def _lq_step(s, it, alpha, one, zero):
    """The LQ factorisation of Tₖ shared by BiLQ and BiLQR (pallas_fused.
    py:4634-4645): (ck, sk, d_{k-1}, λ_{k-1}, ε_{k-2}, d̄ₖ)."""
    is1, is2 = it == 1, it == 2
    ck_g, sk_g, d_km1 = sym_givens(s.dbar_km1, s.gamma)
    ck = torch.where(is1, -one, ck_g)
    sk = torch.where(is1, zero, sk_g)
    eps_km2 = s.s_km1 * s.beta
    lam2 = ck * s.beta + sk * alpha
    dbar2 = sk * s.beta - ck * alpha
    lam3 = -s.c_km1 * ck * s.beta + sk * alpha
    dbar3 = -s.c_km1 * sk * s.beta - ck * alpha
    lam_km1 = torch.where(is2, lam2, lam3)
    dbar_k = torch.where(is1, alpha, torch.where(is2, dbar2, dbar3))
    return ck, sk, d_km1, lam_km1, eps_km2, dbar_k


def bilq_dia_fused_ref(pd, pd_adj, offsets, offsets_adj, b, atol, rtol,
                       itmax, transfer_to_bicg=True):
    """Plain PyTorch BiLQ of A x = b with the shadow c = b (pallas_fused.
    py:4545-4706): the two-sided Lanczos step on A and Aᴴ, the LQ of Tₖ,
    the residual estimates of the LQ and BiCG points, and the transfer to
    the BiCG point when its test stops the solve.

    Returns (x, niter, rnorm, status) as tensors, as ``bilq_dia_fused``
    does."""
    eps = torch.finfo(b.dtype).eps
    one, zero = _scalar(1, b), _scalar(0, b)
    bnorm, chb, beta0, gamma0, v1, u1 = _bi_start(b, None)
    eps_lim = _scalar(atol, b) + _scalar(rtol, b) * bnorm
    status0 = torch.where(
        bnorm == 0, ZERO_RESIDUAL, torch.where(
            chb == 0, BC_BREAKDOWN, torch.where(
                bnorm <= eps_lim, SOLVED_LQ, RUNNING))).to(torch.int32)
    s0 = types.SimpleNamespace(
        x=torch.zeros_like(b), vk=v1, uk=u1, vkm1=torch.zeros_like(b),
        ukm1=torch.zeros_like(b), dbar=torch.zeros_like(b), iter=_i32(0, b),
        beta=beta0, gamma=gamma0, c_km1=-one, s_km1=zero, dbar_km1=zero,
        zeta_km1=zero, zeta_km2=zero, eta_km1=zero, zetabar=zero,
        norm_vk=bnorm / _safe(torch.abs(beta0), one), rnorm=bnorm,
        cgflag=_i32(0, b), status=status0)

    def step(s):
        it = s.iter + 1
        is1, is2, ge2 = it == 1, it == 2, it >= 2
        alpha, phq, beta1, gamma1, vk1, uk1 = _bi_lanczos_ref(
            pd, offsets, pd_adj, offsets_adj, s, one)
        ck, sk, d_km1, lam_km1, eps_km2, dbar_k = _lq_step(s, it, alpha,
                                                           one, zero)
        zeta_km1 = torch.where(ge2, s.eta_km1 / _safe(d_km1, one),
                               s.zeta_km1)
        zeta_km2 = torch.where(it >= 3, s.zeta_km1, s.zeta_km2)
        eta_k = torch.where(is1, s.beta, torch.where(
            is2, -lam_km1 * zeta_km1,
            -eps_km2 * zeta_km2 - lam_km1 * zeta_km1))
        x_add = torch.where(ge2, zeta_km1, zero)
        x = s.x + (x_add * ck) * s.dbar + (x_add * sk) * s.vk
        dbar = torch.where(is1, s.vk, sk * s.dbar - ck * s.vk)
        vhv = torch.sum(s.vk * vk1)
        norm_vkp1 = torch.sqrt(torch.sum(vk1 * vk1))
        mu = s.beta * (s.s_km1 * zeta_km2 - s.c_km1 * ck * zeta_km1) \
            + alpha * sk * zeta_km1
        om = beta1 * sk * zeta_km1
        th = mu * om * vhv
        rnorm_lq = torch.where(is1, s.rnorm, torch.sqrt(
            mu * mu * s.norm_vk * s.norm_vk
            + om * om * norm_vkp1 * norm_vkp1 + 2 * th))
        dbar_ok = torch.abs(dbar_k) > eps
        zetabar = torch.where(dbar_ok, eta_k / _safe(dbar_k, one),
                              s.zetabar)
        rho = beta1 * (sk * zeta_km1 - ck * zetabar)
        rnorm_cg = torch.abs(rho) * norm_vkp1
        solved_lq = rnorm_lq <= eps_lim
        solved_cg = (dbar_ok & (rnorm_cg <= eps_lim)) if transfer_to_bicg \
            else torch.zeros_like(solved_lq)
        breakdown = ~solved_lq & ~solved_cg & (phq == 0)
        code = torch.where(solved_cg & ~solved_lq, SOLVED_CG_PT, torch.where(
            solved_lq, SOLVED_LQ, torch.where(breakdown, UV_BREAKDOWN,
                                              RUNNING))).to(torch.int32)
        return dict(x=x, vk=vk1, uk=uk1, vkm1=s.vk, ukm1=s.uk, dbar=dbar,
                    iter=it, beta=beta1, gamma=gamma1, c_km1=ck, s_km1=sk,
                    dbar_km1=dbar_k, zeta_km1=zeta_km1, zeta_km2=zeta_km2,
                    eta_km1=eta_k, zetabar=zetabar, norm_vk=norm_vkp1,
                    rnorm=rnorm_lq,
                    cgflag=(solved_cg & ~solved_lq).to(torch.int32),
                    status=code)

    s = _drive_ref(s0, step, itmax)
    x = torch.where(s.cgflag == 1, s.x + s.zetabar * s.dbar, s.x)
    return x, s.iter, s.rnorm, s.status


def qmr_dia_fused_ref(pd, pd_adj, offsets, offsets_adj, b, atol, rtol,
                      itmax):
    """Plain PyTorch QMR of A x = b with the shadow c = b (pallas_fused.
    py:4755-4880): the two-sided Lanczos step, the QR of Tₖ₊₁.ₖ by
    ``sym_givens`` and the w_{k-2}, w_{k-1} direction recurrence.

    Returns (x, niter, rnorm, status) as tensors, as ``qmr_dia_fused``
    does."""
    one, zero = _scalar(1, b), _scalar(0, b)
    bnorm, chb, beta0, gamma0, v1, u1 = _bi_start(b, None)
    eps_lim = _scalar(atol, b) + _scalar(rtol, b) * bnorm
    status0 = torch.where(
        bnorm == 0, ZERO_RESIDUAL, torch.where(
            chb == 0, BC_BREAKDOWN, torch.where(
                bnorm <= eps_lim, SOLVED, RUNNING))).to(torch.int32)
    s0 = types.SimpleNamespace(
        x=torch.zeros_like(b), vk=v1, uk=u1, vkm1=torch.zeros_like(b),
        ukm1=torch.zeros_like(b), wkm2=torch.zeros_like(b),
        wkm1=torch.zeros_like(b), iter=_i32(0, b), beta=beta0, gamma=gamma0,
        c_km2=zero, s_km2=zero, c_km1=zero, s_km1=zero, zetabar=beta0,
        tau=bnorm * bnorm / _safe(torch.abs(beta0), one) ** 2, rnorm=bnorm,
        status=status0)

    def step(s):
        it = s.iter + 1
        is2, ge2, ge3 = it == 2, it >= 2, it >= 3
        alpha, phq, beta1, gamma1, vk1, uk1 = _bi_lanczos_ref(
            pd, offsets, pd_adj, offsets_adj, s, one)
        eps_km2 = torch.where(ge3, s.s_km2 * s.gamma, zero)
        lbar_km1 = torch.where(ge3, -s.c_km2 * s.gamma,
                               torch.where(is2, s.gamma, zero))
        lam_km1 = torch.where(ge2, s.c_km1 * lbar_km1 + s.s_km1 * alpha,
                              zero)
        dbar_k = torch.where(ge2, s.s_km1 * lbar_km1 - s.c_km1 * alpha,
                             alpha)
        ck, sk, d_k = sym_givens(dbar_k, beta1)
        zeta_k = ck * s.zetabar
        zetabar = sk * s.zetabar
        w_k = (s.vk - lam_km1 * s.wkm1 - eps_km2 * s.wkm2) / _safe(d_k, one)
        tau = s.tau + torch.sum(vk1 * vk1)
        rnorm = torch.abs(zetabar) * torch.sqrt(tau)
        solved = (rnorm <= eps_lim) | ((rnorm + 1.0) <= 1.0)
        breakdown = ~solved & (phq == 0)
        code = torch.where(solved, SOLVED, torch.where(
            breakdown, UV_BREAKDOWN, RUNNING)).to(torch.int32)
        return dict(x=s.x + zeta_k * w_k, vk=vk1, uk=uk1, vkm1=s.vk,
                    ukm1=s.uk, wkm2=torch.where(ge2, s.wkm1, s.wkm2),
                    wkm1=w_k, iter=it, beta=beta1, gamma=gamma1,
                    c_km2=s.c_km1, s_km2=s.s_km1, c_km1=ck, s_km1=sk,
                    zetabar=zetabar, tau=tau, rnorm=rnorm, status=code)

    s = _drive_ref(s0, step, itmax)
    return s.x, s.iter, s.rnorm, s.status


def bilqr_dia_fused_ref(pd, pd_adj, offsets, offsets_adj, b, c, atol, rtol,
                        itmax, transfer_to_bicg=True):
    """Plain PyTorch BiLQR of A x = b and Aᴴ y = c (pallas_fused.py:
    7400-7640): one two-sided Lanczos process feeding the primal BiLQ
    recurrences and the dual QMR-like ones, each frozen once its own
    system is solved, and the transfer of x to the BiCG point.

    Returns (x, y, niter, rnorm, snorm, status, flags) as tensors, as
    ``bilqr_dia_fused`` does; flags = [lq_tol, lq_mach, cg_tol, cg_mach,
    qr_tol, qr_mach, solved_primal, solved_dual, breakdown]."""
    eps = torch.finfo(b.dtype).eps
    one, zero = _scalar(1, b), _scalar(0, b)
    i0 = _i32(0, b)
    bnorm, chb, beta0, gamma0, v1, u1 = _bi_start(b, c)
    cnorm = torch.sqrt(torch.sum(c * c))
    eps_l = _scalar(atol, b) + _scalar(rtol, b) * bnorm
    eps_q = _scalar(atol, b) + _scalar(rtol, b) * cnorm
    sp0, sd0 = (bnorm == 0).to(torch.int32), (cnorm == 0).to(torch.int32)
    status0 = torch.where(
        chb == 0, BC_BREAKDOWN, torch.where(
            (sp0 == 1) & (sd0 == 1), ZERO_RESIDUAL, RUNNING)).to(torch.int32)
    s0 = types.SimpleNamespace(
        x=torch.zeros_like(b), y=torch.zeros_like(b), vk=v1, uk=u1,
        vkm1=torch.zeros_like(b), ukm1=torch.zeros_like(b),
        dbar=torch.zeros_like(b), wkm3=torch.zeros_like(b),
        wkm2=torch.zeros_like(b), iter=i0, beta=beta0, gamma=gamma0,
        c_km1=-one, s_km1=zero, dbar_km1=zero, zeta_km1=zero, zeta_km2=zero,
        eta_km1=zero, zetabar=zero, psibar_km1=zero, eps_km3=zero,
        lam_km2=zero, norm_vk=bnorm / _safe(torch.abs(beta0), one),
        tau=zero, rnorm=bnorm, snorm=cnorm, sp=sp0, sd=sd0, lq_t=i0,
        lq_m=i0, cg_t=i0, cg_m=i0, qr_t=i0, qr_m=i0, cgflag=i0, brk=i0,
        status=status0)

    def step(s):
        it = s.iter + 1
        is1, is2, ge2 = it == 1, it == 2, it >= 2
        alpha, phq, beta1, gamma1, vk1, uk1 = _bi_lanczos_ref(
            pd, offsets, pd_adj, offsets_adj, s, one)
        ck, sk, d_km1, lam_km1, eps_km2, dbar_k = _lq_step(s, it, alpha,
                                                           one, zero)
        # primal block (frozen once solved)
        pm = s.sp == 0
        zeta_km1 = torch.where(pm & ge2, s.eta_km1 / _safe(d_km1, one),
                               s.zeta_km1)
        zeta_km2 = torch.where(pm & (it >= 3), s.zeta_km1, s.zeta_km2)
        eta_k = torch.where(pm, torch.where(is1, s.beta, torch.where(
            is2, -lam_km1 * zeta_km1,
            -eps_km2 * zeta_km2 - lam_km1 * zeta_km1)), s.eta_km1)
        x_add = torch.where(pm & ge2, zeta_km1, zero)
        x = s.x + (x_add * ck) * s.dbar + (x_add * sk) * s.vk
        dbar = torch.where(pm, torch.where(is1, s.vk,
                                           sk * s.dbar - ck * s.vk), s.dbar)
        # dual block (the old u_{k-1})
        dm = s.sd == 0
        psi_km1 = torch.where(is1, zero, ck * s.psibar_km1)
        psibar_k = torch.where(is1, s.gamma, sk * s.psibar_km1)
        d = _safe(d_km1, one)
        w2 = s.ukm1 / d
        w3 = (s.ukm1 - s.lam_km2 * s.wkm2) / d
        w4 = (s.ukm1 - s.lam_km2 * s.wkm2 - s.eps_km3 * s.wkm3) / d
        w_km1 = torch.where(is2, w2, torch.where(it == 3, w3, w4))
        y = s.y + torch.where(dm & ge2, psi_km1, zero) * w_km1
        tau = torch.where(dm, s.tau + torch.sum(s.uk * s.uk), s.tau)
        snorm = torch.where(dm, torch.abs(psibar_k) * torch.sqrt(tau),
                            s.snorm)
        vhv = torch.sum(s.vk * vk1)
        norm_vkp1 = torch.sqrt(torch.sum(vk1 * vk1))
        mu = s.beta * (s.s_km1 * zeta_km2 - s.c_km1 * ck * zeta_km1) \
            + alpha * sk * zeta_km1
        om = beta1 * sk * zeta_km1
        th = mu * om * vhv
        rnorm_lq = torch.where(is1, s.rnorm, torch.sqrt(
            mu * mu * s.norm_vk * s.norm_vk
            + om * om * norm_vkp1 * norm_vkp1 + 2 * th))
        rnorm_lq = torch.where(pm, rnorm_lq, s.rnorm)
        dbar_ok = torch.abs(dbar_k) > eps
        zetabar = torch.where(pm & dbar_ok, eta_k / _safe(dbar_k, one),
                              s.zetabar)
        rho = beta1 * (sk * zeta_km1 - ck * zetabar)
        rnorm_cg = torch.abs(rho) * norm_vkp1
        if transfer_to_bicg:
            cg_t_b = dbar_ok & (rnorm_cg <= eps_l)
            cg_m_b = dbar_ok & ((rnorm_cg + 1.0) <= 1.0)
        else:
            cg_t_b = cg_m_b = torch.zeros_like(dbar_ok)

        def keep(cond, new, old):
            return torch.where(cond, new.to(torch.int32), old)

        lq_t = keep(pm, rnorm_lq <= eps_l, s.lq_t)
        lq_m = keep(pm, (rnorm_lq + 1.0) <= 1.0, s.lq_m)
        cg_t = keep(pm, cg_t_b, s.cg_t)
        cg_m = keep(pm, cg_m_b, s.cg_m)
        solved_lq = (lq_t == 1) | (lq_m == 1)
        solved_cg = (cg_t == 1) | (cg_m == 1)
        sp = keep(pm & (solved_lq | solved_cg), torch.ones_like(pm), s.sp)
        qr_t = keep(dm, snorm <= eps_q, s.qr_t)
        qr_m = keep(dm, (snorm + 1.0) <= 1.0, s.qr_m)
        sd = keep(dm & ((qr_t == 1) | (qr_m == 1)), torch.ones_like(dm),
                  s.sd)
        brk = ~solved_lq & ~solved_cg & (phq == 0)
        code = torch.where(brk, UV_BREAKDOWN, torch.where(
            (sp == 1) & (sd == 1), SOLVED_PRIMAL_DUAL, RUNNING)).to(
                torch.int32)
        cgflag = keep((s.cgflag == 1) | (solved_cg & pm & ~solved_lq),
                      torch.ones_like(pm), s.cgflag)
        return dict(
            x=x, y=y, vk=vk1, uk=uk1, vkm1=s.vk, ukm1=s.uk, dbar=dbar,
            wkm3=torch.where(ge2, s.wkm2, s.wkm3),
            wkm2=torch.where(ge2, w_km1, s.wkm2), iter=it, beta=beta1,
            gamma=gamma1, c_km1=ck, s_km1=sk, dbar_km1=dbar_k,
            zeta_km1=zeta_km1, zeta_km2=zeta_km2, eta_km1=eta_k,
            zetabar=zetabar, psibar_km1=psibar_k,
            eps_km3=torch.where(it >= 3, eps_km2, s.eps_km3),
            lam_km2=torch.where(ge2, lam_km1, s.lam_km2), norm_vk=norm_vkp1,
            tau=tau, rnorm=rnorm_lq, snorm=snorm, sp=sp, sd=sd, lq_t=lq_t,
            lq_m=lq_m, cg_t=cg_t, cg_m=cg_m, qr_t=qr_t, qr_m=qr_m,
            cgflag=cgflag, brk=brk.to(torch.int32), status=code)

    s = _drive_ref(s0, step, itmax)
    x = torch.where(s.cgflag == 1, s.x + s.zetabar * s.dbar, s.x)
    flags = torch.stack([s.lq_t, s.lq_m, s.cg_t, s.cg_m, s.qr_t, s.qr_m,
                         s.sp, s.sd, s.brk])
    return x, s.y, s.iter, s.rnorm, s.snorm, s.status, flags


# ---------------------------------------------------------------------------
# USYMLQ, USYMQR, TriLQR and USYMLQR: the plain versions
# ---------------------------------------------------------------------------

def _ssy_start(b, c):
    """‖b‖, ‖c‖, v₁ = b/‖b‖ and u₁ = c/‖c‖ (pallas_fused.py:6615-6621)."""
    one = _scalar(1, b)
    bnorm = torch.sqrt(torch.sum(b * b))
    cnorm = torch.sqrt(torch.sum(c * c))
    return bnorm, cnorm, b / _safe(bnorm, one), c / _safe(cnorm, one)


def _ssy_ref(pd, offsets, pd_adj, offsets_adj, s, one, zero):
    """q = A uₖ − γ vₖ₋₁ and p = Aᴴ vₖ − β uₖ₋₁ (the β and γ terms from
    the second iteration on), α = ⟨vₖ, q⟩, q −= α vₖ, p −= α uₖ,
    βₖ₊₁ = ‖q‖, γₖ₊₁ = ‖p‖ (pallas_fused.py:6646-6658)."""
    g2 = torch.where(s.iter >= 1, one, zero)
    q = dia_spmv_aligned_ref(pd, offsets, s.uk) - (g2 * s.gamma) * s.vkm1
    p = dia_spmv_aligned_ref(pd_adj, offsets_adj, s.vk) \
        - (g2 * s.beta) * s.ukm1
    alpha = torch.sum(s.vk * q)
    q = q - alpha * s.vk
    p = p - alpha * s.uk
    return q, p, alpha, torch.sqrt(torch.sum(q * q)), \
        torch.sqrt(torch.sum(p * p))


def _ssy_next(q, p, beta1, gamma1, vk, uk, one):
    """vₖ₊₁ = q/βₖ₊₁ and uₖ₊₁ = p/γₖ₊₁, or vₖ and uₖ where the norm is 0
    (pallas_fused.py:6688-6691)."""
    return (torch.where(beta1 != 0, q / _safe(beta1, one), vk),
            torch.where(gamma1 != 0, p / _safe(gamma1, one), uk))


def usymlq_dia_fused_ref(pd, pd_adj, offsets, offsets_adj, b, c, atol, rtol,
                         itmax, transfer_to_usymcg=True):
    """Plain PyTorch USYMLQ of A x = b (pallas_fused.py:6565-6706): the SSY
    process (A on u, Aᴴ on v), the LQ of Tₖ, the residual estimates of the
    LQ and USYMCG points, and the transfer to the USYMCG point when its
    test stops the solve.

    Returns (x, niter, rnorm, status) as tensors, as ``usymlq_dia_fused``
    does."""
    eps = torch.finfo(b.dtype).eps
    one, zero = _scalar(1, b), _scalar(0, b)
    bnorm, gamma0, v1, u1 = _ssy_start(b, c)
    eps_lim = _scalar(atol, b) + _scalar(rtol, b) * bnorm
    status0 = torch.where(bnorm == 0, ZERO_RESIDUAL, torch.where(
        bnorm <= eps_lim, SOLVED_LQ, RUNNING)).to(torch.int32)
    s0 = types.SimpleNamespace(
        x=torch.zeros_like(b), vk=v1, uk=u1, vkm1=torch.zeros_like(b),
        ukm1=torch.zeros_like(b), dbar=torch.zeros_like(b), iter=_i32(0, b),
        beta=bnorm, gamma=gamma0, c_km1=-one, s_km1=zero, dbar_km1=zero,
        zeta_km1=zero, zeta_km2=zero, eta_km1=zero, zetabar=zero,
        rnorm=bnorm, cgflag=_i32(0, b), status=status0)

    def step(s):
        it = s.iter + 1
        is1, is2, ge2 = it == 1, it == 2, it >= 2
        q, p, alpha, beta1, gamma1 = _ssy_ref(pd, offsets, pd_adj,
                                              offsets_adj, s, one, zero)
        # the LQ of T_k is BiLQ's (pallas_fused.py:6660-6670)
        ck, sk, d_km1, lam_km1, eps_km2, dbar_k = _lq_step(s, it, alpha,
                                                           one, zero)
        zeta_km1 = torch.where(ge2, s.eta_km1 / _safe(d_km1, one),
                               s.zeta_km1)
        zeta_km2 = torch.where(it >= 3, s.zeta_km1, s.zeta_km2)
        eta_k = torch.where(is1, s.beta, torch.where(
            is2, -lam_km1 * zeta_km1,
            -eps_km2 * zeta_km2 - lam_km1 * zeta_km1))
        x_add = torch.where(ge2, zeta_km1, zero)
        x = s.x + (x_add * ck) * s.dbar + (x_add * sk) * s.uk
        dbar = torch.where(is1, s.uk, sk * s.dbar - ck * s.uk)
        vk1, uk1 = _ssy_next(q, p, beta1, gamma1, s.vk, s.uk, one)
        mu = s.beta * (s.s_km1 * zeta_km2 - s.c_km1 * ck * zeta_km1) \
            + alpha * sk * zeta_km1
        om = beta1 * sk * zeta_km1
        rnorm_lq = torch.where(is1, s.rnorm, torch.sqrt(mu * mu + om * om))
        dbar_ok = torch.abs(dbar_k) > eps
        zetabar = torch.where(dbar_ok, eta_k / _safe(dbar_k, one),
                              s.zetabar)
        rnorm_cg = torch.abs(beta1 * (sk * zeta_km1 - ck * zetabar))
        solved_lq = rnorm_lq <= eps_lim
        solved_cg = (dbar_ok & (rnorm_cg <= eps_lim)) if transfer_to_usymcg \
            else torch.zeros_like(solved_lq)
        code = torch.where(solved_lq, SOLVED_LQ, torch.where(
            solved_cg, SOLVED_CG_PT, RUNNING)).to(torch.int32)
        return dict(x=x, vk=vk1, uk=uk1, vkm1=s.vk, ukm1=s.uk, dbar=dbar,
                    iter=it, beta=beta1, gamma=gamma1, c_km1=ck, s_km1=sk,
                    dbar_km1=dbar_k, zeta_km1=zeta_km1, zeta_km2=zeta_km2,
                    eta_km1=eta_k, zetabar=zetabar, rnorm=rnorm_lq,
                    cgflag=(solved_cg & ~solved_lq).to(torch.int32),
                    status=code)

    s = _drive_ref(s0, step, itmax)
    x = torch.where(s.cgflag == 1, s.x + s.zetabar * s.dbar, s.x)
    return x, s.iter, s.rnorm, s.status


def usymqr_dia_fused_ref(pd, pd_adj, offsets, offsets_adj, b, c, atol, rtol,
                         itmax):
    """Plain PyTorch USYMQR of min ‖b − Ax‖ (pallas_fused.py:6756-6882):
    the SSY process, the QR of Tₖ₊₁.ₖ by ``sym_givens``, the w_{k-2},
    w_{k-1} direction recurrence and the ‖Aᴴr‖ inconsistency test.

    Returns (x, niter, rnorm, arnorm, status, inconsistent) as tensors, as
    ``usymqr_dia_fused`` does."""
    one, zero = _scalar(1, b), _scalar(0, b)
    bnorm, gamma0, v1, u1 = _ssy_start(b, c)
    eps_lim = _scalar(atol, b) + _scalar(rtol, b) * bnorm
    status0 = torch.where(bnorm == 0, ZERO_RESIDUAL, torch.where(
        bnorm <= eps_lim, SOLVED, RUNNING)).to(torch.int32)
    s0 = types.SimpleNamespace(
        x=torch.zeros_like(b), vk=v1, uk=u1, vkm1=torch.zeros_like(b),
        ukm1=torch.zeros_like(b), wkm2=torch.zeros_like(b),
        wkm1=torch.zeros_like(b), iter=_i32(0, b), beta=bnorm, gamma=gamma0,
        c_km2=zero, s_km2=zero, c_km1=zero, s_km1=zero, zetabar=bnorm,
        kappa=zero, rnorm=bnorm, arnorm=zero, incon=_i32(0, b),
        status=status0)

    def step(s):
        it = s.iter + 1
        is1, is2, ge2, ge3 = it == 1, it == 2, it >= 2, it >= 3
        q, p, alpha, beta1, gamma1 = _ssy_ref(pd, offsets, pd_adj,
                                              offsets_adj, s, one, zero)
        eps_km2 = torch.where(ge3, s.s_km2 * s.gamma, zero)
        lbar_km1 = torch.where(ge3, -s.c_km2 * s.gamma,
                               torch.where(is2, s.gamma, zero))
        lam_km1 = torch.where(ge2, s.c_km1 * lbar_km1 + s.s_km1 * alpha,
                              zero)
        dbar_k = torch.where(ge2, s.s_km1 * lbar_km1 - s.c_km1 * alpha,
                             alpha)
        ck, sk, d_k = sym_givens(dbar_k, beta1)
        zeta_k = ck * s.zetabar
        zetabar = sk * s.zetabar
        w_k = (s.uk - lam_km1 * s.wkm1 - eps_km2 * s.wkm2) / _safe(d_k, one)
        vk1, uk1 = _ssy_next(q, p, beta1, gamma1, s.vk, s.uk, one)
        rnorm = torch.abs(zetabar)
        arnorm = torch.abs(s.zetabar) * torch.sqrt(
            dbar_k * dbar_k + (s.c_km1 * gamma1) ** 2)
        kappa = torch.where(is1, _scalar(atol, b) + _scalar(rtol, b)
                            * arnorm, s.kappa)
        solved = rnorm <= eps_lim
        incon = ~solved & (arnorm <= kappa)
        code = torch.where(solved, SOLVED, torch.where(
            incon, INCONSISTENT, RUNNING)).to(torch.int32)
        return dict(x=s.x + zeta_k * w_k, vk=vk1, uk=uk1, vkm1=s.vk,
                    ukm1=s.uk, wkm2=torch.where(ge2, s.wkm1, s.wkm2),
                    wkm1=w_k, iter=it, beta=beta1, gamma=gamma1,
                    c_km2=s.c_km1, s_km2=s.s_km1, c_km1=ck, s_km1=sk,
                    zetabar=zetabar, kappa=kappa, rnorm=rnorm,
                    arnorm=arnorm, incon=incon.to(torch.int32), status=code)

    s = _drive_ref(s0, step, itmax)
    return s.x, s.iter, s.rnorm, s.arnorm, s.status, s.incon


def trilqr_dia_fused_ref(pd, pd_adj, offsets, offsets_adj, b, c, atol, rtol,
                         itmax, transfer_to_usymcg=True):
    """Plain PyTorch TriLQR of A x = b and Aᴴ y = c (pallas_fused.py:
    7695-7910): one SSY process feeding the primal USYMLQ recurrences and
    the dual QR ones (directions from the old v_{k-1}), each frozen once
    its own system is solved or, for the dual, found inconsistent, and
    the transfer of x to the USYMCG point.

    Returns (x, y, niter, rnorm, snorm, status, flags) as tensors, as
    ``trilqr_dia_fused`` does; flags = [lq_tol, lq_mach, cg_tol, cg_mach,
    qr_tol, qr_mach, solved_primal, solved_dual, inconsistent_dual]."""
    eps = torch.finfo(b.dtype).eps
    one, zero = _scalar(1, b), _scalar(0, b)
    i0 = _i32(0, b)
    bnorm, cnorm, v1, u1 = _ssy_start(b, c)
    eps_l = _scalar(atol, b) + _scalar(rtol, b) * bnorm
    eps_q = _scalar(atol, b) + _scalar(rtol, b) * cnorm
    sp0, sd0 = (bnorm == 0).to(torch.int32), (cnorm == 0).to(torch.int32)
    status0 = torch.where((sp0 == 1) & (sd0 == 1), ZERO_RESIDUAL,
                          RUNNING).to(torch.int32)
    s0 = types.SimpleNamespace(
        x=torch.zeros_like(b), y=torch.zeros_like(b), vk=v1, uk=u1,
        vkm1=torch.zeros_like(b), ukm1=torch.zeros_like(b),
        dbar=torch.zeros_like(b), wkm3=torch.zeros_like(b),
        wkm2=torch.zeros_like(b), iter=i0, beta=bnorm, gamma=cnorm,
        c_km1=-one, s_km1=zero, dbar_km1=zero, zeta_km1=zero, zeta_km2=zero,
        eta_km1=zero, zetabar=zero, psibar_km1=zero, eps_km3=zero,
        lam_km2=zero, kappa=zero, rnorm=bnorm, snorm=cnorm, sp=sp0, sd=sd0,
        lq_t=i0, lq_m=i0, cg_t=i0, cg_m=i0, qr_t=i0, qr_m=i0, cgflag=i0,
        incd=i0, status=status0)

    def keep(cond, new, old):
        return torch.where(cond, new.to(torch.int32), old)

    def step(s):
        it = s.iter + 1
        is1, is2, ge2 = it == 1, it == 2, it >= 2
        q, p, alpha, beta1, gamma1 = _ssy_ref(pd, offsets, pd_adj,
                                              offsets_adj, s, one, zero)
        # the LQ of T_k is BiLQ's (pallas_fused.py:6660-6670)
        ck, sk, d_km1, lam_km1, eps_km2, dbar_k = _lq_step(s, it, alpha,
                                                           one, zero)
        # primal (USYMLQ), frozen once solved
        pm = s.sp == 0
        zeta_km1 = torch.where(pm & ge2, s.eta_km1 / _safe(d_km1, one),
                               s.zeta_km1)
        zeta_km2 = torch.where(pm & (it >= 3), s.zeta_km1, s.zeta_km2)
        eta_k = torch.where(pm, torch.where(is1, s.beta, torch.where(
            is2, -lam_km1 * zeta_km1,
            -eps_km2 * zeta_km2 - lam_km1 * zeta_km1)), s.eta_km1)
        x_add = torch.where(pm & ge2, zeta_km1, zero)
        x = s.x + (x_add * ck) * s.dbar + (x_add * sk) * s.uk
        dbar = torch.where(pm, torch.where(is1, s.uk,
                                           sk * s.dbar - ck * s.uk), s.dbar)
        mu = s.beta * (s.s_km1 * zeta_km2 - s.c_km1 * ck * zeta_km1) \
            + alpha * sk * zeta_km1
        om = beta1 * sk * zeta_km1
        rnorm_lq = torch.where(is1, s.rnorm, torch.sqrt(mu * mu + om * om))
        rnorm_lq = torch.where(pm, rnorm_lq, s.rnorm)
        dbar_ok = torch.abs(dbar_k) > eps
        zetabar = torch.where(pm & dbar_ok, eta_k / _safe(dbar_k, one),
                              s.zetabar)
        rnorm_cg = torch.abs(beta1 * (sk * zeta_km1 - ck * zetabar))
        if transfer_to_usymcg:
            cg_t_b = dbar_ok & (rnorm_cg <= eps_l)
            cg_m_b = dbar_ok & ((rnorm_cg + 1.0) <= 1.0)
        else:
            cg_t_b = cg_m_b = torch.zeros_like(dbar_ok)
        lq_t = keep(pm, rnorm_lq <= eps_l, s.lq_t)
        lq_m = keep(pm, (rnorm_lq + 1.0) <= 1.0, s.lq_m)
        cg_t = keep(pm, cg_t_b, s.cg_t)
        cg_m = keep(pm, cg_m_b, s.cg_m)
        solved_lq = (lq_t == 1) | (lq_m == 1)
        solved_cg = (cg_t == 1) | (cg_m == 1)
        sp = keep(pm & (solved_lq | solved_cg), torch.ones_like(pm), s.sp)
        # dual (QR on Aᴴ y = c), directions from the old v_{k-1}
        dm = s.sd == 0
        psi_km1 = torch.where(is1, zero, ck * s.psibar_km1)
        psibar_k = torch.where(is1, s.gamma, sk * s.psibar_km1)
        d = _safe(d_km1, one)
        w2 = s.vkm1 / d
        w3 = (s.vkm1 - s.lam_km2 * s.wkm2) / d
        w4 = (s.vkm1 - s.lam_km2 * s.wkm2 - s.eps_km3 * s.wkm3) / d
        w_km1 = torch.where(is2, w2, torch.where(it == 3, w3, w4))
        y = s.y + torch.where(dm & ge2, psi_km1, zero) * w_km1
        snorm = torch.where(dm, torch.abs(psibar_k), s.snorm)
        asnorm = torch.abs(psibar_k) * torch.sqrt(
            dbar_k * dbar_k + (ck * beta1) ** 2)
        kappa = torch.where(is1, _scalar(atol, b) + _scalar(rtol, b)
                            * asnorm, s.kappa)
        qr_t = keep(dm, snorm <= eps_q, s.qr_t)
        qr_m = keep(dm, (snorm + 1.0) <= 1.0, s.qr_m)
        incd = keep(dm, asnorm <= kappa, s.incd)
        sd = keep(dm & ((qr_t == 1) | (qr_m == 1) | (incd == 1)),
                  torch.ones_like(dm), s.sd)
        vk1, uk1 = _ssy_next(q, p, beta1, gamma1, s.vk, s.uk, one)
        code = torch.where((sp == 1) & (sd == 1), SOLVED_PRIMAL_DUAL,
                           RUNNING).to(torch.int32)
        cgflag = keep((s.cgflag == 1) | (solved_cg & pm & ~solved_lq),
                      torch.ones_like(pm), s.cgflag)
        return dict(
            x=x, y=y, vk=vk1, uk=uk1, vkm1=s.vk, ukm1=s.uk, dbar=dbar,
            wkm3=torch.where(ge2, s.wkm2, s.wkm3),
            wkm2=torch.where(ge2, w_km1, s.wkm2), iter=it, beta=beta1,
            gamma=gamma1, c_km1=ck, s_km1=sk, dbar_km1=dbar_k,
            zeta_km1=zeta_km1, zeta_km2=zeta_km2, eta_km1=eta_k,
            zetabar=zetabar, psibar_km1=psibar_k,
            eps_km3=torch.where(it >= 3, eps_km2, s.eps_km3),
            lam_km2=torch.where(ge2, lam_km1, s.lam_km2), kappa=kappa,
            rnorm=rnorm_lq, snorm=snorm, sp=sp, sd=sd, lq_t=lq_t, lq_m=lq_m,
            cg_t=cg_t, cg_m=cg_m, qr_t=qr_t, qr_m=qr_m, cgflag=cgflag,
            incd=incd, status=code)

    s = _drive_ref(s0, step, itmax)
    x = torch.where(s.cgflag == 1, s.x + s.zetabar * s.dbar, s.x)
    flags = torch.stack([s.lq_t, s.lq_m, s.cg_t, s.cg_m, s.qr_t, s.qr_m,
                         s.sp, s.sd, s.incd])
    return x, s.y, s.iter, s.rnorm, s.snorm, s.status, flags


def usymlqr_dia_fused_ref(pd, pd_adj, offsets, offsets_adj, b, c, atol,
                          rtol, itmax, ls=True, ln=True):
    """Plain PyTorch USYMLQR of [I A; Aᴴ 0][x; y] = [b; c] (pallas_fused.
    py:7968-8161): one SSY process feeding the least-squares QR
    recurrences (y, r and the ‖Aᴴr‖ inconsistency test) and the
    least-norm LQ ones (xᴸ, z), each frozen by its own mask, then the
    composition x = xᴸ + r, y = yₖ + zᴸ.

    Returns (x, y, niter, rnorm_ls, rnorm_ln, status, inconsistent) as
    tensors, as ``usymlqr_dia_fused`` does."""
    one, zero = _scalar(1, b), _scalar(0, b)
    i0 = _i32(0, b)
    beta0, gamma0, v1, u1 = _ssy_start(b, c)
    eps_ls = _scalar(atol, b) + _scalar(rtol, b) * beta0
    eps_ln = _scalar(atol, b) + _scalar(rtol, b) * gamma0
    true = torch.ones((), dtype=torch.bool, device=b.device)
    sls0 = (beta0 <= eps_ls) if ls else true
    sln0 = (gamma0 <= eps_ln) if ln else true
    status0 = torch.where(sls0 & sln0, SOLVED, RUNNING).to(torch.int32)
    s0 = types.SimpleNamespace(
        x=torch.zeros_like(b), y=torch.zeros_like(b),
        r=b if ls else torch.zeros_like(b), z=torch.zeros_like(b), vk=v1,
        uk=u1, vkm1=torch.zeros_like(b), ukm1=torch.zeros_like(b),
        wkm1=torch.zeros_like(b), wkm2=torch.zeros_like(b),
        dbar=torch.zeros_like(b), iter=i0, beta=beta0, gamma=gamma0,
        c_km2=-one, s_km2=zero, c_km1=-one, s_km1=zero, phibar=beta0,
        zeta_km1=zero, zeta_km2=zero, eta_km1=zero, delta_km1=zero,
        kappa=zero, rnorm_ls=beta0, rnorm_ln=gamma0,
        ahrnorm=_scalar(float("inf"), b), sls=sls0.to(torch.int32),
        sln=sln0.to(torch.int32), incon=i0, status=status0)

    def step(s):
        it = s.iter + 1
        is1, ge2 = it == 1, it >= 2
        q, p, alpha, beta1, gamma1 = _ssy_ref(pd, offsets, pd_adj,
                                              offsets_adj, s, one, zero)
        eps_km2 = s.s_km2 * s.gamma
        lambdabar = -s.c_km2 * s.gamma
        lam_km1 = s.c_km1 * lambdabar + s.s_km1 * alpha
        deltabar = s.s_km1 * lambdabar - s.c_km1 * alpha
        ck, sk, delta = sym_givens(deltabar, beta1)
        w_new = (s.uk - lam_km1 * s.wkm1 - eps_km2 * s.wkm2) \
            / _safe(delta, one)
        # least-squares sweep
        als = (s.sls == 0) & ls
        phi = ck * s.phibar
        phibar_next = sk * s.phibar
        y = s.y + (torch.where(als, one, zero) * phi) * w_new
        rfac = torch.where(beta1 != 0, -ck * phibar_next / _safe(beta1, one),
                           zero)
        r = torch.where(als, (sk * sk) * s.r + rfac * q, s.r)
        rnorm_ls = torch.where(als, torch.abs(phibar_next), s.rnorm_ls)
        ahrnorm = torch.where(als, torch.abs(s.phibar) * torch.sqrt(
            deltabar * deltabar + (s.c_km1 * gamma1) ** 2), s.ahrnorm)
        kappa = torch.where(is1 & ls, _scalar(atol, b) + _scalar(rtol, b)
                            * ahrnorm, s.kappa)
        sls = torch.where(als & (rnorm_ls <= eps_ls), 1, s.sls).to(
            torch.int32)
        incon = torch.where(als, (~(rnorm_ls <= eps_ls)
                                  & (ahrnorm <= kappa)).to(torch.int32),
                            s.incon)
        # least-norm sweep
        aln = (s.sln == 0) & ln
        zeta_km1 = torch.where(aln & ge2, s.eta_km1
                               / _safe(s.delta_km1, one), s.zeta_km1)
        zeta_km2 = torch.where(aln & (it >= 3), s.zeta_km1, s.zeta_km2)
        eta = torch.where(aln, torch.where(
            is1, s.gamma, -eps_km2 * zeta_km2 - lam_km1 * zeta_km1),
            s.eta_km1)
        x_add = torch.where(aln & ge2, zeta_km1, zero)
        x = s.x + (x_add * s.c_km1) * s.dbar + (x_add * s.s_km1) * s.vk
        z = s.z - x_add * s.wkm1
        dbar = torch.where(aln, torch.where(
            is1, s.vk, s.s_km1 * s.dbar - s.c_km1 * s.vk), s.dbar)
        mu = s.gamma * (s.s_km2 * zeta_km2 - s.c_km2 * s.c_km1 * zeta_km1) \
            + alpha * s.s_km1 * zeta_km1
        om = gamma1 * s.s_km1 * zeta_km1
        rnorm_ln = torch.where(aln & ge2, torch.sqrt(mu * mu + om * om),
                               s.rnorm_ln)
        sln = torch.where(aln & (rnorm_ln <= eps_ln), 1, s.sln).to(
            torch.int32)
        vk1, uk1 = _ssy_next(q, p, beta1, gamma1, torch.zeros_like(q),
                             torch.zeros_like(p), one)
        code = torch.where((sls == 1) & (sln == 1), SOLVED, torch.where(
            incon == 1, INCONSISTENT, RUNNING)).to(torch.int32)
        return dict(
            x=x, y=y, r=r, z=z, vk=vk1, uk=uk1, vkm1=s.vk, ukm1=s.uk,
            wkm1=w_new, wkm2=s.wkm1, dbar=dbar, iter=it, beta=beta1,
            gamma=gamma1, c_km2=s.c_km1, s_km2=s.s_km1, c_km1=ck, s_km1=sk,
            phibar=torch.where(als, phibar_next, s.phibar),
            zeta_km1=zeta_km1, zeta_km2=zeta_km2,
            eta_km1=torch.where(aln, eta, s.eta_km1), delta_km1=delta,
            kappa=kappa, rnorm_ls=rnorm_ls, rnorm_ln=rnorm_ln,
            ahrnorm=ahrnorm, sls=sls, sln=sln, incon=incon, status=code)

    s = _drive_ref(s0, step, itmax)
    return (s.x + s.r, s.y + s.z, s.iter, s.rnorm_ls, s.rnorm_ln, s.status,
            s.incon)



# ---------------------------------------------------------------------------
# LSQR, LSMR and LSLQ: the plain versions
# ---------------------------------------------------------------------------

def _gk_start_ref(pd_adj, offsets_adj, b, one):
    """β₁ = ‖b‖, u₁ = b/β₁, ‖Aᴴu₁‖² as summed, α₁ and v₁ = Aᴴu₁/α₁
    (pallas_fused.py:1440-1450)."""
    beta1 = torch.sqrt(torch.sum(b * b))
    u = b / _safe(beta1, one)
    ahu = dia_spmv_aligned_ref(pd_adj, offsets_adj, u)
    anorm2 = torch.sum(ahu * ahu)
    alpha = torch.sqrt(anorm2)
    return beta1, u, anorm2, alpha, ahu / _safe(alpha, one)


def _gk_ref(pd, offsets, pd_adj, offsets_adj, s, one):
    """One Golub–Kahan step (pallas_fused.py:1481-1503): βu = Av − αu,
    then αv = Aᴴu − βv unless β = 0, each normalised only where its norm
    is not 0.  Returns (u, v, α, β, β ≠ 0)."""
    u_un = dia_spmv_aligned_ref(pd, offsets, s.v) - s.alpha * s.u
    beta = torch.sqrt(torch.sum(u_un * u_un))
    bnz = beta != 0
    u = torch.where(bnz, u_un / _safe(beta, one), u_un)
    v_un = torch.where(bnz, dia_spmv_aligned_ref(pd_adj, offsets_adj, u)
                       - beta * s.v, s.v)
    alpha = torch.where(bnz, torch.sqrt(torch.sum(v_un * v_un)), s.alpha)
    anz = bnz & (alpha != 0)
    return u, torch.where(anz, v_un / _safe(alpha, one), v_un), alpha, \
        beta, bnz


def _window_norm(errs, first):
    """√ of the sum of squares of the error window, slot by slot from
    ``first`` on, circularly, in the order of the TPU kernels' window."""
    w = errs.shape[0]
    err2 = torch.zeros_like(errs[0])
    for j in range(w):
        e = errs[(first + j) % w]
        err2 = err2 + e * e
    return torch.sqrt(err2)


def _ps_code(ill_cond_mach, ill_cond_lim, solved, zero_r, fwd_err):
    """The TPU kernels' Paige–Saunders status chain, a later condition
    winning (pallas_fused.py:1558-1563)."""
    code = torch.zeros_like(solved, dtype=torch.int32)
    for cond, c in ((ill_cond_mach, ILL_COND_MACH),
                    (ill_cond_lim, COND_EXCEEDED), (solved, SOLVED_LSQ),
                    (solved & zero_r, SOLVED_ZERO),
                    (solved & fwd_err, FWD_ERR)):
        code = torch.where(cond, c, code).to(torch.int32)
    return code


def _ctol(conlim, like):
    conlim = _scalar(conlim, like)
    return torch.where(conlim > 0, 1.0 / conlim, torch.zeros_like(conlim))


def _check_window(window):
    if int(window) < 1:
        raise ValueError("window must be at least 1")


def lsqr_dia_fused_ref(pd, pd_adj, offsets, offsets_adj, b, lam, axtol, btol,
                       atol, rtol, etol, conlim, itmax, window=5):
    """Plain PyTorch LSQR of min ‖b − Ax‖ (+ λ) (pallas_fused.py:
    1394-1569): Golub–Kahan over A and Aᴴ, the rotation against λ, the
    Paige–Saunders stops, the ‖x‖ rotation and the etol window.

    Returns (x, niter, rnorm, arnorm, status, zero_resid) as tensors, as
    ``lsqr_dia_fused`` does."""
    _check_window(window)
    tiny = torch.finfo(b.dtype).tiny
    one, zero = _scalar(1, b), _scalar(0, b)
    lam, axtol, btol, atol, rtol, etol = (_scalar(v, b) for v in (
        lam, axtol, btol, atol, rtol, etol))
    ctol = _ctol(conlim, b)
    beta1, u, anorm2_0, alpha0, v = _gk_start_ref(pd_adj, offsets_adj, b,
                                                  one)
    arnorm0 = alpha0 * beta1
    status0 = torch.where(beta1 == 0, ZERO_RESIDUAL, torch.where(
        alpha0 == 0, MIN_LSQ_X, RUNNING))
    t2 = arnorm0 / (torch.sqrt(torch.clamp(anorm2_0, min=tiny))
                    * _safe(beta1, one))
    status0 = torch.where((status0 == RUNNING) & ((t2 <= axtol)
                                                  | ((1.0 + t2) <= 1.0)),
                          SOLVED_LSQ, status0).to(torch.int32)
    s0 = types.SimpleNamespace(
        x=torch.zeros_like(b), u=u, v=v, w=v, iter=_i32(0, b), alpha=alpha0,
        phibar=beta1, rhobar=alpha0, anorm2=anorm2_0, dnorm2=zero,
        xnorm2=zero, res2=zero, c2=-one, s2=zero, zsc=zero, xenorm2=zero,
        rnorm=beta1, arnorm=arnorm0, status=status0, zr=_i32(0, b),
        errs=torch.zeros(window, dtype=b.dtype, device=b.device))

    def step(s):
        it = s.iter + 1
        u, v, alpha, beta, bnz = _gk_ref(pd, offsets, pd_adj, offsets_adj,
                                         s, one)
        anorm2 = torch.where(bnz, s.anorm2 + s.alpha * s.alpha + beta * beta
                             + torch.where(lam > 0, lam * lam, zero),
                             s.anorm2)
        c1, s1, rhobar1 = sym_givens(s.rhobar, lam)
        psi = s1 * s.phibar
        phibar_mid = c1 * s.phibar
        cg, sg, rho = sym_givens(rhobar1, beta)
        phi = cg * phibar_mid
        phibar = sg * phibar_mid
        xenorm2 = s.xenorm2 + phi * phi
        errs = torch.cat([s.errs[1:], phi.reshape(1)])
        err_lbnd = _window_norm(errs, 0)
        tau = sg * phi
        theta = sg * alpha
        safe_rho = _safe(rho, one)
        dnorm2 = s.dnorm2 + torch.sum(s.w * s.w) / (safe_rho * safe_rho)
        x = s.x + (phi / safe_rho) * s.w
        w = v - (theta / safe_rho) * s.w
        delta = s.s2 * rho
        gbar = -s.c2 * rho
        rhs = phi - delta * s.zsc
        zbar = rhs / _safe(gbar, one)
        xnorm = torch.sqrt(s.xnorm2 + zbar * zbar)
        c2, s2, gamma = sym_givens(gbar, theta)
        zsc = rhs / _safe(gamma, one)
        anorm = torch.sqrt(anorm2)
        acond = anorm * torch.sqrt(dnorm2)
        res2 = s.res2 + psi * psi
        rnorm = torch.sqrt(phibar * phibar + res2)
        arnorm = alpha * torch.abs(tau)
        test1 = rnorm / beta1
        test2 = arnorm / torch.clamp(anorm * rnorm, min=tiny)
        test3 = 1.0 / torch.clamp(acond, min=tiny)
        t1 = test1 / (1.0 + anorm * xnorm / beta1)
        rnormtol = btol + axtol * anorm * xnorm / beta1
        zero_r = ((1.0 + t1) <= 1.0) | (test1 <= rnormtol)
        fwd_err = (it >= window) & (err_lbnd <= etol * torch.sqrt(xenorm2))
        solved = (((1.0 + test2) <= 1.0) | (test2 <= axtol)
                  | (arnorm <= atol + rtol * arnorm0) | zero_r | fwd_err)
        return dict(x=x, u=u, v=v, w=w, iter=it, alpha=alpha, phibar=phibar,
                    rhobar=-cg * alpha, anorm2=anorm2, dnorm2=dnorm2,
                    xnorm2=s.xnorm2 + zsc * zsc, res2=res2, c2=c2, s2=s2,
                    zsc=zsc, xenorm2=xenorm2, rnorm=rnorm, arnorm=arnorm,
                    status=_ps_code((1.0 + test3) <= 1.0, test3 <= ctol,
                                    solved, zero_r, fwd_err),
                    zr=zero_r.to(torch.int32), errs=errs)

    s = _drive_ref(s0, step, itmax)
    return s.x, s.iter, s.rnorm, s.arnorm, s.status, s.zr


def lsmr_dia_fused_ref(pd, pd_adj, offsets, offsets_adj, b, lam, axtol, btol,
                       atol, rtol, etol, conlim, itmax, window=5):
    """Plain PyTorch LSMR of min ‖b − Ax‖ (+ λ) (pallas_fused.py:
    1641-1856): Golub–Kahan, LSMR's rotations, the ‖r‖, ‖A‖, cond(A) and
    ‖x‖ estimates, the Paige–Saunders stops and the etol window.

    Returns (x, niter, rnorm, arnorm, acond, anorm, xnorm, status,
    zero_resid) as tensors, as ``lsmr_dia_fused`` does."""
    _check_window(window)
    tiny = torch.finfo(b.dtype).tiny
    one, zero = _scalar(1, b), _scalar(0, b)
    lam, axtol, btol, atol, rtol, etol = (_scalar(v, b) for v in (
        lam, axtol, btol, atol, rtol, etol))
    ctol = _ctol(conlim, b)
    beta1, u, _, alpha0, v = _gk_start_ref(pd_adj, offsets_adj, b, one)
    arnorm0 = alpha0 * beta1
    status0 = torch.where(beta1 == 0, ZERO_RESIDUAL, torch.where(
        alpha0 == 0, MIN_LSQ_X, torch.where(
            beta1 <= axtol, SOLVED_LSQ, RUNNING))).to(torch.int32)
    s0 = types.SimpleNamespace(
        x=torch.zeros_like(b), u=u, v=v, h=v, hbar=torch.zeros_like(b),
        iter=_i32(0, b), alpha=alpha0, zetabar=arnorm0, alphabar=alpha0,
        rho=one, rhobar=one, cbar=one, sbar=zero, betadd=beta1, betad=zero,
        rhodold=one, tautildeold=zero, thetatilde=zero, zeta=zero, dd=zero,
        anorm2=alpha0 * alpha0, maxrbar=zero,
        minrbar=_scalar(torch.finfo(b.dtype).max, b), xenorm2=zero,
        rnorm=beta1, arnorm=arnorm0, acond=zero, anorm=alpha0, xnorm=zero,
        status=status0, zr=_i32(0, b),
        errs=torch.zeros(window, dtype=b.dtype, device=b.device))

    def step(s):
        it = s.iter + 1
        u, v, alpha, beta, _ = _gk_ref(pd, offsets, pd_adj, offsets_adj, s,
                                       one)
        chat, shat, alphahat = sym_givens(s.alphabar, lam)
        cg, sg, rho = sym_givens(alphahat, beta)
        thetanew = sg * alpha
        thetabar = s.sbar * rho
        rhotemp = s.cbar * rho
        cbar, sbar, rhobar = sym_givens(rhotemp, thetanew)
        zeta = cbar * s.zetabar
        zetabar = -sbar * s.zetabar
        xenorm2 = s.xenorm2 + zeta * zeta
        errs = torch.cat([s.errs[1:], zeta.reshape(1)])
        err_lbnd = _window_norm(errs, 0)
        delta = thetabar * rho / torch.clamp(s.rho * s.rhobar, min=tiny)
        hbar = s.h - delta * s.hbar
        x = s.x + (zeta / torch.clamp(rho * rhobar, min=tiny)) * hbar
        h = v - (thetanew / torch.clamp(rho, min=tiny)) * s.h
        betaacute = chat * s.betadd
        betacheck = -shat * s.betadd
        betahat = cg * betaacute
        betadd = -sg * betaacute
        ctildeold, stildeold, rhotildeold = sym_givens(s.rhodold, thetabar)
        thetatilde = stildeold * rhobar
        rhodold = ctildeold * rhobar
        betad = -stildeold * s.betad + ctildeold * betahat
        tautildeold = (s.zeta - s.thetatilde * s.tautildeold) \
            / torch.clamp(rhotildeold, min=tiny)
        taud = (zeta - thetatilde * tautildeold) / torch.clamp(rhodold,
                                                               min=tiny)
        dd = s.dd + betacheck * betacheck
        rnorm = torch.sqrt(dd + (betad - taud) ** 2 + betadd * betadd)
        anorm2_mid = s.anorm2 + beta * beta
        anorm = torch.sqrt(anorm2_mid)
        maxrbar = torch.maximum(s.maxrbar, s.rhobar)
        minrbar = torch.where(it > 1, torch.minimum(s.minrbar, s.rhobar),
                              s.minrbar)
        acond = torch.maximum(maxrbar, rhotemp) / torch.clamp(
            torch.minimum(minrbar, rhotemp), min=tiny)
        arnorm = torch.abs(zetabar)
        xnorm = torch.sqrt(torch.sum(x * x))
        test1 = rnorm / beta1
        test2 = arnorm / torch.clamp(anorm * rnorm, min=tiny)
        test3 = 1.0 / torch.clamp(acond, min=tiny)
        t1 = test1 / (1.0 + anorm * xnorm / beta1)
        rnormtol = btol + axtol * anorm * xnorm / beta1
        zero_r = ((1.0 + t1) <= 1.0) | (test1 <= rnormtol)
        fwd_err = (it >= window) & (err_lbnd <= etol * torch.sqrt(xenorm2))
        solved = (((1.0 + test2) <= 1.0) | (test2 <= axtol)
                  | (arnorm <= atol + rtol * arnorm0) | zero_r | fwd_err)
        return dict(x=x, u=u, v=v, h=h, hbar=hbar, iter=it, alpha=alpha,
                    zetabar=zetabar, alphabar=cg * alpha, rho=rho,
                    rhobar=rhobar, cbar=cbar, sbar=sbar, betadd=betadd,
                    betad=betad, rhodold=rhodold, tautildeold=tautildeold,
                    thetatilde=thetatilde, zeta=zeta, dd=dd,
                    anorm2=anorm2_mid + alpha * alpha, maxrbar=maxrbar,
                    minrbar=minrbar, xenorm2=xenorm2, rnorm=rnorm,
                    arnorm=arnorm, acond=acond, anorm=anorm, xnorm=xnorm,
                    status=_ps_code((1.0 + test3) <= 1.0, test3 <= ctol,
                                    solved, zero_r, fwd_err),
                    zr=zero_r.to(torch.int32), errs=errs)

    s = _drive_ref(s0, step, itmax)
    return (s.x, s.iter, s.rnorm, s.arnorm, s.acond, s.anorm, s.xnorm,
            s.status, s.zr)


def lslq_dia_fused_ref(pd, pd_adj, offsets, offsets_adj, b, lam, sigma, atol,
                       rtol, btol, etol, utol, conlim, itmax, use_sigma=False,
                       transfer_to_lsqr=False, window=5):
    """Plain PyTorch LSLQ of min ‖b − Ax‖ (+ λ) (pallas_fused.py:
    6942-7164): Golub–Kahan, the LQ recurrences with the λ registers, the
    σ error bounds, the forward-error window and the LSQR transfer.

    Returns (x, niter, rnorm, arnorm, status, zero_resid, complex_bnd)
    as tensors, as ``lslq_dia_fused`` does."""
    _check_window(window)
    tiny = torch.finfo(b.dtype).tiny
    one, zero = _scalar(1, b), _scalar(0, b)
    sigma, atol, rtol, etol, utol = (_scalar(v, b) for v in (
        sigma, atol, rtol, etol, utol))
    ctol = _ctol(conlim, b)
    beta1, u, _, alpha0, v = _gk_start_ref(pd_adj, offsets_adj, b, one)
    eps_lim = atol + rtol * beta1
    status0 = torch.where(beta1 == 0, ZERO_RESIDUAL, torch.where(
        alpha0 == 0, MIN_LSQ_X, torch.where(
            beta1 <= eps_lim, SOLVED_ZERO, RUNNING))).to(torch.int32)
    s0 = types.SimpleNamespace(
        x=torch.zeros_like(b), u=u, v=v, wbar=v, iter=_i32(0, b),
        alpha=alpha0, lam_k=_scalar(lam, b), anorm2=alpha0 * alpha0,
        smax=zero, smin=_scalar(float("inf"), b), gbar=alpha0, psi=beta1,
        c=-one, s=zero, delta=-one, tau=alpha0 * beta1, zeta=zero,
        zetabar=zero, zetatilde=zero, rhobar_sig=-sigma, csig=-one,
        omega=zero, xlqnorm2=zero, rnorm=beta1, arnorm=alpha0 * beta1,
        zr=_i32(0, b), cbnd=_i32(0, b), status=status0,
        errs=torch.zeros(window, dtype=b.dtype, device=b.device))

    def step(s_):
        it0 = s_.iter
        u, v, alpha, beta, bnz = _gk_ref(pd, offsets, pd_adj, offsets_adj,
                                         s_, one)
        lam_on = (s_.lam_k != 0) & bnz
        cl, sl, blr = sym_givens(beta, s_.lam_k)
        al = torch.where(lam_on, cl * alpha, alpha)
        bl = torch.where(lam_on, blr, beta)
        lam_k = torch.where(lam_on, torch.sqrt(
            s_.lam_k * s_.lam_k + (sl * alpha) ** 2), s_.lam_k)
        anorm2 = torch.where(bnz, s_.anorm2 + al * al + bl * bl, s_.anorm2)
        anorm = torch.sqrt(anorm2)
        cp, sp, gamma = sym_givens(s_.gbar, bl)
        tau = -s_.tau * s_.delta / _safe(gamma, one)
        delta = sp * al
        cbnd = s_.cbnd == 1
        rhobar_sig, csig, omega = s_.rhobar_sig, s_.csig, s_.omega
        if use_sigma:
            mubar = -csig * gamma
            csig1, ssig1, _ = sym_givens(rhobar_sig, gamma)
            rhobar_sig = ssig1 * mubar + csig1 * sigma
            mubar = -csig1 * delta
            h = delta * csig1 / _safe(rhobar_sig, one)
            disc = sigma * (sigma - delta * h)
            cbnd = cbnd | (disc < 0)
            omega = torch.where(disc >= 0,
                                torch.sqrt(torch.clamp(disc, min=0)), omega)
            csig, ssig2, _ = sym_givens(rhobar_sig, delta)
            rhobar_sig = ssig2 * mubar + csig * sigma
        ebar = -gamma * s_.c
        eta = gamma * s_.s
        c, s, eps_ = sym_givens(ebar, delta)
        smax = torch.maximum(s_.smax, torch.maximum(eps_, torch.abs(ebar)))
        smin = torch.minimum(s_.smin, torch.minimum(eps_, torch.abs(ebar)))
        acond = smax / torch.clamp(smin, min=tiny)
        zeta = (tau - s_.zeta * eta) / _safe(eps_, one)
        zetabar = zeta / _safe(c, one)
        rnorm = torch.sqrt((s_.psi * cp - s_.zeta * eta) ** 2
                           + (s_.psi * sp) ** 2)
        arnorm = torch.sqrt((gamma * eps_ * zeta) ** 2
                            + (delta * eta * s_.zeta) ** 2)
        x = s_.x + (c * zeta) * s_.wbar + (s * zeta) * v
        wbar = s * s_.wbar - c * v
        xlqnorm2 = s_.xlqnorm2 + zeta * zeta
        xlqnorm = torch.sqrt(xlqnorm2)
        xcgnorm2 = xlqnorm2 + zetabar * zetabar
        errs = s_.errs.index_put(((it0 % window).long().reshape(1),),
                                 zeta.reshape(1))
        fwd_lbnd = (it0 >= window) & (_window_norm(errs, 0)
                                      <= etol * xlqnorm)
        zetatilde = s_.zetatilde
        fwd_ubnd = torch.zeros_like(fwd_lbnd)
        if use_sigma:
            taut = -tau * delta / _safe(omega, one)
            zetatilde = (taut - zeta * (omega * s)) / _safe(-omega * c, one)
            disc_cg = s_.zetatilde ** 2 - zetabar ** 2
            cbnd = cbnd | ((it0 > 0) & (disc_cg < 0))
            fwd_ubnd = (it0 > 0) & (disc_cg >= 0) & (
                torch.sqrt(torch.clamp(disc_cg, min=0))
                <= utol * torch.sqrt(xcgnorm2))
        test2 = arnorm / torch.clamp(anorm * rnorm, min=tiny)
        test3 = 1.0 / torch.clamp(acond, min=tiny)
        t1 = rnorm / (1.0 + anorm * xlqnorm)
        zero_r = ((1.0 + t1) <= 1.0) | (rnorm <= eps_lim)
        solved = ((1.0 + test2) <= 1.0) | (test2 <= atol) | zero_r \
            | fwd_lbnd | fwd_ubnd
        code = torch.zeros_like(it0)
        for cond, k in (((1.0 + test3) <= 1.0, ILL_COND_MACH),
                        (test3 <= ctol, COND_EXCEEDED),
                        (solved, SOLVED_LSQ), (zero_r, SOLVED_ZERO),
                        (fwd_lbnd, FWD_LBND), (fwd_ubnd, FWD_UBND)):
            code = torch.where(cond, k, code).to(torch.int32)
        return dict(x=x, u=u, v=v, wbar=wbar, iter=it0 + 1, alpha=alpha,
                    lam_k=lam_k, anorm2=anorm2, smax=smax, smin=smin,
                    gbar=-cp * al, psi=s_.psi * sp, c=c, s=s, delta=delta,
                    tau=tau, zeta=zeta, zetabar=zetabar, zetatilde=zetatilde,
                    rhobar_sig=rhobar_sig, csig=csig, omega=omega,
                    xlqnorm2=xlqnorm2, rnorm=rnorm, arnorm=arnorm,
                    zr=zero_r.to(torch.int32), cbnd=cbnd.to(torch.int32),
                    status=code, errs=errs)

    s = _drive_ref(s0, step, itmax)
    x = s.x
    if transfer_to_lsqr:
        x = torch.where((s.status != ZERO_RESIDUAL) & (s.status != MIN_LSQ_X),
                        x + s.zetabar * s.wbar, x)
    return x, s.iter, s.rnorm, s.arnorm, s.status, s.zr, s.cbnd


# ---------------------------------------------------------------------------
# CGNE and CRMR, CRAIG, CRAIGMR and LNLQ: the plain versions
# ---------------------------------------------------------------------------

def _check_variant(variant):
    if variant not in ("cgne", "crmr"):
        raise ValueError(f"variant must be 'cgne' or 'crmr', not {variant!r}")


def cgne_crmr_dia_fused_ref(pd, pd_adj, offsets, offsets_adj, b, lam, atol,
                            rtol, itmax, variant="cgne"):
    """Plain PyTorch CGNE or CRMR of min ‖x‖ subject to Ax = b (+ λ)
    (pallas_fused.py:3571-3666): CG or CR on AAᴴ, λ through s, and the
    "probably inconsistent" exit.  s is left alone without λ, as in the
    kernel, since no output reads it.

    Returns (x, niter, rnorm, status) as tensors, as
    ``cgne_crmr_dia_fused`` does."""
    _check_variant(variant)
    cgne = variant == "cgne"
    lam_on = float(lam) > 0
    one, zero = _scalar(1, b), _scalar(0, b)
    lam, atol, rtol = (_scalar(v, b) for v in (lam, atol, rtol))
    incons_code = INCONS_CGNE if cgne else INCONS_CRMR
    rnorm0 = torch.sqrt(torch.sum(b * b))
    p0 = dia_spmv_aligned_ref(pd_adj, offsets_adj, b)
    if cgne:
        gamma0 = rnorm0 * rnorm0
        ind0 = torch.sqrt(torch.sum(p0 * p0))
    else:
        gamma0 = torch.sum(p0 * p0) + (lam * rnorm0 * rnorm0 if lam_on
                                       else zero)
        ind0 = torch.sqrt(gamma0)
    eps_c = atol + rtol * rnorm0
    eps_i = atol + rtol * ind0
    status0 = torch.where(rnorm0 == 0, ZERO_RESIDUAL, torch.where(
        rnorm0 <= eps_c, SOLVED, torch.where(
            (rnorm0 > 100 * eps_c) & (ind0 <= eps_i), incons_code,
            RUNNING))).to(torch.int32)
    s0 = types.SimpleNamespace(x=torch.zeros_like(b), r=b, p=p0, s=b,
                               gamma=gamma0, rnorm=rnorm0, iter=_i32(0, b),
                               status=status0)

    def step(s):
        q = dia_spmv_aligned_ref(pd, offsets, s.p)
        if lam_on:
            q = q + lam * s.s
        if cgne:
            delta = torch.sum(s.p * s.p) + (lam * torch.sum(s.s * s.s)
                                            if lam_on else zero)
            alpha = s.gamma / _safe(delta, one)
            x = s.x + alpha * s.p
            r = s.r - alpha * q
            gamma = torch.sum(r * r)
            beta = gamma / _safe(s.gamma, one)
            p = dia_spmv_aligned_ref(pd_adj, offsets_adj, r) + beta * s.p
            ind = torch.sqrt(torch.sum(p * p))
            rnorm = torch.sqrt(torch.clamp(gamma, min=0))
        else:
            alpha = s.gamma / _safe(torch.sum(q * q), one)
            x = s.x + alpha * s.p
            r = s.r - alpha * q
            rnorm = torch.sqrt(torch.sum(r * r))
            t = dia_spmv_aligned_ref(pd_adj, offsets_adj, r)
            gamma = torch.sum(t * t) + (lam * rnorm * rnorm if lam_on
                                        else zero)
            beta = gamma / _safe(s.gamma, one)
            p = t + beta * s.p
            ind = torch.sqrt(torch.clamp(gamma, min=0))
        solved = (rnorm <= eps_c) | ((rnorm + 1.0) <= 1.0)
        incons = (rnorm > 100 * eps_c) & (ind <= eps_i)
        code = torch.where(solved, SOLVED, torch.where(incons, incons_code,
                                                       RUNNING))
        return dict(x=x, r=r, p=p, s=r + beta * s.s if lam_on else s.s,
                    gamma=gamma, rnorm=rnorm, iter=s.iter + 1,
                    status=code.to(torch.int32))

    s = _drive_ref(s0, step, itmax)
    return s.x, s.iter, s.rnorm, s.status


def craig_dia_fused_ref(pd, pd_adj, offsets, offsets_adj, b, lam, atol, rtol,
                        btol, conlim, itmax, use_lam=False):
    """Plain PyTorch CRAIG of min ‖x‖ subject to Ax = b (+ λ)
    (pallas_fused.py:5922-6077), in the TPU kernel's order: v from Aᴴu,
    the updates, u from Av and the tests on the new β; the λ two-rotation
    scheme, and the α = 0 exit, which counts no iteration and changes
    nothing but the status.

    Returns (x, y, niter, rnorm, status) as tensors, as
    ``craig_dia_fused`` does."""
    tiny = torch.finfo(b.dtype).tiny
    one, zero = _scalar(1, b), _scalar(0, b)
    lam, atol, rtol, btol = (_scalar(v, b) for v in (lam, atol, rtol, btol))
    ctol = _ctol(conlim, b)
    beta1 = torch.sqrt(torch.sum(b * b))
    eps_c = atol + rtol * beta1
    z = torch.zeros_like(b)
    s0 = types.SimpleNamespace(
        x=z, y=z, u=b / _safe(beta1, one), v=z, w=z, w2=z, iter=_i32(0, b),
        beta=beta1, theta=beta1, xi=-one, delta=lam, rho_prev=one,
        anorm2=zero, dnorm2=zero, xnorm2=zero, rnorm=beta1,
        status=torch.where(beta1 == 0, ZERO_RESIDUAL, RUNNING).to(
            torch.int32))

    def step(s):
        nv = dia_spmv_aligned_ref(pd_adj, offsets_adj, s.u) - s.beta * s.v
        alpha = torch.sqrt(torch.sum(nv * nv))
        incons = alpha == 0
        v = torch.where(incons, nv, nv / _safe(alpha, one))
        anorm2 = s.anorm2 + alpha * alpha + lam * lam
        if use_lam:
            c1, s1, rho = sym_givens(alpha, s.delta)
        else:
            c1, s1, rho = one, zero, alpha
        xi = -s.theta / _safe(rho, one) * s.xi
        if use_lam:
            x = s.x + (xi * c1) * v + (xi * s1) * s.w2
            w2 = s1 * v - c1 * s.w2
        else:
            x = s.x + xi * v
            w2 = s.w2
        w = s.u - (s.theta / s.rho_prev) * s.w
        y = s.y + (xi / rho) * w
        dnorm2 = s.dnorm2 + torch.sqrt(torch.sum(w * w))
        mu = dia_spmv_aligned_ref(pd, offsets, v) - alpha * s.u
        beta = torch.sqrt(torch.sum(mu * mu))
        u = torch.where(beta != 0, mu / _safe(beta, one), mu)
        if use_lam:
            theta = beta * c1
            _, s2, delta = sym_givens(lam, beta * s1)
            w2 = s2 * w2
        else:
            theta, delta = beta, s.delta
        anorm2 = anorm2 + beta * beta
        anorm = torch.sqrt(anorm2)
        acond = anorm * torch.sqrt(dnorm2)
        xnorm2 = s.xnorm2 + xi * xi
        xnorm = torch.sqrt(xnorm2)
        rnorm = beta * torch.abs(xi)
        if use_lam:
            rnorm = rnorm * torch.abs(c1)
        bkwerr = rnorm / torch.sqrt(beta1 * beta1 + anorm2 * xnorm2 + tiny)
        solved = (((1.0 + bkwerr) <= 1.0) | (bkwerr <= btol)
                  | (rnorm <= eps_c)
                  | (rnorm <= btol + atol * anorm * xnorm / _safe(beta1,
                                                                   one)))
        inv_acond = 1.0 / torch.clamp(acond, min=tiny)
        code = torch.zeros_like(s.iter)
        for cond, k in ((solved, SOLVED_CRAIG),
                        ((1.0 + inv_acond) <= 1.0, ILL_COND_MACH),
                        (inv_acond <= ctol, COND_EXCEEDED),
                        (incons, INCONS_CRAIG)):
            code = torch.where(cond, k, code).to(torch.int32)
        new = dict(x=x, y=y, u=u, w=w, w2=w2, iter=s.iter + 1, beta=beta,
                   theta=theta, xi=xi, delta=delta, rho_prev=rho,
                   anorm2=anorm2, dnorm2=dnorm2, xnorm2=xnorm2, rnorm=rnorm)
        # on the inconsistency exit the iteration's updates never happened
        new = {k: torch.where(incons, getattr(s, k), val)
               for k, val in new.items()}
        return dict(new, v=v, status=code)

    s = _drive_ref(s0, step, itmax)
    return s.x, s.y, s.iter, s.rnorm, s.status


def _ln_start_ref(pd_adj, offsets_adj, b, lam, use_lam, one):
    """The Golub–Kahan start of CRAIGMR and LNLQ and the rotation of
    (α₁, λ): β₁, u₁, α₁, v₁, cp, sp, α̂ and q = sp·v₁ (0 without λ)
    (pallas_fused.py:6172-6193, 6386-6407)."""
    beta1, u, _, alpha, v = _gk_start_ref(pd_adj, offsets_adj, b, one)
    if use_lam:
        cp, sp, alphahat = sym_givens(alpha, lam)
        q = sp * v
    else:
        cp, sp, alphahat, q = one, one, alpha, torch.zeros_like(b)
    return beta1, u, alpha, v, cp, sp, alphahat, q


def craigmr_dia_fused_ref(pd, pd_adj, offsets, offsets_adj, b, lam, atol,
                          rtol, itmax, use_lam=False):
    """Plain PyTorch CRAIGMR of min ‖x‖ subject to Ax = b (+ λ)
    (pallas_fused.py:6132-6283): Golub–Kahan, the QR of the lower
    bidiagonal, the λ registers with the first iteration's d, and the
    (‖r‖, ‖Aᴴr‖) stops.

    Returns (x, y, niter, rnorm, arnorm, status) as tensors, as
    ``craigmr_dia_fused`` does."""
    one, zero = _scalar(1, b), _scalar(0, b)
    lam, atol, rtol = (_scalar(v, b) for v in (lam, atol, rtol))
    beta1, u, alpha0, v, cp, sp, alphahat, q = _ln_start_ref(
        pd_adj, offsets_adj, b, lam, use_lam, one)
    eps_c = atol + rtol * beta1
    eps_i = atol + rtol * alpha0
    z = torch.zeros_like(b)
    s0 = types.SimpleNamespace(
        x=z, y=z, u=u, v=v, w=z, wbar=u / _safe(alphahat, one), d=z, q=q,
        iter=_i32(0, b), alpha=alpha0, zetabar=beta1, rhobar=alphahat,
        theta=zero, cp=cp, sp=sp, lam_k=lam, rnorm=beta1, arnorm=alpha0,
        status=torch.where(beta1 == 0, ZERO_RESIDUAL, torch.where(
            alpha0 == 0, MIN_LSQ_X, RUNNING)).to(torch.int32))

    def step(s):
        u, v, alpha, beta, _ = _gk_ref(pd, offsets, pd_adj, offsets_adj, s,
                                       one)
        betahat = s.cp * beta if use_lam else beta
        c, sg, rho = sym_givens(s.rhobar, betahat)
        zeta = c * s.zetabar
        zetabar = sg * s.zetabar
        rnorm = torch.abs(zetabar)
        sr = _safe(rho, one)
        w = s.wbar / sr - (s.theta / sr) * s.w
        if use_lam:
            first = s.iter == 0
            d = torch.where(first, (s.cp / sr) * s.v,
                            (s.cp / sr) * s.v - (s.theta / sr) * s.d
                            + (s.sp / sr) * s.q)
            q = torch.where(first, s.q, s.sp * s.v - s.cp * s.q)
            _, sd, lam_next = sym_givens(s.lam_k, s.sp * beta)
            q = sd * q
            cp, sp, alphahat = sym_givens(alpha, lam_next)
        else:
            d = s.v / sr - (s.theta / sr) * s.d
            q, cp, sp, lam_next, alphahat = s.q, s.cp, s.sp, s.lam_k, alpha
        arnorm = alpha * beta * torch.abs(zeta / sr)
        wbar = torch.where(alpha != 0,
                           (u - betahat * s.wbar) / _safe(alphahat, one),
                           s.wbar)
        code = torch.where(rnorm <= eps_c, SOLVED_MN, torch.where(
            (rnorm > 100 * eps_c) & (arnorm <= eps_i), SOLVED_LSQ, RUNNING))
        return dict(x=s.x + zeta * d, y=s.y + zeta * w, u=u, v=v, w=w,
                    wbar=wbar, d=d, q=q, iter=s.iter + 1, alpha=alpha,
                    zetabar=zetabar, rhobar=-c * alphahat,
                    theta=sg * alphahat, cp=cp, sp=sp, lam_k=lam_next,
                    rnorm=rnorm, arnorm=arnorm, status=code.to(torch.int32))

    s = _drive_ref(s0, step, itmax)
    return s.x, s.y, s.iter, s.rnorm, s.arnorm, s.status


def lnlq_dia_fused_ref(pd, pd_adj, offsets, offsets_adj, b, lam, atol, rtol,
                       itmax, use_lam=False, transfer_to_craig=True):
    """Plain PyTorch LNLQ of min ‖x‖ subject to Ax = b (+ λ)
    (pallas_fused.py:6345-6511): Golub–Kahan, the LQ recurrences, the λ
    registers, and the move to the CRAIG point after the loop where the
    stop was the CG branch and ζ̄ > eps (signed).

    Returns (x, y, niter, rnorm, status) as tensors, as
    ``lnlq_dia_fused`` does."""
    eps = torch.finfo(b.dtype).eps
    one, zero = _scalar(1, b), _scalar(0, b)
    lam, atol, rtol = (_scalar(v, b) for v in (lam, atol, rtol))
    beta1, u, alpha0, v, cp, sp, alphahat, q = _ln_start_ref(
        pd_adj, offsets_adj, b, lam, use_lam, one)
    tau = beta1 / _safe(alphahat, one)
    eps_lim = atol + rtol * beta1
    z = torch.zeros_like(b)
    s0 = types.SimpleNamespace(
        x=z, y=z, u=u, v=v, wbar=u, q=q, iter=_i32(0, b), alpha=alpha0,
        alphahat=alphahat, s_k=zero, zeta_km1=zero,
        zetabar=tau / _safe(alphahat, one), theta=tau, epsbar=alphahat,
        tau=tau, cp=cp, sp=sp, rnorm=beta1, cgflag=_i32(0, b),
        status=torch.where(beta1 == 0, ZERO_RESIDUAL, RUNNING).to(
            torch.int32))

    def step(s):
        if use_lam:
            second = s.iter >= 1
            x = s.x + (s.tau * s.cp) * s.v + torch.where(
                second, s.tau * s.sp, zero) * s.q
            q = torch.where(second, s.sp * s.v - s.cp * s.q, s.q)
        else:
            x = s.x + s.tau * s.v
            q = s.q
        u, v, alpha, beta, _ = _gk_ref(pd, offsets, pd_adj, offsets_adj, s,
                                       one)
        if use_lam:
            betahat = s.cp * beta
            _, sd, lam_next = sym_givens(lam, s.sp * beta)
            q = sd * q
            cp, sp, alphahat = sym_givens(alpha, lam_next)
        else:
            betahat, cp, sp, alphahat = beta, s.cp, s.sp, alpha
        tau = -betahat * s.tau / _safe(alphahat, one)
        c, sk, eps_k = sym_givens(s.epsbar, betahat)
        eta = alphahat * sk
        epsbar = -alphahat * c
        zeta = s.theta / _safe(eps_k, one)
        theta = tau - eta * zeta
        rnorm = torch.where(
            s.iter == 0, s.rnorm, torch.abs(s.alphahat) * torch.sqrt(
                (s.epsbar * s.zetabar) ** 2
                + (betahat * s.s_k * s.zeta_km1) ** 2))
        solved_lq = rnorm <= eps_lim
        cg_stop = torch.zeros_like(solved_lq)
        if transfer_to_craig:
            cg_stop = ((torch.abs(s.zetabar) > eps)
                       & (torch.abs(betahat * s.tau) <= eps_lim) & ~solved_lq)
        code = torch.where(solved_lq, SOLVED_LNLQ_LQ, torch.where(
            cg_stop, SOLVED_LNLQ_CG, RUNNING))
        return dict(x=x, y=s.y + (zeta * c) * s.wbar + (zeta * sk) * u,
                    u=u, v=v, wbar=sk * s.wbar - c * u, q=q,
                    iter=s.iter + 1, alpha=alpha, alphahat=alphahat,
                    s_k=sk, zeta_km1=zeta, zetabar=theta / _safe(epsbar, one),
                    theta=theta, epsbar=epsbar, tau=tau, cp=cp, sp=sp,
                    rnorm=rnorm, cgflag=cg_stop.to(torch.int32),
                    status=code.to(torch.int32))

    s = _drive_ref(s0, step, itmax)
    transfer = (s.cgflag == 1) & (s.zetabar > eps)
    xt = (s.x + (s.tau * s.cp) * s.v + (s.tau * s.sp) * s.q if use_lam
          else s.x + s.tau * s.v)
    return (torch.where(transfer, xt, s.x),
            torch.where(transfer, s.y + s.zetabar * s.wbar, s.y), s.iter,
            s.rnorm, s.status)


# ---------------------------------------------------------------------------
# CGLS, CRLS, CGLS-Lanczos-shift and TriCG: the plain versions
# ---------------------------------------------------------------------------

def _ne_start(b, lam, atol, rtol):
    """λ as b's scalar, whether it is on (λ > 0), ε's tolerances and 1."""
    return (_scalar(lam, b), float(lam) > 0, _scalar(atol, b),
            _scalar(rtol, b), _scalar(1, b))


def cgls_dia_fused_ref(pd, pd_adj, offsets, offsets_adj, b, lam, atol, rtol,
                       itmax):
    """Plain PyTorch CGLS of min ‖b − Ax‖² + λ‖x‖² (pallas_fused.py:
    3309-3383): δ = ‖Ap‖² + λ‖p‖², s = Aᴴr − λx (λ itself, as the TPU
    kernel), the stop on ‖s‖ ≤ atol + rtol‖Aᴴb‖.

    Returns (x, niter, rnorm, arnorm, status) as tensors, as
    ``cgls_dia_fused`` does."""
    lam, lam_on, atol, rtol, one = _ne_start(b, lam, atol, rtol)
    bnorm = torch.sqrt(torch.sum(b * b))
    s0 = dia_spmv_aligned_ref(pd_adj, offsets_adj, b)
    gamma0 = torch.sum(s0 * s0)
    arnorm0 = torch.sqrt(gamma0)
    eps_lim = atol + rtol * arnorm0
    status0 = torch.where(bnorm == 0, ZERO_RESIDUAL, torch.where(
        arnorm0 <= eps_lim, SOLVED, RUNNING)).to(torch.int32)
    st0 = types.SimpleNamespace(x=torch.zeros_like(b), r=b, p=s0,
                                gamma=gamma0, rnorm=bnorm, arnorm=arnorm0,
                                iter=_i32(0, b), status=status0)

    def step(s):
        q = dia_spmv_aligned_ref(pd, offsets, s.p)
        delta = torch.sum(q * q)
        if lam_on:
            delta = delta + lam * torch.sum(s.p * s.p)
        alpha = s.gamma / _safe(delta, one)
        x = s.x + alpha * s.p
        r = s.r - alpha * q
        sv = dia_spmv_aligned_ref(pd_adj, offsets_adj, r)
        if lam_on:
            sv = sv - lam * x
        gamma = torch.sum(sv * sv)
        arnorm = torch.sqrt(gamma)
        return dict(x=x, r=r, p=sv + (gamma / _safe(s.gamma, one)) * s.p,
                    gamma=gamma, rnorm=torch.sqrt(torch.sum(r * r)),
                    arnorm=arnorm, iter=s.iter + 1,
                    status=torch.where(arnorm <= eps_lim, SOLVED,
                                       RUNNING).to(torch.int32))

    s = _drive_ref(st0, step, itmax)
    return s.x, s.iter, s.rnorm, s.arnorm, s.status


def crls_dia_fused_ref(pd, pd_adj, offsets, offsets_adj, b, lam, atol, rtol,
                       itmax):
    """Plain PyTorch CRLS of min ‖b − Ax‖² + λ‖x‖² (pallas_fused.py:
    3429-3521): x, r, Ar = Aᴴr, p, Ap and q = AᴴAp + λp, three stencils
    at the start; ‖r‖ with λ is √(‖r‖² + λ‖x‖²); the stop on
    ‖Ar‖ ≤ atol + rtol‖Aᴴb‖.

    Returns (x, niter, rnorm, arnorm, status) as tensors, as
    ``crls_dia_fused`` does."""
    lam, lam_on, atol, rtol, one = _ne_start(b, lam, atol, rtol)

    def q_of(ap, p):
        q = dia_spmv_aligned_ref(pd_adj, offsets_adj, ap)
        return q + lam * p if lam_on else q

    def gamma_of(sv, arnorm):
        g = torch.sum(sv * sv)
        return g + lam * arnorm * arnorm if lam_on else g

    rnorm0 = torch.sqrt(torch.sum(b * b))
    ar0 = dia_spmv_aligned_ref(pd_adj, offsets_adj, b)
    sv0 = dia_spmv_aligned_ref(pd, offsets, ar0)
    arnorm0 = torch.sqrt(torch.sum(ar0 * ar0))
    eps_lim = atol + rtol * arnorm0
    status0 = torch.where(rnorm0 == 0, ZERO_RESIDUAL, torch.where(
        arnorm0 <= eps_lim, SOLVED, RUNNING)).to(torch.int32)
    st0 = types.SimpleNamespace(
        x=torch.zeros_like(b), r=b, ar=ar0, p=ar0, ap=sv0, q=q_of(sv0, ar0),
        gamma=gamma_of(sv0, arnorm0), rnorm=rnorm0, arnorm=arnorm0,
        iter=_i32(0, b), status=status0)

    def step(s):
        alpha = s.gamma / _safe(torch.sum(s.q * s.q), one)
        x = s.x + alpha * s.p
        ar = s.ar - alpha * s.q
        arnorm = torch.sqrt(torch.sum(ar * ar))
        r = s.r - alpha * s.ap
        sv = dia_spmv_aligned_ref(pd, offsets, ar)
        gamma = gamma_of(sv, arnorm)
        beta = gamma / _safe(s.gamma, one)
        p = ar + beta * s.p
        ap = sv + beta * s.ap
        rr = torch.sum(r * r)
        rnorm = (torch.sqrt(rr + lam * torch.sum(x * x)) if lam_on
                 else torch.sqrt(rr))
        return dict(x=x, r=r, ar=ar, p=p, ap=ap, q=q_of(ap, p), gamma=gamma,
                    rnorm=rnorm, arnorm=arnorm, iter=s.iter + 1,
                    status=torch.where(arnorm <= eps_lim, SOLVED,
                                       RUNNING).to(torch.int32))

    s = _drive_ref(st0, step, itmax)
    return s.x, s.iter, s.rnorm, s.arnorm, s.status


def cgls_lanczos_shift_dia_fused_ref(pd, pd_adj, offsets, offsets_adj, b,
                                     shifts, atol, rtol, itmax):
    """Plain PyTorch CGLS-Lanczos-shift of every min ‖b − Ax‖² + λᵢ‖x‖²
    from one Lanczos stream on AᴴA (pallas_fused.py:7217-7342): v₀ =
    Aᴴb/‖Aᴴb‖ while every shift's p starts at the unnormalised Aᴴb; each
    iteration t = Av, then Aᴴt.  A converged shift freezes; the solve
    stops when every shift has converged.  ``shifts`` is a 1-D tensor on
    b's device.

    Returns (X (nshifts, n), niter, rnorms, status, indefinite) as
    tensors, as ``cgls_lanczos_shift_dia_fused`` does."""
    one = _scalar(1, b)
    ns = shifts.shape[0]
    mv0 = dia_spmv_aligned_ref(pd_adj, offsets_adj, b)
    beta0 = torch.sqrt(torch.sum(mv0 * mv0))
    eps_lim = _scalar(atol, b) + _scalar(rtol, b) * beta0
    v0 = mv0 / _safe(beta0, one)
    conv0 = (beta0 <= eps_lim).expand(ns).clone()
    status0 = torch.where(
        beta0 == 0, ZERO_RESIDUAL,
        torch.where(conv0.all(), SOLVED, RUNNING)).to(torch.int32)
    st0 = types.SimpleNamespace(
        X=torch.zeros((ns, b.shape[0]), dtype=b.dtype, device=b.device),
        P=mv0.expand(ns, -1).clone(), v=v0, vprev=v0, iter=_i32(0, b),
        beta=beta0, sigma=beta0.expand(ns).clone(),
        omega=torch.zeros_like(shifts), gamma=torch.ones_like(shifts),
        rnorm=beta0.expand(ns).clone(), conv=conv0,
        indef=torch.zeros(ns, dtype=torch.bool, device=b.device),
        status=status0)

    def step(s):
        t = dia_spmv_aligned_ref(pd, offsets, s.v)
        w = dia_spmv_aligned_ref(pd_adj, offsets_adj, t)
        delta = torch.sum(s.v * w)
        w = w - delta * s.v
        w = torch.where(s.iter > 0, w - s.beta * s.vprev, w)
        beta = torch.sqrt(torch.sum(w * w))
        v_new = w / _safe(beta, one)
        gamma = 1.0 / ((delta + shifts) - s.omega / s.gamma)
        mask = ~s.conv
        col = mask[:, None]
        om = beta * gamma
        sigma = torch.where(mask, -om * s.sigma, s.sigma)
        om2 = torch.where(mask, om * om, s.omega)
        rnorm = torch.where(mask, torch.abs(sigma), s.rnorm)
        conv = torch.where(mask, rnorm <= eps_lim, s.conv)
        return dict(
            X=torch.where(col, s.X + gamma[:, None] * s.P, s.X),
            P=torch.where(col, sigma[:, None] * v_new + om2[:, None] * s.P,
                          s.P),
            v=v_new, vprev=s.v, iter=s.iter + 1, beta=beta, sigma=sigma,
            omega=om2, gamma=torch.where(mask, gamma, s.gamma), rnorm=rnorm,
            conv=conv, indef=s.indef | (gamma <= 0),
            status=torch.where(conv.all(), SOLVED, RUNNING).to(torch.int32))

    s = _drive_ref(st0, step, itmax)
    return s.X, s.iter, s.rnorm, s.status, s.indef.to(torch.int32)


def tricg_dia_fused_ref(pd, pd_adj, offsets, offsets_adj, b, c, tau, nu,
                        atol, rtol, itmax):
    """Plain PyTorch TriCG of [τI A; Aᴴ νI][x; y] = [b; c] (pallas_fused.py:
    5427-5583): the SSY process, the LDLᴴ of Sₖ.ₖ, the π solve, the odd
    and even x and y directions; q or p stays un-normalised where its
    norm is at most eps^¾, both at once is a breakdown (code 28) unless
    the solved test holds.

    Returns (x, y, niter, rnorm, status) as tensors, as
    ``tricg_dia_fused`` does."""
    one, zero = _scalar(1, b), _scalar(0, b)
    tau, nu = _scalar(tau, b), _scalar(nu, b)
    btol = _scalar(float(torch.finfo(b.dtype).eps) ** 0.75, b)
    beta0, gamma0, v1, u1 = _ssy_start(b, c)
    rnorm0 = torch.sqrt(gamma0 * gamma0 + beta0 * beta0)
    eps_lim = _scalar(atol, b) + _scalar(rtol, b) * rnorm0
    status0 = torch.where(rnorm0 == 0, ZERO_RESIDUAL, torch.where(
        rnorm0 <= eps_lim, SOLVED, RUNNING)).to(torch.int32)
    zv = torch.zeros_like(b)
    st0 = types.SimpleNamespace(
        x=zv, y=zv, vk=v1, uk=u1, vkm1=zv, ukm1=zv, gxo=zv, gxe=zv, gyo=zv,
        gye=zv, iter=_i32(0, b), beta=beta0, gamma=gamma0, d_m3=zero,
        d_m2=zero, pi_m3=zero, pi_m2=zero, delta_km1=zero, rnorm=rnorm0,
        status=status0)

    def step(s):
        is1 = s.iter == 0
        q, p, alpha, beta1, gamma1 = _ssy_ref(pd, offsets, pd_adj,
                                              offsets_adj, s, one, zero)
        # the LDLᴴ of Sₖ.ₖ (pallas_fused.py:5511-5523)
        delta1 = alpha / _safe(tau, one)
        d_even1 = nu - delta1 * delta1 * tau
        sigma = s.beta / _safe(s.d_m2, one)
        eta = s.gamma / _safe(s.d_m3, one)
        lam = -(eta * s.delta_km1 * s.d_m3) / _safe(s.d_m2, one)
        d_oddk = tau - sigma * sigma * s.d_m2
        deltak = (alpha - lam * sigma * s.d_m2) / _safe(d_oddk, one)
        d_evenk = nu - eta * eta * s.d_m3 - lam * lam * s.d_m2 \
            - deltak * deltak * d_oddk
        d_odd = torch.where(is1, tau, d_oddk)
        delta = torch.where(is1, delta1, deltak)
        d_even = torch.where(is1, d_even1, d_evenk)
        # LₖDₖπₖ = β₁e₁ + γ₁e₂ (pallas_fused.py:5525-5532)
        pi_oddk = -(sigma * s.d_m2 * s.pi_m2) / _safe(d_odd, one)
        pi_odd = torch.where(is1, s.beta / _safe(d_odd, one), pi_oddk)
        pi_even = torch.where(
            is1, (s.gamma - delta * s.beta) / _safe(d_even, one),
            -(delta * d_odd * pi_oddk + lam * s.d_m2 * s.pi_m2
              + eta * s.d_m3 * s.pi_m3) / _safe(d_even, one))
        # the directions, x and y (pallas_fused.py:5534-5554)
        gx_evenk = s.vk - sigma * s.gxe
        gy_evenk = -sigma * s.gye
        gx_oddk = -(eta * s.gxo + lam * s.gxe) - delta * gx_evenk
        gy_oddk = s.uk - (eta * s.gyo + lam * s.gye) - delta * gy_evenk
        gxo = torch.where(is1, s.vk, gx_evenk)
        gxe = torch.where(is1, -delta * s.vk, gx_oddk)
        gyo = torch.where(is1, zero, gy_evenk)
        gye = torch.where(is1, s.uk, gy_oddk)
        zeta_odd = pi_odd - delta * pi_even
        rnorm = torch.sqrt((gamma1 * zeta_odd) ** 2 + (beta1 * pi_even) ** 2)
        solved = (rnorm <= eps_lim) | ((rnorm + 1.0) <= 1.0)
        breakdown = (beta1 <= btol) & (gamma1 <= btol)
        code = torch.where(solved, SOLVED, torch.where(
            breakdown, INCONS_TRI, RUNNING))
        return dict(
            x=s.x + pi_odd * gxo + pi_even * gxe,
            y=s.y + pi_odd * gyo + pi_even * gye,
            vk=torch.where(beta1 > btol, q / _safe(beta1, one), q),
            uk=torch.where(gamma1 > btol, p / _safe(gamma1, one), p),
            vkm1=s.vk, ukm1=s.uk, gxo=gxo, gxe=gxe, gyo=gyo, gye=gye,
            iter=s.iter + 1, beta=beta1, gamma=gamma1, d_m3=d_odd,
            d_m2=d_even, pi_m3=pi_odd, pi_m2=pi_even, delta_km1=delta,
            rnorm=rnorm, status=code.to(torch.int32))

    s = _drive_ref(st0, step, itmax)
    return s.x, s.y, s.iter, s.rnorm, s.status


def trimr_dia_fused_ref(pd, pd_adj, offsets, offsets_adj, b, c, tau, nu,
                        atol, rtol, itmax):
    """Plain PyTorch TriMR of [τI A; Aᴴ νI][x; y] = [b; c] (pallas_fused.py:
    5639-5863): the SSY process, the four previous reflections applied to
    the new columns of Sₖ₊₁.ₖ, the current cascade of four, the four-deep
    x and y direction recurrences (masked coefficients on zeroed panels at
    the first two iterations) and the π pair; q or p stays un-normalised
    where its norm is at most eps^¾, both at once is a breakdown (code 28)
    unless the solved test holds.

    Returns (x, y, niter, rnorm, status) as tensors, as
    ``trimr_dia_fused`` does."""
    one, zero = _scalar(1, b), _scalar(0, b)
    tau, nu = _scalar(tau, b), _scalar(nu, b)
    btol = _scalar(float(torch.finfo(b.dtype).eps) ** 0.75, b)
    beta0, gamma0, v1, u1 = _ssy_start(b, c)
    rnorm0 = torch.sqrt(gamma0 * gamma0 + beta0 * beta0)
    eps_lim = _scalar(atol, b) + _scalar(rtol, b) * rnorm0
    status0 = torch.where(rnorm0 == 0, ZERO_RESIDUAL, torch.where(
        rnorm0 <= eps_lim, SOLVED, RUNNING)).to(torch.int32)
    zv = torch.zeros_like(b)
    scal = ("oc1", "os1", "oc2", "os2", "oc3", "os3", "oc4", "os4",
            "sbar_m2", "ebar_m3", "lbar_m3", "mu_m5", "mu_m4", "lam_m4")
    st0 = types.SimpleNamespace(
        x=zv, y=zv, vk=v1, uk=u1, vkm1=zv, ukm1=zv,
        gx=torch.zeros((4,) + b.shape, dtype=b.dtype, device=b.device),
        gy=torch.zeros((4,) + b.shape, dtype=b.dtype, device=b.device),
        iter=_i32(0, b), beta=beta0, gamma=gamma0, pibar_odd=beta0,
        pibar_even=gamma0, rnorm=rnorm0, status=status0,
        **dict.fromkeys(scal, zero))

    def step(s):
        first = s.iter == 0
        ge2 = s.iter >= 1
        q, p, alpha, beta1, gamma1 = _ssy_ref(pd, offsets, pd_adj,
                                              offsets_adj, s, one, zero)
        # the four previous reflections (pallas_fused.py:5742-5770)
        sbis_m2 = s.oc1 * s.sbar_m2 + s.os1 * alpha
        ebis_m2 = s.os1 * nu
        lbis_m2 = s.os1 * beta1
        thbis = s.os1 * s.sbar_m2 - s.oc1 * alpha
        dbis_even = -s.oc1 * nu
        sbis_even = -s.oc1 * beta1
        e_m3 = s.oc2 * s.ebar_m3 + s.os2 * sbis_m2
        l_m3 = s.oc2 * s.lbar_m3 + s.os2 * ebis_m2
        mu_m3 = s.os2 * lbis_m2
        shat_m2 = s.os2 * s.ebar_m3 - s.oc2 * sbis_m2
        ehat_m2 = s.os2 * s.lbar_m3 - s.oc2 * ebis_m2
        lhat_m2 = -s.oc2 * lbis_m2
        stmp_m2 = s.oc3 * shat_m2 + s.os3 * thbis
        etmp_m2 = s.oc3 * ehat_m2 + s.os3 * dbis_even
        ltmp_m2 = s.oc3 * lhat_m2 + s.os3 * sbis_even
        thetabar_k = s.os3 * shat_m2 - s.oc3 * thbis
        dbar_even_k = s.os3 * ehat_m2 - s.oc3 * dbis_even
        sbar_even_k = s.os3 * lhat_m2 - s.oc3 * sbis_even
        s_m2 = s.oc4 * stmp_m2 + s.os4 * tau
        e_m2 = s.oc4 * etmp_m2 + s.os4 * alpha
        l_m2 = s.oc4 * ltmp_m2
        mu_m2 = s.os4 * gamma1
        dbar_odd_k = s.os4 * stmp_m2 - s.oc4 * tau
        sbar_odd_k = s.os4 * etmp_m2 - s.oc4 * alpha
        ebar_odd_k = s.os4 * ltmp_m2
        lbar_odd_k = -s.oc4 * gamma1
        thetabar = torch.where(first, alpha, thetabar_k)
        dbar_odd = torch.where(first, tau, dbar_odd_k)
        dbar_even = torch.where(first, nu, dbar_even_k)
        sbar_odd = torch.where(first, alpha, sbar_odd_k)
        sbar_even = torch.where(first, beta1, sbar_even_k)
        lbar_odd = torch.where(first, gamma1, lbar_odd_k)
        ebar_odd = torch.where(first, zero, ebar_odd_k)
        e_m3, l_m3, mu_m3, s_m2, e_m2, l_m2, mu_m2 = (
            torch.where(first, zero, v)
            for v in (e_m3, l_m3, mu_m3, s_m2, e_m2, l_m2, mu_m2))
        # the current cascade (pallas_fused.py:5786-5794)
        c1, s1, theta_k = sym_givens(thetabar, gamma1)
        g_k = s1 * dbar_even
        dbar_even2 = c1 * dbar_even
        c2, s2, d_odd = sym_givens(dbar_odd, theta_k)
        s_odd = c2 * sbar_odd + s2 * dbar_even2
        dbis_even2 = s2 * sbar_odd - c2 * dbar_even2
        c3, s3, dhat_even = sym_givens(dbis_even2, g_k)
        c4, s4, d_even = sym_givens(dhat_even, beta1)
        # the directions on the zeroed panels (pallas_fused.py:5796-5817)
        sd_odd, sd_even = _safe(d_odd, one), _safe(d_even, one)
        mu5 = torch.where(first, zero, s.mu_m5)
        mu4 = torch.where(first, zero, s.mu_m4)
        lam4 = torch.where(first, zero, s.lam_m4)
        gx, gy = s.gx, s.gy
        gx_odd = (s.vk - mu5 * gx[0] - lam4 * gx[1] - e_m3 * gx[2]
                  - s_m2 * gx[3]) / sd_odd
        gx_even = (-mu4 * gx[1] - l_m3 * gx[2] - e_m2 * gx[3]
                   - s_odd * gx_odd) / sd_even
        gy_odd = (-mu5 * gy[0] - lam4 * gy[1] - e_m3 * gy[2]
                  - s_m2 * gy[3]) / sd_odd
        gy_even = (s.uk - mu4 * gy[1] - l_m3 * gy[2] - e_m2 * gy[3]
                   - s_odd * gy_odd) / sd_even
        # the π pair (pallas_fused.py:5819-5827)
        pibis_even = c1 * s.pibar_even
        pibis_next_even = s1 * s.pibar_even
        pi_odd = c2 * s.pibar_odd + s2 * pibis_even
        pihat_even = s2 * s.pibar_odd - c2 * pibis_even
        pitmp = c3 * pihat_even + s3 * pibis_next_even
        pibar_next_even = s3 * pihat_even - c3 * pibis_next_even
        pi_even = c4 * pitmp
        pibar_next_odd = s4 * pitmp
        rnorm = torch.sqrt(pibar_next_odd ** 2 + pibar_next_even ** 2)
        solved = (rnorm <= eps_lim) | ((rnorm + 1.0) <= 1.0)
        breakdown = (beta1 <= btol) & (gamma1 <= btol)
        code = torch.where(solved, SOLVED, torch.where(
            breakdown, INCONS_TRI, RUNNING))
        return dict(
            x=s.x + pi_odd * gx_odd + pi_even * gx_even,
            y=s.y + pi_odd * gy_odd + pi_even * gy_even,
            vk=torch.where(beta1 > btol, q / _safe(beta1, one), q),
            uk=torch.where(gamma1 > btol, p / _safe(gamma1, one), p),
            vkm1=s.vk, ukm1=s.uk,
            gx=torch.stack([gx[2], gx[3], gx_odd, gx_even]),
            gy=torch.stack([gy[2], gy[3], gy_odd, gy_even]),
            iter=s.iter + 1, beta=beta1, gamma=gamma1, oc1=c1, os1=s1,
            oc2=c2, os2=s2, oc3=c3, os3=s3, oc4=c4, os4=s4,
            sbar_m2=sbar_even, ebar_m3=ebar_odd, lbar_m3=lbar_odd,
            mu_m5=torch.where(ge2, mu_m3, s.mu_m5),
            mu_m4=torch.where(ge2, mu_m2, s.mu_m4),
            lam_m4=torch.where(ge2, l_m2, s.lam_m4),
            pibar_odd=pibar_next_odd, pibar_even=pibar_next_even,
            rnorm=rnorm, status=code.to(torch.int32))

    s = _drive_ref(st0, step, itmax)
    return s.x, s.y, s.iter, s.rnorm, s.status


# ---------------------------------------------------------------------------
# GPMR: the plain version
# ---------------------------------------------------------------------------

def _rotate_quad(col, i0, cs, ss):
    """Rows 2i0 .. 2i0 + 3 of a column (CPU 0-d tensors) through one stored
    reflection quadruple (pallas_fused.py:8369-8392)."""
    c1, c2, c3, c4 = cs
    s1, s2, s3, s4 = ss
    r1, r2, r3, r4 = col[2 * i0:2 * i0 + 4]
    t = c1 * r1 + s1 * r4
    r4 = s1 * r1 - c1 * r4
    r1 = t
    t = c2 * r1 + s2 * r2
    r2 = s2 * r1 - c2 * r2
    r1 = t
    t = c3 * r2 + s3 * r4
    r4 = s3 * r2 - c3 * r4
    r2 = t
    t = c4 * r2 + s4 * r3
    r3 = s4 * r2 - c4 * r3
    r2 = t
    col[2 * i0:2 * i0 + 4] = [r1, r2, r3, r4]


def _gp_layout(mem):
    """(scalars, work rows, partial rows) of the GPMR kernel at this mem
    (csrc/gpmr_dia.cu, struct Layout): h, f, zt, the quadruples' c and s,
    R, and the staging copy (rNorm, zt, the quadruple, two columns); the
    basis V and U (mem + 1 rows each), q, p, x, y; the dots' partials."""
    r = _GP_H + 2 * mem + (2 * mem + 2) + 8 * mem
    nsc = r + (2 * mem + 2) * 2 * mem + 1 + 4 + 8 + 2 * (2 * mem + 2)
    return nsc, 2 * mem + 6, 2 * mem + 2


def gpmr_dia_fused_ref(pd_a, pd_b, offsets_a, offsets_b, b, c, lam, mu,
                       atol, rtol, itmax, mem=20):
    """Plain PyTorch GPMR of [λI A; B μI][x; y] = [b; c] (pallas_fused.py:
    8220-8549): A on uₖ, B on vₖ, classical Gram–Schmidt against the basis
    (every dot first, then the subtraction), the stored reflection
    quadruples applied one after another to the two new columns, the
    current four, t̄ and the status (100 when k reaches mem), then the
    back substitution on the 2k × 2k triangle (a pivot of modulus at most
    eps^¾ gives 0 and the inconsistent flag) and x = Σ zt₂ᵢ Vᵢ,
    y = Σ zt₂ᵢ₊₁ Uᵢ.  The vectors stay on b's device and the scalar work
    runs on the CPU in b's dtype.

    Returns (x, y, niter, rnorm, status, inconsistent) as tensors, as
    ``gpmr_dia_fused`` does."""
    dev, T = b.device, b.dtype
    n = b.shape[0]
    two = 2 * mem

    def cpu(v):
        return torch.as_tensor(v, dtype=T)

    one, zero = cpu(1), cpu(0)
    lam, mu = cpu(lam), cpu(mu)
    btol = float(torch.finfo(T).eps) ** 0.75
    V = torch.zeros((mem + 1, n), dtype=T, device=dev)
    U = torch.zeros((mem + 1, n), dtype=T, device=dev)
    beta0 = torch.sqrt(torch.sum(b * b))
    gamma0 = torch.sqrt(torch.sum(c * c))
    V[0] = torch.where(beta0 != 0, b / _safe(beta0, _scalar(1, b)), 0)
    U[0] = torch.where(gamma0 != 0, c / _safe(gamma0, _scalar(1, b)), 0)
    beta0, gamma0 = beta0.cpu(), gamma0.cpu()
    rnorm = torch.sqrt(beta0 * beta0 + gamma0 * gamma0)
    eps_lim = cpu(atol) + cpu(rtol) * rnorm
    zt = [zero] * (two + 2)
    zt[0], zt[1] = beta0, gamma0
    gc, gs = [zero] * (4 * mem), [zero] * (4 * mem)
    R = torch.zeros((two + 2, two), dtype=T)
    status = (ZERO_RESIDUAL if rnorm == 0 else SOLVED if rnorm <= eps_lim
              else RUNNING)
    it = 0
    while status == RUNNING and it < itmax:
        k = it + 1
        q = dia_spmv_aligned_ref(pd_a, offsets_a, U[it])
        p = dia_spmv_aligned_ref(pd_b, offsets_b, V[it])
        # CGS: all 2k dots, then the subtraction (pallas_fused.py:8318-8334)
        hf = torch.stack([torch.stack([torch.sum(V[j] * q),
                                       torch.sum(U[j] * p)])
                          for j in range(k)])
        for j in range(k):
            q = q - hf[j, 0] * V[j]
            p = p - hf[j, 1] * U[j]
        haux = torch.sqrt(torch.sum(q * q)).cpu()
        faux = torch.sqrt(torch.sum(p * p)).cpu()
        hf = hf.cpu()
        # the two new columns (pallas_fused.py:8339-8350)
        co, ce = [zero] * (two + 2), [zero] * (two + 2)
        for j in range(k):
            co[2 * j + 1] = hf[j, 1]
            ce[2 * j] = hf[j, 0]
        co[2 * k - 2] = co[2 * k - 2] + lam
        ce[2 * k - 1] = ce[2 * k - 1] + mu
        for i0 in range(k - 1):
            cs = gc[4 * i0:4 * i0 + 4]
            ss = gs[4 * i0:4 * i0 + 4]
            _rotate_quad(co, i0, cs, ss)
            _rotate_quad(ce, i0, cs, ss)
        # the current reflections (pallas_fused.py:8396-8412)
        c1, s1, do = sym_givens(co[2 * k - 2], faux)
        theta = s1 * ce[2 * k - 2]
        de1 = c1 * ce[2 * k - 2]
        c2, s2, do = sym_givens(do, co[2 * k - 1])
        t = c2 * de1 + s2 * ce[2 * k - 1]
        de2 = s2 * de1 - c2 * ce[2 * k - 1]
        de1 = t
        c3, s3, de2 = sym_givens(de2, theta)
        c4, s4, de2 = sym_givens(de2, haux)
        co[2 * k - 2], co[2 * k - 1] = do, zero
        ce[2 * k - 2], ce[2 * k - 1] = de1, de2
        R[:2 * k, 2 * k - 2] = torch.stack(co[:2 * k])
        R[:2 * k, 2 * k - 1] = torch.stack(ce[:2 * k])
        # t̄ₖ (pallas_fused.py:8420-8433)
        z1, z2 = zt[2 * k - 2], zt[2 * k - 1]
        tbar_pp = s1 * z1
        z1 = c1 * z1
        t = c2 * z1 + s2 * z2
        z2 = s2 * z1 - c2 * z2
        z1 = t
        t = c3 * z2 + s3 * tbar_pp
        tbar_pp = s3 * z2 - c3 * tbar_pp
        z2 = t
        tbar_p = s4 * z2
        z2 = c4 * z2
        zt[2 * k - 2], zt[2 * k - 1] = z1, z2
        gc[4 * k - 4:4 * k] = [c1, c2, c3, c4]
        gs[4 * k - 4:4 * k] = [s1, s2, s3, s4]
        rnorm = torch.sqrt(tbar_p * tbar_p + tbar_pp * tbar_pp)
        if rnorm <= eps_lim or rnorm + 1.0 <= 1.0:
            status = SOLVED
        elif faux <= btol and haux <= btol:
            status = BREAKDOWN
        elif k >= mem:
            status = TIRED
        if status == RUNNING:
            V[k] = q / haux.to(dev) if haux > btol else 0
            U[k] = p / faux.to(dev) if faux > btol else 0
            zt[2 * k], zt[2 * k + 1] = tbar_p, tbar_pp
        it = k
    # the back substitution and the solution (pallas_fused.py:8455-8495)
    y_t, sing = _back_substitute_ref(R, torch.stack(zt), 2 * it, btol)
    y_t = y_t.to(dev)
    x = torch.zeros_like(b)
    y = torch.zeros_like(c)
    for i in range(it):
        x = x + y_t[2 * i] * V[i]
        y = y + y_t[2 * i + 1] * U[i]
    return (x, y, _i32(it, b), rnorm.to(dev), _i32(status, b),
            _i32(int(sing), b))


# ---------------------------------------------------------------------------
# block GMRES: the plain version
# ---------------------------------------------------------------------------

def _fro_np(G):
    """‖G‖_F of a small numpy matrix, the squares summed from 0 by rows."""
    s = G.dtype.type(0)
    for v in G.reshape(-1):
        s = s + v * v
    return np.sqrt(s)


def _bg_layout(mem, p):
    """(scalars, partial rows) of the block GMRES kernel
    (csrc/block_gmres.cuh, struct Layout): NSC fixed slots, H1 and H2
    (mem p × p each), R₁ with its pivots and R₂ with its pivots (p² + p
    each), the rotations c and s (mem p × p each), Z ((mem+1) p × p), Y
    (mem p × p) and the triangle ((mem p)²); the partial rows of H (mem p
    × p entries), which the Gram triangles' reuse."""
    mp = mem * p
    return (_BG_NSC + 5 * mp * p + 2 * (p * p + p) + (mp + p) * p + mp * mp,
            mp * p)


def block_gmres_dia_fused_ref(pd, offsets, B, atol, rtol, itmax, mem=16,
                              basis_dtype=None):
    """Plain PyTorch restarted block GMRES(mem) of AX = B (pallas_fused.py:
    2221-2597): the panels (p columns of n) on B's device, block CGS2
    against the panels 0..k, CholQR2, and on the host in B's dtype the
    banded block Hessenberg's Givens QR (every earlier rotation replayed,
    p new ones per column), Z, the mass stranded on singular pivots, the
    back substitution and its inconsistent flag; X += V Y, one basis
    vector after another, and the reseed from B − AX, in the TPU kernel's
    order.  With ``basis_dtype`` the basis is stored in that type, every
    pass end reseeds, and a stop on the residual estimate holds only where
    the true residual confirms it or the pass stagnated.

    Returns (X (n, p), niter, rnorm, status, inconsistent, npass) as
    tensors, as ``block_gmres_dia_fused`` does."""
    dev, T = B.device, B.dtype
    NT = _NP[T]
    n, p = B.shape
    BT = T if basis_dtype is None else basis_dtype
    confirm = basis_dtype is not None
    btol = NT(float(torch.finfo(T).eps) ** 0.75)
    zero, one = NT(0), NT(1)
    mp, mp1 = mem * p, (mem + 1) * p
    Bt = B.T.contiguous()
    V = torch.zeros((mp1, n), dtype=BT, device=dev)
    X = torch.zeros((p, n), dtype=T, device=dev)
    cs = np.zeros((mp, p), dtype=NT)
    sn = np.zeros((mp, p), dtype=NT)
    Rt = np.zeros((mp, mp), dtype=NT)
    zz = np.zeros((mp1, p), dtype=NT)
    strand = [zero]

    def reseed():
        W = Bt - torch.stack([dia_spmv_aligned_ref(pd, offsets, X[b])
                              for b in range(p)])
        W, G = _cholqr2_ref(W, btol)
        V[:p] = W.to(BT)
        zz[:] = zero
        zz[:p] = G
        strand[0] = zero
        return _fro_np(G)

    beta0 = reseed()
    eps_lim = NT(atol) + NT(rtol) * beta0
    status = (ZERO_RESIDUAL if beta0 == 0 else SOLVED if beta0 <= eps_lim
              else RUNNING)
    it, k, rnorm, incons, npass = 0, 0, beta0, False, 1
    prev_tr = NT(np.inf)
    while status == RUNNING and it < itmax:
        # W = A V_k, CGS2 against the panels 0..k (pallas_fused.py:
        # 2396-2432)
        W = torch.stack([dia_spmv_aligned_ref(pd, offsets,
                                              V[k * p + b].to(T))
                         for b in range(p)])
        Vk = V[:(k + 1) * p].to(T)
        with full_fp32():
            H1 = Vk @ W.T
            W = W - H1.T @ Vk
            H2 = Vk @ W.T
            W = W - H2.T @ Vk
        H = (H1 + H2).cpu().numpy()
        # CholQR2 into V_{k+1}, H_{k+1,k} = R (:2435-2439)
        W, R = _cholqr2_ref(W, btol)
        hbis = _fro_np(R)
        V[(k + 1) * p:(k + 2) * p] = W.to(BT)
        # the p new columns of the banded Hessenberg (:2441-2511)
        for l in range(p):
            c = k * p + l
            col = np.zeros(mp1, dtype=NT)
            col[:(k + 1) * p] = H[:, l]
            col[(k + 1) * p:(k + 2) * p] = R[:, l]
            for c2 in range(c):
                for j in range(p):
                    r = c2 + p - j
                    u, v = col[r - 1], col[r]
                    col[r - 1] = cs[c2, j] * u + sn[c2, j] * v
                    col[r] = sn[c2, j] * u - cs[c2, j] * v
            for j in range(p):
                r = c + p - j
                ch, sh, rr = (NT(v.item()) for v in sym_givens(
                    torch.tensor(col[r - 1]), torch.tensor(col[r])))
                cs[c, j], sn[c, j], col[r - 1] = ch, sh, rr
                for b in range(p):
                    u, v = zz[r - 1, b], zz[r, b]
                    zz[r - 1, b] = ch * u + sh * v
                    zz[r, b] = sh * u - ch * v
            Rt[:c + 1, c] = col[:c + 1]
            sm = zero
            for b in range(p):
                sm = sm + zz[c, b] ** 2
            strand[0] = strand[0] + (sm if abs(col[c]) <= btol else zero)
        ss = strand[0]
        for a in range(p):
            for b in range(p):
                ss = ss + zz[(k + 1) * p + a, b] ** 2
        rnorm_n = np.sqrt(ss)
        it, kk = it + 1, k + 1
        resid = bool(rnorm_n <= eps_lim or rnorm_n + one <= one)
        brk = bool(hbis <= btol)
        tired = it >= itmax
        inner_done = resid or brk or tired or kk >= mem
        tmp0, sing, confirmed = rnorm_n, False, False
        if inner_done:
            # the back substitution and X += V Y (:2515-2546)
            cols = kk * p
            Y = np.zeros((cols, p), dtype=NT)
            for i in reversed(range(cols)):
                acc = zz[i].copy()
                for j in range(i + 1, cols):
                    acc = acc - Rt[i, j] * Y[j]
                if abs(Rt[i, i]) <= btol:
                    sing = True
                else:
                    Y[i] = acc / Rt[i, i]
            Yt = torch.as_tensor(Y, device=dev)
            for j in range(cols):
                X = X + Yt[j][:, None] * V[j].to(T)[None, :]
            if confirm or not (resid or brk or tired):
                tmp0 = reseed()
                confirmed = bool(tmp0 <= eps_lim or tmp0 + one <= one)
        if confirm:
            final = resid and (confirmed or bool(tmp0 > NT(0.5) * prev_tr))
            if inner_done and resid and not final:
                prev_tr = tmp0
        else:
            final = resid
        glob_final = final or brk or tired
        incons = incons or (inner_done and sing)
        code = BREAKDOWN
        code = TIRED if tired else code
        code = SOLVED if final else code
        status = (RUNNING if not glob_final else code) if inner_done \
            else RUNNING
        k = 0 if inner_done else kk
        if inner_done and not glob_final:
            npass += 1
            rnorm = tmp0
        else:
            rnorm = rnorm_n
    return (X.T.contiguous(), _i32(it, B), torch.as_tensor(rnorm, device=dev),
            _i32(status, B), _i32(int(incons), B), _i32(npass, B))


# ---------------------------------------------------------------------------
# block MINRES: the plain version
# ---------------------------------------------------------------------------

def _cholqr_ref(W, btol):
    """One CholQR pass of the panel W (p, n) on the card, the TPU kernel's
    (pallas_fused.py:2713-2748): the Gram matrix, its Cholesky R with a
    pivot ≤ btol keeping its row of R at 0 off the diagonal and its column
    undivided, and W ← W R⁻¹ column by column.  Returns (W, R), R a numpy
    array in W's dtype."""
    p = W.shape[0]
    iu = [(a, b) for a in range(p) for b in range(a, p)]
    gram = torch.stack([torch.sum(W[a] * W[b]) for a, b in iu]).cpu()
    G = np.zeros((p, p), dtype=_NP[W.dtype])
    for (a, b), g in zip(iu, gram.numpy()):
        G[a, b] = g
    zero, one = G.dtype.type(0), G.dtype.type(1)
    R = np.zeros_like(G)
    safe = []
    for i in range(p):
        s = G[i, i]
        for t in range(i):
            s = s - R[t, i] ** 2
        di = np.sqrt(max(s, zero))
        R[i, i] = di
        safe.append(one if di <= btol else di)
        for j in range(i + 1, p):
            s2 = G[i, j]
            for t in range(i):
                s2 = s2 - R[t, i] * R[t, j]
            R[i, j] = zero if di <= btol else s2 / safe[i]
    cols = []
    for i in range(p):
        w = W[i]
        for t in range(i):
            w = w - float(R[t, i]) * cols[t]
        cols.append(w / float(safe[i]))
    return torch.stack(cols), R


_NP = {torch.float32: np.float32, torch.float64: np.float64}


def _cholqr2_ref(W, btol):
    """CholQR2 (pallas_fused.py:2750-2762): two passes, and R = R₂R₁
    (upper triangular), each entry summed from 0 in the order of t."""
    W, R1 = _cholqr_ref(W, btol)
    W, R2 = _cholqr_ref(W, btol)
    p = R1.shape[0]
    R = np.zeros_like(R1)
    for i in range(p):
        for j in range(i, p):
            s = R1.dtype.type(0)
            for t in range(i, j + 1):
                s = s + R2[i, t] * R1[t, j]
            R[i, j] = s
    return W, R


def _mm_np(A, B):
    """A @ B for small numpy matrices, each entry summed from 0 in order."""
    out = np.zeros((A.shape[0], B.shape[1]), dtype=A.dtype)
    for r in range(A.shape[0]):
        for c in range(B.shape[1]):
            s = A.dtype.type(0)
            for t in range(A.shape[1]):
                s = s + A[r, t] * B[t, c]
            out[r, c] = s
    return out


def _bm_layout(p):
    """(scalars, work rows, partial rows) of the block MINRES kernel
    (csrc/block_minres.cuh, struct Layout): ATOL, RTOL, EPS_LIM, then
    the state from RNORM (rNorm, Ψ, Φbar, Θₖ₋₂, Θₖ₋₁: 1 + 10p²) and its
    staging copy, then Ω and R₁ (p² each); six panels of p rows (V in
    three slots, W̃ in two, X); the partials of Ω and of two Gram
    triangles."""
    state = 1 + 10 * p * p
    return (_BM_RNORM + 2 * state + 2 * p * p, 6 * p,
            p * p + p * (p + 1))


def block_minres_dia_fused_ref(pd, offsets, B, atol, rtol, itmax):
    """Plain PyTorch block MINRES of AX = B, A Hermitian (pallas_fused.py:
    2669-2942): the panels (p columns of n) on B's device, the p × p and
    2p × 2p scalar work on the CPU in B's dtype, in the TPU kernel's
    order: CholQR2 of B and of each Lanczos remainder, Θₖ₋₂ and Θₖ₋₁ on
    [0; Ψₖᵀ] and [Γbar; Ωₖ], the Givens QR of [Λbar; Ψₖ₊₁] accumulated
    into Θₖ, [Φₖ; Φbarₖ₊₁], the direction panel and X += W̃ₖΦₖ.

    Returns (X (n, p), niter, rnorm, status) as tensors, as
    ``block_minres_dia_fused`` does."""
    dev, T = B.device, B.dtype
    NT = _NP[T]
    p = B.shape[1]
    btol = NT(float(torch.finfo(T).eps) ** 0.75)
    zero, one = NT(0), NT(1)
    Vk, phib = _cholqr2_ref(B.T.contiguous(), btol)
    Vkm1 = torch.zeros_like(Vk)
    wm1 = torch.zeros_like(Vk)
    wm2 = torch.zeros_like(Vk)
    X = torch.zeros_like(Vk)
    psi = np.zeros((p, p), dtype=NT)
    qt1 = np.eye(2 * p, dtype=NT)
    qt2 = np.eye(2 * p, dtype=NT)
    bsq = zero
    for a in range(p):
        for b in range(p):
            bsq = bsq + phib[a, b] ** 2
    rnorm = np.sqrt(bsq)
    eps_lim = NT(atol) + NT(rtol) * rnorm
    status = (ZERO_RESIDUAL if rnorm == 0 else SOLVED if rnorm <= eps_lim
              else RUNNING)
    it = 0
    while status == RUNNING and it < itmax:
        it += 1
        # the block Lanczos step (pallas_fused.py:2800-2817)
        W = torch.stack([dia_spmv_aligned_ref(pd, offsets, Vk[b])
                         for b in range(p)])
        om = torch.stack([torch.stack([torch.sum(Vk[a] * W[b])
                                       for b in range(p)])
                          for a in range(p)]).cpu().numpy()
        m2 = one if it >= 2 else zero
        cols = []
        for b in range(p):
            w = W[b]
            for a in range(p):
                w = w - float(m2 * psi[b, a]) * Vkm1[a]
                w = w - float(om[a, b]) * Vk[a]
            cols.append(w)
        W = torch.stack(cols)
        # the reflections of the last two iterations (:2820-2850)
        m3 = one if it >= 3 else zero
        sm = _mm_np(qt2[:, p:], psi.T)
        pi = m3 * sm[:p]
        stk_top = sm[p:] if it >= 3 else psi.T.copy()
        sm = np.zeros((2 * p, p), dtype=NT)
        for r in range(2 * p):
            for c in range(p):
                s = zero
                for t in range(p):
                    s = s + qt1[r, t] * stk_top[t, c]
                    s = s + qt1[r, p + t] * om[t, c]
                sm[r, c] = s
        gam = m2 * sm[:p]
        lam = sm[p:] if it >= 2 else om.copy()
        # Vₖ₊₁ and Ψₖ₊₁ (:2853), Θₖ by Givens rotations (:2856-2882)
        W, R = _cholqr2_ref(W, btol)
        stk = np.concatenate([lam, R])
        qtn = np.eye(2 * p, dtype=NT)
        for j in range(p):
            for r in range(2 * p - 1, j, -1):
                ch, sh, rr = (NT(v.item()) for v in sym_givens(
                    torch.tensor(stk[r - 1, j]), torch.tensor(stk[r, j])))
                stk[r - 1, j], stk[r, j] = rr, zero
                for c in range(j + 1, p):
                    u, v = stk[r - 1, c], stk[r, c]
                    stk[r - 1, c] = ch * u + sh * v
                    stk[r, c] = sh * u - ch * v
                for c in range(2 * p):
                    u, v = qtn[r - 1, c], qtn[r, c]
                    qtn[r - 1, c] = ch * u + sh * v
                    qtn[r, c] = sh * u - ch * v
        lam = stk[:p]
        sm = _mm_np(qtn[:, :p], phib)
        # the direction panel and X (:2893-2918)
        wt = []
        for j in range(p):
            w = Vk[j]
            for a in range(p):
                w = w - float(gam[a, j]) * wm1[a]
                w = w - float(pi[a, j]) * wm2[a]
            for t in range(j):
                w = w - float(lam[t, j]) * wt[t]
            dj = lam[j, j]
            wt.append(w / float(one if dj == 0 else dj))
        wt = torch.stack(wt)
        xs = []
        for b in range(p):
            xb = X[b]
            for t in range(p):
                xb = xb + float(sm[t, b]) * wt[t]
            xs.append(xb)
        X = torch.stack(xs)
        phib = sm[p:].copy()
        psi = R
        rsq = zero
        for a in range(p):
            for b in range(p):
                rsq = rsq + phib[a, b] ** 2
        Vkm1, Vk, wm2, wm1 = Vk, W, wm1, wt
        qt2, qt1 = qt1, qtn
        rnorm = np.sqrt(rsq)
        status = (SOLVED if rnorm <= eps_lim or rnorm + one <= one
                  else RUNNING)
    return (X.T.contiguous(), _i32(it, B),
            torch.as_tensor(rnorm, device=dev), _i32(status, B))


# ---------------------------------------------------------------------------
# the kernel wrappers
# ---------------------------------------------------------------------------

def _check(pd, offsets, b, dinv):
    _check_spmv(pd, offsets, b)
    if dinv is not None and (dinv.shape != b.shape or dinv.dtype != b.dtype
                             or dinv.device != b.device
                             or not dinv.is_contiguous()):
        raise ValueError("dinv must be a contiguous vector like b")


def _pair(name, b, pd):
    """The C entry points' type suffix; raises where there is no kernel."""
    pair = _PAIR.get((b.dtype, pd.dtype))
    if pair is None or b.device.type != "cuda":
        raise ValueError(f"no {name} kernel for b {b.dtype} with pd "
                         f"{pd.dtype} on {b.device}")
    return pair


def _pair_adjoint(name, b, pd, pd_adj, offsets_adj):
    """``_pair`` of a kernel that also applies Aᴴ; raises where Aᴴ's
    diagonals do not fit b or have another dtype than A's."""
    pair = _pair(name, b, pd)
    _check_spmv(pd_adj, offsets_adj, b)
    if pd_adj.dtype != pd.dtype:
        raise ValueError("pd_adj must have pd's dtype")
    return pair


def _grid(b):
    nsm = torch.cuda.get_device_properties(b.device).multi_processor_count
    return max(1, min(-(-b.shape[0] // _THREADS), _BLOCKS_PER_SM * nsm))


def _wide_grid(b, pd):
    """The grid of a launch on wide rows: a few blocks per SM, each
    thread 16 bytes of diagonals a row group."""
    nsm = torch.cuda.get_device_properties(b.device).multi_processor_count
    rows = _THREADS * (16 // pd.element_size())
    return max(1, min(-(-b.shape[0] // rows), _WIDE_BLOCKS_PER_SM * nsm))


def _host_scalars(nsc, b, values):
    """The kernel's scalar array, on b's device, with ``values`` (slot →
    value) set; each value is rounded to b's dtype, as the TPU kernels
    round their scalar inputs."""
    sc = torch.zeros(nsc, dtype=b.dtype)
    for slot, v in values.items():
        sc[slot] = v
    return sc.to(b.device)


def _run(wrapper, b, init_name, init_args, iter_name, iter_args, st, itmax):
    """One init call, then iterate calls in chunks until the status read
    at a chunk's end says the solve stopped (or the cap).  Each C call
    counts as one launch of ``wrapper``'s kernel."""
    lib = _build.library()
    with torch.cuda.device(b.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, init_name)(*init_args, stream)
        wrapper.launches += 1
        _build.check(err, init_name)
        state = types.SimpleNamespace(status=st[_STATUS])

        def run(_, cap, steps):
            err = getattr(lib, iter_name)(*iter_args, steps, cap, stream)
            wrapper.launches += 1
            _build.check(err, iter_name)
            return state

        drive(run, itmax, float("inf"))


def _finish(wrapper, name, b, args):
    """One finishing launch after the loop (it reads the final state on
    the device), counted as a launch of ``wrapper``'s kernel."""
    with torch.cuda.device(b.device):
        err = getattr(_build.library(), name)(
            *args, torch.cuda.current_stream().cuda_stream)
    wrapper.launches += 1
    _build.check(err, name)


def cg_dia_fused(pd, offsets, b, atol, rtol, itmax, dinv=None):
    """Full CG solve of A x = b for a DIA matrix.

    Args:
      pd: (nd, n) output-aligned diagonals (see ops/cuda_dia.dia_align).
      offsets: int64 tensor of the nd diagonal offsets, on b's device.
      b: (n,) right-hand side (real floating dtype).
      atol, rtol: tolerances (ε = atol + rtol‖r₀‖).
      itmax: iteration cap.
      dinv: optional (n,) diagonal preconditioner applied as z = dinv·r
        (Jacobi: dinv = 1/diag(A)); rnorm is then the M-norm √(rᴴz).
    Returns:
      (x, niter, rnorm, status_code, posdef_violation) as tensors on b's
      device; status codes follow _runtime (RUNNING = cap hit).
    """
    _check(pd, offsets, b, dinv)
    if b.device.type == "cpu":
        return cg_dia_fused_ref(pd, offsets, b, atol, rtol, itmax, dinv)
    pair = _pair("CG", b, pd)
    n, grid = b.shape[0], _grid(b)
    # the kernels allocate nothing; every buffer starts zeroed
    x, r, p, ap = (torch.zeros_like(b) for _ in range(4))
    partial = torch.zeros(grid, dtype=b.dtype, device=b.device)
    sc = torch.zeros(_CG_NSC, dtype=b.dtype, device=b.device)
    st = torch.zeros(_CG_NST, dtype=torch.int32, device=b.device)
    dptr = None if dinv is None else dinv.data_ptr()
    _run(cg_dia_fused, b, f"ktt_cg_dia_init_{pair[:3]}",
         (b.data_ptr(), dptr, x.data_ptr(), r.data_ptr(), p.data_ptr(),
          partial.data_ptr(), sc.data_ptr(), st.data_ptr(), n, grid,
          float(atol), float(rtol)),
         f"ktt_cg_dia_iterate_{pair}",
         (pd.data_ptr(), offsets.data_ptr(), pd.shape[0], dptr,
          x.data_ptr(), r.data_ptr(), p.data_ptr(), ap.data_ptr(),
          partial.data_ptr(), sc.data_ptr(), st.data_ptr(), n, grid),
         st, itmax)
    return x, st[_IT], sc[_CG_RNORM], st[_STATUS], st[_CG_VIOL]


cg_dia_fused.launches = 0


def cg_cheby_dia_fused(pd, offsets, b, atol, rtol, itmax, lmin, lmax,
                       degree):
    """Full Chebyshev-preconditioned CG solve of A x = b for a DIA matrix.

    M is the degree-``degree`` Chebyshev polynomial ≈ A⁻¹ on
    [lmin, lmax] (``ChebyshevPreconditioner``), applied on the card with
    degree − 1 stencil applications.  rnorm is the M-norm √(rᴴz).
    Returns (x, niter, rnorm, status_code, posdef_violation) as tensors
    on b's device.
    """
    _check(pd, offsets, b, None)
    degree = int(degree)
    if degree < 1:
        raise ValueError("degree must be >= 1")
    if b.device.type == "cpu":
        return cg_cheby_dia_fused_ref(pd, offsets, b, atol, rtol, itmax,
                                      lmin, lmax, degree)
    pair = _pair("Chebyshev CG", b, pd)
    n, grid = b.shape[0], _grid(b)
    theta, steps = cheby_constants(lmin, lmax, degree, b.dtype)
    consts = [theta] + [c for step in steps for c in step]
    sc = _host_scalars(_CG_NSC + len(consts), b,
                       {_CG_NSC + j: c for j, c in enumerate(consts)})
    work = torch.zeros((7, n), dtype=b.dtype, device=b.device)
    partial = torch.zeros(grid, dtype=b.dtype, device=b.device)
    st = torch.zeros(_CG_NST, dtype=torch.int32, device=b.device)
    head = (pd.data_ptr(), offsets.data_ptr(), pd.shape[0])
    bufs = (work.data_ptr(), partial.data_ptr(), sc.data_ptr(),
            st.data_ptr(), n, grid, degree)
    _run(cg_cheby_dia_fused, b, f"ktt_cg_cheby_dia_init_{pair}",
         head + (b.data_ptr(),) + bufs + (float(atol), float(rtol)),
         f"ktt_cg_cheby_dia_iterate_{pair}", head + bufs, st, itmax)
    return work[0].clone(), st[_IT], sc[_CG_RNORM], st[_STATUS], \
        st[_CG_VIOL]


cg_cheby_dia_fused.launches = 0


def _cr_like(wrapper, kind, pd, offsets, b, atol, rtol, itmax, nsc, atol_slot,
             nvec, npart, nst):
    pair = _pair(kind.upper(), b, pd)
    n, grid = b.shape[0], _grid(b)
    sc = _host_scalars(nsc, b, {atol_slot: atol, atol_slot + 1: rtol})
    work = torch.zeros((nvec, n), dtype=b.dtype, device=b.device)
    partial = torch.zeros((npart, grid), dtype=b.dtype, device=b.device)
    st = torch.zeros(nst, dtype=torch.int32, device=b.device)
    head = (pd.data_ptr(), offsets.data_ptr(), pd.shape[0])
    bufs = (work.data_ptr(), partial.data_ptr(), sc.data_ptr(),
            st.data_ptr(), n, grid)
    _run(wrapper, b, f"ktt_{kind}_dia_init_{pair}",
         head + (b.data_ptr(),) + bufs, f"ktt_{kind}_dia_iterate_{pair}",
         head + bufs, st, itmax)
    return work[0].clone(), sc, st


def cr_dia_fused(pd, offsets, b, atol, rtol, itmax):
    """Full CR (conjugate residuals) solve of A x = b for a DIA matrix.

    Returns (x, niter, rnorm, status_code, indef_error) as tensors on b's
    device; indef_error says that some pᴴAp ≤ 0 was met (the solver
    raises "Indefinite system and no trust region").
    """
    _check(pd, offsets, b, None)
    if b.device.type == "cpu":
        return cr_dia_fused_ref(pd, offsets, b, atol, rtol, itmax)
    x, sc, st = _cr_like(cr_dia_fused, "cr", pd, offsets, b, atol, rtol,
                         itmax, _CR_NSC, _CR_ATOL, 5, 3, _CR_NST)
    return x, st[_IT], sc[_CR_RNORM], st[_STATUS], st[_CR_INDEF]


cr_dia_fused.launches = 0


def car_dia_fused(pd, offsets, b, atol, rtol, itmax):
    """Full CAR (min ‖A r‖) solve of A x = b for a DIA matrix.

    Returns (x, niter, rnorm, arnorm, status_code) as tensors on b's
    device.
    """
    _check(pd, offsets, b, None)
    if b.device.type == "cpu":
        return car_dia_fused_ref(pd, offsets, b, atol, rtol, itmax)
    x, sc, st = _cr_like(car_dia_fused, "car", pd, offsets, b, atol, rtol,
                         itmax, _CAR_NSC, _CAR_ATOL, 7, 4, _CAR_NST)
    return x, st[_IT], sc[_CAR_RNORM], sc[_CAR_ARNORM], st[_STATUS]


car_dia_fused.launches = 0


def minres_dia_fused(pd, offsets, b, atol, rtol, etol, ctol, lam, itmax,
                     window=5, dinv=None):
    """Full MINRES solve of (A + λI) x = b for a DIA matrix.

    Args beyond CG's: etol (forward-error window stop), ctol = 1/conlim
    (0 disables), lam (the shift λ), window (the number of φ values in
    the forward-error estimate) and dinv (Jacobi: v = dinv·r₂, β² =
    ⟨r₂, v⟩).
    Returns (x, niter, rnorm, status_code, inconsistent,
    precond_violation) as tensors on b's device.
    """
    _check(pd, offsets, b, dinv)
    window = int(window)
    if window < 1:
        raise ValueError("window must be >= 1")
    if b.device.type == "cpu":
        return minres_dia_fused_ref(pd, offsets, b, atol, rtol, etol, ctol,
                                    lam, itmax, window, dinv)
    pair = _pair("MINRES", b, pd)
    n, grid = b.shape[0], _grid(b)
    sc = _host_scalars(_MR_NSC + window, b,
                       dict(enumerate((atol, rtol, etol, ctol, lam))))
    work = torch.zeros((7, n), dtype=b.dtype, device=b.device)
    partial = torch.zeros((3, grid), dtype=b.dtype, device=b.device)
    st = torch.zeros(_MR_NST, dtype=torch.int32, device=b.device)
    dptr = None if dinv is None else dinv.data_ptr()
    bufs = (work.data_ptr(), partial.data_ptr(), sc.data_ptr(),
            st.data_ptr(), n, grid, window)
    _run(minres_dia_fused, b, f"ktt_minres_dia_init_{pair[:3]}",
         (b.data_ptr(), dptr) + bufs, f"ktt_minres_dia_iterate_{pair}",
         (pd.data_ptr(), offsets.data_ptr(), pd.shape[0], dptr) + bufs,
         st, itmax)
    return (work[0].clone(), st[_IT], sc[_MR_RNORM], st[_STATUS],
            st[_MR_INCON], st[_MR_VIOL])


minres_dia_fused.launches = 0


def cg_lanczos_dia_fused(pd, offsets, b, atol, rtol, itmax,
                         check_curvature=False):
    """Full CG-Lanczos solve of A x = b for a DIA matrix, M = I.

    With ``check_curvature`` an indefinite step is not applied and stops
    the solve with status 27 (negative curvature).
    Returns (x, niter, rnorm, anorm, status_code, indefinite) as tensors
    on b's device.
    """
    _check(pd, offsets, b, None)
    if b.device.type == "cpu":
        return cg_lanczos_dia_fused_ref(pd, offsets, b, atol, rtol, itmax,
                                        check_curvature)
    pair = _pair("CG-Lanczos", b, pd)
    n, grid = b.shape[0], _grid(b)
    sc = _host_scalars(_CGL_NSC, b, {0: atol, 1: rtol})
    work = torch.zeros((5, n), dtype=b.dtype, device=b.device)
    partial = torch.zeros(grid, dtype=b.dtype, device=b.device)
    st = torch.zeros(_CGL_NST, dtype=torch.int32, device=b.device)
    bufs = (work.data_ptr(), partial.data_ptr(), sc.data_ptr(),
            st.data_ptr(), n, grid)
    _run(cg_lanczos_dia_fused, b, f"ktt_cg_lanczos_dia_init_{pair[:3]}",
         (b.data_ptr(),) + bufs, f"ktt_cg_lanczos_dia_iterate_{pair}",
         (pd.data_ptr(), offsets.data_ptr(), pd.shape[0]) + bufs
         + (int(bool(check_curvature)),), st, itmax)
    return (work[0].clone(), st[_IT], sc[_CGL_RNORM],
            torch.sqrt(sc[_CGL_ANORM2]), st[_STATUS], st[_CGL_INDEF])


cg_lanczos_dia_fused.launches = 0


def cg_lanczos_shift_dia_fused(pd, offsets, b, shifts, atol, rtol, itmax,
                               check_curvature=False):
    """Every shifted system (A + σᵢI) xᵢ = b from one Lanczos stream, for
    a DIA matrix, M = I.  ``shifts`` is a 1-D tensor of b's dtype on b's
    device; any number of shifts.

    Returns (X (nshifts, n), niter, rnorms (nshifts,), status_code,
    indefinite (nshifts,)) as tensors on b's device.
    """
    _check(pd, offsets, b, None)
    if (shifts.dim() != 1 or shifts.dtype != b.dtype
            or shifts.device != b.device or shifts.shape[0] < 1):
        raise ValueError("shifts must be a non-empty vector of b's dtype "
                         "on b's device")
    if b.device.type == "cpu":
        return cg_lanczos_shift_dia_fused_ref(pd, offsets, b, shifts, atol,
                                              rtol, itmax, check_curvature)
    pair = _pair("CG-Lanczos-shift", b, pd)
    n, grid, ns = b.shape[0], _grid(b), shifts.shape[0]
    sc = torch.zeros(_CGLS_NSC + _CGLS_NBLK * ns, dtype=b.dtype,
                     device=b.device)
    sc[:2] = torch.tensor([atol, rtol], dtype=b.dtype)
    sc[_CGLS_NSC:_CGLS_NSC + ns] = shifts
    work = torch.zeros((3 + 2 * ns, n), dtype=b.dtype, device=b.device)
    partial = torch.zeros(grid, dtype=b.dtype, device=b.device)
    st = torch.zeros(_CGLS_NST + 3 * ns, dtype=torch.int32, device=b.device)
    bufs = (work.data_ptr(), partial.data_ptr(), sc.data_ptr(),
            st.data_ptr(), n, grid, ns)
    _run(cg_lanczos_shift_dia_fused, b,
         f"ktt_cg_lanczos_shift_dia_init_{pair[:3]}", (b.data_ptr(),) + bufs,
         f"ktt_cg_lanczos_shift_dia_iterate_{pair}",
         (pd.data_ptr(), offsets.data_ptr(), pd.shape[0]) + bufs
         + (int(bool(check_curvature)),), st, itmax)
    rn = _CGLS_NSC + _CGLS_RNORM * ns
    idf = _CGLS_NST + _CGLS_INDEF * ns
    return (work[3:3 + ns].clone(), st[_IT], sc[rn:rn + ns].clone(),
            st[_STATUS], st[idf:idf + ns].clone())


cg_lanczos_shift_dia_fused.launches = 0


def symmlq_dia_fused(pd, offsets, b, atol, rtol, ctol, lam, itmax,
                     transfer_to_cg=True):
    """Full SYMMLQ solve of (A + λI) x = b for a DIA matrix, M = I.

    ctol = 1/conlim (0 disables).  With ``transfer_to_cg`` the solve
    moves x to the CG point when the CG test stops it (one finishing
    launch after the loop).
    Returns (x, niter, rnorm, status_code, anorm2, gmax, gmin) as tensors
    on b's device; the status codes add 34, 35 and 36 (SYMMLQ's own).
    """
    _check(pd, offsets, b, None)
    if b.device.type == "cpu":
        return symmlq_dia_fused_ref(pd, offsets, b, atol, rtol, ctol, lam,
                                    itmax, transfer_to_cg)
    pair = _pair("SYMMLQ", b, pd)
    n, grid = b.shape[0], _grid(b)
    sc = _host_scalars(_SQ_NSC, b, dict(enumerate((atol, rtol, ctol, lam))))
    work = torch.zeros((5, n), dtype=b.dtype, device=b.device)
    partial = torch.zeros(grid, dtype=b.dtype, device=b.device)
    st = torch.zeros(_SQ_NST, dtype=torch.int32, device=b.device)
    args = (pd.data_ptr(), offsets.data_ptr(), pd.shape[0], work.data_ptr(),
            partial.data_ptr(), sc.data_ptr(), st.data_ptr(), n, grid,
            int(bool(transfer_to_cg)))
    _run(symmlq_dia_fused, b, f"ktt_symmlq_dia_init_{pair}",
         args[:3] + (b.data_ptr(),) + args[3:],
         f"ktt_symmlq_dia_iterate_{pair}", args, st, itmax)
    _finish(symmlq_dia_fused, f"ktt_symmlq_dia_finish_{pair[:3]}", b,
            (work.data_ptr(), sc.data_ptr(), st.data_ptr(), n, grid))
    return (work[0].clone(), st[_IT], sc[_SQ_RNORM], st[_STATUS],
            sc[_SQ_ANORM2], sc[_SQ_GMAX], sc[_SQ_GMIN])


symmlq_dia_fused.launches = 0


def minres_qlp_dia_fused(pd, offsets, b, atol, rtol, artol, lam, itmax):
    """Full MINRES-QLP solve of (A + λI) x = b for a DIA matrix, M = I.

    artol is the tolerance of the inconsistency test on ‖Ar‖ and |μ̄ₖ|.
    After the loop one finishing launch applies x += τₖ₋₁wₖ₋₁ + τₖwₖ
    (τₖ dropped when the system was found inconsistent).
    Returns (x, niter, rnorm, status_code, inconsistent, arnorm) as
    tensors on b's device.
    """
    _check(pd, offsets, b, None)
    if b.device.type == "cpu":
        return minres_qlp_dia_fused_ref(pd, offsets, b, atol, rtol, artol,
                                        lam, itmax)
    pair = _pair("MINRES-QLP", b, pd)
    n, grid = b.shape[0], _grid(b)
    sc = _host_scalars(_QLP_NSC, b, dict(enumerate(
        (atol, rtol, artol, lam, torch.finfo(b.dtype).eps ** 0.75))))
    work = torch.zeros((6, n), dtype=b.dtype, device=b.device)
    partial = torch.zeros(grid, dtype=b.dtype, device=b.device)
    st = torch.zeros(_QLP_NST, dtype=torch.int32, device=b.device)
    bufs = (work.data_ptr(), partial.data_ptr(), sc.data_ptr(),
            st.data_ptr(), n, grid)
    _run(minres_qlp_dia_fused, b, f"ktt_minres_qlp_dia_init_{pair[:3]}",
         (b.data_ptr(),) + bufs, f"ktt_minres_qlp_dia_iterate_{pair}",
         (pd.data_ptr(), offsets.data_ptr(), pd.shape[0]) + bufs, st, itmax)
    _finish(minres_qlp_dia_fused, f"ktt_minres_qlp_dia_finish_{pair[:3]}",
            b, bufs[:1] + bufs[2:])
    return (work[0].clone(), st[_IT], sc[_QLP_RNORM], st[_STATUS],
            st[_QLP_INCON], sc[_QLP_ARNORM])


minres_qlp_dia_fused.launches = 0


def minares_dia_fused(pd, offsets, b, atol, rtol, artol, lam, itmax):
    """Full MINARES solve of (A + λI) x = b for a DIA matrix.

    artol is the tolerance of the ‖Ar‖ stop.  Once the Lanczos process
    breaks down (βₖ₊₂ ≤ eps^¾) its stencil launch is skipped by a device
    flag while the iteration finishes.
    Returns (x, niter, rnorm, arnorm, status_code) as tensors on b's
    device; the status codes are 0 running, 2 zero residual, 7
    breakdown and 37 solved.
    """
    _check(pd, offsets, b, None)
    if b.device.type == "cpu":
        return minares_dia_fused_ref(pd, offsets, b, atol, rtol, artol, lam,
                                     itmax)
    pair = _pair("MINARES", b, pd)
    n, grid = b.shape[0], _grid(b)
    sc = _host_scalars(_MNA_NSC, b, dict(enumerate(
        (atol, rtol, artol, lam, torch.finfo(b.dtype).eps ** 0.75))))
    work = torch.zeros((10, n), dtype=b.dtype, device=b.device)
    partial = torch.zeros(grid, dtype=b.dtype, device=b.device)
    st = torch.zeros(_MNA_NST, dtype=torch.int32, device=b.device)
    head = (pd.data_ptr(), offsets.data_ptr(), pd.shape[0])
    bufs = (work.data_ptr(), partial.data_ptr(), sc.data_ptr(),
            st.data_ptr(), n, grid)
    _run(minares_dia_fused, b, f"ktt_minares_dia_init_{pair}",
         head + (b.data_ptr(),) + bufs + (int(itmax),),
         f"ktt_minares_dia_iterate_{pair}", head + bufs, st, itmax)
    return (work[0].clone(), st[_IT], sc[_MNA_RNORM], sc[_MNA_ARNORM],
            st[_STATUS])


minares_dia_fused.launches = 0


def _ar_layout(mem, grid):
    """(the row of the ‖w‖² partials, the Gram rows, the size) of the
    GMRES and FOM kernels' scratch array (csrc/arnoldi.cuh, struct
    Layout): rows of ``grid`` block partials, of cⱼ = ⟨vⱼ, w⟩ (mem rows),
    of the Gram row gⱼ = ⟨vₖ, vⱼ⟩ (mem rows) and of ⟨w, w⟩, then the Gram
    rows G[i, j] = ⟨vᵢ, vⱼ⟩ (mem × mem)."""
    ww = 2 * mem * grid
    return ww, ww + grid, ww + grid + mem * mem


def _arnoldi_fused(wrapper, kind, pd, offsets, b, atol, rtol, itmax, mem,
                   basis_dtype=None):
    """The buffers and launches shared by the GMRES and FOM kernels
    (``csrc/arnoldi.cuh``): the Krylov panel V (mem + 1, n) in its own
    type, the Arnoldi vector w, x, the block partials of the dots and the
    Gram rows (zeroed here), the scalars and the flags; the stencil also
    takes the interior of the offsets."""
    pair = _pair(kind.upper(), b, pd)
    bt = b.dtype if basis_dtype is None else basis_dtype
    n, grid = b.shape[0], _wide_grid(b, pd)
    sc = _host_scalars(_AR_NSC + 5 * mem + 2 + mem * mem, b, dict(
        enumerate((atol, rtol, torch.finfo(b.dtype).eps ** 0.75))))
    V = torch.zeros((mem + 1, n), dtype=bt, device=b.device)
    w, x = torch.zeros_like(b), torch.zeros_like(b)
    partial = torch.zeros(_ar_layout(mem, grid)[2], dtype=b.dtype,
                          device=b.device)
    st = torch.zeros(_AR_NST, dtype=torch.int32, device=b.device)
    bufs = (V.data_ptr(), x.data_ptr(), partial.data_ptr(), sc.data_ptr(),
            st.data_ptr(), n, grid, mem)
    suffix = "" if kind == "fom" else "_" + _BASIS[bt]
    head = (pd.data_ptr(), offsets.data_ptr(), pd.shape[0],
            *_tensor_span(offsets, n)[:2], b.data_ptr(), w.data_ptr()) + bufs
    _run(wrapper, b, f"ktt_{kind}_dia_init_{pair[:3]}{suffix}",
         (b.data_ptr(),) + bufs + (int(itmax),),
         f"ktt_{kind}_dia_iterate_{pair}{suffix}",
         head + ((int(basis_dtype is not None),) if kind == "gmres" else ()),
         st, itmax)
    return x, st[_IT], sc[_AR_RNORM], st[_STATUS], st[_AR_INCONS], \
        st[_AR_NPASS]


def gmres_dia_fused(pd, offsets, b, atol, rtol, itmax, mem=20,
                    basis_dtype=None):
    """Full restarted GMRES(mem) solve of A x = b for a DIA matrix.

    MGS Arnoldi in five launches an iteration (the stencil with every
    dot of w and the Gram row, the coefficients by forward substitution
    in one block, the ordered update, the column, the normalise), Givens
    QR and the back substitution in one thread, restarts from b − Ax on
    the card.
    ``basis_dtype`` (bf16 or f16) stores the Krylov panel compressed
    while the arithmetic stays in b's dtype; a stop is then confirmed
    on the true residual.
    Returns (x, niter, rnorm, status_code, inconsistent, npass) as
    tensors on b's device; status 100 means itmax was reached.
    """
    _check(pd, offsets, b, None)
    mem = int(mem)
    if mem < 1:
        raise ValueError("mem must be >= 1")
    if b.device.type == "cpu":
        return gmres_dia_fused_ref(pd, offsets, b, atol, rtol, itmax, mem,
                                   basis_dtype)
    if not _basis_ok(b.dtype, basis_dtype):
        raise ValueError(f"no GMRES kernel for a {basis_dtype} panel with "
                         f"b {b.dtype}")
    return _arnoldi_fused(gmres_dia_fused, "gmres", pd, offsets, b, atol,
                          rtol, itmax, mem, basis_dtype)


gmres_dia_fused.launches = 0


def fom_dia_fused(pd, offsets, b, atol, rtol, itmax, mem=20):
    """Full restarted FOM(mem) solve of A x = b for a DIA matrix: the
    Arnoldi launches of ``gmres_dia_fused`` with the LU of the
    Hessenberg.  Returns (x, niter, rnorm, status_code, inconsistent,
    npass) as tensors on b's device; status 28 is a breakdown without
    convergence, 100 means itmax was reached."""
    _check(pd, offsets, b, None)
    mem = int(mem)
    if mem < 2:
        raise ValueError("mem must be >= 2")
    if b.device.type == "cpu":
        return fom_dia_fused_ref(pd, offsets, b, atol, rtol, itmax, mem)
    return _arnoldi_fused(fom_dia_fused, "fom", pd, offsets, b, atol, rtol,
                          itmax, mem)


fom_dia_fused.launches = 0


def _biortho_fused(wrapper, kind, pd, offsets, b, atol, rtol, itmax, nvec,
                   npart, nsc, nst):
    pair = _pair(kind.upper(), b, pd)
    n, grid = b.shape[0], _grid(b)
    sc = _host_scalars(nsc, b, {0: atol, 1: rtol})
    work = torch.zeros((nvec, n), dtype=b.dtype, device=b.device)
    partial = torch.zeros((npart, grid), dtype=b.dtype, device=b.device)
    st = torch.zeros(nst, dtype=torch.int32, device=b.device)
    bufs = (b.data_ptr(), work.data_ptr(), partial.data_ptr(), sc.data_ptr(),
            st.data_ptr(), n, grid)
    _run(wrapper, b, f"ktt_{kind}_dia_init_{pair[:3]}", bufs,
         f"ktt_{kind}_dia_iterate_{pair}",
         (pd.data_ptr(), offsets.data_ptr(), pd.shape[0]) + bufs, st, itmax)
    return work[0].clone(), sc, st


def bicgstab_dia_fused(pd, offsets, b, atol, rtol, itmax):
    """Full BiCGSTAB solve of A x = b for a DIA matrix, shadow c = b.

    Returns (x, niter, rnorm, status_code) as tensors on b's device;
    status 29 is bᴴc = 0 and 30 a breakdown αₖ == 0 (or NaN).
    """
    _check(pd, offsets, b, None)
    if b.device.type == "cpu":
        return bicgstab_dia_fused_ref(pd, offsets, b, atol, rtol, itmax)
    x, sc, st = _biortho_fused(bicgstab_dia_fused, "bicgstab", pd, offsets,
                               b, atol, rtol, itmax, 6, _BS_NPART, _BS_NSC,
                               _BS_NST)
    return x, st[_IT], sc[_BS_RNORM], st[_STATUS]


bicgstab_dia_fused.launches = 0


def cgs_dia_fused(pd, offsets, b, atol, rtol, itmax):
    """Full CGS solve of A x = b for a DIA matrix, shadow c = b.

    Returns (x, niter, rnorm, status_code) as tensors on b's device, with
    the status codes of ``bicgstab_dia_fused``.
    """
    _check(pd, offsets, b, None)
    if b.device.type == "cpu":
        return cgs_dia_fused_ref(pd, offsets, b, atol, rtol, itmax)
    x, sc, st = _biortho_fused(cgs_dia_fused, "cgs", pd, offsets, b, atol,
                               rtol, itmax, 7, _CGS_NPART, _CGS_NSC,
                               _CGS_NST)
    return x, st[_IT], sc[_CGS_RNORM], st[_STATUS]


cgs_dia_fused.launches = 0


def trunc_dia_fused(pd, offsets, b, atol, rtol, itmax, mem=20,
                    variant="dqgmres"):
    """Full DIOM or DQGMRES solve of A x = b for a DIA matrix, M = N = I.

    Circular V (mem) and P (mem − 1 for DIOM, mem for DQGMRES) rings in
    device memory, zeroed at the start; per iteration the stencil with
    every window dot's partials, the window subtraction (each block sums
    the dots) with the ‖w‖ partials, the Hessenberg column in one
    thread, and the P-ring, x and V-ring update.
    Returns (x, niter, rnorm, status_code) as tensors on b's device;
    status 100 means itmax was reached.
    """
    _check(pd, offsets, b, None)
    mem = int(mem)
    if mem < 2:
        raise ValueError("mem must be >= 2")
    if variant not in ("diom", "dqgmres"):
        raise ValueError(f"variant must be 'diom' or 'dqgmres', not "
                         f"{variant!r}")
    if b.device.type == "cpu":
        return trunc_dia_fused_ref(pd, offsets, b, atol, rtol, itmax, mem,
                                   variant)
    pair = _pair("DIOM/DQGMRES", b, pd)
    diom = variant == "diom"
    mP = mem - 1 if diom else mem
    n, grid = b.shape[0], _wide_grid(b, pd)
    sc = _host_scalars(_TR_NSC + 5 * mem + 2, b, {0: atol, 1: rtol})
    # the init launch zeroes the rings and x before any read
    V = torch.empty((mem, n), dtype=b.dtype, device=b.device)
    P = torch.empty((mP, n), dtype=b.dtype, device=b.device)
    w, x = torch.empty_like(b), torch.empty_like(b)
    # the partial rows of the window dots and of <w, w>, then room for
    # every warp's sums of the window slots the stencil keeps out of its
    # registers
    partial = torch.empty((mem + 1 + mem * _THREADS // 32) * grid,
                          dtype=b.dtype, device=b.device)
    st = torch.zeros(_TR_NST, dtype=torch.int32, device=b.device)
    bufs = (V.data_ptr(), P.data_ptr(), x.data_ptr(), partial.data_ptr(),
            sc.data_ptr(), st.data_ptr(), n, grid, mem, mP)
    _run(trunc_dia_fused, b, f"ktt_trunc_dia_init_{pair[:3]}",
         (b.data_ptr(),) + bufs, f"ktt_trunc_dia_iterate_{pair}",
         (pd.data_ptr(), offsets.data_ptr(), pd.shape[0],
          *_tensor_span(offsets, n)[:2], w.data_ptr()) + bufs
         + (int(diom),), st, itmax)
    return x, st[_IT], sc[_TR_RNORM], st[_STATUS]


trunc_dia_fused.launches = 0


def _bi_fused(wrapper, kind, pd, pd_adj, offsets, offsets_adj, b, c, atol,
              rtol, itmax, nvec, nsc, nst, flag):
    """The buffers and launches shared by the BiLQ, QMR and BiLQR kernels
    (``csrc/bilanczos.cuh``): the work rows (v and u in three buffers
    each, then the method's own vectors), the block partials (doubles),
    the scalars and the flags; the stencil also takes the interiors of
    A's and Aᴴ's offsets, read on the host once per solve (kept on the
    offsets tensors).
    Returns (work, sc, st)."""
    pair = _pair_adjoint(kind.upper(), b, pd, pd_adj, offsets_adj)
    n, grid = b.shape[0], _grid(b)
    spans = (*_tensor_span(offsets, n)[:2],
             *_tensor_span(offsets_adj, n)[:2])
    sc = _host_scalars(nsc, b, {0: atol, 1: rtol})
    # the init launch writes every row an iteration reads before it does
    work = torch.empty((nvec, n), dtype=b.dtype, device=b.device)
    partial = torch.empty((_BI_NPART, grid), dtype=torch.float64,
                          device=b.device)
    st = torch.zeros(nst, dtype=torch.int32, device=b.device)
    bufs = (work.data_ptr(), partial.data_ptr(), sc.data_ptr(),
            st.data_ptr(), n, grid)
    _run(wrapper, b, f"ktt_{kind}_dia_init_{pair[:3]}",
         (b.data_ptr(), c.data_ptr()) + bufs,
         f"ktt_{kind}_dia_iterate_{pair}",
         (pd.data_ptr(), offsets.data_ptr(), pd.shape[0], pd_adj.data_ptr(),
          offsets_adj.data_ptr(), pd_adj.shape[0]) + spans + bufs
         + (int(flag),), st, itmax)
    _finish(wrapper, f"ktt_{kind}_dia_finish_{pair[:3]}", b,
            (work.data_ptr(), sc.data_ptr(), st.data_ptr(), n, grid))
    return work, sc, st


def bilq_dia_fused(pd, pd_adj, offsets, offsets_adj, b, atol, rtol, itmax,
                   transfer_to_bicg=True):
    """Full BiLQ solve of A x = b for a DIA matrix, shadow c = b.

    ``pd_adj`` and ``offsets_adj`` are Aᴴ's aligned diagonals and offsets
    (``DIAOperator.aligned_adjoint``).  With ``transfer_to_bicg`` the
    solve moves x to the BiCG point when that point's test stops it (one
    finishing launch).  Returns (x, niter, rnorm, status_code) as tensors
    on b's device; the codes add 29 (bᴴc = 0), 35 (the LQ point solved),
    36 (the BiCG point solved) and 38 (⟨uₖ₊₁, vₖ₊₁⟩ = 0).
    """
    _check(pd, offsets, b, None)
    if b.device.type == "cpu":
        return bilq_dia_fused_ref(pd, pd_adj, offsets, offsets_adj, b, atol,
                                  rtol, itmax, transfer_to_bicg)
    work, sc, st = _bi_fused(bilq_dia_fused, "bilq", pd, pd_adj, offsets,
                             offsets_adj, b, b, atol, rtol, itmax, 8,
                             _BQ_NSC, _BQ_NST, bool(transfer_to_bicg))
    return work[_BI_X].clone(), st[_IT], sc[_BQ_RNORM], st[_STATUS]


bilq_dia_fused.launches = 0


def qmr_dia_fused(pd, pd_adj, offsets, offsets_adj, b, atol, rtol, itmax):
    """Full QMR solve of A x = b for a DIA matrix, shadow c = b.

    Each iteration's direction and x update runs in the next iteration's
    launch (it needs βₖ₊₁), and one finishing launch applies the last.
    Returns (x, niter, rnorm, status_code) as tensors on b's device, with
    the codes of ``bilq_dia_fused`` but 1 for solved."""
    _check(pd, offsets, b, None)
    if b.device.type == "cpu":
        return qmr_dia_fused_ref(pd, pd_adj, offsets, offsets_adj, b, atol,
                                 rtol, itmax)
    work, sc, st = _bi_fused(qmr_dia_fused, "qmr", pd, pd_adj, offsets,
                             offsets_adj, b, b, atol, rtol, itmax, 9,
                             _QM_NSC, _QM_NST, 0)
    return work[_BI_X].clone(), st[_IT], sc[_QM_RNORM], st[_STATUS]


qmr_dia_fused.launches = 0


def bilqr_dia_fused(pd, pd_adj, offsets, offsets_adj, b, c, atol, rtol,
                    itmax, transfer_to_bicg=True):
    """Full BiLQR solve of A x = b and Aᴴ y = c for a DIA matrix.

    Returns (x, y, niter, rnorm, snorm, status_code, flags) as tensors on
    b's device, flags = [lq_tol, lq_mach, cg_tol, cg_mach, qr_tol,
    qr_mach, solved_primal, solved_dual, breakdown]; the codes are 15
    (both solved), 2, 29 and 38.
    """
    _check(pd, offsets, b, None)
    _check(pd, offsets, c, None)
    if b.device.type == "cpu":
        return bilqr_dia_fused_ref(pd, pd_adj, offsets, offsets_adj, b, c,
                                   atol, rtol, itmax, transfer_to_bicg)
    work, sc, st = _bi_fused(bilqr_dia_fused, "bilqr", pd, pd_adj, offsets,
                             offsets_adj, b, c, atol, rtol, itmax, 11,
                             _BR_NSC, _BR_NST, bool(transfer_to_bicg))
    return (work[_BI_X].clone(), work[_BI_X + 1].clone(), st[_IT],
            sc[_BR_RNORM], sc[_BR_RNORM + 1], st[_STATUS],
            st[list(_BR_FLAGS)])


bilqr_dia_fused.launches = 0


def _ssy_fused(wrapper, kind, pd, pd_adj, offsets, offsets_adj, b, c, atol,
               rtol, itmax, nrows, nsc, nst, flag, finish, scalars=None):
    """The buffers and launches shared by the USYMLQ, USYMQR, TriLQR,
    USYMLQR, TriCG and TriMR kernels (``csrc/ssy.cuh``): the work rows (v
    and u in three buffers each, then the method's own vectors), the
    block partials, the scalars (``scalars``: the method's own host
    values, by slot) and the ints with their staging copies; the stencil
    also takes the interiors of A's and Aᴴ's offsets, read on the host
    once per solve (kept on the offsets tensors).  Returns (work, sc,
    st)."""
    pair = _pair_adjoint(kind.upper(), b, pd, pd_adj, offsets_adj)
    n, grid = b.shape[0], _grid(b)
    spans = (*_tensor_span(offsets, n)[:2],
             *_tensor_span(offsets_adj, n)[:2])
    sc = _host_scalars(nsc, b, {0: atol, 1: rtol, **(scalars or {})})
    # the init launch writes every row and every state slot
    work = torch.empty((nrows, n), dtype=b.dtype, device=b.device)
    partial = torch.empty((_SSY_NPART, grid), dtype=b.dtype, device=b.device)
    st = torch.zeros(nst, dtype=torch.int32, device=b.device)
    bufs = (work.data_ptr(), partial.data_ptr(), sc.data_ptr(),
            st.data_ptr(), n, grid)
    _run(wrapper, b, f"ktt_{kind}_dia_init_{pair[:3]}",
         (b.data_ptr(), c.data_ptr()) + bufs + (int(flag),),
         f"ktt_{kind}_dia_iterate_{pair}",
         (pd.data_ptr(), offsets.data_ptr(), pd.shape[0], pd_adj.data_ptr(),
          offsets_adj.data_ptr(), pd_adj.shape[0]) + spans + bufs
         + (int(flag),), st, itmax)
    if finish:
        _finish(wrapper, f"ktt_{kind}_dia_finish_{pair[:3]}", b,
                (work.data_ptr(), sc.data_ptr(), st.data_ptr(), n, grid))
    return work, sc, st


def _check_pair(pd, offsets, b, c):
    _check(pd, offsets, b, None)
    _check(pd, offsets, c, None)


def usymlq_dia_fused(pd, pd_adj, offsets, offsets_adj, b, c, atol, rtol,
                     itmax, transfer_to_usymcg=True):
    """Full USYMLQ solve of A x = b for a DIA matrix, with c the vector
    that starts the second SSY basis.

    ``pd_adj`` and ``offsets_adj`` are Aᴴ's aligned diagonals and offsets
    (``DIAOperator.aligned_adjoint``).  With ``transfer_to_usymcg`` the
    solve moves x to the USYMCG point when that point's test stops it
    (one finishing launch).  Returns (x, niter, rnorm, status_code) as
    tensors on b's device; the codes are 2 (zero residual), 35 (the LQ
    point solved) and 36 (the USYMCG point solved).
    """
    _check_pair(pd, offsets, b, c)
    if b.device.type == "cpu":
        return usymlq_dia_fused_ref(pd, pd_adj, offsets, offsets_adj, b, c,
                                    atol, rtol, itmax, transfer_to_usymcg)
    work, sc, st = _ssy_fused(usymlq_dia_fused, "usymlq", pd, pd_adj,
                              offsets, offsets_adj, b, c, atol, rtol, itmax,
                              8, _UL_NSC, _UL_NST, bool(transfer_to_usymcg),
                              True)
    return work[_SSY_X].clone(), st[_IT], sc[_UL_RNORM], st[_STATUS]


usymlq_dia_fused.launches = 0


def usymqr_dia_fused(pd, pd_adj, offsets, offsets_adj, b, c, atol, rtol,
                     itmax):
    """Full USYMQR solve of min ‖b − Ax‖ for a DIA matrix.

    Each iteration's direction and x update runs in the next iteration's
    stencil launch (it needs αₖ and βₖ₊₁), and one finishing launch
    applies the last.  Returns (x, niter, rnorm, arnorm, status_code,
    inconsistent) as tensors on b's device; the codes are 1 (solved), 2
    (zero residual) and 8 (the system is probably inconsistent)."""
    _check_pair(pd, offsets, b, c)
    if b.device.type == "cpu":
        return usymqr_dia_fused_ref(pd, pd_adj, offsets, offsets_adj, b, c,
                                    atol, rtol, itmax)
    work, sc, st = _ssy_fused(usymqr_dia_fused, "usymqr", pd, pd_adj,
                              offsets, offsets_adj, b, c, atol, rtol, itmax,
                              9, _UQ_NSC, _UQ_NST, 0, True)
    return (work[_SSY_X].clone(), st[_IT], sc[_UQ_RNORM], sc[_UQ_ARNORM],
            st[_STATUS], st[_UQ_INCON])


usymqr_dia_fused.launches = 0


def trilqr_dia_fused(pd, pd_adj, offsets, offsets_adj, b, c, atol, rtol,
                     itmax, transfer_to_usymcg=True):
    """Full TriLQR solve of A x = b and Aᴴ y = c for a DIA matrix.

    Returns (x, y, niter, rnorm, snorm, status_code, flags) as tensors on
    b's device, flags = [lq_tol, lq_mach, cg_tol, cg_mach, qr_tol,
    qr_mach, solved_primal, solved_dual, inconsistent_dual]; the codes
    are 15 (both solved) and 2.
    """
    _check_pair(pd, offsets, b, c)
    if b.device.type == "cpu":
        return trilqr_dia_fused_ref(pd, pd_adj, offsets, offsets_adj, b, c,
                                    atol, rtol, itmax, transfer_to_usymcg)
    work, sc, st = _ssy_fused(trilqr_dia_fused, "trilqr", pd, pd_adj,
                              offsets, offsets_adj, b, c, atol, rtol, itmax,
                              11, _TL_NSC, _TL_NST, bool(transfer_to_usymcg),
                              True)
    return (work[_SSY_X].clone(), work[_SSY_X + 1].clone(), st[_IT],
            sc[_TL_RNORM], sc[_TL_RNORM + 1], st[_STATUS],
            st[list(_TL_FLAGS)])


trilqr_dia_fused.launches = 0


def usymlqr_dia_fused(pd, pd_adj, offsets, offsets_adj, b, c, atol, rtol,
                      itmax, ls=True, ln=True):
    """Full USYMLQR solve of [I A; Aᴴ 0][x; y] = [b; c] for a DIA matrix.

    ``ls`` and ``ln`` select the least-squares and least-norm sweeps (at
    least one).  Returns (x, y, niter, rnorm_ls, rnorm_ln, status_code,
    inconsistent) as tensors on b's device; the codes are 1 (solved) and
    8 (the least-squares sweep found the system inconsistent).
    """
    _check_pair(pd, offsets, b, c)
    if not (ls or ln):
        raise ValueError("ls and ln can't be both false")
    if b.device.type == "cpu":
        return usymlqr_dia_fused_ref(pd, pd_adj, offsets, offsets_adj, b, c,
                                     atol, rtol, itmax, ls, ln)
    work, sc, st = _ssy_fused(usymlqr_dia_fused, "usymlqr", pd, pd_adj,
                              offsets, offsets_adj, b, c, atol, rtol, itmax,
                              13, _ULR_NSC, _ULR_NST,
                              int(bool(ls)) | 2 * int(bool(ln)), True)
    return (work[_SSY_X].clone(), work[_SSY_X + 1].clone(), st[_IT],
            sc[_ULR_RNORM], sc[_ULR_RNORM + 1], st[_STATUS],
            st[_ULR_INCON])


usymlqr_dia_fused.launches = 0


def _gk_fused(wrapper, kind, pd, pd_adj, offsets, offsets_adj, b, params,
              itmax, nrows, nsc, nst, flag, window, finish=False):
    """The buffers and launches shared by the LSQR, LSMR, LSLQ, CRAIG,
    CRAIGMR and LNLQ kernels (``csrc/gk.cuh``): the work rows (u, v, x,
    then the method's own vectors), the block partials, the scalars (the
    host's parameters, the state and its staging copy, the error window)
    and the ints with their staging copy.  Returns (work, sc, st)."""
    _check_window(window)
    pair = _pair_adjoint(kind.upper(), b, pd, pd_adj, offsets_adj)
    n, grid = b.shape[0], _grid(b)
    sc = _host_scalars(nsc + int(window), b, dict(enumerate(params)))
    # the init launches write every row and every state slot
    work = torch.empty((nrows, n), dtype=b.dtype, device=b.device)
    partial = torch.empty((_GK_NPART, grid), dtype=b.dtype, device=b.device)
    st = torch.zeros(nst, dtype=torch.int32, device=b.device)
    bufs = (work.data_ptr(), partial.data_ptr(), sc.data_ptr(),
            st.data_ptr(), n, grid, int(flag), int(window))
    adj = (pd_adj.data_ptr(), offsets_adj.data_ptr(), pd_adj.shape[0])
    _run(wrapper, b, f"ktt_{kind}_dia_init_{pair}",
         adj + (b.data_ptr(),) + bufs, f"ktt_{kind}_dia_iterate_{pair}",
         (pd.data_ptr(), offsets.data_ptr(), pd.shape[0]) + adj + bufs, st,
         itmax)
    if finish:
        _finish(wrapper, f"ktt_{kind}_dia_finish_{pair[:3]}", b,
                (work.data_ptr(), sc.data_ptr(), st.data_ptr(), n, grid,
                 int(flag)))
    return work, sc, st


def lsqr_dia_fused(pd, pd_adj, offsets, offsets_adj, b, lam, axtol, btol,
                   atol, rtol, etol, conlim, itmax, window=5):
    """Full LSQR solve of min ‖b − Ax‖ (+ λ) for a DIA matrix.

    ``pd_adj`` and ``offsets_adj`` are Aᴴ's aligned diagonals and offsets
    (``DIAOperator.aligned_adjoint``); ``window`` is the length of the
    etol error window.  Returns (x, niter, rnorm, arnorm, status_code,
    zero_resid) as tensors on b's device; the codes are those of
    ``_runtime`` (2, 11, 20-24).
    """
    _check(pd, offsets, b, None)
    if b.device.type == "cpu":
        return lsqr_dia_fused_ref(pd, pd_adj, offsets, offsets_adj, b, lam,
                                  axtol, btol, atol, rtol, etol, conlim,
                                  itmax, window)
    work, sc, st = _gk_fused(lsqr_dia_fused, "lsqr", pd, pd_adj, offsets,
                             offsets_adj, b, (lam, axtol, btol, atol, rtol,
                                              etol, conlim), itmax, 4,
                             _LQ_NSC, _LQ_NST, 0, window)
    return (work[_GK_X].clone(), st[_IT], sc[_LQ_RNORM], sc[_LQ_ARNORM],
            st[_STATUS], st[_GK_ZR])


lsqr_dia_fused.launches = 0


def lsmr_dia_fused(pd, pd_adj, offsets, offsets_adj, b, lam, axtol, btol,
                   atol, rtol, etol, conlim, itmax, window=5):
    """Full LSMR solve of min ‖b − Ax‖ (+ λ) for a DIA matrix.  Returns
    (x, niter, rnorm, arnorm, acond, anorm, xnorm, status_code,
    zero_resid) as tensors on b's device."""
    _check(pd, offsets, b, None)
    if b.device.type == "cpu":
        return lsmr_dia_fused_ref(pd, pd_adj, offsets, offsets_adj, b, lam,
                                  axtol, btol, atol, rtol, etol, conlim,
                                  itmax, window)
    work, sc, st = _gk_fused(lsmr_dia_fused, "lsmr", pd, pd_adj, offsets,
                             offsets_adj, b, (lam, axtol, btol, atol, rtol,
                                              etol, conlim), itmax, 5,
                             _LM_NSC, _LM_NST, 0, window)
    return (work[_GK_X].clone(), st[_IT], *sc[list(_LM_NORMS)].unbind(),
            st[_STATUS], st[_GK_ZR])


lsmr_dia_fused.launches = 0


def lslq_dia_fused(pd, pd_adj, offsets, offsets_adj, b, lam, sigma, atol,
                   rtol, btol, etol, utol, conlim, itmax, use_sigma=False,
                   transfer_to_lsqr=False, window=5):
    """Full LSLQ solve of min ‖b − Ax‖ (+ λ) for a DIA matrix.

    ``use_sigma`` turns on the σ error bounds and their ``utol`` stop;
    ``transfer_to_lsqr`` moves x to the LSQR point after the loop (one
    finishing launch).  Returns (x, niter, rnorm, arnorm, status_code,
    zero_resid, complex_bnd) as tensors on b's device; the codes add 44
    and 45, the forward-error lower and upper bounds.
    """
    _check(pd, offsets, b, None)
    if b.device.type == "cpu":
        return lslq_dia_fused_ref(pd, pd_adj, offsets, offsets_adj, b, lam,
                                  sigma, atol, rtol, btol, etol, utol,
                                  conlim, itmax, use_sigma, transfer_to_lsqr,
                                  window)
    flag = int(bool(use_sigma)) | 2 * int(bool(transfer_to_lsqr))
    work, sc, st = _gk_fused(lslq_dia_fused, "lslq", pd, pd_adj, offsets,
                             offsets_adj, b, (lam, 0.0, btol, atol, rtol,
                                              etol, conlim, sigma, utol),
                             itmax, 4, _LL_NSC, _LL_NST, flag, window,
                             finish=bool(transfer_to_lsqr))
    return (work[_GK_X].clone(), st[_IT], sc[_LL_RNORM], sc[_LL_ARNORM],
            st[_STATUS], st[_GK_ZR], st[_LL_CBND])


lslq_dia_fused.launches = 0


def craig_dia_fused(pd, pd_adj, offsets, offsets_adj, b, lam, atol, rtol,
                    btol, conlim, itmax, use_lam=False):
    """Full CRAIG solve of min ‖x‖ subject to Ax = b (+ λ) for a DIA
    matrix (x = Aᴴy).

    ``pd_adj`` and ``offsets_adj`` are Aᴴ's aligned diagonals and offsets
    (``DIAOperator.aligned_adjoint``); ``use_lam`` turns on the λ
    rotations.  Returns (x, y, niter, rnorm, status_code) as tensors on
    b's device; the codes are 2, 11, 23, 39 (solved) and 41 (α = 0, the
    system may be inconsistent).
    """
    _check(pd, offsets, b, None)
    if b.device.type == "cpu":
        return craig_dia_fused_ref(pd, pd_adj, offsets, offsets_adj, b, lam,
                                   atol, rtol, btol, conlim, itmax, use_lam)
    # no error window: a ring of one slot, which nothing reads
    work, sc, st = _gk_fused(craig_dia_fused, "craig", pd, pd_adj, offsets,
                             offsets_adj, b, (lam, 0.0, btol, atol, rtol,
                                              0.0, conlim), itmax, 6,
                             _CRAIG_NSC, _CRAIG_NST, int(bool(use_lam)), 1)
    return (work[_GK_X].clone(), work[_LN_Y].clone(), st[_IT],
            sc[_CRAIG_RNORM], st[_STATUS])


craig_dia_fused.launches = 0


def craigmr_dia_fused(pd, pd_adj, offsets, offsets_adj, b, lam, atol, rtol,
                      itmax, use_lam=False):
    """Full CRAIGMR solve of min ‖x‖ subject to Ax = b (+ λ) for a DIA
    matrix.  Returns (x, y, niter, rnorm, arnorm, status_code) as tensors
    on b's device; the codes are 2, 20 (‖Aᴴr‖ small: inconsistent), 24
    and 40 (solved)."""
    _check(pd, offsets, b, None)
    if b.device.type == "cpu":
        return craigmr_dia_fused_ref(pd, pd_adj, offsets, offsets_adj, b,
                                     lam, atol, rtol, itmax, use_lam)
    work, sc, st = _gk_fused(craigmr_dia_fused, "craigmr", pd, pd_adj,
                             offsets, offsets_adj, b, (lam, 0.0, 0.0, atol,
                                                       rtol), itmax, 8,
                             _CMR_NSC, _CMR_NST, int(bool(use_lam)), 1)
    return (work[_GK_X].clone(), work[_LN_Y].clone(), st[_IT],
            sc[_CMR_RNORM], sc[_CMR_ARNORM], st[_STATUS])


craigmr_dia_fused.launches = 0


def lnlq_dia_fused(pd, pd_adj, offsets, offsets_adj, b, lam, atol, rtol,
                   itmax, use_lam=False, transfer_to_craig=True):
    """Full LNLQ solve of min ‖x‖ subject to Ax = b (+ λ) for a DIA
    matrix.  ``transfer_to_craig`` allows the CG-point stop and moves x
    and y to the CRAIG point after it (one finishing launch).  Returns
    (x, y, niter, rnorm, status_code) as tensors on b's device; the codes
    are 2, 42 (the LQ point) and 43 (the CRAIG point)."""
    _check(pd, offsets, b, None)
    if b.device.type == "cpu":
        return lnlq_dia_fused_ref(pd, pd_adj, offsets, offsets_adj, b, lam,
                                  atol, rtol, itmax, use_lam,
                                  transfer_to_craig)
    flag = int(bool(use_lam)) | 2 * int(bool(transfer_to_craig))
    work, sc, st = _gk_fused(lnlq_dia_fused, "lnlq", pd, pd_adj, offsets,
                             offsets_adj, b, (lam, 0.0, 0.0, atol, rtol),
                             itmax, 6, _LNLQ_NSC, _LNLQ_NST, flag, 1,
                             finish=bool(transfer_to_craig))
    return (work[_GK_X].clone(), work[_LN_Y].clone(), st[_IT],
            sc[_LNLQ_RNORM], st[_STATUS])


lnlq_dia_fused.launches = 0


def cgne_crmr_dia_fused(pd, pd_adj, offsets, offsets_adj, b, lam, atol,
                        rtol, itmax, variant="cgne"):
    """Full CGNE or CRMR (``variant``) solve of min ‖x‖ subject to Ax = b
    (+ λ) for a DIA matrix.  Returns (x, niter, rnorm, status_code) as
    tensors on b's device; the codes are 1, 2 and 32 (CGNE) or 33 (CRMR),
    "probably inconsistent"."""
    _check(pd, offsets, b, None)
    _check_variant(variant)
    if b.device.type == "cpu":
        return cgne_crmr_dia_fused_ref(pd, pd_adj, offsets, offsets_adj, b,
                                       lam, atol, rtol, itmax, variant)
    pair = _pair_adjoint("CGNE/CRMR", b, pd, pd_adj, offsets_adj)
    n, grid = b.shape[0], _grid(b)
    sc = _host_scalars(_NE_NSC, b, {0: lam, 1: atol, 2: rtol})
    # the init launches write every row and every state slot
    work = torch.empty((_NE_NROWS, n), dtype=b.dtype, device=b.device)
    partial = torch.empty((_NE_NPART, grid), dtype=b.dtype, device=b.device)
    st = torch.zeros(_NE_NST, dtype=torch.int32, device=b.device)
    bufs = (work.data_ptr(), partial.data_ptr(), sc.data_ptr(),
            st.data_ptr(), n, grid, int(variant == "cgne"))
    adj = (pd_adj.data_ptr(), offsets_adj.data_ptr(), pd_adj.shape[0])
    _run(cgne_crmr_dia_fused, b, f"ktt_cgne_crmr_dia_init_{pair}",
         adj + (b.data_ptr(),) + bufs, f"ktt_cgne_crmr_dia_iterate_{pair}",
         (pd.data_ptr(), offsets.data_ptr(), pd.shape[0]) + adj + bufs, st,
         itmax)
    return work[0].clone(), st[_IT], sc[_NE_RNORM], st[_STATUS]


cgne_crmr_dia_fused.launches = 0


def _nq_fused(wrapper, kind, pd, pd_adj, offsets, offsets_adj, b, lam, atol,
              rtol, itmax, nrows, npart):
    """The buffers and launches of the CGLS and CRLS kernels: the work rows
    (x first), the block partials, the scalars (λ, atol, rtol, then the
    state) and the ints.  Returns (x, niter, rnorm, arnorm, status)."""
    pair = _pair_adjoint(kind.upper(), b, pd, pd_adj, offsets_adj)
    n, grid = b.shape[0], _grid(b)
    sc = _host_scalars(_NQ_NSC, b, {0: lam, 1: atol, 2: rtol})
    # the init launches write every row read and every state slot
    work = torch.empty((nrows, n), dtype=b.dtype, device=b.device)
    partial = torch.empty((npart, grid), dtype=b.dtype, device=b.device)
    st = torch.zeros(_NQ_NST, dtype=torch.int32, device=b.device)
    bufs = (work.data_ptr(), partial.data_ptr(), sc.data_ptr(),
            st.data_ptr(), n, grid)
    a = (pd.data_ptr(), offsets.data_ptr(), pd.shape[0])
    adj = (pd_adj.data_ptr(), offsets_adj.data_ptr(), pd_adj.shape[0])
    # CRLS's start applies A as well as Aᴴ
    init = (a if kind == "crls" else ()) + adj + (b.data_ptr(),) + bufs
    _run(wrapper, b, f"ktt_{kind}_dia_init_{pair}", init,
         f"ktt_{kind}_dia_iterate_{pair}", a + adj + bufs, st, itmax)
    return (work[0].clone(), st[_IT], sc[_NQ_RNORM], sc[_NQ_ARNORM],
            st[_STATUS])


def cgls_dia_fused(pd, pd_adj, offsets, offsets_adj, b, lam, atol, rtol,
                   itmax):
    """Full CGLS solve of min ‖b − Ax‖² + λ‖x‖² for a DIA matrix.

    ``pd_adj`` and ``offsets_adj`` are Aᴴ's aligned diagonals and offsets
    (``DIAOperator.aligned_adjoint``).  Returns (x, niter, rnorm, arnorm,
    status_code) as tensors on b's device; the codes are 1 (‖Aᴴr − λx‖
    small enough) and 2 (b = 0)."""
    _check(pd, offsets, b, None)
    if b.device.type == "cpu":
        return cgls_dia_fused_ref(pd, pd_adj, offsets, offsets_adj, b, lam,
                                  atol, rtol, itmax)
    return _nq_fused(cgls_dia_fused, "cgls", pd, pd_adj, offsets,
                     offsets_adj, b, lam, atol, rtol, itmax, _GLS_NROWS,
                     _GLS_NPART)


cgls_dia_fused.launches = 0


def crls_dia_fused(pd, pd_adj, offsets, offsets_adj, b, lam, atol, rtol,
                   itmax):
    """Full CRLS solve of min ‖b − Ax‖² + λ‖x‖² for a DIA matrix.  Returns
    (x, niter, rnorm, arnorm, status_code) as ``cgls_dia_fused`` does;
    with λ, rnorm is √(‖r‖² + λ‖x‖²)."""
    _check(pd, offsets, b, None)
    if b.device.type == "cpu":
        return crls_dia_fused_ref(pd, pd_adj, offsets, offsets_adj, b, lam,
                                  atol, rtol, itmax)
    return _nq_fused(crls_dia_fused, "crls", pd, pd_adj, offsets,
                     offsets_adj, b, lam, atol, rtol, itmax, _RLS_NROWS,
                     _RLS_NPART)


crls_dia_fused.launches = 0


def cgls_lanczos_shift_dia_fused(pd, pd_adj, offsets, offsets_adj, b,
                                 shifts, atol, rtol, itmax):
    """Every regularised least-squares problem min ‖b − Ax‖² + λᵢ‖x‖²
    from one Lanczos stream on AᴴA, for a DIA matrix.  ``shifts`` (the
    λᵢ) is a 1-D tensor of b's dtype on b's device; any number of them.

    Returns (X (nshifts, n), niter, rnorms (nshifts,), status_code,
    indefinite (nshifts,)) as tensors on b's device.
    """
    _check(pd, offsets, b, None)
    if (shifts.dim() != 1 or shifts.dtype != b.dtype
            or shifts.device != b.device or shifts.shape[0] < 1):
        raise ValueError("shifts must be a non-empty vector of b's dtype "
                         "on b's device")
    if b.device.type == "cpu":
        return cgls_lanczos_shift_dia_fused_ref(pd, pd_adj, offsets,
                                                offsets_adj, b, shifts, atol,
                                                rtol, itmax)
    pair = _pair_adjoint("CGLS-Lanczos-shift", b, pd, pd_adj, offsets_adj)
    n, grid, ns = b.shape[0], _grid(b), shifts.shape[0]
    sc = _host_scalars(_LZS_NSC + _LZS_NBLK * ns, b, {0: atol, 1: rtol})
    sc[_LZS_NSC:_LZS_NSC + ns] = shifts
    # zeroed: the first iteration reads none of v_prev's buffer
    work = torch.zeros((_LZS_X + 2 * ns, n), dtype=b.dtype, device=b.device)
    partial = torch.empty((_LZS_NPART, grid), dtype=b.dtype,
                          device=b.device)
    st = torch.zeros(_LZS_NST + 3 * ns, dtype=torch.int32, device=b.device)
    bufs = (work.data_ptr(), partial.data_ptr(), sc.data_ptr(),
            st.data_ptr(), n, grid, ns)
    adj = (pd_adj.data_ptr(), offsets_adj.data_ptr(), pd_adj.shape[0])
    _run(cgls_lanczos_shift_dia_fused, b,
         f"ktt_cgls_lanczos_shift_dia_init_{pair}",
         adj + (b.data_ptr(),) + bufs,
         f"ktt_cgls_lanczos_shift_dia_iterate_{pair}",
         (pd.data_ptr(), offsets.data_ptr(), pd.shape[0]) + adj + bufs, st,
         itmax)
    rn = _LZS_NSC + _LZS_RNORM * ns
    idf = _LZS_NST + _LZS_INDEF * ns
    return (work[_LZS_X:_LZS_X + ns].clone(), st[_IT],
            sc[rn:rn + ns].clone(), st[_STATUS], st[idf:idf + ns].clone())


cgls_lanczos_shift_dia_fused.launches = 0


def tricg_dia_fused(pd, pd_adj, offsets, offsets_adj, b, c, tau, nu, atol,
                    rtol, itmax):
    """Full TriCG solve of [τI A; Aᴴ νI][x; y] = [b; c] for a square DIA
    matrix.  Returns (x, y, niter, rnorm, status_code) as tensors on b's
    device; the codes are 1 (solved), 2 (b = c = 0) and 28 (both SSY
    norms at most eps^¾: "inconsistent linear system")."""
    _check_pair(pd, offsets, b, c)
    if b.device.type == "cpu":
        return tricg_dia_fused_ref(pd, pd_adj, offsets, offsets_adj, b, c,
                                   tau, nu, atol, rtol, itmax)
    work, sc, st = _ssy_fused(tricg_dia_fused, "tricg", pd, pd_adj, offsets,
                              offsets_adj, b, c, atol, rtol, itmax,
                              _TCG_NROWS, _TCG_NSC, _TCG_NST, 0, False,
                              scalars={_TCG_TAU: tau, _TCG_TAU + 1: nu})
    return (work[_SSY_X].clone(), work[_SSY_X + 1].clone(), st[_IT],
            sc[_TCG_RNORM], st[_STATUS])


tricg_dia_fused.launches = 0


def trimr_dia_fused(pd, pd_adj, offsets, offsets_adj, b, c, tau, nu, atol,
                    rtol, itmax):
    """Full TriMR solve of [τI A; Aᴴ νI][x; y] = [b; c] for a square DIA
    matrix.  Returns (x, y, niter, rnorm, status_code) as tensors on b's
    device; the codes are those of ``tricg_dia_fused``."""
    _check_pair(pd, offsets, b, c)
    if b.device.type == "cpu":
        return trimr_dia_fused_ref(pd, pd_adj, offsets, offsets_adj, b, c,
                                   tau, nu, atol, rtol, itmax)
    work, sc, st = _ssy_fused(trimr_dia_fused, "trimr", pd, pd_adj, offsets,
                              offsets_adj, b, c, atol, rtol, itmax,
                              _TMR_NROWS, _TMR_NSC, _TMR_NST, 0, False,
                              scalars={_TMR_TAU: tau, _TMR_TAU + 1: nu})
    return (work[_SSY_X].clone(), work[_SSY_X + 1].clone(), st[_IT],
            sc[_TMR_RNORM], st[_STATUS])


trimr_dia_fused.launches = 0


def gpmr_dia_fused(pd_a, pd_b, offsets_a, offsets_b, b, c, lam, mu, atol,
                   rtol, itmax, mem=20):
    """Full GPMR solve of [λI A; B μI][x; y] = [b; c] for two square DIA
    matrices (A on its aligned diagonals ``pd_a``, B on ``pd_b``), with a
    basis of mem ≤ 64 slots.  Returns (x, y, niter, rnorm, status_code,
    inconsistent) as tensors on b's device; the codes are 1 (solved), 2
    (b = c = 0), 7 (breakdown) and 100 (k reached mem), and the flag is 1
    where the back substitution met a pivot of modulus at most eps^¾."""
    _check_pair(pd_a, offsets_a, b, c)
    _check(pd_b, offsets_b, b, None)
    if not 2 <= mem <= _GP_MAXMEM:
        raise ValueError(f"mem must lie in [2, {_GP_MAXMEM}], got {mem}")
    if b.device.type == "cpu":
        return gpmr_dia_fused_ref(pd_a, pd_b, offsets_a, offsets_b, b, c,
                                  lam, mu, atol, rtol, itmax, mem)
    pair = _pair("GPMR", b, pd_a)
    if pd_b.dtype != pd_a.dtype:
        raise ValueError("pd_b must have pd_a's dtype")
    n, grid = b.shape[0], _grid(b)
    nsc, nrows, npart = _gp_layout(mem)
    sc = _host_scalars(nsc, b, {0: atol, 1: rtol, 2: lam, 3: mu})
    # the init launch writes V₀, U₀ and every state slot; each later row
    # is written before it is read
    work = torch.empty((nrows, n), dtype=b.dtype, device=b.device)
    partial = torch.empty((npart, grid), dtype=b.dtype, device=b.device)
    st = torch.zeros(_GP_NST, dtype=torch.int32, device=b.device)
    bufs = (work.data_ptr(), partial.data_ptr(), sc.data_ptr(),
            st.data_ptr(), n, grid, int(mem))
    _run(gpmr_dia_fused, b, f"ktt_gpmr_dia_init_{pair[:3]}",
         (b.data_ptr(), c.data_ptr()) + bufs, f"ktt_gpmr_dia_iterate_{pair}",
         (pd_a.data_ptr(), offsets_a.data_ptr(), pd_a.shape[0],
          pd_b.data_ptr(), offsets_b.data_ptr(), pd_b.shape[0]) + bufs,
         st, itmax)
    _finish(gpmr_dia_fused, f"ktt_gpmr_dia_finish_{pair[:3]}", b,
            (work.data_ptr(), sc.data_ptr(), st.data_ptr(), n, grid,
             int(mem)))
    return (work[2 * mem + 4].clone(), work[2 * mem + 5].clone(), st[_IT],
            sc[_GP_RNORM], st[_STATUS], st[_GP_INCON])


gpmr_dia_fused.launches = 0


def block_minres_dia_fused(pd, offsets, B, atol, rtol, itmax):
    """Full block-MINRES solve of AX = B for a Hermitian DIA matrix and B
    of shape (n, p), 1 ≤ p ≤ 8.  Returns (X (n, p), niter, rnorm,
    status_code) as tensors on B's device; the codes are 1 (solved) and 2
    (B = 0).  B should have full column rank: a rank-deficient block
    keeps CholQR's small pivots (the solver's route sends it to the
    general core)."""
    if B.dim() != 2 or not 1 <= B.shape[1] <= _BM_MAXP:
        raise ValueError(f"B must have shape (n, p), 1 <= p <= {_BM_MAXP}; "
                         f"got {tuple(B.shape)}")
    # the panels as p rows of n (pallas_fused.py:2695), which the init
    # launches copy into V's first slot beside the zeroed others
    Bt = B.T.contiguous()
    _check(pd, offsets, Bt[0], None)
    if B.device.type == "cpu":
        return block_minres_dia_fused_ref(pd, offsets, B, atol, rtol, itmax)
    pair = _pair("BLOCK-MINRES", B, pd)
    n, p = B.shape
    grid = _grid(Bt[0])
    nsc, nrows, npart = _bm_layout(p)
    sc = _host_scalars(nsc, B, {0: atol, 1: rtol})
    work = torch.empty((nrows, n), dtype=B.dtype, device=B.device)
    partial = torch.empty((npart, grid), dtype=B.dtype, device=B.device)
    st = torch.zeros(_BM_NST, dtype=torch.int32, device=B.device)
    bufs = (work.data_ptr(), partial.data_ptr(), sc.data_ptr(),
            st.data_ptr(), n, grid, p)
    _run(block_minres_dia_fused, B, f"ktt_block_minres_dia_init_{pair[:3]}",
         (Bt.data_ptr(),) + bufs, f"ktt_block_minres_dia_iterate_{pair}",
         (pd.data_ptr(), offsets.data_ptr(), pd.shape[0]) + bufs, st, itmax)
    return (work[5 * p:6 * p].T.contiguous(), st[_IT], sc[_BM_RNORM],
            st[_STATUS])


block_minres_dia_fused.launches = 0


def block_gmres_dia_fused(pd, offsets, B, atol, rtol, itmax, mem=16,
                          basis_dtype=None):
    """Full restarted block-GMRES(mem) solve of AX = B for a DIA matrix and
    B of shape (n, p), 1 ≤ p ≤ 8, mem ≥ 2, mem·p ≤ 128.  ``basis_dtype``
    (bf16, or B's own) stores the basis in that type and confirms every
    stop on the true residual.  Returns (X (n, p), niter, rnorm,
    status_code, inconsistent, npass) as tensors on B's device; the codes
    are 1 (solved), 2 (B = 0), 7 (breakdown) and 100 (itmax).  B should
    have full column rank (the solver's route sends a rank-deficient
    block to the general core)."""
    if B.dim() != 2 or not 1 <= B.shape[1] <= _BM_MAXP:
        raise ValueError(f"B must have shape (n, p), 1 <= p <= {_BM_MAXP}; "
                         f"got {tuple(B.shape)}")
    n, p = B.shape
    if mem < 2 or mem * p > _BG_MAXMP:
        raise ValueError(f"need mem >= 2 and mem * p <= {_BG_MAXMP}; got "
                         f"mem={mem}, p={p}")
    Bt = B.T.contiguous()
    _check(pd, offsets, Bt[0], None)
    if B.device.type == "cpu":
        return block_gmres_dia_fused_ref(pd, offsets, B, atol, rtol, itmax,
                                         mem, basis_dtype)
    pair = _pair("BLOCK-GMRES", B, pd)
    BT = B.dtype if basis_dtype is None else basis_dtype
    if BT not in (B.dtype, torch.bfloat16):
        raise ValueError(f"no BLOCK-GMRES kernel for a {BT} basis")
    suffix = f"{pair}_{_BASIS[BT]}"
    grid = max(1, -(-n // (_THREADS * _BG_ROWS)))
    nsc, npart = _bg_layout(mem, p)
    btol = float(torch.finfo(B.dtype).eps) ** 0.75
    sc = _host_scalars(nsc, B, {0: atol, 1: rtol, 2: btol})
    V = torch.zeros(((mem + 1) * p, n), dtype=BT, device=B.device)
    W = torch.zeros((p, n), dtype=B.dtype, device=B.device)
    X = torch.zeros((p, n), dtype=B.dtype, device=B.device)
    partial = torch.zeros((npart, grid), dtype=B.dtype, device=B.device)
    st = torch.zeros(_BG_NST, dtype=torch.int32, device=B.device)
    head = (pd.data_ptr(), offsets.data_ptr(), pd.shape[0], Bt.data_ptr(),
            V.data_ptr(), W.data_ptr(), X.data_ptr(), partial.data_ptr(),
            sc.data_ptr(), st.data_ptr(), n, grid, p, mem)
    _run(block_gmres_dia_fused, B, f"ktt_block_gmres_dia_init_{suffix}",
         head + (itmax,), f"ktt_block_gmres_dia_iterate_{suffix}",
         head + (int(basis_dtype is not None),), st, itmax)
    return (X.T.contiguous(), st[_IT], sc[_BG_RNORM], st[_STATUS],
            st[_BG_INCONS], st[_BG_NPASS])


block_gmres_dia_fused.launches = 0
