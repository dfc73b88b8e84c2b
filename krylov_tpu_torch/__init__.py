"""krylov_tpu_torch — the PyTorch/CUDA port of ``krylov_tpu``.

A second package beside the JAX one, ported slice by slice.  It carries
``cg`` (with M = I, Jacobi or a Chebyshev polynomial), ``cr``, ``car``,
``minres``, ``cg_lanczos``, ``cg_lanczos_shift``, ``symmlq``,
``minres_qlp``, ``minares`` and, for non-symmetric systems, ``gmres``,
``fgmres``, ``fom``, ``diom``, ``dqgmres``, ``bicgstab``, ``cgs``,
``bilq``, ``qmr`` and ``bilqr`` (Ax = b and Aᴴy = c), and, on the
Saunders–Simon–Yip process, ``usymlq``, ``usymqr``, ``trilqr`` and
``usymlqr`` (the saddle point [I A; Aᴴ 0]), and, on Golub–Kahan
bidiagonalisation, ``lsqr``, ``lsmr`` and ``lslq`` for min ‖b − Ax‖
and ``craig``, ``craigmr`` and ``lnlq`` for min ‖x‖ subject to Ax = b,
with ``cgne`` and ``crmr`` (CG and CR on AAᴴ) for the same problem,
and ``cgls``, ``crls`` and ``cgls_lanczos_shift`` (CG and CR on AᴴA)
for min ‖b − Ax‖² + λ‖x‖², ``tricg`` and ``trimr`` for the symmetric
quasi-definite [τI A; Aᴴ νI][x; y] = [b; c], ``gpmr`` for the
partitioned [λI A; B μI][x; y] = [b; c] with two operators, and
``block_minres`` and ``block_gmres`` for AX = B with several right-hand
sides, on DIA stencil, block-ELL (``BELLOperator``), CSR, dense and
matrix-free operators (with their adjoints), and on general sparse
matrices through ``HybridOperator`` (a CSRMatrix on the card is analysed
once into dense diagonals and a SELL-C-128 remainder), through
hand-written CUDA kernels for Hopper (``csrc/``): a DIA SpMV (plain and
in a padded, chainable layout), the block-ELL SpMV and SpMM, the SELL
SpMV, and a whole-solve kernel for each solver, each with a plain
PyTorch version used on the CPU; the
twelve Krylov processes (``arnoldi``, ``golub_kahan``, ...,
``block_montoison_orban``); and the generic
``krylov_solve`` / ``krylov_workspace`` interface over those methods.
Constructors put data on the card unless the caller passes
``device="cpu"``; solvers run on the device of their inputs, and put
inputs that are not tensors on the card.
"""

from .operators import (
    AbstractLinearOperator,
    AdjointOperator,
    BELLOperator,
    CSROperator,
    DIAOperator,
    DiagonalOperator,
    FunctionOperator,
    HybridOperator,
    IdentityOperator,
    MatrixOperator,
    as_operator,
    precond_apply,
)
from .ops.cuda_dia import (dia_align_adjoint, dia_pad_layout,
                           dia_spmv_aligned, dia_spmv_padded,
                           dia_unpad_layout)
from .ops.cuda_fused import (bicgstab_dia_fused, bilq_dia_fused,
                             bilqr_dia_fused, block_gmres_dia_fused,
                             block_minres_dia_fused,
                             car_dia_fused,
                             cg_cheby_dia_fused, cg_dia_fused,
                             cg_lanczos_dia_fused,
                             cg_lanczos_shift_dia_fused, cgls_dia_fused,
                             cgls_lanczos_shift_dia_fused,
                             cgne_crmr_dia_fused, cgs_dia_fused,
                             cr_dia_fused, craig_dia_fused,
                             craigmr_dia_fused, crls_dia_fused,
                             fom_dia_fused, gmres_dia_fused, gpmr_dia_fused,
                             lnlq_dia_fused,
                             lslq_dia_fused, lsmr_dia_fused, lsqr_dia_fused,
                             minares_dia_fused, minres_dia_fused,
                             minres_qlp_dia_fused, qmr_dia_fused,
                             symmlq_dia_fused, tricg_dia_fused,
                             trilqr_dia_fused, trimr_dia_fused,
                             trunc_dia_fused,
                             usymlq_dia_fused, usymlqr_dia_fused,
                             usymqr_dia_fused)
from .ops.cuda_spmv import (BELLMatrix, ELLMatrix, bell_from_csr,
                            bell_from_dense_blocks, bell_spmm, bell_spmv,
                            ell_from_csr, ell_spmv)
from .ops.cuda_sell import (SELLBucketed, SELLMatrix, sell_bucketed_from_csr,
                            sell_from_csr, sell_spmv)
from .ops.dia import (DIAMatrix, convdiff_dia, dia_from_scipy, dia_spmm,
                      poisson_dia)
from .ops.hybrid import HybridMatrix, hybrid_from_csr, split_diagonals
from .ops.kops import (kdot, kdotr, kdotr2, knorm, knorm_elliptic,
                       roots_quadratic, sym_givens, to_boundary)
from .ops.sparse import CSRMatrix, csr_from_coo, csr_from_dense, spmm, spmv
from .precond import ChebyshevPreconditioner, power_bound
from .processes import (arnoldi, block_arnoldi, block_golub_kahan,
                        block_hermitian_lanczos, block_montoison_orban,
                        block_nonhermitian_lanczos, block_saunders_simon_yip,
                        golub_kahan, hermitian_lanczos, montoison_orban,
                        nonhermitian_lanczos, saunders_simon_yip)
from .solvers.bicgstab import bicgstab, cgs
from .solvers.bilq import bilq, bilqr, qmr
from .solvers.block import block_gmres, block_minres
from .solvers.cg import cg
from .solvers.cg_lanczos import cg_lanczos, cg_lanczos_shift
from .solvers.cgls import cgls, cgls_lanczos_shift, crls
from .solvers.cgne import cgne, crmr
from .solvers.cr import car, cr
from .solvers.craig import craig, craigmr, lnlq
from .solvers.fom import diom, dqgmres, fom
from .solvers.gmres import fgmres, gmres
from .solvers.gpmr import gpmr
from .solvers.lslq import lslq
from .solvers.lsmr import lsmr
from .solvers.lsqr import lsqr
from .solvers.minares import minares
from .solvers.minres import minres
from .solvers.minres_qlp import minres_qlp
from .solvers.symmlq import symmlq
from .solvers.tricg import tricg, trimr
from .solvers.usymlq import trilqr, usymlq, usymlqr, usymqr
from .stats import (AdjointStats, LanczosShiftStats, LanczosStats,
                    LNLQStats, LSLQStats, LsmrStats, SimpleStats,
                    SymmlqStats)

# Generic interface + workspaces.
from . import workspaces as _workspaces
from .interface import (KRYLOV_METHODS, krylov_solve, krylov_solve_inplace,
                        krylov_workspace)
from .show import kstdout, show_stats, show_workspace
from .workspaces import (METHOD_TABLE, Aprod_count, Atprod_count,
                         BlockKrylovWorkspace, KrylovConstructor,
                         KrylovWorkspace, elapsed_time, issolved,
                         issolved_dual, issolved_primal, iteration_count,
                         results, solution, statistics, warm_start)

# each CUDA kernel wrapper by the name its launch count goes under
KERNELS = {"dia_spmv": dia_spmv_aligned,
           "dia_spmv_padded": dia_spmv_padded,
           "cg_dia": cg_dia_fused,
           "cg_cheby_dia": cg_cheby_dia_fused,
           "cr_dia": cr_dia_fused,
           "car_dia": car_dia_fused,
           "minres_dia": minres_dia_fused,
           "cg_lanczos_dia": cg_lanczos_dia_fused,
           "cg_lanczos_shift_dia": cg_lanczos_shift_dia_fused,
           "symmlq_dia": symmlq_dia_fused,
           "minres_qlp_dia": minres_qlp_dia_fused,
           "minares_dia": minares_dia_fused,
           "gmres_dia": gmres_dia_fused,
           "fom_dia": fom_dia_fused,
           "bicgstab_dia": bicgstab_dia_fused,
           "cgs_dia": cgs_dia_fused,
           "trunc_dia": trunc_dia_fused,
           "bilq_dia": bilq_dia_fused,
           "qmr_dia": qmr_dia_fused,
           "bilqr_dia": bilqr_dia_fused,
           "usymlq_dia": usymlq_dia_fused,
           "usymqr_dia": usymqr_dia_fused,
           "trilqr_dia": trilqr_dia_fused,
           "usymlqr_dia": usymlqr_dia_fused,
           "lsqr_dia": lsqr_dia_fused,
           "lsmr_dia": lsmr_dia_fused,
           "lslq_dia": lslq_dia_fused,
           "craig_dia": craig_dia_fused,
           "craigmr_dia": craigmr_dia_fused,
           "lnlq_dia": lnlq_dia_fused,
           "cgne_crmr_dia": cgne_crmr_dia_fused,
           "cgls_dia": cgls_dia_fused,
           "crls_dia": crls_dia_fused,
           "cgls_lanczos_shift_dia": cgls_lanczos_shift_dia_fused,
           "tricg_dia": tricg_dia_fused,
           "trimr_dia": trimr_dia_fused,
           "gpmr_dia": gpmr_dia_fused,
           "block_minres_dia": block_minres_dia_fused,
           "block_gmres_dia": block_gmres_dia_fused,
           "bell_spmv": bell_spmv,
           "bell_spmm": bell_spmm,
           "sell_spmv": sell_spmv}


def kernel_launches():
    """Launch counts of the CUDA kernel wrappers, by kernel."""
    return {name: w.launches for name, w in KERNELS.items()}


# The generated per-method workspace classes (CgWorkspace,
# MinresWorkspace, ...), as the JAX package exports them (reference
# src/krylov_workspaces.jl).
for _method in METHOD_TABLE:
    _cname = "".join(_w.capitalize() for _w in _method.split("_")) \
        + "Workspace"
    globals()[_cname] = getattr(_workspaces, _cname)
del _method, _cname

__version__ = "0.1.0"
