"""krylov_tpu_torch — the PyTorch/CUDA port of ``krylov_tpu``.

A second package beside the JAX one, ported slice by slice.  It carries
``cg`` (with M = I, Jacobi or a Chebyshev polynomial), ``cr``, ``car``
and ``minres`` on DIA stencil operators, through hand-written CUDA
kernels for Hopper (``csrc/``): a DIA SpMV and a whole-solve kernel for
each solver, each with a plain PyTorch version used on the CPU.
Constructors put data on the card unless the caller passes
``device="cpu"``; solvers run on the device of their inputs, and put
inputs that are not tensors on the card.
"""

from .operators import (
    AbstractLinearOperator,
    DIAOperator,
    DiagonalOperator,
    FunctionOperator,
    IdentityOperator,
    MatrixOperator,
    as_operator,
    precond_apply,
)
from .ops.cuda_dia import dia_spmv_aligned
from .ops.cuda_fused import (car_dia_fused, cg_cheby_dia_fused,
                             cg_dia_fused, cr_dia_fused, minres_dia_fused)
from .ops.dia import DIAMatrix, convdiff_dia, dia_from_scipy, poisson_dia
from .precond import ChebyshevPreconditioner, power_bound
from .solvers.cg import cg
from .solvers.cr import car, cr
from .solvers.minres import minres
from .stats import SimpleStats


def kernel_launches():
    """Launch counts of the CUDA kernel wrappers, by kernel."""
    return {"dia_spmv": dia_spmv_aligned.launches,
            "cg_dia": cg_dia_fused.launches,
            "cg_cheby_dia": cg_cheby_dia_fused.launches,
            "cr_dia": cr_dia_fused.launches,
            "car_dia": car_dia_fused.launches,
            "minres_dia": minres_dia_fused.launches}
