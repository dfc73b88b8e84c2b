"""Carry operator state across from the JAX package.

The port never imports ``krylov_tpu``; a caller holding a
``krylov_tpu`` ``DIAMatrix`` D passes its fields as numpy data:
``dia_from_numpy(np.asarray(D.data), D.offsets, D.shape)``, and both
packages then solve the same system.  A ``krylov_tpu`` ``CSRMatrix`` C
goes across likewise: ``csr_from_numpy(np.asarray(C.data),
np.asarray(C.indices), np.asarray(C.indptr), np.asarray(C.rows),
C.shape)``; its ``BELLMatrix`` B as ``bell_from_numpy(np.asarray(B.data),
np.asarray(B.indices), B.shape, B.bs)``, its ``ELLMatrix`` E as
``ell_from_numpy(np.asarray(E.data), np.asarray(E.indices), E.shape)`` and
its ``SELLMatrix`` S as ``sell_from_numpy(np.asarray(S.data),
np.asarray(S.idx), np.asarray(S.slice_of), np.asarray(S.chunk_of),
S.shape, S.nnz, S.covered)``.
"""

import numpy as np
import torch

from .ops.cuda_sell import SELLMatrix
from .ops.cuda_spmv import BELLMatrix, ELLMatrix
from .ops.dia import DIAMatrix, resolve_device
from .ops.sparse import CSRMatrix


def dia_from_numpy(data, offsets, shape, device="cuda"):
    """The port's DIAMatrix with the same diagonals (column-indexed, as in
    SciPy: data[d, j] holds A[j - k_d, j])."""
    return DIAMatrix(np.array(data), offsets, shape,
                     device=device)


def csr_from_numpy(data, indices, indptr, rows, shape, device="cuda"):
    """The port's CSRMatrix with the same entries, in the same order."""
    device = resolve_device(device)

    def t(a, dtype=None):
        return torch.as_tensor(np.array(a, dtype=dtype), device=device)

    return CSRMatrix(t(data), t(indices, np.int64), t(indptr, np.int64),
                     t(rows, np.int64), shape)


def bell_from_numpy(data, indices, shape, bs, device="cuda"):
    """The port's BELLMatrix with the same blocks and int32 block column
    indices."""
    device = resolve_device(device)
    return BELLMatrix(torch.as_tensor(np.array(data), device=device),
                      torch.as_tensor(np.array(indices, dtype=np.int32),
                                      device=device), shape, bs)


def ell_from_numpy(data, indices, shape, device="cuda"):
    """The port's ELLMatrix with the same padded rows."""
    device = resolve_device(device)
    return ELLMatrix(torch.as_tensor(np.array(data), device=device),
                     torch.as_tensor(np.array(indices, dtype=np.int32),
                                     device=device), shape)


def sell_from_numpy(data, idx, slice_of, chunk_of, shape, nnz, covered=True,
                    device="cuda"):
    """The port's SELLMatrix with the same pairs and slots: int32 lane
    indices, slice and chunk of each pair, and the per-slice pair pointer
    derived from slice_of."""
    device = resolve_device(device)

    def t(a, dtype=None):
        return torch.as_tensor(np.array(a, dtype=dtype), device=device)

    return SELLMatrix(t(data), t(idx, np.int32), t(slice_of, np.int32),
                      t(chunk_of, np.int32), shape, nnz, covered)
