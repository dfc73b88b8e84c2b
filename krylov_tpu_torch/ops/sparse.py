"""CSR storage and its products (counterpart of ``krylov_tpu/ops/sparse.py``).

``CSRMatrix`` keeps the COO row index array ``rows`` beside ``indptr``,
as the JAX package does: the products are a gather of x by column and a
sum into rows (the JAX package's sorted ``segment_sum``): ``index_add_``
on the CPU, ``segment_reduce`` over the row lengths on the card, where
``index_add_``'s atomics would change the bits from call to call.  The
structure is built on the host with numpy; constructors put the arrays
on the card unless ``device="cpu"`` is passed, as the other
constructors of the port do.
"""

import numpy as np
import torch

from .dia import resolve_device


class CSRMatrix:
    """CSR sparse matrix: data, indices (columns), indptr and rows."""

    def __init__(self, data, indices, indptr, rows, shape):
        self.data = data
        self.indices = indices
        self.indptr = indptr
        self.rows = rows
        self.shape = tuple(int(s) for s in shape)

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def device(self):
        return self.data.device

    @property
    def nnz(self):
        return self.data.shape[0]

    def todense(self):
        dense = torch.zeros(self.shape, dtype=self.dtype, device=self.device)
        return dense.index_put_((self.rows, self.indices), self.data,
                                accumulate=True)

    def transpose_conj(self):
        """Aᴴ as a new CSRMatrix (built on the host, placed where A is)."""
        m, n = self.shape
        rows = self.rows.cpu().numpy()
        cols = self.indices.cpu().numpy()
        order = np.lexsort((rows, cols))
        # the values reordered where they lie (numpy holds no bf16)
        data = self.data.conj().resolve_conj()[
            torch.as_tensor(order, device=self.device)]
        return _csr_arrays(data, cols[order], rows[order], (n, m),
                           self.device)

    def __matmul__(self, x):
        if x.dim() == 1:
            return spmv(self, x)
        return spmm(self, x)


def _csr_arrays(vals, rows, cols, shape, device):
    """A CSRMatrix from COO arrays sorted by (row, column)."""
    m = shape[0]
    indptr = np.zeros(m + 1, dtype=np.int64)
    np.add.at(indptr, rows + 1, 1)
    indptr = np.cumsum(indptr)

    def t(a):
        return torch.as_tensor(a, device=device)

    return CSRMatrix(t(vals), t(cols.astype(np.int64)), t(indptr),
                     t(rows.astype(np.int64)), shape)


def csr_from_coo(rows, cols, vals, shape, dtype=None, device="cuda"):
    """A CSRMatrix from COO triplets (host-side; duplicates summed)."""
    device = resolve_device(device)
    rows = np.asarray(rows)
    cols = np.asarray(cols)
    vals = np.asarray(vals)
    if dtype is not None:
        vals = vals.astype(dtype)
    m, n = shape
    order = np.lexsort((cols, rows))
    rows, cols, vals = rows[order], cols[order], vals[order]
    if len(rows) > 0:
        key = rows.astype(np.int64) * n + cols.astype(np.int64)
        uniq, inv = np.unique(key, return_inverse=True)
        if len(uniq) != len(key):
            summed = np.zeros(len(uniq), dtype=vals.dtype)
            np.add.at(summed, inv, vals)
            rows, cols, vals = uniq // n, uniq % n, summed
    return _csr_arrays(vals, rows, cols, (m, n), device)


def csr_from_dense(A, tol=0.0, device=None):
    """A CSRMatrix of the entries of a dense array with |a| > tol; a
    tensor's entries stay on its device, numpy data goes to the card."""
    if device is None:
        device = A.device if isinstance(A, torch.Tensor) else "cuda"
    A = A.cpu().numpy() if isinstance(A, torch.Tensor) else np.asarray(A)
    rows, cols = np.nonzero(np.abs(A) > tol)
    return csr_from_coo(rows, cols, A[rows, cols], A.shape, device=device)


def _row_sums(A, prod):
    """The products ``prod`` (one row per stored entry) summed into A's
    rows.  On the CPU ``index_add_``, which adds them in order; on the
    card ``index_add_`` adds with atomics, in an order that changes from
    call to call, so each row is summed by ``segment_reduce`` over
    indptr's row lengths, in an order fixed by the matrix alone (complex
    products as their real and imaginary parts)."""
    out = torch.zeros((A.shape[0],) + prod.shape[1:], dtype=prod.dtype,
                      device=prod.device)
    if prod.device.type == "cpu" or prod.shape[0] == 0:
        return out.index_add_(0, A.rows, prod)
    lengths = A.indptr[1:] - A.indptr[:-1]
    if prod.is_complex():
        sums = torch.segment_reduce(torch.view_as_real(prod), "sum",
                                    lengths=lengths, unsafe=True)
        return torch.view_as_complex(sums.contiguous())
    return torch.segment_reduce(prod, "sum", lengths=lengths, unsafe=True)


def spmv(A, x):
    """y = A x: a gather of x by column and a sum into rows."""
    dt = torch.promote_types(A.dtype, x.dtype)
    return _row_sums(A, (A.data * x[A.indices]).to(dt))


def spmm(A, X):
    """Y = A X for a block of column vectors."""
    dt = torch.promote_types(A.dtype, X.dtype)
    return _row_sums(A, (A.data[:, None] * X[A.indices, :]).to(dt))
