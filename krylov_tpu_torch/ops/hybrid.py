"""Matrix-structure analysis: a general CSR matrix split into DIA and SELL
parts (counterpart of ``krylov_tpu/ops/hybrid.py``).

A one-time host-side analysis decomposes the pattern:

* diagonals dense enough to stream (fill >= ``diag_fill``) go to a DIA
  part, whose product on the card is the DIA SpMV kernel on diagonals
  aligned once at analysis time (``ops/cuda_dia.py``),
* everything else goes to the SELL-C-128 remainder (``ops/cuda_sell.py``),
  or stays CSR when its SELL packing would be degenerate.

A banded matrix analyses to pure DIA, a scattered one to pure SELL.
``y = dia part + sell part``, exact.  The analysis makes the JAX
package's decisions, so one CSR gives the same parts in both packages.
On the card a product with both parts is two launches, the DIA SpMV and
one SELL SpMV over every part that adds the DIA half as it writes y.
"""

import numpy as np
import torch

from .cuda_dia import DIASpMV, dia_align, offsets_tensor
from .cuda_sell import (_MAX_PAIR_WORDS, SELLBucketed, sell_bucketed_from_csr,
                        sell_hybrid_spmv, sell_spmv)
from .cuda_spmv import _host, _placed
from .dia import DIAMatrix, dia_spmv
from .sparse import CSRMatrix, csr_from_coo, spmv


def _device(csr):
    """Where the parts of ``csr`` go: its tensors' device; the card for a
    matrix of numpy arrays (the JAX package's)."""
    return csr.data.device if isinstance(csr.data, torch.Tensor) else "cuda"


def split_diagonals(csr, diag_fill=0.5, max_diags=256):
    """Partition a square CSRMatrix's nonzeros by diagonal density.

    Returns ``(dia, rem)``: ``dia`` a DIAMatrix of every diagonal whose
    fill (nonzeros on it / its length) is at least ``diag_fill`` (at most
    ``max_diags``, densest first), ``rem`` a CSRMatrix of the other
    nonzeros; either may be None.  Both lie where ``csr`` does (on the
    card for numpy arrays), in its element type.  Host-side, O(nnz).
    """
    m, n = csr.shape
    rows = _host(csr.rows).astype(np.int64)
    cols = _host(csr.indices).astype(np.int64)
    vals = _host(csr.data)
    if m != n or len(vals) == 0:
        return None, csr

    offs = cols - rows
    uniq, counts = np.unique(offs, return_counts=True)
    lengths = n - np.abs(uniq)
    fill = counts / lengths
    dense = uniq[fill >= diag_fill]
    if len(dense) > max_diags:
        order = np.argsort(-fill[np.isin(uniq, dense)])
        dense = dense[order[:max_diags]]
        dense.sort()
    if len(dense) == 0:
        return None, csr

    on_dia = np.isin(offs, dense)
    data = np.zeros((len(dense), n), vals.dtype)
    d_of = np.searchsorted(dense, offs[on_dia])
    # SciPy's DIA convention: A[i, i+k] lives at data[d, i+k] (the column)
    data[d_of, cols[on_dia]] = vals[on_dia]
    device = _device(csr)
    dia = DIAMatrix(_placed(data, csr.data, device),
                    tuple(int(k) for k in dense), (n, n), device=device)

    if np.all(on_dia):
        return dia, None
    rem = _narrowed(csr_from_coo(rows[~on_dia], cols[~on_dia],
                                 vals[~on_dia], (m, n), device=device), csr)
    return dia, rem


def _narrowed(out, csr):
    """CSRMatrix ``out``, built from ``csr``'s values on the host, with its
    data in ``csr``'s bf16 again (``_host`` widened them to f32)."""
    out.data = _placed(out.data, csr.data, out.data.device)
    return out


class HybridMatrix:
    """DIA + SELL decomposition of a sparse matrix (either part optional).

    ``sell`` is a SELLMatrix, a SELLBucketed, or the CSRMatrix remainder
    when its packing would be degenerate.  ``dia_pd`` holds the
    output-aligned diagonals that the DIA SpMV kernel takes, made at
    analysis time when the diagonals lie on the card (None elsewhere),
    and validated once for the kernel (``DIASpMV``).
    """

    def __init__(self, dia, sell, shape, dia_pd=None):
        self.dia = dia
        self.sell = sell
        self.dia_pd = dia_pd
        self.shape = tuple(shape)
        self._offsets = self._dia_spmv = None
        if dia_pd is not None:
            self._offsets = offsets_tensor(dia.offsets, dia_pd.device)
            self._dia_spmv = DIASpMV(dia_pd, self._offsets, dia.offsets)

    @property
    def dtype(self):
        return self.dia.dtype if self.dia is not None else self.sell.dtype

    @property
    def device(self):
        return self.dia.device if self.dia is not None else self.sell.device

    @property
    def nnz(self):
        z = 0
        if self.dia is not None:
            z += self.dia.nnz
        if self.sell is not None:
            z += self.sell.nnz
        return z

    def __matmul__(self, x):
        return hybrid_spmv(self, x)


def rcm_permute(csr):
    """Reverse-Cuthill-McKee reorder: ``(P A Pᵀ as CSRMatrix, perm)``.

    Clusters a scattered pattern toward the diagonal, so that the
    analysis finds dense diagonals and the SELL remainder gets few pairs
    at a high fill.  Solve the permuted system with ``b[perm]`` and
    un-permute x with ``x[inv]``, ``inv = np.argsort(perm)``.  The result
    lies where ``csr`` does.
    """
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee
    m, n = csr.shape
    if m != n:
        raise ValueError("rcm_permute needs a square matrix")
    A = sp.csr_matrix((_host(csr.data), _host(csr.indices),
                       _host(csr.indptr)), shape=csr.shape)
    perm = np.asarray(reverse_cuthill_mckee(A, symmetric_mode=False))
    Ap = A[perm][:, perm].tocoo()
    return (_narrowed(csr_from_coo(Ap.row, Ap.col, Ap.data, (n, n),
                                   device=_device(csr)), csr), perm)


def hybrid_from_csr(csr, diag_fill=0.5, max_diags=256):
    """Analyse a CSRMatrix into a HybridMatrix (host-side, one-time).

    If the remainder's SELL packing would be degenerate — more than 64
    stored slots per nonzero, the sign of a scattered pattern with no
    slice/chunk locality, or more pairs than the JAX package's kernel
    takes — the remainder stays CSR (``ops/sparse.spmv``); pre-process
    with :func:`rcm_permute` to give the analysis a banded pattern.
    """
    dia, rem = split_diagonals(csr, diag_fill, max_diags)
    sell = None
    if rem is not None:
        sell = sell_bucketed_from_csr(rem)
        parts = sell.parts if isinstance(sell, SELLBucketed) else (sell,)
        slots = sum(p.data.numel() for p in parts)
        pairs = max(p.data.shape[0] for p in parts)
        if slots > 64 * max(rem.nnz, 1) or 2 * pairs + 1 > _MAX_PAIR_WORDS:
            sell = rem
    dia_pd = None
    if dia is not None and dia.data.is_cuda:
        dia_pd = dia_align(dia.data, dia.offsets, dia.shape[0])
    return HybridMatrix(dia, sell, csr.shape, dia_pd)


def hybrid_spmv(A, x):
    """y = A x for a HybridMatrix: the DIA part through the DIA SpMV kernel
    (on the card) or the plain shift-and-add product (on the CPU), plus
    the remainder through one SELL launch that adds the DIA half (its
    table walk on the CPU), or the CSR product."""
    y = None
    if A.dia is not None:
        if A._dia_spmv is not None:
            y = A._dia_spmv(x)
        else:
            y = dia_spmv(A.dia.data, A.dia.offsets, x)
    if A.sell is None:
        return y
    if isinstance(A.sell, CSRMatrix):
        ys = spmv(A.sell, x)
        return ys if y is None else y + ys
    if y is None:
        return sell_spmv(A.sell, x)
    return sell_hybrid_spmv(A.sell, x, y)
