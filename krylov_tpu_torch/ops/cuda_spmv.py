"""General-sparse products on a block or row structure: ELL and block-ELL
(counterpart of ``krylov_tpu/ops/pallas_spmv.py``).

* **ELL** (padded rows): data and column indices of shape (m, K); the
  product is a gather of x and a row sum, in plain PyTorch (the JAX
  package's is a ``jnp.take``, outside any kernel).
* **BELL** (block-ELL): dense bs × bs blocks, nbr block rows of mbpr
  slots, padding slots zero.  ``bell_spmv`` and ``bell_spmm`` launch the
  CUDA kernels of ``csrc/bell_spmv.cu`` for CUDA tensors and take their
  plain versions (``bell_spmv_ref``, ``bell_spmm_ref``) for CPU tensors.

The builders run on the host with numpy, vectorised over the entries, and
give the JAX package's arrays: the same slots, in the same order.  A
builder puts its result on its input's device (a tensor's, a CSR
matrix's), numpy input on ``device``, by default the card.
"""

import numpy as np
import torch

from .. import _build
from .._runtime import full_fp32
from .dia import resolve_device

# the element types the block-ELL kernels take (data and x alike)
_SUFFIX = {torch.float32: "f32", torch.float64: "f64",
           torch.bfloat16: "bf16", torch.float16: "f16",
           torch.complex64: "c64", torch.complex128: "c128"}


def _host(a):
    """A tensor's or array's values as numpy; bf16, which numpy lacks,
    widened to f32 (exactly)."""
    if isinstance(a, torch.Tensor):
        return (a.float() if a.dtype == torch.bfloat16 else a).cpu().numpy()
    return np.asarray(a)


def _placed(a, like, device):
    """numpy ``a`` on ``device``, else on ``like``'s device (a tensor's),
    else on the card; floating values narrowed back to bf16 where ``like``
    holds bf16 (``_host`` widened them)."""
    if device is None:
        device = like.device if hasattr(like, "device") and isinstance(
            like.device, torch.device) else "cuda"
    t = torch.as_tensor(a, device=resolve_device(device))
    if t.is_floating_point() and getattr(like, "dtype",
                                         None) == torch.bfloat16:
        t = t.to(torch.bfloat16)
    return t


# ---------------------------------------------------------------------------
# ELL: padded scalar rows
# ---------------------------------------------------------------------------

class ELLMatrix:
    """Padded-row sparse matrix: data and indices of shape (m, K)."""

    def __init__(self, data, indices, shape):
        self.data = data
        self.indices = indices
        self.shape = tuple(int(s) for s in shape)

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def device(self):
        return self.data.device

    def __matmul__(self, x):
        return ell_spmv(self.data, self.indices, x)


def ell_from_csr(csr, device=None):
    """A CSRMatrix as padded ELL (host-side), the JAX package's arrays:
    row i's entries in its first slots, in CSR order; K the longest row
    (at least 1)."""
    indptr = _host(csr.indptr).astype(np.int64)
    cols = _host(csr.indices)
    vals = _host(csr.data)
    m, n = csr.shape
    counts = np.diff(indptr)
    K = int(counts.max()) if m else 0
    data = np.zeros((m, max(K, 1)), dtype=vals.dtype)
    idx = np.zeros((m, max(K, 1)), dtype=np.int32)
    rows = np.repeat(np.arange(m), counts)
    pos = np.arange(indptr[-1] if m else 0) - indptr[rows]
    data[rows, pos] = vals
    idx[rows, pos] = cols
    return ELLMatrix(_placed(data, csr, device), _placed(idx, csr, device),
                     (m, n))


def ell_spmv(data, indices, x):
    """y = A x for ELL: the row sums of data times the gathered x."""
    return torch.sum(data * x[indices.long()], dim=1)


# ---------------------------------------------------------------------------
# BELL: block-ELL
# ---------------------------------------------------------------------------

class BELLMatrix:
    """Block-ELL: data (nbr, mbpr, bs, bs), block column indices (nbr,
    mbpr) int32."""

    def __init__(self, data, indices, shape, bs):
        self.data = data
        self.indices = indices
        self.shape = tuple(int(s) for s in shape)
        self.bs = int(bs)

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def device(self):
        return self.data.device

    def __matmul__(self, x):
        return bell_spmv(self, x) if x.dim() == 1 else bell_spmm(self, x)


def _bell(data, idx, shape, bs, like, device):
    return BELLMatrix(_placed(data, like, device), _placed(idx, like, device),
                      shape, bs)


def bell_from_dense_blocks(A, bs=128, tol=0.0, device=None):
    """BELL from a dense matrix: its bs × bs blocks with an entry of
    modulus above ``tol``, each block row's in the order of their block
    columns."""
    An = _host(A)
    m, n = An.shape
    mp, np_ = -(-m // bs) * bs, -(-n // bs) * bs
    Ap = np.zeros((mp, np_), dtype=An.dtype)
    Ap[:m, :n] = An
    nbr, nbc = mp // bs, np_ // bs
    blocks = Ap.reshape(nbr, bs, nbc, bs).transpose(0, 2, 1, 3)
    occ = np.any(np.abs(blocks) > tol, axis=(2, 3))
    mbpr = max(1, int(occ.sum(axis=1).max()))
    ri, cj = np.nonzero(occ)
    slots = (np.cumsum(occ, axis=1) - 1)[ri, cj]
    data = np.zeros((nbr, mbpr, bs, bs), dtype=An.dtype)
    idx = np.zeros((nbr, mbpr), dtype=np.int32)
    data[ri, slots] = blocks[ri, cj]
    idx[ri, slots] = cj
    return _bell(data, idx, (m, n), bs, A, device)


def bell_from_csr(csr, bs=128, device=None):
    """BELL from a CSRMatrix without densifying (host-side, O(nnz)): the
    occupied blocks from the pattern (indices // bs), each block row's in
    the order of their block columns."""
    rows = _host(csr.rows).astype(np.int64)
    cols = _host(csr.indices).astype(np.int64)
    vals = _host(csr.data)
    m, n = csr.shape
    nbr = -(-m // bs)
    nbc = max(-(-n // bs), 1)
    key = (rows // bs) * nbc + cols // bs
    uk = np.unique(key)
    ubi, ubj = uk // nbc, uk % nbc
    counts = np.bincount(ubi, minlength=nbr)
    mbpr = max(1, int(counts.max()) if nbr else 1)
    slot_u = np.arange(uk.size) - (np.cumsum(counts) - counts)[ubi]
    data = np.zeros((nbr, mbpr, bs, bs), dtype=vals.dtype)
    idx = np.zeros((nbr, mbpr), dtype=np.int32)
    idx[ubi, slot_u] = ubj
    slot = slot_u[np.searchsorted(uk, key)]
    data[rows // bs, slot, rows % bs, cols % bs] = vals
    return _bell(data, idx, (m, n), bs, csr, device)


def _acc_dtype(dtype):
    """The kernels' accumulation type: f32 for f32, bf16 and f16, else the
    type itself (pallas_spmv.py:205-206)."""
    return torch.float32 if dtype in (torch.bfloat16, torch.float16,
                                      torch.float32) else dtype


def bell_spmm_ref(A, X):
    """Plain PyTorch Y = A X for BELL (X of shape (n, p)): x padded with
    zeros to whole blocks, one slot after another, each slot a batched
    product of the blocks with the segments their indices name, in the
    accumulation type and IEEE fp32."""
    nbr, mbpr, bs, _ = A.data.shape
    n_in, p = X.shape
    acc_t = _acc_dtype(X.dtype)
    ncols_pad = max(-(-A.shape[1] // bs), 1) * bs
    Xp = torch.zeros((ncols_pad, p), dtype=acc_t, device=X.device)
    Xp[:n_in] = X
    Xb = Xp.view(-1, bs, p)
    idx = A.indices.long()
    Y = torch.zeros((nbr, bs, p), dtype=acc_t, device=X.device)
    with full_fp32():
        for k in range(mbpr):
            Y += torch.bmm(A.data[:, k].to(acc_t), Xb[idx[:, k]])
    return Y.reshape(-1, p)[:A.shape[0]].to(X.dtype)


def bell_spmv_ref(A, x):
    """Plain PyTorch y = A x for BELL (``bell_spmm_ref`` on one column)."""
    return bell_spmm_ref(A, x[:, None])[:, 0]


def _bell_launch(wrapper, name, A, X, p):
    """The block-ELL kernel ``name`` on X (n,) or (n, p) on the card;
    raises for a type pair with no kernel."""
    suffix = _SUFFIX.get(X.dtype)
    if suffix is None or A.data.dtype != X.dtype or not X.is_cuda:
        raise ValueError(f"no BELL {name} kernel for x {X.dtype} with data "
                         f"{A.data.dtype} on {X.device}")
    if not (A.data.device == A.indices.device == X.device
            and A.indices.dtype == torch.int32):
        raise ValueError("BELL data, int32 indices and x must be on one "
                         "device")
    nbr, mbpr, bs, _ = A.data.shape
    m, n = A.shape
    data, idx, X = (A.data.contiguous(), A.indices.contiguous(),
                    X.contiguous())
    Y = torch.empty((m,) + tuple(X.shape[1:]), dtype=X.dtype,
                    device=X.device)
    entry = f"ktt_bell_{name}_{suffix}"
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream().cuda_stream
        args = (data.data_ptr(), idx.data_ptr(), X.data_ptr(), Y.data_ptr(),
                nbr, mbpr, bs, m, n) + ((p,) if name == "spmm" else ())
        err = getattr(_build.library(), entry)(*args, stream)
    wrapper.launches += 1
    _build.check(err, entry)
    return Y


def bell_spmv(A, x):
    """y = A x for a BELLMatrix: the kernel for a CUDA x, the plain
    version for a CPU one."""
    if x.dim() != 1 or x.shape[0] != A.shape[1]:
        raise ValueError(f"x {tuple(x.shape)} does not match A {A.shape}")
    if x.device.type == "cpu":
        return bell_spmv_ref(A, x)
    return _bell_launch(bell_spmv, "spmv", A, x, 1)


bell_spmv.launches = 0


def bell_spmm(A, X):
    """Y = A X for a BELLMatrix and X of shape (n, p), any p: the kernel
    (each block read once per tile of 8 columns) for a CUDA X, the plain
    version for a CPU one.  The block solvers reach it through
    ``BELLOperator.matmat``."""
    if X.dim() != 2 or X.shape[0] != A.shape[1]:
        raise ValueError(f"X {tuple(X.shape)} does not match A {A.shape}")
    if X.device.type == "cpu":
        return bell_spmm_ref(A, X)
    return _bell_launch(bell_spmm, "spmm", A, X, X.shape[1])


bell_spmm.launches = 0
