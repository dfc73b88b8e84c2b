"""General-sparse products on a block or row structure: ELL and block-ELL
(counterpart of ``krylov_tpu/ops/pallas_spmv.py``).

* **ELL** (padded rows): data and column indices of shape (m, K); the
  product is a gather of x and a row sum, in plain PyTorch (the JAX
  package's is a ``jnp.take``, outside any kernel).
* **BELL** (block-ELL): dense bs × bs blocks, nbr block rows of mbpr
  slots, padding slots zero.  ``bell_spmv`` and ``bell_spmm`` launch the
  CUDA kernels of ``csrc/bell_spmv.cu`` for CUDA tensors and take their
  plain versions (``bell_spmv_ref``, ``bell_spmm_ref``) for CPU tensors;
  both check their arguments on every call.  ``bell_plan`` chooses how
  the kernel runs a product (column tile, rows per slab, parts of a
  row's words, wide or element copies); ``BELLSpMM``, which ``BELLOperator`` holds,
  checks the storage once and binds one plan per type, shape and
  alignment of x, so that its call is one foreign call.

The builders run on the host with numpy, vectorised over the entries, and
give the JAX package's arrays: the same slots, in the same order.  A
builder puts its result on its input's device (a tensor's, a CSR
matrix's), numpy input on ``device``, by default the card.
"""

import functools
from typing import NamedTuple

import numpy as np
import torch

from .. import _build
from .._runtime import full_fp32
from .cuda_dia import _run
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


# ---------------------------------------------------------------------------
# the kernels' plan and their binding
# ---------------------------------------------------------------------------

# sm_90's shared memory per thread block (227 KB) and the kernel's ring
# and limits (csrc/bell_spmv.cu kStages, kMaxThreads): two stages, threads
SHARED_BYTES = 232448
STAGES = 2
_MAX_THREADS = 512
# the plan's aims, the fastest plans of sweeps on an H100 (PERF.md §6):
# slabs of 32 KB, at most 8 parts and 256 threads, at least two blocks per
# SM
SLAB_BYTES = 32768
PARTS = 8
THREADS = 256
# each thread's tile of outputs (rows, columns) by tile width: the
# kernel's TileRows and TileCols
_TILE = {1: (1, 1), 2: (1, 2), 4: (2, 2), 8: (2, 4)}
# the H100 SXM's SMs, for a plan made off the card
H100_SMS = 132


class BELLPlan(NamedTuple):
    """How the kernel of ``csrc/bell_spmv.cu`` runs one product: tiles of
    ``cols`` columns (1, 2, 4 or 8), slabs of ``rows`` rows, a ring of
    STAGES stages whose rows (the slab's, then x's columns) are ``ld``
    elements apart, ``wide`` 16-byte copies or element copies, ``shared``
    bytes of shared memory and ``threads`` threads per block: ``parts``
    of them for each tile of outputs (``_TILE``), each summing every
    ``parts``-th 16-byte word of the tile's rows."""
    cols: int
    rows: int
    parts: int
    ld: int
    wide: bool
    shared: int
    threads: int

    def blocks(self, nbr, bs, p):
        """Thread blocks in the grid: block rows × slabs × column tiles."""
        return nbr * -(-bs // self.rows) * -(-p // self.cols)


@functools.lru_cache(maxsize=None)
def bell_plan(bs, itemsize, p, aligned, nbr=None, sms=H100_SMS):
    """The plan of a product with blocks of bs, elements of ``itemsize``
    bytes and p columns (1 for the SpMV) over ``nbr`` block rows on a
    card of ``sms`` SMs; ``aligned`` says that data and x start on
    16-byte boundaries.

    Wide copies where a block's rows are whole 16-byte words and the
    pointers aligned, element copies otherwise.  Rows of a stage padded
    to an odd number of 16-byte words (distinct banks for 16-byte reads
    of distinct rows).  A slab is SLAB_BYTES of a block, cut
    in half while the grid has fewer than two blocks per SM (down to 16
    rows), and each tile's words are split over the most parts (up to
    PARTS) that keep THREADS threads.  Rows (a whole number of thread
    tiles, at most bs so rounded, at most 512 threads) are cut, then the
    tile width, until the ring fits 227 KB; raises where even one row of
    one column does not."""
    vec = 16 // itemsize
    words = -(-bs * itemsize // 16)
    ld = (words | 1) * vec
    cols = 1 if p == 1 else 2 if p == 2 else 4 if p <= 4 else 8

    def fit(r, c, g):
        tr, tc = _TILE[c]
        r = min(r, -(-bs // tr) * tr, _MAX_THREADS // (c // tc * g) * tr)
        return max(tr, r - r % tr)

    def shared(r, c):
        return STAGES * (r + c) * ld * itemsize

    def split(r, c):
        # the most parts, a power of two, that keep THREADS threads
        tr, tc = _TILE[c]
        g = 1
        while (g * 2 <= min(PARTS, words)
               and r // tr * (c // tc) * g * 2 <= THREADS):
            g *= 2
        return g

    rows = max(1, SLAB_BYTES // (bs * itemsize))
    if nbr is not None:
        while rows > 16 and nbr * -(-bs // rows) * -(-p // cols) < 2 * sms:
            rows //= 2
    parts = split(fit(rows, cols, 1), cols)
    rows = fit(rows, cols, parts)
    while shared(rows, cols) > SHARED_BYTES and rows > _TILE[cols][0]:
        rows = fit(-(-rows // 2), cols, parts)
    while shared(rows, cols) > SHARED_BYTES and cols > 1:
        cols //= 2
        rows = fit(rows, cols, parts)
    if shared(rows, cols) > SHARED_BYTES:
        raise ValueError(f"no BELL kernel plan for blocks of {bs} elements "
                         f"of {itemsize} bytes: two stages exceed "
                         f"{SHARED_BYTES} bytes of shared memory")
    tr, tc = _TILE[cols]
    threads = -(-(rows // tr * (cols // tc) * parts) // 32) * 32
    wide = aligned and (bs * itemsize) % 16 == 0
    return BELLPlan(cols, rows, parts, ld, wide, shared(rows, cols),
                    threads)


@functools.lru_cache(maxsize=None)
def _sm_count(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


def _entry(kind, dtype):
    """(name, C function) of the BELL ``kind`` entry point for ``dtype``,
    looked up once."""
    key = (kind, dtype)
    hit = _BOUND.get(key)
    if hit is None:
        name = f"ktt_bell_{kind}_{_SUFFIX[dtype]}"
        hit = _BOUND[key] = (name, getattr(_build.library(), name))
    return hit


_BOUND = {}


def _check_storage(A):
    """(nbr, mbpr, bs) of a BELLMatrix whose data (nbr, mbpr, bs, bs) and
    int32 indices (nbr, mbpr) agree with its shape and lie on one device;
    raises otherwise."""
    if A.data.dim() != 4 or A.indices.dim() != 2:
        raise ValueError(f"BELL data {tuple(A.data.shape)} and indices "
                         f"{tuple(A.indices.shape)}: want (nbr, mbpr, bs, "
                         "bs) and (nbr, mbpr)")
    nbr, mbpr, bs, bs2 = A.data.shape
    m, n = A.shape
    if (bs != bs2 or bs != A.bs or tuple(A.indices.shape) != (nbr, mbpr)
            or m > nbr * bs):
        raise ValueError(f"BELL data {tuple(A.data.shape)}, indices "
                         f"{tuple(A.indices.shape)} and bs {A.bs} do not "
                         f"make a {m} x {n} matrix")
    if not (A.data.device == A.indices.device
            and A.indices.dtype == torch.int32):
        raise ValueError("BELL data and int32 indices must be on one "
                         "device")
    return nbr, mbpr, bs


def _plan_args(A, X, storage):
    """What one product of A (storage (nbr, mbpr, bs)) with X on the card
    launches: the bound entry point and the wrapper that counts it
    (bell_spmv's for a vector, bell_spmm's for a panel), the arguments
    before and after x and y, and y's shape; raises for a type pair with
    no kernel."""
    kind, wrapper = ("spmv", bell_spmv) if X.dim() == 1 \
        else ("spmm", bell_spmm)
    if _SUFFIX.get(X.dtype) is None or A.data.dtype != X.dtype \
            or not X.is_cuda:
        raise ValueError(f"no BELL {kind} kernel for x {X.dtype} with data "
                         f"{A.data.dtype} on {X.device}")
    if A.data.device != X.device:
        raise ValueError("BELL data, int32 indices and x must be on one "
                         "device")
    nbr, mbpr, bs = storage
    m, n = A.shape
    p = 1 if X.dim() == 1 else X.shape[1]
    aligned = A.data.data_ptr() % 16 == 0 and X.data_ptr() % 16 == 0
    plan = bell_plan(bs, X.element_size(), p, aligned, nbr,
                     _sm_count(X.device))
    cols = () if kind == "spmv" else (p, plan.cols)
    return (_entry(kind, X.dtype), wrapper,
            (A.data.data_ptr(), A.indices.data_ptr()),
            (nbr, mbpr, bs, m, n, *cols, plan.rows, plan.parts, plan.ld,
             int(plan.wide)),
            (m,) + tuple(X.shape[1:]))


def _check_x(A, X):
    if X.dim() not in (1, 2) or X.shape[0] != A.shape[1]:
        raise ValueError(f"x {tuple(X.shape)} does not match A {A.shape}")


def _launch(plan, X, device):
    """One foreign call of a product's plan (``_plan_args``) on X."""
    bound, wrapper, head, tail, shape = plan
    Y = torch.empty(shape, dtype=X.dtype, device=device)
    _run(bound, wrapper, device, (*head, X.data_ptr(), Y.data_ptr(), *tail))
    return Y


def _public(A, X):
    _check_x(A, X)
    if X.device.type == "cpu":
        return bell_spmv_ref(A, X) if X.dim() == 1 else bell_spmm_ref(A, X)
    A = BELLMatrix(A.data.contiguous(), A.indices.contiguous(), A.shape,
                   A.bs)
    X = X.contiguous()
    return _launch(_plan_args(A, X, _check_storage(A)), X, X.device)


def bell_spmv(A, x):
    """y = A x for a BELLMatrix: the kernel for a CUDA x, the plain
    version for a CPU one.  Checks its arguments on every call;
    ``BELLSpMM`` checks the storage once."""
    if x.dim() != 1:
        raise ValueError(f"x {tuple(x.shape)} does not match A {A.shape}")
    return _public(A, x)


bell_spmv.launches = 0


def bell_spmm(A, X):
    """Y = A X for a BELLMatrix and X of shape (n, p), any p: the kernel
    (each block read once per tile of up to 8 columns) for a CUDA X, the
    plain version for a CPU one.  The block solvers reach it through
    ``BELLOperator.matmat``."""
    if X.dim() != 2:
        raise ValueError(f"X {tuple(X.shape)} does not match A {A.shape}")
    return _public(A, X)


bell_spmm.launches = 0


class BELLSpMM:
    """y = A x and Y = A X for one BELLMatrix, its storage checked once
    (contiguous, where it lies on the card).

    A call checks x's type, shape, 16-byte alignment, device and
    contiguity against the plans it has bound, then makes one stream
    lookup and one foreign call to the kernel of ``csrc/bell_spmv.cu``,
    counted on ``bell_spmv.launches`` for a vector and
    ``bell_spmm.launches`` for a panel; a CPU x takes the plain version,
    and a strided x is copied first, as the public wrappers do.
    An in-place change of the data is seen by the next call; new tensors
    in the matrix need a new ``BELLSpMM``.
    """

    def __init__(self, A):
        self._storage = _check_storage(A)
        if A.data.is_cuda and not (A.data.is_contiguous()
                                   and A.indices.is_contiguous()):
            raise ValueError("BELL data and indices on the card must be "
                             "contiguous")
        self.A, self.data, self.indices = A, A.data, A.indices
        self.device = A.data.device
        self._plans = {}

    def __call__(self, X):
        plan = self._plans.get((X.dtype, X.shape, not X.data_ptr() & 15))
        if plan is None or X.device != self.device \
                or not X.is_contiguous():
            return self._bind(X)
        return _launch(plan, X, self.device)

    def _bind(self, X):
        _check_x(self.A, X)
        if X.device.type == "cpu":
            return bell_spmv_ref(self.A, X) if X.dim() == 1 \
                else bell_spmm_ref(self.A, X)
        X = X.contiguous()
        plan = self._plans[X.dtype, X.shape, not X.data_ptr() & 15] = \
            _plan_args(self.A, X, self._storage)
        return _launch(plan, X, self.device)
