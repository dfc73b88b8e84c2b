"""SELL-C-128 storage and its SpMV: the CUDA kernel and its plain version
(counterpart of ``krylov_tpu/ops/pallas_sell.py``).

The layout is the JAX package's, array for array:

* rows are grouped in **slices of 1024** (``SLICE``),
* each slice's nonzeros are grouped by **128-wide column chunk**
  (``col // 128``, ``CHUNK``), giving a list of (slice, chunk) *pairs*
  sorted by slice,
* a pair stores its nonzeros as (Kmax·8, 128) data and index tiles: lane
  = row % 128, sublane group k = the k-th nonzero of that row in this
  chunk, index = column % 128 (lane-local); padding slots hold 0.

So slot (p, k·8 + r // 128, r % 128) of a pair holds the k-th nonzero of
row r of its slice, and for a fixed k the 1024 rows of the slice lie at
consecutive addresses.  ``sell_spmv`` launches the kernel of
``csrc/sell_spmv.cu`` for a CUDA x (one thread block per slice, a thread
per row, the pair's 128 x values staged in shared memory) and takes the
plain version, ``sell_spmv_ref``, for a CPU x.

``SELLBucketed`` is a sum of SELL parts, each packed at its own Kmax by
the JAX package's cost plan (``_bucket_plan``, its v5e constants kept so
that one CSR gives the same parts in both packages), optionally with
rows σ-sorted by depth class.  The builders run on the host with numpy.
A builder puts its result on its input's device (a CSR matrix's), numpy
input on ``device``, by default the card; beside the JAX package's arrays
a ``SELLMatrix`` keeps ``slice_ptr``, the first pair of each slice (nsl
+ 1 entries, int32), which the kernel walks.
"""

import numpy as np
import torch

from .. import _build
from .._runtime import full_fp32
from .cuda_dia import _SUFFIX
from .cuda_spmv import _host, _placed

SLICE = 1024       # rows per slice
CHUNK = 128        # columns per chunk
# the most pairs a SELL matrix may hold: the JAX package's SMEM
# scalar-prefetch budget (pallas_sell.py:341-345), kept for parity
_MAX_PAIR_WORDS = 240_000


class SELLMatrix:
    """Chunked sliced-ELL matrix (see the module docstring).

    data, idx: (P, Kmax·8, 128); slice_of: (P + 1,) int32 slice of each
    pair and a sentinel; chunk_of: (P,) int32 chunk of each pair;
    ``covered`` records whether every slice owns a pair.  slice_ptr:
    (nsl + 1,) int32, pairs [slice_ptr[s], slice_ptr[s + 1]) belong to
    slice s; computed from slice_of when not given.
    """

    def __init__(self, data, idx, slice_of, chunk_of, shape, nnz,
                 covered=True, slice_ptr=None):
        self.data = data
        self.idx = idx
        self.slice_of = slice_of
        self.chunk_of = chunk_of
        self.shape = tuple(int(s) for s in shape)
        self.nnz = int(nnz)
        self.covered = bool(covered)
        if slice_ptr is None:
            slice_ptr = torch.as_tensor(
                _slice_ptr(_host(slice_of), self.shape[0]),
                device=data.device)
        self.slice_ptr = slice_ptr

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def device(self):
        return self.data.device

    @property
    def kmax(self):
        return self.data.shape[1] // 8

    @property
    def fill(self):
        """Fraction of stored slots that hold real nonzeros."""
        return self.nnz / max(self.data.numel(), 1)

    def __matmul__(self, x):
        return sell_spmv(self, x)


def _nslices(m):
    return max(-(-m // SLICE), 1)


def _slice_ptr(slice_of, m):
    """The first pair of each slice and the pair count, from the slice of
    each pair (sorted) and its sentinel."""
    pairs = np.asarray(slice_of[:-1], np.int64)
    return np.searchsorted(pairs, np.arange(_nslices(m) + 1)).astype(
        np.int32)


def _sell_arrays(rows, cols, vals, m, n, cover):
    """The JAX package's sell_from_csr arrays (pallas_sell.py:94-144) from
    COO triplets: (data, idx, slice_of, chunk_of, covered)."""
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    nsl = _nslices(m)
    nch = max(-(-n // CHUNK), 1)

    s = rows // SLICE
    c = cols // CHUNK
    key = s * nch + c
    order = np.lexsort((cols, rows, key))
    key_o, row_o, col_o, val_o = key[order], rows[order], cols[order], \
        vals[order]

    # slot k = running count of this row's nonzeros within its pair
    if len(key_o):
        new_grp = np.r_[True, (key_o[1:] != key_o[:-1])
                        | (row_o[1:] != row_o[:-1])]
        starts = np.where(new_grp, np.arange(len(key_o)), 0)
        k = np.arange(len(key_o)) - np.maximum.accumulate(starts)
        kmax = int(k.max()) + 1
    else:
        k = np.zeros(0, np.int64)
        kmax = 1

    uniq = np.unique(key_o)
    missing = np.setdiff1d(np.arange(nsl), uniq // nch)
    covered = len(missing) == 0
    if cover:
        # every slice owns >= 1 pair
        uniq = np.union1d(uniq, missing * nch)
        covered = True
    P = len(uniq)
    pair_of_nnz = np.searchsorted(uniq, key_o)

    data = np.zeros((P, kmax * 8, CHUNK), vals.dtype)
    idx = np.zeros((P, kmax * 8, CHUNK), np.int32)
    r_loc = row_o % SLICE
    sub = k * 8 + r_loc // CHUNK
    lane = r_loc % CHUNK
    data[pair_of_nnz, sub, lane] = val_o
    idx[pair_of_nnz, sub, lane] = (col_o % CHUNK).astype(np.int32)

    slice_of = np.empty(P + 1, np.int32)
    slice_of[:P] = uniq // nch
    slice_of[P] = slice_of[P - 1] + 1 if P else 0   # sentinel
    chunk_of = (uniq % nch).astype(np.int32)
    return data, idx, slice_of, chunk_of, covered


def sell_from_csr(csr, cover=True, device=None):
    """A SELLMatrix from a CSRMatrix (host-side, vectorised O(nnz)).

    ``cover=True`` inserts an all-zero pair for every slice that owns no
    nonzero; ``cover=False`` skips them (the kernel writes zeros for a
    slice with no pair) — the choice for the deep, sparse parts of
    :func:`sell_bucketed_from_csr`.
    """
    return _sell_matrix(_host(csr.rows), _host(csr.indices),
                        _host(csr.data), csr.shape, cover, csr.data, device)


def _sell_matrix(rows, cols, vals, shape, cover, like, device):
    """A SELLMatrix from COO triplets, placed as ``_placed`` places
    ``like``'s arrays."""
    m, n = shape
    data, idx, slice_of, chunk_of, covered = _sell_arrays(
        rows, cols, vals, m, n, cover)
    return SELLMatrix(*(_placed(a, like, device)
                        for a in (data, idx, slice_of, chunk_of)),
                      (m, n), len(vals), covered,
                      _placed(_slice_ptr(slice_of, m), like, device))


class SELLBucketed:
    """Sum of SELLMatrix parts, each packed at its own Kmax (SELL-C-σ).

    y is the exact sum of the parts' products, un-permuted by one gather
    when rows were σ-sorted (``row_pos`` maps an original row to its
    sorted position; None when unsorted).
    """

    def __init__(self, parts, shape, nnz, row_pos=None):
        self.parts = tuple(parts)
        self.shape = tuple(int(s) for s in shape)
        self.nnz = int(nnz)
        self.row_pos = row_pos

    @property
    def dtype(self):
        return self.parts[0].dtype

    @property
    def device(self):
        return self.parts[0].device

    @property
    def slots(self):
        return sum(p.data.numel() for p in self.parts)

    @property
    def fill(self):
        return self.nnz / max(self.slots, 1)

    def __matmul__(self, x):
        return sell_bucketed_spmv(self, x)


# The JAX package's cost model, in units of one stored slot, calibrated
# on a TPU v5e (pallas_sell.py:204-209).  Kept as it is: the plan decides
# which parts are built, not y, and one CSR must give the same parts in
# both packages.
_PAIR_COST = 27_000    # fixed cost per pair
_GATHER_COST = 870     # one element of the un-permuting gather
_PART_COST = 250_000   # per extra part: a launch and the y sum


def _bucket_plan(rows, cols, m, n):
    """Cost-optimal depth segmentation of the (slice, chunk) pairs
    (pallas_sell.py:212-267): pairs sorted by their own Kmax, split into
    contiguous segments minimising ``Σ count_b · (_PAIR_COST + kmax_b ·
    SLICE)`` plus ``_PART_COST`` per segment (exact interval DP over the
    distinct depths).  Returns ``(cost, slots, lbl_nnz, labels)``, where
    ``lbl_nnz`` maps each input nonzero to its segment."""
    nch = max(-(-n // CHUNK), 1)
    key = (rows // SLICE) * nch + cols // CHUNK
    order = np.lexsort((cols, rows, key))
    key_o, row_o = key[order], rows[order]
    new_grp = np.r_[True, (key_o[1:] != key_o[:-1])
                    | (row_o[1:] != row_o[:-1])]
    starts = np.where(new_grp, np.arange(len(key_o)), 0)
    k = np.arange(len(key_o)) - np.maximum.accumulate(starts)

    uniq = np.unique(key_o)
    pair_of = np.searchsorted(uniq, key_o)
    kmax_p = np.zeros(len(uniq), np.int64)
    np.maximum.at(kmax_p, pair_of, k + 1)

    # best[j] = least cost covering the first j depth groups
    depths, counts = np.unique(kmax_p, return_counts=True)
    d = len(depths)
    csum = np.r_[0, np.cumsum(counts)]
    best = np.full(d + 1, np.inf)
    best[0] = 0.0
    cut = np.zeros(d + 1, np.int64)
    for j in range(1, d + 1):
        for i in range(j):
            c = best[i] + _PART_COST + (csum[j] - csum[i]) * (
                _PAIR_COST + int(depths[j - 1]) * SLICE)
            if c < best[j]:
                best[j] = c
                cut[j] = i
    bounds = []
    j = d
    while j > 0:
        bounds.append((cut[j], j))
        j = cut[j]
    bounds.reverse()

    lbl_of_depth = np.zeros(d, np.int64)
    slots = 0
    for lb, (i, j) in enumerate(bounds):
        lbl_of_depth[i:j] = lb
        slots += int(csum[j] - csum[i]) * int(depths[j - 1]) * SLICE
    lbl_p = lbl_of_depth[np.searchsorted(depths, kmax_p)]
    lbl_nnz = np.empty(len(key_o), np.int64)
    lbl_nnz[order] = lbl_p[pair_of]          # back to input nnz order
    return float(best[d]), slots, lbl_nnz, np.arange(len(bounds))


def sell_bucketed_from_csr(csr, sort_rows="auto", device=None):
    """A CSRMatrix packed into cost-optimal depth-segmented SELL parts
    (pallas_sell.py:270-322).

    Pairs are partitioned by their own Kmax into the segments that
    minimise the cost model; each becomes a SELLMatrix with no coverage
    pairs.  With ``sort_rows``, a second plan is costed that first
    permutes rows by descending depth class (ceil log2 of the row's
    count, stable); it is taken when its cost plus the un-permuting
    gather beats the unsorted plan.  Returns a plain SELLMatrix when one
    unsorted segment is best, else a SELLBucketed.
    """
    rows = _host(csr.rows).astype(np.int64)
    cols = _host(csr.indices).astype(np.int64)
    vals = _host(csr.data)
    if len(vals) == 0:
        return sell_from_csr(csr, device=device)
    m, n = csr.shape

    cost, slots, lbl_nnz, labels = _bucket_plan(rows, cols, m, n)
    row_pos = None
    if sort_rows:
        counts = np.zeros(m, np.int64)
        np.add.at(counts, rows, 1)
        cls = np.ceil(np.log2(np.maximum(counts, 1) + 1e-9))
        if cls.max() != cls[counts > 0].min():
            order_rows = np.argsort(-cls, kind="stable")
            pos = np.empty(m, np.int64)
            pos[order_rows] = np.arange(m)
            cost_s, slots_s, lbl_s, labels_s = _bucket_plan(
                pos[rows], cols, m, n)
            if cost_s + m * _GATHER_COST < cost:
                slots, lbl_nnz, labels = slots_s, lbl_s, labels_s
                rows = pos[rows]
                row_pos = pos

    if len(labels) == 1 and row_pos is None:
        return sell_from_csr(csr, device=device)

    from .sparse import csr_from_coo
    parts = []
    for lb in labels:
        # through csr_from_coo, as the JAX package goes (duplicates summed)
        sel = lbl_nnz == lb
        part = csr_from_coo(rows[sel], cols[sel], vals[sel], (m, n),
                            device="cpu")
        parts.append(_sell_matrix(part.rows.numpy(), part.indices.numpy(),
                                  part.data.numpy(), (m, n), False,
                                  csr.data, device))
    return SELLBucketed(parts, (m, n), len(vals),
                        None if row_pos is None
                        else _placed(row_pos, csr.data, device))


def _acc_dtype(dtype):
    """The kernel's accumulation type: f32 for f32, bf16 and f16 x, else
    x's own type (pallas_sell.py:352-353)."""
    return torch.float32 if dtype in (torch.bfloat16, torch.float16,
                                      torch.float32) else dtype


def _check(A, x):
    P = A.data.shape[0]
    if 2 * P + 1 > _MAX_PAIR_WORDS:
        raise ValueError(
            f"SELL pair count {P} exceeds the pair budget of the JAX "
            "package's kernel; the pattern has no slice/chunk locality — "
            "keep CSR or pre-process with ops.hybrid.rcm_permute")
    if x.dim() != 1 or x.shape[0] != A.shape[1]:
        raise ValueError(f"x {tuple(x.shape)} does not match A {A.shape}")


def sell_spmv_ref(A, x):
    """Plain PyTorch y = A x for a SELLMatrix: x gathered by each pair's
    chunk and lane index (zeros past n), times the data in the
    accumulation type, the Kmax groups of eight rows summed, the pairs'
    tiles summed into their slices (a slice with no pair reads 0); the
    result in x's dtype."""
    _check(A, x)
    m, n = A.shape
    P, K8, _ = A.data.shape
    acc_t = _acc_dtype(x.dtype)
    nch = max(-(-n // CHUNK), 1)
    xp = torch.zeros(nch * CHUNK, dtype=acc_t, device=x.device)
    xp[:n] = x
    cols = A.chunk_of.long()[:, None, None] * CHUNK + A.idx.long()
    with full_fp32():
        prod = A.data.to(acc_t) * xp[cols]
        tiles = prod.reshape(P, K8 // 8, 8, CHUNK).sum(dim=1)
        out = torch.zeros((_nslices(m), 8, CHUNK), dtype=acc_t,
                          device=x.device)
        out.index_add_(0, A.slice_of[:P].long(), tiles)
    return out.reshape(-1)[:m].to(x.dtype)


def sell_spmv(A, x):
    """y = A x for a SELLMatrix: the kernel of ``csrc/sell_spmv.cu`` for a
    CUDA x, the plain version for a CPU one.  Raises for an (x, data)
    type pair with no kernel, and for more pairs than the JAX package's
    budget."""
    _check(A, x)
    if x.device.type == "cpu":
        return sell_spmv_ref(A, x)
    suffix = _SUFFIX.get((x.dtype, A.data.dtype))
    if suffix is None or not x.is_cuda:
        raise ValueError(f"no SELL SpMV kernel for x {x.dtype} with data "
                         f"{A.data.dtype} on {x.device}")
    arrays = (A.data, A.idx, A.chunk_of, A.slice_ptr)
    if not (all(a.device == x.device for a in arrays)
            and all(a.dtype == torch.int32 for a in arrays[1:])):
        raise ValueError("SELL data, int32 idx, chunk_of and slice_ptr and "
                         "x must be on one device")
    m, n = A.shape
    data, idx, chunk_of, slice_ptr = (a.contiguous() for a in arrays)
    x = x.contiguous()
    y = torch.empty(m, dtype=x.dtype, device=x.device)
    entry = f"ktt_sell_spmv_{suffix}"
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(_build.library(), entry)(
            data.data_ptr(), idx.data_ptr(), chunk_of.data_ptr(),
            slice_ptr.data_ptr(), x.data_ptr(), y.data_ptr(), A.kmax,
            _nslices(m), m, n, stream)
    sell_spmv.launches += 1
    _build.check(err, entry)
    return y


sell_spmv.launches = 0


def _bucketed(spmv, A, x):
    y = None
    for p in A.parts:
        yp = spmv(p, x)
        y = yp if y is None else y + yp
    if A.row_pos is not None:
        y = y[A.row_pos]                  # un-permute σ-sorted rows
    return y


def sell_bucketed_spmv(A, x):
    """y = A x for a SELLBucketed: one ``sell_spmv`` per part, summed in
    x's dtype, then un-permuted (pallas_sell.py:324-331)."""
    return _bucketed(sell_spmv, A, x)


def sell_bucketed_spmv_ref(A, x):
    """The plain version of ``sell_bucketed_spmv``."""
    return _bucketed(sell_spmv_ref, A, x)
