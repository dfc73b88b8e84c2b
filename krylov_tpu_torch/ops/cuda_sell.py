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
consecutive addresses.

``SELLBucketed`` is a sum of SELL parts, each packed at its own Kmax by
the JAX package's cost plan (``_bucket_plan``, its v5e constants kept so
that one CSR gives the same parts in both packages), optionally with
rows σ-sorted by depth class.  Its parts' slots live in one set of
buffers (``buffers``: data, idx, chunk_of and slice_ptr, each the parts'
arrays one after another; the parts' own tensors are views of them) and
a part table (``table``, int64, per part its data offset in slots, pair
offset, slice_ptr offset and Kmax); ``inv`` undoes the σ-sort.  A plain
``SELLMatrix`` is a table of one part.  ``sell_spmv`` launches the kernel
of ``csrc/sell_spmv.cu`` once for a CUDA x, over every part, and takes
the plain versions for a CPU x: ``sell_spmv_ref`` for a SELLMatrix,
``sell_table_spmv_ref`` (a walk of the table) for a SELLBucketed.  A
matrix binds its launch once per x type (types, devices, contiguity, the
entry point), so that a call makes one stream lookup and one foreign
call.

The ``*_from_csr`` functions run on the host with numpy and put their
result on their input's device (a CSR matrix's), numpy input on
``device``, by default the card; beside the JAX package's arrays a
``SELLMatrix`` keeps ``slice_ptr``, the first pair of each slice (nsl +
1 entries, int32), which the kernel walks.
"""

import weakref
from typing import NamedTuple

import numpy as np
import torch

from .. import _build
from .._runtime import full_fp32
from .cuda_dia import _SUFFIX, _run
from .cuda_spmv import _host, _placed

SLICE = 1024       # rows per slice
CHUNK = 128        # columns per chunk
# the most pairs a SELL matrix may hold: the JAX package's SMEM
# scalar-prefetch budget (pallas_sell.py:341-345), kept for parity
_MAX_PAIR_WORDS = 240_000


class SELLBuffers(NamedTuple):
    """A SELL matrix's slots as flat arrays, its parts one after another:
    data (slots), idx (int32, slots), chunk_of (int32, pairs), slice_ptr
    (int32, nsl + 1 per part)."""
    data: torch.Tensor
    idx: torch.Tensor
    chunk_of: torch.Tensor
    slice_ptr: torch.Tensor


# the arrays whose replacement unbinds a matrix's launch (and re-homes
# the parts of the SELLBucketed that holds it)
_ARRAYS = frozenset(("data", "idx", "slice_of", "chunk_of", "slice_ptr"))


class SELLMatrix:
    """Chunked sliced-ELL matrix (see the module docstring).

    data, idx: (P, Kmax·8, 128); slice_of: (P + 1,) int32 slice of each
    pair and a sentinel; chunk_of: (P,) int32 chunk of each pair;
    ``covered`` records whether every slice owns a pair.  slice_ptr:
    (nsl + 1,) int32, pairs [slice_ptr[s], slice_ptr[s + 1]) belong to
    slice s; computed from slice_of when not given.  A table of one part
    (``table``, ``buffers``, ``inv`` None).
    """

    _stale = False
    inv = None

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

    def __setattr__(self, name, value):
        object.__setattr__(self, name, value)
        if name in _ARRAYS:
            self.__dict__["_plans"] = {}
            owner = self.__dict__.get("_owner")
            owner = owner() if owner is not None else None
            if owner is not None:
                owner._stale = True

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

    @property
    def buffers(self):
        return SELLBuffers(self.data.reshape(-1), self.idx.reshape(-1),
                           self.chunk_of, self.slice_ptr)

    @property
    def table(self):
        """The part table of this one part: {0, 0, 0, Kmax}."""
        return torch.tensor([[0, 0, 0, self.kmax]], dtype=torch.int64,
                            device=self.device)

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

    y is the exact sum of the parts' products, un-permuted when rows were
    σ-sorted (``row_pos`` maps an original row to its sorted position;
    None when unsorted).  The parts' data, idx, chunk_of and slice_ptr
    are homed in one set of ``buffers``, which the part ``table`` indexes
    (see the module docstring), with ``inv`` (int32, the inverse of
    row_pos) beside them: parts built as views of one set of buffers
    (``sell_bucketed_from_csr``) keep them, parts made from separate
    tensors are copied into new buffers and re-pointed at them.  So an
    in-place change of a part's tensors is seen by the kernel; a part
    tensor replaced by another is homed again at the next product.
    """

    def __init__(self, parts, shape, nnz, row_pos=None):
        self.parts = tuple(parts)
        self.shape = tuple(int(s) for s in shape)
        self.nnz = int(nnz)
        self.row_pos = row_pos
        self._home()

    def __setattr__(self, name, value):
        object.__setattr__(self, name, value)
        if name in ("parts", "row_pos"):
            self._stale = True

    def _home(self):
        """Home the parts in one set of buffers and build the part table
        and inv."""
        parts = self.parts
        if not parts:
            raise ValueError("a SELLBucketed needs at least one part")
        if len({(p.data.dtype, p.data.device) for p in parts}) != 1:
            raise ValueError("SELL parts must share one data type and "
                             "device")
        bufs = []
        for name in SELLBuffers._fields:
            arrays = [getattr(p, name) for p in parts]
            buf = _shared_base(arrays)
            if buf is None:
                buf = torch.cat([a.reshape(-1) for a in arrays])
                off = 0
                for p, a in zip(parts, arrays):
                    setattr(p, name, buf[off:off + a.numel()].view(a.shape))
                    off += a.numel()
            bufs.append(buf)
        self.buffers = SELLBuffers(*bufs)
        rows, d, pr, sp = [], 0, 0, 0
        for p in parts:
            rows.append((d, pr, sp, p.kmax))
            d += p.data.numel()
            pr += p.chunk_of.numel()
            sp += p.slice_ptr.numel()
        self.table = torch.tensor(rows, dtype=torch.int64,
                                  device=parts[0].device)
        inv = None
        if self.row_pos is not None:
            pos = self.row_pos.long()
            inv = torch.empty(pos.shape, dtype=torch.int32,
                              device=pos.device)
            inv[pos] = torch.arange(pos.numel(), dtype=torch.int32,
                                    device=pos.device)
        self.inv = inv
        self._plans = {}
        for p in parts:
            p._owner = weakref.ref(self)
        self._stale = False

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
        return sell_spmv(self, x)


def _shared_base(arrays):
    """The flat tensor whose consecutive pieces ``arrays`` are (contiguous
    views, in order, covering it), else None."""
    base = arrays[0]._base
    if base is None or base.dim() != 1 or not base.is_contiguous():
        return None
    off = base.storage_offset()
    for a in arrays:
        if (a._base is not base or not a.is_contiguous()
                or a.storage_offset() != off):
            return None
        off += a.numel()
    return base if off == base.storage_offset() + base.numel() else None


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
    packed = []
    for lb in labels:
        # through csr_from_coo, as the JAX package goes (duplicates summed)
        sel = lbl_nnz == lb
        part = csr_from_coo(rows[sel], cols[sel], vals[sel], (m, n),
                            device="cpu")
        arrays = _sell_arrays(part.rows.numpy(), part.indices.numpy(),
                              part.data.numpy(), m, n, False)
        packed.append((part.nnz, arrays, _slice_ptr(arrays[2], m)))
    # the parts' slots in one set of buffers, one copy to the device each;
    # the parts are views of them
    bufs = SELLBuffers(*(
        _placed(np.concatenate([a.reshape(-1) for a in group]), csr.data,
                device)
        for group in zip(*((a[1][0], a[1][1], a[1][3], a[2])
                           for a in packed))))
    parts, offs = [], [0, 0, 0, 0]
    for nnz, (data, idx, slice_of, chunk_of, covered), ptr in packed:
        views = []
        for b, (buf, a) in enumerate(zip(bufs, (data, idx, chunk_of, ptr))):
            views.append(buf[offs[b]:offs[b] + a.size].view(a.shape))
            offs[b] += a.size
        parts.append(SELLMatrix(views[0], views[1],
                                _placed(slice_of, csr.data, device),
                                views[2], (m, n), nnz, covered, views[3]))
    return SELLBucketed(parts, (m, n), len(vals),
                        None if row_pos is None
                        else _placed(row_pos, csr.data, device))


def _acc_dtype(dtype):
    """The kernel's accumulation type: f32 for f32, bf16 and f16 x, else
    x's own type (pallas_sell.py:352-353)."""
    return torch.float32 if dtype in (torch.bfloat16, torch.float16,
                                      torch.float32) else dtype


def _check(A, x):
    for P in (p.data.shape[0] for p in getattr(A, "parts", (A,))):
        if 2 * P + 1 > _MAX_PAIR_WORDS:
            raise ValueError(
                f"SELL pair count {P} exceeds the pair budget of the JAX "
                "package's kernel; the pattern has no slice/chunk locality "
                "— keep CSR or pre-process with ops.hybrid.rcm_permute")
    if x.dim() != 1 or x.shape[0] != A.shape[1]:
        raise ValueError(f"x {tuple(x.shape)} does not match A {A.shape}")


def _sell_ref(data, idx, slice_of, chunk_of, m, n, x):
    """One part's plain product: x gathered by each pair's chunk and lane
    index (zeros past n), times the data in the accumulation type, the
    Kmax groups of eight rows summed, the pairs' tiles summed into their
    slices (a slice with no pair reads 0); in x's dtype."""
    P, K8, _ = data.shape
    acc_t = _acc_dtype(x.dtype)
    nch = max(-(-n // CHUNK), 1)
    xp = torch.zeros(nch * CHUNK, dtype=acc_t, device=x.device)
    xp[:n] = x
    cols = chunk_of.long()[:, None, None] * CHUNK + idx.long()
    with full_fp32():
        prod = data.to(acc_t) * xp[cols]
        tiles = prod.reshape(P, K8 // 8, 8, CHUNK).sum(dim=1)
        out = torch.zeros((_nslices(m), 8, CHUNK), dtype=acc_t,
                          device=x.device)
        out.index_add_(0, slice_of.long(), tiles)
    return out.reshape(-1)[:m].to(x.dtype)


def sell_spmv_ref(A, x):
    """Plain PyTorch y = A x for a SELLMatrix: x gathered by each pair's
    chunk and lane index (zeros past n), times the data in the
    accumulation type, the Kmax groups of eight rows summed, the pairs'
    tiles summed into their slices (a slice with no pair reads 0); the
    result in x's dtype."""
    _check(A, x)
    P = A.data.shape[0]
    return _sell_ref(A.data, A.idx, A.slice_of[:P], A.chunk_of, *A.shape, x)


def sell_table_spmv_ref(A, x, y_dia=None):
    """Plain PyTorch version of the one-launch product of a SELLMatrix or
    SELLBucketed: a walk of its part table at the kernel's rounding
    points.  Each part, read from the buffers at the table's offsets, is
    summed as ``sell_spmv_ref`` sums it and rounded to x's dtype; the
    parts are summed in x's dtype in part order; ``inv`` sends sorted row
    s to row inv[s]; with ``y_dia`` the result is y_dia + that sum."""
    _check(A, x)
    if A._stale:
        A._home()
    m, n = A.shape
    nsl = _nslices(m)
    buf = A.buffers
    y = None
    for doff, poff, soff, kmax in A.table.tolist():
        ptr = buf.slice_ptr[soff:soff + nsl + 1].long()
        P = int(ptr[-1])
        slots = slice(doff, doff + P * kmax * SLICE)
        slice_of = torch.repeat_interleave(
            torch.arange(nsl, device=ptr.device), ptr.diff())
        yp = _sell_ref(buf.data[slots].view(P, kmax * 8, CHUNK),
                       buf.idx[slots].view(P, kmax * 8, CHUNK), slice_of,
                       buf.chunk_of[poff:poff + P], m, n, x)
        y = yp if y is None else y + yp
    if A.inv is not None:
        out = torch.empty_like(y)
        out[A.inv.long()] = y
        y = out
    return y if y_dia is None else y_dia + y


def _bind(A, x):
    """A's launch for x's type: everything that depends on the matrix
    alone, checked once.  Raises for an (x, data) type pair with no
    kernel, for tensors on other devices and for more pairs than the JAX
    package's budget."""
    _check(A, x)
    suffix = _SUFFIX.get((x.dtype, A.data.dtype if not hasattr(A, "parts")
                          else A.parts[0].data.dtype))
    if suffix is None or not x.is_cuda:
        raise ValueError(f"no SELL SpMV kernel for x {x.dtype} with data "
                         f"{A.dtype} on {x.device}")
    buf = tuple(a.contiguous() for a in A.buffers)
    table = A.table
    extra = (table,) if A.inv is None else (table, A.inv)
    if not (all(a.device == x.device for a in buf + extra)
            and all(a.dtype == torch.int32 for a in buf[1:])):
        raise ValueError("SELL data, int32 idx, chunk_of and slice_ptr and "
                         "x must be on one device")
    m, n = A.shape
    name = f"ktt_sell_spmv_{suffix}"
    inv = 0 if A.inv is None else A.inv.data_ptr()
    plan = ((name, getattr(_build.library(), name)),
            (*(a.data_ptr() for a in buf), table.data_ptr(), table.shape[0],
             inv),
            (_nslices(m), m, n), x.device, (n,), (buf, extra))
    A._plans[x.dtype] = plan
    return plan


def _launch(A, x, y_dia=None):
    """One launch of the SELL kernel over A's part table."""
    if A._stale:
        A._home()
    plan = A._plans.get(x.dtype)
    if (plan is None or x.device != plan[3] or x.shape != plan[4]
            or not x.is_contiguous()):
        x = x.contiguous()
        plan = _bind(A, x)
    bound, head, tail, dev = plan[:4]
    y = torch.empty(tail[1], dtype=x.dtype, device=dev)
    _run(bound, sell_spmv, dev,
         (*head, x.data_ptr(), 0 if y_dia is None else y_dia.data_ptr(),
          y.data_ptr(), *tail))
    return y


def sell_spmv(A, x):
    """y = A x for a SELLMatrix or a SELLBucketed: one launch of the kernel
    of ``csrc/sell_spmv.cu`` over every part for a CUDA x, the plain
    versions for a CPU one.  Raises for an (x, data) type pair with no
    kernel, and for more pairs than the JAX package's budget."""
    if x.device.type == "cpu":
        if isinstance(A, SELLBucketed):
            return sell_table_spmv_ref(A, x)
        return sell_spmv_ref(A, x)
    return _launch(A, x)


sell_spmv.launches = 0


def sell_hybrid_spmv(A, x, y_dia):
    """y_dia + A x in x's type for a SELLMatrix or SELLBucketed A: the
    SELL half of a hybrid product, one launch that also adds the DIA
    half on the card, the table walk on the CPU."""
    if x.device.type == "cpu":
        return sell_table_spmv_ref(A, x, y_dia)
    return _launch(A, x, y_dia)


def _bucketed(spmv, A, x):
    y = None
    for p in A.parts:
        yp = spmv(p, x)
        y = yp if y is None else y + yp
    if A.row_pos is not None:
        y = y[A.row_pos]                  # un-permute σ-sorted rows
    return y


def sell_bucketed_spmv(A, x):
    """y = A x for a SELLBucketed (pallas_sell.py:324-331): one
    ``sell_spmv`` launch over all its parts on the card, the table walk
    on the CPU."""
    return sell_spmv(A, x)


def sell_bucketed_spmv_parts(A, x):
    """The per-part composition: ``sell_spmv`` launched on each part alone,
    the results summed in x's dtype in part order and un-permuted by a
    gather, as PyTorch ops.  The one-launch product equals it bit for
    bit."""
    return _bucketed(sell_spmv, A, x)


def sell_bucketed_spmv_ref(A, x):
    """The plain version of ``sell_bucketed_spmv``: ``sell_spmv_ref`` on
    each part, summed and un-permuted as ``sell_bucketed_spmv_parts``
    does."""
    return _bucketed(sell_spmv_ref, A, x)
