"""DIA SpMV on output-aligned diagonals: the CUDA kernels and their plain
versions (counterpart of ``krylov_tpu/ops/pallas_dia.py``).

``dia_align`` shifts the stored diagonals once so that
y[i] = Σ_d pd[d, i]·x[i+k_d].  ``dia_spmv_aligned`` launches the kernel
of ``csrc/dia_spmv.cu`` for a CUDA tensor and takes the plain version,
``dia_spmv_aligned_ref``, for a CPU tensor.  ``dia_spmv_padded`` is the
same product in a padded, chainable layout (``dia_pad_layout``).  Both
validate their arguments on every call; ``DIASpMV`` validates a matrix
once (``DIAOperator`` and ``HybridMatrix`` hold one), so that its call
checks x and makes one stream lookup and one foreign call.  The entry
points are looked up once per type pair and the offsets' values read
from the card once per offsets tensor.
"""

import functools

import torch

from .. import _build

# (x dtype, pd dtype) → the C entry points' type suffix.  The kernel
# accumulates in f32 for f32, bf16 and f16 x, in f64 for f64 x and in
# x's complex type for complex x (pallas_dia.py:165-166).
_SUFFIX = {
    (torch.float32, torch.float32): "f32_f32",
    (torch.float32, torch.bfloat16): "f32_bf16",
    (torch.float32, torch.float16): "f32_f16",
    (torch.float64, torch.float64): "f64_f64",
    (torch.float64, torch.float32): "f64_f32",
    (torch.bfloat16, torch.bfloat16): "bf16_bf16",
    (torch.float16, torch.float16): "f16_f16",
    (torch.complex64, torch.float32): "c64_f32",
    (torch.complex64, torch.complex64): "c64_c64",
    (torch.complex128, torch.float64): "c128_f64",
    (torch.complex128, torch.complex128): "c128_c128",
}
# the halo of the padded layout is a multiple of this many rows
HALO_ROWS = 32


def _span(k, n):
    """Rows [lo, hi) whose neighbour i + k lies in [0, n)."""
    return max(0, -k), min(n, n - k)


def dia_align(data, offsets, n):
    """Output-aligned diagonals: pd[d, i] = data[d, i+k_d] (0 outside).

    One-time O(nnz) device op; cache the result next to the matrix.
    """
    pd = torch.zeros_like(data)
    for d, k in enumerate(offsets):
        lo, hi = _span(k, n)
        if lo < hi:
            pd[d, lo:hi] = data[d, lo + k:hi + k]
    return pd


def offsets_tensor(offsets, device):
    """The diagonal offsets as the int64 tensor the kernels take."""
    return torch.tensor([int(k) for k in offsets], dtype=torch.int64,
                        device=device)


def _acc_dtype(dtype):
    return torch.float32 if dtype in (torch.bfloat16, torch.float16) \
        else dtype


def dia_spmv_aligned_ref(pd, offsets, x):
    """Plain PyTorch y = A x from aligned diagonals; ``offsets`` is an
    int64 tensor.  Accumulates one diagonal after another in the kernel's
    type: f32 for f32, bf16 and f16 x, else x's own type."""
    n = x.shape[0]
    acc_t = _acc_dtype(x.dtype)
    xa = x.to(acc_t)
    acc = torch.zeros_like(xa)
    for d, k in enumerate(offsets.tolist()):
        lo, hi = _span(k, n)
        if lo < hi:
            acc[lo:hi] += pd[d, lo:hi].to(acc_t) * xa[lo + k:hi + k]
    return acc.to(x.dtype)


def _check(pd, offsets, x):
    n = x.shape[0]
    if x.dim() != 1 or pd.dim() != 2 or pd.shape[1] != n:
        raise ValueError(f"pd {tuple(pd.shape)} and x {tuple(x.shape)} do "
                         "not match: want pd (nd, n), x (n,)")
    if offsets.dtype != torch.int64 or offsets.shape != (pd.shape[0],):
        raise ValueError("offsets must be an int64 tensor of length nd")
    if not (pd.device == x.device == offsets.device):
        raise ValueError("pd, offsets and x must be on one device")
    if not (pd.is_contiguous() and x.is_contiguous()
            and offsets.is_contiguous()):
        raise ValueError("pd, offsets and x must be contiguous")


def _entry(kind, x, pd):
    """The C entry point for x and pd on the card; raises naming the pair
    where there is none."""
    suffix = _SUFFIX.get((x.dtype, pd.dtype))
    if suffix is None or x.device.type != "cuda":
        raise ValueError(f"no DIA SpMV kernel for x {x.dtype} with pd "
                         f"{pd.dtype} on {x.device}")
    return f"ktt_{kind}_{suffix}"


def _interior(offsets, n):
    """Rows [lo, hi) whose every neighbour i + k_d lies in [0, n): the rows
    the kernel sums with no bounds branch.  Empty (lo == hi) where no row
    has all its neighbours, [0, n) where there is no diagonal."""
    if not offsets:
        return 0, n
    lo = min(n, max(0, -min(offsets)))
    return lo, max(lo, min(n, n - max(offsets)))


def _host_offsets(offsets):
    """The values of an offsets tensor as a tuple of ints, read from the
    card once and kept on the tensor until an in-place change."""
    return _kept(offsets)[1]


def _kept(offsets):
    version = None if offsets.is_inference() else offsets._version
    kept = getattr(offsets, "_ktt_host", None)
    if kept is None or kept[0] != version or version is None:
        kept = (version, tuple(int(k) for k in offsets.tolist()), {})
        offsets._ktt_host = kept
    return kept


def _kernel_span(host, n):
    """(lo, hi, max |k|): the interior and the widest offset, what the
    kernel takes beside the offsets."""
    return (*_interior(host, n), max((abs(k) for k in host), default=0))


def _tensor_span(offsets, n):
    """_kernel_span of an offsets tensor's values, kept on the tensor."""
    _, host, spans = _kept(offsets)
    if n not in spans:
        spans[n] = _kernel_span(host, n)
    return spans[n]


_BOUND = {}


@functools.cache
def _many_cards():
    return torch.cuda.device_count() > 1


def _bound(kind, x, pd):
    """(name, C function) of ``kind``'s entry point for x and pd on the
    card, looked up once per type pair; raises naming the pair where
    there is none."""
    key = (kind, x.dtype, pd.dtype)
    hit = _BOUND.get(key)
    if hit is None:
        name = _entry(kind, x, pd)
        hit = _BOUND[key] = (name, getattr(_build.library(), name))
    return hit


def _run(bound, wrapper, device, args):
    """One foreign call of a bound entry point on ``device``'s current
    stream, counted on ``wrapper``; raises on a CUDA error."""
    name, fn = bound
    index = device.index
    if _many_cards() and torch.cuda.current_device() != index:
        with torch.cuda.device(index):
            err = fn(*args, _build.current_stream(index))
    else:
        err = fn(*args, _build.current_stream(index))
    wrapper.launches += 1
    if err:
        _build.check(err, name)


class DIASpMV:
    """y = A x from aligned diagonals ``pd`` (nd, n) and ``offsets``, an
    int64 tensor on pd's device whose values are ``host_offsets`` (read
    from it when not given), validated once.

    A call checks x's type, device, length and contiguity against what
    the last one bound, then makes one stream lookup and one foreign call
    to the kernel of ``csrc/dia_spmv.cu`` (counted on
    ``dia_spmv_aligned.launches``); a CPU x takes the plain version.  An
    in-place change of pd is seen by the next call; a changed offsets
    tensor needs a new ``DIASpMV``.
    """

    def __init__(self, pd, offsets, host_offsets=None):
        if pd.dim() != 2 or not pd.is_contiguous():
            raise ValueError(f"pd {tuple(pd.shape)} must be a contiguous "
                             "(nd, n) tensor")
        if (offsets.dtype != torch.int64 or offsets.shape != (pd.shape[0],)
                or not offsets.is_contiguous()
                or offsets.device != pd.device):
            raise ValueError("offsets must be a contiguous int64 tensor of "
                             "length nd on pd's device")
        self.pd, self.offsets = pd, offsets
        host = _host_offsets(offsets) if host_offsets is None \
            else tuple(int(k) for k in host_offsets)
        if len(host) != pd.shape[0]:
            raise ValueError("host_offsets do not match pd")
        self.n = pd.shape[1]
        self.device = pd.device
        self._x_shape = (self.n,)
        self._tail = (self.n, *_kernel_span(host, self.n))
        self._plans = {}

    def __call__(self, x):
        plan = self._plans.get(x.dtype)
        if (plan is None or x.device != self.device
                or x.shape != self._x_shape or not x.is_contiguous()):
            _check(self.pd, self.offsets, x)
            if x.device.type == "cpu":
                return dia_spmv_aligned_ref(self.pd, self.offsets, x)
            plan = self._plans[x.dtype] = (
                _bound("dia_spmv", x, self.pd),
                (self.pd.data_ptr(), self.offsets.data_ptr(),
                 self.pd.shape[0]))
        y = torch.empty_like(x)
        _run(plan[0], dia_spmv_aligned, self.device,
             (*plan[1], x.data_ptr(), y.data_ptr(), *self._tail))
        return y


def dia_spmv_aligned(pd, offsets, x):
    """y = A x from aligned diagonals ``pd`` (see dia_align).

    ``offsets`` is an int64 tensor on x's device.  A CUDA tensor goes
    through the kernel; a CPU tensor through the plain version.  Checks
    its arguments on every call; ``DIASpMV`` checks the matrix once.
    """
    _check(pd, offsets, x)
    if x.device.type == "cpu":
        return dia_spmv_aligned_ref(pd, offsets, x)
    bound = _bound("dia_spmv", x, pd)
    y = torch.empty_like(x)
    n = x.shape[0]
    _run(bound, dia_spmv_aligned, x.device,
         (pd.data_ptr(), offsets.data_ptr(), pd.shape[0], x.data_ptr(),
          y.data_ptr(), n, *_tensor_span(offsets, n)))
    return y


dia_spmv_aligned.launches = 0


# ---------------------------------------------------------------------------
# the padded, chainable layout (pallas_dia.py:207-226)
# ---------------------------------------------------------------------------

def halo_width(offsets):
    """Rows of halo on each side of the padded layout: the largest
    |offset| rounded up to a multiple of HALO_ROWS (at least HALO_ROWS)."""
    m = max((abs(int(k)) for k in offsets), default=0)
    return max(1, -(-m // HALO_ROWS)) * HALO_ROWS


def dia_pad_layout(x, offsets):
    """x in the padded layout: a vector of length n + 2h whose rows
    [h, h + n) hold x and whose halo rows are zero."""
    h = halo_width(offsets)
    xw = torch.zeros(x.shape[0] + 2 * h, dtype=x.dtype, device=x.device)
    xw[h:h + x.shape[0]] = x
    return xw


def dia_unpad_layout(xw, offsets, n):
    """The interior of a padded vector (a view); inverse of
    dia_pad_layout."""
    h = halo_width(offsets)
    return xw[h:h + n]


def _halo(pd, offsets, xw, n):
    _check(pd, offsets, xw[:n])
    h, odd = divmod(xw.shape[0] - n, 2)
    if xw.dim() != 1 or h < 0 or odd:
        raise ValueError(f"xw of shape {tuple(xw.shape)} is not a padded "
                         f"layout of n = {n}")
    return h


def dia_spmv_padded_ref(pd, offsets, xw, n):
    """Plain PyTorch version of ``dia_spmv_padded``: the interior of the
    result is the aligned product of the interior of ``xw``; its halo is
    left as ``torch.empty`` made it."""
    h = _halo(pd, offsets, xw, n)
    yw = torch.empty_like(xw)
    yw[h:h + n] = dia_spmv_aligned_ref(pd, offsets, xw[h:h + n])
    return yw


def dia_spmv_padded(pd, offsets, xw, n):
    """y = A x in the padded layout of ``dia_pad_layout`` — chainable.

    ``xw`` holds x in rows [h, h + n) of a vector of length n + 2h; its
    halo rows are don't-care (the kernel reads only the interior).  The
    result has the same layout, and its halo is never written, so it
    feeds the next product as it is.  ``offsets`` is an int64 tensor on
    xw's device.  A CUDA tensor goes through the kernel of
    ``csrc/dia_spmv.cu``; a CPU tensor through the plain version.
    """
    h = _halo(pd, offsets, xw, n)
    if xw.device.type == "cpu":
        return dia_spmv_padded_ref(pd, offsets, xw, n)
    bound = _bound("dia_spmv_padded", xw, pd)
    yw = torch.empty_like(xw)
    _run(bound, dia_spmv_padded, xw.device,
         (pd.data_ptr(), offsets.data_ptr(), pd.shape[0], xw.data_ptr(),
          yw.data_ptr(), n, h, *_tensor_span(offsets, n)))
    return yw


dia_spmv_padded.launches = 0


def dia_align_adjoint(pd, offsets, n):
    """Output-aligned diagonals of Aᴴ from those of A (the JAX package's
    ``pallas_fused.dia_align_adjoint``).

    With y[i] = Σ_d pd[d, i]·x[i+k_d], (Aᴴu)[j] = Σ_d conj(pd[d, j−k_d])·
    u[j−k_d]: the offsets negate and each aligned diagonal shifts by +k_d.
    Returns (pd_adj, offsets_adj) with the offsets as a tuple.  One-time
    O(nnz) device op.
    """
    pd_adj = torch.zeros_like(pd)
    for d, k in enumerate(offsets):
        k = int(k)
        lo, hi = _span(-k, n)
        if lo < hi:
            pd_adj[d, lo:hi] = torch.conj(pd[d, lo - k:hi - k])
    return pd_adj, tuple(-int(k) for k in offsets)
