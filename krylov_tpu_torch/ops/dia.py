"""DIA (diagonal) sparse format, counterpart of ``krylov_tpu/ops/dia.py``.

Banded matrices (finite-difference stencils like the reference's
get_div_grad Poisson operator, test/get_div_grad.jl:8-19) store one
dense vector per nonzero diagonal.  The storage is column-indexed, as in
SciPy: ``data[d, j]`` holds ``A[j - k_d, j]``.  ``dia_spmv`` here is the
plain shift-and-add product; the CUDA kernel in ``ops/cuda_dia.py``
works on output-aligned diagonals instead.
"""

import numpy as np
import torch


def resolve_device(device):
    """The torch device for a constructor's ``device=`` argument.

    Constructors default to the card.  Without one they raise: the port
    never falls back to the CPU on its own; callers that want the CPU
    say ``device="cpu"``.
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to build on "
            "the CPU")
    return device


class DIAMatrix:
    """Square banded matrix: data[d] holds diagonal `offsets[d]`.

    Row convention (scipy.sparse.dia compatible): ``A[i, i+k] =
    data[d, i+k]``.  Equivalently y = Σ_d shift(data[d] * x, -k_d) with
    entries outside [0, n) dropped.
    """

    def __init__(self, data, offsets, shape, device="cuda"):
        self.data = torch.as_tensor(data, device=resolve_device(device))
        self.offsets = tuple(int(o) for o in offsets)
        self.shape = tuple(int(s) for s in shape)
        if self.data.shape != (len(self.offsets), self.shape[0]):
            raise ValueError(
                f"data has shape {tuple(self.data.shape)}, expected "
                f"{(len(self.offsets), self.shape[0])}")

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def device(self):
        return self.data.device

    @property
    def nnz(self):
        n = self.shape[0]
        return sum(max(n - abs(k), 0) for k in self.offsets)

    def __matmul__(self, x):
        return dia_spmv(self.data, self.offsets, x)

    def todense(self):
        n = self.shape[0]
        data = self.data.cpu().numpy()
        A = np.zeros((n, n), dtype=data.dtype)
        for d, k in enumerate(self.offsets):
            for i in range(max(0, -k), min(n, n - k)):
                A[i, i + k] = data[d, i + k]
        return torch.as_tensor(A, device=self.device)


def dia_spmv(data, offsets, x):
    """y = A x for a DIA matrix, one shifted multiply-add per diagonal."""
    n = x.shape[0]
    y = torch.zeros_like(x)
    for d, k in enumerate(offsets):
        if abs(k) >= n:
            continue
        prod = data[d] * x
        if k == 0:
            y = y + prod
        elif k > 0:
            # y[i] += data[d, i+k] * x[i+k]  for i in [0, n-k)
            y[: n - k] += prod[k:]
        else:
            # y[i] += data[d, i+k] * x[i+k]  for i in [-k, n)
            y[-k:] += prod[: n + k]
    return y


def dia_spmm(data, offsets, X):
    """Y = A X for a block of column vectors (n, p): ``dia_spmv`` on every
    column at once, in the same order of terms."""
    n = X.shape[0]
    Y = torch.zeros_like(X)
    for d, k in enumerate(offsets):
        if abs(k) >= n:
            continue
        prod = data[d][:, None] * X
        if k == 0:
            Y = Y + prod
        elif k > 0:
            Y[: n - k] += prod[k:]
        else:
            Y[-k:] += prod[: n + k]
    return Y


def dia_from_scipy(A_scipy, dtype=None, device="cuda"):
    """Build a DIAMatrix from any scipy.sparse matrix (host-side)."""
    import scipy.sparse as sp
    D = sp.dia_matrix(A_scipy)
    data = np.asarray(D.data)
    if dtype is not None:
        data = data.astype(dtype)
    return DIAMatrix(data, tuple(int(o) for o in D.offsets), D.shape,
                     device=device)


def _torch_dtype(dtype):
    """A torch dtype from a torch or numpy dtype (bfloat16 has no numpy one)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.zeros(0, dtype=dtype)).dtype


def _stencil(n1, n2, n3, dtype, device, xm, xp):
    """DIAMatrix of the 7-point stencil: centre 6, x-neighbours xm
    (A[i, i-1]) and xp (A[i, i+1]), y and z neighbours -1.  Built on the
    target device."""
    device = resolve_device(device)
    n = n1 * n2 * n3
    offs = (-n1 * n2, -n1, -1, 0, 1, n1, n1 * n2)
    data = torch.zeros((7, n), dtype=_torch_dtype(dtype), device=device)
    data[3] = 6.0
    idx = torch.arange(n, device=device)
    ix = idx % n1
    iy = (idx // n1) % n2
    iz = idx // (n1 * n2)
    # offset +1 stores A[i, i+1] at data[., i+1]: valid when (i+1) % n1 != 0
    data[4][ix != 0] = xp                   # column index i+1 has ix!=0
    data[2][ix != n1 - 1] = xm              # A[i, i-1] at data[., i-1]
    data[5][iy != 0] = -1.0
    data[1][iy != n2 - 1] = -1.0
    data[6][iz != 0] = -1.0
    data[0][iz != n3 - 1] = -1.0
    return DIAMatrix(data, offs, (n, n), device=device)


def convdiff_dia(n1, n2=None, n3=None, pe=0.3, dtype=np.float32,
                 device="cuda"):
    """Nonsymmetric 3-D convection-diffusion stencil in DIA form.

    -Δu + β·uₓ on the unit-grid 7-point stencil with central differences:
    diagonal 6, x-neighbors -(1 ± pe) where ``pe`` = β·h/2 is the cell
    Péclet number, y/z neighbors -1.
    """
    n2 = n1 if n2 is None else n2
    n3 = n1 if n3 is None else n3
    return _stencil(n1, n2, n3, dtype, device, -(1.0 + pe), -(1.0 - pe))


def poisson_dia(n1, n2=None, n3=None, dtype=np.float32, device="cuda"):
    """The reference's get_div_grad 3-D Poisson operator in DIA form
    (test/get_div_grad.jl:8-19), built directly from the stencil:
    A = Div Divᵀ, diagonal 6 (2 per dimension), off-diagonals -1 at
    offsets ±1 (within x-lines), ±n1 (y), ±n1·n2 (z)."""
    n2 = n1 if n2 is None else n2
    n3 = n1 if n3 is None else n3
    return _stencil(n1, n2, n3, dtype, device, -1.0, -1.0)
