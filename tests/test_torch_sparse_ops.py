"""The port's CSR storage, its adjoint operators and ``knorm_elliptic``
against krylov_tpu's (krylov_tpu/ops/sparse.py, operators.py:47-100,
200-249 and 320-328, ops/kops.py:43).

Inputs are made with numpy from a seed and given to both packages; a
JAX ``CSRMatrix`` goes to the port through ``convert.csr_from_numpy``.
Tolerances: products agree to 1e-12 of their largest entry in f64 and
c128 (sums run in another order); the structure of Aᴴ (indices,
indptr, rows) and the aligned adjoint diagonals are equal exactly.
"""

import numpy as np
import jax.numpy as jnp
import pytest
torch = pytest.importorskip("torch")

import krylov_tpu as kj
import krylov_tpu.ops.pallas_fused as jf
import krylov_tpu.ops.sparse as js
import krylov_tpu_torch as kt
from krylov_tpu.operators import (CSROperator as JCSROperator,
                                  DIAOperator as JDIAOperator)
from krylov_tpu.ops.dia import convdiff_dia as jconvdiff
from krylov_tpu.ops.kops import knorm_elliptic as jknorm_elliptic
from krylov_tpu.ops.pallas_dia import dia_align as jdia_align
from krylov_tpu_torch.convert import csr_from_numpy, dia_from_numpy
from krylov_tpu_torch.ops import sparse as ts
from krylov_tpu_torch.ops.cuda_dia import dia_align, dia_align_adjoint

DTYPES = [np.float64, np.complex128]


def _rel(a, b):
    a, b = np.asarray(a, np.complex128), np.asarray(b, np.complex128)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300)


def _coo(m, n, nnz, dtype, seed=3):
    """Seeded COO triplets with duplicates (csr_from_coo sums them)."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, m, nnz)
    cols = rng.integers(0, n, nnz)
    vals = rng.standard_normal(nnz)
    if np.dtype(dtype).kind == "c":
        vals = vals + 1j * rng.standard_normal(nnz)
    return rows, cols, vals.astype(dtype)


def _vec(n, dtype, seed=5, cols=None):
    rng = np.random.default_rng(seed)
    shape = (n,) if cols is None else (n, cols)
    v = rng.standard_normal(shape)
    if np.dtype(dtype).kind == "c":
        v = v + 1j * rng.standard_normal(shape)
    return v.astype(dtype)


def _port_csr(C):
    return csr_from_numpy(np.asarray(C.data), np.asarray(C.indices),
                          np.asarray(C.indptr), np.asarray(C.rows), C.shape,
                          device="cpu")


@pytest.mark.parametrize("dtype", DTYPES)
def test_csr_from_coo_matches_jax(dtype):
    rows, cols, vals = _coo(13, 9, 60, dtype)
    Cj = js.csr_from_coo(rows, cols, vals, (13, 9))
    Ct = ts.csr_from_coo(rows, cols, vals, (13, 9), device="cpu")
    for f in ("indices", "indptr", "rows"):
        assert np.array_equal(getattr(Ct, f).numpy(),
                              np.asarray(getattr(Cj, f)))
    assert _rel(Ct.data.numpy(), Cj.data) <= 1e-15
    assert Ct.nnz == Cj.nnz and Ct.shape == Cj.shape
    assert _rel(Ct.todense().numpy(), Cj.todense()) <= 1e-15


@pytest.mark.parametrize("dtype", DTYPES)
def test_spmv_spmm_transpose_conj_match_jax(dtype):
    rows, cols, vals = _coo(13, 9, 60, dtype)
    Cj = js.csr_from_coo(rows, cols, vals, (13, 9))
    Ct = _port_csr(Cj)
    x, X = _vec(9, dtype), _vec(9, dtype, cols=3)
    assert _rel(ts.spmv(Ct, torch.as_tensor(x)).numpy(),
                js.spmv(Cj, jnp.asarray(x))) <= 1e-12
    assert _rel(ts.spmm(Ct, torch.as_tensor(X)).numpy(),
                js.spmm(Cj, jnp.asarray(X))) <= 1e-12
    assert _rel((Ct @ torch.as_tensor(X)).numpy(), Cj @ jnp.asarray(X)) \
        <= 1e-12
    Hj, Ht = Cj.transpose_conj(), Ct.transpose_conj()
    assert Ht.shape == Hj.shape == (9, 13)
    for f in ("indices", "indptr", "rows"):
        assert np.array_equal(getattr(Ht, f).numpy(),
                              np.asarray(getattr(Hj, f)))
    assert _rel(Ht.data.numpy(), Hj.data) <= 1e-15
    u = _vec(13, dtype, seed=6)
    assert _rel(ts.spmv(Ht, torch.as_tensor(u)).numpy(),
                js.spmv(Hj, jnp.asarray(u))) <= 1e-12


def test_csr_from_dense_matches_jax():
    A = _vec(8, np.float64, cols=8)
    A[np.abs(A) < 0.7] = 0.0
    Cj = js.csr_from_dense(A)
    Ct = ts.csr_from_dense(torch.as_tensor(A))
    assert Ct.device.type == "cpu"
    assert np.array_equal(Ct.indptr.numpy(), np.asarray(Cj.indptr))
    assert _rel(Ct.todense().numpy(), A) == 0.0


def _operators(dtype):
    """(name, JAX operator, port operator) of each kind, on one matrix."""
    rng = np.random.default_rng(9)
    n = 12
    A = rng.standard_normal((n, n))
    d = rng.standard_normal(n) + 3.0
    if np.dtype(dtype).kind == "c":
        A = A + 1j * rng.standard_normal((n, n))
        d = d + 1j * rng.standard_normal(n)
    A, d = A.astype(dtype), d.astype(dtype)
    A[np.abs(A) < 0.8] = 0.0
    Cj = js.csr_from_dense(A)
    At, dt = torch.as_tensor(A), torch.as_tensor(d)
    return [
        ("matrix", kj.MatrixOperator(jnp.asarray(A)), kt.MatrixOperator(At)),
        ("diagonal", kj.DiagonalOperator(jnp.asarray(d)),
         kt.DiagonalOperator(dt)),
        ("csr", JCSROperator(Cj).with_adjoint(),
         kt.CSROperator(_port_csr(Cj)).with_adjoint()),
        ("function", kj.FunctionOperator(
            lambda v: jnp.asarray(A) @ v, (n, n), dtype,
            rmatvec=lambda v: jnp.conj(jnp.asarray(A)).T @ v),
         kt.FunctionOperator(lambda v: At @ v, (n, n), At.dtype,
                             rmatvec=lambda v: At.conj().T @ v)),
    ]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", ["matrix", "diagonal", "csr", "function"])
def test_adjoint_operator_matches_jax(dtype, kind):
    name, Oj, Ot = next(o for o in _operators(dtype) if o[0] == kind)
    n = Ot.shape[0]
    x, X = _vec(n, dtype, seed=1), _vec(n, dtype, seed=2, cols=3)
    xt, Xt = torch.as_tensor(x), torch.as_tensor(X)
    assert isinstance(Ot.H, kt.AdjointOperator)
    assert Ot.H.shape == (Ot.shape[1], Ot.shape[0])
    assert Ot.H.H is Ot and Ot.T.H is Ot
    for jop, top in ((Oj, Ot), (Oj.H, Ot.H), (Oj.T, Ot.T)):
        assert _rel(top.matvec(xt).numpy(), jop.matvec(jnp.asarray(x))) \
            <= 1e-12
        assert _rel(top.rmatvec(xt).numpy(), jop.rmatvec(jnp.asarray(x))) \
            <= 1e-12
        assert _rel(top.matmat(Xt).numpy(), jop.matmat(jnp.asarray(X))) \
            <= 1e-12
        assert _rel(top.rmatmat(Xt).numpy(), jop.rmatmat(jnp.asarray(X))) \
            <= 1e-12
        assert _rel((top @ Xt).numpy(), jop @ jnp.asarray(X)) <= 1e-12
        assert _rel((top @ xt).numpy(), jop @ jnp.asarray(x)) <= 1e-12


def test_identity_and_csr_without_adjoint():
    I = kt.IdentityOperator(4)
    X = torch.ones((4, 2), dtype=torch.float64)
    assert I.H is I and torch.equal(I.matmat(X), X)
    assert torch.equal(I.rmatmat(X), X)
    C = ts.csr_from_dense(torch.eye(4, dtype=torch.float64))
    op = kt.as_operator(C)
    assert isinstance(op, kt.CSROperator) and op.device.type == "cpu"
    with pytest.raises(ValueError, match="with_adjoint"):
        op.rmatvec(torch.ones(4, dtype=torch.float64))
    assert op.with_adjoint().with_adjoint().csr_h is not None


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_aligned_adjoint_matches_jax(dtype):
    D = jconvdiff(4, 5, 3, dtype=dtype)
    pd_j = jdia_align(D.data, D.offsets, D.shape[0])
    pdj_adj, offs_j = jf.dia_align_adjoint(pd_j, D.offsets, D.shape[0])
    A = dia_from_numpy(np.array(D.data), D.offsets, D.shape, device="cpu")
    for use_kernel in (True, False):
        op = kt.DIAOperator(A, use_kernel=use_kernel)
        pd_adj, offs = op.aligned_adjoint()
        assert offs == offs_j
        assert np.array_equal(pd_adj.numpy(), np.asarray(pdj_adj))
        assert op.aligned_adjoint()[0] is pd_adj
        u = _vec(A.shape[0], dtype)
        Oj = JDIAOperator(D, use_pallas=False)
        assert _rel(op.rmatvec(torch.as_tensor(u)).numpy(),
                    Oj.rmatvec(jnp.asarray(u))) <= 1e-6
    pd = dia_align(A.data, A.offsets, A.shape[0])
    assert dia_align_adjoint(pd, A.offsets, A.shape[0])[1] == offs_j


@pytest.mark.parametrize("dtype", DTYPES)
def test_knorm_elliptic_matches_jax(dtype):
    x = _vec(20, dtype, seed=11)
    d = np.abs(_vec(20, np.float64, seed=12)) + 0.5
    mx = (d * x).astype(dtype)
    got = kt.knorm_elliptic(torch.as_tensor(x), torch.as_tensor(mx))
    want = jknorm_elliptic(jnp.asarray(x), jnp.asarray(mx))
    assert got.dtype == torch.float64
    assert abs(float(got) - float(want)) <= 1e-14 * float(want)
