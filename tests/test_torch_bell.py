"""krylov_tpu_torch's ELL and block-ELL storage, its products and
``BELLOperator`` against krylov_tpu's (tests/test_pallas_spmv.py:113-210),
the JAX kernels in interpret mode.

Inputs are made with numpy from a seed and given to both packages (the
JAX package's matrices cross over as numpy arrays through
``convert.bell_from_numpy`` and ``ell_from_numpy``).  Tolerances: the
builders give equal arrays; the products agree to 1e-12 relative in f64
and 1e-5 in f32 (the same products summed in another order; f32 at 128
terms a block row); the solves keep the JAX tests' bounds and, in f64,
the JAX package's niter and status with X within 1e-8 relative.
"""

import numpy as np
import jax.numpy as jnp
import pytest
torch = pytest.importorskip("torch")

import krylov_tpu as kj
import krylov_tpu_torch as kt
from krylov_tpu.ops import pallas_spmv as js
from krylov_tpu.ops.sparse import csr_from_dense as jcsr_from_dense
from krylov_tpu_torch.convert import (bell_from_numpy, csr_from_numpy,
                                      ell_from_numpy)
from krylov_tpu_torch.ops import cuda_spmv as ts


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300)


def _sparse(rng, m, n, density=0.2):
    return np.where(rng.random((m, n)) < density,
                    rng.standard_normal((m, n)), 0.0)


def _tcsr(C):
    """The port's copy of a krylov_tpu CSRMatrix."""
    return csr_from_numpy(np.asarray(C.data), np.asarray(C.indices),
                          np.asarray(C.indptr), np.asarray(C.rows), C.shape,
                          device="cpu")


def _tbell(Bj):
    return bell_from_numpy(np.asarray(Bj.data), np.asarray(Bj.indices),
                           Bj.shape, Bj.bs, device="cpu")


@pytest.mark.parametrize("m,n,bs", [(48, 48, 8), (53, 41, 8), (20, 70, 16)])
def test_builders_give_the_jax_arrays(m, n, bs):
    """bell_from_dense_blocks (with and without a tolerance),
    bell_from_csr and ell_from_csr give the JAX builders' arrays."""
    rng = np.random.default_rng(m + n)
    S = _sparse(rng, m, n)
    S[:, 3] = 1e-3 * rng.standard_normal(m)
    for tol in (0.0, 0.5):
        want = js.bell_from_dense_blocks(jnp.asarray(S), bs=bs, tol=tol)
        got = ts.bell_from_dense_blocks(torch.as_tensor(S), bs=bs, tol=tol)
        assert got.shape == want.shape and got.bs == want.bs
        assert np.array_equal(got.data.numpy(), np.asarray(want.data))
        assert np.array_equal(got.indices.numpy(), np.asarray(want.indices))
        assert got.indices.dtype == torch.int32
    C = jcsr_from_dense(jnp.asarray(S))
    want = js.bell_from_csr(C, bs=bs)
    got = ts.bell_from_csr(_tcsr(C), bs=bs)
    assert np.array_equal(got.data.numpy(), np.asarray(want.data))
    assert np.array_equal(got.indices.numpy(), np.asarray(want.indices))
    want = js.ell_from_csr(C)
    got = ts.ell_from_csr(_tcsr(C))
    assert got.shape == want.shape
    assert np.array_equal(got.data.numpy(), np.asarray(want.data))
    assert np.array_equal(got.indices.numpy(), np.asarray(want.indices))


def test_ell_spmv_matches_jax():
    rng = np.random.default_rng(1)
    S = _sparse(rng, 40, 33)
    E = js.ell_from_csr(jcsr_from_dense(jnp.asarray(S)))
    x = rng.standard_normal(33)
    Et = ell_from_numpy(np.asarray(E.data), np.asarray(E.indices), E.shape,
                        device="cpu")
    y = Et @ torch.as_tensor(x)
    assert _rel(y.numpy(), np.asarray(E @ jnp.asarray(x))) <= 1e-12
    assert _rel(y.numpy(), S @ x) <= 1e-12


def _bell_pair(dtype, bs, nb, mbpr=2, seed=5):
    """tests/test_pallas_spmv.py:146-161's BELL (nb block rows of bs, mbpr
    slots) in both packages, and its dense copy."""
    rng = np.random.default_rng(seed)
    data = rng.standard_normal((nb, mbpr, bs, bs)).astype(dtype) / bs
    idx = (np.arange(nb)[:, None] // 2 * 2
           + np.arange(mbpr)[None, :]) % nb
    idx = idx.astype(np.int32)
    n = nb * bs
    dense = np.zeros((n, n), dtype)
    for i in range(nb):
        for k in range(mbpr):
            j = idx[i, k]
            dense[i * bs:(i + 1) * bs, j * bs:(j + 1) * bs] += data[i, k]
    Aj = js.BELLMatrix(jnp.asarray(data), jnp.asarray(idx), (n, n), bs)
    return Aj, _tbell(Aj), dense


@pytest.mark.parametrize("dtype,tol", [(np.float32, 1e-5),
                                       (np.float64, 1e-12)],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("bs,nb", [(8, 6), (128, 4)])
def test_bell_products_match_the_jax_kernels(dtype, tol, bs, nb):
    """The plain bell_spmv and bell_spmm (p = 1, 4, 8, 130) against the
    JAX kernels in interpret mode and the dense product."""
    Aj, At, dense = _bell_pair(dtype, bs, nb)
    rng = np.random.default_rng(7)
    x = rng.standard_normal(dense.shape[1]).astype(dtype)
    y = kt.bell_spmv(At, torch.as_tensor(x))
    assert y.dtype == torch.float32 if dtype == np.float32 else True
    assert _rel(y.numpy(), np.asarray(js.bell_spmv(Aj, jnp.asarray(x),
                                                   interpret=True))) <= tol
    assert _rel(y.numpy(), dense @ x) <= tol
    for p in (1, 4, 8, 130):
        X = rng.standard_normal((dense.shape[1], p)).astype(dtype)
        Y = kt.bell_spmm(At, torch.as_tensor(X))
        assert Y.shape == (dense.shape[0], p)
        assert _rel(Y.numpy(), np.asarray(js.bell_spmm(
            Aj, jnp.asarray(X), interpret=True))) <= tol
        assert _rel(Y.numpy(), dense @ X) <= tol


def test_bell_products_on_ragged_shapes_and_narrow_types():
    """A BELL built from a 53 × 50 matrix (ragged block edges) multiplies
    as the dense matrix; bf16 data accumulate in f32 and round once, as
    the JAX kernel's (pallas_spmv.py:205-206)."""
    rng = np.random.default_rng(11)
    S = _sparse(rng, 53, 50, 0.3)
    A = ts.bell_from_dense_blocks(torch.as_tensor(S), bs=8)
    x = rng.standard_normal(50)
    assert _rel(kt.bell_spmv(A, torch.as_tensor(x)).numpy(), S @ x) <= 1e-12
    X = rng.standard_normal((50, 3))
    assert _rel(kt.bell_spmm(A, torch.as_tensor(X)).numpy(), S @ X) <= 1e-12
    Ab = ts.BELLMatrix(A.data.to(torch.bfloat16), A.indices, A.shape, 8)
    xb = torch.as_tensor(x).to(torch.bfloat16)
    want = (Ab.data.float().numpy(), xb.float().numpy())
    yb = kt.bell_spmv(Ab, xb)
    assert yb.dtype == torch.bfloat16
    ref = ts.bell_spmv_ref(ts.BELLMatrix(torch.as_tensor(want[0]),
                                         A.indices, A.shape, 8),
                           torch.as_tensor(want[1]))
    assert torch.equal(yb, ref.to(torch.bfloat16))
    with pytest.raises(ValueError, match="does not match"):
        kt.bell_spmv(A, torch.ones(49, dtype=torch.float64))


def test_bell_operator_under_cg_and_its_adjoint_storage():
    """tests/test_pallas_spmv.py:113-130: CG through a BELLOperator on an
    SPD matrix, as the JAX package's; rmatvec without bell_h raises with
    its message, and with it is Aᴴ's product."""
    rng = np.random.default_rng(0)
    n = 64
    Ad = rng.standard_normal((n, n))
    S = Ad @ Ad.T + n * np.eye(n)
    opj = kj.BELLOperator(js.bell_from_dense_blocks(jnp.asarray(S), bs=8))
    xj, sj = kj.cg(opj, jnp.ones(n), rtol=1e-10)
    op = kt.BELLOperator(_tbell(opj.bell))
    x, st = kt.cg(op, torch.ones(n, dtype=torch.float64), rtol=1e-10)
    assert (st.status, st.niter) == (sj.status, sj.niter) and st.solved
    assert _rel(x.numpy(), np.asarray(xj)) <= 1e-8
    assert np.linalg.norm(S @ x.numpy() - 1) <= 1e-6
    eye = ts.bell_from_dense_blocks(torch.eye(16, dtype=torch.float64), bs=8)
    with pytest.raises(ValueError, match="adjoint storage"):
        kt.BELLOperator(eye).rmatvec(torch.ones(16, dtype=torch.float64))
    N = _sparse(rng, 24, 24, 0.4)
    opn = kt.BELLOperator(ts.bell_from_dense_blocks(torch.as_tensor(N), 8),
                          ts.bell_from_dense_blocks(torch.as_tensor(N.T), 8))
    v = rng.standard_normal(24)
    assert _rel(opn.rmatvec(torch.as_tensor(v)).numpy(), N.T @ v) <= 1e-12
    assert _rel(opn.H.matmat(torch.as_tensor(np.stack([v, v], 1))).numpy(),
                N.T @ np.stack([v, v], 1)) <= 1e-12


def _block_tridiagonal(nb, bs, seed=9):
    """tests/test_pallas_spmv.py:184-203's SPD block-tridiagonal BELL
    arrays (f64)."""
    rng = np.random.default_rng(seed)
    diag_blocks = []
    for _ in range(nb):
        M = rng.standard_normal((bs, bs)) / bs
        diag_blocks.append(M @ M.T + 2 * np.eye(bs))
    off = rng.standard_normal((bs, bs)) / (4 * bs)
    data = np.zeros((nb, 3, bs, bs), np.float64)
    idx = np.zeros((nb, 3), np.int32)
    for i in range(nb):
        cols = [max(0, i - 1), i, min(nb - 1, i + 1)]
        idx[i] = cols
        for k, j in enumerate(cols):
            if j == i:
                data[i, k] += diag_blocks[i]
            elif j == i - 1:
                data[i, k] += off
            elif j == i + 1:
                data[i, k] += off.T
    return data, idx, rng


def test_block_solvers_over_a_bell_operator():
    """tests/test_pallas_spmv.py:179-210: block_gmres (memory 30, rtol
    1e-10) over the block-tridiagonal BELL operator with two columns, as
    the JAX package's: the same niter and status, X within 1e-8, the
    relative residual ≤ 1e-8; block_minres on the same operator."""
    bs, nb = 128, 3
    data, idx, rng = _block_tridiagonal(nb, bs)
    n = nb * bs
    Aj = kj.BELLOperator(js.BELLMatrix(jnp.asarray(data), jnp.asarray(idx),
                                       (n, n), bs))
    A = kt.BELLOperator(bell_from_numpy(data, idx, (n, n), bs,
                                        device="cpu"))
    B = rng.standard_normal((n, 2))
    kw = dict(atol=0.0, rtol=1e-10, memory=30)
    Xj, sj = kj.block_gmres(Aj, jnp.asarray(B), **kw)
    X, st = kt.block_gmres(A, torch.as_tensor(B), **kw)
    assert (st.status, st.niter) == (sj.status, sj.niter) and st.solved
    assert _rel(X.numpy(), np.asarray(Xj)) <= 1e-8
    R = B - A.matmat(X).numpy()
    assert np.linalg.norm(R) <= 1e-8 * np.linalg.norm(B)
    Xm, sm = kt.block_minres(A, torch.as_tensor(B), atol=0.0, rtol=1e-10)
    assert sm.solved and np.linalg.norm(B - A.matmat(Xm).numpy()) \
        <= 1e-8 * np.linalg.norm(B)
