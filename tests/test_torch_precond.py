"""The port's Chebyshev preconditioner and ``cg`` with it against
krylov_tpu's, on both routes (the cases of tests/test_precond_cheby.py
and tests/test_fused.py:412-505).

Inputs are made with numpy from a seed and given to both packages.
Tolerances: in f64 the status string and niter are equal and x agrees
to 1e-8 relative (reductions are summed in another order);
``power_bound`` starts from the same numpy vector and agrees to 1e-10
relative, and one preconditioner application to 1e-12 relative; in f32
the status is equal, niter within ±max(2, 10%) (the band of
tests/reference_niter.json) and x to 1e-4 relative.
"""

import numpy as np
import jax.numpy as jnp
import pytest
torch = pytest.importorskip("torch")

import krylov_tpu as kj
import krylov_tpu_torch as kt
from krylov_tpu.operators import DIAOperator as JDIAOperator
from krylov_tpu.operators import MatrixOperator as JMatrixOperator
from krylov_tpu_torch.convert import dia_from_numpy
from krylov_tpu_torch.solvers.cg import _cg_solve

SOLVED = "solution good enough given atol and rtol"


def _poisson(N=8, dtype=np.float64, seed=3):
    D = kj.ops.dia.poisson_dia(N, N, N, dtype=dtype)
    A = dia_from_numpy(np.array(D.data), D.offsets, D.shape, device="cpu")
    b = np.random.default_rng(seed).standard_normal(N ** 3).astype(dtype)
    return D, A, b


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300)


def _same(xt, st, xj, sj, tol=1e-8):
    assert st.status == sj.status
    assert st.niter == sj.niter
    assert st.solved == sj.solved
    assert _rel(xt.numpy(), xj) <= tol


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_power_bound_matches_jax(dtype):
    D, A, _ = _poisson(N=12, dtype=dtype)
    got = kt.power_bound(A)
    want = kj.power_bound(JDIAOperator(D, use_pallas=False))
    assert abs(got - want) <= (1e-10 if dtype == np.float64 else 1e-5) \
        * want
    assert got <= 12.0 * 1.1              # λmax < 12, inflated by 1.05
    v = torch.ones(A.shape[0], dtype=torch.float64)
    assert float(v @ kt.DIAOperator(A).matvec(v) / (v @ v)) <= got


@pytest.mark.parametrize("degree", [1, 3, 8])
def test_application_matches_jax(degree):
    D, A, b = _poisson()
    Mj = kj.ChebyshevPreconditioner(D, degree=degree, lmin=0.4, lmax=12.2)
    Mt = kt.ChebyshevPreconditioner(A, degree=degree, lmin=0.4, lmax=12.2)
    zj = np.asarray(Mj.matvec(jnp.asarray(b)))
    zt = Mt.matvec(torch.as_tensor(b)).numpy()
    assert _rel(zt, zj) <= 1e-12
    for apply in (Mt.rmatvec, Mt.solve, Mt.rsolve):
        assert torch.equal(apply(torch.as_tensor(b)),
                           Mt.matvec(torch.as_tensor(b)))


def test_defaults_hermitian_and_positive():
    """lmax from power_bound, lmin = lmax / 30, as in the JAX package."""
    D, A, _ = _poisson(N=12)
    M = kt.ChebyshevPreconditioner(A, degree=6)
    assert M.lmax == pytest.approx(kt.power_bound(A), rel=0)
    assert M.lmin == M.lmax / 30.0
    assert isinstance(M.lmin, float) and isinstance(M.lmax, float)
    rng = np.random.default_rng(0)
    a = torch.as_tensor(rng.standard_normal(A.shape[0]))
    c = torch.as_tensor(rng.standard_normal(A.shape[0]))
    assert abs(float(M.matvec(a) @ c) - float(a @ M.matvec(c))) < 1e-10
    assert float(M.matvec(a) @ a) > 0
    with pytest.raises(ValueError):
        kt.ChebyshevPreconditioner(A, degree=0, lmax=12.0)


def test_degree_one_is_scaled_identity():
    _, A, _ = _poisson()
    M = kt.ChebyshevPreconditioner(A, degree=1, lmin=1.0, lmax=3.0)
    z = M.matvec(torch.ones(A.shape[0], dtype=torch.float64))
    assert torch.allclose(z, torch.full_like(z, 0.5), rtol=0, atol=0)


@pytest.mark.parametrize("degree", [1, 2, 6])
def test_cg_general_route_matches_jax(degree):
    D, A, b = _poisson()
    Mj = kj.ChebyshevPreconditioner(JDIAOperator(D, use_pallas=False),
                                    degree=degree, lmin=0.4, lmax=12.2)
    Mt = kt.ChebyshevPreconditioner(A, degree=degree, lmin=0.4, lmax=12.2)
    xj, sj = kj.cg(JDIAOperator(D, use_pallas=False), b, M=Mj, atol=0.0,
                   rtol=1e-8)
    xt, st = kt.cg(A, torch.as_tensor(b), M=Mt, atol=0.0, rtol=1e-8)
    assert st.status == SOLVED
    _same(xt, st, xj, sj)


@pytest.mark.parametrize("degree", [1, 2, 8])
def test_cg_fused_route_matches_jax(degree):
    """The same operator object in A and M routes to the Chebyshev
    kernel, on the CPU through its plain version, as use_pallas=True
    takes the JAX kernel in interpret mode; a degree above 1 cuts the
    iterations."""
    D, A, b = _poisson()
    opj = JDIAOperator(D, use_pallas=True)
    opt = kt.DIAOperator(A, use_kernel=True)
    Mj = kj.ChebyshevPreconditioner(opj, degree=degree, lmin=0.4, lmax=12.2)
    Mt = kt.ChebyshevPreconditioner(opt, degree=degree, lmin=0.4, lmax=12.2)
    xj, sj = kj.cg(opj, b, M=Mj, atol=0.0, rtol=1e-8)
    n0 = kt.kernel_launches()
    xt, st, state = _cg_solve(opt, torch.as_tensor(b), M=Mt, atol=0.0,
                              rtol=1e-8)
    assert state is None                                # the fused route
    assert kt.kernel_launches() == n0                   # its plain version
    _same(xt, st, xj, sj)
    if degree > 1:
        _, s0 = kt.cg(opt, torch.as_tensor(b), atol=0.0, rtol=1e-8)
        assert st.niter < s0.niter


def test_cg_fused_route_f32_and_warm_start():
    D, A, b = _poisson(dtype=np.float32)
    opj = JDIAOperator(D, use_pallas=True)
    opt = kt.DIAOperator(A, use_kernel=True)
    Mj = kj.ChebyshevPreconditioner(opj, degree=4, lmin=0.4, lmax=12.2)
    Mt = kt.ChebyshevPreconditioner(opt, degree=4, lmin=0.4, lmax=12.2)
    xj, sj = kj.cg(opj, b, M=Mj)
    xt, st = kt.cg(opt, torch.as_tensor(b), M=Mt)
    assert st.status == sj.status == SOLVED
    assert abs(st.niter - sj.niter) <= max(2, 0.1 * sj.niter)
    assert _rel(xt.numpy(), xj) <= 1e-4
    D, A, b = _poisson()
    opt = kt.DIAOperator(A, use_kernel=True)
    Mt = kt.ChebyshevPreconditioner(opt, degree=4, lmin=0.4, lmax=12.2)
    bt = torch.as_tensor(b)
    x1, _ = kt.cg(opt, bt, M=Mt, atol=0.0, rtol=1e-3)
    x2, _ = kt.cg(opt, bt, x1, M=Mt, atol=0.0, rtol=1e-9)
    r = bt - opt.matvec(x2)
    assert float(r.norm()) <= 1e-8 * float(bt.norm())


def test_cg_foreign_operator_takes_general_route():
    """A preconditioner built on another operator object must not reach
    the kernel, whose polynomial applies A itself."""
    D, A, b = _poisson()
    opt = kt.DIAOperator(A, use_kernel=True)
    other = kt.DIAOperator(A, use_kernel=False)
    M = kt.ChebyshevPreconditioner(other, degree=4, lmin=0.4, lmax=12.2)
    bt = torch.as_tensor(b)
    x, st, state = _cg_solve(opt, bt, M=M, atol=0.0, rtol=1e-8)
    assert state is not None                            # general route
    assert st.status == SOLVED
    r = bt - other.matvec(x)
    assert float(r.norm()) <= 1e-8 * float(bt.norm()) * 1.1


def test_cg_zero_rhs():
    D, A, b = _poisson(dtype=np.float32)
    opt = kt.DIAOperator(A, use_kernel=True)
    M = kt.ChebyshevPreconditioner(opt, degree=4, lmin=0.4, lmax=12.2)
    x, st = kt.cg(opt, torch.zeros(A.shape[0]), M=M, atol=0.0, rtol=1e-6)
    assert st.niter == 0 and st.status == "x is a zero-residual solution"
    assert float(x.abs().max()) == 0.0


def test_complex_hpd_dense():
    rng = np.random.default_rng(1)
    n = 64
    B = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    A_ = B @ B.conj().T / n + 2 * np.eye(n)
    b = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    opj = JMatrixOperator(jnp.asarray(A_))
    xj, sj = kj.cg(opj, b, M=kj.ChebyshevPreconditioner(opj, degree=5),
                   atol=0.0, rtol=1e-10)
    opt = kt.MatrixOperator(torch.as_tensor(A_))
    xt, st = kt.cg(opt, torch.as_tensor(b),
                   M=kt.ChebyshevPreconditioner(opt, degree=5), atol=0.0,
                   rtol=1e-10)
    assert st.solved
    assert np.linalg.norm(A_ @ xt.numpy() - b) < 1e-7
    _same(xt, st, xj, sj)


def test_minres_accepts_cheby():
    D, A, _ = _poisson(N=12)
    b = np.ones(A.shape[0])
    opj = JDIAOperator(D, use_pallas=False)
    xj, sj = kj.minres(opj, b, M=kj.ChebyshevPreconditioner(opj, degree=4),
                       atol=0.0, rtol=1e-8)
    xt, st = kt.minres(A, torch.as_tensor(b),
                       M=kt.ChebyshevPreconditioner(A, degree=4), atol=0.0,
                       rtol=1e-8)
    _, s0 = kt.minres(A, torch.as_tensor(b), atol=0.0, rtol=1e-8)
    assert st.solved and st.niter < s0.niter
    _same(xt, st, xj, sj)
