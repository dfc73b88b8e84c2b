"""krylov_tpu_torch.minres against krylov_tpu.minres, on both routes (the
cases of tests/test_minres.py and tests/test_fused.py:153-200, 370-401).

Inputs are made with numpy from a seed (or the fixture generators) and
given to both packages; a sparse fixture goes to krylov_tpu as CSR and
to the port as a DIA matrix.  Tolerances: in f64 and c128 the status
string, niter and the flags are equal and x agrees to 1e-8 relative
(reductions are summed in another order), the histories to 1e-8; in f32
the status is equal, niter within ±max(2, 10%) (the band of
tests/reference_niter.json) and x to 1e-4 relative.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import scipy.sparse as sp
torch = pytest.importorskip("torch")

import fixtures as fx
import krylov_tpu as kj
import krylov_tpu_torch as kt
from krylov_tpu.operators import DIAOperator as JDIAOperator
from krylov_tpu.solvers.minres import _minres_solve as _jminres_solve
from krylov_tpu_torch.convert import dia_from_numpy
from krylov_tpu_torch.solvers.minres import _minres_solve


@pytest.fixture(params=[np.float64, np.complex128], ids=["f64", "c128"])
def FC(request):
    return request.param


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300)


def _same(xt, st, xj, sj, tol=1e-8):
    assert st.status == sj.status
    assert st.niter == sj.niter
    assert st.solved == sj.solved
    assert st.inconsistent == sj.inconsistent
    assert st.indefinite == sj.indefinite
    assert st.npc_count == sj.npc_count
    assert _rel(xt.numpy(), xj) <= tol


def _both(A, b, At=None, **kw):
    xj, sj = kj.minres(A, b, **kw)
    xt, st = kt.minres(torch.as_tensor(A) if At is None else At, b, **kw)
    return xt, st, xj, sj


def _poisson(N=8, dtype=np.float64, seed=9, jacobi=False):
    D = kj.ops.dia.poisson_dia(N, N, N, dtype=dtype)
    data = np.array(D.data)
    d = None
    if jacobi:
        zi = list(D.offsets).index(0)
        data[zi] = 6.0 + 0.5 * np.sin(np.arange(N ** 3))
        d = (1.0 / data[zi]).astype(dtype)
        D = type(D)(jnp.asarray(data), D.offsets, D.shape)
    A = dia_from_numpy(data, D.offsets, D.shape, device="cpu")
    b = np.random.default_rng(seed).standard_normal(N ** 3).astype(dtype)
    return D, A, b, d


@pytest.mark.parametrize("gen", [fx.symmetric_definite,
                                 fx.symmetric_indefinite],
                         ids=["cubic_spline", "indefinite"])
def test_dense_fixtures(gen, FC):
    A, b = gen(FC=FC)
    xt, st, xj, sj = _both(A, b)
    assert st.solved
    _same(xt, st, xj, sj)


@pytest.mark.parametrize("shifted", [False, True],
                         ids=["laplacian", "almost_singular"])
def test_sparse_fixtures(shifted):
    A = fx.get_div_grad(6, 6, 6)
    if shifted:
        A = (A - 5 * sp.eye(A.shape[0])).tocsr()
    b = A @ np.ones(A.shape[0])
    xt, st, xj, sj = _both(fx.to_csr(A), b,
                           At=kt.dia_from_scipy(A, device="cpu"))
    _same(xt, st, xj, sj)


def test_zero_rhs(FC):
    A, _ = fx.zero_rhs(FC=FC)
    xt, st, xj, sj = _both(A, np.zeros(10, dtype=FC))
    assert st.status == "x is a zero-residual solution" and st.niter == 1
    assert float(xt.abs().max()) == 0.0
    _same(xt, st, xj, sj)


def test_shifted_and_conlim(FC):
    A, b = fx.symmetric_indefinite(FC=FC)
    for kw in (dict(lam=2.0), dict(conlim=10.0), dict(etol=1e-3,
                                                      window=3)):
        xt, st, xj, sj = _both(A, b, **kw)
        _same(xt, st, xj, sj)


def test_preconditioned_history(FC):
    A, b, M_inv = fx.square_preconditioned(FC=FC)
    d = np.diag(M_inv).copy()
    xj, sj = kj.minres(A, b, M=kj.DiagonalOperator(jnp.asarray(d)),
                       history=True)
    xt, st = kt.minres(torch.as_tensor(A), b,
                       M=kt.DiagonalOperator(torch.as_tensor(d)),
                       history=True)
    _same(xt, st, xj, sj)
    for name in ("residuals", "Aresiduals", "Acond"):
        got, want = getattr(st, name), getattr(sj, name)
        assert got.shape == (st.niter + 1,)
        assert _rel(got, want) <= 1e-8


def test_linesearch_npc(FC):
    A = np.diag([10.0, 8.0, 5.0, -1.0]).astype(FC)
    b = np.array([1.0, 1.0, 1.0, 0.1], dtype=FC)
    xj, sj, statej = _jminres_solve(A, b, linesearch=True)
    xt, st, statet = _minres_solve(torch.as_tensor(A), b, linesearch=True)
    assert st.status == "nonpositive curvature" and st.indefinite
    _same(xt, st, xj, sj)
    np.testing.assert_allclose(statet.npc_dir.numpy(),
                               np.asarray(statej.npc_dir), rtol=1e-8)


def test_linesearch_first_iter_npc(FC):
    A, b = fx.symmetric_indefinite(FC=FC, shift=10)
    xj, sj, _ = _jminres_solve(A, b, linesearch=True)
    xt, st, _ = _minres_solve(torch.as_tensor(A), b, linesearch=True)
    assert st.niter == 1 and np.allclose(xt.numpy(), b)
    _same(xt, st, xj, sj)


def test_warm_start_callback_and_verbose(capsys):
    A = fx.get_div_grad(6, 6, 6)
    b = A @ np.ones(A.shape[0])
    At = kt.dia_from_scipy(A, device="cpu")
    x0 = 0.99 * np.ones(b.shape[0])
    xt, st, xj, sj = _both(fx.to_csr(A), b, At=At, x0=x0)
    _same(xt, st, xj, sj)
    stop = dict(callback=lambda s: s.iter >= 4)
    xt, st, xj, sj = _both(fx.to_csr(A), b, At=At, **stop)
    assert st.status == "user-requested exit" and st.niter == 4
    _same(xt, st, xj, sj)
    kt.minres(At, b, verbose=1)
    out = capsys.readouterr().out
    assert "MINRES: system of size 216" in out
    assert len(out.strip().splitlines()) > 3


def test_singular_inconsistent():
    """A least-squares solve of a singular system: its x grows along the
    null space by an amount that rounding decides, so only the status,
    niter, the flags and a bounded residual are compared."""
    A, b = fx.symmetric_inconsistent()
    xt, st, xj, sj = _both(A, b)
    assert st.solved
    _same(xt, st, xj, sj, tol=np.inf)
    assert np.isfinite(xt.numpy()).all()
    assert np.linalg.norm(b - A @ xt.numpy()) <= np.linalg.norm(b)


@pytest.mark.parametrize("case", ["M=I", "lambda", "jacobi", "ldiv"])
def test_fused_route_on_cpu_f64(case):
    """DIAOperator(use_kernel=True) on the CPU takes the fused route
    through the kernel's plain version, as use_pallas=True takes the JAX
    kernel in interpret mode."""
    D, A, b, d = _poisson(jacobi=case in ("jacobi", "ldiv"))
    kw = dict(atol=0.0, rtol=1e-8)
    if case == "lambda":
        kw["lam"] = 0.5
    Mj = Mt = None
    if d is not None:
        dm = 1.0 / d if case == "ldiv" else d
        kw["ldiv"] = case == "ldiv"
        Mj = kj.DiagonalOperator(jnp.asarray(dm))
        Mt = kt.DiagonalOperator(torch.as_tensor(dm))
    xj, sj = kj.minres(JDIAOperator(D, use_pallas=True), b, M=Mj, **kw)
    n0 = kt.kernel_launches()
    xt, st, state = _minres_solve(kt.DIAOperator(A, use_kernel=True),
                                  torch.as_tensor(b), M=Mt, **kw)
    assert state is None and kt.kernel_launches() == n0
    _same(xt, st, xj, sj)


def test_fused_route_on_cpu_f32():
    D, A, b, _ = _poisson(dtype=np.float32)
    xj, sj = kj.minres(JDIAOperator(D, use_pallas=True), b, atol=0.0,
                       rtol=1e-6)
    xt, st = kt.minres(kt.DIAOperator(A, use_kernel=True),
                       torch.as_tensor(b), atol=0.0, rtol=1e-6)
    assert st.status == sj.status
    assert abs(st.niter - sj.niter) <= max(2, 0.1 * sj.niter)
    assert _rel(xt.numpy(), xj) <= 1e-4


def test_fused_route_zero_rhs_warm_start_and_violation():
    D, A, b, d = _poisson(jacobi=True)
    op = kt.DIAOperator(A, use_kernel=True)
    bt = torch.as_tensor(b)
    x, st = kt.minres(op, torch.zeros_like(bt))
    assert st.niter == 1                  # reference parity src/minres.jl:219
    assert st.status == "x is a zero-residual solution"
    assert not st.inconsistent
    x1, _ = kt.minres(op, bt, atol=0.0, rtol=1e-3)
    x2, _ = kt.minres(op, bt, x1, atol=0.0, rtol=1e-8)
    r = bt - op.matvec(x2)
    assert float(r.norm()) <= 1e-8 * float(bt.norm()) * 1.1
    M = kt.DiagonalOperator(-torch.ones_like(bt))
    with pytest.raises(ValueError, match="positive definite"):
        kt.minres(op, bt, M=M, atol=0.0, rtol=1e-8)


def test_history_takes_general_route():
    D, A, b, _ = _poisson()
    xj, sj = kj.minres(JDIAOperator(D, use_pallas=True), b, history=True)
    xt, st, state = _minres_solve(kt.DIAOperator(A, use_kernel=True),
                                  torch.as_tensor(b), history=True)
    assert state is not None and st.residuals.shape == (st.niter + 1,)
    _same(xt, st, xj, sj)


def test_precision_options():
    A, b = fx.symmetric_definite()
    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
        kt.minres(torch.as_tensor(A), b, precision="double_word")
    with pytest.raises(ValueError):
        kt.minres(torch.as_tensor(A), b, precision="quad")
    with pytest.raises(ValueError):
        kt.minres(torch.as_tensor(A), b[:4])
    with pytest.raises(ValueError, match="warm_start and linesearch"):
        kt.minres(torch.as_tensor(A), b, np.zeros(10), linesearch=True)
