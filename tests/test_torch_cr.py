"""krylov_tpu_torch.cr and .car against krylov_tpu's, on both routes (the
cases of tests/test_spd_family.py and tests/test_fused.py:476-505).

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
torch = pytest.importorskip("torch")

import fixtures as fx
import krylov_tpu as kj
import krylov_tpu_torch as kt
from krylov_tpu.operators import DIAOperator as JDIAOperator
from krylov_tpu_torch.convert import dia_from_numpy
from krylov_tpu_torch.solvers.cr import _car_solve, _cr_solve

SOLVED = "solution good enough given atol and rtol"


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


def _laplacian(n=6):
    """get_div_grad(n, n, n): CSR for krylov_tpu, DIA for the port."""
    A = fx.get_div_grad(n, n, n)
    return fx.to_csr(A), kt.dia_from_scipy(A, device="cpu"), A


def _poisson(N=8, dtype=np.float64, seed=5):
    D = kj.ops.dia.poisson_dia(N, N, N, dtype=dtype)
    A = dia_from_numpy(np.array(D.data), D.offsets, D.shape, device="cpu")
    b = np.random.default_rng(seed).standard_normal(N ** 3).astype(dtype)
    return D, A, b


SOLVERS = {"cr": (kj.cr, kt.cr), "car": (kj.car, kt.car)}


@pytest.mark.parametrize("method", ["cr", "car"])
def test_symmetric_definite(method, FC):
    A, b = fx.symmetric_definite(FC=FC)
    js, ts = SOLVERS[method]
    xj, sj = js(A, b)
    xt, st = ts(torch.as_tensor(A), b)
    assert st.status == SOLVED
    _same(xt, st, xj, sj)


@pytest.mark.parametrize("method", ["cr", "car"])
def test_sparse_laplacian(method):
    Aj, At, _ = _laplacian()
    b = np.ones(At.shape[0])
    js, ts = SOLVERS[method]
    xj, sj = js(Aj, b)
    xt, st = ts(At, b)
    _same(xt, st, xj, sj)


@pytest.mark.parametrize("method", ["cr", "car"])
def test_preconditioned(method, FC):
    A, b, M_inv = fx.square_preconditioned(FC=FC)
    js, ts = SOLVERS[method]
    kw = {"rtol": 5e-8} if method == "cr" else {}
    xj, sj = js(A, b, M=kj.DiagonalOperator(jnp.asarray(np.diag(M_inv))),
                **kw)
    xt, st = ts(torch.as_tensor(A), b,
                M=kt.DiagonalOperator(torch.tensor(np.diag(M_inv))), **kw)
    _same(xt, st, xj, sj)


@pytest.mark.parametrize("method", ["cr", "car"])
def test_zero_rhs(method, FC):
    A, _ = fx.zero_rhs(FC=FC)
    xt, st = SOLVERS[method][1](torch.as_tensor(A), np.zeros(10, dtype=FC))
    assert st.status == "x is a zero-residual solution" and st.niter == 0
    assert float(xt.abs().max()) == 0.0


@pytest.mark.parametrize("method", ["cr", "car"])
def test_warm_start(method):
    A, b = fx.warm_start_system(n=6)
    At = kt.dia_from_scipy(fx.get_div_grad(6, 6, 6), device="cpu")
    x0 = 0.99 * np.ones(b.shape[0])
    js, ts = SOLVERS[method]
    xj, sj = js(A, b, x0)
    xt, st = ts(At, b, x0)
    _same(xt, st, xj, sj)


@pytest.mark.parametrize("method", ["cr", "car"])
def test_history_callback_verbose(method, capsys):
    A, b = fx.symmetric_definite()
    js, ts = SOLVERS[method]
    At = torch.as_tensor(A)
    xj, sj = js(A, b, history=True)
    xt, st = ts(At, b, history=True)
    _same(xt, st, xj, sj)
    assert st.residuals.shape == (st.niter + 1,)
    assert _rel(st.residuals, sj.residuals) <= 1e-8
    assert _rel(st.Aresiduals, sj.Aresiduals) <= 1e-8
    xj, sj = js(A, b, callback=lambda s: s.iter >= 2)
    xt, st = ts(At, b, callback=lambda s: s.iter >= 2)
    assert st.status == "user-requested exit" and st.niter == 2
    _same(xt, st, xj, sj)
    ts(At, b, verbose=1)
    out = capsys.readouterr().out
    assert f"{method.upper()}: system of size 10" in out
    assert len(out.strip().splitlines()) > 3


def test_cr_trust_region(FC):
    A, b = fx.symmetric_definite(FC=FC)
    radius = 0.75 * float(np.linalg.norm(np.linalg.solve(A, b)))
    xj, sj = kj.cr(A, b, radius=radius, itmax=10)
    xt, st = kt.cr(torch.as_tensor(A), b, radius=radius, itmax=10)
    assert st.solved
    assert float(xt.abs().norm()) <= radius * (1 + 1e-6)
    _same(xt, st, xj, sj)


@pytest.mark.parametrize("shift", [10, 2.5])
def test_cr_trust_region_indefinite(shift):
    """The nonpositive-curvature cases of the trust-region step."""
    A, b = fx.symmetric_indefinite(shift=shift)
    xj, sj, statej = kj.solvers.cr._cr_solve(A, b, radius=5.0)
    xt, st, statet = _cr_solve(torch.as_tensor(A), b, radius=5.0)
    _same(xt, st, xj, sj)
    np.testing.assert_allclose(statet.npc_dir.numpy(),
                               np.asarray(statej.npc_dir), rtol=1e-8)


def test_cr_linesearch_indefinite(FC):
    A, b = fx.symmetric_indefinite(FC=FC, shift=10)
    xj, sj, _ = kj.solvers.cr._cr_solve(A, b, linesearch=True)
    xt, st, _ = _cr_solve(torch.as_tensor(A), b, linesearch=True)
    assert st.status == "nonpositive curvature" and st.indefinite
    assert st.niter == 0
    _same(xt, st, xj, sj)


def test_cr_indefinite_error_both_routes():
    A, b = fx.symmetric_indefinite(shift=10)
    with pytest.raises(ValueError, match="Indefinite system"):
        kt.cr(torch.as_tensor(A), b)
    D, At, bp = _poisson()
    data = At.data.clone()
    data[list(At.offsets).index(0)] -= 8.0
    op = kt.DIAOperator(kt.DIAMatrix(data, At.offsets, At.shape,
                                     device="cpu"), use_kernel=True)
    with pytest.raises(ValueError, match="Indefinite system"):
        kt.cr(op, torch.as_tensor(bp))


@pytest.mark.parametrize("method", ["cr", "car"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_fused_route_on_cpu(method, dtype):
    """DIAOperator(use_kernel=True) on the CPU takes the fused route
    through the kernel's plain version, as use_pallas=True takes the JAX
    kernel in interpret mode."""
    D, A, b = _poisson(dtype=dtype)
    js, _ = SOLVERS[method]
    solve = _cr_solve if method == "cr" else _car_solve
    xj, sj = js(JDIAOperator(D, use_pallas=True), b, atol=0.0, rtol=1e-6)
    n0 = kt.kernel_launches()
    xt, st, state = solve(kt.DIAOperator(A, use_kernel=True),
                          torch.as_tensor(b), atol=0.0, rtol=1e-6)
    assert state is None and kt.kernel_launches() == n0
    assert st.status == sj.status == SOLVED
    if dtype == np.float64:
        _same(xt, st, xj, sj)
    else:
        assert abs(st.niter - sj.niter) <= max(2, 0.1 * sj.niter)
        assert _rel(xt.numpy(), xj) <= 1e-4


@pytest.mark.parametrize("method", ["cr", "car"])
def test_fused_route_zero_rhs_warm_start_and_cap(method):
    D, A, b = _poisson()
    op = kt.DIAOperator(A, use_kernel=True)
    js, ts = SOLVERS[method]
    bt = torch.as_tensor(b)
    x, st = ts(op, torch.zeros_like(bt))
    assert st.status == "x is a zero-residual solution" and st.niter == 0
    x1, _ = ts(op, bt, atol=0.0, rtol=1e-3)
    x2, st = ts(op, bt, x1, atol=0.0, rtol=1e-9)
    r = bt - op.matvec(x2)
    assert float(r.norm()) <= 1e-9 * float(bt.norm()) * 1.1
    D, A, b = _poisson(N=12)
    b = 1e6 * b
    xj, sj = js(JDIAOperator(D, use_pallas=True), b, itmax=70, atol=0.0,
                rtol=1e-30)
    xt, st = ts(kt.DIAOperator(A, use_kernel=True), torch.as_tensor(b),
                itmax=70, atol=0.0, rtol=1e-30)
    assert st.status == "maximum number of iterations exceeded"
    _same(xt, st, xj, sj)


@pytest.mark.parametrize("method", ["cr", "car"])
def test_history_and_timemax_take_general_route(method):
    D, A, b = _poisson()
    op = kt.DIAOperator(A, use_kernel=True)
    solve = _cr_solve if method == "cr" else _car_solve
    js, _ = SOLVERS[method]
    xj, sj = js(JDIAOperator(D, use_pallas=True), b, history=True)
    n0 = kt.kernel_launches()
    for kw in (dict(history=True), dict(timemax=1e6)):
        xt, st, state = solve(op, torch.as_tensor(b), **kw)
        assert state is not None
        _same(xt, st, xj, sj)
    assert st.Aresiduals.size == 0
    assert kt.kernel_launches() == n0          # the CPU takes no kernel


@pytest.mark.parametrize("method", ["cr", "car"])
def test_precision_options(method):
    A, b = fx.symmetric_definite()
    ts = SOLVERS[method][1]
    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
        ts(torch.as_tensor(A), b, precision="double_word")
    with pytest.raises(ValueError):
        ts(torch.as_tensor(A), b, precision="quad")
    with pytest.raises(ValueError):
        ts(torch.as_tensor(A), b[:5])
