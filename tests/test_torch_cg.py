"""krylov_tpu_torch.cg against krylov_tpu.cg on the same systems.

Inputs are made with numpy from a seed and given to both packages.
Tolerances: in f64 the status string and niter are equal and x agrees
to 1e-8 relative (the two sum their reductions in other orders); in f32
the status is equal and niter within ±max(2, 10%), the band of
tests/reference_niter.json, with x to 1e-3 relative.
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
from krylov_tpu_torch.solvers.cg import _cg_solve

SOLVED = "solution good enough given atol and rtol"


def _poisson(N=16, dtype=np.float64, seed=11, jacobi=False):
    D = kj.ops.dia.poisson_dia(N, N, N, dtype=dtype)
    data = np.array(D.data)
    d = None
    if jacobi:
        zi = list(D.offsets).index(0)
        data[zi] = 6.0 + 0.5 * np.sin(np.arange(N ** 3))
        d = (1.0 / data[zi]).astype(dtype)
        D = type(D)(jnp.asarray(data), D.offsets, D.shape)
    b = np.random.default_rng(seed).standard_normal(N ** 3).astype(dtype)
    A = dia_from_numpy(data, D.offsets, D.shape, device="cpu")
    return D, A, b, d


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


def test_poisson_f64():
    D, A, b, _ = _poisson()
    xj, sj = kj.cg(D, b, atol=0.0, rtol=1e-8)
    xt, st = kt.cg(A, torch.as_tensor(b), atol=0.0, rtol=1e-8)
    assert st.status == SOLVED
    _same(xt, st, xj, sj)


def test_poisson_f32_default_tolerances():
    D, A, b, _ = _poisson(dtype=np.float32)
    xj, sj = kj.cg(D, b)
    xt, st = kt.cg(A, torch.as_tensor(b))
    assert st.status == sj.status == SOLVED
    assert abs(st.niter - sj.niter) <= max(2, 0.1 * sj.niter)
    assert _rel(xt.numpy(), xj) <= 1e-3


@pytest.mark.parametrize("ldiv", [False, True])
def test_jacobi(ldiv):
    D, A, b, d = _poisson(jacobi=True)
    dj = 1.0 / d if ldiv else d
    xj, sj = kj.cg(D, b, M=kj.DiagonalOperator(jnp.asarray(dj)), ldiv=ldiv,
                   atol=0.0, rtol=1e-8)
    xt, st = kt.cg(A, torch.as_tensor(b),
                   M=kt.DiagonalOperator(torch.as_tensor(dj)), ldiv=ldiv,
                   atol=0.0, rtol=1e-8)
    _same(xt, st, xj, sj)


def test_warm_start():
    D, A, b, _ = _poisson()
    x0 = np.random.default_rng(12).standard_normal(b.shape[0])
    xj, sj = kj.cg(D, b, jnp.asarray(x0), atol=0.0, rtol=1e-8)
    xt, st = kt.cg(A, torch.as_tensor(b), torch.as_tensor(x0), atol=0.0,
                   rtol=1e-8)
    _same(xt, st, xj, sj)


def test_history():
    D, A, b, _ = _poisson()
    xj, sj = kj.cg(D, b, atol=0.0, rtol=1e-8, history=True)
    xt, st = kt.cg(A, torch.as_tensor(b), atol=0.0, rtol=1e-8, history=True)
    _same(xt, st, xj, sj)
    assert st.residuals.shape == (st.niter + 1,)
    assert _rel(st.residuals, sj.residuals) <= 1e-8


def test_callback():
    D, A, b, _ = _poisson()
    xj, sj = kj.cg(D, b, callback=lambda s: s.iter >= 3, atol=0.0,
                   rtol=1e-30)
    xt, st = kt.cg(A, torch.as_tensor(b), callback=lambda s: s.iter >= 3,
                   atol=0.0, rtol=1e-30)
    assert st.status == "user-requested exit" and st.niter == 3
    _same(xt, st, xj, sj)


def test_radius():
    D, A, b, _ = _poisson()
    xfull, _ = kj.cg(D, b, atol=0.0, rtol=1e-10)
    radius = 0.5 * float(np.linalg.norm(np.asarray(xfull)))
    xj, sj = kj.cg(D, b, radius=radius)
    xt, st = kt.cg(A, torch.as_tensor(b), radius=radius)
    assert st.status == "on trust-region boundary"
    assert np.isclose(float(xt.norm()), radius, rtol=1e-6)
    _same(xt, st, xj, sj)


@pytest.mark.parametrize("case", ["linesearch", "radius"])
def test_npc_exits_dense(case):
    """Nonpositive curvature on the dense fixtures of tests/test_cg.py,
    through the port's MatrixOperator (reference test_cg.jl:51-96)."""
    if case == "linesearch":
        A, b = fx.symmetric_indefinite(shift=10)
        kw = dict(linesearch=True)
    else:
        A = np.diag([10.0, 8.0, 5.0, -1.0])
        b = np.array([1.0, 1.0, 1.0, 0.1])
        kw = dict(radius=10.0)
    from krylov_tpu.solvers.cg import _cg_solve as _jcg_solve
    xj, sj, statej = _jcg_solve(A, b, **kw)
    xt, st, statet = _cg_solve(torch.as_tensor(A), b, **kw)
    assert st.status == "nonpositive curvature"
    _same(xt, st, xj, sj, tol=1e-12)
    np.testing.assert_allclose(statet.npc_dir.numpy(),
                               np.asarray(statej.npc_dir), rtol=1e-12)


def test_linesearch_on_stencil():
    D, A, b, _ = _poisson()
    xj, sj = kj.cg(D, b, linesearch=True, atol=0.0, rtol=1e-8)
    xt, st = kt.cg(A, torch.as_tensor(b), linesearch=True, atol=0.0,
                   rtol=1e-8)
    _same(xt, st, xj, sj)


def test_compensated_f32():
    D, A, b, _ = _poisson(dtype=np.float32)
    xj, sj = kj.cg(D, b, atol=0.0, rtol=1e-6, precision="compensated")
    xt, st = kt.cg(A, torch.as_tensor(b), atol=0.0, rtol=1e-6,
                   precision="compensated")
    assert st.status == sj.status == SOLVED
    assert abs(st.niter - sj.niter) <= max(2, 0.1 * sj.niter)
    assert _rel(xt.numpy(), xj) <= 1e-3


def test_zero_rhs_and_itmax():
    D, A, b, _ = _poisson()
    xt, st = kt.cg(A, torch.zeros(b.shape[0], dtype=torch.float64))
    assert st.status == "x is a zero-residual solution" and st.niter == 0
    assert float(xt.abs().max()) == 0.0
    xj, sj = kj.cg(D, b, itmax=70, atol=0.0, rtol=1e-30)
    xt, st = kt.cg(A, torch.as_tensor(b), itmax=70, atol=0.0, rtol=1e-30)
    assert st.status == "maximum number of iterations exceeded"
    _same(xt, st, xj, sj)


def test_finite_timemax_runs_general_route():
    D, A, b, _ = _poisson()
    xj, sj = kj.cg(D, b, atol=0.0, rtol=1e-8, timemax=1e6)
    xt, st = kt.cg(A, torch.as_tensor(b), atol=0.0, rtol=1e-8, timemax=1e6)
    _same(xt, st, xj, sj)


@pytest.mark.parametrize("jacobi", [False, True])
def test_fused_route_on_cpu(jacobi):
    """DIAOperator(use_kernel=True) on the CPU takes the fused route
    through the kernels' plain versions, as use_pallas=True takes the
    JAX fused kernel in interpret mode."""
    D, A, b, d = _poisson(N=8, jacobi=jacobi)
    Mj = None if d is None else kj.DiagonalOperator(jnp.asarray(d))
    Mt = None if d is None else kt.DiagonalOperator(torch.as_tensor(d))
    xj, sj = kj.cg(JDIAOperator(D, use_pallas=True), b, M=Mj, atol=0.0,
                   rtol=1e-8)
    x0 = kt.cg_dia_fused.launches
    xt, st, state = _cg_solve(kt.DIAOperator(A, use_kernel=True),
                              torch.as_tensor(b), M=Mt, atol=0.0, rtol=1e-8)
    assert state is None                       # the fused route ran
    assert kt.cg_dia_fused.launches == x0      # through the plain version
    _same(xt, st, xj, sj)


def test_fused_route_warm_start_and_violation():
    D, A, b, _ = _poisson(N=8)
    op = kt.DIAOperator(A, use_kernel=True)
    bt = torch.as_tensor(b)
    x1, _ = kt.cg(op, bt, atol=0.0, rtol=1e-3)
    x2, s2 = kt.cg(op, bt, x1, atol=0.0, rtol=1e-8)
    r = bt - op.matvec(x2)
    assert float(r.norm()) <= 1e-8 * float(bt.norm()) * 1.1
    with pytest.raises(ValueError, match="positive definite"):
        kt.cg(op, bt, M=kt.DiagonalOperator(-torch.ones_like(bt)),
              atol=0.0, rtol=1e-8)


def test_matrix_free_and_dense():
    A, b = fx.symmetric_definite(n=30)
    xj, sj = kj.cg(A, b)
    At = torch.as_tensor(np.asarray(A))
    op = kt.FunctionOperator(lambda v: At @ v, (30, 30), At.dtype)
    for Aop in (op, At, kt.MatrixOperator(At)):
        xt, st = kt.cg(Aop, torch.as_tensor(b))
        _same(xt, st, xj, sj, tol=1e-10)


def test_verbose_prints_table(capsys):
    D, A, b, _ = _poisson(N=4)
    kt.cg(A, torch.as_tensor(b), verbose=1)
    out = capsys.readouterr().out
    assert "CG: system of 64 equations in 64 variables" in out
    assert len(out.strip().splitlines()) > 3


def test_unported_options_raise():
    D, A, b, _ = _poisson(N=4)
    bt = torch.as_tensor(b)
    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
        kt.cg(A, bt, precision="double_word")
    with pytest.raises(ValueError):
        kt.cg(A, bt, radius=1.0, linesearch=True)
    with pytest.raises(ValueError):
        kt.cg(A, bt, precision="quad")
    with pytest.raises(ValueError):
        kt.cg(A, bt[:10])



def test_chebyshev_preconditioner_accepted():
    """A Chebyshev M runs (it raised NotImplementedError before it was
    ported): the general route matches krylov_tpu.cg to 1e-8 with equal
    niter and status, and cuts the iterations."""
    D, A, b, _ = _poisson(N=8)
    bt = torch.as_tensor(b)
    Mj = kj.ChebyshevPreconditioner(D, degree=4, lmin=0.4, lmax=12.2)
    Mt = kt.ChebyshevPreconditioner(A, degree=4, lmin=0.4, lmax=12.2)
    xj, sj = kj.cg(D, b, M=Mj, atol=0.0, rtol=1e-8)
    xt, st = kt.cg(A, bt, M=Mt, atol=0.0, rtol=1e-8)
    assert st.status == SOLVED
    _same(xt, st, xj, sj)
    _, s0 = kt.cg(A, bt, atol=0.0, rtol=1e-8)
    assert st.niter < s0.niter
