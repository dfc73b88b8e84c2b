"""krylov_tpu_torch.symmlq against krylov_tpu.symmlq, on both routes (the
cases of tests/test_sid_family.py and tests/test_fused.py:857-904), the
plain version of its whole-solve kernel against krylov_tpu's
``symmlq_dia_fused`` in interpret mode, and ``sym_givens`` against the
JAX function.

Inputs are made with numpy from a seed (or the fixture generators) and
given to both packages; a sparse fixture goes to krylov_tpu as CSR and
to the port as a DIA matrix.  Tolerances: in f64 and c128 the status
string and niter are equal and x agrees to 1e-8 relative (reductions are
summed in another order), the histories, Anorm and Acond to 1e-8; in
f32 the status is equal, niter within ±max(2, 10%) (the band of
tests/reference_niter.json) and x to 1e-3 relative.  sym_givens agrees
to 1e-15 relative in f64 (the same formulas, in the same order).
"""

import numpy as np
import jax.numpy as jnp
import pytest
torch = pytest.importorskip("torch")

import fixtures as fx
import krylov_tpu as kj
import krylov_tpu.ops.pallas_fused as jf
import krylov_tpu_torch as kt
from krylov_tpu.ops.dia import poisson_dia as jpoisson
from krylov_tpu.ops.kops import sym_givens as jsym_givens
from krylov_tpu.ops.pallas_dia import dia_align as jdia_align
from krylov_tpu.operators import DIAOperator as JDIAOperator
from krylov_tpu_torch.convert import dia_from_numpy
from krylov_tpu_torch.ops import cuda_fused as tf
from krylov_tpu_torch.ops.cuda_dia import dia_align, offsets_tensor


@pytest.fixture(params=[np.float64, np.complex128], ids=["f64", "c128"])
def FC(request):
    return request.param


def _rel(a, b):
    a, b = np.asarray(a, np.complex128), np.asarray(b, np.complex128)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300)


def _close(got, want, tol=1e-8):
    if np.isnan(want) or np.isinf(want):
        return got == want or np.isnan(got) and np.isnan(want)
    return abs(got - want) <= tol * max(abs(want), 1.0)


def _same(xt, st, xj, sj, tol=1e-8):
    assert st.status == sj.status
    assert st.niter == sj.niter
    assert st.solved == sj.solved
    assert _close(st.Anorm, sj.Anorm, tol)
    assert _close(st.Acond, sj.Acond, tol)
    assert _rel(xt.numpy(), xj) <= tol


def _poisson(N=8, dtype=np.float64, seed=7):
    D = jpoisson(N, N, N, dtype=dtype)
    A = dia_from_numpy(np.array(D.data), D.offsets, D.shape, device="cpu")
    b = np.random.default_rng(seed).standard_normal(N ** 3).astype(dtype)
    return D, A, b


# ---------------------------------------------------------------------------
# general route
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case,kw", [
    ("definite", {}),
    ("indefinite", {}),
    ("shifted", {"lam": 2.0}),
    ("conlim", {"conlim": 10.0}),
    ("etol", {"lambda_est": 0.5, "etol": 1e-3}),
    ("history", {"history": True}),
])
def test_symmlq_dense_fixtures(case, kw, FC):
    gen = fx.symmetric_definite if case in ("definite", "history") \
        else fx.symmetric_indefinite
    A, b = gen(FC=FC)
    xj, sj = kj.symmlq(A, b, **kw)
    xt, st = kt.symmlq(torch.as_tensor(A), b, **kw)
    _same(xt, st, xj, sj)
    if case == "history":
        for name in ("residuals", "residualscg"):
            got, want = getattr(st, name), getattr(sj, name)
            assert got.shape == want.shape == (st.niter + 1,)
            np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-14)


@pytest.mark.parametrize("window", [1, 3, 5])
def test_symmlq_lambda_est_error_window(window):
    """The λest error bounds with the retrospective window correction of
    errorscg (tests/test_sid_family.py:112-150)."""
    rng = np.random.default_rng(3)
    n = 50
    Q = np.linalg.qr(rng.standard_normal((n, n)))[0]
    A = Q @ np.diag(np.linspace(1.0, 10.0, n)) @ Q.T
    A = (A + A.T) / 2
    b = rng.standard_normal(n)
    kw = dict(lambda_est=0.9, window=window, atol=0.0, rtol=1e-12,
              etol=1e-12, history=True)
    xj, sj = kj.symmlq(A, b, **kw)
    xt, st = kt.symmlq(torch.as_tensor(A), b, **kw)
    _same(xt, st, xj, sj)
    for name in ("residuals", "residualscg", "errors", "errorscg"):
        got, want = getattr(st, name), getattr(sj, name)
        assert got.shape == want.shape == (st.niter + 1,)
        np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-14)


def test_symmlq_preconditioned_and_zero_rhs(FC):
    A, b, M_inv = fx.square_preconditioned(FC=FC)
    d = np.diag(M_inv).copy()
    xj, sj = kj.symmlq(A, b, M=kj.DiagonalOperator(jnp.asarray(d)))
    xt, st = kt.symmlq(torch.as_tensor(A), b,
                       M=kt.DiagonalOperator(torch.as_tensor(d)))
    _same(xt, st, xj, sj)
    xj, sj = kj.symmlq(A, b, M=kj.DiagonalOperator(jnp.asarray(1.0 / d)),
                       ldiv=True)
    xt, st = kt.symmlq(torch.as_tensor(A), b, ldiv=True,
                       M=kt.DiagonalOperator(torch.as_tensor(1.0 / d)))
    _same(xt, st, xj, sj)
    A, _ = fx.zero_rhs(FC=FC)
    xj, sj = kj.symmlq(A, np.zeros(10, dtype=FC))
    xt, st = kt.symmlq(torch.as_tensor(A), np.zeros(10, dtype=FC))
    assert st.status == "x is a zero-residual solution"
    assert float(xt.abs().max()) == 0.0
    _same(xt, st, xj, sj)


def test_symmlq_sparse_laplacian_and_warm_start():
    A = fx.get_div_grad(6, 6, 6)
    At = kt.dia_from_scipy(A, device="cpu")
    b = np.ones(A.shape[0])
    xj, sj = kj.symmlq(fx.to_csr(A), b)
    xt, st = kt.symmlq(At, b)
    _same(xt, st, xj, sj)
    # without the transfer the 10-unknown fixtures run past the Lanczos
    # breakdown (niter 11), where Anorm sums rounding noise; this system
    # stops well before it
    rb = np.random.default_rng(4).standard_normal(A.shape[0])
    xj, sj = kj.symmlq(fx.to_csr(A), rb, transfer_to_cg=False)
    xt, st = kt.symmlq(At, rb, transfer_to_cg=False)
    assert st.niter < A.shape[0]
    _same(xt, st, xj, sj)
    x0 = 0.99 * np.ones(A.shape[0])
    xj, sj = kj.symmlq(fx.to_csr(A), b, x0, atol=0.0, rtol=1e-10)
    xt, st = kt.symmlq(At, b, x0, atol=0.0, rtol=1e-10)
    _same(xt, st, xj, sj)


def test_symmlq_double_word_raises():
    A = kt.poisson_dia(3, dtype=torch.float64, device="cpu")
    with pytest.raises(NotImplementedError):
        kt.symmlq(A, torch.ones(27, dtype=torch.float64),
                  precision="double_word")


# ---------------------------------------------------------------------------
# the fused route and the kernel's plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("case,kw", [
    ("plain", {}),
    ("lam", {"lam": 0.7}),
    ("no_transfer", {"transfer_to_cg": False}),
    ("conlim", {"ctol": 0.1}),
    # ‖b‖ = 1, tol = 0.5: the CG point is good enough at the start
    # (solved_cg0), so the transfer runs with niter = 0
    ("init_transfer", {"atol": 0.5, "rtol": 0.0}),
])
def test_symmlq_fused_ref_matches_jax_kernel(dtype, case, kw):
    D, A, b = _poisson(dtype=dtype)
    n = b.shape[0]
    if case == "init_transfer":
        b = (b / np.linalg.norm(b)).astype(dtype)
    rtol = 1e-6 if dtype == np.float32 else 1e-10
    args = dict(atol=0.0, rtol=rtol, ctol=1e-8, lam=0.0, itmax=2 * n,
                transfer_to_cg=True)
    args.update(kw)
    pj = jdia_align(D.data, D.offsets, n)
    pt = dia_align(A.data, A.offsets, n)
    j = jf.symmlq_dia_fused(pj, D.offsets, jnp.asarray(b), interpret=True,
                            **args)
    t = tf.symmlq_dia_fused_ref(pt, offsets_tensor(A.offsets, "cpu"),
                                torch.as_tensor(b), **args)
    j = [np.asarray(v) for v in j]
    t = [v.numpy() for v in t]
    assert int(t[3]) == int(j[3])                     # status
    if case == "init_transfer":
        assert int(t[1]) == 0 and int(t[3]) == tf.SOLVED_CG_PT
        assert float(np.abs(t[0]).max()) > 0
    if dtype == np.float64:
        assert int(t[1]) == int(j[1])
        assert _rel(t[0], j[0]) <= 1e-8
        for i in (2, 4, 5, 6):                        # rnorm, Anorm², gmax/min
            assert _close(float(t[i]), float(j[i]))
    else:
        assert abs(int(t[1]) - int(j[1])) <= max(2, 0.1 * int(j[1]))
        assert _rel(t[0], j[0]) <= 1e-3


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_symmlq_fused_route_matches_jax(dtype):
    D, A, b = _poisson(dtype=dtype)
    kw = dict(atol=0.0, rtol=1e-6)
    xj, sj = kj.symmlq(JDIAOperator(D, use_pallas=True), b, **kw)
    n0 = tf.symmlq_dia_fused.launches
    xt, st = kt.symmlq(kt.DIAOperator(A, use_kernel=True),
                       torch.as_tensor(b), **kw)
    assert tf.symmlq_dia_fused.launches == n0         # CPU: plain version
    assert st.status == sj.status and st.residuals.size == 0
    if dtype == np.float64:
        _same(xt, st, xj, sj)
    else:
        assert abs(st.niter - sj.niter) <= max(2, 0.1 * sj.niter)
        assert _rel(xt.numpy(), xj) <= 1e-3


# ---------------------------------------------------------------------------
# sym_givens
# ---------------------------------------------------------------------------

_GRID = [0.0, 1.0, -1.0, 2.5, -3.0, 1e-300]


@pytest.mark.parametrize("kind", ["real", "complex"])
def test_sym_givens_matches_jax(kind):
    """A grid of (a, b) with zeros, |a| = |b| and both orders of
    magnitude; sym_givens(0, 0) = (1, 0, 0)."""
    vals = _GRID if kind == "real" else \
        [complex(v * p) for v in _GRID
         for p in (1.0, 1j, (1 - 1j) / np.sqrt(2))]
    dt = torch.float64 if kind == "real" else torch.complex128
    dt_np = np.float64 if kind == "real" else np.complex128
    for a in vals:
        for b in vals:
            got = kt.sym_givens(torch.tensor(a, dtype=dt),
                                torch.tensor(b, dtype=dt))
            want = jsym_givens(jnp.asarray(a, dt_np), jnp.asarray(b, dt_np))
            for g, w in zip(got, want):
                g, w = complex(g), complex(np.asarray(w))
                assert abs(g - w) <= 1e-15 * max(abs(w), 1e-300), (a, b)
    c, s, rho = kt.sym_givens(torch.tensor(0.0), torch.tensor(0.0))
    assert (float(c), float(s), float(rho)) == (1.0, 0.0, 0.0)
