"""krylov_tpu_torch.minres_qlp against krylov_tpu.minres_qlp, on both
routes (the cases of tests/test_fixture_zoo.py and tests/test_fused.py:
906-948), and the plain version of its whole-solve kernel against
krylov_tpu's ``minres_qlp_dia_fused`` in interpret mode.

Inputs are made with numpy from a seed (or the fixture generators) and
given to both packages; a sparse fixture goes to krylov_tpu as CSR and
to the port as a DIA matrix.  Tolerances: in f64 and c128 the status
string, niter and the flags are equal and x agrees to 1e-8 relative
(reductions are summed in another order), the histories to 1e-8; in f32
the status is equal, niter within ±max(2, 10%) (the band of
tests/reference_niter.json) and x to 1e-3 relative.
"""

import numpy as np
import jax.numpy as jnp
import pytest
torch = pytest.importorskip("torch")

import fixtures as fx
import krylov_tpu as kj
import krylov_tpu.ops.pallas_fused as jf
import krylov_tpu_torch as kt
from krylov_tpu.ops.dia import DIAMatrix as JDIAMatrix
from krylov_tpu.ops.dia import poisson_dia as jpoisson
from krylov_tpu.ops.pallas_dia import dia_align as jdia_align
from krylov_tpu.operators import DIAOperator as JDIAOperator
from krylov_tpu.solvers.minres_qlp import _minres_qlp_solve as _jsolve
from krylov_tpu_torch.convert import dia_from_numpy
from krylov_tpu_torch.ops import cuda_fused as tf
from krylov_tpu_torch.ops.cuda_dia import dia_align, offsets_tensor
from krylov_tpu_torch.solvers.minres_qlp import _minres_qlp_solve


@pytest.fixture(params=[np.float64, np.complex128], ids=["f64", "c128"])
def FC(request):
    return request.param


def _rel(a, b):
    a, b = np.asarray(a, np.complex128), np.asarray(b, np.complex128)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300)


def _same(xt, st, xj, sj, tol=1e-8):
    assert st.status == sj.status
    assert st.niter == sj.niter
    assert st.solved == sj.solved
    assert st.inconsistent == sj.inconsistent
    assert st.indefinite == sj.indefinite
    assert st.npc_count == sj.npc_count
    assert _rel(xt.numpy(), xj) <= tol


def _band(xt, st, xj, sj):
    """The f32 comparison."""
    assert st.status == sj.status
    assert abs(st.niter - sj.niter) <= max(2, 0.1 * sj.niter)
    assert _rel(xt.numpy(), xj) <= 1e-3


def _both(A, b, At=None, **kw):
    xj, sj = kj.minres_qlp(A, b, **kw)
    xt, st = kt.minres_qlp(torch.as_tensor(A) if At is None else At, b, **kw)
    return xt, st, xj, sj


def _poisson(N=8, dtype=np.float64, seed=7, three_eigenvalues=False):
    """The 3-D Poisson stencil for both packages, or the diagonal matrix
    with eigenvalues 1, 2 and 3, whose Krylov space is exhausted at the
    third step."""
    D = jpoisson(N, N, N, dtype=dtype)
    if three_eigenvalues:
        D = JDIAMatrix(jnp.asarray((1.0 + np.arange(N ** 3) % 3)[None],
                                   dtype), (0,), D.shape)
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
    ("indefinite_shift", {"lam": -2.0}),
    ("Artol", {"Artol": 0.5}),
    ("history", {"history": True}),
])
def test_dense_fixtures(case, kw, FC):
    gen = fx.symmetric_definite if case in ("definite", "history") \
        else fx.symmetric_indefinite
    A, b = gen(FC=FC)
    xt, st, xj, sj = _both(A, b, **kw)
    _same(xt, st, xj, sj)
    if case == "history":
        for name in ("residuals", "Aresiduals"):
            got, want = getattr(st, name), getattr(sj, name)
            assert got.shape == want.shape == (st.niter + 1,)
            np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-14)


def test_f32_band():
    A, b = fx.symmetric_definite(FC=np.float32)
    _band(*_both(A, b, atol=0.0, rtol=1e-6))


def test_preconditioned_ldiv_and_zero_rhs(FC):
    A, b, M_inv = fx.square_preconditioned(FC=FC)
    d = np.diag(M_inv).copy()
    xt, st, xj, sj = _both(A, b, M=None)
    _same(xt, st, xj, sj)
    xj, sj = kj.minres_qlp(A, b, M=kj.DiagonalOperator(jnp.asarray(d)))
    xt, st = kt.minres_qlp(torch.as_tensor(A), b,
                           M=kt.DiagonalOperator(torch.as_tensor(d)))
    _same(xt, st, xj, sj)
    xj, sj = kj.minres_qlp(A, b, ldiv=True,
                           M=kj.DiagonalOperator(jnp.asarray(1.0 / d)))
    xt, st = kt.minres_qlp(torch.as_tensor(A), b, ldiv=True,
                           M=kt.DiagonalOperator(torch.as_tensor(1.0 / d)))
    _same(xt, st, xj, sj)
    A, _ = fx.zero_rhs(FC=FC)
    xt, st, xj, sj = _both(A, np.zeros(10, dtype=FC))
    assert st.status == "x is a zero-residual solution"
    assert float(xt.abs().max()) == 0.0
    _same(xt, st, xj, sj)


def test_linesearch_npc_exit_and_warm_start_error():
    A, b = fx.symmetric_indefinite(shift=10)
    xj, sj, _ = _jsolve(A, b, linesearch=True)
    xt, st, state = _minres_qlp_solve(torch.as_tensor(A), b,
                                      linesearch=True)
    assert st.status == "nonpositive curvature" and st.indefinite
    assert state.npc_dir.shape == (10,)
    _same(xt, st, xj, sj)
    with pytest.raises(ValueError, match="warm_start and linesearch"):
        kt.minres_qlp(torch.as_tensor(A), b, np.zeros(10), linesearch=True)


def test_warm_start_callback_and_verbose(capsys):
    A = fx.get_div_grad(6, 6, 6)
    b = A @ np.ones(A.shape[0])
    At = kt.dia_from_scipy(A, device="cpu")
    x0 = 0.99 * np.ones(b.shape[0])
    _same(*_both(fx.to_csr(A), b, At=At, x0=x0))
    stop = dict(callback=lambda s: s.iter >= 4)
    xt, st, xj, sj = _both(fx.to_csr(A), b, At=At, **stop)
    assert st.status == "user-requested exit" and st.niter == 4
    _same(xt, st, xj, sj)
    kt.minres_qlp(At, b, verbose=1)
    out = capsys.readouterr().out
    assert "MINRES-QLP: system of size 216" in out
    assert len(out.strip().splitlines()) > 3


def test_singular_systems():
    """The minimum-norm solution of a singular consistent system, and the
    least-squares solution of an inconsistent one (flag and ‖Aᴴr‖)."""
    A, b = fx.singular_consistent()
    xt, st, xj, sj = _both(A, b)
    _same(xt, st, xj, sj)
    assert fx.check_min_norm(A, b, xt.numpy(), atol=1e-5)
    A, b = fx.symmetric_inconsistent()
    xt, st, xj, sj = _both(A, b)
    assert st.inconsistent
    _same(xt, st, xj, sj)



def test_timemax_stops_after_a_chunk():
    """timemax is read once per chunk of 64 iterations, as the JAX
    package's drive reads it: with timemax = 0 a solve that needs more
    than 64 stops after 64."""
    D, A, b = _poisson(N=16)
    kw = dict(atol=0.0, rtol=1e-12, timemax=0.0)
    xj, sj = kj.minres_qlp(D, b, **kw)
    xt, st = kt.minres_qlp(A, torch.as_tensor(b), **kw)
    assert st.status == "time limit exceeded" and st.niter == 64
    _same(xt, st, xj, sj)

def test_double_word_raises():
    A, b = fx.symmetric_definite()
    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
        kt.minres_qlp(torch.as_tensor(A), b, precision="double_word")


# ---------------------------------------------------------------------------
# the fused route and the kernel's plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("case,kw", [
    ("plain", {}),
    ("lam", {"lam": 0.5}),
    # indefinite: rtol 1e-8 as tests/test_fused.py:920-931 (at 1e-10 the
    # two summation orders part by two iterations in f64)
    ("indefinite", {"lam": -2.0, "rtol": 1e-8}),
    ("Artol", {"artol": 0.5}),
    ("three_eigenvalues", {}),
    ("capped", {"itmax": 5}),
])
def test_fused_ref_matches_jax_kernel(dtype, case, kw):
    D, A, b = _poisson(dtype=dtype,
                       three_eigenvalues=case == "three_eigenvalues")
    n = b.shape[0]
    f64 = dtype == np.float64
    args = dict(atol=0.0, rtol=1e-10 if f64 else 1e-6, artol=0.0, lam=0.0,
                itmax=2 * n)
    args.update(kw)
    pj = jdia_align(D.data, D.offsets, n)
    pt = dia_align(A.data, A.offsets, n)
    j = jf.minres_qlp_dia_fused(pj, D.offsets, jnp.asarray(b),
                                interpret=True, **args)
    t = tf.minres_qlp_dia_fused_ref(pt, offsets_tensor(A.offsets, "cpu"),
                                    torch.as_tensor(b), **args)
    j = [np.asarray(v) for v in j]
    t = [v.numpy() for v in t]
    assert int(t[3]) == int(j[3]) and int(t[4]) == int(j[4])  # status, incon
    if case == "three_eigenvalues":
        assert int(t[1]) == 3
    if f64:
        assert int(t[1]) == int(j[1])
        assert _rel(t[0], j[0]) <= 1e-8
        # rNorm and ArNorm, estimates that reach the rounding level of
        # the Lanczos process at the stop: to 1e-8 of the scale ‖b‖
        for i in (2, 5):
            assert abs(float(t[i]) - float(j[i])) <= \
                1e-8 * np.linalg.norm(b)
    else:
        assert abs(int(t[1]) - int(j[1])) <= max(2, 0.1 * int(j[1]))
        assert _rel(t[0], j[0]) <= 1e-3


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_fused_route_matches_jax(dtype):
    D, A, b = _poisson(dtype=dtype)
    kw = dict(atol=0.0, rtol=1e-6)
    xj, sj = kj.minres_qlp(JDIAOperator(D, use_pallas=True), b, **kw)
    n0 = kt.kernel_launches()
    xt, st, state = _minres_qlp_solve(kt.DIAOperator(A, use_kernel=True),
                                      torch.as_tensor(b), **kw)
    assert state is None and kt.kernel_launches() == n0  # plain version
    if dtype == np.float64:
        _same(xt, st, xj, sj)
    else:
        _band(xt, st, xj, sj)


def test_fused_route_zero_rhs_warm_start_and_history():
    D, A, b = _poisson()
    op = kt.DIAOperator(A, use_kernel=True)
    jop = JDIAOperator(D, use_pallas=True)
    bt = torch.as_tensor(b)
    x, st = kt.minres_qlp(op, torch.zeros_like(bt))
    assert st.status == "x is a zero-residual solution"
    assert float(x.abs().max()) == 0.0 and not st.inconsistent
    x1, _ = kt.minres_qlp(op, bt, atol=0.0, rtol=1e-3)
    xj1, _ = kj.minres_qlp(jop, b, atol=0.0, rtol=1e-3)
    xt, st = kt.minres_qlp(op, bt, x1, atol=0.0, rtol=1e-8)
    xj, sj = kj.minres_qlp(jop, b, xj1, atol=0.0, rtol=1e-8)
    _same(xt, st, xj, sj)
    xj, sj = kj.minres_qlp(jop, b, history=True, atol=0.0, rtol=1e-6)
    xt, st, state = _minres_qlp_solve(op, bt, history=True, atol=0.0,
                                      rtol=1e-6)
    assert state is not None and st.residuals.shape == (st.niter + 1,)
    _same(xt, st, xj, sj)
