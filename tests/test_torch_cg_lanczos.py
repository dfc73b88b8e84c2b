"""krylov_tpu_torch.cg_lanczos and .cg_lanczos_shift against krylov_tpu's,
on both routes (the cases of tests/test_spd_family.py and
tests/test_fused.py:510-595), and the plain versions of their
whole-solve kernels against krylov_tpu's ``cg_lanczos_dia_fused`` and
``cg_lanczos_shift_dia_fused`` in interpret mode.

Inputs are made with numpy from a seed (or the fixture generators) and
given to both packages; a sparse fixture goes to krylov_tpu as CSR and
to the port as a DIA matrix.  Tolerances: in f64 and c128 the status
string, niter and the flags are equal and x agrees to 1e-8 relative
(reductions are summed in another order), the histories and Anorm to
1e-8; in f32 the status is equal, niter within ±max(2, 10%) (the band of
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
from krylov_tpu_torch.convert import dia_from_numpy
from krylov_tpu_torch.ops import cuda_fused as tf
from krylov_tpu_torch.ops.cuda_dia import dia_align, offsets_tensor


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
    assert np.array_equal(np.asarray(st.indefinite),
                          np.asarray(sj.indefinite))
    assert abs(st.Anorm - sj.Anorm) <= tol * max(sj.Anorm, 1.0)
    assert _rel(xt.numpy(), xj) <= tol


def _poisson(N=8, dtype=np.float64, seed=5, flip=False):
    """The Poisson stencil (with ``flip`` the sign of the first half of
    its main diagonal flipped: indefinite, tests/test_fused.py:524-542)
    for both packages, and a seeded right-hand side."""
    D = jpoisson(N, N, N, dtype=dtype)
    data = np.array(D.data)
    if flip:
        data[list(D.offsets).index(0)][: N ** 3 // 2] *= -1.0
        D = JDIAMatrix(jnp.asarray(data), D.offsets, D.shape)
    A = dia_from_numpy(data, D.offsets, D.shape, device="cpu")
    b = np.random.default_rng(seed).standard_normal(N ** 3).astype(dtype)
    return D, A, b


# ---------------------------------------------------------------------------
# cg_lanczos, general route
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["definite", "check_curvature",
                                  "preconditioned", "ldiv", "history"])
def test_cg_lanczos_dense_fixtures(case, FC):
    kw = {}
    if case == "check_curvature":
        A, b = fx.symmetric_indefinite(FC=FC)
        kw = {"check_curvature": True}
    elif case in ("preconditioned", "ldiv"):
        A, b, M_inv = fx.square_preconditioned(FC=FC)
        d = np.diag(M_inv).copy()
        if case == "ldiv":
            d = 1.0 / d
        kw = {"ldiv": case == "ldiv"}
    else:
        A, b = fx.symmetric_definite(FC=FC)
        kw = {"history": case == "history"}
    jkw, tkw = dict(kw), dict(kw)
    if case in ("preconditioned", "ldiv"):
        jkw["M"] = kj.DiagonalOperator(jnp.asarray(d))
        tkw["M"] = kt.DiagonalOperator(torch.as_tensor(d))
    xj, sj = kj.cg_lanczos(A, b, **jkw)
    xt, st = kt.cg_lanczos(torch.as_tensor(A), b, **tkw)
    _same(xt, st, xj, sj)
    if case == "check_curvature":
        assert st.status == "negative curvature" and st.indefinite
    if case == "history":
        assert st.residuals.shape == (st.niter + 1,)
        assert _rel(st.residuals, sj.residuals) <= 1e-8


def test_cg_lanczos_zero_rhs(FC):
    A, _ = fx.zero_rhs(FC=FC)
    xj, sj = kj.cg_lanczos(A, np.zeros(10, dtype=FC))
    xt, st = kt.cg_lanczos(torch.as_tensor(A), np.zeros(10, dtype=FC))
    assert st.status == "x is a zero-residual solution" and st.niter == 0
    assert float(xt.abs().max()) == 0.0
    _same(xt, st, xj, sj)


def test_cg_lanczos_sparse_laplacian_and_warm_start():
    A = fx.get_div_grad(6, 6, 6)
    At = kt.dia_from_scipy(A, device="cpu")
    b = np.ones(A.shape[0])
    xj, sj = kj.cg_lanczos(fx.to_csr(A), b)
    xt, st = kt.cg_lanczos(At, b)
    _same(xt, st, xj, sj)
    x0 = 0.99 * np.ones(A.shape[0])
    xj, sj = kj.cg_lanczos(fx.to_csr(A), b, x0, atol=0.0, rtol=1e-10)
    xt, st = kt.cg_lanczos(At, b, x0, atol=0.0, rtol=1e-10)
    _same(xt, st, xj, sj)


def test_cg_lanczos_double_word_raises():
    A = kt.poisson_dia(3, dtype=torch.float64, device="cpu")
    with pytest.raises(NotImplementedError):
        kt.cg_lanczos(A, torch.ones(27, dtype=torch.float64),
                      precision="double_word")


# ---------------------------------------------------------------------------
# cg_lanczos_shift, general route
# ---------------------------------------------------------------------------

def _same_shift(Xt, st, Xj, sj, tol=1e-8):
    assert st.status == sj.status
    assert st.niter == sj.niter
    assert st.solved == sj.solved
    assert np.array_equal(np.asarray(st.indefinite, bool),
                          np.asarray(sj.indefinite, bool))
    assert Xt.shape == tuple(np.asarray(Xj).shape)
    assert _rel(Xt.numpy(), Xj) <= tol


@pytest.mark.parametrize("case", ["shifts", "negative_curvature",
                                  "history", "preconditioned"])
def test_cg_lanczos_shift_dense_fixtures(case, FC):
    A, b = fx.symmetric_definite(FC=FC)
    shifts, kw = [1.0, 2.0, 5.0], {}
    if case == "negative_curvature":
        # -4 makes A + σI indefinite (diag 4, eigenvalues > 0)
        shifts, kw = [-4.0, 1.0], {"check_curvature": True}
    elif case == "history":
        shifts, kw = [0.0, 3.0], {"history": True}
    jkw, tkw = dict(kw), dict(kw)
    if case == "preconditioned":
        d = 1.0 / np.abs(np.diag(A))
        jkw["M"] = kj.DiagonalOperator(jnp.asarray(d))
        tkw["M"] = kt.DiagonalOperator(torch.as_tensor(d))
    Xj, sj = kj.cg_lanczos_shift(A, b, shifts, **jkw)
    Xt, st = kt.cg_lanczos_shift(torch.as_tensor(A), b, shifts, **tkw)
    _same_shift(Xt, st, Xj, sj)
    if case == "history":
        assert len(st.residuals) == len(sj.residuals) == 2
        for got, want in zip(st.residuals, sj.residuals):
            assert got.shape == want.shape
            assert _rel(got, want) <= 1e-8


def test_cg_lanczos_shift_zero_rhs():
    A, _ = fx.symmetric_definite()
    Xj, sj = kj.cg_lanczos_shift(A, np.zeros(10), [1.0, 2.0])
    Xt, st = kt.cg_lanczos_shift(torch.as_tensor(A), np.zeros(10),
                                 [1.0, 2.0])
    assert st.status == "x is a zero-residual solution"
    _same_shift(Xt, st, Xj, sj)


# ---------------------------------------------------------------------------
# the fused routes and the kernels' plain versions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("flip", [False, True], ids=["spd", "indefinite"])
def test_cg_lanczos_fused_ref_matches_jax_kernel(dtype, flip):
    D, A, b = _poisson(dtype=dtype, flip=flip)
    n = b.shape[0]
    pj = jdia_align(D.data, D.offsets, n)
    pt = dia_align(A.data, A.offsets, n)
    ot = offsets_tensor(A.offsets, "cpu")
    rtol = 1e-6 if dtype == np.float32 else 1e-10
    j = jf.cg_lanczos_dia_fused(pj, D.offsets, jnp.asarray(b), 0.0, rtol,
                                2 * n, check_curvature=flip,
                                interpret=True)
    t = tf.cg_lanczos_dia_fused_ref(pt, ot, torch.as_tensor(b), 0.0, rtol,
                                    2 * n, check_curvature=flip)
    j = [np.asarray(v) for v in j]
    t = [v.numpy() for v in t]
    assert int(t[4]) == int(j[4])                     # status
    assert int(t[5]) == int(j[5])                     # indefinite
    if flip:
        assert int(t[4]) == tf.NEG_CURV
    if dtype == np.float64:
        assert int(t[1]) == int(j[1])
        assert _rel(t[0], j[0]) <= 1e-8
        assert abs(float(t[3]) - float(j[3])) <= 1e-8 * float(j[3])
    else:
        assert abs(int(t[1]) - int(j[1])) <= max(2, 0.1 * int(j[1]))
        assert _rel(t[0], j[0]) <= 1e-3


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_cg_lanczos_fused_route_matches_jax(dtype):
    D, A, b = _poisson(dtype=dtype)
    kw = dict(atol=0.0, rtol=1e-6)
    xj, sj = kj.cg_lanczos(JDIAOperator(D, use_pallas=True), b, **kw)
    n0 = tf.cg_lanczos_dia_fused.launches
    xt, st = kt.cg_lanczos(kt.DIAOperator(A, use_kernel=True),
                           torch.as_tensor(b), **kw)
    assert tf.cg_lanczos_dia_fused.launches == n0     # CPU: plain version
    assert st.status == sj.status and st.residuals.size == 0
    if dtype == np.float64:
        _same(xt, st, xj, sj)
    else:
        assert abs(st.niter - sj.niter) <= max(2, 0.1 * sj.niter)
        assert _rel(xt.numpy(), xj) <= 1e-3


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("curvature", [False, True])
def test_cg_lanczos_shift_fused_ref_matches_jax_kernel(dtype, curvature):
    D, A, b = _poisson(dtype=dtype)
    n = b.shape[0]
    shifts = [-2.0, 0.0, 0.5, 2.0] if curvature else [0.0, 0.5, 2.0]
    pj = jdia_align(D.data, D.offsets, n)
    pt = dia_align(A.data, A.offsets, n)
    ot = offsets_tensor(A.offsets, "cpu")
    rtol = 1e-6 if dtype == np.float32 else 1e-10
    j = jf.cg_lanczos_shift_dia_fused(
        pj, D.offsets, jnp.asarray(b), jnp.asarray(shifts, dtype),
        len(shifts), 0.0, rtol, 2 * n, check_curvature=curvature,
        interpret=True)
    t = tf.cg_lanczos_shift_dia_fused_ref(
        pt, ot, torch.as_tensor(b), torch.tensor(shifts, dtype=pt.dtype),
        0.0, rtol, 2 * n, check_curvature=curvature)
    j = [np.asarray(v) for v in j]
    t = [v.numpy() for v in t]
    assert t[0].shape == (len(shifts), n)
    assert int(t[3]) == int(j[3])                     # status
    assert np.array_equal(t[4], j[4])                 # indefinite
    if dtype == np.float64:
        assert int(t[1]) == int(j[1])
        assert _rel(t[0], j[0]) <= 1e-8
        assert _rel(t[2], j[2]) <= 1e-6
    else:
        assert abs(int(t[1]) - int(j[1])) <= max(2, 0.1 * int(j[1]))
        assert _rel(t[0], j[0]) <= 1e-3


def test_cg_lanczos_shift_fused_route_matches_jax():
    D, A, b = _poisson()
    shifts = [0.0, 0.5, 2.0]
    kw = dict(atol=0.0, rtol=1e-8)
    Xj, sj = kj.cg_lanczos_shift(JDIAOperator(D, use_pallas=True), b,
                                 jnp.asarray(shifts), **kw)
    Xt, st = kt.cg_lanczos_shift(kt.DIAOperator(A, use_kernel=True),
                                 torch.as_tensor(b), shifts, **kw)
    _same_shift(Xt, st, Xj, sj)
    for i, sig in enumerate(shifts):
        r = torch.as_tensor(b) - (A @ Xt[i] + sig * Xt[i])
        assert float(r.norm()) <= 2e-8 * float(np.linalg.norm(b))
