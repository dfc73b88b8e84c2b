"""krylov_tpu_torch.gmres and fgmres against krylov_tpu's, on both routes
(the cases of tests/test_gmres.py and tests/test_fused.py), and the
plain version of the GMRES whole-solve kernel against krylov_tpu's
``gmres_dia_fused`` in interpret mode.

Inputs are made with numpy from a seed (or the fixture generators) and
given to both packages; a CSR fixture goes to the port through
``convert.csr_from_numpy``.  Tolerances: in f64 and c128 the status
string, niter and the inconsistent flag are equal and x agrees to 1e-8
relative (reductions are summed in another order), the histories to
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
from krylov_tpu.operators import DIAOperator as JDIAOperator
from krylov_tpu.ops.dia import convdiff_dia as jconvdiff
from krylov_tpu.ops.pallas_dia import dia_align as jdia_align
from krylov_tpu_torch.convert import csr_from_numpy, dia_from_numpy
from krylov_tpu_torch.ops import cuda_fused as tf
from krylov_tpu_torch.ops.cuda_dia import dia_align, offsets_tensor

METHODS = ["gmres", "fgmres"]


@pytest.fixture(params=[np.float64, np.complex128], ids=["f64", "c128"])
def FC(request):
    return request.param


def _rel(a, b):
    a, b = np.asarray(a, np.complex128), np.asarray(b, np.complex128)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300)


def port(A):
    """The port's copy of a fixture matrix: a tensor, or a CSRMatrix."""
    if isinstance(A, np.ndarray):
        return torch.as_tensor(A)
    return csr_from_numpy(np.asarray(A.data), np.asarray(A.indices),
                          np.asarray(A.indptr), np.asarray(A.rows), A.shape,
                          device="cpu")


def _same(xt, st, xj, sj, tol=1e-8):
    assert st.status == sj.status
    assert st.niter == sj.niter
    assert st.solved == sj.solved
    assert st.inconsistent == sj.inconsistent
    assert _rel(xt.numpy(), xj) <= tol


def _band(xt, st, xj, sj):
    """The f32 comparison."""
    assert st.status == sj.status
    assert abs(st.niter - sj.niter) <= max(2, 0.1 * sj.niter)
    assert _rel(xt.numpy(), xj) <= 1e-3


def _both(method, A, b, *args, **kw):
    xj, sj = getattr(kj, method)(A, b, *args, **kw)
    xt, st = getattr(kt, method)(port(A), torch.as_tensor(np.asarray(b)),
                                 *args, **kw)
    return xt, st, xj, sj


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("make", [fx.nonsymmetric_definite,
                                  fx.nonsymmetric_indefinite,
                                  fx.square_consistent, fx.zero_rhs],
                         ids=["nonsym_definite", "nonsym_indefinite",
                              "square_consistent", "zero_rhs"])
def test_dense_fixtures(method, make, FC):
    A, b = make(FC=FC)
    _same(*_both(method, A, b))


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("kw", [{}, {"memory": 8, "restart": True},
                                {"itmax": 3, "rtol": 1e-30, "atol": 1e-30}],
                         ids=["default", "restart", "itmax"])
def test_sparse_laplacian(method, kw):
    A, b = fx.sparse_laplacian(8)
    _same(*_both(method, A, b, **kw))


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("kw", [{}, {"memory": 10, "restart": True}],
                         ids=["warm", "warm_restart"])
def test_warm_start(method, kw):
    A, b = fx.warm_start_system()
    _same(*_both(method, A, b, 0.99 * np.ones(b.shape[0]), **kw))


@pytest.mark.parametrize("method", METHODS)
def test_preconditioners_and_ldiv(method, FC):
    A, b, M_inv, N_inv = fx.two_preconditioners(FC=FC)
    mj = kj.DiagonalOperator(jnp.asarray(np.diag(M_inv)))
    nj = kj.DiagonalOperator(jnp.asarray(np.diag(N_inv)))
    mt = kt.DiagonalOperator(torch.as_tensor(np.diag(M_inv).copy()))
    nt = kt.DiagonalOperator(torch.as_tensor(np.diag(N_inv).copy()))
    for ldiv in (False, True):
        xj, sj = getattr(kj, method)(A, b, M=mj, N=nj, ldiv=ldiv)
        xt, st = getattr(kt, method)(torch.as_tensor(A), torch.as_tensor(b),
                                     M=mt, N=nt, ldiv=ldiv)
        _same(xt, st, xj, sj)


@pytest.mark.parametrize("method", METHODS)
def test_history_and_reorthogonalization(method):
    A, b = fx.nonsymmetric_definite()
    xt, st, xj, sj = _both(method, A, b, history=True)
    _same(xt, st, xj, sj)
    assert len(st.residuals) == st.niter + 1
    assert _rel(st.residuals, sj.residuals) <= 1e-8
    A, b = fx.sparse_laplacian(8)
    xt, st, xj, sj = _both(method, A, b, memory=5, restart=True,
                           history=True)
    _same(xt, st, xj, sj)
    assert _rel(st.residuals, sj.residuals) <= 1e-8
    A, b = fx.kron_unsymmetric(4)
    _same(*_both(method, A, b, reorthogonalization=True))


def test_square_inconsistent_and_f32():
    A, b = fx.square_inconsistent()
    xt, st, xj, sj = _both("gmres", A, b)
    _same(xt, st, xj, sj)
    assert st.inconsistent
    A, b = fx.nonsymmetric_definite(FC=np.float32)
    _band(*_both("gmres", A, b))
    A, b = fx.sparse_laplacian(8, FC=np.float32)
    _band(*_both("fgmres", A, b, memory=6, restart=True))


def test_callback():
    A, b = fx.sparse_laplacian(8)

    def cb(state):
        return state.iter >= 4

    xt, st, xj, sj = _both("gmres", A, b, callback=cb, rtol=1e-30,
                           atol=1e-30)
    _same(xt, st, xj, sj)
    assert st.status == "user-requested exit" and st.niter == 4


def test_callback_sees_pass_boundary_state():
    """At a restart the callback sees the state after the pass end: x
    moved, rNorm the restarted residual (tests/test_gmres.py)."""
    A, b = fx.sparse_laplacian(8)
    bn = np.linalg.norm(np.asarray(b))

    def cb(state):
        return state.rNorm <= 1e-6 * bn

    xt, st, xj, sj = _both("gmres", A, b, memory=5, restart=True,
                           callback=cb, rtol=1e-30, atol=1e-30)
    _same(xt, st, xj, sj)
    assert st.status == "user-requested exit" and st.niter % 5 == 0


def test_fgmres_variable_preconditioner():
    A, b = fx.nonsymmetric_definite(n=20)
    d = 1.0 / np.diag(A)
    nj = kj.FunctionOperator(lambda v: jnp.asarray(d) * v, (20, 20),
                             jnp.float64)
    dt = torch.as_tensor(d)
    nt = kt.FunctionOperator(lambda v: dt * v, (20, 20), torch.float64)
    xj, sj = kj.fgmres(A, b, N=nj)
    xt, st = kt.fgmres(torch.as_tensor(A), torch.as_tensor(b), N=nt)
    _same(xt, st, xj, sj)


def test_timemax_verbose_and_options(capsys):
    A, b = fx.sparse_laplacian(8)
    xt, st = kt.gmres(port(A), torch.as_tensor(b), memory=5, restart=True,
                      rtol=1e-30, atol=1e-30, itmax=300, timemax=1e-9)
    assert st.status == "time limit exceeded" and st.niter == 64
    xt, st, xj, sj = _both("gmres", A, b, verbose=1)
    _same(xt, st, xj, sj)
    out = capsys.readouterr().out
    assert "GMRES: system of size 512" in out and "pass" in out
    with pytest.raises(ValueError, match="basis_dtype"):
        kt.gmres(port(A), torch.as_tensor(b), basis_dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
        kt.gmres(port(A), torch.as_tensor(b), precision="double_word")
    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
        kt.fgmres(port(A), torch.as_tensor(b), precision="double_word")
    with pytest.raises(ValueError, match="square"):
        kt.gmres(torch.ones((3, 4), dtype=torch.float64),
                 torch.ones(3, dtype=torch.float64))


# ---------------------------------------------------------------------------
# the whole-solve kernel's route and its plain version
# ---------------------------------------------------------------------------

def _convdiff(N=6, dtype=np.float64, seed=4):
    D = jconvdiff(N, N, N, dtype=dtype)
    A = dia_from_numpy(np.array(D.data), D.offsets, D.shape, device="cpu")
    b = np.random.default_rng(seed).standard_normal(N ** 3).astype(dtype)
    return D, A, b


@pytest.fixture
def fused_calls(monkeypatch):
    """Counts the calls of the GMRES kernel's plain version, which the
    kernel wrapper takes for CPU tensors."""
    calls = []
    ref = tf.gmres_dia_fused_ref

    def counted(*a, **k):
        calls.append(k.get("basis_dtype", a[7] if len(a) > 7 else None))
        return ref(*a, **k)

    monkeypatch.setattr(tf, "gmres_dia_fused_ref", counted)
    return calls


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("kw", [{"memory": 20, "restart": True}, {},
                                {"x0": True}],
                         ids=["restart20", "default", "warm_start"])
def test_fused_route_matches_jax(method, kw, fused_calls):
    D, A, b = _convdiff()
    args = ()
    kw = dict(kw)
    if kw.pop("x0", False):
        args = (0.5 * np.ones(b.shape[0]),)
    kw.update(atol=0.0, rtol=1e-10)
    xj, sj = getattr(kj, method)(JDIAOperator(D, use_pallas=True),
                                 jnp.asarray(b), *args, **kw)
    xt, st = getattr(kt, method)(kt.DIAOperator(A, use_kernel=True),
                                 torch.as_tensor(b), *args, **kw)
    _same(xt, st, xj, sj)
    assert len(fused_calls) == 1


def test_fused_route_bf16_basis_and_fallbacks(fused_calls):
    D, A, b = _convdiff(dtype=np.float32)
    op = kt.DIAOperator(A, use_kernel=True)
    kw = dict(memory=20, restart=True, atol=0.0, rtol=1e-5)
    xj, sj = kj.gmres(JDIAOperator(D, use_pallas=True), jnp.asarray(b),
                      basis_dtype=jnp.bfloat16, **kw)
    xt, st = kt.gmres(op, torch.as_tensor(b), basis_dtype=torch.bfloat16,
                      **kw)
    _band(xt, st, xj, sj)
    assert fused_calls == [torch.bfloat16]
    # history, an M or N take the general route
    xt, st = kt.gmres(op, torch.as_tensor(b), history=True, **kw)
    assert st.solved and len(st.residuals) == st.niter + 1
    xt, st = kt.fgmres(op, torch.as_tensor(b), N=kt.IdentityOperator(),
                       **kw)
    assert st.solved and len(fused_calls) == 1
    with pytest.raises(ValueError, match="basis_dtype"):
        kt.gmres(op, torch.as_tensor(b), basis_dtype=torch.bfloat16,
                 history=True)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("mem", [3, 20])
@pytest.mark.parametrize("basis", [None, "bf16"])
def test_plain_version_matches_jax_kernel(dtype, mem, basis):
    D, A, b = _convdiff(dtype=dtype)
    pdj = jdia_align(D.data, D.offsets, D.shape[0])
    pd = dia_align(A.data, A.offsets, A.shape[0])
    ot = offsets_tensor(A.offsets, "cpu")
    rtol = 1e-10 if dtype == np.float64 else 1e-6
    rj = jf.gmres_dia_fused(pdj, D.offsets, jnp.asarray(b), 0.0, rtol, 400,
                            mem=mem, interpret=True,
                            basis_dtype=jnp.bfloat16 if basis else None)
    rt_ = tf.gmres_dia_fused_ref(pd, ot, torch.as_tensor(b), 0.0, rtol, 400,
                                 mem, torch.bfloat16 if basis else None)
    niter_j, status_j, incons_j, npass_j = (int(rj[i]) for i in (1, 3, 4, 5))
    niter_t, status_t, incons_t, npass_t = (int(rt_[i]) for i in (1, 3, 4, 5))
    assert (status_t, incons_t) == (status_j, incons_j)
    if dtype == np.float64:
        assert (niter_t, npass_t) == (niter_j, npass_j)
        assert _rel(rt_[0].numpy(), rj[0]) <= 1e-8
        assert abs(float(rt_[2]) - float(rj[2])) <= 1e-10 * np.linalg.norm(b)
    else:
        assert abs(niter_t - niter_j) <= max(2, 0.1 * niter_j)
        assert _rel(rt_[0].numpy(), rj[0]) <= 1e-3


def test_plain_version_zero_rhs_and_itmax():
    D, A, b = _convdiff()
    pd = dia_align(A.data, A.offsets, A.shape[0])
    ot = offsets_tensor(A.offsets, "cpu")
    x, niter, rnorm, status, incons, npass = tf.gmres_dia_fused_ref(
        pd, ot, torch.zeros(b.shape[0], dtype=torch.float64), 0.0, 1e-8, 50)
    assert (int(niter), int(status), float(rnorm)) == (0, 2, 0.0)
    pdj = jdia_align(D.data, D.offsets, D.shape[0])
    rj = jf.gmres_dia_fused(pdj, D.offsets, jnp.asarray(b), 0.0, 1e-14, 7,
                            mem=3, interpret=True)
    rt_ = tf.gmres_dia_fused_ref(pd, ot, torch.as_tensor(b), 0.0, 1e-14, 7,
                                 3)
    assert [int(rt_[i]) for i in (1, 3, 5)] == [int(rj[i]) for i in (1, 3, 5)]
    assert int(rt_[3]) == 100
