"""krylov_tpu_torch.bicgstab and cgs against krylov_tpu's, on both routes
(the cases of tests/test_fused.py:709-800 and of the reference's
bicgstab/cgs tests as tests/test_fixture_zoo.py drives them), and the
plain versions of their whole-solve kernels against krylov_tpu's
``bicgstab_dia_fused`` and ``cgs_dia_fused`` in interpret mode.

Inputs are made with numpy from a seed (or the fixture generators) and
given to both packages; a CSR fixture goes to the port through
``convert.csr_from_numpy``.  Tolerances: in f64 and c128 the status
string and niter are equal and x agrees to 1e-8 relative (reductions are
summed in another order), the histories to 1e-8; in f32 the status is
equal, niter within ±max(2, 10%) (the band of
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
from krylov_tpu.ops.pallas_dia import dia_align as jdia_align
from krylov_tpu_torch.ops import cuda_fused as tf
from krylov_tpu_torch.ops.cuda_dia import dia_align, offsets_tensor
from test_torch_gmres import _band, _both, _convdiff, _rel, _same, port

METHODS = ["bicgstab", "cgs"]


@pytest.fixture(params=[np.float64, np.complex128], ids=["f64", "c128"])
def FC(request):
    return request.param


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("make", [fx.nonsymmetric_definite,
                                  fx.nonsymmetric_indefinite, fx.zero_rhs],
                         ids=["nonsym_definite", "nonsym_indefinite",
                              "zero_rhs"])
def test_dense_fixtures(method, make, FC):
    A, b = make(FC=FC)
    _same(*_both(method, A, b))


@pytest.mark.parametrize("method", METHODS)
def test_sparse_laplacian_history_and_itmax(method):
    A, b = fx.sparse_laplacian(8)
    _same(*_both(method, A, b))
    xt, st, xj, sj = _both(method, A, b, history=True)
    _same(xt, st, xj, sj)
    assert len(st.residuals) == st.niter + 1
    assert _rel(st.residuals, sj.residuals) <= 1e-8
    _same(*_both(method, A, b, itmax=3, rtol=1e-30, atol=1e-30))


@pytest.mark.parametrize("method", METHODS)
def test_preconditioners_ldiv_and_shadow(method, FC):
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
    A, b = fx.nonsymmetric_definite(FC=FC)
    c = np.random.default_rng(2).standard_normal(b.shape[0]).astype(FC)
    _same(*_both(method, A, b, c=c))


@pytest.mark.parametrize("method", METHODS)
def test_warm_start_callback_and_f32(method):
    A, b = fx.warm_start_system()
    _same(*_both(method, A, b, 0.99 * np.ones(b.shape[0])))
    A, b = fx.sparse_laplacian(8)

    def cb(state):
        return state.iter >= 4

    xt, st, xj, sj = _both(method, A, b, callback=cb, rtol=1e-30,
                           atol=1e-30)
    _same(xt, st, xj, sj)
    assert st.status == "user-requested exit" and st.niter == 4
    A, b = fx.sparse_laplacian(8, FC=np.float32)
    _band(*_both(method, A, b))


@pytest.mark.parametrize("method", METHODS)
def test_breakdowns_timemax_and_options(method, capsys):
    """bᴴc = 0 (a shadow orthogonal to b) and the α breakdown of
    tests/test_fixture_zoo.py's square_inconsistent case."""
    A, b = fx.nonsymmetric_definite()
    c = np.zeros_like(b)
    c[0], c[1] = b[1], -b[0]
    xt, st, xj, sj = _both(method, A, b, c=c)
    _same(xt, st, xj, sj)
    assert st.status == "Breakdown bᴴc = 0"
    A, b = fx.square_inconsistent()
    xt, st, xj, sj = _both(method, A, b)
    assert st.status == sj.status and st.niter == sj.niter
    # a random matrix, on which neither method stops within 64 iterations
    A = np.random.default_rng(0).standard_normal((100, 100))
    xt, st = getattr(kt, method)(torch.as_tensor(A), torch.ones(
        100, dtype=torch.float64), rtol=1e-30, atol=1e-30, itmax=300,
        timemax=1e-9)
    assert st.status == "time limit exceeded" and st.niter == 64
    A, b = fx.sparse_laplacian(8)
    xt, st, xj, sj = _both(method, A, b, verbose=1)
    _same(xt, st, xj, sj)
    assert f"{method.upper()}: system of size 512" in capsys.readouterr().out
    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
        getattr(kt, method)(port(A), torch.as_tensor(b),
                            precision="double_word")


@pytest.fixture
def fused_calls(monkeypatch):
    calls = []
    for name in ("bicgstab_dia_fused_ref", "cgs_dia_fused_ref"):
        ref = getattr(tf, name)

        def counted(*a, _ref=ref, _name=name, **k):
            calls.append(_name)
            return _ref(*a, **k)

        monkeypatch.setattr(tf, name, counted)
    return calls


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_fused_route_matches_jax(method, dtype, fused_calls):
    D, A, b = _convdiff(N=8, dtype=dtype, seed=8)
    op = kt.DIAOperator(A, use_kernel=True)
    rtol = 1e-8 if dtype == np.float64 else 1e-5
    xj, sj = getattr(kj, method)(JDIAOperator(D, use_pallas=True),
                                 jnp.asarray(b), atol=0.0, rtol=rtol)
    xt, st = getattr(kt, method)(op, torch.as_tensor(b), atol=0.0, rtol=rtol)
    (_same if dtype == np.float64 else _band)(xt, st, xj, sj)
    assert fused_calls == [method + "_dia_fused_ref"]
    # a shadow c, a warm start, history or M take the general route
    tb = torch.as_tensor(b)
    for kw in ({"c": tb.clone()}, {"history": True},
               {"M": kt.IdentityOperator()}):
        xt, st = getattr(kt, method)(op, tb, atol=0.0, rtol=rtol, **kw)
        assert st.solved
    xt, st = getattr(kt, method)(op, tb, torch.zeros_like(tb), atol=0.0,
                                 rtol=rtol)
    assert st.solved and len(fused_calls) == 1
    xt, st = getattr(kt, method)(op, torch.zeros_like(tb))
    assert st.niter == 0 and st.status == "x is a zero-residual solution"


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_plain_version_matches_jax_kernel(method, dtype):
    D, A, b = _convdiff(dtype=dtype)
    pdj = jdia_align(D.data, D.offsets, D.shape[0])
    pd = dia_align(A.data, A.offsets, A.shape[0])
    ot = offsets_tensor(A.offsets, "cpu")
    rtol = 1e-10 if dtype == np.float64 else 1e-6
    rj = getattr(jf, method + "_dia_fused")(pdj, D.offsets, jnp.asarray(b),
                                            0.0, rtol, 400, interpret=True)
    rt_ = getattr(tf, method + "_dia_fused_ref")(pd, ot, torch.as_tensor(b),
                                                 0.0, rtol, 400)
    assert int(rt_[3]) == int(rj[3])
    if dtype == np.float64:
        assert int(rt_[1]) == int(rj[1])
        assert _rel(rt_[0].numpy(), rj[0]) <= 1e-8
    else:
        assert abs(int(rt_[1]) - int(rj[1])) <= max(2, 0.1 * int(rj[1]))
        assert _rel(rt_[0].numpy(), rj[0]) <= 1e-3
