"""krylov_tpu_torch.diom and dqgmres against krylov_tpu's, on both routes
(the cases of tests/test_fom_family.py and of tests/test_fused.py:
1088-1120), and the plain version of the truncated whole-solve kernel
against krylov_tpu's ``trunc_dia_fused`` in interpret mode.

Inputs are made with numpy from a seed (or the fixture generators) and
given to both packages; a CSR fixture goes to the port through
``convert.csr_from_numpy``.  Tolerances: in f64 and c128 the status
string and niter are equal and x agrees to 1e-10 relative (the window
dots and the column recurrence are summed in another order), the
histories to 1e-10; in f32 the status is equal, niter within
±max(2, 10%) (the band of tests/reference_niter.json) and x to 1e-3
relative.
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

METHODS = ["diom", "dqgmres"]


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
    _same(*_both(method, A, b), tol=1e-10)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("kw", [{"memory": 30}, {"memory": 2},
                                {"itmax": 3, "rtol": 1e-30, "atol": 1e-30}],
                         ids=["memory30", "memory2", "itmax"])
def test_sparse_laplacian(method, kw):
    A, b = fx.sparse_laplacian(8)
    _same(*_both(method, A, b, **kw), tol=1e-10)


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
        _same(xt, st, xj, sj, tol=1e-10)


@pytest.mark.parametrize("method", METHODS)
def test_history_reorthogonalization_and_warm_start(method):
    A, b = fx.nonsymmetric_definite()
    xt, st, xj, sj = _both(method, A, b, history=True)
    _same(xt, st, xj, sj, tol=1e-10)
    assert len(st.residuals) == st.niter + 1
    assert _rel(st.residuals, sj.residuals) <= 1e-10
    _same(*_both(method, A, b, reorthogonalization=True, memory=4),
          tol=1e-10)
    A, b = fx.warm_start_system()
    _same(*_both(method, A, b, 0.99 * np.ones(b.shape[0])), tol=1e-10)


@pytest.mark.parametrize("method", METHODS)
def test_callback_timemax_and_options(method, capsys):
    A, b = fx.sparse_laplacian(8)

    def cb(state):
        return state.iter >= 4

    xt, st, xj, sj = _both(method, A, b, callback=cb, rtol=1e-30,
                           atol=1e-30)
    _same(xt, st, xj, sj, tol=1e-10)
    assert st.status == "user-requested exit" and st.niter == 4
    # a random matrix, on which neither method stops within 64 iterations
    R = np.random.default_rng(0).standard_normal((100, 100))
    xt, st = getattr(kt, method)(torch.as_tensor(R), torch.ones(
        100, dtype=torch.float64), memory=5, rtol=1e-30, atol=1e-30,
        itmax=300, timemax=1e-9)
    assert st.status == "time limit exceeded" and st.niter == 64
    xt, st, xj, sj = _both(method, A, b, verbose=2)
    _same(xt, st, xj, sj, tol=1e-10)
    assert f"{method.upper()}: system of size 512" in capsys.readouterr().out
    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
        getattr(kt, method)(port(A), torch.as_tensor(b),
                            precision="double_word")


@pytest.fixture
def fused_calls(monkeypatch):
    """Counts the calls of the truncated kernel's plain version, which the
    kernel wrapper takes for CPU tensors, with their (mem, variant)."""
    calls = []
    ref = tf.trunc_dia_fused_ref

    def counted(*a, **k):
        calls.append(a[6:8])
        return ref(*a, **k)

    monkeypatch.setattr(tf, "trunc_dia_fused_ref", counted)
    return calls


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_fused_route_matches_jax(method, dtype, fused_calls):
    """The kernel route is taken exactly where the JAX gate admits it
    (krylov_tpu/solvers/fom.py:632-659): M = N = None, no history,
    callback, verbose, reorthogonalization or timemax; a warm start keeps
    it (the kernel solves for b − A x0)."""
    D, A, b = _convdiff(N=8, dtype=dtype, seed=5)
    op = kt.DIAOperator(A, use_kernel=True)
    rtol = 1e-8 if dtype == np.float64 else 1e-5
    jop = JDIAOperator(D, use_pallas=True)
    for mem in (6, 20):
        xj, sj = getattr(kj, method)(jop, jnp.asarray(b), memory=mem,
                                     atol=0.0, rtol=rtol)
        xt, st = getattr(kt, method)(op, torch.as_tensor(b), memory=mem,
                                     atol=0.0, rtol=rtol)
        if dtype == np.float64:
            _same(xt, st, xj, sj, tol=1e-10)
        else:
            _band(xt, st, xj, sj)
    assert fused_calls == [(6, method), (20, method)]
    tb = torch.as_tensor(b)
    xt, st = getattr(kt, method)(op, tb, 0.5 * torch.ones_like(tb),
                                 atol=0.0, rtol=rtol)
    assert st.solved and len(fused_calls) == 3
    for kw in ({"history": True}, {"M": kt.IdentityOperator()},
               {"reorthogonalization": True}, {"timemax": 1e6},
               {"verbose": 0, "callback": lambda s: False}):
        xt, st = getattr(kt, method)(op, tb, atol=0.0, rtol=rtol, **kw)
        assert st.solved
    assert len(fused_calls) == 3
    xt, st = getattr(kt, method)(op, torch.zeros_like(tb))
    assert st.niter == 0 and st.status == "x is a zero-residual solution"


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("mem", [2, 6, 20])
def test_plain_version_matches_jax_kernel(method, mem):
    """mem = 2 gives DIOM a P ring of one slot; in f64 niter, status and x
    agree with the JAX kernel run in interpret mode."""
    D, A, b = _convdiff()
    pdj = jdia_align(D.data, D.offsets, D.shape[0])
    pd = dia_align(A.data, A.offsets, A.shape[0])
    ot = offsets_tensor(A.offsets, "cpu")
    rj = jf.trunc_dia_fused(pdj, D.offsets, jnp.asarray(b), 0.0, 1e-10, 300,
                            mem=mem, variant=method, interpret=True)
    rt_ = tf.trunc_dia_fused_ref(pd, ot, torch.as_tensor(b), 0.0, 1e-10, 300,
                                 mem, method)
    assert [int(rt_[i]) for i in (1, 3)] == [int(rj[i]) for i in (1, 3)]
    assert _rel(rt_[0].numpy(), rj[0]) <= 1e-10
    assert abs(float(rt_[2]) - float(rj[2])) <= 1e-10 * float(
        np.linalg.norm(b))


@pytest.mark.parametrize("method", METHODS)
def test_plain_version_f32_and_zero_rhs(method):
    D, A, b = _convdiff(dtype=np.float32)
    pdj = jdia_align(D.data, D.offsets, D.shape[0])
    pd = dia_align(A.data, A.offsets, A.shape[0])
    ot = offsets_tensor(A.offsets, "cpu")
    rj = jf.trunc_dia_fused(pdj, D.offsets, jnp.asarray(b), 0.0, 1e-6, 300,
                            mem=20, variant=method, interpret=True)
    rt_ = tf.trunc_dia_fused_ref(pd, ot, torch.as_tensor(b), 0.0, 1e-6, 300,
                                 20, method)
    assert int(rt_[3]) == int(rj[3])
    assert abs(int(rt_[1]) - int(rj[1])) <= max(2, 0.1 * int(rj[1]))
    assert _rel(rt_[0].numpy(), rj[0]) <= 1e-3
    x, niter, rnorm, status = tf.trunc_dia_fused(
        pd, ot, torch.zeros_like(torch.as_tensor(b)), 0.0, 1e-6, 300, 20,
        method)
    assert (int(niter), int(status), float(rnorm)) == (0, 2, 0.0)
    assert not x.any()
    with pytest.raises(ValueError, match="mem must be >= 2"):
        tf.trunc_dia_fused(pd, ot, torch.as_tensor(b), 0.0, 1e-6, 300, 1,
                           method)
