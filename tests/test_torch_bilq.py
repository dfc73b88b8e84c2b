"""krylov_tpu_torch.bilq, qmr and bilqr against krylov_tpu's, on both
routes (the cases of tests/test_twosided.py:25-80, of
tests/test_fixture_zoo.py's bi-Lanczos breakdowns and of
tests/test_fused.py:986-1040, 1387-1420), and the plain versions of
their whole-solve kernels against krylov_tpu's ``bilq_dia_fused``,
``qmr_dia_fused`` and ``bilqr_dia_fused`` in interpret mode.

Inputs are made with numpy from a seed (or the fixture generators) and
given to both packages; a CSR fixture goes to the port through
``convert.csr_from_numpy``.  Tolerances: in f64 and c128 the status
string and niter are equal and x (and y) agree to 1e-10 relative (the
reductions are summed in another order), the histories to 1e-10; in
f32 the status is equal, niter within ±max(2, 10%) (the band of
tests/reference_niter.json) and x to 1e-3 relative.  BiLQR's residual
estimates lose digits by cancellation as the residuals fall, so on
``square_adjoint(50)`` in f64 the JAX general core itself stops at
another iteration when only the order of its matvec's sums changes;
that fixture is held to the status, the band and the true residuals.
"""

import itertools

import numpy as np
import jax.numpy as jnp
import pytest
torch = pytest.importorskip("torch")

import fixtures as fx
import krylov_tpu as kj
import krylov_tpu.ops.pallas_fused as jf
import krylov_tpu_torch as kt
from krylov_tpu.operators import DIAOperator as JDIAOperator
from krylov_tpu.operators import FunctionOperator as JFunctionOperator
from krylov_tpu.ops.pallas_dia import dia_align as jdia_align
from krylov_tpu.solvers.bilq import _bilqr_status as jbilqr_status
from krylov_tpu_torch.convert import dia_from_numpy
from krylov_tpu_torch.ops import cuda_fused as tf
from krylov_tpu_torch.ops.cuda_dia import (dia_align, dia_align_adjoint,
                                           offsets_tensor)
from krylov_tpu_torch.solvers.bilq import _bilqr_status
from test_torch_gmres import _band, _both, _convdiff, _rel, _same, port

METHODS = ["bilq", "qmr"]
TOL = 1e-10


@pytest.fixture(params=[np.float64, np.complex128], ids=["f64", "c128"])
def FC(request):
    return request.param


def _t(v):
    return None if v is None else torch.as_tensor(np.asarray(v))


def _both_bilqr(A, b, c, *args, **kw):
    xj, yj, sj = kj.bilqr(A, b, c, *args, **kw)
    xt, yt, st = kt.bilqr(port(A), _t(b), _t(c),
                          *[_t(a) for a in args], **kw)
    return (xt, yt, st), (xj, yj, sj)


def _same_bilqr(rt_, rj, tol=TOL):
    (xt, yt, st), (xj, yj, sj) = rt_, rj
    assert st.status == sj.status
    assert st.niter == sj.niter
    assert (st.solved_primal, st.solved_dual) == (sj.solved_primal,
                                                  sj.solved_dual)
    assert _rel(xt.numpy(), xj) <= tol
    assert _rel(yt.numpy(), yj) <= tol


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("make", [fx.nonsymmetric_definite,
                                  fx.nonsymmetric_indefinite, fx.zero_rhs],
                         ids=["nonsym_definite", "nonsym_indefinite",
                              "zero_rhs"])
def test_dense_fixtures(method, make, FC):
    A, b = make(FC=FC)
    _same(*_both(method, A, b), tol=TOL)


@pytest.mark.parametrize("method", METHODS)
def test_kron_history_and_itmax(method):
    A, b = fx.kron_unsymmetric(4)
    _same(*_both(method, A, b), tol=TOL)
    xt, st, xj, sj = _both(method, A, b, history=True)
    _same(xt, st, xj, sj, tol=TOL)
    assert len(st.residuals) == st.niter + 1
    assert _rel(st.residuals, sj.residuals) <= TOL
    _same(*_both(method, A, b, itmax=3, rtol=1e-30, atol=1e-30), tol=TOL)


@pytest.mark.parametrize("method", METHODS)
def test_breakdowns_shadow_and_warm_start(method, FC):
    """bᴴc = 0, the bi-Lanczos breakdown trigger of reference
    test_bilq.jl:53-58 (which ends at the solution), a custom shadow c
    and a warm start."""
    A, b, c = fx.bc_breakdown(FC=FC)
    xt, st, xj, sj = _both(method, A, b, c=c)
    _same(xt, st, xj, sj, tol=TOL)
    assert st.status == "Breakdown bᴴc = 0"
    A, b, c = fx.unsymmetric_breakdown(FC=FC)
    _same(*_both(method, A, b, c=c), tol=TOL)
    A, b = fx.nonsymmetric_definite(FC=FC)
    c = np.random.default_rng(2).standard_normal(b.shape[0]).astype(FC)
    _same(*_both(method, A, b, c=c), tol=TOL)
    A, b = fx.warm_start_system()
    _same(*_both(method, A, b, 0.99 * np.ones(b.shape[0])), tol=TOL)


@pytest.mark.parametrize("method", METHODS)
def test_callback_timemax_and_options(method, capsys):
    A, b = fx.sparse_laplacian(8)

    def cb(state):
        return state.iter >= 4

    xt, st, xj, sj = _both(method, A, b, callback=cb, rtol=1e-30,
                           atol=1e-30)
    _same(xt, st, xj, sj, tol=TOL)
    assert st.status == "user-requested exit" and st.niter == 4
    # a random matrix, on which neither method stops within 64 iterations
    R = np.random.default_rng(0).standard_normal((100, 100))
    xt, st = getattr(kt, method)(torch.as_tensor(R), torch.ones(
        100, dtype=torch.float64), rtol=1e-30, atol=1e-30, itmax=300,
        timemax=1e-9)
    assert st.status == "time limit exceeded" and st.niter == 64
    xt, st, xj, sj = _both(method, A, b, verbose=1)
    _same(xt, st, xj, sj, tol=TOL)
    assert f"{method.upper()}: system of size 512" in capsys.readouterr().out
    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
        getattr(kt, method)(port(A), torch.as_tensor(b),
                            precision="double_word")


def test_bilq_without_transfer():
    A, b = fx.nonsymmetric_indefinite()
    xt, st, xj, sj = _both("bilq", A, b, transfer_to_bicg=False)
    _same(xt, st, xj, sj, tol=TOL)
    assert st.status == "solution xᴸ good enough given atol and rtol"


@pytest.mark.parametrize("make", [
    lambda FC: fx.square_adjoint(n=20, FC=FC),
    lambda FC: fx.adjoint_ode(50, FC=FC),
    lambda FC: fx.adjoint_pde(8, 8, FC=FC)],
    ids=["square_adjoint20", "adjoint_ode", "adjoint_pde"])
@pytest.mark.parametrize("transfer", [True, False], ids=["bicg", "lq"])
def test_bilqr_matches_jax(make, transfer, FC):
    A, b, c = make(FC)
    rt_, rj = _both_bilqr(A, b, c, transfer_to_bicg=transfer)
    _same_bilqr(rt_, rj)
    assert rt_[2].solved and "Both primal and dual" in rt_[2].status


def test_bilqr_history_warm_start_and_callback(capsys):
    A, b, c = fx.square_adjoint(n=20)
    rt_, rj = _both_bilqr(A, b, c, history=True)
    _same_bilqr(rt_, rj)
    st, sj = rt_[2], rj[2]
    for name in ("residuals_primal", "residuals_dual"):
        got, want = getattr(st, name), np.asarray(getattr(sj, name))
        assert got.shape == want.shape and got.size > 0
        assert _rel(got, want) <= TOL
    x0, y0 = 1.2 * np.ones(b.shape[0]), 0.8 * np.ones(b.shape[0])
    _same_bilqr(*_both_bilqr(A, b, c, x0, y0))
    _same_bilqr(*_both_bilqr(A, b, c, None, y0))

    def cb(state):
        return state.iter >= 3

    rt_, rj = _both_bilqr(A, b, c, callback=cb)
    _same_bilqr(rt_, rj)
    assert rt_[2].status == "user-requested exit" and rt_[2].niter == 3
    _same_bilqr(*_both_bilqr(A, b, c, verbose=1))
    assert "BILQR: system of size 20" in capsys.readouterr().out
    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
        kt.bilqr(_t(A), _t(b), _t(c), precision="double_word")


def test_bilqr_breakdowns_and_zero_rhs():
    A, b, c = fx.bc_breakdown()
    rt_, rj = _both_bilqr(A, b, c)
    _same_bilqr(rt_, rj)
    assert rt_[2].status == "Breakdown bᴴc = 0"
    A, b, c = fx.square_adjoint(n=20)
    z = np.zeros_like(b)
    for bb, cc in ((z, z), (z, c), (b, z)):
        rt_, rj = _both_bilqr(A, bb, cc)
        assert rt_[2].status == rj[2].status
        assert rt_[2].niter == rj[2].niter


def test_bilqr_spread_on_square_adjoint50():
    """The residual estimates' cancellation: JAX's own general core stops
    after a different iteration when only its matvec's summation order
    changes, so the port is held to the status, the band and the true
    residuals here."""
    A, b, c = fx.square_adjoint(n=50)
    rt_, rj = _both_bilqr(A, b, c)
    (xt, yt, st), (xj, yj, sj) = rt_, rj
    Aj = jnp.asarray(A)
    op = JFunctionOperator(lambda v: (Aj * v[None, :]).sum(1), A.shape,
                           jnp.float64,
                           rmatvec=lambda v: (Aj.T * v[None, :]).sum(1))
    s2 = kj.bilqr(op, b, c)[2]
    assert s2.niter != sj.niter
    assert st.status == sj.status and st.solved
    assert abs(st.niter - sj.niter) <= max(2, 0.1 * sj.niter)
    for v, rhs, M in ((xt, b, A), (yt, c, A.T)):
        assert np.linalg.norm(rhs - M @ v.numpy()) \
            <= 1e-6 * np.linalg.norm(rhs)


def test_bilqr_status_vocabulary_matches_jax():
    """Every combination of the nine flags and the codes that bypass
    them gives the JAX package's string."""
    names = ("solved_lq_tol", "solved_lq_mach", "solved_cg_tol",
             "solved_cg_mach", "solved_qr_tol", "solved_qr_mach",
             "solved_primal", "solved_dual", "breakdown")
    codes = (kt._runtime.SOLVED_PRIMAL_DUAL, kt._runtime.TIRED,
             kt._runtime.USER_EXIT, 29, kt._runtime.ZERO_RESIDUAL, 38)
    for bits in itertools.product((False, True), repeat=9):
        flags = dict(zip(names, bits))
        ns = type("S", (), flags)
        for code in codes:
            assert _bilqr_status(ns, code) == jbilqr_status(ns, code)


def test_adjoint_stats_and_show_stats():
    A, b, c = fx.square_adjoint(n=20)
    (xt, yt, st), (xj, yj, sj) = _both_bilqr(A, b, c, history=True)
    assert isinstance(st, kt.AdjointStats)
    assert st.solved == (st.solved_primal and st.solved_dual)
    port_copy = kt.AdjointStats(
        niter=sj.niter, timer=sj.timer, status=sj.status,
        solved_primal=sj.solved_primal, solved_dual=sj.solved_dual,
        residuals_primal=np.asarray(sj.residuals_primal),
        residuals_dual=np.asarray(sj.residuals_dual))
    assert kt.show_stats(port_copy) == kj.show_stats(sj)


# ---------------------------------------------------------------------------
# the kernel route and the plain versions
# ---------------------------------------------------------------------------

@pytest.fixture
def fused_calls(monkeypatch):
    """Counts the calls of the three kernels' plain versions, which the
    kernel wrappers take for CPU tensors."""
    calls = []
    for name in ("bilq_dia_fused_ref", "qmr_dia_fused_ref",
                 "bilqr_dia_fused_ref"):
        ref = getattr(tf, name)

        def counted(*a, _ref=ref, _name=name, **k):
            calls.append(_name)
            return _ref(*a, **k)

        monkeypatch.setattr(tf, name, counted)
    return calls


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_fused_route_matches_jax(method, dtype, fused_calls):
    """The kernel route is taken exactly where the JAX gate admits it
    (krylov_tpu/solvers/bilq.py:256-282, 482-505): c = b, no warm start,
    history, callback, verbose or timemax."""
    D, A, b = _convdiff(N=8, dtype=dtype, seed=5)
    op = kt.DIAOperator(A, use_kernel=True)
    rtol = 1e-8 if dtype == np.float64 else 1e-5
    xj, sj = getattr(kj, method)(JDIAOperator(D, use_pallas=True),
                                 jnp.asarray(b), atol=0.0, rtol=rtol)
    xt, st = getattr(kt, method)(op, torch.as_tensor(b), atol=0.0,
                                 rtol=rtol)
    (_same if dtype == np.float64 else _band)(xt, st, xj, sj)
    assert fused_calls == [method + "_dia_fused_ref"]
    tb = torch.as_tensor(b)
    for args, kw in (((), {"c": tb.clone()}), ((), {"history": True}),
                     ((torch.zeros_like(tb),), {}), ((), {"timemax": 1e6}),
                     ((), {"callback": lambda s: False})):
        xt, st = getattr(kt, method)(op, tb, *args, atol=0.0, rtol=rtol,
                                     **kw)
        assert st.solved
    assert len(fused_calls) == 1
    xt, st = getattr(kt, method)(op, torch.zeros_like(tb))
    assert st.niter == 0 and st.status == "x is a zero-residual solution"


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_bilqr_fused_route_matches_jax(dtype, fused_calls):
    D, A, b = _convdiff(N=8, dtype=dtype, seed=5)
    c = np.random.default_rng(6).standard_normal(b.shape[0]).astype(dtype)
    op = kt.DIAOperator(A, use_kernel=True)
    rtol = 1e-8 if dtype == np.float64 else 1e-5
    xj, yj, sj = kj.bilqr(JDIAOperator(D, use_pallas=True), jnp.asarray(b),
                          jnp.asarray(c), atol=0.0, rtol=rtol)
    xt, yt, st = kt.bilqr(op, _t(b), _t(c), atol=0.0, rtol=rtol)
    assert st.status == sj.status
    assert (st.solved_primal, st.solved_dual) == (sj.solved_primal,
                                                  sj.solved_dual)
    if dtype == np.float64:
        assert st.niter == sj.niter
        assert _rel(xt.numpy(), xj) <= TOL and _rel(yt.numpy(), yj) <= TOL
    else:
        assert abs(st.niter - sj.niter) <= max(2, 0.1 * sj.niter)
    assert fused_calls == ["bilqr_dia_fused_ref"]
    for args, kw in (((_t(np.zeros_like(b)),), {}),
                     ((None, _t(np.zeros_like(b))), {}),
                     ((), {"history": True})):
        xt, yt, st = kt.bilqr(op, _t(b), _t(c), *args, atol=0.0, rtol=rtol,
                              **kw)
        assert st.solved_primal and st.solved_dual
    assert len(fused_calls) == 1
    # c orthogonal to b: the breakdown bᴴc = 0 from the kernel's start
    c0 = np.zeros_like(b)
    c0[0], c0[1] = b[1], -b[0]
    xt, yt, st = kt.bilqr(op, _t(b), _t(c0))
    assert st.status == "Breakdown bᴴc = 0" and st.niter == 0
    assert len(fused_calls) == 2


def _adjoint_pair(D, A):
    pdj = jdia_align(D.data, D.offsets, D.shape[0])
    pdaj, offaj = jf.dia_align_adjoint(pdj, D.offsets, D.shape[0])
    pd = dia_align(A.data, A.offsets, A.shape[0])
    pda, offa = dia_align_adjoint(pd, A.offsets, A.shape[0])
    return (pdj, pdaj, offaj), (pd, pda, offsets_tensor(A.offsets, "cpu"),
                                offsets_tensor(offa, "cpu"))


@pytest.mark.parametrize("kernel", ["bilq", "bilq_lq", "qmr"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_plain_version_matches_jax_kernel(kernel, dtype):
    D, A, b = _convdiff(dtype=dtype)
    (pdj, pdaj, offaj), (pd, pda, ot, ota) = _adjoint_pair(D, A)
    rtol = 1e-10 if dtype == np.float64 else 1e-6
    args = (0.0, rtol, 400)
    if kernel == "qmr":
        rj = jf.qmr_dia_fused(pdj, pdaj, D.offsets, offaj, jnp.asarray(b),
                              *args, interpret=True)
        rt_ = tf.qmr_dia_fused_ref(pd, pda, ot, ota, torch.as_tensor(b),
                                   *args)
    else:
        tr = kernel == "bilq"
        rj = jf.bilq_dia_fused(pdj, pdaj, D.offsets, offaj, jnp.asarray(b),
                               *args, transfer_to_bicg=tr, interpret=True)
        rt_ = tf.bilq_dia_fused_ref(pd, pda, ot, ota, torch.as_tensor(b),
                                    *args, tr)
    assert int(rt_[3]) == int(rj[3])
    if dtype == np.float64:
        assert int(rt_[1]) == int(rj[1])
        assert _rel(rt_[0].numpy(), rj[0]) <= TOL
    else:
        assert abs(int(rt_[1]) - int(rj[1])) <= max(2, 0.1 * int(rj[1]))
        assert _rel(rt_[0].numpy(), rj[0]) <= 1e-3


@pytest.mark.parametrize("transfer", [True, False], ids=["bicg", "lq"])
def test_bilqr_plain_version_matches_jax_kernel(transfer):
    D, A, b = _convdiff()
    c = np.random.default_rng(6).standard_normal(b.shape[0])
    (pdj, pdaj, offaj), (pd, pda, ot, ota) = _adjoint_pair(D, A)
    rj = jf.bilqr_dia_fused(pdj, pdaj, D.offsets, offaj, jnp.asarray(b),
                            jnp.asarray(c), 0.0, 1e-10, 400,
                            transfer_to_bicg=transfer, interpret=True)
    rt_ = tf.bilqr_dia_fused_ref(pd, pda, ot, ota, _t(b), _t(c), 0.0, 1e-10,
                                 400, transfer)
    assert [int(rt_[i]) for i in (2, 5)] == [int(rj[i]) for i in (2, 5)]
    assert rt_[6].tolist() == np.asarray(rj[6]).tolist()
    assert _rel(rt_[0].numpy(), rj[0]) <= TOL
    assert _rel(rt_[1].numpy(), rj[1]) <= TOL
    for i in (3, 4):
        assert abs(float(rt_[i]) - float(rj[i])) <= TOL * max(
            np.linalg.norm(b), np.linalg.norm(c))


def test_plain_versions_breakdowns_match_jax_kernels():
    """The ⟨uₖ₊₁, vₖ₊₁⟩ = 0 breakdown at the first iteration (A = [[2, 0,
    1], [1, 2, 0], [0, 1, 2]], b = e₁: q = e₂ and p = e₃), b = 0, and
    BiLQR's bᴴc = 0 and c = 0, each with the JAX kernel's status and
    niter."""
    data = np.array([[1.0, 1.0, 0.0], [2.0, 2.0, 2.0], [0.0, 0.0, 1.0]])
    offs = (-1, 0, 2)
    from krylov_tpu.ops.dia import DIAMatrix as JDIAMatrix
    D = JDIAMatrix(jnp.asarray(data), offs, (3, 3))
    A = dia_from_numpy(data, offs, (3, 3), device="cpu")
    (pdj, pdaj, offaj), (pd, pda, ot, ota) = _adjoint_pair(D, A)
    e1 = np.array([1.0, 0.0, 0.0])
    for b in (e1, np.zeros(3)):
        for tr in (True, False):
            rj = jf.bilq_dia_fused(pdj, pdaj, offs, offaj, jnp.asarray(b),
                                   0.0, 1e-10, 20, transfer_to_bicg=tr,
                                   interpret=True)
            rt_ = tf.bilq_dia_fused_ref(pd, pda, ot, ota, _t(b), 0.0, 1e-10,
                                        20, tr)
            assert [int(rt_[i]) for i in (1, 3)] == \
                [int(rj[i]) for i in (1, 3)]
        rj = jf.qmr_dia_fused(pdj, pdaj, offs, offaj, jnp.asarray(b), 0.0,
                              1e-10, 20, interpret=True)
        rt_ = tf.qmr_dia_fused_ref(pd, pda, ot, ota, _t(b), 0.0, 1e-10, 20)
        assert [int(rt_[i]) for i in (1, 3)] == [int(rj[i]) for i in (1, 3)]
    rt_ = tf.bilq_dia_fused_ref(pd, pda, ot, ota, _t(e1), 0.0, 1e-10, 20,
                                False)
    assert (int(rt_[1]), int(rt_[3])) == (1, tf.UV_BREAKDOWN)
    for c in (np.array([0.0, 1.0, 0.0]), np.zeros(3)):
        rj = jf.bilqr_dia_fused(pdj, pdaj, offs, offaj, jnp.asarray(e1),
                                jnp.asarray(c), 0.0, 1e-10, 20,
                                interpret=True)
        rt_ = tf.bilqr_dia_fused_ref(pd, pda, ot, ota, _t(e1), _t(c), 0.0,
                                     1e-10, 20)
        assert [int(rt_[i]) for i in (2, 5)] == [int(rj[i]) for i in (2, 5)]
        assert rt_[6].tolist() == np.asarray(rj[6]).tolist()
