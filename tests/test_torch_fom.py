"""krylov_tpu_torch.fom against krylov_tpu.fom, on both routes (the cases
of tests/test_fom_family.py:32-82 and the FOM cases of
tests/test_fused.py), and the plain version of the FOM whole-solve
kernel against krylov_tpu's ``fom_dia_fused`` in interpret mode.

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
from krylov_tpu_torch.ops import cuda_fused as tf
from krylov_tpu_torch.ops.cuda_dia import dia_align, offsets_tensor
from krylov_tpu.ops.pallas_dia import dia_align as jdia_align
from test_torch_gmres import _band, _both, _convdiff, _rel, _same, port


@pytest.fixture(params=[np.float64, np.complex128], ids=["f64", "c128"])
def FC(request):
    return request.param


@pytest.mark.parametrize("make", [fx.nonsymmetric_definite,
                                  fx.symmetric_indefinite, fx.zero_rhs],
                         ids=["nonsym_definite", "sym_indefinite",
                              "zero_rhs"])
def test_dense_fixtures(make, FC):
    A, b = make(FC=FC)
    _same(*_both("fom", A, b))


@pytest.mark.parametrize("kw", [{"memory": 30}, {"memory": 10,
                                                 "restart": True},
                                {"itmax": 3, "rtol": 1e-30, "atol": 1e-30}],
                         ids=["memory30", "restart", "itmax"])
def test_sparse_laplacian(kw):
    A, b = fx.sparse_laplacian(8)
    _same(*_both("fom", A, b, **kw))


def test_preconditioners_and_ldiv(FC):
    A, b, M_inv, N_inv = fx.two_preconditioners(FC=FC)
    mj = kj.DiagonalOperator(jnp.asarray(np.diag(M_inv)))
    nj = kj.DiagonalOperator(jnp.asarray(np.diag(N_inv)))
    mt = kt.DiagonalOperator(torch.as_tensor(np.diag(M_inv).copy()))
    nt = kt.DiagonalOperator(torch.as_tensor(np.diag(N_inv).copy()))
    for ldiv in (False, True):
        xj, sj = kj.fom(A, b, M=mj, N=nj, ldiv=ldiv)
        xt, st = kt.fom(torch.as_tensor(A), torch.as_tensor(b), M=mt, N=nt,
                        ldiv=ldiv)
        _same(xt, st, xj, sj)


@pytest.mark.parametrize("kw", [{"memory": 40}, {"memory": 10,
                                                 "restart": True}],
                         ids=["warm", "warm_restart"])
def test_warm_start(kw):
    A, b = fx.warm_start_system()
    _same(*_both("fom", A, b, 0.99 * np.ones(b.shape[0]), **kw))


def test_history_reorthogonalization_and_f32():
    A, b = fx.nonsymmetric_definite()
    xt, st, xj, sj = _both("fom", A, b, history=True)
    _same(xt, st, xj, sj)
    assert len(st.residuals) == st.niter + 1
    assert _rel(st.residuals, sj.residuals) <= 1e-8
    A, b = fx.kron_unsymmetric(4)
    _same(*_both("fom", A, b, reorthogonalization=True, memory=8,
                 restart=True))
    A, b = fx.sparse_laplacian(8, FC=np.float32)
    _band(*_both("fom", A, b, memory=6, restart=True))


def test_breakdown_is_inconsistent_linear_system():
    """A Krylov space exhausted before the residual test: FOM's breakdown
    status (reference src/fom.jl:355-359).  The system is singular and x
    grows along its null space by a rounding-dependent amount, so status,
    niter and the flags are compared and x is not, as
    tests/test_torch_minres.py does for singular systems."""
    A = np.diag([1.0, 2.0, 0.0, 3.0])
    b = np.array([1.0, 1.0, 1.0, 1.0])
    xt, st, xj, sj = _both("fom", A, b)
    assert (st.status, st.niter, st.solved, st.inconsistent) == \
        (sj.status, sj.niter, sj.solved, sj.inconsistent)


def test_callback_timemax_and_options(capsys):
    A, b = fx.sparse_laplacian(8)

    def cb(state):
        return state.iter >= 4

    xt, st, xj, sj = _both("fom", A, b, callback=cb, rtol=1e-30,
                           atol=1e-30)
    _same(xt, st, xj, sj)
    assert st.status == "user-requested exit" and st.niter == 4
    xt, st = kt.fom(port(A), torch.as_tensor(b), memory=5, restart=True,
                    rtol=1e-30, atol=1e-30, itmax=300, timemax=1e-9)
    assert st.status == "time limit exceeded" and st.niter == 64
    xt, st, xj, sj = _both("fom", A, b, verbose=2)
    _same(xt, st, xj, sj)
    assert "FOM: system of size 512" in capsys.readouterr().out
    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
        kt.fom(port(A), torch.as_tensor(b), precision="double_word")
    B = torch.stack([torch.as_tensor(b), torch.ones(len(b),
                                                    dtype=torch.float64)], 1)
    X, sb = kt.krylov_solve("block_gmres", port(A), B, memory=5,
                            restart=True)
    Xd, sd = kt.block_gmres(port(A), B, memory=5, restart=True)
    assert (sb.status, sb.niter) == (sd.status, sd.niter)
    assert torch.equal(X, Xd)


@pytest.fixture
def fused_calls(monkeypatch):
    calls = []
    ref = tf.fom_dia_fused_ref

    def counted(*a, **k):
        calls.append(a[6] if len(a) > 6 else k.get("mem"))
        return ref(*a, **k)

    monkeypatch.setattr(tf, "fom_dia_fused_ref", counted)
    return calls


@pytest.mark.parametrize("kw", [{"memory": 20, "restart": True}, {},
                                {"x0": True}],
                         ids=["restart20", "default", "warm_start"])
def test_fused_route_matches_jax(kw, fused_calls):
    D, A, b = _convdiff()
    args = ()
    kw = dict(kw)
    if kw.pop("x0", False):
        args = (0.5 * np.ones(b.shape[0]),)
    kw.update(atol=0.0, rtol=1e-10)
    xj, sj = kj.fom(JDIAOperator(D, use_pallas=True), jnp.asarray(b), *args,
                    **kw)
    xt, st = kt.fom(kt.DIAOperator(A, use_kernel=True), torch.as_tensor(b),
                    *args, **kw)
    _same(xt, st, xj, sj)
    assert len(fused_calls) == 1
    xt, st = kt.fom(kt.DIAOperator(A, use_kernel=True), torch.as_tensor(b),
                    history=True, **kw)
    assert st.solved and len(fused_calls) == 1


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("mem", [3, 20])
def test_plain_version_matches_jax_kernel(dtype, mem):
    D, A, b = _convdiff(dtype=dtype)
    pdj = jdia_align(D.data, D.offsets, D.shape[0])
    pd = dia_align(A.data, A.offsets, A.shape[0])
    ot = offsets_tensor(A.offsets, "cpu")
    rtol = 1e-10 if dtype == np.float64 else 1e-6
    rj = jf.fom_dia_fused(pdj, D.offsets, jnp.asarray(b), 0.0, rtol, 400,
                          mem=mem, interpret=True)
    rt_ = tf.fom_dia_fused_ref(pd, ot, torch.as_tensor(b), 0.0, rtol, 400,
                               mem)
    assert [int(rt_[i]) for i in (3, 4)] == [int(rj[i]) for i in (3, 4)]
    if dtype == np.float64:
        assert [int(rt_[i]) for i in (1, 5)] == [int(rj[i]) for i in (1, 5)]
        assert _rel(rt_[0].numpy(), rj[0]) <= 1e-8
    else:
        assert abs(int(rt_[1]) - int(rj[1])) <= max(2, 0.1 * int(rj[1]))
        assert _rel(rt_[0].numpy(), rj[0]) <= 1e-3
