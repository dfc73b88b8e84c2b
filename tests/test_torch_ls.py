"""krylov_tpu_torch.lsqr, lsmr and lslq against krylov_tpu's, on both
routes (the cases of tests/test_ls_family.py:26-83,
tests/test_twosided.py:320-345 and tests/test_fused.py:436-470, 597-656,
1305-1335), and the plain versions of their whole-solve kernels against
krylov_tpu's ``lsqr_dia_fused``, ``lsmr_dia_fused`` and
``lslq_dia_fused`` in interpret mode.

Inputs are made with numpy from a seed (or the fixture generators) and
given to both packages.  Tolerances: on the fixtures, in f64 and c128,
the status string, niter, ``solved`` and ``inconsistent`` are equal and
x, the histories and LSMR's estimates of cond(A), ‖A‖ and ‖x‖ agree to
1e-10 relative (the reductions are summed in another order); LSMR's
residual estimates, which converge to about 1e-13 by cancellation, to
1e-10 of ‖b‖ and of ‖A‖‖b‖.  ``gen_lsq`` with npower 2 to 4 has a
condition number of 1e2 to 1e4, and there the JAX package's x moves by up
to 4e-5 relative (LSMR, npower 4) when only the order of its product's
sums changes (a dense A against the same A in CSR), and LSMR's cond(A)
estimate by up to 90% between the two packages.  Those cases hold the
status and flags equal, niter within 1 (LSLQ at npower 4: 21 against
22), x to four times the JAX package's own spread, measured in the test,
and the JAX package's own least-squares test, ‖Aᵀr‖ ≤ 1e-5‖b‖
(tests/test_ls_family.py:44-50), with LSMR's estimates not compared.
Golub–Kahan's estimates follow the order of the sums after some 25
iterations even on a well-conditioned system (on a seeded normal 60 × 40 one, cond(A) 8.2, the JAX package's
‖Aᴴr‖ estimate at iteration 30 moves by 1.5e-4 between the dense and
the CSR product), so the options run on a seeded normal 80 × 20 system,
cond(A) 2.6, which the three methods solve in 15 to 18 iterations and on
which the JAX package agrees with itself to 1e-15.

The kernel route runs on the convection-diffusion stencil with 0.5 added
to its main diagonal (convdiff + 0.5 I, the JAX package's cell for this
family), 512 unknowns.  There Golub–Kahan runs 70 to 100 iterations
without reorthogonalisation, and the JAX package's results move with the
order of its sums alone: its kernel and its general core stop up to one
iteration apart (LSMR with λ = 0.1: 82 and 81; LSLQ at rtol 1e-6: 82 and
81), and their x differ by up to 7e-9 relative (4e-7 where they stop an
iteration apart), LSMR's cond(A) estimate by 4e-3.  The JAX package's
own tests of these kernels hold them to its general core with niter
within 1 and x to 1e-6 of max|x| (tests/test_fused.py:445-447, 461,
1318-1322).  So there, in f64, the status and flags are equal, niter is
within 1 and x within 1e-6 of max(|x|, |b|); a run capped at 30
iterations, before the rounding has grown (the two packages' x agree to
1e-15 at iteration 20 and 4e-12 at 40), holds niter, status, x and
LSMR's three estimates to 1e-10.  In f32 the status is equal and niter
within ±max(2, 10%) (the band of tests/reference_niter.json).
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
torch = pytest.importorskip("torch")

import fixtures as fx
import krylov_tpu as kj
import krylov_tpu.ops.pallas_fused as jf
import krylov_tpu_torch as kt
from krylov_tpu.operators import DIAOperator as JDIAOperator
from krylov_tpu.ops.dia import DIAMatrix as JDIAMatrix
from krylov_tpu.ops.dia import convdiff_dia as jconvdiff
from krylov_tpu_torch.convert import dia_from_numpy
from krylov_tpu_torch.ops import cuda_fused as tf
from test_torch_bilq import _adjoint_pair
from test_torch_gmres import _rel

TOL = 1e-10
METHODS = ("lsqr", "lsmr", "lslq")
# LsmrStats' estimates held relative to themselves
ESTIMATES = ("Acond", "Anorm", "xNorm")


@pytest.fixture(params=[np.float64, np.complex128], ids=["f64", "c128"])
def FC(request):
    return request.param


def _t(v):
    return None if v is None else torch.as_tensor(np.asarray(v))


def _both(method, A, b, **kw):
    """(port's (x, stats), JAX's (x, stats)) of one call."""
    rj = getattr(kj, method)(A, b, **kw)
    rt_ = getattr(kt, method)(_t(A), _t(b), **kw)
    return rt_, rj


def _same(rt_, rj, tol=TOL, histories=False, bnorm=None):
    """Status, niter, the flags and the LSMR and LSLQ extras equal; x (and
    the histories and estimates) to ``tol`` relative, LSMR's residual
    estimates to ``tol`` of ‖b‖ and ‖A‖‖b‖ (``bnorm`` is ‖b‖)."""
    (xt, st), (xj, sj) = rt_, rj
    assert st.status == sj.status
    assert st.niter == sj.niter
    assert (st.solved, st.inconsistent) == (sj.solved, sj.inconsistent)
    assert _rel(xt.numpy(), np.asarray(xj)) <= tol
    if isinstance(sj, kj.LSLQStats):
        assert st.error_with_bnd == sj.error_with_bnd
    if isinstance(sj, kj.LsmrStats):
        for name in ESTIMATES:
            assert _rel(getattr(st, name), getattr(sj, name)) <= tol, name
        assert abs(st.residual - sj.residual) <= tol * bnorm
        assert abs(st.Aresidual - sj.Aresidual) <= tol * sj.Anorm * bnorm
    if histories:
        for name in ("residuals", "Aresiduals"):
            got, want = getattr(st, name), np.asarray(getattr(sj, name))
            assert got.shape == want.shape and got.size == st.niter + 1
            assert _rel(got, want) <= tol, name


# ---------------------------------------------------------------------------
# the general cores against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("make", [fx.over_consistent, fx.over_inconsistent],
                         ids=["over_consistent", "over_inconsistent"])
def test_overdetermined(method, make, FC):
    A, b = make(FC=FC)
    rt_, rj = _both(method, A, b, history=True)
    _same(rt_, rj, histories=True, bnorm=np.linalg.norm(b))
    assert rt_[1].solved


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("npower", [1, 2, 3, 4])
def test_gen_lsq(method, npower):
    """npower 1 to the fixtures' tolerances; npower 2 to 4 by the module
    docstring's rule for ill-conditioned systems."""
    b, A, *_ = fx.gen_lsq(40, 40, 4, npower, 0.0)
    (xt, st), (xj, sj) = _both(method, A, b)
    bnorm = np.linalg.norm(b)
    r = b - A @ xt.numpy()
    assert np.linalg.norm(A.T @ r) / bnorm <= 1e-5
    if npower == 1:
        _same((xt, st), (xj, sj), bnorm=bnorm)
        return
    xc, _ = getattr(kj, method)(kj.csr_from_dense(A), b)
    assert (st.status, st.solved, st.inconsistent) == (sj.status, sj.solved,
                                                       sj.inconsistent)
    assert abs(st.niter - sj.niter) <= 1
    assert _rel(xt.numpy(), np.asarray(xj)) <= max(
        TOL, 4 * _rel(np.asarray(xc), np.asarray(xj)))


@pytest.mark.parametrize("method", METHODS)
def test_regularized_and_sqd(method):
    """λ = 1e-3 damps the least-squares problem (Aᴴr = λ²x); sqd sets
    λ = 1 and refuses a λ of its own, as the JAX package does."""
    b, A, *_ = fx.gen_lsq(25, 10, 1, 1, 0.0)
    bnorm = np.linalg.norm(b)
    rt_, rj = _both(method, A, b, lam=1e-3)
    _same(rt_, rj, bnorm=bnorm)
    x = rt_[0].numpy()
    if method != "lslq":     # as tests/test_ls_family.py:52-60
        assert np.linalg.norm(A.T @ (b - A @ x) - 1e-6 * x) / bnorm <= 1e-5
    _same(*_both(method, A, b, sqd=True), bnorm=bnorm)
    for pkg, mat, vec in ((kt, _t(A), _t(b)), (kj, A, b)):
        with pytest.raises(ValueError, match="sqd"):
            getattr(pkg, method)(mat, vec, sqd=True, lam=2.0)


@pytest.mark.parametrize("method", METHODS)
def test_zero_rhs(method, FC):
    A, _ = fx.over_consistent(FC=FC)
    rt_, rj = _both(method, A, np.zeros(25, dtype=FC))
    _same(rt_, rj, bnorm=1.0)
    assert rt_[1].status == "x is a zero-residual solution"
    assert rt_[1].niter == 0 and not rt_[1].inconsistent


def test_lsmr_stats():
    b, A, *_ = fx.gen_lsq(25, 10, 1, 1, 0.0)
    (x, st), rj = _both("lsmr", A, b)
    _same((x, st), rj, bnorm=np.linalg.norm(b))
    assert isinstance(st, kt.LsmrStats) and st.Anorm > 0 and st.Acond > 0


@pytest.mark.parametrize("kw", [{"sigma": 0.01, "utol": 1e-4},
                                {"transfer_to_lsqr": True},
                                {"sigma": 0.5}],
                         ids=["sigma", "transfer", "sigma_complex"])
def test_lslq_sigma_and_transfer(kw, FC):
    """LSLQ's σ bounds with ``utol`` and its LSQR transfer
    (tests/test_twosided.py:320-345); σ = 0.5 overestimates σmin, and
    the bounds go complex."""
    b, A, *_ = fx.gen_lsq(25, 10, 1, 1, 0.0)
    A = A.astype(FC)
    b = b.astype(FC)
    rt_, rj = _both("lslq", A, b, history=True, **kw)
    _same(rt_, rj, histories=True)
    assert rt_[1].solved


# ---------------------------------------------------------------------------
# options
# ---------------------------------------------------------------------------

def _wellcond():
    """A seeded normal 80 x 20 least-squares system, cond(A) 2.6."""
    rng = np.random.default_rng(7)
    return rng.standard_normal((80, 20)), rng.standard_normal(80)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("ldiv", [False, True])
def test_preconditioners(method, ldiv):
    """M and N as diagonal operators (the elliptic norms of reference
    src/lsqr.jl:253-273), applied or divided by."""
    A, b = _wellcond()
    rng = np.random.default_rng(3)
    dm, dn = 1.0 + rng.random(80), 1.0 + rng.random(20)
    rj = getattr(kj, method)(A, b, M=kj.DiagonalOperator(dm),
                             N=kj.DiagonalOperator(dn), ldiv=ldiv,
                             history=True)
    rt_ = getattr(kt, method)(_t(A), _t(b), M=kt.DiagonalOperator(_t(dm)),
                              N=kt.DiagonalOperator(_t(dn)), ldiv=ldiv,
                              history=True)
    _same(rt_, rj, histories=True, bnorm=np.linalg.norm(b))


@pytest.mark.parametrize("method", ["lsqr", "lsmr"])
def test_radius(method):
    A, b = _wellcond()
    rt_, rj = _both(method, A, b, radius=0.05)
    _same(rt_, rj, bnorm=np.linalg.norm(b))
    assert rt_[1].status == "on trust-region boundary"
    assert abs(np.linalg.norm(rt_[0].numpy()) - 0.05) <= 1e-8


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("window", [1, 12])
def test_window_etol_conlim_itmax(method, window):
    """The error window of 1 and 12 with a loose etol, a small conlim,
    and an iteration cap."""
    A, b = _wellcond()
    for kw in ({"window": window, "etol": 1e-3},
               {"window": window, "conlim": 2.0},
               {"window": window, "itmax": 3, "atol": 0.0, "rtol": 0.0}):
        _same(*_both(method, A, b, **kw), bnorm=np.linalg.norm(b))
    assert _both(method, A, b, itmax=3, atol=0.0, rtol=0.0)[0][1].status \
        == "maximum number of iterations exceeded"


def test_lsqr_compensated():
    """precision="compensated" runs the Golub–Kahan norms as Dot2, on both
    packages' general routes."""
    A, b = _wellcond()
    rt_, rj = _both("lsqr", A, b, precision="compensated", history=True)
    _same(rt_, rj, histories=True)


@pytest.mark.parametrize("method", METHODS)
def test_callback_timemax_and_verbose(method, capsys):
    """A callback stops the solve after iteration 4 and sees the active
    iterations only; a finite ``timemax`` stops after one chunk of 64;
    the verbose table prints the JAX package's rows."""
    A, b = _wellcond()
    rt_, rj = _both(method, A, b, callback=lambda s: s.iter >= 4)
    _same(rt_, rj, bnorm=np.linalg.norm(b))
    assert rt_[1].status == "user-requested exit" and rt_[1].niter == 4
    seen = []
    _, st = getattr(kt, method)(_t(A), _t(b), callback=lambda s: seen.append(
        int(s.iter)) or False)
    assert seen == list(range(1, st.niter + 1))
    R = np.random.default_rng(0).standard_normal((100, 100))
    _, st = getattr(kt, method)(_t(R), torch.ones(100, dtype=torch.float64),
                                atol=0.0, rtol=0.0, btol=0.0, etol=0.0,
                                conlim=0.0, itmax=300, timemax=1e-9)
    assert st.status == "time limit exceeded" and st.niter == 64
    capsys.readouterr()
    getattr(kj, method)(A, b, verbose=2)
    want = capsys.readouterr().out
    getattr(kt, method)(_t(A), _t(b), verbose=2)
    got = capsys.readouterr().out
    assert got.splitlines() == want.splitlines() and len(got.splitlines()) > 4


def test_double_word_and_bad_precision_raise():
    b, A, *_ = fx.gen_lsq(25, 10, 1, 1, 0.0)
    for method in METHODS:
        with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
            getattr(kt, method)(_t(A), _t(b), precision="double_word")
    for method in ("lsmr", "lslq"):
        with pytest.raises(ValueError, match="precision"):
            getattr(kt, method)(_t(A), _t(b), precision="compensated")
    with pytest.raises(ValueError, match="Inconsistent problem size"):
        kt.lsqr(_t(A), _t(b[:10]))


def test_csr_and_matrix_free_operators():
    """A CSR operator (its adjoint built on the host) and a matrix-free
    one give the dense operator's results, rectangular A included."""
    b, A, *_ = fx.gen_lsq(25, 10, 1, 1, 0.0)
    At = _t(A)
    csr = kt.csr_from_dense(At)
    fn = kt.FunctionOperator(lambda v: At @ v, A.shape, torch.float64,
                             rmatvec=lambda v: At.T @ v)
    for method in METHODS:
        want, sw = getattr(kt, method)(At, _t(b))
        for op in (csr, fn):
            got, sg = getattr(kt, method)(op, _t(b))
            assert sg.niter == sw.niter and _rel(got.numpy(),
                                                 want.numpy()) <= 1e-12


def test_show_stats_for_lsmr_and_lslq():
    """An LsmrStats and an LSLQStats render as the JAX package's do."""
    b, A, *_ = fx.gen_lsq(25, 10, 1, 1, 0.0)
    for method, kw in (("lsmr", {}), ("lslq", {"sigma": 0.01})):
        (_, st), (_, sj) = _both(method, A, b, history=True, **kw)
        assert st.status == sj.status and st.niter == sj.niter
        port_copy = type(st)(**{f.name: getattr(sj, f.name)
                                for f in dataclasses.fields(sj)})
        assert kt.show_stats(port_copy) == kj.show_stats(sj)
        assert kt.show_stats(st).splitlines()[:3] == \
            kj.show_stats(sj).splitlines()[:3]
    assert "error with bnd: false" in kt.show_stats(st)


# ---------------------------------------------------------------------------
# the kernel route and the plain versions
# ---------------------------------------------------------------------------

def _shifted(N=8, dtype=np.float64, seed=5):
    """convdiff_dia(N) + 0.5 I in both packages, and b from ``seed``."""
    D0 = jconvdiff(N, N, N, dtype=dtype)
    data = np.array(D0.data)
    data[list(D0.offsets).index(0)] += 0.5
    D = JDIAMatrix(jnp.asarray(data), D0.offsets, D0.shape)
    A = dia_from_numpy(data, D0.offsets, D0.shape, device="cpu")
    b = np.random.default_rng(seed).standard_normal(D0.shape[0]).astype(
        dtype)
    return D, A, b


@pytest.fixture
def fused_calls(monkeypatch):
    """Counts the calls of the three kernels' plain versions, which the
    kernel wrappers take for CPU tensors."""
    calls = []
    for method in METHODS:
        name = method + "_dia_fused_ref"
        ref = getattr(tf, name)

        def counted(*a, _ref=ref, _name=name, **k):
            calls.append(_name)
            return _ref(*a, **k)

        monkeypatch.setattr(tf, name, counted)
    return calls


def _band(nt, nj, dtype):
    return abs(nt - nj) <= (1 if dtype == np.float64
                            else max(2, 0.1 * nj))


def _x_close(xt, xj, b, dtype):
    """f64: x within 1e-6 of max(|x|, |b|), the module docstring's bound."""
    if dtype == np.float64:
        xj = np.asarray(xj)
        assert np.abs(np.asarray(xt) - xj).max() <= 1e-6 * max(
            np.abs(xj).max(), np.abs(b).max())


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_fused_route_matches_jax(method, dtype, fused_calls):
    """The kernel route is taken exactly where the JAX gate admits it
    (krylov_tpu/solvers/lsqr.py:333-338, lsmr.py:347-351,
    lslq.py:333-336): no M, N, radius, history, callback, verbose,
    timemax or (LSQR) compensated precision; every excluded option runs
    the general core (tests/test_fused.py:641-656, 1325-1335)."""
    D, A, b = _shifted(dtype=dtype)
    op = kt.DIAOperator(A, use_kernel=True)
    kw = {"atol": 0.0, "rtol": 1e-10 if dtype == np.float64 else 1e-5}
    xj, sj = getattr(kj, method)(JDIAOperator(D, use_pallas=True),
                                 jnp.asarray(b), **kw)
    xt, st = getattr(kt, method)(op, _t(b), **kw)
    assert (st.status, st.solved, st.inconsistent) == (sj.status, sj.solved,
                                                       sj.inconsistent)
    assert _band(st.niter, sj.niter, dtype)
    _x_close(xt.numpy(), xj, b, dtype)
    assert fused_calls == [method + "_dia_fused_ref"]
    n = b.shape[0]
    fallbacks = [{"history": True}, {"timemax": 1e6},
                 {"callback": lambda s: False}, {"verbose": 100},
                 {"M": kt.DiagonalOperator(torch.ones(n, dtype=xt.dtype))},
                 {"N": kt.DiagonalOperator(torch.ones(n, dtype=xt.dtype))}]
    if method != "lslq":
        fallbacks.append({"radius": 1e6})
    if method == "lsqr":
        fallbacks.append({"precision": "compensated"})
    for extra in fallbacks:
        _, st = getattr(kt, method)(op, _t(b), **kw, **extra)
        assert st.solved
    assert len(fused_calls) == 1
    _, st = getattr(kt, method)(op, _t(np.zeros_like(b)))
    assert len(fused_calls) == 2
    assert st.niter == 0 and st.status == "x is a zero-residual solution"


def test_fused_route_options(fused_calls):
    """λ, window and LSLQ's σ and transfer go to the kernel; a complex
    system and a CPU operator without the kernel never do."""
    D, A, b = _shifted()
    op = kt.DIAOperator(A, use_kernel=True)
    jop = JDIAOperator(D, use_pallas=True)
    runs = [("lsqr", {"lam": 0.1}), ("lsmr", {"window": 12}),
            ("lslq", {"sigma": 0.1, "transfer_to_lsqr": True,
                      "atol": 0.0, "rtol": 1e-10})]
    for method, kw in runs:
        xj, sj = getattr(kj, method)(jop, jnp.asarray(b), **kw)
        xt, st = getattr(kt, method)(op, _t(b), **kw)
        assert st.status == sj.status and _band(st.niter, sj.niter,
                                                np.float64)
        _x_close(xt.numpy(), xj, b, np.float64)
    assert len(fused_calls) == 3
    Ac = kt.DIAOperator(kt.convdiff_dia(4, dtype=torch.complex128,
                                        device="cpu"), use_kernel=True)
    v = torch.ones(64, dtype=torch.complex128)
    for method in METHODS:
        assert getattr(kt, method)(Ac, v)[1].solved
        assert getattr(kt, method)(kt.DIAOperator(A, use_kernel=False),
                                   _t(b))[1].solved
    assert len(fused_calls) == 3


KERNELS = {"lsqr": {}, "lsqr_lam": {"lam": 0.1}, "lsmr": {},
           "lsmr_lam": {"lam": 0.1}, "lslq": {}, "lslq_lam": {"lam": 0.1},
           "lslq_sigma": {"sigma": 0.1, "use_sigma": True},
           "lslq_transfer": {"transfer_to_lsqr": True},
           "lsqr_window1": {"window": 1}, "lsmr_window12": {"window": 12},
           "lslq_window12": {"window": 12}}


def _kernel_args(name, b, kw, itmax):
    """The arguments after (pd, pd_adj, offsets, offsets_adj, b) of both
    packages' kernels, at the default tolerances (√eps) and atol = rtol =
    0 for LSQR and LSMR (their defaults)."""
    kw = dict(kw)
    tol = float(np.sqrt(np.finfo(b.dtype).eps))
    lam = kw.pop("lam", 0.0)
    if name == "lslq":
        return (lam, kw.pop("sigma", 0.0), tol, tol, tol, tol, tol, 1e8,
                itmax), kw
    return (lam, tol, tol, 0.0, 0.0, tol, 1e8, itmax), kw


def _ints(r):
    return [int(v) for v in r[1:] if np.asarray(v).dtype == np.int32]


@pytest.mark.parametrize("kernel", sorted(KERNELS))
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("rhs", ["b", "zero_b"])
def test_plain_version_matches_jax_kernel(kernel, dtype, rhs):
    """Each plain version against the JAX kernel in interpret mode at 8³
    on the shifted stencil, to the tolerances of the module docstring,
    with λ = 0.1, LSLQ's σ and transfer, windows of 1 and 12, and b = 0;
    in f64 also capped at 30 iterations, to 1e-10."""
    D, A, b = _shifted(dtype=dtype)
    if rhs == "zero_b":
        b = np.zeros_like(b)
    (pdj, pdaj, offaj), (pd, pda, ot, ota) = _adjoint_pair(D, A)
    name = kernel.split("_")[0]
    caps = (400, 30) if dtype == np.float64 and rhs == "b" else (400,)
    for itmax in caps:
        args, kw = _kernel_args(name, b, KERNELS[kernel], itmax)
        rt_ = getattr(tf, name + "_dia_fused_ref")(pd, pda, ot, ota, _t(b),
                                                   *args, **kw)
        rj = getattr(jf, name + "_dia_fused")(
            pdj, pdaj, D.offsets, offaj, jnp.asarray(b), *args,
            interpret=True, **kw)
        it_t, *codes_t = _ints(rt_)
        it_j, *codes_j = _ints(rj)
        assert codes_t == codes_j
        if itmax == 30:
            assert it_t == it_j
            assert _rel(rt_[0].numpy(), np.asarray(rj[0])) <= TOL
            if name == "lsmr":
                for i in (4, 5, 6):
                    assert _rel(float(rt_[i]), float(rj[i])) <= TOL
        else:
            assert _band(it_t, it_j, dtype)
            _x_close(rt_[0].numpy(), rj[0], b, dtype)
        if rhs == "zero_b":
            assert it_t == 0 and not rt_[0].any()


def test_kernel_window_must_be_positive():
    D, A, b = _shifted()
    (_, _, _), (pd, pda, ot, ota) = _adjoint_pair(D, A)
    with pytest.raises(ValueError, match="window"):
        tf.lsqr_dia_fused(pd, pda, ot, ota, _t(b), 0.0, 1e-8, 1e-8, 0.0,
                          0.0, 1e-8, 1e8, 10, window=0)


def test_krylov_solve_and_workspace():
    """The three methods through krylov_solve equal direct calls and the
    JAX package's; an LSMR workspace's accessors match the JAX
    package's, and these methods refuse a warm start."""
    b, A, *_ = fx.gen_lsq(25, 10, 1, 1, 0.0)
    for method in METHODS:
        x, st = kt.krylov_solve(method, _t(A), _t(b))
        xd, sd = getattr(kt, method)(_t(A), _t(b))
        xj, sj = kj.krylov_solve(method, A, b)
        assert (st.status, st.niter) == (sd.status, sd.niter) \
            == (sj.status, sj.niter)
        assert torch.equal(x, xd) and _rel(x.numpy(), xj) <= TOL
    wj = kj.krylov_workspace("lsmr", A, b)
    wt = kt.krylov_workspace("lsmr", _t(A), _t(b))
    kj.krylov_solve_inplace(wj, A, b)
    kt.krylov_solve_inplace(wt, _t(A), _t(b))
    assert kt.iteration_count(wt) == kj.iteration_count(wj)
    assert kt.Aprod_count(wt) == kt.Atprod_count(wt) == kj.Atprod_count(wj)
    assert isinstance(kt.statistics(wt), kt.LsmrStats)
    assert _rel(kt.solution(wt).numpy(), kj.solution(wj)) <= TOL
    assert wt.rNorm is not None and "state storage" in repr(wt)
    with pytest.raises(ValueError, match="does not support warm starts"):
        kt.warm_start(wt, kt.solution(wt))
