"""krylov_tpu_torch.craig, craigmr, lnlq, cgne and crmr against
krylov_tpu's, on both routes (the cases of tests/test_fixture_zoo.py:
148-170, 247-262, tests/test_ls_family.py:87-120 and
tests/test_fused.py:1180-1245), and the plain versions of their
whole-solve kernels against krylov_tpu's ``craig_dia_fused``,
``craigmr_dia_fused``, ``lnlq_dia_fused`` and ``cgne_crmr_dia_fused`` in
interpret mode.

Inputs are made with numpy from a seed (or the fixture generators) and
given to both packages.  Tolerances: on the fixtures, in f64 and c128,
the status string, niter, ``solved`` and ``inconsistent`` are equal and
x, y and the histories agree to 1e-10 relative (the reductions are
summed in another order).  One fixture is an exact tie that rounding
alone decides: on ``under_inconsistent`` (A = ones(10, 25)) the second
Golub–Kahan α is 0 in exact arithmetic, and the two packages' products,
summed in another order, give an α of exactly 0 (the port: CRAIG's
"system may be inconsistent" after one iteration) or of 1e-16 (the JAX
package: an estimate that grows to 1e32 and a conlim stop after three).
There CRAIG is held to the JAX package's own test (tests/
test_fixture_zoo.py:165-170), inconsistent or a condition-number stop,
and LNLQ, which the JAX package does not test there, is not compared.

The options run on a seeded normal 20 × 80 system (cond(A) 2.8), which
the five methods solve in 16 or 17 iterations.

The kernel route runs on the convection-diffusion stencil, 512 unknowns,
with and without 0.5 added to its main diagonal (convdiff + 0.5 I, the
JAX package's cell for this family).  There Golub–Kahan and CG on AAᴴ
run 70 to 130 iterations without reorthogonalisation, and the results
move with the order of the sums: the JAX package's own tests hold its
kernels to its general cores with niter within 1 and x and y to 1e-7 of
max|x| + 1 (tests/test_fused.py:1190-1196, 1219-1225).  So there, in
f64, the status is equal, niter within 1, and x and y within 1e-7
relative (measured: 2.8e-8 at most, CRAIG unshifted); a run capped at 30
iterations, before the rounding has grown, holds niter, status, x and y
to 1e-10 (measured: 9e-12 at most, LNLQ's y).  In f32 the status is equal
and niter within ±max(2, 10%) (the band of tests/reference_niter.json).
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
from krylov_tpu.ops.dia import DIAMatrix as JDIAMatrix
from krylov_tpu.ops.dia import convdiff_dia as jconvdiff
from krylov_tpu_torch.convert import dia_from_numpy
from krylov_tpu_torch.ops import cuda_fused as tf
from test_torch_bilq import _adjoint_pair
from test_torch_gmres import _rel

TOL = 1e-10
XY = ("craig", "craigmr", "lnlq")      # return (x, y, stats)
METHODS = ("cgne", "crmr") + XY


@pytest.fixture(params=[np.float64, np.complex128], ids=["f64", "c128"])
def FC(request):
    return request.param


def _t(v):
    return None if v is None else torch.as_tensor(np.asarray(v))


def _both(method, A, b, **kw):
    """(port's (x[, y], stats), JAX's (x[, y], stats)) of one call."""
    rj = getattr(kj, method)(A, b, **kw)
    rt_ = getattr(kt, method)(_t(A), _t(b), **kw)
    return rt_, rj


def _same(rt_, rj, tol=TOL, histories=False):
    """Status, niter and the flags equal; x (and y, and the histories) to
    ``tol`` relative."""
    *vt, st = rt_
    *vj, sj = rj
    assert type(st).__name__ == type(sj).__name__
    assert st.status == sj.status
    assert st.niter == sj.niter
    assert st.solved == sj.solved
    assert getattr(st, "inconsistent", None) == getattr(sj, "inconsistent",
                                                        None)
    for a, w in zip(vt, vj):
        assert _rel(a.numpy(), np.asarray(w)) <= tol
    if histories:
        names = ["residuals"] + (["Aresiduals"] if type(st).__name__
                                 == "SimpleStats" else [])
        for name in names:
            got, want = getattr(st, name), np.asarray(getattr(sj, name))
            assert got.shape == want.shape
            if want.size:
                assert _rel(got, want) <= tol, name


# ---------------------------------------------------------------------------
# the general cores against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("fixture", ["under_consistent",
                                     "square_consistent"])
def test_minimum_norm(method, fixture, FC):
    """The minimum-norm solution of a consistent system
    (tests/test_fixture_zoo.py:247-262), with the histories."""
    A, b = getattr(fx, fixture)(FC=FC)
    rt_, rj = _both(method, A, b, rtol=1e-10, history=True)
    _same(rt_, rj, histories=True)
    x = rt_[0].numpy()
    assert np.linalg.norm(b - A @ x) <= 1e-6 * np.linalg.norm(b)
    assert fx.check_min_norm(A, b, x, atol=1e-5)


@pytest.mark.parametrize("method", ["cgne", "crmr", "craigmr"])
@pytest.mark.parametrize("fixture", ["under_inconsistent",
                                     "over_inconsistent",
                                     "square_inconsistent"])
def test_inconsistent(method, fixture, FC):
    """CGNE, CRMR and CRAIGMR flag an inconsistent system
    (tests/test_fixture_zoo.py:148-162)."""
    A, b = getattr(fx, fixture)(FC=FC)
    rt_, rj = _both(method, A, b, history=True)
    _same(rt_, rj, histories=True)
    st = rt_[-1]
    assert st.inconsistent or "condition number" in st.status


def test_craig_under_inconsistent():
    """CRAIG on the exact tie of the module docstring: inconsistent or a
    conlim stop, as the JAX package's own test holds it."""
    A, b = fx.under_inconsistent()
    *_, st = kt.krylov_solve("craig", _t(A), _t(b))
    assert st.inconsistent or "condition number" in st.status
    assert st.status == "system may be inconsistent" and st.niter == 1


@pytest.mark.parametrize("method", METHODS)
def test_zero_rhs(method, FC):
    A, _ = fx.under_consistent(FC=FC)
    rt_, rj = _both(method, A, np.zeros(10, dtype=FC))
    _same(rt_, rj)
    assert rt_[-1].status == "x is a zero-residual solution"
    assert rt_[-1].niter == 0 and not rt_[0].any()


@pytest.mark.parametrize("method", METHODS)
def test_regularized_and_sqd(method, FC):
    """λ = 0.3 (the regularised minimum-norm problem); sqd sets λ = 1 and
    refuses a λ of its own, as the JAX package does."""
    A, b = fx.under_consistent(FC=FC)
    _same(*_both(method, A, b, lam=0.3, history=True), histories=True)
    if method in XY:
        _same(*_both(method, A, b, sqd=True))
        for pkg, mat, vec in ((kt, _t(A), _t(b)), (kj, A, b)):
            with pytest.raises(ValueError, match="sqd"):
                getattr(pkg, method)(mat, vec, sqd=True, lam=2.0)


# ---------------------------------------------------------------------------
# options
# ---------------------------------------------------------------------------

def _wellcond():
    """A seeded normal 20 x 80 underdetermined system, cond(A) 2.8."""
    rng = np.random.default_rng(7)
    return rng.standard_normal((20, 80)), rng.standard_normal(20)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("ldiv", [False, True])
def test_preconditioners(method, ldiv):
    """M and N as diagonal operators, applied or divided by: CRAIG's,
    CRAIGMR's and LNLQ's M on the b side and N on the x side; CGNE's and
    CRMR's N on the b side (they take no M)."""
    A, b = _wellcond()
    rng = np.random.default_rng(3)
    dm, dn = 1.0 + rng.random(20), 1.0 + rng.random(80)
    if method not in XY:
        dm, dn = None, dm
    jkw = {"N": kj.DiagonalOperator(dn), "ldiv": ldiv, "history": True}
    tkw = {"N": kt.DiagonalOperator(_t(dn)), "ldiv": ldiv, "history": True}
    if dm is not None:
        jkw["M"] = kj.DiagonalOperator(dm)
        tkw["M"] = kt.DiagonalOperator(_t(dm))
    rj = getattr(kj, method)(A, b, **jkw)
    rt_ = getattr(kt, method)(_t(A), _t(b), **tkw)
    _same(rt_, rj, histories=True)


@pytest.mark.parametrize("kw", [{"btol": 1e-3}, {"btol": 0.0, "atol": 0.0,
                                                 "rtol": 1e-12},
                                {"conlim": 2.0}, {"transfer_to_lsqr": True}],
                         ids=["btol", "btol0", "conlim", "transfer"])
def test_craig_btol_and_conlim(kw):
    """CRAIG's backward-error tolerance, its conlim stop, and the
    ``transfer_to_lsqr`` it accepts and ignores."""
    A, b = _wellcond()
    _same(*_both("craig", A, b, history=True, **kw), histories=True)


@pytest.mark.parametrize("transfer", [True, False])
@pytest.mark.parametrize("FC_", [np.float64, np.complex128],
                         ids=["f64", "c128"])
def test_lnlq_transfer_to_craig(transfer, FC_):
    """With the transfer LNLQ stops at the CRAIG point (code 43), without
    it at the LQ point (42)."""
    A, b = _wellcond()
    A, b = A.astype(FC_), b.astype(FC_)
    rt_, rj = _both("lnlq", A, b, transfer_to_craig=transfer, history=True)
    _same(rt_, rj, histories=True)
    assert rt_[-1].status.startswith("solutions (xᶜ" if transfer
                                     else "solutions (xᴸ")


@pytest.mark.parametrize("method", METHODS)
def test_callback_itmax_timemax_and_verbose(method, capsys):
    """A callback stops the solve after iteration 4 and sees the active
    iterations only; itmax = 3 stops tired; a finite ``timemax`` stops
    after one chunk of 64; the verbose table prints the JAX package's
    rows."""
    A, b = _wellcond()
    rt_, rj = _both(method, A, b, callback=lambda s: s.iter >= 4)
    _same(rt_, rj)
    assert rt_[-1].status == "user-requested exit" and rt_[-1].niter == 4
    seen = []
    *_, st = getattr(kt, method)(_t(A), _t(b), callback=lambda s: seen.append(
        int(s.iter)) or False)
    assert seen == list(range(1, st.niter + 1))
    rt_, rj = _both(method, A, b, itmax=3, atol=0.0, rtol=0.0)
    _same(rt_, rj)
    assert rt_[-1].status == "maximum number of iterations exceeded"
    R = np.random.default_rng(0).standard_normal((100, 100))
    extra = {"btol": 0.0, "conlim": 0.0} if method == "craig" else {}
    *_, st = getattr(kt, method)(_t(R), torch.ones(100, dtype=torch.float64),
                                 atol=0.0, rtol=0.0, itmax=300,
                                 timemax=1e-9, **extra)
    assert st.status == "time limit exceeded" and st.niter == 64
    capsys.readouterr()
    getattr(kj, method)(A, b, verbose=3)
    want = capsys.readouterr().out
    getattr(kt, method)(_t(A), _t(b), verbose=3)
    got = capsys.readouterr().out
    assert got.splitlines() == want.splitlines() and len(got.splitlines()) > 4


def test_double_word_and_bad_inputs_raise():
    A, b = _wellcond()
    for method in METHODS:
        with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
            getattr(kt, method)(_t(A), _t(b), precision="double_word")
        with pytest.raises(ValueError, match="precision"):
            getattr(kt, method)(_t(A), _t(b), precision="compensated")
        with pytest.raises(ValueError, match="Inconsistent problem size"):
            getattr(kt, method)(_t(A), _t(b[:10]))
    with pytest.raises(TypeError):
        kt.cgne(_t(A), _t(b), M=kt.DiagonalOperator(_t(b)))


def test_csr_and_matrix_free_operators():
    """A CSR operator (its adjoint built on the host) and a matrix-free
    one give the dense operator's results, rectangular A included."""
    A, b = _wellcond()
    At = _t(A)
    csr = kt.csr_from_dense(At)
    fn = kt.FunctionOperator(lambda v: At @ v, A.shape, torch.float64,
                             rmatvec=lambda v: At.T @ v)
    for method in METHODS:
        *want, sw = getattr(kt, method)(At, _t(b))
        for op in (csr, fn):
            *got, sg = getattr(kt, method)(op, _t(b))
            assert sg.niter == sw.niter
            for g, w in zip(got, want):
                assert _rel(g.numpy(), w.numpy()) <= 1e-12


def test_show_stats_for_lnlq():
    """An LNLQStats renders as the JAX package's does."""
    A, b = _wellcond()
    (*_, st), (*_, sj) = _both("lnlq", A, b, history=True)
    assert isinstance(st, kt.LNLQStats)
    assert kt.show_stats(st).splitlines()[:3] == \
        kj.show_stats(sj).splitlines()[:3]
    assert "error with bnd: false" in kt.show_stats(st)


# ---------------------------------------------------------------------------
# the kernel route and the plain versions
# ---------------------------------------------------------------------------

def _stencil(N=8, dtype=np.float64, shift=0.5, seed=5):
    """convdiff_dia(N) + shift·I in both packages, and b from ``seed``."""
    D0 = jconvdiff(N, N, N, dtype=dtype)
    data = np.array(D0.data)
    data[list(D0.offsets).index(0)] += shift
    D = JDIAMatrix(jnp.asarray(data), D0.offsets, D0.shape)
    A = dia_from_numpy(data, D0.offsets, D0.shape, device="cpu")
    b = np.random.default_rng(seed).standard_normal(D0.shape[0]).astype(
        dtype)
    return D, A, b


# the plain version each wrapper takes for CPU tensors
PLAIN = ("craig", "craigmr", "lnlq", "cgne_crmr")


@pytest.fixture
def fused_calls(monkeypatch):
    """Counts the calls of the four kernels' plain versions."""
    calls = []
    for kernel in PLAIN:
        name = kernel + "_dia_fused_ref"
        ref = getattr(tf, name)

        def counted(*a, _ref=ref, _name=name, **k):
            calls.append(_name)
            return _ref(*a, **k)

        monkeypatch.setattr(tf, name, counted)
    return calls


def _band(nt, nj, dtype):
    return abs(nt - nj) <= (1 if dtype == np.float64
                            else max(2, 0.1 * nj))


def _close(vt, vj, dtype, tol=1e-7):
    """f64: within ``tol`` of max|v| + 1, the JAX package's own bound."""
    if dtype == np.float64:
        vj = np.asarray(vj)
        assert np.abs(np.asarray(vt) - vj).max() <= tol * (
            np.abs(vj).max() + 1)


def _kernel_of(method):
    return "cgne_crmr" if method in ("cgne", "crmr") else method


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_fused_route_matches_jax(method, dtype, fused_calls):
    """The kernel route is taken exactly where the JAX gate admits it
    (krylov_tpu/solvers/craig.py:272-275, 599-602, 907-910; cgne.py:
    179-182): no M, N, history, callback, verbose or finite timemax;
    every excluded option runs the general core."""
    D, A, b = _stencil(dtype=dtype)
    op = kt.DIAOperator(A, use_kernel=True)
    kw = {"atol": 0.0, "rtol": 1e-8 if dtype == np.float64 else 1e-5}
    *vj, sj = getattr(kj, method)(JDIAOperator(D, use_pallas=True),
                                  jnp.asarray(b), **kw)
    *vt, st = getattr(kt, method)(op, _t(b), **kw)
    assert (st.status, st.solved, st.inconsistent) == (sj.status, sj.solved,
                                                       sj.inconsistent)
    assert type(st) is kt.SimpleStats
    assert _band(st.niter, sj.niter, dtype)
    for a, w in zip(vt, vj):
        _close(a.numpy(), w, dtype)
    assert fused_calls == [_kernel_of(method) + "_dia_fused_ref"]
    n = b.shape[0]
    ones = kt.DiagonalOperator(torch.ones(n, dtype=vt[0].dtype))
    fallbacks = [{"history": True}, {"timemax": 1e6},
                 {"callback": lambda s: False}, {"verbose": 100},
                 {"N": ones}]
    if method in XY:
        fallbacks.append({"M": ones})
    for extra in fallbacks:
        *_, st = getattr(kt, method)(op, _t(b), **kw, **extra)
        assert st.solved
    assert len(fused_calls) == 1
    *_, st = getattr(kt, method)(op, _t(np.zeros_like(b)))
    assert len(fused_calls) == 2
    assert st.niter == 0 and st.status == "x is a zero-residual solution"


@pytest.mark.parametrize("method", METHODS)
def test_fused_route_options(method, fused_calls):
    """λ (and LNLQ's transfer) go to the kernel, with the JAX package's
    results; a complex system and a CPU operator without the kernel never
    do."""
    D, A, b = _stencil()
    op = kt.DIAOperator(A, use_kernel=True)
    jop = JDIAOperator(D, use_pallas=True)
    runs = [{"lam": 0.3, "atol": 0.0, "rtol": 1e-8}]
    if method == "lnlq":
        runs.append({"transfer_to_craig": False, "atol": 0.0, "rtol": 1e-8})
    for kw in runs:
        *vj, sj = getattr(kj, method)(jop, jnp.asarray(b), **kw)
        *vt, st = getattr(kt, method)(op, _t(b), **kw)
        assert st.status == sj.status and _band(st.niter, sj.niter,
                                                np.float64)
        for a, w in zip(vt, vj):
            _close(a.numpy(), w, np.float64)
    assert len(fused_calls) == len(runs)
    Ac = kt.DIAOperator(kt.convdiff_dia(4, dtype=torch.complex128,
                                        device="cpu"), use_kernel=True)
    v = torch.ones(64, dtype=torch.complex128)
    assert getattr(kt, method)(Ac, v)[-1].solved
    assert getattr(kt, method)(kt.DIAOperator(A, use_kernel=False),
                               _t(b))[-1].solved
    assert len(fused_calls) == len(runs)


def test_lnlq_stats_type_by_route():
    """LNLQ returns SimpleStats (inconsistent False) on the kernel route
    and LNLQStats on the general route, as the JAX package does
    (krylov_tpu/solvers/craig.py:923-931, 948-955): a quirk of the JAX
    package that the port keeps."""
    D, A, b = _stencil()
    op = kt.DIAOperator(A, use_kernel=True)
    jop = JDIAOperator(D, use_pallas=True)
    for kw, cls in (({}, "SimpleStats"), ({"history": True}, "LNLQStats")):
        *_, st = kt.lnlq(op, _t(b), **kw)
        *_, sj = kj.lnlq(jop, jnp.asarray(b), **kw)
        assert type(st).__name__ == type(sj).__name__ == cls
    assert st.solved and not kt.lnlq(op, _t(b))[-1].inconsistent


# kernel cases: (kernel, λ, keyword arguments)
CASES = {"craig": ("craig", 0.0, {}),
         "craig_lam": ("craig", 0.3, {"use_lam": True}),
         "craigmr": ("craigmr", 0.0, {}),
         "craigmr_lam": ("craigmr", 0.3, {"use_lam": True}),
         "lnlq": ("lnlq", 0.0, {}),
         "lnlq_lam": ("lnlq", 0.3, {"use_lam": True}),
         "lnlq_no_transfer": ("lnlq", 0.0, {"transfer_to_craig": False}),
         "cgne": ("cgne_crmr", 0.0, {"variant": "cgne"}),
         "cgne_lam": ("cgne_crmr", 0.3, {"variant": "cgne"}),
         "crmr": ("cgne_crmr", 0.0, {"variant": "crmr"}),
         "crmr_lam": ("cgne_crmr", 0.3, {"variant": "crmr"})}


def _kernel_args(name, lam, itmax):
    """The arguments after (pd, pd_adj, offsets, offsets_adj, b) of both
    packages' kernels, at the default tolerances (√eps) and conlim 1e8."""
    tol = float(np.sqrt(np.finfo(np.float64).eps))
    if name == "craig":
        return (lam, tol, tol, tol, 1e8, itmax)
    return (lam, tol, tol, itmax)


def _ints(r):
    return [int(v) for v in r if np.asarray(v).dtype == np.int32]


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("stencil", ["shifted", "plain", "zero_b"])
def test_plain_version_matches_jax_kernel(case, stencil):
    """Each plain version against the JAX kernel in interpret mode at 8³
    f64, on the stencil with and without the 0.5 shift and with b = 0,
    to the tolerances of the module docstring, with λ = 0.3 and LNLQ
    without the transfer; also capped at 30 iterations, to 1e-10."""
    D, A, b = _stencil(shift=0.0 if stencil == "plain" else 0.5)
    if stencil == "zero_b":
        b = np.zeros_like(b)
    (pdj, pdaj, offaj), (pd, pda, ot, ota) = _adjoint_pair(D, A)
    name, lam, kw = CASES[case]
    nvec = 1 if name == "cgne_crmr" else 2
    for itmax in (400, 30) if stencil != "zero_b" else (400,):
        args = _kernel_args(name, lam, itmax)
        rt_ = getattr(tf, name + "_dia_fused_ref")(pd, pda, ot, ota, _t(b),
                                                   *args, **kw)
        rj = getattr(jf, name + "_dia_fused")(
            pdj, pdaj, D.offsets, offaj, jnp.asarray(b), *args,
            interpret=True, **kw)
        it_t, *codes_t = _ints(rt_)
        it_j, *codes_j = _ints(rj)
        assert codes_t == codes_j
        for vt, vj in zip(rt_[:nvec], rj[:nvec]):
            if itmax == 30:
                assert _rel(vt.numpy(), np.asarray(vj)) <= TOL
            else:
                assert _rel(vt.numpy(), np.asarray(vj)) <= 1e-7
        assert (it_t == it_j) if itmax == 30 else _band(it_t, it_j,
                                                          np.float64)
        if stencil == "zero_b":
            assert it_t == 0 and codes_t == [2]
            assert not any(bool(v.any()) for v in rt_[:nvec])


def test_kernel_variant_must_be_known():
    D, A, b = _stencil()
    (_, _, _), (pd, pda, ot, ota) = _adjoint_pair(D, A)
    with pytest.raises(ValueError, match="variant"):
        tf.cgne_crmr_dia_fused(pd, pda, ot, ota, _t(b), 0.0, 1e-8, 1e-8, 10,
                               variant="cgls")


def test_krylov_solve_and_workspace():
    """The five methods through krylov_solve equal direct calls and the
    JAX package's; a CRAIG workspace's accessors match the JAX package's
    (two solutions, one A and one Aᴴ product per iteration), and these
    methods refuse a warm start."""
    A, b = _wellcond()
    for method in METHODS:
        *vs, st = kt.krylov_solve(method, _t(A), _t(b))
        *vd, sd = getattr(kt, method)(_t(A), _t(b))
        *vj, sj = kj.krylov_solve(method, A, b)
        assert (st.status, st.niter) == (sd.status, sd.niter) \
            == (sj.status, sj.niter)
        for v, d, j in zip(vs, vd, vj):
            assert torch.equal(v, d) and _rel(v.numpy(), j) <= TOL
    wj = kj.krylov_workspace("craig", A, b)
    wt = kt.krylov_workspace("craig", _t(A), _t(b))
    kj.krylov_solve_inplace(wj, A, b)
    kt.krylov_solve_inplace(wt, _t(A), _t(b))
    assert kt.iteration_count(wt) == kj.iteration_count(wj)
    assert kt.Aprod_count(wt) == kt.Atprod_count(wt) == kj.Atprod_count(wj)
    x, y = kt.solution(wt)
    for vt, vj in zip((x, y), kj.solution(wj)):
        assert _rel(vt.numpy(), vj) <= TOL
    assert kt.results(wt) == (x, y, kt.statistics(wt))
    assert wt.rNorm is not None and "state storage" in repr(wt)
    with pytest.raises(ValueError, match="does not support warm starts"):
        kt.warm_start(wt, x)
    ws = kt.krylov_workspace("lnlq", precision="double_word")
    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
        kt.krylov_solve_inplace(ws, _t(A), _t(b))
