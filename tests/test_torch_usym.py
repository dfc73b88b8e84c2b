"""krylov_tpu_torch.usymlq, usymqr, trilqr and usymlqr against
krylov_tpu's, on both routes (the cases of tests/test_twosided.py:
138-245 and tests/test_fused.py:1270-1495), and the plain versions of
their whole-solve kernels against krylov_tpu's ``usymlq_dia_fused``,
``usymqr_dia_fused``, ``trilqr_dia_fused`` and ``usymlqr_dia_fused`` in
interpret mode.

Inputs are made with numpy from a seed (or the fixture generators) and
given to both packages.  Tolerances: on the fixtures, in f64 and c128,
the status string, niter and the flags are equal and x (and y) agree to
1e-10 relative (the reductions are summed in another order), the
histories to 1e-10.  The kernel route runs on the convection-diffusion
stencil with 0.5 added to its main diagonal (convdiff + 0.5 I), which
keeps the stencil non-symmetric and its iteration counts small; there
SSY runs about 110 to 170 iterations on 512 unknowns without
reorthogonalisation, and the JAX package's results move with the order
of its sums alone: at rtol 1e-8 its general core stops USYMLQ at the LQ
point and the same core with a matrix-free product at the USYMCG point,
niter moves by up to 2 and x by up to 4e-8 relative.  The f64
comparisons there run at rtol 1e-6, where the JAX package agrees with
itself, and hold status and flags equal, niter equal and x (and y) to
1e-6 of max(|x|, |b|) (the bound of the JAX package's own test of these
kernels, tests/test_fused.py:1474-1477); in f32 the status is equal and
niter within ±max(2, 10%) (the band of tests/reference_niter.json).
A few fixtures are degenerate and say so where they are tested.
"""

import dataclasses
import itertools
from types import SimpleNamespace

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
from krylov_tpu.solvers.usymlq import _trilqr_status as jtrilqr_status
from krylov_tpu_torch.convert import dia_from_numpy
from krylov_tpu_torch.ops import cuda_fused as tf
from krylov_tpu_torch.ops.kops import sym_givens
from krylov_tpu_torch.solvers.usymlq import _trilqr_status
from test_torch_bilq import _adjoint_pair
from test_torch_gmres import _rel, port

TOL = 1e-10
ONE = ("usymlq", "usymqr")
TWO = ("trilqr", "usymlqr")


@pytest.fixture(params=[np.float64, np.complex128], ids=["f64", "c128"])
def FC(request):
    return request.param


def _t(v):
    return None if v is None else torch.as_tensor(np.asarray(v))


def _both(method, A, b, c, *args, **kw):
    """(port's result, JAX's result) of one call; each is (x, stats) or
    (x, y, stats)."""
    rj = getattr(kj, method)(A, b, c, *args, **kw)
    rt_ = getattr(kt, method)(port(A), _t(b), _t(c), *[_t(a) for a in args],
                              **kw)
    return rt_, rj


def _same(rt_, rj, tol=TOL, scale=None):
    """Status, niter and flags equal; the solutions to ``tol`` relative
    to their largest entry (or to ``scale``), with NaN where the JAX
    package has NaN."""
    *vt, st = rt_
    *vj, sj = rj
    assert st.status == sj.status
    assert st.niter == sj.niter
    for name in ("solved", "inconsistent", "solved_primal", "solved_dual"):
        if hasattr(sj, name):
            assert getattr(st, name) == getattr(sj, name), name
    for a, w in zip(vt, vj):
        a, w = a.numpy(), np.asarray(w)
        nan = np.isnan(w)
        assert (np.isnan(a) == nan).all()
        if scale is not None:
            assert np.abs(a - w).max() <= tol * scale
        elif not nan.all():
            assert _rel(a[~nan], w[~nan]) <= tol


def _histories(st, sj, names, upto=None):
    """Histories equal in shape and NaN entries (USYMQR's ‖Aᴴr‖ has none
    at iteration 0), the rest (the first ``upto`` entries) to 1e-10."""
    for name in names:
        got, want = getattr(st, name), np.asarray(getattr(sj, name))
        assert got.shape == want.shape and got.size > 0, name
        got, want = got[:upto], want[:upto]
        nan = np.isnan(want)
        assert (np.isnan(got) == nan).all(), name
        assert _rel(got[~nan], want[~nan]) <= TOL, name


# ---------------------------------------------------------------------------
# the general cores against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", ONE + TWO)
@pytest.mark.parametrize("n", [20, 40])
def test_square_adjoint(method, n, FC):
    A, b, c = fx.square_adjoint(n=n, FC=FC)
    rt_, rj = _both(method, A, b, c)
    _same(rt_, rj)
    assert rt_[-1].solved


@pytest.mark.parametrize("method", ONE + TWO)
def test_zero_rhs(method, FC):
    """b = 0 (and, for the two-solution methods, c = 0 and both)."""
    A, b, c = fx.square_adjoint(n=20, FC=FC)
    z = np.zeros_like(b)
    pairs = ((z, c),) if method in ONE else ((z, z), (z, c))
    if method == "usymlqr":
        pairs += ((b, z),)
    for bb, cc in pairs:
        _same(*_both(method, A, bb, cc))
    if method in ONE:
        assert _both(method, A, z, c)[0][-1].status == \
            "x is a zero-residual solution"


def test_trilqr_zero_c(FC):
    """c = 0 starts the SSY process from u₁ = 0, a degenerate process
    whose every later step rounding decides: the JAX package's general
    core stops after 27 iterations on the dense operator and after 19
    when only the order of its product's sums changes.  The port is held
    to the status, the flags and the primal true residual."""
    A, b, _ = fx.square_adjoint(n=20, FC=FC)
    (xt, yt, st), (xj, yj, sj) = _both("trilqr", A, b, np.zeros_like(b))
    assert st.status == sj.status
    assert (st.solved_primal, st.solved_dual) == (sj.solved_primal,
                                                  sj.solved_dual)
    assert not yt.any()
    for x in (xt.numpy(), np.asarray(xj)):
        assert np.linalg.norm(b - A @ x) <= 1e-7 * np.linalg.norm(b)


@pytest.mark.parametrize("make", [
    lambda FC: (*fx.over_consistent(FC=FC), np.ones(10, dtype=FC)),
    lambda FC: (*fx.under_inconsistent(FC=FC), np.array(
        [1.0 if (i + 1) % 2 == 0 else -1.0 for i in range(25)]).astype(FC)),
    lambda FC: (*fx.square_inconsistent(FC=FC), np.ones(10, dtype=FC))],
    ids=["over_consistent", "under_inconsistent", "square_inconsistent"])
def test_usymqr_rectangular_and_inconsistent(make, FC):
    """USYMQR's rectangular systems and its inconsistency flag
    (tests/test_twosided.py:149-172).  The two inconsistent systems stop
    at iteration 2, after the SSY process has exhausted a basis: x has
    grown to about 1e15 along a direction the last bits of the products
    decide, and the second residual estimates with it (the JAX package's
    own x moves by 2.4e15 and its estimate by 9% when only the order of
    its product's sums changes).  There x is held to be finite and the
    estimates of iteration 0 and 1 to 1e-10."""
    A, b, c = make(FC)
    rt_, rj = _both("usymqr", A, b, c, history=True)
    consistent = A.shape == (25, 10)
    if consistent:
        _same(rt_, rj)
    else:
        _same((rt_[-1],), (rj[-1],))
        assert np.isfinite(rt_[0].numpy()).all()
    _histories(rt_[-1], rj[-1], ("residuals", "Aresiduals"),
               upto=None if consistent else 2)
    assert rt_[-1].inconsistent == (not consistent)


@pytest.mark.parametrize("method,transpose", [
    ("usymlq", False), ("usymlq", True), ("usymqr", False),
    ("usymqr", True), ("trilqr", False), ("trilqr", True),
    ("usymlqr", True)], ids=lambda v: {False: "2x3", True: "3x2"}.get(v, v))
def test_ssy_mo_breakdown(method, transpose, FC):
    """The SSY fixture whose process exhausts a basis early, in both
    orientations (tests/fixtures.py:343).  On the 3 x 2 matrix γ₂ is 0 in
    exact arithmetic: the port's products give 0, and USYMLQ and TriLQR
    stop at the USYMCG point after 2 iterations with x = 0, the
    least-squares solution; the JAX package's products give 1.8e-17, on
    which it runs to its iteration limit over a basis of rounding noise.
    There those two are held to that outcome; everything else to the JAX
    package's, with x compared to 1e-10 of ‖b‖ (x = 0 is USYMQR's
    solution there too).  USYMLQR's saddle system on the 2 x 3 matrix is
    singular and inconsistent; neither package solves it, and rounding
    decides where each stops."""
    A, b, c = fx.ssy_mo_breakdown(transpose, FC=FC)
    rt_, rj = _both(method, A, b, c)
    if transpose and method in ("usymlq", "trilqr"):
        st = rt_[-1]
        assert st.niter == 2 and st.solved_primal if method == "trilqr" \
            else st.status == "solution xᶜ good enough given atol and rtol"
        assert np.abs(rt_[0].numpy()).max() <= 1e-15
        return
    *vt, st = rt_
    *vj, sj = rj
    _same((st,), (sj,))
    for a, w in zip(vt, vj):
        assert np.abs(a.numpy() - np.asarray(w)).max() \
            <= TOL * np.abs(b).max()


def test_trilqr_rectangular():
    A, b, c = fx.underdetermined_adjoint(20, 40)
    rt_, rj = _both("trilqr", A, b, c)
    _same(rt_, rj)
    assert rt_[-1].solved_primal


def test_trilqr_square_adjoint50(FC):
    """BiLQR's sensitive fixture (test_torch_bilq.py), exact here: SSY's
    residual estimates need no ⟨v, v⟩ cancellation."""
    A, b, c = fx.square_adjoint(n=50, FC=FC)
    rt_, rj = _both("trilqr", A, b, c)
    _same(rt_, rj)
    assert rt_[-1].solved_primal and rt_[-1].solved_dual


def _saddle_120x80():
    """The 120 x 80 system of examples/trimr_usymlqr_saddle.py."""
    rng = np.random.default_rng(5)
    m, n = 120, 80
    A = rng.standard_normal((m, n)) / np.sqrt(m)
    return A, rng.standard_normal(m), rng.standard_normal(n)


MODES = pytest.mark.parametrize("mode", [{}, {"ln": False}, {"ls": False}],
                                ids=["ls_ln", "ls", "ln"])


def _small_sp(FC):
    """The 4 x 4 system of reference test_usymlqr.jl's "Small complex SP"
    block (tests/test_twosided.py:220-235)."""
    rng = np.random.default_rng(7)

    def rnd(*s):
        a = rng.random(s)
        return a + 1j * rng.random(s) if FC == np.complex128 else a

    return rnd(4, 4).astype(FC), rnd(4).astype(FC), rnd(4).astype(FC)


def _example_5x5(FC):
    """The 5 x 5 system of examples/trimr_usymlqr_saddle.py (reference
    docs/src/examples/usymlqr.md)."""
    A = np.array([[2.0 ** (i / j) * j + (-1.0) ** (i - j) * 5 * (i - 1)
                   for j in range(1, 6)] for i in range(1, 6)]).astype(FC)
    b = np.ones(5, dtype=FC)
    return A, b, -3.0 * b


@MODES
@pytest.mark.parametrize("make", [_small_sp, _example_5x5],
                         ids=["small_sp", "example_5x5"])
def test_usymlqr_modes(mode, make, FC):
    """x = xᴸ + r holds the least-squares residual r, near 0, so the
    solutions are compared relative to the data, max(|b|, |c|): to 1e-10
    on the 4 x 4 system and to 1e-8 on the 5 x 5 example, whose A has a
    condition number of 6.7e3 (κ² eps = 4.5e-9 bounds what a saddle
    solve keeps)."""
    A, b, c = make(FC)
    rt_, rj = _both("usymlqr", A, b, c, **mode)
    scale = max(np.abs(b).max(), np.abs(c).max())
    _same(rt_, rj, tol=TOL if make is _small_sp else 1e-8, scale=scale)
    assert rt_[-1].solved


@MODES
def test_usymlqr_saddle_120x80(mode):
    """The 120 x 80 system of the example, to the default tolerances.  It
    runs about 84 iterations on 80 unknowns without reorthogonalisation:
    the JAX package's x moves by 3.5e-8 when only the order of its
    product's sums changes, and the port stops one iteration after it
    with the ls sweep.  So it is held to the status, the band and the
    true block residuals of the sweeps run (b − x − Ay with ls,
    c − Aᴴx with ln), no worse than 1.5 times the JAX package's."""
    A, b, c = _saddle_120x80()
    (xt, yt, st), (xj, yj, sj) = _both("usymlqr", A, b, c, **mode)
    assert st.status == sj.status and st.solved == sj.solved
    assert abs(st.niter - sj.niter) <= max(2, 0.1 * sj.niter)

    def res(x, y):
        x, y = np.asarray(x), np.asarray(y)
        return (np.linalg.norm(b - x - A @ y) if mode.get("ls", True)
                else 0.0, np.linalg.norm(c - A.T @ x)
                if mode.get("ln", True) else 0.0)

    for got, want in zip(res(xt.numpy(), yt.numpy()), res(xj, yj)):
        assert got <= 1.5 * want + 1e-12 * np.linalg.norm(b)


def test_usymlqr_raises():
    A, b, c = _saddle_120x80()
    with pytest.raises(ValueError, match="can't be both"):
        kt.usymlqr(_t(A), _t(b), _t(c), ls=False, ln=False)
    with pytest.raises(ValueError, match="Inconsistent problem size"):
        kt.usymlqr(_t(A), _t(c), _t(b))
    for method in ONE + TWO:
        with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
            getattr(kt, method)(_t(A), _t(b), _t(c),
                                precision="double_word")


# ---------------------------------------------------------------------------
# options
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", ONE + TWO)
def test_history_itmax_and_warm_start(method):
    A, b, c = fx.square_adjoint(n=20)
    rt_, rj = _both(method, A, b, c, history=True)
    _same(rt_, rj)
    names = {"usymlq": ("residuals",),
             "usymqr": ("residuals", "Aresiduals"),
             "trilqr": ("residuals_primal", "residuals_dual"),
             "usymlqr": ("residuals", "Aresiduals")}[method]
    _histories(rt_[-1], rj[-1], names)
    _same(*_both(method, A, b, c, itmax=3, rtol=1e-30, atol=1e-30))
    x0, y0 = 1.2 * np.ones(b.shape[0]), 0.8 * np.ones(b.shape[0])
    _same(*_both(method, A, b, c, x0))
    if method in TWO:
        _same(*_both(method, A, b, c, x0, y0))
        _same(*_both(method, A, b, c, None, y0))


@pytest.mark.parametrize("method", ONE + TWO)
def test_callback_timemax_and_verbose(method, capsys):
    A, b, c = fx.square_adjoint(n=40)

    def cb(state):
        return state.iter >= 4

    rt_, rj = _both(method, A, b, c, callback=cb, rtol=1e-30, atol=1e-30)
    _same(rt_, rj)
    assert rt_[-1].status == "user-requested exit" and rt_[-1].niter == 4
    R = np.random.default_rng(0).standard_normal((100, 100))
    v = torch.ones(100, dtype=torch.float64)
    *_, st = getattr(kt, method)(torch.as_tensor(R), v, v, rtol=1e-30,
                                 atol=1e-30, itmax=300, timemax=1e-9)
    assert st.status == "time limit exceeded" and st.niter == 64
    capsys.readouterr()
    _same(*_both(method, A, b, c, verbose=1))
    out = capsys.readouterr().out
    assert out.count(f"{method.upper()}: system of size 40") == 2


def test_callback_sees_active_iterations_only():
    A, b, c = fx.square_adjoint(n=20)
    seen = []
    kt.usymqr(_t(A), _t(b), _t(c), callback=lambda s: seen.append(
        int(s.iter)) or False)
    st = kt.usymqr(_t(A), _t(b), _t(c))[1]
    assert seen == list(range(1, st.niter + 1))


def test_usymlq_without_transfer(FC):
    A, b, c = fx.square_adjoint(n=40, FC=FC)
    rt_, rj = _both("usymlq", A, b, c, transfer_to_usymcg=False)
    _same(rt_, rj)
    assert rt_[-1].status == "solution xᴸ good enough given atol and rtol"
    _same(*_both("trilqr", A, b, c, transfer_to_usymcg=False))


def test_csr_and_matrix_free_operators():
    """A CSR operator (its adjoint built on the host) and a matrix-free
    one give the dense operator's results."""
    A, b, c = fx.square_adjoint(n=30)
    csr = kt.csr_from_dense(_t(A))
    At = _t(A)
    fn = kt.FunctionOperator(lambda v: At @ v, A.shape, torch.float64,
                             rmatvec=lambda v: At.T @ v)
    for method in ONE + TWO:
        *want, _ = getattr(kt, method)(At, _t(b), _t(c))
        for op in (csr, fn):
            *got, _ = getattr(kt, method)(op, _t(b), _t(c))
            for g, w in zip(got, want):
                assert _rel(g.numpy(), w.numpy()) <= 1e-12


def test_trilqr_status_vocabulary_matches_jax():
    """Every combination of the nine flags and the codes that bypass
    them gives the JAX package's string."""
    names = ("solved_lq_tol", "solved_lq_mach", "solved_cg_tol",
             "solved_cg_mach", "solved_qr_tol", "solved_qr_mach",
             "solved_primal", "solved_dual", "inconsistent_dual")
    codes = (kt._runtime.SOLVED_PRIMAL_DUAL, kt._runtime.TIRED,
             kt._runtime.USER_EXIT, kt._runtime.ZERO_RESIDUAL)
    for bits in itertools.product((False, True), repeat=9):
        flags = dict(zip(names, bits), breakdown=False)
        ns = type("S", (), flags)
        for code in codes:
            assert _trilqr_status(ns, code) == jtrilqr_status(ns, code)


def test_show_stats_for_trilqr_and_usymlqr():
    """A TriLQR AdjointStats and a USYMLQR SimpleStats with Aresiduals
    render as the JAX package's do."""
    A, b, c = fx.square_adjoint(n=20)
    for method in TWO:
        (*_, st), (*_, sj) = _both(method, A, b, c, history=True)
        port_copy = type(st)(**{f.name: getattr(sj, f.name)
                                for f in dataclasses.fields(sj)})
        assert kt.show_stats(port_copy) == kj.show_stats(sj)
        assert kt.show_stats(st).splitlines()[:2] == \
            kj.show_stats(sj).splitlines()[:2]
    assert "Aresiduals" in kt.show_stats(st)


def test_inputs_placement():
    """A numpy b, c (and y0) beside a CPU operator stay on the CPU."""
    A = kt.convdiff_dia(4, dtype=torch.float64, device="cpu")
    v = np.random.default_rng(1).standard_normal(64)
    for method in ONE + TWO:
        *xs, st = getattr(kt, method)(A, v, v + 1.0)
        assert all(x.device.type == "cpu" for x in xs) and st.solved


# ---------------------------------------------------------------------------
# the kernel route and the plain versions
# ---------------------------------------------------------------------------

def _shifted(N=8, dtype=np.float64, seed=5):
    """convdiff_dia(N) + 0.5 I in both packages, and b, c from seeds
    ``seed`` and ``seed + 1``."""
    D0 = jconvdiff(N, N, N, dtype=dtype)
    data = np.array(D0.data)
    data[list(D0.offsets).index(0)] += 0.5
    D = JDIAMatrix(jnp.asarray(data), D0.offsets, D0.shape)
    A = dia_from_numpy(data, D0.offsets, D0.shape, device="cpu")
    n = D0.shape[0]
    b = np.random.default_rng(seed).standard_normal(n).astype(dtype)
    c = np.random.default_rng(seed + 1).standard_normal(n).astype(dtype)
    return D, A, b, c


@pytest.fixture
def fused_calls(monkeypatch):
    """Counts the calls of the four kernels' plain versions, which the
    kernel wrappers take for CPU tensors."""
    calls = []
    for method in ONE + TWO:
        name = method + "_dia_fused_ref"
        ref = getattr(tf, name)

        def counted(*a, _ref=ref, _name=name, **k):
            calls.append(_name)
            return _ref(*a, **k)

        monkeypatch.setattr(tf, name, counted)
    return calls


RTOL = {np.float64: 1e-6, np.float32: 1e-5}


def _kernel_same(got, want, dtype, b):
    """The shifted-stencil comparison of the module docstring.  ``got``
    and ``want`` are (solutions, niter, codes): f64 codes (status and
    flags) and niter equal, the solutions to 1e-6 of max(|x|, |b|); f32
    niter within the band (its status moves between the LQ and USYMCG
    points, both solved)."""
    (vt, nt, ct), (vj, nj, cj) = got, want
    if dtype == np.float64:
        assert (nt, ct) == (nj, cj)
        for a, w in zip(vt, vj):
            w = np.asarray(w)
            assert np.abs(np.asarray(a) - w).max() <= 1e-6 * max(
                np.abs(w).max(), np.abs(b).max())
    else:
        assert abs(nt - nj) <= max(2, 0.1 * nj)


def _kernel_out(r, nvec):
    """(solutions, niter, codes) of a kernel's or plain version's
    outputs."""
    ints = [i for v in r[nvec:] if np.asarray(v).dtype == np.int32
            for i in np.asarray(v).reshape(-1).tolist()]
    return r[:nvec], ints[0], ints[1:]


def _solve_out(r):
    """(solutions, niter, codes) of an entry point's outputs."""
    *xs, st = r
    return [x.numpy() if hasattr(x, "numpy") else x for x in xs], \
        st.niter, [st.status, getattr(st, "solved_primal", None),
                   getattr(st, "solved_dual", None)]


@pytest.mark.parametrize("method", ONE + TWO)
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_fused_route_matches_jax(method, dtype, fused_calls):
    """The kernel route is taken exactly where the JAX gate admits it
    (krylov_tpu/solvers/usymlq.py:224-227, 456-459, 816-819, 1188-1191):
    no warm start, history, callback, verbose or timemax; every excluded
    option runs the general core (tests/test_fused.py:1289-1303,
    1445-1457, 1480-1494)."""
    D, A, b, c = _shifted(dtype=dtype)
    op = kt.DIAOperator(A, use_kernel=True)
    rtol = RTOL[dtype]
    rj = getattr(kj, method)(JDIAOperator(D, use_pallas=True),
                             jnp.asarray(b), jnp.asarray(c), atol=0.0,
                             rtol=rtol)
    rt_ = getattr(kt, method)(op, _t(b), _t(c), atol=0.0, rtol=rtol)
    _kernel_same(_solve_out(rt_), _solve_out(rj), dtype, b)
    assert fused_calls == [method + "_dia_fused_ref"]
    z = _t(np.zeros_like(b))
    fallbacks = [((z,), {}), ((), {"history": True}), ((), {"timemax": 1e6}),
                 ((), {"callback": lambda s: False}), ((), {"verbose": 1})]
    if method in TWO:
        fallbacks += [((None, z), {})]
    for args, kw in fallbacks:
        *_, st = getattr(kt, method)(op, _t(b), _t(c), *args, atol=0.0,
                                     rtol=rtol, **kw)
        assert st.solved or st.inconsistent
    assert len(fused_calls) == 1
    *_, st = getattr(kt, method)(op, z, _t(c))
    assert len(fused_calls) == 2
    if method in ONE:
        assert st.niter == 0 and st.status == "x is a zero-residual solution"


def test_fused_route_options(fused_calls):
    """USYMLQ's and TriLQR's transfer and USYMLQR's ls / ln go to the
    kernel; a complex system never does."""
    D, A, b, c = _shifted()
    op = kt.DIAOperator(A, use_kernel=True)
    for method, kw in (("usymlq", {"transfer_to_usymcg": False}),
                       ("trilqr", {"transfer_to_usymcg": False}),
                       ("usymlqr", {"ls": False}), ("usymlqr", {"ln": False})):
        rj = getattr(kj, method)(JDIAOperator(D, use_pallas=True),
                                 jnp.asarray(b), jnp.asarray(c), atol=0.0,
                                 rtol=1e-6, **kw)
        rt_ = getattr(kt, method)(op, _t(b), _t(c), atol=0.0, rtol=1e-6,
                                  **kw)
        _kernel_same(_solve_out(rt_), _solve_out(rj), np.float64, b)
    assert len(fused_calls) == 4
    Ac = kt.DIAOperator(kt.convdiff_dia(4, dtype=torch.complex128,
                                        device="cpu"), use_kernel=True)
    v = torch.ones(64, dtype=torch.complex128)
    *_, st = kt.usymqr(Ac, v, v)
    assert st.solved and len(fused_calls) == 4


KERNELS = {"usymlq": {}, "usymlq_no_transfer": {"transfer_to_usymcg": False},
           "usymqr": {}, "trilqr": {},
           "trilqr_no_transfer": {"transfer_to_usymcg": False},
           "usymlqr": {}, "usymlqr_ls": {"ln": False},
           "usymlqr_ln": {"ls": False}}


@pytest.mark.parametrize("kernel", sorted(KERNELS))
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("rhs", ["b", "zero_b", "zero_c"])
def test_plain_version_matches_jax_kernel(kernel, dtype, rhs):
    """Each plain version against the JAX kernel in interpret mode at 8³
    on the shifted stencil, to the tolerances of the module docstring,
    with b = 0 and with c = 0.  For USYMLQ and TriLQR, c = 0 starts the
    SSY process from u₁ = 0, a degenerate process whose every later step
    rounding decides (the JAX package's general core runs to its limit of
    1024 iterations there, and stops after 255 when only the order of its
    product's sums changes); there the port is held to a finite x and the
    primal true residual its status claims."""
    D, A, b, c = _shifted(dtype=dtype)
    if rhs == "zero_b":
        b = np.zeros_like(b)
    elif rhs == "zero_c":
        c = np.zeros_like(c)
    (pdj, pdaj, offaj), (pd, pda, ot, ota) = _adjoint_pair(D, A)
    rtol = RTOL[dtype]
    name, kw = kernel.split("_")[0], KERNELS[kernel]
    rt_ = getattr(tf, name + "_dia_fused_ref")(pd, pda, ot, ota, _t(b), _t(c),
                                               0.0, rtol, 400, **kw)
    nvec = 2 if name in TWO else 1
    if rhs == "zero_c" and name in ("usymlq", "trilqr"):
        x = rt_[0].numpy()
        assert np.isfinite(x).all()
        if int(rt_[nvec + 1]) != 0:
            r = b - kt.DIAOperator(A).matvec(_t(x)).numpy()
            assert np.linalg.norm(r) <= 10 * rtol * np.linalg.norm(b)
        return
    rj = getattr(jf, name + "_dia_fused")(
        pdj, pdaj, D.offsets, offaj, jnp.asarray(b), jnp.asarray(c), 0.0,
        rtol, 400, interpret=True, **kw)
    _kernel_same(_kernel_out(rt_, nvec), _kernel_out(rj, nvec), dtype, b)


def _usymqr_deferred(pd, pda, ot, ota, b, c, atol, rtol, itmax):
    """USYMQR on its kernel's schedule (``csrc/usymqr_dia.cu``): v and u
    each in three buffers and w in two, indexed by the 0-based iteration
    count; each iteration's wₖ and x += ζₖ wₖ applied at the start of the
    next iteration, from the ζₖ, λₖ₋₁, εₖ₋₂ and dₖ its step staged and
    from its uₖ (the next iteration's uₖ₋₁), and the last one after the
    loop, where no iteration follows.  The scalar step is the plain
    version's, expression for expression.  Returns what
    ``usymqr_dia_fused_ref`` returns."""
    one, zero = tf._scalar(1, b), tf._scalar(0, b)
    bnorm, gamma, v1, u1 = tf._ssy_start(b, c)
    eps_lim = tf._scalar(atol, b) + tf._scalar(rtol, b) * bnorm
    V = [v1, torch.zeros_like(b), torch.zeros_like(b)]
    U = [u1, torch.zeros_like(b), torch.zeros_like(b)]
    W = [torch.zeros_like(b), torch.zeros_like(b)]
    x = torch.zeros_like(b)
    beta, zetabar, rnorm = bnorm, bnorm, bnorm
    c_km2 = s_km2 = c_km1 = s_km1 = kappa = arnorm = zero
    incon = tf._i32(0, b)
    status = torch.where(bnorm == 0, tf.ZERO_RESIDUAL, torch.where(
        bnorm <= eps_lim, tf.SOLVED, tf.RUNNING)).to(torch.int32)
    staged, it0 = None, 0

    def apply(jt, x):
        zeta, lam, eps, d = staged
        w = (U[jt % 3] - lam * W[(jt + 1) % 2] - eps * W[jt % 2]) / d
        W[jt % 2] = w
        return x + zeta * w

    while int(status) == tf.RUNNING and it0 < itmax:
        if staged is not None:
            x = apply(it0 - 1, x)
        it = it0 + 1
        s = SimpleNamespace(vk=V[it0 % 3], uk=U[it0 % 3],
                            vkm1=V[(it0 + 2) % 3], ukm1=U[(it0 + 2) % 3],
                            beta=beta, gamma=gamma, iter=tf._i32(it0, b))
        q, p, alpha, beta1, gamma1 = tf._ssy_ref(pd, ot, pda, ota, s, one,
                                                 zero)
        eps_km2 = s_km2 * gamma if it >= 3 else zero
        lbar_km1 = -c_km2 * gamma if it >= 3 else (gamma if it == 2
                                                   else zero)
        lam_km1 = c_km1 * lbar_km1 + s_km1 * alpha if it >= 2 else zero
        dbar_k = s_km1 * lbar_km1 - c_km1 * alpha if it >= 2 else alpha
        ck, sk, d_k = sym_givens(dbar_k, beta1)
        staged = (ck * zetabar, lam_km1, eps_km2, tf._safe(d_k, one))
        V[(it0 + 1) % 3], U[(it0 + 1) % 3] = tf._ssy_next(
            q, p, beta1, gamma1, s.vk, s.uk, one)
        rnorm = torch.abs(sk * zetabar)
        arnorm = torch.abs(zetabar) * torch.sqrt(
            dbar_k * dbar_k + (c_km1 * gamma1) ** 2)
        if it == 1:
            kappa = tf._scalar(atol, b) + tf._scalar(rtol, b) * arnorm
        solved = rnorm <= eps_lim
        incons = ~solved & (arnorm <= kappa)
        status = torch.where(solved, tf.SOLVED, torch.where(
            incons, tf.INCONSISTENT, tf.RUNNING)).to(torch.int32)
        incon = incons.to(torch.int32)
        c_km2, s_km2, c_km1, s_km1 = c_km1, s_km1, ck, sk
        zetabar, beta, gamma = sk * zetabar, beta1, gamma1
        it0 = it
    if staged is not None:
        x = apply(it0 - 1, x)
    return x, tf._i32(it0, b), rnorm, arnorm, status, incon


@pytest.mark.parametrize("itmax", [1, 2, 3, None, "zero_b"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_usymqr_deferred_schedule_matches_plain_version(itmax, dtype):
    """The USYMQR kernel's schedule, its direction and x updates one
    iteration late and the last one by the finishing launch, gives the
    bits of ``usymqr_dia_fused_ref`` at 8³ on the shifted stencil: capped
    at 1, 2 and 3 iterations, converged (itmax 400), and with b = 0,
    where no iteration runs and nothing is pending."""
    D, A, b, c = _shifted(dtype=dtype)
    if itmax == "zero_b":
        b, itmax = np.zeros_like(b), None
    _, (pd, pda, ot, ota) = _adjoint_pair(D, A)
    args = (pd, pda, ot, ota, _t(b), _t(c), 0.0, RTOL[dtype], itmax or 400)
    got = _usymqr_deferred(*args)
    want = tf.usymqr_dia_fused_ref(*args)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    if itmax is not None:
        assert int(got[1]) == itmax
    elif b.any():
        assert int(got[4]) == tf.SOLVED and 3 < int(got[1]) < 400
    else:
        assert int(got[1]) == 0


def test_krylov_solve_and_workspace():
    """The four methods through krylov_solve equal direct calls; a TriLQR
    workspace round trip with a warm start matches the JAX package's."""
    A, b, c = fx.square_adjoint(n=20)
    for method in ONE + TWO:
        *vs, st = kt.krylov_solve(method, _t(A), _t(b), _t(c))
        *vd, sd = getattr(kt, method)(_t(A), _t(b), _t(c))
        *vj, sj = kj.krylov_solve(method, A, b, c)
        assert (st.status, st.niter) == (sd.status, sd.niter) \
            == (sj.status, sj.niter)
        for a, d, j in zip(vs, vd, vj):
            assert torch.equal(a, d) and _rel(a.numpy(), j) <= TOL
    wj = kj.krylov_workspace("trilqr", A, b)
    wt = kt.krylov_workspace("trilqr", _t(A), _t(b))
    kj.krylov_solve_inplace(wj, A, b, c)
    kt.krylov_solve_inplace(wt, _t(A), _t(b), _t(c))
    x, y = kt.solution(wt)
    assert kt.Aprod_count(wt) == kt.Atprod_count(wt) == kt.iteration_count(
        wt) == kj.iteration_count(wj)
    assert kt.issolved_primal(wt) and kt.issolved_dual(wt)
    kj.warm_start(wj, 0.5 * np.asarray(x), 0.5 * np.asarray(y))
    kt.warm_start(wt, 0.5 * x, 0.5 * y)
    kj.krylov_solve_inplace(wj, A, b, c)
    kt.krylov_solve_inplace(wt, _t(A), _t(b), _t(c))
    assert kt.iteration_count(wt) == kj.iteration_count(wj)
    for vt, vj in zip(kt.solution(wt), kj.solution(wj)):
        assert _rel(vt.numpy(), vj) <= TOL
    assert wt._x0 is None and wt._y0 is None


def test_usymlqr_timemax_over_two_chunks_keeps_x_and_y():
    """``usymlqr(..., timemax=1e6)`` on a solve of 106 iterations (two
    chunks of ``_runtime.drive``) gives the x and y of its ``timemax=inf``
    solve, bit for bit, and both solve the saddle system.  The port
    composes x ← xᴸ + r and y ← y + zᴸ once, after the loop; the JAX
    package composes them at the end of every chunk
    (krylov_tpu/solvers/usymlq.py:1146-1149), so its second chunk adds r
    and zᴸ again, and this test cannot hold the port to it here."""
    rng = np.random.default_rng(0)
    A = 2.0 * np.eye(200) + rng.standard_normal((200, 200)) / np.sqrt(200)
    b, c = rng.standard_normal(200), rng.standard_normal(200)
    x, y, st = kt.usymlqr(_t(A), _t(b), _t(c), atol=0.0, rtol=1e-12)
    xm, ym, sm = kt.usymlqr(_t(A), _t(b), _t(c), atol=0.0, rtol=1e-12,
                            timemax=1e6)
    assert st.niter == sm.niter > 64 and st.status == sm.status
    assert st.solved and sm.solved
    assert torch.equal(x, xm) and torch.equal(y, ym)
    x, y = xm.numpy(), ym.numpy()
    assert np.linalg.norm(b - x - A @ y) <= 1e-10 * np.linalg.norm(b)
    assert np.linalg.norm(c - A.T @ x) <= 1e-10 * np.linalg.norm(c)
