"""krylov_tpu_torch.cgls, crls and cgls_lanczos_shift against krylov_tpu's,
on both routes (the cases of tests/test_ls_family.py, tests/
test_fixture_zoo.py:173-180, 264-270 and tests/test_fused.py:726-761,
1335-1370), and the plain versions of their whole-solve kernels against
krylov_tpu's ``cgls_dia_fused``, ``crls_dia_fused`` and
``cgls_lanczos_shift_dia_fused`` in interpret mode.

Inputs are made with numpy from a seed (or the fixture generators) and
given to both packages.  Tolerances: on the fixtures, in f64 and c128,
the status string, niter and ``solved`` are equal and x and the
histories agree to 1e-10 relative (the reductions are summed in another
order).  The options run on ``gen_lsq(25, 10)`` (tests/fixtures.py), an
overdetermined system that the three methods solve in 10 to 12
iterations.

The kernel route runs on the convection-diffusion stencil, 512
unknowns, the JAX package's own cell for this family (tests/
test_fused.py:726-761).  There CG and CR on AᴴA run 100 to 115
iterations without reorthogonalisation, and their iterates follow the
order of the sums: the JAX package's own tests hold its kernels to its
general cores with niter within 1 and x to 1e-6 of max|x| + 1.  So
there, in f64, the status is equal, niter within 1 and x within 1e-7 of
max|x| + 1 (measured against the JAX kernels: 2.2e-8 relative, the shift
solver stopping at 104 against 105, and 9.2e-9 at most for the others);
a run capped at 30 iterations, before the rounding has grown, holds
niter, status and x to 1e-10 (measured: 5.1e-13 at most).  In f32 the status is equal and niter
within ±max(2, 10%) (the band of tests/reference_niter.json).
"""

import json
import pathlib

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
from krylov_tpu_torch import workspaces as tws
from krylov_tpu_torch.convert import dia_from_numpy
from krylov_tpu_torch.ops import cuda_fused as tf
from test_torch_bilq import _adjoint_pair
from test_torch_gmres import _rel

TOL = 1e-10
METHODS = ("cgls", "crls")
SHIFTS = [0.1, 1.0]
NITER = json.loads((pathlib.Path(__file__).parent
                    / "reference_niter.json").read_text())


@pytest.fixture(params=[np.float64, np.complex128], ids=["f64", "c128"])
def FC(request):
    return request.param


def _t(v):
    return None if v is None else torch.as_tensor(np.asarray(v))


def _both(method, A, b, *args, **kw):
    """(port's (x, stats), JAX's (x, stats)) of one call."""
    rj = getattr(kj, method)(A, b, *args, **kw)
    rt_ = getattr(kt, method)(_t(A), _t(b), *args, **kw)
    return rt_, rj


def _same(rt_, rj, tol=TOL, histories=False):
    """Status, niter and the flags equal; x (and the histories) to ``tol``
    relative."""
    (xt, st), (xj, sj) = rt_, rj
    assert type(st).__name__ == type(sj).__name__
    assert (st.status, st.niter, st.solved) == (sj.status, sj.niter,
                                                sj.solved)
    assert _rel(xt.numpy(), np.asarray(xj)) <= tol
    if isinstance(st, kt.LanczosShiftStats):
        assert np.array_equal(st.indefinite, np.asarray(sj.indefinite))
        if histories:
            assert len(st.residuals) == len(sj.residuals)
            for got, want in zip(st.residuals, sj.residuals):
                assert got.shape == np.asarray(want).shape
                assert _rel(got, want) <= tol
        return
    assert st.inconsistent == sj.inconsistent
    if histories:
        for name in ("residuals", "Aresiduals"):
            got, want = getattr(st, name), np.asarray(getattr(sj, name))
            assert got.shape == want.shape
            if want.size:
                assert _rel(got, want) <= tol, name


def _gen_lsq():
    b, A, *_ = fx.gen_lsq(25, 10, 1, 1, 0.0)
    return np.asarray(A), np.asarray(b)


# ---------------------------------------------------------------------------
# the general cores against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("fixture", ["over_consistent", "over_inconsistent",
                                     "square_consistent"])
def test_least_squares(method, fixture, FC):
    """The least-squares solution of a rectangular or square system
    (tests/test_ls_family.py:26-43), with the histories."""
    A, b = getattr(fx, fixture)(FC=FC)
    rt_, rj = _both(method, A, b, history=True)
    _same(rt_, rj, histories=True)
    x = rt_[0].numpy()
    assert np.linalg.norm(A.conj().T @ (b - A @ x)) <= 1e-5 \
        * np.linalg.norm(A) * np.linalg.norm(b)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("lam", [1e-3, 0.1])
def test_regularized(method, lam, FC):
    """λ-regularised normal equations Aᴴr = λx (tests/test_ls_family.py:
    52-61), real and complex."""
    A, b = _gen_lsq()
    A, b = A.astype(FC), b.astype(FC)
    rt_, rj = _both(method, A, b, lam=lam, history=True)
    _same(rt_, rj, histories=True)
    x = rt_[0].numpy()
    resid = np.linalg.norm(A.conj().T @ (b - A @ x) - lam * x)
    assert resid / np.linalg.norm(b) <= 1e-5


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("radius", [0.5, 5.0])
def test_trust_region(method, radius, FC):
    """The trust-region ``radius`` (through ``to_boundary``): a small
    radius stops on the boundary, with ‖x‖ = radius; a large one is not
    reached."""
    A, b = _gen_lsq()
    A, b = A.astype(FC), b.astype(FC)
    rt_, rj = _both(method, A, b, radius=radius, history=True)
    _same(rt_, rj, histories=True)
    xnorm = float(np.linalg.norm(rt_[0].numpy()))
    if rt_[1].status == "on trust-region boundary":
        assert abs(xnorm - radius) <= 1e-8 * radius
    else:
        assert xnorm < radius


def test_trust_region_stops_on_the_boundary():
    """With radius 0.5 both methods stop on the boundary, as the JAX
    package's do."""
    A, b = _gen_lsq()
    for method in METHODS:
        (_, st), (_, sj) = _both(method, A, b, radius=0.5)
        assert st.status == sj.status == "on trust-region boundary"


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("ldiv", [False, True])
def test_preconditioner(method, ldiv):
    """M as a diagonal operator on the b side, applied or divided by, on a
    seeded normal 300 × 60 system, solved in 20 iterations: before the
    finite termination of CG on AᴴA, where the last ‖Aᴴr‖ is rounding
    alone, and before that rounding grows (at 40 iterations on a 200 ×
    100 system CGLS's x moves by 1.8e-10, the watch list's Golub–Kahan
    rounding)."""
    rng = np.random.default_rng(7)
    A, b = rng.standard_normal((300, 60)), rng.standard_normal(300)
    d = 1.0 + np.random.default_rng(3).random(300)
    rj = getattr(kj, method)(A, b, M=kj.DiagonalOperator(d), ldiv=ldiv,
                             history=True)
    rt_ = getattr(kt, method)(_t(A), _t(b), M=kt.DiagonalOperator(_t(d)),
                              ldiv=ldiv, history=True)
    _same(rt_, rj, histories=True)


@pytest.mark.parametrize("method", METHODS + ("cgls_lanczos_shift",))
def test_zero_rhs(method, FC):
    A, _ = fx.over_consistent(FC=FC)
    args = (SHIFTS,) if method == "cgls_lanczos_shift" else ()
    rt_, rj = _both(method, A, np.zeros(25, dtype=FC), *args)
    _same(rt_, rj)
    assert rt_[1].status == "x is a zero-residual solution"
    assert rt_[1].niter == 0 and not rt_[0].any()


@pytest.mark.parametrize("method", METHODS + ("cgls_lanczos_shift",))
def test_callback_itmax_timemax_and_verbose(method, capsys):
    """A callback stops the solve after iteration 4 and sees the active
    iterations only; itmax = 3 stops tired; a finite ``timemax`` stops
    after one chunk of 64; the verbose table prints the JAX package's
    rows."""
    A, b = _gen_lsq()
    args = (SHIFTS,) if method == "cgls_lanczos_shift" else ()
    rt_, rj = _both(method, A, b, *args, callback=lambda s: s.iter >= 4)
    _same(rt_, rj)
    assert rt_[1].status == "user-requested exit" and rt_[1].niter == 4
    seen = []
    _, st = getattr(kt, method)(_t(A), _t(b), *args,
                                callback=lambda s: seen.append(int(s.iter))
                                or False)
    assert seen == list(range(1, st.niter + 1))
    rt_, rj = _both(method, A, b, *args, itmax=3, atol=0.0, rtol=0.0)
    _same(rt_, rj)
    assert rt_[1].status == "maximum number of iterations exceeded"
    R = np.random.default_rng(0).standard_normal((100, 100))
    _, st = getattr(kt, method)(_t(R), torch.ones(100, dtype=torch.float64),
                                *args, atol=0.0, rtol=0.0, itmax=300,
                                timemax=1e-9)
    assert st.status == "time limit exceeded" and st.niter == 64
    capsys.readouterr()
    getattr(kj, method)(A, b, *args, verbose=3)
    want = capsys.readouterr().out
    getattr(kt, method)(_t(A), _t(b), *args, verbose=3)
    assert capsys.readouterr().out.splitlines() == want.splitlines()
    if method != "cgls_lanczos_shift":
        assert len(want.splitlines()) > 4


def test_double_word_and_bad_inputs_raise():
    """CGLS waits for the double-word port; CRLS takes no ``precision``
    (the JAX package's TypeError, for any value); CGLS-Lanczos-shift
    takes None and "working" and refuses the rest with a ValueError."""
    A, b = _gen_lsq()
    for method in METHODS + ("cgls_lanczos_shift",):
        args = (SHIFTS,) if method == "cgls_lanczos_shift" else ()
        if method == "cgls":
            raised = {"double_word": (NotImplementedError, "Queue 1 item 8"),
                      "compensated": (ValueError, "precision")}
        elif method == "crls":
            raised = {p: (TypeError, "precision")
                      for p in ("double_word", "compensated", "working",
                                None)}
            for p in raised:
                with pytest.raises(TypeError, match="precision"):
                    kj.crls(A, b, precision=p)
        else:
            raised = {p: (ValueError, "no double-word path")
                      for p in ("double_word", "compensated")}
            for p in (None, "working"):
                X, st = kt.cgls_lanczos_shift(_t(A), _t(b), SHIFTS,
                                              precision=p)
                assert st.solved and X.shape == (len(SHIFTS), A.shape[1])
        for p, (exc, msg) in raised.items():
            with pytest.raises(exc, match=msg):
                getattr(kt, method)(_t(A), _t(b), *args, precision=p)
        with pytest.raises(ValueError, match="Inconsistent problem size"):
            getattr(kt, method)(_t(A), _t(b[:10]), *args)
    with pytest.raises(TypeError):
        kt.cgls_lanczos_shift(_t(A), _t(b), SHIFTS,
                              M=kt.DiagonalOperator(_t(b)))


def test_csr_and_matrix_free_operators():
    """A CSR operator (its adjoint built on the host) and a matrix-free
    one give the dense operator's results, rectangular A included."""
    A, b = _gen_lsq()
    At = _t(A)
    csr = kt.csr_from_dense(At)
    fn = kt.FunctionOperator(lambda v: At @ v, A.shape, torch.float64,
                             rmatvec=lambda v: At.T @ v)
    for method in METHODS + ("cgls_lanczos_shift",):
        args = (SHIFTS,) if method == "cgls_lanczos_shift" else ()
        want, sw = getattr(kt, method)(At, _t(b), *args)
        for op in (csr, fn):
            got, sg = getattr(kt, method)(op, _t(b), *args)
            assert sg.niter == sw.niter
            assert _rel(got.numpy(), want.numpy()) <= 1e-12


def test_cgls_lanczos_shift_matches_jax_and_the_normal_equations(FC):
    """Every shift's x against the JAX package's and the dense solve of
    (AᴴA + λI)x = Aᴴb (tests/test_ls_family.py:112-120), with the
    per-shift histories."""
    A, b = _gen_lsq()
    A, b = A.astype(FC), b.astype(FC)
    shifts = [0.0, 0.5, 2.0]
    rt_, rj = _both("cgls_lanczos_shift", A, b, shifts, history=True)
    _same(rt_, rj, histories=True)
    X, st = rt_
    assert X.shape == (3, 10) and st.solved
    for i, lam in enumerate(shifts):
        xreg = np.linalg.solve(A.conj().T @ A + lam * np.eye(10),
                               A.conj().T @ b)
        assert np.allclose(X[i].numpy(), xreg, atol=1e-4)


# ---------------------------------------------------------------------------
# the kernel route and the plain versions
# ---------------------------------------------------------------------------

def _stencil(N=8, dtype=np.float64, seed=11):
    """convdiff_dia(N) in both packages, and b from ``seed``."""
    D = jconvdiff(N, N, N, dtype=dtype)
    A = dia_from_numpy(np.array(D.data), D.offsets, D.shape, device="cpu")
    b = np.random.default_rng(seed).standard_normal(D.shape[0]).astype(
        dtype)
    return D, A, b


ALL = METHODS + ("cgls_lanczos_shift",)


@pytest.fixture
def fused_calls(monkeypatch):
    """Counts the calls of the three kernels' plain versions."""
    calls = []
    for kernel in ALL:
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


@pytest.mark.parametrize("method", ALL)
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_fused_route_matches_jax(method, dtype, fused_calls):
    """The kernel route is taken exactly where the JAX gate admits it
    (krylov_tpu/solvers/cgls.py:159-183, 397-420, 596-621): no M, radius,
    history, callback, verbose or finite timemax; every excluded option
    runs the general core; b = 0 takes the kernel and stops at once."""
    D, A, b = _stencil(dtype=dtype)
    op = kt.DIAOperator(A, use_kernel=True)
    args = (SHIFTS,) if method == "cgls_lanczos_shift" else ()
    kw = {"atol": 0.0, "rtol": 1e-8 if dtype == np.float64 else 1e-5}
    xj, sj = getattr(kj, method)(JDIAOperator(D, use_pallas=True),
                                 jnp.asarray(b), *args, **kw)
    xt, st = getattr(kt, method)(op, _t(b), *args, **kw)
    assert (st.status, st.solved) == (sj.status, sj.solved)
    assert _band(st.niter, sj.niter, dtype)
    if dtype == np.float64:
        xj = np.asarray(xj)
        assert np.abs(xt.numpy() - xj).max() <= 1e-7 * (np.abs(xj).max() + 1)
    assert fused_calls == [method + "_dia_fused_ref"]
    fallbacks = [{"history": True}, {"timemax": 1e6},
                 {"callback": lambda s: False}, {"verbose": 100}]
    if method != "cgls_lanczos_shift":
        ones = kt.DiagonalOperator(torch.ones(b.shape[0], dtype=xt.dtype))
        fallbacks += [{"M": ones}, {"radius": 1e6}]
    for extra in fallbacks:
        _, st = getattr(kt, method)(op, _t(b), *args, **kw, **extra)
        assert st.solved
    assert len(fused_calls) == 1
    _, st = getattr(kt, method)(op, _t(np.zeros_like(b)), *args)
    assert len(fused_calls) == 2
    assert st.niter == 0 and st.status == "x is a zero-residual solution"


@pytest.mark.parametrize("method", METHODS)
def test_fused_route_lambda_and_fallbacks(method, fused_calls):
    """λ = 0.1 goes to the kernel, with the JAX package's results; a
    complex system and a CPU operator without the kernel never do."""
    D, A, b = _stencil()
    op = kt.DIAOperator(A, use_kernel=True)
    kw = {"lam": 0.1, "atol": 0.0, "rtol": 1e-8}
    xj, sj = getattr(kj, method)(JDIAOperator(D, use_pallas=True),
                                 jnp.asarray(b), **kw)
    xt, st = getattr(kt, method)(op, _t(b), **kw)
    assert st.status == sj.status and _band(st.niter, sj.niter, np.float64)
    xj = np.asarray(xj)
    assert np.abs(xt.numpy() - xj).max() <= 1e-7 * (np.abs(xj).max() + 1)
    assert len(fused_calls) == 1
    Ac = kt.DIAOperator(kt.convdiff_dia(4, dtype=torch.complex128,
                                        device="cpu"), use_kernel=True)
    assert getattr(kt, method)(Ac, torch.ones(64, dtype=torch.complex128),
                               lam=0.1)[1].solved
    assert getattr(kt, method)(kt.DIAOperator(A, use_kernel=False),
                               _t(b))[1].solved
    assert len(fused_calls) == 1


# kernel cases: (kernel, λ or the shifts)
CASES = {"cgls": ("cgls", 0.0), "cgls_lam": ("cgls", 0.1),
         "crls": ("crls", 0.0), "crls_lam": ("crls", 0.1),
         "shift": ("cgls_lanczos_shift", SHIFTS),
         "shift_zero": ("cgls_lanczos_shift", [0.0, 4.0])}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("stencil", ["b", "zero_b"])
def test_plain_version_matches_jax_kernel(case, stencil):
    """Each plain version against the JAX kernel in interpret mode at 8³
    f64, at the default tolerances (√eps), with λ = 0.1 and with b = 0, to
    the tolerances of the module docstring; also capped at 30 iterations,
    to 1e-10."""
    D, A, b = _stencil()
    if stencil == "zero_b":
        b = np.zeros_like(b)
    (pdj, pdaj, offaj), (pd, pda, ot, ota) = _adjoint_pair(D, A)
    name, lam = CASES[case]
    tol = float(np.sqrt(np.finfo(np.float64).eps))
    for itmax in (400, 30) if stencil == "b" else (400,):
        if name == "cgls_lanczos_shift":
            rt_ = tf.cgls_lanczos_shift_dia_fused_ref(
                pd, pda, ot, ota, _t(b), _t(lam), tol, tol, itmax)
            rj = jf.cgls_lanczos_shift_dia_fused(
                pdj, pdaj, D.offsets, offaj, jnp.asarray(b),
                jnp.asarray(lam), len(lam), tol, tol, itmax, interpret=True)
            it_t, code_t, it_j, code_j = (int(rt_[1]), int(rt_[3]),
                                          int(rj[1]), int(rj[3]))
            assert np.array_equal(rt_[4].numpy(), np.asarray(rj[4]))
        else:
            rt_ = getattr(tf, name + "_dia_fused_ref")(
                pd, pda, ot, ota, _t(b), lam, tol, tol, itmax)
            rj = getattr(jf, name + "_dia_fused")(
                pdj, pdaj, D.offsets, offaj, jnp.asarray(b), lam, tol, tol,
                itmax, interpret=True)
            it_t, code_t, it_j, code_j = (int(rt_[1]), int(rt_[4]),
                                          int(rj[1]), int(rj[4]))
        assert code_t == code_j
        err = _rel(rt_[0].numpy(), np.asarray(rj[0]))
        if itmax == 30:
            assert it_t == it_j == 30 and err <= TOL
            assert _rel(rt_[2].numpy(), np.asarray(rj[2])) <= TOL
        else:
            assert _band(it_t, it_j, np.float64) and err <= 1e-7
        if stencil == "zero_b":
            assert it_t == 0 and code_t == 2 and not rt_[0].any()


def test_kernel_shifts_must_be_a_vector_of_b():
    D, A, b = _stencil()
    (_, _, _), (pd, pda, ot, ota) = _adjoint_pair(D, A)
    wrong = torch.tensor([0.1], dtype=torch.float32)
    with pytest.raises(ValueError, match="shifts"):
        tf.cgls_lanczos_shift_dia_fused(pd, pda, ot, ota, _t(b), wrong, 1e-8,
                                        1e-8, 10)


# ---------------------------------------------------------------------------
# the interface, storage and the niter table
# ---------------------------------------------------------------------------

def test_krylov_solve_and_workspace():
    """The three methods through krylov_solve equal direct calls and the
    JAX package's; a CGLS workspace's accessors match the JAX package's
    (one A and one Aᴴ product per iteration), and these methods refuse a
    warm start."""
    A, b = _gen_lsq()
    for method in ALL:
        args = (SHIFTS,) if method == "cgls_lanczos_shift" else ()
        xs, st = kt.krylov_solve(method, _t(A), _t(b), *args)
        xd, sd = getattr(kt, method)(_t(A), _t(b), *args)
        xj, sj = kj.krylov_solve(method, A, b, *args)
        assert (st.status, st.niter) == (sd.status, sd.niter) \
            == (sj.status, sj.niter)
        assert torch.equal(xs, xd) and _rel(xs.numpy(), xj) <= TOL
    wj = kj.krylov_workspace("cgls", A, b)
    wt = kt.krylov_workspace("cgls", _t(A), _t(b))
    kj.krylov_solve_inplace(wj, A, b)
    kt.krylov_solve_inplace(wt, _t(A), _t(b))
    assert kt.iteration_count(wt) == kj.iteration_count(wj)
    assert kt.Aprod_count(wt) == kt.Atprod_count(wt) == kj.Atprod_count(wj)
    assert _rel(kt.solution(wt).numpy(), kj.solution(wj)) <= TOL
    assert kt.results(wt) == (kt.solution(wt), kt.statistics(wt))
    assert wt.rNorm is not None and "state storage" in repr(wt)
    assert isinstance(kt.CglsWorkspace(_t(A), _t(b)), kt.KrylovWorkspace)
    with pytest.raises(ValueError, match="does not support warm starts"):
        kt.warm_start(wt, kt.solution(wt))
    for p in ("double_word", "working"):
        wj = kj.krylov_workspace("crls", precision=p)
        with pytest.raises(TypeError, match="precision"):
            kj.krylov_solve_inplace(wj, A, b)
        ws = kt.krylov_workspace("crls", precision=p)
        with pytest.raises(TypeError, match="precision"):
            kt.krylov_solve_inplace(ws, _t(A), _t(b))
    ws = kt.krylov_workspace("cgls_lanczos_shift", precision="double_word")
    with pytest.raises(ValueError, match="no double-word path"):
        kt.krylov_solve_inplace(ws, _t(A), _t(b), SHIFTS)


# element budgets of the large tensors (size ≥ n) of each state, copied
# from tests/test_storage.py:64-66 (m = 14 rows, n = 10 columns, two
# shifts)
N_, M_, NSH = 10, 14, 2
BUDGETS = {"cgls": 3 * N_ + 2 * M_, "crls": 4 * N_ + 3 * M_,
           "cgls_lanczos_shift": (3 + NSH) * N_ + 2 * M_ + 5 * NSH}


def _tall(m=M_, n=N_):
    """The tall fixture of tests/fixtures.py:drive_method and its b."""
    A = np.zeros((m, n))
    for i in range(m):
        if i < n:
            A[i, i] = 2.0 + 0.05 * i
        if 0 <= i - 1 < n:
            A[i, i - 1] = 0.5
    b = A @ np.ones(n) + 0.01 * np.concatenate([np.zeros(n),
                                                np.ones(m - n)])
    return A, b


@pytest.mark.parametrize("method", ALL)
def test_state_within_storage_budget(method):
    A, b = _tall()
    solve, _ = tws._resolve(method)
    args = ([0.0, 0.1],) if method == "cgls_lanczos_shift" else ()
    _, stats, state = solve(_t(A), _t(b), *args)
    assert state is not None and stats.niter > 0
    big = sum(t.numel() for _, t in tws.state_tensors(state)
              if t.numel() >= N_)
    assert big <= BUDGETS[method], (method, big)


def _slack(ref):
    return max(2, int(round(0.10 * ref)))


@pytest.mark.parametrize("method", ALL)
def test_niter_within_the_reference_band(method):
    """niter on the fixtures of tests/reference_niter.json (the tall
    14 × 10 system of ``small_fixtures``, and ``gen_lsq(25, 10)`` with
    λ = 0.1) within ±max(2, 10%) of the recorded f64 counts, with the
    recorded status."""
    A, b = _tall()
    if method == "cgls_lanczos_shift":
        _, st = kt.cgls_lanczos_shift(_t(A), _t(b), [0.0, 0.1])
    else:
        _, st = kt.krylov_solve(method, _t(A), _t(b))
    ref = NITER["small_fixtures"][method]
    assert st.status == ref["status"]
    assert abs(st.niter - ref["niter"]) <= _slack(ref["niter"])
    if method in NITER["gen_lsq_25x10_lam0.1"]:
        A, b = _gen_lsq()
        _, st = kt.krylov_solve(method, _t(A), _t(b), lam=0.1)
        ref = NITER["gen_lsq_25x10_lam0.1"][method]
        assert st.status == ref["status"]
        assert abs(st.niter - ref["niter"]) <= _slack(ref["niter"])
