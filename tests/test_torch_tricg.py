"""krylov_tpu_torch.tricg against krylov_tpu's, on both routes (the cases
of tests/test_twosided.py:189-269 and tests/test_fused.py:1121-1175), and
the plain version of its whole-solve kernel against krylov_tpu's
``tricg_dia_fused`` in interpret mode.

Inputs are made with numpy from a seed (or the fixture generators) and
given to both packages.  Tolerances: on the fixtures, in f64 and c128,
the status string, niter, ``solved`` and ``inconsistent`` are equal and x,
y and the histories agree to 1e-10 relative (the reductions are summed in
another order).  Two kinds of case are held to less, and say why where
they are tested: a breakdown (code 28), where x and y carry the rounding
of pivots near 0, and an exact tie, where a pivot is 0 in exact
arithmetic and rounding alone decides between "solved" and the
breakdown (tests/fixtures.py:ssy_mo_breakdown with the spd preset: the
port's products give a pivot of exactly 0, the JAX package's 1e-16).

The kernel route runs on the 3-D Poisson stencil, 512 unknowns, with a
seeded c (the JAX package's cell, tests/test_fused.py:1121-1157).  The
saddle recurrences amplify the rounding of the sums over 100 and more
iterations, and the stop can move by 1 to 3 iterations near the
threshold, so there, as the JAX package's own test does, a run capped at
40 iterations holds x and y to 1e-10 of max|v| + 1 (measured: 1.5e-13 at
most), and a converged f64 run holds the status, niter within 3 and x
and y within 1e-7 relative (measured against the JAX kernel: niter 2
apart, 128 against 130, and 1.6e-8 at most).  In f32 the
status is equal and niter within ±max(2, 10%) (the band of
tests/reference_niter.json).
"""

import json
import pathlib

import numpy as np
import scipy.sparse as sp
import jax.numpy as jnp
import pytest
torch = pytest.importorskip("torch")

import fixtures as fx
import krylov_tpu as kj
import krylov_tpu.ops.pallas_fused as jf
import krylov_tpu_torch as kt
from krylov_tpu.operators import DIAOperator as JDIAOperator
from krylov_tpu.ops.dia import DIAMatrix as JDIAMatrix
from krylov_tpu.ops.dia import poisson_dia as jpoisson
from krylov_tpu_torch import workspaces as tws
from krylov_tpu_torch.convert import dia_from_numpy
from krylov_tpu_torch.ops import cuda_fused as tf
from test_torch_bilq import _adjoint_pair
from test_torch_gmres import _rel

TOL = 1e-10
NITER = json.loads((pathlib.Path(__file__).parent
                    / "reference_niter.json").read_text())
# the (τ, ν) of each preset (krylov_tpu/solvers/tricg.py:32-41)
PRESETS = {"default": ({}, 1.0, -1.0), "spd": ({"spd": True}, 1.0, 1.0),
           "snd": ({"snd": True}, -1.0, -1.0),
           "flip": ({"flip": True}, -1.0, 1.0),
           "sp": ({"sp": True}, 1.0, 0.0),
           "tau_nu": ({"tau": 0.5, "nu": -2.0}, 0.5, -2.0)}


@pytest.fixture(params=[np.float64, np.complex128], ids=["f64", "c128"])
def FC(request):
    return request.param


def _t(v):
    return None if v is None else torch.as_tensor(np.asarray(v))


def _both(A, b, c, *args, **kw):
    """(port's (x, y, stats), JAX's (x, y, stats)) of one call."""
    rj = kj.tricg(A, b, c, *args, **kw)
    rt_ = kt.tricg(_t(A), _t(b), _t(c), *map(_t, args), **kw)
    return rt_, rj


def _same(rt_, rj, tol=TOL, histories=False, values=True):
    """Status, niter and the flags equal; x, y (and the history) to
    ``tol`` relative."""
    *vt, st = rt_
    *vj, sj = rj
    assert type(st) is kt.SimpleStats
    assert (st.status, st.niter, st.solved, st.inconsistent) == (
        sj.status, sj.niter, sj.solved, sj.inconsistent)
    if values:
        for a, w in zip(vt, vj):
            assert _rel(a.numpy(), np.asarray(w)) <= tol
    if histories:
        want = np.asarray(sj.residuals)
        assert st.residuals.shape == want.shape
        assert _rel(st.residuals, want) <= tol


def _block_residual(A, b, c, x, y, tau, nu):
    """‖[b; c] − [τI A; Aᴴ νI][x; y]‖."""
    top = b - (tau * x + A @ y)
    bot = c - (A.conj().T @ x + nu * y)
    return np.sqrt(np.linalg.norm(top) ** 2 + np.linalg.norm(bot) ** 2)


# ---------------------------------------------------------------------------
# the general core against the JAX package
# ---------------------------------------------------------------------------

def _random(shape=(40, 30), FC=np.float64):
    """A seeded normal m × n matrix scaled to ‖A‖ = 0.5, b and c: every
    preset's system is then definite or quasi-definite and well
    conditioned, and TriCG stops after 12 to 14 iterations, before the
    finite termination of the tridiagonalisation (tests/fixtures.py:
    drive_method scales its saddle fixture for the same reason)."""
    rng = np.random.default_rng(5)
    G = rng.standard_normal(shape)
    if FC == np.complex128:
        G = G + 1j * rng.standard_normal(shape)
    A = 0.5 * G / np.linalg.norm(G, 2)
    return (A, rng.standard_normal(shape[0]).astype(FC),
            rng.standard_normal(shape[1]).astype(FC))


@pytest.mark.parametrize("preset", sorted(set(PRESETS) - {"sp"}))
@pytest.mark.parametrize("shape", [(40, 30), (30, 40)], ids=["tall", "wide"])
def test_presets(preset, shape, FC):
    """Each preset and an explicit (τ, ν) on a rectangular system, with the
    history: x has A's rows, y its columns, and the block residual is
    small."""
    A, b, c = _random(shape, FC)
    kw, tau, nu = PRESETS[preset]
    rt_, rj = _both(A, b, c, history=True, **kw)
    _same(rt_, rj, histories=True)
    x, y, st = rt_
    assert st.solved
    assert x.shape == (shape[0],) and y.shape == (shape[1],)
    assert _block_residual(A, b, c, x.numpy(), y.numpy(), tau, nu) \
        <= 1e-6 * np.linalg.norm(np.concatenate([b, c]))


@pytest.mark.parametrize("preset", ["default", "spd", "sp"])
def test_sqd_fixture(preset, FC):
    """The SQD fixture of the JAX package's tests (tests/test_twosided.py:
    189-199, 261-269), 5 × 5, which TriCG solves at the finite termination
    of the tridiagonalisation: from the fifth iteration on the residual
    estimates are the rounding of β and γ, so the history is held to
    1e-10 before it (measured with sp, which takes a sixth iteration:
    6.0e-7 against 6.3e-7 of 3.2 at the fifth); x and y to 1e-10
    (measured: 3.1e-12 at most, sp, whose ν = 0 TriCG factorises without
    pivoting)."""
    A, b, _, _ = fx.sqd(FC=FC)
    c = -b.copy()
    kw, tau, nu = PRESETS[preset]
    rt_, rj = _both(A, b, c, history=True, **kw)
    _same(rt_, rj)
    want = np.asarray(rj[2].residuals)
    assert rt_[2].residuals.shape == want.shape
    assert _rel(rt_[2].residuals[:5], want[:5]) <= TOL
    x, y, st = rt_
    assert st.solved
    if preset != "sp":
        assert _block_residual(A, b, c, x.numpy(), y.numpy(), tau, nu) \
            <= 1e-6 * np.linalg.norm(np.concatenate([b, c]))


@pytest.mark.parametrize("transpose", [False, True])
def test_small_rectangular(transpose, FC):
    """A 3 × 2 and a 2 × 3 system (tests/fixtures.py:small_sqd)."""
    A, b, c, _, _ = fx.small_sqd(transpose=transpose, FC=FC)
    rt_, rj = _both(A, b, c, history=True)
    _same(rt_, rj, histories=True)
    assert rt_[0].shape == (A.shape[0],) and rt_[1].shape == (A.shape[1],)


@pytest.mark.parametrize("ldiv", [False, True])
def test_preconditioners(ldiv, FC):
    """M and N as diagonal operators, applied or divided by."""
    A, b, c = _random(FC=FC)
    rng = np.random.default_rng(3)
    dm, dn = 1.0 + rng.random(40), 1.0 + rng.random(30)
    rj = kj.tricg(A, b, c, M=kj.DiagonalOperator(dm),
                  N=kj.DiagonalOperator(dn), ldiv=ldiv, history=True)
    rt_ = kt.tricg(_t(A), _t(b), _t(c), M=kt.DiagonalOperator(_t(dm)),
                   N=kt.DiagonalOperator(_t(dn)), ldiv=ldiv, history=True)
    _same(rt_, rj, histories=True)


def test_warm_start(FC):
    """A warm start (x0, y0) near the solution: the JAX package's result,
    x0 and y0 added back, and the block residual small; x0 without y0
    is refused."""
    A, b, _, _ = fx.sqd(FC=FC)
    c = -b.copy()
    x, y, _ = kt.tricg(_t(A), _t(b), _t(c))
    rng = np.random.default_rng(11)
    x0 = x.numpy() + 1e-3 * rng.standard_normal(5)
    y0 = y.numpy() + 1e-3 * rng.standard_normal(5)
    rt_, rj = _both(A, b, c, x0, y0, history=True)
    _same(rt_, rj, histories=True)
    assert _block_residual(A, b, c, rt_[0].numpy(), rt_[1].numpy(), 1.0,
                           -1.0) <= 1e-6 * np.linalg.norm(b)
    with pytest.raises(ValueError, match="x0 and y0"):
        kt.tricg(_t(A), _t(b), _t(c), _t(x0))


def test_zero_rhs(FC):
    A, b, _, _ = fx.sqd(FC=FC)
    z = np.zeros_like(b)
    rt_, rj = _both(A, z, z)
    _same(rt_, rj)
    assert rt_[2].status == "x is a zero-residual solution"
    assert rt_[2].niter == 0 and not rt_[0].any() and not rt_[1].any()


def _near_identity():
    """[I A; Aᴴ I] with A = I + 1e-12 R, b = e₁, c = e₂: after a few
    iterations both SSY norms are below eps^¾ and not 0."""
    A = np.eye(4) + 1e-12 * np.random.default_rng(0).standard_normal((4, 4))
    b, c = np.eye(4)[0].copy(), np.eye(4)[1].copy()
    return A, b, c


def test_breakdown_and_the_exact_tie():
    """Code 28, "inconsistent linear system", where both SSY norms fall
    to 1e-16 with a residual estimate that is not small: status, niter and
    the flags equal (x and y follow the rounding of pivots near 1e-12, so
    they are not compared).  And the exact tie of the module docstring,
    held to what each package's own rounding gives."""
    A, b, c = _near_identity()
    rt_, rj = _both(A, b, c, spd=True)
    _same(rt_, rj, values=False)
    assert rt_[2].status == "inconsistent linear system"
    assert rt_[2].inconsistent and not rt_[2].solved
    A, b, c = fx.ssy_mo_breakdown()
    _same(*_both(A, b, c))
    *_, st = kt.tricg(_t(A), _t(b), _t(c), spd=True)
    assert st.status == "solution good enough given atol and rtol"
    assert st.niter == 2


def test_callback_itmax_timemax_and_verbose(capsys):
    """A callback stops the solve after iteration 2 and sees the active
    iterations only; itmax = 2 stops tired; a finite ``timemax`` stops
    after one chunk of 64; the verbose table prints the JAX package's
    rows."""
    A, b, c = _random()
    rt_, rj = _both(A, b, c, callback=lambda s: s.iter >= 2)
    _same(rt_, rj)
    assert rt_[2].status == "user-requested exit" and rt_[2].niter == 2
    seen = []
    *_, st = kt.tricg(_t(A), _t(b), _t(c),
                      callback=lambda s: seen.append(int(s.iter)) or False)
    assert seen == list(range(1, st.niter + 1))
    rt_, rj = _both(A, b, c, itmax=2, atol=0.0, rtol=0.0)
    _same(rt_, rj)
    assert rt_[2].status == "maximum number of iterations exceeded"
    R = np.random.default_rng(0).standard_normal((100, 100))
    v = torch.ones(100, dtype=torch.float64)
    *_, st = kt.tricg(_t(R), v, v, atol=0.0, rtol=0.0, itmax=300,
                      timemax=1e-9)
    assert st.status == "time limit exceeded" and st.niter == 64
    capsys.readouterr()
    kj.tricg(A, b, c, verbose=1)
    want = capsys.readouterr().out
    kt.tricg(_t(A), _t(b), _t(c), verbose=1)
    got = capsys.readouterr().out
    assert got.splitlines() == want.splitlines() and len(got.splitlines()) > 4


def test_double_word_and_bad_inputs_raise():
    A, b, _, _ = fx.sqd()
    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
        kt.tricg(_t(A), _t(b), _t(b), precision="double_word")
    with pytest.raises(ValueError, match="precision"):
        kt.tricg(_t(A), _t(b), _t(b), precision="compensated")
    with pytest.raises(ValueError, match="Inconsistent problem size"):
        kt.tricg(_t(A), _t(b), _t(b[:3]))
    B = np.stack([b, np.ones(len(b))], axis=1)
    X, sb = kt.krylov_solve("block_gmres", _t(A @ A.T + np.eye(len(b))),
                            _t(B))
    Xd, sd = kt.block_gmres(_t(A @ A.T + np.eye(len(b))), _t(B))
    assert (sb.status, sb.niter) == (sd.status, sd.niter)
    assert torch.equal(X, Xd)


def test_csr_and_matrix_free_operators():
    """A CSR operator (its adjoint built on the host) and a matrix-free
    one give the dense operator's results, rectangular A included."""
    A, b, c, _, _ = fx.small_sqd()
    for A_, b_, c_ in ((A, b, c), fx.sqd()[:2] + (-fx.sqd()[1],)):
        At = _t(A_)
        want = kt.tricg(At, _t(b_), _t(c_))
        for op in (kt.csr_from_dense(At),
                   kt.FunctionOperator(lambda v, At=At: At @ v, A_.shape,
                                       torch.float64,
                                       rmatvec=lambda v, At=At: At.T @ v)):
            got = kt.tricg(op, _t(b_), _t(c_))
            assert got[2].niter == want[2].niter
            for g, w in zip(got[:2], want[:2]):
                assert _rel(g.numpy(), w.numpy()) <= TOL


# ---------------------------------------------------------------------------
# the kernel route and the plain version
# ---------------------------------------------------------------------------

def _stencil(N=8, dtype=np.float64):
    """poisson_dia(N) in both packages, b as tests/test_fused.py:19-25
    draws it and c from seed 11."""
    D = jpoisson(N, N, N, dtype=dtype)
    A = dia_from_numpy(np.array(D.data), D.offsets, D.shape, device="cpu")
    n = D.shape[0]
    b = np.random.default_rng(7).standard_normal(n).astype(dtype)
    c = np.random.default_rng(11).standard_normal(n).astype(dtype)
    return D, A, b, c


@pytest.fixture
def fused_calls(monkeypatch):
    """Counts the calls of the kernel's plain version."""
    calls = []
    ref = tf.tricg_dia_fused_ref

    def counted(*a, **k):
        calls.append(a[6:8])
        return ref(*a, **k)

    monkeypatch.setattr(tf, "tricg_dia_fused_ref", counted)
    return calls


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_fused_route_matches_jax(dtype, fused_calls):
    """The kernel route is taken exactly where the JAX gate admits it
    (krylov_tpu/solvers/tricg.py:275-298), with the preset's τ and ν: no
    M, N, x0, y0, history, callback, verbose or finite timemax; every
    excluded option runs the general core; b = c = 0 takes the kernel
    and stops at once."""
    D, A, b, c = _stencil(dtype=dtype)
    op = kt.DIAOperator(A, use_kernel=True)
    jop = JDIAOperator(D, use_pallas=True)
    kw = {"atol": 0.0, "rtol": 1e-8 if dtype == np.float64 else 1e-5}
    for preset in ("default", "spd", "flip"):
        pkw, tau, nu = PRESETS[preset]
        xj, yj, sj = kj.tricg(jop, jnp.asarray(b), jnp.asarray(c), **kw,
                              **pkw)
        xt, yt, st = kt.tricg(op, _t(b), _t(c), **kw, **pkw)
        assert (st.status, st.solved) == (sj.status, sj.solved)
        if dtype == np.float64:
            assert abs(st.niter - sj.niter) <= 3
            for v, w in ((xt, xj), (yt, yj)):
                assert _rel(v.numpy(), np.asarray(w)) <= 1e-7
        else:
            assert abs(st.niter - sj.niter) <= max(2, 0.1 * sj.niter)
        assert fused_calls[-1] == (tau, nu)
    assert len(fused_calls) == 3
    ones = kt.DiagonalOperator(torch.ones(b.shape[0], dtype=xt.dtype))
    half = 0.5 * xt
    for args, extra in (((), {"history": True}), ((), {"timemax": 1e6}),
                        ((), {"callback": lambda s: False}),
                        ((), {"verbose": 100}), ((), {"M": ones}),
                        ((), {"N": ones}), ((half, 0.5 * yt), {})):
        *_, st = kt.tricg(op, _t(b), _t(c), *args, **kw, **extra)
        assert st.solved
    assert len(fused_calls) == 3
    z = np.zeros_like(b)
    *_, st = kt.tricg(op, _t(z), _t(z))
    assert len(fused_calls) == 4
    assert st.niter == 0 and st.status == "x is a zero-residual solution"
    Ac = kt.DIAOperator(kt.poisson_dia(4, dtype=torch.complex128,
                                       device="cpu"), use_kernel=True)
    v = torch.ones(64, dtype=torch.complex128)
    assert kt.tricg(Ac, v, v)[-1].solved
    assert len(fused_calls) == 4


@pytest.mark.parametrize("preset", ["default", "spd", "flip"])
def test_fixed_cap_trajectory(preset):
    """40 iterations with atol = 0 and rtol = 1e-30 (tests/test_fused.py:
    1121-1141): the port's kernel route (its plain version on the CPU),
    its general core and the JAX package's general core agree to 1e-10
    of max|v| + 1."""
    D, A, b, c = _stencil()
    pkw = PRESETS[preset][0]
    kw = dict(atol=0.0, rtol=1e-30, itmax=40, **pkw)
    xk, yk, sk = kt.tricg(kt.DIAOperator(A, use_kernel=True), _t(b), _t(c),
                          **kw)
    xg, yg, sg = kt.tricg(kt.DIAOperator(A), _t(b), _t(c), **kw)
    xj, yj, sj = kj.tricg(JDIAOperator(D, use_pallas=False), jnp.asarray(b),
                          jnp.asarray(c), **kw)
    assert sk.niter == sg.niter == sj.niter == 40
    for pair in ((xk, xj), (xg, xj), (yk, yj), (yg, yj)):
        v, w = pair[0].numpy(), np.asarray(pair[1])
        assert np.abs(v - w).max() <= TOL * (np.abs(w).max() + 1)


def _dia_of(A):
    """A dense matrix as a DIA matrix in both packages."""
    S = sp.dia_matrix(A)
    offsets = tuple(int(o) for o in S.offsets)
    return (JDIAMatrix(jnp.asarray(S.data), offsets, A.shape),
            dia_from_numpy(S.data, offsets, A.shape, device="cpu"))


@pytest.mark.parametrize("preset", ["default", "spd", "flip"])
@pytest.mark.parametrize("rhs", ["b", "zero_b"])
def test_plain_version_matches_jax_kernel(preset, rhs):
    """The plain version against the JAX kernel in interpret mode at 8³
    f64, at the default tolerances (√eps), to the tolerances of the module
    docstring; capped at 40 iterations, to 1e-10; b = c = 0 stops at once
    with code 2."""
    D, A, b, c = _stencil()
    if rhs == "zero_b":
        b, c = np.zeros_like(b), np.zeros_like(c)
    (pdj, pdaj, offaj), (pd, pda, ot, ota) = _adjoint_pair(D, A)
    _, tau, nu = PRESETS[preset]
    tol = float(np.sqrt(np.finfo(np.float64).eps))
    for itmax in (400, 40) if rhs == "b" else (400,):
        args = (tau, nu, tol, tol, itmax)
        rt_ = tf.tricg_dia_fused_ref(pd, pda, ot, ota, _t(b), _t(c), *args)
        rj = jf.tricg_dia_fused(pdj, pdaj, D.offsets, offaj, jnp.asarray(b),
                                jnp.asarray(c), *args, interpret=True)
        assert int(rt_[4]) == int(rj[4])
        for v, w in zip(rt_[:2], rj[:2]):
            w = np.asarray(w)
            if itmax == 40:
                assert np.abs(v.numpy() - w).max() <= TOL * (
                    np.abs(w).max() + 1)
            else:
                assert _rel(v.numpy(), w) <= 1e-7
        assert (int(rt_[2]) == int(rj[2]) == 40 if itmax == 40
                else abs(int(rt_[2]) - int(rj[2])) <= 3)
        if rhs == "zero_b":
            assert int(rt_[2]) == 0 and int(rt_[4]) == 2
            assert not rt_[0].any() and not rt_[1].any()
    tol = float(np.sqrt(np.finfo(np.float64).eps))
    Dn, An = _dia_of(_near_identity()[0])
    _, bn, cn = _near_identity()
    (pdj, pdaj, offaj), (pd, pda, ot, ota) = _adjoint_pair(Dn, An)
    rt_ = tf.tricg_dia_fused_ref(pd, pda, ot, ota, _t(bn), _t(cn), 1.0, 1.0,
                                 tol, tol, 8)
    rj = jf.tricg_dia_fused(pdj, pdaj, Dn.offsets, offaj, jnp.asarray(bn),
                            jnp.asarray(cn), 1.0, 1.0, tol, tol, 8,
                            interpret=True)
    assert (int(rt_[2]), int(rt_[4])) == (int(rj[2]), int(rj[4])) \
        == (4, tf.INCONS_TRI)


# ---------------------------------------------------------------------------
# the interface, storage and the niter table
# ---------------------------------------------------------------------------

def test_krylov_solve_and_workspace():
    """krylov_solve equals a direct call and the JAX package's; a TriCG
    workspace's accessors match the JAX package's (two solutions, one A
    and one Aᴴ product per iteration) and it takes a warm start."""
    A, b, _, _ = fx.sqd()
    c = -b.copy()
    *vs, st = kt.krylov_solve("tricg", _t(A), _t(b), _t(c))
    *vd, sd = kt.tricg(_t(A), _t(b), _t(c))
    *vj, sj = kj.krylov_solve("tricg", A, b, c)
    assert (st.status, st.niter) == (sd.status, sd.niter) == (sj.status,
                                                              sj.niter)
    for v, d, j in zip(vs, vd, vj):
        assert torch.equal(v, d) and _rel(v.numpy(), j) <= TOL
    wj = kj.krylov_workspace("tricg", A, b)
    wt = kt.krylov_workspace("tricg", _t(A), _t(b))
    kj.krylov_solve_inplace(wj, A, b, c)
    kt.krylov_solve_inplace(wt, _t(A), _t(b), _t(c))
    assert kt.iteration_count(wt) == kj.iteration_count(wj)
    assert kt.Aprod_count(wt) == kt.Atprod_count(wt) == kj.Atprod_count(wj)
    x, y = kt.solution(wt)
    for v, j in zip((x, y), kj.solution(wj)):
        assert _rel(v.numpy(), j) <= TOL
    assert isinstance(kt.TricgWorkspace(_t(A), _t(b)), kt.KrylovWorkspace)
    kj.warm_start(wj, 0.5 * np.asarray(x), 0.5 * np.asarray(y))
    kt.warm_start(wt, 0.5 * x, 0.5 * y)
    kj.krylov_solve_inplace(wj, A, b, c)
    kt.krylov_solve_inplace(wt, _t(A), _t(b), _t(c))
    assert kt.iteration_count(wt) == kj.iteration_count(wj)
    for v, j in zip(kt.solution(wt), kj.solution(wj)):
        assert _rel(v.numpy(), j) <= TOL
    assert wt._x0 is None and wt._y0 is None
    assert wt.rNorm is not None and "state storage" in repr(wt)


def _rect_pair(m=14, n=10):
    """The saddle fixture of tests/fixtures.py:drive_method for TriCG:
    0.3 times the tall m × n matrix, b and c from seed 42."""
    A = np.zeros((m, n))
    for i in range(m):
        if i < n:
            A[i, i] = 2.0 + 0.05 * i
        if 0 <= i - 1 < n:
            A[i, i - 1] = 0.5
    rng = np.random.default_rng(42)
    b = rng.standard_normal(m)
    c = rng.standard_normal(n)
    return 0.3 * A, b, c


def test_state_within_storage_budget():
    """The state's large tensors (size ≥ n) within tests/test_storage.py:77's
    budget, 6n + 6m, on the 14 × 10 system."""
    A, b, c = _rect_pair()
    solve, _ = tws._resolve("tricg")
    *_, stats, state = solve(_t(A), _t(b), _t(c))
    assert state is not None and stats.niter > 0
    big = sum(t.numel() for _, t in tws.state_tensors(state)
              if t.numel() >= 10)
    assert big <= 6 * 10 + 6 * 14


def test_niter_within_the_reference_band():
    """niter on the saddle fixture of tests/reference_niter.json's
    ``small_fixtures`` within ±max(2, 10%) of the recorded f64 count,
    with the recorded status, and the block residual of
    [I A; Aᴴ −I] small."""
    A, b, c = _rect_pair()
    x, y, st = kt.tricg(_t(A), _t(b), _t(c))
    ref = NITER["small_fixtures"]["tricg"]
    assert st.status == ref["status"]
    assert abs(st.niter - ref["niter"]) <= max(2, round(0.1 * ref["niter"]))
    assert _block_residual(A, b, c, x.numpy(), y.numpy(), 1.0, -1.0) \
        <= 1e-6 * np.linalg.norm(b)
