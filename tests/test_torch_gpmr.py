"""krylov_tpu_torch.gpmr against krylov_tpu's, on both routes (the cases
of tests/test_twosided.py:271-295 and tests/test_fused.py:1495-1545), and
the plain version of its whole-solve kernel against krylov_tpu's
``gpmr_dia_fused`` in interpret mode.

Inputs are made with numpy from a seed (or the fixture generators) and
given to both packages.  Tolerances: on the fixtures, in f64 and c128,
the status string, niter, ``solved`` and ``inconsistent`` are equal and x,
y and the histories agree to 1e-10 relative (the dots are summed in
another order; measured: 2.5e-13 at most).

The kernel route runs on the 3-D convection-diffusion stencil, 512
unknowns, with B the DIA matrix whose data are A's aligned adjoint
diagonals in both packages (the JAX package's cell, tests/test_fused.py:
1495-1526): the plain version against the JAX kernel converged (niter
within 1, x and y within 1e-7 relative, the JAX package's own bands) and
capped at 12 iterations (x and y within 1e-10 of max|v| + 1; measured:
7e-16).  In f32 the status is equal and niter within ±max(2, 10%) (the
band of tests/reference_niter.json).  B built by ``adjoint_dia()`` is the
true transpose: the stacked residual of [I K; Kᴴ −I] is then at most
rtol (the watch list's GPMR converged on a B that was not).
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
from krylov_tpu.ops.dia import DIAMatrix as JDIAMatrix
from krylov_tpu.ops.dia import convdiff_dia as jconvdiff
from krylov_tpu.ops.dia import poisson_dia as jpoisson
from krylov_tpu_torch import workspaces as tws
from krylov_tpu_torch.convert import dia_from_numpy
from krylov_tpu_torch.ops import cuda_fused as tf
from krylov_tpu_torch.ops.cuda_dia import dia_align, offsets_tensor
from test_torch_gmres import _rel
from test_torch_tricg import _rect_pair, _t

TOL = 1e-10
NITER = json.loads((pathlib.Path(__file__).parent
                    / "reference_niter.json").read_text())


@pytest.fixture(params=[np.float64, np.complex128], ids=["f64", "c128"])
def FC(request):
    return request.param


def _both(A, B, b, c, *args, **kw):
    """(port's (x, y, stats), JAX's (x, y, stats)) of one call."""
    rj = kj.gpmr(A, B, b, c, *args, **kw)
    rt_ = kt.gpmr(_t(A), _t(B), _t(b), _t(c), *map(_t, args), **kw)
    return rt_, rj


def _same(rt_, rj, tol=TOL, histories=False):
    """Status, niter and the flags equal; x, y (and the history) to
    ``tol`` relative."""
    *vt, st = rt_
    *vj, sj = rj
    assert type(st) is kt.SimpleStats
    assert (st.status, st.niter, st.solved, st.inconsistent) == (
        sj.status, sj.niter, sj.solved, sj.inconsistent)
    for a, w in zip(vt, vj):
        assert _rel(a.numpy(), np.asarray(w)) <= tol
    if histories:
        want = np.asarray(sj.residuals)
        assert st.residuals.shape == want.shape
        assert _rel(st.residuals, want) <= tol


def _stacked_residual(A, B, b, c, x, y, lam, mu):
    """‖[b; c] − [λI A; B μI][x; y]‖."""
    top = b - (lam * x + A @ y)
    bot = c - (B @ x + mu * y)
    return np.sqrt(np.linalg.norm(top) ** 2 + np.linalg.norm(bot) ** 2)


def _random(FC=np.float64):
    """The 20 × 15 system of tests/test_twosided.py:282-287, seed 1."""
    rng = np.random.default_rng(1)
    A = rng.standard_normal((20, 15))
    B = rng.standard_normal((15, 20))
    b = rng.standard_normal(20)
    c = rng.standard_normal(15)
    if FC == np.complex128:
        A = A + 1j * rng.standard_normal((20, 15))
        B = B + 1j * rng.standard_normal((15, 20))
    return A.astype(FC), B.astype(FC), b.astype(FC), c.astype(FC)


# ---------------------------------------------------------------------------
# the general core against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("transpose", [False, True])
def test_gsp_fixture(transpose, FC):
    """The GSP fixture of tests/test_twosided.py:271-279 (and its
    transpose), with the history: the JAX package's result and a small
    stacked residual of [I A; B I]."""
    A, B, b, c, _, _ = fx.gsp(transpose=transpose, FC=FC)
    rt_, rj = _both(A, B, b, c, history=True)
    _same(rt_, rj, histories=True)
    x, y, st = rt_
    assert st.solved
    assert _stacked_residual(A, B, b, c, x.numpy(), y.numpy(), 1.0, 1.0) \
        <= 1e-8


@pytest.mark.parametrize("kw", [{}, {"lam": 3.0, "mu": 2.0},
                                {"gsp": True}, {"lam": 1.0, "mu": -1.0},
                                {"memory": 5}, {"itmax": 10},
                                {"reorthogonalization": True}],
                         ids=["default", "lam_mu", "gsp", "saddle", "memory",
                              "itmax", "reorth"])
def test_options(kw, FC):
    """λ and μ, the gsp preset (whose back substitution meets a pivot
    below eps^¾ and sets ``inconsistent`` with the solve solved), a
    ``memory`` that does not size the basis (gpmr.py:366), itmax and the
    second Gram–Schmidt pass on the 20 × 15 system: the JAX package's
    result, with the history."""
    A, B, b, c = _random(FC)
    rt_, rj = _both(A, B, b, c, history=True, **kw)
    _same(rt_, rj, histories=True)
    if kw == {"gsp": True} and FC == np.float64:
        assert rt_[2].inconsistent and rt_[2].solved
    if kw == {"lam": 3.0, "mu": 2.0}:
        assert _stacked_residual(A, B, b, c, rt_[0].numpy(), rt_[1].numpy(),
                                 3.0, 2.0) <= 1e-8


@pytest.mark.parametrize("ldiv", [False, True])
def test_preconditioners(ldiv, FC):
    """C, D, E and F as diagonal operators, applied or divided by."""
    A, B, b, c = _random(FC)
    rng = np.random.default_rng(3)
    d = [1.0 + rng.random(k) for k in (20, 15, 20, 15)]
    rj = kj.gpmr(A, B, b, c, C=kj.DiagonalOperator(d[0]),
                 D=kj.DiagonalOperator(d[1]), E=kj.DiagonalOperator(d[2]),
                 F=kj.DiagonalOperator(d[3]), ldiv=ldiv, history=True)
    rt_ = kt.gpmr(_t(A), _t(B), _t(b), _t(c),
                  C=kt.DiagonalOperator(_t(d[0])),
                  D=kt.DiagonalOperator(_t(d[1])),
                  E=kt.DiagonalOperator(_t(d[2])),
                  F=kt.DiagonalOperator(_t(d[3])), ldiv=ldiv, history=True)
    _same(rt_, rj, histories=True)


def test_warm_start(FC):
    """A warm start (x0, y0) near the solution: the JAX package's result,
    x0 and y0 added back; x0 without y0 is refused."""
    A, B, b, c = _random(FC)
    x, y, _ = kt.gpmr(_t(A), _t(B), _t(b), _t(c))
    rng = np.random.default_rng(11)
    x0 = x.numpy() + 1e-3 * rng.standard_normal(20)
    y0 = y.numpy() + 1e-3 * rng.standard_normal(15)
    rt_, rj = _both(A, B, b, c, x0, y0, history=True)
    _same(rt_, rj, histories=True)
    assert _stacked_residual(A, B, b, c, rt_[0].numpy(), rt_[1].numpy(), 1.0,
                             1.0) <= 1e-6 * np.linalg.norm(b)
    with pytest.raises(ValueError, match="x0 and y0"):
        kt.gpmr(_t(A), _t(B), _t(b), _t(c), _t(x0))


def test_zero_rhs(FC):
    A, B, b, c = _random(FC)
    rt_, rj = _both(A, B, np.zeros_like(b), np.zeros_like(c))
    _same(rt_, rj)
    assert rt_[2].status == "x is a zero-residual solution"
    assert rt_[2].niter == 0 and not rt_[0].any() and not rt_[1].any()


def test_callback_itmax_timemax_and_verbose(capsys):
    """A callback stops the solve after iteration 2 and sees the active
    iterations only; a finite ``timemax`` stops after one chunk of 64; the
    verbose table prints the JAX package's rows (over 8 iterations: at
    the finite termination, iteration 15, fₖ₊₁.ₖ is rounding, 1e-13)."""
    A, B, b, c = _random()
    rt_, rj = _both(A, B, b, c, callback=lambda s: s.iter >= 2)
    _same(rt_, rj)
    assert rt_[2].status == "user-requested exit" and rt_[2].niter == 2
    seen = []
    *_, st = kt.gpmr(_t(A), _t(B), _t(b), _t(c),
                     callback=lambda s: seen.append(int(s.iter)) or False)
    assert seen == list(range(1, st.niter + 1))
    R = np.random.default_rng(0).standard_normal((100, 100))
    v = torch.ones(100, dtype=torch.float64)
    *_, st = kt.gpmr(_t(R), _t(R.T), v, v, atol=0.0, rtol=0.0, itmax=150,
                     timemax=1e-9)
    assert st.status == "time limit exceeded" and st.niter == 64
    capsys.readouterr()
    kj.gpmr(A, B, b, c, verbose=1, itmax=8)
    want = capsys.readouterr().out
    kt.gpmr(_t(A), _t(B), _t(b), _t(c), verbose=1, itmax=8)
    got = capsys.readouterr().out
    assert got.splitlines() == want.splitlines() and len(got.splitlines()) > 4


def test_double_word_and_bad_inputs_raise():
    A, B, b, c = _random()
    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
        kt.gpmr(_t(A), _t(B), _t(b), _t(c), precision="double_word")
    with pytest.raises(ValueError, match="precision"):
        kt.gpmr(_t(A), _t(B), _t(b), _t(c), precision="compensated")
    with pytest.raises(ValueError, match="mem must lie"):
        tf.gpmr_dia_fused(*_dia_pair()[2], 1.0, -1.0, 0.0, 1e-8,
                          80, mem=80)


# ---------------------------------------------------------------------------
# the kernel route and the plain version
# ---------------------------------------------------------------------------

def _dia_pair(dtype=np.float64, N=8):
    """A = convdiff_dia(N) and B = the DIA matrix whose data are A's aligned
    adjoint diagonals, in both packages (tests/test_fused.py:1497-1508),
    b and c from seeds 5 and 6; returns (JAX (A, B), port (A, B), the
    port's aligned (pd_a, pd_b, offsets_a, offsets_b), b, c)."""
    D = jconvdiff(N, N, N, dtype=dtype)
    pdj = JDIAOperator(D, use_pallas=True)
    pd_adj, offs_adj = pdj.aligned_adjoint()
    DT = JDIAMatrix(pd_adj, offs_adj, D.shape)
    A = dia_from_numpy(np.array(D.data), D.offsets, D.shape, device="cpu")
    BT = dia_from_numpy(np.array(pd_adj), offs_adj, D.shape, device="cpu")
    n = D.shape[0]
    b = np.random.default_rng(5).standard_normal(n).astype(dtype)
    c = np.random.default_rng(6).standard_normal(n).astype(dtype)
    aligned = (dia_align(A.data, A.offsets, n), dia_align(BT.data, BT.offsets,
                                                          n),
               offsets_tensor(A.offsets, "cpu"),
               offsets_tensor(BT.offsets, "cpu"), _t(b), _t(c))
    return (D, DT), (A, BT), aligned


@pytest.fixture
def fused_calls(monkeypatch):
    """Counts the calls of the kernel's plain version."""
    calls = []
    ref = tf.gpmr_dia_fused_ref

    def counted(*a, **k):
        calls.append((a[6:8], a[11] if len(a) > 11 else k.get("mem")))
        return ref(*a, **k)

    monkeypatch.setattr(tf, "gpmr_dia_fused_ref", counted)
    return calls


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_fused_route_matches_jax(dtype, fused_calls):
    """The kernel route is taken exactly where the JAX gate admits it
    (krylov_tpu/solvers/gpmr.py:364-396): A and B DIA operators, no C, D,
    E, F, x0, y0, history, callback, verbose, second pass or finite
    timemax, and a basis of at most 64 slots; the route's status, niter
    and x, y against the JAX package's fused route; every excluded
    option runs the general core."""
    (D, DT), (A, BT), _ = _dia_pair(dtype)
    n = D.shape[0]
    b = np.random.default_rng(5).standard_normal(n).astype(dtype)
    c = np.random.default_rng(6).standard_normal(n).astype(dtype)
    opA, opB = (kt.DIAOperator(M, use_kernel=True) for M in (A, BT))
    jA, jB = (JDIAOperator(M, use_pallas=True) for M in (D, DT))
    kw = {"lam": 1.0, "mu": -1.0, "memory": 40, "itmax": 40, "atol": 0.0,
          "rtol": 1e-8 if dtype == np.float64 else 1e-5}
    xj, yj, sj = kj.gpmr(jA, jB, jnp.asarray(b), jnp.asarray(c), **kw)
    xt, yt, st = kt.gpmr(opA, opB, _t(b), _t(c), **kw)
    assert (st.status, st.solved, st.inconsistent) == (sj.status, sj.solved,
                                                       sj.inconsistent)
    assert fused_calls == [((1.0, -1.0), 40)]
    if dtype == np.float64:
        assert abs(st.niter - sj.niter) <= 1
        for v, w in ((xt, xj), (yt, yj)):
            assert _rel(v.numpy(), np.asarray(w)) <= 1e-7
    else:
        assert abs(st.niter - sj.niter) <= max(2, 0.1 * sj.niter)
    ones = kt.DiagonalOperator(torch.ones(n, dtype=xt.dtype))
    for args, extra in (((), {"history": True}), ((), {"timemax": 1e6}),
                        ((), {"callback": lambda s: False}),
                        ((), {"verbose": 100}), ((), {"C": ones}),
                        ((), {"F": ones}),
                        ((), {"reorthogonalization": True}),
                        ((0.5 * xt, 0.5 * yt), {})):
        kt.gpmr(opA, opB, _t(b), _t(c), *args, **kw, **extra)
    kt.gpmr(opA, opB, _t(b), _t(c), **dict(kw, itmax=80, memory=80))
    kt.gpmr(opA, kt.DIAOperator(BT), _t(b), _t(c), **kw)
    assert len(fused_calls) == 1
    kt.gpmr(opA, opB, _t(b), _t(c), **dict(kw, itmax=64))
    assert fused_calls[-1] == ((1.0, -1.0), 64)


@pytest.mark.parametrize("itmax", [40, 12])
def test_plain_version_matches_jax_kernel(itmax):
    """The plain version against the JAX kernel in interpret mode at 8³
    f64 (tests/test_fused.py:1495-1526): converged at rtol 1e-8 in 40
    iterations (or tired at the basis size), niter within 1, status and
    flag equal, x and y within 1e-7 relative; capped at 12 iterations,
    status 100, x and y within 1e-10 of max|v| + 1."""
    (D, DT), _, (pda, pdb, ota, otb, b, c) = _dia_pair()
    pdj = JDIAOperator(D, use_pallas=True)._pd
    pdbj = JDIAOperator(DT, use_pallas=True)._pd
    args = (1.0, -1.0, 0.0, 1e-8, itmax)
    rt_ = tf.gpmr_dia_fused_ref(pda, pdb, ota, otb, b, c, *args, itmax)
    rj = jf.gpmr_dia_fused(pdj, pdbj, D.offsets, DT.offsets,
                           jnp.asarray(b.numpy()), jnp.asarray(c.numpy()),
                           *args, mem=itmax, interpret=True)
    assert (int(rt_[4]), int(rt_[5])) == (int(rj[4]), int(rj[5]))
    assert abs(int(rt_[2]) - int(rj[2])) <= 1
    for v, w in zip(rt_[:2], rj[:2]):
        w = np.asarray(w)
        if itmax == 12:
            assert int(rt_[2]) == 12 and int(rt_[4]) == 100
            assert np.abs(v.numpy() - w).max() <= TOL * (np.abs(w).max() + 1)
        else:
            assert _rel(v.numpy(), w) <= 1e-7
    z = torch.zeros_like(b)
    out = tf.gpmr_dia_fused_ref(pda, pdb, ota, otb, z, z, *args, itmax)
    assert (int(out[2]), int(out[4])) == (0, 2)
    assert not out[0].any() and not out[1].any()


def _scaled_poisson(N=8, dtype=np.float64):
    """K = 0.1 (P + I) for the 3-D Poisson stencil P (tools/
    exp_fused_all_tpu.py:72-85), a port DIA matrix on the CPU."""
    D = jpoisson(N, N, N, dtype=dtype)
    data = np.array(D.data)
    data[D.offsets.index(0)] += 1.0
    return dia_from_numpy(0.1 * data, D.offsets, D.shape, device="cpu")


def test_adjoint_dia_gives_the_true_transpose():
    """gpmr(K, Kᴴ, b, c, λ = 1, μ = −1, memory = 48, itmax = 48) with Kᴴ
    from ``adjoint_dia()``, on the kernel route (its plain version here):
    solved, and the true stacked residual of [I K; Kᴴ −I], in f64, at
    most rtol ‖[b; c]‖ (the JAX cell, 20 iterations at 48³)."""
    K = _scaled_poisson()
    opK = kt.DIAOperator(K, use_kernel=True)
    data, offs = opK.adjoint_dia()
    opKH = kt.DIAOperator(kt.DIAMatrix(data, offs, K.shape, device="cpu"),
                          use_kernel=True)
    n = K.shape[0]
    rng = np.random.default_rng(7)
    b, c = _t(rng.standard_normal(n)), _t(rng.standard_normal(n))
    rtol = 1e-8
    x, y, st = kt.gpmr(opK, opKH, b, c, lam=1.0, mu=-1.0, memory=48,
                       itmax=48, atol=0.0, rtol=rtol)
    assert st.solved and st.niter < 48
    top = b - (x + opK.matvec(y))
    bot = c - (opK.rmatvec(x) - y)
    res = float(torch.sqrt(top.norm() ** 2 + bot.norm() ** 2))
    assert res <= rtol * float(torch.sqrt(b.norm() ** 2 + c.norm() ** 2))


# ---------------------------------------------------------------------------
# the interface, storage and the niter table
# ---------------------------------------------------------------------------

def _tall_pair():
    """The GPMR fixture of tests/fixtures.py:drive_method: the tall 14 ×
    10 matrix A, B = Aᴴ, b and c from seed 42."""
    A, b, c = _rect_pair()
    return A / 0.3, (A / 0.3).T.copy(), b, c


def test_krylov_solve_and_workspace():
    """krylov_solve equals a direct call and the JAX package's; a GPMR
    workspace's accessors match the JAX package's (two solutions, one A
    and one B product per iteration, no Aᴴ product)."""
    A, B, b, c = _random()
    *vs, st = kt.krylov_solve("gpmr", _t(A), _t(B), _t(b), _t(c))
    *vd, sd = kt.gpmr(_t(A), _t(B), _t(b), _t(c))
    *vj, sj = kj.krylov_solve("gpmr", A, B, b, c)
    assert (st.status, st.niter) == (sd.status, sd.niter) == (sj.status,
                                                              sj.niter)
    for v, d, j in zip(vs, vd, vj):
        assert torch.equal(v, d) and _rel(v.numpy(), j) <= TOL
    wj = kj.krylov_workspace("gpmr", A, b)
    wt = kt.krylov_workspace("gpmr", _t(A), _t(b))
    kj.krylov_solve_inplace(wj, A, B, b, c)
    kt.krylov_solve_inplace(wt, _t(A), _t(B), _t(b), _t(c))
    assert kt.iteration_count(wt) == kj.iteration_count(wj)
    assert kt.Aprod_count(wt) == kj.Aprod_count(wj)
    assert kt.Atprod_count(wt) == kj.Atprod_count(wj) == 0
    assert tws.Bprod_count(wt) == kt.iteration_count(wt)
    for v, j in zip(kt.solution(wt), kj.solution(wj)):
        assert _rel(v.numpy(), j) <= TOL
    assert isinstance(kt.GpmrWorkspace(_t(A), _t(b)), kt.KrylovWorkspace)
    assert wt.rNorm is not None and "state storage" in repr(wt)


def test_state_within_storage_budget():
    """The state's large tensors (size ≥ n) within tests/test_storage.py:80's
    budget with itmax = 12, (12 + 1)(n + m) + (2·12 + 2)² + 8·12, on the
    14 × 10 system."""
    A, B, b, c = _tall_pair()
    solve, _ = tws._resolve("gpmr")
    *_, stats, state = solve(_t(A), _t(B), _t(b), _t(c), itmax=12)
    assert state is not None and stats.niter > 0
    big = sum(t.numel() for _, t in tws.state_tensors(state)
              if t.numel() >= 10)
    assert big <= 13 * (10 + 14) + 26 ** 2 + 8 * 12


def test_niter_within_the_reference_band():
    """niter on the GPMR fixture of tests/reference_niter.json's
    ``small_fixtures`` within ±max(2, 10%) of the recorded f64 count,
    with the recorded status, and the stacked residual of [I A; Aᴴ I]
    small."""
    A, B, b, c = _tall_pair()
    x, y, st = kt.gpmr(_t(A), _t(B), _t(b), _t(c))
    ref = NITER["small_fixtures"]["gpmr"]
    assert st.status == ref["status"]
    assert abs(st.niter - ref["niter"]) <= max(2, round(0.1 * ref["niter"]))
    assert _stacked_residual(A, B, b, c, x.numpy(), y.numpy(), 1.0, 1.0) \
        <= 1e-6 * np.linalg.norm(b)
