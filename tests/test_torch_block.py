"""krylov_tpu_torch.block_minres against krylov_tpu's, on both routes (the
cases of tests/test_interface.py:116-150, tests/test_block_minres.py and
tests/test_fused.py:325-365), and the plain version of its whole-solve
kernel against krylov_tpu's ``block_minres_dia_fused`` in interpret mode.

Inputs are made with numpy from a seed (or the fixture generators) and
given to both packages.  Tolerances: on the fixtures, in f64 and c128,
the status string, niter and ``solved`` are equal and X and the
histories agree to 1e-10 relative (both packages' QRs are LAPACK's
Householder QR on the CPU, summed in another order; measured: 5.4e-16 at
most).

The kernel route runs on the 3-D Poisson stencil at 10³ with a seeded
normal B of 4 columns, and shifted by −1.5 (indefinite), the JAX
package's cells (tests/test_fused.py:325-348).  Its plain version takes
CholQR2 where the general core takes a Householder QR, so the two are
held to the JAX package's own bands: niter within 2, the same status and
‖B − AX‖_F ≤ 1e-9 ‖B‖_F at rtol 1e-10; against the JAX kernel, the same
status, niter within 2 and X within 1e-7 relative at the default
tolerances (measured: equal niter, 4.8e-9 with the shift), and capped at
30 iterations X within 1e-10 of max|X| + 1 (measured: 1.5e-12).
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
from krylov_tpu.ops.dia import poisson_dia as jpoisson
from krylov_tpu_torch import workspaces as tws
from krylov_tpu_torch.convert import dia_from_numpy
from krylov_tpu_torch.ops import cuda_fused as tf
from krylov_tpu_torch.ops.cuda_dia import offsets_tensor
from test_torch_gmres import _rel
from test_torch_tricg import _t

TOL = 1e-10
NITER = json.loads((pathlib.Path(__file__).parent
                    / "reference_niter.json").read_text())


@pytest.fixture(params=[np.float64, np.complex128], ids=["f64", "c128"])
def FC(request):
    return request.param


def _both(A, B, *args, **kw):
    """(port's (X, stats), JAX's (X, stats)) of one call."""
    rj = kj.block_minres(A, B, *args, **kw)
    rt_ = kt.block_minres(_t(A), _t(B), *map(_t, args), **kw)
    return rt_, rj


def _same(rt_, rj, tol=TOL, histories=False):
    """Status, niter and ``solved`` equal; X (and the history) to ``tol``
    relative."""
    Xt, st = rt_
    Xj, sj = rj
    assert type(st) is kt.SimpleStats
    assert (st.status, st.niter, st.solved, st.inconsistent) == (
        sj.status, sj.niter, sj.solved, sj.inconsistent)
    assert _rel(Xt.numpy(), np.asarray(Xj)) <= tol
    if histories:
        want = np.asarray(sj.residuals)
        assert st.residuals.shape == want.shape
        assert _rel(st.residuals, want) <= tol


def _relres(A, B, X):
    return np.linalg.norm(B - A @ X) / np.linalg.norm(B)


# ---------------------------------------------------------------------------
# the general core against the JAX package
# ---------------------------------------------------------------------------

def test_interface_cases(FC):
    """tests/test_interface.py:116-150: two columns on the 20 × 20
    Hermitian definite fixture, with the history, and a warm start."""
    A, b = fx.symmetric_definite(n=20, FC=FC)
    A = np.asarray(A)
    B = np.stack([b, np.ones(20, dtype=FC)], axis=1)
    rt_, rj = _both(A, B, history=True)
    _same(rt_, rj, histories=True)
    assert rt_[1].solved and _relres(A, B, rt_[0].numpy()) <= 1e-6
    X0 = (0.5 * np.ones((20, 2))).astype(FC)
    rt_, rj = _both(A, B, X0)
    _same(rt_, rj)
    assert _relres(A, B, rt_[0].numpy()) <= 1e-6


@pytest.mark.parametrize("p", [1, 8])
def test_block_widths(p):
    """p = 1 and p = 8 on the 100 × 100 definite system of
    tests/test_block_minres.py:70-78."""
    rng = np.random.default_rng(13)
    M = rng.standard_normal((100, 100))
    A = M @ M.T + 100 * np.eye(100)
    B = rng.standard_normal((100, p))
    rt_, rj = _both(A, B, atol=0.0, rtol=1e-10, history=True)
    _same(rt_, rj, histories=True)
    assert rt_[1].solved and _relres(A, B, rt_[0].numpy()) <= 1e-9


def test_indefinite():
    """The indefinite system of tests/test_block_minres.py:54-66 (200 ×
    200, 20 negative eigenvalues, p = 3) at rtol 1e-10.  The block
    Lanczos basis loses orthogonality there: from iteration 24 on the
    two packages' residual estimates part by a factor of about 40 per
    iteration (7.5e-14 at 24, 0.25 at 36, measured), so the stop falls
    on 36 or 37 by rounding alone.  Held to: the history to 1e-10 over the
    first 20 iterations, the same status, niter within 2 (the JAX
    package's band between its own two routes, tests/test_fused.py:345)
    and both ‖B − AX‖ ≤ 1e-8 ‖B‖."""
    rng = np.random.default_rng(11)
    n, p = 200, 3
    Q = np.linalg.qr(rng.standard_normal((n, n)))[0]
    d = np.concatenate([np.linspace(1, 5, n - 20), -np.linspace(1, 3, 20)])
    A = Q @ np.diag(d) @ Q.T
    B = rng.standard_normal((n, p))
    (Xt, st), (Xj, sj) = _both(A, B, atol=0.0, rtol=1e-10, history=True)
    assert (st.status, st.solved) == (sj.status, sj.solved)
    assert abs(st.niter - sj.niter) <= 2
    assert _rel(st.residuals[:20], np.asarray(sj.residuals)[:20]) <= TOL
    assert st.solved and _relres(A, B, Xt.numpy()) <= 1e-8
    assert _relres(A, B, np.asarray(Xj)) <= 1e-8


def test_warm_start_refinement():
    """tests/test_block_minres.py:69-78: a loose solve, then a warm start
    from it to rtol 1e-12."""
    rng = np.random.default_rng(13)
    M = rng.standard_normal((100, 100))
    A = M @ M.T + 100 * np.eye(100)
    B = rng.standard_normal((100, 2))
    X0, _ = kt.block_minres(_t(A), _t(B), atol=0.0, rtol=1e-2)
    rt_, rj = _both(A, B, X0.numpy(), atol=0.0, rtol=1e-12)
    _same(rt_, rj)
    assert _relres(A, B, rt_[0].numpy()) <= 1e-10


def test_zero_rhs(FC):
    A, _ = fx.symmetric_definite(n=20, FC=FC)
    B = np.zeros((20, 2), dtype=FC)
    rt_, rj = _both(np.asarray(A), B)
    _same(rt_, rj)
    assert rt_[1].status == "x is a zero-residual solution"
    assert rt_[1].niter == 0 and not rt_[0].any()


def test_callback_itmax_timemax_and_verbose(capsys):
    """A callback stops the solve after iteration 2 and sees the active
    iterations only; itmax = 2 stops tired; a finite ``timemax`` stops
    after one chunk of 64; the verbose table prints the JAX package's
    rows (over 8 iterations: at the finite termination, iteration 10, the
    estimate is rounding, 1e-16)."""
    A, b = fx.symmetric_definite(n=20)
    A = np.asarray(A)
    B = np.stack([b, np.ones(20)], axis=1)
    rt_, rj = _both(A, B, callback=lambda s: s.iter >= 2)
    _same(rt_, rj)
    assert rt_[1].status == "user-requested exit" and rt_[1].niter == 2
    seen = []
    _, st = kt.block_minres(_t(A), _t(B), callback=lambda s: seen.append(
        int(s.iter)) or False)
    assert seen == list(range(1, st.niter + 1))
    rt_, rj = _both(A, B, itmax=2, atol=0.0, rtol=0.0)
    _same(rt_, rj)
    assert rt_[1].status == "maximum number of iterations exceeded"
    R = np.random.default_rng(0).standard_normal((200, 200))
    _, st = kt.block_minres(_t(R + R.T), _t(np.ones((200, 2))), atol=0.0,
                            rtol=0.0, itmax=300, timemax=1e-9)
    assert st.status == "time limit exceeded" and st.niter == 64
    capsys.readouterr()
    kj.block_minres(A, B, verbose=1, itmax=8)
    want = capsys.readouterr().out
    kt.block_minres(_t(A), _t(B), verbose=1, itmax=8)
    got = capsys.readouterr().out
    assert got.splitlines() == want.splitlines() and len(got.splitlines()) > 4


def test_double_word_and_bad_inputs_raise():
    A, b = fx.symmetric_definite(n=20)
    A, B = _t(np.asarray(A)), _t(np.stack([b, b], axis=1))
    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
        kt.block_minres(A, B, precision="double_word")
    with pytest.raises(ValueError, match="precision"):
        kt.block_minres(A, B, precision="compensated")
    with pytest.raises(ValueError, match="preconditioning"):
        kt.block_minres(A, B, M=kt.DiagonalOperator(torch.ones(20)))
    with pytest.raises(ValueError, match="square"):
        kt.block_minres(A[:, :10], B)
    with pytest.raises(ValueError, match="columns"):
        kt.block_minres(A, B, p=4)
    with pytest.raises(ValueError, match="shape"):
        tf.block_minres_dia_fused(*_kernel_system()[1][:2],
                                  torch.ones(1000, 9), 0.0, 0.1, 10)


# ---------------------------------------------------------------------------
# the kernel route and the plain version
# ---------------------------------------------------------------------------

def _kernel_system(N=10, p=4, shift=0.0, seed=3):
    """poisson_dia(N) + shift I in both packages and a seeded normal B
    (tests/test_fused.py:328-336); returns (JAX matrix, (port's aligned
    diagonals, offsets), port matrix, B)."""
    D = jpoisson(N, N, N, dtype=np.float64)
    data = np.array(D.data)
    data[D.offsets.index(0)] += shift
    Dj = JDIAMatrix(jnp.asarray(data), D.offsets, D.shape)
    A = dia_from_numpy(data, D.offsets, D.shape, device="cpu")
    op = kt.DIAOperator(A, use_kernel=True)
    B = np.random.default_rng(seed).standard_normal((D.shape[0], p))
    return Dj, (op._pd, offsets_tensor(D.offsets, "cpu")), A, B


@pytest.fixture
def fused_calls(monkeypatch):
    """Counts the calls of the kernel's plain version."""
    calls = []
    ref = tf.block_minres_dia_fused_ref

    def counted(*a, **k):
        calls.append(tuple(a[2].shape))
        return ref(*a, **k)

    monkeypatch.setattr(tf, "block_minres_dia_fused_ref", counted)
    return calls


@pytest.mark.parametrize("shift", [0.0, -1.5], ids=["spd", "indefinite"])
def test_fused_route_matches_general(shift, fused_calls):
    """tests/test_fused.py:335-348: the kernel route (its plain version on
    the CPU) against the general core at rtol 1e-10, niter within 2, the
    same status, and ‖B − AX‖ ≤ 1e-9‖B‖; against the JAX package's fused
    route, the same status and niter within 2."""
    Dj, _, A, B = _kernel_system(shift=shift)
    kw = dict(atol=0.0, rtol=1e-10)
    Xf, sf = kt.block_minres(kt.DIAOperator(A, use_kernel=True), _t(B), **kw)
    Xg, sg = kt.block_minres(kt.DIAOperator(A), _t(B), **kw)
    _, sj = kj.block_minres(JDIAOperator(Dj, use_pallas=True),
                            jnp.asarray(B), **kw)
    assert fused_calls == [B.shape]
    assert sf.status == sg.status == sj.status
    assert abs(sf.niter - sg.niter) <= 2 and abs(sf.niter - sj.niter) <= 2
    R = B - torch.stack([A @ Xf[:, j].contiguous()
                         for j in range(B.shape[1])], 1).numpy()
    assert np.linalg.norm(R) <= 1e-9 * np.linalg.norm(B)


def test_route_gate_zero_rhs_warm_start_and_rank_probe(fused_calls):
    """tests/test_fused.py:350-365: B = 0 stops at once (the full-rank
    probe sends it to the general core, as the JAX package's); a warm
    start takes the kernel on B − AX₀ and adds X₀ back; the probe sends a
    rank-1 block to the general core; history, callback, verbose, a
    finite timemax and p = 9 take the general core; a complex B has no
    kernel."""
    Dj, _, A, B = _kernel_system()
    op = kt.DIAOperator(A, use_kernel=True)
    X0, st0 = kt.block_minres(op, torch.zeros(B.shape, dtype=torch.float64))
    assert st0.niter == 0 and not X0.any() and len(fused_calls) == 0
    assert st0.status == "x is a zero-residual solution"
    Xr, _ = kt.block_minres(kt.DIAOperator(A), _t(B), atol=0.0, rtol=1e-10)
    Xw, sw = kt.block_minres(op, _t(B), 0.5 * Xr, atol=0.0, rtol=1e-10)
    assert len(fused_calls) == 1 and sw.solved
    Rw = _t(B) - torch.stack([A @ Xw[:, j].contiguous() for j in range(4)],
                             1)
    assert float(Rw.norm()) <= 1e-9 * np.linalg.norm(B)
    B1 = np.tile(B[:, :1], (1, 4))
    X1, s1 = kt.block_minres(op, _t(B1), atol=0.0, rtol=1e-10)
    assert len(fused_calls) == 1 and s1.solved
    # the QR of a rank-1 block leaves three columns of rounding, which the
    # two packages' Householder QRs round apart: niter 40 here, 41 there
    _, s1j = kj.block_minres(JDIAOperator(Dj, use_pallas=True),
                             jnp.asarray(B1), atol=0.0, rtol=1e-10)
    assert s1.status == s1j.status and abs(s1.niter - s1j.niter) <= 2
    R1 = _t(B1) - torch.stack([A @ X1[:, j].contiguous() for j in range(4)],
                              1)
    assert float(R1.norm()) <= 1e-9 * np.linalg.norm(B1)
    for extra in ({"history": True}, {"callback": lambda s: False},
                  {"verbose": 100}, {"timemax": 1e6}):
        assert kt.block_minres(op, _t(B), **extra)[1].solved
    B9 = np.random.default_rng(4).standard_normal((B.shape[0], 9))
    kt.block_minres(op, _t(B9), itmax=3)
    Bc = _t(B).to(torch.complex128)
    Ac = kt.DIAOperator(kt.poisson_dia(10, dtype=torch.complex128,
                                       device="cpu"), use_kernel=True)
    assert kt.block_minres(Ac, Bc)[1].solved
    assert len(fused_calls) == 1
    assert tf.block_minres_dia_fused_supported(A.offsets, 1000, 8,
                                               torch.float32)
    assert not tf.block_minres_dia_fused_supported(A.offsets, 1000, 9,
                                                   torch.float32)


@pytest.mark.parametrize("shift", [0.0, -1.5], ids=["spd", "indefinite"])
@pytest.mark.parametrize("itmax", [2000, 30], ids=["converged", "capped"])
def test_plain_version_matches_jax_kernel(shift, itmax):
    """The plain version against the JAX kernel in interpret mode at 10³
    f64 with p = 4, at the default tolerances (√eps): the status equal,
    niter within 2 and X within 1e-7 relative; capped at 30 iterations,
    X within 1e-10 of max|X| + 1."""
    Dj, (pd, ot), _, B = _kernel_system(shift=shift)
    pdj = JDIAOperator(Dj, use_pallas=True)._pd
    tol = float(np.sqrt(np.finfo(np.float64).eps))
    rt_ = tf.block_minres_dia_fused_ref(pd, ot, _t(B), tol, tol, itmax)
    rj = jf.block_minres_dia_fused(pdj, Dj.offsets, jnp.asarray(B), tol,
                                   tol, itmax, p=4, interpret=True)
    assert int(rt_[3]) == int(rj[3])
    Xt, Xj = rt_[0].numpy(), np.asarray(rj[0])
    if itmax == 30:
        assert int(rt_[1]) == int(rj[1]) == 30
        assert np.abs(Xt - Xj).max() <= TOL * (np.abs(Xj).max() + 1)
    else:
        assert abs(int(rt_[1]) - int(rj[1])) <= 2
        assert _rel(Xt, Xj) <= 1e-7
    Z = tf.block_minres_dia_fused_ref(pd, ot, torch.zeros(B.shape,
                                                          dtype=torch.float64),
                                      tol, tol, itmax)
    assert (int(Z[1]), int(Z[3])) == (0, 2) and not Z[0].any()


# ---------------------------------------------------------------------------
# the interface, storage and the niter table
# ---------------------------------------------------------------------------

def _spd_pair(n=10, p=2):
    """The block fixture of tests/fixtures.py:drive_method: the SPD
    tridiagonal 10 × 10 matrix and B = A [1 1]."""
    A = np.diag(4.0 * np.ones(n)) + np.diag(-np.ones(n - 1), 1) \
        + np.diag(-np.ones(n - 1), -1)
    return A, A @ np.ones((n, p))


def test_krylov_solve_and_workspace():
    """krylov_solve equals a direct call and the JAX package's; a block
    MINRES workspace (a BlockKrylovWorkspace) solves with its width."""
    A, B = _spd_pair()
    Xs, st = kt.krylov_solve("block_minres", _t(A), _t(B))
    Xd, sd = kt.block_minres(_t(A), _t(B))
    Xj, sj = kj.krylov_solve("block_minres", A, B)
    assert (st.status, st.niter) == (sd.status, sd.niter) == (sj.status,
                                                              sj.niter)
    assert torch.equal(Xs, Xd) and _rel(Xs.numpy(), np.asarray(Xj)) <= TOL
    ws = tws.BlockMinresWorkspace(10, 10, torch.float64, p=2)
    assert isinstance(ws, kt.BlockKrylovWorkspace)
    kt.krylov_solve_inplace(ws, _t(A), _t(B), atol=0.0, rtol=1e-10)
    assert kt.issolved(ws)
    assert _rel(kt.solution(ws).numpy(), np.ones((10, 2))) <= 1e-8
    assert ws.rNorm is not None and "state storage" in repr(ws)


def test_state_within_storage_budget():
    """The state's large tensors (size ≥ n) within tests/test_storage.py:
    81's budget with p = 2, 7np + 12p², on the 10 × 10 system."""
    A, B = _spd_pair()
    solve, _ = tws._resolve("block_minres")
    *_, stats, state = solve(_t(A), _t(B))
    assert state is not None and stats.niter > 0
    big = sum(t.numel() for _, t in tws.state_tensors(state)
              if t.numel() >= 10)
    assert big <= 7 * 10 * 2 + 12 * 2 * 2


def test_niter_within_the_reference_band():
    """niter on the block fixture of tests/reference_niter.json's
    ``small_fixtures`` within ±max(2, 10%) of the recorded f64 count,
    with the recorded status, and ‖B − AX‖ small."""
    A, B = _spd_pair()
    X, st = kt.block_minres(_t(A), _t(B))
    ref = NITER["small_fixtures"]["block_minres"]
    assert st.status == ref["status"]
    assert abs(st.niter - ref["niter"]) <= max(2, round(0.1 * ref["niter"]))
    assert _relres(A, B, X.numpy()) <= 1e-6
