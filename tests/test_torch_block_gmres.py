"""krylov_tpu_torch.block_gmres against krylov_tpu's, on both routes (the
cases of tests/test_interface.py:127-140 and tests/test_fused.py:
196-321), and the plain version of its whole-solve kernel against
krylov_tpu's ``block_gmres_dia_fused`` in interpret mode.

Inputs are made with numpy from a seed (or the fixture generators) and
given to both packages.  Tolerances, in f64 and c128 on the general
core: the status string, niter and ``solved`` are equal, X agrees to
1e-10 relative (both packages' QRs and Cholesky factors are LAPACK's on
the CPU, their products summed in another order; measured 5e-15 without
a restart) and to 1e-8 across restarts (a restart starts from the true
residual, which the rounding of X has moved; measured 1.4e-9), the
histories to 1e-10.  The kernel's plain version against the JAX kernel:
the same status, flags and pass count, niter exact in f64 and X within
1e-12 (measured 2e-15), within ±2 with a bf16 basis and X within 1e-4
(bf16 rounds at other places in the two frameworks; measured 1.2e-6).
The two routes are compared on X, the status and niter within 2, never
on V (ROADMAP.md, watch list: the general core's Householder QR and the
kernel's CholQR2 give the basis other column signs).
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
from krylov_tpu.operators import DiagonalOperator as JDiagonalOperator
from krylov_tpu.operators import FunctionOperator as JFunctionOperator
from krylov_tpu.ops.dia import DIAMatrix as JDIAMatrix
from krylov_tpu.ops.dia import poisson_dia as jpoisson
from krylov_tpu_torch import workspaces as tws
from krylov_tpu_torch.convert import dia_from_numpy
from krylov_tpu_torch.ops import cuda_fused as tf
from test_torch_gmres import _rel
from test_torch_tricg import _t


def _both(A, B, *args, port_kw=None, **kw):
    """(port's (X, stats), JAX's (X, stats)) of one call; ``port_kw``
    replaces options that are operators of one package."""
    rj = kj.block_gmres(A, B, *args, **kw)
    kw.update(port_kw or {})
    rt_ = kt.block_gmres(_t(A), _t(B), *map(_t, args), **kw)
    return rt_, rj


def _same(rt_, rj, tol=1e-10, histories=False):
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


def _laplacian_system():
    """tests/test_interface.py:135-140: the 6³ Laplacian, two columns."""
    A, b = fx.sparse_laplacian(6)
    Ad = np.asarray(A.todense())
    return Ad, np.stack([b, np.linspace(0, 1, 216)], axis=1)


# ---------------------------------------------------------------------------
# the general core against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("FC", [np.float64, np.complex128],
                         ids=["f64", "c128"])
def test_interface_case(FC):
    """tests/test_interface.py:127-133: two columns on the 20 × 20
    non-symmetric fixture.  In f64 its Krylov block turns rank-deficient
    at the second iteration, where a Cholesky pivot of 1e-17 is positive
    or negative by rounding alone (the JAX package breaks down and
    restarts there, the port need not), so f64 is held to the JAX test's
    bound; c128 to the JAX package's niter, status, X and history."""
    A, b = fx.nonsymmetric_definite(n=20, FC=FC)
    A = np.asarray(A)
    B = np.stack([b, np.arange(20).astype(FC)], axis=1)
    rt_, rj = _both(A, B, history=True)
    assert rt_[1].solved and _relres(A, B, rt_[0].numpy()) <= 1e-6
    if FC == np.complex128:
        _same(rt_, rj, histories=True)


@pytest.mark.parametrize("kw", [
    {"memory": 10, "restart": True},
    {"memory": 10, "restart": True, "reorthogonalization": True},
    {"memory": 4, "restart": True, "itmax": 7},
    {}], ids=["restart", "reorth", "itmax", "no-restart"])
def test_restarts_match_jax(kw):
    """tests/test_interface.py:135-140 with the options of the reference's
    signature: restarts (a pass of 10 panels), a third CGS pass, an itmax
    that stops mid-pass, and the default basis of min(itmax, 128)
    panels."""
    A, B = _laplacian_system()
    rt_, rj = _both(A, B, **kw)
    _same(rt_, rj, tol=1e-8)
    if "itmax" not in kw:
        assert _relres(A, B, rt_[0].numpy()) <= 1e-5


def test_complex_b_warm_start_and_history():
    """A complex system with three columns, restarting, with its history;
    then a warm start on the Laplacian (X₀ is part of X from the start,
    as in the JAX package)."""
    rng = np.random.default_rng(4)
    A, _ = _laplacian_system()
    Ac = A + 0.3j * np.diag(rng.standard_normal(216))
    Bc = rng.standard_normal((216, 3)) + 1j * rng.standard_normal((216, 3))
    _same(*_both(Ac, Bc, memory=10, restart=True, history=True),
          histories=True)
    A, B = _laplacian_system()
    rt_, rj = _both(A, B, 0.3 * np.ones((216, 2)), memory=10, restart=True)
    _same(rt_, rj, tol=1e-8)


def test_left_and_right_preconditioners_with_ldiv():
    """M and N (Jacobi and its square root) applied by products, then by
    ``solve`` (ldiv=True) on block-capable operators."""
    A, B = _laplacian_system()
    d = np.diag(A)
    rt_, rj = _both(A, B, M=JDiagonalOperator(1 / d),
                    N=JDiagonalOperator(1 / np.sqrt(d)), memory=8,
                    restart=True,
                    port_kw={"M": kt.DiagonalOperator(_t(1 / d)),
                             "N": kt.DiagonalOperator(_t(1 / np.sqrt(d)))})
    _same(rt_, rj, tol=1e-8)

    def jop(s):
        return JFunctionOperator(lambda v: v * s[:, None], (216, 216),
                                 np.float64, solve=lambda v: v / s[:, None])

    def top(s):
        st = _t(s)[:, None]
        return kt.FunctionOperator(lambda v: v * st, (216, 216),
                                   torch.float64, solve=lambda v: v / st)

    rt_, rj = _both(A, B, M=jop(d), N=jop(np.sqrt(d)), ldiv=True, memory=8,
                    restart=True,
                    port_kw={"M": top(d), "N": top(np.sqrt(d))})
    _same(rt_, rj, tol=1e-8)
    assert _relres(A, B, rt_[0].numpy()) <= 1e-5


@pytest.mark.parametrize("stop", [3, 10, 12])
def test_callback_mid_pass_and_at_the_pass_boundary(stop):
    """A callback that asks to stop at iteration 3 (mid-pass: X stays the
    pass's start, as in the JAX package), 10 (the pass boundary: the
    pass's X) and 12 (mid-pass of the second pass)."""
    A, B = _laplacian_system()
    _same(*_both(A, B, memory=10, restart=True,
                 callback=lambda s: s.iter >= stop), tol=1e-8)


def test_verbose_table_and_timemax(capsys):
    """The verbose table prints the pass first (the reference's columns,
    src/block_gmres.jl:181), every ``verbose`` iterations, as the JAX
    package prints it; a finite timemax stops with 'time limit
    exceeded'."""
    A, B = _laplacian_system()
    kj.block_gmres(A, B, memory=10, restart=True, verbose=2)
    want = capsys.readouterr().out
    kt.block_gmres(_t(A), _t(B), memory=10, restart=True, verbose=2)
    got = capsys.readouterr().out
    assert got.splitlines() == want.splitlines()
    assert got.splitlines()[1].split() == ["pass", "k", "‖Rₖ‖"]
    X, st = kt.block_gmres(_t(A), _t(B), memory=4, restart=True,
                           rtol=1e-30, atol=1e-30, itmax=300, timemax=1e-9)
    assert st.status == "time limit exceeded" and st.niter == 64


# ---------------------------------------------------------------------------
# the kernel's plain version against the JAX kernel
# ---------------------------------------------------------------------------

def _dia_pair(N, dtype, shift=0.5):
    """tests/test_fused.py:199-206's P + shift·I in both packages (the
    port's with its kernel route, on the CPU)."""
    D = jpoisson(N, N, N, dtype=dtype)
    D = JDIAMatrix(D.data.at[3].add(shift), D.offsets, D.shape)
    Dt = dia_from_numpy(np.asarray(D.data), D.offsets, D.shape,
                        device="cpu")
    return D, kt.DIAOperator(Dt, use_kernel=True)


def _kernels(D, op, B, atol, rtol, itmax, mem, basis=None):
    """(the port's plain version, the JAX kernel in interpret mode) on the
    same inputs."""
    jop = JDIAOperator(D, use_pallas=True)
    rj = jf.block_gmres_dia_fused(
        jop._pd, D.offsets, jnp.asarray(B), atol, rtol, itmax, mem=mem,
        p=B.shape[1], basis_dtype=None if basis is None else jnp.bfloat16)
    rt_ = tf.block_gmres_dia_fused(op._pd, op._offsets, _t(B), atol, rtol,
                                   itmax, mem, basis)
    return rt_, rj


def _ints(r):
    return [int(v) for v in (r[1], r[3], r[4], r[5])]


def test_plain_version_restarts_with_the_jax_kernel():
    """P + 0.5 I at 6³, three columns, memory 6 (restarts), rtol 1e-10 in
    f64: niter, status, inconsistent flag and pass count equal, X and the
    final estimate within 1e-12."""
    D, op = _dia_pair(6, np.float64)
    B = np.random.default_rng(3).standard_normal((216, 3))
    rt_, rj = _kernels(D, op, B, 0.0, 1e-10, 200, 6)
    assert _ints(rt_) == _ints(rj) and int(rt_[3]) == 1 and int(rt_[5]) > 1
    assert _rel(rt_[0].numpy(), np.asarray(rj[0])) <= 1e-12
    assert abs(float(rt_[2]) - float(rj[2])) <= 1e-12 * np.linalg.norm(B)


def test_plain_version_zero_b_itmax_and_bf16_basis():
    """B = 0 stops at once with X = 0; itmax = 3 stops tired; a bf16 basis
    (f32 arithmetic) stops solved with the JAX kernel's status and passes,
    niter within 2, and a true residual within the JAX test's bound
    (tests/test_fused.py:300-318)."""
    D, op = _dia_pair(6, np.float64)
    B = np.random.default_rng(3).standard_normal((216, 3))
    for Bs, itmax, code in ((0 * B, 200, 2), (B, 3, 100)):
        rt_, rj = _kernels(D, op, Bs, 0.0, 1e-14, itmax, 8)
        assert _ints(rt_) == _ints(rj) and int(rt_[3]) == code
        assert _rel(rt_[0].numpy(), np.asarray(rj[0])) <= 1e-12 \
            if code == 100 else float(rt_[0].abs().max()) == 0.0
    D, op = _dia_pair(6, np.float32)
    B32 = B.astype(np.float32)
    rt_, rj = _kernels(D, op, B32, 0.0, 1e-5, 200, 6, torch.bfloat16)
    assert [int(rt_[3]), int(rt_[4])] == [int(rj[3]), int(rj[4])] == [1, 0]
    assert abs(int(rt_[1]) - int(rj[1])) <= 2
    assert abs(int(rt_[5]) - int(rj[5])) <= 2
    assert _rel(rt_[0].numpy(), np.asarray(rj[0])) <= 1e-4
    Ad = np.asarray(D.todense()).astype(np.float64)
    assert _relres(Ad, B, rt_[0].numpy().astype(np.float64)) <= 5e-5


def test_plain_version_strands_mass_on_singular_pivots():
    """A block whose third column is A times its first turns rank-deficient
    after one iteration: both kernels keep the mass of Z stranded on the
    singular pivots in the residual estimate, so neither claims
    convergence (ROADMAP.md watch list, false convergence on
    rank-deficient blocks); both run to itmax with the inconsistent flag
    set and the same pass count.  X is rounding-amplified there (its
    deficient column is solved only through restarts; measured 5e-3), so
    it is held to the true residual the estimate reports."""
    D, op = _dia_pair(6, np.float64)
    rng = np.random.default_rng(3)
    b = rng.standard_normal(216)
    Ad = np.asarray(D.todense())
    B = np.stack([b, rng.standard_normal(216), Ad @ b], 1)
    rt_, rj = _kernels(D, op, B, 0.0, 1e-10, 16, 8)
    assert _ints(rt_) == _ints(rj) and int(rt_[3]) == 100
    assert int(rt_[4]) == 1
    assert float(rt_[2]) > 1e-10 * np.linalg.norm(B)


# ---------------------------------------------------------------------------
# the routes
# ---------------------------------------------------------------------------

def test_kernel_route_matches_jax_and_the_general_core():
    """tests/test_fused.py:208-258 on the 6³ stencil: block_gmres on a DIA
    operator with its kernel route (the plain version here) against the
    JAX package's kernel route and the port's general core (the same
    status, niter within 2, ‖B − AX‖ ≤ 1.05 rtol ‖B‖), restarting at
    memory 6; a warm start from half the solution; M takes the general
    core; zero B and itmax as the JAX test has them."""
    D, op = _dia_pair(6, np.float64)
    B = np.random.default_rng(3).standard_normal((216, 3))
    Ad = np.asarray(D.todense())
    kw = dict(memory=6, restart=True, atol=0.0, rtol=1e-10)
    Xj, sj = kj.block_gmres(JDIAOperator(D, use_pallas=True),
                            jnp.asarray(B), **kw)
    Xf, sf = kt.block_gmres(op, _t(B), **kw)
    Xr, sr = kt.block_gmres(kt.DIAOperator(op.dia, use_kernel=False),
                            _t(B), **kw)
    assert (sf.status, sf.niter) == (sj.status, sj.niter) and sr.niter > 6
    assert abs(sf.niter - sr.niter) <= 2 and sf.status == sr.status
    assert _rel(Xf.numpy(), np.asarray(Xj)) <= 1e-12
    for X in (Xf, Xr):
        assert _relres(Ad, B, X.numpy()) <= 1.05e-10
    Xw, sw = kt.block_gmres(op, _t(B), 0.5 * Xr, **kw)
    assert _relres(Ad, B, Xw.numpy()) <= 1e-9
    M = kt.DiagonalOperator(torch.full((216,), 1.0 / 6.5,
                                       dtype=torch.float64))
    Xm, sm = kt.block_gmres(op, _t(B), M=M, **kw)
    assert sm.solved and _relres(Ad, B, Xm.numpy()) <= 1e-9
    X0, s0 = kt.block_gmres(op, _t(0 * B), memory=8)
    assert s0.niter == 0 and float(X0.abs().max()) == 0.0
    _, sc = kt.block_gmres(op, _t(B), memory=8, restart=True, itmax=3,
                           atol=0.0, rtol=1e-14)
    assert sc.niter == 3
    assert sc.status == "maximum number of iterations exceeded"


def test_route_choices(monkeypatch):
    """The kernel route runs for a full-rank block within the JAX gate's
    limits; M, a rank-deficient block (B = 0 included), mem·p > 128 and
    complex B take the general core; a bf16 basis off the kernel route
    raises the JAX package's 'fused-path feature' error."""
    calls = []
    ref = tf.block_gmres_dia_fused_ref

    def counted(*a, **k):
        calls.append(a[2].shape[1])
        return ref(*a, **k)

    monkeypatch.setattr(tf, "block_gmres_dia_fused_ref", counted)
    D, op = _dia_pair(4, np.float64)
    rng = np.random.default_rng(5)
    B = rng.standard_normal((64, 2))
    kt.block_gmres(op, _t(B))
    assert calls == [2]
    M = kt.DiagonalOperator(torch.full((64,), 0.2, dtype=torch.float64))
    for args, kw in (((_t(B),), {"M": M}),
                     ((_t(np.stack([B[:, 0], B[:, 0]], 1)),), {}),
                     ((_t(0 * B),), {}),
                     ((_t(rng.standard_normal((64, 3))),),
                      {"memory": 50, "restart": True, "itmax": 100}),
                     ((_t(B + 1j * np.flipud(B).copy()),), {}),
                     ((_t(B),), {"history": True}),
                     ((_t(B),), {"reorthogonalization": True})):
        kt.block_gmres(op, *args, **kw)
    assert calls == [2]
    with pytest.raises(ValueError, match="fused-path feature"):
        kt.block_gmres(kt.DIAOperator(op.dia, use_kernel=False), _t(B),
                       basis_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="fused-path feature"):
        kt.block_gmres(op, _t(B), basis_dtype=torch.float16)
    assert not tf.block_gmres_dia_fused_supported(
        D.offsets, 64, 9, torch.float64, 4)
    assert not tf.block_gmres_dia_fused_supported(
        D.offsets, 64, 4, torch.float64, 33)
    assert not tf.block_gmres_dia_fused_supported(
        D.offsets, 64, 4, torch.float64, 1)


def test_interface_workspace_and_double_word():
    """krylov_solve('block_gmres') equals the direct call; the workspace
    is a BlockKrylovWorkspace; double_word raises naming Queue 1 item
    8."""
    A, B = _laplacian_system()
    X, st = kt.krylov_solve("block_gmres", _t(A), _t(B), memory=10,
                            restart=True)
    Xd, sd = kt.block_gmres(_t(A), _t(B), memory=10, restart=True)
    assert (st.status, st.niter) == (sd.status, sd.niter)
    assert torch.equal(X, Xd)
    assert issubclass(tws.BlockGmresWorkspace, kt.BlockKrylovWorkspace)
    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
        kt.block_gmres(_t(A), _t(B), precision="double_word")
    with pytest.raises(ValueError, match="System must be square"):
        kt.block_gmres(_t(A[:, :200]), _t(B))
