"""The plain versions of the port's Chebyshev-CG, CR, CAR and MINRES
whole-solve kernels against krylov_tpu's ``cg_cheby_dia_fused``,
``cr_dia_fused``, ``car_dia_fused`` and ``minres_dia_fused``, run in
interpret mode as tests/test_fused.py runs them.

The same Poisson problem and right-hand side, made with numpy from a
seed, on the cases of tests/test_fused.py: converged, zero rhs, the
itmax cap, Jacobi, the λ-shift, the posdef and indefinite flags, and
Chebyshev degrees 1, 2 and 8.  Tolerances: in f64 niter, status and the
flags are equal, x agrees to 1e-10 relative and the returned norms to
1e-10 of ‖b‖ (reductions are summed in another order, and a converged
residual's norm carries the cancellation of b − Ax, so its own relative
error can reach eps/rtol); in f32 status is equal, niter within
±max(2, 10%) (the band of tests/reference_niter.json) and x to 1e-4
relative.
"""

import numpy as np
import jax.numpy as jnp
import pytest
torch = pytest.importorskip("torch")

import krylov_tpu.ops.pallas_fused as jf
from krylov_tpu.ops.dia import poisson_dia as jpoisson
from krylov_tpu.ops.pallas_dia import dia_align as jdia_align
from krylov_tpu_torch.ops import cuda_fused as tf
from krylov_tpu_torch.ops.cuda_dia import dia_align, offsets_tensor


def _problem(N=8, dtype=np.float64, seed=7, shift=0.0, jacobi=False):
    n = N ** 3
    D = jpoisson(N, N, N, dtype=dtype)
    data = np.array(D.data)
    zi = list(D.offsets).index(0)
    data[zi] -= shift
    dinv = None
    if jacobi:
        # a variable diagonal makes Jacobi non-trivial
        data[zi] = 6.0 + 0.5 * np.sin(np.arange(n))
        dinv = (1.0 / data[zi]).astype(dtype)
    b = np.random.default_rng(seed).standard_normal(n).astype(dtype)
    return data, D.offsets, b, dinv


def _operands(data, offs, b, dinv=None):
    n = b.shape[0]
    j = (jdia_align(jnp.asarray(data), offs, n), offs, jnp.asarray(b))
    t = (dia_align(torch.as_tensor(data), offs, n),
         offsets_tensor(offs, "cpu"), torch.as_tensor(b))
    jd = None if dinv is None else jnp.asarray(dinv)
    td = None if dinv is None else torch.as_tensor(dinv)
    return j, t, jd, td


def _np(outs):
    return [np.asarray(v) if hasattr(v, "shape") else v for v in outs]


def _rel(a, b):
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300)


def _same(j, t, ints, floats, f64=True, bnorm=1.0):
    """x (index 0), the int outputs (indices ``ints``; the status first)
    and the norms (``floats``), on a right-hand side of norm ``bnorm``."""
    j, t = _np(j), [v.numpy() for v in t]
    if f64:
        for i in ints:
            assert int(t[i]) == int(j[i]), (i, int(t[i]), int(j[i]))
        for i in floats:
            assert abs(float(t[i]) - float(j[i])) <= 1e-10 * bnorm
        assert _rel(t[0], j[0]) <= 1e-10
    else:
        assert int(t[ints[0]]) == int(j[ints[0]])
        assert _rel(t[0], j[0]) <= 1e-4


# ---------------------------------------------------------------------------
# Chebyshev-preconditioned CG
# ---------------------------------------------------------------------------

def _cheby(data, offs, b, atol, rtol, itmax, degree, lmin=0.4, lmax=12.2):
    (pj, oj, bj), (pt, ot, bt), _, _ = _operands(data, offs, b)
    j = jf.cg_cheby_dia_fused(pj, oj, bj, atol, rtol, itmax, lmin, lmax,
                              degree, interpret=True)
    t = tf.cg_cheby_dia_fused_ref(pt, ot, bt, atol, rtol, itmax, lmin,
                                  lmax, degree)
    return j, t


@pytest.mark.parametrize("degree", [1, 2, 8])
def test_cheby_ref_matches_jax_f64(degree):
    data, offs, b, _ = _problem()
    j, t = _cheby(data, offs, b, 0.0, 1e-8, 2 * b.shape[0], degree)
    assert int(t[3]) == 1
    # niter; status; posdef flag; then rnorm
    _same(j, t, (3, 1, 4), (2,), bnorm=np.linalg.norm(b))


@pytest.mark.parametrize("degree", [1, 8])
def test_cheby_ref_matches_jax_f32(degree):
    data, offs, b, _ = _problem(dtype=np.float32)
    j, t = _cheby(data, offs, b, 0.0, 1e-6, 2 * b.shape[0], degree)
    assert int(t[3]) == 1
    assert abs(int(t[1]) - int(j[1])) <= max(2, 0.1 * int(j[1]))
    _same(j, t, (3,), (), f64=False)


def test_cheby_ref_zero_rhs_and_cap():
    data, offs, b, _ = _problem()
    j, t = _cheby(data, offs, np.zeros_like(b), 0.0, 1e-6, 100, 4)
    assert int(t[1]) == 0 and int(t[3]) == 2           # ZERO_RESIDUAL
    assert float(t[0].abs().max()) == 0.0
    j, t = _cheby(data, offs, b, 0.0, 1e-14, 3, 4)
    assert int(t[1]) == 3 and int(t[3]) == 0           # RUNNING → TIRED
    _same(j, t, (3, 1, 4), (2,), bnorm=np.linalg.norm(b))


def test_cheby_ref_posdef_flag():
    """An interval far above the spectrum makes M indefinite."""
    data, offs, b, _ = _problem()
    j, t = _cheby(data, offs, b, 0.0, 1e-8, 50, 3, lmin=20.0, lmax=40.0)
    _same(j, t, (3, 1, 4), ())


def test_cheby_constants_round_as_jax():
    """θ and the step coefficients, in f32, equal the values the JAX
    kernel (bounds rounded first) and ChebyshevPreconditioner.matvec
    (f64 bounds) compute, exactly."""
    lmin, lmax = 0.1234567891, 12.345678912
    for round_bounds in (True, False):
        theta, steps = tf.cheby_constants(lmin, lmax, 4, torch.float32,
                                          round_bounds=round_bounds)
        if round_bounds:
            lo, hi = np.float32(lmin), np.float32(lmax)
            th = (hi + lo) * np.float32(0.5)
            de = (hi - lo) * np.float32(0.5)
        else:
            th = np.float32((lmax + lmin) / 2)
            de = np.float32((lmax - lmin) / 2)
        sigma = th / de
        rho = np.float32(1) / sigma
        assert theta == float(th)
        for c1, c2 in steps:
            rho_n = np.float32(1) / (np.float32(2) * sigma - rho)
            assert c1 == float(rho_n * rho)
            assert c2 == float(np.float32(2) * rho_n / de)
            rho = rho_n


# ---------------------------------------------------------------------------
# CR and CAR
# ---------------------------------------------------------------------------

def _cr(kind, data, offs, b, atol, rtol, itmax):
    (pj, oj, bj), (pt, ot, bt), _, _ = _operands(data, offs, b)
    j = getattr(jf, f"{kind}_dia_fused")(pj, oj, bj, atol, rtol, itmax,
                                         interpret=True)
    t = getattr(tf, f"{kind}_dia_fused_ref")(pt, ot, bt, atol, rtol, itmax)
    return j, t


# CR returns (x, niter, rnorm, status, indef); CAR (x, niter, rnorm,
# arnorm, status)
_LAYOUT = {"cr": ((3, 1, 4), (2,)), "car": ((4, 1), (2, 3))}


@pytest.mark.parametrize("kind", ["cr", "car"])
def test_cr_car_ref_matches_jax_f64(kind):
    data, offs, b, _ = _problem()
    j, t = _cr(kind, data, offs, b, 0.0, 1e-8, 2 * b.shape[0])
    ints, floats = _LAYOUT[kind]
    assert int(t[ints[0]]) == 1
    _same(j, t, ints, floats, bnorm=np.linalg.norm(b))


@pytest.mark.parametrize("kind", ["cr", "car"])
def test_cr_car_ref_matches_jax_f32(kind):
    data, offs, b, _ = _problem(dtype=np.float32)
    j, t = _cr(kind, data, offs, b, 0.0, 1e-6, 2 * b.shape[0])
    ints, _ = _LAYOUT[kind]
    assert int(t[ints[0]]) == 1
    assert abs(int(t[1]) - int(j[1])) <= max(2, 0.1 * int(j[1]))
    _same(j, t, ints, (), f64=False)


@pytest.mark.parametrize("kind", ["cr", "car"])
@pytest.mark.parametrize("itmax", [3, 70])
def test_cr_car_ref_itmax_cap(kind, itmax):
    """The cap stops the solve with status RUNNING, also past the first
    chunk of 64 iterations."""
    data, offs, b, _ = _problem(N=12)
    j, t = _cr(kind, data, offs, 1e6 * b, 0.0, 1e-14, itmax)
    ints, floats = _LAYOUT[kind]
    assert int(t[1]) == itmax and int(t[ints[0]]) == 0
    _same(j, t, ints, floats, bnorm=np.linalg.norm(b))


@pytest.mark.parametrize("kind", ["cr", "car"])
def test_cr_car_ref_zero_rhs(kind):
    data, offs, b, _ = _problem()
    j, t = _cr(kind, data, offs, np.zeros_like(b), 0.0, 1e-6, 100)
    ints, _ = _LAYOUT[kind]
    assert int(t[1]) == 0 and int(t[ints[0]]) == 2     # ZERO_RESIDUAL
    assert float(t[0].abs().max()) == 0.0
    _same(j, t, ints, ())


def test_cr_ref_indefinite_flag():
    """A shifted stencil with negative eigenvalues raises the indef flag
    in both kernels (20 iterations, before the unstable recurrence of an
    indefinite CR drifts)."""
    data, offs, b, _ = _problem(shift=8.0)
    j, t = _cr("cr", data, offs, b, 0.0, 1e-8, 20)
    assert int(t[4]) == int(j[4]) == 1
    _same(j, t, (3, 1, 4), (2,), bnorm=np.linalg.norm(b))


# ---------------------------------------------------------------------------
# MINRES
# ---------------------------------------------------------------------------

def _minres(data, offs, b, dinv, atol, rtol, itmax, lam=0.0, etol=None,
            ctol=1e-8, window=5):
    etol = rtol if etol is None else etol
    (pj, oj, bj), (pt, ot, bt), jd, td = _operands(data, offs, b, dinv)
    j = jf.minres_dia_fused(pj, oj, bj, atol, rtol, etol, ctol, lam, itmax,
                            window=window, dinv=jd, interpret=True)
    t = tf.minres_dia_fused_ref(pt, ot, bt, atol, rtol, etol, ctol, lam,
                                itmax, window, td)
    return j, t


# (x, niter, rnorm, status, inconsistent, precond_violation)
_MR = ((3, 1, 4, 5), (2,))


@pytest.mark.parametrize("lam,jacobi", [(0.0, False), (0.5, False),
                                        (0.0, True)],
                         ids=["M=I", "lambda", "jacobi"])
def test_minres_ref_matches_jax_f64(lam, jacobi):
    data, offs, b, dinv = _problem(jacobi=jacobi)
    j, t = _minres(data, offs, b, dinv, 0.0, 1e-8, 2 * b.shape[0], lam=lam)
    assert int(t[3]) not in (0, 11, 23)                # a solved code
    _same(j, t, *_MR, bnorm=np.linalg.norm(b))


@pytest.mark.parametrize("jacobi", [False, True])
def test_minres_ref_matches_jax_f32(jacobi):
    data, offs, b, dinv = _problem(dtype=np.float32, jacobi=jacobi)
    j, t = _minres(data, offs, b, dinv, 0.0, 1e-6, 2 * b.shape[0])
    assert abs(int(t[1]) - int(j[1])) <= max(2, 0.1 * int(j[1]))
    _same(j, t, *_MR, f64=False)


@pytest.mark.parametrize("shift,kw", [
    (2.35, {}), (0.0, dict(window=3, etol=1e-3)),
    (0.0, dict(window=7, etol=1e-6)), (2.35, dict(ctol=0.5))],
    ids=["indefinite", "window3", "window7", "conlim"])
def test_minres_ref_status_overrides(shift, kw):
    """An indefinite stencil (shift 2.35 keeps every eigenvalue 0.1 or
    more from 0), the forward-error window stop at widths 3 and 7, and a
    tight conlim: the status overrides run in the kernel's order."""
    data, offs, b, _ = _problem(shift=shift)
    j, t = _minres(data, offs, b, None, 0.0, 1e-10, 300, **kw)
    _same(j, t, *_MR, bnorm=np.linalg.norm(b))


@pytest.mark.parametrize("itmax", [3, 70])
def test_minres_ref_itmax_cap(itmax):
    data, offs, b, _ = _problem(N=12)
    j, t = _minres(data, offs, b, None, 0.0, 1e-14, itmax)
    assert int(t[1]) == itmax and int(t[3]) == 0
    _same(j, t, *_MR, bnorm=np.linalg.norm(b))


def test_minres_ref_zero_rhs_and_violation():
    data, offs, b, dinv = _problem(jacobi=True)
    j, t = _minres(data, offs, np.zeros_like(b), None, 0.0, 1e-6, 100)
    assert int(t[1]) == 0 and int(t[3]) == 2
    _same(j, t, *_MR, bnorm=np.linalg.norm(b))
    j, t = _minres(data, offs, b, -dinv, 0.0, 1e-8, 50)
    assert int(t[5]) == int(j[5]) == 1
    _same(j, t, *_MR, bnorm=np.linalg.norm(b))


# ---------------------------------------------------------------------------
# the wrappers on the CPU, and the gates
# ---------------------------------------------------------------------------

def test_wrappers_take_plain_versions_on_cpu():
    data, offs, b, dinv = _problem(jacobi=True)
    _, (pt, ot, bt), _, td = _operands(data, offs, b, dinv)
    calls = [
        (tf.cg_cheby_dia_fused, tf.cg_cheby_dia_fused_ref,
         (0.0, 1e-8, 500, 0.4, 12.2, 4), {}),
        (tf.cr_dia_fused, tf.cr_dia_fused_ref, (0.0, 1e-8, 500), {}),
        (tf.car_dia_fused, tf.car_dia_fused_ref, (0.0, 1e-8, 500), {}),
        (tf.minres_dia_fused, tf.minres_dia_fused_ref,
         (0.0, 1e-8, 1e-8, 1e-8, 0.0, 500), {"dinv": td}),
    ]
    for wrapper, ref, args, kw in calls:
        before = wrapper.launches
        got = wrapper(pt, ot, bt, *args, **kw)
        want = ref(pt, ot, bt, *args, **kw)
        assert wrapper.launches == before
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    with pytest.raises(ValueError):
        tf.minres_dia_fused(pt, ot, bt, 0.0, 1e-8, 1e-8, 1e-8, 0.0, 10,
                            dinv=torch.ones(3, dtype=torch.float64))
    with pytest.raises(ValueError):
        tf.minres_dia_fused(pt, ot, bt, 0.0, 1e-8, 1e-8, 1e-8, 0.0, 10,
                            window=0)
    with pytest.raises(ValueError):
        tf.cg_cheby_dia_fused(pt, ot, bt, 0.0, 1e-8, 10, 0.4, 12.2, 0)


@pytest.mark.parametrize("gate", [tf.cg_cheby_dia_fused_supported,
                                  tf.cr_dia_fused_supported,
                                  tf.car_dia_fused_supported,
                                  tf.minres_dia_fused_supported])
def test_supported_gates(gate):
    offs = (-1, 0, 1)
    assert gate(offs, 10, torch.float32)
    assert gate(offs, 10, torch.float32, stencil_dtype=torch.bfloat16)
    assert gate(offs, 10, torch.float64)
    assert gate(offs, 512 ** 3, torch.float32)   # no VMEM-size gate
    assert not gate(offs, 10, torch.float64, stencil_dtype=torch.float32)
    assert not gate(offs, 10, torch.float16)
    assert not gate(offs, 10, torch.complex64)
