"""The port's mixed-precision sweep, the counterpart of ``test_mp.py`` and
``test_mp_full.py``: the same systems, built from numpy with a torch
``_mk``, solved through ``krylov_tpu_torch`` on the CPU in bfloat16,
float32 and float64 (and complex64/complex128), held to the same bars
(√eps(T), ×10 for bfloat16, times the JAX tests' slack) with the same
``BF16_EXCLUDE``, and x in the input's dtype."""

import numpy as np
import pytest
torch = pytest.importorskip("torch")

import fixtures as fx
import krylov_tpu_torch as kt
from test_mp import RECT, SQUARE
from test_mp_full import BF16_EXCLUDE

REAL = [torch.bfloat16, torch.float32, torch.float64]
REAL_IDS = ["bf16", "f32", "f64"]
COMPLEX = [torch.complex64, torch.complex128]
COMPLEX_IDS = ["c64", "c128"]


def tol_for(dtype):
    t = np.sqrt(float(torch.finfo(dtype).eps))
    return 10 * t if dtype == torch.bfloat16 else t


def _mk(dtype, arr):
    return torch.as_tensor(np.asarray(arr)).to(dtype)


def _f64(v, cplx):
    return v.to(torch.complex128 if cplx else torch.float64).numpy()


def drive_method(method, dtype, n=10, m=14):
    """``fixtures.drive_method`` through the port: the same systems (by
    its matrix builders' definitions and its seed), the same natural
    residual, computed in f64.  Returns (residual, stats, extras)."""
    cplx = dtype.is_complex
    rng = np.random.default_rng(42)

    def spd(k):
        A = np.diag(4.0 * np.ones(k)) + np.diag(-np.ones(k - 1), 1) \
            + np.diag(-np.ones(k - 1), -1)
        if cplx:
            A = A.astype(np.complex128)
            od = (0.5 + 0.25j) * np.ones(k - 1)
            A += np.diag(od, 1) + np.diag(od.conj(), -1)
        return A

    def nonsym(k):
        A = np.diag(4.0 * np.ones(k)) + np.diag(-2.0 * np.ones(k - 1), -1) \
            + np.diag(-np.ones(k - 1), 1)
        if cplx:
            A = A.astype(np.complex128) + 0.3j * np.diag(np.ones(k))
        return A

    def tall(mm, nn):
        A = np.zeros((mm, nn))
        for i in range(mm):
            if i < nn:
                A[i, i] = 2.0 + 0.05 * i
            if 0 <= i - 1 < nn:
                A[i, i - 1] = 0.5
        if cplx:
            A = A.astype(np.complex128)
            A[0, 0] += 0.25j
        return A

    def f64(v):
        return np.asarray(v, dtype=np.complex128 if cplx else np.float64)

    def x64(v):
        return _f64(v, cplx)

    def rel(r, b):
        return float(np.linalg.norm(r) / np.linalg.norm(b))

    if method in fx.SPD_METHODS or method in fx.NONSYM_METHODS:
        A = spd(n) if method in fx.SPD_METHODS else nonsym(n)
        b = A @ np.ones(n)
        x, stats = kt.krylov_solve(method, _mk(dtype, A), _mk(dtype, b))
        return rel(f64(b) - f64(A) @ x64(x), b), stats, {"x": x}

    if method == "cg_lanczos_shift":
        A = spd(n)
        b = A @ np.ones(n)
        x, stats = kt.cg_lanczos_shift(_mk(dtype, A), _mk(dtype, b),
                                       [0.0, 0.5])
        r = f64(b) - (f64(A) + 0.5 * np.eye(n)) @ x64(x[1])
        return rel(r, b), stats, {"x": x}

    if method in fx.USYM_METHODS:
        A = nonsym(n)
        b = A @ np.ones(n)
        c = b + 0.1 * rng.standard_normal(n)
        x, stats = kt.krylov_solve(method, _mk(dtype, A), _mk(dtype, b),
                                   c=_mk(dtype, c))
        return rel(f64(b) - f64(A) @ x64(x), b), stats, {"x": x}

    if method in fx.LS_METHODS or method == "cgls_lanczos_shift":
        A = tall(m, n)
        b = A @ np.ones(n) + 0.01 * np.concatenate(
            [np.zeros(n), np.ones(m - n)])
        if method == "cgls_lanczos_shift":
            x, stats = kt.cgls_lanczos_shift(_mk(dtype, A), _mk(dtype, b),
                                             [0.0, 0.1])
            xx = x64(x[0])
        else:
            x, stats = kt.krylov_solve(method, _mk(dtype, A), _mk(dtype, b))
            xx = x64(x)
        Ar = f64(A).conj().T @ (f64(b) - f64(A) @ xx)
        return rel(Ar, b), stats, {"x": x}

    if method in fx.LN_METHODS:
        A = tall(m, n).conj().T
        b = A @ np.ones(m)
        out = kt.krylov_solve(method, _mk(dtype, A), _mk(dtype, b))
        x, stats = out[0], out[-1]
        return rel(f64(b) - f64(A) @ x64(x), b), stats, {"x": x}

    if method in fx.TWO_OUT_SQ:
        A = nonsym(n)
        b = A @ np.ones(n)
        c = A.conj().T @ np.ones(n)
        x, y, stats = kt.bilqr(_mk(dtype, A), _mk(dtype, b), _mk(dtype, c))
        r = f64(b) - f64(A) @ x64(x)
        s = f64(c) - f64(A).conj().T @ x64(y)
        rr = np.sqrt(np.linalg.norm(r) ** 2 + np.linalg.norm(s) ** 2)
        return float(rr / np.linalg.norm(b)), stats, {"x": x, "y": y}

    if method in fx.RECT_PAIR:
        A = tall(m, n)
        if method == "trilqr":
            b = A @ np.ones(n)
            c = rng.standard_normal(n)
            x, y, stats = kt.trilqr(_mk(dtype, A), _mk(dtype, b),
                                    _mk(dtype, c))
            s = f64(c) - f64(A).conj().T @ x64(y)
            return rel(s, c), stats, {"x": x, "y": y}
        if method == "usymlqr":
            xs = 0.1 * rng.standard_normal(m)
            ys = rng.standard_normal(n)
            b = np.asarray(A @ ys)
            c = np.asarray(A.conj().T @ xs)
            x, y, stats = kt.usymlqr(_mk(dtype, A), _mk(dtype, b),
                                     _mk(dtype, c))
            top = f64(b) - (x64(x) + f64(A) @ x64(y))
            bot = f64(c) - f64(A).conj().T @ x64(x)
            rr = np.sqrt(np.linalg.norm(top) ** 2 + np.linalg.norm(bot) ** 2)
            return float(rr / np.linalg.norm(b)), stats, {"x": x, "y": y}
        A = 0.3 * A
        b = rng.standard_normal(m)
        c = rng.standard_normal(n)
        fn = kt.tricg if method == "tricg" else kt.trimr
        x, y, stats = fn(_mk(dtype, A), _mk(dtype, b), _mk(dtype, c))
        top = f64(b) - (x64(x) + f64(A) @ x64(y))
        bot = f64(c) - (f64(A).conj().T @ x64(x) - x64(y))
        rr = np.sqrt(np.linalg.norm(top) ** 2 + np.linalg.norm(bot) ** 2)
        return float(rr / np.linalg.norm(b)), stats, {"x": x, "y": y}

    if method == "gpmr":
        A = tall(m, n)
        B = A.conj().T
        b = rng.standard_normal(m)
        c = rng.standard_normal(n)
        x, y, stats = kt.gpmr(_mk(dtype, A), _mk(dtype, B), _mk(dtype, b),
                              _mk(dtype, c))
        top = f64(b) - (x64(x) + f64(A) @ x64(y))
        bot = f64(c) - (f64(B) @ x64(x) + x64(y))
        rr = np.sqrt(np.linalg.norm(top) ** 2 + np.linalg.norm(bot) ** 2)
        return float(rr / np.linalg.norm(b)), stats, {"x": x, "y": y}

    if method in ("block_minres", "block_gmres"):
        A = spd(n) if method == "block_minres" else nonsym(n)
        Bm = A @ np.ones((n, 2))
        fn = kt.block_minres if method == "block_minres" else kt.block_gmres
        X, stats = fn(_mk(dtype, A), _mk(dtype, Bm))
        R = f64(Bm) - f64(A) @ x64(X)
        return float(np.linalg.norm(R) / np.linalg.norm(Bm)), stats, \
            {"x": X}

    raise ValueError(f"unknown method {method}")


def _slack(method):
    return 100 if method in ("usymlqr", "tricg", "trimr", "gpmr") else 20


# test_mp.py's TestMixedPrecision: MINRES-QLP in bf16 is its expected
# failure there (BF16_EXCLUDE), so that case is left out here
SQUARE_CASES = [(m, d) for d in REAL for m in SQUARE
                if not (d == torch.bfloat16 and m == "minres_qlp")]


@pytest.mark.parametrize(
    "method,dtype", SQUARE_CASES,
    ids=[f"{REAL_IDS[REAL.index(d)]}-{m}" for m, d in SQUARE_CASES])
def test_square(method, dtype):
    n = 10
    A = np.diag(4.0 * np.ones(n)) + np.diag(-np.ones(n - 1), 1) \
        + np.diag(-np.ones(n - 1), -1)
    b = A @ np.ones(n)
    x, stats = kt.krylov_solve(method, _mk(dtype, A), _mk(dtype, b))
    assert x.dtype == dtype
    r = b - A @ _f64(x, False)
    assert np.linalg.norm(r) / np.linalg.norm(b) <= 20 * tol_for(dtype), \
        (method, stats.status)


@pytest.mark.parametrize("dtype", REAL, ids=REAL_IDS)
@pytest.mark.parametrize("method", RECT)
def test_rectangular(method, dtype):
    b0, A0, *_ = fx.gen_lsq(15, 8, 1, 1, 0.0)
    x, stats = kt.krylov_solve(method, _mk(dtype, A0), _mk(dtype, b0))
    assert x.dtype == dtype
    Ar = A0.T @ (b0 - A0 @ _f64(x, False))
    assert np.linalg.norm(Ar) / np.linalg.norm(b0) <= 100 * tol_for(dtype), \
        (method, stats.status)


@pytest.mark.parametrize("dtype", COMPLEX, ids=COMPLEX_IDS)
def test_complex_propagation(dtype):
    A, b = fx.symmetric_definite(n=10, FC=np.complex128)
    for method in ("cg", "minres", "gmres", "bicgstab"):
        x, stats = kt.krylov_solve(method, _mk(dtype, np.asarray(A)),
                                   _mk(dtype, b))
        assert x.dtype == dtype, method


REAL_BASKET = [(m, d) for d in REAL for m in fx.ALL_METHODS
               if not (d == torch.bfloat16 and m in BF16_EXCLUDE)]


@pytest.mark.parametrize(
    "method,dtype", REAL_BASKET,
    ids=[f"{m}-{REAL_IDS[REAL.index(d)]}" for m, d in REAL_BASKET])
def test_real_full_basket(method, dtype):
    rr, stats, extras = drive_method(method, dtype)
    assert rr <= _slack(method) * tol_for(dtype), (method, stats.status, rr)
    for v in extras.values():
        assert v.dtype == dtype, method


@pytest.mark.parametrize("dtype", COMPLEX, ids=COMPLEX_IDS)
@pytest.mark.parametrize("method", fx.ALL_METHODS)
def test_complex_full_basket(method, dtype):
    rr, stats, extras = drive_method(method, dtype)
    assert rr <= _slack(method) * tol_for(dtype), (method, stats.status, rr)
    assert extras["x"].is_complex() and extras["x"].dtype == dtype, method
