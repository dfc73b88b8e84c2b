"""krylov_tpu_torch's twelve Krylov processes against krylov_tpu.processes,
and the three checks of tests/test_processes.py (orthonormality, the
first vector, the factorisation residual), in f64 and c128.

Inputs are made with numpy from a seed (or the fixture generators) and
given to both packages.  Tolerances: the bases and coefficient matrices
agree to 1e-10 relative (the same Gram–Schmidt and Householder
recurrences, LAPACK's QR in both, the sums taken in another order:
measured 1e-14 at most), the complex block Lanczos basis of the
Hermitian fixture up to the phases of its columns (``_same``); the
checks keep tests/test_processes.py's own bounds.  The breakdown messages are the reference's text, as the JAX
package raises them.
"""

import numpy as np
import pytest
torch = pytest.importorskip("torch")

import fixtures as fx
import krylov_tpu.processes as jp
import krylov_tpu_torch as kt
from krylov_tpu_torch import processes as tp

TOL = 1e-10


@pytest.fixture(params=[np.float64, np.complex128], ids=["f64", "c128"])
def FC(request):
    return request.param


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _np(v):
    return v.resolve_conj().cpu().numpy() if isinstance(v, torch.Tensor) \
        else np.asarray(v)


def _same(got, want, tol=TOL, moduli=False):
    """Every output of a process, element for element, to ``tol`` relative
    (scalars and arrays alike); with ``moduli`` their moduli: a complex
    Householder QR fixes each column's phase by the sign of a real part,
    which is a rounding tie where that part is 0 (the Hermitian fixture's
    imaginary off-diagonals give such columns), and another phase turns
    V into V D and the coefficients into Dᴴ T D, D diagonal and unitary,
    which keeps the moduli."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = _np(g), _np(w)
        if moduli:
            g, w = np.abs(g), np.abs(w)
        assert g.shape == w.shape
        assert np.max(np.abs(g - w), initial=0.0) \
            <= tol * max(np.max(np.abs(w), initial=0.0), 1.0)


def ortho(V, tol=1e-4):
    V = _np(V)
    G = V.conj().T @ V
    return np.linalg.norm(G - np.eye(G.shape[0])) <= tol


def _rand(rng, shape, FC):
    a = rng.standard_normal(shape)
    if np.issubdtype(np.dtype(FC), np.complexfloating):
        a = a + 1j * rng.standard_normal(shape)
    return a.astype(FC)


def test_hermitian_lanczos(FC):
    A, b = fx.symmetric_definite(FC=FC)
    A = np.asarray(A)
    for reorth in (False, True):
        got = tp.hermitian_lanczos(_t(A), _t(b), 6,
                                   reorthogonalization=reorth)
        _same(got, jp.hermitian_lanczos(A, b, 6,
                                        reorthogonalization=reorth))
    V, beta1, T = map(_np, got)
    assert ortho(V) and np.allclose(beta1 * V[:, 0], b)
    assert np.linalg.norm(A @ V[:, :6] - V @ T) <= 1e-10


def test_nonhermitian_lanczos(FC):
    rng = np.random.default_rng(7)
    A = _rand(rng, (12, 12), FC) + 6 * np.eye(12)
    b = rng.standard_normal(12).astype(FC)
    c = rng.standard_normal(12).astype(FC)
    got = tp.nonhermitian_lanczos(_t(A), _t(b), _t(c), 6)
    _same(got, jp.nonhermitian_lanczos(A, b, c, 6))
    V, _, T, U, _, Th = map(_np, got)
    assert np.linalg.norm(A @ V[:, :6] - V @ T) <= 1e-8
    assert np.linalg.norm(A.conj().T @ U[:, :6] - U @ Th) <= 1e-8
    assert np.linalg.norm(U.conj().T @ V - np.eye(7)) <= 1e-6


def test_arnoldi(FC):
    rng = np.random.default_rng(8)
    A = _rand(rng, (12, 12), FC)
    b = rng.standard_normal(12).astype(FC)
    got = tp.arnoldi(_t(A), _t(b), 6)
    _same(got, jp.arnoldi(A, b, 6))
    V, beta, H = map(_np, got)
    assert ortho(V) and np.allclose(beta * V[:, 0], b)
    assert np.linalg.norm(A @ V[:, :6] - V @ H) <= 1e-10
    A, b = fx.symmetric_definite(n=30)
    got = tp.arnoldi(_t(A), _t(b), 10, reorthogonalization=True)
    _same(got, jp.arnoldi(np.asarray(A), b, 10, reorthogonalization=True))
    assert ortho(got[0], tol=1e-10)


def test_golub_kahan(FC):
    rng = np.random.default_rng(9)
    A = _rand(rng, (20, 12), FC)
    b = rng.standard_normal(20).astype(FC)
    got = tp.golub_kahan(_t(A), _t(b), 5)
    _same(got, jp.golub_kahan(A, b, 5))
    V, U, beta1, L = map(_np, got)
    assert ortho(V) and ortho(U) and np.allclose(beta1 * U[:, 0], b)
    assert np.linalg.norm(A.conj().T @ U - V @ L.conj().T) <= 1e-8


def test_saunders_simon_yip(FC):
    A, b, c = fx.square_adjoint(n=20, FC=FC)
    A = np.asarray(A)
    got = tp.saunders_simon_yip(_t(A), _t(b), _t(c), 6)
    _same(got, jp.saunders_simon_yip(A, b, c, 6))
    V, _, T, U, _, Th = map(_np, got)
    assert ortho(V) and ortho(U)
    assert np.linalg.norm(A @ U[:, :6] - V @ T) <= 1e-8
    assert np.linalg.norm(A.conj().T @ V[:, :6] - U @ Th) <= 1e-8


def test_montoison_orban(FC):
    rng = np.random.default_rng(3)
    A = rng.standard_normal((15, 12)).astype(FC)
    B = rng.standard_normal((12, 15)).astype(FC)
    b = rng.standard_normal(15).astype(FC)
    c = rng.standard_normal(12).astype(FC)
    for reorth in (False, True):
        got = tp.montoison_orban(_t(A), _t(B), _t(b), _t(c), 5,
                                 reorthogonalization=reorth)
        _same(got, jp.montoison_orban(A, B, b, c, 5,
                                      reorthogonalization=reorth))
    V, _, H, U, _, F = map(_np, got)
    assert ortho(V) and ortho(U)
    assert np.linalg.norm(A @ U[:, :5] - V @ H) <= 1e-8
    assert np.linalg.norm(B @ V[:, :5] - U @ F) <= 1e-8


@pytest.mark.parametrize("algo", ["householder", "gs", "mgs"])
def test_block_hermitian_lanczos_and_arnoldi(FC, algo):
    A, _ = fx.symmetric_definite(n=16, FC=FC)
    A = np.asarray(A)
    B = np.random.default_rng(0).standard_normal((16, 2)).astype(FC)
    got = tp.block_hermitian_lanczos(_t(A), _t(B), 4, algo=algo)
    _same(got, jp.block_hermitian_lanczos(A, B, 4, algo=algo),
          moduli=algo == "householder" and FC == np.complex128)
    V, _, T = map(_np, got)
    assert ortho(V, tol=1e-8)
    assert np.linalg.norm(A @ V[:, :8] - V @ T) <= 1e-8
    rng = np.random.default_rng(1)
    A = _rand(rng, (16, 16), FC)
    B = rng.standard_normal((16, 2)).astype(FC)
    for reorth in (False, True):
        got = tp.block_arnoldi(_t(A), _t(B), 4, algo=algo,
                               reorthogonalization=reorth)
        _same(got, jp.block_arnoldi(A, B, 4, algo=algo,
                                    reorthogonalization=reorth))
    V, _, H = map(_np, got)
    assert ortho(V, tol=1e-8)
    assert np.linalg.norm(A @ V[:, :8] - V @ H) <= 1e-8


def test_block_golub_kahan_and_ssy(FC):
    rng = np.random.default_rng(2)
    A = _rand(rng, (20, 12), FC)
    B = rng.standard_normal((20, 2)).astype(FC)
    got = tp.block_golub_kahan(_t(A), _t(B), 3)
    _same(got, jp.block_golub_kahan(A, B, 3))
    V, U, _, L = map(_np, got)
    assert ortho(V, tol=1e-8) and ortho(U, tol=1e-8)
    assert np.linalg.norm(A.conj().T @ U - V @ L.conj().T) <= 1e-8
    rng = np.random.default_rng(4)
    A = _rand(rng, (18, 14), FC)
    b = rng.standard_normal((18, 2)).astype(FC)
    c = rng.standard_normal((14, 2)).astype(FC)
    got = tp.block_saunders_simon_yip(_t(A), _t(b), _t(c), 3)
    _same(got, jp.block_saunders_simon_yip(A, b, c, 3))
    V, _, T, U, _, Th = map(_np, got)
    assert ortho(V, tol=1e-8) and ortho(U, tol=1e-8)
    assert np.linalg.norm(A @ U[:, :6] - V @ T) <= 1e-8


def test_block_montoison_orban_and_nonhermitian_lanczos(FC):
    rng = np.random.default_rng(5)
    A = _rand(rng, (15, 12), FC)
    B = _rand(rng, (12, 15), FC)
    D = rng.standard_normal((15, 2)).astype(FC)
    C = rng.standard_normal((12, 2)).astype(FC)
    got = tp.block_montoison_orban(_t(A), _t(B), _t(D), _t(C), 3)
    _same(got, jp.block_montoison_orban(A, B, D, C, 3))
    V, _, H, U, _, F = map(_np, got)
    assert ortho(V, tol=1e-8) and ortho(U, tol=1e-8)
    assert np.linalg.norm(A @ U[:, :6] - V @ H) <= 1e-8
    assert np.linalg.norm(B @ V[:, :6] - U @ F) <= 1e-8
    rng = np.random.default_rng(6)
    A = _rand(rng, (16, 16), FC) + 8 * np.eye(16)
    B = rng.standard_normal((16, 2)).astype(FC)
    C = rng.standard_normal((16, 2)).astype(FC)
    got = tp.block_nonhermitian_lanczos(_t(A), _t(B), _t(C), 3)
    _same(got, jp.block_nonhermitian_lanczos(A, B, C, 3), tol=1e-8)
    V, _, T, U, _, _ = map(_np, got)
    assert np.linalg.norm(U.conj().T @ V - np.eye(8)) <= 1e-6
    assert np.linalg.norm(A @ V[:, :6] - V @ T) <= 1e-6


def test_breakdowns_raise_with_the_reference_text():
    """A breakdown raises with the JAX package's message, and
    ``allow_breakdown=True`` completes the basis with zeros as it does."""
    A, b = fx.symmetric_breakdown()
    for fn, args in ((tp.hermitian_lanczos, (A, b, 2)),
                     (tp.arnoldi, (A, b, 2))):
        jfn = getattr(jp, fn.__name__)
        with pytest.raises(ValueError) as want:
            jfn(*args)
        with pytest.raises(ValueError) as got:
            fn(_t(args[0]), _t(args[1]), args[2])
        assert str(got.value) == str(want.value) \
            and "Exact breakdown" in str(got.value)
        _same(fn(_t(A), _t(b), 2, allow_breakdown=True),
              jfn(A, b, 2, allow_breakdown=True))
    z = np.zeros(2)
    for name, args in (("golub_kahan", (A, z, 2)),
                       ("saunders_simon_yip", (A, z, b, 2)),
                       ("nonhermitian_lanczos", (A, b, np.array([0.0, 1.0]),
                                                 2)),
                       ("montoison_orban", (A, A, b, z, 2))):
        with pytest.raises(ValueError) as want:
            getattr(jp, name)(*args)
        with pytest.raises(ValueError) as got:
            getattr(tp, name)(*(_t(a) if isinstance(a, np.ndarray) else a
                                for a in args))
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="unknown block QR algo"):
        tp._block_qr(torch.ones((4, 2)), "qr_magic")


def test_processes_exported_and_on_operators():
    """The twelve processes are on the top level, and take the port's
    operators: a CSR matrix (its adjoint built on the host) gives the
    dense matrix's Golub–Kahan factors."""
    for name in ("hermitian_lanczos", "nonhermitian_lanczos", "arnoldi",
                 "golub_kahan", "saunders_simon_yip", "montoison_orban",
                 "block_hermitian_lanczos", "block_nonhermitian_lanczos",
                 "block_arnoldi", "block_golub_kahan",
                 "block_saunders_simon_yip", "block_montoison_orban"):
        assert getattr(kt, name) is getattr(tp, name)
    rng = np.random.default_rng(10)
    A = np.where(rng.random((20, 12)) < 0.4,
                 rng.standard_normal((20, 12)), 0.0)
    b = rng.standard_normal(20)
    want = tp.golub_kahan(_t(A), _t(b), 4)
    got = tp.golub_kahan(kt.csr_from_dense(_t(A)), _t(b), 4)
    _same(got, want, tol=1e-12)
