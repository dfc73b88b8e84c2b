"""krylov_tpu_torch's DIA + SELL analysis of a CSR matrix
(``ops/hybrid.py``), ``HybridOperator`` and the CSR routing of
``as_operator`` against krylov_tpu's (tests/test_sell_hybrid.py:71-172),
the JAX SELL kernel in interpret mode.

Inputs are made with numpy from a seed and given to both packages.
Tolerances: the analysis gives equal arrays; the products agree to 1e-12
of max|y| in f64 and 1e-5 in f32; the solves, in f64, give the JAX
package's status and niter with x within 1e-8 relative.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import scipy.sparse as sp
torch = pytest.importorskip("torch")

import krylov_tpu as kj
from krylov_tpu.ops import hybrid as jh
from krylov_tpu.ops import pallas_sell as js
from krylov_tpu.ops.sparse import CSRMatrix as JCSRMatrix
from krylov_tpu.ops.sparse import csr_from_coo as jcsr_from_coo
import krylov_tpu_torch as kt
from krylov_tpu_torch.convert import csr_from_numpy
from krylov_tpu_torch.ops import cuda_sell as ts
from krylov_tpu_torch.ops import hybrid as th
from krylov_tpu_torch.ops.sparse import CSRMatrix


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300)


def _jcsr(A, dtype=None):
    coo = sp.coo_matrix(A)
    return jcsr_from_coo(coo.row, coo.col, coo.data, A.shape, dtype=dtype)


def _tcsr(C):
    """The port's copy of a krylov_tpu CSRMatrix, on the CPU."""
    return csr_from_numpy(np.asarray(C.data), np.asarray(C.indices),
                          np.asarray(C.indptr), np.asarray(C.rows), C.shape,
                          device="cpu")


def _assert_same_csr(t, j):
    assert isinstance(t, CSRMatrix) and t.shape == j.shape
    for f in ("data", "indices", "indptr", "rows"):
        assert np.array_equal(getattr(t, f).numpy(),
                              np.asarray(getattr(j, f))), f


def _assert_same_dia(t, j):
    assert (t is None) == (j is None)
    if j is not None:
        assert t.offsets == tuple(j.offsets) and t.shape == j.shape
        assert np.array_equal(t.data.numpy(), np.asarray(j.data))
        assert t.nnz == j.nnz


def _assert_same_hybrid(t, j):
    """The port's HybridMatrix holds the JAX one's parts."""
    _assert_same_dia(t.dia, j.dia)
    assert t.shape == j.shape and t.nnz == j.nnz and t.dia_pd is None
    if j.sell is None:
        assert t.sell is None
    elif isinstance(j.sell, JCSRMatrix):
        _assert_same_csr(t.sell, j.sell)
    elif isinstance(j.sell, js.SELLBucketed):
        assert isinstance(t.sell, ts.SELLBucketed)
        assert len(t.sell.parts) == len(j.sell.parts)
        assert (t.sell.row_pos is None) == (j.sell.row_pos is None)
        for tp, jp in zip(t.sell.parts, j.sell.parts):
            for f in ("data", "idx", "slice_of", "chunk_of"):
                assert np.array_equal(getattr(tp, f).numpy(),
                                      np.asarray(getattr(jp, f))), f
    else:
        assert isinstance(t.sell, ts.SELLMatrix)
        for f in ("data", "idx", "slice_of", "chunk_of"):
            assert np.array_equal(getattr(t.sell, f).numpy(),
                                  np.asarray(getattr(j.sell, f))), f
        assert t.sell.covered == j.sell.covered


def _skewed(n, seed, w=300, nheavy=150, hdeg=120):
    """tests/test_sell_hybrid.py:178-190."""
    rng = np.random.default_rng(seed)
    deg = np.full(n, 7)
    heavy = n - 1 - rng.choice(2048, nheavy, replace=False)
    deg[heavy] = hdeg
    r = np.repeat(np.arange(n, dtype=np.int64), deg)
    c = np.clip(r + rng.integers(-w, w + 1, size=r.size), 0, n - 1)
    A = sp.coo_matrix((rng.standard_normal(r.size), (r, c)),
                      shape=(n, n)).tocsr()
    A.sum_duplicates()
    return A


def _mixed(n=1024):
    """tests/test_sell_hybrid.py:87-103: three dense diagonals and 300
    scattered entries."""
    A = sp.diags([1.5, 4.0, 1.5], [-2, 0, 2], (n, n)).tolil()
    rng = np.random.default_rng(9)
    for _ in range(300):
        A[rng.integers(n), rng.integers(n)] = rng.standard_normal()
    return A.tocsr()


def _scattered(n=600):
    A = sp.random(n, n, density=0.005, random_state=5).tocsr()
    A.setdiag(0)
    A.eliminate_zeros()
    return A


def _degenerate(n=1 << 15):
    """tests/test_sell_hybrid.py:125-140: 30 far-apart nonzeros."""
    rng = np.random.default_rng(5)
    rows = rng.choice(n, 30, replace=False)
    cols = rng.choice(n, 30, replace=False)
    return sp.coo_matrix((np.ones(30), (rows, cols)), shape=(n, n)).tocsr()


def _bucketed():
    A = _skewed(1 << 13, 4)
    A.setdiag(0)
    A.eliminate_zeros()
    return A


FIXTURES = {
    "stencil": lambda: sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1],
                                (512, 512)).tocsr(),
    "scattered": _scattered,
    "mixed": _mixed,
    "rectangular": lambda: sp.random(100, 300, density=0.05,
                                     random_state=2).tocsr(),
    "degenerate": _degenerate,
    "band_noise": lambda: (sp.diags([1.0, -4.0, 1.0], [-1, 0, 1],
                                    (1500, 1500))
                           + sp.random(1500, 1500, density=0.002,
                                       random_state=11)).tocsr(),
    "bucketed": _bucketed,
}


@pytest.mark.parametrize("name", list(FIXTURES))
def test_analysis_gives_jax_parts_and_product(name):
    """split_diagonals and hybrid_from_csr give the JAX package's parts
    (pure DIA, pure SELL, both, a CSR remainder for the degenerate
    pattern, SELLBucketed for the skewed one), and hybrid_spmv its
    product within 1e-12 in f64."""
    A = FIXTURES[name]()
    C = _jcsr(A)
    T = _tcsr(C)
    dj, rj = jh.split_diagonals(C)
    dt, rt = th.split_diagonals(T)
    _assert_same_dia(dt, dj)
    assert (rt is None) == (rj is None)
    if rj is not None:
        _assert_same_csr(rt, rj)
    Hj = jh.hybrid_from_csr(C)
    Ht = th.hybrid_from_csr(T)
    _assert_same_hybrid(Ht, Hj)
    expect = {"stencil": (True, type(None)), "scattered": (False, object),
              "mixed": (True, object), "rectangular": (False, object),
              "degenerate": (False, CSRMatrix),
              "band_noise": (True, object),
              "bucketed": (False, ts.SELLBucketed)}[name]
    assert (Ht.dia is not None) == expect[0]
    assert isinstance(Ht.sell, expect[1])
    x = np.random.default_rng(3).standard_normal(A.shape[1])
    y = th.hybrid_spmv(Ht, torch.as_tensor(x))
    assert y.shape == (A.shape[0],) and y.dtype == torch.float64
    assert _rel(y, np.asarray(jh.hybrid_spmv(Hj, jnp.asarray(x)))) <= 1e-12
    assert _rel(y, A @ x) <= 1e-12
    assert torch.equal(Ht @ torch.as_tensor(x), y)


def test_hybrid_spmv_f32():
    """The mixed and skewed patterns in f32: within 1e-5 of the JAX
    product."""
    for A in (_mixed(), _bucketed()):
        C = _jcsr(A, dtype=np.float32)
        Hj = jh.hybrid_from_csr(C)
        Ht = th.hybrid_from_csr(_tcsr(C))
        _assert_same_hybrid(Ht, Hj)
        assert Ht.dtype == torch.float32
        x = np.random.default_rng(6).standard_normal(A.shape[1]).astype(
            np.float32)
        y = th.hybrid_spmv(Ht, torch.as_tensor(x))
        assert y.dtype == torch.float32
        assert _rel(y, np.asarray(jh.hybrid_spmv(Hj, jnp.asarray(x)))) \
            <= 1e-5


def test_rcm_permute_gives_jax_permutation():
    """rcm_permute recovers a scrambled band (tests/test_sell_hybrid.py:
    108-123) with the JAX package's permutation and matrix."""
    n = 400
    rng = np.random.default_rng(21)
    perm0 = rng.permutation(n)
    T = sp.diags([1.0, 4.0, 1.0], [-1, 0, 1], (n, n)).tocsr()
    C = _jcsr(T[perm0][:, perm0].tocsr())
    cj, pj = jh.rcm_permute(C)
    ct, pt = th.rcm_permute(_tcsr(C))
    assert np.array_equal(pt, pj)
    _assert_same_csr(ct, cj)
    rows, cols = ct.rows.numpy(), ct.indices.numpy()
    assert np.max(np.abs(rows - cols)) <= 2
    with pytest.raises(ValueError, match="square"):
        th.rcm_permute(_tcsr(_jcsr(sp.random(4, 5, density=0.5,
                                             random_state=0))))


def _solve_pair(method, A, **kw):
    C = _jcsr(A)
    b = np.ones(A.shape[0])
    xj, sj = getattr(kj, method)(kj.HybridOperator.analyze(C),
                                 jnp.asarray(b), **kw)
    op = kt.HybridOperator.analyze(_tcsr(C))
    xt, st = getattr(kt, method)(op, torch.as_tensor(b), **kw)
    return xj, sj, xt, st


def test_cg_through_hybrid_operator():
    """cg on tests/test_sell_hybrid.py:150-160's SPD system through
    HybridOperator.analyze: the JAX package's status and niter, x within
    1e-8."""
    n = 900
    R = sp.random(n, n, density=0.003, random_state=13)
    A = (sp.diags([-1.0, 4.0, -1.0], [-1, 0, 1], (n, n)) + R + R.T).tocsr()
    xj, sj, xt, st = _solve_pair("cg", A, atol=0.0, rtol=1e-10)
    assert st.solved and (st.status, st.niter) == (sj.status, sj.niter)
    assert _rel(xt, xj) <= 1e-8
    assert np.linalg.norm(A @ xt.numpy() - 1.0) <= 1e-7


def test_bicgstab_and_adjoint_through_hybrid_operator():
    """bicgstab and rmatvec on tests/test_sell_hybrid.py:162-172's
    unsymmetric system: the JAX package's status and niter, x within
    1e-8, Aᴴx within 1e-12; rmatvec without adjoint storage raises the
    JAX package's ValueError."""
    n = 800
    A = (sp.diags([0.3, 3.0, -0.7], [-1, 0, 1], (n, n))
         + sp.random(n, n, density=0.002, random_state=17)).tocsr()
    xj, sj, xt, st = _solve_pair("bicgstab", A, atol=0.0, rtol=1e-10)
    assert st.solved and (st.status, st.niter) == (sj.status, sj.niter)
    assert _rel(xt, xj) <= 1e-8
    C = _jcsr(A)
    opj = kj.HybridOperator.analyze(C).with_adjoint()
    op = kt.HybridOperator.analyze(_tcsr(C))
    v = np.random.default_rng(4).standard_normal(n)
    with pytest.raises(ValueError, match="with_adjoint"):
        op.rmatvec(torch.as_tensor(v))
    opa = op.with_adjoint()
    assert opa.with_adjoint() is opa and opa.hyb is op.hyb
    _assert_same_hybrid(opa.hyb_h, opj.hyb_h)
    got = opa.rmatvec(torch.as_tensor(v))
    assert _rel(got, np.asarray(opj.rmatvec(jnp.asarray(v)))) <= 1e-12
    assert _rel(got, A.T @ v) <= 1e-12
    assert _rel(opa.H @ torch.as_tensor(v), A.T @ v) <= 1e-12


def test_lsqr_builds_adjoint_and_replaces_cache():
    """lsqr on a HybridOperator builds the analysis of Aᴴ (as the JAX
    package's need_adjoint routing does for a CSR matrix) and solves as
    the JAX package does on its adjoint-capable operator; with_adjoint
    replaces the operator cached on its source matrix."""
    n = 800
    A = (sp.diags([0.3, 3.0, -0.7], [-1, 0, 1], (n, n))
         + sp.random(n, n, density=0.002, random_state=19)).tocsr()
    C = _jcsr(A)
    b = np.random.default_rng(8).standard_normal(n)
    xj, sj = kj.lsqr(kj.HybridOperator.analyze(C).with_adjoint(),
                     jnp.asarray(b), atol=0.0, rtol=1e-10)
    T = _tcsr(C)
    op = kt.HybridOperator.analyze(T)
    T._hybrid_op = op
    xt, st = kt.lsqr(op, torch.as_tensor(b), atol=0.0, rtol=1e-10)
    assert (st.status, st.niter) == (sj.status, sj.niter)
    assert _rel(xt, xj) <= 1e-8
    opa = T._hybrid_op
    assert opa is not op and opa.hyb is op.hyb and opa.hyb_h is not None
    assert opa.with_adjoint() is opa and op.hyb_h is None
    with pytest.raises(ValueError, match="source CSRMatrix"):
        kt.HybridOperator(op.hyb).with_adjoint()


def test_as_operator_on_cpu_keeps_csr():
    """A CSRMatrix on the CPU stays a CSROperator (gather and index_add_),
    caches nothing, and solves as the JAX package does."""
    n = 900
    R = sp.random(n, n, density=0.003, random_state=13)
    A = (sp.diags([-1.0, 4.0, -1.0], [-1, 0, 1], (n, n)) + R + R.T).tocsr()
    C = _jcsr(A)
    T = _tcsr(C)
    op = kt.as_operator(T)
    assert isinstance(op, kt.CSROperator) and not hasattr(T, "_hybrid_op")
    xt, st = kt.cg(T, torch.ones(n, dtype=torch.float64), atol=0.0,
                   rtol=1e-10)
    xj, sj = kj.cg(C, jnp.ones(n), atol=0.0, rtol=1e-10)
    assert (st.status, st.niter) == (sj.status, sj.niter)
    assert _rel(xt, xj) <= 1e-8
    assert kt.HybridOperator.analyze(T).device.type == "cpu"


def _bf16(T):
    """The port's CSRMatrix ``T`` with its values rounded to bf16."""
    return CSRMatrix(T.data.to(torch.bfloat16), T.indices, T.indptr, T.rows,
                     T.shape)


@pytest.mark.parametrize("name", ["mixed", "bucketed"])
def test_bf16_analysis_gives_jax_parts_and_product(name):
    """A bf16 CSRMatrix analyses (numpy holds no bf16: the host works on
    its values widened to f32) into the JAX package's parts, stored in
    bf16; hybrid_spmv of f32 x is within 1e-5 of the JAX product, and
    rmatvec after with_adjoint within 1e-5 of CSROperator's."""
    A = FIXTURES[name]()
    Hj = jh.hybrid_from_csr(_jcsr(A, dtype=jnp.bfloat16))
    T = _bf16(_tcsr(_jcsr(A)))
    Ht = th.hybrid_from_csr(T)
    assert Ht.dtype == torch.bfloat16 and Ht.nnz == Hj.nnz
    assert (Ht.dia is None) == (Hj.dia is None)
    if Hj.dia is not None:
        assert Ht.dia.offsets == tuple(Hj.dia.offsets)
        assert np.array_equal(Ht.dia.data.float().numpy(),
                              np.asarray(Hj.dia.data, np.float32))
    pt = getattr(Ht.sell, "parts", (Ht.sell,))
    pj = getattr(Hj.sell, "parts", (Hj.sell,))
    assert len(pt) == len(pj)
    for a, b in zip(pt, pj):
        assert a.data.dtype == torch.bfloat16
        assert np.array_equal(a.data.float().numpy(),
                              np.asarray(b.data, np.float32))
        for f in ("idx", "slice_of", "chunk_of"):
            assert np.array_equal(getattr(a, f).numpy(),
                                  np.asarray(getattr(b, f))), f
    x = np.random.default_rng(6).standard_normal(A.shape[1]).astype(
        np.float32)
    y = th.hybrid_spmv(Ht, torch.as_tensor(x))
    assert y.dtype == torch.float32
    assert _rel(y, np.asarray(jh.hybrid_spmv(Hj, jnp.asarray(x)),
                              np.float32)) <= 1e-5
    op = kt.HybridOperator.analyze(T).with_adjoint()
    assert op.hyb_h.dtype == torch.bfloat16
    xt = torch.as_tensor(x)
    assert _rel(op.rmatvec(xt),
                kt.CSROperator(T).with_adjoint().rmatvec(xt)) <= 1e-5


def test_cached_analysis_follows_in_place_changes():
    """The operator cached on a CSRMatrix is analysed anew after an
    in-place change of its data (mul_, copy_) or a new data tensor, and
    its product is then the new matrix's; with_adjoint on an operator
    whose source has changed analyses A again beside Aᴴ."""
    from krylov_tpu_torch.operators import _cached_hybrid
    A = _mixed()
    T = _tcsr(_jcsr(A))
    x = torch.as_tensor(np.random.default_rng(7).standard_normal(
        A.shape[1]))
    op = _cached_hybrid(T)
    assert T._hybrid_op is op and _cached_hybrid(T) is op
    assert _rel(op.matvec(x), A @ x.numpy()) <= 1e-12
    T.data.mul_(2.0)
    op2 = _cached_hybrid(T)
    assert op2 is not op and T._hybrid_op is op2
    assert _rel(op2.matvec(x), 2.0 * (A @ x.numpy())) <= 1e-12
    assert _cached_hybrid(T) is op2
    stale = op.with_adjoint()
    assert stale.hyb is not op.hyb
    assert _rel(stale.matvec(x), 2.0 * (A @ x.numpy())) <= 1e-12
    assert _rel(stale.rmatvec(x), 2.0 * (A.T @ x.numpy())) <= 1e-12
    T.data.copy_(T.data / 4.0)
    assert _rel(_cached_hybrid(T).matvec(x), 0.5 * (A @ x.numpy())) <= 1e-12
    T.data = T.data * 6.0
    op3 = _cached_hybrid(T)
    assert _rel(op3.matvec(x), 3.0 * (A @ x.numpy())) <= 1e-12
    opa = op3.with_adjoint()
    assert T._hybrid_op is opa and opa.hyb is op3.hyb
    assert _cached_hybrid(T) is opa


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16, torch.complex64])
@pytest.mark.parametrize("name", ["mixed", "band_noise", "bucketed"])
def test_hybrid_product_is_the_per_part_composition(name, dtype):
    """hybrid_spmv on the CPU (the DIA half, then the table walk that adds
    it, as the card's second launch does) is bit for bit the DIA half
    plus the per-part composition of the SELL remainder; within 1e-12
    (f64) and 1e-5 (f32, bf16 data with f32 x) of the JAX package's
    hybrid_spmv, and within 1e-5 of the f64 product for c64, which the
    JAX SELL kernel does not take."""
    from krylov_tpu_torch.ops.dia import dia_spmv
    A = FIXTURES[name]()
    if dtype.is_complex:
        A = (A * (1.0 + 0.5j)).tocsr()
    T = _tcsr(_jcsr(A))
    if dtype == torch.bfloat16:
        T = _bf16(T)
    elif dtype == torch.complex64 or dtype == torch.float32:
        T = CSRMatrix(T.data.to(dtype), T.indices, T.indptr, T.rows, T.shape)
    H = th.hybrid_from_csr(T)
    assert (H.dia is not None) == (name != "bucketed")
    assert isinstance(H.sell, (ts.SELLMatrix, ts.SELLBucketed))
    xdt = torch.float32 if dtype == torch.bfloat16 else dtype
    xw = np.random.default_rng(12).standard_normal(A.shape[1])
    if dtype.is_complex:
        xw = xw * (0.5 - 1.0j)
    x = torch.as_tensor(xw).to(xdt)
    y = th.hybrid_spmv(H, x)
    sell = ts.sell_bucketed_spmv_ref(H.sell, x) if isinstance(
        H.sell, ts.SELLBucketed) else ts.sell_spmv_ref(H.sell, x)
    want = sell if H.dia is None else dia_spmv(H.dia.data, H.dia.offsets,
                                               x) + sell
    assert y.dtype == xdt and torch.equal(y, want)
    if dtype.is_complex:
        ref = A @ x.numpy().astype(np.complex128)
        assert np.max(np.abs(y.numpy() - ref)) <= 1e-5 * np.max(np.abs(ref))
        return
    jdt = {torch.float32: np.float32, torch.float64: np.float64,
           torch.bfloat16: jnp.bfloat16}[dtype]
    Hj = jh.hybrid_from_csr(_jcsr(A, dtype=jdt))
    yj = np.asarray(jh.hybrid_spmv(Hj, jnp.asarray(x.numpy())), np.float64)
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    assert _rel(y.double().numpy(), yj) <= tol
