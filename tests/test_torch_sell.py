"""krylov_tpu_torch's SELL-C-128 storage and its product against
krylov_tpu's (tests/test_sell_hybrid.py), the JAX kernel in interpret
mode.

Inputs are made with numpy from a seed and given to both packages (a JAX
CSRMatrix crosses over through ``convert.csr_from_numpy``).  Tolerances:
the builders give equal arrays, element for element; the products agree
to 1e-12 of max|y| in f64 and 1e-5 in f32 (the same products summed in
another order).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import scipy.sparse as sp
torch = pytest.importorskip("torch")

from krylov_tpu.ops import pallas_sell as js
from krylov_tpu.ops.sparse import csr_from_coo as jcsr_from_coo
from krylov_tpu.ops.sparse import csr_from_dense as jcsr_from_dense
import krylov_tpu_torch as kt
from krylov_tpu_torch.convert import csr_from_numpy, sell_from_numpy
from krylov_tpu_torch.ops import cuda_sell as ts


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


def _assert_same_sell(t, j):
    """The port's SELLMatrix holds the JAX one's arrays, and its slice
    pointer names each slice's pairs."""
    assert isinstance(t, ts.SELLMatrix)
    for f in ("data", "idx", "slice_of", "chunk_of"):
        got, want = getattr(t, f).numpy(), np.asarray(getattr(j, f))
        assert got.shape == want.shape and np.array_equal(got, want), f
    assert t.idx.dtype == t.slice_of.dtype == t.chunk_of.dtype \
        == t.slice_ptr.dtype == torch.int32
    assert (t.shape, t.nnz, t.covered, t.kmax) == (j.shape, j.nnz,
                                                   j.covered, j.kmax)
    assert t.fill == pytest.approx(j.fill, rel=1e-12)
    so = t.slice_of.numpy()[:-1]
    ptr = t.slice_ptr.numpy()
    assert len(ptr) == max(-(-t.shape[0] // ts.SLICE), 1) + 1
    for s in range(len(ptr) - 1):
        assert np.all(so[ptr[s]:ptr[s + 1]] == s)
    assert ptr[-1] == len(so)


def _assert_same_bucketed(t, j):
    assert type(t).__name__ == type(j).__name__
    if isinstance(j, js.SELLMatrix):
        _assert_same_sell(t, j)
        return
    assert len(t.parts) == len(j.parts)
    for tp, jp in zip(t.parts, j.parts):
        _assert_same_sell(tp, jp)
    assert (t.shape, t.nnz, t.slots) == (j.shape, j.nnz, j.slots)
    assert (t.row_pos is None) == (j.row_pos is None)
    if j.row_pos is not None:
        assert np.array_equal(t.row_pos.numpy(), np.asarray(j.row_pos))


def _skewed(n=1 << 14, w=300, seed=0, nheavy=150, hdeg=120):
    """tests/test_sell_hybrid.py:178-190: a uniform band and a clustered
    block of heavy rows at the end."""
    rng = np.random.default_rng(seed)
    deg = np.full(n, 7)
    heavy = n - 1 - rng.choice(2048, nheavy, replace=False)
    deg[heavy] = hdeg
    r = np.repeat(np.arange(n, dtype=np.int64), deg)
    c = np.clip(r + rng.integers(-w, w + 1, size=r.size), 0, n - 1)
    v = rng.standard_normal(r.size)
    A = sp.coo_matrix((v, (r, c)), shape=(n, n)).tocsr()
    A.sum_duplicates()
    return A


def _spread(n=1 << 14, w=300, seed=0, hcols=1280):
    """The same band with its heavy rows (n/256 of them) spread over every
    slice, each coupled to the first ``hcols`` columns (constraint rows):
    here the σ-sorted plan wins, where _skewed's clustered rows never
    make it win."""
    rng = np.random.default_rng(seed)
    r = np.repeat(np.arange(n, dtype=np.int64), 7)
    c = np.clip(r + rng.integers(-w, w + 1, size=r.size), 0, n - 1)
    heavy = np.sort(rng.choice(n, n // 256, replace=False))
    r = np.r_[r, np.repeat(heavy, hcols)]
    c = np.r_[c, np.tile(np.arange(hcols), len(heavy))]
    A = sp.coo_matrix((rng.standard_normal(r.size), (r, c)),
                      shape=(n, n)).tocsr()
    A.sum_duplicates()
    return A


@pytest.mark.parametrize("m,n,density", [
    (2048, 2048, 0.003), (1000, 3000, 0.01), (3000, 1000, 0.01),
    (500, 500, 0.02), (1024, 1024, 0.001)])
@pytest.mark.parametrize("cover", [True, False])
def test_sell_from_csr_gives_jax_arrays_and_product(m, n, density, cover):
    """sell_from_csr with and without coverage pairs, square and
    rectangular: the JAX arrays, and the product within 1e-12 in f64."""
    A = sp.random(m, n, density=density, random_state=7, format="csr",
                  dtype=np.float64)
    C = _jcsr(A)
    J = js.sell_from_csr(C, cover=cover)
    T = ts.sell_from_csr(_tcsr(C), cover=cover)
    _assert_same_sell(T, J)
    assert T.device.type == "cpu"
    x = np.random.default_rng(0).standard_normal(n)
    y = kt.sell_spmv(T, torch.as_tensor(x))
    assert y.dtype == torch.float64 and y.shape == (m,)
    assert _rel(y, np.asarray(js.sell_spmv(J, jnp.asarray(x)))) <= 1e-12
    assert _rel(y, A @ x) <= 1e-12


def test_empty_rows_and_slices():
    """Rows and a whole slice with no nonzero read 0, covered or not."""
    A = np.zeros((2500, 2500))
    A[0, 0] = 1.0
    A[2400, 77] = 2.5
    C = jcsr_from_dense(jnp.asarray(A))
    x = np.arange(2500.0)
    for cover in (True, False):
        J = js.sell_from_csr(C, cover=cover)
        T = ts.sell_from_csr(_tcsr(C), cover=cover)
        _assert_same_sell(T, J)
        assert T.covered == cover
        y = ts.sell_spmv_ref(T, torch.as_tensor(x)).numpy()
        assert np.array_equal(y, A @ x)
        assert _rel(y, np.asarray(js.sell_spmv(J, jnp.asarray(x)))) <= 1e-12


def test_duplicate_heavy_row_and_f32():
    """One row with 100 nonzeros in one chunk drives Kmax; f64 within
    1e-12 and f32 within 1e-5 of the JAX product."""
    A = np.zeros((256, 256))
    A[3, :100] = np.arange(1.0, 101.0)
    A += np.eye(256)
    x = np.random.default_rng(1).standard_normal(256)
    for dt, tol in ((np.float64, 1e-12), (np.float32, 1e-5)):
        C = _jcsr(A, dtype=dt)
        J = js.sell_from_csr(C)
        T = ts.sell_from_csr(_tcsr(C))
        _assert_same_sell(T, J)
        assert T.kmax >= 100 and T.dtype == torch.from_numpy(
            np.zeros(0, dt)).dtype
        xd = x.astype(dt)
        y = ts.sell_spmv(T, torch.as_tensor(xd))
        assert y.dtype == T.dtype
        assert _rel(y, np.asarray(js.sell_spmv(J, jnp.asarray(xd)))) <= tol


def test_mixed_pair_accumulates_in_x_type():
    """f64 x on f32 data: the product in f64, as the JAX kernel's."""
    A = sp.random(700, 900, density=0.01, random_state=3, format="csr")
    C = _jcsr(A, dtype=np.float32)
    J = js.sell_from_csr(C)
    T = ts.sell_from_csr(_tcsr(C))
    x = np.random.default_rng(2).standard_normal(900)
    y = ts.sell_spmv(T, torch.as_tensor(x))
    assert y.dtype == torch.float64
    assert _rel(y, np.asarray(js.sell_spmv(J, jnp.asarray(x)))) <= 1e-12


@pytest.mark.parametrize("case", ["skewed", "fat_tailed", "heavy_row",
                                  "uniform", "sorted"])
def test_bucketed_gives_jax_parts_and_product(case):
    """sell_bucketed_from_csr on the fixtures of
    tests/test_sell_hybrid.py:175-262 and a σ-sorted plan: the JAX parts,
    row_pos and plan type, and the product within 1e-12 in f64."""
    rng = np.random.default_rng(0)
    if case == "skewed":
        A = _skewed()
    elif case == "fat_tailed":
        n, w = 1 << 13, 300
        deg = np.minimum(2 + rng.zipf(1.6, size=n), 200)
        r = np.repeat(np.arange(n, dtype=np.int64), deg)
        c = np.clip(r + rng.integers(-w, w + 1, size=r.size), 0, n - 1)
        A = sp.coo_matrix((rng.standard_normal(r.size), (r, c)),
                          shape=(n, n)).tocsr()
        A.sum_duplicates()
    elif case == "heavy_row":
        A = sp.eye(8192, format="lil")
        A[3, :100] = np.arange(1.0, 101.0)
        A = A.tocsr()
    elif case == "uniform":
        A = sp.diags([1.0, 4.0, 1.0], [-1, 0, 1], (2048, 2048)).tocsr()
    else:
        A = _spread()
    C = _jcsr(A)
    J = js.sell_bucketed_from_csr(C)
    T = ts.sell_bucketed_from_csr(_tcsr(C))
    _assert_same_bucketed(T, J)
    assert isinstance(T, ts.SELLBucketed) == (case != "uniform")
    assert (getattr(T, "row_pos", None) is not None) == (case == "sorted")
    x = rng.standard_normal(A.shape[1])
    y = T @ torch.as_tensor(x)
    assert _rel(y, np.asarray(J @ jnp.asarray(x))) <= 1e-12
    assert _rel(y, A @ x) <= 1e-12
    if isinstance(T, ts.SELLBucketed):
        assert torch.equal(y, ts.sell_bucketed_spmv_ref(T,
                                                        torch.as_tensor(x)))


def test_bucket_plan_matches_jax():
    """_bucket_plan's cost, slots and labels equal the JAX package's, and
    so do the cost constants."""
    A = _skewed(n=1 << 13, seed=3).tocoo()
    rows, cols = A.row.astype(np.int64), A.col.astype(np.int64)
    got = ts._bucket_plan(rows, cols, *A.shape)
    want = js._bucket_plan(rows, cols, *A.shape)
    assert got[0] == want[0] and got[1] == want[1]
    assert np.array_equal(got[2], want[2]) and np.array_equal(got[3],
                                                             want[3])
    assert (ts._PAIR_COST, ts._GATHER_COST, ts._PART_COST, ts.SLICE,
            ts.CHUNK) == (js._PAIR_COST, js._GATHER_COST, js._PART_COST,
                          js.SLICE, js.CHUNK)


def test_sell_from_numpy_parity():
    """A JAX SELLMatrix's arrays become the port's own SELLMatrix."""
    A = sp.random(1500, 1300, density=0.004, random_state=5, format="csr")
    C = _jcsr(A)
    for cover in (True, False):
        J = js.sell_from_csr(C, cover=cover)
        T = sell_from_numpy(np.asarray(J.data), np.asarray(J.idx),
                            np.asarray(J.slice_of), np.asarray(J.chunk_of),
                            J.shape, J.nnz, J.covered, device="cpu")
        _assert_same_sell(T, J)
        own = ts.sell_from_csr(_tcsr(C), cover=cover)
        assert torch.equal(T.slice_ptr, own.slice_ptr)
        x = torch.as_tensor(np.random.default_rng(4).standard_normal(1300))
        assert torch.equal(T @ x, own @ x)


def test_pair_budget_and_shape_raise():
    """More pairs than the JAX kernel's budget (2P + 1 > 240 000) and an x
    of the wrong length raise ValueError; a CPU x takes the plain
    version without counting a launch."""
    A = ts.sell_from_csr(csr_from_numpy(
        np.ones(2), np.array([0, 1]), np.array([0, 1, 2]), np.array([0, 1]),
        (2, 2), device="cpu"))
    big = ts.SELLMatrix(torch.zeros(1, 8, 128).expand(120_000, 8, 128),
                        A.idx.expand(120_000, 8, 128),
                        torch.zeros(120_001, dtype=torch.int32),
                        torch.zeros(120_000, dtype=torch.int32), (2, 2), 2,
                        slice_ptr=A.slice_ptr)
    with pytest.raises(ValueError, match="pair count 120000"):
        kt.sell_spmv(big, torch.ones(2))
    with pytest.raises(ValueError, match="does not match"):
        kt.sell_spmv(A, torch.ones(3, dtype=torch.float64))
    n0 = kt.sell_spmv.launches
    assert torch.equal(kt.sell_spmv(A, torch.ones(2, dtype=torch.float64)),
                       torch.ones(2, dtype=torch.float64))
    assert kt.sell_spmv.launches == n0


def test_numpy_input_goes_to_card(monkeypatch):
    """A CSR matrix whose arrays are numpy (the JAX package's) goes to the
    card by default, which raises here; device="cpu" keeps it."""
    C = _jcsr(sp.random(300, 300, density=0.02, random_state=1))
    S = ts.sell_from_csr(C, device="cpu")
    assert S.device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ts.sell_from_csr(C)


def _fixture(case):
    rng = np.random.default_rng(0)
    if case == "skewed":
        return _skewed()
    if case == "sorted":
        return _spread()
    if case == "heavy_row":
        A = sp.eye(8192, format="lil")
        A[3, :100] = np.arange(1.0, 101.0)
        return A.tocsr()
    n, w = 1 << 13, 300
    deg = np.minimum(2 + rng.zipf(1.6, size=n), 200)
    r = np.repeat(np.arange(n, dtype=np.int64), deg)
    c = np.clip(r + rng.integers(-w, w + 1, size=r.size), 0, n - 1)
    A = sp.coo_matrix((rng.standard_normal(r.size), (r, c)),
                      shape=(n, n)).tocsr()
    A.sum_duplicates()
    return A


@pytest.mark.parametrize("case", ["skewed", "fat_tailed", "heavy_row",
                                  "sorted"])
def test_bucketed_parts_are_views_of_the_part_table(case):
    """sell_bucketed_from_csr homes its parts in one set of buffers: each
    part's data, idx, chunk_of and slice_ptr are consecutive views of
    them (and still the JAX package's arrays), the table holds each
    part's data, pair and slice_ptr offsets and its Kmax, and inv is the
    inverse of row_pos."""
    C = _jcsr(_fixture(case))
    J = js.sell_bucketed_from_csr(C)
    T = ts.sell_bucketed_from_csr(_tcsr(C))
    _assert_same_bucketed(T, J)
    offs = [0, 0, 0, 0]
    rows = []
    for tp, jp in zip(T.parts, J.parts):
        rows.append((offs[0], offs[2], offs[3], jp.kmax))
        for b, f in enumerate(ts.SELLBuffers._fields):
            a, buf = getattr(tp, f), getattr(T.buffers, f)
            assert a._base is buf and a.is_contiguous()
            assert a.storage_offset() - buf.storage_offset() == offs[b]
            offs[b] += a.numel()
    assert [b.numel() for b in T.buffers] == offs
    assert T.table.dtype == torch.int64 and T.table.tolist() == \
        [list(r) for r in rows]
    if case == "sorted":
        assert T.inv.dtype == torch.int32
        assert torch.equal(T.inv[T.row_pos.long()].long(),
                           torch.arange(T.shape[0]))
    else:
        assert T.inv is None


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16, torch.complex64])
@pytest.mark.parametrize("case", ["skewed", "sorted"])
def test_table_walk_is_the_per_part_composition(case, dtype):
    """The plain walk of the part table (the kernel's rounding points:
    each part rounded to x's type, the parts summed in x's type in part
    order, inv) is bit for bit sell_bucketed_spmv_ref, and it is what
    sell_spmv gives on the CPU; within 1e-12 (f64) and 1e-5 (f32, bf16
    data with f32 x) of the JAX package's sell_bucketed_spmv in interpret
    mode, and within 1e-5 of the f64 product for c64, which the JAX
    kernel does not take."""
    A = _fixture(case)
    wide = np.complex128 if dtype.is_complex else np.float64
    Aw = (A * (1.0 + 0.5j)).tocsr() if dtype.is_complex else A
    T = ts.sell_bucketed_from_csr(_tcsr(_jcsr(Aw)))
    for p in T.parts:
        p.data = p.data.to(dtype)
    xdt = torch.float32 if dtype == torch.bfloat16 else dtype
    rng = np.random.default_rng(7)
    xw = rng.standard_normal(A.shape[1]).astype(wide)
    if dtype.is_complex:
        xw = xw * (0.5 - 1.0j)
    x = torch.as_tensor(xw).to(xdt)
    y = ts.sell_table_spmv_ref(T, x)
    assert y.dtype == xdt and T._stale is False
    assert torch.equal(y, ts.sell_bucketed_spmv_ref(T, x))
    assert torch.equal(kt.sell_spmv(T, x), y)
    if dtype.is_complex:
        want = Aw @ x.numpy().astype(wide)
        assert np.max(np.abs(y.numpy() - want)) <= 1e-5 * np.max(
            np.abs(want))
        return
    jdt = {torch.float32: np.float32, torch.float64: np.float64,
           torch.bfloat16: jnp.bfloat16}[dtype]
    J = js.sell_bucketed_from_csr(_jcsr(A, dtype=jdt))
    yj = np.asarray(js.sell_bucketed_spmv(J, jnp.asarray(x.numpy())),
                    np.float64)
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    assert _rel(y.double().numpy(), yj) <= tol


def test_separate_parts_are_homed_and_follow_changes():
    """A SELLBucketed made from separate part tensors copies them into one
    set of buffers and re-points the parts at them; an in-place change
    of a part's data is seen by the next product, and a part tensor
    replaced by another is homed again before it."""
    T = ts.sell_bucketed_from_csr(_tcsr(_jcsr(_skewed())))
    S = ts.SELLBucketed(
        [ts.SELLMatrix(p.data.clone(), p.idx.clone(), p.slice_of,
                       p.chunk_of.clone(), p.shape, p.nnz, p.covered,
                       p.slice_ptr.clone()) for p in T.parts],
        T.shape, T.nnz, T.row_pos)
    for p in S.parts:
        assert p.data._base is S.buffers.data
    x = torch.as_tensor(np.random.default_rng(9).standard_normal(
        T.shape[1]))
    y = kt.sell_spmv(S, x)
    assert torch.equal(y, kt.sell_spmv(T, x))
    S.parts[0].data.mul_(2.0)
    y2 = kt.sell_spmv(S, x)
    assert torch.equal(y2, ts.sell_bucketed_spmv_ref(S, x))
    assert not torch.equal(y2, y)
    S.parts[1].data = S.parts[1].data * 0.0
    assert S._stale
    y3 = kt.sell_spmv(S, x)
    assert not S._stale and S.parts[1].data._base is S.buffers.data
    assert torch.equal(y3, ts.sell_bucketed_spmv_ref(S, x))
    single = T.parts[0]
    assert single.table.tolist() == [[0, 0, 0, single.kmax]]
    assert single.inv is None
    assert torch.equal(ts.sell_table_spmv_ref(single, x),
                       ts.sell_spmv_ref(single, x))
