"""DIA storage and the DIA SpMV of krylov_tpu_torch against krylov_tpu.

The same diagonals and vectors, made with numpy from a seed, go through
the JAX functions (``dia_spmv``, and ``dia_spmv_pallas`` in interpret
mode, as the JAX package's own tests run it on the CPU) and through the
port's plain versions.  Tolerances, relative to max|y|: 1e-12 in f64 and
1e-5 in f32.  Both sides accumulate in the vector's dtype, one diagonal
after another, but the JAX kernel works on a padded lane layout and XLA
may contract or reorder its multiply-adds, so f32 can differ by a few
ulps of the largest entry; bf16 diagonals are rounded identically on
both sides and then accumulate in f32.
"""

import numpy as np
import jax.numpy as jnp
import pytest
torch = pytest.importorskip("torch")

import krylov_tpu_torch as ktt
from krylov_tpu.ops.dia import (convdiff_dia as jconvdiff, dia_spmv as
                                jdia_spmv, poisson_dia as jpoisson)
from krylov_tpu.ops.pallas_dia import dia_align as jdia_align
from krylov_tpu.ops.pallas_dia import dia_pad_layout as jdia_pad_layout
from krylov_tpu.ops.pallas_dia import dia_spmv_padded as jdia_spmv_padded
from krylov_tpu.ops.pallas_dia import dia_spmv_pallas
from krylov_tpu.ops.pallas_dia import dia_unpad_layout as jdia_unpad_layout
from krylov_tpu.operators import DIAOperator as JDIAOperator
from krylov_tpu_torch.convert import dia_from_numpy
from krylov_tpu_torch.ops.cuda_dia import (dia_align, dia_pad_layout,
                                           dia_spmv_aligned,
                                           dia_spmv_aligned_ref,
                                           dia_spmv_padded,
                                           dia_unpad_layout, halo_width,
                                           offsets_tensor)
from krylov_tpu_torch.ops.dia import dia_spmv

TOL = {np.float64: 1e-12, np.float32: 1e-5}
RAGGED = (12, 10, 9)


def _rel(a, b):
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300)


def _random_dia(n, offsets, dtype, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((len(offsets), n)).astype(dtype), \
        rng.standard_normal(n).astype(dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("dims", [(8, 8, 8), RAGGED])
@pytest.mark.parametrize("build", ["poisson", "convdiff"])
def test_stencil_data_equals_jax(build, dims, dtype):
    if build == "poisson":
        D = jpoisson(*dims, dtype=dtype)
        P = ktt.poisson_dia(*dims, dtype=dtype, device="cpu")
    else:
        D = jconvdiff(*dims, pe=0.3, dtype=dtype)
        P = ktt.convdiff_dia(*dims, pe=0.3, dtype=dtype, device="cpu")
    assert P.offsets == D.offsets and P.shape == D.shape
    assert P.nnz == D.nnz
    np.testing.assert_array_equal(P.data.numpy(), np.asarray(D.data))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_dia_align_equals_jax(dtype):
    n = int(np.prod(RAGGED))
    offs = (-300, -129, -1, 0, 5, 131, 257)
    data, _ = _random_dia(n, offs, dtype, seed=1)
    pd_j = np.asarray(jdia_align(jnp.asarray(data), offs, n))
    pd_t = dia_align(torch.as_tensor(data), offs, n).numpy()
    np.testing.assert_array_equal(pd_t, pd_j)


CASES = [
    ("poisson_ragged", None),
    ("random_offsets", (-300, -129, -1, 0, 5, 131, 257)),
]


def _case(name, offs, dtype, seed):
    if offs is None:
        D = jpoisson(*RAGGED, dtype=dtype)
        data, offs = np.array(D.data), D.offsets
        x = np.random.default_rng(seed).standard_normal(
            data.shape[1]).astype(dtype)
    else:
        data, x = _random_dia(int(np.prod(RAGGED)), offs, dtype, seed)
    return data, offs, x


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("name,offs", CASES)
def test_aligned_ref_matches_jax(name, offs, dtype):
    data, offs, x = _case(name, offs, dtype, seed=2)
    n = x.shape[0]
    pd_j = jdia_align(jnp.asarray(data), offs, n)
    y_kernel = np.asarray(dia_spmv_pallas(pd_j, offs, jnp.asarray(x),
                                          interpret=True))
    y_plain = np.asarray(jdia_spmv(jnp.asarray(data), offs, jnp.asarray(x)))
    pd_t = dia_align(torch.as_tensor(data), offs, n)
    y = dia_spmv_aligned_ref(pd_t, offsets_tensor(offs, "cpu"),
                             torch.as_tensor(x)).numpy()
    assert y.dtype == dtype
    assert _rel(y, y_kernel) <= TOL[dtype]
    assert _rel(y, y_plain) <= TOL[dtype]
    # the port's plain shift-and-add product on the stored diagonals
    y2 = dia_spmv(torch.as_tensor(data), offs, torch.as_tensor(x)).numpy()
    assert _rel(y2, y_plain) <= TOL[dtype]


@pytest.mark.parametrize("name,offs", CASES)
def test_aligned_ref_bf16_diagonals_match_jax(name, offs):
    data, offs, x = _case(name, offs, np.float32, seed=3)
    n = x.shape[0]
    pd_t = dia_align(torch.as_tensor(data), offs, n).to(torch.bfloat16)
    pd_j = jdia_align(jnp.asarray(data), offs, n).astype(jnp.bfloat16)
    np.testing.assert_array_equal(pd_t.float().numpy(),
                                  np.asarray(pd_j.astype(jnp.float32)))
    y_j = np.asarray(dia_spmv_pallas(pd_j, offs, jnp.asarray(x),
                                     interpret=True))
    y = dia_spmv_aligned_ref(pd_t, offsets_tensor(offs, "cpu"),
                             torch.as_tensor(x))
    assert y.dtype == torch.float32
    assert _rel(y.numpy(), y_j) <= TOL[np.float32]


def test_wrapper_takes_plain_version_on_cpu():
    data, offs, x = _case("random_offsets", CASES[1][1], np.float64, seed=4)
    pd = dia_align(torch.as_tensor(data), offs, x.shape[0])
    ot = offsets_tensor(offs, "cpu")
    before = dia_spmv_aligned.launches
    y = dia_spmv_aligned(pd, ot, torch.as_tensor(x))
    assert dia_spmv_aligned.launches == before
    assert torch.equal(y, dia_spmv_aligned_ref(pd, ot, torch.as_tensor(x)))


def test_wrapper_rejects_bad_inputs():
    pd = torch.zeros(3, 10)
    ot = offsets_tensor((-1, 0, 1), "cpu")
    with pytest.raises(ValueError):
        dia_spmv_aligned(pd, ot, torch.zeros(9))
    with pytest.raises(ValueError):
        dia_spmv_aligned(pd, ot.to(torch.int32), torch.zeros(10))
    with pytest.raises(ValueError):
        dia_spmv_aligned(pd.t().contiguous().t(), ot, torch.zeros(10))


@pytest.mark.parametrize("use_kernel", [False, True])
def test_dia_operator_matvec_matches_jax(use_kernel):
    D = jpoisson(*RAGGED, dtype=np.float64)
    x = np.random.default_rng(5).standard_normal(D.shape[0])
    A = dia_from_numpy(np.asarray(D.data), D.offsets, D.shape, device="cpu")
    op = ktt.DIAOperator(A, use_kernel=use_kernel)
    y = op.matvec(torch.as_tensor(x)).numpy()
    yj = np.asarray(JDIAOperator(D, use_pallas=False).matvec(jnp.asarray(x)))
    assert _rel(y, yj) <= TOL[np.float64]
    yt = op.rmatvec(torch.as_tensor(x)).numpy()
    yjt = np.asarray(JDIAOperator(D, use_pallas=False).rmatvec(
        jnp.asarray(x)))
    assert _rel(yt, yjt) <= TOL[np.float64]


def test_dia_from_scipy_matches_dense():
    import scipy.sparse as sp
    rng = np.random.default_rng(6)
    M = sp.random(40, 40, density=0.2, random_state=7, format="csr")
    A = ktt.dia_from_scipy(M, device="cpu")
    x = rng.standard_normal(40)
    np.testing.assert_allclose((A @ torch.as_tensor(x)).numpy(),
                               M @ x, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(A.todense().numpy(), M.toarray())



# the further (x, diagonal) pairs of the SpMV kernel and their tolerance
# against the JAX package, relative to max|y|: the accumulator is f32 for
# bf16 and f16 x (rounded to x's type at the end, so the two may differ
# by one ulp of the narrow type), else x's own type
PAIRS = [
    (np.float64, np.float32, 1e-12),
    (np.complex64, np.float32, 1e-5),
    (np.complex64, np.complex64, 1e-5),
    (np.complex128, np.float64, 1e-12),
    (np.complex128, np.complex128, 1e-12),
    ("bfloat16", "bfloat16", 1e-2),
    (np.float16, np.float16, 1e-3),
]


@pytest.mark.parametrize("xdt,pdt,tol", PAIRS,
                         ids=[f"{np.dtype(x).name}-{np.dtype(p).name}"
                              for x, p, _ in PAIRS])
def test_aligned_ref_new_pairs_match_jax(xdt, pdt, tol):
    """The plain version for the pairs that got kernels in this slice,
    against the JAX package's product on the same rounded inputs (its
    Pallas kernel for the narrow types, its plain product otherwise)."""
    data, offs, x = _case("random_offsets", CASES[1][1], np.float64, 6)
    n = x.shape[0]
    data = jnp.asarray(data).astype(pdt)
    xj = jnp.asarray(x).astype(xdt)
    if np.dtype(xdt).kind == "c":
        data = data * (1.0 + 0.5j if np.dtype(pdt).kind == "c" else 1.0)
        xj = xj * (0.5 - 1.0j)
    pd_j = jdia_align(data, offs, n)
    if np.dtype(xdt).itemsize < 4:
        y_j = dia_spmv_pallas(pd_j, offs, xj, interpret=True)
    else:
        y_j = jdia_spmv(data, offs, xj)
    pd_t = torch.from_numpy(np.array(pd_j.astype(jnp.float32))).to(
        torch.bfloat16) if pdt == "bfloat16" else torch.from_numpy(
            np.array(pd_j))
    x_t = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(
        torch.bfloat16) if xdt == "bfloat16" else torch.from_numpy(
            np.array(xj))
    y = dia_spmv_aligned(pd_t, offsets_tensor(offs, "cpu"), x_t)
    assert y.dtype == x_t.dtype
    y = y.to(torch.complex128 if y.is_complex() else torch.float64)
    want = np.asarray(y_j.astype(jnp.complex128))
    assert np.max(np.abs(y.numpy() - want)) <= tol * np.max(np.abs(want))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("name,offs", CASES)
def test_padded_ref_chains_like_jax(name, offs, dtype):
    """Two chained products in the padded layout, with the port's input
    halo full of NaN, against the JAX package's dia_spmv_padded in
    interpret mode after unpadding (tests/test_pallas_spmv.py:214)."""
    data, offs, x = _case(name, offs, dtype, seed=7)
    n = x.shape[0]
    pd_j = jdia_align(jnp.asarray(data), offs, n)
    yw = jdia_spmv_padded(pd_j, offs, jdia_pad_layout(jnp.asarray(x), offs),
                          n, interpret=True)
    y2w = jdia_spmv_padded(pd_j, offs, yw, n, interpret=True)
    pd = dia_align(torch.as_tensor(data), offs, n)
    ot = offsets_tensor(offs, "cpu")
    xw = dia_pad_layout(torch.as_tensor(x), offs)
    h = halo_width(offs)
    assert h % 32 == 0 and h >= max(abs(k) for k in offs)
    assert xw.shape == (n + 2 * h,) and float(xw[:h].abs().max()) == 0
    xw[:h] = float("nan")
    xw[h + n:] = float("nan")
    before = dia_spmv_padded.launches
    tw = dia_spmv_padded(pd, ot, xw, n)
    t2w = dia_spmv_padded(pd, ot, tw, n)
    assert dia_spmv_padded.launches == before    # CPU: the plain version
    for got, want in ((tw, yw), (t2w, y2w)):
        got = dia_unpad_layout(got, offs, n).numpy()
        assert np.isfinite(got).all()
        assert _rel(got, jdia_unpad_layout(want, offs, n)) <= TOL[dtype]
    with pytest.raises(ValueError):
        dia_spmv_padded(pd, ot, xw[1:], n)


@pytest.mark.parametrize("offsets,n,want", [
    ((-2, -1), 10, (2, 10)),            # negative offsets only
    ((0, 1, 3), 10, (0, 7)),            # positive offsets only
    ((-3, 0, 2), 10, (3, 8)),
    ((-12, -3, -1, 0, 1, 3, 12), 60, (12, 48)),
    ((0, 10), 10, (0, 0)),              # |k| >= n: no interior row
    ((-10, 0), 10, (10, 10)),
    ((-25, 40), 10, (10, 10)),
    ((-1, 0, 1), 3, (1, 2)),            # n below the vector width
    ((-1, 1), 1, (1, 1)),
    ((0,), 2, (0, 2)),
    ((), 5, (0, 5)),                    # no diagonal
])
def test_interior_row_range(offsets, n, want):
    """The host's interior [lo, hi), the rows whose every neighbour
    i + k_d lies in [0, n), which the kernel sums with no bounds branch:
    every row in it has all its neighbours, and no row outside it
    does."""
    from krylov_tpu_torch.ops.cuda_dia import _interior
    lo, hi = _interior(offsets, n)
    assert (lo, hi) == want and 0 <= lo <= hi <= n
    full = [all(0 <= i + k < n for k in offsets) for i in range(n)]
    assert full == [lo <= i < hi for i in range(n)]


def test_dia_plan_on_cpu_takes_plain_version_and_checks_once():
    """DIASpMV (what DIAOperator and HybridMatrix hold) checks the
    diagonals when it is made and x on each call; on the CPU its product
    is the plain version's, bit for bit, with no launch counted, and its
    offsets are read from the tensor where not given."""
    from krylov_tpu_torch.ops.cuda_dia import DIASpMV, _host_offsets
    data, offs, x = _case("random_offsets", CASES[1][1], np.float64, seed=6)
    n = x.shape[0]
    pd = dia_align(torch.as_tensor(data), offs, n)
    ot = offsets_tensor(offs, "cpu")
    assert _host_offsets(ot) == tuple(int(k) for k in offs)
    plan = DIASpMV(pd, ot)
    xt = torch.as_tensor(x)
    before = dia_spmv_aligned.launches
    assert torch.equal(plan(xt), dia_spmv_aligned_ref(pd, ot, xt))
    assert dia_spmv_aligned.launches == before
    with pytest.raises(ValueError):
        plan(torch.zeros(n + 1, dtype=torch.float64))
    with pytest.raises(ValueError):
        DIASpMV(pd.t().contiguous().t(), ot)
    with pytest.raises(ValueError):
        DIASpMV(pd, ot.to(torch.int32))
    with pytest.raises(ValueError):
        DIASpMV(pd, ot, offs[:-1])
    op = ktt.DIAOperator(dia_from_numpy(data, offs, (n, n), device="cpu"),
                         use_kernel=True)
    assert torch.equal(op.matvec(xt), dia_spmv_aligned_ref(op._pd,
                                                           op._offsets, xt))
