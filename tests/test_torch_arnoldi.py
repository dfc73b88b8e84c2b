"""The arithmetic of the GMRES and FOM kernels' Arnoldi step
(krylov_tpu_torch/csrc/arnoldi.cuh) in its plain mirror,
``cuda_fused._GramMGS``: MGS's coefficients from the dots of the
unmodified w, the Gram rows and a forward substitution, then the ordered
update.  The mirror is held to sequential MGS (``_mgs_ref``, the TPU
kernels' arithmetic) on random non-orthonormal panels, and whole solves
run with it to krylov_tpu's ``gmres_dia_fused`` and ``fom_dia_fused`` in
interpret mode.

Inputs are made with numpy from a seed.  Tolerances are stated at each
comparison.
"""

import numpy as np
import jax.numpy as jnp
import pytest
torch = pytest.importorskip("torch")

import krylov_tpu.ops.pallas_fused as jf
from krylov_tpu.ops.pallas_dia import dia_align as jdia_align
from krylov_tpu_torch.ops import cuda_fused as tf
from krylov_tpu_torch.ops.cuda_dia import dia_align, offsets_tensor
from test_torch_gmres import _convdiff, _rel

# (vector type T, panel type): f64, f32, and a bf16-stored panel whose
# arithmetic runs in f32
KINDS = {"f64": (torch.float64, torch.float64),
         "f32": (torch.float32, torch.float32),
         "bf16_panel": (torch.float32, torch.bfloat16)}
# Relative tolerances of h and w′ against sequential MGS.  Both forms
# take the same products of the same stored values and differ only in
# where they round: a few ulps of T, grown by the forward substitution
# through Gram entries of about 0.08, so 1e-12 in f64 and 1e-5
# in f32 (eps 1.2e-7) leave a margin of about 100x.  A bf16 panel is
# widened to f32 identically by both, so it keeps the f32 tolerance.
TOL = {"f64": 1e-12, "f32": 1e-5, "bf16_panel": 1e-5}


def _panel(k, n, kind, seed=3):
    """k + 1 random unit vectors in the panel's type that share a common
    direction (normalised, not orthogonal: their Gram entries are about
    0.08), and a random w in T."""
    T, BT = KINDS[kind]
    rng = np.random.default_rng(seed + k)
    u = rng.standard_normal(n)
    V = rng.standard_normal((k + 1, n)) + 0.3 * u
    V /= np.linalg.norm(V, axis=1, keepdims=True)
    w = rng.standard_normal(n)
    return torch.as_tensor(V).to(BT), torch.as_tensor(w).to(T), T


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("k", [0, 1, 5, 19, 63])
def test_gram_step_matches_sequential_mgs(k, kind):
    """The mirror's h and w′ at step k, its Gram rows built by steps
    0..k as in a pass, against sequential MGS on the same panel; and
    classical Gram-Schmidt (the mirror without its Gram term) is far from
    both, so the Gram term is what makes the mirror MGS."""
    V, w, T = _panel(k, 512, kind)
    step = tf._GramMGS(k + 1)
    for j in range(k):
        step(V, j, w, T)
    h, w1 = step(V, k, w, T)
    h_ref, w1_ref = tf._mgs_ref(V, k, w, T)
    assert h.dtype == w1.dtype == T
    assert _rel(h.numpy(), h_ref.numpy()) <= TOL[kind]
    assert _rel(w1.numpy(), w1_ref.numpy()) <= TOL[kind]
    if k >= 1:
        h_cgs = torch.stack([torch.sum(V[j].to(T) * w)
                             for j in range(k + 1)])
        assert _rel(h_cgs.numpy(), h_ref.numpy()) >= 1e3 * TOL[kind]


def test_gram_rows_persist_across_a_pass_and_restart():
    """The Gram row of step k is kept for the later steps of the pass,
    and a new pass (a new v₀ at k = 0) writes its rows again: steps run
    on one panel, then on another from k = 0, give MGS's h on each."""
    step = tf._GramMGS(8)
    for seed in (5, 6):
        V, w, T = _panel(7, 256, "f64", seed=seed)
        for k in range(8):
            h, _ = step(V, k, w, T)
            h_ref, _ = tf._mgs_ref(V, k, w, T)
            assert _rel(h.numpy(), h_ref.numpy()) <= TOL["f64"]


def _solve_both(method, N, dtype, mem, basis=None):
    D, A, b = _convdiff(N=N, dtype=dtype, seed=11)
    pdj = jdia_align(D.data, D.offsets, D.shape[0])
    pd = dia_align(A.data, A.offsets, A.shape[0])
    ot = offsets_tensor(A.offsets, "cpu")
    rtol = 1e-10 if dtype == np.float64 else 1e-6
    mem = N ** 3 if mem == "n" else mem
    kw = {} if basis is None else {"basis_dtype": jnp.bfloat16}
    rj = getattr(jf, method + "_dia_fused")(
        pdj, D.offsets, jnp.asarray(b), 0.0, rtol, 400, mem=mem,
        interpret=True, **kw)
    bt = torch.float64 if dtype == np.float64 else torch.float32
    if method == "gmres":
        col = tf._GmresColumn(mem, bt, torch.tensor(
            torch.finfo(bt).eps ** 0.75, dtype=bt))
    else:
        col = tf._FomColumn(mem, bt)
    rt_ = tf._arnoldi_ref(pd, ot, torch.as_tensor(b), 0.0, rtol, 400, mem,
                          None if basis is None else torch.bfloat16, col,
                          step=tf._GramMGS(mem))
    return rj, rt_


@pytest.mark.parametrize("method", ["gmres", "fom"])
@pytest.mark.parametrize("N,mem", [(8, 3), (8, 20), (8, "n"), (10, 3),
                                   (10, 20)])
def test_gram_solves_match_jax_kernel_f64(method, N, mem):
    """Whole f64 solves with the kernel's arithmetic against the JAX
    kernels (sequential MGS) at memory 3, 20 and n: status, niter, the
    inconsistent flag and npass equal, x to 1e-10 relative (rtol 1e-10,
    the same iterations; the two orthogonalisations differ by a few ulps
    a step, which the Hessenberg's least-squares solution does not
    amplify past 1e-10)."""
    rj, rt_ = _solve_both(method, N, np.float64, mem)
    assert [int(rt_[i]) for i in (1, 3, 4, 5)] == \
        [int(rj[i]) for i in (1, 3, 4, 5)]
    assert _rel(rt_[0].numpy(), rj[0]) <= 1e-10


@pytest.mark.parametrize("method,basis,mem", [
    ("gmres", None, 3), ("gmres", None, 20), ("gmres", None, "n"),
    ("fom", None, 3), ("fom", None, 20), ("fom", None, "n"),
    ("gmres", "bf16", 3), ("gmres", "bf16", 20)])
def test_gram_solves_match_jax_kernel_f32(method, basis, mem):
    """Whole f32 solves at 8^3 (and GMRES with a bf16 panel, confirmed on
    the true residual, at memory 3 and 20: at memory n its pass never
    ends before itmax, and 400 steps of the mirror's forward substitution
    in Python take two minutes) against the JAX kernels: status equal, niter
    within ±max(2, 10%) (the band of tests/reference_niter.json: the
    stopping iteration moves with the order of f32 sums), x to 1e-3
    relative (two solves stopped at rtol 1e-6 on a system of condition
    number about 1e2)."""
    rj, rt_ = _solve_both(method, 8, np.float32, mem, basis)
    assert int(rt_[3]) == int(rj[3])
    assert abs(int(rt_[1]) - int(rj[1])) <= max(2, 0.1 * int(rj[1]))
    assert _rel(rt_[0].numpy(), rj[0]) <= 1e-3
