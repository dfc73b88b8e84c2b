"""L0 kernel layer ("k-ops"), counterpart of ``krylov_tpu/ops/kops.py``.

The reductions, the compensated Dot2 reduction, the trust-region
boundary step and the symmetric Givens reflection, as torch expressions.  Every function is
branchless over tensors, so a solver can call it inside a chunk of
masked iterations without the host waiting for the device.
"""

import torch


# ---------------------------------------------------------------------------
# reductions
# ---------------------------------------------------------------------------

def kdot(x, y):
    """⟨x, y⟩ with conjugation on x (BLAS dotc semantics)."""
    return torch.sum(torch.conj(x) * y)


def kdotr(x, y):
    """Real part of ⟨x, y⟩ (reference kdotr, src/krylov_utils.jl:318)."""
    d = kdot(x, y)
    return d.real if d.is_complex() else d


def knorm(x):
    """Euclidean norm, always real."""
    return torch.sqrt(kdotr(x, x))


def knorm_elliptic(x, mx):
    """Elliptic norm √(xᴴ M x) given x and Mx (reference knorm_elliptic)."""
    return torch.sqrt(kdotr(x, mx))


# ---------------------------------------------------------------------------
# compensated (double-word) reductions: Ogita-Rump-Oishi Dot2.  The
# product error terms from TwoProd and the running-sum error terms from
# TwoSum are accumulated separately and folded back in, giving results as
# if computed in twice the working precision.
# ---------------------------------------------------------------------------

_SPLITTER = {torch.float32: 4097.0, torch.float64: 134217729.0,
             torch.bfloat16: 17.0}


def _dekker_split(a):
    """Split a into hi + lo with hi carrying the top half of the mantissa."""
    c = _SPLITTER[a.dtype] * a
    hi = c - (c - a)
    lo = a - hi
    return hi, lo


def _two_prod_vec(a, b):
    """Vectorized TwoProd via Dekker splitting (no FMA required)."""
    p = a * b
    ah, al = _dekker_split(a)
    bh, bl = _dekker_split(b)
    err = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, err


def _comp_pairwise_sum(v):
    """Compensated pairwise summation: a TwoSum reduction tree whose
    per-level error terms are folded back in (Sum2-grade accuracy)."""
    err = torch.zeros((), dtype=v.dtype, device=v.device)
    while v.shape[0] > 1:
        if v.shape[0] % 2:
            v = torch.cat([v, v.new_zeros(1)])
        a, b = v[0::2], v[1::2]
        s = a + b
        bp = s - a
        e = (a - (s - bp)) + (b - bp)
        err = err + torch.sum(e)
        v = s
    return v[0] + err


def kdotr2(x, y):
    """Compensated Re⟨x, y⟩ (Ogita-Rump-Oishi Dot2, vectorized)."""
    if x.is_complex() or y.is_complex():
        return kdotr2(x.real, y.real) + kdotr2(x.imag, y.imag)
    p, err = _two_prod_vec(x, y)
    return _comp_pairwise_sum(p) + _comp_pairwise_sum(err)


# ---------------------------------------------------------------------------
# Givens reflections
# ---------------------------------------------------------------------------

def _sym_givens_real(a, b):
    abs_a, abs_b = torch.abs(a), torch.abs(b)
    b_zero = abs_b == 0
    a_zero = abs_a == 0
    b_dominant = abs_b > abs_a
    one, zero = torch.ones_like(a), torch.zeros_like(a)

    # |b| > |a|: t = a/b, s = sign(b)/√(1+t²), c = s·t, ρ = b/s
    t3 = a / _safe(b, b_zero)
    s3 = torch.sign(b) / torch.sqrt(one + t3 * t3)
    c3 = s3 * t3
    rho3 = b / _safe(s3, s3 == 0)

    # |a| ≥ |b|: t = b/a, c = sign(a)/√(1+t²), s = c·t, ρ = a/c
    t4 = b / _safe(a, a_zero)
    c4 = torch.sign(a) / torch.sqrt(one + t4 * t4)
    s4 = c4 * t4
    rho4 = a / _safe(c4, c4 == 0)

    # sign(0) = 0; sign(a) + iszero(a) makes sym_givens(0, 0) = (1, 0, 0)
    c = torch.where(b_zero, torch.sign(a) + a_zero.to(a.dtype),
                    torch.where(a_zero, zero,
                                torch.where(b_dominant, c3, c4)))
    s = torch.where(b_zero, zero,
                    torch.where(a_zero, torch.sign(b),
                                torch.where(b_dominant, s3, s4)))
    rho = torch.where(b_zero, abs_a,
                      torch.where(a_zero, abs_b,
                                  torch.where(b_dominant, rho3, rho4)))
    return c, s, rho


def _sym_givens_complex(a, b):
    abs_a, abs_b = torch.abs(a), torch.abs(b)
    b_zero = abs_b == 0
    a_zero = abs_a == 0
    b_dominant = abs_b > abs_a
    one_r = torch.ones_like(abs_a)
    # phase factor conj((b/|b|)/(a/|a|)); safe where either is zero
    phase = torch.conj((b / _safe(abs_b, b_zero).to(a.dtype))
                       / (a / _safe(abs_a, a_zero).to(a.dtype)))

    # |b| > |a|: t = |a|/|b|, c₀ = 1/√(1+t²), s = c₀·phase, c = c₀·t,
    # ρ = b/conj(s)
    t3 = abs_a / _safe(abs_b, b_zero)
    c0_3 = one_r / torch.sqrt(one_r + t3 * t3)
    s3 = c0_3.to(a.dtype) * phase
    c3 = c0_3 * t3
    rho3 = b / _safe(torch.conj(s3), s3 == 0)

    # |a| ≥ |b|: t = |b|/|a|, c = 1/√(1+t²), s = c·t·phase, ρ = a/c
    t4 = abs_b / _safe(abs_a, a_zero)
    c4 = one_r / torch.sqrt(one_r + t4 * t4)
    s4 = (c4 * t4).to(a.dtype) * phase
    rho4 = a / _safe(c4, c4 == 0).to(a.dtype)

    c = torch.where(b_zero, one_r,
                    torch.where(a_zero, torch.zeros_like(abs_a),
                                torch.where(b_dominant, c3, c4)))
    s = torch.where(b_zero, torch.zeros_like(a),
                    torch.where(a_zero, torch.ones_like(a),
                                torch.where(b_dominant, s3, s4)))
    rho = torch.where(b_zero, a,
                      torch.where(a_zero, b,
                                  torch.where(b_dominant, rho3, rho4)))
    return c, s, rho


def sym_givens(a, b):
    """Numerically stable symmetric Givens reflection.

    Returns (c, s, ρ) with [c s; s̄ -c] applied to [a; b] giving [ρ; 0].
    c is always real; s and ρ take the (possibly complex) promoted type
    of a and b.  The branch structure is the JAX package's
    (krylov_tpu/ops/kops.py:161-240, reference src/krylov_utils.jl:21-97),
    branchless over 0-d tensors, with sym_givens(0, 0) = (1, 0, 0).
    """
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    dt = torch.promote_types(a.dtype, b.dtype)
    a, b = a.to(dt), b.to(dt)
    if dt.is_complex:
        return _sym_givens_complex(a, b)
    return _sym_givens_real(a, b)


# ---------------------------------------------------------------------------
# quadratic roots & trust-region boundary
# ---------------------------------------------------------------------------

def _safe(d, zero_pred):
    """Replace d by 1 where zero_pred, to make untaken where-branches finite."""
    return torch.where(zero_pred, torch.ones_like(d), d)


def roots_quadratic(q2, q1, q0, nitref=1):
    """Real roots of q(x) = q₂x² + q₁x + q₀, cancellation-safe.

    Branchless version of reference src/krylov_utils.jl:110-152 over 0-d
    tensors, including the ill-conditioned |q₀q₂| ≤ √eps·q₁² fallback
    and ``nitref`` Newton refinement steps.  Like the traced JAX version
    it does not raise on complex roots (their discriminant clamps to 0).
    """
    q1 = q1.to(q2.dtype)
    q0 = q0.to(q2.dtype)
    eps_t = torch.finfo(q2.dtype).eps

    linear = q2 == 0
    lin_root = torch.where(q1 == 0, torch.zeros_like(q0),
                           -q0 / _safe(q1, q1 == 0))

    well_cond = torch.abs(q0 * q2) > (eps_t ** 0.5) * q1 * q1
    disc = q1 * q1 - 4 * q2 * q0
    d = -(q1 + torch.copysign(torch.sqrt(torch.clamp(disc, min=0)), q1)) / 2
    safe_q2 = _safe(q2, linear)
    root1_w = d / safe_q2
    root2_w = q0 / _safe(d, d == 0)
    root1_i = -q1 / safe_q2
    root2_i = torch.zeros_like(q0)

    root1 = torch.where(linear, lin_root,
                        torch.where(well_cond, root1_w, root1_i))
    root2 = torch.where(linear, lin_root,
                        torch.where(well_cond, root2_w, root2_i))

    def refine(root):
        for _ in range(nitref):
            q = (q2 * root + q1) * root + q0
            dq = 2 * q2 * root + q1
            root = torch.where(dq == 0, root, root - q / _safe(dq, dq == 0))
        return root

    return refine(root1), refine(root2)


def to_boundary(x, d, radius, flip=False, xNorm2=None, dNorm2=None,
                M_apply=None):
    """σ₁, σ₂ with ‖x + σᵢ d‖ = radius (M-elliptic norm if M_apply given).

    Counterpart of reference src/krylov_utils.jl:375-402.  ``M_apply``
    is a callable v ↦ Mv (already resolved for ldiv).  Returns both
    roots; callers take the max.
    """
    if M_apply is None:
        rxd = kdotr(x, d)
        dn2 = kdotr(d, d) if dNorm2 is None else dNorm2
        xn2 = kdotr(x, x) if xNorm2 is None else xNorm2
    else:
        mx = M_apply(x)
        rxd = kdotr(mx, d)
        xn2 = kdotr(mx, x)
        md = M_apply(d)
        dn2 = kdotr(md, d)
    if flip:
        rxd = -rxd
    radius2 = radius * radius
    return roots_quadratic(dn2, 2 * rxd, xn2 - radius2)

