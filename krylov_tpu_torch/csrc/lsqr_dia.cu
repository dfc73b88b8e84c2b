// Whole LSQR solve of min ||b - A x|| (+ lambda) for a DIA matrix on
// Hopper (sm_90a), with no grid-wide barrier.
//
// Replaces the TPU kernel krylov_tpu/ops/pallas_fused.py:1394
// lsqr_dia_fused and computes what it computes (pallas_fused.py:
// 1433-1569): Golub-Kahan over A and A^H, the rotation against lambda,
// the Paige-Saunders stopping rules (axtol, btol, conlim, atol and rtol
// on ||A^H r||), the ||x|| estimate and the etol error window.  Outputs:
// x, niter, rnorm, arnorm, the status code and the last zero-residual
// test.
//
// Bound on an H100 SXM: memory bandwidth.  An iteration applies A and
// A^H once each (2 x 28 B per row in f32 for the 7-point stencil) and
// must read and write u, v, x and w: (56 + 32) B per row, 88 B.
//
// Design: the launches of gk.cuh, with
//   3. the update: LSQR's scalar step (both rotations, the ||x||
//      rotation, the tests) in thread 0 of every block, with ||w_k||^2
//      summed from the partials launch 3 of the last iteration took as
//      it wrote w_k; x += sigma w and w = v - (theta / rho) w row by row,
//      with the partials of ||w_{k+1}||^2.
// Per iteration this design moves (28 + 12) + (28 + 12) + 32 B per row
// in f32: 112 B.
#include "gk.cuh"

namespace {

using namespace gk;

// slots of the scalar and int arrays after the shared ones
enum ScalarSlot {
  BETA1 = ALPHA + 1, ARNORM0, PHIBAR, RHOBAR, ANORM2, DNORM2, XNORM2, RES2,
  C2, S2, ZSC, XENORM2, RNORM, ARNORM, ERR_NEW, NSC_STATE,
  NSC = 2 * NSC_STATE - ALPHA
};
enum IntSlot { NST_STATE = ZR + 1, NST = 2 * NST_STATE - STATUS };
// the method's own rows of the vector workspace
enum OwnRow { W = NSHARED_ROWS, NROWS };

struct Lsqr : Hooks {
  static constexpr int kRows = NROWS - NSHARED_ROWS;
  static constexpr int kNscState = NSC_STATE;
  static constexpr int kNstState = NST_STATE;
  static constexpr int kErrNew = ERR_NEW;

  // the window holds the last `window` phi, oldest first from slot
  // (it + 1) mod window (pallas_fused.py:1513-1518)
  __device__ static int ring_slot(int it0, int window) {
    return (it0 + 1) % window;
  }

  template <typename T>
  struct Coef {
    T xs, wc;
  };

  // w_1 = v_1; the partials of ||w_1||^2
  template <typename T>
  __device__ static T init_row(T* work, const T*, long long n, long long i,
                                T v1, T, int) {
    row(work, W, n)[i] = v1;
    return v1 * v1;
  }

  // the first state and the solved tests before the loop
  // (pallas_fused.py:1453-1466)
  template <typename T>
  __device__ static void init_scalars(T* sc, int* st, T alpha, T beta1,
                                      T anorm2, int) {
    const T arnorm0 = alpha * beta1;
    sc[ALPHA] = alpha;
    sc[BETA1] = beta1;
    sc[ARNORM0] = arnorm0;
    sc[PHIBAR] = beta1;
    sc[RHOBAR] = alpha;
    sc[ANORM2] = anorm2;
    sc[C2] = T(-1);
    sc[RNORM] = beta1;
    sc[ARNORM] = arnorm0;
    int status = beta1 == T(0) ? ZERO_RESIDUAL
                 : alpha == T(0) ? MIN_LSQ_X : RUNNING;
    const T t2 = arnorm0 / (sqrt(fmax(anorm2, tiny_of<T>())) * safe(beta1));
    if (status == RUNNING && (t2 <= sc[AXTOL] || T(1) + t2 <= T(1))) {
      status = SOLVED_LSQ;
    }
    st[STATUS] = status;
  }

  // One iteration's scalars, as the TPU kernel (pallas_fused.py:
  // 1480-1567); ww = ||w_k||^2.
  template <typename T>
  __device__ static Coef<T> step(const T* sc, const int* st, T alpha_n,
                                 T beta_n, T ww, int it, int, int window,
                                 T* nsc, int* nst) {
    const T tiny = tiny_of<T>();
    const T lam = sc[LAM];
    const T alpha = sc[ALPHA];
    const T beta1 = sc[BETA1];
    const T axtol = sc[AXTOL];
    const bool bnz = beta_n != T(0);
    const T anorm2 = bnz ? sc[ANORM2] + alpha * alpha + beta_n * beta_n
                               + (lam > T(0) ? lam * lam : T(0))
                         : sc[ANORM2];
    // rotation 1 eliminates lambda, rotation 2 beta
    T c1, s1, rhobar1;
    sym_givens(sc[RHOBAR], lam, c1, s1, rhobar1);
    const T psi = s1 * sc[PHIBAR];
    const T phibar_mid = c1 * sc[PHIBAR];
    T cg, sg, rho;
    sym_givens(rhobar1, beta_n, cg, sg, rho);
    const T phi = cg * phibar_mid;
    const T phibar = sg * phibar_mid;
    const T xenorm2 = sc[XENORM2] + phi * phi;
    const T err_lbnd = window_norm<Lsqr>(sc, window, (it + 1) % window,
                                         it % window, phi);
    const T tau = sg * phi;
    const T theta = sg * alpha_n;
    const T rhobar = -cg * alpha_n;
    const T safe_rho = safe(rho);
    const T dnorm2 = sc[DNORM2] + ww / (safe_rho * safe_rho);
    const T sigma = phi / safe_rho;
    // the right rotation that estimates ||x|| (pallas_fused.py:1531-1540)
    const T delta = sc[S2] * rho;
    const T gbar = -sc[C2] * rho;
    const T rhs = phi - delta * sc[ZSC];
    const T zbar = rhs / safe(gbar);
    const T xnorm = sqrt(sc[XNORM2] + zbar * zbar);
    T c2, s2, gamma;
    sym_givens(gbar, theta, c2, s2, gamma);
    const T zsc = rhs / safe(gamma);
    const T anorm = sqrt(anorm2);
    const T acond = anorm * sqrt(dnorm2);
    const T res2 = sc[RES2] + psi * psi;
    const T rnorm = sqrt(phibar * phibar + res2);
    const T arnorm = alpha_n * fabs(tau);
    const T test1 = rnorm / beta1;
    const T test2 = arnorm / fmax(anorm * rnorm, tiny);
    const T test3 = T(1) / fmax(acond, tiny);
    const T t1 = test1 / (T(1) + anorm * xnorm / beta1);
    const T rnormtol = sc[BTOL] + axtol * anorm * xnorm / beta1;
    const bool ill_cond_mach = T(1) + test3 <= T(1);
    const bool ill_cond_lim = test3 <= ctol_of(sc);
    const bool zero_r = T(1) + t1 <= T(1) || test1 <= rnormtol;
    const bool fwd_err = it >= window && err_lbnd <= sc[ETOL] * sqrt(xenorm2);
    const bool solved = T(1) + test2 <= T(1) || test2 <= axtol ||
                        arnorm <= sc[ATOL] + sc[RTOL] * sc[ARNORM0] ||
                        zero_r || fwd_err;
    if (nsc != nullptr) {
      stage_state<T, Lsqr>(sc, st, nsc, nst);
      nsc[ALPHA] = alpha_n;
      nsc[PHIBAR] = phibar;
      nsc[RHOBAR] = rhobar;
      nsc[ANORM2] = anorm2;
      nsc[DNORM2] = dnorm2;
      nsc[XNORM2] = sc[XNORM2] + zsc * zsc;
      nsc[RES2] = res2;
      nsc[C2] = c2;
      nsc[S2] = s2;
      nsc[ZSC] = zsc;
      nsc[XENORM2] = xenorm2;
      nsc[RNORM] = rnorm;
      nsc[ARNORM] = arnorm;
      nsc[ERR_NEW] = phi;
      int code = RUNNING;
      if (ill_cond_mach) code = ILL_COND_MACH;
      if (ill_cond_lim) code = COND_EXCEEDED;
      if (solved) code = SOLVED_LSQ;
      if (solved && zero_r) code = SOLVED_ZERO;
      if (solved && fwd_err) code = FWD_ERR;
      nst[STATUS] = code;
      nst[ZR] = zero_r ? 1 : 0;
    }
    return Coef<T>{sigma, theta / safe_rho};
  }

  // x += sigma w, w = v - (theta / rho) w; the partials of ||w||^2
  // (pallas_fused.py:1527-1529)
  template <typename T>
  __device__ static T update_row(T* work, const Coef<T>& k, long long n,
                                 long long i, T v) {
    T* x = row(work, X, n);
    T* w = row(work, W, n);
    const T wi = w[i];
    x[i] = x[i] + k.xs * wi;
    const T wn = v - k.wc * wi;
    w[i] = wn;
    return wn * wn;
  }

  template <typename T>
  __device__ static void commit(T*, int*, const T*, int, int, int) {}
};

}  // namespace

KTT_GK_INIT(ktt_lsqr_dia_init_f32_f32, float, float, Lsqr)
KTT_GK_INIT(ktt_lsqr_dia_init_f32_bf16, float, __nv_bfloat16, Lsqr)
KTT_GK_INIT(ktt_lsqr_dia_init_f32_f16, float, __half, Lsqr)
KTT_GK_INIT(ktt_lsqr_dia_init_f64_f64, double, double, Lsqr)
KTT_GK_ITERATE(ktt_lsqr_dia_iterate_f32_f32, float, float, Lsqr)
KTT_GK_ITERATE(ktt_lsqr_dia_iterate_f32_bf16, float, __nv_bfloat16, Lsqr)
KTT_GK_ITERATE(ktt_lsqr_dia_iterate_f32_f16, float, __half, Lsqr)
KTT_GK_ITERATE(ktt_lsqr_dia_iterate_f64_f64, double, double, Lsqr)
