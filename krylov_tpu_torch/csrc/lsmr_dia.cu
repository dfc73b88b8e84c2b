// Whole LSMR solve of min ||b - A x|| (+ lambda) for a DIA matrix on
// Hopper (sm_90a), with no grid-wide barrier.
//
// Replaces the TPU kernel krylov_tpu/ops/pallas_fused.py:1641
// lsmr_dia_fused and computes what it computes (pallas_fused.py:
// 1680-1856): Golub-Kahan over A and A^H, LSMR's rotations (lambda, beta,
// and the ||A^H r||-monotone pair), the ||r||, ||A||, cond(A) and ||x||
// estimates, the Paige-Saunders stopping rules and the etol error
// window.  Outputs: x, niter, rnorm, arnorm, acond, anorm, xnorm, the
// status code and the last zero-residual test.
//
// Bound on an H100 SXM: memory bandwidth.  An iteration applies A and
// A^H once each (2 x 28 B per row in f32 for the 7-point stencil) and
// must read and write u, v, x, h and h_bar: (56 + 40) B per row, 96 B.
//
// Design: the launches of gk.cuh, with
//   3. the update: LSMR's rotations and estimate recurrences in thread 0
//      of every block; h_bar = h - delta h_bar, x += sigma h_bar and
//      h = v - (theta / rho) h row by row, with the partials of
//      ||x_{k+1}||^2;
//   4. the commit: the stopping tests, which read ||x_{k+1}||
//      (pallas_fused.py:1817-1825), on the staged state, before it is
//      copied in.
// Per iteration this design moves (28 + 12) + (28 + 12) + 40 B per row
// in f32: 120 B.
#include "gk.cuh"

namespace {

using namespace gk;

// slots of the scalar and int arrays after the shared ones
enum ScalarSlot {
  BETA1 = ALPHA + 1, ARNORM0, ZETABAR, ALPHABAR, RHO, RHOBAR, CBAR, SBAR,
  BETADD, BETAD, RHODOLD, TAUTILDEOLD, THETATILDE, ZETA, DD, ANORM2, MAXRBAR,
  MINRBAR, XENORM2, RNORM, ARNORM, ACOND, ANORM, XNORM, ERR_NEW, ERR_LBND,
  NSC_STATE, NSC = 2 * NSC_STATE - ALPHA
};
enum IntSlot { NST_STATE = ZR + 1, NST = 2 * NST_STATE - STATUS };
// the method's own rows of the vector workspace
enum OwnRow { H = NSHARED_ROWS, HBAR, NROWS };

struct Lsmr : Hooks {
  static constexpr int kRows = NROWS - NSHARED_ROWS;
  static constexpr int kNscState = NSC_STATE;
  static constexpr int kNstState = NST_STATE;
  static constexpr int kErrNew = ERR_NEW;

  // the window holds the last `window` zeta, oldest first from slot
  // (it + 1) mod window (pallas_fused.py:1772-1776)
  __device__ static int ring_slot(int it0, int window) {
    return (it0 + 1) % window;
  }

  template <typename T>
  struct Coef {
    T delta, sigma, hc;
  };

  // h_1 = v_1, h_bar = 0
  template <typename T>
  __device__ static T init_row(T* work, const T*, long long n, long long i,
                                T v1, T, int) {
    row(work, H, n)[i] = v1;
    row(work, HBAR, n)[i] = T(0);
    return T(0);
  }

  // the first state (pallas_fused.py:1710-1724)
  template <typename T>
  __device__ static void init_scalars(T* sc, int* st, T alpha, T beta1, T,
                                      int) {
    sc[ALPHA] = alpha;
    sc[BETA1] = beta1;
    sc[ARNORM0] = alpha * beta1;
    sc[ZETABAR] = alpha * beta1;
    sc[ALPHABAR] = alpha;
    sc[RHO] = T(1);
    sc[RHOBAR] = T(1);
    sc[CBAR] = T(1);
    sc[BETADD] = beta1;
    sc[RHODOLD] = T(1);
    sc[ANORM2] = alpha * alpha;
    sc[MINRBAR] = max_of<T>();
    sc[RNORM] = beta1;
    sc[ARNORM] = alpha * beta1;
    sc[ANORM] = alpha;
    st[STATUS] = beta1 == T(0)       ? ZERO_RESIDUAL
                 : alpha == T(0)     ? MIN_LSQ_X
                 : beta1 <= sc[AXTOL] ? SOLVED_LSQ
                                     : RUNNING;
  }

  // One iteration's rotations and estimates, as the TPU kernel
  // (pallas_fused.py:1758-1815); the tests run in commit.
  template <typename T>
  __device__ static Coef<T> step(const T* sc, const int* st, T alpha_n,
                                 T beta_n, T, int it, int, int window,
                                 T* nsc, int* nst) {
    const T tiny = tiny_of<T>();
    T chat, shat, alphahat;
    sym_givens(sc[ALPHABAR], sc[LAM], chat, shat, alphahat);
    const T rhoold = sc[RHO];
    T cg, sg, rho;
    sym_givens(alphahat, beta_n, cg, sg, rho);
    const T thetanew = sg * alpha_n;
    const T rhobarold = sc[RHOBAR];
    const T zetaold = sc[ZETA];
    const T thetabar = sc[SBAR] * rho;
    const T rhotemp = sc[CBAR] * rho;
    T cbar, sbar, rhobar;
    sym_givens(rhotemp, thetanew, cbar, sbar, rhobar);
    const T zeta = cbar * sc[ZETABAR];
    const T zetabar = -sbar * sc[ZETABAR];
    const T xenorm2 = sc[XENORM2] + zeta * zeta;
    const T err_lbnd = window_norm<Lsmr>(sc, window, (it + 1) % window,
                                         it % window, zeta);
    const T delta = thetabar * rho / fmax(rhoold * rhobarold, tiny);
    const T sigma = zeta / fmax(rho * rhobar, tiny);
    const T hc = thetanew / fmax(rho, tiny);
    if (nsc != nullptr) {
      // the ||r|| estimate recurrences (pallas_fused.py:1790-1807)
      const T betaacute = chat * sc[BETADD];
      const T betacheck = -shat * sc[BETADD];
      const T betahat = cg * betaacute;
      const T betadd = -sg * betaacute;
      const T thetatildeold = sc[THETATILDE];
      T ctildeold, stildeold, rhotildeold;
      sym_givens(sc[RHODOLD], thetabar, ctildeold, stildeold, rhotildeold);
      const T thetatilde = stildeold * rhobar;
      const T rhodold = ctildeold * rhobar;
      const T betad = -stildeold * sc[BETAD] + ctildeold * betahat;
      const T tautildeold = (zetaold - thetatildeold * sc[TAUTILDEOLD]) /
                            fmax(rhotildeold, tiny);
      const T taud = (zeta - thetatilde * tautildeold) / fmax(rhodold, tiny);
      const T dd = sc[DD] + betacheck * betacheck;
      const T anorm2_mid = sc[ANORM2] + beta_n * beta_n;
      const T maxrbar = fmax(sc[MAXRBAR], rhobarold);
      const T minrbar = it > 1 ? fmin(sc[MINRBAR], rhobarold) : sc[MINRBAR];
      stage_state<T, Lsmr>(sc, st, nsc, nst);
      nsc[ALPHA] = alpha_n;
      nsc[ZETABAR] = zetabar;
      nsc[ALPHABAR] = cg * alpha_n;
      nsc[RHO] = rho;
      nsc[RHOBAR] = rhobar;
      nsc[CBAR] = cbar;
      nsc[SBAR] = sbar;
      nsc[BETADD] = betadd;
      nsc[BETAD] = betad;
      nsc[RHODOLD] = rhodold;
      nsc[TAUTILDEOLD] = tautildeold;
      nsc[THETATILDE] = thetatilde;
      nsc[ZETA] = zeta;
      nsc[DD] = dd;
      nsc[ANORM2] = anorm2_mid + alpha_n * alpha_n;
      nsc[MAXRBAR] = maxrbar;
      nsc[MINRBAR] = minrbar;
      nsc[XENORM2] = xenorm2;
      nsc[RNORM] = sqrt(dd + sq(betad - taud) + betadd * betadd);
      nsc[ARNORM] = fabs(zetabar);
      nsc[ACOND] = fmax(maxrbar, rhotemp) / fmax(fmin(minrbar, rhotemp), tiny);
      nsc[ANORM] = sqrt(anorm2_mid);
      nsc[ERR_NEW] = zeta;
      nsc[ERR_LBND] = err_lbnd;
    }
    return Coef<T>{delta, sigma, hc};
  }

  // h_bar = h - delta h_bar, x += sigma h_bar, h = v - (theta / rho) h;
  // the partials of ||x||^2 (pallas_fused.py:1783-1788)
  template <typename T>
  __device__ static T update_row(T* work, const Coef<T>& k, long long n,
                                 long long i, T v) {
    T* x = row(work, X, n);
    T* h = row(work, H, n);
    T* hbar = row(work, HBAR, n);
    const T hi = h[i];
    const T hb = hi - k.delta * hbar[i];
    hbar[i] = hb;
    const T xi = x[i] + k.sigma * hb;
    x[i] = xi;
    h[i] = v - k.hc * hi;
    return xi * xi;
  }

  // The stopping tests on the staged state and ||x_{k+1}||, summed from
  // launch 3's partials by the whole block (pallas_fused.py:1817-1842).
  template <typename T>
  __device__ static void commit(T* nsc, int* nst, const T* xx_partial,
                                int nparts, int it, int window) {
    const T xx = sum_partials(xx_partial, nparts);
    if (threadIdx.x != 0) return;
    const T tiny = tiny_of<T>();
    const T xnorm = sqrt(xx);
    const T beta1 = nsc[BETA1];
    nsc[XNORM] = xnorm;
    // the parameters are not staged: read them below the staging copy
    const T* sc = nsc - (NSC_STATE - ALPHA);
    const T rnorm = nsc[RNORM];
    const T arnorm = nsc[ARNORM];
    const T anorm = nsc[ANORM];
    const T test1 = rnorm / beta1;
    const T test2 = arnorm / fmax(anorm * rnorm, tiny);
    const T test3 = T(1) / fmax(nsc[ACOND], tiny);
    const T t1 = test1 / (T(1) + anorm * xnorm / beta1);
    const T rnormtol = sc[BTOL] + sc[AXTOL] * anorm * xnorm / beta1;
    const bool ill_cond_mach = T(1) + test3 <= T(1);
    const bool ill_cond_lim = test3 <= ctol_of(sc);
    const bool zero_r = T(1) + t1 <= T(1) || test1 <= rnormtol;
    const bool fwd_err =
        it >= window && nsc[ERR_LBND] <= sc[ETOL] * sqrt(nsc[XENORM2]);
    const bool solved = T(1) + test2 <= T(1) || test2 <= sc[AXTOL] ||
                        arnorm <= sc[ATOL] + sc[RTOL] * nsc[ARNORM0] ||
                        zero_r || fwd_err;
    int code = RUNNING;
    if (ill_cond_mach) code = ILL_COND_MACH;
    if (ill_cond_lim) code = COND_EXCEEDED;
    if (solved) code = SOLVED_LSQ;
    if (solved && zero_r) code = SOLVED_ZERO;
    if (solved && fwd_err) code = FWD_ERR;
    nst[STATUS] = code;
    nst[ZR] = zero_r ? 1 : 0;
  }
};

}  // namespace

KTT_GK_INIT(ktt_lsmr_dia_init_f32_f32, float, float, Lsmr)
KTT_GK_INIT(ktt_lsmr_dia_init_f32_bf16, float, __nv_bfloat16, Lsmr)
KTT_GK_INIT(ktt_lsmr_dia_init_f32_f16, float, __half, Lsmr)
KTT_GK_INIT(ktt_lsmr_dia_init_f64_f64, double, double, Lsmr)
KTT_GK_ITERATE(ktt_lsmr_dia_iterate_f32_f32, float, float, Lsmr)
KTT_GK_ITERATE(ktt_lsmr_dia_iterate_f32_bf16, float, __nv_bfloat16, Lsmr)
KTT_GK_ITERATE(ktt_lsmr_dia_iterate_f32_f16, float, __half, Lsmr)
KTT_GK_ITERATE(ktt_lsmr_dia_iterate_f64_f64, double, double, Lsmr)
