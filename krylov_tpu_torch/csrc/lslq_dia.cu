// Whole LSLQ solve of min ||b - A x|| (+ lambda) for a DIA matrix on
// Hopper (sm_90a), with no grid-wide barrier.
//
// Replaces the TPU kernel krylov_tpu/ops/pallas_fused.py:6942
// lslq_dia_fused and computes what it computes (pallas_fused.py:
// 6968-7164): Golub-Kahan over A and A^H, the LQ recurrences with the
// lambda registers, the sigma error-bound machinery (flag bit 1), the
// forward-error window and, with transfer_to_lsqr (flag bit 2), the move
// of x to the LSQR point after the loop.  Outputs: x, niter, rnorm,
// arnorm, the status code, the last zero-residual test and whether an
// error bound went complex.
//
// Bound on an H100 SXM: memory bandwidth.  An iteration applies A and
// A^H once each (2 x 28 B per row in f32 for the 7-point stencil) and
// must read and write u, v, x and w_bar: (56 + 32) B per row, 88 B.
//
// Design: the launches of gk.cuh, with
//   3. the update: LSLQ's scalar step (the lambda rotation, the LQ
//      rotations, the sigma bounds, the tests) in thread 0 of every
//      block; x += c zeta w_bar + s zeta v and w_bar = s w_bar - c v row
//      by row
// and one finishing launch after the loop for the transfer,
// x += zeta_bar w_bar.  Per iteration this design moves
// (28 + 12) + (28 + 12) + 32 B per row in f32: 112 B.
#include "gk.cuh"

namespace {

using namespace gk;

constexpr int FWD_LBND = 44;
constexpr int FWD_UBND = 45;
constexpr int USE_SIGMA = 1;
constexpr int TRANSFER = 2;

// slots of the scalar and int arrays after the shared ones
enum ScalarSlot {
  LAMK = ALPHA + 1, BETA1, EPS_LIM, ANORM2, SMAX, SMIN, GBAR, PSI, C, S,
  DELTA, TAU, ZETA, ZETABAR, ZETATILDE, RHOBAR_SIG, CSIG, OMEGA, XLQNORM2,
  RNORM, ARNORM, ERR_NEW, NSC_STATE, NSC = 2 * NSC_STATE - ALPHA
};
enum IntSlot { CBND = ZR + 1, NST_STATE, NST = 2 * NST_STATE - STATUS };
// the method's own rows of the vector workspace
enum OwnRow { WBAR = NSHARED_ROWS, NROWS };

struct Lslq : Hooks {
  static constexpr int kRows = NROWS - NSHARED_ROWS;
  static constexpr int kNscState = NSC_STATE;
  static constexpr int kNstState = NST_STATE;
  static constexpr int kErrNew = ERR_NEW;

  // zeta goes to slot (it - 1) mod window, and the window is summed from
  // slot 0 on (pallas_fused.py:7102-7106)
  __device__ static int ring_slot(int it0, int window) {
    return it0 % window;
  }

  template <typename T>
  struct Coef {
    T xa, xb, c, s;
  };

  // w_bar = v_1
  template <typename T>
  __device__ static T init_row(T* work, const T*, long long n, long long i,
                                T v1, T, int) {
    row(work, WBAR, n)[i] = v1;
    return T(0);
  }

  // the first state (pallas_fused.py:6990-7004)
  template <typename T>
  __device__ static void init_scalars(T* sc, int* st, T alpha, T beta1, T,
                                      int) {
    const T eps_lim = sc[ATOL] + sc[RTOL] * beta1;
    sc[ALPHA] = alpha;
    sc[LAMK] = sc[LAM];
    sc[BETA1] = beta1;
    sc[EPS_LIM] = eps_lim;
    sc[ANORM2] = alpha * alpha;
    sc[SMIN] = T(INFINITY);
    sc[GBAR] = alpha;
    sc[PSI] = beta1;
    sc[C] = T(-1);
    sc[DELTA] = T(-1);
    sc[TAU] = alpha * beta1;
    sc[RHOBAR_SIG] = -sc[SIGMA];
    sc[CSIG] = T(-1);
    sc[RNORM] = beta1;
    sc[ARNORM] = alpha * beta1;
    st[STATUS] = beta1 == T(0)     ? ZERO_RESIDUAL
                 : alpha == T(0)   ? MIN_LSQ_X
                 : beta1 <= eps_lim ? SOLVED_ZERO
                                   : RUNNING;
  }

  // One iteration's scalars, as the TPU kernel (pallas_fused.py:
  // 7041-7143).
  template <typename T>
  __device__ static Coef<T> step(const T* sc, const int* st, T alpha_n,
                                 T beta_n, T, int it, int flag, int window,
                                 T* nsc, int* nst) {
    const T tiny = tiny_of<T>();
    const int it0 = it - 1;
    const T sigma = sc[SIGMA];
    const bool bnz = beta_n != T(0);
    const T lam_k = sc[LAMK];
    const bool lam_on = lam_k != T(0) && bnz;
    T cl, sl, blr;
    sym_givens(beta_n, lam_k, cl, sl, blr);
    const T al = lam_on ? cl * alpha_n : alpha_n;
    const T bl = lam_on ? blr : beta_n;
    const T lam_kn = lam_on ? sqrt(lam_k * lam_k + sq(sl * alpha_n)) : lam_k;
    const T anorm2 = bnz ? sc[ANORM2] + al * al + bl * bl : sc[ANORM2];
    const T anorm = sqrt(anorm2);
    T cp, sp, gamma;
    sym_givens(sc[GBAR], bl, cp, sp, gamma);
    const T tau = -sc[TAU] * sc[DELTA] / safe(gamma);
    const T delta = sp * al;
    const T gbar = -cp * al;
    // the sigma error-bound machinery (pallas_fused.py:7062-7077)
    const bool use_sigma = flag & USE_SIGMA;
    T rhobar_sig = sc[RHOBAR_SIG];
    T csig = sc[CSIG];
    T omega = sc[OMEGA];
    bool cbnd = st[CBND] == 1;
    if (use_sigma) {
      T mubar = -csig * gamma;
      T csig1, ssig1, rho1;
      sym_givens(rhobar_sig, gamma, csig1, ssig1, rho1);
      rhobar_sig = ssig1 * mubar + csig1 * sigma;
      mubar = -csig1 * delta;
      const T h = delta * csig1 / safe(rhobar_sig);
      const T disc = sigma * (sigma - delta * h);
      cbnd = cbnd || disc < T(0);
      if (disc >= T(0)) omega = sqrt(fmax(disc, T(0)));
      T csig2, ssig2, rho2;
      sym_givens(rhobar_sig, delta, csig2, ssig2, rho2);
      rhobar_sig = ssig2 * mubar + csig2 * sigma;
      csig = csig2;
    }
    const T ebar = -gamma * sc[C];
    const T eta = gamma * sc[S];
    T c, s, eps;
    sym_givens(ebar, delta, c, s, eps);
    const T smax = fmax(sc[SMAX], fmax(eps, fabs(ebar)));
    const T smin = fmin(sc[SMIN], fmin(eps, fabs(ebar)));
    const T acond = smax / fmax(smin, tiny);
    const T zold = sc[ZETA];
    const T zeta = (tau - zold * eta) / safe(eps);
    const T zetabar = zeta / safe(c);
    const T psi = sc[PSI];
    const T rnorm = sqrt(sq(psi * cp - zold * eta) + sq(psi * sp));
    const T arnorm = sqrt(sq(gamma * eps * zeta) + sq(delta * eta * zold));
    const T xlqnorm2 = sc[XLQNORM2] + zeta * zeta;
    const T xlqnorm = sqrt(xlqnorm2);
    const T xcgnorm2 = xlqnorm2 + zetabar * zetabar;
    const T err_lbnd = window_norm<Lslq>(sc, window, 0, it0 % window, zeta);
    const bool fwd_lbnd = it0 >= window && err_lbnd <= sc[ETOL] * xlqnorm;
    T zetatilde = sc[ZETATILDE];
    bool fwd_ubnd = false;
    if (use_sigma) {
      const T etat = omega * s;
      const T epst = -omega * c;
      const T taut = -tau * delta / safe(omega);
      const T disc_cg = sq(sc[ZETATILDE]) - sq(zetabar);
      zetatilde = (taut - zeta * etat) / safe(epst);
      cbnd = cbnd || (it0 > 0 && disc_cg < T(0));
      fwd_ubnd = it0 > 0 && disc_cg >= T(0) &&
                 sqrt(fmax(disc_cg, T(0))) <= sc[UTOL] * sqrt(xcgnorm2);
    }
    const T test2 = arnorm / fmax(anorm * rnorm, tiny);
    const T test3 = T(1) / fmax(acond, tiny);
    const T t1 = rnorm / (T(1) + anorm * xlqnorm);
    const bool zero_r = T(1) + t1 <= T(1) || rnorm <= sc[EPS_LIM];
    const bool solved = T(1) + test2 <= T(1) || test2 <= sc[ATOL] || zero_r ||
                        fwd_lbnd || fwd_ubnd;
    if (nsc != nullptr) {
      stage_state<T, Lslq>(sc, st, nsc, nst);
      nsc[ALPHA] = alpha_n;
      nsc[LAMK] = lam_kn;
      nsc[ANORM2] = anorm2;
      nsc[SMAX] = smax;
      nsc[SMIN] = smin;
      nsc[GBAR] = gbar;
      nsc[PSI] = psi * sp;
      nsc[C] = c;
      nsc[S] = s;
      nsc[DELTA] = delta;
      nsc[TAU] = tau;
      nsc[ZETA] = zeta;
      nsc[ZETABAR] = zetabar;
      nsc[ZETATILDE] = zetatilde;
      nsc[RHOBAR_SIG] = rhobar_sig;
      nsc[CSIG] = csig;
      nsc[OMEGA] = omega;
      nsc[XLQNORM2] = xlqnorm2;
      nsc[RNORM] = rnorm;
      nsc[ARNORM] = arnorm;
      nsc[ERR_NEW] = zeta;
      int code = RUNNING;
      if (T(1) + test3 <= T(1)) code = ILL_COND_MACH;
      if (test3 <= ctol_of(sc)) code = COND_EXCEEDED;
      if (solved) code = SOLVED_LSQ;
      if (zero_r) code = SOLVED_ZERO;
      if (fwd_lbnd) code = FWD_LBND;
      if (fwd_ubnd) code = FWD_UBND;
      nst[STATUS] = code;
      nst[ZR] = zero_r ? 1 : 0;
      nst[CBND] = cbnd ? 1 : 0;
    }
    return Coef<T>{c * zeta, s * zeta, c, s};
  }

  // x += c zeta w_bar + s zeta v, w_bar = s w_bar - c v
  // (pallas_fused.py:7095-7098)
  template <typename T>
  __device__ static T update_row(T* work, const Coef<T>& k, long long n,
                                 long long i, T v) {
    T* x = row(work, X, n);
    T* wbar = row(work, WBAR, n);
    const T wi = wbar[i];
    x[i] = x[i] + k.xa * wi + k.xb * v;
    wbar[i] = k.s * wi - k.c * v;
    return T(0);
  }

  template <typename T>
  __device__ static void commit(T*, int*, const T*, int, int, int) {}

  // After the loop: x += zeta_bar w_bar with transfer_to_lsqr, unless the
  // start settled the solve (pallas_fused.py:7155-7158).
  template <typename T>
  __device__ static bool finishes(const T*, const int* st, int flag) {
    return (flag & TRANSFER) && st[STATUS] != ZERO_RESIDUAL &&
           st[STATUS] != MIN_LSQ_X;
  }
  template <typename T>
  __device__ static void finish_row(T* work, const T* sc, long long n,
                                    long long i, int) {
    T* x = row(work, X, n);
    x[i] = x[i] + sc[ZETABAR] * row(work, WBAR, n)[i];
  }
};

}  // namespace

KTT_GK_INIT(ktt_lslq_dia_init_f32_f32, float, float, Lslq)
KTT_GK_INIT(ktt_lslq_dia_init_f32_bf16, float, __nv_bfloat16, Lslq)
KTT_GK_INIT(ktt_lslq_dia_init_f32_f16, float, __half, Lslq)
KTT_GK_INIT(ktt_lslq_dia_init_f64_f64, double, double, Lslq)
KTT_GK_ITERATE(ktt_lslq_dia_iterate_f32_f32, float, float, Lslq)
KTT_GK_ITERATE(ktt_lslq_dia_iterate_f32_bf16, float, __nv_bfloat16, Lslq)
KTT_GK_ITERATE(ktt_lslq_dia_iterate_f32_f16, float, __half, Lslq)
KTT_GK_ITERATE(ktt_lslq_dia_iterate_f64_f64, double, double, Lslq)
KTT_GK_FINISH(ktt_lslq_dia_finish_f32, float, Lslq)
KTT_GK_FINISH(ktt_lslq_dia_finish_f64, double, Lslq)
