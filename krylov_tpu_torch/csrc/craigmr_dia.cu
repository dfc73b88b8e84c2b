// Whole CRAIGMR solve of min ||x|| subject to A x = b (+ lambda), with
// ||r|| monotone, for a DIA matrix on Hopper (sm_90a), with no grid-wide
// barrier.
//
// Replaces the TPU kernel krylov_tpu/ops/pallas_fused.py:6132
// craigmr_dia_fused and computes what it computes (pallas_fused.py:
// 6166-6283): Golub-Kahan over A and A^H, the QR of the lower
// bidiagonal, the lambda registers (flag bit 1) with the first-iteration
// case of d, and the (||r||, ||A^H r||) stops.  Outputs: x, y, niter,
// rnorm, arnorm and the status code.
//
// Bound on an H100 SXM: memory bandwidth.  An iteration applies A and
// A^H once each (2 x 28 B per row in f32 for the 7-point stencil) and
// must read and write u, v, x, y, w, d and w_bar: (56 + 56) B per row,
// 112 B.
//
// Design: the launches of gk.cuh, with
//   2. A^H u_{k+1}: before v_k goes under v_hat at a row, the rotation of
//      (rho_bar, beta_hat) from beta_{k+1} in every block, then
//      w = (w_bar - theta w) / rho, y += zeta w, d = (v_k - theta d) / rho
//      (with the lambda terms and q), x += zeta d;
//   3. the update: the scalar step (the rotations, ||A^H r||, the tests)
//      in thread 0 of every block; w_bar = (u_{k+1} - beta_hat w_bar) /
//      alpha_hat row by row.
// Per iteration this design moves (28 + 8) + (28 + 4 + 40) + 24 B per row
// in f32 (+ 8 with lambda): 132 B.
#include "gk.cuh"

namespace {

using namespace gk;

constexpr int SOLVED_MN = 40;
constexpr int USE_LAM = 1;

// slots of the scalar and int arrays after the shared ones
enum ScalarSlot {
  ZETABAR = ALPHA + 1, RHOBAR, THETA, CP, SP, LAMK, RNORM, ARNORM, EPS_C,
  EPS_I, NSC_STATE, NSC = 2 * NSC_STATE - ALPHA
};
enum IntSlot { NST_STATE = ZR + 1, NST = 2 * NST_STATE - STATUS };
// the method's own rows of the vector workspace
enum OwnRow { Y = NSHARED_ROWS, W, WBAR, D, Q, NROWS };

struct Craigmr : Hooks {
  static constexpr int kRows = NROWS - NSHARED_ROWS;
  static constexpr int kNscState = NSC_STATE;
  static constexpr int kNstState = NST_STATE;
  // no error window: the ring's one slot takes ||r||, which nothing reads
  static constexpr int kErrNew = RNORM;
  static constexpr bool kAhuRows = true;

  __device__ static int ring_slot(int, int) { return 0; }

  template <typename T>
  struct Coef {
    T betahat, alphahat;
    bool anz;
  };

  template <typename T>
  struct Pre {
    T zeta, rho, tc, dc, qc, cp, sp, sd;
    bool lam, first;
  };

  // cp, sp and alpha_hat of the rotation of (alpha_1, lambda), or 1, 1 and
  // alpha_1 without lambda (pallas_fused.py:6185-6193)
  template <typename T>
  __device__ static void first_rotation(T alpha, T lam, bool lam_on, T& cp,
                                        T& sp, T& alphahat) {
    cp = T(1);
    sp = T(1);
    alphahat = alpha;
    if (lam_on) sym_givens(alpha, lam, cp, sp, alphahat);
  }

  // y = w = d = 0, w_bar = u_1 / alpha_hat, q = sp v_1 (lambda) or 0
  template <typename T>
  __device__ static T init_row(T* work, const T* sc, long long n,
                               long long i, T v1, T alpha, int flag) {
    T cp, sp, alphahat;
    first_rotation(alpha, sc[LAM], flag & USE_LAM, cp, sp, alphahat);
    row(work, Y, n)[i] = T(0);
    row(work, W, n)[i] = T(0);
    row(work, D, n)[i] = T(0);
    row(work, Q, n)[i] = (flag & USE_LAM) ? sp * v1 : T(0);
    row(work, WBAR, n)[i] = row(work, U, n)[i] / safe(alphahat);
    return T(0);
  }

  // the first state (pallas_fused.py:6172-6197)
  template <typename T>
  __device__ static void init_scalars(T* sc, int* st, T alpha, T beta1, T,
                                      int flag) {
    T cp, sp, alphahat;
    first_rotation(alpha, sc[LAM], flag & USE_LAM, cp, sp, alphahat);
    sc[ALPHA] = alpha;
    sc[ZETABAR] = beta1;
    sc[RHOBAR] = alphahat;
    sc[CP] = cp;
    sc[SP] = sp;
    sc[LAMK] = sc[LAM];
    sc[RNORM] = beta1;
    sc[ARNORM] = alpha;
    sc[EPS_C] = sc[ATOL] + sc[RTOL] * beta1;
    sc[EPS_I] = sc[ATOL] + sc[RTOL] * alpha;
    st[STATUS] = beta1 == T(0)   ? ZERO_RESIDUAL
                 : alpha == T(0) ? MIN_LSQ_X
                                 : RUNNING;
  }

  // beta_hat and the rotation of (rho_bar, beta_hat) (pallas_fused.py:
  // 6218-6227)
  template <typename T>
  __device__ static void qr_rotation(const T* sc, T beta, bool lam_on,
                                     T& betahat, T& c, T& sg, T& rho) {
    betahat = lam_on ? sc[CP] * beta : beta;
    sym_givens(sc[RHOBAR], betahat, c, sg, rho);
  }

  template <typename T>
  __device__ static Pre<T> ahu_coef(const T* sc, const int* st, T beta,
                                    int flag) {
    Pre<T> p{};
    p.lam = flag & USE_LAM;
    p.first = st[IT] == 0;
    T betahat, c, sg, rho;
    qr_rotation(sc, beta, p.lam, betahat, c, sg, rho);
    p.zeta = c * sc[ZETABAR];
    p.rho = safe(rho);
    p.tc = sc[THETA] / p.rho;
    p.dc = sc[CP] / p.rho;
    p.qc = sc[SP] / p.rho;
    p.cp = sc[CP];
    p.sp = sc[SP];
    if (p.lam) {
      T cd, lam_next;
      sym_givens(sc[LAMK], sc[SP] * beta, cd, p.sd, lam_next);
    }
    return p;
  }

  // w, y, d, q and x from v_k (pallas_fused.py:6229-6249)
  template <typename T>
  __device__ static void ahu_row(T* work, const Pre<T>& p, long long n,
                                 long long i, T v, T) {
    T* w = row(work, W, n);
    T* y = row(work, Y, n);
    T* d = row(work, D, n);
    T* x = row(work, X, n);
    const T wn = row(work, WBAR, n)[i] / p.rho - p.tc * w[i];
    w[i] = wn;
    y[i] = y[i] + p.zeta * wn;
    T dn;
    if (p.lam) {
      T* q = row(work, Q, n);
      const T qi = q[i];
      dn = p.first ? p.dc * v : p.dc * v - p.tc * d[i] + p.qc * qi;
      q[i] = p.sd * (p.first ? qi : p.sp * v - p.cp * qi);
    } else {
      dn = v / p.rho - p.tc * d[i];
    }
    d[i] = dn;
    x[i] = x[i] + p.zeta * dn;
  }

  // One iteration's scalars, as the TPU kernel (pallas_fused.py:
  // 6218-6283).
  template <typename T>
  __device__ static Coef<T> step(const T* sc, const int* st, T alpha_n,
                                 T beta_n, T, int, int flag, int, T* nsc,
                                 int* nst) {
    const bool lam_on = flag & USE_LAM;
    T betahat, c, sg, rho;
    qr_rotation(sc, beta_n, lam_on, betahat, c, sg, rho);
    const T zeta = c * sc[ZETABAR];
    const T zetabar = sg * sc[ZETABAR];
    const T rnorm = fabs(zetabar);
    const T arnorm = alpha_n * beta_n * fabs(zeta / safe(rho));
    T cp = sc[CP], sp = sc[SP], lam_next = sc[LAMK], alphahat = alpha_n;
    if (lam_on) {
      T cd, sd;
      sym_givens(sc[LAMK], sc[SP] * beta_n, cd, sd, lam_next);
      sym_givens(alpha_n, lam_next, cp, sp, alphahat);
    }
    if (nsc != nullptr) {
      stage_state<T, Craigmr>(sc, st, nsc, nst);
      nsc[ALPHA] = alpha_n;
      nsc[ZETABAR] = zetabar;
      nsc[RHOBAR] = -c * alphahat;
      nsc[THETA] = sg * alphahat;
      nsc[CP] = cp;
      nsc[SP] = sp;
      nsc[LAMK] = lam_next;
      nsc[RNORM] = rnorm;
      nsc[ARNORM] = arnorm;
      const bool solved = rnorm <= sc[EPS_C];
      const bool inconsistent =
          rnorm > T(100) * sc[EPS_C] && arnorm <= sc[EPS_I];
      int code = RUNNING;
      if (inconsistent) code = SOLVED_LSQ;
      if (solved) code = SOLVED_MN;
      nst[STATUS] = code;
    }
    return Coef<T>{betahat, safe(alphahat), alpha_n != T(0)};
  }

  // w_bar = (u_{k+1} - beta_hat w_bar) / alpha_hat where alpha_{k+1} != 0
  // (pallas_fused.py:6265-6267)
  template <typename T>
  __device__ static T update_row(T* work, const Coef<T>& k, long long n,
                                 long long i, T) {
    if (k.anz) {
      T* wbar = row(work, WBAR, n);
      wbar[i] = (row(work, U, n)[i] - k.betahat * wbar[i]) / k.alphahat;
    }
    return T(0);
  }

  template <typename T>
  __device__ static void commit(T*, int*, const T*, int, int, int) {}
};

}  // namespace

KTT_GK_INIT(ktt_craigmr_dia_init_f32_f32, float, float, Craigmr)
KTT_GK_INIT(ktt_craigmr_dia_init_f32_bf16, float, __nv_bfloat16, Craigmr)
KTT_GK_INIT(ktt_craigmr_dia_init_f32_f16, float, __half, Craigmr)
KTT_GK_INIT(ktt_craigmr_dia_init_f64_f64, double, double, Craigmr)
KTT_GK_ITERATE(ktt_craigmr_dia_iterate_f32_f32, float, float, Craigmr)
KTT_GK_ITERATE(ktt_craigmr_dia_iterate_f32_bf16, float, __nv_bfloat16,
               Craigmr)
KTT_GK_ITERATE(ktt_craigmr_dia_iterate_f32_f16, float, __half, Craigmr)
KTT_GK_ITERATE(ktt_craigmr_dia_iterate_f64_f64, double, double, Craigmr)
