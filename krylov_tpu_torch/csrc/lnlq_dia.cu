// Whole LNLQ solve of min ||x|| subject to A x = b (+ lambda) for a DIA
// matrix on Hopper (sm_90a), with no grid-wide barrier.
//
// Replaces the TPU kernel krylov_tpu/ops/pallas_fused.py:6345
// lnlq_dia_fused and computes what it computes (pallas_fused.py:
// 6379-6511): Golub-Kahan over A and A^H, the LQ recurrences, the lambda
// registers (flag bit 1) with their second-iteration guard, the LQ and
// CG-point stops and, with transfer_to_craig (flag bit 2), the move of x
// and y to the CRAIG point after the loop where the stop was the CG
// branch and zeta_bar > eps (signed).  Outputs: x, y, niter, rnorm and
// the status code.
//
// Bound on an H100 SXM: memory bandwidth.  An iteration applies A and
// A^H once each (2 x 28 B per row in f32 for the 7-point stencil) and
// must read and write u, v, x, y and w_bar: (56 + 40) B per row, 96 B.
//
// Design: the launches of gk.cuh, with
//   2. A^H u_{k+1}: before v_k goes under v_hat at a row, the LQ rotation
//      of (eps_bar, beta_hat) from beta_{k+1} in every block, then
//      x += tau v_k (with the lambda terms and q), y += zeta c w_bar +
//      zeta s u_{k+1} and w_bar = s w_bar - c u_{k+1};
//   3. the update: the scalar step (the recurrences, the estimates of
//      ||r||, the tests) in thread 0 of every block;
// and one finishing launch after the loop for the transfer.  Per
// iteration this design moves (28 + 8) + (28 + 4 + 32) + 16 B per row in
// f32 (+ 8 with lambda): 116 B.
#include "gk.cuh"

namespace {

using namespace gk;

constexpr int SOLVED_LNLQ_LQ = 42;
constexpr int SOLVED_LNLQ_CG = 43;
constexpr int USE_LAM = 1;
constexpr int TRANSFER = 2;

// slots of the scalar and int arrays after the shared ones
enum ScalarSlot {
  ALPHAHAT = ALPHA + 1, SK, ZETA_KM1, ZETABAR, THETA, EPSBAR, TAU, CP, SP,
  RNORM, EPS_LIM, NSC_STATE, NSC = 2 * NSC_STATE - ALPHA
};
enum IntSlot { CGFLAG = ZR + 1, NST_STATE, NST = 2 * NST_STATE - STATUS };
// the method's own rows of the vector workspace
enum OwnRow { Y = NSHARED_ROWS, WBAR, Q, NROWS };

struct Lnlq : Hooks {
  static constexpr int kRows = NROWS - NSHARED_ROWS;
  static constexpr int kNscState = NSC_STATE;
  static constexpr int kNstState = NST_STATE;
  // no error window: the ring's one slot takes ||r||, which nothing reads
  static constexpr int kErrNew = RNORM;
  static constexpr bool kAhuRows = true;

  __device__ static int ring_slot(int, int) { return 0; }

  template <typename T>
  struct Coef {};

  template <typename T>
  struct Pre {
    T xa, xb, cp, sp, sd, ya, yb, c, s;
    bool lam, second;
  };

  // cp, sp and alpha_hat of the rotation of (alpha_1, lambda), or 1, 1 and
  // alpha_1 without lambda (pallas_fused.py:6399-6407)
  template <typename T>
  __device__ static void first_rotation(T alpha, T lam, bool lam_on, T& cp,
                                        T& sp, T& alphahat) {
    cp = T(1);
    sp = T(1);
    alphahat = alpha;
    if (lam_on) sym_givens(alpha, lam, cp, sp, alphahat);
  }

  // beta_hat, the rotation of (eps_bar, beta_hat) and zeta_k
  // (pallas_fused.py:6449-6466)
  template <typename T>
  __device__ static void lq_rotation(const T* sc, T beta, bool lam_on,
                                     T& betahat, T& c, T& s, T& eps,
                                     T& zeta) {
    betahat = lam_on ? sc[CP] * beta : beta;
    sym_givens(sc[EPSBAR], betahat, c, s, eps);
    zeta = sc[THETA] / safe(eps);
  }

  // y = 0, w_bar = u_1, q = sp v_1 (lambda) or 0
  template <typename T>
  __device__ static T init_row(T* work, const T* sc, long long n,
                               long long i, T v1, T alpha, int flag) {
    T cp, sp, alphahat;
    first_rotation(alpha, sc[LAM], flag & USE_LAM, cp, sp, alphahat);
    row(work, Y, n)[i] = T(0);
    row(work, WBAR, n)[i] = row(work, U, n)[i];
    row(work, Q, n)[i] = (flag & USE_LAM) ? sp * v1 : T(0);
    return T(0);
  }

  // the first state (pallas_fused.py:6386-6422)
  template <typename T>
  __device__ static void init_scalars(T* sc, int* st, T alpha, T beta1, T,
                                      int flag) {
    T cp, sp, alphahat;
    first_rotation(alpha, sc[LAM], flag & USE_LAM, cp, sp, alphahat);
    const T tau = beta1 / safe(alphahat);
    sc[ALPHA] = alpha;
    sc[ALPHAHAT] = alphahat;
    sc[ZETABAR] = tau / safe(alphahat);
    sc[THETA] = tau;
    sc[EPSBAR] = alphahat;
    sc[TAU] = tau;
    sc[CP] = cp;
    sc[SP] = sp;
    sc[RNORM] = beta1;
    sc[EPS_LIM] = sc[ATOL] + sc[RTOL] * beta1;
    st[STATUS] = beta1 == T(0) ? ZERO_RESIDUAL : RUNNING;
  }

  template <typename T>
  __device__ static Pre<T> ahu_coef(const T* sc, const int* st, T beta,
                                    int flag) {
    Pre<T> p{};
    p.lam = flag & USE_LAM;
    p.second = st[IT] >= 1;
    p.cp = sc[CP];
    p.sp = sc[SP];
    const T tau = sc[TAU];
    if (p.lam) {
      T cd, lam_next;
      sym_givens(sc[LAM], sc[SP] * beta, cd, p.sd, lam_next);
      p.xa = tau * p.cp;
      p.xb = p.second ? tau * p.sp : T(0);
    } else {
      p.xa = tau;
    }
    T betahat, eps, zeta;
    lq_rotation(sc, beta, p.lam, betahat, p.c, p.s, eps, zeta);
    p.ya = zeta * p.c;
    p.yb = zeta * p.s;
    return p;
  }

  // x and q from v_k (pallas_fused.py:6438-6446, 6452), y and w_bar from
  // u_{k+1} (:6467-6469)
  template <typename T>
  __device__ static void ahu_row(T* work, const Pre<T>& p, long long n,
                                 long long i, T v, T u) {
    T* x = row(work, X, n);
    if (p.lam) {
      T* q = row(work, Q, n);
      const T qi = q[i];
      x[i] = x[i] + p.xa * v + p.xb * qi;
      q[i] = p.sd * (p.second ? p.sp * v - p.cp * qi : qi);
    } else {
      x[i] = x[i] + p.xa * v;
    }
    T* y = row(work, Y, n);
    T* wbar = row(work, WBAR, n);
    const T wb = wbar[i];
    y[i] = y[i] + p.ya * wb + p.yb * u;
    wbar[i] = p.s * wb - p.c * u;
  }

  // One iteration's scalars, as the TPU kernel (pallas_fused.py:
  // 6449-6490); alpha_n is alpha_{k+1}.
  template <typename T>
  __device__ static Coef<T> step(const T* sc, const int* st, T alpha_n,
                                 T beta_n, T, int it, int flag, int, T* nsc,
                                 int* nst) {
    const bool lam_on = flag & USE_LAM;
    T cp = sc[CP], sp = sc[SP], alphahat = alpha_n;
    if (lam_on) {
      T cd, sd, lam_next;
      sym_givens(sc[LAM], sc[SP] * beta_n, cd, sd, lam_next);
      sym_givens(alpha_n, lam_next, cp, sp, alphahat);
    }
    T betahat, c, s, eps, zeta;
    lq_rotation(sc, beta_n, lam_on, betahat, c, s, eps, zeta);
    if (nsc != nullptr) {
      const T tau = -betahat * sc[TAU] / safe(alphahat);
      const T eta = alphahat * s;
      const T epsbar = -alphahat * c;
      const T theta = tau - eta * zeta;
      const T rnorm_lq =
          it == 1 ? sc[RNORM]
                  : fabs(sc[ALPHAHAT]) *
                        sqrt(sq(sc[EPSBAR] * sc[ZETABAR]) +
                             sq(betahat * sc[SK] * sc[ZETA_KM1]));
      const T rnorm_cg = fabs(betahat * sc[TAU]);
      const bool solved_lq = rnorm_lq <= sc[EPS_LIM];
      const bool solved_cg = (flag & TRANSFER) &&
                             fabs(sc[ZETABAR]) > eps_of<T>() &&
                             rnorm_cg <= sc[EPS_LIM];
      stage_state<T, Lnlq>(sc, st, nsc, nst);
      nsc[ALPHA] = alpha_n;
      nsc[ALPHAHAT] = alphahat;
      nsc[SK] = s;
      nsc[ZETA_KM1] = zeta;
      nsc[ZETABAR] = theta / safe(epsbar);
      nsc[THETA] = theta;
      nsc[EPSBAR] = epsbar;
      nsc[TAU] = tau;
      nsc[CP] = cp;
      nsc[SP] = sp;
      nsc[RNORM] = rnorm_lq;
      int code = RUNNING;
      if (solved_lq) code = SOLVED_LNLQ_LQ;
      if (solved_cg && !solved_lq) code = SOLVED_LNLQ_CG;
      nst[STATUS] = code;
      nst[CGFLAG] = solved_cg && !solved_lq ? 1 : 0;
    }
    return Coef<T>{};
  }

  template <typename T>
  __device__ static T update_row(T*, const Coef<T>&, long long, long long,
                                 T) {
    return T(0);
  }

  template <typename T>
  __device__ static void commit(T*, int*, const T*, int, int, int) {}

  // After the loop: the CRAIG point where the stop was the CG branch and
  // zeta_bar > eps (pallas_fused.py:6495-6503).
  template <typename T>
  __device__ static bool finishes(const T* sc, const int* st, int) {
    return st[CGFLAG] == 1 && sc[ZETABAR] > eps_of<T>();
  }
  template <typename T>
  __device__ static void finish_row(T* work, const T* sc, long long n,
                                    long long i, int flag) {
    T* x = row(work, X, n);
    const T v = row(work, V, n)[i];
    x[i] = (flag & USE_LAM)
               ? x[i] + (sc[TAU] * sc[CP]) * v +
                     (sc[TAU] * sc[SP]) * row(work, Q, n)[i]
               : x[i] + sc[TAU] * v;
    T* y = row(work, Y, n);
    y[i] = y[i] + sc[ZETABAR] * row(work, WBAR, n)[i];
  }
};

}  // namespace

KTT_GK_INIT(ktt_lnlq_dia_init_f32_f32, float, float, Lnlq)
KTT_GK_INIT(ktt_lnlq_dia_init_f32_bf16, float, __nv_bfloat16, Lnlq)
KTT_GK_INIT(ktt_lnlq_dia_init_f32_f16, float, __half, Lnlq)
KTT_GK_INIT(ktt_lnlq_dia_init_f64_f64, double, double, Lnlq)
KTT_GK_ITERATE(ktt_lnlq_dia_iterate_f32_f32, float, float, Lnlq)
KTT_GK_ITERATE(ktt_lnlq_dia_iterate_f32_bf16, float, __nv_bfloat16, Lnlq)
KTT_GK_ITERATE(ktt_lnlq_dia_iterate_f32_f16, float, __half, Lnlq)
KTT_GK_ITERATE(ktt_lnlq_dia_iterate_f64_f64, double, double, Lnlq)
KTT_GK_FINISH(ktt_lnlq_dia_finish_f32, float, Lnlq)
KTT_GK_FINISH(ktt_lnlq_dia_finish_f64, double, Lnlq)
