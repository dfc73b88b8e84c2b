// Whole CRAIG solve of min ||x|| subject to A x = b (+ lambda) for a DIA
// matrix on Hopper (sm_90a), with no grid-wide barrier.
//
// Replaces the TPU kernel krylov_tpu/ops/pallas_fused.py:5922
// craig_dia_fused and computes what it computes (pallas_fused.py:
// 5955-6077): Golub-Kahan from A^H u_1, the lambda two-rotation scheme
// (flag bit 1), the backward-error, residual and conlim stops and the
// "system may be inconsistent" exit at alpha = 0, which counts no
// iteration and changes nothing but the status.  Outputs: x, y, niter,
// rnorm and the status code.
//
// Bound on an H100 SXM: memory bandwidth.  An iteration applies A and
// A^H once each (2 x 28 B per row in f32 for the 7-point stencil) and
// must read and write u, v, x, w and y: (56 + 40) B per row, 96 B.
//
// Design: the launches of gk.cuh, half an iteration out of phase with the
// TPU kernel.  Its iteration k is v_k from A^H u_k, the updates, then
// u_{k+1} from A v_k and the tests on beta_{k+1}; here the init takes
// A^H u_1 (gk.cuh's init), and iteration k of gk.cuh (A v_k, then
// A^H u_{k+1}) carries the rest of the TPU kernel's iteration k and the
// first half of its iteration k + 1, whose alpha_{k+1} the next
// iteration reads.  So
//   1. A v_k: before u_k goes under u_hat at a row, w_{k+1} = u_k -
//      (theta / rho_prev) w, y += (xi / rho) w_{k+1} and x += xi c1 v_k
//      (+ xi s1 w2), with the partials of ||w_{k+1}||^2 for the norm
//      that dnorm2 adds (a norm, not its square, as the TPU kernel);
//   2. A^H u_{k+1}: w2 = s2 (s1 v_k - c1 w2) before v_k goes under v_hat
//      (lambda only: s2 needs beta_{k+1});
//   3. the scalar step, the tests on beta_{k+1} and ||w_{k+1}||, and the
//      normalisation of u_{k+1} and v_{k+1};
// and where alpha_k = 0 launches 1-3 skip and the commit sets the
// inconsistency status.  Per iteration this design moves (28 + 4 + 24) +
// (28 + 8) + 16 B per row in f32 (+ 12 with lambda): 108 B, and one A^H
// stencil after the stop that the TPU kernel does not take.
#include "gk.cuh"

namespace {

using namespace gk;

constexpr int SOLVED_CRAIG = 39;
constexpr int INCONS_CRAIG = 41;
constexpr int USE_LAM = 1;

// slots of the scalar and int arrays after the shared ones
enum ScalarSlot {
  BETA = ALPHA + 1, THETA, XI, DELTA, RHO_PREV, ANORM2, DNORM2, XNORM2,
  RNORM, BETA1, EPS_C, NSC_STATE, NSC = 2 * NSC_STATE - ALPHA
};
enum IntSlot { NST_STATE = ZR + 1, NST = 2 * NST_STATE - STATUS };
// the method's own rows of the vector workspace
enum OwnRow { Y = NSHARED_ROWS, W, W2, NROWS };

struct Craig : Hooks {
  static constexpr int kRows = NROWS - NSHARED_ROWS;
  static constexpr int kNscState = NSC_STATE;
  static constexpr int kNstState = NST_STATE;
  // no error window: the ring's one slot takes ||r||, which nothing reads
  static constexpr int kErrNew = RNORM;
  static constexpr bool kAvRows = true;
  static constexpr bool kAhuRows = true;

  __device__ static int ring_slot(int, int) { return 0; }

  template <typename T>
  struct Coef {};

  template <typename T>
  struct Pre {
    T wc, yc, xa, xb, c1, s1, s2;
    bool lam;
  };

  // The rotation against delta (lambda only) and xi, from the state
  // (pallas_fused.py:5996-6003).
  template <typename T>
  __device__ static void rotation(const T* sc, bool lam, T& c1, T& s1,
                                  T& rho, T& xi) {
    c1 = T(1);
    s1 = T(0);
    rho = sc[ALPHA];
    if (lam) sym_givens(sc[ALPHA], sc[DELTA], c1, s1, rho);
    xi = -sc[THETA] / safe(rho) * sc[XI];
  }

  // alpha = 0 is the inconsistency exit (pallas_fused.py:5992, 6056-6062)
  template <typename T>
  __device__ static bool runs(const T* sc) { return sc[ALPHA] != T(0); }
  __device__ static void skip(int* st) { st[STATUS] = INCONS_CRAIG; }

  // y = w = w2 = 0 (x is zeroed by gk.cuh)
  template <typename T>
  __device__ static T init_row(T* work, const T*, long long n, long long i,
                               T, T, int) {
    row(work, Y, n)[i] = T(0);
    row(work, W, n)[i] = T(0);
    row(work, W2, n)[i] = T(0);
    return T(0);
  }

  // the first state (pallas_fused.py:5957-5978), alpha_1 from gk.cuh's
  // A^H u_1
  template <typename T>
  __device__ static void init_scalars(T* sc, int* st, T alpha, T beta1, T,
                                      int) {
    sc[ALPHA] = alpha;
    sc[BETA] = beta1;
    sc[THETA] = beta1;
    sc[XI] = T(-1);
    sc[DELTA] = sc[LAM];
    sc[RHO_PREV] = T(1);
    sc[RNORM] = beta1;
    sc[BETA1] = beta1;
    sc[EPS_C] = sc[ATOL] + sc[RTOL] * beta1;
    st[STATUS] = beta1 == T(0) ? ZERO_RESIDUAL : RUNNING;
  }

  template <typename T>
  __device__ static Pre<T> av_coef(const T* sc, const int*, int flag) {
    Pre<T> p{};
    p.lam = flag & USE_LAM;
    T rho, xi;
    rotation(sc, p.lam, p.c1, p.s1, rho, xi);
    p.wc = sc[THETA] / sc[RHO_PREV];
    p.yc = xi / rho;
    p.xa = xi * p.c1;
    p.xb = xi * p.s1;
    return p;
  }

  // w = u_k - (theta / rho_prev) w, y += (xi / rho) w, x += xi c1 v_k
  // (+ xi s1 w2); the partials of ||w||^2 (pallas_fused.py:6005-6016)
  template <typename T>
  __device__ static T av_row(T* work, const Pre<T>& p, long long n,
                             long long i, T u) {
    T* x = row(work, X, n);
    T* y = row(work, Y, n);
    T* w = row(work, W, n);
    const T vi = row(work, V, n)[i];
    const T wn = u - p.wc * w[i];
    w[i] = wn;
    y[i] = y[i] + p.yc * wn;
    x[i] = p.lam ? x[i] + p.xa * vi + p.xb * row(work, W2, n)[i]
                 : x[i] + p.xa * vi;
    return wn * wn;
  }

  // s2 of the rotation of (lambda, beta_{k+1} s1) (pallas_fused.py:
  // 6024-6027)
  template <typename T>
  __device__ static Pre<T> ahu_coef(const T* sc, const int*, T beta,
                                    int flag) {
    Pre<T> p{};
    p.lam = flag & USE_LAM;
    if (p.lam) {
      T rho, xi, c2, delta;
      rotation(sc, true, p.c1, p.s1, rho, xi);
      sym_givens(sc[LAM], beta * p.s1, c2, p.s2, delta);
    }
    return p;
  }

  // w2 = s2 (s1 v_k - c1 w2)
  template <typename T>
  __device__ static void ahu_row(T* work, const Pre<T>& p, long long n,
                                 long long i, T v, T) {
    if (p.lam) {
      T* w2 = row(work, W2, n);
      w2[i] = p.s2 * (p.s1 * v - p.c1 * w2[i]);
    }
  }

  // The rest of the TPU kernel's iteration k on beta_{k+1} and
  // ww = ||w_{k+1}||^2 (pallas_fused.py:5996-6054); alpha_n is
  // alpha_{k+1}, the next iteration's.
  template <typename T>
  __device__ static Coef<T> step(const T* sc, const int* st, T alpha_n,
                                 T beta_n, T ww, int, int flag, int,
                                 T* nsc, int* nst) {
    const T tiny = tiny_of<T>();
    const bool lam_on = flag & USE_LAM;
    const T lam = sc[LAM];
    const T alpha = sc[ALPHA];
    T c1, s1, rho, xi;
    rotation(sc, lam_on, c1, s1, rho, xi);
    T anorm2 = sc[ANORM2] + alpha * alpha + lam * lam;
    const T dnorm2 = sc[DNORM2] + sqrt(ww);
    T theta = beta_n;
    T delta = sc[DELTA];
    if (lam_on) {
      theta = beta_n * c1;
      T c2, s2;
      sym_givens(lam, beta_n * s1, c2, s2, delta);
    }
    anorm2 = anorm2 + beta_n * beta_n;
    const T anorm = sqrt(anorm2);
    const T acond = anorm * sqrt(dnorm2);
    const T xnorm2 = sc[XNORM2] + xi * xi;
    const T xnorm = sqrt(xnorm2);
    T rnorm = beta_n * fabs(xi);
    if (lam_on) rnorm = rnorm * fabs(c1);
    const T beta1 = sc[BETA1];
    const T bt = sc[BTOL];
    const T bkwerr = rnorm / sqrt(beta1 * beta1 + anorm2 * xnorm2 + tiny);
    const bool solved = T(1) + bkwerr <= T(1) || bkwerr <= bt ||
                        rnorm <= sc[EPS_C] ||
                        rnorm <= bt + sc[ATOL] * anorm * xnorm / safe(beta1);
    const bool ill_cond_mach = T(1) + T(1) / fmax(acond, tiny) <= T(1);
    const bool ill_cond_lim = T(1) / fmax(acond, tiny) <= ctol_of(sc);
    if (nsc != nullptr) {
      stage_state<T, Craig>(sc, st, nsc, nst);
      nsc[ALPHA] = alpha_n;
      nsc[BETA] = beta_n;
      nsc[THETA] = theta;
      nsc[XI] = xi;
      nsc[DELTA] = delta;
      nsc[RHO_PREV] = rho;
      nsc[ANORM2] = anorm2;
      nsc[DNORM2] = dnorm2;
      nsc[XNORM2] = xnorm2;
      nsc[RNORM] = rnorm;
      int code = RUNNING;
      if (solved) code = SOLVED_CRAIG;
      if (ill_cond_mach) code = ILL_COND_MACH;
      if (ill_cond_lim) code = COND_EXCEEDED;
      nst[STATUS] = code;
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
};

}  // namespace

KTT_GK_INIT(ktt_craig_dia_init_f32_f32, float, float, Craig)
KTT_GK_INIT(ktt_craig_dia_init_f32_bf16, float, __nv_bfloat16, Craig)
KTT_GK_INIT(ktt_craig_dia_init_f32_f16, float, __half, Craig)
KTT_GK_INIT(ktt_craig_dia_init_f64_f64, double, double, Craig)
KTT_GK_ITERATE(ktt_craig_dia_iterate_f32_f32, float, float, Craig)
KTT_GK_ITERATE(ktt_craig_dia_iterate_f32_bf16, float, __nv_bfloat16, Craig)
KTT_GK_ITERATE(ktt_craig_dia_iterate_f32_f16, float, __half, Craig)
KTT_GK_ITERATE(ktt_craig_dia_iterate_f64_f64, double, double, Craig)
