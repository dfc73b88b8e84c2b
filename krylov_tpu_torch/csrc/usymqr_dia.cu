// Whole USYMQR solve of min ||b - A x|| for a DIA matrix, c starting the
// second SSY basis, on Hopper (sm_90a), with no grid-wide barrier.
//
// Replaces the TPU kernel krylov_tpu/ops/pallas_fused.py:6756
// usymqr_dia_fused and computes what it computes (pallas_fused.py:
// 6776-6882): the Saunders-Simon-Yip process, the QR factorisation of
// T_{k+1,k} by symmetric Givens reflections, the direction recurrence
// w_k = (u_k - lambda_{k-1} w_{k-1} - eps_{k-2} w_{k-2}) / d_k and the
// ||A^H r|| inconsistency test.  Outputs: x, niter, rnorm, arnorm, the
// status code (0 running / 1 solved / 2 zero residual / 8 inconsistent)
// and the inconsistent flag.
//
// Bound on an H100 SXM: memory bandwidth.  An iteration applies A and
// A^H once each (2 x 28 B per row in f32 for the 7-point stencil) and
// must read v_k, u_k, v_{k-1}, u_{k-1}, x, w_{k-1} and w_{k-2} and write
// v_{k+1}, u_{k+1}, x and w_k: (56 + 44) B per row, 100 B.
//
// Design: the launches of ssy.cuh.  The direction and x updates need
// this iteration's alpha and beta_{k+1} (lambda_{k-1} and d_k), so each
// runs one iteration late, in the next stencil's pass, which reads u_k
// as its p's subtracted term:
//   1. the stencil: q, p, the partials of <v_k, q>; the last iteration's
//      w_{k-1} = (u_{k-1} - lambda w_{k-2} - eps w_{k-3}) / d into the
//      buffer of w_{k-3} and x += zeta w_{k-1}, their coefficients staged
//      in the state (Usymqr::pre in thread 0 of every block,
//      Usymqr::early_rows on each thread's R rows)
//   2. alpha
//   3. the update: the QR step from the last two reflections and this
//      iteration's alpha and beta_{k+1} in thread 0 of every block
//      (Usymqr::step), which stages zeta_k, lambda_{k-1}, eps_{k-2} and
//      d_k; no row update but v_{k+1} and u_{k+1}, 16 bytes of each a
//      thread
//   4. the commit
// and one finishing launch after the loop, the last iteration's w_k and
// x += zeta_k w_k wherever the loop stopped (none where no iteration
// ran).  Each row's products and sums are those of the one-row update,
// in the same order.  Per iteration this design moves (80 + 20) + 24 +
// 16 B per row in f32: 140 B.
#include "ssy.cuh"

namespace {

using namespace ssy;

enum ScalarSlot {
  EPS_LIM = GAMMA + 1, C_KM2, S_KM2, C_KM1, S_KM1, ZETABAR, KAPPA, RNORM,
  ARNORM, W_ZETA, W_LAM, W_EPS, W_D, NSC_STATE, NSC = 2 * NSC_STATE - BETA
};
enum IntSlot { INCON = GO + 1, NST_STATE, NST = 2 * NST_STATE - STATUS };
enum OwnRow { X = NSHARED_ROWS, W0, W1, NROWS };

// In the 0-based iteration jt, w_{k-1} sits in buffer W0 + (jt + 1) mod 2
// and w_{k-2} in W0 + jt mod 2, where w_k goes.
__device__ __forceinline__ int wkm1_row(int jt) { return W0 + (jt + 1) % 2; }
__device__ __forceinline__ int wkm2_row(int jt) { return W0 + jt % 2; }

struct Usymqr {
  static constexpr int kRows = NROWS - NSHARED_ROWS;
  static constexpr bool kKeep = true;
  static constexpr int kNscState = NSC_STATE;
  static constexpr int kNstState = NST_STATE;
  static int b_row(int) { return -1; }

  static constexpr bool kSplit = true;

  // The last iteration's direction and x update, staged by its step:
  // zeta_k, lambda_{k-1}, eps_{k-2} and d_k (1 where it is 0); none
  // before the second iteration.
  template <typename T>
  struct Pre {
    T zeta, lam, eps, d;
    int run;
  };

  template <typename T>
  __device__ static Pre<T> pre(const T* sc, const int*, int it, int) {
    return Pre<T>{sc[W_ZETA], sc[W_LAM], sc[W_EPS], sc[W_D],
                  it >= 2 ? 1 : 0};
  }

  // The update's rows take no coefficient.
  template <typename T>
  struct Coef {};

  // ||b||, eps, zeta_bar = ||b|| and the status (pallas_fused.py:
  // 6805-6818); the reflections start at (0, 0)
  template <typename T>
  __device__ static void init_scalars(T bnorm, T, T* sc, int* st, int) {
    const T eps_lim = sc[ATOL] + sc[RTOL] * bnorm;
    sc[EPS_LIM] = eps_lim;
    sc[ZETABAR] = bnorm;
    sc[RNORM] = bnorm;
    st[STATUS] = bnorm == T(0) ? ZERO_RESIDUAL
                 : bnorm <= eps_lim ? SOLVED : RUNNING;
  }

  // One iteration's scalars, branch for branch as the TPU kernel
  // (pallas_fused.py:6840-6877).
  template <typename T>
  __device__ static Coef<T> step(const T* sc, const int* st, T alpha,
                                 T beta1, T gamma1, int it, int, T* nsc,
                                 int* nst) {
    const bool is1 = it == 1;
    const bool is2 = it == 2;
    const bool ge2 = it >= 2;
    const bool ge3 = it >= 3;
    const T gamma = sc[GAMMA];
    const T c_km2 = sc[C_KM2];
    const T s_km2 = sc[S_KM2];
    const T c_km1 = sc[C_KM1];
    const T s_km1 = sc[S_KM1];
    const T zetabar = sc[ZETABAR];
    const T eps_km2 = ge3 ? s_km2 * gamma : T(0);
    const T lbar_km1 = ge3 ? -c_km2 * gamma : (is2 ? gamma : T(0));
    const T lam_km1 = ge2 ? c_km1 * lbar_km1 + s_km1 * alpha : T(0);
    const T dbar_k = ge2 ? s_km1 * lbar_km1 - c_km1 * alpha : alpha;
    T ck, sk, d_k;
    sym_givens(dbar_k, beta1, ck, sk, d_k);
    const T zeta_k = ck * zetabar;
    const T zetabar_next = sk * zetabar;
    const T rnorm = fabs(zetabar_next);
    const T cg = c_km1 * gamma1;
    const T arnorm = static_cast<T>(fabs(zetabar))
                     * sqrt(dbar_k * dbar_k + cg * cg);
    const T kappa = is1 ? sc[ATOL] + sc[RTOL] * arnorm : sc[KAPPA];
    const bool solved = rnorm <= sc[EPS_LIM];
    const bool incon = !solved && arnorm <= kappa;
    if (nsc != nullptr) {
      stage_state<T, Usymqr>(sc, st, nsc, nst);
      nsc[BETA] = beta1;
      nsc[GAMMA] = gamma1;
      nsc[C_KM2] = c_km1;
      nsc[S_KM2] = s_km1;
      nsc[C_KM1] = ck;
      nsc[S_KM1] = sk;
      nsc[ZETABAR] = zetabar_next;
      nsc[KAPPA] = kappa;
      nsc[RNORM] = rnorm;
      nsc[ARNORM] = arnorm;
      nsc[W_ZETA] = zeta_k;
      nsc[W_LAM] = lam_km1;
      nsc[W_EPS] = eps_km2;
      nsc[W_D] = safe(d_k);
      nst[STATUS] = solved ? SOLVED : incon ? INCONSISTENT : RUNNING;
      nst[INCON] = incon ? 1 : 0;
    }
    return Coef<T>{};
  }

  // The update of the 0-based iteration it0 - 1 on rows i0 .. i0 + R - 1
  // (left of them below n): its w_k into the buffer of its w_{k-2} and
  // x += zeta_k w_k (pallas_fused.py:6855-6859), from its u_k, which is
  // u_{k-1} of iteration it0.
  template <int R, bool VEC, typename T>
  __device__ static void early_rows(T* work, const Pre<T>& k, int it0,
                                    long long n, long long i0,
                                    long long left) {
    if (!k.run) return;
    const int jt = it0 - 1;
    T* x = row(work, X, n) + i0;
    T* wkm2 = row(work, wkm2_row(jt), n) + i0;
    T xv[R];
    T uv[R];
    T w1[R];
    T w2[R];
    load_rows<VEC>(x, left, xv);
    load_rows<VEC>(row(work, U0 + cur(jt), n) + i0, left, uv);
    load_rows<VEC>(row(work, wkm1_row(jt), n) + i0, left, w1);
    load_rows<VEC>(wkm2, left, w2);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const T w = (uv[r] - k.lam * w1[r] - k.eps * w2[r]) / k.d;
      xv[r] = xv[r] + k.zeta * w;
      w2[r] = w;
    }
    store_rows<VEC>(x, left, xv);
    store_rows<VEC>(wkm2, left, w2);
  }

  // No row waits for alpha or the norms.
  template <int NR, bool VEC, typename T>
  __device__ static void late_rows(T*, const Coef<T>&, int, long long,
                                   long long, long long) {}

  // After the loop: the last iteration's update, which no stencil ran.
  template <typename T>
  __device__ static bool finishes(const T*, const int* st) {
    return st[IT] >= 1;
  }
  template <typename T>
  __device__ static void finish_row(T* work, const T* sc, const int* st,
                                    long long n, long long i) {
    const int it0 = st[IT];
    early_rows<1, false>(work, pre<T>(sc, st, it0 + 1, 0), it0, n, i, n - i);
  }
};

}  // namespace

KTT_SSY_INIT(ktt_usymqr_dia_init_f32, float, Usymqr)
KTT_SSY_INIT(ktt_usymqr_dia_init_f64, double, Usymqr)
KTT_SSY_ITERATE(ktt_usymqr_dia_iterate_f32_f32, float, float, Usymqr)
KTT_SSY_ITERATE(ktt_usymqr_dia_iterate_f32_bf16, float, __nv_bfloat16, Usymqr)
KTT_SSY_ITERATE(ktt_usymqr_dia_iterate_f32_f16, float, __half, Usymqr)
KTT_SSY_ITERATE(ktt_usymqr_dia_iterate_f64_f64, double, double, Usymqr)
KTT_SSY_FINISH(ktt_usymqr_dia_finish_f32, float, Usymqr)
KTT_SSY_FINISH(ktt_usymqr_dia_finish_f64, double, Usymqr)
