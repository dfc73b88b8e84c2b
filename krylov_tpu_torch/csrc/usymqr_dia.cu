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
// Design: the launches of ssy.cuh, with
//   3. the update: the QR step from the last two reflections and this
//      iteration's alpha and beta_{k+1} in thread 0 of every block; w_k
//      into the buffer of w_{k-2} and x += zeta_k w_k row by row.
// Per iteration this design moves (56 + 24) + 24 + (40 + 16) B per row
// in f32: 160 B.
#include "ssy.cuh"

namespace {

using namespace ssy;

enum ScalarSlot {
  EPS_LIM = GAMMA + 1, C_KM2, S_KM2, C_KM1, S_KM1, ZETABAR, KAPPA, RNORM,
  ARNORM, NSC_STATE, NSC = 2 * NSC_STATE - BETA
};
enum IntSlot { INCON = GO + 1, NST_STATE, NST = 2 * NST_STATE - STATUS };
enum OwnRow { X = NSHARED_ROWS, W0, W1, NROWS };

// w_{k-1} sits in buffer W0 + (it + 1) mod 2 and w_{k-2} in W0 + it mod 2,
// where w_k goes (it the 0-based iteration count).
__device__ __forceinline__ int wkm1_row(int it0) { return W0 + (it0 + 1) % 2; }
__device__ __forceinline__ int wkm2_row(int it0) { return W0 + it0 % 2; }

struct Usymqr {
  static constexpr int kRows = NROWS - NSHARED_ROWS;
  static constexpr bool kKeep = true;
  static constexpr int kNscState = NSC_STATE;
  static constexpr int kNstState = NST_STATE;
  static int b_row(int) { return -1; }

  template <typename T>
  struct Coef {
    T zeta_k, lam_km1, eps_km2, d;
  };

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
      nst[STATUS] = solved ? SOLVED : incon ? INCONSISTENT : RUNNING;
      nst[INCON] = incon ? 1 : 0;
    }
    return Coef<T>{zeta_k, lam_km1, eps_km2, safe(d_k)};
  }

  // w_k into the buffer of w_{k-2}, x += zeta_k w_k (pallas_fused.py:
  // 6855-6859)
  template <typename T>
  __device__ static void update_row(T* work, const Coef<T>& k,
                                    const Vecs<T>& v, int it0, long long n,
                                    long long i) {
    T* x = row(work, X, n);
    T* wkm2 = row(work, wkm2_row(it0), n);
    const T w = (v.uk[i] - k.lam_km1 * row(work, wkm1_row(it0), n)[i]
                 - k.eps_km2 * wkm2[i]) / k.d;
    x[i] = x[i] + k.zeta_k * w;
    wkm2[i] = w;
  }
};

}  // namespace

KTT_SSY_INIT(ktt_usymqr_dia_init_f32, float, Usymqr)
KTT_SSY_INIT(ktt_usymqr_dia_init_f64, double, Usymqr)
KTT_SSY_ITERATE(ktt_usymqr_dia_iterate_f32_f32, float, float, Usymqr)
KTT_SSY_ITERATE(ktt_usymqr_dia_iterate_f32_bf16, float, __nv_bfloat16, Usymqr)
KTT_SSY_ITERATE(ktt_usymqr_dia_iterate_f32_f16, float, __half, Usymqr)
KTT_SSY_ITERATE(ktt_usymqr_dia_iterate_f64_f64, double, double, Usymqr)
