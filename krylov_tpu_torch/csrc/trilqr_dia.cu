// Whole TriLQR solve of A x = b and A^H y = c for a DIA matrix, on Hopper
// (sm_90a), with no grid-wide barrier.
//
// Replaces the TPU kernel krylov_tpu/ops/pallas_fused.py:7695
// trilqr_dia_fused and computes what it computes (pallas_fused.py:
// 7724-7910): one Saunders-Simon-Yip process feeding the primal USYMLQ
// recurrences (the LQ of T_k, x along d_bar) and the dual QR recurrences
// (y along w_{k-1} built from the old v_{k-1}), each frozen once its own
// system is solved or, for the dual, found inconsistent, and the move of
// x to the USYMCG point where that point's test solved the primal
// system.  Outputs: x, y, niter, rnorm, snorm, the status code (0
// running / 2 zero residual / 15 both solved) and nine flags: lq_tol,
// lq_mach, cg_tol, cg_mach, qr_tol, qr_mach, solved_primal, solved_dual,
// inconsistent_dual.
//
// Bound on an H100 SXM: memory bandwidth.  An iteration applies A and
// A^H once each (2 x 28 B per row in f32 for the 7-point stencil) and
// must read v_k, u_k, v_{k-1}, u_{k-1}, x, d_bar, y, w_{k-2} and w_{k-3}
// and write v_{k+1}, u_{k+1}, x, d_bar, y and w_{k-1}: (56 + 60) B per
// row, 116 B.
//
// Design: the launches of ssy.cuh.  Every coefficient of the vector
// updates (c_k and s_k from sym_givens(d_bar_{k-1}, gamma_k), zeta_{k-1},
// psi_{k-1}, lambda_{k-2}, epsilon_{k-3}, d_{k-1}) comes from the
// committed state alone, so all of them run in the stencil's pass
// (Trilqr::pre in thread 0 of every block, Trilqr::early_rows on each
// thread's R rows), which already reads u_k[i] and v_{k-1}[i]:
//   1. the stencil: q, p, the partials of <v_k, q>; the primal x and
//      d_bar updates, the dual direction w_{k-1} from v_{k-1} into the
//      buffer of w_{k-3}, and y
//   2. alpha
//   3. the update: both chains, the nine flags and the status in thread
//      0 of every block (Trilqr::step, from alpha and the norms); no row
//      update but v_{k+1} and u_{k+1}, 16 bytes of each a thread
//   4. the commit
// and one finishing launch after the loop, x += zeta_bar d_bar where the
// USYMCG point solved the primal system.  Each row's products and sums
// are those of the one-row update, in the same order.  Per iteration
// this design moves (80 + 36) + 24 + 16 B per row in f32: 156 B.
#include "ssy.cuh"

namespace {

using namespace ssy;

enum ScalarSlot {
  EPSL = GAMMA + 1, EPSQ, C_KM1, S_KM1, DBAR_KM1, ZETA_KM1, ZETA_KM2, ETA_KM1,
  ZETABAR, PSIBAR_KM1, EPS_KM3, LAM_KM2, KAPPA, RNORM, SNORM, NSC_STATE,
  NSC = 2 * NSC_STATE - BETA
};
enum IntSlot {
  SP = GO + 1, SD, LQ_T, LQ_M, CG_T, CG_M, QR_T, QR_M, CGFLAG, INCD,
  NST_STATE, NST = 2 * NST_STATE - STATUS
};
enum OwnRow { X = NSHARED_ROWS, Y, DBAR, W0, W1, NROWS };

// w_{k-2} sits in buffer W0 + (it + 1) mod 2 and w_{k-3} in W0 + it mod 2,
// where w_{k-1} goes (it the 0-based iteration count).
__device__ __forceinline__ int wkm2_row(int it0) { return W0 + (it0 + 1) % 2; }
__device__ __forceinline__ int wkm3_row(int it0) { return W0 + it0 % 2; }

struct Trilqr {
  static constexpr int kRows = NROWS - NSHARED_ROWS;
  static constexpr bool kKeep = true;
  static constexpr int kNscState = NSC_STATE;
  static constexpr int kNstState = NST_STATE;
  static int b_row(int) { return -1; }

  static constexpr bool kSplit = true;

  // ||b||, ||c||, the tolerances and the starting state (pallas_fused.py:
  // 7744-7770)
  template <typename T>
  __device__ static void init_scalars(T bnorm, T cnorm, T* sc, int* st,
                                      int) {
    sc[EPSL] = sc[ATOL] + sc[RTOL] * bnorm;
    sc[EPSQ] = sc[ATOL] + sc[RTOL] * cnorm;
    sc[C_KM1] = T(-1);
    sc[RNORM] = bnorm;
    sc[SNORM] = cnorm;
    st[SP] = bnorm == T(0) ? 1 : 0;
    st[SD] = cnorm == T(0) ? 1 : 0;
    st[STATUS] = st[SP] == 1 && st[SD] == 1 ? ZERO_RESIDUAL : RUNNING;
  }

  // The coefficients of the row updates, from the committed state, and
  // what the step takes from them (pallas_fused.py:7791-7794, 7804-7814,
  // 7853-7860).
  template <typename T>
  struct Pre {
    T ck, sk, zeta_km1, psi_km1, xa, xb, y_add, lam_km2, eps_km3, d;
    int it, pm;
  };

  template <typename T>
  __device__ static Pre<T> pre(const T* sc, const int* st, int it, int) {
    const bool ge2 = it >= 2;
    T ck_g, sk_g, d_km1;
    sym_givens(sc[DBAR_KM1], sc[GAMMA], ck_g, sk_g, d_km1);
    const T ck = it == 1 ? T(-1) : ck_g;
    const T sk = it == 1 ? T(0) : sk_g;
    const bool pm = st[SP] == 0;
    const T zeta_km1 = pm && ge2 ? sc[ETA_KM1] / safe(d_km1) : sc[ZETA_KM1];
    const T x_add = pm && ge2 ? zeta_km1 : T(0);
    const T psi_km1 = it == 1 ? T(0) : ck * sc[PSIBAR_KM1];
    return Pre<T>{ck, sk, zeta_km1, psi_km1, x_add * ck, x_add * sk,
                  st[SD] == 0 && ge2 ? psi_km1 : T(0), sc[LAM_KM2],
                  sc[EPS_KM3], safe(d_km1), it, pm ? 1 : 0};
  }

  // The update's rows take no coefficient.
  template <typename T>
  struct Coef {};

  // One iteration's scalars, branch for branch as the TPU kernel
  // (pallas_fused.py:7795-7887).
  template <typename T>
  __device__ static Coef<T> step(const T* sc, const int* st, T alpha,
                                 T beta1, T gamma1, int it, int transfer,
                                 T* nsc, int* nst) {
    const Pre<T> k = pre<T>(sc, st, it, transfer);
    const bool is1 = it == 1;
    const bool is2 = it == 2;
    const T beta = sc[BETA];
    const T gamma = sc[GAMMA];
    const T c_km1 = sc[C_KM1];
    const T s_km1 = sc[S_KM1];
    const T ck = k.ck;
    const T sk = k.sk;
    const T eps_km2 = s_km1 * beta;
    const T lam2 = ck * beta + sk * alpha;
    const T dbar2 = sk * beta - ck * alpha;
    const T lam3 = -c_km1 * ck * beta + sk * alpha;
    const T dbar3 = -c_km1 * sk * beta - ck * alpha;
    const T lam_km1 = is2 ? lam2 : lam3;
    const T dbar_k = is1 ? alpha : (is2 ? dbar2 : dbar3);

    // primal (USYMLQ), frozen once solved
    const bool pm = k.pm;
    const T zeta_km1 = k.zeta_km1;
    const T zeta_km2 = pm && it >= 3 ? sc[ZETA_KM1] : sc[ZETA_KM2];
    const T eta_k =
        pm ? (is1 ? beta
                  : (is2 ? -lam_km1 * zeta_km1
                         : -eps_km2 * zeta_km2 - lam_km1 * zeta_km1))
           : sc[ETA_KM1];
    const T mu = beta * (s_km1 * zeta_km2 - c_km1 * ck * zeta_km1)
                 + alpha * sk * zeta_km1;
    const T om = beta1 * sk * zeta_km1;
    T rnorm = is1 ? sc[RNORM] : sqrt(mu * mu + om * om);
    rnorm = pm ? rnorm : sc[RNORM];
    const bool dbar_ok = fabs(dbar_k) > eps_of<T>();
    const T zetabar = pm && dbar_ok ? eta_k / safe(dbar_k) : sc[ZETABAR];
    const T rnorm_cg = fabs(beta1 * (sk * zeta_km1 - ck * zetabar));
    const T epsl = sc[EPSL];
    const bool cg_t_b = transfer && dbar_ok && rnorm_cg <= epsl;
    const bool cg_m_b = transfer && dbar_ok && (rnorm_cg + T(1)) <= T(1);
    const int lq_t = pm ? (rnorm <= epsl ? 1 : 0) : st[LQ_T];
    const int lq_m = pm ? ((rnorm + T(1)) <= T(1) ? 1 : 0) : st[LQ_M];
    const int cg_t = pm ? (cg_t_b ? 1 : 0) : st[CG_T];
    const int cg_m = pm ? (cg_m_b ? 1 : 0) : st[CG_M];
    const bool solved_lq = lq_t == 1 || lq_m == 1;
    const bool solved_cg = cg_t == 1 || cg_m == 1;
    const int sp = pm && (solved_lq || solved_cg) ? 1 : st[SP];

    // dual (QR on A^H y = c), directions from the old v_{k-1}
    const bool dm = st[SD] == 0;
    const T psibar_k = is1 ? gamma : sk * sc[PSIBAR_KM1];
    const T snorm = dm ? static_cast<T>(fabs(psibar_k)) : sc[SNORM];
    const T cb = ck * beta1;
    const T asnorm = static_cast<T>(fabs(psibar_k))
                     * sqrt(dbar_k * dbar_k + cb * cb);
    const T kappa = is1 ? sc[ATOL] + sc[RTOL] * asnorm : sc[KAPPA];
    const int qr_t = dm ? (snorm <= sc[EPSQ] ? 1 : 0) : st[QR_T];
    const int qr_m = dm ? ((snorm + T(1)) <= T(1) ? 1 : 0) : st[QR_M];
    const int incd = dm ? (asnorm <= kappa ? 1 : 0) : st[INCD];
    const int sd = dm && (qr_t == 1 || qr_m == 1 || incd == 1) ? 1 : st[SD];
    if (nsc != nullptr) {
      stage_state<T, Trilqr>(sc, st, nsc, nst);
      nsc[BETA] = beta1;
      nsc[GAMMA] = gamma1;
      nsc[C_KM1] = ck;
      nsc[S_KM1] = sk;
      nsc[DBAR_KM1] = dbar_k;
      nsc[ZETA_KM1] = zeta_km1;
      nsc[ZETA_KM2] = zeta_km2;
      nsc[ETA_KM1] = eta_k;
      nsc[ZETABAR] = zetabar;
      nsc[PSIBAR_KM1] = psibar_k;
      if (it >= 3) nsc[EPS_KM3] = eps_km2;
      if (it >= 2) nsc[LAM_KM2] = lam_km1;
      nsc[KAPPA] = kappa;
      nsc[RNORM] = rnorm;
      nsc[SNORM] = snorm;
      nst[SP] = sp;
      nst[SD] = sd;
      nst[LQ_T] = lq_t;
      nst[LQ_M] = lq_m;
      nst[CG_T] = cg_t;
      nst[CG_M] = cg_m;
      nst[QR_T] = qr_t;
      nst[QR_M] = qr_m;
      nst[INCD] = incd;
      nst[CGFLAG] = st[CGFLAG] == 1 || (solved_cg && pm && !solved_lq)
                        ? 1 : st[CGFLAG];
      nst[STATUS] = sp == 1 && sd == 1 ? SOLVED_PRIMAL_DUAL : RUNNING;
    }
    return Coef<T>{};
  }

  // The primal x and d_bar, the dual w_{k-1} and y on rows i0 ..
  // i0 + R - 1 (left of them below n), in the stencil's pass
  // (pallas_fused.py:7815-7874)
  template <int R, bool VEC, typename T>
  __device__ static void early_rows(T* work, const Pre<T>& k, int it0,
                                    long long n, long long i0,
                                    long long left) {
    T* x = row(work, X, n) + i0;
    T* y = row(work, Y, n) + i0;
    T* dbar = row(work, DBAR, n) + i0;
    T* wkm3 = row(work, wkm3_row(it0), n) + i0;
    T xv[R];
    T yv[R];
    T dv[R];
    T uv[R];
    T vm[R];
    T w2[R];
    T w3[R];
    load_rows<VEC>(x, left, xv);
    load_rows<VEC>(y, left, yv);
    load_rows<VEC>(dbar, left, dv);
    load_rows<VEC>(row(work, U0 + cur(it0), n) + i0, left, uv);
    load_rows<VEC>(row(work, V0 + prev(it0), n) + i0, left, vm);
    load_rows<VEC>(row(work, wkm2_row(it0), n) + i0, left, w2);
    load_rows<VEC>(wkm3, left, w3);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const T ui = uv[r];
      const T di = dv[r];
      xv[r] = xv[r] + k.xa * di + k.xb * ui;
      dv[r] = k.it == 1 ? ui : k.sk * di - k.ck * ui;
      const T vi = vm[r];
      const T w2i = w2[r];
      const T w3i = w3[r];
      const T w = k.it == 2 ? vi / k.d
                  : (k.it == 3 ? (vi - k.lam_km2 * w2i) / k.d
                               : (vi - k.lam_km2 * w2i - k.eps_km3 * w3i)
                                     / k.d);
      yv[r] = yv[r] + k.y_add * w;
      w3[r] = w;
    }
    store_rows<VEC>(x, left, xv);
    if (k.pm) store_rows<VEC>(dbar, left, dv);
    store_rows<VEC>(y, left, yv);
    // w_{k-3} <- w_{k-2}, w_{k-2} <- w_{k-1} from the second iteration on
    if (k.it >= 2) store_rows<VEC>(wkm3, left, w3);
  }

  // No row waits for alpha or the norms.
  template <int NR, bool VEC, typename T>
  __device__ static void late_rows(T*, const Coef<T>&, int, long long,
                                   long long, long long) {}

  // After the loop: x += zeta_bar d_bar where the USYMCG point solved the
  // primal system (pallas_fused.py:7889-7891).
  template <typename T>
  __device__ static bool finishes(const T*, const int* st) {
    return st[CGFLAG] == 1;
  }
  template <typename T>
  __device__ static void finish_row(T* work, const T* sc, const int*,
                                    long long n, long long i) {
    T* x = row(work, X, n);
    x[i] = x[i] + sc[ZETABAR] * row(work, DBAR, n)[i];
  }
};

}  // namespace

KTT_SSY_INIT(ktt_trilqr_dia_init_f32, float, Trilqr)
KTT_SSY_INIT(ktt_trilqr_dia_init_f64, double, Trilqr)
KTT_SSY_ITERATE(ktt_trilqr_dia_iterate_f32_f32, float, float, Trilqr)
KTT_SSY_ITERATE(ktt_trilqr_dia_iterate_f32_bf16, float, __nv_bfloat16, Trilqr)
KTT_SSY_ITERATE(ktt_trilqr_dia_iterate_f32_f16, float, __half, Trilqr)
KTT_SSY_ITERATE(ktt_trilqr_dia_iterate_f64_f64, double, double, Trilqr)
KTT_SSY_FINISH(ktt_trilqr_dia_finish_f32, float, Trilqr)
KTT_SSY_FINISH(ktt_trilqr_dia_finish_f64, double, Trilqr)
