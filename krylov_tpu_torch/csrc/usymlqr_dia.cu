// Whole USYMLQR solve of the saddle point [I A; A^H 0][x; y] = [b; c] for
// a DIA matrix, on Hopper (sm_90a), with no grid-wide barrier.
//
// Replaces the TPU kernel krylov_tpu/ops/pallas_fused.py:7968
// usymlqr_dia_fused and computes what it computes (pallas_fused.py:
// 7989-8161): one Saunders-Simon-Yip process feeding the least-squares
// QR recurrences (y, the residual r and the ||A^H r|| inconsistency
// test) and the least-norm LQ recurrences (x^L and z), each frozen by its
// own mask, and after the loop the composition x = x^L + r, y = y + z.
// flag bit 0 selects the least-squares sweep (ls), bit 1 the least-norm
// sweep (ln).  Outputs: x, y, niter, rnorm_ls, rnorm_ln, the status code
// (0 running / 1 solved / 8 inconsistent) and the inconsistent flag.
//
// Bound on an H100 SXM: memory bandwidth.  An iteration applies A and
// A^H once each (2 x 28 B per row in f32 for the 7-point stencil) and
// must read v_k, u_k, v_{k-1}, u_{k-1}, x, y, r, z, w_{k-1}, w_{k-2} and
// d_bar and write v_{k+1}, u_{k+1}, x, y, r, z, w_k and d_bar: (56 + 76)
// B per row, 132 B.
//
// Design: the launches of ssy.cuh, each row update in the earliest pass
// that has its scalars and already reads its vectors:
//   1. the stencil: q, p, the partials of <v_k, q>; the least-norm x and
//      d_bar, whose coefficients (x_add c_{k-1}, x_add s_{k-1}, c_{k-1},
//      s_{k-1}) come from the committed state alone (Usymlqr::pre in
//      thread 0 of every block, Usymlqr::early_rows on each thread's R
//      rows) and whose vector v_k the pass already reads
//   2. alpha
//   3. the update: the QR step of T_{k+1,k} (delta from
//      sym_givens(delta_bar, beta_{k+1})) and both sweeps' scalars in
//      thread 0 of every block; w_k into the buffer of w_{k-2}, y and r
//      (the least-squares sweep needs delta, phi and the r factor), and
//      z, which reads w_{k-1} as w_k does (Usymlqr::late_rows, 16 bytes
//      of each vector a thread); a zero norm zeroes the new basis vector
//   4. the commit
// and one finishing launch after the loop for the composition.  Each
// row's products and sums are those of the one-row update, in the same
// order.  Per iteration this design moves (80 + 16) + 24 + (16 + 40) B
// per row in f32: 176 B.
#include "ssy.cuh"

namespace {

using namespace ssy;

enum ScalarSlot {
  EPS_LS = GAMMA + 1, EPS_LN, C_KM2, S_KM2, C_KM1, S_KM1, PHIBAR, ZETA_KM1,
  ZETA_KM2, ETA_KM1, DELTA_KM1, KAPPA, AHRNORM, RNORM_LS, RNORM_LN,
  NSC_STATE, NSC = 2 * NSC_STATE - BETA
};
enum IntSlot {
  SLS = GO + 1, SLN, INCON, NST_STATE, NST = 2 * NST_STATE - STATUS
};
enum OwnRow { X = NSHARED_ROWS, Y, R, Z, W0, W1, DBAR, NROWS };

// w_{k-1} sits in buffer W0 + (it + 1) mod 2 and w_{k-2} in W0 + it mod 2,
// where w_k goes (it the 0-based iteration count).
__device__ __forceinline__ int wkm1_row(int it0) { return W0 + (it0 + 1) % 2; }
__device__ __forceinline__ int wkm2_row(int it0) { return W0 + it0 % 2; }

struct Usymlqr {
  static constexpr int kRows = NROWS - NSHARED_ROWS;
  static constexpr bool kKeep = false;
  static constexpr int kNscState = NSC_STATE;
  static constexpr int kNstState = NST_STATE;
  // r starts as b when the least-squares sweep runs
  static int b_row(int flag) { return flag & 1 ? static_cast<int>(R) : -1; }

  static constexpr bool kSplit = true;

  // The least-norm sweep's row coefficients, from the committed state,
  // and what the step takes from them (pallas_fused.py:8104-8114).
  template <typename T>
  struct Pre {
    T zeta_km1, x_add, xa, xb, c_km1, s_km1;
    int aln, is1;
  };

  template <typename T>
  __device__ static Pre<T> pre(const T* sc, const int* st, int it,
                               int flag) {
    const bool aln = (flag & 2) && st[SLN] == 0;
    const T c_km1 = sc[C_KM1];
    const T s_km1 = sc[S_KM1];
    const T zeta_km1 = aln && it >= 2 ? sc[ETA_KM1] / safe(sc[DELTA_KM1])
                                      : sc[ZETA_KM1];
    const T x_add = aln && it >= 2 ? zeta_km1 : T(0);
    return Pre<T>{zeta_km1, x_add, x_add * c_km1, x_add * s_km1, c_km1,
                  s_km1, aln ? 1 : 0, it == 1 ? 1 : 0};
  }

  // The coefficients of the rows that wait for alpha and the norms.
  template <typename T>
  struct Coef {
    T lam_km1, eps_km2, d, yfac, rfac, s2, zfac;
    int als;
  };

  // beta_1 = ||b||, gamma_1 = ||c||, the tolerances, the sweeps' flags and
  // the starting state (pallas_fused.py:8017-8039)
  template <typename T>
  __device__ static void init_scalars(T beta0, T gamma0, T* sc, int* st,
                                      int flag) {
    const bool ls = flag & 1;
    const bool ln = flag & 2;
    const T eps_ls = sc[ATOL] + sc[RTOL] * beta0;
    const T eps_ln = sc[ATOL] + sc[RTOL] * gamma0;
    sc[EPS_LS] = eps_ls;
    sc[EPS_LN] = eps_ln;
    sc[C_KM2] = T(-1);
    sc[C_KM1] = T(-1);
    sc[PHIBAR] = beta0;
    sc[AHRNORM] = T(INFINITY);
    sc[RNORM_LS] = beta0;
    sc[RNORM_LN] = gamma0;
    st[SLS] = !ls || beta0 <= eps_ls ? 1 : 0;
    st[SLN] = !ln || gamma0 <= eps_ln ? 1 : 0;
    st[STATUS] = st[SLS] == 1 && st[SLN] == 1 ? SOLVED : RUNNING;
  }

  // One iteration's scalars, branch for branch as the TPU kernel
  // (pallas_fused.py:8062-8150).
  template <typename T>
  __device__ static Coef<T> step(const T* sc, const int* st, T alpha,
                                 T beta1, T gamma1, int it, int flag, T* nsc,
                                 int* nst) {
    const bool ls = flag & 1;
    const bool is1 = it == 1;
    const bool ge2 = it >= 2;
    const T gamma = sc[GAMMA];
    const T c_km2 = sc[C_KM2];
    const T s_km2 = sc[S_KM2];
    const T c_km1 = sc[C_KM1];
    const T s_km1 = sc[S_KM1];
    const T eps_km2 = s_km2 * gamma;
    const T lambdabar = -c_km2 * gamma;
    const T lam_km1 = c_km1 * lambdabar + s_km1 * alpha;
    const T deltabar = s_km1 * lambdabar - c_km1 * alpha;
    T ck, sk, delta;
    sym_givens(deltabar, beta1, ck, sk, delta);

    // least-squares sweep
    const bool als = ls && st[SLS] == 0;
    const T phibar = sc[PHIBAR];
    const T phi = ck * phibar;
    const T phibar_next = sk * phibar;
    const T rfac = beta1 != T(0) ? -ck * phibar_next / safe(beta1) : T(0);
    const T rnorm_ls = als ? static_cast<T>(fabs(phibar_next)) : sc[RNORM_LS];
    const T cg = c_km1 * gamma1;
    const T ahrnorm =
        als ? static_cast<T>(fabs(phibar))
                  * sqrt(deltabar * deltabar + cg * cg)
            : sc[AHRNORM];
    const T kappa = ls && is1 ? sc[ATOL] + sc[RTOL] * ahrnorm : sc[KAPPA];
    const int sls = als && rnorm_ls <= sc[EPS_LS] ? 1 : st[SLS];
    const int incon = als ? (!(rnorm_ls <= sc[EPS_LS]) && ahrnorm <= kappa
                                 ? 1 : 0)
                          : st[INCON];

    // least-norm sweep
    const Pre<T> e = pre<T>(sc, st, it, flag);
    const bool aln = e.aln;
    const T zeta_km1 = e.zeta_km1;
    const T zeta_km2 = aln && it >= 3 ? sc[ZETA_KM1] : sc[ZETA_KM2];
    const T eta =
        aln ? (is1 ? gamma : -eps_km2 * zeta_km2 - lam_km1 * zeta_km1)
            : sc[ETA_KM1];
    const T mu = gamma * (s_km2 * zeta_km2 - c_km2 * c_km1 * zeta_km1)
                 + alpha * s_km1 * zeta_km1;
    const T om = gamma1 * s_km1 * zeta_km1;
    const T rnorm_ln = aln && ge2 ? sqrt(mu * mu + om * om) : sc[RNORM_LN];
    const int sln = aln && rnorm_ln <= sc[EPS_LN] ? 1 : st[SLN];
    if (nsc != nullptr) {
      stage_state<T, Usymlqr>(sc, st, nsc, nst);
      nsc[BETA] = beta1;
      nsc[GAMMA] = gamma1;
      nsc[C_KM2] = c_km1;
      nsc[S_KM2] = s_km1;
      nsc[C_KM1] = ck;
      nsc[S_KM1] = sk;
      nsc[PHIBAR] = als ? phibar_next : phibar;
      nsc[ZETA_KM1] = zeta_km1;
      nsc[ZETA_KM2] = zeta_km2;
      nsc[ETA_KM1] = aln ? eta : sc[ETA_KM1];
      nsc[DELTA_KM1] = delta;
      nsc[KAPPA] = kappa;
      nsc[AHRNORM] = ahrnorm;
      nsc[RNORM_LS] = rnorm_ls;
      nsc[RNORM_LN] = rnorm_ln;
      nst[SLS] = sls;
      nst[SLN] = sln;
      nst[INCON] = incon;
      nst[STATUS] = sls == 1 && sln == 1 ? SOLVED
                    : incon == 1 ? INCONSISTENT : RUNNING;
    }
    return Coef<T>{lam_km1, eps_km2, safe(delta), (als ? T(1) : T(0)) * phi,
                   rfac, sk * sk, e.x_add, als ? 1 : 0};
  }

  // The least-norm x and d_bar on rows i0 .. i0 + NR - 1 (left of them
  // below n), in the stencil's pass (pallas_fused.py:8115-8121)
  template <int NR, bool VEC, typename T>
  __device__ static void early_rows(T* work, const Pre<T>& k, int it0,
                                    long long n, long long i0,
                                    long long left) {
    T* x = row(work, X, n) + i0;
    T* dbar = row(work, DBAR, n) + i0;
    T xv[NR];
    T dv[NR];
    T vv[NR];
    load_rows<VEC>(x, left, xv);
    load_rows<VEC>(dbar, left, dv);
    load_rows<VEC>(row(work, V0 + cur(it0), n) + i0, left, vv);
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      const T vi = vv[r];
      const T di = dv[r];
      xv[r] = xv[r] + k.xa * di + k.xb * vi;
      dv[r] = k.is1 ? vi : k.s_km1 * di - k.c_km1 * vi;
    }
    store_rows<VEC>(x, left, xv);
    if (k.aln) store_rows<VEC>(dbar, left, dv);
  }

  // w_k into the buffer of w_{k-2}; y and r (least squares); z (least
  // norm), from the old w_{k-1}, on rows i0 .. i0 + NR - 1 (left of them
  // below n), before v_{k+1} goes over q (pallas_fused.py:8069-8144)
  template <int NR, bool VEC, typename T>
  __device__ static void late_rows(T* work, const Coef<T>& k, int it0,
                                   long long n, long long i0,
                                   long long left) {
    T* wkm2 = row(work, wkm2_row(it0), n) + i0;
    T* y = row(work, Y, n) + i0;
    T* r = row(work, R, n) + i0;
    T* z = row(work, Z, n) + i0;
    T w1[NR];
    T w2[NR];
    T uv[NR];
    T qv[NR];
    T yv[NR];
    T rv[NR];
    T zv[NR];
    load_rows<VEC>(row(work, wkm1_row(it0), n) + i0, left, w1);
    load_rows<VEC>(wkm2, left, w2);
    load_rows<VEC>(row(work, U0 + cur(it0), n) + i0, left, uv);
    load_rows<VEC>(y, left, yv);
    load_rows<VEC>(z, left, zv);
    if (k.als) {
      load_rows<VEC>(row(work, V0 + next(it0), n) + i0, left, qv);
      load_rows<VEC>(r, left, rv);
    }
#pragma unroll
    for (int j = 0; j < NR; ++j) {
      const T w = (uv[j] - k.lam_km1 * w1[j] - k.eps_km2 * w2[j]) / k.d;
      yv[j] = yv[j] + k.yfac * w;
      if (k.als) rv[j] = k.s2 * rv[j] + k.rfac * qv[j];
      zv[j] = zv[j] - k.zfac * w1[j];
      w2[j] = w;
    }
    store_rows<VEC>(y, left, yv);
    if (k.als) store_rows<VEC>(r, left, rv);
    store_rows<VEC>(z, left, zv);
    store_rows<VEC>(wkm2, left, w2);
  }

  // After the loop: x = x^L + r, y = y + z (pallas_fused.py:8152-8155).
  template <typename T>
  __device__ static bool finishes(const T*, const int*) {
    return true;
  }
  template <typename T>
  __device__ static void finish_row(T* work, const T*, const int*,
                                    long long n, long long i) {
    T* x = row(work, X, n);
    T* y = row(work, Y, n);
    x[i] = x[i] + row(work, R, n)[i];
    y[i] = y[i] + row(work, Z, n)[i];
  }
};

}  // namespace

KTT_SSY_INIT(ktt_usymlqr_dia_init_f32, float, Usymlqr)
KTT_SSY_INIT(ktt_usymlqr_dia_init_f64, double, Usymlqr)
KTT_SSY_ITERATE(ktt_usymlqr_dia_iterate_f32_f32, float, float, Usymlqr)
KTT_SSY_ITERATE(ktt_usymlqr_dia_iterate_f32_bf16, float, __nv_bfloat16,
                Usymlqr)
KTT_SSY_ITERATE(ktt_usymlqr_dia_iterate_f32_f16, float, __half, Usymlqr)
KTT_SSY_ITERATE(ktt_usymlqr_dia_iterate_f64_f64, double, double, Usymlqr)
KTT_SSY_FINISH(ktt_usymlqr_dia_finish_f32, float, Usymlqr)
KTT_SSY_FINISH(ktt_usymlqr_dia_finish_f64, double, Usymlqr)
