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
// Design: the launches of ssy.cuh, with
//   3. the update: the QR step of T_{k+1,k} and both sweeps' scalars in
//      thread 0 of every block; w_k into the buffer of w_{k-2}, y, r, x,
//      z and d_bar row by row; a zero norm zeroes the new basis vector
// and one finishing launch after the loop for the composition.  Per
// iteration this design moves (56 + 24) + 24 + (68 + 32) B per row in
// f32: 204 B.
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

  template <typename T>
  struct Coef {
    T lam_km1, eps_km2, d, yfac, rfac, s2, xa, xb, zfac, c_km1, s_km1;
    int als, aln, is1;
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
    const bool ln = flag & 2;
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
    const bool aln = ln && st[SLN] == 0;
    const T zeta_km1 = aln && ge2 ? sc[ETA_KM1] / safe(sc[DELTA_KM1])
                                  : sc[ZETA_KM1];
    const T zeta_km2 = aln && it >= 3 ? sc[ZETA_KM1] : sc[ZETA_KM2];
    const T eta =
        aln ? (is1 ? gamma : -eps_km2 * zeta_km2 - lam_km1 * zeta_km1)
            : sc[ETA_KM1];
    const T x_add = aln && ge2 ? zeta_km1 : T(0);
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
                   rfac, sk * sk, x_add * c_km1, x_add * s_km1, x_add,
                   c_km1, s_km1, als ? 1 : 0, aln ? 1 : 0, is1 ? 1 : 0};
  }

  // w_k into the buffer of w_{k-2}; y and r (least squares); x, z and
  // d_bar (least norm), from the old w_{k-1} (pallas_fused.py:8069-8144)
  template <typename T>
  __device__ static void update_row(T* work, const Coef<T>& k,
                                    const Vecs<T>& v, int it0, long long n,
                                    long long i) {
    T* wkm2 = row(work, wkm2_row(it0), n);
    T* x = row(work, X, n);
    T* y = row(work, Y, n);
    T* r = row(work, R, n);
    T* z = row(work, Z, n);
    T* dbar = row(work, DBAR, n);
    const T w1 = row(work, wkm1_row(it0), n)[i];
    const T w = (v.uk[i] - k.lam_km1 * w1 - k.eps_km2 * wkm2[i]) / k.d;
    y[i] = y[i] + k.yfac * w;
    if (k.als) r[i] = k.s2 * r[i] + k.rfac * v.q[i];
    const T vi = v.vk[i];
    const T di = dbar[i];
    x[i] = x[i] + k.xa * di + k.xb * vi;
    z[i] = z[i] - k.zfac * w1;
    if (k.aln) dbar[i] = k.is1 ? vi : k.s_km1 * di - k.c_km1 * vi;
    wkm2[i] = w;
  }

  // After the loop: x = x^L + r, y = y + z (pallas_fused.py:8152-8155).
  template <typename T>
  __device__ static bool finishes(const T*, const int*) {
    return true;
  }
  template <typename T>
  __device__ static void finish_row(T* work, const T*, long long n,
                                    long long i) {
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
