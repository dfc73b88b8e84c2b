// Whole USYMLQ solve of A x = b for a DIA matrix, c starting the second
// SSY basis, on Hopper (sm_90a), with no grid-wide barrier.
//
// Replaces the TPU kernel krylov_tpu/ops/pallas_fused.py:6565
// usymlq_dia_fused and computes what it computes (pallas_fused.py:
// 6591-6706): the Saunders-Simon-Yip process (A on u, A^H on v), the LQ
// factorisation of T_k, the residual estimates of the LQ and USYMCG
// points and, with transfer_to_usymcg, the move of x to the USYMCG point
// when its test stops the solve.  Outputs: x, niter, rnorm and the status
// code (0 running / 2 zero residual / 35 the LQ point solved / 36 the
// USYMCG point solved).
//
// Bound on an H100 SXM: memory bandwidth.  An iteration applies A and
// A^H once each (2 x 28 B per row in f32 for the 7-point stencil) and
// must read v_k, u_k, v_{k-1}, u_{k-1}, x and d_bar and write v_{k+1},
// u_{k+1}, x and d_bar: (56 + 40) B per row, 96 B.
//
// Design: the launches of ssy.cuh.  Every coefficient of the row updates
// (c_k and s_k from sym_givens(d_bar_{k-1}, gamma_k), zeta_{k-1} from the
// last iteration's eta) comes from the committed state alone, so the
// rows run in the stencil's pass (Usymlq::pre in thread 0 of every
// block, Usymlq::early_rows on each thread's R rows), which already
// reads u_k:
//   1. the stencil: q, p, the partials of <v_k, q>; x += zeta c d_bar +
//      zeta s u_k and d_bar = s d_bar - c u_k
//   2. alpha
//   3. the update: the rest of the LQ chain and the two residual
//      estimates in thread 0 of every block (Usymlq::step, from alpha and
//      the norms); no row update but v_{k+1} and u_{k+1}, 16 bytes of
//      each a thread
//   4. the commit
// and one finishing launch after the loop, x += zeta_bar d_bar where the
// USYMCG point stopped the solve.  Each row's products and sums are those
// of the one-row update, in the same order.  Per iteration this design
// moves (80 + 16) + 24 + 16 B per row in f32: 136 B.
#include "ssy.cuh"

namespace {

using namespace ssy;

// slots of the scalar and int arrays after the shared ones; ATOL and
// RTOL are set by the host
enum ScalarSlot {
  EPS_LIM = GAMMA + 1, C_KM1, S_KM1, DBAR_KM1, ZETA_KM1, ZETA_KM2, ETA_KM1,
  ZETABAR, RNORM, NSC_STATE, NSC = 2 * NSC_STATE - BETA
};
enum IntSlot { CGFLAG = GO + 1, NST_STATE, NST = 2 * NST_STATE - STATUS };
// the method's own rows of the vector workspace
enum OwnRow { X = NSHARED_ROWS, DBAR, NROWS };

struct Usymlq {
  static constexpr int kRows = NROWS - NSHARED_ROWS;
  static constexpr bool kKeep = true;
  static constexpr int kNscState = NSC_STATE;
  static constexpr int kNstState = NST_STATE;
  static int b_row(int) { return -1; }

  static constexpr bool kSplit = true;

  // The row updates' coefficients, from the committed state, and what
  // the step takes from them (pallas_fused.py:6645-6647, 6655, 6662).
  template <typename T>
  struct Pre {
    T ck, sk, zeta_km1, xa, xb;
    int is1;
  };

  template <typename T>
  __device__ static Pre<T> pre(const T* sc, const int*, int it, int) {
    const bool is1 = it == 1;
    const bool ge2 = it >= 2;
    T ck_g, sk_g, d_km1;
    sym_givens(sc[DBAR_KM1], sc[GAMMA], ck_g, sk_g, d_km1);
    const T ck = is1 ? T(-1) : ck_g;
    const T sk = is1 ? T(0) : sk_g;
    const T zeta_km1 = ge2 ? sc[ETA_KM1] / safe(d_km1) : sc[ZETA_KM1];
    const T x_add = ge2 ? zeta_km1 : T(0);
    return Pre<T>{ck, sk, zeta_km1, x_add * ck, x_add * sk, is1 ? 1 : 0};
  }

  // The update's rows take no coefficient.
  template <typename T>
  struct Coef {};

  // ||b||, eps, the status and c_{k-1} = -1 (pallas_fused.py:6615-6627)
  template <typename T>
  __device__ static void init_scalars(T bnorm, T, T* sc, int* st, int) {
    const T eps_lim = sc[ATOL] + sc[RTOL] * bnorm;
    sc[EPS_LIM] = eps_lim;
    sc[C_KM1] = T(-1);
    sc[RNORM] = bnorm;
    st[STATUS] = bnorm == T(0) ? ZERO_RESIDUAL
                 : bnorm <= eps_lim ? SOLVED_LQ : RUNNING;
  }

  // One iteration's scalars, branch for branch as the TPU kernel
  // (pallas_fused.py:6660-6701).
  template <typename T>
  __device__ static Coef<T> step(const T* sc, const int* st, T alpha,
                                 T beta1, T gamma1, int it, int transfer,
                                 T* nsc, int* nst) {
    const Pre<T> k = pre<T>(sc, st, it, transfer);
    const bool is1 = it == 1;
    const bool is2 = it == 2;
    const T beta = sc[BETA];
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
    const T zeta_km1 = k.zeta_km1;
    const T zeta_km2 = it >= 3 ? sc[ZETA_KM1] : sc[ZETA_KM2];
    const T eta_k = is1 ? beta
                    : (is2 ? -lam_km1 * zeta_km1
                           : -eps_km2 * zeta_km2 - lam_km1 * zeta_km1);
    const T mu = beta * (s_km1 * zeta_km2 - c_km1 * ck * zeta_km1)
                 + alpha * sk * zeta_km1;
    const T om = beta1 * sk * zeta_km1;
    const T rnorm = is1 ? sc[RNORM] : sqrt(mu * mu + om * om);
    const bool dbar_ok = fabs(dbar_k) > eps_of<T>();
    const T zetabar = dbar_ok ? eta_k / safe(dbar_k) : sc[ZETABAR];
    const T rnorm_cg = fabs(beta1 * (sk * zeta_km1 - ck * zetabar));
    const bool solved_lq = rnorm <= sc[EPS_LIM];
    const bool solved_cg = transfer && dbar_ok && rnorm_cg <= sc[EPS_LIM];
    if (nsc != nullptr) {
      stage_state<T, Usymlq>(sc, st, nsc, nst);
      nsc[BETA] = beta1;
      nsc[GAMMA] = gamma1;
      nsc[C_KM1] = ck;
      nsc[S_KM1] = sk;
      nsc[DBAR_KM1] = dbar_k;
      nsc[ZETA_KM1] = zeta_km1;
      nsc[ZETA_KM2] = zeta_km2;
      nsc[ETA_KM1] = eta_k;
      nsc[ZETABAR] = zetabar;
      nsc[RNORM] = rnorm;
      nst[STATUS] = solved_lq ? SOLVED_LQ : solved_cg ? SOLVED_CG : RUNNING;
      nst[CGFLAG] = solved_cg && !solved_lq ? 1 : 0;
    }
    return Coef<T>{};
  }

  // x += zeta c d_bar + zeta s u_k, d_bar = s d_bar - c u_k on rows
  // i0 .. i0 + R - 1 (left of them below n), in the stencil's pass
  // (pallas_fused.py:6680-6683)
  template <int R, bool VEC, typename T>
  __device__ static void early_rows(T* work, const Pre<T>& k, int it0,
                                    long long n, long long i0,
                                    long long left) {
    T* x = row(work, X, n) + i0;
    T* dbar = row(work, DBAR, n) + i0;
    T xv[R];
    T dv[R];
    T uv[R];
    load_rows<VEC>(x, left, xv);
    load_rows<VEC>(dbar, left, dv);
    load_rows<VEC>(row(work, U0 + cur(it0), n) + i0, left, uv);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const T ui = uv[r];
      const T di = dv[r];
      xv[r] = xv[r] + k.xa * di + k.xb * ui;
      dv[r] = k.is1 ? ui : k.sk * di - k.ck * ui;
    }
    store_rows<VEC>(x, left, xv);
    store_rows<VEC>(dbar, left, dv);
  }

  // No row waits for alpha or the norms.
  template <int NR, bool VEC, typename T>
  __device__ static void late_rows(T*, const Coef<T>&, int, long long,
                                   long long, long long) {}

  // After the loop: x += zeta_bar d_bar where the USYMCG point solved
  // (pallas_fused.py:6703-6705).
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

KTT_SSY_INIT(ktt_usymlq_dia_init_f32, float, Usymlq)
KTT_SSY_INIT(ktt_usymlq_dia_init_f64, double, Usymlq)
KTT_SSY_ITERATE(ktt_usymlq_dia_iterate_f32_f32, float, float, Usymlq)
KTT_SSY_ITERATE(ktt_usymlq_dia_iterate_f32_bf16, float, __nv_bfloat16, Usymlq)
KTT_SSY_ITERATE(ktt_usymlq_dia_iterate_f32_f16, float, __half, Usymlq)
KTT_SSY_ITERATE(ktt_usymlq_dia_iterate_f64_f64, double, double, Usymlq)
KTT_SSY_FINISH(ktt_usymlq_dia_finish_f32, float, Usymlq)
KTT_SSY_FINISH(ktt_usymlq_dia_finish_f64, double, Usymlq)
