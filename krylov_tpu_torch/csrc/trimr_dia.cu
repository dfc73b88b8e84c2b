// Whole TriMR solve of the symmetric quasi-definite system
// [tau I A; A^H nu I][x; y] = [b; c] for a square DIA matrix on Hopper
// (sm_90a), with no grid-wide barrier.
//
// Replaces the TPU kernel krylov_tpu/ops/pallas_fused.py:5639
// trimr_dia_fused and computes what it computes (pallas_fused.py:
// 5680-5863): the orthogonal Saunders-Simon-Yip tridiagonalisation (A on
// u, A^H on v), the QR factorisation of S_{k+1}.k by the four reflections
// of the last iteration applied to the new columns and a cascade of four
// new ones, the four-deep recurrences of the x and y directions, the pi
// pair and the residual estimate.  Where beta_{k+1} or gamma_{k+1} <=
// eps^(3/4) the new q or p stays un-normalised; both at once is a
// breakdown (code 28, "inconsistent linear system"), unless the solved
// test, rNorm <= eps or rNorm + 1 <= 1, holds.  Outputs: x, y, niter,
// rNorm and the status code (0 running, 1 solved, 2 zero residual, 28
// breakdown).
//
// Bound on an H100 SXM: memory bandwidth.  An iteration applies A and
// A^H once each (2 x 28 B per row in f32 for the 7-point stencil) and
// must read v_k, u_k, v_{k-1}, u_{k-1}, the eight direction panels
// (gx and gy, four deep), x and y, and write v_{k+1}, u_{k+1}, the new
// pair of each direction, x and y: (56 + 14 x 4 + 8 x 4) B per row,
// 144 B.
//
// Design: the launches of ssy.cuh, with
//   3. the update: thread 0 of every block applies the last iteration's
//      four reflections (held in the scalar state) to the new columns,
//      runs the new cascade (sym_givens four times) and the pi pair, and
//      block 0 stages the next state (the branch of the first iteration
//      where it = 1); then, row by row, gx_odd, gx_even, gy_odd and
//      gy_even from v_k and u_k before v_{k+1} and u_{k+1} go over q and
//      p, and x and y; the eps^(3/4) normalisation (ssy::uses_btol)
// and no finishing launch.  The TPU kernel shifts its four-deep panels
// by copies (pallas_fused.py:5831-5838); here each of gx and gy is two
// pairs of rows whose roles turn over with the parity of the iteration:
// the pair in rows (it0 mod 2) holds g_{2k-3}, g_{2k-2} and the other
// g_{2k-1}, g_{2k}, and the new pair overwrites the older one row by
// row, in the thread that read it.  All eight start zeroed, so the
// first two iterations' masked coefficients give the general core's
// selects (pallas_fused.py:5802-5808).  Per iteration this design moves
// (56 + 24) + 24 + (56 + 32) B per row in f32: 192 B.
#include "ssy.cuh"

namespace {

using namespace ssy;

constexpr int INCONS_TRI = 28;

// slots of the scalar and int arrays after the shared ones; ATOL and
// RTOL, and TAU and NU after the staging copy, are set by the host
enum ScalarSlot {
  EPS_LIM = GAMMA + 1, OC1, OS1, OC2, OS2, OC3, OS3, OC4, OS4, SBAR_M2,
  EBAR_M3, LBAR_M3, MU_M5, MU_M4, LAM_M4, PIBAR_ODD, PIBAR_EVEN, RNORM,
  NSC_STATE, TAU = 2 * NSC_STATE - BETA, NU, NSC
};
enum IntSlot { NST_STATE = GO + 1, NST = 2 * NST_STATE - STATUS };
// the method's own rows of the vector workspace: x, y, then gx and gy,
// each two pairs of rows
enum OwnRow { X = NSHARED_ROWS, Y, GX, GY = GX + 4, NROWS = GY + 4 };

struct Trimr {
  static constexpr int kRows = NROWS - NSHARED_ROWS;
  static constexpr bool kBtol = true;
  static constexpr int kNscState = NSC_STATE;
  static constexpr int kNstState = NST_STATE;
  static int b_row(int) { return -1; }

  template <typename T>
  struct Coef {
    T mu5, lam4, e_m3, s_m2, mu4, l_m3, e_m2, s_odd, sd_odd, sd_even,
        pi_odd, pi_even;
  };

  // rNorm_0 = sqrt(gamma_0^2 + beta_0^2), eps, the status and the pi
  // pair (beta_0, gamma_0) (pallas_fused.py:5679-5693)
  template <typename T>
  __device__ static void init_scalars(T beta0, T gamma0, T* sc, int* st,
                                      int) {
    const T rnorm = sqrt(gamma0 * gamma0 + beta0 * beta0);
    const T eps_lim = sc[ATOL] + sc[RTOL] * rnorm;
    sc[EPS_LIM] = eps_lim;
    sc[RNORM] = rnorm;
    sc[PIBAR_ODD] = beta0;
    sc[PIBAR_EVEN] = gamma0;
    st[STATUS] = rnorm == T(0)      ? ZERO_RESIDUAL
                 : rnorm <= eps_lim ? SOLVED
                                    : RUNNING;
  }

  // One iteration's scalars, branch for branch as the TPU kernel
  // (pallas_fused.py:5742-5827, 5845-5856).
  template <typename T>
  __device__ static Coef<T> step(const T* sc, const int* st, T alpha,
                                 T beta1, T gamma1, int it, int, T* nsc,
                                 int* nst) {
    const bool first = it == 1;
    const bool ge2 = it >= 2;
    const T tau = sc[TAU];
    const T nu = sc[NU];
    const T oc1 = sc[OC1], os1 = sc[OS1], oc2 = sc[OC2], os2 = sc[OS2];
    const T oc3 = sc[OC3], os3 = sc[OS3], oc4 = sc[OC4], os4 = sc[OS4];
    const T sbar_m2 = sc[SBAR_M2];
    const T ebar_m3 = sc[EBAR_M3];
    const T lbar_m3 = sc[LBAR_M3];
    // the four previous reflections (pallas_fused.py:5742-5770)
    const T sbis_m2 = oc1 * sbar_m2 + os1 * alpha;
    const T ebis_m2 = os1 * nu;
    const T lbis_m2 = os1 * beta1;
    const T thbis = os1 * sbar_m2 - oc1 * alpha;
    const T dbis_even = -oc1 * nu;
    const T sbis_even = -oc1 * beta1;
    const T e_m3k = oc2 * ebar_m3 + os2 * sbis_m2;
    const T l_m3k = oc2 * lbar_m3 + os2 * ebis_m2;
    const T mu_m3k = os2 * lbis_m2;
    const T shat_m2 = os2 * ebar_m3 - oc2 * sbis_m2;
    const T ehat_m2 = os2 * lbar_m3 - oc2 * ebis_m2;
    const T lhat_m2 = -oc2 * lbis_m2;
    const T stmp_m2 = oc3 * shat_m2 + os3 * thbis;
    const T etmp_m2 = oc3 * ehat_m2 + os3 * dbis_even;
    const T ltmp_m2 = oc3 * lhat_m2 + os3 * sbis_even;
    const T thetabar_k = os3 * shat_m2 - oc3 * thbis;
    const T dbar_even_k = os3 * ehat_m2 - oc3 * dbis_even;
    const T sbar_even_k = os3 * lhat_m2 - oc3 * sbis_even;
    const T s_m2k = oc4 * stmp_m2 + os4 * tau;
    const T e_m2k = oc4 * etmp_m2 + os4 * alpha;
    const T l_m2k = oc4 * ltmp_m2;
    const T mu_m2k = os4 * gamma1;
    const T dbar_odd_k = os4 * stmp_m2 - oc4 * tau;
    const T sbar_odd_k = os4 * etmp_m2 - oc4 * alpha;
    const T ebar_odd_k = os4 * ltmp_m2;
    const T lbar_odd_k = -oc4 * gamma1;
    const T thetabar = first ? alpha : thetabar_k;
    const T dbar_odd = first ? tau : dbar_odd_k;
    const T dbar_even = first ? nu : dbar_even_k;
    const T sbar_odd = first ? alpha : sbar_odd_k;
    const T sbar_even = first ? beta1 : sbar_even_k;
    const T lbar_odd = first ? gamma1 : lbar_odd_k;
    const T ebar_odd = first ? T(0) : ebar_odd_k;
    const T e_m3 = first ? T(0) : e_m3k;
    const T l_m3 = first ? T(0) : l_m3k;
    const T mu_m3 = first ? T(0) : mu_m3k;
    const T s_m2 = first ? T(0) : s_m2k;
    const T e_m2 = first ? T(0) : e_m2k;
    const T l_m2 = first ? T(0) : l_m2k;
    const T mu_m2 = first ? T(0) : mu_m2k;
    // the current cascade (pallas_fused.py:5786-5794)
    T c1, s1, theta_k, c2, s2, d_odd, c3, s3, dhat_even, c4, s4, d_even;
    sym_givens(thetabar, gamma1, c1, s1, theta_k);
    const T g_k = s1 * dbar_even;
    const T dbar_even2 = c1 * dbar_even;
    sym_givens(dbar_odd, theta_k, c2, s2, d_odd);
    const T s_odd = c2 * sbar_odd + s2 * dbar_even2;
    const T dbis_even2 = s2 * sbar_odd - c2 * dbar_even2;
    sym_givens(dbis_even2, g_k, c3, s3, dhat_even);
    sym_givens(dhat_even, beta1, c4, s4, d_even);
    // the pi pair (pallas_fused.py:5819-5827)
    const T pibar_odd = sc[PIBAR_ODD];
    const T pibar_even = sc[PIBAR_EVEN];
    const T pibis_even = c1 * pibar_even;
    const T pibis_next_even = s1 * pibar_even;
    const T pi_odd = c2 * pibar_odd + s2 * pibis_even;
    const T pihat_even = s2 * pibar_odd - c2 * pibis_even;
    const T pitmp = c3 * pihat_even + s3 * pibis_next_even;
    const T pibar_next_even = s3 * pihat_even - c3 * pibis_next_even;
    const T pi_even = c4 * pitmp;
    const T pibar_next_odd = s4 * pitmp;
    if (nsc != nullptr) {
      // the residual estimate and the tests (pallas_fused.py:5845-5850)
      const T rnorm = sqrt(pibar_next_odd * pibar_next_odd
                           + pibar_next_even * pibar_next_even);
      const T btol = btol_of<T>();
      const bool solved = rnorm <= sc[EPS_LIM] || rnorm + T(1) <= T(1);
      const bool breakdown = beta1 <= btol && gamma1 <= btol;
      stage_state<T, Trimr>(sc, st, nsc, nst);
      nsc[BETA] = beta1;
      nsc[GAMMA] = gamma1;
      nsc[OC1] = c1;
      nsc[OS1] = s1;
      nsc[OC2] = c2;
      nsc[OS2] = s2;
      nsc[OC3] = c3;
      nsc[OS3] = s3;
      nsc[OC4] = c4;
      nsc[OS4] = s4;
      nsc[SBAR_M2] = sbar_even;
      nsc[EBAR_M3] = ebar_odd;
      nsc[LBAR_M3] = lbar_odd;
      nsc[MU_M5] = ge2 ? mu_m3 : sc[MU_M5];
      nsc[MU_M4] = ge2 ? mu_m2 : sc[MU_M4];
      nsc[LAM_M4] = ge2 ? l_m2 : sc[LAM_M4];
      nsc[PIBAR_ODD] = pibar_next_odd;
      nsc[PIBAR_EVEN] = pibar_next_even;
      nsc[RNORM] = rnorm;
      nst[STATUS] = solved ? SOLVED : breakdown ? INCONS_TRI : RUNNING;
    }
    return Coef<T>{first ? T(0) : sc[MU_M5], first ? T(0) : sc[LAM_M4],
                   e_m3, s_m2, first ? T(0) : sc[MU_M4], l_m3, e_m2, s_odd,
                   safe(d_odd), safe(d_even), pi_odd, pi_even};
  }

  // The new direction pair of x and of y over the older one, then x and y
  // (pallas_fused.py:5809-5830).
  template <typename T>
  __device__ static void update_row(T* work, const Coef<T>& k,
                                    const Vecs<T>& v, int it0, long long n,
                                    long long i) {
    const int old = 2 * (it0 % 2);
    const int mid = 2 - old;
    T* gx0 = row(work, GX + old, n);
    T* gx1 = row(work, GX + old + 1, n);
    T* gy0 = row(work, GY + old, n);
    T* gy1 = row(work, GY + old + 1, n);
    const T gx2 = row(work, GX + mid, n)[i];
    const T gx3 = row(work, GX + mid + 1, n)[i];
    const T gy2 = row(work, GY + mid, n)[i];
    const T gy3 = row(work, GY + mid + 1, n)[i];
    const T vk = v.vk[i];
    const T uk = v.uk[i];
    const T gx_odd = (vk - k.mu5 * gx0[i] - k.lam4 * gx1[i] - k.e_m3 * gx2
                      - k.s_m2 * gx3) / k.sd_odd;
    const T gx_even = (-k.mu4 * gx1[i] - k.l_m3 * gx2 - k.e_m2 * gx3
                       - k.s_odd * gx_odd) / k.sd_even;
    const T gy_odd = (-k.mu5 * gy0[i] - k.lam4 * gy1[i] - k.e_m3 * gy2
                      - k.s_m2 * gy3) / k.sd_odd;
    const T gy_even = (uk - k.mu4 * gy1[i] - k.l_m3 * gy2 - k.e_m2 * gy3
                       - k.s_odd * gy_odd) / k.sd_even;
    gx0[i] = gx_odd;
    gx1[i] = gx_even;
    gy0[i] = gy_odd;
    gy1[i] = gy_even;
    T* x = row(work, X, n);
    T* y = row(work, Y, n);
    x[i] = x[i] + k.pi_odd * gx_odd + k.pi_even * gx_even;
    y[i] = y[i] + k.pi_odd * gy_odd + k.pi_even * gy_even;
  }
};

}  // namespace

KTT_SSY_INIT(ktt_trimr_dia_init_f32, float, Trimr)
KTT_SSY_INIT(ktt_trimr_dia_init_f64, double, Trimr)
KTT_SSY_ITERATE(ktt_trimr_dia_iterate_f32_f32, float, float, Trimr)
KTT_SSY_ITERATE(ktt_trimr_dia_iterate_f32_bf16, float, __nv_bfloat16, Trimr)
KTT_SSY_ITERATE(ktt_trimr_dia_iterate_f32_f16, float, __half, Trimr)
KTT_SSY_ITERATE(ktt_trimr_dia_iterate_f64_f64, double, double, Trimr)
