// Whole TriCG solve of the symmetric quasi-definite system
// [tau I A; A^H nu I][x; y] = [b; c] for a square DIA matrix on Hopper
// (sm_90a), with no grid-wide barrier.
//
// Replaces the TPU kernel krylov_tpu/ops/pallas_fused.py:5427
// tricg_dia_fused and computes what it computes (pallas_fused.py:
// 5447-5582): the orthogonal Saunders-Simon-Yip tridiagonalisation (A on
// u, A^H on v), the LDL^H factorisation of S_k.k, the solve of
// L_k D_k pi_k = beta_1 e_1 + gamma_1 e_2, the two-term recurrences of the
// x and y directions (odd and even), and the residual estimate.  Where
// beta_{k+1} or gamma_{k+1} <= eps^(3/4) the new q or p stays
// un-normalised; both at once is a breakdown (code 28, "inconsistent
// linear system"), unless the solved test, rNorm <= eps or rNorm + 1 <= 1,
// holds.  Outputs: x, y, niter, rNorm and the status code (0 running,
// 1 solved, 2 zero residual, 28 breakdown).
//
// Bound on an H100 SXM: memory bandwidth.  An iteration applies A and
// A^H once each (2 x 28 B per row in f32 for the 7-point stencil) and
// must read v_k, u_k, v_{k-1}, u_{k-1}, the four directions, x and y and
// write v_{k+1}, u_{k+1}, the four directions, x and y:
// (56 + 72) B per row, 128 B.
//
// Design: the launches of ssy.cuh, with
//   3. the update: sigma, eta, lambda, the LDL^H pivots, delta and the
//      pi pair in thread 0 of every block (the first iteration's branch
//      where it = 1); gx_odd, gx_even, gy_odd, gy_even, x and y row by
//      row, from v_k and u_k before v_{k+1} and u_{k+1} go over q and p;
//      the eps^(3/4) normalisation of v_{k+1} and u_{k+1}
//      (ssy::uses_btol)
// and no finishing launch.  Per iteration this design moves
// (56 + 24) + 24 + (40 + 32) B per row in f32: 176 B.
#include "ssy.cuh"

namespace {

using namespace ssy;

constexpr int INCONS_TRI = 28;

// slots of the scalar and int arrays after the shared ones; ATOL and
// RTOL, and TAU and NU after the staging copy, are set by the host
enum ScalarSlot {
  EPS_LIM = GAMMA + 1, D_M3, D_M2, PI_M3, PI_M2, DELTA_KM1, RNORM,
  NSC_STATE, TAU = 2 * NSC_STATE - BETA, NU, NSC
};
enum IntSlot { NST_STATE = GO + 1, NST = 2 * NST_STATE - STATUS };
// the method's own rows of the vector workspace
enum OwnRow { X = NSHARED_ROWS, Y, GXO, GXE, GYO, GYE, NROWS };

struct Tricg {
  static constexpr int kRows = NROWS - NSHARED_ROWS;
  static constexpr bool kBtol = true;
  static constexpr int kNscState = NSC_STATE;
  static constexpr int kNstState = NST_STATE;
  static int b_row(int) { return -1; }

  template <typename T>
  struct Coef {
    T eta, lam, sigma, delta, pi_odd, pi_even;
    int is1;
  };

  // rNorm_0 = sqrt(gamma_0^2 + beta_0^2), eps and the status
  // (pallas_fused.py:5470-5478)
  template <typename T>
  __device__ static void init_scalars(T beta0, T gamma0, T* sc, int* st,
                                      int) {
    const T rnorm = sqrt(gamma0 * gamma0 + beta0 * beta0);
    const T eps_lim = sc[ATOL] + sc[RTOL] * rnorm;
    sc[EPS_LIM] = eps_lim;
    sc[RNORM] = rnorm;
    st[STATUS] = rnorm == T(0)      ? ZERO_RESIDUAL
                 : rnorm <= eps_lim ? SOLVED
                                    : RUNNING;
  }

  // One iteration's scalars, branch for branch as the TPU kernel
  // (pallas_fused.py:5505-5574).
  template <typename T>
  __device__ static Coef<T> step(const T* sc, const int* st, T alpha,
                                 T beta1, T gamma1, int it, int, T* nsc,
                                 int* nst) {
    const bool is1 = it == 1;
    const T tau = sc[TAU];
    const T nu = sc[NU];
    const T beta = sc[BETA];
    const T gamma = sc[GAMMA];
    const T d_m3 = sc[D_M3];
    const T d_m2 = sc[D_M2];
    const T pi_m3 = sc[PI_M3];
    const T pi_m2 = sc[PI_M2];
    // the LDL^H of S_k.k (pallas_fused.py:5511-5523)
    const T delta1 = alpha / safe(tau);
    const T d_even1 = nu - delta1 * delta1 * tau;
    const T sigma = beta / safe(d_m2);
    const T eta = gamma / safe(d_m3);
    const T lam = -(eta * sc[DELTA_KM1] * d_m3) / safe(d_m2);
    const T d_oddk = tau - sigma * sigma * d_m2;
    const T deltak = (alpha - lam * sigma * d_m2) / safe(d_oddk);
    const T d_evenk = nu - eta * eta * d_m3 - lam * lam * d_m2
                      - deltak * deltak * d_oddk;
    const T d_odd = is1 ? tau : d_oddk;
    const T delta = is1 ? delta1 : deltak;
    const T d_even = is1 ? d_even1 : d_evenk;
    // L_k D_k pi_k = beta_1 e_1 + gamma_1 e_2 (pallas_fused.py:5525-5532)
    const T pi_odd1 = beta / safe(d_odd);
    const T pi_even1 = (gamma - delta * beta) / safe(d_even);
    const T pi_oddk = -(sigma * d_m2 * pi_m2) / safe(d_odd);
    const T pi_evenk = -(delta * d_odd * pi_oddk + lam * d_m2 * pi_m2
                         + eta * d_m3 * pi_m3) / safe(d_even);
    const T pi_odd = is1 ? pi_odd1 : pi_oddk;
    const T pi_even = is1 ? pi_even1 : pi_evenk;
    // the residual estimate and the tests (pallas_fused.py:5565-5574)
    const T zeta_odd = pi_odd - delta * pi_even;
    const T zeta_even = pi_even;
    const T g_z = gamma1 * zeta_odd;
    const T b_z = beta1 * zeta_even;
    const T rnorm = sqrt(g_z * g_z + b_z * b_z);
    const T btol = btol_of<T>();
    const bool solved = rnorm <= sc[EPS_LIM] || rnorm + T(1) <= T(1);
    const bool breakdown = beta1 <= btol && gamma1 <= btol;
    if (nsc != nullptr) {
      stage_state<T, Tricg>(sc, st, nsc, nst);
      nsc[BETA] = beta1;
      nsc[GAMMA] = gamma1;
      nsc[D_M3] = d_odd;
      nsc[D_M2] = d_even;
      nsc[PI_M3] = pi_odd;
      nsc[PI_M2] = pi_even;
      nsc[DELTA_KM1] = delta;
      nsc[RNORM] = rnorm;
      nst[STATUS] = solved ? SOLVED : breakdown ? INCONS_TRI : RUNNING;
    }
    return Coef<T>{eta, lam, sigma, delta, pi_odd, pi_even, is1 ? 1 : 0};
  }

  // The four directions, then x and y (pallas_fused.py:5534-5554).
  template <typename T>
  __device__ static void update_row(T* work, const Coef<T>& k,
                                    const Vecs<T>& v, int, long long n,
                                    long long i) {
    T* gxo = row(work, GXO, n);
    T* gxe = row(work, GXE, n);
    T* gyo = row(work, GYO, n);
    T* gye = row(work, GYE, n);
    const T vk = v.vk[i];
    const T uk = v.uk[i];
    const T gxo_old = gxo[i];
    const T gxe_old = gxe[i];
    const T gyo_old = gyo[i];
    const T gye_old = gye[i];
    const T gx_mid = k.eta * gxo_old + k.lam * gxe_old;
    const T gy_mid = k.eta * gyo_old + k.lam * gye_old;
    const T gx_evenk = vk - k.sigma * gxe_old;
    const T gy_evenk = -k.sigma * gye_old;
    const T gx_oddk = -gx_mid - k.delta * gx_evenk;
    const T gy_oddk = uk - gy_mid - k.delta * gy_evenk;
    const T gx_odd = k.is1 ? vk : gx_evenk;
    const T gx_even = k.is1 ? -k.delta * vk : gx_oddk;
    const T gy_odd = k.is1 ? T(0) : gy_evenk;
    const T gy_even = k.is1 ? uk : gy_oddk;
    gxo[i] = gx_odd;
    gxe[i] = gx_even;
    gyo[i] = gy_odd;
    gye[i] = gy_even;
    T* x = row(work, X, n);
    T* y = row(work, Y, n);
    x[i] = x[i] + k.pi_odd * gx_odd + k.pi_even * gx_even;
    y[i] = y[i] + k.pi_odd * gy_odd + k.pi_even * gy_even;
  }
};

}  // namespace

KTT_SSY_INIT(ktt_tricg_dia_init_f32, float, Tricg)
KTT_SSY_INIT(ktt_tricg_dia_init_f64, double, Tricg)
KTT_SSY_ITERATE(ktt_tricg_dia_iterate_f32_f32, float, float, Tricg)
KTT_SSY_ITERATE(ktt_tricg_dia_iterate_f32_bf16, float, __nv_bfloat16, Tricg)
KTT_SSY_ITERATE(ktt_tricg_dia_iterate_f32_f16, float, __half, Tricg)
KTT_SSY_ITERATE(ktt_tricg_dia_iterate_f64_f64, double, double, Tricg)
