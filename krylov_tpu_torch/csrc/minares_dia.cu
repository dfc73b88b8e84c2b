// Whole MINARES solve of (A + lam I) x = b for a DIA matrix on Hopper
// (sm_90a), with no grid-wide barrier.
//
// Replaces the TPU kernel krylov_tpu/ops/pallas_fused.py:4217
// minares_dia_fused and computes what it computes (pallas_fused.py:
// 4248-4485): the normalised Lanczos stream of A + lam I one step ahead
// of the iteration, stopped at its breakdown (beta_{k+2} <= eps^(3/4)
// sets ell, and only iterations it <= ell - 1 continue it) while the
// iteration goes on, the QR-within-QR reflection cascade (six sym_givens
// per iteration, branch for branch as krylov_tpu/ops/kops.py:161-198,
// with the iter == 1 / 2 / >= 3 selects), the W and D direction
// recurrences, the pi/tau residual estimates, and x, niter, rNorm,
// ArNorm and the status code (0 running, 2 zero residual, 7 breakdown,
// 37 solved).
//
// Bound on an H100 SXM: memory bandwidth.  An iteration applies the
// stencil once (pd, 28 B per row in f32 for the 7-point stencil), must
// read v_k and v_{k+1} and write the next v (12 B), read and write x
// (8 B), and read two W and two D columns and write one of each (24 B):
// 72 B per row, 151 MB at 128^3, so at least 45 us per iteration at
// 3.35 TB/s.
//
// Design.  An iteration is five launches on the caller's stream, with no
// block waiting on another:
//   1. mna_stencil (grid)     q = (A + lam I) v_{k+1} - beta_{k+1} v_k into
//                             the next Lanczos buffer, partials of
//                             q'v_{k+1}; skipped once the Lanczos process
//                             has stopped (the device flag it <= ell - 1,
//                             which is not the stop flag)
//   2. mna_alpha   (1 block)  GO, LAN, alpha_{k+1}
//   3. mna_lanczos (grid)     q -= alpha_{k+1} v_{k+1} in place, partials
//                             of q'q
//   4. mna_scalars (1 block)  beta_{k+2}, ell, the reflection cascade, the
//                             tau and pi recurrences, rNorm, ArNorm, the
//                             tests, status, it
//   5. mna_update  (grid)     v_{k+2} = q / beta_{k+2} in place, w_k, d_k
//                             and x += zeta_k d_k
// The init applies the stencil once (pallas_fused.py:4275), so it is
// eight launches.  The three Lanczos vectors rotate through three
// buffers by it mod 3 (v_k in V[it % 3], v_{k+1} in V[(it + 1) % 3], q
// in V[(it + 2) % 3]), so the launch that reads v_{k+1}'s halo writes
// only the buffer of the vector before v_k.  W and D are rings of three
// columns each (w_k into W[k % 3], over w_{k-3}): the unified formulas
// w = (v - gamma w_{k-1} - eps w_{k-2}) / l and d = (w - phi d_{k-1} -
// rho d_{k-2}) / mu equal the TPU kernel's selects because the columns
// and scalars they read are zero before they activate, and launch 5
// reads and writes them row by row, never through a halo.  A launch
// after the stop writes nothing; every launch returns at once when the
// solve has stopped, and the host reads the status once per chunk of
// iterations.  Reductions are two-level in a fixed order.  Per
// iteration this design moves (28 + 12) + 12 + 44 B per row in f32:
// 96 B.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kReduceThreads = 1024;

constexpr int RUNNING = 0;
constexpr int ZERO_RESIDUAL = 2;
constexpr int BREAKDOWN = 7;
constexpr int SOLVED_ARTOL = 37;

// slots of the scalar array; ATOL .. BTOL (the breakdown tolerance
// eps^(3/4)) are set by the host.  U_BETA .. U_ZETA carry launch 4's
// results to launch 5.
enum ScalarSlot {
  ATOL = 0, RTOL, ARTOL, LAM, BTOL, EPS_LIM, KAPPA, BETA1, ALPHA_K, BETA_K,
  BETA_KP1, GAMMA_KM1, LAMBDABAR_K, GAMMABAR_K, EPS_KM2, EPS_KM1, XI_KM1,
  TAU_KM2, TAU_KM1, TAU_K, THETABAR_KM2, PSIBIS_KM2, PSIBAR_KM1, PI_KM2,
  PI_KM1, CHIBAR_K, ZETABIS_K, ZETABAR_KP1, CT4, ST4, CT3, ST3, CT2, ST2,
  RNORM, ARNORM, ALPHA_N, U_BETA, U_GAM, U_EPS, U_LK, U_PHI, U_RHO, U_MU,
  U_ZETA, NSC
};
// LAN: this iteration continues the Lanczos process; NORM: launch 5
// normalises the new Lanczos vector
enum IntSlot { IT = 0, STATUS, GO, LAN, ROT, ELL, NORM, NST };
// rows of the vector workspace: x, the W and D rings, the Lanczos buffers
enum Vec { VX = 0, VW0, VD0 = VW0 + 3, VL0 = VD0 + 3, NVEC = VL0 + 3 };

template <typename T>
__device__ __forceinline__ T* ring(T* work, int first, int slot,
                                   long long n) {
  return work + static_cast<long long>(first + slot % 3) * n;
}

using ktt::safe;
using ktt::sym_givens;

// Partials of b'b.
template <typename T>
__global__ void __launch_bounds__(kThreads)
mna_init_norm(const T* __restrict__ b, T* __restrict__ partial,
              long long n) {
  T s = T(0);
  for (long long i = ktt::first_row(); i < n; i += ktt::row_stride()) {
    s += b[i] * b[i];
  }
  ktt::store_partial(s, partial);
}

// beta1 and eps_lim.
template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
mna_init_beta1(const T* __restrict__ partial, int nparts, T* sc) {
  const T bb = ktt::sum_partials(partial, nparts);
  if (threadIdx.x != 0) return;
  const T beta1 = sqrt(bb);
  sc[BETA1] = beta1;
  sc[EPS_LIM] = sc[ATOL] + sc[RTOL] * beta1;
}

// v_1 = b / beta1 into V[0].
template <typename T>
__global__ void __launch_bounds__(kThreads)
mna_init_vectors(const T* __restrict__ b, T* work, const T* sc,
                 long long n) {
  const T s1 = safe(sc[BETA1]);
  T* __restrict__ v = ring(work, VL0, 0, n);
  for (long long i = ktt::first_row(); i < n; i += ktt::row_stride()) {
    v[i] = b[i] / s1;
  }
}

// q = (A + lam I) v_1 into V[1], partials of v_1'q.
template <typename T, typename P>
__global__ void __launch_bounds__(kThreads)
mna_init_stencil(const P* __restrict__ pd,
                 const long long* __restrict__ offsets, int nd, T* work,
                 T* __restrict__ partial, const T* sc, long long n) {
  const T lam = sc[LAM];
  const T* __restrict__ v = ring(work, VL0, 0, n);
  T* __restrict__ q = ring(work, VL0, 1, n);
  T s = T(0);
  for (long long i = ktt::first_row(); i < n; i += ktt::row_stride()) {
    const T vi = v[i];
    const T qi = ktt::stencil_row(pd, offsets, nd, v, i, n) + lam * vi;
    q[i] = qi;
    s += vi * qi;
  }
  ktt::store_partial(s, partial);
}

// alpha_1.
template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
mna_init_alpha(const T* __restrict__ partial, int nparts, T* sc) {
  const T alpha = ktt::sum_partials(partial, nparts);
  if (threadIdx.x == 0) sc[ALPHA_K] = alpha;
}

// q -= alpha_1 v_1 in V[1], partials of q'q.
template <typename T>
__global__ void __launch_bounds__(kThreads)
mna_init_lanczos(T* work, T* __restrict__ partial, const T* sc,
                 long long n) {
  const T alpha = sc[ALPHA_K];
  const T* __restrict__ v = ring(work, VL0, 0, n);
  T* __restrict__ q = ring(work, VL0, 1, n);
  T s = T(0);
  for (long long i = ktt::first_row(); i < n; i += ktt::row_stride()) {
    const T qi = q[i] - alpha * v[i];
    q[i] = qi;
    s += qi * qi;
  }
  ktt::store_partial(s, partial);
}

// beta2, ArNorm_0, kappa, the starting scalars and status
// (pallas_fused.py:4280-4297).
template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
mna_init_scalars(const T* __restrict__ partial, int nparts, T* sc, int* st,
                 int itmax) {
  const T qq = ktt::sum_partials(partial, nparts);
  if (threadIdx.x != 0) return;
  const T beta2 = sqrt(qq);
  const T beta1 = sc[BETA1];
  const T alpha1 = sc[ALPHA_K];
  const T b1a1 = beta1 * alpha1;
  const T b1b2 = beta1 * beta2;
  const T arnorm0 = sqrt(b1a1 * b1a1 + b1b2 * b1b2);
  const T kappa = sc[ATOL] + sc[ARTOL] * arnorm0;
  for (int k = BETA_K; k < NSC; ++k) sc[k] = T(0);
  sc[KAPPA] = kappa;
  sc[BETA_K] = beta1;
  sc[BETA_KP1] = beta2;
  sc[ZETABIS_K] = b1a1;
  sc[ZETABAR_KP1] = b1b2;
  sc[RNORM] = beta1;
  sc[ARNORM] = arnorm0;
  sc[U_BETA] = beta2;
  st[IT] = 0;
  st[STATUS] = beta1 == T(0) ? ZERO_RESIDUAL
               : ((beta1 <= sc[EPS_LIM] || arnorm0 <= kappa) ? SOLVED_ARTOL
                                                            : RUNNING);
  st[GO] = 0;
  st[LAN] = 0;
  st[ROT] = 0;
  st[ELL] = itmax + 2;
  st[NORM] = beta2 != T(0) ? 1 : 0;
}

// v_2 = q / beta2 in place, where beta2 != 0.
template <typename T>
__global__ void __launch_bounds__(kThreads)
mna_init_update(T* work, const T* sc, const int* st, long long n) {
  if (!st[NORM]) return;
  T* __restrict__ q = ring(work, VL0, 1, n);
  const T beta = sc[U_BETA];
  for (long long i = ktt::first_row(); i < n; i += ktt::row_stride()) {
    q[i] = q[i] / beta;
  }
}

__device__ __forceinline__ bool running(const int* st, int cap) {
  return st[STATUS] == RUNNING && st[IT] < cap;
}

// Whether the iteration after `it` continues the Lanczos process.
__device__ __forceinline__ bool lanczos_on(const int* st) {
  return st[IT] + 1 <= st[ELL] - 1;
}

// 1. q = (A + lam I) v_{k+1} - beta_{k+1} v_k into V[(it + 2) % 3],
// partials of q'v_{k+1}.  Reads the status, it and ell that the previous
// iteration's mna_scalars wrote.
template <typename T, typename P>
__global__ void __launch_bounds__(kThreads)
mna_stencil(const P* __restrict__ pd, const long long* __restrict__ offsets,
            int nd, T* work, T* __restrict__ partial, const T* sc,
            const int* st, long long n, int cap) {
  if (!running(st, cap) || !lanczos_on(st)) return;
  const int it = st[IT];
  const T* __restrict__ vk = ring(work, VL0, it, n);
  const T* __restrict__ vkp1 = ring(work, VL0, it + 1, n);
  T* __restrict__ q = ring(work, VL0, it + 2, n);
  const T lam = sc[LAM];
  const T beta = sc[BETA_KP1];
  T acc = T(0);
  for (long long i = ktt::first_row(); i < n; i += ktt::row_stride()) {
    const T vi = vkp1[i];
    const T qi =
        ktt::stencil_row(pd, offsets, nd, vkp1, i, n) + lam * vi - beta * vk[i];
    q[i] = qi;
    acc += qi * vi;
  }
  ktt::store_partial(acc, partial);
}

// 2. Decide whether this iteration runs (GO) and continues the Lanczos
// process (LAN), then alpha_{k+1}.
template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
mna_alpha(const T* __restrict__ partial, int nparts, T* sc, int* st,
          int cap) {
  const bool go = running(st, cap);
  const bool lan = go && lanczos_on(st);
  if (!lan) {
    if (threadIdx.x == 0) {
      st[GO] = go ? 1 : 0;
      st[LAN] = 0;
      st[ROT] = st[IT];
    }
    return;
  }
  const T alpha = ktt::sum_partials(partial, nparts);
  if (threadIdx.x != 0) return;
  sc[ALPHA_N] = alpha;
  st[GO] = 1;
  st[LAN] = 1;
  st[ROT] = st[IT];
}

// 3. q -= alpha_{k+1} v_{k+1} in place, partials of q'q.
template <typename T>
__global__ void __launch_bounds__(kThreads)
mna_lanczos(T* work, T* __restrict__ partial, const T* sc, const int* st,
            long long n) {
  if (!st[LAN]) return;
  const int r = st[ROT];
  const T* __restrict__ vkp1 = ring(work, VL0, r + 1, n);
  T* __restrict__ q = ring(work, VL0, r + 2, n);
  const T alpha = sc[ALPHA_N];
  T s = T(0);
  for (long long i = ktt::first_row(); i < n; i += ktt::row_stride()) {
    const T qi = q[i] - alpha * vkp1[i];
    q[i] = qi;
    s += qi * qi;
  }
  ktt::store_partial(s, partial);
}

// 4. beta_{k+2}, ell and the scalar recurrences of pallas_fused.py:
// 4310-4451 (in that order), the tests and the status; the coefficients
// of launch 5.
template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
mna_scalars(const T* __restrict__ partial, int nparts, T* sc, int* st) {
  if (!st[GO]) return;
  const bool lan = st[LAN] != 0;
  T qq = T(0);
  if (lan) qq = ktt::sum_partials(partial, nparts);
  if (threadIdx.x != 0) return;
  const T one = T(1);
  const T zero = T(0);
  const int it = st[ROT] + 1;
  const bool is1 = it == 1, is2 = it == 2, ge2 = it >= 2, ge3 = it >= 3;

  const T alpha_k = sc[ALPHA_K], beta_k = sc[BETA_K];
  const T beta_kp1 = sc[BETA_KP1];
  const T gamma_km1 = sc[GAMMA_KM1], eps_km2 = sc[EPS_KM2];
  const T eps_km1 = sc[EPS_KM1], xi_km1 = sc[XI_KM1];
  const T tau_km2_o = sc[TAU_KM2], tau_km1_o = sc[TAU_KM1];
  const T tau_k_o = sc[TAU_K];
  const T thetabar_km2 = sc[THETABAR_KM2], psibis_km2 = sc[PSIBIS_KM2];
  const T psibar_km1 = sc[PSIBAR_KM1];
  const T pi_km2_o = sc[PI_KM2], pi_km1 = sc[PI_KM1];
  const T zetabis_k = sc[ZETABIS_K], zetabar_kp1 = sc[ZETABAR_KP1];
  const T ct4 = sc[CT4], st4 = sc[ST4], ct3 = sc[CT3], st3 = sc[ST3];
  const T ct2 = sc[CT2], st2 = sc[ST2];

  const T lambdabar_k = is1 ? alpha_k : sc[LAMBDABAR_K];
  const T gammabar_k = is1 ? beta_kp1 : sc[GAMMABAR_K];
  const T chibar_k = is1 ? beta_k : sc[CHIBAR_K];
  T ck, sk, l_k;
  sym_givens(lambdabar_k, beta_kp1, ck, sk, l_k);

  // the Lanczos process, continued while it <= ell - 1
  const T alpha_kp1 = lan ? sc[ALPHA_N] : alpha_k;
  const T beta_kp2 = lan ? sqrt(qq) : zero;
  const bool brk = beta_kp2 <= sc[BTOL];
  const int ell = (lan && brk) ? it + 1 : st[ELL];

  // Q_{k,k+1}, gated on ell
  const bool two_ok = it <= ell - 2;
  const bool one_ok = it <= ell - 1;
  const T eps_k = two_ok ? sk * beta_kp2 : zero;
  const T gammabar_kp1 = two_ok ? -ck * beta_kp2 : zero;
  const T gamma_k = one_ok ? ck * gammabar_k + sk * alpha_kp1 : zero;
  const T lambdabar_kp1 = one_ok ? sk * gammabar_k - ck * alpha_kp1 : zero;

  // the QR of N_k: previous reflections
  const T rho_km2 = ge3 ? st4 * l_k : zero;
  const T lhat_k = ge3 ? -ct4 * l_k : (is2 ? l_k : zero);
  const T phibar_km1 = ge2 ? st3 * lhat_k : zero;
  const T mubar_k = ge2 ? -ct3 * lhat_k : l_k;
  const T phi_km1 =
      ge2 ? (one_ok ? ct2 * phibar_km1 + st2 * gamma_k : phibar_km1) : zero;
  const T ghat_k =
      ge2 ? (one_ok ? st2 * phibar_km1 - ct2 * gamma_k : zero) : gamma_k;
  T ct1n, st1n, mubis_g, ct0n, st0n, mu_g;
  sym_givens(mubar_k, ghat_k, ct1n, st1n, mubis_g);
  const T ct1 = one_ok ? ct1n : one;
  const T st1 = one_ok ? st1n : zero;
  const T mubis_k = one_ok ? mubis_g : mubar_k;
  sym_givens(mubis_k, eps_k, ct0n, st0n, mu_g);
  const T ct0 = two_ok ? ct0n : one;
  const T st0 = two_ok ? st0n : zero;
  const T mu_k = two_ok ? mu_g : mubis_k;

  // the z_k updates
  const T zring = one_ok ? ct1 * zetabis_k + st1 * zetabar_kp1 : zetabis_k;
  const T zetabis_kp1 = one_ok ? st1 * zetabis_k - ct1 * zetabar_kp1 : zero;
  const T zeta_k = two_ok ? ct0 * zring : zring;
  const T zetabar_kp2 = two_ok ? st0 * zring : zero;
  const T arnorm =
      two_ok ? sqrt(zetabis_kp1 * zetabis_kp1 + zetabar_kp2 * zetabar_kp2)
             : (it == ell - 1 ? fabs(zetabis_kp1) : zero);

  // the LQ of U_k
  T chm3_2, shm3_2, psibis2, chm4, shm4, psi_km2, chm3_3, shm3_3, psibis3;
  sym_givens(psibar_km1, phi_km1, chm3_2, shm3_2, psibis2);
  sym_givens(psibis_km2, rho_km2, chm4, shm4, psi_km2);
  const T theta_km2 = chm4 * thetabar_km2 + shm4 * phi_km1;
  const T delta_k = shm4 * thetabar_km2 - chm4 * phi_km1;
  const T omega_km2 = shm4 * mu_k;
  const T eta_k = -chm4 * mu_k;
  sym_givens(psibar_km1, delta_k, chm3_3, shm3_3, psibis3);
  const T psibar_k = is1 ? mu_k : (is2 ? -chm3_2 * mu_k : -chm3_3 * eta_k);
  const T thetabar_km1 =
      is2 ? shm3_2 * mu_k : (ge3 ? shm3_3 * eta_k : zero);
  const T psibis_km1 = is2 ? psibis2 : (ge3 ? psibis3 : zero);

  // solve L_k t_k = z_k
  const T tau_km2 = ge3 ? tau_km1_o * psibis_km2 / safe(psi_km2) : tau_km2_o;
  const T tau_km1 =
      is2 ? tau_k_o * psibar_km1 / safe(psibis2)
          : (ge3 ? (xi_km1 - theta_km2 * tau_km2) / safe(psibis3)
                 : tau_km1_o);
  const T xi_k = ge3 ? zeta_k - omega_km2 * tau_km2 : zeta_k;
  const T tau_k = is1 ? zeta_k / safe(psibar_k)
                      : (xi_k - thetabar_km1 * tau_km1) / safe(psibar_k);

  // (Q_k)' beta1 e1 and the pi updates
  const T chi_k = ck * chibar_k;
  const T chibar_kp1 = sk * chibar_k;
  const T pi3a_k = shm4 * pi_km2_o - chm4 * chi_k;
  const T pi_km1_mid =
      is2 ? chm3_2 * pi_km1 + shm3_2 * chi_k
          : (ge3 ? chm3_3 * pi_km1 + shm3_3 * pi3a_k : pi_km1);
  const T pi_k = is1 ? chi_k
                     : (is2 ? shm3_2 * pi_km1 - chm3_2 * chi_k
                            : shm3_3 * pi_km1 - chm3_3 * pi3a_k);
  const T pi_km2 = ge3 ? chm4 * pi_km2_o + shm4 * chi_k : pi_km2_o;
  const T d1 = pi_k - tau_k;
  const T d2 = pi_km1_mid - tau_km1;
  const T rnorm = is1 ? sqrt(d1 * d1 + chibar_kp1 * chibar_kp1)
                      : sqrt(d2 * d2 + d1 * d1 + chibar_kp1 * chibar_kp1);

  const bool solved = rnorm <= sc[EPS_LIM] || arnorm <= sc[KAPPA];
  const bool breakdown = beta_kp1 <= sc[BTOL];

  // launch 5's coefficients
  sc[U_BETA] = beta_kp2;
  sc[U_GAM] = gamma_km1;
  sc[U_EPS] = eps_km2;
  sc[U_LK] = safe(l_k);
  sc[U_PHI] = phi_km1;
  sc[U_RHO] = rho_km2;
  sc[U_MU] = safe(mu_k);
  sc[U_ZETA] = zeta_k;
  st[NORM] = (lan && !brk) ? 1 : 0;

  if (one_ok) {
    sc[ALPHA_K] = alpha_kp1;
    sc[BETA_KP1] = beta_kp2;
    sc[GAMMA_KM1] = gamma_k;
    sc[LAMBDABAR_K] = lambdabar_kp1;
    sc[ZETABIS_K] = zetabis_kp1;
  } else {
    sc[LAMBDABAR_K] = lambdabar_k;
  }
  sc[BETA_K] = beta_kp1;
  if (two_ok) {
    sc[GAMMABAR_K] = gammabar_kp1;
    sc[EPS_KM1] = eps_k;
    sc[ZETABAR_KP1] = zetabar_kp2;
  } else {
    sc[GAMMABAR_K] = gammabar_k;
  }
  if (ge2) {
    sc[EPS_KM2] = eps_km1;
    sc[THETABAR_KM2] = thetabar_km1;
    sc[PSIBIS_KM2] = psibis_km1;
    sc[PI_KM2] = pi_km1_mid;
    sc[CT4] = ct2;
    sc[ST4] = st2;
  } else {
    sc[PI_KM2] = pi_km2;
  }
  sc[XI_KM1] = xi_k;
  sc[TAU_KM2] = tau_km2;
  sc[TAU_KM1] = tau_km1;
  sc[TAU_K] = tau_k;
  sc[PSIBAR_KM1] = psibar_k;
  sc[PI_KM1] = pi_k;
  sc[CHIBAR_K] = chibar_kp1;
  sc[CT3] = ct1;
  sc[ST3] = st1;
  sc[CT2] = ct0;
  sc[ST2] = st0;
  sc[RNORM] = rnorm;
  sc[ARNORM] = arnorm;
  st[ELL] = ell;
  st[IT] = it;
  st[STATUS] = solved ? SOLVED_ARTOL : (breakdown ? BREAKDOWN : RUNNING);
}

// 5. v_{k+2} = q / beta_{k+2} in place (while the Lanczos process runs
// and has not broken down), w_k, d_k and x += zeta_k d_k, row by row.
template <typename T>
__global__ void __launch_bounds__(kThreads)
mna_update(T* work, const T* sc, const int* st, long long n) {
  if (!st[GO]) return;
  const int r = st[ROT];
  const int it = r + 1;
  const T* __restrict__ vk = ring(work, VL0, r, n);
  T* __restrict__ q = ring(work, VL0, r + 2, n);
  const T* __restrict__ wkm1 = ring(work, VW0, it + 2, n);
  const T* __restrict__ wkm2 = ring(work, VW0, it + 1, n);
  T* __restrict__ wk = ring(work, VW0, it, n);
  const T* __restrict__ dkm1 = ring(work, VD0, it + 2, n);
  const T* __restrict__ dkm2 = ring(work, VD0, it + 1, n);
  T* __restrict__ dk = ring(work, VD0, it, n);
  T* __restrict__ x = work + VX * n;
  const bool norm = st[NORM] != 0;
  const T beta = sc[U_BETA];
  const T gam = sc[U_GAM], eps = sc[U_EPS], lk = sc[U_LK];
  const T phi = sc[U_PHI], rho = sc[U_RHO], mu = sc[U_MU];
  const T zeta = sc[U_ZETA];
  for (long long i = ktt::first_row(); i < n; i += ktt::row_stride()) {
    if (norm) q[i] = q[i] / beta;
    const T w = (vk[i] - gam * wkm1[i] - eps * wkm2[i]) / lk;
    wk[i] = w;
    const T d = (w - phi * dkm1[i] - rho * dkm2[i]) / mu;
    dk[i] = d;
    x[i] = x[i] + zeta * d;
  }
}

template <typename T, typename P>
int init(const void* pd, const void* offsets, int nd, const void* b_,
         void* work_, void* partial_, void* sc_, void* st_, long long n,
         int grid, int itmax, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const P* A = static_cast<const P*>(pd);
  const long long* offs = static_cast<const long long*>(offsets);
  const T* b = static_cast<const T*>(b_);
  T* work = static_cast<T*>(work_);
  T* partial = static_cast<T*>(partial_);
  T* sc = static_cast<T*>(sc_);
  int* st = static_cast<int*>(st_);
  mna_init_norm<T><<<grid, kThreads, 0, s>>>(b, partial, n);
  mna_init_beta1<T><<<1, kReduceThreads, 0, s>>>(partial, grid, sc);
  mna_init_vectors<T><<<grid, kThreads, 0, s>>>(b, work, sc, n);
  mna_init_stencil<T, P><<<grid, kThreads, 0, s>>>(A, offs, nd, work,
                                                   partial, sc, n);
  mna_init_alpha<T><<<1, kReduceThreads, 0, s>>>(partial, grid, sc);
  mna_init_lanczos<T><<<grid, kThreads, 0, s>>>(work, partial, sc, n);
  mna_init_scalars<T><<<1, kReduceThreads, 0, s>>>(partial, grid, sc, st,
                                                   itmax);
  mna_init_update<T><<<grid, kThreads, 0, s>>>(work, sc, st, n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename P>
int iterate(const void* pd, const void* offsets, int nd, void* work_,
            void* partial_, void* sc_, void* st_, long long n, int grid,
            int iters, int cap, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const P* A = static_cast<const P*>(pd);
  const long long* offs = static_cast<const long long*>(offsets);
  T* work = static_cast<T*>(work_);
  T* partial = static_cast<T*>(partial_);
  T* sc = static_cast<T*>(sc_);
  int* st = static_cast<int*>(st_);
  for (int k = 0; k < iters; ++k) {
    mna_stencil<T, P><<<grid, kThreads, 0, s>>>(A, offs, nd, work, partial,
                                                sc, st, n, cap);
    mna_alpha<T><<<1, kReduceThreads, 0, s>>>(partial, grid, sc, st, cap);
    mna_lanczos<T><<<grid, kThreads, 0, s>>>(work, partial, sc, st, n);
    mna_scalars<T><<<1, kReduceThreads, 0, s>>>(partial, grid, sc, st);
    mna_update<T><<<grid, kThreads, 0, s>>>(work, sc, st, n);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define KTT_MINARES(INIT, ITERATE, T, P)                                     \
  extern "C" int INIT(const void* pd, const void* offsets, int nd,           \
                      const void* b, void* work, void* partial, void* sc,    \
                      void* st, long long n, int grid, int itmax,            \
                      void* stream) {                                        \
    return init<T, P>(pd, offsets, nd, b, work, partial, sc, st, n, grid,    \
                      itmax, stream);                                        \
  }                                                                          \
  extern "C" int ITERATE(const void* pd, const void* offsets, int nd,        \
                         void* work, void* partial, void* sc, void* st,      \
                         long long n, int grid, int iters, int cap,          \
                         void* stream) {                                     \
    return iterate<T, P>(pd, offsets, nd, work, partial, sc, st, n, grid,    \
                         iters, cap, stream);                                \
  }

KTT_MINARES(ktt_minares_dia_init_f32_f32, ktt_minares_dia_iterate_f32_f32,
            float, float)
KTT_MINARES(ktt_minares_dia_init_f32_bf16, ktt_minares_dia_iterate_f32_bf16,
            float, __nv_bfloat16)
KTT_MINARES(ktt_minares_dia_init_f32_f16, ktt_minares_dia_iterate_f32_f16,
            float, __half)
KTT_MINARES(ktt_minares_dia_init_f64_f64, ktt_minares_dia_iterate_f64_f64,
            double, double)
