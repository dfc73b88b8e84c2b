// Whole MINRES-QLP solve of (A + lam I) x = b for a DIA matrix, M = I, on
// Hopper (sm_90a), with no grid-wide barrier.
//
// Replaces the TPU kernel krylov_tpu/ops/pallas_fused.py:3935
// minres_qlp_dia_fused and computes what it computes (pallas_fused.py:
// 3966-4160): the normalised Lanczos stream of A + lam I, the QR
// rotation of the tridiagonal and the LQ rotations of R (sym_givens,
// branch for branch as krylov_tpu/ops/kops.py:161-198) with the iter ==
// 1 / 2 / >= 3 selects, the three-term direction recurrences of W, the
// mumin/mumax condition estimate, the Artol inconsistency test, the
// final correction x += tau_{k-1} w_{k-1} + tau_k w_k (tau_k dropped when
// the system was found inconsistent), and x, niter, rNorm, ArNorm, the
// status code (0 running, 1 solved, 2 zero residual, 20 least-squares
// solution, 21 zero-residual solution, 23 ill-conditioned for the
// machine) and the inconsistent flag.  The status overrides come in the
// order of pallas_fused.py:4136-4140.
//
// Bound on an H100 SXM: memory bandwidth.  An iteration applies the
// stencil once (pd, 28 B per row in f32 for the 7-point stencil), must
// read v and v_{k-1} and write the next v (12 B), and read and write x,
// w_{k-1} and w_k (24 B): 64 B per row, 134 MB at 128^3, so at least
// 40 us per iteration at 3.35 TB/s.
//
// Design.  The Lanczos step has two gating reductions (alpha = v'p
// before p is orthogonalised, |p| before the rotations), and the
// backward-error test needs |x| after x is updated, so an iteration is
// six launches on the caller's stream, with no block waiting on another:
//   1. qlp_stencil (grid)     p = (A + lam I) v - beta v_{k-1} into the
//                             next Lanczos buffer, partials of v'p
//   2. qlp_alpha   (1 block)  GO, alpha
//   3. qlp_lanczos (grid)     p -= alpha v in place, partials of p'p
//   4. qlp_scalars (1 block)  beta_{k+1}, the QR and LQ rotations, the
//                             tau recurrence, mumin/mumax, ArNorm, kappa
//                             and every test but the backward one
//   5. qlp_update  (grid)     v_{k+1} = p / beta_{k+1} in place, the W
//                             rotation, x += tau_{k-2} (c w_{k-1} + s v),
//                             partials of x'x
//   6. qlp_tests   (1 block)  |x|, the backward test, status, it
// The TPU kernel overwrites v in place while the next stencil reads its
// neighbours; here the three Lanczos vectors rotate through three
// buffers by it mod 3 (v in V[it % 3], v_{k-1} in V[(it + 2) % 3], p in
// V[(it + 1) % 3]), so the launch that reads v's halo writes only the
// buffer that held the vector before v_{k-1}.  x, w_{k-1} and w_k stay
// in fixed buffers and are read and written row by row in launch 5
// only, never through a halo.  The final correction is one finishing
// launch after the host's loop.  A launch after the stop writes nothing,
// so the rotation never runs ahead of it; every launch returns at once
// when the solve has stopped, and the host reads the status once per
// chunk of iterations.  Reductions are two-level in a fixed order.  Per
// iteration this design moves (28 + 12) + 12 + 36 B per row in f32: 88 B.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kReduceThreads = 1024;

constexpr int RUNNING = 0;
constexpr int SOLVED = 1;
constexpr int ZERO_RESIDUAL = 2;
constexpr int SOLVED_LSQ = 20;
constexpr int SOLVED_ZERO = 21;
constexpr int ILL_COND_MACH = 23;

// slots of the scalar array; ATOL .. BTOL (the breakdown tolerance
// eps^(3/4)) are set by the host.  CP .. XADD carry launch 4's results
// to launch 5.
enum ScalarSlot {
  ATOL = 0, RTOL, ARTOL, LAM, BTOL, EPS_LIM, ALPHA, BETA_K, ZETABAR, XI_KM1,
  TAU_KM2, TAU_KM1, TAU_K, PSIBAR_KM2, MUBIS_KM2, MUBAR_KM1, C_KM2, C_KM1,
  S_KM2, S_KM1, MUMIN, MUMAX, ANORM2, RNORM, ARNORM, KAPPA, CP, SP, CD, SD,
  XADD, NSC
};
// FLAGS holds launch 4's tests for launch 6
enum IntSlot { IT = 0, STATUS, INCON, GO, ROT, FLAGS, NST };
enum Flag { F_ILL_COND = 1, F_INCON = 2, F_BREAKDOWN = 4, F_RESID = 8 };
// rows of the vector workspace: x, w_{k-1}, w_k and the Lanczos buffers
enum Vec { VX = 0, VWKM1, VWK, VL0, NVEC = VL0 + 3 };

template <typename T>
__device__ __forceinline__ T* lanczos(T* work, int slot, long long n) {
  return work + static_cast<long long>(VL0 + slot % 3) * n;
}

using ktt::safe;
using ktt::sym_givens;

// Partials of b'b.
template <typename T>
__global__ void __launch_bounds__(kThreads)
qlp_init_norm(const T* __restrict__ b, T* __restrict__ partial,
              long long n) {
  T s = T(0);
  for (long long i = ktt::first_row(); i < n; i += ktt::row_stride()) {
    s += b[i] * b[i];
  }
  ktt::store_partial(s, partial);
}

// beta1, eps_lim, the starting scalars and status (pallas_fused.py:
// 3982-4000).
template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
qlp_init_scalars(const T* __restrict__ partial, int nparts, T* sc, int* st) {
  const T bb = ktt::sum_partials(partial, nparts);
  if (threadIdx.x != 0) return;
  const T beta1 = sqrt(bb);
  const T eps_lim = sc[ATOL] + sc[RTOL] * beta1;
  for (int k = EPS_LIM; k < NSC; ++k) sc[k] = T(0);
  sc[EPS_LIM] = eps_lim;
  sc[BETA_K] = beta1;
  sc[ZETABAR] = beta1;
  sc[RNORM] = beta1;
  sc[C_KM2] = T(1);
  sc[C_KM1] = T(1);
  st[IT] = 0;
  st[STATUS] = beta1 == T(0) ? ZERO_RESIDUAL
               : (beta1 <= eps_lim ? SOLVED : RUNNING);
  st[INCON] = 0;
  st[GO] = 0;
  st[ROT] = 0;
  st[FLAGS] = 0;
}

// v = b / beta1 into V[0].
template <typename T>
__global__ void __launch_bounds__(kThreads)
qlp_init_vectors(const T* __restrict__ b, T* work, const T* sc,
                 long long n) {
  const T s1 = safe(sc[BETA_K]);
  T* __restrict__ v = lanczos(work, 0, n);
  for (long long i = ktt::first_row(); i < n; i += ktt::row_stride()) {
    v[i] = b[i] / s1;
  }
}

// 1. p = (A + lam I) v - beta_k v_{k-1} into V[(it + 1) % 3], partials
// of v'p.  Reads the status and it that the previous iteration's
// qlp_tests wrote; v_{k-1} is the zeroed V[2] in the first iteration.
template <typename T, typename P>
__global__ void __launch_bounds__(kThreads)
qlp_stencil(const P* __restrict__ pd, const long long* __restrict__ offsets,
            int nd, T* work, T* __restrict__ partial, const T* sc,
            const int* st, long long n, int cap) {
  if (!(st[STATUS] == RUNNING && st[IT] < cap)) return;
  const int it = st[IT];
  const T* __restrict__ v = lanczos(work, it, n);
  const T* __restrict__ vkm1 = lanczos(work, it + 2, n);
  T* __restrict__ p = lanczos(work, it + 1, n);
  const T lam = sc[LAM];
  const T bk = it + 1 >= 2 ? sc[BETA_K] : T(0);
  T acc = T(0);
  for (long long i = ktt::first_row(); i < n; i += ktt::row_stride()) {
    const T vi = v[i];
    T pi = ktt::stencil_row(pd, offsets, nd, v, i, n) + lam * vi;
    pi = pi - bk * vkm1[i];
    p[i] = pi;
    acc += vi * pi;
  }
  ktt::store_partial(acc, partial);
}

// 2. Decide whether this iteration runs (GO), then alpha.
template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
qlp_alpha(const T* __restrict__ partial, int nparts, T* sc, int* st,
          int cap) {
  const bool go = st[STATUS] == RUNNING && st[IT] < cap;
  if (!go) {
    if (threadIdx.x == 0) st[GO] = 0;
    return;
  }
  const T alpha = ktt::sum_partials(partial, nparts);
  if (threadIdx.x != 0) return;
  sc[ALPHA] = alpha;
  st[ROT] = st[IT];
  st[GO] = 1;
}

// 3. p -= alpha v in place, partials of p'p.
template <typename T>
__global__ void __launch_bounds__(kThreads)
qlp_lanczos(T* work, T* __restrict__ partial, const T* sc, const int* st,
            long long n) {
  if (!st[GO]) return;
  const int r = st[ROT];
  const T* __restrict__ v = lanczos(work, r, n);
  T* __restrict__ p = lanczos(work, r + 1, n);
  const T alpha = sc[ALPHA];
  T s = T(0);
  for (long long i = ktt::first_row(); i < n; i += ktt::row_stride()) {
    const T pi = p[i] - alpha * v[i];
    p[i] = pi;
    s += pi * pi;
  }
  ktt::store_partial(s, partial);
}

// 4. beta_{k+1} and the scalar recurrences of pallas_fused.py:4027-4131
// (in that order), the tests that need no |x|, and the coefficients of
// launch 5.
template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
qlp_scalars(const T* __restrict__ partial, int nparts, T* sc, int* st) {
  if (!st[GO]) return;
  const T pp = ktt::sum_partials(partial, nparts);
  if (threadIdx.x != 0) return;
  const T tiny = ktt::tiny_of<T>();
  const T one = T(1);
  const T zero = T(0);
  const int it = st[ROT] + 1;
  const bool is1 = it == 1, is2 = it == 2, ge2 = it >= 2, ge3 = it >= 3;

  const T alpha = sc[ALPHA];
  const T beta_k = sc[BETA_K];
  const T zetabar = sc[ZETABAR];
  const T c_km2 = sc[C_KM2], c_km1 = sc[C_KM1];
  const T s_km2 = sc[S_KM2], s_km1 = sc[S_KM1];
  const T mubar_km1 = sc[MUBAR_KM1], mubis_km2 = sc[MUBIS_KM2];
  const T psibar_km2 = sc[PSIBAR_KM2];
  const T tau_km2_o = sc[TAU_KM2], tau_km1_o = sc[TAU_KM1];
  const T tau_k_o = sc[TAU_K], xi_km1 = sc[XI_KM1];

  const T beta_kp1 = sqrt(pp);
  const T anorm2 =
      sc[ANORM2] + alpha * alpha + beta_k * beta_k + beta_kp1 * beta_kp1;

  // the previous reflections
  const T eps_km2 = ge3 ? s_km2 * beta_k : zero;
  const T gbar_km1 = ge3 ? -c_km2 * beta_k : (is2 ? beta_k : zero);
  const T g_km1 = c_km1 * gbar_km1 + s_km1 * alpha;
  const T lbar_k = is1 ? alpha : s_km1 * gbar_km1 - c_km1 * alpha;
  T ck, sk, l_k;
  sym_givens(lbar_k, beta_kp1, ck, sk, l_k);
  const T zeta = ck * zetabar;
  const T zetabar_next = sk * zetabar;

  // the LQ update of R_k
  T cp2, sp2, mubis2, cp3, sp3, mu_km2, cd, sd, mubis3;
  sym_givens(mubar_km1, g_km1, cp2, sp2, mubis2);
  sym_givens(mubis_km2, eps_km2, cp3, sp3, mu_km2);
  const T psi_km2 = cp3 * psibar_km2 + sp3 * g_km1;
  const T theta_k = sp3 * psibar_km2 - cp3 * g_km1;
  const T rho_km2 = sp3 * l_k;
  const T eta_k = -cp3 * l_k;
  sym_givens(mubar_km1, theta_k, cd, sd, mubis3);
  const T mubar_k = is1 ? l_k : (is2 ? -cp2 * l_k : -cd * eta_k);
  const T psibar_km1 = is2 ? sp2 * l_k : (ge3 ? sd * eta_k : zero);
  const T mubis_km1 = is2 ? mubis2 : (ge3 ? mubis3 : zero);
  const T cp = is2 ? cp2 : cp3;
  const T sp = is2 ? sp2 : sp3;

  // solve L_k t_k = z_k
  const T tau_km2 = ge3 ? tau_km1_o * mubis_km2 / safe(mu_km2) : tau_km2_o;
  const T tau_km1 =
      is2 ? tau_k_o * mubar_km1 / safe(mubis2)
          : (ge3 ? (xi_km1 - psi_km2 * tau_km2) / safe(mubis3) : tau_km1_o);
  const T xi_k = ge3 ? zeta - rho_km2 * tau_km2 : zeta;
  const T tau_k = is1 ? zeta / safe(mubar_k)
                      : (xi_k - psibar_km1 * tau_km1) / safe(mubar_k);

  const T rnorm = fabs(zetabar_next);
  const T cb = c_km1 * beta_kp1;
  const T arnorm = fabs(zetabar) * sqrt(lbar_k * lbar_k + cb * cb);
  const T kappa = is1 ? sc[ATOL] + sc[ARTOL] * arnorm : sc[KAPPA];
  const T abs_mubar = fabs(mubar_k);
  const T lo = mubis_km1 < abs_mubar ? mubis_km1 : abs_mubar;
  const T hi = mubis_km1 > abs_mubar ? mubis_km1 : abs_mubar;
  T mumin = abs_mubar, mumax = abs_mubar;
  if (!is1) {
    const T lo3 = is2 ? lo : (mu_km2 < lo ? mu_km2 : lo);
    const T hi3 = is2 ? hi : (mu_km2 > hi ? mu_km2 : hi);
    mumin = sc[MUMIN] < lo3 ? sc[MUMIN] : lo3;
    mumax = sc[MUMAX] > hi3 ? sc[MUMAX] : hi3;
  }
  const T acond = mumax / (mumin > tiny ? mumin : tiny);
  const T acond_t = acond > tiny ? acond : tiny;

  int flags = 0;
  if ((one + one / acond_t) <= one) flags |= F_ILL_COND;
  if (arnorm <= kappa && abs_mubar <= sc[ARTOL]) flags |= F_INCON;
  if (beta_kp1 <= sc[BTOL]) flags |= F_BREAKDOWN;
  if ((one + rnorm) <= one || rnorm <= sc[EPS_LIM]) flags |= F_RESID;
  st[FLAGS] = flags;

  sc[BETA_K] = beta_kp1;
  sc[ZETABAR] = zetabar_next;
  sc[XI_KM1] = xi_k;
  sc[TAU_KM2] = tau_km2;
  sc[TAU_KM1] = tau_km1;
  sc[TAU_K] = tau_k;
  if (ge2) {
    sc[PSIBAR_KM2] = psibar_km1;
    sc[MUBIS_KM2] = mubis_km1;
    sc[C_KM2] = c_km1;
    sc[S_KM2] = s_km1;
  }
  sc[MUBAR_KM1] = mubar_k;
  sc[C_KM1] = ck;
  sc[S_KM1] = sk;
  sc[MUMIN] = mumin;
  sc[MUMAX] = mumax;
  sc[ANORM2] = anorm2;
  sc[RNORM] = rnorm;
  sc[ARNORM] = arnorm;
  sc[KAPPA] = kappa;
  sc[CP] = cp;
  sc[SP] = sp;
  sc[CD] = cd;
  sc[SD] = sd;
  sc[XADD] = ge3 ? tau_km2 : zero;
}

// 5. v_{k+1} = p / beta_{k+1} in place (p itself when beta_{k+1} <=
// eps^(3/4)), x += tau_{k-2} (cp w_{k-1} + sp v) and the W rotation of
// pallas_fused.py:4072-4087, row by row; partials of x'x.
template <typename T>
__global__ void __launch_bounds__(kThreads)
qlp_update(T* work, T* __restrict__ partial, const T* sc, const int* st,
           long long n) {
  if (!st[GO]) return;
  const int r = st[ROT];
  const int it = r + 1;
  const T* __restrict__ v = lanczos(work, r, n);
  T* __restrict__ p = lanczos(work, r + 1, n);
  T* __restrict__ x = work + VX * n;
  T* __restrict__ wkm1 = work + VWKM1 * n;
  T* __restrict__ wk = work + VWK * n;
  const T beta = sc[BETA_K];
  const bool norm_ok = beta > sc[BTOL];
  const T cp = sc[CP], sp = sc[SP], cd = sc[CD], sd = sc[SD];
  const T xa = sc[XADD] * cp;
  const T xb = sc[XADD] * sp;
  T acc = T(0);
  for (long long i = ktt::first_row(); i < n; i += ktt::row_stride()) {
    if (norm_ok) p[i] = p[i] / beta;
    const T vi = v[i];
    const T wm = wkm1[i];
    const T wc = wk[i];
    T xi = x[i];
    if (it == 1) {
      wk[i] = vi;
    } else if (it == 2) {
      wkm1[i] = cp * wc + sp * vi;
      wk[i] = sp * wc - cp * vi;
    } else {
      xi = xi + xa * wm + xb * vi;
      x[i] = xi;
      const T waux = sp * wm - cp * vi;
      wkm1[i] = cd * wc + sd * waux;
      wk[i] = sd * wc - cd * waux;
    }
    acc += xi * xi;
  }
  ktt::store_partial(acc, partial);
}

// 6. |x|, the backward test, the status chain (pallas_fused.py:
// 4118-4140) and it.
template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
qlp_tests(const T* __restrict__ partial, int nparts, const T* sc, int* st) {
  if (!st[GO]) return;
  const T xx = ktt::sum_partials(partial, nparts);
  if (threadIdx.x != 0) return;
  const T tiny = ktt::tiny_of<T>();
  const T one = T(1);
  const int flags = st[FLAGS];
  const T ax = sqrt(sc[ANORM2]) * sqrt(xx);
  const T backward = sc[RNORM] / (ax > tiny ? ax : tiny);
  const bool zero_resid =
      (one + backward) <= one || backward <= ktt::eps_of<T>();
  const bool solved = (flags & F_RESID) || zero_resid;
  const bool incon =
      (flags & F_INCON) || ((flags & F_BREAKDOWN) && !solved);
  int code = RUNNING;
  if (flags & F_ILL_COND) code = ILL_COND_MACH;
  if (incon) code = SOLVED_LSQ;
  if (zero_resid) code = SOLVED_ZERO;
  if (solved) code = SOLVED;
  st[IT] = st[IT] + 1;
  st[STATUS] = code;
  st[INCON] = incon ? 1 : 0;
}

// The final correction x += tau_{k-1} w_{k-1} + tau_k w_k after the last
// iteration (pallas_fused.py:4150-4158).
template <typename T>
__global__ void __launch_bounds__(kThreads)
qlp_finish(T* work, const T* sc, const int* st, long long n) {
  const int nit = st[IT];
  if (nit < 1) return;
  const T add1 = nit >= 2 ? sc[TAU_KM1] : T(0);
  const T add2 = st[INCON] == 0 ? sc[TAU_K] : T(0);
  T* __restrict__ x = work + VX * n;
  const T* __restrict__ wkm1 = work + VWKM1 * n;
  const T* __restrict__ wk = work + VWK * n;
  for (long long i = ktt::first_row(); i < n; i += ktt::row_stride()) {
    x[i] = x[i] + add1 * wkm1[i] + add2 * wk[i];
  }
}

template <typename T>
int init(const void* b_, void* work_, void* partial_, void* sc_, void* st_,
         long long n, int grid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* b = static_cast<const T*>(b_);
  T* work = static_cast<T*>(work_);
  T* partial = static_cast<T*>(partial_);
  T* sc = static_cast<T*>(sc_);
  qlp_init_norm<T><<<grid, kThreads, 0, s>>>(b, partial, n);
  qlp_init_scalars<T><<<1, kReduceThreads, 0, s>>>(partial, grid, sc,
                                                   static_cast<int*>(st_));
  qlp_init_vectors<T><<<grid, kThreads, 0, s>>>(b, work, sc, n);
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
    qlp_stencil<T, P><<<grid, kThreads, 0, s>>>(A, offs, nd, work, partial,
                                                sc, st, n, cap);
    qlp_alpha<T><<<1, kReduceThreads, 0, s>>>(partial, grid, sc, st, cap);
    qlp_lanczos<T><<<grid, kThreads, 0, s>>>(work, partial, sc, st, n);
    qlp_scalars<T><<<1, kReduceThreads, 0, s>>>(partial, grid, sc, st);
    qlp_update<T><<<grid, kThreads, 0, s>>>(work, partial, sc, st, n);
    qlp_tests<T><<<1, kReduceThreads, 0, s>>>(partial, grid, sc, st);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int finish(void* work, const void* sc, const void* st, long long n, int grid,
           void* stream) {
  qlp_finish<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<T*>(work), static_cast<const T*>(sc),
      static_cast<const int*>(st), n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define KTT_QLP_ITERATE(NAME, T, P)                                          \
  extern "C" int NAME(const void* pd, const void* offsets, int nd,           \
                      void* work, void* partial, void* sc, void* st,         \
                      long long n, int grid, int iters, int cap,             \
                      void* stream) {                                        \
    return iterate<T, P>(pd, offsets, nd, work, partial, sc, st, n, grid,    \
                         iters, cap, stream);                                \
  }

#define KTT_QLP_TYPED(INIT, FINISH, T)                                       \
  extern "C" int INIT(const void* b, void* work, void* partial, void* sc,    \
                      void* st, long long n, int grid, void* stream) {       \
    return init<T>(b, work, partial, sc, st, n, grid, stream);               \
  }                                                                          \
  extern "C" int FINISH(void* work, const void* sc, const void* st,          \
                        long long n, int grid, void* stream) {               \
    return finish<T>(work, sc, st, n, grid, stream);                         \
  }

KTT_QLP_TYPED(ktt_minres_qlp_dia_init_f32, ktt_minres_qlp_dia_finish_f32,
              float)
KTT_QLP_TYPED(ktt_minres_qlp_dia_init_f64, ktt_minres_qlp_dia_finish_f64,
              double)
KTT_QLP_ITERATE(ktt_minres_qlp_dia_iterate_f32_f32, float, float)
KTT_QLP_ITERATE(ktt_minres_qlp_dia_iterate_f32_bf16, float, __nv_bfloat16)
KTT_QLP_ITERATE(ktt_minres_qlp_dia_iterate_f32_f16, float, __half)
KTT_QLP_ITERATE(ktt_minres_qlp_dia_iterate_f64_f64, double, double)
