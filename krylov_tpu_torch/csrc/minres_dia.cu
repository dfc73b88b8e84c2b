// Whole MINRES solve of (A + lam I) x = b for a DIA matrix, M = I or
// Jacobi (v = dinv r2), on Hopper (sm_90a), with no grid-wide barrier.
//
// Replaces the TPU kernel krylov_tpu/ops/pallas_fused.py:465
// minres_dia_fused and computes what it computes (pallas_fused.py:
// 500-645): the unnormalised Lanczos step, the Givens chain, the
// forward-error window of `window` phi values, the conlim and
// machine-precision stops, and x, niter, rnorm, the status code (0
// running, 2 zero residual, 11 conlim, 20 least-squares solution, 21
// zero-residual solution, 22 forward error, 23 ill-conditioned for the
// machine, 24 minimum least-squares x), the inconsistent flag and the
// preconditioner-violation flag.  gamma is clamped at eps, the
// zero-residual limit test applies only with M = I, and the status
// overrides come in the order of pallas_fused.py:633-639.
//
// Bound on an H100 SXM: memory bandwidth.  An iteration applies the
// stencil once (pd, 28 B per row in f32 for the 7-point stencil, 58.7 MB
// at 128^3, more than the 50 MB L2) and must read and write x, the two
// Lanczos vectors and the two directions w1, w2: (28 + 40) B per row with
// M = I, about 143 MB at 128^3, so at least 42.6 us per iteration at
// 3.35 TB/s.
//
// Design.  Each of the iteration's three reductions gates the next
// vector pass, so an iteration is six launches on the caller's stream,
// with no block waiting on another:
//   1. mr_stencil (grid)     y = (A v + lam v) / beta - (beta / oldbeta) r1,
//                            partials of v'y
//   2. mr_alpha   (1 block)  GO, alpha = v'y / beta, delta
//   3. mr_lanczos (grid)     y -= (alpha / beta) r2; w1 = v / beta -
//                            delta w2 - eps w1 (unscaled); r1 = r2;
//                            r2 = y, v = dinv y (or v = y); partials of
//                            y'v
//   4. mr_rotate  (1 block)  beta, the Givens rotation, phi, the window
//   5. mr_update  (grid)     w = w1 / gamma, x += phi w, w1 = w2, w2 = w,
//                            partials of x'x
//   6. mr_tests   (1 block)  the stopping tests, status, it
// The TPU kernel overwrites the stencil's input v with y in place; here
// launch 1 reads v's neighbours, so y has its own buffer, and launch 3,
// which reads only its own rows, moves y into v.  The window's phi values
// live in the scalar array.  Every launch returns at once when the solve
// has stopped, and the host reads the status once per chunk of
// iterations.  Reductions are two-level in a fixed order, so two runs
// give the same bits.  Per iteration this design moves (28 + 12) + 28 +
// 24 B per row in f32 with M = I: 92 B.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kReduceThreads = 1024;

constexpr int RUNNING = 0;
constexpr int ZERO_RESIDUAL = 2;
constexpr int COND_EXCEEDED = 11;
constexpr int SOLVED_LSQ = 20;
constexpr int SOLVED_ZERO = 21;
constexpr int FWD_ERR = 22;
constexpr int ILL_COND_MACH = 23;
constexpr int MIN_LSQ_X = 24;

// slots of the scalar arrays; ATOL .. LAM are set by the host, and the
// window's phi values follow NSC, oldest first
enum ScalarSlot {
  ATOL = 0, RTOL, ETOL, CTOL, LAM, BETA1, EPS_LIM, OLDBETA, BETA, DBAR,
  EPS_PREV, PHIBAR, GMAX, GMIN, CS, SN, ANORM2, XENORM2, RNORM, ALPHA, DELTA,
  ROOT, GAMMA, PHI, NSC
};
enum IntSlot { IT = 0, STATUS, INCON, VIOL, GO, NST };
// rows of the vector workspace and of the partials
enum Vec { VX = 0, VR1, VR2, VV, VY, VW1, VW2, NVEC };
enum Part { PVY = 0, PYV, PXX, NPART };

// x = 0, r1 = b, v = dinv b (r2 = b) or v = b, w1 = w2 = 0, partials of
// b'v.
template <typename T>
__global__ void __launch_bounds__(kThreads)
mr_init(const T* __restrict__ b, const T* __restrict__ dinv,
        T* __restrict__ x, T* __restrict__ r1, T* __restrict__ r2,
        T* __restrict__ v, T* __restrict__ w1, T* __restrict__ w2,
        T* __restrict__ partial, long long n) {
  T s = T(0);
  for (long long i = ktt::first_row(); i < n; i += ktt::row_stride()) {
    const T bi = b[i];
    x[i] = T(0);
    r1[i] = bi;
    w1[i] = T(0);
    w2[i] = T(0);
    if (dinv) {
      const T vi = dinv[i] * bi;
      r2[i] = bi;
      v[i] = vi;
      s += bi * vi;
    } else {
      v[i] = bi;
      s += bi * bi;
    }
  }
  ktt::store_partial(s, partial);
}

// beta1, eps_lim, the starting status and the carried scalars.
template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
mr_init_scalars(const T* __restrict__ partial, int nparts, T* sc, int* st,
                int window) {
  const T beta1_sq = ktt::sum_partials(partial + PYV * nparts, nparts);
  if (threadIdx.x != 0) return;
  const T beta1 = sqrt(beta1_sq > T(0) ? beta1_sq : T(0));
  const T eps_lim = sc[ATOL] + sc[RTOL] * beta1;
  sc[BETA1] = beta1;
  sc[EPS_LIM] = eps_lim;
  sc[OLDBETA] = T(0);
  sc[BETA] = beta1;
  sc[DBAR] = T(0);
  sc[EPS_PREV] = T(0);
  sc[PHIBAR] = beta1;
  sc[GMAX] = T(0);
  sc[GMIN] = T(INFINITY);
  sc[CS] = T(-1);
  sc[SN] = T(0);
  sc[ANORM2] = T(0);
  sc[XENORM2] = T(0);
  sc[RNORM] = beta1;
  for (int j = 0; j < window; ++j) sc[NSC + j] = T(0);
  st[IT] = 0;
  st[STATUS] = beta1 == T(0) ? ZERO_RESIDUAL
               : (beta1 <= eps_lim ? SOLVED_ZERO : RUNNING);
  st[INCON] = 1;
  st[VIOL] = beta1_sq < T(0) ? 1 : 0;
  st[GO] = 0;
}

// 1. y = (A v + lam v) / beta, minus (beta / oldbeta) r1 from the second
// iteration on, and partials of v'y.  Reads the status and it that the
// previous iteration's mr_tests wrote.
template <typename T, typename P>
__global__ void __launch_bounds__(kThreads)
mr_stencil(const P* __restrict__ pd, const long long* __restrict__ offsets,
           int nd, const T* __restrict__ v, const T* __restrict__ r1,
           T* __restrict__ y, T* __restrict__ partial, const T* sc,
           const int* st, long long n, int cap) {
  if (!(st[STATUS] == RUNNING && st[IT] < cap)) return;
  const T lam = sc[LAM];
  const T beta = sc[BETA];
  const T oldbeta = sc[OLDBETA];
  const bool second = st[IT] >= 1;
  const T c = beta / (oldbeta == T(0) ? T(1) : oldbeta);
  T s = T(0);
  for (long long i = ktt::first_row(); i < n; i += ktt::row_stride()) {
    const T vi = v[i];
    T yi = ktt::stencil_row(pd, offsets, nd, v, i, n) + lam * vi;
    yi = yi / beta;
    if (second) yi = yi - c * r1[i];
    y[i] = yi;
    s += vi * yi;
  }
  ktt::store_partial(s, partial);
}

// 2. Decide whether this iteration runs (GO), then alpha and delta.
template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
mr_alpha(const T* __restrict__ partial, int nparts, T* sc, int* st, int cap) {
  const bool go = st[STATUS] == RUNNING && st[IT] < cap;
  if (!go) {
    if (threadIdx.x == 0) st[GO] = 0;
    return;
  }
  const T vy = ktt::sum_partials(partial, nparts);
  if (threadIdx.x != 0) return;
  const T alpha = vy / sc[BETA];
  sc[ALPHA] = alpha;
  sc[DELTA] = sc[CS] * sc[DBAR] + sc[SN] * alpha;
  st[GO] = 1;
}

// 3. The rest of the Lanczos step and the unscaled direction, row by row:
// y -= (alpha / beta) r2c with r2c = r2 (Jacobi) or v; w1 = v / beta -
// delta w2 - eps w1; r1 = r2c; then r2 = y, v = dinv y, or v = y; and the
// partials of y'v.
template <typename T>
__global__ void __launch_bounds__(kThreads)
mr_lanczos(const T* __restrict__ dinv, const T* __restrict__ y,
           T* __restrict__ r1, T* __restrict__ r2, T* __restrict__ v,
           T* __restrict__ w1, const T* __restrict__ w2,
           T* __restrict__ partial, const T* sc, const int* st, long long n) {
  if (!st[GO]) return;
  const T beta = sc[BETA];
  const T ab = sc[ALPHA] / beta;
  const T delta = sc[DELTA];
  const T eps_prev = sc[EPS_PREV];
  T s = T(0);
  for (long long i = ktt::first_row(); i < n; i += ktt::row_stride()) {
    const T vi = v[i];
    const T r2c = dinv ? r2[i] : vi;
    const T yi = y[i] - ab * r2c;
    w1[i] = vi / beta - delta * w2[i] - eps_prev * w1[i];
    r1[i] = r2c;
    if (dinv) {
      const T vn = dinv[i] * yi;
      r2[i] = yi;
      v[i] = vn;
      s += yi * vn;
    } else {
      v[i] = yi;
      s += yi * yi;
    }
  }
  ktt::store_partial(s, partial);
}

// 4. beta, the Givens rotation, phi and the forward-error window.
template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
mr_rotate(const T* __restrict__ partial, int nparts, T* sc, int* st,
          int window, bool precond) {
  if (!st[GO]) return;
  T beta_sq = ktt::sum_partials(partial, nparts);
  if (threadIdx.x != 0) return;
  if (precond) {
    if (beta_sq < T(0)) st[VIOL] = 1;
    beta_sq = beta_sq > T(0) ? beta_sq : T(0);
  }
  const T eps = ktt::eps_of<T>();
  const T alpha = sc[ALPHA];
  const T cs = sc[CS];
  const T sn = sc[SN];
  const T dbar = sc[DBAR];
  const T phibar = sc[PHIBAR];
  const T oldbeta_n = sc[BETA];
  const T beta_n = sqrt(beta_sq);
  const T anorm2 = sc[ANORM2] + alpha * alpha + oldbeta_n * oldbeta_n
                   + beta_sq;
  const T gbar = sn * dbar - cs * alpha;
  const T dbar_n = -cs * beta_n;
  const T root = sqrt(gbar * gbar + dbar_n * dbar_n);
  const T g = sqrt(gbar * gbar + beta_sq);
  const T gamma = g > eps ? g : eps;
  const T cs_n = gbar / gamma;
  const T sn_n = beta_n / gamma;
  const T phi = cs_n * phibar;
  sc[OLDBETA] = oldbeta_n;
  sc[BETA] = beta_n;
  sc[ANORM2] = anorm2;
  sc[EPS_PREV] = sn * beta_n;
  sc[DBAR] = dbar_n;
  sc[ROOT] = root;
  sc[GAMMA] = gamma;
  sc[CS] = cs_n;
  sc[SN] = sn_n;
  sc[PHI] = phi;
  sc[PHIBAR] = sn_n * phibar;
  sc[XENORM2] = sc[XENORM2] + phi * phi;
  sc[GMAX] = sc[GMAX] > gamma ? sc[GMAX] : gamma;
  sc[GMIN] = sc[GMIN] < gamma ? sc[GMIN] : gamma;
  for (int j = 0; j + 1 < window; ++j) sc[NSC + j] = sc[NSC + j + 1];
  sc[NSC + window - 1] = phi;
}

// 5. w = w1 / gamma, x += phi w, w1 = w2, w2 = w, partials of x'x.
template <typename T>
__global__ void __launch_bounds__(kThreads)
mr_update(T* __restrict__ x, T* __restrict__ w1, T* __restrict__ w2,
          T* __restrict__ partial, const T* sc, const int* st, long long n) {
  if (!st[GO]) return;
  const T gamma = sc[GAMMA];
  const T phi = sc[PHI];
  T s = T(0);
  for (long long i = ktt::first_row(); i < n; i += ktt::row_stride()) {
    const T w = w1[i] / gamma;
    const T xi = x[i] + phi * w;
    x[i] = xi;
    w1[i] = w2[i];
    w2[i] = w;
    s += xi * xi;
  }
  ktt::store_partial(s, partial);
}

// 6. The stopping tests and the status chain (pallas_fused.py:600-643).
template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
mr_tests(const T* __restrict__ partial, int nparts, T* sc, int* st,
         int window, bool precond) {
  if (!st[GO]) return;
  const T xx = ktt::sum_partials(partial, nparts);
  if (threadIdx.x != 0) return;
  const T eps = ktt::eps_of<T>();
  const T tiny = ktt::tiny_of<T>();
  const T one = T(1);
  const int it = st[IT] + 1;
  T err2 = T(0);
  for (int j = 0; j < window; ++j) err2 = err2 + sc[NSC + j] * sc[NSC + j];
  const T err_lbnd = sqrt(err2);
  const T anorm = sqrt(sc[ANORM2]);
  const T xnorm = sqrt(xx);
  const T rnorm = sc[PHIBAR];
  const T ax = anorm * xnorm;
  const T test1 = rnorm / (ax > tiny ? ax : tiny);
  const T test2 = sc[ROOT] / (anorm > tiny ? anorm : tiny);
  const T gmin = sc[GMIN];
  const T acond = sc[GMAX] / (gmin == T(0) ? tiny : gmin);
  const T eps_lim = sc[EPS_LIM];

  const bool min_lsq_early = it == 1 && sc[BETA] / sc[BETA1] <= T(10) * eps;
  const bool ill_cond_mach = (one + one / acond) <= one;
  const bool solved_mach = (one + test2) <= one;
  const bool zero_resid_mach = (one + test1) <= one;
  const bool resid_mach = (rnorm + one) <= one;
  const bool ill_cond_lim = (one / acond) <= sc[CTOL];
  const bool solved_lim = test2 <= eps_lim;
  const bool zero_resid_lim = !precond && test1 <= eps;
  const bool resid_lim = rnorm <= eps_lim;
  const bool fwd_err =
      it >= window && err_lbnd <= sc[ETOL] * sqrt(sc[XENORM2]);
  const bool zero_resid = zero_resid_mach || zero_resid_lim;
  const bool resid_decrease = resid_mach || resid_lim;
  const bool solved = solved_mach || solved_lim || zero_resid || fwd_err
                      || resid_decrease;

  int code = RUNNING;
  if (ill_cond_mach) code = ILL_COND_MACH;
  if (ill_cond_lim) code = COND_EXCEEDED;
  if (solved) code = SOLVED_LSQ;
  if (zero_resid) code = SOLVED_ZERO;
  if (fwd_err) code = FWD_ERR;
  if (min_lsq_early) code = MIN_LSQ_X;
  sc[RNORM] = rnorm;
  st[INCON] = min_lsq_early ? 1 : (zero_resid ? 0 : 1);
  st[IT] = it;
  st[STATUS] = code;
}

template <typename T>
int init(const void* b, const void* dinv, void* work_, void* partial_,
         void* sc_, void* st_, long long n, int grid, int window,
         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  T* work = static_cast<T*>(work_);
  T* partial = static_cast<T*>(partial_);
  mr_init<T><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(b), static_cast<const T*>(dinv), work + VX * n,
      work + VR1 * n, work + VR2 * n, work + VV * n, work + VW1 * n,
      work + VW2 * n, partial + PYV * grid, n);
  mr_init_scalars<T><<<1, kReduceThreads, 0, s>>>(
      partial, grid, static_cast<T*>(sc_), static_cast<int*>(st_), window);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename P>
int iterate(const void* pd, const void* offsets, int nd, const void* dinv_,
            void* work_, void* partial_, void* sc_, void* st_, long long n,
            int grid, int window, int iters, int cap, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const P* A = static_cast<const P*>(pd);
  const long long* offs = static_cast<const long long*>(offsets);
  const T* dinv = static_cast<const T*>(dinv_);
  T* work = static_cast<T*>(work_);
  T* partial = static_cast<T*>(partial_);
  T* sc = static_cast<T*>(sc_);
  int* st = static_cast<int*>(st_);
  const bool precond = dinv != nullptr;
  T* x = work + VX * n;
  T* r1 = work + VR1 * n;
  T* r2 = work + VR2 * n;
  T* v = work + VV * n;
  T* y = work + VY * n;
  T* w1 = work + VW1 * n;
  T* w2 = work + VW2 * n;
  T* pvy = partial + PVY * grid;
  T* pyv = partial + PYV * grid;
  T* pxx = partial + PXX * grid;
  for (int k = 0; k < iters; ++k) {
    mr_stencil<T, P><<<grid, kThreads, 0, s>>>(A, offs, nd, v, r1, y, pvy, sc,
                                               st, n, cap);
    mr_alpha<T><<<1, kReduceThreads, 0, s>>>(pvy, grid, sc, st, cap);
    mr_lanczos<T><<<grid, kThreads, 0, s>>>(dinv, y, r1, r2, v, w1, w2, pyv,
                                            sc, st, n);
    mr_rotate<T><<<1, kReduceThreads, 0, s>>>(pyv, grid, sc, st, window,
                                              precond);
    mr_update<T><<<grid, kThreads, 0, s>>>(x, w1, w2, pxx, sc, st, n);
    mr_tests<T><<<1, kReduceThreads, 0, s>>>(pxx, grid, sc, st, window,
                                             precond);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define KTT_MINRES_INIT(NAME, T)                                              \
  extern "C" int NAME(const void* b, const void* dinv, void* work,           \
                      void* partial, void* sc, void* st, long long n,        \
                      int grid, int window, void* stream) {                  \
    return init<T>(b, dinv, work, partial, sc, st, n, grid, window, stream); \
  }

#define KTT_MINRES_ITERATE(NAME, T, P)                                        \
  extern "C" int NAME(const void* pd, const void* offsets, int nd,           \
                      const void* dinv, void* work, void* partial, void* sc, \
                      void* st, long long n, int grid, int window, int iters, \
                      int cap, void* stream) {                               \
    return iterate<T, P>(pd, offsets, nd, dinv, work, partial, sc, st, n,    \
                         grid, window, iters, cap, stream);                  \
  }

KTT_MINRES_INIT(ktt_minres_dia_init_f32, float)
KTT_MINRES_INIT(ktt_minres_dia_init_f64, double)
KTT_MINRES_ITERATE(ktt_minres_dia_iterate_f32_f32, float, float)
KTT_MINRES_ITERATE(ktt_minres_dia_iterate_f32_bf16, float, __nv_bfloat16)
KTT_MINRES_ITERATE(ktt_minres_dia_iterate_f32_f16, float, __half)
KTT_MINRES_ITERATE(ktt_minres_dia_iterate_f64_f64, double, double)
