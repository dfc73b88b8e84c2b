// Whole SYMMLQ solve of (A + lam I) x = b for a DIA matrix, M = I, on
// Hopper (sm_90a), with no grid-wide barrier.
//
// Replaces the TPU kernel krylov_tpu/ops/pallas_fused.py:3722
// symmlq_dia_fused and computes what it computes (pallas_fused.py:
// 3755-3881): the normalised Lanczos stream of A + lam I, the LQ Givens
// chain (sym_givens, branch for branch as krylov_tpu/ops/kops.py:161-198),
// the CG-point test, the conlim and machine-precision stops, the CG-point
// transfer x += zetabar wbar after the stop when the CG test fired, and x,
// niter, rnorm, the status code (0 running, 2 zero residual, 11 conlim, 23
// ill-conditioned for the machine, 34 solution, 35 LQ solution, 36 CG
// solution), Anorm^2, gmax and gmin.  The status overrides come in the
// order of pallas_fused.py:3863-3871.
//
// Bound on an H100 SXM: memory bandwidth.  An iteration applies the
// stencil once (pd, 28 B per row in f32 for the 7-point stencil) and must
// read v and vold and write the next v (12 B) and read and write x and
// wbar (16 B): 56 B per row, 117 MB at 128^3, so at least 35 us per
// iteration at 3.35 TB/s.
//
// Design.  The Givens rotation of an iteration depends only on the
// previous iteration's scalars, so the scalar launch that ends an
// iteration also computes the next one's c, s and zeta.  An iteration is
// five launches on the caller's stream, with no block waiting on another:
//   1. sq_stencil (grid)     x += c zeta wbar + s zeta v, wbar = s wbar -
//                            c v, y = (A + lam I) v into the next Lanczos
//                            buffer, partials of v'y
//   2. sq_alpha   (1 block)  GO, alpha
//   3. sq_lanczos (grid)     y -= beta vold + alpha v in place, partials
//                            of y'y
//   4. sq_tests   (1 block)  beta, the LQ and CG-point recurrences, the
//                            stopping tests, status, it, and the next
//                            rotation
//   5. sq_update  (grid)     v = y / beta in place
// The init applies the stencil once (pallas_fused.py:3774-3779), so it is
// eight launches.  The TPU kernel overwrites v in place while the next
// stencil reads its neighbours; here the three Lanczos vectors rotate
// through three buffers by it mod 3 (v in V[it % 3], vold in
// V[(it + 2) % 3], y in V[(it + 1) % 3]), so the launch that reads v's
// halo never writes v.  x and wbar stay in fixed buffers.  The CG-point
// transfer is one finishing launch after the host's loop.  Every
// iteration launch returns at once when the solve has stopped, and the
// host reads the status once per chunk of iterations.  Per iteration this
// design moves (28 + 24) + 16 + 8 B per row in f32: 76 B.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kReduceThreads = 1024;

constexpr int RUNNING = 0;
constexpr int ZERO_RESIDUAL = 2;
constexpr int COND_EXCEEDED = 11;
constexpr int ILL_COND_MACH = 23;
constexpr int SOLVED_GEN = 34;
constexpr int SOLVED_LQ = 35;
constexpr int SOLVED_CG = 36;

// slots of the scalar array; ATOL .. LAM are set by the host
enum ScalarSlot {
  ATOL = 0, RTOL, CTOL, LAM, BETA1, TOL, ALPHA, BETA, GBAR, DBAR, EPS_OLD,
  ETA, ZOLD, ZETABAR, ANORM2, GMAX, GMIN, XNORM2, RNORM, RCG, CS, SN, GAMMA,
  ZETA, NSC
};
enum IntSlot { IT = 0, STATUS, CGFLAG, GO, ROT, NST };
// rows of the vector workspace: x, wbar and the three Lanczos buffers
enum Vec { VX = 0, VWBAR, VL0, NVEC = VL0 + 3 };

template <typename T>
__device__ __forceinline__ T* lanczos(T* work, int slot, long long n) {
  return work + static_cast<long long>(VL0 + slot % 3) * n;
}

using ktt::safe;
using ktt::sym_givens;

// The rotation of the next iteration from gbar and beta: c, s, gamma and
// zeta = eta / gamma.
template <typename T>
__device__ void next_rotation(T* sc) {
  T c, s, gamma;
  sym_givens(sc[GBAR], sc[BETA], c, s, gamma);
  sc[CS] = c;
  sc[SN] = s;
  sc[GAMMA] = gamma;
  sc[ZETA] = sc[ETA] / safe(gamma);
}

// Partials of b'b.
template <typename T>
__global__ void __launch_bounds__(kThreads)
sq_init_norm(const T* __restrict__ b, T* __restrict__ partial, long long n) {
  T s = T(0);
  for (long long i = ktt::first_row(); i < n; i += ktt::row_stride()) {
    s += b[i] * b[i];
  }
  ktt::store_partial(s, partial);
}

// beta1 and tol.
template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
sq_init_beta1(const T* __restrict__ partial, int nparts, T* sc) {
  const T bb = ktt::sum_partials(partial, nparts);
  if (threadIdx.x != 0) return;
  const T beta1 = sqrt(bb);
  sc[BETA1] = beta1;
  sc[TOL] = sc[ATOL] + sc[RTOL] * beta1;
}

// x = 0, vold = wbar = b / beta1 (vold in V[2]).
template <typename T>
__global__ void __launch_bounds__(kThreads)
sq_init_vectors(const T* __restrict__ b, T* work, const T* sc, long long n) {
  const T s1 = safe(sc[BETA1]);
  T* x = work + VX * n;
  T* wbar = work + VWBAR * n;
  T* vold = lanczos(work, 2, n);
  for (long long i = ktt::first_row(); i < n; i += ktt::row_stride()) {
    const T vi = b[i] / s1;
    x[i] = T(0);
    wbar[i] = vi;
    vold[i] = vi;
  }
}

// y = (A + lam I) vold into V[0], partials of vold'y.
template <typename T, typename P>
__global__ void __launch_bounds__(kThreads)
sq_init_stencil(const P* __restrict__ pd,
                const long long* __restrict__ offsets, int nd, T* work,
                T* __restrict__ partial, const T* sc, long long n) {
  const T lam = sc[LAM];
  const T* __restrict__ vold = lanczos(work, 2, n);
  T* __restrict__ y = lanczos(work, 0, n);
  T s = T(0);
  for (long long i = ktt::first_row(); i < n; i += ktt::row_stride()) {
    const T vi = vold[i];
    const T yi = ktt::stencil_row(pd, offsets, nd, vold, i, n) + lam * vi;
    y[i] = yi;
    s += vi * yi;
  }
  ktt::store_partial(s, partial);
}

// alpha from the partials (the init's, and launch 2 of an iteration).
template <typename T>
__device__ __forceinline__ void store_alpha(const T* partial, int nparts,
                                            T* sc) {
  const T alpha = ktt::sum_partials(partial, nparts);
  if (threadIdx.x == 0) sc[ALPHA] = alpha;
}

template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
sq_init_alpha(const T* __restrict__ partial, int nparts, T* sc) {
  store_alpha(partial, nparts, sc);
}

// y -= alpha vold in V[0], partials of y'y.
template <typename T>
__global__ void __launch_bounds__(kThreads)
sq_init_lanczos(T* work, T* __restrict__ partial, const T* sc, long long n) {
  const T alpha = sc[ALPHA];
  const T* __restrict__ vold = lanczos(work, 2, n);
  T* __restrict__ y = lanczos(work, 0, n);
  T s = T(0);
  for (long long i = ktt::first_row(); i < n; i += ktt::row_stride()) {
    const T yi = y[i] - alpha * vold[i];
    y[i] = yi;
    s += yi * yi;
  }
  ktt::store_partial(s, partial);
}

// beta, the starting scalars and status (pallas_fused.py:3781-3800), and
// the first rotation.
template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
sq_init_scalars(const T* __restrict__ partial, int nparts, T* sc, int* st,
                bool transfer_to_cg) {
  const T yy = ktt::sum_partials(partial, nparts);
  if (threadIdx.x != 0) return;
  const T beta = sqrt(yy);
  const T alpha = sc[ALPHA];
  const T beta1 = sc[BETA1];
  const T tol = sc[TOL];
  const T zetabar = beta1 / safe(alpha);
  const T rcg = beta1 * fabs(zetabar);
  const bool solved_lq0 = beta1 <= tol;
  const bool solved_cg0 = transfer_to_cg && alpha != T(0) && rcg <= tol;
  sc[BETA] = beta;
  sc[GBAR] = alpha;
  sc[DBAR] = beta;
  sc[EPS_OLD] = T(0);
  sc[ETA] = beta1;
  sc[ZOLD] = T(0);
  sc[ZETABAR] = zetabar;
  sc[ANORM2] = alpha * alpha + beta * beta;
  sc[GMAX] = T(-INFINITY);
  sc[GMIN] = T(INFINITY);
  sc[XNORM2] = T(0);
  sc[RNORM] = beta1;
  sc[RCG] = rcg;
  next_rotation(sc);
  st[IT] = 0;
  st[STATUS] = beta1 == T(0) ? ZERO_RESIDUAL
               : (solved_lq0 ? SOLVED_LQ : (solved_cg0 ? SOLVED_CG : RUNNING));
  st[CGFLAG] = solved_cg0 ? 1 : 0;
  st[GO] = 0;
  st[ROT] = 0;
}

// v = y / beta in place: V[0] after the init (from == 0), V[(it + 1) % 3]
// in an iteration.
template <typename T>
__device__ __forceinline__ void normalise(T* y, T beta, long long n) {
  const T sb = safe(beta);
  for (long long i = ktt::first_row(); i < n; i += ktt::row_stride()) {
    y[i] = y[i] / sb;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
sq_init_update(T* work, const T* sc, long long n) {
  normalise(lanczos(work, 0, n), sc[BETA], n);
}

// 1. The x and wbar updates with this iteration's rotation, y = (A + lam
// I) v into V[(it + 1) % 3], partials of v'y.  Reads the status and it
// that the previous iteration's sq_tests wrote.
template <typename T, typename P>
__global__ void __launch_bounds__(kThreads)
sq_stencil(const P* __restrict__ pd, const long long* __restrict__ offsets,
           int nd, T* work, T* __restrict__ partial, const T* sc,
           const int* st, long long n, int cap) {
  if (!(st[STATUS] == RUNNING && st[IT] < cap)) return;
  const int it = st[IT];
  const T* __restrict__ v = lanczos(work, it, n);
  T* __restrict__ y = lanczos(work, it + 1, n);
  T* __restrict__ x = work + VX * n;
  T* __restrict__ wbar = work + VWBAR * n;
  const T lam = sc[LAM];
  const T c = sc[CS];
  const T s = sc[SN];
  const T cz = c * sc[ZETA];
  const T sz = s * sc[ZETA];
  T acc = T(0);
  for (long long i = ktt::first_row(); i < n; i += ktt::row_stride()) {
    const T vi = v[i];
    const T wi = wbar[i];
    x[i] = x[i] + cz * wi + sz * vi;
    wbar[i] = s * wi - c * vi;
    const T yi = ktt::stencil_row(pd, offsets, nd, v, i, n) + lam * vi;
    y[i] = yi;
    acc += vi * yi;
  }
  ktt::store_partial(acc, partial);
}

// 2. Decide whether this iteration runs (GO), then alpha.
template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
sq_alpha(const T* __restrict__ partial, int nparts, T* sc, int* st, int cap) {
  const bool go = st[STATUS] == RUNNING && st[IT] < cap;
  if (!go) {
    if (threadIdx.x == 0) st[GO] = 0;
    return;
  }
  store_alpha(partial, nparts, sc);
  if (threadIdx.x != 0) return;
  st[ROT] = st[IT];
  st[GO] = 1;
}

// 3. y -= beta vold + alpha v in place, partials of y'y.
template <typename T>
__global__ void __launch_bounds__(kThreads)
sq_lanczos(T* work, T* __restrict__ partial, const T* sc, const int* st,
           long long n) {
  if (!st[GO]) return;
  const int r = st[ROT];
  const T* __restrict__ v = lanczos(work, r, n);
  const T* __restrict__ vold = lanczos(work, r + 2, n);
  T* __restrict__ y = lanczos(work, r + 1, n);
  const T beta = sc[BETA];
  const T alpha = sc[ALPHA];
  T s = T(0);
  for (long long i = ktt::first_row(); i < n; i += ktt::row_stride()) {
    const T yi = y[i] - beta * vold[i] - alpha * v[i];
    y[i] = yi;
    s += yi * yi;
  }
  ktt::store_partial(s, partial);
}

// 4. beta, the LQ and CG-point recurrences, the stopping tests and the
// status chain (pallas_fused.py:3830-3871), then the next rotation.
template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
sq_tests(const T* __restrict__ partial, int nparts, T* sc, int* st,
         bool transfer_to_cg) {
  if (!st[GO]) return;
  const T yy = ktt::sum_partials(partial, nparts);
  if (threadIdx.x != 0) return;
  const T tiny = ktt::tiny_of<T>();
  const T one = T(1);
  const T beta_n = sqrt(yy);
  const T alpha = sc[ALPHA];
  const T beta = sc[BETA];
  const T c = sc[CS];
  const T s = sc[SN];
  const T gamma = sc[GAMMA];
  const T zeta = sc[ZETA];
  const T dbar = sc[DBAR];
  const T eps_old = sc[EPS_OLD];
  const T zold = sc[ZOLD];
  const T tol = sc[TOL];

  const T anorm2 = sc[ANORM2] + alpha * alpha + beta * beta + beta_n * beta_n;
  const T delta = dbar * c + alpha * s;
  const T gbar = dbar * s - alpha * c;
  const T eps_new = beta_n * s;
  const T dbar_n = -beta_n * c;
  const T eta = -eps_old * zold - delta * zeta;
  const T rnorm = sqrt(gamma * gamma * zeta * zeta
                       + eps_old * eps_old * zold * zold);
  const T xnorm2 = sc[XNORM2] + zeta * zeta;
  const bool gbar_nz = gbar != T(0);
  const T zetabar = gbar_nz ? eta / safe(gbar) : sc[ZETABAR];
  const T rcg = gbar_nz ? beta_n * fabs(s * zeta - c * zetabar) : sc[RCG];
  const T gmax = sc[GMAX] > gamma ? sc[GMAX] : gamma;
  const T gmin = sc[GMIN] < gamma ? sc[GMIN] : gamma;
  const T acond = gmax / (gmin > tiny ? gmin : tiny);
  const T anorm = sqrt(anorm2);
  const T ax = anorm * sqrt(xnorm2);
  const T test1 = rnorm / (ax > tiny ? ax : tiny);
  const T acond_t = acond > tiny ? acond : tiny;

  const bool resid_mach = (one + rnorm) <= one;
  const bool ill_cond_mach = (one + one / acond_t) <= one;
  const bool zero_resid_mach = (one + test1) <= one;
  const bool ill_cond_lim = (one / acond_t) <= sc[CTOL];
  const bool zero_resid_lim = test1 <= tol;
  const bool solved_lq = rnorm <= tol;
  const bool solved_cg = transfer_to_cg && gbar_nz && rcg <= tol;
  const bool zero_resid = solved_lq || solved_cg;
  const bool solved =
      resid_mach || zero_resid || zero_resid_mach || zero_resid_lim;

  int code = RUNNING;
  if (ill_cond_mach) code = ILL_COND_MACH;
  if (ill_cond_lim) code = COND_EXCEEDED;
  if (solved) code = SOLVED_GEN;
  if (solved && solved_lq) code = SOLVED_LQ;
  if (solved && solved_cg) code = SOLVED_CG;

  sc[BETA] = beta_n;
  sc[GBAR] = gbar;
  sc[DBAR] = dbar_n;
  sc[EPS_OLD] = eps_new;
  sc[ETA] = eta;
  sc[ZOLD] = zeta;
  sc[ZETABAR] = zetabar;
  sc[ANORM2] = anorm2;
  sc[GMAX] = gmax;
  sc[GMIN] = gmin;
  sc[XNORM2] = xnorm2;
  sc[RNORM] = rnorm;
  sc[RCG] = rcg;
  next_rotation(sc);
  st[IT] = st[IT] + 1;
  st[STATUS] = code;
  st[CGFLAG] = solved_cg ? 1 : 0;
}

// 5. v = y / beta in place.
template <typename T>
__global__ void __launch_bounds__(kThreads)
sq_update(T* work, const T* sc, const int* st, long long n) {
  if (!st[GO]) return;
  normalise(lanczos(work, st[ROT] + 1, n), sc[BETA], n);
}

// The CG-point transfer x += zetabar wbar, when the CG test stopped the
// solve (pallas_fused.py:3879-3881).
template <typename T>
__global__ void __launch_bounds__(kThreads)
sq_finish(T* work, const T* sc, const int* st, long long n) {
  if (!st[CGFLAG]) return;
  T* __restrict__ x = work + VX * n;
  const T* __restrict__ wbar = work + VWBAR * n;
  const T zetabar = sc[ZETABAR];
  for (long long i = ktt::first_row(); i < n; i += ktt::row_stride()) {
    x[i] = x[i] + zetabar * wbar[i];
  }
}

template <typename T, typename P>
int init(const void* pd, const void* offsets, int nd, const void* b_,
         void* work_, void* partial_, void* sc_, void* st_, long long n,
         int grid, int transfer_to_cg, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const P* A = static_cast<const P*>(pd);
  const long long* offs = static_cast<const long long*>(offsets);
  const T* b = static_cast<const T*>(b_);
  T* work = static_cast<T*>(work_);
  T* partial = static_cast<T*>(partial_);
  T* sc = static_cast<T*>(sc_);
  sq_init_norm<T><<<grid, kThreads, 0, s>>>(b, partial, n);
  sq_init_beta1<T><<<1, kReduceThreads, 0, s>>>(partial, grid, sc);
  sq_init_vectors<T><<<grid, kThreads, 0, s>>>(b, work, sc, n);
  sq_init_stencil<T, P><<<grid, kThreads, 0, s>>>(A, offs, nd, work, partial,
                                                  sc, n);
  sq_init_alpha<T><<<1, kReduceThreads, 0, s>>>(partial, grid, sc);
  sq_init_lanczos<T><<<grid, kThreads, 0, s>>>(work, partial, sc, n);
  sq_init_scalars<T><<<1, kReduceThreads, 0, s>>>(
      partial, grid, sc, static_cast<int*>(st_), transfer_to_cg != 0);
  sq_init_update<T><<<grid, kThreads, 0, s>>>(work, sc, n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename P>
int iterate(const void* pd, const void* offsets, int nd, void* work_,
            void* partial_, void* sc_, void* st_, long long n, int grid,
            int transfer_to_cg, int iters, int cap, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const P* A = static_cast<const P*>(pd);
  const long long* offs = static_cast<const long long*>(offsets);
  T* work = static_cast<T*>(work_);
  T* partial = static_cast<T*>(partial_);
  T* sc = static_cast<T*>(sc_);
  int* st = static_cast<int*>(st_);
  for (int k = 0; k < iters; ++k) {
    sq_stencil<T, P><<<grid, kThreads, 0, s>>>(A, offs, nd, work, partial, sc,
                                               st, n, cap);
    sq_alpha<T><<<1, kReduceThreads, 0, s>>>(partial, grid, sc, st, cap);
    sq_lanczos<T><<<grid, kThreads, 0, s>>>(work, partial, sc, st, n);
    sq_tests<T><<<1, kReduceThreads, 0, s>>>(partial, grid, sc, st,
                                             transfer_to_cg != 0);
    sq_update<T><<<grid, kThreads, 0, s>>>(work, sc, st, n);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int finish(void* work, const void* sc, const void* st, long long n, int grid,
           void* stream) {
  sq_finish<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<T*>(work), static_cast<const T*>(sc),
      static_cast<const int*>(st), n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define KTT_SYMMLQ(INIT, ITERATE, T, P)                                       \
  extern "C" int INIT(const void* pd, const void* offsets, int nd,           \
                      const void* b, void* work, void* partial, void* sc,    \
                      void* st, long long n, int grid, int transfer_to_cg,   \
                      void* stream) {                                        \
    return init<T, P>(pd, offsets, nd, b, work, partial, sc, st, n, grid,    \
                      transfer_to_cg, stream);                               \
  }                                                                          \
  extern "C" int ITERATE(const void* pd, const void* offsets, int nd,        \
                         void* work, void* partial, void* sc, void* st,      \
                         long long n, int grid, int transfer_to_cg,          \
                         int iters, int cap, void* stream) {                 \
    return iterate<T, P>(pd, offsets, nd, work, partial, sc, st, n, grid,    \
                         transfer_to_cg, iters, cap, stream);                \
  }

KTT_SYMMLQ(ktt_symmlq_dia_init_f32_f32, ktt_symmlq_dia_iterate_f32_f32, float,
           float)
KTT_SYMMLQ(ktt_symmlq_dia_init_f32_bf16, ktt_symmlq_dia_iterate_f32_bf16,
           float, __nv_bfloat16)
KTT_SYMMLQ(ktt_symmlq_dia_init_f32_f16, ktt_symmlq_dia_iterate_f32_f16, float,
           __half)
KTT_SYMMLQ(ktt_symmlq_dia_init_f64_f64, ktt_symmlq_dia_iterate_f64_f64,
           double, double)

extern "C" int ktt_symmlq_dia_finish_f32(void* work, const void* sc,
                                         const void* st, long long n, int grid,
                                         void* stream) {
  return finish<float>(work, sc, st, n, grid, stream);
}

extern "C" int ktt_symmlq_dia_finish_f64(void* work, const void* sc,
                                         const void* st, long long n, int grid,
                                         void* stream) {
  return finish<double>(work, sc, st, n, grid, stream);
}
