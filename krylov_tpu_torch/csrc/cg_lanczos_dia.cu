// Whole CG-Lanczos solve of A x = b for a DIA matrix, M = I, on Hopper
// (sm_90a), with no grid-wide barrier.
//
// Replaces the TPU kernel krylov_tpu/ops/pallas_fused.py:1021
// cg_lanczos_dia_fused and computes what it computes (pallas_fused.py:
// 1050-1129): the normalised Lanczos stream, the CG iterate and direction
// recurrences, the Anorm estimate, the check_curvature exit (the offending
// iteration is not applied: x, p, v and it stay as they were and the
// status is 27), and x, niter, rnorm, the status code (0 running, 1
// solved, 2 zero residual, 27 negative curvature) and the indefinite flag.
//
// Bound on an H100 SXM: memory bandwidth.  An iteration applies the
// stencil once (pd, 28 B per row in f32 for the 7-point stencil) and must
// read v and vprev and write the next v (12 B) and read and write x and p
// (16 B): 56 B per row, 117 MB at 128^3, so at least 35 us per iteration
// at 3.35 TB/s.
//
// Design.  Each of the iteration's two reductions (delta = v'Av before w
// is formed, |w| before v is normalised and p updated) gates the next
// vector pass, so an iteration is five launches on the caller's stream,
// with no block waiting on another:
//   1. cgl_stencil (grid)     Av into the next Lanczos buffer, partials of
//                             v'Av
//   2. cgl_delta   (1 block)  GO, delta, gamma, the curvature test and skip
//   3. cgl_lanczos (grid)     w = Av - delta v - beta vprev in place,
//                             x += gamma p, partials of w'w
//   4. cgl_beta    (1 block)  beta, Anorm, sigma, omega, the stopping test,
//                             status, it
//   5. cgl_update  (grid)     v = w / beta in place, p = sigma v + omega p
// The TPU kernel overwrites v in place while the next stencil reads its
// neighbours.  Here the three Lanczos vectors rotate through three
// buffers by it mod 3 (v in V[it % 3], vprev in V[(it + 2) % 3], the next
// one in V[(it + 1) % 3]), so the launch that reads v's halo writes only
// the buffer that held the vector before vprev, and launches 3 and 5 read
// and write their own rows only.  x and p stay in fixed buffers.  A
// launch after the stop writes nothing, so the rotation never runs ahead
// of it.  Every launch returns at once when the solve has stopped, and
// the host reads the status once per chunk of iterations.  Reductions are
// two-level in a fixed order, so two runs give the same bits.  Per
// iteration this design moves (28 + 8) + 28 + 16 B per row in f32: 80 B.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kReduceThreads = 1024;

constexpr int RUNNING = 0;
constexpr int SOLVED = 1;
constexpr int ZERO_RESIDUAL = 2;
constexpr int NEG_CURV = 27;

// slots of the scalar arrays; ATOL and RTOL are set by the host
enum ScalarSlot {
  ATOL = 0, RTOL, EPS_LIM, BETA, SIGMA, OMEGA, GAMMA, ANORM2, BETA_PREV,
  RNORM, DELTA, NSC
};
enum IntSlot { IT = 0, STATUS, INDEF, GO, ROT, NST };
// rows of the vector workspace: x, p and the three Lanczos buffers
enum Vec { VX = 0, VP, VL0, NVEC = VL0 + 3 };

template <typename T>
__device__ __forceinline__ T* lanczos(T* work, int slot, long long n) {
  return work + static_cast<long long>(VL0 + slot % 3) * n;
}

// Partials of b'b.
template <typename T>
__global__ void __launch_bounds__(kThreads)
cgl_init_norm(const T* __restrict__ b, T* __restrict__ partial, long long n) {
  T s = T(0);
  for (long long i = ktt::first_row(); i < n; i += ktt::row_stride()) {
    s += b[i] * b[i];
  }
  ktt::store_partial(s, partial);
}

// beta0, eps_lim, the starting status and the carried scalars.
template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
cgl_init_scalars(const T* __restrict__ partial, int nparts, T* sc, int* st) {
  const T bb = ktt::sum_partials(partial, nparts);
  if (threadIdx.x != 0) return;
  const T beta0 = sqrt(bb);
  const T eps_lim = sc[ATOL] + sc[RTOL] * beta0;
  sc[EPS_LIM] = eps_lim;
  sc[BETA] = beta0;
  sc[SIGMA] = beta0;
  sc[OMEGA] = T(0);
  sc[GAMMA] = T(1);
  sc[ANORM2] = T(0);
  sc[BETA_PREV] = T(0);
  sc[RNORM] = beta0;
  st[IT] = 0;
  st[STATUS] = beta0 == T(0) ? ZERO_RESIDUAL
               : (beta0 <= eps_lim ? SOLVED : RUNNING);
  st[INDEF] = 0;
  st[GO] = 0;
  st[ROT] = 0;
}

// x = 0, p = b, v = b / beta0 (in V[0]).
template <typename T>
__global__ void __launch_bounds__(kThreads)
cgl_init_vectors(const T* __restrict__ b, T* work, const T* sc, long long n) {
  const T beta0 = sc[BETA];
  const T safe = beta0 == T(0) ? T(1) : beta0;
  T* x = work + VX * n;
  T* p = work + VP * n;
  T* v = lanczos(work, 0, n);
  for (long long i = ktt::first_row(); i < n; i += ktt::row_stride()) {
    const T bi = b[i];
    x[i] = T(0);
    p[i] = bi;
    v[i] = bi / safe;
  }
}

// 1. Av into V[(it + 1) % 3] and partials of v'Av.  Reads the status and
// it that the previous iteration's cgl_beta wrote.
template <typename T, typename P>
__global__ void __launch_bounds__(kThreads)
cgl_stencil(const P* __restrict__ pd, const long long* __restrict__ offsets,
            int nd, T* work, T* __restrict__ partial, const int* st,
            long long n, int cap) {
  if (!(st[STATUS] == RUNNING && st[IT] < cap)) return;
  const int it = st[IT];
  const T* __restrict__ v = lanczos(work, it, n);
  T* __restrict__ av = lanczos(work, it + 1, n);
  T s = T(0);
  for (long long i = ktt::first_row(); i < n; i += ktt::row_stride()) {
    const T acc = ktt::stencil_row(pd, offsets, nd, v, i, n);
    av[i] = acc;
    s += v[i] * acc;
  }
  ktt::store_partial(s, partial);
}

// 2. Decide whether this iteration runs (GO), then delta, gamma and the
// curvature test; with check_curvature an indefinite step stops the solve
// without being applied.
template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
cgl_delta(const T* __restrict__ partial, int nparts, T* sc, int* st, int cap,
          bool check_curvature) {
  const bool go = st[STATUS] == RUNNING && st[IT] < cap;
  if (!go) {
    if (threadIdx.x == 0) st[GO] = 0;
    return;
  }
  const T delta = ktt::sum_partials(partial, nparts);
  if (threadIdx.x != 0) return;
  const T gamma = T(1) / (delta - sc[OMEGA] / sc[GAMMA]);
  const bool indef = st[INDEF] != 0 || gamma <= T(0);
  st[INDEF] = indef ? 1 : 0;
  if (check_curvature && indef) {
    st[STATUS] = NEG_CURV;
    st[GO] = 0;
    return;
  }
  sc[DELTA] = delta;
  sc[GAMMA] = gamma;
  st[ROT] = st[IT];
  st[GO] = 1;
}

// 3. w = Av - delta v - beta vprev (from the second iteration on) in
// place of Av, x += gamma p, partials of w'w.
template <typename T>
__global__ void __launch_bounds__(kThreads)
cgl_lanczos(T* work, T* __restrict__ partial, const T* sc, const int* st,
            long long n) {
  if (!st[GO]) return;
  const int r = st[ROT];
  const T* __restrict__ v = lanczos(work, r, n);
  const T* __restrict__ vprev = lanczos(work, r + 2, n);
  T* __restrict__ w = lanczos(work, r + 1, n);
  T* __restrict__ x = work + VX * n;
  const T* __restrict__ p = work + VP * n;
  const T delta = sc[DELTA];
  const T beta = sc[BETA];
  const T gamma = sc[GAMMA];
  const bool second = r > 0;
  T s = T(0);
  for (long long i = ktt::first_row(); i < n; i += ktt::row_stride()) {
    T wi = w[i] - delta * v[i];
    if (second) wi = wi - beta * vprev[i];
    w[i] = wi;
    x[i] = x[i] + gamma * p[i];
    s += wi * wi;
  }
  ktt::store_partial(s, partial);
}

// 4. beta, Anorm, sigma, omega, the stopping test, status and it.
template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
cgl_beta(const T* __restrict__ partial, int nparts, T* sc, int* st) {
  if (!st[GO]) return;
  const T ww = ktt::sum_partials(partial, nparts);
  if (threadIdx.x != 0) return;
  const T beta_n = sqrt(ww);
  const T delta = sc[DELTA];
  const T beta_prev = sc[BETA_PREV];
  sc[ANORM2] = sc[ANORM2] + beta_prev * beta_prev + beta_n * beta_n
               + delta * delta;
  const T om = beta_n * sc[GAMMA];
  const T sigma = -om * sc[SIGMA];
  const T rnorm = fabs(sigma);
  const bool solved = rnorm <= sc[EPS_LIM] || (rnorm + T(1)) <= T(1);
  sc[BETA] = beta_n;
  sc[BETA_PREV] = beta_n;
  sc[SIGMA] = sigma;
  sc[OMEGA] = om * om;
  sc[RNORM] = rnorm;
  st[IT] = st[IT] + 1;
  st[STATUS] = solved ? SOLVED : RUNNING;
}

// 5. v = w / beta in place, p = sigma v + omega p.
template <typename T>
__global__ void __launch_bounds__(kThreads)
cgl_update(T* work, const T* sc, const int* st, long long n) {
  if (!st[GO]) return;
  T* __restrict__ w = lanczos(work, st[ROT] + 1, n);
  T* __restrict__ p = work + VP * n;
  const T beta = sc[BETA];
  const T safe = beta == T(0) ? T(1) : beta;
  const T sigma = sc[SIGMA];
  const T omega = sc[OMEGA];
  for (long long i = ktt::first_row(); i < n; i += ktt::row_stride()) {
    const T vi = w[i] / safe;
    w[i] = vi;
    p[i] = sigma * vi + omega * p[i];
  }
}

template <typename T>
int init(const void* b, void* work_, void* partial_, void* sc_, void* st_,
         long long n, int grid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  T* work = static_cast<T*>(work_);
  T* partial = static_cast<T*>(partial_);
  T* sc = static_cast<T*>(sc_);
  cgl_init_norm<T><<<grid, kThreads, 0, s>>>(static_cast<const T*>(b),
                                             partial, n);
  cgl_init_scalars<T><<<1, kReduceThreads, 0, s>>>(partial, grid, sc,
                                                   static_cast<int*>(st_));
  cgl_init_vectors<T><<<grid, kThreads, 0, s>>>(static_cast<const T*>(b),
                                                work, sc, n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename P>
int iterate(const void* pd, const void* offsets, int nd, void* work_,
            void* partial_, void* sc_, void* st_, long long n, int grid,
            int check_curvature, int iters, int cap, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const P* A = static_cast<const P*>(pd);
  const long long* offs = static_cast<const long long*>(offsets);
  T* work = static_cast<T*>(work_);
  T* partial = static_cast<T*>(partial_);
  T* sc = static_cast<T*>(sc_);
  int* st = static_cast<int*>(st_);
  for (int k = 0; k < iters; ++k) {
    cgl_stencil<T, P><<<grid, kThreads, 0, s>>>(A, offs, nd, work, partial,
                                                st, n, cap);
    cgl_delta<T><<<1, kReduceThreads, 0, s>>>(partial, grid, sc, st, cap,
                                              check_curvature != 0);
    cgl_lanczos<T><<<grid, kThreads, 0, s>>>(work, partial, sc, st, n);
    cgl_beta<T><<<1, kReduceThreads, 0, s>>>(partial, grid, sc, st);
    cgl_update<T><<<grid, kThreads, 0, s>>>(work, sc, st, n);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define KTT_CGL_INIT(NAME, T)                                                 \
  extern "C" int NAME(const void* b, void* work, void* partial, void* sc,    \
                      void* st, long long n, int grid, void* stream) {       \
    return init<T>(b, work, partial, sc, st, n, grid, stream);               \
  }

#define KTT_CGL_ITERATE(NAME, T, P)                                           \
  extern "C" int NAME(const void* pd, const void* offsets, int nd,           \
                      void* work, void* partial, void* sc, void* st,         \
                      long long n, int grid, int check_curvature, int iters, \
                      int cap, void* stream) {                               \
    return iterate<T, P>(pd, offsets, nd, work, partial, sc, st, n, grid,    \
                         check_curvature, iters, cap, stream);               \
  }

KTT_CGL_INIT(ktt_cg_lanczos_dia_init_f32, float)
KTT_CGL_INIT(ktt_cg_lanczos_dia_init_f64, double)
KTT_CGL_ITERATE(ktt_cg_lanczos_dia_iterate_f32_f32, float, float)
KTT_CGL_ITERATE(ktt_cg_lanczos_dia_iterate_f32_bf16, float, __nv_bfloat16)
KTT_CGL_ITERATE(ktt_cg_lanczos_dia_iterate_f32_f16, float, __half)
KTT_CGL_ITERATE(ktt_cg_lanczos_dia_iterate_f64_f64, double, double)
