// Whole CGLS solve of min ||b - A x||^2 + lambda ||x||^2 for a DIA matrix
// on Hopper (sm_90a), with no grid-wide barrier.
//
// Replaces the TPU kernel krylov_tpu/ops/pallas_fused.py:3309
// cgls_dia_fused and computes what it computes (pallas_fused.py:
// 3326-3376): CG on the normal equations with q = A p,
// delta = ||q||^2 + lambda ||p||^2, x += alpha p, r -= alpha q,
// s = A^H r - lambda x (lambda itself, not its square root, as the TPU
// kernel has it), p = s + beta p, and the stop on
// ||s|| <= atol + rtol ||A^H b||.  Outputs: x, niter, ||r||, ||A^H r||
// (||s||) and the status code (0 running, 1 solved, 2 zero residual).
//
// Bound on an H100 SXM: memory bandwidth.  An iteration applies A and
// A^H once each (2 x 28 B per row in f32 for the 7-point stencil) and
// must read and write x, r and p: (56 + 24) B per row, 80 B.
//
// Design: five launches per iteration, the scalar state on the device
// and the status read by the host once per chunk:
//   1. gls_ap     (grid)    GO decided here; q = A p, partials of ||q||^2
//   2. gls_xr     (grid)    alpha = gamma / (||q||^2 + lambda ||p||^2)
//                           summed in every block; x += alpha p,
//                           r -= alpha q, partials of ||r||^2
//   3. gls_ahr    (grid)    s = A^H r - lambda x, partials of ||s||^2
//   4. gls_p      (grid)    beta = ||s||^2 / gamma in every block;
//                           p = s + beta p, partials of ||p||^2
//   5. gls_commit (1 block) ||r||, ||s||, the test, gamma = ||s||^2 and
//                           the iteration count
// alpha needs all of ||q||^2, so x and r cannot move in launch 1; s reads
// r's neighbours, so r is final before launch 3.  Launch 1 reads p's
// neighbours and launch 3 r's, and neither writes the vector it reads
// so; the state the grid launches read is written only by the commit.
// Per iteration this design moves (28 + 8) + 24 + (28 + 8) + 12 B per
// row in f32, 108 B (+ 4 with lambda).
#include "common.cuh"

namespace {

using namespace ktt;

constexpr int kThreads = 256;

// the status codes of krylov_tpu_torch/_runtime.py
constexpr int RUNNING = 0;
constexpr int SOLVED = 1;
constexpr int ZERO_RESIDUAL = 2;

// LAM, ATOL and RTOL are set by the host
enum ScalarSlot { LAM = 0, ATOL, RTOL, GAMMA, RNORM, ARNORM, EPS_LIM, NSC };
enum IntSlot { IT = 0, STATUS, GO, NST };
enum Row { ROW_X = 0, ROW_R, ROW_P, ROW_Q, ROW_S, NROWS };
enum Part { PBB = 0, PQQ, PRR, PSS, PPP, NPART };

template <typename T>
__device__ __forceinline__ T* row(T* work, int r, long long n) {
  return work + static_cast<long long>(r) * n;
}

// The same sum of block partials in every block of a launch.
template <typename T>
__device__ __forceinline__ T all_sum(const T* partial, int nparts) {
  __shared__ T sum;
  const T s = sum_partials(partial, nparts);
  if (threadIdx.x == 0) sum = s;
  __syncthreads();
  return sum;
}

// lambda where it is positive (pallas_fused.py:3358-3366)
template <typename T>
__device__ __forceinline__ bool lam_on(const T* sc) {
  return sc[LAM] > T(0);
}

// Init: x = 0, r = b, q = s = 0, with the partials of b'b.
template <typename T>
__global__ void __launch_bounds__(kThreads)
gls_init_vectors(const T* __restrict__ b, T* __restrict__ work,
                 T* __restrict__ partial, long long n) {
  T s = T(0);
  for (long long i = first_row(); i < n; i += row_stride()) {
    const T bi = b[i];
    row(work, ROW_X, n)[i] = T(0);
    row(work, ROW_R, n)[i] = bi;
    row(work, ROW_Q, n)[i] = T(0);
    row(work, ROW_S, n)[i] = T(0);
    s += bi * bi;
  }
  store_partial(s, partial + PBB * gridDim.x);
}

// Init: p = A^H b, with the partials of ||p||^2 (gamma_0).
template <typename T, typename P>
__global__ void __launch_bounds__(kThreads)
gls_init_p(const P* __restrict__ pda, const long long* __restrict__ offs_a,
           int nda, const T* __restrict__ b, T* __restrict__ work,
           T* __restrict__ partial, long long n) {
  T* p = row(work, ROW_P, n);
  T s = T(0);
  for (long long i = first_row(); i < n; i += row_stride()) {
    const T pi = stencil_row(pda, offs_a, nda, b, i, n);
    p[i] = pi;
    s += pi * pi;
  }
  store_partial(s, partial + PPP * gridDim.x);
}

// Init: ||b||, gamma_0 = ||A^H b||^2, eps and the status (pallas_fused.py:
// 3335-3348).
template <typename T>
__global__ void __launch_bounds__(kThreads)
gls_init_state(T* sc, int* st, const T* __restrict__ partial, int nparts) {
  const T bb = sum_partials(partial + PBB * nparts, nparts);
  __syncthreads();
  const T gamma = sum_partials(partial + PPP * nparts, nparts);
  if (threadIdx.x != 0) return;
  const T bnorm = sqrt(bb);
  const T arnorm = sqrt(gamma);
  const T eps_lim = sc[ATOL] + sc[RTOL] * arnorm;
  sc[GAMMA] = gamma;
  sc[RNORM] = bnorm;
  sc[ARNORM] = arnorm;
  sc[EPS_LIM] = eps_lim;
  st[IT] = 0;
  st[STATUS] = bnorm == T(0)      ? ZERO_RESIDUAL
               : arnorm <= eps_lim ? SOLVED
                                   : RUNNING;
  st[GO] = 0;
}

// 1. GO; q = A p and the partials of ||q||^2.
template <typename T, typename P>
__global__ void __launch_bounds__(kThreads)
gls_ap(const P* __restrict__ pd, const long long* __restrict__ offsets,
       int nd, T* __restrict__ work, T* __restrict__ partial, int* st,
       long long n, int cap) {
  const bool go = st[STATUS] == RUNNING && st[IT] < cap;
  if (blockIdx.x == 0 && threadIdx.x == 0) st[GO] = go ? 1 : 0;
  if (!go) return;
  const T* p = row(work, ROW_P, n);
  T* q = row(work, ROW_Q, n);
  T s = T(0);
  for (long long i = first_row(); i < n; i += row_stride()) {
    const T qi = stencil_row(pd, offsets, nd, p, i, n);
    q[i] = qi;
    s += qi * qi;
  }
  store_partial(s, partial + PQQ * gridDim.x);
}

// 2. alpha = gamma / (||q||^2 + lambda ||p||^2); x += alpha p,
// r -= alpha q and the partials of ||r||^2.
template <typename T>
__global__ void __launch_bounds__(kThreads)
gls_xr(T* __restrict__ work, T* __restrict__ partial, const T* sc,
       const int* st, long long n) {
  if (!st[GO]) return;
  const int nparts = gridDim.x;
  T delta = all_sum(partial + PQQ * nparts, nparts);
  if (lam_on(sc)) delta = delta + sc[LAM] * all_sum(partial + PPP * nparts,
                                                    nparts);
  const T alpha = sc[GAMMA] / safe(delta);
  const T* p = row(work, ROW_P, n);
  const T* q = row(work, ROW_Q, n);
  T* x = row(work, ROW_X, n);
  T* r = row(work, ROW_R, n);
  T s = T(0);
  for (long long i = first_row(); i < n; i += row_stride()) {
    x[i] = x[i] + alpha * p[i];
    const T ri = r[i] - alpha * q[i];
    r[i] = ri;
    s += ri * ri;
  }
  store_partial(s, partial + PRR * nparts);
}

// 3. s = A^H r - lambda x and the partials of ||s||^2.
template <typename T, typename P>
__global__ void __launch_bounds__(kThreads)
gls_ahr(const P* __restrict__ pda, const long long* __restrict__ offs_a,
        int nda, T* __restrict__ work, T* __restrict__ partial, const T* sc,
        const int* st, long long n) {
  if (!st[GO]) return;
  const bool lam = lam_on(sc);
  const T* r = row(work, ROW_R, n);
  const T* x = row(work, ROW_X, n);
  T* s_ = row(work, ROW_S, n);
  T s = T(0);
  for (long long i = first_row(); i < n; i += row_stride()) {
    T si = stencil_row(pda, offs_a, nda, r, i, n);
    if (lam) si = si - sc[LAM] * x[i];
    s_[i] = si;
    s += si * si;
  }
  store_partial(s, partial + PSS * gridDim.x);
}

// 4. beta = ||s||^2 / gamma; p = s + beta p and the partials of ||p||^2.
template <typename T>
__global__ void __launch_bounds__(kThreads)
gls_p(T* __restrict__ work, T* __restrict__ partial, const T* sc,
      const int* st, long long n) {
  if (!st[GO]) return;
  const int nparts = gridDim.x;
  const T beta = all_sum(partial + PSS * nparts, nparts) / safe(sc[GAMMA]);
  const T* s_ = row(work, ROW_S, n);
  T* p = row(work, ROW_P, n);
  T s = T(0);
  for (long long i = first_row(); i < n; i += row_stride()) {
    const T pi = s_[i] + beta * p[i];
    p[i] = pi;
    s += pi * pi;
  }
  store_partial(s, partial + PPP * nparts);
}

// 5. The commit: ||r||, ||s||, the test and the next state
// (pallas_fused.py:3367-3374).
template <typename T>
__global__ void __launch_bounds__(kThreads)
gls_commit(T* sc, int* st, const T* __restrict__ partial, int nparts) {
  if (!st[GO]) return;
  const T rr = sum_partials(partial + PRR * nparts, nparts);
  __syncthreads();
  const T gamma = sum_partials(partial + PSS * nparts, nparts);
  if (threadIdx.x != 0) return;
  const T arnorm = sqrt(gamma);
  sc[GAMMA] = gamma;
  sc[RNORM] = sqrt(rr);
  sc[ARNORM] = arnorm;
  st[STATUS] = arnorm <= sc[EPS_LIM] ? SOLVED : RUNNING;
  st[IT] = st[IT] + 1;
}

template <typename T, typename P>
int init(const void* pda, const void* offs_a, int nda, const void* b_,
         void* work_, void* partial_, void* sc, void* st, long long n,
         int grid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* b = static_cast<const T*>(b_);
  T* work = static_cast<T*>(work_);
  T* partial = static_cast<T*>(partial_);
  gls_init_vectors<T><<<grid, kThreads, 0, s>>>(b, work, partial, n);
  gls_init_p<T, P><<<grid, kThreads, 0, s>>>(
      static_cast<const P*>(pda), static_cast<const long long*>(offs_a), nda,
      b, work, partial, n);
  gls_init_state<T><<<1, kThreads, 0, s>>>(
      static_cast<T*>(sc), static_cast<int*>(st), partial, grid);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename P>
int iterate(const void* pd_, const void* offsets_, int nd, const void* pda_,
            const void* offs_a_, int nda, void* work_, void* partial_,
            void* sc_, void* st_, long long n, int grid, int iters, int cap,
            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const P* pd = static_cast<const P*>(pd_);
  const long long* offs = static_cast<const long long*>(offsets_);
  const P* pda = static_cast<const P*>(pda_);
  const long long* offs_a = static_cast<const long long*>(offs_a_);
  T* work = static_cast<T*>(work_);
  T* partial = static_cast<T*>(partial_);
  T* sc = static_cast<T*>(sc_);
  int* st = static_cast<int*>(st_);
  for (int j = 0; j < iters; ++j) {
    gls_ap<T, P><<<grid, kThreads, 0, s>>>(pd, offs, nd, work, partial, st,
                                           n, cap);
    gls_xr<T><<<grid, kThreads, 0, s>>>(work, partial, sc, st, n);
    gls_ahr<T, P><<<grid, kThreads, 0, s>>>(pda, offs_a, nda, work, partial,
                                            sc, st, n);
    gls_p<T><<<grid, kThreads, 0, s>>>(work, partial, sc, st, n);
    gls_commit<T><<<1, kThreads, 0, s>>>(sc, st, partial, grid);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define KTT_GLS_INIT(NAME, T, P)                                              \
  extern "C" int NAME(const void* pda, const void* offsets_a, int nda,       \
                      const void* b, void* work, void* partial, void* sc,    \
                      void* st, long long n, int grid, void* stream) {       \
    return init<T, P>(pda, offsets_a, nda, b, work, partial, sc, st, n,      \
                      grid, stream);                                         \
  }

#define KTT_GLS_ITERATE(NAME, T, P)                                           \
  extern "C" int NAME(const void* pd, const void* offsets, int nd,           \
                      const void* pda, const void* offsets_a, int nda,       \
                      void* work, void* partial, void* sc, void* st,         \
                      long long n, int grid, int iters, int cap,             \
                      void* stream) {                                        \
    return iterate<T, P>(pd, offsets, nd, pda, offsets_a, nda, work,         \
                         partial, sc, st, n, grid, iters, cap, stream);      \
  }

KTT_GLS_INIT(ktt_cgls_dia_init_f32_f32, float, float)
KTT_GLS_INIT(ktt_cgls_dia_init_f32_bf16, float, __nv_bfloat16)
KTT_GLS_INIT(ktt_cgls_dia_init_f32_f16, float, __half)
KTT_GLS_INIT(ktt_cgls_dia_init_f64_f64, double, double)
KTT_GLS_ITERATE(ktt_cgls_dia_iterate_f32_f32, float, float)
KTT_GLS_ITERATE(ktt_cgls_dia_iterate_f32_bf16, float, __nv_bfloat16)
KTT_GLS_ITERATE(ktt_cgls_dia_iterate_f32_f16, float, __half)
KTT_GLS_ITERATE(ktt_cgls_dia_iterate_f64_f64, double, double)
