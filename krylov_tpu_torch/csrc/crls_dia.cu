// Whole CRLS solve of min ||b - A x||^2 + lambda ||x||^2 for a DIA matrix
// on Hopper (sm_90a), with no grid-wide barrier.
//
// Replaces the TPU kernel krylov_tpu/ops/pallas_fused.py:3429
// crls_dia_fused and computes what it computes (pallas_fused.py:
// 3447-3516): CR on the normal equations over six vectors, x, r,
// Ar = A^H r, p, Ap and q = A^H Ap + lambda p; three stencils at the
// start (A^H b, A Ar, A^H Ap), then A on Ar and A^H on Ap each
// iteration; ||r|| with lambda is sqrt(||r||^2 + lambda ||x||^2), and the
// solve stops on ||Ar|| <= atol + rtol ||A^H b||.  Outputs: x, niter,
// ||r||, ||Ar|| and the status code (0 running, 1 solved, 2 zero
// residual).
//
// Bound on an H100 SXM: memory bandwidth.  An iteration applies A and
// A^H once each (2 x 28 B per row in f32 for the 7-point stencil) and
// must read and write x, r, Ar, p, Ap and q: (56 + 48) B per row, 104 B.
//
// Design: five launches per iteration, the scalar state on the device
// and the status read by the host once per chunk:
//   1. rls_xr     (grid)    GO decided here; alpha = gamma / ||q||^2
//                           summed in every block; x += alpha p,
//                           Ar -= alpha q, r -= alpha Ap; partials of
//                           ||Ar||^2, ||r||^2 (and ||x||^2 with lambda)
//   2. rls_av     (grid)    s = A Ar, partials of ||s||^2
//   3. rls_p      (grid)    gamma' = ||s||^2 + lambda ||Ar||^2 and
//                           beta = gamma' / gamma in every block;
//                           p = Ar + beta p, Ap = s + beta Ap
//   4. rls_q      (grid)    q = A^H Ap + lambda p, partials of ||q||^2
//   5. rls_commit (1 block) ||Ar||, ||r||, the test, gamma' and the
//                           iteration count
// Launch 2 reads Ar's neighbours and launch 4 Ap's, and neither writes
// the vector it reads so; the state the grid launches read is written
// only by the commit.  Per iteration this design moves 36 + (28 + 8) +
// 24 + (28 + 8) B per row in f32, 132 B (+ 8 with lambda).
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
enum Row { ROW_X = 0, ROW_R, ROW_AR, ROW_P, ROW_AP, ROW_Q, ROW_S, NROWS };
enum Part { PBB = 0, PARAR, PRR, PXX, PSS, PQQ, NPART };

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

// lambda where it is positive (pallas_fused.py:3478-3513)
template <typename T>
__device__ __forceinline__ bool lam_on(const T* sc) {
  return sc[LAM] > T(0);
}

// gamma' = ||s||^2 + lambda ||Ar||^2 from the sums, ||Ar|| = sqrt(ArAr)
// (pallas_fused.py:3492-3500).
template <typename T>
__device__ __forceinline__ T next_gamma(const T* sc, T ss, T arar,
                                        T& arnorm) {
  arnorm = sqrt(arar);
  return ss + (lam_on(sc) ? sc[LAM] * arnorm * arnorm : T(0));
}

// Init: x = 0, r = b, with the partials of b'b.
template <typename T>
__global__ void __launch_bounds__(kThreads)
rls_init_vectors(const T* __restrict__ b, T* __restrict__ work,
                 T* __restrict__ partial, long long n) {
  T s = T(0);
  for (long long i = first_row(); i < n; i += row_stride()) {
    const T bi = b[i];
    row(work, ROW_X, n)[i] = T(0);
    row(work, ROW_R, n)[i] = bi;
    s += bi * bi;
  }
  store_partial(s, partial + PBB * gridDim.x);
}

// Init: Ar = p = A^H b, with the partials of ||Ar||^2.
template <typename T, typename P>
__global__ void __launch_bounds__(kThreads)
rls_init_ar(const P* __restrict__ pda, const long long* __restrict__ offs_a,
            int nda, const T* __restrict__ b, T* __restrict__ work,
            T* __restrict__ partial, long long n) {
  T* ar = row(work, ROW_AR, n);
  T* p = row(work, ROW_P, n);
  T s = T(0);
  for (long long i = first_row(); i < n; i += row_stride()) {
    const T ai = stencil_row(pda, offs_a, nda, b, i, n);
    ar[i] = ai;
    p[i] = ai;
    s += ai * ai;
  }
  store_partial(s, partial + PARAR * gridDim.x);
}

// Init: Ap = s = A Ar, with the partials of ||s||^2.
template <typename T, typename P>
__global__ void __launch_bounds__(kThreads)
rls_init_ap(const P* __restrict__ pd, const long long* __restrict__ offsets,
            int nd, T* __restrict__ work, T* __restrict__ partial,
            long long n) {
  const T* ar = row(work, ROW_AR, n);
  T* ap = row(work, ROW_AP, n);
  T* s_ = row(work, ROW_S, n);
  T s = T(0);
  for (long long i = first_row(); i < n; i += row_stride()) {
    const T si = stencil_row(pd, offsets, nd, ar, i, n);
    ap[i] = si;
    s_[i] = si;
    s += si * si;
  }
  store_partial(s, partial + PSS * gridDim.x);
}

// 4 (and the last init launch). q = A^H Ap + lambda p and the partials of
// ||q||^2; the per-iteration launch returns when the solve has stopped.
template <typename T, typename P>
__global__ void __launch_bounds__(kThreads)
rls_q(const P* __restrict__ pda, const long long* __restrict__ offs_a,
      int nda, T* __restrict__ work, T* __restrict__ partial, const T* sc,
      const int* st, long long n) {
  if (st != nullptr && !st[GO]) return;
  const bool lam = lam_on(sc);
  const T* ap = row(work, ROW_AP, n);
  const T* p = row(work, ROW_P, n);
  T* q = row(work, ROW_Q, n);
  T s = T(0);
  for (long long i = first_row(); i < n; i += row_stride()) {
    T qi = stencil_row(pda, offs_a, nda, ap, i, n);
    if (lam) qi = qi + sc[LAM] * p[i];
    q[i] = qi;
    s += qi * qi;
  }
  store_partial(s, partial + PQQ * gridDim.x);
}

// Init: ||b||, ||A^H b||, gamma_0, eps and the status (pallas_fused.py:
// 3455-3476).
template <typename T>
__global__ void __launch_bounds__(kThreads)
rls_init_state(T* sc, int* st, const T* __restrict__ partial, int nparts) {
  const T bb = sum_partials(partial + PBB * nparts, nparts);
  __syncthreads();
  const T arar = sum_partials(partial + PARAR * nparts, nparts);
  __syncthreads();
  const T ss = sum_partials(partial + PSS * nparts, nparts);
  if (threadIdx.x != 0) return;
  const T rnorm = sqrt(bb);
  T arnorm;
  sc[GAMMA] = next_gamma(sc, ss, arar, arnorm);
  const T eps_lim = sc[ATOL] + sc[RTOL] * arnorm;
  sc[RNORM] = rnorm;
  sc[ARNORM] = arnorm;
  sc[EPS_LIM] = eps_lim;
  st[IT] = 0;
  st[STATUS] = rnorm == T(0)      ? ZERO_RESIDUAL
               : arnorm <= eps_lim ? SOLVED
                                   : RUNNING;
  st[GO] = 0;
}

// 1. GO; alpha = gamma / ||q||^2; x += alpha p, Ar -= alpha q,
// r -= alpha Ap, with the partials of ||Ar||^2, ||r||^2 and, with
// lambda, ||x||^2.
template <typename T>
__global__ void __launch_bounds__(kThreads)
rls_xr(T* __restrict__ work, T* __restrict__ partial, const T* sc, int* st,
       long long n, int cap) {
  const bool go = st[STATUS] == RUNNING && st[IT] < cap;
  if (blockIdx.x == 0 && threadIdx.x == 0) st[GO] = go ? 1 : 0;
  if (!go) return;
  const int nparts = gridDim.x;
  const T alpha = sc[GAMMA] / safe(all_sum(partial + PQQ * nparts, nparts));
  const bool lam = lam_on(sc);
  const T* p = row(work, ROW_P, n);
  const T* q = row(work, ROW_Q, n);
  const T* ap = row(work, ROW_AP, n);
  T* x = row(work, ROW_X, n);
  T* ar = row(work, ROW_AR, n);
  T* r = row(work, ROW_R, n);
  T sar = T(0);
  T srr = T(0);
  T sxx = T(0);
  for (long long i = first_row(); i < n; i += row_stride()) {
    const T xi = x[i] + alpha * p[i];
    x[i] = xi;
    const T ai = ar[i] - alpha * q[i];
    ar[i] = ai;
    const T ri = r[i] - alpha * ap[i];
    r[i] = ri;
    sar += ai * ai;
    srr += ri * ri;
    sxx += xi * xi;
  }
  store_partials(sar, partial + PARAR * nparts, srr, partial + PRR * nparts);
  if (lam) {
    __syncthreads();
    store_partial(sxx, partial + PXX * nparts);
  }
}

// 2. s = A Ar and the partials of ||s||^2.
template <typename T, typename P>
__global__ void __launch_bounds__(kThreads)
rls_av(const P* __restrict__ pd, const long long* __restrict__ offsets,
       int nd, T* __restrict__ work, T* __restrict__ partial, const int* st,
       long long n) {
  if (!st[GO]) return;
  const T* ar = row(work, ROW_AR, n);
  T* s_ = row(work, ROW_S, n);
  T s = T(0);
  for (long long i = first_row(); i < n; i += row_stride()) {
    const T si = stencil_row(pd, offsets, nd, ar, i, n);
    s_[i] = si;
    s += si * si;
  }
  store_partial(s, partial + PSS * gridDim.x);
}

// 3. beta = gamma' / gamma; p = Ar + beta p, Ap = s + beta Ap.
template <typename T>
__global__ void __launch_bounds__(kThreads)
rls_p(T* __restrict__ work, const T* __restrict__ partial, const T* sc,
      const int* st, long long n) {
  if (!st[GO]) return;
  const int nparts = gridDim.x;
  const T ss = all_sum(partial + PSS * nparts, nparts);
  const T arar = all_sum(partial + PARAR * nparts, nparts);
  T arnorm;
  const T beta = next_gamma(sc, ss, arar, arnorm) / safe(sc[GAMMA]);
  const T* ar = row(work, ROW_AR, n);
  const T* s_ = row(work, ROW_S, n);
  T* p = row(work, ROW_P, n);
  T* ap = row(work, ROW_AP, n);
  for (long long i = first_row(); i < n; i += row_stride()) {
    p[i] = ar[i] + beta * p[i];
    ap[i] = s_[i] + beta * ap[i];
  }
}

// 5. The commit: ||Ar||, ||r|| (with lambda sqrt(||r||^2 + lambda
// ||x||^2)), the test and the next state (pallas_fused.py:3486-3513).
template <typename T>
__global__ void __launch_bounds__(kThreads)
rls_commit(T* sc, int* st, const T* __restrict__ partial, int nparts) {
  if (!st[GO]) return;
  const T ss = sum_partials(partial + PSS * nparts, nparts);
  __syncthreads();
  const T arar = sum_partials(partial + PARAR * nparts, nparts);
  __syncthreads();
  const T rr = sum_partials(partial + PRR * nparts, nparts);
  __syncthreads();
  const T xx = lam_on(sc) ? sum_partials(partial + PXX * nparts, nparts)
                          : T(0);
  if (threadIdx.x != 0) return;
  T arnorm;
  sc[GAMMA] = next_gamma(sc, ss, arar, arnorm);
  sc[ARNORM] = arnorm;
  sc[RNORM] = lam_on(sc) ? sqrt(rr + sc[LAM] * xx) : sqrt(rr);
  st[STATUS] = arnorm <= sc[EPS_LIM] ? SOLVED : RUNNING;
  st[IT] = st[IT] + 1;
}

template <typename T, typename P>
int init(const void* pd_, const void* offsets_, int nd, const void* pda_,
         const void* offs_a_, int nda, const void* b_, void* work_,
         void* partial_, void* sc_, void* st, long long n, int grid,
         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const P* pd = static_cast<const P*>(pd_);
  const long long* offs = static_cast<const long long*>(offsets_);
  const P* pda = static_cast<const P*>(pda_);
  const long long* offs_a = static_cast<const long long*>(offs_a_);
  const T* b = static_cast<const T*>(b_);
  T* work = static_cast<T*>(work_);
  T* partial = static_cast<T*>(partial_);
  T* sc = static_cast<T*>(sc_);
  rls_init_vectors<T><<<grid, kThreads, 0, s>>>(b, work, partial, n);
  rls_init_ar<T, P><<<grid, kThreads, 0, s>>>(pda, offs_a, nda, b, work,
                                              partial, n);
  rls_init_ap<T, P><<<grid, kThreads, 0, s>>>(pd, offs, nd, work, partial,
                                              n);
  rls_q<T, P><<<grid, kThreads, 0, s>>>(pda, offs_a, nda, work, partial, sc,
                                        nullptr, n);
  rls_init_state<T><<<1, kThreads, 0, s>>>(sc, static_cast<int*>(st),
                                           partial, grid);
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
    rls_xr<T><<<grid, kThreads, 0, s>>>(work, partial, sc, st, n, cap);
    rls_av<T, P><<<grid, kThreads, 0, s>>>(pd, offs, nd, work, partial, st,
                                           n);
    rls_p<T><<<grid, kThreads, 0, s>>>(work, partial, sc, st, n);
    rls_q<T, P><<<grid, kThreads, 0, s>>>(pda, offs_a, nda, work, partial,
                                          sc, st, n);
    rls_commit<T><<<1, kThreads, 0, s>>>(sc, st, partial, grid);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define KTT_RLS_INIT(NAME, T, P)                                              \
  extern "C" int NAME(const void* pd, const void* offsets, int nd,           \
                      const void* pda, const void* offsets_a, int nda,       \
                      const void* b, void* work, void* partial, void* sc,    \
                      void* st, long long n, int grid, void* stream) {       \
    return init<T, P>(pd, offsets, nd, pda, offsets_a, nda, b, work,         \
                      partial, sc, st, n, grid, stream);                     \
  }

#define KTT_RLS_ITERATE(NAME, T, P)                                           \
  extern "C" int NAME(const void* pd, const void* offsets, int nd,           \
                      const void* pda, const void* offsets_a, int nda,       \
                      void* work, void* partial, void* sc, void* st,         \
                      long long n, int grid, int iters, int cap,             \
                      void* stream) {                                        \
    return iterate<T, P>(pd, offsets, nd, pda, offsets_a, nda, work,         \
                         partial, sc, st, n, grid, iters, cap, stream);      \
  }

KTT_RLS_INIT(ktt_crls_dia_init_f32_f32, float, float)
KTT_RLS_INIT(ktt_crls_dia_init_f32_bf16, float, __nv_bfloat16)
KTT_RLS_INIT(ktt_crls_dia_init_f32_f16, float, __half)
KTT_RLS_INIT(ktt_crls_dia_init_f64_f64, double, double)
KTT_RLS_ITERATE(ktt_crls_dia_iterate_f32_f32, float, float)
KTT_RLS_ITERATE(ktt_crls_dia_iterate_f32_bf16, float, __nv_bfloat16)
KTT_RLS_ITERATE(ktt_crls_dia_iterate_f32_f16, float, __half)
KTT_RLS_ITERATE(ktt_crls_dia_iterate_f64_f64, double, double)
