// Whole CGS solve of A x = b for a DIA matrix, M = N = I, shadow vector
// c = b, on Hopper (sm_90a), with no grid-wide barrier.
//
// Replaces the TPU kernel krylov_tpu/ops/pallas_fused.py:3149
// cgs_dia_fused and computes what it computes (pallas_fused.py:
// 3180-3230): x, niter, rnorm and the status code (0 running / 1 solved
// / 2 zero residual / 29 b'c = 0 / 30 alpha == 0 or NaN).
//
// Bound on an H100 SXM: memory bandwidth.  An iteration applies the
// stencil twice (2 x 28 B per row in f32 for the 7-point stencil) and
// must read b, r, u, p and q and write x, r, u, p and q once each, and
// read and write x: (56 + 44) B per row, about 210 MB at 128^3, at
// least 62.6 us per iteration at 3.35 TB/s.
//
// Design.  Each iteration is a fixed sequence of five launches on the
// caller's stream, with no block waiting on another; alpha, which the
// second launch needs, is summed by every block of it from the block
// partials in a fixed order:
//   1. cgs_stencil_t (grid)    GO, t = A p, partials of <b, t>
//   2. cgs_update_q  (grid)    alpha = rho / <b, t>; q = u - alpha t,
//                              uh = u + q, x += alpha uh
//   3. cgs_stencil_r (grid)    r -= alpha A uh, partials of <b, r>, <r, r>
//   4. cgs_beta      (1 block) rho, beta, ||r||, the status, it
//   5. cgs_update_up (grid)    u = r + beta q, p = u + beta (q + beta p)
// The stencil launches read the neighbours of p and of uh (u + q, a
// buffer of its own) and write t and r only; launch 5 reads the old p
// row by row, so no copy of it is kept.  The scalars live on the
// device; every launch returns at once when the solve has stopped, and
// the host reads the status once per chunk of iterations.  Per
// iteration this design moves (28 + 12) + (16 + 16) + (28 + 16)
// + (12 + 12) B per row in f32: 140 B.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kReduceThreads = 1024;

constexpr int RUNNING = 0;
constexpr int SOLVED = 1;
constexpr int ZERO_RESIDUAL = 2;
constexpr int BC_BREAKDOWN = 29;
constexpr int ALPHA_BREAKDOWN = 30;

// slots of the scalar arrays; ATOL and RTOL are set by the host
enum ScalarSlot { ATOL = 0, RTOL, EPS_LIM, RHO, RNORM, ALPHA, BETA, NSC };
enum IntSlot { IT = 0, STATUS, GO, NST };
// rows of the vector workspace and of the partials
enum Vec { VX = 0, VR, VU, VP, VQ, VUH, VT, NVEC };
enum Part { PBT = 0, PBR, PRR, NPART };

// x = 0, r = u = p = b, partials of b'b.
template <typename T>
__global__ void __launch_bounds__(kThreads)
cgs_init(const T* __restrict__ b, T* __restrict__ work,
         T* __restrict__ partial, long long n) {
  T s = T(0);
  for (long long i = ktt::first_row(); i < n; i += ktt::row_stride()) {
    const T bi = b[i];
    work[VX * n + i] = T(0);
    work[VR * n + i] = bi;
    work[VU * n + i] = bi;
    work[VP * n + i] = bi;
    s += bi * bi;
  }
  ktt::store_partial(s, partial + PRR * gridDim.x);
}

// ||b||, rho = <b, b>, eps_lim and the starting status.
template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
cgs_init_scalars(const T* __restrict__ partial, int nparts, T* sc, int* st) {
  const T bb = ktt::sum_partials(partial + PRR * nparts, nparts);
  if (threadIdx.x != 0) return;
  const T rnorm = sqrt(bb);
  const T eps_lim = sc[ATOL] + sc[RTOL] * rnorm;
  sc[EPS_LIM] = eps_lim;
  sc[RHO] = bb;
  sc[RNORM] = rnorm;
  sc[ALPHA] = T(0);
  sc[BETA] = T(0);
  st[IT] = 0;
  st[STATUS] = rnorm == T(0) ? ZERO_RESIDUAL
               : bb == T(0) ? BC_BREAKDOWN
               : rnorm <= eps_lim ? SOLVED : RUNNING;
  st[GO] = 0;
}

// 1. Decide whether this iteration runs (GO, read by launches 2-5), then
// t = A p and the partials of <b, t>.
template <typename T, typename P>
__global__ void __launch_bounds__(kThreads)
cgs_stencil_t(const P* __restrict__ pd, const long long* __restrict__ offsets,
              int nd, const T* __restrict__ b, T* __restrict__ work,
              T* __restrict__ partial, int* st, long long n, int cap) {
  const bool go = st[STATUS] == RUNNING && st[IT] < cap;
  if (blockIdx.x == 0 && threadIdx.x == 0) st[GO] = go ? 1 : 0;
  if (!go) return;
  const T* p = work + VP * n;
  T* t = work + VT * n;
  T s = T(0);
  for (long long i = ktt::first_row(); i < n; i += ktt::row_stride()) {
    const T ti = ktt::stencil_row(pd, offsets, nd, p, i, n);
    t[i] = ti;
    s += b[i] * ti;
  }
  ktt::store_partial(s, partial + PBT * gridDim.x);
}

// 2. alpha = rho / <b, t> (summed in every block); q = u - alpha t,
// uh = u + q, x += alpha uh.
template <typename T>
__global__ void __launch_bounds__(kThreads)
cgs_update_q(T* __restrict__ work, const T* __restrict__ partial, T* sc,
             const int* st, long long n) {
  if (!st[GO]) return;
  __shared__ T bt_shared;
  const T bt = ktt::sum_partials(partial + PBT * gridDim.x, gridDim.x);
  if (threadIdx.x == 0) bt_shared = bt;
  __syncthreads();
  const T alpha = sc[RHO] / ktt::safe(bt_shared);
  if (blockIdx.x == 0 && threadIdx.x == 0) sc[ALPHA] = alpha;
  T* x = work + VX * n;
  const T* u = work + VU * n;
  T* q = work + VQ * n;
  T* uh = work + VUH * n;
  const T* t = work + VT * n;
  for (long long i = ktt::first_row(); i < n; i += ktt::row_stride()) {
    const T ui = u[i];
    const T qi = ui - alpha * t[i];
    const T uhi = ui + qi;
    q[i] = qi;
    uh[i] = uhi;
    x[i] = x[i] + alpha * uhi;
  }
}

// 3. r -= alpha A uh, partials of <b, r> and <r, r>.
template <typename T, typename P>
__global__ void __launch_bounds__(kThreads)
cgs_stencil_r(const P* __restrict__ pd, const long long* __restrict__ offsets,
              int nd, const T* __restrict__ b, T* __restrict__ work,
              T* __restrict__ partial, const T* sc, const int* st,
              long long n) {
  if (!st[GO]) return;
  const T alpha = sc[ALPHA];
  const T* uh = work + VUH * n;
  T* r = work + VR * n;
  T sbr = T(0);
  T srr = T(0);
  for (long long i = ktt::first_row(); i < n; i += ktt::row_stride()) {
    const T ri = r[i] - alpha * ktt::stencil_row(pd, offsets, nd, uh, i, n);
    r[i] = ri;
    sbr += b[i] * ri;
    srr += ri * ri;
  }
  const int nparts = gridDim.x;
  ktt::store_partials(sbr, partial + PBR * nparts, srr,
                      partial + PRR * nparts);
}

// 4. rho, beta, ||r||, the status chain (pallas_fused.py:3222-3230), it.
template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
cgs_beta(const T* __restrict__ partial, int nparts, T* sc, int* st) {
  if (!st[GO]) return;
  const T rho_next = ktt::sum_partials(partial + PBR * nparts, nparts);
  __syncthreads();
  const T rr = ktt::sum_partials(partial + PRR * nparts, nparts);
  if (threadIdx.x != 0) return;
  const T alpha = sc[ALPHA];
  sc[BETA] = rho_next / ktt::safe(sc[RHO]);
  sc[RHO] = rho_next;
  const T rnorm = sqrt(rr);
  sc[RNORM] = rnorm;
  const bool solved = rnorm <= sc[EPS_LIM] || (rnorm + T(1)) <= T(1);
  const bool breakdown = alpha == T(0) || isnan(alpha);
  st[IT] += 1;
  st[STATUS] = solved ? SOLVED : (breakdown ? ALPHA_BREAKDOWN : RUNNING);
}

// 5. u = r + beta q, p = u + beta (q + beta p).
template <typename T>
__global__ void __launch_bounds__(kThreads)
cgs_update_up(T* __restrict__ work, const T* sc, const int* st,
              long long n) {
  if (!st[GO]) return;
  const T beta = sc[BETA];
  const T* r = work + VR * n;
  T* u = work + VU * n;
  T* p = work + VP * n;
  const T* q = work + VQ * n;
  for (long long i = ktt::first_row(); i < n; i += ktt::row_stride()) {
    const T qi = q[i];
    const T ui = r[i] + beta * qi;
    u[i] = ui;
    p[i] = ui + beta * (qi + beta * p[i]);
  }
}

template <typename T>
int init(const void* b, void* work, void* partial_, void* sc, void* st,
         long long n, int grid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  T* partial = static_cast<T*>(partial_);
  cgs_init<T><<<grid, kThreads, 0, s>>>(static_cast<const T*>(b),
                                        static_cast<T*>(work), partial, n);
  cgs_init_scalars<T><<<1, kReduceThreads, 0, s>>>(
      partial, grid, static_cast<T*>(sc), static_cast<int*>(st));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename P>
int iterate(const void* pd, const void* offsets, int nd, const void* b_,
            void* work_, void* partial_, void* sc_, void* st_, long long n,
            int grid, int iters, int cap, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const P* A = static_cast<const P*>(pd);
  const long long* offs = static_cast<const long long*>(offsets);
  const T* b = static_cast<const T*>(b_);
  T* work = static_cast<T*>(work_);
  T* partial = static_cast<T*>(partial_);
  T* sc = static_cast<T*>(sc_);
  int* st = static_cast<int*>(st_);
  for (int k = 0; k < iters; ++k) {
    cgs_stencil_t<T, P><<<grid, kThreads, 0, s>>>(A, offs, nd, b, work,
                                                  partial, st, n, cap);
    cgs_update_q<T><<<grid, kThreads, 0, s>>>(work, partial, sc, st, n);
    cgs_stencil_r<T, P><<<grid, kThreads, 0, s>>>(A, offs, nd, b, work,
                                                  partial, sc, st, n);
    cgs_beta<T><<<1, kReduceThreads, 0, s>>>(partial, grid, sc, st);
    cgs_update_up<T><<<grid, kThreads, 0, s>>>(work, sc, st, n);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define KTT_CGS_INIT(NAME, T)                                                 \
  extern "C" int NAME(const void* b, void* work, void* partial, void* sc,    \
                      void* st, long long n, int grid, void* stream) {       \
    return init<T>(b, work, partial, sc, st, n, grid, stream);               \
  }

#define KTT_CGS_ITERATE(NAME, T, P)                                           \
  extern "C" int NAME(const void* pd, const void* offsets, int nd,           \
                      const void* b, void* work, void* partial, void* sc,    \
                      void* st, long long n, int grid, int iters, int cap,   \
                      void* stream) {                                        \
    return iterate<T, P>(pd, offsets, nd, b, work, partial, sc, st, n, grid, \
                         iters, cap, stream);                                \
  }

KTT_CGS_INIT(ktt_cgs_dia_init_f32, float)
KTT_CGS_INIT(ktt_cgs_dia_init_f64, double)
KTT_CGS_ITERATE(ktt_cgs_dia_iterate_f32_f32, float, float)
KTT_CGS_ITERATE(ktt_cgs_dia_iterate_f32_bf16, float, __nv_bfloat16)
KTT_CGS_ITERATE(ktt_cgs_dia_iterate_f32_f16, float, __half)
KTT_CGS_ITERATE(ktt_cgs_dia_iterate_f64_f64, double, double)
