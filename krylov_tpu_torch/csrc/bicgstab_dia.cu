// Whole BiCGSTAB solve of A x = b for a DIA matrix, M = N = I, shadow
// vector c = b, on Hopper (sm_90a), with no grid-wide barrier.
//
// Replaces the TPU kernel krylov_tpu/ops/pallas_fused.py:3016
// bicgstab_dia_fused and computes what it computes (pallas_fused.py:
// 3049-3090): x, niter, rnorm and the status code (0 running / 1 solved
// / 2 zero residual / 29 b'c = 0 / 30 alpha == 0 or NaN), with x moved
// as (x + alpha p) + omega s, in that rounding order.
//
// Bound on an H100 SXM: memory bandwidth.  An iteration applies the
// stencil twice (2 x 28 B per row in f32 for the 7-point stencil) and
// must read b, r, p, v and s and write x, r, p, v, s and t once each:
// (56 + 40) B per row, about 201 MB at 128^3, at least 60.1 us per
// iteration at 3.35 TB/s.
//
// Design.  Each iteration is a fixed sequence of six launches on the
// caller's stream, with no block waiting on another.  A reduction that
// the next grid launch needs is summed by every block of that launch
// from the block partials, in a fixed order, so every block holds the
// same value and no one-block launch sits between them:
//   1. bs_stencil_v (grid)  GO, v = A p, partials of <b, v>
//   2. bs_update_s  (grid)  alpha = rho / <b, v>; s = r - alpha v,
//                           x += alpha p
//   3. bs_stencil_t (grid)  t = A s, partials of <t, s> and <t, t>
//   4. bs_update_r  (grid)  omega = <t, s> / <t, t>; x += omega s,
//                           r = s - omega t, partials of <b, r>, <r, r>
//   5. bs_beta      (1 block) rho, beta, ||r||, the status, it
//   6. bs_update_p  (grid)  p = r + beta (p - omega v)
// p and s live in separate buffers: the stencil launches read the
// neighbours of p and s and write v and t only.  The scalars live on the
// device; every launch returns at once when the solve has stopped, and
// the host reads the status once per chunk of iterations.  Per
// iteration this design moves (28 + 12) + (8 + 20) + (28 + 12)
// + (16 + 20) + 16 B per row in f32: 160 B.
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
enum ScalarSlot {
  ATOL = 0, RTOL, EPS_LIM, RHO, RNORM, ALPHA, OMEGA, BETA, NSC
};
enum IntSlot { IT = 0, STATUS, GO, NST };
// rows of the vector workspace and of the partials
enum Vec { VX = 0, VR, VP, VV, VS, VT, NVEC };
enum Part { PBV = 0, PTS, PTT, PBR, PRR, NPART };

// The same sum of block partials in every block of a launch.
template <typename T>
__device__ __forceinline__ T all_sum(const T* partial, int nparts) {
  __shared__ T sum;
  const T s = ktt::sum_partials(partial, nparts);
  if (threadIdx.x == 0) sum = s;
  __syncthreads();
  return sum;
}

// x = 0, r = p = b, partials of b'b.
template <typename T>
__global__ void __launch_bounds__(kThreads)
bs_init(const T* __restrict__ b, T* __restrict__ work, T* __restrict__ partial,
        long long n) {
  T s = T(0);
  for (long long i = ktt::first_row(); i < n; i += ktt::row_stride()) {
    const T bi = b[i];
    work[VX * n + i] = T(0);
    work[VR * n + i] = bi;
    work[VP * n + i] = bi;
    s += bi * bi;
  }
  ktt::store_partial(s, partial + PRR * gridDim.x);
}

// ||b||, rho = <b, b>, eps_lim and the starting status.
template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
bs_init_scalars(const T* __restrict__ partial, int nparts, T* sc, int* st) {
  const T bb = ktt::sum_partials(partial + PRR * nparts, nparts);
  if (threadIdx.x != 0) return;
  const T rnorm = sqrt(bb);
  const T eps_lim = sc[ATOL] + sc[RTOL] * rnorm;
  sc[EPS_LIM] = eps_lim;
  sc[RHO] = bb;
  sc[RNORM] = rnorm;
  sc[ALPHA] = T(0);
  sc[OMEGA] = T(0);
  sc[BETA] = T(0);
  st[IT] = 0;
  st[STATUS] = rnorm == T(0) ? ZERO_RESIDUAL
               : bb == T(0) ? BC_BREAKDOWN
               : rnorm <= eps_lim ? SOLVED : RUNNING;
  st[GO] = 0;
}

// 1. Decide whether this iteration runs (GO, read by launches 2-6), then
// v = A p and the partials of <b, v>.
template <typename T, typename P>
__global__ void __launch_bounds__(kThreads)
bs_stencil_v(const P* __restrict__ pd, const long long* __restrict__ offsets,
             int nd, const T* __restrict__ b, T* __restrict__ work,
             T* __restrict__ partial, int* st, long long n, int cap) {
  const bool go = st[STATUS] == RUNNING && st[IT] < cap;
  if (blockIdx.x == 0 && threadIdx.x == 0) st[GO] = go ? 1 : 0;
  if (!go) return;
  const T* p = work + VP * n;
  T* v = work + VV * n;
  T s = T(0);
  for (long long i = ktt::first_row(); i < n; i += ktt::row_stride()) {
    const T vi = ktt::stencil_row(pd, offsets, nd, p, i, n);
    v[i] = vi;
    s += b[i] * vi;
  }
  ktt::store_partial(s, partial + PBV * gridDim.x);
}

// 2. alpha = rho / <b, v>; s = r - alpha v, x += alpha p.
template <typename T>
__global__ void __launch_bounds__(kThreads)
bs_update_s(T* __restrict__ work, const T* __restrict__ partial, T* sc,
            const int* st, long long n) {
  if (!st[GO]) return;
  const T bv = all_sum(partial + PBV * gridDim.x, gridDim.x);
  const T alpha = sc[RHO] / ktt::safe(bv);
  if (blockIdx.x == 0 && threadIdx.x == 0) sc[ALPHA] = alpha;
  T* x = work + VX * n;
  const T* r = work + VR * n;
  const T* p = work + VP * n;
  const T* v = work + VV * n;
  T* s = work + VS * n;
  for (long long i = ktt::first_row(); i < n; i += ktt::row_stride()) {
    s[i] = r[i] - alpha * v[i];
    x[i] = x[i] + alpha * p[i];
  }
}

// 3. t = A s, partials of <t, s> and <t, t>.
template <typename T, typename P>
__global__ void __launch_bounds__(kThreads)
bs_stencil_t(const P* __restrict__ pd, const long long* __restrict__ offsets,
             int nd, T* __restrict__ work, T* __restrict__ partial,
             const int* st, long long n) {
  if (!st[GO]) return;
  const T* s = work + VS * n;
  T* t = work + VT * n;
  T sts = T(0);
  T stt = T(0);
  for (long long i = ktt::first_row(); i < n; i += ktt::row_stride()) {
    const T ti = ktt::stencil_row(pd, offsets, nd, s, i, n);
    t[i] = ti;
    sts += ti * s[i];
    stt += ti * ti;
  }
  const int nparts = gridDim.x;
  ktt::store_partials(sts, partial + PTS * nparts, stt,
                      partial + PTT * nparts);
}

// 4. omega = <t, s> / <t, t>; x += omega s, r = s - omega t, partials of
// <b, r> and <r, r>.
template <typename T>
__global__ void __launch_bounds__(kThreads)
bs_update_r(const T* __restrict__ b, T* __restrict__ work,
            T* __restrict__ partial, T* sc, const int* st, long long n) {
  if (!st[GO]) return;
  const int nparts = gridDim.x;
  const T ts = all_sum(partial + PTS * nparts, nparts);
  __syncthreads();
  const T tt = all_sum(partial + PTT * nparts, nparts);
  const T omega = ts / ktt::safe(tt);
  if (blockIdx.x == 0 && threadIdx.x == 0) sc[OMEGA] = omega;
  T* x = work + VX * n;
  T* r = work + VR * n;
  const T* s = work + VS * n;
  const T* t = work + VT * n;
  T sbr = T(0);
  T srr = T(0);
  for (long long i = ktt::first_row(); i < n; i += ktt::row_stride()) {
    const T si = s[i];
    x[i] = x[i] + omega * si;
    const T ri = si - omega * t[i];
    r[i] = ri;
    sbr += b[i] * ri;
    srr += ri * ri;
  }
  __syncthreads();
  ktt::store_partials(sbr, partial + PBR * nparts, srr,
                      partial + PRR * nparts);
}

// 5. rho, beta, ||r||, the status chain (pallas_fused.py:3080-3090), it.
template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
bs_beta(const T* __restrict__ partial, int nparts, T* sc, int* st) {
  if (!st[GO]) return;
  const T next_rho = ktt::sum_partials(partial + PBR * nparts, nparts);
  __syncthreads();
  const T rr = ktt::sum_partials(partial + PRR * nparts, nparts);
  if (threadIdx.x != 0) return;
  const T alpha = sc[ALPHA];
  const T omega = sc[OMEGA];
  sc[BETA] = (next_rho / ktt::safe(sc[RHO])) * (alpha / ktt::safe(omega));
  sc[RHO] = next_rho;
  const T rnorm = sqrt(rr);
  sc[RNORM] = rnorm;
  const bool solved = rnorm <= sc[EPS_LIM] || (rnorm + T(1)) <= T(1);
  const bool breakdown = alpha == T(0) || isnan(alpha);
  st[IT] += 1;
  st[STATUS] = solved ? SOLVED : (breakdown ? ALPHA_BREAKDOWN : RUNNING);
}

// 6. p = r + beta (p - omega v).
template <typename T>
__global__ void __launch_bounds__(kThreads)
bs_update_p(T* __restrict__ work, const T* sc, const int* st, long long n) {
  if (!st[GO]) return;
  const T beta = sc[BETA];
  const T omega = sc[OMEGA];
  const T* r = work + VR * n;
  T* p = work + VP * n;
  const T* v = work + VV * n;
  for (long long i = ktt::first_row(); i < n; i += ktt::row_stride()) {
    p[i] = r[i] + beta * (p[i] - omega * v[i]);
  }
}

template <typename T>
int init(const void* b, void* work, void* partial_, void* sc, void* st,
         long long n, int grid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  T* partial = static_cast<T*>(partial_);
  bs_init<T><<<grid, kThreads, 0, s>>>(static_cast<const T*>(b),
                                       static_cast<T*>(work), partial, n);
  bs_init_scalars<T><<<1, kReduceThreads, 0, s>>>(
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
    bs_stencil_v<T, P><<<grid, kThreads, 0, s>>>(A, offs, nd, b, work,
                                                 partial, st, n, cap);
    bs_update_s<T><<<grid, kThreads, 0, s>>>(work, partial, sc, st, n);
    bs_stencil_t<T, P><<<grid, kThreads, 0, s>>>(A, offs, nd, work, partial,
                                                 st, n);
    bs_update_r<T><<<grid, kThreads, 0, s>>>(b, work, partial, sc, st, n);
    bs_beta<T><<<1, kReduceThreads, 0, s>>>(partial, grid, sc, st);
    bs_update_p<T><<<grid, kThreads, 0, s>>>(work, sc, st, n);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define KTT_BS_INIT(NAME, T)                                                  \
  extern "C" int NAME(const void* b, void* work, void* partial, void* sc,    \
                      void* st, long long n, int grid, void* stream) {       \
    return init<T>(b, work, partial, sc, st, n, grid, stream);               \
  }

#define KTT_BS_ITERATE(NAME, T, P)                                            \
  extern "C" int NAME(const void* pd, const void* offsets, int nd,           \
                      const void* b, void* work, void* partial, void* sc,    \
                      void* st, long long n, int grid, int iters, int cap,   \
                      void* stream) {                                        \
    return iterate<T, P>(pd, offsets, nd, b, work, partial, sc, st, n, grid, \
                         iters, cap, stream);                                \
  }

KTT_BS_INIT(ktt_bicgstab_dia_init_f32, float)
KTT_BS_INIT(ktt_bicgstab_dia_init_f64, double)
KTT_BS_ITERATE(ktt_bicgstab_dia_iterate_f32_f32, float, float)
KTT_BS_ITERATE(ktt_bicgstab_dia_iterate_f32_bf16, float, __nv_bfloat16)
KTT_BS_ITERATE(ktt_bicgstab_dia_iterate_f32_f16, float, __half)
KTT_BS_ITERATE(ktt_bicgstab_dia_iterate_f64_f64, double, double)
