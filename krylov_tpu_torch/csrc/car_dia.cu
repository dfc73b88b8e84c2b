// Whole CAR (conjugate A-residuals, min ||A r||) solve of A x = b for a
// DIA matrix, M = I, on Hopper (sm_90a), with no grid-wide barrier.
//
// Replaces the TPU kernel krylov_tpu/ops/pallas_fused.py:879 car_dia_fused
// and computes what it computes (pallas_fused.py:903-960): x, niter,
// ||r||, ||A r|| and the status code (0 running / 1 solved / 2 zero
// residual).  Init applies the stencil twice (s = A r, t = A s); p, q, u
// and ||A r|| stay frozen on the solving step.
//
// Bound on an H100 SXM: memory bandwidth.  An iteration applies the
// stencil once (pd, 28 B per row in f32 for the 7-point stencil, 58.7 MB
// at 128^3, more than the 50 MB L2) and must read and write x, r, s, p, q
// and u: (28 + 48) B per row, about 159 MB at 128^3, so at least 47.6 us
// per iteration at 3.35 TB/s.
//
// Design.  Each iteration is a fixed sequence of five launches on the
// caller's stream, with no block waiting on another:
//   1. car_alpha      (1 block)  GO, alpha = rho / u'u
//   2. car_update     (grid)     x += alpha p, r -= alpha q, s -= alpha u,
//                                partials of r'r and s's
//   3. car_stencil    (grid)     t = A s, partials of s't
//   4. car_beta       (1 block)  ||r||, solved, beta, ||A r||, status, it
//   5. car_update_pqu (grid)     p = r + beta p, q = s + beta q,
//                                u = t + beta u, partials of u'u
// The stencil reads s's neighbours, so s is updated one launch before it
// and t has its own buffer.  The scalar state lives in two small device
// arrays; every launch returns at once when the solve has stopped, and
// the host reads the status once per chunk of iterations.  Reductions are
// two-level in a fixed order, so two runs give the same bits.  Per
// iteration this design moves 36 + (28 + 8) + 36 B per row in f32: 108 B.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kReduceThreads = 1024;

constexpr int RUNNING = 0;
constexpr int SOLVED = 1;
constexpr int ZERO_RESIDUAL = 2;

// slots of the scalar arrays; ATOL and RTOL are set by the host
enum ScalarSlot {
  RHO = 0, RNORM, ARNORM, EPS_LIM, ALPHA, BETA, ATOL, RTOL, NSC
};
enum IntSlot { IT = 0, STATUS, GO, STAY, NST };
// rows of the vector workspace and of the partials
enum Vec { VX = 0, VR, VP, VS, VQ, VT, VU, NVEC };
enum Part { PUU = 0, PRR, PSS, PST, NPART };

// x = 0, r = p = b, partials of b'b.
template <typename T>
__global__ void __launch_bounds__(kThreads)
car_init(const T* __restrict__ b, T* __restrict__ x, T* __restrict__ r,
         T* __restrict__ p, T* __restrict__ partial, long long n) {
  T s = T(0);
  for (long long i = ktt::first_row(); i < n; i += ktt::row_stride()) {
    const T bi = b[i];
    x[i] = T(0);
    r[i] = bi;
    p[i] = bi;
    s += bi * bi;
  }
  ktt::store_partial(s, partial);
}

// out = A in, copy = out (when given), partials of in'out and, when
// given, of out'out.  At init it runs ungated.
template <typename T, typename P>
__global__ void __launch_bounds__(kThreads)
car_stencil(const P* __restrict__ pd, const long long* __restrict__ offsets,
            int nd, const T* __restrict__ in, T* __restrict__ out,
            T* __restrict__ copy, T* __restrict__ partial_io,
            T* __restrict__ partial_oo, const int* st, long long n,
            bool gated) {
  if (gated && !st[GO]) return;
  T sio = T(0);
  T soo = T(0);
  for (long long i = ktt::first_row(); i < n; i += ktt::row_stride()) {
    const T acc = ktt::stencil_row(pd, offsets, nd, in, i, n);
    out[i] = acc;
    if (copy) copy[i] = acc;
    sio += acc * in[i];
    soo += acc * acc;
  }
  if (partial_oo) {
    ktt::store_partials(sio, partial_io, soo, partial_oo);
  } else {
    ktt::store_partial(sio, partial_io);
  }
}

// ||r0||, ||A r0||, rho0 = t's, eps_lim and the starting status.
template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
car_init_scalars(const T* __restrict__ partial, int nparts, T* sc, int* st) {
  const T rr = ktt::sum_partials(partial + PRR * nparts, nparts);
  __syncthreads();
  const T ss = ktt::sum_partials(partial + PSS * nparts, nparts);
  __syncthreads();
  const T rho = ktt::sum_partials(partial + PST * nparts, nparts);
  if (threadIdx.x != 0) return;
  const T rnorm = sqrt(rr);
  const T eps_lim = sc[ATOL] + sc[RTOL] * rnorm;
  sc[RHO] = rho;
  sc[RNORM] = rnorm;
  sc[ARNORM] = sqrt(ss);
  sc[EPS_LIM] = eps_lim;
  sc[ALPHA] = T(0);
  sc[BETA] = T(0);
  st[IT] = 0;
  st[STATUS] = rnorm == T(0) ? ZERO_RESIDUAL
               : (rnorm <= eps_lim ? SOLVED : RUNNING);
  st[GO] = 0;
  st[STAY] = 0;
}

// 1. Decide whether this iteration runs (GO), then alpha = rho / u'u.
template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
car_alpha(const T* __restrict__ partial, int nparts, T* sc, int* st, int cap) {
  const bool go = st[STATUS] == RUNNING && st[IT] < cap;
  if (!go) {
    if (threadIdx.x == 0) st[GO] = 0;
    return;
  }
  const T uu = ktt::sum_partials(partial + PUU * nparts, nparts);
  if (threadIdx.x != 0) return;
  sc[ALPHA] = sc[RHO] / (uu == T(0) ? T(1) : uu);
  st[GO] = 1;
}

// 2. x += alpha p, r -= alpha q, s -= alpha u, partials of r'r and s's.
template <typename T>
__global__ void __launch_bounds__(kThreads)
car_update(T* __restrict__ x, T* __restrict__ r, T* __restrict__ s_,
           const T* __restrict__ p, const T* __restrict__ q,
           const T* __restrict__ u, T* __restrict__ partial, const T* sc,
           const int* st, long long n) {
  if (!st[GO]) return;
  const T a = sc[ALPHA];
  T srr = T(0);
  T sss = T(0);
  for (long long i = ktt::first_row(); i < n; i += ktt::row_stride()) {
    x[i] = x[i] + a * p[i];
    const T ri = r[i] - a * q[i];
    r[i] = ri;
    const T si = s_[i] - a * u[i];
    s_[i] = si;
    srr += ri * ri;
    sss += si * si;
  }
  const int nparts = gridDim.x;
  ktt::store_partials(srr, partial + PRR * nparts, sss,
                      partial + PSS * nparts);
}

// 4. ||r||, the solved test, beta, ||A r|| = ||s||, status and it.
template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
car_beta(const T* __restrict__ partial, int nparts, T* sc, int* st) {
  if (!st[GO]) return;
  const T rr = ktt::sum_partials(partial + PRR * nparts, nparts);
  __syncthreads();
  const T ss = ktt::sum_partials(partial + PSS * nparts, nparts);
  __syncthreads();
  const T rho_next = ktt::sum_partials(partial + PST * nparts, nparts);
  if (threadIdx.x != 0) return;
  const T rho = sc[RHO];
  const T rnorm = sqrt(rr);
  const bool solved = rnorm <= sc[EPS_LIM] || (rnorm + T(1)) <= T(1);
  sc[RNORM] = rnorm;
  sc[BETA] = rho_next / (rho == T(0) ? T(1) : rho);
  if (!solved) {
    sc[ARNORM] = sqrt(ss);
    sc[RHO] = rho_next;
  }
  st[STAY] = solved ? 0 : 1;
  st[IT] += 1;
  st[STATUS] = solved ? SOLVED : RUNNING;
}

// 5. p = r + beta p, q = s + beta q, u = t + beta u, partials of u'u.
template <typename T>
__global__ void __launch_bounds__(kThreads)
car_update_pqu(const T* __restrict__ r, const T* __restrict__ s_,
               const T* __restrict__ t, T* __restrict__ p, T* __restrict__ q,
               T* __restrict__ u, T* __restrict__ partial, const T* sc,
               const int* st, long long n) {
  if (!st[GO] || !st[STAY]) return;
  const T beta = sc[BETA];
  T suu = T(0);
  for (long long i = ktt::first_row(); i < n; i += ktt::row_stride()) {
    p[i] = r[i] + beta * p[i];
    q[i] = s_[i] + beta * q[i];
    const T ui = t[i] + beta * u[i];
    u[i] = ui;
    suu += ui * ui;
  }
  ktt::store_partial(suu, partial);
}

template <typename T, typename P>
int init(const void* pd, const void* offsets, int nd, const void* b,
         void* work_, void* partial_, void* sc_, void* st_, long long n,
         int grid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const P* A = static_cast<const P*>(pd);
  const long long* offs = static_cast<const long long*>(offsets);
  T* work = static_cast<T*>(work_);
  T* partial = static_cast<T*>(partial_);
  int* st = static_cast<int*>(st_);
  car_init<T><<<grid, kThreads, 0, s>>>(static_cast<const T*>(b),
                                        work + VX * n, work + VR * n,
                                        work + VP * n, partial + PRR * grid, n);
  // s = q = A r with partials of s's; t = u = A s with partials of s't and
  // of u'u for the first alpha
  car_stencil<T, P><<<grid, kThreads, 0, s>>>(
      A, offs, nd, work + VR * n, work + VS * n, work + VQ * n,
      partial + PST * grid, partial + PSS * grid, st, n, false);
  car_stencil<T, P><<<grid, kThreads, 0, s>>>(
      A, offs, nd, work + VS * n, work + VT * n, work + VU * n,
      partial + PST * grid, partial + PUU * grid, st, n, false);
  car_init_scalars<T><<<1, kReduceThreads, 0, s>>>(partial, grid,
                                                   static_cast<T*>(sc_), st);
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
  T* x = work + VX * n;
  T* r = work + VR * n;
  T* p = work + VP * n;
  T* sv = work + VS * n;
  T* q = work + VQ * n;
  T* t = work + VT * n;
  T* u = work + VU * n;
  for (int k = 0; k < iters; ++k) {
    car_alpha<T><<<1, kReduceThreads, 0, s>>>(partial, grid, sc, st, cap);
    car_update<T><<<grid, kThreads, 0, s>>>(x, r, sv, p, q, u, partial, sc, st,
                                            n);
    car_stencil<T, P><<<grid, kThreads, 0, s>>>(
        A, offs, nd, sv, t, static_cast<T*>(nullptr), partial + PST * grid,
        static_cast<T*>(nullptr), st, n, true);
    car_beta<T><<<1, kReduceThreads, 0, s>>>(partial, grid, sc, st);
    car_update_pqu<T><<<grid, kThreads, 0, s>>>(r, sv, t, p, q, u,
                                                partial + PUU * grid, sc, st,
                                                n);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define KTT_CAR_INIT(NAME, T, P)                                              \
  extern "C" int NAME(const void* pd, const void* offsets, int nd,           \
                      const void* b, void* work, void* partial, void* sc,    \
                      void* st, long long n, int grid, void* stream) {       \
    return init<T, P>(pd, offsets, nd, b, work, partial, sc, st, n, grid,    \
                      stream);                                               \
  }

#define KTT_CAR_ITERATE(NAME, T, P)                                           \
  extern "C" int NAME(const void* pd, const void* offsets, int nd,           \
                      void* work, void* partial, void* sc, void* st,         \
                      long long n, int grid, int iters, int cap,             \
                      void* stream) {                                        \
    return iterate<T, P>(pd, offsets, nd, work, partial, sc, st, n, grid,    \
                         iters, cap, stream);                                \
  }

KTT_CAR_INIT(ktt_car_dia_init_f32_f32, float, float)
KTT_CAR_INIT(ktt_car_dia_init_f32_bf16, float, __nv_bfloat16)
KTT_CAR_INIT(ktt_car_dia_init_f32_f16, float, __half)
KTT_CAR_INIT(ktt_car_dia_init_f64_f64, double, double)
KTT_CAR_ITERATE(ktt_car_dia_iterate_f32_f32, float, float)
KTT_CAR_ITERATE(ktt_car_dia_iterate_f32_bf16, float, __nv_bfloat16)
KTT_CAR_ITERATE(ktt_car_dia_iterate_f32_f16, float, __half)
KTT_CAR_ITERATE(ktt_car_dia_iterate_f64_f64, double, double)
