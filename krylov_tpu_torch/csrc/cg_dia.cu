// Whole CG solve of A x = b for a DIA matrix, M = I or Jacobi, on Hopper
// (sm_90a), with no grid-wide barrier.
//
// Replaces the TPU kernel krylov_tpu/ops/pallas_fused.py:73 cg_dia_fused
// and computes what it computes: x, niter, rnorm (sqrt(r'z) with
// Jacobi), the status code (0 running / 1 solved / 2 zero residual / 5
// zero curvature) and the posdef-violation flag, with the same
// zero-curvature exit, skip logic, resid_mach test and cr/cp update of p
// (pallas_fused.py:141-185).
//
// Bound on an H100 SXM: memory bandwidth.  An iteration must read pd
// once and read and write x, r and p once: (28 + 24) B per row for the
// 7-point stencil in f32, about 109 MB at 128^3, so at least 33 us at
// 3.35 TB/s.  The TPU kernel keeps every vector in 128 MB of VMEM; the
// H100 has 50 MB of L2, so the vectors live in device memory and each
// iteration streams them.
//
// Design.  The TPU kernel is one launch whose loop runs on one core.
// Blocks of a CUDA grid run in no order and a block may not wait for
// another (a grid barrier hangs when the blocks do not all fit, and a
// cooperative launch is refused then), so each iteration is a fixed
// sequence of five launches on the caller's stream:
//   1. cg_stencil   (grid)     ap = A p, per-block partials of p'ap
//   2. cg_alpha     (1 block)  p'ap -> alpha, zero curvature, skip
//   3. cg_update_xr (grid)     x += a p, r -= a ap, z = dinv r,
//                              per-block partials of r'z
//   4. cg_beta      (1 block)  gamma, beta, solved, status, it
//   5. cg_update_p  (grid)     p = cr z + cp p
// The scalar state (it, status, gamma, pNorm2, rnorm, eps_lim, viol, the
// step's alpha, cr, cp) lives in two small device arrays.  No block reads
// a scalar that another block writes in the same launch.  Every launch
// returns at once when the solve has stopped (status != RUNNING or
// it >= cap); the host enqueues iterations in chunks and reads the
// status once per chunk, so niter is exact and the host never waits
// inside a chunk.  Reductions are two-level (a block sum, then one block
// over the partials in a fixed order), so two runs give the same bits.
// Per iteration this design moves pd, p (read twice), ap (written and
// read), x (read, written), r (read, written, read again) and, with
// Jacobi, dinv twice: (28 + 44) B per row in f32 with M = I.
#include "cg_steps.cuh"

namespace {

// x = 0, r = b, p = z0 = dinv b (or b), partials of b'z0.
template <typename T>
__global__ void __launch_bounds__(kThreads)
cg_init(const T* __restrict__ b, const T* __restrict__ dinv, T* __restrict__ x,
        T* __restrict__ r, T* __restrict__ p, T* __restrict__ partial,
        long long n) {
  T s = T(0);
  for (long long i = ktt::first_row(); i < n; i += ktt::row_stride()) {
    const T bi = b[i];
    const T zi = dinv ? dinv[i] * bi : bi;
    x[i] = T(0);
    r[i] = bi;
    p[i] = zi;
    s += bi * zi;
  }
  ktt::store_partial(s, partial);
}

// 3. x += a p, r -= a ap, z = dinv r, per-block partials of r'z.
template <typename T>
__global__ void __launch_bounds__(kThreads)
cg_update_xr(const T* __restrict__ dinv, T* __restrict__ x, T* __restrict__ r,
             const T* __restrict__ p, const T* __restrict__ ap,
             T* __restrict__ partial, const T* sc, const int* st, long long n) {
  if (!st[GO]) return;
  const T a = sc[A_EFF];
  T s = T(0);
  for (long long i = ktt::first_row(); i < n; i += ktt::row_stride()) {
    x[i] = x[i] + a * p[i];
    const T ri = r[i] - a * ap[i];
    r[i] = ri;
    const T zi = dinv ? dinv[i] * ri : ri;
    s += ri * zi;
  }
  ktt::store_partial(s, partial);
}

// 5. p = cr z + cp p.
template <typename T>
__global__ void __launch_bounds__(kThreads)
cg_update_p(const T* __restrict__ dinv, const T* __restrict__ r,
            T* __restrict__ p, const T* sc, const int* st, long long n) {
  if (!st[GO]) return;
  const T cr = sc[CR];
  const T cp = sc[CP];
  for (long long i = ktt::first_row(); i < n; i += ktt::row_stride()) {
    const T zi = dinv ? dinv[i] * r[i] : r[i];
    p[i] = cr * zi + cp * p[i];
  }
}

template <typename T>
int init(const void* b, const void* dinv, void* x, void* r, void* p,
         void* partial, void* sc, void* st, long long n, int grid,
         double atol, double rtol, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cg_init<T><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(b), static_cast<const T*>(dinv), static_cast<T*>(x),
      static_cast<T*>(r), static_cast<T*>(p), static_cast<T*>(partial), n);
  cg_init_scalars<T><<<1, kReduceThreads, 0, s>>>(
      static_cast<const T*>(partial), grid, static_cast<T*>(sc),
      static_cast<int*>(st), atol, rtol);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename P>
int iterate(const void* pd, const void* offsets, int nd, const void* dinv_,
            void* x_, void* r_, void* p_, void* ap_, void* partial_, void* sc_,
            void* st_, long long n, int grid, int iters, int cap,
            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const P* A = static_cast<const P*>(pd);
  const long long* offs = static_cast<const long long*>(offsets);
  const T* dinv = static_cast<const T*>(dinv_);
  T* x = static_cast<T*>(x_);
  T* r = static_cast<T*>(r_);
  T* p = static_cast<T*>(p_);
  T* ap = static_cast<T*>(ap_);
  T* partial = static_cast<T*>(partial_);
  T* sc = static_cast<T*>(sc_);
  int* st = static_cast<int*>(st_);
  for (int k = 0; k < iters; ++k) {
    cg_stencil<T, P><<<grid, kThreads, 0, s>>>(A, offs, nd, p, ap, partial, st,
                                               n, cap);
    cg_alpha<T><<<1, kReduceThreads, 0, s>>>(partial, grid, sc, st, cap);
    cg_update_xr<T><<<grid, kThreads, 0, s>>>(dinv, x, r, p, ap, partial, sc,
                                              st, n);
    cg_beta<T><<<1, kReduceThreads, 0, s>>>(partial, grid, sc, st);
    cg_update_p<T><<<grid, kThreads, 0, s>>>(dinv, r, p, sc, st, n);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define KTT_CG_INIT(NAME, T)                                                  \
  extern "C" int NAME(const void* b, const void* dinv, void* x, void* r,     \
                      void* p, void* partial, void* sc, void* st,            \
                      long long n, int grid, double atol, double rtol,       \
                      void* stream) {                                        \
    return init<T>(b, dinv, x, r, p, partial, sc, st, n, grid, atol, rtol,   \
                   stream);                                                  \
  }

#define KTT_CG_ITERATE(NAME, T, P)                                            \
  extern "C" int NAME(const void* pd, const void* offsets, int nd,           \
                      const void* dinv, void* x, void* r, void* p, void* ap, \
                      void* partial, void* sc, void* st, long long n,        \
                      int grid, int iters, int cap, void* stream) {          \
    return iterate<T, P>(pd, offsets, nd, dinv, x, r, p, ap, partial, sc, st, \
                         n, grid, iters, cap, stream);                       \
  }

KTT_CG_INIT(ktt_cg_dia_init_f32, float)
KTT_CG_INIT(ktt_cg_dia_init_f64, double)
KTT_CG_ITERATE(ktt_cg_dia_iterate_f32_f32, float, float)
KTT_CG_ITERATE(ktt_cg_dia_iterate_f32_bf16, float, __nv_bfloat16)
KTT_CG_ITERATE(ktt_cg_dia_iterate_f32_f16, float, __half)
KTT_CG_ITERATE(ktt_cg_dia_iterate_f64_f64, double, double)
