// Whole CG solve of A x = b for a DIA matrix with a degree-d Chebyshev
// polynomial preconditioner z = p_d(A) r on [lmin, lmax], on Hopper
// (sm_90a), with no grid-wide barrier.
//
// Replaces the TPU kernel krylov_tpu/ops/pallas_fused.py:261
// cg_cheby_dia_fused and computes what it computes: x, niter, rnorm =
// sqrt(r'z), the status code (0 running / 1 solved / 2 zero residual / 5
// zero curvature) and the posdef-violation flag, with the CG skip and
// cr/cp logic of pallas_fused.py:360-391 and the Chebyshev semi-iteration
// of pallas_fused.py:318-334 (d = r / theta, z = d; then d - 1 times
// d = c1 d + c2 (r - A z), z = z + d).
//
// Bound on an H100 SXM: memory bandwidth.  An iteration applies the
// stencil d times (once to p, d - 1 times inside M), and pd (28 B per row
// in f32 for the 7-point stencil, 58.7 MB at 128^3) does not fit in the
// 50 MB L2, so each application streams it.  Besides, CG must read and
// write x, r and p, and each Chebyshev step must read z and r and write
// z.  At degree 8 that is (8 * 28 + 24 + 7 * 12) B = 332 B per row, about
// 696 MB at 128^3, so at least 208 us per iteration at 3.35 TB/s.
//
// Design.  The scalar launches, the stencil with p'ap partials and the
// layout of the scalar state are those of cg_dia.cu (cg_steps.cuh).  The
// TPU kernel updates z in place while its stencil reads z's neighbours:
// one core runs the loop in order.  Blocks of a grid run in no order, so
// a launch that reads z's halo cannot write z: z has two buffers that
// swap at each Chebyshev step, and each step is one launch.  theta and
// the (c1, c2) of each step depend only on lmin, lmax and d; the host
// computes them once in the working type, rounding as the TPU kernel
// does, and passes them in the scalar array after CG's slots.  An
// iteration is d + 4 launches:
//   1. cg_stencil       (grid)     ap = A p, partials of p'ap
//   2. cg_alpha         (1 block)  alpha, zero curvature, skip
//   3. cheb_update_xr   (grid)     x += a p, r -= a ap, d = r / theta,
//                                  z = d (partials of r'z when d = 1)
//   4. cheb_step x (d-1) (grid)    d = c1 d + c2 (r - A z), z' = z + d,
//                                  the last with partials of r'z
//   5. cg_beta          (1 block)  gamma, beta, status, it
//   6. cheb_update_p    (grid)     p = cr z + cp p
// Every launch returns at once when the solve has stopped; the host reads
// the status once per chunk of iterations.  Per iteration this design
// moves (28 + 8) + 32 + (28 + 20) (d - 1) + 12 B per row in f32: 416 B
// at degree 8.
#include "cg_steps.cuh"

namespace {

// the Chebyshev constants follow CG's slots: theta, then (c1, c2) per step
constexpr int THETA = NSC;
constexpr int STEPS = NSC + 1;
// rows of the vector workspace
enum Vec { VX = 0, VR, VP, VAP, VD, VZ0, VZ1, NVEC };

// x = 0, r = b, d = b / theta, z = d, partials of b'z (used when d = 1).
template <typename T>
__global__ void __launch_bounds__(kThreads)
cheb_init(const T* __restrict__ b, T* __restrict__ x, T* __restrict__ r,
          T* __restrict__ d, T* __restrict__ z, T* __restrict__ partial,
          const T* sc, long long n) {
  const T theta = sc[THETA];
  T s = T(0);
  for (long long i = ktt::first_row(); i < n; i += ktt::row_stride()) {
    const T bi = b[i];
    const T di = bi / theta;
    x[i] = T(0);
    r[i] = bi;
    d[i] = di;
    z[i] = di;
    s += bi * di;
  }
  ktt::store_partial(s, partial);
}

// 3. x += a p, r -= a ap, then the start of M r: d = r / theta, z = d,
// partials of r'z (the final ones when d = 1).
template <typename T>
__global__ void __launch_bounds__(kThreads)
cheb_update_xr(T* __restrict__ x, T* __restrict__ r, const T* __restrict__ p,
               const T* __restrict__ ap, T* __restrict__ d, T* __restrict__ z,
               T* __restrict__ partial, const T* sc, const int* st,
               long long n) {
  if (!st[GO]) return;
  const T a = sc[A_EFF];
  const T theta = sc[THETA];
  T s = T(0);
  for (long long i = ktt::first_row(); i < n; i += ktt::row_stride()) {
    x[i] = x[i] + a * p[i];
    const T ri = r[i] - a * ap[i];
    r[i] = ri;
    const T di = ri / theta;
    d[i] = di;
    z[i] = di;
    s += ri * di;
  }
  ktt::store_partial(s, partial);
}

// 4. Chebyshev step k: d = c1 d + c2 (r - A z), z_out = z_in + d, and
// partials of r'z_out.  Reads z_in's neighbours, so z_out is the other
// buffer.  At init every step runs (gated = false).
template <typename T, typename P>
__global__ void __launch_bounds__(kThreads)
cheb_step(const P* __restrict__ pd, const long long* __restrict__ offsets,
          int nd, const T* __restrict__ r, T* __restrict__ d,
          const T* __restrict__ z_in, T* __restrict__ z_out,
          T* __restrict__ partial, const T* sc, const int* st, long long n,
          int k, bool gated) {
  if (gated && !st[GO]) return;
  const T c1 = sc[STEPS + 2 * k];
  const T c2 = sc[STEPS + 2 * k + 1];
  T s = T(0);
  for (long long i = ktt::first_row(); i < n; i += ktt::row_stride()) {
    const T w = ktt::stencil_row(pd, offsets, nd, z_in, i, n);
    const T ri = r[i];
    const T di = c1 * d[i] + c2 * (ri - w);
    d[i] = di;
    const T zi = z_in[i] + di;
    z_out[i] = zi;
    s += ri * zi;
  }
  ktt::store_partial(s, partial);
}

// p = z at init.
template <typename T>
__global__ void __launch_bounds__(kThreads)
cheb_copy(const T* __restrict__ z, T* __restrict__ p, long long n) {
  for (long long i = ktt::first_row(); i < n; i += ktt::row_stride()) {
    p[i] = z[i];
  }
}

// 6. p = cr z + cp p.
template <typename T>
__global__ void __launch_bounds__(kThreads)
cheb_update_p(const T* __restrict__ z, T* __restrict__ p, const T* sc,
              const int* st, long long n) {
  if (!st[GO]) return;
  const T cr = sc[CR];
  const T cp = sc[CP];
  for (long long i = ktt::first_row(); i < n; i += ktt::row_stride()) {
    p[i] = cr * z[i] + cp * p[i];
  }
}

// z = M r: d - 1 steps from the z in Z0, alternating buffers.  Returns
// the buffer that holds the result.
template <typename T, typename P>
T* apply_steps(const P* A, const long long* offs, int nd, T* work, T* partial,
               const T* sc, const int* st, long long n, int grid, int degree,
               bool gated, cudaStream_t s) {
  T* z[2] = {work + VZ0 * n, work + VZ1 * n};
  for (int k = 0; k + 1 < degree; ++k) {
    cheb_step<T, P><<<grid, kThreads, 0, s>>>(
        A, offs, nd, work + VR * n, work + VD * n, z[k % 2], z[(k + 1) % 2],
        partial, sc, st, n, k, gated);
  }
  return z[(degree - 1) % 2];
}

template <typename T, typename P>
int init(const void* pd, const void* offsets, int nd, const void* b,
         void* work_, void* partial_, void* sc_, void* st_, long long n,
         int grid, int degree, double atol, double rtol, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const P* A = static_cast<const P*>(pd);
  const long long* offs = static_cast<const long long*>(offsets);
  T* work = static_cast<T*>(work_);
  T* partial = static_cast<T*>(partial_);
  T* sc = static_cast<T*>(sc_);
  int* st = static_cast<int*>(st_);
  cheb_init<T><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(b), work + VX * n, work + VR * n, work + VD * n,
      work + VZ0 * n, partial, sc, n);
  T* z = apply_steps<T, P>(A, offs, nd, work, partial, sc, st, n, grid,
                           degree, false, s);
  cheb_copy<T><<<grid, kThreads, 0, s>>>(z, work + VP * n, n);
  cg_init_scalars<T><<<1, kReduceThreads, 0, s>>>(partial, grid, sc, st,
                                                  atol, rtol);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename P>
int iterate(const void* pd, const void* offsets, int nd, void* work_,
            void* partial_, void* sc_, void* st_, long long n, int grid,
            int degree, int iters, int cap, void* stream) {
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
  T* ap = work + VAP * n;
  for (int k = 0; k < iters; ++k) {
    cg_stencil<T, P><<<grid, kThreads, 0, s>>>(A, offs, nd, p, ap, partial, st,
                                               n, cap);
    cg_alpha<T><<<1, kReduceThreads, 0, s>>>(partial, grid, sc, st, cap);
    cheb_update_xr<T><<<grid, kThreads, 0, s>>>(x, r, p, ap, work + VD * n,
                                                work + VZ0 * n, partial, sc, st,
                                                n);
    T* z = apply_steps<T, P>(A, offs, nd, work, partial, sc, st, n, grid,
                             degree, true, s);
    cg_beta<T><<<1, kReduceThreads, 0, s>>>(partial, grid, sc, st);
    cheb_update_p<T><<<grid, kThreads, 0, s>>>(z, p, sc, st, n);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define KTT_CHEB_INIT(NAME, T, P)                                             \
  extern "C" int NAME(const void* pd, const void* offsets, int nd,           \
                      const void* b, void* work, void* partial, void* sc,    \
                      void* st, long long n, int grid, int degree,           \
                      double atol, double rtol, void* stream) {              \
    return init<T, P>(pd, offsets, nd, b, work, partial, sc, st, n, grid,    \
                      degree, atol, rtol, stream);                           \
  }

#define KTT_CHEB_ITERATE(NAME, T, P)                                          \
  extern "C" int NAME(const void* pd, const void* offsets, int nd,           \
                      void* work, void* partial, void* sc, void* st,         \
                      long long n, int grid, int degree, int iters, int cap, \
                      void* stream) {                                        \
    return iterate<T, P>(pd, offsets, nd, work, partial, sc, st, n, grid,    \
                         degree, iters, cap, stream);                        \
  }

KTT_CHEB_INIT(ktt_cg_cheby_dia_init_f32_f32, float, float)
KTT_CHEB_INIT(ktt_cg_cheby_dia_init_f32_bf16, float, __nv_bfloat16)
KTT_CHEB_INIT(ktt_cg_cheby_dia_init_f32_f16, float, __half)
KTT_CHEB_INIT(ktt_cg_cheby_dia_init_f64_f64, double, double)
KTT_CHEB_ITERATE(ktt_cg_cheby_dia_iterate_f32_f32, float, float)
KTT_CHEB_ITERATE(ktt_cg_cheby_dia_iterate_f32_bf16, float, __nv_bfloat16)
KTT_CHEB_ITERATE(ktt_cg_cheby_dia_iterate_f32_f16, float, __half)
KTT_CHEB_ITERATE(ktt_cg_cheby_dia_iterate_f64_f64, double, double)
