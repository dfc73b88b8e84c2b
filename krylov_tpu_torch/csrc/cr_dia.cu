// Whole CR (conjugate residuals) solve of A x = b for a DIA matrix, M = I,
// on Hopper (sm_90a), with no grid-wide barrier.
//
// Replaces the TPU kernel krylov_tpu/ops/pallas_fused.py:727 cr_dia_fused
// and computes what it computes (pallas_fused.py:754-820): x, niter,
// rnorm, the status code (0 running / 1 solved / 2 zero residual / 25
// numerical issues / 26 b is a zero-curvature direction) and the flag
// that some p'Ap <= 0 was met (the host raises "Indefinite system and no
// trust region").  indef is taken from the carried pAp at the start of an
// iteration, and rho, pNorm2, pr and pAp stay frozen on the solving step.
//
// Bound on an H100 SXM: memory bandwidth.  An iteration applies the
// stencil once (pd, 28 B per row in f32 for the 7-point stencil, 58.7 MB
// at 128^3, more than the 50 MB L2) and must read and write x, r, p and
// q: (28 + 32) B per row, about 126 MB at 128^3, so at least 37.6 us per
// iteration at 3.35 TB/s.
//
// Design.  The TPU kernel's loop runs on one core; here each iteration
// is a fixed sequence of five launches on the caller's stream, with no
// block waiting on another:
//   1. cr_alpha     (1 block)  GO, indef |= pAp <= 0, alpha = rho / q'q
//   2. cr_update_xr (grid)     x += alpha p, r -= alpha q
//   3. cr_stencil   (grid)     Ar = A r, partials of r'r and r'Ar
//   4. cr_beta      (1 block)  rnorm, beta, the recurrences, status, it
//   5. cr_update_pq (grid)     p = r + beta p, q = Ar + beta q, partials
//                              of q'q for the next iteration's alpha
// The stencil reads r's neighbours, so r is updated one launch before the
// stencil.  The scalar state lives in two small device arrays; every
// launch returns at once when the solve has stopped (status != RUNNING or
// it >= cap), and the host reads the status once per chunk of
// iterations.  Reductions are two-level in a fixed order, so two runs
// give the same bits.  Per iteration this design moves 24 + (28 + 8) +
// 24 B per row in f32: 84 B.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kReduceThreads = 1024;

constexpr int RUNNING = 0;
constexpr int SOLVED = 1;
constexpr int ZERO_RESIDUAL = 2;
constexpr int NUMERICAL = 25;
constexpr int ZERO_CURV_B = 26;

// slots of the scalar arrays; ATOL and RTOL are set by the host
enum ScalarSlot {
  RHO = 0, RNORM2, RNORM, PNORM2, PR, PAP, EPS_LIM, ALPHA, BETA, ATOL, RTOL,
  NSC
};
enum IntSlot { IT = 0, STATUS, INDEF, GO, STAY, NST };
// rows of the vector workspace and of the partials
enum Vec { VX = 0, VR, VP, VQ, VAR, NVEC };
enum Part { PQQ = 0, PRR, PRAR, NPART };

// x = 0, r = p = b.
template <typename T>
__global__ void __launch_bounds__(kThreads)
cr_init(const T* __restrict__ b, T* __restrict__ x, T* __restrict__ r,
        T* __restrict__ p, long long n) {
  for (long long i = ktt::first_row(); i < n; i += ktt::row_stride()) {
    const T bi = b[i];
    x[i] = T(0);
    r[i] = bi;
    p[i] = bi;
  }
}

// q = Ar at init, partials of q'q.
template <typename T>
__global__ void __launch_bounds__(kThreads)
cr_init_q(const T* __restrict__ ar, T* __restrict__ q, T* __restrict__ partial,
          long long n) {
  T s = T(0);
  for (long long i = ktt::first_row(); i < n; i += ktt::row_stride()) {
    const T qi = ar[i];
    q[i] = qi;
    s += qi * qi;
  }
  ktt::store_partial(s, partial);
}

// rnorm0, rho0 = b'Ab, eps_lim and the starting status.
template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
cr_init_scalars(const T* __restrict__ partial, int nparts, T* sc, int* st) {
  const T rnorm2 = ktt::sum_partials(partial + PRR * nparts, nparts);
  __syncthreads();
  const T rho = ktt::sum_partials(partial + PRAR * nparts, nparts);
  if (threadIdx.x != 0) return;
  const T rnorm = sqrt(rnorm2);
  const T eps_lim = sc[ATOL] + sc[RTOL] * rnorm;
  sc[RHO] = rho;
  sc[RNORM2] = rnorm2;
  sc[RNORM] = rnorm;
  sc[PNORM2] = rnorm2;
  sc[PR] = rnorm2;
  sc[PAP] = rho;
  sc[EPS_LIM] = eps_lim;
  sc[ALPHA] = T(0);
  sc[BETA] = T(0);
  st[IT] = 0;
  st[STATUS] = rnorm == T(0) ? ZERO_RESIDUAL
               : rho == T(0) ? ZERO_CURV_B
               : rnorm <= eps_lim ? SOLVED : RUNNING;
  st[INDEF] = 0;
  st[GO] = 0;
  st[STAY] = 0;
}

// 1. Decide whether this iteration runs (GO, read by launches 2-5), then
// the indefinite flag and alpha.
template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
cr_alpha(const T* __restrict__ partial, int nparts, T* sc, int* st, int cap) {
  const bool go = st[STATUS] == RUNNING && st[IT] < cap;
  if (!go) {
    if (threadIdx.x == 0) st[GO] = 0;
    return;
  }
  const T qq = ktt::sum_partials(partial + PQQ * nparts, nparts);
  if (threadIdx.x != 0) return;
  if (sc[PAP] <= T(0)) st[INDEF] = 1;
  sc[ALPHA] = sc[RHO] / (qq == T(0) ? T(1) : qq);
  st[GO] = 1;
}

// 2. x += alpha p, r -= alpha q.
template <typename T>
__global__ void __launch_bounds__(kThreads)
cr_update_xr(T* __restrict__ x, T* __restrict__ r, const T* __restrict__ p,
             const T* __restrict__ q, const T* sc, const int* st,
             long long n) {
  if (!st[GO]) return;
  const T a = sc[ALPHA];
  for (long long i = ktt::first_row(); i < n; i += ktt::row_stride()) {
    x[i] = x[i] + a * p[i];
    r[i] = r[i] - a * q[i];
  }
}

// 3. Ar = A r, partials of r'r and r'Ar.  At init it runs ungated.
template <typename T, typename P>
__global__ void __launch_bounds__(kThreads)
cr_stencil(const P* __restrict__ pd, const long long* __restrict__ offsets,
           int nd, const T* __restrict__ r, T* __restrict__ ar,
           T* __restrict__ partial, const int* st, long long n, bool gated) {
  if (gated && !st[GO]) return;
  T srr = T(0);
  T srar = T(0);
  for (long long i = ktt::first_row(); i < n; i += ktt::row_stride()) {
    const T acc = ktt::stencil_row(pd, offsets, nd, r, i, n);
    const T ri = r[i];
    ar[i] = acc;
    srr += ri * ri;
    srar += ri * acc;
  }
  const int nparts = gridDim.x;
  ktt::store_partials(srr, partial + PRR * nparts, srar,
                      partial + PRAR * nparts);
}

// 4. rnorm, the solved test, beta and the recurrences of pNorm2, pr and
// pAp (reference src/cr.jl; pallas_fused.py:790-818).
template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
cr_beta(const T* __restrict__ partial, int nparts, T* sc, int* st) {
  if (!st[GO]) return;
  const T rnorm2 = ktt::sum_partials(partial + PRR * nparts, nparts);
  __syncthreads();
  const T rho_n = ktt::sum_partials(partial + PRAR * nparts, nparts);
  if (threadIdx.x != 0) return;
  const T sqeps = static_cast<T>(sqrt(static_cast<double>(ktt::eps_of<T>())));
  const T alpha = sc[ALPHA];
  const T rho = sc[RHO];
  const T pr = sc[PR];
  const T pAp = sc[PAP];
  const T pNorm2 = sc[PNORM2];
  const T rnorm = sqrt(rnorm2);
  const bool solved = rnorm <= sc[EPS_LIM] || (rnorm + T(1)) <= T(1);
  const T beta = rho_n / (rho == T(0) ? T(1) : rho);
  const T pNorm2_n = rnorm2 + T(2) * beta * pr - T(2) * beta * alpha * pAp
                     + beta * beta * pNorm2;
  const bool pnorm_bad = pNorm2_n <= -sqeps;
  const T pr_n = rnorm2 + beta * pr - beta * alpha * pAp;
  const T pAp_n = rho_n + beta * beta * pAp;
  sc[RNORM2] = rnorm2;
  sc[RNORM] = rnorm;
  sc[BETA] = beta;
  if (!solved) {
    sc[RHO] = rho_n;
    sc[PNORM2] = pNorm2_n;
    sc[PR] = pr_n;
    sc[PAP] = pAp_n;
  }
  st[STAY] = solved ? 0 : 1;
  st[IT] += 1;
  st[STATUS] = solved ? SOLVED : (pnorm_bad ? NUMERICAL : RUNNING);
}

// 5. p = r + beta p, q = Ar + beta q, partials of q'q.
template <typename T>
__global__ void __launch_bounds__(kThreads)
cr_update_pq(const T* __restrict__ r, const T* __restrict__ ar,
             T* __restrict__ p, T* __restrict__ q, T* __restrict__ partial,
             const T* sc, const int* st, long long n) {
  if (!st[GO] || !st[STAY]) return;
  const T beta = sc[BETA];
  T s = T(0);
  for (long long i = ktt::first_row(); i < n; i += ktt::row_stride()) {
    p[i] = r[i] + beta * p[i];
    const T qi = ar[i] + beta * q[i];
    q[i] = qi;
    s += qi * qi;
  }
  ktt::store_partial(s, partial);
}

template <typename T, typename P>
int init(const void* pd, const void* offsets, int nd, const void* b,
         void* work_, void* partial_, void* sc_, void* st_, long long n,
         int grid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  T* work = static_cast<T*>(work_);
  T* partial = static_cast<T*>(partial_);
  int* st = static_cast<int*>(st_);
  cr_init<T><<<grid, kThreads, 0, s>>>(static_cast<const T*>(b), work + VX * n,
                                       work + VR * n, work + VP * n, n);
  cr_stencil<T, P><<<grid, kThreads, 0, s>>>(
      static_cast<const P*>(pd), static_cast<const long long*>(offsets), nd,
      work + VR * n, work + VAR * n, partial, st, n, false);
  cr_init_q<T><<<grid, kThreads, 0, s>>>(work + VAR * n, work + VQ * n,
                                         partial + PQQ * grid, n);
  cr_init_scalars<T><<<1, kReduceThreads, 0, s>>>(partial, grid,
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
  T* q = work + VQ * n;
  T* ar = work + VAR * n;
  for (int k = 0; k < iters; ++k) {
    cr_alpha<T><<<1, kReduceThreads, 0, s>>>(partial, grid, sc, st, cap);
    cr_update_xr<T><<<grid, kThreads, 0, s>>>(x, r, p, q, sc, st, n);
    cr_stencil<T, P><<<grid, kThreads, 0, s>>>(A, offs, nd, r, ar, partial, st,
                                               n, true);
    cr_beta<T><<<1, kReduceThreads, 0, s>>>(partial, grid, sc, st);
    cr_update_pq<T><<<grid, kThreads, 0, s>>>(r, ar, p, q, partial + PQQ * grid,
                                              sc, st, n);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define KTT_CR_INIT(NAME, T, P)                                               \
  extern "C" int NAME(const void* pd, const void* offsets, int nd,           \
                      const void* b, void* work, void* partial, void* sc,    \
                      void* st, long long n, int grid, void* stream) {       \
    return init<T, P>(pd, offsets, nd, b, work, partial, sc, st, n, grid,    \
                      stream);                                               \
  }

#define KTT_CR_ITERATE(NAME, T, P)                                            \
  extern "C" int NAME(const void* pd, const void* offsets, int nd,           \
                      void* work, void* partial, void* sc, void* st,         \
                      long long n, int grid, int iters, int cap,             \
                      void* stream) {                                        \
    return iterate<T, P>(pd, offsets, nd, work, partial, sc, st, n, grid,    \
                         iters, cap, stream);                                \
  }

KTT_CR_INIT(ktt_cr_dia_init_f32_f32, float, float)
KTT_CR_INIT(ktt_cr_dia_init_f32_bf16, float, __nv_bfloat16)
KTT_CR_INIT(ktt_cr_dia_init_f32_f16, float, __half)
KTT_CR_INIT(ktt_cr_dia_init_f64_f64, double, double)
KTT_CR_ITERATE(ktt_cr_dia_iterate_f32_f32, float, float)
KTT_CR_ITERATE(ktt_cr_dia_iterate_f32_bf16, float, __nv_bfloat16)
KTT_CR_ITERATE(ktt_cr_dia_iterate_f32_f16, float, __half)
KTT_CR_ITERATE(ktt_cr_dia_iterate_f64_f64, double, double)
