// Whole CGNE or CRMR solve of min ||x|| subject to A x = b (+ lambda) for
// a DIA matrix on Hopper (sm_90a), with no grid-wide barrier.
//
// Replaces the TPU kernel krylov_tpu/ops/pallas_fused.py:3571
// cgne_crmr_dia_fused and computes what it computes (pallas_fused.py:
// 3590-3666): CG (CGNE) or CR (CRMR) on A A^H y = b with x = A^H y, lambda
// through the s vector, and the "probably inconsistent" exit on
// ||p|| (CGNE) or ||A^H r|| (CRMR).  Outputs: x, niter, rnorm and the
// status code.
//
// Bound on an H100 SXM: memory bandwidth.  An iteration applies A and
// A^H once each (2 x 28 B per row in f32 for the 7-point stencil) and
// must read and write p, r and x: (56 + 24) B per row, 80 B.
//
// Design: the launches per iteration, with the scalar state on the device
// and the status read by the host once per chunk:
//   1. q = A p (+ lambda s) (GO decided here, as in gk.cuh).  CGNE knows
//      alpha = gamma / (||p||^2 + lambda ||s||^2) from the state, so it
//      updates x += alpha p and r -= alpha q at once, with the partials
//      of ||r||^2; CRMR stores q, with the partials of ||q||^2.
//   2. CRMR only: alpha = gamma / ||q||^2 in every block; x += alpha p,
//      r -= alpha q, with the partials of ||r||^2.
//   3. t = A^H r.  CGNE knows beta = ||r||^2 / gamma: p = t + beta p and
//      s = r + beta s (lambda), with the partials of ||p||^2 and ||s||^2;
//      CRMR stores t, with the partials of ||t||^2.
//   4. CRMR only: beta = (||t||^2 + lambda ||r||^2) / gamma in every
//      block; p = t + beta p and s = r + beta s (lambda).
//   5. the commit (one block): ||r||, the indicator of inconsistency, the
//      tests, gamma and the iteration count.
// Launch 1 reads p's neighbours and launch 3 r's, and neither writes the
// vector it reads so; the state the grid launches read is written only by
// the commit.  s is left alone without lambda, since no output reads it.
// Per iteration this design moves (28 + 4 + 16) + (28 + 4 + 8) B per row
// in f32 for CGNE, 88 B, and (28 + 8) + 28 + (28 + 8) + 12 B for CRMR,
// 112 B (+ 8 with lambda).
#include "common.cuh"

namespace {

using namespace ktt;

constexpr int kThreads = 256;
constexpr int kCommitThreads = 256;

// the status codes of krylov_tpu_torch/_runtime.py and
// krylov_tpu_torch/solvers/cgne.py
constexpr int RUNNING = 0;
constexpr int SOLVED = 1;
constexpr int ZERO_RESIDUAL = 2;
constexpr int INCONS_CGNE = 32;
constexpr int INCONS_CRMR = 33;

enum ScalarSlot {
  LAM = 0, ATOL, RTOL, GAMMA, RNORM, PP, SS, EPS_C, EPS_I, NSC
};
enum IntSlot { IT = 0, STATUS, GO, NST };
enum Row { ROW_X = 0, ROW_R, ROW_P, ROW_S, ROW_Q, ROW_T, NROWS };
enum Part { PBB = 0, PQQ, PRR, PTT, PPP, PSS, NPART };

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

// lambda where it is positive, else 0 (pallas_fused.py:3628)
template <typename T>
__device__ __forceinline__ bool lam_on(const T* sc) {
  return sc[LAM] > T(0);
}

// Init: x = 0, r = s = b, q = t = 0, with the partials of b'b.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ne_init_vectors(const T* __restrict__ b, T* __restrict__ work,
                T* __restrict__ partial, long long n) {
  T s = T(0);
  for (long long i = first_row(); i < n; i += row_stride()) {
    const T bi = b[i];
    row(work, ROW_X, n)[i] = T(0);
    row(work, ROW_R, n)[i] = bi;
    row(work, ROW_S, n)[i] = bi;
    row(work, ROW_Q, n)[i] = T(0);
    row(work, ROW_T, n)[i] = T(0);
    s += bi * bi;
  }
  store_partial(s, partial + PBB * gridDim.x);
}

// Init: p = A^H b, with the partials of ||p||^2.
template <typename T, typename P>
__global__ void __launch_bounds__(kThreads)
ne_init_p(const P* __restrict__ pda, const long long* __restrict__ offs_a,
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

// Init: the first state and its four-way status (pallas_fused.py:
// 3611-3623).
template <typename T, bool kCgne>
__global__ void __launch_bounds__(kCommitThreads)
ne_init_state(T* sc, int* st, const T* __restrict__ partial, int nparts) {
  const T bb = sum_partials(partial + PBB * nparts, nparts);
  __syncthreads();
  const T pp = sum_partials(partial + PPP * nparts, nparts);
  if (threadIdx.x != 0) return;
  const T rnorm = sqrt(bb);
  T gamma, ind;
  if constexpr (kCgne) {
    gamma = rnorm * rnorm;
    ind = sqrt(pp);
  } else {
    gamma = pp + (lam_on(sc) ? sc[LAM] * rnorm * rnorm : T(0));
    ind = sqrt(gamma);
  }
  const T eps_c = sc[ATOL] + sc[RTOL] * rnorm;
  const T eps_i = sc[ATOL] + sc[RTOL] * ind;
  sc[GAMMA] = gamma;
  sc[RNORM] = rnorm;
  sc[PP] = pp;
  sc[SS] = bb;
  sc[EPS_C] = eps_c;
  sc[EPS_I] = eps_i;
  const bool incons = rnorm > T(100) * eps_c && ind <= eps_i;
  st[IT] = 0;
  st[STATUS] = rnorm == T(0)   ? ZERO_RESIDUAL
               : rnorm <= eps_c ? SOLVED
               : incons         ? (kCgne ? INCONS_CGNE : INCONS_CRMR)
                                : RUNNING;
  st[GO] = 0;
}

// 1. GO; q = A p (+ lambda s); CGNE: x += alpha p, r -= alpha q and the
// partials of ||r||^2; CRMR: q stored and the partials of ||q||^2.
template <typename T, typename P, bool kCgne>
__global__ void __launch_bounds__(kThreads)
ne_ap(const P* __restrict__ pd, const long long* __restrict__ offsets,
      int nd, T* __restrict__ work, T* __restrict__ partial, const T* sc,
      int* st, long long n, int cap) {
  const bool go = st[STATUS] == RUNNING && st[IT] < cap;
  if (blockIdx.x == 0 && threadIdx.x == 0) st[GO] = go ? 1 : 0;
  if (!go) return;
  const bool lam = lam_on(sc);
  T alpha = T(0);
  if constexpr (kCgne) {
    alpha = sc[GAMMA] / safe(sc[PP] + (lam ? sc[LAM] * sc[SS] : T(0)));
  }
  const T* p = row(work, ROW_P, n);
  const T* s_ = row(work, ROW_S, n);
  T* x = row(work, ROW_X, n);
  T* r = row(work, ROW_R, n);
  T* q = row(work, ROW_Q, n);
  T s = T(0);
  for (long long i = first_row(); i < n; i += row_stride()) {
    T qi = stencil_row(pd, offsets, nd, p, i, n);
    if (lam) qi = qi + sc[LAM] * s_[i];
    if constexpr (kCgne) {
      x[i] = x[i] + alpha * p[i];
      const T ri = r[i] - alpha * qi;
      r[i] = ri;
      s += ri * ri;
    } else {
      q[i] = qi;
      s += qi * qi;
    }
  }
  store_partial(s, partial + (kCgne ? PRR : PQQ) * gridDim.x);
}

// 2. CRMR: alpha = gamma / ||q||^2; x += alpha p, r -= alpha q and the
// partials of ||r||^2.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ne_xr(T* __restrict__ work, T* __restrict__ partial, const T* sc,
      const int* st, long long n) {
  if (!st[GO]) return;
  const int nparts = gridDim.x;
  const T alpha = sc[GAMMA] / safe(all_sum(partial + PQQ * nparts, nparts));
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

// 3. t = A^H r; CGNE: beta = ||r||^2 / gamma, p = t + beta p and s = r +
// beta s, with the partials of ||p||^2 and ||s||^2; CRMR: t stored and
// the partials of ||t||^2.
template <typename T, typename P, bool kCgne>
__global__ void __launch_bounds__(kThreads)
ne_ahr(const P* __restrict__ pda, const long long* __restrict__ offs_a,
       int nda, T* __restrict__ work, T* __restrict__ partial, const T* sc,
       const int* st, long long n) {
  if (!st[GO]) return;
  const int nparts = gridDim.x;
  const bool lam = lam_on(sc);
  T beta = T(0);
  if constexpr (kCgne) {
    beta = all_sum(partial + PRR * nparts, nparts) / safe(sc[GAMMA]);
  }
  const T* r = row(work, ROW_R, n);
  T* p = row(work, ROW_P, n);
  T* s_ = row(work, ROW_S, n);
  T* t = row(work, ROW_T, n);
  T s1 = T(0);
  T s2 = T(0);
  for (long long i = first_row(); i < n; i += row_stride()) {
    const T ti = stencil_row(pda, offs_a, nda, r, i, n);
    if constexpr (kCgne) {
      const T pi = ti + beta * p[i];
      p[i] = pi;
      s1 += pi * pi;
      if (lam) {
        const T si = r[i] + beta * s_[i];
        s_[i] = si;
        s2 += si * si;
      }
    } else {
      t[i] = ti;
      s1 += ti * ti;
    }
  }
  if constexpr (kCgne) {
    store_partials(s1, partial + PPP * nparts, s2, partial + PSS * nparts);
  } else {
    store_partial(s1, partial + PTT * nparts);
  }
}

// gamma_{k+1} of CRMR from the sums of ||t||^2 and ||r||^2, and ||r||
// (pallas_fused.py:3645-3651).
template <typename T>
__device__ __forceinline__ T crmr_gamma(const T* sc, T tt, T rr, T& rnorm) {
  rnorm = sqrt(rr);
  return tt + (lam_on(sc) ? sc[LAM] * rnorm * rnorm : T(0));
}

// 4. CRMR: beta = gamma_{k+1} / gamma; p = t + beta p and s = r + beta s.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ne_ps(T* __restrict__ work, const T* __restrict__ partial, const T* sc,
      const int* st, long long n) {
  if (!st[GO]) return;
  const int nparts = gridDim.x;
  const T tt = all_sum(partial + PTT * nparts, nparts);
  const T rr = all_sum(partial + PRR * nparts, nparts);
  T rnorm;
  const T beta = crmr_gamma(sc, tt, rr, rnorm) / safe(sc[GAMMA]);
  const bool lam = lam_on(sc);
  const T* r = row(work, ROW_R, n);
  const T* t = row(work, ROW_T, n);
  T* p = row(work, ROW_P, n);
  T* s_ = row(work, ROW_S, n);
  for (long long i = first_row(); i < n; i += row_stride()) {
    p[i] = t[i] + beta * p[i];
    if (lam) s_[i] = r[i] + beta * s_[i];
  }
}

// 5. The commit: ||r_{k+1}||, the indicator (||p_{k+1}|| or
// sqrt(gamma_{k+1})), the tests and the next state (pallas_fused.py:
// 3637-3665).
template <typename T, bool kCgne>
__global__ void __launch_bounds__(kCommitThreads)
ne_commit(T* sc, int* st, const T* __restrict__ partial, int nparts) {
  if (!st[GO]) return;
  const T rr = sum_partials(partial + PRR * nparts, nparts);
  __syncthreads();
  const T s1 = sum_partials(partial + (kCgne ? PPP : PTT) * nparts, nparts);
  __syncthreads();
  const T s2 = kCgne && lam_on(sc)
                   ? sum_partials(partial + PSS * nparts, nparts)
                   : T(0);
  if (threadIdx.x != 0) return;
  T gamma, rnorm, ind;
  if constexpr (kCgne) {
    gamma = rr;
    rnorm = sqrt(fmax(gamma, T(0)));
    ind = sqrt(s1);
    sc[PP] = s1;
    if (lam_on(sc)) sc[SS] = s2;
  } else {
    gamma = crmr_gamma(sc, s1, rr, rnorm);
    ind = sqrt(fmax(gamma, T(0)));
  }
  const T eps_c = sc[EPS_C];
  const bool solved = rnorm <= eps_c || rnorm + T(1) <= T(1);
  const bool incons = rnorm > T(100) * eps_c && ind <= sc[EPS_I];
  int code = RUNNING;
  if (incons) code = kCgne ? INCONS_CGNE : INCONS_CRMR;
  if (solved) code = SOLVED;
  sc[GAMMA] = gamma;
  sc[RNORM] = rnorm;
  st[STATUS] = code;
  st[IT] = st[IT] + 1;
}

template <typename T, typename P, bool kCgne>
int init(const void* pda, const void* offs_a, int nda, const void* b_,
         void* work_, void* partial_, void* sc, void* st, long long n,
         int grid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* b = static_cast<const T*>(b_);
  T* work = static_cast<T*>(work_);
  T* partial = static_cast<T*>(partial_);
  ne_init_vectors<T><<<grid, kThreads, 0, s>>>(b, work, partial, n);
  ne_init_p<T, P><<<grid, kThreads, 0, s>>>(
      static_cast<const P*>(pda), static_cast<const long long*>(offs_a), nda,
      b, work, partial, n);
  ne_init_state<T, kCgne><<<1, kCommitThreads, 0, s>>>(
      static_cast<T*>(sc), static_cast<int*>(st), partial, grid);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename P, bool kCgne>
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
    ne_ap<T, P, kCgne><<<grid, kThreads, 0, s>>>(pd, offs, nd, work, partial,
                                                  sc, st, n, cap);
    if constexpr (!kCgne) {
      ne_xr<T><<<grid, kThreads, 0, s>>>(work, partial, sc, st, n);
    }
    ne_ahr<T, P, kCgne><<<grid, kThreads, 0, s>>>(pda, offs_a, nda, work,
                                                   partial, sc, st, n);
    if constexpr (!kCgne) {
      ne_ps<T><<<grid, kThreads, 0, s>>>(work, partial, sc, st, n);
    }
    ne_commit<T, kCgne><<<1, kCommitThreads, 0, s>>>(sc, st, partial, grid);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// variant: 1 CGNE, 0 CRMR
#define KTT_NE_INIT(NAME, T, P)                                              \
  extern "C" int NAME(const void* pda, const void* offsets_a, int nda,       \
                      const void* b, void* work, void* partial, void* sc,    \
                      void* st, long long n, int grid, int variant,          \
                      void* stream) {                                        \
    return variant ? init<T, P, true>(pda, offsets_a, nda, b, work, partial, \
                                      sc, st, n, grid, stream)               \
                   : init<T, P, false>(pda, offsets_a, nda, b, work,         \
                                       partial, sc, st, n, grid, stream);    \
  }

#define KTT_NE_ITERATE(NAME, T, P)                                           \
  extern "C" int NAME(const void* pd, const void* offsets, int nd,           \
                      const void* pda, const void* offsets_a, int nda,       \
                      void* work, void* partial, void* sc, void* st,         \
                      long long n, int grid, int variant, int iters,         \
                      int cap, void* stream) {                               \
    return variant                                                           \
               ? iterate<T, P, true>(pd, offsets, nd, pda, offsets_a, nda,   \
                                     work, partial, sc, st, n, grid, iters,  \
                                     cap, stream)                            \
               : iterate<T, P, false>(pd, offsets, nd, pda, offsets_a, nda,  \
                                      work, partial, sc, st, n, grid, iters, \
                                      cap, stream);                          \
  }

KTT_NE_INIT(ktt_cgne_crmr_dia_init_f32_f32, float, float)
KTT_NE_INIT(ktt_cgne_crmr_dia_init_f32_bf16, float, __nv_bfloat16)
KTT_NE_INIT(ktt_cgne_crmr_dia_init_f32_f16, float, __half)
KTT_NE_INIT(ktt_cgne_crmr_dia_init_f64_f64, double, double)
KTT_NE_ITERATE(ktt_cgne_crmr_dia_iterate_f32_f32, float, float)
KTT_NE_ITERATE(ktt_cgne_crmr_dia_iterate_f32_bf16, float, __nv_bfloat16)
KTT_NE_ITERATE(ktt_cgne_crmr_dia_iterate_f32_f16, float, __half)
KTT_NE_ITERATE(ktt_cgne_crmr_dia_iterate_f64_f64, double, double)
