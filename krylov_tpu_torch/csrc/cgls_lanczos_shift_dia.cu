// Whole CGLS-Lanczos-shift solve of every regularised least-squares
// problem min ||b - A x||^2 + lambda_i ||x||^2 from one Lanczos stream on
// A^H A, for a DIA matrix, on Hopper (sm_90a), with no grid-wide barrier.
//
// Replaces the TPU kernel krylov_tpu/ops/pallas_fused.py:7217
// cgls_lanczos_shift_dia_fused and computes what it computes
// (pallas_fused.py:7236-7340): the start v_0 = A^H b / ||A^H b|| with
// every shift's p starting at the unnormalised A^H b, then each iteration
// t = A v and A^H t, the normalised Lanczos step, and for each shift its
// gamma, sigma and omega recurrences, its x and p, its residual norm and
// its converged and indefinite flags.  A converged shift freezes its x, p
// and scalars; the solve stops when every shift has converged.  Returns X
// (nshifts, n), niter, the residual norms, the status code (0 running,
// 1 solved, 2 zero residual) and the indefinite flags.  The number of
// shifts is a runtime argument here (it was static on the TPU).
//
// Bound on an H100 SXM: memory bandwidth.  An iteration applies A and
// A^H once each (2 x 28 B per row in f32 for the 7-point stencil), must
// read v and v_prev and write the next v (12 B), and read and write every
// active shift's x and p (16 B per shift): (68 + 16 nshifts) B per row,
// 100 B with 2 shifts.
//
// Design: five launches per iteration on the caller's stream, with no
// block waiting on another:
//   1. lzs_av      (grid)     GO and the rotation decided here; t = A v
//   2. lzs_ahav    (grid)     w = A^H t into the next Lanczos buffer,
//                             partials of v'w
//   3. lzs_lanczos (grid)     delta = v'w summed in every block (block 0
//                             keeps it); w = w - delta v - beta v_prev in
//                             place (the beta term from the second
//                             iteration on), partials of w'w
//   4. lzs_shifts  (1 block)  beta, and for each shift gamma, the mask,
//                             sigma, omega, the residual norm and the
//                             flags; status, it
//   5. lzs_update  (grid)     v = w / beta in place; for each active shift
//                             x += gamma p, p = sigma v + omega p
// The Lanczos vectors rotate through three buffers by the iteration
// count, as in cg_lanczos_shift_dia.cu; t has a row of its own.  Launch
// 1 reads v's neighbours and launch 2 t's, and neither writes the vector
// it reads so.  Per iteration this design moves (28 + 8) + (28 + 12) + 16
// + (8 + 16 nshifts) B per row in f32 while every shift is active:
// 100 + 16 nshifts, 132 B with 2 shifts.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kReduceThreads = 1024;

constexpr int RUNNING = 0;
constexpr int SOLVED = 1;
constexpr int ZERO_RESIDUAL = 2;

// slots of the scalar array; ATOL and RTOL are set by the host, and after
// NSC come nshifts values of each per-shift block in the order of Shift
// (the shifts themselves, SHIFTS, are set by the host)
enum ScalarSlot { ATOL = 0, RTOL, EPS_LIM, BETA, DELTA, NSC };
enum Shift { SHIFTS = 0, SIGMA, OMEGA, GAMMA, RNORM, NSHIFT_BLOCKS };
// slots of the int array; after NST come nshifts values of each of CONV,
// INDEF and MASK
enum IntSlot { IT = 0, STATUS, GO, ROT, NST };
enum ShiftFlag { CONV = 0, INDEF, MASK, NFLAG_BLOCKS };
// rows of the vector workspace: the three Lanczos buffers, t, then the
// nshifts rows of X, then the nshifts rows of P
constexpr int VL0 = 0;
constexpr int VT = 3;
constexpr int VX = 4;
enum Part { PVW = 0, PWW, NPART };

template <typename T>
__device__ __forceinline__ T* lanczos(T* work, int slot, long long n) {
  return work + static_cast<long long>(VL0 + slot % 3) * n;
}

template <typename T>
__device__ __forceinline__ T* shift_sc(T* sc, int block, int ns) {
  return sc + NSC + block * ns;
}

__device__ __forceinline__ int* shift_st(int* st, int block, int ns) {
  return st + NST + block * ns;
}

// Init: w = A^H b into V[0] and every row of P, X = 0, with the partials
// of w'w.
template <typename T, typename P>
__global__ void __launch_bounds__(kThreads)
lzs_init_ahb(const P* __restrict__ pda, const long long* __restrict__ offs_a,
             int nda, const T* __restrict__ b, T* work,
             T* __restrict__ partial, long long n, int ns) {
  T* v = lanczos(work, 0, n);
  T* X = work + VX * n;
  T* Pm = X + static_cast<long long>(ns) * n;
  T s = T(0);
  for (long long i = ktt::first_row(); i < n; i += ktt::row_stride()) {
    const T wi = ktt::stencil_row(pda, offs_a, nda, b, i, n);
    v[i] = wi;
    for (int k = 0; k < ns; ++k) {
      X[k * n + i] = T(0);
      Pm[k * n + i] = wi;
    }
    s += wi * wi;
  }
  ktt::store_partial(s, partial + PWW * gridDim.x);
}

// Init: beta0 = ||A^H b||, eps_lim, the per-shift start and the status
// (pallas_fused.py:7247-7271).
template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
lzs_init_scalars(const T* __restrict__ partial, int nparts, T* sc, int* st,
                 int ns) {
  const T ww = ktt::sum_partials(partial + PWW * nparts, nparts);
  if (threadIdx.x != 0) return;
  const T beta0 = sqrt(ww);
  const T eps_lim = sc[ATOL] + sc[RTOL] * beta0;
  const bool conv = beta0 <= eps_lim;
  sc[EPS_LIM] = eps_lim;
  sc[BETA] = beta0;
  for (int i = 0; i < ns; ++i) {
    shift_sc(sc, SIGMA, ns)[i] = beta0;
    shift_sc(sc, OMEGA, ns)[i] = T(0);
    shift_sc(sc, GAMMA, ns)[i] = T(1);
    shift_sc(sc, RNORM, ns)[i] = beta0;
    shift_st(st, CONV, ns)[i] = conv ? 1 : 0;
    shift_st(st, INDEF, ns)[i] = 0;
    shift_st(st, MASK, ns)[i] = 0;
  }
  st[IT] = 0;
  st[STATUS] = beta0 == T(0) ? ZERO_RESIDUAL : (conv ? SOLVED : RUNNING);
  st[GO] = 0;
  st[ROT] = 0;
}

// Init: v_0 = A^H b / beta0 in place (A^H b where beta0 = 0).
template <typename T>
__global__ void __launch_bounds__(kThreads)
lzs_init_v(T* work, const T* sc, long long n) {
  const T beta0 = sc[BETA];
  const T safe = beta0 == T(0) ? T(1) : beta0;
  T* v = lanczos(work, 0, n);
  for (long long i = ktt::first_row(); i < n; i += ktt::row_stride()) {
    v[i] = v[i] / safe;
  }
}

// 1. Decide whether this iteration runs (GO, with the rotation ROT), then
// t = A v.
template <typename T, typename P>
__global__ void __launch_bounds__(kThreads)
lzs_av(const P* __restrict__ pd, const long long* __restrict__ offsets,
       int nd, T* work, int* st, long long n, int cap) {
  const int it = st[IT];
  const bool go = st[STATUS] == RUNNING && it < cap;
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    st[GO] = go ? 1 : 0;
    if (go) st[ROT] = it;
  }
  if (!go) return;
  const T* __restrict__ v = lanczos(work, it, n);
  T* __restrict__ t = work + VT * n;
  for (long long i = ktt::first_row(); i < n; i += ktt::row_stride()) {
    t[i] = ktt::stencil_row(pd, offsets, nd, v, i, n);
  }
}

// 2. w = A^H t into V[(it + 1) % 3], partials of v'w.
template <typename T, typename P>
__global__ void __launch_bounds__(kThreads)
lzs_ahav(const P* __restrict__ pda, const long long* __restrict__ offs_a,
         int nda, T* work, T* __restrict__ partial, const int* st,
         long long n) {
  if (!st[GO]) return;
  const int r = st[ROT];
  const T* __restrict__ t = work + VT * n;
  const T* __restrict__ v = lanczos(work, r, n);
  T* __restrict__ w = lanczos(work, r + 1, n);
  T s = T(0);
  for (long long i = ktt::first_row(); i < n; i += ktt::row_stride()) {
    const T wi = ktt::stencil_row(pda, offs_a, nda, t, i, n);
    w[i] = wi;
    s += v[i] * wi;
  }
  ktt::store_partial(s, partial + PVW * gridDim.x);
}

// 3. delta = v'w; w = w - delta v - beta v_prev in place, partials of
// w'w.
template <typename T>
__global__ void __launch_bounds__(kThreads)
lzs_lanczos(T* work, T* __restrict__ partial, T* sc, const int* st,
            long long n) {
  if (!st[GO]) return;
  const int nparts = gridDim.x;
  __shared__ T delta_s;
  const T d = ktt::sum_partials(partial + PVW * nparts, nparts);
  if (threadIdx.x == 0) {
    delta_s = d;
    if (blockIdx.x == 0) sc[DELTA] = d;
  }
  __syncthreads();
  const T delta = delta_s;
  const int r = st[ROT];
  const T* __restrict__ v = lanczos(work, r, n);
  const T* __restrict__ vprev = lanczos(work, r + 2, n);
  T* __restrict__ w = lanczos(work, r + 1, n);
  const T beta = sc[BETA];
  const bool second = r > 0;
  T s = T(0);
  for (long long i = ktt::first_row(); i < n; i += ktt::row_stride()) {
    T wi = w[i] - delta * v[i];
    if (second) wi = wi - beta * vprev[i];
    w[i] = wi;
    s += wi * wi;
  }
  ktt::store_partial(s, partial + PWW * nparts);
}

// 4. beta, then every shift's recurrences and mask (pallas_fused.py:
// 7299-7327), the status and it.  GAMMA holds the gamma that launch 5
// applies to x, SIGMA and OMEGA the coefficients of the new p.
template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
lzs_shifts(const T* __restrict__ partial, int nparts, T* sc, int* st,
           int ns) {
  if (!st[GO]) return;
  const T ww = ktt::sum_partials(partial + PWW * nparts, nparts);
  if (threadIdx.x != 0) return;
  const T beta_n = sqrt(ww);
  const T delta = sc[DELTA];
  const T eps_lim = sc[EPS_LIM];
  T* shifts = shift_sc(sc, SHIFTS, ns);
  T* sigma = shift_sc(sc, SIGMA, ns);
  T* omega = shift_sc(sc, OMEGA, ns);
  T* gamma = shift_sc(sc, GAMMA, ns);
  T* rnorm = shift_sc(sc, RNORM, ns);
  int* conv = shift_st(st, CONV, ns);
  int* indef = shift_st(st, INDEF, ns);
  int* mask = shift_st(st, MASK, ns);
  bool done = true;
  for (int k = 0; k < ns; ++k) {
    const T g = T(1) / ((delta + shifts[k]) - omega[k] / gamma[k]);
    const bool active = conv[k] == 0;
    if (active) {
      const T om = beta_n * g;
      const T sg = -om * sigma[k];
      sigma[k] = sg;
      omega[k] = om * om;
      gamma[k] = g;
      rnorm[k] = fabs(sg);
      conv[k] = fabs(sg) <= eps_lim ? 1 : 0;
    }
    indef[k] = indef[k] != 0 || g <= T(0) ? 1 : 0;
    mask[k] = active ? 1 : 0;
    done = done && conv[k] != 0;
  }
  sc[BETA] = beta_n;
  st[IT] = st[IT] + 1;
  st[STATUS] = done ? SOLVED : RUNNING;
}

// 5. v = w / beta in place, then for every active shift x += gamma p and
// p = sigma v + omega p.
template <typename T>
__global__ void __launch_bounds__(kThreads)
lzs_update(T* work, const T* sc, const int* st, long long n, int ns) {
  if (!st[GO]) return;
  T* __restrict__ w = lanczos(work, st[ROT] + 1, n);
  T* X = work + VX * n;
  T* Pm = X + static_cast<long long>(ns) * n;
  const T beta = sc[BETA];
  const T safe = beta == T(0) ? T(1) : beta;
  const T* sigma = sc + NSC + SIGMA * ns;
  const T* omega = sc + NSC + OMEGA * ns;
  const T* gamma = sc + NSC + GAMMA * ns;
  const int* mask = st + NST + MASK * ns;
  for (long long i = ktt::first_row(); i < n; i += ktt::row_stride()) {
    const T vi = w[i] / safe;
    w[i] = vi;
    for (int k = 0; k < ns; ++k) {
      if (!mask[k]) continue;
      const long long j = k * n + i;
      const T pj = Pm[j];
      X[j] = X[j] + gamma[k] * pj;
      Pm[j] = sigma[k] * vi + omega[k] * pj;
    }
  }
}

template <typename T, typename P>
int init(const void* pda, const void* offsets_a, int nda, const void* b,
         void* work_, void* partial_, void* sc_, void* st_, long long n,
         int grid, int ns, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  T* work = static_cast<T*>(work_);
  T* partial = static_cast<T*>(partial_);
  T* sc = static_cast<T*>(sc_);
  lzs_init_ahb<T, P><<<grid, kThreads, 0, s>>>(
      static_cast<const P*>(pda), static_cast<const long long*>(offsets_a),
      nda, static_cast<const T*>(b), work, partial, n, ns);
  lzs_init_scalars<T><<<1, kReduceThreads, 0, s>>>(
      partial, grid, sc, static_cast<int*>(st_), ns);
  lzs_init_v<T><<<grid, kThreads, 0, s>>>(work, sc, n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename P>
int iterate(const void* pd_, const void* offsets_, int nd, const void* pda_,
            const void* offs_a_, int nda, void* work_, void* partial_,
            void* sc_, void* st_, long long n, int grid, int ns, int iters,
            int cap, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const P* pd = static_cast<const P*>(pd_);
  const long long* offs = static_cast<const long long*>(offsets_);
  const P* pda = static_cast<const P*>(pda_);
  const long long* offs_a = static_cast<const long long*>(offs_a_);
  T* work = static_cast<T*>(work_);
  T* partial = static_cast<T*>(partial_);
  T* sc = static_cast<T*>(sc_);
  int* st = static_cast<int*>(st_);
  for (int k = 0; k < iters; ++k) {
    lzs_av<T, P><<<grid, kThreads, 0, s>>>(pd, offs, nd, work, st, n, cap);
    lzs_ahav<T, P><<<grid, kThreads, 0, s>>>(pda, offs_a, nda, work, partial,
                                             st, n);
    lzs_lanczos<T><<<grid, kThreads, 0, s>>>(work, partial, sc, st, n);
    lzs_shifts<T><<<1, kReduceThreads, 0, s>>>(partial, grid, sc, st, ns);
    lzs_update<T><<<grid, kThreads, 0, s>>>(work, sc, st, n, ns);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define KTT_LZS_INIT(NAME, T, P)                                              \
  extern "C" int NAME(const void* pda, const void* offsets_a, int nda,       \
                      const void* b, void* work, void* partial, void* sc,    \
                      void* st, long long n, int grid, int ns,               \
                      void* stream) {                                        \
    return init<T, P>(pda, offsets_a, nda, b, work, partial, sc, st, n,      \
                      grid, ns, stream);                                     \
  }

#define KTT_LZS_ITERATE(NAME, T, P)                                           \
  extern "C" int NAME(const void* pd, const void* offsets, int nd,           \
                      const void* pda, const void* offsets_a, int nda,       \
                      void* work, void* partial, void* sc, void* st,         \
                      long long n, int grid, int ns, int iters, int cap,     \
                      void* stream) {                                        \
    return iterate<T, P>(pd, offsets, nd, pda, offsets_a, nda, work,         \
                         partial, sc, st, n, grid, ns, iters, cap, stream);  \
  }

KTT_LZS_INIT(ktt_cgls_lanczos_shift_dia_init_f32_f32, float, float)
KTT_LZS_INIT(ktt_cgls_lanczos_shift_dia_init_f32_bf16, float, __nv_bfloat16)
KTT_LZS_INIT(ktt_cgls_lanczos_shift_dia_init_f32_f16, float, __half)
KTT_LZS_INIT(ktt_cgls_lanczos_shift_dia_init_f64_f64, double, double)
KTT_LZS_ITERATE(ktt_cgls_lanczos_shift_dia_iterate_f32_f32, float, float)
KTT_LZS_ITERATE(ktt_cgls_lanczos_shift_dia_iterate_f32_bf16, float,
                __nv_bfloat16)
KTT_LZS_ITERATE(ktt_cgls_lanczos_shift_dia_iterate_f32_f16, float, __half)
KTT_LZS_ITERATE(ktt_cgls_lanczos_shift_dia_iterate_f64_f64, double, double)
