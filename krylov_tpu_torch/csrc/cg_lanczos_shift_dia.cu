// Whole CG-Lanczos solve of every shifted system (A + sigma_i I) x_i = b
// from one Lanczos stream, for a DIA matrix, M = I, on Hopper (sm_90a),
// with no grid-wide barrier.
//
// Replaces the TPU kernel krylov_tpu/ops/pallas_fused.py:1181
// cg_lanczos_shift_dia_fused and computes what it computes
// (pallas_fused.py:1215-1309): one normalised Lanczos stream, and for
// each shift its gamma, sigma and omega recurrences, its x and p, its
// residual norm and converged and indefinite flags.  A converged shift
// (and with check_curvature an indefinite one) freezes its x, p and
// scalars; the solve stops when every shift is done.  Returns X
// (nshifts, n), niter, the residual norms, the status code (0 running, 1
// solved, 2 zero residual) and the indefinite flags.  The number of shifts
// is a runtime argument here (it was static on the TPU).
//
// Bound on an H100 SXM: memory bandwidth.  An iteration applies the
// stencil once (pd, 28 B per row in f32 for the 7-point stencil) and must
// read v and vprev and write the next v (12 B) and read and write every
// shift's x and p (16 B per shift): (40 + 16 nshifts) B per row, 218 MB
// at 128^3 with 4 shifts, so at least 65 us per iteration at 3.35 TB/s.
//
// Design.  An iteration is five launches on the caller's stream, with no
// block waiting on another:
//   1. cgls_stencil (grid)     Av into the next Lanczos buffer, partials
//                              of v'Av
//   2. cgls_delta   (1 block)  GO, delta
//   3. cgls_lanczos (grid)     w = Av - delta v - beta vprev in place,
//                              partials of w'w
//   4. cgls_shifts  (1 block)  beta, and for each shift gamma, the masks,
//                              sigma, omega, the residual norm and the
//                              flags; status, it
//   5. cgls_update  (grid)     v = w / beta in place; for each active
//                              shift x += gamma p, p = sigma v + omega p,
//                              reading v once per row
// The three Lanczos vectors rotate through three buffers by it mod 3, as
// in cg_lanczos_dia.cu, so the launch that reads v's halo never writes v.
// X and P are fixed (nshifts, n) panels.  Every launch returns at once
// when the solve has stopped, and the host reads the status once per
// chunk of iterations.  Per iteration this design moves (28 + 8) + 16 +
// (8 + 16 nshifts) B per row in f32 while every shift is active: 60 + 16
// nshifts, 124 B with 4 shifts.
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
// rows of the vector workspace: the three Lanczos buffers, then the
// nshifts rows of X, then the nshifts rows of P
constexpr int VL0 = 0;
constexpr int VX = 3;

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

// Partials of b'b.
template <typename T>
__global__ void __launch_bounds__(kThreads)
cgls_init_norm(const T* __restrict__ b, T* __restrict__ partial,
               long long n) {
  T s = T(0);
  for (long long i = ktt::first_row(); i < n; i += ktt::row_stride()) {
    s += b[i] * b[i];
  }
  ktt::store_partial(s, partial);
}

// beta0, eps_lim, the per-shift start and the starting status.
template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
cgls_init_scalars(const T* __restrict__ partial, int nparts, T* sc, int* st,
                  int ns) {
  const T bb = ktt::sum_partials(partial, nparts);
  if (threadIdx.x != 0) return;
  const T beta0 = sqrt(bb);
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

// X = 0, every row of P = b, v = b / beta0 (in V[0]).
template <typename T>
__global__ void __launch_bounds__(kThreads)
cgls_init_vectors(const T* __restrict__ b, T* work, const T* sc, long long n,
                  int ns) {
  const T beta0 = sc[BETA];
  const T safe = beta0 == T(0) ? T(1) : beta0;
  T* v = lanczos(work, 0, n);
  T* X = work + VX * n;
  T* P = X + static_cast<long long>(ns) * n;
  for (long long i = ktt::first_row(); i < n; i += ktt::row_stride()) {
    const T bi = b[i];
    v[i] = bi / safe;
    for (int k = 0; k < ns; ++k) {
      X[k * n + i] = T(0);
      P[k * n + i] = bi;
    }
  }
}

// 1. Av into V[(it + 1) % 3] and partials of v'Av.
template <typename T, typename P>
__global__ void __launch_bounds__(kThreads)
cgls_stencil(const P* __restrict__ pd, const long long* __restrict__ offsets,
             int nd, T* work, T* __restrict__ partial, const int* st,
             long long n, int cap) {
  if (!(st[STATUS] == RUNNING && st[IT] < cap)) return;
  const int it = st[IT];
  const T* __restrict__ v = lanczos(work, it, n);
  T* __restrict__ av = lanczos(work, it + 1, n);
  T s = T(0);
  for (long long i = ktt::first_row(); i < n; i += ktt::row_stride()) {
    const T acc = ktt::stencil_row(pd, offsets, nd, v, i, n);
    av[i] = acc;
    s += v[i] * acc;
  }
  ktt::store_partial(s, partial);
}

// 2. Decide whether this iteration runs (GO), then delta.
template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
cgls_delta(const T* __restrict__ partial, int nparts, T* sc, int* st,
           int cap) {
  const bool go = st[STATUS] == RUNNING && st[IT] < cap;
  if (!go) {
    if (threadIdx.x == 0) st[GO] = 0;
    return;
  }
  const T delta = ktt::sum_partials(partial, nparts);
  if (threadIdx.x != 0) return;
  sc[DELTA] = delta;
  st[ROT] = st[IT];
  st[GO] = 1;
}

// 3. w = Av - delta v - beta vprev (from the second iteration on) in
// place of Av, partials of w'w.
template <typename T>
__global__ void __launch_bounds__(kThreads)
cgls_lanczos(T* work, T* __restrict__ partial, const T* sc, const int* st,
             long long n) {
  if (!st[GO]) return;
  const int r = st[ROT];
  const T* __restrict__ v = lanczos(work, r, n);
  const T* __restrict__ vprev = lanczos(work, r + 2, n);
  T* __restrict__ w = lanczos(work, r + 1, n);
  const T delta = sc[DELTA];
  const T beta = sc[BETA];
  const bool second = r > 0;
  T s = T(0);
  for (long long i = ktt::first_row(); i < n; i += ktt::row_stride()) {
    T wi = w[i] - delta * v[i];
    if (second) wi = wi - beta * vprev[i];
    w[i] = wi;
    s += wi * wi;
  }
  ktt::store_partial(s, partial);
}

// 4. beta, then every shift's recurrences and masks (pallas_fused.py:
// 1274-1302), the status and it.  GAMMA holds the gamma that launch 5
// applies to x, SIGMA and OMEGA the coefficients of the new p.
template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
cgls_shifts(const T* __restrict__ partial, int nparts, T* sc, int* st, int ns,
            bool check_curvature) {
  if (!st[GO]) return;
  const T ww = ktt::sum_partials(partial, nparts);
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
    const bool idf = indef[k] != 0 || g <= T(0);
    const bool cv = conv[k] != 0;
    const bool active = !(cv || (check_curvature && idf));
    if (active) {
      const T om = beta_n * g;
      const T sg = -om * sigma[k];
      sigma[k] = sg;
      omega[k] = om * om;
      gamma[k] = g;
      rnorm[k] = fabs(sg);
      conv[k] = fabs(sg) <= eps_lim ? 1 : 0;
    }
    indef[k] = idf ? 1 : 0;
    mask[k] = active ? 1 : 0;
    done = done && (conv[k] != 0 || (check_curvature && idf));
  }
  sc[BETA] = beta_n;
  st[IT] = st[IT] + 1;
  st[STATUS] = done ? SOLVED : RUNNING;
}

// 5. v = w / beta in place, then for every active shift x += gamma p and
// p = sigma v + omega p.
template <typename T>
__global__ void __launch_bounds__(kThreads)
cgls_update(T* work, const T* sc, const int* st, long long n, int ns) {
  if (!st[GO]) return;
  T* __restrict__ w = lanczos(work, st[ROT] + 1, n);
  T* X = work + VX * n;
  T* P = X + static_cast<long long>(ns) * n;
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
      const T pj = P[j];
      X[j] = X[j] + gamma[k] * pj;
      P[j] = sigma[k] * vi + omega[k] * pj;
    }
  }
}

template <typename T>
int init(const void* b, void* work_, void* partial_, void* sc_, void* st_,
         long long n, int grid, int ns, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  T* work = static_cast<T*>(work_);
  T* partial = static_cast<T*>(partial_);
  T* sc = static_cast<T*>(sc_);
  cgls_init_norm<T><<<grid, kThreads, 0, s>>>(static_cast<const T*>(b),
                                              partial, n);
  cgls_init_scalars<T><<<1, kReduceThreads, 0, s>>>(
      partial, grid, sc, static_cast<int*>(st_), ns);
  cgls_init_vectors<T><<<grid, kThreads, 0, s>>>(static_cast<const T*>(b),
                                                 work, sc, n, ns);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename P>
int iterate(const void* pd, const void* offsets, int nd, void* work_,
            void* partial_, void* sc_, void* st_, long long n, int grid,
            int ns, int check_curvature, int iters, int cap, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const P* A = static_cast<const P*>(pd);
  const long long* offs = static_cast<const long long*>(offsets);
  T* work = static_cast<T*>(work_);
  T* partial = static_cast<T*>(partial_);
  T* sc = static_cast<T*>(sc_);
  int* st = static_cast<int*>(st_);
  for (int k = 0; k < iters; ++k) {
    cgls_stencil<T, P><<<grid, kThreads, 0, s>>>(A, offs, nd, work, partial,
                                                 st, n, cap);
    cgls_delta<T><<<1, kReduceThreads, 0, s>>>(partial, grid, sc, st, cap);
    cgls_lanczos<T><<<grid, kThreads, 0, s>>>(work, partial, sc, st, n);
    cgls_shifts<T><<<1, kReduceThreads, 0, s>>>(partial, grid, sc, st, ns,
                                                check_curvature != 0);
    cgls_update<T><<<grid, kThreads, 0, s>>>(work, sc, st, n, ns);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define KTT_CGLS_INIT(NAME, T)                                                \
  extern "C" int NAME(const void* b, void* work, void* partial, void* sc,    \
                      void* st, long long n, int grid, int ns,               \
                      void* stream) {                                        \
    return init<T>(b, work, partial, sc, st, n, grid, ns, stream);           \
  }

#define KTT_CGLS_ITERATE(NAME, T, P)                                          \
  extern "C" int NAME(const void* pd, const void* offsets, int nd,           \
                      void* work, void* partial, void* sc, void* st,         \
                      long long n, int grid, int ns, int check_curvature,    \
                      int iters, int cap, void* stream) {                    \
    return iterate<T, P>(pd, offsets, nd, work, partial, sc, st, n, grid,    \
                         ns, check_curvature, iters, cap, stream);           \
  }

KTT_CGLS_INIT(ktt_cg_lanczos_shift_dia_init_f32, float)
KTT_CGLS_INIT(ktt_cg_lanczos_shift_dia_init_f64, double)
KTT_CGLS_ITERATE(ktt_cg_lanczos_shift_dia_iterate_f32_f32, float, float)
KTT_CGLS_ITERATE(ktt_cg_lanczos_shift_dia_iterate_f32_bf16, float,
                 __nv_bfloat16)
KTT_CGLS_ITERATE(ktt_cg_lanczos_shift_dia_iterate_f32_f16, float, __half)
KTT_CGLS_ITERATE(ktt_cg_lanczos_shift_dia_iterate_f64_f64, double, double)
