// The Golub-Kahan launches shared by the LSQR, LSMR, LSLQ, CRAIG, CRAIGMR
// and LNLQ whole-solve kernels (lsqr_dia.cu, lsmr_dia.cu, lslq_dia.cu,
// craig_dia.cu, craigmr_dia.cu, lnlq_dia.cu) on Hopper (sm_90a), with no
// grid-wide barrier.
//
// What they compute is the Golub-Kahan step of the TPU kernels
// krylov_tpu/ops/pallas_fused.py:1394 lsqr_dia_fused, :1641
// lsmr_dia_fused, :6942 lslq_dia_fused, :5922 craig_dia_fused, :6132
// craigmr_dia_fused and :6345 lnlq_dia_fused (pallas_fused.py:1481-1503):
//   u_hat = A v_k - alpha_k u_k,  beta_{k+1} = ||u_hat||,
//   u_{k+1} = u_hat / beta_{k+1}               (u_hat where beta = 0),
//   v_hat = A^H u_{k+1} - beta_{k+1} v_k      (v_k where beta = 0),
//   alpha_{k+1} = ||v_hat||,
//   v_{k+1} = v_hat / alpha_{k+1}             (v_hat where it is 0).
// The two stencils depend on each other (u from A v, then v from A^H u),
// so they take two launches.
//
// Design.  Four launches per iteration:
//   1. gk_av     (grid)    GO; u_hat over u_k in place (a row reads u at
//                          its own row only); partials of ||u_hat||^2
//   2. gk_ahu    (grid)    beta_{k+1}, summed in every block; v_hat over
//                          v_k in place, each neighbour of u_hat divided
//                          by beta as it is read (the TPU kernel
//                          normalises u before its stencil); partials of
//                          ||v_hat||^2
//   3. gk_update (grid)    beta_{k+1} and alpha_{k+1} summed in every
//                          block, and the method's auxiliary sum (the
//                          partials of the last iteration's launch 3);
//                          thread 0 of every block runs the method's
//                          scalar step (Method::step) on the last
//                          iteration's state, and block 0 writes the next
//                          state into the staging copy; then each row
//                          gets u_{k+1} and v_{k+1} in place and the
//                          method's vector updates (Method::update_row),
//                          whose auxiliary partials go to the row of the
//                          other parity
//   4. gk_commit (1 block) the method's tests that need a sum of launch
//                          3 (Method::commit: LSMR's ||x_{k+1}||), the
//                          staging copy into the state, the newest entry
//                          of the error window, and the iteration count
// The state every block of launch 3 reads is only written by launch 4,
// and the auxiliary partials launch 3 reads (parity it mod 2) are not
// those it writes, so no block reads a scalar another block of the same
// launch writes.  No launch writes a vector whose neighbours it reads:
// launch 1 reads v's, launch 2 u's.
//
// Hooks (struct Hooks; LSQR, LSMR and LSLQ take its defaults, which add
// nothing).  The least-norm methods update vectors that need u_k or v_k,
// which launches 1 and 2 overwrite in place, so a method may add row
// updates to those launches, with coefficients that thread 0 of every
// block computes from the state (and, in launch 2, beta_{k+1}):
//   av_row  (launch 1) sees u_k at its row before u_hat goes over it; its
//           partials go to the auxiliary row launch 3 reads (CRAIG's
//           ||w_{k+1}||^2);
//   ahu_row (launch 2) sees v_k and u_{k+1} at its row before v_hat goes
//           over v.
// A method whose runs() is false for the state skips launches 1-3 and has
// the commit set only its status (skip): CRAIG's alpha = 0 exit, which
// counts no iteration.
//
// Layouts.  The scalar array holds the host's parameters (LAM .. UTOL),
// then the state from ALPHA to the method's kNscState, then its staging
// copy (slot j's copy at j + kNscState - ALPHA), then the error window,
// a ring of `window` scalars written only by launch 4.  The int array
// holds IT, STATUS, GO and ZR, then the method's ints up to kNstState,
// then the staging copy of STATUS .. kNstState (slot j's copy at
// j + kNstState - STATUS; GO's copy is unused).
#pragma once

#include "common.cuh"

// Internal linkage, as cg_steps.cuh: each kernel file has its own copies.
namespace {
namespace gk {

using namespace ktt;

constexpr int kThreads = 256;
constexpr int kCommitThreads = 256;

// the status codes of krylov_tpu_torch/_runtime.py
constexpr int RUNNING = 0;
constexpr int ZERO_RESIDUAL = 2;
constexpr int COND_EXCEEDED = 11;
constexpr int SOLVED_LSQ = 20;
constexpr int SOLVED_ZERO = 21;
constexpr int FWD_ERR = 22;
constexpr int ILL_COND_MACH = 23;
constexpr int MIN_LSQ_X = 24;

// The first slots of every method's scalar and int arrays (its own enums
// continue these), the rows of the vector workspace before the method's
// own, and the partial rows (the auxiliary sum in two, by parity).
enum SharedSlot {
  LAM = 0, AXTOL, BTOL, ATOL, RTOL, ETOL, CONLIM, SIGMA, UTOL, ALPHA
};
enum SharedInt { IT = 0, STATUS, GO, ZR };
enum Row { U = 0, V, X, NSHARED_ROWS };
enum Part { PUU = 0, PVV, PAUX, NPART = PAUX + 2 };

template <typename T>
__device__ __forceinline__ T* row(T* work, int r, long long n) {
  return work + static_cast<long long>(r) * n;
}

template <typename T>
__device__ __forceinline__ T sq(T v) { return v * v; }

// The defaults of the hooks (see the top of this file).
struct Hooks {
  static constexpr bool kAvRows = false;
  static constexpr bool kAhuRows = false;
  template <typename T>
  struct Pre {};
  template <typename T>
  __device__ static bool runs(const T*) { return true; }
  __device__ static void skip(int*) {}
};

template <typename T> __device__ __forceinline__ T max_of();
template <>
__device__ __forceinline__ float max_of<float>() { return FLT_MAX; }
template <>
__device__ __forceinline__ double max_of<double>() { return DBL_MAX; }

// 1 / conlim where conlim > 0, else 0 (pallas_fused.py:1427)
template <typename T>
__device__ __forceinline__ T ctol_of(const T* sc) {
  return sc[CONLIM] > T(0) ? T(1) / sc[CONLIM] : T(0);
}

// The error window, after the state and its staging copy.
template <typename Method, typename T>
__device__ __forceinline__ T* ring(T* sc) {
  return sc + 2 * Method::kNscState - ALPHA;
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

// Row i of A^H (z / s): each neighbour of z divided by s as it is read,
// then summed over the diagonals in order.
template <typename T, typename P>
__device__ __forceinline__ T stencil_row_scaled(
    const P* __restrict__ pd, const long long* __restrict__ offsets, int nd,
    const T* __restrict__ z, T s, long long i, long long n) {
  T acc = T(0);
  for (int d = 0; d < nd; ++d) {
    const long long j = i + __ldg(offsets + d);
    if (j >= 0 && j < n) {
      acc = madd(acc, pd[static_cast<long long>(d) * n + i], z[j] / s);
    }
  }
  return acc;
}

// Init: the partials of b'b (row PUU).
template <typename T>
__global__ void __launch_bounds__(kThreads)
gk_init_dots(const T* __restrict__ b, T* __restrict__ partial, long long n) {
  T s = T(0);
  for (long long i = first_row(); i < n; i += row_stride()) s += b[i] * b[i];
  store_partial(s, partial + PUU * gridDim.x);
}

// Init: beta_1 = ||b||, u_1 = b / beta_1 and v_hat = A^H u_1 (each
// neighbour of b divided by beta_1 as it is read), with the partials of
// ||v_hat||^2 (pallas_fused.py:1440-1447).
template <typename T, typename P>
__global__ void __launch_bounds__(kThreads)
gk_init_ahu(const P* __restrict__ pda, const long long* __restrict__ offs_a,
            int nda, const T* __restrict__ b, T* __restrict__ work,
            T* __restrict__ partial, long long n) {
  const int nparts = gridDim.x;
  const T beta1 = safe(sqrt(all_sum(partial + PUU * nparts, nparts)));
  T* u = row(work, U, n);
  T* v = row(work, V, n);
  T s = T(0);
  for (long long i = first_row(); i < n; i += row_stride()) {
    u[i] = b[i] / beta1;
    const T vh = stencil_row_scaled(pda, offs_a, nda, b, beta1, i, n);
    v[i] = vh;
    s += vh * vh;
  }
  store_partial(s, partial + PVV * nparts);
}

// Init: v_1 = v_hat / alpha_1, x = 0 and the method's rows
// (Method::init_row, given alpha_1 and the host's parameters, whose
// partials go to the auxiliary row of parity 0);
// block 0 zeroes the state, its staging copy and the error window and
// sets the method's first state (Method::init_scalars).
template <typename T, typename Method>
__global__ void __launch_bounds__(kThreads)
gk_init_vectors(T* __restrict__ work, T* __restrict__ partial, T* sc, int* st,
                long long n, int flag, int window) {
  const int nparts = gridDim.x;
  const T beta1 = sqrt(all_sum(partial + PUU * nparts, nparts));
  const T anorm2 = all_sum(partial + PVV * nparts, nparts);
  const T alpha = sqrt(anorm2);
  const T sa = safe(alpha);
  T* v = row(work, V, n);
  T* x = row(work, X, n);
  T aux = T(0);
  for (long long i = first_row(); i < n; i += row_stride()) {
    const T vi = v[i] / sa;
    v[i] = vi;
    x[i] = T(0);
    aux += Method::init_row(work, sc, n, i, vi, alpha, flag);
  }
  store_partial(aux, partial + PAUX * nparts);
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    for (int j = ALPHA; j < 2 * Method::kNscState - ALPHA + window; ++j) {
      sc[j] = T(0);
    }
    for (int j = 0; j < 2 * Method::kNstState - STATUS; ++j) st[j] = 0;
    Method::template init_scalars<T>(sc, st, alpha, beta1, anorm2, flag);
  }
}

// 1. Decide whether this iteration runs (GO, read by every later launch
// of the iteration), then u_hat = A v_k - alpha_k u_k over u and the
// partials of ||u_hat||^2; the method's av_row at each row.
template <typename T, typename P, typename Method>
__global__ void __launch_bounds__(kThreads)
gk_av(const P* __restrict__ pd, const long long* __restrict__ offsets, int nd,
      T* __restrict__ work, T* __restrict__ partial, const T* sc, int* st,
      long long n, int cap, int flag) {
  const bool go = st[STATUS] == RUNNING && st[IT] < cap;
  if (blockIdx.x == 0 && threadIdx.x == 0) st[GO] = go ? 1 : 0;
  if (!go || !Method::runs(sc)) return;
  __shared__ typename Method::template Pre<T> pre;
  if constexpr (Method::kAvRows) {
    if (threadIdx.x == 0) pre = Method::av_coef(sc, st, flag);
    __syncthreads();
  }
  const T alpha = sc[ALPHA];
  const T* v = row(work, V, n);
  T* u = row(work, U, n);
  T s = T(0);
  T aux = T(0);
  for (long long i = first_row(); i < n; i += row_stride()) {
    const T ui = u[i];
    const T uh = stencil_row(pd, offsets, nd, v, i, n) - alpha * ui;
    if constexpr (Method::kAvRows) aux += Method::av_row(work, pre, n, i, ui);
    u[i] = uh;
    s += uh * uh;
  }
  store_partial(s, partial + PUU * gridDim.x);
  if constexpr (Method::kAvRows) {
    __syncthreads();
    store_partial(aux, partial + (PAUX + st[IT] % 2) * gridDim.x);
  }
}

// 2. beta_{k+1}; v_hat = A^H (u_hat / beta) - beta v_k over v (v_k where
// beta = 0) and the partials of ||v_hat||^2; the method's ahu_row at each
// row.
template <typename T, typename P, typename Method>
__global__ void __launch_bounds__(kThreads)
gk_ahu(const P* __restrict__ pda, const long long* __restrict__ offs_a,
       int nda, T* __restrict__ work, T* __restrict__ partial, const T* sc,
       const int* st, long long n, int flag) {
  if (!st[GO] || !Method::runs(sc)) return;
  const int nparts = gridDim.x;
  const T beta = sqrt(all_sum(partial + PUU * nparts, nparts));
  __shared__ typename Method::template Pre<T> pre;
  if constexpr (Method::kAhuRows) {
    if (threadIdx.x == 0) pre = Method::ahu_coef(sc, st, beta, flag);
    __syncthreads();
  }
  const T* u = row(work, U, n);
  T* v = row(work, V, n);
  T s = T(0);
  for (long long i = first_row(); i < n; i += row_stride()) {
    T vh = v[i];
    if constexpr (Method::kAhuRows) {
      Method::ahu_row(work, pre, n, i, vh, beta != T(0) ? u[i] / beta : u[i]);
    }
    if (beta != T(0)) {
      vh = stencil_row_scaled(pda, offs_a, nda, u, beta, i, n) - beta * vh;
      v[i] = vh;
    }
    s += vh * vh;
  }
  store_partial(s, partial + PVV * nparts);
}

// 3. beta_{k+1}, alpha_{k+1} and the auxiliary sum; the method's scalar
// step in thread 0 of every block (block 0 stores the next state in the
// staging copy); u_{k+1}, v_{k+1} and the method's row updates.
template <typename T, typename Method>
__global__ void __launch_bounds__(kThreads)
gk_update(T* __restrict__ work, T* __restrict__ partial, T* sc, int* st,
          long long n, int flag, int window) {
  if (!st[GO] || !Method::runs(sc)) return;
  const int nparts = gridDim.x;
  const int it0 = st[IT];
  const T beta = sqrt(all_sum(partial + PUU * nparts, nparts));
  const T vv = all_sum(partial + PVV * nparts, nparts);
  const T aux = all_sum(partial + (PAUX + it0 % 2) * nparts, nparts);
  const bool bnz = beta != T(0);
  const T alpha = bnz ? sqrt(vv) : sc[ALPHA];
  const bool anz = bnz && alpha != T(0);
  __shared__ typename Method::template Coef<T> coef;
  if (threadIdx.x == 0) {
    const bool store = blockIdx.x == 0;
    coef = Method::step(sc, st, alpha, beta, aux, it0 + 1, flag, window,
                        store ? sc + (Method::kNscState - ALPHA) : nullptr,
                        store ? st + (Method::kNstState - STATUS) : nullptr);
  }
  __syncthreads();
  T* u = row(work, U, n);
  T* v = row(work, V, n);
  T s = T(0);
  for (long long i = first_row(); i < n; i += row_stride()) {
    if (bnz) u[i] = u[i] / beta;
    T vi = v[i];
    if (anz) {
      vi = vi / alpha;
      v[i] = vi;
    }
    s += Method::update_row(work, coef, n, i, vi);
  }
  store_partial(s, partial + (PAUX + (it0 + 1) % 2) * nparts);
}

// 4. The method's tests on the sums of launch 3, the staging copy into
// the state, the newest entry of the error window, and the iteration
// count; or, where the method skipped the iteration, its status alone.
template <typename T, typename Method>
__global__ void __launch_bounds__(kCommitThreads)
gk_commit(T* sc, int* st, const T* __restrict__ partial, int nparts,
          int window) {
  if (!st[GO]) return;
  if (!Method::runs(sc)) {
    if (threadIdx.x == 0) Method::skip(st);
    return;
  }
  constexpr int kSc = Method::kNscState - ALPHA;
  constexpr int kSt = Method::kNstState - STATUS;
  const int it0 = st[IT];
  Method::commit(sc + kSc, st + kSt, partial + (PAUX + (it0 + 1) % 2) * nparts,
                 nparts, it0 + 1, window);
  __syncthreads();
  for (int j = ALPHA + threadIdx.x; j < Method::kNscState; j += blockDim.x) {
    sc[j] = sc[j + kSc];
  }
  for (int j = STATUS + threadIdx.x; j < Method::kNstState; j += blockDim.x) {
    if (j != GO) st[j] = st[j + kSt];
  }
  if (threadIdx.x == 0) {
    ring<Method>(sc)[Method::ring_slot(it0, window)] =
        sc[Method::kErrNew + kSc];
    st[IT] = it0 + 1;
  }
}

// The start of a method's step in block 0: the staging copy set to the
// current state, so that slots the step leaves alone commit unchanged.
template <typename T, typename Method>
__device__ __forceinline__ void stage_state(const T* sc, const int* st,
                                            T* nsc, int* nst) {
  for (int j = ALPHA; j < Method::kNscState; ++j) nsc[j] = sc[j];
  for (int j = STATUS; j < Method::kNstState; ++j) nst[j] = st[j];
}

// sqrt of the sum of squares of the error window with `fresh` in slot
// `slot`, summed over the slots from `first` on, circularly (the order
// of the TPU kernel's window).
template <typename Method, typename T>
__device__ __forceinline__ T window_norm(const T* sc, int window, int first,
                                         int slot, T fresh) {
  const T* ev = ring<Method>(const_cast<T*>(sc));
  T s = T(0);
  for (int j = 0; j < window; ++j) {
    const int k = (first + j) % window;
    s += sq(k == slot ? fresh : ev[k]);
  }
  return sqrt(s);
}

// The init, per-iteration and finishing launch sequences; a method
// derives from Hooks and supplies
//   Method::init_row<T>(work, sc, n, i, v1, alpha1, flag) (gk_init_vectors)
//   Method::init_scalars<T>(sc, st, alpha1, beta1, alpha1^2 as summed,
//                           flag)                      (one thread)
//   Method::step<T>(...), Method::update_row<T>(...)   (gk_update)
//   Method::commit<T>(...)                              (gk_commit)
//   Method::finishes<T>(sc, st, flag), finish_row<T>(...) (finish)
//   and, where it sets kAvRows or kAhuRows, its Pre<T> and av_coef/av_row
//   or ahu_coef/ahu_row (launches 1 and 2), and runs/skip
// the number of its own work rows (kRows), the ends of its scalar and
// int states (kNscState, kNstState), the state slot of the error
// window's newest entry (kErrNew) and the ring slot it goes to
// (ring_slot(it0, window)).
template <typename T, typename P, typename Method>
int init(const void* pda_, const void* offsets_a_, int nda, const void* b_,
         void* work_, void* partial_, void* sc_, void* st_, long long n,
         int grid, int flag, int window, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* b = static_cast<const T*>(b_);
  T* work = static_cast<T*>(work_);
  T* partial = static_cast<T*>(partial_);
  gk_init_dots<T><<<grid, kThreads, 0, s>>>(b, partial, n);
  gk_init_ahu<T, P><<<grid, kThreads, 0, s>>>(
      static_cast<const P*>(pda_), static_cast<const long long*>(offsets_a_),
      nda, b, work, partial, n);
  gk_init_vectors<T, Method><<<grid, kThreads, 0, s>>>(
      work, partial, static_cast<T*>(sc_), static_cast<int*>(st_), n, flag,
      window);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename P, typename Method>
int iterate(const void* pd_, const void* offsets_, int nd, const void* pda_,
            const void* offsets_a_, int nda, void* work_, void* partial_,
            void* sc_, void* st_, long long n, int grid, int flag, int window,
            int iters, int cap, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const P* pd = static_cast<const P*>(pd_);
  const long long* offs = static_cast<const long long*>(offsets_);
  const P* pda = static_cast<const P*>(pda_);
  const long long* offs_a = static_cast<const long long*>(offsets_a_);
  T* work = static_cast<T*>(work_);
  T* partial = static_cast<T*>(partial_);
  T* sc = static_cast<T*>(sc_);
  int* st = static_cast<int*>(st_);
  for (int j = 0; j < iters; ++j) {
    gk_av<T, P, Method><<<grid, kThreads, 0, s>>>(pd, offs, nd, work,
                                                  partial, sc, st, n, cap,
                                                  flag);
    gk_ahu<T, P, Method><<<grid, kThreads, 0, s>>>(pda, offs_a, nda, work,
                                                   partial, sc, st, n, flag);
    gk_update<T, Method><<<grid, kThreads, 0, s>>>(work, partial, sc, st, n,
                                                   flag, window);
    gk_commit<T, Method><<<1, kCommitThreads, 0, s>>>(sc, st, partial, grid,
                                                      window);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

// After the loop: the method's final vector update, row by row.
template <typename T, typename Method>
__global__ void __launch_bounds__(kThreads)
gk_finish(T* __restrict__ work, const T* sc, const int* st, long long n,
          int flag) {
  if (!Method::template finishes<T>(sc, st, flag)) return;
  for (long long i = first_row(); i < n; i += row_stride()) {
    Method::template finish_row<T>(work, sc, n, i, flag);
  }
}

template <typename T, typename Method>
int finish(void* work, const void* sc, const void* st, long long n, int grid,
           int flag, void* stream) {
  gk_finish<T, Method><<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<T*>(work), static_cast<const T*>(sc),
      static_cast<const int*>(st), n, flag);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace gk
}  // namespace

// The C entry points of a method: init and iterate for every (vector,
// diagonal) type pair, and finish for f32 and f64.
#define KTT_GK_INIT(NAME, T, P, METHOD)                                       \
  extern "C" int NAME(const void* pda, const void* offsets_a, int nda,       \
                      const void* b, void* work, void* partial, void* sc,    \
                      void* st, long long n, int grid, int flag, int window, \
                      void* stream) {                                        \
    return gk::init<T, P, METHOD>(pda, offsets_a, nda, b, work, partial, sc, \
                                  st, n, grid, flag, window, stream);        \
  }

#define KTT_GK_ITERATE(NAME, T, P, METHOD)                                    \
  extern "C" int NAME(const void* pd, const void* offsets, int nd,           \
                      const void* pda, const void* offsets_a, int nda,       \
                      void* work, void* partial, void* sc, void* st,         \
                      long long n, int grid, int flag, int window, int iters,\
                      int cap, void* stream) {                               \
    return gk::iterate<T, P, METHOD>(pd, offsets, nd, pda, offsets_a, nda,   \
                                     work, partial, sc, st, n, grid, flag,   \
                                     window, iters, cap, stream);            \
  }

#define KTT_GK_FINISH(NAME, T, METHOD)                                        \
  extern "C" int NAME(void* work, const void* sc, const void* st,            \
                      long long n, int grid, int flag, void* stream) {       \
    return gk::finish<T, METHOD>(work, sc, st, n, grid, flag, stream);       \
  }
