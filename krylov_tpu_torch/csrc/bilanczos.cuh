// The two-sided Lanczos launches shared by the BiLQ, QMR and BiLQR
// whole-solve kernels (bilq_dia.cu, qmr_dia.cu, bilqr_dia.cu) on Hopper
// (sm_90a), with no grid-wide barrier.
//
// What they compute is the bi-Lanczos step of the TPU kernels
// krylov_tpu/ops/pallas_fused.py:4545 bilq_dia_fused, :4755
// qmr_dia_fused and :7400 bilqr_dia_fused (pallas_fused.py:4617-4632):
//   q = A v_k - gamma_k v_{k-1},  p = A^H u_k - beta_k u_{k-1},
//   alpha = <u_k, q>,  q -= alpha v_k,  p -= alpha u_k,  <p, q>,
// with <p, q> taken after both updates, as the TPU kernels take it.
//
// Design.  An iteration's first two launches are these:
//   1. bl_stencil (grid)  GO, q = A v_k - gamma v_{k-1} and
//                         p = A^H u_k - beta u_{k-1} on the two sets of
//                         aligned diagonals, partials of <u_k, q> (and,
//                         for BiLQR's dual residual, of <u_k, u_k>)
//   2. bl_alpha   (grid)  alpha = the sum of those partials in every
//                         block (a fixed order, so every block holds the
//                         same value); q -= alpha v_k, p -= alpha u_k,
//                         partials of <p, q>
// Each method's own grid launch follows (bi_next_scalars and
// bi_next_row form v_{k+1} = q / beta_{k+1} and u_{k+1} = p / gamma_{k+1}
// in place, beside the method's vector updates), then its one-block
// scalar launch.  v and u each rotate through three buffers by the
// iteration count: v_k in buffer it mod 3, v_{k-1} in (it + 2) mod 3,
// and q, which becomes v_{k+1}, in (it + 1) mod 3.  The stencils read
// the neighbours of v_k and u_k only, and no launch writes a buffer
// whose neighbours it reads; v_{k-1} and u_{k-1} stay whole through the
// iteration (BiLQR's dual update reads u_{k-1} in its third launch).
#pragma once

#include "common.cuh"

// Internal linkage, as cg_steps.cuh: each kernel file has its own copies.
namespace {
namespace bilanczos {

using namespace ktt;

constexpr int kThreads = 256;
constexpr int kReduceThreads = 1024;

constexpr int RUNNING = 0;
constexpr int SOLVED = 1;
constexpr int ZERO_RESIDUAL = 2;
constexpr int SOLVED_PRIMAL_DUAL = 15;
constexpr int BC_BREAKDOWN = 29;
constexpr int SOLVED_LQ = 35;
constexpr int SOLVED_CG = 36;
constexpr int UV_BREAKDOWN = 38;

// The first slots of every method's scalar and int arrays (its own
// enums continue these), the rows of the vector workspace before the
// method's own (V0 = 0 .. 2, U0 = 3 .. 5), and the partial rows.
enum SharedSlot { ATOL = 0, RTOL, BETA, GAMMA, ALPHA, PHQ, BETA1, GAMMA1 };
enum SharedInt { IT = 0, STATUS, GO };
enum Row { V0 = 0, U0 = 3, NSHARED_ROWS = 6 };
enum Part { PUQ = 0, PUU, PPQ, PVV, PNN, NPART };

template <typename T>
__device__ __forceinline__ T* row(T* work, int r, long long n) {
  return work + static_cast<long long>(r) * n;
}
// the buffers of v_k (or u_k), v_{k-1} and q (which becomes v_{k+1})
__device__ __forceinline__ int cur(int it0) { return it0 % 3; }
__device__ __forceinline__ int prev(int it0) { return (it0 + 2) % 3; }
__device__ __forceinline__ int next(int it0) { return (it0 + 1) % 3; }

// The same sum of block partials in every block of a launch.
template <typename T>
__device__ __forceinline__ T all_sum(const T* partial, int nparts) {
  __shared__ T sum;
  const T s = sum_partials(partial, nparts);
  if (threadIdx.x == 0) sum = s;
  __syncthreads();
  return sum;
}

// Init: the partials of b'b (row PUQ), c'c (row PUU) and c'b (row PPQ).
template <typename T>
__global__ void __launch_bounds__(kThreads)
bl_init_dots(const T* __restrict__ b, const T* __restrict__ c,
             T* __restrict__ partial, long long n) {
  T sbb = T(0);
  T scc = T(0);
  T scb = T(0);
  for (long long i = first_row(); i < n; i += row_stride()) {
    const T bi = b[i];
    const T ci = c[i];
    sbb += bi * bi;
    scc += ci * ci;
    scb += ci * bi;
  }
  const int nparts = gridDim.x;
  store_partials(sbb, partial + PUQ * nparts, scc, partial + PUU * nparts);
  __syncthreads();
  store_partial(scb, partial + PPQ * nparts);
}

// Init: v_1 = b / beta_1, u_1 = c / gamma_1 (buffer 0), v_0 = u_0 = 0
// (buffer 2), and rows first .. nrows - 1 of the method's own vectors
// zeroed.
template <typename T>
__global__ void __launch_bounds__(kThreads)
bl_init_vectors(const T* __restrict__ b, const T* __restrict__ c,
                T* __restrict__ work, const T* sc, long long n, int first,
                int nrows) {
  const T beta = safe(sc[BETA]);
  const T gamma = safe(sc[GAMMA]);
  for (long long i = first_row(); i < n; i += row_stride()) {
    row(work, V0, n)[i] = b[i] / beta;
    row(work, U0, n)[i] = c[i] / gamma;
    row(work, V0 + 2, n)[i] = T(0);
    row(work, U0 + 2, n)[i] = T(0);
    for (int r = first; r < nrows; ++r) row(work, r, n)[i] = T(0);
  }
}

// 1. Decide whether this iteration runs (GO, read by every later launch
// of the iteration), then q and p and the partials of <u_k, q> (and of
// <u_k, u_k> with with_uu).
template <typename T, typename P>
__global__ void __launch_bounds__(kThreads)
bl_stencil(const P* __restrict__ pd, const long long* __restrict__ offsets,
           int nd, const P* __restrict__ pda,
           const long long* __restrict__ offsets_a, int nda,
           T* __restrict__ work, T* __restrict__ partial, const T* sc,
           int* st, long long n, int cap, int with_uu) {
  const int it0 = st[IT];
  const bool go = st[STATUS] == RUNNING && it0 < cap;
  if (blockIdx.x == 0 && threadIdx.x == 0) st[GO] = go ? 1 : 0;
  if (!go) return;
  const T beta = sc[BETA];
  const T gamma = sc[GAMMA];
  const T* vk = row(work, V0 + cur(it0), n);
  const T* vkm1 = row(work, V0 + prev(it0), n);
  T* q = row(work, V0 + next(it0), n);
  const T* uk = row(work, U0 + cur(it0), n);
  const T* ukm1 = row(work, U0 + prev(it0), n);
  T* p = row(work, U0 + next(it0), n);
  T suq = T(0);
  T suu = T(0);
  for (long long i = first_row(); i < n; i += row_stride()) {
    const T qi = stencil_row(pd, offsets, nd, vk, i, n) - gamma * vkm1[i];
    const T pi = stencil_row(pda, offsets_a, nda, uk, i, n) - beta * ukm1[i];
    q[i] = qi;
    p[i] = pi;
    const T ui = uk[i];
    suq += ui * qi;
    suu += ui * ui;
  }
  const int nparts = gridDim.x;
  if (with_uu) {
    store_partials(suq, partial + PUQ * nparts, suu, partial + PUU * nparts);
  } else {
    store_partial(suq, partial + PUQ * nparts);
  }
}

// 2. alpha = <u_k, q>; q -= alpha v_k, p -= alpha u_k; partials of
// <p, q>.
template <typename T>
__global__ void __launch_bounds__(kThreads)
bl_alpha(T* __restrict__ work, T* __restrict__ partial, T* sc,
         const int* st, long long n) {
  if (!st[GO]) return;
  const int nparts = gridDim.x;
  const T alpha = all_sum(partial + PUQ * nparts, nparts);
  if (blockIdx.x == 0 && threadIdx.x == 0) sc[ALPHA] = alpha;
  const int it0 = st[IT];
  const T* vk = row(work, V0 + cur(it0), n);
  T* q = row(work, V0 + next(it0), n);
  const T* uk = row(work, U0 + cur(it0), n);
  T* p = row(work, U0 + next(it0), n);
  T s = T(0);
  for (long long i = first_row(); i < n; i += row_stride()) {
    const T qi = q[i] - alpha * vk[i];
    const T pi = p[i] - alpha * uk[i];
    q[i] = qi;
    p[i] = pi;
    s += pi * qi;
  }
  store_partial(s, partial + PPQ * nparts);
}

// The head of a method's third launch: <p, q> summed in every block,
// beta_{k+1} = sqrt|<p, q>| and gamma_{k+1} = <p, q> / beta_{k+1}; block
// 0 stores the three.
template <typename T>
__device__ __forceinline__ void bi_next_scalars(const T* partial, T* sc,
                                                T& phq, T& beta1,
                                                T& gamma1) {
  const int nparts = gridDim.x;
  phq = all_sum(partial + PPQ * nparts, nparts);
  beta1 = sqrt(fabs(phq));
  gamma1 = phq / safe(beta1);
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    sc[PHQ] = phq;
    sc[BETA1] = beta1;
    sc[GAMMA1] = gamma1;
  }
}

// Row i of v_{k+1} = q / beta_{k+1} and u_{k+1} = p / gamma_{k+1}, in
// place of q and p; where <p, q> = 0 they keep v_k and u_k
// (pallas_fused.py:4660-4662).  Returns v_{k+1}[i].
template <typename T>
__device__ __forceinline__ T bi_next_row(T* work, int it0, long long n,
                                         long long i, T phq, T beta1,
                                         T gamma1) {
  T* q = row(work, V0 + next(it0), n);
  T* p = row(work, U0 + next(it0), n);
  const bool nz = phq != T(0);
  const T vn = nz ? q[i] / safe(beta1) : row(work, V0 + cur(it0), n)[i];
  const T un = nz ? p[i] / safe(gamma1) : row(work, U0 + cur(it0), n)[i];
  q[i] = vn;
  p[i] = un;
  return vn;
}

// The init and per-iteration launch sequences; a method supplies
//   Method::init_scalars<T>(partial, grid, sc, st, stream)
//   Method::next<T>(work, partial, sc, st, n, grid, flag, stream)
//   Method::scalars<T>(partial, grid, sc, st, flag, stream)
// the number of its own work rows (Method::kRows), and whether the
// stencil launch takes the partials of <u_k, u_k> (Method::kWithUU).
template <typename T, typename Method>
int init(const void* b_, const void* c_, void* work_, void* partial_,
         void* sc_, void* st_, long long n, int grid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* b = static_cast<const T*>(b_);
  const T* c = static_cast<const T*>(c_);
  T* partial = static_cast<T*>(partial_);
  T* sc = static_cast<T*>(sc_);
  bl_init_dots<T><<<grid, kThreads, 0, s>>>(b, c, partial, n);
  Method::template init_scalars<T>(partial, grid, sc, static_cast<int*>(st_),
                                   s);
  bl_init_vectors<T><<<grid, kThreads, 0, s>>>(
      b, c, static_cast<T*>(work_), sc, n, NSHARED_ROWS,
      NSHARED_ROWS + Method::kRows);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename P, typename Method>
int iterate(const void* pd_, const void* offsets_, int nd, const void* pda_,
            const void* offsets_a_, int nda, void* work_, void* partial_,
            void* sc_, void* st_, long long n, int grid, int flag, int iters,
            int cap, void* stream) {
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
    bl_stencil<T, P><<<grid, kThreads, 0, s>>>(pd, offs, nd, pda, offs_a,
                                               nda, work, partial, sc, st, n,
                                               cap, Method::kWithUU);
    bl_alpha<T><<<grid, kThreads, 0, s>>>(work, partial, sc, st, n);
    Method::template next<T>(work, partial, sc, st, n, grid, flag, s);
    Method::template scalars<T>(partial, grid, sc, st, flag, s);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace bilanczos
}  // namespace
