// The two-sided Lanczos launches shared by the BiLQ, QMR and BiLQR
// whole-solve kernels (bilq_dia.cu, qmr_dia.cu, bilqr_dia.cu) on Hopper
// (sm_90a), with no grid-wide barrier.
//
// What they compute is the bi-Lanczos step of the TPU kernels
// krylov_tpu/ops/pallas_fused.py:4545 bilq_dia_fused, :4755
// qmr_dia_fused and :7400 bilqr_dia_fused (pallas_fused.py:4617-4632):
//   q = A v_k - gamma_k v_{k-1},  p = A^H u_k - beta_k u_{k-1},
//   alpha = <u_k, q>,  q -= alpha v_k,  p -= alpha u_k,  <p, q>,
// with <p, q> taken after both updates, as the TPU kernels take it, and
// v_{k+1} = q / beta_{k+1}, u_{k+1} = p / gamma_{k+1}, where
// beta_{k+1} = sqrt|<p, q>|, gamma_{k+1} = <p, q> / beta_{k+1}; where
// <p, q> = 0 they keep v_k and u_k.  v and u each rotate through three
// buffers by the iteration count: v_k in buffer it mod 3, v_{k-1} in
// (it + 2) mod 3, and q, then v_{k+1}, in (it + 1) mod 3.  The stencil
// reads the neighbours of v_k and u_k only, and no launch writes a
// buffer whose neighbours it reads.
//
// An iteration is four launches:
//   1. two_sided_stencil (grid)  GO; q = A v_k - gamma v_{k-1} and
//                            p = A^H u_k - beta u_{k-1} on the two sets
//                            of aligned diagonals, written once;
//                            partials of <u_k, q> (and, for BiLQR's dual
//                            residual, of <u_k, u_k>)
//   2. the method's fused launch (grid): alpha = the sum of those
//                            partials in every block (a fixed order, so
//                            every block holds the same value, AlphaRows);
//                            q -= alpha v_k and p -= alpha u_k written
//                            once; partials of <p, q>, <v_k, q>, ||q||^2
//                            and ||v_k||^2; the method's vector updates
//                            in the same pass over the rows
//   3. bl_normalise (grid)   <p, q> summed in every block, beta_{k+1} and
//                            gamma_{k+1} (block 0 stores the three for
//                            launch 4), and v_{k+1} = q / beta_{k+1},
//                            u_{k+1} = p / gamma_{k+1} in place of q and p
//                            (v_k and u_k where <p, q> = 0)
//   4. the method's scalar launch (1 block): the method's chains from
//                            launch 3's <p, q>, beta_{k+1} and
//                            gamma_{k+1}, in one thread
// Each value of q and p is divided once, by the pass of launch 3, so the
// stencil and the fused launch read v and u as stored: dividing each
// neighbour as it is read, with or without a shared tile of divided
// values, cost the stencil more than that pass (PERF.md section 6).
//
// The stencil is common.cuh's pair_stencil, which it shares with
// ssy.cuh, on dia_spmv.cu's design (common.cuh dia_rows): a thread
// owns R = 2 consecutive rows (kPairRows), pd read R entries at a time
// and x where i + k_d is a multiple of R, the offsets in shared
// memory, an interior [lo, hi) for each of A and A^H, computed on the
// host once per solve, with no bounds branch, masked rows outside it, a
// scalar path where n is no multiple of R or a buffer is not 16-byte
// aligned.  Each row sums its diagonals in order, as stencil_row.  The
// dots keep the order of a grid of 256-thread blocks that own one row a
// thread, 256-row chunks a grid stride apart (thread t of block b takes
// rows b 256 + t + m 256 grid, m = 0, 1, ...): the stencil's blocks are
// of 256 / R threads and walk the same chunks, each thread R consecutive
// rows of a chunk, always the same R of the 256, with R running sums
// that take their rows in that order; the block's partial is summed in
// the shuffle tree a 256-thread block would take (store_spread_partial).
// Then the per-block partials are summed in a kThreads block's strides
// (alpha in every block of the fused launch; <p, q> in every block of
// launch 3; <u_k, u_k> in the scalar launch's strides).  So q, p and
// every dot are bit for bit those of a one-row-a-thread grid, and no
// launch hands a value from thread to thread.  Every dot is summed in T,
// as the TPU kernel sums them, but ||q||^2, summed in double (Dot).
// <v_k, v_{k+1}> and ||v_{k+1}||^2 are <v_k, q> / beta_{k+1} and
// ||q||^2 / beta_{k+1}^2 (||v_k||^2 for both where <p, q> = 0): a
// division after the sum in place of a sum over v_{k+1}'s rows.
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
// method's own (V0 = 0 .. 2, U0 = 3 .. 5), and the partial rows: PVV
// <v_k, q>, PNN ||q||^2, PKK ||v_k||^2.  PHQ, BETA1 and GAMMA1 hold
// <p, q>, beta_{k+1} and gamma_{k+1} from launch 3 to launch 4, which
// moves the last two into BETA and GAMMA.
enum SharedSlot { ATOL = 0, RTOL, BETA, GAMMA, ALPHA, PHQ, BETA1, GAMMA1 };
enum SharedInt { IT = 0, STATUS, GO };
enum Row { V0 = 0, U0 = 3, NSHARED_ROWS = 6 };
enum Part { PUQ = 0, PUU, PPQ, PVV, PNN, PKK, NPART };

template <typename T>
__device__ __forceinline__ T* row(T* work, int r, long long n) {
  return work + static_cast<long long>(r) * n;
}
// the buffers of v_k (or u_k), v_{k-1} and q (which becomes v_{k+1})
__device__ __forceinline__ int cur(int it0) { return it0 % 3; }
__device__ __forceinline__ int prev(int it0) { return (it0 + 2) % 3; }
__device__ __forceinline__ int next(int it0) { return (it0 + 1) % 3; }

// The partial array is of doubles.  Every row but PNN (alpha,
// <u_k, u_k>, <p, q>, <v_k, q>, ||v_k||^2) holds sums taken in T, as the
// TPU kernel takes its dots, converted exactly; ||q||^2 (PNN) is summed
// in double, per thread, per block and across blocks, and rounded to T
// once where it is read: q is kept as it is, about beta_{k+1} times
// v_{k+1}, so in f32 ||q||^2 can leave the range of the type where
// ||v_{k+1}||^2 does not (it did in an f32 BiLQR run at 16^3, whose
// estimate then went NaN).
using Dot = double;

// This block's sum of s (in T), stored as D at partial[blockIdx.x].
template <typename T, typename D>
__device__ __forceinline__ void store_partial(T s, D* partial) {
  s = block_sum(s);
  if (threadIdx.x == 0) partial[blockIdx.x] = static_cast<D>(s);
}

template <typename T, typename D>
__device__ __forceinline__ void store_partials(T s1, D* partial1, T s2,
                                               D* partial2) {
  store_partial(s1, partial1);
  __syncthreads();
  store_partial(s2, partial2);
}

// The sum in T of a row of per-block partials stored as Dot, in
// sum_partials' order; valid in thread 0.
template <typename T>
__device__ __forceinline__ T sum_partials_in(const Dot* partial, int nparts) {
  T s = T(0);
  for (int i = threadIdx.x; i < nparts; i += blockDim.x) {
    s += static_cast<T>(partial[i]);
  }
  return block_sum(s);
}

// The same sum in every block of a launch.
template <typename T>
__device__ __forceinline__ T all_sum_in(const Dot* partial, int nparts) {
  __shared__ T sum;
  const T s = sum_partials_in<T>(partial, nparts);
  if (threadIdx.x == 0) sum = s;
  __syncthreads();
  return sum;
}

// Init: the partials of b'b (row PUQ), c'c (row PUU) and c'b (row PPQ).
template <typename T>
__global__ void __launch_bounds__(kThreads)
bl_init_dots(const T* __restrict__ b, const T* __restrict__ c,
             Dot* __restrict__ partial, long long n) {
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

// The end of a scalar launch, in its one thread: beta_{k+1} and
// gamma_{k+1} become beta and gamma.
template <typename T>
__device__ __forceinline__ void commit_lanczos(T* sc) {
  sc[BETA] = sc[BETA1];
  sc[GAMMA] = sc[GAMMA1];
}

// 1. Decide whether this iteration runs (GO, read by every later launch
// of the iteration), then q and p, each written once, and the partials
// of <u_k, q> (and of <u_k, u_k> with with_uu), on common.cuh's
// pair_stencil in blocks of kThreads / R threads.  [lo, hi) and
// [lo_a, hi_a) are the interiors of A's and A^H's offsets; with VEC, pd,
// pda and the work rows are 16-byte aligned and n is a multiple of R.
template <typename T, typename P, bool VEC>
__global__ void __launch_bounds__(kThreads / kPairRows)
two_sided_stencil(const P* __restrict__ pd,
                  const long long* __restrict__ offsets, int nd,
                  const P* __restrict__ pda,
                  const long long* __restrict__ offsets_a, int nda,
                  long long lo, long long hi, long long lo_a, long long hi_a,
                  T* __restrict__ work, Dot* __restrict__ partial,
                  const T* sc, int* st, long long n, int cap, int with_uu) {
  const int it0 = st[IT];
  const bool go = st[STATUS] == RUNNING && it0 < cap;
  if (blockIdx.x == 0 && threadIdx.x == 0) st[GO] = go ? 1 : 0;
  if (!go) return;
  const T* uk = row(work, U0 + cur(it0), n);
  const int nparts = gridDim.x;
  pair_stencil<T, P, VEC>(
      pd, offsets, nd, pda, offsets_a, nda, lo, hi, lo_a, hi_a,
      row(work, V0 + cur(it0), n), uk, row(work, V0 + prev(it0), n),
      sc[GAMMA], row(work, U0 + prev(it0), n), sc[BETA], uk,
      row(work, V0 + next(it0), n), row(work, U0 + next(it0), n),
      partial + PUQ * nparts, with_uu ? partial + PUU * nparts : nullptr, n,
      NoRows{});
}

// 2. The head and the Lanczos rows of a method's fused launch: alpha =
// <u_k, q> summed in every block (block 0 stores it), then, row by row,
// q -= alpha v_k and p -= alpha u_k, written once; t gathers the row's
// terms of <p, q>, <v_k, q> and ||v_k||^2 (in T) and qq that of ||q||^2
// (in Dot).
template <typename T>
struct AlphaRows {
  const T* vk;
  const T* uk;
  T* q;
  T* p;
  T alpha;

  __device__ __forceinline__ AlphaRows(T* work, const Dot* partial, T* sc,
                                       int it0, long long n) {
    const int nparts = gridDim.x;
    alpha = all_sum_in<T>(partial + PUQ * nparts, nparts);
    if (blockIdx.x == 0 && threadIdx.x == 0) sc[ALPHA] = alpha;
    vk = row(work, V0 + cur(it0), n);
    uk = row(work, U0 + cur(it0), n);
    q = row(work, V0 + next(it0), n);
    p = row(work, U0 + next(it0), n);
  }

  // Row i's values, loaded before any store of the launch's row pass:
  // the rows are distinct buffers of one array, which the compiler cannot
  // know, so each launch loads a row's every value first.
  struct Vals {
    T v, u, q, p;
  };
  __device__ __forceinline__ Vals load(long long i) const {
    return Vals{vk[i], uk[i], q[i], p[i]};
  }

  // Row i from its loaded values; returns v_k[i].
  __device__ __forceinline__ T step(long long i, const Vals& a, T (&t)[3],
                                    Dot& qq) const {
    const T vi = a.v;
    const T qi = a.q - alpha * vi;
    const T pi = a.p - alpha * a.u;
    q[i] = qi;
    p[i] = pi;
    t[0] += pi * qi;
    t[1] += vi * qi;
    t[2] += vi * vi;
    const Dot qd = qi;
    qq += qd * qd;
    return vi;
  }
};

// 3. v_{k+1} = q / beta_{k+1} and u_{k+1} = p / gamma_{k+1} in place of
// q and p, or, where <p, q> = 0, v_k and u_k (pallas_fused.py:4660-4662),
// with <p, q> summed in every block; block 0 stores <p, q>, beta_{k+1}
// and gamma_{k+1} for the scalar launch.  Each value is divided once, as
// the TPU kernel and the plain version divide it.
template <typename T>
__global__ void __launch_bounds__(kThreads)
bl_normalise(T* __restrict__ work, const Dot* __restrict__ partial, T* sc,
             const int* st, long long n) {
  if (!st[GO]) return;
  const int nparts = gridDim.x;
  const T phq = all_sum_in<T>(partial + PPQ * nparts, nparts);
  const T beta1 = sqrt(fabs(phq));
  const T gamma1 = phq / safe(beta1);
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    sc[PHQ] = phq;
    sc[BETA1] = beta1;
    sc[GAMMA1] = gamma1;
  }
  // beta_{k+1} > 0 and gamma_{k+1} != 0 where <p, q> != 0
  const bool nz = phq != T(0);
  const int it0 = st[IT];
  const T* vk = row(work, V0 + cur(it0), n);
  const T* uk = row(work, U0 + cur(it0), n);
  T* q = row(work, V0 + next(it0), n);
  T* p = row(work, U0 + next(it0), n);
  for (long long i = first_row(); i < n; i += row_stride()) {
    const T qi = nz ? q[i] : vk[i];
    const T pi = nz ? p[i] : uk[i];
    q[i] = nz ? qi / beta1 : qi;
    p[i] = nz ? pi / gamma1 : pi;
  }
}

// The fused launch's partials: rows PPQ, PVV and PKK in T, PNN in Dot.
template <typename T>
__device__ __forceinline__ void store_alpha_partials(const T (&t)[3], Dot qq,
                                                     Dot* partial) {
  const int nparts = gridDim.x;
  store_partial(t[0], partial + PPQ * nparts);
  __syncthreads();
  store_partial(t[1], partial + PVV * nparts);
  __syncthreads();
  store_partial(t[2], partial + PKK * nparts);
  __syncthreads();
  store_partial(qq, partial + PNN * nparts);
}

// The scalar launches' sums of the partials, valid in thread 0.
template <typename T>
struct LanczosSums {
  T uu, vq, vv;
  Dot qq;
};

template <typename T>
__device__ __forceinline__ LanczosSums<T> lanczos_sums(const Dot* partial,
                                                       int nparts) {
  // each row in sum_partials' order, three rows in one block tree
  T v[3] = {T(0), T(0), T(0)};
  Dot qq = Dot(0);
  for (int i = threadIdx.x; i < nparts; i += blockDim.x) {
    v[0] += static_cast<T>(partial[PUU * nparts + i]);
    v[1] += static_cast<T>(partial[PVV * nparts + i]);
    v[2] += static_cast<T>(partial[PKK * nparts + i]);
    qq += partial[PNN * nparts + i];
  }
  __shared__ T t[3];
  block_sums<T, 3>(v, t, 0);
  LanczosSums<T> r;
  r.qq = block_sum(qq);
  r.uu = t[0];
  r.vq = t[1];
  r.vv = t[2];
  return r;
}

// The next Lanczos vectors' inner products from the sums, <v_k, v_{k+1}>
// = <v_k, q> / beta_{k+1} and ||v_{k+1}||^2 = ||q||^2 / beta_{k+1}^2 (in
// double); ||v_k||^2 for both where <p, q> = 0.
template <typename T>
__device__ __forceinline__ T next_dot(const LanczosSums<T>& sums, T phq,
                                      T beta1) {
  return phq != T(0) ? sums.vq / safe(beta1) : sums.vv;
}

template <typename T>
__device__ __forceinline__ T next_norm2(const LanczosSums<T>& sums, T phq,
                                        T beta1) {
  const Dot b1 = safe(beta1);
  return phq != T(0) ? static_cast<T>(sums.qq / (b1 * b1)) : sums.vv;
}

// The init; a method supplies
//   Method::init_scalars<T>(partial, grid, sc, st, stream)
// and the number of its own work rows (Method::kRows).
template <typename T, typename Method>
int init(const void* b_, const void* c_, void* work_, void* partial_,
         void* sc_, void* st_, long long n, int grid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* b = static_cast<const T*>(b_);
  const T* c = static_cast<const T*>(c_);
  Dot* partial = static_cast<Dot*>(partial_);
  T* sc = static_cast<T*>(sc_);
  bl_init_dots<T><<<grid, kThreads, 0, s>>>(b, c, partial, n);
  Method::template init_scalars<T>(partial, grid, sc, static_cast<int*>(st_),
                                   s);
  bl_init_vectors<T><<<grid, kThreads, 0, s>>>(
      b, c, static_cast<T*>(work_), sc, n, NSHARED_ROWS,
      NSHARED_ROWS + Method::kRows);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename P, bool VEC, typename Method>
int steps(const P* pd, const long long* offs, int nd, const P* pda,
          const long long* offs_a, int nda, long long lo, long long hi,
          long long lo_a, long long hi_a, T* work, Dot* partial, T* sc,
          int* st, long long n, int grid, int flag, int iters, int cap,
          cudaStream_t s) {
  constexpr int kStencilThreads = kThreads / kPairRows;
  for (int j = 0; j < iters; ++j) {
    two_sided_stencil<T, P, VEC><<<grid, kStencilThreads, 0, s>>>(
        pd, offs, nd, pda, offs_a, nda, lo, hi, lo_a, hi_a, work, partial,
        sc, st, n, cap, Method::kWithUU);
    Method::template fused<T>(work, partial, sc, st, n, grid, s);
    bl_normalise<T><<<grid, kThreads, 0, s>>>(work, partial, sc, st, n);
    Method::template scalars<T>(partial, grid, sc, st, flag, s);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

// iters iterations; [lo, hi) and [lo_a, hi_a) are the interiors of A's
// and A^H's offsets (ops/cuda_dia.py _interior).  A method supplies
//   Method::fused<T>(work, partial, sc, st, n, grid, stream)
//   Method::scalars<T>(partial, grid, sc, st, flag, stream)
// and whether the stencil takes the partials of <u_k, u_k>
// (Method::kWithUU).
template <typename T, typename P, typename Method>
int iterate(const void* pd_, const void* offsets_, int nd, const void* pda_,
            const void* offsets_a_, int nda, long long lo, long long hi,
            long long lo_a, long long hi_a, void* work_, void* partial_,
            void* sc_, void* st_, long long n, int grid, int flag, int iters,
            int cap, void* stream) {
  constexpr int R = kPairRows;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const P* pd = static_cast<const P*>(pd_);
  const long long* offs = static_cast<const long long*>(offsets_);
  const P* pda = static_cast<const P*>(pda_);
  const long long* offs_a = static_cast<const long long*>(offsets_a_);
  T* work = static_cast<T*>(work_);
  Dot* partial = static_cast<Dot*>(partial_);
  T* sc = static_cast<T*>(sc_);
  int* st = static_cast<int*>(st_);
  const bool vec = n % R == 0 && aligned16(pd_) && aligned16(pda_)
      && aligned16(work_);
  if (vec) {
    return steps<T, P, true, Method>(pd, offs, nd, pda, offs_a, nda, lo, hi,
                                     lo_a, hi_a, work, partial, sc, st, n,
                                     grid, flag, iters, cap, s);
  }
  return steps<T, P, false, Method>(pd, offs, nd, pda, offs_a, nda, lo, hi,
                                    lo_a, hi_a, work, partial, sc, st, n,
                                    grid, flag, iters, cap, s);
}

}  // namespace bilanczos
}  // namespace
