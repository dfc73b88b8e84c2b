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
// (it + 2) mod 3, and q, which stands for v_{k+1}, in (it + 1) mod 3.
// The stencils read the neighbours of v_k and u_k only, and no launch
// writes a buffer whose neighbours it reads.
//
// QMR and BiLQR (the fused design).  An iteration is three launches:
//   1. fused_stencil (grid)  GO; q = A v_k - gamma v_{k-1} and
//                            p = A^H u_k - beta u_{k-1} on the two sets
//                            of aligned diagonals, written once, with
//                            v_k, u_k, v_{k-1} and u_{k-1} divided as they
//                            are read; partials of <u_k, q> (and, for
//                            BiLQR's dual residual, of <u_k, u_k>)
//   2. the method's fused launch (grid): alpha = the sum of those
//                            partials in every block (a fixed order, so
//                            every block holds the same value, AlphaRows);
//                            q -= alpha v_k and p -= alpha u_k written
//                            once; partials of <p, q>, <v_k, q>, ||q||^2
//                            and ||v_k||^2; the method's vector updates
//                            in the same pass over the rows
//   3. the method's scalar launch (1 block): <p, q>, beta_{k+1},
//                            gamma_{k+1} (commit_lanczos) and the
//                            method's chains, in one thread
// No launch normalises q and p: they stay in their buffers as the fused
// launch leaves them, and every reader forms v_{k+1}[i] = q[i] / d with
// d = safe(beta_{k+1}) (u: safe(gamma_{k+1})), the very division the
// TPU kernel and the plain version make, so the values read are bitwise
// those a pass of its own would have stored: the next stencil (each
// neighbour as it is loaded), the alpha update and the methods' row
// updates.  Each buffer's divisor is a scalar slot (DV0 + buffer, DU0 +
// buffer); v_1 and u_1 are stored normalised, with divisor 1.  Where
// <p, q> = 0 the scalar launch gives buffer it + 1 the divisors of
// buffer it and sets COPY; the next stencil then reads v_k and u_k from
// buffer it (its v_{k-1} and u_{k-1}, the same vectors) and copies them,
// as stored, into their own buffers for the later launches.
//
// The stencil is dia_spmv.cu's design (common.cuh dia_rows): a thread
// owns R = 16 / sizeof(pd element) consecutive rows, pd read 16 bytes at
// a time and x where i + k_d is a multiple of R, the offsets in shared
// memory, an interior [lo, hi) for each of A and A^H, computed on the
// host once per solve, with no bounds branch, masked rows outside it, a
// scalar path where n is no multiple of R or a buffer is not 16-byte
// aligned.  Each row sums its diagonals in order, as stencil_row, so q
// and p are bitwise those of BiLQ's stencil for the same v_k and u_k.  A
// block walks bl_stencil's rows, 256-row chunks a grid stride apart, R
// chunks at a time, and hands u_k and q through shared memory to the
// thread that bl_stencil gives each row, which adds it to its dots in
// bl_stencil's order.  Sum order of the dots: every dot in BiLQ's launches' order -- alpha
// and <u_k, u_k> per thread over its rows, then the block tree, then the
// per-block partials in a kThreads block's strides (alpha in every block
// of the fused launch, as bl_alpha; <p, q> in the scalar launch, as
// bi_next_scalars); <u_k, u_k> in the scalar launch's strides -- so the
// iterates are bit for bit those of the four-launch design.  Every dot
// is summed in T, as the TPU kernel sums them, but ||q||^2, summed in
// double (Dot).  BiLQR's <v_k, v_{k+1}> and ||v_{k+1}||^2 are
// <v_k, q> / beta_{k+1} and ||q||^2 / beta_{k+1}^2 (||v_k||^2 for both
// where <p, q> = 0), QMR's ||v_{k+1}||^2 likewise: a division after the
// sum in place of one per row, so their last bits, and with them the
// residual estimates (and a stop that they decide), may differ from
// BiLQ's launches'.
//
// BiLQ (launches bl_stencil, bl_alpha, bi_next_scalars and bi_next_row,
// four per iteration, q and p normalised in the method launch) keeps the
// earlier design; those launches leave this header with BiLQ's own
// redesign onto the fused launches.
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
// BiLQ's launches: PVV <v_k, v_{k+1}>, PNN ||v_{k+1}||^2; the fused
// launches: PVV <v_k, q>, PNN ||q||^2, PKK ||v_k||^2
enum Part { PUQ = 0, PUU, PPQ, PVV, PNN, PKK, NPART };
// The fused design's slots, which QMR's and BiLQR's enums continue: the
// divisors of the three v and the three u buffers, and the copy flag.
enum FusedSlot { DV0 = GAMMA1 + 1, DU0 = DV0 + 3, NFUSED_SLOTS = DU0 + 3 };
enum FusedInt { COPY = GO + 1, NFUSED_INTS };

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

// Init: the partials of b'b (row PUQ), c'c (row PUU) and c'b (row PPQ),
// stored as D (T for BiLQ, Dot for the fused design).
template <typename T, typename D = T>
__global__ void __launch_bounds__(kThreads)
bl_init_dots(const T* __restrict__ b, const T* __restrict__ c,
             D* __restrict__ partial, long long n) {
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

// BiLQ's launches, the earlier design: bl_stencil, bl_alpha, then
// bq_next with bi_next_scalars and bi_next_row, and iterate.  They leave
// this header with BiLQ's own redesign onto the fused launches below.
//
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

// The init and BiLQ's per-iteration launch sequence; a method supplies
//   Method::init_scalars<T>(partial, grid, sc, st, stream), partial of
//   type D* (T* for BiLQ, Dot* for QMR and BiLQR)
//   Method::next<T>(work, partial, sc, st, n, grid, flag, stream)
//   Method::scalars<T>(partial, grid, sc, st, flag, stream)
// the number of its own work rows (Method::kRows), and whether the
// stencil launch takes the partials of <u_k, u_k> (Method::kWithUU).
template <typename T, typename Method, typename D = T>
int init(const void* b_, const void* c_, void* work_, void* partial_,
         void* sc_, void* st_, long long n, int grid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* b = static_cast<const T*>(b_);
  const T* c = static_cast<const T*>(c_);
  D* partial = static_cast<D*>(partial_);
  T* sc = static_cast<T*>(sc_);
  bl_init_dots<T, D><<<grid, kThreads, 0, s>>>(b, c, partial, n);
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

// ---------------------------------------------------------------------
// The fused design of QMR and BiLQR
// ---------------------------------------------------------------------

// The fused design's partial array is of doubles.  Every row but PNN
// (alpha, <u_k, u_k>, <p, q>, <v_k, q>, ||v_k||^2) holds sums taken in T,
// as BiLQ's launches and the TPU kernel take their dots, converted
// exactly; ||q||^2 (PNN) is summed in double, per thread, per block and
// across blocks, and rounded to T once where it is read: q is kept as it
// is, about beta_{k+1} times v_{k+1}, so in f32 ||q||^2 can leave the
// range of the type where ||v_{k+1}||^2 does not (it did in an f32 BiLQR
// run at 16^3, whose estimate then went NaN).
using Dot = double;

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

// The starting divisors (v_1, u_1 stored normalised, v_0 = u_0 = 0) and
// no copy; a method's init_scalars calls it.
template <typename T>
__device__ __forceinline__ void fused_init_state(T* sc, int* st) {
  for (int j = DV0; j < NFUSED_SLOTS; ++j) sc[j] = T(1);
  st[COPY] = 0;
}

// The end of a fused scalar launch, in its one thread: beta_{k+1} and
// gamma_{k+1} become beta and gamma, and buffer it + 1 (q and p) gets its
// divisors, or, where <p, q> = 0, those of buffer it with COPY set, so
// that the next stencil copies v_k and u_k into it.
template <typename T>
__device__ __forceinline__ void commit_lanczos(T* sc, int* st, int it0,
                                               T phq, T beta1, T gamma1) {
  const bool nz = phq != T(0);
  sc[BETA] = beta1;
  sc[GAMMA] = gamma1;
  sc[DV0 + next(it0)] = nz ? safe(beta1) : sc[DV0 + cur(it0)];
  sc[DU0 + next(it0)] = nz ? safe(gamma1) : sc[DU0 + cur(it0)];
  st[COPY] = nz ? 0 : 1;
}

// Rows i0 .. i0 + R - 1 of a work row, 16 bytes at a time with VEC (then
// n is a multiple of R), else element by element, 0 past n.
template <bool VEC, typename T, int R>
__device__ __forceinline__ void load_rows(const T* p, long long left,
                                          T (&v)[R]) {
  if (VEC) {
    ld_vec(p, v);
  } else {
#pragma unroll
    for (int r = 0; r < R; ++r) v[r] = r < left ? ld_ro(p + r) : T(0);
  }
}

template <bool VEC, typename T, int R>
__device__ __forceinline__ void store_rows(T* p, long long left,
                                           const T (&v)[R]) {
  if (VEC) {
    st_vec(p, v);
  } else {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r < left) p[r] = v[r];
    }
  }
}

// 1. Decide whether this iteration runs (GO, read by every later launch
// of the iteration), then q and p, each written once, and the partials
// of <u_k, q> (and of <u_k, u_k> with with_uu).  A block walks its rows
// as bl_stencil's block does, 256-row chunks a grid stride apart, R
// chunks at a time: thread t takes R consecutive rows of chunk
// t / (256 / R) on the wide rows, and then, through shared memory, sums
// row t of each chunk in turn, as bl_stencil's thread t does, so the
// dots keep BiLQ's order.  With VEC, pd, pda and the work rows are
// 16-byte aligned and n is a multiple of R.
template <typename T, typename P, bool VEC>
__global__ void __launch_bounds__(kThreads)
fused_stencil(const P* __restrict__ pd,
              const long long* __restrict__ offsets, int nd,
              const P* __restrict__ pda,
              const long long* __restrict__ offsets_a, int nda,
              long long lo, long long hi, long long lo_a, long long hi_a,
              T* __restrict__ work, Dot* __restrict__ partial, const T* sc,
              int* st, long long n, int cap, int with_uu) {
  constexpr int R = rows_per_thread<P>();
  constexpr int kLanes = kThreads / R;      // threads on one 256-row chunk
  const int it0 = st[IT];
  const bool go = st[STATUS] == RUNNING && it0 < cap;
  if (blockIdx.x == 0 && threadIdx.x == 0) st[GO] = go ? 1 : 0;
  if (!go) return;
  __shared__ long long offs[kDiaTile];
  __shared__ long long offs_a[kDiaTile];
  __shared__ T su[R][kThreads];
  __shared__ T sq[R][kThreads];
  if (nd <= kDiaTile) stage_offsets(offs, offsets, nd);
  if (nda <= kDiaTile) stage_offsets(offs_a, offsets_a, nda);
  __syncthreads();
  // v_k and u_k in their own buffers, or, after <p, q> = 0, in those of
  // v_{k-1} and u_{k-1}, which hold the same vectors
  const int src = st[COPY] ? prev(it0) : cur(it0);
  const T* vk = row(work, V0 + src, n);
  const T* uk = row(work, U0 + src, n);
  const T* vkm1 = row(work, V0 + prev(it0), n);
  const T* ukm1 = row(work, U0 + prev(it0), n);
  T* q = row(work, V0 + next(it0), n);
  T* p = row(work, U0 + next(it0), n);
  const DividedBy<T> fv(sc[DV0 + src]);
  const DividedBy<T> fu(sc[DU0 + src]);
  const DividedBy<T> fvm(sc[DV0 + prev(it0)]);
  const DividedBy<T> fum(sc[DU0 + prev(it0)]);
  const T gamma = sc[GAMMA];
  const T beta = sc[BETA];
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const int c = threadIdx.x / kLanes;
  const int o = (threadIdx.x % kLanes) * R;
  T suq = T(0);
  T suu = T(0);
  for (long long base = static_cast<long long>(blockIdx.x) * kThreads;
       base < n; base += R * stride) {
    const long long i0 = base + c * stride + o;
    T aq[R];
    T ap[R];
    T uc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) aq[r] = ap[r] = uc[r] = T(0);
    dia_rows<R, VEC>(pd, offsets, nd, offs, vk, i0, n, lo, hi, VEC, fv, aq);
    dia_rows<R, VEC>(pda, offsets_a, nda, offs_a, uk, i0, n, lo_a, hi_a, VEC,
                     fu, ap);
    if (i0 < n) {
      const long long left = n - i0;
      T vm[R];
      T um[R];
      load_rows<VEC>(vkm1 + i0, left, vm);
      load_rows<VEC>(ukm1 + i0, left, um);
      load_rows<VEC>(uk + i0, left, uc);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        // q = A v_k - gamma v_{k-1} as one fused multiply-add, as BiLQ's
        // stencil rounds it
        aq[r] = fused_madd(-gamma, fvm(vm[r]), aq[r]);
        ap[r] = fused_madd(-beta, fum(um[r]), ap[r]);
        uc[r] = fu(uc[r]);
      }
      store_rows<VEC>(q + i0, left, aq);
      store_rows<VEC>(p + i0, left, ap);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      su[c][o + r] = uc[r];
      sq[c][o + r] = aq[r];
    }
    __syncthreads();
    for (int k = 0; k < R; ++k) {
      if (base + k * stride + threadIdx.x < n) {
        const T u = su[k][threadIdx.x];
        suq = fused_madd(u, sq[k][threadIdx.x], suq);
        suu = fused_madd(u, u, suu);
      }
    }
    __syncthreads();
  }
  const int nparts = gridDim.x;
  if (with_uu) {
    store_partials(suq, partial + PUQ * nparts, suu, partial + PUU * nparts);
  } else {
    store_partial(suq, partial + PUQ * nparts);
  }
  if (src != cur(it0)) {
    T* vc = row(work, V0 + cur(it0), n);
    T* ucur = row(work, U0 + cur(it0), n);
    for (long long i = first_row(); i < n; i += row_stride()) {
      vc[i] = vk[i];
      ucur[i] = uk[i];
    }
  }
}

// 2. The head and the Lanczos rows of a method's fused launch: alpha =
// <u_k, q> summed in every block (block 0 stores it), then, row by row,
// q -= alpha v_k and p -= alpha u_k, written once, with v_k and u_k
// formed from their buffers as they are read; t gathers the row's terms
// of <p, q>, <v_k, q> and ||v_k||^2 (in T) and qq that of ||q||^2 (in
// Dot).
template <typename T>
struct AlphaRows {
  const T* vk;
  const T* uk;
  T* q;
  T* p;
  DividedBy<T> fv, fu;
  T alpha;

  __device__ __forceinline__ AlphaRows(T* work, const Dot* partial, T* sc,
                                       int it0, long long n)
      : fv(sc[DV0 + cur(it0)]), fu(sc[DU0 + cur(it0)]) {
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
    const T vi = fv(a.v);
    const T ui = fu(a.u);
    const T qi = a.q - alpha * vi;
    const T pi = a.p - alpha * ui;
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
  T uu, phq, vq, vv;
  Dot qq;
};

template <typename T>
__device__ __forceinline__ LanczosSums<T> lanczos_sums(const Dot* partial,
                                                       int nparts) {
  // each row in sum_partials' order, four rows in one block tree; <p, q>
  // in the strides of a kThreads block, as BiLQ's launches sum it in
  // every block of a grid launch (the block tree's further threads add
  // zeros)
  T v[4] = {T(0), T(0), T(0), T(0)};
  Dot qq = Dot(0);
  for (int i = threadIdx.x; i < nparts; i += blockDim.x) {
    v[0] += static_cast<T>(partial[PUU * nparts + i]);
    v[2] += static_cast<T>(partial[PVV * nparts + i]);
    v[3] += static_cast<T>(partial[PKK * nparts + i]);
    qq += partial[PNN * nparts + i];
  }
  if (threadIdx.x < kThreads) {
    for (int i = threadIdx.x; i < nparts; i += kThreads) {
      v[1] += static_cast<T>(partial[PPQ * nparts + i]);
    }
  }
  __shared__ T t[4];
  block_sums<T, 4>(v, t, 0);
  LanczosSums<T> r;
  r.qq = block_sum(qq);
  r.uu = t[0];
  r.phq = t[1];
  r.vq = t[2];
  r.vv = t[3];
  return r;
}

// The per-iteration launch sequence of the fused design; a method
// supplies (partial of type Dot*)
//   Method::init_scalars<T>(partial, grid, sc, st, stream)
//   Method::fused<T>(work, partial, sc, st, n, grid, stream)
//   Method::scalars<T>(partial, grid, sc, st, flag, stream)
// and kRows and kWithUU as for init.
template <typename T, typename P, bool VEC, typename Method>
int fused_steps(const P* pd, const long long* offs, int nd, const P* pda,
                const long long* offs_a, int nda, long long lo, long long hi,
                long long lo_a, long long hi_a, T* work, Dot* partial,
                T* sc, int* st, long long n, int grid, int flag, int iters,
                int cap, cudaStream_t s) {
  for (int j = 0; j < iters; ++j) {
    fused_stencil<T, P, VEC><<<grid, kThreads, 0, s>>>(
        pd, offs, nd, pda, offs_a, nda, lo, hi, lo_a, hi_a, work, partial,
        sc, st, n, cap, Method::kWithUU);
    Method::template fused<T>(work, partial, sc, st, n, grid, s);
    Method::template scalars<T>(partial, grid, sc, st, flag, s);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

// iters iterations of the fused design; [lo, hi) and [lo_a, hi_a) are
// the interiors of A's and A^H's offsets (ops/cuda_dia.py _interior).
template <typename T, typename P, typename Method>
int iterate_fused(const void* pd_, const void* offsets_, int nd,
                  const void* pda_, const void* offsets_a_, int nda,
                  long long lo, long long hi, long long lo_a, long long hi_a,
                  void* work_, void* partial_, void* sc_, void* st_,
                  long long n, int grid, int flag, int iters, int cap,
                  void* stream) {
  constexpr int R = rows_per_thread<P>();
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
    return fused_steps<T, P, true, Method>(pd, offs, nd, pda, offs_a, nda,
                                           lo, hi, lo_a, hi_a, work, partial,
                                           sc, st, n, grid, flag, iters, cap,
                                           s);
  }
  return fused_steps<T, P, false, Method>(pd, offs, nd, pda, offs_a, nda, lo,
                                          hi, lo_a, hi_a, work, partial, sc,
                                          st, n, grid, flag, iters, cap, s);
}

}  // namespace bilanczos
}  // namespace
