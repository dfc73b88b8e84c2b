// The restarted Arnoldi process shared by the GMRES and FOM whole-solve
// kernels (gmres_dia.cu, fom_dia.cu) on Hopper (sm_90a), with no
// grid-wide barrier.
//
// What it computes is the Arnoldi half of the TPU kernels
// krylov_tpu/ops/pallas_fused.py:1922 gmres_dia_fused and :4933
// fom_dia_fused: w = A v_k orthogonalised by sequential modified
// Gram-Schmidt against v_0..v_k (pallas_fused.py:1995-2010), the next
// basis vector v_{k+1} = w / ||w||, the pass end (back substitution,
// x += sum_i y_i v_i, restart from the true residual b - A x) and the
// status.  The method's own scalar work (the Givens QR of GMRES, the LU
// of FOM), its back substitution and its status chain are launched
// through the Method type each kernel file defines.
//
// Design.  MGS is sequential: h_i = <v_i, w> must be final before
// w -= h_i v_i.  Without a grid barrier that is one launch per basis
// vector: launch i (1 <= i <= k + 1) first sums, in every block and in
// a fixed order, the block partials of <v_{i-1}, w> that launch i - 1
// left, so that every block holds the same h_{i-1} (block 0 stores it);
// then it applies w -= h_{i-1} v_{i-1} row by row and leaves its own
// partials of <v_i, w> (of <w, w> for i = k + 1).  The partials
// alternate between two rows, so no launch writes what it reads.  An
// iteration is: the stencil launch (w = A v_k, partials of <v_0, w>),
// k + 1 MGS launches, the method's one-block column launch (||w||, the
// factorisation, the residual estimate and the stop flags) and the
// normalise launch (v_{k+1} = w / ||w||).  The stencil reads column k of
// the panel and writes w; nothing writes a vector in the launch that
// reads its neighbours.  The panel's columns need no halo: the stencil
// row masks its reads past either end, as every kernel of the port does.
//
// When a pass ends (stage 1) the pass-end group runs: the back
// substitution (one thread, the TPU loop's order), x += sum_i y_i v_i,
// the restart stencil r = b - A x (it reads x, which no launch of the
// stencil writes), the one-block restart launch (||r||, the status and
// the pass count) and v_0 = r / ||r||.  Without a compressed panel a
// pass ends either at k = mem (a restart) or when the solve stops, so
// while the solve runs k = it mod mem is known to the host: it issues
// exactly k + 1 MGS launches and the pass-end group after the
// iterations with k = mem - 1 and at the end of each chunk (a stop
// inside a chunk blocks every later iteration through the stage flag
// until that group has run).  With a compressed panel (confirm mode) a
// pass may end at any iteration, so every iteration issues mem MGS
// launches, of which those past k + 1 return at once, and its own
// pass-end group.  The scalars live on the device; every launch returns
// at once when the solve has stopped.
//
// Bound on an H100 SXM: memory bandwidth.  An iteration with k must
// read the diagonals once (28 B per row at 7 f32 diagonals) and each of
// v_0..v_k once, and write v_{k+1}: (28 + 4 (k + 2)) B per row in f32.
// This design reads v_i and w and writes w in each MGS launch: 12 B per
// row and launch, so (28 + 12 (k + 1) + 16) B per row per iteration.
#pragma once

#include "common.cuh"

// Internal linkage, as cg_steps.cuh: each kernel file has its own copies.
namespace {
namespace arnoldi {

using namespace ktt;

constexpr int kThreads = 256;
constexpr int kReduceThreads = 1024;

constexpr int RUNNING = 0;
constexpr int SOLVED = 1;
constexpr int ZERO_RESIDUAL = 2;
constexpr int TIRED = 100;

// slots of the scalar arrays; ATOL, RTOL and BTOL are set by the host.
// After the NSC fixed slots come h (mem + 1), c and s (mem each; FOM
// keeps its multipliers l in c), zz (mem + 1), y (mem) and R by rows
// (mem * mem).
enum ScalarSlot {
  ATOL = 0, RTOL, BTOL, EPS_LIM, RNORM, HBIS, BETA_R, PREV_TR, NSC
};
enum IntSlot {
  IT = 0, STATUS, K, GO, STAGE, INCONS, NPASS, ITMAX, FLAGS, KK, SING, NST
};
// why the pass ended (FLAGS), and the stages of a pass end (STAGE)
enum Flag { F_RESID = 1, F_BREAK = 2, F_TIRED = 4 };
enum Stage { S_NONE = 0, S_BACKSUB, S_XACC, S_RESTARTED };
// which launches a column write runs in (ar_scale)
enum Gate { GATE_NONE = 0, GATE_GO, GATE_RESTARTED };

__host__ __device__ inline long long h_at(int) { return NSC; }
__host__ __device__ inline long long c_at(int mem) { return NSC + mem + 1; }
__host__ __device__ inline long long s_at(int mem) {
  return NSC + 2LL * mem + 1;
}
__host__ __device__ inline long long zz_at(int mem) {
  return NSC + 3LL * mem + 1;
}
__host__ __device__ inline long long y_at(int mem) {
  return NSC + 4LL * mem + 2;
}
__host__ __device__ inline long long r_at(int mem) {
  return NSC + 5LL * mem + 2;
}

// x = 0, partials of b'b.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ar_init_dot(const T* __restrict__ b, T* __restrict__ x,
            T* __restrict__ partial, long long n) {
  T s = T(0);
  for (long long i = first_row(); i < n; i += row_stride()) {
    const T bi = b[i];
    x[i] = T(0);
    s += bi * bi;
  }
  store_partial(s, partial);
}

// beta0 = ||b||, eps_lim, zz[0] and the starting status.
template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
ar_init_scalars(const T* __restrict__ partial, int nparts, T* sc, int* st,
                int mem, int itmax) {
  const T bb = sum_partials(partial, nparts);
  if (threadIdx.x != 0) return;
  const T beta0 = sqrt(bb);
  const T eps_lim = sc[ATOL] + sc[RTOL] * beta0;
  sc[EPS_LIM] = eps_lim;
  sc[RNORM] = beta0;
  sc[HBIS] = T(0);
  sc[BETA_R] = beta0;
  sc[PREV_TR] = static_cast<T>(INFINITY);
  sc[zz_at(mem)] = beta0;
  st[IT] = 0;
  st[STATUS] = beta0 == T(0) ? ZERO_RESIDUAL
               : beta0 <= eps_lim ? SOLVED : RUNNING;
  st[K] = 0;
  st[GO] = 0;
  st[STAGE] = S_NONE;
  st[INCONS] = 0;
  st[NPASS] = 1;
  st[ITMAX] = itmax;
  st[FLAGS] = 0;
  st[KK] = 0;
  st[SING] = 0;
}

// Column col of the panel (st[K] where col < 0) = src / sc[slot], in the
// panel's type.  GATE_GO runs it in an iteration that runs, and
// GATE_RESTARTED in one whose pass end restarted.
template <typename T, typename BT>
__global__ void __launch_bounds__(kThreads)
ar_scale(const T* __restrict__ src, BT* __restrict__ V, const T* sc,
         int slot, const int* st, long long n, int col, int gate) {
  if (gate != GATE_NONE && !st[GO]) return;
  if (gate == GATE_RESTARTED && st[STAGE] != S_RESTARTED) return;
  const T d = safe(sc[slot]);
  BT* v = V + static_cast<long long>(col < 0 ? st[K] : col) * n;
  for (long long i = first_row(); i < n; i += row_stride()) {
    v[i] = narrow<BT>(src[i] / d);
  }
}

// The first launch of an iteration: decide whether it runs (GO, read by
// every later launch of the iteration; a pending pass end blocks it),
// then w = A v_k and the partials of <v_0, w>.
template <typename T, typename P, typename BT>
__global__ void __launch_bounds__(kThreads)
ar_stencil(const P* __restrict__ pd, const long long* __restrict__ offsets,
           int nd, const BT* __restrict__ V, T* __restrict__ w,
           T* __restrict__ partial, int* st, long long n, int cap) {
  const int stage = st[STAGE];
  const bool go = st[STATUS] == RUNNING && st[IT] < cap
                  && (stage == S_NONE || stage == S_RESTARTED);
  if (blockIdx.x == 0 && threadIdx.x == 0) st[GO] = go ? 1 : 0;
  if (!go) return;
  const BT* vk = V + static_cast<long long>(st[K]) * n;
  T s = T(0);
  for (long long i = first_row(); i < n; i += row_stride()) {
    const T acc = stencil_row_acc<T>(pd, offsets, nd, vk, i, n);
    w[i] = acc;
    s += widen<T>(V[i]) * acc;
  }
  store_partial(s, partial);
}

// MGS launch i (1 <= i <= k + 1; any later one returns): h_{i-1} from
// the partials of launch i - 1, w -= h_{i-1} v_{i-1}, the partials of
// <v_i, w>, or of <w, w> for i = k + 1.
template <typename T, typename BT>
__global__ void __launch_bounds__(kThreads)
ar_mgs(const BT* __restrict__ V, T* __restrict__ w, T* __restrict__ partial,
       T* sc, const int* st, long long n, int nparts, int i) {
  if (!st[GO]) return;
  const int k = st[K];
  if (i > k + 1) return;
  __shared__ T h_shared;
  const T h = sum_partials(partial + ((i - 1) & 1) * nparts, nparts);
  if (threadIdx.x == 0) {
    h_shared = h;
    if (blockIdx.x == 0) sc[h_at(0) + i - 1] = h;
  }
  __syncthreads();
  const T hi = h_shared;
  const BT* vprev = V + static_cast<long long>(i - 1) * n;
  const bool last = i == k + 1;
  const BT* vi = V + static_cast<long long>(last ? 0 : i) * n;
  T s = T(0);
  for (long long r = first_row(); r < n; r += row_stride()) {
    const T wr = w[r] - hi * widen<T>(vprev[r]);
    w[r] = wr;
    s += (last ? wr : widen<T>(vi[r])) * wr;
  }
  store_partial(s, partial + (i & 1) * nparts);
}

// The end of a method's column launch (thread 0): the iteration count,
// ||r_k||, the stop flags, and stage 1 when the pass ends
// (pallas_fused.py:2037-2046).
template <typename T>
__device__ void end_column(T* sc, int* st, int k, T hbis, T rnorm, int mem) {
  const int it = st[IT] + 1;
  const int kk = k + 1;
  const bool resid = rnorm <= sc[EPS_LIM] || (rnorm + T(1)) <= T(1);
  const bool brk = hbis <= sc[BTOL];
  const bool tired = it >= st[ITMAX];
  const bool inner_done = resid || brk || tired || kk >= mem;
  st[IT] = it;
  st[K] = kk;
  sc[RNORM] = rnorm;
  sc[HBIS] = hbis;
  st[STAGE] = inner_done ? S_BACKSUB : S_NONE;
  if (inner_done) {
    st[KK] = kk;
    st[FLAGS] = (resid ? F_RESID : 0) | (brk ? F_BREAK : 0)
                | (tired ? F_TIRED : 0);
  }
}

// The pass end: x += sum_{i < kk} y_i v_i, one term after another
// (pallas_fused.py:2073-2077).
template <typename T, typename BT>
__global__ void __launch_bounds__(kThreads)
ar_xacc(const BT* __restrict__ V, T* __restrict__ x, const T* sc,
        const int* st, long long n, int mem) {
  if (st[STAGE] != S_XACC) return;
  const int kk = st[KK];
  const T* y = sc + y_at(mem);
  for (long long r = first_row(); r < n; r += row_stride()) {
    T xr = x[r];
    for (int i = 0; i < kk; ++i) {
      xr = xr + y[i] * widen<T>(V[static_cast<long long>(i) * n + r]);
    }
    x[r] = xr;
  }
}

// The pass end: w = b - A x and the partials of <w, w>, where the pass
// restarts (confirm mode: always, to check the stop on the true
// residual).
template <typename T, typename P>
__global__ void __launch_bounds__(kThreads)
ar_restart_stencil(const P* __restrict__ pd,
                   const long long* __restrict__ offsets, int nd,
                   const T* __restrict__ b, const T* __restrict__ x,
                   T* __restrict__ w, T* __restrict__ partial, const int* st,
                   long long n, int confirm) {
  if (st[STAGE] != S_XACC) return;
  if (!confirm && (st[FLAGS] & (F_RESID | F_BREAK | F_TIRED))) return;
  T s = T(0);
  for (long long i = first_row(); i < n; i += row_stride()) {
    const T ri = b[i] - stencil_row<T>(pd, offsets, nd, x, i, n);
    w[i] = ri;
    s += ri * ri;
  }
  store_partial(s, partial);
}

// What a method supplies: its one-block launches.
//   Method::column<T>(partial, grid, sc, st, mem, stream)
//   Method::backsub<T>(sc, st, mem, stream)
//   Method::restart<T>(partial, grid, sc, st, mem, confirm, stream)

template <typename T, typename P, typename BT, typename Method>
void pass_end(const P* pd, const long long* offsets, int nd, const T* b,
              T* w, BT* V, T* x, T* partial, T* sc, int* st, long long n,
              int grid, int mem, int confirm, cudaStream_t s) {
  Method::template backsub<T>(sc, st, mem, s);
  ar_xacc<T, BT><<<grid, kThreads, 0, s>>>(V, x, sc, st, n, mem);
  ar_restart_stencil<T, P><<<grid, kThreads, 0, s>>>(
      pd, offsets, nd, b, x, w, partial, st, n, confirm);
  Method::template restart<T>(partial, grid, sc, st, mem, confirm, s);
  ar_scale<T, BT><<<grid, kThreads, 0, s>>>(w, V, sc, BETA_R, st, n, 0,
                                            GATE_RESTARTED);
}

template <typename T, typename BT>
int init(const void* b_, void* V_, void* x_, void* partial_, void* sc_,
         void* st_, long long n, int grid, int mem, int itmax,
         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* b = static_cast<const T*>(b_);
  T* partial = static_cast<T*>(partial_);
  T* sc = static_cast<T*>(sc_);
  int* st = static_cast<int*>(st_);
  ar_init_dot<T><<<grid, kThreads, 0, s>>>(b, static_cast<T*>(x_), partial,
                                           n);
  ar_init_scalars<T><<<1, kReduceThreads, 0, s>>>(partial, grid, sc, st,
                                                  mem, itmax);
  ar_scale<T, BT><<<grid, kThreads, 0, s>>>(b, static_cast<BT*>(V_), sc,
                                            BETA_R, st, n, 0, GATE_NONE);
  return static_cast<int>(cudaGetLastError());
}

// ``iters`` iterations with the iteration cap ``cap``: the solve's own
// iteration count is cap - iters at the first of them while it runs.
template <typename T, typename P, typename BT, typename Method>
int iterate(const void* pd_, const void* offsets_, int nd, const void* b_,
            void* w_, void* V_, void* x_, void* partial_, void* sc_,
            void* st_, long long n, int grid, int mem, int confirm,
            int iters, int cap, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const P* pd = static_cast<const P*>(pd_);
  const long long* offs = static_cast<const long long*>(offsets_);
  const T* b = static_cast<const T*>(b_);
  T* w = static_cast<T*>(w_);
  BT* V = static_cast<BT*>(V_);
  T* x = static_cast<T*>(x_);
  T* partial = static_cast<T*>(partial_);
  T* sc = static_cast<T*>(sc_);
  int* st = static_cast<int*>(st_);
  const int start = cap - iters;
  bool ended = false;
  for (int j = 0; j < iters; ++j) {
    const int k = (start + j) % mem;
    ar_stencil<T, P, BT><<<grid, kThreads, 0, s>>>(pd, offs, nd, V, w,
                                                   partial, st, n, cap);
    const int nmgs = confirm ? mem : k + 1;
    for (int i = 1; i <= nmgs; ++i) {
      ar_mgs<T, BT><<<grid, kThreads, 0, s>>>(V, w, partial, sc, st, n, grid,
                                              i);
    }
    Method::template column<T>(partial, grid, sc, st, mem, s);
    ar_scale<T, BT><<<grid, kThreads, 0, s>>>(w, V, sc, HBIS, st, n, -1,
                                              GATE_GO);
    ended = confirm || k == mem - 1;
    if (ended) {
      pass_end<T, P, BT, Method>(pd, offs, nd, b, w, V, x, partial, sc, st,
                                 n, grid, mem, confirm, s);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (!ended) {
    pass_end<T, P, BT, Method>(pd, offs, nd, b, w, V, x, partial, sc, st, n,
                               grid, mem, confirm, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace arnoldi
}  // namespace
