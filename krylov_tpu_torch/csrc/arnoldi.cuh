// The restarted Arnoldi process shared by the GMRES and FOM whole-solve
// kernels (gmres_dia.cu, fom_dia.cu) on Hopper (sm_90a), with no
// grid-wide barrier.
//
// What it computes is the Arnoldi half of the TPU kernels
// krylov_tpu/ops/pallas_fused.py:1922 gmres_dia_fused and :4933
// fom_dia_fused: w = A v_k orthogonalised against v_0..v_k by modified
// Gram-Schmidt (pallas_fused.py:1995-2010), the next basis vector
// v_{k+1} = w / ||w||, the pass end (back substitution, x += sum_i y_i
// v_i, restart from the true residual b - A x) and the status.  The
// method's own scalar work (the Givens QR of GMRES, the LU of FOM), its
// back substitution and its status chain are launched through the
// Method type each kernel file defines.
//
// MGS's coefficients from one dot pass.  Sequential MGS takes
// h_i = <v_i, w^(i)> with w^(i) = w - sum_{j<i} h_j v_j, so for any
// vectors v_j (normalised or not, a bf16 or f16 panel widened to T too)
//   h_i = <v_i, w> - sum_{j<i} <v_i, v_j> h_j,   w' = w - sum_{j<=k} h_j v_j
// exactly: the inverse compact-WY form of MGS (Swirydowicz, Langou,
// Ananthan, Yang and Thomas, "Low synchronization Gram-Schmidt and
// generalized minimal residual algorithms", Numer. Linear Algebra Appl.,
// 2021), which keeps MGS's loss of orthogonality, O(eps kappa).  Without
// the Gram term it would be classical Gram-Schmidt, another algorithm.
// The Gram row <v_k, v_j>, j < k, is new at iteration k; the rows of
// earlier iterations of the pass are kept in a scratch array.
//
// An iteration is five launches, whatever k and the panel type:
//   1. ar_stencil (grid)     GO; w = A v_k on common.cuh's wide rows
//                            (dia_rows: R = 16 / sizeof(pd element) rows
//                            a thread, 16-byte loads where aligned, the
//                            offsets in shared memory, a branch-free
//                            interior [lo, hi)), w written once and kept
//                            in registers for the block partials of
//                            c_j = <v_j, w> (j <= k) and of the Gram row
//                            g_j = <v_k, v_j> (j < k): v_k is the
//                            stencil's own centre, so each v_j is read
//                            once for both dots.  A group of basis
//                            vectors' sums in registers at a time (in
//                            f32, 8 where k < 32, else 20; with a
//                            compressed panel, whose k the host does not
//                            know, by the memory); past a group the
//                            block walks its rows again for the next,
//                            reading w and v_k again, so any memory has
//                            a kernel.  Every load of a group outside a
//                            branch, so all are in flight at once.  As
//                            many blocks as the card holds at once; one
//                            partial a block and dot, each in the
//                            block's fixed tree
//   2. ar_coef    (1 block)  each dot's partials summed by one warp in a
//                            fixed order, the Gram row k stored, then
//                            h_i = c_i - sum_{j<i} G[i][j] h_j in blocks
//                            of 32 rows: the terms of the earlier blocks
//                            by one warp a row, then the block's unit
//                            triangle by one warp, lane i taking h_m from
//                            lane m in order m = 0, 1, ...; h_0..h_k go
//                            where the column launch reads them (h_at),
//                            through shared memory up to kSmemMax
//   3. ar_update  (grid)     w -= h_j v_j for j = 0..k in that order, row
//                            by row (MGS's order in each row), h in
//                            shared memory kChunk at a time, and the
//                            partials of <w, w>
//   4. the method's column launch (1 block): ||w||, the factorisation,
//                            the residual estimate and the stop flags
//   5. ar_normalise (grid)   v_{k+1} = w / ||w|| in the panel's type
// The stencil reads the neighbours of v_k, the panel's column k, and
// writes w; nothing writes a vector in the launch that reads its
// neighbours.  The panel's columns need no halo: the stencil rows mask
// their reads past either end, as every kernel of the port does.  The
// sums are in the same order on every run: no atomics, no barrier across
// blocks.
//
// When a pass ends (stage 1) the pass-end group runs: the back
// substitution (one thread, the TPU loop's order), x += sum_i y_i v_i,
// the restart stencil r = b - A x (it reads x, which no launch of the
// stencil writes), the one-block restart launch (||r||, the status and
// the pass count) and v_0 = r / ||r||.  Without a compressed panel a
// pass ends either at k = mem (a restart) or when the solve stops, so
// while the solve runs k = it mod mem is known to the host: it issues the
// pass-end group after the iterations with k = mem - 1 and at the end of
// each chunk (a stop inside a chunk blocks every later iteration through
// the stage flag until that group has run).  With a compressed panel
// (confirm mode) a pass may end at any iteration, so every iteration
// issues its own pass-end group, which returns at once unless the pass
// ended.  The scalars live on the device; every launch returns at once
// when the solve has stopped.
//
// Bound on an H100 SXM: memory bandwidth.  An iteration with k must read
// the diagonals once (28 B per row at 7 f32 diagonals) and each of
// v_0..v_k once, and write v_{k+1}: (28 + 4 (k + 2)) B per row in f32.
// This design moves (28 + 4 (k + 1) + 4) B per row in the stencil
// (diagonals, v_0..v_k, w), (4 (k + 1) + 8) in the update (v_0..v_k, w
// read and written) and 8 in the normalise: (48 + 8 (k + 1)) B per row.
// Reading v_0..v_k twice, once for the dots and once for the update, is
// the price of having no grid barrier.
#pragma once

#include <type_traits>

#include "common.cuh"

// Internal linkage, as cg_steps.cuh: each kernel file has its own copies.
namespace {
namespace arnoldi {

using namespace ktt;

constexpr int kThreads = 256;
constexpr int kReduceThreads = 1024;
// the h_j ar_update holds in shared memory at a time
constexpr int kChunk = 512;
// the dynamic shared memory ar_coef takes at most for h, well inside the
// 48 KB a launch may take without an opt-in; past it h is built in place
// in the scalar array
constexpr size_t kSmemMax = 32 * 1024;

// The two shapes of ar_stencil: the basis vectors whose two dots it sums
// in registers at a time (a group), and the blocks per SM its registers
// must leave room for.  Small groups at four blocks an SM serve an
// iteration with k < kSmallK, large groups at the registers' own
// occupancy the others: timed alone at 128^3 f32 the small shape was
// the faster stencil up to memory 64, the large one at memory 512, and
// the choice by k came within 1% of the faster at every memory (PERF.md
// section 6).
template <typename T>
struct Small {
  static constexpr int kGroup = sizeof(T) == 4 ? 8 : 4;
  static constexpr int kMinBlocks = 4;
};
template <typename T>
struct Large {
  static constexpr int kGroup = sizeof(T) == 4 ? 20 : 12;
  static constexpr int kMinBlocks = 1;
};
// k below which an iteration takes the small shape
constexpr int kSmallK = 32;

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
// whether a column write runs always or only in an iteration whose pass
// end restarted (ar_scale)
enum Gate { GATE_NONE = 0, GATE_RESTARTED };

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

// The scratch array: rows of `grid` block partials, those of c_j in rows
// 0 .. mem - 1 (the init and restart dots use row 0), of the Gram row
// g_j in rows mem .. 2 mem - 1 and of <w, w> in row 2 mem; then the Gram
// rows G[i][j] = <v_i, v_j>, j < i, at gram() + i mem + j.
struct Layout {
  long long mem, grid;
  __host__ __device__ long long g_row() const { return mem * grid; }
  __host__ __device__ long long ww_row() const { return 2 * mem * grid; }
  __host__ __device__ long long gram() const { return ww_row() + grid; }
  __host__ __device__ long long size() const { return gram() + mem * mem; }
};

// Rows p[0 .. R - 1] of a panel column, widened to T.
template <bool VEC, typename T, typename BT, int R>
__device__ __forceinline__ void load_panel(const BT* p, long long left,
                                           T (&v)[R]) {
  if (VEC) {
    BT raw[R];
    ld_vec(p, raw);
#pragma unroll
    for (int r = 0; r < R; ++r) v[r] = widen<T>(raw[r]);
  } else {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      v[r] = r < left ? widen<T>(ld_ro(p + r)) : T(0);
    }
  }
}

// Rows p[0 .. R - 1] as load_rows reads them, but through the ordinary
// data path: for w, which a launch reads again after writing it.
template <bool VEC, typename T, int R>
__device__ __forceinline__ void load_rw(const T* p, long long left,
                                        T (&v)[R]) {
  if (VEC) {
    constexpr int W = static_cast<int>(R * sizeof(T) / 16);
    uint4 words[W];
#pragma unroll
    for (int q = 0; q < W; ++q) words[q] = reinterpret_cast<const uint4*>(p)[q];
    memcpy(&v[0], &words[0], sizeof(words));
  } else {
#pragma unroll
    for (int r = 0; r < R; ++r) v[r] = r < left ? p[r] : T(0);
  }
}

// Sum over a warp in a fixed tree; valid in lane 0.
template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
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

// Column col of the panel = src / sc[slot], in the panel's type (the
// init's and a restart's v_0).  GATE_RESTARTED runs it in an iteration
// whose pass end restarted.
template <typename T, typename BT>
__global__ void __launch_bounds__(kThreads)
ar_scale(const T* __restrict__ src, BT* __restrict__ V, const T* sc,
         int slot, const int* st, long long n, int col, int gate) {
  if (gate == GATE_RESTARTED && (!st[GO] || st[STAGE] != S_RESTARTED)) {
    return;
  }
  const T d = safe(sc[slot]);
  BT* v = V + static_cast<long long>(col) * n;
  for (long long i = first_row(); i < n; i += row_stride()) {
    v[i] = narrow<BT>(src[i] / d);
  }
}

// 1. Decide whether this iteration runs (GO, read by every later launch
// of the iteration; a pending pass end blocks it), then w = A v_k and
// the partials of c_j = <v_j, w> (j <= k) and g_j = <v_k, v_j> (j < k):
// block b's partial of c_j at partial[j grid + b], of g_j at
// partial[g_row() + j grid + b], where grid is the scratch array's row
// length (the launch may have fewer blocks).  Rows past n count as zeros.
template <typename T, typename P, typename BT, bool VEC, int KR, int MINB>
__global__ void __launch_bounds__(kThreads, MINB)
ar_stencil(const P* __restrict__ pd, const long long* __restrict__ offsets,
           int nd, long long lo, long long hi, const BT* __restrict__ V,
           T* __restrict__ w, T* __restrict__ partial, int* st, long long n,
           int mem, int grid, int cap) {
  constexpr int R = rows_per_thread<P>();
  const int stage = st[STAGE];
  const bool go = st[STATUS] == RUNNING && st[IT] < cap
                  && (stage == S_NONE || stage == S_RESTARTED);
  if (blockIdx.x == 0 && threadIdx.x == 0) st[GO] = go ? 1 : 0;
  if (!go) return;
  __shared__ long long offs[kDiaTile];
  if (nd <= kDiaTile) stage_offsets(offs, offsets, nd);
  __syncthreads();
  const int k = st[K];
  const Layout L{mem, grid};
  const BT* vk = V + static_cast<long long>(k) * n;
  for (int c0 = 0; c0 <= k; c0 += KR) {
    // the basis vectors of this group, c0 .. c0 + count - 1
    const int count = min(KR, k + 1 - c0);
    T cs[KR], gs[KR];
#pragma unroll
    for (int j = 0; j < KR; ++j) {
      cs[j] = T(0);
      gs[j] = T(0);
    }
    // every thread of the block takes the same number of steps: the
    // stencil rows may stage offsets between barriers
    for (long long i0 = first_rows<R>(); i0 - threadIdx.x * R < n;
         i0 += rows_stride<R>()) {
      const long long left = n - i0;
      T wv[R];
      if (c0 == 0) {
#pragma unroll
        for (int r = 0; r < R; ++r) wv[r] = T(0);
        dia_rows<R, VEC>(pd, offsets, nd, offs, vk, i0, n, lo, hi, VEC, wv);
        if (left > 0) store_rows<VEC>(w + i0, left, wv);
      } else if (left > 0) {
        load_rw<VEC>(w + i0, left, wv);
      }
      if (left > 0) {
        T kv[R];
        load_panel<VEC>(vk + i0, left, kv);
        // no branch around a load, so that the group's loads are all in
        // flight at once: past the group's last basis vector the sums
        // take v_k again (a cache hit), and block_sums drops them
#pragma unroll
        for (int jj = 0; jj < KR; ++jj) {
          const int j = c0 + min(jj, count - 1);
          T vv[R];
          load_panel<VEC>(V + static_cast<long long>(j) * n + i0, left, vv);
#pragma unroll
          for (int r = 0; r < R; ++r) {
            cs[jj] += vv[r] * wv[r];
            gs[jj] += vv[r] * kv[r];
          }
        }
      }
    }
    block_sums<T, KR>(cs, partial + static_cast<long long>(c0) * grid, grid,
                      count);
    block_sums<T, KR>(gs, partial + L.g_row() + static_cast<long long>(c0)
                      * grid, grid, min(count, k - c0));
  }
}

// The sums of ar_coef's dot rows (rows 0 .. k: c_r into hc; rows k + 1 ..
// 2 k: G[k][r - k - 1] into gram), each in one warp: lane l adds
// partials l, l + 32, ... in order, then the warp's tree.  A warp takes U
// rows kWarps apart at a time, every load outside a branch so that all
// are in flight at once (rows past the last are read again and not
// stored).
template <typename T, int U>
__device__ __forceinline__ void sum_dot_rows(const T* partial, T* hc,
                                             T* gram, const Layout& L,
                                             int k, int nparts) {
  constexpr int kWarps = kReduceThreads / 32;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nrows = 2 * k + 1;
  for (int r0 = warp; r0 < nrows; r0 += U * kWarps) {
    const T* row[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = min(r0 + u * kWarps, nrows - 1);
      row[u] = partial + (r <= k ? r * L.grid
                                 : L.g_row() + (r - k - 1) * L.grid);
    }
    T s[U];
#pragma unroll
    for (int u = 0; u < U; ++u) s[u] = T(0);
    for (int i = lane; i < nparts; i += 32) {
#pragma unroll
      for (int u = 0; u < U; ++u) s[u] += row[u][i];
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = r0 + u * kWarps;
      const T v = warp_sum(s[u]);
      if (lane == 0 && r < nrows) {
        if (r <= k) {
          hc[r] = v;
        } else {
          gram[k * L.mem + (r - k - 1)] = v;
        }
      }
    }
  }
}

// 2. One block: c_0..c_k and the Gram row k from their partials (the
// first nparts of each row; sum_dot_rows), G[k][j] stored for the later
// iterations of the pass, then h_i = c_i - sum_{j<i} G[i][j] h_j in
// blocks of 32 rows, in place of c in hc: a shared copy (Staged, mem
// values) or the h slots of the scalar array.  For each block the terms
// of the earlier blocks are summed one row a warp while the block's unit
// triangle is staged in shared memory; then warp 0 solves the triangle,
// lane l holding row b0 + l, lane m's value final (h_{b0+m}) at step m.
template <typename T, bool Staged>
__global__ void __launch_bounds__(kReduceThreads)
ar_coef(T* __restrict__ partial, T* sc, const int* st, int mem, int grid,
        int nparts) {
  if (!st[GO]) return;
  constexpr int kWarps = kReduceThreads / 32;
  extern __shared__ __align__(16) unsigned char hc_mem[];
  __shared__ T t[32];
  __shared__ T tri[32][33];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int k = st[K];
  const Layout L{mem, grid};
  T* hc = Staged ? reinterpret_cast<T*>(hc_mem) : sc + h_at(mem);
  T* gram = partial + L.gram();
  // the rows each warp holds at once: enough for 2 k + 1 rows, at most 8
  const int per_warp = (2 * k + kWarps) / kWarps;
  if (per_warp <= 1) {
    sum_dot_rows<T, 1>(partial, hc, gram, L, k, nparts);
  } else if (per_warp <= 2) {
    sum_dot_rows<T, 2>(partial, hc, gram, L, k, nparts);
  } else if (per_warp <= 4) {
    sum_dot_rows<T, 4>(partial, hc, gram, L, k, nparts);
  } else {
    sum_dot_rows<T, 8>(partial, hc, gram, L, k, nparts);
  }
  __syncthreads();
  for (int b0 = 0; b0 <= k; b0 += 32) {
    {
      // the block's triangle, G[b0 + l][b0 + m] for m < l, 0 elsewhere
      const int l = threadIdx.x >> 5;
      const int m = threadIdx.x & 31;
      const int row = b0 + l;
      tri[l][m] = row <= k && m < l
          ? gram[static_cast<long long>(row) * mem + b0 + m] : T(0);
    }
    // the terms of the blocks before b0: warp w takes row b0 + w
    const int i = b0 + warp;
    if (i <= k) {
      const T* gi = gram + static_cast<long long>(i) * mem;
      T s = T(0);
      for (int j = lane; j < b0; j += 32) s += gi[j] * hc[j];
      s = warp_sum(s);
      if (lane == 0) t[warp] = hc[i] - s;
    }
    __syncthreads();
    if (warp == 0) {
      const int row = b0 + lane;
      T ti = row <= k ? t[lane] : T(0);
#pragma unroll
      for (int m = 0; m < 32; ++m) {
        const T hm = __shfl_sync(0xffffffffu, ti, m);
        if (m < lane) ti -= tri[lane][m] * hm;
      }
      if (row <= k) hc[row] = ti;
    }
    __syncthreads();
  }
  if (Staged) {
    for (int j = threadIdx.x; j <= k; j += blockDim.x) {
      sc[h_at(mem) + j] = hc[j];
    }
  }
}

// 3. w -= h_j v_j for j = 0 .. k, in that order in each row, and the
// partials of <w, w> at ww.  The block holds kChunk of the h_j in shared
// memory at a time; w goes through memory between chunks, where it keeps
// its bits.
template <typename T, int R, typename BT, bool VEC>
__global__ void __launch_bounds__(kThreads)
ar_update(const BT* __restrict__ V, T* __restrict__ w, T* __restrict__ ww,
          const T* sc, const int* st, long long n, int mem) {
  if (!st[GO]) return;
  __shared__ T hs[kChunk];
  const int k = st[K];
  T s = T(0);
  for (int j0 = 0; j0 <= k; j0 += kChunk) {
    const int count = min(kChunk, k + 1 - j0);
    const bool last = j0 + count == k + 1;
    for (int j = threadIdx.x; j < count; j += kThreads) {
      hs[j] = sc[h_at(mem) + j0 + j];
    }
    __syncthreads();
    const BT* Vc = V + static_cast<long long>(j0) * n;
    for (long long i0 = first_rows<R>(); i0 < n; i0 += rows_stride<R>()) {
      const long long left = n - i0;
      T wv[R];
      load_rw<VEC>(w + i0, left, wv);
#pragma unroll 4
      for (int j = 0; j < count; ++j) {
        const T h = hs[j];
        T vv[R];
        load_panel<VEC>(Vc + static_cast<long long>(j) * n + i0, left, vv);
#pragma unroll
        for (int r = 0; r < R; ++r) wv[r] = wv[r] - h * vv[r];
      }
      store_rows<VEC>(w + i0, left, wv);
      if (last) {
#pragma unroll
        for (int r = 0; r < R; ++r) s += wv[r] * wv[r];
      }
    }
    // the next chunk's h overwrite hs
    __syncthreads();
  }
  store_partial(s, ww);
}

// 5. v_{k+1} = w / ||w|| in the panel's type (st[K] is k + 1 after the
// column launch).
template <typename T, int R, typename BT, bool VEC>
__global__ void __launch_bounds__(kThreads)
ar_normalise(const T* __restrict__ w, BT* __restrict__ V, const T* sc,
             const int* st, long long n) {
  if (!st[GO]) return;
  const T d = safe(sc[HBIS]);
  BT* v = V + static_cast<long long>(st[K]) * n;
  for (long long i0 = first_rows<R>(); i0 < n; i0 += rows_stride<R>()) {
    const long long left = n - i0;
    T wv[R];
    load_rows<VEC>(w + i0, left, wv);
    BT out[R];
#pragma unroll
    for (int r = 0; r < R; ++r) out[r] = narrow<BT>(wv[r] / d);
    store_rows<VEC>(v + i0, left, out);
  }
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

// What a method supplies: its one-block launches (column reads the
// partials of <w, w>, restart those of <r, r> in row 0).
//   Method::column<T>(ww, grid, sc, st, mem, stream)
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

// The blocks of a launch of kernel that the card holds at once, at most
// grid.
template <typename Kernel>
int resident_grid(Kernel kernel, int grid) {
  int dev = 0, nsm = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  return max(1, min(grid, per_sm * nsm));
}

template <typename T, typename P, typename BT, typename Method, bool VEC>
int steps(const P* pd, const long long* offs, int nd, long long lo,
          long long hi, const T* b, T* w, BT* V, T* x, T* partial, T* sc,
          int* st, long long n, int grid, int mem, int confirm, int iters,
          int cap, cudaStream_t s) {
  constexpr int R = rows_per_thread<P>();
  const Layout L{mem, grid};
  T* ww = partial + L.ww_row();
  const size_t hc_bytes = static_cast<size_t>(mem) * sizeof(T);
  const bool staged = hc_bytes <= kSmemMax;
  // the element-wise rows (no VEC) take the large shape alone
  using S = std::conditional_t<VEC, Small<T>, Large<T>>;
  auto small = ar_stencil<T, P, BT, VEC, S::kGroup, S::kMinBlocks>;
  auto large = ar_stencil<T, P, BT, VEC, Large<T>::kGroup,
                          Large<T>::kMinBlocks>;
  const int grid_small = resident_grid(small, grid);
  const int grid_large = resident_grid(large, grid);
  const int start = cap - iters;
  bool ended = false;
  for (int j = 0; j < iters; ++j) {
    const int k = (start + j) % mem;
    // a compressed panel's k is the device's; its memory decides
    const bool is_small = (confirm ? mem - 1 : k) < kSmallK;
    const int sgrid = is_small ? grid_small : grid_large;
    (is_small ? small : large)<<<sgrid, kThreads, 0, s>>>(
        pd, offs, nd, lo, hi, V, w, partial, st, n, mem, grid, cap);
    if (staged) {
      ar_coef<T, true><<<1, kReduceThreads, hc_bytes, s>>>(partial, sc, st,
                                                          mem, grid, sgrid);
    } else {
      ar_coef<T, false><<<1, kReduceThreads, 0, s>>>(partial, sc, st, mem,
                                                     grid, sgrid);
    }
    ar_update<T, R, BT, VEC><<<grid, kThreads, 0, s>>>(V, w, ww, sc, st, n,
                                                       mem);
    Method::template column<T>(ww, grid, sc, st, mem, s);
    ar_normalise<T, R, BT, VEC><<<grid, kThreads, 0, s>>>(w, V, sc, st, n);
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

// ``iters`` iterations with the iteration cap ``cap``: the solve's own
// iteration count is cap - iters at the first of them while it runs.
// [lo, hi) is the interior of the offsets (ops/cuda_dia.py _interior);
// partial holds Layout{mem, grid}.size() values, zeroed by the caller.
template <typename T, typename P, typename BT, typename Method>
int iterate(const void* pd_, const void* offsets_, int nd, long long lo,
            long long hi, const void* b_, void* w_, void* V_, void* x_,
            void* partial_, void* sc_, void* st_, long long n, int grid,
            int mem, int confirm, int iters, int cap, void* stream) {
  constexpr int R = rows_per_thread<P>();
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
  const bool vec = n % R == 0 && aligned16(pd_) && aligned16(w_)
      && aligned16(V_);
  if (vec) {
    return steps<T, P, BT, Method, true>(pd, offs, nd, lo, hi, b, w, V, x,
                                         partial, sc, st, n, grid, mem,
                                         confirm, iters, cap, s);
  }
  return steps<T, P, BT, Method, false>(pd, offs, nd, lo, hi, b, w, V, x,
                                        partial, sc, st, n, grid, mem,
                                        confirm, iters, cap, s);
}

}  // namespace arnoldi
}  // namespace
