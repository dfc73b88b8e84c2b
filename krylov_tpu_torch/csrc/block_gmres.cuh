// Whole restarted block-GMRES(mem) solve of A X = B, A in DIA form, B of
// p <= 8 columns, mem * p <= 128, on Hopper (sm_90a), with no grid-wide
// barrier.
//
// Replaces the TPU kernel krylov_tpu/ops/pallas_fused.py:2221
// block_gmres_dia_fused and computes what it computes (pallas_fused.py:
// 2268-2597): CholQR2 of B (V_0 Gamma = B); per iteration W = A V_k for
// the p columns, block CGS2 against the panels 0..k (H = V^T W,
// W -= V H, twice, H the sum), CholQR2 of W (V_{k+1} H_{k+1,k} = W,
// H_{k+1,k} = R_2 R_1), then for each of the p new scalar columns of the
// banded block Hessenberg the replay of every earlier Givens rotation in
// creation order, p new rotations (sym_givens) bottom-up, the same
// rotations on the rows of Z (the transformed E_1 Gamma, p columns), the
// mass of Z stranded on a singular pivot (|R_cc| <= btol, btol =
// eps^(3/4)), and ||r|| = sqrt(stranded + ||Z rows (k+1)p..(k+2)p-1||_F^2).
// A pass ends on the residual test, a breakdown (||H_{k+1,k}||_F <=
// btol), itmax, or k + 1 = mem: the back substitution of the (kp x kp)
// triangle for the p right-hand sides (a singular pivot gives 0 and sets
// the inconsistent flag), X += V Y, and, when the solve goes on, the
// reseed W = B - A X, CholQR2 into V_0 and Z = [Gamma; 0].  With a
// compressed basis (bf16; the arithmetic stays in T) every pass end
// reseeds, and a stop on the residual estimate holds only where the true
// residual confirms it or the pass stagnated (> half the last confirmed
// one, pallas_fused.py:2542-2566).  Outputs: X (p columns of n), niter,
// rNorm, the status (0 running, 1 solved, 2 B = 0, 7 breakdown, 100 itmax),
// the inconsistent flag and the pass count.
//
// Bound on an H100 SXM: memory bandwidth.  An iteration with k must read
// the diagonals once (28 B per row for 7 f32 diagonals), V_k once for the
// stencil, the (k+1) p basis vectors in three sweeps (CGS2 needs the
// dots of the first pass, the subtraction of the first together with the
// dots of the second, and the subtraction of the second), W and V_{k+1}
// once each; at a pass end (k+1) p vectors for X += V Y, and for the
// reseed B, X and the two CholQR sweeps.  A bf16 basis counts at half
// width.
//
// Design (csrc/block.cuh for the Cholesky of CholQR).  Ten launches per
// iteration, the basis, W and X in device memory, the scalars in `sc`:
//   1. bg_stencil   (grid)  GO; W = A V_k; partials of H1 = V^T W
//   2. bg_reduce    (grid of 8-entry groups)  H1 summed, into sc
//   3. bg_project   (grid)  W -= V H1; partials of H2 = V^T W
//   4. bg_reduce    H2 summed
//   5. bg_project   (grid)  W -= V H2; partials of the Gram triangle of W
//   6. bg_chol      (1 blk) R_1 = chol(W^T W)
//   7. bg_scale     (grid)  W <- W R_1^-1; partials of its Gram triangle
//   8. bg_chol      (1 blk) R_2
//   9. bg_scale     (grid)  V_{k+1} = W R_2^-1, in the basis type
//  10. bg_hess      (1 blk) the banded block-Hessenberg step: p threads
//                           replay the earlier iterations' rotations on
//                           the p new columns side by side, thread 0 the
//                           rotations of this iteration, Z, the stranded
//                           mass, ||r|| and the stop flags (once, not in
//                           every block)
// and the pass-end group, whose launches return at once unless a pass
// ended (the stage):
//  11. bg_backsub   (1 blk) one warp per right-hand side, the row sums
//                           across its lanes
//  12. bg_xacc      (grid)  X += V Y
//  13. bg_restart_stencil (grid)  W = B - A X; Gram partials (where the
//                           solve goes on, or always with a compressed
//                           basis)
//  14-17.                   CholQR2 of W into V_0, as 6-9
//  18. bg_restart   (1 blk) Gamma, Z, the status, the pass count
// The solve's first launches are 13-18 with X = 0.  Without a compressed
// basis a pass ends at k + 1 = mem or when the solve stops, so k = it mod
// mem while it runs: the host issues the pass-end group after the
// iterations with k = mem - 1 and at the end of each chunk (a pass that
// ended blocks every later iteration through the stage until the group
// has run); with a compressed basis after every iteration.  The
// partial-sum rows of one launch are summed in the next, never in the
// launch that writes them; no launch writes a vector whose halo it reads
// (the stencils read V_k and X, and write W).
#pragma once

#include "block.cuh"

namespace {
namespace bg {

using namespace ktt;
using blk::kMaxP;
using blk::ntri;

constexpr int kThreads = 256;
constexpr int kRows = 4;        // rows per thread in the row launches
constexpr int kJ = 4;           // basis vectors per group of partial sums
constexpr int kGroup = 8;       // entries per block of bg_reduce
constexpr int kMaxMP = 128;     // mem * p (pallas_fused.py:2660)
constexpr int kMaxMP1 = kMaxMP + kMaxP;

constexpr int RUNNING = 0;
constexpr int SOLVED = 1;
constexpr int ZERO_RESIDUAL = 2;
constexpr int BREAKDOWN = 7;
constexpr int TIRED = 100;

// The fixed slots of the scalar array (the host sets ATOL, RTOL and
// BTOL), then the arrays of struct Layout.
enum ScalarSlot {
  ATOL = 0, RTOL, BTOL, EPS_LIM, RNORM, HBIS, PREV_TR, STRAND, NSC
};
enum IntSlot {
  IT = 0, STATUS, K, GO, STAGE, INCONS, NPASS, ITMAX, FLAGS, KK, SING,
  RESEED, INIT, NST
};
// why a pass ended (FLAGS), the stages of a pass end (STAGE), and the
// gates of the launches shared by an iteration and a reseed
enum Flag { F_RESID = 1, F_BREAK = 2, F_TIRED = 4 };
enum Stage { S_NONE = 0, S_BACKSUB, S_XACC };
enum Gate { G_ITER = 0, G_RESEED };

// The arrays of the scalar array: H1 and H2 ((k+1)p x p, by rows), R_1
// and its pivots, R_2 and its pivots, the rotations c and s (p per scalar
// column), Z ((mem+1)p x p), Y (mem p x p) and the triangle R (column c
// at c * mem p).
struct Layout {
  int mem, p;
  __host__ __device__ int mp() const { return mem * p; }
  __host__ __device__ int mp1() const { return (mem + 1) * p; }
  __host__ __device__ long long h1() const { return NSC; }
  __host__ __device__ long long h2() const { return h1() + mp() * p; }
  __host__ __device__ long long r1() const { return h2() + mp() * p; }
  __host__ __device__ long long s1() const { return r1() + p * p; }
  __host__ __device__ long long r2() const { return s1() + p; }
  __host__ __device__ long long s2() const { return r2() + p * p; }
  __host__ __device__ long long cs() const { return s2() + p; }
  __host__ __device__ long long sn() const { return cs() + mp() * p; }
  __host__ __device__ long long zz() const { return sn() + mp() * p; }
  __host__ __device__ long long y() const { return zz() + mp1() * p; }
  __host__ __device__ long long rt() const { return y() + mp() * p; }
  __host__ __device__ long long size() const {
    return rt() + static_cast<long long>(mp()) * mp();
  }
};

__device__ __forceinline__ bool gate_open(const int* st, int gate) {
  if (gate == G_ITER) return st[GO] != 0;
  return st[STAGE] == S_XACC && st[RESEED] != 0;
}

// Row r (0 <= r < kRows) of this thread in a row launch.
__device__ __forceinline__ long long row_of(int r) {
  return static_cast<long long>(blockIdx.x) * (kThreads * kRows)
         + static_cast<long long>(r) * kThreads + threadIdx.x;
}

// The partials of H = V[0..nvec)^T W over this block's rows: entry
// (j, b) at partial[(j NP + b) nparts + blockIdx.x], in groups of kJ
// basis vectors, each group's sums over the block in a fixed order.
template <typename T, typename BT, int NP>
__device__ void panel_dots(const BT* __restrict__ V, long long n, int nvec,
                           const T (&w)[kRows][NP], T* __restrict__ partial,
                           int nparts) {
  for (int j0 = 0; j0 < nvec; j0 += kJ) {
    T acc[kJ * NP];
#pragma unroll
    for (int e = 0; e < kJ * NP; ++e) acc[e] = T(0);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const long long i = row_of(r);
      if (i < n) {
#pragma unroll
        for (int jj = 0; jj < kJ; ++jj) {
          if (j0 + jj < nvec) {
            const T v = widen<T>(V[static_cast<long long>(j0 + jj) * n + i]);
#pragma unroll
            for (int b = 0; b < NP; ++b) acc[jj * NP + b] += v * w[r][b];
          }
        }
      }
    }
    const int count = min(kJ, nvec - j0) * NP;
    block_sums<T, kJ * NP>(acc, partial + static_cast<long long>(j0) * NP
                                              * nparts, nparts, count);
  }
}

// 1. GO (the solve runs, below the chunk's cap, no pass end pending);
// W = A V_k; the partials of H1 = V[0..(k+1)p)^T W.
template <typename T, typename P, typename BT, int NP>
__global__ void __launch_bounds__(kThreads)
bg_stencil(const P* __restrict__ pd, const long long* __restrict__ offsets,
           int nd, const BT* __restrict__ V, T* __restrict__ W,
           T* __restrict__ partial, int* st, long long n, int cap) {
  const bool go = st[STATUS] == RUNNING && st[IT] < cap
                  && st[STAGE] == S_NONE;
  if (blockIdx.x == 0 && threadIdx.x == 0) st[GO] = go ? 1 : 0;
  if (!go) return;
  const int k = st[K];
  const BT* vk = V + static_cast<long long>(k) * NP * n;
  T w[kRows][NP];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const long long i = row_of(r);
#pragma unroll
    for (int b = 0; b < NP; ++b) {
      w[r][b] = T(0);
      if (i < n) {
        w[r][b] = stencil_row_acc<T>(pd, offsets, nd, vk + b * n, i, n);
        W[b * n + i] = w[r][b];
      }
    }
  }
  panel_dots<T, BT, NP>(V, n, (k + 1) * NP, w, partial, gridDim.x);
}

// 2, 4. The sums of the partial rows of H (of (k+1) p^2 entries), kGroup
// entries per block, into sc[slot ..].
template <typename T>
__global__ void __launch_bounds__(kThreads)
bg_reduce(const T* __restrict__ partial, int nparts, T* sc, long long slot,
          const int* st, int p) {
  if (!st[GO]) return;
  const int count = (st[K] + 1) * p * p;
  const int e0 = blockIdx.x * kGroup;
  if (e0 >= count) return;
  const int m = min(kGroup, count - e0);
  T v[kGroup];
#pragma unroll
  for (int j = 0; j < kGroup; ++j) v[j] = T(0);
  for (int i = threadIdx.x; i < nparts; i += blockDim.x) {
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      if (j < m) v[j] += partial[static_cast<long long>(e0 + j) * nparts + i];
    }
  }
  block_sums<T, kGroup>(v, sc + slot + e0, 0, m);
}

// 3, 5. W -= V[0..(k+1)p) H (H in sc[hslot ..]), each column's terms in
// the order of the basis (pallas_fused.py:2418-2426); then the partials
// of the next H, or with LAST of the Gram triangle of W.
template <typename T, typename BT, int NP, bool LAST>
__global__ void __launch_bounds__(kThreads)
bg_project(const BT* __restrict__ V, T* __restrict__ W, const T* sc,
           long long hslot, T* __restrict__ partial, const int* st,
           long long n) {
  if (!st[GO]) return;
  const int nvec = (st[K] + 1) * NP;
  __shared__ T h[kMaxMP * kMaxP];
  for (int e = threadIdx.x; e < nvec * NP; e += blockDim.x) {
    h[e] = sc[hslot + e];
  }
  __syncthreads();
  T w[kRows][NP];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const long long i = row_of(r);
#pragma unroll
    for (int b = 0; b < NP; ++b) w[r][b] = i < n ? W[b * n + i] : T(0);
  }
  for (int j = 0; j < nvec; ++j) {
    const BT* vj = V + static_cast<long long>(j) * n;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const long long i = row_of(r);
      if (i < n) {
        const T v = widen<T>(vj[i]);
#pragma unroll
        for (int b = 0; b < NP; ++b) w[r][b] = w[r][b] - h[j * NP + b] * v;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const long long i = row_of(r);
    if (i < n) {
#pragma unroll
      for (int b = 0; b < NP; ++b) W[b * n + i] = w[r][b];
    }
  }
  if constexpr (LAST) {
    T g[ntri(NP)];
#pragma unroll
    for (int e = 0; e < ntri(NP); ++e) g[e] = T(0);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (row_of(r) < n) blk::gram_add<T, NP>(g, w[r]);
    }
    block_sums<T, ntri(NP)>(g, partial, gridDim.x);
  } else {
    panel_dots<T, BT, NP>(V, n, nvec, w, partial, gridDim.x);
  }
}

// 6, 8, 15, 17. The Gram triangle from its partial rows, and its Cholesky
// factor into sc (R_1 and its pivots, or with second R_2), in one block.
template <typename T>
__global__ void __launch_bounds__(kThreads)
bg_chol(const T* __restrict__ partial, int nparts, T* sc, const int* st,
        int mem, int p, int gate, int second) {
  if (!gate_open(st, gate)) return;
  const Layout L{mem, p};
  __shared__ T g[ntri(kMaxP)];
  sum_partial_rows(partial, nparts, ntri(p), g);
  if (threadIdx.x == 0) {
    blk::cholesky(g, p, sc[BTOL], sc + (second ? L.r2() : L.r1()),
                  sc + (second ? L.s2() : L.s1()));
  }
}

// 7, 9, 16, 18. W <- W R^-1 row by row: the first pass (R_1) writes W
// back with the partials of its Gram triangle; the second (FINAL, R_2)
// writes the basis panel k + 1 (a reseed: panel 0) in the basis type.
template <typename T, typename BT, int NP, bool FINAL>
__global__ void __launch_bounds__(kThreads)
bg_scale(BT* __restrict__ V, T* __restrict__ W, const T* sc,
         T* __restrict__ partial, const int* st, long long n, int mem,
         int gate) {
  if (!gate_open(st, gate)) return;
  const Layout L{mem, NP};
  __shared__ T R[kMaxP * kMaxP];
  __shared__ T sf[kMaxP];
  if (threadIdx.x < NP * NP) {
    R[threadIdx.x] = sc[(FINAL ? L.r2() : L.r1()) + threadIdx.x];
  }
  if (threadIdx.x < NP) sf[threadIdx.x] = sc[(FINAL ? L.s2() : L.s1())
                                             + threadIdx.x];
  __syncthreads();
  const int slot = gate == G_ITER ? st[K] + 1 : 0;
  BT* vout = V + static_cast<long long>(slot) * NP * n;
  T g[ntri(NP)];
#pragma unroll
  for (int e = 0; e < ntri(NP); ++e) g[e] = T(0);
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const long long i = row_of(r);
    if (i >= n) continue;
    T w[NP];
#pragma unroll
    for (int b = 0; b < NP; ++b) w[b] = W[b * n + i];
    blk::solve_row<T, NP>(w, R, sf);
    if (FINAL) {
#pragma unroll
      for (int b = 0; b < NP; ++b) vout[b * n + i] = narrow<BT>(w[b]);
    } else {
#pragma unroll
      for (int b = 0; b < NP; ++b) W[b * n + i] = w[b];
      blk::gram_add<T, NP>(g, w);
    }
  }
  if (!FINAL) block_sums<T, ntri(NP)>(g, partial, gridDim.x);
}

// One Givens rotation on rows r - 1 and r of a column.
template <typename T>
__device__ __forceinline__ void rotate(T* col, int r, T ch, T sh) {
  const T u = col[r - 1];
  const T v = col[r];
  col[r - 1] = ch * u + sh * v;
  col[r] = sh * u - ch * v;
}

// 10. The banded block-Hessenberg step of iteration k (pallas_fused.py:
// 2438-2511), in one block.
template <typename T>
__global__ void __launch_bounds__(kThreads)
bg_hess(T* sc, int* st, int mem, int p) {
  if (!st[GO]) return;
  const Layout L{mem, p};
  const int k = st[K];
  const int c0 = k * p;
  const int nv = (k + 1) * p;
  const int mp = L.mp();
  const T btol = sc[BTOL];
  __shared__ T col[kMaxP][kMaxMP1 + 1];
  __shared__ T R[kMaxP * kMaxP];
  __shared__ T hbis_s;
  if (threadIdx.x == 0) {
    blk::chol2_product(sc + L.r2(), sc + L.r1(), p, R);
    T s = T(0);
    for (int e = 0; e < p * p; ++e) s = s + R[e] * R[e];
    hbis_s = sqrt(s);
  }
  __syncthreads();
  // the p new columns: H1 + H2 over the basis, R below
  for (int e = threadIdx.x; e < p * (nv + p); e += blockDim.x) {
    const int l = e / (nv + p);
    const int i = e % (nv + p);
    col[l][i] = i < nv ? sc[L.h1() + i * p + l] + sc[L.h2() + i * p + l]
                       : R[(i - nv) * p + l];
  }
  __syncthreads();
  // the rotations of the earlier iterations, a thread per column
  if (static_cast<int>(threadIdx.x) < p) {
    T* cl = col[threadIdx.x];
    for (int c2 = 0; c2 < c0; ++c2) {
      for (int j = 0; j < p; ++j) {
        rotate(cl, c2 + p - j, sc[L.cs() + c2 * p + j],
               sc[L.sn() + c2 * p + j]);
      }
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    T* zz = sc + L.zz();
    T strand = sc[STRAND];
    for (int l = 0; l < p; ++l) {
      const int c = c0 + l;
      T* cl = col[l];
      for (int c2 = c0; c2 < c; ++c2) {
        for (int j = 0; j < p; ++j) {
          rotate(cl, c2 + p - j, sc[L.cs() + c2 * p + j],
                 sc[L.sn() + c2 * p + j]);
        }
      }
      for (int j = 0; j < p; ++j) {
        const int r = c + p - j;
        T ch, sh, rr;
        sym_givens(cl[r - 1], cl[r], ch, sh, rr);
        sc[L.cs() + c * p + j] = ch;
        sc[L.sn() + c * p + j] = sh;
        cl[r - 1] = rr;
        for (int b = 0; b < p; ++b) {
          const T u = zz[(r - 1) * p + b];
          const T v = zz[r * p + b];
          zz[(r - 1) * p + b] = ch * u + sh * v;
          zz[r * p + b] = sh * u - ch * v;
        }
      }
      // a singular pivot strands the mass of Z's row c
      // (pallas_fused.py:2475-2488)
      T sm = T(0);
      for (int b = 0; b < p; ++b) sm = sm + zz[c * p + b] * zz[c * p + b];
      strand = strand + (fabs(cl[c]) <= btol ? sm : T(0));
    }
    sc[STRAND] = strand;
    T ss = strand;
    for (int a = 0; a < p; ++a) {
      for (int b = 0; b < p; ++b) {
        const T z = zz[(nv + a) * p + b];
        ss = ss + z * z;
      }
    }
    const T rnorm = sqrt(ss);
    const T hbis = hbis_s;
    const int it = st[IT] + 1;
    const int kk = k + 1;
    const bool resid = rnorm <= sc[EPS_LIM] || rnorm + T(1) <= T(1);
    const bool brk = hbis <= btol;
    const bool tired = it >= st[ITMAX];
    const bool inner_done = resid || brk || tired || kk >= mem;
    st[IT] = it;
    st[K] = kk;
    sc[RNORM] = rnorm;
    sc[HBIS] = hbis;
    if (inner_done) {
      st[STAGE] = S_BACKSUB;
      st[KK] = kk;
      st[FLAGS] = (resid ? F_RESID : 0) | (brk ? F_BREAK : 0)
                  | (tired ? F_TIRED : 0);
    }
  }
  __syncthreads();
  // the columns into the triangle, rows 0..c (pallas_fused.py:2473)
  for (int e = threadIdx.x; e < p * mp; e += blockDim.x) {
    const int l = e / mp;
    const int i = e % mp;
    const int c = c0 + l;
    if (i <= c) sc[L.rt() + static_cast<long long>(c) * mp + i] = col[l][i];
  }
}

// 11. The back substitution R Y = Z_top of the pass's kk p columns, a warp
// per right-hand side (pallas_fused.py:2522-2538): Y into sc, the
// singular-pivot flag, and whether the pass end reseeds.
template <typename T>
__global__ void __launch_bounds__(kThreads)
bg_backsub(T* sc, int* st, int mem, int p, int confirm) {
  if (st[STAGE] != S_BACKSUB) return;
  const Layout L{mem, p};
  const int mp = L.mp();
  const int cols = st[KK] * p;
  const T btol = sc[BTOL];
  const T* zz = sc + L.zz();
  const T* rt = sc + L.rt();
  __shared__ T ys[kMaxP][kMaxMP];
  __shared__ int sing_any;
  if (threadIdx.x == 0) sing_any = 0;
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (warp < p) {
    const int b = warp;
    for (int i = cols - 1; i >= 0; --i) {
      T part = T(0);
      for (int j = i + 1 + lane; j < cols; j += 32) {
        part += rt[static_cast<long long>(j) * mp + i] * ys[b][j];
      }
      for (int o = 16; o > 0; o >>= 1) {
        part += __shfl_down_sync(0xffffffffu, part, o);
      }
      if (lane == 0) {
        const T diag = rt[static_cast<long long>(i) * mp + i];
        const bool sing = fabs(diag) <= btol;
        ys[b][i] = sing ? T(0) : (zz[i * p + b] - part) / diag;
        if (sing) sing_any = 1;
      }
      __syncwarp();
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < cols * p; e += blockDim.x) {
    sc[L.y() + e] = ys[e % p][e / p];
  }
  if (threadIdx.x == 0) {
    const int flags = st[FLAGS];
    st[SING] = sing_any;
    st[RESEED] = confirm || !(flags & (F_RESID | F_BREAK | F_TIRED)) ? 1 : 0;
    st[STAGE] = S_XACC;
  }
}

// 12. X += sum_j Y_j v_j over the pass's kk p basis vectors, one term
// after another (pallas_fused.py:2540-2546).
template <typename T, typename BT, int NP>
__global__ void __launch_bounds__(kThreads)
bg_xacc(const BT* __restrict__ V, T* __restrict__ X, const T* sc,
        const int* st, long long n, int mem) {
  if (st[STAGE] != S_XACC) return;
  const Layout L{mem, NP};
  const int cols = st[KK] * NP;
  __shared__ T ys[kMaxMP * kMaxP];
  for (int e = threadIdx.x; e < cols * NP; e += blockDim.x) {
    ys[e] = sc[L.y() + e];
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const long long i = row_of(r);
    if (i >= n) continue;
    T x[NP];
#pragma unroll
    for (int b = 0; b < NP; ++b) x[b] = X[b * n + i];
    for (int j = 0; j < cols; ++j) {
      const T v = widen<T>(V[static_cast<long long>(j) * n + i]);
#pragma unroll
      for (int b = 0; b < NP; ++b) x[b] = x[b] + ys[j * NP + b] * v;
    }
#pragma unroll
    for (int b = 0; b < NP; ++b) X[b * n + i] = x[b];
  }
}

// 13. The reseed: W = B - A X and the partials of its Gram triangle.
template <typename T, typename P, int NP>
__global__ void __launch_bounds__(kThreads)
bg_restart_stencil(const P* __restrict__ pd,
                   const long long* __restrict__ offsets, int nd,
                   const T* __restrict__ Bt, const T* __restrict__ X,
                   T* __restrict__ W, T* __restrict__ partial, const int* st,
                   long long n) {
  if (!gate_open(st, G_RESEED)) return;
  T g[ntri(NP)];
#pragma unroll
  for (int e = 0; e < ntri(NP); ++e) g[e] = T(0);
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const long long i = row_of(r);
    if (i >= n) continue;
    T w[NP];
#pragma unroll
    for (int b = 0; b < NP; ++b) {
      w[b] = Bt[b * n + i] - stencil_row<T>(pd, offsets, nd, X + b * n, i, n);
      W[b * n + i] = w[b];
    }
    blk::gram_add<T, NP>(g, w);
  }
  block_sums<T, ntri(NP)>(g, partial, gridDim.x);
}

// 18. The pass end's scalars (or the start's, with INIT): Gamma = R_2 R_1
// of the reseed, Z = [Gamma; 0], the stranded mass cleared; the status
// (pallas_fused.py:2548-2595), the inconsistent flag, the pass count and
// rNorm (the true residual when the solve goes on).
template <typename T>
__global__ void __launch_bounds__(kThreads)
bg_restart(T* sc, int* st, int mem, int p, int confirm) {
  if (st[STAGE] != S_XACC) return;
  const Layout L{mem, p};
  __shared__ T G[kMaxP * kMaxP];
  __shared__ T beta_s;
  const bool reseeded = st[RESEED] != 0;
  if (reseeded) {
    if (threadIdx.x == 0) {
      blk::chol2_product(sc + L.r2(), sc + L.r1(), p, G);
      T s = T(0);
      for (int e = 0; e < p * p; ++e) s = s + G[e] * G[e];
      beta_s = sqrt(s);
    }
    __syncthreads();
    T* zz = sc + L.zz();
    for (int e = threadIdx.x; e < L.mp1() * p; e += blockDim.x) {
      zz[e] = e < p * p ? G[e] : T(0);
    }
  }
  if (threadIdx.x != 0) return;
  const T beta_r = reseeded ? beta_s : T(0);
  if (reseeded) sc[STRAND] = T(0);
  if (st[INIT]) {
    const T eps_lim = sc[ATOL] + sc[RTOL] * beta_r;
    sc[EPS_LIM] = eps_lim;
    sc[RNORM] = beta_r;
    sc[HBIS] = T(0);
    sc[PREV_TR] = static_cast<T>(INFINITY);
    st[STATUS] = beta_r == T(0) ? ZERO_RESIDUAL
                 : beta_r <= eps_lim ? SOLVED : RUNNING;
    st[IT] = 0;
    st[K] = 0;
    st[GO] = 0;
    st[INCONS] = 0;
    st[NPASS] = 1;
    st[INIT] = 0;
    st[STAGE] = S_NONE;
    return;
  }
  const int flags = st[FLAGS];
  const bool resid = flags & F_RESID;
  const bool brk = flags & F_BREAK;
  const bool tired = flags & F_TIRED;
  bool final_resid = resid;
  if (confirm) {
    const T eps_lim = sc[EPS_LIM];
    const bool confirmed = beta_r <= eps_lim || beta_r + T(1) <= T(1);
    const bool stagnated = beta_r > T(0.5) * sc[PREV_TR];
    final_resid = resid && (confirmed || stagnated);
    if (resid && !final_resid) sc[PREV_TR] = beta_r;
  }
  const bool glob_final = final_resid || brk || tired;
  if (st[SING]) st[INCONS] = 1;
  int code = BREAKDOWN;
  if (tired) code = TIRED;
  if (final_resid) code = SOLVED;
  if (!glob_final) code = RUNNING;
  st[STATUS] = code;
  st[K] = 0;
  st[STAGE] = S_NONE;
  if (!glob_final) {
    st[NPASS] += 1;
    sc[RNORM] = beta_r;
  }
}

// The start's scalars: the stage of a reseed with X = 0 (INIT).
__global__ void bg_init_scalars(int* st, int itmax) {
  for (int j = 0; j < NST; ++j) st[j] = 0;
  st[ITMAX] = itmax;
  st[STAGE] = S_XACC;
  st[RESEED] = 1;
  st[INIT] = 1;
}

template <typename T>
struct Bufs {
  const T* Bt;
  T* W;
  T* X;
  T* partial;
  T* sc;
  int* st;
};

// The reseed (13-18; at the start, with INIT, from X = 0).
template <typename T, typename P, typename BT, int NP>
void reseed(const P* pd, const long long* offs, int nd, BT* V,
            const Bufs<T>& q, long long n, int grid, int mem, int confirm,
            cudaStream_t s) {
  bg_restart_stencil<T, P, NP><<<grid, kThreads, 0, s>>>(
      pd, offs, nd, q.Bt, q.X, q.W, q.partial, q.st, n);
  bg_chol<T><<<1, kThreads, 0, s>>>(q.partial, grid, q.sc, q.st, mem, NP,
                                    G_RESEED, 0);
  bg_scale<T, BT, NP, false><<<grid, kThreads, 0, s>>>(
      V, q.W, q.sc, q.partial, q.st, n, mem, G_RESEED);
  bg_chol<T><<<1, kThreads, 0, s>>>(q.partial, grid, q.sc, q.st, mem, NP,
                                    G_RESEED, 1);
  bg_scale<T, BT, NP, true><<<grid, kThreads, 0, s>>>(
      V, q.W, q.sc, q.partial, q.st, n, mem, G_RESEED);
  bg_restart<T><<<1, kThreads, 0, s>>>(q.sc, q.st, mem, NP, confirm);
}

template <typename T, typename P, typename BT, int NP>
int init_p(const void* pd, const void* offsets, int nd, void* V,
           const Bufs<T>& q, long long n, int grid, int mem, int itmax,
           cudaStream_t s) {
  bg_init_scalars<<<1, 1, 0, s>>>(q.st, itmax);
  reseed<T, P, BT, NP>(static_cast<const P*>(pd),
                       static_cast<const long long*>(offsets), nd,
                       static_cast<BT*>(V), q, n, grid, mem, 0, s);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename P, typename BT, int NP>
int iterate_p(const void* pd_, const void* offsets, int nd, void* V_,
              const Bufs<T>& q, long long n, int grid, int mem, int confirm,
              int iters, int cap, cudaStream_t s) {
  const Layout L{mem, NP};
  const P* pd = static_cast<const P*>(pd_);
  const long long* offs = static_cast<const long long*>(offsets);
  BT* V = static_cast<BT*>(V_);
  const int nred = (L.mp() * NP + kGroup - 1) / kGroup;
  const int start = cap - iters;
  bool ended = false;
  for (int j = 0; j < iters; ++j) {
    const int k = (start + j) % mem;
    bg_stencil<T, P, BT, NP><<<grid, kThreads, 0, s>>>(
        pd, offs, nd, V, q.W, q.partial, q.st, n, cap);
    bg_reduce<T><<<nred, kThreads, 0, s>>>(q.partial, grid, q.sc, L.h1(),
                                           q.st, NP);
    bg_project<T, BT, NP, false><<<grid, kThreads, 0, s>>>(
        V, q.W, q.sc, L.h1(), q.partial, q.st, n);
    bg_reduce<T><<<nred, kThreads, 0, s>>>(q.partial, grid, q.sc, L.h2(),
                                           q.st, NP);
    bg_project<T, BT, NP, true><<<grid, kThreads, 0, s>>>(
        V, q.W, q.sc, L.h2(), q.partial, q.st, n);
    bg_chol<T><<<1, kThreads, 0, s>>>(q.partial, grid, q.sc, q.st, mem, NP,
                                      G_ITER, 0);
    bg_scale<T, BT, NP, false><<<grid, kThreads, 0, s>>>(
        V, q.W, q.sc, q.partial, q.st, n, mem, G_ITER);
    bg_chol<T><<<1, kThreads, 0, s>>>(q.partial, grid, q.sc, q.st, mem, NP,
                                      G_ITER, 1);
    bg_scale<T, BT, NP, true><<<grid, kThreads, 0, s>>>(
        V, q.W, q.sc, q.partial, q.st, n, mem, G_ITER);
    bg_hess<T><<<1, kThreads, 0, s>>>(q.sc, q.st, mem, NP);
    ended = confirm || k == mem - 1;
    if (ended) {
      bg_backsub<T><<<1, kThreads, 0, s>>>(q.sc, q.st, mem, NP, confirm);
      bg_xacc<T, BT, NP><<<grid, kThreads, 0, s>>>(V, q.X, q.sc, q.st, n,
                                                   mem);
      reseed<T, P, BT, NP>(pd, offs, nd, V, q, n, grid, mem, confirm, s);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (!ended) {
    bg_backsub<T><<<1, kThreads, 0, s>>>(q.sc, q.st, mem, NP, confirm);
    bg_xacc<T, BT, NP><<<grid, kThreads, 0, s>>>(V, q.X, q.sc, q.st, n, mem);
    reseed<T, P, BT, NP>(pd, offs, nd, V, q, n, grid, mem, confirm, s);
  }
  return static_cast<int>(cudaGetLastError());
}

#define KTT_BG_DISPATCH(CALL)                                                 \
  switch (p) {                                                               \
    case 1: return CALL(1);                                                  \
    case 2: return CALL(2);                                                  \
    case 3: return CALL(3);                                                  \
    case 4: return CALL(4);                                                  \
    case 5: return CALL(5);                                                  \
    case 6: return CALL(6);                                                  \
    case 7: return CALL(7);                                                  \
    case 8: return CALL(8);                                                  \
    default: return static_cast<int>(cudaErrorInvalidValue);                 \
  }

template <typename T, typename P, typename BT>
int init(const void* pd, const void* offsets, int nd, const void* Bt,
         void* V, void* W, void* X, void* partial, void* sc, void* st,
         long long n, int grid, int p, int mem, int itmax, void* stream) {
  if (mem * p > kMaxMP || mem < 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Bufs<T> q{static_cast<const T*>(Bt), static_cast<T*>(W),
                  static_cast<T*>(X), static_cast<T*>(partial),
                  static_cast<T*>(sc), static_cast<int*>(st)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define KTT_BG_INIT(NP)                                                       \
  init_p<T, P, BT, NP>(pd, offsets, nd, V, q, n, grid, mem, itmax, s)
  KTT_BG_DISPATCH(KTT_BG_INIT)
#undef KTT_BG_INIT
}

template <typename T, typename P, typename BT>
int iterate(const void* pd, const void* offsets, int nd, const void* Bt,
            void* V, void* W, void* X, void* partial, void* sc, void* st,
            long long n, int grid, int p, int mem, int confirm, int iters,
            int cap, void* stream) {
  if (mem * p > kMaxMP || mem < 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Bufs<T> q{static_cast<const T*>(Bt), static_cast<T*>(W),
                  static_cast<T*>(X), static_cast<T*>(partial),
                  static_cast<T*>(sc), static_cast<int*>(st)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define KTT_BG_ITER(NP)                                                       \
  iterate_p<T, P, BT, NP>(pd, offsets, nd, V, q, n, grid, mem, confirm,     \
                          iters, cap, s)
  KTT_BG_DISPATCH(KTT_BG_ITER)
#undef KTT_BG_ITER
}

#undef KTT_BG_DISPATCH

}  // namespace bg
}  // namespace

// (pd, offsets, nd, Bt, V, W, X, partial, sc, st, n, grid, p, mem, itmax,
// stream) and (pd, offsets, nd, Bt, V, W, X, partial, sc, st, n, grid, p,
// mem, confirm, iters, cap, stream)
#define KTT_BG_ENTRIES(INIT, ITERATE, T, P, BT)                               \
  extern "C" int INIT(const void* pd, const void* offsets, int nd,           \
                      const void* Bt, void* V, void* W, void* X,             \
                      void* partial, void* sc, void* st, long long n,        \
                      int grid, int p, int mem, int itmax, void* stream) {   \
    return bg::init<T, P, BT>(pd, offsets, nd, Bt, V, W, X, partial, sc, st, \
                              n, grid, p, mem, itmax, stream);               \
  }                                                                          \
  extern "C" int ITERATE(const void* pd, const void* offsets, int nd,        \
                         const void* Bt, void* V, void* W, void* X,          \
                         void* partial, void* sc, void* st, long long n,     \
                         int grid, int p, int mem, int confirm, int iters,   \
                         int cap, void* stream) {                            \
    return bg::iterate<T, P, BT>(pd, offsets, nd, Bt, V, W, X, partial, sc,  \
                                 st, n, grid, p, mem, confirm, iters, cap,   \
                                 stream);                                    \
  }
