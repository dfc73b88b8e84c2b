// Whole block-MINRES solve of A X = B, A Hermitian and in DIA form, B of
// p <= 8 columns, on Hopper (sm_90a), with no grid-wide barrier.
//
// Replaces the TPU kernel krylov_tpu/ops/pallas_fused.py:2669
// block_minres_dia_fused and computes what it computes (pallas_fused.py:
// 2705-2942): CholQR2 of B (V_1 Gamma = B), then per iteration the block
// Lanczos step W = A V_k - V_{k-1} Psi_k^T - V_k Omega_k with
// Omega_k = V_k^T A V_k, CholQR2 of W (V_{k+1} Psi_{k+1} = W), the last two
// reflections applied to [0; Psi_k^T] and [Gamma-bar; Omega_k], the Givens
// QR of [Lambda-bar; Psi_{k+1}] accumulated into the 2p x 2p reflection
// Theta_k, [Phi_k; Phi-bar_{k+1}] = Theta_k [Phi-bar_k; 0], the direction
// panel W~_k = (V_k - W~_{k-1} Gamma_{k-1} - W~_{k-2} Pi_{k-2}) Lambda_k^-1,
// X += W~_k Phi_k and rNorm = ||Phi-bar_{k+1}||_F.  Outputs: X (as p
// columns of n), niter, rNorm and the status (0 running, 1 solved, 2
// B = 0).
//
// Bound on an H100 SXM: memory bandwidth.  An iteration reads the
// diagonals once (28 B per row in f32 for the 7-point stencil) and must
// read V_k, V_{k-1}, W~_{k-1}, W~_{k-2} and X and write V_{k+1}, W~_k and
// X: 28 + 8 p x 4 B per row, 156 B at p = 4.
//
// Design (csrc/block.cuh for the panels and CholQR).  Five launches per
// iteration:
//   1. bm_stencil (grid)  GO; W = A V_k for the p columns, the diagonals
//                         read once per row; the partials of Omega_k
//   2. bm_orth    (grid)  Omega summed in every block (block 0 keeps it
//                         for launch 4); W -= V_{k-1} Psi_k^T + V_k Omega
//                         (the TPU kernel's order); the partials of W^T W
//   3. bm_chol    (grid)  the first Cholesky in every block (block 0 keeps
//                         R_1); W <- W R_1^-1; the partials of W^T W
//   4. bm_update  (grid)  the second Cholesky in every block, Psi_{k+1} =
//                         R_2 R_1, and thread 0 of every block runs the
//                         scalar step (block 0 stages the next Psi,
//                         Phi-bar, the two reflections, rNorm and the
//                         status); the rows: V_{k+1} = W R_2^-1 in place,
//                         W~_k column by column, X += W~_k Phi_k
//   5. bm_commit  (1 blk) the staged state, it += 1
// V_{k-1}, V_k and W (V_{k+1}) turn over through three panel slots by the
// iteration count, W~_{k-2} and W~_{k-1} through two: the new W~_k goes
// over W~_{k-2} row by row, in the thread that read it (the TPU kernel
// copies, pallas_fused.py:2919-2932).  All rings and X start at 0.  The
// stencil reads the neighbours of V_k only, in a launch that writes W.
// Per iteration this design moves (28 + 8p) + 12p + 8p + 24p B per row in
// f32: 236 B at p = 4.//
// block_minres_dia.cu instantiates the f32 entry points and
// block_minres_dia_f64.cu the f64 ones: two translation units, which the
// build compiles side by side (the eight block widths make each long).
#pragma once

#include "block.cuh"

namespace {

using namespace ktt;
using blk::col;
using blk::kMaxP;
using blk::ntri;
using blk::tri;

constexpr int kThreads = 256;

constexpr int RUNNING = 0;
constexpr int SOLVED = 1;
constexpr int ZERO_RESIDUAL = 2;

// The fixed slots of the scalar array (the host sets ATOL and RTOL), then
// the state, sized by p: Psi (p^2), Phi-bar (p^2), Theta_{k-2} and
// Theta_{k-1} (4 p^2 each), then its staging copy (rNorm and the four
// arrays), then Omega and R_1 of the current iteration (p^2 each).
enum ScalarSlot { ATOL = 0, RTOL, EPS_LIM, RNORM, PSI };
// IT, STATUS, GO and the staged status
enum IntSlot { IT = 0, STATUS, GO, S_STATUS, NST };

struct Layout {
  int p;
  __device__ int psi() const { return PSI; }
  __device__ int phib() const { return PSI + p * p; }
  __device__ int qt2() const { return PSI + 2 * p * p; }
  __device__ int qt1() const { return PSI + 6 * p * p; }
  __device__ int state_end() const { return PSI + 10 * p * p; }
  // the staging copy of slots RNORM .. state_end()
  __device__ int stage(int slot) const {
    return slot + state_end() - RNORM;
  }
  __device__ int om() const { return 2 * state_end() - RNORM; }
  __device__ int r1() const { return om() + p * p; }
  // work panels: V in slots 0..2, W~ in 3..4, X in 5
  // partial rows: Omega (p^2), the two Gram triangles
  __device__ int p_om() const { return 0; }
  __device__ int p_g1() const { return p * p; }
  __device__ int p_g2() const { return p * p + ntri(p); }
};

__device__ __forceinline__ int vslot(int it0, int d) { return (it0 + d) % 3; }

template <typename T>
__device__ __forceinline__ T btol_of() {
  return static_cast<T>(pow(static_cast<double>(eps_of<T>()), 0.75));
}

// The Gram triangle of the panel in slot `slot` (p columns), from its
// partial rows; then its Cholesky factor in R and safe (shared memory),
// valid in every thread on return.
template <typename T>
__device__ void chol_from_partials(const T* partial, int nparts, int p,
                                   T* g, T* R, T* safe) {
  sum_partial_rows(partial, nparts, ntri(p), g);
  if (threadIdx.x == 0) blk::cholesky(g, p, btol_of<T>(), R, safe);
  __syncthreads();
}

// Init: the panels zeroed, B copied into V slot 0; the partials of B^T B.
template <typename T, int NP>
__global__ void __launch_bounds__(kThreads)
bm_init_copy(const T* __restrict__ Bt, T* __restrict__ work,
             T* __restrict__ partial, long long n) {
  const Layout L{NP};
  T g[ntri(NP)];
#pragma unroll
  for (int j = 0; j < ntri(NP); ++j) g[j] = T(0);
  for (long long i = first_row(); i < n; i += row_stride()) {
    T w[NP];
#pragma unroll
    for (int b = 0; b < NP; ++b) {
      w[b] = Bt[static_cast<long long>(b) * n + i];
      col(work, 0, b, NP, n)[i] = w[b];
      for (int s = 1; s < 6; ++s) col(work, s, b, NP, n)[i] = T(0);
    }
    blk::gram_add<T, NP>(g, w);
  }
  block_sums<T, ntri(NP)>(
      g, partial + static_cast<long long>(L.p_g1()) * gridDim.x, gridDim.x);
}

// 1. GO; W = A V_k; the partials of Omega = V_k^T W.
template <typename T, typename P, int NP>
__global__ void __launch_bounds__(kThreads)
bm_stencil(const P* __restrict__ pd, const long long* __restrict__ offsets,
           int nd, T* __restrict__ work, T* __restrict__ partial, int* st,
           long long n, int cap) {
  const int it0 = st[IT];
  const bool go = st[STATUS] == RUNNING && it0 < cap;
  if (blockIdx.x == 0 && threadIdx.x == 0) st[GO] = go ? 1 : 0;
  if (!go) return;
  const int cur = vslot(it0, 0);
  const int nxt = vslot(it0, 1);
  T om[NP * NP];
#pragma unroll
  for (int j = 0; j < NP * NP; ++j) om[j] = T(0);
  for (long long i = first_row(); i < n; i += row_stride()) {
    T acc[NP];
#pragma unroll
    for (int b = 0; b < NP; ++b) acc[b] = T(0);
    for (int d = 0; d < nd; ++d) {
      const long long j = i + __ldg(offsets + d);
      if (j >= 0 && j < n) {
        const T a = widen<T>(pd[static_cast<long long>(d) * n + i]);
#pragma unroll
        for (int b = 0; b < NP; ++b) {
          acc[b] = acc[b] + a * col(work, cur, b, NP, n)[j];
        }
      }
    }
#pragma unroll
    for (int a = 0; a < NP; ++a) {
      const T va = col(work, cur, a, NP, n)[i];
#pragma unroll
      for (int b = 0; b < NP; ++b) om[a * NP + b] += va * acc[b];
    }
#pragma unroll
    for (int b = 0; b < NP; ++b) col(work, nxt, b, NP, n)[i] = acc[b];
  }
  block_sums<T, NP * NP>(om, partial, gridDim.x);
}

// 2. Omega; W -= V_{k-1} Psi^T + V_k Omega; the partials of W^T W.
template <typename T, int NP>
__global__ void __launch_bounds__(kThreads)
bm_orth(T* __restrict__ work, T* __restrict__ partial, T* sc, const int* st,
        long long n) {
  if (!st[GO]) return;
  const Layout L{NP};
  const int it0 = st[IT];
  const int nparts = gridDim.x;
  __shared__ T om[kMaxP * kMaxP];
  __shared__ T cpsi[kMaxP * kMaxP];
  sum_partial_rows(partial, nparts, NP * NP, om);
  if (threadIdx.x == 0) {
    // (m2 psi[b][a]), m2 = 0 at the first iteration (pallas_fused.py:2813)
    const T m2 = it0 >= 1 ? T(1) : T(0);
    for (int j = 0; j < NP * NP; ++j) cpsi[j] = m2 * sc[L.psi() + j];
    if (blockIdx.x == 0) {
      for (int j = 0; j < NP * NP; ++j) sc[L.om() + j] = om[j];
    }
  }
  __syncthreads();
  const int prv = vslot(it0, 2);
  const int cur = vslot(it0, 0);
  const int nxt = vslot(it0, 1);
  T g[ntri(NP)];
#pragma unroll
  for (int j = 0; j < ntri(NP); ++j) g[j] = T(0);
  for (long long i = first_row(); i < n; i += row_stride()) {
    T vm[NP];
    T vk[NP];
    T w[NP];
#pragma unroll
    for (int a = 0; a < NP; ++a) {
      vm[a] = col(work, prv, a, NP, n)[i];
      vk[a] = col(work, cur, a, NP, n)[i];
    }
#pragma unroll
    for (int b = 0; b < NP; ++b) {
      T v = col(work, nxt, b, NP, n)[i];
#pragma unroll
      for (int a = 0; a < NP; ++a) {
        v = v - cpsi[b * NP + a] * vm[a];
        v = v - om[a * NP + b] * vk[a];
      }
      w[b] = v;
      col(work, nxt, b, NP, n)[i] = v;
    }
    blk::gram_add<T, NP>(g, w);
  }
  block_sums<T, ntri(NP)>(
      g, partial + static_cast<long long>(L.p_g1()) * nparts, nparts);
}

// 3. The first Cholesky (block 0 keeps R_1); W <- W R_1^-1; the partials of
// the new W^T W.  With init, on V slot 0 (B) whatever GO says.
template <typename T, int NP>
__global__ void __launch_bounds__(kThreads)
bm_chol(T* __restrict__ work, T* __restrict__ partial, T* sc, const int* st,
        long long n, int init) {
  if (!init && !st[GO]) return;
  const Layout L{NP};
  const int nparts = gridDim.x;
  __shared__ T g[ntri(kMaxP)];
  __shared__ T R[kMaxP * kMaxP];
  __shared__ T safe[kMaxP];
  chol_from_partials(partial + static_cast<long long>(L.p_g1()) * nparts,
                     nparts, NP, g, R, safe);
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    for (int j = 0; j < NP * NP; ++j) sc[L.r1() + j] = R[j];
  }
  const int slot = init ? 0 : vslot(st[IT], 1);
  T gg[ntri(NP)];
#pragma unroll
  for (int j = 0; j < ntri(NP); ++j) gg[j] = T(0);
  for (long long i = first_row(); i < n; i += row_stride()) {
    T w[NP];
#pragma unroll
    for (int b = 0; b < NP; ++b) w[b] = col(work, slot, b, NP, n)[i];
    blk::solve_row<T, NP>(w, R, safe);
#pragma unroll
    for (int b = 0; b < NP; ++b) col(work, slot, b, NP, n)[i] = w[b];
    blk::gram_add<T, NP>(gg, w);
  }
  block_sums<T, ntri(NP)>(
      gg, partial + static_cast<long long>(L.p_g2()) * nparts, nparts);
}

// Init, after bm_chol: the second Cholesky, V_1 = W R_2^-1 in slot 0,
// Gamma = R_2 R_1 = Phi-bar_1, Psi = 0, Theta = I, rNorm_0 = ||Gamma||_F,
// eps and the status (pallas_fused.py:2765-2788).
template <typename T, int NP>
__global__ void __launch_bounds__(kThreads)
bm_init_finish(T* __restrict__ work, const T* __restrict__ partial, T* sc,
               int* st, long long n) {
  const Layout L{NP};
  const int nparts = gridDim.x;
  __shared__ T g[ntri(kMaxP)];
  __shared__ T R2[kMaxP * kMaxP];
  __shared__ T safe[kMaxP];
  chol_from_partials(partial + static_cast<long long>(L.p_g2()) * nparts,
                     nparts, NP, g, R2, safe);
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    T* phib = sc + L.phib();
    blk::chol2_product(R2, sc + L.r1(), NP, phib);
    T bsq = T(0);
    for (int j = 0; j < NP * NP; ++j) {
      sc[L.psi() + j] = T(0);
      bsq = bsq + phib[j] * phib[j];
    }
    for (int a = 0; a < 2 * NP; ++a) {
      for (int b = 0; b < 2 * NP; ++b) {
        const T e = a == b ? T(1) : T(0);
        sc[L.qt2() + a * 2 * NP + b] = e;
        sc[L.qt1() + a * 2 * NP + b] = e;
      }
    }
    const T beta0 = sqrt(bsq);
    const T eps_lim = sc[ATOL] + sc[RTOL] * beta0;
    sc[EPS_LIM] = eps_lim;
    sc[RNORM] = beta0;
    for (int j = 0; j < NST; ++j) st[j] = 0;
    st[STATUS] = beta0 == T(0)      ? ZERO_RESIDUAL
                 : beta0 <= eps_lim ? SOLVED
                                    : RUNNING;
  }
  for (long long i = first_row(); i < n; i += row_stride()) {
    T w[NP];
#pragma unroll
    for (int b = 0; b < NP; ++b) w[b] = col(work, 0, b, NP, n)[i];
    blk::solve_row<T, NP>(w, R2, safe);
#pragma unroll
    for (int b = 0; b < NP; ++b) col(work, 0, b, NP, n)[i] = w[b];
  }
}

// The coefficients the rows of launch 4 need, and the scalar step's
// scratch (in shared memory: thread 0 alone uses it, and a local array of
// this size would be reserved for every thread of the card).
template <typename T>
struct Coef {
  T R2[kMaxP * kMaxP];
  T safe2[kMaxP];
  T gam[kMaxP * kMaxP];
  T pi[kMaxP * kMaxP];
  T lam[kMaxP * kMaxP];
  T sm[2 * kMaxP * kMaxP];    // [Phi_k; Phi-bar_{k+1}] by rows
  T tmp[2 * kMaxP * kMaxP];
  T stk[2 * kMaxP * kMaxP];
  T qtn[4 * kMaxP * kMaxP];
};

// The scalar step of iteration it in one thread (pallas_fused.py:
// 2819-2892): k.R2 holds R_2, R the new Psi; with stage, block 0's
// staging copy of the next state.  Not inlined: one copy per type serves
// the eight block widths, which keeps the build short.
template <typename T>
__device__ __noinline__ void bm_step(const T* sc, int* st, const Layout& L, int it,
                        const T* R, Coef<T>& k, T* stage) {
  const int p = L.p;
  const int q2 = 2 * p;
  const T* psi = sc + L.psi();
  const T* om = sc + L.om();
  const T* qt2 = sc + L.qt2();
  const T* qt1 = sc + L.qt1();
  const T m2 = it >= 2 ? T(1) : T(0);
  const T m3 = it >= 3 ? T(1) : T(0);
  T* sm = k.tmp;
  T* stk = k.stk;
  T* qtn = k.qtn;
  // Theta_{k-2}^T [0; Psi_k^T] -> Pi_{k-2}, Gamma-bar (:2821-2834)
  for (int r = 0; r < q2; ++r) {
    for (int c = 0; c < p; ++c) {
      T s = T(0);
      for (int t = 0; t < p; ++t) s = s + qt2[r * q2 + p + t] * psi[c * p + t];
      sm[r * p + c] = s;
    }
  }
  for (int a = 0; a < p; ++a) {
    for (int b = 0; b < p; ++b) {
      k.pi[a * p + b] = m3 * sm[a * p + b];
      stk[a * p + b] = it >= 3 ? sm[(p + a) * p + b] : psi[b * p + a];
    }
  }
  // Theta_{k-1}^T [Gamma-bar; Omega] -> Gamma_{k-1}, Lambda-bar (:2835-2850)
  for (int r = 0; r < q2; ++r) {
    for (int c = 0; c < p; ++c) {
      T s = T(0);
      for (int t = 0; t < p; ++t) {
        s = s + qt1[r * q2 + t] * stk[t * p + c];
        s = s + qt1[r * q2 + p + t] * om[t * p + c];
      }
      sm[r * p + c] = s;
    }
  }
  for (int a = 0; a < p; ++a) {
    for (int b = 0; b < p; ++b) {
      k.gam[a * p + b] = m2 * sm[a * p + b];
      k.lam[a * p + b] = it >= 2 ? sm[(p + a) * p + b] : om[a * p + b];
    }
  }
  // Theta_k: the Givens QR of [Lambda-bar; Psi_{k+1}] (:2856-2882)
  for (int a = 0; a < p; ++a) {
    for (int b = 0; b < p; ++b) {
      stk[a * p + b] = k.lam[a * p + b];
      stk[(p + a) * p + b] = R[a * p + b];
    }
  }
  for (int a = 0; a < q2; ++a) {
    for (int b = 0; b < q2; ++b) qtn[a * q2 + b] = a == b ? T(1) : T(0);
  }
  for (int j = 0; j < p; ++j) {
    for (int r = q2 - 1; r > j; --r) {
      T ch, sh, rr;
      sym_givens(stk[(r - 1) * p + j], stk[r * p + j], ch, sh, rr);
      stk[(r - 1) * p + j] = rr;
      stk[r * p + j] = T(0);
      for (int c = j + 1; c < p; ++c) {
        const T u = stk[(r - 1) * p + c];
        const T v = stk[r * p + c];
        stk[(r - 1) * p + c] = ch * u + sh * v;
        stk[r * p + c] = sh * u - ch * v;
      }
      for (int c = 0; c < q2; ++c) {
        const T u = qtn[(r - 1) * q2 + c];
        const T v = qtn[r * q2 + c];
        qtn[(r - 1) * q2 + c] = ch * u + sh * v;
        qtn[r * q2 + c] = sh * u - ch * v;
      }
    }
  }
  for (int j = 0; j < p * p; ++j) k.lam[j] = stk[j];
  // [Phi_k; Phi-bar_{k+1}] = Theta_k [Phi-bar_k; 0] (:2885-2891)
  const T* phib = sc + L.phib();
  for (int r = 0; r < q2; ++r) {
    for (int c = 0; c < p; ++c) {
      T s = T(0);
      for (int t = 0; t < p; ++t) s = s + qtn[r * q2 + t] * phib[t * p + c];
      k.sm[r * p + c] = s;
    }
  }
  if (stage == nullptr) return;
  // the next state (:2919-2941)
  T rsq = T(0);
  for (int a = 0; a < p; ++a) {
    for (int b = 0; b < p; ++b) {
      const T v = k.sm[(p + a) * p + b];
      stage[L.phib() - RNORM + a * p + b] = v;
      stage[L.psi() - RNORM + a * p + b] = R[a * p + b];
      rsq = rsq + v * v;
    }
  }
  for (int j = 0; j < q2 * q2; ++j) {
    stage[L.qt2() - RNORM + j] = qt1[j];
    stage[L.qt1() - RNORM + j] = qtn[j];
  }
  const T rnorm = sqrt(rsq);
  stage[0] = rnorm;
  const bool solved = rnorm <= sc[EPS_LIM] || rnorm + T(1) <= T(1);
  st[S_STATUS] = solved ? SOLVED : RUNNING;
}

// 4. The second Cholesky, Psi_{k+1}, the scalar step (thread 0 of every
// block, block 0 staging); V_{k+1}, W~_k and X row by row.
template <typename T, int NP>
__global__ void __launch_bounds__(kThreads)
bm_update(T* __restrict__ work, const T* __restrict__ partial, T* sc,
          int* st, long long n) {
  if (!st[GO]) return;
  const Layout L{NP};
  const int it0 = st[IT];
  const int nparts = gridDim.x;
  __shared__ T g[ntri(kMaxP)];
  __shared__ Coef<T> k;
  __shared__ T R[kMaxP * kMaxP];
  chol_from_partials(partial + static_cast<long long>(L.p_g2()) * nparts,
                     nparts, NP, g, k.R2, k.safe2);
  if (threadIdx.x == 0) {
    blk::chol2_product(k.R2, sc + L.r1(), NP, R);
    bm_step(sc, st, L, it0 + 1, R, k,
            blockIdx.x == 0 ? sc + L.stage(RNORM) : nullptr);
  }
  __syncthreads();
  const int cur = vslot(it0, 0);
  const int nxt = vslot(it0, 1);
  const int w_old = 3 + it0 % 2;         // W~_{k-2}, overwritten by W~_k
  const int w_mid = 3 + (it0 + 1) % 2;   // W~_{k-1}
  for (long long i = first_row(); i < n; i += row_stride()) {
    T w[NP];
#pragma unroll
    for (int b = 0; b < NP; ++b) w[b] = col(work, nxt, b, NP, n)[i];
    blk::solve_row<T, NP>(w, k.R2, k.safe2);
#pragma unroll
    for (int b = 0; b < NP; ++b) col(work, nxt, b, NP, n)[i] = w[b];
    T wm1[NP];
    T wm2[NP];
    T wt[NP];
#pragma unroll
    for (int a = 0; a < NP; ++a) {
      wm1[a] = col(work, w_mid, a, NP, n)[i];
      wm2[a] = col(work, w_old, a, NP, n)[i];
    }
#pragma unroll
    for (int j = 0; j < NP; ++j) {
      T v = col(work, cur, j, NP, n)[i];
#pragma unroll
      for (int a = 0; a < NP; ++a) {
        v = v - k.gam[a * NP + j] * wm1[a];
        v = v - k.pi[a * NP + j] * wm2[a];
      }
#pragma unroll
      for (int t = 0; t < j; ++t) v = v - k.lam[t * NP + j] * wt[t];
      const T dj = k.lam[j * NP + j];
      wt[j] = v / (dj == T(0) ? T(1) : dj);
      col(work, w_old, j, NP, n)[i] = wt[j];
    }
#pragma unroll
    for (int b = 0; b < NP; ++b) {
      T* x = col(work, 5, b, NP, n);
      T xb = x[i];
#pragma unroll
      for (int t = 0; t < NP; ++t) xb = xb + k.sm[t * NP + b] * wt[t];
      x[i] = xb;
    }
  }
}

// 5. The staged state, and the iteration count.
template <typename T>
__global__ void __launch_bounds__(128)
bm_commit(T* sc, int* st, int p) {
  if (!st[GO]) return;
  const Layout L{p};
  for (int j = RNORM + threadIdx.x; j < L.state_end(); j += blockDim.x) {
    sc[j] = sc[L.stage(j)];
  }
  if (threadIdx.x == 0) {
    st[STATUS] = st[S_STATUS];
    st[IT] += 1;
  }
}

template <typename T, int NP>
int init_p(const void* Bt, void* work_, void* partial_, void* sc_, void* st_,
           long long n, int grid, cudaStream_t s) {
  T* work = static_cast<T*>(work_);
  T* partial = static_cast<T*>(partial_);
  T* sc = static_cast<T*>(sc_);
  int* st = static_cast<int*>(st_);
  bm_init_copy<T, NP><<<grid, kThreads, 0, s>>>(static_cast<const T*>(Bt),
                                                work, partial, n);
  bm_chol<T, NP><<<grid, kThreads, 0, s>>>(work, partial, sc, st, n, 1);
  bm_init_finish<T, NP><<<grid, kThreads, 0, s>>>(work, partial, sc, st, n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename P, int NP>
int iterate_p(const void* pd, const void* offsets, int nd, void* work_,
              void* partial_, void* sc_, void* st_, long long n, int grid,
              int iters, int cap, cudaStream_t s) {
  T* work = static_cast<T*>(work_);
  T* partial = static_cast<T*>(partial_);
  T* sc = static_cast<T*>(sc_);
  int* st = static_cast<int*>(st_);
  for (int j = 0; j < iters; ++j) {
    bm_stencil<T, P, NP><<<grid, kThreads, 0, s>>>(
        static_cast<const P*>(pd), static_cast<const long long*>(offsets), nd,
        work, partial, st, n, cap);
    bm_orth<T, NP><<<grid, kThreads, 0, s>>>(work, partial, sc, st, n);
    bm_chol<T, NP><<<grid, kThreads, 0, s>>>(work, partial, sc, st, n, 0);
    bm_update<T, NP><<<grid, kThreads, 0, s>>>(work, partial, sc, st, n);
    bm_commit<T><<<1, 128, 0, s>>>(sc, st, NP);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int init(const void* Bt, void* work, void* partial, void* sc, void* st,
         long long n, int grid, int p, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (p) {
    case 1: return init_p<T, 1>(Bt, work, partial, sc, st, n, grid, s);
    case 2: return init_p<T, 2>(Bt, work, partial, sc, st, n, grid, s);
    case 3: return init_p<T, 3>(Bt, work, partial, sc, st, n, grid, s);
    case 4: return init_p<T, 4>(Bt, work, partial, sc, st, n, grid, s);
    case 5: return init_p<T, 5>(Bt, work, partial, sc, st, n, grid, s);
    case 6: return init_p<T, 6>(Bt, work, partial, sc, st, n, grid, s);
    case 7: return init_p<T, 7>(Bt, work, partial, sc, st, n, grid, s);
    case 8: return init_p<T, 8>(Bt, work, partial, sc, st, n, grid, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T, typename P>
int iterate(const void* pd, const void* offsets, int nd, void* work,
            void* partial, void* sc, void* st, long long n, int grid, int p,
            int iters, int cap, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define KTT_BM_CASE(NP)                                                       \
  case NP:                                                                    \
    return iterate_p<T, P, NP>(pd, offsets, nd, work, partial, sc, st, n,     \
                               grid, iters, cap, s);
  switch (p) {
    KTT_BM_CASE(1)
    KTT_BM_CASE(2)
    KTT_BM_CASE(3)
    KTT_BM_CASE(4)
    KTT_BM_CASE(5)
    KTT_BM_CASE(6)
    KTT_BM_CASE(7)
    KTT_BM_CASE(8)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef KTT_BM_CASE
}

}  // namespace

#define KTT_BM_INIT(NAME, T)                                                  \
  extern "C" int NAME(const void* Bt, void* work, void* partial, void* sc,   \
                      void* st, long long n, int grid, int p,                \
                      void* stream) {                                        \
    return init<T>(Bt, work, partial, sc, st, n, grid, p, stream);           \
  }
#define KTT_BM_ITERATE(NAME, T, P)                                            \
  extern "C" int NAME(const void* pd, const void* offsets, int nd,           \
                      void* work, void* partial, void* sc, void* st,         \
                      long long n, int grid, int p, int iters, int cap,      \
                      void* stream) {                                        \
    return iterate<T, P>(pd, offsets, nd, work, partial, sc, st, n, grid, p, \
                         iters, cap, stream);                                \
  }
