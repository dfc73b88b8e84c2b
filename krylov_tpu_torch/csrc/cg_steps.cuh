// The launches that CG (cg_dia.cu) and Chebyshev-preconditioned CG
// (cg_cheby_dia.cu) share: the scalar state's layout, its start, the
// stencil with p'ap partials, and the two one-block scalar steps.  Each
// file that includes this gets its own copy of the kernels.
#pragma once

#include "common.cuh"

namespace {

constexpr int kThreads = 256;        // vector launches
constexpr int kReduceThreads = 1024; // the one-block scalar launches

constexpr int RUNNING = 0;
constexpr int SOLVED = 1;
constexpr int ZERO_RESIDUAL = 2;
constexpr int ZERO_CURVATURE = 5;

// slots of the scalar arrays
enum ScalarSlot { GAMMA = 0, PNORM2, RNORM, EPS_LIM, A_EFF, CR, CP, NSC };
enum IntSlot { IT = 0, STATUS, VIOL, GO, SKIP, NST };

// gamma0 = b'z0 from the partials, rnorm0, eps_lim and the starting status.
template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
cg_init_scalars(const T* __restrict__ partial, int nparts, T* sc, int* st,
                double atol, double rtol) {
  const T gamma0 = ktt::sum_partials(partial, nparts);
  if (threadIdx.x != 0) return;
  const T rnorm0 = sqrt(gamma0 > T(0) ? gamma0 : T(0));
  const T eps_lim = static_cast<T>(atol) + static_cast<T>(rtol) * rnorm0;
  sc[GAMMA] = gamma0;
  sc[PNORM2] = gamma0;
  sc[RNORM] = rnorm0;
  sc[EPS_LIM] = eps_lim;
  sc[A_EFF] = T(0);
  sc[CR] = T(0);
  sc[CP] = T(1);
  st[IT] = 0;
  st[STATUS] = gamma0 == T(0) ? ZERO_RESIDUAL
               : (rnorm0 <= eps_lim ? SOLVED : RUNNING);
  st[VIOL] = gamma0 < T(0) ? 1 : 0;
  st[GO] = 0;
  st[SKIP] = 0;
}

// ap = A p and per-block partials of p'ap.  Reads the status and it that
// the previous iteration's cg_beta wrote.
template <typename T, typename P>
__global__ void __launch_bounds__(kThreads)
cg_stencil(const P* __restrict__ pd, const long long* __restrict__ offsets,
           int nd, const T* __restrict__ p, T* __restrict__ ap,
           T* __restrict__ partial, const int* st, long long n, int cap) {
  if (!(st[STATUS] == RUNNING && st[IT] < cap)) return;
  T s = T(0);
  for (long long i = ktt::first_row(); i < n; i += ktt::row_stride()) {
    const T acc = ktt::stencil_row(pd, offsets, nd, p, i, n);
    ap[i] = acc;
    s += p[i] * acc;
  }
  ktt::store_partial(s, partial);
}

// Decide whether this iteration runs (GO, read by the later launches),
// then alpha and the zero-curvature skip (reference src/cg.jl:198-211
// with linesearch = false, radius = 0).
template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
cg_alpha(const T* __restrict__ partial, int nparts, T* sc, int* st, int cap) {
  const bool go = st[STATUS] == RUNNING && st[IT] < cap;
  if (!go) {
    if (threadIdx.x == 0) st[GO] = 0;
    return;
  }
  const T pAp = ktt::sum_partials(partial, nparts);
  if (threadIdx.x != 0) return;
  const T eps = ktt::eps_of<T>();
  const T pNorm2 = sc[PNORM2];
  const bool curv_small = pAp <= eps * pNorm2;
  const bool zero_curv = curv_small && fabs(pAp) <= eps * pNorm2;
  const T alpha = sc[GAMMA] / (pAp == T(0) ? T(1) : pAp);
  sc[A_EFF] = zero_curv ? T(0) : alpha;
  st[SKIP] = zero_curv ? 1 : 0;
  st[GO] = 1;
}

// gamma = r'z from the partials, beta, the stopping tests, status and it.
template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
cg_beta(const T* __restrict__ partial, int nparts, T* sc, int* st) {
  if (!st[GO]) return;
  const T gamma_next = ktt::sum_partials(partial, nparts);
  if (threadIdx.x != 0) return;
  const bool skip = st[SKIP] != 0;
  const T gamma = sc[GAMMA];
  const T pNorm2 = sc[PNORM2];
  if (gamma_next < T(0)) st[VIOL] = 1;
  const T rnorm_next = sqrt(gamma_next > T(0) ? gamma_next : T(0));
  const bool resid_mach = (rnorm_next + T(1)) <= T(1);
  const bool solved = rnorm_next <= sc[EPS_LIM] || resid_mach;
  const T beta = gamma_next / (gamma == T(0) ? T(1) : gamma);
  const bool stay = !(solved || skip);
  sc[CR] = stay ? T(1) : T(0);
  sc[CP] = stay ? beta : T(1);
  sc[GAMMA] = stay ? gamma_next : gamma;
  sc[PNORM2] = stay ? gamma_next + beta * beta * pNorm2 : pNorm2;
  if (!skip) sc[RNORM] = rnorm_next;
  st[IT] += skip ? 0 : 1;
  st[STATUS] = skip ? ZERO_CURVATURE : (solved ? SOLVED : RUNNING);
}

}  // namespace
