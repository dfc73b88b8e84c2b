// Whole restarted GMRES(mem) solve of A x = b for a DIA matrix, M = N = I,
// on Hopper (sm_90a), with no grid-wide barrier: the method's launches and
// the C entry points' macros, instantiated by gmres_dia.cu (a Krylov panel
// in b's type), gmres_dia_bf16.cu and gmres_dia_f16.cu (compressed
// panels), which compile side by side.
//
// Replaces the TPU kernel krylov_tpu/ops/pallas_fused.py:1922
// gmres_dia_fused and computes what it computes (pallas_fused.py:
// 1956-2136): MGS Arnoldi (arnoldi.cuh), the Givens QR of each Hessenberg
// column, the back substitution with its singular-pivot flag (which sets
// "inconsistent"), restarts from b - A x, and optionally a compressed
// (bf16 or f16) Krylov panel whose arithmetic stays in T: then every
// pass that meets the residual estimate recomputes b - A x, and the
// solve stops only when the true residual confirms the tolerance or a
// confirmed pass stopped halving it (the prev_tr test).  Outputs: x,
// niter, rnorm, the status code (0 running / 1 solved / 2 zero residual
// / 7 breakdown / 8 inconsistent / 100 itmax reached), the inconsistent
// flag and the number of passes.
//
// Design: the Arnoldi launches of arnoldi.cuh, and three one-block
// launches of its own, each in one thread, branch for branch as the TPU
// kernel: the column launch (||w||, the k previous rotations applied to
// h, sym_givens of (h_k, ||w||), column k of R, zz and the residual
// estimate |zz_{k+1}|), the back substitution (row by row from the
// bottom, a pivot of modulus <= eps^(3/4), passed from the host, giving
// y_i = 0) and the restart launch (||b - A x||, the status chain of
// pallas_fused.py:2112-2124).  Bounds are in arnoldi.cuh.
#pragma once

#include "arnoldi.cuh"

namespace {

using namespace arnoldi;

constexpr int BREAKDOWN = 7;
constexpr int INCONSISTENT = 8;

// ||w||, the rotations and the residual estimate of column k.
template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
gm_column(const T* __restrict__ ww, int nparts, T* sc, int* st,
          int mem) {
  if (!st[GO]) return;
  const int k = st[K];
  const T wnorm2 = ktt::sum_partials(ww, nparts);
  if (threadIdx.x != 0) return;
  const T hbis = sqrt(wnorm2);
  T* h = sc + h_at(mem);
  T* c = sc + c_at(mem);
  T* s = sc + s_at(mem);
  T* zz = sc + zz_at(mem);
  T* R = sc + r_at(mem);
  for (int i = 0; i < k; ++i) {
    const T hi = h[i];
    const T hi1 = h[i + 1];
    h[i] = c[i] * hi + s[i] * hi1;
    h[i + 1] = s[i] * hi - c[i] * hi1;
  }
  T ck, sk, rkk;
  ktt::sym_givens(h[k], hbis, ck, sk, rkk);
  c[k] = ck;
  s[k] = sk;
  h[k] = rkk;
  for (int i = 0; i <= k; ++i) R[static_cast<long long>(i) * mem + k] = h[i];
  const T zeta_next = sk * zz[k];
  zz[k] = ck * zz[k];
  zz[k + 1] = zeta_next;
  end_column(sc, st, k, hbis, static_cast<T>(fabs(zeta_next)), mem);
}

// R[:kk, :kk] y = zz[:kk]; a pivot of modulus <= btol gives y_i = 0 and
// sets SING.
template <typename T>
__global__ void gm_backsub(T* sc, int* st, int mem) {
  if (st[STAGE] != S_BACKSUB || threadIdx.x != 0) return;
  const int kk = st[KK];
  const T btol = sc[BTOL];
  const T* zz = sc + zz_at(mem);
  const T* R = sc + r_at(mem);
  T* y = sc + y_at(mem);
  int sing = 0;
  for (int i = kk - 1; i >= 0; --i) {
    const T* row = R + static_cast<long long>(i) * mem;
    T acc = zz[i];
    for (int j = i + 1; j < kk; ++j) acc = acc - row[j] * y[j];
    const T diag = row[i];
    const bool s = fabs(diag) <= btol;
    y[i] = s ? T(0) : acc / diag;
    sing |= s ? 1 : 0;
  }
  st[SING] = sing;
  st[STAGE] = S_XACC;
}

// ||b - A x||, the confirm test and the status chain; the next pass or
// the stop.
template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
gm_restart(const T* __restrict__ partial, int nparts, T* sc, int* st,
           int mem, int confirm) {
  if (st[STAGE] != S_XACC) return;
  const int flags = st[FLAGS];
  const bool resid = flags & F_RESID;
  const bool brk = flags & F_BREAK;
  const bool tired = flags & F_TIRED;
  const bool restart = confirm || !(resid || brk || tired);
  const T rr = restart ? ktt::sum_partials(partial, nparts) : T(0);
  if (threadIdx.x != 0) return;
  T tmp = sc[RNORM];
  bool confirmed = false;
  if (restart) {
    const T beta_r = sqrt(rr);
    sc[zz_at(mem)] = beta_r;
    sc[BETA_R] = beta_r;
    tmp = beta_r;
    confirmed = beta_r <= sc[EPS_LIM] || (beta_r + T(1)) <= T(1);
  }
  bool final = resid;
  if (confirm) {
    final = resid && (confirmed || tmp > T(0.5) * sc[PREV_TR]);
    if (resid && !final) sc[PREV_TR] = tmp;
  }
  const bool glob_final = final || brk || tired;
  const int incons = st[INCONS] | st[SING];
  int code = BREAKDOWN;
  if (tired) code = TIRED;
  if (final) code = SOLVED;
  if (incons) code = INCONSISTENT;
  st[INCONS] = incons;
  st[STATUS] = glob_final ? code : RUNNING;
  if (!glob_final) {
    st[NPASS] += 1;
    sc[RNORM] = tmp;
  }
  st[K] = 0;
  st[STAGE] = glob_final ? S_NONE : S_RESTARTED;
}

struct Gmres {
  template <typename T>
  static void column(T* ww, int grid, T* sc, int* st, int mem,
                     cudaStream_t s) {
    gm_column<T><<<1, kReduceThreads, 0, s>>>(ww, grid, sc, st, mem);
  }
  template <typename T>
  static void backsub(T* sc, int* st, int mem, cudaStream_t s) {
    gm_backsub<T><<<1, 32, 0, s>>>(sc, st, mem);
  }
  template <typename T>
  static void restart(T* partial, int grid, T* sc, int* st, int mem,
                      int confirm, cudaStream_t s) {
    gm_restart<T><<<1, kReduceThreads, 0, s>>>(partial, grid, sc, st, mem,
                                              confirm);
  }
};

}  // namespace

#define KTT_GMRES_INIT(NAME, T, BT)                                           \
  extern "C" int NAME(const void* b, void* V, void* x, void* partial,        \
                      void* sc, void* st, long long n, int grid, int mem,    \
                      int itmax, void* stream) {                             \
    return arnoldi::init<T, BT>(b, V, x, partial, sc, st, n, grid, mem,      \
                                itmax, stream);                              \
  }

#define KTT_GMRES_ITERATE(NAME, T, P, BT)                                     \
  extern "C" int NAME(const void* pd, const void* offsets, int nd,           \
                      long long lo, long long hi, const void* b, void* w,    \
                      void* V, void* x, void* partial, void* sc, void* st,   \
                      long long n, int grid, int mem, int confirm,           \
                      int iters, int cap, void* stream) {                    \
    return arnoldi::iterate<T, P, BT, Gmres>(pd, offsets, nd, lo, hi, b, w,  \
                                             V, x, partial, sc, st, n, grid, \
                                             mem, confirm, iters, cap,       \
                                             stream);                        \
  }
