// Whole DIOM or DQGMRES solve of A x = b for a DIA matrix, M = N = I, on
// Hopper (sm_90a), with no grid-wide barrier.
//
// Replaces the TPU kernel krylov_tpu/ops/pallas_fused.py:5160
// trunc_dia_fused and computes what it computes (pallas_fused.py:
// 5185-5350), for variant "diom" (truncated FOM: LU pivots in a ring of
// mem - 1, P ring of mem - 1) and "dqgmres" (truncated GMRES: Givens
// rotations in rings of mem, P ring of mem): x, niter, rnorm and the
// status code (0 running / 1 solved / 2 zero residual).
//
// Bound on an H100 SXM: memory bandwidth.  An iteration must read the
// diagonals once (28 B per row at 7 f32 diagonals), each of the mem
// basis vectors of the window and the mP directions once, x once, and
// write w's normalisation v_{k+1}, the new direction and x: at memory 20
// (28 + 80 + 80 + 4 + 12) B per row for DQGMRES in f32.
//
// Design.  Each iteration is a fixed sequence of five launches on the
// caller's stream, with no block waiting on another:
//   1. tr_stencil (grid)     GO, w = A v_k (v_k = V[k mod mem]), and the
//                            block partials of <v_j, w> for every ring
//                            slot j, all against the unmodified w
//                            (window classical Gram-Schmidt, pallas_fused
//                            .py:5233-5247)
//   2. tr_dots    (1 block)  h_j = the sums of those partials in a fixed
//                            order, zero for a slot not yet filled
//   3. tr_sub     (grid)     w -= h_j v_j for j = 0 .. mem - 1 in order,
//                            partials of <w, w>
//   4. tr_column  (1 block)  ||w||, the diagonal-indexed Hessenberg
//                            column, DIOM's LU pivots or DQGMRES's
//                            rotations, the P-ring coefficients, the
//                            residual estimate and the status, in one
//                            thread, branch for branch as the TPU kernel
//                            (pallas_fused.py:5248-5335)
//   5. tr_update  (grid)     p = (v_k - sum_j coef_j P_j) / denom into
//                            P[k mod mP], x += gamma p, V[(k+1) mod mem]
//                            = w / ||w|| unless ||w|| = 0
// The stencil reads the neighbours of v_k, which sits in the ring slot
// k mod mem; v_{k+1} goes to slot (k + 1) mod mem, another slot since
// mem >= 2, in launch 5, which reads no neighbours.  The init launch
// zeroes both rings: the window sums read every slot, and 0 times
// uninitialised memory can be NaN.  The scalars live on the device;
// every launch returns at once when the solve has stopped, and the host
// reads the status once per chunk of iterations.  Per iteration this
// design reads the V ring twice (launches 1 and 3): at memory 20 about
// (28 + 84) + (84 + 4) + (76 + 24) B per row in f32, 300 B for DIOM.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kReduceThreads = 1024;
// ring slots whose dots one pass over the rows accumulates at once
constexpr int kGroup = 8;

constexpr int RUNNING = 0;
constexpr int SOLVED = 1;
constexpr int ZERO_RESIDUAL = 2;

// slots of the scalar arrays; ATOL and RTOL are set by the host.  After
// the NSC fixed slots come hs (mem), H (mem + 2), L (mem), S (mem) and
// the P-ring coefficients (mem).
enum ScalarSlot {
  ATOL = 0, RTOL, EPS_LIM, RNORM, XI, HAUX, DENOM, GSTEP, NSC
};
enum IntSlot { IT = 0, STATUS, GO, K, NST };

__host__ __device__ inline long long hs_at(int) { return NSC; }
__host__ __device__ inline long long hh_at(int mem) { return NSC + mem; }
__host__ __device__ inline long long l_at(int mem) {
  return NSC + 2LL * mem + 2;
}
__host__ __device__ inline long long s_at(int mem) {
  return NSC + 3LL * mem + 2;
}
__host__ __device__ inline long long coef_at(int mem) {
  return NSC + 4LL * mem + 2;
}

// a mod m in [0, m) for m > 0, as jnp.mod
__device__ __forceinline__ int pmod(int a, int m) { return ((a % m) + m) % m; }

// x = 0, both rings = 0, partials of b'b.
template <typename T>
__global__ void __launch_bounds__(kThreads)
tr_init_dot(const T* __restrict__ b, T* __restrict__ V, T* __restrict__ P,
            T* __restrict__ x, T* __restrict__ partial, long long n, int mem,
            int mP) {
  T s = T(0);
  for (long long i = ktt::first_row(); i < n; i += ktt::row_stride()) {
    const T bi = b[i];
    x[i] = T(0);
    for (int j = 0; j < mem; ++j) V[static_cast<long long>(j) * n + i] = T(0);
    for (int j = 0; j < mP; ++j) P[static_cast<long long>(j) * n + i] = T(0);
    s += bi * bi;
  }
  ktt::store_partial(s, partial);
}

// beta0 = ||b||, eps_lim, xi = rnorm = beta0, the rings of scalars and
// the starting status.
template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
tr_init_scalars(const T* __restrict__ partial, int nparts, T* sc, int* st,
                int mem) {
  const T bb = ktt::sum_partials(partial, nparts);
  if (threadIdx.x != 0) return;
  const T beta0 = sqrt(bb);
  const T eps_lim = sc[ATOL] + sc[RTOL] * beta0;
  sc[EPS_LIM] = eps_lim;
  sc[RNORM] = beta0;
  sc[XI] = beta0;
  sc[HAUX] = T(0);
  sc[DENOM] = T(1);
  sc[GSTEP] = T(0);
  for (long long j = NSC; j < coef_at(mem) + mem; ++j) sc[j] = T(0);
  st[IT] = 0;
  st[STATUS] = beta0 == T(0) ? ZERO_RESIDUAL
               : beta0 <= eps_lim ? SOLVED : RUNNING;
  st[GO] = 0;
  st[K] = 0;
}

// V[0] = b / ||b|| (b itself when b = 0).
template <typename T>
__global__ void __launch_bounds__(kThreads)
tr_init_v0(const T* __restrict__ b, T* __restrict__ V, const T* sc,
           long long n) {
  const T d = ktt::safe(sc[RNORM]);
  for (long long i = ktt::first_row(); i < n; i += ktt::row_stride()) {
    V[i] = b[i] / d;
  }
}

// 1. Decide whether this iteration runs (GO, read by launches 2-5; K =
// the iteration's 0-based index), then w = A v_k and the partials of
// <v_j, w> for every slot j, kGroup slots per pass over the rows.
template <typename T, typename P>
__global__ void __launch_bounds__(kThreads)
tr_stencil(const P* __restrict__ pd, const long long* __restrict__ offsets,
           int nd, const T* __restrict__ V, T* __restrict__ w,
           T* __restrict__ partial, int* st, long long n, int mem, int cap) {
  const int k = st[IT];
  const bool go = st[STATUS] == RUNNING && k < cap;
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    st[GO] = go ? 1 : 0;
    st[K] = k;
  }
  if (!go) return;
  const T* vk = V + static_cast<long long>(k % mem) * n;
  for (long long i = ktt::first_row(); i < n; i += ktt::row_stride()) {
    w[i] = ktt::stencil_row(pd, offsets, nd, vk, i, n);
  }
  for (int g = 0; g < mem; g += kGroup) {
    T acc[kGroup];
#pragma unroll
    for (int jj = 0; jj < kGroup; ++jj) acc[jj] = T(0);
    for (long long i = ktt::first_row(); i < n; i += ktt::row_stride()) {
      const T wi = w[i];
#pragma unroll
      for (int jj = 0; jj < kGroup; ++jj) {
        if (g + jj < mem) {
          acc[jj] += V[static_cast<long long>(g + jj) * n + i] * wi;
        }
      }
    }
    for (int jj = 0; jj < kGroup && g + jj < mem; ++jj) {
      if (g + jj > 0) __syncthreads();
      ktt::store_partial(acc[jj],
                         partial + static_cast<long long>(g + jj) * gridDim.x);
    }
  }
}

// 2. h_j = <v_j, w> for the slots that hold a basis vector (the slot's
// index k - ((k mod mem - j) mod mem) is >= 0), 0 for the others.
template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
tr_dots(const T* __restrict__ partial, int nparts, T* sc, const int* st,
        int mem) {
  if (!st[GO]) return;
  const int k = st[K];
  const int pos = k % mem;
  T* hs = sc + hs_at(mem);
  for (int j = 0; j < mem; ++j) {
    if (j > 0) __syncthreads();
    const T h = ktt::sum_partials(partial + static_cast<long long>(j) * nparts,
                                  nparts);
    if (threadIdx.x == 0) hs[j] = k - pmod(pos - j, mem) >= 0 ? h : T(0);
  }
}

// 3. w -= h_j v_j for j = 0 .. mem - 1, in that order, and the partials
// of <w, w>.
template <typename T>
__global__ void __launch_bounds__(kThreads)
tr_sub(const T* __restrict__ V, T* __restrict__ w, T* __restrict__ partial,
       const T* sc, const int* st, long long n, int mem) {
  if (!st[GO]) return;
  const T* hs = sc + hs_at(mem);
  T s = T(0);
  for (long long i = ktt::first_row(); i < n; i += ktt::row_stride()) {
    T wi = w[i];
    for (int j = 0; j < mem; ++j) {
      wi = wi - hs[j] * V[static_cast<long long>(j) * n + i];
    }
    w[i] = wi;
    s += wi * wi;
  }
  ktt::store_partial(s, partial + static_cast<long long>(mem) * gridDim.x);
}

// 4. ||w||, the column and its recurrence, the P-ring coefficients, the
// residual estimate and the status (pallas_fused.py:5248-5335).
template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
tr_column(const T* __restrict__ partial, int nparts, T* sc, int* st,
          int mem, int mP, int diom) {
  if (!st[GO]) return;
  const T ww = ktt::sum_partials(
      partial + static_cast<long long>(mem) * nparts, nparts);
  if (threadIdx.x != 0) return;
  const T haux = sqrt(ww);
  const int k = st[K];
  const int it1 = k + 1;
  const int pos = k % mem;
  const T* hs = sc + hs_at(mem);
  T* H = sc + hh_at(mem);
  T* L = sc + l_at(mem);
  T* S = sc + s_at(mem);
  T* coef = sc + coef_at(mem);
  // the diagonal-indexed column: H[k - i + 1] holds row i
  for (int d = 0; d < mem + 2; ++d) H[d] = T(0);
  for (int j = 0; j < mem; ++j) {
    const int i_idx = k - pmod(pos - j, mem);
    if (i_idx >= 0) {
      const int diag = k - i_idx + 1;
      H[diag] = H[diag] + hs[j];
    }
  }
  T xi = sc[XI];
  T gstep, rnorm, denom;
  if (diom) {
    // LU column update (reference src/diom.jl:251-266)
    for (int i = max(2, it1 - mem + 2); i <= it1; ++i) {
      const int lslot = (i - 1) % (mem - 1);
      const int diag = it1 - i + 1;
      H[diag] = H[diag] - L[lslot] * H[diag + 1];
      if (i == it1) xi = -L[lslot] * xi;
    }
    const T safe_u = ktt::safe(H[1]);
    L[it1 % (mem - 1)] = haux / safe_u;
    gstep = xi;
    rnorm = haux * static_cast<T>(fabs(xi / safe_u));
    denom = safe_u;
  } else {
    // previous rotations (reference src/dqgmres.jl:257-266)
    for (int i = max(1, it1 - mem); i <= it1 - 1; ++i) {
      const int slot = (i - 1) % mem;
      const int diag = it1 - i;
      const T ci = L[slot];
      const T si = S[slot];
      const T hi1 = H[diag + 1];
      const T hi0 = H[diag];
      H[diag] = si * hi1 - ci * hi0;
      H[diag + 1] = ci * hi1 + si * hi0;
    }
    T ck, sk, rkk;
    ktt::sym_givens(H[1], haux, ck, sk, rkk);
    H[1] = rkk;
    L[pos] = ck;
    S[pos] = sk;
    gstep = ck * xi;
    xi = sk * xi;
    rnorm = static_cast<T>(fabs(xi));
    denom = ktt::safe(rkk);
  }
  // the P-ring coefficients: slot jp holds the direction of index iP
  const int lowP = diom ? k - mem + 1 : k - mem;
  for (int jp = 0; jp < mP; ++jp) {
    const int iP = (k - 1) - pmod((k - 1) - jp, mP);
    const bool valid = iP >= 0 && iP >= lowP && iP <= k - 1;
    coef[jp] = valid ? H[k - iP + 1] : T(0);
  }
  sc[XI] = xi;
  sc[HAUX] = haux;
  sc[DENOM] = denom;
  sc[GSTEP] = gstep;
  sc[RNORM] = rnorm;
  const bool solved = rnorm <= sc[EPS_LIM] || (rnorm + T(1)) <= T(1);
  st[IT] = it1;
  st[STATUS] = solved ? SOLVED : RUNNING;
}

// 5. p = (v_k - sum_jp coef_jp P_jp) / denom into slot k mod mP,
// x += gamma p, and v_{k+1} = w / ||w|| into slot (k + 1) mod mem unless
// ||w|| = 0 (a lucky breakdown keeps the slot).
template <typename T>
__global__ void __launch_bounds__(kThreads)
tr_update(T* __restrict__ V, T* __restrict__ Pr, T* __restrict__ x,
          const T* __restrict__ w, const T* sc, const int* st, long long n,
          int mem, int mP) {
  if (!st[GO]) return;
  const int k = st[K];
  const T* coef = sc + coef_at(mem);
  const T denom = sc[DENOM];
  const T gstep = sc[GSTEP];
  const T haux = sc[HAUX];
  const T* vk = V + static_cast<long long>(k % mem) * n;
  T* pnew = Pr + static_cast<long long>(k % mP) * n;
  T* vnext = V + static_cast<long long>((k + 1) % mem) * n;
  for (long long i = ktt::first_row(); i < n; i += ktt::row_stride()) {
    T acc = T(0);
    for (int jp = 0; jp < mP; ++jp) {
      acc = acc + coef[jp] * Pr[static_cast<long long>(jp) * n + i];
    }
    const T p = (vk[i] - acc) / denom;
    pnew[i] = p;
    x[i] = x[i] + gstep * p;
    if (haux != T(0)) vnext[i] = w[i] / haux;
  }
}

template <typename T>
int init(const void* b_, void* V_, void* P_, void* x_, void* partial_,
         void* sc_, void* st_, long long n, int grid, int mem, int mP,
         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* b = static_cast<const T*>(b_);
  T* V = static_cast<T*>(V_);
  T* partial = static_cast<T*>(partial_);
  T* sc = static_cast<T*>(sc_);
  tr_init_dot<T><<<grid, kThreads, 0, s>>>(b, V, static_cast<T*>(P_),
                                           static_cast<T*>(x_), partial, n,
                                           mem, mP);
  tr_init_scalars<T><<<1, kReduceThreads, 0, s>>>(partial, grid, sc,
                                                  static_cast<int*>(st_), mem);
  tr_init_v0<T><<<grid, kThreads, 0, s>>>(b, V, sc, n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename P>
int iterate(const void* pd, const void* offsets, int nd, void* w_, void* V_,
            void* P_, void* x_, void* partial_, void* sc_, void* st_,
            long long n, int grid, int mem, int mP, int diom, int iters,
            int cap, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const P* A = static_cast<const P*>(pd);
  const long long* offs = static_cast<const long long*>(offsets);
  T* w = static_cast<T*>(w_);
  T* V = static_cast<T*>(V_);
  T* Pr = static_cast<T*>(P_);
  T* x = static_cast<T*>(x_);
  T* partial = static_cast<T*>(partial_);
  T* sc = static_cast<T*>(sc_);
  int* st = static_cast<int*>(st_);
  for (int j = 0; j < iters; ++j) {
    tr_stencil<T, P><<<grid, kThreads, 0, s>>>(A, offs, nd, V, w, partial, st,
                                               n, mem, cap);
    tr_dots<T><<<1, kReduceThreads, 0, s>>>(partial, grid, sc, st, mem);
    tr_sub<T><<<grid, kThreads, 0, s>>>(V, w, partial, sc, st, n, mem);
    tr_column<T><<<1, kReduceThreads, 0, s>>>(partial, grid, sc, st, mem, mP,
                                              diom);
    tr_update<T><<<grid, kThreads, 0, s>>>(V, Pr, x, w, sc, st, n, mem, mP);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define KTT_TR_INIT(NAME, T)                                                  \
  extern "C" int NAME(const void* b, void* V, void* P, void* x,              \
                      void* partial, void* sc, void* st, long long n,        \
                      int grid, int mem, int mP, void* stream) {             \
    return init<T>(b, V, P, x, partial, sc, st, n, grid, mem, mP, stream);   \
  }

#define KTT_TR_ITERATE(NAME, T, P)                                            \
  extern "C" int NAME(const void* pd, const void* offsets, int nd, void* w,  \
                      void* V, void* Pr, void* x, void* partial, void* sc,   \
                      void* st, long long n, int grid, int mem, int mP,      \
                      int diom, int iters, int cap, void* stream) {          \
    return iterate<T, P>(pd, offsets, nd, w, V, Pr, x, partial, sc, st, n,   \
                         grid, mem, mP, diom, iters, cap, stream);           \
  }

KTT_TR_INIT(ktt_trunc_dia_init_f32, float)
KTT_TR_INIT(ktt_trunc_dia_init_f64, double)
KTT_TR_ITERATE(ktt_trunc_dia_iterate_f32_f32, float, float)
KTT_TR_ITERATE(ktt_trunc_dia_iterate_f32_bf16, float, __nv_bfloat16)
KTT_TR_ITERATE(ktt_trunc_dia_iterate_f32_f16, float, __half)
KTT_TR_ITERATE(ktt_trunc_dia_iterate_f64_f64, double, double)
