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
// Design.  Each iteration is a fixed sequence of four launches on the
// caller's stream, with no block waiting on another:
//   1. tr_stencil (grid)     GO, w = A v_k (v_k = V[k mod mem]) on
//                            dia_spmv.cu's wide rows (common.cuh
//                            dia_rows: R = 16 / sizeof(pd element) rows
//                            a thread, 16-byte loads of pd, of the rings
//                            and of w, the offsets in shared memory), w
//                            written once and kept in registers for the
//                            block partials of <v_j, w> for every ring
//                            slot j, all against the unmodified w
//                            (window classical Gram-Schmidt, pallas_fused
//                            .py:5233-5247): the first kReg slots'
//                            sums in registers, the others' summed over
//                            each warp into a global scratch of one
//                            value a warp and slot, so any memory has a
//                            kernel
//   2. tr_sub     (grid)     h_j = the sums of those partials in a fixed
//                            order, the same in every block, zero for a
//                            slot not yet filled (block 0 stores them for
//                            launch 3); w -= h_j v_j for j = 0 .. mem - 1
//                            in order, h in shared memory kChunk slots at
//                            a time (w stored between chunks, which keeps
//                            its bits); partials of <w, w>
//   3. tr_column  (1 block)  ||w||, the diagonal-indexed Hessenberg
//                            column, DIOM's LU pivots or DQGMRES's
//                            rotations, the P-ring coefficients, the
//                            residual estimate and the status, in one
//                            thread on a shared-memory copy of those
//                            rings (in place in global memory past
//                            kSmemMax), branch for branch as the TPU
//                            kernel (pallas_fused.py:5248-5335)
//   4. tr_update  (grid)     p = (v_k - sum_j coef_j P_j) / denom into
//                            P[k mod mP], the coefficients in shared
//                            memory (read in place past kSmemMax),
//                            x += gamma p, V[(k+1) mod mem] = w / ||w||
//                            unless ||w|| = 0
// The stencil reads the neighbours of v_k, which sits in the ring slot
// k mod mem; v_{k+1} goes to slot (k + 1) mod mem, another slot since
// mem >= 2, in launch 4, which reads no neighbours.  The init launch
// zeroes both rings: the window sums read every slot, and 0 times
// uninitialised memory can be NaN.  The scalars live on the device;
// every launch returns at once when the solve has stopped, and the host
// reads the status once per chunk of iterations.  The grid launches walk
// their rows R at a time, a grid stride apart, over a grid of a few
// blocks per SM, so launch 2 sums mem x grid partials in each block.
// Reading the V ring twice (launches 1 and 2) is the price of the
// window's classical Gram-Schmidt without a grid barrier.  Bytes per row
// at memory 20 in f32: (28 + 80 + 4) + (8 + 80) + (80 + 28) = 308 for
// DQGMRES, 304 for DIOM (P ring of 19).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kReduceThreads = 1024;
// ring slots whose window dots launch 1 sums in registers
constexpr int kReg = 24;
// the window dots launch 2 holds in shared memory at a time
constexpr int kChunk = 512;
// the dynamic shared memory a launch takes at most, well inside the
// 48 KB a launch may take without an opt-in beside its static arrays;
// past it launches 3 and 4 work on the scalar array in place
constexpr size_t kSmemMax = 32 * 1024;

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

// 1. Decide whether this iteration runs (GO, read by launches 2-4; K =
// the iteration's 0-based index), then w = A v_k and the partials of
// <v_j, w> for every slot j at partial[j grid + block].  Rows past n
// count as zeros.  For mem > kReg, slot kReg + j's sum over warp w of
// block b is built at warp_sums[(j grid + b) kWarps + w], by that warp's
// lane 0 alone, and the block adds its warps' sums in order.
template <typename T, typename P, bool VEC>
__global__ void __launch_bounds__(kThreads)
tr_stencil(const P* __restrict__ pd, const long long* __restrict__ offsets,
           int nd, long long lo, long long hi, const T* __restrict__ V,
           T* __restrict__ w, T* __restrict__ partial, T* warp_sums, int* st,
           long long n, int mem, int cap) {
  constexpr int R = ktt::rows_per_thread<P>();
  const int k = st[IT];
  const bool go = st[STATUS] == RUNNING && k < cap;
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    st[GO] = go ? 1 : 0;
    st[K] = k;
  }
  if (!go) return;
  __shared__ long long offs[ktt::kDiaTile];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // this warp's sums of the slots past kReg, a stride of grid kWarps
  T* my_sums = warp_sums + static_cast<long long>(blockIdx.x) * kWarps + warp;
  const long long sum_stride = static_cast<long long>(gridDim.x) * kWarps;
  if (nd <= ktt::kDiaTile) ktt::stage_offsets(offs, offsets, nd);
  if (lane == 0) {
    for (int j = kReg; j < mem; ++j) my_sums[(j - kReg) * sum_stride] = T(0);
  }
  __syncthreads();
  const T* vk = V + static_cast<long long>(k % mem) * n;
  T acc[kReg];
#pragma unroll
  for (int j = 0; j < kReg; ++j) acc[j] = T(0);
  for (long long i0 = ktt::first_rows<R>(); i0 - threadIdx.x * R < n;
       i0 += ktt::rows_stride<R>()) {
    const long long left = n - i0;
    T wv[R];
#pragma unroll
    for (int r = 0; r < R; ++r) wv[r] = T(0);
    ktt::dia_rows<R, VEC>(pd, offsets, nd, offs, vk, i0, n, lo, hi, VEC, wv);
    if (left > 0) ktt::store_rows<VEC>(w + i0, left, wv);
#pragma unroll
    for (int j = 0; j < kReg; ++j) {
      if (j < mem && left > 0) {
        T vv[R];
        ktt::load_rows<VEC>(V + static_cast<long long>(j) * n + i0, left, vv);
#pragma unroll
        for (int r = 0; r < R; ++r) acc[j] += vv[r] * wv[r];
      }
    }
    for (int j = kReg; j < mem; ++j) {
      T s = T(0);
      if (left > 0) {
        T vv[R];
        ktt::load_rows<VEC>(V + static_cast<long long>(j) * n + i0, left, vv);
#pragma unroll
        for (int r = 0; r < R; ++r) s += vv[r] * wv[r];
      }
      for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
      if (lane == 0) my_sums[(j - kReg) * sum_stride] += s;
    }
  }
  ktt::block_sums<T, kReg>(acc, partial, gridDim.x, min(mem, kReg));
  // every warp's sums are written and visible to the block
  __syncthreads();
  for (int j = kReg + threadIdx.x; j < mem; j += kThreads) {
    const T* sums = warp_sums + (j - kReg) * sum_stride
        + static_cast<long long>(blockIdx.x) * kWarps;
    T s = T(0);
    for (int v = 0; v < kWarps; ++v) s += sums[v];
    partial[static_cast<long long>(j) * gridDim.x + blockIdx.x] = s;
  }
}

// 2. h_j = <v_j, w> for the slots that hold a basis vector (the slot's
// index k - ((k mod mem - j) mod mem) is >= 0), 0 for the others, summed
// in every block (block 0 stores them); w -= h_j v_j for j = 0 .. mem - 1,
// in that order, and the partials of <w, w>.  The block holds kChunk of
// the h_j in shared memory at a time; past the first chunk, w goes
// through memory between chunks, where it keeps its bits.
template <typename T, int R, bool VEC>
__global__ void __launch_bounds__(kThreads)
tr_sub(const T* __restrict__ V, T* __restrict__ w, T* __restrict__ partial,
       T* sc, const int* st, long long n, int mem) {
  if (!st[GO]) return;
  __shared__ T hs[kChunk];
  const int nparts = gridDim.x;
  const int k = st[K];
  const int pos = k % mem;
  T s = T(0);
  for (int j0 = 0; j0 < mem; j0 += kChunk) {
    const int count = min(kChunk, mem - j0);
    const bool last = j0 + count == mem;
    ktt::sum_partial_rows(partial + static_cast<long long>(j0) * nparts,
                          nparts, count, hs);
    if (threadIdx.x == 0) {
      for (int j = 0; j < count; ++j) {
        if (k - pmod(pos - (j0 + j), mem) < 0) hs[j] = T(0);
        if (blockIdx.x == 0) sc[hs_at(mem) + j0 + j] = hs[j];
      }
    }
    __syncthreads();
    const T* Vc = V + static_cast<long long>(j0) * n;
    for (long long i0 = ktt::first_rows<R>(); i0 < n;
         i0 += ktt::rows_stride<R>()) {
      const long long left = n - i0;
      T wv[R];
      ktt::load_rows<VEC>(w + i0, left, wv);
      for (int j = 0; j < count; ++j) {
        const T h = hs[j];
        T vv[R];
        ktt::load_rows<VEC>(Vc + static_cast<long long>(j) * n + i0, left,
                            vv);
#pragma unroll
        for (int r = 0; r < R; ++r) wv[r] = wv[r] - h * vv[r];
      }
      ktt::store_rows<VEC>(w + i0, left, wv);
      if (last) {
#pragma unroll
        for (int r = 0; r < R; ++r) s += wv[r] * wv[r];
      }
    }
    // the next chunk's sums overwrite hs
    __syncthreads();
  }
  ktt::store_partial(s, partial + static_cast<long long>(mem) * nparts);
}

// 3. ||w||, the column and its recurrence, the P-ring coefficients, the
// residual estimate and the status (pallas_fused.py:5248-5335).  With
// Staged, the block copies hs, H, L, S and the coefficients (5 mem + 2
// slots) into dynamic shared memory, one thread runs the recurrence
// there, and the block copies them back; without, the thread runs it on
// the scalar array in place.
template <typename T, bool Staged>
__global__ void __launch_bounds__(kReduceThreads)
tr_column(const T* __restrict__ partial, int nparts, T* sc, int* st,
          int mem, int mP, int diom) {
  if (!st[GO]) return;
  extern __shared__ __align__(16) unsigned char ring_mem[];
  T* ring = Staged ? reinterpret_cast<T*>(ring_mem) : sc + hs_at(mem);
  const int nring = 5 * mem + 2;
  if (Staged) {
    for (int j = threadIdx.x; j < nring; j += blockDim.x) {
      ring[j] = sc[hs_at(mem) + j];
    }
  }
  const T ww = ktt::sum_partials(
      partial + static_cast<long long>(mem) * nparts, nparts);
  if (threadIdx.x == 0) {
    const T haux = sqrt(ww);
    const int k = st[K];
    const int it1 = k + 1;
    const int pos = k % mem;
    const T* hs = ring;
    T* H = ring + (hh_at(mem) - hs_at(mem));
    T* L = ring + (l_at(mem) - hs_at(mem));
    T* S = ring + (s_at(mem) - hs_at(mem));
    T* coef = ring + (coef_at(mem) - hs_at(mem));
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
  if (Staged) {
    __syncthreads();
    for (int j = threadIdx.x; j < nring; j += blockDim.x) {
      sc[hs_at(mem) + j] = ring[j];
    }
  }
}

// 4. p = (v_k - sum_jp coef_jp P_jp) / denom into slot k mod mP,
// x += gamma p, and v_{k+1} = w / ||w|| into slot (k + 1) mod mem unless
// ||w|| = 0 (a lucky breakdown keeps the slot).  With staged, the
// coefficients are copied into dynamic shared memory (mP elements);
// without, read where they are.
template <typename T, int R, bool VEC>
__global__ void __launch_bounds__(kThreads)
tr_update(T* __restrict__ V, T* __restrict__ Pr, T* __restrict__ x,
          const T* __restrict__ w, const T* sc, const int* st, long long n,
          int mem, int mP, bool staged) {
  if (!st[GO]) return;
  extern __shared__ __align__(16) unsigned char coef_mem[];
  T* smem = reinterpret_cast<T*>(coef_mem);
  const T* coef = staged ? smem : sc + coef_at(mem);
  if (staged) {
    for (int j = threadIdx.x; j < mP; j += kThreads) {
      smem[j] = sc[coef_at(mem) + j];
    }
    __syncthreads();
  }
  const int k = st[K];
  const T denom = sc[DENOM];
  const T gstep = sc[GSTEP];
  const T haux = sc[HAUX];
  const T* vk = V + static_cast<long long>(k % mem) * n;
  T* pnew = Pr + static_cast<long long>(k % mP) * n;
  T* vnext = V + static_cast<long long>((k + 1) % mem) * n;
  for (long long i0 = ktt::first_rows<R>(); i0 < n;
       i0 += ktt::rows_stride<R>()) {
    const long long left = n - i0;
    T acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = T(0);
    for (int jp = 0; jp < mP; ++jp) {
      const T cj = coef[jp];
      T pv[R];
      ktt::load_rows<VEC>(Pr + static_cast<long long>(jp) * n + i0, left, pv);
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = acc[r] + cj * pv[r];
    }
    T vv[R], xv[R], wv[R];
    ktt::load_rows<VEC>(vk + i0, left, vv);
    ktt::load_rows<VEC>(x + i0, left, xv);
    ktt::load_rows<VEC>(w + i0, left, wv);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const T p = (vv[r] - acc[r]) / denom;
      acc[r] = p;
      xv[r] = xv[r] + gstep * p;
      wv[r] = wv[r] / haux;
    }
    ktt::store_rows<VEC>(pnew + i0, left, acc);
    ktt::store_rows<VEC>(x + i0, left, xv);
    if (haux != T(0)) ktt::store_rows<VEC>(vnext + i0, left, wv);
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

template <typename T, typename P, bool VEC>
int steps(const P* pd, const long long* offs, int nd, long long lo,
          long long hi, T* w, T* V, T* Pr, T* x, T* partial, T* sc, int* st,
          long long n, int grid, int mem, int mP, int diom, int iters,
          int cap, cudaStream_t s) {
  constexpr int R = ktt::rows_per_thread<P>();
  // the warps' window sums past kReg follow the partial rows
  T* warp_sums = partial + static_cast<long long>(mem + 1) * grid;
  const size_t ring_bytes = static_cast<size_t>(5 * mem + 2) * sizeof(T);
  const size_t coef_bytes = static_cast<size_t>(mP) * sizeof(T);
  const bool ring_staged = ring_bytes <= kSmemMax;
  const bool coef_staged = coef_bytes <= kSmemMax;
  for (int j = 0; j < iters; ++j) {
    tr_stencil<T, P, VEC><<<grid, kThreads, 0, s>>>(
        pd, offs, nd, lo, hi, V, w, partial, warp_sums, st, n, mem, cap);
    tr_sub<T, R, VEC><<<grid, kThreads, 0, s>>>(V, w, partial, sc, st, n,
                                                mem);
    if (ring_staged) {
      tr_column<T, true><<<1, kReduceThreads, ring_bytes, s>>>(
          partial, grid, sc, st, mem, mP, diom);
    } else {
      tr_column<T, false><<<1, kReduceThreads, 0, s>>>(partial, grid, sc, st,
                                                       mem, mP, diom);
    }
    tr_update<T, R, VEC><<<grid, kThreads, coef_staged ? coef_bytes : 0, s>>>(
        V, Pr, x, w, sc, st, n, mem, mP, coef_staged);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

// iters iterations; [lo, hi) is the interior of the offsets
// (ops/cuda_dia.py _interior).  partial holds (mem + 1) grid partials
// and then at least (mem - kReg) grid kWarps warp sums.
template <typename T, typename P>
int iterate(const void* pd, const void* offsets, int nd, long long lo,
            long long hi, void* w_, void* V_, void* P_, void* x_,
            void* partial_, void* sc_, void* st_, long long n, int grid,
            int mem, int mP, int diom, int iters, int cap, void* stream) {
  constexpr int R = ktt::rows_per_thread<P>();
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
  const bool vec = n % R == 0 && ktt::aligned16(pd) && ktt::aligned16(w_)
      && ktt::aligned16(V_) && ktt::aligned16(P_) && ktt::aligned16(x_);
  if (vec) {
    return steps<T, P, true>(A, offs, nd, lo, hi, w, V, Pr, x, partial, sc,
                             st, n, grid, mem, mP, diom, iters, cap, s);
  }
  return steps<T, P, false>(A, offs, nd, lo, hi, w, V, Pr, x, partial, sc,
                            st, n, grid, mem, mP, diom, iters, cap, s);
}

}  // namespace

#define KTT_TR_INIT(NAME, T)                                                  \
  extern "C" int NAME(const void* b, void* V, void* P, void* x,              \
                      void* partial, void* sc, void* st, long long n,        \
                      int grid, int mem, int mP, void* stream) {             \
    return init<T>(b, V, P, x, partial, sc, st, n, grid, mem, mP, stream);   \
  }

#define KTT_TR_ITERATE(NAME, T, P)                                            \
  extern "C" int NAME(const void* pd, const void* offsets, int nd,           \
                      long long lo, long long hi, void* w, void* V,          \
                      void* Pr, void* x, void* partial, void* sc, void* st,  \
                      long long n, int grid, int mem, int mP, int diom,      \
                      int iters, int cap, void* stream) {                    \
    return iterate<T, P>(pd, offsets, nd, lo, hi, w, V, Pr, x, partial, sc,  \
                         st, n, grid, mem, mP, diom, iters, cap, stream);    \
  }

KTT_TR_INIT(ktt_trunc_dia_init_f32, float)
KTT_TR_INIT(ktt_trunc_dia_init_f64, double)
KTT_TR_ITERATE(ktt_trunc_dia_iterate_f32_f32, float, float)
KTT_TR_ITERATE(ktt_trunc_dia_iterate_f32_bf16, float, __nv_bfloat16)
KTT_TR_ITERATE(ktt_trunc_dia_iterate_f32_f16, float, __half)
KTT_TR_ITERATE(ktt_trunc_dia_iterate_f64_f64, double, double)
