// The Saunders-Simon-Yip launches shared by the USYMLQ, USYMQR, TriLQR,
// USYMLQR, TriCG and TriMR whole-solve kernels (usymlq_dia.cu,
// usymqr_dia.cu, trilqr_dia.cu, usymlqr_dia.cu, tricg_dia.cu,
// trimr_dia.cu) on Hopper (sm_90a), with no grid-wide barrier.
//
// What they compute is the SSY step of the TPU kernels
// krylov_tpu/ops/pallas_fused.py:6565 usymlq_dia_fused, :6756
// usymqr_dia_fused, :7695 trilqr_dia_fused, :7968 usymlqr_dia_fused,
// :5427 tricg_dia_fused and :5639 trimr_dia_fused (pallas_fused.py:
// 6646-6658, 5499-5508):
//   q = A u_k - gamma_k v_{k-1},  p = A^H v_k - beta_k u_{k-1}
//   (the gamma and beta terms from the second iteration on),
//   alpha = <v_k, q>,  q -= alpha v_k,  p -= alpha u_k,
//   beta_{k+1} = ||q||,  gamma_{k+1} = ||p||.
// Unlike the two-sided Lanczos process of bilanczos.cuh, A acts on u (the
// basis c starts) and A^H on v (the basis b starts), alpha pairs v_k with
// q, and two norms normalise the two new vectors.
//
// Design.  Four launches per iteration:
//   1. ssy_stencil (grid)    GO; q and p on the two sets of aligned
//                            diagonals, on common.cuh's pair_stencil (the
//                            two-sided kernels' stencil: two rows a
//                            thread, the interiors of A and A^H from the
//                            host, a scalar path where n is no multiple
//                            of the rows a thread owns or a buffer is not
//                            16-byte aligned), and the partials of
//                            <v_k, q> in the order of a one-row-a-thread
//                            grid, so q, p and alpha are bit for bit those
//                            of a one-row stencil; a split method
//                            (Method::kSplit: USYMLQ, USYMQR, TriLQR,
//                            USYMLQR) runs in the same pass the row
//                            updates whose coefficients come from the
//                            committed state alone (Method::pre in thread
//                            0 of every block, Method::early_rows on the
//                            thread's rows; USYMQR's are the last
//                            iteration's, staged by its step)
//   2. ssy_alpha   (grid)    alpha = the sum of those partials in every
//                            block (a fixed order, so every block holds
//                            the same value); q -= alpha v_k,
//                            p -= alpha u_k; partials of ||q||^2, ||p||^2
//   3. ssy_update  (grid)    beta_{k+1} and gamma_{k+1} summed in every
//                            block; thread 0 of every block runs the
//                            method's scalar step (Method::step) on the
//                            last iteration's state, and block 0 writes
//                            the next state into the staging copy of the
//                            scalar and int arrays; then the method's
//                            row updates that need alpha or the norms
//                            (Method::update_row a row at a time for
//                            TriCG and TriMR, or a split method's
//                            Method::late_rows on 16 bytes of each vector
//                            a thread), v_{k+1} = q / beta_{k+1} and
//                            u_{k+1} = p / gamma_{k+1} in place (where a
//                            norm is 0, or for TriCG and TriMR at most
//                            eps^(3/4), as the method says)
//   4. ssy_commit  (1 block) the staging copy into the state, and the
//                            iteration count
// The state every block of launches 1 and 3 reads is only written by
// launch 4, so no block reads a scalar another block of the same launch
// writes.  v and u each rotate through three buffers by the iteration
// count: v_k in buffer it mod 3, v_{k-1} in (it + 2) mod 3, and q, which
// becomes v_{k+1}, in (it + 1) mod 3.  The stencil reads the neighbours
// of u_k and v_k only, and no launch writes a buffer whose neighbours it
// reads.  Every row update keeps the products and sums of the one-row
// update, in its order.  Bytes per row and iteration in f32 with f32
// diagonals (7-point stencil): the stencil 2 x 28 B of diagonals, u_k,
// v_k, v_{k-1}, u_{k-1} read and q, p written (80 B) and the early rows;
// alpha q, p, v_k, u_k read and q, p written (24 B); the update q, p read
// and written (16 B; v_k and u_k are read only where a norm is 0) and the
// late rows.
//
// Layouts.  The scalar array holds ATOL, RTOL and ALPHA, then the state
// from BETA to the method's NSC_STATE, then its staging copy (slot j's
// copy at j + NSC_STATE - BETA).  The int array holds IT, STATUS and GO,
// then the method's ints up to NST_STATE, then the staging copy of
// STATUS .. NST_STATE (slot j's copy at j + NST_STATE - STATUS; GO's copy
// is unused).
#pragma once

#include "common.cuh"

// Internal linkage, as cg_steps.cuh: each kernel file has its own copies.
namespace {
namespace ssy {

using namespace ktt;

constexpr int kThreads = 256;
constexpr int kReduceThreads = 1024;

constexpr int RUNNING = 0;
constexpr int SOLVED = 1;
constexpr int ZERO_RESIDUAL = 2;
constexpr int INCONSISTENT = 8;
constexpr int SOLVED_PRIMAL_DUAL = 15;
constexpr int SOLVED_LQ = 35;
constexpr int SOLVED_CG = 36;

// The first slots of every method's scalar and int arrays (its own enums
// continue these), the rows of the vector workspace before the method's
// own (V0 = 0 .. 2, U0 = 3 .. 5), and the partial rows.
enum SharedSlot { ATOL = 0, RTOL, ALPHA, BETA, GAMMA };
enum SharedInt { IT = 0, STATUS, GO };
enum Row { V0 = 0, U0 = 3, NSHARED_ROWS = 6 };
enum Part { PVQ = 0, PQQ, PPP, NPART };

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

// Init: the partials of b'b (row PQQ) and c'c (row PPP).
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssy_init_dots(const T* __restrict__ b, const T* __restrict__ c,
              T* __restrict__ partial, long long n) {
  T sbb = T(0);
  T scc = T(0);
  for (long long i = first_row(); i < n; i += row_stride()) {
    const T bi = b[i];
    const T ci = c[i];
    sbb += bi * bi;
    scc += ci * ci;
  }
  const int nparts = gridDim.x;
  store_partials(sbb, partial + PQQ * nparts, scc, partial + PPP * nparts);
}

// Init: v_1 = b / ||b|| and u_1 = c / ||c|| (buffer 0), the other v and u
// buffers and rows first .. nrows - 1 zeroed, and b copied into row
// b_row where b_row >= 0 (USYMLQR's r).
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssy_init_vectors(const T* __restrict__ b, const T* __restrict__ c,
                 T* __restrict__ work, const T* sc, long long n, int first,
                 int nrows, int b_row) {
  const T beta = safe(sc[BETA]);
  const T gamma = safe(sc[GAMMA]);
  for (long long i = first_row(); i < n; i += row_stride()) {
    const T bi = b[i];
    row(work, V0, n)[i] = bi / beta;
    row(work, U0, n)[i] = c[i] / gamma;
    for (int r = 1; r < 3; ++r) {
      row(work, V0 + r, n)[i] = T(0);
      row(work, U0 + r, n)[i] = T(0);
    }
    for (int r = first; r < nrows; ++r) {
      row(work, r, n)[i] = r == b_row ? bi : T(0);
    }
  }
}

// Method::kSplit where a method defines it (USYMLQ, USYMQR, TriLQR,
// USYMLQR), else false: its row updates split between the stencil's
// pass, from Method::pre's coefficients (Method::early_rows), and the
// update's (Method::late_rows), both on rows a thread owns several of.
template <typename M, typename = void>
struct splits {
  static constexpr bool value = false;
};
template <typename M>
struct splits<M, decltype(void(M::kSplit))> {
  static constexpr bool value = M::kSplit;
};

// A method's early rows on a thread's R rows, with the coefficients
// every thread copied from its block's shared copy.
template <typename T, typename Method, int R, bool VEC>
struct EarlyRows {
  T* work;
  typename Method::template Pre<T> k;
  int it0;
  long long n;
  __device__ __forceinline__ void operator()(long long i0,
                                             long long left) const {
    Method::template early_rows<R, VEC>(work, k, it0, n, i0, left);
  }
};

// The SSY products on pair_stencil: A on u_k, A^H on v_k, the partials of
// <v_k, q> (g2 = 0 at the first iteration, pallas_fused.py:6650-6654).
template <typename T, typename P, bool VEC, typename Rows>
__device__ __forceinline__ void ssy_pair(
    const P* __restrict__ pd, const long long* __restrict__ offsets, int nd,
    const P* __restrict__ pda, const long long* __restrict__ offsets_a,
    int nda, long long lo, long long hi, long long lo_a, long long hi_a,
    T* work, T* partial, const T* sc, int it0, long long n,
    const Rows& rows) {
  const T g2 = it0 >= 1 ? T(1) : T(0);
  const T* vk = row(work, V0 + cur(it0), n);
  pair_stencil<T, P, VEC>(
      pd, offsets, nd, pda, offsets_a, nda, lo, hi, lo_a, hi_a,
      row(work, U0 + cur(it0), n), vk, row(work, V0 + prev(it0), n),
      g2 * sc[GAMMA], row(work, U0 + prev(it0), n), g2 * sc[BETA], vk,
      row(work, V0 + next(it0), n), row(work, U0 + next(it0), n),
      partial + PVQ * gridDim.x, static_cast<T*>(nullptr), n, rows);
}

// 1. Decide whether this iteration runs (GO, read by every later launch
// of the iteration), then q = A u_k - gamma v_{k-1},
// p = A^H v_k - beta u_{k-1}, the partials of <v_k, q> and a split
// method's early rows, in blocks of kThreads / R threads.  [lo, hi) and
// [lo_a, hi_a) are the interiors of A's and A^H's offsets; with VEC, pd,
// pda and the work rows are 16-byte aligned and n is a multiple of R.
template <typename T, typename P, bool VEC, typename Method>
__global__ void __launch_bounds__(kThreads / kPairRows)
ssy_stencil(const P* __restrict__ pd, const long long* __restrict__ offsets,
            int nd, const P* __restrict__ pda,
            const long long* __restrict__ offsets_a, int nda, long long lo,
            long long hi, long long lo_a, long long hi_a,
            T* __restrict__ work, T* __restrict__ partial, const T* sc,
            int* st, long long n, int flag, int cap) {
  constexpr int R = kPairRows;
  const int it0 = st[IT];
  const bool go = st[STATUS] == RUNNING && it0 < cap;
  if (blockIdx.x == 0 && threadIdx.x == 0) st[GO] = go ? 1 : 0;
  if (!go) return;
  if constexpr (splits<Method>::value) {
    __shared__ typename Method::template Pre<T> pre;
    if (threadIdx.x == 0) {
      pre = Method::template pre<T>(sc, st, it0 + 1, flag);
    }
    __syncthreads();
    ssy_pair<T, P, VEC>(pd, offsets, nd, pda, offsets_a, nda, lo, hi, lo_a,
                        hi_a, work, partial, sc, it0, n,
                        EarlyRows<T, Method, R, VEC>{work, pre, it0, n});
  } else {
    ssy_pair<T, P, VEC>(pd, offsets, nd, pda, offsets_a, nda, lo, hi, lo_a,
                        hi_a, work, partial, sc, it0, n, NoRows{});
  }
}

// 2. alpha = <v_k, q>; q -= alpha v_k, p -= alpha u_k; partials of
// ||q||^2 and ||p||^2.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssy_alpha(T* __restrict__ work, T* __restrict__ partial, T* sc,
          const int* st, long long n) {
  if (!st[GO]) return;
  const int nparts = gridDim.x;
  const T alpha = all_sum(partial + PVQ * nparts, nparts);
  if (blockIdx.x == 0 && threadIdx.x == 0) sc[ALPHA] = alpha;
  const int it0 = st[IT];
  const T* vk = row(work, V0 + cur(it0), n);
  T* q = row(work, V0 + next(it0), n);
  const T* uk = row(work, U0 + cur(it0), n);
  T* p = row(work, U0 + next(it0), n);
  T sqq = T(0);
  T spp = T(0);
  for (long long i = first_row(); i < n; i += row_stride()) {
    const T qi = q[i] - alpha * vk[i];
    const T pi = p[i] - alpha * uk[i];
    q[i] = qi;
    p[i] = pi;
    sqq += qi * qi;
    spp += pi * pi;
  }
  store_partials(sqq, partial + PQQ * nparts, spp, partial + PPP * nparts);
}

// Row i of v_{k+1} = q / beta_{k+1} and u_{k+1} = p / gamma_{k+1}, in
// place of q and p; where a norm is 0 the new vector is the old one
// (keep) or zero (pallas_fused.py:6688-6691, 8140-8143), and only then is
// the old one read.  A method's row update runs before it, so it may
// read q[i] and p[i] first.
template <typename T>
__device__ __forceinline__ void ssy_next_row(T* work, int it0, long long n,
                                             long long i, T beta1, T gamma1,
                                             bool keep) {
  T* q = row(work, V0 + next(it0), n);
  T* p = row(work, U0 + next(it0), n);
  q[i] = beta1 != T(0) ? q[i] / safe(beta1)
                       : (keep ? row(work, V0 + cur(it0), n)[i] : T(0));
  p[i] = gamma1 != T(0) ? p[i] / safe(gamma1)
                        : (keep ? row(work, U0 + cur(it0), n)[i] : T(0));
}

// Row i of v_{k+1} and u_{k+1} for a method that keeps q (or p)
// un-normalised where beta_{k+1} (or gamma_{k+1}) <= btol = eps^(3/4)
// (TriCG, pallas_fused.py:5559-5563).
template <typename T>
__device__ __forceinline__ void ssy_next_row_btol(T* work, int it0,
                                                  long long n, long long i,
                                                  T beta1, T gamma1, T btol) {
  T* q = row(work, V0 + next(it0), n);
  T* p = row(work, U0 + next(it0), n);
  if (beta1 > btol) q[i] = q[i] / beta1;
  if (gamma1 > btol) p[i] = p[i] / gamma1;
}

// Rows i0 .. i0 + R - 1 (left of them below n) of v_{k+1} and u_{k+1},
// as ssy_next_row takes each.
template <int R, bool VEC, typename T>
__device__ __forceinline__ void ssy_next_rows(T* work, int it0, long long n,
                                              long long i0, long long left,
                                              T beta1, T gamma1, bool keep) {
  const T norms[2] = {beta1, gamma1};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int base = h == 0 ? V0 : U0;
    T* out = row(work, base + next(it0), n) + i0;
    T v[R];
    if (norms[h] != T(0)) {
      load_rows<VEC>(out, left, v);
#pragma unroll
      for (int r = 0; r < R; ++r) v[r] = v[r] / safe(norms[h]);
    } else if (keep) {
      load_rows<VEC>(row(work, base + cur(it0), n) + i0, left, v);
    } else {
#pragma unroll
      for (int r = 0; r < R; ++r) v[r] = T(0);
    }
    store_rows<VEC>(out, left, v);
  }
}

// eps^(3/4) of T, taken in double and rounded to T, as the TPU kernel
// takes it (pallas_fused.py:5446).
template <typename T>
__device__ __forceinline__ T btol_of() {
  return static_cast<T>(pow(static_cast<double>(eps_of<T>()), 0.75));
}

// Method::kBtol where a method defines it (TriCG), else false: the
// normalisation of ssy_next_row_btol instead of ssy_next_row's.
template <typename M, typename = void>
struct uses_btol {
  static constexpr bool value = false;
};
template <typename M>
struct uses_btol<M, decltype(void(M::kBtol))> {
  static constexpr bool value = M::kBtol;
};

// The vectors a method's row update reads: v_k, v_{k-1}, u_k and q (the
// un-normalised q of this iteration).
template <typename T>
struct Vecs {
  const T* vk;
  const T* vkm1;
  const T* uk;
  const T* q;
};

// 3. beta_{k+1}, gamma_{k+1}; the method's scalar step in thread 0 of
// every block (block 0 stores the next state in the staging copy); its
// late row updates; v_{k+1} and u_{k+1}.  A split method's rows go
// 16 / sizeof(T) to a thread (VEC: the work rows are 16-byte aligned and
// n is a multiple of that), the others' one.
template <typename T, bool VEC, typename Method>
__global__ void __launch_bounds__(kThreads)
ssy_update(T* __restrict__ work, T* __restrict__ partial, T* sc, int* st,
           long long n, int flag) {
  if (!st[GO]) return;
  const int nparts = gridDim.x;
  const T beta1 = sqrt(all_sum(partial + PQQ * nparts, nparts));
  const T gamma1 = sqrt(all_sum(partial + PPP * nparts, nparts));
  const int it0 = st[IT];
  __shared__ typename Method::template Coef<T> coef;
  if (threadIdx.x == 0) {
    const bool store = blockIdx.x == 0;
    coef = Method::step(sc, st, sc[ALPHA], beta1, gamma1, it0 + 1, flag,
                        store ? sc + (Method::kNscState - BETA) : nullptr,
                        store ? st + (Method::kNstState - STATUS) : nullptr);
  }
  __syncthreads();
  if constexpr (splits<Method>::value) {
    constexpr int R = static_cast<int>(16 / sizeof(T));
    for (long long i0 = first_rows<R>(); i0 < n; i0 += rows_stride<R>()) {
      const long long left = n - i0;
      Method::template late_rows<R, VEC>(work, coef, it0, n, i0, left);
      ssy_next_rows<R, VEC>(work, it0, n, i0, left, beta1, gamma1,
                            Method::kKeep);
    }
  } else {
    const Vecs<T> vecs{row(work, V0 + cur(it0), n),
                       row(work, V0 + prev(it0), n),
                       row(work, U0 + cur(it0), n),
                       row(work, V0 + next(it0), n)};
    for (long long i = first_row(); i < n; i += row_stride()) {
      Method::update_row(work, coef, vecs, it0, n, i);
      if constexpr (uses_btol<Method>::value) {
        ssy_next_row_btol(work, it0, n, i, beta1, gamma1, btol_of<T>());
      } else {
        ssy_next_row(work, it0, n, i, beta1, gamma1, Method::kKeep);
      }
    }
  }
}

// 4. The staging copy into the state, and the iteration count.
template <typename T, typename Method>
__global__ void __launch_bounds__(32)
ssy_commit(T* sc, int* st) {
  if (!st[GO]) return;
  constexpr int kSc = Method::kNscState - BETA;
  constexpr int kSt = Method::kNstState - STATUS;
  for (int j = BETA + threadIdx.x; j < Method::kNscState; j += blockDim.x) {
    sc[j] = sc[j + kSc];
  }
  for (int j = STATUS + threadIdx.x; j < Method::kNstState; j += blockDim.x) {
    if (j != GO) st[j] = st[j + kSt];
  }
  if (threadIdx.x == 0) st[IT] += 1;
}

// The start of a method's step in block 0: the staging copy set to the
// current state, so that slots the step leaves alone commit unchanged.
template <typename T, typename Method>
__device__ __forceinline__ void stage_state(const T* sc, const int* st,
                                            T* nsc, int* nst) {
  for (int j = BETA; j < Method::kNscState; ++j) nsc[j] = sc[j];
  for (int j = STATUS; j < Method::kNstState; ++j) nst[j] = st[j];
}

// The init, per-iteration and finishing launch sequences; a method
// supplies
//   Method::init_scalars<T>(b_norm, c_norm, sc, st, flag)  (one thread)
//   Method::step<T>(...)                                   (ssy_update)
//   Method::finishes<T>(sc, st), Method::finish_row<T>(...) (finish)
// and either Method::update_row<T>(...) (ssy_update, a row at a time:
// TriCG, TriMR) or, with kSplit, Method::Pre<T>, Method::pre<T>(sc, st,
// it, flag) (one thread of each block of ssy_stencil),
// Method::early_rows<R, VEC>(...) (ssy_stencil) and
// Method::late_rows<R, VEC>(...) (ssy_update); the
// number of its own work rows (kRows), the row that starts as b
// (b_row(flag), -1 for none), whether a zero norm keeps the old basis
// vector (kKeep), and the ends of its scalar and int states (kNscState,
// kNstState).
template <typename T, typename Method>
__global__ void __launch_bounds__(kReduceThreads)
ssy_init_scalars(const T* __restrict__ partial, int nparts, T* sc, int* st,
                 int flag) {
  const T bb = sum_partials(partial + PQQ * nparts, nparts);
  __syncthreads();
  const T cc = sum_partials(partial + PPP * nparts, nparts);
  if (threadIdx.x != 0) return;
  for (int j = ALPHA; j < Method::kNscState; ++j) sc[j] = T(0);
  for (int j = 0; j < Method::kNstState; ++j) st[j] = 0;
  sc[BETA] = sqrt(bb);
  sc[GAMMA] = sqrt(cc);
  Method::template init_scalars<T>(sc[BETA], sc[GAMMA], sc, st, flag);
}

template <typename T, typename Method>
int init(const void* b_, const void* c_, void* work_, void* partial_,
         void* sc_, void* st_, long long n, int grid, int flag,
         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* b = static_cast<const T*>(b_);
  const T* c = static_cast<const T*>(c_);
  T* partial = static_cast<T*>(partial_);
  T* sc = static_cast<T*>(sc_);
  ssy_init_dots<T><<<grid, kThreads, 0, s>>>(b, c, partial, n);
  ssy_init_scalars<T, Method><<<1, kReduceThreads, 0, s>>>(
      partial, grid, sc, static_cast<int*>(st_), flag);
  ssy_init_vectors<T><<<grid, kThreads, 0, s>>>(
      b, c, static_cast<T*>(work_), sc, n, NSHARED_ROWS,
      NSHARED_ROWS + Method::kRows, Method::b_row(flag));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename P, bool VEC, typename Method>
int steps(const P* pd, const long long* offs, int nd, const P* pda,
          const long long* offs_a, int nda, long long lo, long long hi,
          long long lo_a, long long hi_a, T* work, T* partial, T* sc,
          int* st, long long n, int grid, int flag, int iters, int cap,
          cudaStream_t s) {
  constexpr int kStencilThreads = kThreads / kPairRows;
  for (int j = 0; j < iters; ++j) {
    ssy_stencil<T, P, VEC, Method><<<grid, kStencilThreads, 0, s>>>(
        pd, offs, nd, pda, offs_a, nda, lo, hi, lo_a, hi_a, work, partial,
        sc, st, n, flag, cap);
    ssy_alpha<T><<<grid, kThreads, 0, s>>>(work, partial, sc, st, n);
    ssy_update<T, VEC && splits<Method>::value, Method>
        <<<grid, kThreads, 0, s>>>(work, partial, sc, st, n, flag);
    ssy_commit<T, Method><<<1, 32, 0, s>>>(sc, st);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

// iters iterations; [lo, hi) and [lo_a, hi_a) are the interiors of A's
// and A^H's offsets (ops/cuda_dia.py _interior).
template <typename T, typename P, typename Method>
int iterate(const void* pd_, const void* offsets_, int nd, const void* pda_,
            const void* offsets_a_, int nda, long long lo, long long hi,
            long long lo_a, long long hi_a, void* work_, void* partial_,
            void* sc_, void* st_, long long n, int grid, int flag, int iters,
            int cap, void* stream) {
  static_assert(16 / sizeof(T) % kPairRows == 0, "VEC covers R");
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const P* pd = static_cast<const P*>(pd_);
  const long long* offs = static_cast<const long long*>(offsets_);
  const P* pda = static_cast<const P*>(pda_);
  const long long* offs_a = static_cast<const long long*>(offsets_a_);
  T* work = static_cast<T*>(work_);
  T* partial = static_cast<T*>(partial_);
  T* sc = static_cast<T*>(sc_);
  int* st = static_cast<int*>(st_);
  // the update's rows go 16 / sizeof(T) to a thread, a multiple of R
  const bool vec = n % (16 / sizeof(T)) == 0 && aligned16(pd_)
      && aligned16(pda_) && aligned16(work_);
  if (vec) {
    return steps<T, P, true, Method>(pd, offs, nd, pda, offs_a, nda, lo, hi,
                                     lo_a, hi_a, work, partial, sc, st, n,
                                     grid, flag, iters, cap, s);
  }
  return steps<T, P, false, Method>(pd, offs, nd, pda, offs_a, nda, lo, hi,
                                    lo_a, hi_a, work, partial, sc, st, n,
                                    grid, flag, iters, cap, s);
}

// After the loop: the method's final vector update, row by row (st
// holds the iteration count and the final status).
template <typename T, typename Method>
__global__ void __launch_bounds__(kThreads)
ssy_finish(T* __restrict__ work, const T* sc, const int* st, long long n) {
  if (!Method::template finishes<T>(sc, st)) return;
  for (long long i = first_row(); i < n; i += row_stride()) {
    Method::template finish_row<T>(work, sc, st, n, i);
  }
}

template <typename T, typename Method>
int finish(void* work, const void* sc, const void* st, long long n, int grid,
           void* stream) {
  ssy_finish<T, Method><<<grid, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<T*>(work), static_cast<const T*>(sc),
      static_cast<const int*>(st), n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ssy
}  // namespace

// The C entry points of a method: init and finish for f32 and f64, and
// iterate for every (vector, diagonal) type pair.
#define KTT_SSY_INIT(NAME, T, METHOD)                                         \
  extern "C" int NAME(const void* b, const void* c, void* work,              \
                      void* partial, void* sc, void* st, long long n,        \
                      int grid, int flag, void* stream) {                    \
    return ssy::init<T, METHOD>(b, c, work, partial, sc, st, n, grid, flag,  \
                                stream);                                     \
  }

#define KTT_SSY_ITERATE(NAME, T, P, METHOD)                                   \
  extern "C" int NAME(const void* pd, const void* offsets, int nd,           \
                      const void* pda, const void* offsets_a, int nda,       \
                      long long lo, long long hi, long long lo_a,            \
                      long long hi_a, void* work, void* partial, void* sc,   \
                      void* st, long long n, int grid, int flag, int iters,  \
                      int cap, void* stream) {                               \
    return ssy::iterate<T, P, METHOD>(pd, offsets, nd, pda, offsets_a, nda,  \
                                      lo, hi, lo_a, hi_a, work, partial, sc, \
                                      st, n, grid, flag, iters, cap,         \
                                      stream);                               \
  }

#define KTT_SSY_FINISH(NAME, T, METHOD)                                       \
  extern "C" int NAME(void* work, const void* sc, const void* st,            \
                      long long n, int grid, void* stream) {                 \
    return ssy::finish<T, METHOD>(work, sc, st, n, grid, stream);            \
  }
