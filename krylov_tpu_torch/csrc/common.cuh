// Helpers shared by the port's CUDA kernels: element conversions, the
// masked DIA stencil row, the wide DIA rows of dia_spmv.cu, trunc_dia.cu
// and the Arnoldi stencil of arnoldi.cuh, the Lanczos pair stencil of
// bilanczos.cuh and ssy.cuh on those rows, and block-wide sums whose
// order is fixed by the grid and block shape alone, so that two runs of a
// kernel give the same bits.
#pragma once

#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cstring>

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace ktt {

// Widen a stored diagonal entry to the accumulation type.
template <typename A>
__device__ __forceinline__ A widen(float v) { return static_cast<A>(v); }
template <typename A>
__device__ __forceinline__ A widen(double v) { return static_cast<A>(v); }
template <typename A>
__device__ __forceinline__ A widen(__nv_bfloat16 v) {
  return static_cast<A>(__bfloat162float(v));
}
template <typename A>
__device__ __forceinline__ A widen(__half v) {
  return static_cast<A>(__half2float(v));
}

// A complex number laid out as PyTorch stores complex64 and complex128:
// the real part, then the imaginary part.
template <typename R>
struct alignas(2 * sizeof(R)) complex {
  R re, im;
  __host__ __device__ complex(R r = R(0), R i = R(0)) : re(r), im(i) {}
};

// acc + p * x in the accumulation type A: a real diagonal entry and a
// real x are widened to A; a complex x takes a real or a complex entry.
template <typename A, typename P, typename X>
__device__ __forceinline__ A madd(A acc, P p, X x) {
  return acc + widen<A>(p) * widen<A>(x);
}
template <typename R>
__device__ __forceinline__ complex<R> madd(complex<R> acc, R p,
                                           complex<R> x) {
  return complex<R>(acc.re + p * x.re, acc.im + p * x.im);
}
template <typename R>
__device__ __forceinline__ complex<R> madd(complex<R> acc, complex<R> p,
                                           complex<R> x) {
  return complex<R>(acc.re + (p.re * x.re - p.im * x.im),
                    acc.im + (p.re * x.im + p.im * x.re));
}

// The accumulator narrowed to the stored vector type.
template <typename X, typename A>
__device__ __forceinline__ X narrow(A v) { return static_cast<X>(v); }
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16, float>(float v) {
  return __float2bfloat16(v);
}
template <>
__device__ __forceinline__ __half narrow<__half, float>(float v) {
  return __float2half(v);
}
// A double narrows through float, as PyTorch converts it (the plain
// versions' .to(torch.bfloat16) rounds twice).
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16, double>(
    double v) {
  return __float2bfloat16(static_cast<float>(v));
}
template <>
__device__ __forceinline__ __half narrow<__half, double>(double v) {
  return __float2half(static_cast<float>(v));
}

// Machine epsilon and the smallest normal number of the vector type.
template <typename T> __device__ __forceinline__ T eps_of();
template <> __device__ __forceinline__ float eps_of<float>() { return FLT_EPSILON; }
template <> __device__ __forceinline__ double eps_of<double>() { return DBL_EPSILON; }
template <typename T> __device__ __forceinline__ T tiny_of();
template <> __device__ __forceinline__ float tiny_of<float>() { return FLT_MIN; }
template <> __device__ __forceinline__ double tiny_of<double>() { return DBL_MIN; }

// Grid-stride row loop: rows first_row(), first_row() + row_stride(), ...
__device__ __forceinline__ long long first_row() {
  return static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
}
__device__ __forceinline__ long long row_stride() {
  return static_cast<long long>(gridDim.x) * blockDim.x;
}

// The same loop over R consecutive rows a thread (the wide-row launches):
// rows first_rows<R>() .. + R - 1, then a stride of rows_stride<R>().
template <int R>
__device__ __forceinline__ long long first_rows() {
  return first_row() * R;
}
template <int R>
__device__ __forceinline__ long long rows_stride() {
  return row_stride() * R;
}

// Row i of A x from output-aligned diagonals, pd[d, i] * x[i + k_d] summed
// over d in order in the accumulation type A.  The read of x is masked,
// so nothing is loaded past either end of x; row and diagonal indices
// are 64-bit.
template <typename A, typename P, typename X>
__device__ __forceinline__ A stencil_row_acc(
    const P* __restrict__ pd, const long long* __restrict__ offsets, int nd,
    const X* __restrict__ x, long long i, long long n) {
  A acc = A(0);
  for (int d = 0; d < nd; ++d) {
    const long long j = i + __ldg(offsets + d);
    if (j >= 0 && j < n) {
      acc = madd(acc, pd[static_cast<long long>(d) * n + i], x[j]);
    }
  }
  return acc;
}

// The same row for a real vector type T, accumulated in T.
template <typename T, typename P>
__device__ __forceinline__ T stencil_row(const P* __restrict__ pd,
                                         const long long* __restrict__ offsets,
                                         int nd, const T* __restrict__ x,
                                         long long i, long long n) {
  return stencil_row_acc<T>(pd, offsets, nd, x, i, n);
}

// Loads through the read-only data cache: one element, or R elements
// from a 16-byte aligned address, 16 bytes at a time.
__device__ __forceinline__ float ld_ro(const float* p) { return __ldg(p); }
__device__ __forceinline__ double ld_ro(const double* p) { return __ldg(p); }
__device__ __forceinline__ __nv_bfloat16 ld_ro(const __nv_bfloat16* p) {
  return __ldg(p);
}
__device__ __forceinline__ __half ld_ro(const __half* p) { return __ldg(p); }
__device__ __forceinline__ complex<float> ld_ro(const complex<float>* p) {
  const float2 v = __ldg(reinterpret_cast<const float2*>(p));
  return complex<float>(v.x, v.y);
}
__device__ __forceinline__ complex<double> ld_ro(const complex<double>* p) {
  const double2 v = __ldg(reinterpret_cast<const double2*>(p));
  return complex<double>(v.x, v.y);
}

// R elements as whole 16-byte words, or as one 8- or 4-byte word where R
// elements of a narrow type (a bf16 or f16 Krylov panel) fill no more;
// p is aligned to the words' size.
template <typename T, int R>
__device__ __forceinline__ void ld_vec(const T* p, T (&v)[R]) {
  constexpr size_t B = R * sizeof(T);
  static_assert(B % 16 == 0 || B == 8 || B == 4, "whole words");
  if constexpr (B % 16 == 0) {
    constexpr int W = static_cast<int>(B / 16);
    uint4 w[W];
#pragma unroll
    for (int q = 0; q < W; ++q) {
      w[q] = __ldg(reinterpret_cast<const uint4*>(p) + q);
    }
    memcpy(&v[0], &w[0], sizeof(w));
  } else if constexpr (B == 8) {
    const uint2 w = __ldg(reinterpret_cast<const uint2*>(p));
    memcpy(&v[0], &w, sizeof(w));
  } else {
    const unsigned int w = __ldg(reinterpret_cast<const unsigned int*>(p));
    memcpy(&v[0], &w, sizeof(w));
  }
}

template <typename T, int R>
__device__ __forceinline__ void st_vec(T* p, const T (&v)[R]) {
  constexpr size_t B = R * sizeof(T);
  static_assert(B % 16 == 0 || B == 8 || B == 4, "whole words");
  if constexpr (B % 16 == 0) {
    constexpr int W = static_cast<int>(B / 16);
    uint4 w[W];
    memcpy(&w[0], &v[0], sizeof(w));
#pragma unroll
    for (int q = 0; q < W; ++q) reinterpret_cast<uint4*>(p)[q] = w[q];
  } else if constexpr (B == 8) {
    uint2 w;
    memcpy(&w, &v[0], sizeof(w));
    *reinterpret_cast<uint2*>(p) = w;
  } else {
    unsigned int w;
    memcpy(&w, &v[0], sizeof(w));
    *reinterpret_cast<unsigned int*>(p) = w;
  }
}

// Rows p[0 .. R - 1] of a vector with `left` rows from p on, 16 bytes at a
// time with VEC (then R rows are there and p is 16-byte aligned), else
// element by element, 0 past the end.
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

// The rows a thread owns in the wide DIA kernels: as many as one 16-byte
// load of the diagonal type holds.
template <typename P>
__host__ __device__ constexpr int rows_per_thread() {
  return static_cast<int>(16 / sizeof(P));
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<std::uintptr_t>(p) & 15u) == 0;
}

// Diagonals staged in shared memory at a time by the wide DIA rows.
constexpr int kDiaTile = 256;

template <typename Ix>
__device__ __forceinline__ void stage_offsets(Ix* offs,
                                              const long long* offsets,
                                              int dn) {
  for (int t = threadIdx.x; t < dn; t += blockDim.x) {
    offs[t] = static_cast<Ix>(offsets[t]);
  }
}

// Rows i0 .. i0 + R - 1 of A x added to acc over the dn diagonals whose
// offsets offs holds, pt = pd + d0 * n + i0 (the first of them).  Rows
// whose every neighbour lies in [0, n) (inner) take a path with no bounds
// branch, several diagonals' loads in flight, and x read 16 bytes at a
// time where i0 + k_d is a multiple of R and x is aligned (VEC and
// x_aligned); the others mask each read of x, so nothing is loaded past
// either end of x.  Each row sums its diagonals in order, skipping those
// that leave [0, n), as stencil_row_acc does.
template <int R, bool VEC, typename AT, typename PT, typename XT,
          typename Ix>
__device__ __forceinline__ void dia_tile_rows(
    const PT* __restrict__ pt, const Ix* offs, int dn,
    const XT* __restrict__ x, Ix i0, Ix n, bool inner, bool x_aligned,
    AT (&acc)[R]) {
  if (inner) {
#pragma unroll 4
    for (int dd = 0; dd < dn; ++dd) {
      const Ix k = offs[dd];
      const PT* __restrict__ prow = pt + static_cast<Ix>(dd) * n;
      PT pv[R];
      XT xv[R];
      if (VEC) {
        ld_vec(prow, pv);
      } else {
#pragma unroll
        for (int r = 0; r < R; ++r) pv[r] = ld_ro(prow + r);
      }
      if (VEC && x_aligned && k % R == 0) {
        ld_vec(x + i0 + k, xv);
      } else {
#pragma unroll
        for (int r = 0; r < R; ++r) xv[r] = ld_ro(x + i0 + k + r);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = madd(acc[r], pv[r], xv[r]);
    }
  } else {
    for (int dd = 0; dd < dn; ++dd) {
      const Ix k = offs[dd];
      const PT* __restrict__ prow = pt + static_cast<Ix>(dd) * n;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const Ix i = i0 + r;
        const Ix j = i + k;
        if (i < n && j >= 0 && j < n) {
          acc[r] = madd(acc[r], ld_ro(prow + r), ld_ro(x + j));
        }
      }
    }
  }
}

// Rows i0 .. i0 + R - 1 of A x over all nd diagonals, [lo, hi) the
// interior (ops/cuda_dia.py _interior).  Where nd <= kDiaTile the caller
// has staged the offsets in offs, behind a barrier; otherwise each tile
// is staged here between barriers.  Every thread of the block calls it
// the same number of times, rows past n included.
template <int R, bool VEC, typename AT, typename PT, typename XT,
          typename Ix>
__device__ __forceinline__ void dia_rows(
    const PT* __restrict__ pd, const long long* __restrict__ offsets, int nd,
    Ix* offs, const XT* __restrict__ x, Ix i0, Ix n, Ix lo, Ix hi,
    bool x_aligned, AT (&acc)[R]) {
  const bool live = i0 < n;
  const bool inner = i0 >= lo && i0 + R <= hi;
  for (int d0 = 0; d0 < nd; d0 += kDiaTile) {
    const int dn = min(kDiaTile, nd - d0);
    if (nd > kDiaTile) {
      __syncthreads();                 // the last tile's reads are done
      stage_offsets(offs, offsets + d0, dn);
      __syncthreads();
    }
    if (live) {
      dia_tile_rows<R, VEC>(pd + static_cast<Ix>(d0) * n + i0, offs, dn, x,
                            i0, n, inner, x_aligned, acc);
    }
  }
}

// a b + c rounded once, in the type of its arguments.
__device__ __forceinline__ float fused_madd(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fused_madd(double a, double b, double c) {
  return fma(a, b, c);
}

// d, or 1 where d is 0: keeps a division whose result is not taken
// finite.
template <typename T>
__device__ __forceinline__ T safe(T d) { return d == T(0) ? T(1) : d; }

template <typename T>
__device__ __forceinline__ T sign(T v) {
  return v > T(0) ? T(1) : (v < T(0) ? T(-1) : T(0));
}

// The symmetric Givens reflection (c, s, rho) of (a, b), real case,
// branch for branch as krylov_tpu/ops/kops.py:_sym_givens_real, with
// sym_givens(0, 0) = (1, 0, 0).
template <typename T>
__device__ void sym_givens(T a, T b, T& c, T& s, T& rho) {
  const T abs_a = fabs(a);
  const T abs_b = fabs(b);
  if (abs_b == T(0)) {
    c = sign(a) + (abs_a == T(0) ? T(1) : T(0));
    s = T(0);
    rho = abs_a;
  } else if (abs_a == T(0)) {
    c = T(0);
    s = sign(b);
    rho = abs_b;
  } else if (abs_b > abs_a) {
    const T t = a / b;
    s = sign(b) / sqrt(T(1) + t * t);
    c = s * t;
    rho = b / safe(s);
  } else {
    const T t = b / a;
    c = sign(a) / sqrt(T(1) + t * t);
    s = c * t;
    rho = a / safe(c);
  }
}

// Sum of v over the block; the result is valid in thread 0 only.
// blockDim.x must be a multiple of 32 and at most 1024.  A kernel that
// takes a second sum calls __syncthreads() between the two, since both
// use the same shared array.
template <typename T>
__device__ __forceinline__ T block_sum(T v) {
  __shared__ T warp_sums[32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  const int nwarps = blockDim.x >> 5;
  v = threadIdx.x < nwarps ? warp_sums[threadIdx.x] : T(0);
  if (warp == 0) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  }
  return v;
}

// This block's partial sum of s, stored at partial[blockIdx.x].
template <typename T>
__device__ __forceinline__ void store_partial(T s, T* partial) {
  s = block_sum(s);
  if (threadIdx.x == 0) partial[blockIdx.x] = s;
}

// Two partial sums in one launch.
template <typename T>
__device__ __forceinline__ void store_partials(T s1, T* partial1, T s2,
                                               T* partial2) {
  store_partial(s1, partial1);
  __syncthreads();
  store_partial(s2, partial2);
}

// Sum of the per-block partials in a fixed order; valid in thread 0.
template <typename T>
__device__ __forceinline__ T sum_partials(const T* partial, int nparts) {
  T s = T(0);
  for (int i = threadIdx.x; i < nparts; i += blockDim.x) s += partial[i];
  return block_sum(s);
}

// K sums over the block at once: v[j] summed over the block's threads is
// stored at out[j * stride + blockIdx.x] (a block's partials of K dots),
// or, with stride 0, at out[j] by thread 0 alone, for j < count.  Each sum
// is taken in a fixed order, as block_sum's; blockDim.x is a multiple of
// 32.
template <typename T, int K>
__device__ __forceinline__ void block_sums(T (&v)[K], T* out, int stride,
                                           int count = K) {
  __shared__ T warp_sums[K][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    T s = v[j];
    for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
    if (lane == 0) warp_sums[j][warp] = s;
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      T s = lane < nwarps ? warp_sums[j][lane] : T(0);
      for (int o = 16; o > 0; o >>= 1) {
        s += __shfl_down_sync(0xffffffffu, s, o);
      }
      if (lane == 0 && j < count) {
        if (stride == 0) {
          out[j] = s;
        } else {
          out[static_cast<long long>(j) * stride + blockIdx.x] = s;
        }
      }
    }
  }
  __syncthreads();
}

// The sums of count rows of per-block partials (row j at
// partial[j * nparts]), each in a fixed order, into out[0 .. count) in
// shared memory, the same values in every block; every thread may read
// them on return.
template <typename T>
__device__ __forceinline__ void sum_partial_rows(const T* partial, int nparts,
                                                 int count, T* out) {
  constexpr int K = 8;
  for (int j0 = 0; j0 < count; j0 += K) {
    T v[K];
#pragma unroll
    for (int j = 0; j < K; ++j) v[j] = T(0);
    for (int i = threadIdx.x; i < nparts; i += blockDim.x) {
#pragma unroll
      for (int j = 0; j < K; ++j) {
        if (j0 + j < count) {
          v[j] += partial[static_cast<long long>(j0 + j) * nparts + i];
        }
      }
    }
    T s[K];
    block_sums<T, K>(v, s, 0);
    if (threadIdx.x == 0) {
      for (int j = 0; j < K && j0 + j < count; ++j) out[j0 + j] = s[j];
    }
    __syncthreads();
  }
}

// The threads of a block of the one-row-a-thread grid whose order the
// wide-row Lanczos stencil's dots keep.
constexpr int kRowBlock = 256;

// The sum block_sum takes over a kRowBlock block whose thread t holds
// v_t, here with v_{threadIdx.x R + r} = c[r] in a block of kRowBlock / R
// threads, stored as D at partial[blockIdx.x]: each group of 32
// consecutive v_t summed by a warp's shuffle tree, then the kRowBlock / 32
// group sums by one more, in block_sum's order, so the bits are those of
// a kRowBlock block.
template <int R, typename T, typename D>
__device__ __forceinline__ void store_spread_partial(const T (&c)[R],
                                                     D* partial) {
  constexpr int kGroups = kRowBlock / 32;
  __shared__ T vals[kRowBlock];
  __shared__ T group_sums[kGroups];
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < R; ++r) vals[threadIdx.x * R + r] = c[r];
  __syncthreads();
  for (int g = threadIdx.x >> 5; g < kGroups; g += blockDim.x >> 5) {
    T v = vals[g * 32 + lane];
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if (lane == 0) group_sums[g] = v;
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    T v = lane < kGroups ? group_sums[lane] : T(0);
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if (lane == 0) partial[blockIdx.x] = static_cast<D>(v);
  }
  __syncthreads();
}

// The rows a thread owns in pair_stencil: two, whatever the types.  The
// dot order fixes the grid at one block per 256 rows a grid stride apart
// (8 blocks an SM at 128^3), so a thread owning 16 bytes of f32 diagonals
// (four rows) left 16 warps an SM; two rows keep 32, as f64 has them
// (PERF.md section 6).
constexpr int kPairRows = 2;

// No row updates beside a pair stencil's products.
struct NoRows {
  __device__ __forceinline__ void operator()(long long, long long) const {}
};

// The pair of products of a Lanczos-type process on the wide rows,
//   q = A xa - cq qm,  p = A^H xh - cp pm,
// each written once, with the block partials of <d, q> (and of <d, d>
// where partial_dd is not null), stored as D.  The two-sided process
// (bilanczos.cuh) takes xa = v_k, xh = u_k, d = u_k; the Saunders-Simon-
// Yip process (ssy.cuh) xa = u_k, xh = v_k, d = v_k; both qm = v_{k-1},
// pm = u_{k-1}.  A block of kRowBlock / R threads walks the kRowBlock-row
// chunks of a kRowBlock-thread block a grid stride apart, each thread R
// consecutive rows of a chunk, always the same R of the chunk, and keeps R
// running sums for them in the order the rows come, those of the
// kRowBlock threads that would own one row each; store_spread_partial
// sums the block's partial in that block's shuffle tree.  So q, p and the
// dots are bit for bit those of a one-row-a-thread grid.  [lo, hi) and
// [lo_a, hi_a) are the interiors of A's and A^H's offsets; with VEC, pd,
// pda and the vectors are 16-byte aligned and n is a multiple of R.
// rows(i0, left) runs the caller's row updates on the thread's R rows
// (left of them below n) after q and p are stored.
template <typename T, typename P, bool VEC, typename D, typename Rows>
__device__ __forceinline__ void pair_stencil(
    const P* __restrict__ pd, const long long* __restrict__ offsets, int nd,
    const P* __restrict__ pda, const long long* __restrict__ offsets_a,
    int nda, long long lo, long long hi, long long lo_a, long long hi_a,
    const T* xa, const T* xh, const T* qm, T cq, const T* pm, T cp,
    const T* d, T* q, T* p, D* partial_dq, D* partial_dd, long long n,
    const Rows& rows) {
  constexpr int R = kPairRows;
  // In f32 the rows read beside the products are loaded before them, in
  // flight with the diagonals; in f64 after them: each order was the
  // faster by 9 to 12 us a call at 128^3 on an H100 (PERF.md section 6).
  constexpr bool kRowsFirst = sizeof(T) == 4;
  __shared__ long long offs[kDiaTile];
  __shared__ long long offs_a[kDiaTile];
  if (nd <= kDiaTile) stage_offsets(offs, offsets, nd);
  if (nda <= kDiaTile) stage_offsets(offs_a, offsets_a, nda);
  __syncthreads();
  const long long stride = static_cast<long long>(gridDim.x) * kRowBlock;
  T sdq[R];
  T sdd[R];
#pragma unroll
  for (int r = 0; r < R; ++r) sdq[r] = sdd[r] = T(0);
  for (long long base = static_cast<long long>(blockIdx.x) * kRowBlock;
       base < n; base += stride) {
    const long long i0 = base + threadIdx.x * R;
    const long long left = n - i0;
    T aq[R];
    T ap[R];
    T qmv[R];
    T pmv[R];
    T dv[R];
#pragma unroll
    for (int r = 0; r < R; ++r) aq[r] = ap[r] = T(0);
    if constexpr (kRowsFirst) {
      if (i0 < n) {
        load_rows<VEC>(qm + i0, left, qmv);
        load_rows<VEC>(pm + i0, left, pmv);
        load_rows<VEC>(d + i0, left, dv);
      }
    }
    dia_rows<R, VEC>(pd, offsets, nd, offs, xa, i0, n, lo, hi, VEC, aq);
    dia_rows<R, VEC>(pda, offsets_a, nda, offs_a, xh, i0, n, lo_a, hi_a, VEC,
                     ap);
    if (i0 < n) {
      if constexpr (!kRowsFirst) {
        load_rows<VEC>(qm + i0, left, qmv);
        load_rows<VEC>(pm + i0, left, pmv);
        load_rows<VEC>(d + i0, left, dv);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        // q = A xa - cq qm as one fused multiply-add
        aq[r] = fused_madd(-cq, qmv[r], aq[r]);
        ap[r] = fused_madd(-cp, pmv[r], ap[r]);
      }
      store_rows<VEC>(q + i0, left, aq);
      store_rows<VEC>(p + i0, left, ap);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r < left) {
          sdq[r] = fused_madd(dv[r], aq[r], sdq[r]);
          sdd[r] = fused_madd(dv[r], dv[r], sdd[r]);
        }
      }
      rows(i0, left);
    }
  }
  store_spread_partial(sdq, partial_dq);
  if (partial_dd != nullptr) store_spread_partial(sdd, partial_dd);
}

}  // namespace ktt
