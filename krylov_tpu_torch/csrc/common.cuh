// Helpers shared by the port's CUDA kernels: element conversions, the
// masked DIA stencil row, and block-wide sums whose order is fixed by the
// grid and block shape alone, so that two runs of a kernel give the same
// bits.
#pragma once

#include <cfloat>
#include <cmath>

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

}  // namespace ktt
