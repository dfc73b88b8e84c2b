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
// over d in order.  The read of x is masked, so nothing is loaded past
// either end of x; row and diagonal indices are 64-bit.
template <typename T, typename P>
__device__ __forceinline__ T stencil_row(const P* __restrict__ pd,
                                         const long long* __restrict__ offsets,
                                         int nd, const T* __restrict__ x,
                                         long long i, long long n) {
  T acc = T(0);
  for (int d = 0; d < nd; ++d) {
    const long long j = i + __ldg(offsets + d);
    if (j >= 0 && j < n) {
      acc += widen<T>(pd[static_cast<long long>(d) * n + i]) * x[j];
    }
  }
  return acc;
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

}  // namespace ktt
