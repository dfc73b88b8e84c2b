// SELL-C-128 sparse matrix-vector product for Hopper (sm_90a): y = A x for
// the chunked sliced-ELL layout of krylov_tpu_torch/ops/cuda_sell.py.
//
// Replaces the TPU kernel krylov_tpu/ops/pallas_sell.py:335 sell_spmv
// (pallas_call at :384) and computes what it computes.  Rows come in
// slices of 1024 and columns in chunks of 128; a (slice, chunk) pair p
// stores Kmax * 1024 slots, slot k * 1024 + r holding the k-th nonzero of
// row r of the slice in that chunk (data[p, k*8 + r/128, r%128]) and its
// column within the chunk (idx, int32, 0..127); padding slots hold 0.
// Pairs are sorted by slice; slice_ptr[s] is the first pair of slice s
// (slice_ptr has nsl + 1 entries).  A slice that owns no pair (an
// uncovered part, pallas_sell.py:389-392) gets zeros.  The sum
// accumulates in f32 for f32, bf16 and f16 x and in x's own type
// otherwise (pallas_sell.py:352-353); y is rounded to x's type.  The
// (x, data) type pairs are the DIA SpMV's (csrc/dia_spmv.cu), so that the
// two halves of a hybrid product take the same pairs.
//
// Bound on an H100 SXM: memory bandwidth.  Every stored slot is read once
// (the element and its 4-byte index), x and y once: at fill 0.13-0.15 the
// slots are 6-8 times the nonzeros, so the layout, not the kernel, sets
// how far this product stays behind a CSR product of the same matrix.
//
// Design: one thread block per slice, a thread per row (1024 threads).
// The Pallas kernel runs one grid step per pair and carries the slice's
// sum in VMEM; here the block walks its own pair range instead, so no sum
// crosses blocks, there are no atomics, and every row of y is written
// exactly once, by its own thread.  For each pair the first 128 threads
// stage the pair's 128 x values in shared memory (zeros past n); then each
// thread reads its Kmax slots, which for a fixed k lie at consecutive
// addresses across the block, so the loads of data and idx coalesce, and
// gathers x from shared memory by the lane index.  Indices are 64-bit
// where they address data.
#include "common.cuh"

namespace {

using namespace ktt;

constexpr int kSlice = 1024;
constexpr int kChunk = 128;

template <typename XT, typename DT, typename AT>
__global__ void __launch_bounds__(kSlice)
sell_spmv_kernel(const DT* __restrict__ data, const int* __restrict__ idx,
                 const int* __restrict__ chunk_of,
                 const int* __restrict__ slice_ptr, const XT* __restrict__ x,
                 XT* __restrict__ y, int kmax, long long m, long long n) {
  // raw storage: a __shared__ array of a class type (complex) may not have
  // a constructor
  __shared__ __align__(16) unsigned char xs_raw[kChunk * sizeof(XT)];
  XT* xs = reinterpret_cast<XT*>(xs_raw);
  const int r = threadIdx.x;
  const int p0 = slice_ptr[blockIdx.x];
  const int p1 = slice_ptr[blockIdx.x + 1];
  const long long pair_slots = static_cast<long long>(kmax) * kSlice;
  AT acc = AT(0);
  for (int p = p0; p < p1; ++p) {
    __syncthreads();                    // the last pair's reads are done
    if (r < kChunk) {
      const long long j = static_cast<long long>(chunk_of[p]) * kChunk + r;
      xs[r] = j < n ? x[j] : narrow<XT>(0.0f);
    }
    __syncthreads();
    const DT* __restrict__ dp = data + p * pair_slots + r;
    const int* __restrict__ ip = idx + p * pair_slots + r;
#pragma unroll 4
    for (int k = 0; k < kmax; ++k) {
      acc = madd(acc, dp[k * kSlice], xs[ip[k * kSlice]]);
    }
  }
  const long long row = static_cast<long long>(blockIdx.x) * kSlice + r;
  if (row < m) y[row] = narrow<XT>(acc);
}

template <typename XT, typename DT, typename AT>
int launch(const void* data, const void* idx, const void* chunk_of,
           const void* slice_ptr, const void* x, void* y, int kmax, int nsl,
           long long m, long long n, void* stream) {
  if (m > 0 && nsl > 0) {
    sell_spmv_kernel<XT, DT, AT><<<nsl, kSlice, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
        static_cast<const DT*>(data), static_cast<const int*>(idx),
        static_cast<const int*>(chunk_of), static_cast<const int*>(slice_ptr),
        static_cast<const XT*>(x), static_cast<XT*>(y), kmax, m, n);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// (data, idx, chunk_of, slice_ptr, x, y, kmax, nsl, m, n, stream) for one
// (x type, data type, accumulator type).
#define KTT_SELL_SPMV(NAME, XT, DT, AT)                                       \
  extern "C" int NAME(const void* data, const void* idx,                     \
                      const void* chunk_of, const void* slice_ptr,           \
                      const void* x, void* y, int kmax, int nsl, long long m, \
                      long long n, void* stream) {                           \
    return launch<XT, DT, AT>(data, idx, chunk_of, slice_ptr, x, y, kmax,    \
                              nsl, m, n, stream);                            \
  }

using c64 = ktt::complex<float>;
using c128 = ktt::complex<double>;

KTT_SELL_SPMV(ktt_sell_spmv_f32_f32, float, float, float)
KTT_SELL_SPMV(ktt_sell_spmv_f32_bf16, float, __nv_bfloat16, float)
KTT_SELL_SPMV(ktt_sell_spmv_f32_f16, float, __half, float)
KTT_SELL_SPMV(ktt_sell_spmv_f64_f64, double, double, double)
KTT_SELL_SPMV(ktt_sell_spmv_f64_f32, double, float, double)
KTT_SELL_SPMV(ktt_sell_spmv_bf16_bf16, __nv_bfloat16, __nv_bfloat16, float)
KTT_SELL_SPMV(ktt_sell_spmv_f16_f16, __half, __half, float)
KTT_SELL_SPMV(ktt_sell_spmv_c64_f32, c64, float, c64)
KTT_SELL_SPMV(ktt_sell_spmv_c64_c64, c64, c64, c64)
KTT_SELL_SPMV(ktt_sell_spmv_c128_f64, c128, double, c128)
KTT_SELL_SPMV(ktt_sell_spmv_c128_c128, c128, c128, c128)
