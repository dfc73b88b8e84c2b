// DIA sparse matrix-vector product for Hopper (sm_90a).
//
//   y[i] = sum_d pd[d, i] * x[i + k_d]
//
// pd holds output-aligned diagonals, pd[d, i] = data[d, i + k_d] and 0
// where i + k_d lies outside [0, n) (krylov_tpu_torch/ops/cuda_dia.py
// dia_align).  Replaces the TPU kernel krylov_tpu/ops/pallas_dia.py:105
// dia_spmv_pallas.
//
// Bound on an H100 SXM: memory bandwidth.  One pass moves pd once, x
// once and y once: (7*4 + 4 + 4) B per row for the 7-point stencil in
// f32, 75.5 MB at 128^3, so at least 22.5 us at 3.35 TB/s.  Two flops per
// stored entry is far below the card's compute rate.
//
// Design: one thread per row, grid-stride, so neighbouring threads read
// neighbouring addresses of pd, x and y and every load coalesces; the
// x[i + k] reads of the near diagonals hit in L1/L2.  The TPU kernel's
// zero-copy path reads clamped out-of-range rows and relies on pd being
// 0 there; here the read of x[i + k] is masked instead, so nothing is
// ever loaded past either end of x.  Row and diagonal indices are 64-bit.
// The offsets come as a device int64 array, so any number of diagonals
// works.  Accumulation is in f32 for f32/bf16/f16 diagonals with f32 x,
// and in f64 for f64 (as pallas_dia.py:165-166).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename XT, typename PT>
__global__ void __launch_bounds__(kThreads)
dia_spmv_kernel(const PT* __restrict__ pd, const long long* __restrict__ offsets,
                int nd, const XT* __restrict__ x, XT* __restrict__ y,
                long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    y[i] = ktt::stencil_row(pd, offsets, nd, x, i, n);
  }
}

template <typename XT, typename PT>
int launch(const void* pd, const void* offsets, int nd, const void* x, void* y,
           long long n, void* stream) {
  if (n > 0) {
    long long blocks = (n + kThreads - 1) / kThreads;
    if (blocks > 0x7fffffffLL) blocks = 0x7fffffffLL;
    dia_spmv_kernel<XT, PT><<<static_cast<unsigned>(blocks), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const PT*>(pd), static_cast<const long long*>(offsets), nd,
        static_cast<const XT*>(x), static_cast<XT*>(y), n);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define KTT_DIA_SPMV(NAME, XT, PT)                                           \
  extern "C" int NAME(const void* pd, const void* offsets, int nd,          \
                      const void* x, void* y, long long n, void* stream) {  \
    return launch<XT, PT>(pd, offsets, nd, x, y, n, stream);                 \
  }

KTT_DIA_SPMV(ktt_dia_spmv_f32_f32, float, float)
KTT_DIA_SPMV(ktt_dia_spmv_f32_bf16, float, __nv_bfloat16)
KTT_DIA_SPMV(ktt_dia_spmv_f32_f16, float, __half)
KTT_DIA_SPMV(ktt_dia_spmv_f64_f64, double, double)

// The message of a CUDA error code returned by an entry point above.
extern "C" const char* ktt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
