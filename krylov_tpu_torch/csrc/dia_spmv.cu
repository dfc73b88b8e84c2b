// DIA sparse matrix-vector products for Hopper (sm_90a).
//
//   y[i] = sum_d pd[d, i] * x[i + k_d]
//
// pd holds output-aligned diagonals, pd[d, i] = data[d, i + k_d] and 0
// where i + k_d lies outside [0, n) (krylov_tpu_torch/ops/cuda_dia.py
// dia_align).  Two kernels:
//
// * dia_spmv_kernel replaces the TPU kernel krylov_tpu/ops/pallas_dia.py:105
//   dia_spmv_pallas: y = A x on plain vectors of length n.
// * dia_spmv_padded_kernel replaces pallas_dia.py:226 dia_spmv_padded: the
//   same product in the padded, chainable layout of cuda_dia.py
//   dia_pad_layout, a vector of length n + 2 h whose interior is rows
//   [h, h + n).  The halo rows are don't-care: every read of x is masked
//   against the interior, so a halo full of NaN never reaches y, and only
//   the interior of y is written, so y chains into the next product as it
//   is.
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
// works.  The accumulator follows x's type as pallas_dia.py:165-166 does:
// f32 for f32, bf16 and f16 x (the result is rounded to x's type), f64
// for f64, and complex for complex x, whose diagonals are real or complex
// of the same precision.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename XT, typename PT, typename AT>
__global__ void __launch_bounds__(kThreads)
dia_spmv_kernel(const PT* __restrict__ pd, const long long* __restrict__ offsets,
                int nd, const XT* __restrict__ x, XT* __restrict__ y,
                long long n) {
  for (long long i = ktt::first_row(); i < n; i += ktt::row_stride()) {
    y[i] = ktt::narrow<XT>(ktt::stencil_row_acc<AT>(pd, offsets, nd, x, i, n));
  }
}

// The interior of yw from the interior of xw; the halo of xw is never
// read and the halo of yw is never written.
template <typename XT, typename PT, typename AT>
__global__ void __launch_bounds__(kThreads)
dia_spmv_padded_kernel(const PT* __restrict__ pd,
                       const long long* __restrict__ offsets, int nd,
                       const XT* __restrict__ xw, XT* __restrict__ yw,
                       long long n, long long halo) {
  const XT* __restrict__ x = xw + halo;
  XT* __restrict__ y = yw + halo;
  for (long long i = ktt::first_row(); i < n; i += ktt::row_stride()) {
    y[i] = ktt::narrow<XT>(ktt::stencil_row_acc<AT>(pd, offsets, nd, x, i, n));
  }
}

unsigned blocks_for(long long n) {
  long long blocks = (n + kThreads - 1) / kThreads;
  return static_cast<unsigned>(blocks > 0x7fffffffLL ? 0x7fffffffLL : blocks);
}

template <typename XT, typename PT, typename AT>
int launch(const void* pd, const void* offsets, int nd, const void* x, void* y,
           long long n, void* stream) {
  if (n > 0) {
    dia_spmv_kernel<XT, PT, AT><<<blocks_for(n), kThreads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
        static_cast<const PT*>(pd), static_cast<const long long*>(offsets), nd,
        static_cast<const XT*>(x), static_cast<XT*>(y), n);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename XT, typename PT, typename AT>
int launch_padded(const void* pd, const void* offsets, int nd, const void* xw,
                  void* yw, long long n, long long halo, void* stream) {
  if (n > 0) {
    dia_spmv_padded_kernel<XT, PT, AT><<<blocks_for(n), kThreads, 0,
                                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const PT*>(pd), static_cast<const long long*>(offsets), nd,
        static_cast<const XT*>(xw), static_cast<XT*>(yw), n, halo);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The plain and the padded entry point of one (x type, diagonal type,
// accumulator type).
#define KTT_DIA_SPMV(NAME, PADDED, XT, PT, AT)                                \
  extern "C" int NAME(const void* pd, const void* offsets, int nd,           \
                      const void* x, void* y, long long n, void* stream) {   \
    return launch<XT, PT, AT>(pd, offsets, nd, x, y, n, stream);             \
  }                                                                          \
  extern "C" int PADDED(const void* pd, const void* offsets, int nd,         \
                        const void* xw, void* yw, long long n,               \
                        long long halo, void* stream) {                      \
    return launch_padded<XT, PT, AT>(pd, offsets, nd, xw, yw, n, halo,       \
                                     stream);                                \
  }

using c64 = ktt::complex<float>;
using c128 = ktt::complex<double>;

KTT_DIA_SPMV(ktt_dia_spmv_f32_f32, ktt_dia_spmv_padded_f32_f32, float, float,
             float)
KTT_DIA_SPMV(ktt_dia_spmv_f32_bf16, ktt_dia_spmv_padded_f32_bf16, float,
             __nv_bfloat16, float)
KTT_DIA_SPMV(ktt_dia_spmv_f32_f16, ktt_dia_spmv_padded_f32_f16, float, __half,
             float)
KTT_DIA_SPMV(ktt_dia_spmv_f64_f64, ktt_dia_spmv_padded_f64_f64, double,
             double, double)
KTT_DIA_SPMV(ktt_dia_spmv_f64_f32, ktt_dia_spmv_padded_f64_f32, double, float,
             double)
KTT_DIA_SPMV(ktt_dia_spmv_bf16_bf16, ktt_dia_spmv_padded_bf16_bf16,
             __nv_bfloat16, __nv_bfloat16, float)
KTT_DIA_SPMV(ktt_dia_spmv_f16_f16, ktt_dia_spmv_padded_f16_f16, __half,
             __half, float)
KTT_DIA_SPMV(ktt_dia_spmv_c64_f32, ktt_dia_spmv_padded_c64_f32, c64, float,
             c64)
KTT_DIA_SPMV(ktt_dia_spmv_c64_c64, ktt_dia_spmv_padded_c64_c64, c64, c64, c64)
KTT_DIA_SPMV(ktt_dia_spmv_c128_f64, ktt_dia_spmv_padded_c128_f64, c128,
             double, c128)
KTT_DIA_SPMV(ktt_dia_spmv_c128_c128, ktt_dia_spmv_padded_c128_c128, c128,
             c128, c128)

// The message of a CUDA error code returned by an entry point of the
// library.
extern "C" const char* ktt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
