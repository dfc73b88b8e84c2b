// DIA sparse matrix-vector products for Hopper (sm_90a).
//
//   y[i] = sum_d pd[d, i] * x[i + k_d]
//
// pd holds output-aligned diagonals, pd[d, i] = data[d, i + k_d] and 0
// where i + k_d lies outside [0, n) (krylov_tpu_torch/ops/cuda_dia.py
// dia_align).  One kernel, two entry points:
//
// * ktt_dia_spmv_* replaces the TPU kernel krylov_tpu/ops/pallas_dia.py:105
//   dia_spmv_pallas: y = A x on plain vectors of length n.
// * ktt_dia_spmv_padded_* replaces pallas_dia.py:226 dia_spmv_padded: the
//   same product in the padded, chainable layout of cuda_dia.py
//   dia_pad_layout, a vector of length n + 2 h whose interior is rows
//   [h, h + n).  It runs the kernel on the interiors: every read of x is
//   masked against the interior, so a halo full of NaN never reaches y,
//   and only the interior of y is written, so y chains into the next
//   product as it is.
//
// Bound on an H100 SXM: memory bandwidth.  One pass moves pd once, x
// once and y once: (7*4 + 4 + 4) B per row for the 7-point stencil in
// f32, 75.5 MB at 128^3, so at least 22.5 us at 3.35 TB/s.  Two flops per
// stored entry is far below the card's compute rate.
//
// Design: a thread owns R = 16 / sizeof(pd element) consecutive rows, so
// each diagonal's R entries of pd are one 16-byte load and the R outputs
// one or two 16-byte stores, where pd, y and n are aligned for it (a
// scalar path otherwise).  The offsets are staged in shared memory once
// per block.  Rows whose every neighbour i + k_d lies in [0, n) -- the
// interior [lo, hi), computed on the host from the offsets -- take a path
// with no bounds branch, several diagonals' loads in flight, and x read
// 16 bytes at a time where i + k_d is a multiple of R and x is aligned;
// the rows outside it mask each read of x, so nothing is loaded past
// either end of x (common.cuh dia_rows, which the two-sided stencil of
// bilanczos.cuh shares).  Index math is 32-bit where nd * n and n + max|k_d|
// stay below 2^31, 64-bit otherwise.  Each row sums its diagonals in
// order, skipping those that leave [0, n), in the accumulation type of
// pallas_dia.py:165-166: f32 for f32, bf16 and f16 x (the result is
// rounded to x's type), f64 for f64, and complex for complex x, whose
// diagonals are real or complex of the same precision.
#include "common.cuh"

namespace {

using namespace ktt;

constexpr int kThreads = 256;

template <typename XT, typename PT, typename AT, typename IT, bool VEC>
__global__ void __launch_bounds__(kThreads)
dia_spmv_kernel(const PT* __restrict__ pd,
                const long long* __restrict__ offsets, int nd,
                const XT* __restrict__ x, XT* __restrict__ y, IT n, IT lo,
                IT hi, int x_aligned) {
  constexpr int R = rows_per_thread<PT>();
  __shared__ IT offs[kDiaTile];
  const IT i0 = (static_cast<IT>(blockIdx.x) * kThreads + threadIdx.x) * R;
  AT acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = AT(0);
  if (nd <= kDiaTile) {
    stage_offsets(offs, offsets, nd);
    __syncthreads();
  }
  dia_rows<R, VEC>(pd, offsets, nd, offs, x, i0, n, lo, hi, x_aligned != 0,
                   acc);
  if (i0 >= n) return;
  XT out[R];
#pragma unroll
  for (int r = 0; r < R; ++r) out[r] = narrow<XT>(acc[r]);
  if (VEC && i0 + R <= n) {
    st_vec(y + i0, out);
  } else {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (i0 + r < n) y[i0 + r] = out[r];
    }
  }
}

template <typename XT, typename PT, typename AT, typename IT, bool VEC>
void run(unsigned blocks, cudaStream_t stream, const void* pd,
         const void* offsets, int nd, const void* x, void* y, long long n,
         long long lo, long long hi, int x_aligned) {
  dia_spmv_kernel<XT, PT, AT, IT, VEC><<<blocks, kThreads, 0, stream>>>(
      static_cast<const PT*>(pd), static_cast<const long long*>(offsets), nd,
      static_cast<const XT*>(x), static_cast<XT*>(y), static_cast<IT>(n),
      static_cast<IT>(lo), static_cast<IT>(hi), x_aligned);
}

// y = A x on vectors of length n; [lo, hi) is the interior and kabs the
// largest |k_d| (cuda_dia.py _interior).
template <typename XT, typename PT, typename AT>
int launch(const void* pd, const void* offsets, int nd, const void* x,
           void* y, long long n, long long lo, long long hi, long long kabs,
           void* stream) {
  if (n > 0) {
    constexpr int R = rows_per_thread<PT>();
    constexpr long long kSpan = static_cast<long long>(R) * kThreads;
    const long long blocks = (n + kSpan - 1) / kSpan;
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    const bool vec = n % R == 0 && aligned16(pd) && aligned16(y);
    const int x_aligned = aligned16(x) ? 1 : 0;
    const long long lim = (1LL << 31) - 2 * kSpan;
    const bool narrow_idx = static_cast<long long>(nd) * n < lim
        && n + kabs < lim;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const unsigned b = static_cast<unsigned>(blocks);
    if (narrow_idx) {
      if (vec) run<XT, PT, AT, int, true>(b, st, pd, offsets, nd, x, y, n, lo,
                                          hi, x_aligned);
      else run<XT, PT, AT, int, false>(b, st, pd, offsets, nd, x, y, n, lo,
                                       hi, x_aligned);
    } else {
      if (vec) run<XT, PT, AT, long long, true>(b, st, pd, offsets, nd, x, y,
                                                n, lo, hi, x_aligned);
      else run<XT, PT, AT, long long, false>(b, st, pd, offsets, nd, x, y, n,
                                             lo, hi, x_aligned);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The plain and the padded entry point of one (x type, diagonal type,
// accumulator type).  The padded one runs the product on the interiors,
// rows [halo, halo + n) of xw and yw.
#define KTT_DIA_SPMV(NAME, PADDED, XT, PT, AT)                                \
  extern "C" int NAME(const void* pd, const void* offsets, int nd,           \
                      const void* x, void* y, long long n, long long lo,     \
                      long long hi, long long kabs, void* stream) {          \
    return launch<XT, PT, AT>(pd, offsets, nd, x, y, n, lo, hi, kabs,        \
                              stream);                                       \
  }                                                                          \
  extern "C" int PADDED(const void* pd, const void* offsets, int nd,         \
                        const void* xw, void* yw, long long n,               \
                        long long halo, long long lo, long long hi,          \
                        long long kabs, void* stream) {                      \
    return launch<XT, PT, AT>(pd, offsets, nd,                               \
                              static_cast<const XT*>(xw) + halo,             \
                              static_cast<XT*>(yw) + halo, n, lo, hi, kabs,  \
                              stream);                                       \
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
