// Block-ELL SpMV and SpMM on Hopper (sm_90a): y = A x and Y = A X for a
// matrix of dense bs x bs blocks, nbr block rows of mbpr slots each
// (data (nbr, mbpr, bs, bs), row-major blocks; block column indices
// (nbr, mbpr) int32; a padding slot holds zeros).
//
// Replaces the TPU kernels krylov_tpu/ops/pallas_spmv.py:172 bell_spmv
// and :236 bell_spmm and computes what they compute: for each block row
// i, the sum over its slots k of data[i, k] times the bs-row segment of x
// (of X's p columns) that idx[i, k] names, rows of x past its end read as
// 0, and rows of y past m not written.  The sum accumulates in f32 for
// f32, bf16 and f16 data, and in the data's own type for f64, complex64
// and complex128 (pallas_spmv.py:205-206), one slot after another, each
// block's columns in order.
//
// Bound on an H100 SXM: memory bandwidth.  The blocks are read once
// (nbr mbpr bs^2 elements), x and y once: for p <= 8 this design reads
// each block once; wider panels go in tiles of 8 columns, one grid row
// of blocks each, and read the blocks once per tile.
//
// Design.  One thread block per (block row, tile of at most 8 columns),
// 128 threads, a thread per output row (rows past 128 in further
// passes).  A thread that walked its row of a row-major block in global
// memory would touch addresses bs apart, so the block is staged instead:
// for each slot and each chunk of CT columns, the threads load the
// 128 x CT chunk of the block into shared memory row by row (each warp
// reads CT consecutive elements of a row) and the CT x 8 segment of x
// beside it, the block column index read by the block itself; then each
// thread takes its row of the chunk against the segment.  The chunk's
// rows are padded by one element, so the threads of a warp read distinct
// banks.
#include "common.cuh"

namespace {

using namespace ktt;

constexpr int kThreads = 128;
constexpr int kCols = 8;

template <typename S> struct Acc { using type = S; };
template <> struct Acc<__nv_bfloat16> { using type = float; };
template <> struct Acc<__half> { using type = float; };

template <typename S, int CT>
__global__ void __launch_bounds__(kThreads)
bell_kernel(const S* __restrict__ data, const int* __restrict__ idx,
            const S* __restrict__ x, S* __restrict__ y, int mbpr, int bs,
            long long m, long long n, int p) {
  using A = typename Acc<S>::type;
  // raw storage: a __shared__ array of a class type (complex) may not
  // have a constructor
  __shared__ __align__(16) unsigned char tile_raw[kThreads * (CT + 1)
                                                  * sizeof(S)];
  __shared__ __align__(16) unsigned char xs_raw[CT * kCols * sizeof(S)];
  S(*tile)[CT + 1] = reinterpret_cast<S(*)[CT + 1]>(tile_raw);
  S(*xs)[kCols] = reinterpret_cast<S(*)[kCols]>(xs_raw);
  const S zero = narrow<S>(0.0f);
  const long long i = blockIdx.x;
  const int c_base = blockIdx.y * kCols;
  const int pc = min(kCols, p - c_base);
  for (int r0 = 0; r0 < bs; r0 += kThreads) {
    const int nr = min(kThreads, bs - r0);
    A acc[kCols];
#pragma unroll
    for (int b = 0; b < kCols; ++b) acc[b] = A(0);
    for (int k = 0; k < mbpr; ++k) {
      const long long j = idx[i * mbpr + k];
      const S* blk = data + (i * mbpr + k) * bs * static_cast<long long>(bs);
      for (int c0 = 0; c0 < bs; c0 += CT) {
        const int nc = min(CT, bs - c0);
        __syncthreads();
        for (int e = threadIdx.x; e < kThreads * CT; e += kThreads) {
          const int rr = e / CT;
          const int cc = e % CT;
          tile[rr][cc] = (rr < nr && cc < nc)
              ? blk[static_cast<long long>(r0 + rr) * bs + c0 + cc] : zero;
        }
        for (int e = threadIdx.x; e < CT * kCols; e += kThreads) {
          const int cc = e / kCols;
          const int b = e % kCols;
          const long long row = j * bs + c0 + cc;
          xs[cc][b] = (cc < nc && b < pc && row < n)
              ? x[row * p + c_base + b] : zero;
        }
        __syncthreads();
        if (static_cast<int>(threadIdx.x) < nr) {
          for (int cc = 0; cc < nc; ++cc) {
            const S a = tile[threadIdx.x][cc];
#pragma unroll
            for (int b = 0; b < kCols; ++b) {
              acc[b] = madd(acc[b], a, xs[cc][b]);
            }
          }
        }
      }
    }
    const long long row = i * bs + r0 + threadIdx.x;
    if (static_cast<int>(threadIdx.x) < nr && row < m) {
      for (int b = 0; b < pc; ++b) {
        y[row * p + c_base + b] = narrow<S>(acc[b]);
      }
    }
  }
}

template <typename S, int CT>
int launch(const void* data, const void* idx, const void* x, void* y,
           int nbr, int mbpr, int bs, long long m, long long n, int p,
           void* stream) {
  if (nbr <= 0 || p <= 0) return static_cast<int>(cudaSuccess);
  const dim3 grid(nbr, (p + kCols - 1) / kCols);
  bell_kernel<S, CT><<<grid, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const S*>(data), static_cast<const int*>(idx),
      static_cast<const S*>(x), static_cast<S*>(y), mbpr, bs, m, n, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// (data, idx, x, y, nbr, mbpr, bs, m, n, stream) and the same with p
// before the stream; CT columns per staged chunk (16 for complex128, so
// that the chunk fits 48 KB of shared memory).
#define KTT_BELL(SPMV, SPMM, S, CT)                                           \
  extern "C" int SPMV(const void* data, const void* idx, const void* x,      \
                      void* y, int nbr, int mbpr, int bs, long long m,       \
                      long long n, void* stream) {                           \
    return launch<S, CT>(data, idx, x, y, nbr, mbpr, bs, m, n, 1, stream);  \
  }                                                                          \
  extern "C" int SPMM(const void* data, const void* idx, const void* x,      \
                      void* y, int nbr, int mbpr, int bs, long long m,       \
                      long long n, int p, void* stream) {                    \
    return launch<S, CT>(data, idx, x, y, nbr, mbpr, bs, m, n, p, stream);  \
  }

KTT_BELL(ktt_bell_spmv_f32, ktt_bell_spmm_f32, float, 32)
KTT_BELL(ktt_bell_spmv_f64, ktt_bell_spmm_f64, double, 32)
KTT_BELL(ktt_bell_spmv_bf16, ktt_bell_spmm_bf16, __nv_bfloat16, 32)
KTT_BELL(ktt_bell_spmv_f16, ktt_bell_spmm_f16, __half, 32)
KTT_BELL(ktt_bell_spmv_c64, ktt_bell_spmm_c64, complex<float>, 32)
KTT_BELL(ktt_bell_spmv_c128, ktt_bell_spmm_c128, complex<double>, 16)
