// SELL-C-128 sparse matrix-vector product for Hopper (sm_90a): y = A x for
// the chunked sliced-ELL layout of krylov_tpu_torch/ops/cuda_sell.py, over
// every part of a depth-bucketed matrix in one launch.
//
// Replaces the TPU kernel krylov_tpu/ops/pallas_sell.py:335 sell_spmv
// (pallas_call at :384) and the part sum and un-permuting gather around it
// (pallas_sell.py:324-331, krylov_tpu/ops/hybrid.py:160-177), and computes
// what they compute.  Rows come in slices of 1024 and columns in chunks of
// 128; a (slice, chunk) pair p of a part stores Kmax * 1024 slots, slot
// k * 1024 + r holding the k-th nonzero of row r of the slice in that
// chunk (data[p, k*8 + r/128, r%128]) and its column within the chunk
// (idx, int32, 0..127); padding slots hold 0.  A part's pairs are sorted by
// slice; its slice_ptr[s] is the first pair of slice s (nsl + 1 entries).
//
// The parts live in one set of buffers: data, idx, chunk_of and slice_ptr
// are each the parts' arrays one after another, and the int64 table holds,
// for part b, {data offset (slots), pair offset, slice_ptr offset, Kmax}.
// A plain SELL matrix is a table of one part.
//
// Rounding points are the JAX package's: each part's sum accumulates from
// zero in f32 for f32, bf16 and f16 x and in x's own type otherwise
// (pallas_sell.py:352-353) and is rounded to x's type; the parts are summed
// in x's type in part order (for bf16 and f16 an f32 add rounded back, as
// PyTorch adds them); a sigma-sorted plan's row s is written to original
// row inv[s]; with y_dia (the DIA half of a hybrid product) the result is
// y_dia + that sum in x's type.  So one launch gives, bit for bit, what
// this kernel launched on each part alone followed by PyTorch's adds and
// gather gives.  The (x, data) type pairs are the DIA SpMV's
// (csrc/dia_spmv.cu), so that the two halves of a hybrid product take the
// same pairs.
//
// Bound on an H100 SXM: memory bandwidth.  Every stored slot is read once
// (the element and its 4-byte index), x and y once: at fill 0.13-0.15 the
// slots are 6-8 times the nonzeros, so the layout, not the kernel, sets
// how far this product stays behind a CSR product of the same matrix.
//
// Design: a thread per row, 256 rows (four blocks) per slice, so the grid
// has four times as many blocks as slices.  A thread walks, part by part,
// its slice's slots in pair order and k ascending: for a fixed slot the
// rows of the block lie at consecutive addresses, so the data and idx
// loads coalesce.  They stream (evict-first) in batches of kUnroll slots,
// each batch loaded one batch ahead of its x loads and multiply-adds,
// with each slot's chunk (one address across the block, an L1 hit); x is
// read through the read-only path (its 128 values of a pair are hot in
// L1, the vector in L2).  No shared memory and no barrier.  Offsets that
// address slots are 64-bit.
#include <cstdint>

#include "common.cuh"

namespace {

using namespace ktt;

constexpr int kSlice = 1024;
constexpr int kChunk = 128;
constexpr int kRows = 256;                      // threads (rows) per block
constexpr int kBlocksPerSlice = kSlice / kRows;
constexpr int kUnroll = 4;                      // slots per batch

// A streamed read (evict-first) of a slot.
__device__ __forceinline__ float ld_slot(const float* p) { return __ldcs(p); }
__device__ __forceinline__ double ld_slot(const double* p) { return __ldcs(p); }
__device__ __forceinline__ int ld_slot(const int* p) { return __ldcs(p); }
__device__ __forceinline__ __nv_bfloat16 ld_slot(const __nv_bfloat16* p) {
  return __ldcs(p);
}
__device__ __forceinline__ __half ld_slot(const __half* p) { return __ldcs(p); }
__device__ __forceinline__ complex<float> ld_slot(const complex<float>* p) {
  const float2 v = __ldcs(reinterpret_cast<const float2*>(p));
  return complex<float>(v.x, v.y);
}
__device__ __forceinline__ complex<double> ld_slot(const complex<double>* p) {
  const double2 v = __ldcs(reinterpret_cast<const double2*>(p));
  return complex<double>(v.x, v.y);
}

// A read of x through the read-only data path.
__device__ __forceinline__ float ld_x(const float* p) { return __ldg(p); }
__device__ __forceinline__ double ld_x(const double* p) { return __ldg(p); }
__device__ __forceinline__ __nv_bfloat16 ld_x(const __nv_bfloat16* p) {
  return __ldg(p);
}
__device__ __forceinline__ __half ld_x(const __half* p) { return __ldg(p); }
__device__ __forceinline__ complex<float> ld_x(const complex<float>* p) {
  const float2 v = __ldg(reinterpret_cast<const float2*>(p));
  return complex<float>(v.x, v.y);
}
__device__ __forceinline__ complex<double> ld_x(const complex<double>* p) {
  const double2 v = __ldg(reinterpret_cast<const double2*>(p));
  return complex<double>(v.x, v.y);
}

// a + b in x's type, as PyTorch adds two tensors of that type: bf16 and
// f16 through f32, rounded to nearest even.
__device__ __forceinline__ float add_x(float a, float b) { return a + b; }
__device__ __forceinline__ double add_x(double a, double b) { return a + b; }
__device__ __forceinline__ __nv_bfloat16 add_x(__nv_bfloat16 a,
                                               __nv_bfloat16 b) {
  return __float2bfloat16(__bfloat162float(a) + __bfloat162float(b));
}
__device__ __forceinline__ __half add_x(__half a, __half b) {
  return __float2half(__half2float(a) + __half2float(b));
}
template <typename R>
__device__ __forceinline__ complex<R> add_x(complex<R> a, complex<R> b) {
  return complex<R>(a.re + b.re, a.im + b.im);
}

// kUnroll slots' data, column within the chunk, and chunk.
template <typename DT>
struct Batch {
  DT d[kUnroll];
  int c[kUnroll];
  int ch[kUnroll];
};

// Loads the batch of slots [t, t + kUnroll) together: the pair of a slot
// comes from the counter (k, q), so no load waits on another.
template <typename DT>
__device__ __forceinline__ void load_batch(Batch<DT>& b,
                                           const DT* __restrict__ dp,
                                           const int* __restrict__ ip,
                                           const int* __restrict__ cp,
                                           long long t, int kmax, int& k,
                                           int& q) {
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    b.d[u] = ld_slot(dp + (t + u) * kSlice);
    b.c[u] = ld_slot(ip + (t + u) * kSlice);
    b.ch[u] = __ldg(cp + q);
    if (++k == kmax) {
      k = 0;
      ++q;
    }
  }
}

// Row r's sum over one part's pairs of its slice, from zero, in the
// accumulation type: nslot slots t = (p - p0) * kmax + k, in order.  Each
// batch is loaded one batch ahead of its x loads and multiply-adds; the
// last nslot % kUnroll slots go one by one.
template <typename XT, typename DT, typename AT>
__device__ __forceinline__ AT part_row(const DT* __restrict__ dp,
                                       const int* __restrict__ ip,
                                       const int* __restrict__ cp,
                                       long long nslot, int kmax,
                                       const XT* __restrict__ x, long long n) {
  AT acc = AT(0);
  const XT zero = narrow<XT>(0.0f);
  int k = 0;                                  // k of the next slot to load
  int q = 0;                                  // its pair, from p0
  const long long full = nslot - nslot % kUnroll;
  if (full > 0) {
    Batch<DT> cur;
    load_batch(cur, dp, ip, cp, 0, kmax, k, q);
    for (long long t = 0; t < full; t += kUnroll) {
      Batch<DT> nxt;
      const bool more = t + kUnroll < full;
      if (more) load_batch(nxt, dp, ip, cp, t + kUnroll, kmax, k, q);
      XT xv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long col = static_cast<long long>(cur.ch[u]) * kChunk
            + cur.c[u];
        xv[u] = col < n ? ld_x(x + col) : zero;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) acc = madd(acc, cur.d[u], xv[u]);
      if (more) cur = nxt;
    }
  }
  for (long long t = full; t < nslot; ++t) {
    const DT d = ld_slot(dp + t * kSlice);
    const long long col = static_cast<long long>(__ldg(cp + q)) * kChunk
        + ld_slot(ip + t * kSlice);
    acc = madd(acc, d, col < n ? ld_x(x + col) : zero);
    if (++k == kmax) {
      k = 0;
      ++q;
    }
  }
  return acc;
}

template <typename XT, typename DT, typename AT>
__global__ void __launch_bounds__(kRows)
sell_spmv_kernel(const DT* __restrict__ data, const int* __restrict__ idx,
                 const int* __restrict__ chunk_of,
                 const int* __restrict__ slice_ptr,
                 const long long* __restrict__ table, int nparts,
                 const int* __restrict__ inv, const XT* __restrict__ x,
                 const XT* __restrict__ y_dia, XT* __restrict__ y,
                 long long m, long long n) {
  const int s = blockIdx.x / kBlocksPerSlice;
  const int r = (blockIdx.x % kBlocksPerSlice) * kRows + threadIdx.x;
  const long long row = static_cast<long long>(s) * kSlice + r;
  if (row >= m) return;
  XT out = narrow<XT>(0.0f);
  for (int b = 0; b < nparts; ++b) {
    const long long doff = __ldg(table + 4 * b);
    const long long poff = __ldg(table + 4 * b + 1);
    const long long soff = __ldg(table + 4 * b + 2);
    const int kmax = static_cast<int>(__ldg(table + 4 * b + 3));
    const int p0 = __ldg(slice_ptr + soff + s);
    const int p1 = __ldg(slice_ptr + soff + s + 1);
    const long long first = doff + static_cast<long long>(p0) * kmax * kSlice
        + r;
    const XT part = narrow<XT>(part_row<XT, DT, AT>(
        data + first, idx + first, chunk_of + poff + p0,
        static_cast<long long>(p1 - p0) * kmax, kmax, x, n));
    out = b == 0 ? part : add_x(out, part);
  }
  const long long orow = inv != nullptr ? static_cast<long long>(inv[row])
                                        : row;
  if (y_dia != nullptr) out = add_x(y_dia[orow], out);
  y[orow] = out;
}

template <typename XT, typename DT, typename AT>
int launch(const void* data, const void* idx, const void* chunk_of,
           const void* slice_ptr, const void* table, int nparts,
           const void* inv, const void* x, const void* y_dia, void* y,
           int nsl, long long m, long long n, void* stream) {
  if (m > 0 && nsl > 0) {
    sell_spmv_kernel<XT, DT, AT><<<nsl * kBlocksPerSlice, kRows, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
        static_cast<const DT*>(data), static_cast<const int*>(idx),
        static_cast<const int*>(chunk_of), static_cast<const int*>(slice_ptr),
        static_cast<const long long*>(table), nparts,
        static_cast<const int*>(inv), static_cast<const XT*>(x),
        static_cast<const XT*>(y_dia), static_cast<XT*>(y), m, n);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// (data, idx, chunk_of, slice_ptr, table, nparts, inv, x, y_dia, y, nsl, m,
// n, stream) for one (x type, data type, accumulator type); inv and y_dia
// may be null.
#define KTT_SELL_SPMV(NAME, XT, DT, AT)                                       \
  extern "C" int NAME(const void* data, const void* idx,                     \
                      const void* chunk_of, const void* slice_ptr,           \
                      const void* table, int nparts, const void* inv,        \
                      const void* x, const void* y_dia, void* y, int nsl,    \
                      long long m, long long n, void* stream) {              \
    return launch<XT, DT, AT>(data, idx, chunk_of, slice_ptr, table, nparts, \
                              inv, x, y_dia, y, nsl, m, n, stream);          \
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
