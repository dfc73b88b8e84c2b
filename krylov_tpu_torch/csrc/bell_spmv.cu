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
// and complex128 (pallas_spmv.py:205-206).
//
// Bound on an H100 SXM: bytes.  The blocks and their indices are read
// once, x and y once (nbr mbpr bs^2 elements of blocks against 2 flops
// an element per column); the card's floating-point rate is far above
// what that traffic asks for.  For p <= 8 each block is read once; wider
// panels go in tiles of 8 columns, one grid row of thread blocks each,
// and read the blocks once per tile.
//
// Design: bytes in flight.  A thread block owns a slab of R consecutive
// rows of one block row (R rows of bs elements are one contiguous run of
// each block) and one tile of P columns, P in {1, 2, 4, 8} chosen by the
// host from p, so that the grid runs nbr x ceil(bs / R) x ceil(p / P)
// thread blocks and fills the card at small nbr.  The block walks the
// block row's slots through a ring of two shared-memory stages: each
// stage holds the slot's R x bs slab and the P columns of the bs-row
// segment of x it multiplies, each column as one row of the stage,
// copied by cp.async (cp.async.cg, past the L1, 16 bytes a thread for the
// slab) while the other stage is multiplied, so that one slab is in
// flight per block and several blocks per SM (the host sizes R so that
// they fit).  Shapes whose rows are not whole 16-byte words, or whose
// data or x are not 16-byte aligned, take the scalar-copy variant of the
// same kernel: element copies by cp.async of 4, 8 or 16 bytes (plain
// loads for 2-byte types) into the same stages.  The segment of x goes
// in by 16-byte copies where it is one run of whole words (p = 1, in
// range); otherwise element by element, P > 1 transposed into its column
// rows, missing rows and columns zero-filled.  Every row of a stage is
// padded to an odd number of 16-byte words, so that threads reading 16
// bytes of distinct rows hit distinct banks; the columns between bs and
// the next whole word are zeroed once, so every read is a 16-byte word.
// Shared memory serves a warp's 16-byte reads at 128 bytes a cycle
// whatever the threads share, so each word read should feed several
// multiply-adds: a thread owns a tile of outputs, 2 rows (half a slab
// apart) by 4 columns for P = 8, 2 x 2 for P = 4, 1 x 2 for P = 2, one
// output for P = 1, and reads 16 bytes of each of its slab rows and
// column rows at a time.  To keep enough warps on an SM whose shared
// memory holds only a few slabs, the host's plan splits each tile's sum
// over G lanes of a warp (G a power of two, "parts"): lane g takes the
// words g, g + G, g + 2G, ... of the rows.
//
// Sum order: each output is summed in the accumulation type by G lanes,
// lane g over the slots in order and, within a slot, over its words in
// order (each word's columns in order); the G partial sums are then
// added pairwise by lanes, (s0 + s1) + (s2 + s3) and so on, in a fixed
// tree.  With G = 1 this is the order of the kernel this one replaced:
// one slot after another, each block's columns in order.  Either way
// the result is the same bit for bit from run to run.  No atomics, no
// grid barrier.
#include <cstdint>
#include <cstring>

#include "common.cuh"

namespace {

using namespace ktt;

constexpr int kMaxThreads = 512;
constexpr int kStages = 2;           // the ring of shared-memory stages
constexpr int kMaxShared = 232448;      // 227 KB, sm_90's per-block limit

template <typename S> struct Acc { using type = S; };
template <> struct Acc<__nv_bfloat16> { using type = float; };
template <> struct Acc<__half> { using type = float; };

__device__ __forceinline__ unsigned shared_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(shared_addr(dst)), "l"(src) : "memory");
}

// One element of B bytes into shared memory by cp.async, or B zero bytes
// where !valid (the source is then not read); 2-byte elements by a plain
// load and store.
template <typename S>
__device__ __forceinline__ void cp_elem(S* dst, const S* src, bool valid) {
  constexpr int B = sizeof(S);
  if constexpr (B == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(shared_addr(dst)), "l"(src), "r"(valid ? 16 : 0)
                 : "memory");
  } else if constexpr (B == 4 || B == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                 :: "r"(shared_addr(dst)), "l"(src), "n"(B),
                    "r"(valid ? B : 0)
                 : "memory");
  } else {
    *dst = valid ? *src : narrow<S>(0.0f);
  }
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until none of this thread's copy groups is pending.
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// v from the lane whose index differs from this one's in the bits of o.
__device__ __forceinline__ float shfl_xor(float v, int o) {
  return __shfl_xor_sync(0xffffffffu, v, o);
}
__device__ __forceinline__ double shfl_xor(double v, int o) {
  return __shfl_xor_sync(0xffffffffu, v, o);
}
template <typename R>
__device__ __forceinline__ complex<R> shfl_xor(complex<R> v, int o) {
  return complex<R>(shfl_xor(v.re, o), shfl_xor(v.im, o));
}

template <typename A>
__device__ __forceinline__ A add(A a, A b) { return a + b; }
template <typename R>
__device__ __forceinline__ complex<R> add(complex<R> a, complex<R> b) {
  return complex<R>(a.re + b.re, a.im + b.im);
}

// N elements from 16-byte aligned shared memory, 16 bytes at a time where
// N elements are whole 16-byte words.
template <typename S, int N>
__device__ __forceinline__ void lds(const S* p, S (&v)[N]) {
  if constexpr ((N * sizeof(S)) % 16 == 0) {
    constexpr int W = static_cast<int>(N * sizeof(S) / 16);
    uint4 w[W];
#pragma unroll
    for (int q = 0; q < W; ++q) w[q] = reinterpret_cast<const uint4*>(p)[q];
    memcpy(&v[0], &w[0], sizeof(w));
  } else {
#pragma unroll
    for (int b = 0; b < N; ++b) v[b] = p[b];
  }
}

// Elements of S in one 16-byte word.
template <typename S>
constexpr int kVec = static_cast<int>(16 / sizeof(S));

// Each thread's tile of outputs: TileRows rows (half a slab apart) by
// TileCols columns of the P-column tile, so that each 16-byte word read
// from shared memory feeds several multiply-adds: 1 x 1 for P = 1, 1 x 2
// for P = 2, 2 x 2 for P = 4, 2 x 4 for P = 8.  The host's plan
// (ops/cuda_spmv.bell_plan) counts the same threads.
template <int P> struct TileRows { static constexpr int value = P >= 4 ? 2 : 1; };
template <int P> struct TileCols {
  static constexpr int value = P == 8 ? 4 : P == 4 ? 2 : P;
};

// Stage layout, in elements of S: the slab's rows, then the segment's P
// columns, each a row of ld elements (ld >= bs rounded up to a whole
// 16-byte word).
__host__ __device__ __forceinline__ long long stage_elems(int rows, int cols,
                                                           int ld) {
  return static_cast<long long>(rows + cols) * ld;
}

template <typename S, int P, bool kWide>
__global__ void __launch_bounds__(kMaxThreads)
bell_kernel(const S* __restrict__ data, const int* __restrict__ idx,
            const S* __restrict__ x, S* __restrict__ y, int mbpr, int bs,
            long long m, long long n, int p, int rows, int parts, int ld) {
  using A = typename Acc<S>::type;
  constexpr int V = kVec<S>;
  // raw storage: a shared array of a class type (complex) may not have a
  // constructor
  extern __shared__ __align__(16) unsigned char smem_raw[];
  S* smem = reinterpret_cast<S*>(smem_raw);
  const int t = threadIdx.x;
  const int nthreads = blockDim.x;
  constexpr int R2 = TileRows<P>::value;
  constexpr int C2 = TileCols<P>::value;
  const int half = rows / R2;   // thread row groups
  const int part = t % parts;   // this thread's words: part + parts w
  const int u = t / parts;
  const int rg = u / (P / C2);  // its rows rg + q half, q < R2
  const int cg = u - rg * (P / C2);  // and columns cg C2 + j, j < C2
  const int nslab = (bs + rows - 1) / rows;
  const long long i = blockIdx.x / nslab;
  const int r0 = static_cast<int>(blockIdx.x - i * nslab) * rows;
  const int nr = min(rows, bs - r0);
  const int c_base = blockIdx.y * P;
  const int pc = min(P, p - c_base);
  const int bsv = (bs + V - 1) / V * V;
  const long long stage = stage_elems(rows, P, ld);
  const S zero = narrow<S>(0.0f);

  // the columns [bs, bsv) of every row of every stage: never copied, read
  // as zeros
  if (bsv > bs) {
    const int pad = bsv - bs;
    for (int e = t; e < kStages * (rows + P) * pad; e += nthreads) {
      smem[static_cast<long long>(e / pad) * ld + bs + e % pad] = zero;
    }
  }

  const long long block_row = i * mbpr;
  // copy slot k's slab and segment of x into stage s
  auto issue = [&](int k, int s) {
    S* tile = smem + s * stage;
    S* xs = tile + static_cast<long long>(rows) * ld;
    const S* slab = data + ((block_row + k) * bs + r0)
                               * static_cast<long long>(bs);
    if constexpr (kWide) {
      const int words = bs / V;     // 16-byte words per row
      for (int e = t; e < nr * words; e += nthreads) {
        const int rr = e / words;
        cp_async16(tile + static_cast<long long>(rr) * ld
                       + (e - rr * words) * V,
                   slab + static_cast<long long>(e) * V);
      }
    } else {
      for (int e = t; e < nr * bs; e += nthreads) {
        const int rr = e / bs;
        cp_elem(tile + static_cast<long long>(rr) * ld + (e - rr * bs),
                slab + e, true);
      }
    }
    const long long row0 = static_cast<long long>(idx[block_row + k]) * bs;
    if (kWide && P == 1 && p == 1 && row0 + bs <= n) {
      // one contiguous run of bs elements, whole 16-byte words
      for (int e = t; e < bs / V; e += nthreads) {
        cp_async16(xs + e * V, x + row0 + static_cast<long long>(e) * V);
      }
    } else {
      // x's (row, column) to column row c of the stage, consecutive
      // threads on consecutive elements of x
      for (int e = t; e < bs * P; e += nthreads) {
        const int rr = e / P;
        const int c = e - rr * P;
        const long long row = row0 + rr;
        const bool ok = row < n && c < pc;
        cp_elem(xs + static_cast<long long>(c) * ld + rr,
                ok ? x + row * p + c_base + c : x, ok);
      }
    }
  };

  if (mbpr > 0) {
    issue(0, 0);
    cp_commit();
  }
  A acc[R2][C2];
#pragma unroll
  for (int q = 0; q < R2; ++q) {
#pragma unroll
    for (int j = 0; j < C2; ++j) acc[q][j] = A(0);
  }
  for (int k = 0; k < mbpr; ++k) {
    cp_wait_all();    // slot k's copies, this thread's
    __syncthreads();  // everyone's; and slot k - 1's stage is free
    if (k + 1 < mbpr) {
      issue(k + 1, (k + 1) % kStages);
      cp_commit();
    }
    if (rg < half) {
      const S* tile = smem + (k % kStages) * stage;
      const S* arow = tile + static_cast<long long>(rg) * ld;
      const S* xcol = tile + static_cast<long long>(rows + cg * C2) * ld;
#pragma unroll 2
      for (int c = part * V; c < bsv; c += parts * V) {
        S a[R2][V], xv[C2][V];
#pragma unroll
        for (int q = 0; q < R2; ++q) {
          lds(arow + static_cast<long long>(q) * half * ld + c, a[q]);
        }
#pragma unroll
        for (int j = 0; j < C2; ++j) {
          lds(xcol + static_cast<long long>(j) * ld + c, xv[j]);
        }
#pragma unroll
        for (int v = 0; v < V; ++v) {
#pragma unroll
          for (int q = 0; q < R2; ++q) {
#pragma unroll
            for (int j = 0; j < C2; ++j) {
              acc[q][j] = madd(acc[q][j], a[q][v], xv[j][v]);
            }
          }
        }
      }
    }
  }
  // the parts' sums, lanes part of one warp: (p0 + p1) + (p2 + p3), ...;
  // every lane of a group ends with the same bits (+ commutes exactly)
  for (int o = 1; o < parts; o <<= 1) {
#pragma unroll
    for (int q = 0; q < R2; ++q) {
#pragma unroll
      for (int j = 0; j < C2; ++j) {
        acc[q][j] = add(acc[q][j], shfl_xor(acc[q][j], o));
      }
    }
  }
  if (rg < half && part == 0) {
#pragma unroll
    for (int q = 0; q < R2; ++q) {
      const int rr = rg + q * half;
      const long long row = i * bs + r0 + rr;
#pragma unroll
      for (int j = 0; j < C2; ++j) {
        const int c = cg * C2 + j;
        if (rr < nr && row < m && c < pc) {
          y[row * p + c_base + c] = narrow<S>(acc[q][j]);
        }
      }
    }
  }
}

// Threads of a block: one per tile of outputs, in whole warps.
template <int P>
int threads_of(int rows, int parts) {
  const int t = rows / TileRows<P>::value * (P / TileCols<P>::value) * parts;
  return (t + 31) / 32 * 32;
}

// The shared memory of one block, or -1 for a plan the kernel does not
// take.
template <typename S, int P>
long long shared_bytes(int bs, int rows, int parts, int ld) {
  constexpr int V = kVec<S>;
  const int bsv = (bs + V - 1) / V * V;
  if (bs <= 0 || rows < 1 || rows % TileRows<P>::value != 0
      || parts < 1 || parts > 32 || (parts & (parts - 1)) != 0
      || threads_of<P>(rows, parts) > kMaxThreads || ld < bsv
      || ld % V != 0) {
    return -1;
  }
  return kStages * stage_elems(rows, P, ld)
      * static_cast<long long>(sizeof(S));
}

template <typename S, int P, bool kWide>
int launch_plan(const void* data, const void* idx, const void* x, void* y,
                int nbr, int mbpr, int bs, long long m, long long n, int p,
                int rows, int parts, int ld, void* stream) {
  const long long smem = shared_bytes<S, P>(bs, rows, parts, ld);
  if (smem < 0 || smem > kMaxShared) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (nbr <= 0 || p <= 0 || m <= 0) return static_cast<int>(cudaSuccess);
  auto kernel = bell_kernel<S, P, kWide>;
  // once per device: the kernel may take up to 227 KB, and the SM gives
  // shared memory all it can, so that several blocks' stages fit
  static bool raised[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64 || !raised[dev]) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxShared);
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
          static_cast<int>(cudaSharedmemCarveoutMaxShared));
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev >= 0 && dev < 64) raised[dev] = true;
  }
  const int nslab = (bs + rows - 1) / rows;
  const dim3 grid(static_cast<unsigned>(static_cast<long long>(nbr) * nslab),
                  static_cast<unsigned>((p + P - 1) / P));
  const int threads = threads_of<P>(rows, parts);
  kernel<<<grid, threads, static_cast<size_t>(smem),
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const S*>(data), static_cast<const int*>(idx),
      static_cast<const S*>(x), static_cast<S*>(y), mbpr, bs, m, n, p, rows,
      parts, ld);
  return static_cast<int>(cudaGetLastError());
}

template <typename S, int P>
int launch_cols(const void* data, const void* idx, const void* x, void* y,
                int nbr, int mbpr, int bs, long long m, long long n, int p,
                int rows, int parts, int ld, int wide, void* stream) {
  return wide ? launch_plan<S, P, true>(data, idx, x, y, nbr, mbpr, bs, m,
                                        n, p, rows, parts, ld, stream)
              : launch_plan<S, P, false>(data, idx, x, y, nbr, mbpr, bs, m,
                                         n, p, rows, parts, ld, stream);
}

template <typename S>
int launch(const void* data, const void* idx, const void* x, void* y,
           int nbr, int mbpr, int bs, long long m, long long n, int p,
           int cols, int rows, int parts, int ld, int wide, void* stream) {
  // the wide variant needs whole 16-byte words per row and aligned data
  // and x; the host chooses it only then, and it is refused otherwise
  if (wide && ((bs * sizeof(S)) % 16 != 0
               || reinterpret_cast<uintptr_t>(data) % 16 != 0
               || reinterpret_cast<uintptr_t>(x) % 16 != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (cols) {
    case 1:
      return launch_cols<S, 1>(data, idx, x, y, nbr, mbpr, bs, m, n, p,
                               rows, parts, ld, wide, stream);
    case 2:
      return launch_cols<S, 2>(data, idx, x, y, nbr, mbpr, bs, m, n, p,
                               rows, parts, ld, wide, stream);
    case 4:
      return launch_cols<S, 4>(data, idx, x, y, nbr, mbpr, bs, m, n, p,
                               rows, parts, ld, wide, stream);
    case 8:
      return launch_cols<S, 8>(data, idx, x, y, nbr, mbpr, bs, m, n, p,
                               rows, parts, ld, wide, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// (data, idx, x, y, nbr, mbpr, bs, m, n, rows, parts, ld, wide, stream)
// and, for the SpMM, (data, idx, x, y, nbr, mbpr, bs, m, n, p, cols,
// rows, parts, ld, wide, stream).  The plan is the host's
// (ops/cuda_spmv.bell_plan): rows per slab, parts of each row's words,
// the padded row stride ld in elements, the tile width cols
// in {1, 2, 4, 8}, wide or element copies; the SpMV is the one-column
// variant.
#define KTT_BELL(SPMV, SPMM, S)                                               \
  extern "C" int SPMV(const void* data, const void* idx, const void* x,      \
                      void* y, int nbr, int mbpr, int bs, long long m,       \
                      long long n, int rows, int parts, int ld, int wide,    \
                      void* stream) {                                        \
    return launch<S>(data, idx, x, y, nbr, mbpr, bs, m, n, 1, 1, rows,       \
                     parts, ld, wide, stream);                               \
  }                                                                          \
  extern "C" int SPMM(const void* data, const void* idx, const void* x,      \
                      void* y, int nbr, int mbpr, int bs, long long m,       \
                      long long n, int p, int cols, int rows, int parts,     \
                      int ld, int wide, void* stream) {                      \
    return launch<S>(data, idx, x, y, nbr, mbpr, bs, m, n, p, cols, rows,    \
                     parts, ld, wide, stream);                               \
  }

KTT_BELL(ktt_bell_spmv_f32, ktt_bell_spmm_f32, float)
KTT_BELL(ktt_bell_spmv_f64, ktt_bell_spmm_f64, double)
KTT_BELL(ktt_bell_spmv_bf16, ktt_bell_spmm_bf16, __nv_bfloat16)
KTT_BELL(ktt_bell_spmv_f16, ktt_bell_spmm_f16, __half)
KTT_BELL(ktt_bell_spmv_c64, ktt_bell_spmm_c64, complex<float>)
KTT_BELL(ktt_bell_spmv_c128, ktt_bell_spmm_c128, complex<double>)
