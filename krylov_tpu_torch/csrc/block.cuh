// The p-column panel helpers of the block whole-solve kernels
// (block_minres.cuh; block GMRES's kernel is to reuse them) on Hopper
// (sm_90a): a panel is p vectors of n stored one after another
// (column-major, as the TPU kernels' (p * rows, 128) panels,
// krylov_tpu/ops/pallas_fused.py:2695); the per-block partials of a Gram
// matrix's upper triangle; the Cholesky factor of CholQR that every block
// computes in its thread 0 from those partials; and the row-wise solve
// W <- W R^-1 that applies it.
//
// CholQR as the TPU kernel has it (pallas_fused.py:2713-2748): G = W^T W;
// R upper with R[i][i] = sqrt(max(G[i][i] - sum_t R[t][i]^2, 0)); a pivot
// at most btol = eps^(3/4) keeps its row of R at 0 off the diagonal and
// its column of W undivided (only a rank-deficient panel reaches that, and
// the solvers keep such panels off the kernels); W[:, i] <- (W[:, i] -
// sum_{t<i} R[t][i] W[:, t]) / R[i][i], t in order, on the new columns.
#pragma once

#include "common.cuh"

namespace {
namespace blk {

using namespace ktt;

constexpr int kMaxP = 8;

// Row r of column col of panel slot (a panel is NP rows of n).
template <typename T>
__device__ __forceinline__ T* col(T* work, int slot, int c, int np,
                                  long long n) {
  return work + (static_cast<long long>(slot) * np + c) * n;
}

// The number of entries of an NP x NP upper triangle, and the index of
// (a, b), a <= b, in the order a, then b.
__host__ __device__ constexpr int ntri(int np) { return np * (np + 1) / 2; }
__device__ __forceinline__ int tri(int a, int b, int np) {
  return a * np - a * (a - 1) / 2 + (b - a);
}

// g += the upper triangle of w w^T, one row's terms.
template <typename T, int NP>
__device__ __forceinline__ void gram_add(T (&g)[ntri(NP)], const T (&w)[NP]) {
#pragma unroll
  for (int a = 0; a < NP; ++a) {
#pragma unroll
    for (int b = a; b < NP; ++b) g[tri(a, b, NP)] += w[a] * w[b];
  }
}

// The Cholesky factor R (NP x NP, by rows, lower part 0) of the Gram matrix
// whose upper triangle is g, and the divisors of its columns (R[i][i], or 1
// where the pivot is at most btol); one thread (pallas_fused.py:
// 2719-2741).
template <typename T>
__device__ __noinline__ void cholesky(const T* g, int np, T btol, T* R,
                                      T* safe) {
  for (int i = 0; i < np; ++i) {
    T s = g[tri(i, i, np)];
    for (int t = 0; t < i; ++t) s = s - R[t * np + i] * R[t * np + i];
    const T di = sqrt(s > T(0) ? s : T(0));
    R[i * np + i] = di;
    const bool small = di <= btol;
    safe[i] = small ? T(1) : di;
    for (int j = i + 1; j < np; ++j) {
      T s2 = g[tri(i, j, np)];
      for (int t = 0; t < i; ++t) s2 = s2 - R[t * np + i] * R[t * np + j];
      R[i * np + j] = small ? T(0) : s2 / safe[i];
    }
    for (int j = 0; j < i; ++j) R[i * np + j] = T(0);
  }
}

// One row of W <- W R^-1, in place: column i from the new columns t < i
// (pallas_fused.py:2742-2748).
template <typename T, int NP>
__device__ __forceinline__ void solve_row(T (&w)[NP], const T* R,
                                          const T* safe) {
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    T v = w[i];
#pragma unroll
    for (int t = 0; t < i; ++t) v = v - R[t * NP + i] * w[t];
    w[i] = v / safe[i];
  }
}

// R = R2 R1 of CholQR2, upper (pallas_fused.py:2753-2762), one thread.
template <typename T>
__device__ void chol2_product(const T* R2, const T* R1, int np, T* R) {
  for (int i = 0; i < np; ++i) {
    for (int j = 0; j < np; ++j) {
      T s = T(0);
      if (j >= i) {
        for (int t = i; t <= j; ++t) s = s + R2[i * np + t] * R1[t * np + j];
      }
      R[i * np + j] = s;
    }
  }
}

}  // namespace blk
}  // namespace
