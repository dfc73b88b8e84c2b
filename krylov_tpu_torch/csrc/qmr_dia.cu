// Whole QMR solve of A x = b for a DIA matrix, shadow vector c = b, on
// Hopper (sm_90a), with no grid-wide barrier.
//
// Replaces the TPU kernel krylov_tpu/ops/pallas_fused.py:4755
// qmr_dia_fused and computes what it computes (pallas_fused.py:
// 4775-4880): the two-sided Lanczos process on A and A^H, the QR of
// T_{k+1,k} by sym_givens and the w_{k-2}, w_{k-1} direction
// recurrence.  Outputs: x, niter, rnorm and the status code (0 running /
// 1 solved / 2 zero residual / 29 b'c = 0 / 38 <u_{k+1}, v_{k+1}> = 0).
//
// Bound on an H100 SXM: memory bandwidth.  An iteration applies A and
// A^H once each (2 x 28 B per row in f32) and must read v_k, u_k,
// v_{k-1}, u_{k-1}, w_{k-1}, w_{k-2} and x and write v_{k+1}, u_{k+1},
// w_k and x: (56 + 44) B per row, 100 B.
//
// Design: the launches of bilanczos.cuh, then
//   3. qm_next    (grid)     beta_{k+1}, gamma_{k+1}; the QR step (the
//                            rotation of d_bar_k against beta_{k+1}, in
//                            one thread of each block), w_k = (v_k
//                            - lambda w_{k-1} - eps w_{k-2}) / d_k,
//                            x += zeta_k w_k, v_{k+1} and u_{k+1} in
//                            place of q and p, partials of
//                            ||v_{k+1}||^2
//   4. qm_scalars (1 block)  tau, the residual estimate, the status
// w_k overwrites w_{k-2} in its buffer row by row (wkm2_row), so two
// buffers hold the recurrence; neither is read with neighbours.  Per
// iteration this design moves (56 + 24) + 24 + (36 + 8) B per row in
// f32: 148 B.
#include "bilanczos.cuh"

namespace {

using namespace bilanczos;

enum ScalarSlot {
  EPS_LIM = GAMMA1 + 1, C_KM2, S_KM2, C_KM1, S_KM1, ZETABAR, TAU, RNORM, CK,
  SK, NSC
};
enum IntSlot { NST = GO + 1 };
enum OwnRow { X = NSHARED_ROWS, W0, W1, NROWS };

// w_{k-1} sits in buffer W0 + (it + 1) mod 2 and w_{k-2} in W0 + it mod 2,
// where w_k goes (it the 0-based iteration count).
__device__ __forceinline__ int wkm1_row(int it0) { return W0 + (it0 + 1) % 2; }
__device__ __forceinline__ int wkm2_row(int it0) { return W0 + it0 % 2; }

// ||b||, b'c = ||b||^2, beta_1, gamma_1, zeta_bar_1 = beta_1, tau and the
// starting status.
template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
qm_init_scalars(const T* __restrict__ partial, int nparts, T* sc, int* st) {
  const T bb = sum_partials(partial + PUQ * nparts, nparts);
  if (threadIdx.x != 0) return;
  const T bnorm = sqrt(bb);
  const T chb = bnorm * bnorm;          // c = b on the fused path
  const T beta = sqrt(fabs(chb));
  const T eps_lim = sc[ATOL] + sc[RTOL] * bnorm;
  const T abeta = safe(static_cast<T>(fabs(beta)));
  sc[BETA] = beta;
  sc[GAMMA] = chb / safe(beta);
  sc[ALPHA] = sc[PHQ] = sc[BETA1] = sc[GAMMA1] = T(0);
  sc[EPS_LIM] = eps_lim;
  sc[C_KM2] = sc[S_KM2] = sc[C_KM1] = sc[S_KM1] = T(0);
  sc[ZETABAR] = beta;
  sc[TAU] = bnorm * bnorm / (abeta * abeta);
  sc[RNORM] = bnorm;
  sc[CK] = sc[SK] = T(0);
  st[IT] = 0;
  st[GO] = 0;
  st[STATUS] = bnorm == T(0) ? ZERO_RESIDUAL
               : chb == T(0) ? BC_BREAKDOWN
               : bnorm <= eps_lim ? SOLVED : RUNNING;
}

// The QR step of pallas_fused.py:4837-4846: lambda_{k-1}, eps_{k-2}, the
// rotation (c_k, s_k, d_k) of d_bar_k against beta_{k+1}, and
// zeta_k = c_k zeta_bar_k.
template <typename T>
struct QrStep {
  T lam, eps, ck, sk, dk, zeta;
};

template <typename T>
__device__ __forceinline__ QrStep<T> qr_step(const T* sc, int it, T beta1) {
  const T gamma = sc[GAMMA];
  const T alpha = sc[ALPHA];
  const T c_km2 = sc[C_KM2];
  const T c_km1 = sc[C_KM1];
  const T s_km1 = sc[S_KM1];
  QrStep<T> r;
  r.eps = it >= 3 ? sc[S_KM2] * gamma : T(0);
  const T lbar = it >= 3 ? -c_km2 * gamma : (it == 2 ? gamma : T(0));
  r.lam = it >= 2 ? c_km1 * lbar + s_km1 * alpha : T(0);
  const T dbar_k = it >= 2 ? s_km1 * lbar - c_km1 * alpha : alpha;
  sym_givens(dbar_k, beta1, r.ck, r.sk, r.dk);
  r.zeta = r.ck * sc[ZETABAR];
  return r;
}

// 3. beta_{k+1}, gamma_{k+1}, the QR step, w_k and x, v_{k+1} and
// u_{k+1}, partials of ||v_{k+1}||^2.
template <typename T>
__global__ void __launch_bounds__(kThreads)
qm_next(T* __restrict__ work, T* __restrict__ partial, T* sc, const int* st,
        long long n) {
  if (!st[GO]) return;
  T phq, beta1, gamma1;
  bi_next_scalars(partial, sc, phq, beta1, gamma1);
  const int it0 = st[IT];
  __shared__ QrStep<T> qr;
  if (threadIdx.x == 0) qr = qr_step(sc, it0 + 1, beta1);
  __syncthreads();
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    sc[CK] = qr.ck;
    sc[SK] = qr.sk;
  }
  const T lam = qr.lam;
  const T eps = qr.eps;
  const T dk = safe(qr.dk);
  const T zeta = qr.zeta;
  const T* vk = row(work, V0 + cur(it0), n);
  const T* wkm1 = row(work, wkm1_row(it0), n);
  T* wk = row(work, wkm2_row(it0), n);
  T* x = row(work, X, n);
  T snn = T(0);
  for (long long i = first_row(); i < n; i += row_stride()) {
    const T w = (vk[i] - lam * wkm1[i] - eps * wk[i]) / dk;
    wk[i] = w;
    x[i] = x[i] + zeta * w;
    const T vn = bi_next_row(work, it0, n, i, phq, beta1, gamma1);
    snn += vn * vn;
  }
  store_partial(snn, partial + PNN * gridDim.x);
}

// 4. tau, ||r_k|| ~ |zeta_bar_{k+1}| sqrt(tau) and the status
// (pallas_fused.py:4856-4872).
template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
qm_scalars(const T* __restrict__ partial, int nparts, T* sc, int* st, int) {
  if (!st[GO]) return;
  const T nn = sum_partials(partial + PNN * nparts, nparts);
  if (threadIdx.x != 0) return;
  const T sk = sc[SK];
  const T zetabar = sk * sc[ZETABAR];
  const T tau = sc[TAU] + nn;
  const T rnorm = static_cast<T>(fabs(zetabar)) * sqrt(tau);
  const bool solved = rnorm <= sc[EPS_LIM] || (rnorm + T(1)) <= T(1);
  const bool breakdown = !solved && sc[PHQ] == T(0);
  int code = RUNNING;
  if (breakdown) code = UV_BREAKDOWN;
  if (solved) code = SOLVED;
  sc[BETA] = sc[BETA1];
  sc[GAMMA] = sc[GAMMA1];
  sc[C_KM2] = sc[C_KM1];
  sc[S_KM2] = sc[S_KM1];
  sc[C_KM1] = sc[CK];
  sc[S_KM1] = sk;
  sc[ZETABAR] = zetabar;
  sc[TAU] = tau;
  sc[RNORM] = rnorm;
  st[IT] += 1;
  st[STATUS] = code;
}

struct Qmr {
  static constexpr int kRows = NROWS - NSHARED_ROWS;
  static constexpr int kWithUU = 0;
  template <typename T>
  static void init_scalars(T* partial, int grid, T* sc, int* st,
                           cudaStream_t s) {
    qm_init_scalars<T><<<1, kReduceThreads, 0, s>>>(partial, grid, sc, st);
  }
  template <typename T>
  static void next(T* work, T* partial, T* sc, int* st, long long n,
                   int grid, int, cudaStream_t s) {
    qm_next<T><<<grid, kThreads, 0, s>>>(work, partial, sc, st, n);
  }
  template <typename T>
  static void scalars(T* partial, int grid, T* sc, int* st, int flag,
                      cudaStream_t s) {
    qm_scalars<T><<<1, kReduceThreads, 0, s>>>(partial, grid, sc, st, flag);
  }
};

}  // namespace

#define KTT_QM_INIT(NAME, T)                                                  \
  extern "C" int NAME(const void* b, const void* c, void* work,              \
                      void* partial, void* sc, void* st, long long n,        \
                      int grid, void* stream) {                              \
    return bilanczos::init<T, Qmr>(b, c, work, partial, sc, st, n, grid,     \
                                   stream);                                  \
  }

#define KTT_QM_ITERATE(NAME, T, P)                                            \
  extern "C" int NAME(const void* pd, const void* offsets, int nd,           \
                      const void* pda, const void* offsets_a, int nda,       \
                      void* work, void* partial, void* sc, void* st,         \
                      long long n, int grid, int flag, int iters, int cap,   \
                      void* stream) {                                        \
    return bilanczos::iterate<T, P, Qmr>(pd, offsets, nd, pda, offsets_a,    \
                                         nda, work, partial, sc, st, n,      \
                                         grid, flag, iters, cap, stream);    \
  }

KTT_QM_INIT(ktt_qmr_dia_init_f32, float)
KTT_QM_INIT(ktt_qmr_dia_init_f64, double)
KTT_QM_ITERATE(ktt_qmr_dia_iterate_f32_f32, float, float)
KTT_QM_ITERATE(ktt_qmr_dia_iterate_f32_bf16, float, __nv_bfloat16)
KTT_QM_ITERATE(ktt_qmr_dia_iterate_f32_f16, float, __half)
KTT_QM_ITERATE(ktt_qmr_dia_iterate_f64_f64, double, double)
