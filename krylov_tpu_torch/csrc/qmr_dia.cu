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
// A^H once each (2 x 7 diagonals for the 7-point stencil) and must read
// v_k, u_k, v_{k-1}, u_{k-1}, w_{k-1}, w_{k-2} and x and write v_{k+1},
// u_{k+1}, w_k and x: 14 + 11 words per row, 100 B in f32, 200 B in f64.
//
// Design: the launches of bilanczos.cuh (its note says where v_{k+1}
// and u_{k+1} are normalised and in which order the dots are summed),
// four per iteration:
//   1. two_sided_stencil (grid)  q, p, partials of <u_k, q>
//   2. qm_fused       (grid)     alpha; q -= alpha v_k, p -= alpha u_k;
//                                partials of <p, q>, ||q||^2 and
//                                ||v_k||^2; and the last iteration's
//                                direction update, one iteration late:
//                                w_{k-1} = (v_{k-1} - lambda w_{k-2}
//                                - eps w_{k-3}) / d_{k-1} and
//                                x += zeta_{k-1} w_{k-1}
//   3. bl_normalise   (grid)     v_{k+1} and u_{k+1} in place of q and p
//   4. qm_scalars     (1 block)  beta_{k+1}, gamma_{k+1}; the QR step
//                                (the rotation of d_bar_k against
//                                beta_{k+1}) and the coefficients of this
//                                iteration's late update; tau,
//                                ||v_{k+1}||^2 = ||q||^2 / beta_{k+1}^2,
//                                the residual estimate, the status
// The direction update needs beta_{k+1}, which only the scalar launch
// has, so it runs in the next iteration's fused launch, and one
// finishing launch after the loop (qm_finish) applies the update of the
// last iteration that ran, whether the solve stopped in the middle of a
// chunk or at its end, so x holds every update the plain version makes.
// w_k overwrites w_{k-2} in its buffer row by row, so two buffers hold
// the recurrence; neither is read with neighbours.  Bytes per row and
// iteration: the stencil 2 x 7 diagonals, v_k, u_k, v_{k-1}, u_{k-1}
// read and q, p written (20 words), the fused launch q, p, v_k, u_k,
// v_{k-1}, w_{k-1}, w_{k-2}, x read and q, p, w, x written (12 words),
// the normalising launch q and p read and written (4 words): 144 B in
// f32 (bound 100), 288 B in f64 (bound 200).
#include "bilanczos.cuh"

namespace {

using namespace bilanczos;

enum ScalarSlot {
  EPS_LIM = GAMMA1 + 1, C_KM2, S_KM2, C_KM1, S_KM1, ZETABAR, TAU, RNORM,
  LAM, EPS, DK, ZETA, NSC
};
enum IntSlot { NST = GO + 1 };
enum OwnRow { X = NSHARED_ROWS, W0, W1, NROWS };

// ||b||, b'c = ||b||^2, beta_1, gamma_1, zeta_bar_1 = beta_1, tau and the
// starting status.
template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
qm_init_scalars(const Dot* __restrict__ partial, int nparts, T* sc,
                int* st) {
  const T bb = sum_partials_in<T>(partial + PUQ * nparts, nparts);
  if (threadIdx.x != 0) return;
  const T bnorm = sqrt(bb);
  const T chb = bnorm * bnorm;          // c = b on the fused path
  const T beta = sqrt(fabs(chb));
  const T eps_lim = sc[ATOL] + sc[RTOL] * bnorm;
  const T abeta = safe(static_cast<T>(fabs(beta)));
  sc[BETA] = beta;
  sc[GAMMA] = chb / safe(beta);
  sc[ALPHA] = T(0);
  sc[EPS_LIM] = eps_lim;
  sc[C_KM2] = sc[S_KM2] = sc[C_KM1] = sc[S_KM1] = T(0);
  sc[ZETABAR] = beta;
  sc[TAU] = bnorm * bnorm / (abeta * abeta);
  sc[RNORM] = bnorm;
  sc[LAM] = sc[EPS] = sc[ZETA] = T(0);
  sc[DK] = T(1);
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

// The direction update of the iteration before it0 (0-based), from the
// coefficients its scalar launch stored: w = (v - lambda w_{k-1}
// - eps w_{k-2}) / d_k over w_{k-2}'s buffer, x += zeta w.  v is that
// iteration's v_k, now in buffer prev(it0).
template <typename T>
struct LateUpdate {
  const T* v;
  const T* wkm1;
  T* wk;
  T* x;
  T d, lam, eps, zeta;

  __device__ __forceinline__ LateUpdate(T* work, const T* sc, int it0,
                                        long long n)
      : d(safe(sc[DK])) {
    const int upd = it0 >= 1 ? it0 - 1 : 0;   // none before it0 = 1
    v = row(work, V0 + prev(it0), n);
    wkm1 = row(work, W0 + (upd + 1) % 2, n);
    wk = row(work, W0 + upd % 2, n);
    x = row(work, X, n);
    lam = sc[LAM];
    eps = sc[EPS];
    zeta = sc[ZETA];
  }

  struct Vals {
    T v, w1, w2, x;
  };
  __device__ __forceinline__ Vals load(long long i) const {
    return Vals{v[i], wkm1[i], wk[i], x[i]};
  }

  __device__ __forceinline__ void step(long long i, const Vals& a) const {
    const T w = (a.v - lam * a.w1 - eps * a.w2) / d;
    wk[i] = w;
    x[i] = a.x + zeta * w;
  }
};

// 2. alpha, q and p, the partials of <p, q>, ||q||^2 and ||v_k||^2, and
// the last iteration's direction and x update.
template <typename T>
__global__ void __launch_bounds__(kThreads)
qm_fused(T* __restrict__ work, Dot* __restrict__ partial, T* sc,
         const int* st, long long n) {
  if (!st[GO]) return;
  const int it0 = st[IT];
  const AlphaRows<T> lz(work, partial, sc, it0, n);
  const bool late = it0 >= 1;
  const LateUpdate<T> up(work, sc, it0, n);
  T t[3] = {T(0), T(0), T(0)};
  Dot qq = Dot(0);
  for (long long i = first_row(); i < n; i += row_stride()) {
    const auto a = lz.load(i);
    if (late) {
      const auto b = up.load(i);
      lz.step(i, a, t, qq);
      up.step(i, b);
    } else {
      lz.step(i, a, t, qq);
    }
  }
  store_alpha_partials(t, qq, partial);
}

// 3. beta_{k+1}, gamma_{k+1}, the QR step and the late update's
// coefficients, tau, ||r_k|| ~ |zeta_bar_{k+1}| sqrt(tau) and the status
// (pallas_fused.py:4837-4872).
template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
qm_scalars(const Dot* __restrict__ partial, int nparts, T* sc, int* st,
           int) {
  if (!st[GO]) return;
  const LanczosSums<T> sums = lanczos_sums<T>(partial, nparts);
  if (threadIdx.x != 0) return;
  const int it0 = st[IT];
  const T phq = sc[PHQ];
  const T beta1 = sc[BETA1];
  const QrStep<T> qr = qr_step(sc, it0 + 1, beta1);
  const T nn = next_norm2(sums, phq, beta1);
  const T zetabar = qr.sk * sc[ZETABAR];
  const T tau = sc[TAU] + nn;
  const T rnorm = static_cast<T>(fabs(zetabar)) * sqrt(tau);
  const bool solved = rnorm <= sc[EPS_LIM] || (rnorm + T(1)) <= T(1);
  const bool breakdown = !solved && phq == T(0);
  int code = RUNNING;
  if (breakdown) code = UV_BREAKDOWN;
  if (solved) code = SOLVED;
  sc[LAM] = qr.lam;
  sc[EPS] = qr.eps;
  sc[DK] = qr.dk;
  sc[ZETA] = qr.zeta;
  sc[C_KM2] = sc[C_KM1];
  sc[S_KM2] = sc[S_KM1];
  sc[C_KM1] = qr.ck;
  sc[S_KM1] = qr.sk;
  sc[ZETABAR] = zetabar;
  sc[TAU] = tau;
  sc[RNORM] = rnorm;
  commit_lanczos(sc);
  st[IT] = it0 + 1;
  st[STATUS] = code;
}

// After the loop: the direction and x update of the last iteration that
// ran.
template <typename T>
__global__ void __launch_bounds__(kThreads)
qm_finish(T* __restrict__ work, const T* sc, const int* st, long long n) {
  const int it0 = st[IT];
  if (it0 < 1) return;
  const LateUpdate<T> up(work, sc, it0, n);
  for (long long i = first_row(); i < n; i += row_stride()) {
    up.step(i, up.load(i));
  }
}

struct Qmr {
  static constexpr int kRows = NROWS - NSHARED_ROWS;
  static constexpr int kWithUU = 0;
  template <typename T>
  static void init_scalars(Dot* partial, int grid, T* sc, int* st,
                           cudaStream_t s) {
    qm_init_scalars<T><<<1, kReduceThreads, 0, s>>>(partial, grid, sc, st);
  }
  template <typename T>
  static void fused(T* work, Dot* partial, T* sc, int* st, long long n,
                    int grid, cudaStream_t s) {
    qm_fused<T><<<grid, kThreads, 0, s>>>(work, partial, sc, st, n);
  }
  template <typename T>
  static void scalars(Dot* partial, int grid, T* sc, int* st, int flag,
                      cudaStream_t s) {
    qm_scalars<T><<<1, kReduceThreads, 0, s>>>(partial, grid, sc, st, flag);
  }
};

template <typename T>
int finish(void* work, const void* sc, const void* st, long long n, int grid,
           void* stream) {
  qm_finish<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<T*>(work), static_cast<const T*>(sc),
      static_cast<const int*>(st), n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define KTT_QM_INIT(NAME, T)                                                  \
  extern "C" int NAME(const void* b, const void* c, void* work,              \
                      void* partial, void* sc, void* st, long long n,        \
                      int grid, void* stream) {                              \
    return bilanczos::init<T, Qmr>(b, c, work, partial, sc, st, n,      \
                                        grid, stream);                       \
  }

#define KTT_QM_ITERATE(NAME, T, P)                                            \
  extern "C" int NAME(const void* pd, const void* offsets, int nd,           \
                      const void* pda, const void* offsets_a, int nda,       \
                      long long lo, long long hi, long long lo_a,            \
                      long long hi_a, void* work, void* partial, void* sc,   \
                      void* st, long long n, int grid, int flag, int iters,  \
                      int cap, void* stream) {                               \
    return bilanczos::iterate<T, P, Qmr>(                                    \
        pd, offsets, nd, pda, offsets_a, nda, lo, hi, lo_a, hi_a, work,      \
        partial, sc, st, n, grid, flag, iters, cap, stream);                 \
  }

#define KTT_QM_FINISH(NAME, T)                                                \
  extern "C" int NAME(void* work, const void* sc, const void* st,            \
                      long long n, int grid, void* stream) {                 \
    return finish<T>(work, sc, st, n, grid, stream);                         \
  }

KTT_QM_INIT(ktt_qmr_dia_init_f32, float)
KTT_QM_INIT(ktt_qmr_dia_init_f64, double)
KTT_QM_ITERATE(ktt_qmr_dia_iterate_f32_f32, float, float)
KTT_QM_ITERATE(ktt_qmr_dia_iterate_f32_bf16, float, __nv_bfloat16)
KTT_QM_ITERATE(ktt_qmr_dia_iterate_f32_f16, float, __half)
KTT_QM_ITERATE(ktt_qmr_dia_iterate_f64_f64, double, double)
KTT_QM_FINISH(ktt_qmr_dia_finish_f32, float)
KTT_QM_FINISH(ktt_qmr_dia_finish_f64, double)
