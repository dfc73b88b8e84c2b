// Whole BiLQR solve of A x = b and A^H y = c for a DIA matrix, on Hopper
// (sm_90a), with no grid-wide barrier.
//
// Replaces the TPU kernel krylov_tpu/ops/pallas_fused.py:7400
// bilqr_dia_fused and computes what it computes (pallas_fused.py:
// 7427-7638): one two-sided Lanczos process feeding the primal BiLQ
// recurrences (the LQ of T_k, x along d_bar) and the dual QMR-like
// recurrences (y along w_{k-1} built from u_{k-1}), each frozen once its
// own system is solved, and the move of x to the BiCG point where that
// point's test solved the primal system.  Outputs: x, y, niter, rnorm,
// snorm, the status code (0 running / 2 zero residual / 15 both solved
// / 29 b'c = 0 / 38 <u_{k+1}, v_{k+1}> = 0) and nine flags: lq_tol,
// lq_mach, cg_tol, cg_mach, qr_tol, qr_mach, solved_primal, solved_dual,
// breakdown.
//
// Bound on an H100 SXM: memory bandwidth.  An iteration applies A and
// A^H once each (2 x 7 diagonals for the 7-point stencil) and must read
// v_k, u_k, v_{k-1}, u_{k-1}, x, d_bar, y, w_{k-2} and w_{k-3} and write
// v_{k+1}, u_{k+1}, x, d_bar, y and w_{k-1}: 14 + 15 words per row,
// 116 B in f32, 232 B in f64.
//
// Design: the launches of bilanczos.cuh (its note says where v_{k+1}
// and u_{k+1} are normalised and in which order the dots are summed;
// the stencil also takes the partials of <u_k, u_k> for the dual
// residual), four per iteration:
//   1. two_sided_stencil (grid) q, p, partials of <u_k, q>, <u_k, u_k>
//   2. br_fused      (grid)     alpha; q -= alpha v_k, p -= alpha u_k;
//                               partials of <p, q>, <v_k, q>, ||q||^2
//                               and ||v_k||^2; this iteration's rotation
//                               (from the last iteration's scalars, in
//                               one thread of each block); the primal x
//                               and d_bar updates; the dual direction
//                               w_{k-1} from u_{k-1} and y
//   3. bl_normalise  (grid)     v_{k+1} and u_{k+1} in place of q and p
//   4. br_scalars    (1 block)  beta_{k+1}, gamma_{k+1}; <v_k, v_{k+1}>
//                               = <v_k, q> / beta_{k+1} and
//                               ||v_{k+1}||^2 = ||q||^2 / beta_{k+1}^2
//                               (||v_k||^2 for both where <p, q> = 0);
//                               the rest of both chains, the nine flags
//                               and the status, in one thread, branch for
//                               branch as the TPU kernel
// and one finishing launch after the loop, x += zeta_bar d_bar where the
// BiCG point solved the primal system.  Where <p, q> = 0 after the
// primal system is solved, the dual goes on with v_{k+1} = v_k and
// u_{k+1} = u_k, which the normalising launch copies (bilanczos.cuh).
// w_{k-1} overwrites w_{k-3} in its buffer row by row, so two buffers
// hold the dual recurrence.  Bytes per row and iteration: the stencil 2 x
// 7 diagonals, v_k, u_k, v_{k-1}, u_{k-1} read and q, p written (20
// words), the fused launch q, p, v_k, u_k, x, d_bar, u_{k-1}, w_{k-2},
// w_{k-3}, y read and q, p, x, d_bar, w_{k-1}, y written (16 words), the
// normalising launch q and p read and written (4 words): 160 B in f32
// (bound 116), 320 B in f64 (bound 232).
#include "bilanczos.cuh"

namespace {

using namespace bilanczos;

enum ScalarSlot {
  EPSL = GAMMA1 + 1, EPSQ, C_KM1, S_KM1, DBAR_KM1, ZETA_KM1, ZETA_KM2,
  ETA_KM1, ZETABAR, PSIBAR_KM1, EPS_KM3, LAM_KM2, NORM_VK, TAU, RNORM, SNORM,
  CK, SK, ZKM1N, NSC
};
enum IntSlot {
  SP = GO + 1, SD, LQ_T, LQ_M, CG_T, CG_M, QR_T, QR_M, CGFLAG, BRK, NST
};
enum OwnRow { X = NSHARED_ROWS, Y, DBAR, W0, W1, NROWS };

// w_{k-2} sits in buffer W0 + (it + 1) mod 2 and w_{k-3} in W0 + it mod 2,
// where w_{k-1} goes (it the 0-based iteration count).
__device__ __forceinline__ int wkm2_row(int it0) { return W0 + (it0 + 1) % 2; }
__device__ __forceinline__ int wkm3_row(int it0) { return W0 + it0 % 2; }

// ||b||, ||c||, c'b, beta_1, gamma_1, the tolerances and the starting
// state (pallas_fused.py:7455-7475).
template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
br_init_scalars(const Dot* __restrict__ partial, int nparts, T* sc,
                int* st) {
  const T bb = sum_partials_in<T>(partial + PUQ * nparts, nparts);
  __syncthreads();
  const T cc = sum_partials_in<T>(partial + PUU * nparts, nparts);
  __syncthreads();
  const T chb = sum_partials_in<T>(partial + PPQ * nparts, nparts);
  if (threadIdx.x != 0) return;
  const T bnorm = sqrt(bb);
  const T cnorm = sqrt(cc);
  const T beta = sqrt(fabs(chb));
  sc[BETA] = beta;
  sc[GAMMA] = chb / safe(beta);
  sc[ALPHA] = T(0);
  sc[EPSL] = sc[ATOL] + sc[RTOL] * bnorm;
  sc[EPSQ] = sc[ATOL] + sc[RTOL] * cnorm;
  sc[C_KM1] = T(-1);
  for (int j = S_KM1; j < NSC; ++j) sc[j] = T(0);
  sc[NORM_VK] = bnorm / safe(static_cast<T>(fabs(beta)));
  sc[RNORM] = bnorm;
  sc[SNORM] = cnorm;
  for (int j = SP; j < NST; ++j) st[j] = 0;
  st[SP] = bnorm == T(0) ? 1 : 0;
  st[SD] = cnorm == T(0) ? 1 : 0;
  st[IT] = 0;
  st[GO] = 0;
  st[STATUS] = chb == T(0) ? BC_BREAKDOWN
               : (st[SP] == 1 && st[SD] == 1) ? ZERO_RESIDUAL : RUNNING;
}

// This iteration's rotation and what the vector updates need from the
// last iteration's scalars (pallas_fused.py:7506-7550).
template <typename T>
struct Pre {
  T ck, sk, zeta_km1, x_add, psi_km1, y_add, d;
  bool pm;
};

template <typename T>
__device__ __forceinline__ Pre<T> pre_step(const T* sc, const int* st,
                                           int it) {
  T ck_g, sk_g, d_km1;
  sym_givens(sc[DBAR_KM1], sc[GAMMA], ck_g, sk_g, d_km1);
  Pre<T> r;
  r.ck = it == 1 ? T(-1) : ck_g;
  r.sk = it == 1 ? T(0) : sk_g;
  r.pm = st[SP] == 0;
  r.zeta_km1 = r.pm && it >= 2 ? sc[ETA_KM1] / safe(d_km1) : sc[ZETA_KM1];
  r.x_add = r.pm && it >= 2 ? r.zeta_km1 : T(0);
  r.psi_km1 = it == 1 ? T(0) : r.ck * sc[PSIBAR_KM1];
  r.y_add = st[SD] == 0 && it >= 2 ? r.psi_km1 : T(0);
  r.d = safe(d_km1);
  return r;
}

// 2. alpha, q and p, the partials of <p, q>, <v_k, q>, ||q||^2 and
// ||v_k||^2; x, d_bar, w_{k-1} and y.
template <typename T>
__global__ void __launch_bounds__(kThreads)
br_fused(T* __restrict__ work, Dot* __restrict__ partial, T* sc,
         const int* st, long long n) {
  if (!st[GO]) return;
  const int it0 = st[IT];
  const int it = it0 + 1;
  const AlphaRows<T> lz(work, partial, sc, it0, n);
  __shared__ Pre<T> pre;
  if (threadIdx.x == 0) pre = pre_step(sc, st, it);
  __syncthreads();
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    sc[CK] = pre.ck;
    sc[SK] = pre.sk;
    sc[ZKM1N] = pre.zeta_km1;
  }
  const T ck = pre.ck;
  const T sk = pre.sk;
  const T a = pre.x_add * ck;
  const T bcoef = pre.x_add * sk;
  const bool pm = pre.pm;
  const T d = pre.d;
  const T y_add = pre.y_add;
  const T lam_km2 = sc[LAM_KM2];
  const T eps_km3 = sc[EPS_KM3];
  const T* ukm1 = row(work, U0 + prev(it0), n);
  const T* wkm2 = row(work, wkm2_row(it0), n);
  T* wkm3 = row(work, wkm3_row(it0), n);
  T* x = row(work, X, n);
  T* y = row(work, Y, n);
  T* dbar = row(work, DBAR, n);
  T t[3] = {T(0), T(0), T(0)};
  Dot qq = Dot(0);
  for (long long i = first_row(); i < n; i += row_stride()) {
    const auto lv = lz.load(i);
    const T di = dbar[i];
    const T xi = x[i];
    const T um = ukm1[i];
    const T w2i = wkm2[i];
    const T w3i = wkm3[i];
    const T yi = y[i];
    const T vi = lz.step(i, lv, t, qq);
    x[i] = xi + a * di + bcoef * vi;
    if (pm) dbar[i] = it == 1 ? vi : sk * di - ck * vi;
    const T w = (it == 2 ? um
                 : (it == 3 ? um - lam_km2 * w2i
                            : um - lam_km2 * w2i - eps_km3 * w3i)) / d;
    y[i] = yi + y_add * w;
    // w_{k-3} <- w_{k-2}, w_{k-2} <- w_{k-1} from the second iteration on
    wkm3[i] = it >= 2 ? w : w3i;
  }
  store_alpha_partials(t, qq, partial);
}

// 3. beta_{k+1}, gamma_{k+1}, the rest of the primal and dual chains,
// the flags and the status (pallas_fused.py:7506-7618).
template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
br_scalars(const Dot* __restrict__ partial, int nparts, T* sc, int* st,
           int transfer_to_bicg) {
  if (!st[GO]) return;
  const LanczosSums<T> sums = lanczos_sums<T>(partial, nparts);
  if (threadIdx.x != 0) return;
  const int it0 = st[IT];
  const int it = it0 + 1;
  const T uu = sums.uu;
  const T phq = sc[PHQ];
  const T beta1 = sc[BETA1];
  const T vhv = next_dot(sums, phq, beta1);
  const T nn = next_norm2(sums, phq, beta1);
  const bool is1 = it == 1;
  const bool is2 = it == 2;
  const T beta = sc[BETA];
  const T gamma = sc[GAMMA];
  const T alpha = sc[ALPHA];
  const T c_km1 = sc[C_KM1];
  const T s_km1 = sc[S_KM1];
  const T ck = sc[CK];
  const T sk = sc[SK];
  const T eps_km2 = s_km1 * beta;
  const T lam2 = ck * beta + sk * alpha;
  const T dbar2 = sk * beta - ck * alpha;
  const T lam3 = -c_km1 * ck * beta + sk * alpha;
  const T dbar3 = -c_km1 * sk * beta - ck * alpha;
  const T lam_km1 = is2 ? lam2 : lam3;
  const T dbar_k = is1 ? alpha : (is2 ? dbar2 : dbar3);

  // primal block (frozen once solved)
  const bool pm = st[SP] == 0;
  const T zeta_km1 = sc[ZKM1N];
  const T zeta_km2 = pm && it >= 3 ? sc[ZETA_KM1] : sc[ZETA_KM2];
  const T eta_k = pm ? (is1 ? beta
                            : (is2 ? -lam_km1 * zeta_km1
                                   : -eps_km2 * zeta_km2 - lam_km1 * zeta_km1))
                     : sc[ETA_KM1];

  // dual block
  const bool dm = st[SD] == 0;
  const T psibar_k = is1 ? gamma : sk * sc[PSIBAR_KM1];
  const T tau = dm ? sc[TAU] + uu : sc[TAU];
  const T snorm = dm ? static_cast<T>(fabs(psibar_k)) * sqrt(tau) : sc[SNORM];

  const T norm_vk = sc[NORM_VK];
  const T norm_vkp1 = sqrt(nn);
  const T mu = beta * (s_km1 * zeta_km2 - c_km1 * ck * zeta_km1)
               + alpha * sk * zeta_km1;
  const T om = beta1 * sk * zeta_km1;
  const T th = mu * om * vhv;
  T rnorm_lq = is1 ? sc[RNORM]
                   : sqrt(mu * mu * norm_vk * norm_vk
                          + om * om * norm_vkp1 * norm_vkp1 + T(2) * th);
  rnorm_lq = pm ? rnorm_lq : sc[RNORM];
  const bool dbar_ok = fabs(dbar_k) > eps_of<T>();
  const T zetabar = pm && dbar_ok ? eta_k / safe(dbar_k) : sc[ZETABAR];
  const T rho = beta1 * (sk * zeta_km1 - ck * zetabar);
  const T rnorm_cg = static_cast<T>(fabs(rho)) * norm_vkp1;
  const T epsl = sc[EPSL];
  const bool cg_t_b = transfer_to_bicg && dbar_ok && rnorm_cg <= epsl;
  const bool cg_m_b = transfer_to_bicg && dbar_ok && (rnorm_cg + T(1)) <= T(1);
  const int lq_t = pm ? (rnorm_lq <= epsl ? 1 : 0) : st[LQ_T];
  const int lq_m = pm ? ((rnorm_lq + T(1)) <= T(1) ? 1 : 0) : st[LQ_M];
  const int cg_t = pm ? (cg_t_b ? 1 : 0) : st[CG_T];
  const int cg_m = pm ? (cg_m_b ? 1 : 0) : st[CG_M];
  const bool solved_lq = lq_t == 1 || lq_m == 1;
  const bool solved_cg = cg_t == 1 || cg_m == 1;
  const int sp = pm && (solved_lq || solved_cg) ? 1 : st[SP];
  const int qr_t = dm ? (snorm <= sc[EPSQ] ? 1 : 0) : st[QR_T];
  const int qr_m = dm ? ((snorm + T(1)) <= T(1) ? 1 : 0) : st[QR_M];
  const int sd = dm && (qr_t == 1 || qr_m == 1) ? 1 : st[SD];
  const bool brk = !solved_lq && !solved_cg && phq == T(0);
  const int code = brk ? UV_BREAKDOWN
                   : (sp == 1 && sd == 1 ? SOLVED_PRIMAL_DUAL : RUNNING);
  const int cgflag =
      st[CGFLAG] == 1 || (solved_cg && pm && !solved_lq) ? 1 : st[CGFLAG];

  sc[C_KM1] = ck;
  sc[S_KM1] = sk;
  sc[DBAR_KM1] = dbar_k;
  sc[ZETA_KM1] = zeta_km1;
  sc[ZETA_KM2] = zeta_km2;
  sc[ETA_KM1] = eta_k;
  sc[ZETABAR] = zetabar;
  sc[PSIBAR_KM1] = psibar_k;
  if (it >= 3) sc[EPS_KM3] = eps_km2;
  if (it >= 2) sc[LAM_KM2] = lam_km1;
  sc[NORM_VK] = norm_vkp1;
  sc[TAU] = tau;
  sc[RNORM] = rnorm_lq;
  sc[SNORM] = snorm;
  st[SP] = sp;
  st[SD] = sd;
  st[LQ_T] = lq_t;
  st[LQ_M] = lq_m;
  st[CG_T] = cg_t;
  st[CG_M] = cg_m;
  st[QR_T] = qr_t;
  st[QR_M] = qr_m;
  st[CGFLAG] = cgflag;
  st[BRK] = brk ? 1 : 0;
  commit_lanczos(sc);
  st[IT] = it;
  st[STATUS] = code;
}

// After the loop: x += zeta_bar d_bar where the BiCG point solved the
// primal system.
template <typename T>
__global__ void __launch_bounds__(kThreads)
br_transfer(T* __restrict__ work, const T* sc, const int* st, long long n) {
  if (!st[CGFLAG]) return;
  const T zetabar = sc[ZETABAR];
  T* x = row(work, X, n);
  const T* dbar = row(work, DBAR, n);
  for (long long i = first_row(); i < n; i += row_stride()) {
    x[i] = x[i] + zetabar * dbar[i];
  }
}

struct Bilqr {
  static constexpr int kRows = NROWS - NSHARED_ROWS;
  static constexpr int kWithUU = 1;
  template <typename T>
  static void init_scalars(Dot* partial, int grid, T* sc, int* st,
                           cudaStream_t s) {
    br_init_scalars<T><<<1, kReduceThreads, 0, s>>>(partial, grid, sc, st);
  }
  template <typename T>
  static void fused(T* work, Dot* partial, T* sc, int* st, long long n,
                    int grid, cudaStream_t s) {
    br_fused<T><<<grid, kThreads, 0, s>>>(work, partial, sc, st, n);
  }
  template <typename T>
  static void scalars(Dot* partial, int grid, T* sc, int* st, int flag,
                      cudaStream_t s) {
    br_scalars<T><<<1, kReduceThreads, 0, s>>>(partial, grid, sc, st, flag);
  }
};

template <typename T>
int finish(void* work, const void* sc, const void* st, long long n, int grid,
           void* stream) {
  br_transfer<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<T*>(work), static_cast<const T*>(sc),
      static_cast<const int*>(st), n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define KTT_BR_INIT(NAME, T)                                                  \
  extern "C" int NAME(const void* b, const void* c, void* work,              \
                      void* partial, void* sc, void* st, long long n,        \
                      int grid, void* stream) {                              \
    return bilanczos::init<T, Bilqr>(b, c, work, partial, sc, st, n,    \
                                          grid, stream);                     \
  }

#define KTT_BR_ITERATE(NAME, T, P)                                            \
  extern "C" int NAME(const void* pd, const void* offsets, int nd,           \
                      const void* pda, const void* offsets_a, int nda,       \
                      long long lo, long long hi, long long lo_a,            \
                      long long hi_a, void* work, void* partial, void* sc,   \
                      void* st, long long n, int grid, int flag, int iters,  \
                      int cap, void* stream) {                               \
    return bilanczos::iterate<T, P, Bilqr>(                                  \
        pd, offsets, nd, pda, offsets_a, nda, lo, hi, lo_a, hi_a, work,      \
        partial, sc, st, n, grid, flag, iters, cap, stream);                 \
  }

#define KTT_BR_FINISH(NAME, T)                                                \
  extern "C" int NAME(void* work, const void* sc, const void* st,            \
                      long long n, int grid, void* stream) {                 \
    return finish<T>(work, sc, st, n, grid, stream);                         \
  }

KTT_BR_INIT(ktt_bilqr_dia_init_f32, float)
KTT_BR_INIT(ktt_bilqr_dia_init_f64, double)
KTT_BR_ITERATE(ktt_bilqr_dia_iterate_f32_f32, float, float)
KTT_BR_ITERATE(ktt_bilqr_dia_iterate_f32_bf16, float, __nv_bfloat16)
KTT_BR_ITERATE(ktt_bilqr_dia_iterate_f32_f16, float, __half)
KTT_BR_ITERATE(ktt_bilqr_dia_iterate_f64_f64, double, double)
KTT_BR_FINISH(ktt_bilqr_dia_finish_f32, float)
KTT_BR_FINISH(ktt_bilqr_dia_finish_f64, double)
