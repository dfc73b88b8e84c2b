// Whole BiLQ solve of A x = b for a DIA matrix, shadow vector c = b, on
// Hopper (sm_90a), with no grid-wide barrier.
//
// Replaces the TPU kernel krylov_tpu/ops/pallas_fused.py:4545
// bilq_dia_fused and computes what it computes (pallas_fused.py:
// 4575-4706): the two-sided Lanczos process on A and A^H, the LQ
// factorisation of T_k, the residual estimates of the LQ and BiCG
// points and, with transfer_to_bicg, the move of x to the BiCG point
// when its test stops the solve.  Outputs: x, niter, rnorm and the
// status code (0 running / 2 zero residual / 29 b'c = 0 / 35 the LQ
// point solved / 36 the BiCG point solved / 38 <u_{k+1}, v_{k+1}> = 0).
//
// Bound on an H100 SXM: memory bandwidth.  An iteration applies A and
// A^H once each (2 x 7 diagonals for the 7-point stencil) and must read
// v_k, u_k, v_{k-1}, u_{k-1}, x and d_bar and write v_{k+1}, u_{k+1}, x
// and d_bar: 14 + 10 words per row, 96 B in f32, 192 B in f64.
//
// Design: the launches of bilanczos.cuh (its note says where v_{k+1} and
// u_{k+1} are normalised and in which order the dots are summed), four
// per iteration:
//   1. two_sided_stencil (grid)  q, p, partials of <u_k, q>
//   2. bq_fused     (grid)     alpha; q -= alpha v_k, p -= alpha u_k;
//                              partials of <p, q>, <v_k, q>, ||q||^2 and
//                              ||v_k||^2; x += zeta c d_bar + zeta s v_k
//                              and d_bar = s d_bar - c v_k with this
//                              iteration's rotation (from the last
//                              iteration's scalars, in one thread of each
//                              block)
//   3. bl_normalise (grid)     v_{k+1} and u_{k+1} in place of q and p
//   4. bq_scalars   (1 block)  beta_{k+1}, gamma_{k+1}; <v_k, v_{k+1}>
//                              and ||v_{k+1}||^2 from the sums; the rest
//                              of the LQ chain, the residual estimates
//                              and the status, in one thread, branch for
//                              branch as the TPU kernel
// and one finishing launch after the loop, x += zeta_bar d_bar where the
// BiCG point stopped the solve.  Bytes per row and iteration: the
// stencil 2 x 7 diagonals, v_k, u_k, v_{k-1}, u_{k-1} read and q, p
// written (20 words), the fused launch q, p, v_k, u_k, x, d_bar read and
// q, p, x, d_bar written (10 words), the normalising launch q and p read
// and written (4 words): 136 B in f32 (bound 96), 272 B in f64 (bound
// 192).
#include "bilanczos.cuh"

namespace {

using namespace bilanczos;

// slots of the scalar arrays after the shared ones; ATOL and RTOL are
// set by the host
enum ScalarSlot {
  EPS_LIM = GAMMA1 + 1, C_KM1, S_KM1, DBAR_KM1, ZETA_KM1, ZETA_KM2,
  ETA_KM1, ZETABAR, NORM_VK, RNORM, CK, SK, ZKM1N, NSC
};
enum IntSlot { CGFLAG = GO + 1, NST };
// the method's own rows of the vector workspace
enum OwnRow { X = NSHARED_ROWS, DBAR, NROWS };

// ||b||, b'c = ||b||^2, beta_1, gamma_1 and the starting state.
template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
bq_init_scalars(const Dot* __restrict__ partial, int nparts, T* sc,
                int* st) {
  const T bb = sum_partials_in<T>(partial + PUQ * nparts, nparts);
  if (threadIdx.x != 0) return;
  const T bnorm = sqrt(bb);
  const T chb = bnorm * bnorm;          // c = b on the fused path
  const T beta = sqrt(fabs(chb));
  const T eps_lim = sc[ATOL] + sc[RTOL] * bnorm;
  sc[BETA] = beta;
  sc[GAMMA] = chb / safe(beta);
  sc[ALPHA] = T(0);
  sc[EPS_LIM] = eps_lim;
  sc[C_KM1] = T(-1);
  sc[S_KM1] = sc[DBAR_KM1] = sc[ZETA_KM1] = sc[ZETA_KM2] = T(0);
  sc[ETA_KM1] = sc[ZETABAR] = sc[CK] = sc[SK] = sc[ZKM1N] = T(0);
  sc[NORM_VK] = bnorm / safe(static_cast<T>(fabs(beta)));
  sc[RNORM] = bnorm;
  st[IT] = 0;
  st[GO] = 0;
  st[CGFLAG] = 0;
  st[STATUS] = bnorm == T(0) ? ZERO_RESIDUAL
               : chb == T(0) ? BC_BREAKDOWN
               : bnorm <= eps_lim ? SOLVED_LQ : RUNNING;
}

// This iteration's rotation (c_k, s_k) from d_bar_{k-1} and gamma_k
// (none at the first iteration: c = -1, s = 0) and zeta_{k-1}
// (pallas_fused.py:4634-4655), from the last iteration's scalars.
template <typename T>
struct Rotation {
  T ck, sk, zeta_km1;
};

template <typename T>
__device__ __forceinline__ Rotation<T> rotation(const T* sc, int it) {
  T ck_g, sk_g, d_km1;
  sym_givens(sc[DBAR_KM1], sc[GAMMA], ck_g, sk_g, d_km1);
  Rotation<T> r;
  r.ck = it == 1 ? T(-1) : ck_g;
  r.sk = it == 1 ? T(0) : sk_g;
  r.zeta_km1 = it >= 2 ? sc[ETA_KM1] / safe(d_km1) : sc[ZETA_KM1];
  return r;
}

// 2. alpha, q and p, the partials of <p, q>, <v_k, q>, ||q||^2 and
// ||v_k||^2; the x and d_bar updates.
template <typename T>
__global__ void __launch_bounds__(kThreads)
bq_fused(T* __restrict__ work, Dot* __restrict__ partial, T* sc,
         const int* st, long long n) {
  if (!st[GO]) return;
  const int it0 = st[IT];
  const int it = it0 + 1;
  const AlphaRows<T> lz(work, partial, sc, it0, n);
  __shared__ Rotation<T> rot;
  if (threadIdx.x == 0) rot = rotation(sc, it);
  __syncthreads();
  const T ck = rot.ck;
  const T sk = rot.sk;
  const T x_add = it >= 2 ? rot.zeta_km1 : T(0);
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    sc[CK] = ck;
    sc[SK] = sk;
    sc[ZKM1N] = rot.zeta_km1;
  }
  const T a = x_add * ck;
  const T bcoef = x_add * sk;
  T* x = row(work, X, n);
  T* dbar = row(work, DBAR, n);
  T t[3] = {T(0), T(0), T(0)};
  Dot qq = Dot(0);
  for (long long i = first_row(); i < n; i += row_stride()) {
    const auto lv = lz.load(i);
    const T di = dbar[i];
    const T xi = x[i];
    const T vi = lz.step(i, lv, t, qq);
    x[i] = xi + a * di + bcoef * vi;
    dbar[i] = it == 1 ? vi : sk * di - ck * vi;
  }
  store_alpha_partials(t, qq, partial);
}

// 3. beta_{k+1}, gamma_{k+1}, the rest of the LQ chain, the LQ and BiCG
// residual estimates and the status (pallas_fused.py:4636-4698).
template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
bq_scalars(const Dot* __restrict__ partial, int nparts, T* sc, int* st,
           int transfer_to_bicg) {
  if (!st[GO]) return;
  const LanczosSums<T> sums = lanczos_sums<T>(partial, nparts);
  if (threadIdx.x != 0) return;
  const int it0 = st[IT];
  const int it = it0 + 1;
  const T phq = sc[PHQ];
  const T beta1 = sc[BETA1];
  const T vhv = next_dot(sums, phq, beta1);
  const T nn = next_norm2(sums, phq, beta1);
  const bool is1 = it == 1;
  const bool is2 = it == 2;
  const T beta = sc[BETA];
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
  const T zeta_km1 = sc[ZKM1N];
  const T zeta_km2 = it >= 3 ? sc[ZETA_KM1] : sc[ZETA_KM2];
  const T eta_k = is1 ? beta
                  : (is2 ? -lam_km1 * zeta_km1
                         : -eps_km2 * zeta_km2 - lam_km1 * zeta_km1);
  const T norm_vk = sc[NORM_VK];
  const T norm_vkp1 = sqrt(nn);
  const T mu = beta * (s_km1 * zeta_km2 - c_km1 * ck * zeta_km1)
               + alpha * sk * zeta_km1;
  const T om = beta1 * sk * zeta_km1;
  const T th = mu * om * vhv;
  const T rnorm_lq =
      is1 ? sc[RNORM]
          : sqrt(mu * mu * norm_vk * norm_vk
                 + om * om * norm_vkp1 * norm_vkp1 + T(2) * th);
  const bool dbar_ok = fabs(dbar_k) > eps_of<T>();
  const T zetabar = dbar_ok ? eta_k / safe(dbar_k) : sc[ZETABAR];
  const T rho = beta1 * (sk * zeta_km1 - ck * zetabar);
  const T rnorm_cg = static_cast<T>(fabs(rho)) * norm_vkp1;
  const T eps_lim = sc[EPS_LIM];
  const bool solved_lq = rnorm_lq <= eps_lim;
  const bool solved_cg = transfer_to_bicg && dbar_ok && rnorm_cg <= eps_lim;
  const bool breakdown = !solved_lq && !solved_cg && phq == T(0);
  int code = RUNNING;
  if (breakdown) code = UV_BREAKDOWN;
  if (solved_lq) code = SOLVED_LQ;
  if (solved_cg && !solved_lq) code = SOLVED_CG;
  sc[C_KM1] = ck;
  sc[S_KM1] = sk;
  sc[DBAR_KM1] = dbar_k;
  sc[ZETA_KM1] = zeta_km1;
  sc[ZETA_KM2] = zeta_km2;
  sc[ETA_KM1] = eta_k;
  sc[ZETABAR] = zetabar;
  sc[NORM_VK] = norm_vkp1;
  sc[RNORM] = rnorm_lq;
  commit_lanczos(sc);
  st[CGFLAG] = solved_cg && !solved_lq ? 1 : 0;
  st[IT] = it;
  st[STATUS] = code;
}

// After the loop: x += zeta_bar d_bar where the BiCG point stopped the
// solve.
template <typename T>
__global__ void __launch_bounds__(kThreads)
bq_transfer(T* __restrict__ work, const T* sc, const int* st, long long n) {
  if (!st[CGFLAG]) return;
  const T zetabar = sc[ZETABAR];
  T* x = row(work, X, n);
  const T* dbar = row(work, DBAR, n);
  for (long long i = first_row(); i < n; i += row_stride()) {
    x[i] = x[i] + zetabar * dbar[i];
  }
}

struct Bilq {
  static constexpr int kRows = NROWS - NSHARED_ROWS;
  static constexpr int kWithUU = 0;
  template <typename T>
  static void init_scalars(Dot* partial, int grid, T* sc, int* st,
                           cudaStream_t s) {
    bq_init_scalars<T><<<1, kReduceThreads, 0, s>>>(partial, grid, sc, st);
  }
  template <typename T>
  static void fused(T* work, Dot* partial, T* sc, int* st, long long n,
                    int grid, cudaStream_t s) {
    bq_fused<T><<<grid, kThreads, 0, s>>>(work, partial, sc, st, n);
  }
  template <typename T>
  static void scalars(Dot* partial, int grid, T* sc, int* st, int flag,
                      cudaStream_t s) {
    bq_scalars<T><<<1, kReduceThreads, 0, s>>>(partial, grid, sc, st, flag);
  }
};

template <typename T>
int finish(void* work, const void* sc, const void* st, long long n, int grid,
           void* stream) {
  bq_transfer<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<T*>(work), static_cast<const T*>(sc),
      static_cast<const int*>(st), n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define KTT_BQ_INIT(NAME, T)                                                  \
  extern "C" int NAME(const void* b, const void* c, void* work,              \
                      void* partial, void* sc, void* st, long long n,        \
                      int grid, void* stream) {                              \
    return bilanczos::init<T, Bilq>(b, c, work, partial, sc, st, n, grid,    \
                                    stream);                                 \
  }

#define KTT_BQ_ITERATE(NAME, T, P)                                            \
  extern "C" int NAME(const void* pd, const void* offsets, int nd,           \
                      const void* pda, const void* offsets_a, int nda,       \
                      long long lo, long long hi, long long lo_a,            \
                      long long hi_a, void* work, void* partial, void* sc,   \
                      void* st, long long n, int grid, int flag, int iters,  \
                      int cap, void* stream) {                               \
    return bilanczos::iterate<T, P, Bilq>(                                   \
        pd, offsets, nd, pda, offsets_a, nda, lo, hi, lo_a, hi_a, work,      \
        partial, sc, st, n, grid, flag, iters, cap, stream);                 \
  }

#define KTT_BQ_FINISH(NAME, T)                                                \
  extern "C" int NAME(void* work, const void* sc, const void* st,            \
                      long long n, int grid, void* stream) {                 \
    return finish<T>(work, sc, st, n, grid, stream);                         \
  }

KTT_BQ_INIT(ktt_bilq_dia_init_f32, float)
KTT_BQ_INIT(ktt_bilq_dia_init_f64, double)
KTT_BQ_ITERATE(ktt_bilq_dia_iterate_f32_f32, float, float)
KTT_BQ_ITERATE(ktt_bilq_dia_iterate_f32_bf16, float, __nv_bfloat16)
KTT_BQ_ITERATE(ktt_bilq_dia_iterate_f32_f16, float, __half)
KTT_BQ_ITERATE(ktt_bilq_dia_iterate_f64_f64, double, double)
KTT_BQ_FINISH(ktt_bilq_dia_finish_f32, float)
KTT_BQ_FINISH(ktt_bilq_dia_finish_f64, double)
