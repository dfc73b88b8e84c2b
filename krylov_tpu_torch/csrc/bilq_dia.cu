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
// A^H once each (2 x 28 B per row in f32 for the 7-point stencil) and
// must read v_k, u_k, v_{k-1}, u_{k-1}, x and d_bar and write v_{k+1},
// u_{k+1}, x and d_bar: (56 + 40) B per row, 96 B.
//
// Design: the launches of bilanczos.cuh (the two stencils with the
// alpha partials, then the q/p update with the <p, q> partials), then
//   3. bq_next    (grid)     beta_{k+1}, gamma_{k+1}; x += zeta c d_bar
//                            + zeta s v_k and d_bar = s d_bar - c v_k
//                            with this iteration's rotation (which needs
//                            only the last iteration's scalars),
//                            v_{k+1} and u_{k+1} in place of q and p,
//                            partials of <v_k, v_{k+1}> and
//                            ||v_{k+1}||^2
//   4. bq_scalars (1 block)  the rest of the LQ chain, the residual
//                            estimates and the status, in one thread,
//                            branch for branch as the TPU kernel
// and one finishing launch after the loop, x += zeta_bar d_bar where the
// BiCG point stopped the solve.  Per iteration this design moves
// (56 + 24) + 24 + (40 + 8) B per row in f32: 152 B.
#include "bilanczos.cuh"

namespace {

using namespace bilanczos;

// slots of the scalar arrays after the shared ones; ATOL and RTOL are
// set by the host
enum ScalarSlot {
  EPS_LIM = GAMMA1 + 1, C_KM1, S_KM1, DBAR_KM1, ZETA_KM1, ZETA_KM2, ETA_KM1,
  ZETABAR, NORM_VK, RNORM, CK, SK, ZKM1N, NSC
};
enum IntSlot { CGFLAG = GO + 1, NST };
// the method's own rows of the vector workspace
enum OwnRow { X = NSHARED_ROWS, DBAR, NROWS };

// ||b||, b'c = ||b||^2, beta_1, gamma_1 and the starting state.
template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
bq_init_scalars(const T* __restrict__ partial, int nparts, T* sc, int* st) {
  const T bb = sum_partials(partial + PUQ * nparts, nparts);
  if (threadIdx.x != 0) return;
  const T bnorm = sqrt(bb);
  const T chb = bnorm * bnorm;          // c = b on the fused path
  const T beta = sqrt(fabs(chb));
  const T eps_lim = sc[ATOL] + sc[RTOL] * bnorm;
  sc[BETA] = beta;
  sc[GAMMA] = chb / safe(beta);
  sc[ALPHA] = sc[PHQ] = sc[BETA1] = sc[GAMMA1] = T(0);
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

// 3. beta_{k+1}, gamma_{k+1}, the x and d_bar updates, v_{k+1} and
// u_{k+1}, partials of <v_k, v_{k+1}> and ||v_{k+1}||^2.
template <typename T>
__global__ void __launch_bounds__(kThreads)
bq_next(T* __restrict__ work, T* __restrict__ partial, T* sc, const int* st,
        long long n) {
  if (!st[GO]) return;
  T phq, beta1, gamma1;
  bi_next_scalars(partial, sc, phq, beta1, gamma1);
  const int it0 = st[IT];
  const int it = it0 + 1;
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
  const T* vk = row(work, V0 + cur(it0), n);
  T* x = row(work, X, n);
  T* dbar = row(work, DBAR, n);
  T svv = T(0);
  T snn = T(0);
  for (long long i = first_row(); i < n; i += row_stride()) {
    const T vi = vk[i];
    const T di = dbar[i];
    x[i] = x[i] + a * di + bcoef * vi;
    dbar[i] = it == 1 ? vi : sk * di - ck * vi;
    const T vn = bi_next_row(work, it0, n, i, phq, beta1, gamma1);
    svv += vi * vn;
    snn += vn * vn;
  }
  const int nparts = gridDim.x;
  store_partials(svv, partial + PVV * nparts, snn, partial + PNN * nparts);
}

// 4. The rest of the LQ chain, the LQ and BiCG residual estimates and the
// status (pallas_fused.py:4636-4698).
template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
bq_scalars(const T* __restrict__ partial, int nparts, T* sc, int* st,
           int transfer_to_bicg) {
  if (!st[GO]) return;
  const T vhv = sum_partials(partial + PVV * nparts, nparts);
  __syncthreads();
  const T nn = sum_partials(partial + PNN * nparts, nparts);
  if (threadIdx.x != 0) return;
  const int it = st[IT] + 1;
  const bool is1 = it == 1;
  const bool is2 = it == 2;
  const T beta = sc[BETA];
  const T alpha = sc[ALPHA];
  const T phq = sc[PHQ];
  const T beta1 = sc[BETA1];
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
  sc[BETA] = beta1;
  sc[GAMMA] = sc[GAMMA1];
  sc[C_KM1] = ck;
  sc[S_KM1] = sk;
  sc[DBAR_KM1] = dbar_k;
  sc[ZETA_KM1] = zeta_km1;
  sc[ZETA_KM2] = zeta_km2;
  sc[ETA_KM1] = eta_k;
  sc[ZETABAR] = zetabar;
  sc[NORM_VK] = norm_vkp1;
  sc[RNORM] = rnorm_lq;
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
  static void init_scalars(T* partial, int grid, T* sc, int* st,
                           cudaStream_t s) {
    bq_init_scalars<T><<<1, kReduceThreads, 0, s>>>(partial, grid, sc, st);
  }
  template <typename T>
  static void next(T* work, T* partial, T* sc, int* st, long long n,
                   int grid, int, cudaStream_t s) {
    bq_next<T><<<grid, kThreads, 0, s>>>(work, partial, sc, st, n);
  }
  template <typename T>
  static void scalars(T* partial, int grid, T* sc, int* st, int flag,
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
                      void* work, void* partial, void* sc, void* st,         \
                      long long n, int grid, int flag, int iters, int cap,   \
                      void* stream) {                                        \
    return bilanczos::iterate<T, P, Bilq>(pd, offsets, nd, pda, offsets_a,   \
                                          nda, work, partial, sc, st, n,     \
                                          grid, flag, iters, cap, stream);   \
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
