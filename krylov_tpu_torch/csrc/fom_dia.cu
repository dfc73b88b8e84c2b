// Whole restarted FOM(mem) solve of A x = b for a DIA matrix, M = N = I,
// on Hopper (sm_90a), with no grid-wide barrier.
//
// Replaces the TPU kernel krylov_tpu/ops/pallas_fused.py:4933
// fom_dia_fused and computes what it computes (pallas_fused.py:
// 4970-5090): the Arnoldi process of GMRES with the LU factorisation of
// the Hessenberg in place of its QR (u_i -= l_{i-1} u_{i-1}, l_k =
// ||w|| / U_kk, zz_k = -l_{k-1} zz_{k-1}, pallas_fused.py:5013-5027), the
// back substitution on U with a zero pivot dividing by 1, and restarts
// from b - A x.  Outputs: x, niter, rnorm, the status code (0 running /
// 1 solved / 2 zero residual / 28 breakdown without convergence, which
// the solver reports as "inconsistent linear system" / 100 itmax
// reached), the inconsistent flag and the number of passes.
//
// Design: the Arnoldi launches of arnoldi.cuh (never in confirm mode:
// FOM has no compressed panel), with three one-block launches of its
// own, each in one thread, branch for branch as the TPU kernel: the
// column launch, the back substitution and the restart launch.  Bounds
// are in arnoldi.cuh.
#include "arnoldi.cuh"

namespace {

using namespace arnoldi;

constexpr int INCONS_FOM = 28;

// ||w||, the LU column k and the residual estimate ||w|| |zz_k / U_kk|.
template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
fom_column(const T* __restrict__ ww, int nparts, T* sc, int* st,
           int mem) {
  if (!st[GO]) return;
  const int k = st[K];
  const T wnorm2 = ktt::sum_partials(ww, nparts);
  if (threadIdx.x != 0) return;
  const T hbis = sqrt(wnorm2);
  T* h = sc + h_at(mem);
  T* l = sc + c_at(mem);
  T* zz = sc + zz_at(mem);
  T* U = sc + r_at(mem);
  for (int i = 1; i <= k; ++i) h[i] = h[i] - l[i - 1] * h[i - 1];
  const T safe_u = ktt::safe(h[k]);
  if (k >= 1) zz[k] = -l[k - 1] * zz[k - 1];
  l[k] = hbis / safe_u;
  for (int i = 0; i <= k; ++i) U[static_cast<long long>(i) * mem + k] = h[i];
  end_column(sc, st, k, hbis, hbis * static_cast<T>(fabs(zz[k] / safe_u)),
             mem);
}

// U[:kk, :kk] y = zz[:kk], a zero pivot dividing by 1.
template <typename T>
__global__ void fom_backsub(T* sc, int* st, int mem) {
  if (st[STAGE] != S_BACKSUB || threadIdx.x != 0) return;
  const int kk = st[KK];
  const T* zz = sc + zz_at(mem);
  const T* U = sc + r_at(mem);
  T* y = sc + y_at(mem);
  for (int i = kk - 1; i >= 0; --i) {
    const T* row = U + static_cast<long long>(i) * mem;
    T acc = zz[i];
    for (int j = i + 1; j < kk; ++j) acc = acc - row[j] * y[j];
    y[i] = acc / ktt::safe(row[i]);
  }
  st[SING] = 0;
  st[STAGE] = S_XACC;
}

// ||b - A x|| where the pass restarts, and the status chain of
// pallas_fused.py:5080-5087.
template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
fom_restart(const T* __restrict__ partial, int nparts, T* sc, int* st,
            int mem) {
  if (st[STAGE] != S_XACC) return;
  const int flags = st[FLAGS];
  const bool resid = flags & F_RESID;
  const bool brk = flags & F_BREAK;
  const bool tired = flags & F_TIRED;
  const bool glob_done = resid || brk || tired;
  const T rr = glob_done ? T(0) : ktt::sum_partials(partial, nparts);
  if (threadIdx.x != 0) return;
  int code = TIRED;
  if (brk) code = INCONS_FOM;
  if (resid) code = SOLVED;
  if (brk && !resid) st[INCONS] = 1;
  st[STATUS] = glob_done ? code : RUNNING;
  if (!glob_done) {
    const T beta_r = sqrt(rr);
    sc[zz_at(mem)] = beta_r;
    sc[BETA_R] = beta_r;
    sc[RNORM] = beta_r;
    st[NPASS] += 1;
  }
  st[K] = 0;
  st[STAGE] = glob_done ? S_NONE : S_RESTARTED;
}

struct Fom {
  template <typename T>
  static void column(T* ww, int grid, T* sc, int* st, int mem,
                     cudaStream_t s) {
    fom_column<T><<<1, kReduceThreads, 0, s>>>(ww, grid, sc, st, mem);
  }
  template <typename T>
  static void backsub(T* sc, int* st, int mem, cudaStream_t s) {
    fom_backsub<T><<<1, 32, 0, s>>>(sc, st, mem);
  }
  template <typename T>
  static void restart(T* partial, int grid, T* sc, int* st, int mem, int,
                      cudaStream_t s) {
    fom_restart<T><<<1, kReduceThreads, 0, s>>>(partial, grid, sc, st, mem);
  }
};

}  // namespace

#define KTT_FOM_INIT(NAME, T)                                                 \
  extern "C" int NAME(const void* b, void* V, void* x, void* partial,        \
                      void* sc, void* st, long long n, int grid, int mem,    \
                      int itmax, void* stream) {                             \
    return arnoldi::init<T, T>(b, V, x, partial, sc, st, n, grid, mem,       \
                               itmax, stream);                               \
  }

#define KTT_FOM_ITERATE(NAME, T, P)                                           \
  extern "C" int NAME(const void* pd, const void* offsets, int nd,           \
                      long long lo, long long hi, const void* b, void* w,    \
                      void* V, void* x, void* partial, void* sc, void* st,   \
                      long long n, int grid, int mem, int iters, int cap,    \
                      void* stream) {                                        \
    return arnoldi::iterate<T, P, T, Fom>(pd, offsets, nd, lo, hi, b, w, V,  \
                                          x, partial, sc, st, n, grid, mem,  \
                                          0, iters, cap, stream);            \
  }

KTT_FOM_INIT(ktt_fom_dia_init_f32, float)
KTT_FOM_INIT(ktt_fom_dia_init_f64, double)
KTT_FOM_ITERATE(ktt_fom_dia_iterate_f32_f32, float, float)
KTT_FOM_ITERATE(ktt_fom_dia_iterate_f32_bf16, float, __nv_bfloat16)
KTT_FOM_ITERATE(ktt_fom_dia_iterate_f32_f16, float, __half)
KTT_FOM_ITERATE(ktt_fom_dia_iterate_f64_f64, double, double)
