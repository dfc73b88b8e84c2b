// Whole GPMR solve of the generalized partitioned system
// [lam I A; B mu I][x; y] = [b; c] for two square DIA matrices A and B on
// Hopper (sm_90a), with no grid-wide barrier.
//
// Replaces the TPU kernel krylov_tpu/ops/pallas_fused.py:8220
// gpmr_dia_fused and computes what it computes (pallas_fused.py:
// 8260-8495): the Montoison-Orban process (A on u_k, B on v_k, each on its
// own aligned diagonals and offsets) with classical Gram-Schmidt against
// the whole basis (all 2k dots first, then the subtraction), the two new
// columns of S_{k+1}.k through the k - 1 stored reflection quadruples and
// a cascade of four new ones, the update of zt and the status (1 solved,
// 7 both new norms at most eps^(3/4), 100 when k reaches mem); after the
// loop the back substitution on the 2k x 2k triangle, whose pivots of
// modulus at most eps^(3/4) give 0 and the inconsistent flag, and
// x = sum zt_{2i} V_i, y = sum zt_{2i+1} U_i.  Outputs: x, y, niter,
// rNorm, the status code and the flag.
//
// Bound on an H100 SXM: memory bandwidth.  Iteration k applies A and B
// once each (2 x 28 B per row in f32 for 7-point stencils), must read the
// 2k basis vectors V_0..V_{k-1} and U_0..U_{k-1} once (v_k and u_k among
// them) and write v_{k+1} and u_{k+1}: (56 + 8k + 8) B per row; after the
// loop the 2 niter basis vectors are read once more and x and y written.
//
// Design.  Four launches per iteration:
//   1. gp_stencil (grid)   GO; q = A u_k, p = B v_k into two work rows;
//                          the per-block partials of h_j = <V_j, q> and
//                          f_j = <U_j, p> for j < k, eight of each per
//                          pass over the rows, so q and p are read once
//                          per eight dots
//   2. gp_orth     (grid)  h and f summed from the partials in every
//                          block in a fixed order (block 0 keeps them in
//                          the scalar array for launch 3);
//                          q -= sum_j h_j V_j, p -= sum_j f_j U_j, j in
//                          order; the partials of ||q||^2 and ||p||^2
//   3. gp_update   (grid)  Haux and Faux summed in every block; thread 0
//                          of every block builds the two columns in shared
//                          memory, applies the stored quadruples and the
//                          new cascade, updates zt and decides the status
//                          (block 0 stages the columns, the quadruple,
//                          zt[2k-2 .. 2k+1], rNorm and the status); while
//                          the solve goes on, the rows write
//                          v_{k+1} = q / Haux and u_{k+1} = p / Faux into
//                          basis slot k (0 where the norm is at most
//                          eps^(3/4))
//   4. gp_commit   (1 blk) the staged values into the state, it += 1
// and after the loop gp_backsub (one thread) and gp_xy (grid).  No block
// reads a scalar that another block of the same launch writes: the state
// that launch 3 reads changes only in launch 4.  Per iteration this
// design moves (56 + 8 + 8 + 16k) + (16 + 16k) + 16 B per row in f32.
#include "common.cuh"

namespace {

using namespace ktt;

constexpr int kThreads = 256;
constexpr int kReduceThreads = 1024;
constexpr int kMaxMem = 64;

constexpr int RUNNING = 0;
constexpr int SOLVED = 1;
constexpr int ZERO_RESIDUAL = 2;
constexpr int BREAKDOWN = 7;
constexpr int TIRED = 100;

// The fixed slots of the scalar array; the host sets ATOL, RTOL, LAM and
// MU.  From H on the arrays follow, sized by mem (Layout below): h (mem),
// f (mem), zt (2 mem + 2), the quadruples' c (4 mem) and s (4 mem), R by
// columns ((2 mem + 2) x 2 mem), then the staging copy: rNorm, zt (4), the
// quadruple (8) and the two columns (2 (2 mem + 2)).
enum ScalarSlot { ATOL = 0, RTOL, LAM, MU, EPS_LIM, RNORM, H };
// IT, STATUS, GO, the staged status and the inconsistent flag
enum IntSlot { IT = 0, STATUS, GO, S_STATUS, INCON, NST };

struct Layout {
  int mem;
  __device__ int h() const { return H; }
  __device__ int f() const { return H + mem; }
  __device__ int zt() const { return H + 2 * mem; }
  __device__ int gc() const { return zt() + 2 * mem + 2; }
  __device__ int gs() const { return gc() + 4 * mem; }
  __device__ int r() const { return gs() + 4 * mem; }
  __device__ int col() const { return 2 * mem + 2; }   // R's column stride
  __device__ int s_rnorm() const { return r() + col() * 2 * mem; }
  __device__ int s_zt() const { return s_rnorm() + 1; }
  __device__ int s_quad() const { return s_zt() + 4; }
  __device__ int s_cols() const { return s_quad() + 8; }
  // work rows: V_0..V_mem, U_0..U_mem, q, p, x, y
  __device__ int v(int j) const { return j; }
  __device__ int u(int j) const { return mem + 1 + j; }
  __device__ int q() const { return 2 * mem + 2; }
  __device__ int p() const { return 2 * mem + 3; }
  __device__ int x() const { return 2 * mem + 4; }
  __device__ int y() const { return 2 * mem + 5; }
  // partial rows: h_j, f_j, ||q||^2, ||p||^2 (the init's b'b and c'c in
  // rows 0 and 1)
  __device__ int ph(int j) const { return j; }
  __device__ int pf(int j) const { return mem + j; }
  __device__ int pqq() const { return 2 * mem; }
  __device__ int ppp() const { return 2 * mem + 1; }
};

template <typename T>
__device__ __forceinline__ T* row(T* work, int r, long long n) {
  return work + static_cast<long long>(r) * n;
}

template <typename T>
__device__ __forceinline__ T btol_of() {
  return static_cast<T>(pow(static_cast<double>(eps_of<T>()), 0.75));
}

// The same sum of block partials in every block of a launch.
template <typename T>
__device__ __forceinline__ T all_sum(const T* partial, int nparts) {
  __shared__ T sum;
  const T s = sum_partials(partial, nparts);
  if (threadIdx.x == 0) sum = s;
  __syncthreads();
  return sum;
}

// Init: the partials of b'b (row 0) and c'c (row 1).
template <typename T>
__global__ void __launch_bounds__(kThreads)
gp_init_dots(const T* __restrict__ b, const T* __restrict__ c,
             T* __restrict__ partial, long long n) {
  T sbb = T(0);
  T scc = T(0);
  for (long long i = first_row(); i < n; i += row_stride()) {
    sbb += b[i] * b[i];
    scc += c[i] * c[i];
  }
  store_partials(sbb, partial, scc, partial + gridDim.x);
}

// Init: beta_0, gamma_0, rNorm_0, eps, zt = (beta_0, gamma_0, 0, ...), the
// stored quadruples 0 and the status (pallas_fused.py:8282-8304).
template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
gp_init_scalars(const T* __restrict__ partial, int nparts, T* sc, int* st,
                int mem) {
  const Layout L{mem};
  const T bb = sum_partials(partial, nparts);
  __syncthreads();
  const T cc = sum_partials(partial + nparts, nparts);
  if (threadIdx.x != 0) return;
  const T beta0 = sqrt(bb);
  const T gamma0 = sqrt(cc);
  for (int j = L.zt(); j < L.r(); ++j) sc[j] = T(0);
  sc[L.zt()] = beta0;
  sc[L.zt() + 1] = gamma0;
  const T rnorm = sqrt(beta0 * beta0 + gamma0 * gamma0);
  const T eps_lim = sc[ATOL] + sc[RTOL] * rnorm;
  sc[EPS_LIM] = eps_lim;
  sc[RNORM] = rnorm;
  for (int j = 0; j < NST; ++j) st[j] = 0;
  st[STATUS] = rnorm == T(0)      ? ZERO_RESIDUAL
               : rnorm <= eps_lim ? SOLVED
                                  : RUNNING;
}

// Init: V_0 = b / beta_0 and U_0 = c / gamma_0 (0 where the norm is 0).
template <typename T>
__global__ void __launch_bounds__(kThreads)
gp_init_vectors(const T* __restrict__ b, const T* __restrict__ c,
                T* __restrict__ work, const T* sc, long long n, int mem) {
  const Layout L{mem};
  const T beta0 = sc[L.zt()];
  const T gamma0 = sc[L.zt() + 1];
  T* v0 = row(work, L.v(0), n);
  T* u0 = row(work, L.u(0), n);
  for (long long i = first_row(); i < n; i += row_stride()) {
    v0[i] = beta0 != T(0) ? b[i] / beta0 : T(0);
    u0[i] = gamma0 != T(0) ? c[i] / gamma0 : T(0);
  }
}

// 1. GO; q = A u_k, p = B v_k; the partials of h_j and f_j, j < k.
template <typename T, typename P>
__global__ void __launch_bounds__(kThreads)
gp_stencil(const P* __restrict__ pd_a, const long long* __restrict__ offs_a,
           int nda, const P* __restrict__ pd_b,
           const long long* __restrict__ offs_b, int ndb,
           T* __restrict__ work, T* __restrict__ partial, int* st,
           long long n, int mem, int cap) {
  const Layout L{mem};
  const int it0 = st[IT];
  const bool go = st[STATUS] == RUNNING && it0 < cap;
  if (blockIdx.x == 0 && threadIdx.x == 0) st[GO] = go ? 1 : 0;
  if (!go) return;
  const int k = it0 + 1;
  const T* uk = row(work, L.u(it0), n);
  const T* vk = row(work, L.v(it0), n);
  T* q = row(work, L.q(), n);
  T* p = row(work, L.p(), n);
  for (long long i = first_row(); i < n; i += row_stride()) {
    q[i] = stencil_row(pd_a, offs_a, nda, uk, i, n);
    p[i] = stencil_row(pd_b, offs_b, ndb, vk, i, n);
  }
  const int nparts = gridDim.x;
  constexpr int K = 8;
  for (int j0 = 0; j0 < k; j0 += K) {
    const int cnt = k - j0 < K ? k - j0 : K;
    T sh[K];
    T sf[K];
#pragma unroll
    for (int j = 0; j < K; ++j) sh[j] = sf[j] = T(0);
    for (long long i = first_row(); i < n; i += row_stride()) {
      const T qi = q[i];
      const T pi = p[i];
#pragma unroll
      for (int j = 0; j < K; ++j) {
        if (j < cnt) {
          sh[j] += row(work, L.v(j0 + j), n)[i] * qi;
          sf[j] += row(work, L.u(j0 + j), n)[i] * pi;
        }
      }
    }
    block_sums<T, K>(sh, partial + static_cast<long long>(L.ph(j0)) * nparts,
                     nparts, cnt);
    block_sums<T, K>(sf, partial + static_cast<long long>(L.pf(j0)) * nparts,
                     nparts, cnt);
  }
}

// 2. h and f; q -= sum h_j V_j, p -= sum f_j U_j; the partials of ||q||^2
// and ||p||^2.
template <typename T>
__global__ void __launch_bounds__(kThreads)
gp_orth(T* __restrict__ work, T* __restrict__ partial, T* sc, const int* st,
        long long n, int mem) {
  if (!st[GO]) return;
  const Layout L{mem};
  const int k = st[IT] + 1;
  const int nparts = gridDim.x;
  __shared__ T h[kMaxMem];
  __shared__ T f[kMaxMem];
  sum_partial_rows(partial + static_cast<long long>(L.ph(0)) * nparts, nparts,
                   k, h);
  sum_partial_rows(partial + static_cast<long long>(L.pf(0)) * nparts, nparts,
                   k, f);
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    for (int j = 0; j < k; ++j) {
      sc[L.h() + j] = h[j];
      sc[L.f() + j] = f[j];
    }
  }
  T* q = row(work, L.q(), n);
  T* p = row(work, L.p(), n);
  T sqq = T(0);
  T spp = T(0);
  for (long long i = first_row(); i < n; i += row_stride()) {
    T qi = q[i];
    T pi = p[i];
    for (int j = 0; j < k; ++j) {
      qi = qi - h[j] * row(work, L.v(j), n)[i];
      pi = pi - f[j] * row(work, L.u(j), n)[i];
    }
    q[i] = qi;
    p[i] = pi;
    sqq += qi * qi;
    spp += pi * pi;
  }
  store_partials(sqq, partial + static_cast<long long>(L.pqq()) * nparts, spp,
                 partial + static_cast<long long>(L.ppp()) * nparts);
}

// Rows 2 i0 .. 2 i0 + 3 of a column through one stored quadruple
// (pallas_fused.py:8369-8392).
template <typename T>
__device__ void rotate_quad(T* col, int i0, const T* cs, const T* ss) {
  T r1 = col[2 * i0];
  T r2 = col[2 * i0 + 1];
  T r3 = col[2 * i0 + 2];
  T r4 = col[2 * i0 + 3];
  T t = cs[0] * r1 + ss[0] * r4;
  r4 = ss[0] * r1 - cs[0] * r4;
  r1 = t;
  t = cs[1] * r1 + ss[1] * r2;
  r2 = ss[1] * r1 - cs[1] * r2;
  r1 = t;
  t = cs[2] * r2 + ss[2] * r4;
  r4 = ss[2] * r2 - cs[2] * r4;
  r2 = t;
  t = cs[3] * r2 + ss[3] * r3;
  r3 = ss[3] * r2 - cs[3] * r3;
  r2 = t;
  col[2 * i0] = r1;
  col[2 * i0 + 1] = r2;
  col[2 * i0 + 2] = r3;
  col[2 * i0 + 3] = r4;
}

// The scalar step of iteration k in one thread (pallas_fused.py:
// 8337-8450): the columns in co and ce (shared memory); with store, the
// staging copy.  Returns whether the solve goes on.
template <typename T>
__device__ bool gp_step(const T* sc, int* st, const Layout& L, int k,
                        T haux, T faux, T* co, T* ce, T* stage, bool store) {
  const int nrow = L.col();
  for (int r = 0; r < nrow; ++r) co[r] = ce[r] = T(0);
  for (int j = 0; j < k; ++j) {
    co[2 * j + 1] = sc[L.f() + j];
    ce[2 * j] = sc[L.h() + j];
  }
  co[2 * k - 2] = co[2 * k - 2] + sc[LAM];
  ce[2 * k - 1] = ce[2 * k - 1] + sc[MU];
  for (int i0 = 0; i0 < k - 1; ++i0) {
    const T* cs = sc + L.gc() + 4 * i0;
    const T* ss = sc + L.gs() + 4 * i0;
    rotate_quad(co, i0, cs, ss);
    rotate_quad(ce, i0, cs, ss);
  }
  // the current reflections (pallas_fused.py:8396-8412)
  T c1, s1, c2, s2, c3, s3, c4, s4, d_o, de2;
  sym_givens(co[2 * k - 2], faux, c1, s1, d_o);
  const T theta = s1 * ce[2 * k - 2];
  T de1 = c1 * ce[2 * k - 2];
  sym_givens(d_o, co[2 * k - 1], c2, s2, d_o);
  T t = c2 * de1 + s2 * ce[2 * k - 1];
  de2 = s2 * de1 - c2 * ce[2 * k - 1];
  de1 = t;
  sym_givens(de2, theta, c3, s3, de2);
  sym_givens(de2, haux, c4, s4, de2);
  co[2 * k - 2] = d_o;
  co[2 * k - 1] = T(0);
  ce[2 * k - 2] = de1;
  ce[2 * k - 1] = de2;
  // t-bar (pallas_fused.py:8420-8433)
  T z1 = sc[L.zt() + 2 * k - 2];
  T z2 = sc[L.zt() + 2 * k - 1];
  T tbar_pp = s1 * z1;
  z1 = c1 * z1;
  t = c2 * z1 + s2 * z2;
  z2 = s2 * z1 - c2 * z2;
  z1 = t;
  t = c3 * z2 + s3 * tbar_pp;
  tbar_pp = s3 * z2 - c3 * tbar_pp;
  z2 = t;
  const T tbar_p = s4 * z2;
  z2 = c4 * z2;
  const T rnorm = sqrt(tbar_p * tbar_p + tbar_pp * tbar_pp);
  const T btol = btol_of<T>();
  const bool solved = rnorm <= sc[EPS_LIM] || rnorm + T(1) <= T(1);
  const bool breakdown = faux <= btol && haux <= btol;
  const int code = solved      ? SOLVED
                   : breakdown ? BREAKDOWN
                   : k >= L.mem ? TIRED
                                : RUNNING;
  const bool cont = code == RUNNING;
  if (store) {
    stage[0] = rnorm;
    stage[1] = z1;
    stage[2] = z2;
    stage[3] = cont ? tbar_p : sc[L.zt() + 2 * k];
    stage[4] = cont ? tbar_pp : sc[L.zt() + 2 * k + 1];
    T* quad = stage + 5;
    quad[0] = c1;
    quad[1] = c2;
    quad[2] = c3;
    quad[3] = c4;
    quad[4] = s1;
    quad[5] = s2;
    quad[6] = s3;
    quad[7] = s4;
    T* cols = stage + 13;
    for (int r = 0; r < 2 * k; ++r) {
      cols[r] = co[r];
      cols[nrow + r] = ce[r];
    }
    st[S_STATUS] = code;
  }
  return cont;
}

// 3. Haux, Faux; the scalar step in thread 0 of every block (block 0
// stages it); v_{k+1} and u_{k+1} into basis slot k while the solve goes
// on.
template <typename T>
__global__ void __launch_bounds__(kThreads)
gp_update(T* __restrict__ work, const T* __restrict__ partial, T* sc,
          int* st, long long n, int mem) {
  if (!st[GO]) return;
  const Layout L{mem};
  const int nparts = gridDim.x;
  const T haux = sqrt(all_sum(partial + static_cast<long long>(L.pqq())
                              * nparts, nparts));
  const T faux = sqrt(all_sum(partial + static_cast<long long>(L.ppp())
                              * nparts, nparts));
  const int k = st[IT] + 1;
  __shared__ T cols[2 * (2 * kMaxMem + 2)];
  __shared__ int cont;
  if (threadIdx.x == 0) {
    cont = gp_step(sc, st, L, k, haux, faux, cols, cols + L.col(),
                   sc + L.s_rnorm(), blockIdx.x == 0)
               ? 1
               : 0;
  }
  __syncthreads();
  if (!cont) return;
  const T btol = btol_of<T>();
  const T* q = row(work, L.q(), n);
  const T* p = row(work, L.p(), n);
  T* vn = row(work, L.v(k), n);
  T* un = row(work, L.u(k), n);
  for (long long i = first_row(); i < n; i += row_stride()) {
    vn[i] = haux > btol ? q[i] / haux : T(0);
    un[i] = faux > btol ? p[i] / faux : T(0);
  }
}

// 4. The staged values into the state, and the iteration count.
template <typename T>
__global__ void __launch_bounds__(128)
gp_commit(T* sc, int* st, int mem) {
  if (!st[GO]) return;
  const Layout L{mem};
  const int it0 = st[IT];
  const int k = it0 + 1;
  const int nrow = L.col();
  const T* cols = sc + L.s_cols();
  T* r_o = sc + L.r() + static_cast<long long>(2 * k - 2) * nrow;
  T* r_e = sc + L.r() + static_cast<long long>(2 * k - 1) * nrow;
  for (int r = threadIdx.x; r < 2 * k; r += blockDim.x) {
    r_o[r] = cols[r];
    r_e[r] = cols[nrow + r];
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  const T* stage = sc + L.s_rnorm();
  sc[RNORM] = stage[0];
  for (int j = 0; j < 4; ++j) sc[L.zt() + 2 * k - 2 + j] = stage[1 + j];
  for (int j = 0; j < 4; ++j) {
    sc[L.gc() + 4 * k - 4 + j] = stage[5 + j];
    sc[L.gs() + 4 * k - 4 + j] = stage[9 + j];
  }
  st[STATUS] = st[S_STATUS];
  st[IT] = it0 + 1;
}

// After the loop: the back substitution on the 2 niter x 2 niter triangle
// (pallas_fused.py:8455-8476), in one thread.
template <typename T>
__global__ void __launch_bounds__(32)
gp_backsub(T* sc, int* st, int mem) {
  if (threadIdx.x != 0) return;
  const Layout L{mem};
  const int k2 = 2 * st[IT];
  const int nrow = L.col();
  T* zt = sc + L.zt();
  const T* R = sc + L.r();
  const T btol = btol_of<T>();
  int incon = 0;
  for (int i = k2 - 1; i >= 0; --i) {
    T acc = zt[i];
    for (int j = i + 1; j < k2; ++j) {
      acc = acc - R[static_cast<long long>(j) * nrow + i] * zt[j];
    }
    const T diag = R[static_cast<long long>(i) * nrow + i];
    const bool sing = fabs(diag) <= btol;
    zt[i] = sing ? T(0) : acc / diag;
    if (sing) incon = 1;
  }
  st[INCON] = incon;
}

// After the loop: x = sum zt_{2i} V_i and y = sum zt_{2i+1} U_i, i in
// order (pallas_fused.py:8478-8485).
template <typename T>
__global__ void __launch_bounds__(kThreads)
gp_xy(T* __restrict__ work, const T* sc, const int* st, long long n,
      int mem) {
  const Layout L{mem};
  const int niter = st[IT];
  const T* zt = sc + L.zt();
  T* x = row(work, L.x(), n);
  T* y = row(work, L.y(), n);
  for (long long i = first_row(); i < n; i += row_stride()) {
    T xi = T(0);
    T yi = T(0);
    for (int j = 0; j < niter; ++j) {
      xi = xi + zt[2 * j] * row(work, L.v(j), n)[i];
      yi = yi + zt[2 * j + 1] * row(work, L.u(j), n)[i];
    }
    x[i] = xi;
    y[i] = yi;
  }
}

template <typename T>
int init(const void* b_, const void* c_, void* work_, void* partial_,
         void* sc_, void* st_, long long n, int grid, int mem, void* stream) {
  if (mem < 2 || mem > kMaxMem) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* b = static_cast<const T*>(b_);
  const T* c = static_cast<const T*>(c_);
  T* partial = static_cast<T*>(partial_);
  T* sc = static_cast<T*>(sc_);
  gp_init_dots<T><<<grid, kThreads, 0, s>>>(b, c, partial, n);
  gp_init_scalars<T><<<1, kReduceThreads, 0, s>>>(
      partial, grid, sc, static_cast<int*>(st_), mem);
  gp_init_vectors<T><<<grid, kThreads, 0, s>>>(b, c, static_cast<T*>(work_),
                                               sc, n, mem);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename P>
int iterate(const void* pd_a, const void* offs_a, int nda, const void* pd_b,
            const void* offs_b, int ndb, void* work_, void* partial_,
            void* sc_, void* st_, long long n, int grid, int mem, int iters,
            int cap, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  T* work = static_cast<T*>(work_);
  T* partial = static_cast<T*>(partial_);
  T* sc = static_cast<T*>(sc_);
  int* st = static_cast<int*>(st_);
  for (int j = 0; j < iters; ++j) {
    gp_stencil<T, P><<<grid, kThreads, 0, s>>>(
        static_cast<const P*>(pd_a), static_cast<const long long*>(offs_a),
        nda, static_cast<const P*>(pd_b),
        static_cast<const long long*>(offs_b), ndb, work, partial, st, n,
        mem, cap);
    gp_orth<T><<<grid, kThreads, 0, s>>>(work, partial, sc, st, n, mem);
    gp_update<T><<<grid, kThreads, 0, s>>>(work, partial, sc, st, n, mem);
    gp_commit<T><<<1, 128, 0, s>>>(sc, st, mem);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int finish(void* work, void* sc, void* st, long long n, int grid, int mem,
           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  gp_backsub<T><<<1, 32, 0, s>>>(static_cast<T*>(sc), static_cast<int*>(st),
                                 mem);
  gp_xy<T><<<grid, kThreads, 0, s>>>(static_cast<T*>(work),
                                     static_cast<const T*>(sc),
                                     static_cast<const int*>(st), n, mem);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define KTT_GP_INIT(NAME, T)                                                  \
  extern "C" int NAME(const void* b, const void* c, void* work,              \
                      void* partial, void* sc, void* st, long long n,        \
                      int grid, int mem, void* stream) {                     \
    return init<T>(b, c, work, partial, sc, st, n, grid, mem, stream);       \
  }
#define KTT_GP_ITERATE(NAME, T, P)                                            \
  extern "C" int NAME(const void* pd_a, const void* offs_a, int nda,         \
                      const void* pd_b, const void* offs_b, int ndb,         \
                      void* work, void* partial, void* sc, void* st,         \
                      long long n, int grid, int mem, int iters, int cap,    \
                      void* stream) {                                        \
    return iterate<T, P>(pd_a, offs_a, nda, pd_b, offs_b, ndb, work,         \
                         partial, sc, st, n, grid, mem, iters, cap, stream); \
  }
#define KTT_GP_FINISH(NAME, T)                                                \
  extern "C" int NAME(void* work, void* sc, void* st, long long n, int grid, \
                      int mem, void* stream) {                               \
    return finish<T>(work, sc, st, n, grid, mem, stream);                    \
  }

KTT_GP_INIT(ktt_gpmr_dia_init_f32, float)
KTT_GP_INIT(ktt_gpmr_dia_init_f64, double)
KTT_GP_ITERATE(ktt_gpmr_dia_iterate_f32_f32, float, float)
KTT_GP_ITERATE(ktt_gpmr_dia_iterate_f32_bf16, float, __nv_bfloat16)
KTT_GP_ITERATE(ktt_gpmr_dia_iterate_f32_f16, float, __half)
KTT_GP_ITERATE(ktt_gpmr_dia_iterate_f64_f64, double, double)
KTT_GP_FINISH(ktt_gpmr_dia_finish_f32, float)
KTT_GP_FINISH(ktt_gpmr_dia_finish_f64, double)
