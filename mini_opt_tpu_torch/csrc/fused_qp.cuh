// The whole fixed-trip QP interior point of B independent small dense QPs,
// one instance per thread: kernel 6's register route, instantiated by
// fused_qp.cu (any box rows, the C launcher), fused_qp_pairs.cu (the
// general path's rows) and fused_qp_k2.cu (two equality rows). Larger QPs
// take the warp route, fused_qp_warp.cu.
//
// Replaces the TPU kernel mini_opt_tpu/ops/pallas_qp.py::_make_qp_kernel
// (launched at pallas_qp.py:262 by _fused_qp_batch). Per instance:
//   min 0.5 x^T G x + c^T x  s.t.  A x + b = 0 (K rows),
//                                  ia[m] x[var[m]] + ib[m] >= 0 (M rows),
// by the equality-constrained initial guess, then `iterations` steps of the
// condensed (N+K)^2 KKT interior point (qp.cc:228-364 structure) with the
// complementarity or the Mehrotra predictor-corrector mu schedule and
// fraction-to-boundary tau = 0.995.
//
// What bounds it on this card: one instance's serial chain. An instance
// reads about N (N + 1) / 2 + N + K (N + 1) + 2M scalars and writes N + K,
// but runs some hundreds of dependent floating-point operations per
// iteration (IEEE divisions among them), so even at B = 8192 the card holds
// about one warp per scheduler and the time is the chain's latency.
//
// What the design does about it: one instance per thread with N and K
// compile-time sizes (N = 1..8 with K <= 1, N = 1..6 with K = 2: the caps
// below), every loop over variables
// unrolled, so the KKT matrix, its LDL^T factor (fused_sqp.cuh's unrolled
// ldlt_factor / ldlt_apply) and every iterate live in registers. The box
// rows are a type: PairRows, the rows every caller in the port passes (a lo
// and a hi row on each of variables 1..N-1, the IK joint limits), has its
// count and variables at compile time, so each x[var[m]] is a register and
// no dead row is carried; AnyRows takes any M <= 2N rows as run-time values,
// unrolled over the 2N possible rows with per-variable selects. Each
// (r_c + corr - mu) / s of a solve step is computed once. The inputs are
// read batch-major straight from the caller's tensors, any strides (the
// general path's ia is a stride-0 broadcast), and x (B, N), y (B, K) are
// written batch-major: a call is one device kernel. The ragged edge is
// masked.
//
// Semantics mirror the JAX kernel: jnp.maximum / minimum propagate NaN
// (nmax / nmin), sums keep its order, (mu_aff / mu) ** 3 is r * (r * r).
// Built without FMA contraction, the kernel reproduces
// ops/fused_qp.py::_fused_qp_plain bit for bit.
#pragma once

#include <cuda_runtime.h>

#include "fused_sqp.cuh"

#if !defined(MO_QP_REGISTER_MAX_N_K0) || !defined(MO_QP_REGISTER_MAX_N_K1) || !defined(MO_QP_REGISTER_MAX_N_K2)
#error "build with -DMO_QP_REGISTER_MAX_N_K0, _K1 and _K2 (ops/_build.py passes ops/fused_qp.py's caps)"
#endif

namespace mo {
namespace qp {

constexpr int kBlock = 32;  // at B = 8192: 1-2.5% faster than 128 at N = 2, 5% at N = 8
// The register route's largest N for K = 0, 1 and 2 equality rows, the
// sizes whose float instances ptxas keeps free of spills on the general
// path's rows. The caps' one home is ops/fused_qp.py (REGISTER_MAX_N),
// which ops/_build.py passes to nvcc; past them the warp route
// (fused_qp_warp.cu) takes the QP.
__host__ __device__ constexpr int register_max_n(int K) {
  return K == 0 ? MO_QP_REGISTER_MAX_N_K0
                : (K == 1 ? MO_QP_REGISTER_MAX_N_K1 : (K == 2 ? MO_QP_REGISTER_MAX_N_K2 : 0));
}
constexpr int kRegisterTopN = register_max_n(0) > register_max_n(1)
                                  ? (register_max_n(0) > register_max_n(2) ? register_max_n(0) : register_max_n(2))
                                  : (register_max_n(1) > register_max_n(2) ? register_max_n(1) : register_max_n(2));
constexpr int kMaxRows = 2 * kRegisterTopN;  // 2N for the largest instance

// The schedule, uniform over the grid.
struct Schedule {
  int iterations;
  double sigma;
  int mpc;
  int has_eq_guess;
};

// The caller's tensors and their strides in elements: G (B, N, N) (lower
// triangle read), c (B, N), A (B, K, N), b (B, K), ia / ib (B, M); the
// outputs x (B, N) and y (B, K) are contiguous.
struct Tensors {
  const void *G, *c, *A, *b, *ia, *ib;
  void *x, *y;
  long long sG[3], sc[2], sA[3], sb[2], sia[2], sib[2];
};

// v[idx] for a run-time idx without indexing a register array.
template <typename T, int L>
__device__ __forceinline__ T pick(const T (&v)[L], int idx) {
  T r = v[0];
#pragma unroll
  for (int i = 1; i < L; ++i) r = (idx == i) ? v[i] : r;
  return r;
}

template <typename T, int L>
__device__ __forceinline__ void put(T (&v)[L], int idx, T val) {
#pragma unroll
  for (int i = 0; i < L; ++i) {
    if (idx == i) v[i] = val;
  }
}

// The general path's box rows: row 2(i - 1) is the lo row and row
// 2(i - 1) + 1 the hi row of variable i, i = 1..N-1 (nonlinear.py's
// _ineq_var of the IK problem), all at compile time.
__host__ __device__ constexpr int pair_var(int m) { return 1 + m / 2; }

template <int N>
struct PairRows {
  static constexpr int R = 2 * (N - 1);
  __host__ __device__ static constexpr int var(int m) { return pair_var(m); }
  __device__ __forceinline__ int count() const { return R; }
  __device__ __forceinline__ bool live(int) const { return true; }
  template <typename T, int L>
  __device__ __forceinline__ T get(const T (&v)[L], int m) const { return v[var(m)]; }
  template <typename T, int L>
  __device__ __forceinline__ void set(T (&v)[L], int m, T val) const { v[var(m)] = val; }
  template <typename T, int D>
  __device__ __forceinline__ void add_diag(T (&H)[D][D], int m, T val) const {
    H[var(m)][var(m)] = H[var(m)][var(m)] + val;
  }
};

// Whether M box rows on the variables var are PairRows of N variables: the
// launcher (fused_qp.cu) takes the compile-time route exactly there.
inline bool is_pair_rows(int N, int M, const int* var) {
  if (M != 2 * (N - 1)) return false;
  for (int m = 0; m < M; ++m) {
    if (var[m] != pair_var(m)) return false;
  }
  return true;
}

// Any box rows: their count M <= 2N and variables are run-time values,
// uniform over the grid; rows m >= M are dead slots (a = b = s = z = 1).
template <int N>
struct AnyRows {
  static constexpr int R = 2 * N;
  int M;
  int var[kMaxRows];
  __device__ __forceinline__ int count() const { return M; }
  __device__ __forceinline__ bool live(int m) const { return m < M; }
  template <typename T, int L>
  __device__ __forceinline__ T get(const T (&v)[L], int m) const { return pick(v, var[m]); }
  template <typename T, int L>
  __device__ __forceinline__ void set(T (&v)[L], int m, T val) const { put(v, var[m], val); }
  template <typename T, int D>
  __device__ __forceinline__ void add_diag(T (&H)[D][D], int m, T val) const {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if (var[m] == i) H[i][i] = H[i][i] + val;
    }
  }
};

// Kernel 6's phases (scripts/fused_kernel_times.py --spans): the loads, the
// initial guess, then per iteration the residuals, the assembly and factor,
// the Mehrotra probe's solve and its mu_aff, the step's solve, the
// fraction to the boundary and the update; the stores.
// Each translation unit has its own sums; fused_qp_pairs.cu reads its own,
// the general path's route.
enum QpSpan {
  kQpLoads, kQpGuess, kQpResiduals, kQpFactor, kQpSolveAffine, kQpMuAffine, kQpSolve, kQpFtb,
  kQpUpdate, kQpStore, kQpSpans
};
#ifdef MO_FUSED_SPANS
static __device__ unsigned long long mo_qp_spans[kQpSpans];
#endif

template <typename T, int N, int K, class Rows>
__global__ void __launch_bounds__(kBlock)
    fused_qp_kernel(const Tensors t, int B, const Rows rows, const Schedule sch) {
  constexpr int D = N + K;
  constexpr int KA = K > 0 ? K : 1;  // C++ has no zero-length arrays
  constexpr int R = Rows::R;
  constexpr int RA = slots(R);  // PairRows<1> has no row
  const int lane = blockIdx.x * kBlock + threadIdx.x;
  if (lane >= B) return;
  const long long l = lane;
  SpanClock<kQpSpans> sc(lane == 0);

  const T* __restrict__ Gp = static_cast<const T*>(t.G) + l * t.sG[0];
  const T* __restrict__ cp = static_cast<const T*>(t.c) + l * t.sc[0];
  const T* __restrict__ Ap = static_cast<const T*>(t.A) + l * t.sA[0];
  const T* __restrict__ bp = static_cast<const T*>(t.b) + l * t.sb[0];
  const T* __restrict__ iap = static_cast<const T*>(t.ia) + l * t.sia[0];
  const T* __restrict__ ibp = static_cast<const T*>(t.ib) + l * t.sib[0];
  T G[N][N], c[N], A[KA][N], bq[KA], ia[RA], ib[RA];
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) G[i][j] = Gp[i * t.sG[1] + j * t.sG[2]];
    c[i] = cp[i * t.sc[1]];
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int j = 0; j < N; ++j) A[k][j] = Ap[k * t.sA[1] + j * t.sA[2]];
    bq[k] = bp[k * t.sb[1]];
  }
#pragma unroll
  for (int m = 0; m < R; ++m) {
    ia[m] = rows.live(m) ? iap[m * t.sia[1]] : T(1);
    ib[m] = rows.live(m) ? ibp[m * t.sib[1]] : T(1);
  }
  const int M = rows.count();
  const T zero = T(0), one = T(1);
  sc.mark(kQpLoads);

  T H[D][D], L[D][D], dg[D], sol[D];
  // Condensed lower triangle: G's, sig[m] added on the diagonal of var[m]
  // in row order, the equality rows below, a zero (K, K) block.
  auto assemble = [&](const T (&sig)[RA]) {
#pragma unroll
    for (int i = 0; i < D; ++i) {
#pragma unroll
      for (int j = 0; j < D; ++j) H[i][j] = zero;
    }
#pragma unroll
    for (int i = 0; i < N; ++i) {
#pragma unroll
      for (int j = 0; j <= i; ++j) H[i][j] = G[i][j];
    }
#pragma unroll
    for (int m = 0; m < R; ++m) {
      if (rows.live(m)) rows.add_diag(H, m, sig[m]);
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
#pragma unroll
      for (int j = 0; j < N; ++j) H[N + k][j] = A[k][j];
    }
  };

  // Initial guess (qp.cc:439-482).
  T x[N], y[KA];
  if (sch.has_eq_guess) {
    T sig0[RA];
#pragma unroll
    for (int m = 0; m < R; ++m) sig0[m] = zero;
    assemble(sig0);
#pragma unroll
    for (int i = 0; i < N; ++i) sol[i] = -c[i];
#pragma unroll
    for (int k = 0; k < K; ++k) sol[N + k] = -bq[k];
    ldlt_factor<T, D>(H, L, dg);
    ldlt_apply<T, D>(L, dg, sol);
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = sol[i];
#pragma unroll
    for (int k = 0; k < K; ++k) y[k] = -sol[N + k];
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = zero;
#pragma unroll
    for (int k = 0; k < K; ++k) y[k] = zero;
  }
  // Clamp into the feasible half-lines in row order, then
  // s = max(1e-9, a x + b), z = 1 / s.
  T s[RA], z[RA];
#pragma unroll
  for (int m = 0; m < R; ++m) {
    if (rows.live(m)) {
      const T xv = rows.get(x, m);
      const T tv = ia[m] * xv + ib[m];
      rows.set(x, m, xv + (tv < zero ? -tv / ia[m] : zero));
    }
  }
#pragma unroll
  for (int m = 0; m < R; ++m) {
    s[m] = rows.live(m) ? nmax(T(1e-9), ia[m] * rows.get(x, m) + ib[m]) : one;
    z[m] = one / s[m];
  }
  sc.mark(kQpGuess);

  // ftb(vs, dvs, tau) over the live rows.
  auto ftb = [&](const T (&vs)[RA], const T (&dvs)[RA], T tau_v) {
    T alpha = one;
#pragma unroll
    for (int m = 0; m < R; ++m) {
      if (rows.live(m)) {
        const bool blocking = (vs[m] + dvs[m] <= zero) && (fabs(dvs[m]) > zero);
        const T cand = -tau_v * vs[m] / (blocking ? dvs[m] : one);
        alpha = nmin(alpha, blocking ? cand : one);
      }
    }
    return alpha;
  };

  T mu = one;
  const T tau = T(0.995);
  const T sigma = static_cast<T>(sch.sigma);
#pragma unroll 1
  for (int it = 0; it < sch.iterations; ++it) {
    // KKT residuals (qp.cc:391-420).
    T r_d[N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      T acc = c[i];
#pragma unroll
      for (int j = 0; j < N; ++j) acc = acc + (i >= j ? G[i][j] : G[j][i]) * x[j];
#pragma unroll
      for (int k = 0; k < K; ++k) acc = acc - A[k][i] * y[k];
      r_d[i] = acc;
    }
#pragma unroll
    for (int m = 0; m < R; ++m) {
      if (rows.live(m)) rows.set(r_d, m, rows.get(r_d, m) - ia[m] * z[m]);
    }
    T r_pe[KA];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      T acc = bq[k];
#pragma unroll
      for (int j = 0; j < N; ++j) acc = acc + A[k][j] * x[j];
      r_pe[k] = acc;
    }
    T r_pi[RA], r_c[RA], zs[RA], sig[RA];
#pragma unroll
    for (int m = 0; m < R; ++m) {
      r_pi[m] = ia[m] * rows.get(x, m) + ib[m] - s[m];
      r_c[m] = s[m] * z[m];
      zs[m] = z[m] / s[m];
      sig[m] = ia[m] * ia[m] * zs[m];
    }
    sc.mark(kQpResiduals);
    assemble(sig);
    ldlt_factor<T, D>(H, L, dg);
    sc.mark(kQpFactor);

    // Elimination, condensed solve, back-substitution (qp.cc:318-364); the
    // quotient (r_c + corr - mu) / s enters both the right-hand side and
    // dz, and is computed once.
    auto solve_step = [&](T mu_v, const T (&corr)[RA], T (&dx)[N], T (&dy)[KA], T (&ds)[RA],
                          T (&dz)[RA]) {
      T q[RA];
#pragma unroll
      for (int m = 0; m < R; ++m) q[m] = (r_c[m] + corr[m] - mu_v) / s[m];
#pragma unroll
      for (int i = 0; i < N; ++i) sol[i] = r_d[i];
#pragma unroll
      for (int m = 0; m < R; ++m) {
        if (rows.live(m)) rows.set(sol, m, rows.get(sol, m) + ia[m] * (zs[m] * r_pi[m] + q[m]));
      }
#pragma unroll
      for (int i = 0; i < N; ++i) sol[i] = -sol[i];
#pragma unroll
      for (int k = 0; k < K; ++k) sol[N + k] = -r_pe[k];
      ldlt_apply<T, D>(L, dg, sol);
#pragma unroll
      for (int i = 0; i < N; ++i) dx[i] = sol[i];
#pragma unroll
      for (int k = 0; k < K; ++k) dy[k] = -sol[N + k];
#pragma unroll
      for (int m = 0; m < R; ++m) {
        ds[m] = ia[m] * rows.get(dx, m) + r_pi[m];
        dz[m] = -zs[m] * ds[m] - q[m];
      }
    };

    T dx[N], dy[KA], ds[RA], dz[RA], zeros_c[RA];
#pragma unroll
    for (int m = 0; m < R; ++m) zeros_c[m] = zero;
    if (M == 0) {
      solve_step(zero, zeros_c, dx, dy, ds, dz);
    } else if (sch.mpc) {
      T dxa[N], dya[KA], dsa[RA], dza[RA], corr[RA];
      solve_step(zero, zeros_c, dxa, dya, dsa, dza);
      sc.mark(kQpSolveAffine);
      const T ap_a = ftb(s, dsa, one);
      const T ad_a = ftb(z, dza, one);
      T mu_aff = zero;
#pragma unroll
      for (int m = 0; m < R; ++m) {
        if (rows.live(m)) mu_aff = mu_aff + (s[m] + ap_a * dsa[m]) * (z[m] + ad_a * dza[m]);
      }
      mu_aff = nmax(mu_aff / T(M), zero);
      const T ratio = mu_aff / mu;
      const T mu_used = ratio * (ratio * ratio) * mu;
#pragma unroll
      for (int m = 0; m < R; ++m) corr[m] = dsa[m] * dza[m];
      sc.mark(kQpMuAffine);
      solve_step(mu_used, corr, dx, dy, ds, dz);
    } else {
      solve_step(mu, zeros_c, dx, dy, ds, dz);
    }
    sc.mark(kQpSolve);

    T ap = one, ad = one;
    if (M > 0) {
      ap = ftb(s, ds, tau);
      ad = ftb(z, dz, tau);
    }
    sc.mark(kQpFtb);
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = x[i] + ap * dx[i];
#pragma unroll
    for (int m = 0; m < R; ++m) s[m] = s[m] + ap * ds[m];
#pragma unroll
    for (int k = 0; k < K; ++k) y[k] = y[k] + ad * dy[k];
#pragma unroll
    for (int m = 0; m < R; ++m) z[m] = z[m] + ad * dz[m];
    if (M > 0) {
      T comp = zero;
#pragma unroll
      for (int m = 0; m < R; ++m) {
        if (rows.live(m)) comp = comp + s[m] * z[m];
      }
      mu = sigma * (comp / T(M));
    }
    sc.mark(kQpUpdate);
  }

  T* __restrict__ xo = static_cast<T*>(t.x) + l * N;
#pragma unroll
  for (int i = 0; i < N; ++i) xo[i] = x[i];
  T* __restrict__ yo = static_cast<T*>(t.y) + l * K;
#pragma unroll
  for (int k = 0; k < K; ++k) yo[k] = y[k];
  sc.mark(kQpStore);
#ifdef MO_FUSED_SPANS
  sc.flush(mo_qp_spans);
#endif
}

template <typename T, int N, int K, class Rows>
int launch(const Tensors& t, int B, const Rows& rows, const Schedule& sch, cudaStream_t stream) {
  fused_qp_kernel<T, N, K, Rows><<<(B + kBlock - 1) / kBlock, kBlock, 0, stream>>>(t, B, rows, sch);
  return static_cast<int>(cudaGetLastError());
}

// Whether the register route has an instance of N variables and K
// equality rows.
__host__ __device__ constexpr bool register_instance(int N, int K) {
  return N >= 1 && N <= register_max_n(K);
}

// The register-route instance <T, n, K> on the rows make(Rows<n>{}), for a
// run-time n; kNoInstance where the caps have none.
template <typename T, int K, template <int> class Rows, int N = 1, class Make>
int dispatch_register(int n, const Tensors& t, int B, const Make& make, const Schedule& sch,
                      cudaStream_t s) {
  if constexpr (N > kRegisterTopN) {
    return kNoInstance;
  } else {
    if (n == N) {
      if constexpr (register_instance(N, K)) {
        return launch<T, N, K>(t, B, make(Rows<N>{}), sch, s);
      } else {
        return kNoInstance;
      }
    }
    return dispatch_register<T, K, Rows, N + 1>(n, t, B, make, sch, s);
  }
}

// The PairRows instances with K in {0, 1} (fused_qp_pairs.cu) and every
// instance with K = 2 (fused_qp_k2.cu, AnyRows where `pairs` is false,
// the M box rows' variables in var).
int launch_pairs(int dtype, int N, int K, const Tensors& t, int B, const Schedule& sch,
                 cudaStream_t stream);
int launch_k2(int dtype, int N, bool pairs, int M, const int* var, const Tensors& t, int B,
              const Schedule& sch, cudaStream_t stream);

// AnyRows of N variables holding the M rows' variables var.
struct FillAny {
  int M;
  const int* var;
  template <class Rows>
  Rows operator()(Rows rows) const {
    rows.M = M;
    for (int m = 0; m < M; ++m) rows.var[m] = var[m];
    return rows;
  }
};
struct Same {
  template <class Rows>
  Rows operator()(Rows rows) const { return rows; }
};

}  // namespace qp
}  // namespace mo
