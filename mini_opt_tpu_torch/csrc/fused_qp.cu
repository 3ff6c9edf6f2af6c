// The whole fixed-trip QP interior point of B independent small dense QPs,
// one instance per thread, behind a plain C launcher that ops/fused_qp.py
// binds with ctypes.
//
// Replaces the TPU kernel mini_opt_tpu/ops/pallas_qp.py::_make_qp_kernel
// (launched at pallas_qp.py:262 by _fused_qp_batch). Per instance:
//   min 0.5 x^T G x + c^T x  s.t.  A x + b = 0 (K rows),
//                                  ia[m] x[var[m]] + ib[m] >= 0 (M rows),
// by the equality-constrained initial guess, then `iterations` steps of the
// condensed (N+K)^2 KKT interior point (qp.cc:228-364 structure) with the
// complementarity or the Mehrotra predictor-corrector mu schedule and
// fraction-to-boundary tau = 0.995. Writes x (N, B) and y (K, B).
//
// What bounds it on this card: arithmetic. An instance reads about
// N (N + 1) / 2 + N + K (N + 1) + 2M scalars and writes N + K, but runs some
// hundreds of floating-point operations per iteration (counted by
// chip_smoke.py from the plain version), so the memory system idles next
// to the FP32/FP64 pipes.
//
// What the design does about it: one instance per thread with N and K
// compile-time sizes (N = 2..8, K in {0, 1}), so every loop over variables
// unrolls and the KKT matrix, its LDL^T factor (fused_sqp.cuh's unrolled
// ldlt_factor / ldlt_apply, the helpers the Pallas kernel imports from
// pallas_ik) and every iterate live in registers. The box rows are run-time
// values (their count M <= 2N and variable indices come in the launch
// arguments, uniform across the grid), handled by unrolled loops over the
// 2N possible rows with per-variable selects, so no register array is ever
// indexed at run time. Loads are feature-major (vars, B): thread i reads
// column i and a warp's loads are coalesced. The ragged edge is masked.
//
// Semantics mirror the JAX kernel: jnp.maximum / minimum propagate NaN
// (nmax / nmin), sums keep its order, (mu_aff / mu) ** 3 is r * (r * r).
// Built without FMA contraction, the kernel reproduces
// ops/fused_qp.py::_fused_qp_plain bit for bit.
#include <cuda_runtime.h>

#include "fused_sqp.cuh"

namespace {

constexpr int kBlock = 128;
constexpr int kMaxRows = 16;  // 2N for the largest instance, N = 8

struct QPArgs {
  int M;
  int var[kMaxRows];
  int iterations;
  double sigma;
  int mpc;
  int has_eq_guess;
};

// v[idx] for a run-time idx without indexing a register array.
template <typename T, int N>
__device__ __forceinline__ T pick(const T (&v)[N], int idx) {
  T r = v[0];
#pragma unroll
  for (int i = 1; i < N; ++i) r = (idx == i) ? v[i] : r;
  return r;
}

template <typename T, int N>
__device__ __forceinline__ void put(T (&v)[N], int idx, T val) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (idx == i) v[i] = val;
  }
}

template <typename T, int N, int K>
__global__ void __launch_bounds__(kBlock)
    fused_qp_kernel(const T* __restrict__ Gp, const T* __restrict__ cp, const T* __restrict__ Ap,
                    const T* __restrict__ bp, const T* __restrict__ iap,
                    const T* __restrict__ ibp, T* __restrict__ x_out, T* __restrict__ y_out, int B,
                    QPArgs a) {
  constexpr int D = N + K;
  constexpr int KA = K > 0 ? K : 1;  // C++ has no zero-length arrays
  constexpr int R = 2 * N;           // the most box rows an instance takes
  const int lane = blockIdx.x * kBlock + threadIdx.x;
  if (lane >= B) return;
  const size_t b = static_cast<size_t>(B);
  const int M = a.M;

  T G[N][N], c[N], A[KA][N], bq[KA], ia[R], ib[R];
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) G[i][j] = Gp[(i * N + j) * b + lane];
    c[i] = cp[i * b + lane];
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int j = 0; j < N; ++j) A[k][j] = Ap[(k * N + j) * b + lane];
    bq[k] = bp[k * b + lane];
  }
#pragma unroll
  for (int m = 0; m < R; ++m) {
    ia[m] = m < M ? iap[m * b + lane] : T(1);
    ib[m] = m < M ? ibp[m * b + lane] : T(1);
  }
  const T zero = T(0), one = T(1);

  T H[D][D], L[D][D], dg[D], sol[D];
  // Condensed lower triangle: G's, sig[m] added on the diagonal of var[m]
  // in row order, the equality rows below, a zero (K, K) block.
  auto assemble = [&](const T (&sig)[R]) {
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
      if (m < M) {
#pragma unroll
        for (int i = 0; i < N; ++i) {
          if (a.var[m] == i) H[i][i] = H[i][i] + sig[m];
        }
      }
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
#pragma unroll
      for (int j = 0; j < N; ++j) H[N + k][j] = A[k][j];
    }
  };

  // Initial guess (qp.cc:439-482).
  T x[N], y[KA];
  if (a.has_eq_guess) {
    T sig0[R];
#pragma unroll
    for (int m = 0; m < R; ++m) sig0[m] = zero;
    assemble(sig0);
#pragma unroll
    for (int i = 0; i < N; ++i) sol[i] = -c[i];
#pragma unroll
    for (int k = 0; k < K; ++k) sol[N + k] = -bq[k];
    mo::ldlt_factor<T, D>(H, L, dg);
    mo::ldlt_apply<T, D>(L, dg, sol);
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
  T s[R], z[R];
#pragma unroll
  for (int m = 0; m < R; ++m) {
    if (m < M) {
      const T xv = pick(x, a.var[m]);
      const T t = ia[m] * xv + ib[m];
      put(x, a.var[m], xv + (t < zero ? -t / ia[m] : zero));
    }
  }
#pragma unroll
  for (int m = 0; m < R; ++m) {
    s[m] = m < M ? mo::nmax(T(1e-9), ia[m] * pick(x, a.var[m]) + ib[m]) : one;
    z[m] = one / s[m];
  }

  // ftb(vs, dvs, tau) over the live rows.
  auto ftb = [&](const T (&vs)[R], const T (&dvs)[R], T tau_v) {
    T alpha = one;
#pragma unroll
    for (int m = 0; m < R; ++m) {
      if (m < M) {
        const bool blocking = (vs[m] + dvs[m] <= zero) && (fabs(dvs[m]) > zero);
        const T cand = -tau_v * vs[m] / (blocking ? dvs[m] : one);
        alpha = mo::nmin(alpha, blocking ? cand : one);
      }
    }
    return alpha;
  };

  T mu = one;
  const T tau = T(0.995);
  const T sigma = static_cast<T>(a.sigma);
#pragma unroll 1
  for (int it = 0; it < a.iterations; ++it) {
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
      if (m < M) put(r_d, a.var[m], pick(r_d, a.var[m]) - ia[m] * z[m]);
    }
    T r_pe[KA];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      T acc = bq[k];
#pragma unroll
      for (int j = 0; j < N; ++j) acc = acc + A[k][j] * x[j];
      r_pe[k] = acc;
    }
    T r_pi[R], r_c[R], zs[R], sig[R];
#pragma unroll
    for (int m = 0; m < R; ++m) {
      r_pi[m] = ia[m] * pick(x, a.var[m]) + ib[m] - s[m];
      r_c[m] = s[m] * z[m];
      zs[m] = z[m] / s[m];
      sig[m] = ia[m] * ia[m] * zs[m];
    }
    assemble(sig);
    mo::ldlt_factor<T, D>(H, L, dg);

    // Elimination, condensed solve, back-substitution (qp.cc:318-364).
    auto solve_step = [&](T mu_v, const T (&corr)[R], T (&dx)[N], T (&dy)[KA], T (&ds)[R],
                          T (&dz)[R]) {
#pragma unroll
      for (int i = 0; i < N; ++i) sol[i] = r_d[i];
#pragma unroll
      for (int m = 0; m < R; ++m) {
        if (m < M) {
          const T add = ia[m] * (zs[m] * r_pi[m] + (r_c[m] + corr[m] - mu_v) / s[m]);
          put(sol, a.var[m], pick(sol, a.var[m]) + add);
        }
      }
#pragma unroll
      for (int i = 0; i < N; ++i) sol[i] = -sol[i];
#pragma unroll
      for (int k = 0; k < K; ++k) sol[N + k] = -r_pe[k];
      mo::ldlt_apply<T, D>(L, dg, sol);
#pragma unroll
      for (int i = 0; i < N; ++i) dx[i] = sol[i];
#pragma unroll
      for (int k = 0; k < K; ++k) dy[k] = -sol[N + k];
#pragma unroll
      for (int m = 0; m < R; ++m) {
        ds[m] = ia[m] * pick(dx, a.var[m]) + r_pi[m];
        dz[m] = -zs[m] * ds[m] - (r_c[m] + corr[m] - mu_v) / s[m];
      }
    };

    T dx[N], dy[KA], ds[R], dz[R], zeros_c[R];
#pragma unroll
    for (int m = 0; m < R; ++m) zeros_c[m] = zero;
    if (M == 0) {
      solve_step(zero, zeros_c, dx, dy, ds, dz);
    } else if (a.mpc) {
      T dxa[N], dya[KA], dsa[R], dza[R], corr[R];
      solve_step(zero, zeros_c, dxa, dya, dsa, dza);
      const T ap_a = ftb(s, dsa, one);
      const T ad_a = ftb(z, dza, one);
      T mu_aff = zero;
#pragma unroll
      for (int m = 0; m < R; ++m) {
        if (m < M) mu_aff = mu_aff + (s[m] + ap_a * dsa[m]) * (z[m] + ad_a * dza[m]);
      }
      mu_aff = mo::nmax(mu_aff / T(M), zero);
      const T ratio = mu_aff / mu;
      const T mu_used = ratio * (ratio * ratio) * mu;
#pragma unroll
      for (int m = 0; m < R; ++m) corr[m] = dsa[m] * dza[m];
      solve_step(mu_used, corr, dx, dy, ds, dz);
    } else {
      solve_step(mu, zeros_c, dx, dy, ds, dz);
    }

    T ap = one, ad = one;
    if (M > 0) {
      ap = ftb(s, ds, tau);
      ad = ftb(z, dz, tau);
    }
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
        if (m < M) comp = comp + s[m] * z[m];
      }
      mu = sigma * (comp / T(M));
    }
  }

#pragma unroll
  for (int i = 0; i < N; ++i) x_out[i * b + lane] = x[i];
#pragma unroll
  for (int k = 0; k < K; ++k) y_out[k * b + lane] = y[k];
}

struct Ptrs {
  const void *G, *c, *A, *b, *ia, *ib;
  void *x, *y;
};

template <typename T, int N, int K>
int launch(const Ptrs& p, int B, const QPArgs& a, cudaStream_t stream) {
  fused_qp_kernel<T, N, K><<<(B + kBlock - 1) / kBlock, kBlock, 0, stream>>>(
      static_cast<const T*>(p.G), static_cast<const T*>(p.c), static_cast<const T*>(p.A),
      static_cast<const T*>(p.b), static_cast<const T*>(p.ia), static_cast<const T*>(p.ib),
      static_cast<T*>(p.x), static_cast<T*>(p.y), B, a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int K>
int dispatch_n(int N, const Ptrs& p, int B, const QPArgs& a, cudaStream_t s) {
  switch (N) {
    case 2: return launch<T, 2, K>(p, B, a, s);
    case 3: return launch<T, 3, K>(p, B, a, s);
    case 4: return launch<T, 4, K>(p, B, a, s);
    case 5: return launch<T, 5, K>(p, B, a, s);
    case 6: return launch<T, 6, K>(p, B, a, s);
    case 7: return launch<T, 7, K>(p, B, a, s);
    case 8: return launch<T, 8, K>(p, B, a, s);
    default: return mo::kNoInstance;
  }
}

template <typename T>
int dispatch_k(int N, int K, const Ptrs& p, int B, const QPArgs& a, cudaStream_t s) {
  switch (K) {
    case 0: return dispatch_n<T, 0>(N, p, B, a, s);
    case 1: return dispatch_n<T, 1>(N, p, B, a, s);
    default: return mo::kNoInstance;
  }
}

}  // namespace

// dtype: 0 float, 1 double. Feature-major G (N, N, B) (lower triangle
// read), c (N, B), A (K, N, B), b (K, B), ia / ib (M, B), x (N, B), y (K, B);
// var holds the M box rows' variable indices.
extern "C" int mo_fused_qp_launch(int dtype, int N, int K, int M, const int* var, const void* G,
                                  const void* c, const void* A, const void* b, const void* ia,
                                  const void* ib, void* x, void* y, int B, int iterations,
                                  double sigma, int mpc, int has_eq_guess, void* stream) {
  if (B <= 0 || iterations < 0 || M < 0 || M > 2 * N || M > kMaxRows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  QPArgs a{};
  a.M = M;
  for (int m = 0; m < M; ++m) {
    if (var[m] < 0 || var[m] >= N) return static_cast<int>(cudaErrorInvalidValue);
    a.var[m] = var[m];
  }
  a.iterations = iterations;
  a.sigma = sigma;
  a.mpc = mpc;
  a.has_eq_guess = has_eq_guess;
  const Ptrs p{G, c, A, b, ia, ib, x, y};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch_k<float>(N, K, p, B, a, s);
    case 1: return dispatch_k<double>(N, K, p, B, a, s);
    default: return mo::kNoInstance;
  }
}
