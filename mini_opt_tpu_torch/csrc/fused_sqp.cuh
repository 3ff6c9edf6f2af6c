// Fused whole-solve SQP for batched constrained least squares on Hopper.
//
// Replaces the TPU kernel mini_opt_tpu/ops/pallas_ik.py::_make_kernel
// (launched at pallas_ik.py:930 by _fused_solve). It computes the same
// thing, per instance: the family's linearization and Gauss-Newton assembly
// with LM damping; the condensed (n+m)^2 KKT interior point (equality-
// constrained initial guess, complementarity or Mehrotra mu schedule,
// fraction-to-boundary tau = 0.995) on a fully unrolled LDL^T; the L1-merit
// Armijo or polynomial line search with retraction and the Armijo slack
// clamped to <= 0; the LM lambda restore machine; the best-merit return; the
// (f, |eq|_1, flags) write-out; optionally the (iters, 7 + n) history.
//
// What bounds it on this card: arithmetic. An instance reads data_rows + n
// scalars and writes n + 3 (about 2n + 5) but runs thousands of floating-
// point operations (counted by chip_smoke.py from the plain version), so
// the memory system is idle next to the FP32/FP64 pipes.
//
// What the design does about it: one instance per CUDA thread, so every
// step is scalar register arithmetic with no shared memory, no
// synchronisation and no cross-thread traffic. The compile-time sizes come
// from the family (Family::N, Family::M, the bound lists), every D-loop is
// unrolled, so the KKT matrix, its factor and all iterates live in
// registers (D = n + m <= 9 for the instantiated families); only the
// iteration budgets and the barrier / line-search choices are runtime
// values, uniform across the warp, so there is no divergence. Loads are
// feature-major (vars, B): thread i reads column i and a warp's loads are
// coalesced. The ragged edge is masked; there are no padding lanes.
//
// Semantics mirror the JAX kernel where a transcription would drift:
// jnp.maximum/minimum propagate NaN (nmax/nmin below, not fmax/fmin),
// jnp.sign is 0 at 0 and NaN at NaN, the pivot test uses FLT_MIN/DBL_MIN,
// and every sum keeps the JAX kernel's order. The build uses no fast math
// and no FMA contraction, so this kernel reproduces the plain PyTorch
// version (ops/fused_ik.py::_fused_solve_plain) bit for bit.
#pragma once

#include <cfloat>
#include <cmath>

namespace mo {

template <typename T>
struct Tiny;
template <>
struct Tiny<float> {
  static __device__ __forceinline__ float value() { return FLT_MIN; }
};
template <>
struct Tiny<double> {
  static __device__ __forceinline__ double value() { return DBL_MIN; }
};

// jnp.maximum / jnp.minimum: NaN if either operand is NaN.
template <typename T>
__device__ __forceinline__ T nmax(T a, T b) {
  return (a != a || b != b) ? a + b : (a > b ? a : b);
}
template <typename T>
__device__ __forceinline__ T nmin(T a, T b) {
  return (a != a || b != b) ? a + b : (a < b ? a : b);
}
// jnp.sign: +-1, and the input itself at +-0 and NaN.
template <typename T>
__device__ __forceinline__ T sgn(T a) {
  return a > T(0) ? T(1) : (a < T(0) ? T(-1) : a);
}

struct SolveOptions {
  int max_iterations;
  int qp_iterations;
  int ls_iterations;
  bool polynomial;  // polynomial line search, else Armijo
  bool mpc;         // Mehrotra predictor-corrector, else complementarity
};

// Unit-lower L and diagonal d of the symmetric D x D system H (lower
// triangle read), fully unrolled.
template <typename T, int D>
__device__ __forceinline__ void ldlt_factor(const T (&H)[D][D], T (&L)[D][D], T (&d)[D]) {
#pragma unroll
  for (int j = 0; j < D; ++j) {
    T acc = H[j][j];
#pragma unroll
    for (int k = 0; k < j; ++k) acc = acc - L[j][k] * L[j][k] * d[k];
    d[j] = acc;
#pragma unroll
    for (int i = j + 1; i < D; ++i) {
      T aij = H[i][j];
#pragma unroll
      for (int k = 0; k < j; ++k) aij = aij - L[i][k] * L[j][k] * d[k];
      L[i][j] = aij / d[j];
    }
  }
}

// y <- (L D L^T)^{-1} y, unrolled substitutions.
template <typename T, int D>
__device__ __forceinline__ void ldlt_apply(const T (&L)[D][D], const T (&d)[D], T (&y)[D]) {
#pragma unroll
  for (int i = 0; i < D; ++i) {
#pragma unroll
    for (int k = 0; k < i; ++k) y[i] = y[i] - L[i][k] * y[k];
  }
#pragma unroll
  for (int i = 0; i < D; ++i) y[i] = y[i] / d[i];
#pragma unroll
  for (int i = D - 1; i >= 0; --i) {
#pragma unroll
    for (int k = i + 1; k < D; ++k) y[i] = y[i] - L[k][i] * y[k];
  }
}

// 1 where any pivot is (near-)zero or non-finite, else 0.
template <typename T, int D>
__device__ __forceinline__ T ldlt_bad(const T (&d)[D]) {
  T bad = T(0);
#pragma unroll
  for (int j = 0; j < D; ++j) {
    const bool good = (fabs(d[j]) > Tiny<T>::value()) && isfinite(d[j]);
    bad = nmax(bad, good ? T(0) : T(1));
  }
  return bad;
}

// Interior point on the condensed (n+m) x (n+m) system (qp.cc:228-316
// structure), for families with bounds on both sides (NLO, NHI >= 1: C++
// has no zero-length arrays). Bound rows act per side: for slack j on
// variable i, dx_i + ib_lo[j] >= 0 and -dx_i + ib_hi[j] >= 0. Writes dx and
// the duals y; returns 1 where any factorization of this solve was bad.
template <typename T, class F>
__device__ __forceinline__ T qp_solve(const T (&G)[F::N][F::N], const T (&c)[F::N],
                                      const T (&Jeq)[F::M][F::N], const T (&beq)[F::M],
                                      const T (&ib_lo)[F::NLO], const T (&ib_hi)[F::NHI],
                                      const SolveOptions& opt, T (&x)[F::N], T (&y)[F::M]) {
  constexpr int N = F::N, M = F::M, NLO = F::NLO, NHI = F::NHI;
  constexpr int NCON = NLO + NHI, D = N + M;
  constexpr int NMAX = NLO > NHI ? NLO : NHI;

  T H[D][D];
  T L[D][D];
  T dg[D];
  T sol[D];
  // assemble(sig_lo, sig_hi): G's lower triangle, bound sigmas on the
  // diagonal, equality rows below.
  auto assemble = [&](const T (&sig_lo)[NLO], const T (&sig_hi)[NHI]) {
#pragma unroll
    for (int i = 0; i < D; ++i) {
#pragma unroll
      for (int j = 0; j < D; ++j) H[i][j] = T(0);
    }
#pragma unroll
    for (int i = 0; i < N; ++i) {
#pragma unroll
      for (int j = 0; j <= i; ++j) H[i][j] = G[i][j];
    }
#pragma unroll
    for (int j = 0; j < NLO; ++j) H[F::lo_var(j)][F::lo_var(j)] = H[F::lo_var(j)][F::lo_var(j)] + sig_lo[j];
#pragma unroll
    for (int j = 0; j < NHI; ++j) H[F::hi_var(j)][F::hi_var(j)] = H[F::hi_var(j)][F::hi_var(j)] + sig_hi[j];
#pragma unroll
    for (int k = 0; k < M; ++k) {
#pragma unroll
      for (int j = 0; j < N; ++j) H[N + k][j] = Jeq[k][j];
    }
  };

  // Equality-constrained initial guess, then clamp + slack init
  // (InitialGuessMethod::SOLVE_EQUALITY_CONSTRAINED, qp.cc:439-482).
  T zlo0[NLO], zhi0[NHI];
#pragma unroll
  for (int j = 0; j < NLO; ++j) zlo0[j] = T(0);
#pragma unroll
  for (int j = 0; j < NHI; ++j) zhi0[j] = T(0);
  assemble(zlo0, zhi0);
#pragma unroll
  for (int i = 0; i < N; ++i) sol[i] = -c[i];
#pragma unroll
  for (int k = 0; k < M; ++k) sol[N + k] = -beq[k];
  ldlt_factor<T, D>(H, L, dg);
  T bad = ldlt_bad<T, D>(dg);
  ldlt_apply<T, D>(L, dg, sol);
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = sol[i];
#pragma unroll
  for (int k = 0; k < M; ++k) y[k] = -sol[N + k];
  T s_lo[NLO], s_hi[NHI], z_lo[NLO], z_hi[NHI];
#pragma unroll
  for (int j = 0; j < NLO; ++j) x[F::lo_var(j)] = nmax(x[F::lo_var(j)], -ib_lo[j]);
#pragma unroll
  for (int j = 0; j < NHI; ++j) x[F::hi_var(j)] = nmin(x[F::hi_var(j)], ib_hi[j]);
#pragma unroll
  for (int j = 0; j < NLO; ++j) s_lo[j] = nmax(T(1e-9), x[F::lo_var(j)] + ib_lo[j]);
#pragma unroll
  for (int j = 0; j < NHI; ++j) s_hi[j] = nmax(T(1e-9), -x[F::hi_var(j)] + ib_hi[j]);
#pragma unroll
  for (int j = 0; j < NLO; ++j) z_lo[j] = T(1) / s_lo[j];
#pragma unroll
  for (int j = 0; j < NHI; ++j) z_hi[j] = T(1) / s_hi[j];

  T mu = T(1);
  const T tau = T(0.995);
#pragma unroll 1
  for (int qit = 0; qit < opt.qp_iterations; ++qit) {
    // KKT residuals (eqs 19.2a-d, qp.cc:391-420).
    T r_d[N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      T acc = c[i];
#pragma unroll
      for (int k = 0; k < M; ++k) acc = acc - Jeq[k][i] * y[k];
#pragma unroll
      for (int j = 0; j < N; ++j) acc = acc + (i >= j ? G[i][j] : G[j][i]) * x[j];
      r_d[i] = acc;
    }
#pragma unroll
    for (int j = 0; j < NLO; ++j) r_d[F::lo_var(j)] = r_d[F::lo_var(j)] - z_lo[j];
#pragma unroll
    for (int j = 0; j < NHI; ++j) r_d[F::hi_var(j)] = r_d[F::hi_var(j)] + z_hi[j];
    T r_pe[M];
#pragma unroll
    for (int k = 0; k < M; ++k) {
      T acc = beq[k];
#pragma unroll
      for (int j = 0; j < N; ++j) acc = acc + Jeq[k][j] * x[j];
      r_pe[k] = acc;
    }
    T r_pi_lo[NLO], r_pi_hi[NHI], r_c_lo[NLO], r_c_hi[NHI], sig_lo[NLO], sig_hi[NHI];
#pragma unroll
    for (int j = 0; j < NLO; ++j) r_pi_lo[j] = x[F::lo_var(j)] + ib_lo[j] - s_lo[j];
#pragma unroll
    for (int j = 0; j < NHI; ++j) r_pi_hi[j] = -x[F::hi_var(j)] + ib_hi[j] - s_hi[j];
#pragma unroll
    for (int j = 0; j < NLO; ++j) r_c_lo[j] = s_lo[j] * z_lo[j];
#pragma unroll
    for (int j = 0; j < NHI; ++j) r_c_hi[j] = s_hi[j] * z_hi[j];
#pragma unroll
    for (int j = 0; j < NLO; ++j) sig_lo[j] = z_lo[j] / s_lo[j];
#pragma unroll
    for (int j = 0; j < NHI; ++j) sig_hi[j] = z_hi[j] / s_hi[j];
    assemble(sig_lo, sig_hi);
    ldlt_factor<T, D>(H, L, dg);
    bad = nmax(bad, ldlt_bad<T, D>(dg));

    // Variable elimination + condensed solve + back-substitution for a
    // barrier value and Mehrotra corrector terms.
    auto solve_step = [&](T mu_v, const T (&corr_lo)[NLO], const T (&corr_hi)[NHI],
                          T (&dx_v)[N], T (&dy_v)[M], T (&ds_lo_v)[NLO], T (&ds_hi_v)[NHI],
                          T (&dz_lo_v)[NLO], T (&dz_hi_v)[NHI]) {
      T rhs[D];
#pragma unroll
      for (int i = 0; i < N; ++i) rhs[i] = r_d[i];
#pragma unroll
      for (int j = 0; j < NLO; ++j) {
        const int i = F::lo_var(j);
        rhs[i] = rhs[i] + sig_lo[j] * r_pi_lo[j] + (r_c_lo[j] + corr_lo[j] - mu_v) / s_lo[j];
      }
#pragma unroll
      for (int j = 0; j < NHI; ++j) {
        const int i = F::hi_var(j);
        rhs[i] = rhs[i] - sig_hi[j] * r_pi_hi[j] - (r_c_hi[j] + corr_hi[j] - mu_v) / s_hi[j];
      }
#pragma unroll
      for (int i = 0; i < N; ++i) rhs[i] = -rhs[i];
#pragma unroll
      for (int k = 0; k < M; ++k) rhs[N + k] = -r_pe[k];
      ldlt_apply<T, D>(L, dg, rhs);
#pragma unroll
      for (int i = 0; i < N; ++i) dx_v[i] = rhs[i];
#pragma unroll
      for (int k = 0; k < M; ++k) dy_v[k] = -rhs[N + k];
#pragma unroll
      for (int j = 0; j < NLO; ++j) ds_lo_v[j] = dx_v[F::lo_var(j)] + r_pi_lo[j];
#pragma unroll
      for (int j = 0; j < NHI; ++j) ds_hi_v[j] = -dx_v[F::hi_var(j)] + r_pi_hi[j];
#pragma unroll
      for (int j = 0; j < NLO; ++j)
        dz_lo_v[j] = -sig_lo[j] * ds_lo_v[j] - (r_c_lo[j] + corr_lo[j] - mu_v) / s_lo[j];
#pragma unroll
      for (int j = 0; j < NHI; ++j)
        dz_hi_v[j] = -sig_hi[j] * ds_hi_v[j] - (r_c_hi[j] + corr_hi[j] - mu_v) / s_hi[j];
    };

    // Fraction to the boundary over the lo slacks then the hi slacks.
    auto ftb = [&](const T (&v_lo)[NLO], const T (&v_hi)[NHI], const T (&dv_lo)[NLO],
                   const T (&dv_hi)[NHI], T tau_v) {
      T alpha = T(1);
      auto one_side = [&](T v, T dv) {
        const bool blocking = (v + dv <= T(0)) && (fabs(dv) > T(0));
        const T cand = -tau_v * v / (blocking ? dv : T(1));
        alpha = nmin(alpha, blocking ? cand : T(1));
      };
#pragma unroll
      for (int j = 0; j < NLO; ++j) one_side(v_lo[j], dv_lo[j]);
#pragma unroll
      for (int j = 0; j < NHI; ++j) one_side(v_hi[j], dv_hi[j]);
      return alpha;
    };

    T dx[N], dy[M], ds_lo[NLO], ds_hi[NHI], dz_lo[NLO], dz_hi[NHI];
    if (opt.mpc) {
      // Mehrotra predictor-corrector (algorithm 16.4 / eq 19.22): affine
      // probe with mu = 0, sigma = (mu_aff / mu)^3, corrector
      // diag(ds_aff) dz_aff.
      T dxa[N], dya[M], dsl_a[NLO], dsh_a[NHI], dzl_a[NLO], dzh_a[NHI];
      solve_step(T(0), zlo0, zhi0, dxa, dya, dsl_a, dsh_a, dzl_a, dzh_a);
      const T ap_a = ftb(s_lo, s_hi, dsl_a, dsh_a, T(1));
      const T ad_a = ftb(z_lo, z_hi, dzl_a, dzh_a, T(1));
      T mu_aff = T(0);
#pragma unroll
      for (int j = 0; j < NMAX; ++j) {  // lo/hi interleaved (pallas_ik.py:345-354)
        if (j < NLO) mu_aff = mu_aff + (s_lo[j] + ap_a * dsl_a[j]) * (z_lo[j] + ad_a * dzl_a[j]);
        if (j < NHI) mu_aff = mu_aff + (s_hi[j] + ap_a * dsh_a[j]) * (z_hi[j] + ad_a * dzh_a[j]);
      }
      mu_aff = nmax(mu_aff / T(NCON), T(0));
      const T ratio = mu_aff / mu;
      const T sigma = ratio * (ratio * ratio);  // jax.lax.integer_pow(ratio, 3)
      const T mu_used = sigma * mu;
      T corr_lo[NLO], corr_hi[NHI];
#pragma unroll
      for (int j = 0; j < NLO; ++j) corr_lo[j] = dsl_a[j] * dzl_a[j];
#pragma unroll
      for (int j = 0; j < NHI; ++j) corr_hi[j] = dsh_a[j] * dzh_a[j];
      solve_step(mu_used, corr_lo, corr_hi, dx, dy, ds_lo, ds_hi, dz_lo, dz_hi);
    } else {
      solve_step(mu, zlo0, zhi0, dx, dy, ds_lo, ds_hi, dz_lo, dz_hi);
    }

    const T ap = ftb(s_lo, s_hi, ds_lo, ds_hi, tau);
    const T ad = ftb(z_lo, z_hi, dz_lo, dz_hi, tau);
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = x[i] + ap * dx[i];
#pragma unroll
    for (int j = 0; j < NLO; ++j) s_lo[j] = s_lo[j] + ap * ds_lo[j];
#pragma unroll
    for (int j = 0; j < NHI; ++j) s_hi[j] = s_hi[j] + ap * ds_hi[j];
#pragma unroll
    for (int k = 0; k < M; ++k) y[k] = y[k] + ad * dy[k];
#pragma unroll
    for (int j = 0; j < NLO; ++j) z_lo[j] = z_lo[j] + ad * dz_lo[j];
#pragma unroll
    for (int j = 0; j < NHI; ++j) z_hi[j] = z_hi[j] + ad * dz_hi[j];
    T comp = T(0);
#pragma unroll
    for (int j = 0; j < NMAX; ++j) {
      if (j < NLO) comp = comp + s_lo[j] * z_lo[j];
      if (j < NHI) comp = comp + s_hi[j] * z_hi[j];
    }
    mu = T(0.1) * (comp / T(NCON));
  }
  return bad;
}

// The whole fused solve of instance `lane` (< B) of family `fam`. Inputs
// and outputs are feature-major: data (ROWS, B), x0 (N, B), x_out (N, B),
// state (3, B), hist (max_iterations, 7 + N, B) or nullptr.
template <typename T, class F>
__device__ __forceinline__ void fused_sqp_solve(const F& fam, const T* __restrict__ data,
                                                const T* __restrict__ x0, T* __restrict__ x_out,
                                                T* __restrict__ state, T* __restrict__ hist,
                                                int B, int lane, const SolveOptions& opt) {
  constexpr int N = F::N, M = F::M, R = F::ROWS, NLO = F::NLO, NHI = F::NHI;
  constexpr int NH = 7 + N;  // history channels
  static_assert(M >= 1 && NLO >= 1 && NHI >= 1, "skeleton instantiated for bounded, constrained families");
  static_assert(N + M <= 32, "past D = 32 the register tier does not apply");
  const size_t b = static_cast<size_t>(B);
  const size_t l = static_cast<size_t>(lane);
  auto hist_at = [&](int it, int ch) -> T& { return hist[(static_cast<size_t>(it) * NH + ch) * b + l]; };

  T tgt[R], th[N];
#pragma unroll
  for (int r = 0; r < R; ++r) tgt[r] = data[r * b + l];
#pragma unroll
  for (int i = 0; i < N; ++i) th[i] = x0[i * b + l];

  T lam = T(0.001);
  T penalty = T(0.01);
  T restore = T(0);
  // Best-merit iterate ever visited, under the current penalty; NaN lanes
  // stay on their last good iterate (NaN comparisons are false).
  T th_best[N];
#pragma unroll
  for (int i = 0; i < N; ++i) th_best[i] = th[i];
  T f_best = T(0), eq_best = T(0);
  // fac_bad is sticky; lam_maxed holds the last iteration's state.
  T fac_bad = T(0), lam_maxed = T(0);
  T f_pre = T(0), eq_pre = T(0), f_acc = T(0), eq_acc = T(0), accepted = T(0);

#pragma unroll 1
  for (int it = 0; it < opt.max_iterations; ++it) {
    T r_eq[M], Jeq[M][N], G[N][N], c[N];
    fam.linearize(th, tgt, f_pre, r_eq, Jeq, G, c);
    eq_pre = T(0);
#pragma unroll
    for (int k = 0; k < M; ++k) eq_pre = eq_pre + fabs(r_eq[k]);
    if (it == 0) {
      f_best = f_pre;
      eq_best = eq_pre;
    } else {
      const bool better = f_pre + penalty * eq_pre < f_best + penalty * eq_best;
#pragma unroll
      for (int i = 0; i < N; ++i) th_best[i] = better ? th[i] : th_best[i];
      f_best = better ? f_pre : f_best;
      eq_best = better ? eq_pre : eq_best;
    }
    if (hist) {
      hist_at(it, 0) = f_pre;
      hist_at(it, 1) = eq_pre;
    }
    // LM damping on the diagonal (off-diagonal entries gain an exact +0).
#pragma unroll
    for (int i = 0; i < N; ++i) {
#pragma unroll
      for (int j = 0; j <= i; ++j) G[i][j] = G[i][j] + (i == j ? lam : T(0));
    }
    T ib_lo[NLO], ib_hi[NHI];
#pragma unroll
    for (int j = 0; j < NLO; ++j) ib_lo[j] = th[F::lo_var(j)] - T(F::lo_val(j));
#pragma unroll
    for (int j = 0; j < NHI; ++j) ib_hi[j] = T(F::hi_val(j)) - th[F::hi_var(j)];

    T dx[N], y[M];
    const T bad_it = qp_solve<T, F>(G, c, Jeq, r_eq, ib_lo, ib_hi, opt, dx, y);
    fac_bad = nmax(fac_bad, bad_it);

    T d_f = T(0);
#pragma unroll
    for (int i = 0; i < N; ++i) d_f = d_f + c[i] * dx[i];
    T y_abs = fabs(y[0]);
#pragma unroll
    for (int k = 1; k < M; ++k) y_abs = nmax(y_abs, fabs(y[k]));
    penalty = y_abs > penalty ? y_abs * T(1.01) : penalty;
    T d_eq = T(0);
#pragma unroll
    for (int k = 0; k < M; ++k) {
      T s = T(0);
#pragma unroll
      for (int i = 0; i < N; ++i) s = s + Jeq[k][i] * dx[i];
      d_eq = d_eq + sgn(r_eq[k]) * s;
    }
    const T dd = d_f + penalty * d_eq;
    const T merit_pre = f_pre + penalty * eq_pre;

    T alpha = T(1);
    accepted = T(0);
    T dead = T(0);  // lanes whose polynomial fit went invalid
    T best[N];
#pragma unroll
    for (int i = 0; i < N; ++i) best[i] = th[i];
    f_acc = f_pre;
    eq_acc = eq_pre;
    T alpha_prev = T(1), phi_prev = merit_pre;
    T alpha_prev2 = T(2), phi_prev2 = merit_pre;
#pragma unroll 1
    for (int probe = 0; probe <= opt.ls_iterations; ++probe) {
      if (probe > 0) {
        if (!opt.polynomial) {
          alpha = alpha * T(0.5);
        } else {
          // Quadratic fit (probe 1), cubic after (nonlinear.cc:418-443),
          // with validity gating; an invalid fit kills the lane's
          // remaining probes.
          T a_new;
          bool valid;
          if (probe == 1) {
            const T num = phi_prev - dd * alpha_prev - merit_pre;
            const T num_s = num == T(0) ? T(1) : num;
            a_new = -dd * alpha_prev * alpha_prev / (T(2) * num_s);
            valid = (dd <= T(0)) && (num > T(0));
          } else {
            const T a0 = alpha_prev2, a1 = alpha_prev;
            const T r0 = phi_prev2 - merit_pre - dd * a0;
            const T r1 = phi_prev - merit_pre - dd * a1;
            const T det = a0 * a0 * a1 * a1 * (a0 - a1);
            const T det_s = det == T(0) ? T(1) : det;
            const T ca = (a1 * a1 * r0 - a0 * a0 * r1) / det_s;
            const T cb = (-a1 * a1 * a1 * r0 + a0 * a0 * a0 * r1) / det_s;
            const T arg = cb * cb - T(3) * ca * dd;
            const T ca_s = ca == T(0) ? T(1) : ca;
            a_new = (-cb + sqrt(nmax(arg, T(1e-30)))) / (T(3) * ca_s);
            valid = (ca != T(0)) && (arg >= T(-1e-12)) && (det != T(0));
          }
          valid = valid && (a_new > T(0)) && (a_new < alpha);
          dead = nmax(dead, (T(1) - (valid ? T(1) : T(0))) * (T(1) - accepted));
          alpha = valid ? a_new : alpha * T(0.5);
        }
      }
      T cand[N];
#pragma unroll
      for (int i = 0; i < N; ++i) cand[i] = th[i] + alpha * dx[i];
      fam.retract(cand);
      T f_c, eq_c;
      fam.errors(cand, tgt, f_c, eq_c);
      const T merit_c = f_c + penalty * eq_c;
      // Armijo with the slack term clamped to <= 0.
      const T ok = merit_c <= merit_pre + T(1e-4) * alpha * nmin(dd, T(0)) ? T(1) : T(0);
      const T take = ok * (T(1) - accepted) * (T(1) - dead);
      // Arithmetic blend, not a select: a NaN candidate poisons `best`
      // exactly as in the JAX kernel.
#pragma unroll
      for (int i = 0; i < N; ++i) best[i] = take * cand[i] + (T(1) - take) * best[i];
      f_acc = take * f_c + (T(1) - take) * f_acc;
      eq_acc = take * eq_c + (T(1) - take) * eq_acc;
      accepted = nmin(accepted + take, T(1));
      alpha_prev2 = alpha_prev;
      phi_prev2 = phi_prev;
      alpha_prev = alpha;
      phi_prev = merit_c;
    }

#pragma unroll
    for (int i = 0; i < N; ++i) th[i] = accepted > T(0) ? best[i] : th[i];
    if (hist) {
      hist_at(it, 2) = penalty;
      hist_at(it, 3) = lam;
      hist_at(it, 4) = dd;
      hist_at(it, 5) = accepted;
      hist_at(it, 6) = alpha;
#pragma unroll
      for (int i = 0; i < N; ++i) hist_at(it, 7 + i) = dx[i];
    }
    const T lam_succ = nmax(lam * (restore > T(0) ? T(0.8) : T(0.1)), T(1e-9));
    const T lam_fail = restore > T(0) ? lam * T(10) : nmax(T(0.001), lam * T(10));
    lam = accepted > T(0) ? lam_succ : lam_fail;
    restore = accepted > T(0) ? T(0) : T(1);
    // MAX_LAMBDA analog: failed line search with damping past max_lambda.
    lam_maxed = (accepted == T(0) && lam > T(1)) ? T(1) : T(0);
  }

  // Final best update covers the last iteration's accepted step.
  const T f_fin = accepted > T(0) ? f_acc : f_pre;
  const T eq_fin = accepted > T(0) ? eq_acc : eq_pre;
  const bool better = f_fin + penalty * eq_fin < f_best + penalty * eq_best;
#pragma unroll
  for (int i = 0; i < N; ++i) x_out[i * b + l] = better ? th[i] : th_best[i];
  state[0 * b + l] = better ? f_fin : f_best;
  state[1 * b + l] = better ? eq_fin : eq_best;
  state[2 * b + l] = fac_bad + T(2) * lam_maxed;
}

}  // namespace mo
