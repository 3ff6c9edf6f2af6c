// Fused whole-solve SQP for medium-N families (the blocked tier) on Hopper.
//
// Replaces the TPU kernel mini_opt_tpu/ops/pallas_blocked.py::
// _make_blocked_kernel (launched at pallas_blocked.py:703 by
// blocked_solve_batch), and, through ldlt_factor_cta / ldlt_solve_cta
// (used by blocked_kkt.cu), the kernel of pallas_blocked.py::
// blocked_kkt_solve. It computes what fused_sqp.cuh computes -- the family's
// linearization and damped Gauss-Newton assembly, the condensed KKT interior
// point (equality-constrained initial guess, complementarity or Mehrotra mu,
// fraction to the boundary), the L1-merit Armijo or polynomial line search
// with retraction, the lambda machine, the best-merit return with f_best
// starting at +inf, and the (f, |eq|_1, flags) write-out -- for systems of
// D = n + m rows past the register tier's 32.
//
// What bounds it on this card: operations, and the latency between them.
// An instance reads and writes a few hundred bytes but factors its D x D
// KKT matrix (qp_iterations + 1) times per outer iteration, D^3 / 3
// multiply-subtracts each: about a million floating-point operations per
// instance at D = 49. The factorization's column steps depend on each other,
// so one instance's work is a chain of D steps per factor and 2 D per solve.
//
// What the design does about it: one instance per CTA, one thread per KKT
// row (blockDim = D rounded up to whole warps). The KKT matrix, its factor,
// the packed Gauss-Newton Hessian and the solver's vectors live in dynamic
// shared memory (about 18 KB at D = 49 in float, 190 KB at D = 120 in
// double), so nothing of the solve touches device memory; many CTAs per SM
// hide each other's barrier latency. The factorization is right-looking:
// at step k every row below k takes its multiplier and updates its own part
// of the trailing lower triangle, two barriers per step; the substitutions
// publish one entry per step, one barrier per step. Vectors indexed by
// variable or KKT row sit in the owning thread's registers (the slacks of a
// variable with the variable). Quantities uniform across the instance
// (merits, step lengths, mu, lambda, penalties) are computed by every thread
// from the same shared values in the same order, so they need no broadcast.
// A warp per instance, several instances per CTA and fewer barriers are
// later work.
//
// Order of operations: every sum the JAX kernel takes with jnp.sum over a
// stacked axis is taken here term by term in index order, the factor's
// updates in pivot order, as in the plain PyTorch version
// (ops/blocked.py::_blocked_solve_plain). With no FMA contraction
// (--fmad=false) and no fast math, kernel and plain version round alike.
#pragma once

#include <cfloat>
#include <cmath>

#include "fused_sqp.cuh"

namespace mo {
namespace blocked {

// Threads per CTA for a D-row system: one per row, whole warps.
__host__ __device__ inline int block_threads(int D) { return (D + 31) / 32 * 32; }
// Row stride of a D x D matrix in shared memory: odd, so that the threads of
// a warp reading A[i * S + k] (one row each) fall in different banks.
__host__ __device__ inline int row_stride(int D) { return D | 1; }
// Start of row i of a packed lower triangle.
__host__ __device__ inline int tri(int i) { return i * (i + 1) / 2; }

// The unpivoted LDL^T of the D x D matrix A (row-major, stride S, lower
// triangle read), by the CTA, thread i owning row i. On exit A's strict
// lower triangle holds L (unit diagonal implied) and d the pivots. Step k:
// L_ik = A_ik / d_k and w_i = d_k L_ik for every row i > k, then
// A_ij -= L_ik * w_j on row i's part of the trailing lower triangle. Begins
// and ends with a barrier.
template <typename T>
__device__ void ldlt_factor_cta(T* A, T* d, T* w, int D, int S, int tid) {
  __syncthreads();
  for (int k = 0; k < D; ++k) {
    const T dk = A[k * S + k];
    T lk = T(0);
    if (tid == k) d[k] = dk;
    if (tid > k && tid < D) {
      lk = A[tid * S + k] / dk;
      A[tid * S + k] = lk;
      w[tid] = dk * lk;
    }
    __syncthreads();
    if (tid > k && tid < D) {
      T* row = A + tid * S;
      for (int j = k + 1; j <= tid; ++j) row[j] = row[j] - lk * w[j];
    }
    __syncthreads();
  }
}

// Solve L diag(d) L^T x = rhs with the factor of ldlt_factor_cta. Thread i
// passes rhs_i in v and gets x_i back; w is the publication buffer. Forward
// substitution subtracts L_ik x_k for k = 0, 1, ...; back substitution
// L_kj x_k for k = D-1, D-2, .... Ends with a barrier.
template <typename T>
__device__ T ldlt_solve_cta(const T* A, const T* d, T* w, int D, int S, int tid, T v) {
  for (int k = 0; k < D - 1; ++k) {
    if (tid == k) w[k] = v;
    __syncthreads();
    if (tid > k && tid < D) v = v - A[tid * S + k] * w[k];
  }
  if (tid < D) v = v / d[tid];
  for (int k = D - 1; k > 0; --k) {
    if (tid == k) w[k] = v;
    __syncthreads();
    if (tid < k) v = v - A[k * S + tid] * w[k];
  }
  __syncthreads();
  return v;
}

// 1 where any pivot is (near-)zero or non-finite, else 0.
template <typename T>
__device__ T factor_bad(const T* d, int D) {
  bool good = true;
  for (int j = 0; j < D; ++j) good = good && fabs(d[j]) > Tiny<T>::value() && isfinite(d[j]);
  return good ? T(0) : T(1);
}

// Fraction to the boundary: the step-length candidate of one slack.
template <typename T>
__device__ __forceinline__ T ftb_cand(T v, T dv, T tau) {
  const bool blocking = (v + dv <= T(0)) && (fabs(dv) > T(0));
  const T cand = -tau * v / (blocking ? dv : T(1));
  return blocking ? cand : T(1);
}

// alpha = min(alpha, min_j cand[j]), NaN-propagating.
template <typename T>
__device__ T min_into(T alpha, const T* cand, int count) {
  if (count == 0) return alpha;
  T mn = cand[0];
  for (int j = 1; j < count; ++j) mn = nmin(mn, cand[j]);
  return nmin(alpha, mn);
}

// terms[0] + terms[1] + ... (count >= 1).
template <typename T>
__device__ T sum_terms(const T* terms, int count) {
  T acc = terms[0];
  for (int j = 1; j < count; ++j) acc = acc + terms[j];
  return acc;
}

// One instance's shared memory.
template <typename T>
struct Smem {
  T* A;      // D x S: the KKT matrix, factored in place
  T* d;      // D pivots
  T* w;      // D: the factor's w, the solves' published entries
  T* G;      // n (n + 1) / 2: damped Gauss-Newton Hessian, packed lower
  T* Jeq;    // m x n
  T* c;      // n gradient
  T* req;    // m equality residuals
  T* th;     // n: the iterate (or line-search candidate) the family reads
  T* tgt;    // data rows
  T* vec;    // D: a published primal (n) + dual (m) vector
  T* ftb_lo; // 2 nlo: step candidates, primal then dual side
  T* ftb_hi; // 2 nhi
  T* terms;  // nlo + nhi: per-slack terms of a sum
  T* fam;    // the family's scratch
};

// Carve one instance's shared memory out of `base` (nullptr: only count);
// returns the bytes it takes.
template <typename T, class F>
__host__ __device__ size_t carve(const F& fam, unsigned char* base, Smem<T>* out) {
  const int n = fam.nvar(), m = F::M, D = n + m;
  size_t off = 0;
  auto take = [&](size_t count) {
    T* p = base ? reinterpret_cast<T*>(base) + off : nullptr;
    off += count;
    return p;
  };
  Smem<T> s;
  s.A = take(size_t(D) * row_stride(D));
  s.d = take(D);
  s.w = take(D);
  s.G = take(size_t(tri(n)));
  s.Jeq = take(size_t(m) * n);
  s.c = take(n);
  s.req = take(m);
  s.th = take(n);
  s.tgt = take(F::ROWS);
  s.vec = take(D);
  s.ftb_lo = take(2 * size_t(fam.nlo()));
  s.ftb_hi = take(2 * size_t(fam.nhi()));
  s.terms = take(size_t(fam.nlo() + fam.nhi()));
  s.fam = take(fam.scratch());
  if (out) *out = s;
  return off * sizeof(T);
}

// The instance's view of itself: sizes, and which variable, equality row
// and slacks this thread owns.
struct Rows {
  int n, m, D, S, nlo, nhi, ncon, tid;
  bool var;    // thread owns variable tid
  bool eqrow;  // thread owns equality row tid - n
  int slo;     // this variable's lower slack, or -1
  int shi;     // this variable's upper slack, or -1
};

// The condensed KKT matrix [[G + diag(sig_d), .], [J_eq, 0]], lower
// triangle, row tid (pallas_blocked.py:203-225).
template <typename T>
__device__ void assemble_kkt(const Smem<T>& s, const Rows& r, bool with_sig, T sig_d) {
  const int i = r.tid;
  T* row = s.A + i * r.S;
  if (r.var) {
    const T* g = s.G + tri(i);
    for (int j = 0; j < i; ++j) row[j] = g[j];
    row[i] = with_sig ? g[i] + sig_d : g[i];
  } else if (r.eqrow) {
    const T* J = s.Jeq + (i - r.n) * r.n;
    for (int j = 0; j < r.n; ++j) row[j] = J[j];
    for (int j = r.n; j <= i; ++j) row[j] = T(0);
  }
}

// Interior point on the condensed system (pallas_blocked.py:227-424).
// Reads G, c, Jeq, req from shared memory and this thread's shifted bounds
// ib_lo / ib_hi; returns the uniform factorization flag and this thread's
// primal (var threads) in x, dual (equality rows) in y.
template <typename T, class F>
__device__ T qp_solve(const F& fam, const Smem<T>& s, const Rows& r, T ib_lo, T ib_hi,
                      const SolveOptions& opt, T& x_out, T& y_out) {
  const bool var = r.var, eqrow = r.eqrow;
  const int slo = r.slo, shi = r.shi, nlo = r.nlo, nhi = r.nhi;

  assemble_kkt(s, r, false, T(0));
  ldlt_factor_cta(s.A, s.d, s.w, r.D, r.S, r.tid);
  T bad = factor_bad(s.d, r.D);
  T v = var ? -s.c[r.tid] : (eqrow ? -s.req[r.tid - r.n] : T(0));
  v = ldlt_solve_cta(s.A, s.d, s.w, r.D, r.S, r.tid, v);
  T x = v;
  T y = -v;
  if (r.ncon == 0) {
    x_out = x;
    y_out = y;
    return bad;
  }

  // Clamp into the shifted bounds, then slack/dual init (qp.cc:470-481).
  if (slo >= 0) x = nmax(x, -ib_lo);
  if (shi >= 0) x = nmin(x, ib_hi);
  T s_lo = T(0), s_hi = T(0), z_lo = T(0), z_hi = T(0);
  if (slo >= 0) {
    s_lo = nmax(x + ib_lo, T(1e-9));
    z_lo = T(1) / s_lo;
  }
  if (shi >= 0) {
    s_hi = nmax(-x + ib_hi, T(1e-9));
    z_hi = T(1) / s_hi;
  }

  T mu = T(1);
  const T tau = T(0.995);
  for (int qit = 0; qit < opt.qp_iterations; ++qit) {
    if (var) s.vec[r.tid] = x;
    if (eqrow) s.vec[r.tid] = y;
    __syncthreads();
    // KKT residuals (eqs 19.2a-d, qp.cc:391-420).
    T r_d = T(0), r_pe = T(0);
    if (var) {
      const int i = r.tid;
      T acc = s.G[tri(i)] * s.vec[0];
      for (int j = 1; j < r.n; ++j) {
        const T g = j <= i ? s.G[tri(i) + j] : s.G[tri(j) + i];
        acc = acc + g * s.vec[j];
      }
      r_d = s.c[i] + acc;
      if (r.m > 0) {
        T acc_t = s.Jeq[i] * s.vec[r.n];
        for (int k = 1; k < r.m; ++k) acc_t = acc_t + s.Jeq[k * r.n + i] * s.vec[r.n + k];
        r_d = r_d - acc_t;
      }
      if (nlo > 0) r_d = r_d - (slo >= 0 ? z_lo : T(0));
      if (nhi > 0) r_d = r_d + (shi >= 0 ? z_hi : T(0));
    }
    if (eqrow) {
      const T* J = s.Jeq + (r.tid - r.n) * r.n;
      T acc = J[0] * s.vec[0];
      for (int j = 1; j < r.n; ++j) acc = acc + J[j] * s.vec[j];
      r_pe = s.req[r.tid - r.n] + acc;
    }
    const T r_pi_lo = slo >= 0 ? x + ib_lo - s_lo : T(0);
    const T r_pi_hi = shi >= 0 ? -x + ib_hi - s_hi : T(0);
    const T r_c_lo = s_lo * z_lo, r_c_hi = s_hi * z_hi;
    const T sig_lo = slo >= 0 ? z_lo / s_lo : T(0);
    const T sig_hi = shi >= 0 ? z_hi / s_hi : T(0);
    T sig_d = T(0);
    if (nlo > 0) sig_d = sig_d + (slo >= 0 ? sig_lo : T(0));
    if (nhi > 0) sig_d = sig_d + (shi >= 0 ? sig_hi : T(0));
    assemble_kkt(s, r, true, sig_d);
    ldlt_factor_cta(s.A, s.d, s.w, r.D, r.S, r.tid);
    bad = nmax(bad, factor_bad(s.d, r.D));

    // Condensed solve for a barrier value and corrector terms, and the
    // recovered slack and dual steps.
    auto solve_step = [&](T mu_v, T corr_lo, T corr_hi, T& dx_v, T& dy_v, T& ds_lo_v,
                          T& ds_hi_v, T& dz_lo_v, T& dz_hi_v) {
      T rhs = T(0);
      if (var) {
        T r_aug = r_d;
        if (nlo > 0)
          r_aug = r_aug + (slo >= 0 ? sig_lo * r_pi_lo + (r_c_lo + corr_lo - mu_v) / s_lo : T(0));
        if (nhi > 0)
          r_aug = r_aug - (shi >= 0 ? sig_hi * r_pi_hi + (r_c_hi + corr_hi - mu_v) / s_hi : T(0));
        rhs = -r_aug;
      } else if (eqrow) {
        rhs = -r_pe;
      }
      const T sol = ldlt_solve_cta(s.A, s.d, s.w, r.D, r.S, r.tid, rhs);
      dx_v = sol;
      dy_v = -sol;
      ds_lo_v = slo >= 0 ? dx_v + r_pi_lo : T(0);
      ds_hi_v = shi >= 0 ? -dx_v + r_pi_hi : T(0);
      dz_lo_v = slo >= 0 ? -sig_lo * ds_lo_v - (r_c_lo + corr_lo - mu_v) / s_lo : T(0);
      dz_hi_v = shi >= 0 ? -sig_hi * ds_hi_v - (r_c_hi + corr_hi - mu_v) / s_hi : T(0);
    };

    // Primal and dual step lengths over the lo then the hi slacks.
    auto ftb = [&](T ds_lo_v, T ds_hi_v, T dz_lo_v, T dz_hi_v, T tau_v, T& ap_v, T& ad_v) {
      if (slo >= 0) {
        s.ftb_lo[slo] = ftb_cand(s_lo, ds_lo_v, tau_v);
        s.ftb_lo[nlo + slo] = ftb_cand(z_lo, dz_lo_v, tau_v);
      }
      if (shi >= 0) {
        s.ftb_hi[shi] = ftb_cand(s_hi, ds_hi_v, tau_v);
        s.ftb_hi[nhi + shi] = ftb_cand(z_hi, dz_hi_v, tau_v);
      }
      __syncthreads();
      ap_v = min_into(min_into(T(1), s.ftb_lo, nlo), s.ftb_hi, nhi);
      ad_v = min_into(min_into(T(1), s.ftb_lo + nlo, nlo), s.ftb_hi + nhi, nhi);
    };

    // (0 + sum of the lo terms) + sum of the hi terms, in slack order.
    auto slack_sum = [&](T t_lo, T t_hi) {
      if (slo >= 0) s.terms[slo] = t_lo;
      if (shi >= 0) s.terms[nlo + shi] = t_hi;
      __syncthreads();
      T acc = T(0);
      if (nlo > 0) acc = acc + sum_terms(s.terms, nlo);
      if (nhi > 0) acc = acc + sum_terms(s.terms + nlo, nhi);
      return acc;
    };

    T dx, dy, ds_lo, ds_hi, dz_lo, dz_hi;
    if (opt.mpc) {
      // Mehrotra predictor-corrector (alg 16.4 / qp.cc:170-188).
      T dxa, dya, dsl_a, dsh_a, dzl_a, dzh_a, ap_a, ad_a;
      solve_step(T(0), T(0), T(0), dxa, dya, dsl_a, dsh_a, dzl_a, dzh_a);
      ftb(dsl_a, dsh_a, dzl_a, dzh_a, T(1), ap_a, ad_a);
      T mu_aff = slack_sum((s_lo + ap_a * dsl_a) * (z_lo + ad_a * dzl_a),
                           (s_hi + ap_a * dsh_a) * (z_hi + ad_a * dzh_a));
      mu_aff = nmax(mu_aff / T(r.ncon), T(0));
      const T ratio = mu_aff / mu;
      const T sigma = ratio * (ratio * ratio);  // jax.lax.integer_pow(ratio, 3)
      solve_step(sigma * mu, dsl_a * dzl_a, dsh_a * dzh_a, dx, dy, ds_lo, ds_hi, dz_lo, dz_hi);
    } else {
      solve_step(mu, T(0), T(0), dx, dy, ds_lo, ds_hi, dz_lo, dz_hi);
    }

    T ap, ad;
    ftb(ds_lo, ds_hi, dz_lo, dz_hi, tau, ap, ad);
    x = x + ap * dx;
    s_lo = s_lo + ap * ds_lo;
    z_lo = z_lo + ad * dz_lo;
    s_hi = s_hi + ap * ds_hi;
    z_hi = z_hi + ad * dz_hi;
    y = y + ad * dy;
    const T comp = slack_sum(s_lo * z_lo, s_hi * z_hi);
    mu = T(0.1) * (comp / T(r.ncon));
  }
  const bool finite = __syncthreads_and(!var || isfinite(x));
  bad = nmax(bad, finite ? T(0) : T(1));
  x_out = x;
  y_out = y;
  return bad;
}

// The whole fused solve of instance blockIdx.x of family `fam`. Inputs and
// outputs are feature-major: data (ROWS, B), x0 (n, B), x_out (n, B),
// state (3, B).
template <typename T, class F>
__device__ void blocked_sqp_solve(const F& fam, const T* __restrict__ data,
                                  const T* __restrict__ x0, T* __restrict__ x_out,
                                  T* __restrict__ state, int B, const SolveOptions& opt,
                                  unsigned char* smem) {
  Smem<T> s;
  carve<T, F>(fam, smem, &s);
  Rows r;
  r.n = fam.nvar();
  r.m = F::M;
  r.D = r.n + r.m;
  r.S = row_stride(r.D);
  r.nlo = fam.nlo();
  r.nhi = fam.nhi();
  r.ncon = r.nlo + r.nhi;
  r.tid = threadIdx.x;
  r.var = r.tid < r.n;
  r.eqrow = r.tid >= r.n && r.tid < r.D;
  r.slo = r.var ? fam.lo_slot(r.tid) : -1;
  r.shi = r.var ? fam.hi_slot(r.tid) : -1;
  const int tid = r.tid, n = r.n, m = r.m;
  const size_t b = blockIdx.x, nb = static_cast<size_t>(B);

  if (tid < F::ROWS) s.tgt[tid] = data[tid * nb + b];
  T th = r.var ? x0[tid * nb + b] : T(0);
  if (r.var) s.th[tid] = th;

  T lam = T(0.001);
  T penalty = T(0.01);
  T restore = T(0);
  // Best-merit iterate under the current penalty, from f_best = +inf
  // (pallas_blocked.py:607-610): a lane whose merit is never finite keeps
  // its start.
  T th_best = th;
  T f_best = T(INFINITY), eq_best = T(0);
  // fac_bad is sticky; lam_maxed holds the last iteration's state.
  T fac_bad = T(0), lam_maxed = T(0);
  T f_pre = T(0), eq_pre = T(0), f_acc = T(0), eq_acc = T(0), accepted = T(0);
  __syncthreads();

  for (int it = 0; it < opt.max_iterations; ++it) {
    fam.linearize(tid, s.th, s.tgt, s.fam, s.G, s.Jeq, s.c, s.req, f_pre);
    eq_pre = T(0);
    if (m > 0) {
      eq_pre = fabs(s.req[0]);
      for (int k = 1; k < m; ++k) eq_pre = eq_pre + fabs(s.req[k]);
    }
    const bool better = f_pre + penalty * eq_pre < f_best + penalty * eq_best;
    th_best = better ? th : th_best;
    f_best = better ? f_pre : f_best;
    eq_best = better ? eq_pre : eq_best;

    // LM damping, G + lam I (off-diagonal entries gain an exact +0).
    if (r.var) {
      T* row = s.G + tri(tid);
      for (int j = 0; j < tid; ++j) row[j] = row[j] + T(0);
      row[tid] = row[tid] + lam;
    }
    T ib_lo = T(0), ib_hi = T(0);
    if (r.slo >= 0) ib_lo = th - T(fam.lo_val(r.slo));
    if (r.shi >= 0) ib_hi = T(fam.hi_val(r.shi)) - th;
    __syncthreads();

    T dx, y;
    const T bad_it = qp_solve<T, F>(fam, s, r, ib_lo, ib_hi, opt, dx, y);
    fac_bad = nmax(fac_bad, bad_it);

    if (r.var) s.vec[tid] = dx;
    if (r.eqrow) s.vec[tid] = y;
    __syncthreads();
    T d_f = s.c[0] * s.vec[0];
    for (int i = 1; i < n; ++i) d_f = d_f + s.c[i] * s.vec[i];
    T d_eq = T(0);
    if (m > 0) {
      T y_abs = fabs(s.vec[n]);
      for (int k = 1; k < m; ++k) y_abs = nmax(y_abs, fabs(s.vec[n + k]));
      penalty = y_abs > penalty ? y_abs * T(1.01) : penalty;
      for (int k = 0; k < m; ++k) {
        const T* J = s.Jeq + k * n;
        T jdx = J[0] * s.vec[0];
        for (int j = 1; j < n; ++j) jdx = jdx + J[j] * s.vec[j];
        const T t = sgn(s.req[k]) * jdx;
        d_eq = k == 0 ? t : d_eq + t;
      }
    }
    const T dd = d_f + penalty * d_eq;
    const T merit_pre = f_pre + penalty * eq_pre;

    T alpha = T(1);
    accepted = T(0);
    T dead = T(0);  // lanes whose polynomial fit went invalid
    T best = th;
    f_acc = f_pre;
    eq_acc = eq_pre;
    T alpha_prev = T(1), phi_prev = merit_pre;
    T alpha_prev2 = T(2), phi_prev2 = merit_pre;
    for (int probe = 0; probe <= opt.ls_iterations; ++probe) {
      if (probe > 0) {
        if (!opt.polynomial) {
          alpha = alpha * T(0.5);
        } else {
          // Quadratic fit (probe 1), cubic after (nonlinear.cc:418-443),
          // with validity gating; an invalid fit kills the lane's remaining
          // probes.
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
      const T cand = fam.retract(th + alpha * dx);
      if (r.var) s.th[tid] = cand;
      __syncthreads();
      T f_c, eq_c;
      fam.errors(tid, s.th, s.tgt, s.fam, f_c, eq_c);
      const T merit_c = f_c + penalty * eq_c;
      // Armijo with the slack term clamped to <= 0.
      const T ok = merit_c <= merit_pre + T(1e-4) * alpha * nmin(dd, T(0)) ? T(1) : T(0);
      const T take = ok * (T(1) - accepted) * (T(1) - dead);
      // Arithmetic blend, not a select: a NaN candidate poisons `best`
      // exactly as in the JAX kernel.
      best = take * cand + (T(1) - take) * best;
      f_acc = take * f_c + (T(1) - take) * f_acc;
      eq_acc = take * eq_c + (T(1) - take) * eq_acc;
      accepted = nmin(accepted + take, T(1));
      alpha_prev2 = alpha_prev;
      phi_prev2 = phi_prev;
      alpha_prev = alpha;
      phi_prev = merit_c;
    }

    th = accepted > T(0) ? best : th;
    if (r.var) s.th[tid] = th;
    __syncthreads();
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
  if (r.var) x_out[tid * nb + b] = better ? th : th_best;
  if (tid == 0) {
    state[0 * nb + b] = better ? f_fin : f_best;
    state[1 * nb + b] = better ? eq_fin : eq_best;
    state[2 * nb + b] = fac_bad + T(2) * lam_maxed;
  }
}

#ifdef __CUDACC__
// Host side of a launch: checks that a CTA of `threads` threads with `bytes`
// of dynamic shared memory fits the current device and lets `kernel` use
// that much. Returns 0, a CUDA error code or kTooLarge.
template <typename Kernel>
int allow_dynamic_smem(Kernel kernel, int threads, int max_threads, size_t bytes) {
  int device = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  if (threads > max_threads || bytes > static_cast<size_t>(optin)) return kTooLarge;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
}
#endif

}  // namespace blocked
}  // namespace mo
