// Kernels 8 and 9: whole-period MPC solves for fleets of plants on Hopper.
//
// Kernel 8 (mpc_solve_kernel) replaces the TPU kernel mini_opt_tpu/ops/
// pallas_mpc.py::_make_mpc_kernel (launched at pallas_mpc.py:1268 by
// fused_mpc_solve_batch): one MPC period of a direct multiple-shooting
// problem, per instance -- the stagewise RK4 linearization with forward-mode
// Jacobians (dual numbers), the Mehrotra interior point on the input bounds
// with its linear systems solved by a register Riccati recursion (LDL^T of
// the nu x nu F blocks), the L1-merit Armijo line search, the lambda machine
// at the MPC constants, the best-merit return and the (f, |eq|_1, flags)
// write-out, optionally the (iters, 7) history. Kernel 9 (mpc_servo_kernel)
// replaces pallas_mpc.py::_make_mpc_servo_kernel (launched at :1131 by
// fused_mpc_servo_batch): `periods` x (the same solve -> apply u_0 -> RK4
// plant step -> shift the warm start) in one launch.
//
// What bounds it on this card: arithmetic and the per-lane working set. An
// instance reads nx + T (nu + nx) scalars and writes as many, but runs some
// million floating-point operations per period at T = 20 (chip_smoke.py
// counts them from the plain version), and its stage arrays (about 125 T
// scalars for the cart-pole: iterates, A_t, B_t, the Riccati factors, the
// interior point's slacks, duals and residuals) do not fit registers.
//
// What the design does about it: one instance per CUDA thread, scalar
// arithmetic with no shared memory and no synchronisation. Only the plant's
// nx and nu are compile-time (the Plant functor); the horizon T is a
// run-time loop bound (#pragma unroll 1 over stages), so one build serves
// every horizon and the compile stays small. The stage arrays live in a
// scratch array the caller allocates, feature-major like the inputs
// ((slots, B), thread i on column i), so that a warp's accesses to one slot
// are coalesced; a stage's Riccati blocks (V, K, F) are registers.
//
// Semantics mirror the JAX kernel where a transcription would drift:
// jnp.maximum/minimum propagate NaN (nmax/nmin), jnp.sign is 0 at 0 and NaN
// at NaN, the pivot test uses FLT_MIN/DBL_MIN, every Python sum starts from
// 0 and runs in the JAX kernel's order, the cost and defect sums start from
// their first term, 0.5 dt and dt / 6 come folded in double, mu divides by
// the integer row count, (mu_aff / mu)^3 is x (x x), and the line search
// blends candidates arithmetically, so a NaN candidate poisons the blend.
// The build uses no fast math and no FMA contraction, so this kernel
// reproduces the plain PyTorch version (ops/mpc.py::_mpc_plain and
// _mpc_servo_plain) bit for bit.
#pragma once

#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

#include "fused_sqp.cuh"

namespace mo::mpc {

constexpr int kBlock = 64;
constexpr int kMaxNX = 6;
constexpr int kMaxNU = 2;
constexpr double kTauFtb = 0.995;

// The family's cost and bound constants, as Python doubles (each rounded
// once to T where it is used). w2* are the squared tracking weights of the
// running (t < T-1) and terminal stages, hw2* half of them.
struct Cost {
  int horizon;
  double hdt, dt, dt6;
  double w2[kMaxNX], w2T[kMaxNX], hw2[kMaxNX], hw2T[kMaxNX], goal[kMaxNX];
  double r_u[kMaxNU], hr_u[kMaxNU], u_ref[kMaxNU], u_min[kMaxNU], u_max[kMaxNU];
};

// ---------------------------------------------------------------------------
// Dual numbers: ops/mpc.py::_Dual's rules, in the same order.
// ---------------------------------------------------------------------------

template <typename T, int N>
struct Dual {
  T v;
  T t[N];
};

template <typename T, int N>
__device__ __forceinline__ Dual<T, N> operator+(const Dual<T, N>& a, const Dual<T, N>& b) {
  Dual<T, N> o;
  o.v = a.v + b.v;
#pragma unroll
  for (int k = 0; k < N; ++k) o.t[k] = a.t[k] + b.t[k];
  return o;
}
template <typename T, int N>
__device__ __forceinline__ Dual<T, N> operator+(T c, const Dual<T, N>& a) {
  Dual<T, N> o;
  o.v = c + a.v;
#pragma unroll
  for (int k = 0; k < N; ++k) o.t[k] = a.t[k];
  return o;
}
template <typename T, int N>
__device__ __forceinline__ Dual<T, N> operator-(const Dual<T, N>& a, const Dual<T, N>& b) {
  Dual<T, N> o;
  o.v = a.v - b.v;
#pragma unroll
  for (int k = 0; k < N; ++k) o.t[k] = a.t[k] - b.t[k];
  return o;
}
template <typename T, int N>
__device__ __forceinline__ Dual<T, N> operator-(const Dual<T, N>& a, T c) {
  Dual<T, N> o;
  o.v = a.v - c;
#pragma unroll
  for (int k = 0; k < N; ++k) o.t[k] = a.t[k];
  return o;
}
template <typename T, int N>
__device__ __forceinline__ Dual<T, N> operator-(const Dual<T, N>& a) {
  Dual<T, N> o;
  o.v = -a.v;
#pragma unroll
  for (int k = 0; k < N; ++k) o.t[k] = -a.t[k];
  return o;
}
template <typename T, int N>
__device__ __forceinline__ Dual<T, N> operator*(const Dual<T, N>& a, const Dual<T, N>& b) {
  Dual<T, N> o;
  o.v = a.v * b.v;
#pragma unroll
  for (int k = 0; k < N; ++k) o.t[k] = a.t[k] * b.v + a.v * b.t[k];
  return o;
}
template <typename T, int N>
__device__ __forceinline__ Dual<T, N> operator*(T c, const Dual<T, N>& a) {
  Dual<T, N> o;
  o.v = c * a.v;
#pragma unroll
  for (int k = 0; k < N; ++k) o.t[k] = c * a.t[k];
  return o;
}
template <typename T, int N>
__device__ __forceinline__ Dual<T, N> quot(const Dual<T, N>& a, const Dual<T, N>& b) {
  Dual<T, N> o;
  o.v = a.v / b.v;
#pragma unroll
  for (int k = 0; k < N; ++k) o.t[k] = (a.t[k] - o.v * b.t[k]) / b.v;
  return o;
}
template <typename T, int N>
__device__ __forceinline__ Dual<T, N> quot(const Dual<T, N>& a, T c) {
  Dual<T, N> o;
  o.v = a.v / c;
#pragma unroll
  for (int k = 0; k < N; ++k) o.t[k] = a.t[k] / c;
  return o;
}
template <typename T>
__device__ __forceinline__ T quot(T a, T b) {
  return a / b;
}
template <typename T, int N>
__device__ __forceinline__ Dual<T, N> dsin(const Dual<T, N>& a) {
  Dual<T, N> o;
  o.v = sin(a.v);
  const T c = cos(a.v);
#pragma unroll
  for (int k = 0; k < N; ++k) o.t[k] = c * a.t[k];
  return o;
}
template <typename T, int N>
__device__ __forceinline__ Dual<T, N> dcos(const Dual<T, N>& a) {
  Dual<T, N> o;
  o.v = cos(a.v);
  const T ns = -sin(a.v);
#pragma unroll
  for (int k = 0; k < N; ++k) o.t[k] = ns * a.t[k];
  return o;
}
template <typename T>
__device__ __forceinline__ T dsin(T a) {
  return sin(a);
}
template <typename T>
__device__ __forceinline__ T dcos(T a) {
  return cos(a);
}

// ---------------------------------------------------------------------------
// Plants: the continuous dynamics over values of type S (T or Dual<T, N>),
// each a line-by-line counterpart of the plain version's xdot.
// ---------------------------------------------------------------------------

struct CartPole {
  static constexpr int NX = 4;
  static constexpr int NU = 1;
  double mass_cart, mass_pole, length, gravity;

  template <typename T, typename S>
  __device__ __forceinline__ void xdot(const S (&x)[NX], const S (&u)[NU], S (&out)[NX]) const {
    const S s = dsin(x[2]);
    const S c = dcos(x[2]);
    const S denom = T(mass_cart) + T(mass_pole) * s * s;
    const S a = quot(u[0] + T(mass_pole) * s * (T(length) * x[3] * x[3] - T(gravity) * c), denom);
    out[0] = x[1];
    out[1] = a;
    out[2] = x[3];
    out[3] = quot(T(gravity) * s - a * c, T(length));
  }
};

struct Quadrotor {
  static constexpr int NX = 6;
  static constexpr int NU = 2;
  double mass, inertia, arm, gravity;

  template <typename T, typename S>
  __device__ __forceinline__ void xdot(const S (&x)[NX], const S (&u)[NU], S (&out)[NX]) const {
    const S s = dsin(x[2]);
    const S c = dcos(x[2]);
    const S thrust = quot(u[0] + u[1], T(mass));
    out[0] = x[3];
    out[1] = x[4];
    out[2] = x[5];
    out[3] = (-thrust) * s;
    out[4] = thrust * c - T(gravity);
    out[5] = T(arm / inertia) * (u[0] - u[1]);
  }
};

// One RK4 step over values of type S.
template <typename T, class P, typename S>
__device__ __forceinline__ void rk4(const P& plant, const Cost& cs, const S (&x)[P::NX],
                                    const S (&u)[P::NU], S (&out)[P::NX]) {
  constexpr int NX = P::NX;
  const T hdt = T(cs.hdt), dt = T(cs.dt), dt6 = T(cs.dt6);
  S k1[NX], k2[NX], k3[NX], k4[NX], tmp[NX];
  plant.template xdot<T>(x, u, k1);
#pragma unroll
  for (int i = 0; i < NX; ++i) tmp[i] = x[i] + hdt * k1[i];
  plant.template xdot<T>(tmp, u, k2);
#pragma unroll
  for (int i = 0; i < NX; ++i) tmp[i] = x[i] + hdt * k2[i];
  plant.template xdot<T>(tmp, u, k3);
#pragma unroll
  for (int i = 0; i < NX; ++i) tmp[i] = x[i] + dt * k3[i];
  plant.template xdot<T>(tmp, u, k4);
#pragma unroll
  for (int i = 0; i < NX; ++i) out[i] = x[i] + dt6 * (k1[i] + T(2.0) * k2[i] + T(2.0) * k3[i] + k4[i]);
}

// ---------------------------------------------------------------------------
// The lane's scratch column.
// ---------------------------------------------------------------------------

// Scratch rows of one lane at horizon T: four trajectories of dim = T (nu +
// nx) (the iterate, the best iterate, the line search's blend and its
// candidate), the stage Jacobians A_t (nx x nx; A_0 zero) and B_t, the
// defects r and cost gradients, the Riccati factors (F's L and d, K,
// V_{t+1}), and the interior point's per-input and per-state arrays.
struct Layout {
  int cur, best, blend, cand;
  int A, Bm, r, cu, cx;
  int L, d, K, Vn;
  int rdiag, ib_lo, ib_hi, du, s_lo, s_hi, z_lo, z_hi, r_d_u, r_pi_lo, r_pi_hi, r_c_lo, r_c_hi,
      sig_lo, sig_hi, r_aug, ddu, ds_lo, ds_hi, dz_lo, dz_hi, dsl_a, dsh_a, dzl_a, dzh_a, ks;
  int dxs, y, r_d_x, r_pe, ddx, ddy, vnext;
  int total;
  __host__ __device__ static int take(int& o, int n) {
    const int at = o;
    o += n;
    return at;
  }
  __host__ __device__ Layout(int T, int nx, int nu) {
    const int dim = T * (nu + nx), tu = T * nu, tx = T * nx;
    int o = 0;
    cur = take(o, dim);
    best = take(o, dim);
    blend = take(o, dim);
    cand = take(o, dim);
    A = take(o, tx * nx);
    Bm = take(o, tx * nu);
    r = take(o, tx);
    cu = take(o, tu);
    cx = take(o, tx);
    L = take(o, tu * nu);
    d = take(o, tu);
    K = take(o, tu * nx);
    Vn = take(o, tx * nx);
    int* per_u[] = {&rdiag, &ib_lo, &ib_hi, &du, &s_lo, &s_hi, &z_lo, &z_hi, &r_d_u, &r_pi_lo,
                    &r_pi_hi, &r_c_lo, &r_c_hi, &sig_lo, &sig_hi, &r_aug, &ddu, &ds_lo, &ds_hi,
                    &dz_lo, &dz_hi, &dsl_a, &dsh_a, &dzl_a, &dzh_a, &ks};
    for (int* p : per_u) *p = take(o, tu);
    int* per_x[] = {&dxs, &y, &r_d_x, &r_pe, &ddx, &ddy, &vnext};
    for (int* p : per_x) *p = take(o, tx);
    total = o;
  }
};

// One lane's column of a feature-major (rows, B) array.
template <typename P>
struct Col {
  P* p;
  size_t stride;
  __device__ __forceinline__ P& operator[](int row) const {
    return p[static_cast<size_t>(row) * stride];
  }
};

// Everything one lane's solve reads besides its inputs.
template <typename T, class P>
struct Ctx {
  static constexpr int NX = P::NX;
  static constexpr int NU = P::NU;
  P plant;
  Cost cs;
  int T_;
  Col<T> s;
  Layout L;
  // Trajectory slots: u_t[r] and x_{t+1}[i] of the dim-sized block at z.
  __device__ __forceinline__ T& u(int z, int t, int r) const { return s[z + t * NU + r]; }
  __device__ __forceinline__ T& x(int z, int t, int i) const { return s[z + T_ * NU + t * NX + i]; }
  __device__ __forceinline__ T& pu(int off, int t, int r) const { return s[off + t * NU + r]; }
  __device__ __forceinline__ T& px(int off, int t, int i) const { return s[off + t * NX + i]; }
  __device__ __forceinline__ T& Aa(int t, int i, int j) const { return s[L.A + (t * NX + i) * NX + j]; }
  __device__ __forceinline__ T& Ba(int t, int i, int r) const { return s[L.Bm + (t * NX + i) * NU + r]; }
  __device__ __forceinline__ T w2(int t, int i) const { return T(t < T_ - 1 ? cs.w2[i] : cs.w2T[i]); }
  __device__ __forceinline__ T hw2(int t, int i) const { return T(t < T_ - 1 ? cs.hw2[i] : cs.hw2T[i]); }
  __device__ __forceinline__ int dim() const { return T_ * (NU + NX); }
};

template <typename T, class P>
__device__ __forceinline__ void copy_z(const Ctx<T, P>& c, int from, int to) {
#pragma unroll 1
  for (int q = 0; q < c.dim(); ++q) c.s[to + q] = c.s[from + q];
}

// The cost at the trajectory z, its terms in order: per stage the nx
// tracking terms, then the nu effort terms.
template <typename T, class P>
__device__ T cost_at(const Ctx<T, P>& c, int z) {
  T f = T(0);
#pragma unroll 1
  for (int t = 0; t < c.T_; ++t) {
#pragma unroll
    for (int i = 0; i < P::NX; ++i) {
      const T rr = c.x(z, t, i) - T(c.cs.goal[i]);
      const T term = c.hw2(t, i) * rr * rr;
      f = (t == 0 && i == 0) ? term : f + term;
    }
#pragma unroll
    for (int r = 0; r < P::NU; ++r) {
      const T du = c.u(z, t, r) - T(c.cs.u_ref[r]);
      f = f + T(c.cs.hr_u[r]) * du * du;
    }
  }
  return f;
}

// |eq|_1 of the defects at the trajectory z from the plant state x0.
template <typename T, class P>
__device__ T defects_at(const Ctx<T, P>& c, const T (&x0)[P::NX], int z) {
  T eq = T(0);
#pragma unroll 1
  for (int t = 0; t < c.T_; ++t) {
    T xin[P::NX], uu[P::NU], pred[P::NX];
#pragma unroll
    for (int i = 0; i < P::NX; ++i) xin[i] = t == 0 ? x0[i] : c.x(z, t - 1, i);
#pragma unroll
    for (int r = 0; r < P::NU; ++r) uu[r] = c.u(z, t, r);
    rk4<T>(c.plant, c.cs, xin, uu, pred);
#pragma unroll
    for (int i = 0; i < P::NX; ++i) {
      const T d = fabs(c.x(z, t, i) - pred[i]);
      eq = (t == 0 && i == 0) ? d : eq + d;
    }
  }
  return eq;
}

// ---------------------------------------------------------------------------
// Register Riccati (ops/mpc.py::_riccati_factor / _riccati_solve).
// ---------------------------------------------------------------------------

// Backward V/K/F recursion with R = the rdiag slot and Q_t = w2 + lam.
// Stores F's LDL^T, K and V_{t+1} per stage; returns the bad flag.
template <typename T, class P>
__device__ T riccati_factor(const Ctx<T, P>& c, T lam) {
  constexpr int NX = P::NX, NU = P::NU;
  const int Tn = c.T_;
  T V[NX][NX];
#pragma unroll
  for (int i = 0; i < NX; ++i)
#pragma unroll
    for (int j = 0; j < NX; ++j) V[i][j] = i == j ? c.w2(Tn - 1, i) + lam : T(0);
  T bad = T(0);
#pragma unroll 1
  for (int t = Tn - 1; t >= 0; --t) {
    T At[NX][NX], Bt[NX][NU];
#pragma unroll
    for (int i = 0; i < NX; ++i) {
#pragma unroll
      for (int j = 0; j < NX; ++j) At[i][j] = c.Aa(t, i, j);
#pragma unroll
      for (int r = 0; r < NU; ++r) Bt[i][r] = c.Ba(t, i, r);
    }
    T VB[NX][NU];
#pragma unroll
    for (int i = 0; i < NX; ++i)
#pragma unroll
      for (int j = 0; j < NU; ++j) {
        T acc = T(0);
#pragma unroll
        for (int k = 0; k < NX; ++k) acc = acc + V[i][k] * Bt[k][j];
        VB[i][j] = acc;
      }
    T F[NU][NU];
#pragma unroll
    for (int i = 0; i < NU; ++i)
#pragma unroll
      for (int j = 0; j < NU; ++j) {
        T acc = T(0);
#pragma unroll
        for (int k = 0; k < NX; ++k) acc = acc + Bt[k][i] * VB[k][j];
        F[i][j] = (i == j ? c.pu(c.L.rdiag, t, i) : T(0)) + acc;
      }
    T Lf[NU][NU], df[NU];
    mo::ldlt_factor<T, NU>(F, Lf, df);
    bad = mo::nmax(bad, mo::ldlt_bad<T, NU>(df));
    T K[NU][NX];
#pragma unroll
    for (int j = 0; j < NX; ++j) {
      T col[NU];
#pragma unroll
      for (int i = 0; i < NU; ++i) {
        T acc = T(0);
#pragma unroll
        for (int k = 0; k < NX; ++k) acc = acc + VB[k][i] * At[k][j];
        col[i] = acc;
      }
      mo::ldlt_apply<T, NU>(Lf, df, col);
#pragma unroll
      for (int i = 0; i < NU; ++i) K[i][j] = col[i];
    }
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      c.s[c.L.d + t * NU + i] = df[i];
#pragma unroll
      for (int j = 0; j < NU; ++j) c.s[c.L.L + (t * NU + i) * NU + j] = i > j ? Lf[i][j] : T(0);
#pragma unroll
      for (int j = 0; j < NX; ++j) c.s[c.L.K + (t * NU + i) * NX + j] = K[i][j];
    }
#pragma unroll
    for (int i = 0; i < NX; ++i)
#pragma unroll
      for (int j = 0; j < NX; ++j) c.s[c.L.Vn + (t * NX + i) * NX + j] = V[i][j];
    if (t > 0) {
      T M[NX][NX];
#pragma unroll
      for (int i = 0; i < NX; ++i)
#pragma unroll
        for (int j = 0; j < NX; ++j) {
          T s1 = T(0), s2 = T(0);
#pragma unroll
          for (int k = 0; k < NX; ++k) s1 = s1 + V[i][k] * At[k][j];
#pragma unroll
          for (int r = 0; r < NU; ++r) s2 = s2 + VB[i][r] * K[r][j];
          M[i][j] = s1 - s2;
        }
      T Vt[NX][NX];
#pragma unroll
      for (int i = 0; i < NX; ++i)
#pragma unroll
        for (int j = 0; j < NX; ++j) {
          T acc = T(0);
#pragma unroll
          for (int k = 0; k < NX; ++k) acc = acc + At[k][i] * M[k][j];
          Vt[i][j] = (i == j ? c.w2(t - 1, i) + lam : T(0)) + acc;
        }
#pragma unroll
      for (int i = 0; i < NX; ++i)
#pragma unroll
        for (int j = 0; j < NX; ++j) V[i][j] = T(0.5) * (Vt[i][j] + Vt[j][i]);
    }
  }
  return bad;
}

template <typename T, int NU>
__device__ __forceinline__ void load_ldlt(const Col<T>& s, int Loff, int doff, int t, T (&Lf)[NU][NU],
                                          T (&df)[NU]) {
#pragma unroll
  for (int i = 0; i < NU; ++i) {
    df[i] = s[doff + t * NU + i];
#pragma unroll
    for (int j = 0; j < NU; ++j) Lf[i][j] = s[Loff + (t * NU + i) * NU + j];
  }
}

// Backward (v, k) and forward (du, dx, dy) sweeps. The right-hand sides
// are the negated slots su (u rows), sx (x_{t+1} rows) and se (equality
// rows); results go to the slots ou, ox, oy.
template <typename T, class P>
__device__ void riccati_solve(const Ctx<T, P>& c, int su, int sx, int se, int ou, int ox, int oy) {
  constexpr int NX = P::NX, NU = P::NU;
  const int Tn = c.T_;
  T v[NX];
#pragma unroll
  for (int i = 0; i < NX; ++i) v[i] = -(-c.px(sx, Tn - 1, i));
#pragma unroll 1
  for (int t = Tn - 1; t >= 0; --t) {
    T V1[NX][NX], b2[NX];
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      b2[i] = -c.px(se, t, i);
      c.px(c.L.vnext, t, i) = v[i];
#pragma unroll
      for (int j = 0; j < NX; ++j) V1[i][j] = c.s[c.L.Vn + (t * NX + i) * NX + j];
    }
    T tmp[NX];
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      T acc = T(0);
#pragma unroll
      for (int j = 0; j < NX; ++j) acc = acc + V1[i][j] * b2[j];
      tmp[i] = acc + v[i];
    }
    T k[NU];
#pragma unroll
    for (int r = 0; r < NU; ++r) {
      T acc = T(0);
#pragma unroll
      for (int i = 0; i < NX; ++i) acc = acc + c.Ba(t, i, r) * tmp[i];
      k[r] = -c.pu(su, t, r) - acc;
    }
    T Lf[NU][NU], df[NU];
    load_ldlt<T, NU>(c.s, c.L.L, c.L.d, t, Lf, df);
    mo::ldlt_apply<T, NU>(Lf, df, k);
#pragma unroll
    for (int r = 0; r < NU; ++r) c.pu(c.L.ks, t, r) = k[r];
    if (t > 0) {
      T inner[NX];
#pragma unroll
      for (int j = 0; j < NX; ++j) {
        T acc = T(0);
#pragma unroll
        for (int r = 0; r < NU; ++r) acc = acc + c.Ba(t, j, r) * k[r];
        inner[j] = acc + b2[j];
      }
      T w[NX];
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        T acc = T(0);
#pragma unroll
        for (int j = 0; j < NX; ++j) acc = acc + V1[i][j] * inner[j];
        w[i] = acc + v[i];
      }
#pragma unroll
      for (int j = 0; j < NX; ++j) {
        T acc = T(0);
#pragma unroll
        for (int i = 0; i < NX; ++i) acc = acc + c.Aa(t, i, j) * w[i];
        v[j] = acc - (-c.px(sx, t - 1, j));
      }
    }
  }
  T dx[NX];
#pragma unroll
  for (int i = 0; i < NX; ++i) dx[i] = T(0);
#pragma unroll 1
  for (int t = 0; t < Tn; ++t) {
    T du[NU];
#pragma unroll
    for (int r = 0; r < NU; ++r) {
      T acc = T(0);
#pragma unroll
      for (int j = 0; j < NX; ++j) acc = acc + c.s[c.L.K + (t * NU + r) * NX + j] * dx[j];
      du[r] = -acc + c.pu(c.L.ks, t, r);
      c.pu(ou, t, r) = du[r];
    }
    T dxn[NX];
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      T sa = T(0), sb = T(0);
#pragma unroll
      for (int j = 0; j < NX; ++j) sa = sa + c.Aa(t, i, j) * dx[j];
#pragma unroll
      for (int r = 0; r < NU; ++r) sb = sb + c.Ba(t, i, r) * du[r];
      dxn[i] = sa + sb + -c.px(se, t, i);
    }
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      T acc = T(0);
#pragma unroll
      for (int j = 0; j < NX; ++j) acc = acc + c.s[c.L.Vn + (t * NX + i) * NX + j] * dxn[j];
      c.px(oy, t, i) = acc + c.px(c.L.vnext, t, i);
      c.px(ox, t, i) = dxn[i];
      dx[i] = dxn[i];
    }
  }
}

// ---------------------------------------------------------------------------
// The interior point (the JAX kernel's qp_solve).
// ---------------------------------------------------------------------------

// The largest step in (0, 1] keeping the slots v + alpha dv positive: the
// (v_lo, dv_lo) pairs in stage order, then the (v_hi, dv_hi) pairs.
template <typename T, class P>
__device__ T ftb(const Ctx<T, P>& c, int v_lo, int dv_lo, int v_hi, int dv_hi, double tau) {
  T alpha = T(1);
  const int n = c.T_ * P::NU;
  for (int side = 0; side < 2; ++side) {
    const int vo = side == 0 ? v_lo : v_hi, dvo = side == 0 ? dv_lo : dv_hi;
#pragma unroll 1
    for (int q = 0; q < n; ++q) {
      const T v = c.s[vo + q], dv = c.s[dvo + q];
      const bool blocking = (v + dv <= T(0)) && (fabs(dv) > T(0));
      alpha = mo::nmin(alpha, blocking ? (T(-tau) * v) / dv : T(1));
    }
  }
  return alpha;
}

// One Newton solve of the condensed system at barrier mu_v with the
// corrector terms corr_lo/corr_hi (0 for the affine step; the slots cl, ch
// otherwise). Writes ddu, ddx, ddy, ds_lo, ds_hi, dz_lo, dz_hi.
template <typename T, class P>
__device__ void solve_step(const Ctx<T, P>& c, T mu_v, bool corr, int ds_lo, int ds_hi, int dz_lo,
                           int dz_hi) {
  const auto& L = c.L;
  const int n = c.T_ * P::NU;
#pragma unroll 1
  for (int q = 0; q < n; ++q) {
    const T cl = corr ? c.s[L.dsl_a + q] * c.s[L.dzl_a + q] : T(0);
    const T ch = corr ? c.s[L.dsh_a + q] * c.s[L.dzh_a + q] : T(0);
    const T c_lo = (c.s[L.r_c_lo + q] + cl - mu_v) / c.s[L.s_lo + q];
    const T c_hi = (c.s[L.r_c_hi + q] + ch - mu_v) / c.s[L.s_hi + q];
    c.s[L.r_aug + q] = c.s[L.r_d_u + q] + c.s[L.sig_lo + q] * c.s[L.r_pi_lo + q] + c_lo -
                       c.s[L.sig_hi + q] * c.s[L.r_pi_hi + q] - c_hi;
  }
  riccati_solve(c, L.r_aug, L.r_d_x, L.r_pe, L.ddu, L.ddx, L.ddy);
#pragma unroll 1
  for (int q = 0; q < n; ++q) {
    const T cl = corr ? c.s[L.dsl_a + q] * c.s[L.dzl_a + q] : T(0);
    const T ch = corr ? c.s[L.dsh_a + q] * c.s[L.dzh_a + q] : T(0);
    const T c_lo = (c.s[L.r_c_lo + q] + cl - mu_v) / c.s[L.s_lo + q];
    const T c_hi = (c.s[L.r_c_hi + q] + ch - mu_v) / c.s[L.s_hi + q];
    const T ddu = c.s[L.ddu + q];
    const T dsl = ddu + c.s[L.r_pi_lo + q];
    const T dsh = -ddu + c.s[L.r_pi_hi + q];
    c.s[ds_lo + q] = dsl;
    c.s[ds_hi + q] = dsh;
    c.s[dz_lo + q] = (-c.s[L.sig_lo + q]) * dsl - c_lo;
    c.s[dz_hi + q] = (-c.s[L.sig_hi + q]) * dsh - c_hi;
  }
}

// The interior point on the stage-structured condensed system at the
// iterate z. Writes the step into du and dxs; returns y_abs_max and the bad
// flag.
template <typename T, class P>
__device__ void qp_solve(const Ctx<T, P>& c, int z, T lam, int qp_iterations, T& y_abs, T& bad) {
  constexpr int NX = P::NX, NU = P::NU;
  const auto& L = c.L;
  const int Tn = c.T_;
  const int n = Tn * NU;
  const T ncon = T(2 * Tn * NU);
  T Rb[NU];
#pragma unroll
  for (int r = 0; r < NU; ++r) Rb[r] = T(c.cs.r_u[r]) + lam;

  // Equality-constrained initial guess (Sigma = 0).
#pragma unroll 1
  for (int t = 0; t < Tn; ++t)
#pragma unroll
    for (int r = 0; r < NU; ++r) c.pu(L.rdiag, t, r) = Rb[r];
  bad = riccati_factor(c, lam);
  riccati_solve(c, L.cu, L.cx, L.r, L.du, L.dxs, L.y);
  // Clamp into the shifted bounds; slack and dual init (qp.cc:470-481).
#pragma unroll 1
  for (int t = 0; t < Tn; ++t)
#pragma unroll
    for (int r = 0; r < NU; ++r) {
      const T ib_lo = c.u(z, t, r) - T(c.cs.u_min[r]);
      const T ib_hi = T(c.cs.u_max[r]) - c.u(z, t, r);
      const T du = mo::nmin(mo::nmax(c.pu(L.du, t, r), -ib_lo), ib_hi);
      const T s_lo = mo::nmax(du + ib_lo, T(1e-9));
      const T s_hi = mo::nmax(-du + ib_hi, T(1e-9));
      c.pu(L.ib_lo, t, r) = ib_lo;
      c.pu(L.ib_hi, t, r) = ib_hi;
      c.pu(L.du, t, r) = du;
      c.pu(L.s_lo, t, r) = s_lo;
      c.pu(L.s_hi, t, r) = s_hi;
      c.pu(L.z_lo, t, r) = T(1) / s_lo;
      c.pu(L.z_hi, t, r) = T(1) / s_hi;
    }
  T mu = T(1);
#pragma unroll 1
  for (int it = 0; it < qp_iterations; ++it) {
    // KKT residuals (qp.cc:391-420) per stage.
#pragma unroll 1
    for (int t = 0; t < Tn; ++t) {
#pragma unroll
      for (int r = 0; r < NU; ++r) {
        T acc = T(0);
#pragma unroll
        for (int i = 0; i < NX; ++i) acc = acc + c.Ba(t, i, r) * c.px(L.y, t, i);
        const T du = c.pu(L.du, t, r), s_lo = c.pu(L.s_lo, t, r), s_hi = c.pu(L.s_hi, t, r);
        const T z_lo = c.pu(L.z_lo, t, r), z_hi = c.pu(L.z_hi, t, r);
        c.pu(L.r_d_u, t, r) = c.pu(L.cu, t, r) + Rb[r] * du + acc - z_lo + z_hi;
        c.pu(L.r_pi_lo, t, r) = du + c.pu(L.ib_lo, t, r) - s_lo;
        c.pu(L.r_pi_hi, t, r) = -du + c.pu(L.ib_hi, t, r) - s_hi;
        c.pu(L.r_c_lo, t, r) = s_lo * z_lo;
        c.pu(L.r_c_hi, t, r) = s_hi * z_hi;
        const T sig_lo = z_lo / s_lo, sig_hi = z_hi / s_hi;
        c.pu(L.sig_lo, t, r) = sig_lo;
        c.pu(L.sig_hi, t, r) = sig_hi;
        c.pu(L.rdiag, t, r) = Rb[r] + sig_lo + sig_hi;
      }
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        T nxt = T(0);
        if (t + 1 < Tn) {
#pragma unroll
          for (int k = 0; k < NX; ++k) nxt = nxt + c.Aa(t + 1, k, i) * c.px(L.y, t + 1, k);
        }
        const T Q = c.w2(t, i) + lam;
        c.px(L.r_d_x, t, i) = Q * c.px(L.dxs, t, i) + c.px(L.cx, t, i) - c.px(L.y, t, i) + nxt;
        T sa = T(0), sb = T(0);
        if (t > 0) {
#pragma unroll
          for (int j = 0; j < NX; ++j) sa = sa + c.Aa(t, i, j) * c.px(L.dxs, t - 1, j);
        }
#pragma unroll
        for (int r = 0; r < NU; ++r) sb = sb + c.Ba(t, i, r) * c.pu(L.du, t, r);
        c.px(L.r_pe, t, i) = c.px(L.r, t, i) - sa - sb + c.px(L.dxs, t, i);
      }
    }
    bad = mo::nmax(bad, riccati_factor(c, lam));

    // Mehrotra predictor-corrector (algorithm 16.4 / qp.cc:170-188).
    solve_step(c, T(0), false, L.dsl_a, L.dsh_a, L.dzl_a, L.dzh_a);
    const T ap_a = ftb(c, L.s_lo, L.dsl_a, L.s_hi, L.dsh_a, 1.0);
    const T ad_a = ftb(c, L.z_lo, L.dzl_a, L.z_hi, L.dzh_a, 1.0);
    // The reference's mu_aff form (qp.cc:519-537): the carried mu stands in
    // for s^T z / M.
    T cross = T(0);
#pragma unroll 1
    for (int q = 0; q < n; ++q) {
      const T dsl = c.s[L.dsl_a + q], dsh = c.s[L.dsh_a + q];
      const T dzl = c.s[L.dzl_a + q], dzh = c.s[L.dzh_a + q];
      cross = cross + (ad_a * c.s[L.s_lo + q] * dzl + ap_a * c.s[L.z_lo + q] * dsl + ap_a * ad_a * dsl * dzl);
      cross = cross + (ad_a * c.s[L.s_hi + q] * dzh + ap_a * c.s[L.z_hi + q] * dsh + ap_a * ad_a * dsh * dzh);
    }
    const T mu_aff = mo::nmax(mu + cross / ncon, T(0));
    const T ratio = mu_aff / mu;
    const T sigma = ratio * (ratio * ratio);
    solve_step(c, sigma * mu, true, L.ds_lo, L.ds_hi, L.dz_lo, L.dz_hi);

    const T ap = ftb(c, L.s_lo, L.ds_lo, L.s_hi, L.ds_hi, kTauFtb);
    const T ad = ftb(c, L.z_lo, L.dz_lo, L.z_hi, L.dz_hi, kTauFtb);
    T comp = T(0);
#pragma unroll 1
    for (int q = 0; q < n; ++q) {
      c.s[L.du + q] = c.s[L.du + q] + ap * c.s[L.ddu + q];
      const T s_lo = c.s[L.s_lo + q] + ap * c.s[L.ds_lo + q];
      const T s_hi = c.s[L.s_hi + q] + ap * c.s[L.ds_hi + q];
      const T z_lo = c.s[L.z_lo + q] + ad * c.s[L.dz_lo + q];
      const T z_hi = c.s[L.z_hi + q] + ad * c.s[L.dz_hi + q];
      c.s[L.s_lo + q] = s_lo;
      c.s[L.s_hi + q] = s_hi;
      c.s[L.z_lo + q] = z_lo;
      c.s[L.z_hi + q] = z_hi;
      comp = comp + s_lo * z_lo + s_hi * z_hi;
    }
#pragma unroll 1
    for (int q = 0; q < Tn * NX; ++q) {
      c.s[L.dxs + q] = c.s[L.dxs + q] + ap * c.s[L.ddx + q];
      c.s[L.y + q] = c.s[L.y + q] + ad * c.s[L.ddy + q];
    }
    mu = T(0.1) * (comp / ncon);
  }

  y_abs = fabs(c.px(L.y, 0, 0));
  bool fin = isfinite(c.pu(L.du, 0, 0));
#pragma unroll 1
  for (int q = 0; q < Tn * NX; ++q) {
    y_abs = mo::nmax(y_abs, T(fabs(c.s[L.y + q])));
    fin = fin && isfinite(c.s[L.dxs + q]);
  }
#pragma unroll 1
  for (int q = 0; q < n; ++q) fin = fin && isfinite(c.s[L.du + q]);
  bad = mo::nmax(bad, fin ? T(0) : T(1));
}

// ---------------------------------------------------------------------------
// One MPC period (the JAX kernel's core).
// ---------------------------------------------------------------------------

template <typename T>
struct PeriodOut {
  T f, eq, flags;
};

// Solves from the iterate in the `cur` slot and the plant state x0; leaves
// the returned trajectory in the `best` slot. hist, when not null, gets the
// (iters, 7) channels of this lane (column stride hstride).
template <typename T, class P>
__device__ PeriodOut<T> core(const Ctx<T, P>& c, const T (&x0)[P::NX], int max_iterations,
                             int qp_iterations, int ls_iterations, T* hist, size_t hstride) {
  constexpr int NX = P::NX, NU = P::NU, NIN = NX + NU;
  using D = Dual<T, NIN>;
  const auto& L = c.L;
  const int Tn = c.T_;
  const int dim = c.dim();
  const T zero = T(0), one = T(1);

  T lam = T(1e-6) * one, penalty = T(1.0) * one, restore = zero;
  copy_z(c, L.cur, L.best);
  T f_best = T(INFINITY), eq_best = zero, fac_bad = zero, lam_maxed = zero, accepted = zero;
  T f_acc = zero, eq_acc = zero, f_pre = zero, eq_pre = zero;
#pragma unroll 1
  for (int it = 0; it < max_iterations; ++it) {
    // Stagewise linearization (the LinearizeAndFillQP analog).
#pragma unroll 1
    for (int t = 0; t < Tn; ++t) {
#pragma unroll
      for (int r = 0; r < NU; ++r)
        c.pu(L.cu, t, r) = T(c.cs.r_u[r]) * (c.u(L.cur, t, r) - T(c.cs.u_ref[r]));
#pragma unroll
      for (int i = 0; i < NX; ++i) c.px(L.cx, t, i) = c.w2(t, i) * (c.x(L.cur, t, i) - T(c.cs.goal[i]));
      D xin[NX], uin[NU], pred[NX];
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        xin[i].v = t == 0 ? x0[i] : c.x(L.cur, t - 1, i);
#pragma unroll
        for (int k = 0; k < NIN; ++k) xin[i].t[k] = k == i ? one : zero;
      }
#pragma unroll
      for (int r = 0; r < NU; ++r) {
        uin[r].v = c.u(L.cur, t, r);
#pragma unroll
        for (int k = 0; k < NIN; ++k) uin[r].t[k] = k == NX + r ? one : zero;
      }
      rk4<T>(c.plant, c.cs, xin, uin, pred);
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        c.px(L.r, t, i) = c.x(L.cur, t, i) - pred[i].v;
        // Row 0's state coefficient acts on the parameter x_0: A_0 = 0.
#pragma unroll
        for (int j = 0; j < NX; ++j) c.Aa(t, i, j) = t == 0 ? zero : pred[i].t[j];
#pragma unroll
        for (int r = 0; r < NU; ++r) c.Ba(t, i, r) = pred[i].t[NX + r];
      }
    }
    eq_pre = zero;
#pragma unroll 1
    for (int q = 0; q < Tn * NX; ++q) {
      const T d = fabs(c.s[L.r + q]);
      eq_pre = q == 0 ? d : eq_pre + d;
    }
    f_pre = cost_at(c, L.cur);

    if (f_pre + penalty * eq_pre < f_best + penalty * eq_best) {
      copy_z(c, L.cur, L.best);
      f_best = f_pre;
      eq_best = eq_pre;
    }

    T y_abs, bad_it;
    qp_solve(c, L.cur, lam, qp_iterations, y_abs, bad_it);
    fac_bad = mo::nmax(fac_bad, bad_it);

    // Directional derivative and penalty (nonlinear.cc:457-502).
    T d_f = zero, d_eq = zero;
#pragma unroll 1
    for (int t = 0; t < Tn; ++t) {
#pragma unroll
      for (int r = 0; r < NU; ++r) d_f = d_f + c.pu(L.cu, t, r) * c.pu(L.du, t, r);
#pragma unroll
      for (int i = 0; i < NX; ++i) d_f = d_f + c.px(L.cx, t, i) * c.px(L.dxs, t, i);
    }
#pragma unroll 1
    for (int t = 0; t < Tn; ++t)
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        T sa = zero, sb = zero;
        if (t > 0) {
#pragma unroll
          for (int j = 0; j < NX; ++j) sa = sa + c.Aa(t, i, j) * c.px(L.dxs, t - 1, j);
        }
#pragma unroll
        for (int r = 0; r < NU; ++r) sb = sb + c.Ba(t, i, r) * c.pu(L.du, t, r);
        // A_eq row: -A_t dx_t - B_t du_t + dx_{t+1}.
        d_eq = d_eq + mo::sgn(c.px(L.r, t, i)) * (-sa - sb + c.px(L.dxs, t, i));
      }
    penalty = y_abs > penalty ? y_abs * T(1.01) : penalty;
    const T dd = d_f + penalty * d_eq;
    const T merit_pre = f_pre + penalty * eq_pre;

    // Armijo backtracking line search (tau = 0.5).
    T alpha = one;
    accepted = zero;
    copy_z(c, L.cur, L.blend);
    f_acc = f_pre;
    eq_acc = eq_pre;
#pragma unroll 1
    for (int probe = 0; probe <= ls_iterations; ++probe) {
      if (probe > 0) alpha = alpha * T(0.5);
#pragma unroll 1
      for (int t = 0; t < Tn; ++t) {
#pragma unroll
        for (int r = 0; r < NU; ++r) c.u(L.cand, t, r) = c.u(L.cur, t, r) + alpha * c.pu(L.du, t, r);
#pragma unroll
        for (int i = 0; i < NX; ++i) c.x(L.cand, t, i) = c.x(L.cur, t, i) + alpha * c.px(L.dxs, t, i);
      }
      const T f_c = cost_at(c, L.cand);
      const T eq_c = defects_at(c, x0, L.cand);
      const T merit_c = f_c + penalty * eq_c;
      const T ok = (merit_c <= merit_pre + T(1e-4) * alpha * mo::nmin(dd, zero)) ? one : zero;
      const T take = ok * (T(1.0) - accepted);
#pragma unroll 1
      for (int q = 0; q < dim; ++q)
        c.s[L.blend + q] = take * c.s[L.cand + q] + (T(1.0) - take) * c.s[L.blend + q];
      f_acc = take * f_c + (T(1.0) - take) * f_acc;
      eq_acc = take * eq_c + (T(1.0) - take) * eq_acc;
      accepted = mo::nmin(accepted + take, T(1.0));
    }
    if (accepted > zero) copy_z(c, L.blend, L.cur);
    if (hist != nullptr) {
      const T row[7] = {f_pre, eq_pre, penalty, lam, dd, accepted, alpha};
#pragma unroll
      for (int ch = 0; ch < 7; ++ch) hist[static_cast<size_t>(it * 7 + ch) * hstride] = row[ch];
    }
    // Lambda machine at the MPC family constants.
    const T lam_succ = mo::nmax(lam * (restore > zero ? T(0.8) : T(0.1)), T(1e-12));
    const T lam_fail = restore > zero ? lam * T(10.0) : mo::nmax(T(1e-3) * one, lam * T(10.0));
    lam = accepted > zero ? lam_succ : lam_fail;
    restore = accepted > zero ? zero : one;
    lam_maxed = (accepted == zero && lam > T(1.0)) ? one : zero;
  }
  const T f_fin = accepted > zero ? f_acc : f_pre;
  const T eq_fin = accepted > zero ? eq_acc : eq_pre;
  const bool better = f_fin + penalty * eq_fin < f_best + penalty * eq_best;
  if (better) copy_z(c, L.cur, L.best);
  return PeriodOut<T>{better ? f_fin : f_best, better ? eq_fin : eq_best, fac_bad + T(2.0) * lam_maxed};
}

// ---------------------------------------------------------------------------
// The two kernels.
// ---------------------------------------------------------------------------

template <typename T, class P>
__device__ __forceinline__ Ctx<T, P> make_ctx(const P& plant, const Cost& cs, T* scratch, int lane, int B) {
  return Ctx<T, P>{plant, cs, cs.horizon, Col<T>{scratch + lane, static_cast<size_t>(B)},
                   Layout(cs.horizon, P::NX, P::NU)};
}

// Kernel 8: one period per lane; x0 (nx, B), z0 (dim, B) -> z_out (dim, B),
// stat (3, B) = (f, |eq|_1, flags), hist (iters, 7, B) or null.
template <typename T, class P>
__global__ void __launch_bounds__(kBlock)
    mpc_solve_kernel(P plant, Cost cs, const T* __restrict__ x0, const T* __restrict__ z0,
                     T* __restrict__ z_out, T* __restrict__ stat, T* __restrict__ hist,
                     T* __restrict__ scratch, int B, int max_iterations, int qp_iterations,
                     int ls_iterations) {
  const int lane = blockIdx.x * kBlock + threadIdx.x;
  if (lane >= B) return;
  const size_t stride = static_cast<size_t>(B);
  const Ctx<T, P> c = make_ctx<T>(plant, cs, scratch, lane, B);
  T x[P::NX];
#pragma unroll
  for (int i = 0; i < P::NX; ++i) x[i] = x0[i * stride + lane];
  const int dim = c.dim();
#pragma unroll 1
  for (int q = 0; q < dim; ++q) c.s[c.L.cur + q] = z0[q * stride + lane];
  const PeriodOut<T> o =
      core(c, x, max_iterations, qp_iterations, ls_iterations, hist == nullptr ? nullptr : hist + lane, stride);
#pragma unroll 1
  for (int q = 0; q < dim; ++q) z_out[q * stride + lane] = c.s[c.L.best + q];
  stat[lane] = o.f;
  stat[stride + lane] = o.eq;
  stat[2 * stride + lane] = o.flags;
}

// Kernel 9: `periods` x (solve -> apply u_0 -> RK4 plant step -> shift the
// warm start) per lane; x (nx, B), z0 (dim, B) -> x_out, z_out, stats (4, B)
// = (f, |eq|_1 of the last period, sticky flags, max |u_0|).
template <typename T, class P>
__global__ void __launch_bounds__(kBlock)
    mpc_servo_kernel(P plant, Cost cs, const T* __restrict__ x0, const T* __restrict__ z0,
                     T* __restrict__ x_out, T* __restrict__ z_out, T* __restrict__ stats,
                     T* __restrict__ scratch, int B, int periods, int max_iterations, int qp_iterations,
                     int ls_iterations) {
  constexpr int NX = P::NX, NU = P::NU;
  const int lane = blockIdx.x * kBlock + threadIdx.x;
  if (lane >= B) return;
  const size_t stride = static_cast<size_t>(B);
  const Ctx<T, P> c = make_ctx<T>(plant, cs, scratch, lane, B);
  const int Tn = c.T_;
  T x[NX];
#pragma unroll
  for (int i = 0; i < NX; ++i) x[i] = x0[i * stride + lane];
  const int dim = c.dim();
#pragma unroll 1
  for (int q = 0; q < dim; ++q) c.s[c.L.cur + q] = z0[q * stride + lane];
  T maxu = T(0), f = T(0), eq = T(0), flags = T(0);
#pragma unroll 1
  for (int p = 0; p < periods; ++p) {
    const PeriodOut<T> o = core(c, x, max_iterations, qp_iterations, ls_iterations, static_cast<T*>(nullptr), stride);
    T u0[NU], xn[NX];
#pragma unroll
    for (int r = 0; r < NU; ++r) u0[r] = c.u(c.L.best, 0, r);
    rk4<T>(c.plant, c.cs, x, u0, xn);
    // shift_warm_start: u_t <- u_{t+1} (last repeated), x_t <- x_{t+1}, the
    // new terminal state integrated from the last shifted pair.
#pragma unroll 1
    for (int t = 0; t < Tn; ++t) {
      const int from = t + 1 < Tn ? t + 1 : Tn - 1;
#pragma unroll
      for (int r = 0; r < NU; ++r) c.u(c.L.cur, t, r) = c.u(c.L.best, from, r);
    }
#pragma unroll 1
    for (int t = 0; t + 1 < Tn; ++t)
#pragma unroll
      for (int i = 0; i < NX; ++i) c.x(c.L.cur, t, i) = c.x(c.L.best, t + 1, i);
    T xl[NX], ul[NU], xt[NX];
#pragma unroll
    for (int i = 0; i < NX; ++i) xl[i] = c.x(c.L.best, Tn - 1, i);
#pragma unroll
    for (int r = 0; r < NU; ++r) ul[r] = c.u(c.L.best, Tn - 1, r);
    rk4<T>(c.plant, c.cs, xl, ul, xt);
#pragma unroll
    for (int i = 0; i < NX; ++i) c.x(c.L.cur, Tn - 1, i) = xt[i];
#pragma unroll
    for (int r = 0; r < NU; ++r) maxu = mo::nmax(maxu, T(fabs(u0[r])));
    flags = mo::nmax(flags, o.flags);
    f = o.f;
    eq = o.eq;
#pragma unroll
    for (int i = 0; i < NX; ++i) x[i] = xn[i];
  }
#pragma unroll
  for (int i = 0; i < NX; ++i) x_out[i * stride + lane] = x[i];
#pragma unroll 1
  for (int q = 0; q < dim; ++q) z_out[q * stride + lane] = c.s[c.L.cur + q];
  stats[lane] = f;
  stats[stride + lane] = eq;
  stats[2 * stride + lane] = flags;
  stats[3 * stride + lane] = maxu;
}

struct LaunchArgs {
  const void* x0;
  const void* z0;
  void* x_out;  // servo only
  void* z_out;
  void* stat;
  void* hist;  // solve only; may be null
  void* scratch;
  int B;
  int periods;  // servo only; < 0 selects the solve kernel
  int max_iterations;
  int qp_iterations;
  int ls_iterations;
  cudaStream_t stream;
};

template <typename T, class P>
int launch(const P& plant, const Cost& cs, const LaunchArgs& a) {
  const int grid = (a.B + kBlock - 1) / kBlock;
  if (a.periods < 0) {
    mpc_solve_kernel<T, P><<<grid, kBlock, 0, a.stream>>>(
        plant, cs, static_cast<const T*>(a.x0), static_cast<const T*>(a.z0), static_cast<T*>(a.z_out),
        static_cast<T*>(a.stat), static_cast<T*>(a.hist), static_cast<T*>(a.scratch), a.B,
        a.max_iterations, a.qp_iterations, a.ls_iterations);
  } else {
    mpc_servo_kernel<T, P><<<grid, kBlock, 0, a.stream>>>(
        plant, cs, static_cast<const T*>(a.x0), static_cast<const T*>(a.z0), static_cast<T*>(a.x_out),
        static_cast<T*>(a.z_out), static_cast<T*>(a.stat), static_cast<T*>(a.scratch), a.B, a.periods,
        a.max_iterations, a.qp_iterations, a.ls_iterations);
  }
  return static_cast<int>(cudaGetLastError());
}

// plant: 0 cart-pole (consts mass_cart, mass_pole, length, gravity),
// 1 quadrotor (mass, inertia, arm, gravity).
template <typename T>
int dispatch_plant(int plant, const double* consts, const Cost& cs, const LaunchArgs& a) {
  switch (plant) {
    case 0: return launch<T>(CartPole{consts[0], consts[1], consts[2], consts[3]}, cs, a);
    case 1: return launch<T>(Quadrotor{consts[0], consts[1], consts[2], consts[3]}, cs, a);
    default: return mo::kNoInstance;
  }
}

// The instances of one dtype, each built in its own source file so that the
// two compile in parallel: mpc.cu (float), mpc_f64.cu (double).
int launch_float(int plant, const double* consts, const Cost& cs, const LaunchArgs& a);
int launch_double(int plant, const double* consts, const Cost& cs, const LaunchArgs& a);

}  // namespace mo::mpc
