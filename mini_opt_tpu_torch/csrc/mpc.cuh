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
// What bounds it on this card: one instance's serial chain. An instance
// reads nx + T (nu + nx) scalars and writes as many, but runs some million
// floating-point operations per period at T = 20 (chip_smoke.py counts them
// from the plain version), most of them in loops over the T stages, and its
// stage arrays (about 125 T scalars for the cart-pole: iterates, A_t, B_t,
// the Riccati factors, the interior point's slacks, duals and residuals) do
// not fit registers.
//
// What the design does about it: one warp per instance, W warps per CTA,
// the grid ceil(B / W). The instance's Layout slots are the warp's slab of
// dynamic shared memory (10,000 B for the cart-pole at T = 20 in float32);
// where one slab does not fit a CTA, the launcher passes an instance-major
// global scratch array and the same code runs on it through the same T*
// base pointer. Lane l takes stages t = l, l + 32, ... of every loop whose
// stages are independent: the linearization (one dual-number RK4 step per
// stage), the cost and defect terms, the line search's candidate and blend,
// the interior point's elementwise passes and the servo's warm-start shift.
// The Riccati recursions stay sequential in t; within a stage the nx x nx
// entries of V and M, the columns of K and the rows of the sweeps are spread
// over the lanes, each entry's dot product in the k order of the one-lane
// recursion, and F's nu x nu LDL^T runs on every lane alike. The sweeps'
// stage vectors pass between lanes by shuffle, with no __syncwarp per
// stage; a shuffle orders no memory, so every slot that one lane writes and
// another reads has a __syncwarp between. Scalar sums
// read the per-stage terms back from shared memory in index order on every
// lane, so each lane holds the same scalars and every per-instance decision
// (the lambda machine, the penalty, accept/restore, the best iterate, the
// loop trips) is warp-uniform. The only shuffle tree is max |y|, whose
// result does not depend on the order; ftb's minimum keeps the ordered loop
// (a +-0 candidate makes it order-dependent). Only the plant's nx and nu are
// compile-time (the Plant functor); the horizon T is a run-time loop bound,
// so one build serves every horizon.
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

constexpr int kWarp = 32;
constexpr int kMaxWarps = 8;  // warps (instances) per CTA
constexpr int kMaxSmem = 232448;  // dynamic shared memory one CTA may hold
constexpr unsigned kAll = 0xffffffffu;
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
// The warp's slab.
// ---------------------------------------------------------------------------

// Slots of one instance at horizon T: four trajectories of dim = T (nu +
// nx) (the iterate, the best iterate, the line search's blend and its
// candidate), the stage Jacobians A_t (nx x nx; A_0 zero) and B_t, the
// defects r and cost gradients, the Riccati factors (F's L and d, K,
// V_{t+1}), and the interior point's per-input and per-state arrays. Slots
// that are idle in a phase hold that phase's per-stage terms and the
// Riccati recursions' temporaries (see `wk` below).
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
    // One statement per slot (no pointers to members, which would put the
    // layout on the stack): 26 per-input, then 7 per-state arrays.
    rdiag = take(o, tu);
    ib_lo = take(o, tu);
    ib_hi = take(o, tu);
    du = take(o, tu);
    s_lo = take(o, tu);
    s_hi = take(o, tu);
    z_lo = take(o, tu);
    z_hi = take(o, tu);
    r_d_u = take(o, tu);
    r_pi_lo = take(o, tu);
    r_pi_hi = take(o, tu);
    r_c_lo = take(o, tu);
    r_c_hi = take(o, tu);
    sig_lo = take(o, tu);
    sig_hi = take(o, tu);
    r_aug = take(o, tu);
    ddu = take(o, tu);
    ds_lo = take(o, tu);
    ds_hi = take(o, tu);
    dz_lo = take(o, tu);
    dz_hi = take(o, tu);
    dsl_a = take(o, tu);
    dsh_a = take(o, tu);
    dzl_a = take(o, tu);
    dzh_a = take(o, tu);
    ks = take(o, tu);
    dxs = take(o, tx);
    y = take(o, tx);
    r_d_x = take(o, tx);
    r_pe = take(o, tx);
    ddx = take(o, tx);
    ddy = take(o, tx);
    vnext = take(o, tx);
    total = o;
  }
};

__device__ __forceinline__ void warp_sync() { __syncwarp(kAll); }

// The CTA's dynamic shared memory: W slabs of Layout::total slots.
template <typename T>
__device__ __forceinline__ T* dyn_smem() {
  extern __shared__ __align__(16) unsigned char mo_mpc_smem[];
  return reinterpret_cast<T*>(mo_mpc_smem);
}

// Everything one warp's solve reads besides its inputs. s is the warp's
// slab (shared or global); lane is this thread's lane.
template <typename T, class P>
struct Ctx {
  static constexpr int NX = P::NX;
  static constexpr int NU = P::NU;
  // VB fits the blend and cand blocks (2 dim slots) at T = 1, a stage's
  // cost terms the nx^2 T slots of Vn, every stage row has a lane, and the
  // last lane is free for the stage's stores.
  static_assert(NX * NU <= 2 * (NX + NU) && NX * NX >= NX + NU && NX * NU <= kWarp && NX < kWarp - 1,
                "plant too wide");
  P plant;
  Cost cs;
  int T_;
  T* s;
  Layout L;
  int lane;
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
  for (int q = c.lane; q < c.dim(); q += kWarp) c.s[to + q] = c.s[from + q];
  warp_sync();
}

// Ordered sums of n terms, read on every lane: from the first term (the
// plain version's _seq_sum without a start) or from 0.
template <typename T>
__device__ __forceinline__ T sum_from_first(const T* p, int n) {
  T acc = p[0];
#pragma unroll 4
  for (int q = 1; q < n; ++q) acc = acc + p[q];
  return acc;
}
template <typename T>
__device__ __forceinline__ T sum_from_zero(const T* p, int n) {
  T acc = T(0);
#pragma unroll 4
  for (int q = 0; q < n; ++q) acc = acc + p[q];
  return acc;
}

// Stage t's cost terms at the trajectory z, in the order of the sum: the nx
// tracking terms, then the nu effort terms, at buf + t (nx + nu).
template <typename T, class P>
__device__ __forceinline__ void cost_terms(const Ctx<T, P>& c, int z, int t, T* buf) {
  T* o = buf + t * (P::NX + P::NU);
#pragma unroll
  for (int i = 0; i < P::NX; ++i) {
    const T rr = c.x(z, t, i) - T(c.cs.goal[i]);
    o[i] = c.hw2(t, i) * rr * rr;
  }
#pragma unroll
  for (int r = 0; r < P::NU; ++r) {
    const T du = c.u(z, t, r) - T(c.cs.u_ref[r]);
    o[P::NX + r] = T(c.cs.hr_u[r]) * du * du;
  }
}

// (f, |eq|_1) at the trajectory z from the plant state x0: each lane its
// stages' cost terms (into the idle Vn block) and defect terms (into ddx),
// then both sums from their first term.
template <typename T, class P>
__device__ void errors_at(const Ctx<T, P>& c, const T (&x0)[P::NX], int z, T& f, T& eq) {
  constexpr int NX = P::NX, NU = P::NU;
  T* fb = c.s + c.L.Vn;
  T* eb = c.s + c.L.ddx;
#pragma unroll 1
  for (int t = c.lane; t < c.T_; t += kWarp) {
    cost_terms(c, z, t, fb);
    T xin[NX], uu[NU], pred[NX];
#pragma unroll
    for (int i = 0; i < NX; ++i) xin[i] = t == 0 ? x0[i] : c.x(z, t - 1, i);
#pragma unroll
    for (int r = 0; r < NU; ++r) uu[r] = c.u(z, t, r);
    rk4<T>(c.plant, c.cs, xin, uu, pred);
#pragma unroll
    for (int i = 0; i < NX; ++i) eb[t * NX + i] = fabs(c.x(z, t, i) - pred[i]);
  }
  warp_sync();
  f = sum_from_first(fb, c.dim());
  eq = sum_from_first(eb, c.T_ * NX);
  warp_sync();
}

// ---------------------------------------------------------------------------
// Riccati across the lanes (ops/mpc.py::_riccati_factor / _riccati_solve).
// ---------------------------------------------------------------------------

// Backward V/K/F recursion with R = the rdiag slot and Q_t = w2 + lam.
// Stores F's LDL^T, K and V_{t+1} per stage; returns the bad flag (the same
// on every lane). V_t lives in its Vn block from the stage before; M of
// stage t is formed in the block of V_{t-1}, which it then becomes.
template <typename T, class P>
__device__ T riccati_factor(const Ctx<T, P>& c, T lam) {
  constexpr int NX = P::NX, NU = P::NU, NE = NX * NX;
  constexpr int PER = (NE + kWarp - 1) / kWarp;  // V / M entries per lane
  const auto& L = c.L;
  const int Tn = c.T_;
  T* vb = c.s + L.blend;  // VB: the blend block, idle while a recursion runs
#pragma unroll
  for (int p = 0; p < PER; ++p) {
    const int e = c.lane + p * kWarp;
    if (e < NE) {
      const int i = e / NX, j = e % NX;
      c.s[L.Vn + (Tn - 1) * NE + e] = i == j ? c.w2(Tn - 1, i) + lam : T(0);
    }
  }
  warp_sync();
  T bad = T(0);
#pragma unroll 1
  for (int t = Tn - 1; t >= 0; --t) {
    const T* V = c.s + L.Vn + t * NE;
    // VB = V B_t, an entry per lane.
    if (c.lane < NX * NU) {
      const int i = c.lane / NU, j = c.lane % NU;
      T acc = T(0);
#pragma unroll
      for (int k = 0; k < NX; ++k) acc = acc + V[i * NX + k] * c.Ba(t, k, j);
      vb[c.lane] = acc;
    }
    warp_sync();
    // F = R + B^T V B and its LDL^T on every lane; K's column j on lane j.
    T F[NU][NU];
#pragma unroll
    for (int i = 0; i < NU; ++i)
#pragma unroll
      for (int j = 0; j < NU; ++j) {
        T acc = T(0);
#pragma unroll
        for (int k = 0; k < NX; ++k) acc = acc + c.Ba(t, k, i) * vb[k * NU + j];
        F[i][j] = (i == j ? c.pu(L.rdiag, t, i) : T(0)) + acc;
      }
    T Lf[NU][NU], df[NU];
    mo::ldlt_factor<T, NU>(F, Lf, df);
    bad = mo::nmax(bad, mo::ldlt_bad<T, NU>(df));
    if (c.lane < NX) {
      const int j = c.lane;
      T col[NU];
#pragma unroll
      for (int i = 0; i < NU; ++i) {
        T acc = T(0);
#pragma unroll
        for (int k = 0; k < NX; ++k) acc = acc + vb[k * NU + i] * c.Aa(t, k, j);
        col[i] = acc;
      }
      mo::ldlt_apply<T, NU>(Lf, df, col);
#pragma unroll
      for (int i = 0; i < NU; ++i) c.s[L.K + (t * NU + i) * NX + j] = col[i];
    } else if (c.lane == kWarp - 1) {
#pragma unroll
      for (int i = 0; i < NU; ++i) {
        c.s[L.d + t * NU + i] = df[i];
#pragma unroll
        for (int j = 0; j < NU; ++j) c.s[L.L + (t * NU + i) * NU + j] = i > j ? Lf[i][j] : T(0);
      }
    }
    warp_sync();
    if (t > 0) {
      T* Vp = c.s + L.Vn + (t - 1) * NE;
      const T* Kt = c.s + L.K + t * NU * NX;
      // M = V A_t - VB K, an entry per lane (two where nx^2 > 32).
#pragma unroll
      for (int p = 0; p < PER; ++p) {
        const int e = c.lane + p * kWarp;
        if (e < NE) {
          const int i = e / NX, j = e % NX;
          T s1 = T(0), s2 = T(0);
#pragma unroll
          for (int k = 0; k < NX; ++k) s1 = s1 + V[i * NX + k] * c.Aa(t, k, j);
#pragma unroll
          for (int r = 0; r < NU; ++r) s2 = s2 + vb[i * NU + r] * Kt[r * NX + j];
          Vp[e] = s1 - s2;
        }
      }
      warp_sync();
      // V_{t-1} = sym(Q + A^T M): each lane forms both Vt[i][j] and
      // Vt[j][i] (the bits of the lane that owns (j, i)).
      T vnew[PER];
#pragma unroll
      for (int p = 0; p < PER; ++p) {
        const int e = c.lane + p * kWarp;
        if (e < NE) {
          const int i = e / NX, j = e % NX;
          const T dg = i == j ? c.w2(t - 1, i) + lam : T(0);
          T a1 = T(0), a2 = T(0);
#pragma unroll
          for (int k = 0; k < NX; ++k) a1 = a1 + c.Aa(t, k, i) * Vp[k * NX + j];
#pragma unroll
          for (int k = 0; k < NX; ++k) a2 = a2 + c.Aa(t, k, j) * Vp[k * NX + i];
          vnew[p] = T(0.5) * ((dg + a1) + (dg + a2));
        }
      }
      warp_sync();
#pragma unroll
      for (int p = 0; p < PER; ++p) {
        const int e = c.lane + p * kWarp;
        if (e < NE) Vp[e] = vnew[p];
      }
      warp_sync();
    }
  }
  return bad;
}

template <typename T, int NU>
__device__ __forceinline__ void load_ldlt(const T* s, int Loff, int doff, int t, T (&Lf)[NU][NU], T (&df)[NU]) {
#pragma unroll
  for (int i = 0; i < NU; ++i) {
    df[i] = s[doff + t * NU + i];
#pragma unroll
    for (int j = 0; j < NU; ++j) Lf[i][j] = s[Loff + (t * NU + i) * NU + j];
  }
}

// Backward (v, k) and forward (du, dx, dy) sweeps. The right-hand sides
// are the negated slots su (u rows), sx (x_{t+1} rows) and se (equality
// rows); results go to the slots ou, ox, oy. A stage's vectors (tmp, w,
// v_t; dx) have row i on lane i, in a register: the other lanes read them
// by shuffle, so a stage needs no __syncwarp. k and du run on every lane
// alike. v_t is also stored to the vnext block for dy.
template <typename T, class P>
__device__ void riccati_solve(const Ctx<T, P>& c, int su, int sx, int se, int ou, int ox, int oy) {
  constexpr int NX = P::NX, NU = P::NU, NE = NX * NX;
  const auto& L = c.L;
  const int Tn = c.T_;
  const bool row = c.lane < NX;  // this lane holds row i = lane of the stage's vectors
  T v = row ? -(-c.px(sx, Tn - 1, c.lane)) : T(0);
  if (row) c.px(L.vnext, Tn - 1, c.lane) = v;
#pragma unroll 1
  for (int t = Tn - 1; t >= 0; --t) {
    const T* V1 = c.s + L.Vn + t * NE;
    T tmp = T(0);
    if (row) {
      const int i = c.lane;
      T acc = T(0);
#pragma unroll
      for (int j = 0; j < NX; ++j) acc = acc + V1[i * NX + j] * -c.px(se, t, j);
      tmp = acc + v;
    }
    T tmps[NX];
#pragma unroll
    for (int i = 0; i < NX; ++i) tmps[i] = __shfl_sync(kAll, tmp, i);
    T k[NU];
#pragma unroll
    for (int r = 0; r < NU; ++r) {
      T acc = T(0);
#pragma unroll
      for (int i = 0; i < NX; ++i) acc = acc + c.Ba(t, i, r) * tmps[i];
      k[r] = -c.pu(su, t, r) - acc;
    }
    T Lf[NU][NU], df[NU];
    load_ldlt<T, NU>(c.s, L.L, L.d, t, Lf, df);
    mo::ldlt_apply<T, NU>(Lf, df, k);
    if (c.lane == kWarp - 1) {
#pragma unroll
      for (int r = 0; r < NU; ++r) c.pu(L.ks, t, r) = k[r];
    }
    if (t > 0) {
      T w = T(0);
      if (row) {
        const int i = c.lane;
        T acc = T(0);
#pragma unroll
        for (int j = 0; j < NX; ++j) {
          T a2 = T(0);
#pragma unroll
          for (int r = 0; r < NU; ++r) a2 = a2 + c.Ba(t, j, r) * k[r];
          const T inner = a2 + -c.px(se, t, j);
          acc = acc + V1[i * NX + j] * inner;
        }
        w = acc + v;
      }
      T ws[NX];
#pragma unroll
      for (int i = 0; i < NX; ++i) ws[i] = __shfl_sync(kAll, w, i);
      if (row) {
        const int j = c.lane;
        T acc = T(0);
#pragma unroll
        for (int i = 0; i < NX; ++i) acc = acc + c.Aa(t, i, j) * ws[i];
        v = acc - (-c.px(sx, t - 1, j));
        c.px(L.vnext, t - 1, j) = v;
      }
    }
  }
  warp_sync();  // ks and vnext of every stage
  T dx = T(0);  // dx_t[lane], 0 before the first stage
#pragma unroll 1
  for (int t = 0; t < Tn; ++t) {
    T dxs[NX];
#pragma unroll
    for (int j = 0; j < NX; ++j) dxs[j] = __shfl_sync(kAll, dx, j);
    T du[NU];
#pragma unroll
    for (int r = 0; r < NU; ++r) {
      T acc = T(0);
#pragma unroll
      for (int j = 0; j < NX; ++j) acc = acc + c.s[L.K + (t * NU + r) * NX + j] * dxs[j];
      du[r] = -acc + c.pu(L.ks, t, r);
    }
    if (row) {
      const int i = c.lane;
      T sa = T(0), sb = T(0);
#pragma unroll
      for (int j = 0; j < NX; ++j) sa = sa + c.Aa(t, i, j) * dxs[j];
#pragma unroll
      for (int r = 0; r < NU; ++r) sb = sb + c.Ba(t, i, r) * du[r];
      dx = sa + sb + -c.px(se, t, i);
      c.px(ox, t, i) = dx;
    } else if (c.lane == kWarp - 1) {
#pragma unroll
      for (int r = 0; r < NU; ++r) c.pu(ou, t, r) = du[r];
    }
  }
  warp_sync();
  // dy_t = lambda_{t+1} = V_{t+1} dx_{t+1} + v_{t+1}, every stage at once.
#pragma unroll 1
  for (int q = c.lane; q < Tn * NX; q += kWarp) {
    const int t = q / NX, i = q % NX;
    T acc = T(0);
#pragma unroll
    for (int j = 0; j < NX; ++j) acc = acc + c.s[L.Vn + (t * NX + i) * NX + j] * c.px(ox, t, j);
    c.s[oy + q] = acc + c.px(L.vnext, t, i);
  }
  warp_sync();
}

// ---------------------------------------------------------------------------
// The interior point (the JAX kernel's qp_solve).
// ---------------------------------------------------------------------------

template <typename T>
__device__ __forceinline__ T ftb_candidate(T v, T dv, double tau) {
  const bool blocking = (v + dv <= T(0)) && (fabs(dv) > T(0));
  return blocking ? (T(-tau) * v) / dv : T(1);
}

// Two fraction-to-boundary steps at once: the largest alpha in (0, 1]
// keeping v + alpha dv positive over the (v_lo, dv_lo) pairs in stage
// order, then the (v_hi, dv_hi) pairs, for the (a1_*) and the (a2_*)
// slots. The candidates are formed across the lanes into the idle cand and
// blend blocks; the minimum runs in order on every lane.
template <typename T, class P>
__device__ void ftb2(const Ctx<T, P>& c, int a1_vlo, int a1_dlo, int a1_vhi, int a1_dhi, int a2_vlo, int a2_dlo,
                     int a2_vhi, int a2_dhi, double tau, T& a1, T& a2) {
  const int n = c.T_ * P::NU;
  T* b1 = c.s + c.L.cand;
  T* b2 = c.s + c.L.blend;
#pragma unroll 1
  for (int q = c.lane; q < n; q += kWarp) {
    b1[q] = ftb_candidate(c.s[a1_vlo + q], c.s[a1_dlo + q], tau);
    b1[n + q] = ftb_candidate(c.s[a1_vhi + q], c.s[a1_dhi + q], tau);
    b2[q] = ftb_candidate(c.s[a2_vlo + q], c.s[a2_dlo + q], tau);
    b2[n + q] = ftb_candidate(c.s[a2_vhi + q], c.s[a2_dhi + q], tau);
  }
  warp_sync();
  a1 = T(1);
  a2 = T(1);
#pragma unroll 4
  for (int q = 0; q < 2 * n; ++q) {
    a1 = mo::nmin(a1, b1[q]);
    a2 = mo::nmin(a2, b2[q]);
  }
  warp_sync();
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
  for (int q = c.lane; q < n; q += kWarp) {
    const T cl = corr ? c.s[L.dsl_a + q] * c.s[L.dzl_a + q] : T(0);
    const T ch = corr ? c.s[L.dsh_a + q] * c.s[L.dzh_a + q] : T(0);
    const T c_lo = (c.s[L.r_c_lo + q] + cl - mu_v) / c.s[L.s_lo + q];
    const T c_hi = (c.s[L.r_c_hi + q] + ch - mu_v) / c.s[L.s_hi + q];
    c.s[L.r_aug + q] = c.s[L.r_d_u + q] + c.s[L.sig_lo + q] * c.s[L.r_pi_lo + q] + c_lo -
                       c.s[L.sig_hi + q] * c.s[L.r_pi_hi + q] - c_hi;
  }
  warp_sync();
  riccati_solve(c, L.r_aug, L.r_d_x, L.r_pe, L.ddu, L.ddx, L.ddy);
#pragma unroll 1
  for (int q = c.lane; q < n; q += kWarp) {
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
  warp_sync();
}

// The interior point on the stage-structured condensed system at the
// iterate z. Writes the step into du and dxs; returns y_abs_max and the bad
// flag, the same on every lane.
template <typename T, class P>
__device__ void qp_solve(const Ctx<T, P>& c, int z, T lam, int qp_iterations, T& y_abs, T& bad) {
  constexpr int NX = P::NX, NU = P::NU;
  const auto& L = c.L;
  const int Tn = c.T_;
  const int n = Tn * NU, tx = Tn * NX;
  const T ncon = T(2 * Tn * NU);
  T* terms = c.s + L.cand;  // 2n per-row terms of the ordered sums
  T Rb[NU];
#pragma unroll
  for (int r = 0; r < NU; ++r) Rb[r] = T(c.cs.r_u[r]) + lam;

  // Equality-constrained initial guess (Sigma = 0).
#pragma unroll 1
  for (int q = c.lane; q < n; q += kWarp) c.s[L.rdiag + q] = Rb[q % NU];
  warp_sync();
  bad = riccati_factor(c, lam);
  riccati_solve(c, L.cu, L.cx, L.r, L.du, L.dxs, L.y);
  // Clamp into the shifted bounds; slack and dual init (qp.cc:470-481).
#pragma unroll 1
  for (int q = c.lane; q < n; q += kWarp) {
    const int r = q % NU;
    const T ib_lo = c.s[z + q] - T(c.cs.u_min[r]);
    const T ib_hi = T(c.cs.u_max[r]) - c.s[z + q];
    const T du = mo::nmin(mo::nmax(c.s[L.du + q], -ib_lo), ib_hi);
    const T s_lo = mo::nmax(du + ib_lo, T(1e-9));
    const T s_hi = mo::nmax(-du + ib_hi, T(1e-9));
    c.s[L.ib_lo + q] = ib_lo;
    c.s[L.ib_hi + q] = ib_hi;
    c.s[L.du + q] = du;
    c.s[L.s_lo + q] = s_lo;
    c.s[L.s_hi + q] = s_hi;
    c.s[L.z_lo + q] = T(1) / s_lo;
    c.s[L.z_hi + q] = T(1) / s_hi;
  }
  warp_sync();
  T mu = T(1);
#pragma unroll 1
  for (int it = 0; it < qp_iterations; ++it) {
    // KKT residuals (qp.cc:391-420): the u rows, then the x rows.
#pragma unroll 1
    for (int q = c.lane; q < n; q += kWarp) {
      const int t = q / NU, r = q % NU;
      T acc = T(0);
#pragma unroll
      for (int i = 0; i < NX; ++i) acc = acc + c.Ba(t, i, r) * c.px(L.y, t, i);
      const T du = c.s[L.du + q], s_lo = c.s[L.s_lo + q], s_hi = c.s[L.s_hi + q];
      const T z_lo = c.s[L.z_lo + q], z_hi = c.s[L.z_hi + q];
      c.s[L.r_d_u + q] = c.s[L.cu + q] + Rb[r] * du + acc - z_lo + z_hi;
      c.s[L.r_pi_lo + q] = du + c.s[L.ib_lo + q] - s_lo;
      c.s[L.r_pi_hi + q] = -du + c.s[L.ib_hi + q] - s_hi;
      c.s[L.r_c_lo + q] = s_lo * z_lo;
      c.s[L.r_c_hi + q] = s_hi * z_hi;
      const T sig_lo = z_lo / s_lo, sig_hi = z_hi / s_hi;
      c.s[L.sig_lo + q] = sig_lo;
      c.s[L.sig_hi + q] = sig_hi;
      c.s[L.rdiag + q] = Rb[r] + sig_lo + sig_hi;
    }
#pragma unroll 1
    for (int q = c.lane; q < tx; q += kWarp) {
      const int t = q / NX, i = q % NX;
      T nxt = T(0);
      if (t + 1 < Tn) {
#pragma unroll
        for (int k = 0; k < NX; ++k) nxt = nxt + c.Aa(t + 1, k, i) * c.px(L.y, t + 1, k);
      }
      const T Q = c.w2(t, i) + lam;
      c.s[L.r_d_x + q] = Q * c.s[L.dxs + q] + c.s[L.cx + q] - c.s[L.y + q] + nxt;
      T sa = T(0), sb = T(0);
      if (t > 0) {
#pragma unroll
        for (int j = 0; j < NX; ++j) sa = sa + c.Aa(t, i, j) * c.px(L.dxs, t - 1, j);
      }
#pragma unroll
      for (int r = 0; r < NU; ++r) sb = sb + c.Ba(t, i, r) * c.pu(L.du, t, r);
      c.s[L.r_pe + q] = c.s[L.r + q] - sa - sb + c.s[L.dxs + q];
    }
    warp_sync();
    bad = mo::nmax(bad, riccati_factor(c, lam));

    // Mehrotra predictor-corrector (algorithm 16.4 / qp.cc:170-188).
    solve_step(c, T(0), false, L.dsl_a, L.dsh_a, L.dzl_a, L.dzh_a);
    T ap_a, ad_a;
    ftb2(c, L.s_lo, L.dsl_a, L.s_hi, L.dsh_a, L.z_lo, L.dzl_a, L.z_hi, L.dzh_a, 1.0, ap_a, ad_a);
    // The reference's mu_aff form (qp.cc:519-537): the carried mu stands in
    // for s^T z / M.
#pragma unroll 1
    for (int q = c.lane; q < n; q += kWarp) {
      const T dsl = c.s[L.dsl_a + q], dsh = c.s[L.dsh_a + q];
      const T dzl = c.s[L.dzl_a + q], dzh = c.s[L.dzh_a + q];
      terms[2 * q] = ad_a * c.s[L.s_lo + q] * dzl + ap_a * c.s[L.z_lo + q] * dsl + ap_a * ad_a * dsl * dzl;
      terms[2 * q + 1] = ad_a * c.s[L.s_hi + q] * dzh + ap_a * c.s[L.z_hi + q] * dsh + ap_a * ad_a * dsh * dzh;
    }
    warp_sync();
    const T cross = sum_from_zero(terms, 2 * n);
    warp_sync();
    const T mu_aff = mo::nmax(mu + cross / ncon, T(0));
    const T ratio = mu_aff / mu;
    const T sigma = ratio * (ratio * ratio);
    solve_step(c, sigma * mu, true, L.ds_lo, L.ds_hi, L.dz_lo, L.dz_hi);

    T ap, ad;
    ftb2(c, L.s_lo, L.ds_lo, L.s_hi, L.ds_hi, L.z_lo, L.dz_lo, L.z_hi, L.dz_hi, kTauFtb, ap, ad);
#pragma unroll 1
    for (int q = c.lane; q < n; q += kWarp) {
      c.s[L.du + q] = c.s[L.du + q] + ap * c.s[L.ddu + q];
      const T s_lo = c.s[L.s_lo + q] + ap * c.s[L.ds_lo + q];
      const T s_hi = c.s[L.s_hi + q] + ap * c.s[L.ds_hi + q];
      const T z_lo = c.s[L.z_lo + q] + ad * c.s[L.dz_lo + q];
      const T z_hi = c.s[L.z_hi + q] + ad * c.s[L.dz_hi + q];
      c.s[L.s_lo + q] = s_lo;
      c.s[L.s_hi + q] = s_hi;
      c.s[L.z_lo + q] = z_lo;
      c.s[L.z_hi + q] = z_hi;
      terms[2 * q] = s_lo * z_lo;
      terms[2 * q + 1] = s_hi * z_hi;
    }
#pragma unroll 1
    for (int q = c.lane; q < tx; q += kWarp) {
      c.s[L.dxs + q] = c.s[L.dxs + q] + ap * c.s[L.ddx + q];
      c.s[L.y + q] = c.s[L.y + q] + ad * c.s[L.ddy + q];
    }
    warp_sync();
    // comp = comp + s_lo z_lo + s_hi z_hi, row by row.
    const T comp = sum_from_zero(terms, 2 * n);
    warp_sync();
    mu = T(0.1) * (comp / ncon);
  }

  // max |y| over the lanes: the largest of non-negative values (or NaN)
  // does not depend on the order, so a shuffle tree gives the ordered
  // loop's bits. The finiteness test is a warp vote.
  T ya = fabs(c.s[L.y]);
  bool fin = isfinite(c.s[L.du]);
#pragma unroll 1
  for (int q = c.lane; q < tx; q += kWarp) {
    ya = mo::nmax(ya, T(fabs(c.s[L.y + q])));
    fin = fin && isfinite(c.s[L.dxs + q]);
  }
#pragma unroll 1
  for (int q = c.lane; q < n; q += kWarp) fin = fin && isfinite(c.s[L.du + q]);
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) ya = mo::nmax(ya, __shfl_xor_sync(kAll, ya, o));
  y_abs = ya;
  bad = mo::nmax(bad, __all_sync(kAll, fin) ? T(0) : T(1));
}

// ---------------------------------------------------------------------------
// One MPC period (the JAX kernel's core).
// ---------------------------------------------------------------------------

template <typename T>
struct PeriodOut {
  T f, eq, flags;
};

// Solves from the iterate in the `cur` slot and the plant state x0 (the
// same on every lane); leaves the returned trajectory in the `best` slot.
// hist, when not null, gets the (iters, 7) channels of this instance
// (column stride hstride), written by lane 0.
template <typename T, class P>
__device__ PeriodOut<T> core(const Ctx<T, P>& c, const T (&x0)[P::NX], int max_iterations,
                             int qp_iterations, int ls_iterations, T* hist, size_t hstride) {
  constexpr int NX = P::NX, NU = P::NU, NIN = NX + NU;
  using D = Dual<T, NIN>;
  const auto& L = c.L;
  const int Tn = c.T_;
  const int dim = c.dim();
  const int tu = Tn * NU;
  const T zero = T(0), one = T(1);
  T* fterms = c.s + L.Vn;  // per-stage terms while the Vn block is idle
  T* eterms = c.s + L.ddx;

  T lam = T(1e-6) * one, penalty = T(1.0) * one, restore = zero;
  copy_z(c, L.cur, L.best);
  T f_best = T(INFINITY), eq_best = zero, fac_bad = zero, lam_maxed = zero, accepted = zero;
  T f_acc = zero, eq_acc = zero, f_pre = zero, eq_pre = zero;
#pragma unroll 1
  for (int it = 0; it < max_iterations; ++it) {
    // Stagewise linearization (the LinearizeAndFillQP analog), a stage per
    // lane, with the stage's cost terms.
#pragma unroll 1
    for (int t = c.lane; t < Tn; t += kWarp) {
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
      cost_terms(c, L.cur, t, fterms);
    }
    warp_sync();
    eq_pre = fabs(c.s[L.r]);
#pragma unroll 4
    for (int q = 1; q < Tn * NX; ++q) eq_pre = eq_pre + fabs(c.s[L.r + q]);
    f_pre = sum_from_first(fterms, dim);
    warp_sync();

    if (f_pre + penalty * eq_pre < f_best + penalty * eq_best) {
      copy_z(c, L.cur, L.best);
      f_best = f_pre;
      eq_best = eq_pre;
    }

    T y_abs, bad_it;
    qp_solve(c, L.cur, lam, qp_iterations, y_abs, bad_it);
    fac_bad = mo::nmax(fac_bad, bad_it);

    // Directional derivative and penalty (nonlinear.cc:457-502): the terms
    // across the lanes, the sums in order.
#pragma unroll 1
    for (int q = c.lane; q < dim; q += kWarp) {
      const int t = q / (NU + NX), k = q % (NU + NX);
      fterms[q] = k < NU ? c.pu(L.cu, t, k) * c.pu(L.du, t, k) : c.px(L.cx, t, k - NU) * c.px(L.dxs, t, k - NU);
    }
#pragma unroll 1
    for (int q = c.lane; q < Tn * NX; q += kWarp) {
      const int t = q / NX, i = q % NX;
      T sa = zero, sb = zero;
      if (t > 0) {
#pragma unroll
        for (int j = 0; j < NX; ++j) sa = sa + c.Aa(t, i, j) * c.px(L.dxs, t - 1, j);
      }
#pragma unroll
      for (int r = 0; r < NU; ++r) sb = sb + c.Ba(t, i, r) * c.pu(L.du, t, r);
      // A_eq row: -A_t dx_t - B_t du_t + dx_{t+1}.
      eterms[q] = mo::sgn(c.px(L.r, t, i)) * (-sa - sb + c.px(L.dxs, t, i));
    }
    warp_sync();
    const T d_f = sum_from_zero(fterms, dim);
    const T d_eq = sum_from_zero(eterms, Tn * NX);
    warp_sync();
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
      for (int q = c.lane; q < dim; q += kWarp)
        c.s[L.cand + q] = c.s[L.cur + q] + alpha * (q < tu ? c.s[L.du + q] : c.s[L.dxs + q - tu]);
      warp_sync();
      T f_c, eq_c;
      errors_at(c, x0, L.cand, f_c, eq_c);
      const T merit_c = f_c + penalty * eq_c;
      const T ok = (merit_c <= merit_pre + T(1e-4) * alpha * mo::nmin(dd, zero)) ? one : zero;
      const T take = ok * (T(1.0) - accepted);
#pragma unroll 1
      for (int q = c.lane; q < dim; q += kWarp)
        c.s[L.blend + q] = take * c.s[L.cand + q] + (T(1.0) - take) * c.s[L.blend + q];
      warp_sync();
      f_acc = take * f_c + (T(1.0) - take) * f_acc;
      eq_acc = take * eq_c + (T(1.0) - take) * eq_acc;
      accepted = mo::nmin(accepted + take, T(1.0));
    }
    if (accepted > zero) copy_z(c, L.blend, L.cur);
    if (hist != nullptr && c.lane == 0) {
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
// The two kernels: warp w of CTA b solves instance b W + w.
// ---------------------------------------------------------------------------

// The warp's context: its slab of the CTA's shared memory, or row `inst` of
// the instance-major (B, slots) global scratch when the launcher passes one.
template <typename T, class P>
__device__ __forceinline__ Ctx<T, P> make_ctx(const P& plant, const Cost& cs, T* scratch, int inst) {
  const Layout L(cs.horizon, P::NX, P::NU);
  T* slab = scratch != nullptr ? scratch + static_cast<size_t>(inst) * L.total
                               : dyn_smem<T>() + static_cast<size_t>(threadIdx.x / kWarp) * L.total;
  return Ctx<T, P>{plant, cs, cs.horizon, slab, L, static_cast<int>(threadIdx.x % kWarp)};
}

__device__ __forceinline__ int instance_of_warp() {
  return blockIdx.x * (blockDim.x / kWarp) + threadIdx.x / kWarp;
}

// Kernel 8: one period per instance; x0 (nx, B), z0 (dim, B) -> z_out (dim,
// B), stat (3, B) = (f, |eq|_1, flags), hist (iters, 7, B) or null.
template <typename T, class P>
__global__ void __launch_bounds__(kMaxWarps * kWarp)
    mpc_solve_kernel(P plant, Cost cs, const T* __restrict__ x0, const T* __restrict__ z0,
                     T* __restrict__ z_out, T* __restrict__ stat, T* __restrict__ hist,
                     T* __restrict__ scratch, int B, int max_iterations, int qp_iterations,
                     int ls_iterations) {
  const int inst = instance_of_warp();
  if (inst >= B) return;  // the whole warp, before its first __syncwarp
  const size_t stride = static_cast<size_t>(B);
  const Ctx<T, P> c = make_ctx<T>(plant, cs, scratch, inst);
  T x[P::NX];
#pragma unroll
  for (int i = 0; i < P::NX; ++i) x[i] = x0[i * stride + inst];
  const int dim = c.dim();
#pragma unroll 1
  for (int q = c.lane; q < dim; q += kWarp) c.s[c.L.cur + q] = z0[q * stride + inst];
  warp_sync();
  const PeriodOut<T> o =
      core(c, x, max_iterations, qp_iterations, ls_iterations, hist == nullptr ? nullptr : hist + inst, stride);
#pragma unroll 1
  for (int q = c.lane; q < dim; q += kWarp) z_out[q * stride + inst] = c.s[c.L.best + q];
  if (c.lane == 0) {
    stat[inst] = o.f;
    stat[stride + inst] = o.eq;
    stat[2 * stride + inst] = o.flags;
  }
}

// Kernel 9: `periods` x (solve -> apply u_0 -> RK4 plant step -> shift the
// warm start) per instance; x (nx, B), z0 (dim, B) -> x_out, z_out, stats
// (4, B) = (f, |eq|_1 of the last period, sticky flags, max |u_0|).
template <typename T, class P>
__global__ void __launch_bounds__(kMaxWarps * kWarp)
    mpc_servo_kernel(P plant, Cost cs, const T* __restrict__ x0, const T* __restrict__ z0,
                     T* __restrict__ x_out, T* __restrict__ z_out, T* __restrict__ stats,
                     T* __restrict__ scratch, int B, int periods, int max_iterations, int qp_iterations,
                     int ls_iterations) {
  constexpr int NX = P::NX, NU = P::NU;
  const int inst = instance_of_warp();
  if (inst >= B) return;  // the whole warp, before its first __syncwarp
  const size_t stride = static_cast<size_t>(B);
  const Ctx<T, P> c = make_ctx<T>(plant, cs, scratch, inst);
  const int Tn = c.T_;
  const auto& L = c.L;
  T x[NX];
#pragma unroll
  for (int i = 0; i < NX; ++i) x[i] = x0[i * stride + inst];
  const int dim = c.dim();
#pragma unroll 1
  for (int q = c.lane; q < dim; q += kWarp) c.s[L.cur + q] = z0[q * stride + inst];
  warp_sync();
  T maxu = T(0), f = T(0), eq = T(0), flags = T(0);
#pragma unroll 1
  for (int p = 0; p < periods; ++p) {
    const PeriodOut<T> o = core(c, x, max_iterations, qp_iterations, ls_iterations, static_cast<T*>(nullptr), stride);
    T u0[NU], xn[NX];
#pragma unroll
    for (int r = 0; r < NU; ++r) u0[r] = c.u(L.best, 0, r);
    rk4<T>(c.plant, c.cs, x, u0, xn);
    // shift_warm_start: u_t <- u_{t+1} (last repeated), x_t <- x_{t+1}, the
    // new terminal state integrated from the last shifted pair (last lane).
#pragma unroll 1
    for (int q = c.lane; q < Tn * NU; q += kWarp) {
      const int t = q / NU, r = q % NU;
      c.u(L.cur, t, r) = c.u(L.best, t + 1 < Tn ? t + 1 : Tn - 1, r);
    }
#pragma unroll 1
    for (int q = c.lane; q < (Tn - 1) * NX; q += kWarp) c.s[L.cur + Tn * NU + q] = c.s[L.best + Tn * NU + NX + q];
    if (c.lane == kWarp - 1) {
      T xl[NX], ul[NU], xt[NX];
#pragma unroll
      for (int i = 0; i < NX; ++i) xl[i] = c.x(L.best, Tn - 1, i);
#pragma unroll
      for (int r = 0; r < NU; ++r) ul[r] = c.u(L.best, Tn - 1, r);
      rk4<T>(c.plant, c.cs, xl, ul, xt);
#pragma unroll
      for (int i = 0; i < NX; ++i) c.x(L.cur, Tn - 1, i) = xt[i];
    }
    warp_sync();
#pragma unroll
    for (int r = 0; r < NU; ++r) maxu = mo::nmax(maxu, T(fabs(u0[r])));
    flags = mo::nmax(flags, o.flags);
    f = o.f;
    eq = o.eq;
#pragma unroll
    for (int i = 0; i < NX; ++i) x[i] = xn[i];
  }
#pragma unroll 1
  for (int q = c.lane; q < dim; q += kWarp) z_out[q * stride + inst] = c.s[L.cur + q];
  if (c.lane == 0) {
#pragma unroll
    for (int i = 0; i < NX; ++i) x_out[i * stride + inst] = x[i];
    stats[inst] = f;
    stats[stride + inst] = eq;
    stats[2 * stride + inst] = flags;
    stats[3 * stride + inst] = maxu;
  }
}

struct LaunchArgs {
  const void* x0;
  const void* z0;
  void* x_out;  // servo only
  void* z_out;
  void* stat;
  void* hist;  // solve only; may be null
  void* scratch;  // null: the slabs live in shared memory
  int B;
  int warps;  // instances per CTA
  int periods;  // servo only; < 0 selects the solve kernel
  int max_iterations;
  int qp_iterations;
  int ls_iterations;
  cudaStream_t stream;
};

// Dynamic shared memory of one CTA: `warps` slabs, or none on the global
// route.
template <typename T, class P>
size_t cta_smem_bytes(const Cost& cs, const LaunchArgs& a) {
  return a.scratch != nullptr ? 0 : static_cast<size_t>(a.warps) * Layout(cs.horizon, P::NX, P::NU).total * sizeof(T);
}

template <typename T, class P>
const void* kernel_of(bool servo) {
  return servo ? reinterpret_cast<const void*>(&mpc_servo_kernel<T, P>)
               : reinterpret_cast<const void*>(&mpc_solve_kernel<T, P>);
}

// Lets the kernel take `smem` bytes of dynamic shared memory (above 48 KB
// only by this opt-in). kTooLarge past one CTA's 232,448 bytes.
template <typename T, class P>
int allow_smem(bool servo, size_t smem) {
  if (smem > static_cast<size_t>(kMaxSmem)) return mo::kTooLarge;
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(
      cudaFuncSetAttribute(kernel_of<T, P>(servo), cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
}

template <typename T, class P>
int launch(const P& plant, const Cost& cs, const LaunchArgs& a) {
  if (a.warps < 1 || a.warps > kMaxWarps) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = cta_smem_bytes<T, P>(cs, a);
  const int rc = allow_smem<T, P>(a.periods >= 0, smem);
  if (rc != 0) return rc;
  const int grid = (a.B + a.warps - 1) / a.warps;
  const int threads = a.warps * kWarp;
  if (a.periods < 0) {
    mpc_solve_kernel<T, P><<<grid, threads, smem, a.stream>>>(
        plant, cs, static_cast<const T*>(a.x0), static_cast<const T*>(a.z0), static_cast<T*>(a.z_out),
        static_cast<T*>(a.stat), static_cast<T*>(a.hist), static_cast<T*>(a.scratch), a.B,
        a.max_iterations, a.qp_iterations, a.ls_iterations);
  } else {
    mpc_servo_kernel<T, P><<<grid, threads, smem, a.stream>>>(
        plant, cs, static_cast<const T*>(a.x0), static_cast<const T*>(a.z0), static_cast<T*>(a.x_out),
        static_cast<T*>(a.z_out), static_cast<T*>(a.stat), static_cast<T*>(a.scratch), a.B, a.periods,
        a.max_iterations, a.qp_iterations, a.ls_iterations);
  }
  return static_cast<int>(cudaGetLastError());
}

// CTAs of `warps` instances that fit one SM at once, for the shared route
// (scratch null) or the global one; negative on a CUDA error.
template <typename T, class P>
int occupancy(const Cost& cs, const LaunchArgs& a) {
  const size_t smem = cta_smem_bytes<T, P>(cs, a);
  const int rc = allow_smem<T, P>(a.periods >= 0, smem);
  if (rc != 0) return rc > 0 ? -rc : rc;
  int blocks = 0;
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel_of<T, P>(a.periods >= 0),
                                                                      a.warps * kWarp, smem);
  return e == cudaSuccess ? blocks : -static_cast<int>(e);
}

// plant: 0 cart-pole (consts mass_cart, mass_pole, length, gravity),
// 1 quadrotor (mass, inertia, arm, gravity). occupancy_only asks for the
// CTAs per SM instead of a launch.
template <typename T>
int dispatch_plant(int plant, const double* consts, const Cost& cs, const LaunchArgs& a, bool occupancy_only) {
  switch (plant) {
    case 0: {
      const CartPole p{consts[0], consts[1], consts[2], consts[3]};
      return occupancy_only ? occupancy<T, CartPole>(cs, a) : launch<T>(p, cs, a);
    }
    case 1: {
      const Quadrotor p{consts[0], consts[1], consts[2], consts[3]};
      return occupancy_only ? occupancy<T, Quadrotor>(cs, a) : launch<T>(p, cs, a);
    }
    default: return mo::kNoInstance;
  }
}

// The instances of one dtype, each built in its own source file so that the
// two compile in parallel: mpc.cu (float), mpc_f64.cu (double).
int launch_float(int plant, const double* consts, const Cost& cs, const LaunchArgs& a, bool occupancy_only);
int launch_double(int plant, const double* consts, const Cost& cs, const LaunchArgs& a, bool occupancy_only);

}  // namespace mo::mpc
