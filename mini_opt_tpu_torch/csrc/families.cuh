// Hand-written device functors of the fused IK families, the CUDA twins of
// planar_family / spatial_family in ops/fused_ik.py (and of the JAX
// package's pallas_ik.py:190-320).
//
// A family tells the solver skeleton (fused_sqp.cuh) its compile-time sizes
// -- N variables, M equality rows, ROWS data rows, NLO / NHI bounded sides
// with lo_var / lo_val / hi_var / hi_val -- and supplies
//   linearize(th, data, f, r_eq, J_eq, G (lower triangle), c)
//   errors(th, data, f, eq_l1)
//   retract(th)   (in place)
// The link length is a runtime member. Every expression keeps the operand
// order of the Python version, so both round alike.
#pragma once

#include <cmath>

namespace mo {

// The JAX package's literal (pallas_ik.py:70), not M_PI.
constexpr double kPi = 3.14159265358979;

// Joints 1..N-1 limited to [0, pi], joint 0 free (both families).
template <int N_>
struct JointLimits {
  static constexpr int N = N_;
  static constexpr int NLO = N_ - 1;
  static constexpr int NHI = N_ - 1;
  __host__ __device__ static constexpr int lo_var(int j) { return j + 1; }
  __host__ __device__ static constexpr double lo_val(int) { return 0.0; }
  __host__ __device__ static constexpr int hi_var(int j) { return j + 1; }
  __host__ __device__ static constexpr double hi_val(int) { return kPi; }

  // _mod_pi: a - 2 pi floor((a + pi) / (2 pi)), 2 pi folded in double.
  template <typename T>
  __device__ __forceinline__ void retract(T (&th)[N_]) const {
    const T two_pi = T(2.0 * kPi);
#pragma unroll
    for (int i = 0; i < N_; ++i) th[i] = th[i] - two_pi * floor((th[i] + T(kPi)) / two_pi);
  }
};

// Planar Z-rotation chain: cost on effector y, equality on effector x.
template <int N_>
struct Planar : JointLimits<N_> {
  static constexpr int N = N_;
  static constexpr int M = 1;
  static constexpr int ROWS = 2;
  double link;

  template <typename T>
  __device__ __forceinline__ void fk(const T (&th)[N], T& px, T& py, T (&jx)[N], T (&jy)[N]) const {
    const T L = T(link);
    T c[N], s[N];
    T phi = th[0];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if (i > 0) phi = phi + th[i];
      c[i] = cos(phi);
      s[i] = sin(phi);
    }
    T sc = T(0), ss = T(0);  // Python's sum() starts from 0
#pragma unroll
    for (int i = 0; i < N; ++i) {
      sc = sc + c[i];
      ss = ss + s[i];
    }
    px = L * sc;
    py = L * ss;
    // dpx/dth_a = -L sum_{i>=a} s_i ; dpy/dth_a = L sum_{i>=a} c_i
    T sx = s[N - 1], sy = c[N - 1];
    jx[N - 1] = T(-link) * sx;
    jy[N - 1] = L * sy;
#pragma unroll
    for (int a = N - 2; a >= 0; --a) {
      sx = sx + s[a];
      sy = sy + c[a];
      jx[a] = T(-link) * sx;
      jy[a] = L * sy;
    }
  }

  template <typename T>
  __device__ __forceinline__ void linearize(const T (&th)[N], const T (&d)[ROWS], T& f,
                                            T (&r_eq)[M], T (&Jeq)[M][N], T (&G)[N][N],
                                            T (&c)[N]) const {
    T px, py, jx[N], jy[N];
    fk(th, px, py, jx, jy);
    const T ry = py - d[1];
    const T rx = px - d[0];
    f = T(0.5) * ry * ry;
#pragma unroll
    for (int i = 0; i < N; ++i) {
#pragma unroll
      for (int j = 0; j <= i; ++j) G[i][j] = jy[i] * jy[j];
    }
#pragma unroll
    for (int i = 0; i < N; ++i) c[i] = jy[i] * ry;
    r_eq[0] = rx;
#pragma unroll
    for (int i = 0; i < N; ++i) Jeq[0][i] = jx[i];
  }

  template <typename T>
  __device__ __forceinline__ void errors(const T (&th)[N], const T (&d)[ROWS], T& f,
                                         T& eq) const {
    T px, py, jx[N], jy[N];
    fk(th, px, py, jx, jy);
    const T ey = py - d[1];
    f = T(0.5) * (ey * ey);
    eq = fabs(px - d[0]);
  }
};

// 3-D chain with alternating rotation axes (z, y, z, y, ...), links along
// local x: cost on effector (y, z), equality on effector x.
template <int N_>
struct Spatial : JointLimits<N_> {
  static constexpr int N = N_;
  static constexpr int M = 1;
  static constexpr int ROWS = 3;
  double link;

  // Effector p and per-joint world Jacobians J[a] = w_a x (p - q_a).
  template <typename T>
  __device__ __forceinline__ void fk(const T (&th)[N], T (&p)[3], T (&J)[N][3]) const {
    const T L = T(link);
    T R[3][3] = {{T(1), T(0), T(0)}, {T(0), T(1), T(0)}, {T(0), T(0), T(1)}};
    T ws[N][3], qs[N][3];
    p[0] = p[1] = p[2] = T(0);
#pragma unroll
    for (int a = 0; a < N; ++a) {
      const int axis_col = a % 2 == 0 ? 2 : 1;  // z-axis or y-axis column
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        ws[a][r] = R[r][axis_col];
        qs[a][r] = p[r];
      }
      const T c_ = cos(th[a]), s_ = sin(th[a]);
      if (a % 2 == 0) {  // R = R @ Rz
        T c0[3], c1[3];
#pragma unroll
        for (int r = 0; r < 3; ++r) {
          c0[r] = c_ * R[r][0] + s_ * R[r][1];
          c1[r] = -s_ * R[r][0] + c_ * R[r][1];
        }
#pragma unroll
        for (int r = 0; r < 3; ++r) {
          R[r][0] = c0[r];
          R[r][1] = c1[r];
        }
      } else {  // R = R @ Ry
        T c0[3], c2[3];
#pragma unroll
        for (int r = 0; r < 3; ++r) {
          c0[r] = c_ * R[r][0] - s_ * R[r][2];
          c2[r] = s_ * R[r][0] + c_ * R[r][2];
        }
#pragma unroll
        for (int r = 0; r < 3; ++r) {
          R[r][0] = c0[r];
          R[r][2] = c2[r];
        }
      }
#pragma unroll
      for (int r = 0; r < 3; ++r) p[r] = p[r] + L * R[r][0];
    }
#pragma unroll
    for (int a = 0; a < N; ++a) {
      T d[3];
#pragma unroll
      for (int r = 0; r < 3; ++r) d[r] = p[r] - qs[a][r];
      const T* w = ws[a];
      J[a][0] = w[1] * d[2] - w[2] * d[1];
      J[a][1] = w[2] * d[0] - w[0] * d[2];
      J[a][2] = w[0] * d[1] - w[1] * d[0];
    }
  }

  template <typename T>
  __device__ __forceinline__ void linearize(const T (&th)[N], const T (&d)[ROWS], T& f,
                                            T (&r_eq)[M], T (&Jeq)[M][N], T (&G)[N][N],
                                            T (&c)[N]) const {
    T p[3], J[N][3];
    fk(th, p, J);
    const T ry = p[1] - d[1];
    const T rz = p[2] - d[2];
    const T rx = p[0] - d[0];
    f = T(0.5) * (ry * ry + rz * rz);
#pragma unroll
    for (int i = 0; i < N; ++i) {
#pragma unroll
      for (int j = 0; j <= i; ++j) G[i][j] = J[i][1] * J[j][1] + J[i][2] * J[j][2];
    }
#pragma unroll
    for (int i = 0; i < N; ++i) c[i] = J[i][1] * ry + J[i][2] * rz;
    r_eq[0] = rx;
#pragma unroll
    for (int i = 0; i < N; ++i) Jeq[0][i] = J[i][0];
  }

  template <typename T>
  __device__ __forceinline__ void errors(const T (&th)[N], const T (&d)[ROWS], T& f,
                                         T& eq) const {
    T p[3], J[N][3];
    fk(th, p, J);
    const T ey = p[1] - d[1];
    const T ez = p[2] - d[2];
    f = T(0.5) * (ey * ey + ez * ez);
    eq = fabs(p[0] - d[0]);
  }
};

}  // namespace mo
