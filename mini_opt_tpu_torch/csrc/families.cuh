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
//
// PlanarChain and SpatialChain at the end are the blocked tier's families
// (blocked_sqp.cuh): the same arithmetic with the chain length a runtime
// value, evaluated by the instance's warp.
#pragma once

#include <cmath>

namespace mo {

// The JAX package's literal (pallas_ik.py:70), not M_PI.
constexpr double kPi = 3.14159265358979;

// The row of slot p of a lower triangle packed by rows (row i at
// i (i + 1) / 2): i (i + 1) / 2 <= p < (i + 1) (i + 2) / 2.
__host__ __device__ inline int packed_row(int p) {
  int i = static_cast<int>((sqrtf(8.0f * p + 1.0f) - 1.0f) * 0.5f);
  i -= i * (i + 1) / 2 > p ? 1 : 0;
  i += (i + 1) * (i + 2) / 2 <= p ? 1 : 0;
  return i;
}

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

// Planar chain with a runtime number of joints n, for the blocked tier
// (blocked_sqp.cuh; D = n + 1 runs to 192, past what one template per N
// would reasonably instance). The cooperative members are called by every
// lane of the instance's warp after a __syncwarp that published th and tgt;
// lane l handles joints l, l + 32, ...; each ends with a __syncwarp after
// which its shared-memory outputs are visible, and each returns its uniform
// outputs (f, eq) to every lane. Arithmetic and operand order are Planar's:
// the angles' prefix sums and the Jacobian's suffix sums run in index order
// on each lane.
struct PlanarChain {
  static constexpr int M = 1;
  static constexpr int ROWS = 2;
  static constexpr int kLanes = 32;
  int n;
  double link;

  __host__ __device__ int nvar() const { return n; }
  // Joints 1..n-1 limited to [0, pi]: slack j sits on joint j + 1.
  __host__ __device__ int nlo() const { return n - 1; }
  __host__ __device__ int nhi() const { return n - 1; }
  __device__ int lo_slot(int i) const { return i - 1; }  // -1: no bound
  __device__ int hi_slot(int i) const { return i - 1; }
  __device__ double lo_val(int) const { return 0.0; }
  __device__ double hi_val(int) const { return kPi; }
  // Scratch: cos and sin of the cumulative angles, then J_y (J_x goes
  // straight to J_eq).
  __host__ __device__ int scratch() const { return 3 * n; }

  // Variable i's retraction (every joint wraps alike).
  template <typename T>
  __device__ __forceinline__ T retract(int, T a) const {
    const T two_pi = T(2.0 * kPi);
    return a - two_pi * floor((a + T(kPi)) / two_pi);
  }

  // cs[i], sn[i] = cos, sin of th[0] + ... + th[i] (summed in index order):
  // each lane runs the prefix sum up to its last joint, parking its angles
  // in cs, then takes their cos and sin.
  template <typename T>
  __device__ void angles(int lane, const T* th, T* cs, T* sn) const {
    T phi = th[0];
    for (int i = lane, k = 0; i < n; i += kLanes) {
      while (k < i) phi = phi + th[++k];
      cs[i] = phi;
    }
    for (int i = lane; i < n; i += kLanes) {
      const T a = cs[i];
      cs[i] = cos(a);
      sn[i] = sin(a);
    }
    __syncwarp();
  }

  template <typename T>
  __device__ void effector(const T* cs, const T* sn, T& px, T& py) const {
    T sc = T(0), ss = T(0);  // Python's sum() starts from 0
    for (int i = 0; i < n; ++i) {
      sc = sc + cs[i];
      ss = ss + sn[i];
    }
    px = T(link) * sc;
    py = T(link) * ss;
  }

  // G: packed lower triangle (row i at i (i + 1) / 2), Jeq (1, n), c (n),
  // req (1) in shared memory; f to every lane.
  template <typename T>
  __device__ void linearize(int lane, const T* th, const T* tgt, T* scr, T* G, T* Jeq, T* c,
                            T* req, T& f) const {
    T* cs = scr;
    T* sn = scr + n;
    T* jy = scr + 2 * n;
    angles(lane, th, cs, sn);
    T px, py;
    effector(cs, sn, px, py);
    // dpx/dth_a = -L sum_{i>=a} s_i ; dpy/dth_a = L sum_{i>=a} c_i: one
    // suffix sum per lane, from joint n-1 down to its lowest joint.
    if (lane < n) {
      T sx = sn[n - 1], sy = cs[n - 1];
      for (int a = n - 1;; --a) {
        if (a < n - 1) {
          sx = sx + sn[a];
          sy = sy + cs[a];
        }
        if ((a - lane) % kLanes == 0) {
          Jeq[a] = T(-link) * sx;
          jy[a] = T(link) * sy;
        }
        if (a == lane) break;
      }
    }
    __syncwarp();
    const T ry = py - tgt[1];
    const T rx = px - tgt[0];
    f = T(0.5) * ry * ry;
    // G = J_y J_y^T, its slots spread over the lanes.
    for (int p = lane; p < n * (n + 1) / 2; p += kLanes) {
      const int i = packed_row(p);
      G[p] = jy[i] * jy[p - i * (i + 1) / 2];
    }
    for (int a = lane; a < n; a += kLanes) c[a] = jy[a] * ry;
    if (lane == 0) req[0] = rx;
    __syncwarp();
  }

  template <typename T>
  __device__ void errors(int lane, const T* th, const T* tgt, T* scr, T& f, T& eq) const {
    angles(lane, th, scr, scr + n);
    T px, py;
    effector(scr, scr + n, px, py);
    const T ey = py - tgt[1];
    f = T(0.5) * (ey * ey);
    eq = fabs(px - tgt[0]);
    __syncwarp();
  }
};

// The spatial chain with a runtime number of joints n, for the blocked tier:
// Spatial's arithmetic, with PlanarChain's cooperative interface. The
// rotation chain is a product of prefixes, so every lane runs all of it (the
// same operations in joint order, so every lane holds the same effector p);
// lane l records the axis w_a and origin q_a of its joints a = l, l + 32, ...
// as the chain passes them, and then makes their Jacobian columns
// J_a = w_a x (p - q_a) from the slots it wrote itself.
struct SpatialChain {
  static constexpr int M = 1;
  static constexpr int ROWS = 3;
  static constexpr int kLanes = 32;
  int n;
  double link;

  __host__ __device__ int nvar() const { return n; }
  // Joints 1..n-1 limited to [0, pi]: slack j sits on joint j + 1.
  __host__ __device__ int nlo() const { return n - 1; }
  __host__ __device__ int nhi() const { return n - 1; }
  __device__ int lo_slot(int i) const { return i - 1; }  // -1: no bound
  __device__ int hi_slot(int i) const { return i - 1; }
  __device__ double lo_val(int) const { return 0.0; }
  __device__ double hi_val(int) const { return kPi; }
  // Scratch: w_a and q_a (6 a joint), then J_y and J_z (J_x goes straight
  // to J_eq).
  __host__ __device__ int scratch() const { return 8 * n; }

  template <typename T>
  __device__ __forceinline__ T retract(int, T a) const {
    const T two_pi = T(2.0 * kPi);
    return a - two_pi * floor((a + T(kPi)) / two_pi);
  }

  // The effector p on every lane; with wq, the lane's joints' w_a (wq[6a
  // ..]) and q_a (wq[6a + 3 ..]). Spatial::fk's operations in its order.
  template <typename T>
  __device__ void chain(int lane, const T* th, T* wq, T (&p)[3]) const {
    const T L = T(link);
    T R[3][3] = {{T(1), T(0), T(0)}, {T(0), T(1), T(0)}, {T(0), T(0), T(1)}};
    p[0] = p[1] = p[2] = T(0);
    for (int a = 0; a < n; ++a) {
      const int axis_col = a % 2 == 0 ? 2 : 1;  // z-axis or y-axis column
      if (wq != nullptr && (a - lane) % kLanes == 0) {
#pragma unroll
        for (int r = 0; r < 3; ++r) {
          wq[6 * a + r] = R[r][axis_col];
          wq[6 * a + 3 + r] = p[r];
        }
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
  }

  // G: packed lower triangle (row i at i (i + 1) / 2), Jeq (1, n), c (n),
  // req (1) in the slab; f to every lane.
  template <typename T>
  __device__ void linearize(int lane, const T* th, const T* tgt, T* scr, T* G, T* Jeq, T* c, T* req,
                            T& f) const {
    T* wq = scr;
    T* jy = scr + 6 * n;
    T* jz = scr + 7 * n;
    T p[3];
    chain(lane, th, wq, p);
    for (int a = lane; a < n; a += kLanes) {
      T d[3];
#pragma unroll
      for (int r = 0; r < 3; ++r) d[r] = p[r] - wq[6 * a + 3 + r];
      const T* w = wq + 6 * a;
      Jeq[a] = w[1] * d[2] - w[2] * d[1];
      jy[a] = w[2] * d[0] - w[0] * d[2];
      jz[a] = w[0] * d[1] - w[1] * d[0];
    }
    __syncwarp();
    const T ry = p[1] - tgt[1];
    const T rz = p[2] - tgt[2];
    const T rx = p[0] - tgt[0];
    f = T(0.5) * (ry * ry + rz * rz);
    for (int q = lane; q < n * (n + 1) / 2; q += kLanes) {
      const int i = packed_row(q), j = q - i * (i + 1) / 2;
      G[q] = jy[i] * jy[j] + jz[i] * jz[j];
    }
    for (int a = lane; a < n; a += kLanes) c[a] = jy[a] * ry + jz[a] * rz;
    if (lane == 0) req[0] = rx;
    __syncwarp();
  }

  template <typename T>
  __device__ void errors(int lane, const T* th, const T* tgt, T*, T& f, T& eq) const {
    T p[3];
    chain<T>(lane, th, nullptr, p);
    const T ey = p[1] - tgt[1];
    const T ez = p[2] - tgt[2];
    f = T(0.5) * (ey * ey + ez * ez);
    eq = fabs(p[0] - tgt[0]);
    __syncwarp();
  }
};

}  // namespace mo
