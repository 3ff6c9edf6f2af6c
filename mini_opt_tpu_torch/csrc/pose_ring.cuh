// Kernel 7: the whole Gauss-Newton / Levenberg-Marquardt solve of batched
// SE(2) pose graphs -- an odometry chain (edges (t, t+1)) plus one or more
// loop closures, with a soft anchor on pose 0 -- on Hopper.
//
// Replaces the TPU kernel mini_opt_tpu/ops/pallas_pose_ring.py::
// _make_ring_kernel (launched at pallas_pose_ring.py:712 by
// pose_ring_solve_batch). It computes the same thing, per instance: the
// analytic Gauss-Newton blocks (3x3 diagonal blocks, the chain's coupling
// blocks, one block per closure, the gradient); the damped step by the
// bordered block-Thomas algorithm -- the closure endpoints are the border
// poses, each chain segment between them is eliminated by a block-Thomas
// sweep that carries one 3x3 column block per adjacent border, and the
// borders solve their Schur system (a 3x3 adjugate inverse for one closure,
// an unrolled 3k x 3k LDL^T for k borders); the Armijo line search with
// angle wrap in the cost; the lambda machine; the best-merit return; the
// (f, 0, flags) write-out.
//
// What bounds it on this card: arithmetic and the per-lane working set. An
// instance reads 3E + 3N scalars and writes 3N + 3, but runs some hundred
// thousand floating-point operations (chip_smoke.py counts them from the
// plain version), and its blocks (about 54 N scalars) do not fit registers.
//
// What the design does about it: one instance per CUDA thread, scalar
// arithmetic with no shared memory and no synchronisation. The number of
// poses N is a run-time value, so one build serves every ring size and
// topology: the per-pose blocks live in a scratch array the caller
// allocates, feature-major like the inputs ((slots, B), thread i on column
// i), so that a warp's accesses to one slot are coalesced. The topology is
// turned by the launcher into a small schedule (border poses, segments)
// passed by value; the multi-closure Schur system is a template on the
// border count k = 2..6, factored by fused_sqp.cuh's unrolled LDL^T.
//
// Semantics mirror the JAX kernel where a transcription would drift:
// jnp.maximum/minimum propagate NaN (nmax/nmin), the pivot and determinant
// tests use FLT_MIN/DBL_MIN, each 3x3 product sums from 0 as Python's sum
// does, the cost sums from its first term, the angle wrap divides by 2 pi
// (math.pi, not the IK kernels' truncated literal), and the line search
// blends candidates arithmetically, so a NaN candidate poisons the blend. The
// build uses no fast math and no FMA contraction, so this kernel reproduces
// the plain PyTorch version (ops/pose_ring.py::_pose_ring_plain) bit for
// bit.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>

#include "fused_sqp.cuh"

namespace mo::ring {

constexpr int kBlock = 128;
constexpr int kMaxClosures = 16;
constexpr int kMaxBorders = 6;
constexpr int kMaxSegments = kMaxBorders + 1;
constexpr double kPi = 3.141592653589793;

// The topology as a schedule: closures in declaration order, the border
// poses ascending (one closure: its lower endpoint; several: every
// endpoint), and the chain segments between them in ascending order.
struct Topology {
  int n;
  int n_cl;
  int cl_from[kMaxClosures];
  int cl_to[kMaxClosures];
  int k;
  int border[kMaxBorders];
  int n_seg;
  int seg_lo[kMaxSegments];
  int seg_hi[kMaxSegments];
  double wa2;       // anchor_weight^2
  double half_wa2;  // 0.5 * anchor_weight^2
};

// Scratch rows of one lane, in units of N: cand, best_x, bx, dx, g, z / y
// (3 each); D (9: the diagonal blocks; the sweep replaces a non-border
// pose's block by its inverse); U (9 per chain edge); ZW / W (18: two
// border columns); then 9 per closure.
struct Layout {
  int cand, best, bx, dx, g, zy, D, U, ZW, Cb, total;
  __host__ __device__ explicit Layout(int n, int n_cl)
      : cand(0), best(3 * n), bx(6 * n), dx(9 * n), g(12 * n), zy(15 * n), D(18 * n), U(27 * n),
        ZW(27 * n + 9 * (n - 1)), Cb(ZW + 18 * n), total(Cb + 9 * n_cl) {}
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

template <typename T>
struct M3 {
  T a[3][3];
};
template <typename T>
struct V3 {
  T a[3];
};

template <typename T>
__device__ __forceinline__ T wrap(T a) {
  return a - T(2.0 * kPi) * floor((a + T(kPi)) / T(2.0 * kPi));
}

template <typename T>
__device__ __forceinline__ M3<T> zero33() {
  M3<T> Z;
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int s = 0; s < 3; ++s) Z.a[r][s] = T(0);
  return Z;
}

template <typename T>
__device__ __forceinline__ M3<T> mm(const M3<T>& A, const M3<T>& B) {
  M3<T> C;
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int s = 0; s < 3; ++s)
      C.a[r][s] = ((T(0) + A.a[r][0] * B.a[0][s]) + A.a[r][1] * B.a[1][s]) + A.a[r][2] * B.a[2][s];
  return C;
}

template <typename T>
__device__ __forceinline__ M3<T> mTm(const M3<T>& A, const M3<T>& B) {  // A^T B
  M3<T> C;
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int s = 0; s < 3; ++s)
      C.a[r][s] = ((T(0) + A.a[0][r] * B.a[0][s]) + A.a[1][r] * B.a[1][s]) + A.a[2][r] * B.a[2][s];
  return C;
}

template <typename T>
__device__ __forceinline__ V3<T> mv(const M3<T>& A, const V3<T>& v) {
  V3<T> w;
#pragma unroll
  for (int r = 0; r < 3; ++r)
    w.a[r] = ((T(0) + A.a[r][0] * v.a[0]) + A.a[r][1] * v.a[1]) + A.a[r][2] * v.a[2];
  return w;
}

template <typename T>
__device__ __forceinline__ V3<T> mTv(const M3<T>& A, const V3<T>& v) {
  V3<T> w;
#pragma unroll
  for (int r = 0; r < 3; ++r)
    w.a[r] = ((T(0) + A.a[0][r] * v.a[0]) + A.a[1][r] * v.a[1]) + A.a[2][r] * v.a[2];
  return w;
}

template <typename T>
__device__ __forceinline__ M3<T> msub(const M3<T>& A, const M3<T>& B) {
  M3<T> C;
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int s = 0; s < 3; ++s) C.a[r][s] = A.a[r][s] - B.a[r][s];
  return C;
}

template <typename T>
__device__ __forceinline__ M3<T> madd(const M3<T>& A, const M3<T>& B) {
  M3<T> C;
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int s = 0; s < 3; ++s) C.a[r][s] = A.a[r][s] + B.a[r][s];
  return C;
}

template <typename T>
__device__ __forceinline__ M3<T> mT(const M3<T>& A) {
  M3<T> C;
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int s = 0; s < 3; ++s) C.a[r][s] = A.a[s][r];
  return C;
}

template <typename T>
__device__ __forceinline__ V3<T> vsub(const V3<T>& a, const V3<T>& b) {
  V3<T> c;
#pragma unroll
  for (int r = 0; r < 3; ++r) c.a[r] = a.a[r] - b.a[r];
  return c;
}

// Adjugate inverse; bad = 1 where the determinant is tiny or not finite.
template <typename T>
__device__ __forceinline__ M3<T> inv33(const M3<T>& M, T& bad) {
  const T a = M.a[0][0], b = M.a[0][1], c = M.a[0][2];
  const T d = M.a[1][0], e = M.a[1][1], f = M.a[1][2];
  const T g = M.a[2][0], h = M.a[2][1], i = M.a[2][2];
  const T A = e * i - f * h;
  const T B = f * g - d * i;
  const T C = d * h - e * g;
  const T det = a * A + b * B + c * C;
  const bool good = (fabs(det) > mo::Tiny<T>::value()) && isfinite(det);
  bad = good ? T(0) : T(1);
  const T inv_det = T(1) / (good ? det : T(1));
  const T adj[3][3] = {
      {A, c * h - b * i, b * f - c * e},
      {B, a * i - c * g, c * d - a * f},
      {C, b * g - a * h, a * e - b * d},
  };
  M3<T> R;
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int s = 0; s < 3; ++s) R.a[r][s] = adj[r][s] * inv_det;
  return R;
}

template <typename T>
__device__ __forceinline__ M3<T> load_m(Col<T> c, int row) {
  M3<T> M;
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int s = 0; s < 3; ++s) M.a[r][s] = c[row + 3 * r + s];
  return M;
}

template <typename T>
__device__ __forceinline__ void store_m(Col<T> c, int row, const M3<T>& M) {
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int s = 0; s < 3; ++s) c[row + 3 * r + s] = M.a[r][s];
}

template <typename T>
__device__ __forceinline__ V3<T> load_v(Col<T> c, int row) {
  return V3<T>{{c[row], c[row + 1], c[row + 2]}};
}

template <typename T>
__device__ __forceinline__ void store_v(Col<T> c, int row, const V3<T>& v) {
#pragma unroll
  for (int r = 0; r < 3; ++r) c[row + r] = v.a[r];
}

// The scratch blocks of one lane during a solve.
template <typename T>
struct Lane {
  Col<T> s;  // scratch column
  Layout L;
  __device__ M3<T> D(int p) const { return load_m(s, L.D + 9 * p); }
  __device__ M3<T> U(int t) const { return load_m(s, L.U + 9 * t); }
  __device__ M3<T> Cb(int j) const { return load_m(s, L.Cb + 9 * j); }
  __device__ M3<T> ZW(int p, int c) const { return load_m(s, L.ZW + 18 * p + 9 * c); }
  __device__ V3<T> zy(int p) const { return load_v(s, L.zy + 3 * p); }
  // The damped diagonal block Dd[p] = D[p] + lam I and b[p] = -g[p].
  __device__ M3<T> Dd(int p, T lam) const {
    M3<T> M = D(p);
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int c = 0; c < 3; ++c) M.a[r][c] = M.a[r][c] + (r == c ? lam : T(0));
    return M;
  }
  __device__ V3<T> b(int p) const {
    return V3<T>{{-s[L.g + 3 * p], -s[L.g + 3 * p + 1], -s[L.g + 3 * p + 2]}};
  }
};

__device__ __forceinline__ void edge_ij(const Topology& tp, int e, int& i, int& j) {
  if (e < tp.n - 1) {
    i = e;
    j = e + 1;
  } else {
    i = tp.cl_from[e - (tp.n - 1)];
    j = tp.cl_to[e - (tp.n - 1)];
  }
}

// f = 0.5 ||r||^2 over all edges and the anchor, at the poses in rows
// [x0, x0 + 3N) of column xs.
template <typename T>
__device__ T errors(const Topology& tp, Col<T> xs, int x0, Col<const T> data) {
  const int E = tp.n - 1 + tp.n_cl;
  T f = T(0);
  for (int e = 0; e < E; ++e) {
    int i, j;
    edge_ij(tp, e, i, j);
    const T xi = xs[x0 + 3 * i], yi = xs[x0 + 3 * i + 1], thi = xs[x0 + 3 * i + 2];
    const T xj = xs[x0 + 3 * j], yj = xs[x0 + 3 * j + 1], thj = xs[x0 + 3 * j + 2];
    const T c = cos(thi), s = sin(thi);
    const T dxw = xj - xi, dyw = yj - yi;
    const T rx = c * dxw + s * dyw - data[3 * e];
    const T ry = -s * dxw + c * dyw - data[3 * e + 1];
    const T rt = wrap(thj - thi - data[3 * e + 2]);
    const T term = T(0.5) * (rx * rx + ry * ry + rt * rt);
    f = e == 0 ? term : f + term;
  }
  const T ax = xs[x0], ay = xs[x0 + 1], at = wrap(xs[x0 + 2]);
  return f + T(tp.half_wa2) * (ax * ax + ay * ay + at * at);
}

// Gauss-Newton blocks at x (rows [0, 3N) of xs) into the lane's scratch:
// D, U, the closure blocks Cb[j] = block(min_j, max_j), the gradient g.
// Returns the cost.
template <typename T>
__device__ T linearize(const Topology& tp, Col<T> xs, Col<const T> data, const Lane<T>& ln) {
  const int N = tp.n, E = N - 1 + tp.n_cl;
  const T zero = T(0), one = T(1);
  Col<T> s = ln.s;
  for (int q = 0; q < 9 * N; ++q) s[ln.L.D + q] = zero;
  for (int q = 0; q < 9 * (N - 1); ++q) s[ln.L.U + q] = zero;
  for (int q = 0; q < 9 * tp.n_cl; ++q) s[ln.L.Cb + q] = zero;
  for (int q = 0; q < 3 * N; ++q) s[ln.L.g + q] = zero;
  T f = zero;
  for (int e = 0; e < E; ++e) {
    int i, j;
    edge_ij(tp, e, i, j);
    const T xi = xs[3 * i], yi = xs[3 * i + 1], thi = xs[3 * i + 2];
    const T xj = xs[3 * j], yj = xs[3 * j + 1], thj = xs[3 * j + 2];
    const T c = cos(thi), sn = sin(thi);
    const T dxw = xj - xi, dyw = yj - yi;
    const T rx_raw = c * dxw + sn * dyw;
    const T ry_raw = -sn * dxw + c * dyw;
    const V3<T> r{{rx_raw - data[3 * e], ry_raw - data[3 * e + 1], wrap(thj - thi - data[3 * e + 2])}};
    const T term = T(0.5) * (r.a[0] * r.a[0] + r.a[1] * r.a[1] + r.a[2] * r.a[2]);
    f = e == 0 ? term : f + term;
    const M3<T> Ji{{{-c, -sn, ry_raw}, {sn, -c, -rx_raw}, {zero, zero, -one}}};
    const M3<T> Jj{{{c, sn, zero}, {-sn, c, zero}, {zero, zero, one}}};
    const M3<T> JiTJi = mTm(Ji, Ji);
    const M3<T> JjTJj = mTm(Jj, Jj);
    const M3<T> JiTJj = mTm(Ji, Jj);
#pragma unroll
    for (int r_ = 0; r_ < 3; ++r_)
#pragma unroll
      for (int s_ = 0; s_ < 3; ++s_) {
        s[ln.L.D + 9 * i + 3 * r_ + s_] = s[ln.L.D + 9 * i + 3 * r_ + s_] + JiTJi.a[r_][s_];
        s[ln.L.D + 9 * j + 3 * r_ + s_] = s[ln.L.D + 9 * j + 3 * r_ + s_] + JjTJj.a[r_][s_];
      }
    if (e < N - 1) {
#pragma unroll
      for (int r_ = 0; r_ < 3; ++r_)
#pragma unroll
        for (int s_ = 0; s_ < 3; ++s_)
          s[ln.L.U + 9 * e + 3 * r_ + s_] = s[ln.L.U + 9 * e + 3 * r_ + s_] + JiTJj.a[r_][s_];
    } else {
      const int cb = ln.L.Cb + 9 * (e - (N - 1));
#pragma unroll
      for (int r_ = 0; r_ < 3; ++r_)
#pragma unroll
        for (int s_ = 0; s_ < 3; ++s_)
          s[cb + 3 * r_ + s_] = s[cb + 3 * r_ + s_] + (i > j ? JiTJj.a[s_][r_] : JiTJj.a[r_][s_]);
    }
    const V3<T> gi = mTv(Ji, r);
    const V3<T> gj = mTv(Jj, r);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      s[ln.L.g + 3 * i + k] = s[ln.L.g + 3 * i + k] + gi.a[k];
      s[ln.L.g + 3 * j + k] = s[ln.L.g + 3 * j + k] + gj.a[k];
    }
  }
  const T ax = xs[0], ay = xs[1], at = wrap(xs[2]);
  f = f + T(tp.half_wa2) * (ax * ax + ay * ay + at * at);
  const T wa2 = T(tp.wa2);
#pragma unroll
  for (int k = 0; k < 3; ++k) s[ln.L.D + 4 * k] = s[ln.L.D + 4 * k] + wa2;
  s[ln.L.g + 0] = s[ln.L.g + 0] + wa2 * ax;
  s[ln.L.g + 1] = s[ln.L.g + 1] + wa2 * ay;
  s[ln.L.g + 2] = s[ln.L.g + 2] + wa2 * at;
  return f;
}

// The coupling block(p, q) of pose p in a segment with the border pose of
// its column c, where the JAX kernel's Brow holds one; false where it holds
// none (the sweep then reads a zero block).
template <typename T, int K>
__device__ __forceinline__ bool brow(const Topology& tp, const Lane<T>& ln, int p, int q, int lo, int hi,
                                     M3<T>& out) {
  if constexpr (K == 1) {
    // One border a = the closure's lower endpoint; the closure's other
    // endpoint bb couples to a, adding where it is a's chain neighbour.
    const int a = tp.border[0];
    const int bb = tp.cl_from[0] > tp.cl_to[0] ? tp.cl_from[0] : tp.cl_to[0];
    bool present = false;
    if (a >= 1 && p == a - 1) {
      out = ln.U(a - 1);
      present = true;
    }
    if (p == a + 1) {
      out = mT(ln.U(a));
      present = true;
    }
    if (p == bb) {
      out = madd(present ? out : zero33<T>(), mT(ln.Cb(0)));
      present = true;
    }
    return present;
  } else {
    if (q == lo - 1 && p == lo) {
      out = mT(ln.U(lo - 1));  // block(seg0, left)
      return true;
    }
    if (q == hi + 1 && p == hi) {
      out = ln.U(hi);  // block(seg_last, right)
      return true;
    }
    return false;
  }
}

// Block-Thomas forward and backward sweep over poses lo..hi with ncol
// border columns (border poses cols[]): leaves dinv in D[p], y in zy[p] and
// the column blocks W in ZW[p]. Returns the sweep's bad flag.
template <typename T, int K>
__device__ T sweep(const Topology& tp, const Lane<T>& ln, int lo, int hi, int ncol, const int (&cols)[2], T lam) {
  Col<T> s = ln.s;
  T bad = T(0);
  for (int p = lo; p <= hi; ++p) {
    M3<T> dk;
    V3<T> zk;
    M3<T> Zk[2];
    if (p == lo) {
      dk = ln.Dd(p, lam);
      zk = ln.b(p);
      for (int c = 0; c < ncol; ++c) {
        M3<T> B;
        Zk[c] = brow<T, K>(tp, ln, p, cols[c], lo, hi, B) ? B : zero33<T>();
      }
    } else {
      const M3<T> Upp = ln.U(p - 1);
      const M3<T> dinv_pp = ln.D(p - 1);
      dk = msub(ln.Dd(p, lam), mTm(Upp, mm(dinv_pp, Upp)));
      zk = vsub(ln.b(p), mTv(Upp, mv(dinv_pp, ln.zy(p - 1))));
      for (int c = 0; c < ncol; ++c) {
        M3<T> B;
        const M3<T> Brow = brow<T, K>(tp, ln, p, cols[c], lo, hi, B) ? B : zero33<T>();
        Zk[c] = msub(Brow, mTm(Upp, mm(dinv_pp, ln.ZW(p - 1, c))));
      }
    }
    T badk;
    const M3<T> inv = inv33(dk, badk);
    bad = mo::nmax(bad, badk);
    store_m(s, ln.L.D + 9 * p, inv);
    store_v(s, ln.L.zy + 3 * p, zk);
    for (int c = 0; c < ncol; ++c) store_m(s, ln.L.ZW + 18 * p + 9 * c, Zk[c]);
  }
  {
    const M3<T> dinv = ln.D(hi);
    store_v(s, ln.L.zy + 3 * hi, mv(dinv, ln.zy(hi)));
    for (int c = 0; c < ncol; ++c) store_m(s, ln.L.ZW + 18 * hi + 9 * c, mm(dinv, ln.ZW(hi, c)));
  }
  for (int p = hi - 1; p >= lo; --p) {
    const M3<T> dinv = ln.D(p);
    const M3<T> Up = ln.U(p);
    store_v(s, ln.L.zy + 3 * p, mv(dinv, vsub(ln.zy(p), mv(Up, ln.zy(p + 1)))));
    for (int c = 0; c < ncol; ++c)
      store_m(s, ln.L.ZW + 18 * p + 9 * c, mm(dinv, msub(ln.ZW(p, c), mm(Up, ln.ZW(p + 1, c)))));
  }
  return bad;
}

template <typename T>
__device__ __forceinline__ T finite_flag(const Topology& tp, const Lane<T>& ln, T bad) {
  bool fin = true;
  for (int q = 0; q < 3 * tp.n; ++q) fin = fin && isfinite(ln.s[ln.L.dx + q]);
  return mo::nmax(bad, fin ? T(0) : T(1));
}

// Segment s's border columns, left then right: returns their count.
__device__ __forceinline__ int seg_cols(const Topology& tp, int sg, int (&cols)[2]) {
  int nc = 0;
  if (tp.seg_lo[sg] - 1 >= 0) cols[nc++] = tp.seg_lo[sg] - 1;
  if (tp.seg_hi[sg] + 1 <= tp.n - 1) cols[nc++] = tp.seg_hi[sg] + 1;
  return nc;
}

// (H + lam I) dx = -g for one closure: dx into the scratch; returns bad.
template <typename T>
__device__ T bordered_solve(const Topology& tp, const Lane<T>& ln, T lam) {
  Col<T> s = ln.s;
  const int N = tp.n;
  const int a = tp.border[0];
  const int bb = tp.cl_from[0] > tp.cl_to[0] ? tp.cl_from[0] : tp.cl_to[0];
  const int cols[2] = {a, a};
  T bad = T(0);
  for (int sg = 0; sg < tp.n_seg; ++sg)
    bad = mo::nmax(bad, sweep<T, 1>(tp, ln, tp.seg_lo[sg], tp.seg_hi[sg], 1, cols, lam));

  // Schur complement on the border pose over the coupled poses, ascending:
  // S = A - sum_r C_r W_r with C_r = block(a, r).
  M3<T> S = ln.Dd(a, lam);
  V3<T> rhs0 = ln.b(a);
  for (int t = 0; t < 3; ++t) {
    int r;
    M3<T> C;
    if (t == 0) {
      if (a < 1) continue;
      r = a - 1;
      C = mT(ln.U(a - 1));
    } else if (t == 1) {
      r = a + 1;
      C = bb == a + 1 ? madd(ln.U(a), ln.Cb(0)) : ln.U(a);
    } else {
      if (bb == a + 1) continue;
      r = bb;
      C = madd(zero33<T>(), ln.Cb(0));
    }
    S = msub(S, mm(C, ln.ZW(r, 0)));
    rhs0 = vsub(rhs0, mv(C, ln.zy(r)));
  }
  T badS;
  const M3<T> Sinv = inv33(S, badS);
  bad = mo::nmax(bad, badS);
  const V3<T> dx0 = mv(Sinv, rhs0);
  store_v(s, ln.L.dx + 3 * a, dx0);
  for (int p = 0; p < N; ++p) {
    if (p == a) continue;
    store_v(s, ln.L.dx + 3 * p, vsub(ln.zy(p), mv(ln.ZW(p, 0), dx0)));
  }
  return finite_flag(tp, ln, bad);
}

template <int K>
__device__ __forceinline__ int border_index(const Topology& tp, int p) {
#pragma unroll
  for (int i = 0; i < K; ++i)
    if (tp.border[i] == p) return i;
  return -1;
}

template <typename T, int K>
__device__ __forceinline__ void add_block(T (&H)[3 * K][3 * K], int i, int j, const M3<T>& M, bool sub) {
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c)
      H[3 * i + r][3 * j + c] = sub ? H[3 * i + r][3 * j + c] - M.a[r][c] : H[3 * i + r][3 * j + c] + M.a[r][c];
}

// (H + lam I) dx = -g for several closures, K border poses: dx into the
// scratch; returns bad.
template <typename T, int K>
__device__ T bordered_solve_multi(const Topology& tp, const Lane<T>& ln, T lam) {
  constexpr int DK = 3 * K;
  Col<T> s = ln.s;
  T bad = T(0);
  for (int sg = 0; sg < tp.n_seg; ++sg) {
    int cols[2] = {0, 0};
    const int nc = seg_cols(tp, sg, cols);
    bad = mo::nmax(bad, sweep<T, K>(tp, ln, tp.seg_lo[sg], tp.seg_hi[sg], nc, cols, lam));
  }

  // The borders' Schur system: direct couplings (chain edges between
  // adjacent borders, closure blocks) minus the segment eliminations.
  T H[DK][DK];
  T rhs[DK];
  for (int i = 0; i < K; ++i) {
    const V3<T> bi = ln.b(tp.border[i]);
    for (int r = 0; r < 3; ++r) rhs[3 * i + r] = bi.a[r];
    for (int j = 0; j < K; ++j) {
      const M3<T> M = i == j ? ln.Dd(tp.border[i], lam) : zero33<T>();
      for (int r = 0; r < 3; ++r)
        for (int c = 0; c < 3; ++c) H[3 * i + r][3 * j + c] = M.a[r][c];
    }
  }
  for (int i = 0; i + 1 < K; ++i) {
    const int p = tp.border[i];
    if (tp.border[i + 1] != p + 1) continue;
    const M3<T> Up = ln.U(p);
    add_block<T, K>(H, i, i + 1, Up, false);
    add_block<T, K>(H, i + 1, i, mT(Up), false);
  }
  for (int jc = 0; jc < tp.n_cl; ++jc) {
    const int f = tp.cl_from[jc], t = tp.cl_to[jc];
    const int lo = border_index<K>(tp, f < t ? f : t), hi = border_index<K>(tp, f < t ? t : f);
    const M3<T> Cb = ln.Cb(jc);
    add_block<T, K>(H, lo, hi, Cb, false);
    add_block<T, K>(H, hi, lo, mT(Cb), false);
  }
  for (int sg = 0; sg < tp.n_seg; ++sg) {
    int cols[2] = {0, 0};
    const int nc = seg_cols(tp, sg, cols);
    const int lo = tp.seg_lo[sg], hi = tp.seg_hi[sg];
    for (int cp = 0; cp < nc; ++cp) {
      const int P = cols[cp];
      const bool left = P == lo - 1;
      const int r_p = left ? lo : hi;
      const M3<T> C = left ? ln.U(P) : mT(ln.U(hi));  // block(P, r_p)
      const int iP = border_index<K>(tp, P);
      const V3<T> cy = mv(C, ln.zy(r_p));
      for (int r = 0; r < 3; ++r) rhs[3 * iP + r] = rhs[3 * iP + r] - cy.a[r];
      for (int cq = 0; cq < nc; ++cq)
        add_block<T, K>(H, iP, border_index<K>(tp, cols[cq]), mm(C, ln.ZW(r_p, cq)), true);
    }
  }

  T L[DK][DK];
  T d[DK];
  mo::ldlt_factor<T, DK>(H, L, d);
  bad = mo::nmax(bad, mo::ldlt_bad<T, DK>(d));
  mo::ldlt_apply<T, DK>(L, d, rhs);
  for (int i = 0; i < K; ++i) store_v(s, ln.L.dx + 3 * tp.border[i], V3<T>{{rhs[3 * i], rhs[3 * i + 1], rhs[3 * i + 2]}});
  for (int sg = 0; sg < tp.n_seg; ++sg) {
    int cols[2] = {0, 0};
    const int nc = seg_cols(tp, sg, cols);
    for (int p = tp.seg_lo[sg]; p <= tp.seg_hi[sg]; ++p) {
      V3<T> xp = ln.zy(p);
      for (int cq = 0; cq < nc; ++cq) {
        const int iQ = border_index<K>(tp, cols[cq]);
        xp = vsub(xp, mv(ln.ZW(p, cq), V3<T>{{rhs[3 * iQ], rhs[3 * iQ + 1], rhs[3 * iQ + 2]}}));
      }
      store_v(s, ln.L.dx + 3 * p, xp);
    }
  }
  return finite_flag(tp, ln, bad);
}

// The whole solve of lane `lane`: x lives in the output column, the blocks
// in the scratch column.
template <typename T, int K>
__global__ void __launch_bounds__(kBlock)
    pose_ring_kernel(Topology tp, const T* __restrict__ data, const T* __restrict__ x0,
                     T* __restrict__ x_out, T* __restrict__ state, T* __restrict__ scratch, int B,
                     int max_iterations, int ls_iterations) {
  const int lane = blockIdx.x * kBlock + threadIdx.x;
  if (lane >= B) return;
  const size_t stride = static_cast<size_t>(B);
  const int N = tp.n;
  const Col<const T> dat{data + lane, stride};
  const Col<T> xs{x_out + lane, stride};
  const Lane<T> ln{Col<T>{scratch + lane, stride}, Layout(N, tp.n_cl)};
  const Col<T> s = ln.s;
  const int nx = 3 * N;
  const T zero = T(0), one = T(1);

  for (int q = 0; q < nx; ++q) {
    const T v = x0[static_cast<size_t>(q) * stride + lane];
    xs[q] = v;
    s[ln.L.best + q] = v;
  }
  T lam = zero, restore = zero, f_best = T(INFINITY);
  T fac_bad = zero, lam_maxed = zero, accepted = zero, f_acc = zero, f_pre = zero;
  for (int it = 0; it < max_iterations; ++it) {
    f_pre = linearize(tp, xs, dat, ln);
    if (f_pre < f_best) {
      for (int q = 0; q < nx; ++q) s[ln.L.best + q] = xs[q];
      f_best = f_pre;
    }
    T bad;
    if constexpr (K == 1) {
      bad = bordered_solve(tp, ln, lam);
    } else {
      bad = bordered_solve_multi<T, K>(tp, ln, lam);
    }
    fac_bad = mo::nmax(fac_bad, bad);
    T dd = zero;
    for (int q = 0; q < nx; ++q) dd = dd + s[ln.L.g + q] * s[ln.L.dx + q];

    T alpha = one;
    accepted = zero;
    for (int q = 0; q < nx; ++q) s[ln.L.bx + q] = xs[q];
    f_acc = f_pre;
    for (int probe = 0; probe <= ls_iterations; ++probe) {
      if (probe > 0) alpha = alpha * T(0.5);
      for (int q = 0; q < nx; ++q) s[ln.L.cand + q] = xs[q] + alpha * s[ln.L.dx + q];
      const T f_c = errors(tp, s, ln.L.cand, dat);
      const T ok = (f_c <= f_pre + T(1e-4) * alpha * mo::nmin(dd, zero)) ? one : zero;
      const T take = ok * (one - accepted);
      for (int q = 0; q < nx; ++q)
        s[ln.L.bx + q] = take * s[ln.L.cand + q] + (one - take) * s[ln.L.bx + q];
      f_acc = take * f_c + (one - take) * f_acc;
      accepted = mo::nmin(accepted + take, one);
    }
    if (accepted > zero)
      for (int q = 0; q < nx; ++q) xs[q] = s[ln.L.bx + q];
    // Lambda machine at NLSParams defaults (nonlinear.cc:296-343).
    const T lam_succ = mo::nmax(lam * (restore > zero ? T(0.8) : T(0.1)), zero);
    const T lam_fail = restore > zero ? lam * T(10.0) : mo::nmax(T(1e-2) * one, lam * T(10.0));
    lam_maxed = (accepted == zero && lam >= one) ? one : lam_maxed;
    lam = mo::nmin(accepted > zero ? lam_succ : lam_fail, one);
    restore = accepted > zero ? zero : one;
  }
  const T f_fin = accepted > zero ? f_acc : f_pre;
  const bool better = f_fin < f_best;
  if (!better)
    for (int q = 0; q < nx; ++q) xs[q] = s[ln.L.best + q];
  state[lane] = better ? f_fin : f_best;
  state[stride + lane] = zero;
  state[2 * stride + lane] = fac_bad + T(2.0) * lam_maxed;
}

struct LaunchArgs {
  const void* data;
  const void* x0;
  void* x_out;
  void* state;
  void* scratch;
  int B;
  int max_iterations;
  int ls_iterations;
  cudaStream_t stream;
};

template <typename T, int K>
int launch(const Topology& tp, const LaunchArgs& a) {
  const int grid = (a.B + kBlock - 1) / kBlock;
  pose_ring_kernel<T, K><<<grid, kBlock, 0, a.stream>>>(
      tp, static_cast<const T*>(a.data), static_cast<const T*>(a.x0), static_cast<T*>(a.x_out),
      static_cast<T*>(a.state), static_cast<T*>(a.scratch), a.B, a.max_iterations, a.ls_iterations);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_k(const Topology& tp, const LaunchArgs& a) {
  switch (tp.k) {
    case 1: return launch<T, 1>(tp, a);
    case 2: return launch<T, 2>(tp, a);
    case 3: return launch<T, 3>(tp, a);
    case 4: return launch<T, 4>(tp, a);
    case 5: return launch<T, 5>(tp, a);
    case 6: return launch<T, 6>(tp, a);
    default: return mo::kNoInstance;
  }
}

// The instances of one dtype, each built in its own source file so that
// the two compile in parallel: pose_ring.cu (float), pose_ring_f64.cu
// (double).
int launch_float(const Topology& tp, const LaunchArgs& a);
int launch_double(const Topology& tp, const LaunchArgs& a);

}  // namespace mo::ring
