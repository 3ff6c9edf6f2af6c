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
// What bounds it on this card: one instance's dependent chain. An instance
// reads 3E + 3N scalars and writes 3N + 3, but runs some ninety thousand
// floating-point operations at N = 16 (chip_smoke.py counts them from the
// plain version), most of them in the sweep, whose pose steps depend on one
// another, and in sin / cos, division and the angle wrap.
//
// What the design does about it: one warp per graph, W graphs per CTA
// (ops/pose_ring.py::launch_plan: 4, fewer where 4 slabs do not fit
// 232,448 bytes), the grid ceil(B / W). The graph's Layout slots (the
// iterate, its best and blend, the step, the gradient, the per-pose blocks,
// the measurements and a terms area) are the warp's slab of dynamic shared
// memory (4,176 B at N = 16 in float); past one CTA, the launcher passes an
// instance-major global scratch array and the same code runs on it (the
// route is a template argument, so that a shared slab compiles to shared
// loads and stores). N is a run-time value, so one build serves every ring
// size and topology; the topology is a small schedule passed by value, and
// the multi-closure Schur system a template on the border count k. The
// float single-closure instance is held to 80 registers (24 graphs an SM).
// - Linearization: lane e takes edge e (sin, cos, residual, cost term) and
//   writes its values to the terms area; then lane p builds pose p's
//   diagonal block and gradient, chain block U(p) and closure block p from
//   the 3x3 products of its edges, added in edge order from 0.
// - The sweep stays sequential in pose order. Within a pose step the
//   pivot block's 9 entries, the right-hand side's 3 and each border
//   column's 9 are spread over the lanes in two levels of 3-term products
//   (operands by __shfl_sync from the lane that made them, the rest loaded
//   a step ahead); every lane inverts the pivot block alike, so the next
//   step's operands are in its registers. The back substitution passes each
//   step's values by shuffle. With k >= 2 borders, lane i builds and
//   factors row i of the borders' 3k x 3k Schur system. Past kMaxBorders
//   borders or kMaxClosures closures (the run-time route, K = 0: any
//   topology), the schedule is a device table (TopoTable) and the Schur
//   system lives in the slab, rows l, l + 32, ... on lane l, factored column
//   by column in the same order (bordered_solve_rt).
// - The line-search probes are independent (the plain version evaluates
//   each and blends), so their edge terms are evaluated together, up to
//   kProbeChunk probes a round; then the Armijo tests, the takes and the
//   blend run in probe order.
// - Every sum's terms go to slots and every lane reads them back in index
//   order (four at a time, padded with -0), so every per-instance decision
//   (the lambda machine, accept, the best iterate) is warp-uniform.
//   In the sweep every lane stores every step (lanes without a part to a
//   dummy slot) and no lane reads a slot another lane writes in the same
//   pass, so its loops need no __syncwarp.
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

constexpr int kWarp = 32;
constexpr unsigned kAll = 0xffffffffu;
constexpr int kMaxWarps = 4;  // graphs (warps) per CTA
constexpr int kMaxSmem = 232448;  // dynamic shared memory one CTA may hold
constexpr int kMaxClosures = 16;
constexpr int kMaxBorders = 6;
constexpr int kMaxSegments = kMaxBorders + 1;
constexpr int kEdgeValues = 8;  // c, s, rx, ry, r0, r1, r2, cost term
constexpr int kProbeChunk = kEdgeValues;  // line-search probes per round
constexpr double kPi = 3.141592653589793;

// The topology as a schedule: closures in declaration order, the border
// poses ascending (one closure: its lower endpoint; several: every
// endpoint), and the chain segments between them in ascending order. Up to
// kMaxClosures closures and kMaxBorders borders the schedule is passed by
// value and the Schur system is a template on k; past them (TopoTable) its
// arrays are a small device table and k a run-time value.
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

// The same schedule with run-time sizes: its arrays point into one device
// table [cl_from (n_cl), cl_to (n_cl), border (k), seg_lo (n_seg), seg_hi
// (n_seg)] that the caller keeps (ops/pose_ring.py::ring_schedule).
struct TopoTable {
  int n;
  int n_cl;
  const int* cl_from;
  const int* cl_to;
  int k;
  const int* border;
  int n_seg;
  const int* seg_lo;
  const int* seg_hi;
  double wa2;
  double half_wa2;
};

__host__ __device__ inline int round4(int k) { return (k + 3) & ~3; }

// One instance's slots, each array from a 4-slot (16-byte) boundary: the
// iterate x, the best iterate, the line search's blend bx, the step dx, the
// gradient g, z / y of the sweep (3N each); D (9N: the diagonal blocks; the
// sweep replaces a non-border pose's block by its inverse); U (9 per chain
// edge); ZW (18N: two border columns per pose); 9 per closure; the 3E
// measurements; the terms area: kEdgeValues rows of e4 = round4(E) slots
// (the linearization's per-edge values; a line-search round's cost terms,
// one row per probe; the terms of g . dx). With kr > 0 border poses on the
// run-time route, the borders' 3kr x 3kr Schur system (row-major, factored
// in place), its right-hand side / solution and its pivots follow.
struct Layout {
  int x, best, bx, dx, g, zy, D, U, ZW, Cb, meas, terms, e4, Sh, Sy, Sd, total;
  __host__ __device__ static int take(int& o, int n) {
    const int at = o;
    o += round4(n);
    return at;
  }
  __host__ __device__ Layout(int n, int n_cl, int kr = 0) {
    const int E = n - 1 + n_cl;
    e4 = round4(E);
    int o = 0;
    x = take(o, 3 * n);
    best = take(o, 3 * n);
    bx = take(o, 3 * n);
    dx = take(o, 3 * n);
    g = take(o, 3 * n);
    zy = take(o, 3 * n);
    D = take(o, 9 * n);
    U = take(o, 9 * (n - 1));
    ZW = take(o, 18 * n);
    Cb = take(o, 9 * n_cl);
    meas = take(o, 3 * E);
    terms = take(o, kEdgeValues * e4);
    Sh = take(o, 9 * kr * kr);
    Sy = take(o, 3 * kr);
    Sd = take(o, 3 * kr);
    total = o;
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

// ((0 + a0 b0) + a1 b1) + a2 b2: every 3-term product of the plain
// version (mm, mTm, mv, mTv) in its order.
template <typename T>
__device__ __forceinline__ T dot3(T a0, T a1, T a2, T b0, T b1, T b2) {
  return ((T(0) + a0 * b0) + a1 * b1) + a2 * b2;
}

template <typename T>
__device__ __forceinline__ M3<T> mTm(const M3<T>& A, const M3<T>& B) {  // A^T B
  M3<T> C;
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int s = 0; s < 3; ++s) C.a[r][s] = dot3(A.a[0][r], A.a[1][r], A.a[2][r], B.a[0][s], B.a[1][s], B.a[2][s]);
  return C;
}

template <typename T>
__device__ __forceinline__ V3<T> mv(const M3<T>& A, const V3<T>& v) {
  V3<T> w;
#pragma unroll
  for (int r = 0; r < 3; ++r) w.a[r] = dot3(A.a[r][0], A.a[r][1], A.a[r][2], v.a[0], v.a[1], v.a[2]);
  return w;
}

template <typename T>
__device__ __forceinline__ V3<T> mTv(const M3<T>& A, const V3<T>& v) {
  V3<T> w;
#pragma unroll
  for (int r = 0; r < 3; ++r) w.a[r] = dot3(A.a[0][r], A.a[1][r], A.a[2][r], v.a[0], v.a[1], v.a[2]);
  return w;
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
__device__ __forceinline__ M3<T> load_m(const T* p) {
  M3<T> M;
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int s = 0; s < 3; ++s) M.a[r][s] = p[3 * r + s];
  return M;
}

template <typename T>
__device__ __forceinline__ V3<T> load_v(const T* p) {
  return V3<T>{{p[0], p[1], p[2]}};
}

// ---------------------------------------------------------------------------
// Warp helpers.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void warp_sync() { __syncwarp(kAll); }

template <typename T>
__device__ __forceinline__ T shfl(T v, int src) {
  return __shfl_sync(kAll, v, src);
}

// *at = v where p holds (a short guarded store: the compiler predicates it).
template <typename T>
__device__ __forceinline__ void put_if(bool p, T* at, T v) {
  if (p) *at = v;
}

// Four consecutive slots from a 16-byte boundary.
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x;
  v[1] = a.y;
  v[2] = a.z;
  v[3] = a.w;
}
__device__ __forceinline__ void load4(const double* p, double (&v)[4]) {
  const double2 a = *reinterpret_cast<const double2*>(p);
  const double2 b = *reinterpret_cast<const double2*>(p + 2);
  v[0] = a.x;
  v[1] = a.y;
  v[2] = b.x;
  v[3] = b.y;
}

// p[count .. round4(count)) = -0 (x + -0 is x for every x, +0 included),
// by lanes 0..2.
template <typename T>
__device__ __forceinline__ void pad4(T* p, int count, int lane) {
  const bool mine = count + lane < round4(count);
  put_if(mine, p + (mine ? count + lane : 0), T(-0.0));
}

// start + p[0] + p[1] + ... over round4(count) slots, padded with -0.
template <typename T>
__device__ __forceinline__ T sum4(T start, const T* p, int count) {
  T acc = start;
  for (int q0 = 0; q0 < count; q0 += 4) {
    T v[4];
    load4(p + q0, v);
#pragma unroll
    for (int q = 0; q < 4; ++q) acc = acc + v[q];
  }
  return acc;
}

// p[0] + p[1] + ... (count >= 1), from the first term, padded with -0.
template <typename T>
__device__ __forceinline__ T sum4_first(const T* p, int count) {
  T v[4];
  load4(p, v);
  T acc = v[0];
#pragma unroll
  for (int q = 1; q < 4; ++q) acc = acc + v[q];
  return sum4(acc, p + 4, count - 4);
}

// Phase spans: built with MO_RING_SPANS defined (scripts/
// pose_ring_kernel_times.py --spans), lane 0 of instance 0 adds the
// clock64() cycles of each phase of its solve to mo_ring_spans[phase]; the
// kernel's build has none of it.
enum Span { kSpanSetup, kSpanLinearize, kSpanSolve, kSpanStepDot, kSpanLineSearch, kSpanUpdate, kSpanOut, kSpans };
#ifdef MO_RING_SPANS
static __device__ unsigned long long mo_ring_spans[kSpans];
__device__ __forceinline__ long long span_now() {
#ifdef __CUDA_ARCH__
  return clock64();
#else
  return 0;
#endif
}
struct SpanClock {
  bool on;
  long long t;
  __device__ explicit SpanClock(bool o) : on(o), t(span_now()) {}
  __device__ void mark(int phase) {
    const long long now = span_now();
    if (on) mo_ring_spans[phase] += static_cast<unsigned long long>(now - t);
    t = now;
  }
};
#else
struct SpanClock {
  __device__ explicit SpanClock(bool) {}
  __device__ void mark(int) {}
};
#endif

// The CTA's dynamic shared memory: W slabs of Layout::total slots.
template <typename T>
__device__ __forceinline__ T* dyn_smem() {
  extern __shared__ __align__(16) unsigned char mo_ring_smem[];
  return reinterpret_cast<T*>(mo_ring_smem);
}

// ---------------------------------------------------------------------------
// One warp's solve.
// ---------------------------------------------------------------------------

// The warp's view of its instance: the topology, the slab and its layout.
template <typename T, class TP = Topology>
struct Ctx {
  const TP& tp;
  T* s;
  Layout L;
  int lane;
  int N, E;
  __device__ M3<T> ZW(int p, int c) const { return load_m(s + L.ZW + 18 * p + 9 * c); }
  __device__ V3<T> zy(int p) const { return load_v(s + L.zy + 3 * p); }
};

template <class TP>
__device__ __forceinline__ void edge_ij(const TP& tp, int e, int& i, int& j) {
  if (e < tp.n - 1) {
    i = e;
    j = e + 1;
  } else {
    i = tp.cl_from[e - (tp.n - 1)];
    j = tp.cl_to[e - (tp.n - 1)];
  }
}

// Edge e's values at poses xi, xj: cos and sin of theta_i, the raw
// rotated differences, the residual and the cost term 0.5 |r|^2.
template <typename T>
__device__ __forceinline__ void edge_values(T xi, T yi, T thi, T xj, T yj, T thj, const T* m, T (&v)[kEdgeValues]) {
  const T c = cos(thi), sn = sin(thi);
  const T dxw = xj - xi, dyw = yj - yi;
  const T rx_raw = c * dxw + sn * dyw;
  const T ry_raw = -sn * dxw + c * dyw;
  const T r0 = rx_raw - m[0], r1 = ry_raw - m[1], r2 = wrap(thj - thi - m[2]);
  v[0] = c;
  v[1] = sn;
  v[2] = rx_raw;
  v[3] = ry_raw;
  v[4] = r0;
  v[5] = r1;
  v[6] = r2;
  v[7] = T(0.5) * (r0 * r0 + r1 * r1 + r2 * r2);
}

// The edge Jacobians of the stored values: Ji (pose i) and Jj (pose j).
template <typename T>
__device__ __forceinline__ M3<T> jac_i(T c, T sn, T rx_raw, T ry_raw) {
  return M3<T>{{{-c, -sn, ry_raw}, {sn, -c, -rx_raw}, {T(0), T(0), -T(1)}}};
}
template <typename T>
__device__ __forceinline__ M3<T> jac_j(T c, T sn) {
  return M3<T>{{{c, sn, T(0)}, {-sn, c, T(0)}, {T(0), T(0), T(1)}}};
}

// The anchor's cost term at the pose (ax, ay, theta).
template <typename T, class TP>
__device__ __forceinline__ T anchor_term(const TP& tp, T ax, T ay, T ath) {
  const T at = wrap(ath);
  return T(tp.half_wa2) * (ax * ax + ay * ay + at * at);
}

// Gauss-Newton blocks at x into the slab: D, U, the closure blocks Cb[j]
// = block(min_j, max_j), the gradient g. Returns the cost on every lane.
template <typename T, class TP>
__device__ __forceinline__ T linearize(const Ctx<T, TP>& cx) {
  const TP& tp = cx.tp;
  T* s = cx.s;
  const Layout& L = cx.L;
  const int N = cx.N, E = cx.E, lane = cx.lane;
  const T* x = s + L.x;
  T* val = s + L.terms;  // value k of edge e at val[k * e4 + e]
  for (int e = lane; e < E; e += kWarp) {
    int i, j;
    edge_ij(tp, e, i, j);
    T v[kEdgeValues];
    edge_values(x[3 * i], x[3 * i + 1], x[3 * i + 2], x[3 * j], x[3 * j + 1], x[3 * j + 2], s + L.meas + 3 * e, v);
#pragma unroll
    for (int k = 0; k < kEdgeValues; ++k) val[k * L.e4 + e] = v[k];
  }
  pad4(val + 7 * L.e4, E, lane);
  warp_sync();
  // Lane t: pose t's D and g from its edges in edge order (chain edge t - 1
  // as j, chain edge t as i, then the closures), chain block U(t) and
  // closure block t.
  const T zero = T(0);
  const int rows = N > tp.n_cl ? N : tp.n_cl;
  for (int t = lane; t < rows; t += kWarp) {
    auto edge = [&](int e, T& c, T& sn, T& rx, T& ry, V3<T>& r) {
      c = val[e];
      sn = val[L.e4 + e];
      rx = val[2 * L.e4 + e];
      ry = val[3 * L.e4 + e];
      r = V3<T>{{val[4 * L.e4 + e], val[5 * L.e4 + e], val[6 * L.e4 + e]}};
    };
    if (t < N) {
      M3<T> Dp = zero33<T>();
      V3<T> gp{{zero, zero, zero}};
      T c, sn, rx, ry;
      V3<T> r;
      if (t >= 1) {  // chain edge t - 1: pose t is its j
        edge(t - 1, c, sn, rx, ry, r);
        const M3<T> Jj = jac_j(c, sn);
        Dp = madd(Dp, mTm(Jj, Jj));
        const V3<T> gj = mTv(Jj, r);
#pragma unroll
        for (int k = 0; k < 3; ++k) gp.a[k] = gp.a[k] + gj.a[k];
      }
      if (t <= N - 2) {  // chain edge t: pose t is its i
        edge(t, c, sn, rx, ry, r);
        const M3<T> Ji = jac_i(c, sn, rx, ry);
        Dp = madd(Dp, mTm(Ji, Ji));
        const V3<T> gi = mTv(Ji, r);
#pragma unroll
        for (int k = 0; k < 3; ++k) gp.a[k] = gp.a[k] + gi.a[k];
      }
      for (int jc = 0; jc < tp.n_cl; ++jc) {
        const bool is_i = tp.cl_from[jc] == t, is_j = tp.cl_to[jc] == t;
        if (!(is_i || is_j)) continue;
        edge(N - 1 + jc, c, sn, rx, ry, r);
        const M3<T> J = is_i ? jac_i(c, sn, rx, ry) : jac_j(c, sn);
        Dp = madd(Dp, mTm(J, J));
        const V3<T> gq = mTv(J, r);
#pragma unroll
        for (int k = 0; k < 3; ++k) gp.a[k] = gp.a[k] + gq.a[k];
      }
      if (t == 0) {  // the anchor
        const T wa2 = T(tp.wa2);
        const T ax = x[0], ay = x[1], at = wrap(x[2]);
#pragma unroll
        for (int k = 0; k < 3; ++k) Dp.a[k][k] = Dp.a[k][k] + wa2;
        gp.a[0] = gp.a[0] + wa2 * ax;
        gp.a[1] = gp.a[1] + wa2 * ay;
        gp.a[2] = gp.a[2] + wa2 * at;
      }
      T* dp = s + L.D + 9 * t;
#pragma unroll
      for (int q = 0; q < 9; ++q) dp[q] = Dp.a[q / 3][q % 3];
#pragma unroll
      for (int k = 0; k < 3; ++k) s[L.g + 3 * t + k] = gp.a[k];
      if (t <= N - 2) {  // U(t) = block(t, t + 1)
        const T cu = val[t], su = val[L.e4 + t];
        const M3<T> Ut = madd(zero33<T>(), mTm(jac_i(cu, su, val[2 * L.e4 + t], val[3 * L.e4 + t]), jac_j(cu, su)));
        T* up = s + L.U + 9 * t;
#pragma unroll
        for (int q = 0; q < 9; ++q) up[q] = Ut.a[q / 3][q % 3];
      }
    }
    if (t < tp.n_cl) {  // closure t: block(i, j), stored as block(min, max)
      const int e = N - 1 + t;
      const T c = val[e], sn = val[L.e4 + e];
      const M3<T> P = mTm(jac_i(c, sn, val[2 * L.e4 + e], val[3 * L.e4 + e]), jac_j(c, sn));
      const bool flip = tp.cl_from[t] > tp.cl_to[t];
      T* cb = s + L.Cb + 9 * t;
#pragma unroll
      for (int q = 0; q < 9; ++q) cb[q] = T(0) + (flip ? P.a[q % 3][q / 3] : P.a[q / 3][q % 3]);
    }
  }
  const T f = sum4_first(val + 7 * L.e4, E);
  const T ax = x[0], ay = x[1];
  return f + anchor_term(tp, ax, ay, x[2]);
}

// The coupling block(p, q) entry (r, c) of pose p in a segment with the
// border pose q of its column, where the JAX kernel's Brow holds one; 0
// where it holds none.
template <typename T, int K, class TP>
__device__ __forceinline__ T brow_entry(const Ctx<T, TP>& cx, int p, int q, int lo, int hi, int r, int c) {
  const T* s = cx.s;
  const Layout& L = cx.L;
  if constexpr (K == 1) {
    // One border a = the closure's lower endpoint; the closure's other
    // endpoint bb couples to a, adding where it is a's chain neighbour.
    // Selects, not branches, and every load in bounds.
    const int a = cx.tp.border[0];
    const int bb = cx.tp.cl_from[0] > cx.tp.cl_to[0] ? cx.tp.cl_from[0] : cx.tp.cl_to[0];
    const T u_left = s[L.U + 9 * (a >= 1 ? a - 1 : 0) + 3 * r + c];  // block(a - 1, a)
    const T u_right = s[L.U + 9 * a + 3 * c + r];                      // block(a + 1, a)
    const T cb = s[L.Cb + 3 * c + r];
    const bool left = a >= 1 && p == a - 1, right = p == a + 1;
    const T v = right ? u_right : (left ? u_left : T(0));
    return p == bb ? ((left || right) ? v : T(0)) + cb : v;
  } else {
    const T ul = s[L.U + 9 * (lo >= 1 ? lo - 1 : 0) + 3 * c + r];  // block(seg0, left)
    const T ur = s[L.U + 9 * (hi <= cx.N - 2 ? hi : 0) + 3 * r + c];  // block(seg_last, right)
    return (q == lo - 1 && p == lo) ? ul : ((q == hi + 1 && p == hi) ? ur : T(0));
  }
}

// A lane's part in a sweep with ncol border columns: lanes 0..8 the pivot
// block (entry (r, s) = (l / 3, l % 3)), lanes 9..11 the right-hand side
// (row r = l - 9), lanes 12.. 12 + 9 ncol - 1 the border column blocks
// (column c = (l - 12) / 9, entry (r, s)); the rest mirror lane 0 and store
// nothing. src(k) = src + k * src_step is the lane holding row k of this
// lane's column in the same part.
struct Part {
  int kind;  // 0 pivot block, 1 right-hand side, 2 border column, -1 none
  int r, s, c;
  int src, src_step;
};

__device__ __forceinline__ Part part_of(int lane, int ncol) {
  if (lane < 9) return Part{0, lane / 3, lane % 3, 0, lane % 3, 3};
  if (lane < 12) return Part{1, lane - 9, 0, 0, 9, 1};
  if (lane < 12 + 9 * ncol) {
    const int q = lane - 12;
    return Part{2, (q % 9) / 3, q % 3, q / 9, 12 + 9 * (q / 9) + q % 3, 3};
  }
  return Part{-1, 0, 0, 0, 0, 3};
}

// Block-Thomas forward and backward sweep over poses lo..hi with ncol
// border columns (border poses cols[]): leaves dinv in D[p], y in zy[p] and
// the column blocks W in ZW[p]. Returns the sweep's bad flag (uniform).
// A step's entries pass between lanes by shuffle, so the loops need no
// __syncwarp; the operands that do not depend on the elimination (U, D, g
// and the border couplings, which the sweep does not write) are loaded a
// step ahead. Every lane stores every step, lanes without a part to a slot
// of the terms area, which the sweep does not use.
template <typename T, int K, class TP>
__device__ __forceinline__ T sweep(const Ctx<T, TP>& cx, int lo, int hi, int ncol, const int (&cols)[2], T lam) {
  T* s = cx.s;
  const Layout& L = cx.L;
  const Part pt = part_of(cx.lane, ncol);
  const int q = cols[pt.c];
  const bool pivot = pt.kind == 0;
  // The lane's own slot at pose p: own + step p.
  const int own = pt.kind == 1 ? L.zy + pt.r : (pt.kind == 2 ? L.ZW + 9 * pt.c + 3 * pt.r + pt.s
                                                               : L.D + 3 * pt.r + pt.s);
  const int step = pt.kind == 1 ? 3 : (pt.kind == 2 ? 18 : 9);
  const int dummy = L.terms + cx.lane;
  const int src0 = pt.src, src1 = pt.src + pt.src_step, src2 = pt.src + 2 * pt.src_step;

  // Step p's operands that do not depend on the elimination: column s and
  // row entries (k, r) of Upp = U(p - 1), and the entry of the step's block
  // before the elimination -- Dd(p), b(p) or the border coupling (lanes
  // other than the pivot part read g, which the sweep does not write).
  struct Ops {
    T uc[3], ur[3], base;
  };
  auto fetch = [&](int p) {
    Ops o;
    const T* u = s + L.U + 9 * (p >= 1 ? p - 1 : 0);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      o.uc[k] = u[3 * k + pt.s];
      o.ur[k] = u[3 * k + pt.r];
    }
    const T v = s[pivot ? L.D + 9 * p + 3 * pt.r + pt.s : L.g + 3 * p + (pt.kind == 1 ? pt.r : 0)];
    const T d = v + (pt.r == pt.s ? lam : T(0));
    const T br = brow_entry<T, K>(cx, p, q, lo, hi, pt.r, pt.s);
    o.base = pt.kind == 1 ? -v : (pt.kind == 2 ? br : d);
    return o;
  };

  T bad = T(0);
  M3<T> R;  // the last pivot block's inverse, on every lane
  T prev;   // the lane's entry of the last step
  // Gather the pivot block, invert it on every lane, store the lane's entry.
  auto finish = [&](int p, T v) {
    M3<T> M;
#pragma unroll
    for (int e = 0; e < 9; ++e) M.a[e / 3][e % 3] = shfl(v, e);
    T badk;
    R = inv33(M, badk);
    bad = mo::nmax(bad, badk);
    const T r0 = pt.r == 0 ? R.a[0][0] : (pt.r == 1 ? R.a[1][0] : R.a[2][0]);
    const T r1 = pt.r == 0 ? R.a[0][1] : (pt.r == 1 ? R.a[1][1] : R.a[2][1]);
    const T r2 = pt.r == 0 ? R.a[0][2] : (pt.r == 1 ? R.a[1][2] : R.a[2][2]);
    const T inv_entry = pt.s == 0 ? r0 : (pt.s == 1 ? r1 : r2);
    s[pt.kind >= 0 ? own + step * p : dummy] = pivot ? inv_entry : v;
    prev = v;
  };

  Ops next = fetch(lo + 1 <= hi ? lo + 1 : lo);
  finish(lo, fetch(lo).base);
  for (int p = lo + 1; p <= hi; ++p) {
    const Ops o = next;
    next = fetch(p + 1 <= hi ? p + 1 : p);
    // Level 1: (dinv_pp Upp), (dinv_pp z_pp), (dinv_pp ZW_pp) entries; z_pp
    // and ZW_pp are the last step's entries of the lanes src0..2.
    const T a0 = pt.r == 0 ? R.a[0][0] : (pt.r == 1 ? R.a[1][0] : R.a[2][0]);
    const T a1 = pt.r == 0 ? R.a[0][1] : (pt.r == 1 ? R.a[1][1] : R.a[2][1]);
    const T a2 = pt.r == 0 ? R.a[0][2] : (pt.r == 1 ? R.a[1][2] : R.a[2][2]);
    const T b0 = shfl(prev, src0), b1 = shfl(prev, src1), b2 = shfl(prev, src2);
    const T m1 = dot3(a0, a1, a2, pivot ? o.uc[0] : b0, pivot ? o.uc[1] : b1, pivot ? o.uc[2] : b2);
    // Level 2: Upp^T times the level-1 block, subtracted from the base.
    finish(p, o.base - dot3(o.ur[0], o.ur[1], o.ur[2], shfl(m1, src0), shfl(m1, src1), shfl(m1, src2)));
  }
  warp_sync();  // dinv, z and ZW of the segment are in the slab

  // Back substitution: y(hi) = dinv z(hi), W(hi) = dinv ZW(hi); then
  // y(p) = dinv(p) (z(p) - U(p) y(p + 1)), W likewise, the entries passed
  // by shuffle. A lane reads and writes only its own slot of z and ZW (the
  // owners overwrite them in this pass); the pivot part only reads.
  struct Back {
    T own, u[3], d[3];
  };
  auto bfetch = [&](int p) {
    Back o;
    o.own = s[own + step * p];
    const T* ur = s + L.U + 9 * (p <= cx.N - 2 ? p : 0) + 3 * pt.r;  // U(p) row r
    const T* dr = s + L.D + 9 * p + 3 * pt.r;                         // dinv(p) row r
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      o.u[k] = ur[k];
      o.d[k] = dr[k];
    }
    return o;
  };
  auto back = [&](int p, const Back& o, T t) {
    const T y = dot3(o.d[0], o.d[1], o.d[2], shfl(t, src0), shfl(t, src1), shfl(t, src2));
    s[pt.kind >= 1 ? own + step * p : dummy] = y;
    return y;
  };
  Back bnext = bfetch(hi - 1 >= lo ? hi - 1 : hi);
  const Back bhi = bfetch(hi);
  T y = back(hi, bhi, bhi.own);
  for (int p = hi - 1; p >= lo; --p) {
    const Back o = bnext;
    bnext = bfetch(p - 1 >= lo ? p - 1 : p);
    y = back(p, o, o.own - dot3(o.u[0], o.u[1], o.u[2], shfl(y, src0), shfl(y, src1), shfl(y, src2)));
  }
  warp_sync();
  return bad;
}

// 1 where the bad flag is set or any step entry is not finite (uniform).
template <typename T, class TP>
__device__ __forceinline__ T finite_flag(const Ctx<T, TP>& cx, T bad) {
  bool fin = true;
  for (int q = cx.lane; q < 3 * cx.N; q += kWarp) fin = fin && isfinite(cx.s[cx.L.dx + q]);
  return mo::nmax(bad, __all_sync(kAll, fin) ? T(0) : T(1));
}

// Segment s's border columns, left then right: returns their count.
template <class TP>
__device__ __forceinline__ int seg_cols(const TP& tp, int sg, int (&cols)[2]) {
  int nc = 0;
  if (tp.seg_lo[sg] - 1 >= 0) cols[nc++] = tp.seg_lo[sg] - 1;
  if (tp.seg_hi[sg] + 1 <= tp.n - 1) cols[nc++] = tp.seg_hi[sg] + 1;
  return nc;
}

// (H + lam I) dx = -g for one closure: dx into the slab; returns bad.
template <typename T, class TP>
__device__ __forceinline__ T bordered_solve(const Ctx<T, TP>& cx, T lam) {
  const TP& tp = cx.tp;
  T* s = cx.s;
  const Layout& L = cx.L;
  const int a = tp.border[0];
  const int bb = tp.cl_from[0] > tp.cl_to[0] ? tp.cl_from[0] : tp.cl_to[0];
  const int cols[2] = {a, a};
  T bad = T(0);
  for (int sg = 0; sg < tp.n_seg; ++sg)
    bad = mo::nmax(bad, sweep<T, 1>(cx, tp.seg_lo[sg], tp.seg_hi[sg], 1, cols, lam));

  // Schur complement on the border pose over the coupled poses, ascending:
  // S = A - sum_r C_r W_r with C_r = block(a, r); lanes 0..8 the entries of
  // S, lanes 9..11 those of the right-hand side.
  const Part pt = part_of(cx.lane, 0);
  const int r = pt.r, c = pt.s;
  const T d0 = s[pt.kind == 1 ? L.g + 3 * a + r : L.D + 9 * a + 3 * r + c];
  T v = pt.kind == 1 ? -d0 : d0 + (r == c ? lam : T(0));
  for (int t = 0; t < 3; ++t) {
    int rp;
    T c0, c1, c2;  // row r of C
    if (t == 0) {
      if (a < 1) continue;
      rp = a - 1;
      const T* u = s + L.U + 9 * (a - 1) + r;
      c0 = u[0];
      c1 = u[3];
      c2 = u[6];
    } else if (t == 1) {
      rp = a + 1;
      const T* u = s + L.U + 9 * a + 3 * r;
      const T* cb = s + L.Cb + 3 * r;
      c0 = bb == a + 1 ? u[0] + cb[0] : u[0];
      c1 = bb == a + 1 ? u[1] + cb[1] : u[1];
      c2 = bb == a + 1 ? u[2] + cb[2] : u[2];
    } else {
      if (bb == a + 1) continue;
      rp = bb;
      const T* cb = s + L.Cb + 3 * r;
      c0 = T(0) + cb[0];
      c1 = T(0) + cb[1];
      c2 = T(0) + cb[2];
    }
    const T* w = pt.kind == 1 ? s + L.zy + 3 * rp : s + L.ZW + 18 * rp + c;  // rows 1 or 3 apart
    const int ws = pt.kind == 1 ? 1 : 3;
    v = v - dot3(c0, c1, c2, w[0], w[ws], w[2 * ws]);
  }
  M3<T> S;
#pragma unroll
  for (int e = 0; e < 9; ++e) S.a[e / 3][e % 3] = shfl(v, e);
  const V3<T> rhs0{{shfl(v, 9), shfl(v, 10), shfl(v, 11)}};
  T badS;
  const M3<T> Sinv = inv33(S, badS);
  bad = mo::nmax(bad, badS);
  const V3<T> dx0 = mv(Sinv, rhs0);
  for (int p = cx.lane; p < cx.N; p += kWarp) {
    T* d = s + L.dx + 3 * p;
    if (p == a) {
#pragma unroll
      for (int k = 0; k < 3; ++k) d[k] = dx0.a[k];
    } else {
      const V3<T> xp = vsub(cx.zy(p), mv(cx.ZW(p, 0), dx0));
#pragma unroll
      for (int k = 0; k < 3; ++k) d[k] = xp.a[k];
    }
  }
  warp_sync();
  return finite_flag(cx, bad);
}

template <int K, class TP>
__device__ __forceinline__ int border_index(const TP& tp, int p) {
#pragma unroll
  for (int i = 0; i < K; ++i)
    if (tp.border[i] == p) return i;
  return -1;
}

// The same for k = tp.k border poses at run time.
__device__ __forceinline__ int border_index_rt(const TopoTable& tp, int p) {
  for (int i = 0; i < tp.k; ++i)
    if (tp.border[i] == p) return i;
  return -1;
}

// (H + lam I) dx = -g for several closures, K border poses: dx into the
// slab; returns bad. Lane i < 3K owns row i of the borders' 3K x 3K Schur
// system (border i / 3, row i % 3): it builds the row in registers with
// every update the one-lane assembly makes, in the same order; the
// left-looking LDL^T of fused_sqp.cuh's ldlt_factor then runs column by
// column, lane i making L_ij from its row and row j's entries by shuffle,
// and the substitutions run lane by lane in ldlt_apply's order.
template <typename T, int K, class TP>
__device__ __forceinline__ T bordered_solve_multi(const Ctx<T, TP>& cx, T lam) {
  constexpr int DK = 3 * K;
  const TP& tp = cx.tp;
  T* s = cx.s;
  const Layout& L = cx.L;
  const int lane = cx.lane;
  T bad = T(0);
  for (int sg = 0; sg < tp.n_seg; ++sg) {
    int cols[2] = {0, 0};
    const int nc = seg_cols(tp, sg, cols);
    bad = mo::nmax(bad, sweep<T, K>(cx, tp.seg_lo[sg], tp.seg_hi[sg], nc, cols, lam));
  }

  // Row i of H (lanes past 3K mirror row 0 and store nothing).
  const int i = lane < DK ? lane : 0, bi = i / 3, r = i % 3;
  T h[DK];
  T y;
  {
    const int pb = tp.border[bi];
    const T* dr = s + L.D + 9 * pb + 3 * r;
#pragma unroll
    for (int j = 0; j < DK; ++j) h[j] = j / 3 == bi ? dr[j % 3] + (j % 3 == r ? lam : T(0)) : T(0);
    y = -s[L.g + 3 * pb + r];
  }
  // block(bi, bj) += M (row r of M: m[0..2]) where `on`.
  auto add_row = [&](bool on, int bj, T m0, T m1, T m2, bool sub) {
#pragma unroll
    for (int j = 0; j < DK; ++j) {
      const T m = j % 3 == 0 ? m0 : (j % 3 == 1 ? m1 : m2);
      const T v = sub ? h[j] - m : h[j] + m;
      h[j] = on && j / 3 == bj ? v : h[j];
    }
  };
  for (int i2 = 0; i2 + 1 < K; ++i2) {
    const int p = tp.border[i2];
    if (tp.border[i2 + 1] != p + 1) continue;
    const T* u = s + L.U + 9 * p;
    add_row(bi == i2, i2 + 1, u[3 * r], u[3 * r + 1], u[3 * r + 2], false);  // U(p)
    add_row(bi == i2 + 1, i2, u[r], u[3 + r], u[6 + r], false);              // U(p)^T
  }
  for (int jc = 0; jc < tp.n_cl; ++jc) {
    const int f = tp.cl_from[jc], t = tp.cl_to[jc];
    const int lo = border_index<K>(tp, f < t ? f : t), hi = border_index<K>(tp, f < t ? t : f);
    const T* cb = s + L.Cb + 9 * jc;
    add_row(bi == lo, hi, cb[3 * r], cb[3 * r + 1], cb[3 * r + 2], false);  // Cb
    add_row(bi == hi, lo, cb[r], cb[3 + r], cb[6 + r], false);              // Cb^T
  }
  for (int sg = 0; sg < tp.n_seg; ++sg) {
    int cols[2] = {0, 0};
    const int nc = seg_cols(tp, sg, cols);
    const int lo = tp.seg_lo[sg], hi = tp.seg_hi[sg];
    for (int cp = 0; cp < nc; ++cp) {
      const int P = cols[cp];
      const bool left = P == lo - 1;
      const int r_p = left ? lo : hi;
      const bool mine = bi == border_index<K>(tp, P);
      // Row r of C = block(P, r_p): U(P) row r, or U(hi)^T row r.
      const T* u = s + L.U + 9 * (left ? P : hi);
      const T c0 = left ? u[3 * r] : u[r], c1 = left ? u[3 * r + 1] : u[3 + r], c2 = left ? u[3 * r + 2] : u[6 + r];
      const T* z = s + L.zy + 3 * r_p;
      const T cy = dot3(c0, c1, c2, z[0], z[1], z[2]);
      y = mine ? y - cy : y;
      for (int cq = 0; cq < nc; ++cq) {
        const T* w = s + L.ZW + 18 * r_p + 9 * cq;
        add_row(mine, border_index<K>(tp, cols[cq]), dot3(c0, c1, c2, w[0], w[3], w[6]),
                dot3(c0, c1, c2, w[1], w[4], w[7]), dot3(c0, c1, c2, w[2], w[5], w[8]), true);
      }
    }
  }

  // LDL^T, column j: lane i computes H_ij - sum_k L_ik L_jk d_k (k < j);
  // lane j's is the pivot d_j, which every lane takes by shuffle.
  T l[DK], d[DK];
  T my_d = T(1);
#pragma unroll
  for (int j = 0; j < DK; ++j) {
    T acc = h[j];
#pragma unroll
    for (int k = 0; k < j; ++k) acc = acc - l[k] * shfl(l[k], j) * d[k];
    d[j] = shfl(acc, j);
    l[j] = acc / d[j];
    my_d = i == j ? d[j] : my_d;
  }
  bad = mo::nmax(bad, mo::ldlt_bad<T, DK>(d));
  // Forward substitution, diagonal, back substitution (ldlt_apply's order).
#pragma unroll
  for (int k = 0; k < DK; ++k) {
    const T yk = shfl(y, k);
    y = i > k ? y - l[k] * yk : y;
  }
  y = y / my_d;
#pragma unroll
  for (int i2 = DK - 1; i2 >= 0; --i2) {
#pragma unroll
    for (int k = i2 + 1; k < DK; ++k) {
      const T lki = shfl(l[i2], k), yk = shfl(y, k);
      y = i == i2 ? y - lki * yk : y;
    }
  }
  put_if(lane < DK, s + L.dx + 3 * tp.border[bi] + r, y);
  warp_sync();  // the borders' steps are in dx
  for (int sg = 0; sg < tp.n_seg; ++sg) {
    int cols[2] = {0, 0};
    const int nc = seg_cols(tp, sg, cols);
    for (int p = tp.seg_lo[sg] + lane; p <= tp.seg_hi[sg]; p += kWarp) {
      V3<T> xp = cx.zy(p);
      for (int cq = 0; cq < nc; ++cq) xp = vsub(xp, mv(cx.ZW(p, cq), load_v(s + L.dx + 3 * cols[cq])));
      T* dp = s + L.dx + 3 * p;
      for (int r2 = 0; r2 < 3; ++r2) dp[r2] = xp.a[r2];
    }
  }
  warp_sync();
  return finite_flag(cx, bad);
}

// (H + lam I) dx = -g for k = tp.k border poses at run time (the run-time
// route, past kMaxBorders borders or kMaxClosures closures): dx into the
// slab; returns bad. bordered_solve_multi's arithmetic in its order, with
// the borders' 3k x 3k Schur system in the slab (Layout::Sh, row-major)
// instead of a row per lane in registers: lane l builds rows l, l + 32, ...,
// with every update of that row in the same order; the left-looking LDL^T
// takes column j on the rows j.. (row j's entry is the pivot d_j, the rows
// below divide by it), a __syncwarp between a column's entries and its
// quotients; the forward substitution takes x_k from the slab after a
// __syncwarp a step; the back substitution runs each row on its owner, k
// ascending, a __syncwarp a row.
template <typename T>
__device__ __forceinline__ T bordered_solve_rt(const Ctx<T, TopoTable>& cx, T lam) {
  const TopoTable& tp = cx.tp;
  const int DK = 3 * tp.k;
  T* s = cx.s;
  const Layout& L = cx.L;
  const int lane = cx.lane;
  T* H = s + L.Sh;
  T* Y = s + L.Sy;
  T* Dg = s + L.Sd;
  T bad = T(0);
  for (int sg = 0; sg < tp.n_seg; ++sg) {
    int cols[2] = {0, 0};
    const int nc = seg_cols(tp, sg, cols);
    bad = mo::nmax(bad, sweep<T, 0>(cx, tp.seg_lo[sg], tp.seg_hi[sg], nc, cols, lam));
  }

  // Row i of H and of the right-hand side.
  for (int i = lane; i < DK; i += kWarp) {
    const int bi = i / 3, r = i % 3, pb = tp.border[bi];
    const T* dr = s + L.D + 9 * pb + 3 * r;
    for (int j = 0; j < DK; ++j) H[i * DK + j] = j / 3 == bi ? dr[j % 3] + (j % 3 == r ? lam : T(0)) : T(0);
    Y[i] = -s[L.g + 3 * pb + r];
  }
  // block(bi, bj) += or -= M on row i (row r of M: m0, m1, m2).
  auto add_row = [&](int i, int bj, T m0, T m1, T m2, bool sub) {
    T* h = H + i * DK + 3 * bj;
    h[0] = sub ? h[0] - m0 : h[0] + m0;
    h[1] = sub ? h[1] - m1 : h[1] + m1;
    h[2] = sub ? h[2] - m2 : h[2] + m2;
  };
  for (int i2 = 0; i2 + 1 < tp.k; ++i2) {
    const int p = tp.border[i2];
    if (tp.border[i2 + 1] != p + 1) continue;
    const T* u = s + L.U + 9 * p;
    for (int i = lane; i < DK; i += kWarp) {
      const int bi = i / 3, r = i % 3;
      if (bi == i2) add_row(i, i2 + 1, u[3 * r], u[3 * r + 1], u[3 * r + 2], false);  // U(p)
      if (bi == i2 + 1) add_row(i, i2, u[r], u[3 + r], u[6 + r], false);              // U(p)^T
    }
  }
  for (int jc = 0; jc < tp.n_cl; ++jc) {
    const int f = tp.cl_from[jc], t = tp.cl_to[jc];
    const int lo = border_index_rt(tp, f < t ? f : t), hi = border_index_rt(tp, f < t ? t : f);
    const T* cb = s + L.Cb + 9 * jc;
    for (int i = lane; i < DK; i += kWarp) {
      const int bi = i / 3, r = i % 3;
      if (bi == lo) add_row(i, hi, cb[3 * r], cb[3 * r + 1], cb[3 * r + 2], false);  // Cb
      if (bi == hi) add_row(i, lo, cb[r], cb[3 + r], cb[6 + r], false);              // Cb^T
    }
  }
  for (int sg = 0; sg < tp.n_seg; ++sg) {
    int cols[2] = {0, 0};
    const int nc = seg_cols(tp, sg, cols);
    const int lo = tp.seg_lo[sg], hi = tp.seg_hi[sg];
    for (int cp = 0; cp < nc; ++cp) {
      const int P = cols[cp];
      const bool left = P == lo - 1;
      const int r_p = left ? lo : hi, bP = border_index_rt(tp, P);
      for (int i = lane; i < DK; i += kWarp) {
        const int r = i % 3;
        if (i / 3 != bP) continue;
        // Row r of C = block(P, r_p): U(P) row r, or U(hi)^T row r.
        const T* u = s + L.U + 9 * (left ? P : hi);
        const T c0 = left ? u[3 * r] : u[r], c1 = left ? u[3 * r + 1] : u[3 + r], c2 = left ? u[3 * r + 2] : u[6 + r];
        const T* z = s + L.zy + 3 * r_p;
        Y[i] = Y[i] - dot3(c0, c1, c2, z[0], z[1], z[2]);
        for (int cq = 0; cq < nc; ++cq) {
          const T* w = s + L.ZW + 18 * r_p + 9 * cq;
          add_row(i, border_index_rt(tp, cols[cq]), dot3(c0, c1, c2, w[0], w[3], w[6]),
                  dot3(c0, c1, c2, w[1], w[4], w[7]), dot3(c0, c1, c2, w[2], w[5], w[8]), true);
        }
      }
    }
  }

  // LDL^T, column j: row i >= j takes H_ij - sum_k (L_ik L_jk) d_k (k < j),
  // row j's is the pivot d_j, the rows below divide by it.
  for (int j = 0; j < DK; ++j) {
    warp_sync();  // column j - 1's quotients (and the rows' assembly) are in
    for (int i = j + lane; i < DK; i += kWarp) {
      T acc = H[i * DK + j];
      for (int k = 0; k < j; ++k) acc = acc - H[i * DK + k] * H[j * DK + k] * Dg[k];
      if (i == j) {
        Dg[j] = acc;
      } else {
        H[i * DK + j] = acc;
      }
    }
    warp_sync();
    for (int i = j + 1 + lane; i < DK; i += kWarp) H[i * DK + j] = H[i * DK + j] / Dg[j];
  }
  warp_sync();
  for (int j = 0; j < DK; ++j) {
    const T dj = Dg[j];
    const bool good = (fabs(dj) > mo::Tiny<T>::value()) && isfinite(dj);
    bad = mo::nmax(bad, good ? T(0) : T(1));
  }
  // Forward substitution, diagonal, back substitution (ldlt_apply's order).
  for (int k = 0; k < DK; ++k) {
    warp_sync();  // y_k is final
    const T yk = Y[k];
    for (int i = k + 1 + lane; i < DK; i += kWarp) Y[i] = Y[i] - H[i * DK + k] * yk;
  }
  warp_sync();
  for (int i = lane; i < DK; i += kWarp) Y[i] = Y[i] / Dg[i];
  for (int i2 = DK - 1; i2 >= 0; --i2) {
    warp_sync();  // rows past i2 are final
    if (i2 % kWarp == lane) {
      T y = Y[i2];
      for (int k = i2 + 1; k < DK; ++k) y = y - H[k * DK + i2] * Y[k];
      Y[i2] = y;
    }
  }
  warp_sync();
  for (int i = lane; i < DK; i += kWarp) s[L.dx + 3 * tp.border[i / 3] + i % 3] = Y[i];
  warp_sync();  // the borders' steps are in dx
  for (int sg = 0; sg < tp.n_seg; ++sg) {
    int cols[2] = {0, 0};
    const int nc = seg_cols(tp, sg, cols);
    for (int p = tp.seg_lo[sg] + lane; p <= tp.seg_hi[sg]; p += kWarp) {
      V3<T> xp = cx.zy(p);
      for (int cq = 0; cq < nc; ++cq) xp = vsub(xp, mv(cx.ZW(p, cq), load_v(s + L.dx + 3 * cols[cq])));
      T* dp = s + L.dx + 3 * p;
      for (int r2 = 0; r2 < 3; ++r2) dp[r2] = xp.a[r2];
    }
  }
  warp_sync();
  return finite_flag(cx, bad);
}

// The whole solve of one instance by one warp on its slab: data (3E, B),
// x0 (3N, B), x_out (3N, B), state (3, B), feature-major.
template <typename T, int K, class TP>
__device__ __forceinline__ void solve(const TP& tp, T* slab, const T* __restrict__ data, const T* __restrict__ x0,
                      T* __restrict__ x_out, T* __restrict__ state, int inst, int B, int max_iterations,
                      int ls_iterations) {
  const int N = tp.n, E = N - 1 + tp.n_cl;
  const Ctx<T, TP> cx{tp, slab, Layout(N, tp.n_cl, K == 0 ? tp.k : 0), static_cast<int>(threadIdx.x % kWarp), N, E};
  const Layout& L = cx.L;
  T* s = slab;
  const int lane = cx.lane, nx = 3 * N;
  const size_t stride = static_cast<size_t>(B);
  const T zero = T(0), one = T(1);
  SpanClock clk(inst == 0 && lane == 0);

  for (int q = lane; q < 3 * E; q += kWarp) s[L.meas + q] = data[q * stride + inst];
  for (int q = lane; q < nx; q += kWarp) {
    const T v = x0[q * stride + inst];
    s[L.x + q] = v;
    s[L.best + q] = v;
  }
  warp_sync();
  T lam = zero, restore = zero, f_best = T(INFINITY);
  T fac_bad = zero, lam_maxed = zero, accepted = zero, f_acc = zero, f_pre = zero;
  clk.mark(kSpanSetup);
  for (int it = 0; it < max_iterations; ++it) {
    f_pre = linearize(cx);
    if (f_pre < f_best) {
      for (int q = lane; q < nx; q += kWarp) s[L.best + q] = s[L.x + q];
      f_best = f_pre;
    }
    warp_sync();
    clk.mark(kSpanLinearize);
    T bad;
    if constexpr (K == 1) {
      bad = bordered_solve(cx, lam);
    } else if constexpr (K == 0) {
      bad = bordered_solve_rt(cx, lam);
    } else {
      bad = bordered_solve_multi<T, K>(cx, lam);
    }
    fac_bad = mo::nmax(fac_bad, bad);
    clk.mark(kSpanSolve);
    // dd = 0 + g[0] dx[0] + g[1] dx[1] + ..., the terms read back in order.
    T* terms = s + L.terms;
    for (int q = lane; q < nx; q += kWarp) terms[q] = s[L.g + q] * s[L.dx + q];
    pad4(terms, nx, lane);
    warp_sync();
    const T dd = sum4(zero, terms, nx);
    warp_sync();
    clk.mark(kSpanStepDot);

    // Line search: the probes' cost terms a round at a time (probe i of the
    // round in row i of the terms area), then the tests in probe order.
    T alpha = one;
    accepted = zero;
    for (int q = lane; q < nx; q += kWarp) s[L.bx + q] = s[L.x + q];
    f_acc = f_pre;
    const T* x = s + L.x;
    const T* dx = s + L.dx;
    for (int p0 = 0; p0 <= ls_iterations; p0 += kProbeChunk) {
      const int nq = ls_iterations + 1 - p0 < kProbeChunk ? ls_iterations + 1 - p0 : kProbeChunk;
      for (int item = lane; item < nq * E; item += kWarp) {
        const int i = item / E, e = item - i * E;
        T a = one;
        for (int t = 0; t < p0 + i; ++t) a = a * T(0.5);
        int pi, pj;
        edge_ij(tp, e, pi, pj);
        T v[kEdgeValues];
        edge_values(x[3 * pi] + a * dx[3 * pi], x[3 * pi + 1] + a * dx[3 * pi + 1], x[3 * pi + 2] + a * dx[3 * pi + 2],
                    x[3 * pj] + a * dx[3 * pj], x[3 * pj + 1] + a * dx[3 * pj + 1], x[3 * pj + 2] + a * dx[3 * pj + 2],
                    s + L.meas + 3 * e, v);
        terms[i * L.e4 + e] = v[7];
      }
      for (int i = 0; i < nq; ++i) pad4(terms + i * L.e4, E, lane);
      warp_sync();
      for (int i = 0; i < nq; ++i) {
        if (p0 + i > 0) alpha = alpha * T(0.5);
        const T f_c = sum4_first(terms + i * L.e4, E) +
                      anchor_term(tp, x[0] + alpha * dx[0], x[1] + alpha * dx[1], x[2] + alpha * dx[2]);
        const T ok = (f_c <= f_pre + T(1e-4) * alpha * mo::nmin(dd, zero)) ? one : zero;
        const T take = ok * (one - accepted);
        for (int q = lane; q < nx; q += kWarp)
          s[L.bx + q] = take * (x[q] + alpha * dx[q]) + (one - take) * s[L.bx + q];
        f_acc = take * f_c + (one - take) * f_acc;
        accepted = mo::nmin(accepted + take, one);
      }
      warp_sync();
    }
    clk.mark(kSpanLineSearch);
    if (accepted > zero)
      for (int q = lane; q < nx; q += kWarp) s[L.x + q] = s[L.bx + q];
    warp_sync();
    // Lambda machine at NLSParams defaults (nonlinear.cc:296-343).
    const T lam_succ = mo::nmax(lam * (restore > zero ? T(0.8) : T(0.1)), zero);
    const T lam_fail = restore > zero ? lam * T(10.0) : mo::nmax(T(1e-2) * one, lam * T(10.0));
    lam_maxed = (accepted == zero && lam >= one) ? one : lam_maxed;
    lam = mo::nmin(accepted > zero ? lam_succ : lam_fail, one);
    restore = accepted > zero ? zero : one;
    clk.mark(kSpanUpdate);
  }
  const T f_fin = accepted > zero ? f_acc : f_pre;
  const bool better = f_fin < f_best;
  for (int q = lane; q < nx; q += kWarp) x_out[q * stride + inst] = better ? s[L.x + q] : s[L.best + q];
  if (lane == 0) {
    state[inst] = better ? f_fin : f_best;
    state[stride + inst] = zero;
    state[2 * stride + inst] = fac_bad + T(2.0) * lam_maxed;
  }
  clk.mark(kSpanOut);
}

// CTAs of kMaxWarps warps that each SM should hold at once, which sets the
// register budget of an instance: the float single-closure instance (the
// main path) is held to 80 registers, 6 CTAs (24 graphs) an SM; the double
// one to 128; the multi-closure ones, whose Schur system runs on one lane,
// take what they need.
template <typename T, int K>
constexpr int kMinCtas = K == 1 ? (sizeof(T) == 4 ? 6 : 4) : 1;

// Kernel 7: instance blockIdx.x * W + warp on warp `warp` of a CTA of W
// warps, its slab in the CTA's dynamic shared memory (kShared) or row
// `inst` of the instance-major (B, slots) global scratch. The route is a
// template argument so that the compiler addresses a shared slab as shared
// memory. K = 0: the run-time route (TopoTable, the Schur system in the
// slab).
template <typename T, int K, bool kShared, class TP = Topology>
__global__ void __launch_bounds__(kMaxWarps * kWarp, kMinCtas<T, K>)
    pose_ring_kernel(TP tp, const T* __restrict__ data, const T* __restrict__ x0,
                     T* __restrict__ x_out, T* __restrict__ state, T* __restrict__ scratch, int B,
                     int max_iterations, int ls_iterations) {
  const int warp = threadIdx.x / kWarp;
  const int inst = blockIdx.x * (blockDim.x / kWarp) + warp;
  if (inst >= B) return;  // the whole warp, before its first __syncwarp
  const int slots = Layout(tp.n, tp.n_cl, K == 0 ? tp.k : 0).total;
  T* slab = kShared ? dyn_smem<T>() + static_cast<size_t>(warp) * slots : scratch + static_cast<size_t>(inst) * slots;
  solve<T, K>(tp, slab, data, x0, x_out, state, inst, B, max_iterations, ls_iterations);
}

struct LaunchArgs {
  const void* data;
  const void* x0;
  void* x_out;
  void* state;
  void* scratch;  // null: the slabs live in shared memory
  int B;
  int warps;  // instances per CTA
  int max_iterations;
  int ls_iterations;
  cudaStream_t stream;
};

// Kernel 7 for K borders on one route: a launch, or (occupancy_only) the
// CTAs of a.warps instances that fit one SM, negative on an error.
// kTooLarge where the slabs do not fit one CTA's shared memory.
template <typename T, int K, bool kShared, class TP>
int launch_route(const TP& tp, const LaunchArgs& a, bool occupancy_only) {
  const size_t smem =
      kShared ? static_cast<size_t>(a.warps) * Layout(tp.n, tp.n_cl, K == 0 ? tp.k : 0).total * sizeof(T) : 0;
  int rc = 0;
  if (smem > static_cast<size_t>(kMaxSmem)) {
    rc = mo::kTooLarge;
  } else if (smem > 48 * 1024) {
    rc = static_cast<int>(cudaFuncSetAttribute(pose_ring_kernel<T, K, kShared, TP>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
  }
  const int threads = a.warps * kWarp;
  if (occupancy_only) {
    if (rc != 0) return rc > 0 ? -rc : rc;
    int blocks = 0;
    const cudaError_t e =
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, pose_ring_kernel<T, K, kShared, TP>, threads, smem);
    return e == cudaSuccess ? blocks : -static_cast<int>(e);
  }
  if (rc != 0) return rc;
  const int grid = (a.B + a.warps - 1) / a.warps;
  pose_ring_kernel<T, K, kShared, TP><<<grid, threads, smem, a.stream>>>(
      tp, static_cast<const T*>(a.data), static_cast<const T*>(a.x0), static_cast<T*>(a.x_out),
      static_cast<T*>(a.state), static_cast<T*>(a.scratch), a.B, a.max_iterations, a.ls_iterations);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int K, class TP>
int launch(const TP& tp, const LaunchArgs& a, bool occupancy_only) {
  if (a.warps < 1 || a.warps > kMaxWarps) return static_cast<int>(cudaErrorInvalidValue);
  return a.scratch != nullptr ? launch_route<T, K, false>(tp, a, occupancy_only)
                              : launch_route<T, K, true>(tp, a, occupancy_only);
}

template <typename T>
int dispatch_k(const Topology& tp, const LaunchArgs& a, bool occupancy_only) {
  switch (tp.k) {
    case 1: return launch<T, 1>(tp, a, occupancy_only);
    case 2: return launch<T, 2>(tp, a, occupancy_only);
    case 3: return launch<T, 3>(tp, a, occupancy_only);
    case 4: return launch<T, 4>(tp, a, occupancy_only);
    case 5: return launch<T, 5>(tp, a, occupancy_only);
    case 6: return launch<T, 6>(tp, a, occupancy_only);
    default: return mo::kNoInstance;
  }
}

// The instances of one dtype, each built in its own source file so that
// the two compile in parallel: pose_ring.cu (float), pose_ring_f64.cu
// (double); launch_*_table are the run-time route's.
int launch_float(const Topology& tp, const LaunchArgs& a, bool occupancy_only);
int launch_double(const Topology& tp, const LaunchArgs& a, bool occupancy_only);
int launch_float_table(const TopoTable& tp, const LaunchArgs& a, bool occupancy_only);
int launch_double_table(const TopoTable& tp, const LaunchArgs& a, bool occupancy_only);

}  // namespace mo::ring
