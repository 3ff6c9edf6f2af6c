// Fused whole-solve SQP for medium-N families (the blocked tier) on Hopper.
//
// Kernel 2 (blocked_sqp_kernel) replaces the TPU kernel mini_opt_tpu/ops/
// pallas_blocked.py::_make_blocked_kernel (launched at pallas_blocked.py:703
// by blocked_solve_batch). It computes what fused_sqp.cuh computes -- the
// family's linearization and damped Gauss-Newton assembly, the condensed
// KKT interior point (equality-constrained initial guess, complementarity or
// Mehrotra mu, fraction to the boundary), the L1-merit Armijo or polynomial
// line search with retraction, the lambda machine, the best-merit return
// with f_best starting at +inf, and the (f, |eq|_1, flags) write-out -- for
// systems of D = n + m rows past the register tier's 32. ldlt_factor_cta /
// ldlt_solve_cta at the top are kernel 3's routines past D = 192
// (blocked_kkt.cu, the kernel of pallas_blocked.py::blocked_kkt_solve): one
// CTA per system, one thread per row; below that kernel 3 takes the warp
// routines that follow.
//
// What bounds it on this card: operations in principle, the shared-memory
// instructions in practice. An instance reads and writes a few hundred
// bytes but factors its D x D KKT matrix (qp_iterations + 1) times per outer
// iteration, D^3 / 6 multiply-subtracts each: about 1.5 million
// floating-point operations per instance at D = 49, 6/3/2. Its matrices
// live in shared memory, and one warp gets about one shared-memory
// instruction through every 8 cycles, so the count of those instructions,
// and the dependent chain of a factor's D pivot steps and a solve's
// 2 (D - 1) substitution steps, set the time.
//
// What the design does about it: one warp per instance, W instances per
// CTA (ops/blocked.py::launch_plan: 4, fewer where 4 slabs do not fit
// 232,448 bytes), the grid ceil(B / W). Lane l owns KKT rows l, l + 32, ...
// (R = 2, 4 or 6 rows a lane, a template parameter, so their vectors sit in
// registers) and the variable, equality row and slacks of each. The warp's
// slab of dynamic shared memory (Slab: 12,768 B at D = 49 in float) holds
// the KKT matrix, the packed Gauss-Newton Hessian, the family's outputs and
// a scratch area that the family, the step candidates and the terms of
// every sum take in turn.
// - The KKT matrix is stored by columns in whole 16-byte tiles of 4 rows
//   (colA), so the trailing triangle of a pivot is one run of tiles. The
//   factor is right-looking: at pivot k the lanes divide column k by its
//   pivot and form w = d_k L_k; after a __syncwarp the trailing tiles are
//   spread evenly over the lanes, each tile one 16-byte load of A, one of
//   column k's L at the same rows, one load of w_j and one 16-byte store.
//   Each entry still takes its updates in pivot order, A_ij - L_ik w_j.
// - The substitutions pass x_k from its owner lane to all by __shfl_sync;
//   each lane updates its own rows, with no shared-memory publication and no
//   barrier, the factor entries of a block of steps loaded ahead of the
//   block's shuffles. The pivots are read from the factor's diagonal.
// - Sums over rows or slacks: each term to a scratch slot, then every lane
//   reads the terms back in index order, four at a time, so every lane
//   holds the same scalars and each per-instance decision (the lambda
//   machine, the penalty, accept/restore, the best-merit iterate, the loop
//   trips, the flags) is warp-uniform. The fraction to the boundary keeps
//   its ordered minimum (a +-0 candidate makes it order-dependent).
// - Loads in the hot loops are unconditional and guarded stores are
//   predicated (store_if), because a branch the compiler cannot prove
//   warp-uniform costs a reconvergence barrier per trip.
// There is no __syncthreads in the solve: a warp past B exits whole before
// its first __syncwarp. Kernel 3 (blocked_kkt.cu) runs the warp routines
// below on one system per warp up to D = 192 and the CTA routines above past
// it.
// - Past one CTA's shared memory or D = 192 (to 256), the global route
//   (blocked_sqp_global_kernel): the same solve with R = 6 or 8 rows a lane,
//   its slab a row of a global scratch array of one slab per warp of the
//   grid (one warp a CTA, 264 warps, ops/blocked.py::GLOBAL_SLABS), each
//   warp solving instances w, w + 264, ... in turn; its guarded stores are
//   plain ones (put_if<true>). A kernel of its own: folding the route into
//   the shared kernel's body cost that kernel 6.6% at D = 49.
//
// Order of operations: every sum the JAX kernel takes with jnp.sum over a
// stacked axis is taken here term by term in index order, the factor's
// updates in pivot order, as in the plain PyTorch version
// (ops/blocked.py::_blocked_solve_plain). With no FMA contraction
// (--fmad=false) and no fast math, kernel and plain version round alike.
#pragma once

#include <cfloat>
#include <cmath>

#include "families.cuh"
#include "fused_sqp.cuh"

namespace mo {
namespace blocked {

// ---------------------------------------------------------------------------
// Kernel 3's routines past D = 192: one CTA per system, one thread per row.
// ---------------------------------------------------------------------------

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

// ---------------------------------------------------------------------------
// Kernel 2: one warp per instance.
// ---------------------------------------------------------------------------

constexpr int kWarp = 32;
constexpr unsigned kAll = 0xffffffffu;
constexpr int kMaxWarps = 4;  // instances per CTA

__device__ __forceinline__ void warp_sync() { __syncwarp(kAll); }

// KKT rows per lane of the kernel instance that takes a D-row system (lane
// l owns rows l, l + 32, ...): 2 up to D = 64, 4 up to 128, 6 up to 192;
// 0 past that (no instance).
__host__ __device__ constexpr int rows_per_lane(int D) {
  return D <= 64 ? 2 : (D <= 128 ? 4 : (D <= 192 ? 6 : 0));
}

// The same on the global route (each warp's slab in a global scratch
// array, for systems past one CTA's shared memory or past D = 192): 6 up to
// 192, 8 up to 256 (the tile table's 8-bit row and column); 0 past that.
__host__ __device__ constexpr int global_rows_per_lane(int D) {
  return D <= 192 ? 6 : (D <= 256 ? 8 : 0);
}

// The KKT matrix's layout: its lower triangle by columns, each column in
// whole tiles of 4 rows. Column j holds rows (j & ~3) .. Dp - 1 (Dp = D
// rounded up to 4; the rows above j and past D - 1 are padding that nothing
// reads as data), from slot colA(j), a multiple of 4, so that rows
// 4q .. 4q + 3 of any column are one 16-byte-aligned tile and the trailing
// triangle of pivot k is the contiguous run of tiles from colA(k + 1).
constexpr int kTile = 4;
__host__ __device__ inline int round4(int D) { return (D + 3) & ~3; }
// colA(j) = sum over columns c < j of their length Dp - (c & ~3).
__host__ __device__ inline int colA(int j, int D) {
  const int Dp = round4(D), g = j >> 2, r = j & 3;
  return 4 * g * Dp - 8 * g * (g - 1) + r * (Dp - 4 * g);
}
// Slot of entry (i, j), i >= j & ~3.
__host__ __device__ inline int cidx(int i, int j, int D) { return colA(j, D) + i - (j & ~3); }

// Tile t's first row and column, as (i0 << 8) | j (D <= 256): the table
// the factor and the assembly index tiles by.
__device__ inline void fill_tile_table(unsigned short* tiles, int D, int lane) {
  const int Dp = round4(D);
  for (int j = 0; j < D; ++j) {
    const int first = colA(j, D) / kTile, i0 = j & ~3;
    for (int t = lane; t < (Dp - i0) / kTile; t += kWarp) {
      tiles[first + t] = static_cast<unsigned short>(((i0 + kTile * t) << 8) | j);
    }
  }
}

// Four consecutive entries of a 16-byte-aligned tile.
__device__ __forceinline__ void load_tile(const float* p, float (&v)[kTile]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x;
  v[1] = a.y;
  v[2] = a.z;
  v[3] = a.w;
}
__device__ __forceinline__ void store_tile(float* p, const float (&v)[kTile]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void load_tile(const double* p, double (&v)[kTile]) {
  const double2 a = *reinterpret_cast<const double2*>(p);
  const double2 b = *reinterpret_cast<const double2*>(p + 2);
  v[0] = a.x;
  v[1] = a.y;
  v[2] = b.x;
  v[3] = b.y;
}
__device__ __forceinline__ void store_tile(double* p, const double (&v)[kTile]) {
  *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
  *reinterpret_cast<double2*>(p + 2) = make_double2(v[2], v[3]);
}

// Stores that happen only where `p` holds, as predicated shared-memory
// stores: no branch, so no reconvergence barrier in the loops that use
// them (the compiler cannot tell that such a guard is warp-uniform).
#ifdef __CUDA_ARCH__
__device__ __forceinline__ void store_tile_if(bool p, float* at, const float (&v)[kTile]) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(at));
  asm volatile("{ .reg .pred q; setp.ne.b32 q, %0, 0; @q st.shared.v4.f32 [%1], {%2, %3, %4, %5}; }" ::"r"(int(p)),
               "r"(a), "f"(v[0]), "f"(v[1]), "f"(v[2]), "f"(v[3])
               : "memory");
}
__device__ __forceinline__ void store_tile_if(bool p, double* at, const double (&v)[kTile]) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(at));
  asm volatile("{ .reg .pred q; setp.ne.b32 q, %0, 0; @q st.shared.v2.f64 [%1], {%2, %3}; @q st.shared.v2.f64 [%1+16], {%4, %5}; }" ::"r"(int(p)),
               "r"(a), "d"(v[0]), "d"(v[1]), "d"(v[2]), "d"(v[3])
               : "memory");
}
__device__ __forceinline__ void store_if(bool p, float* at, float v) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(at));
  asm volatile("{ .reg .pred q; setp.ne.b32 q, %0, 0; @q st.shared.f32 [%1], %2; }" ::"r"(int(p)), "r"(a), "f"(v)
               : "memory");
}
__device__ __forceinline__ void store_if(bool p, double* at, double v) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(at));
  asm volatile("{ .reg .pred q; setp.ne.b32 q, %0, 0; @q st.shared.f64 [%1], %2; }" ::"r"(int(p)), "r"(a), "d"(v)
               : "memory");
}
#else
template <typename T>
inline void store_tile_if(bool p, T* at, const T (&v)[kTile]) {
  if (p) store_tile(at, v);
}
template <typename T>
inline void store_if(bool p, T* at, T v) {
  if (p) *at = v;
}
#endif

// The guarded stores of a slab in shared memory (G false: the predicated
// st.shared above) or in the global scratch (G true: a guarded store that
// the compiler predicates).
template <bool G, typename T>
__device__ __forceinline__ void put_tile_if(bool p, T* at, const T (&v)[kTile]) {
  if constexpr (G) {
    if (p) store_tile(at, v);
  } else {
    store_tile_if(p, at, v);
  }
}
template <bool G, typename T>
__device__ __forceinline__ void put_if(bool p, T* at, T v) {
  if constexpr (G) {
    if (p) *at = v;
  } else {
    store_if(p, at, v);
  }
}

// The unpivoted LDL^T of the D x D matrix A (the tiled layout above, tiles
// its tile table), by one warp. On exit A's diagonal holds the pivots d and
// its strict lower triangle L (unit diagonal implied); w (D slots) is
// scratch. Step k: L_ik = A_ik / d_k and w_i = d_k L_ik for every row i > k
// (rows spread over the lanes), a __syncwarp, then A_ij -= L_ik * w_j on
// the trailing triangle tile by tile, tiles l, l + 32, ... on lane l, U of
// them loaded before any is stored: a tile of column j is one 16-byte load
// of A, one of column k's L at the same rows, one load of w_j and one
// 16-byte store. A tile's padding rows take the same arithmetic on values
// nothing reads. Every load is unconditional (a tile past the end reads
// column k's first tile, which no lane writes in the step). Begins and ends
// with a __syncwarp. G: A and w lie in global memory (the global route).
template <typename T, int R, bool G = false>
__device__ void ldlt_factor_warp(T* A, T* w, const unsigned short* tiles, int D, int lane) {
  constexpr int U = R <= 2 ? 4 : 2;  // tiles in flight per lane
  const int end = colA(D, D) / kTile;
  warp_sync();
  for (int k = 0; k + 1 < D; ++k) {
    T* Lk = A + colA(k, D) - (k & ~3);  // Lk[i] = A_ik
    const int own = colA(k, D) / kTile, first = colA(k + 1, D) / kTile + lane;
    const T dk = Lk[k];
#pragma unroll
    for (int u = 0; u < R; ++u) {
      if (k + 1 + u * kWarp >= D) break;  // no lane has a row this far down
      const int i = k + 1 + lane + u * kWarp;
      const T lk = Lk[i < D ? i : k] / dk;
      put_if<G>(i < D, Lk + (i < D ? i : k), lk);
      put_if<G>(i < D, w + (i < D ? i : k), dk * lk);
    }
    warp_sync();
    for (int t0 = first; t0 < end; t0 += U * kWarp) {
      T a[U][kTile], l[U][kTile], wj[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int t = t0 + u * kWarp < end ? t0 + u * kWarp : own;
        const int e = tiles[t];
        load_tile(A + kTile * t, a[u]);
        load_tile(Lk + (e >> 8), l[u]);
        wj[u] = w[e & 255];
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int t = t0 + u * kWarp;
#pragma unroll
        for (int q = 0; q < kTile; ++q) a[u][q] = a[u][q] - l[u][q] * wj[u];
        put_tile_if<G>(t < end, A + kTile * (t < end ? t : own), a[u]);
      }
    }
    warp_sync();
  }
}

// Solve L diag(d) L^T x = rhs with the factor of ldlt_factor_warp: v[r]
// holds rhs and gets x of row lane + 32 r (0 past D). The owner of row k
// hands x_k to every lane by shuffle. The steps run in blocks of S: each
// lane first loads the factor entries of its rows for the block's steps
// (unconditionally: a row without an entry reads a pivot), then runs the
// block's shuffles, so that no load waits in the shuffles' chain. Forward
// substitution subtracts L_ik x_k for k = 0, 1, ...; back substitution
// L_kj x_k for k = D-1, D-2, .... Reads A only (the caller's __syncwarp
// after the factor makes it visible).
template <typename T, int R>
__device__ void ldlt_solve_warp(const T* A, int D, int lane, T (&v)[R]) {
  constexpr int S = R <= 2 ? 8 : 4;
  // Row i of column k is slot base(k) + i: base(k) = colA(k) - (k & ~3),
  // base(k + 1) = base(k) + Dp - ((k + 1) & ~3).
  const int Dp = round4(D);
  int base = 0;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    for (int k0 = r * kWarp; k0 < (r + 1) * kWarp && k0 + 1 < D; k0 += S) {
      T l[S][R];
      int b = base;
#pragma unroll
      for (int t = 0; t < S; ++t) {
        const int k = k0 + t;
#pragma unroll
        for (int r2 = r; r2 < R; ++r2) {
          const int q = lane + r2 * kWarp;
          l[t][r2] = A[q > k && q < D ? b + q : 0];
        }
        b += Dp - ((k + 1) & ~3);
      }
      asm volatile("" ::: "memory");  // the loads stay ahead of the shuffles
#pragma unroll
      for (int t = 0; t < S; ++t) {
        const int k = k0 + t;
        if (k + 1 < D) {
          const T xk = __shfl_sync(kAll, v[r], k - r * kWarp);
#pragma unroll
          for (int r2 = r; r2 < R; ++r2) {
            const int i = lane + r2 * kWarp;
            if (i > k && i < D) v[r2] = v[r2] - l[t][r2] * xk;
          }
        }
      }
      base = b;
    }
  }
  // The lane's rows' columns start at c[r] + row: A[c[r] + k] = L_k,row.
  int c[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = lane + r * kWarp;
    c[r] = i < D ? colA(i, D) - (i & ~3) : 0;
    const T d = A[c[r] + (i < D ? i : 0)];
    if (i < D) v[r] = v[r] / d;
  }
#pragma unroll
  for (int r = R - 1; r >= 0; --r) {
    const int top = (r + 1) * kWarp < D ? (r + 1) * kWarp : D;
    for (int k0 = top - 1; k0 >= r * kWarp && k0 >= 1; k0 -= S) {
      T l[S][R];
#pragma unroll
      for (int t = 0; t < S; ++t) {
        const int k = k0 - t;
#pragma unroll
        for (int r2 = 0; r2 <= r; ++r2) {
          const int j = lane + r2 * kWarp;
          l[t][r2] = A[j < k ? c[r2] + k : 0];
        }
      }
      asm volatile("" ::: "memory");
#pragma unroll
      for (int t = 0; t < S; ++t) {
        const int k = k0 - t;
        if (k >= r * kWarp && k >= 1) {
          const T xk = __shfl_sync(kAll, v[r], k - r * kWarp);
#pragma unroll
          for (int r2 = 0; r2 <= r; ++r2) {
            const int j = lane + r2 * kWarp;
            if (j < k) v[r2] = v[r2] - l[t][r2] * xk;
          }
        }
      }
    }
  }
}

// 1 where any pivot (the factor's diagonal, read in index order) is
// (near-)zero or non-finite, else 0.
template <typename T>
__device__ T factor_bad(const T* A, int D) {
  bool good = true;
  const int Dp = round4(D);
  for (int j = 0, p = 0; j < D; p += Dp + 1 - ((j + 1) & ~3), ++j) {
    const T d = A[p];  // p = cidx(j, j, D)
    good = good & (fabs(d) > Tiny<T>::value()) & static_cast<bool>(isfinite(d));
  }
  return good ? T(0) : T(1);
}

// Fraction to the boundary: the step-length candidate of one slack.
template <typename T>
__device__ __forceinline__ T ftb_cand(T v, T dv, T tau) {
  const bool blocking = (v + dv <= T(0)) && (fabs(dv) > T(0));
  const T cand = -tau * v / (blocking ? dv : T(1));
  return blocking ? cand : T(1);
}

// The step candidates and the terms of sums sit in scratch arrays that
// start on 16-byte boundaries and are padded to whole tiles of 4 with a
// value that leaves the result alone (+inf for a minimum, -0 for a sum:
// x + -0 is x for every x, +0 included), so that every lane reads them back
// in index order four at a time, without a guard.

// Lanes 0..2 write `value` into a[count .. round4(count)).
template <bool G, typename T>
__device__ __forceinline__ void pad_tile(T* a, int count, T value, int lane) {
  const bool mine = count + lane < round4(count);
  put_if<G>(mine, a + (mine ? count + lane : 0), value);
}

// alpha_a = min(alpha_a, min_j a[j]) and alpha_b likewise over j < count
// (nothing when count is 0), each minimum NaN-propagating and taken from
// the first candidate in index order (from +inf, the first comparison
// yields the first candidate), the two chains side by side. The chains
// compare only; whether a NaN was seen is kept beside them (nmin's result
// is NaN from the first NaN on, whatever follows).
template <typename T>
__device__ void min2_into(T& alpha_a, const T* a, T& alpha_b, const T* b, int count) {
  if (count == 0) return;
  T ma = T(INFINITY), mb = T(INFINITY);
  bool nan_a = false, nan_b = false;
  for (int j0 = 0; j0 < count; j0 += kTile) {
    T va[kTile], vb[kTile];
    load_tile(a + j0, va);
    load_tile(b + j0, vb);
#pragma unroll
    for (int q = 0; q < kTile; ++q) {
      nan_a = nan_a | (va[q] != va[q]);
      ma = ma < va[q] ? ma : va[q];
      nan_b = nan_b | (vb[q] != vb[q]);
      mb = mb < vb[q] ? mb : vb[q];
    }
  }
  alpha_a = nmin(alpha_a, nan_a ? T(NAN) : ma);
  alpha_b = nmin(alpha_b, nan_b ? T(NAN) : mb);
}

// terms[0] + terms[1] + ... (count >= 1), from -0 (-0 + t is t).
template <typename T>
__device__ T sum_terms(const T* terms, int count) {
  T acc = T(-0.0);
  for (int j0 = 0; j0 < count; j0 += kTile) {
    T v[kTile];
    load_tile(terms + j0, v);
#pragma unroll
    for (int q = 0; q < kTile; ++q) acc = acc + v[q];
  }
  return acc;
}

// (0 + a[0] + ... + a[na-1]) + (b[0] + ... + b[nb-1]), an empty side
// skipped, the two sums taken side by side.
template <typename T>
__device__ T sum2_terms(const T* a, int na, const T* b, int nb) {
  T sa = T(-0.0), sb = T(-0.0);
  const int both = na < nb ? na : nb;
  int j0 = 0;
  for (; j0 < both; j0 += kTile) {
    T va[kTile], vb[kTile];
    load_tile(a + j0, va);
    load_tile(b + j0, vb);
#pragma unroll
    for (int q = 0; q < kTile; ++q) {
      sa = sa + va[q];
      sb = sb + vb[q];
    }
  }
  for (int j = j0; j < na; j += kTile) {
    T v[kTile];
    load_tile(a + j, v);
#pragma unroll
    for (int q = 0; q < kTile; ++q) sa = sa + v[q];
  }
  for (int j = j0; j < nb; j += kTile) {
    T v[kTile];
    load_tile(b + j, v);
#pragma unroll
    for (int q = 0; q < kTile; ++q) sb = sb + v[q];
  }
  T acc = T(0);
  if (na > 0) acc = acc + sa;
  if (nb > 0) acc = acc + sb;
  return acc;
}

// One instance's slab, of shared memory or of the global scratch.
template <typename T>
struct Slab {
  T* A;    // colA(D): the KKT matrix in whole tiles (colA), factored in place
  T* vec;  // D: the factor's w; a published primal (n) + dual (m) vector
  T* G;    // tri(n): damped Gauss-Newton Hessian, lower triangle packed by rows
  T* Jeq;  // m x n
  T* c;    // n gradient
  T* req;  // m equality residuals
  T* th;   // n: the iterate (or line-search candidate) the family reads
  T* tgt;  // data rows
  T* scr;  // the family's scratch, then the step candidates and the terms of sums
  unsigned short* tiles;  // colA(D) / 4: each tile's first row and column
};

// Slots of the scratch area, in whole tiles: the family's, the four arrays
// of step candidates (lo primal, lo dual, hi primal, hi dual, each from a
// tile boundary), n terms of a sum over the variables.
template <class F>
__host__ __device__ int scratch_slots(const F& fam) {
  int s = fam.scratch();
  const int cand = 2 * (round4(fam.nlo()) + round4(fam.nhi()));
  s = s > cand ? s : cand;
  return round4(s > fam.nvar() ? s : fam.nvar());
}

// Carve one instance's slab out of `base` (16-byte aligned; nullptr: only
// count); returns the bytes it takes, rounded up to a multiple of 16 so
// that every slab is aligned alike (ops/blocked.py::launch_plan counts the
// same).
template <typename T, class F>
__host__ __device__ size_t carve(const F& fam, unsigned char* base, Slab<T>* out) {
  const int n = fam.nvar(), m = F::M, D = n + m;
  size_t off = 0;
  auto take = [&](size_t count) {
    T* p = base ? reinterpret_cast<T*>(base) + off : nullptr;
    off += count;
    return p;
  };
  Slab<T> s;
  s.A = take(size_t(colA(D, D)));
  s.scr = take(scratch_slots(fam));
  s.vec = take(D);
  s.G = take(size_t(tri(n)));
  s.Jeq = take(size_t(m) * n);
  s.c = take(n);
  s.req = take(m);
  s.th = take(n);
  s.tgt = take(F::ROWS);
  s.tiles = reinterpret_cast<unsigned short*>(take((2 * size_t(colA(D, D) / kTile) + sizeof(T) - 1) / sizeof(T)));
  if (out) *out = s;
  return (off * sizeof(T) + 15) / 16 * 16;
}

// The lane's view of its instance: sizes, and the slacks of the rows it
// owns (row lane + 32 r: variable if < n, equality row if < D).
template <int R>
struct Lane {
  int n, m, D, nlo, nhi, ncon, lane;
  int slo[R];  // the row's lower slack, or -1
  int shi[R];  // the row's upper slack, or -1
  __device__ int row(int r) const { return lane + r * kWarp; }
  __device__ bool var(int r) const { return row(r) < n; }
  __device__ bool eqrow(int r) const { return row(r) >= n && row(r) < D; }
};

// The condensed KKT matrix [[G + diag(sig_d), .], [J_eq, 0]]
// (pallas_blocked.py:203-225) into A: tiles l, l + 32, ... on lane l, each
// one 16-byte store (padding rows 0); after a __syncwarp, G's diagonal
// entries (plus sig_d when with_sig) by the row's owner.
template <typename T, int R>
__device__ void assemble_kkt(const Slab<T>& s, const Lane<R>& L, bool with_sig, const T (&sig_d)[R]) {
  const int n = L.n, D = L.D;
  warp_sync();  // the last solve's reads of A are done
  for (int t = L.lane; t < colA(D, D) / kTile; t += kWarp) {
    const int e = s.tiles[t], i0 = e >> 8, j = e & 255;
    T v[kTile];
#pragma unroll
    for (int q = 0; q < kTile; ++q) {
      const int i = i0 + q;
      const T g = s.G[i < n && j <= i ? tri(i) + j : 0];
      const T J = s.Jeq[i >= n && i < D && j < n ? (i - n) * n + j : 0];
      v[q] = i < j || i >= D ? T(0) : (i < n ? g : (j < n ? J : T(0)));
    }
    store_tile(s.A + kTile * t, v);
  }
  warp_sync();
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (L.var(r)) {
      const int i = L.row(r);
      const T g = s.G[tri(i) + i];
      s.A[cidx(i, i, D)] = with_sig ? g + sig_d[r] : g;
    }
  }
}

// Interior point on the condensed system (pallas_blocked.py:227-424).
// Reads G, c, Jeq, req from the slab and the lane's shifted bounds ib_lo /
// ib_hi; returns the uniform factorization flag, and in xy the primal of
// the lane's variable rows and the dual of its equality rows.
template <typename T, int R, bool G>
__device__ T qp_solve(const Slab<T>& s, const Lane<R>& L, const T (&ib_lo)[R], const T (&ib_hi)[R],
                      const SolveOptions& opt, T (&xy)[R]) {
  const int n = L.n, D = L.D, nlo = L.nlo, nhi = L.nhi;
  const int lo4 = round4(nlo), hi4 = round4(nhi);  // tile-aligned array strides in scr
  T zero[R];
#pragma unroll
  for (int r = 0; r < R; ++r) zero[r] = T(0);

  assemble_kkt(s, L, false, zero);
  ldlt_factor_warp<T, R, G>(s.A, s.vec, s.tiles, D, L.lane);
  T bad = factor_bad(s.A, D);
  T v[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = L.row(r);
    v[r] = L.var(r) ? -s.c[i] : (L.eqrow(r) ? -s.req[i - n] : T(0));
  }
  ldlt_solve_warp(s.A, D, L.lane, v);
  // x = v on the variable rows, y = -v on the equality rows.
#pragma unroll
  for (int r = 0; r < R; ++r) xy[r] = L.eqrow(r) ? -v[r] : v[r];
  if (L.ncon == 0) return bad;

  // Clamp into the shifted bounds, then slack/dual init (qp.cc:470-481).
  T s_lo[R], s_hi[R], z_lo[R], z_hi[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (L.slo[r] >= 0) xy[r] = nmax(xy[r], -ib_lo[r]);
    if (L.shi[r] >= 0) xy[r] = nmin(xy[r], ib_hi[r]);
    s_lo[r] = s_hi[r] = z_lo[r] = z_hi[r] = T(0);
    if (L.slo[r] >= 0) {
      s_lo[r] = nmax(xy[r] + ib_lo[r], T(1e-9));
      z_lo[r] = T(1) / s_lo[r];
    }
    if (L.shi[r] >= 0) {
      s_hi[r] = nmax(-xy[r] + ib_hi[r], T(1e-9));
      z_hi[r] = T(1) / s_hi[r];
    }
  }

  // Primal and dual step lengths over the lo then the hi slacks: the
  // candidates to scr (lo primal, lo dual, hi primal, hi dual), then an
  // ordered minimum on every lane.
  auto ftb = [&](const T(&ds_lo)[R], const T(&ds_hi)[R], const T(&dz_lo)[R], const T(&dz_hi)[R],
                 T tau_v, T& ap_v, T& ad_v) {
    warp_sync();  // the last readers of scr are done
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const bool lo = L.slo[r] >= 0, hi = L.shi[r] >= 0;
      const int jl = lo ? L.slo[r] : 0, jh = hi ? L.shi[r] : 0;
      put_if<G>(lo, s.scr + jl, ftb_cand(s_lo[r], ds_lo[r], tau_v));
      put_if<G>(lo, s.scr + lo4 + jl, ftb_cand(z_lo[r], dz_lo[r], tau_v));
      put_if<G>(hi, s.scr + 2 * lo4 + jh, ftb_cand(s_hi[r], ds_hi[r], tau_v));
      put_if<G>(hi, s.scr + 2 * lo4 + hi4 + jh, ftb_cand(z_hi[r], dz_hi[r], tau_v));
    }
    pad_tile<G>(s.scr, nlo, T(INFINITY), L.lane);
    pad_tile<G>(s.scr + lo4, nlo, T(INFINITY), L.lane);
    pad_tile<G>(s.scr + 2 * lo4, nhi, T(INFINITY), L.lane);
    pad_tile<G>(s.scr + 2 * lo4 + hi4, nhi, T(INFINITY), L.lane);
    warp_sync();
    ap_v = ad_v = T(1);
    min2_into(ap_v, s.scr, ad_v, s.scr + lo4, nlo);
    min2_into(ap_v, s.scr + 2 * lo4, ad_v, s.scr + 2 * lo4 + hi4, nhi);
  };

  // (0 + sum of the lo terms) + sum of the hi terms, in slack order.
  auto slack_sum = [&](const T(&t_lo)[R], const T(&t_hi)[R]) {
    warp_sync();
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const bool lo = L.slo[r] >= 0, hi = L.shi[r] >= 0;
      put_if<G>(lo, s.scr + (lo ? L.slo[r] : 0), t_lo[r]);
      put_if<G>(hi, s.scr + lo4 + (hi ? L.shi[r] : 0), t_hi[r]);
    }
    pad_tile<G>(s.scr, nlo, T(-0.0), L.lane);
    pad_tile<G>(s.scr + lo4, nhi, T(-0.0), L.lane);
    warp_sync();
    return sum2_terms(s.scr, nlo, s.scr + lo4, nhi);
  };

  T mu = T(1);
  const T tau = T(0.995);
  for (int qit = 0; qit < opt.qp_iterations; ++qit) {
    warp_sync();  // the factor's last use of vec (its w) is done
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (L.row(r) < D) s.vec[L.row(r)] = xy[r];
    }
    warp_sync();
    // KKT residuals (eqs 19.2a-d, qp.cc:391-420): r_d on the variable rows,
    // r_pe on the equality rows, each row's products in index order (the
    // lane's rows side by side).
    T res[R], r_pi_lo[R], r_pi_hi[R], r_c_lo[R], r_c_hi[R], sig_lo[R], sig_hi[R], sig_d[R];
    for (int j = 0; j < n; ++j) {
      const T vj = s.vec[j];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int i = L.row(r);
        const T g = L.var(r) ? s.G[j <= i ? tri(i) + j : tri(j) + i]
                             : s.Jeq[L.eqrow(r) ? (i - n) * n + j : 0];
        res[r] = j == 0 ? g * vj : res[r] + g * vj;
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = L.row(r);
      if (L.var(r)) {
        T r_d = s.c[i] + res[r];
        if (L.m > 0) {
          T acc_t = s.Jeq[i] * s.vec[n];
          for (int k = 1; k < L.m; ++k) acc_t = acc_t + s.Jeq[k * n + i] * s.vec[n + k];
          r_d = r_d - acc_t;
        }
        if (nlo > 0) r_d = r_d - (L.slo[r] >= 0 ? z_lo[r] : T(0));
        if (nhi > 0) r_d = r_d + (L.shi[r] >= 0 ? z_hi[r] : T(0));
        res[r] = r_d;
      } else if (L.eqrow(r)) {
        res[r] = s.req[i - n] + res[r];
      } else {
        res[r] = T(0);
      }
      r_pi_lo[r] = L.slo[r] >= 0 ? xy[r] + ib_lo[r] - s_lo[r] : T(0);
      r_pi_hi[r] = L.shi[r] >= 0 ? -xy[r] + ib_hi[r] - s_hi[r] : T(0);
      r_c_lo[r] = s_lo[r] * z_lo[r];
      r_c_hi[r] = s_hi[r] * z_hi[r];
      sig_lo[r] = L.slo[r] >= 0 ? z_lo[r] / s_lo[r] : T(0);
      sig_hi[r] = L.shi[r] >= 0 ? z_hi[r] / s_hi[r] : T(0);
      sig_d[r] = T(0);
      if (nlo > 0) sig_d[r] = sig_d[r] + (L.slo[r] >= 0 ? sig_lo[r] : T(0));
      if (nhi > 0) sig_d[r] = sig_d[r] + (L.shi[r] >= 0 ? sig_hi[r] : T(0));
    }
    assemble_kkt(s, L, true, sig_d);
    ldlt_factor_warp<T, R, G>(s.A, s.vec, s.tiles, D, L.lane);
    bad = nmax(bad, factor_bad(s.A, D));

    // Condensed solve for a barrier value and corrector terms: d the primal
    // step on variable rows and the dual step on equality rows, and the
    // recovered slack and dual steps.
    auto solve_step = [&](T mu_v, const T(&corr_lo)[R], const T(&corr_hi)[R], T(&d)[R], T(&ds_lo)[R],
                          T(&ds_hi)[R], T(&dz_lo)[R], T(&dz_hi)[R]) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        T rhs = T(0);
        if (L.var(r)) {
          T r_aug = res[r];
          if (nlo > 0)
            r_aug = r_aug + (L.slo[r] >= 0
                                 ? sig_lo[r] * r_pi_lo[r] + (r_c_lo[r] + corr_lo[r] - mu_v) / s_lo[r]
                                 : T(0));
          if (nhi > 0)
            r_aug = r_aug - (L.shi[r] >= 0
                                 ? sig_hi[r] * r_pi_hi[r] + (r_c_hi[r] + corr_hi[r] - mu_v) / s_hi[r]
                                 : T(0));
          rhs = -r_aug;
        } else if (L.eqrow(r)) {
          rhs = -res[r];
        }
        d[r] = rhs;
      }
      ldlt_solve_warp(s.A, D, L.lane, d);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const T sol = d[r];
        d[r] = L.eqrow(r) ? -sol : sol;
        ds_lo[r] = L.slo[r] >= 0 ? sol + r_pi_lo[r] : T(0);
        ds_hi[r] = L.shi[r] >= 0 ? -sol + r_pi_hi[r] : T(0);
        dz_lo[r] = L.slo[r] >= 0 ? -sig_lo[r] * ds_lo[r] - (r_c_lo[r] + corr_lo[r] - mu_v) / s_lo[r] : T(0);
        dz_hi[r] = L.shi[r] >= 0 ? -sig_hi[r] * ds_hi[r] - (r_c_hi[r] + corr_hi[r] - mu_v) / s_hi[r] : T(0);
      }
    };

    T d[R], ds_lo[R], ds_hi[R], dz_lo[R], dz_hi[R];
    if (opt.mpc) {
      // Mehrotra predictor-corrector (alg 16.4 / qp.cc:170-188).
      T da[R], dsl_a[R], dsh_a[R], dzl_a[R], dzh_a[R], ap_a, ad_a;
      solve_step(T(0), zero, zero, da, dsl_a, dsh_a, dzl_a, dzh_a);
      ftb(dsl_a, dsh_a, dzl_a, dzh_a, T(1), ap_a, ad_a);
      T t_lo[R], t_hi[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        t_lo[r] = (s_lo[r] + ap_a * dsl_a[r]) * (z_lo[r] + ad_a * dzl_a[r]);
        t_hi[r] = (s_hi[r] + ap_a * dsh_a[r]) * (z_hi[r] + ad_a * dzh_a[r]);
      }
      T mu_aff = slack_sum(t_lo, t_hi);
      mu_aff = nmax(mu_aff / T(L.ncon), T(0));
      const T ratio = mu_aff / mu;
      const T sigma = ratio * (ratio * ratio);  // jax.lax.integer_pow(ratio, 3)
#pragma unroll
      for (int r = 0; r < R; ++r) {
        t_lo[r] = dsl_a[r] * dzl_a[r];
        t_hi[r] = dsh_a[r] * dzh_a[r];
      }
      solve_step(sigma * mu, t_lo, t_hi, d, ds_lo, ds_hi, dz_lo, dz_hi);
    } else {
      solve_step(mu, zero, zero, d, ds_lo, ds_hi, dz_lo, dz_hi);
    }

    T ap, ad;
    ftb(ds_lo, ds_hi, dz_lo, dz_hi, tau, ap, ad);
    T t_lo[R], t_hi[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (L.var(r)) xy[r] = xy[r] + ap * d[r];
      if (L.eqrow(r)) xy[r] = xy[r] + ad * d[r];
      s_lo[r] = s_lo[r] + ap * ds_lo[r];
      z_lo[r] = z_lo[r] + ad * dz_lo[r];
      s_hi[r] = s_hi[r] + ap * ds_hi[r];
      z_hi[r] = z_hi[r] + ad * dz_hi[r];
      t_lo[r] = s_lo[r] * z_lo[r];
      t_hi[r] = s_hi[r] * z_hi[r];
    }
    const T comp = slack_sum(t_lo, t_hi);
    mu = T(0.1) * (comp / T(L.ncon));
  }
  bool finite = true;
#pragma unroll
  for (int r = 0; r < R; ++r) finite = finite && (!L.var(r) || isfinite(xy[r]));
  bad = nmax(bad, __all_sync(kAll, finite) ? T(0) : T(1));
  return bad;
}

// The caller's tensors: data (B, ROWS) and x0 (B, n) at their element
// strides (instance, row), so that a batch-major tensor and the transposed
// view of a feature-major one are read where they lie; x_out (n, B) and
// state (3, B) written feature-major and contiguous (their transposes are
// the caller's (B, n) and (B, 3)). Writing them batch-major cost kernel 2
// 2-3% at B = 8192, D = 49: ptxas then spilled 104 bytes where it spills 8.
struct BlockedIO {
  const void* data;
  const void* x0;
  void* x_out;
  void* state;
  long long ds[2];  // data: instance, row
  long long xs[2];  // x0: instance, row
};

// The whole fused solve of instance `inst` of family `fam` by one warp
// (this lane: `lane`) on its slab, on the tensors of BlockedIO. G: the slab
// lies in the global scratch.
template <typename T, int R, class F, bool G>
__device__ void blocked_sqp_solve(const F& fam, const T* __restrict__ data, const T* __restrict__ x0,
                                  T* __restrict__ x_out, T* __restrict__ state, long long ds0, long long ds1,
                                  long long xs0, long long xs1, int B, const SolveOptions& opt,
                                  unsigned char* slab, int inst, int lane) {
  Slab<T> s;
  carve<T, F>(fam, slab, &s);
  Lane<R> L;
  L.n = fam.nvar();
  L.m = F::M;
  L.D = L.n + L.m;
  L.nlo = fam.nlo();
  L.nhi = fam.nhi();
  L.ncon = L.nlo + L.nhi;
  L.lane = lane;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    L.slo[r] = L.var(r) ? fam.lo_slot(L.row(r)) : -1;
    L.shi[r] = L.var(r) ? fam.hi_slot(L.row(r)) : -1;
  }
  const int n = L.n, m = L.m;
  const long long b = inst;
  const size_t nb = static_cast<size_t>(B);

  for (int k = lane; k < F::ROWS; k += kWarp) s.tgt[k] = data[b * ds0 + k * ds1];
  fill_tile_table(s.tiles, L.D, lane);
  T th[R], th_best[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    th[r] = L.var(r) ? x0[b * xs0 + L.row(r) * xs1] : T(0);
    if (L.var(r)) s.th[L.row(r)] = th[r];
    // Best-merit iterate under the current penalty, from f_best = +inf
    // (pallas_blocked.py:607-610): a lane whose merit is never finite keeps
    // its start.
    th_best[r] = th[r];
  }

  T lam = T(0.001);
  T penalty = T(0.01);
  T restore = T(0);
  T f_best = T(INFINITY), eq_best = T(0);
  // fac_bad is sticky; lam_maxed holds the last iteration's state.
  T fac_bad = T(0), lam_maxed = T(0);
  T f_pre = T(0), eq_pre = T(0), f_acc = T(0), eq_acc = T(0), accepted = T(0);
  warp_sync();

  for (int it = 0; it < opt.max_iterations; ++it) {
    fam.linearize(lane, s.th, s.tgt, s.scr, s.G, s.Jeq, s.c, s.req, f_pre);
    eq_pre = T(0);
    if (m > 0) {
      eq_pre = fabs(s.req[0]);
      for (int k = 1; k < m; ++k) eq_pre = eq_pre + fabs(s.req[k]);
    }
    const bool better = f_pre + penalty * eq_pre < f_best + penalty * eq_best;
#pragma unroll
    for (int r = 0; r < R; ++r) th_best[r] = better ? th[r] : th_best[r];
    f_best = better ? f_pre : f_best;
    eq_best = better ? eq_pre : eq_best;

    // LM damping, G + lam I (off-diagonal entries gain an exact +0), the
    // slots spread over the lanes.
    for (int p = lane; p < tri(n); p += kWarp) {
      const int i = packed_row(p);
      s.G[p] = s.G[p] + (p - tri(i) == i ? lam : T(0));
    }
    T ib_lo[R], ib_hi[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      ib_lo[r] = L.slo[r] >= 0 ? th[r] - T(fam.lo_val(L.slo[r])) : T(0);
      ib_hi[r] = L.shi[r] >= 0 ? T(fam.hi_val(L.shi[r])) - th[r] : T(0);
    }
    warp_sync();

    T xy[R];
    const T bad_it = qp_solve<T, R, G>(s, L, ib_lo, ib_hi, opt, xy);
    fac_bad = nmax(fac_bad, bad_it);

    // d_f = c . dx and d_eq = sum_k sgn(r_eq,k) (J_k . dx), each product's
    // terms to scr, summed in index order on every lane.
    warp_sync();  // the QP's last readers of scr and vec are done
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = L.row(r);
      if (i < L.D) s.vec[i] = xy[r];
      if (L.var(r)) s.scr[i] = s.c[i] * xy[r];
    }
    pad_tile<G>(s.scr, n, T(-0.0), lane);
    warp_sync();
    const T d_f = sum_terms(s.scr, n);
    T d_eq = T(0);
    if (m > 0) {
      T y_abs = fabs(s.vec[n]);
      for (int k = 1; k < m; ++k) y_abs = nmax(y_abs, fabs(s.vec[n + k]));
      penalty = y_abs > penalty ? y_abs * T(1.01) : penalty;
      for (int k = 0; k < m; ++k) {
        warp_sync();
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (L.var(r)) s.scr[L.row(r)] = s.Jeq[k * n + L.row(r)] * xy[r];
        }
        pad_tile<G>(s.scr, n, T(-0.0), lane);
        warp_sync();
        const T t = sgn(s.req[k]) * sum_terms(s.scr, n);
        d_eq = k == 0 ? t : d_eq + t;
      }
    }
    const T dd = d_f + penalty * d_eq;
    const T merit_pre = f_pre + penalty * eq_pre;

    T alpha = T(1);
    accepted = T(0);
    T dead = T(0);  // lanes whose polynomial fit went invalid
    T best[R];
#pragma unroll
    for (int r = 0; r < R; ++r) best[r] = th[r];
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
      T cand[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        // The family retracts variable i = l + 32 r by itself; the KKT's
        // rows past n are never stored and stay as they are.
        const T step = th[r] + alpha * xy[r];
        cand[r] = L.var(r) ? fam.retract(L.row(r), step) : step;
      }
      warp_sync();  // the family's last reads of th are done
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (L.var(r)) s.th[L.row(r)] = cand[r];
      }
      warp_sync();
      T f_c, eq_c;
      fam.errors(lane, s.th, s.tgt, s.scr, f_c, eq_c);
      const T merit_c = f_c + penalty * eq_c;
      // Armijo with the slack term clamped to <= 0.
      const T ok = merit_c <= merit_pre + T(1e-4) * alpha * nmin(dd, T(0)) ? T(1) : T(0);
      const T take = ok * (T(1) - accepted) * (T(1) - dead);
      // Arithmetic blend, not a select: a NaN candidate poisons `best`
      // exactly as in the JAX kernel.
#pragma unroll
      for (int r = 0; r < R; ++r) best[r] = take * cand[r] + (T(1) - take) * best[r];
      f_acc = take * f_c + (T(1) - take) * f_acc;
      eq_acc = take * eq_c + (T(1) - take) * eq_acc;
      accepted = nmin(accepted + take, T(1));
      alpha_prev2 = alpha_prev;
      phi_prev2 = phi_prev;
      alpha_prev = alpha;
      phi_prev = merit_c;
    }

    warp_sync();
#pragma unroll
    for (int r = 0; r < R; ++r) {
      th[r] = accepted > T(0) ? best[r] : th[r];
      if (L.var(r)) s.th[L.row(r)] = th[r];
    }
    warp_sync();
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
  for (int r = 0; r < R; ++r) {
    if (L.var(r)) x_out[L.row(r) * nb + b] = better ? th[r] : th_best[r];
  }
  if (lane == 0) {
    state[0 * nb + b] = better ? f_fin : f_best;
    state[1 * nb + b] = better ? eq_fin : eq_best;
    state[2 * nb + b] = fac_bad + T(2) * lam_maxed;
  }
}

#ifdef __CUDACC__
// Kernel 2: instance blockIdx.x * W + warp on warp `warp` of a CTA of W
// warps, its slab at warp * slab bytes of the CTA's dynamic shared memory.
template <typename T, int R, class F>
__global__ void __launch_bounds__(kMaxWarps * kWarp)
    blocked_sqp_kernel(F fam, const T* __restrict__ data, const T* __restrict__ x0, T* __restrict__ x_out,
                       T* __restrict__ state, long long ds0, long long ds1, long long xs0, long long xs1, int B,
                       SolveOptions opt) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x / kWarp;
  const int inst = blockIdx.x * (blockDim.x / kWarp) + warp;
  if (inst >= B) return;  // the whole warp, before its first __syncwarp
  const size_t slab = carve<T, F>(fam, nullptr, nullptr);
  blocked_sqp_solve<T, R, F, false>(fam, data, x0, x_out, state, ds0, ds1, xs0, xs1, B, opt, smem + warp * slab,
                                    inst, threadIdx.x % kWarp);
}

// Kernel 2 on the global route: warp w of the grid owns row w of the
// (W * grid, slab bytes) global scratch and solves instances w,
// w + W * grid, ... in turn on it, so the scratch holds a slab per warp of
// the grid, not per instance. A kernel of its own, so that the shared
// route's code stays as it was.
template <typename T, int R, class F>
__global__ void __launch_bounds__(kMaxWarps * kWarp)
    blocked_sqp_global_kernel(F fam, const T* __restrict__ data, const T* __restrict__ x0, T* __restrict__ x_out,
                              T* __restrict__ state, long long ds0, long long ds1, long long xs0, long long xs1,
                              int B, SolveOptions opt, unsigned char* __restrict__ scratch) {
  const int first = blockIdx.x * (blockDim.x / kWarp) + threadIdx.x / kWarp;
  const int stride = gridDim.x * (blockDim.x / kWarp);
  const size_t slab = carve<T, F>(fam, nullptr, nullptr);
  for (int inst = first; inst < B; inst += stride) {
    blocked_sqp_solve<T, R, F, true>(fam, data, x0, x_out, state, ds0, ds1, xs0, xs1, B, opt, scratch + first * slab,
                                     inst, threadIdx.x % kWarp);
  }
}

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

struct LaunchArgs {
  BlockedIO io;
  int B;
  int warps;  // instances per CTA
  SolveOptions opt;
  cudaStream_t stream;
  // The global route: the (slabs, slab_bytes) scratch, one slab per warp of
  // the grid (the grid is slabs / warps CTAs); null for shared slabs.
  void* scratch;
  int slabs;
  long long slab_bytes;
};

// A launcher's arguments (strides: data's instance and row stride, then
// x0's; scratch null, or `slabs` slabs of `slab_bytes`);
// cudaErrorInvalidValue for a budget or scratch the kernel does not take.
inline int launch_args(const void* data, const void* x0, const long long* strides, void* x_out, void* state,
                       int B, int warps, int max_iterations, int qp_iterations, int ls_iterations,
                       int polynomial, int mpc, void* scratch, int slabs, long long slab_bytes, void* stream,
                       LaunchArgs* a) {
  if (max_iterations < 1 || qp_iterations < 0 || ls_iterations < 0 ||
      (scratch != nullptr && (slabs < 1 || warps < 1 || slabs % warps != 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  *a = LaunchArgs{BlockedIO{data, x0, x_out, state, {strides[0], strides[1]}, {strides[2], strides[3]}},
                  B,
                  warps,
                  SolveOptions{max_iterations, qp_iterations, ls_iterations, polynomial != 0, mpc != 0},
                  static_cast<cudaStream_t>(stream),
                  scratch,
                  slabs,
                  slab_bytes};
  return 0;
}

// The arguments of an occupancy query for CTAs of `warps` instances, on the
// global route where `global` holds.
inline LaunchArgs occupancy_args(int warps, bool global) {
  static char placeholder;
  return LaunchArgs{BlockedIO{nullptr, nullptr, nullptr, nullptr, {0, 0}, {0, 0}}, 1, warps,
                    SolveOptions{1, 0, 0, false, false}, nullptr, global ? &placeholder : nullptr, warps, 0};
}

// Kernel 2 with R rows a lane, its slabs in shared memory or (G) in the
// global scratch: a launch, or (occupancy_only) the CTAs of a.warps
// instances that fit one SM, negative on an error. The global route takes
// only a scratch whose slabs hold carve's count.
template <typename T, int R, bool G, class F>
int launch_rows(const F& fam, const LaunchArgs& a, bool occupancy_only) {
  const int threads = a.warps * kWarp;
  const size_t slab = carve<T, F>(fam, nullptr, nullptr);
  const size_t bytes = G ? 0 : static_cast<size_t>(a.warps) * slab;
  if (G && !occupancy_only && slab > static_cast<size_t>(a.slab_bytes)) return kTooLarge;
  auto run = [&](auto kernel, int grid, auto... scratch) {
    const int rc = allow_dynamic_smem(kernel, threads, kMaxWarps * kWarp, bytes);
    if (occupancy_only) {
      if (rc != 0) return rc > 0 ? -rc : rc;
      int blocks = 0;
      const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, bytes);
      return e == cudaSuccess ? blocks : -static_cast<int>(e);
    }
    if (rc != 0) return rc;
    kernel<<<grid, threads, bytes, a.stream>>>(fam, static_cast<const T*>(a.io.data), static_cast<const T*>(a.io.x0),
                                               static_cast<T*>(a.io.x_out), static_cast<T*>(a.io.state), a.io.ds[0],
                                               a.io.ds[1], a.io.xs[0], a.io.xs[1], a.B, a.opt, scratch...);
    return static_cast<int>(cudaGetLastError());
  };
  if constexpr (G) {
    return run(blocked_sqp_global_kernel<T, R, F>, a.slabs / a.warps, static_cast<unsigned char*>(a.scratch));
  } else {
    return run(blocked_sqp_kernel<T, R, F>, (a.B + a.warps - 1) / a.warps);
  }
}

// Kernel 2 on the family's instance with the rows a lane its D takes, on
// the shared route or (G) the global one (which a.scratch must name).
template <typename T, bool G, class F>
int launch_family(const F& fam, const LaunchArgs& a, bool occupancy_only) {
  if (a.warps < 1 || a.warps > kMaxWarps || G != (a.scratch != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int D = fam.nvar() + F::M;
  if constexpr (G) {
    switch (global_rows_per_lane(D)) {
      case 6: return launch_rows<T, 6, true>(fam, a, occupancy_only);
      case 8: return launch_rows<T, 8, true>(fam, a, occupancy_only);
      default: return kTooLarge;
    }
  } else {
    switch (rows_per_lane(D)) {
      case 2: return launch_rows<T, 2, false>(fam, a, occupancy_only);
      case 4: return launch_rows<T, 4, false>(fam, a, occupancy_only);
      case 6: return launch_rows<T, 6, false>(fam, a, occupancy_only);
      default: return kTooLarge;
    }
  }
}

// The instances, each group built in its own source file so that they
// compile in parallel and each file's kernels are the only callers of the
// routines they inline: blocked.cu (the planar chain's shared-route float
// instances, with the C launcher), blocked_f64.cu (double),
// blocked_spatial.cu and blocked_spatial_f64.cu (families.cuh SpatialChain),
// blocked_global.cu, blocked_global_f64.cu, blocked_spatial_global.cu and
// blocked_spatial_global_f64.cu (the global route's).
int launch_planar_float(int n, double link, const LaunchArgs& a, bool occupancy_only);
int launch_planar_double(int n, double link, const LaunchArgs& a, bool occupancy_only);
int launch_spatial_float(int n, double link, const LaunchArgs& a, bool occupancy_only);
int launch_spatial_double(int n, double link, const LaunchArgs& a, bool occupancy_only);
int launch_global_planar_float(int n, double link, const LaunchArgs& a, bool occupancy_only);
int launch_global_planar_double(int n, double link, const LaunchArgs& a, bool occupancy_only);
int launch_global_spatial_float(int n, double link, const LaunchArgs& a, bool occupancy_only);
int launch_global_spatial_double(int n, double link, const LaunchArgs& a, bool occupancy_only);
#endif

}  // namespace blocked
}  // namespace mo
