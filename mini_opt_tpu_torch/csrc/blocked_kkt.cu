// Kernel 3, the standalone blocked KKT solve: B dense systems H x = rhs by
// an unpivoted LDL^T, behind a plain C launcher that ops/blocked.py binds
// with ctypes.
//
// Replaces the kernel of mini_opt_tpu/ops/pallas_blocked.py::
// blocked_kkt_solve (inline kernel at pallas_blocked.py:769, launched at
// :797), which factors (D, D, lanes) tiles column by column in VMEM.
//
// What bounds it on this card: bytes in principle, one system's dependent
// chain in practice. A system reads its D (D + 1) / 2 lower-triangle
// entries and the D-entry rhs and writes D entries, against about
// D^3 / 3 + 2 D^2 operations: at D = 49 some 16 operations per byte read,
// below the H100's FP32 ratio of 20. But the factor's D pivot steps and the
// solve's 2 (D - 1) substitution steps depend on one another, and each
// step's shared-memory instructions, not its flops, set its time.
//
// What the design does about it (ops/blocked.py::kkt_launch_plan):
// - D <= 192 (the warp route): one warp per system, W systems per CTA (4,
//   fewer where 4 slabs do not fit 232,448 bytes), the grid ceil(B / W).
//   The warp reads its system's lower triangle row by row (coalesced: H is
//   batch-major, (B, D, D), so system b is one contiguous block) into
//   kernel 2's tiled column layout in its slab of dynamic shared memory
//   (blocked_sqp.cuh colA / cidx, the padding rows zero), factors it with
//   ldlt_factor_warp (the trailing tiles of each pivot spread evenly over
//   the lanes, 16-byte loads and stores) and solves with ldlt_solve_warp
//   (x_k passed from its owner lane by shuffle), lane l owning rows l,
//   l + 32, ... (R = 2, 4 or 6 rows a lane). This route takes every D from
//   1 up: the routines need no minimum size.
// - D > 192 (the CTA route, PR 5's design): one CTA per system, one thread
//   per row, the matrix in shared memory with an odd row stride,
//   ldlt_factor_cta / ldlt_solve_cta; up to D = 239 in float and 169 in
//   double (one CTA's shared memory).
// Both routes keep the operation order of ops/blocked.py::
// _blocked_kkt_solve_plain (each entry's updates A_ij - L_ik w_j in pivot
// order, forward then back substitution), so with no FMA contraction the
// kernel and the plain version round alike.
#include <cuda_runtime.h>

#include "blocked_sqp.cuh"

namespace {

using mo::blocked::colA;
using mo::blocked::kTile;
using mo::blocked::kWarp;
using mo::blocked::round4;

constexpr int kMaxThreads = 256;  // the CTA route's threads (one per row)

// Bytes of one system's slab on the warp route: the tiled lower triangle,
// the factor's w (D, in whole tiles) and the 2-byte tile table, rounded up
// to 16 so that every slab is aligned alike (ops/blocked.py::kkt_slab_slots
// counts the same).
template <typename T>
size_t warp_slab_bytes(int D) {
  const size_t a = static_cast<size_t>(colA(D, D));
  const size_t table = (2 * (a / kTile) + sizeof(T) - 1) / sizeof(T);
  return ((a + round4(D) + table) * sizeof(T) + 15) / 16 * 16;
}

// The warp route: system blockIdx.x * W + warp on warp `warp` of a CTA of W
// warps, its slab at warp * slab bytes of the CTA's dynamic shared memory.
template <typename T, int R>
__global__ void __launch_bounds__(mo::blocked::kMaxWarps * kWarp)
    blocked_kkt_warp_kernel(const T* __restrict__ H, const T* __restrict__ rhs, T* __restrict__ x, int D, int B,
                            int slab_bytes) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int inst = blockIdx.x * (blockDim.x / kWarp) + warp;
  if (inst >= B) return;  // the whole warp, before its first __syncwarp
  T* A = reinterpret_cast<T*>(smem + static_cast<size_t>(warp) * slab_bytes);
  const int tiles_n = colA(D, D) / kTile;
  T* w = A + kTile * tiles_n;
  unsigned short* tiles = reinterpret_cast<unsigned short*>(w + round4(D));
  mo::blocked::fill_tile_table(tiles, D, lane);
  const T zero[kTile] = {T(0), T(0), T(0), T(0)};
  for (int t = lane; t < tiles_n; t += kWarp) mo::blocked::store_tile(A + kTile * t, zero);
  const size_t b = static_cast<size_t>(inst);
  T v[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = lane + r * kWarp;
    const T ri = rhs[b * D + (i < D ? i : 0)];
    v[r] = i < D ? ri : T(0);
  }
  mo::blocked::warp_sync();  // the padding is zero before the entries land
  // The lower triangle, packed by rows: slot p is entry (i, j), j <= i, of
  // row i = packed_row(p); lanes take consecutive slots, kLoads of them in
  // flight before their stores (a slot past the triangle reloads the last
  // one and stores nothing).
  constexpr int kLoads = 8;
  const T* Hb = H + b * D * D;
  const int n_tri = mo::blocked::tri(D);
  for (int p0 = lane; p0 < n_tri; p0 += kLoads * kWarp) {
    T v[kLoads];
    int at[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int p = p0 + u * kWarp < n_tri ? p0 + u * kWarp : n_tri - 1;
      const int i = mo::packed_row(p), j = p - mo::blocked::tri(i);
      v[u] = Hb[static_cast<size_t>(i) * D + j];
      at[u] = mo::blocked::cidx(i, j, D);
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      if (p0 + u * kWarp < n_tri) A[at[u]] = v[u];
    }
  }
  mo::blocked::ldlt_factor_warp<T, R>(A, w, tiles, D, lane);
  mo::blocked::ldlt_solve_warp<T, R>(A, D, lane, v);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = lane + r * kWarp;
    if (i < D) x[b * D + i] = v[r];
  }
}

// The CTA route's shared memory: the matrix with an odd row stride, d, w.
template <typename T>
size_t kkt_smem_bytes(int D) {
  return (static_cast<size_t>(D) * mo::blocked::row_stride(D) + 2 * static_cast<size_t>(D)) *
         sizeof(T);
}

// The CTA route: system blockIdx.x, thread i owning row i.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
    blocked_kkt_kernel(const T* __restrict__ H, const T* __restrict__ rhs, T* __restrict__ x,
                       int D) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int S = mo::blocked::row_stride(D);
  T* A = reinterpret_cast<T*>(smem);
  T* d = A + static_cast<size_t>(D) * S;
  T* w = d + D;
  const int tid = threadIdx.x;
  const size_t b = blockIdx.x;
  const T* Hb = H + b * D * D;
  for (int idx = tid; idx < D * D; idx += blockDim.x) {
    const int r = idx / D, c = idx - r * D;
    if (c <= r) A[r * S + c] = Hb[idx];
  }
  T v = tid < D ? rhs[b * D + tid] : T(0);
  mo::blocked::ldlt_factor_cta(A, d, w, D, S, tid);
  v = mo::blocked::ldlt_solve_cta(A, d, w, D, S, tid, v);
  if (tid < D) x[b * D + tid] = v;
}

struct Args {
  int D;
  const void* H;
  const void* rhs;
  void* x;
  int B;
  int warps;  // systems per CTA on the warp route
  cudaStream_t stream;
};

// A launch, or (occupancy_only) the CTAs that fit one SM, negative on an
// error.
template <typename Kernel>
int finish(Kernel kernel, int threads, int max_threads, size_t bytes, bool occupancy_only) {
  const int rc = mo::blocked::allow_dynamic_smem(kernel, threads, max_threads, bytes);
  if (!occupancy_only) return rc;
  if (rc != 0) return rc > 0 ? -rc : rc;
  int blocks = 0;
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, bytes);
  return e == cudaSuccess ? blocks : -static_cast<int>(e);
}

template <typename T, int R>
int launch_warp(const Args& a, bool occupancy_only) {
  if (a.warps < 1 || a.warps > mo::blocked::kMaxWarps) return static_cast<int>(cudaErrorInvalidValue);
  const size_t slab = warp_slab_bytes<T>(a.D);
  const size_t bytes = static_cast<size_t>(a.warps) * slab;
  const int threads = a.warps * kWarp;
  const int rc = finish(blocked_kkt_warp_kernel<T, R>, threads, mo::blocked::kMaxWarps * kWarp, bytes, occupancy_only);
  if (occupancy_only || rc != 0) return rc;
  const int grid = (a.B + a.warps - 1) / a.warps;
  blocked_kkt_warp_kernel<T, R><<<grid, threads, bytes, a.stream>>>(
      static_cast<const T*>(a.H), static_cast<const T*>(a.rhs), static_cast<T*>(a.x), a.D, a.B,
      static_cast<int>(slab));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const Args& a, bool occupancy_only) {
  switch (mo::blocked::rows_per_lane(a.D)) {
    case 2: return launch_warp<T, 2>(a, occupancy_only);
    case 4: return launch_warp<T, 4>(a, occupancy_only);
    case 6: return launch_warp<T, 6>(a, occupancy_only);
    default: break;
  }
  const int threads = mo::blocked::block_threads(a.D);
  const size_t bytes = kkt_smem_bytes<T>(a.D);
  const int rc = finish(blocked_kkt_kernel<T>, threads, kMaxThreads, bytes, occupancy_only);
  if (occupancy_only || rc != 0) return rc;
  blocked_kkt_kernel<T><<<a.B, threads, bytes, a.stream>>>(
      static_cast<const T*>(a.H), static_cast<const T*>(a.rhs), static_cast<T*>(a.x), a.D);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(int dtype, const Args& a, bool occupancy_only) {
  switch (dtype) {
    case 0: return launch<float>(a, occupancy_only);
    case 1: return launch<double>(a, occupancy_only);
    default: return mo::kNoInstance;
  }
}

}  // namespace

// dtype: 0 float, 1 double. Batch-major H (B, D, D) (lower triangle read),
// rhs (B, D), x (B, D). warps: systems per CTA on the warp route (D <= 192;
// 1..4), ignored on the CTA route. kTooLarge where the route's shared
// memory does not fit one CTA.
extern "C" int mo_blocked_kkt_launch(int dtype, int D, const void* H, const void* rhs, void* x,
                                     int B, int warps, void* stream) {
  if (B <= 0 || D < 1) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch(dtype, Args{D, H, rhs, x, B, warps, static_cast<cudaStream_t>(stream)}, false);
}

// CTAs per SM of kernel 3 at D (warps systems per CTA on the warp route):
// cudaOccupancyMaxActiveBlocksPerMultiprocessor; negative on an error.
extern "C" int mo_blocked_kkt_occupancy(int dtype, int D, int warps) {
  if (D < 1) return -static_cast<int>(cudaErrorInvalidValue);
  return dispatch(dtype, Args{D, nullptr, nullptr, nullptr, 1, warps, nullptr}, true);
}
