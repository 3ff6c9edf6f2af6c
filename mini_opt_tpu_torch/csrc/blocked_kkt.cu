// The standalone blocked KKT solve: B dense systems H x = rhs by an
// unpivoted LDL^T, one system per CTA, behind a plain C launcher that
// ops/blocked.py binds with ctypes.
//
// Replaces the kernel of mini_opt_tpu/ops/pallas_blocked.py::
// blocked_kkt_solve (inline kernel at pallas_blocked.py:769, launched at
// :797), which factors (D, D, lanes) tiles column by column in VMEM.
//
// What bounds it on this card: bytes, at the blocked tier's sizes. A system
// reads its D (D + 1) / 2 lower-triangle entries and the D-entry rhs and
// writes D entries, against about D^3 / 3 + 2 D^2 operations: at D = 49
// some 16 operations per byte read, below the H100's FP32 ratio of 20.
// In practice the factor's D dependent steps, each ending in a barrier,
// bound a lone CTA.
//
// What the design does about it: the CTA loads its matrix once, coalesced
// (H is batch-major, (B, D, D), so system b is one contiguous block), into
// dynamic shared memory with an odd row stride, factors and solves it there
// with the routines of blocked_sqp.cuh (one thread per row; the same
// operation order as ops/blocked.py::_blocked_kkt_solve_plain), and writes
// the D solution entries. Many CTAs per SM overlap one another's barriers
// and loads.
#include <cuda_runtime.h>

#include "blocked_sqp.cuh"

namespace {

constexpr int kMaxThreads = 256;

template <typename T>
size_t kkt_smem_bytes(int D) {
  return (static_cast<size_t>(D) * mo::blocked::row_stride(D) + 2 * static_cast<size_t>(D)) *
         sizeof(T);
}

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

template <typename T>
int launch(int D, const void* H, const void* rhs, void* x, int B, cudaStream_t stream) {
  const int threads = mo::blocked::block_threads(D);
  const size_t bytes = kkt_smem_bytes<T>(D);
  const int rc = mo::blocked::allow_dynamic_smem(blocked_kkt_kernel<T>, threads, kMaxThreads, bytes);
  if (rc != 0) return rc;
  blocked_kkt_kernel<T><<<B, threads, bytes, stream>>>(
      static_cast<const T*>(H), static_cast<const T*>(rhs), static_cast<T*>(x), D);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 float, 1 double. Batch-major H (B, D, D) (lower triangle read),
// rhs (B, D), x (B, D).
extern "C" int mo_blocked_kkt_launch(int dtype, int D, const void* H, const void* rhs, void* x,
                                     int B, void* stream) {
  if (B <= 0 || D < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(D, H, rhs, x, B, s);
    case 1: return launch<double>(D, H, rhs, x, B, s);
    default: return mo::kNoInstance;
  }
}
