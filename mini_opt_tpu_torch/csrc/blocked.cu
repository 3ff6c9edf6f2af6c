// The blocked-tier fused solve: the skeleton of blocked_sqp.cuh for the
// planar chain (families.cuh PlanarChain, runtime n), in float and double,
// behind a plain C launcher that ops/blocked.py binds with ctypes.
//
// One instance per CTA on a 1-D grid of B blocks, D = n + 1 rows rounded up
// to whole warps per block, the instance's matrices in dynamic shared
// memory. The launcher runs on the caller's stream (PyTorch's current
// stream), allocates nothing, does not synchronise, and returns the CUDA
// error of the attribute call or of the launch, so that a refused launch is
// reported.
#include <cuda_runtime.h>

#include "blocked_sqp.cuh"
#include "families.cuh"

namespace {

constexpr int kMaxThreads = 256;

template <typename T, class F>
__global__ void __launch_bounds__(kMaxThreads)
    blocked_sqp_kernel(F fam, const T* __restrict__ data, const T* __restrict__ x0,
                       T* __restrict__ x_out, T* __restrict__ state, int B, mo::SolveOptions opt) {
  extern __shared__ __align__(16) unsigned char smem[];
  mo::blocked::blocked_sqp_solve<T, F>(fam, data, x0, x_out, state, B, opt, smem);
}

template <typename T, class F>
int launch(const F& fam, const void* data, const void* x0, void* x_out, void* state, int B,
           const mo::SolveOptions& opt, cudaStream_t stream) {
  const int threads = mo::blocked::block_threads(fam.nvar() + F::M);
  const size_t bytes = mo::blocked::carve<T, F>(fam, nullptr, nullptr);
  const int rc = mo::blocked::allow_dynamic_smem(blocked_sqp_kernel<T, F>, threads, kMaxThreads, bytes);
  if (rc != 0) return rc;
  blocked_sqp_kernel<T, F><<<B, threads, bytes, stream>>>(
      fam, static_cast<const T*>(data), static_cast<const T*>(x0), static_cast<T*>(x_out),
      static_cast<T*>(state), B, opt);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_family(int family, int n, double link, const void* data, const void* x0, void* x_out,
                    void* state, int B, const mo::SolveOptions& opt, cudaStream_t stream) {
  switch (family) {
    case 0: return launch<T>(mo::PlanarChain{n, link}, data, x0, x_out, state, B, opt, stream);
    default: return mo::kNoInstance;
  }
}

}  // namespace

// family: 0 planar; dtype: 0 float, 1 double. Feature-major data (2, B),
// x0 (n, B), x_out (n, B), state (3, B).
extern "C" int mo_blocked_launch(int family, int n, int dtype, const void* data, const void* x0,
                                 void* x_out, void* state, int B, int max_iterations,
                                 int qp_iterations, int ls_iterations, int polynomial, int mpc,
                                 double link, void* stream) {
  if (B <= 0 || n < 1 || max_iterations < 1 || qp_iterations < 0 || ls_iterations < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const mo::SolveOptions opt{max_iterations, qp_iterations, ls_iterations, polynomial != 0,
                             mpc != 0};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch_family<float>(family, n, link, data, x0, x_out, state, B, opt, s);
    case 1: return dispatch_family<double>(family, n, link, data, x0, x_out, state, B, opt, s);
    default: return mo::kNoInstance;
  }
}
