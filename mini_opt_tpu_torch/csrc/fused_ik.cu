// The fused IK kernel: instances of the solver skeleton (fused_sqp.cuh) for
// the planar and spatial families (families.cuh), N = 2..8, in float and
// double, behind a plain C launcher that ops/fused_ik.py binds with ctypes.
//
// One instance per thread, blocks of 128 threads on a 1-D grid; thread
// `lane` reads column `lane` of the feature-major inputs and masks the
// ragged edge. The launcher runs on the caller's stream (PyTorch's current
// stream), allocates nothing, does not synchronise, and returns
// cudaGetLastError() so that a refused launch is reported.
#include <cuda_runtime.h>

#include "families.cuh"
#include "fused_sqp.cuh"

namespace {

constexpr int kBlock = 128;
constexpr int kNoInstance = -1;

template <typename T, class F>
__global__ void __launch_bounds__(kBlock)
    fused_ik_kernel(F fam, const T* __restrict__ data, const T* __restrict__ x0,
                    T* __restrict__ x_out, T* __restrict__ state, T* __restrict__ hist, int B,
                    mo::SolveOptions opt) {
  const int lane = blockIdx.x * kBlock + threadIdx.x;
  if (lane >= B) return;
  mo::fused_sqp_solve<T, F>(fam, data, x0, x_out, state, hist, B, lane, opt);
}

struct LaunchArgs {
  const void* data;
  const void* x0;
  void* x_out;
  void* state;
  void* hist;
  int B;
  mo::SolveOptions opt;
  cudaStream_t stream;
};

template <typename T, class F>
int launch(const F& fam, const LaunchArgs& a) {
  const int grid = (a.B + kBlock - 1) / kBlock;
  fused_ik_kernel<T, F><<<grid, kBlock, 0, a.stream>>>(
      fam, static_cast<const T*>(a.data), static_cast<const T*>(a.x0), static_cast<T*>(a.x_out),
      static_cast<T*>(a.state), static_cast<T*>(a.hist), a.B, a.opt);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, template <int> class Fam>
int dispatch_n(int n, double link, const LaunchArgs& a) {
  switch (n) {
    case 2: return launch<T>(Fam<2>{{}, link}, a);
    case 3: return launch<T>(Fam<3>{{}, link}, a);
    case 4: return launch<T>(Fam<4>{{}, link}, a);
    case 5: return launch<T>(Fam<5>{{}, link}, a);
    case 6: return launch<T>(Fam<6>{{}, link}, a);
    case 7: return launch<T>(Fam<7>{{}, link}, a);
    case 8: return launch<T>(Fam<8>{{}, link}, a);
    default: return kNoInstance;
  }
}

template <typename T>
int dispatch_family(int family, int n, double link, const LaunchArgs& a) {
  switch (family) {
    case 0: return dispatch_n<T, mo::Planar>(n, link, a);
    case 1: return dispatch_n<T, mo::Spatial>(n, link, a);
    default: return kNoInstance;
  }
}

}  // namespace

// family: 0 planar, 1 spatial; dtype: 0 float, 1 double. hist may be NULL.
extern "C" int mo_fused_ik_launch(int family, int n, int dtype, const void* data, const void* x0,
                                  void* x_out, void* state, void* hist, int B,
                                  int max_iterations, int qp_iterations, int ls_iterations,
                                  int polynomial, int mpc, double link, void* stream) {
  if (B <= 0 || max_iterations < 1 || qp_iterations < 0 || ls_iterations < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const LaunchArgs a{data, x0, x_out, state, hist, B,
                     mo::SolveOptions{max_iterations, qp_iterations, ls_iterations,
                                      polynomial != 0, mpc != 0},
                     static_cast<cudaStream_t>(stream)};
  switch (dtype) {
    case 0: return dispatch_family<float>(family, n, link, a);
    case 1: return dispatch_family<double>(family, n, link, a);
    default: return kNoInstance;
  }
}

extern "C" const char* mo_cuda_error_string(int rc) {
  if (rc == kNoInstance) return "no kernel instance for this family, n and dtype";
  return cudaGetErrorString(static_cast<cudaError_t>(rc));
}
