// Kernel 1's launch, shared by its hand-written instances (fused_ik.cu,
// the families of families.cuh) and by each family that ops/fused_emit.py
// emits from a Problem (one generated .cu per family, built at first use):
// the __global__ wrapper around the solver skeleton (fused_sqp.cuh) and the
// launcher's checks, so that every route runs the same kernel.
//
// One instance per thread, blocks of 128 threads on a 1-D grid; thread
// `lane` reads row `lane` of the batch-major inputs at their strides and
// masks the ragged edge. A launcher runs on the caller's stream (PyTorch's
// current stream), allocates nothing, does not synchronise, and returns
// cudaGetLastError() so that a refused launch is reported.
#pragma once

#include <cuda_runtime.h>

#include "fused_sqp.cuh"

namespace {

constexpr int kBlock = 128;

template <typename T, class F>
__global__ void __launch_bounds__(kBlock)
    fused_ik_kernel(F fam, const mo::SqpIO io, int B, mo::SolveOptions opt) {
  const int lane = blockIdx.x * kBlock + threadIdx.x;
  if (lane >= B) return;
  mo::fused_sqp_solve<T, F>(fam, io, lane, opt);
}

struct LaunchArgs {
  mo::SqpIO io;
  int B;
  mo::SolveOptions opt;
  cudaStream_t stream;
};

// The launcher's arguments: data (B, rows) and x0 (B, n) at the element
// strides in `strides` (data 2, x0 2); x_out (B, n), state (B, 3) and hist
// (B, max_iterations, 7 + n) contiguous, hist may be NULL. Returns
// cudaErrorInvalidValue for a budget or batch the kernel does not take.
inline int launch_args(const void* data, const void* x0, const long long* strides, void* x_out,
                       void* state, void* hist, int B, int max_iterations, int qp_iterations,
                       int ls_iterations, int polynomial, int mpc, void* stream, LaunchArgs* a) {
  if (B <= 0 || max_iterations < 1 || qp_iterations < 0 || ls_iterations < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  *a = LaunchArgs{mo::SqpIO{data, x0, x_out, state, hist, {strides[0], strides[1]}, {strides[2], strides[3]}},
                  B,
                  mo::SolveOptions{max_iterations, qp_iterations, ls_iterations, polynomial != 0, mpc != 0},
                  static_cast<cudaStream_t>(stream)};
  return 0;
}

template <typename T, class F>
int launch(const F& fam, const LaunchArgs& a) {
  const int grid = (a.B + kBlock - 1) / kBlock;
  fused_ik_kernel<T, F><<<grid, kBlock, 0, a.stream>>>(fam, a.io, a.B, a.opt);
  return static_cast<int>(cudaGetLastError());
}

// Text of any launcher's return code (fused_sqp.cuh's, or CUDA's).
inline const char* error_text(int rc) {
  if (rc == mo::kNoInstance) return "no kernel instance for this family, n and dtype";
  if (rc == mo::kTooLarge) return "the system does not fit one CTA (threads or shared memory)";
  return cudaGetErrorString(static_cast<cudaError_t>(rc));
}

}  // namespace
