// Lane-batched LDL^T factor and solve of small dense systems (the
// condensed KKT systems of the QP interior point), behind plain C launchers
// that ops/ldlt.py binds with ctypes.
//
// Replaces the TPU kernels mini_opt_tpu/ops/pallas_ldlt.py::_ldlt_kernel
// (launched at pallas_ldlt.py:115 by _batched_factorize) and
// ::_solve_kernel (launched at :155 by _batched_solve). Both compute, per
// instance, the unpivoted H = L diag(d) L^T of a (D, D) system and the
// forward, 1/d and back substitutions, D ~ 3-40 at run time.
//
// What bounds them on this card: bytes. A factorization reads the lower
// triangle, D (D + 1) / 2 entries, and writes D^2 + D, against about D^3 / 3
// multiply-adds: at D = 3 that is 5 operations per entry moved, far below
// the H100's 20 FP32 operations per byte. A solve reads L's lower triangle,
// d and the rhs and writes D entries for about 2 D^2 operations.
//
// What the design does about it: one instance per thread and the
// feature-major layout the TPU kernel uses, (D, D, B) and (D, B), so that
// the 32 threads of a warp reading one matrix entry read 32 neighbouring
// words: every load and store is coalesced and each byte crosses the bus
// once. The factor writes L to device memory column by column and reads
// the earlier columns back (from L1/L2), as the Pallas kernel reads l_ref;
// the solve works in the output buffer, as the Pallas kernel works in
// x_ref. No padding lanes: the ragged edge is masked.
//
// Association and order are the Pallas kernels': c = H[:, j] - sum_k
// L[:, k] * (d[k] * L[j, k]) with the sum taken in index order, col = c / d_j
// below the diagonal, 1 on it and 0 above; forward substitution, x / d,
// back substitution, each sum in index order. Built without FMA
// contraction, the kernels reproduce ops/ldlt.py's plain versions bit for
// bit.
#include <cuda_runtime.h>

#include "fused_sqp.cuh"

namespace {

constexpr int kBlock = 128;

template <typename T>
__global__ void __launch_bounds__(kBlock)
    ldlt_factor_kernel(const T* __restrict__ H, T* __restrict__ L, T* __restrict__ d, int D,
                       int B) {
  const int lane = blockIdx.x * kBlock + threadIdx.x;
  if (lane >= B) return;
  const size_t b = static_cast<size_t>(B);
  // Entry (i, j) of this lane's matrix.
  auto at = [&](int i, int j) { return (static_cast<size_t>(i) * D + j) * b + lane; };
  for (int j = 0; j < D; ++j) {
    // The diagonal first: d_j is every later row's divisor.
    T dj = H[at(j, j)];
    if (j > 0) {
      T acc = L[at(j, 0)] * (d[lane] * L[at(j, 0)]);
      for (int k = 1; k < j; ++k) acc = acc + L[at(j, k)] * (d[k * b + lane] * L[at(j, k)]);
      dj = dj - acc;
    }
    d[j * b + lane] = dj;
    for (int i = 0; i < j; ++i) L[at(i, j)] = T(0);
    L[at(j, j)] = T(1);
    for (int i = j + 1; i < D; ++i) {
      T c = H[at(i, j)];
      if (j > 0) {
        T acc = L[at(i, 0)] * (d[lane] * L[at(j, 0)]);
        for (int k = 1; k < j; ++k) acc = acc + L[at(i, k)] * (d[k * b + lane] * L[at(j, k)]);
        c = c - acc;
      }
      L[at(i, j)] = c / dj;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kBlock)
    ldlt_solve_kernel(const T* __restrict__ L, const T* __restrict__ d,
                      const T* __restrict__ rhs, T* __restrict__ x, int D, int B) {
  const int lane = blockIdx.x * kBlock + threadIdx.x;
  if (lane >= B) return;
  const size_t b = static_cast<size_t>(B);
  auto at = [&](int i, int j) { return (static_cast<size_t>(i) * D + j) * b + lane; };
  // Forward substitution with unit-lower L: y_j = rhs_j - L[j, :j] . y[:j].
  for (int j = 0; j < D; ++j) {
    T acc = rhs[j * b + lane];
    if (j > 0) {
      T s = L[at(j, 0)] * x[lane];
      for (int k = 1; k < j; ++k) s = s + L[at(j, k)] * x[k * b + lane];
      acc = acc - s;
    }
    x[j * b + lane] = acc;
  }
  for (int j = 0; j < D; ++j) x[j * b + lane] = x[j * b + lane] / d[j * b + lane];
  // Back substitution with L^T: x_j -= L[j+1:, j] . x[j+1:].
  for (int j = D - 2; j >= 0; --j) {
    T s = L[at(j + 1, j)] * x[(j + 1) * b + lane];
    for (int k = j + 2; k < D; ++k) s = s + L[at(k, j)] * x[k * b + lane];
    x[j * b + lane] = x[j * b + lane] - s;
  }
}

int grid(int B) { return (B + kBlock - 1) / kBlock; }

}  // namespace

// dtype: 0 float, 1 double. Feature-major H and L (D, D, B), d (D, B).
extern "C" int mo_ldlt_factor_launch(int dtype, int D, const void* H, void* L, void* d, int B,
                                     void* stream) {
  if (B <= 0 || D < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      ldlt_factor_kernel<float><<<grid(B), kBlock, 0, s>>>(
          static_cast<const float*>(H), static_cast<float*>(L), static_cast<float*>(d), D, B);
      break;
    case 1:
      ldlt_factor_kernel<double><<<grid(B), kBlock, 0, s>>>(
          static_cast<const double*>(H), static_cast<double*>(L), static_cast<double*>(d), D, B);
      break;
    default:
      return mo::kNoInstance;
  }
  return static_cast<int>(cudaGetLastError());
}

// dtype: 0 float, 1 double. Feature-major L (D, D, B), d, rhs and x (D, B).
extern "C" int mo_ldlt_solve_launch(int dtype, int D, const void* L, const void* d,
                                    const void* rhs, void* x, int B, void* stream) {
  if (B <= 0 || D < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      ldlt_solve_kernel<float><<<grid(B), kBlock, 0, s>>>(
          static_cast<const float*>(L), static_cast<const float*>(d),
          static_cast<const float*>(rhs), static_cast<float*>(x), D, B);
      break;
    case 1:
      ldlt_solve_kernel<double><<<grid(B), kBlock, 0, s>>>(
          static_cast<const double*>(L), static_cast<const double*>(d),
          static_cast<const double*>(rhs), static_cast<double*>(x), D, B);
      break;
    default:
      return mo::kNoInstance;
  }
  return static_cast<int>(cudaGetLastError());
}
