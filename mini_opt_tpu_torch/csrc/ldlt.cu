// Kernels 4 and 5: lane-batched LDL^T factor and solve of small dense
// systems (the condensed KKT systems of the QP interior point), behind plain
// C launchers that ops/ldlt.py binds with ctypes.
//
// Replaces the TPU kernels mini_opt_tpu/ops/pallas_ldlt.py::_ldlt_kernel
// (launched at pallas_ldlt.py:115 by _batched_factorize) and
// ::_solve_kernel (launched at :155 by _batched_solve). Both compute, per
// instance, the unpivoted H = L diag(d) L^T of a (D, D) system and the
// forward, 1/d and back substitutions, D ~ 3-40 at run time.
//
// What bounds them on this card: bytes, and below a few thousand systems
// the cost of a launch. A factorization reads its D x D matrix and writes
// D^2 + D entries and a flag, against about D^3 / 3 multiply-adds: at D = 3
// some 15 operations per system, far below the H100's 20 FP32 operations
// per byte. A solve reads L's strict lower triangle, d and the rhs and
// writes D entries for about 2 D^2 operations. At the general path's
// B = 8192, D = 3 either moves under 0.7 MB, a fraction of a microsecond of
// HBM time, so what a launch costs on the card is most of what is left.
//
// What the design does about it (ops/ldlt.py::ldlt_launch_plan; the
// route follows D):
// - D <= kRegisterMaxD (the register route, D a template parameter): one
//   system per thread, 32 threads a CTA, so that B = 8192 spreads over
//   every SM. Each thread issues the loads of its system's whole lower
//   triangle (one contiguous block) before it uses any of them, factors in
//   registers and writes L (the full (D, D) column, with the zeros and the
//   one), d and its health flag ok once, at the end. The solve loads L's
//   strict lower triangle, d and its rhs, substitutes in registers and
//   writes x once. H, rhs and x are batch-major, (B, D, D) and (B, D), as
//   the QP builds and reads them, and L and d feature-major, (D, D, B) and
//   (D, B), which a warp writes and the solve reads coalesced: a
//   factorize + solve pair is two launches and nothing else on the card.
//   A warp's loads of one entry of 32 neighbouring systems touch D^2 words
//   of stride; the warp's systems sit in a few cache lines, which L1 serves
//   to the later loads. (Staging the CTA's run through
//   shared memory with 16-byte loads measured 15-20% slower at D = 3,
//   B = 8192.)
// - D > kRegisterMaxD (the generic route, the first design): one system per
//   thread, 128 threads a CTA, on feature-major tensors, which the wrappers
//   copy; L's earlier columns and x are read back from device memory. (Read
//   batch-major instead, D = 40 at B = 8192 took 1.7x as long.)
//
// Association and order are the Pallas kernels': c = H[:, j] - sum_k
// L[:, k] * (d[k] * L[j, k]) with the sum taken in index order, col = c / d_j
// below the diagonal, 1 on it and 0 above; forward substitution, x / d,
// back substitution, each sum in index order. Built without FMA
// contraction and with IEEE division, the kernels reproduce ops/ldlt.py's
// plain versions bit for bit. The flag is ops/ldlt.py::_ok (and
// pallas_ldlt.py:133-135): every entry of L finite and every |d_j| above the
// type's smallest normal; the diagonal ones and the upper zeros are always
// finite, so the kernel tests the strict lower triangle.
#include <cuda_runtime.h>

#include "fused_sqp.cuh"

namespace {

// The largest D of the register route: ops/ldlt.py::REGISTER_MAX_D, which
// ops/_build.py passes to nvcc. ptxas keeps every instance up to 13 free of
// spills in both types (at D = 14 the double solve spills 8 bytes).
#ifndef MO_LDLT_REGISTER_MAX_D
#error "MO_LDLT_REGISTER_MAX_D (ops/ldlt.py::REGISTER_MAX_D) is set by ops/_build.py"
#endif
constexpr int kRegisterMaxD = MO_LDLT_REGISTER_MAX_D;
constexpr int kRegisterThreads = 32;  // systems a CTA on the register route
constexpr int kGenericThreads = 128;  // systems a CTA on the generic route

// Register route, the factor: system blockIdx.x * blockDim.x + threadIdx.x.
// (The second launch bound keeps ptxas from spilling: with the first alone
// it spilled 8 bytes at D = 7 in double.)
template <typename T, int D>
__global__ void __launch_bounds__(kRegisterThreads, 1)
    ldlt_factor_reg_kernel(const T* __restrict__ H, T* __restrict__ L, T* __restrict__ d,
                           unsigned char* __restrict__ ok, int B) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  // The lower triangle of this system's contiguous D x D block, every load
  // issued before any use; a[i][j] becomes L[i][j] in place as column j is
  // finished.
  const T* h = H + static_cast<size_t>(lane) * D * D;
  T a[D][D];
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j <= i; ++j) a[i][j] = h[i * D + j];
  T dv[D];
  bool good = true;
#pragma unroll
  for (int j = 0; j < D; ++j) {
    T w[D > 1 ? D - 1 : 1];  // w[k] = d[k] * L[j, k]
#pragma unroll
    for (int k = 0; k < j; ++k) w[k] = dv[k] * a[j][k];
    // c_i for every row i >= j; row j's is d_j, every later row's divisor.
#pragma unroll
    for (int i = j; i < D; ++i) {
      T c = a[i][j];
      if (j > 0) {
        T acc = a[i][0] * w[0];
#pragma unroll
        for (int k = 1; k < j; ++k) acc = acc + a[i][k] * w[k];
        c = c - acc;
      }
      a[i][j] = c;
    }
    const T dj = a[j][j];
    dv[j] = dj;
    good &= fabs(dj) > mo::Tiny<T>::value();
#pragma unroll
    for (int i = j + 1; i < D; ++i) {
      a[i][j] = a[i][j] / dj;
      good &= static_cast<bool>(isfinite(a[i][j]));
    }
  }
  const size_t b = static_cast<size_t>(B);
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) L[(i * D + j) * b + lane] = i > j ? a[i][j] : T(i == j ? 1 : 0);
#pragma unroll
  for (int j = 0; j < D; ++j) d[j * b + lane] = dv[j];
  ok[lane] = good;
}

// Register route, the solve: the factor feature-major, rhs and x
// batch-major, each system's D entries contiguous.
template <typename T, int D>
__global__ void __launch_bounds__(kRegisterThreads, 1)
    ldlt_solve_reg_kernel(const T* __restrict__ L, const T* __restrict__ d, const T* __restrict__ rhs,
                          T* __restrict__ x, int B) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  const size_t b = static_cast<size_t>(B);
  T l[D][D];
  T dv[D];
  T y[D];
#pragma unroll
  for (int i = 1; i < D; ++i)
#pragma unroll
    for (int j = 0; j < i; ++j) l[i][j] = L[(i * D + j) * b + lane];
#pragma unroll
  for (int j = 0; j < D; ++j) {
    dv[j] = d[j * b + lane];
    y[j] = rhs[static_cast<size_t>(lane) * D + j];
  }
  // Forward substitution with unit-lower L: y_j = rhs_j - L[j, :j] . y[:j].
#pragma unroll
  for (int j = 1; j < D; ++j) {
    T s = l[j][0] * y[0];
#pragma unroll
    for (int k = 1; k < j; ++k) s = s + l[j][k] * y[k];
    y[j] = y[j] - s;
  }
#pragma unroll
  for (int j = 0; j < D; ++j) y[j] = y[j] / dv[j];
  // Back substitution with L^T: x_j -= L[j+1:, j] . x[j+1:].
#pragma unroll
  for (int j = D - 2; j >= 0; --j) {
    T s = l[j + 1][j] * y[j + 1];
#pragma unroll
    for (int k = j + 2; k < D; ++k) s = s + l[k][j] * y[k];
    y[j] = y[j] - s;
  }
#pragma unroll
  for (int j = 0; j < D; ++j) x[static_cast<size_t>(lane) * D + j] = y[j];
}

// Generic route, the factor (the first design's kernel and the flag):
// feature-major H and L (D, D, B), d (D, B).
template <typename T>
__global__ void __launch_bounds__(kGenericThreads)
    ldlt_factor_kernel(const T* __restrict__ H, T* __restrict__ L, T* __restrict__ d,
                       unsigned char* __restrict__ ok, int D, int B) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  const size_t b = static_cast<size_t>(B);
  // Entry (i, j) of this lane's matrix.
  auto at = [&](int i, int j) { return (static_cast<size_t>(i) * D + j) * b + lane; };
  bool good = true;
  for (int j = 0; j < D; ++j) {
    // The diagonal first: d_j is every later row's divisor.
    T dj = H[at(j, j)];
    if (j > 0) {
      T acc = L[at(j, 0)] * (d[lane] * L[at(j, 0)]);
      for (int k = 1; k < j; ++k) acc = acc + L[at(j, k)] * (d[k * b + lane] * L[at(j, k)]);
      dj = dj - acc;
    }
    d[j * b + lane] = dj;
    good &= fabs(dj) > mo::Tiny<T>::value();
    for (int i = 0; i < j; ++i) L[at(i, j)] = T(0);
    L[at(j, j)] = T(1);
    for (int i = j + 1; i < D; ++i) {
      T c = H[at(i, j)];
      if (j > 0) {
        T acc = L[at(i, 0)] * (d[lane] * L[at(j, 0)]);
        for (int k = 1; k < j; ++k) acc = acc + L[at(i, k)] * (d[k * b + lane] * L[at(j, k)]);
        c = c - acc;
      }
      c = c / dj;
      L[at(i, j)] = c;
      good &= static_cast<bool>(isfinite(c));
    }
  }
  ok[lane] = good;
}

// Generic route, the solve: feature-major L (D, D, B), d, rhs and x (D, B).
template <typename T>
__global__ void __launch_bounds__(kGenericThreads)
    ldlt_solve_kernel(const T* __restrict__ L, const T* __restrict__ d,
                      const T* __restrict__ rhs, T* __restrict__ x, int D, int B) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
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

struct Launch {
  int D;
  const void* in;  // H (factor) or L (solve)
  const void* d;   // the solve's d
  const void* rhs;
  void* out;  // L (factor) or x (solve)
  void* d_out;
  void* ok;
  int B;
  cudaStream_t stream;
};

// The register route's instance for a.D (1 <= a.D <= kRegisterMaxD).
template <typename T, int D = 1>
int launch_register(bool factor, const Launch& a) {
  if constexpr (D < kRegisterMaxD) {
    if (a.D > D) return launch_register<T, D + 1>(factor, a);
  }
  const int grid = (a.B - 1) / kRegisterThreads + 1;
  if (factor) {
    ldlt_factor_reg_kernel<T, D><<<grid, kRegisterThreads, 0, a.stream>>>(
        static_cast<const T*>(a.in), static_cast<T*>(a.out), static_cast<T*>(a.d_out),
        static_cast<unsigned char*>(a.ok), a.B);
  } else {
    ldlt_solve_reg_kernel<T, D><<<grid, kRegisterThreads, 0, a.stream>>>(
        static_cast<const T*>(a.in), static_cast<const T*>(a.d), static_cast<const T*>(a.rhs),
        static_cast<T*>(a.out), a.B);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(bool factor, const Launch& a) {
  if (a.D <= kRegisterMaxD) return launch_register<T>(factor, a);
  const int grid = (a.B - 1) / kGenericThreads + 1;
  if (factor) {
    ldlt_factor_kernel<T><<<grid, kGenericThreads, 0, a.stream>>>(
        static_cast<const T*>(a.in), static_cast<T*>(a.out), static_cast<T*>(a.d_out),
        static_cast<unsigned char*>(a.ok), a.D, a.B);
  } else {
    ldlt_solve_kernel<T><<<grid, kGenericThreads, 0, a.stream>>>(
        static_cast<const T*>(a.in), static_cast<const T*>(a.d), static_cast<const T*>(a.rhs),
        static_cast<T*>(a.out), a.D, a.B);
  }
  return static_cast<int>(cudaGetLastError());
}

int dispatch(int dtype, bool factor, const Launch& a) {
  if (a.B <= 0 || a.D < 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case 0: return launch<float>(factor, a);
    case 1: return launch<double>(factor, a);
    default: return mo::kNoInstance;
  }
}

}  // namespace

// dtype: 0 float, 1 double. H (lower triangle read) batch-major (B, D, D)
// up to kRegisterMaxD (the register route), feature-major (D, D, B) past it
// (the generic route); writes feature-major L (D, D, B) and d (D, B), and
// ok (B,) as bytes 0 or 1.
extern "C" int mo_ldlt_factor_launch(int dtype, int D, const void* H, void* L, void* d, void* ok, int B,
                                     void* stream) {
  return dispatch(dtype, true, Launch{D, H, nullptr, nullptr, L, d, ok, B, static_cast<cudaStream_t>(stream)});
}

// dtype: 0 float, 1 double. Feature-major L (D, D, B) and d (D, B); rhs
// and x batch-major (B, D) on the register route, feature-major (D, B) on
// the generic one.
extern "C" int mo_ldlt_solve_launch(int dtype, int D, const void* L, const void* d, const void* rhs, void* x,
                                    int B, void* stream) {
  return dispatch(dtype, false, Launch{D, L, d, rhs, x, nullptr, nullptr, B, static_cast<cudaStream_t>(stream)});
}
