// Kernel 2's launch for each family that ops/fused_emit.py's blocked target
// emits from a Problem (one generated .cu per family, built at first use),
// the counterpart of fused_ik_launch.cuh for kernel 1: the routines the
// emitted functor calls, and the launcher that instantiates
// blocked_sqp_kernel<T, R, GeneratedFamily> (or, on the global route,
// blocked_sqp_global_kernel) for the R that the family's D
// takes (2, 4 or 6 KKT rows a lane on the shared route, G false; 6 or 8 on
// the global route past D = 128), in float and double.
//
// The functor has PlanarChain's interface (families.cuh): nvar(), M, ROWS,
// nlo() / nhi(), lo_slot / hi_slot / lo_val / hi_val, scratch(), retract(i, a)
// (variable i's retraction of the value a),
// and the warp-cooperative linearize(lane, th, tgt, scr, G, Jeq, c, req, f)
// and errors(lane, th, tgt, scr, f, eq), G the Hessian's lower triangle
// packed by rows. Its work is split over the warp by residual block: a
// block's rows and the columns of its Jacobian depend on no other block, so
// lane l evaluates the blocks l, l + 32, ... of the family's blocks (its
// emitted per-block program, one statement per aten operation of the plain
// version's per-block evaluation) into the slab's scratch, and after a
// __syncwarp the routines below sum them into f, G, c and take r_eq and J_eq,
// in the plain linearize's order (ops/fused_auto.py::family_from_problem):
// - G, c and J_eq start each linearization as exact zeros (the solve damps
//   G's diagonal in place, so a cell is not left from the last one);
// - the Hessian and the gradient block by block, a __syncwarp between two
//   blocks; within one block the lanes take its cells side by side (the
//   cells of one block are distinct: the emitter refuses a block that reads
//   a variable twice), each cell's terms in k order, starting from the
//   cell's value. A product's operands may come in either order: IEEE
//   multiplication commutes exactly;
// - f (and |eq|_1) by every lane, block by block, row by row, so that every
//   lane holds the same scalar;
// - the equality rows, each entry of the blocks' cells written once.
#pragma once

#include <cuda_runtime.h>

#include "blocked_sqp.cuh"

namespace mo {
namespace gen {

constexpr int kLanes = 32;

// The first of the blocks a lane evaluates, the blocks of all groups dealt
// to the lanes in one run: group block b is block `first + b` of the family.
__device__ __forceinline__ int first_block(int lane, int first) { return (lane - first % kLanes + kLanes) % kLanes; }

// One element of a block's data row: payload row `src`, or the constant `value`.
template <typename T>
__device__ __forceinline__ T drow(const T* tgt, int src, T value) {
  return src >= 0 ? tgt[src] : value;
}

// The cost blocks of one group, block by block: `out` holds each block's
// rows (DIM) then the columns of its Jacobian a-major (P x DIM), K = DIM (1
// + P) slots a block; `ix` each block's P variables. Item t < P (P + 1) / 2
// is the cell of local variables (a, a2), a2 <= a; item P (P + 1) / 2 + a the
// gradient entry of variable a.
template <typename T, int P, int DIM>
__device__ void scatter_cost(int lane, int nb, const int* ix, const T* out, T* G, T* c) {
  constexpr int NP = P * (P + 1) / 2, K = DIM * (1 + P);
  for (int b = 0; b < nb; ++b) {
    const T* o = out + b * K;
    const int* idx = ix + b * P;
    for (int t = lane; t < NP + P; t += kLanes) {
      if (t < NP) {
        const int a = packed_row(t), a2 = t - a * (a + 1) / 2;
        const int ga = idx[a], gb = idx[a2];
        T* g = G + (ga >= gb ? ga * (ga + 1) / 2 + gb : gb * (gb + 1) / 2 + ga);
        T acc = *g;
        for (int k = 0; k < DIM; ++k) acc = acc + o[DIM + a * DIM + k] * o[DIM + a2 * DIM + k];
        *g = acc;
      } else {
        const int a = t - NP;
        T acc = c[idx[a]];
        for (int k = 0; k < DIM; ++k) acc = acc + o[DIM + a * DIM + k] * o[k];
        c[idx[a]] = acc;
      }
    }
    __syncwarp();
  }
}

// f + sum over the blocks and their rows of 0.5 r r, in order.
template <typename T, int DIM, int K>
__device__ T sum_squares(T f, int nb, const T* out) {
  for (int b = 0; b < nb; ++b) {
    for (int k = 0; k < DIM; ++k) {
      const T r = out[b * K + k];
      f = f + T(0.5) * r * r;
    }
  }
  return f;
}

// eq + sum over the blocks and their rows of |r|, in order.
template <typename T, int DIM, int K>
__device__ T sum_abs(T eq, int nb, const T* out) {
  for (int b = 0; b < nb; ++b) {
    for (int k = 0; k < DIM; ++k) eq = eq + fabs(out[b * K + k]);
  }
  return eq;
}

// The equality blocks of one group: rows row0, row0 + 1, ... of r_eq and of
// J_eq (n columns), the lanes over every (block, row, entry).
template <typename T, int P, int DIM>
__device__ void scatter_eq(int lane, int nb, const int* ix, const T* out, int row0, int n, T* req, T* Jeq) {
  constexpr int K = DIM * (1 + P);
  for (int t = lane; t < nb * K; t += kLanes) {
    const int b = t / K, u = t - b * K, k = u % DIM, a = u / DIM - 1;  // a = -1: the residual
    const T* o = out + b * K;
    const int row = row0 + b * DIM + k;
    if (a < 0) {
      req[row] = o[k];
    } else {
      Jeq[row * n + ix[b * P + a]] = o[DIM + a * DIM + k];
    }
  }
}

// Kernel 2 on the family with the rows a lane its D takes, in `dtype` (0
// float, 1 double), on the shared route or (a.scratch) the global one: a
// launch, or (occupancy_only) the CTAs of a.warps instances that fit one SM.
// The shared route's instance exists up to D = 192, the global route's from
// D = 129 (below that a slab fits a CTA) to 256; kNoInstance elsewhere.
template <class F>
int launch_generated(const F& fam, int dtype, const blocked::LaunchArgs& a, bool occupancy_only) {
  constexpr int D = F::N + F::M;
  constexpr int R = blocked::rows_per_lane(D), RG = blocked::global_rows_per_lane(D);
  static_assert(RG > 0, "kernel 2 takes D = n + m up to 256");
  if (a.B <= 0 || a.warps < 1 || a.warps > blocked::kMaxWarps) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype != 0 && dtype != 1) return kNoInstance;
  if (a.scratch != nullptr) {
    if constexpr (D > 128) {
      return dtype == 0 ? blocked::launch_rows<float, RG, true>(fam, a, occupancy_only)
                        : blocked::launch_rows<double, RG, true>(fam, a, occupancy_only);
    }
    return kNoInstance;
  }
  if constexpr (R > 0) {
    return dtype == 0 ? blocked::launch_rows<float, R, false>(fam, a, occupancy_only)
                      : blocked::launch_rows<double, R, false>(fam, a, occupancy_only);
  }
  return kNoInstance;
}

// Text of the launcher's return code (blocked_sqp.cuh's, or CUDA's).
inline const char* error_text(int rc) {
  if (rc == kNoInstance) return "no kernel instance for this dtype";
  if (rc == kTooLarge) return "the system does not fit one CTA (threads or shared memory)";
  return cudaGetErrorString(static_cast<cudaError_t>(rc));
}

}  // namespace gen
}  // namespace mo
