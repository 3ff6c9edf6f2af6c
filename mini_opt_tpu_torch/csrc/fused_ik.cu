// One hand-written instance of the fused IK kernel: the solver skeleton
// (fused_sqp.cuh) on the planar or spatial family (families.cuh) at one
// chain length and type, behind a plain C launcher that ops/fused_ik.py binds
// with ctypes. The kernel and its launch are in fused_ik_launch.cuh, which
// the families emitted from a Problem (ops/fused_emit.py) share.
//
// This file is not part of the main library: ops/_build.py builds it once per
// (family, n, type) at first use, each with its own nvcc, passing
//   MO_IK_FAMILY   0 planar, 1 spatial
//   MO_IK_N        the chain length
//   MO_IK_DOUBLE   0 float, 1 double
//   MO_FUSED_IK_MIN_N / MO_FUSED_IK_MAX_N   the chain lengths the port takes
//                  (ops/fused_ik.py CUDA_MIN_N / CUDA_MAX_N, their one home)
// so that a process builds only the instances it launches. A fully unrolled
// instance at n = 31 is large; building all 124 in one file would put every
// one of them on the path of every process.
#include <type_traits>

#include "families.cuh"
#include "fused_ik_launch.cuh"

#if !defined(MO_IK_FAMILY) || !defined(MO_IK_N) || !defined(MO_IK_DOUBLE) || !defined(MO_FUSED_IK_MIN_N) || \
    !defined(MO_FUSED_IK_MAX_N)
#error "fused_ik.cu is built per instance by ops/_build.py::build_fused_ik"
#endif
static_assert(MO_IK_N >= MO_FUSED_IK_MIN_N && MO_IK_N <= MO_FUSED_IK_MAX_N, "no instance at this chain length");
static_assert(MO_IK_FAMILY == 0 || MO_IK_FAMILY == 1, "family: 0 planar, 1 spatial");

namespace {

using Real = std::conditional_t<MO_IK_DOUBLE != 0, double, float>;
using Family = std::conditional_t<MO_IK_FAMILY == 0, mo::Planar<MO_IK_N>, mo::Spatial<MO_IK_N>>;

}  // namespace

// data (B, rows) and x0 (B, n) at the element strides in `strides` (data 2,
// x0 2); x_out (B, n), state (B, 3) and hist (B, max_iterations, 7 + n)
// contiguous, hist may be NULL; all of this instance's type.
extern "C" int mo_fused_ik_launch(const void* data, const void* x0, const long long* strides, void* x_out,
                                  void* state, void* hist, int B, int max_iterations, int qp_iterations,
                                  int ls_iterations, int polynomial, int mpc, double link, void* stream) {
  LaunchArgs a;
  if (const int rc = launch_args(data, x0, strides, x_out, state, hist, B, max_iterations, qp_iterations,
                                 ls_iterations, polynomial, mpc, stream, &a)) {
    return rc;
  }
  return launch<Real>(Family{{}, link}, a);
}

// Text of the launcher's return code (fused_sqp.cuh's, or CUDA's).
extern "C" const char* mo_fused_ik_error_string(int rc) { return error_text(rc); }

#ifdef MO_FUSED_SPANS
// The phase spans of instance 0 (fused_sqp.cuh IkSpan order), summed since
// the last reset; reset clears them. Returns a CUDA error code.
extern "C" int mo_fused_ik_spans(unsigned long long* out, int reset) {
  unsigned long long zeros[mo::kIkSpans] = {};
  if (reset) return static_cast<int>(cudaMemcpyToSymbol(mo::mo_ik_spans, zeros, sizeof(zeros)));
  return static_cast<int>(cudaMemcpyFromSymbol(out, mo::mo_ik_spans, sizeof(zeros)));
}
#endif
