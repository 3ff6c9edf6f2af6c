// The fused IK kernel's hand-written instances: the solver skeleton
// (fused_sqp.cuh) for the planar and spatial families (families.cuh),
// N = 2..8, in float and double, behind a plain C launcher that
// ops/fused_ik.py binds with ctypes. The kernel and its launch are in
// fused_ik_launch.cuh, which the families emitted from a Problem
// (ops/fused_emit.py) share.
#include "families.cuh"
#include "fused_ik_launch.cuh"

namespace {

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
    default: return mo::kNoInstance;
  }
}

template <typename T>
int dispatch_family(int family, int n, double link, const LaunchArgs& a) {
  switch (family) {
    case 0: return dispatch_n<T, mo::Planar>(n, link, a);
    case 1: return dispatch_n<T, mo::Spatial>(n, link, a);
    default: return mo::kNoInstance;
  }
}

}  // namespace

// family: 0 planar, 1 spatial; dtype: 0 float, 1 double. data (B, rows)
// and x0 (B, n) at the element strides in `strides` (data 2, x0 2); x_out
// (B, n), state (B, 3) and hist (B, max_iterations, 7 + n) contiguous, hist
// may be NULL.
extern "C" int mo_fused_ik_launch(int family, int n, int dtype, const void* data, const void* x0,
                                  const long long* strides, void* x_out, void* state, void* hist,
                                  int B, int max_iterations, int qp_iterations, int ls_iterations,
                                  int polynomial, int mpc, double link, void* stream) {
  LaunchArgs a;
  if (const int rc = launch_args(data, x0, strides, x_out, state, hist, B, max_iterations, qp_iterations,
                                 ls_iterations, polynomial, mpc, stream, &a)) {
    return rc;
  }
  switch (dtype) {
    case 0: return dispatch_family<float>(family, n, link, a);
    case 1: return dispatch_family<double>(family, n, link, a);
    default: return mo::kNoInstance;
  }
}

// Text of any launcher's return code (fused_sqp.cuh's, or CUDA's).
extern "C" const char* mo_cuda_error_string(int rc) { return error_text(rc); }

#ifdef MO_FUSED_SPANS
// The phase spans of instance 0 (fused_sqp.cuh IkSpan order), summed since
// the last reset; reset clears them. Returns a CUDA error code.
extern "C" int mo_fused_ik_spans(unsigned long long* out, int reset) {
  unsigned long long zeros[mo::kIkSpans] = {};
  if (reset) return static_cast<int>(cudaMemcpyToSymbol(mo::mo_ik_spans, zeros, sizeof(zeros)));
  return static_cast<int>(cudaMemcpyFromSymbol(out, mo::mo_ik_spans, sizeof(zeros)));
}
#endif
