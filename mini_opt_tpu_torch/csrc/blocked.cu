// Kernel 2's launchers (the device code is in blocked_sqp.cuh): the float
// instances and the plain C entry points that ops/blocked.py binds with
// ctypes.
//
// One warp per instance, `warps` instances per CTA (ops/blocked.py::
// launch_plan), each instance's slab in the CTA's dynamic shared memory; the
// instance with R = 2, 4 or 6 KKT rows a lane takes D = n + 1 up to 64, 128
// or 192. A launcher runs on the caller's stream (PyTorch's current stream),
// allocates nothing, does not synchronise, and returns the CUDA error of the
// attribute call or of the launch (kTooLarge past one CTA's shared memory
// or D = 192), so that a refused launch is reported.
#include <cuda_runtime.h>

#include "blocked_sqp.cuh"

int mo::blocked::launch_float(int family, int n, double link, const LaunchArgs& a, bool occupancy_only) {
  return dispatch_family<float>(family, n, link, a, occupancy_only);
}

namespace {

int launch(int family, int n, int dtype, double link, const mo::blocked::LaunchArgs& a, bool occupancy_only) {
  if (a.B <= 0 || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case 0: return mo::blocked::launch_float(family, n, link, a, occupancy_only);
    case 1: return mo::blocked::launch_double(family, n, link, a, occupancy_only);
    default: return mo::kNoInstance;
  }
}

}  // namespace

// family: 0 planar; dtype: 0 float, 1 double; warps: instances per CTA
// (1..4). data (B, 2) and x0 (B, n) at the element strides in `strides`
// (data's instance and row stride, then x0's); x_out (n, B) and state (3, B)
// contiguous.
extern "C" int mo_blocked_launch(int family, int n, int dtype, const void* data, const void* x0,
                                 const long long* strides, void* x_out, void* state, int B, int warps,
                                 int max_iterations, int qp_iterations, int ls_iterations, int polynomial,
                                 int mpc, double link, void* stream) {
  mo::blocked::LaunchArgs a;
  if (const int rc = mo::blocked::launch_args(data, x0, strides, x_out, state, B, warps, max_iterations,
                                              qp_iterations, ls_iterations, polynomial, mpc, stream, &a)) {
    return rc;
  }
  return launch(family, n, dtype, link, a, false);
}

// CTAs of `warps` instances of kernel 2 that fit one SM at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor); negative on an error or
// where the system does not fit one CTA.
extern "C" int mo_blocked_occupancy(int family, int n, int dtype, int warps) {
  if (n < 1 || warps < 1 || warps > mo::blocked::kMaxWarps) {
    return -static_cast<int>(cudaErrorInvalidValue);
  }
  return launch(family, n, dtype, 0.0, mo::blocked::occupancy_args(warps), true);
}
