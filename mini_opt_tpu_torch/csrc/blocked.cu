// Kernel 2's launchers (the device code is in blocked_sqp.cuh): the planar
// chain's float instances on the shared route and the plain C entry points
// that ops/blocked.py binds with ctypes.
//
// One warp per instance. On the shared route `warps` instances share a CTA
// (ops/blocked.py::launch_plan), each instance's slab in the CTA's dynamic
// shared memory; the instance with R = 2, 4 or 6 KKT rows a lane takes
// D = n + 1 up to 64, 128 or 192. On the global route (past one CTA's
// shared memory or D = 192) each warp of the grid owns a slab of the
// caller's global scratch and solves instances in turn on it; R = 6 or 8
// rows a lane take D up to 192 or 256. A launcher runs on the
// caller's stream (PyTorch's current stream), allocates nothing, does not
// synchronise, and returns the CUDA error of the attribute call or of the
// launch (kTooLarge past one CTA's shared memory on the shared route, past
// D = 256, or for a scratch slab smaller than the instance's), so that a
// refused launch is reported.
#include <cuda_runtime.h>

#include "blocked_sqp.cuh"

int mo::blocked::launch_planar_float(int n, double link, const LaunchArgs& a, bool occupancy_only) {
  return launch_family<float, false>(PlanarChain{n, link}, a, occupancy_only);
}

namespace {

int launch(int family, int n, int dtype, double link, const mo::blocked::LaunchArgs& a, bool occupancy_only) {
  using namespace mo::blocked;
  if (a.B <= 0 || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (a.scratch != nullptr) {
    switch (family * 2 + dtype) {
      case 0: return launch_global_planar_float(n, link, a, occupancy_only);
      case 1: return launch_global_planar_double(n, link, a, occupancy_only);
      case 2: return launch_global_spatial_float(n, link, a, occupancy_only);
      case 3: return launch_global_spatial_double(n, link, a, occupancy_only);
      default: return mo::kNoInstance;
    }
  }
  switch (family * 2 + dtype) {
    case 0: return launch_planar_float(n, link, a, occupancy_only);
    case 1: return launch_planar_double(n, link, a, occupancy_only);
    case 2: return launch_spatial_float(n, link, a, occupancy_only);
    case 3: return launch_spatial_double(n, link, a, occupancy_only);
    default: return mo::kNoInstance;
  }
}

}  // namespace

// family: 0 planar, 1 spatial; dtype: 0 float, 1 double; warps: instances
// per CTA (1..4). data (B, rows) and x0 (B, n) at the element strides in
// `strides` (data's instance and row stride, then x0's); x_out (n, B) and
// state (3, B) contiguous. scratch: null (the shared route), or the global
// route's `slabs` slabs of `slab_bytes` each (slabs a multiple of warps).
extern "C" int mo_blocked_launch(int family, int n, int dtype, const void* data, const void* x0,
                                 const long long* strides, void* x_out, void* state, int B, int warps,
                                 int max_iterations, int qp_iterations, int ls_iterations, int polynomial,
                                 int mpc, void* scratch, int slabs, long long slab_bytes, double link,
                                 void* stream) {
  mo::blocked::LaunchArgs a;
  if (const int rc = mo::blocked::launch_args(data, x0, strides, x_out, state, B, warps, max_iterations,
                                              qp_iterations, ls_iterations, polynomial, mpc, scratch, slabs,
                                              slab_bytes, stream, &a)) {
    return rc;
  }
  if (family < 0 || family > 1 || dtype < 0 || dtype > 1) return mo::kNoInstance;
  return launch(family, n, dtype, link, a, false);
}

// CTAs of `warps` instances of kernel 2 that fit one SM at once on the
// shared (global 0) or global (1) route
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor); negative on an error or
// where the system does not fit one CTA.
extern "C" int mo_blocked_occupancy(int family, int n, int dtype, int warps, int global) {
  if (n < 1 || warps < 1 || warps > mo::blocked::kMaxWarps || family < 0 || family > 1 || dtype < 0 ||
      dtype > 1) {
    return -static_cast<int>(cudaErrorInvalidValue);
  }
  return launch(family, n, dtype, 0.0, mo::blocked::occupancy_args(warps, global != 0), true);
}
