// Kernel 2's planar double instances on the shared route (blocked_sqp.cuh),
// in a file of their own so that nvcc builds them beside blocked.cu's float
// instances.
#include "blocked_sqp.cuh"

int mo::blocked::launch_planar_double(int n, double link, const LaunchArgs& a, bool occupancy_only) {
  return launch_family<double, false>(PlanarChain{n, link}, a, occupancy_only);
}
