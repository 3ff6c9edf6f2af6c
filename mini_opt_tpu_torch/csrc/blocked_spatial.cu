// Kernel 2's spatial-chain float instances on the shared route
// (blocked_sqp.cuh, families.cuh SpatialChain), in a file of their own so
// that nvcc builds them beside the planar ones.
#include "blocked_sqp.cuh"

int mo::blocked::launch_spatial_float(int n, double link, const LaunchArgs& a, bool occupancy_only) {
  return launch_family<float, false>(SpatialChain{n, link}, a, occupancy_only);
}
