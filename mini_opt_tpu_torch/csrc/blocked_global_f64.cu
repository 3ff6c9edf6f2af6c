// Kernel 2's planar-chain double instances on the global route (blocked_sqp.cuh):
// each warp's slab a row of the caller's global scratch, in a file of their
// own so that nvcc builds them beside the shared route's.
#include "blocked_sqp.cuh"

int mo::blocked::launch_global_planar_double(int n, double link, const LaunchArgs& a, bool occupancy_only) {
  return launch_family<double, true>(PlanarChain{n, link}, a, occupancy_only);
}
