// Kernel 2's double instances (blocked_sqp.cuh), in a file of their own so
// that nvcc builds them beside blocked.cu's float instances.
#include "blocked_sqp.cuh"

int mo::blocked::launch_double(int family, int n, double link, const LaunchArgs& a, bool occupancy_only) {
  return dispatch_family<double>(family, n, link, a, occupancy_only);
}
