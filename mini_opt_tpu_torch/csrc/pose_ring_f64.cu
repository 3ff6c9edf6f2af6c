// Kernel 7's double instances (the device code is in pose_ring.cuh), in a
// source file of their own so that nvcc builds them beside the float ones.
#include "pose_ring.cuh"

int mo::ring::launch_double(const Topology& tp, const LaunchArgs& a, bool occupancy_only) {
  return dispatch_k<double>(tp, a, occupancy_only);
}

int mo::ring::launch_double_table(const TopoTable& tp, const LaunchArgs& a, bool occupancy_only) {
  return launch<double, 0>(tp, a, occupancy_only);
}
