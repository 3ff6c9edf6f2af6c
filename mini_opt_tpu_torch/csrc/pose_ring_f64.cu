// Kernel 7's double instances (the device code is in pose_ring.cuh), in a
// source file of their own so that nvcc builds them beside the float ones.
#include "pose_ring.cuh"

int mo::ring::launch_double(const Topology& tp, const LaunchArgs& a) { return dispatch_k<double>(tp, a); }
