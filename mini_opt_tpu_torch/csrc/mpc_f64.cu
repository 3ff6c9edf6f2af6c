// Kernels 8 and 9's double instances (the device code is in mpc.cuh), in a
// source file of their own so that nvcc builds them beside the float ones.
#include "mpc.cuh"

int mo::mpc::launch_double(int plant, const double* consts, const Cost& cs, const LaunchArgs& a,
                           bool occupancy_only) {
  return dispatch_plant<double>(plant, consts, cs, a, occupancy_only);
}
