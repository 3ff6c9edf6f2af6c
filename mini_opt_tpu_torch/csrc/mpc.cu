// Kernels 8 and 9's launchers (the device code is in mpc.cuh): the float
// instances and the plain C entry points that ops/mpc.py binds with ctypes.
// A launcher runs on the caller's stream (PyTorch's current stream),
// allocates nothing (the caller passes the global scratch array on the
// route that needs one), does not synchronise, and returns
// cudaGetLastError() so that a refused launch is reported.
#include "mpc.cuh"

int mo::mpc::launch_float(int plant, const double* consts, const Cost& cs, const LaunchArgs& a,
                          bool occupancy_only) {
  return dispatch_plant<float>(plant, consts, cs, a, occupancy_only);
}

namespace {

using mo::mpc::Cost;

// The plant's (nx, nu); false for an unknown plant.
bool plant_dims(int plant, int& nx, int& nu) {
  switch (plant) {
    case 0: nx = mo::mpc::CartPole::NX; nu = mo::mpc::CartPole::NU; return true;
    case 1: nx = mo::mpc::Quadrotor::NX; nu = mo::mpc::Quadrotor::NU; return true;
    default: return false;
  }
}

// The cost array ops/mpc.py::_cuda_args builds: hdt, dt, dt6, then w2,
// w2T, hw2, hw2T, goal (nx each), then r_u, hr_u, u_ref, u_min, u_max (nu
// each).
bool make_cost(int plant, int horizon, const double* a, Cost& cs) {
  int nx, nu;
  if (horizon < 1 || !plant_dims(plant, nx, nu)) return false;
  cs.horizon = horizon;
  cs.hdt = a[0];
  cs.dt = a[1];
  cs.dt6 = a[2];
  const double* p = a + 3;
  double* per_x[] = {cs.w2, cs.w2T, cs.hw2, cs.hw2T, cs.goal};
  for (double* dst : per_x) {
    for (int i = 0; i < mo::mpc::kMaxNX; ++i) dst[i] = i < nx ? p[i] : 0.0;
    p += nx;
  }
  double* per_u[] = {cs.r_u, cs.hr_u, cs.u_ref, cs.u_min, cs.u_max};
  for (double* dst : per_u) {
    for (int r = 0; r < mo::mpc::kMaxNU; ++r) dst[r] = r < nu ? p[r] : 0.0;
    p += nu;
  }
  return true;
}

int launch(int dtype, int plant, const double* consts, const Cost& cs, const mo::mpc::LaunchArgs& a,
           bool occupancy_only = false) {
  if (a.B <= 0 || a.max_iterations < 1 || a.qp_iterations < 0 || a.ls_iterations < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case 0: return mo::mpc::launch_float(plant, consts, cs, a, occupancy_only);
    case 1: return mo::mpc::launch_double(plant, consts, cs, a, occupancy_only);
    default: return mo::kNoInstance;
  }
}

}  // namespace

// Slots of one instance's slab for the plant at horizon T (Layout::total):
// a warp's share of the CTA's shared memory, or a row of the (B, slots)
// global scratch array. -1 for an unknown plant.
extern "C" int mo_mpc_scratch_slots(int plant, int horizon) {
  int nx, nu;
  if (horizon < 1 || !plant_dims(plant, nx, nu)) return -1;
  return mo::mpc::Layout(horizon, nx, nu).total;
}

// Kernel 8. dtype: 0 float, 1 double. plant: 0 cart-pole (consts
// mass_cart, mass_pole, length, gravity), 1 quadrotor (mass, inertia, arm,
// gravity). hist may be null. warps: instances per CTA (1..8). scratch: null
// for slabs in shared memory (refused with kTooLarge past 232,448 bytes a
// CTA), else the instance-major (B, slots) array of the data's dtype.
extern "C" int mo_mpc_launch(int dtype, int plant, const double* consts, const double* cost, int horizon,
                             const void* x0, const void* z0, void* z_out, void* stat, void* hist,
                             void* scratch, int B, int warps, int max_iterations, int qp_iterations,
                             int ls_iterations, void* stream) {
  Cost cs;
  if (!make_cost(plant, horizon, cost, cs)) return mo::kNoInstance;
  const mo::mpc::LaunchArgs a{x0, z0, nullptr, z_out, stat, hist, scratch, B, warps, -1,
                              max_iterations, qp_iterations, ls_iterations, static_cast<cudaStream_t>(stream)};
  return launch(dtype, plant, consts, cs, a);
}

// Kernel 9: `periods` receding-horizon periods per instance.
extern "C" int mo_mpc_servo_launch(int dtype, int plant, const double* consts, const double* cost, int horizon,
                                   const void* x0, const void* z0, void* x_out, void* z_out, void* stats,
                                   void* scratch, int B, int warps, int periods, int max_iterations,
                                   int qp_iterations, int ls_iterations, void* stream) {
  Cost cs;
  if (periods < 0 || !make_cost(plant, horizon, cost, cs)) return mo::kNoInstance;
  const mo::mpc::LaunchArgs a{x0, z0, x_out, z_out, stats, nullptr, scratch, B, warps, periods,
                              max_iterations, qp_iterations, ls_iterations, static_cast<cudaStream_t>(stream)};
  return launch(dtype, plant, consts, cs, a);
}

// CTAs per SM of kernel 8 (servo 0) or 9 (servo 1) at `warps` instances per
// CTA on the route the scratch flag names (0: shared slabs, 1: global):
// cudaOccupancyMaxActiveBlocksPerMultiprocessor; negative on an error.
extern "C" int mo_mpc_occupancy(int dtype, int plant, int horizon, int servo, int warps, int global_scratch) {
  Cost cs;
  const double zeros[4] = {0.0, 0.0, 0.0, 0.0};
  double cost[3 + 5 * mo::mpc::kMaxNX + 5 * mo::mpc::kMaxNU] = {};
  if (!make_cost(plant, horizon, cost, cs)) return mo::kNoInstance;
  if (warps < 1 || warps > mo::mpc::kMaxWarps) return -static_cast<int>(cudaErrorInvalidValue);
  static char placeholder;
  const mo::mpc::LaunchArgs a{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                              global_scratch ? &placeholder : nullptr, 1, warps, servo ? 0 : -1, 1, 0, 0,
                              nullptr};
  return launch(dtype, plant, zeros, cs, a, true);
}
