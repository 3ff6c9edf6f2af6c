// Kernels 8 and 9's launchers (the device code is in mpc.cuh): the float
// instances and the plain C entry points that ops/mpc.py binds with ctypes.
// A launcher runs on the caller's stream (PyTorch's current stream),
// allocates nothing (the caller passes the scratch array), does not
// synchronise, and returns cudaGetLastError() so that a refused launch is
// reported.
#include "mpc.cuh"

int mo::mpc::launch_float(int plant, const double* consts, const Cost& cs, const LaunchArgs& a) {
  return dispatch_plant<float>(plant, consts, cs, a);
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

int launch(int dtype, int plant, const double* consts, const Cost& cs, const mo::mpc::LaunchArgs& a) {
  if (a.B <= 0 || a.max_iterations < 1 || a.qp_iterations < 0 || a.ls_iterations < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case 0: return mo::mpc::launch_float(plant, consts, cs, a);
    case 1: return mo::mpc::launch_double(plant, consts, cs, a);
    default: return mo::kNoInstance;
  }
}

}  // namespace

// Scratch rows per lane for the plant at horizon T: the caller allocates
// (rows, B) of the data's dtype. -1 for an unknown plant.
extern "C" int mo_mpc_scratch_slots(int plant, int horizon) {
  int nx, nu;
  if (horizon < 1 || !plant_dims(plant, nx, nu)) return -1;
  return mo::mpc::Layout(horizon, nx, nu).total;
}

// Kernel 8. dtype: 0 float, 1 double. plant: 0 cart-pole (consts
// mass_cart, mass_pole, length, gravity), 1 quadrotor (mass, inertia, arm,
// gravity). hist may be null.
extern "C" int mo_mpc_launch(int dtype, int plant, const double* consts, const double* cost, int horizon,
                             const void* x0, const void* z0, void* z_out, void* stat, void* hist,
                             void* scratch, int B, int max_iterations, int qp_iterations, int ls_iterations,
                             void* stream) {
  Cost cs;
  if (!make_cost(plant, horizon, cost, cs)) return mo::kNoInstance;
  const mo::mpc::LaunchArgs a{x0, z0, nullptr, z_out, stat, hist, scratch, B, -1,
                              max_iterations, qp_iterations, ls_iterations, static_cast<cudaStream_t>(stream)};
  return launch(dtype, plant, consts, cs, a);
}

// Kernel 9: `periods` receding-horizon periods per lane.
extern "C" int mo_mpc_servo_launch(int dtype, int plant, const double* consts, const double* cost, int horizon,
                                   const void* x0, const void* z0, void* x_out, void* z_out, void* stats,
                                   void* scratch, int B, int periods, int max_iterations, int qp_iterations,
                                   int ls_iterations, void* stream) {
  Cost cs;
  if (periods < 0 || !make_cost(plant, horizon, cost, cs)) return mo::kNoInstance;
  const mo::mpc::LaunchArgs a{x0, z0, x_out, z_out, stats, nullptr, scratch, B, periods,
                              max_iterations, qp_iterations, ls_iterations, static_cast<cudaStream_t>(stream)};
  return launch(dtype, plant, consts, cs, a);
}
