// Kernel 7's launcher (the device code is in pose_ring.cuh): the float
// instances, the topology schedule and the plain C entry points that
// ops/pose_ring.py binds with ctypes. The launcher runs on the caller's
// stream (PyTorch's current stream), allocates nothing (the caller passes the
// scratch array), does not synchronise, and returns cudaGetLastError() so
// that a refused launch is reported.
#include "pose_ring.cuh"

int mo::ring::launch_float(const Topology& tp, const LaunchArgs& a) { return dispatch_k<float>(tp, a); }

namespace {

using mo::ring::Topology;
using mo::ring::kMaxBorders;
using mo::ring::kMaxClosures;

// The schedule of a topology; false if the kernel has no instance for it.
bool make_topology(int n, int n_cl, const int* closures, double anchor_weight, Topology& tp) {
  if (n < 2 || n_cl < 1 || n_cl > kMaxClosures) return false;
  tp.n = n;
  tp.n_cl = n_cl;
  for (int j = 0; j < n_cl; ++j) {
    tp.cl_from[j] = closures[2 * j];
    tp.cl_to[j] = closures[2 * j + 1];
    if (tp.cl_from[j] < 0 || tp.cl_from[j] >= n || tp.cl_to[j] < 0 || tp.cl_to[j] >= n ||
        tp.cl_from[j] == tp.cl_to[j])
      return false;
  }
  tp.wa2 = anchor_weight * anchor_weight;
  tp.half_wa2 = 0.5 * anchor_weight * anchor_weight;
  tp.n_seg = 0;
  if (n_cl == 1) {
    const int a = tp.cl_from[0] < tp.cl_to[0] ? tp.cl_from[0] : tp.cl_to[0];
    tp.k = 1;
    tp.border[0] = a;
    if (a >= 1) {
      tp.seg_lo[tp.n_seg] = 0;
      tp.seg_hi[tp.n_seg++] = a - 1;
    }
    tp.seg_lo[tp.n_seg] = a + 1;
    tp.seg_hi[tp.n_seg++] = n - 1;
    return true;
  }
  tp.k = 0;
  for (int p = 0; p < n; ++p) {
    bool is_border = false;
    for (int j = 0; j < n_cl; ++j) is_border = is_border || tp.cl_from[j] == p || tp.cl_to[j] == p;
    if (is_border) {
      if (tp.k == kMaxBorders) return false;
      tp.border[tp.k++] = p;
    } else if (p > 0 && tp.n_seg > 0 && tp.seg_hi[tp.n_seg - 1] == p - 1) {
      tp.seg_hi[tp.n_seg - 1] = p;
    } else {
      tp.seg_lo[tp.n_seg] = p;
      tp.seg_hi[tp.n_seg++] = p;
    }
  }
  return tp.k >= 2;
}

}  // namespace

// Scratch rows per lane for n poses and n_cl closures: the caller allocates
// (rows, B) of the data's dtype.
extern "C" int mo_pose_ring_scratch_slots(int n, int n_cl) { return mo::ring::Layout(n, n_cl).total; }

// dtype: 0 float, 1 double. closures: n_cl (from, to) pairs.
extern "C" int mo_pose_ring_launch(int dtype, int n, int n_cl, const int* closures, double anchor_weight,
                                   const void* data, const void* x0, void* x_out, void* state,
                                   void* scratch, int B, int max_iterations, int ls_iterations,
                                   void* stream) {
  if (B <= 0 || max_iterations < 0 || ls_iterations < 0) return static_cast<int>(cudaErrorInvalidValue);
  Topology tp;
  if (!make_topology(n, n_cl, closures, anchor_weight, tp)) return mo::kNoInstance;
  const mo::ring::LaunchArgs a{data, x0, x_out, state, scratch, B, max_iterations, ls_iterations,
                     static_cast<cudaStream_t>(stream)};
  switch (dtype) {
    case 0: return mo::ring::launch_float(tp, a);
    case 1: return mo::ring::launch_double(tp, a);
    default: return mo::kNoInstance;
  }
}
