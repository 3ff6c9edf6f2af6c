// Kernel 7's launcher (the device code is in pose_ring.cuh): the float
// instances, the topology schedule and the plain C entry points that
// ops/pose_ring.py binds with ctypes. The launcher runs on the caller's
// stream (PyTorch's current stream), allocates nothing (the caller passes the
// global scratch array on the route that needs one), does not synchronise,
// and returns cudaGetLastError() so that a refused launch is reported.
#include "pose_ring.cuh"

int mo::ring::launch_float(const Topology& tp, const LaunchArgs& a, bool occupancy_only) {
  return dispatch_k<float>(tp, a, occupancy_only);
}

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

int launch(int dtype, const Topology& tp, const mo::ring::LaunchArgs& a, bool occupancy_only) {
  switch (dtype) {
    case 0: return mo::ring::launch_float(tp, a, occupancy_only);
    case 1: return mo::ring::launch_double(tp, a, occupancy_only);
    default: return mo::kNoInstance;
  }
}

}  // namespace

// Slots of one instance's slab for n poses and n_cl closures (Layout::
// total): a warp's share of the CTA's shared memory, or a row of the
// (B, slots) global scratch array; -1 for no such graph.
extern "C" int mo_pose_ring_scratch_slots(int n, int n_cl) {
  if (n < 2 || n_cl < 1) return -1;
  return mo::ring::Layout(n, n_cl).total;
}

// dtype: 0 float, 1 double. closures: n_cl (from, to) pairs. warps:
// instances per CTA (1..4). scratch: null for slabs in shared memory
// (refused with kTooLarge past 232,448 bytes a CTA), else the
// instance-major (B, slots) array of the data's dtype.
extern "C" int mo_pose_ring_launch(int dtype, int n, int n_cl, const int* closures, double anchor_weight,
                                   const void* data, const void* x0, void* x_out, void* state,
                                   void* scratch, int B, int warps, int max_iterations, int ls_iterations,
                                   void* stream) {
  if (B <= 0 || max_iterations < 0 || ls_iterations < 0) return static_cast<int>(cudaErrorInvalidValue);
  Topology tp;
  if (!make_topology(n, n_cl, closures, anchor_weight, tp)) return mo::kNoInstance;
  const mo::ring::LaunchArgs a{data, x0, x_out, state, scratch, B, warps, max_iterations, ls_iterations,
                               static_cast<cudaStream_t>(stream)};
  return launch(dtype, tp, a, false);
}

// CTAs per SM of kernel 7 for this topology at `warps` instances per CTA
// on the route the scratch flag names (0: shared slabs, 1: global):
// cudaOccupancyMaxActiveBlocksPerMultiprocessor; negative on an error.
extern "C" int mo_pose_ring_occupancy(int dtype, int n, int n_cl, const int* closures, int warps,
                                      int global_scratch) {
  Topology tp;
  if (!make_topology(n, n_cl, closures, 1.0, tp)) return mo::kNoInstance;
  static char placeholder;
  const mo::ring::LaunchArgs a{nullptr, nullptr, nullptr, nullptr, global_scratch ? &placeholder : nullptr,
                               1, warps, 0, 0, nullptr};
  return launch(dtype, tp, a, true);
}

#ifdef MO_RING_SPANS
// The phase spans of instance 0 (pose_ring.cuh Span order), summed since the
// last reset; reset clears them. Returns a CUDA error code.
extern "C" int mo_pose_ring_spans(unsigned long long* out, int reset) {
  unsigned long long zeros[mo::ring::kSpans] = {};
  if (reset) return static_cast<int>(cudaMemcpyToSymbol(mo::ring::mo_ring_spans, zeros, sizeof(zeros)));
  return static_cast<int>(cudaMemcpyFromSymbol(out, mo::ring::mo_ring_spans, sizeof(zeros)));
}
#endif
