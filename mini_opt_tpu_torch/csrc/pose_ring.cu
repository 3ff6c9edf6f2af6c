// Kernel 7's launcher (the device code is in pose_ring.cuh): the float
// instances, the topology schedule and the plain C entry points that
// ops/pose_ring.py binds with ctypes: mo_pose_ring_launch for up to
// kMaxClosures closures and kMaxBorders borders (the schedule by value, the
// Schur system a template on k), mo_pose_ring_table_launch past them (the
// schedule a device table, k a run-time value). The launcher runs on the caller's
// stream (PyTorch's current stream), allocates nothing (the caller passes the
// global scratch array on the route that needs one), does not synchronise,
// and returns cudaGetLastError() so that a refused launch is reported.
#include "pose_ring.cuh"

int mo::ring::launch_float(const Topology& tp, const LaunchArgs& a, bool occupancy_only) {
  return dispatch_k<float>(tp, a, occupancy_only);
}

int mo::ring::launch_float_table(const TopoTable& tp, const LaunchArgs& a, bool occupancy_only) {
  return launch<float, 0>(tp, a, occupancy_only);
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

// The run-time route, for any number of closures and border poses: the
// schedule's arrays in the device table `table` (int32: cl_from and cl_to
// (n_cl each), border (k), seg_lo and seg_hi (n_seg each), as
// ops/pose_ring.py::ring_schedule makes them), the Schur system of the k
// borders in the slab. Otherwise as mo_pose_ring_launch.
extern "C" int mo_pose_ring_table_launch(int dtype, int n, int n_cl, int k, int n_seg, const int* table,
                                         double anchor_weight, const void* data, const void* x0, void* x_out,
                                         void* state, void* scratch, int B, int warps, int max_iterations,
                                         int ls_iterations, void* stream) {
  if (B <= 0 || max_iterations < 0 || ls_iterations < 0 || n < 2 || n_cl < 1 || k < 2 || n_seg < 0 ||
      table == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const mo::ring::TopoTable tp{n, n_cl, table, table + n_cl, k, table + 2 * n_cl, n_seg,
                               table + 2 * n_cl + k, table + 2 * n_cl + k + n_seg, anchor_weight * anchor_weight,
                               0.5 * anchor_weight * anchor_weight};
  const mo::ring::LaunchArgs a{data, x0, x_out, state, scratch, B, warps, max_iterations, ls_iterations,
                               static_cast<cudaStream_t>(stream)};
  switch (dtype) {
    case 0: return mo::ring::launch_float_table(tp, a, false);
    case 1: return mo::ring::launch_double_table(tp, a, false);
    default: return mo::kNoInstance;
  }
}

// Slots of one instance's slab on the run-time route (Layout(n, n_cl,
// k).total); -1 for no such graph.
extern "C" int mo_pose_ring_table_slots(int n, int n_cl, int k) {
  if (n < 2 || n_cl < 1 || k < 2) return -1;
  return mo::ring::Layout(n, n_cl, k).total;
}

// CTAs per SM of the run-time route's kernel at `warps` instances per CTA
// on the shared (global_scratch 0) or global (1) slab route.
extern "C" int mo_pose_ring_table_occupancy(int dtype, int n, int n_cl, int k, int warps, int global_scratch) {
  if (n < 2 || n_cl < 1 || k < 2) return -static_cast<int>(cudaErrorInvalidValue);
  static char placeholder;
  const mo::ring::TopoTable tp{n, n_cl, nullptr, nullptr, k, nullptr, 0, nullptr, nullptr, 1.0, 0.5};
  const mo::ring::LaunchArgs a{nullptr, nullptr, nullptr, nullptr, global_scratch ? &placeholder : nullptr,
                               1, warps, 0, 0, nullptr};
  switch (dtype) {
    case 0: return mo::ring::launch_float_table(tp, a, true);
    case 1: return mo::ring::launch_double_table(tp, a, true);
    default: return mo::kNoInstance;
  }
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
