// Kernel 6 (fused_qp.cuh), the fused QP interior point, behind plain C
// launchers that ops/fused_qp.py binds with ctypes. mo_fused_qp_launch runs
// the register route (one instance per thread): the AnyRows instances with
// K in {0, 1} (any M <= 2N box rows, run-time values) here, the PairRows
// instances (the general path's rows, compile time) in fused_qp_pairs.cu
// and every K = 2 instance in fused_qp_k2.cu, so that nvcc builds them in
// parallel. Past the register caps, mo_fused_qp_warp_launch
// (fused_qp_warp.cu) runs one warp per instance. Every route reads the
// caller's tensors batch-major, at any strides, and writes x (B, N), y (B, K).
#include "fused_qp.cuh"

namespace {

using mo::qp::AnyRows;
using mo::qp::FillAny;
using mo::qp::Schedule;
using mo::qp::Tensors;

template <typename T>
int dispatch_k(int N, int K, const Tensors& t, int B, int M, const int* var, const Schedule& sch,
               cudaStream_t s) {
  const FillAny any{M, var};
  switch (K) {
    case 0: return mo::qp::dispatch_register<T, 0, AnyRows>(N, t, B, any, sch, s);
    case 1: return mo::qp::dispatch_register<T, 1, AnyRows>(N, t, B, any, sch, s);
    default: return mo::kNoInstance;
  }
}

}  // namespace

// The register route. dtype: 0 float, 1 double. var holds the M box rows'
// variables: where they are the general path's pairs (M = 2(N - 1),
// var[m] = 1 + m / 2) the PairRows instance runs, else the AnyRows one.
// G (B, N, N) (lower triangle read), c (B, N), A (B, K, N), b (B, K),
// ia / ib (B, M) at the 14 element strides in `strides` (G 3, c 2, A 3,
// b 2, ia 2, ib 2); x (B, N) and y (B, K) contiguous. kNoInstance where the
// register caps (fused_qp.cuh register_instance) hold no instance.
extern "C" int mo_fused_qp_launch(int dtype, int N, int K, int M, const int* var, const void* G,
                                  const void* c, const void* A, const void* b, const void* ia,
                                  const void* ib, const long long* strides, void* x, void* y,
                                  int B, int iterations, double sigma, int mpc, int has_eq_guess,
                                  void* stream) {
  if (B <= 0 || iterations < 0 || M < 0 || M > 2 * N || M > mo::qp::kMaxRows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int m = 0; m < M; ++m) {
    if (var[m] < 0 || var[m] >= N) return static_cast<int>(cudaErrorInvalidValue);
  }
  if (!mo::qp::register_instance(N, K)) return mo::kNoInstance;
  Tensors t{G, c, A, b, ia, ib, x, y, {}, {}, {}, {}, {}, {}};
  long long* dst[] = {t.sG, t.sc, t.sA, t.sb, t.sia, t.sib};
  const int dims[] = {3, 2, 3, 2, 2, 2};
  for (int a = 0, q = 0; a < 6; ++a) {
    for (int d = 0; d < dims[a]; ++d) dst[a][d] = strides[q++];
  }
  const Schedule sch{iterations, sigma, mpc, has_eq_guess};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool pairs = mo::qp::is_pair_rows(N, M, var);
  if (K == 2) return mo::qp::launch_k2(dtype, N, pairs, M, var, t, B, sch, s);
  if (pairs) return mo::qp::launch_pairs(dtype, N, K, t, B, sch, s);
  switch (dtype) {
    case 0: return dispatch_k<float>(N, K, t, B, M, var, sch, s);
    case 1: return dispatch_k<double>(N, K, t, B, M, var, sch, s);
    default: return mo::kNoInstance;
  }
}
