// Kernel 6 (fused_qp.cuh), the fused QP interior point, behind a plain C
// launcher that ops/fused_qp.py binds with ctypes: the AnyRows instances
// (any M <= 2N box rows, run-time values) here, the PairRows instances (the
// general path's rows, compile time) in fused_qp_pairs.cu, so that nvcc
// builds the two halves in parallel. Both routes read the caller's tensors
// batch-major, at any strides, and write x (B, N), y (B, K).
#include "fused_qp.cuh"

namespace {

using mo::qp::AnyRows;
using mo::qp::Schedule;
using mo::qp::Tensors;

template <typename T, int K>
int dispatch_n(int N, const Tensors& t, int B, int M, const int* var, const Schedule& sch,
               cudaStream_t s) {
  auto any = [&](auto rows) {
    rows.M = M;
    for (int m = 0; m < M; ++m) rows.var[m] = var[m];
    return rows;
  };
  switch (N) {
    case 2: return mo::qp::launch<T, 2, K>(t, B, any(AnyRows<2>{}), sch, s);
    case 3: return mo::qp::launch<T, 3, K>(t, B, any(AnyRows<3>{}), sch, s);
    case 4: return mo::qp::launch<T, 4, K>(t, B, any(AnyRows<4>{}), sch, s);
    case 5: return mo::qp::launch<T, 5, K>(t, B, any(AnyRows<5>{}), sch, s);
    case 6: return mo::qp::launch<T, 6, K>(t, B, any(AnyRows<6>{}), sch, s);
    case 7: return mo::qp::launch<T, 7, K>(t, B, any(AnyRows<7>{}), sch, s);
    case 8: return mo::qp::launch<T, 8, K>(t, B, any(AnyRows<8>{}), sch, s);
    default: return mo::kNoInstance;
  }
}

template <typename T>
int dispatch_k(int N, int K, const Tensors& t, int B, int M, const int* var, const Schedule& sch,
               cudaStream_t s) {
  switch (K) {
    case 0: return dispatch_n<T, 0>(N, t, B, M, var, sch, s);
    case 1: return dispatch_n<T, 1>(N, t, B, M, var, sch, s);
    default: return mo::kNoInstance;
  }
}

}  // namespace

// dtype: 0 float, 1 double. var holds the M box rows' variables: where they
// are the general path's pairs (M = 2(N - 1), var[m] = 1 + m / 2) the
// PairRows instance runs, else the AnyRows one. G (B, N, N) (lower triangle
// read), c (B, N), A (B, K, N), b (B, K), ia / ib (B, M) at the 14 element
// strides in `strides` (G 3, c 2, A 3, b 2, ia 2, ib 2); x (B, N) and y
// (B, K) contiguous.
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
  Tensors t{G, c, A, b, ia, ib, x, y, {}, {}, {}, {}, {}, {}};
  long long* dst[] = {t.sG, t.sc, t.sA, t.sb, t.sia, t.sib};
  const int dims[] = {3, 2, 3, 2, 2, 2};
  for (int a = 0, q = 0; a < 6; ++a) {
    for (int d = 0; d < dims[a]; ++d) dst[a][d] = strides[q++];
  }
  const Schedule sch{iterations, sigma, mpc, has_eq_guess};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mo::qp::is_pair_rows(N, M, var)) return mo::qp::launch_pairs(dtype, N, K, t, B, sch, s);
  switch (dtype) {
    case 0: return dispatch_k<float>(N, K, t, B, M, var, sch, s);
    case 1: return dispatch_k<double>(N, K, t, B, M, var, sch, s);
    default: return mo::kNoInstance;
  }
}
