// Kernel 6 (fused_qp.cuh) on the general path's box rows, PairRows: a lo
// and a hi row on each of variables 1..N-1, the count and variables at
// compile time. mo_fused_qp_launch (fused_qp.cu) launches it where the
// rows it is given are these (is_pair_rows).
#include "fused_qp.cuh"

namespace {

using mo::qp::PairRows;
using mo::qp::Schedule;
using mo::qp::Tensors;

template <typename T, int K>
int dispatch_n(int N, const Tensors& t, int B, const Schedule& sch, cudaStream_t s) {
  switch (N) {
    case 2: return mo::qp::launch<T, 2, K>(t, B, PairRows<2>{}, sch, s);
    case 3: return mo::qp::launch<T, 3, K>(t, B, PairRows<3>{}, sch, s);
    case 4: return mo::qp::launch<T, 4, K>(t, B, PairRows<4>{}, sch, s);
    case 5: return mo::qp::launch<T, 5, K>(t, B, PairRows<5>{}, sch, s);
    case 6: return mo::qp::launch<T, 6, K>(t, B, PairRows<6>{}, sch, s);
    case 7: return mo::qp::launch<T, 7, K>(t, B, PairRows<7>{}, sch, s);
    case 8: return mo::qp::launch<T, 8, K>(t, B, PairRows<8>{}, sch, s);
    default: return mo::kNoInstance;
  }
}

template <typename T>
int dispatch_k(int N, int K, const Tensors& t, int B, const Schedule& sch, cudaStream_t s) {
  switch (K) {
    case 0: return dispatch_n<T, 0>(N, t, B, sch, s);
    case 1: return dispatch_n<T, 1>(N, t, B, sch, s);
    default: return mo::kNoInstance;
  }
}

}  // namespace

namespace mo {
namespace qp {

int launch_pairs(int dtype, int N, int K, const Tensors& t, int B, const Schedule& sch,
                 cudaStream_t stream) {
  switch (dtype) {
    case 0: return dispatch_k<float>(N, K, t, B, sch, stream);
    case 1: return dispatch_k<double>(N, K, t, B, sch, stream);
    default: return kNoInstance;
  }
}

}  // namespace qp
}  // namespace mo

#ifdef MO_FUSED_SPANS
// The phase spans of instance 0 on the PairRows route (fused_qp.cuh QpSpan
// order), summed since the last reset; reset clears them. Returns a CUDA
// error code.
extern "C" int mo_fused_qp_spans(unsigned long long* out, int reset) {
  unsigned long long zeros[mo::qp::kQpSpans] = {};
  if (reset) return static_cast<int>(cudaMemcpyToSymbol(mo::qp::mo_qp_spans, zeros, sizeof(zeros)));
  return static_cast<int>(cudaMemcpyFromSymbol(out, mo::qp::mo_qp_spans, sizeof(zeros)));
}
#endif
