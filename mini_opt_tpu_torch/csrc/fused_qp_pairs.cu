// Kernel 6 (fused_qp.cuh) on the general path's box rows, PairRows: a lo
// and a hi row on each of variables 1..N-1, the count and variables at
// compile time, K in {0, 1}. mo_fused_qp_launch (fused_qp.cu) launches it where the
// rows it is given are these (is_pair_rows).
#include "fused_qp.cuh"

namespace {

using mo::qp::PairRows;
using mo::qp::Same;
using mo::qp::Schedule;
using mo::qp::Tensors;

template <typename T>
int dispatch_k(int N, int K, const Tensors& t, int B, const Schedule& sch, cudaStream_t s) {
  switch (K) {
    case 0: return mo::qp::dispatch_register<T, 0, PairRows>(N, t, B, Same{}, sch, s);
    case 1: return mo::qp::dispatch_register<T, 1, PairRows>(N, t, B, Same{}, sch, s);
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
