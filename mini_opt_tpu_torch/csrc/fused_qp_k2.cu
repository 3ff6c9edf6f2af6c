// Kernel 6 (fused_qp.cuh) on the register route with K = 2 equality rows
// (a slack-lifted IK problem's effector row and keep-out row), both box-row
// types: PairRows where the rows are the general path's pairs, else
// AnyRows. mo_fused_qp_launch (fused_qp.cu) hands K = 2 here. The instances
// exist where ops/fused_qp.py's register caps allow them.
#include "fused_qp.cuh"

namespace {

using mo::qp::AnyRows;
using mo::qp::FillAny;
using mo::qp::PairRows;
using mo::qp::Same;
using mo::qp::Schedule;
using mo::qp::Tensors;

template <typename T>
int dispatch(int N, bool pairs, int M, const int* var, const Tensors& t, int B, const Schedule& sch,
             cudaStream_t s) {
  if (pairs) return mo::qp::dispatch_register<T, 2, PairRows>(N, t, B, Same{}, sch, s);
  return mo::qp::dispatch_register<T, 2, AnyRows>(N, t, B, FillAny{M, var}, sch, s);
}

}  // namespace

namespace mo {
namespace qp {

int launch_k2(int dtype, int N, bool pairs, int M, const int* var, const Tensors& t, int B,
              const Schedule& sch, cudaStream_t stream) {
  switch (dtype) {
    case 0: return dispatch<float>(N, pairs, M, var, t, B, sch, stream);
    case 1: return dispatch<double>(N, pairs, M, var, t, B, sch, stream);
    default: return kNoInstance;
  }
}

}  // namespace qp
}  // namespace mo
