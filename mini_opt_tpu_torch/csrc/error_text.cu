// The main library's text of a launcher's return code: the codes of
// fused_sqp.cuh (kNoInstance, kTooLarge) or CUDA's own.
#include <cuda_runtime.h>

#include "fused_sqp.cuh"

extern "C" const char* mo_cuda_error_string(int rc) {
  if (rc == mo::kNoInstance) return "no kernel instance for these arguments";
  if (rc == mo::kTooLarge) return "the system does not fit one CTA (threads or shared memory)";
  return cudaGetErrorString(static_cast<cudaError_t>(rc));
}
