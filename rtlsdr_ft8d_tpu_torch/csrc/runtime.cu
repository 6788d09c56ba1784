// Error reporting for the ctypes wrappers: every kernel entry returns its
// cudaGetLastError() code, and the wrapper asks for the message here.
#include "common.cuh"

FT8_EXPORT const char* ft8_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
