// Error reporting for the ctypes wrappers: every kernel entry returns
// cudaGetLastError() as an int, and the wrapper turns a nonzero code into
// an exception carrying this string.
#include <cuda_runtime.h>

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
