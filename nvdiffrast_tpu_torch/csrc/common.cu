// Shared C entry of the kernel library: CUDA error code -> message.
#include <cuda_runtime.h>

extern "C" const char* nvdr_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
