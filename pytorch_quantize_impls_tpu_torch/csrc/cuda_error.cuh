// The C entry point every kernel library exports beside its kernels: the
// message of a CUDA error code, which kernels/_build.py reads when an entry
// point returns a non-zero cudaGetLastError().
#pragma once

#include <cuda_runtime.h>

extern "C" const char* qt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
