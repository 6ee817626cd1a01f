// Shared by every kernel source of the port. Each source is built into its own
// shared library with a plain C interface (ops/_build.py) and includes this
// header once, so every library exports the same error-string lookup.
#pragma once

#include <cuda_runtime.h>

extern "C" const char* vpc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
