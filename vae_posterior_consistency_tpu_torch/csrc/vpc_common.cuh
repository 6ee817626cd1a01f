// Shared by every kernel source of the port. Each source is built into its own
// shared library with a plain C interface (ops/_build.py) and includes this
// header once, so every library exports the same error-string lookup.
#pragma once

#include <cuda_runtime.h>

extern "C" const char* vpc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Makes `device` the current device for the life of the guard and gives the
// caller's current device back when the guard goes out of scope, on every
// return path of the entry point that holds it (after its return value,
// usually cudaGetLastError(), has been taken).
class DeviceGuard {
 public:
  explicit DeviceGuard(int device) {
    err_ = cudaGetDevice(&prev_);
    if (err_ == cudaSuccess && prev_ != device) {
      err_ = cudaSetDevice(device);
      switched_ = err_ == cudaSuccess;
    }
  }
  ~DeviceGuard() {
    if (switched_) cudaSetDevice(prev_);
  }
  DeviceGuard(const DeviceGuard&) = delete;
  DeviceGuard& operator=(const DeviceGuard&) = delete;
  cudaError_t error() const { return err_; }

 private:
  int prev_ = 0;
  bool switched_ = false;
  cudaError_t err_ = cudaSuccess;
};
