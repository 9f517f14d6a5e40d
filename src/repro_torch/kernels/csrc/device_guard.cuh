// Shared by the kernel sources: the C entry points take the device of
// their tensors and launch there without PyTorch's device context.
#pragma once
#include <cuda_runtime.h>

namespace {

// Makes `dev` the current device for the launch and restores the caller's.
struct DeviceGuard {
  int prev = -1;
  cudaError_t err = cudaSuccess;
  explicit DeviceGuard(int dev) {
    int cur = 0;
    err = cudaGetDevice(&cur);
    if (err == cudaSuccess && cur != dev) {
      err = cudaSetDevice(dev);
      if (err == cudaSuccess) prev = cur;
    }
  }
  ~DeviceGuard() {
    if (prev >= 0) cudaSetDevice(prev);
  }
};

}  // namespace
