// Selects the card a launch runs on and gives the caller's card back.
//
// Every C entry of the kernel library takes the device index of its
// tensors. The guard makes that card current for the launch and restores
// the calling thread's card when the entry returns, so the Python
// wrappers enter no `torch.cuda.device` context and PyTorch's current
// device never changes under it. cudaGetDevice reads a thread-local
// value; cudaSetDevice is called only when the cards differ.

#pragma once

#include <cuda_runtime.h>

class DeviceGuard {
 public:
  explicit DeviceGuard(int device) {
    err_ = cudaGetDevice(&prev_);
    if (err_ == cudaSuccess && prev_ != device) {
      err_ = cudaSetDevice(device);
      restore_ = err_ == cudaSuccess;
    }
  }
  ~DeviceGuard() {
    if (restore_) cudaSetDevice(prev_);
  }
  DeviceGuard(const DeviceGuard&) = delete;
  DeviceGuard& operator=(const DeviceGuard&) = delete;

  cudaError_t error() const { return err_; }

 private:
  int prev_ = 0;
  bool restore_ = false;
  cudaError_t err_ = cudaSuccess;
};
