// Helpers shared by the kernels' plain C entry points.
#pragma once
#include <cuda_runtime.h>

namespace mxtpu {

// Makes `device` current for the scope of a launch when it is not already
// (the common case costs one cudaGetDevice), and restores the caller's
// device after. PyTorch and the kernels share the device's primary context.
class DeviceScope {
 public:
  explicit DeviceScope(int device) {
    err_ = cudaGetDevice(&prev_);
    if (err_ == cudaSuccess && prev_ != device) {
      err_ = cudaSetDevice(device);
      switched_ = err_ == cudaSuccess;
    }
  }
  ~DeviceScope() {
    if (switched_) cudaSetDevice(prev_);
  }
  cudaError_t error() const { return err_; }

 private:
  int prev_ = 0;
  bool switched_ = false;
  cudaError_t err_;
};

}  // namespace mxtpu
