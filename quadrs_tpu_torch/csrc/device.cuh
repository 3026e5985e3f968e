// The launchers' device scope, shared by the port's kernels.  A launcher
// makes the tensors' device the calling thread's current device for the
// launch and gives the caller's back on the way out, so a launch on one
// card of a mesh leaves torch.cuda.current_device() as the caller had it:
// later allocations and streams that name no device stay where they were.
#pragma once

#include <cuda_runtime.h>

namespace qt {

class DeviceScope {
 public:
  explicit DeviceScope(int device) {
    int current = -1;
    status_ = cudaGetDevice(&current);
    if (status_ == cudaSuccess && current != device) {
      status_ = cudaSetDevice(device);
      if (status_ == cudaSuccess) previous_ = current;
    }
  }
  ~DeviceScope() {
    if (previous_ >= 0) cudaSetDevice(previous_);
  }
  DeviceScope(const DeviceScope&) = delete;
  DeviceScope& operator=(const DeviceScope&) = delete;
  // cudaSuccess, or the error of reading or setting the current device
  cudaError_t status() const { return status_; }

 private:
  cudaError_t status_ = cudaSuccess;
  int previous_ = -1;  // the caller's device, restored on exit; -1: unchanged
};

}  // namespace qt
