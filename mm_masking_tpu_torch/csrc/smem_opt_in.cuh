// The dynamic shared-memory opt-in of a kernel, made once per kernel and
// device and cached: the first launch on a card sets the attribute, later
// ones make no attribute call. A step that is warmed up before it is
// captured into a CUDA graph therefore records only the launches.
#pragma once

#include <cuda_runtime.h>

#include <map>
#include <mutex>
#include <utility>

namespace mm {

// Opt `kernel` into `bytes` of dynamic shared memory on the current device
// (the host wrapper makes the inputs' device current). A CUDA error code, or
// 0.
inline int opt_in_smem(const void* kernel, int bytes) {
  if (bytes <= 48 * 1024) return 0;  // every kernel may use this much
  int device = 0;
  cudaError_t status = cudaGetDevice(&device);
  if (status != cudaSuccess) return static_cast<int>(status);
  static std::mutex mutex;
  static std::map<std::pair<const void*, int>, int> granted;  // (kernel, device) -> bytes
  std::lock_guard<std::mutex> lock(mutex);
  int& have = granted[{kernel, device}];
  if (have >= bytes) return 0;
  status = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (status == cudaSuccess) have = bytes;
  return static_cast<int>(status);
}

}  // namespace mm
