// Shared by the port's kernel sources (logmel.cu, groupconv.cu).
#pragma once

#include <cuda_runtime.h>

#include <cstddef>

namespace conan {

constexpr int kMaxDevices = 64;

// Lets `kernel` launch with `bytes` of dynamic shared memory on the current
// device. Above 48 KB that needs cudaFuncSetAttribute, whose setting belongs
// to the device's context, so `opted` keeps what was set per device ordinal
// (one array per kernel, owned by the caller). Two threads racing here only
// set the same attribute twice.
template <typename Kernel>
inline cudaError_t allow_dynamic_smem(Kernel kernel, size_t bytes, size_t (&opted)[kMaxDevices]) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const bool tracked = dev >= 0 && dev < kMaxDevices;
  if (tracked && opted[dev] >= bytes) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e == cudaSuccess && tracked) opted[dev] = bytes;
  return e;
}

}  // namespace conan
