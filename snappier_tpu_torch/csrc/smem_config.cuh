// A kernel's shared-memory attributes, set per device and size, and the
// launch that needs them, under one lock.
//
// A function attribute holds only on the device that was current when it
// was set, so each launcher keeps, per device, the dynamic sizes it has set
// there and sets the attributes again only for another device or size. The
// largest dynamic size only grows, so a launch that found its size allowed
// is never refused because another host thread set a smaller one. The
// carveout follows the latest size, and a launch reads it when it is
// enqueued: so the attributes are set and the launch is enqueued under the
// same lock, and another host thread cannot set another size in between and
// leave the launch with fewer blocks an SM than its own size allows.
#pragma once

#include <cuda_runtime.h>

#include <mutex>

namespace attrs {

// The devices a process may address at once; a device at or past it has
// its attributes set on every launch.
constexpr int kMaxDevices = 64;

// Per device, the largest dynamic size allowed there and the size the
// carveout was set for, each plus 1 (0: none), and the lock that orders the
// setting and the launches. One per kernel: every launch and query of the
// kernel goes through the same one.
struct SetFor {
  std::mutex lock;
  long long max[kMaxDevices] = {};
  long long last[kMaxDevices] = {};
};

// Sets kernel's attributes on the current device for `dyn` dynamic shared
// bytes per block: the largest dynamic size, raised to dyn if it was below,
// and a carveout that holds as many blocks of dyn bytes as fit an SM
// (static and reserved shared memory included, at most 32 blocks) and
// leaves the rest to L1, which caches the kernels' reads of device memory.
// Nothing is set when set_for says they were set there for dyn. The caller
// holds set_for.lock.
template <class Kernel>
cudaError_t configure_locked(Kernel* kernel, size_t dyn, SetFor& set_for) {
  int dev = 0, per_sm = 0, reserved = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const long long want = (long long)dyn + 1;
  const bool known = dev < kMaxDevices;
  if (known && set_for.last[dev] == want) return cudaSuccess;
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, kernel);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  }
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&reserved, cudaDevAttrReservedSharedMemoryPerBlock, dev);
  }
  if (e != cudaSuccess) return e;
  if (!known || set_for.max[dev] < want) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
    if (e != cudaSuccess) return e;
    if (known) set_for.max[dev] = want;
  }
  size_t per_block = dyn + attr.sharedSizeBytes + (size_t)reserved;
  size_t fit = (size_t)per_sm / per_block;
  fit = fit < 32 ? (fit < 1 ? 1 : fit) : 32;  // an SM holds at most 32 blocks
  int carveout = (int)((fit * per_block * 100 + per_sm - 1) / per_sm);
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                           carveout > 100 ? 100 : carveout);
  if (e == cudaSuccess && known) set_for.last[dev] = want;
  return e;
}

// Sets kernel's attributes for `dyn` bytes (configure_locked) and calls
// run() under the same lock: a launch, which the caller checks with
// cudaGetLastError inside run(), or a query of the launch's occupancy.
// Returns the first error.
template <class Kernel, class Run>
cudaError_t configure_and_launch(Kernel* kernel, size_t dyn, SetFor& set_for, Run run) {
  std::lock_guard<std::mutex> hold(set_for.lock);
  cudaError_t e = configure_locked(kernel, dyn, set_for);
  return e != cudaSuccess ? e : run();
}

}  // namespace attrs
