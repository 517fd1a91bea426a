// Liveness kernel: y = x + WATCH_SALT over int32 elements.
//
// Replaces: tools/tpu_watch.sh:19-24, the salted identity kernel whose
// only job is to show that the compiler and the launch path are alive
// before the real phases start (a device can still answer discovery
// while kernel compiles hang). The salt is a compile-time constant, so
// every probe compiles a kernel the machine has never seen and no cache
// can answer for it: build with -DWATCH_SALT=<n>.
//
// What bounds it: nothing worth measuring. 1024 words in and out are
// 8 KiB, microseconds below the launch latency; the point is the fresh
// compile, which takes seconds. One thread per element.
#include <cuda_runtime.h>
#include <stdint.h>

#ifndef WATCH_SALT
#error "build with -DWATCH_SALT=<n>"
#endif

namespace {

__global__ void watch_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ y,
                             int64_t n) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] = x[i] + (int32_t)(WATCH_SALT);
}

}  // namespace

// x, y: int32[n].
extern "C" int watch_launch(const void* x, void* y, int64_t n, void* stream) {
  if (n == 0) return 0;
  watch_kernel<<<(unsigned)((n + 127) / 128), 128, 0, (cudaStream_t)stream>>>(
      (const int32_t*)x, (int32_t*)y, n);
  return (int)cudaGetLastError();
}
