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
// compile, which takes seconds. What a caller waits for is the launch
// path, so the kernel is one block of 256 threads at this size, each
// thread a 16-byte load and store where n is a multiple of 4 and both
// pointers are 16-byte aligned, one word otherwise; a grid-stride loop
// covers any larger n.
#include <cuda_runtime.h>
#include <stdint.h>

#ifndef WATCH_SALT
#error "build with -DWATCH_SALT=<n>"
#endif

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 1024;

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    watch_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ y, int64_t n) {
  const int32_t salt = (int32_t)(WATCH_SALT);
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (kVec) {
    const int4* x4 = reinterpret_cast<const int4*>(x);
    int4* y4 = reinterpret_cast<int4*>(y);
    for (; i < (n >> 2); i += stride) {
      int4 v = __ldg(x4 + i);
      v.x += salt;
      v.y += salt;
      v.z += salt;
      v.w += salt;
      y4[i] = v;
    }
  } else {
    for (; i < n; i += stride) y[i] = __ldg(x + i) + salt;
  }
}

}  // namespace

// x, y: int32[n].
extern "C" int watch_launch(const void* x, void* y, int64_t n, void* stream) {
  if (n == 0) return 0;
  const bool vec = n % 4 == 0 && (uintptr_t)x % 16 == 0 && (uintptr_t)y % 16 == 0;
  const int64_t units = vec ? n >> 2 : n;
  int64_t blocks = (units + kThreads - 1) / kThreads;
  blocks = blocks < kMaxBlocks ? blocks : kMaxBlocks;
  if (vec) {
    watch_kernel<true><<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)x, (int32_t*)y, n);
  } else {
    watch_kernel<false><<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)x, (int32_t*)y, n);
  }
  return (int)cudaGetLastError();
}
