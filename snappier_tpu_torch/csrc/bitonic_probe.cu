// The in-kernel sort probe on Hopper.
//
// tools/perf_probe_hybrid.py::_bitonic_kernel (wrapper bitonic): one merge
// pass of a bitonic network, 16 compare-exchange stages (k = 15, j = 32768
// down to 1), over 65,536 int32 keys and their indices, with the TPU's rule
// (hp::bitonic_keep: equal keys keep their own key and index). The TPU holds
// all 512 KB of keys and indices in VMEM and runs each stage as whole-array
// row and lane permutations. The SIMT counterpart of an in-kernel sort: a
// block's shared memory holds 227 KB, not 512, so the stages whose pairs
// span more than a 4,096-element tile (j >= 4096) run one launch each over
// device memory (a thread a pair, in place: a pair is read and written by
// its thread alone), and the 12 stages below run in one launch in which
// each of 16 blocks holds its tile of keys and indices (32 KB) in shared
// memory, with a barrier between stages. One C call issues the five
// launches on the stream. Bound: 256 KB of keys in, 512 KB of keys and
// indices out, about 0.23 us at 3.35 TB/s; the device-memory stages read
// and write the arrays four times more, and each launch costs a few us.
#include <cuda_runtime.h>
#include <stdint.h>

#include "hybrid_probes.cuh"

namespace {

constexpr int32_t kTile = 4096;  // elements a block holds in the shared-memory stages
constexpr int32_t kPairs = hp::kSortN / 2;

// One stage at stride j over device memory. The first reads the keys from
// keys_in and takes each element's own index as its value.
__global__ void bitonic_global_kernel(const int32_t* keys_in, int32_t* keys, int32_t* vals,
                                      int32_t j, int32_t first) {
  const int32_t p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= kPairs) return;
  const int32_t lo = hp::bitonic_lo(p, j), hi = lo | j;
  int32_t k0 = keys_in[lo], k1 = keys_in[hi];
  int32_t v0 = first ? lo : vals[lo], v1 = first ? hi : vals[hi];
  hp::bitonic_exchange(lo, j, &k0, &k1, &v0, &v1);
  keys[lo] = k0;
  keys[hi] = k1;
  vals[lo] = v0;
  vals[hi] = v1;
}

// The stages j = j_top ... 1 on one tile of kTile elements in shared memory.
__global__ void bitonic_tile_kernel(int32_t* keys, int32_t* vals, int32_t j_top) {
  __shared__ int32_t ks[kTile], vs[kTile];
  const int32_t base = blockIdx.x * kTile;
  for (int32_t i = threadIdx.x; i < kTile; i += blockDim.x) {
    ks[i] = keys[base + i];
    vs[i] = vals[base + i];
  }
  __syncthreads();
  for (int32_t j = j_top; j >= 1; j >>= 1) {
    for (int32_t p = threadIdx.x; p < kTile / 2; p += blockDim.x) {
      const int32_t lo = hp::bitonic_lo(p, j);
      hp::bitonic_exchange(base + lo, j, &ks[lo], &ks[lo | j], &vs[lo], &vs[lo | j]);
    }
    __syncthreads();
  }
  for (int32_t i = threadIdx.x; i < kTile; i += blockDim.x) {
    keys[base + i] = ks[i];
    vals[base + i] = vs[i];
  }
}

}  // namespace

// x: int32[65536] keys; keys, vals: int32[65536] out (the merged keys and
// the index each came from).
extern "C" int probe_bitonic_launch(const void* x, void* keys, void* vals, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  int32_t* k = (int32_t*)keys;
  int32_t* v = (int32_t*)vals;
  for (int32_t j = hp::kSortN / 2; j >= kTile; j >>= 1) {
    const bool first = j == hp::kSortN / 2;
    bitonic_global_kernel<<<kPairs / 256, 256, 0, s>>>(first ? (const int32_t*)x : k, k, v, j,
                                                        first);
    int e = (int)cudaGetLastError();
    if (e != 0) return e;
  }
  bitonic_tile_kernel<<<hp::kSortN / kTile, 1024, 0, s>>>(k, v, kTile / 2);
  return (int)cudaGetLastError();
}
