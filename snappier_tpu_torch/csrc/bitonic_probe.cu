// The in-kernel sort probe on Hopper.
//
// tools/perf_probe_hybrid.py::_bitonic_kernel (wrapper bitonic): one merge
// pass of a bitonic network, 16 compare-exchange stages (k = 15, j = 32768
// down to 1), over 65,536 int32 keys and their indices, with the TPU's rule
// (hp::bitonic_keep: equal keys keep their own key and index). The TPU holds
// all 512 KB of keys and indices in VMEM and runs each stage as whole-array
// row and lane permutations.
//
// What bounds it: 256 KB of keys in, 512 KB of keys and indices out, about
// 0.23 us at 3.35 TB/s; and the stages' dependence: each needs the whole of
// the one before it, so a launch a stage pays a launch and a round trip of
// the arrays through L2 each time.
//
// What the design does about it: one launch of one thread-block cluster of
// hp::kSortCtas CTAs, which holds the whole array and its indices on chip
// (1,024 threads of 8 elements a CTA). CTA c takes the elements whose bits
// 10-12 are c (8 runs of 1,024, by TMA), so the three top stages run in each
// thread's registers (hp::bitonic_top). One transpose through distributed
// shared memory in 16-byte pieces (hp::bitonic_send) gives CTA c the
// contiguous tile c << 13 in buffers of its own, so only two cluster
// barriers order it: the first (arrived at the start, awaited before the
// first remote store) that every CTA runs, the second that the tile is
// whole. The tile's 13 stages are three rounds of three stages in registers
// through shared memory, a barrier each (hp::bitonic_tile_regs), then j = 8
// by a warp shuffle and j = 4, 2, 1 in registers, stored as 16-byte vectors
// (hp::bitonic_tile_last).
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hybrid_probes.cuh"
#include "smem_config.cuh"

namespace cg = cooperative_groups;

namespace {

// A CTA's runs and their indices, then its tile and their indices.
constexpr size_t kSmem = 4 * 4 * (size_t)hp::kSortTile;

__global__ void __cluster_dims__(hp::kSortCtas, 1, 1) __launch_bounds__(hp::kSortThreads, 1)
    bitonic_cluster_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ keys,
                           int32_t* __restrict__ vals) {
  extern __shared__ __align__(16) int32_t smem[];
  __shared__ __align__(8) uint64_t loaded;
  int32_t* rk = smem;  // the runs' keys (by TMA) and indices
  int32_t* rv = smem + hp::kSortTile;
  int32_t* ks = smem + 2 * hp::kSortTile;  // the tile's
  int32_t* vs = smem + 3 * hp::kSortTile;
  cg::cluster_group cluster = cg::this_cluster();
  const int32_t c = (int32_t)cluster.block_rank();
  const int32_t wi = threadIdx.x >> 5;
  const uint32_t bar = (uint32_t)__cvta_generic_to_shared(&loaded);
  // This CTA runs: the others may store into its tile once all have said so.
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  // The CTA's 8 runs of keys by TMA, one thread issuing.
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    constexpr uint32_t kRunBytes = 4 * hp::kSortRun;
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
                 "r"(8 * kRunBytes)
                 : "memory");
    const uint32_t dst = (uint32_t)__cvta_generic_to_shared(rk);
#pragma unroll
    for (int r = 0; r < 8; r++) {
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
          "[%3];\n" ::"r"(dst + r * kRunBytes),
          "l"(x + (r << 13) + (c << 10)), "r"(kRunBytes), "r"(bar)
          : "memory");
    }
  }
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar)
        : "memory");
  }
  const sc::CudaWarp w;
  hp::bitonic_top(w, c, wi, rk, rv);
  __syncthreads();
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  hp::bitonic_send(w, c, wi, rk, rv,
                   [&](int32_t cta, int32_t i, const int32_t* k, const int32_t* v) {
                     hp::store_words<4>(cluster.map_shared_rank(ks, cta) + i, k);
                     hp::store_words<4>(cluster.map_shared_rank(vs, cta) + i, v);
                   });
  cluster.sync();  // the tile is whole
#pragma unroll
  for (int q = 0; q < 3; q++) {
    hp::bitonic_tile_regs(w, c, wi, ks, vs, hp::kSortTopShift - 3 * q);
    __syncthreads();
  }
  hp::bitonic_tile_last(w, c, wi, ks, vs, keys, vals);
}

attrs::SetFor set_for;

}  // namespace

// x: int32[65536] keys, 16-byte aligned; keys, vals: int32[65536] out (the
// merged keys and the index each came from), 16-byte aligned.
extern "C" int probe_bitonic_launch(const void* x, void* keys, void* vals, void* stream) {
  return (int)attrs::configure_and_launch(bitonic_cluster_kernel, kSmem, set_for, [&] {
    bitonic_cluster_kernel<<<hp::kSortCtas, hp::kSortThreads, kSmem, (cudaStream_t)stream>>>(
        (const int32_t*)x, (int32_t*)keys, (int32_t*)vals);
    return cudaGetLastError();
  });
}
