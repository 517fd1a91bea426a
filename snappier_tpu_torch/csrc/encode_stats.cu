// The encoder's budget on Hopper: per fragment, how many probe groups miss,
// how many hit, how many iterations the extension walks take and how many
// bytes the matches cover.
//
// Replaces: tools/perf_probe_r4.py::_encode_stats_kernel (wrapper
// encode_stats), the TPU's instrumented encode walk: K2's greedy walk at 15
// hash bits with a probe of 4 positions (all stored), the stride-4
// extension that seeds the table once a step, the tail from one XOR and the
// clamp of the match to the fragment, and no emission. It is
// encode_variants.cuh's walk under EV_STATS_WALK with a WalkStats sink; the
// TPU's epoch-tagged table is the fresh table of EMPTY slots.
//
// SIMT counterpart of the TPU unit it measures: the TPU runs the walk on
// the scalar core over SMEM; here one thread walks over shared memory.
//
// What bounds it: the serial walk, as encode.cu: waves of fragments (one
// block per SM: the 64 KiB table and the 64 KiB fragment fill most of an
// SM's shared memory) times one fragment's chain of dependent shared-memory
// loads. The bytes, 32 MiB in and 8 KiB out for 512 fragments, take about
// 10 us at 3.35 TB/s.
//
// What the design does about it: encode.cu's layout (one block per
// fragment, the table and the fragment in dynamic shared memory, one
// walking thread); only the four counts leave the block.
#include <cuda_runtime.h>
#include <stdint.h>

#include "encode_variants.cuh"

namespace {

constexpr int kHashBits = 15;

__global__ void encode_stats_kernel(const uint8_t* __restrict__ frags, int64_t frag_w,
                                    const int32_t* __restrict__ lengths,
                                    int32_t* __restrict__ stats) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint16_t* table = reinterpret_cast<uint16_t*>(smem);
  uint8_t* s = smem + (sizeof(uint16_t) << kHashBits);
  const int64_t b = blockIdx.x;
  const int32_t n = ev::stage_fragment(smem, kHashBits, frags, frag_w, lengths, b);
  if (threadIdx.x == 0) {
    sc::WalkStats st;
    sc::encode_fragment_variant(s, n, table, sc::StaticWalk<sc::EV_STATS_WALK>{kHashBits, 1},
                                nullptr, st);
    int32_t* row = stats + b * 4;
    row[0] = st.miss_iters;
    row[1] = st.hits;
    row[2] = st.ext_iters;
    row[3] = st.match_bytes;
  }
}

}  // namespace

// frags: uint8[B, frag_w]; lengths: int32[B]; stats: int32[B, 4] (miss
// iterations, hits, extension iterations, matched bytes).
extern "C" int snappy_encode_stats_launch(const void* frags, int64_t frag_w, const void* lengths,
                                          int64_t batch, void* stats, void* stream) {
  if (batch == 0) return 0;
  const size_t smem = ev::smem_bytes(kHashBits, frag_w);
  cudaError_t e = cudaFuncSetAttribute(encode_stats_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  encode_stats_kernel<<<(unsigned)batch, ev::kThreads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)frags, frag_w, (const int32_t*)lengths, (int32_t*)stats);
  return (int)cudaGetLastError();
}
