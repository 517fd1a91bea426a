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
// What the design does about it: one block of 256 threads per fragment
// stages the table and the fragment in dynamic shared memory, and one thread
// walks the staged copy (ev::Staged); only the four counts leave the block.
// The attributes are set and each launch enqueued under one lock
// (smem_config.cuh).
#include <cuda_runtime.h>
#include <stdint.h>

#include "encode_variants.cuh"
#include "smem_config.cuh"

namespace {

constexpr int kHashBits = 15;
constexpr int kThreads = 256;
constexpr int kZeros = 16;  // the zero bytes ev::Staged reads past a fragment

// The match table, then the fragment and its zero bytes.
size_t smem_bytes(int64_t frag_w) {
  return (sizeof(uint16_t) << kHashBits) + (size_t)((frag_w + kZeros + 15) & ~15);
}

__global__ void encode_stats_kernel(const uint8_t* __restrict__ frags, int64_t frag_w,
                                    const int32_t* __restrict__ lengths,
                                    int32_t* __restrict__ stats) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint16_t* table = reinterpret_cast<uint16_t*>(smem);
  uint8_t* s = smem + (sizeof(uint16_t) << kHashBits);
  const int64_t b = blockIdx.x;
  int32_t n = lengths[b];
  n = n < 0 ? 0 : (n > frag_w ? (int32_t)frag_w : n);
  // All threads clear the table and stage the fragment and its zero bytes.
  uint4* t4 = reinterpret_cast<uint4*>(smem);
  const int words = (int)((sizeof(uint16_t) << kHashBits) / sizeof(uint4));
  const uint4 empty = make_uint4(0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu);
  for (int w = threadIdx.x; w < words; w += blockDim.x) t4[w] = empty;
  const uint8_t* row = frags + b * frag_w;
  for (int32_t i = threadIdx.x; i < n + kZeros; i += blockDim.x) s[i] = i < n ? row[i] : 0;
  __syncthreads();
  if (threadIdx.x == 0) {
    sc::WalkStats st;
    sc::encode_fragment_variant(ev::Staged{s, n}, n, table,
                                sc::StaticWalk<sc::EV_STATS_WALK>{kHashBits, 1}, nullptr, st);
    int32_t* out = stats + b * 4;
    out[0] = st.miss_iters;
    out[1] = st.hits;
    out[2] = st.ext_iters;
    out[3] = st.match_bytes;
  }
}

attrs::SetFor set_for;

}  // namespace

// frags: uint8[B, frag_w]; lengths: int32[B]; stats: int32[B, 4] (miss
// iterations, hits, extension iterations, matched bytes).
extern "C" int snappy_encode_stats_launch(const void* frags, int64_t frag_w, const void* lengths,
                                          int64_t batch, void* stats, void* stream) {
  if (batch == 0) return 0;
  const size_t smem = smem_bytes(frag_w);
  return (int)attrs::configure_and_launch(encode_stats_kernel, smem, set_for, [&] {
    encode_stats_kernel<<<(unsigned)batch, kThreads, smem, (cudaStream_t)stream>>>(
        (const uint8_t*)frags, frag_w, (const int32_t*)lengths, (int32_t*)stats);
    return cudaGetLastError();
  });
}
