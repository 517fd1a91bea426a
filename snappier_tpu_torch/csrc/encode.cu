// Batched greedy Snappy encode on Hopper.
//
// Replaces: snappier_tpu/ops/pallas/scalar_codec.py::_encode_kernel in fast
// mode (wrapper encode_blocks_scalar), the TPU scalar-core LZ77 walk.
//
// What bounds it: the greedy walk is serial per fragment (each probe group
// depends on the table writes and the match end of the one before), so a
// fragment's time is its probe count times the latency of a dependent
// shared-memory round trip; 32 MiB in and about 7 MiB out at 3.35 TB/s is
// about 12 us for the whole batch, far below the walk.
//
// What the design does about it: one block per fragment. The match table
// (16-bit slots, 64 KiB at 15 hash bits) and the fragment itself (64 KiB)
// live in dynamic shared memory, so every probe, verify and extension read
// is a shared-memory load. All threads clear the table and stage the
// fragment with coalesced loads; one thread then walks. 128 KiB of shared
// memory per block leaves one block per SM, so 132 fragments walk at once.
#include <cuda_runtime.h>
#include <stdint.h>

#include "scalar_codec.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void encode_kernel(const uint8_t* __restrict__ frags, int64_t frag_w,
                              const int32_t* __restrict__ lengths, int hash_bits,
                              int32_t skip_base, uint8_t* __restrict__ bodies,
                              int64_t body_w, int32_t* __restrict__ body_lens) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint16_t* table = reinterpret_cast<uint16_t*>(smem);
  uint8_t* s = smem + (sizeof(uint16_t) << hash_bits);
  const int64_t b = blockIdx.x;
  int32_t n = lengths[b];
  n = n < 0 ? 0 : (n > frag_w ? (int32_t)frag_w : n);

  uint4* t4 = reinterpret_cast<uint4*>(table);
  const int words = (int)((sizeof(uint16_t) << hash_bits) / sizeof(uint4));
  const uint4 empty = make_uint4(0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu);
  for (int w = threadIdx.x; w < words; w += blockDim.x) t4[w] = empty;
  // Bytes past n read as zero (8 of them are read at most).
  const uint8_t* row = frags + b * frag_w;
  for (int32_t i = threadIdx.x; i < n + 8; i += blockDim.x) s[i] = i < n ? row[i] : 0;
  __syncthreads();

  if (threadIdx.x == 0) {
    body_lens[b] = sc::encode_fragment(s, n, table, hash_bits, skip_base,
                                       bodies + b * body_w);
  }
}

}  // namespace

// frags: uint8[B, frag_w]; lengths, body_lens: int32[B];
// bodies: uint8[B, body_w] with body_w >= frag_w + frag_w / 65 + 8.
extern "C" int snappy_encode_launch(const void* frags, int64_t frag_w, const void* lengths,
                                    int64_t batch, int32_t hash_bits, int32_t skip_base,
                                    void* bodies, int64_t body_w, void* body_lens,
                                    void* stream) {
  if (batch == 0) return 0;
  size_t smem = (sizeof(uint16_t) << hash_bits) + (size_t)((frag_w + 8 + 15) & ~15);
  cudaError_t e = cudaFuncSetAttribute(encode_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  encode_kernel<<<(unsigned)batch, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)frags, frag_w, (const int32_t*)lengths, hash_bits, skip_base,
      (uint8_t*)bodies, body_w, (int32_t*)body_lens);
  return (int)cudaGetLastError();
}
