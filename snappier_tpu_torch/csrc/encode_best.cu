// Batched level="best" Snappy encode on Hopper.
//
// Replaces: snappier_tpu/ops/pallas/scalar_codec.py::_encode_kernel with
// exact_cands=True (wrapper _encode_best_pallas, reached from
// encode_blocks_best), the TPU scalar-core walk driven by one precomputed
// candidate per position instead of a hash table.
//
// What bounds it: as in fast mode, the walk is serial per fragment (each
// step depends on the match end of the one before), so a fragment's time is
// its step count times the latency of dependent shared-memory loads. The
// bytes it must move (32 MiB of fragments, 128 MiB of int32 candidates,
// about 8 MiB of bodies for 512 fragments) take about 0.05 ms at 3.35 TB/s,
// far below the walk.
//
// What the design does about it: one block per fragment. An int32 candidate
// array of a 64 KiB fragment is 256 KiB, more than a block's 227 KB of
// shared memory, so the staging pass narrows each candidate to 16 bits
// (EMPTY = 0xFFFF for none, safe because a candidate lies below its
// position, which is below 65536) with coalesced loads by all threads, beside
// the fragment itself: 192 KiB, one block per SM. One thread then walks, so
// every candidate, verify and extension read is a shared-memory load.
#include <cuda_runtime.h>
#include <stdint.h>

#include "scalar_codec.cuh"

namespace {

constexpr int kThreads = 256;

__host__ __device__ inline size_t cand_bytes(int64_t frag_w) {
  return (size_t)((2 * frag_w + 15) & ~(int64_t)15);
}

__global__ void encode_best_kernel(const uint8_t* __restrict__ frags, int64_t frag_w,
                                   const int32_t* __restrict__ lengths,
                                   const int32_t* __restrict__ cands, int32_t skip_base,
                                   uint8_t* __restrict__ bodies, int64_t body_w,
                                   int32_t* __restrict__ body_lens) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint16_t* c16 = reinterpret_cast<uint16_t*>(smem);
  uint8_t* s = smem + cand_bytes(frag_w);
  const int64_t b = blockIdx.x;
  int32_t n = lengths[b];
  n = n < 0 ? 0 : (n > frag_w ? (int32_t)frag_w : n);

  const int32_t* crow = cands + b * frag_w;
  for (int32_t i = threadIdx.x; i < n; i += blockDim.x) {
    int32_t c = crow[i];
    c16[i] = (c >= 0 && c < i) ? (uint16_t)c : sc::EMPTY;
  }
  // Bytes past n read as zero (8 of them are read at most).
  const uint8_t* row = frags + b * frag_w;
  for (int32_t i = threadIdx.x; i < n + 8; i += blockDim.x) s[i] = i < n ? row[i] : 0;
  __syncthreads();

  if (threadIdx.x == 0) {
    body_lens[b] = sc::encode_fragment_best(s, n, c16, skip_base, bodies + b * body_w);
  }
}

}  // namespace

// frags: uint8[B, frag_w]; lengths, body_lens: int32[B]; cands: int32[B, frag_w];
// bodies: uint8[B, body_w] with body_w >= frag_w + frag_w / 65 + 8.
extern "C" int snappy_encode_best_launch(const void* frags, int64_t frag_w,
                                         const void* lengths, int64_t batch,
                                         const void* cands, int32_t skip_base, void* bodies,
                                         int64_t body_w, void* body_lens, void* stream) {
  if (batch == 0) return 0;
  size_t smem = cand_bytes(frag_w) + (size_t)((frag_w + 8 + 15) & ~15);
  cudaError_t e = cudaFuncSetAttribute(encode_best_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  encode_best_kernel<<<(unsigned)batch, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)frags, frag_w, (const int32_t*)lengths, (const int32_t*)cands,
      skip_base, (uint8_t*)bodies, body_w, (int32_t*)body_lens);
  return (int)cudaGetLastError();
}
