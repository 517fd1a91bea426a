// Staging of the decode-walk ablation kernels (decode_variants.cu): the
// shared-memory geometry of a block's images, the coalesced load of a
// compressed row into a word image, the store of a decoded image to its row,
// and the warp barrier the walks are given; and the row length every decode
// ablation kernel clamps to its row (row_length: decode_hybrid.cu and
// decode_pipe.cu too).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "decode_variants.cuh"

namespace stage {

struct WarpSync {
  __host__ __device__ void operator()() const {
#ifdef __CUDA_ARCH__
    __syncwarp();
#endif
  }
};

constexpr int LUT_WORDS = 256;

// Shared-memory geometry, the same on both sides of the launch.
__host__ __device__ inline int32_t comp_words(int64_t cc) {
  return (int32_t)((((cc + 3) >> 2) + 2 + 3) & ~(int64_t)3);  // row + 8 bytes, 16-byte groups
}
__host__ __device__ inline int32_t out_words(int32_t out_cap) {
  return (((out_cap + 3) >> 2) + 4 + 3) & ~3;  // out_cap + over-store, 16-byte groups
}
__host__ __device__ inline int32_t byte_slack_words() { return 16; }  // 64 bytes of over-copy

// Stage the first n + 8 bytes of a row as little-endian words; bytes at or
// past the row's width cc are zero.
__device__ inline void stage_row(const uint8_t* __restrict__ row, int64_t cc, int32_t n,
                          uint32_t* words, int32_t wc) {
  int32_t nw = (n + 8 + 3) >> 2;
  if (nw > wc) nw = wc;
  int32_t whole = (int32_t)(cc >> 2);  // words that lie inside the row
  bool aligned = (((uintptr_t)row) & 3) == 0;
  for (int32_t w = threadIdx.x; w < nw; w += blockDim.x) {
    uint32_t v = 0;
    if (aligned && w < whole) {
      v = reinterpret_cast<const uint32_t*>(row)[w];
    } else {
      for (int j = 0; j < 4; j++) {
        int64_t i = (int64_t)w * 4 + j;
        if (i < cc) v |= (uint32_t)row[i] << (8 * j);
      }
    }
    words[w] = v;
  }
}

__device__ inline void build_lut(int32_t* lut) {
  for (int t = threadIdx.x; t < LUT_WORDS; t += blockDim.x) lut[t] = sc::tag_descriptor(t);
}

// out_len bytes of a shared-memory image (16-byte aligned) to a row of out.
__device__ inline void store_row(const uint8_t* img, int32_t nb, uint8_t* dst, int32_t out_cap) {
  if ((out_cap & 15) == 0) {
    // Rows start 16-byte aligned: whole 16-byte groups (the tail past
    // out_len is garbage by contract and may be written).
    int32_t groups = (nb + 15) >> 4;
    const uint4* s4 = reinterpret_cast<const uint4*>(img);
    uint4* d4 = reinterpret_cast<uint4*>(dst);
    for (int32_t g = threadIdx.x; g < groups; g += blockDim.x) d4[g] = s4[g];
  } else {
    for (int32_t i = threadIdx.x; i < nb; i += blockDim.x) dst[i] = img[i];
  }
}

__device__ inline int32_t row_length(const int32_t* comp_lens, int64_t b, int64_t cc) {
  int32_t n = comp_lens[b];
  if (n < 0) n = 0;
  if (n > cc) n = (int32_t)cc;
  return n;
}

}  // namespace stage
