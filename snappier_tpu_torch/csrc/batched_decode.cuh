// The block of the batched decode kernels (decode.cu's K1, decode_hybrid.cu's
// forms, decode_pipe.cu's pipelined walks, decode_variants.cu's ablation):
// two warps over one Snappy block whose output is built in shared memory.
// Warp 0 runs the walk (sc::decode_block_batched over a tag source) and
// hands each parsed batch (its tags' offsets and sources, 264 bytes) to warp
// 1 through a queue of four slots in shared memory; warp 1 writes it
// (sc::emit_batch), so a batch's parse overlaps the previous batch's output.
// The output leaves shared memory in one coalesced pass.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "scalar_codec.cuh"

namespace bd {

constexpr int kWarp = 32;
constexpr int kQueue = 4;  // batches in flight between the two warps
constexpr int kThreads = 2 * kWarp;

// A queue slot: one parsed batch, or the end of the walk.
struct Slot {
  int32_t delta[kWarp];
  uint32_t start[kWarp];
  sc::Batch bt;
  int32_t op;
  int32_t end;
};

// The queue and the walk's result, in the block's static shared memory.
struct Queue {
  Slot q[kQueue];
  int32_t head, tail;  // slots published by warp 0, freed by warp 1
  sc::DecodeResult res;
};

// Before the block's first __syncthreads.
__device__ inline void init(Queue& qs) {
  if (threadIdx.x == 0) qs.head = qs.tail = 0;
}

// A block's walk reads no further than about six times out_cap into its
// row (ip passes only tags that were checked against the output left), so
// a row wider than 2^31 - 1 bytes is read as its first 2^31 - 1.
__device__ inline int32_t row_width(int64_t cc) {
  return cc < 0x7FFFFFFF ? (int32_t)cc : 0x7FFFFFFF;
}

// Block b's compressed length, taken as 0 below 0 and as the row's width
// past it.
__device__ inline int32_t row_length(const int32_t* comp_lens, int64_t b, int64_t cc) {
  int32_t n = comp_lens[b];
  if (n < 0) n = 0;
  if (n > cc) n = (int32_t)cc;
  return n;
}

// The output row leaves shared memory: whole 16-byte groups when rows start
// 16-byte aligned (the tail past out_len is garbage by contract and may be
// written), else bytes.
__device__ inline void store_row(const uint8_t* ow, int32_t nb, uint8_t* dst, int32_t out_cap) {
  if ((out_cap & 15) == 0) {
    const int32_t groups = (nb + 15) >> 4;
    const uint4* s4 = reinterpret_cast<const uint4*>(ow);
    uint4* d4 = reinterpret_cast<uint4*>(dst);
    for (int32_t g = threadIdx.x; g < groups; g += kThreads) d4[g] = s4[g];
  } else {
    for (int32_t i = threadIdx.x; i < nb; i += kThreads) dst[i] = ow[i];
  }
}

// The block's two warps over one Snappy block, after init(qs) and a
// __syncthreads. Warp 0 returns walk(step) (a decode_block_batched call
// with the step given), handing each batch on; warp 1 calls emit(bt, op,
// delta, start) for each, its slot first in registers (the output's stores
// could alias it). Returns the walk's result on every thread, the output
// complete. Without hand_on (the same on every thread) warp 0 walks alone
// and hands nothing on, and no output is written.
template <class Walk, class Emit>
__device__ sc::DecodeResult run(Queue& qs, Walk walk, Emit emit, bool hand_on = true) {
  const int lane = threadIdx.x & (kWarp - 1);
  volatile int32_t* vhead = &qs.head;
  volatile int32_t* vtail = &qs.tail;
  if (threadIdx.x < kWarp) {
    int32_t h = 0;
    auto publish = [&](const sc::Batch& bt, int32_t op, int32_t end, int32_t delta,
                       uint32_t start) {
      while (h - *vtail >= kQueue) {
      }
      Slot& s = qs.q[h % kQueue];
      s.delta[lane] = delta;
      s.start[lane] = start;
      if (lane == 0) {
        s.bt = bt;
        s.op = op;
        s.end = end;
      }
      __syncwarp();
      if (lane == 0) {
        __threadfence_block();
        *vhead = h + 1;
      }
      h++;
    };
    auto step = [&](const sc::Batch& bt, int32_t op, const auto& delta, const auto& start) {
      if (hand_on) publish(bt, op, 0, delta.v, start.v);
    };
    const sc::DecodeResult r = walk(step);
    if (hand_on) publish(sc::Batch{}, 0, 1, 0, 0u);
    if (lane == 0) qs.res = r;
  } else if (hand_on) {
    for (int32_t t = 0;; t++) {
      while (*vhead == t) {
      }
      __threadfence_block();
      const Slot& s = qs.q[t % kQueue];
      if (s.end) break;
      const sc::Batch bt = s.bt;
      const int32_t op = s.op;
      const sc::LanesOf<sc::CudaWarp, int32_t> delta{s.delta[lane]};
      const sc::LanesOf<sc::CudaWarp, uint32_t> start{s.start[lane]};
      emit(bt, op, delta, start);
      __syncwarp();
      if (lane == 0) {
        __threadfence_block();
        *vtail = t + 1;
      }
    }
  }
  __syncthreads();
  return qs.res;
}

}  // namespace bd
