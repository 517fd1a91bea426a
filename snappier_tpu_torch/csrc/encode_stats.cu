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
// What bounds it: the serial walk, as encode.cu: waves of fragments times
// one fragment's chain of dependent loads (the words at ip, the table
// slots, the candidate's words). The bytes, 32 MiB in and 8 KiB out for 512
// fragments, take about 10 us at 3.35 TB/s.
//
// What the design does about it: K2's layout, the ablation kernel of
// encode_variants.cuh with the counts as its sink (ev::StatsRows): one
// block of one warp per fragment, only the 64 KiB match table in dynamic
// shared memory (cleared by the warp), lane 0 walking the fragment through
// the read-only path (sc::RowWords where base and width are multiples of
// 16, else sc::RowBytes). Three walks share an SM, so 512 fragments run in
// two waves on 132 SMs, where a staged fragment beside the table left one
// block an SM and four waves; only the four counts leave the block. The
// attributes are set and each launch enqueued under one lock
// (smem_config.cuh).
#include <cuda_runtime.h>
#include <stdint.h>

#include "encode_variants.cuh"

// frags: uint8[B, frag_w], any address and width; lengths: int32[B]; stats:
// int32[B, 4] (miss iterations, hits, extension iterations, matched bytes).
extern "C" int snappy_encode_stats_launch(const void* frags, int64_t frag_w, const void* lengths,
                                          int64_t batch, void* stats, void* stream) {
  return ev::launch(ev::kStatsWalk, frags, frag_w, lengths, batch,
                    ev::StatsRows{(int32_t*)stats}, stream);
}

// The layout of the launch above for rows at frags of width frag_w
// (ev::layout: blocks per SM, shared bytes, threads, loader).
extern "C" int snappy_encode_stats_layout(const void* frags, int64_t frag_w, int32_t* out) {
  return ev::layout<ev::StatsRows>(ev::kStatsWalk, frags, frag_w, out);
}
