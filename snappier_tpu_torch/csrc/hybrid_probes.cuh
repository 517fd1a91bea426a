// Step bodies of the hybrid decode's micro-probes (hybrid_probes.cu), as
// __host__ __device__ functions that a host C++ compiler also builds for the
// tests. Each computes what its TPU kernel in tools/perf_probe_hybrid.py
// computes, with int32 arithmetic done in uint32 where XLA wraps.
#pragma once

#include <stdint.h>

#include "scalar_codec.cuh"

namespace hp {

constexpr int32_t kRecHalf = 8192;  // chainrec: the record at t & 8191, op at + 8192
constexpr int32_t kRecWords = 2 * kRecHalf;
constexpr int32_t kImageWords = 16384;  // vcopy's image: 128 rows of 128 lanes
constexpr int32_t kLanes = 128;
constexpr int32_t kCountAt = 3 * kRecHalf;  // vcopy's loop count in its record array
constexpr uint32_t kFill = 0x80000000u;  // interpret mode's unwritten scratch word

// --- chain / chainrec (_chain_kernel) -------------------------------------

// One walk ip += adv[ip] from ip while ip < n; returns the final ip and sets
// steps. With kRec it stores (ip << 8) | (a & 0xFF) and the running sum of
// advances per step. The TPU stores record t at t and t + 8192 of a
// 16,384-word buffer, past its end after 8,192 steps; here at t & 8191, so
// a longer walk overwrites its first records. Nothing reads the buffer, so
// the checksum is the TPU's either way.
template <bool kRec>
SC_HD int32_t chain_trial(const int32_t* adv, int32_t n, int32_t ip, int32_t* rec,
                          int32_t& steps) {
  int32_t op = 0, t = 0;
  while (ip < n) {
    const int32_t a = adv[ip];
    if (kRec) {
      const int32_t slot = t & (kRecHalf - 1);
      rec[slot] = (int32_t)(((uint32_t)ip << 8) | (uint32_t)(a & 0xFF));
      rec[slot + kRecHalf] = op;
      op += a;
    }
    t++;
    ip += a;
  }
  steps = t;
  return ip;
}

// R trials from start + (r & 1): the sum of the final ip, plus the steps
// with kRec (the TPU's t stays 0 without records).
template <bool kRec>
SC_HD int32_t chain_walk(const int32_t* adv, int32_t n, int32_t start, int32_t R, int32_t* rec) {
  uint32_t acc = 0;
  for (int32_t r = 0; r < R; r++) {
    int32_t steps;
    const int32_t ip = chain_trial<kRec>(adv, n, start + (r & 1), rec, steps);
    acc += (uint32_t)ip + (kRec ? (uint32_t)steps : 0u);
  }
  return (int32_t)acc;
}

// --- vcopy (_vcopy_kernel) -------------------------------------------------

// One record: where it reads and writes. w[i] is word i of the 128 words
// that start at lane sl of row r0 and go on in row r1; the 2d body's r1 is
// r0 + 1. The 3d body rotates a pair of 8-row tiles by sublanes and, when
// r0 is the last row of its tile (srow 7), takes the pair's row 7 as r1:
// row 6 of the next tile, clamped to tile 15. It writes only tile dw >> 10,
// so a spill past the tile's row 7 is dropped.
struct VcopyRecord {
  int32_t r0, r1, sl, a8, dr, dl, nw;
  bool spill;
};

template <bool k3d>
SC_HD VcopyRecord vcopy_record(int32_t dst, int32_t src, int32_t ln) {
  VcopyRecord r;
  const int32_t sw = src >> 2, dw = dst >> 2;
  r.r0 = sw >> 7;
  r.r1 = r.r0 + 1;
  r.sl = sw & 127;
  r.a8 = (src & 3) * 8;
  r.dr = dw >> 7;
  r.dl = dw & 127;
  r.nw = ((int32_t)((uint32_t)ln + 3u) >> 2) + 1;
  r.spill = true;
  if (k3d) {
    if ((r.r0 & 7) == 7) r.r1 = ((sw >> 10) + 1 < 15 ? (sw >> 10) + 1 : 15) * 8 + 6;
    r.spill = (r.dr & 7) != 7;
  }
  return r;
}

// Word q of w.
SC_HD uint32_t vcopy_word(const uint32_t* img, const VcopyRecord& r, int32_t q) {
  return q < kLanes - r.sl ? img[r.r0 * kLanes + q + r.sl] : img[r.r1 * kLanes + q + r.sl - kLanes];
}

// rolled[i]: the funnel-shifted w (the next word from w[(j + 1) & 127]: lane
// 127 takes lane 0, as the TPU's roll does), rotated to start at lane dl. No
// shift by 32: phase 0 takes w itself.
SC_HD uint32_t vcopy_lane(const uint32_t* img, const VcopyRecord& r, int32_t i) {
  const int32_t j = (i - r.dl) & 127;
  const uint32_t w = vcopy_word(img, r, j);
  if (r.a8 == 0) return w;
  return (w >> r.a8) | (vcopy_word(img, r, (j + 1) & 127) << (32 - r.a8));
}

// Lane i's stores: row dr under lanes [dl, dl + nw), row dr + 1 under lanes
// below dl + nw - 128 (unless the 3d body drops the spill).
SC_HD void vcopy_store(uint32_t* img, const VcopyRecord& r, int32_t i, uint32_t v) {
  if (i >= r.dl && i < r.dl + r.nw) img[r.dr * kLanes + i] = v;
  if (r.spill && i < r.dl + r.nw - kLanes) img[(r.dr + 1) * kLanes + i] = v;
}

// --- coissue (_coissue_kernel) ---------------------------------------------

// The scratch as interpret mode leaves it: 0x80000000, seed at word 0.
SC_HD void coissue_init(uint32_t* scratch, int32_t seed) {
  for (int i = 0; i < 64; i++) scratch[i] = kFill;
  scratch[0] = (uint32_t)seed;
}

// Iteration t of the scalar chain (24 dependent operations through the
// 64-word scratch); returns x, which the TPU adds to its sum.
SC_HD uint32_t coissue_step(uint32_t* scratch, uint32_t t) {
  uint32_t x = scratch[t & 63];
#pragma unroll
  for (int j = 0; j < 6; j++) {
    x = (x * 5u + 1u) & 0x7FFFFFFFu;
    scratch[(t + x) & 63] = x;
    x ^= scratch[(x >> 3) & 63];
  }
  return x;
}

// One vector update of a tile element: v * 3 + roll(v, s)[i], the rolled
// value taken by the caller from lane (i - s) & 127 of the same row.
SC_HD uint32_t coissue_update(uint32_t v, uint32_t rolled) { return v * 3u + rolled; }

}  // namespace hp
