// Step bodies of the hybrid decode's micro-probes (hybrid_probes.cu and,
// for the sort, bitonic_probe.cu), as __host__ __device__ functions that a
// host C++ compiler also builds for the tests. Each computes what its TPU
// kernel in tools/perf_probe_hybrid.py computes, with int32 arithmetic done
// in uint32 where XLA wraps.
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

// A 64-word scratch as interpret mode leaves it: 0x80000000, seed at word 0
// (coissue and bprobe).
SC_HD void scratch_init(uint32_t* scratch, int32_t seed) {
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

// --- iso (_iso_kernel) -------------------------------------------------------

// One part of vcopy's body alone per mode, over the records 20 times (pass r
// from record r & 1). Every mode but scalar adds dst to the sum; full is
// vcopy's 2d body (vcopy_record<false>, vcopy_lane, vcopy_store).
enum IsoMode { kIsoScalar = 0, kIsoDynload, kIsoDynload8, kIsoStatroll, kIsoDynroll, kIsoFull };
constexpr int32_t kIsoPasses = 20;

// scalar: the record's words through an 8-step chain, no image work.
SC_HD uint32_t iso_scalar(int32_t dst, int32_t src, int32_t ln) {
  uint32_t x = ((uint32_t)dst * 5u + (uint32_t)src) ^ (uint32_t)ln;
#pragma unroll
  for (int i = 0; i < 8; i++) x = (x * 5u + 1u) & 0x7FFFFFFFu;
  return x;
}

// The row modes: rows [sr, sr + rows) stored at [dr, dr + rows), each row
// rolled by shift lanes (pltpu.roll: roll(v, s)[p] = v[(p - s) & 127]).
// dynload8 moves the 8 rows of the aligned group; statroll rolls by 5,
// dynroll by (128 - sl) & 127, which brings lane sl to lane 0.
struct IsoRecord {
  int32_t sr, dr, rows, shift;
};

template <int kMode>
SC_HD IsoRecord iso_record(int32_t dst, int32_t src) {
  const int32_t sw = src >> 2, dw = dst >> 2;
  IsoRecord r{sw >> 7, dw >> 7, 1, 0};
  if (kMode == kIsoDynload8) {
    r.sr &= 120;
    r.dr &= 120;
    r.rows = 8;
  }
  if (kMode == kIsoStatroll) r.shift = 5;
  if (kMode == kIsoDynroll) r.shift = (128 - (sw & 127)) & 127;
  return r;
}

// Word i (0 <= i < 128 * rows) of what the record stores at row dr.
SC_HD uint32_t iso_word(const uint32_t* img, const IsoRecord& r, int32_t i) {
  return img[(r.sr + (i >> 7)) * kLanes + (((i & 127) - r.shift) & 127)];
}

SC_HD void iso_store(uint32_t* img, const IsoRecord& r, int32_t i, uint32_t v) {
  img[r.dr * kLanes + i] = v;
}

// --- bprobe (_bprobe_kernel) -------------------------------------------------

constexpr int32_t kBprobeIters = 524288;

// Iteration t: a 4-step mix of the scratch word at t & 63, then kNwhen
// stores under a data-dependent condition (pl.when), or with kNwhen 0 three
// select-stores that write the old word back where the bit is clear.
// Shifts are arithmetic on int32 (a word never written reads 0x80000000, so
// x may start negative); adds wrap. Returns x, which the TPU adds to its sum.
template <int kNwhen>
SC_HD uint32_t bprobe_step(uint32_t* scratch, uint32_t t) {
  int32_t x = (int32_t)(scratch[t & 63] ^ t);
#pragma unroll
  for (int i = 0; i < 4; i++) x = (int32_t)(((uint32_t)x + (uint32_t)(x >> 3)) & 0x7FFFFFFFu);
  if (kNwhen) {
#pragma unroll
    for (int k = 0; k < kNwhen; k++) {
      if ((x >> k) & 1) scratch[(t + k) & 63] = (uint32_t)x + k;
    }
  } else {
#pragma unroll
    for (int k = 0; k < 3; k++) {
      const uint32_t old = scratch[(t + k) & 63];
      scratch[(t + k) & 63] = ((x >> k) & 1) ? (uint32_t)x + k : old;
    }
  }
  return (uint32_t)x;
}

// --- cliff (_cliff_kernel) and the chase ------------------------------------

// chain's walk with a body per tag that writes a 16,384-word image, which
// persists across the trials; kChase is the same walk with no body (chain's
// function, the latency floor the cliff modes are held to).
enum CliffMode { kCliffWhen1 = 0, kCliffWhen2, kCliffFori, kCliffStore4, kCliffLoad4, kChase };
constexpr uint32_t kCliffMask = kImageWords - 1;
constexpr uint32_t kCliffBytes = 4u * kCliffMask;  // a word's byte offset in the image, masked
constexpr int32_t kCliffImageWords = kImageWords + 4;  // the image, the dummy, 16-byte groups
constexpr int kCliffUnroll = 4;  // steps between two exit tests

// The advance array as the walk stages it: word i holds 4 * adv[i] below n
// (a byte offset, so that a step is a load and an add) and 0 at and past n
// (a step there keeps ip where it is). The staged copy holds the advance
// array's own words and room past n for the largest advance below n, so
// that the load a walk issues at its final ip lies inside
// (ops/cuda/hybrid_probes.py::cliff_staged_words).
SC_HD int32_t cliff_staged(const int32_t* adv, int32_t n, int32_t i) {
  return i < n ? 4 * adv[i] : 0;
}

// The image word at byte offset x (masked to the image) where `on`, else
// the dummy word past the image: a select, no branch.
SC_HD uint32_t& cliff_word(uint32_t* img, uint32_t x, bool on = true) {
  const uint32_t at = on ? x & kCliffBytes : 4u * kImageWords;
  return *reinterpret_cast<uint32_t*>(reinterpret_cast<char*>(img) + at);
}

// One step's body at ip, op (as the byte offset o4 = 4 * op) and advance a
// (unscaled; a4 = 4 * a); `live` is false for a step past the end (a is 0
// there). No branch: a store the body does not make goes to the dummy word
// (when1, when2, store4 past the end), except fori's, whose 7 stores,
// unrolled over a & 7 with the TPU's carry, are each predicated on its
// index. load4 past the end stores back the two words it loaded.
template <int kMode>
SC_HD void cliff_body(uint32_t* __restrict__ img, uint32_t ui, uint32_t o4, uint32_t ua,
                      uint32_t a4, bool live) {
  if (kMode == kCliffWhen1) {
    cliff_word(img, o4, ua > 3u) = ua;
  } else if (kMode == kCliffWhen2) {
    const bool s2 = ua > 2u, s4 = ua > 13u;
    cliff_word(img, o4, s2) = ua;
    cliff_word(img, o4 + 4u, s2) = ua ^ ui;
    cliff_word(img, o4 + 8u, s4) = ua + ui;
    cliff_word(img, o4 + 12u, s4) = ua - ui;
  } else if (kMode == kCliffFori) {
    const uint32_t cnt = ua > 2u ? ua & 7u : 0u;
    uint32_t carry = ua;
#pragma unroll
    for (uint32_t k = 0; k < 7u; k++) {
      if (k < cnt) cliff_word(img, o4 + 4u * k) = carry + k;
      carry ^= k;
    }
  } else if (kMode == kCliffStore4) {
    cliff_word(img, o4, live) = ua;
    cliff_word(img, o4 + 4u, live) = ua ^ ui;
    cliff_word(img, o4 + 8u, live) = ua + ui;
    cliff_word(img, o4 + 12u, live) = ua - ui;
  } else if (kMode == kCliffLoad4) {  // both loads before both stores
    const uint32_t s0 = cliff_word(img, o4 - a4), s1 = cliff_word(img, o4 - a4 + 4u);
    cliff_word(img, o4) = s0;
    cliff_word(img, o4 + 4u) = s1;
  }
}

// R trials from start + (r & 1), one after another, over the staged
// advances adv4 (cliff_staged); returns the sum of each trial's final ip
// and, but for kChase, its step count. The image (disjoint from adv4) takes
// the bodies' stores in the TPU's order.
//
// The chain of a step is one shared-memory load and an add: the next step's
// advance is loaded (at the byte offset p + a4) before this step's body
// runs, so the body's compares, stores and loads issue in that load's
// shadow. The loop tests for the end once every kCliffUnroll steps, on the
// position before the group's last step (known before the loads in flight
// return; at the end a group past it is steps that keep ip); steps past the
// end load the staged 0 at the final ip, keep it, count nothing and store
// nothing.
template <int kMode>
SC_HD int32_t cliff_walk(const int32_t* __restrict__ adv4, int32_t n, int32_t start, int32_t R,
                         uint32_t* __restrict__ img) {
  const char* base = reinterpret_cast<const char*>(adv4);
  const int32_t end4 = 4 * n;
  uint32_t acc = 0;
  for (int32_t r = 0; r < R; r++) {
    const int32_t ip0 = start + (r & 1);
    if (ip0 >= n) {
      acc += (uint32_t)ip0;
      continue;
    }
    int32_t p = 4 * ip0;
    int32_t a4 = *reinterpret_cast<const int32_t*>(base + p);
    uint32_t o4 = 0, t = 0;
    bool done = false;
    while (!done) {
#pragma unroll
      for (int j = 0; j < kCliffUnroll; j++) {
        const int32_t q = p + a4;
        const int32_t a4n = *reinterpret_cast<const int32_t*>(base + q);
        if (kMode != kChase) {
          const bool live = p < end4;
          cliff_body<kMode>(img, (uint32_t)p >> 2, o4, (uint32_t)a4 >> 2, (uint32_t)a4, live);
          o4 += (uint32_t)a4;
          t += live ? 1u : 0u;
        }
        if (j == kCliffUnroll - 2) done = q >= end4;
        p = q;
        a4 = a4n;
      }
    }
    acc += ((uint32_t)p >> 2) + t;
  }
  return (int32_t)acc;
}

// --- bitonic (_bitonic_kernel) -----------------------------------------------

constexpr int32_t kSortN = 65536;
constexpr int32_t kBitonicK = 15;  // the one merge pass the TPU runs: j = 32768 ... 1

// The TPU's rule for the element at idx against its partner idx ^ j: keep
// its own key and index, or take the partner's. Equal keys keep their own.
SC_HD bool bitonic_keep(int32_t idx, int32_t j, int32_t key, int32_t partner) {
  const bool up = ((idx >> (kBitonicK + 1)) & 1) == 0;
  const bool is_lo = (idx & j) == 0;
  return up == is_lo ? (key <= partner) : (key >= partner);
}

// The pair (lo, lo | j), lo with bit j clear, whose keys and indices sit at
// ka, kb, va, vb: both sides by the TPU's rule.
SC_HD void bitonic_exchange(int32_t lo, int32_t j, int32_t* ka, int32_t* kb, int32_t* va,
                            int32_t* vb) {
  const int32_t k0 = *ka, k1 = *kb, v0 = *va, v1 = *vb;
  const bool keep0 = bitonic_keep(lo, j, k0, k1), keep1 = bitonic_keep(lo | j, j, k1, k0);
  *ka = keep0 ? k0 : k1;
  *va = keep0 ? v0 : v1;
  *kb = keep1 ? k1 : k0;
  *vb = keep1 ? v1 : v0;
}

// Pair p's lower index at stride j: p with a 0 bit inserted at j.
SC_HD int32_t bitonic_lo(int32_t p, int32_t j) { return ((p & ~(j - 1)) << 1) | (p & (j - 1)); }

}  // namespace hp
