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

// The same record as flat word addresses, all of it known before the image
// is read. Word q of w lies at sw + q, and at sw + q + delta for q >= cut
// (the 3d body's srow 7: delta moves row r0 + 1 to r1; 0 otherwise). The
// stores are one flat run too: lane i of row dr holds rolled[i] =
// f[(i - dl) & 127], where f is the funnel-shifted w, and row dr + 1 goes
// on where row dr ends, so word m of the run (m < lim) is f[m & 127] at
// dw + m. lim is nw, cut to the end of row dr + 1 (or of row dr where the
// 3d body drops the spill); m reaches 128 only when nw does.
struct VcopyPlan {
  int32_t sw, cut, delta, a8, dw, lim;
};

template <bool k3d>
SC_HD VcopyPlan vcopy_plan(int32_t dst, int32_t src, int32_t ln) {
  const VcopyRecord r = vcopy_record<k3d>(dst, src, ln);
  const int32_t room = (r.spill ? 2 * kLanes : kLanes) - r.dl;
  return {src >> 2, kLanes - r.sl, (r.r1 - r.r0 - 1) * kLanes, r.a8, dst >> 2,
          r.nw < room ? r.nw : room};
}

// Bits s .. s + 31 of hi:lo (s < 32): the funnel from the next word. With
// s = 0 it is lo, so phase 0 needs no branch.
SC_HD uint32_t funnel(uint32_t lo, uint32_t hi, int32_t s) {
#ifdef __CUDA_ARCH__
  return __funnelshift_r(lo, hi, (uint32_t)s);
#else
  return (uint32_t)((((uint64_t)hi << 32) | lo) >> (s & 31));
#endif
}

// --- the record loop of vcopy and iso ------------------------------------

// Word i of the record array, through the read-only path on the card.
SC_HD int32_t rec_at(const int32_t* rec, int32_t i) {
#ifdef __CUDA_ARCH__
  return __ldg(rec + i);
#else
  return rec[i];
#endif
}

// Four consecutive words, 16-byte aligned: one 128-bit shared access a lane.
struct alignas(16) Words4 {
  uint32_t w[4];
};

SC_HD Words4 load4(const uint32_t* img, int32_t at) {
#ifdef __CUDA_ARCH__
  const uint4 v = *reinterpret_cast<const uint4*>(img + at);
  return {{v.x, v.y, v.z, v.w}};
#else
  Words4 v;
  for (int k = 0; k < 4; k++) v.w[k] = img[at + k];
  return v;
#endif
}

SC_HD void store4(uint32_t* img, int32_t at, const Words4& v) {
#ifdef __CUDA_ARCH__
  *reinterpret_cast<uint4*>(img + at) = make_uint4(v.w[0], v.w[1], v.w[2], v.w[3]);
#else
  for (int k = 0; k < 4; k++) img[at + k] = v.w[k];
#endif
}

constexpr int32_t kBatch = 32;  // records a batch: one a lane
constexpr int32_t kPlanSlots = 2 * kBatch;  // the plan ring: two batches
// The image, then the plan ring (16 bytes a record), in shared memory.
constexpr int32_t kRecordSmemWords = kImageWords + 4 * kPlanSlots;

// A batch of records: lane l holds the words of record base + l (record
// 0's past the count, which no body sees), loaded by one coalesced access
// an array.
template <class W>
struct RecordBatch {
  sc::LanesOf<W, int32_t> dst, src, len;
  sc::LanesOf<W, bool> live;

  SC_HD void load(const W& w, const int32_t* rec, int32_t base, int32_t count) {
    w.each([&](int l) {
      const int32_t t = base + l;
      live[l] = t < count;
      const int32_t at = t < count ? t : 0;
      dst[l] = rec_at(rec, at);
      src[l] = rec_at(rec, at + kRecHalf);
      len[l] = rec_at(rec, at + 2 * kRecHalf);
    });
  }
};

// The records t in [first, count), in order, through body(plan of t). Lane
// l loads record base + l of a batch two batches ahead and writes its plan
// (Plans::make, 16 bytes) into the ring of plans a batch ahead (seen(batch)
// sees each batch once, then); each record's plan is one broadcast 128-bit
// shared load (Plans::at), two records before its body, and the loop runs
// two records an iteration (both measured best, PERF.md). So nothing of a
// record waits on the image but its own shared loads, and nothing of the
// record array lies on the chain that runs through the image. A batch's
// slots are written after the bodies that read them and read after a
// body's warp sync.
template <class Plans, class W, class Seen, class Body>
SC_HD void record_loop(const W& w, const int32_t* rec, int32_t first, int32_t count,
                       Words4* ring, Seen seen, Body body) {
  if (first >= count) return;
  RecordBatch<W> next;
  next.load(w, rec, first, count);
  Plans::make(w, next, ring);
  seen(next);
  next.load(w, rec, first + kBatch, count);
  Plans::make(w, next, ring + kBatch);
  if (first + kBatch < count) seen(next);
  next.load(w, rec, first + 2 * kBatch, count);
  w.sync();
  int32_t i = 1;  // t - first + 1
  auto p = Plans::at(ring[0]);
  auto pn = Plans::at(ring[1]);
  for (int32_t base = first; base < count; base += kBatch) {
    const int32_t n = count - base < kBatch ? count - base : kBatch;
#pragma unroll 2
    for (int32_t j = 0; j < n; j++) {
      i++;
      const auto pnn = Plans::at(ring[i & (kPlanSlots - 1)]);
      body(p);
      p = pn;
      pn = pnn;
    }
    Plans::make(w, next, ring + ((((i - 1) >> 5) - 1) & 1) * kBatch);
    if (base + 2 * kBatch < count) seen(next);
    next.load(w, rec, base + 3 * kBatch, count);
  }
}

// vcopy's plans: sw, dw, lim and a8 | cut << 8 | delta << 16 (a8 below
// 32, so the funnel's shift is the word itself; delta is 0, 768 or -256).
template <bool k3d, class W>
struct VcopyPlans {
  SC_HD static void make(const W& w, const RecordBatch<W>& b, Words4* slots) {
    w.each([&](int l) {
      const VcopyPlan p = vcopy_plan<k3d>(b.dst[l], b.src[l], b.len[l]);
      slots[l] = {{(uint32_t)p.sw, (uint32_t)p.dw, (uint32_t)p.lim,
                   (uint32_t)p.a8 | (uint32_t)p.cut << 8 | (uint32_t)p.delta << 16}};
    });
  }
  SC_HD static VcopyPlan at(const Words4& x) {
    const int32_t a = (int32_t)x.w[3];
    return {(int32_t)x.w[0], k3d ? (a >> 8) & 0xFF : kLanes, k3d ? a >> 16 : 0, a,
            (int32_t)x.w[1], (int32_t)x.w[2]};
  }
};

// One record of vcopy's body (iso full: kParity false): lane l takes words q
// = l + 32 k of w from s = img + sw, w[q] and w[(q + 1) & 127] (lane 127
// takes lane 0, as the TPU's roll does; consecutive words across the lanes,
// no bank conflict; in 3d from s3 = s + delta past cut, a select of the
// base), funnels them, the warp meets (a destination may overlap its own
// source), then stores word q at d = img + dw, d[q], and where the run goes
// past 128 words at d[128 + q], each store predicated on its word lying below
// lim: no branch (a store aimed at a dummy word instead measured slower,
// PERF.md). The stored words are distinct, so their order within a record
// does not show; the warp meets again before the next record's loads.
template <bool k3d, bool kParity, class W>
SC_HD void vcopy_body(const W& w, uint32_t* img, const VcopyPlan& p,
                      sc::LanesOf<W, uint32_t>& acc) {
  sc::LanesOf<W, Words4> v;
  const uint32_t* s = img + p.sw;
  const uint32_t* s3 = s + p.delta;  // 3d: the words past cut
  w.each([&](int l) {
#pragma unroll
    for (int k = 0; k < 4; k++) {
      const int32_t q = l + 32 * k, q1 = k < 3 ? q + 1 : (q + 1) & (kLanes - 1);
      const uint32_t lo = (k3d && q >= p.cut ? s3 : s)[q];
      const uint32_t hi = (k3d && q1 >= p.cut ? s3 : s)[q1];
      const uint32_t x = funnel(lo, hi, p.a8);
      v[l].w[k] = x;
      if (kParity) acc[l] += x & 1u;
    }
  });
  w.sync();
  uint32_t* d = img + p.dw;
  w.each([&](int l) {
#pragma unroll
    for (int k = 0; k < 4; k++) {
      const int32_t q = l + 32 * k;
      if (q < p.lim) d[q] = v[l].w[k];
      if (q + kLanes < p.lim) d[q + kLanes] = v[l].w[k];
    }
  });
  w.sync();
}

// vcopy_kernel's work: every record in order; acc gets the low bits of the
// rolled words.
template <bool k3d, class W>
SC_HD void vcopy_run(const W& w, const int32_t* rec, uint32_t* img,
                     sc::LanesOf<W, uint32_t>& acc) {
  record_loop<VcopyPlans<k3d, W>>(
      w, rec, 0, rec_at(rec, kCountAt), reinterpret_cast<Words4*>(img + kImageWords),
      [](const RecordBatch<W>&) {},
      [&](const VcopyPlan& p) { vcopy_body<k3d, true>(w, img, p, acc); });
}

// --- coissue (_coissue_kernel) ---------------------------------------------

// The scalar chain's 64-word scratch in shared memory, word i at byte 8 * i
// (element 2 * i of kScratchSlots words): a load's byte offset (x >> 3 & 63)
// * 8 is then x & 0x1F8, one AND, where word i at byte 4 * i takes a shift
// too.
constexpr int kScratchWords = 64;
constexpr int kScratchSlots = 2 * kScratchWords;
constexpr uint32_t kScratchBytes = 8u * (kScratchWords - 1);  // 0x1F8: a word's offset, masked

SC_HD uint32_t& scratch_word(uint32_t* scratch, uint32_t at) {
  return *reinterpret_cast<uint32_t*>(reinterpret_cast<char*>(scratch) + at);
}

// The scratch as interpret mode leaves it: 0x80000000, seed at word 0.
SC_HD void scratch_init(uint32_t* scratch, int32_t seed) {
  for (int i = 0; i < kScratchWords; i++) scratch[2 * i] = kFill;
  scratch[0] = (uint32_t)seed;
}

// (a ^ b) & keep: on the card one LOP3, written in PTX so that it stays one
// instruction on the chain.
SC_HD uint32_t xor_and(uint32_t a, uint32_t b, uint32_t keep) {
#ifdef __CUDA_ARCH__
  uint32_t r;
  asm("lop3.b32 %0, %1, %2, %3, 0x28;" : "=r"(r) : "r"(a), "r"(b), "r"(keep));
  return r;
#else
  return (a ^ b) & keep;
#endif
}

// Iteration t of the scalar chain, the TPU's six rounds of x = (x * 5 + 1) &
// 0x7FFFFFFF, scratch[(t + x) & 63] = x, x ^= scratch[(x >> 3) & 63] (24
// dependent operations); returns x, which the TPU adds to its sum.
//
// A round loads before it stores, so that the load waits on nothing but y =
// x * 5 + 1 (the mask leaves bits 3-8 alone, and the store's address and
// value are made in the load's shadow): where the two name one word, the
// load would have read the stored x, and x ^ x = 0 takes its place. The
// chain of a round is then a multiply-add, an AND, the load and one LOP3.
// Each round's store precedes the next round's load, and the last round's
// the next iteration's first load.
SC_HD uint32_t coissue_step(uint32_t* scratch, uint32_t t) {
  uint32_t x = scratch_word(scratch, (t << 3) & kScratchBytes);
#pragma unroll
  for (int j = 0; j < 6; j++) {
    const uint32_t y = x * 5u + 1u;
    const uint32_t from = y & kScratchBytes, to = ((t + y) << 3) & kScratchBytes;
    const uint32_t z = scratch_word(scratch, from);
    x = y & 0x7FFFFFFFu;
    scratch_word(scratch, to) = x;
    x = xor_and(x, z, from == to ? 0u : 0xFFFFFFFFu);
  }
  return x;
}

// One vector update of a tile element: v * 3 + roll(v, s)[i], the rolled
// value taken by the caller from element (i - s) & 127 of the same row.
SC_HD uint32_t coissue_update(uint32_t v, uint32_t rolled) { return v * 3u + rolled; }

// The tile's row on one warp, kQuad elements a lane: lane l holds elements
// 4l .. 4l + 3. roll(v, s)[p] = v[(p - s) & 127] takes, for s <= 4, element
// j >= s from the lane's own word j - s and j < s from word j - s + 4 of
// lane l - 1; for 4 < s <= 8 (q = s - 4), j >= q from word j - q of lane
// l - 1 and j < q from word j - q + 4 of lane l - 2 (lanes wrap mod 32).
// An update of shift s is min(s, 4) shuffles from fixed lanes and no
// select: 26 an iteration at nvec 8 (elements 32 apart a lane took 4
// shuffles and 4 selects an update).
constexpr int kQuad = 4;
constexpr int kTileRows = 8;
constexpr int kCoissueVec = -1;  // the coissue launcher's nvec for the vector stream alone
constexpr int kVecUpdates = 8;   // its updates an iteration

// One iteration of a row: v <- v * 3 + roll(v, s) for s = 1 .. kNvec; left1
// and left2 hold each lane's lanes l - 1 and l - 2.
template <int kNvec, class W>
SC_HD void coissue_row_iteration(const W& w, sc::LanesOf<W, uint32_t> (&v)[kQuad],
                                 const sc::LanesOf<W, int32_t>& left1,
                                 const sc::LanesOf<W, int32_t>& left2) {
  static_assert(kNvec <= 2 * kQuad, "a shift reaches at most two lanes back");
#pragma unroll
  for (int s = 1; s <= kNvec; s++) {
    const int q = s > kQuad ? s - kQuad : s;
    sc::LanesOf<W, uint32_t> r[kQuad];
#pragma unroll
    for (int j = 0; j < kQuad; j++) {
      if (s <= kQuad) {
        r[j] = j >= s ? v[j - s] : w.gather(v[j - s + kQuad], left1);
      } else {
        r[j] = j >= q ? w.gather(v[j - q], left1) : w.gather(v[j - q + kQuad], left2);
      }
    }
    w.each([&](int l) {
#pragma unroll
      for (int j = 0; j < kQuad; j++) v[j][l] = coissue_update(v[j][l], r[j][l]);
    });
  }
}

// A row's iters iterations of kNvec updates from the row's 128 words and
// back; returns each lane's count of odd words.
template <int kNvec, class W>
SC_HD sc::LanesOf<W, uint32_t> coissue_row(const W& w, const int32_t* row, int32_t iters,
                                           int32_t* row_out) {
  static_assert(W::kLanes * kQuad == kLanes, "a row is 32 lanes of kQuad words");
  sc::LanesOf<W, uint32_t> v[kQuad], par;
  sc::LanesOf<W, int32_t> left1, left2;
  w.each([&](int l) {
#pragma unroll
    for (int j = 0; j < kQuad; j++) v[j][l] = (uint32_t)row[kQuad * l + j];
    left1[l] = (l - 1) & (W::kLanes - 1);
    left2[l] = (l - 2) & (W::kLanes - 1);
  });
  for (int32_t t = 0; t < (kNvec ? iters : 0); t++) {
    coissue_row_iteration<kNvec>(w, v, left1, left2);
  }
  w.each([&](int l) {
    par[l] = 0;
#pragma unroll
    for (int j = 0; j < kQuad; j++) {
      row_out[kQuad * l + j] = (int32_t)v[j][l];
      par[l] += v[j][l] & 1u;
    }
  });
  return par;
}

// --- iso (_iso_kernel) -------------------------------------------------------

// One part of vcopy's body alone per mode, over the records 20 times (pass r
// from record r & 1). Every mode but scalar adds dst to the sum; full is
// vcopy's 2d body.
enum IsoMode { kIsoScalar = 0, kIsoDynload, kIsoDynload8, kIsoStatroll, kIsoDynroll, kIsoFull };
constexpr int32_t kIsoPasses = 20;

// scalar: the record's words through an 8-step chain, no image work.
SC_HD uint32_t iso_scalar(int32_t dst, int32_t src, int32_t ln) {
  uint32_t x = ((uint32_t)dst * 5u + (uint32_t)src) ^ (uint32_t)ln;
#pragma unroll
  for (int i = 0; i < 8; i++) x = (x * 5u + 1u) & 0x7FFFFFFFu;
  return x;
}

// scalar's records are independent and its sum wraps, so the lanes take
// records: lane `lane` sums iso_scalar over t = first + lane + 32 i below
// count. Its loads run kIsoScalarSlots groups of kIsoScalarGroup records
// ahead of the chains (a ring of slots in registers: a slot's group is
// summed, then the slot loads the group kIsoScalarSlots groups on), and a
// group's chains are independent.
constexpr int kIsoScalarGroup = 8;
constexpr int kIsoScalarSlots = 4;

SC_HD uint32_t iso_scalar_lane(const int32_t* rec, int32_t first, int32_t count, int lane) {
  constexpr int G = kIsoScalarGroup, S = kIsoScalarSlots;
  constexpr int32_t kStep = 32 * G;  // records a group
  int32_t d[S][G], s[S][G], n[S][G];
  auto load = [&](int slot, int32_t base) {
#pragma unroll
    for (int g = 0; g < G; g++) {
      const int32_t t = base + lane + 32 * g, at = t < count ? t : 0;
      d[slot][g] = rec_at(rec, at);
      s[slot][g] = rec_at(rec, at + kRecHalf);
      n[slot][g] = rec_at(rec, at + 2 * kRecHalf);
    }
  };
  uint32_t acc = 0;
#pragma unroll
  for (int slot = 0; slot < S; slot++) load(slot, first + slot * kStep);
  for (int32_t base = first; base < count; base += S * kStep) {
#pragma unroll
    for (int slot = 0; slot < S; slot++) {
      const int32_t at = base + slot * kStep;
#pragma unroll
      for (int g = 0; g < G; g++) {
        const uint32_t x = iso_scalar(d[slot][g], s[slot][g], n[slot][g]);
        acc += at + lane + 32 * g < count ? x : 0u;
      }
      load(slot, at + S * kStep);
    }
  }
  return acc;
}

// The row modes: rows [sr, sr + rows) stored at [dr, dr + rows), each row
// rolled by shift lanes (pltpu.roll: roll(v, s)[p] = v[(p - s) & 127]).
// dynload8 moves the 8 rows of the aligned group; statroll rolls by 5,
// dynroll by (128 - sl) & 127, which brings lane sl to lane 0. A record's
// plan: its first source and destination words, and the roll.
struct IsoPlan {
  int32_t sbase, dbase, shift;
};

template <int kMode>
SC_HD IsoPlan iso_plan(int32_t dst, int32_t src) {
  const int32_t sw = src >> 2, rows = kMode == kIsoDynload8 ? 120 : 127;
  return {((sw >> 7) & rows) * kLanes, ((dst >> 9) & rows) * kLanes,
          kMode == kIsoStatroll ? 5 : (kMode == kIsoDynroll ? (128 - (sw & 127)) & 127 : 0)};
}

template <int kMode, class W>
struct IsoPlans {
  SC_HD static void make(const W& w, const RecordBatch<W>& b, Words4* slots) {
    w.each([&](int l) {
      const IsoPlan p = iso_plan<kMode>(b.dst[l], b.src[l]);
      slots[l] = {{(uint32_t)p.sbase, (uint32_t)p.dbase, (uint32_t)p.shift, 0u}};
    });
  }
  SC_HD static IsoPlan at(const Words4& x) {  // statroll's shift is static
    return {(int32_t)x.w[0], (int32_t)x.w[1],
            kMode == kIsoDynroll ? (int32_t)x.w[2] : (kMode == kIsoStatroll ? 5 : 0)};
  }
};

// One record of a row mode: the loads, the warp meets, the stores, the
// warp meets. dynload and dynload8 move whole rows, lane l words 4 l .. 4 l
// + 3 of each, one 128-bit load and store a row; the rolls take word
// (p - shift) & 127 of the row for word p = l + 32 k (consecutive words
// across the lanes, no bank conflict).
template <int kMode, class W>
SC_HD void iso_body(const W& w, uint32_t* img, const IsoPlan& p) {
  if (kMode == kIsoDynload || kMode == kIsoDynload8) {
    constexpr int kRows = kMode == kIsoDynload8 ? 8 : 1;
    sc::LanesOf<W, Words4> v[kRows];
    w.each([&](int l) {
#pragma unroll
      for (int r = 0; r < kRows; r++) v[r][l] = load4(img, p.sbase + r * kLanes + 4 * l);
    });
    w.sync();
    w.each([&](int l) {
#pragma unroll
      for (int r = 0; r < kRows; r++) store4(img, p.dbase + r * kLanes + 4 * l, v[r][l]);
    });
  } else {
    sc::LanesOf<W, Words4> v;
    w.each([&](int l) {
#pragma unroll
      for (int k = 0; k < 4; k++) v[l].w[k] = img[p.sbase + ((l + 32 * k - p.shift) & 127)];
    });
    w.sync();
    w.each([&](int l) {
#pragma unroll
      for (int k = 0; k < 4; k++) img[p.dbase + l + 32 * k] = v[l].w[k];
    });
  }
  w.sync();
}

// iso_kernel's work: the 20 passes; acc gets each mode's sum (the caller
// adds row 0's odd words).
template <int kMode, class W>
SC_HD void iso_run(const W& w, const int32_t* rec, uint32_t* img, sc::LanesOf<W, uint32_t>& acc) {
  const int32_t count = rec_at(rec, kCountAt);
  Words4* ring = reinterpret_cast<Words4*>(img + kImageWords);
  auto seen = [&](const RecordBatch<W>& b) {
    w.each([&](int l) { acc[l] += b.live[l] ? (uint32_t)b.dst[l] : 0u; });
  };
  for (int32_t pass = 0; pass < kIsoPasses; pass++) {
    const int32_t first = pass & 1;
    if (kMode == kIsoScalar) {
      w.each([&](int l) { acc[l] += iso_scalar_lane(rec, first, count, l); });
    } else if (kMode == kIsoFull) {
      record_loop<VcopyPlans<false, W>>(w, rec, first, count, ring, seen, [&](const VcopyPlan& p) {
        vcopy_body<false, false>(w, img, p, acc);
      });
    } else {
      record_loop<IsoPlans<kMode, W>>(w, rec, first, count, ring, seen,
                                      [&](const IsoPlan& p) { iso_body<kMode>(w, img, p); });
    }
  }
}

// --- bprobe (_bprobe_kernel) and its floor ----------------------------------

constexpr int32_t kBprobeIters = 524288;
constexpr int kBprobeBlock = 64;  // iterations a block: the scratch's words
constexpr int kBprobeFloor = -1;  // the launcher's nwhen for the floor

// The 4-step mix of one iteration. Shifts are arithmetic on int32 (a word
// never written reads 0x80000000, so x may start negative); adds wrap.
SC_HD int32_t bprobe_mix(int32_t x) {
#pragma unroll
  for (int i = 0; i < 4; i++) x = (int32_t)(((uint32_t)x + (uint32_t)(x >> 3)) & 0x7FFFFFFFu);
  return x;
}

// Iterations t0 .. t0 + 63 over the scratch s (t0 a multiple of 64), each
// unrolled, so that every index (t + k) & 63 is known when the body is
// compiled and s lives in 64 registers. Iteration t mixes s[t & 63] ^ t,
// then makes kNwhen stores under a data-dependent condition (pl.when) or,
// with kNwhen 0, three select-stores that write the old word back where the
// bit is clear: either way a select of a register, no branch and no memory.
// Returns the sum of the x, which the TPU adds to its sum, in four partial
// sums (at kNwhen 1 the 64 iterations are independent, so nothing chains
// them but a sum).
template <int kNwhen>
SC_HD uint32_t bprobe_block(uint32_t (&s)[kBprobeBlock], uint32_t t0) {
  constexpr int kStores = kNwhen ? kNwhen : 3;
  uint32_t part[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < kBprobeBlock; j++) {
    const int32_t x = bprobe_mix((int32_t)(s[j] ^ (t0 + (uint32_t)j)));
#pragma unroll
    for (int k = 0; k < kStores; k++) {
      uint32_t& w = s[(j + k) & (kBprobeBlock - 1)];
      w = ((x >> k) & 1) ? (uint32_t)x + (uint32_t)k : w;
    }
    part[j & 3] += (uint32_t)x;
  }
  return (part[0] + part[1]) + (part[2] + part[3]);
}

// bprobe_kernel's work: the scratch as interpret mode leaves it
// (0x80000000, seed at word 0), then 8,192 blocks; returns the sum and
// leaves the scratch in s.
template <int kNwhen>
SC_HD uint32_t bprobe_run(uint32_t (&s)[kBprobeBlock], int32_t seed) {
#pragma unroll
  for (int i = 0; i < kBprobeBlock; i++) s[i] = i ? kFill : (uint32_t)seed;
  uint32_t acc = 0;
#pragma unroll 1
  for (uint32_t t0 = 0; t0 < (uint32_t)kBprobeIters; t0 += kBprobeBlock) {
    acc += bprobe_block<kNwhen>(s, t0);
  }
  return acc;
}

// The floor of bprobe's chain: its arithmetic with no scratch, x_t =
// mix(x_{t-1} ^ t) from x_{-1} = seed over the same 524,288 iterations and
// blocks of 64; returns the sum of the x. A yardstick, not a TPU kernel.
SC_HD uint32_t bprobe_floor(int32_t seed) {
  int32_t x = seed;
  uint32_t part[4] = {0u, 0u, 0u, 0u};
#pragma unroll 1
  for (uint32_t t0 = 0; t0 < (uint32_t)kBprobeIters; t0 += kBprobeBlock) {
#pragma unroll
    for (int j = 0; j < kBprobeBlock; j++) {
      x = bprobe_mix((int32_t)((uint32_t)x ^ (t0 + (uint32_t)j)));
      part[j & 3] += (uint32_t)x;
    }
  }
  return (part[0] + part[1]) + (part[2] + part[3]);
}

// --- the walk: cliff (_cliff_kernel), chain and chainrec (_chain_kernel) ------

// The tag-boundary walk ip += adv[ip], R trials, with a body per step.
// cliff's modes write a 16,384-word image, which persists across the
// trials; kChase is the walk with no body: chain's function, and the
// latency floor the cliff modes are held to (the chase); kChainRec is
// chainrec's body, which stores (ip << 8) | (a & 0xFF) at record t & 8191
// and the running op at (t & 8191) + 8192 of a 16,384-word buffer (the TPU
// stores record t at t and t + 8192, past its buffer after 8,192 steps;
// nothing reads the buffer, so the checksum is the TPU's either way).
enum CliffMode {
  kCliffWhen1 = 0, kCliffWhen2, kCliffFori, kCliffStore4, kCliffLoad4, kChase, kChainRec
};
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

// *p = v where `on`, p in shared memory: on the card one predicated
// st.shared, which ptxas keeps predicated (from C++ it put a branch around
// chainrec's two stores, and the next step's load waited for the branch).
SC_HD void store_if(uint32_t* p, uint32_t v, bool on) {
#ifdef __CUDA_ARCH__
  const uint32_t at = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile("{\n\t.reg .pred q;\n\tsetp.ne.u32 q, %2, 0;\n\t@q st.shared.u32 [%0], %1;\n\t}"
               ::"r"(at), "r"(v), "r"((uint32_t)on)
               : "memory");
#else
  if (on) *p = v;
#endif
}

// The image word at byte offset x (masked to the image) where `on`, else
// the dummy word past the image: a select, no branch.
SC_HD uint32_t& cliff_word(uint32_t* img, uint32_t x, bool on = true) {
  const uint32_t at = on ? x & kCliffBytes : 4u * kImageWords;
  return *reinterpret_cast<uint32_t*>(reinterpret_cast<char*>(img) + at);
}

// One step's body at step t, ip, op (as the byte offset o4 = 4 * op) and
// advance a (unscaled; a4 = 4 * a); `live` is false for a step past the end
// (a is 0 there). No branch: a store the body does not make goes to the
// dummy word (when1, when2, store4 past the end), except fori's, whose 7
// stores, unrolled over a & 7 with the TPU's carry, are each predicated on
// its index, and chainrec's two, predicated on `live`. load4 past the end
// stores back the two words it loaded.
template <int kMode>
SC_HD void cliff_body(uint32_t* __restrict__ img, uint32_t t, uint32_t ui, uint32_t o4,
                      uint32_t ua, uint32_t a4, bool live) {
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
  } else if (kMode == kChainRec) {
    uint32_t* rec = img + (t & (uint32_t)(kRecHalf - 1));
    store_if(rec, ui << 8 | (ua & 0xFFu), live);
    store_if(rec + kRecHalf, o4 >> 2, live);
  }
}

// R trials from start + (r & 1), one after another, over the staged
// advances adv4 (cliff_staged); returns the sum of each trial's final ip
// and, but for kChase, its step count. The image or record buffer
// (disjoint from adv4) takes the bodies' stores in the TPU's order.
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
          cliff_body<kMode>(img, t, (uint32_t)p >> 2, o4, (uint32_t)a4 >> 2, (uint32_t)a4, live);
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

// One merge pass covers kSortN = 2^(kBitonicK + 1) elements, so every index
// has its direction bit clear and runs up: of a pair (lo, lo | j), lo with
// bit j clear, bitonic_keep(lo, j, k0, k1) is k0 <= k1 and the upper side's
// bitonic_keep(lo | j, j, k1, k0) is k1 >= k0, the same. The pair's keys
// become their minimum and maximum, and its indices swap when the lower key
// is the larger (equal keys keep their own key and index).
static_assert(kSortN == 1 << (kBitonicK + 1), "one merge pass: every index runs up");

SC_HD void bitonic_exchange(int32_t* ka, int32_t* kb, int32_t* va, int32_t* vb) {
  const int32_t k0 = *ka, k1 = *kb, v0 = *va, v1 = *vb;
  const bool swap = k0 > k1;
  *ka = swap ? k1 : k0;
  *kb = swap ? k0 : k1;
  *va = swap ? v1 : v0;
  *vb = swap ? v0 : v1;
}

// The cluster kernel's layout (bitonic_probe.cu): kSortCtas CTAs of
// kSortThreads threads, 8 elements a thread, so that the whole array and its
// indices live on chip. Before the transpose CTA c holds the elements whose
// bits 10-12 are c (8 runs of 1,024), so j = 32768, 16384 and 8192 are its
// own; after it CTA c holds the contiguous tile c << 13, so j = 4096 ... 1
// are.
constexpr int32_t kSortCtas = 8;
constexpr int32_t kSortTile = kSortN / kSortCtas;  // 8,192 elements a CTA
constexpr int32_t kSortThreads = kSortTile / 8;    // 1,024
constexpr int32_t kSortRun = 1024;                 // the runs before the transpose
// The rounds of three stages on a tile in registers (bitonic_tile_regs) at
// shifts kSortTopShift, - 3, - 6: j = 4096 ... 1024, 512 ... 128, 64 ... 16;
// j = 8 is the warp's exchange.
constexpr int32_t kSortTopShift = 10;

// A thread's 8 keys and their indices.
struct Sort8 {
  int32_t k[8], v[8];
};

// The three stages between a thread's 8 elements, element r at global
// index g + r * step (step a power of 2 above g's bits): j = 4 step, 2 step,
// step, in registers.
SC_HD void bitonic_regs(Sort8& s) {
#pragma unroll
  for (int rb = 4; rb >= 1; rb >>= 1) {
#pragma unroll
    for (int r = 0; r < 8; r++) {
      if (!(r & rb)) bitonic_exchange(&s.k[r], &s.k[r | rb], &s.v[r], &s.v[r | rb]);
    }
  }
}

// n consecutive words at p (16-byte aligned, n a multiple of 4), as 16-byte
// moves on the card.
template <int n>
SC_HD void load_words(const int32_t* p, int32_t* x) {
#ifdef __CUDA_ARCH__
#pragma unroll
  for (int i = 0; i < n; i += 4) {
    const int4 a = reinterpret_cast<const int4*>(p)[i / 4];
    x[i] = a.x, x[i + 1] = a.y, x[i + 2] = a.z, x[i + 3] = a.w;
  }
#else
  memcpy(x, p, 4 * n);
#endif
}

template <int n>
SC_HD void store_words(int32_t* p, const int32_t* x) {
#ifdef __CUDA_ARCH__
#pragma unroll
  for (int i = 0; i < n; i += 4) {
    reinterpret_cast<int4*>(p)[i / 4] = make_int4(x[i], x[i + 1], x[i + 2], x[i + 3]);
  }
#else
  memcpy(p, x, 4 * n);
#endif
}

// Where thread t keeps element r in a round at shift sh: the elements
// ((t >> sh) << (sh + 3)) | (r << sh) | (t & (2^sh - 1)), r = 0..7, so that
// j = 4, 2, 1 times 2^sh are between its own elements; at sh = 10 and 7 a
// warp's accesses are 32 consecutive words, at sh = 4 two runs of 16.
SC_HD int32_t bitonic_slot(int32_t t, int32_t r, int32_t sh) {
  return ((t >> sh) << (sh + 3)) | (r << sh) | (t & ((1 << sh) - 1));
}

// Before the transpose, warp wi of CTA c: thread t = 32 wi + l takes
// element r = 0..7 of global index (r << 13) | (c << 10) | t from ks (the
// CTA's runs, ks[(r << 10) | i] = x[(r << 13) | (c << 10) | i]) with that
// index, runs j = 32768, 16384, 8192 in registers and puts the keys back
// into ks and the indices into vs.
template <class W>
SC_HD void bitonic_top(const W& w, int32_t c, int32_t wi, int32_t* ks, int32_t* vs) {
  w.each([&](int l) {
    const int32_t t = 32 * wi + l, g = (c << 10) | t;
    Sort8 s;
#pragma unroll
    for (int r = 0; r < 8; r++) {
      s.k[r] = ks[bitonic_slot(t, r, 10)];
      s.v[r] = (r << 13) | g;
    }
    bitonic_regs(s);
#pragma unroll
    for (int r = 0; r < 8; r++) {
      ks[bitonic_slot(t, r, 10)] = s.k[r];
      vs[bitonic_slot(t, r, 10)] = s.v[r];
    }
  });
}

// The transpose from CTA c's runs (ks, vs after bitonic_top): run r goes to
// CTA r, at c << 10 of its tile, in 16-byte pieces, thread t moving pieces
// t and t + 1,024 of the 2,048 a CTA sends of each; store4(cta, i, keys,
// indices) stores 4 keys and 4 indices at i.
template <class W, class Store4>
SC_HD void bitonic_send(const W& w, int32_t c, int32_t wi, const int32_t* ks, const int32_t* vs,
                        Store4 store4) {
  w.each([&](int l) {
#pragma unroll
    for (int h = 0; h < 2; h++) {
      const int32_t piece = 32 * wi + l + h * kSortThreads, r = piece >> 8;
      const int32_t at = 4 * (piece & 255);
      int32_t k[4], v[4];
      load_words<4>(ks + (r << 10) + at, k);
      load_words<4>(vs + (r << 10) + at, v);
      store4(r, (c << 10) + at, k, v);
    }
  });
}

// A round of three stages on CTA c's tile (ks, vs) in registers: thread t
// takes its elements at shift sh (bitonic_slot) and runs j = 4, 2, 1 times
// 2^sh.
template <class W>
SC_HD void bitonic_tile_regs(const W& w, int32_t c, int32_t wi, int32_t* ks, int32_t* vs,
                             int32_t sh) {
  w.each([&](int l) {
    const int32_t t = 32 * wi + l;
    Sort8 s;
#pragma unroll
    for (int r = 0; r < 8; r++) {
      s.k[r] = ks[bitonic_slot(t, r, sh)];
      s.v[r] = vs[bitonic_slot(t, r, sh)];
    }
    bitonic_regs(s);
#pragma unroll
    for (int r = 0; r < 8; r++) {
      ks[bitonic_slot(t, r, sh)] = s.k[r];
      vs[bitonic_slot(t, r, sh)] = s.v[r];
    }
  });
}

// The last four stages on CTA c's tile: thread t takes the 8 consecutive
// elements from 8 t; j = 8 pairs it with lane l ^ 1 (the warp's exchange,
// each lane keeping its side by the TPU's rule), j = 4, 2, 1 run in
// registers; the keys and indices go out as 16-byte stores.
template <class W>
SC_HD void bitonic_tile_last(const W& w, int32_t c, int32_t wi, const int32_t* ks,
                             const int32_t* vs, int32_t* keys, int32_t* vals) {
  sc::LanesOf<W, Sort8> s;
  sc::LanesOf<W, int32_t> src;
  w.each([&](int l) {
    const int32_t i = 8 * (32 * wi + l);
    load_words<8>(ks + i, s[l].k);
    load_words<8>(vs + i, s[l].v);
    src[l] = l ^ 1;
  });
#pragma unroll
  for (int r = 0; r < 8; r++) {
    sc::LanesOf<W, int32_t> k, v;
    w.each([&](int l) {
      k[l] = s[l].k[r];
      v[l] = s[l].v[r];
    });
    const sc::LanesOf<W, int32_t> pk = w.gather(k, src), pv = w.gather(v, src);
    w.each([&](int l) {
      const int32_t g = (c << 13) | (8 * (32 * wi + l) + r);
      const bool keep = bitonic_keep(g, 8, k[l], pk[l]);
      s[l].k[r] = keep ? k[l] : pk[l];
      s[l].v[r] = keep ? v[l] : pv[l];
    });
  }
  w.each([&](int l) {
    const int32_t i = 8 * (32 * wi + l);
    bitonic_regs(s[l]);
    store_words<8>(keys + (c << 13) + i, s[l].k);
    store_words<8>(vals + (c << 13) + i, s[l].v);
  });
}

}  // namespace hp
