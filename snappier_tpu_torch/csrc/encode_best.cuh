// The level="best" encode of one fragment (K4's row) as a block's phases:
// csrc/encode_best.cu runs it as one block a row; a host build runs the
// same phases over plain arrays, a phase at a time, to hold them to the JAX
// kernel and the plain version (ops/cuda/scalar_codec.py::encode_best_plain).
//
// The walk it computes is scalar_codec.py's exact_cands branch: from ip = 1,
// a position whose candidate lies in [0, ip) and whose first 4 bytes equal
// the candidate's is a hit, which emits the literal before it and a copy of
// its full match length and resets the miss step; a miss steps
// 1 + (skip >> 7) and adds 1 to skip. The candidates are fixed before the
// walk, so whether a position is a hit, and its match length, do not
// depend on the path the walk takes. The schedule works them out for every
// position at once and walks over them in shared memory:
//
//  1. stage: the row's bytes into shared memory, zero at and past its
//     length (the walks' windows read bytes past it as zero).
//  2. hits: each warp takes 32 positions a step, a lane a position: its
//     candidate from device memory, the 4-byte compare, and a ballot for the
//     hit bitmask's word. A hit whose candidate continues the one before
//     (a run of one match) takes its length from the run's head, so only
//     heads extend, up to kCap (a word's few heads by the whole warp, many
//     each on its lane). A length of kCap or more is stored as kCapped and
//     finished only where a walk takes it, so rows that match far ahead
//     (long runs) cost O(n), not O(n^2).
//  3. walk: the lanes of warp 0 each walk one of kSegs segments, from its
//     start with skip at its base, over the bitmask (a find-first-set a
//     probe group) and the lengths: a copy is a bit in the take bitmask.
//     The warp finishes the capped lengths the walkers reach, together, up
//     to each segment's end; a copy that reaches past it ends its walker,
//     its length pending.
//  4. stitch: warp 0 follows the true chain from segment 0's exit across
//     the segments. Where it enters segment k, it walks on until its next
//     hit is one that walker k took: from there the two walks are one, so
//     walker k's copies before that hit are cleared and the chain's set. A
//     segment with no hit is crossed in one step of arithmetic. Capped
//     lengths on the chain are finished by the warp, 256 bytes a step.
//  5. emit: each thread takes a run of the take bitmask's words; a max-scan
//     of the copies' ends gives each run the end of the copy before it, a
//     sum-scan of the runs' tag bytes its offset in the body, and the
//     threads write the literal and copy tags as sc::emit_literal and
//     sc::emit_copy do. Literals of kLongLiteral bytes or more are copied
//     by the whole block after.
//
// The schedule is written once (run_row) over a runner that runs a phase
// on every thread (threads), every warp (warps) or warp 0 (warp0), with a
// warp policy (sc::CudaWarp on the card; a warp of array lanes in the host
// build), and orders the phases (sync). A thread's registers between
// phases are its ThreadState.
#pragma once

#include <stdint.h>

#include "scalar_codec.cuh"

namespace eb {

constexpr int32_t kSegs = 32;          // walkers: the lanes of warp 0
constexpr int32_t kCap = 256;          // the parallel extension's cap
constexpr int32_t kWarpHeads = 2;      // a word's heads the warp extends one by one
constexpr uint16_t kCapped = 1;        // lens: a hit of length kCap or more (no hit is shorter than 4)
constexpr int32_t kMaxThreads = 1024;  // threads a block, for the widest rows
constexpr int32_t kLongLiteral = 128;  // a literal the block copies together

// misc words
constexpr int32_t kSegIp = 0;        // [kSegs] each walker's exit: the first position past its segment
constexpr int32_t kSegSkip = 32;     // [kSegs] and skip there
constexpr int32_t kSegPend = 64;     // [kSegs] or its last copy, whose length is pending (else -1),
constexpr int32_t kSegC = 96;        // [kSegs] that copy's candidate
constexpr int32_t kSegKnown = 128;   // [kSegs] and the bytes known equal
constexpr int32_t kPartMax = 160;    // [32] per warp: the last copy end, then the one before the warp
constexpr int32_t kPartSum = 192;    // [32] per warp: the tag bytes, then those before the warp
constexpr int32_t kLastEnd = 224;    // the end of the chain's last copy
constexpr int32_t kTotal = 225;      // the tag bytes up to it
constexpr int32_t kLongCount = 226;  // literals in the long-literal list
constexpr int32_t kFinished = 227;   // capped lengths the walks extended
constexpr int32_t kRewalked = 228;   // copies the stitch walked again
constexpr int32_t kMiscWords = 232;

// Shared memory for rows of width F: the row's words (F bytes and 32 more),
// the match lengths (uint16 a position), the hit and take bitmasks and the
// misc words, in bytes from the start.
struct Layout {
  int32_t threads;  // a multiple of 32: 64 positions a thread, at most kMaxThreads
  int32_t words;    // bitmask words: 32 positions each
  int32_t row_words;
  uint32_t lens_off, hit_off, take_off, misc_off, bytes;
};

SC_HD uint32_t align16(uint32_t x) { return (x + 15u) & ~15u; }

SC_HD Layout layout_for(int32_t F) {
  Layout l;
  const int32_t t = ((F + 63) / 64 + 31) & ~31;
  l.threads = t < 32 ? 32 : (t > kMaxThreads ? kMaxThreads : t);
  l.words = (F + 31) / 32;
  l.row_words = (F + 3) / 4 + 8;
  l.lens_off = align16(4u * (uint32_t)l.row_words);
  l.hit_off = l.lens_off + align16(2u * (uint32_t)F);
  l.take_off = l.hit_off + align16(4u * (uint32_t)l.words);
  l.misc_off = l.take_off + align16(4u * (uint32_t)l.words);
  l.bytes = l.misc_off + 4u * kMiscWords;
  return l;
}

struct Smem {
  uint32_t* row;   // the row's bytes, little-endian words, zero at and past n
  uint16_t* lens;  // at a hit: its match length, or kCapped
  uint32_t* hit;   // bit p: position p is a hit; after the stitch, the long-literal list
  uint32_t* take;  // bit p: a copy starts at p
  int32_t* misc;
};

SC_HD Smem smem_at(unsigned char* base, const Layout& l) {
  return {(uint32_t*)base, (uint16_t*)(base + l.lens_off), (uint32_t*)(base + l.hit_off),
          (uint32_t*)(base + l.take_off), (int32_t*)(base + l.misc_off)};
}

struct Row {
  const int32_t* cands;  // the row's candidates, in device memory
  int32_t n;             // its length, in [0, F]
  int32_t skip_base;     // at least 0
  uint8_t* out;          // its body
  int32_t* body_len;
  int32_t* stats;        // [2]: kFinished and kRewalked summed over rows, or null
};

struct ThreadState {
  int32_t e;   // the end of the copy before the thread's run
  int32_t op;  // the run's first byte in the body
};

// Adds v to *p, atomically on the card (shared or device memory).
SC_HD void bump(int32_t* p, int32_t v) {
#ifdef __CUDA_ARCH__
  atomicAdd(p, v);
#else
  *p += v;
#endif
}

// The little-endian window of bytes i .. i + 3 of the staged row.
SC_HD uint32_t win(const uint32_t* row, int32_t i) {
  return sc::funnel_r(row[i >> 2], row[(i >> 2) + 1], 8u * (uint32_t)(i & 3));
}

// min(LCP, top) of the bytes at p and at c, given that their first m bytes
// are equal (m <= top <= n - p): 16 bytes a step, their four windows' loads
// at once (bytes up to 19 past n are read: the row's 32 zero bytes). Equal
// to min(sc::extend_match, top) for a hit at p against c.
SC_HD int32_t extend_to(const uint32_t* row, int32_t p, int32_t c, int32_t m, int32_t top) {
  while (m < top) {
    uint32_t x[4];
#pragma unroll
    for (int i = 0; i < 4; i++) x[i] = win(row, p + m + 4 * i) ^ win(row, c + m + 4 * i);
#pragma unroll
    for (int i = 0; i < 4; i++) {
      if (x[i] != 0) {
        const int32_t r = m + 4 * i + (sc::low_bit(x[i]) >> 3);
        return r < top ? r : top;
      }
    }
    m += 16;
  }
  return top;
}

// The same by a warp, 8 bytes a lane and 8 * kLanes a step.
template <class W>
SC_HD int32_t extend_warp(const W& w, const uint32_t* row, int32_t p, int32_t c, int32_t m,
                          int32_t top) {
  while (m < top) {
    sc::LanesOf<W, uint32_t> x0, x1;
    sc::LanesOf<W, bool> bad;
    w.each([&](int l) {
      const int32_t at = m + 8 * l;
      x0[l] = at < top ? win(row, p + at) ^ win(row, c + at) : 0u;
      x1[l] = at + 4 < top ? win(row, p + at + 4) ^ win(row, c + at + 4) : 0u;
      bad[l] = (x0[l] | x1[l]) != 0;
    });
    const uint32_t b = w.ballot(bad);
    if (b != 0) {
      const int f = sc::low_bit(b);
      const uint32_t y0 = w.read(x0, f), y1 = w.read(x1, f);
      const int32_t r = m + 8 * f + (y0 != 0 ? sc::low_bit(y0) >> 3 : 4 + (sc::low_bit(y1) >> 3));
      return r < top ? r : top;
    }
    m += 8 * W::kLanes;
  }
  return top;
}

// The first set bit of the bitmask in [from, to), or -1.
SC_HD int32_t first_set(const uint32_t* bits, int32_t from, int32_t to) {
  for (int32_t j = from >> 5; (j << 5) < to; j++) {
    uint32_t v = bits[j];
    if (j == (from >> 5)) v &= ~0u << (from & 31);
    const int32_t hi = to - (j << 5);
    if (hi < 32) v &= (1u << hi) - 1u;
    if (v != 0) return (j << 5) + sc::low_bit(v);
  }
  return -1;
}

// The first set bit of the bitmask at from, from + d, ... below to, or -1.
SC_HD int32_t first_strided(const uint32_t* bits, int32_t from, int32_t to, int32_t d) {
  for (int32_t q = from; q < to;) {
    const int32_t j = q >> 5, wend = (j + 1) << 5, top = wend < to ? wend : to;
    const uint32_t v = bits[j];
    if (v != 0) {
      for (int32_t x = q; x < top; x += d) {
        if ((v >> (x & 31)) & 1u) return x;
      }
    }
    q += (top - q + d - 1) / d * d;
  }
  return -1;
}

// (ip, skip) past probes that all miss, to the first probe at or past stop.
SC_HD void pass_misses(int32_t& ip, int32_t& skip, int32_t stop) {
  while (ip < stop) {
    const int32_t d = 1 + (skip >> 7), left = 128 - (skip & 127);
    if ((int64_t)left * d < stop - ip) {
      ip += left * d;
      skip += left;
    } else {
      const int32_t probes = (stop - ip + d - 1) / d;
      ip += probes * d;
      skip += probes;
    }
  }
}

// The walk's probes from (ip, skip) up to `stop`: true with ip at the first
// hit and skip as the walk has it there, else false with (ip, skip) at the
// first probe at or past stop. A group of probes with one step (128 a step
// size; the first after a copy 128 - skip_base % 128) is one bitmask search.
SC_HD bool next_hit(const uint32_t* hit, int32_t& ip, int32_t& skip, int32_t stop) {
  while (ip < stop) {
    const int32_t d = 1 + (skip >> 7), left = 128 - (skip & 127);
    if (d == 1) {  // the common case, in 32-bit arithmetic with no division
      const int32_t lim = left < stop - ip ? ip + left : stop;
      const int32_t h = first_set(hit, ip, lim);
      if (h >= 0) {
        skip += h - ip;
        ip = h;
        return true;
      }
      skip += lim - ip;
      ip = lim;
      continue;
    }
    const int32_t lim = (int64_t)left * d < stop - ip ? ip + left * d : stop;
    const int32_t h = first_strided(hit, ip, lim, d);
    if (h >= 0) {
      skip += (h - ip) / d;
      ip = h;
      return true;
    }
    pass_misses(ip, skip, lim);
  }
  return false;
}

// Whether the bitmask has a bit in [from, to), by the warp, a word a lane.
template <class W>
SC_HD bool any_set_warp(const W& w, const uint32_t* bits, int32_t from, int32_t to) {
  sc::LanesOf<W, bool> some;
  w.each([&](int l) {
    some[l] = false;
    for (int32_t j = (from >> 5) + l; (j << 5) < to; j += W::kLanes) {
      uint32_t v = bits[j];
      if (j == (from >> 5)) v &= ~0u << (from & 31);
      const int32_t hi = to - (j << 5);
      if (hi < 32) v &= (1u << hi) - 1u;
      some[l] = some[l] || v != 0;
    }
  });
  return w.ballot(some) != 0;
}

SC_HD bool bit(const uint32_t* bits, int32_t p) { return (bits[p >> 5] >> (p & 31)) & 1u; }

// The tag bytes of a literal of len bytes (none for 0) and of a copy.
SC_HD int32_t literal_bytes(int32_t len) {
  return len == 0 ? 0 : len + 1 + (len > 60) + (len > 256);
}

SC_HD int32_t copy_bytes(int32_t len, int32_t off) {
  const int32_t k = (len - 4) >> 6;  // sc::emit_copy's tags of 64
  int32_t r = len - 64 * k, b = 3 * k;
  if (r > 64) {
    b += 3;
    r -= 60;
  }
  return b + (r <= 11 && off < 2048 ? 2 : 3);
}

// sc::emit_literal's header.
SC_HD int32_t literal_head(uint8_t* out, int32_t op, int32_t len) {
  const int32_t lm1 = len - 1, extra = len > 256 ? 2 : (len > 60 ? 1 : 0);
  out[op] = (uint8_t)(extra == 0 ? lm1 << 2 : (59 + extra) << 2);
  if (extra >= 1) out[op + 1] = (uint8_t)(lm1 & 0xFF);
  if (extra == 2) out[op + 2] = (uint8_t)((lm1 >> 8) & 0xFF);
  return op + 1 + extra;
}

// Segments of the probed positions [0, lim): kSegs of whole bitmask words.
SC_HD int32_t segment(int32_t lim) {
  const int32_t s = ((lim + kSegs - 1) / kSegs + 31) & ~31;
  return s < 32 ? 32 : s;
}

// Phase: the row's words in, the take bitmask and misc words cleared.
template <class Ld>
SC_HD void stage_thread(const Ld& ld, const Layout& lay, const Smem& m, int32_t t) {
#pragma unroll 4
  for (int32_t k = t; k < lay.row_words; k += lay.threads) m.row[k] = ld.word(k);
  for (int32_t j = t; j < lay.words; j += lay.threads) m.take[j] = 0;
  for (int32_t k = t; k < kMiscWords; k += lay.threads) m.misc[k] = 0;
}

// The candidate of position p if the walk may probe it, else -1.
SC_HD int32_t probed_cand(const Row& row, int32_t p, int32_t lim) {
  return p >= 1 && p < lim ? sc::load_i32(row.cands + p) : -1;
}

// A word's hits and lengths, a position a lane, from the lanes' candidates
// c. A hit whose candidate continues the lane before's (c - 1, a hit too)
// follows it: its match is that match less its first byte. So only the
// runs' heads extend, up to kCap + 31 (a follower's length then reaches
// kCap where its head's does): each by the whole warp where a word has at
// most kWarpHeads (runs of one byte or one period: a head a word), else each
// on its lane. A follower's length is its head's less its distance from it.
template <class W>
SC_HD void hit_word(const W& w, const Smem& m, const Row& row, int32_t j,
                    const sc::LanesOf<W, int32_t>& c) {
  sc::LanesOf<W, bool> hit, follows;
  sc::LanesOf<W, int32_t> src, lcp;
  w.each([&](int l) {
    const int32_t p = 32 * j + l;
    hit[l] = (uint32_t)c[l] < (uint32_t)p && win(m.row, c[l]) == win(m.row, p);
    src[l] = l > 0 ? l - 1 : 0;
  });
  const uint32_t hits = w.ballot(hit);
  if (hits == 0) {
    w.each([&](int l) {
      if (l == 0) m.hit[j] = 0;
    });
    return;
  }
  const auto before = w.gather(c, src);
  w.each([&](int l) {
    follows[l] = l > 0 && ((hits >> (l - 1)) & 3u) == 3u && c[l] == before[l] + 1;
  });
  const uint32_t heads = hits & ~w.ballot(follows);
  auto top = [&](int32_t p) { return row.n - p < kCap + 31 ? row.n - p : kCap + 31; };
  if (sc::popc(heads) <= kWarpHeads) {
    for (uint32_t h = heads; h != 0; h &= h - 1u) {
      const int f = sc::low_bit(h);
      const int32_t p = 32 * j + f;
      const int32_t len = extend_warp(w, m.row, p, w.read(c, f), 4, top(p));
      w.each([&](int l) {
        if (l == f) lcp[l] = len;
      });
    }
  } else {
    w.each([&](int l) {
      const int32_t p = 32 * j + l;
      if ((heads >> l) & 1u) lcp[l] = extend_to(m.row, p, c[l], 4, top(p));
    });
  }
  w.each([&](int l) { src[l] = sc::top_bit(heads & (0xFFFFFFFFu >> (31 - l))); });
  const auto head_lcp = w.gather(lcp, src);
  w.each([&](int l) {
    if (!((hits >> l) & 1u)) return;
    const int32_t p = 32 * j + l, len = head_lcp[l] - (l - src[l]);
    m.lens[p] = len >= kCap && row.n - p > kCap ? kCapped : (uint16_t)len;
  });
  w.each([&](int l) {
    if (l == 0) m.hit[j] = hits;
  });
}

// Phase: warp wi's bitmask words (wi, wi + nwarps, ...), kAhead a round,
// the next round's candidates loaded before this round's compares (rows
// with few hits are bound by these loads).
template <class W>
SC_HD void hits_warp(const W& w, const Smem& m, const Row& row, int32_t wi, int32_t nwarps,
                     int32_t lim, int32_t words) {
  constexpr int kAhead = 4;
  sc::LanesOf<W, int32_t> next[kAhead];
  w.each([&](int l) {
#pragma unroll
    for (int k = 0; k < kAhead; k++) next[k][l] = probed_cand(row, 32 * (wi + k * nwarps) + l, lim);
  });
  for (int32_t j0 = wi; j0 < words; j0 += kAhead * nwarps) {
    sc::LanesOf<W, int32_t> cur[kAhead];
    w.each([&](int l) {
#pragma unroll
      for (int k = 0; k < kAhead; k++) {
        cur[k][l] = next[k][l];
        next[k][l] = probed_cand(row, 32 * (j0 + (kAhead + k) * nwarps) + l, lim);
      }
    });
#pragma unroll
    for (int k = 0; k < kAhead; k++) {
      if (j0 + k * nwarps < words) hit_word(w, m, row, j0 + k * nwarps, cur[k]);
    }
  }
}

// Phase (warp 0): walker l over segment l, [l * seg, end), from its start
// with skip at its base; its exit into misc. Each round, every walker runs
// on to its next capped hit (loading its candidate) or its exit; then the
// warp finishes the capped lengths together, a walker's up to its
// segment's end: one that reaches it ends the walker, its length pending.
template <class W>
SC_HD void walk_warp(const W& w, const Smem& m, const Row& row, int32_t lim, int32_t seg) {
  sc::LanesOf<W, int32_t> ip, skip, end, need, cand, known;
  sc::LanesOf<W, bool> live, waiting;
  w.each([&](int l) {
    const int32_t s = l * seg;
    end[l] = s + seg < lim ? s + seg : lim;
    live[l] = l == 0 || s < lim;
    ip[l] = l == 0 ? 1 : s;
    skip[l] = row.skip_base;
    need[l] = -1;
    cand[l] = -1;
    known[l] = 0;
  });
  int32_t finished = 0;
  for (;;) {
    w.each([&](int l) {
      waiting[l] = false;
      while (live[l]) {
        if (!next_hit(m.hit, ip[l], skip[l], end[l])) {
          live[l] = false;
          break;
        }
        const int32_t q = ip[l], len = m.lens[q];
        m.take[q >> 5] |= 1u << (q & 31);
        if (len == kCapped) {
          need[l] = q;
          cand[l] = sc::load_i32(row.cands + q);
          waiting[l] = true;
          break;
        }
        ip[l] = q + len;
        skip[l] = row.skip_base;
        live[l] = ip[l] < end[l];
      }
    });
    uint32_t todo = w.ballot(waiting);
    if (todo == 0) break;
    for (; todo != 0; todo &= todo - 1u) {
      const int f = sc::low_bit(todo);
      const int32_t q = w.read(need, f), top = w.read(end, f) - q;  // below n - q
      const int32_t len = top > kCap ? extend_warp(w, m.row, q, w.read(cand, f), kCap, top) : top;
      finished++;
      w.each([&](int l) {
        if (l != f) return;
        if (len == top) {  // reaches the segment's end: the stitch finishes it if it needs it
          known[l] = top;
          live[l] = false;
          return;
        }
        m.lens[q] = (uint16_t)len;
        need[l] = -1;
        ip[l] = q + len;
        skip[l] = row.skip_base;
        live[l] = ip[l] < end[l];
      });
    }
    w.sync();
  }
  w.each([&](int l) {
    m.misc[kSegIp + l] = ip[l];
    m.misc[kSegSkip + l] = skip[l];
    m.misc[kSegPend + l] = need[l];
    m.misc[kSegC + l] = cand[l];
    m.misc[kSegKnown + l] = known[l];
    if (l == 0) m.misc[kFinished] = finished;
  });
}

// The full length of the copy at q, whose candidate is c and whose first
// `known` bytes are equal, by the warp; written back.
template <class W>
SC_HD int32_t finish_warp(const W& w, const Smem& m, const Row& row, int32_t q, int32_t c,
                          int32_t known, int32_t& finished) {
  finished++;
  const int32_t full = extend_warp(w, m.row, q, c, known, row.n - q);
  w.sync();
  w.each([&](int l) {
    if (l == 0) m.lens[q] = (uint16_t)full;
  });
  w.sync();
  return full;
}

// The length of the hit at q, finished by the warp where it is capped.
template <class W>
SC_HD int32_t length_warp(const W& w, const Smem& m, const Row& row, int32_t q,
                          int32_t& finished) {
  const int32_t len = m.lens[q];
  return len != kCapped ? len
                        : finish_warp(w, m, row, q, sc::load_i32(row.cands + q), kCap, finished);
}

// take's bits in [from, to) cleared, a word a lane.
template <class W>
SC_HD void clear_take(const W& w, const Smem& m, int32_t from, int32_t to) {
  w.each([&](int l) {
    for (int32_t j = (from >> 5) + l; (j << 5) < to; j += W::kLanes) {
      uint32_t keep = 0;
      if (j == (from >> 5)) keep |= (1u << (from & 31)) - 1u;
      const int32_t hi = to - (j << 5);
      if (hi < 32) keep |= ~((1u << hi) - 1u);
      m.take[j] &= keep;
    }
  });
  w.sync();
}

// Phase: the true chain across the segments, by warp 0 (every lane runs the
// same walk; lane 0 writes).
template <class W>
SC_HD void stitch_warp(const W& w, const Smem& m, const Row& row, int32_t lim, int32_t seg) {
  int32_t a = m.misc[kSegIp], skip = m.misc[kSegSkip], pend = m.misc[kSegPend];
  int32_t pc = m.misc[kSegC], known = m.misc[kSegKnown];
  int32_t finished = 0, rewalked = 0;
  for (int32_t k = 1; k * seg < lim; k++) {
    const int32_t s = k * seg, end = s + seg < lim ? s + seg : lim;
    if (pend >= 0) {
      a = pend + finish_warp(w, m, row, pend, pc, known, finished);
      skip = row.skip_base;
      pend = -1;
    }
    if (a >= end) {  // the chain passes over segment k
      clear_take(w, m, s, end);
      continue;
    }
    if (!any_set_warp(w, m.hit, a, end)) {  // no hit before the segment's end: no copy
      pass_misses(a, skip, end);
      clear_take(w, m, s, end);
      continue;
    }
    // Walk on until the next hit is one of walker k's copies.
    int32_t ip = a, sk = skip, copies = 0;
    bool met = false;
    while (next_hit(m.hit, ip, sk, end)) {
      if (bit(m.take, ip)) {
        met = true;
        break;
      }
      ip += length_warp(w, m, row, ip, finished);
      sk = row.skip_base;
      copies++;
      if (ip >= end) break;
    }
    clear_take(w, m, s, met ? ip : end);
    rewalked += copies;
    if (copies > 0) {  // the chain's copies, walked again (their lengths now whole)
      int32_t q = a, qs = skip;
      for (int32_t i = 0; i < copies; i++) {
        next_hit(m.hit, q, qs, end);
        w.each([&](int l) {
          if (l == 0) m.take[q >> 5] |= 1u << (q & 31);
        });
        q += m.lens[q];
        qs = row.skip_base;
      }
      w.sync();
    }
    if (met) {
      a = m.misc[kSegIp + k];
      skip = m.misc[kSegSkip + k];
      pend = m.misc[kSegPend + k];
      pc = m.misc[kSegC + k];
      known = m.misc[kSegKnown + k];
    } else {
      a = ip;
      skip = sk;
    }
  }
  if (pend >= 0) finish_warp(w, m, row, pend, pc, known, finished);  // the last copy's length
  w.each([&](int l) {
    if (l != 0) return;
    if (finished) bump(m.misc + kFinished, finished);
    m.misc[kRewalked] = rewalked;
  });
}

// The end of the last copy that starts in bitmask words [j0, j1), or 0.
SC_HD int32_t last_end(const Smem& m, int32_t j0, int32_t j1) {
  for (int32_t j = j1 - 1; j >= j0; j--) {
    if (m.take[j] != 0) {
      const int32_t q = (j << 5) + sc::top_bit(m.take[j]);
      return q + m.lens[q];
    }
  }
  return 0;
}

// The tag bytes of the copies that start in words [j0, j1) and the
// literals before them, the copy before them ending at e. Each copy's offset
// goes into the length slot of the position after it, which lies inside the
// copy and is no copy's start.
SC_HD int32_t run_bytes(const Smem& m, const Row& row, int32_t e, int32_t j0, int32_t j1) {
  int32_t bytes = 0;
  for (int32_t j = j0; j < j1; j++) {
    for (uint32_t v = m.take[j]; v != 0; v &= v - 1u) {
      const int32_t q = (j << 5) + sc::low_bit(v), len = m.lens[q];
      const int32_t off = q - sc::load_i32(row.cands + q);
      m.lens[q + 1] = (uint16_t)off;
      bytes += literal_bytes(q - e) + copy_bytes(len, off);
      e = q + len;
    }
  }
  return bytes;
}

// A literal of the row's bytes [src, src + len) at op: the header, and the
// payload here or, for a long one, into the block's list.
SC_HD int32_t put_literal(const Smem& m, const Row& row, int32_t op, int32_t src, int32_t len) {
  op = literal_head(row.out, op, len);
  if (len >= kLongLiteral) {
#ifdef __CUDA_ARCH__
    const int32_t i = atomicAdd(m.misc + kLongCount, 1);
#else
    const int32_t i = m.misc[kLongCount]++;
#endif
    m.hit[3 * i] = (uint32_t)src;
    m.hit[3 * i + 1] = (uint32_t)op;
    m.hit[3 * i + 2] = (uint32_t)len;
  } else {
    const uint8_t* bytes = (const uint8_t*)m.row;
    for (int32_t i = 0; i < len; i++) row.out[op + i] = bytes[src + i];
  }
  return op + len;
}

// The run's tags from op (run_bytes' order).
SC_HD void emit_run(const Smem& m, const Row& row, int32_t e, int32_t op, int32_t j0,
                    int32_t j1) {
  for (int32_t j = j0; j < j1; j++) {
    for (uint32_t v = m.take[j]; v != 0; v &= v - 1u) {
      const int32_t q = (j << 5) + sc::low_bit(v), len = m.lens[q];
      if (q > e) op = put_literal(m, row, op, e, q - e);
      op = sc::emit_copy(row.out, op, m.lens[q + 1], len);
      e = q + len;
    }
  }
}

// Phase: each lane's run's last copy end; the warp's max-scan of them.
template <class W, class St>
SC_HD void ends_warp(const W& w, const Smem& m, int32_t wi, int32_t per, int32_t words, St st) {
  sc::LanesOf<W, uint32_t> end;
  w.each([&](int l) {
    const int32_t j0 = (wi * 32 + l) * per, j1 = j0 + per < words ? j0 + per : words;
    end[l] = (uint32_t)last_end(m, j0, j1);
  });
  const auto ex = w.excl_max(end);
  w.each([&](int l) {
    st(l).e = (int32_t)ex[l];
    if (l == 31) m.misc[kPartMax + wi] = (int32_t)(ex[l] > end[l] ? ex[l] : end[l]);
  });
}

// Phase (warp 0): the warps' parts scanned, exclusive; the whole in `whole`.
template <class W>
SC_HD void parts_warp(const W& w, const Smem& m, int32_t nwarps, int32_t part, bool sum,
                      int32_t whole) {
  sc::LanesOf<W, uint32_t> v;
  w.each([&](int l) { v[l] = l < nwarps ? (uint32_t)m.misc[part + l] : 0u; });
  const auto ex = sum ? w.excl_sum(v) : w.excl_max(v);
  w.sync();
  w.each([&](int l) {
    m.misc[part + l] = (int32_t)ex[l];
    if (l == 31) {
      m.misc[whole] = (int32_t)(sum ? ex[l] + v[l] : (ex[l] > v[l] ? ex[l] : v[l]));
    }
  });
}

// Phase: each lane's run's tag bytes; the warp's sum-scan of them.
template <class W, class St>
SC_HD void bytes_warp(const W& w, const Smem& m, const Row& row, int32_t wi, int32_t per,
                      int32_t words, St st) {
  sc::LanesOf<W, uint32_t> bytes;
  const int32_t before = m.misc[kPartMax + wi];
  w.each([&](int l) {
    const int32_t j0 = (wi * 32 + l) * per, j1 = j0 + per < words ? j0 + per : words;
    ThreadState& s = st(l);
    s.e = s.e > before ? s.e : before;
    bytes[l] = (uint32_t)run_bytes(m, row, s.e, j0, j1);
  });
  const auto ex = w.excl_sum(bytes);
  w.each([&](int l) {
    st(l).op = (int32_t)ex[l];
    if (l == 31) m.misc[kPartSum + wi] = (int32_t)(ex[l] + bytes[l]);
  });
}

// The whole row through the phases; the body into row.out and its length
// into *row.body_len.
template <class R, class Ld>
SC_HD void run_row(R& r, const Layout& lay, const Smem& m, const Row& row, const Ld& ld) {
  const int32_t nwarps = lay.threads / 32, words = lay.words;
  const int32_t lim = row.n > 15 ? row.n - 15 : 0, seg = segment(lim);
  const int32_t per = (words + lay.threads - 1) / lay.threads;  // bitmask words a thread emits
  r.threads([&](int32_t t, ThreadState&) { stage_thread(ld, lay, m, t); });
  r.sync();
  r.warps([&](int32_t wi, const auto& w, auto) { hits_warp(w, m, row, wi, nwarps, lim, words); });
  r.sync();
  r.warp0([&](const auto& w) { walk_warp(w, m, row, lim, seg); });
  r.sync();
  r.warp0([&](const auto& w) { stitch_warp(w, m, row, lim, seg); });
  r.sync();
  r.warps([&](int32_t wi, const auto& w, auto st) { ends_warp(w, m, wi, per, words, st); });
  r.sync();
  r.warp0([&](const auto& w) { parts_warp(w, m, nwarps, kPartMax, false, kLastEnd); });
  r.sync();
  r.warps([&](int32_t wi, const auto& w, auto st) { bytes_warp(w, m, row, wi, per, words, st); });
  r.sync();
  r.warp0([&](const auto& w) { parts_warp(w, m, nwarps, kPartSum, true, kTotal); });
  r.sync();
  r.threads([&](int32_t t, ThreadState& st) {
    const int32_t j0 = t * per, j1 = j0 + per < words ? j0 + per : words;
    if (j0 < j1) emit_run(m, row, st.e, st.op + m.misc[kPartSum + t / 32], j0, j1);
    if (t == lay.threads - 1) {  // the literal after the last copy, and the length
      const int32_t e = m.misc[kLastEnd], op = m.misc[kTotal];
      *row.body_len = row.n > e ? put_literal(m, row, op, e, row.n - e) : op;
    }
  });
  r.sync();
  r.threads([&](int32_t t, ThreadState&) {
    const uint8_t* bytes = (const uint8_t*)m.row;
    for (int32_t i = 0; i < m.misc[kLongCount]; i++) {
      const int32_t src = (int32_t)m.hit[3 * i], dst = (int32_t)m.hit[3 * i + 1];
      const int32_t len = (int32_t)m.hit[3 * i + 2];
      for (int32_t x = t; x < len; x += lay.threads) row.out[dst + x] = bytes[src + x];
    }
    if (t == 0 && row.stats != nullptr) {
      if (m.misc[kFinished]) bump(row.stats, m.misc[kFinished]);
      if (m.misc[kRewalked]) bump(row.stats + 1, m.misc[kRewalked]);
    }
  });
}

}  // namespace eb
