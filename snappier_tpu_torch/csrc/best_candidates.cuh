// The candidate search of level="best" as one row's schedule: the
// fingerprints of every width of the ladder, a stable radix sort of each
// width's keys across the row, each position's nearest previous equal key,
// and the merge where the widest width wins. csrc/best_candidates.cu runs it
// as one thread-block cluster a row; a host build runs the same phases over
// plain arrays, a phase at a time, to hold them to the plain version
// (snappier_tpu_torch/ops/best_match.py::exact_candidates_plain).
//
// The schedule is written once (run_row) over a runner that gives it the
// CTAs' shared memory (cta for its own; get and put for any CTA's), runs a
// phase on every thread (threads) or warp (warps, warp0) and orders them
// (cta_sync; cluster_sync, or its two halves cluster_arrive and
// cluster_wait with other work between). A phase reads and writes only what
// the barriers before it ordered; a thread's registers between phases are
// its ThreadState.
//
// A radix pass keeps the row's elements in registers, a thread's 8 at its
// slots: it ranks them in their warp and CTA by the pass's byte, stores them
// in that order into the CTA's sort buffer, and then each thread gathers
// the elements of its slots in the row's new order from the buffer of the
// CTA that holds them (runs of one byte and CTA, found by a binary search):
// the reads of a warp from another CTA's shared memory are runs of
// neighbouring words, where stores to each element's row index would each
// be a transfer of their own.
//
// The keys are the plain version's: at width w a position i with
// i + w <= len takes (hi, lo), the fingerprint pair, and any other position
// the pair (0x7F000000 + i, i), which no other position has. Equal pairs
// are equal 64-bit keys (hi above lo). Width 4 takes (hi, invalid) instead:
// lo = hi * M2 there, and no valid pair equals an invalid one (for every
// position below 65,536), so the two keys group the positions alike. A sort
// that is stable from position order leaves each group in position order.
//
// A width first sorts by a 16-bit hash of hi, its bucket (2 passes), which
// puts every equal key into one bucket, in position order. A position's
// nearest previous equal key is then found by walking back over its bucket
// a run of equal keys a step (each element knows where its run starts): the
// first element with its whole key is the one, another bucket ends the walk
// with none. Where a bucket holds one key (most buckets) the walk is one
// step. A walk that crosses more than kWalk runs makes the row sort that
// width again by the whole key (8 passes; 5 at width 4, whose low word is 0
// or 1) and take each element before it, counted in Row::fallbacks: a bound
// of a few times the sort's time for any row, however its keys collide.
#pragma once

#include <stdint.h>

#ifndef __CUDACC__
#define __host__
#define __device__
#endif

#define BC_HD __host__ __device__ inline

namespace bc {

constexpr int32_t kSlots = 8192;  // positions a CTA
constexpr int32_t kSlotBits = 13;
constexpr int32_t kThreads = 1024;
constexpr int32_t kWarps = kThreads / 32;
constexpr int32_t kPer = kSlots / kThreads;  // elements a thread
constexpr int32_t kMaxCtas = 8;              // the portable cluster size
constexpr int32_t kMaxWidth = kSlots * kMaxCtas;
constexpr int32_t kDigits = 256;  // a radix pass sorts by one byte of the key
constexpr uint32_t kM1 = 0x9E3779B9u;
constexpr uint32_t kM2 = 0xC2B2AE35u;
constexpr uint32_t kInvalidHi = 0x7F000000u;
constexpr int32_t kWalk = 32;  // runs a walk may cross before its width is sorted whole

// A CTA's shared memory, in bytes from its start.
constexpr uint32_t kRuns = kDigits * kMaxCtas;                   // runs of a byte and a CTA
constexpr uint32_t kKeyOff = 0;                                  // uint64 [kSlots]
constexpr uint32_t kHiOff = kKeyOff + 8 * kSlots;                // uint32 [kSlots]
constexpr uint32_t kLoOff = kHiOff + 4 * kSlots;                 // uint32 [kSlots]
constexpr uint32_t kCandOff = kLoOff + 4 * kSlots;               // int32 [kSlots]
constexpr uint32_t kPosOff = kCandOff + 4 * kSlots;              // uint16 [kSlots]
constexpr uint32_t kHistOff = kPosOff + 2 * kSlots;              // uint16 [kWarps][kDigits]
constexpr uint32_t kTotOff = kHistOff + 2 * kWarps * kDigits;    // uint32 [2][kDigits]
constexpr uint32_t kStartOff = kTotOff + 2 * 4 * kDigits;        // uint32 [2][kDigits]
constexpr uint32_t kPartOff = kStartOff + 2 * 4 * kDigits;       // uint32 [4][kDigits]
constexpr uint32_t kRunAtOff = kPartOff + 4 * 4 * kDigits;       // uint32 [kRuns]
constexpr uint32_t kRunSrcOff = kRunAtOff + 4 * kRuns;           // uint32 [kRuns]
constexpr uint32_t kCountsOff = kRunSrcOff + 4 * kRuns;          // uint16 [kMaxCtas][kDigits]
constexpr uint32_t kFlagOff = kCountsOff + 2 * kMaxCtas * kDigits;  // uint32 [4]
constexpr uint32_t kSmem = kFlagOff + 16;

// A CTA's arrays. Slot s of hi/lo/cand is position c * kSlots + s; the sort
// buffer (key, pos) holds the CTA's elements in a pass's order, and after a
// width's last pass row elements c * kSlots + s.
struct Cta {
  uint64_t* key;  // the sort's keys
  uint32_t* hi;   // the current width's fingerprints
  uint32_t* lo;
  int32_t* cand;  // the candidates so far
  uint16_t* pos;  // the sort's positions
  uint16_t* hist;  // per warp and digit: its count, then its first rank in the CTA;
                   // after a width's sort, each slot's run start
  uint32_t* tot;    // per pass parity and digit: the CTA's count (read by the other CTAs)
  uint32_t* start;  // per pass parity and digit: its first index in the CTA's buffer
  uint32_t* part;   // scan partials; the row's count of each digit and its first row index
  uint32_t* run_at;   // per run (digit d, CTA q at d * n + q): its first row index
  uint32_t* run_src;  // and its first index in CTA q's buffer, q above bit 16
  uint16_t* counts;   // per CTA q and digit: q's count (a copy of its tot)
  uint32_t* flag;     // [0]: a walk of this CTA ran past kWalk; [1]: its last run start
};

BC_HD Cta cta_at(unsigned char* smem) {
  return {(uint64_t*)(smem + kKeyOff),   (uint32_t*)(smem + kHiOff),
          (uint32_t*)(smem + kLoOff),    (int32_t*)(smem + kCandOff),
          (uint16_t*)(smem + kPosOff),   (uint16_t*)(smem + kHistOff),
          (uint32_t*)(smem + kTotOff),   (uint32_t*)(smem + kStartOff),
          (uint32_t*)(smem + kPartOff),  (uint32_t*)(smem + kRunAtOff),
          (uint32_t*)(smem + kRunSrcOff), (uint16_t*)(smem + kCountsOff),
          (uint32_t*)(smem + kFlagOff)};
}

// A thread's elements between phases: a key (a fingerprint pair while the
// next width is folded, a candidate after the walk) and its position, with
// its rank among the warp's elements of the same digit above bit 16.
struct ThreadState {
  uint64_t key[kPer];
  uint32_t pr[kPer];
};

struct Row {
  const uint8_t* bytes;  // the row's F bytes
  int32_t F;
  int32_t len;    // at least 0
  uint32_t mask;  // the widths to sort: bit k for 2^k, none above len
  int32_t n;      // CTAs a row
  int32_t* out;   // the row's F candidates
  int32_t* fallbacks;  // widths sorted whole, summed over rows (or null)
};

BC_HD int32_t popc(uint32_t x) {
#ifdef __CUDA_ARCH__
  return __popc(x);
#else
  return __builtin_popcount(x);
#endif
}

// Element k of thread t: a warp's 256 slots are contiguous, a round of 32
// at a time, so a warp ranks them in slot order.
BC_HD int32_t slot_of(int32_t t, int32_t k) { return ((t >> 5) << 8) | (k << 5) | (t & 31); }

BC_HD int32_t cta_count(int32_t F) { return (F + kSlots - 1) >> kSlotBits; }

BC_HD int32_t cta_positions(int32_t F, int32_t c) {
  const int32_t m = F - (c << kSlotBits);
  return m < kSlots ? m : kSlots;
}

// The ladder's widths that some position of a row of `len` bytes can take
// (widths up to 2^30; a wider one exceeds every int32 length).
BC_HD uint32_t row_mask(uint32_t mask, int32_t len) {
  uint32_t keep = 0;
  for (int32_t k = 2; k < 31 && (1 << k) <= len; k++) keep |= 1u << k;
  return mask & keep;
}

// A key's bucket: 16 bits of its hi mixed by an odd multiplier (equal keys,
// equal buckets).
BC_HD uint32_t bucket_of(uint64_t key) { return ((uint32_t)(key >> 32) * kM1) >> 16; }

// Radix passes of width w by bucket or by the whole key; pass p's digit: a
// byte of the bucket (shift -2, -1) or of the key from bit `shift`.
BC_HD int32_t passes(int32_t w, bool whole) { return !whole ? 2 : w == 4 ? 5 : 8; }
BC_HD int32_t digit_shift(int32_t w, bool whole, int32_t p) {
  return !whole ? p - 2 : w == 4 ? (p == 0 ? 0 : 24 + 8 * p) : 8 * p;
}
BC_HD uint32_t digit_of(uint64_t key, int32_t shift) {
  return (shift < 0 ? bucket_of(key) >> (16 + 8 * shift) : (uint32_t)(key >> shift)) & 0xFFu;
}

// One more row that sorted a width whole.
BC_HD void count_fallback(int32_t* fallbacks) {
  if (fallbacks == nullptr) return;
#ifdef __CUDA_ARCH__
  atomicAdd(fallbacks, 1);
#else
  ++*fallbacks;
#endif
}

// Phase: the width-4 fingerprints of the CTA's positions (bytes past F read
// as 0, the plain version's padding) and no candidate yet.
BC_HD void init_thread(const Cta& m, const Row& row, int32_t c, int32_t t) {
  const int32_t mc = cta_positions(row.F, c);
#pragma unroll
  for (int32_t k = 0; k < kPer; k++) {
    const int32_t s = slot_of(t, k);
    if (s >= mc) continue;
    const int32_t i = (c << kSlotBits) + s;
    uint32_t k4 = 0;
    for (int32_t j = 0; j < 4; j++) {
      if (i + j < row.F) k4 |= (uint32_t)row.bytes[i + j] << (8 * j);
    }
    m.hi[s] = k4;
    m.lo[s] = k4 * kM2;
    m.cand[s] = -1;
  }
}

// Phase: width w's key of each of the thread's positions, in position
// order, into its registers.
BC_HD void keys_thread(const Cta& m, const Row& row, int32_t c, int32_t t, int32_t w,
                       ThreadState& st) {
  const int32_t mc = cta_positions(row.F, c);
#pragma unroll
  for (int32_t k = 0; k < kPer; k++) {
    const int32_t s = slot_of(t, k);
    if (s >= mc) continue;
    const int32_t i = (c << kSlotBits) + s;
    const uint64_t bad = (uint64_t)(kInvalidHi + (uint32_t)i) << 32;
    if (i + w <= row.len) {
      st.key[k] = (uint64_t)m.hi[s] << 32 | (w == 4 ? 0u : m.lo[s]);
    } else {
      st.key[k] = bad | (w == 4 ? 1u : (uint32_t)i);
    }
    st.pr[k] = (uint32_t)i & 0xFFFFu;
  }
}

// Warp phase: each element's rank among the warp's earlier elements of the
// same digit, and the warp's count of each digit. A round of 32 slots: the
// lanes of one digit find each other (match_any), the lowest of them adds
// their number to the count, which each read before.
template <class W, class St>
BC_HD void rank_warp(const W& w, const Cta& m, int32_t mc, int32_t wi, int32_t shift, St st) {
  uint16_t* wh = m.hist + wi * kDigits;
  const bool full = ((wi + 1) << 8) <= mc;  // no absent element: digits below 256
  w.each([&](int l) {
    for (int32_t j = 0; j < kDigits / 32; j++) wh[l * (kDigits / 32) + j] = 0;
  });
  w.sync();
#pragma unroll
  for (int32_t k = 0; k < kPer; k++) {
    typename W::template Lanes<uint32_t> d, b0;
    w.each([&](int l) {
      const bool present = ((wi << 8) | (k << 5) | l) < mc;
      // An absent element takes a digit of its own, outside the 256.
      d[l] = present ? digit_of(st(l).key[k], shift) : 0x100u | (uint32_t)l;
    });
    const auto peers = w.match_any(d, full ? 8 : 9);
    w.each([&](int l) { b0[l] = d[l] < 0x100u ? wh[d[l]] : 0u; });
    w.sync();
    w.each([&](int l) {
      const uint32_t below = peers[l] & ((1u << l) - 1u);
      if (d[l] < 0x100u && below == 0) wh[d[l]] = (uint16_t)(b0[l] + popc(peers[l]));
      st(l).pr[k] = (st(l).pr[k] & 0xFFFFu) | ((b0[l] + popc(below)) << 16);
    });
    w.sync();
  }
}

// Phase: thread t takes digit t & 255 over the quarter t >> 8 of the warps:
// their counts become offsets within the quarter, its sum a partial.
BC_HD void scan_thread(const Cta& m, int32_t t) {
  const int32_t d = t & (kDigits - 1), q = t >> 8;
  uint32_t run = 0;
  for (int32_t j = 0; j < kWarps / 4; j++) {
    uint16_t* h = m.hist + ((q * (kWarps / 4) + j) * kDigits + d);
    const uint32_t v = *h;
    *h = (uint16_t)run;
    run += v;
  }
  m.part[q * kDigits + d] = run;
}

// Phase: the offsets move past the earlier quarters'; the CTA's count of
// each digit goes where the other CTAs read it.
BC_HD void scan2_thread(const Cta& m, int32_t t, int32_t parity) {
  const int32_t d = t & (kDigits - 1), q = t >> 8;
  uint32_t off = 0;
  for (int32_t p = 0; p < q; p++) off += m.part[p * kDigits + d];
  for (int32_t j = 0; j < kWarps / 4; j++) {
    m.hist[(q * (kWarps / 4) + j) * kDigits + d] += (uint16_t)off;
  }
  if (q == 0) {
    m.tot[parity * kDigits + d] = m.part[d] + m.part[kDigits + d] + m.part[2 * kDigits + d] +
                                  m.part[3 * kDigits + d];
  }
}

// Warp phase (the first warp): out[d] = the sum of in[d'] over d' < d, for
// the 256 digits.
template <class W>
BC_HD void digits_scan_warp(const W& w, const uint32_t* in, uint32_t* out) {
  constexpr int32_t kLaneDigits = kDigits / 32;
  typename W::template Lanes<uint32_t> sum;
  w.each([&](int l) {
    uint32_t s = 0;
    for (int32_t j = 0; j < kLaneDigits; j++) s += in[l * kLaneDigits + j];
    sum[l] = s;
  });
  const auto excl = w.excl_scan(sum);
  w.each([&](int l) {
    uint32_t run = excl[l];
    for (int32_t j = 0; j < kLaneDigits; j++) {
      const uint32_t v = in[l * kLaneDigits + j];
      out[l * kLaneDigits + j] = run;
      run += v;
    }
  });
}

// Phase: the thread's elements into the CTA's buffer in the pass's order:
// by digit, then by warp, then by rank.
BC_HD void stage_thread(const Cta& m, int32_t mc, int32_t t, int32_t shift, int32_t parity,
                        const ThreadState& st) {
  const uint16_t* wh = m.hist + (t >> 5) * kDigits;
  const uint32_t* start = m.start + parity * kDigits;
#pragma unroll
  for (int32_t k = 0; k < kPer; k++) {
    if (slot_of(t, k) >= mc) continue;
    const uint32_t d = digit_of(st.key[k], shift);
    const uint32_t j = start[d] + wh[d] + (st.pr[k] >> 16);
    m.key[j] = st.key[k];
    m.pos[j] = (uint16_t)st.pr[k];
  }
}

// Phase: every CTA's count and first buffer index of each digit, copied
// from the CTA (two reads a thread at most, all in flight at once).
template <class R>
BC_HD void exchange_thread(R& r, const Cta& m, int32_t n, int32_t t, int32_t parity) {
#pragma unroll
  for (int32_t h = 0; h < kMaxCtas * kDigits / kThreads; h++) {
    const int32_t i = t + h * kThreads;
    if (i >= n * kDigits) break;
    const int32_t q = i >> 8, d = i & (kDigits - 1);
    m.counts[i] = (uint16_t)r.get(m.tot, q, parity * kDigits + d);
    m.run_src[d * n + q] = r.get(m.start, q, parity * kDigits + d) | (uint32_t)q << 16;
  }
}

// Phase (threads of the first 256): digit t's count over the row's CTAs.
BC_HD void count_thread(const Cta& m, int32_t n, int32_t t) {
  if (t >= kDigits) return;
  uint32_t all = 0;
  for (int32_t q = 0; q < n; q++) all += m.counts[q * kDigits + t];
  m.part[t] = all;
}

// Phase (threads of the first 256): the runs of digit t, CTA by CTA, from
// the digit's first row index (part[kDigits + t]).
BC_HD void runs_thread(const Cta& m, int32_t n, int32_t t) {
  if (t >= kDigits) return;
  uint32_t at = m.part[kDigits + t];
  for (int32_t q = 0; q < n; q++) {
    m.run_at[t * n + q] = at;
    at += m.counts[q * kDigits + t];
  }
}

// Phase: the elements of the thread's slots in the pass's row order, each
// from the buffer of the CTA that staged it: the run that holds row index
// g is the last whose first index is at most g. One binary search for the
// first slot; the later slots, 32 apart, walk forward from it.
template <class R>
BC_HD void gather_thread(R& r, const Cta& m, int32_t c, int32_t mc, int32_t n, int32_t t,
                         ThreadState& st) {
  const int32_t runs = n * kDigits;
  int32_t at = 0;
  {
    const uint32_t g = (uint32_t)((c << kSlotBits) + slot_of(t, 0));
    for (int32_t b = (int32_t)kRuns / 2; b > 0; b >>= 1) {
      at += at + b < runs && m.run_at[at + b] <= g ? b : 0;
    }
  }
#pragma unroll
  for (int32_t k = 0; k < kPer; k++) {
    const int32_t s = slot_of(t, k);
    if (s >= mc) break;
    const uint32_t g = (uint32_t)((c << kSlotBits) + s);
    while (at + 1 < runs && m.run_at[at + 1] <= g) at++;
    const uint32_t src = m.run_src[at];
    const int32_t q = (int32_t)(src >> 16);
    const int32_t j = (int32_t)((src & 0xFFFFu) + (g - m.run_at[at]));
    st.key[k] = r.get(m.key, q, j);
    st.pr[k] = r.get(m.pos, q, j);
  }
}

// Phase: the sorted elements of the thread's slots into the CTA's buffer.
BC_HD void store_thread(const Cta& m, int32_t mc, int32_t t, const ThreadState& st) {
#pragma unroll
  for (int32_t k = 0; k < kPer; k++) {
    const int32_t s = slot_of(t, k);
    if (s >= mc) continue;
    m.key[s] = st.key[k];
    m.pos[s] = (uint16_t)st.pr[k];
  }
}

// Warp phase, the row sorted: where each run of equal keys starts (a row
// index where the key differs from the one before, or 0), running maximum
// over the warp's slots in order, into hist (the passes' counts are done
// with); the warp's maximum into part[wi]. Max with 0 is no start.
template <class R, class W>
BC_HD void starts_warp(R& r, const W& w, const Cta& m, int32_t c, int32_t mc, int32_t wi) {
  uint32_t carry = 0;
  for (int32_t k = 0; k < kPer; k++) {
    typename W::template Lanes<uint32_t> v;
    w.each([&](int l) {
      const int32_t s = (wi << 8) | (k << 5) | l;
      v[l] = 0;
      if (s < mc) {
        const uint64_t before =
            s > 0 ? m.key[s - 1] : c > 0 ? r.get(m.key, c - 1, kSlots - 1) : 0;
        if ((c | s) == 0 || m.key[s] != before) v[l] = (uint32_t)((c << kSlotBits) + s);
      }
    });
    const auto below = w.excl_max(v);
    w.each([&](int l) {
      const int32_t s = (wi << 8) | (k << 5) | l;
      uint32_t run = below[l] > v[l] ? below[l] : v[l];
      run = run > carry ? run : carry;
      if (s < mc) m.hist[s] = (uint16_t)run;
    });
    const uint32_t top = w.at(below, 31) > w.at(v, 31) ? w.at(below, 31) : w.at(v, 31);
    carry = top > carry ? top : carry;
  }
  w.each([&](int l) {
    if (l == 0) m.part[wi] = carry;
  });
}

// Warp phase (the first warp): part[kWarps + wi] the maximum over the warps
// below wi; flag[1] the CTA's last run start.
template <class W>
BC_HD void starts_cta_warp(const W& w, const Cta& m) {
  typename W::template Lanes<uint32_t> top;
  w.each([&](int l) { top[l] = m.part[l]; });
  const auto below = w.excl_max(top);
  w.each([&](int l) {
    m.part[kWarps + l] = below[l];
    if (l == 31) m.flag[1] = below[l] > top[l] ? below[l] : top[l];
  });
}

// Phase: the run starts of the thread's slots past the warps and CTAs before.
template <class R>
BC_HD void starts_thread(R& r, const Cta& m, int32_t c, int32_t mc, int32_t t) {
  uint32_t carry = m.part[kWarps + (t >> 5)];
  for (int32_t q = 0; q < c; q++) {
    const uint32_t v = r.get(m.flag, q, 1);
    carry = v > carry ? v : carry;
  }
#pragma unroll
  for (int32_t k = 0; k < kPer; k++) {
    const int32_t s = slot_of(t, k);
    if (s >= mc) break;
    if (m.hist[s] < carry) m.hist[s] = (uint16_t)carry;
  }
}

// The rest of a walk whose first step found another key of its bucket at
// row index x: on over x's run and back a run a step until its key (its
// position returned), another bucket or the row's start (-1); past kWalk
// runs it marks the CTA's flag.
template <class R>
BC_HD int32_t walk_on(R& r, const Cta& m, int32_t c, int32_t x, uint64_t key) {
  const uint32_t bucket = bucket_of(key);
  for (int32_t steps = 1;; steps++) {
    int32_t q = x >> kSlotBits, j = x & (kSlots - 1);
    x = (int32_t)(q == c ? m.hist[j] : r.get(m.hist, q, j)) - 1;
    if (x < 0) return -1;
    if (steps == kWalk) {
      m.flag[0] = 1;
      return -1;
    }
    q = x >> kSlotBits;
    j = x & (kSlots - 1);
    const uint64_t other = q == c ? m.key[j] : r.get(m.key, q, j);
    if (bucket_of(other) != bucket) return -1;
    if (other == key) return q == c ? m.pos[j] : r.get(m.pos, q, j);
  }
}

// Warp phase, the row sorted by bucket: each element's nearest previous
// equal key, kept in its key's register (-1 for none). The first step is
// the element before it, from the lane before (or the round before); where
// that is another key of its bucket, walk_on goes on.
template <class R, class W, class St>
BC_HD void walk_warp(R& r, const W& w, const Cta& m, int32_t c, int32_t mc, int32_t wi, St st) {
  uint64_t last_key = 0;  // the element before the round's first slot
  uint32_t last_pos = 0;
  const int32_t g0 = (c << kSlotBits) + (wi << 8);
  if (g0 > 0) {
    const int32_t q = (g0 - 1) >> kSlotBits, j = (g0 - 1) & (kSlots - 1);
    last_key = q == c ? m.key[j] : r.get(m.key, q, j);
    last_pos = q == c ? m.pos[j] : r.get(m.pos, q, j);
  }
  for (int32_t k = 0; k < kPer; k++) {
    typename W::template Lanes<uint64_t> key;
    typename W::template Lanes<uint32_t> pos;
    w.each([&](int l) {
      key[l] = st(l).key[k];
      pos[l] = st(l).pr[k] & 0xFFFFu;
    });
    const auto up_key = w.up(key);
    const auto up_pos = w.up(pos);
    w.each([&](int l) {
      const int32_t s = (wi << 8) | (k << 5) | l, g = (c << kSlotBits) + s;
      if (s >= mc) return;
      const uint64_t other = l > 0 ? up_key[l] : last_key;
      int32_t prev = -1;
      if (g > 0 && other == key[l]) {
        prev = (int32_t)(l > 0 ? up_pos[l] : last_pos);
      } else if (g > 0 && bucket_of(other) == bucket_of(key[l])) {
        prev = walk_on(r, m, c, g - 1, key[l]);
      }
      st(l).key[k] = (uint64_t)(uint32_t)prev;
    });
    last_key = w.at(key, 31);
    last_pos = w.at(pos, 31);
  }
}

// Phase: each walk's candidate into the candidate array of the CTA that
// holds its position; a wider width runs later and overwrites.
template <class R>
BC_HD void commit_thread(R& r, int32_t mc, int32_t t, const Cta& m, const ThreadState& st) {
#pragma unroll
  for (int32_t k = 0; k < kPer; k++) {
    if (slot_of(t, k) >= mc) break;
    const int32_t prev = (int32_t)(uint32_t)st.key[k];
    const int32_t p = (int32_t)(st.pr[k] & 0xFFFFu);
    if (prev >= 0) r.put(m.cand, p >> kSlotBits, p & (kSlots - 1), prev);
  }
}

// Whether a walk of any of the row's CTAs ran past kWalk.
template <class R>
BC_HD bool walk_overran(R& r, const Cta& m, int32_t n) {
  uint32_t any = 0;
  for (int32_t q = 0; q < n; q++) any |= r.get(m.flag, q, 0);
  return any != 0;
}

// Phase: where the element before it in the sorted row has its key, the
// position gets that element's position as its candidate; a wider width
// runs later and overwrites.
template <class R>
BC_HD void prev_thread(R& r, const Cta& m, int32_t c, int32_t mc, int32_t t) {
#pragma unroll
  for (int32_t k = 0; k < kPer; k++) {
    const int32_t s = slot_of(t, k);
    if (s >= mc || (c == 0 && s == 0)) continue;
    uint64_t before;
    uint16_t at;
    if (s > 0) {
      before = m.key[s - 1];
      at = m.pos[s - 1];
    } else {
      before = r.get(m.key, c - 1, kSlots - 1);
      at = r.get(m.pos, c - 1, kSlots - 1);
    }
    if (before != m.key[s]) continue;
    const int32_t p = m.pos[s];
    r.put(m.cand, p >> kSlotBits, p & (kSlots - 1), (int32_t)at);
  }
}

// Phase: width 2w's fingerprints, fold(fp(w)[i], fp(w)[(i + w) % F]) (the
// plain version's roll), into registers.
template <class R>
BC_HD void fold_thread(R& r, const Cta& m, const Row& row, int32_t c, int32_t t, int32_t w,
                       ThreadState& st) {
  const int32_t mc = cta_positions(row.F, c);
#pragma unroll
  for (int32_t k = 0; k < kPer; k++) {
    const int32_t s = slot_of(t, k);
    if (s >= mc) continue;
    const int32_t j = ((c << kSlotBits) + s + w) % row.F;
    const int32_t q = j >> kSlotBits, js = j & (kSlots - 1);
    const uint32_t hj = q == c ? m.hi[js] : r.get(m.hi, q, js);
    const uint32_t lj = q == c ? m.lo[js] : r.get(m.lo, q, js);
    st.key[k] = (uint64_t)(m.hi[s] * kM1 + hj) << 32 | (uint32_t)(m.lo[s] * kM2 + lj);
  }
}

// Phase: the folded fingerprints in place of the old.
BC_HD void fold_store_thread(const Cta& m, int32_t mc, int32_t t, const ThreadState& st) {
#pragma unroll
  for (int32_t k = 0; k < kPer; k++) {
    const int32_t s = slot_of(t, k);
    if (s >= mc) continue;
    m.hi[s] = (uint32_t)(st.key[k] >> 32);
    m.lo[s] = (uint32_t)st.key[k];
  }
}

// Phase: the CTA's candidates out, in position order.
BC_HD void out_thread(const Cta& m, const Row& row, int32_t c, int32_t t) {
  const int32_t mc = cta_positions(row.F, c);
#pragma unroll
  for (int32_t k = 0; k < kPer; k++) {
    const int32_t s = slot_of(t, k);
    if (s < mc) row.out[(c << kSlotBits) + s] = m.cand[s];
  }
}

// The stable LSD radix sort of the row's keys across its CTAs by hi alone
// or whole (a pass a byte: rank in the warp, scan in the CTA, stage in the
// CTA's buffer, counts exchanged across the CTAs, each slot gathered from
// the CTA that staged its element), from the keys in the threads'
// registers to the sorted row in the buffers and registers. A pass's tot and
// start are its parity's, so a CTA that runs ahead does not overwrite what
// another still reads; the barrier after a pass's gathers is awaited only
// before the next pass stages over the buffers they read.
template <class R>
BC_HD void sort_keys(R& r, const Row& row, int32_t w, bool whole) {
  auto mc = [&](int32_t c) { return cta_positions(row.F, c); };
  for (int32_t p = 0; p < passes(w, whole); p++) {
    const int32_t shift = digit_shift(w, whole, p), parity = p & 1;
    r.warps([&](int32_t c, int32_t wi, const auto& wp, auto st) {
      rank_warp(wp, r.cta(c), mc(c), wi, shift, st);
    });
    r.cta_sync();
    r.threads([&](int32_t c, int32_t t, ThreadState&) { scan_thread(r.cta(c), t); });
    r.cta_sync();
    r.threads([&](int32_t c, int32_t t, ThreadState&) { scan2_thread(r.cta(c), t, parity); });
    r.cta_sync();
    r.warp0([&](int32_t c, const auto& wp) {
      const Cta m = r.cta(c);
      digits_scan_warp(wp, m.tot + parity * kDigits, m.start + parity * kDigits);
    });
    if (p > 0) r.cluster_wait();  // every gather of the pass before done
    r.cta_sync();
    r.threads([&](int32_t c, int32_t t, ThreadState& st) {
      stage_thread(r.cta(c), mc(c), t, shift, parity, st);
    });
    r.cluster_sync();  // every CTA's elements staged and counted
    r.threads([&](int32_t c, int32_t t, ThreadState&) { exchange_thread(r, r.cta(c), row.n, t, parity); });
    r.cta_sync();
    r.threads([&](int32_t c, int32_t t, ThreadState&) { count_thread(r.cta(c), row.n, t); });
    r.cta_sync();
    r.warp0([&](int32_t c, const auto& wp) {
      const Cta m = r.cta(c);
      digits_scan_warp(wp, m.part, m.part + kDigits);
    });
    r.cta_sync();
    r.threads([&](int32_t c, int32_t t, ThreadState&) { runs_thread(r.cta(c), row.n, t); });
    r.cta_sync();
    r.threads([&](int32_t c, int32_t t, ThreadState& st) {
      gather_thread(r, r.cta(c), c, mc(c), row.n, t, st);
    });
    r.cluster_arrive();
  }
  r.cluster_wait();
  r.threads([&](int32_t c, int32_t t, ThreadState& st) { store_thread(r.cta(c), mc(c), t, st); });
  r.cluster_sync();  // the sorted row in the buffers
}

// One width: its keys sorted by bucket and walked; where a walk ran long,
// sorted whole and each element's candidate the element before it.
template <class R>
BC_HD void sort_width(R& r, const Row& row, int32_t w) {
  auto mc = [&](int32_t c) { return cta_positions(row.F, c); };
  r.threads([&](int32_t c, int32_t t, ThreadState& st) {
    keys_thread(r.cta(c), row, c, t, w, st);
    if (t == 0) r.cta(c).flag[0] = 0;
  });
  sort_keys(r, row, w, false);
  r.warps([&](int32_t c, int32_t wi, const auto& wp, auto) { starts_warp(r, wp, r.cta(c), c, mc(c), wi); });
  r.cta_sync();
  r.warp0([&](int32_t c, const auto& wp) { starts_cta_warp(wp, r.cta(c)); });
  r.cluster_sync();  // every CTA's last run start out
  r.threads([&](int32_t c, int32_t t, ThreadState&) { starts_thread(r, r.cta(c), c, mc(c), t); });
  r.cluster_sync();  // every run start in
  r.warps([&](int32_t c, int32_t wi, const auto& wp, auto st) {
    walk_warp(r, wp, r.cta(c), c, mc(c), wi, st);
  });
  r.cluster_sync();  // every walk and flag done
  if (!walk_overran(r, r.cta(0), row.n)) {
    r.threads([&](int32_t c, int32_t t, ThreadState& st) { commit_thread(r, mc(c), t, r.cta(c), st); });
  } else {
    r.threads([&](int32_t c, int32_t t, ThreadState& st) {
      if (c == 0 && t == 0) count_fallback(row.fallbacks);
      keys_thread(r.cta(c), row, c, t, w, st);
    });
    sort_keys(r, row, w, true);
    r.threads([&](int32_t c, int32_t t, ThreadState&) { prev_thread(r, r.cta(c), c, mc(c), t); });
  }
  r.cluster_sync();  // the candidates in, the buffers free
}

// The whole row: width 4's fingerprints, then for each width up to the
// widest the row can take, its sort where the ladder has it and the fold to
// the next; the candidates out.
template <class R>
BC_HD void run_row(R& r, const Row& row) {
  r.threads([&](int32_t c, int32_t t, ThreadState&) { init_thread(r.cta(c), row, c, t); });
  r.cluster_sync();
  int32_t top = 0;
  for (int32_t k = 2; k < 32; k++) top = (row.mask >> k) & 1u ? k : top;
  for (int32_t k = 2; k <= top; k++) {
    const int32_t w = 1 << k;
    if ((row.mask >> k) & 1u) sort_width(r, row, w);
    if (k == top) break;
    r.threads([&](int32_t c, int32_t t, ThreadState& st) { fold_thread(r, r.cta(c), row, c, t, w, st); });
    r.cluster_sync();  // every fingerprint of width w read
    r.threads([&](int32_t c, int32_t t, ThreadState& st) {
      fold_store_thread(r.cta(c), cta_positions(row.F, c), t, st);
    });
    r.cluster_sync();
  }
  r.threads([&](int32_t c, int32_t t, ThreadState&) { out_thread(r.cta(c), row, c, t); });
}

}  // namespace bc
