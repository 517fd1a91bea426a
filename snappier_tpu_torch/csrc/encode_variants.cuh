// The encode-walk ablation (encode_variants.cu, encode_r4.cu): one greedy
// walk over a fragment whose parts are chosen by a mask, written as a
// __host__ __device__ function like the walks in scalar_codec.cuh.
//
// It computes what tools/perf_probe_enc.py::_encode_kernel_v (wrapper
// encode_variant, the flag tuples) and tools/perf_probe_r4.py::
// _encode_kernel_r4 (wrapper encode_r4, the named restructurings) compute:
// the tag stream of one fragment and its length. The two TPU kernels are
// one family: a probe of 4 or 8 positions against the match table, an
// extension walk that also seeds the table, a tail of up to 3 bytes, and the
// emission of a literal and a copy. The mask says which form each part
// takes; the hash width and the thinning of the probe's table stores are
// run-time values. A StaticWalk<mask> fixes the mask at compile time, so
// that every test of it folds away and each named variant is a kernel of
// its own; a DynWalk carries any legal mask.
//
// Some parts change the bytes (another valid encoding of the same input:
// the seeding of the extension walks, the probe width, the miss advance,
// the store thinning, the hash width), some only the order of the work (the
// preloaded next group, the detection-only probe, the two nested loops, the
// branch-free tail and copy tag): the latter give the bytes of the walk
// they restructure. The table is fresh per fragment (16-bit slots, EMPTY
// for none), which is what the TPU kernels' epoch tag amounts to.
#pragma once

#include "scalar_codec.cuh"

namespace sc {

enum : uint32_t {
  // Extension walk, bits 0-2.
  EV_EXT_LOOP4 = 0,   // stride 4, no seeding (encode_variant without "merged")
  EV_EXT_4 = 1,       // stride 4, one seed per step ("merged"; encode_r4's base walk)
  EV_EXT_8 = 2,       // stride 8 whose advance depends on the compares ("encext8")
  EV_EXT_8U = 3,      // stride 8, unconditional advance, backs up at the end ("ext8", "encext8u")
  EV_EXT_8S2 = 4,     // EXT_8U with two seeds per step ("encext8s2")
  EV_EXT_16U = 5,     // stride 16, two seeds per step ("encext16u")
  EV_EXT_MASK = 7,
  EV_POST_SEED = 1u << 3,   // seed at + 1 + 4k over the match after emission
  EV_XOR_TAIL = 1u << 4,    // the tail from one XOR of two windows ("btail")
  EV_BFREE_COPY = 1u << 5,  // a copy tag always stores 3 bytes ("bcopy")
  EV_EMIT_COUNT = 1u << 6,  // lengths only, no stores ("encnoemit")
  EV_EMIT_HITS = 1u << 7,   // 2 per hit, no stores, no final literal ("noemit")
  EV_PROBE8 = 1u << 8,      // 8 positions a probe, advance 7 + (skip >> 5) ("probe8")
  EV_OCT = 1u << 9,         // 8 positions, all stored, advance 6 + 2 * (skip >> 5) ("encoct")
  EV_ADV4 = 1u << 10,       // a miss advances by the probe width ("adv4")
  EV_TRIM = 1u << 11,       // detection-only probe, candidates chosen in the hit branch
  EV_LOOP_PRE = 1u << 12,   // the next miss position's keys and hashes loaded before the resolve
  EV_LOOP_TWO = 1u << 13,   // an inner loop over misses, the hit work once per outer step
  EV_NOSCAN = 1u << 14,     // no walk at all: length 0 ("noscan")
  EV_DMA_ONLY = 1u << 15,   // no walk at all: length n ("encdmaonly")
};

template <uint32_t kMask>
struct StaticWalk {
  int hash_bits;
  int store_step;  // the probe stores positions 0, store_step, 2 * store_step, ...: 1, 2, 4 or 8
  SC_HD constexpr uint32_t mask() const { return kMask; }
};

struct DynWalk {
  uint32_t m;
  int hash_bits;
  int store_step;
  SC_HD uint32_t mask() const { return m; }
};

// Emission of one literal run and one copy under a mask: stores and the new
// output position, or the position alone. A literal's payload is read
// through the walk's loader (sc::emit_literal's loader form, which may store
// up to 3 bytes past the literal).
template <class Ld>
struct VariantEmitter {
  uint32_t mk;
  const Ld& ld;
  uint8_t* out;

  SC_HD int32_t literal(int32_t op, int32_t start, int32_t end) const {
    int32_t len = end - start;
    if (len <= 0) return op;
    if (mk & EV_EMIT_COUNT) return op + 1 + (len > 256 ? 2 : (len > 60 ? 1 : 0)) + len;
    return emit_literal(out, op, ld, start, len);
  }

  SC_HD int32_t upto64(int32_t op, int32_t off, int32_t len) const {
    if (mk & EV_EMIT_COUNT) return op + ((len <= 11 && off < 2048) ? 2 : 3);
    if (mk & EV_BFREE_COPY) return emit_copy_upto64_bfree(out, op, off, len);
    return emit_copy_upto64(out, op, off, len);
  }

  SC_HD int32_t copy(int32_t op, int32_t off, int32_t len) const {
    while (len >= 68) {
      op = upto64(op, off, 64);
      len -= 64;
    }
    if (len > 64) {
      op = upto64(op, off, 60);
      len -= 60;
    }
    return upto64(op, off, len);
  }
};

// The match length at `at` against `cand` before the tail, by the mask's
// extension walk; `steps` gains the walk's loop iterations. seed(pos) stores
// min(pos, n - 5) in the table.
template <class Key, class Seed>
SC_HD int32_t variant_extend(uint32_t ext, Key key, Seed seed, int32_t at, int32_t cand,
                             int32_t n, int32_t& steps) {
  int32_t m = 4;
  bool go = true;
  if (ext == EV_EXT_LOOP4) {
    while (at + m + 4 <= n && key(at + m) == key(cand + m)) {
      m += 4;
      steps++;
    }
  } else if (ext == EV_EXT_4) {
    while (go && at + m + 4 <= n) {
      steps++;
      seed(at + m - 3);
      go = key(at + m) == key(cand + m);
      m += 4;
    }
    if (!go) m -= 4;
  } else if (ext == EV_EXT_8) {
    while (go && at + m + 8 <= n) {
      steps++;
      seed(at + m - 3);
      bool eq0 = key(at + m) == key(cand + m);
      bool eq1 = key(at + m + 4) == key(cand + m + 4);
      m += eq0 ? (eq1 ? 8 : 4) : 0;
      go = eq0 && eq1;
    }
    if (go && at + m + 4 <= n && key(at + m) == key(cand + m)) m += 4;
  } else if (ext == EV_EXT_8U || ext == EV_EXT_8S2) {
    bool eq0l = true;
    while (go && at + m + 8 <= n) {
      steps++;
      seed(at + m - 3);
      if (ext == EV_EXT_8S2) seed(at + m + 1);
      bool eq0 = key(at + m) == key(cand + m);
      bool eq1 = key(at + m + 4) == key(cand + m + 4);
      m += 8;
      go = eq0 && eq1;
      eq0l = eq0;
    }
    if (!go) m = m - 8 + (eq0l ? 4 : 0);
    if (go && at + m + 4 <= n && key(at + m) == key(cand + m)) m += 4;
  } else {  // EV_EXT_16U
    bool e0 = true, e01 = true, e012 = true;
    while (go && at + m + 16 <= n) {
      steps++;
      seed(at + m - 3);
      seed(at + m + 5);
      e0 = key(at + m) == key(cand + m);
      e01 = e0 && key(at + m + 4) == key(cand + m + 4);
      e012 = e01 && key(at + m + 8) == key(cand + m + 8);
      go = e012 && key(at + m + 12) == key(cand + m + 12);
      m += 16;
    }
    if (!go) {
      m = m - 16 + (e0 ? 4 : 0) + (e01 ? 4 : 0) + (e012 ? 4 : 0);
    } else {  // the bounds ended the walk: up to 3 groups of 4 remain
      while (go && at + m + 4 <= n) {
        steps++;
        go = key(at + m) == key(cand + m);
        m += 4;
      }
      if (!go) m -= 4;
    }
  }
  return m;
}

// What a walk counts: nothing (the ablation kernels), or the budget of
// tools/perf_probe_r4.py::_encode_stats_kernel.
struct NoStats {
  SC_HD void miss() {}
  SC_HD void hit(int32_t, int32_t) {}
};

struct WalkStats {
  int32_t miss_iters = 0;  // probe groups without a hit
  int32_t hits = 0;
  int32_t ext_iters = 0;  // loop iterations of the extension walks
  int32_t match_bytes = 0;  // match lengths after the tail and the clamp to n
  SC_HD void miss() { miss_iters++; }
  SC_HD void hit(int32_t steps, int32_t m) {
    hits++;
    ext_iters += steps;
    match_bytes += m;
  }
};

// encode_stats.cu's walk: K2's probe of 4 positions, all stored, the
// stride-4 extension that seeds, the tail from one XOR, no emission.
constexpr uint32_t EV_STATS_WALK = EV_EXT_4 | EV_XOR_TAIL | EV_EMIT_HITS;

// Greedy LZ77 over one fragment of n bytes under a mask, read through a
// loader (sc::RowWords, sc::RowBytes); returns the tag stream's length and
// counts the walk into `stats`. Bytes at or past n read as zero. table holds
// 1 << cfg.hash_bits slots, all EMPTY on entry; out holds the bound of
// greedy emission plus 3 bytes (nothing without emission).
template <class Ld, class Cfg, class Stats>
SC_HD int32_t encode_fragment_variant(const Ld& ld, int32_t n, uint16_t* table, Cfg cfg,
                                      uint8_t* out, Stats& stats) {
  const uint32_t mk = cfg.mask();
  if (mk & EV_DMA_ONLY) return n;
  if (mk & EV_NOSCAN) return 0;
  const int hb = cfg.hash_bits;
  const int W = (mk & (EV_PROBE8 | EV_OCT)) ? 8 : 4;
  const int store_step = (mk & EV_OCT) ? 1 : cfg.store_step;
  const int32_t margin = INPUT_MARGIN + ((mk & EV_OCT) ? 4 : 0);
  const int32_t skip_base = 32;
  const VariantEmitter<Ld> em{mk, ld, out};

  auto key = [&](int32_t i) { return ld.window(i); };
  auto seed = [&](int32_t pos) {
    int32_t p = pos < n - 5 ? pos : n - 5;
    table[hash32(ld.window(p), hb)] = (uint16_t)p;
  };
  auto miss_step = [&](int32_t skip) {
    if (mk & EV_OCT) return 6 + 2 * (skip >> 5);
    return ((mk & EV_ADV4) ? W : W - 1) + (skip >> 5);
  };
  const int32_t skip_inc = (mk & EV_OCT) ? 2 : 1;
  // The loops over a group's positions run to 8 under a test against W, with
  // the arrays indexed by the loop counter alone, so that they unroll and
  // the arrays stay in registers.
  //
  // Keys and hashes of the W positions at ip, from the three words that
  // hold them (four for a probe of 8) and funnel shifts; ip is clamped to
  // n - 3, as the staged walk of the TPU kernels clamps a speculative load.
  auto loads_at = [&](int32_t ip, uint32_t* cur, uint32_t* h) {
    if (ip > n - 3) ip = n - 3 < 0 ? 0 : n - 3;
    const int32_t k = ip >> 2;
    const uint32_t sh = 8u * (uint32_t)(ip & 3);
    const uint32_t w1 = ld.word(k + 1), w2 = ld.word(k + 2);
    const uint32_t a0 = funnel_r(ld.word(k), w1, sh), a1 = funnel_r(w1, w2, sh);
    const uint32_t a2 = W == 8 ? funnel_r(w2, ld.word(k + 3), sh) : 0u;
#pragma unroll
    for (int d = 0; d < 8; d++) {
      if (d < W) {
        cur[d] = d < 4 ? funnel_r(a0, a1, 8u * d) : funnel_r(a1, a2, 8u * (d - 4));
        h[d] = hash32(cur[d], hb);
      }
    }
  };
  // The probe of the group at ip: reads the W slots, stores the group's
  // positions (every store_step-th, a power of two), and finds the first
  // position whose candidate verifies. Returns its index (or -1) and sets
  // cand_first.
  auto probe = [&](int32_t ip, const uint32_t* cur, const uint32_t* h, int32_t& cand_first) {
    int32_t ent[8];
#pragma unroll
    for (int d = 0; d < 8; d++) {
      if (d < W) ent[d] = table[h[d]];
    }
#pragma unroll
    for (int d = 0; d < 8; d++) {
      if (d < W && (d & (store_step - 1)) == 0) table[h[d]] = (uint16_t)(ip + d);
    }
    if (mk & EV_TRIM) {
      // Detection only: an EMPTY slot fails the bound test by itself, so
      // one compare stands for the empty test and the bound. Candidates are
      // chosen after the miss case has left.
      bool hit[8];
      bool any = false;
#pragma unroll
      for (int d = 0; d < 8; d++) {
        if (d < W) {
          bool ok = ent[d] < ip + d && ld.window(ent[d]) == cur[d];
#pragma unroll
          for (int i = 0; i < d; i++) ok = ok || cur[i] == cur[d];
          hit[d] = ok;
          any = any || ok;
        }
      }
      if (!any) return -1;
      int d_first = -1;
#pragma unroll
      for (int d = 0; d < 8; d++) {
        if (d < W && d_first < 0 && hit[d]) {
          int32_t cand = ent[d];
#pragma unroll
          for (int i = 0; i < d; i++) {
            if (cur[i] == cur[d]) cand = ip + i;
          }
          cand_first = cand;
          d_first = d;
        }
      }
      return d_first;
    }
    int d_first = -1;
#pragma unroll
    for (int d = 0; d < 8; d++) {
      if (d < W && d_first < 0) {
        bool ok = ent[d] != EMPTY && ent[d] < ip + d && ld.window(ent[d]) == cur[d];
        int32_t cand = ok ? ent[d] : 0;
#pragma unroll
        for (int i = 0; i < d; i++) {
          if (cur[i] == cur[d]) {  // the nearest earlier equal key wins
            cand = ip + i;
            ok = true;
          }
        }
        if (ok) {
          cand_first = cand;
          d_first = d;
        }
      }
    }
    return d_first;
  };
  // Extension, tail, emission and the seeding after it; returns the match
  // end and moves op.
  auto on_hit = [&](int32_t at, int32_t cand, int32_t lit_start, int32_t& op) {
    int32_t steps = 0;
    int32_t m = variant_extend(mk & EV_EXT_MASK, key, seed, at, cand, n, steps);
    if (mk & EV_XOR_TAIL) {
      uint32_t x = key(at + m) ^ key(cand + m);
      m += x == 0 ? 3 : ((x & 0xFFu) == 0) + ((x & 0xFFFFu) == 0) + ((x & 0xFFFFFFu) == 0);
    } else {
      for (int t = 0; t < 3 && at + m < n && ld.byte(at + m) == ld.byte(cand + m); t++) m++;
    }
    if (m > n - at) m = n - at;
    stats.hit(steps, m);
    int32_t end = at + m;
    if (mk & EV_EMIT_HITS) {
      op += 2;
    } else {
      op = em.literal(op, lit_start, at);
      op = em.copy(op, at - cand, m);
    }
    if (mk & EV_POST_SEED) {
      int32_t stop = end < n - 4 ? end : n - 4;
      for (int32_t p = at + 1; p + 3 <= stop; p += 4) seed(p);
    }
    return end;
  };

  int32_t ip = n < 1 ? n : 1;
  int32_t lit_start = 0;
  int32_t op = 0;
  int32_t skip = skip_base;
  uint32_t cur[8], h[8];
  int32_t cand = 0;
  if (mk & EV_LOOP_TWO) {
    while (ip + margin < n) {
      int d = -1;
      while (d < 0 && ip + margin < n) {  // misses only: probe and advance
        loads_at(ip, cur, h);
        d = probe(ip, cur, h, cand);
        if (d < 0) {
          ip += miss_step(skip);
          stats.miss();
        }
        skip += skip_inc;
      }
      if (d >= 0) {  // the hit work, once per outer step
        ip = on_hit(ip + d, cand, lit_start, op);
        lit_start = ip;
        skip = skip_base;
      }
    }
  } else if (mk & EV_LOOP_PRE) {
    uint32_t ncur[8], nh[8];
    loads_at(ip, cur, h);
    while (ip + margin < n) {
      int32_t ipm = ip + miss_step(skip);
      loads_at(ipm, ncur, nh);  // the next miss position, before this group resolves
      int d = probe(ip, cur, h, cand);
      if (d < 0) {
        ip = ipm;
        skip += skip_inc;
        stats.miss();
#pragma unroll
        for (int i = 0; i < 8; i++) {
          if (i < W) {
            cur[i] = ncur[i];
            h[i] = nh[i];
          }
        }
      } else {
        ip = on_hit(ip + d, cand, lit_start, op);
        lit_start = ip;
        skip = skip_base;
        loads_at(ip, cur, h);
      }
    }
  } else {
    while (ip + margin < n) {
      loads_at(ip, cur, h);
      int d = probe(ip, cur, h, cand);
      if (d < 0) {
        ip += miss_step(skip);
        skip += skip_inc;
        stats.miss();
        continue;
      }
      ip = on_hit(ip + d, cand, lit_start, op);
      lit_start = ip;
      skip = skip_base;
    }
  }
  if (!(mk & EV_EMIT_HITS)) op = em.literal(op, lit_start, n);
  return op;
}

template <class Ld, class Cfg>
SC_HD int32_t encode_fragment_variant(const Ld& ld, int32_t n, uint16_t* table, Cfg cfg,
                                      uint8_t* out) {
  NoStats none;
  return encode_fragment_variant(ld, n, table, cfg, out, none);
}

}  // namespace sc

namespace ev {

// Where one fragment's walk goes (encode_variant_row's sink). BodyOut: the
// tag stream into the body's row and its length (encode_variants.cu,
// encode_r4.cu); a fragment that is not walked (EV_DMA_ONLY, EV_NOSCAN)
// gives its length and the XOR of its words, stored in the 4 bytes after
// the length, which a body leaves unspecified. StatsOut: the walk's budget
// (encode_stats.cu), miss iterations, hits, extension iterations and
// matched bytes; a fragment that is not walked counts nothing.
struct BodyOut {
  uint8_t* row;
  int32_t* len;
  template <class Ld, class Cfg>
  SC_HD void walk(const Ld& ld, int32_t n, uint16_t* table, Cfg cfg) const {
    *len = sc::encode_fragment_variant(ld, n, table, cfg, row);
  }
  SC_HD void no_walk(int32_t length, uint32_t acc) const {
    for (int j = 0; j < 4; j++) row[length + j] = (uint8_t)(acc >> (8 * j));
    *len = length;
  }
};

struct StatsOut {
  int32_t* counts;
  template <class Ld, class Cfg>
  SC_HD void walk(const Ld& ld, int32_t n, uint16_t* table, Cfg cfg) const {
    sc::WalkStats st;
    sc::encode_fragment_variant(ld, n, table, cfg, nullptr, st);
    counts[0] = st.miss_iters;
    counts[1] = st.hits;
    counts[2] = st.ext_iters;
    counts[3] = st.match_bytes;
  }
  SC_HD void no_walk(int32_t, uint32_t) const {
    for (int j = 0; j < 4; j++) counts[j] = 0;
  }
};

// A batch's sinks: row b's body and length, or its four counts.
struct BodyRows {
  uint8_t* bodies;
  int64_t body_w;
  int32_t* lens;
  SC_HD BodyOut at(int64_t b) const { return {bodies + b * body_w, lens + b}; }
};

struct StatsRows {
  int32_t* stats;  // int32[B, 4]
  SC_HD StatsOut at(int64_t b) const { return {stats + 4 * b}; }
};

// encode_stats.cu's walk: EV_STATS_WALK at the production 15 hash bits,
// every probe position stored.
constexpr sc::StaticWalk<sc::EV_STATS_WALK> kStatsWalk{15, 1};

}  // namespace ev

#ifdef __CUDACC__
#include "smem_config.cuh"

// The kernel, its launch and its layout query, shared by encode_variants.cu,
// encode_r4.cu and encode_stats.cu: encode.cu's layout. One block of one
// warp per fragment; only the match table (1 << hash_bits 16-bit slots)
// lives in dynamic shared memory, so 3 blocks fit an SM at 15 hash bits and
// 6 at 14. The warp clears the table, then lane 0 walks, reading the
// fragment through the read-only path (sc::RowWords where base and width
// are multiples of 16, else sc::RowBytes), and hands the result to the
// row's sink (BodyOut stores the tags straight into the body's row,
// StatsOut the four counts).
namespace ev {

constexpr int kThreads = 32;

SC_HD size_t table_bytes(int hash_bits) { return sizeof(uint16_t) << hash_bits; }

// One fragment on one warp. The variants without a walk (EV_DMA_ONLY: length
// n, EV_NOSCAN: length 0) time what their TPU kernels time, the fragment
// brought on chip: the warp reads the fragment's words once through the
// loader and the sink gets their XOR; BodyOut stores it with no condition,
// so the compiler keeps the loads.
template <class Cfg, class Ld, class Out>
__device__ void encode_variant_row(const Ld& ld, int32_t n, uint16_t* table, Cfg cfg,
                                   const Out& out) {
  const uint32_t mk = cfg.mask();
  if (mk & (sc::EV_DMA_ONLY | sc::EV_NOSCAN)) {
    uint32_t acc = 0;
    for (int32_t k = threadIdx.x; 4 * k < n; k += kThreads) acc ^= ld.word(k);
    for (int o = 16; o > 0; o >>= 1) acc ^= __shfl_xor_sync(0xFFFFFFFFu, acc, o);
    if (threadIdx.x == 0) out.no_walk((mk & sc::EV_DMA_ONLY) ? n : 0, acc);
    return;
  }
  uint4* t4 = reinterpret_cast<uint4*>(table);
  const int words = (int)(table_bytes(cfg.hash_bits) / sizeof(uint4));
  const uint4 empty = make_uint4(0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu);
  for (int w = threadIdx.x; w < words; w += kThreads) t4[w] = empty;
  __syncwarp();
  if (threadIdx.x == 0) out.walk(ld, n, table, cfg);
}

template <class Cfg, bool kWords, class Rows>
__global__ void __launch_bounds__(kThreads)
    encode_variant_kernel(const uint8_t* __restrict__ frags, int64_t frag_w,
                          const int32_t* __restrict__ lengths, Cfg cfg, Rows rows) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint16_t* table = reinterpret_cast<uint16_t*>(smem);
  const int64_t b = blockIdx.x;
  int32_t n = lengths[b];
  n = n < 0 ? 0 : (n > frag_w ? (int32_t)frag_w : n);
  const uint8_t* row = frags + b * frag_w;
  if (kWords) {
    encode_variant_row(sc::RowWords{reinterpret_cast<const uint32_t*>(row), n}, n, table, cfg,
                       rows.at(b));
  } else {
    encode_variant_row(sc::RowBytes{row, n}, n, table, cfg, rows.at(b));
  }
}

// Each instantiation's attributes, set per device (smem_config.cuh).
template <class Cfg, bool kWords, class Rows>
attrs::SetFor& set_for() {
  static attrs::SetFor s;
  return s;
}

// Runs fn with the kernel's shared-memory attributes set on the current
// device for a table of cfg.hash_bits, under the lock that orders them with
// every other launch of the kernel.
template <class Cfg, bool kWords, class Rows, class Fn>
cudaError_t configured(Cfg cfg, Fn fn) {
  return attrs::configure_and_launch(encode_variant_kernel<Cfg, kWords, Rows>,
                                     table_bytes(cfg.hash_bits), set_for<Cfg, kWords, Rows>(),
                                     fn);
}

template <class Cfg, bool kWords, class Rows>
int launch_rows(Cfg cfg, const void* frags, int64_t frag_w, const void* lengths, int64_t batch,
                Rows rows, void* stream) {
  const size_t smem = table_bytes(cfg.hash_bits);
  return (int)configured<Cfg, kWords, Rows>(cfg, [&] {
    encode_variant_kernel<Cfg, kWords, Rows>
        <<<(unsigned)batch, kThreads, smem, (cudaStream_t)stream>>>(
            (const uint8_t*)frags, frag_w, (const int32_t*)lengths, cfg, rows);
    return cudaGetLastError();
  });
}

// frags: uint8[B, frag_w], any address and width; lengths: int32[B]; rows:
// the B sinks (BodyRows: bodies uint8[B, body_w], body_w at least frag_w + 4
// and the bound of greedy emission plus 3 bytes, and int32[B] lengths;
// StatsRows: int32[B, 4]).
template <class Cfg, class Rows>
int launch(Cfg cfg, const void* frags, int64_t frag_w, const void* lengths, int64_t batch,
           Rows rows, void* stream) {
  if (batch == 0) return 0;
  return sc::word_rows(frags, frag_w)
             ? launch_rows<Cfg, true>(cfg, frags, frag_w, lengths, batch, rows, stream)
             : launch_rows<Cfg, false>(cfg, frags, frag_w, lengths, batch, rows, stream);
}

template <class Cfg, bool kWords, class Rows>
int layout_rows(Cfg cfg, int32_t* out) {
  const size_t smem = table_bytes(cfg.hash_bits);
  int nb = 0;
  cudaError_t e = configured<Cfg, kWords, Rows>(cfg, [&] {
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &nb, encode_variant_kernel<Cfg, kWords, Rows>, kThreads, smem);
  });
  out[0] = nb;
  out[1] = (int32_t)smem;
  out[2] = kThreads;
  out[3] = kWords ? 1 : 0;
  return (int)e;
}

// The layout of launch() with sinks of type Rows for rows at frags of width
// frag_w: out[0] blocks per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor
// under the attributes the launch sets), out[1] dynamic shared bytes per
// block, out[2] threads per block, out[3] 1 for the word loader and 0 for
// the byte loader.
template <class Rows, class Cfg>
int layout(Cfg cfg, const void* frags, int64_t frag_w, int32_t* out) {
  return sc::word_rows(frags, frag_w) ? layout_rows<Cfg, true, Rows>(cfg, out)
                                      : layout_rows<Cfg, false, Rows>(cfg, out);
}

}  // namespace ev
#endif  // __CUDACC__
