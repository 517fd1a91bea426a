// Per-block Snappy walks shared by the CUDA kernels (decode.cu, encode.cu,
// encode_best.cu, probe.cu) and, compiled by a host C++ compiler, by the
// tests that hold the walks against the JAX reference on a machine without
// a GPU.
//
// The walks are byte-serial state machines over one <= 64 KiB block, so
// they are written once as __host__ __device__ functions: the CUDA kernels
// give them shared-memory buffers and a lane index, a host build gives them
// plain arrays and lane 0 of 1.
//
// The bytes they produce are the contract of the JAX scalar kernels in
// snappier_tpu/ops/pallas/scalar_codec.py (_decode_kernel, _encode_kernel in
// fast and best mode, _probe_kernel): the same (out[:out_len], out_len, err)
// triple from the decoder, the same tag streams from the encoders and the
// same match lengths from the extension walk.
#pragma once

#include <stdint.h>
#include <string.h>

#ifndef __CUDACC__
#define __host__
#define __device__
#endif

#define SC_HD __host__ __device__ inline

namespace sc {

// Error words of the decode walk (snappier_tpu/ops/decode.py:51-54). The
// walk reports every mid-stream failure as the combined MALFORMED word, as
// the JAX scalar kernel does (scalar_codec.py:57).
constexpr int32_t ERR_TRUNCATED_TAG = 1;
constexpr int32_t ERR_BAD_OFFSET = 2;
constexpr int32_t ERR_LENGTH_MISMATCH = 4;
constexpr int32_t ERR_BAD_PREAMBLE = 8;
constexpr int32_t ERR_MALFORMED =
    ERR_TRUNCATED_TAG | ERR_BAD_OFFSET | ERR_LENGTH_MISMATCH;

constexpr int32_t INPUT_MARGIN = 15;      // Constants.cs:27
constexpr uint32_t HASH_MUL = 0x1E35A7BDu;  // HashTable.cs magic multiply
constexpr uint16_t EMPTY = 0xFFFF;        // empty match-table slot

struct DecodeResult {
  int32_t out_len;
  int32_t err;
};

// Decode one Snappy block: varint preamble, then the tag walk.
//
// comp holds cc bytes; bytes at or past cc read as zero (the JAX key image
// pads the same way). n is the block's compressed length, out_cap the
// caller's capacity: a preamble claiming more is ERR_BAD_PREAMBLE. out must
// hold out_cap bytes; bytes past out_len are left as they are.
//
// Every lane of a group runs the same walk on the same input, so the
// control flow stays uniform; lanes split each tag's payload bytes, and
// sync() orders one tag's stores before the next tag's copy reads them.
template <class Sync>
SC_HD DecodeResult decode_block(const uint8_t* comp, int64_t cc, int32_t n,
                                int32_t out_cap, uint8_t* out, int lane,
                                int nlanes, Sync sync) {
  auto rd = [&](int64_t i) -> uint32_t {
    return (i >= 0 && i < cc) ? (uint32_t)comp[i] : 0u;
  };

  // Varint preamble (VarIntEncoding.Read.cs semantics, scalar_codec.py
  // :217-239): at most 5 bytes, the 5th below 8.
  int32_t pre_len = 0;
  uint32_t val = 0;
  bool done = false;
  int32_t err = 0;
  while (!done && pre_len < 5 && err == 0) {
    uint32_t byte = rd(pre_len);
    int sh = 7 * pre_len < 28 ? 7 * pre_len : 28;
    val |= (byte & 0x7Fu) << sh;
    done = byte < 0x80u;
    if (pre_len == 4 && byte >= 8u) err = ERR_BAD_PREAMBLE;
    pre_len++;
  }
  int32_t expected = (int32_t)val;
  if (!done) err = ERR_BAD_PREAMBLE;
  if (pre_len > n) err = ERR_BAD_PREAMBLE;
  if (expected > out_cap) err = ERR_BAD_PREAMBLE;
  if (expected < 0) err = ERR_BAD_PREAMBLE;

  int32_t op = 0;
  if (err == 0) {
    int64_t ip = pre_len;
    bool bad = false;
    while (ip < n) {
      uint32_t tag = rd(ip);
      uint32_t rest =
          rd(ip + 1) | (rd(ip + 2) << 8) | (rd(ip + 3) << 16) | (rd(ip + 4) << 24);
      uint32_t tt = tag & 3u;
      int32_t hdr;
      int32_t length;
      int32_t off = 0;
      bool is_lit = tt == 0;
      if (tt == 0) {
        uint32_t l6 = tag >> 2;
        if (l6 < 60) {
          hdr = 1;
          length = (int32_t)l6 + 1;
        } else {
          // 1..4 little-endian length bytes; a 4-byte field keeps all 32
          // bits and wraps exactly as the int32 reference does.
          int32_t extra = (int32_t)l6 - 59;
          uint32_t lm = extra < 4 ? ((1u << (8 * extra)) - 1u) : 0xFFFFFFFFu;
          hdr = 1 + extra;
          length = (int32_t)((rest & lm) + 1u);
        }
      } else if (tt == 1) {
        hdr = 2;
        length = (int32_t)((tag >> 2) & 7u) + 4;
        off = (int32_t)(((tag >> 5) << 8) | (rest & 0xFFu));
      } else if (tt == 2) {
        hdr = 3;
        length = (int32_t)(tag >> 2) + 1;
        off = (int32_t)(rest & 0xFFFFu);
      } else {
        hdr = 5;
        length = (int32_t)(tag >> 2) + 1;
        off = (int32_t)rest;  // a 4th offset byte >= 0x80 is negative: bad
      }
      int64_t ip2 = ip + hdr + (is_lit ? (int64_t)length : 0);
      // One unsigned compare rejects lengths past the remaining output,
      // negative lengths and the length-0 wrap (scalar_codec.py:409-424).
      bool b = ip2 > n ||
               (uint32_t)length - 1u >= (uint32_t)expected - (uint32_t)op;
      if (!is_lit && (off <= 0 || off > op)) b = true;
      if (b) {
        bad = true;
        break;
      }
      if (is_lit) {
        int64_t src = ip + hdr;
        for (int32_t i = lane; i < length; i += nlanes) out[op + i] = (uint8_t)rd(src + i);
      } else if (off >= length) {
        const uint8_t* s = out + (op - off);
        for (int32_t i = lane; i < length; i += nlanes) out[op + i] = s[i];
      } else {
        // Overlapping copy: byte op+i repeats byte op-off+(i mod off), which
        // is what a forward byte-serial copy (IncrementalCopy) produces.
        const uint8_t* s = out + (op - off);
        for (int32_t i = lane; i < length; i += nlanes) out[op + i] = s[i % off];
      }
      sync();
      op += length;
      ip = ip2;
    }
    if (bad || ip != n) {
      err = ERR_MALFORMED;
    } else if (op != expected) {
      err = ERR_LENGTH_MISMATCH;
    }
  }
  DecodeResult r;
  r.err = err;
  r.out_len = err == 0 ? expected : 0;
  return r;
}

// ---------------------------------------------------------------------------
// Encoder
// ---------------------------------------------------------------------------

// Unaligned little-endian 32-bit window at byte i.
SC_HD uint32_t load32(const uint8_t* s, int32_t i) {
  return (uint32_t)s[i] | ((uint32_t)s[i + 1] << 8) | ((uint32_t)s[i + 2] << 16) |
         ((uint32_t)s[i + 3] << 24);
}

SC_HD uint32_t hash32(uint32_t key, int hash_bits) {
  return (key * HASH_MUL) >> (32 - hash_bits);
}

// The low 32 bits of (hi:lo) >> sh, sh in [0, 31].
SC_HD uint32_t funnel_r(uint32_t lo, uint32_t hi, uint32_t sh) {
#ifdef __CUDA_ARCH__
  return __funnelshift_r(lo, hi, sh);
#else
  return (uint32_t)(((((uint64_t)hi) << 32) | lo) >> (sh & 31));
#endif
}

// Of word n >> 2 of a fragment of n bytes, the bytes below n (none when n
// is a multiple of 4).
SC_HD uint32_t tail_mask(int32_t n) { return (1u << (8 * (n & 3))) - 1u; }

// Fragment loaders of the greedy walk. word(k) is the little-endian 32-bit
// word of bytes 4k .. 4k + 3 and window(i) the one of bytes i .. i + 3;
// bytes at or past n read as zero, and no loader reads a byte at or past n
// of its row, so the last row of a batch may end where its buffer ends.
// word_in(k) is word(k) for a caller that knows all four bytes lie below
// n: one load, no test.

// A row in device memory whose base is 4-byte aligned, read as aligned
// words through the read-only path: a window is two word loads and a
// funnel shift. A word holding byte n - 1 is read whole, so the row's
// width must be a multiple of 4.
struct RowWords {
  const uint32_t* w;
  int32_t n;
  uint32_t tail;
  SC_HD RowWords(const uint32_t* w_, int32_t n_) : w(w_), n(n_), tail(tail_mask(n_)) {}
  SC_HD uint32_t word_in(int32_t k) const {
#ifdef __CUDA_ARCH__
    return __ldg(w + k);
#else
    uint32_t v;
    memcpy(&v, w + k, 4);
    return v;
#endif
  }
  SC_HD uint32_t word(int32_t k) const {
    uint32_t v = 4 * k < n ? word_in(k) : 0u;
    return k == (n >> 2) ? v & tail : v;
  }
  SC_HD uint32_t window(int32_t i) const {
    return funnel_r(word(i >> 2), word((i >> 2) + 1), 8u * (uint32_t)(i & 3));
  }
};

// A row in device memory at any address and width, read a byte at a time.
struct RowBytes {
  const uint8_t* p;
  int32_t n;
  SC_HD RowBytes(const uint8_t* p_, int32_t n_) : p(p_), n(n_) {}
  SC_HD uint32_t ld(int32_t i) const {
#ifdef __CUDA_ARCH__
    return (uint32_t)__ldg(p + i);
#else
    return (uint32_t)p[i];
#endif
  }
  SC_HD uint32_t byte(int32_t i) const { return i < n ? ld(i) : 0u; }
  SC_HD uint32_t word_in(int32_t k) const {
    int32_t i = 4 * k;
    return ld(i) | (ld(i + 1) << 8) | (ld(i + 2) << 16) | (ld(i + 3) << 24);
  }
  SC_HD uint32_t window(int32_t i) const {
    return byte(i) | (byte(i + 1) << 8) | (byte(i + 2) << 16) | (byte(i + 3) << 24);
  }
  SC_HD uint32_t word(int32_t k) const { return window(4 * k); }
};

// Full match length at `at` against `cand` (whose first 4 bytes equal), in
// [4, n - at]: the stride-8 walk of scalar_codec.py::_match_extension.
// key(i) is the little-endian 32-bit window at byte i; seed(pos) runs at
// pos = at + 4 and at each stride-8 step before its compare, where the fast
// encoder writes its table.
//
// extend_match_from continues the walk from its state after the first
// step (m, go and the last step's first compare, eq0l), for a caller that
// made that step from words it already holds.
template <class Key, class Seed>
SC_HD int32_t extend_match_from(Key key, int32_t at, int32_t cand, int32_t n, Seed seed,
                                int32_t m, bool go, bool eq0l) {
  while (go && at + m + 8 <= n) {
    seed(at + m);
    bool eq0 = key(at + m) == key(cand + m);
    bool eq1 = key(at + m + 4) == key(cand + m + 4);
    m += 8;
    go = eq0 && eq1;
    eq0l = eq0;
  }
  if (!go) m = m - 8 + (eq0l ? 4 : 0);
  if (go && at + m + 4 <= n && key(at + m) == key(cand + m)) m += 4;
  uint32_t x = key(at + m) ^ key(cand + m);
  if (x == 0) {
    m += 3;
  } else {
    m += ((x & 0xFFu) == 0) + ((x & 0xFFFFu) == 0) + ((x & 0xFFFFFFu) == 0);
  }
  return m < n - at ? m : n - at;
}

template <class Key, class Seed>
SC_HD int32_t extend_match(Key key, int32_t at, int32_t cand, int32_t n, Seed seed) {
  if (at + 12 > n) return extend_match_from(key, at, cand, n, seed, 4, true, true);
  seed(at + 4);
  bool eq0w = key(at + 4) == key(cand + 4);
  bool eq1w = key(at + 8) == key(cand + 8);
  return extend_match_from(key, at, cand, n, seed, 12, eq0w && eq1w, eq0w);
}

// extend_match over a staged fragment s. With a table it seeds
// table[hash(p)] = p, p = min(pos - 3, n - 5), so the table ends up as the
// reference's does; table == nullptr seeds nothing (best mode, the probe).
SC_HD int32_t match_extension(const uint8_t* s, int32_t at, int32_t cand, int32_t n,
                              uint16_t* table, int hash_bits) {
  return extend_match([&](int32_t i) { return load32(s, i); }, at, cand, n,
                      [&](int32_t pos) {
                        if (table == nullptr) return;
                        int32_t p = pos - 3 < n - 5 ? pos - 3 : n - 5;
                        table[hash32(load32(s, p), hash_bits)] = (uint16_t)p;
                      });
}

// The probe's walk over a row of cc bytes that need not be padded: bytes
// outside [0, cc) read as zero, as the JAX key image's zero slack does
// (scalar_codec.py:742). Never reads outside the row.
SC_HD int32_t match_extension_row(const uint8_t* row, int64_t cc, int32_t at, int32_t cand,
                                  int32_t n) {
  auto byte = [&](int64_t i) -> uint32_t {
    return (i >= 0 && i < cc) ? (uint32_t)row[i] : 0u;
  };
  return extend_match(
      [&](int32_t i) {
        return byte(i) | (byte((int64_t)i + 1) << 8) | (byte((int64_t)i + 2) << 16) |
               (byte((int64_t)i + 3) << 24);
      },
      at, cand, n, [](int32_t) {});
}

// Literal tag + payload (SnappyCompressor.cs:417-464); lit_len >= 1.
SC_HD int32_t emit_literal(uint8_t* out, int32_t op, const uint8_t* s, int32_t start,
                           int32_t lit_len) {
  int32_t lm1 = lit_len - 1;
  int32_t extra = lit_len > 256 ? 2 : (lit_len > 60 ? 1 : 0);
  out[op] = (uint8_t)(extra == 0 ? lm1 << 2 : (59 + extra) << 2);
  if (extra >= 1) out[op + 1] = (uint8_t)(lm1 & 0xFF);
  if (extra == 2) out[op + 2] = (uint8_t)((lm1 >> 8) & 0xFF);
  op += 1 + extra;
  for (int32_t i = 0; i < lit_len; i++) out[op + i] = s[start + i];
  return op + lit_len;
}

// One copy tag of length 4..64 (SnappyCompressor.cs:466-505).
SC_HD int32_t emit_copy_upto64(uint8_t* out, int32_t op, int32_t off, int32_t len) {
  if (len <= 11 && off < 2048) {
    out[op] = (uint8_t)(1 | ((len - 4) << 2) | ((off >> 8) << 5));
    out[op + 1] = (uint8_t)(off & 0xFF);
    return op + 2;
  }
  out[op] = (uint8_t)(2 | ((len - 1) << 2));
  out[op + 1] = (uint8_t)(off & 0xFF);
  out[op + 2] = (uint8_t)((off >> 8) & 0xFF);
  return op + 3;
}

// Repeated 64s with the 64 < len < 68 split (SnappyCompressor.cs:507-543).
SC_HD int32_t emit_copy(uint8_t* out, int32_t op, int32_t off, int32_t len) {
  while (len >= 68) {
    op = emit_copy_upto64(out, op, off, 64);
    len -= 64;
  }
  if (len > 64) {
    op = emit_copy_upto64(out, op, off, 60);
    len -= 60;
  }
  return emit_copy_upto64(out, op, off, len);
}

// A copy tag of length 4..64 that always stores 3 bytes; the third is
// overwritten by the next tag when the tag has 2, or lies past the stream.
SC_HD int32_t emit_copy_upto64_bfree(uint8_t* out, int32_t op, int32_t off, int32_t len) {
  bool is1 = len <= 11 && off < 2048;
  out[op] = (uint8_t)(is1 ? (1 | ((len - 4) << 2) | ((off >> 8) << 5)) : (2 | ((len - 1) << 2)));
  out[op + 1] = (uint8_t)(off & 0xFF);
  out[op + 2] = (uint8_t)((off >> 8) & 0xFF);
  return op + (is1 ? 2 : 3);
}

// emit_copy's tags through emit_copy_upto64_bfree.
SC_HD int32_t emit_copy_bfree(uint8_t* out, int32_t op, int32_t off, int32_t len) {
  while (len >= 68) {
    op = emit_copy_upto64_bfree(out, op, off, 64);
    len -= 64;
  }
  if (len > 64) {
    op = emit_copy_upto64_bfree(out, op, off, 60);
    len -= 60;
  }
  return emit_copy_upto64_bfree(out, op, off, len);
}

// emit_literal with the payload read through a fragment loader, one word
// and four byte stores at a time: up to 3 bytes past the literal are
// stored too, which the next tag overwrites or which lie past the stream.
template <class Ld, class = decltype(&Ld::word)>
SC_HD int32_t emit_literal(uint8_t* out, int32_t op, const Ld& ld, int32_t start,
                           int32_t lit_len) {
  int32_t lm1 = lit_len - 1;
  int32_t extra = lit_len > 256 ? 2 : (lit_len > 60 ? 1 : 0);
  out[op] = (uint8_t)(extra == 0 ? lm1 << 2 : (59 + extra) << 2);
  if (extra >= 1) out[op + 1] = (uint8_t)(lm1 & 0xFF);
  if (extra == 2) out[op + 2] = (uint8_t)((lm1 >> 8) & 0xFF);
  op += 1 + extra;
  int32_t k = start >> 2;
  const uint32_t sh = 8u * (uint32_t)(start & 3);
  uint32_t lo = ld.word(k);
  for (int32_t i = 0; i < lit_len; i += 4) {
    uint32_t hi = ld.word(++k);
    uint32_t v = funnel_r(lo, hi, sh);
    out[op + i] = (uint8_t)v;
    out[op + i + 1] = (uint8_t)(v >> 8);
    out[op + i + 2] = (uint8_t)(v >> 16);
    out[op + i + 3] = (uint8_t)(v >> 24);
    lo = hi;
  }
  return op + lit_len;
}

// Greedy LZ77 over one fragment of n bytes read through a loader (RowWords,
// RowBytes); returns the tag stream's length.
//
// table holds 1 << hash_bits slots, all EMPTY on entry: a fresh table is
// what the reference's epoch-tagged table amounts to, since every slot
// another block wrote fails its epoch check (scalar_codec.py:813-816).
// Positions stay below 65536, so a slot is 16 bits and EMPTY is never a
// position (ip + 3 < n - 12). out holds the bound of greedy emission plus
// 3 bytes: a literal's payload and a copy tag may store up to 3 bytes past
// their end (emit_literal above, emit_copy_bfree).
//
// The probe group is unrolled so that every array lives in registers.
// Five words cover ip .. ip + 16 and give a[j], the window at ip + 4j, so
// each position's key, the windows of the first extension step and the
// seed after it are funnel shifts by constants. A candidate's four words,
// loaded at once, give its verify and its side of the first extension
// step, so a hit costs three dependent loads before the extension: the
// words at ip, the table slots, the candidate's words.
template <class Ld, class = decltype(&Ld::word_in)>
SC_HD int32_t encode_fragment(const Ld& ld, int32_t n, uint16_t* table, int hash_bits,
                              int32_t skip_base, uint8_t* out) {
  auto key = [&](int32_t i) { return ld.window(i); };
  auto seed = [&](int32_t pos) {
    int32_t p = pos - 3 < n - 5 ? pos - 3 : n - 5;
    table[hash32(ld.window(p), hash_bits)] = (uint16_t)p;
  };
  int32_t ip = n < 1 ? n : 1;
  int32_t lit_start = 0;
  int32_t op = 0;
  int32_t skip = skip_base;
  while (ip + INPUT_MARGIN < n) {
    // Quad probe (scalar_codec.py:1007-1043): read four slots, then write
    // them in order (the last write wins on a collision), then take the
    // first position whose candidate verifies. Words k .. k + 3 end at
    // ip + 15 at most, below n; word k + 4 may pass it.
    const int32_t k = ip >> 2;
    uint32_t w[5], a[4], cur[4], h[4];
    int32_t ent[4];
#pragma unroll
    for (int j = 0; j < 4; j++) w[j] = ld.word_in(k + j);
    w[4] = ld.word(k + 4);
#pragma unroll
    for (int j = 0; j < 4; j++) a[j] = funnel_r(w[j], w[j + 1], 8u * (uint32_t)(ip & 3));
#pragma unroll
    for (int d = 0; d < 4; d++) {
      cur[d] = funnel_r(a[0], a[1], 8u * d);
      h[d] = hash32(cur[d], hash_bits);
    }
#pragma unroll
    for (int d = 0; d < 4; d++) ent[d] = table[h[d]];
#pragma unroll
    for (int d = 0; d < 4; d++) table[h[d]] = (uint16_t)(ip + d);
    bool found = false;
    int32_t at = 0, cand = 0;
    uint32_t at4 = 0, at8 = 0, c4 = 0, c8 = 0, s1 = 0;
#pragma unroll
    for (int d = 0; d < 4; d++) {
      if (found) continue;
      int32_t eq = -1;  // the nearest earlier position with an equal key wins
#pragma unroll
      for (int i = 0; i < d; i++) {
        if (cur[i] == cur[d]) eq = i;
      }
      if (eq >= 0) {
        found = true;
        cand = ip + eq;
        c4 = funnel_r(a[1], a[2], 8u * (uint32_t)eq);
        c8 = funnel_r(a[2], a[3], 8u * (uint32_t)eq);
      } else if (ent[d] < ip + d) {  // EMPTY fails: ip + d < 65536 - 12
        // The candidate's words: bytes up to ent + 11 <= ip + 13 lie below
        // n, the fourth word may pass it.
        const int32_t e = ent[d];
        const uint32_t csh = 8u * (uint32_t)(e & 3);
        uint32_t c0 = ld.word_in(e >> 2), c1 = ld.word_in((e >> 2) + 1);
        uint32_t c2 = ld.word_in((e >> 2) + 2), c3 = ld.word((e >> 2) + 3);
        if (funnel_r(c0, c1, csh) == cur[d]) {
          found = true;
          cand = e;
          c4 = funnel_r(c1, c2, csh);
          c8 = funnel_r(c2, c3, csh);
        }
      }
      if (found) {
        at = ip + d;
        at4 = funnel_r(a[1], a[2], 8u * d);
        at8 = funnel_r(a[2], a[3], 8u * d);
        s1 = d < 3 ? funnel_r(a[0], a[1], 8u * (d + 1)) : a[1];
      }
    }
    if (!found) {
      ip += 3 + (skip >> 5);
      skip += 1;
      continue;
    }
    // extend_match's first step from the words in hand (at + 12 <= n here):
    // the seed at pos = at + 4 stores at + 1, then two compares.
    table[hash32(s1, hash_bits)] = (uint16_t)(at + 1);
    bool eq0 = at4 == c4;
    int32_t m = extend_match_from(key, at, cand, n, seed, 12, eq0 && at8 == c8, eq0);
    if (at > lit_start) op = emit_literal(out, op, ld, lit_start, at - lit_start);
    op = emit_copy_bfree(out, op, at - cand, m);
    ip = at + m;
    lit_start = ip;
    skip = skip_base;
  }
  if (n > lit_start) op = emit_literal(out, op, ld, lit_start, n - lit_start);
  return op;
}

// The level="best" walk over one fragment of n bytes (scalar_codec.py
// :964-996); returns the tag stream's length.
//
// s as for encode_fragment. cands[i] is the one candidate for position i
// (ops/best_match.py::exact_candidates, nearest first), or EMPTY for none;
// the caller stores EMPTY for any candidate outside [0, i), which a correct
// candidate array never holds, so every hit copies from earlier bytes. A
// hit is a candidate whose first 4 bytes equal the position's; no table,
// no seeding, and a miss steps 1 + (skip >> 7).
SC_HD int32_t encode_fragment_best(const uint8_t* s, int32_t n, const uint16_t* cands,
                                   int32_t skip_base, uint8_t* out) {
  int32_t ip = n < 1 ? n : 1;
  int32_t lit_start = 0;
  int32_t op = 0;
  int32_t skip = skip_base;
  while (ip + INPUT_MARGIN < n) {
    int32_t c = cands[ip];
    if (c == EMPTY || load32(s, c) != load32(s, ip)) {
      ip += 1 + (skip >> 7);
      skip += 1;
      continue;
    }
    int32_t m = match_extension(s, ip, c, n, nullptr, 0);
    if (ip > lit_start) op = emit_literal(out, op, s, lit_start, ip - lit_start);
    op = emit_copy(out, op, ip - c, m);
    ip += m;
    lit_start = ip;
    skip = skip_base;
  }
  if (n > lit_start) op = emit_literal(out, op, s, lit_start, n - lit_start);
  return op;
}

}  // namespace sc
