// Per-block Snappy walks shared by the CUDA kernels (decode.cu, encode.cu)
// and, compiled by a host C++ compiler, by the tests that hold the walks
// against the JAX reference on a machine without a GPU.
//
// Both walks are byte-serial state machines over one <= 64 KiB block, so
// they are written once as __host__ __device__ functions: the CUDA kernels
// give them shared-memory buffers and a lane index, a host build gives them
// plain arrays and lane 0 of 1.
//
// The bytes they produce are the contract of the JAX scalar kernels in
// snappier_tpu/ops/pallas/scalar_codec.py (_decode_kernel, _encode_kernel in
// fast mode): the same (out[:out_len], out_len, err) triple from the decoder
// and the same tag stream from the encoder.
#pragma once

#include <stdint.h>

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

// Full match length at `at` against `cand` (whose first 4 bytes equal), in
// [4, n - at]: the stride-8 walk of scalar_codec.py::_match_extension with
// the same table seeding. Seeding writes table[hash(p)] = p with
// p = min(pos - 3, n - 5) at pos = at + 4 and at each stride-8 step before
// its compare, so the table ends up as the reference's does.
SC_HD int32_t match_extension(const uint8_t* s, int32_t at, int32_t cand, int32_t n,
                              uint16_t* table, int hash_bits) {
  auto seed = [&](int32_t pos) {
    if (table == nullptr) return;
    int32_t p = pos - 3 < n - 5 ? pos - 3 : n - 5;
    table[hash32(load32(s, p), hash_bits)] = (uint16_t)p;
  };
  bool has12 = at + 12 <= n;
  int32_t m = 4;
  bool go = true;
  bool eq0l = true;
  if (has12) {
    seed(at + 4);
    bool eq0w = load32(s, at + 4) == load32(s, cand + 4);
    bool eq1w = load32(s, at + 8) == load32(s, cand + 8);
    m = 12;
    go = eq0w && eq1w;
    eq0l = eq0w;
  }
  while (go && at + m + 8 <= n) {
    seed(at + m);
    bool eq0 = load32(s, at + m) == load32(s, cand + m);
    bool eq1 = load32(s, at + m + 4) == load32(s, cand + m + 4);
    m += 8;
    go = eq0 && eq1;
    eq0l = eq0;
  }
  if (!go) m = m - 8 + (eq0l ? 4 : 0);
  if (go && at + m + 4 <= n && load32(s, at + m) == load32(s, cand + m)) m += 4;
  uint32_t x = load32(s, at + m) ^ load32(s, cand + m);
  if (x == 0) {
    m += 3;
  } else {
    m += ((x & 0xFFu) == 0) + ((x & 0xFFFFu) == 0) + ((x & 0xFFFFFFu) == 0);
  }
  return m < n - at ? m : n - at;
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

// Greedy LZ77 over one fragment of n bytes; returns the tag stream's length.
//
// s holds the fragment followed by at least 4 readable bytes (their values
// never change the result). table holds 1 << hash_bits slots, all EMPTY on
// entry: a fresh table is what the reference's epoch-tagged table amounts
// to, since every slot another block wrote fails its epoch check
// (scalar_codec.py:813-816). Positions stay below 65536, so a slot is 16
// bits and EMPTY is never a position (ip + 3 < n - 12).
SC_HD int32_t encode_fragment(const uint8_t* s, int32_t n, uint16_t* table,
                              int hash_bits, int32_t skip_base, uint8_t* out) {
  int32_t ip = n < 1 ? n : 1;
  int32_t lit_start = 0;
  int32_t op = 0;
  int32_t skip = skip_base;
  while (ip + INPUT_MARGIN < n) {
    // Quad probe (scalar_codec.py:1007-1043): read four slots, then write
    // them in order (the last write wins on a collision), then take the
    // first position whose candidate verifies.
    uint32_t cur[4];
    uint32_t h[4];
    int32_t ent[4];
    for (int d = 0; d < 4; d++) {
      cur[d] = load32(s, ip + d);
      h[d] = hash32(cur[d], hash_bits);
    }
    for (int d = 0; d < 4; d++) ent[d] = table[h[d]];
    for (int d = 0; d < 4; d++) table[h[d]] = (uint16_t)(ip + d);
    int d_first = -1;
    int32_t cand_first = 0;
    for (int d = 0; d < 4 && d_first < 0; d++) {
      bool ok = ent[d] != EMPTY && ent[d] < ip + d && load32(s, ent[d]) == cur[d];
      int32_t cand = ok ? ent[d] : 0;
      for (int i = 0; i < d; i++) {
        if (cur[i] == cur[d]) {  // the nearest earlier equal key wins
          cand = ip + i;
          ok = true;
        }
      }
      if (ok) {
        d_first = d;
        cand_first = cand;
      }
    }
    if (d_first < 0) {
      ip += 3 + (skip >> 5);
      skip += 1;
      continue;
    }
    int32_t at = ip + d_first;
    int32_t m = match_extension(s, at, cand_first, n, table, hash_bits);
    if (at > lit_start) op = emit_literal(out, op, s, lit_start, at - lit_start);
    op = emit_copy(out, op, at - cand_first, m);
    ip = at + m;
    lit_start = ip;
    skip = skip_base;
  }
  if (n > lit_start) op = emit_literal(out, op, s, lit_start, n - lit_start);
  return op;
}

}  // namespace sc
