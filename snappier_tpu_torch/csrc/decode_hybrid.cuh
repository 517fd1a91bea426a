// The descriptor-driven decode (decode_hybrid.cu): the descriptors of the
// tag that would start at every byte position, computed by a pre-pass
// (spec_at, spec2_at), and the tag source that feeds them to the decode
// kernel's batched walk (sc::decode_block_batched), written once as
// __host__ __device__ functions: the CUDA kernels give them device memory
// and a warp, a host build gives them plain arrays and a warp of arrays.
//
// They compute what the decode kernels of tools/perf_probe_hybrid.py compute
// (_decode_kernel_v5, _v6, _v7): the (out[:out_len], out_len, err) triple of
// one Snappy block, out_len 0 on any error. A tag costs one descriptor load
// (two for form 7) instead of a parse:
//
//   kForm 5 (decode_v5, decode_v5_spec)  one word, spec_at: a literal's
//       adv:18 | hdr:3 << 18, a copy's off:16 | len:7 << 16 | (adv - 2):2 <<
//       23 | poison << 25 | 1 << 31. Error words as the TPU's chain of
//       wheres, the last true one winning (tag_error): 2 (the tag overruns
//       the input), 3 (copy offset 0 or beyond the output), 4 (a poisoned
//       literal), 3 (a poisoned copy), 4 (the tag overruns the claim). A
//       literal length that wraps to -4..-1 steps the output position back,
//       as on the TPU; the port refuses it with 4 where the position would go
//       below 0.
//   kForm 6 (decode_v6)  the same descriptors and checks; such a literal is
//       taken as empty. The TPU walk clamps a bad tag's append instead of
//       skipping it, to save a branch; its output is discarded all the same,
//       so this walk stops at the first bad tag as v5 does.
//   kForm 7 (decode_v7)  two words, spec2_at: spec0 = adv:18 | F:7 << 18 |
//       small << 30 | is_copy << 31, spec1 = the source relative to ip (a
//       literal) or op (a copy). One test per tag, error 4 for any bad tag;
//       a literal of -4..-1 bytes is taken as empty.
//
// All: 8 for a bad preamble (a claim above out_cap among them, where the
// TPU walks take up to owc * 4 - 1024 bytes and cut the row), 4 for a clean
// walk that ends short of the claim.
#pragma once

#include <type_traits>

#include "scalar_codec.cuh"

namespace hy {

constexpr int32_t ERR_TRUNC = 2;
constexpr int32_t ERR_OFF = 3;
constexpr int32_t ERR_LEN = 4;

// The error word of the form-5/6 tag of descriptor d at ip, after op output
// bytes of the claimed `expected`, n the block's length: 0 for a good tag.
template <int kForm>
SC_HD int32_t tag_error(int32_t d, int32_t ip, int32_t op, int32_t n, int32_t expected) {
  const uint32_t u = (uint32_t)d;
  const bool is_copy = d < 0;
  const int32_t hdr = (int32_t)((u >> 18) & 7u);
  const int32_t off = d & 0xFFFF;
  const int32_t adv = is_copy ? (int32_t)((u >> 23) & 3u) + 2 : d & 0x3FFFF;
  const int32_t length = is_copy ? (int32_t)((u >> 16) & 0x7Fu) : (d & 0x3FFFF) - hdr;
  int32_t e = ip + adv > n ? ERR_TRUNC : 0;
  if (is_copy && (off == 0 || off > op)) e = ERR_OFF;
  if (!is_copy && hdr >= 6) e = ERR_LEN;
  if (is_copy && ((u >> 25) & 1u)) e = ERR_OFF;
  if (op + length > expected) e = ERR_LEN;
  if (kForm == 5 && e == 0 && op + length < 0) e = ERR_LEN;
  return e;
}

// --- the pre-passes ---------------------------------------------------------

// Forms 5 and 6's descriptor of the tag that would start at a byte, from its
// bytes p .. p + 4 in the low 40 bits of v (bytes at or past the row's end
// zero): what tools/perf_probe_hybrid.py::_spec_from_comp computes there, in
// int32 arithmetic that wraps where XLA's does (the 4-byte literal length,
// b4 << 24 and the advance they give). A literal whose advance leaves (0,
// 2^18) is poisoned: 1 | 7 << 18.
SC_HD int32_t spec_at(uint64_t v) {
  const uint32_t b0 = (uint32_t)v & 0xFFu, b1 = (uint32_t)(v >> 8) & 0xFFu;
  const uint32_t b2 = (uint32_t)(v >> 16) & 0xFFu;
  const uint32_t tt = b0 & 3u, l6 = b0 >> 2;
  const uint32_t ext = l6 < 60u ? 0u : l6 - 59u, hdr = 1u + ext;
  const uint32_t field = (uint32_t)(v >> 8);  // bytes p + 1 .. p + 4
  const uint32_t litlen = ext == 0u ? l6 + 1u : sc::low_bytes(field, ext) + 1u;
  const int32_t adv_l = (int32_t)(hdr + litlen);
  if (tt == 0u) {
    return adv_l > 0 && adv_l < (1 << 18) ? (int32_t)((uint32_t)adv_l | hdr << 18) : 1 | 7 << 18;
  }
  const int32_t off4 = (int32_t)field;
  const uint32_t off =
      tt == 1u ? ((b0 >> 5) << 8) | b1 : tt == 2u ? b1 | (b2 << 8) : field & 0xFFFFu;
  const uint32_t len = tt == 1u ? (l6 & 7u) + 4u : l6 + 1u;
  const uint32_t advc = tt == 1u ? 0u : tt == 2u ? 1u : 3u;
  const uint32_t poison = tt == 3u && (off4 > 0xFFFF || off4 < 0);
  return (int32_t)(off | len << 16 | advc << 23 | poison << 25 | 0x80000000u);
}

// Form 7's descriptors of the tag that would start at a byte, from its
// bytes p .. p + 4 in the low 40 bits of v (bytes at or past the row's end
// zero): what tools/perf_probe_hybrid.py::_spec2_from_words computes there,
// in int32 arithmetic that wraps where XLA's does (the 4-byte literal
// length and the advance it gives). A literal whose advance leaves (0,
// 2^18) is poisoned: a copy of offset 0 and length 4 that advances 1.
SC_HD void spec2_at(uint64_t v, int32_t& spec0, int32_t& spec1) {
  const uint32_t b0 = (uint32_t)v & 0xFFu, b1 = (uint32_t)(v >> 8) & 0xFFu;
  const uint32_t b2 = (uint32_t)(v >> 16) & 0xFFu;
  const uint32_t tt = b0 & 3u, l6 = b0 >> 2;
  const uint32_t ext = l6 < 60u ? 0u : l6 - 59u, hdr = 1u + ext;
  const uint32_t field = (uint32_t)(v >> 8);  // bytes p + 1 .. p + 4
  const uint32_t litlen = ext == 0u ? l6 + 1u : sc::low_bytes(field, ext) + 1u;
  const int32_t adv_l = (int32_t)(hdr + litlen);
  const bool is_lit = tt == 0u && adv_l > 0 && adv_l < (1 << 18);
  const int32_t off4 = (int32_t)field;
  uint32_t off = tt == 1u ? ((b0 >> 5) << 8) | b1 : tt == 2u ? b1 | (b2 << 8) : field & 0xFFFFu;
  if ((tt == 3u && (off4 > 0xFFFF || off4 < 0)) || tt == 0u) off = 0u;  // poisoned
  const uint32_t adv_c = tt == 1u ? 2u : tt == 2u ? 3u : 5u;
  const uint32_t adv = is_lit ? (uint32_t)adv_l : tt == 0u ? 1u : adv_c;
  const uint32_t f = is_lit ? hdr : tt == 0u ? 4u : tt == 1u ? (l6 & 7u) + 4u : l6 + 1u;
  const bool small = !is_lit && off < 8u;
  spec0 = (int32_t)(adv | f << 18 | (uint32_t)small << 30 | (is_lit ? 0u : 0x80000000u));
  spec1 = is_lit ? (int32_t)hdr : -(int32_t)off;
}

// What a pre-pass writes a position: kArrays descriptor words, at(v, d, j)
// putting position j's into d[k][j] from its bytes in v.
struct SpecOne {  // forms 5 and 6
  static constexpr int kArrays = 1;
  SC_HD static void at(uint64_t v, int32_t (&d)[kArrays][4], int j) { d[0][j] = spec_at(v); }
};
struct SpecTwo {  // form 7
  static constexpr int kArrays = 2;
  SC_HD static void at(uint64_t v, int32_t (&d)[kArrays][4], int j) {
    spec2_at(v, d[0][j], d[1][j]);
  }
};

// The descriptors of positions 4g .. 4g + 3 of a row, from its words g and
// g + 1 read through a loader (sc::RowWords, sc::RowBytes: zero at and past
// the row's end): the pre-pass kernel's work for one thread.
template <class Desc, class Ld>
SC_HD void describe_word(const Ld& in, int32_t g, int32_t (&d)[Desc::kArrays][4]) {
  const uint64_t v = (uint64_t)in.word(g + 1) << 32 | in.word(g);
#pragma unroll
  for (int j = 0; j < 4; j++) Desc::at(v >> (8 * j), d, j);
}

// --- the tag source -----------------------------------------------------------

// The second descriptor row of forms 5 and 6: none.
struct NoSpec {
  template <class W>
  SC_HD void advance(const W&, int32_t) {}
};

// The descriptor-driven tag source for sc::decode_block_batched: lane l
// takes the tag at ip + l from its descriptors at that position, each a word
// read through a loader (Spec: sc::RingWords over sc::RowWords of a
// descriptor row, word p at position p; form 7 reads two rows, the second
// NoSpec for forms 5 and 6), in place of the decode kernel's 5-byte gather
// and table; the preamble's bytes come from the compressed row (Row). A
// position at or past the row's `width` descriptors reads nothing (it ends
// the window), so the last row may end where its buffer ends.
//
// The checks are parse_batch's past (ip + adv > n) and bad(), each true
// exactly where the form's error word is not 0; the word of the first bad
// tag is computed again from its descriptor (error_word) only once a batch
// has failed. Form 7: its one test per tag (op + length > expected, a copy
// whose off - 1 is >= op or < 0), error 4 for any. Forms 5 and 6: a poisoned
// tag is read as one of offset 0; a literal of -4..-1 bytes is empty in form
// 6, and in form 5 a negative length that steps the output back and ends its
// batch (kStepBack). Tags of no output are left out of the tags a batch
// hands on (kEmptyTags); their ip still advances.
template <int kForm, class Row, class Spec>
struct DescribedTags {
  static_assert(kForm >= 5 && kForm <= 7, "descriptor form");
  static constexpr bool kEmptyTags = true;
  static constexpr bool kStepBack = kForm == 5;
  using Spec1 = typename std::conditional<kForm == 7, Spec, NoSpec>::type;
  Row row;
  Spec s0;
  Spec1 s1;
  int32_t width;
  SC_HD DescribedTags(const Row& r, const Spec& a, const Spec1& b, int32_t w)
      : row(r), s0(a), s1(b), width(w) {}
  template <class W>
  SC_HD void advance(const W& w, int32_t ip) {
    s0.advance(w, 4 * ip);  // the loaders count bytes: 4 a descriptor
    s1.advance(w, 4 * ip);
  }
  SC_HD uint32_t byte(int32_t i) const { return row.byte(i); }
  SC_HD sc::LaneTag tag(int32_t p) const {
    if (p >= width) return sc::LaneTag{(int64_t)p + 1, 0, 0, 0u, true};
    const int32_t d0 = (int32_t)s0.word(p);
    const uint32_t u = (uint32_t)d0;
    if constexpr (kForm == 7) {
      const int32_t d1 = (int32_t)s1.word(p);
      const int32_t adv = d0 & 0x3FFFF, f = (int32_t)((u >> 18) & 0x7Fu);
      const int32_t length = d0 < 0 ? f : adv - f;
      return sc::LaneTag{(int64_t)p + adv, p + d1, -d1, length > 0 ? (uint32_t)length : 0u,
                         d0 >= 0};
    } else {
      const bool lit = d0 >= 0;
      const int32_t hdr = (int32_t)((u >> 18) & 7u);
      const int32_t adv = lit ? d0 & 0x3FFFF : (int32_t)((u >> 23) & 3u) + 2;
      int32_t length = lit ? (d0 & 0x3FFFF) - hdr : (int32_t)((u >> 16) & 0x7Fu);
      if (kForm == 6 && length < 0) length = 0;
      // off: a copy's offset, 0 for a poisoned tag (a literal's is 1).
      const bool poison = lit ? hdr >= 6 : ((u >> 25) & 1u) != 0u;
      const int32_t off = poison ? 0 : lit ? 1 : d0 & 0xFFFF;
      return sc::LaneTag{(int64_t)p + adv, p + hdr, off, (uint32_t)length, lit};
    }
  }
  // A tag that starts after opl output bytes of the claimed `expected`.
  SC_HD static bool bad(const sc::LaneTag& t, uint32_t opl, int32_t expected) {
    if constexpr (kForm == 7) {
      return t.len > (uint32_t)expected - opl || (!t.lit && (t.off <= 0 || t.off > (int32_t)opl));
    } else {
      const int64_t end = (int64_t)(int32_t)opl + (int32_t)t.len;
      return t.off <= 0 || (!t.lit && t.off > (int32_t)opl) || end > expected ||
             (kForm == 5 && end < 0);
    }
  }
  // The error word of the bad tag at p after opl output bytes.
  SC_HD int32_t error_word(int32_t p, int32_t opl, int32_t n, int32_t expected) const {
    if constexpr (kForm == 7) {
      return ERR_LEN;
    } else {
      return tag_error<kForm>((int32_t)s0.word(p), p, opl, n, expected);
    }
  }
  SC_HD static sc::DecodeResult result(int32_t err, int32_t bad, int32_t ip, int32_t n,
                                       int32_t op, int32_t expected) {
    if (err == 0) err = bad != 0 ? bad : (ip != n || op != expected) ? ERR_LEN : 0;
    return sc::DecodeResult{err == 0 ? expected : 0, err};
  }
};

}  // namespace hy
