// The descriptor-driven decode walks (decode_hybrid.cu), written once as
// __host__ __device__ functions like the walks of decode_variants.cuh: the
// CUDA kernel gives them a shared-memory image, descriptors in device memory
// and a lane index, a host build gives them plain arrays and lane 0 of 1 (or
// a few threads and a barrier).
//
// They compute what the decode kernels of tools/perf_probe_hybrid.py compute
// (_decode_kernel_v5, _v6, _v7): the (out[:out_len], out_len, err) triple of
// one Snappy block, out_len 0 on any error. A pre-pass (ops/cuda/
// decode_hybrid.py) has decoded the tag that would start at every byte
// position, so a tag costs one descriptor load (two for v7) instead of a
// parse:
//
//   kForm 5 (decode_v5, decode_v5_spec)  spec0 = a literal's adv:18 | hdr:3
//       << 18, a copy's off:16 | len:7 << 16 | (adv - 2):2 << 23 | poison <<
//       25 | 1 << 31. Error words as the TPU's chain of wheres, the last true
//       one winning: 2 (the tag overruns the input), 3 (copy offset 0 or
//       beyond the output), 4 (a poisoned literal), 3 (a poisoned copy), 4
//       (the tag overruns the claim). A literal length that wraps to -4..-1
//       steps the output position back, as on the TPU; the port refuses it
//       with 4 where the position would go below 0.
//   kForm 6 (decode_v6)  the same descriptors and checks; such a literal is
//       taken as empty. The TPU walk clamps a bad tag's append instead of
//       skipping it, to save a branch; its output is discarded all the same,
//       so this walk stops at the first bad tag as v5 does. The two words
//       after an append's frontier word are always stored, as on the TPU.
//
// Both: 8 for a bad preamble (a claim above out_cap among them, where the
// TPU walks take up to owc * 4 - 1024 bytes and cut the row), 4 for a clean
// walk that ends short of the claim.
//
// Form 7 (decode_v7) is not a walk of its own: its descriptors (spec0 =
// adv:18 | F:7 << 18 | small << 30 | is_copy << 31, spec1 = the source
// relative to ip (a literal) or op (a copy); spec2_at computes both) feed
// the decode kernel's batched walk (sc::decode_block_batched) as a tag
// source, DescribedTags: one test per tag, error 4 for any bad tag.
#pragma once

#include "decode_variants.cuh"

namespace hy {

constexpr int32_t ERR_TRUNC = 2;
constexpr int32_t ERR_OFF = 3;
constexpr int32_t ERR_LEN = 4;

// A descriptor from device memory through the read-only path.
SC_HD int32_t load_spec(const int32_t* p, int32_t i) {
#ifdef __CUDA_ARCH__
  return __ldg(p + i);
#else
  return p[i];
#endif
}

struct Step {
  int32_t err;     // 0, or the tag's error word
  int32_t adv;     // input bytes the tag takes
  int32_t length;  // output bytes (a literal's may be negative: see kForm 5)
  int32_t off;     // a copy's offset
  int32_t src;     // a literal's first payload byte
  bool is_copy;
};

// The tag at ip from its descriptors, checked against the walk's state.
template <int kForm>
SC_HD Step read_tag(const int32_t* spec0, int32_t ip, int32_t op, int32_t n, int32_t expected) {
  Step s;
  const int32_t d = load_spec(spec0, ip);
  const uint32_t u = (uint32_t)d;
  s.is_copy = d < 0;
  const int32_t hdr = (int32_t)((u >> 18) & 7u);
  s.off = d & 0xFFFF;
  s.adv = s.is_copy ? (int32_t)((u >> 23) & 3u) + 2 : d & 0x3FFFF;
  s.length = s.is_copy ? (int32_t)((u >> 16) & 0x7Fu) : (d & 0x3FFFF) - hdr;
  s.src = ip + hdr;
  int32_t e = ip + s.adv > n ? ERR_TRUNC : 0;
  if (s.is_copy && (s.off == 0 || s.off > op)) e = ERR_OFF;
  if (!s.is_copy && hdr >= 6) e = ERR_LEN;
  if (s.is_copy && ((u >> 25) & 1u)) e = ERR_OFF;
  if (op + s.length > expected) e = ERR_LEN;
  if (kForm == 5 && e == 0 && op + s.length < 0) e = ERR_LEN;
  s.err = e;
  return s;
}

// Decode one block over its descriptors.
//
// img, wc, owc, lane, nlanes and sync as for sc::decode_block_words with
// separate images: words [0, wc) hold the compressed row staged up to byte
// n + 8, words [wc, wc + owc) receive the output. spec0 holds the block's
// descriptors, one per byte position below n.
template <int kForm, class Sync>
SC_HD sc::DecodeResult decode_block_hybrid(uint32_t* img, int32_t wc, int32_t owc,
                                           const int32_t* spec0, int32_t n, int32_t out_cap,
                                           int lane, int nlanes, Sync sync) {
  constexpr int kUncond = kForm == 6 ? 2 : 0;
  uint32_t* ow = img + wc;
  int32_t pre_len, expected;
  int32_t err = sc::read_preamble(img, n, out_cap, pre_len, expected);
  int32_t ip = pre_len;
  int32_t op = 0;

  // One tag: false once the walk has stopped (a bad tag, or the end).
  auto step = [&]() -> bool {
    Step s = read_tag<kForm>(spec0, ip, op, n, expected);
    if (s.err != 0) {
      err = s.err;
      return false;
    }
    const int32_t length = s.length;
    if (length > 0) {
      if (!s.is_copy) {
        sc::append_stream<kUncond>(img, wc - 1, s.src, ow, op, length, false, lane, nlanes, sync);
      } else if (s.off >= 8) {
        sc::append_stream<kUncond>(ow, owc - 1, op - s.off, ow, op, length, true, lane, nlanes,
                                   sync);
      } else {
        // Pattern expansion: the first min(length, 14) bytes one by one,
        // after which a multiple of the period that is at least 8 lies
        // behind the frontier and the word path finishes.
        sc::append_bytes(ow, op - s.off, op, length < 14 ? length : 14, lane);
        if (length > 14) {
          sync();
          int32_t off2 = s.off * (14 / s.off);
          sc::append_stream<kUncond>(ow, owc - 1, op + 14 - off2, ow, op + 14, length - 14,
                                     true, lane, nlanes, sync);
        }
      }
      sync();
    }
    op += (kForm == 5 || length > 0) ? length : 0;
    ip += s.adv;
    return ip < n;
  };

  if (err == 0) {
    while (ip < n && step()) {
    }
  }
  if (err == 0 && op != expected) err = ERR_LEN;
  sc::DecodeResult r;
  r.err = err;
  r.out_len = err == 0 ? expected : 0;
  return r;
}

// --- form 7 --------------------------------------------------------------

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

// Form 7's tag source for sc::decode_block_batched: lane l takes the tag at
// ip + l from its two descriptors, each a word read through a loader (Spec:
// sc::RingWords over sc::RowWords of the descriptor row, word p at position
// p), in place of the decode kernel's 5-byte gather and table; the
// preamble's bytes come from the compressed row (Row). A position at or
// past the row's `width` descriptors reads nothing (it ends the window), so
// the last row may end where its buffer ends. The TPU walk's one test per
// tag (ip + adv > n, op + length > expected, a copy whose off - 1 is >= op
// or < 0) is parse_batch's past and bad(), error 4 for any; a literal whose
// length wraps to -4..-1 is taken as empty and its ip still advances
// (kEmptyTags: the batch leaves it out of the tags it hands on).
template <class Row, class Spec>
struct DescribedTags {
  static constexpr bool kEmptyTags = true;
  Row row;
  Spec s0, s1;
  int32_t width;
  SC_HD DescribedTags(const Row& r, const Spec& a, const Spec& b, int32_t w)
      : row(r), s0(a), s1(b), width(w) {}
  template <class W>
  SC_HD void advance(const W& w, int32_t ip) {
    s0.advance(w, 4 * ip);  // the loaders count bytes: 4 a descriptor
    s1.advance(w, 4 * ip);
  }
  SC_HD uint32_t byte(int32_t i) const { return row.byte(i); }
  SC_HD sc::LaneTag tag(int32_t p) const {
    if (p >= width) return sc::LaneTag{(int64_t)p + 1, 0, 0, 0u, true};
    const int32_t d0 = (int32_t)s0.word(p), d1 = (int32_t)s1.word(p);
    const int32_t adv = d0 & 0x3FFFF, f = (int32_t)(((uint32_t)d0 >> 18) & 0x7Fu);
    const int32_t length = d0 < 0 ? f : adv - f;
    return sc::LaneTag{(int64_t)p + adv, p + d1, -d1, length > 0 ? (uint32_t)length : 0u,
                       d0 >= 0};
  }
  SC_HD static bool bad(const sc::LaneTag& t, uint32_t opl, int32_t expected) {
    return t.len > (uint32_t)expected - opl || (!t.lit && (t.off <= 0 || t.off > (int32_t)opl));
  }
  SC_HD static sc::DecodeResult result(int32_t err, bool bad, int32_t ip, int32_t n, int32_t op,
                                       int32_t expected) {
    if (err == 0 && (bad || ip != n || op != expected)) err = ERR_LEN;
    return sc::DecodeResult{err == 0 ? expected : 0, err};
  }
};

}  // namespace hy
