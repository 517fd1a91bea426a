// The tag source of the decode-walk ablation (decode_variants.cu) for the
// decode kernel's batched walk (sc::decode_block_batched), written once as
// __host__ __device__ code like the walks in scalar_codec.cuh: the CUDA
// kernels give it a row through a loader, a host build gives it a plain
// array and a warp of arrays.
//
// It computes what the ablation kernels of tools/perf_probe.py compute
// (_decode_kernel_v2, _v4, _v3, _v1): the (out[:out_len], out_len, err)
// triple of one Snappy block, out_len 0 on any error, with the error word
// classified per tag: 1 (the tag overruns the input), overwritten by 2
// (copy offset 0 or beyond the output), overwritten by 4 (the tag overruns
// the claimed length); 8 for the preamble; 4 for a clean walk that ends
// short of the claim. These differ from the decode kernel's combined word
// on purpose.
//
// The tags are the decode kernel's (sc::ParsedTags: lane l parses the tag
// at ip + l from two row words and the table), and so are the checks:
// parse_batch's end test (a tag may not end past n) and ParsedTags::bad
// (one unsigned compare against the output left, which also refuses the
// length-0 wrap, and a copy's offset in (0, op]) reject exactly the tags
// that T1-T4's test rejects. T1-T4 read a 4-byte length or offset field
// whose top byte is set as 1 << 28 (poisoned); ParsedTags reads all 32 bits:
// either reading is past the output left, or past the output written for an
// offset (a 4th offset byte of 0x80 or more is negative), so both refuse the
// tag. Only the first bad tag's word is worked out, once the walk stopped
// there (error_word: T1-T4's reading, then their classification).
//
// Without kChecks (v1nock) the source drops the checks that do not keep an
// access inside the block's image and row: the end test (a tag that ends
// past n ends the walk at n, its bytes read as the row holds them, zero at
// or past its width) and the classification (any bad tag gives 4). It keeps
// the room and offset tests, which keep every store inside the output image
// and every copy's source in bytes already written. Its triple is defined
// for valid blocks only, where it is the checked walk's.
#pragma once

#include <type_traits>

#include "scalar_codec.cuh"

namespace dv {

constexpr int32_t POISON = 1 << 28;  // a length or offset field wider than 24 bits

// T1-T4's error word of the tag whose bytes v (bytes_at) start at p, after
// op output bytes of the claimed `expected`, n the block's length; 0 for a
// tag that may be appended.
SC_HD int32_t variant_error(uint64_t v, int32_t p, int32_t op, int32_t n, int32_t expected) {
  const uint32_t t = (uint32_t)v & 0xFFu, tt = t & 3u, l6 = t >> 2;
  const uint32_t rest = (uint32_t)(v >> 8) & 0xFFFFFFu;  // bytes 1-3
  const bool top = ((v >> 32) & 0xFFu) != 0u;             // byte 4
  int32_t hdr, length, off = 0;
  if (tt == 0) {
    const uint32_t extra = l6 < 60 ? 0u : l6 - 59;
    hdr = 1 + (int32_t)extra;
    length = extra == 0 ? (int32_t)l6 + 1
                        : (int32_t)sc::low_bytes(rest, extra < 3 ? extra : 3) + 1;
    if (extra == 4 && top) length = POISON;
  } else if (tt == 1) {
    hdr = 2;
    length = (int32_t)(l6 & 7u) + 4;
    off = (int32_t)(((t >> 5) << 8) | (rest & 0xFFu));
  } else {
    hdr = tt == 2 ? 3 : 5;
    length = (int32_t)l6 + 1;
    off = tt == 2 ? (int32_t)(rest & 0xFFFFu) : (top ? POISON : (int32_t)rest);
  }
  int32_t e = (int64_t)p + hdr + (tt == 0 ? length : 0) > n ? sc::ERR_TRUNCATED_TAG : 0;
  if (tt != 0 && (off <= 0 || off > op)) e = sc::ERR_BAD_OFFSET;
  if (op + length > expected) e = sc::ERR_LENGTH_MISMATCH;
  return e;
}

// The ablation's tag source over a row loader Ld (sc::RingWords,
// sc::RowBytes) for the walk of a block of n compressed bytes.
template <class Ld, bool kChecks = true>
struct VariantTags {
  static constexpr bool kEmptyTags = false;  // every tag of no output fails its check
  static constexpr bool kStepBack = false;
  using Parsed = sc::ParsedTags<Ld>;
  Parsed parsed;
  int32_t n;
  SC_HD VariantTags(const Ld& in, const uint32_t* lut, int32_t n_) : parsed(in, lut), n(n_) {}
  template <class W>
  SC_HD void advance(const W& w, int32_t ip) { parsed.advance(w, ip); }
  SC_HD uint32_t byte(int32_t i) const { return parsed.byte(i); }
  SC_HD sc::LaneTag tag(int32_t p) const {
    sc::LaneTag t = parsed.tag(p);
    if (!kChecks && t.next > n) t.next = n;
    return t;
  }
  SC_HD static bool bad(const sc::LaneTag& t, uint32_t opl, int32_t expected) {
    return Parsed::bad(t, opl, expected);
  }
  SC_HD int32_t error_word(int32_t p, int32_t opl, int32_t n_, int32_t expected) const {
    if (!kChecks) return sc::ERR_LENGTH_MISMATCH;
    return variant_error(sc::bytes_at(parsed.in, p), p, opl, n_, expected);
  }
  // A walk that found no bad tag ended at n: parse_batch refuses a tag that
  // ends past it, and without kChecks tag() ends such a tag there.
  SC_HD static sc::DecodeResult result(int32_t err, int32_t bad, int32_t, int32_t, int32_t op,
                                       int32_t expected) {
    if (err == 0) err = bad != 0 ? bad : op != expected ? sc::ERR_LENGTH_MISMATCH : 0;
    return sc::DecodeResult{err == 0 ? expected : 0, err};
  }
};

// The launcher's variant numbers (0 decode_v2, 1 decode_v4, 2 decode_v3, 3
// v1, 4 v1nock, 5 v1nocp) as the batched walk's knobs: f(checks, unc, emit)
// with checks a std::bool_constant, unc a std::integral_constant (the
// rounds emit_batch stores past a batch's end) and emit whether the parsing
// warp hands its batches on. Returns f's result, or -1 for another number.
// Host code: the launcher's and the host tests'.
//
//   v2, v3   emit_batch<0>. v3's one image with one source address for a
//            literal and a copy has no counterpart: emit_batch resolves
//            every byte through one source word already.
//   v4       its two words stored past the frontier: emit_batch<1>, a
//            batch's last round stored whole (32 bytes of slack).
//   v1       its fixed 16-byte move a tag: emit_batch<2>, every round left
//            in a step stored whole (128 bytes of slack).
//   v1nock   v1 over the source without kChecks.
//   v1nocp   v1 whose parsing warp hands nothing on (bd::run's hand_on).
template <class F>
inline int with_variant(int32_t variant, F f) {
  using Yes = std::true_type;
  using No = std::false_type;
  switch (variant) {
    case 0: return f(Yes{}, std::integral_constant<int, 0>{}, true);
    case 1: return f(Yes{}, std::integral_constant<int, 1>{}, true);
    case 2: return f(Yes{}, std::integral_constant<int, 0>{}, true);
    case 3: return f(Yes{}, std::integral_constant<int, 2>{}, true);
    case 4: return f(No{}, std::integral_constant<int, 2>{}, true);
    case 5: return f(Yes{}, std::integral_constant<int, 2>{}, false);
  }
  return -1;
}

}  // namespace dv
