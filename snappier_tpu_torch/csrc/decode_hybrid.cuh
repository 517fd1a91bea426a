// The descriptor-driven decode walks (decode_hybrid.cu), written once as
// __host__ __device__ functions like the walks of decode_variants.cuh: the
// CUDA kernel gives them a shared-memory image, descriptors in device memory
// and a lane index, a host build gives them plain arrays and lane 0 of 1 (or
// a few threads and a barrier).
//
// They compute what the decode kernels of tools/perf_probe_hybrid.py compute
// (_decode_kernel_v5, _v6, _v7): the (out[:out_len], out_len, err) triple of
// one Snappy block, out_len 0 on any error. A tensor pre-pass
// (ops/cuda/decode_hybrid.py) has decoded the tag that would start at every
// byte position, so a tag costs one descriptor load (two for v7) instead of a
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
//   kForm 7 (decode_v7)  spec0 = adv:18 | F:7 << 18 | small << 30 | is_copy
//       << 31, spec1 = the source relative to ip (a literal) or op (a copy);
//       one validity test per tag, error 4 for any bad tag. kUnroll2 takes
//       two tags per loop iteration (the tool's v7u).
//
// Every form: 8 for a bad preamble (a claim above out_cap among them, where
// the TPU walks take up to owc * 4 - 1024 bytes and cut the row), 4 for a
// clean walk that ends short of the claim.
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
SC_HD Step read_tag(const int32_t* spec0, const int32_t* spec1, int32_t ip, int32_t op,
                    int32_t n, int32_t expected) {
  Step s;
  const int32_t d = load_spec(spec0, ip);
  const uint32_t u = (uint32_t)d;
  s.is_copy = d < 0;
  if (kForm == 7) {
    const int32_t d1 = load_spec(spec1, ip);
    const int32_t f = (int32_t)((u >> 18) & 0x7Fu);
    s.adv = d & 0x3FFFF;
    s.length = s.is_copy ? f : s.adv - f;
    s.off = -d1;
    s.src = ip + d1;
    const int32_t offm1 = -d1 - 1;
    bool bad = ip + s.adv > n || op + s.length > expected ||
               (s.is_copy && (offm1 >= op || offm1 < 0));
    s.err = bad ? ERR_LEN : 0;
    return s;
  }
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
// n + 8, words [wc, wc + owc) receive the output. spec0 (and for kForm 7
// spec1) hold the block's descriptors, one per byte position below n.
template <int kForm, bool kUnroll2, class Sync>
SC_HD sc::DecodeResult decode_block_hybrid(uint32_t* img, int32_t wc, int32_t owc,
                                           const int32_t* spec0, const int32_t* spec1,
                                           int32_t n, int32_t out_cap, int lane, int nlanes,
                                           Sync sync) {
  constexpr int kUncond = kForm == 6 ? 2 : 0;
  uint32_t* ow = img + wc;
  int32_t pre_len, expected;
  int32_t err = sc::read_preamble(img, n, out_cap, pre_len, expected);
  int32_t ip = pre_len;
  int32_t op = 0;

  // One tag: false once the walk has stopped (a bad tag, or the end).
  auto step = [&]() -> bool {
    Step s = read_tag<kForm>(spec0, spec1, ip, op, n, expected);
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
    if (kUnroll2) {
      while (ip < n) {
        if (!step() || !step()) break;
      }
    } else {
      while (ip < n && step()) {
      }
    }
  }
  if (err == 0 && op != expected) err = ERR_LEN;
  sc::DecodeResult r;
  r.err = err;
  r.out_len = err == 0 ? expected : 0;
  return r;
}

}  // namespace hy
