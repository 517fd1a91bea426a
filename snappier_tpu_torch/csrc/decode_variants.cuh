// The decode-walk ablation variants (decode_variants.cu), written once as
// __host__ __device__ functions like the walks in scalar_codec.cuh: the CUDA
// kernels give them a shared-memory image and a lane index, a host build
// gives them a plain array and lane 0 of 1 (or a few threads and a barrier).
//
// They compute what the ablation kernels of tools/perf_probe.py compute
// (_decode_kernel_v2, _v4, _v3, _v1): the (out[:out_len], out_len, err)
// triple of one Snappy block, with out_len 0 on any error and the error
// word classified per tag: 1 (the tag overruns the input), overwritten by 2
// (copy offset 0 or beyond the output), overwritten by 4 (the tag overruns
// the claimed length); 8 for the preamble; 4 for a clean walk that ends
// short of the claimed length. These differ from decode_block's combined
// word on purpose. What differs between the variants is how the output
// image is kept and how a tag's payload is appended, which is what the
// ablation times:
//
//   words<false,false,false>  (decode_v2)  word-packed output image; an
//       append is word loads, a funnel shift and word stores, the partial
//       frontier word a read-modify-write; the error word is carried
//       through the loop.
//   words<false,true,true>    (decode_v4)  as v2, with the two words after
//       the frontier word always stored and the walk carrying only a `bad`
//       flag; the error word is worked out once, after the loop.
//   words<true,false,true>    (decode_v3)  one image for the compressed
//       words and the output words, one source address for a literal and
//       a copy, one append path; deferred classification.
//   bytes16<checks,copies>    (decode_variant v1, v1nock, v1nocp)  a byte
//       image, compressed bytes and output in one buffer; every tag moves a
//       fixed 16 bytes whatever its length, a loop runs only past 16 bytes
//       and a pattern loop only for offsets below 8.
#pragma once

#include "scalar_codec.cuh"

namespace sc {

constexpr int32_t POISON = 1 << 28;  // a length or offset field wider than 24 bits

// One entry of the 256-entry tag descriptor table (the reference's
// _tag_lut): bits 0-2 header length, bit 3 is-literal, bits 4-10 inline
// length, bits 11-13 literal extra-length bytes, bits 14-24 copy-1 offset
// high bits, bits 25-26 tag type.
SC_HD int32_t tag_descriptor(uint32_t t) {
  uint32_t tt = t & 3u;
  uint32_t l6 = t >> 2;
  int32_t hdr, L, extra = 0, is_lit = 0, offhi = 0;
  if (tt == 0) {
    is_lit = 1;
    if (l6 < 60) {
      hdr = 1;
      L = (int32_t)l6 + 1;
    } else {
      extra = (int32_t)l6 - 59;
      hdr = 1 + extra;
      L = 0;
    }
  } else if (tt == 1) {
    hdr = 2;
    L = (int32_t)((t >> 2) & 7u) + 4;
    offhi = (int32_t)((t >> 5) << 8);
  } else if (tt == 2) {
    hdr = 3;
    L = (int32_t)l6 + 1;
  } else {
    hdr = 5;
    L = (int32_t)l6 + 1;
  }
  return hdr | (is_lit << 3) | (L << 4) | (extra << 11) | (offhi << 14) | ((int32_t)tt << 25);
}

// The low 32 bits of (hi:lo) >> sh, sh in {0, 8, 16, 24}: one instruction
// on the card.
SC_HD uint32_t funnel_r(uint32_t lo, uint32_t hi, int sh) {
#ifdef __CUDA_ARCH__
  return __funnelshift_r(lo, hi, (unsigned)sh);
#else
  return sh == 0 ? lo : (lo >> sh) | (hi << (32 - sh));
#endif
}

// The 4 bytes at byte i of a little-endian word image, and the byte at i + 4.
SC_HD void window5(const uint32_t* w, int32_t i, uint32_t& v32, uint32_t& b4) {
  int32_t wi = i >> 2;
  int sh = (i & 3) * 8;
  uint32_t w0 = w[wi];
  uint32_t w1 = w[wi + 1];
  v32 = funnel_r(w0, w1, sh);
  b4 = (w1 >> sh) & 0xFFu;
}

struct Tag {
  int32_t hdr;      // tag byte plus its length or offset bytes
  bool is_lit;
  int32_t length;   // output bytes; POISON for a literal length of 4 bytes
  int32_t off;      // copy offset; POISON for an offset of 4 bytes
  int32_t advance;  // hdr, plus the payload of a literal
};

SC_HD Tag parse_tag(uint32_t v32, uint32_t b4, const int32_t* lut) {
  int32_t d = lut[v32 & 0xFFu];
  Tag t;
  t.hdr = d & 7;
  t.is_lit = (d & 8) != 0;
  int32_t L = (d >> 4) & 0x7F;
  int32_t extra = (d >> 11) & 7;
  uint32_t rest = v32 >> 8;
  uint32_t mask = extra == 0 ? 0u : (0xFFFFFFFFu >> ((4 - extra) * 8));
  int32_t longlen = (int32_t)(rest & mask) + 1;
  if (extra == 4 && b4 > 0) longlen = POISON;
  t.length = (t.is_lit && extra > 0) ? longlen : L;
  int32_t tt = d >> 25;
  if (tt == 1) {
    t.off = ((d >> 14) & 0x7FF) | (int32_t)(rest & 0xFFu);
  } else if (tt == 2) {
    t.off = (int32_t)(rest & 0xFFFFu);
  } else {
    t.off = b4 > 0 ? POISON : (int32_t)rest;
  }
  t.advance = t.hdr + (t.is_lit ? t.length : 0);
  return t;
}

// A tag's error word: 1, overwritten by 2, overwritten by 4; 0 for a tag
// that may be appended.
SC_HD int32_t classify_tag(const Tag& t, int32_t ip, int32_t op, int32_t n, int32_t expected) {
  int32_t e = ip + t.advance > n ? ERR_TRUNCATED_TAG : 0;
  if (!t.is_lit && (t.off <= 0 || t.off > op)) e = ERR_BAD_OFFSET;
  if (op + t.length > expected || t.length < 0) e = ERR_LENGTH_MISMATCH;
  return e;
}

// The varint preamble of a word image whose first 8 bytes are staged:
// returns the error word (0 or ERR_BAD_PREAMBLE) and sets pre_len, expected.
SC_HD int32_t read_preamble(const uint32_t* w, int32_t n, int32_t out_cap, int32_t& pre_len,
                            int32_t& expected) {
  pre_len = 0;
  uint32_t val = 0;
  bool done = false;
  int32_t err = 0;
  while (!done && pre_len < 5 && err == 0) {
    uint32_t byte = (w[pre_len >> 2] >> ((pre_len & 3) * 8)) & 0xFFu;
    int sh = 7 * pre_len < 28 ? 7 * pre_len : 28;
    val |= (byte & 0x7Fu) << sh;
    done = byte < 0x80u;
    if (pre_len == 4 && byte >= 8u) err = ERR_BAD_PREAMBLE;
    pre_len++;
  }
  expected = (int32_t)val;
  if (!done || pre_len > n || expected > out_cap || expected < 0) err = ERR_BAD_PREAMBLE;
  return err;
}

// Append K >= 1 bytes to the word image D at byte dpos, read from the word
// image S at byte spos; word indices into S clamp to [0, smax]. Lane k takes
// the k-th word of a round: two source words, a funnel shift, one store.
// The frontier word keeps its bytes below dpos; whole words are stored past
// dpos + K, and those bytes are garbage until a later append overwrites
// them. With `ordered` (S and D are one image and the source may be bytes
// this append writes; the source lies at least 8 bytes back), a round takes
// only the words whose sources earlier rounds have written, and the lanes
// meet between rounds. kUncond > 0 stores the words of the first round after
// the frontier word, up to kUncond of them, whatever K is.
template <int kUncond, class Sync>
SC_HD void append_stream(const uint32_t* S, int32_t smax, int32_t spos, uint32_t* D,
                         int32_t dpos, int32_t K, bool ordered, int lane, int nlanes,
                         Sync sync) {
  int32_t rel = spos - dpos;
  int a8 = (rel & 3) * 8;
  int32_t rw = rel >> 2;  // floor for a negative rel
  int32_t w0 = dpos >> 2;
  uint32_t lowmask = (1u << ((dpos & 3) * 8)) - 1u;
  int32_t base = w0 + rw;
  int32_t last = ((dpos + K - 1) >> 2) - w0;  // words after the frontier word
  int32_t m = nlanes;
  if (ordered && -rw - 1 < m) m = -rw - 1;  // word w0 + k reads words up to base + k + 1
  if (kUncond > 0) {
    int32_t more = m - 1 < kUncond ? m - 1 : kUncond;
    if (last < more) last = more;
  }
  for (int32_t k0 = 0; k0 <= last; k0 += m) {
    int32_t k = k0 + lane;
    if (lane < m && k <= last) {
      int32_t i0 = base + k;
      int32_t i1 = i0 + 1;
      i0 = i0 < 0 ? 0 : (i0 > smax ? smax : i0);
      i1 = i1 < 0 ? 0 : (i1 > smax ? smax : i1);
      uint32_t v = funnel_r(S[i0], S[i1], a8);
      if (k == 0) {
        D[w0] = (D[w0] & lowmask) | (v & ~lowmask);
      } else {
        D[w0 + k] = v;
      }
    }
    if (ordered && k0 + m <= last) sync();
  }
}

// Append K bytes to the word image D at byte dpos from byte spos of the same
// image, one byte after the other (a copy whose offset is below 8): one lane
// does the read-modify-writes, since each may read what the last one wrote.
SC_HD void append_bytes(uint32_t* D, int32_t spos, int32_t dpos, int32_t K, int lane) {
  if (lane != 0) return;
  for (int32_t k = 0; k < K; k++) {
    int32_t s = spos + k;
    int32_t q = dpos + k;
    uint32_t byte = (D[s >> 2] >> ((s & 3) * 8)) & 0xFFu;
    int sh = (q & 3) * 8;
    D[q >> 2] = (D[q >> 2] & ~(0xFFu << sh)) | (byte << sh);
  }
}

// Decode one block on word images (decode_v2, decode_v4, decode_v3).
//
// img holds wc + owc words. Words [0, wc) are the compressed bytes, staged
// by the caller up to byte n + 8, with zeros for bytes at or past the row's
// width. Words [wc, wc + owc) receive the output; owc covers out_cap bytes
// and 3 words of over-store. lut holds the 256 tag descriptors. Every lane
// runs the same walk, so the control flow stays uniform; the lanes split
// each append's words, and sync() orders one tag's stores before the next
// tag's reads.
template <bool kUnified, bool kUncondPair, bool kDeferred, class Sync>
SC_HD DecodeResult decode_block_words(uint32_t* img, int32_t wc, int32_t owc,
                                      const int32_t* lut, int32_t n, int32_t out_cap, int lane,
                                      int nlanes, Sync sync) {
  constexpr int kUncond = kUncondPair ? 2 : 0;
  uint32_t* ow = img + wc;
  const int32_t wcb = wc * 4;  // byte base of the output words in the unified image
  int32_t pre_len, expected;
  int32_t err = read_preamble(img, n, out_cap, pre_len, expected);

  auto append = [&](const Tag& t, int32_t ip, int32_t op) {
    if (kUnified) {
      // One image, one source address for either kind of tag.
      int32_t dst = wcb + op;
      int32_t spos = t.is_lit ? ip + t.hdr : dst - t.off;
      if (t.is_lit || t.off >= 8) {
        append_stream<kUncond>(img, wc + owc - 1, spos, img, dst, t.length, true, lane,
                                   nlanes, sync);
      } else {
        // Pattern expansion: the first min(K, 14) bytes one by one, after
        // which a multiple of the period that is at least 8 lies behind
        // the frontier and the word path finishes.
        append_bytes(img, spos, dst, t.length < 14 ? t.length : 14, lane);
        if (t.length > 14) {
          sync();
          int32_t off2 = t.off * (14 / t.off);
          append_stream<kUncond>(img, wc + owc - 1, dst + 14 - off2, img, dst + 14,
                                     t.length - 14, true, lane, nlanes, sync);
        }
      }
    } else if (t.is_lit) {
      append_stream<kUncond>(img, wc - 1, ip + t.hdr, ow, op, t.length, false, lane,
                                 nlanes, sync);
    } else if (t.off >= 8) {
      append_stream<kUncond>(ow, owc - 1, op - t.off, ow, op, t.length, true, lane, nlanes,
                                 sync);
    } else {
      append_bytes(ow, op - t.off, op, t.length < 14 ? t.length : 14, lane);
      if (t.length > 14) {
        sync();
        int32_t off2 = t.off * (14 / t.off);
        append_stream<kUncond>(ow, owc - 1, op + 14 - off2, ow, op + 14, t.length - 14,
                                   true, lane, nlanes, sync);
      }
    }
    sync();
  };

  int32_t ip = pre_len;
  int32_t op = 0;
  uint32_t v32, b4;
  if (kDeferred) {
    bool bad = err != 0;
    while (ip < n && !bad) {
      window5(img, ip, v32, b4);
      Tag t = parse_tag(v32, b4, lut);
      bool ok = ip + t.advance <= n && (t.is_lit || (t.off > 0 && t.off <= op)) &&
                op + t.length <= expected && t.length > 0;
      if (ok) {
        append(t, ip, op);
        ip += t.advance;
        op += t.length;
      } else {
        bad = true;
      }
    }
    if (err == 0 && bad) {  // classified once: re-parse the failing tag
      window5(img, ip, v32, b4);
      err = classify_tag(parse_tag(v32, b4, lut), ip, op, n, expected);
    }
  } else {
    while (ip < n && err == 0) {
      window5(img, ip, v32, b4);
      Tag t = parse_tag(v32, b4, lut);
      err = classify_tag(t, ip, op, n, expected);
      if (err == 0) {
        append(t, ip, op);
        op += t.length;
      }
      ip += t.advance;
    }
  }
  if (err == 0 && op != expected) err = ERR_LENGTH_MISMATCH;
  DecodeResult r;
  r.err = err;
  r.out_len = err == 0 ? expected : 0;
  return r;
}

// Decode one block on a byte image (decode_variant: v1, v1nock, v1nocp).
//
// buf holds `total` bytes and is 4-byte aligned. Bytes [0, ccp) are the
// compressed bytes, staged by the caller up to byte n + 8, with zeros for
// bytes at or past the row's width; ccp is a multiple of 4. Bytes [ccp, ccp
// + out_cap) receive the output, and total - ccp - out_cap >= 32 bytes of
// slack take the over-copy. Without kChecks no tag is tested (for trusted
// input); every address is still clamped into buf, so that no input reads or
// writes outside it. Without kCopies the walk moves no payload and only
// out_len and err mean anything.
template <bool kChecks, bool kCopies, class Sync>
SC_HD DecodeResult decode_block_bytes16(uint8_t* buf, int32_t ccp, int32_t total,
                                        const int32_t* lut, int32_t n, int32_t out_cap,
                                        int lane, int nlanes, Sync sync) {
  const uint32_t* words = reinterpret_cast<const uint32_t*>(buf);
  int32_t pre_len, expected;
  int32_t err = read_preamble(words, n, out_cap, pre_len, expected);

  int32_t ip = pre_len;
  int32_t op = 0;
  while (ip < n && err == 0) {
    uint32_t v32, b4;
    window5(words, ip, v32, b4);
    Tag t = parse_tag(v32, b4, lut);
    int32_t e = kChecks ? classify_tag(t, ip, op, n, expected) : 0;
    bool ok = e == 0;
    int32_t length = t.length;
    if (!kChecks) {  // keep an untested tag inside the output region
      if (op > out_cap) op = out_cap;
      if (length > out_cap - op) length = out_cap - op;
    }
    if (kCopies) {
      // One image: a literal's source lies in the compressed bytes, a
      // copy's in the output. Byte i of the payload comes from src + i, or
      // for a copy that overlaps itself from src + i % off, the bytes
      // behind the frontier, so the lanes can take any bytes in any order.
      int32_t dst = ccp + op;
      int32_t src = t.is_lit ? ip + t.hdr : dst - t.off;
      src = src < 0 ? 0 : (src > total - 17 ? total - 17 : src);
      int32_t period = (t.is_lit || t.off <= 0) ? POISON : t.off;
      // The fixed 16 bytes, whatever the tag's length and verdict: right
      // for a literal and for an offset of 8 or more (i < 16 <= 2 * off).
      for (int32_t i = lane; i < 16; i += nlanes) {
        buf[dst + i] = buf[src + (i >= period ? i - period : i)];
      }
      if (ok && length > 16 && (t.is_lit || t.off >= 8)) {
        int32_t end = (length + 7) & ~7;  // whole groups of 8 bytes
        if (period >= end) {
          for (int32_t i = 16 + lane; i < end; i += nlanes) buf[dst + i] = buf[src + i];
        } else {
          for (int32_t i = 16 + lane; i < end; i += nlanes) buf[dst + i] = buf[src + i % period];
        }
      }
      if (ok && !t.is_lit && t.off < 8) {  // a short period: the whole payload again
        for (int32_t i = lane; i < length; i += nlanes) buf[dst + i] = buf[src + i % period];
      }
      sync();
    }
    ip += t.advance;
    if (ok) op += kChecks ? t.length : length;
    err = e;
  }
  if (err == 0 && op != expected) err = ERR_LENGTH_MISMATCH;
  DecodeResult r;
  r.err = err;
  r.out_len = err == 0 ? expected : 0;
  return r;
}

}  // namespace sc
