// Per-block Snappy walks shared by the CUDA kernels (decode.cu, encode.cu,
// encode_best.cu, probe.cu) and, compiled by a host C++ compiler, by the
// tests that hold the walks against the JAX reference on a machine without
// a GPU.
//
// The walks run over one <= 64 KiB block and are written once as
// __host__ __device__ functions: the CUDA kernels give them rows in device
// memory through loaders (RowWords, RowBytes, RingWords; the probe's
// RowSpan and SpanRings), shared-memory buffers and, for the decode and
// probe walks, the warp (CudaWarp); a host build gives them plain arrays and
// a warp whose lanes are arrays run in lock step.
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

// ---------------------------------------------------------------------------
// Words and row loaders
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
  SC_HD uint32_t byte(int32_t i) const { return (word(i >> 2) >> (8 * (i & 3))) & 0xFFu; }
  // Asks L1 for the line that holds byte i, if i < n (no load, no result).
  SC_HD void prefetch(int32_t i) const {
#ifdef __CUDA_ARCH__
    if (i < n) asm volatile("prefetch.global.L1 [%0];" ::"l"(w + (i >> 2)));
#endif
  }
};

// The kernels that read rows as words (encode.cu, the encode ablation) take
// RowWords for rows whose base and width are multiples of 16, RowBytes for
// any other.
inline bool word_rows(const void* rows, int64_t width) {
  return ((uintptr_t)rows % 16) == 0 && width % 16 == 0;
}

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
  SC_HD void prefetch(int32_t i) const {
#ifdef __CUDA_ARCH__
    if (i < n) asm volatile("prefetch.global.L1 [%0];" ::"l"(p + i));
#endif
  }
  // The decode walk's hook at each batch's ip: the line 512 bytes ahead.
  template <class W>
  SC_HD void advance(const W& warp, int32_t ip) const {
    warp.each([&](int l) {
      if (l == 0) prefetch(ip + 512);
    });
  }
};

// A row of n bytes at any address and width (the probe's), read as the
// aligned 32-bit words that hold it: word(k) holds bytes 4k - a .. 4k - a + 3
// of the row (a the row's address mod 4), read whole through the read-only
// path where all four lie in the row, else byte by byte with the bytes
// outside the row zero. No byte outside the row is read.
struct RowSpan {
  const uint8_t* p;
  const uint32_t* w;  // p rounded down to 4 bytes
  int32_t a, n;
  SC_HD RowSpan(const uint8_t* p_, int32_t n_)
      : p(p_),
        w(reinterpret_cast<const uint32_t*>(p_ - ((uintptr_t)p_ & 3u))),
        a((int32_t)((uintptr_t)p_ & 3u)),
        n(n_) {}
  SC_HD uint32_t byte(int32_t i) const {
#ifdef __CUDA_ARCH__
    return i >= 0 && i < n ? (uint32_t)__ldg(p + i) : 0u;
#else
    return i >= 0 && i < n ? (uint32_t)p[i] : 0u;
#endif
  }
  SC_HD uint32_t word(int32_t k) const {
    const int32_t b = 4 * k - a;
    if (b >= 0 && b + 4 <= n) {
#ifdef __CUDA_ARCH__
      return __ldg(w + k);
#else
      uint32_t v;
      memcpy(&v, w + k, 4);
      return v;
#endif
    }
    return byte(b) | (byte(b + 1) << 8) | (byte(b + 2) << 16) | (byte(b + 3) << 24);
  }
};

// A RowWords row read through a ring of kRing words in shared memory that
// the decode walk's warp fills ahead of ip (advance, once a batch): a warp
// of words a fill by cp.async, kAhead words ahead, the last kInFlight fills
// left in flight. A word in the ring's readable span is a shared load, any
// other (behind it, ahead of it: a long literal's payload) is the row's.
// The decode kernel's input for word rows.
template <int kRing>
struct RingWords {
  static constexpr int kAhead = 96, kInFlight = 2;
  RowWords row;
  uint32_t* ring;
  int32_t n;
  int32_t lo = 0, ready = 0, hi = 0;  // words [lo, ready) readable, [ready, hi) in flight
  SC_HD RingWords(const RowWords& r, uint32_t* ring_) : row(r), ring(ring_), n(r.n) {}
  SC_HD uint32_t word(int32_t k) const {
    return k >= lo && k < ready ? ring[k & (kRing - 1)] : row.word(k);
  }
  SC_HD uint32_t window(int32_t i) const {
    return funnel_r(word(i >> 2), word((i >> 2) + 1), 8u * (uint32_t)(i & 3));
  }
  SC_HD uint32_t byte(int32_t i) const { return (word(i >> 2) >> (8 * (i & 3))) & 0xFFu; }
  template <class W>
  SC_HD void advance(const W& warp, int32_t ip) {
    constexpr int C = W::kLanes;  // words a fill
    static_assert(kRing >= kAhead + 2 * C && (kRing & (kRing - 1)) == 0, "ring size");
    const int32_t k0 = ip >> 2;
    if (k0 >= ready) {  // jumped past the ring: start it again at ip
#ifdef __CUDA_ARCH__
      asm volatile("cp.async.wait_all;\n" ::);  // no fill in flight to an old slot
#endif
      lo = ready = hi = k0 & ~(C - 1);
    }
    bool filled = false;
    while (hi < k0 + kAhead) {
      const int32_t at = hi;
      warp.each([&](int l) { fill(at + l); });
#ifdef __CUDA_ARCH__
      asm volatile("cp.async.commit_group;\n" ::);
#endif
      hi += C;
      filled = true;
    }
    if (!filled) return;
#ifdef __CUDA_ARCH__
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kInFlight));
#endif
    ready = hi - kInFlight * C;
    lo = hi - kRing > lo ? hi - kRing : lo;
    warp.sync();
  }
  // Word k into its slot, zero at or past the row's end (no read there).
  SC_HD void fill(int32_t k) const {
#ifdef __CUDA_ARCH__
    const bool in_row = 4 * k < n;
    const uint32_t slot = (uint32_t)__cvta_generic_to_shared(ring + (k & (kRing - 1)));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(slot),
                 "l"(in_row ? row.w + k : row.w), "r"(in_row ? 4 : 0));
#else
    ring[k & (kRing - 1)] = row.word(k);
#endif
  }
};

// ---------------------------------------------------------------------------
// Decoder
// ---------------------------------------------------------------------------

// One entry of the decode walk's 256-entry tag table: bits 0-2 the header
// length, 3-9 the base length, 10-12 how many length bytes follow the tag
// (a long literal's 1-4), 13-15 how many offset bytes (1, 2 or 4), 16-26 a
// copy-1 tag's offset high bits, bit 27 literal. A tag's length is its base
// plus its length bytes, its offset the high bits plus its offset bytes.
SC_HD uint32_t tag_entry(uint32_t t) {
  const uint32_t tt = t & 3u, l6 = t >> 2;
  uint32_t hdr, base, nlen = 0, noff = 0, offhi = 0, lit = 0;
  if (tt == 0) {
    lit = 1;
    nlen = l6 < 60 ? 0 : l6 - 59;
    hdr = 1 + nlen;
    base = l6 < 60 ? l6 + 1 : 1;
  } else if (tt == 1) {
    hdr = 2;
    base = (l6 & 7u) + 4;
    noff = 1;
    offhi = (t >> 5) << 8;
  } else {
    hdr = tt == 2 ? 3 : 5;
    base = l6 + 1;
    noff = tt == 2 ? 2 : 4;
  }
  return hdr | base << 3 | nlen << 10 | noff << 13 | offhi << 16 | lit << 27;
}

// The low k bytes of v, k in [0, 4].
SC_HD uint32_t low_bytes(uint32_t v, uint32_t k) {
  return v & (uint32_t)(0xFFFFFFFFull >> (32 - 8 * k));
}

SC_HD int popc(uint32_t m) {
#ifdef __CUDA_ARCH__
  return __popc(m);
#else
  return __builtin_popcount(m);
#endif
}

// The highest set bit of m != 0.
SC_HD int top_bit(uint32_t m) {
#ifdef __CUDA_ARCH__
  return 31 - __clz(m);
#else
  return 31 - __builtin_clz(m);
#endif
}

// The lowest set bit of m != 0.
SC_HD int low_bit(uint32_t m) {
#ifdef __CUDA_ARCH__
  return __ffs(m) - 1;
#else
  return __builtin_ctz(m);
#endif
}

// The position of the k-th (from 0) set bit of m, k < popc(m): a binary
// search on the halves' counts, in registers.
SC_HD int nth_bit(uint32_t m, int k) {
  int pos = 0;
#pragma unroll
  for (int w = 16; w >= 1; w >>= 1) {
    const int c = popc(m & ((1u << w) - 1u));
    if (k >= c) {
      k -= c;
      m >>= w;
      pos += w;
    }
  }
  return pos;
}

// Bytes p .. p + 4 (and more) of a row, little-endian, from its two words.
template <class Ld>
SC_HD uint64_t bytes_at(const Ld& in, int32_t p) {
  const uint64_t lo = in.word(p >> 2), hi = in.word((p >> 2) + 1);
  return (hi << 32 | lo) >> (8 * (p & 3));
}

// The warp of the decode walk on the card: a lane's value is one register
// and the walk's exchanges are the warp's own instructions. A host build
// gives the walk another policy with the same members, whose lanes are
// arrays run in lock step (the tests' ArrayWarp).
struct CudaWarp {
  static constexpr int kLanes = 32;
  template <class T>
  struct Lanes {
    T v;
    SC_HD T& operator[](int) { return v; }
    SC_HD const T& operator[](int) const { return v; }
  };
  // f(lane) on every lane.
  template <class F>
  SC_HD void each(F f) const {
#ifdef __CUDA_ARCH__
    f((int)(threadIdx.x & 31u));
#endif
  }
  // Lane l gets x of lane src[l].
  template <class T>
  SC_HD Lanes<T> gather(const Lanes<T>& x, const Lanes<int32_t>& src) const {
#ifdef __CUDA_ARCH__
    return {__shfl_sync(0xFFFFFFFFu, x.v, src.v)};
#else
    return x;
#endif
  }
  SC_HD Lanes<bool> gather_bool(const Lanes<bool>& x, const Lanes<int32_t>& src) const {
#ifdef __CUDA_ARCH__
    return {__shfl_sync(0xFFFFFFFFu, (int)x.v, src.v) != 0};
#else
    return x;
#endif
  }
  // x of one lane, on every lane.
  template <class T>
  SC_HD T read(const Lanes<T>& x, int lane) const {
#ifdef __CUDA_ARCH__
    return __shfl_sync(0xFFFFFFFFu, x.v, lane);
#else
    return x.v;
#endif
  }
  SC_HD uint32_t ballot(const Lanes<bool>& p) const {
#ifdef __CUDA_ARCH__
    return __ballot_sync(0xFFFFFFFFu, p.v);
#else
    return p.v;
#endif
  }
  SC_HD uint32_t or_all(const Lanes<uint32_t>& x) const {
#ifdef __CUDA_ARCH__
    return __reduce_or_sync(0xFFFFFFFFu, x.v);
#else
    return x.v;
#endif
  }
  // Orders the lanes' shared-memory stores before the next reads.
  SC_HD void sync() const {
#ifdef __CUDA_ARCH__
    __syncwarp();
#endif
  }
  // A batch of `tags` tags passed its checks (a host build counts them).
  SC_HD void batch(int) const {}
};

template <class W, class T>
using LanesOf = typename W::template Lanes<T>;

// The varint preamble of a block of n compressed bytes
// (VarIntEncoding.Read.cs semantics, scalar_codec.py:217-239): at most 5
// bytes, the 5th below 8, a claim in [0, out_cap]. Returns 0 or
// ERR_BAD_PREAMBLE, with the preamble's length and the claim.
template <class Ld>
SC_HD int32_t read_preamble(const Ld& in, int32_t n, int32_t out_cap, int32_t* pre_len,
                            int32_t* expected) {
  int32_t len = 0;
  uint32_t val = 0;
  bool done = false;
  int32_t err = 0;
  while (!done && len < 5 && err == 0) {
    uint32_t byte = in.byte(len);
    int sh = 7 * len < 28 ? 7 * len : 28;
    val |= (byte & 0x7Fu) << sh;
    done = byte < 0x80u;
    if (len == 4 && byte >= 8u) err = ERR_BAD_PREAMBLE;
    len++;
  }
  *pre_len = len;
  *expected = (int32_t)val;
  if (!done || len > n || *expected > out_cap || *expected < 0) err = ERR_BAD_PREAMBLE;
  return err;
}

// One parsed batch of tags, the same on every lane; its tags' fields are
// the caller's per-lane arrays, tag k on lane k (see parse_batch).
// A batch that failed (bad) keeps in next where the first bad tag of its
// chain starts and in total the output before that tag.
struct Batch {
  uint32_t total;  // output bytes (a stepping source's: their signed sum)
  uint32_t lits;   // bit k: tag k is a literal
  int32_t ntags;
  int32_t next;    // ip after the batch
  bool bad;        // a tag failed its checks: the block is malformed
};

// The walk's verdict once it stopped at ip after op output bytes.
SC_HD DecodeResult walk_result(int32_t err, bool bad, int32_t ip, int32_t n, int32_t op,
                               int32_t expected) {
  if (err == 0 && (bad || ip != n)) err = ERR_MALFORMED;
  if (err == 0 && op != expected) err = ERR_LENGTH_MISMATCH;
  DecodeResult r;
  r.err = err;
  r.out_len = err == 0 ? expected : 0;
  return r;
}

// The tag that would start at byte p, as the batched walk sees it.
struct LaneTag {
  int64_t next;  // where the tag after it starts
  int32_t at;    // a literal's first payload byte
  int32_t off;   // a copy's offset
  uint32_t len;  // its output bytes
  bool lit;
};

// The decode kernel's tag source: the tag at each byte parsed from the row
// through a loader (RowBytes, RingWords; in.advance(w, ip) readies the input
// ahead of each batch, byte(i) reads the preamble) and the 256-entry table
// lut of tag_entry(t). A tag is checked as one tag at a time would be
// (scalar_codec.py:409-424): one unsigned compare rejects lengths past the
// remaining output, negative lengths and the length-0 wrap; a copy's offset
// must lie in (0, op]. Every mid-stream failure is ERR_MALFORMED.
//
// kEmptyLiteral takes the length-0 wrap (a 4-byte literal length field of
// 0xFFFFFFFF) as a literal of no bytes, as decode_pipe2 does
// (tools/perf_probe_r4.py): only a literal can have length 0, so the compare
// becomes len > room for every tag, and such tags are left out of the
// batches handed on (kEmptyTags).
template <class Ld, bool kEmptyLiteral = false>
struct ParsedTags {
  static constexpr bool kEmptyTags = kEmptyLiteral;  // else a tag of no output fails its check
  static constexpr bool kStepBack = false;           // no tag has a negative length
  Ld in;
  const uint32_t* lut;
  SC_HD ParsedTags(const Ld& in_, const uint32_t* lut_) : in(in_), lut(lut_) {}
  template <class W>
  SC_HD void advance(const W& w, int32_t ip) { in.advance(w, ip); }
  SC_HD uint32_t byte(int32_t i) const { return in.byte(i); }
  // Its 5 header bytes from two words of the row, then lut. A 4-byte length
  // field keeps all 32 bits and wraps exactly as the int32 reference does;
  // a 4th offset byte >= 0x80 is negative: bad.
  SC_HD LaneTag tag(int32_t p) const {
    const uint64_t v = bytes_at(in, p);
    const uint32_t rest = (uint32_t)(v >> 8);
    const uint32_t e = lut[(uint32_t)v & 0xFFu];
    const int32_t hdr = (int32_t)(e & 7u);
    LaneTag t;
    t.lit = (e >> 27) & 1u;
    t.len = ((e >> 3) & 127u) + low_bytes(rest, (e >> 10) & 7u);
    t.next = (int64_t)p + hdr + (t.lit ? (int64_t)(int32_t)t.len : 0);
    t.off = (int32_t)(((e >> 16) & 0x7FFu) + low_bytes(rest, (e >> 13) & 7u));
    t.at = p + hdr;
    return t;
  }
  // A tag that starts after opl output bytes of the claimed `expected`.
  SC_HD static bool bad(const LaneTag& t, uint32_t opl, int32_t expected) {
    const uint32_t room = (uint32_t)expected - opl;
    return (kEmptyLiteral ? t.len > room : t.len - 1u >= room) ||
           (!t.lit && (t.off <= 0 || t.off > (int32_t)opl));
  }
  // The error word of the first bad tag: one for every check.
  SC_HD int32_t error_word(int32_t, int32_t, int32_t, int32_t) const { return ERR_MALFORMED; }
  SC_HD static DecodeResult result(int32_t err, int32_t bad, int32_t ip, int32_t n, int32_t op,
                                   int32_t expected) {
    return walk_result(err, bad != 0, ip, n, op, expected);
  }
};

// Parse the batch of tags that start in the window of kLanes bytes at ip
// (ip < n, op bytes written so far of the claimed `expected`) from the tag
// source src (ParsedTags; decode_hybrid.cuh's DescribedTags).
//
// Lane l takes the tag that would start at ip + l (src.tag). The chain of
// real tag starts from lane 0 is resolved by pointer doubling over the
// lanes' successors: a tag advances at least 2 bytes, so a window holds at
// most kLanes / 2 tags and log2 of that many rounds of three gathers
// suffice; the same rounds give each tag the output length from it to the
// end of the chain, and so its output offset. The batch ends at the first
// tag whose successor leaves the window (a long literal, the end of the
// block). Each tag is checked against its own op (src.bad) and may not end
// past n. The first bad tag fails the block: the batch then says where it
// starts and the output before it (Batch), for the source's error word.
// A source whose tags may step the output back (Src::kStepBack: a negative
// length) ends the batch at such a tag, and the batch's total is the signed
// sum of its lengths: a later tag of the batch would write bytes an earlier
// one writes.
//
// On return lane k < ntags holds tag k's output offset in the batch (start)
// and the source of its bytes (delta): output byte x of the batch (0 at the
// batch's first byte) is compressed byte x + delta of a literal, and output
// byte x + delta of a copy (x - off: what a forward byte-serial copy reads).
// A source whose tags may have no output (Src::kEmptyTags) leaves them out
// of the ntags tags handed on, and those of a negative length too.
template <class W, class Src>
SC_HD Batch parse_batch(const W& w, const Src& src, int32_t ip, int32_t op, int32_t n,
                        int32_t expected, LanesOf<W, int32_t>& delta,
                        LanesOf<W, uint32_t>& start) {
  constexpr int N = W::kLanes;
  LanesOf<W, int32_t> succ, nxt, off, at, from;
  LanesOf<W, uint32_t> len, reach, sum;
  LanesOf<W, bool> lit, past, flag;
  w.each([&](int l) {
    const int32_t p = ip + l;
    const LaneTag t = src.tag(p);
    const int64_t d = t.next - ip;
    const bool back = Src::kStepBack && (int32_t)t.len < 0;
    succ[l] = (t.next > p && t.next < n && d < N && !back) ? (int32_t)d : N;
    nxt[l] = (int32_t)t.next;  // read only where next <= n
    off[l] = t.off;
    at[l] = t.at;
    len[l] = t.len;
    lit[l] = t.lit;
    past[l] = t.next > n;
    reach[l] = 1u << l;
    sum[l] = t.len;
  });
  // The chain: reach[l] gathers the tag starts of 2^k hops from l, sum[l]
  // their output lengths, succ[l] the lane 2^k hops on.
  for (int h = 1; h < (N + 1) / 2; h <<= 1) {
    w.each([&](int l) { from[l] = succ[l] < N ? succ[l] : l; });
    const LanesOf<W, uint32_t> r2 = w.gather(reach, from), s2 = w.gather(sum, from);
    const LanesOf<W, int32_t> p2 = w.gather(succ, from);
    w.each([&](int l) {
      if (succ[l] < N) {
        reach[l] |= r2[l];
        sum[l] += s2[l];
        succ[l] = p2[l];
      }
    });
  }
  const uint32_t chain = w.read(reach, 0);
  Batch bt;
  bt.total = w.read(sum, 0);
  w.each([&](int l) {
    const uint32_t o = bt.total - sum[l];  // output before this tag, mod 2^32
    const uint32_t opl = (uint32_t)op + o;
    const LaneTag t{0, 0, off[l], len[l], lit[l]};
    const bool b = past[l] || Src::bad(t, opl, expected);
    sum[l] = o;
    at[l] = lit[l] ? at[l] - (int32_t)o : (int32_t)((uint32_t)op - (uint32_t)off[l]);
    flag[l] = ((chain >> l) & 1u) && b;
  });
  const uint32_t failed = w.ballot(flag);
  bt.bad = failed != 0;
  if (bt.bad) {
    const int f = low_bit(failed);
    bt.next = ip + f;
    bt.total = (uint32_t)op + w.read(sum, f);
    return bt;
  }
  bt.next = w.read(nxt, top_bit(chain));
  uint32_t kept = chain;
  if (Src::kEmptyTags) {
    w.each([&](int l) { flag[l] = (int32_t)len[l] > 0; });
    kept &= w.ballot(flag);
  }
  bt.ntags = popc(kept);
  // Tag k's fields move to lane k.
  w.each([&](int l) { from[l] = nth_bit(kept, l < bt.ntags ? l : bt.ntags - 1); });
  delta = w.gather(at, from);
  start = w.gather(sum, from);
  const LanesOf<W, bool> tl = w.gather_bool(lit, from);
  w.each([&](int l) { flag[l] = l < bt.ntags && tl[l]; });
  bt.lits = w.ballot(flag);
  return bt;
}

constexpr int kEmitRounds = 4;  // emit_batch's rounds a step

// The bytes past the output's end that emit_batch<unc> on `lanes` lanes may
// store.
SC_HD constexpr int32_t emit_slack(int unc, int lanes) {
  return unc == 0 ? 0 : (unc == 1 ? lanes : kEmitRounds * lanes);
}

// Write a parsed batch's bt.total output bytes at op: kSub rounds of kLanes
// bytes a step, one byte a lane a round, across tag boundaries. Round j of a
// step writes bytes xr + j * kLanes + l: a byte's tag is its rank among the
// round's tag starts (a bit mask), and the look-ups of a step's rounds are
// independent of each other. A source in the round's own output is resolved
// through the lane that writes it (pointer jumping over the round's lanes)
// before any lane reads shared memory; one sync a round orders the stores
// before the next round's reads. The rest of a long literal that ends a
// batch moves four bytes a lane. delta and start are parse_batch's: tag k's
// on lane k.
//
// kUnc (decode_pipe2's `unc`) stores whole rounds past the batch's end: 1
// every lane of its last round, up to kLanes - 1 bytes past op + bt.total;
// 2 also the rounds left in that step, up to kSub * kLanes - 1 bytes past
// it. Those bytes are garbage until a later batch writes them, and out must
// hold them (emit_slack). A lane past the end takes the batch's last tag: a
// literal's lane reads the loader, which returns zero at or past the row's
// width without reading there; a copy's reads the output below its own byte.
template <int kUnc = 0, class W, class Ld>
SC_HD void emit_batch(const W& w, const Ld& in, const Batch& bt, int32_t op, uint8_t* out,
                      const LanesOf<W, int32_t>& delta, const LanesOf<W, uint32_t>& start) {
  constexpr int N = W::kLanes;
  constexpr int kSub = kEmitRounds;
  const int ntags = bt.ntags;
  const bool last_lit = (bt.lits >> (ntags - 1)) & 1u;
  const int32_t last_delta = w.read(delta, ntags - 1);
  LanesOf<W, int32_t> from;
  LanesOf<W, bool> flag;
  int cnt = 0;  // tags that start before the step
  for (uint32_t xr = 0; xr < bt.total;) {
    if (cnt == ntags && last_lit && bt.total - xr >= 4u * N) {
      w.each([&](int l) {
        const int32_t x = (int32_t)xr + 4 * l;
        const uint32_t v = in.window(x + last_delta);
        uint8_t* d = out + op + x;
        d[0] = (uint8_t)v;
        d[1] = (uint8_t)(v >> 8);
        d[2] = (uint8_t)(v >> 16);
        d[3] = (uint8_t)(v >> 24);
      });
      w.sync();
      xr += 4u * N;
      continue;
    }
    // Per round: its tag starts, each lane's tag rank, and where its byte
    // comes from (desc < 0: compressed byte -1 - desc; else output byte).
    LanesOf<W, uint32_t> bits[kSub];
    LanesOf<W, int32_t> rank[kSub], desc[kSub];
    w.each([&](int l) {
#pragma unroll
      for (int j = 0; j < kSub; j++) {
        const uint32_t d = start[l] - (xr + (uint32_t)(j * N));
        bits[j][l] = l < ntags && d < (uint32_t)N ? 1u << d : 0u;
      }
    });
    uint32_t starts[kSub];
    int first[kSub + 1];
    first[0] = cnt;
#pragma unroll
    for (int j = 0; j < kSub; j++) {
      starts[j] = w.or_all(bits[j]);
      first[j + 1] = first[j] + popc(starts[j]);
    }
    w.each([&](int l) {
#pragma unroll
      for (int j = 0; j < kSub; j++) {
        const int k = first[j] + popc(starts[j] & ((2u << l) - 1u)) - 1;
        rank[j][l] = k < 0 ? 0 : (k < ntags ? k : ntags - 1);
      }
    });
#pragma unroll
    for (int j = 0; j < kSub; j++) {
      const LanesOf<W, int32_t> dl = w.gather(delta, rank[j]);
      w.each([&](int l) {
        const int32_t pos = (int32_t)xr + j * N + l + dl[l];
        desc[j][l] = ((bt.lits >> rank[j][l]) & 1u) ? -1 - pos : pos;
      });
    }
#pragma unroll
    for (int j = 0; j < kSub; j++) {
      const uint32_t xj = xr + (uint32_t)(j * N);
      if (kUnc < 2 && xj >= bt.total) break;
      const int32_t base = op + (int32_t)xj;
      w.each([&](int l) { flag[l] = (kUnc > 0 || xj + l < bt.total) && desc[j][l] >= base; });
      while (w.ballot(flag)) {
        w.each([&](int l) { from[l] = flag[l] ? desc[j][l] - base : l; });
        const LanesOf<W, int32_t> d2 = w.gather(desc[j], from);
        w.each([&](int l) {
          if (flag[l]) {
            desc[j][l] = d2[l];
            flag[l] = desc[j][l] >= base;
          }
        });
      }
      w.each([&](int l) {
        if (kUnc > 0 || xj + l < bt.total) {
          const int32_t d = desc[j][l];
          out[base + l] = d < 0 ? (uint8_t)in.byte(-1 - d) : out[d];
        }
      });
      w.sync();
    }
    cnt = first[kSub];
    xr += (uint32_t)(kSub * N);
  }
}

// Decode one Snappy block: varint preamble, then the tags, a batch of them
// per warp step: parse_batch over the tag source src, then step(bt, op,
// delta, start) with the batch that passed its checks, the output offset
// where it starts and parse_batch's per-lane results (a batch with no
// output, or a negative total, is not handed on). A warp that writes its
// own batches passes a step that calls emit_batch; the decode kernels'
// parsing warp passes one that hands the batch to its writing warp. kUnits
// batches are parsed a loop iteration (decode_hybrid.cu's unroll2 takes 2),
// to the same result.
//
// src reads the block's row of cc bytes, bytes at or past its width read as
// zero (the JAX key image pads the same way) and never read; src.advance(w,
// ip) readies the input ahead of each batch. n here is the block's
// compressed length, out_cap the caller's capacity: a preamble claiming
// more is ERR_BAD_PREAMBLE. Bytes of the output past out_len are
// unspecified (a failed walk may have written some). src.result gives the
// verdict from src.error_word of the first bad tag, read again only then
// (ParsedTags: every mid-stream failure is ERR_MALFORMED, as the JAX scalar
// kernel reports it).
template <int kUnits = 1, class W, class Src, class Step>
SC_HD DecodeResult decode_block_batched(const W& w, Src src, int32_t n, int32_t out_cap,
                                        Step step) {
  int32_t pre_len, expected, op = 0, ip = 0;
  const int32_t err = read_preamble(src, n, out_cap, &pre_len, &expected);
  int32_t bad = 0;  // the first bad tag's error word
  if (err == 0) {
    LanesOf<W, int32_t> delta;
    LanesOf<W, uint32_t> start;
    // One batch; false once the walk stops (a bad tag, the end).
    auto unit = [&]() -> bool {
      src.advance(w, ip);
      const Batch bt = parse_batch(w, src, ip, op, n, expected, delta, start);
      if (bt.bad) {
        bad = src.error_word(bt.next, (int32_t)bt.total, n, expected);
        return false;
      }
      w.batch(bt.ntags);
      if (!Src::kEmptyTags || (int32_t)bt.total > 0) step(bt, op, delta, start);
      op += (int32_t)bt.total;
      ip = bt.next;
      return ip < n;
    };
    for (ip = pre_len; ip < n;) {
      bool go = unit();
      for (int u = 1; u < kUnits && go; u++) go = unit();
      if (!go) break;
    }
  }
  return src.result(err, bad, ip, n, op, expected);
}

// ---------------------------------------------------------------------------
// Encoder
// ---------------------------------------------------------------------------

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

// The probe's arguments clamped as match_extension_probe's plain version
// clamps them: n into [0, cc], at into [0, n], cand into [0, cc]. Every
// walk is then bounded and reads only bytes of its row.
struct ProbeArgs {
  int32_t at, cand, n;
};

SC_HD ProbeArgs probe_args(int64_t cc, int32_t at, int32_t cand, int32_t n) {
  const int32_t w = cc < INT32_MAX ? (int32_t)cc : INT32_MAX;
  const int32_t nn = n < 0 ? 0 : (n > w ? w : n);
  return {at < 0 ? 0 : (at > nn ? nn : at), cand < 0 ? 0 : (cand > w ? w : cand), nn};
}

// The probe walk's two spans ([at, ...) and [cand, ...) of a RowSpan row)
// read through rings of kRing words each in shared memory that a warp fills
// ahead of the walk: a warp of words a fill, a word a lane, by cp.async
// where the row holds all four of its bytes and from the row's bytes (zero
// outside the row) where not; start() fills [k0 & ~31, k0 + 96) before the
// walk, advance() (the walk's seed hook, each stride-8 step) fills a span
// once its word is within kAhead words of the filled end, waits for every
// fill before this one and marks it readable. Every window the walk reads
// (its words at most 6 past the last hook's) then lies in a ring's readable
// words [lo, ready) and is two shared loads, with no test on the row, and
// a funnel shift. Every lane runs the same walk, so the warp stays
// converged for the fills and a shared load is a broadcast. A host build
// fills the rings at once.
template <int kRing>
struct SpanRings {
  static constexpr int32_t kAhead = 64, kFill = 32;
  static_assert(kRing >= kAhead + 2 * kFill && (kRing & (kRing - 1)) == 0, "ring size");
  RowSpan row;
  uint32_t* ring;  // [2][kRing]
  int32_t lo[2], ready[2], hi[2];
#ifndef __CUDA_ARCH__
  // A host build's fills in flight, in order: they land at the waits.
  static constexpr int kGroups = 8;
  uint32_t held[kGroups][kFill];
  uint32_t* slots[kGroups][kFill];
  int held_n = 0;
#endif
  SC_HD SpanRings(const RowSpan& r, uint32_t* ring_) : row(r), ring(ring_) {}
  template <class W>
  SC_HD void fill(const W& w, int s) {
    static_assert(W::kLanes == kFill, "a word a lane");
    const int32_t h = hi[s];
    w.each([&](int l) {
      const int32_t k = h + l;
      uint32_t* slot = ring + s * kRing + (k & (kRing - 1));
#ifdef __CUDA_ARCH__
      const int32_t b = 4 * k - row.a;
      if (b >= 0 && b + 4 <= row.n) {
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                         (uint32_t)__cvta_generic_to_shared(slot)),
                     "l"(row.w + k)
                     : "memory");
      } else {
        *slot = row.word(k);
      }
#else
      held[held_n][l] = row.word(k);
      slots[held_n][l] = slot;
#endif
    });
#ifdef __CUDA_ARCH__
    asm volatile("cp.async.commit_group;\n" ::: "memory");
#else
    held_n++;
#endif
    hi[s] = h + kFill;
  }
  // Every fill but the newest `newest` (0-2) has landed.
  SC_HD void wait(int newest) {
#ifdef __CUDA_ARCH__
    if (newest == 0) asm volatile("cp.async.wait_all;\n" ::: "memory");
    if (newest == 1) asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    if (newest == 2) asm volatile("cp.async.wait_group 2;\n" ::: "memory");
#else
    const int land = held_n - newest;
    for (int g = 0; g < land; g++) {
      for (int l = 0; l < kFill; l++) *slots[g][l] = held[g][l];
    }
    for (int g = land; g < held_n; g++) {
      memcpy(held[g - land], held[g], sizeof(held[g]));
      memcpy(slots[g - land], slots[g], sizeof(slots[g]));
    }
    held_n = newest;
#endif
  }
  template <class W>
  SC_HD void start(const W& w, int32_t k0, int32_t k1) {
    for (int s = 0; s < 2; s++) {
      const int32_t k = s ? k1 : k0;
      lo[s] = hi[s] = k & ~(kFill - 1);
      while (hi[s] < k + kAhead + kFill) fill(w, s);
      ready[s] = hi[s];
    }
    wait(0);
    w.sync();
  }
  template <class W>
  SC_HD void advance(const W& w, int32_t k0, int32_t k1) {
    const bool n0 = k0 + kAhead > hi[0], n1 = k1 + kAhead > hi[1];
    if (!(n0 || n1)) return;
    if (n0) fill(w, 0);
    if (n1) fill(w, 1);
    wait(n0 && n1 ? 2 : 1);
    for (int s = 0; s < 2; s++) {
      ready[s] = (s ? n1 : n0) ? hi[s] - kFill : hi[s];
      lo[s] = hi[s] - kRing > lo[s] ? hi[s] - kRing : lo[s];
    }
    w.sync();
  }
  // The window at byte i: from ring 0 where both its words are readable
  // there, else from ring 1.
  SC_HD uint32_t window(int32_t i) const {
    const int32_t q = i + row.a, k = q >> 2;
    const bool in0 = (uint32_t)(k - lo[0]) < (uint32_t)(ready[0] - 1 - lo[0]);
    const uint32_t* r = ring + (in0 ? 0 : kRing);
    return funnel_r(r[k & (kRing - 1)], r[(k + 1) & (kRing - 1)], 8u * (uint32_t)(q & 3));
  }
};

// The probe's walk on clamped arguments by warp w over a RowSpan row read
// through SpanRings (the row's words in `ring`, 2 kRing words): extend_match
// unchanged, its seed hook the rings' advance.
template <int kRing, class W>
SC_HD int32_t match_extension_ring(const W& w, const RowSpan& row, const ProbeArgs& g,
                                   uint32_t* ring) {
  SpanRings<kRing> rings(row, ring);
  rings.start(w, (g.at + row.a) >> 2, (g.cand + row.a) >> 2);
  const int32_t m = extend_match([&](int32_t i) { return rings.window(i); }, g.at, g.cand, g.n,
                                 [&](int32_t pos) {
                                   rings.advance(w, (pos + row.a) >> 2,
                                                 (g.cand + (pos - g.at) + row.a) >> 2);
                                 });
  rings.wait(0);  // no fill lands after the walk
  return m;
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

// An int32 of device memory through the read-only path.
SC_HD int32_t load_i32(const int32_t* p) {
#ifdef __CUDA_ARCH__
  return __ldg(p);
#else
  return *p;
#endif
}

// Asks L1 for the line of p[i], if i < n.
SC_HD void prefetch_i32(const int32_t* p, int32_t i, int32_t n) {
#ifdef __CUDA_ARCH__
  if (i < n) asm volatile("prefetch.global.L1 [%0];" ::"l"(p + i));
#endif
}

// The level="best" walk over one fragment of n bytes read through a loader
// (RowWords, RowBytes; scalar_codec.py:964-996); returns the tag stream's
// length.
//
// cands is the fragment's row of int32 candidates, read in device memory:
// cands[i] is the one candidate for position i
// (ops/best_match.py::exact_candidates, nearest first), and any value
// outside [0, i), which a correct candidate array never holds, counts as
// none, so every hit copies from earlier bytes. A hit is a candidate whose
// first 4 bytes equal the position's; no table, no seeding, and a miss
// steps 1 + (skip >> 7). out holds the bound of greedy emission plus 3
// bytes (a literal's payload may store up to 3 bytes past its end).
template <class Ld>
SC_HD int32_t encode_fragment_best(const Ld& ld, int32_t n, const int32_t* cands,
                                   int32_t skip_base, uint8_t* out) {
  auto key = [&](int32_t i) { return ld.window(i); };
  int32_t ip = n < 1 ? n : 1;
  int32_t lit_start = 0;
  int32_t op = 0;
  int32_t skip = skip_base;
  while (ip + INPUT_MARGIN < n) {
    // The candidates and the fragment stream forward: ask L1 for their lines
    // 128 positions ahead.
    prefetch_i32(cands, ip + 128, n);
    ld.prefetch(ip + 128);
    const int32_t c = load_i32(cands + ip);
    if (c < 0 || c >= ip || key(c) != key(ip)) {
      ip += 1 + (skip >> 7);
      skip += 1;
      continue;
    }
    const int32_t m = extend_match(key, ip, c, n, [](int32_t) {});
    if (ip > lit_start) op = emit_literal(out, op, ld, lit_start, ip - lit_start);
    op = emit_copy(out, op, ip - c, m);
    ip += m;
    lit_start = ip;
    skip = skip_base;
  }
  if (n > lit_start) op = emit_literal(out, op, ld, lit_start, n - lit_start);
  return op;
}

}  // namespace sc
