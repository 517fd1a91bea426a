// CRC32C (Castagnoli) of byte rows, a block of kWarps warps a row: the row
// math shared by the CUDA kernel (crc32c.cu) and, compiled by a host C++
// compiler, by the tests that hold it against the JAX reference on a
// machine without a GPU.
//
// The CRC is affine over GF(2): crc(M) = ~state after M from the state ~0,
// and a state shifted past d zero bytes is a 32x32 matrix applied to it
// (format/crc32c.py::shift_matrices; ops/cuda/crc32c.py::kernel_tables
// builds the tables below from them). So a row splits into independent runs
// whose raw (zero-start) CRCs combine by fixed shifts:
//
// - the row's bytes from its first 16-byte boundary are 16-byte chunks, 32
//   to a line of 512 bytes; the chunks are placed so that the last one ends
//   the last line of a group of kWarps lines (the first `pad` chunk slots
//   stay empty, and leading zeros add nothing to a raw CRC); warp w takes
//   lines w, w + kWarps, ..., and lane l chunk l of each, copied with one
//   aligned 16-byte cp.async into the warp's ring in shared memory: a warp's
//   copy is 512 contiguous bytes, three batches of kBatch lines in flight;
// - a chunk's CRC is four steps of the 4-byte shift (slicing by 4: four
//   independent look-ups in a 4 x 256 table, one a byte of the state), and a
//   lane runs the kBatch chunks of a batch step by step side by side, so
//   their look-ups overlap;
// - lane l folds its chunks in order: acc = shift(acc, kFold) ^ crc(chunk),
//   kFold the kWarps lines between two lines of a warp (a 4 x 256 table too),
//   so acc is the lane's part of the prefix, seen from the end of its last
//   chunk;
// - lane l shifts acc by the (31 - l) chunks after its own with its own
//   32 x 32 matrix (a word a bit of acc), and five shuffles XOR the lanes;
//   warp w's sum is shifted by the (kWarps - 1 - w) lines after its own (a
//   lane a bit, five shuffles) and kept in shared memory; the XOR of a row's
//   warp sums is the state after its prefix. The warps meet at a barrier
//   only after every kStagedRows rows and after their last, where each
//   thread finishes one of those rows;
// - the bytes before the first boundary (< 16) are walked from ~0 by the
//   lane that holds chunk 0, which starts from their state (the affine term
//   rides in that chunk, with no table of crc(0^n)); the bytes after the last
//   whole chunk (< 16) are walked on from the prefix's state.
//
// No byte at or past the row's length is read. The two 4 x 256 tables of
// the inner loop are spread over the banks so that a warp's look-up is one
// shared-memory wavefront: entry v of the 4 byte tables j fills a row of 32
// words, 8 copies each (word 32 v + 8 j + c, c < 8); lane l reads copy l % 8,
// and at look-up e of a shift it reads table (l / 8 + e) mod 4, so the four
// quarters of a warp read four different tables at once and each lane its
// own bank. The matrices are laid out so that lane l reads bank l.
#pragma once

#include <stdint.h>
#include <string.h>

#include "scalar_codec.cuh"  // SC_HD, sc::CudaWarp

namespace crc {

constexpr int kLanes = 32;
constexpr int kWarps = 8;                // a block's warps, which share a row
constexpr int kChunk = 16;               // bytes of one aligned load
constexpr int kLine = kLanes * kChunk;   // a warp's load
constexpr int kFold = kWarps * kLine;    // a lane's fold: from one of its lines to the next
constexpr int kBatch = 8;                // lines of a warp's batch
constexpr int kStages = 4;               // a warp's batches in shared memory: 3 in flight
constexpr int kStagedRows = 64;          // a block's row lengths read at its start

// Word offsets in the table array kernel_tables() builds: the byte table
// T, with step(s, b) = (s >> 8) ^ T[(s ^ b) & 0xFF]; the 4-byte step and the
// fold as [4][256] tables (entry [j][v] shifts v << 8 j); the lanes'
// matrices (word 32 i + l: bit i shifted by (31 - l) chunks); the warps'
// (word 32 w + i: bit i shifted by (kWarps - 1 - w) lines).
constexpr int kByteTable = 0;
constexpr int kStepTable = 256;
constexpr int kFoldTable = kStepTable + 1024;
constexpr int kLaneMats = kFoldTable + 1024;
constexpr int kWarpMats = kLaneMats + kLanes * 32;
constexpr int kTableWords = kWarpMats + kWarps * 32;

// Shared memory, in words: the step table and the fold table spread over
// the banks, the matrices as they are, the block's first kStagedRows row
// lengths, the warps' sums of kStagedRows rows, and each warp's ring of
// kStages batches. The byte table, read only by the walks of a row's ends,
// stays in device memory.
constexpr int kSpreadWords = 256 * kLanes;
constexpr int kSmemMats = 2 * kSpreadWords;
constexpr int kSmemLengths = kSmemMats + (kTableWords - kLaneMats);
constexpr int kSmemSums = kSmemLengths + kStagedRows;
constexpr int kSmemRings = kSmemSums + kStagedRows * kWarps;
constexpr int kStageWords = kBatch * kLine / 4;
constexpr int kSmemWords = kSmemRings + kWarps * kStages * kStageWords;

SC_HD uint32_t rotl(uint32_t x, uint32_t r) {
#ifdef __CUDA_ARCH__
  return __funnelshift_l(x, x, r);
#else
  return (x << (r & 31u)) | (x >> ((32u - r) & 31u));
#endif
}

// Fills the shared memory from `tables` (kernel_tables()) and the row
// lengths of the block that takes rows first, first + stride, ... < batch:
// thread `tid` of `nthreads` takes every nthreads-th item, all its loads
// issued before its stores. A spread table's word 32 v + 8 j + c holds entry
// v of its byte table j; 8 neighbouring threads write the 4-word groups of
// one row, on 32 banks.
SC_HD void fill_shared(uint32_t* smem, const uint32_t* tables, const int32_t* lengths,
                       int64_t batch, int64_t first, int64_t stride, int tid, int nthreads) {
  constexpr int kItems = 2 * 256 * 8;  // table, entry v, then j and half of the row
  constexpr int kMatWords = kTableWords - kLaneMats;
  for (int k0 = tid, m0 = tid, r0 = tid; k0 < kItems || m0 < kMatWords || r0 < kStagedRows;
       k0 += 16 * nthreads, m0 += 8 * nthreads, r0 += nthreads) {
    uint32_t x[16], m[8], len = 0;
#pragma unroll
    for (int g = 0; g < 16; g++) {
      const int k = k0 + g * nthreads;
      x[g] = k < kItems ? tables[kStepTable + (k >> 11) * 1024 + ((k >> 1) & 3) * 256 +
                                 ((k >> 3) & 255)]
                        : 0u;
    }
#pragma unroll
    for (int g = 0; g < 8; g++) {
      m[g] = m0 + g * nthreads < kMatWords ? tables[kLaneMats + m0 + g * nthreads] : 0u;
    }
    if (r0 < kStagedRows && first + r0 * stride < batch) {
      len = (uint32_t)lengths[first + r0 * stride];
    }
#pragma unroll
    for (int g = 0; g < 16; g++) {
      const int k = k0 + g * nthreads;
      if (k >= kItems) continue;
      uint32_t* at = smem + (k >> 11) * kSpreadWords + 32 * ((k >> 3) & 255) + 4 * (k & 7);
#ifdef __CUDA_ARCH__
      *reinterpret_cast<uint4*>(at) = make_uint4(x[g], x[g], x[g], x[g]);
#else
      for (int c = 0; c < 4; c++) at[c] = x[g];
#endif
    }
#pragma unroll
    for (int g = 0; g < 8; g++) {
      if (m0 + g * nthreads < kMatWords) smem[kSmemMats + m0 + g * nthreads] = m[g];
    }
    if (r0 < kStagedRows) smem[kSmemLengths + r0] = len;
  }
}

// A lane's view of the shared tables.
struct Tables {
  // Byte offsets of the spread tables: the 4-byte step, the fold.
  static constexpr int kStepAt = 0;
  static constexpr int kFoldAt = kSpreadWords * 4;

  const uint32_t* byte;   // in device memory
  const uint8_t* spread;  // the spread step table, then the spread fold table
  const uint32_t* mats;   // the lanes' matrices, then the warps'
  // For look-up e of a shift: the lane's table j = (l / 8 + e) mod 4, the
  // rotation that puts byte j of the state at bits 7-14 and the lane's
  // byte offset in a row of the spread table.
  uint32_t rot[4], off[4];

  // The state x shifted by the spread table at byte `table`.
  template <int table>
  SC_HD uint32_t shift(uint32_t x) const {
    uint32_t r = 0;
#pragma unroll
    for (int e = 0; e < 4; e++) {
      const uint32_t at = (rotl(x, rot[e]) & 0x7F80u) | off[e];
      r ^= *reinterpret_cast<const uint32_t*>(spread + table + at);
    }
    return r;
  }
};

SC_HD Tables lane_tables(const uint32_t* smem, const uint32_t* tables, int lane) {
  Tables t;
  t.byte = tables + kByteTable;
  t.spread = reinterpret_cast<const uint8_t*>(smem);
  t.mats = smem + kSmemMats;
  for (int e = 0; e < 4; e++) {
    const uint32_t j = (uint32_t)((lane / 8 + e) & 3);
    t.rot[e] = (7u - 8u * j) & 31u;
    t.off[e] = 4u * (8u * j + (uint32_t)(lane & 7));
  }
  return t;
}

// The state s walked over n bytes at p, a byte a step.
SC_HD uint32_t walk(const uint32_t* byte, uint32_t s, const uint8_t* p, int64_t n) {
  for (int64_t i = 0; i < n; i++) s = (s >> 8) ^ byte[(s ^ p[i]) & 0xFFu];
  return s;
}

struct Chunk {
  uint32_t w[4];
};

// Copies the 16 bytes at src (16-byte aligned) to dst in shared memory, or
// zeros without reading src unless `valid`: on the card an asynchronous copy
// past L1 (no row is read twice), in the group that the next commit()
// closes; on the host at once.
SC_HD void copy_chunk(uint32_t* dst, const uint8_t* src, bool valid) {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :
               : "r"((uint32_t)__cvta_generic_to_shared(dst)), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
#else
  if (valid) {
    memcpy(dst, src, 16);
  } else {
    memset(dst, 0, 16);
  }
#endif
}

// The 16 bytes at p in shared memory (16-byte aligned).
SC_HD Chunk read_chunk(const uint32_t* p) {
  Chunk c;
#ifdef __CUDA_ARCH__
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  c = Chunk{{v.x, v.y, v.z, v.w}};
#else
  memcpy(c.w, p, sizeof(c.w));
#endif
  return c;
}

SC_HD void commit() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;" ::: "memory");
#endif
}

// Waits until at most `pending` of the lane's committed groups are in
// flight; the others' bytes are then the lane's to read.
template <int pending>
SC_HD void wait_groups() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_group %0;" ::"n"(pending) : "memory");
#endif
}

// How a row of n bytes at p splits.
struct Row {
  const uint8_t* p;
  int64_t n;
  int64_t h;         // bytes before the first 16-byte boundary, walked
  int64_t c;         // whole chunks after them
  int64_t per_warp;  // lines a warp takes
  int64_t batches;   // batches of kBatch lines a warp takes
  int32_t pad;       // empty chunk slots before chunk 0 (< kLanes * kWarps)
};

SC_HD Row plan_row(const uint8_t* p, int64_t n) {
  Row r;
  r.p = p;
  r.n = n;
  r.h = (int64_t)((16u - ((uint32_t)(uintptr_t)p & 15u)) & 15u);
  r.h = r.h < n ? r.h : n;
  r.c = (n - r.h) / kChunk;
  r.per_warp = (r.c + kLanes * kWarps - 1) / (kLanes * kWarps);
  r.batches = (r.per_warp + kBatch - 1) / kBatch;
  r.pad = (int32_t)(r.per_warp * kLanes * kWarps - r.c);
  return r;
}

// One batch of one row: the block's k-th row r, its split, the batch's index.
struct Unit {
  int64_t k;
  int64_t r;  // < 0: none
  Row row;
  int64_t i;
};

// Warp `warp` of a block that takes rows first, first + stride, ... < batch
// of a [batch, width] array, through warp W (sc::CudaWarp on the card; an
// array warp in the tests); `smem` is what fill_shared filled and `sync` the
// block's barrier. Every output is written; none is read.
template <class W, class Sync>
struct RowWalk {
  using Acc = sc::LanesOf<W, uint32_t>;

  const W& w;
  int warp;
  const sc::LanesOf<W, Tables>& t;
  uint32_t* smem;
  Sync sync;
  const uint8_t* rows;
  int64_t width;
  const int32_t* lengths;
  int64_t batch;
  int64_t first;
  int64_t stride;
  int32_t* out;

  // The first batch of the block's k-th row or of a later one; a row with
  // no whole chunk (at most 30 bytes) is walked on the way by lane 0 of
  // warp 0.
  SC_HD Unit from(int64_t k) const {
    for (int64_t r = first + k * stride; r < batch; k++, r += stride) {
      const Row row = row_of(k, r);
      if (row.batches > 0) return {k, r, row, 0};
      w.each([&](int l) {
        if (warp == 0 && l == 0) out[r] = (int32_t)~walk(t[l].byte, ~0u, row.p, row.n);
      });
    }
    return {k, -1, Row{}, 0};
  }

  // The split of the block's k-th row, r.
  SC_HD Row row_of(int64_t k, int64_t r) const {
    int64_t n = k < kStagedRows ? (int32_t)smem[kSmemLengths + k] : lengths[r];
    n = n < 0 ? 0 : (n > width ? width : n);
    return plan_row(rows + r * width, n);
  }

  SC_HD Unit next(const Unit& u) const {
    if (u.r < 0) return u;
    return u.i + 1 < u.row.batches ? Unit{u.k, u.r, u.row, u.i + 1} : from(u.k + 1);
  }

  // The chunk in lane l's slot of the warp's line m: its index in the row
  // (< 0: an empty slot).
  SC_HD int64_t chunk_of(const Row& row, int64_t m, int l) const {
    return (m * kWarps + warp) * kLanes + l - row.pad;
  }

  // The warp's ring stage `stage`: chunk j of lane l at words 4 (32 j + l).
  SC_HD uint32_t* ring(int stage) const {
    return smem + kSmemRings + (warp * kStages + stage) * kStageWords;
  }

  // Copies lane l's chunks of the batch's lines into stage `stage` (zeros
  // for empty slots); none outside the row is read.
  SC_HD void load(const Unit& u, int stage) const {
    uint32_t* dst = ring(stage);
    w.each([&](int l) {
#pragma unroll
      for (int j = 0; j < kBatch; j++) {
        const int64_t m = u.i * kBatch + j;
        const int64_t q = chunk_of(u.row, m, l);
        const bool valid = m < u.row.per_warp && q >= 0;
        copy_chunk(dst + 4 * (kLanes * j + l), valid ? u.row.p + u.row.h + kChunk * q : u.row.p,
                   valid);
      }
    });
  }

  // acc XORed over the lanes, into every lane (five shuffles).
  SC_HD void xor_lanes(Acc& acc) const {
    for (int o = kLanes / 2; o > 0; o /= 2) {
      sc::LanesOf<W, int32_t> src;
      w.each([&](int l) { src[l] = l ^ o; });
      const Acc y = w.gather(acc, src);
      w.each([&](int l) { acc[l] ^= y[l]; });
    }
  }

  // Folds the batch's chunks into acc; after the row's last batch, combines
  // the lanes and keeps the warp's sum, and when the next unit `after` is of
  // another group of kStagedRows rows (or there is none) finishes the group.
  SC_HD void consume(const Unit& u, int stage, Acc& acc, const Unit& after) const {
    const Row& row = u.row;
    const uint32_t* src = ring(stage);
    w.each([&](int l) {
      const Tables& tl = t[l];
      Chunk buf[kBatch];
      uint32_t s[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; j++) {
        buf[j] = read_chunk(src + 4 * (kLanes * j + l));
        s[j] = buf[j].w[0];
      }
      if (u.i == 0) {
        acc[l] = 0;
        // Chunk 0 starts from the head's state, walked from ~0.
        if (chunk_of(row, 0, l) == 0) s[0] ^= walk(tl.byte, ~0u, row.p, row.h);
      }
      // The chunks' four steps side by side (an empty slot holds zeros,
      // whose raw CRC is 0).
#pragma unroll
      for (int k = 1; k < 4; k++) {
#pragma unroll
        for (int j = 0; j < kBatch; j++) {
          s[j] = tl.template shift<Tables::kStepAt>(s[j]) ^ buf[j].w[k];
        }
      }
#pragma unroll
      for (int j = 0; j < kBatch; j++) {
        const uint32_t x = tl.template shift<Tables::kStepAt>(s[j]);
        const uint32_t folded = tl.template shift<Tables::kFoldAt>(acc[l]) ^ x;
        acc[l] = u.i * kBatch + j < row.per_warp ? folded : acc[l];
      }
    });
    if (u.i + 1 < row.batches) return;
    // Lane l's fold ends (31 - l) chunks before the warp's last: its own
    // matrix, a word a set bit.
    w.each([&](int l) {
      uint32_t y = 0;
#pragma unroll
      for (int i = 0; i < 32; i++) y ^= t[l].mats[32 * i + l] & (0u - ((acc[l] >> i) & 1u));
      acc[l] = y;
    });
    xor_lanes(acc);
    // Warp w's sum ends (kWarps - 1 - w) lines before the prefix: lane i
    // takes bit i.
    w.each([&](int l) {
      acc[l] = t[l].mats[kLanes * 32 + 32 * warp + l] & (0u - ((acc[l] >> l) & 1u));
    });
    xor_lanes(acc);
    const int64_t at = u.k % kStagedRows;
    w.each([&](int l) {
      if (l == 0) smem[kSmemSums + at * kWarps + warp] = acc[l];
    });
    if (after.r < 0 || after.k >= u.k - at + kStagedRows) finish(u.k - at, u.k);
  }

  // Rows k0 ... k of the block (kStagedRows at most), whose warps' sums are
  // kept: after a barrier, thread 32 w + l takes row k0 + 32 w + l, XORs its
  // sums (the state after the row's prefix), walks its tail and writes its
  // CRC; a barrier again before the sums are reused.
  SC_HD void finish(int64_t k0, int64_t k) const {
    sync();
    w.each([&](int l) {
      const int64_t q = k0 + kLanes * warp + l;
      const int64_t r = first + q * stride;
      if (q > k) return;
      const Row row = row_of(q, r);
      if (row.batches == 0) return;  // walked by from()
      uint32_t prefix = 0;
      for (int v = 0; v < kWarps; v++) prefix ^= smem[kSmemSums + (q % kStagedRows) * kWarps + v];
      const int64_t done = row.h + kChunk * row.c;
      out[r] = (int32_t)~walk(t[l].byte, prefix, row.p + done, row.n - done);
    });
    sync();
  }
};

// Warp `warp`'s part of the CRC32C of each row first, first + stride, ... of
// rows[batch, width], lengths clamped to [0, width]: batches of kBatch lines
// through the warp's ring of kStages stages, the next kStages - 1 batches
// (of this row or the next) copying in while this one is folded. A lane
// reads only the chunks it copied, so the ring needs no barrier, and the
// warps meet only every kStagedRows rows and after the last. Every warp of
// the block calls it with the same rows, after fill_shared and the block's
// barrier; `sync` is that barrier.
template <class W, class Sync>
SC_HD void crc_rows(const W& w, int warp, const sc::LanesOf<W, Tables>& t, uint32_t* smem,
                    Sync sync, const uint8_t* rows, int64_t width, const int32_t* lengths,
                    int64_t batch, int64_t first, int64_t stride, int32_t* out) {
  static_assert(kStages == 4, "the loop keeps kStages - 1 = 3 batches ahead");
  const RowWalk<W, Sync> rw{w, warp, t, smem, sync, rows, width, lengths, batch, first, stride,
                            out};
  typename RowWalk<W, Sync>::Acc acc;
  // The units in flight: u0 is folded next, from stage `at`.
  Unit u0 = rw.from(0);
  if (u0.r < 0) return;
  rw.load(u0, 0);
  commit();
  Unit u1 = rw.next(u0);
  if (u1.r >= 0) rw.load(u1, 1);
  commit();
  Unit u2 = rw.next(u1);
  if (u2.r >= 0) rw.load(u2, 2);
  commit();
  for (int at = 0; u0.r >= 0; at = (at + 1) % kStages) {
    const Unit u3 = rw.next(u2);
    if (u3.r >= 0) rw.load(u3, (at + 3) % kStages);
    commit();
    wait_groups<kStages - 1>();
    rw.consume(u0, at, acc, u1);
    u0 = u1;
    u1 = u2;
    u2 = u3;
  }
}

}  // namespace crc
