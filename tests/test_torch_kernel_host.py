"""The CUDA kernels' per-block walks (``snappier_tpu_torch/csrc/scalar_codec.cuh``),
compiled for the host with g++ and held against the JAX scalar kernels in
Pallas interpret mode; and the ablation variants' walks
(``csrc/decode_variants.cuh``, ``csrc/encode_variants.cuh``), held against
their plain versions (which tests/test_torch_decode_variants.py and
tests/test_torch_encode_variants.py hold against the TPU kernels); and the
descriptor-driven walks (``csrc/decode_hybrid.cuh``), held against theirs
(which tests/test_torch_hybrid_decode.py holds against the TPU kernels); and
the encode walk's stats sink, held against its plain version (which
tests/test_torch_encode_variants.py holds against the TPU kernel). The
micro-probes' bodies are built and held apart, in
tests/test_torch_kernel_host_probes.py.

The walks are ``__host__ __device__`` functions, so this is the one place
their own logic runs without a GPU. The batched decode walk runs on a warp
of 1, 4 and 32 lanes whose values are arrays run in lock step (``ArrayWarp``,
the host twin of ``sc::CudaWarp``, ``tests/torch_cases.py::ARRAY_WARP``), each loader reading rows placed just
below a page the process may not read; it is also held to the oracle's
verdicts on the block mutation set of tests/test_mutation_parity.py. The
port never uses this host build.
"""

from __future__ import annotations

import ctypes
import functools
import shutil

import jax.numpy as jnp
import numpy as np
import pytest

from snappier_tpu.format import oracle
from snappier_tpu.format.varint import write_varint
from snappier_tpu.ops.best_match import exact_candidates
from snappier_tpu.ops.pallas.crc32c import crc32c_blocks
from snappier_tpu.ops.pallas.scalar_codec import (
    _encode_best_pallas,
    decode_blocks_scalar,
    encode_blocks_scalar,
    match_extension_probe,
)
from tests.test_match_length import VECTORS, _layout
from tests.torch_cases import (
    ARRAY_WARP,
    CRC_LENGTHS,
    batch_streams,
    best_rows,
    corrupt_streams,
    crc_rows,
    empty_literal_streams,
    encode_rows,
    gxx_library,
    html_like,
    pack_streams,
    planted_matches,
    step_back_streams,
    tag_sweep_sample,
    walk_streams,
)

SHIM = (r"""
#include <sys/mman.h>
#include <unistd.h>

#include <condition_variable>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

#include "crc32c.cuh"
#include "decode_hybrid.cuh"
#include "decode_variants.cuh"
#include "encode_variants.cuh"
#include "scalar_codec.cuh"

namespace {
// Reusable barrier for the lanes of one block (a host stand-in for
// __syncwarp).
struct Barrier {
  std::mutex mu;
  std::condition_variable cv;
  int count, waiting = 0, phase = 0;
  explicit Barrier(int n) : count(n) {}
  void wait() {
    std::unique_lock<std::mutex> lk(mu);
    int ph = phase;
    if (++waiting == count) {
      waiting = 0;
      phase++;
      cv.notify_all();
    } else {
      cv.wait(lk, [&] { return phase != ph; });
    }
  }
};

struct BarrierSync {
  Barrier* b;
  void operator()() const { b->wait(); }
};
}  // namespace

"""
    + ARRAY_WARP
    + r"""
// `batch` rows of `width` bytes in a buffer whose end lies just below a page
// the process may not read. With offset kAtGuard the rows end at that page,
// so a read past the last row faults (where they start follows from batch *
// width); with an offset of 0-15 they start that many bytes past a 16-byte
// boundary and end at most 15 bytes below the page. Every other byte of the
// buffer is poisoned.
constexpr int32_t kAtGuard = -1;

struct GuardedRows {
  void* mem = nullptr;
  size_t span = 0, page = 0;
  uint8_t* rows = nullptr;
  GuardedRows(const uint8_t* src, int64_t batch, int64_t width, int32_t offset) {
    page = (size_t)sysconf(_SC_PAGESIZE);
    const size_t bytes = (size_t)(batch * width);
    const size_t gap = offset == kAtGuard ? 0 : (16 - ((size_t)offset + bytes) % 16) % 16;
    span = (bytes + gap + page - 1) / page * page;
    void* m = mmap(nullptr, span + page, PROT_READ | PROT_WRITE, MAP_PRIVATE | MAP_ANONYMOUS,
                   -1, 0);
    if (m == MAP_FAILED) return;
    uint8_t* guard = static_cast<uint8_t*>(m) + span;
    if (mprotect(guard, page, PROT_NONE) != 0) {
      munmap(m, span + page);
      return;
    }
    mem = m;
    memset(m, 0xA5, span);
    rows = guard - gap - bytes;
    memcpy(rows, src, bytes);
  }
  ~GuardedRows() {
    if (mem != nullptr) munmap(mem, span + page);
  }
};

template <int N, class Src, class Ld>
static sc::DecodeResult batched(const Src& src, const Ld& row, int32_t n, int32_t out_cap,
                                uint8_t* out, int64_t* counts, int unroll2 = 0) {
  ArrayWarp<N> w;
  auto emit = [&](const sc::Batch& bt, int32_t op, const auto& delta, const auto& start) {
    sc::emit_batch(w, row, bt, op, out, delta, start);
  };
  sc::DecodeResult r = unroll2 ? sc::decode_block_batched<2>(w, src, n, out_cap, emit)
                               : sc::decode_block_batched(w, src, n, out_cap, emit);
  counts[0] += w.batches;
  counts[1] += w.tags_seen;
  return r;
}

template <class Src, class Ld>
static sc::DecodeResult batched_lanes(int nlanes, const Src& src, const Ld& row, int32_t n,
                                      int32_t out_cap, uint8_t* out, int64_t* counts,
                                      int unroll2 = 0) {
  if (nlanes == 1) return batched<1>(src, row, n, out_cap, out, counts, unroll2);
  if (nlanes == 4) return batched<4>(src, row, n, out_cap, out, counts, unroll2);
  return batched<32>(src, row, n, out_cap, out, counts, unroll2);
}

// The batched decode walk on each row as the decode kernel reads it, the
// rows guarded at `offset` (GuardedRows), a warp of `nlanes` (1, 4 or 32)
// lanes, loader 0 sc::RingWords over sc::RowWords (rows at a multiple of 4
// and cc one; the ring poisoned), 1 sc::RowBytes; the batches written from
// the row's loader (RowWords, RowBytes), as the kernel's writing warp does;
// the output starts poisoned. counts[0] gets the batches that passed their
// checks and counts[1] their tags. Returns 0, or -1 if the buffer was
// refused.
extern "C" int host_decode(const uint8_t* comp, int64_t cc, const int32_t* lens, int64_t batch,
                           int32_t out_cap, int32_t nlanes, int32_t offset, int32_t loader,
                           uint8_t* out, int32_t* out_lens, int32_t* errs, int64_t* counts) {
  counts[0] = counts[1] = 0;
  GuardedRows g(comp, batch, cc, offset);
  if (g.mem == nullptr) return -1;
  static uint32_t lut[256];
  for (int t = 0; t < 256; t++) lut[t] = sc::tag_entry((uint32_t)t);
  std::vector<uint32_t> ring(256);
  for (int64_t b = 0; b < batch; b++) {
    const uint8_t* row = g.rows + b * cc;
    uint8_t* dst = out + b * out_cap;
    memset(dst, 0xDB, (size_t)out_cap);
    for (auto& v : ring) v = 0xDEADBEEFu;
    const sc::RowWords words{reinterpret_cast<const uint32_t*>(row), (int32_t)cc};
    const sc::RowBytes bytes{row, (int32_t)cc};
    using Ring = sc::RingWords<256>;
    const sc::DecodeResult r =
        loader == 0
            ? batched_lanes(nlanes, sc::ParsedTags<Ring>(Ring(words, ring.data()), lut), words,
                            lens[b], out_cap, dst, counts)
            : batched_lanes(nlanes, sc::ParsedTags<sc::RowBytes>(bytes, lut), bytes, lens[b],
                            out_cap, dst, counts);
    out_lens[b] = r.out_len;
    errs[b] = r.err;
  }
  return 0;
}

// The descriptor-driven walk of form 5, 6 or 7 (decode_desc_kernel's two
// warps in one) on each row: the compressed rows guarded at `offset` and
// read by loader 0 (sc::RowWords, rows at a multiple of 4 and cc one) or 1
// (sc::RowBytes); the descriptor rows (int32[batch, spec_cc]: spec0, and
// spec1 for form 7) in buffers that end at a page the process may not read,
// read through rings (poisoned first) as hy::DescribedTags takes them;
// `unroll2` two batches a loop iteration; the output starts poisoned.
// counts as host_decode's. Returns 0, or -1 if a buffer was refused.
template <int kForm>
static int hybrid_rows(const uint8_t* comp, int64_t cc, const int32_t* spec0,
                       const int32_t* spec1, int64_t spec_cc, const int32_t* lens, int64_t batch,
                       int32_t out_cap, int32_t nlanes, int32_t offset, int32_t loader,
                       int32_t unroll2, uint8_t* out, int32_t* out_lens, int32_t* errs,
                       int64_t* counts) {
  counts[0] = counts[1] = 0;
  GuardedRows g(comp, batch, cc, offset);
  GuardedRows g0(reinterpret_cast<const uint8_t*>(spec0), batch, spec_cc * 4, kAtGuard);
  GuardedRows g1(reinterpret_cast<const uint8_t*>(kForm == 7 ? spec1 : spec0), batch,
                 spec_cc * 4, kAtGuard);
  if (g.mem == nullptr || g0.mem == nullptr || g1.mem == nullptr) return -1;
  std::vector<uint32_t> ring0(256), ring1(256);
  const int32_t sw = (int32_t)spec_cc;
  using Ring = sc::RingWords<256>;
  for (int64_t b = 0; b < batch; b++) {
    const uint8_t* row = g.rows + b * cc;
    uint8_t* dst = out + b * out_cap;
    memset(dst, 0xDB, (size_t)out_cap);
    for (auto& v : ring0) v = 0xDEADBEEFu;
    for (auto& v : ring1) v = 0xDEADBEEFu;
    const int32_t n = lens[b] < 0 ? 0 : (lens[b] > sw ? sw : lens[b]);
    const uint8_t* r0 = g0.rows + b * spec_cc * 4;
    const uint8_t* r1 = g1.rows + b * spec_cc * 4;
    const Ring d0(sc::RowWords{reinterpret_cast<const uint32_t*>(r0), 4 * sw}, ring0.data());
    const Ring d1(sc::RowWords{reinterpret_cast<const uint32_t*>(r1), 4 * sw}, ring1.data());
    auto run = [&](const auto& in) {
      using Src = hy::DescribedTags<kForm, std::decay_t<decltype(in)>, Ring>;
      if constexpr (kForm == 7) {
        return batched_lanes(nlanes, Src(in, d0, d1, sw), in, n, out_cap, dst, counts, unroll2);
      } else {
        return batched_lanes(nlanes, Src(in, d0, hy::NoSpec{}, sw), in, n, out_cap, dst, counts,
                             unroll2);
      }
    };
    const sc::DecodeResult r =
        loader == 0 ? run(sc::RowWords{reinterpret_cast<const uint32_t*>(row), (int32_t)cc})
                    : run(sc::RowBytes{row, (int32_t)cc});
    out_lens[b] = r.out_len;
    errs[b] = r.err;
  }
  return 0;
}

extern "C" int host_hybrid(int32_t form, const uint8_t* comp, int64_t cc, const int32_t* spec0,
                           const int32_t* spec1, int64_t spec_cc, const int32_t* lens,
                           int64_t batch, int32_t out_cap, int32_t nlanes, int32_t offset,
                           int32_t loader, int32_t unroll2, uint8_t* out, int32_t* out_lens,
                           int32_t* errs, int64_t* counts) {
  auto call = [&](auto walk) {
    return walk(comp, cc, spec0, spec1, spec_cc, lens, batch, out_cap, nlanes, offset, loader,
                unroll2, out, out_lens, errs, counts);
  };
  if (form == 5) return call(hybrid_rows<5>);
  if (form == 6) return call(hybrid_rows<6>);
  return call(hybrid_rows<7>);
}

// decode_hybrid.cu's prepass_kernel on the host: each word g of each row
// (positions 4g .. 4g + 3) from words g and g + 1 of the row's loader (0
// sc::RowWords, 1 sc::RowBytes) through hy::describe_word, into spec0 (and
// spec1 for form 7), the rows guarded at `offset`. Returns 0, or -1 if the
// buffer was refused.
template <class Desc>
static int prepass_rows(const uint8_t* comp, int64_t cc, int64_t batch, int32_t offset,
                        int32_t loader, int32_t* spec0, int32_t* spec1) {
  GuardedRows g(comp, batch, cc, offset);
  if (g.mem == nullptr) return -1;
  const int32_t width = (int32_t)cc;
  int32_t* outs[2] = {spec0, spec1};
  for (int64_t b = 0; b < batch; b++) {
    const uint8_t* row = g.rows + b * cc;
    for (int32_t k = 0; 4 * k < width; k++) {
      int32_t d[Desc::kArrays][4];
      if (loader == 0) {
        hy::describe_word<Desc>(sc::RowWords{reinterpret_cast<const uint32_t*>(row), width}, k, d);
      } else {
        hy::describe_word<Desc>(sc::RowBytes{row, width}, k, d);
      }
      for (int a = 0; a < Desc::kArrays; a++) {
        for (int j = 0; j < 4 && 4 * k + j < width; j++) outs[a][b * cc + 4 * k + j] = d[a][j];
      }
    }
  }
  return 0;
}

extern "C" int host_prepass(int32_t form, const uint8_t* comp, int64_t cc, int64_t batch,
                            int32_t offset, int32_t loader, int32_t* spec0, int32_t* spec1) {
  return form == 7 ? prepass_rows<hy::SpecTwo>(comp, cc, batch, offset, loader, spec0, spec1)
                   : prepass_rows<hy::SpecOne>(comp, cc, batch, offset, loader, spec0, spec1);
}

// The pipelined walks of decode_pipe.cu (decode_pipe_kernel's two warps in
// one) on each row: sc::decode_block_batched<kUnits> over
// sc::ParsedTags<Ld, kEmpty> on a warp of N lanes, every batch written by
// sc::emit_batch<kUnc> from the row's loader into an image of out_cap bytes,
// the slack of kUnc's over-stores and a guard, all poisoned first (without
// `emit` no batch is handed on). Returns false if a clean walk stored a
// byte at or past its output's end and its slack, or any walk one in the
// guard past out_cap and the slack; counts[2] gets the rows where a clean
// walk stored a byte past its output's end.
constexpr int32_t kPipeGuard = 64;

template <int N, bool kEmpty, int kUnits, int kUnc, class Tags, class Ld>
static bool pipe_walk(const Tags& tags, const Ld& row, int32_t n, int32_t out_cap, bool emit,
                      uint8_t* dst, sc::DecodeResult& r, int64_t* counts) {
  ArrayWarp<N> w;
  const int32_t slack = sc::emit_slack(kUnc, N);
  std::vector<uint8_t> img((size_t)(out_cap + slack + kPipeGuard), 0xDB);
  auto step = [&](const sc::Batch& bt, int32_t op, const auto& delta, const auto& start) {
    if (emit) sc::emit_batch<kUnc>(w, row, bt, op, img.data(), delta, start);
  };
  r = sc::decode_block_batched<kUnits>(w, tags, n, out_cap, step);
  counts[0] += w.batches;
  counts[1] += w.tags_seen;
  memcpy(dst, img.data(), (size_t)out_cap);
  if (r.err != 0) {
    for (size_t i = (size_t)(out_cap + slack); i < img.size(); i++) {
      if (img[i] != 0xDB) return false;
    }
    return true;
  }
  bool past = false;
  for (int32_t i = r.out_len; i < (int32_t)img.size(); i++) {
    if (img[i] == 0xDB) continue;
    if (i >= r.out_len + slack) return false;
    past = true;
  }
  counts[2] += past;
  return true;
}

template <int N, bool kEmpty, int kUnits, int kUnc>
static int pipe_rows(const uint8_t* comp, int64_t cc, const int32_t* lens, int64_t batch,
                     int32_t out_cap, int32_t offset, int32_t loader, int32_t emit, uint8_t* out,
                     int32_t* out_lens, int32_t* errs, int64_t* counts) {
  counts[0] = counts[1] = counts[2] = 0;
  GuardedRows g(comp, batch, cc, offset);
  if (g.mem == nullptr) return -1;
  static uint32_t lut[256];
  for (int t = 0; t < 256; t++) lut[t] = sc::tag_entry((uint32_t)t);
  std::vector<uint32_t> ring(256);
  using Ring = sc::RingWords<256>;
  for (int64_t b = 0; b < batch; b++) {
    const uint8_t* row = g.rows + b * cc;
    for (auto& v : ring) v = 0xDEADBEEFu;
    const int32_t n = lens[b] < 0 ? 0 : (lens[b] > cc ? (int32_t)cc : lens[b]);
    const sc::RowWords words{reinterpret_cast<const uint32_t*>(row), (int32_t)cc};
    const sc::RowBytes bytes{row, (int32_t)cc};
    sc::DecodeResult r;
    const bool kept =
        loader == 0
            ? pipe_walk<N, kEmpty, kUnits, kUnc>(
                  sc::ParsedTags<Ring, kEmpty>(Ring(words, ring.data()), lut), words, n, out_cap,
                  emit != 0, out + b * out_cap, r, counts)
            : pipe_walk<N, kEmpty, kUnits, kUnc>(sc::ParsedTags<sc::RowBytes, kEmpty>(bytes, lut),
                                                 bytes, n, out_cap, emit != 0,
                                                 out + b * out_cap, r, counts);
    if (!kept) return -2;
    out_lens[b] = r.out_len;
    errs[b] = r.err;
  }
  return 0;
}

// A pipelined form (fold 0: decode_pipe, 1: decode_pipe2 with unroll, unc)
// through pipe_rows on a warp of `nlanes` (1, 4 or 32) lanes, the rows
// guarded at `offset` and read through loader 0 (the ring over word rows)
// or 1 (bytes). The forms are decode_pipe, decode_pipe2 at unroll 1-4 and
// at unroll 2 with unc 1 and 2: each unroll and each unc. counts[0] and
// [1] as host_decode's, [2] pipe_walk's. Returns 0, -1 if the buffer was
// refused, -2 if an over-store passed its slack, -3 for another form.
template <int N>
static int pipe_form(int32_t fold, int32_t unroll, int32_t unc, const uint8_t* comp, int64_t cc,
                     const int32_t* lens, int64_t batch, int32_t out_cap, int32_t offset,
                     int32_t loader, int32_t emit, uint8_t* out, int32_t* out_lens,
                     int32_t* errs, int64_t* counts) {
  auto call = [&](auto walk) {
    return walk(comp, cc, lens, batch, out_cap, offset, loader, emit, out, out_lens, errs,
                counts);
  };
  if (fold == 0) return unroll == 1 && unc == 0 ? call(pipe_rows<N, false, 1, 0>) : -3;
  if (unc == 0) {
    switch (unroll) {
      case 1: return call(pipe_rows<N, true, 1, 0>);
      case 2: return call(pipe_rows<N, true, 2, 0>);
      case 3: return call(pipe_rows<N, true, 3, 0>);
      case 4: return call(pipe_rows<N, true, 4, 0>);
    }
  }
  if (unroll == 2 && unc == 1) return call(pipe_rows<N, true, 2, 1>);
  if (unroll == 2 && unc == 2) return call(pipe_rows<N, true, 2, 2>);
  return -3;
}

extern "C" int host_pipe(int32_t fold, int32_t unroll, int32_t unc, int32_t emit,
                         const uint8_t* comp, int64_t cc, const int32_t* lens, int64_t batch,
                         int32_t out_cap, int32_t nlanes, int32_t offset, int32_t loader,
                         uint8_t* out, int32_t* out_lens, int32_t* errs, int64_t* counts) {
  auto call = [&](auto form) {
    return form(fold, unroll, unc, comp, cc, lens, batch, out_cap, offset, loader, emit, out,
                out_lens, errs, counts);
  };
  if (nlanes == 1) return call(pipe_form<1>);
  if (nlanes == 4) return call(pipe_form<4>);
  return call(pipe_form<32>);
}

// The ablation kernels of decode_variants.cu (decode_variant_kernel's two
// warps in one) on each row: variant 0 v2, 1 v4, 2 v3, 3 v1, 4 v1nock, 5
// v1nocp as dv::with_variant maps it, sc::decode_block_batched over
// dv::VariantTags on a warp of `nlanes` (1, 4 or 32) lanes through
// pipe_walk (its image, slack and guard poisoned first), the rows guarded at
// `offset` and read through loader 0 (the ring over word rows) or 1
// (bytes). counts as host_pipe's. Returns 0, -1 if the buffer was refused,
// -2 if an over-store passed its slack, -3 for another variant.
template <int N>
static int variant_rows(int32_t variant, const uint8_t* comp, int64_t cc, const int32_t* lens,
                        int64_t batch, int32_t out_cap, int32_t offset, int32_t loader,
                        uint8_t* out, int32_t* out_lens, int32_t* errs, int64_t* counts) {
  counts[0] = counts[1] = counts[2] = 0;
  GuardedRows g(comp, batch, cc, offset);
  if (g.mem == nullptr) return -1;
  static uint32_t lut[256];
  for (int t = 0; t < 256; t++) lut[t] = sc::tag_entry((uint32_t)t);
  std::vector<uint32_t> ring(256);
  using Ring = sc::RingWords<256>;
  const int rc = dv::with_variant(variant, [&](auto checks, auto unc, bool emit) {
    constexpr bool K = decltype(checks)::value;
    constexpr int U = decltype(unc)::value;
    for (int64_t b = 0; b < batch; b++) {
      const uint8_t* row = g.rows + b * cc;
      for (auto& v : ring) v = 0xDEADBEEFu;
      const int32_t n = lens[b] < 0 ? 0 : (lens[b] > cc ? (int32_t)cc : lens[b]);
      const sc::RowWords words{reinterpret_cast<const uint32_t*>(row), (int32_t)cc};
      const sc::RowBytes bytes{row, (int32_t)cc};
      sc::DecodeResult r;
      const bool kept =
          loader == 0
              ? pipe_walk<N, false, 1, U>(
                    dv::VariantTags<Ring, K>(Ring(words, ring.data()), lut, n), words, n,
                    out_cap, emit, out + b * out_cap, r, counts)
              : pipe_walk<N, false, 1, U>(dv::VariantTags<sc::RowBytes, K>(bytes, lut, n),
                                          bytes, n, out_cap, emit, out + b * out_cap, r, counts);
      if (!kept) return -2;
      out_lens[b] = r.out_len;
      errs[b] = r.err;
    }
    return 0;
  });
  return rc == -1 ? -3 : rc;
}

extern "C" int host_variant(int32_t variant, const uint8_t* comp, int64_t cc,
                            const int32_t* lens, int64_t batch, int32_t out_cap, int32_t nlanes,
                            int32_t offset, int32_t loader, uint8_t* out, int32_t* out_lens,
                            int32_t* errs, int64_t* counts) {
  auto call = [&](auto walk) {
    return walk(variant, comp, cc, lens, batch, out_cap, offset, loader, out, out_lens, errs,
                counts);
  };
  if (nlanes == 1) return call(variant_rows<1>);
  if (nlanes == 4) return call(variant_rows<4>);
  return call(variant_rows<32>);
}

// The encode-ablation walk of one row under a mask; `fixed` takes the walk
// whose mask is a template argument where the shim has it, as the kernels do.
template <class Ld>
static int32_t encode_variant_row(const Ld& ld, int32_t n, uint16_t* table, uint32_t mask,
                                  int32_t hash_bits, int32_t store_step, int32_t fixed,
                                  uint8_t* out) {
  constexpr uint32_t E3 = sc::EV_EXT_4 | sc::EV_XOR_TAIL | sc::EV_BFREE_COPY;
  constexpr uint32_t PRE = E3 | sc::EV_LOOP_PRE;
  if (fixed && mask == E3) {
    return sc::encode_fragment_variant(ld, n, table, sc::StaticWalk<E3>{hash_bits, store_step},
                                       out);
  }
  if (fixed && mask == PRE) {
    return sc::encode_fragment_variant(ld, n, table, sc::StaticWalk<PRE>{hash_bits, store_step},
                                       out);
  }
  return sc::encode_fragment_variant(ld, n, table, sc::DynWalk{mask, hash_bits, store_step},
                                     out);
}

// The rows, guarded at `offset` (GuardedRows), each through the
// encode-ablation walk as the kernels read them: loader 0 sc::RowWords, 1
// sc::RowBytes. Returns 0, or -1 if the buffer was refused.
extern "C" int host_encode_variant(uint32_t mask, int32_t hash_bits, int32_t store_step,
                                   int32_t fixed, const uint8_t* frags, int64_t frag_w,
                                   const int32_t* lens, int64_t batch, int32_t offset,
                                   int32_t loader, uint8_t* bodies, int64_t body_w,
                                   int32_t* body_lens) {
  GuardedRows g(frags, batch, frag_w, offset);
  if (g.mem == nullptr) return -1;
  std::vector<uint16_t> table((size_t)1 << hash_bits);
  for (int64_t b = 0; b < batch; b++) {
    int32_t n = lens[b] < 0 ? 0 : (lens[b] > frag_w ? (int32_t)frag_w : lens[b]);
    for (auto& e : table) e = sc::EMPTY;
    const uint8_t* row = g.rows + b * frag_w;
    uint8_t* out = bodies + b * body_w;
    body_lens[b] =
        loader == 0
            ? encode_variant_row(sc::RowWords{reinterpret_cast<const uint32_t*>(row), n}, n,
                                 table.data(), mask, hash_bits, store_step, fixed, out)
            : encode_variant_row(sc::RowBytes{row, n}, n, table.data(), mask, hash_bits,
                                 store_step, fixed, out);
  }
  return 0;
}

// The rows, guarded at `offset` (GuardedRows), each through encode_stats.cu's
// row sink (ev::StatsOut under ev::kStatsWalk) as the kernel reads it: loader
// 0 sc::RowWords, 1 sc::RowBytes; (miss iterations, hits, extension
// iterations, matched bytes) per fragment. Returns 0, or -1 if the buffer
// was refused.
extern "C" int host_encode_stats(const uint8_t* frags, int64_t frag_w, const int32_t* lens,
                                 int64_t batch, int32_t offset, int32_t loader, int32_t* stats) {
  GuardedRows g(frags, batch, frag_w, offset);
  if (g.mem == nullptr) return -1;
  std::vector<uint16_t> table((size_t)1 << ev::kStatsWalk.hash_bits);
  const ev::StatsRows sinks{stats};
  for (int64_t b = 0; b < batch; b++) {
    int32_t n = lens[b] < 0 ? 0 : (lens[b] > frag_w ? (int32_t)frag_w : lens[b]);
    for (auto& e : table) e = sc::EMPTY;
    const uint8_t* row = g.rows + b * frag_w;
    if (loader == 0) {
      sinks.at(b).walk(sc::RowWords{reinterpret_cast<const uint32_t*>(row), n}, n, table.data(),
                       ev::kStatsWalk);
    } else {
      sinks.at(b).walk(sc::RowBytes{row, n}, n, table.data(), ev::kStatsWalk);
    }
  }
  return 0;
}

// The rows, guarded at `offset` (GuardedRows), each through the greedy walk
// as the encode kernel reads it: loader 0 sc::RowWords, 1 sc::RowBytes. Returns 0,
// or -1 if the buffer was refused.
extern "C" int host_encode_rows(const uint8_t* frags, int64_t frag_w, const int32_t* lens,
                                int64_t batch, int32_t offset, int32_t loader,
                                int32_t hash_bits, int32_t skip_base, uint8_t* bodies,
                                int64_t body_w, int32_t* body_lens) {
  GuardedRows g(frags, batch, frag_w, offset);
  if (g.mem == nullptr) return -1;
  std::vector<uint16_t> table((size_t)1 << hash_bits);
  for (int64_t b = 0; b < batch; b++) {
    int32_t n = lens[b] < 0 ? 0 : (lens[b] > frag_w ? (int32_t)frag_w : lens[b]);
    for (auto& e : table) e = sc::EMPTY;
    const uint8_t* row = g.rows + b * frag_w;
    uint8_t* out = bodies + b * body_w;
    body_lens[b] =
        loader == 0
            ? sc::encode_fragment(sc::RowWords{reinterpret_cast<const uint32_t*>(row), n}, n,
                                  table.data(), hash_bits, skip_base, out)
            : sc::encode_fragment(sc::RowBytes{row, n}, n, table.data(), hash_bits, skip_base,
                                  out);
  }
  return 0;
}

// The rows, guarded at `offset`, and their int32 candidates, ending at the
// guard page (GuardedRows), through the level="best" walk as the best encode
// kernel reads them: loader 0
// sc::RowWords, 1 sc::RowBytes. Returns 0, or -1 if a buffer was refused.
extern "C" int host_encode_best(const uint8_t* frags, int64_t frag_w, const int32_t* lens,
                                const int32_t* cands, int64_t batch, int32_t offset,
                                int32_t loader, int32_t skip_base, uint8_t* bodies,
                                int64_t body_w, int32_t* body_lens) {
  GuardedRows g(frags, batch, frag_w, offset);
  GuardedRows gc(reinterpret_cast<const uint8_t*>(cands), batch, frag_w * 4, kAtGuard);
  if (g.mem == nullptr || gc.mem == nullptr) return -1;
  for (int64_t b = 0; b < batch; b++) {
    int32_t n = lens[b] < 0 ? 0 : (lens[b] > frag_w ? (int32_t)frag_w : lens[b]);
    const uint8_t* row = g.rows + b * frag_w;
    const int32_t* crow = reinterpret_cast<const int32_t*>(gc.rows) + b * frag_w;
    uint8_t* out = bodies + b * body_w;
    body_lens[b] =
        loader == 0
            ? sc::encode_fragment_best(sc::RowWords{reinterpret_cast<const uint32_t*>(row), n},
                                       n, crow, skip_base, out)
            : sc::encode_fragment_best(sc::RowBytes{row, n}, n, crow, skip_base, out);
  }
  return 0;
}

// The CRC32C kernel's row walk (csrc/crc32c.cuh) on `nblocks` blocks, one
// after another, each of crc::kWarps threads that run a warp of 32 array
// lanes and share a barrier, block k taking rows k, k + nblocks, ..., over
// shared tables filled from `tables` as the kernel fills them. With `guard`
// the rows end at a page the process may not read (GuardedRows at kAtGuard),
// so a read past the last row's end faults; else they start `offset` bytes past a
// 16-byte boundary. Returns 0, or -1 if the buffer was refused.
extern "C" int host_crc32c(const uint8_t* rows, int64_t width, const int32_t* lens,
                           int64_t batch, int32_t offset, int32_t guard, int32_t nblocks,
                           const uint32_t* tables, int32_t* out) {
  GuardedRows g(rows, guard ? batch : 0, width, kAtGuard);
  std::vector<uint8_t> buf((size_t)(batch * width) + 32);
  uint8_t* at = buf.data() + ((16 - (uintptr_t)buf.data() % 16) % 16) + offset;
  if (guard) {
    if (g.mem == nullptr) return -1;
    at = g.rows;
  } else {
    memcpy(at, rows, (size_t)(batch * width));
  }
  ArrayWarp<32>::Lanes<crc::Tables> t;
  for (int k = 0; k < nblocks; k++) {
    std::vector<uint32_t> smem(crc::kSmemWords);
    crc::fill_shared(smem.data(), tables, lens, batch, k, nblocks, 0, 1);
    for (int l = 0; l < 32; l++) t[l] = crc::lane_tables(smem.data(), tables, l);
    Barrier bar(crc::kWarps);
    std::vector<std::thread> warps;
    for (int wi = 0; wi < crc::kWarps; wi++) {
      warps.emplace_back([&, wi] {
        ArrayWarp<32> w;
        crc::crc_rows(w, wi, t, smem.data(), BarrierSync{&bar}, at, width, lens, batch, k,
                      nblocks, out);
      });
    }
    for (auto& th : warps) th.join();
  }
  return 0;
}

// The state x shifted by lane `lane`'s view of the spread step table
// (which 0) or fold table (1), as the kernel fills and reads them.
extern "C" uint32_t host_crc_spread(const uint32_t* tables, int32_t which, int32_t lane,
                                    uint32_t x) {
  std::vector<uint32_t> smem(crc::kSmemWords);
  crc::fill_shared(smem.data(), tables, nullptr, 0, 0, 1, 0, 1);
  const crc::Tables t = crc::lane_tables(smem.data(), tables, lane);
  return which == 0 ? t.shift<crc::Tables::kStepAt>(x) : t.shift<crc::Tables::kFoldAt>(x);
}

// The probe kernel's row (csrc/probe.cu): the walk over the spans' rings
// (sc::SpanRings, filled by a warp of 32 array lanes; the rings start
// poisoned and are kept from row to row, as a warp's are on the card), the
// arguments as given, clamped by sc::probe_args, the rows guarded at
// `offset` (GuardedRows). Returns 0, or -1 if the buffer was refused.
extern "C" int host_probe(const uint8_t* bufs, int64_t cc, const int32_t* ats,
                          const int32_t* cands, const int32_t* ns, int64_t batch, int32_t offset,
                          int32_t* out) {
  GuardedRows g(bufs, batch, cc, offset);
  if (g.mem == nullptr) return -1;
  std::vector<uint32_t> ring(2 * 128, 0xA5A5A5A5u);
  for (int64_t b = 0; b < batch; b++) {
    const sc::RowSpan row(g.rows + b * cc, (int32_t)cc);
    const sc::ProbeArgs a = sc::probe_args(cc, ats[b], cands[b], ns[b]);
    out[b] = sc::match_extension_ring<128>(ArrayWarp<32>{}, row, a, ring.data());
  }
  return 0;
}

// sc::extend_match on each row over a key of the row's bytes (zero outside
// the row), the arguments clamped by sc::probe_args: each walk's length
// and its stride-8 steps (its seed hook's calls).
extern "C" void host_probe_steps(const uint8_t* bufs, int64_t cc, const int32_t* ats,
                                 const int32_t* cands, const int32_t* ns, int64_t batch,
                                 int32_t* lens, int32_t* steps) {
  for (int64_t b = 0; b < batch; b++) {
    const uint8_t* row = bufs + b * cc;
    auto byte = [&](int32_t i) -> uint32_t { return i >= 0 && i < cc ? row[i] : 0u; };
    const sc::ProbeArgs a = sc::probe_args(cc, ats[b], cands[b], ns[b]);
    int32_t k = 0;
    lens[b] = sc::extend_match(
        [&](int32_t i) {
          return byte(i) | (byte(i + 1) << 8) | (byte(i + 2) << 16) | (byte(i + 3) << 24);
        },
        a.at, a.cand, a.n, [&](int32_t) { k++; });
    steps[b] = k;
  }
}
""")


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    so = gxx_library(SHIM, tmp_path_factory.mktemp("walk_host"))
    P, I32, I64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
    so.host_decode.argtypes = [P, I64, P, I64, I32, I32, I32, I32, P, P, P, P]
    so.host_decode.restype = I32
    so.host_encode_rows.argtypes = [P, I64, P, I64, I32, I32, I32, I32, P, I64, P]
    so.host_encode_rows.restype = I32
    so.host_encode_best.argtypes = [P, I64, P, P, I64, I32, I32, I32, P, I64, P]
    so.host_encode_best.restype = I32
    so.host_probe.argtypes = [P, I64, P, P, P, I64, I32, P]
    so.host_probe.restype = I32
    so.host_probe_steps.argtypes = [P, I64, P, P, P, I64, P, P]
    so.host_probe_steps.restype = None
    so.host_variant.argtypes = [I32, P, I64, P, I64, I32, I32, I32, I32, P, P, P, P]
    so.host_variant.restype = I32
    so.host_pipe.argtypes = [I32, I32, I32, I32, P, I64, P, I64, I32, I32, I32, I32, P, P, P,
                             P]
    so.host_pipe.restype = I32
    so.host_encode_variant.argtypes = [ctypes.c_uint32, I32, I32, I32, P, I64, P, I64, I32, I32,
                                       P, I64, P]
    so.host_encode_variant.restype = I32
    so.host_hybrid.argtypes = [I32, P, I64, P, P, I64, P, I64, I32, I32, I32, I32, I32, P, P, P,
                               P]
    so.host_hybrid.restype = I32
    so.host_prepass.argtypes = [I32, P, I64, I64, I32, I32, P, P]
    so.host_prepass.restype = I32
    so.host_encode_stats.argtypes = [P, I64, P, I64, I32, I32, P]
    so.host_encode_stats.restype = I32
    so.host_crc32c.argtypes = [P, I64, P, I64, I32, I32, I32, P, P]
    so.host_crc32c.restype = I32
    so.host_crc_spread.argtypes = [P, I32, I32, ctypes.c_uint32]
    so.host_crc_spread.restype = ctypes.c_uint32
    return so


#: Where the rows lie in their guarded buffer (``GuardedRows``): AT_GUARD
#: ends them at the page the process may not read; an int starts them that
#: many bytes past a 16-byte boundary, under the same page.
AT_GUARD = None


def _offset_arg(offset) -> int:
    return -1 if offset is AT_GUARD else offset


def _aligned_cases(width: int):
    """(offset, loader) pairs that move a row's alignment: the byte loader
    0-7 bytes past a 16-byte boundary, the word loader 0, 4, 8 and 12 where
    the width is a multiple of 4."""
    return [(o, 1) for o in range(8)] + ([(o, 0) for o in (0, 4, 8, 12)] if width % 4 == 0
                                         else [])


def _host_decode(lib, comp, lens, out_cap, nlanes, offset=AT_GUARD, loader=0):
    """The batched decode walk on a warp of ``nlanes`` lanes, the rows
    placed at ``offset`` in a guarded buffer, through loader 0 (words) or 1
    (bytes): ``(out, out_lens, errs, (batches, tags))``."""
    comp = np.ascontiguousarray(comp, np.uint8)
    lens = np.ascontiguousarray(lens, np.int32)
    B, cc = comp.shape
    out = np.zeros((B, out_cap), np.uint8)
    out_lens = np.zeros(B, np.int32)
    errs = np.zeros(B, np.int32)
    counts = np.zeros(2, np.int64)
    rc = lib.host_decode(comp.ctypes.data, cc, lens.ctypes.data, B, out_cap, nlanes,
                         _offset_arg(offset), loader, out.ctypes.data, out_lens.ctypes.data,
                         errs.ctypes.data, counts.ctypes.data)
    assert rc == 0
    return out, out_lens, errs, tuple(counts.tolist())


def _host_encode_rows(lib, frags, lens, offset, loader, hash_bits):
    frags = np.ascontiguousarray(frags, np.uint8)
    lens = np.ascontiguousarray(lens, np.int32)
    B, F = frags.shape
    W = F + 2048
    bodies = np.zeros((B, W), np.uint8)
    body_lens = np.zeros(B, np.int32)
    rc = lib.host_encode_rows(frags.ctypes.data, F, lens.ctypes.data, B, _offset_arg(offset),
                              loader, hash_bits, 32, bodies.ctypes.data, W,
                              body_lens.ctypes.data)
    assert rc == 0
    return bodies, body_lens


def _walk_rows(F: int):
    """encode_rows(F), a markup row of 100 bytes and, last, a period-5 row
    of the full width, so that a match runs to the end of the buffer."""
    frags, lens = encode_rows(F)
    rng = np.random.default_rng(F)
    extra = rng.integers(0, 256, (2, F)).astype(np.int32)
    short = min(100, F)
    extra[0, :short] = html_like(short, 5)
    extra[1] = np.tile(rng.integers(0, 256, 5), F)[:F]
    return np.concatenate([frags, extra]), np.concatenate([lens, [short, F]]).astype(np.int32)


# (F, hash_bits): the widths the JAX kernel takes at 15 bits (ids F), then
# widths with no 16-byte or 4-byte multiple, at 8-16 bits.
_WALK_CASES = [(F, 15) for F in (1024, 8192, 65536)] + [
    (F, hb) for F in (100, 4097, 65535, 65536) for hb in (8, 12, 15, 16) if (F, hb) != (65536, 15)]


@functools.lru_cache(maxsize=None)
def _encode_walk_refs(F: int, hash_bits: int):
    """``_walk_rows(F)`` and the JAX kernel's bodies and lengths for them in
    interpret mode (on rows padded to its 1,024-byte multiple)."""
    frags, lens = _walk_rows(F)
    Fj = -(-F // 1024) * 1024
    padded = np.random.default_rng(2).integers(0, 256, (len(lens), Fj)).astype(np.int32)
    padded[:, :F] = frags
    ref_b, ref_l = encode_blocks_scalar(jnp.asarray(padded), jnp.asarray(lens), interpret=True,
                                        hash_bits=hash_bits)
    return frags, lens, np.asarray(ref_b), np.asarray(ref_l)


def _same_bodies(got_b, got_l, ref_b, ref_l, what):
    assert (got_l == ref_l).all(), (what, got_l, ref_l)
    for i in range(len(ref_l)):
        assert (got_b[i, : got_l[i]] == ref_b[i, : ref_l[i]]).all(), (what, i)


_WALK_IDS = [str(F) if hb == 15 and F % 1024 == 0 else f"{F}-hb{hb}" for F, hb in _WALK_CASES]


@pytest.mark.parametrize("F,hash_bits", _WALK_CASES, ids=_WALK_IDS)
def test_host_encode_walk_matches_jax(host_lib, F, hash_bits):
    """The greedy walk through each of the kernel's loaders, the word loader
    (widths of a 4-byte multiple) and the byte loader, the rows in a buffer
    that ends at the last row's end, each equal to the JAX kernel in
    interpret mode (on rows padded to its 1,024-byte multiple) and to the
    plain version."""
    import torch

    from snappier_tpu_torch.ops.cuda.scalar_codec import encode_blocks_plain

    frags, lens, ref_b, ref_l = _encode_walk_refs(F, hash_bits)
    f_u8, l_t = torch.from_numpy(frags.astype(np.uint8)), torch.from_numpy(lens)
    plain_b, plain_l = (x.numpy() for x in encode_blocks_plain(f_u8, l_t, hash_bits, 32))
    _same_bodies(plain_b, plain_l, ref_b, ref_l, "plain")
    for loader in ((0, 1) if F % 4 == 0 else (1,)):
        got_b, got_l = _host_encode_rows(host_lib, frags, lens, AT_GUARD, loader, hash_bits)
        _same_bodies(got_b, got_l, ref_b, ref_l, f"loader {loader}")
    for i in range(len(lens)):
        comp = write_varint(int(lens[i])) + got_b[i, : got_l[i]].tobytes()
        assert oracle.decompress(comp) == frags[i, : lens[i]].astype(np.uint8).tobytes()


@pytest.mark.parametrize("F,hash_bits", _WALK_CASES, ids=_WALK_IDS)
def test_host_encode_walk_on_unaligned_rows(host_lib, F, hash_bits):
    """The greedy walk on rows that start 0-7 bytes past a 16-byte boundary
    (the byte loader) and 0, 4, 8 and 12 bytes past one (the word loader,
    widths of a 4-byte multiple), under the guard page, each equal to the
    JAX kernel in interpret mode."""
    frags, lens, ref_b, ref_l = _encode_walk_refs(F, hash_bits)
    for offset, loader in _aligned_cases(F):
        got_b, got_l = _host_encode_rows(host_lib, frags, lens, offset, loader, hash_bits)
        _same_bodies(got_b, got_l, ref_b, ref_l, f"loader {loader} at offset {offset}")


def _decode_groups():
    """(name, streams, cc, out_cap) of the batched decode walk's cases:
    small and corrupt blocks; the tag-sweep sample; oracle blocks of up to
    64 KiB with the main path's word mix; the batch edges of
    ``torch_cases.batch_streams`` at a width that ends at the longest
    stream (rows end just below the guard page)."""
    import chip_smoke

    small = [oracle.compress(np.frombuffer(d, np.uint8)) for d in (
        b"", b"a", b"ab" * 50, b"a" * 300, b"the quick brown snappy " * 20, bytes(500),
        bytes(range(1, 6)) * 150,
    )] + corrupt_streams()
    datas = [html_like(65536, 3).tobytes(), html_like(40000, 4).tobytes(), b"", b"a",
             bytes(65536), bytes(range(1, 6)) * 9000,
             np.random.default_rng(2).integers(0, 256, 3000, np.uint8).tobytes(),
             chip_smoke.word_mix()[:65536]]
    big = [oracle.compress(np.frombuffer(d, np.uint8)) for d in datas]
    edges = batch_streams()
    return [("small", small, 2048, 1024), ("sweep", tag_sweep_sample(), 1024, 2048),
            ("oracle", big, 68608, 65536), ("edges", edges, max(map(len, edges)), 8192)]


@pytest.fixture(scope="module")
def decode_refs():
    """Each group with the JAX kernel's triple in interpret mode (on rows
    padded to a multiple of 1,024 bytes: bytes past a length never change a
    verdict)."""
    refs = []
    for name, streams, cc, out_cap in _decode_groups():
        comp, lens = pack_streams(streams, cc)
        wide, _ = pack_streams(streams, -(-cc // 1024) * 1024)
        ref = [np.asarray(x) for x in decode_blocks_scalar(
            jnp.asarray(wide), jnp.asarray(lens), out_cap=out_cap, interpret=True)]
        refs.append((name, comp, lens, out_cap, ref))
    return refs


def _loader_cases(cc: int):
    """(offset, loader) pairs that end the rows at the guard page: the byte
    loader, and the word loader (the decode walk's ring over it) where the
    width is a multiple of 4."""
    return [(AT_GUARD, 1)] + ([(AT_GUARD, 0)] if cc % 4 == 0 else [])


def _hold_decode_to_jax(host_lib, decode_refs, nlanes, cases):
    for name, comp, lens, out_cap, ref in decode_refs:
        for offset, loader in cases(comp.shape[1]):
            what = f"{name}, offset {offset}, loader {loader}"
            out, out_lens, errs, (batches, tags) = _host_decode(
                host_lib, comp, lens, out_cap, nlanes, offset, loader)
            assert (errs == ref[2]).all(), (what, errs, ref[2])
            assert (out_lens == ref[1]).all(), what
            for i in range(len(lens)):
                assert (out[i, : out_lens[i]] == ref[0][i, : ref[1][i]]).all(), (what, i)
            assert tags <= nlanes * batches, what


@pytest.mark.parametrize("nlanes", [1, 4, 32])
def test_host_decode_walk_matches_jax(host_lib, decode_refs, nlanes):
    """The batched decode walk on a warp of 1, 4 and 32 lanes (the card's),
    through each loader into a buffer that ends at the last row's end (the
    ring too), equal to the JAX kernel in interpret mode on every group:
    the same error word, out_len and out[:out_len]. On the word mix the 32
    lanes resolve more than 8 tags a step."""
    _hold_decode_to_jax(host_lib, decode_refs, nlanes, _loader_cases)
    name, comp, lens, out_cap, ref = decode_refs[2]
    mix = comp[-1:], lens[-1:]
    _, out_lens, errs, (batches, tags) = _host_decode(host_lib, *mix, out_cap, nlanes)
    assert errs[0] == 0 and out_lens[0] == 65536
    assert tags > (8 * batches if nlanes == 32 else batches if nlanes == 4 else 0)


@pytest.mark.parametrize("nlanes", [1, 4, 32])
def test_host_decode_walk_on_unaligned_rows(host_lib, decode_refs, nlanes):
    """The batched decode walk with the rows 0-7 bytes past a 16-byte
    boundary (the byte loader) and 0, 4, 8 and 12 past one (the ring over
    the word loader, widths of a 4-byte multiple), under the guard page,
    equal to the JAX kernel in interpret mode on every group."""
    _hold_decode_to_jax(host_lib, decode_refs, nlanes, _aligned_cases)


def _mutant_rows():
    from tests.test_mutation_parity import CC, OUT_CAP, _base_streams, _mutants

    mutants = _mutants(_base_streams())
    comp, lens = pack_streams(mutants, CC, garbage_seed=None)
    return mutants, comp, lens, OUT_CAP


def _oracle_verdicts(mutants, out_cap):
    """Per mutant: None for a claim past out_cap (a capacity rejection, not
    a stream verdict), else the oracle's decoded bytes or False."""
    from snappier_tpu.errors import InvalidDataError, SnappyError
    from snappier_tpu.format.varint import read_varint

    verdicts = []
    for mb in mutants:
        try:
            claim, _ = read_varint(np.frombuffer(mb, np.uint8))
        except Exception:
            claim = None
        if claim is not None and claim > out_cap:
            verdicts.append(None)
            continue
        try:
            verdicts.append(bytes(oracle.decompress(np.frombuffer(mb, np.uint8))))
        except (SnappyError, InvalidDataError):
            verdicts.append(False)
    return verdicts


def _hold_to_oracle(verdicts, out, out_lens, errs, what):
    accepted = 0
    for i, v in enumerate(verdicts):
        if v is None or v is False:
            assert errs[i] != 0, (what, i)
            continue
        accepted += 1
        assert errs[i] == 0 and out_lens[i] == len(v), (what, i, errs[i])
        assert out[i, : len(v)].tobytes() == v, (what, i)
    assert accepted >= 20 and len(verdicts) - accepted >= 500, (what, accepted)


@pytest.mark.parametrize("nlanes", [1, 4, 32])
def test_host_decode_walk_matches_oracle_on_mutants(host_lib, nlanes):
    """Verdict parity on the block mutation set of tests/test_mutation_parity.py
    (all of it): the batched walk, through each loader, accepts what the
    oracle accepts with its bytes and rejects what it rejects; claims past
    out_cap are rejected."""
    mutants, comp, lens, out_cap = _mutant_rows()
    verdicts = _oracle_verdicts(mutants, out_cap)
    for offset, loader in ((AT_GUARD, 0), (3, 1), (4, 0)):
        out, out_lens, errs, _ = _host_decode(host_lib, comp, lens, out_cap, nlanes, offset,
                                              loader)
        _hold_to_oracle(verdicts, out, out_lens, errs, f"loader {loader}")


def test_plain_decode_matches_oracle_on_mutants():
    """The same verdict parity for the decode kernel's plain version."""
    import torch

    from snappier_tpu_torch.ops.cuda.scalar_codec import decode_blocks_plain

    mutants, comp, lens, out_cap = _mutant_rows()
    out, out_lens, errs = (x.numpy() for x in decode_blocks_plain(
        torch.from_numpy(comp.astype(np.uint8)), torch.from_numpy(lens), out_cap))
    _hold_to_oracle(_oracle_verdicts(mutants, out_cap), out, out_lens, errs, "plain")


@functools.lru_cache(maxsize=None)
def _best_refs():
    """``best_rows(4096, seed=8)``, their candidates and the JAX kernel's
    bodies and lengths in interpret mode."""
    frags, lens = best_rows(4096, seed=8)
    cands = np.asarray(exact_candidates(jnp.asarray(frags), jnp.asarray(lens)), np.int32)
    ref_b, ref_l = (np.asarray(x) for x in _encode_best_pallas(
        jnp.asarray(frags), jnp.asarray(lens), jnp.asarray(cands), interpret=True))
    return np.ascontiguousarray(frags, np.uint8), lens, cands, ref_b, ref_l


def _hold_best_to_jax(host_lib, cases):
    f8, lens, cands, ref_b, ref_l = _best_refs()
    B, F = f8.shape
    for offset, loader in cases(F):
        bodies = np.zeros((B, F + 2048), np.uint8)
        body_lens = np.zeros(B, np.int32)
        rc = host_lib.host_encode_best(f8.ctypes.data, F, lens.ctypes.data, cands.ctypes.data,
                                       B, _offset_arg(offset), loader, 32, bodies.ctypes.data,
                                       F + 2048, body_lens.ctypes.data)
        assert rc == 0
        _same_bodies(bodies, body_lens, ref_b, ref_l, (offset, loader))


def test_host_best_walk_matches_jax(host_lib):
    """The level="best" walk through each loader, the rows and their
    candidates in buffers that end at a guard page, equal to the JAX kernel
    in interpret mode."""
    _hold_best_to_jax(host_lib, _loader_cases)


def test_host_best_walk_on_unaligned_rows(host_lib):
    """The level="best" walk with the rows 0-7 bytes past a 16-byte boundary
    (the byte loader) and 0, 4, 8 and 12 past one (the word loader), under
    the guard page, equal to the JAX kernel in interpret mode."""
    _hold_best_to_jax(host_lib, _aligned_cases)


def _host_probe(host_lib, bufs, ats, cands, ns, offset) -> np.ndarray:
    """The probe kernel's row function on each row, the rows guarded at
    ``offset``."""
    bufs = np.ascontiguousarray(bufs, np.uint8)
    args = [np.ascontiguousarray(a, np.int32) for a in (ats, cands, ns)]
    out = np.zeros(len(bufs), np.int32)
    assert host_lib.host_probe(bufs.ctypes.data, bufs.shape[1], *(a.ctypes.data for a in args),
                               len(bufs), _offset_arg(offset), out.ctypes.data) == 0
    return out


def _jax_probe(bufs, ats, cands, ns, width: int) -> np.ndarray:
    """The interpreted TPU kernel on the rows zero-padded to ``width`` (a
    multiple of 1,024 with room for the walk's zero slack), on the
    arguments as the kernel clamps them."""
    cc = bufs.shape[1]
    padded = np.zeros((len(bufs), width), np.int32)
    padded[:, :cc] = bufs
    ns = np.clip(ns, 0, cc)
    ats, cands = np.minimum(np.maximum(ats, 0), ns), np.clip(cands, 0, cc)
    return np.asarray(match_extension_probe(jnp.asarray(padded), ats.astype(np.int32),
                                            cands.astype(np.int32), ns.astype(np.int32),
                                            interpret=True))


def test_host_probe_walk_matches_jax(host_lib):
    """The probe kernel's row (the walk over the spans' rings filled by a
    warp) on the golden vectors and planted matches in rows of 8,192 bytes, at the guard page and 1-3 bytes
    past a 16-byte boundary (unaligned words), equal to the JAX kernel in
    interpret mode and to the golden and planted lengths."""
    golden = [(e, *_layout(s1, s2, ln)) for e, s1, s2, ln in VECTORS if e >= 4]
    g_bufs = np.zeros((len(golden), 8192), np.uint8)
    for i, (_, buf, _, _) in enumerate(golden):
        g_bufs[i, : len(buf)] = np.frombuffer(buf, np.uint8)
    bufs, ats, cands, ns, planted = planted_matches(16, 8192, seed=12)
    bufs = np.ascontiguousarray(np.concatenate([g_bufs, bufs]))
    ats = np.concatenate([[g[2] for g in golden], ats]).astype(np.int32)
    cands = np.concatenate([np.zeros(len(golden)), cands]).astype(np.int32)
    ns = np.concatenate([[g[3] for g in golden], ns]).astype(np.int32)
    ref = _jax_probe(bufs, ats, cands, ns, 8192)
    assert (ref == [g[0] for g in golden] + planted.tolist()).all()
    for offset in (AT_GUARD, 1, 2, 3):
        out = _host_probe(host_lib, bufs, ats, cands, ns, offset)
        assert (out == ref).all(), (offset, out, ref)


def _edge_rows(width: int, seed: int):
    """Probe rows of ``width`` random bytes (each row's garbage past its
    width is the next row's bytes, or the guard's poison) whose walks touch
    the row's edges: matches planted anywhere; a match from byte 0 that runs
    to byte width - 1; a candidate whose span runs past the row (zeros); at
    equal to n; n at the width and past it; arguments outside the clamps."""
    rng = np.random.default_rng(seed)
    rows, args = [], []
    if width >= 64:
        bufs, ats, cands, ns, _ = planted_matches(6, width, seed=seed)
        rows, args = [*bufs], [*zip(ats, cands, ns)]
    for at in sorted({a for a in (width // 2, width - 9, width - 4, width - 13) if 0 < a < width}):
        row = rng.integers(0, 256, width, dtype=np.uint8)
        row[at:] = row[: width - at]  # the match from 0 runs to the row's end
        rows.append(row)
        args.append((at, 0, width))
    if width >= 64:  # the candidate's span runs off the row's end into zeros
        row = rng.integers(1, 256, width, dtype=np.uint8)
        row[5:21] = row[width - 16 :]
        row[21:29] = 0
        rows.append(row)
        args.append((5, width - 16, width))
    row = rng.integers(0, 256, width, dtype=np.uint8)
    rows += [row, row, row, row, np.zeros(width, np.uint8)]
    args += [(width - 3, width - 4, width), (width // 3, width // 3, width // 3),
             (-7, width + 40, 1 << 30), (width // 2, -5, width - 1), (width // 4, 0, width + 9)]
    a = np.array(args, np.int64)
    return np.stack(rows), a[:, 0], a[:, 1], a[:, 2]


@pytest.mark.parametrize("width", [1001, 1002, 1003, 1018, 1020, 1024, 13, 7])
def test_host_probe_guarded_edges_match_jax(host_lib, width):
    """The probe kernel's row on rows whose width is no
    multiple of 4 or of 16 (the row's first and last words read by bytes, no byte outside the
    row read: the last row ends at the guard page), the spans touching byte
    0 and byte width - 1, at equal to n, arguments clamped in the kernel;
    equal to the JAX kernel in interpret mode on the rows zero-padded and
    the arguments clamped by the plain version's rule."""
    bufs, ats, cands, ns = _edge_rows(width, seed=width)
    ref = _jax_probe(bufs, ats, cands, ns, 4096)
    clip = np.iinfo(np.int32)
    ats, cands, ns = (np.clip(x, clip.min, clip.max) for x in (ats, cands, ns))
    for offset in (AT_GUARD, 0, 1, 2, 3):
        out = _host_probe(host_lib, bufs, ats, cands, ns, offset)
        assert (out == ref).all(), (width, offset, out, ref)


def test_host_probe_walk_steps_match_chip_smoke(host_lib):
    """``chip_smoke.probe_walk_steps``, from which the probe's walk floor is
    computed, counts the stride-8 steps that ``sc::extend_match`` takes (its
    seed hook's calls) on ``chip_smoke.py``'s own probe rows and on rows
    whose walks touch the row's edges, at widths that are no multiple of 4;
    and the walk's lengths there are the expected ones and the kernel row's."""
    import chip_smoke

    cases = [chip_smoke.probe_batch()]
    for width in (1001, 1003, 13):
        bufs, ats, cands, ns = _edge_rows(width, seed=width)
        clip = np.iinfo(np.int32)
        ats, cands, ns = (np.clip(x, clip.min, clip.max).astype(np.int32)
                          for x in (ats, cands, ns))
        cases.append((bufs, ats, cands, ns, _host_probe(host_lib, bufs, ats, cands, ns, 0)))
    for bufs, ats, cands, ns, expected in cases:
        bufs = np.ascontiguousarray(bufs, np.uint8)
        lens, steps = np.zeros(len(bufs), np.int32), np.zeros(len(bufs), np.int32)
        host_lib.host_probe_steps(bufs.ctypes.data, bufs.shape[1], ats.ctypes.data,
                                  cands.ctypes.data, ns.ctypes.data, len(bufs), lens.ctypes.data,
                                  steps.ctypes.data)
        assert (lens == expected).all()
        cc = bufs.shape[1]
        n = np.clip(ns, 0, cc)
        model = chip_smoke.probe_walk_steps(lens, np.minimum(np.maximum(ats, 0), n), n)
        assert (model == steps).all(), (cc, model, steps)


@pytest.mark.parametrize("nlanes", [1, 4, 32])
@pytest.mark.parametrize("variant", ["v2", "v4", "v3", "v1", "v1nock", "v1nocp"])
def test_host_variant_walk_matches_plain(host_lib, variant, nlanes):
    """Each ablation form (the decode kernel's batched walk over
    ``dv::VariantTags``, its knobs as ``dv::with_variant`` maps them) on a
    warp of 1, 4 and 32 lanes against the plain version: valid blocks with
    every short offset, a 64 KiB block, batch-edge blocks; but for the
    unchecked form (defined for valid blocks only) corrupt blocks, blocks
    holding a literal of no bytes (T1-T4 give it their error word) and a
    sample of the tag-byte sweep; garbage past each length; rows ending at a
    guard page read by the byte loader at a width that is no multiple of 4
    and by the ring at one that is; over-stores within their slack."""
    import torch

    from snappier_tpu_torch.ops.cuda import decode_variants as dv

    number = dv.VARIANTS[variant][0]
    walks = walk_streams(big=0 if nlanes == 32 else 65536)
    valid = walks + batch_streams(programs=4)
    more = [] if variant == "v1nock" else (corrupt_streams() + empty_literal_streams()
                                           + tag_sweep_sample(97))
    widths, out_cap = ((68611, 68612), 65536) if nlanes != 32 else ((4095, 4096), 3070)
    for cc, loader in zip(widths, (1, 0)):
        valid, more = ([s for s in x if len(s) <= cc] for x in (valid, more))
        comp, lens = pack_streams(valid + more, cc)
        comp8 = np.ascontiguousarray(comp, np.uint8)
        B = len(comp8)
        out = np.zeros((B, out_cap), np.uint8)
        out_lens = np.zeros(B, np.int32)
        errs = np.zeros(B, np.int32)
        counts = np.zeros(3, np.int64)
        rc = host_lib.host_variant(number, comp8.ctypes.data, cc, lens.ctypes.data, B, out_cap,
                                   nlanes, _offset_arg(AT_GUARD), loader, out.ctypes.data,
                                   out_lens.ctypes.data, errs.ctypes.data, counts.ctypes.data)
        assert rc == 0, rc
        want = [x.numpy() for x in dv.decode_variant_plain(
            torch.from_numpy(comp8), torch.from_numpy(lens), out_cap, variant)]
        assert (errs == want[2]).all(), (loader, errs.tolist(), want[2].tolist())
        assert (out_lens == want[1]).all(), loader
        assert not errs[: len(walks)].any()  # some batch-edge claims pass out_cap 3070: 8
        if more:
            assert {1, 2, 4, 8} <= set(errs.tolist())  # T1-T4's separate words
        if variant != "v1nocp":
            for i in range(B):
                assert (out[i, : out_lens[i]] == want[0][i, : want[1][i]]).all(), (loader, i)
        if nlanes == 32:  # a batch resolves several tags a warp step
            assert counts[1] > 2 * counts[0], counts
        unc = dv._VARIANT_UNC[number]
        over = unc == 2 or (unc == 1 and nlanes > 1)
        assert (counts[2] > 0) == (over and variant != "v1nocp"), counts
    if variant == "v1nock":
        # Corrupt blocks: the room and offset tests keep every store inside
        # the image and its slack (rc -2 past it); a stopped walk gives 4.
        bad = [s for s in corrupt_streams() + empty_literal_streams() if len(s) <= cc]
        comp, lens = pack_streams(bad, cc)
        comp8 = np.ascontiguousarray(comp, np.uint8)
        B = len(bad)
        out = np.zeros((B, out_cap), np.uint8)
        out_lens, errs = np.zeros(B, np.int32), np.zeros(B, np.int32)
        rc = host_lib.host_variant(number, comp8.ctypes.data, cc, lens.ctypes.data, B, out_cap,
                                   nlanes, _offset_arg(AT_GUARD), 0, out.ctypes.data,
                                   out_lens.ctypes.data, errs.ctypes.data, counts.ctypes.data)
        assert rc == 0, rc
        assert set(errs.tolist()) == {0, 4, 8} and not out_lens[errs != 0].any()


PIPE_CASES = [
    ("pipe", dict(fold=0)),
    ("pipe2u1", dict(fold=1, unroll=1)),
    ("pipe2u2", dict(fold=1, unroll=2)),
    ("pipe2u3", dict(fold=1, unroll=3)),
    ("pipe2u4", dict(fold=1, unroll=4)),
    ("pipe2unc", dict(fold=1, unroll=2, unc=1)),
    ("pipe2unc2", dict(fold=1, unroll=2, unc=2)),
    ("denoemit", dict(fold=1, unroll=2, emit=0)),
]


@pytest.mark.parametrize("nlanes", [1, 4, 32])
@pytest.mark.parametrize("case", PIPE_CASES, ids=[c[0] for c in PIPE_CASES])
def test_host_pipe_walk_matches_plain(host_lib, case, nlanes):
    """The pipelined walks (the decode kernel's batched walk over its tag
    source, ``decode_pipe2`` taking a literal of no bytes) on a warp of 1, 4
    and 32 lanes against their plain version: valid blocks with every short
    offset, a 64 KiB block, corrupt blocks, blocks with literals of no bytes
    at every place in a batch, batch-edge blocks, garbage past each length;
    rows ending at a guard page read by the byte loader at a width that is no
    multiple of 4 and by the ring at one that is; capacities that are no
    multiple of 4 or 16; ``unc``'s over-stores within their slack."""
    import torch

    from snappier_tpu_torch.ops.cuda import decode_variants as dv

    kw = dict(dict(unroll=1, unc=0, emit=1), **case[1])
    streams = (walk_streams(big=0 if nlanes == 32 else 65536) + corrupt_streams()
               + empty_literal_streams() + batch_streams(programs=4))
    widths, out_cap = ((68611, 68612), 65536) if nlanes != 32 else ((4095, 4096), 3070)
    for cc, loader in zip(widths, (1, 0)):
        comp, lens = pack_streams(streams, cc)
        comp8 = np.ascontiguousarray(comp, np.uint8)
        B = len(streams)
        out = np.zeros((B, out_cap), np.uint8)
        out_lens = np.zeros(B, np.int32)
        errs = np.zeros(B, np.int32)
        counts = np.zeros(3, np.int64)
        rc = host_lib.host_pipe(kw["fold"], kw["unroll"], kw["unc"], kw["emit"], comp8.ctypes.data,
                                cc, lens.ctypes.data, B, out_cap, nlanes, _offset_arg(AT_GUARD),
                                loader, out.ctypes.data, out_lens.ctypes.data, errs.ctypes.data,
                                counts.ctypes.data)
        assert rc == 0, rc
        want = [x.numpy() for x in dv.decode_pipe_plain(
            torch.from_numpy(comp8), torch.from_numpy(lens), out_cap, bool(kw["fold"]),
            bool(kw["emit"]))]
        assert (errs == want[2]).all(), (loader, errs.tolist(), want[2].tolist())
        assert (out_lens == want[1]).all(), loader
        assert {0, 4, 7, 8} <= set(errs.tolist())
        if kw["emit"]:
            for i in range(B):
                assert (out[i, : out_lens[i]] == want[0][i, : want[1][i]]).all(), (loader, i)
        if nlanes == 32:  # a batch resolves several tags a warp step
            assert counts[1] > 2 * counts[0], counts
        # unc stores past a batch's end, within its slack (rc -2 past it): a
        # round of one lane has no lane past the end.
        over = kw["unc"] == 2 or (kw["unc"] == 1 and nlanes > 1)
        assert (counts[2] > 0) == (over and kw["emit"] == 1), counts


def _host_encode_variant(lib, frags, lens, mask, hash_bits, store_step, fixed=0,
                         offset=AT_GUARD, loader=1):
    frags = np.ascontiguousarray(frags, np.uint8)
    lens = np.ascontiguousarray(lens, np.int32)
    B, F = frags.shape
    bodies = np.zeros((B, F + 2048), np.uint8)
    body_lens = np.zeros(B, np.int32)
    rc = lib.host_encode_variant(mask, hash_bits, store_step, fixed, frags.ctypes.data, F,
                                 lens.ctypes.data, B, _offset_arg(offset), loader,
                                 bodies.ctypes.data, F + 2048, body_lens.ctypes.data)
    assert rc == 0
    return bodies, body_lens


def _encode_variant_cases():
    from snappier_tpu_torch.ops.cuda import encode_variants as ev

    cases = [(name, *ev.flags_mask(flags)) for name, flags in ev.VARIANT_FLAGS.items()]
    cases += [(name, mask, 15, 1) for name, mask in ev.R4_VARIANTS.items()]
    cases += [("plain_walk", *ev.flags_mask(())), ("st1_probe8", *ev.flags_mask(("probe8", "st1"))),
              ("pre_oct", ev.R4_VARIANTS["encoct8"] | ev.LOOP_PRE, 12, 1),
              ("two_trim_probe8", ev.R4_VARIANTS["enctrim"] | ev.LOOP_TWO | ev.PROBE8, 13, 2)]
    return cases


@functools.lru_cache(maxsize=None)
def _encode_variant_plain(case):
    """The rows of the variant walk's tests, at 2 KiB and (one markup and one
    random row) at 64 KiB, each with the plain version's bodies and lengths
    under the case's mask."""
    import torch

    from snappier_tpu_torch.ops.cuda import encode_variants as ev

    _, mask, hash_bits, store_step = case
    out = []
    for F, rows in ((2048, slice(None)), (65536, slice(0, 3, 2))):
        frags, lens = encode_rows(F)
        frags, lens = frags[rows], lens[rows]
        want_b, want_l = (x.numpy() for x in ev.encode_walk_plain(
            torch.from_numpy(frags.astype(np.uint8)), torch.from_numpy(lens), mask, hash_bits,
            store_step))
        out.append((frags, lens, want_b, want_l))
    return out


def _hold_variant_to_plain(host_lib, case, placements):
    from snappier_tpu_torch.ops.cuda import encode_variants as ev

    name, mask, hash_bits, store_step = case
    no_bytes = mask & (ev.EMIT_COUNT | ev.EMIT_HITS | ev.DMA_ONLY | ev.NOSCAN)
    for frags, lens, want_b, want_l in _encode_variant_plain(case):
        for offset, loader in placements(frags.shape[1]):
            for fixed in (0, 1):
                what = (name, offset, loader, fixed)
                got_b, got_l = _host_encode_variant(host_lib, frags, lens, mask, hash_bits,
                                                    store_step, fixed, offset, loader)
                assert (got_l == want_l).all(), (what, got_l, want_l)
                if not no_bytes:
                    _same_bodies(got_b, got_l, want_b, want_l, what)
        if not no_bytes:
            for i in range(len(lens)):
                comp = write_varint(int(lens[i])) + got_b[i, : got_l[i]].tobytes()
                assert oracle.decompress(comp) == frags[i, : lens[i]].astype(np.uint8).tobytes()


@pytest.mark.parametrize("case", _encode_variant_cases(), ids=lambda c: c[0])
def test_host_encode_variant_walk_matches_plain(host_lib, case):
    """The encode-ablation walk of ``csrc/encode_variants.cuh`` under every
    named mask, and under masks no name has, through each of the kernels'
    loaders, the rows in a buffer that ends at the last row's end, against
    its plain version, at 2 KiB and (one markup and one random row) at
    64 KiB. The parts that only reorder the work (the preloaded group, the
    detection-only probe, the two nested loops) have no plain counterpart:
    they give the bytes of the walk they restructure, which is what this
    holds them to."""
    _hold_variant_to_plain(host_lib, case, _loader_cases)


@pytest.mark.parametrize("case", _encode_variant_cases(), ids=lambda c: c[0])
def test_host_encode_variant_walk_on_unaligned_rows(host_lib, case):
    """The encode-ablation walk under every mask of the test above with the
    rows 0-7 bytes past a 16-byte boundary (the byte loader) and 0, 4, 8 and
    12 past one (the word loader), under the guard page, against its plain
    version."""
    _hold_variant_to_plain(host_lib, case, _aligned_cases)


def _host_hybrid(lib, form, comp, lens, spec0, spec1, out_cap, nlanes, unroll2=False,
                 offset=AT_GUARD, loader=None):
    """The batched walk of ``form`` (``"v5"``, ``"v6"``, ``"v7"``) on a warp
    of ``nlanes`` lanes, the rows at ``offset`` in a guarded buffer read
    through loader 0 (words; the default where the width is a multiple of 4)
    or 1 (bytes), the descriptors (``spec1`` only for ``"v7"``) at a guard
    page: ``(out, out_lens, errs, (batches, tags))``."""
    comp = np.ascontiguousarray(comp, np.uint8)
    lens = np.ascontiguousarray(lens, np.int32)
    s0 = np.ascontiguousarray(spec0, np.int32)
    s1 = s0 if spec1 is None else np.ascontiguousarray(spec1, np.int32)
    B, cc = comp.shape
    if loader is None:
        loader = 0 if cc % 4 == 0 else 1
    out = np.zeros((B, out_cap), np.uint8)
    out_lens = np.zeros(B, np.int32)
    errs = np.zeros(B, np.int32)
    counts = np.zeros(2, np.int64)
    rc = lib.host_hybrid(int(form[1]), comp.ctypes.data, cc, s0.ctypes.data, s1.ctypes.data,
                         s0.shape[1], lens.ctypes.data, B, out_cap, nlanes, int(unroll2),
                         _offset_arg(offset), loader, out.ctypes.data, out_lens.ctypes.data,
                         errs.ctypes.data, counts.ctypes.data)
    assert rc == 0
    return out, out_lens, errs, tuple(counts.tolist())


def _same_triples(got, want, what):
    assert (got[2] == want[2]).all(), (what, got[2].tolist(), want[2].tolist())
    assert (got[1] == want[1]).all(), what
    for i in range(len(want[1])):
        assert (got[0][i, : got[1][i]] == want[0][i, : want[1][i]]).all(), (what, i)


@pytest.mark.parametrize("nlanes", [1, 4, 32])
@pytest.mark.parametrize("form", ["v5", "v6", "v7", "v7u"])
def test_host_hybrid_walk_matches_plain(host_lib, form, nlanes):
    """The descriptor-driven kernels' batched walk on a warp of 1, 4 and 32
    lanes over the port's pre-pass, against their plain version (a tag at a
    time): valid blocks with every short offset, 64 KiB blocks, corrupt
    blocks, a sample of the tag sweep, garbage past each length; rows and
    capacities that are no multiple of 4 (the byte loader), rows and
    descriptors ending at a guard page; v7u parses two batches a loop
    iteration."""
    base = form[:2]
    comp8, lens, out_cap, spec0, spec1, want = _hybrid_walk_refs(base, nlanes == 32)
    got = _host_hybrid(host_lib, base, comp8, lens, spec0, spec1, out_cap, nlanes,
                       unroll2=form == "v7u")[:3]
    _same_triples(got, want, form)
    assert ({0, 4, 8} if base == "v7" else {0, 2, 3, 4, 8}) <= set(got[2].tolist())


@functools.lru_cache(maxsize=None)
def _hybrid_walk_refs(base: str, narrow: bool):
    """The rows of test_host_hybrid_walk_matches_plain (the 32-lane cases'
    narrow, the others' with 64 KiB blocks), the port's pre-pass of form
    ``base`` and the plain walk's triple: ``(comp, lens, out_cap, spec0,
    spec1 or None, want)``. v7 and v7u, and 1 and 4 lanes, share them."""
    import torch

    from snappier_tpu_torch.ops.cuda import decode_hybrid as dh

    streams = (walk_streams(big=0 if narrow else 65536) + corrupt_streams()
               + tag_sweep_sample(97))
    cc, out_cap = (2051, 1022) if narrow else (68611, 65536)
    comp, lens = pack_streams(streams, cc)
    comp8 = np.ascontiguousarray(comp, np.uint8)
    c8 = torch.from_numpy(comp8)
    spec0, spec1 = dh._prepass(c8, base)
    want = [x.numpy() for x in dh.decode_hybrid_plain(c8, torch.from_numpy(lens), out_cap, base)]
    return (comp8, lens, out_cap, spec0.numpy(), None if spec1 is None else spec1.numpy(),
            want)


_V7_CC, _V7_OUT_CAP = 4096, 3072  # OUT_CAP + 1024 a multiple of 4096: the TPU walk agrees


def _negative_literal_streams():
    """A 4-byte literal length of 0xFFFFFFFE (a literal of -1 bytes that
    advances 4, its next tag a copy-4 tag at its top length byte), after
    output and at the start; one of -4 bytes; runs of literals whose length
    wraps to 0, whole batches of tags with no output; and
    ``torch_cases.step_back_streams``, where the step comes after several
    tags of one batch or makes a batch of its own."""
    lit16 = bytes([15 << 2]) + b"abcdefghijklmnop"
    neg = bytes([0xFC, 0xFE, 0xFF, 0xFF, 0xFF, 8, 0, 0, 0])  # then 64 bytes at offset 8
    empty = bytes([0xFC, 0xFB, 0xFF, 0xFF, 0xFF])  # -4 bytes: advances 1, to the next 0xFB ...
    wrap = bytes([0xFC, 0xFF, 0xFF, 0xFF, 0xFF])  # a literal of 0 bytes that advances 5
    runs = [write_varint(16) + lit16 + wrap * k for k in (1, 7, 40)]
    return [write_varint(79) + lit16 + neg, bytes([64]) + neg, write_varint(16) + lit16 + empty,
            *runs, *step_back_streams()]


#: The one stream of _hybrid_refs where decode_v5 diverges from the TPU by
#: design: its step back would take the output below 0 (4 here, 3 there).
_BELOW_ZERO = bytes([64, 0xFC, 0xFE, 0xFF, 0xFF, 0xFF, 8, 0, 0, 0])


@functools.lru_cache(maxsize=None)
def _hybrid_streams():
    """The edge, corrupt, tag-sweep, negative-literal, step-back and
    batch-edge streams."""
    return (walk_streams() + corrupt_streams() + tag_sweep_sample(61)
            + _negative_literal_streams() + batch_streams())


@functools.lru_cache(maxsize=None)
def _hybrid_refs(form: str):
    """The descriptor-driven forms' cases: the edge, corrupt, tag-sweep,
    negative-literal, step-back and batch-edge streams at width 4,096, the
    port's pre-pass of ``form`` (``"v5"``, ``"v6"``, ``"v7"``), the TPU's
    triple in interpret mode (``tools/perf_probe_hybrid.py``), the plain
    version's triple, and the rows where the two are held equal (all but
    :data:`_BELOW_ZERO` for ``"v5"``, where the plain version's 4 and the
    TPU's 3 are checked)."""
    import torch

    from snappier_tpu_torch.ops.cuda import decode_hybrid as dh
    from tests.torch_cases import interpreted_tool

    streams = _hybrid_streams()
    comp, lens = pack_streams(streams, _V7_CC)
    with interpreted_tool("perf_probe_hybrid") as tool:
        c, n = jnp.asarray(comp), jnp.asarray(lens)
        res = (tool.decode_v7(c, n, _V7_OUT_CAP, False) if form == "v7"
               else getattr(tool, f"decode_{form}")(c, n, _V7_OUT_CAP))
        ref = [np.asarray(x) for x in res]
    comp8 = comp.astype(np.uint8)
    c8 = torch.from_numpy(comp8)
    spec0, spec1 = (None if x is None else x.numpy() for x in dh._prepass(c8, form))
    plain = [x.numpy() for x in dh.decode_hybrid_plain(c8, torch.from_numpy(lens), _V7_OUT_CAP,
                                                       form)]
    keep = np.array([not (form == "v5" and s == _BELOW_ZERO) for s in streams])
    if form == "v5":
        assert plain[2][~keep].tolist() == [4] and ref[2][~keep].tolist() == [3]
    return comp8, lens, spec0, spec1, ref, plain, keep


@pytest.fixture(scope="module")
def v7_refs():
    """decode_v7's cases (:func:`_hybrid_refs`): rows, lengths, the port's
    pre-pass and the TPU's decode_v7 triple."""
    comp8, lens, spec0, spec1, ref, _, _ = _hybrid_refs("v7")
    return comp8, lens, spec0, spec1, ref


@pytest.mark.parametrize("unroll2", [False, True], ids=["v7", "v7u"])
@pytest.mark.parametrize("nlanes", [1, 4, 32])
def test_host_v7_walk_matches_jax(host_lib, v7_refs, nlanes, unroll2):
    """decode_v7's batched walk on a warp of 1, 4 and 32 lanes, through both
    row loaders, the rows and descriptors ending at a guard page, equal to
    the TPU's decode_v7 in interpret mode and to the plain version on the
    edge, corrupt, tag-sweep, negative-literal and batch-edge streams: the
    error words (4 for any bad tag, 8 for the preamble), lengths and bytes.
    On 4 and 32 lanes the batches hold more tags than steps."""
    import torch

    from snappier_tpu_torch.ops.cuda import decode_hybrid as dh

    comp8, lens, spec0, spec1, ref = v7_refs
    plain = [x.numpy() for x in dh.decode_hybrid_plain(torch.from_numpy(comp8),
                                                       torch.from_numpy(lens), _V7_OUT_CAP, "v7")]
    _same_triples(plain, ref, "plain")
    assert set(ref[2].tolist()) == {0, 4, 8}
    for offset, loader in _loader_cases(_V7_CC):
        out, out_lens, errs, (batches, tags) = _host_hybrid(
            host_lib, "v7", comp8, lens, spec0, spec1, _V7_OUT_CAP, nlanes, unroll2, offset,
            loader)
        _same_triples((out, out_lens, errs), ref, f"loader {loader}")
        assert tags <= nlanes * batches and (nlanes == 1 or tags > batches)


@pytest.mark.parametrize("nlanes", [1, 4, 32])
def test_host_v7_walk_on_unaligned_rows(host_lib, v7_refs, nlanes):
    """decode_v7's batched walk with the rows 0-7 bytes past a 16-byte
    boundary (the byte loader) and 0, 4, 8 and 12 past one (the word loader),
    under the guard page; and on rows 3 bytes narrower (the byte loader,
    descriptors of that width), against the plain version there."""
    import torch

    from snappier_tpu_torch.ops.cuda import decode_hybrid as dh

    comp8, lens, spec0, spec1, ref = v7_refs
    for offset, loader in _aligned_cases(_V7_CC):
        got = _host_hybrid(host_lib, "v7", comp8, lens, spec0, spec1, _V7_OUT_CAP, nlanes, False,
                           offset, loader)[:3]
        _same_triples(got, ref, f"loader {loader} at offset {offset}")
    narrow = np.ascontiguousarray(comp8[:, : _V7_CC - 3])
    s0, s1 = (x.numpy() for x in dh.prepass_v7(torch.from_numpy(narrow)))
    want = [x.numpy() for x in dh.decode_hybrid_plain(
        torch.from_numpy(narrow), torch.from_numpy(lens), _V7_OUT_CAP, "v7")]
    for offset in (AT_GUARD, 5):
        got = _host_hybrid(host_lib, "v7", narrow, lens, s0, s1, _V7_OUT_CAP, nlanes, False,
                           offset, 1)[:3]
        _same_triples(got, want, f"width {_V7_CC - 3} at offset {offset}")


def _kept(triple, keep):
    return [x[keep] for x in triple]


@pytest.mark.parametrize("nlanes", [1, 4, 32])
@pytest.mark.parametrize("form", ["v5", "v6"])
def test_host_v5_v6_walk_matches_jax(host_lib, form, nlanes):
    """decode_v5's and decode_v6's batched walk (K1's loop, one descriptor
    a lane) on a warp of 1, 4 and 32 lanes, through both row loaders, the
    rows and descriptors ending at a guard page, equal to the plain version
    and to the TPU's decode_v5 / decode_v6 in interpret mode on the edge,
    corrupt, tag-sweep, negative-literal, step-back and batch-edge streams:
    every error word of {0, 2, 3, 4, 8}, lengths and bytes. v5 steps back
    inside a batch (and in a batch of its own); the one row where it
    diverges from the TPU by design is held to the plain version. On 4 and
    32 lanes the batches hold more tags than steps."""
    comp8, lens, spec0, spec1, ref, plain, keep = _hybrid_refs(form)
    _same_triples(_kept(plain, keep), _kept(ref, keep), "plain")
    assert set(plain[2].tolist()) == {0, 2, 3, 4, 8}
    back = np.isin(np.arange(len(lens)), [_hybrid_streams().index(s) for s in step_back_streams()])
    assert plain[2][back].tolist() == ([0, 0, 0] if form == "v5" else [4, 4, 4])
    for offset, loader in _loader_cases(_V7_CC):
        out, out_lens, errs, (batches, tags) = _host_hybrid(
            host_lib, form, comp8, lens, spec0, None, _V7_OUT_CAP, nlanes, False, offset, loader)
        _same_triples((out, out_lens, errs), plain, f"loader {loader}")
        _same_triples(_kept((out, out_lens, errs), keep), _kept(ref, keep), f"loader {loader}")
        assert tags <= nlanes * batches and (nlanes == 1 or tags > batches)


@pytest.mark.parametrize("nlanes", [1, 4, 32])
@pytest.mark.parametrize("form", ["v5", "v6"])
def test_host_v5_v6_walk_on_unaligned_rows(host_lib, form, nlanes):
    """decode_v5's and decode_v6's batched walk with the rows 0-7 bytes past
    a 16-byte boundary (the byte loader) and 0, 4, 8 and 12 past one (the
    word loader), under the guard page; and on rows 3 bytes narrower (the
    byte loader, descriptors of that width), against the plain version."""
    import torch

    from snappier_tpu_torch.ops.cuda import decode_hybrid as dh

    comp8, lens, spec0, _, _, plain, _ = _hybrid_refs(form)
    for offset, loader in _aligned_cases(_V7_CC):
        got = _host_hybrid(host_lib, form, comp8, lens, spec0, None, _V7_OUT_CAP, nlanes, False,
                           offset, loader)[:3]
        _same_triples(got, plain, f"loader {loader} at offset {offset}")
    narrow = np.ascontiguousarray(comp8[:, : _V7_CC - 3])
    s0 = dh._prepass(torch.from_numpy(narrow), form)[0].numpy()
    want = [x.numpy() for x in dh.decode_hybrid_plain(
        torch.from_numpy(narrow), torch.from_numpy(lens), _V7_OUT_CAP, form)]
    for offset in (AT_GUARD, 5):
        got = _host_hybrid(host_lib, form, narrow, lens, s0, None, _V7_OUT_CAP, nlanes, False,
                           offset, 1)[:3]
        _same_triples(got, want, f"width {_V7_CC - 3} at offset {offset}")


def _hold_prepass_to_plain(host_lib, form):
    """The pre-pass kernel's per-word work (hy::describe_word over words g
    and g + 1 of each row) for ``form`` through both loaders, the rows at a
    guard page and 0-7 bytes past a 16-byte boundary (the byte loader) and
    0, 4, 8 and 12 past one (the word loader), bit-equal to the plain
    pre-passes (held to the TPU's by tests/test_torch_hybrid_decode.py) on
    rows of uneven widths: random bytes, literal lengths and copy offsets at
    every wrap and poison edge, packed streams with garbage tails."""
    import torch

    from snappier_tpu_torch.ops.cuda import decode_hybrid as dh
    from tests.test_torch_hybrid_decode import _prepass_rows

    rows = _prepass_rows().astype(np.uint8)
    for cc in (4096, 1001, 1002, 1003, 5):
        part = np.ascontiguousarray(rows[:, :cc])
        t = torch.from_numpy(part)
        words = dh.pack_words(t)
        if form == "v7":
            want = [x.numpy() for x in dh.spec2_from_words(words, cc)]
        else:
            want = [dh.spec_from_comp(t).numpy()]
            assert (dh.spec_from_words(words, cc).numpy() == want[0]).all()
        cases = [(AT_GUARD, 1)] + [(o, 1) for o in range(8)]
        cases += [(AT_GUARD, 0)] + [(o, 0) for o in (0, 4, 8, 12)] if cc % 4 == 0 else []
        for offset, loader in cases:
            got = [np.zeros_like(want[0]) for _ in range(2)]
            assert host_lib.host_prepass(int(form[1]), part.ctypes.data, cc, len(part),
                                         _offset_arg(offset), loader, got[0].ctypes.data,
                                         got[1].ctypes.data) == 0
            for g, w in zip(got, want):
                assert (g == w).all(), (form, cc, offset, loader)


def test_host_prepass_v7_matches_plain(host_lib):
    """Form 7's pre-pass (hy::spec2_at), against spec2_from_words of
    pack_words: :func:`_hold_prepass_to_plain`."""
    _hold_prepass_to_plain(host_lib, "v7")


@pytest.mark.parametrize("form", ["v5", "v6"])
def test_host_prepass_matches_plain(host_lib, form):
    """Forms 5 and 6's pre-pass (hy::spec_at), against spec_from_comp and
    spec_from_words of pack_words: :func:`_hold_prepass_to_plain`."""
    _hold_prepass_to_plain(host_lib, form)


def _hold_stats_to_plain(host_lib, widths, placements):
    """``encode_stats.cu``'s row sink (``ev::StatsOut`` over the stats walk of
    ``csrc/encode_variants.cuh``) through the loaders and placements that
    ``placements(width)`` names, on ``encode_rows`` (garbage past each
    length) at each width in ``widths``, against :func:`encode_stats_plain`;
    at 64 KiB only a markup and a random row."""
    import torch

    from snappier_tpu_torch.ops.cuda import encode_variants as ev

    for F in widths:
        frags, lens = encode_rows(max(F, 2048))
        rows = slice(None) if F < 65536 else slice(0, 3, 2)
        frags = np.ascontiguousarray(frags[rows, :F], np.uint8)
        lens = np.ascontiguousarray(np.minimum(lens[rows], F), np.int32)
        want = ev.encode_stats_plain(torch.from_numpy(frags), torch.from_numpy(lens)).numpy()
        assert want[:, 1].any() and want[:, 2].any()
        for offset, loader in placements(F):
            got = np.zeros((len(lens), 4), np.int32)
            assert host_lib.host_encode_stats(frags.ctypes.data, F, lens.ctypes.data, len(lens),
                                              _offset_arg(offset), loader, got.ctypes.data) == 0
            assert (got == want).all(), (F, offset, loader, got.tolist(), want.tolist())


def test_host_encode_stats_walk_matches_plain(host_lib):
    """``encode_stats.cu``'s row (:func:`_hold_stats_to_plain`) through each
    loader, the rows in a buffer that ends at the last row's end, at 2 KiB
    and 64 KiB."""
    _hold_stats_to_plain(host_lib, (2048, 65536), _loader_cases)


def test_host_encode_stats_walk_on_unaligned_rows(host_lib):
    """``encode_stats.cu``'s row with the rows 0-7 bytes past a 16-byte
    boundary (the byte loader) and 0, 4, 8 and 12 past one (the word loader),
    under the guard page, at 2 KiB and 64 KiB, and on rows of an odd width
    (2,047 B: the byte loader alone)."""
    _hold_stats_to_plain(host_lib, (2048, 65536, 2047), _aligned_cases)


def _host_crc(lib, rows, lens, offset=0, guard=False, nblocks=3):
    """The CRC32C kernel's row walk on the host (``host_crc32c``)."""
    from snappier_tpu_torch.ops.cuda.crc32c import kernel_tables

    rows = np.ascontiguousarray(rows, np.uint8)
    lens = np.ascontiguousarray(lens, np.int32)
    out = np.zeros(len(lens), np.int32)
    rc = lib.host_crc32c(rows.ctypes.data, rows.shape[1], lens.ctypes.data, len(lens), offset,
                         int(guard), nblocks, kernel_tables().ctypes.data, out.ctypes.data)
    assert rc == 0
    return out.view(np.uint32)


@pytest.fixture(scope="module")
def crc_jax():
    """``crc_rows(65536)`` and their CRCs from the JAX kernel in interpret
    mode."""
    rows, lens = crc_rows(65536)
    want = np.asarray(crc32c_blocks(jnp.asarray(rows.astype(np.int32)), jnp.asarray(lens),
                                    interpret=True)).view(np.uint32)
    return rows, lens, want


@pytest.mark.parametrize("offset", [0, 1, 15])
def test_host_crc_walk_matches_jax(host_lib, crc_jax, offset):
    """The kernel's split of 64 KiB rows (chunks of 16 bytes, 32 lanes, 8
    warps with a barrier, the lane fold, the eight tree levels, the head and
    tail walks) on 3 blocks, each taking every third row: rows starting 0, 1 or 15
    bytes past a 16-byte boundary, lengths at every edge of the split
    (``torch_cases.CRC_LENGTHS``) with garbage past them, equal to the JAX
    kernel in interpret mode and to the host CRC32C."""
    from snappier_tpu_torch.format.crc32c import crc32c

    rows, lens, want = crc_jax
    got = _host_crc(host_lib, rows, lens, offset)
    assert (got == want).all(), np.nonzero(got != want)
    assert [int(x) for x in got] == [crc32c(r[:n]) for r, n in zip(rows, lens)]


def test_host_crc_reads_nothing_past_the_length(host_lib):
    """Each length alone as a row that ends at a page the process may not
    read (so a read past its length faults), at every start 0-15 bytes past
    a 16-byte boundary (the start follows from the length), a batch of rows
    of odd width on 1, 2 and 5 blocks and one of 150 rows on 1 and 2 blocks,
    against the host CRC32C."""
    from snappier_tpu_torch.format.crc32c import crc32c

    rng = np.random.default_rng(17)
    lengths = sorted({*CRC_LENGTHS, *range(48), *(4096 + k for k in range(16)),
                      *(65536 - k for k in range(16))} - {0})
    for n in lengths:
        row = rng.integers(0, 256, (1, n), dtype=np.uint8)
        got = _host_crc(host_lib, row, [n], guard=True, nblocks=1)
        assert int(got[0]) == crc32c(row[0]), n
    rows, lens = crc_rows(4097, seed=19)
    for nblocks in (1, 2, 5):
        got = _host_crc(host_lib, rows, lens, offset=3, guard=True, nblocks=nblocks)
        assert [int(x) for x in got] == [crc32c(r[:n]) for r, n in zip(rows, lens)], nblocks
    # More rows a block than the kernel keeps sums for at once (64): 150
    # rows of up to 1,000 bytes, some with no whole chunk, on 1 and 2 blocks.
    rows = rng.integers(0, 256, (150, 1000), dtype=np.uint8)
    lens = rng.integers(0, 1001, 150).astype(np.int32)
    lens[::7] = rng.integers(0, 31, len(lens[::7]))
    for nblocks in (1, 2):
        got = _host_crc(host_lib, rows, lens, guard=True, nblocks=nblocks)
        assert [int(x) for x in got] == [crc32c(r[:n]) for r, n in zip(rows, lens)], nblocks


@pytest.mark.parametrize("table", ["step", "fold", "lanes", "warps"])
def test_crc_kernel_tables_match_combine(host_lib, table):
    """Each shift of ``kernel_tables`` against ``crc32c_combine``: the 4-byte
    step and the fold as 4 x 256 tables (also as every lane reads them
    spread over the banks), the lanes' and the warps' 32 x 32 matrices (each
    a column a state bit)."""
    from snappier_tpu_torch.format.crc32c import crc32c_combine
    from snappier_tpu_torch.ops.cuda.crc32c import (
        CHUNK, FOLD, LANES, WARPS, kernel_tables, shift_table)

    rng = np.random.default_rng(len(table))
    tabs = kernel_tables()
    pairs = rng.integers(0, 2**32, (24, 2), dtype=np.uint64).tolist()
    if table in ("step", "fold"):
        nbytes, at = (4, 256) if table == "step" else (FOLD, 256 + 1024)
        t = shift_table(nbytes)
        assert (tabs[at : at + 1024] == t.reshape(-1)).all()
        for a, b in pairs:
            shifted = int(t[0, a & 255] ^ t[1, (a >> 8) & 255] ^ t[2, (a >> 16) & 255]
                          ^ t[3, a >> 24])
            assert shifted ^ b == crc32c_combine(a, b, nbytes)
            for lane in range(LANES):
                assert host_lib.host_crc_spread(tabs.ctypes.data, table == "fold", lane,
                                                a) == shifted, lane
        return
    mats = (tabs[256 + 2048 : 256 + 3072].reshape(32, LANES).T if table == "lanes"
            else tabs[256 + 3072 :].reshape(WARPS, 32))
    for k, cols in enumerate(mats):  # lane k, or warp k: column i for state bit i
        nbytes = (LANES - 1 - k) * CHUNK if table == "lanes" else (WARPS - 1 - k) * LANES * CHUNK
        for a, b in pairs[:4]:
            shifted = 0
            for i in range(32):
                shifted ^= int(cols[i]) if (a >> i) & 1 else 0
            assert shifted ^ b == crc32c_combine(a, b, nbytes), (table, k)
