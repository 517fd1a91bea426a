// Batched level="best" Snappy encode on Hopper.
//
// Replaces: snappier_tpu/ops/pallas/scalar_codec.py::_encode_kernel with
// exact_cands=True (wrapper _encode_best_pallas, reached from
// encode_blocks_best), the TPU scalar-core walk driven by one precomputed
// candidate per position instead of a hash table.
//
// What bounds it: as in fast mode, the walk is serial per fragment (each
// step depends on the match end of the one before), so a fragment's time is
// its step count times the latency of its dependent loads. The bytes it
// must move (32 MiB of fragments, 128 MiB of int32 candidates, about 8 MiB
// of bodies for 512 fragments) take about 0.05 ms at 3.35 TB/s, far below
// the walk. The card's time is then the waves of fragments times one walk.
//
// What the design does about it: the walk needs no table, so nothing has to
// live in shared memory. One block of one thread per fragment, no dynamic
// shared memory (sc::encode_fragment_best in scalar_codec.cuh): the thread
// reads its candidate at ip as an int32 through the read-only path (a value
// outside [0, ip) is none) and the fragment through a loader, aligned words
// where the rows allow it (sc::RowWords: base and width multiples of 4), a
// byte at a time otherwise (sc::RowBytes); bytes at or past the length read
// as zero and nothing past the row is read. The candidates and the fragment
// stream forward, so the walk asks L1 for their lines 128 positions ahead.
// An SM holds up to 32 such blocks, so 512 fragments run in one wave where
// a layout that staged the candidates (narrowed to 16 bits) beside the
// fragment, 192 KiB, one block an SM, took four. Staging only the fragment
// (64 KiB, three blocks an SM, two waves) was slower (PERF.md; NVIDIA
// H100 80GB HBM3, 700.00 W).
#include <cuda_runtime.h>
#include <stdint.h>

#include "scalar_codec.cuh"
#include "smem_config.cuh"

namespace {

constexpr int kThreads = 1;  // one thread walks each fragment

template <bool kWords>
__global__ void __launch_bounds__(kThreads)
    encode_best_kernel(const uint8_t* __restrict__ frags, int64_t frag_w,
                       const int32_t* __restrict__ lengths, const int32_t* __restrict__ cands,
                       int32_t skip_base, uint8_t* __restrict__ bodies, int64_t body_w,
                       int32_t* __restrict__ body_lens) {
  const int64_t b = blockIdx.x;
  int32_t n = lengths[b];
  n = n < 0 ? 0 : (n > frag_w ? (int32_t)frag_w : n);
  const uint8_t* row = frags + b * frag_w;
  const int32_t* crow = cands + b * frag_w;
  uint8_t* out = bodies + b * body_w;
  if constexpr (kWords) {
    body_lens[b] = sc::encode_fragment_best(
        sc::RowWords{reinterpret_cast<const uint32_t*>(row), n}, n, crow, skip_base, out);
  } else {
    body_lens[b] = sc::encode_fragment_best(sc::RowBytes{row, n}, n, crow, skip_base, out);
  }
}

// The word loader takes rows whose base and width are multiples of 4.
bool word_rows(const void* frags, int64_t frag_w) {
  return ((uintptr_t)frags % 4) == 0 && frag_w % 4 == 0;
}

// encode_best_kernel<kWords>'s attributes, set per device (smem_config.cuh).
template <bool kWords>
attrs::SetFor& set_for() {
  static attrs::SetFor s;
  return s;
}

// Runs fn with encode_best_kernel<kWords>'s carveout set on the current
// device (no dynamic shared memory: the rest of the SM is L1), under the
// lock that orders it with every other launch of the kernel.
template <bool kWords, class Fn>
cudaError_t configured(Fn fn) {
  return attrs::configure_and_launch(encode_best_kernel<kWords>, 0, set_for<kWords>(), fn);
}

template <bool kWords>
int launch(const void* frags, int64_t frag_w, const void* lengths, int64_t batch,
           const void* cands, int32_t skip_base, void* bodies, int64_t body_w, void* body_lens,
           void* stream) {
  return (int)configured<kWords>([&] {
    encode_best_kernel<kWords><<<(unsigned)batch, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)frags, frag_w, (const int32_t*)lengths, (const int32_t*)cands,
        skip_base, (uint8_t*)bodies, body_w, (int32_t*)body_lens);
    return cudaGetLastError();
  });
}

template <bool kWords>
int layout(int32_t* out) {
  int nb = 0;
  cudaError_t e = configured<kWords>([&] {
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, encode_best_kernel<kWords>,
                                                         kThreads, 0);
  });
  out[0] = nb;
  out[1] = 0;
  out[2] = kThreads;
  out[3] = kWords ? 1 : 0;
  return (int)e;
}

}  // namespace

// frags: uint8[B, frag_w], any address and width; lengths, body_lens:
// int32[B]; cands: int32[B, frag_w]; bodies: uint8[B, body_w] with body_w >=
// frag_w + frag_w / 65 + 11 (the greedy emission bound and the 3 bytes a
// literal may store past it).
extern "C" int snappy_encode_best_launch(const void* frags, int64_t frag_w,
                                         const void* lengths, int64_t batch,
                                         const void* cands, int32_t skip_base, void* bodies,
                                         int64_t body_w, void* body_lens, void* stream) {
  if (batch == 0) return 0;
  return word_rows(frags, frag_w)
             ? launch<true>(frags, frag_w, lengths, batch, cands, skip_base, bodies, body_w,
                            body_lens, stream)
             : launch<false>(frags, frag_w, lengths, batch, cands, skip_base, bodies, body_w,
                             body_lens, stream);
}

// The layout for rows at frags of width frag_w: out[0] blocks per SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor under the attributes the
// launch sets), out[1] dynamic shared bytes per block, out[2] threads per
// block, out[3] 1 for the word loader and 0 for the byte loader.
extern "C" int snappy_encode_best_layout(const void* frags, int64_t frag_w, int32_t* out) {
  return word_rows(frags, frag_w) ? layout<true>(out) : layout<false>(out);
}
