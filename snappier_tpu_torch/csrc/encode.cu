// Batched greedy Snappy encode on Hopper.
//
// Replaces: snappier_tpu/ops/pallas/scalar_codec.py::_encode_kernel in fast
// mode (wrapper encode_blocks_scalar), the TPU scalar-core LZ77 walk.
//
// What bounds it: the greedy walk is serial per fragment (each probe group
// depends on the table writes and the match end of the one before), so a
// fragment's time is its probe groups times the latency of their dependent
// loads; 32 MiB in and about 7 MiB out at 3.35 TB/s is about 12 us for the
// whole batch, far below the walk. The card's time is then the waves of
// fragments times one walk, and the walks an SM holds at once are what the
// layout decides.
//
// What the design does about it: one block of one warp per fragment; only
// the match table (16-bit slots, 64 KiB at 15 hash bits) lives in dynamic
// shared memory, so three blocks fit an SM at 15 bits (396 walks at once
// on 132 SMs: 512 fragments in 2 waves) where a staged fragment beside the
// table left one. A walk over device memory through L1 is slower than one
// over a staged fragment, but by less than the waves it saves. The walk
// reads the fragment through the read-only path, as aligned 32-bit words
// where the rows allow it (sc::RowWords: base and width multiples of 16),
// a byte at a time otherwise (sc::RowBytes); bytes at or past the length
// read as zero and nothing past the row is read. The warp clears the
// table; lane 0 walks (sc::encode_fragment in scalar_codec.cuh, its probe
// group unrolled in registers) and stores the tags straight into the
// body's row. One warp a block puts the three walkers of an SM on
// different schedulers.
#include <cuda_runtime.h>
#include <stdint.h>

#include "scalar_codec.cuh"
#include "smem_config.cuh"

namespace {

constexpr int kThreads = 32;  // one warp: it clears the table, then lane 0 walks

template <bool kWords>
__global__ void __launch_bounds__(kThreads)
    encode_kernel(const uint8_t* __restrict__ frags, int64_t frag_w,
                  const int32_t* __restrict__ lengths, int hash_bits, int32_t skip_base,
                  uint8_t* __restrict__ bodies, int64_t body_w,
                  int32_t* __restrict__ body_lens) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint16_t* table = reinterpret_cast<uint16_t*>(smem);
  const int64_t b = blockIdx.x;
  uint4* t4 = reinterpret_cast<uint4*>(table);
  const int words = (int)((sizeof(uint16_t) << hash_bits) / sizeof(uint4));
  const uint4 empty = make_uint4(0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu);
  for (int w = threadIdx.x; w < words; w += blockDim.x) t4[w] = empty;
  __syncthreads();
  if (threadIdx.x != 0) return;
  int32_t n = lengths[b];
  n = n < 0 ? 0 : (n > frag_w ? (int32_t)frag_w : n);
  const uint8_t* row = frags + b * frag_w;
  uint8_t* out = bodies + b * body_w;
  if (kWords) {
    body_lens[b] = sc::encode_fragment(sc::RowWords{reinterpret_cast<const uint32_t*>(row), n},
                                       n, table, hash_bits, skip_base, out);
  } else {
    body_lens[b] = sc::encode_fragment(sc::RowBytes{row, n}, n, table, hash_bits, skip_base, out);
  }
}

// encode_kernel<kWords>'s attributes, set per device (smem_config.cuh).
template <bool kWords>
attrs::SetFor& set_for() {
  static attrs::SetFor s;
  return s;
}

// Runs fn with encode_kernel<kWords>'s shared-memory attributes set on the
// current device for a table of smem bytes, under the lock that orders them
// with every other launch of the kernel.
template <bool kWords, class Fn>
cudaError_t configured(size_t smem, Fn fn) {
  return attrs::configure_and_launch(encode_kernel<kWords>, smem, set_for<kWords>(), fn);
}

template <bool kWords>
int launch(const void* frags, int64_t frag_w, const void* lengths, int64_t batch,
           int32_t hash_bits, int32_t skip_base, void* bodies, int64_t body_w, void* body_lens,
           void* stream) {
  const size_t smem = sizeof(uint16_t) << hash_bits;
  return (int)configured<kWords>(smem, [&] {
    encode_kernel<kWords><<<(unsigned)batch, kThreads, smem, (cudaStream_t)stream>>>(
        (const uint8_t*)frags, frag_w, (const int32_t*)lengths, hash_bits, skip_base,
        (uint8_t*)bodies, body_w, (int32_t*)body_lens);
    return cudaGetLastError();
  });
}

template <bool kWords>
int layout(int32_t hash_bits, int32_t* out) {
  const size_t smem = sizeof(uint16_t) << hash_bits;
  int nb = 0;
  cudaError_t e = configured<kWords>(smem, [&] {
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, encode_kernel<kWords>, kThreads,
                                                         smem);
  });
  out[0] = nb;
  out[1] = (int32_t)smem;
  out[2] = kThreads;
  out[3] = kWords ? 1 : 0;
  return (int)e;
}

}  // namespace

// frags: uint8[B, frag_w], any address and width; lengths, body_lens:
// int32[B]; bodies: uint8[B, body_w] with body_w >= frag_w + frag_w / 65 + 11
// (the greedy emission bound and the 3 bytes a tag may store past it).
extern "C" int snappy_encode_launch(const void* frags, int64_t frag_w, const void* lengths,
                                    int64_t batch, int32_t hash_bits, int32_t skip_base,
                                    void* bodies, int64_t body_w, void* body_lens,
                                    void* stream) {
  if (batch == 0) return 0;
  return sc::word_rows(frags, frag_w)
             ? launch<true>(frags, frag_w, lengths, batch, hash_bits, skip_base, bodies, body_w,
                            body_lens, stream)
             : launch<false>(frags, frag_w, lengths, batch, hash_bits, skip_base, bodies, body_w,
                             body_lens, stream);
}

// The launch's layout for rows at frags of width frag_w: out[0] blocks per
// SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor under the attributes
// the launch sets), out[1] dynamic shared bytes per block, out[2] threads
// per block, out[3] 1 for the word loader and 0 for the byte loader.
extern "C" int snappy_encode_layout(const void* frags, int64_t frag_w, int32_t hash_bits,
                                    int32_t* out) {
  return sc::word_rows(frags, frag_w) ? layout<true>(hash_bits, out)
                                      : layout<false>(hash_bits, out);
}
