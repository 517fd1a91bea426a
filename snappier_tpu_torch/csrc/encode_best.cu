// Batched level="best" Snappy encode on Hopper.
//
// Replaces: snappier_tpu/ops/pallas/scalar_codec.py::_encode_kernel with
// exact_cands=True (wrapper _encode_best_pallas, reached from
// encode_blocks_best), the TPU scalar-core walk driven by one precomputed
// candidate per position instead of a hash table.
//
// What bounds it: the walk is serial (each step starts where the copy
// before it ended), and the form before this one walked each fragment on
// one thread over device memory: a probe was a chain of dependent loads
// (the candidate, both windows, the extension's words), about 700 cycles,
// and 512 single-thread walks left the card nearly empty (7.8 ms for 512
// rows of 64 KiB in the facade's trace, against 0.05 ms for the bytes it
// must move: 32 MiB of fragments, 128 MiB of int32 candidates, about 8 MiB
// of bodies). What remains serial now is a chain of shared-memory steps a
// copy, on 32 segments at once, and the stitch where they meet.
//
// What the design does about it: the candidates are fixed before the walk,
// so each position's hit and match length do not depend on the path it
// takes. One block of up to 1,024 threads a row (eb::run_row in
// encode_best.cuh) stages the row in shared memory, works out every
// position's hit (a bitmask) and match length (capped at eb::kCap, finished
// only where a walk takes it) in parallel, walks 32 segments at once on
// warp 0's lanes over those (a find-first-set a probe group, a shared load
// a copy), stitches the segments where the true chain meets a segment's
// walk, and writes the tags from all threads after a scan of the copies'
// ends and tag bytes. The row is read through a loader (sc::RowWords where
// base and width are multiples of 4, else sc::RowBytes): nothing past a
// row's length is read. A 64 KiB row takes 213,952 bytes of shared memory,
// one block an SM; narrower rows take less and fewer threads.
#include <cuda_runtime.h>
#include <stdint.h>

#include "encode_best.cuh"
#include "smem_config.cuh"

namespace {

// eb's runner on the card: this thread's phase and registers.
struct DeviceRunner {
  int32_t t;
  eb::ThreadState st;
  template <class F>
  SC_HD void threads(F f) {
    f(t, st);
  }
  template <class F>
  SC_HD void warps(F f) {
    f(t >> 5, sc::CudaWarp{}, [this](int) -> eb::ThreadState& { return st; });
  }
  template <class F>
  SC_HD void warp0(F f) {
    if (t < 32) f(sc::CudaWarp{});
  }
  SC_HD void sync() {
#ifdef __CUDA_ARCH__
    __syncthreads();
#endif
  }
};

template <bool kWords>
__global__ void __launch_bounds__(eb::kMaxThreads, 1)
    encode_best_kernel(const uint8_t* __restrict__ frags, int64_t frag_w,
                       const int32_t* __restrict__ lengths, const int32_t* __restrict__ cands,
                       int32_t skip_base, uint8_t* __restrict__ bodies, int64_t body_w,
                       int32_t* __restrict__ body_lens, int32_t* stats) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int64_t b = blockIdx.x;
  int32_t n = lengths[b];
  n = n < 0 ? 0 : (n > frag_w ? (int32_t)frag_w : n);
  const eb::Layout lay = eb::layout_for((int32_t)frag_w);
  const eb::Smem m = eb::smem_at(smem, lay);
  const eb::Row row{cands + b * frag_w, n, skip_base, bodies + b * body_w, body_lens + b, stats};
  const uint8_t* bytes = frags + b * frag_w;
  DeviceRunner r{(int32_t)threadIdx.x, {}};
  if constexpr (kWords) {
    eb::run_row(r, lay, m, row, sc::RowWords{reinterpret_cast<const uint32_t*>(bytes), n});
  } else {
    eb::run_row(r, lay, m, row, sc::RowBytes{bytes, n});
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

// Runs fn with encode_best_kernel<kWords>'s shared memory for rows of width
// frag_w set on the current device, under the lock that orders it with
// every other launch of the kernel.
template <bool kWords, class Fn>
cudaError_t configured(int64_t frag_w, Fn fn) {
  const eb::Layout lay = eb::layout_for((int32_t)frag_w);
  return attrs::configure_and_launch(encode_best_kernel<kWords>, lay.bytes, set_for<kWords>(),
                                     [&] { return fn(lay); });
}

template <bool kWords>
int launch(const void* frags, int64_t frag_w, const void* lengths, int64_t batch,
           const void* cands, int32_t skip_base, void* bodies, int64_t body_w, void* body_lens,
           void* stats, void* stream) {
  return (int)configured<kWords>(frag_w, [&](const eb::Layout& lay) {
    encode_best_kernel<kWords><<<(unsigned)batch, lay.threads, lay.bytes, (cudaStream_t)stream>>>(
        (const uint8_t*)frags, frag_w, (const int32_t*)lengths, (const int32_t*)cands,
        skip_base, (uint8_t*)bodies, body_w, (int32_t*)body_lens, (int32_t*)stats);
    return cudaGetLastError();
  });
}

template <bool kWords>
int layout(int64_t frag_w, int32_t* out) {
  int nb = 0;
  eb::Layout got{};
  cudaError_t e = configured<kWords>(frag_w, [&](const eb::Layout& lay) {
    got = lay;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, encode_best_kernel<kWords>,
                                                         lay.threads, lay.bytes);
  });
  out[0] = nb;
  out[1] = (int32_t)got.bytes;
  out[2] = got.threads;
  out[3] = kWords ? 1 : 0;
  return (int)e;
}

}  // namespace

// frags: uint8[B, frag_w], any address, 0 < frag_w <= 65,536; lengths,
// body_lens: int32[B]; cands: int32[B, frag_w]; skip_base in [0, 2^30];
// bodies: uint8[B, body_w] with body_w >= frag_w + frag_w / 65 + 11 (the
// greedy emission bound, and more); stats: int32[2] to which each row adds
// the capped lengths its walks extended and the copies its stitch walked
// again, or null.
extern "C" int snappy_encode_best_launch(const void* frags, int64_t frag_w,
                                         const void* lengths, int64_t batch,
                                         const void* cands, int32_t skip_base, void* bodies,
                                         int64_t body_w, void* body_lens, void* stats,
                                         void* stream) {
  if (frag_w <= 0 || frag_w > 65536 || batch < 0 || skip_base < 0 || skip_base > (1 << 30)) {
    return (int)cudaErrorInvalidValue;
  }
  if (batch == 0) return 0;
  return word_rows(frags, frag_w)
             ? launch<true>(frags, frag_w, lengths, batch, cands, skip_base, bodies, body_w,
                            body_lens, stats, stream)
             : launch<false>(frags, frag_w, lengths, batch, cands, skip_base, bodies, body_w,
                             body_lens, stats, stream);
}

// The layout for rows at frags of width frag_w: out[0] blocks per SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor under the attributes the
// launch sets), out[1] dynamic shared bytes per block, out[2] threads per
// block, out[3] 1 for the word loader and 0 for the byte loader.
extern "C" int snappy_encode_best_layout(const void* frags, int64_t frag_w, int32_t* out) {
  if (frag_w <= 0 || frag_w > 65536) return (int)cudaErrorInvalidValue;
  return word_rows(frags, frag_w) ? layout<true>(frag_w, out) : layout<false>(frag_w, out);
}
