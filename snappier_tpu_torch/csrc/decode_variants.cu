// The decode-walk ablation on Hopper: six variants of the batched Snappy
// block decode, each timed against the production kernel (decode.cu).
//
// Replaces: tools/perf_probe.py::_decode_kernel_v2 (wrapper decode_v2),
// _decode_kernel_v4 (decode_v4), _decode_kernel_v3 (decode_v3) and
// _decode_kernel_v1 (decode_variant: v1, v1nock, v1nocp), the TPU
// scalar-core experiments on how a tag walk should keep its output image.
//
// What bounds them: as for decode.cu, the serial tag chain. A block's time
// is its tag count times the latency of one parse and one append (a chain
// of shared-memory loads, a table look-up, the stores and a warp barrier),
// not the 42 MB that 512 blocks move: those take about 13 us at 3.35 TB/s.
//
// What the design does about it: one warp per Snappy block, every lane on
// the same walk, as decode.cu. The compressed row is staged into shared
// memory first (only up to the block's length, coalesced word loads), so a
// parse reads two aligned shared words and a 256-entry descriptor table
// that the block builds in shared memory, instead of five global bytes.
// The word variants keep the output as 32-bit words: an append is one
// funnel shift (__funnelshift_r) per word with one word per lane, and a
// copy whose source overlaps its destination runs in rounds of the words
// whose sources are already written. The byte variant moves one byte per
// lane: 16 lanes make the fixed 16-byte over-copy a single step (its
// addresses never overlap: the source of byte i is src + i % off, behind
// the frontier), which one thread with byte moves would take 16 dependent
// steps for. The TPU kernels' separate word image beside the byte image,
// their int32-per-byte layout and their 1024-word DMA tiles do not exist
// here: shared memory is byte-addressed. Shared memory per block is the
// row's width plus out_cap plus about 1 KiB, so one or two blocks fit an
// SM where decode.cu fits three: the ablation's times include that.
#include <cuda_runtime.h>
#include <stdint.h>

#include "decode_stage.cuh"
#include "decode_variants.cuh"
#include "smem_config.cuh"

namespace {

using namespace stage;

template <bool kUnified, bool kUncondPair, bool kDeferred>
__global__ void decode_words_kernel(const uint8_t* __restrict__ comp, int64_t cc,
                                    const int32_t* __restrict__ comp_lens, int32_t out_cap,
                                    uint8_t* __restrict__ out, int32_t* __restrict__ out_lens,
                                    int32_t* __restrict__ errs) {
  extern __shared__ __align__(16) uint32_t smem[];
  int32_t* lut = reinterpret_cast<int32_t*>(smem);
  uint32_t* img = smem + LUT_WORDS;
  const int32_t wc = comp_words(cc);
  const int32_t owc = out_words(out_cap);
  const int64_t b = blockIdx.x;
  const int32_t n = row_length(comp_lens, b, cc);
  build_lut(lut);
  stage_row(comp + b * cc, cc, n, img, wc);
  __syncwarp();
  sc::DecodeResult r = sc::decode_block_words<kUnified, kUncondPair, kDeferred>(
      img, wc, owc, lut, n, out_cap, (int)threadIdx.x, (int)blockDim.x, WarpSync());
  __syncwarp();
  store_row(reinterpret_cast<const uint8_t*>(img + wc), r.out_len, out + b * (int64_t)out_cap,
            out_cap);
  if (threadIdx.x == 0) {
    out_lens[b] = r.out_len;
    errs[b] = r.err;
  }
}

template <bool kChecks, bool kCopies>
__global__ void decode_bytes_kernel(const uint8_t* __restrict__ comp, int64_t cc,
                                    const int32_t* __restrict__ comp_lens, int32_t out_cap,
                                    uint8_t* __restrict__ out, int32_t* __restrict__ out_lens,
                                    int32_t* __restrict__ errs) {
  extern __shared__ __align__(16) uint32_t smem[];
  int32_t* lut = reinterpret_cast<int32_t*>(smem);
  uint32_t* img = smem + LUT_WORDS;
  const int32_t wc = comp_words(cc);
  const int32_t total = (wc + out_words(out_cap) + byte_slack_words()) * 4;
  const int64_t b = blockIdx.x;
  const int32_t n = row_length(comp_lens, b, cc);
  build_lut(lut);
  stage_row(comp + b * cc, cc, n, img, wc);
  __syncwarp();
  sc::DecodeResult r = sc::decode_block_bytes16<kChecks, kCopies>(
      reinterpret_cast<uint8_t*>(img), wc * 4, total, lut, n, out_cap, (int)threadIdx.x,
      (int)blockDim.x, WarpSync());
  __syncwarp();
  if (kCopies) {
    store_row(reinterpret_cast<const uint8_t*>(img + wc), r.out_len,
              out + b * (int64_t)out_cap, out_cap);
  }
  if (threadIdx.x == 0) {
    out_lens[b] = r.out_len;
    errs[b] = r.err;
  }
}

// Dynamic shared memory a block of `variant` needs for rows of cc bytes
// (ops/cuda/decode_variants.py::_smem_bytes checks the same sum first).
size_t smem_bytes(int32_t variant, int64_t cc, int32_t out_cap) {
  size_t words = LUT_WORDS + (size_t)comp_words(cc) + (size_t)out_words(out_cap);
  if (variant >= 3) words += byte_slack_words();
  return words * 4;
}

// Sets the kernel's attributes for smem dynamic bytes and launches it
// under one lock (smem_config.cuh); set_for is the kernel's own record.
template <class Kernel>
int launch(Kernel kernel, attrs::SetFor& set_for, size_t smem, const void* comp, int64_t cc,
           const void* comp_lens, int64_t batch, int32_t out_cap, void* out, void* out_lens,
           void* errs, void* stream) {
  return (int)attrs::configure_and_launch(kernel, smem, set_for, [&] {
    kernel<<<(unsigned)batch, 32, smem, (cudaStream_t)stream>>>(
        (const uint8_t*)comp, cc, (const int32_t*)comp_lens, out_cap, (uint8_t*)out,
        (int32_t*)out_lens, (int32_t*)errs);
    return cudaGetLastError();
  });
}

}  // namespace


// variant: 0 decode_v2, 1 decode_v4, 2 decode_v3, 3 v1, 4 v1nock, 5 v1nocp.
// comp: uint8[B, cc]; comp_lens, out_lens, errs: int32[B]; out: uint8[B, out_cap].
extern "C" int snappy_decode_variant_launch(int32_t variant, const void* comp, int64_t cc,
                                            const void* comp_lens, int64_t batch,
                                            int32_t out_cap, void* out, void* out_lens,
                                            void* errs, void* stream) {
  if (batch == 0) return 0;
  size_t smem = smem_bytes(variant, cc, out_cap);
#define SNAPPY_LAUNCH(k)                                                                   \
  {                                                                                        \
    static attrs::SetFor set_for; /* one record an instantiation */                        \
    return launch(k, set_for, smem, comp, cc, comp_lens, batch, out_cap, out, out_lens, errs, \
                  stream);                                                                 \
  }
  switch (variant) {
    case 0: SNAPPY_LAUNCH((decode_words_kernel<false, false, false>));
    case 1: SNAPPY_LAUNCH((decode_words_kernel<false, true, true>));
    case 2: SNAPPY_LAUNCH((decode_words_kernel<true, false, true>));
    case 3: SNAPPY_LAUNCH((decode_bytes_kernel<true, true>));
    case 4: SNAPPY_LAUNCH((decode_bytes_kernel<false, true>));
    case 5: SNAPPY_LAUNCH((decode_bytes_kernel<true, false>));
  }
#undef SNAPPY_LAUNCH
  return (int)cudaErrorInvalidValue;
}
