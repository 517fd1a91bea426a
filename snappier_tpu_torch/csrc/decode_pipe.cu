// The pipelined decode walks on Hopper: the batched Snappy block decode with
// the next tag loaded before this tag's payload is stored.
//
// Replaces: tools/perf_probe_r4.py::_decode_kernel_pipe (wrapper decode_pipe)
// and _decode_kernel_pipe2 (wrapper decode_pipe2), the TPU scalar-core
// experiments on the latency of the tag chain: software pipelining of the
// walk, the error folded into the input position, two to four tags per loop
// iteration, unconditional first stores, a deferred wait on the output copy.
//
// What bounds them: as decode.cu, the serial tag chain: a block's time is
// its tag count times the latency of one parse and one append, not the
// 42 MB that 512 blocks move (about 13 us at 3.35 TB/s).
//
// What the design does about it: the layout of decode_variants.cu (one warp
// per Snappy block, the compressed row and the output as word images in
// shared memory, one word per lane and append). New is the walk: the loop
// carries the next tag's three table entries and the 4 bytes after its tag
// byte, all shared-memory loads started as soon as this tag's advance is
// known, so that their latency can pass while the lanes store this tag's
// payload; the three tables make the parse free of branches on the tag
// type. `unc` stores the two (1) or four (2) words after an append's
// frontier word whatever its length, which takes the short-append branch
// out of the lanes' path. The TPU kernel's `dma_pipe` let one block's
// output copy drain under the next block's input copy on a core that runs
// blocks one after the other; blocks run side by side here, so its
// counterpart is the drain itself: with `dma_pipe` one lane hands the
// finished image to the copy engine (a bulk asynchronous copy from shared
// to global memory) and the warp only waits until shared memory has been
// read, where without it the lanes store the row 16 bytes each.
#include <cuda_runtime.h>
#include <stdint.h>

#include "decode_stage.cuh"
#include "decode_variants.cuh"
#include "smem_config.cuh"

namespace {

using namespace stage;

constexpr int PIPE_LUT_WORDS = 3 * LUT_WORDS;

// Orders a lane's shared-memory stores before a later copy by the copy
// engine; every lane that stored calls it, then the lanes meet.
__device__ inline void fence_for_bulk() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// nb bytes (a multiple of 16) of a shared-memory image to global memory by
// the copy engine, from one lane; both addresses 16-byte aligned. Returns
// when the shared memory has been read.
__device__ inline void bulk_store(const void* smem_src, void* dst, uint32_t nb) {
  uint32_t src = (uint32_t)__cvta_generic_to_shared(smem_src);
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
               :: "l"(dst), "r"(src), "r"(nb) : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

template <bool kFold, int kUncond>
__global__ void decode_pipe_kernel(const uint8_t* __restrict__ comp, int64_t cc,
                                   const int32_t* __restrict__ comp_lens, int32_t out_cap,
                                   int32_t unroll, int32_t emit, int32_t bulk,
                                   uint8_t* __restrict__ out, int32_t* __restrict__ out_lens,
                                   int32_t* __restrict__ errs) {
  extern __shared__ __align__(16) uint32_t smem[];
  int32_t* luts = reinterpret_cast<int32_t*>(smem);
  uint32_t* img = smem + PIPE_LUT_WORDS;
  const int32_t wc = comp_words(cc);
  const int32_t owc = out_words(out_cap);
  const int64_t b = blockIdx.x;
  const int32_t n = row_length(comp_lens, b, cc);
  for (int t = threadIdx.x; t < LUT_WORDS; t += blockDim.x) {
    sc::pipe_lut_entry(t, kFold, luts[t], luts[LUT_WORDS + t], luts[2 * LUT_WORDS + t]);
  }
  stage_row(comp + b * cc, cc, n, img, wc);
  __syncwarp();
  sc::DecodeResult r = sc::decode_block_pipe<kFold, kUncond>(
      img, wc, owc, luts, n, out_cap, unroll, emit != 0, (int)threadIdx.x, (int)blockDim.x,
      WarpSync());
  __syncwarp();
  if (emit) {
    const uint8_t* src = reinterpret_cast<const uint8_t*>(img + wc);
    uint8_t* dst = out + b * (int64_t)out_cap;
    if (bulk && (out_cap & 15) == 0 && ((uintptr_t)out & 15) == 0) {
      uint32_t nb = ((uint32_t)r.out_len + 15u) & ~15u;
      fence_for_bulk();
      __syncwarp();
      if (threadIdx.x == 0 && nb > 0) bulk_store(src, dst, nb);
    } else {
      store_row(src, r.out_len, dst, out_cap);
    }
  }
  if (threadIdx.x == 0) {
    out_lens[b] = r.out_len;
    errs[b] = r.err;
  }
}

// Sets the kernel's attributes for its dynamic bytes and launches it under
// one lock (smem_config.cuh); set_for is the kernel's own record.
template <class Kernel>
int launch(Kernel kernel, attrs::SetFor& set_for, const void* comp, int64_t cc,
           const void* comp_lens, int64_t batch, int32_t out_cap, int32_t unroll, int32_t emit,
           int32_t bulk, void* out, void* out_lens, void* errs, void* stream) {
  const size_t smem = ((size_t)PIPE_LUT_WORDS + comp_words(cc) + out_words(out_cap)) * 4;
  return (int)attrs::configure_and_launch(kernel, smem, set_for, [&] {
    kernel<<<(unsigned)batch, 32, smem, (cudaStream_t)stream>>>(
        (const uint8_t*)comp, cc, (const int32_t*)comp_lens, out_cap, unroll, emit, bulk,
        (uint8_t*)out, (int32_t*)out_lens, (int32_t*)errs);
    return cudaGetLastError();
  });
}

}  // namespace

// fold: 0 decode_pipe (unroll 1, unc 0), 1 decode_pipe2. unroll: 1..4 tags
// per loop iteration; unc: 0, 1 or 2; emit, dma_pipe: 0 or 1.
// comp: uint8[B, cc]; comp_lens, out_lens, errs: int32[B]; out: uint8[B, out_cap].
extern "C" int snappy_decode_pipe_launch(int32_t fold, int32_t unroll, int32_t unc,
                                         int32_t emit, int32_t dma_pipe, const void* comp,
                                         int64_t cc, const void* comp_lens, int64_t batch,
                                         int32_t out_cap, void* out, void* out_lens,
                                         void* errs, void* stream) {
  if (batch == 0) return 0;
  if (unroll < 1 || unroll > 4 || unc < 0 || unc > 2) return (int)cudaErrorInvalidValue;
#define SNAPPY_LAUNCH(k)                                                                     \
  {                                                                                          \
    static attrs::SetFor set_for; /* one record an instantiation */                          \
    return launch(k, set_for, comp, cc, comp_lens, batch, out_cap, unroll, emit, dma_pipe, out, \
                  out_lens, errs, stream);                                                   \
  }
  if (!fold) {
    if (unroll != 1 || unc != 0) return (int)cudaErrorInvalidValue;
    SNAPPY_LAUNCH((decode_pipe_kernel<false, 0>));
  }
  switch (unc) {
    case 0: SNAPPY_LAUNCH((decode_pipe_kernel<true, 0>));
    case 1: SNAPPY_LAUNCH((decode_pipe_kernel<true, 2>));
    case 2: SNAPPY_LAUNCH((decode_pipe_kernel<true, 4>));
  }
#undef SNAPPY_LAUNCH
  return (int)cudaErrorInvalidValue;
}
