// The descriptor-driven block decode on Hopper: the batched Snappy block
// decode with every tag's fields decoded beforehand, one descriptor per byte
// position, by a tensor pre-pass (ops/cuda/decode_hybrid.py).
//
// Replaces: tools/perf_probe_hybrid.py::_decode_kernel_v5 (wrappers
// decode_v5 and, on a pre-pass computed beforehand, decode_v5_spec: the
// tool's v5parts), _decode_kernel_v6 (decode_v6) and _decode_kernel_v7
// (decode_v7, with unroll2 the tool's v7u), the TPU experiments on a walk
// that parses nothing: the vector unit decodes the tag at every position,
// the scalar core follows ip += adv[ip].
//
// What bounds them: as decode.cu, the serial tag chain. A block's time is
// its tag count times the latency of one descriptor load and one append,
// not the 42 MB that 512 blocks of output move (about 13 us at 3.35 TB/s).
// The pre-pass is separate tensor code that reads the rows and writes 4
// bytes per compressed byte (8 for v7); it is bound by device memory.
//
// What the design does about it: the layout of decode_variants.cu (one warp
// per Snappy block, every lane on the same walk; the compressed row staged
// up to its length and the output as word images in shared memory; appends
// by funnel shift, one word per lane). The TPU kernels stage the whole
// descriptor array in scalar memory too; here that does not fit: at the
// codec's row width (68,608 bytes) the image is 134 KB and the descriptors
// 274 KB (549 KB for v7's two arrays), above the 227 KB a block may have.
// So the descriptors stay in device memory and each tag reads its own
// through the read-only path (__ldg). The walk reads them strictly forward,
// one per tag, about 8,000 per block, so L1 and L2 serve most of them; the
// image alone keeps one block per SM at the codec's width and two at the
// tight one, as T1. The load of the next descriptor depends on this one's
// advance, so its latency is on the chain either way: the design trades the
// parse (a table load and a few operations on shared words) for one load
// that may miss L1.
#include <cuda_runtime.h>
#include <stdint.h>

#include "decode_hybrid.cuh"
#include "decode_stage.cuh"

namespace {

using namespace stage;

template <int kForm, bool kUnroll2>
__global__ void decode_hybrid_kernel(const uint8_t* __restrict__ comp, int64_t cc,
                                     const int32_t* __restrict__ spec0,
                                     const int32_t* __restrict__ spec1, int64_t spec_cc,
                                     const int32_t* __restrict__ comp_lens, int32_t out_cap,
                                     uint8_t* __restrict__ out, int32_t* __restrict__ out_lens,
                                     int32_t* __restrict__ errs) {
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* img = smem;
  const int32_t wc = comp_words(cc);
  const int32_t owc = out_words(out_cap);
  const int64_t b = blockIdx.x;
  const int32_t n = row_length(comp_lens, b, spec_cc);
  stage_row(comp + b * cc, cc, n, img, wc);
  __syncwarp();
  sc::DecodeResult r = hy::decode_block_hybrid<kForm, kUnroll2>(
      img, wc, owc, spec0 + b * spec_cc, kForm == 7 ? spec1 + b * spec_cc : nullptr, n, out_cap,
      (int)threadIdx.x, (int)blockDim.x, WarpSync());
  __syncwarp();
  store_row(reinterpret_cast<const uint8_t*>(img + wc), r.out_len, out + b * (int64_t)out_cap,
            out_cap);
  if (threadIdx.x == 0) {
    out_lens[b] = r.out_len;
    errs[b] = r.err;
  }
}

// Dynamic shared memory of one block for rows of cc bytes
// (ops/cuda/decode_hybrid.py::smem_bytes checks the same sum first).
size_t smem_bytes(int64_t cc, int32_t out_cap) {
  return ((size_t)comp_words(cc) + (size_t)out_words(out_cap)) * 4;
}

}  // namespace

// form: 5 decode_v5 (and decode_v5_spec), 6 decode_v6, 7 decode_v7; unroll2
// only with form 7. comp: uint8[B, cc]; spec0, spec1 (form 7, else unused):
// int32[B, spec_cc] with spec_cc <= cc; comp_lens, out_lens, errs: int32[B];
// out: uint8[B, out_cap].
extern "C" int snappy_decode_hybrid_launch(int32_t form, int32_t unroll2, const void* comp,
                                           int64_t cc, const void* spec0, const void* spec1,
                                           int64_t spec_cc, const void* comp_lens, int64_t batch,
                                           int32_t out_cap, void* out, void* out_lens,
                                           void* errs, void* stream) {
  if (batch == 0) return 0;
  if (spec_cc > cc || (form == 7 && spec1 == nullptr)) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(cc, out_cap);
#define SNAPPY_LAUNCH(F, U)                                                                   \
  do {                                                                                        \
    auto kernel = decode_hybrid_kernel<F, U>;                                                 \
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, \
                                         (int)smem);                                          \
    if (e != cudaSuccess) return (int)e;                                                      \
    kernel<<<(unsigned)batch, 32, smem, (cudaStream_t)stream>>>(                              \
        (const uint8_t*)comp, cc, (const int32_t*)spec0, (const int32_t*)spec1, spec_cc,      \
        (const int32_t*)comp_lens, out_cap, (uint8_t*)out, (int32_t*)out_lens,                \
        (int32_t*)errs);                                                                      \
    return (int)cudaGetLastError();                                                           \
  } while (0)
  if (form == 5 && !unroll2) SNAPPY_LAUNCH(5, false);
  if (form == 6 && !unroll2) SNAPPY_LAUNCH(6, false);
  if (form == 7) {
    if (unroll2) SNAPPY_LAUNCH(7, true);
    SNAPPY_LAUNCH(7, false);
  }
#undef SNAPPY_LAUNCH
  return (int)cudaErrorInvalidValue;
}
