// Batched Snappy block decode on Hopper.
//
// Replaces: snappier_tpu/ops/pallas/scalar_codec.py::_decode_kernel (wrapper
// decode_blocks_scalar), the TPU scalar-core tag walk.
//
// What bounds it: the tag chain is serial (each tag's position comes from
// the previous tag), so a block's time is its tag count times the latency
// of one parse, not memory bandwidth: 32 MiB of output at 3.35 TB/s is about
// 10 us, while one block holds thousands of dependent tag parses.
//
// What the design does about it: one warp per block, so 512 blocks run as
// 512 independent chains across the SMs. All 32 lanes run the same walk on
// the same (broadcast) bytes, so no lane waits on another for control flow;
// the lanes split each tag's payload, so long literals and copies cost one
// step per 32 bytes. The output is built in shared memory (out_cap bytes),
// which keeps copy sources next to the SM, and leaves in one coalesced pass.
#include <cuda_runtime.h>
#include <stdint.h>

#include "scalar_codec.cuh"

namespace {

// Declared for both sides so that decode_block<WarpSync>, a __host__
// __device__ template, never calls a device-only function from host code.
struct WarpSync {
  __host__ __device__ void operator()() const {
#ifdef __CUDA_ARCH__
    __syncwarp();
#endif
  }
};

__global__ void decode_kernel(const uint8_t* __restrict__ comp, int64_t cc,
                              const int32_t* __restrict__ comp_lens, int32_t out_cap,
                              uint8_t* __restrict__ out, int32_t* __restrict__ out_lens,
                              int32_t* __restrict__ errs) {
  extern __shared__ __align__(16) uint8_t ow[];
  const int64_t b = blockIdx.x;
  const int lane = threadIdx.x;
  sc::DecodeResult r = sc::decode_block(comp + b * cc, cc, comp_lens[b], out_cap, ow,
                                        lane, (int)blockDim.x, WarpSync());
  __syncwarp();
  uint8_t* dst = out + b * (int64_t)out_cap;
  int32_t nb = r.out_len;
  if ((out_cap & 15) == 0) {
    // Rows start 16-byte aligned: copy whole 16-byte groups (the tail past
    // out_len is garbage by contract and may be written).
    int32_t groups = (nb + 15) >> 4;
    const uint4* s4 = reinterpret_cast<const uint4*>(ow);
    uint4* d4 = reinterpret_cast<uint4*>(dst);
    for (int32_t g = lane; g < groups; g += blockDim.x) d4[g] = s4[g];
  } else {
    for (int32_t i = lane; i < nb; i += blockDim.x) dst[i] = ow[i];
  }
  if (lane == 0) {
    out_lens[b] = r.out_len;
    errs[b] = r.err;
  }
}

}  // namespace

// comp: uint8[B, cc]; comp_lens, out_lens, errs: int32[B]; out: uint8[B, out_cap].
extern "C" int snappy_decode_launch(const void* comp, int64_t cc, const void* comp_lens,
                                    int64_t batch, int32_t out_cap, void* out,
                                    void* out_lens, void* errs, void* stream) {
  if (batch == 0) return 0;
  size_t smem = (size_t)((out_cap + 15) & ~15);
  cudaError_t e = cudaFuncSetAttribute(decode_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  decode_kernel<<<(unsigned)batch, 32, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)comp, cc, (const int32_t*)comp_lens, out_cap, (uint8_t*)out,
      (int32_t*)out_lens, (int32_t*)errs);
  return (int)cudaGetLastError();
}
