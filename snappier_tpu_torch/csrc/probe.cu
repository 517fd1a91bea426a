// Batched match-extension probe on Hopper (a test hook).
//
// Replaces: snappier_tpu/ops/pallas/scalar_codec.py::_probe_kernel (wrapper
// match_extension_probe), which runs the production extension walk once
// per row so that the FindMatchLength golden vectors drive the code the
// encoders run.
//
// What bounds it: each row is one short dependent chain of 4-byte compares;
// the bytes it must read are about twice the match length per row, so a
// launch is a few microseconds of latency, not bandwidth.
//
// What the design does about it: one thread per row, reading its row from
// global memory through sc::match_extension_row, which reads bytes outside
// the row as zero, so no row is staged or padded. The wrapper clamps n to
// the row width and at to [0, n], which bounds every walk.
#include <cuda_runtime.h>
#include <stdint.h>

#include "scalar_codec.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void probe_kernel(const uint8_t* __restrict__ bufs, int64_t cc,
                             const int32_t* __restrict__ ats,
                             const int32_t* __restrict__ cands,
                             const int32_t* __restrict__ ns, int64_t batch,
                             int32_t* __restrict__ out) {
  const int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= batch) return;
  out[b] = sc::match_extension_row(bufs + b * cc, cc, ats[b], cands[b], ns[b]);
}

}  // namespace

// bufs: uint8[B, cc]; ats, cands, ns, out: int32[B].
extern "C" int match_probe_launch(const void* bufs, int64_t cc, const void* ats,
                                  const void* cands, const void* ns, int64_t batch, void* out,
                                  void* stream) {
  if (batch == 0) return 0;
  unsigned blocks = (unsigned)((batch + kThreads - 1) / kThreads);
  probe_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)bufs, cc, (const int32_t*)ats, (const int32_t*)cands,
      (const int32_t*)ns, batch, (int32_t*)out);
  return (int)cudaGetLastError();
}
