// Batched match-extension probe on Hopper (a test hook).
//
// Replaces: snappier_tpu/ops/pallas/scalar_codec.py::_probe_kernel (wrapper
// match_extension_probe), which runs the production extension walk once
// per row so that the FindMatchLength golden vectors drive the code the
// encoders run.
//
// What bounds it: each row is one dependent chain of stride-8 steps, each
// step four 32-bit windows (two a span) compared and a branch; the longest
// row's walk is the launch. The bytes it must read are about twice the
// match length per row, so a launch is latency, not bandwidth: its floor is
// the longest walk's steps at one dependent load each.
//
// What the design does about it: one row to a warp, so that a load touches
// one line (a thread a row made each load touch 32 rows' lines) and the rows
// spread over the SMs; the row read as the aligned words that hold it
// (sc::RowSpan: the row's first and last words from its bytes where the row
// does not hold all four, never a byte outside the row); the arguments
// clamped here (sc::probe_args), so a wrapper call is one device operation.
// Every lane runs the same walk (sc::extend_match unchanged; the warp stays
// converged, a shared load is a broadcast) while the lanes fill a ring of
// each span in shared memory by cp.async at the walk's seed hook, far
// enough ahead that every window is two shared loads with no test on the
// row (sc::match_extension_ring).
#include <cuda_runtime.h>
#include <stdint.h>

#include "scalar_codec.cuh"

namespace {

constexpr int kWarps = 4;  // rows a block, one a warp
constexpr int kRingWords = 128;  // each span's ring (sc::SpanRings)

__global__ void __launch_bounds__(kWarps * 32)
    probe_kernel(const uint8_t* __restrict__ bufs, int64_t cc, const int32_t* __restrict__ ats,
                 const int32_t* __restrict__ cands, const int32_t* __restrict__ ns,
                 int64_t batch, int32_t* __restrict__ out) {
  __shared__ uint32_t rings[kWarps * 2 * kRingWords];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t b = (int64_t)blockIdx.x * kWarps + warp;
  if (b >= batch) return;
  const sc::ProbeArgs g = sc::probe_args(cc, ats[b], cands[b], ns[b]);
  const sc::RowSpan row(bufs + b * cc, cc < INT32_MAX ? (int32_t)cc : INT32_MAX);
  const int32_t m = sc::match_extension_ring<kRingWords>(sc::CudaWarp{}, row, g,
                                                         rings + warp * 2 * kRingWords);
  if (lane == 0) out[b] = m;
}

}  // namespace

// bufs: uint8[B, cc]; ats, cands, ns, out: int32[B], the arguments as given
// (clamped here).
extern "C" int match_probe_launch(const void* bufs, int64_t cc, const void* ats,
                                  const void* cands, const void* ns, int64_t batch, void* out,
                                  void* stream) {
  if (batch == 0) return 0;
  const unsigned blocks = (unsigned)((batch + kWarps - 1) / kWarps);
  probe_kernel<<<blocks, kWarps * 32, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)bufs, cc, (const int32_t*)ats, (const int32_t*)cands, (const int32_t*)ns,
      batch, (int32_t*)out);
  return (int)cudaGetLastError();
}
