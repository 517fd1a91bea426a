// Batched Snappy block decode on Hopper.
//
// Replaces: snappier_tpu/ops/pallas/scalar_codec.py::_decode_kernel (wrapper
// decode_blocks_scalar), the TPU scalar-core tag walk.
//
// What bounds it: the tag chain is serial (each tag's position comes from
// the previous tag), so a block's time is its steps times the latency of
// one step, not memory bandwidth: 32 MiB of output at 3.35 TB/s is about
// 10 us, while one block holds thousands of tags. A walk that takes one tag
// a step pays a parse, a shared-memory round trip and a barrier per tag
// (about 8,070 tags of 8.1 output bytes on the word mix, 250 ns each: 2 ms a
// block), and no form of it moved that by more than 12%.
//
// What the design does about it: one block per Snappy block, the output
// built in dynamic shared memory (out_cap bytes, 64 KiB at the codec's
// width: three blocks an SM, since copies reach back 64 KiB), and a walk
// that resolves a batch of tags per warp step (scalar_codec.cuh): in
// sc::parse_batch each lane parses the tag that would start at its byte of
// a 32-byte window (two input words, a 256-entry tag table in static shared
// memory), pointer doubling over the lanes' successors finds the real tags
// and their output offsets in four rounds of shuffles, and a ballot checks
// them all; in sc::emit_batch the batch's output (about 15 tags, 120 bytes
// on the word mix) is written a byte a lane a round across tag boundaries,
// four rounds a step whose tag look-ups are independent, one __syncwarp a
// round. Two warps a block: warp 0 parses and hands each batch (its tags'
// offsets and sources, 264 bytes) to warp 1 through a queue of four slots
// in shared memory, and warp 1 writes it (the block of
// csrc/batched_decode.cuh), so a batch's parse overlaps the previous
// batch's output; 10% faster on the word mix than one warp doing
// both (PERF.md; NVIDIA H100 80GB HBM3, 700.00 W). The output leaves shared
// memory in one coalesced pass.
//
// The input: rows whose base and width are multiples of 4 are parsed
// through a ring of 1 KiB in static shared memory that the parsing warp
// fills with cp.async 384 bytes ahead (sc::RingWords; 3% faster than the
// same words read through the read-only path with an L1 prefetch, on the
// same card), and the writing warp reads literal bytes as words through the
// read-only path; other rows a byte at a time (sc::RowBytes). No byte at or
// past the row's width is read, so the last row may end where its buffer
// ends.
#include <cuda_runtime.h>
#include <stdint.h>

#include "batched_decode.cuh"
#include "scalar_codec.cuh"
#include "smem_config.cuh"

namespace {

constexpr int kRingWords = 256;  // the input ring: 1 KiB
constexpr int kThreads = bd::kThreads;

// The input forms: word rows through the ring, any row a byte at a time.
enum Input { kRing, kBytes };

// The block (csrc/batched_decode.cuh): warp 0 parses the row's tags
// (sc::ParsedTags over the ring or the bytes, the table in static shared
// memory), warp 1 writes each batch, its literal bytes read through the
// read-only path.
template <int kInput>
__global__ void __launch_bounds__(kThreads)
    decode_kernel(const uint8_t* __restrict__ comp, int64_t cc,
                  const int32_t* __restrict__ comp_lens, int32_t out_cap,
                  uint8_t* __restrict__ out, int32_t* __restrict__ out_lens,
                  int32_t* __restrict__ errs) {
  extern __shared__ __align__(16) uint8_t ow[];
  __shared__ uint32_t lut[256];
  __shared__ uint32_t ring[kRingWords];
  __shared__ bd::Queue qs;
  const int64_t b = blockIdx.x;
  for (int t = threadIdx.x; t < 256; t += kThreads) lut[t] = sc::tag_entry((uint32_t)t);
  bd::init(qs);
  __syncthreads();
  const uint8_t* row = comp + b * cc;
  const int32_t width = bd::row_width(cc), n = comp_lens[b];
  const sc::CudaWarp w{};
  const sc::RowWords words{reinterpret_cast<const uint32_t*>(row), width};
  const sc::RowBytes bytes{row, width};
  const sc::DecodeResult res = bd::run(
      qs,
      [&](auto step) {
        if constexpr (kInput == kRing) {
          using Ring = sc::RingWords<kRingWords>;
          const sc::DecodeResult r = sc::decode_block_batched(
              w, sc::ParsedTags<Ring>(Ring(words, ring), lut), n, out_cap, step);
          asm volatile("cp.async.wait_all;\n" ::);  // no fill outlives the walk
          return r;
        } else {
          return sc::decode_block_batched(w, sc::ParsedTags<sc::RowBytes>(bytes, lut), n,
                                          out_cap, step);
        }
      },
      [&](const sc::Batch& bt, int32_t op, const auto& delta, const auto& start) {
        if constexpr (kInput == kRing) {
          sc::emit_batch(w, words, bt, op, ow, delta, start);
        } else {
          sc::emit_batch(w, bytes, bt, op, ow, delta, start);
        }
      });
  bd::store_row(ow, res.out_len, out + b * (int64_t)out_cap, out_cap);
  if (threadIdx.x == 0) {
    out_lens[b] = res.out_len;
    errs[b] = res.err;
  }
}

size_t dyn_bytes(int32_t out_cap) { return (size_t)((out_cap + 15) & ~15); }

// Word rows: base and width multiples of 4.
bool word_rows(const void* comp, int64_t cc) {
  return ((uintptr_t)comp % 4) == 0 && cc % 4 == 0;
}

// decode_kernel<kInput>'s attributes, set per device (smem_config.cuh).
template <int kInput>
attrs::SetFor& set_for() {
  static attrs::SetFor s;
  return s;
}

// Runs fn with decode_kernel<kInput>'s shared-memory attributes set on the
// current device for out_cap, under the lock that orders them with every
// other launch of the kernel.
template <int kInput, class Fn>
cudaError_t configured(int32_t out_cap, Fn fn) {
  return attrs::configure_and_launch(decode_kernel<kInput>, dyn_bytes(out_cap),
                                     set_for<kInput>(), fn);
}

template <int kInput>
int launch(const void* comp, int64_t cc, const void* comp_lens, int64_t batch, int32_t out_cap,
           void* out, void* out_lens, void* errs, void* stream) {
  if (batch == 0) return 0;
  return (int)configured<kInput>(out_cap, [&] {
    decode_kernel<kInput><<<(unsigned)batch, kThreads, dyn_bytes(out_cap),
                            (cudaStream_t)stream>>>(
        (const uint8_t*)comp, cc, (const int32_t*)comp_lens, out_cap, (uint8_t*)out,
        (int32_t*)out_lens, (int32_t*)errs);
    return cudaGetLastError();
  });
}

template <int kInput>
int layout(int32_t out_cap, int32_t* out) {
  int nb = 0;
  cudaFuncAttributes attr;
  cudaError_t e = configured<kInput>(out_cap, [&] {
    cudaError_t q = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &nb, decode_kernel<kInput>, kThreads, dyn_bytes(out_cap));
    return q == cudaSuccess ? cudaFuncGetAttributes(&attr, decode_kernel<kInput>) : q;
  });
  out[0] = nb;
  out[1] = e == cudaSuccess ? (int32_t)(dyn_bytes(out_cap) + attr.sharedSizeBytes) : 0;
  out[2] = kThreads;
  out[3] = kInput;
  return (int)e;
}

}  // namespace

// comp: uint8[B, cc], any address and width; comp_lens, out_lens, errs:
// int32[B]; out: uint8[B, out_cap].
extern "C" int snappy_decode_launch(const void* comp, int64_t cc, const void* comp_lens,
                                    int64_t batch, int32_t out_cap, void* out,
                                    void* out_lens, void* errs, void* stream) {
  return word_rows(comp, cc)
             ? launch<kRing>(comp, cc, comp_lens, batch, out_cap, out, out_lens, errs, stream)
             : launch<kBytes>(comp, cc, comp_lens, batch, out_cap, out, out_lens, errs, stream);
}

// The launch's layout for rows at comp of width cc: out[0] blocks per SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor under the attributes the
// launch sets), out[1] shared bytes per block (dynamic and static), out[2]
// threads per block, out[3] the input form: 0 the ring, 1 bytes.
extern "C" int snappy_decode_layout(const void* comp, int64_t cc, int32_t out_cap,
                                    int32_t* out) {
  return word_rows(comp, cc) ? layout<kRing>(out_cap, out) : layout<kBytes>(out_cap, out);
}
