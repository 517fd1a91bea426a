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
// in shared memory, and warp 1 writes it, so a batch's parse overlaps the
// previous batch's output; 10% faster on the word mix than one warp doing
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

#include "scalar_codec.cuh"
#include "smem_config.cuh"

namespace {

constexpr int kWarp = 32;
constexpr int kRingWords = 256;  // the input ring: 1 KiB
constexpr int kQueue = 4;        // batches in flight between the two warps
constexpr int kThreads = 2 * kWarp;

// The input forms: word rows through the ring, any row a byte at a time.
enum Input { kRing, kBytes };

// A block's walk reads no further than about six times out_cap into its
// row (ip passes only tags that were checked against the output left), so
// a row wider than 2^31 - 1 bytes is read as its first 2^31 - 1.
__device__ int32_t row_width(int64_t cc) { return cc < 0x7FFFFFFF ? (int32_t)cc : 0x7FFFFFFF; }

// The output row leaves shared memory: whole 16-byte groups when rows start
// 16-byte aligned (the tail past out_len is garbage by contract and may be
// written), else bytes.
__device__ void store_row(const uint8_t* ow, int32_t nb, uint8_t* dst, int32_t out_cap, int t,
                          int nthreads) {
  if ((out_cap & 15) == 0) {
    const int32_t groups = (nb + 15) >> 4;
    const uint4* s4 = reinterpret_cast<const uint4*>(ow);
    uint4* d4 = reinterpret_cast<uint4*>(dst);
    for (int32_t g = t; g < groups; g += nthreads) d4[g] = s4[g];
  } else {
    for (int32_t i = t; i < nb; i += nthreads) dst[i] = ow[i];
  }
}

// A queue slot: one parsed batch, or the end of the walk.
struct Slot {
  int32_t delta[kWarp];
  uint32_t start[kWarp];
  sc::Batch bt;
  int32_t op;
  int32_t end;
};

template <int kInput>
__global__ void __launch_bounds__(kThreads)
    decode_kernel(const uint8_t* __restrict__ comp, int64_t cc,
                  const int32_t* __restrict__ comp_lens, int32_t out_cap,
                  uint8_t* __restrict__ out, int32_t* __restrict__ out_lens,
                  int32_t* __restrict__ errs) {
  extern __shared__ __align__(16) uint8_t ow[];
  __shared__ uint32_t lut[256];
  __shared__ uint32_t ring[kRingWords];
  __shared__ Slot q[kQueue];
  __shared__ int32_t head, tail;  // slots published by warp 0, freed by warp 1
  __shared__ sc::DecodeResult res;
  const int64_t b = blockIdx.x;
  const int lane = threadIdx.x & (kWarp - 1);
  for (int t = threadIdx.x; t < 256; t += kThreads) lut[t] = sc::tag_entry((uint32_t)t);
  if (threadIdx.x == 0) head = tail = 0;
  __syncthreads();
  volatile int32_t* vhead = &head;
  volatile int32_t* vtail = &tail;
  const uint8_t* row = comp + b * cc;
  const int32_t width = row_width(cc), n = comp_lens[b];
  const sc::CudaWarp w{};
  const sc::RowWords words{reinterpret_cast<const uint32_t*>(row), width};
  const sc::RowBytes bytes{row, width};
  if (threadIdx.x < kWarp) {
    // Warp 0 parses and hands each batch on.
    int32_t h = 0;
    auto publish = [&](const sc::Batch& bt, int32_t op, int32_t end, int32_t delta,
                       uint32_t start) {
      while (h - *vtail >= kQueue) {
      }
      Slot& s = q[h % kQueue];
      s.delta[lane] = delta;
      s.start[lane] = start;
      if (lane == 0) {
        s.bt = bt;
        s.op = op;
        s.end = end;
      }
      __syncwarp();
      if (lane == 0) {
        __threadfence_block();
        *vhead = h + 1;
      }
      h++;
    };
    auto step = [&](const auto&, const sc::Batch& bt, int32_t op, const auto& delta,
                    const auto& start) { publish(bt, op, 0, delta.v, start.v); };
    sc::DecodeResult r;
    if constexpr (kInput == kRing) {
      r = sc::decode_block_batched(w, sc::RingWords<kRingWords>(words, ring), n, out_cap, lut,
                                   step);
      asm volatile("cp.async.wait_all;\n" ::);  // no fill outlives the walk
    } else {
      r = sc::decode_block_batched(w, bytes, n, out_cap, lut, step);
    }
    publish(sc::Batch{}, 0, 1, 0, 0u);
    if (lane == 0) res = r;
  } else {
    // Warp 1 writes each batch as it arrives, its slot first in registers
    // (the output's stores could alias it).
    for (int32_t t = 0;; t++) {
      while (*vhead == t) {
      }
      __threadfence_block();
      const Slot& s = q[t % kQueue];
      if (s.end) break;
      const sc::Batch bt = s.bt;
      const int32_t op = s.op;
      const sc::LanesOf<sc::CudaWarp, int32_t> delta{s.delta[lane]};
      const sc::LanesOf<sc::CudaWarp, uint32_t> start{s.start[lane]};
      if constexpr (kInput == kRing) {
        sc::emit_batch(w, words, bt, op, ow, delta, start);
      } else {
        sc::emit_batch(w, bytes, bt, op, ow, delta, start);
      }
      __syncwarp();
      if (lane == 0) {
        __threadfence_block();
        *vtail = t + 1;
      }
    }
  }
  __syncthreads();
  store_row(ow, res.out_len, out + b * (int64_t)out_cap, out_cap, threadIdx.x, kThreads);
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
