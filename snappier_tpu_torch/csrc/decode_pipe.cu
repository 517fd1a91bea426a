// The pipelined decode walks on Hopper: the batched Snappy block decode in
// the forms of the TPU's software-pipelined walk.
//
// Replaces: tools/perf_probe_r4.py::_decode_kernel_pipe (wrapper decode_pipe)
// and _decode_kernel_pipe2 (wrapper decode_pipe2), the TPU scalar-core
// experiments on the latency of the tag chain: the next tag's loads started
// before this tag's stores, the error folded into the input position, two to
// four tags a loop iteration, unconditional stores past an append's end, a
// deferred wait on the output copy, and a walk that stores nothing.
//
// What bounds them: as decode.cu, the serial tag chain, not the 42 MB that
// 512 blocks move (about 13 us at 3.35 TB/s). A walk of one tag a step pays
// a parse, its table loads, an append and a barrier per tag (about 8,070
// tags a block on the word mix); loading the next tag ahead, the TPU's lever
// against its scalar core's load latency, does not shorten that chain.
//
// What the design does about it: one kernel for both, on the decode kernel's
// block and loop (decode.cu; csrc/batched_decode.cuh): two warps, warp 0
// resolving a batch of about 15 tags a step by pointer doubling
// (sc::decode_block_batched over sc::ParsedTags, K1's tag source through the
// cp.async ring or a byte at a time) and handing it through the queue to
// warp 1, which writes it a byte a lane (sc::emit_batch); only the output
// image in shared memory, three blocks an SM at out_cap 65,536. decode_pipe
// is K1's function and K1's source. decode_pipe2 differs in one case, its
// TPU kernel's: a 4-byte literal length field of 0xFFFFFFFF wraps to a
// literal of no bytes, which is taken (ParsedTags' kEmptyLiteral). The TPU
// knobs map to their nearest counterparts here: `unroll` is the batches
// parsed a loop iteration (decode_block_batched<kUnits>); `unc` stores whole
// rounds of the writing warp past a batch's end, the last round's (1) or
// every round left in that step (2), into 32 or 128 bytes of slack past the
// image (sc::emit_batch<kUnc>); without `emit` the parsing warp walks alone
// and hands nothing on, the walk's floor; with `dma_pipe` the finished image
// leaves shared memory by one bulk asynchronous copy from one lane
// (cp.async.bulk, after a proxy fence), where the rows allow it: an out_cap
// that is a multiple of 16 and a 16-byte aligned output, else the rows take
// the coalesced pass, as the form's rule.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "batched_decode.cuh"
#include "scalar_codec.cuh"
#include "smem_config.cuh"

namespace {

constexpr int kRingWords = 256;  // the input ring: 1 KiB
constexpr int kThreads = bd::kThreads;

// The input forms, decode.cu's: word rows through the ring, any row a byte at
// a time.
enum Input { kRing, kBytes };

template <int N>
using Int = std::integral_constant<int, N>;

// Orders a thread's shared-memory stores before a later copy by the copy
// engine; every thread that stored calls it, then the threads meet.
__device__ inline void fence_for_bulk() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// nb bytes (a multiple of 16) of a shared-memory image to global memory by
// the copy engine, from one thread; both addresses 16-byte aligned. Returns
// when the shared memory has been read.
__device__ inline void bulk_store(const void* smem_src, void* dst, uint32_t nb) {
  uint32_t src = (uint32_t)__cvta_generic_to_shared(smem_src);
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
               :: "l"(dst), "r"(src), "r"(nb) : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

// The block (csrc/batched_decode.cuh) over sc::ParsedTags<Ld, kEmptyLiteral>;
// kUnits batches a loop iteration, emit_batch<kUnc>; emit and bulk as the
// launcher's emit and dma_pipe.
template <bool kEmptyLiteral, int kInput, int kUnits, int kUnc>
__global__ void __launch_bounds__(kThreads)
    decode_pipe_kernel(const uint8_t* __restrict__ comp, int64_t cc,
                       const int32_t* __restrict__ comp_lens, int32_t out_cap, int32_t emit,
                       int32_t bulk, uint8_t* __restrict__ out, int32_t* __restrict__ out_lens,
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
  const int32_t width = bd::row_width(cc);
  const int32_t n = bd::row_length(comp_lens, b, width);
  const sc::CudaWarp w{};
  const sc::RowWords words{reinterpret_cast<const uint32_t*>(row), width};
  const sc::RowBytes bytes{row, width};
  const sc::DecodeResult res = bd::run(
      qs,
      [&](auto step) {
        if constexpr (kInput == kRing) {
          using Ring = sc::RingWords<kRingWords>;
          const sc::DecodeResult r = sc::decode_block_batched<kUnits>(
              w, sc::ParsedTags<Ring, kEmptyLiteral>(Ring(words, ring), lut), n, out_cap, step);
          asm volatile("cp.async.wait_all;\n" ::);  // no fill outlives the walk
          return r;
        } else {
          return sc::decode_block_batched<kUnits>(
              w, sc::ParsedTags<sc::RowBytes, kEmptyLiteral>(bytes, lut), n, out_cap, step);
        }
      },
      [&](const sc::Batch& bt, int32_t op, const auto& delta, const auto& start) {
        if constexpr (kInput == kRing) {
          sc::emit_batch<kUnc>(w, words, bt, op, ow, delta, start);
        } else {
          sc::emit_batch<kUnc>(w, bytes, bt, op, ow, delta, start);
        }
      },
      emit != 0);
  if (emit) {
    uint8_t* dst = out + b * (int64_t)out_cap;
    if (bulk && (out_cap & 15) == 0 && ((uintptr_t)out & 15) == 0) {
      const uint32_t nb = ((uint32_t)res.out_len + 15u) & ~15u;
      fence_for_bulk();
      __syncthreads();
      if (threadIdx.x == 0 && nb > 0) bulk_store(ow, dst, nb);
    } else {
      bd::store_row(ow, res.out_len, dst, out_cap);
    }
  }
  if (threadIdx.x == 0) {
    out_lens[b] = res.out_len;
    errs[b] = res.err;
  }
}

// The output image and the slack of emit_batch<unc>'s over-stores.
size_t dyn_bytes(int32_t out_cap, int unc) {
  return (size_t)((out_cap + 15) & ~15) + (size_t)sc::emit_slack(unc, 32);
}

// Word rows: base and width multiples of 4.
bool word_rows(const void* comp, int64_t cc) {
  return ((uintptr_t)comp % 4) == 0 && cc % 4 == 0;
}

// Each instantiation's attributes, set per device (smem_config.cuh).
template <bool kEmptyLiteral, int kInput, int kUnits, int kUnc>
attrs::SetFor& set_for() {
  static attrs::SetFor s;
  return s;
}

// Runs fn with the instantiation's shared-memory attributes set on the
// current device for out_cap, under the lock that orders them with every
// other launch of the kernel.
template <bool kEmptyLiteral, int kInput, int kUnits, int kUnc, class Fn>
cudaError_t configured(int32_t out_cap, Fn fn) {
  return attrs::configure_and_launch(decode_pipe_kernel<kEmptyLiteral, kInput, kUnits, kUnc>,
                                     dyn_bytes(out_cap, kUnc),
                                     set_for<kEmptyLiteral, kInput, kUnits, kUnc>(), fn);
}

// f(empty_literal, input, units, unc) with the form's compile-time
// parameters, for rows that are word rows or not: fold 0 decode_pipe (K1's
// source: unroll 1, unc 0 only), 1 decode_pipe2 (unroll 1-4, unc 0-2).
// Anything else is cudaErrorInvalidValue.
template <class F>
int with_form(int32_t fold, int32_t unroll, int32_t unc, bool words, F f) {
  auto by_units = [&](auto e, auto in) -> int {
    auto by_unc = [&](auto u) -> int {
      switch (unc) {
        case 0: return f(e, in, u, Int<0>{});
        case 1: return f(e, in, u, Int<1>{});
        case 2: return f(e, in, u, Int<2>{});
      }
      return (int)cudaErrorInvalidValue;
    };
    switch (unroll) {
      case 1: return by_unc(Int<1>{});
      case 2: return by_unc(Int<2>{});
      case 3: return by_unc(Int<3>{});
      case 4: return by_unc(Int<4>{});
    }
    return (int)cudaErrorInvalidValue;
  };
  if (fold == 0) {
    if (unroll != 1 || unc != 0) return (int)cudaErrorInvalidValue;
    return words ? f(std::false_type{}, Int<kRing>{}, Int<1>{}, Int<0>{})
                 : f(std::false_type{}, Int<kBytes>{}, Int<1>{}, Int<0>{});
  }
  if (fold != 1) return (int)cudaErrorInvalidValue;
  return words ? by_units(std::true_type{}, Int<kRing>{})
               : by_units(std::true_type{}, Int<kBytes>{});
}

}  // namespace

// fold: 0 decode_pipe (unroll 1, unc 0), 1 decode_pipe2. unroll: 1..4
// batches a loop iteration; unc: 0, 1 or 2; emit, dma_pipe: 0 or 1.
// comp: uint8[B, cc], any address and width; comp_lens, out_lens, errs:
// int32[B]; out: uint8[B, out_cap].
extern "C" int snappy_decode_pipe_launch(int32_t fold, int32_t unroll, int32_t unc,
                                         int32_t emit, int32_t dma_pipe, const void* comp,
                                         int64_t cc, const void* comp_lens, int64_t batch,
                                         int32_t out_cap, void* out, void* out_lens,
                                         void* errs, void* stream) {
  return with_form(fold, unroll, unc, word_rows(comp, cc), [&](auto e, auto in, auto u, auto c) {
    constexpr bool E = decltype(e)::value;
    constexpr int I = decltype(in)::value, U = decltype(u)::value, C = decltype(c)::value;
    if (batch == 0) return 0;
    return (int)configured<E, I, U, C>(out_cap, [&] {
      decode_pipe_kernel<E, I, U, C>
          <<<(unsigned)batch, kThreads, dyn_bytes(out_cap, C), (cudaStream_t)stream>>>(
              (const uint8_t*)comp, cc, (const int32_t*)comp_lens, out_cap, emit, dma_pipe,
              (uint8_t*)out, (int32_t*)out_lens, (int32_t*)errs);
      return cudaGetLastError();
    });
  });
}

// The layout of a form (fold, unroll, unc as the launcher takes them) for
// rows at comp of width cc: out[0] blocks per SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor under the attributes the
// launch sets), out[1] shared bytes per block (dynamic and static), out[2]
// threads per block, out[3] the input form: 0 the ring, 1 bytes.
extern "C" int snappy_decode_pipe_layout(const void* comp, int64_t cc, int32_t out_cap,
                                         int32_t fold, int32_t unroll, int32_t unc,
                                         int32_t* out) {
  return with_form(fold, unroll, unc, word_rows(comp, cc), [&](auto e, auto in, auto u, auto c) {
    constexpr bool E = decltype(e)::value;
    constexpr int I = decltype(in)::value, U = decltype(u)::value, C = decltype(c)::value;
    auto kernel = decode_pipe_kernel<E, I, U, C>;
    int nb = 0;
    cudaFuncAttributes attr;
    const cudaError_t err = configured<E, I, U, C>(out_cap, [&] {
      cudaError_t q = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, kernel, kThreads,
                                                                    dyn_bytes(out_cap, C));
      return q == cudaSuccess ? cudaFuncGetAttributes(&attr, kernel) : q;
    });
    out[0] = nb;
    out[1] = err == cudaSuccess ? (int32_t)(dyn_bytes(out_cap, C) + attr.sharedSizeBytes) : 0;
    out[2] = kThreads;
    out[3] = I;
    return (int)err;
  });
}
