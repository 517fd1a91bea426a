// The decode-walk ablation on Hopper: six forms of the batched Snappy block
// decode, each timed against the production kernel (decode.cu).
//
// Replaces: tools/perf_probe.py::_decode_kernel_v2 (wrapper decode_v2),
// _decode_kernel_v4 (decode_v4), _decode_kernel_v3 (decode_v3) and
// _decode_kernel_v1 (decode_variant: v1, v1nock, v1nocp), the TPU
// scalar-core experiments on how a tag walk should keep its output image.
//
// What bounds them: as for decode.cu, the serial tag chain. A block's time
// is its steps times the latency of one step, not the 42 MB that 512 blocks
// move: those take about 13 us at 3.35 TB/s. A walk of one tag a step pays a
// parse, an append and a warp barrier per tag (about 8,070 tags a block on
// the word mix).
//
// What the design does about it: one kernel for all six, on the decode
// kernel's block and loop (decode.cu; csrc/batched_decode.cuh): two warps,
// warp 0 resolving a batch of about 15 tags a step by pointer doubling
// (sc::decode_block_batched over dv::VariantTags, the decode kernel's tag
// source with T1-T4's error words: csrc/decode_variants.cuh) and handing it
// through the queue to warp 1, which writes it a byte a lane
// (sc::emit_batch); word rows parsed through the cp.async ring, any other
// row a byte at a time; only the output image (and its slack) in dynamic
// shared memory, three blocks an SM at out_cap 65,536. The TPU knobs map to
// their nearest counterparts on this walk (dv::with_variant): v2 and v3
// emit_batch<0> (v3's one image and one source address have no counterpart:
// emit_batch already resolves literals and copies through one source word);
// v4's two words stored past the frontier emit_batch<1> (a batch's last
// round stored whole, 32 bytes of slack); v1's fixed 16-byte move a tag
// emit_batch<2> (every round left in a step stored whole, 128 bytes of
// slack); v1nock the source without its checks, but for the room and offset
// tests that keep every access inside the image and the row; v1nocp a
// parsing warp that hands nothing on (only out_lens and errs are written).
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "batched_decode.cuh"
#include "decode_variants.cuh"
#include "scalar_codec.cuh"
#include "smem_config.cuh"

namespace {

constexpr int kRingWords = 256;  // the input ring: 1 KiB
constexpr int kThreads = bd::kThreads;

// The input forms, decode.cu's: word rows through the ring, any row a byte at
// a time.
enum Input { kRing, kBytes };

// The block (csrc/batched_decode.cuh) over dv::VariantTags<Ld, kChecks>,
// emit_batch<kUnc>; without emit the parsing warp walks alone.
template <bool kChecks, int kInput, int kUnc>
__global__ void __launch_bounds__(kThreads)
    decode_variant_kernel(const uint8_t* __restrict__ comp, int64_t cc,
                          const int32_t* __restrict__ comp_lens, int32_t out_cap, int32_t emit,
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
          const sc::DecodeResult r = sc::decode_block_batched(
              w, dv::VariantTags<Ring, kChecks>(Ring(words, ring), lut, n), n, out_cap, step);
          asm volatile("cp.async.wait_all;\n" ::);  // no fill outlives the walk
          return r;
        } else {
          return sc::decode_block_batched(
              w, dv::VariantTags<sc::RowBytes, kChecks>(bytes, lut, n), n, out_cap, step);
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
  if (emit) bd::store_row(ow, res.out_len, out + b * (int64_t)out_cap, out_cap);
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
template <bool kChecks, int kInput, int kUnc>
attrs::SetFor& set_for() {
  static attrs::SetFor s;
  return s;
}

// Runs fn with the instantiation's shared-memory attributes set on the
// current device for out_cap, under the lock that orders them with every
// other launch of the kernel.
template <bool kChecks, int kInput, int kUnc, class Fn>
cudaError_t configured(int32_t out_cap, Fn fn) {
  return attrs::configure_and_launch(decode_variant_kernel<kChecks, kInput, kUnc>,
                                     dyn_bytes(out_cap, kUnc), set_for<kChecks, kInput, kUnc>(),
                                     fn);
}

// f(checks, input, unc, emit) for the launcher's variant number, for rows
// that are word rows or not; anything else is cudaErrorInvalidValue.
template <class F>
int with_form(int32_t variant, bool words, F f) {
  const int r = dv::with_variant(variant, [&](auto checks, auto unc, bool emit) {
    return words ? f(checks, std::integral_constant<int, kRing>{}, unc, emit)
                 : f(checks, std::integral_constant<int, kBytes>{}, unc, emit);
  });
  return r == -1 ? (int)cudaErrorInvalidValue : r;
}

}  // namespace

// variant: 0 decode_v2, 1 decode_v4, 2 decode_v3, 3 v1, 4 v1nock, 5 v1nocp.
// comp: uint8[B, cc], any address and width; comp_lens, out_lens, errs:
// int32[B]; out: uint8[B, out_cap].
extern "C" int snappy_decode_variant_launch(int32_t variant, const void* comp, int64_t cc,
                                            const void* comp_lens, int64_t batch,
                                            int32_t out_cap, void* out, void* out_lens,
                                            void* errs, void* stream) {
  return with_form(variant, word_rows(comp, cc), [&](auto k, auto in, auto u, bool emit) {
    constexpr bool K = decltype(k)::value;
    constexpr int I = decltype(in)::value, U = decltype(u)::value;
    if (batch == 0) return 0;
    return (int)configured<K, I, U>(out_cap, [&] {
      decode_variant_kernel<K, I, U>
          <<<(unsigned)batch, kThreads, dyn_bytes(out_cap, U), (cudaStream_t)stream>>>(
              (const uint8_t*)comp, cc, (const int32_t*)comp_lens, out_cap, (int32_t)emit,
              (uint8_t*)out, (int32_t*)out_lens, (int32_t*)errs);
      return cudaGetLastError();
    });
  });
}

// The layout of a variant for rows at comp of width cc: out[0] blocks per SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor under the attributes the
// launch sets), out[1] shared bytes per block (dynamic and static), out[2]
// threads per block, out[3] the input form: 0 the ring, 1 bytes.
extern "C" int snappy_decode_variant_layout(const void* comp, int64_t cc, int32_t out_cap,
                                            int32_t variant, int32_t* out) {
  return with_form(variant, word_rows(comp, cc), [&](auto k, auto in, auto u, bool) {
    constexpr bool K = decltype(k)::value;
    constexpr int I = decltype(in)::value, U = decltype(u)::value;
    auto kernel = decode_variant_kernel<K, I, U>;
    int nb = 0;
    cudaFuncAttributes attr;
    const cudaError_t err = configured<K, I, U>(out_cap, [&] {
      cudaError_t q = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, kernel, kThreads,
                                                                    dyn_bytes(out_cap, U));
      return q == cudaSuccess ? cudaFuncGetAttributes(&attr, kernel) : q;
    });
    out[0] = nb;
    out[1] = err == cudaSuccess ? (int32_t)(dyn_bytes(out_cap, U) + attr.sharedSizeBytes) : 0;
    out[2] = kThreads;
    out[3] = I;
    return (int)err;
  });
}
