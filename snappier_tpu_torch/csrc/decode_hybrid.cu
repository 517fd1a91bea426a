// The descriptor-driven block decode on Hopper: the batched Snappy block
// decode with every tag's fields decoded beforehand, one descriptor per byte
// position, by a pre-pass.
//
// Replaces: tools/perf_probe_hybrid.py::_decode_kernel_v5 (wrappers
// decode_v5 and, on a pre-pass computed beforehand, decode_v5_spec: the
// tool's v5parts), _decode_kernel_v6 (decode_v6) and _decode_kernel_v7
// (decode_v7, with unroll2 the tool's v7u) and its pre-pass
// _spec2_from_words, the TPU experiments on a walk that parses nothing: the
// vector unit decodes the tag at every position, the scalar core follows
// ip += adv[ip].
//
// What bounds them: as decode.cu, the serial tag chain, not the 42 MB that
// 512 blocks of output move (about 13 us at 3.35 TB/s). The pre-passes read
// the rows and write 4 bytes per compressed byte (8 for v7); they are bound
// by device memory.
//
// Forms 5 and 6 (decode_hybrid_kernel<kForm>) keep the layout of
// decode_variants.cu: one warp per Snappy block, every lane on the same
// walk a tag at a time; the compressed row staged up to its length and the
// output as word images in shared memory; appends by funnel shift, one word
// per lane; each tag's descriptor read through the read-only path (__ldg),
// since the descriptors do not fit beside the images (at the codec's row
// width of 68,608 bytes the image is 134 KB and the descriptors 274 KB).
// That holds one block per SM at the codec's width and two at the tight one.
// Their pre-passes are tensor code (ops/cuda/decode_hybrid.py).
//
// Form 7 runs on the decode kernel's layout and loop (decode.cu; the block
// of csrc/batched_decode.cuh): two warps, warp 0 resolving a batch of
// about 15 tags a step by pointer doubling (sc::decode_block_batched) and
// warp 1 writing each a byte a lane; only the output image in shared memory
// (three blocks an SM at out_cap 65,536), the literal bytes read by the
// writing warp through the read-only path (sc::RowWords for word rows, else
// sc::RowBytes). Its descriptors are the batch's per-lane input that the
// decode kernel makes with a 5-byte gather and a table: lane l reads
// spec0[ip + l] and spec1[ip + l] (hy::DescribedTags) from two rings of
// 1 KiB that the parsing warp fills ahead by cp.async (sc::RingWords). Its
// pre-pass is prepass_v7_kernel: a thread a word of the row (4 positions),
// both words it needs read once through the read-only path, 8 bytes
// written a position, nothing kept between positions (hy::spec2_at).
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "batched_decode.cuh"
#include "decode_hybrid.cuh"
#include "decode_stage.cuh"
#include "smem_config.cuh"

namespace {

using namespace stage;

template <int kForm>
__global__ void decode_hybrid_kernel(const uint8_t* __restrict__ comp, int64_t cc,
                                     const int32_t* __restrict__ spec0, int64_t spec_cc,
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
  sc::DecodeResult r = hy::decode_block_hybrid<kForm>(
      img, wc, owc, spec0 + b * spec_cc, n, out_cap, (int)threadIdx.x, (int)blockDim.x,
      WarpSync());
  __syncwarp();
  store_row(reinterpret_cast<const uint8_t*>(img + wc), r.out_len, out + b * (int64_t)out_cap,
            out_cap);
  if (threadIdx.x == 0) {
    out_lens[b] = r.out_len;
    errs[b] = r.err;
  }
}

// Dynamic shared memory of one block of forms 5 and 6 for rows of cc bytes
// (ops/cuda/decode_hybrid.py::smem_bytes checks the same sum first).
size_t smem_bytes(int64_t cc, int32_t out_cap) {
  return ((size_t)comp_words(cc) + (size_t)out_words(out_cap)) * 4;
}

// --- form 7 ------------------------------------------------------------------

constexpr int kRingWords = 256;  // each descriptor ring: 1 KiB
constexpr int kThreads = bd::kThreads;
constexpr int kPrepassThreads = 256;

// The compressed row's loader for the writing warp and the preamble: word
// rows (base and width multiples of 4) as words, any other a byte at a time.
enum Input { kWords, kBytes };

// A descriptor row is read through word loaders that count bytes in int32,
// so a row of more than 2^29 - 1 descriptors is read as its first 2^29 - 1.
__device__ int32_t spec_width(int64_t spec_cc) {
  return spec_cc < (1 << 29) - 1 ? (int32_t)spec_cc : (1 << 29) - 1;
}

template <int kInput, bool kUnroll2>
__global__ void __launch_bounds__(kThreads)
    decode_v7_kernel(const uint8_t* __restrict__ comp, int64_t cc,
                     const int32_t* __restrict__ spec0, const int32_t* __restrict__ spec1,
                     int64_t spec_cc, const int32_t* __restrict__ comp_lens, int32_t out_cap,
                     uint8_t* __restrict__ out, int32_t* __restrict__ out_lens,
                     int32_t* __restrict__ errs) {
  extern __shared__ __align__(16) uint8_t ow[];
  __shared__ uint32_t ring0[kRingWords], ring1[kRingWords];
  __shared__ bd::Queue qs;
  bd::init(qs);
  __syncthreads();
  const int64_t b = blockIdx.x;
  const uint8_t* row = comp + b * cc;
  const int32_t width = bd::row_width(cc), sw = spec_width(spec_cc);
  const int32_t n = row_length(comp_lens, b, sw);
  const sc::CudaWarp w{};
  using Ring = sc::RingWords<kRingWords>;
  using Row = typename std::conditional<kInput == kWords, sc::RowWords, sc::RowBytes>::type;
  Row in = [&] {
    if constexpr (kInput == kWords) {
      return sc::RowWords{reinterpret_cast<const uint32_t*>(row), width};
    } else {
      return sc::RowBytes{row, width};
    }
  }();
  const sc::RowWords d0{reinterpret_cast<const uint32_t*>(spec0 + b * spec_cc), 4 * sw};
  const sc::RowWords d1{reinterpret_cast<const uint32_t*>(spec1 + b * spec_cc), 4 * sw};
  const sc::DecodeResult res = bd::run(
      qs,
      [&](auto step) {
        const sc::DecodeResult r = sc::decode_block_batched<kUnroll2 ? 2 : 1>(
            w, hy::DescribedTags<Row, Ring>(in, Ring(d0, ring0), Ring(d1, ring1), sw), n,
            out_cap, step);
        asm volatile("cp.async.wait_all;\n" ::);  // no fill outlives the walk
        return r;
      },
      [&](const sc::Batch& bt, int32_t op, const auto& delta, const auto& start) {
        sc::emit_batch(w, in, bt, op, ow, delta, start);
      });
  bd::store_row(ow, res.out_len, out + b * (int64_t)out_cap, out_cap);
  if (threadIdx.x == 0) {
    out_lens[b] = res.out_len;
    errs[b] = res.err;
  }
}

// Form 7's descriptors of every position of `batch` rows of cc bytes into
// spec0 and spec1 (int32[batch, cc]): a thread takes word g of a row (its
// positions 4g .. 4g + 3, from words g and g + 1), kVec where the rows are
// word rows and the outputs 16-byte aligned (a 16-byte store each), else the
// bytes and a store a position.
template <bool kVec>
__global__ void __launch_bounds__(kPrepassThreads)
    prepass_v7_kernel(const uint8_t* __restrict__ comp, int64_t cc, int64_t batch,
                      int32_t* __restrict__ spec0, int32_t* __restrict__ spec1) {
  const int32_t width = bd::row_width(cc);
  const int32_t groups = (int32_t)(((int64_t)width + 3) >> 2);
  const int32_t g = blockIdx.x * kPrepassThreads + threadIdx.x;
  if (g >= groups) return;
  for (int64_t r = blockIdx.y; r < batch; r += gridDim.y) {
    const uint8_t* row = comp + r * cc;
    uint64_t v;
    if constexpr (kVec) {
      const sc::RowWords in{reinterpret_cast<const uint32_t*>(row), width};
      v = (uint64_t)in.word(g + 1) << 32 | in.word(g);
    } else {
      const sc::RowBytes in{row, width};
      v = (uint64_t)in.word(g + 1) << 32 | in.word(g);
    }
    int32_t a[4], c[4];
#pragma unroll
    for (int j = 0; j < 4; j++) hy::spec2_at(v >> (8 * j), a[j], c[j]);
    const int64_t at = r * cc + 4 * (int64_t)g;
    if constexpr (kVec) {
      *reinterpret_cast<int4*>(spec0 + at) = make_int4(a[0], a[1], a[2], a[3]);
      *reinterpret_cast<int4*>(spec1 + at) = make_int4(c[0], c[1], c[2], c[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; j++) {
        if (4 * g + j < width) {
          spec0[at + j] = a[j];
          spec1[at + j] = c[j];
        }
      }
    }
  }
}

size_t v7_dyn_bytes(int32_t out_cap) { return (size_t)((out_cap + 15) & ~15); }

bool word_rows(const void* comp, int64_t cc) {
  return ((uintptr_t)comp % 4) == 0 && cc % 4 == 0;
}

// decode_v7_kernel<kInput, kUnroll2>'s attributes, set per device
// (smem_config.cuh): one record an instantiation.
template <int kInput, bool kUnroll2>
attrs::SetFor& set_for() {
  static attrs::SetFor s;
  return s;
}

template <int kInput, bool kUnroll2, class Fn>
cudaError_t configured(int32_t out_cap, Fn fn) {
  return attrs::configure_and_launch(decode_v7_kernel<kInput, kUnroll2>, v7_dyn_bytes(out_cap),
                                     set_for<kInput, kUnroll2>(), fn);
}

template <int kInput, bool kUnroll2>
int launch_v7(const void* comp, int64_t cc, const void* spec0, const void* spec1,
              int64_t spec_cc, const void* comp_lens, int64_t batch, int32_t out_cap, void* out,
              void* out_lens, void* errs, void* stream) {
  return (int)configured<kInput, kUnroll2>(out_cap, [&] {
    decode_v7_kernel<kInput, kUnroll2>
        <<<(unsigned)batch, kThreads, v7_dyn_bytes(out_cap), (cudaStream_t)stream>>>(
            (const uint8_t*)comp, cc, (const int32_t*)spec0, (const int32_t*)spec1, spec_cc,
            (const int32_t*)comp_lens, out_cap, (uint8_t*)out, (int32_t*)out_lens,
            (int32_t*)errs);
    return cudaGetLastError();
  });
}

template <int kInput>
int v7_layout(int32_t out_cap, int32_t* out) {
  int nb = 0;
  cudaFuncAttributes attr;
  cudaError_t e = configured<kInput, false>(out_cap, [&] {
    cudaError_t q = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &nb, decode_v7_kernel<kInput, false>, kThreads, v7_dyn_bytes(out_cap));
    return q == cudaSuccess ? cudaFuncGetAttributes(&attr, decode_v7_kernel<kInput, false>) : q;
  });
  out[0] = nb;
  out[1] = e == cudaSuccess ? (int32_t)(v7_dyn_bytes(out_cap) + attr.sharedSizeBytes) : 0;
  out[2] = kThreads;
  out[3] = kInput;
  return (int)e;
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
  if (spec_cc > cc || (form == 7 && spec1 == nullptr) || (unroll2 && form != 7)) {
    return (int)cudaErrorInvalidValue;
  }
  if (form == 7) {
    const bool words = word_rows(comp, cc);
#define V7_LAUNCH(I, U)                                                                   \
  launch_v7<I, U>(comp, cc, spec0, spec1, spec_cc, comp_lens, batch, out_cap, out, out_lens, \
                  errs, stream)
    if (unroll2) return words ? V7_LAUNCH(kWords, true) : V7_LAUNCH(kBytes, true);
    return words ? V7_LAUNCH(kWords, false) : V7_LAUNCH(kBytes, false);
#undef V7_LAUNCH
  }
  const size_t smem = smem_bytes(cc, out_cap);
#define SNAPPY_LAUNCH(F)                                                                      \
  do {                                                                                        \
    auto kernel = decode_hybrid_kernel<F>;                                                    \
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, \
                                         (int)smem);                                          \
    if (e != cudaSuccess) return (int)e;                                                      \
    kernel<<<(unsigned)batch, 32, smem, (cudaStream_t)stream>>>(                              \
        (const uint8_t*)comp, cc, (const int32_t*)spec0, spec_cc, (const int32_t*)comp_lens,  \
        out_cap, (uint8_t*)out, (int32_t*)out_lens, (int32_t*)errs);                          \
    return (int)cudaGetLastError();                                                           \
  } while (0)
  if (form == 5) SNAPPY_LAUNCH(5);
  if (form == 6) SNAPPY_LAUNCH(6);
#undef SNAPPY_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// Form 7's pre-pass: comp uint8[batch, cc], any address and width; spec0,
// spec1 int32[batch, cc], 4-byte aligned.
extern "C" int snappy_prepass_v7_launch(const void* comp, int64_t cc, int64_t batch, void* spec0,
                                        void* spec1, void* stream) {
  if (batch == 0 || cc == 0) return 0;
  const int64_t groups = ((cc < 0x7FFFFFFF ? cc : 0x7FFFFFFF) + 3) >> 2;
  const dim3 grid((unsigned)((groups + kPrepassThreads - 1) / kPrepassThreads),
                  (unsigned)(batch < 65535 ? batch : 65535));
  const bool vec = word_rows(comp, cc) && ((uintptr_t)spec0 % 16) == 0 &&
                   ((uintptr_t)spec1 % 16) == 0;
  if (vec) {
    prepass_v7_kernel<true><<<grid, kPrepassThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)comp, cc, batch, (int32_t*)spec0, (int32_t*)spec1);
  } else {
    prepass_v7_kernel<false><<<grid, kPrepassThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)comp, cc, batch, (int32_t*)spec0, (int32_t*)spec1);
  }
  return (int)cudaGetLastError();
}

// Form 7's layout for rows at comp of width cc: out[0] blocks per SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor under the attributes the
// launch sets), out[1] shared bytes per block (dynamic and static), out[2]
// threads per block, out[3] the compressed row's loader: 0 words, 1 bytes.
extern "C" int snappy_decode_v7_layout(const void* comp, int64_t cc, int32_t out_cap,
                                       int32_t* out) {
  return word_rows(comp, cc) ? v7_layout<kWords>(out_cap, out) : v7_layout<kBytes>(out_cap, out);
}
