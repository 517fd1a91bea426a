// The descriptor-driven block decode on Hopper: the batched Snappy block
// decode with every tag's fields decoded beforehand, by a pre-pass, into
// descriptors of one word (forms 5 and 6) or two (form 7) per byte position.
//
// Replaces: tools/perf_probe_hybrid.py::_decode_kernel_v5 (wrappers
// decode_v5 and, on a pre-pass computed beforehand, decode_v5_spec: the
// tool's v5parts) and its pre-pass _spec_from_comp, _decode_kernel_v6
// (decode_v6) and its pre-pass _spec_from_words, _decode_kernel_v7
// (decode_v7, with unroll2 the tool's v7u) and its pre-pass
// _spec2_from_words: the TPU experiments on a walk that parses nothing,
// where the vector unit decodes the tag at every position and the scalar
// core follows ip += adv[ip].
//
// What bounds them: as decode.cu, the serial tag chain, not the 42 MB that
// 512 blocks of output move (about 13 us at 3.35 TB/s). The pre-passes read
// the rows and write 4 bytes per compressed byte (8 for form 7); they are
// bound by device memory.
//
// Every form runs on the decode kernel's layout and loop (decode.cu; the
// block of csrc/batched_decode.cuh): two warps, warp 0 resolving a batch of
// about 15 tags a step by pointer doubling (sc::decode_block_batched) and
// warp 1 writing each a byte a lane; only the output image in shared memory
// (three blocks an SM at out_cap 65,536), the literal bytes read by the
// writing warp through the read-only path (sc::RowWords for word rows, else
// sc::RowBytes). The descriptors are the batch's per-lane input that the
// decode kernel makes with a 5-byte gather and a table: lane l reads the
// descriptor words at ip + l (hy::DescribedTags) from rings of 1 KiB, one a
// descriptor row, that the parsing warp fills ahead by cp.async
// (sc::RingWords). A failed batch names its first bad tag, whose error word
// (forms 5 and 6: the TPU's chain of checks) is computed from its descriptor
// then. A form-5 literal of negative length steps the output back: it ends
// its batch, whose output position moves by the signed sum of its lengths.
//
// The pre-pass is one kernel for every form (prepass_kernel): a thread a
// word of the row (4 positions), both words it needs read once through the
// read-only path, 4 or 8 bytes written a position, nothing kept between
// positions (hy::spec_at, hy::spec2_at). Form 5 reads the rows a byte at a
// time, as the TPU's _spec_from_comp slices bytes; forms 6 and 7 read word
// rows as words, two words and a shift a byte phase, as _spec_from_words
// does, and other rows a byte at a time.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "batched_decode.cuh"
#include "decode_hybrid.cuh"
#include "smem_config.cuh"

namespace {

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

template <int kForm, int kInput, bool kUnroll2>
__global__ void __launch_bounds__(kThreads)
    decode_desc_kernel(const uint8_t* __restrict__ comp, int64_t cc,
                       const int32_t* __restrict__ spec0, const int32_t* __restrict__ spec1,
                       int64_t spec_cc, const int32_t* __restrict__ comp_lens, int32_t out_cap,
                       uint8_t* __restrict__ out, int32_t* __restrict__ out_lens,
                       int32_t* __restrict__ errs) {
  constexpr int kRings = kForm == 7 ? 2 : 1;
  extern __shared__ __align__(16) uint8_t ow[];
  __shared__ uint32_t rings[kRings][kRingWords];
  __shared__ bd::Queue qs;
  bd::init(qs);
  __syncthreads();
  const int64_t b = blockIdx.x;
  const uint8_t* row = comp + b * cc;
  const int32_t width = bd::row_width(cc), sw = spec_width(spec_cc);
  const int32_t n = bd::row_length(comp_lens, b, sw);
  const sc::CudaWarp w{};
  using Ring = sc::RingWords<kRingWords>;
  using Row = typename std::conditional<kInput == kWords, sc::RowWords, sc::RowBytes>::type;
  using Src = hy::DescribedTags<kForm, Row, Ring>;
  Row in = [&] {
    if constexpr (kInput == kWords) {
      return sc::RowWords{reinterpret_cast<const uint32_t*>(row), width};
    } else {
      return sc::RowBytes{row, width};
    }
  }();
  auto spec_row = [&](const int32_t* spec) {
    return sc::RowWords{reinterpret_cast<const uint32_t*>(spec + b * spec_cc), 4 * sw};
  };
  Src src = [&] {
    if constexpr (kForm == 7) {
      return Src(in, Ring(spec_row(spec0), rings[0]), Ring(spec_row(spec1), rings[1]), sw);
    } else {
      return Src(in, Ring(spec_row(spec0), rings[0]), hy::NoSpec{}, sw);
    }
  }();
  const sc::DecodeResult res = bd::run(
      qs,
      [&](auto step) {
        const sc::DecodeResult r =
            sc::decode_block_batched<kUnroll2 ? 2 : 1>(w, src, n, out_cap, step);
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

// The descriptors of every position of `batch` rows of cc bytes into spec0
// (and spec1 for Desc = hy::SpecTwo; int32[batch, cc] each): a thread takes
// word g of a row (its positions 4g .. 4g + 3, from words g and g + 1 of the
// row, read as words with kWordsIn, else as bytes); kVecOut where cc is a
// multiple of 4 and the outputs 16-byte aligned (a 16-byte store an array),
// else a store a position.
template <class Desc, bool kWordsIn, bool kVecOut>
__global__ void __launch_bounds__(kPrepassThreads)
    prepass_kernel(const uint8_t* __restrict__ comp, int64_t cc, int64_t batch,
                   int32_t* __restrict__ spec0, int32_t* __restrict__ spec1) {
  const int32_t width = bd::row_width(cc);
  const int32_t groups = (int32_t)(((int64_t)width + 3) >> 2);
  const int32_t g = blockIdx.x * kPrepassThreads + threadIdx.x;
  if (g >= groups) return;
  int32_t* const outs[2] = {spec0, spec1};
  for (int64_t r = blockIdx.y; r < batch; r += gridDim.y) {
    const uint8_t* row = comp + r * cc;
    int32_t d[Desc::kArrays][4];
    if constexpr (kWordsIn) {
      hy::describe_word<Desc>(sc::RowWords{reinterpret_cast<const uint32_t*>(row), width}, g, d);
    } else {
      hy::describe_word<Desc>(sc::RowBytes{row, width}, g, d);
    }
    const int64_t at = r * cc + 4 * (int64_t)g;
#pragma unroll
    for (int k = 0; k < Desc::kArrays; k++) {
      if constexpr (kVecOut) {
        *reinterpret_cast<int4*>(outs[k] + at) = make_int4(d[k][0], d[k][1], d[k][2], d[k][3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; j++) {
          if (4 * g + j < width) outs[k][at + j] = d[k][j];
        }
      }
    }
  }
}

size_t dyn_bytes(int32_t out_cap) { return (size_t)((out_cap + 15) & ~15); }

bool word_rows(const void* comp, int64_t cc) {
  return ((uintptr_t)comp % 4) == 0 && cc % 4 == 0;
}

// decode_desc_kernel<kForm, kInput, kUnroll2>'s attributes, set per device
// (smem_config.cuh): one record an instantiation.
template <int kForm, int kInput, bool kUnroll2>
attrs::SetFor& set_for() {
  static attrs::SetFor s;
  return s;
}

template <int kForm, int kInput, bool kUnroll2, class Fn>
cudaError_t configured(int32_t out_cap, Fn fn) {
  return attrs::configure_and_launch(decode_desc_kernel<kForm, kInput, kUnroll2>,
                                     dyn_bytes(out_cap), set_for<kForm, kInput, kUnroll2>(), fn);
}

template <int kForm, int kInput, bool kUnroll2>
int launch_form(const void* comp, int64_t cc, const void* spec0, const void* spec1,
                int64_t spec_cc, const void* comp_lens, int64_t batch, int32_t out_cap,
                void* out, void* out_lens, void* errs, void* stream) {
  return (int)configured<kForm, kInput, kUnroll2>(out_cap, [&] {
    decode_desc_kernel<kForm, kInput, kUnroll2>
        <<<(unsigned)batch, kThreads, dyn_bytes(out_cap), (cudaStream_t)stream>>>(
            (const uint8_t*)comp, cc, (const int32_t*)spec0, (const int32_t*)spec1, spec_cc,
            (const int32_t*)comp_lens, out_cap, (uint8_t*)out, (int32_t*)out_lens,
            (int32_t*)errs);
    return cudaGetLastError();
  });
}

template <int kForm, int kInput>
int form_layout(int32_t out_cap, int32_t* out) {
  int nb = 0;
  cudaFuncAttributes attr;
  auto kernel = decode_desc_kernel<kForm, kInput, false>;
  cudaError_t e = configured<kForm, kInput, false>(out_cap, [&] {
    cudaError_t q =
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, kernel, kThreads, dyn_bytes(out_cap));
    return q == cudaSuccess ? cudaFuncGetAttributes(&attr, kernel) : q;
  });
  out[0] = nb;
  out[1] = e == cudaSuccess ? (int32_t)(dyn_bytes(out_cap) + attr.sharedSizeBytes) : 0;
  out[2] = kThreads;
  out[3] = kInput;
  return (int)e;
}

template <int kInput>
int layout_of(int32_t form, int32_t out_cap, int32_t* out) {
  if (form == 5) return form_layout<5, kInput>(out_cap, out);
  if (form == 6) return form_layout<6, kInput>(out_cap, out);
  if (form == 7) return form_layout<7, kInput>(out_cap, out);
  return (int)cudaErrorInvalidValue;
}

template <class Desc>
int launch_prepass(bool words_in, const void* comp, int64_t cc, int64_t batch, void* spec0,
                   void* spec1, void* stream) {
  const int64_t groups = ((cc < 0x7FFFFFFF ? cc : 0x7FFFFFFF) + 3) >> 2;
  const dim3 grid((unsigned)((groups + kPrepassThreads - 1) / kPrepassThreads),
                  (unsigned)(batch < 65535 ? batch : 65535));
  const bool vec_out = cc % 4 == 0 && ((uintptr_t)spec0 % 16) == 0 &&
                       (Desc::kArrays == 1 || ((uintptr_t)spec1 % 16) == 0);
  const uint8_t* c = (const uint8_t*)comp;
  int32_t *s0 = (int32_t*)spec0, *s1 = (int32_t*)spec1;
  const cudaStream_t st = (cudaStream_t)stream;
  if (words_in && vec_out) {
    prepass_kernel<Desc, true, true><<<grid, kPrepassThreads, 0, st>>>(c, cc, batch, s0, s1);
  } else if (words_in) {
    prepass_kernel<Desc, true, false><<<grid, kPrepassThreads, 0, st>>>(c, cc, batch, s0, s1);
  } else if (vec_out) {
    prepass_kernel<Desc, false, true><<<grid, kPrepassThreads, 0, st>>>(c, cc, batch, s0, s1);
  } else {
    prepass_kernel<Desc, false, false><<<grid, kPrepassThreads, 0, st>>>(c, cc, batch, s0, s1);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// form: 5 decode_v5 (and decode_v5_spec), 6 decode_v6, 7 decode_v7; unroll2
// only with form 7. comp: uint8[B, cc]; spec0: int32[B, spec_cc] with
// spec_cc <= cc, and spec1 (form 7, else unused) the same; comp_lens,
// out_lens, errs: int32[B]; out: uint8[B, out_cap].
extern "C" int snappy_decode_hybrid_launch(int32_t form, int32_t unroll2, const void* comp,
                                           int64_t cc, const void* spec0, const void* spec1,
                                           int64_t spec_cc, const void* comp_lens, int64_t batch,
                                           int32_t out_cap, void* out, void* out_lens,
                                           void* errs, void* stream) {
  if (batch == 0) return 0;
  if (spec_cc > cc || form < 5 || form > 7 || (form == 7 && spec1 == nullptr) ||
      (unroll2 && form != 7)) {
    return (int)cudaErrorInvalidValue;
  }
  const bool words = word_rows(comp, cc);
#define FORM_LAUNCH(F, I, U)                                                                  \
  launch_form<F, I, U>(comp, cc, spec0, spec1, spec_cc, comp_lens, batch, out_cap, out,        \
                       out_lens, errs, stream)
  if (form == 5) return words ? FORM_LAUNCH(5, kWords, false) : FORM_LAUNCH(5, kBytes, false);
  if (form == 6) return words ? FORM_LAUNCH(6, kWords, false) : FORM_LAUNCH(6, kBytes, false);
  if (unroll2) return words ? FORM_LAUNCH(7, kWords, true) : FORM_LAUNCH(7, kBytes, true);
  return words ? FORM_LAUNCH(7, kWords, false) : FORM_LAUNCH(7, kBytes, false);
#undef FORM_LAUNCH
}

// The pre-pass of form 5, 6 or 7: comp uint8[batch, cc], any address and
// width; spec0 (and spec1, form 7 only) int32[batch, cc], 4-byte aligned.
extern "C" int snappy_prepass_launch(int32_t form, const void* comp, int64_t cc, int64_t batch,
                                     void* spec0, void* spec1, void* stream) {
  if (form < 5 || form > 7 || (form == 7 && spec1 == nullptr)) return (int)cudaErrorInvalidValue;
  if (batch == 0 || cc == 0) return 0;
  const bool words_in = form != 5 && word_rows(comp, cc);
  return form == 7 ? launch_prepass<hy::SpecTwo>(words_in, comp, cc, batch, spec0, spec1, stream)
                   : launch_prepass<hy::SpecOne>(words_in, comp, cc, batch, spec0, spec1, stream);
}

// The layout of form 5, 6 or 7 for rows at comp of width cc: out[0] blocks
// per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor under the attributes
// the launch sets), out[1] shared bytes per block (dynamic and static),
// out[2] threads per block, out[3] the compressed row's loader: 0 words, 1
// bytes.
extern "C" int snappy_decode_hybrid_layout(const void* comp, int64_t cc, int32_t out_cap,
                                           int32_t form, int32_t* out) {
  return word_rows(comp, cc) ? layout_of<kWords>(form, out_cap, out)
                             : layout_of<kBytes>(form, out_cap, out);
}
