// The encode-walk ablation on Hopper, second family: the production walk in
// the named restructurings of encode_r4.
//
// Replaces: tools/perf_probe_r4.py::_encode_kernel_r4 (wrapper encode_r4),
// the TPU scalar-core experiments on the production encode walk at 15 hash
// bits: the next group preloaded before this one resolves, the epoch check
// folded into one compare with candidate selection deferred to the hit
// branch, two nested loops in place of a branch per probe, stride-8 and
// stride-16 extension walks, an eight-wide probe, no emission, no walk.
//
// What bounds it: as encode.cu, the serial walk of one thread per fragment;
// the bytes of 512 fragments take about 12 us at 3.35 TB/s.
//
// What the design does about it: encode.cu's layout at 15 hash bits (128 KiB
// of shared memory, one block per SM). The TPU kernel's precomputed hash
// image would double the staged bytes past what an SM holds, so hashes are
// computed in the walk, as encode.cu does. Names whose TPU difference has
// no counterpart on a SIMT core share a kernel: a pl.when region against a
// lax.cond is the same branch here (encwhen = enctrim, encwhen8 = trim with
// the stride-8 walk, enccopywhen = the base walk), and encr4 = encext8u.
// The word-packed output image of the TPU kernel has no counterpart: the
// walking thread stores bytes straight into the body's row.
#include <cuda_runtime.h>
#include <stdint.h>

#include "encode_variants.cuh"

namespace {

using namespace sc;
constexpr uint32_t BASE = EV_XOR_TAIL | EV_BFREE_COPY;

}  // namespace

// mask: the EV_* bits of the walk (ops/cuda/encode_variants.py::R4_VARIANTS).
// frags: uint8[B, frag_w]; lengths, body_lens: int32[B]; bodies: uint8[B, body_w].
extern "C" int snappy_encode_r4_launch(uint32_t mask, int32_t hash_bits, int32_t store_step,
                                       const void* frags, int64_t frag_w, const void* lengths,
                                       int64_t batch, void* bodies, int64_t body_w,
                                       void* body_lens, void* stream) {
  if (batch == 0) return 0;
#define SNAPPY_CASE(m)                                                                       \
  case (m):                                                                                  \
    return ev::launch(sc::StaticWalk<(m)>{hash_bits, store_step}, frags, frag_w, lengths,    \
                      batch, bodies, body_w, body_lens, stream)
  switch (mask) {
    SNAPPY_CASE(BASE | EV_EXT_4);                   // enccopywhen
    SNAPPY_CASE(BASE | EV_EXT_4 | EV_LOOP_PRE);     // encpre
    SNAPPY_CASE(BASE | EV_EXT_4 | EV_LOOP_TWO);     // enc2loop
    SNAPPY_CASE(BASE | EV_EXT_4 | EV_EMIT_COUNT);   // encnoemit
    SNAPPY_CASE(BASE | EV_EXT_4 | EV_TRIM);         // enctrim, encwhen
    SNAPPY_CASE(BASE | EV_EXT_4 | EV_OCT);          // encoct
    SNAPPY_CASE(BASE | EV_EXT_8);                   // encext8
    SNAPPY_CASE(BASE | EV_EXT_8 | EV_TRIM);         // encfull
    SNAPPY_CASE(BASE | EV_EXT_8U);                  // encext8u, encr4
    SNAPPY_CASE(BASE | EV_EXT_8U | EV_TRIM);        // encwhen8
    SNAPPY_CASE(BASE | EV_EXT_8U | EV_OCT);         // encoct8
    SNAPPY_CASE(BASE | EV_EXT_8S2);                 // encext8s2
    SNAPPY_CASE(BASE | EV_EXT_16U);                 // encext16u
    SNAPPY_CASE(BASE | EV_EXT_4 | EV_DMA_ONLY);     // encdmaonly
  }
#undef SNAPPY_CASE
  return (int)cudaErrorInvalidValue;
}
