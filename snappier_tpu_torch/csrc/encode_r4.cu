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
// What bounds it: as encode.cu, the serial walk of one thread per fragment
// times the waves of fragments; the bytes of 512 fragments take about 12 us
// at 3.35 TB/s.
//
// What the design does about it: encode.cu's layout at 15 hash bits
// (encode_variants.cuh: the 64 KiB match table alone in dynamic shared
// memory, the fragment read through the read-only path as words, one block
// of one warp per fragment), so three walks share an SM and 512 fragments
// run in two waves, as K2's do; encext8u and encr4 walk K2's bytes in K2's
// layout. The TPU kernel's precomputed hash image has no counterpart: hashes
// are computed in the walk, as encode.cu does. Names whose TPU difference has
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

// Calls op with the StaticWalk of a named mask at 15 hash bits; any other
// mask is refused.
template <class Op>
int with_walk(uint32_t mask, int32_t hash_bits, int32_t store_step, Op op) {
#define SNAPPY_CASE(m) \
  case (m):            \
    return op(sc::StaticWalk<(m)>{hash_bits, store_step})
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

}  // namespace

// mask: the EV_* bits of the walk (ops/cuda/encode_variants.py::R4_VARIANTS).
// frags: uint8[B, frag_w], any address and width; lengths, body_lens:
// int32[B]; bodies: uint8[B, body_w] (ev::launch).
extern "C" int snappy_encode_r4_launch(uint32_t mask, int32_t hash_bits, int32_t store_step,
                                       const void* frags, int64_t frag_w, const void* lengths,
                                       int64_t batch, void* bodies, int64_t body_w,
                                       void* body_lens, void* stream) {
  return with_walk(mask, hash_bits, store_step, [&](auto cfg) {
    return ev::launch(cfg, frags, frag_w, lengths, batch,
                      ev::BodyRows{(uint8_t*)bodies, body_w, (int32_t*)body_lens}, stream);
  });
}

// The layout of the launch above for rows at frags of width frag_w
// (ev::layout: blocks per SM, shared bytes, threads, loader).
extern "C" int snappy_encode_r4_layout(const void* frags, int64_t frag_w, uint32_t mask,
                                       int32_t hash_bits, int32_t store_step, int32_t* out) {
  return with_walk(mask, hash_bits, store_step, [&](auto cfg) {
    return ev::layout<ev::BodyRows>(cfg, frags, frag_w, out);
  });
}
