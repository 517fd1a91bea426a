// The encode-walk ablation on Hopper, first family: the greedy walk under
// the flag tuples of encode_variant.
//
// Replaces: tools/perf_probe_enc.py::_encode_kernel_v (wrapper
// encode_variant), the TPU scalar-core experiments on the encode walk:
// seeding merged into the extension loop, a branch-free tail and copy tag,
// a stride-8 extension, an eight-wide probe, a wider miss advance, thinner
// table stores, a narrower hash, no emission, no walk.
//
// What bounds it: as encode.cu, the serial walk of one thread per fragment
// (a chain of dependent loads per probe group: the words at ip, the table
// slots, the candidate's words) times the waves of fragments; the bytes, 32
// MiB in and about 7 MiB out for 512 fragments, take about 12 us at 3.35
// TB/s.
//
// What the design does about it: encode.cu's layout (encode_variants.cuh:
// the match table alone in dynamic shared memory, the fragment read through
// the read-only path, one block of one warp per fragment). At the TPU
// probe's 14 hash bits the table is 32 KiB and six walks share an SM, so
// 512 fragments run in one wave on 132 SMs; at hb9 it is 1 KiB. Each named
// tuple is a kernel of its own (the mask is a template argument, so the
// walk holds only that variant's code); any other legal tuple runs the same
// walk with the mask as a run-time value. Every kernel sets its attributes
// and enqueues its launch under one lock (smem_config.cuh), so a launch at
// one hash width never runs under the carveout of another.
#include <cuda_runtime.h>
#include <stdint.h>

#include "encode_variants.cuh"

namespace {

using namespace sc;
constexpr uint32_t E3 = EV_EXT_4 | EV_XOR_TAIL | EV_BFREE_COPY;
constexpr uint32_t E6 = EV_EXT_8U | EV_POST_SEED | EV_XOR_TAIL | EV_BFREE_COPY;

// Calls op with the walk of `mask`: a StaticWalk where the mask has a name,
// else a DynWalk.
template <class Op>
int with_walk(uint32_t mask, int32_t hash_bits, int32_t store_step, Op op) {
#define SNAPPY_CASE(m) \
  case (m):            \
    return op(sc::StaticWalk<(m)>{hash_bits, store_step})
  switch (mask) {
    SNAPPY_CASE(EV_EXT_LOOP4 | EV_POST_SEED);                        // the empty tuple
    SNAPPY_CASE(EV_EXT_4);                                           // e1
    SNAPPY_CASE(EV_EXT_4 | EV_XOR_TAIL);                             // e2
    SNAPPY_CASE(E3);                                                 // e3, e9, e10, e11
    SNAPPY_CASE(E3 | EV_EMIT_HITS);                                  // e4
    SNAPPY_CASE(EV_EXT_LOOP4 | EV_POST_SEED | EV_XOR_TAIL);          // eb
    SNAPPY_CASE(EV_EXT_LOOP4 | EV_POST_SEED | EV_BFREE_COPY);        // ec
    SNAPPY_CASE(EV_EXT_LOOP4 | EV_POST_SEED | EV_XOR_TAIL | EV_BFREE_COPY);  // ebc
    SNAPPY_CASE(E6);                                                 // e6
    SNAPPY_CASE(E6 | EV_ADV4);                                       // e6a
    SNAPPY_CASE(E6 | EV_ADV4 | EV_PROBE8);                           // e7
    SNAPPY_CASE(E6 | EV_ADV4 | EV_PROBE8 | EV_EMIT_HITS);            // e7n
    SNAPPY_CASE(E6 | EV_ADV4 | EV_EMIT_HITS);                        // e6n
    SNAPPY_CASE(EV_EXT_LOOP4 | EV_POST_SEED | EV_EMIT_HITS | EV_NOSCAN);  // edma
  }
#undef SNAPPY_CASE
  return op(sc::DynWalk{mask, hash_bits, store_step});
}

}  // namespace

// mask: the EV_* bits of the walk (ops/cuda/encode_variants.py builds it
// from the flags). frags: uint8[B, frag_w], any address and width; lengths,
// body_lens: int32[B]; bodies: uint8[B, body_w] (ev::launch).
extern "C" int snappy_encode_variant_launch(uint32_t mask, int32_t hash_bits,
                                            int32_t store_step, const void* frags,
                                            int64_t frag_w, const void* lengths, int64_t batch,
                                            void* bodies, int64_t body_w, void* body_lens,
                                            void* stream) {
  return with_walk(mask, hash_bits, store_step, [&](auto cfg) {
    return ev::launch(cfg, frags, frag_w, lengths, batch,
                      ev::BodyRows{(uint8_t*)bodies, body_w, (int32_t*)body_lens}, stream);
  });
}

// The layout of the launch above for rows at frags of width frag_w
// (ev::layout: blocks per SM, shared bytes, threads, loader).
extern "C" int snappy_encode_variant_layout(const void* frags, int64_t frag_w, uint32_t mask,
                                            int32_t hash_bits, int32_t store_step,
                                            int32_t* out) {
  return with_walk(mask, hash_bits, store_step, [&](auto cfg) {
    return ev::layout<ev::BodyRows>(cfg, frags, frag_w, out);
  });
}
