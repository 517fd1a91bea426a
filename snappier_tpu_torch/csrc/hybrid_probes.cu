// The hybrid decode's micro-probes on Hopper: the primitive costs of a
// decode that walks tag boundaries on one thread and copies payloads with a
// vector of lanes. They are probes: each measures a chain of dependent
// steps, and no design of the same work beats that chain's latency. None is
// a kernel to make fast.
//
// chain: tools/perf_probe_hybrid.py::_chain_kernel (wrapper chain; with_rec
// is chainrec). The TPU walks ip += adv[ip] on the scalar core over SMEM;
// here one thread runs cliff's walk (hp::cliff_walk, below) over the
// advances staged in shared memory: chain is cliff_kernel<kChase>, the
// chase's own kernel, and chainrec cliff_kernel<kChainRec>, whose body
// stores each step's record and op, predicated on the step being live, to
// a shared buffer that the block copies out at the end (so that the stores
// are not dead code); they issue in the next load's shadow, beside the
// chain. The trials run one after another, the records in the TPU's order.
// Bound: the bytes (the advance array in, one word out, the record buffer
// out) take well under a microsecond; the latency floor is R x steps
// dependent shared-memory loads, which is what the probe times.
//
// vcopy_kernel<k3d>: _vcopy_kernel (wrapper vcopy, modes 2d and 3d). The TPU
// copies a record with VPU row operations on a VMEM image (a dynamic row
// load, lane rotates, a funnel shift, masked row stores); here one warp
// holds the 128 lanes, 4 words a lane, over the image in shared memory.
// Records form a chain through the image (a record's destination may
// overlap the next one's source), so the design keeps everything else off
// that chain (hp::record_loop, hp::vcopy_body): the lanes load 32 records
// at once, two batches ahead, and write each record's plan (its window and
// run as flat word addresses, the funnel's shift, the run's length) into a
// ring in shared memory a batch ahead; a record's plan is one broadcast
// 128-bit load, two records ahead. A record is then its shared loads (2d:
// w[q] is img[sw + q], no row select), the warp's meeting, its stores
// (predicated on the run's length, no branch) and another meeting. Bound:
// 192 KiB in and 64 KiB out, about 0.08 us; the floor is the records times
// the round trip of a shared store and the next record's dependent load.
//
// coissue_kernel<kNvec>: _coissue_kernel (wrapper coissue; nvec 0, 1, 2,
// 8; iters 8,192 as on the TPU, fewer for the tests). The TPU asks whether
// Mosaic issues the scalar unit's chain and the VPU's tile updates in the
// same bundles. The SIMT counterpart: warp 0 (one thread) runs the
// 24-operation scalar chain through a 64-word scratch in shared memory (it
// is indexed by data), the tile's 8 rows run the nvec updates a step on
// warps of their own, and the SM's schedulers interleave the warps. Nothing
// syncs them inside the loop, so the time is the longer of the two streams
// if they overlap and their sum if they do not. The design keeps the two
// apart: no tile warp shares warp 0's scheduler (the tile's warps are
// 1-3, 5-7, 9 and 10); a row lies 4 consecutive elements a lane, so that an
// update takes its rolled words from the lane's own registers and from
// lanes l - 1 and l - 2 by at most 4 shuffles and no select
// (hp::coissue_row); and a round of the chain issues its load before its
// store, on an AND of x * 5 + 1 (the scratch's words 8 bytes apart), with
// the store's aliasing folded into one LOP3 (hp::coissue_step). Bound: 8
// KiB of bytes; the floors are measured: nvec 0 is the chain alone, and
// coissue_kernel<hp::kCoissueVec> (wrapper coissue_vec, the launcher's
// nvec -1) the tile's warps at nvec 8 with no chain. The scratch starts as
// interpret mode leaves it (0x80000000, the seed at word 0) and the tile
// comes from device memory (by default 0x80000000 everywhere): on the TPU
// both hold whatever SMEM and VMEM held, and a tile that the compiler could
// see would fold away. (The TPU's result never depends on the vector work:
// 4,096 updates take any tile to 0 modulo 2^32, ops/cuda/hybrid_probes.py
// says why. The work is done all the same: nvcc cannot know it.)
//
// iso_kernel<kMode>: _iso_kernel (wrapper iso; modes scalar, dynload,
// dynload8, statroll, dynroll, full). The TPU times each part of vcopy's
// body alone: Mosaic's dynamic row load and store, an 8-row load, a roll by
// a static and by a dynamic amount, the whole body. The SIMT counterpart of
// a dynamic row load is a shared-memory load at a run-time address, which
// costs what a static one does; of a roll, a lane's load at (p - s) & 127 of
// the same row, so a static and a dynamic roll are the same instructions.
// One warp, the image in shared memory, 20 passes over the records (pass r
// from record r & 1), the image persisting across them. The row modes and
// full run vcopy's record loop (hp::iso_run): dynload and dynload8 move
// whole rows by 128-bit accesses (a row is one a lane), the rolls 4 words
// a lane, full is vcopy's 2d body. scalar touches no image and its records
// are independent: the lanes take records (hp::iso_scalar_lane), their
// loads running four groups of 256 records ahead of the chains, and the
// warp sums the lanes at the end. Bound: the record array and image in,
// the image out, about 0.08 us; the floor is 20 x the records, each a
// round trip of shared stores and the next record's loads (dynload8: 8 KiB
// through shared memory a record; scalar: issuing its chains).
//
// bprobe_kernel<kNwhen>: _bprobe_kernel (wrapper bprobe; nwhen 0, 1, 2, 3,
// 4, 8). The TPU asks what a pl.when costs on the scalar core, over a
// 64-word scratch in SMEM. Here one thread, the scratch in 64 registers:
// every index is (t + k) & 63 and the 524,288 iterations are 8,192 blocks
// of 64, so a block unrolled (hp::bprobe_block) knows each index when it
// is compiled, and each pl.when is a select of a register (PERF.md records
// what cuobjdump shows). No memory access is left on any chain. At nwhen 0
// and 2 or more, iteration t's store at k = 1 is the word t + 1 mixes, so
// the chain is the mix and a select an iteration; at nwhen 1 nothing links
// the 64 iterations of a block, and the one thread's issue bounds it.
// Bound: 260 bytes; the floor is the chain of dependent integer operations.
//
// bprobe_floor_kernel (wrapper bprobe_floor; the bprobe launcher's nwhen
// -1): bprobe's arithmetic alone, x_t = mix(x_{t-1} ^ t), no scratch, in
// the same blocks of 64 (hp::bprobe_floor): the floor measured. A
// yardstick, not a TPU kernel.
//
// cliff_kernel<kMode>: _cliff_kernel (wrapper cliff; modes when1, when2,
// fori, store4, load4). The TPU looks for the body size at which chain's
// 20 ns walk falls off a cliff. Here one thread walks, the advance array
// and the 16,384-word image both in shared memory (the image persists
// across the trials, from 0x80000000 as interpret mode leaves it). Bound:
// the advance array in and the image out, well under a microsecond; the
// floor is R x steps dependent shared-memory loads, and the design puts
// nothing else on that chain (hp::cliff_walk): the advances staged as byte
// offsets (a step is a load and an add); the next step's load issued
// before the current step's body; the body branch-free (a store it does
// not make aimed at a dummy word past the image, fori's stores
// predicated) with the op kept as a byte offset into the image; the loop's
// exit tested every 4 steps on a position known ahead of the loads in
// flight; the advance array and the image passed as disjoint
// (__restrict__) arrays, so that nvcc may move the next load above the
// body's stores. The staged copy is 0 at and past n and reaches past n by
// the largest advance below n (the wrapper computes it), so a step past
// the end keeps ip and its load stays inside. The trials run one after
// another, each store in the TPU's order. A body of more instructions than
// the load's latency holds (fori's 7 stores) is bound by the one thread's
// issue instead (PERF.md).
//
// cliff_kernel<kChase> (wrappers chase and chain): the same walk with no
// body, the floor measured: T10 chain's function (the sum of the final ip)
// on the same staged advances and trials.
#include <cuda_runtime.h>
#include <stdint.h>

#include "hybrid_probes.cuh"
#include "smem_config.cuh"

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;

// The image from device memory into shared memory (16 loads a lane in
// flight); the plan ring after it is the record loop's.
__device__ void stage_image(uint32_t* img, const int32_t* __restrict__ img_in, int lane) {
  constexpr int kUnroll = 16;
  for (int32_t i = lane; i < hp::kImageWords; i += 32 * kUnroll) {
    int32_t v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; u++) v[u] = __ldg(img_in + i + 32 * u);
#pragma unroll
    for (int u = 0; u < kUnroll; u++) img[i + 32 * u] = (uint32_t)v[u];
  }
  __syncwarp();
}

// The warp's sum of acc, into out[0], and the image back to device memory.
__device__ void finish(uint32_t acc, const uint32_t* img, int lane, int32_t* __restrict__ out,
                       int32_t* __restrict__ img_out) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(kFull, acc, o);
  if (lane == 0) out[0] = (int32_t)acc;
  for (int32_t i = lane; i < hp::kImageWords; i += 32) img_out[i] = (int32_t)img[i];
}

template <bool k3d>
__global__ void vcopy_kernel(const int32_t* __restrict__ rec, const int32_t* __restrict__ img_in,
                             int32_t* __restrict__ out, int32_t* __restrict__ img_out) {
  extern __shared__ __align__(16) uint32_t img[];
  const int lane = threadIdx.x;
  stage_image(img, img_in, lane);
  const sc::CudaWarp w;
  sc::LanesOf<sc::CudaWarp, uint32_t> acc{0u};
  hp::vcopy_run<k3d>(w, rec, img, acc);
  finish(acc.v, img, lane, out, img_out);
}

// The tile's warps: 1-3, 5-7, 9 and 10, so that none shares warp 0's
// scheduler (warp w issues from sub-partition w % 4); warps 4 and 8 only
// meet the others at the end. Warp w holds row tile_row(w).
constexpr int kCoissueWarps = 11;
__device__ constexpr int tile_row(int warp) { return warp % 4 ? warp - 1 - warp / 4 : -1; }

// kNvec 0, 1, 2, 8: coissue; hp::kCoissueVec: the tile's warps at nvec 8
// and no chain (the vector stream alone, its sum the tile's parity).
template <int kNvec>
__global__ void __launch_bounds__(kCoissueWarps * 32)
    coissue_kernel(int32_t seed, int32_t iters, const int32_t* __restrict__ tile,
                   int32_t* __restrict__ out, int32_t* __restrict__ tile_out) {
  __shared__ uint32_t scratch[hp::kScratchSlots];
  __shared__ uint32_t sums[hp::kTileRows + 1];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, row = tile_row(warp);
  if (warp == 0) {
    if (lane == 0) {
      uint32_t acc = 0;
      if (kNvec != hp::kCoissueVec) {
        hp::scratch_init(scratch, seed);
        for (uint32_t t = 0; t < (uint32_t)iters; t++) acc += hp::coissue_step(scratch, t);
      }
      sums[hp::kTileRows] = acc;
    }
  } else if (row >= 0) {
    constexpr int kUpdates = kNvec == hp::kCoissueVec ? hp::kVecUpdates : kNvec;
    const sc::CudaWarp w;
    uint32_t par = hp::coissue_row<kUpdates>(w, tile + row * hp::kLanes, iters,
                                             tile_out + row * hp::kLanes).v;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) par += __shfl_xor_sync(kFull, par, o);
    if (lane == 0) sums[row] = par;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    uint32_t total = 0;
    for (int r = 0; r <= hp::kTileRows; r++) total += sums[r];
    out[0] = (int32_t)total;
  }
}

template <int kMode>
__global__ void iso_kernel(const int32_t* __restrict__ rec, const int32_t* __restrict__ img_in,
                           int32_t* __restrict__ out, int32_t* __restrict__ img_out) {
  extern __shared__ __align__(16) uint32_t img[];
  const int lane = threadIdx.x;
  stage_image(img, img_in, lane);
  const sc::CudaWarp w;
  sc::LanesOf<sc::CudaWarp, uint32_t> acc{0u};
  hp::iso_run<kMode>(w, rec, img, acc);
#pragma unroll
  for (int k = 0; k < 4; k++) acc.v += img[lane + 32 * k] & 1u;  // row 0's odd words
  finish(acc.v, img, lane, out, img_out);
}

template <int kNwhen>
__global__ void bprobe_kernel(int32_t seed, int32_t* __restrict__ out,
                              int32_t* __restrict__ scratch_out) {
  uint32_t s[hp::kBprobeBlock];
  out[0] = (int32_t)hp::bprobe_run<kNwhen>(s, seed);
#pragma unroll
  for (int i = 0; i < hp::kBprobeBlock; i++) scratch_out[i] = (int32_t)s[i];
}

__global__ void bprobe_floor_kernel(int32_t seed, int32_t* __restrict__ out) {
  out[0] = (int32_t)hp::bprobe_floor(seed);
}

// The words after the staged advances: cliff's image and dummy, chainrec's
// record buffer, none for the chase.
template <int kMode>
constexpr int32_t kWalkTail =
    kMode == hp::kChase ? 0 : (kMode == hp::kChainRec ? hp::kRecWords : hp::kCliffImageWords);

template <int kMode>
__global__ void cliff_kernel(const int32_t* __restrict__ adv, int32_t n, int32_t staged,
                             int32_t start, int32_t R, int32_t* __restrict__ out,
                             int32_t* __restrict__ img_out) {
  extern __shared__ __align__(16) int32_t smem[];
  int32_t* adv_s = smem;
  uint32_t* img = reinterpret_cast<uint32_t*>(smem + staged);
  for (int32_t i = threadIdx.x; i < staged; i += blockDim.x) {
    adv_s[i] = hp::cliff_staged(adv, n, i);
  }
  // cliff's image from interpret mode's fill; chainrec's buffer from 0.
  for (int32_t i = threadIdx.x; i < kWalkTail<kMode>; i += blockDim.x) {
    img[i] = kMode == hp::kChainRec ? 0u : hp::kFill;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const uint32_t sum = (uint32_t)hp::cliff_walk<kMode>(adv_s, n, start, R, img);
    out[0] = (int32_t)(kMode >= hp::kChase ? sum : sum + img[0]);
  }
  static_assert(hp::kRecWords == hp::kImageWords, "chainrec's buffer is copied out as an image");
  if (kMode != hp::kChase) {
    __syncthreads();
    for (int32_t i = threadIdx.x; i < hp::kImageWords; i += blockDim.x) {
      img_out[i] = (int32_t)img[i];
    }
  }
}

// Sets the kernel's attributes for smem dynamic bytes and runs launch() (the
// launch, then cudaGetLastError) under one lock (smem_config.cuh); each
// call site keeps the kernel's own record in a static.
template <class Kernel, class Launch>
int with_smem(Kernel kernel, attrs::SetFor& set_for, size_t smem, Launch launch) {
  return (int)attrs::configure_and_launch(kernel, smem, set_for, [&] {
    launch();
    return cudaGetLastError();
  });
}

// cliff_kernel<kMode> over `staged` words of staged advances; one record
// of its attributes a mode, whichever launcher calls it (chain and the
// chase share cliff_kernel<kChase>).
template <int kMode>
int launch_walk(const void* adv, int32_t n, int32_t staged, int32_t start, int32_t R, void* out,
                void* img_out, void* stream) {
  static attrs::SetFor set_for;
  const size_t smem = ((size_t)staged + kWalkTail<kMode>) * 4;
  return with_smem(cliff_kernel<kMode>, set_for, smem, [&] {
    cliff_kernel<kMode><<<1, 256, smem, (cudaStream_t)stream>>>(
        (const int32_t*)adv, n, staged, start, R, (int32_t*)out, (int32_t*)img_out);
  });
}

}  // namespace

// adv: int32[n] and more (the walk reads adv[start:n]); staged: the words
// of its staged copy (hybrid_probes.py::cliff_staged_words); out: int32[1];
// recs: int32[16384] with with_rec, else unused.
extern "C" int probe_chain_launch(int32_t with_rec, const void* adv, int32_t n, int32_t staged,
                                  int32_t start, int32_t R, void* out, void* recs,
                                  void* stream) {
  if (with_rec) return launch_walk<hp::kChainRec>(adv, n, staged, start, R, out, recs, stream);
  return launch_walk<hp::kChase>(adv, n, staged, start, R, out, nullptr, stream);
}

// rec: int32[32768] (dst, src, len at 0, 8192, 16384; the count at 24576);
// img, img_out: int32[16384]; out: int32[1].
extern "C" int probe_vcopy_launch(int32_t mode3d, const void* rec, const void* img, void* out,
                                  void* img_out, void* stream) {
  const size_t smem = hp::kRecordSmemWords * 4;
#define PROBE_LAUNCH(M3)                                                                    \
  do {                                                                                      \
    static attrs::SetFor set_for;                                                           \
    return with_smem(vcopy_kernel<M3>, set_for, smem, [&] {                                 \
      vcopy_kernel<M3><<<1, 32, smem, (cudaStream_t)stream>>>(                              \
          (const int32_t*)rec, (const int32_t*)img, (int32_t*)out, (int32_t*)img_out);      \
    });                                                                                     \
  } while (0)
  if (mode3d) PROBE_LAUNCH(true);
  PROBE_LAUNCH(false);
#undef PROBE_LAUNCH
}

// tile, tile_out: int32[8, 128]; out: int32[1]; nvec 0, 1, 2, 8, or -1
// (hp::kCoissueVec) for the vector stream alone (seed unused).
extern "C" int probe_coissue_launch(int32_t nvec, int32_t seed, int32_t iters, const void* tile,
                                    void* out, void* tile_out, void* stream) {
#define PROBE_CASE(N)                                                                      \
  case N:                                                                                  \
    coissue_kernel<N><<<1, kCoissueWarps * 32, 0, (cudaStream_t)stream>>>(                 \
        seed, iters, (const int32_t*)tile, (int32_t*)out, (int32_t*)tile_out);             \
    break
  switch (nvec) {
    PROBE_CASE(hp::kCoissueVec);
    PROBE_CASE(0);
    PROBE_CASE(1);
    PROBE_CASE(2);
    PROBE_CASE(8);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef PROBE_CASE
  return (int)cudaGetLastError();
}

// rec: int32[32768] (dst, src, len at 0, 8192, 16384; the count at 24576);
// img, img_out: int32[16384]; out: int32[1]; mode: hp::IsoMode.
extern "C" int probe_iso_launch(int32_t mode, const void* rec, const void* img, void* out,
                                void* img_out, void* stream) {
  const size_t smem = hp::kRecordSmemWords * 4;
#define PROBE_CASE(M)                                                                        \
  case M: {                                                                                  \
    static attrs::SetFor set_for;                                                            \
    return with_smem(iso_kernel<M>, set_for, smem, [&] {                                     \
      iso_kernel<M><<<1, 32, smem, (cudaStream_t)stream>>>(                                  \
          (const int32_t*)rec, (const int32_t*)img, (int32_t*)out, (int32_t*)img_out);       \
    });                                                                                      \
  }
  switch (mode) {
    PROBE_CASE(hp::kIsoScalar)
    PROBE_CASE(hp::kIsoDynload)
    PROBE_CASE(hp::kIsoDynload8)
    PROBE_CASE(hp::kIsoStatroll)
    PROBE_CASE(hp::kIsoDynroll)
    PROBE_CASE(hp::kIsoFull)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef PROBE_CASE
}

// out: int32[1]; scratch_out: int32[64] (unused by the floor, nwhen -1).
extern "C" int probe_bprobe_launch(int32_t nwhen, int32_t seed, void* out, void* scratch_out,
                                   void* stream) {
#define PROBE_CASE(N)                                                                        \
  case N:                                                                                    \
    bprobe_kernel<N><<<1, 1, 0, (cudaStream_t)stream>>>(seed, (int32_t*)out,                 \
                                                        (int32_t*)scratch_out);              \
    break;
  switch (nwhen) {
    case hp::kBprobeFloor:
      bprobe_floor_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(seed, (int32_t*)out);
      break;
    PROBE_CASE(0)
    PROBE_CASE(1)
    PROBE_CASE(2)
    PROBE_CASE(3)
    PROBE_CASE(4)
    PROBE_CASE(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef PROBE_CASE
  return (int)cudaGetLastError();
}

// adv: int32[n] and more (the walk reads adv[start:n]); staged: the words
// of its staged copy (hybrid_probes.py::cliff_staged_words); out: int32[1]; img_out:
// int32[16384]; mode: hp::CliffMode, kChase and kChainRec excluded.
extern "C" int probe_cliff_launch(int32_t mode, const void* adv, int32_t n, int32_t staged,
                                  int32_t start, int32_t R, void* out, void* img_out,
                                  void* stream) {
#define PROBE_CASE(M) \
  case M:             \
    return launch_walk<M>(adv, n, staged, start, R, out, img_out, stream);
  switch (mode) {
    PROBE_CASE(hp::kCliffWhen1)
    PROBE_CASE(hp::kCliffWhen2)
    PROBE_CASE(hp::kCliffFori)
    PROBE_CASE(hp::kCliffStore4)
    PROBE_CASE(hp::kCliffLoad4)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef PROBE_CASE
}

// The chase: cliff's walk with no body over the same staged copy (chain's
// kernel); out: int32[1], the sum of the trials' final ip.
extern "C" int probe_chase_launch(const void* adv, int32_t n, int32_t staged, int32_t start,
                                  int32_t R, void* out, void* stream) {
  return launch_walk<hp::kChase>(adv, n, staged, start, R, out, nullptr, stream);
}
