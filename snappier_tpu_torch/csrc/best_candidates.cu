// The candidate search of level="best" (ops/best_match.py::exact_candidates)
// in one launch: for each row, every width's fingerprints, a stable radix
// sort of each width's keys, each position's nearest previous equal key and
// the widest-wins merge, with the row on chip from its bytes in to its
// candidates out.
//
// It replaces no Pallas kernel: the JAX package leaves its sorts to XLA
// (snappier_tpu/ops/best_match.py, lax.sort), and the port's plain version
// is tensor code (a library sort, a scatter and an int64 elementwise chain a
// width).
//
// What bounds it: each row's bytes in and its int32 candidates out, 32 MiB
// and 128 MiB for 512 rows of 64 KiB, 0.05 ms at 3.35 TB/s. The work between
// is a grouping of 65,536 positions a row and width, six widths by default:
// bound by shared-memory traffic, the warps' ranking and the CTAs'
// barriers, not by device memory.
//
// What the design does about it: nothing of a row goes to device memory
// between its bytes and its candidates. One thread-block cluster of up to
// bc::kMaxCtas CTAs holds a row of up to 65,536 positions (bc::kSlots a CTA,
// 1,024 threads of 8 elements), its fingerprints, its sort buffer (64-bit
// key and 16-bit position) and its candidates in shared memory (bc::kSmem
// a CTA). Each width's keys are sorted by a 16-bit bucket in two LSD radix
// passes, the elements in registers between passes: a warp ranks its
// elements by ballots, a CTA scans its warps' counts and stages its
// elements in the pass's order, the CTAs read each other's counts through
// distributed shared memory, and each thread gathers the elements of its
// slots from the CTA that staged them, a warp's reads runs of neighbouring
// words. Each element then walks back over its bucket, a run of equal keys
// a step, to its nearest previous equal key; the candidate goes into the
// candidate array of the CTA that holds the position, where a wider width
// overwrites it. A row whose walk runs long sorts that width by the whole
// key instead (bc::kWalk). Widths that no position of a row can take are
// skipped. The schedule is bc::run_row in best_candidates.cuh.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "best_candidates.cuh"
#include "smem_config.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr uint32_t kFull = 0xFFFFFFFFu;

// A warp as bc's warp phases see it: one lane's value in each Lanes.
struct DeviceWarp {
  template <class T>
  struct Lanes {
    T v;
    BC_HD T& operator[](int) { return v; }
    BC_HD const T& operator[](int) const { return v; }
  };
  template <class F>
  BC_HD void each(F f) const {
#ifdef __CUDA_ARCH__
    f((int)(threadIdx.x & 31u));
#endif
  }
  // The lanes whose value equals this lane's, for values below 2^bits (8 or
  // 9): a ballot a bit (MATCH.ANY, __match_any_sync, took about 60 cycles a
  // warp instruction on an H100, serialized across the SM).
  BC_HD Lanes<uint32_t> match_any(const Lanes<uint32_t>& d, int bits) const {
#ifdef __CUDA_ARCH__
    uint32_t peers = kFull;
#pragma unroll
    for (int b = 0; b < 9; b++) {
      if (b == bits) break;
      const bool bit = (d.v >> b) & 1u;
      const uint32_t m = __ballot_sync(kFull, bit);
      peers &= bit ? m : ~m;
    }
    return {peers};
#else
    return d;
#endif
  }
  // Each lane's exclusive prefix sum over the lanes below it.
  BC_HD Lanes<uint32_t> excl_scan(const Lanes<uint32_t>& x) const {
#ifdef __CUDA_ARCH__
    const int l = (int)(threadIdx.x & 31u);
    uint32_t s = x.v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t y = __shfl_up_sync(kFull, s, o);
      s += l >= o ? y : 0u;
    }
    return {s - x.v};
#else
    return x;
#endif
  }
  // Lane l gets lane l - 1's x (lane 0 its own).
  template <class T>
  BC_HD Lanes<T> up(const Lanes<T>& x) const {
#ifdef __CUDA_ARCH__
    return {__shfl_up_sync(kFull, x.v, 1)};
#else
    return x;
#endif
  }
  // x of one lane, on every lane.
  template <class T>
  BC_HD T at(const Lanes<T>& x, int lane) const {
#ifdef __CUDA_ARCH__
    return __shfl_sync(kFull, x.v, lane);
#else
    return x.v;
#endif
  }
  // Each lane's maximum over the lanes below it (0 on lane 0).
  BC_HD Lanes<uint32_t> excl_max(const Lanes<uint32_t>& x) const {
#ifdef __CUDA_ARCH__
    const int l = (int)(threadIdx.x & 31u);
    uint32_t s = x.v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t y = __shfl_up_sync(kFull, s, o);
      s = l >= o && y > s ? y : s;
    }
    const uint32_t e = __shfl_up_sync(kFull, s, 1);
    return {l == 0 ? 0u : e};
#else
    return x;
#endif
  }
  BC_HD void sync() const {
#ifdef __CUDA_ARCH__
    __syncwarp();
#endif
  }
};

// bc's runner on the card: this thread's phase, its CTA's shared memory, the
// cluster's barrier and distributed shared memory.
struct DeviceRunner {
  bc::Cta m;
  int32_t c, t;
  bc::ThreadState st;
  BC_HD bc::Cta cta(int32_t) const { return m; }
  // Word j of array p in CTA `rank`'s shared memory: read, written.
  template <class T>
  BC_HD T get(const T* p, int32_t rank, int32_t j) const {
#ifdef __CUDA_ARCH__
    const uint32_t a = remote(p + j, rank);
    if constexpr (sizeof(T) == 8) {
      uint64_t v;
      asm volatile("ld.shared::cluster.u64 %0, [%1];" : "=l"(v) : "r"(a) : "memory");
      return (T)v;
    } else if constexpr (sizeof(T) == 4) {
      uint32_t v;
      asm volatile("ld.shared::cluster.u32 %0, [%1];" : "=r"(v) : "r"(a) : "memory");
      return (T)v;
    } else {
      uint16_t v;
      asm volatile("ld.shared::cluster.u16 %0, [%1];" : "=h"(v) : "r"(a) : "memory");
      return (T)v;
    }
#else
    return p[j];
#endif
  }
  BC_HD void put(int32_t* p, int32_t rank, int32_t j, int32_t v) const {
#ifdef __CUDA_ARCH__
    asm volatile("st.shared::cluster.u32 [%0], %1;" ::"r"(remote(p + j, rank)), "r"(v) : "memory");
#else
    p[j] = v;
#endif
  }
  // The address of p in CTA `rank`'s shared memory, in the cluster's window.
  BC_HD static uint32_t remote(const void* p, int32_t rank) {
#ifdef __CUDA_ARCH__
    uint32_t a;
    asm("mapa.shared::cluster.u32 %0, %1, %2;"
        : "=r"(a)
        : "r"((uint32_t)__cvta_generic_to_shared(p)), "r"(rank));
    return a;
#else
    return 0;
#endif
  }
  template <class F>
  BC_HD void threads(F f) {
    f(c, t, st);
  }
  template <class F>
  BC_HD void warps(F f) {
    f(c, t >> 5, DeviceWarp{}, [this](int) -> bc::ThreadState& { return st; });
  }
  template <class F>
  BC_HD void warp0(F f) {
    if (t < 32) f(c, DeviceWarp{});
  }
  BC_HD void cta_sync() {
#ifdef __CUDA_ARCH__
    __syncthreads();
#endif
  }
  BC_HD void cluster_sync() {
#ifdef __CUDA_ARCH__
    cg::this_cluster().sync();
#endif
  }
  // The cluster barrier's halves: arrive releases this thread's accesses,
  // wait acquires every thread's that arrived.
  BC_HD void cluster_arrive() {
#ifdef __CUDA_ARCH__
    asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
#endif
  }
  BC_HD void cluster_wait() {
#ifdef __CUDA_ARCH__
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
#endif
  }
};

// One cluster a row: block b * n + c is CTA c of row b.
__global__ void __launch_bounds__(bc::kThreads, 1)
    best_candidates_kernel(const uint8_t* __restrict__ frags, int32_t F,
                           const int32_t* __restrict__ lengths, uint32_t mask,
                           int32_t* __restrict__ out, int32_t* fallbacks) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int32_t n = (int32_t)cluster.num_blocks();
  const int32_t b = (int32_t)(blockIdx.x / (uint32_t)n);
  const int32_t len = lengths[b] < 0 ? 0 : lengths[b];
  const bc::Row row{frags + (size_t)b * F, F, len, bc::row_mask(mask, len), n,
                    out + (size_t)b * F, fallbacks};
  DeviceRunner r{bc::cta_at(smem), (int32_t)cluster.block_rank(), (int32_t)threadIdx.x, {}};
  bc::run_row(r, row);
}

attrs::SetFor set_for;

cudaLaunchConfig_t launch_config(int32_t n, int64_t B, cudaStream_t stream,
                                 cudaLaunchAttribute* cluster) {
  cluster->id = cudaLaunchAttributeClusterDimension;
  cluster->val.clusterDim.x = (unsigned)n;
  cluster->val.clusterDim.y = 1;
  cluster->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(B * n), 1, 1);
  cfg.blockDim = dim3(bc::kThreads, 1, 1);
  cfg.dynamicSmemBytes = bc::kSmem;
  cfg.stream = stream;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

// frags: uint8 [B, F] rows (any address), 0 < F <= 65,536; lengths: int32
// [B] (below 0 taken as 0); mask: the ladder, bit k for width 2^k (k <= 30);
// out: int32 [B, F] candidates, -1 for none; fallbacks: an int32 that each
// width a row sorts whole adds 1 to, or null.
extern "C" int best_candidates_launch(const void* frags, int64_t F, const void* lengths,
                                      int64_t B, uint32_t mask, void* out, void* fallbacks,
                                      void* stream) {
  if (F <= 0 || F > bc::kMaxWidth || B < 0) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const int32_t n = bc::cta_count((int32_t)F);
  return (int)attrs::configure_and_launch(best_candidates_kernel, bc::kSmem, set_for, [&] {
    cudaLaunchAttribute cluster;
    const cudaLaunchConfig_t cfg = launch_config(n, B, (cudaStream_t)stream, &cluster);
    const cudaError_t e =
        cudaLaunchKernelEx(&cfg, best_candidates_kernel, (const uint8_t*)frags, (int32_t)F,
                           (const int32_t*)lengths, mask, (int32_t*)out, (int32_t*)fallbacks);
    return e != cudaSuccess ? e : cudaGetLastError();
  });
}

// The launch's layout for rows of width F on the current device: out[0] the
// CTAs a cluster (a row), out[1] dynamic shared bytes a CTA, out[2] threads
// a CTA, out[3] the clusters the card holds at once
// (cudaOccupancyMaxActiveClusters under the attributes the launch sets).
extern "C" int best_candidates_layout(int64_t F, int32_t* out) {
  if (F <= 0 || F > bc::kMaxWidth) return (int)cudaErrorInvalidValue;
  const int32_t n = bc::cta_count((int32_t)F);
  return (int)attrs::configure_and_launch(best_candidates_kernel, bc::kSmem, set_for, [&] {
    cudaLaunchAttribute cluster;
    const cudaLaunchConfig_t cfg = launch_config(n, 1, 0, &cluster);
    int clusters = 0;
    const cudaError_t e =
        cudaOccupancyMaxActiveClusters(&clusters, best_candidates_kernel, &cfg);
    out[0] = n;
    out[1] = (int32_t)bc::kSmem;
    out[2] = bc::kThreads;
    out[3] = clusters;
    return e;
  });
}
