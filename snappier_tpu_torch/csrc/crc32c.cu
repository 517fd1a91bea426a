// Batched CRC32C (Castagnoli) of each row's first lengths[b] bytes.
//
// Replaces: snappier_tpu/ops/pallas/crc32c.py::_crc_kernel (wrapper
// crc32c_blocks), the TPU VPU contraction against the per-distance table.
//
// What bounds it: device memory. Each row is read once (64 KiB) and one word
// is written, so 512 rows take at least 32 MiB / 3.35 TB/s, about 10 us.
// Next come the table look-ups, one a byte: a warp's look-up costs one
// shared-memory wavefront only if its 32 lanes hit 32 banks, an SM issues
// fewer than one such look-up a cycle, and a row's 64 KiB take 2,560 warp
// look-ups with the folds; a look-up waits some 30 cycles, and a chunk's are
// four steps in a chain.
//
// What the design does about it (the row math is crc32c.cuh): a block of 8
// warps takes a row, warp w its lines w, w + 8, ..., lanes on 16-byte chunks,
// which cp.async copies into a ring of four batches a warp, three in flight
// while the fourth is folded; a lane runs its batch's 8 chunks side by side;
// the look-up tables are spread so that every look-up of the inner loop is
// one wavefront; lanes and then warps combine through fixed 32 x 32 shift
// matrices and XOR shuffles, and the warps meet only every 64 rows. Blocks
// are persistent, one an SM, take rows k, k + grid, ... and fill their
// 69 KiB of tables and row lengths once a launch. Bytes past lengths[b] are
// never read.
#include <cuda_runtime.h>
#include <stdint.h>

#include "crc32c.cuh"
#include "smem_config.cuh"

namespace {

constexpr int kThreads = crc::kWarps * 32;
constexpr size_t kSmemBytes = crc::kSmemWords * sizeof(uint32_t);

// The block's barrier, for the warps' combine of their rows.
struct BlockSync {
  SC_HD void operator()() const {
#ifdef __CUDA_ARCH__
    __syncthreads();
#endif
  }
};

__global__ void __launch_bounds__(kThreads, 1)
    crc32c_kernel(const uint8_t* __restrict__ rows, int64_t width,
                  const int32_t* __restrict__ lengths, int64_t batch,
                  const uint32_t* __restrict__ tables, int32_t* __restrict__ out) {
  extern __shared__ __align__(16) uint32_t smem[];
  crc::fill_shared(smem, tables, lengths, batch, blockIdx.x, gridDim.x, threadIdx.x, kThreads);
  __syncthreads();
  const sc::CudaWarp w{};
  const sc::LanesOf<sc::CudaWarp, crc::Tables> t{
      crc::lane_tables(smem, tables, threadIdx.x & 31)};
  crc::crc_rows(w, (int)(threadIdx.x >> 5), t, smem, BlockSync{}, rows, width, lengths, batch,
                blockIdx.x, gridDim.x, out);
}

// The kernel's attributes, set per device (smem_config.cuh).
attrs::SetFor set_for;

// Runs fn with the kernel's shared-memory attributes set on the current
// device, under the lock that orders them with its launches.
template <class Fn>
cudaError_t configured(Fn fn) {
  return attrs::configure_and_launch(crc32c_kernel, kSmemBytes, set_for, fn);
}

// The persistent blocks of a launch on the current device: one an SM.
cudaError_t sm_count(int* n) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  return e == cudaSuccess ? cudaDeviceGetAttribute(n, cudaDevAttrMultiProcessorCount, dev) : e;
}

}  // namespace

// rows: uint8[B, width], any address and width; lengths, out: int32[B];
// tables: uint32[crc::kTableWords] (ops/cuda/crc32c.py::kernel_tables).
extern "C" int crc32c_launch(const void* rows, int64_t width, const void* lengths,
                             int64_t batch, const void* tables, void* out, void* stream) {
  if (batch == 0) return 0;
  int sms = 0;
  cudaError_t e = sm_count(&sms);
  if (e != cudaSuccess) return (int)e;
  const unsigned grid = (unsigned)(batch < sms ? batch : sms);
  return (int)configured([&] {
    crc32c_kernel<<<grid, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
        (const uint8_t*)rows, width, (const int32_t*)lengths, batch, (const uint32_t*)tables,
        (int32_t*)out);
    return cudaGetLastError();
  });
}

// The launch's layout on the current device: out[0] blocks per SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor under the attributes the
// launch sets), out[1] shared bytes per block (dynamic and static), out[2]
// threads per block, out[3] the persistent blocks of a launch of that many
// rows or more (one an SM).
extern "C" int crc32c_layout(int32_t* out) {
  int nb = 0, sms = 0;
  cudaFuncAttributes attr;
  cudaError_t e = configured([&] {
    cudaError_t q = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, crc32c_kernel, kThreads,
                                                                  kSmemBytes);
    return q == cudaSuccess ? cudaFuncGetAttributes(&attr, crc32c_kernel) : q;
  });
  if (e == cudaSuccess) e = sm_count(&sms);
  out[0] = nb;
  out[1] = e == cudaSuccess ? (int32_t)(kSmemBytes + attr.sharedSizeBytes) : 0;
  out[2] = kThreads;
  out[3] = sms;
  return (int)e;
}
