// Batched CRC32C (Castagnoli) of each row's first lengths[b] bytes.
//
// Replaces: snappier_tpu/ops/pallas/crc32c.py::_crc_kernel (wrapper
// crc32c_blocks), the TPU VPU contraction against the per-distance table.
//
// What bounds it: device memory. Each row is read once (64 KiB) and one word
// is written, so 512 rows take at least 32 MiB / 3.35 TB/s, about 10 us.
// The byte-table recurrence is serial within a run of bytes, so a block
// must split its row into many short runs to hide the lookup latency.
//
// What the design does about it: one block of 256 threads per row. Each
// thread runs the table recurrence from a zero state over its own
// contiguous run (<= 256 bytes of a 64 KiB row), then shifts its partial CRC
// past the bytes that follow its run with the GF(2) zero-shift matrices
// (format/crc32c.py::shift_matrices); the shifted partials XOR together to
// the row's linear part, and the affine term crc(0^n) finishes it. Bytes past
// lengths[b] are never read.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// Advance a raw (zero-init) CRC state by nbytes zero bytes.
__device__ uint32_t shift_zeros(uint32_t s, uint32_t nbytes, const uint32_t* mats) {
  for (int k = 0; nbytes != 0; k++, nbytes >>= 1) {
    if (nbytes & 1u) {
      uint32_t r = 0;
      const uint32_t* m = mats + 32 * k;
      for (int i = 0; i < 32; i++) r ^= m[i] & (0u - ((s >> i) & 1u));
      s = r;
    }
  }
  return s;
}

__global__ void crc32c_kernel(const uint8_t* __restrict__ rows, int64_t width,
                              const int32_t* __restrict__ lengths,
                              const uint32_t* __restrict__ tables,
                              int32_t* __restrict__ out) {
  __shared__ uint32_t t[256];
  __shared__ uint32_t mats[32 * 32];
  __shared__ uint32_t partial[kThreads / 32];
  for (int i = threadIdx.x; i < 256; i += blockDim.x) t[i] = tables[i];
  for (int i = threadIdx.x; i < 32 * 32; i += blockDim.x) mats[i] = tables[256 + i];
  __syncthreads();

  const int64_t b = blockIdx.x;
  int64_t n = lengths[b];
  n = n < 0 ? 0 : (n > width ? width : n);
  const uint8_t* row = rows + b * width;
  // Runs are a multiple of 16 bytes long, so with a 16-byte aligned row
  // every whole group in a run is an aligned uint4 load.
  int64_t run = ((n + kThreads - 1) / kThreads + 15) & ~int64_t(15);
  int64_t lo = threadIdx.x * run;
  int64_t hi = lo + run < n ? lo + run : n;
  uint32_t s = 0;
  if (lo < hi) {
    int64_t i = lo;
    if ((reinterpret_cast<uintptr_t>(row) & 15) == 0) {
      for (; i + 16 <= hi; i += 16) {
        uint4 v = *reinterpret_cast<const uint4*>(row + i);
        uint32_t w[4] = {v.x, v.y, v.z, v.w};
        for (int k = 0; k < 4; k++) {
          for (int j = 0; j < 4; j++) {
            s = (s >> 8) ^ t[(s ^ (w[k] >> (8 * j))) & 0xFFu];
          }
        }
      }
    }
    for (; i < hi; i++) s = (s >> 8) ^ t[(s ^ row[i]) & 0xFFu];
    s = shift_zeros(s, (uint32_t)(n - hi), mats);
  }
  for (int o = 16; o > 0; o >>= 1) s ^= __shfl_xor_sync(0xFFFFFFFFu, s, o);
  if ((threadIdx.x & 31) == 0) partial[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    uint32_t lin = 0;
    for (int w = 0; w < kThreads / 32; w++) lin ^= partial[w];
    // crc(M) = linear part ^ crc(0^n), and crc(0^n) = shift(~0, n) ^ ~0.
    uint32_t z = shift_zeros(0xFFFFFFFFu, (uint32_t)n, mats) ^ 0xFFFFFFFFu;
    out[b] = (int32_t)(lin ^ z);
  }
}

}  // namespace

// rows: uint8[B, width]; lengths, out: int32[B];
// tables: uint32[256 + 32 * 32] (byte table, then the zero-shift matrices).
extern "C" int crc32c_launch(const void* rows, int64_t width, const void* lengths,
                             int64_t batch, const void* tables, void* out, void* stream) {
  if (batch == 0) return 0;
  crc32c_kernel<<<(unsigned)batch, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)rows, width, (const int32_t*)lengths, (const uint32_t*)tables,
      (int32_t*)out);
  return (int)cudaGetLastError();
}
