// Stream compaction: the ascending indices of the True slots of a mask,
// and (optionally) a per-32-slot rank table.
//
// Replaces: sdf_tpu/core/compact.py `_rowpack_kernel` (launched by
// `_rowpack` under `indices_of_pallas`) and `_rowpack_ranks_bytes_kernel`
// (launched in `indices_and_ranktable_of`).  The TPU kernels pack each
// 128-lane row with a barrel shifter because lanes cannot scatter; a warp
// ballot gives the same ranks directly.
//
// Bound on the card: memory traffic -- the mask is read twice (1 byte per
// slot per pass), each True slot's index is written once (4 bytes) and the
// table is 8 bytes per 32 slots -- against 3.35 TB/s.
//
// Design, one for both kernels:
//   * pass 1 (`count`): each block of 1024 slots ballots its 32 warps and
//     writes its True count (`__ballot_sync` + `__popc`).
//   * block offsets: an exclusive scan of the per-block counts, done by the
//     wrapper with torch.cumsum (the JAX package does the same row-offset
//     cumsum in XLA, outside its kernel); the last inclusive entry is the
//     total, which stays on the device.
//   * pass 2 (`scatter`): each block ballots again, scans its 32 warp counts
//     in shared memory, and every True slot writes its global index at
//     offset + rank, so the output is ascending by construction; slots past
//     `capacity` are dropped and the output's tail keeps its zeros.  With a
//     table pointer, lane 0 of each warp also writes its group's
//     (exclusive offset, ballot word) pair, the interleaved layout of
//     compact._interleave_table.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BLOCK = 1024;  // slots (= threads) per block, 32 warps
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(BLOCK)
count_kernel(const uint8_t* __restrict__ mask, int64_t n,
             int32_t* __restrict__ counts) {
  __shared__ int wc[32];
  const int64_t i = (int64_t)blockIdx.x * BLOCK + threadIdx.x;
  const bool m = i < n && mask[i] != 0;
  const unsigned w = __ballot_sync(FULL, m);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) wc[warp] = __popc(w);
  __syncthreads();
  if (warp == 0) {
    int c = wc[lane];
    for (int off = 16; off > 0; off >>= 1) c += __shfl_down_sync(FULL, c, off);
    if (lane == 0) counts[blockIdx.x] = c;
  }
}

__global__ void __launch_bounds__(BLOCK)
scatter_kernel(const uint8_t* __restrict__ mask, int64_t n,
               const int32_t* __restrict__ block_excl,
               int32_t* __restrict__ out, int64_t capacity,
               int32_t* __restrict__ table) {
  __shared__ int wc[32];
  const int64_t i = (int64_t)blockIdx.x * BLOCK + threadIdx.x;
  const bool m = i < n && mask[i] != 0;
  const unsigned w = __ballot_sync(FULL, m);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) wc[warp] = __popc(w);
  __syncthreads();
  if (warp == 0) {
    const int v = wc[lane];
    int incl = v;
    for (int off = 1; off < 32; off <<= 1) {
      const int t = __shfl_up_sync(FULL, incl, off);
      if (lane >= off) incl += t;
    }
    wc[lane] = incl - v;
  }
  __syncthreads();
  const int base = block_excl[blockIdx.x] + wc[warp];
  if (table != nullptr && lane == 0 && i < n) {
    const int64_t g = i >> 5;
    table[2 * g] = base;
    table[2 * g + 1] = (int32_t)w;
  }
  if (m) {
    const int r = base + __popc(w & ((1u << lane) - 1u));
    if (r < capacity) out[r] = (int32_t)i;
  }
}

}  // namespace

extern "C" int sdf_compact_count(const void* mask, int64_t n, void* counts,
                                 void* stream) {
  const int64_t blocks = (n + BLOCK - 1) / BLOCK;
  count_kernel<<<(unsigned)blocks, BLOCK, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)mask, n, (int32_t*)counts);
  return (int)cudaGetLastError();
}

extern "C" int sdf_compact_scatter(const void* mask, int64_t n,
                                   const void* block_excl, void* out,
                                   int64_t capacity, void* table,
                                   void* stream) {
  const int64_t blocks = (n + BLOCK - 1) / BLOCK;
  scatter_kernel<<<(unsigned)blocks, BLOCK, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)mask, n, (const int32_t*)block_excl, (int32_t*)out,
      capacity, (int32_t*)table);
  return (int)cudaGetLastError();
}
