// Stream compaction: the ascending indices of the True slots of a mask
// (kernel B4), and the same with a per-32-slot rank table (kernel B5).
//
// Replaces: sdf_tpu/core/compact.py `_rowpack_kernel` (launched by
// `_rowpack` under `indices_of_pallas`) and `_rowpack_ranks_bytes_kernel`
// (launched in `indices_and_ranktable_of`).  The TPU kernels pack each
// 128-lane row with a barrel shifter because lanes cannot scatter; on the
// card a thread writes its own slots' indices at their ranks.
//
// Bound on the card: memory traffic -- the mask read once (1 byte a slot),
// each kept index written once (4 bytes a True slot, and the zero tail of
// the output up to capacity) and, for B5, the table (8 bytes a 32-slot
// group) -- against 3.35 TB/s.  A few MB: a kernel of a few microseconds,
// whose time is latency (one read of the mask, the chain of chunk
// prefixes, the scatter) unless every launch keeps enough bytes in flight.
//
// B4, `indices_kernel`: one launch, one read of the mask, a single-pass
// scan with decoupled look-back (Merrill & Garland, "Single-pass Parallel
// Prefix Scan with Decoupled Look-back", NVIDIA 2016).
//   * Chunks of IDX_CHUNK = 16,384 slots.  A block takes its chunk from an
//     atomic ticket, not from blockIdx: blocks start in no order, and a
//     look-back waiting on a predecessor that never started would hang.
//   * Each thread loads one 16-byte granule in each of IDX_ROWS rows of the
//     chunk (warps read consecutive 512-byte runs).  The slots are counted
//     in registers, then scanned per warp (__shfl_up_sync) and across the
//     block's 8 warps x IDX_ROWS rows in shared memory by one warp.
//   * The granules are those of the 16-byte aligned address space that
//     holds the mask: slot i is virtual slot i + off, off = the mask's
//     address mod 16.  A granule wholly inside the mask is one vector load;
//     the (at most two) granules that straddle its ends are read byte by
//     byte, so nothing outside the mask is read, at any alignment.
//   * Look-back: each chunk publishes (flag, aggregate) and then (flag,
//     inclusive prefix) in one 64-bit status word.  Warp 0 reads 32
//     predecessors' words at a time, waiting on any not yet published,
//     sums aggregates back to the nearest inclusive prefix, and publishes
//     its own.  The status words and the ticket are one per-call scratch
//     buffer that the entry point zeroes with one cudaMemsetAsync on the
//     stream before the launch (8 bytes a chunk).
//   * Every True slot writes its index at prefix + rank, so the output is
//     ascending by construction; ranks past `capacity` are dropped.  The
//     last chunk writes the count.
//   * Blocks drawing tickets past the last chunk zero the output's tail
//     [count, capacity): they wait for the last chunk's prefix (every chunk
//     has started by then, so the wait ends), then fill the tail with a
//     grid stride.  Every output word is written exactly once.
//
// B5, the same kernel instantiated with TABLE: the same launch, the same one
// read of the mask, and beside the indices the rank table that
// compact.rank_lookup reads, the interleaved int32 pairs [offset(g),
// word(g)] of each 32-slot group g of the mask (compact._ranktable_plain's
// layout): the count of True slots before the group, and the group's
// True slots as the bits of one word.
//   * A lane holds 16 slots (a granule), not one, so the word is not one
//     ballot: the lane that holds the group's first granule takes the next
//     two lanes' granule bits with two shuffles and funnel-shifts the
//     three by `off` (a group starts `off` slots into its first granule of
//     the aligned space).  Lane 30's third granule is the first of the next
//     warp, row or chunk, which it reads again from the mask.
//   * The offset is the chunk's exclusive prefix plus the in-chunk prefix
//     at the granule (both there already for the scatter) plus the True
//     slots of the granule before the group's first.
//   * Bits past the end of the mask are 0, so the last group of a mask
//     whose length is not a multiple of 32 has only its valid bits set.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;

// --- B4 -----------------------------------------------------------------------

constexpr int IDX_THREADS = 256;  // 8 warps
constexpr int IDX_WARPS = IDX_THREADS / 32;
constexpr int IDX_ROWS = 4;  // granules per thread, one in each row
constexpr int IDX_CHUNK = IDX_THREADS * IDX_ROWS * 16;  // slots per chunk
constexpr unsigned FLAG_AGGREGATE = 1u, FLAG_PREFIX = 2u;

// A status word: the flag in the high half, the value in the low half; 0
// (the memset) is not yet published.
__device__ __forceinline__ unsigned long long status_word(unsigned flag,
                                                          unsigned value) {
  return ((unsigned long long)flag << 32) | value;
}

__device__ __forceinline__ unsigned status_flag(unsigned long long w) {
  return (unsigned)(w >> 32);
}

__device__ __forceinline__ unsigned long long load_status(
    const unsigned long long* p) {
  return *(const volatile unsigned long long*)p;
}

__device__ __forceinline__ void store_status(unsigned long long* p,
                                             unsigned long long w) {
  *(volatile unsigned long long*)p = w;
}

// Bit k set iff byte k of the 16-byte granule `g` is nonzero.  __vcmpne4
// sets a byte to 0xff where it differs from 0; the multiply moves bits 7,
// 15, 23, 31 to bits 28-31 (the partial products land on distinct bits, so
// nothing carries into them).
__device__ __forceinline__ unsigned granule_bits(uint4 g) {
  const unsigned w[4] = {g.x, g.y, g.z, g.w};
  unsigned bits = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const unsigned hi = __vcmpne4(w[j], 0u) & 0x80808080u;
    bits |= ((hi * 0x00204081u) >> 28) << (4 * j);
  }
  return bits;
}

// The True bits of the granule starting at virtual slot v (mask slot
// v - off), reading no byte outside the mask's n slots.
__device__ __forceinline__ unsigned load_granule(const uint8_t* __restrict__ mask,
                                                 int64_t n, int off,
                                                 int64_t v) {
  const int64_t i = v - off;
  if (i >= 0 && i + 16 <= n) {
    return granule_bits(__ldg(reinterpret_cast<const uint4*>(mask + i)));
  }
  unsigned bits = 0;
  if (i + 16 > 0 && i < n) {
    for (int b = 0; b < 16; ++b) {
      if (i + b >= 0 && i + b < n && mask[i + b] != 0) bits |= 1u << b;
    }
  }
  return bits;
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// Warp 0 of chunk c (c > 0): the sum of all earlier chunks' slots, from
// their status words.  Publishes nothing.
__device__ __forceinline__ int look_back(const unsigned long long* status,
                                         int c, int lane) {
  int acc = 0;
  for (int j = c - 1 - lane;; j -= 32) {
    unsigned long long w = 0;
    unsigned flag = FLAG_PREFIX;  // before chunk 0: a prefix of 0
    if (j >= 0) {
      do {
        w = load_status(status + j);
        flag = status_flag(w);
      } while (flag == 0);
    }
    const unsigned prefix = __ballot_sync(FULL, flag == FLAG_PREFIX);
    const int v = (int)(unsigned)w;
    if (prefix) {
      // lane k reads chunk c-1-k: the nearest prefix is the lowest lane
      const int first = __ffs(prefix) - 1;
      return acc + warp_sum(lane <= first ? v : 0);
    }
    acc += warp_sum(v);
  }
}

// The table pair of 32-slot group g = j / 2, written by the lane that holds
// its first granule j (even): group g is mask slots [32g, 32g + 32), which
// are virtual slots [16j + off, 16j + off + 32): bits off..15 of granule j,
// all of granule j + 1 and bits 0..off-1 of granule j + 2.  `excl` is the
// count of True slots before granule j.
__device__ __forceinline__ void table_pair(int32_t* __restrict__ table,
                                           int64_t g, int off, unsigned b0,
                                           unsigned b1, unsigned b2, int excl) {
  const unsigned word =
      (b0 >> off) | (b1 << (16 - off)) | (off ? b2 << (32 - off) : 0u);
  table[2 * g] = excl + __popc(b0 & ((1u << off) - 1u));
  table[2 * g + 1] = (int32_t)word;
}

template <bool TABLE>
__global__ void __launch_bounds__(IDX_THREADS)
indices_kernel(const uint8_t* __restrict__ mask, int64_t n, int off,
               int nchunks, int32_t* __restrict__ out, int64_t capacity,
               int32_t* __restrict__ count, int32_t* __restrict__ table,
               unsigned long long* __restrict__ status,
               unsigned* __restrict__ ticket) {
  __shared__ int s_chunk;
  __shared__ int s_base;
  __shared__ int s_warp[IDX_ROWS * IDX_WARPS];  // row-major: [row][warp]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) {
    s_chunk = (int)atomicAdd(ticket, 1u);
  }
  __syncthreads();
  const int c = s_chunk;

  if (c >= nchunks) {  // a tail block
    if (tid == 0) {
      unsigned long long w;
      for (;;) {
        w = load_status(status + nchunks - 1);
        if (status_flag(w) == FLAG_PREFIX) break;
        __nanosleep(64);
      }
      s_base = (int)(unsigned)w;
    }
    __syncthreads();
    const int64_t stride = (int64_t)(gridDim.x - nchunks) * IDX_THREADS;
    for (int64_t j = s_base + (int64_t)(c - nchunks) * IDX_THREADS + tid;
         j < capacity; j += stride) {
      out[j] = 0;
    }
    return;
  }

  const int64_t v0 = (int64_t)c * IDX_CHUNK;
  unsigned bits[IDX_ROWS];
  int cnt[IDX_ROWS], incl[IDX_ROWS];
#pragma unroll
  for (int k = 0; k < IDX_ROWS; ++k) {
    bits[k] = load_granule(mask, n, off,
                           v0 + (int64_t)(k * IDX_THREADS + tid) * 16);
    cnt[k] = __popc(bits[k]);
    incl[k] = cnt[k];
  }
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
#pragma unroll
    for (int k = 0; k < IDX_ROWS; ++k) {
      const int t = __shfl_up_sync(FULL, incl[k], o);
      if (lane >= o) incl[k] += t;
    }
  }
  if (lane == 31) {
#pragma unroll
    for (int k = 0; k < IDX_ROWS; ++k) s_warp[k * IDX_WARPS + warp] = incl[k];
  }
  __syncthreads();

  if (warp == 0) {
    // IDX_ROWS * IDX_WARPS == 32 warp sums, in slot order
    const int v = s_warp[lane];
    int s = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(FULL, s, o);
      if (lane >= o) s += t;
    }
    s_warp[lane] = s - v;
    const int total = __shfl_sync(FULL, s, 31);
    int excl = 0;
    if (c == 0) {
      if (lane == 0) store_status(status, status_word(FLAG_PREFIX, total));
    } else {
      if (lane == 0) {
        store_status(status + c, status_word(FLAG_AGGREGATE, total));
      }
      excl = look_back(status, c, lane);
      if (lane == 0) {
        store_status(status + c,
                     status_word(FLAG_PREFIX, (unsigned)(excl + total)));
      }
    }
    if (lane == 0) {
      s_base = excl;
      if (c == nchunks - 1) *count = excl + total;
    }
  }
  __syncthreads();

  const int base = s_base;
  const int64_t ngroups = (n + 31) >> 5;
#pragma unroll
  for (int k = 0; k < IDX_ROWS; ++k) {
    const int64_t v = v0 + (int64_t)(k * IDX_THREADS + tid) * 16;
    const int excl = base + s_warp[k * IDX_WARPS + warp] + incl[k] - cnt[k];
    if (TABLE) {
      // The two granules after this lane's: lanes + 1 and + 2 of the warp
      // (consecutive lanes hold consecutive granules); lane 30's second
      // one is the next warp's first, read again from the mask.
      const unsigned b1 = __shfl_down_sync(FULL, bits[k], 1);
      unsigned b2 = __shfl_down_sync(FULL, bits[k], 2);
      const int64_t g = v >> 5;  // v is 16 j, the group's first slot 32 g
      if ((lane & 1) == 0 && g < ngroups) {
        if (lane == 30 && off != 0) b2 = load_granule(mask, n, off, v + 32);
        table_pair(table, g, off, bits[k], b1, b2, excl);
      }
    }
    int64_t r = excl;
    const int32_t i0 = (int32_t)(v - off);
    for (unsigned m = bits[k]; m != 0 && r < capacity; m &= m - 1, ++r) {
      out[r] = i0 + (__ffs(m) - 1);
    }
  }
}

// One launch of indices_kernel after one memset of its scratch.
template <bool TABLE>
int compact_launch(const void* mask, int64_t n, int off, int nchunks,
                   int ntail, void* out, int64_t capacity, void* count,
                   void* table, void* scratch, void* stream) {
  if (n <= 0 || n >= (int64_t(1) << 31) || off < 0 || off > 15 ||
      nchunks != (int)((off + n + IDX_CHUNK - 1) / IDX_CHUNK) || ntail < 0 ||
      (ntail == 0) != (capacity == 0) ||
      ((uintptr_t)mask & 15u) != (unsigned)off || (TABLE && !table)) {
    return (int)cudaErrorInvalidValue;
  }
  unsigned long long* status = (unsigned long long*)scratch;
  const cudaError_t e =
      cudaMemsetAsync(status, 0, (size_t)(nchunks + 1) * sizeof(*status),
                      (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  indices_kernel<TABLE><<<(unsigned)(nchunks + ntail), IDX_THREADS, 0,
                          (cudaStream_t)stream>>>(
      (const uint8_t*)mask, n, off, nchunks, (int32_t*)out, capacity,
      (int32_t*)count, (int32_t*)table, status,
      (unsigned*)(status + nchunks));
  return (int)cudaGetLastError();
}

}  // namespace

// B4 and B5.  `off` is the mask's address mod 16, `nchunks` = ceil((off + n)
// / IDX_CHUNK), `ntail` the zero-fill blocks (0 when capacity is 0);
// `scratch` holds nchunks + 1 words: the status words, then the ticket.
// B5's `table` holds 2 * ceil(n / 32) int32.
extern "C" int sdf_compact_indices(const void* mask, int64_t n, int off,
                                   int nchunks, int ntail, void* out,
                                   int64_t capacity, void* count,
                                   void* scratch, void* stream) {
  return compact_launch<false>(mask, n, off, nchunks, ntail, out, capacity,
                               count, nullptr, scratch, stream);
}

extern "C" int sdf_compact_ranktable(const void* mask, int64_t n, int off,
                                     int nchunks, int ntail, void* out,
                                     int64_t capacity, void* count,
                                     void* table, void* scratch,
                                     void* stream) {
  return compact_launch<true>(mask, n, off, nchunks, ntail, out, capacity,
                              count, table, scratch, stream);
}
