// Per-cell triangle count lookup: out[i] = ntri[case[i]].
//
// Replaces: sdf_tpu/core/mc.py `_ntri_kernel` (launched by
// `_ntri_of_kernel`), which computed the same lookup as a bf16 one-hot
// matmul because element gathers are slow on the TPU.  On the card a gather
// from shared memory is cheap, so this is the lookup itself.
//
// Bound on the card: memory traffic, 4 bytes read + 4 bytes written per
// cell, against 3.35 TB/s.
//
// Design (core/mc.py ntri_plan computes the launch):
//   * The table is bytes (a count is at most 10): 256 entries for the fast
//     variant, 5,904 for lewiner, padded to 16 bytes.  Each block copies it
//     into shared memory once, with 16-byte loads.
//   * Few, long-lived blocks: the grid is the SMs times the BLOCKS_PER_SM
//     blocks that fit on each (2,048 threads), or fewer on a short input;
//     each block walks many cells.
//   * 16-byte loads and stores, 4 cells a lane, two vectors in flight a
//     lane.  The wrapper allocates the output at the input's address modulo
//     16, so one split serves both: `head` cells up to the first 16-byte
//     boundary, `nvec` vectors, then a tail of at most 3, the head and the
//     tail done by lanes of block 0 one cell each.
//   * A lane's first vector is loaded before the table copy and its barrier,
//     so the copy's latency overlaps the stream.
// Codes outside the table give 0, as the one-hot form does.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

// The launch plan's shape (core/mc.py mirrors these).
constexpr int NTHREADS = 256;
constexpr int BLOCKS_PER_SM = 8;

__device__ __forceinline__ int32_t look(const uint8_t* tab, int32_t c,
                                        int ntab) {
  return (unsigned)c < (unsigned)ntab ? (int32_t)tab[c] : 0;
}

__device__ __forceinline__ int4 look4(const uint8_t* tab, int4 c, int ntab) {
  return make_int4(look(tab, c.x, ntab), look(tab, c.y, ntab),
                   look(tab, c.z, ntab), look(tab, c.w, ntab));
}

__global__ void __launch_bounds__(NTHREADS, BLOCKS_PER_SM)
ntri_kernel(const int32_t* __restrict__ cas, int64_t n, int head,
            int64_t nvec, const uint8_t* __restrict__ table, int ntab,
            int32_t* __restrict__ out) {
  extern __shared__ uint4 tab16[];
  const uint8_t* tab = (const uint8_t*)tab16;
  const int4* in4 = (const int4*)(cas + head);
  int4* out4 = (int4*)(out + head);
  const int64_t stride = (int64_t)gridDim.x * NTHREADS;
  int64_t v = (int64_t)blockIdx.x * NTHREADS + threadIdx.x;
  int4 a = make_int4(0, 0, 0, 0);
  if (v < nvec) a = in4[v];
  for (int i = threadIdx.x; i < (ntab + 15) / 16; i += NTHREADS)
    tab16[i] = ((const uint4*)table)[i];
  __syncthreads();
  if (blockIdx.x == 0 && threadIdx.x < 8) {
    const int t = threadIdx.x;
    const int64_t i = t < 4 ? (t < head ? t : n) : head + 4 * nvec + (t - 4);
    if (i < n) out[i] = look(tab, cas[i], ntab);
  }
  while (v < nvec) {
    const int64_t w = v + stride;
    int4 b = make_int4(0, 0, 0, 0);
    if (w < nvec) b = in4[w];
    out4[v] = look4(tab, a, ntab);
    if (w < nvec) out4[w] = look4(tab, b, ntab);
    v = w + stride;
    if (v < nvec) a = in4[v];
  }
}

}  // namespace

// head, nvec and blocks are core/mc.py ntri_plan's; `table` holds the
// counts as bytes, padded to a multiple of 16.
extern "C" int sdf_ntri(const void* cas, int64_t n, int head, int64_t nvec,
                        int blocks, const void* table, int ntab, void* out,
                        void* stream) {
  if (n < 1 || head < 0 || head > 3 || nvec < 0 || n - head - 4 * nvec < 0 ||
      n - head - 4 * nvec > 3 || blocks < 1 || ntab < 1 ||
      (uintptr_t)table % 16 != 0 ||
      (nvec > 0 && (((uintptr_t)cas + 4 * head) % 16 != 0 ||
                    ((uintptr_t)out + 4 * head) % 16 != 0))) {
    return (int)cudaErrorInvalidValue;
  }
  ntri_kernel<<<blocks, NTHREADS, (ntab + 15) / 16 * 16,
                (cudaStream_t)stream>>>((const int32_t*)cas, n, head, nvec,
                                        (const uint8_t*)table, ntab,
                                        (int32_t*)out);
  return (int)cudaGetLastError();
}
