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
// Design: each block copies the table (256 entries for the fast variant,
// 5,904 for lewiner; its size is a parameter) into shared memory, then
// walks the codes with a grid-stride loop, one code per thread per step.
// Codes outside the table give 0, as the one-hot form does.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NTHREADS = 256;

__global__ void __launch_bounds__(NTHREADS)
ntri_kernel(const int32_t* __restrict__ cas, int64_t n,
            const int32_t* __restrict__ table, int ntab,
            int32_t* __restrict__ out) {
  extern __shared__ int32_t tab[];
  for (int i = threadIdx.x; i < ntab; i += NTHREADS) tab[i] = table[i];
  __syncthreads();
  const int64_t stride = (int64_t)gridDim.x * NTHREADS;
  for (int64_t i = (int64_t)blockIdx.x * NTHREADS + threadIdx.x; i < n;
       i += stride) {
    const int32_t c = cas[i];
    out[i] = (c >= 0 && c < ntab) ? tab[c] : 0;
  }
}

}  // namespace

extern "C" int sdf_ntri(const void* cas, int64_t n, const void* table,
                        int ntab, void* out, void* stream) {
  int64_t blocks = (n + NTHREADS - 1) / NTHREADS;
  if (blocks > 132 * 16) blocks = 132 * 16;
  if (blocks < 1) blocks = 1;
  ntri_kernel<<<(unsigned)blocks, NTHREADS, ntab * sizeof(int32_t),
                (cudaStream_t)stream>>>((const int32_t*)cas, n,
                                        (const int32_t*)table, ntab,
                                        (int32_t*)out);
  return (int)cudaGetLastError();
}
