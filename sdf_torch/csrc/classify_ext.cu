// Extended-case (lewiner) classification: per cell, the code
//   ext = OFFSET[case] + sum_f bit_f(extra) * WEIGHT[case][f] + ibits
// that addresses the 5,904-entry trilinear-faithful table set.
//
// Replaces: sdf_tpu/core/mc33.py `_ext_table_kernel` (launched by
// `_ext_from_bits_kernel`), the TPU kernel that resolves the per-case
// constants with a bf16 one-hot matmul against a byte-split (8, 256) table in
// (8, 2048) blocks, because element gathers are slow on the TPU.  On the card
// the constants are a lookup in shared memory, so none of that is carried
// over.  The JAX package fuses the float math that produces `extra` into the
// same XLA pass; `classify_ext_kernel` below fuses it into the same kernel.
//
// Two kernels:
//   * classify_ext_kernel (the main path): per cell, the 8 corner samples of
//     the volume (level-shifted), the 8-bit case from kernel B1's grid or
//     derived from the corners, the face test and the guarded interior test
//     (mc33_cell.cuh `extra_bits`), combined with the table.
//   * ext_from_bits_kernel: the table part alone, exactly the TPU kernel's
//     contract (case, extra) -> ext.
// Both call the one `ext_combine` of mc33_cell.cuh.
//
// Bound on the card: the fused kernel does ~600 operations per cell (103
// before the roots, 213 for each of the two roots, 54 for the six face tests,
// the rest shift, case and combine; two square roots and ten divisions among
// them) on 4 or 8 bytes of volume read, 4 bytes of case read and 4 bytes of
// ext written per cell, so it is operation bound against the float32 /
// float64 peak.  Built with -fmad=false and IEEE sqrt and division, its real
// floor is the SASS instructions of that body at the card's issue rate
// (`chip_smoke.py --ptxas`).  The table-only kernel moves 12 bytes per cell
// and is memory bound against 3.35 TB/s.
//
// Design of the fused kernel: the cell body runs on every cell, so the rest
// is made to cost as little as it can (core/mc33.py ext_plan computes the
// launch):
//   * A block is one row block of a (batch volume, x slab): NTHREADS
//     consecutive cells p of the flattened (y, z) cell plane, one per lane,
//     each lane marching its cell column along the slab's `lx` cell planes.
//     The lane's row is y = p / cz by the host's multiplier (p * mul >>
//     shift, exact for p < 2^31), once per block; nothing is divided per
//     cell, and offsets advance by a plane per step.  Rows of 32 (tiles), 161
//     or 406 cells fill the lanes alike: only the plane's last row block has
//     idle lanes.
//   * A step reads the four corners of the new sample plane, (y, z), (y, z +
//     1), (y + 1, z), (y + 1, z + 1) -- neighbouring lanes read neighbouring
//     addresses, and the L1 serves the repeats -- and carries them in
//     registers as the next step's four of the old plane: 4 loads a cell, not
//     8.  The next plane's four are loaded before the body runs.
//   * No barrier after the table copy: warps run on independently, so one
//     that takes the slow path of an IEEE division or square root (operands
//     near zero, where the field is nearly linear) holds no other up.
//   * The 256 + 1,536 int32 constants are copied into shared memory once per
//     block, which does `lx` x NTHREADS cells.
#include <cstdint>
#include <cuda_runtime.h>

#include "mc33_cell.cuh"

namespace {

// The launch plan's shape (core/mc33.py mirrors these).
constexpr int NTHREADS = 256;  // cells of a row block, one per lane
constexpr int NTAB = 256 * 7;  // OFFSET[256] then WEIGHT[256][6]

__device__ __forceinline__ void load_table(const int32_t* __restrict__ tab_g,
                                           int32_t* tab) {
  for (int i = threadIdx.x; i < NTAB; i += NTHREADS) tab[i] = tab_g[i];
}

// The row of cell p of the plane: p / cz (core/mc33.py ext_plan).
__device__ __forceinline__ unsigned row_of(unsigned p, uint64_t mul,
                                           int shift) {
  return (unsigned)(((uint64_t)p * mul) >> shift);
}

// The four corners of one sample plane, level-shifted: (y, z), (y, z + 1)
// from row `a`, (y + 1, z), (y + 1, z + 1) from row `b`.
template <typename T>
__device__ __forceinline__ void corners(const T* __restrict__ a,
                                        const T* __restrict__ b, T level,
                                        T* out) {
  out[0] = a[0] - level;
  out[1] = a[1] - level;
  out[2] = b[0] - level;
  out[3] = b[1] - level;
}

// At least 4 blocks an SM in float32, which the compiler's own choice (62
// registers) meets, and 3 in float64, where the compiler alone takes 116
// registers and fits 2: at 3 (80 registers) the float64 division and square
// root sequences have the warps to hide their latency.
template <typename T>
__global__ void __launch_bounds__(NTHREADS, sizeof(T) == 8 ? 3 : 4)
classify_ext_kernel(const T* __restrict__ vol, int nx, int ny, int nz, int lx,
                    unsigned nrb, unsigned nslab, uint64_t mul, int shift,
                    T level, const int32_t* __restrict__ base_case,
                    const int32_t* __restrict__ tab_g,
                    int32_t* __restrict__ ext) {
  __shared__ int32_t tab[NTAB];
  load_table(tab_g, tab);
  __syncthreads();
  // Block -> (volume b, slab, row block rb); rb runs fastest.
  const unsigned bs = blockIdx.x / nrb, rb = blockIdx.x - bs * nrb;
  const unsigned b = bs / nslab, slab = bs - b * nslab;
  const unsigned cplane = (unsigned)(ny - 1) * (unsigned)(nz - 1);
  const unsigned p = rb * NTHREADS + threadIdx.x;
  if (p >= cplane) return;
  const int x0 = (int)slab * lx, x1 = min(x0 + lx, nx - 1);
  const int64_t plane = (int64_t)ny * nz;
  // The lane's 64-bit bases: sample (y, z) of cell p is p + y.
  const T* a =
      vol + ((int64_t)b * nx + x0) * plane + (p + row_of(p, mul, shift));
  const T* r = a + nz;
  const int64_t c0 = ((int64_t)b * (nx - 1) + x0) * cplane + p;
  int32_t* out = ext + c0;
  const int32_t* bc = base_case == nullptr ? nullptr : base_case + c0;
  T lo[4], hi[4];
  corners(a, r, level, lo);
  corners(a + plane, r + plane, level, hi);
  for (int x = x0; x < x1; ++x) {
    a += plane;
    r += plane;
    T next[4] = {T(0), T(0), T(0), T(0)};
    if (x + 1 < x1) corners(a + plane, r + plane, level, next);
    // Corner i sits at cell + CORNER_OFFSETS[i] (core/mc_tables.py).
    T c[8];
    c[0] = lo[0];
    c[1] = hi[0];
    c[2] = hi[2];
    c[3] = lo[2];
    c[4] = lo[1];
    c[5] = hi[1];
    c[6] = hi[3];
    c[7] = lo[3];
    int32_t cas;
    if (bc != nullptr) {
      cas = *bc;
      bc += cplane;
    } else {
      cas = 0;
#pragma unroll
      for (int i = 0; i < 8; ++i) cas |= (c[i] < T(0)) ? (1 << i) : 0;
    }
    *out = ext_combine(cas, extra_bits<T>(c), tab);
    out += cplane;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      lo[i] = hi[i];
      hi[i] = next[i];
    }
  }
}

__global__ void __launch_bounds__(NTHREADS)
ext_from_bits_kernel(const int32_t* __restrict__ cas,
                     const int32_t* __restrict__ extra, int64_t n,
                     const int32_t* __restrict__ tab_g,
                     int32_t* __restrict__ ext) {
  __shared__ int32_t tab[NTAB];
  load_table(tab_g, tab);
  __syncthreads();
  const int64_t stride = (int64_t)gridDim.x * NTHREADS;
  for (int64_t i = (int64_t)blockIdx.x * NTHREADS + threadIdx.x; i < n;
       i += stride)
    ext[i] = ext_combine(cas[i], extra[i], tab);
}

int ceil_log2(unsigned v) {
  int l = 0;
  while ((1ull << l) < v) ++l;
  return l;
}

template <typename T>
int launch(const void* vol, int64_t nb, int nx, int ny, int nz, int lx,
           unsigned nrb, unsigned nslab, uint64_t mul, int shift,
           unsigned blocks, double level, const void* base_case,
           const void* tab, void* ext, void* stream) {
  // The plan must be ext_plan's for this shape.
  const int64_t cplane = (int64_t)(ny - 1) * (nz - 1);
  if (nb < 1 || nx < 2 || ny < 2 || nz < 2 || lx < 1 || cplane >= (1ll << 31) ||
      nrb != (cplane + NTHREADS - 1) / NTHREADS ||
      nslab != (unsigned)((nx - 1 + lx - 1) / lx) ||
      (int64_t)blocks != nb * nslab * (int64_t)nrb ||
      shift != 31 + ceil_log2((unsigned)(nz - 1)) ||
      mul != ((1ull << shift) + (nz - 2)) / (uint64_t)(nz - 1)) {
    return (int)cudaErrorInvalidValue;
  }
  classify_ext_kernel<T><<<blocks, NTHREADS, 0, (cudaStream_t)stream>>>(
      (const T*)vol, nx, ny, nz, lx, nrb, nslab, mul, shift, (T)level,
      (const int32_t*)base_case, (const int32_t*)tab, (int32_t*)ext);
  return (int)cudaGetLastError();
}

}  // namespace

// nrb, nslab, mul, shift and blocks are core/mc33.py ext_plan's.
extern "C" int sdf_classify_ext_f32(const void* vol, int64_t nb, int nx,
                                    int ny, int nz, int lx, unsigned nrb,
                                    unsigned nslab, uint64_t mul, int shift,
                                    unsigned blocks, double level,
                                    const void* base_case, const void* tab,
                                    void* ext, void* stream) {
  return launch<float>(vol, nb, nx, ny, nz, lx, nrb, nslab, mul, shift,
                       blocks, level, base_case, tab, ext, stream);
}

extern "C" int sdf_classify_ext_f64(const void* vol, int64_t nb, int nx,
                                    int ny, int nz, int lx, unsigned nrb,
                                    unsigned nslab, uint64_t mul, int shift,
                                    unsigned blocks, double level,
                                    const void* base_case, const void* tab,
                                    void* ext, void* stream) {
  return launch<double>(vol, nb, nx, ny, nz, lx, nrb, nslab, mul, shift,
                        blocks, level, base_case, tab, ext, stream);
}

extern "C" int sdf_ext_from_bits(const void* cas, const void* extra, int64_t n,
                                 const void* tab, void* ext, void* stream) {
  int64_t blocks = (n + NTHREADS - 1) / NTHREADS;
  if (blocks > 132 * 16) blocks = 132 * 16;
  if (blocks < 1) blocks = 1;
  ext_from_bits_kernel<<<(unsigned)blocks, NTHREADS, 0,
                         (cudaStream_t)stream>>>(
      (const int32_t*)cas, (const int32_t*)extra, n, (const int32_t*)tab,
      (int32_t*)ext);
  return (int)cudaGetLastError();
}
