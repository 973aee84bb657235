// Fused SDF evaluation + 8-bit marching-cubes classification on a list of
// active tiles (the tiled sparse path): for each row t of `tiles`, the
// (tile+1)^3 sample volume and the tile^3 corner-sign case codes.
//
// Replaces: sdf_tpu/core/pallas_eval.py `_tile_kernel_batched` (launched by
// `eval_tiles_and_classify_batched`, pallas_eval.py:262), the TPU kernel that
// evaluates 128 tiles at once with the tile index on the vector lanes, and
// sdf_tpu/core/pallas_eval.py `_tile_kernel` (launched by
// `eval_tiles_and_classify`, pallas_eval.py:163), the TPU kernel that
// evaluates one tile per program and takes precomputed field windows for the
// subtrees it cannot hold.  Here both are one kernel, instantiated once per
// dtype, behind two pairs of entries that keep the wrappers' contracts:
//   * sdf_eval_tiles_*         (kernel B6): unpadded axes, no field input;
//   * sdf_eval_tiles_fields_*  (kernel B7): axes padded by the caller with
//     `tile` copies of their last coordinate, nf >= 0 field inputs of shape
//     (ntc, TS, TS, TS) that the generated body reads at the sample's own
//     linear index.  With nf = 0 it equals the first bit for bit.
// The sample index is min(t * tile + l, n - 1) per axis.  On padded axes the
// clamp never acts (t * tile + l <= n + tile - 2 < n + tile), and on
// unpadded ones it reads the coordinate that the padding repeats.
//
// Bound on the card: the expression's arithmetic (ops per point * evaluated
// samples) against the float32/float64 peak for a wide body (blobby), or
// for a short body with fields the volume and case writes (rows * (TS^3 *
// sizeof(T) + tile^3 * 4) bytes) plus nf field reads against 3.35 TB/s.
// Built with -fmad=false and IEEE division and sqrt, a wide body issues
// several instructions per recorded op, so its floor is its instructions
// per sample at the card's issue rate: what sets the time is how many
// samples are evaluated, and how evenly the SMs share them.
//
// Design: each sample evaluated once, in blocks small enough to share out.
//   * core/eval_classify.py splices sdf_point.cuh in at the #include line
//     with the per-point body generated from the expression, the same body
//     and the same parameter form the dense kernel gets.
//   * A tile row's TS^3 samples, flattened with z fastest (its layout in
//     `vols`), are cut into `nblk` ranges of S samples, S a multiple of 32
//     (core/eval_classify.py tile_plan); block b of the row evaluates range
//     b, lanes running along it, and stores each value at once: a block's
//     stores are one contiguous run, and no warp idles on a 33-sample row.
//     Blobby's 388 evaluated rows at tile 32 take 2 blocks a row of 17,984
//     samples: 776 blocks, enough for the card's 132 SMs at 4 blocks each.
//   * The sign of each sample (v < 0) goes to a bit array in shared memory,
//     one ballot word per warp step: 562 words for 17,984 samples, in
//     either dtype.
//   * The cells of a range (those whose corner 0 is one of its samples)
//     read signs up to TS^2 + TS + 1 samples past it.  The blocks of a row
//     form a thread block cluster of `csize` (up to the portable 8): after a
//     cluster barrier each block copies that halo of words from the next
//     block's shared memory (distributed shared memory), so no sample is
//     evaluated twice.  Only a row cut into more than one cluster (tile 243
//     and up, whose bits outgrow shared memory in 8 blocks) evaluates the
//     halo at a cluster's end.  A second barrier keeps every block's bits
//     alive until its neighbour has copied them.  Then each cell takes its
//     eight corner bits as four pairs along z (a funnel shift of two words).
//   * Rows past the caller's live count repeat row `live` (tile 0 in
//     core/sparse.py): the wrappers launch over rows [0, live + 1) only and
//     copy that last row over the rest, which costs bytes, not evaluations.
//   * Layout is the JAX package's: (tile, x, y, z), z fastest.  Linear
//     indices are int64.
#include <cooperative_groups.h>

#include "sdf_point.cuh"

namespace {

namespace cg = cooperative_groups;

// The kernel's limits, which core/eval_classify.py's tile_plan mirrors:
// it gives a row as many blocks as fill the card's SMs with the launch's
// rows, up to a cluster of CLUSTER.
constexpr int NTHREADS = 256;
constexpr int CLUSTER = 8;         // most blocks of a cluster (portable)
constexpr int SMEM_MAX = 232448;   // shared memory a block may take, bytes
constexpr int SMEM_STATIC = 49152;  // above this, opt in (cudaFuncSetAttribute)
constexpr unsigned FULL = 0xffffffffu;

// The sign bits of samples q and q + 1 of a block's bit array.
__device__ __forceinline__ int32_t pair(const unsigned* bits, int q) {
  return (int32_t)(__funnelshift_r(bits[q >> 5], bits[(q >> 5) + 1], q & 31) &
                   3u);
}

// Words of sign bits a block keeps: its S samples and the halo its cells
// read, up to the second word of the last pair read.
__host__ __device__ inline int64_t words_of(int64_t S, int64_t TS) {
  return (S - 1 + TS * TS + TS) / 32 + 2;
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
eval_tiles_kernel(const T* __restrict__ X, const T* __restrict__ Y,
                  const T* __restrict__ Z, const __grid_constant__ Params<T> P,
#if SDF_NFIELDS
                  const __grid_constant__ Fields<T> F,
#endif
                  const int32_t* __restrict__ tiles, int nx, int ny, int nz,
                  int tile, int S, int nblk, T* __restrict__ vols,
                  int32_t* __restrict__ cas) {
  extern __shared__ unsigned bits[];
#if !SDF_NFIELDS
  const Fields<T> F = {};  // a body that reads no field: no such argument
#endif
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int csize = (int)cluster.num_blocks();
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x % nblk;
  const int64_t t = blockIdx.x / nblk;
  const int TS = tile + 1, plane = TS * TS, N = plane * TS;
  const int s0 = min(b * S, N), s1 = min(s0 + S, N);
  // The last block of a cluster cut from a longer row evaluates its halo.
  const int e = rank == csize - 1 ? min(s1 + plane + TS + 1, N) : s1;
  const int ox = tiles[3 * t] * tile;
  const int oy = tiles[3 * t + 1] * tile;
  const int oz = tiles[3 * t + 2] * tile;
  const int64_t vbase = t * N;

  // Sample p = (x * TS + y) * TS + z of the row; a thread steps by NTHREADS
  // samples, (dx, dy, dz) in (x, y, z).
  int p = s0 + threadIdx.x;
  int z = p % TS, y = p / TS;
  int x = y / TS;
  y %= TS;
  const int dz = NTHREADS % TS, dy = NTHREADS / TS % TS,
            dx = NTHREADS / plane;
#pragma unroll 1
  for (; p - lane < e; p += NTHREADS) {  // warp-uniform
    bool inside = false;
    if (p < e) {
      // The sample's index in `vols` is its index in every field.
      const T v = sdf_point<T>(X[min(ox + x, nx - 1)], Y[min(oy + y, ny - 1)],
                               Z[min(oz + z, nz - 1)], P, F, vbase + p);
      inside = v < T(0);
      if (p < s1) vols[vbase + p] = v;
    }
    const unsigned w = __ballot_sync(FULL, inside);
    if (lane == 0) bits[(p - lane - s0) >> 5] = w;
    z += dz;
    const int zc = z >= TS;
    z -= zc ? TS : 0;
    y += dy + zc;
    const int yc = y >= TS;
    y -= yc ? TS : 0;
    x += dx + yc;
  }
  cluster.sync();
  if (rank < csize - 1) {  // the halo: the next block's first words
    const unsigned* next = cluster.map_shared_rank(bits, rank + 1);
    const int own = S >> 5, halo = (int)words_of(S, TS) - own;
    for (int i = threadIdx.x; i < halo; i += NTHREADS) {
      bits[own + i] = next[i];
    }
  }
  cluster.sync();

  // The cells whose corner 0 is a sample of the range; corner b at
  // CORNER_OFFSETS[b] (core/mc_tables.py): bits 0-3 at z, 4-7 at z + 1.
  int q = s0 + threadIdx.x;
  z = q % TS;
  y = q / TS;
  x = y / TS;
  y %= TS;
  const int64_t cbase = t * tile * tile * tile;
#pragma unroll 1
  for (; q < s1; q += NTHREADS) {
    if (x < tile && y < tile && z < tile) {
      const int l = q - s0;
      const int32_t a = pair(bits, l), c = pair(bits, l + plane),
                    d = pair(bits, l + plane + TS), f = pair(bits, l + TS);
      cas[cbase + ((int64_t)x * tile + y) * tile + z] =
          (a & 1) | (c & 1) << 1 | (d & 1) << 2 | (f & 1) << 3 |
          (a >> 1) << 4 | (c >> 1) << 5 | (d >> 1) << 6 | (f >> 1) << 7;
    }
    z += dz;
    const int zc = z >= TS;
    z -= zc ? TS : 0;
    y += dy + zc;
    const int yc = y >= TS;
    y -= yc ? TS : 0;
    x += dx + yc;
  }
}

template <typename T>
int launch(const void* X, const void* Y, const void* Z, const void* P,
           const void* tiles, int64_t ntc, int nx, int ny, int nz, int tile,
           int S, int nblk, int csize, const void* const* fields, int nf,
           void* vols, void* cas, void* stream) {
  const int64_t TS = (int64_t)tile + 1, N = TS * TS * TS;
  const int64_t smem = 4 * words_of(S, TS);
  // The plan's invariants: ranges of whole words that cover the row, whole
  // clusters, a halo inside the next block's range, and shared memory.
  if (ntc <= 0 || tile < 1 || N > 2147483647LL || S < 32 || S % 32 ||
      nblk < 1 || (int64_t)S * nblk < N || csize < 1 || csize > CLUSTER ||
      nblk % csize || (csize > 1 && S < (words_of(S, TS) - S / 32) * 32) ||
      ntc * nblk > 2147483647LL || smem > SMEM_MAX || nf != SDF_NFIELDS) {
    return (int)cudaErrorInvalidValue;
  }
  if (smem > SMEM_STATIC) {
    const cudaError_t err = cudaFuncSetAttribute(
        (const void*)eval_tiles_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  Fields<T> F = {};
  for (int k = 0; k < nf; ++k) F.p[k] = (const T*)fields[k];
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(ntc * nblk));
  cfg.blockDim = dim3(NTHREADS);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = (unsigned)csize;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, eval_tiles_kernel<T>, (const T*)X, (const T*)Y, (const T*)Z,
      params_from<T>(P),
#if SDF_NFIELDS
      F,
#endif
      (const int32_t*)tiles, nx, ny, nz, tile, S, nblk, (T*)vols,
      (int32_t*)cas);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// `ntc` is the number of rows launched (the wrapper's evaluated rows); `S`,
// `nblk` and `csize` are eval_classify.tile_plan's; `P` is the host address
// of the parameter values, or their device address when the source reads
// them from device memory (SDF_PARAMS_IN_ARGS 0); `fields` holds `nf`
// device pointers to (ntc, TS, TS, TS) volumes of T, none for kernel B6.
#define SDF_TILES_ENTRY(name, T, TAKES_FIELDS)                                \
  extern "C" int name(const void* X, const void* Y, const void* Z,            \
                      const void* P, const void* tiles, int64_t ntc, int nx,  \
                      int ny, int nz, int tile, int S, int nblk, int csize,   \
                      const void* const* fields, int nf, void* vols,          \
                      void* cas, void* stream) {                              \
    if (!(TAKES_FIELDS) && nf != 0) return (int)cudaErrorInvalidValue;        \
    return launch<T>(X, Y, Z, P, tiles, ntc, nx, ny, nz, tile, S, nblk,       \
                     csize, fields, nf, vols, cas, stream);                   \
  }

SDF_TILES_ENTRY(sdf_eval_tiles_f32, float, false)
SDF_TILES_ENTRY(sdf_eval_tiles_f64, double, false)
SDF_TILES_ENTRY(sdf_eval_tiles_fields_f32, float, true)
SDF_TILES_ENTRY(sdf_eval_tiles_fields_f64, double, true)
