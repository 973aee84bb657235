// Fused SDF evaluation + 8-bit marching-cubes classification on a list of
// active tiles (the tiled sparse path): for each tile t of `tiles`, the
// (tile+1)^3 sample volume and the tile^3 corner-sign case codes.
//
// Replaces: sdf_tpu/core/pallas_eval.py `_tile_kernel_batched` (launched by
// `eval_tiles_and_classify_batched`), the TPU kernel that evaluates 128
// tiles at once with the tile index on the vector lanes, and
// sdf_tpu/core/pallas_eval.py `_tile_kernel` (launched by
// `eval_tiles_and_classify`), the TPU kernel that evaluates one tile per
// program and takes precomputed field windows for the subtrees it cannot
// hold.  Here they are the two instantiations of one kernel template:
//   * sdf_eval_tiles_*         (CLAMP): unpadded axes, the sample index is
//     min(t * tile + l, n - 1) per axis, no field inputs;
//   * sdf_eval_tiles_fields_*  (no clamp): axes padded by the caller with
//     `tile` copies of their last coordinate, nf >= 0 field inputs of shape
//     (ntc, TS, TS, TS) that the generated body reads at the point's own
//     linear index.  With nf = 0 it equals the first bit for bit.
//
// Bound on the card: the volume and case writes (ntc * (TS^3 * sizeof(T) +
// tile^3 * 4) bytes, plus nf field reads) against 3.35 TB/s, or the
// expression's arithmetic (ops per point * points) against the
// float32/float64 peak, whichever is larger.
//
// Design:
//   * core/eval_classify.py splices sdf_point.cuh in at the #include line
//     with the per-point body generated from the expression, the same body
//     and the same parameter form (kernel arguments or device memory) the
//     dense kernel gets.
//   * A tile's samples do not fit one block's shared memory in float64
//     (33^3 * 8 B = 287 KB), so each tile is cut into bricks of TX*TY*TZ
//     cells, as the dense kernel cuts the grid.  blockIdx.x is the tile
//     (the one grid dimension without a 65,535 limit), blockIdx.y the brick.
//     A block evaluates its brick's (TX+1)(TY+1)(TZ+1) samples into shared
//     memory, recomputing the one-sample halo: blocks run in no order, so
//     nothing is carried between them (the Pallas kernel carried a z plane
//     through its sequential grid).
//   * Tiles share no output, so every one of a tile's TS^3 samples is
//     written: a brick owns its leading samples, and the last brick along
//     an axis also owns the tile's final sample plane.  `tile` is a run-time
//     argument; bricks that overhang a small tile mask the overhang.
//   * Rows of `tiles` past the live count repeat tile 0 and are computed
//     like any other (the caller masks them).
//   * Layout is the JAX package's: (tile, x, y, z), z fastest; threads run
//     along z so the stores coalesce.  Linear indices are int64.
#include "sdf_point.cuh"

namespace {

// Cells per brick along x, y, z (z fastest); samples are one more each way.
constexpr int TX = 4, TY = 8, TZ = 32;
constexpr int SX = TX + 1, SY = TY + 1, SZ = TZ + 1;
constexpr int NTHREADS = 256;

// Corner b of a cell sits at cell + CORNER_OFFSETS[b] (core/mc_tables.py).
__constant__ int kCorner[8][3] = {
    {0, 0, 0}, {1, 0, 0}, {1, 1, 0}, {0, 1, 0},
    {0, 0, 1}, {1, 0, 1}, {1, 1, 1}, {0, 1, 1},
};

// The 8-bit case code of the cell at (lx, ly, lz) of a block's shared sample
// brick `s` (SX x SY x SZ, z fastest): bit b set iff corner b is inside.
template <typename T>
__device__ __forceinline__ int32_t brick_case(const T* s, int lx, int ly,
                                              int lz) {
  int32_t code = 0;
#pragma unroll
  for (int b = 0; b < 8; ++b) {
    const T v = s[((lx + kCorner[b][0]) * SY + ly + kCorner[b][1]) * SZ + lz +
                  kCorner[b][2]];
    code |= (v < T(0)) ? (1 << b) : 0;
  }
  return code;
}

template <typename T, bool CLAMP>
__global__ void __launch_bounds__(NTHREADS)
eval_tiles_kernel(const T* __restrict__ X, const T* __restrict__ Y,
                  const T* __restrict__ Z, const __grid_constant__ Params<T> P,
                  const int32_t* __restrict__ tiles, int nx, int ny, int nz,
                  int tile, int bricks_y, int bricks_z,
                  const __grid_constant__ Fields<T> F,
                  T* __restrict__ vols, int32_t* __restrict__ cas) {
  __shared__ T s[SX * SY * SZ];
  const int64_t t = blockIdx.x;
  const int TS = tile + 1;
  int brick = blockIdx.y;
  const int z0 = (brick % bricks_z) * TZ;
  brick /= bricks_z;
  const int y0 = (brick % bricks_y) * TY;
  const int x0 = (brick / bricks_y) * TX;
  const int ox = tiles[3 * t] * tile;
  const int oy = tiles[3 * t + 1] * tile;
  const int oz = tiles[3 * t + 2] * tile;

  for (int i = threadIdx.x; i < SX * SY * SZ; i += NTHREADS) {
    const int bz = i % SZ;
    const int by = (i / SZ) % SY;
    const int bx = i / (SZ * SY);
    const int lx = x0 + bx, ly = y0 + by, lz = z0 + bz;
    if (lx < TS && ly < TS && lz < TS) {
      int gx = ox + lx, gy = oy + ly, gz = oz + lz;
      if (CLAMP) {
        gx = min(gx, nx - 1);
        gy = min(gy, ny - 1);
        gz = min(gz, nz - 1);
      }
      const int64_t lin = ((t * TS + lx) * TS + ly) * TS + lz;
      const T v = sdf_point<T>(X[gx], Y[gy], Z[gz], P, F, lin);
      s[i] = v;
      const bool own = (bx < TX || lx == tile) && (by < TY || ly == tile) &&
                       (bz < TZ || lz == tile);
      if (own) vols[lin] = v;
    }
  }
  __syncthreads();

  for (int c = threadIdx.x; c < TX * TY * TZ; c += NTHREADS) {
    const int bz = c % TZ;
    const int by = (c / TZ) % TY;
    const int bx = c / (TZ * TY);
    const int lx = x0 + bx, ly = y0 + by, lz = z0 + bz;
    if (lx < tile && ly < tile && lz < tile) {
      cas[((t * tile + lx) * tile + ly) * tile + lz] =
          brick_case<T>(s, bx, by, bz);
    }
  }
}

template <typename T, bool CLAMP>
int launch(const void* X, const void* Y, const void* Z, const void* P,
           const void* tiles, int64_t ntc, int nx, int ny, int nz, int tile,
           const void* const* fields, int nf, void* vols, void* cas,
           void* stream) {
  if (ntc <= 0 || ntc > 2147483647LL || tile < 1 || nf < 0 ||
      nf > MAX_FIELDS) {
    return (int)cudaErrorInvalidValue;
  }
  Fields<T> F = {};
  for (int k = 0; k < nf; ++k) F.p[k] = (const T*)fields[k];
  const int bx = (tile + TX - 1) / TX, by = (tile + TY - 1) / TY,
            bz = (tile + TZ - 1) / TZ;
  if ((int64_t)bx * by * bz > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)ntc, (unsigned)(bx * by * bz), 1);
  eval_tiles_kernel<T, CLAMP><<<grid, NTHREADS, 0, (cudaStream_t)stream>>>(
      (const T*)X, (const T*)Y, (const T*)Z, params_from<T>(P),
      (const int32_t*)tiles, nx, ny, nz, tile, by, bz, F, (T*)vols,
      (int32_t*)cas);
  return (int)cudaGetLastError();
}

}  // namespace

#define SDF_TILES_ENTRY(name, T, CLAMP)                                       \
  extern "C" int name(const void* X, const void* Y, const void* Z,            \
                      const void* P, const void* tiles, int64_t ntc, int nx,  \
                      int ny, int nz, int tile, const void* const* fields,    \
                      int nf, void* vols, void* cas, void* stream) {          \
    return launch<T, CLAMP>(X, Y, Z, P, tiles, ntc, nx, ny, nz, tile, fields, \
                            nf, vols, cas, stream);                           \
  }

SDF_TILES_ENTRY(sdf_eval_tiles_f32, float, true)
SDF_TILES_ENTRY(sdf_eval_tiles_f64, double, true)
SDF_TILES_ENTRY(sdf_eval_tiles_fields_f32, float, false)
SDF_TILES_ENTRY(sdf_eval_tiles_fields_f64, double, false)
