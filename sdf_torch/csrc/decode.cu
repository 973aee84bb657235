// The mesh decode (kernel D1): the indexed emit's compacted edge ids,
// float32 interpolants and face ranks -> the mesh in the layout the host
// returns, in one buffer that one copy brings back: ne x 3 float64
// vertices, row-major, then n x 3 int32 faces, row-major.
//
// Replaces: no TPU kernel.  The JAX package fetches a packed wire format
// (an edge id and the bits of t a vertex; three 21-bit ranks in two words
// a triangle) and rebuilds the mesh on the host with numpy
// (sdf_tpu/core/mc.py `unpack_indexed`, sdf_tpu/core/sparse.py
// `unpack_tiles_indexed`), as the port's CPU path still does: about twenty
// full-array passes and hundreds of MB of fresh host memory for a mesh of
// a few million triangles, to halve a copy of a few ms.  Here the card
// computes the same IEEE float32 operations and the host only takes views
// of the fetched bytes (core/mc.py `split_mesh`).
//
// Bound on the card: memory traffic, 8 bytes read a vertex (edge id, t)
// and 12 a triangle (three ranks), 24 bytes written a vertex and 12 a
// triangle, against 3.35 TB/s.
//
// Design:
//   * One thread a row: vertex i for i < ne, triangle i for i < n, blocks
//     of NTHREADS.  Edge ids are below 2^31 (the compaction's int32
//     indices), so the decode divides in 32 bits.
//   * A vertex: its edge's axis and integer start, each component converted
//     to float32 with round-to-nearest, t added on the edge's axis with
//     __fadd_rn, then widened to double.  These are the numpy decode's
//     operations, so the output is bit-equal to it.
//   * The faces: the rank lookup's (3, capacity) rows, read a row at a time
//     (coalesced), transposed to (n, 3).
//   * A block stages its rows in shared memory and writes them back as
//     contiguous runs, so a warp's stores fill whole lines instead of
//     striding by 24 and 12 bytes.
//   * One body, two entries: the dense grid (edge ids in [x | y | z]
//     blocks over the whole grid) and the tiles (a tile id, then per-tile
//     [x | y | z] blocks, offset by the tile's origin from the tile list).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NTHREADS = 256;

// The dense grid's edge blocks: x edges (nx - 1, ny, nz), then y edges
// (nx, ny - 1, nz), then z edges (nx, ny, nz - 1), each row-major.
struct Dense {
  int64_t sx, sxy;  // the x block's size; the x and y blocks' sizes
  uint32_t ny, nz;
};

// Per-tile edge blocks of a tile list: tile id * stile + axis * sblk + the
// row-major index in (tile, ts, ts), (ts, tile, ts) or (ts, ts, tile).
struct Tiled {
  const int32_t* origin;  // (ntc, 3) tile coordinates
  uint32_t tile, sblk, stile;
};

// The edge's axis; its integer start in grid samples goes to xyz.
__device__ __forceinline__ int where(const Dense& g, uint32_t e,
                                     int64_t xyz[3]) {
  int a;
  uint32_t local, my, mz;
  if (e < g.sx) {
    a = 0, local = e, my = g.ny, mz = g.nz;
  } else if (e < g.sxy) {
    a = 1, local = e - (uint32_t)g.sx, my = g.ny - 1, mz = g.nz;
  } else {
    a = 2, local = e - (uint32_t)g.sxy, my = g.ny, mz = g.nz - 1;
  }
  const uint32_t rem = local / mz;
  xyz[0] = rem / my;
  xyz[1] = rem % my;
  xyz[2] = local % mz;
  return a;
}

__device__ __forceinline__ int where(const Tiled& g, uint32_t e,
                                     int64_t xyz[3]) {
  const uint32_t tid = e / g.stile, block = e % g.stile;
  const int a = (int)(block / g.sblk);
  const uint32_t le = block % g.sblk, ts = g.tile + 1;
  const uint32_t d1 = a == 1 ? g.tile : ts, d2 = a == 2 ? g.tile : ts;
  const uint32_t rem = le / d2;
  const int32_t* o = g.origin + 3 * (int64_t)tid;
  xyz[0] = (int64_t)o[0] * g.tile + rem / d1;
  xyz[1] = (int64_t)o[1] * g.tile + rem % d1;
  xyz[2] = (int64_t)o[2] * g.tile + le % d2;
  return a;
}

template <class G>
__global__ void __launch_bounds__(NTHREADS)
decode_mesh_kernel(const int32_t* __restrict__ eidx,
                   const float* __restrict__ t,
                   const int32_t* __restrict__ ranks, int64_t rstride,
                   int64_t ne, int64_t n, G g, double* __restrict__ verts,
                   int32_t* __restrict__ faces) {
  __shared__ double sv[3 * NTHREADS];
  __shared__ int32_t sf[3 * NTHREADS];
  const int64_t base = (int64_t)blockIdx.x * NTHREADS;
  const int64_t i = base + threadIdx.x;
  if (i < ne) {
    int64_t xyz[3];
    const int a = where(g, (uint32_t)eidx[i], xyz);
    const float ti = t[i];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float v = __ll2float_rn(xyz[c]);
      if (c == a) v = __fadd_rn(v, ti);
      sv[3 * threadIdx.x + c] = (double)v;
    }
  }
  if (i < n) {
#pragma unroll
    for (int c = 0; c < 3; ++c)
      sf[3 * threadIdx.x + c] = ranks[c * rstride + i];
  }
  __syncthreads();
  const int64_t out = 3 * base;
  for (int j = threadIdx.x; j < 3 * NTHREADS; j += NTHREADS) {
    if (out + j < 3 * ne) verts[out + j] = sv[j];
    if (out + j < 3 * n) faces[out + j] = sf[j];
  }
}

template <class G>
int decode_launch(const void* eidx, const void* t, const void* ranks,
                  int64_t rstride, int64_t ne, int64_t n, G g, void* out,
                  void* stream) {
  if (ne < 0 || n < 0 || ne >= (int64_t(1) << 31) ||
      n >= (int64_t(1) << 31) || (n > 0 && rstride < n) ||
      ((uintptr_t)out & 7u)) {
    return (int)cudaErrorInvalidValue;
  }
  const int64_t rows = ne > n ? ne : n;
  if (rows == 0) return (int)cudaSuccess;
  double* verts = (double*)out;
  int32_t* faces = (int32_t*)((char*)out + 24 * ne);
  decode_mesh_kernel<G><<<(unsigned)((rows + NTHREADS - 1) / NTHREADS),
                          NTHREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)eidx, (const float*)t, (const int32_t*)ranks, rstride,
      ne, n, g, verts, faces);
  return (int)cudaGetLastError();
}

}  // namespace

// D1 on the dense grid of (nx, ny, nz) samples.  `ranks` holds the three
// rows of face ranks, `rstride` apart; `out` holds 24 * ne + 12 * n bytes,
// 8-byte aligned.
extern "C" int sdf_decode_dense(const void* eidx, const void* t,
                                const void* ranks, int64_t rstride,
                                int64_t ne, int64_t n, int64_t nx, int64_t ny,
                                int64_t nz, void* out, void* stream) {
  if (nx < 2 || ny < 2 || nz < 2 ||
      (nx - 1) * ny * nz + nx * (ny - 1) * nz >= (int64_t(1) << 31)) {
    return (int)cudaErrorInvalidValue;
  }
  const Dense g{(nx - 1) * ny * nz, (nx - 1) * ny * nz + nx * (ny - 1) * nz,
                (uint32_t)ny, (uint32_t)nz};
  return decode_launch(eidx, t, ranks, rstride, ne, n, g, out, stream);
}

// D1 on a tile list: `origin` holds the (ntc, 3) int32 tile coordinates,
// `tile` cells a tile per axis.
extern "C" int sdf_decode_tiles(const void* eidx, const void* t,
                                const void* ranks, int64_t rstride,
                                int64_t ne, int64_t n, const void* origin,
                                int64_t tile, void* out, void* stream) {
  const int64_t sblk = tile * (tile + 1) * (tile + 1);
  if (tile < 1 || 3 * sblk >= (int64_t(1) << 31) || !origin) {
    return (int)cudaErrorInvalidValue;
  }
  const Tiled g{(const int32_t*)origin, (uint32_t)tile, (uint32_t)sblk,
                (uint32_t)(3 * sblk)};
  return decode_launch(eidx, t, ranks, rstride, ne, n, g, out, stream);
}
