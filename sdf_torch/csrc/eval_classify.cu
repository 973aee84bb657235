// Fused SDF evaluation + 8-bit marching-cubes classification on a dense grid.
//
// Replaces: sdf_tpu/core/pallas_eval.py `_kernel` (launched by
// `_pallas_invoke`), the TPU kernel that evaluates the expression tree over
// a z-chunk of the grid and writes the per-cell corner-sign case codes.
//
// Bound on the card: the volume and case writes (nx*ny*nz*sizeof(T) +
// (nx-1)(ny-1)(nz-1)*4 bytes) against 3.35 TB/s, or the expression's
// arithmetic (ops per point * points) against the float32/float64 peak,
// whichever is larger; wide expression trees are arithmetic bound.
//
// Design:
//   * This file is a template.  core/eval_classify.py traces the
//     expression once on a symbolic recorder and inserts one C++ statement
//     per recorded op into the per-point function `sdf_point` of
//     sdf_point.cuh, the way the Pallas kernel traced the tree into its
//     body, and splices that text in at the #include line below.
//   * Each block owns a TX*TY*TZ tile of cells.  It evaluates the tile's
//     (TX+1)(TY+1)(TZ+1) samples into shared memory, recomputing the one
//     sample halo plane on each side: blocks run in no order, so nothing is
//     carried between them (the Pallas kernel carried the z plane through
//     its sequential grid).  It writes the samples it owns to `vol`, then
//     the 8-corner case codes of its cells to `cas`.
//   * Layout is the JAX package's: x-major, z fastest.  Threads run along z
//     so the stores coalesce.
//   * Built with -fmad=false and without fast math: every op rounds as the
//     separate elementwise PyTorch kernels of the plain version do, so the
//     volume is bit-identical to it.
#include "sdf_point.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
eval_classify_kernel(const T* __restrict__ X, const T* __restrict__ Y,
                     const T* __restrict__ Z, const T* __restrict__ P,
                     int nx, int ny, int nz, T* __restrict__ vol,
                     int32_t* __restrict__ cas) {
  __shared__ T s[SX * SY * SZ];
  const Fields<T> none = {};
  const int z0 = blockIdx.x * TZ;
  const int y0 = blockIdx.y * TY;
  const int x0 = blockIdx.z * TX;

  for (int i = threadIdx.x; i < SX * SY * SZ; i += NTHREADS) {
    const int lz = i % SZ;
    const int ly = (i / SZ) % SY;
    const int lx = i / (SZ * SY);
    const int gx = x0 + lx, gy = y0 + ly, gz = z0 + lz;
    if (gx < nx && gy < ny && gz < nz) {
      const T v = sdf_point<T>(X[gx], Y[gy], Z[gz], P, none, 0);
      s[i] = v;
      // A block owns its tile's leading samples; the last tile along an
      // axis also owns the grid's final sample plane.
      const bool own = (lx < TX || gx == nx - 1) && (ly < TY || gy == ny - 1) &&
                       (lz < TZ || gz == nz - 1);
      if (own) vol[((int64_t)gx * ny + gy) * nz + gz] = v;
    }
  }
  __syncthreads();

  for (int c = threadIdx.x; c < TX * TY * TZ; c += NTHREADS) {
    const int lz = c % TZ;
    const int ly = (c / TZ) % TY;
    const int lx = c / (TZ * TY);
    const int gx = x0 + lx, gy = y0 + ly, gz = z0 + lz;
    if (gx < nx - 1 && gy < ny - 1 && gz < nz - 1) {
      cas[((int64_t)gx * (ny - 1) + gy) * (nz - 1) + gz] =
          brick_case<T>(s, lx, ly, lz);
    }
  }
}

template <typename T>
int launch(const void* X, const void* Y, const void* Z, const void* P, int nx,
           int ny, int nz, void* vol, void* cas, void* stream) {
  const dim3 grid((nz - 1 + TZ - 1) / TZ, (ny - 1 + TY - 1) / TY,
                  (nx - 1 + TX - 1) / TX);
  eval_classify_kernel<T><<<grid, NTHREADS, 0, (cudaStream_t)stream>>>(
      (const T*)X, (const T*)Y, (const T*)Z, (const T*)P, nx, ny, nz, (T*)vol,
      (int32_t*)cas);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int sdf_eval_classify_f32(const void* X, const void* Y,
                                     const void* Z, const void* P, int nx,
                                     int ny, int nz, void* vol, void* cas,
                                     void* stream) {
  return launch<float>(X, Y, Z, P, nx, ny, nz, vol, cas, stream);
}

extern "C" int sdf_eval_classify_f64(const void* X, const void* Y,
                                     const void* Z, const void* P, int nx,
                                     int ny, int nz, void* vol, void* cas,
                                     void* stream) {
  return launch<double>(X, Y, Z, P, nx, ny, nz, vol, cas, stream);
}
