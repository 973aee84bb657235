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
//     per recorded op at SDF_BODY (the per-point function `sdf_point`), the
//     way the Pallas kernel traced the tree into its body.  Parameter leaves
//     are read from `P`, not baked in as literals, so new parameter values
//     reuse the compiled library.
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
#include <cstdint>
#include <cuda_runtime.h>

namespace {

// PyTorch's CUDA minimum/maximum/clamp: NaN propagates, else ::fmin/::fmax.
__device__ __forceinline__ float op_min(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : fminf(a, b));
}
__device__ __forceinline__ double op_min(double a, double b) {
  return (a != a) ? a : ((b != b) ? b : fmin(a, b));
}
__device__ __forceinline__ float op_max(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : fmaxf(a, b));
}
__device__ __forceinline__ double op_max(double a, double b) {
  return (a != a) ? a : ((b != b) ? b : fmax(a, b));
}
__device__ __forceinline__ float op_sqrt(float a) { return sqrtf(a); }
__device__ __forceinline__ double op_sqrt(double a) { return sqrt(a); }
__device__ __forceinline__ float op_abs(float a) { return fabsf(a); }
__device__ __forceinline__ double op_abs(double a) { return fabs(a); }
__device__ __forceinline__ float op_cos(float a) { return cosf(a); }
__device__ __forceinline__ double op_cos(double a) { return cos(a); }
__device__ __forceinline__ float op_sin(float a) { return sinf(a); }
__device__ __forceinline__ double op_sin(double a) { return sin(a); }
__device__ __forceinline__ float op_atan2(float a, float b) { return atan2f(a, b); }
__device__ __forceinline__ double op_atan2(double a, double b) { return atan2(a, b); }
__device__ __forceinline__ float op_round(float a) { return rintf(a); }
__device__ __forceinline__ double op_round(double a) { return rint(a); }
__device__ __forceinline__ float op_fmod(float a, float b) { return fmodf(a, b); }
__device__ __forceinline__ double op_fmod(double a, double b) { return fmod(a, b); }
__device__ __forceinline__ float op_pow(float a, float b) { return powf(a, b); }
__device__ __forceinline__ double op_pow(double a, double b) { return pow(a, b); }
__device__ __forceinline__ float op_exp2(float a) { return exp2f(a); }
__device__ __forceinline__ double op_exp2(double a) { return exp2(a); }
template <typename T>
__device__ __forceinline__ T op_sign(T a) {
  return T((T(0) < a) - (a < T(0)));
}

template <typename T>
__device__ __forceinline__ T sdf_point(T x, T y, T z, const T* __restrict__ P) {
//@SDF_BODY@
}

// Cells per block along x, y, z (z fastest); samples are one more each way.
constexpr int TX = 4, TY = 8, TZ = 32;
constexpr int SX = TX + 1, SY = TY + 1, SZ = TZ + 1;
constexpr int NTHREADS = 256;

// Corner b of a cell sits at cell + CORNER_OFFSETS[b] (core/mc_tables.py).
__constant__ int kCorner[8][3] = {
    {0, 0, 0}, {1, 0, 0}, {1, 1, 0}, {0, 1, 0},
    {0, 0, 1}, {1, 0, 1}, {1, 1, 1}, {0, 1, 1},
};

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
eval_classify_kernel(const T* __restrict__ X, const T* __restrict__ Y,
                     const T* __restrict__ Z, const T* __restrict__ P,
                     int nx, int ny, int nz, T* __restrict__ vol,
                     int32_t* __restrict__ cas) {
  __shared__ T s[SX * SY * SZ];
  const int z0 = blockIdx.x * TZ;
  const int y0 = blockIdx.y * TY;
  const int x0 = blockIdx.z * TX;

  for (int i = threadIdx.x; i < SX * SY * SZ; i += NTHREADS) {
    const int lz = i % SZ;
    const int ly = (i / SZ) % SY;
    const int lx = i / (SZ * SY);
    const int gx = x0 + lx, gy = y0 + ly, gz = z0 + lz;
    if (gx < nx && gy < ny && gz < nz) {
      const T v = sdf_point<T>(X[gx], Y[gy], Z[gz], P);
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
      int32_t code = 0;
#pragma unroll
      for (int b = 0; b < 8; ++b) {
        const T v = s[((lx + kCorner[b][0]) * SY + ly + kCorner[b][1]) * SZ +
                      lz + kCorner[b][2]];
        code |= (v < T(0)) ? (1 << b) : 0;
      }
      cas[((int64_t)gx * (ny - 1) + gy) * (nz - 1) + gz] = code;
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
