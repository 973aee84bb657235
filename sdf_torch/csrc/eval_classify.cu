// Fused SDF evaluation + 8-bit marching-cubes classification on a dense grid.
//
// Replaces: sdf_tpu/core/pallas_eval.py `_kernel` (launched by
// `_pallas_invoke`), the TPU kernel that evaluates the expression tree over
// a z-chunk of the grid and writes the per-cell corner-sign case codes,
// carrying the chunk's last z plane through its sequential grid.
//
// Bound on the card: the volume and case writes (nx*ny*nz*sizeof(T) +
// (nx-1)(ny-1)(nz-1)*4 bytes) against 3.35 TB/s, or the expression's
// arithmetic (ops per point * points) against the float32/float64 peak,
// whichever is larger; wide expression trees are arithmetic bound.  Built
// with -fmad=false and IEEE sqrt and division, each recorded op takes at
// least one issue slot (sqrt, division and the NaN-propagating min/max
// several), so the floor of a wide tree is its instructions per sample at
// the card's issue rate, above the operation bound.
//
// Design: a marching slab, every sample evaluated about once.
//   * This file is a template.  core/eval_classify.py traces the
//     expression once on a symbolic recorder and inserts one C++ statement
//     per recorded op into the per-point function `sdf_point` of
//     sdf_point.cuh, the way the Pallas kernel traced the tree into its
//     body, and splices that text in at the #include line below.
//   * Parameters travel by value in the kernel's arguments (the constant
//     bank; sdf_point.cuh `Params`), so a leaf is an instruction operand.
//   * A block owns a patch of CY x CZ = 15 x 31 cells in y and z and a slab
//     of `lx` cell planes along x; blockIdx.z is the slab, and the loop over
//     its sample planes takes the place of the TPU kernel's sequential grid.
//     A warp evaluates one patch row of PZ = 32 samples (lane = z, the one
//     sample of halo included), rows w and w + 8 of the PY = 16: a plane's
//     512 samples on 256 threads, with no index division.  Nothing is carried
//     between blocks, so the halo is recomputed: 16*32 / (15*31) = 1.10 in
//     y and z, (lx + 1) / lx in x.  The launch plan (eval_classify.slab_plan)
//     takes slabs of 16 planes: 1.16-1.17 evaluations a sample on grids of
//     2^22 samples and up, against 1.45 for the TPU kernel's halo blocks.
//   * Each warp ballots its row's signs (v < 0) into one 32-bit word of a
//     3-plane ring in shared memory.  After plane x is in, the cells between
//     planes x - 1 and x read their eight corner bits from four words: one
//     __syncthreads per plane (a ring of three, so a plane's words are not
//     overwritten while a slower warp still reads them).
//   * A block writes the samples it owns: its slab's and patch's leading
//     ones, and the grid's last sample along an axis in the last block there.
//     So every sample is written by exactly one block, every cell by one.
//   * Layout is the JAX package's: x-major, z fastest.  Lanes run along z, so
//     stores coalesce; offsets advance by a plane per step.
//   * Built with -fmad=false and without fast math: every op rounds as the
//     separate elementwise PyTorch kernels of the plain version do, so the
//     volume is bit-identical to it.
#include "sdf_point.cuh"

namespace {

// The launch plan's shape (core/eval_classify.py mirrors these).
constexpr int PZ = 32;  // samples of a patch row along z: one per lane
constexpr int PY = 16;  // sample rows of a patch along y
constexpr int CZ = PZ - 1, CY = PY - 1;  // cells of a patch
constexpr int WARPS = 8;
constexpr int NTHREADS = 32 * WARPS;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int32_t bit(unsigned w, int b) {
  return (int32_t)((w >> b) & 1u);
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
eval_classify_kernel(const T* __restrict__ X, const T* __restrict__ Y,
                     const T* __restrict__ Z,
                     const __grid_constant__ Params<T> P, int nx, int ny,
                     int nz, int lx, T* __restrict__ vol,
                     int32_t* __restrict__ cas) {
  __shared__ unsigned ring[3][PY];
  const Fields<T> none = {};
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int z0 = blockIdx.x * CZ, y0 = blockIdx.y * CY, x0 = blockIdx.z * lx;
  const int x1 = min(x0 + lx, nx - 1);  // the slab's last sample plane
  const int gz = z0 + lane;
  const bool zin = gz < nz;
  const bool zown = lane < CZ || gz == nz - 1;
  const bool zcell = lane < CZ && gz < nz - 1;
  const T zv = zin ? Z[gz] : T(0);
  // The warp's two rows: y values, and offsets in the volume and the case
  // grid at the slab's first plane.
  const int ya = y0 + warp, yb = ya + WARPS;
  const T yva = ya < ny ? Y[ya] : T(0), yvb = yb < ny ? Y[yb] : T(0);
  const int64_t plane = (int64_t)ny * nz;
  const int64_t cplane = (int64_t)(ny - 1) * (nz - 1);
  int64_t vrow = (int64_t)x0 * plane + (int64_t)ya * nz + gz;
  int64_t crow = (int64_t)x0 * cplane + (int64_t)ya * (nz - 1) + gz;
  const int64_t vstep = (int64_t)WARPS * nz, cstep = (int64_t)WARPS * (nz - 1);

  int slot = 0;
  for (int x = x0; x <= x1; ++x) {
    const T xv = X[x];
    const bool xown = x < x0 + lx || x == nx - 1;
#pragma unroll 1
    for (int r = 0; r < PY / WARPS; ++r) {
      const int row = warp + r * WARPS, gy = y0 + row;
      bool inside = false;
      if (gy < ny && zin) {  // gy is uniform across the warp
        const T v = sdf_point<T>(xv, r ? yvb : yva, zv, P, none, 0);
        inside = v < T(0);
        if (xown && zown && (row < CY || gy == ny - 1)) {
          vol[vrow + r * vstep] = v;
        }
      }
      const unsigned w = __ballot_sync(FULL, inside);
      if (lane == 0) ring[slot][row] = w;
    }
    __syncthreads();
    if (x > x0) {
      // The cells between planes x - 1 and x; corner b at CORNER_OFFSETS[b]
      // (core/mc_tables.py): bits 0-3 at z, 4-7 at z + 1.
      const unsigned* lo = ring[slot == 0 ? 2 : slot - 1];
      const unsigned* hi = ring[slot];
#pragma unroll 1
      for (int r = 0; r < PY / WARPS; ++r) {
        const int row = warp + r * WARPS, gy = y0 + row;
        if (row < CY && gy < ny - 1 && zcell) {
          const unsigned a = lo[row], b = lo[row + 1], c = hi[row],
                         d = hi[row + 1];
          int32_t code = 0;
#pragma unroll
          for (int dz = 0; dz < 2; ++dz) {
            const int s = lane + dz;
            code |= (bit(a, s) | bit(c, s) << 1 | bit(d, s) << 2 |
                     bit(b, s) << 3)
                    << (4 * dz);
          }
          cas[crow + r * cstep] = code;
        }
      }
      crow += cplane;
    }
    vrow += plane;
    slot = slot == 2 ? 0 : slot + 1;
  }
}

template <typename T>
int launch(const void* X, const void* Y, const void* Z, const void* P, int nx,
           int ny, int nz, int lx, int gz, int gy, int gx, void* vol,
           void* cas, void* stream) {
  if (nx < 2 || ny < 2 || nz < 2 || lx < 1 ||
      gz != (nz - 1 + CZ - 1) / CZ || gy != (ny - 1 + CY - 1) / CY ||
      gx != (nx - 1 + lx - 1) / lx || gy > 65535 || gx > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  eval_classify_kernel<T><<<dim3(gz, gy, gx), NTHREADS, 0,
                            (cudaStream_t)stream>>>(
      (const T*)X, (const T*)Y, (const T*)Z, params_from<T>(P), nx, ny, nz, lx,
      (T*)vol, (int32_t*)cas);
  return (int)cudaGetLastError();
}

}  // namespace

// `lx` and the grid (gz, gy, gx) are eval_classify.slab_plan's; `P` is the
// host address of the parameter values, or their device address when the
// source reads them from device memory (SDF_PARAMS_IN_ARGS 0).
extern "C" int sdf_eval_classify_f32(const void* X, const void* Y,
                                     const void* Z, const void* P, int nx,
                                     int ny, int nz, int lx, int gz, int gy,
                                     int gx, void* vol, void* cas,
                                     void* stream) {
  return launch<float>(X, Y, Z, P, nx, ny, nz, lx, gz, gy, gx, vol, cas,
                       stream);
}

extern "C" int sdf_eval_classify_f64(const void* X, const void* Y,
                                     const void* Z, const void* P, int nx,
                                     int ny, int nz, int lx, int gz, int gy,
                                     int gx, void* vol, void* cas,
                                     void* stream) {
  return launch<double>(X, Y, Z, P, nx, ny, nz, lx, gz, gy, gx, vol, cas,
                        stream);
}
