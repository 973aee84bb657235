// The per-point SDF evaluation shared by the three eval kernels:
// eval_classify.cu (dense grid), and the two kernels of eval_tiles.cu
// (active tiles, without and with precomputed field inputs).
//
// This is not a header that a compiler finds: core/eval_classify.py splices
// its text into each kernel source at the line that includes this file,
// with the body of `sdf_point` generated from the expression (one C++
// statement per recorded op) at the SDF_BODY mark.  Parameter leaves are
// read from `P`, not baked in as literals, so new parameter values reuse the
// compiled library.  A statement that stands for a subtree evaluated ahead of
// the kernel (a gather the body cannot hold) reads `F.p[k][fi]`: field input
// k at the point's own linear index.
//
// Built with -fmad=false and without fast math: every op rounds as the
// separate elementwise PyTorch kernels of the plain versions do.
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

// Field inputs of a kernel, passed by value (core/eval_classify.py holds
// the same limit and raises above it).
constexpr int MAX_FIELDS = 32;
template <typename T>
struct Fields {
  const T* p[MAX_FIELDS];
};

template <typename T>
__device__ __forceinline__ T sdf_point(T x, T y, T z, const T* __restrict__ P,
                                       const Fields<T>& F, int64_t fi) {
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

}  // namespace
