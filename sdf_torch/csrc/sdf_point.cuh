// The per-point SDF evaluation shared by the eval kernels: eval_classify.cu
// (dense grid, and the bounds refinement's probe grid), and the two kernels
// of eval_tiles.cu (active tiles, without and with precomputed field
// inputs).
//
// This is not a header that a compiler finds: core/eval_classify.py splices
// its text into each kernel source at the line that includes this file,
// with the body of `sdf_point` generated from the expression (one C++
// statement per recorded op) at the SDF_BODY mark, and the expression's
// parameter count and form at the SDF_PARAMS mark.  Parameter leaves are read
// as `P[k]`, not baked in as literals, so new parameter values reuse the
// compiled library.  Up to MAX_ARG_PARAMS of core/eval_classify.py they
// travel by value in the kernel's arguments, which the card keeps in its
// constant bank: a leaf is then an instruction operand, not a load.  A wider
// expression (the form is chosen when the source is generated, from its leaf
// count) reads them from device memory.  A statement that stands for a
// subtree evaluated ahead of the kernel (a gather the body cannot hold) reads
// `F.p[k][fi]`: field input k at the point's own linear index.
//
// Built with -fmad=false and without fast math: every op rounds as the
// separate elementwise PyTorch kernels of the plain versions do.
#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

//@SDF_PARAMS@

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
// Any power in float32; in float64 only 2 ** x: there the general pow
// differs from PyTorch's by an ulp now and then, so other float64 powers
// are fields (core/eval_classify.py Rec._pow).
__device__ __forceinline__ float op_pow(float a, float b) { return powf(a, b); }
__device__ __forceinline__ double op_pow(double a, double b) { return pow(a, b); }
__device__ __forceinline__ float op_exp2(float a) { return exp2f(a); }
__device__ __forceinline__ double op_exp2(double a) { return exp2(a); }
template <typename T>
__device__ __forceinline__ T op_sign(T a) {
  return T((T(0) < a) - (a < T(0)));
}

// The rest of the elementwise functions a user's expression may call, each
// the CUDA math library's function, as PyTorch's CUDA kernel of the op
// calls it.
#define SDF_UNARY_MATH(name, f32, f64)                                    \
  __device__ __forceinline__ float op_##name(float a) { return f32(a); } \
  __device__ __forceinline__ double op_##name(double a) { return f64(a); }
SDF_UNARY_MATH(tanh, tanhf, tanh)
SDF_UNARY_MATH(exp, expf, exp)
SDF_UNARY_MATH(expm1, expm1f, expm1)
SDF_UNARY_MATH(log, logf, log)
SDF_UNARY_MATH(log1p, log1pf, log1p)
SDF_UNARY_MATH(log2, log2f, log2)
SDF_UNARY_MATH(tan, tanf, tan)
SDF_UNARY_MATH(atan, atanf, atan)
SDF_UNARY_MATH(asin, asinf, asin)
SDF_UNARY_MATH(acos, acosf, acos)
SDF_UNARY_MATH(sinh, sinhf, sinh)
SDF_UNARY_MATH(cosh, coshf, cosh)
SDF_UNARY_MATH(floor, floorf, floor)
SDF_UNARY_MATH(ceil, ceilf, ceil)
SDF_UNARY_MATH(trunc, truncf, trunc)
SDF_UNARY_MATH(rsqrt, rsqrtf, rsqrt)
#undef SDF_UNARY_MATH
__device__ __forceinline__ float op_hypot(float a, float b) { return hypotf(a, b); }
__device__ __forceinline__ double op_hypot(double a, double b) { return hypot(a, b); }

// torch.remainder (ATen's remainder_kernel_cuda): fmod, moved to the
// divisor's sign.
template <typename T>
__device__ __forceinline__ T op_remainder(T a, T b) {
  T mod = op_fmod(a, b);
  if ((mod != T(0)) && ((b < T(0)) != (mod < T(0)))) mod += b;
  return mod;
}

// The rounding of a floor division's quotient (c10::div_floor_floating).
template <typename T>
__device__ __forceinline__ T floor_of_quotient(T div, T a_over_b) {
  if (div == T(0)) return copysign(T(0), a_over_b);
  T floordiv = floor(div);
  if (div - floordiv > T(0.5)) floordiv += T(1);
  return floordiv;
}

// torch.floor_divide by a tensor: c10::div_floor_floating.
template <typename T>
__device__ __forceinline__ T op_floordiv(T a, T b) {
  if (b == T(0)) return a / b;
  T mod = op_fmod(a, b);
  T div = (a - mod) / b;
  if ((mod != T(0)) && ((b < T(0)) != (mod < T(0)))) div -= T(1);
  return floor_of_quotient(div, a / b);
}

// torch.floor_divide by a Python number b != 0 (ATen's div_floor_kernel_cuda
// with a CPU scalar divisor): the quotient is a product with 1 / b.
template <typename T>
__device__ __forceinline__ T op_floordiv_number(T a, T b) {
  const T inv_b = T(1) / b;
  T mod = op_fmod(a, b);
  T div = (a - mod) * inv_b;
  if ((mod != T(0)) && ((b < T(0)) != (mod < T(0)))) div -= T(1);
  return floor_of_quotient(div, a * inv_b);
}

// torch.lerp (ATen's at::native::lerp): two branches on the weight's size,
// each a multiply-add that PyTorch's build contracts into an FMA.
template <typename T>
__device__ __forceinline__ T op_lerp(T a, T b, T w) {
  return (op_abs(w) < T(0.5)) ? fma(w, b - a, a) : fma(-(b - a), T(1) - w, b);
}

// The expression's parameters: SDF_NPARAMS values, by value in the kernel
// arguments (declare the kernel's argument __grid_constant__ so the body
// reads it in place) or, when SDF_PARAMS_IN_ARGS is 0, a device pointer.
template <typename T>
struct Params {
#if SDF_PARAMS_IN_ARGS
  T p[SDF_NPARAMS > 0 ? SDF_NPARAMS : 1];
  __device__ __forceinline__ T operator[](int k) const { return p[k]; }
#else
  const T* __restrict__ p;
  __device__ __forceinline__ T operator[](int k) const { return __ldg(p + k); }
#endif
};

// Params from the wrapper's argument: the host address of the values when
// they travel in the arguments, else their device address.
template <typename T>
Params<T> params_from(const void* P) {
  Params<T> out;
#if SDF_PARAMS_IN_ARGS
  std::memcpy(out.p, P, sizeof(T) * SDF_NPARAMS);
#else
  out.p = (const T*)P;
#endif
  return out;
}

// Field inputs of a kernel, passed by value (core/eval_classify.py holds
// the same limit and raises above it); the body reads SDF_NFIELDS of them.
constexpr int MAX_FIELDS = 32;
template <typename T>
struct Fields {
  const T* p[MAX_FIELDS];
};

template <typename T>
__device__ __forceinline__ T sdf_point(T x, T y, T z, const Params<T>& P,
                                       const Fields<T>& F, int64_t fi) {
//@SDF_BODY@
}

}  // namespace
