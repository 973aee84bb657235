// The per-cell body of kernel B2 (extended-case classification), shared by
// the two entry points of classify_ext.cu and by the one-cell probe of
// `chip_smoke.py --ptxas`, which counts its SASS instructions.
//
// THE ORDER OF EVALUATION IS THE CONTRACT.  `interior_code` is
// core/mc33_build.py `interior_flags` term for term with every parenthesis
// kept; built with -fmad=false and without fast math (IEEE sqrt and
// division), so each operation rounds as the separate elementwise PyTorch
// kernels of the plain version do and the ext grid is bit-equal to it.
// Decisions sit behind 64-ulp guards, but only equal arithmetic makes equal
// codes on the cells that land on a guard.  NaN and inf reach this code (an
// ellipsoid's centre is 0/0): every comparison with NaN is false, as in the
// plain version; the one maximum (`clamp0`) passes NaN on as torch.clamp
// does, which fmax would not; the sign select of the quadratic formula is a
// select, not copysign.
//
// classify_ext.cu is built with this text spliced in at its include line
// (core/mc33.py kernel_source), so the library is named by one text.
#include <cstdint>

namespace {

__device__ __forceinline__ float t_abs(float a) { return fabsf(a); }
__device__ __forceinline__ double t_abs(double a) { return fabs(a); }
__device__ __forceinline__ float t_sqrt(float a) { return sqrtf(a); }
__device__ __forceinline__ double t_sqrt(double a) { return sqrt(a); }
// torch.clamp(x, min=0): NaN propagates.
__device__ __forceinline__ float clamp0(float a) {
  return (a != a) ? a : fmaxf(a, 0.0f);
}
__device__ __forceinline__ double clamp0(double a) {
  return (a != a) ? a : fmax(a, 0.0);
}
// GUARD_ULPS (64) times the machine epsilon of the type.
__device__ __forceinline__ float guard_of(float) {
  return 64.0f * 1.1920928955078125e-07f;
}
__device__ __forceinline__ double guard_of(double) {
  return 64.0 * 2.220446049250313e-16;
}

__device__ __forceinline__ int32_t ext_combine(int32_t cas, int32_t extra,
                                               const int32_t* tab) {
  int32_t ext = 0;
  if (cas >= 0 && cas < 256) {
    ext = tab[cas];
#pragma unroll
    for (int f = 0; f < 6; ++f)
      if ((extra >> f) & 1) ext += tab[256 + cas * 6 + f];
  }
  return ext + ((extra >> 6) & 15);
}

template <typename T>
struct Coef {
  T c000, k1, k2, k3, k4, k5, k6, k7, g;
};

// One root z = num / den of the critical-point quadratic: flags[0..3] |=
// (neg1, pos1, neg2, pos2).  The loop body of interior_flags.
template <typename T>
__device__ __forceinline__ void root_flags(const Coef<T>& k, T num, T den,
                                           T errnum, T errden, bool has_roots,
                                           bool* flags) {
  const T g = k.g;
  const bool root_ok = has_roots && (t_abs(den) > errden);
  const T dsafe = (den == T(0)) ? T(1) : den;
  const T z = num / dsafe;
  const T errz = (errnum + t_abs(z) * errden) / t_abs(dsafe);

  const T dd = k.k4 + k.k7 * z;
  const T errdd = g * (t_abs(k.k4) + t_abs(k.k7 * z)) + t_abs(k.k7) * errz;
  const bool dd_ok = t_abs(dd) > errdd;
  const T ddsafe = (dd == T(0)) ? T(1) : dd;
  const T y = -(k.k1 + k.k5 * z) / ddsafe;
  const T x = -(k.k2 + k.k6 * z) / ddsafe;
  const T erry = (g * (t_abs(k.k1) + t_abs(k.k5 * z)) + t_abs(k.k5) * errz +
                  t_abs(y) * errdd) /
                 t_abs(ddsafe);
  const T errx = (g * (t_abs(k.k2) + t_abs(k.k6 * z)) + t_abs(k.k6) * errz +
                  t_abs(x) * errdd) /
                 t_abs(ddsafe);

  const T fv = k.c000 + k.k1 * x + k.k2 * y + k.k3 * z + k.k4 * (x * y) +
               k.k5 * (x * z) + k.k6 * (y * z) + k.k7 * ((x * y) * z);
  const T fmag = t_abs(k.c000) + t_abs(k.k1 * x) + t_abs(k.k2 * y) +
                 t_abs(k.k3 * z) + t_abs(k.k4 * (x * y)) +
                 t_abs(k.k5 * (x * z)) + t_abs(k.k6 * (y * z)) +
                 t_abs(k.k7 * ((x * y) * z));
  const T gx = t_abs(k.k1) + t_abs(k.k4 * y) + t_abs(k.k5 * z) +
               t_abs(k.k7 * (y * z));
  const T gy = t_abs(k.k2) + t_abs(k.k4 * x) + t_abs(k.k6 * z) +
               t_abs(k.k7 * (x * z));
  const T gz = t_abs(k.k3) + t_abs(k.k5 * x) + t_abs(k.k6 * y) +
               t_abs(k.k7 * (x * y));
  const T tolfv = g * fmag + gx * errx + gy * erry + gz * errz;

  const bool ok = root_ok && dd_ok && (x > errx) && (x < T(1) - errx) &&
                  (y > erry) && (y < T(1) - erry) && (z > errz) &&
                  (z < T(1) - errz);
  // Saddle index: sign of det H = 2 a b c (a = dd), guarded.
  const T bb = k.k5 + k.k7 * y;
  const T cc = k.k6 + k.k7 * x;
  const T errbb = g * (t_abs(k.k5) + t_abs(k.k7 * y)) + t_abs(k.k7) * erry;
  const T errcc = g * (t_abs(k.k6) + t_abs(k.k7 * x)) + t_abs(k.k7) * errx;
  const T det = dd * bb * cc;
  const T errdet = t_abs(bb * cc) * errdd + t_abs(dd * cc) * errbb +
                   t_abs(dd * bb) * errcc + (T(2) * g) * t_abs(det);
  const bool idx2 = det > errdet;
  const bool fneg = ok && (fv < -tolfv);
  const bool fpos = ok && (fv > tolfv);
  flags[0] = flags[0] || (fneg && !idx2);
  flags[1] = flags[1] || (fpos && !idx2);
  flags[2] = flags[2] || (fneg && idx2);
  flags[3] = flags[3] || (fpos && idx2);
}

// ibits9 = s1 + 3 * s2 in [0, 9) from the 8 corner values (CORNER_OFFSETS
// order: c000 c100 c110 c010 c001 c101 c111 c011).
template <typename T>
__device__ __forceinline__ int interior_code(const T* c) {
  Coef<T> k;
  k.c000 = c[0];
  k.k1 = c[1] - c[0];
  k.k2 = c[3] - c[0];
  k.k3 = c[4] - c[0];
  k.k4 = c[2] - c[0] - k.k1 - k.k2;
  k.k5 = c[5] - c[0] - k.k1 - k.k3;
  k.k6 = c[7] - c[0] - k.k2 - k.k3;
  k.k7 = c[6] - c[0] - k.k1 - k.k2 - k.k3 - k.k4 - k.k5 - k.k6;
  const T g = guard_of(T(0));
  k.g = g;

  const T m = k.k3 * k.k7 - k.k5 * k.k6;
  const T sm = t_abs(k.k3 * k.k7) + t_abs(k.k5 * k.k6);
  const T A = k.k7 * m;
  const T B = T(2) * (k.k4 * m);
  const T C = k.k3 * (k.k4 * k.k4) - k.k4 * (k.k2 * k.k5 + k.k1 * k.k6) +
              k.k7 * (k.k1 * k.k2);
  const T errA = g * (t_abs(k.k7) * sm);
  const T errB = (T(2) * g) * (t_abs(k.k4) * sm);
  const T errC = g * (t_abs(k.k3 * (k.k4 * k.k4)) + t_abs(k.k4 * (k.k2 * k.k5)) +
                      t_abs(k.k4 * (k.k1 * k.k6)) + t_abs(k.k7 * (k.k1 * k.k2)));

  const T disc = B * B - T(4) * (A * C);
  const T errdisc = g * (B * B + T(4) * t_abs(A * C)) +
                    (T(2) * t_abs(B)) * errB +
                    T(4) * (t_abs(A) * errC + t_abs(C) * errA);
  const bool degen = t_abs(disc) <= errdisc;
  const bool has_roots = degen || (disc > T(0));
  const T sq = degen ? T(0) : t_sqrt(clamp0(disc));
  const T dsq = T(2) * sq + t_sqrt(errdisc);
  const T errsq = errdisc / ((dsq == T(0)) ? T(1) : dsq);
  // sign(B == +-0) -> +sq: a plain select, not copysign
  const T q = T(-0.5) * (B + ((B < T(0)) ? -sq : sq));
  const T errq = T(0.5) * (errB + errsq);

  bool flags[4] = {false, false, false, false};
  root_flags<T>(k, q, A, errq, errA, has_roots, flags);
  root_flags<T>(k, C, q, errC, errq, has_roots, flags);
  const int s1 = flags[0] ? 1 : (flags[1] ? 2 : 0);
  const int s2 = flags[2] ? 1 : (flags[3] ? 2 : 0);
  return s1 + 3 * s2;
}

// Lewiner's face test on a face's corner values, CCW from outside: joined iff
// (a c - b d) and (a + c - b - d) have opposite signs.
template <typename T>
__device__ __forceinline__ int32_t face_joined(T a, T b, T cc, T dd) {
  return (((a * cc - b * dd) * (a + cc - b - dd)) < T(0)) ? 1 : 0;
}

// facebits | ibits9 << 6 (core/mc33.py extra_bits); the faces' corners are
// core/mc_tables.py _FACES.
template <typename T>
__device__ __forceinline__ int32_t extra_bits(const T* c) {
  const int32_t fb = face_joined(c[0], c[3], c[2], c[1])           // z = 0
                     | (face_joined(c[4], c[5], c[6], c[7]) << 1)  // z = 1
                     | (face_joined(c[0], c[1], c[5], c[4]) << 2)  // y = 0
                     | (face_joined(c[3], c[7], c[6], c[2]) << 3)  // y = 1
                     | (face_joined(c[0], c[4], c[7], c[3]) << 4)  // x = 0
                     | (face_joined(c[1], c[2], c[6], c[5]) << 5); // x = 1
  return fb | (interior_code<T>(c) << 6);
}

}  // namespace
