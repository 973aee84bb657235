// Session probes: the float32 mul-add rate, the sqrt rate and the
// device-memory copy rate this card reaches, measured in the same session as
// the eval they normalize (sdf_torch/utils/weather.py `probe_rates`).
//
// Replaces: no TPU kernel.  The JAX package's probes are XLA fusions
// (sdf_tpu/utils/weather.py `probe_rates`: the jitted `muladd` and `sqrts`
// chains and the jitted `v + 1.0` copy); XLA runs each chain as one fused
// kernel, which is what gives a probe its meaning.  PyTorch eager would run
// a 64-step chain as 128 kernels and measure memory traffic instead of
// arithmetic, so each probe is one kernel here.
//
//   muladd: acc = x[i] + y[j] + z[k], then CHAIN steps of
//           acc = acc * 1.0000001f + y[j]; one write a point.
//   sqrts:  acc = |x[i] + y[j] + z[k]| + 1, then SQ steps of
//           acc = sqrt(acc) + 1; one write a point.
//   copy:   out = v + 1 over a flat buffer.
//
// Built like every kernel of the port, with -fmad=false and no fast math:
// `acc * c + y` stays a multiply and an add (FMUL, FADD), as the eval
// bodies issue them, and sqrtf is the correctly rounded square root.  So
// the mul-add probe measures the rate of the arithmetic the eval kernels
// actually issue, at most about half of the 67 TFLOP/s float32 peak, which
// counts a fused multiply-add as 2 flops.  A step counts 2 flops here, as
// the JAX probe counts it.
//
// Bound on the card: muladd and sqrts by operations (2 x CHAIN flops or SQ
// square roots a point against 4 bytes written), copy by bytes (4 read and
// 4 written a value).
//
// Launch plan, not tuned:
//   * muladd, sqrts: one thread a point of the (nx, ny, nz) grid, blocks of
//     NTHREADS; a thread finds (i, j, k) from its flat index with two 32-bit
//     divisions and reads the three 1-D axes itself (the broadcast happens
//     in the kernel).  A chain is one dependent op after another, so the
//     rate comes from the warps resident: up to 8 blocks of 256 on an SM,
//     64 warps, 16 for each of its 4 schedulers.
//   * copy: one 16-byte vector a thread when both pointers are 16-byte
//     aligned, then one value a thread for the n mod 4 left (all values one
//     at a time for a misaligned view).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NTHREADS = 256;
constexpr int CHAIN = 64;  // utils/weather.py _CHAIN
constexpr int SQ = 32;     // utils/weather.py _SQ

__global__ void __launch_bounds__(NTHREADS)
muladd_kernel(const float* __restrict__ x, const float* __restrict__ y,
              const float* __restrict__ z, uint32_t ny, uint32_t nz,
              uint32_t n, float* __restrict__ out) {
  const uint32_t p = blockIdx.x * NTHREADS + threadIdx.x;
  if (p >= n) return;
  const uint32_t k = p % nz;
  const uint32_t ij = p / nz;
  const float yj = y[ij % ny];
  float acc = x[ij / ny] + yj + z[k];
#pragma unroll
  for (int s = 0; s < CHAIN; ++s) acc = acc * 1.0000001f + yj;
  out[p] = acc;
}

__global__ void __launch_bounds__(NTHREADS)
sqrts_kernel(const float* __restrict__ x, const float* __restrict__ y,
             const float* __restrict__ z, uint32_t ny, uint32_t nz,
             uint32_t n, float* __restrict__ out) {
  const uint32_t p = blockIdx.x * NTHREADS + threadIdx.x;
  if (p >= n) return;
  const uint32_t k = p % nz;
  const uint32_t ij = p / nz;
  float acc = fabsf(x[ij / ny] + y[ij % ny] + z[k]) + 1.0f;
#pragma unroll
  for (int s = 0; s < SQ; ++s) acc = sqrtf(acc) + 1.0f;
  out[p] = acc;
}

__global__ void __launch_bounds__(NTHREADS)
copy_kernel(const float* __restrict__ in, int64_t n, int64_t nvec,
            float* __restrict__ out) {
  const int64_t t = (int64_t)blockIdx.x * NTHREADS + threadIdx.x;
  if (t < nvec) {
    float4 v = ((const float4*)in)[t];
    v.x += 1.0f;
    v.y += 1.0f;
    v.z += 1.0f;
    v.w += 1.0f;
    ((float4*)out)[t] = v;
    return;
  }
  const int64_t i = 4 * nvec + (t - nvec);
  if (i < n) out[i] = in[i] + 1.0f;
}

bool grid_ok(int nx, int ny, int nz) {
  return nx >= 1 && ny >= 1 && nz >= 1 &&
         (int64_t)nx * ny * nz < ((int64_t)1 << 32) - NTHREADS;
}

}  // namespace

// x (nx,), y (ny,), z (nz,) float32 -> out (nx, ny, nz) float32; `chain`
// must be CHAIN (the caller's constant, checked against the kernel's).
extern "C" int sdf_probe_muladd(const void* x, const void* y, const void* z,
                                int nx, int ny, int nz, int chain, void* out,
                                void* stream) {
  if (!grid_ok(nx, ny, nz) || chain != CHAIN) {
    return (int)cudaErrorInvalidValue;
  }
  const uint32_t n = (uint32_t)nx * ny * nz;
  muladd_kernel<<<(n + NTHREADS - 1) / NTHREADS, NTHREADS, 0,
                  (cudaStream_t)stream>>>(
      (const float*)x, (const float*)y, (const float*)z, ny, nz, n,
      (float*)out);
  return (int)cudaGetLastError();
}

// As sdf_probe_muladd; `chain` must be SQ.
extern "C" int sdf_probe_sqrts(const void* x, const void* y, const void* z,
                               int nx, int ny, int nz, int chain, void* out,
                               void* stream) {
  if (!grid_ok(nx, ny, nz) || chain != SQ) {
    return (int)cudaErrorInvalidValue;
  }
  const uint32_t n = (uint32_t)nx * ny * nz;
  sqrts_kernel<<<(n + NTHREADS - 1) / NTHREADS, NTHREADS, 0,
                 (cudaStream_t)stream>>>(
      (const float*)x, (const float*)y, (const float*)z, ny, nz, n,
      (float*)out);
  return (int)cudaGetLastError();
}

// n float32 values -> out = in + 1; `nvec` 16-byte vectors first (0 unless
// both pointers are 16-byte aligned), then one value a thread.
extern "C" int sdf_probe_copy(const void* in, int64_t n, int64_t nvec,
                              void* out, void* stream) {
  if (n < 1 || nvec < 0 || 4 * nvec > n ||
      (nvec > 0 && ((uintptr_t)in % 16 != 0 || (uintptr_t)out % 16 != 0))) {
    return (int)cudaErrorInvalidValue;
  }
  const int64_t threads = nvec + (n - 4 * nvec);
  const int64_t blocks = (threads + NTHREADS - 1) / NTHREADS;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  copy_kernel<<<(unsigned)blocks, NTHREADS, 0, (cudaStream_t)stream>>>(
      (const float*)in, n, nvec, (float*)out);
  return (int)cudaGetLastError();
}
