// Kernel L1: batched 3D connected-component labelling of the two sign
// classes of a sampled trilinear, the dense topology oracle of the lewiner
// table builder (sdf_torch/core/mc33_build.py `label_corners`).
//
// Replaces: scipy.ndimage.label (host), called twice in
// sdf_tpu/core/mc33_build.py `loop_partition` (on `f < 0` and on
// `f >= 0`, 6-connectivity).  No TPU kernel computed it: the JAX package
// labels on the host.
//
// Contract, for each of B realizations with trilinear coefficients k[b]
// (8 float64, mc33_build.trilinear_coeffs) on the grid t (n float64,
// numpy's linspace(0, 1, n)):
//   * f at voxel (i, j, l), flat index (i * n + j) * n + l, is
//     k0 + k1 x + k2 y + k3 z + (k4 x) y + (k5 x) z + (k6 y) z + ((k7 x) y) z
//     with x = t[i], y = t[j], z = t[l], summed left to right: numpy's
//     `trilinear_eval` op for op (built with -fmad=false, so no product is
//     fused into an add and `f < 0` is numpy's bit for bit);
//   * a voxel's class is f < 0; two voxels of one class that differ by one
//     in one index are connected (scipy's default structure);
//   * a voxel's label is the smallest flat index of its component;
//   * out_cls[b, c] / out_lab[b, c] are the class and label of cube corner
//     c (CORNER_OFFSETS order: (0,0,0), (1,0,0), (1,1,0), (0,1,0), then the
//     same at z = 1), i.e. the voxel (ox, oy, oz) * (n - 1).
// The class and label volumes (1 + 4 bytes a voxel) are the caller's
// workspace and stay on the card; only the 8 corners come back.
//
// Bound on the card: memory traffic, the label volume written once (4
// bytes a voxel) against 3.35 TB/s; the evaluation, 19 float64 operations a
// voxel, is below it at 34 TFLOP/s.
//
// Design: union-find in four launches over the flattened B x n^3 voxels,
// one thread a voxel (Playne & Hawick, "A New Algorithm for Parallel
// Connected-Component Labelling on GPUs", IEEE TPDS 2018; the find with
// intermediate pointer jumping and the hook by compare-and-swap of ECL-CC,
// Jaiganesh & Burtscher, HPDC 2018):
//   1. eval: f and the class byte;
//   2. init: the z runs, one warp ballot of run starts: each voxel points
//      at the first voxel of its run in its warp (the run's start in its
//      own warp is a root), so a run's tree is at most n / 32 + 1 deep;
//   3. merge: each voxel unites with its same-class y - 1 and x - 1
//      neighbours, where the pair of z - 1 neighbours does not join the
//      same two runs already.
//      A root only ever points at itself, a pointer only ever at a smaller
//      index of its own component, and a hook is a compare-and-swap of a
//      root to the smaller root, so every tree's root is its component's
//      smallest index: the labels are canonical, and equal the plain
//      version's bit for bit whatever order the threads run in.  Reads of
//      the parent array bypass L1 (__ldcg), which other SMs do not see;
//   4. compress: every voxel takes its root; the 8 corner voxels write the
//      outputs.
// A simple correct kernel: no shared-memory pre-labelling of blocks.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NTHREADS = 256;

__device__ __forceinline__ int find(int* L, int v) {
  int par = __ldcg(L + v);
  if (par != v) {
    int prev = v, next;
    while (par > (next = __ldcg(L + par))) {
      __stcg(L + prev, next);
      prev = par;
      par = next;
    }
  }
  return par;
}

__device__ __forceinline__ void unite(int* L, int a, int b) {
  a = find(L, a);
  b = find(L, b);
  while (a != b) {
    if (a > b) {
      const int s = a;
      a = b;
      b = s;
    }
    const int old = atomicCAS(L + b, b, a);
    if (old == b) return;
    b = find(L, old);
    a = find(L, a);
  }
}

__global__ void __launch_bounds__(NTHREADS)
eval_kernel(const double* __restrict__ k, const double* __restrict__ t,
            int n, int64_t total, uint8_t* __restrict__ cls) {
  const int64_t idx = (int64_t)blockIdx.x * NTHREADS + threadIdx.x;
  if (idx >= total) return;
  const int64_t N = (int64_t)n * n * n;
  const int64_t b = idx / N;
  const int r = (int)(idx - b * N);
  const double x = t[r / (n * n)];
  const double y = t[(r / n) % n];
  const double z = t[r % n];
  const double* c = k + 8 * b;
  double f = c[0] + c[1] * x;
  f = f + c[2] * y;
  f = f + c[3] * z;
  f = f + (c[4] * x) * y;
  f = f + (c[5] * x) * z;
  f = f + (c[6] * y) * z;
  f = f + ((c[7] * x) * y) * z;
  cls[idx] = f < 0.0;
}

__global__ void __launch_bounds__(NTHREADS)
init_kernel(const uint8_t* __restrict__ cls, int n, int64_t total,
            int* __restrict__ lab) {
  // A warp holds 32 consecutive voxels, along z within a row.  A voxel
  // whose z - 1 neighbour is of its class continues that neighbour's run;
  // it points at the run's first voxel in the warp, or, when the run
  // enters the warp from the one before, at the voxel before lane 0.
  const int64_t idx = (int64_t)blockIdx.x * NTHREADS + threadIdx.x;
  const bool valid = idx < total;
  const int64_t N = (int64_t)n * n * n;
  const int64_t base = valid ? idx / N * N : 0;
  const int r = (int)(idx - base);
  const uint8_t c = valid ? cls[idx] : 0;
  const bool cont = valid && r % n && cls[idx - 1] == c;
  const unsigned starts = __ballot_sync(0xffffffffu, !cont);
  if (!valid) return;
  const int lane = threadIdx.x & 31;
  const unsigned upto = starts & (0xffffffffu >> (31 - lane));
  lab[idx] = upto ? r - (lane - (31 - __clz(upto))) : r - lane - 1;
}

__global__ void __launch_bounds__(NTHREADS)
merge_kernel(const uint8_t* __restrict__ cls, int n, int64_t total,
             int* lab) {
  // The z edges are in the init's trees.  A y (x) edge joins two z runs;
  // when the z - 1 neighbours of both ends are of the class too, the
  // edge between those joins the same two runs, so only the first voxel
  // of each such stretch unites.
  const int64_t idx = (int64_t)blockIdx.x * NTHREADS + threadIdx.x;
  if (idx >= total) return;
  const int64_t N = (int64_t)n * n * n;
  const int64_t base = idx / N * N;
  const int r = (int)(idx - base);
  const int nn = n * n;
  int* L = lab + base;
  const uint8_t c = cls[idx];
  const bool zprev = r % n && cls[idx - 1] == c;
  if ((r / n) % n && cls[idx - n] == c && !(zprev && cls[idx - n - 1] == c))
    unite(L, r, r - n);
  if (r >= nn && cls[idx - nn] == c && !(zprev && cls[idx - nn - 1] == c))
    unite(L, r, r - nn);
}

__global__ void __launch_bounds__(NTHREADS)
compress_kernel(const uint8_t* __restrict__ cls, int n, int64_t total,
                int* lab, uint8_t* __restrict__ out_cls,
                int* __restrict__ out_lab) {
  const int64_t idx = (int64_t)blockIdx.x * NTHREADS + threadIdx.x;
  if (idx >= total) return;
  const int64_t N = (int64_t)n * n * n;
  const int64_t b = idx / N;
  const int r = (int)(idx - b * N);
  int* L = lab + b * N;
  const int root = find(L, r);
  L[r] = root;
  const int i = r / (n * n), j = (r / n) % n, l = r % n;
  const int m = n - 1;
  if ((i == 0 || i == m) && (j == 0 || j == m) && (l == 0 || l == m)) {
    // CORNER_OFFSETS: (x, y) = (0,0), (1,0), (1,1), (0,1) at z = 0, then z = 1
    const int ox = i == m, oy = j == m;
    const int corner = 4 * (l == m) + (oy ? 3 - ox : ox);
    out_cls[8 * b + corner] = cls[idx];
    out_lab[8 * b + corner] = root;
  }
}

}  // namespace

// k: (nb, 8) float64; t: (n,) float64, n >= 2; cls (nb * n^3 bytes) and
// lab (nb * n^3 int32) workspace; out_cls (nb, 8) uint8, out_lab (nb, 8)
// int32.  Returns the first CUDA error of the four launches, or 0.
extern "C" int sdf_label3d(const void* k, const void* t, int n, int nb,
                           void* cls, void* lab, void* out_cls, void* out_lab,
                           void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t total = (int64_t)nb * n * n * n;
  const unsigned blocks = (unsigned)((total + NTHREADS - 1) / NTHREADS);
  eval_kernel<<<blocks, NTHREADS, 0, s>>>(
      (const double*)k, (const double*)t, n, total, (uint8_t*)cls);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  init_kernel<<<blocks, NTHREADS, 0, s>>>((const uint8_t*)cls, n, total,
                                          (int*)lab);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  merge_kernel<<<blocks, NTHREADS, 0, s>>>((const uint8_t*)cls, n, total,
                                           (int*)lab);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  compress_kernel<<<blocks, NTHREADS, 0, s>>>(
      (const uint8_t*)cls, n, total, (int*)lab, (uint8_t*)out_cls,
      (int*)out_lab);
  return (int)cudaGetLastError();
}
