// Shared helpers for the port's hand-written Hopper kernels: element
// conversion to and from fp32 (all arithmetic is fp32), a warp sum, a
// strided dot product in four partial sums, and the dtype codes the ctypes wrappers pass (0 = float32, 1 = bfloat16).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define REPRO_NEG_INF (-1e30f)

enum ReproDtype { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's cast
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// sum_k a[k * sa] * b[k * sb] over k < n in four interleaved partial sums,
// added pairwise: for the long cancelling dot products of the scans this
// rounds about half as much as one running sum, and the four chains are
// independent (instruction-level parallelism).
__device__ __forceinline__ float strided_dot(const float* a, int sa,
                                             const float* b, int sb, int n) {
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
  const int sa2 = 2 * sa, sa3 = 3 * sa, sb2 = 2 * sb, sb3 = 3 * sb;
  int k = 0;
  for (; k + 4 <= n; k += 4, a += 4 * sa, b += 4 * sb) {
    s0 += a[0] * b[0];
    s1 += a[sa] * b[sb];
    s2 += a[sa2] * b[sb2];
    s3 += a[sa3] * b[sb3];
  }
  for (; k < n; ++k, a += sa, b += sb) s0 += a[0] * b[0];
  return (s0 + s1) + (s2 + s3);
}

// Dynamic shared memory above the 48 KB default needs an opt-in per kernel;
// the attribute is raised only when a launch needs more than the last one
// (`granted` is per kernel instantiation), so steady-state launches, and
// launches inside a CUDA-graph capture, make no attribute call.
template <typename K>
static cudaError_t allow_smem(K kernel, size_t bytes, size_t* granted) {
  if (bytes <= 48 * 1024 || bytes <= *granted) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err == cudaSuccess) *granted = bytes;
  return err;
}
