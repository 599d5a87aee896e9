// Shared helpers for the port's hand-written Hopper kernels.
//
// Every kernel takes a dtype code from its Python wrapper (0 = float32,
// 1 = bfloat16) and is instantiated for both element types.  Arithmetic is
// float32 throughout; only loads and stores touch the storage type.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro {

enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

constexpr float kNeg = -1e30f;  // the JAX kernels' masked-logit value

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Opt a kernel into more than the default 48 KB of dynamic shared memory.
// Idempotent and cheap; called before every launch that may need it.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace repro
