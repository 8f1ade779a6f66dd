// Helpers shared by the port's hand-written Hopper kernels.
//
// Built with nvcc -gencode arch=compute_90a,code=sm_90a and WITHOUT
// --use_fast_math: sqrtf/atan2f/sincosf/expf and float division stay the
// precise IEEE versions, so the kernels reproduce their plain PyTorch
// versions (encode codes bit for bit).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace rt {

constexpr float kNegInf = -1e30f;  // the masked-score sentinel of the JAX code
constexpr float kPi = 3.14159265358979323846f;  // float32(pi), as torch/JAX add it

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(unsigned char x) { return static_cast<float>(x); }

// Value rows come as fp32, bf16, or uint8 mid-tread codes that dequantize
// as code * scale + zero with one fp32 scale and zero per (token, kv head)
// row (QuantConfig.value_bits > 0). The C entries take the kind as an int.
enum ValueKind { kValueF32 = 0, kValueBF16 = 1, kValueU8 = 2 };
template <typename TV>
inline constexpr bool kQuantV = false;
template <>
inline constexpr bool kQuantV<unsigned char> = true;

// f(TV{}) with TV the value type of `kind`; cudaErrorInvalidValue for an
// unknown kind.
template <typename F>
inline int with_value_type(int kind, F&& f) {
  if (kind == kValueF32) return f(0.0f);
  if (kind == kValueBF16) return f(__nv_bfloat16{});
  if (kind == kValueU8) return f(static_cast<unsigned char>(0));
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Shared memory one block of the current device may opt into (232,448 B,
// 227 KB, on an H100); 0 when the query fails.
inline size_t smem_optin_bytes() {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
    return 0;
  return static_cast<size_t>(bytes);
}

// Opt a kernel into more than 48 KB of dynamic shared memory when asked.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace rt
