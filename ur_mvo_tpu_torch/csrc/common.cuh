// Shared helpers for the port's CUDA kernels (compiled for sm_90a).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace urmvo {

// Element types the kernels take: DT_F32 = float, DT_BF16 = __nv_bfloat16.
enum DType { DT_F32 = 0, DT_BF16 = 1 };

template <typename T>
__device__ __forceinline__ float to_f(T x);
template <>
__device__ __forceinline__ float to_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) { return __float2bfloat16_rn(x); }

// x rounded to T and back: where the TPU kernel casts to bf16 mid-stage.
template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_f<T>(from_f<T>(x)); }

}  // namespace urmvo
