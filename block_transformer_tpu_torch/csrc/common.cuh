// Helpers shared by the hand-written kernels: conversions between the
// activation type (float or bf16) and the float32 the kernels compute in.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace bt {

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Round to nearest even, as torch's .to(torch.bfloat16) does.
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// The value a float takes after a round trip through T (the reference casts
// softmax probabilities to the activation type before the P.V product).
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f32<T>(from_f32<T>(v));
}

constexpr float kNeg = -1e30f;   // the masked score, as in ops/masks.py

}  // namespace bt
