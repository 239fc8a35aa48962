// Shared helpers of the port's hand-written kernels: element conversion
// between the storage types the wrappers accept and float, and the dtype
// codes of the plain C interface (0 = float32, 1 = bfloat16, 2 = float16).
#pragma once
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace morph {

enum DType { kF32 = 0, kBF16 = 1, kF16 = 2 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's cast
}
template <> __device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

}  // namespace morph

// Name of a CUDA error code, for the wrappers' messages. Each library is
// built from one source file, so this definition is linked once per library.
extern "C" const char* morph_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Expands to a switch over one dtype code, binding the C++ type to NAME.
#define MORPH_DISPATCH_DTYPE(CODE, NAME, ...)                     \
  switch (CODE) {                                                 \
    case morph::kF32: { using NAME = float; __VA_ARGS__; break; } \
    case morph::kBF16: { using NAME = __nv_bfloat16; __VA_ARGS__; break; } \
    case morph::kF16: { using NAME = __half; __VA_ARGS__; break; } \
    default: return cudaErrorInvalidValue;                        \
  }
