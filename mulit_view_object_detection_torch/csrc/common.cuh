// Shared helpers of the port's CUDA kernels: element type conversions and
// the float32 -> element type cast that ends each backward kernel.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace mvod {

template <typename T>
__device__ __forceinline__ float to_float(T v);

template <>
__device__ __forceinline__ float to_float<float>(float v) { return v; }

template <>
__device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);

template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }

template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

constexpr int kThreads = 256;

inline unsigned int blocks_for(long long total) {
  return static_cast<unsigned int>((total + kThreads - 1) / kThreads);
}

template <typename T>
__global__ void cast_from_f32_kernel(const float* __restrict__ src,
                                     T* __restrict__ dst, long long total) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < total) dst[i] = from_float<T>(src[i]);
}

// Write the float32 accumulator `src` into `dst` in type T: nothing to do
// for float32 when dst is src, else one elementwise pass on `stream`.
template <typename T>
inline cudaError_t cast_from_f32(const float* src, void* dst,
                                 long long total, cudaStream_t stream) {
  if (total == 0 || static_cast<const void*>(src) == dst) return cudaSuccess;
  cast_from_f32_kernel<T><<<blocks_for(total), kThreads, 0, stream>>>(
      src, static_cast<T*>(dst), total);
  return cudaGetLastError();
}

}  // namespace mvod
