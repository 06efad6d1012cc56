// Shared helpers of the port's CUDA kernels: element type conversions,
// 16-byte channel groups, and the float32 -> element type cast that ends
// the unprojection's backward.
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

// 16 bytes of T as floats and back: 4 float32 or 8 bfloat16 (element 0 in
// the low half of the first word). bf16 -> float is exact; float -> bf16
// rounds to nearest even, as from_float does.
template <typename T>
struct Vec16;

template <>
struct Vec16<float> {
  static constexpr int kN = 4;
  __device__ static void unpack(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  __device__ static uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};

template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ static void unpack(const uint4& u, float* f) {
    const unsigned int w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      f[2 * k] = __uint_as_float(w[k] << 16);
      f[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  }
  __device__ static unsigned int bits(float v) {
    return static_cast<unsigned int>(
        __bfloat16_as_ushort(__float2bfloat16_rn(v)));
  }
  __device__ static uint4 pack(const float* f) {
    unsigned int w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      w[k] = bits(f[2 * k]) | (bits(f[2 * k + 1]) << 16);
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

template <typename T, int kVec>
__device__ __forceinline__ void load_vec(const T* __restrict__ src,
                                         float* f) {
  if constexpr (kVec == 1)
    f[0] = to_float(*src);
  else
    Vec16<T>::unpack(__ldg(reinterpret_cast<const uint4*>(src)), f);
}

template <typename T, int kVec>
__device__ __forceinline__ void store_vec(T* dst, const float* f) {
  if constexpr (kVec == 1)
    *dst = from_float<T>(f[0]);
  else
    *reinterpret_cast<uint4*>(dst) = Vec16<T>::pack(f);
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
