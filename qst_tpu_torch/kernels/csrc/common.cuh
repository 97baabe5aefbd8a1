// Shared helpers for the port's hand-written Hopper kernels.
//
// Every C entry point is `extern "C"`, launches on the stream it is given,
// allocates nothing, and returns cudaGetLastError() after each launch, so the
// Python wrapper can raise on a launch the runtime refused.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define QST_RETURN_IF_LAUNCH_FAILED()                 \
  do {                                                \
    cudaError_t qst_err_ = cudaGetLastError();        \
    if (qst_err_ != cudaSuccess) return (int)qst_err_; \
  } while (0)

// dtype codes shared with the Python wrappers (kernels/build.py DTYPE_CODES)
enum QstDType { QST_F32 = 0, QST_BF16 = 1, QST_I8 = 2 };

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's .to(bf16)
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ int warp_sum_int(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
