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

// ---------------------------------------------------------------------------
// Counter-based dropout, bit for bit the TPU kernel's `_drop_mask`
// (qst_tpu/ops/fused_layer_pallas.py:82-108): murmur3-fmix32 of
// (element index ^ (seed + tag * 0x9E3779B9)), 31 uniform bits kept below
// int((1 - rate) * 2147483647.0). In uint32_t the wrapping multiplies and
// logical shifts are the TPU's int32 bits. A grid step of the TPU kernel is
// a block of `nb` sequences; its seed is seed ^ (block * 0x9E3779B9).
// ---------------------------------------------------------------------------
struct DropSite {
  const int* seed;  // (1,) int32 on the device, read by every thread
  int on;           // 0: no dropout at this site
  uint32_t thr;     // keep when the 31 hashed bits are < thr
  float scale;      // float32(1 / (1 - rate))
  int nb, S;        // sequences per TPU grid step, sequence length
};

__device__ __forceinline__ uint32_t drop_hash(uint32_t idx, uint32_t seed, uint32_t tag) {
  uint32_t h = idx ^ (seed + tag * 0x9E3779B9u);
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h & 0x7FFFFFFFu;
}

__device__ __forceinline__ uint32_t drop_step_seed(const DropSite& d, int blk) {
  return (uint32_t)d.seed[0] ^ ((uint32_t)blk * 0x9E3779B9u);
}

// the mask value (0 or scale) of element `idx` under the step seed
__device__ __forceinline__ float drop_keep(const DropSite& d, uint32_t step_seed,
                                           uint32_t idx, uint32_t tag) {
  return drop_hash(idx, step_seed, tag) < d.thr ? d.scale : 0.0f;
}

// hidden-state sites (tags 0, 1) of token row `row` of (B*S, H): the TPU
// kernel indexes the (nb*S, H) block of its grid step
__device__ __forceinline__ float drop_hidden(const DropSite& d, int row, int col, int H,
                                             uint32_t tag) {
  const int blk = row / d.S / d.nb;
  const uint32_t idx = (uint32_t)(row - blk * d.nb * d.S) * (uint32_t)H + (uint32_t)col;
  return drop_keep(d, drop_step_seed(d, blk), idx, tag);
}
