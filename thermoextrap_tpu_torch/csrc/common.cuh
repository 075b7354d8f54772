// Shared device helpers of the thermoextrap_tpu_torch kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Highest moment order the kernels accumulate in registers: the sums of one
// sample are unrolled over n = 0..TX_MAX_ORDER and guarded by n <= order,
// so per-thread accumulators stay in registers whatever the runtime order.
#define TX_MAX_ORDER 15

// Sample streams are float32 or bfloat16 (upcast on load); accumulation is
// always float32.
__device__ __forceinline__ float tx_to_float(float v) { return v; }
__device__ __forceinline__ float tx_to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float tx_to_float(int8_t v) { return (float)v; }
__device__ __forceinline__ float tx_to_float(int16_t v) { return (float)v; }
__device__ __forceinline__ float tx_to_float(int32_t v) { return (float)v; }

__device__ __forceinline__ float tx_warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Pin a value loaded ahead of its use: the compiler may neither sink the load
// below this point nor recompute the value later (an empty volatile asm that
// claims to rewrite it), so a prefetch stays in flight across the work that
// follows.  No instruction is emitted.
__device__ __forceinline__ void tx_keep(float& v) {
#ifdef __CUDA_ARCH__
  asm volatile("" : "+f"(v));
#endif
}
__device__ __forceinline__ void tx_keep(unsigned int& v) {
#ifdef __CUDA_ARCH__
  asm volatile("" : "+r"(v));
#endif
}
__device__ __forceinline__ void tx_keep(uint2& v) {
  tx_keep(v.x);
  tx_keep(v.y);
}
__device__ __forceinline__ void tx_keep(uint4& v) {
  tx_keep(v.x);
  tx_keep(v.y);
  tx_keep(v.z);
  tx_keep(v.w);
}
