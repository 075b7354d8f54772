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

// ---------------------------------------------------------------------------
// Tensor cores by mma.sync, bf16 packing, asynchronous copies.  Each helper
// is inline PTX on the card; under the CPU emulator (csrc/emulate,
// TX_EMULATED) it calls a stand-in that follows the PTX ISA's definition.
// ---------------------------------------------------------------------------

// d = a b + c for one warp: a the 16 x 16 bf16 A fragment (row major), b the
// 16 x 8 bf16 B fragment (column major), c and d 16 x 8 float32, in the
// fragment layout of mma.sync.aligned.m16n8k16 (PTX ISA): with g = lane / 4
// and t = lane % 4, a[0] holds A[g][2t, 2t+1], a[1] A[g+8][2t, 2t+1], a[2]
// A[g][2t+8, 2t+9], a[3] A[g+8][2t+8, 2t+9]; b[0] holds B[2t, 2t+1][g], b[1]
// B[2t+8, 2t+9][g]; c[0], c[1] are D[g][2t, 2t+1] and c[2], c[3]
// D[g+8][2t, 2t+1] (the lower half of a 32-bit register is the first
// element).  Every lane of the warp must call it together.
__device__ __forceinline__ void tx_mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4],
                                                  const uint32_t (&b)[2], const float (&c)[4]) {
#if defined(__CUDA_ARCH__)
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(c[0]),
        "f"(c[1]), "f"(c[2]), "f"(c[3]));
#elif defined(TX_EMULATED)
  emu_mma_bf16_16816(d, a, b, c);
#endif
}

// two float32 values rounded to bf16 (to nearest even) in one 32-bit
// register: lo in the lower half
__device__ __forceinline__ uint32_t tx_pack_bf16x2(float lo, float hi) {
#if defined(__CUDA_ARCH__)
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
#else
  auto rn = [](float f) -> uint32_t {
    uint32_t u;
    memcpy(&u, &f, 4);
    if ((u & 0x7fffffffu) > 0x7f800000u) return (u >> 16) | 0x40u;  // NaN stays NaN
    return (u + 0x7fffu + ((u >> 16) & 1u)) >> 16;
  };
  return rn(lo) | (rn(hi) << 16);
#endif
}

// the lower / upper bf16 of a packed pair, as float32 (exact)
__device__ __forceinline__ float tx_bf16_lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float tx_bf16_hi(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

// Two float32 values v0, v1 as three bf16 terms each, packed in pairs:
// b0 = bf16(v), b1 = bf16(v - b0), b2 = bf16(v - b0 - b1), so that
// b0 + b1 + b2 carries v to ~24 bits (each difference is exact in float32).
// t[k] holds term k of (v0, v1).
__device__ __forceinline__ void tx_split_bf16x3(float v0, float v1, uint32_t (&t)[3]) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    t[k] = tx_pack_bf16x2(v0, v1);
    v0 -= tx_bf16_lo(t[k]);
    v1 -= tx_bf16_hi(t[k]);
  }
}

// 16 bytes from global to shared memory without a register stop: the last
// 16 - src_bytes bytes are zero-filled (src_bytes in 0..16).  dst and src
// 16-byte aligned.  The copies of a thread form a group at tx_cp_commit;
// tx_cp_wait_all waits for all of its groups (a barrier then shows them to
// the block).
__device__ __forceinline__ void tx_cp_async16(void* dst, const void* src, int src_bytes) {
#if defined(__CUDA_ARCH__)
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(src_bytes)
               : "memory");
#else
  memset(dst, 0, 16);
  if (src_bytes > 0) memcpy(dst, src, src_bytes);
#endif
}
__device__ __forceinline__ void tx_cp_commit() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
}
__device__ __forceinline__ void tx_cp_wait_all() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_all;\n" ::: "memory");
#endif
}
