// A stand-in for the CUDA runtime that lets a host C++ compiler build the
// kernels of ../ and run them on the CPU (thermoextrap_tpu_torch/emulate.py):
// the threads of a block are std::threads, __syncthreads a std::barrier, and
// blocks run one after another.  It knows only what these kernels use, and it
// is slow: for checking indexing and control flow on small shapes where there
// is no nvcc, never for timing.  Shared memory starts as NaN in every block,
// so a read of an unwritten entry shows.
#pragma once
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(...)
#define __shared__ static
#define __align__(n) __attribute__((aligned(n)))

struct EmuIndex {
  unsigned x = 0, y = 0, z = 0;
};
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
inline thread_local EmuIndex threadIdx, blockIdx;
inline EmuIndex blockDim, gridDim;

struct alignas(16) float4 {
  float x, y, z, w;
};
struct alignas(16) uint4 {
  unsigned x, y, z, w;
};
struct alignas(8) uint2 {
  unsigned x, y;
};
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
inline uint2 make_uint2(unsigned a, unsigned b) { return {a, b}; }
inline uint32_t __umulhi(uint32_t a, uint32_t b) { return (uint32_t)(((uint64_t)a * b) >> 32); }
inline float __uint_as_float(unsigned v) {
  float f;
  memcpy(&f, &v, 4);
  return f;
}
inline unsigned long long atomicAdd(unsigned long long* a, unsigned long long v) {
  return __atomic_fetch_add(a, v, __ATOMIC_RELAXED);
}

#define EMU_SMEM_BYTES 232448
alignas(16) inline float emu_smem[EMU_SMEM_BYTES / 4];  // dynamic shared memory of the running block
inline float emu_shuffle[1024];
inline std::barrier<>* emu_barrier = nullptr;

inline void __syncthreads() { emu_barrier->arrive_and_wait(); }

// every thread of the block must make the same shuffle calls (these kernels do)
inline float __shfl_xor_sync(unsigned, float v, int offset) {
  const unsigned t = threadIdx.x;
  emu_shuffle[t] = v;
  emu_barrier->arrive_and_wait();
  const float other = emu_shuffle[t ^ (unsigned)offset];
  emu_barrier->arrive_and_wait();
  return other;
}

typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
inline cudaError_t emu_last_error = cudaSuccess;
inline cudaError_t cudaSetDevice(int) { return cudaSuccess; }
inline cudaError_t cudaGetLastError() {
  const cudaError_t e = emu_last_error;
  emu_last_error = cudaSuccess;
  return e;
}
inline const char* cudaGetErrorString(cudaError_t e) { return e ? "invalid value (emulated)" : "no error"; }
template <typename K>
cudaError_t cudaFuncSetAttribute(K, int, int bytes) {
  return bytes <= EMU_SMEM_BYTES ? cudaSuccess : cudaErrorInvalidValue;
}

// kernel<<<grid, block, smem, stream>>>(args...) is rewritten to this call
template <typename K, typename... A>
void emu_launch(K kernel, dim3 grid, dim3 block, size_t smem, cudaStream_t, A... args) {
  if (smem > EMU_SMEM_BYTES || block.x > 1024 || block.y != 1 || block.z != 1) {
    emu_last_error = cudaErrorInvalidValue;
    return;
  }
  blockDim = {block.x, 1, 1};
  gridDim = {grid.x, grid.y, grid.z};
  for (unsigned bz = 0; bz < grid.z; ++bz)
    for (unsigned by = 0; by < grid.y; ++by)
      for (unsigned bx = 0; bx < grid.x; ++bx) {
        const uint32_t nan_bits = 0x7fc00000u;
        for (size_t i = 0; i < EMU_SMEM_BYTES / 4; ++i) memcpy(&emu_smem[i], &nan_bits, 4);
        std::barrier<> barrier(block.x);
        emu_barrier = &barrier;
        std::vector<std::thread> threads;
        for (unsigned t = 0; t < block.x; ++t)
          threads.emplace_back([=]() {
            threadIdx = {t, 0, 0};
            blockIdx = {bx, by, bz};
            kernel(args...);
          });
        for (auto& th : threads) th.join();
      }
}
