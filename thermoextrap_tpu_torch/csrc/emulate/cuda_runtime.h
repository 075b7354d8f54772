// A stand-in for the CUDA runtime that lets a host C++ compiler build the
// kernels of ../ and run them on the CPU (thermoextrap_tpu_torch/emulate.py):
// the threads of a block are std::threads, __syncthreads a std::barrier, and
// blocks run one after another.  It knows only what these kernels use, and it
// is slow: for checking indexing and control flow on small shapes where there
// is no nvcc, never for timing.  Shared memory starts as NaN in every block,
// so a read of an unwritten entry shows.
#pragma once
#define TX_EMULATED 1
#include <algorithm>
#include <atomic>
#include <barrier>
#include <memory>
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
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) { return {a, b, c, d}; }
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

// __syncthreads_or: three flag slots in turn, so that a slot is cleared two
// calls before it is set again
inline std::atomic<int> emu_or_flag[3];
inline thread_local unsigned emu_or_calls = 0;
inline int __syncthreads_or(int pred) {
  const unsigned k = emu_or_calls++;
  if (pred) emu_or_flag[k % 3].store(1);
  emu_barrier->arrive_and_wait();
  const int any = emu_or_flag[k % 3].load();
  if (threadIdx.x == 0) emu_or_flag[(k + 2) % 3].store(0);
  return any;
}

// one barrier per warp, for the warp-collective stand-ins
inline std::vector<std::unique_ptr<std::barrier<>>> emu_warp_barriers;
inline void emu_syncwarp() { emu_warp_barriers[threadIdx.x / 32]->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) { emu_syncwarp(); }

// mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 (PTX ISA fragment
// layout, see tx_mma_bf16_16816 in ../common.cuh): every lane posts its
// fragments, then computes its own four outputs from the whole matrices in
// float64 (exact products; one rounding to float32, where the tensor cores
// round their own way: the emulator checks layout and indexing, not bits)
struct EmuMmaLane {
  uint32_t a[4], b[2];
};
inline EmuMmaLane emu_mma_post[1024];
inline float emu_bf16_at(uint32_t v, int hi) {
  const uint32_t u = hi ? (v & 0xffff0000u) : (v << 16);
  float f;
  memcpy(&f, &u, 4);
  return f;
}
inline void emu_mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2],
                               const float (&c)[4]) {
  const unsigned w0 = threadIdx.x & ~31u;
  const unsigned lane = threadIdx.x & 31u;
  for (int i = 0; i < 4; ++i) emu_mma_post[threadIdx.x].a[i] = a[i];
  for (int i = 0; i < 2; ++i) emu_mma_post[threadIdx.x].b[i] = b[i];
  emu_syncwarp();
  auto A = [&](int row, int k) {
    const EmuMmaLane& l = emu_mma_post[w0 + (row % 8) * 4 + (k % 8) / 2];
    return emu_bf16_at(l.a[(row >= 8 ? 1 : 0) + (k >= 8 ? 2 : 0)], k % 2);
  };
  auto B = [&](int k, int col) {
    const EmuMmaLane& l = emu_mma_post[w0 + col * 4 + (k % 8) / 2];
    return emu_bf16_at(l.b[k >= 8 ? 1 : 0], k % 2);
  };
  float out[4];
  for (int i = 0; i < 4; ++i) {
    const int row = (int)(lane / 4) + (i >= 2 ? 8 : 0);
    const int col = 2 * (int)(lane % 4) + (i % 2);
    double s = c[i];
    for (int k = 0; k < 16; ++k) s += (double)A(row, k) * (double)B(k, col);
    out[i] = (float)s;
  }
  emu_syncwarp();  // every lane has read the posts
  for (int i = 0; i < 4; ++i) d[i] = out[i];
}

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
        emu_warp_barriers.clear();
        for (unsigned w = 0; w < (block.x + 31) / 32; ++w)
          emu_warp_barriers.emplace_back(new std::barrier<>((std::ptrdiff_t)std::min(32u, block.x - 32 * w)));
        for (auto& f : emu_or_flag) f.store(0);
        std::vector<std::thread> threads;
        for (unsigned t = 0; t < block.x; ++t)
          threads.emplace_back([=]() {
            threadIdx = {t, 0, 0};
            emu_or_calls = 0;
            blockIdx = {bx, by, bz};
            kernel(args...);
          });
        for (auto& th : threads) th.join();
      }
}
