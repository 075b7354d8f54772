// A stand-in for the CUDA runtime that lets a host C++ compiler build the
// kernels of ../ and run them on the CPU (thermoextrap_tpu_torch/emulate.py).
// It knows only what these kernels use: for checking indexing, barriers and
// control flow on small shapes where there is no nvcc, never for timing.
// Blocks run one after another.  The threads of a block are fibers (glibc's
// ucontext) on the calling thread, resumed in ascending threadIdx.x order;
// each runs until its next barrier or its end, so every run is the same.
// Shared memory starts as NaN in every block.  A read that a missing barrier
// leaves ahead of a higher-numbered thread's write sees NaN (dynamic shared
// memory) or the previous block's value (static __shared__), on every run; a
// read of a lower-numbered thread's write is not caught.
#pragma once
#define TX_EMULATED 1
#include <ucontext.h>
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>

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
inline EmuIndex threadIdx, blockIdx, blockDim, gridDim;

struct alignas(16) float4 {
  float x, y, z, w;
};
struct alignas(16) uint4 {
  unsigned x, y, z, w;
};
struct alignas(8) uint2 {
  unsigned x, y;
};
struct alignas(16) double2 {
  double x, y;
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
inline unsigned __float_as_uint(float f) {
  unsigned v;
  memcpy(&v, &f, 4);
  return v;
}
inline int __float_as_int(float f) {
  int v;
  memcpy(&v, &f, 4);
  return v;
}
inline float __int_as_float(int v) {
  float f;
  memcpy(&f, &v, 4);
  return f;
}
inline double __hiloint2double(int hi, int lo) {
  const uint64_t v = ((uint64_t)(uint32_t)hi << 32) | (uint32_t)lo;
  double d;
  memcpy(&d, &v, 8);
  return d;
}
inline unsigned long long atomicAdd(unsigned long long* a, unsigned long long v) {
  return (*a += v) - v;  // one fiber runs at a time
}

#define EMU_SMEM_BYTES 232448
alignas(16) inline float emu_smem[EMU_SMEM_BYTES / 4];  // dynamic shared memory of the running block
inline float emu_shuffle[1024];

// The fibers, and the scheduler's context that a waiting fiber yields to;
// emu_moves counts barrier arrivals and fiber ends, to tell a deadlock
#define EMU_STACK_BYTES (256 * 1024)  // these kernels use under 4 KiB of it
inline ucontext_t emu_sched, emu_fiber[1024];
inline bool emu_done[1024];
inline unsigned long emu_moves = 0;

// A barrier of `count` fibers: one that arrives and is not the last yields
// until the generation changes; the last advances it and runs on
struct EmuBarrier {
  unsigned count = 0, arrived = 0, gen = 0;
  void arrive_and_wait() {
    const unsigned g = gen;
    ++emu_moves;
    if (++arrived == count) arrived = 0, ++gen;
    while (gen == g) swapcontext(&emu_fiber[threadIdx.x], &emu_sched);
  }
};
inline EmuBarrier emu_block_barrier, emu_warp_barrier[32];  // the block, and each warp

inline void __syncthreads() { emu_block_barrier.arrive_and_wait(); }

// __syncthreads_or: three flag slots in turn, so that a slot is cleared two
// calls before it is set again
inline int emu_or_flag[3];
inline unsigned emu_or_calls[1024];
inline int __syncthreads_or(int pred) {
  const unsigned k = emu_or_calls[threadIdx.x]++;
  if (pred) emu_or_flag[k % 3] = 1;
  __syncthreads();
  const int any = emu_or_flag[k % 3];
  if (threadIdx.x == 0) emu_or_flag[(k + 2) % 3] = 0;
  return any;
}

// the warp-collective stand-ins meet at their warp's barrier
inline void emu_syncwarp() { emu_warp_barrier[threadIdx.x / 32].arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) { emu_syncwarp(); }

// __any_sync over the whole warp (every lane of it must call it together)
inline int emu_vote[1024];
inline int __any_sync(unsigned, int pred) {
  const unsigned w0 = threadIdx.x & ~31u;
  emu_vote[threadIdx.x] = pred ? 1 : 0;
  emu_syncwarp();
  int any = 0;
  for (unsigned i = w0; i < std::min(w0 + 32u, blockDim.x); ++i) any |= emu_vote[i];
  emu_syncwarp();  // every lane has read the votes
  return any;
}

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
  __syncthreads();
  const float other = emu_shuffle[t ^ (unsigned)offset];
  __syncthreads();
  return other;
}

typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
inline cudaError_t emu_last_error = cudaSuccess;
inline cudaError_t cudaSetDevice(int) { return cudaSuccess; }
// an H100's count of SMs, and 8 resident blocks of any kernel on each
enum { cudaDevAttrMultiProcessorCount = 16 };
inline cudaError_t cudaDeviceGetAttribute(int* value, int attr, int) {
  if (attr != cudaDevAttrMultiProcessorCount) return cudaErrorInvalidValue;
  *value = 132;
  return cudaSuccess;
}
template <typename K>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* blocks, K, int, size_t) {
  *blocks = 8;
  return cudaSuccess;
}
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

// Every fiber makes the running launch's kernel call (emu_body).  A block's
// fibers run to their ends, or abort when all left wait at barriers in vain.
inline std::function<void()> emu_body;
inline void emu_fiber_main() {
  emu_body();
  ++emu_moves;
  emu_done[threadIdx.x] = true;
}  // and back to emu_sched (uc_link)
inline void emu_run_block(unsigned n) {
  static char* const stacks = new char[1024ul * EMU_STACK_BYTES];  // made once; pages taken as touched
  emu_block_barrier = {n};
  for (unsigned w = 0; w < (n + 31) / 32; ++w) emu_warp_barrier[w] = {std::min(32u, n - 32 * w)};
  std::fill(emu_or_flag, emu_or_flag + 3, 0);
  for (unsigned t = 0; t < n; ++t) {
    emu_done[t] = false;
    emu_or_calls[t] = 0;
    getcontext(&emu_fiber[t]);
    emu_fiber[t].uc_stack.ss_sp = stacks + (size_t)t * EMU_STACK_BYTES;
    emu_fiber[t].uc_stack.ss_size = EMU_STACK_BYTES;
    emu_fiber[t].uc_link = &emu_sched;
    makecontext(&emu_fiber[t], emu_fiber_main, 0);
  }
  for (unsigned live = n; live > 0;) {
    const unsigned long moves = emu_moves;
    live = 0;
    for (unsigned t = 0; t < n; ++t) {
      if (emu_done[t]) continue;
      threadIdx = {t, 0, 0};
      swapcontext(&emu_sched, &emu_fiber[t]);
      live += !emu_done[t];
    }
    if (live > 0 && emu_moves == moves) {
      fprintf(stderr, "emulated kernel: %u threads wait at barriers the others never reach\n", live);
      abort();
    }
  }
}

// kernel<<<grid, block, smem, stream>>>(args...) is rewritten to this call
template <typename K, typename... A>
void emu_launch(K kernel, dim3 grid, dim3 block, size_t smem, cudaStream_t, A... args) {
  if (smem > EMU_SMEM_BYTES || block.x > 1024 || block.y != 1 || block.z != 1) {
    emu_last_error = cudaErrorInvalidValue;
    return;
  }
  emu_body = [&]() { kernel(args...); };
  const unsigned n = block.x;
  blockDim = {n, 1, 1};
  gridDim = {grid.x, grid.y, grid.z};
  for (unsigned bz = 0; bz < grid.z; ++bz)
    for (unsigned by = 0; by < grid.y; ++by)
      for (unsigned bx = 0; bx < grid.x; ++bx) {
        const uint32_t nan_bits = 0x7fc00000u;
        for (size_t i = 0; i < EMU_SMEM_BYTES / 4; ++i) memcpy(&emu_smem[i], &nan_bits, 4);
        blockIdx = {bx, by, bz};
        emu_run_block(n);
      }
}
