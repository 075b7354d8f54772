// K4: batched single-pass shifted u-moment reduction.
//
// Replaces thermoextrap_tpu/ops/moments_pallas.py
//   K4 reduce_central_umoments_batched (kernel _reduce_u_batched_kernel, :1656)
// the energy moments of every macrostate of an lnPi grid at once, and the
// x_is_u route of the flat reduction (x == u, so only u-moments are needed).
//
// Computes, for every batch row b and n = 0..order,
//   part[b, blk, n] = sum_j w_bj (u_bj - s_u[b])^n
// over the samples j of sample block blk.  The shift s_u is the per-row
// weighted mean of the first samples, computed by the caller on the card;
// the caller sums the block partials in float64 (a deterministic second
// pass: no atomics, so runs repeat exactly) and recentres them exactly.
//
// Bound on the H100: bytes read.  It reads the u stream (4 bytes f32, 2
// bf16) and the optional weights, and nothing else: running the comoment
// kernel K1/K6 on two copies of u would read every sample twice.  Order 7
// costs ~16 flops per sample, far below the card's ~20 flop/byte balance
// point, so the kernel is a stream.  The simple design: grid = (sample
// blocks, batch rows); each thread strides over its row's samples with
// coalesced scalar loads and keeps the order+1 sums in registers; a block
// reduces them with warp shuffles and writes one partial row.  Vector loads
// are later work.

#include "common.cuh"

#define TX_U_THREADS 256

namespace {

template <typename T>
__global__ void __launch_bounds__(TX_U_THREADS)
reduce_umoments_kernel(const T* __restrict__ u, const float* __restrict__ w,
                       const float* __restrict__ su, float* __restrict__ part, long long R,
                       int order) {
  const int blk = blockIdx.x;
  const int nblk = gridDim.x;
  const int b = blockIdx.y;
  const T* ub = u + (long long)b * R;
  const float* wb = (w != nullptr) ? w + (long long)b * R : nullptr;
  const float s_u = su[b];

  float acc[TX_MAX_ORDER + 1];
#pragma unroll
  for (int n = 0; n <= TX_MAX_ORDER; ++n) acc[n] = 0.f;

  const long long stride = (long long)nblk * blockDim.x;
  for (long long j = (long long)blk * blockDim.x + threadIdx.x; j < R; j += stride) {
    const float du = tx_to_float(ub[j]) - s_u;
    float p = (wb != nullptr) ? wb[j] : 1.f;
#pragma unroll
    for (int n = 0; n <= TX_MAX_ORDER; ++n) {
      if (n <= order) {
        acc[n] += p;
        p *= du;
      }
    }
  }

  __shared__ float red[TX_U_THREADS / 32][TX_MAX_ORDER + 1];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int n = 0; n <= TX_MAX_ORDER; ++n) {
    if (n <= order) {
      const float a = tx_warp_sum(acc[n]);
      if (lane == 0) red[warp][n] = a;
    }
  }
  __syncthreads();
  if (threadIdx.x <= order) {
    const int n = threadIdx.x;
    float a = 0.f;
    for (int q = 0; q < TX_U_THREADS / 32; ++q) a += red[q][n];
    part[((long long)b * nblk + blk) * (order + 1) + n] = a;
  }
}

}  // namespace

extern "C" {

// u (nbatch, R) of the stream type (bf16 != 0: bfloat16, else float32);
// w (nbatch, R) float32 or null; su (nbatch,) float32.  Writes part
// (nbatch, nblk, order+1) float32.  Returns the launch status.
int tx_reduce_umoments(const void* u, const void* w, const void* su, void* part,
                       long long nbatch, long long R, int order, int nblk, int bf16, int device,
                       void* stream) {
  if (order < 0 || order > TX_MAX_ORDER || nblk < 1 || nblk > 2147483647 || nbatch < 1 ||
      nbatch > 65535 || R < 1) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)nblk, (unsigned)nbatch, 1);
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16) {
    reduce_umoments_kernel<__nv_bfloat16><<<grid, TX_U_THREADS, 0, s>>>(
        (const __nv_bfloat16*)u, (const float*)w, (const float*)su, (float*)part, R, order);
  } else {
    reduce_umoments_kernel<float><<<grid, TX_U_THREADS, 0, s>>>(
        (const float*)u, (const float*)w, (const float*)su, (float*)part, R, order);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
