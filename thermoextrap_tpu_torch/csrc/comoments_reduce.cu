// K1 and K6: single-pass shifted (co)moment reduction, batched.
//
// Replaces thermoextrap_tpu/ops/moments_pallas.py
//   K1 reduce_central_comoments_fused   (kernel _reduce_kernel, :192)
//   K6 reduce_central_comoments_batched (kernel _reduce_co_batched_kernel, :1875)
// as ONE kernel over (nbatch, R, V); K1 is the case nbatch = 1.  The TPU kept
// them apart for its 128-lane bitcast packing and misaligned-R path, which
// mean nothing here.
//
// Computes, for every batch row b, value column k and n = 0..order,
//   part_u[b, blk, n]    = sum_j w_j (u_j - s_u[b])^n
//   part_x[b, k, blk, n] = sum_j w_j (u_j - s_u[b])^n (x_jk - s_x[b, k])
// over the samples j of sample block blk.  The shift (s_u, s_x) is the
// weighted mean of the first samples, computed by the caller on the card;
// the caller sums the block partials (a deterministic second pass: no
// atomics, so runs repeat exactly) and recentres them exactly.
//
// Bound on the H100: bytes read.  Order 6, V = 1 costs ~20 flops per sample
// against 8 bytes (f32) or 4 bytes (bf16), far below the card's ~20
// flop/byte balance point, so the kernel is a stream.  The simple design:
// each thread strides over samples with coalesced scalar loads and keeps the
// 2 (order+1) sums in registers; a block reduces them with warp shuffles and
// writes one partial row.  grid = (sample blocks, batch rows, value columns):
// each value column re-reads u, which costs nothing at V = 1 (the main path).
// Vector loads and one pass for all V columns are later work.

#include "common.cuh"

#define TX_REDUCE_THREADS 256

namespace {

template <typename T>
__global__ void __launch_bounds__(TX_REDUCE_THREADS)
reduce_comoments_kernel(const T* __restrict__ u, const T* __restrict__ x,
                        const float* __restrict__ w, const float* __restrict__ su,
                        const float* __restrict__ sx, float* __restrict__ part_u,
                        float* __restrict__ part_x, long long R, int V, int order) {
  const int blk = blockIdx.x;
  const int nblk = gridDim.x;
  const int b = blockIdx.y;
  const int k = blockIdx.z;
  const T* ub = u + (long long)b * R;
  const T* xb = x + (long long)b * R * V;
  const float* wb = (w != nullptr) ? w + (long long)b * R : nullptr;
  const float s_u = su[b];
  const float s_x = sx[(long long)b * V + k];

  float acc_u[TX_MAX_ORDER + 1];
  float acc_x[TX_MAX_ORDER + 1];
#pragma unroll
  for (int n = 0; n <= TX_MAX_ORDER; ++n) {
    acc_u[n] = 0.f;
    acc_x[n] = 0.f;
  }

  const long long stride = (long long)nblk * blockDim.x;
  for (long long j = (long long)blk * blockDim.x + threadIdx.x; j < R; j += stride) {
    const float du = tx_to_float(ub[j]) - s_u;
    const float dx = tx_to_float(xb[j * V + k]) - s_x;
    float p = (wb != nullptr) ? wb[j] : 1.f;
#pragma unroll
    for (int n = 0; n <= TX_MAX_ORDER; ++n) {
      if (n <= order) {
        acc_u[n] += p;
        acc_x[n] = fmaf(p, dx, acc_x[n]);
        p *= du;
      }
    }
  }

  __shared__ float red[TX_REDUCE_THREADS / 32][2 * (TX_MAX_ORDER + 1)];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int n = 0; n <= TX_MAX_ORDER; ++n) {
    if (n <= order) {
      const float a = tx_warp_sum(acc_u[n]);
      const float c = tx_warp_sum(acc_x[n]);
      if (lane == 0) {
        red[warp][n] = a;
        red[warp][TX_MAX_ORDER + 1 + n] = c;
      }
    }
  }
  __syncthreads();
  if (threadIdx.x <= order) {
    const int n = threadIdx.x;
    float a = 0.f;
    float c = 0.f;
    for (int q = 0; q < TX_REDUCE_THREADS / 32; ++q) {
      a += red[q][n];
      c += red[q][TX_MAX_ORDER + 1 + n];
    }
    if (k == 0) part_u[((long long)b * nblk + blk) * (order + 1) + n] = a;
    part_x[(((long long)b * V + k) * nblk + blk) * (order + 1) + n] = c;
  }
}

}  // namespace

extern "C" {

const char* tx_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// u (nbatch, R), x (nbatch, R, V) of the stream type (bf16 != 0: bfloat16,
// else float32); w (nbatch, R) float32 or null; su (nbatch,), sx (nbatch, V)
// float32.  Writes part_u (nbatch, nblk, order+1) and
// part_x (nbatch, V, nblk, order+1), float32.  Returns the launch status.
int tx_reduce_comoments(const void* u, const void* x, const void* w, const void* su,
                        const void* sx, void* part_u, void* part_x, long long nbatch,
                        long long R, int V, int order, int nblk, int bf16, int device,
                        void* stream) {
  if (order < 0 || order > TX_MAX_ORDER || nblk < 1 || nblk > 65535 || nbatch < 1 ||
      nbatch > 65535 || V < 1 || V > 65535 || R < 1) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)nblk, (unsigned)nbatch, (unsigned)V);
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16) {
    reduce_comoments_kernel<__nv_bfloat16><<<grid, TX_REDUCE_THREADS, 0, s>>>(
        (const __nv_bfloat16*)u, (const __nv_bfloat16*)x, (const float*)w,
        (const float*)su, (const float*)sx, (float*)part_u, (float*)part_x, R, V, order);
  } else {
    reduce_comoments_kernel<float><<<grid, TX_REDUCE_THREADS, 0, s>>>(
        (const float*)u, (const float*)x, (const float*)w, (const float*)su,
        (const float*)sx, (float*)part_u, (float*)part_x, R, V, order);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
