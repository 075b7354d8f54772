// K1, K4 and K6: single-pass shifted (co)moment reduction, batched.
//
// Replaces thermoextrap_tpu/ops/moments_pallas.py
//   K1 reduce_central_comoments_fused   (kernel _reduce_kernel, :192)
//   K4 reduce_central_umoments_batched  (kernel _reduce_u_batched_kernel, :1656)
//   K6 reduce_central_comoments_batched (kernel _reduce_co_batched_kernel, :1875)
// as ONE kernel over (nbatch, R, V); K1 is the case nbatch = 1, K4 the case
// V = 0 (u-moments alone: the energy moments of every macrostate of an lnPi
// grid, and the x_is_u route of the flat reduction).  The TPU kept them apart
// for its 128-lane bitcast packing and misaligned-R path, which mean nothing
// here.
//
// Computes, for every batch row b, value column k and n = 0..order,
//   part[blk, b, n]               = sum_j w_j (u_j - s_u[b])^n
//   part[blk, b, (k + 1) n1 + n]  = sum_j w_j (u_j - s_u[b])^n (x_jk - s_x[b, k])
// (n1 = order + 1) over the samples j of sample block blk: the layout of the
// finalize kernels of finalize.cu, with the batch row in the place of the
// replicate (finalize_comoments), or at V = 0 with the sample blocks as the
// chunks of one replicate (finalize_umoments).  The shift row (s_u[b],
// s_x[b, :]) comes from the head-shift kernel; the finalize kernel sums the
// block partials in float64 in a fixed order (no atomics, so runs repeat
// exactly) and recentres them exactly.  The wrapper is those three launches.
//
// Bound on the H100: bytes read.  Order 6, V = 1 costs ~20 flops per sample
// against 8 bytes (f32) or 4 bytes (bf16), and V = 0 at order 7 ~16 flops
// against 4 or 2 bytes, far below the card's ~20 flop/byte balance point, so
// the kernel is a stream.  What the design does about it:
//   - u, w and x are read by 16-byte loads (4 float32 or 8 bfloat16 samples;
//     the V columns of those samples are V more 16-byte loads), two groups in
//     flight per thread; a row whose u, x and w do not share an alignment
//     takes scalar loads, and the samples before the first aligned group and
//     after the last whole one are a scalar head and tail;
//   - u is read once for all V columns: the sums of up to TX_RED_NC = 4
//     columns stay in registers (one kernel for each V up to 4, so that every
//     register index is known to the compiler).  More columns go in tiles of
//     4 by scalar loads, u re-read only past the first tile;
//   - at V = 0 (K4) no x is read, nor passed: one pass over u and w sums the
//     u powers alone (the kernel for NC = 0; its column arrays keep one slot
//     that nothing touches, so that no array has size zero).  A sample costs
//     4 or 2 bytes there, so the instructions per sample count: up to order
//     7 (the lnPi grid's 6, the x_is_u route's 7) the 8 power slots are
//     summed without the per-slot order compare (TX_SHORT_NP);
//   - the sums of a sample block are reduced by warp shuffles and written as
//     one partial row: nblk nbatch blocks, ~8 a SM at the main path's shape.

#include "common.cuh"

#define TX_REDUCE_THREADS 256
#define TX_RED_NC 4  // value columns a thread keeps in registers
#define TX_SHORT_NP 8  // power slots of the unguarded u-only kernel (orders up to 7)

namespace {

// slots of a thread's arrays for NC value columns: at least one, so that the
// u-only kernel (NC = 0) declares no zero-size array; a slot past NC is never
// read or written
template <int NC>
constexpr int kSlots = NC > 0 ? NC : 1;

// 16 bytes of a stream: 4 float32 or 8 bfloat16 samples
template <typename T>
struct Vec16 {
  static constexpr int N = 16 / sizeof(T);
  __device__ __forceinline__ static void load(const T* p, float (&v)[N]) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    T t[N];
    memcpy(t, &raw, 16);
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = tx_to_float(t[i]);
  }
};

// the sums of one block of threads in NP power slots: TX_MAX_ORDER + 1 slots,
// each summed only up to the order, or TX_SHORT_NP slots (order < NP) all
// summed, as a slot past the order costs less than the compare that would
// skip it; no slot past the order is written out
template <int NC, int NP>
struct Sums {
  float u[NP];
  float x[kSlots<NC>][NP];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int n = 0; n < NP; ++n) {
      u[n] = 0.f;
#pragma unroll
      for (int k = 0; k < NC; ++k) x[k][n] = 0.f;
    }
  }

  // one sample: p = w, du and the shifted values of the tile's columns
  __device__ __forceinline__ void add(float p, float du, const float (&dx)[kSlots<NC>], int order) {
#pragma unroll
    for (int n = 0; n < NP; ++n) {
      if (NP == TX_SHORT_NP || n <= order) {
        u[n] += p;
#pragma unroll
        for (int k = 0; k < NC; ++k) x[k][n] = fmaf(p, dx[k], x[k][n]);
        p *= du;
      }
    }
  }
};

// samples [j0, j1) of one row by scalar loads, with a stride of `step`
template <typename T, int NC, int NP>
__device__ __forceinline__ void add_scalar(Sums<NC, NP>& acc, const T* ub, const T* xb,
                                           const float* wb, float s_u, const float (&s_x)[kSlots<NC>],
                                           int k0, int nc, int V, long long j0, long long j1,
                                           long long step, int order) {
  for (long long j = j0; j < j1; j += step) {
    float dx[kSlots<NC>];
#pragma unroll
    for (int k = 0; k < NC; ++k) dx[k] = (k < nc) ? tx_to_float(xb[j * V + k0 + k]) - s_x[k] : 0.f;
    acc.add((wb != nullptr) ? wb[j] : 1.f, tx_to_float(ub[j]) - s_u, dx, order);
  }
}

// Block (blk, b) over the samples of row b, for value columns k0 .. k0 + nc - 1
// (nc <= NC) in turn; the u sums come with the first tile (at V = 0 the only
// one, with no column: x may then be null).
template <typename T, int NC, int NP>
__global__ void __launch_bounds__(TX_REDUCE_THREADS)
reduce_comoments_kernel(const T* __restrict__ u, const T* __restrict__ x,
                        const float* __restrict__ w, const float* __restrict__ shift,
                        float* __restrict__ part, long long R, int V, int order) {
  constexpr int VN = Vec16<T>::N;  // samples a 16-byte load holds
  const int blk = blockIdx.x;
  const int nblk = gridDim.x;
  const int b = blockIdx.y;
  const int nbatch = gridDim.y;
  const int n1 = order + 1;
  const long long m = (long long)(V + 1) * n1;
  const T* ub = u + (long long)b * R;
  const T* xb = x + (long long)b * R * V;
  const float* wb = (w != nullptr) ? w + (long long)b * R : nullptr;
  const float s_u = shift[(long long)b * (V + 1)];
  const long long tid = (long long)blk * TX_REDUCE_THREADS + threadIdx.x;
  const long long nthreads = (long long)nblk * TX_REDUCE_THREADS;

  // the first sample where u, x and w all start a 16-byte load, if there is one
  const long long h = (long long)((16 - (reinterpret_cast<uintptr_t>(ub) & 15)) & 15) / sizeof(T);
  const bool vec_ok = (reinterpret_cast<uintptr_t>(ub) % sizeof(T)) == 0 && h < R &&
                      (V == NC) &&
                      ((reinterpret_cast<uintptr_t>(xb + h * V) & 15) == 0) &&
                      (wb == nullptr || (reinterpret_cast<uintptr_t>(wb + h) & 15) == 0);
  const long long ngroup = vec_ok ? (R - h) / VN : 0;  // whole 16-byte groups
  const long long body_end = h + ngroup * VN;

  __shared__ float red[TX_REDUCE_THREADS / 32][(NC + 1) * (TX_MAX_ORDER + 1)];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  // column tiles; at V = 0 one pass with no column (the u sums alone).  With
  // columns the bound is V itself: a loop condition that also admitted V = 0
  // (k0 == 0 || k0 < V) slowed K1 by 8% on an H100
  const int vcols = (NC == 0) ? 1 : V;
  for (int k0 = 0; k0 < vcols; k0 += kSlots<NC>) {
    const int nc = (V - k0 < NC) ? V - k0 : NC;
    float s_x[kSlots<NC>];
#pragma unroll
    for (int k = 0; k < NC; ++k) s_x[k] = (k < nc) ? shift[(long long)b * (V + 1) + 1 + k0 + k] : 0.f;
    Sums<NC, NP> acc;
    acc.zero();

    if (vec_ok) {
      // groups g of VN samples from h on, two in flight per thread
      for (long long g = tid; g < ngroup; g += 2 * nthreads) {
        const long long g2 = g + nthreads;
        const bool two = g2 < ngroup;
        float uv[2][VN], wv[2][VN], xv[2][kSlots<NC> * VN];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const long long j = h + ((q == 0) ? g : g2) * VN;
          if (q == 0 || two) {
            Vec16<T>::load(ub + j, uv[q]);
            if (wb != nullptr) {
#pragma unroll
              for (int i = 0; i < VN; i += 4) {
                const float4 f = *reinterpret_cast<const float4*>(wb + j + i);
                wv[q][i] = f.x;
                wv[q][i + 1] = f.y;
                wv[q][i + 2] = f.z;
                wv[q][i + 3] = f.w;
              }
            } else {
#pragma unroll
              for (int i = 0; i < VN; ++i) wv[q][i] = 1.f;
            }
            // the V = NC columns of VN samples: V 16-byte loads
#pragma unroll
            for (int c = 0; c < NC; ++c) {
              float t[VN];
              Vec16<T>::load(xb + j * NC + c * VN, t);
#pragma unroll
              for (int i = 0; i < VN; ++i) xv[q][c * VN + i] = t[i];
            }
          } else {
#pragma unroll
            for (int i = 0; i < VN; ++i) wv[q][i] = 0.f;  // adds nothing
#pragma unroll
            for (int i = 0; i < VN; ++i) uv[q][i] = s_u;
#pragma unroll
            for (int i = 0; i < NC * VN; ++i) xv[q][i] = 0.f;
          }
        }
#pragma unroll
        for (int q = 0; q < 2; ++q) {
#pragma unroll
          for (int i = 0; i < VN; ++i) {
            float dx[kSlots<NC>];
#pragma unroll
            for (int k = 0; k < NC; ++k) {
              // sample i's column k sits at index i V + k of the group (V = NC here)
              dx[k] = xv[q][i * NC + k] - s_x[k];
            }
            acc.add(wv[q][i], uv[q][i] - s_u, dx, order);
          }
        }
      }
      // the scalar head [0, h) and tail [body_end, R)
      add_scalar<T, NC, NP>(acc, ub, xb, wb, s_u, s_x, k0, nc, V, tid, h, nthreads, order);
      add_scalar<T, NC, NP>(acc, ub, xb, wb, s_u, s_x, k0, nc, V, body_end + tid, R, nthreads, order);
    } else {
      add_scalar<T, NC, NP>(acc, ub, xb, wb, s_u, s_x, k0, nc, V, tid, R, nthreads, order);
    }

    // block sums: warp shuffles, then the warps in order
#pragma unroll
    for (int n = 0; n < NP; ++n) {
      if (n <= order) {
        const float a = tx_warp_sum(acc.u[n]);
        if (lane == 0) red[warp][n] = a;
#pragma unroll
        for (int k = 0; k < NC; ++k) {
          const float c = tx_warp_sum(acc.x[k][n]);
          if (lane == 0) red[warp][(k + 1) * (TX_MAX_ORDER + 1) + n] = c;
        }
      }
    }
    __syncthreads();
    float* out = part + ((long long)blk * nbatch + b) * m;
    for (int e = threadIdx.x; e < (nc + 1) * n1; e += TX_REDUCE_THREADS) {
      const int g = e / n1;  // 0: u, g: column k0 + g - 1
      const int n = e % n1;
      if (g == 0 && k0 > 0) continue;  // the u sums come with the first tile
      float s = 0.f;
      for (int q = 0; q < TX_REDUCE_THREADS / 32; ++q) s += red[q][g * (TX_MAX_ORDER + 1) + n];
      out[(g == 0 ? 0 : (long long)(k0 + g) * n1) + n] = s;
    }
    __syncthreads();  // red is reused by the next tile
  }
}

template <typename T, int NC, int NP = TX_MAX_ORDER + 1>
void launch_reduce(const void* u, const void* x, const void* w, const void* shift, void* part,
                   long long nbatch, long long R, int V, int order, int nblk, cudaStream_t s) {
  const dim3 grid((unsigned)nblk, (unsigned)nbatch, 1);
  reduce_comoments_kernel<T, NC, NP><<<grid, TX_REDUCE_THREADS, 0, s>>>(
      (const T*)u, (const T*)x, (const float*)w, (const float*)shift, (float*)part, R, V, order);
}

template <typename T>
void launch_by_columns(const void* u, const void* x, const void* w, const void* shift,
                       void* part, long long nbatch, long long R, int V, int order, int nblk,
                       cudaStream_t s) {
  if (V == 0 && order < TX_SHORT_NP) {
    launch_reduce<T, 0, TX_SHORT_NP>(u, x, w, shift, part, nbatch, R, V, order, nblk, s);
  } else if (V == 0) {
    launch_reduce<T, 0>(u, x, w, shift, part, nbatch, R, V, order, nblk, s);
  } else if (V == 1) {
    launch_reduce<T, 1>(u, x, w, shift, part, nbatch, R, V, order, nblk, s);
  } else if (V == 2) {
    launch_reduce<T, 2>(u, x, w, shift, part, nbatch, R, V, order, nblk, s);
  } else if (V == 3) {
    launch_reduce<T, 3>(u, x, w, shift, part, nbatch, R, V, order, nblk, s);
  } else {
    launch_reduce<T, TX_RED_NC>(u, x, w, shift, part, nbatch, R, V, order, nblk, s);
  }
}

}  // namespace

extern "C" {

const char* tx_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// u (nbatch, R), x (nbatch, R, V) of the stream type (bf16 != 0: bfloat16,
// else float32; V = 0: u-moments alone, x not read and may be null); w
// (nbatch, R) float32 or null; shift (nbatch, V + 1) float32, a row (s_u,
// s_x) per batch row (tx_head_shift).  Writes part (nblk, nbatch, (V + 1)
// (order + 1)) float32, the layout of tx_finalize_comoments (V >= 1) and of
// tx_finalize_umoments with nchunk = nblk, nrep = 1 (V = 0).  Returns the
// launch status.
int tx_reduce_comoments(const void* u, const void* x, const void* w, const void* shift,
                        void* part, long long nbatch, long long R, int V, int order, int nblk,
                        int bf16, int device, void* stream) {
  if (order < 0 || order > TX_MAX_ORDER || nblk < 1 || nblk > 2147483647 || nbatch < 1 ||
      nbatch > 65535 || V < 0 || (V > 0 && x == nullptr) || R < 1) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16) {
    launch_by_columns<__nv_bfloat16>(u, x, w, shift, part, nbatch, R, V, order, nblk, s);
  } else {
    launch_by_columns<float>(u, x, w, shift, part, nbatch, R, V, order, nblk, s);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
