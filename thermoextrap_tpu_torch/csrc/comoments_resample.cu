// K2 and K3: per-replicate bootstrap comoment sums, one templated kernel.
//
// Replaces thermoextrap_tpu/ops/moments_pallas.py
//   K2 resample_central_comoments_fused   (kernel _resample_kernel, :548):
//      counts loaded from a materialized (nrep, R) frequency table of type
//      int8 / int16 / int32 / float32 / bfloat16 (fractional counts allowed);
//   K3 resample_central_comoments_poisson (kernel _poisson_resample_kernel,
//      :914; draw _poisson_draw, :898): Poisson(1) counts drawn inside the
//      kernel, so the (nrep, R) table never exists.
//
// For replicate r and contribution row c = (kx + 1) (order + 1) + n
// (kx = -1 for the u rows, else the value column):
//   part[chunk, r, c] = sum_{j in chunk} count(r, j) w_j du_j^n dx_j,kx
// with du = u - s_u, dx = x - s_x (dx_j,-1 = 1).  The caller sums the chunk
// partials (deterministic second pass, no atomics) and recentres exactly.
//
// Bound on the H100: K2 streams the count table (nrep R entries, 1-4 bytes
// each) and does (order+1)(V+1) FMAs per entry; K3 reads only the samples and
// is bound by instruction throughput: one Philox4x32-10 call per 4 counts, 9
// compares per count, then the FMAs.  The simple design: a block owns a tile
// of contribution rows (TX_RS_CB of them, grid.z tiles the rest) and a tile
// of TX_RS_REPS replicates, walks its chunk of samples in shared-memory tiles
// of TX_RS_TILE samples, builds each tile's contribution rows once (shared by
// all its replicates), and every lane accumulates count * contrib in f32 FMAs
// for TX_RS_RB replicates x 4 consecutive samples, reading the tile with
// 16-byte shared loads.  No TF32 and no tensor cores: the sums must hold f32
// accuracy (a looser TPU precision measured 2e-3 wrong).
//
// K3 counter layout (K8 must reuse it): the count of replicate r at global
// sample index j is word (j & 3) of
//   Philox4x32-10(counter = {(j >> 2) mod 2^32, r, (j >> 34) mod 2^32, 0},
//                 key     = {seed mod 2^32, (seed >> 32) mod 2^32})
// mapped to #{q : word > thresholds[q]} over the 9 truncated Poisson(1) CDF
// cutoffs.  The counts are a pure function of (seed, r, j): they do not
// depend on the launch shape, and adjacent seeds are different keys, so
// their streams do not alias.

#include "common.cuh"

#define TX_RS_THREADS 256
#define TX_RS_WARPS (TX_RS_THREADS / 32)
#define TX_RS_RB 4
#define TX_RS_REPS (TX_RS_WARPS * TX_RS_RB)
#define TX_RS_CB 16
#define TX_RS_TILE 512

namespace {

struct PoissonThresholds {
  uint32_t t[9];
};

__device__ __forceinline__ void philox4x32_10(uint32_t c[4], uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    if (i > 0) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t lo0 = 0xD2511F53u * c[0];
    const uint32_t hi0 = __umulhi(0xD2511F53u, c[0]);
    const uint32_t lo1 = 0xCD9E8D57u * c[2];
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c[2]);
    const uint32_t n0 = hi1 ^ c[1] ^ k0;
    const uint32_t n2 = hi0 ^ c[3] ^ k1;
    c[0] = n0;
    c[1] = lo1;
    c[2] = n2;
    c[3] = lo0;
  }
}

// counts of one replicate for the 4 samples j .. j+3 (j a multiple of 4)
struct PoissonCounts {
  uint32_t k0, k1;
  PoissonThresholds th;
  long long R;
  __device__ __forceinline__ void load4(int r, long long j, float f[4]) const {
    uint32_t c[4] = {(uint32_t)(j >> 2), (uint32_t)r, (uint32_t)(j >> 34), 0u};
    philox4x32_10(c, k0, k1);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      int n = 0;
#pragma unroll
      for (int t = 0; t < 9; ++t) n += (c[q] > th.t[t]) ? 1 : 0;
      f[q] = (j + q < R) ? (float)n : 0.f;
    }
  }
};

template <typename F>
struct TableCounts {
  const F* freq;
  long long R;
  __device__ __forceinline__ void load4(int r, long long j, float f[4]) const {
    const F* row = freq + (long long)r * R;
#pragma unroll
    for (int q = 0; q < 4; ++q) f[q] = (j + q < R) ? tx_to_float(row[j + q]) : 0.f;
  }
};

template <typename T, typename Counts>
__global__ void __launch_bounds__(TX_RS_THREADS)
resample_comoments_kernel(const T* __restrict__ u, const T* __restrict__ x,
                          const float* __restrict__ w, const float* __restrict__ su,
                          const float* __restrict__ sx, Counts counts,
                          float* __restrict__ part, long long R, int V, int order,
                          int nrep, long long chunk) {
  __shared__ __align__(16) float tile[TX_RS_CB][TX_RS_TILE];

  const int m = (V + 1) * (order + 1);
  const int c0 = blockIdx.z * TX_RS_CB;
  const int r0 = blockIdx.y * TX_RS_REPS;
  const long long j_begin = (long long)blockIdx.x * chunk;
  const long long j_end = (j_begin + chunk < R) ? j_begin + chunk : R;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float s_u = su[0];
  // value columns whose rows fall in [c0, c0 + TX_RS_CB)
  const int kx_lo = c0 / (order + 1) - 1;
  const int kx_hi_raw = (c0 + TX_RS_CB - 1) / (order + 1) - 1;
  const int kx_hi = (kx_hi_raw < V - 1) ? kx_hi_raw : V - 1;

  float acc[TX_RS_RB][TX_RS_CB];
#pragma unroll
  for (int rb = 0; rb < TX_RS_RB; ++rb)
#pragma unroll
    for (int cc = 0; cc < TX_RS_CB; ++cc) acc[rb][cc] = 0.f;

  for (long long t0 = j_begin; t0 < j_end; t0 += TX_RS_TILE) {
    __syncthreads();  // the previous tile has been consumed
    for (int i = threadIdx.x; i < TX_RS_TILE; i += TX_RS_THREADS) {
      const long long j = t0 + i;
      const bool valid = j < j_end;
      float p = valid ? ((w != nullptr) ? w[j] : 1.f) : 0.f;
      const float du = valid ? tx_to_float(u[j]) - s_u : 0.f;
      float pw[TX_MAX_ORDER + 1];
#pragma unroll
      for (int n = 0; n <= TX_MAX_ORDER; ++n) {
        pw[n] = p;
        p *= du;
      }
      for (int kx = kx_lo; kx <= kx_hi; ++kx) {
        const float dx =
            (kx < 0) ? 1.f : (valid ? tx_to_float(x[j * V + kx]) - sx[kx] : 0.f);
        const int row0 = (kx + 1) * (order + 1) - c0;
#pragma unroll
        for (int n = 0; n <= TX_MAX_ORDER; ++n) {
          const int cc = row0 + n;
          if (n <= order && cc >= 0 && cc < TX_RS_CB) tile[cc][i] = pw[n] * dx;
        }
      }
    }
    __syncthreads();

    for (int base = 4 * lane; base < TX_RS_TILE; base += 128) {
      const long long j = t0 + base;
      float f[TX_RS_RB][4];
#pragma unroll
      for (int rb = 0; rb < TX_RS_RB; ++rb) {
        const int r = r0 + warp * TX_RS_RB + rb;
        if (r < nrep && j < j_end) {
          counts.load4(r, j, f[rb]);
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q) f[rb][q] = 0.f;
        }
      }
#pragma unroll
      for (int cc = 0; cc < TX_RS_CB; ++cc) {
        if (c0 + cc < m) {
          const float4 cv = *reinterpret_cast<const float4*>(&tile[cc][base]);
#pragma unroll
          for (int rb = 0; rb < TX_RS_RB; ++rb) {
            float a = acc[rb][cc];
            a = fmaf(f[rb][0], cv.x, a);
            a = fmaf(f[rb][1], cv.y, a);
            a = fmaf(f[rb][2], cv.z, a);
            a = fmaf(f[rb][3], cv.w, a);
            acc[rb][cc] = a;
          }
        }
      }
    }
  }

#pragma unroll
  for (int rb = 0; rb < TX_RS_RB; ++rb) {
    const int r = r0 + warp * TX_RS_RB + rb;
#pragma unroll
    for (int cc = 0; cc < TX_RS_CB; ++cc) {
      const float v = tx_warp_sum(acc[rb][cc]);
      if (lane == 0 && r < nrep && c0 + cc < m) {
        part[((long long)blockIdx.x * nrep + r) * m + c0 + cc] = v;
      }
    }
  }
}

// the in-kernel Poisson counts as a table (nrep, R) int32: the parity hook
// that holds K3's draws against their plain torch reproduction
__global__ void poisson_counts_kernel(PoissonCounts counts, int32_t* __restrict__ out,
                                      long long R) {
  const long long j = 4 * ((long long)blockIdx.x * blockDim.x + threadIdx.x);
  const int r = blockIdx.y;
  if (j >= R) return;
  float f[4];
  counts.load4(r, j, f);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if (j + q < R) out[(long long)r * R + j + q] = (int32_t)f[q];
  }
}

PoissonCounts make_poisson(long long seed, const unsigned int* thresholds, long long R) {
  PoissonCounts pc;
  pc.k0 = (uint32_t)((unsigned long long)seed & 0xffffffffull);
  pc.k1 = (uint32_t)(((unsigned long long)seed >> 32) & 0xffffffffull);
  for (int t = 0; t < 9; ++t) pc.th.t[t] = thresholds[t];
  pc.R = R;
  return pc;
}

template <typename T, typename Counts>
void launch_resample(dim3 grid, cudaStream_t s, const void* u, const void* x, const void* w,
                     const void* su, const void* sx, Counts counts, void* part, long long R,
                     int V, int order, int nrep, long long chunk) {
  resample_comoments_kernel<T, Counts><<<grid, TX_RS_THREADS, 0, s>>>(
      (const T*)u, (const T*)x, (const float*)w, (const float*)su, (const float*)sx, counts,
      (float*)part, R, V, order, nrep, chunk);
}

template <typename T>
int launch_by_counts(dim3 grid, cudaStream_t s, const void* u, const void* x, const void* w,
                     const void* freq, const void* su, const void* sx, void* part,
                     long long R, int V, int order, int nrep, long long chunk,
                     int count_kind, long long seed, const unsigned int* thresholds) {
  switch (count_kind) {
    case 0:
      launch_resample<T>(grid, s, u, x, w, su, sx, TableCounts<int8_t>{(const int8_t*)freq, R},
                         part, R, V, order, nrep, chunk);
      break;
    case 1:
      launch_resample<T>(grid, s, u, x, w, su, sx,
                         TableCounts<int16_t>{(const int16_t*)freq, R}, part, R, V, order,
                         nrep, chunk);
      break;
    case 2:
      launch_resample<T>(grid, s, u, x, w, su, sx,
                         TableCounts<int32_t>{(const int32_t*)freq, R}, part, R, V, order,
                         nrep, chunk);
      break;
    case 3:
      launch_resample<T>(grid, s, u, x, w, su, sx, TableCounts<float>{(const float*)freq, R},
                         part, R, V, order, nrep, chunk);
      break;
    case 4:
      launch_resample<T>(grid, s, u, x, w, su, sx,
                         TableCounts<__nv_bfloat16>{(const __nv_bfloat16*)freq, R}, part, R,
                         V, order, nrep, chunk);
      break;
    case 5:
      launch_resample<T>(grid, s, u, x, w, su, sx, make_poisson(seed, thresholds, R), part,
                         R, V, order, nrep, chunk);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// u (R,), x (R, V) of the stream type (bf16 != 0: bfloat16, else float32);
// w (R,) float32 or null; su (1,), sx (V,) float32.  count_kind: 0 int8,
// 1 int16, 2 int32, 3 float32, 4 bfloat16 table freq (nrep, R); 5 Poisson
// counts drawn from (seed, thresholds[9]) with freq unused.  Writes part
// (nchunk, nrep, (V+1)(order+1)) float32, chunk samples per chunk (a
// multiple of TX_RS_TILE).  Returns the launch status.
int tx_resample_comoments(const void* u, const void* x, const void* w, const void* freq,
                          const void* su, const void* sx, void* part, long long R, int V,
                          int order, int nrep, int nchunk, long long chunk, int bf16,
                          int count_kind, long long seed, const unsigned int* thresholds,
                          int device, void* stream) {
  const long long m = (long long)(V + 1) * (order + 1);
  const long long ycount = ((long long)nrep + TX_RS_REPS - 1) / TX_RS_REPS;
  const long long zcount = (m + TX_RS_CB - 1) / TX_RS_CB;
  if (order < 0 || order > TX_MAX_ORDER || V < 1 || nrep < 1 || R < 1 || nchunk < 1 ||
      nchunk > 2147483647 || chunk % TX_RS_TILE != 0 || (long long)nchunk * chunk < R ||
      ycount > 65535 || zcount > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)nchunk, (unsigned)ycount, (unsigned)zcount);
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16) {
    return launch_by_counts<__nv_bfloat16>(grid, s, u, x, w, freq, su, sx, part, R, V, order,
                                           nrep, chunk, count_kind, seed, thresholds);
  }
  return launch_by_counts<float>(grid, s, u, x, w, freq, su, sx, part, R, V, order, nrep,
                                 chunk, count_kind, seed, thresholds);
}

// out (nrep, R) int32: the Poisson counts K3 draws for (seed, r, j).
int tx_poisson_counts(void* out, long long R, int nrep, long long seed,
                      const unsigned int* thresholds, int device, void* stream) {
  if (R < 1 || nrep < 1 || nrep > 65535) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long groups = (R + 3) / 4;
  const dim3 grid((unsigned)((groups + 255) / 256), (unsigned)nrep, 1);
  poisson_counts_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      make_poisson(seed, thresholds, R), (int32_t*)out, R);
  return (int)cudaGetLastError();
}

}  // extern "C"
