// Helper kernels of the K1/K6, K2/K3 and K4/K5 wrappers: the head shift
// before the reduction and bootstrap kernels and the finalize passes after
// them, so that those wrappers launch kernels and issue no tensor arithmetic
// from Python (each is head shift, kernel, finalize).
//
// None has a Pallas counterpart: thermoextrap_tpu/ops/moments_pallas.py
// leaves the shift estimate (_head_shift, :112) and the epilogues of
// reduce_central_comoments_fused (:472 on), resample_central_comoments_fused
// (:782 on), resample_central_umoments_batched_poisson (:1292 on) and
// reduce_central_umoments_batched (:1796 on) to XLA,
// which fuses them; in eager PyTorch the same steps are dozens of launches of
// a few microseconds each and took the wrappers' whole time at small shapes.
//
// head_shift_kernel, one block per (column, batch row): s_u[b] and s_x[b, k]
// are the weighted means of the first `head` samples of batch row b (s_u
// alone at V = 0, for K4/K5), accumulated in float32; 0 where the head's
// weight is 0 (the recentring is exact for any finite shift, 0/0 would
// poison every output).
//
// finalize_comoments_kernel, one block per replicate (K2/K3) or batch row
// (K1/K6) r: sums the chunk partials part[chunk, r, c] in float64 in a fixed
// order (a fixed split of the chunks over thread lanes, then the lanes in
// order: no atomics, the same bits on every run), normalises by the weight
// sum with the finite convention of a zero-weight replicate (raw moments
// [1, 0, ...]: its means are the shift and its central moments 0), recentres
// exactly about the mean by the binomial transform out[n] = sum_k C(n, k)
// m[k] (-m[1])^(n-k), forms dxdu = x_du - c[0] du, and writes the float32
// outputs with du[0] = 1, du[1] = 0 and dxdu[0] = 0 exactly.  Columns are
// c = g (order + 1) + k with group g = 0 the u sums and g = kx + 1 the sums
// of value column kx; a block walks the groups in tiles of `gt`, each padded
// to 16 columns, so its shared memory does not grow with V.  Row r's shift
// is shift[r * stride + (0: u, 1 + kx: column kx)]: stride 0 for the one
// shift of K2/K3, V + 1 for the shift row of each K1/K6 batch row.
//
// finalize_umoments_kernel, a group of 1-32 lanes per (replicate, batch
// row), more for fewer pairs: K5's chunk partials part[chunk, r, b (order +
// 1) + n] (K4's block partials: one replicate, the blocks as its chunks)
// summed in float64 in a fixed order (a lane's chunks in order, then
// the lanes in order), normalised with the same zero-weight convention and recentred about
// the mean by the same transform, shifted back by s_u[b].
//
// Bound: bytes, and small ones (the chunk partials, at most some tens of
// MB at K5's grid): each kernel costs a launch and microseconds.

#include "common.cuh"

#define TX_FIN_THREADS 256
#define TX_FIN_PAD (TX_MAX_ORDER + 1)
#define TX_HEAD_THREADS 256

static_assert(TX_FIN_PAD * TX_FIN_PAD == TX_FIN_THREADS, "one thread per binomial entry");

namespace {

template <typename T>
__global__ void __launch_bounds__(TX_HEAD_THREADS)
head_shift_kernel(const T* __restrict__ u, const T* __restrict__ x, const float* __restrict__ w,
                  float* __restrict__ shift, int head, int V, long long R) {
  __shared__ float snum[TX_HEAD_THREADS / 32];
  __shared__ float sden[TX_HEAD_THREADS / 32];
  const int col = blockIdx.x;  // 0: u; k: value column k - 1
  const long long b = blockIdx.y;
  u += b * R;
  x += b * R * V;
  if (w != nullptr) w += b * R;
  float num = 0.f;
  float den = 0.f;
  for (int j = threadIdx.x; j < head; j += TX_HEAD_THREADS) {
    const float wj = (w != nullptr) ? w[j] : 1.f;
    const float vj =
        (col == 0) ? tx_to_float(u[j]) : tx_to_float(x[(long long)j * V + (col - 1)]);
    num = fmaf(wj, vj, num);
    den += wj;
  }
  num = tx_warp_sum(num);
  den = tx_warp_sum(den);
  if ((threadIdx.x & 31) == 0) {
    snum[threadIdx.x >> 5] = num;
    sden[threadIdx.x >> 5] = den;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float n = snum[0];
    float d = sden[0];
    for (int i = 1; i < TX_HEAD_THREADS / 32; ++i) {
      n += snum[i];
      d += sden[i];
    }
    shift[b * (V + 1) + col] = (d > 0.f) ? n / d : 0.f;
  }
}

__global__ void __launch_bounds__(TX_FIN_THREADS)
finalize_comoments_kernel(const float* __restrict__ part, const float* __restrict__ shift,
                          int shift_stride, float* __restrict__ xave,
                          float* __restrict__ uave, float* __restrict__ du,
                          float* __restrict__ dxdu, float* __restrict__ wsum, int nchunk,
                          int nrep, int V, int order, int gt) {
  __shared__ double red[TX_FIN_THREADS];    // [chunk lane][tile column]
  __shared__ double tsum[TX_FIN_THREADS];   // chunk sums of the tile's columns
  __shared__ double binom[TX_FIN_PAD][TX_FIN_PAD];
  __shared__ double mom[TX_FIN_PAD];        // normalised raw u-moments
  __shared__ double pw[TX_FIN_PAD];         // (-mom[1])^i
  __shared__ double duu[TX_FIN_PAD];        // central u-moments before the fix
  __shared__ double safe_s;

  const int n1 = order + 1;
  const long long m = (long long)(V + 1) * n1;
  const int r = blockIdx.x;
  const int t = threadIdx.x;
  const int width = gt * TX_FIN_PAD;        // columns of a tile, padded
  const int nlane = TX_FIN_THREADS / width; // chunk lanes
  const int vc = t % width;
  const int lane = t / width;
  const int gl = vc / TX_FIN_PAD;
  const int k = vc % TX_FIN_PAD;
  const float* su = shift + (long long)r * shift_stride;
  const float* sx = su + 1;

  {  // Pascal's triangle, exact in float64
    const int n = t / TX_FIN_PAD;
    const int kk = t % TX_FIN_PAD;
    double c = 0.0;
    if (kk <= n) {
      c = 1.0;
      for (int i = 1; i <= kk; ++i) c = c * (double)(n - kk + i) / (double)i;
    }
    binom[n][kk] = c;
  }

  for (int g0 = 0; g0 <= V; g0 += gt) {
    const int g = g0 + gl;
    const bool live = g <= V && k < n1;
    double acc = 0.0;
    if (live) {
      const float* p = part + (long long)r * m + (long long)g * n1 + k;
      const long long stride = (long long)nrep * m;
      for (int ch = lane; ch < nchunk; ch += nlane) acc += (double)p[ch * stride];
    }
    red[lane * width + vc] = acc;
    __syncthreads();
    if (lane == 0) {
      double s = red[vc];
      for (int l = 1; l < nlane; ++l) s += red[l * width + vc];
      tsum[vc] = s;
    }
    __syncthreads();

    if (g0 == 0) {  // the u group leads the first tile
      if (t < TX_FIN_PAD) {
        const double w0 = tsum[0];
        const bool ok = w0 > 0.0;
        const double safe = ok ? w0 : 1.0;
        double v = (t < n1) ? tsum[t] / safe : 0.0;
        if (t == 0) {
          v = ok ? v : 1.0;
          safe_s = safe;
        }
        mom[t] = v;
      }
      __syncthreads();
      if (t < TX_FIN_PAD) {
        const double base = -mom[1];
        double p = 1.0;
        for (int i = 0; i < t; ++i) p *= base;
        pw[t] = p;
      }
      __syncthreads();
      if (t < n1) {
        double s = 0.0;
        for (int kk = 0; kk <= t; ++kk) s += binom[t][kk] * mom[kk] * pw[t - kk];
        duu[t] = s;
        du[(long long)t * nrep + r] = (t == 0) ? 1.f : ((t == 1) ? 0.f : (float)s);
      }
      if (t == 0) {
        uave[r] = (float)(mom[1] + (double)su[0]);
        wsum[r] = (float)tsum[0];
      }
      __syncthreads();
    }

    if (lane == 0 && live && g >= 1) {
      const int kx = g - 1;
      const double* c = tsum + gl * TX_FIN_PAD;
      const double safe = safe_s;
      const double c0 = c[0] / safe;
      double s = 0.0;
      for (int kk = 0; kk <= k; ++kk) s += binom[k][kk] * (c[kk] / safe) * pw[k - kk];
      const double v = s - c0 * duu[k];
      dxdu[((long long)k * nrep + r) * V + kx] = (k == 0) ? 0.f : (float)v;
      if (k == 0) xave[(long long)r * V + kx] = (float)(c0 + (double)sx[kx]);
    }
    __syncthreads();  // the next tile overwrites red and tsum
  }
}

// K5's finalize: see the header comment
__global__ void __launch_bounds__(TX_FIN_THREADS)
finalize_umoments_kernel(const float* __restrict__ part, const float* __restrict__ su,
                         float* __restrict__ uave, float* __restrict__ du,
                         float* __restrict__ wsum, int nchunk, int nrep, int nbatch, int order,
                         int lanes) {
  // `lanes` threads (a power of two, at most a warp) per (replicate, batch
  // row); a group past the last pair sums pair 0 again and stores nothing,
  // so that every lane of a warp meets the __syncwarp
  __shared__ double red[TX_FIN_THREADS][TX_FIN_PAD];
  const long long pairs = (long long)nrep * nbatch;
  const long long pair = (long long)blockIdx.x * (TX_FIN_THREADS / lanes) + threadIdx.x / lanes;
  const int lane = threadIdx.x % lanes;
  const bool live = pair < pairs;
  const int r = live ? (int)(pair / nbatch) : 0;
  const int b = live ? (int)(pair % nbatch) : 0;
  const int n1 = order + 1;
  const long long m = (long long)nbatch * n1;
  double sum[TX_FIN_PAD];
#pragma unroll
  for (int n = 0; n < TX_FIN_PAD; ++n) sum[n] = 0.0;
  const float* p = part + (long long)r * m + (long long)b * n1;
  for (int ch = lane; ch < nchunk; ch += lanes) {  // a lane's chunks in order
#pragma unroll
    for (int n = 0; n < TX_FIN_PAD; ++n) {
      if (n < n1) sum[n] += (double)p[(long long)ch * nrep * m + n];
    }
  }
#pragma unroll
  for (int n = 0; n < TX_FIN_PAD; ++n) red[threadIdx.x][n] = sum[n];
  __syncwarp();
  if (lane != 0 || !live) return;
  for (int l = 1; l < lanes; ++l) {  // then the lanes in order
#pragma unroll
    for (int n = 0; n < TX_FIN_PAD; ++n) sum[n] += red[threadIdx.x + l][n];
  }
  const bool ok = sum[0] > 0.0;
  const double safe = ok ? sum[0] : 1.0;
  double mom[TX_FIN_PAD];
#pragma unroll
  for (int n = 0; n < TX_FIN_PAD; ++n) mom[n] = (n < n1) ? sum[n] / safe : 0.0;
  mom[0] = ok ? mom[0] : 1.0;
  const double base = -mom[1];
  // out[n] = sum_k C(n, k) mom[k] base^(n - k), C(n, k) built exactly
  double pw[TX_FIN_PAD];
  pw[0] = 1.0;
#pragma unroll
  for (int i = 1; i < TX_FIN_PAD; ++i) pw[i] = pw[i - 1] * base;
  const long long o = (long long)r * nbatch + b;
  const long long stride = (long long)nrep * nbatch;
#pragma unroll
  for (int n = 0; n < TX_FIN_PAD; ++n) {
    if (n < n1) {
      double s = 0.0;
      double c = 1.0;  // C(n, kk)
      for (int kk = 0; kk <= n; ++kk) {
        s += c * mom[kk] * pw[n - kk];
        c = c * (double)(n - kk) / (double)(kk + 1);
      }
      du[n * stride + o] = (n == 0) ? 1.f : ((n == 1) ? 0.f : (float)s);
    }
  }
  uave[o] = (float)(mom[1] + (double)su[b]);
  wsum[o] = (float)sum[0];
}

// the tensor cores' helper tx_mma_bf16_16816 on one warp: D = A B + C with
// A (16, 16) and B (16, 8) bf16 bits, row major, C and D (16, 8) float32:
// the parity hook of the fragment layout (common.cuh)
__global__ void mma_probe_kernel(const uint16_t* __restrict__ a, const uint16_t* __restrict__ b,
                                 const float* __restrict__ c, float* __restrict__ d) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  auto pair = [](uint16_t lo, uint16_t hi) { return (uint32_t)lo | ((uint32_t)hi << 16); };
  const uint32_t af[4] = {pair(a[g * 16 + 2 * t], a[g * 16 + 2 * t + 1]),
                          pair(a[(g + 8) * 16 + 2 * t], a[(g + 8) * 16 + 2 * t + 1]),
                          pair(a[g * 16 + 2 * t + 8], a[g * 16 + 2 * t + 9]),
                          pair(a[(g + 8) * 16 + 2 * t + 8], a[(g + 8) * 16 + 2 * t + 9])};
  const uint32_t bf[2] = {pair(b[(2 * t) * 8 + g], b[(2 * t + 1) * 8 + g]),
                          pair(b[(2 * t + 8) * 8 + g], b[(2 * t + 9) * 8 + g])};
  const float cf[4] = {c[g * 8 + 2 * t], c[g * 8 + 2 * t + 1], c[(g + 8) * 8 + 2 * t],
                       c[(g + 8) * 8 + 2 * t + 1]};
  float df[4];
  tx_mma_bf16_16816(df, af, bf, cf);
  d[g * 8 + 2 * t] = df[0];
  d[g * 8 + 2 * t + 1] = df[1];
  d[(g + 8) * 8 + 2 * t] = df[2];
  d[(g + 8) * 8 + 2 * t + 1] = df[3];
}

}  // namespace

extern "C" {

// a (16, 16), b (16, 8) bf16 bits; c, d (16, 8) float32: d = a b + c on the
// tensor cores (one warp).  Returns the launch status.
int tx_mma_probe(const void* a, const void* b, const void* c, void* d, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  mma_probe_kernel<<<1, 32, 0, (cudaStream_t)stream>>>((const uint16_t*)a, (const uint16_t*)b,
                                                       (const float*)c, (float*)d);
  return (int)cudaGetLastError();
}

// u (nbatch, R), x (nbatch, R, V) of the stream type (bf16 != 0: bfloat16,
// else float32; x is not read when V = 0); w (nbatch, R) float32 or null;
// head <= R samples behind the estimate.  Writes shift (nbatch, V + 1)
// float32: (s_u, s_x) of each batch row.  Returns the launch status.
int tx_head_shift(const void* u, const void* x, const void* w, void* shift, int head, int V,
                  long long nbatch, long long R, int bf16, int device, void* stream) {
  if (head < 1 || V < 0 || nbatch < 1 || nbatch > 65535 || R < head) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid((unsigned)(V + 1), (unsigned)nbatch, 1);
  if (bf16) {
    head_shift_kernel<__nv_bfloat16><<<grid, TX_HEAD_THREADS, 0, s>>>(
        (const __nv_bfloat16*)u, (const __nv_bfloat16*)x, (const float*)w, (float*)shift, head,
        V, R);
  } else {
    head_shift_kernel<float><<<grid, TX_HEAD_THREADS, 0, s>>>(
        (const float*)u, (const float*)x, (const float*)w, (float*)shift, head, V, R);
  }
  return (int)cudaGetLastError();
}

// part (nchunk, nrep, (V+1)(order+1)) float32; shift float32, the shift of
// row r at shift + r * shift_stride ((1 + V,): s_u, then s_x).  Writes xave
// (nrep, V), uave (nrep,), du (order+1, nrep), dxdu (order+1, nrep, V) and
// wsum (nrep,) float32.  Returns the launch status.
int tx_finalize_comoments(const void* part, const void* shift, int shift_stride, void* xave,
                          void* uave, void* du, void* dxdu, void* wsum, int nchunk, int nrep,
                          int V, int order, int device, void* stream) {
  if (order < 0 || order > TX_MAX_ORDER || V < 1 || nrep < 1 || nchunk < 1 ||
      shift_stride < 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int gt = 1;  // groups per tile: the power of two covering V + 1, at most 16
  while (gt < V + 1 && gt < TX_FIN_THREADS / TX_FIN_PAD) gt *= 2;
  finalize_comoments_kernel<<<nrep, TX_FIN_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)part, (const float*)shift, shift_stride, (float*)xave, (float*)uave,
      (float*)du, (float*)dxdu, (float*)wsum, nchunk, nrep, V, order, gt);
  return (int)cudaGetLastError();
}

// part (nchunk, nrep, nbatch (order+1)) float32 (K5's partials, or K4's with
// nrep = 1 and nchunk its sample blocks), su (nbatch,)
// float32.  Writes uave (nrep, nbatch), du (order+1, nrep, nbatch) and wsum
// (nrep, nbatch) float32.  Returns the launch status.
int tx_finalize_umoments(const void* part, const void* su, void* uave, void* du, void* wsum,
                         int nchunk, int nrep, int nbatch, int order, int device, void* stream) {
  if (order < 0 || order > TX_MAX_ORDER || nbatch < 1 || nrep < 1 || nchunk < 1) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  // lanes per pair: all of a warp for a few pairs (one row: 256 pairs),
  // fewer once there are threads enough (the lnPi grid: 16384 pairs, 4)
  const long long pairs = (long long)nrep * nbatch;
  int lanes = 32;
  while (lanes > 1 && pairs * lanes > 65536) lanes /= 2;
  const long long per_block = TX_FIN_THREADS / lanes;
  finalize_umoments_kernel<<<(unsigned)((pairs + per_block - 1) / per_block), TX_FIN_THREADS, 0,
                             (cudaStream_t)stream>>>((const float*)part, (const float*)su,
                                                     (float*)uave, (float*)du, (float*)wsum,
                                                     nchunk, nrep, nbatch, order, lanes);
  return (int)cudaGetLastError();
}

}  // extern "C"
