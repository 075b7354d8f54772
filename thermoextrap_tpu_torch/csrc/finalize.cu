// Helper kernels of the K2 / K3 wrapper: the head shift before the bootstrap
// kernel of comoments_resample.cu and the finalize pass after it, so that the
// wrapper is three launches and no tensor arithmetic issued from Python.
//
// Neither has a Pallas counterpart: thermoextrap_tpu/ops/moments_pallas.py
// leaves the shift estimate (_head_shift, :112) and the epilogue of
// resample_central_comoments_fused (:782 on) to XLA, which fuses them; in
// eager PyTorch the same steps are dozens of launches of a few microseconds
// each and took the wrapper's whole time at the main path's shape.
//
// head_shift_kernel: s_u and s_x[k] are the weighted means of the first
// `head` samples, accumulated in float32; 0 where the head's weight is 0 (the
// recentring is exact for any finite shift, 0/0 would poison every output).
//
// finalize_comoments_kernel, one block per replicate r: sums the chunk
// partials part[chunk, r, c] in float64 in a fixed order (a fixed split of the
// chunks over thread lanes, then the lanes in order: no atomics, the same bits
// on every run), normalises by the weight sum with the finite convention of a
// zero-weight replicate (raw moments [1, 0, ...]: its means are the shift and
// its central moments 0), recentres exactly about the mean by the binomial
// transform out[n] = sum_k C(n, k) m[k] (-m[1])^(n-k), forms
// dxdu = x_du - c[0] du, and writes the float32 outputs with du[0] = 1,
// du[1] = 0 and dxdu[0] = 0 exactly.  Columns are c = g (order + 1) + k with
// group g = 0 the u sums and g = kx + 1 the sums of value column kx; a block
// walks the groups in tiles of `gt`, each padded to 16 columns, so its shared
// memory does not grow with V.
//
// Bound: bytes, and tiny ones (nchunk nrep (V+1)(order+1) floats, at most a
// few MB): both kernels cost a launch each and a few microseconds.

#include "common.cuh"

#define TX_FIN_THREADS 256
#define TX_FIN_PAD (TX_MAX_ORDER + 1)
#define TX_HEAD_THREADS 256

static_assert(TX_FIN_PAD * TX_FIN_PAD == TX_FIN_THREADS, "one thread per binomial entry");

namespace {

template <typename T>
__global__ void __launch_bounds__(TX_HEAD_THREADS)
head_shift_kernel(const T* __restrict__ u, const T* __restrict__ x, const float* __restrict__ w,
                  float* __restrict__ su, float* __restrict__ sx, int head, int V) {
  __shared__ float snum[TX_HEAD_THREADS / 32];
  __shared__ float sden[TX_HEAD_THREADS / 32];
  const int col = blockIdx.x;  // 0: u; k: value column k - 1
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
    const float shift = (d > 0.f) ? n / d : 0.f;
    if (col == 0) {
      su[0] = shift;
    } else {
      sx[col - 1] = shift;
    }
  }
}

__global__ void __launch_bounds__(TX_FIN_THREADS)
finalize_comoments_kernel(const float* __restrict__ part, const float* __restrict__ su,
                          const float* __restrict__ sx, float* __restrict__ xave,
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

}  // namespace

extern "C" {

// u (R,), x (R, V) of the stream type (bf16 != 0: bfloat16, else float32);
// w (R,) float32 or null; head <= R samples behind the estimate.  Writes
// su (1,), sx (V,) float32.  Returns the launch status.
int tx_head_shift(const void* u, const void* x, const void* w, void* su, void* sx, int head,
                  int V, int bf16, int device, void* stream) {
  if (head < 1 || V < 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16) {
    head_shift_kernel<__nv_bfloat16><<<V + 1, TX_HEAD_THREADS, 0, s>>>(
        (const __nv_bfloat16*)u, (const __nv_bfloat16*)x, (const float*)w, (float*)su,
        (float*)sx, head, V);
  } else {
    head_shift_kernel<float><<<V + 1, TX_HEAD_THREADS, 0, s>>>(
        (const float*)u, (const float*)x, (const float*)w, (float*)su, (float*)sx, head, V);
  }
  return (int)cudaGetLastError();
}

// part (nchunk, nrep, (V+1)(order+1)) float32, su (1,), sx (V,) float32.
// Writes xave (nrep, V), uave (nrep,), du (order+1, nrep), dxdu (order+1,
// nrep, V) and wsum (nrep,) float32.  Returns the launch status.
int tx_finalize_comoments(const void* part, const void* su, const void* sx, void* xave,
                          void* uave, void* du, void* dxdu, void* wsum, int nchunk, int nrep,
                          int V, int order, int device, void* stream) {
  if (order < 0 || order > TX_MAX_ORDER || V < 1 || nrep < 1 || nchunk < 1) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int gt = 1;  // groups per tile: the power of two covering V + 1, at most 16
  while (gt < V + 1 && gt < TX_FIN_THREADS / TX_FIN_PAD) gt *= 2;
  finalize_comoments_kernel<<<nrep, TX_FIN_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)part, (const float*)su, (const float*)sx, (float*)xave, (float*)uave,
      (float*)du, (float*)dxdu, (float*)wsum, nchunk, nrep, V, order, gt);
  return (int)cudaGetLastError();
}

}  // extern "C"
