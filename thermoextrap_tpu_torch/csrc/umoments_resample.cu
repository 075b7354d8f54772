// K5: Poisson bootstrap of batched u-moments, counts drawn in the kernel.
//
// Replaces thermoextrap_tpu/ops/moments_pallas.py
//   K5 resample_central_umoments_batched_poisson
//      (kernel _poisson_resample_u_batched_kernel, :1092)
// the bootstrap of the lnPi macrostate grid and of the flat <u> path.  One
// count per (replicate, sample), shared by every batch row: a replicate
// resamples whole configurations across the grid.  The counts come from the
// Philox schedule of philox.cuh, which takes no batch-row index, so K5 on one
// row draws exactly K3's counts at equal seed.
//
// For replicate r and contribution row c = b (order + 1) + n:
//   part[chunk, r, c] = sum_{j in chunk} count(r, j) w_bj (u_bj - s_u[b])^n
// The caller sums the chunk partials in float64 (deterministic, no atomics)
// and recentres exactly.
//
// The contraction is one of the two kernels of resample_tile.cuh (what bounds
// them is said there): a macrostate grid runs in the many-rows kernel, one
// row (the <u> path) in the few-rows kernel; this file gives them K5's
// contribution rows.

#include "resample_tile.cuh"

namespace {

// rows c = b (order + 1) + n of the batch rows behind a block's row tile
template <typename T>
struct UMomentFill {
  // one (batch row, sample) item of the few-rows kernel: u and its weight
  struct Raw {
    float u, w;
  };
  const T* u;        // (nbatch, R)
  const float* w;    // (nbatch, R) or null
  const float* su;   // (nbatch,)
  long long R;
  int n1;     // order + 1
  int c0;     // first row of the tile
  int ncol;   // rows of the tile
  int b_lo;   // first batch row behind the tile
  int nsrc;   // batch rows behind the tile

  static __device__ __forceinline__ void keep(Raw& raw) {
    tx_keep(raw.u);
    tx_keep(raw.w);
  }

  __device__ __forceinline__ Raw fetch(int item, long long t0, long long j_end) const {
    const long long j = t0 + item % TX_FEW_TILE;
    Raw raw = {0.f, 0.f};
    if (j < j_end) {
      const long long off = (long long)(b_lo + item / TX_FEW_TILE) * R + j;
      raw.u = tx_to_float(u[off]);
      raw.w = (w != nullptr) ? w[off] : 1.f;
    }
    return raw;
  }

  __device__ __forceinline__ void store(Raw raw, int item, float* tile, int gstride,
                                        long long t0, long long j_end) const {
    const int i = item % TX_FEW_TILE;
    const int b = b_lo + item / TX_FEW_TILE;
    float* at = tile + (i >> 2) * gstride + (i & 3);
    float p = raw.w;  // 0 past j_end, and so is every row
    const float du = (t0 + i < j_end) ? raw.u - su[b] : 0.f;
    const int row0 = b * n1 - c0;
#pragma unroll
    for (int n = 0; n <= TX_MAX_ORDER; ++n) {
      if (n < n1) {
        const int cc = row0 + n;
        if ((unsigned)cc < (unsigned)ncol) at[4 * cc] = p;
        p *= du;
      }
    }
  }

  __device__ __forceinline__ void fill(float* tile, int tstride, long long t0,
                                       long long j_end) const {
    // one (batch row, sample) pair per item, 8 items a thread on a 64-row
    // grid; unrolled by two, which on an H100 runs that shape 5% faster than
    // the compiler's own choice
#pragma unroll 2
    for (int item = threadIdx.x; item < nsrc * TX_URS_TILE; item += TX_URS_THREADS) {
      const int b = b_lo + item / TX_URS_TILE;
      const int i = item % TX_URS_TILE;
      const long long j = t0 + i;
      const bool valid = j < j_end;
      const long long off = (long long)b * R + j;
      float p = valid ? ((w != nullptr) ? w[off] : 1.f) : 0.f;
      const float du = valid ? tx_to_float(u[off]) - su[b] : 0.f;
      const int row0 = b * n1 - c0;
#pragma unroll
      for (int n = 0; n <= TX_MAX_ORDER; ++n) {
        if (n < n1) {
          const int cc = row0 + n;
          if ((unsigned)cc < (unsigned)ncol) tile[i * tstride + cc] = p;
          p *= du;
        }
      }
    }
  }
};

template <typename T>
struct UMomentRows {
  using Filler = UMomentFill<T>;
  const T* u;
  const float* w;
  const float* su;
  long long R;
  int n1;

  __device__ __forceinline__ UMomentFill<T> block(int c0, int c_end) const {
    const int b_lo = c0 / n1;
    return {u, w, su, R, n1, c0, c_end - c0, b_lo, (c_end - 1) / n1 - b_lo + 1};
  }
};

template <typename T>
int launch_by_counts(const void* u, const void* w, const void* freq, const void* su, void* part,
                     long long R, int nbatch, int order, int nrep, int nchunk, long long chunk,
                     int nr, int np, long long seed, const unsigned int* thresholds,
                     cudaStream_t s) {
  const UMomentRows<T> rows{(const T*)u, (const float*)w, (const float*)su, R, order + 1};
  const int m = nbatch * (order + 1);
  if (freq != nullptr) {
    return launch_resample_rows(rows, TableCounts<int32_t>{(const int32_t*)freq, R}, part, R, m,
                                nrep, nchunk, chunk, nr, np, s);
  }
  PoissonCounts draw;
  if (!make_poisson(seed, thresholds, &draw)) return (int)cudaErrorInvalidValue;
  return launch_resample_rows(rows, draw, part, R, m, nrep, nchunk, chunk, nr, np, s);
}

}  // namespace

extern "C" {

// u (nbatch, R) of the stream type (bf16 != 0: bfloat16, else float32);
// w (nbatch, R) float32 or null; su (nbatch,) float32.  freq: null for the
// Poisson counts drawn from (seed, thresholds[9]), or an int32 (nrep, R)
// count table whose entries replace the draws (the parity hook).  nr, np:
// row- and replicate-threads of a block (powers of two, nr np divides 256,
// 256 / (nr np) divides 32).  Writes part (nchunk, nrep, nbatch (order+1))
// float32, chunk samples per chunk (a multiple of TX_URS_TILE).  Returns the
// launch status.
int tx_resample_umoments(const void* u, const void* w, const void* freq, const void* su,
                         void* part, long long nbatch, long long R, int order, int nrep,
                         int nchunk, long long chunk, int nr, int np, int bf16,
                         long long seed, const unsigned int* thresholds, int device,
                         void* stream) {
  if (order < 0 || order > TX_MAX_ORDER || nbatch < 1 ||
      !resample_rows_shape_ok(nbatch * (order + 1), R, nrep, nchunk, chunk, nr, np)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16) {
    return launch_by_counts<__nv_bfloat16>(u, w, freq, su, part, R, (int)nbatch, order, nrep,
                                           nchunk, chunk, nr, np, seed, thresholds, s);
  }
  return launch_by_counts<float>(u, w, freq, su, part, R, (int)nbatch, order, nrep, nchunk,
                                 chunk, nr, np, seed, thresholds, s);
}

}  // extern "C"
