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
// The finalize kernel of finalize.cu sums the chunk partials in float64
// (deterministic, no atomics) and recentres exactly: the wrapper is the two
// launches.
//
// The contraction is one of the kernels of resample_tile.cuh: one row (the
// <u> path) runs in the few-rows kernel; a macrostate grid (64 macrostates at
// order 6: 448 rows) on the tensor cores, order 0 in the many-rows FFMA
// kernel.  This file gives them K5's contribution rows (UMomentFill;
// UMomentMmaFill builds each row once per tile as three bf16 terms from
// sample values staged by cp.async).  Bound on the H100 at the grid (256
// replicates, 1e6 samples): 1.15e11 products of a count and a row, 3.42 ms
// as float32 FMAs on the CUDA cores, 0.70 ms as three bf16 products each on
// the tensor cores (989 TFLOP/s dense); reading u takes 0.08 ms and the draw
// 0.18 ms.  The FFMA kernel took 12.4 ms here, held by the shared loads and
// the row building around its FMAs, not by the FMAs (PERF.md).

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

// The rows of the tensor-core kernel (resample_mma_kernel): the sample
// values of a tile staged by cp.async, then each row built once as its three
// bf16 terms.  raw holds u (nsrc, TX_MMA_S) in the stream type, then w
// (nsrc, TX_MMA_S) float32 when there are weights.
template <typename T>
struct UMomentMmaFill {
  static constexpr int VN = 16 / sizeof(T);  // samples of a 16-byte copy
  const T* u;        // (nbatch, R)
  const float* w;    // (nbatch, R) or null
  const float* su;   // (nbatch,)
  long long R;
  int n1;     // order + 1
  int c0;     // first row of the tile
  int ncol;   // rows of the tile
  int b_lo;   // first batch row behind the tile
  int nsrc;   // batch rows behind the tile

  // 16 bytes of n <= per elements of type E from src into dst, zeros after
  // them: by cp.async where src is aligned, else by plain loads
  template <typename E>
  static __device__ __forceinline__ void copy16(char* dst, const E* src, long long n) {
    constexpr int per = 16 / sizeof(E);
    if (n > 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
      tx_cp_async16(dst, src, (int)((n < per ? n : per) * sizeof(E)));
      return;
    }
    E v[per];
    memset(v, 0, sizeof(v));
    for (int e = 0; e < per && e < n; ++e) v[e] = src[e];
    memcpy(dst, v, 16);
  }

  __device__ __forceinline__ void stage(char* raw, long long t0, long long j_end) const {
    constexpr int pu = TX_MMA_S / VN;  // copies of a row's u
    constexpr int pw = TX_MMA_S / 4;   // and of its w
    const int nu = nsrc * pu;
    const int nitem = nu + ((w != nullptr) ? nsrc * pw : 0);
    for (int item = threadIdx.x; item < nitem; item += TX_URS_THREADS) {
      if (item < nu) {
        const int b = item / pu;
        const long long j = t0 + (long long)(item % pu) * VN;
        copy16(raw + ((long long)b * TX_MMA_S + (item % pu) * VN) * sizeof(T),
               u + (long long)(b_lo + b) * R + j, j_end - j);
      } else {
        const int b = (item - nu) / pw;
        const int q = (item - nu) % pw;
        const long long j = t0 + 4LL * q;
        copy16(raw + (long long)nsrc * TX_MMA_S * sizeof(T) + ((long long)b * TX_MMA_S + 4 * q) * 4,
               w + (long long)(b_lo + b) * R + j, j_end - j);
      }
    }
  }

  __device__ __forceinline__ void build(const char* raw, uint16_t* planes, long long t0,
                                        long long j_end) const {
    const T* ru = reinterpret_cast<const T*>(raw);
    const float* rw = reinterpret_cast<const float*>(raw + (long long)nsrc * TX_MMA_S * sizeof(T));
    for (int item = threadIdx.x; item < nsrc * (TX_MMA_S / 4); item += TX_URS_THREADS) {
      const int b = item / (TX_MMA_S / 4);
      const int q = item % (TX_MMA_S / 4);
      const float s = su[b_lo + b];
      float p[4], du[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int at = b * TX_MMA_S + 4 * q + i;
        du[i] = tx_to_float(ru[at]) - s;
        // past j_end the values are zeros: the weight, and every row, is 0
        p[i] = (w != nullptr) ? rw[at] : ((t0 + 4 * q + i < j_end) ? 1.f : 0.f);
      }
      const int row0 = (b_lo + b) * n1 - c0;
#pragma unroll
      for (int n = 0; n <= TX_MAX_ORDER; ++n) {
        if (n < n1) {
          const int cc = row0 + n;
          if ((unsigned)cc < (unsigned)ncol) {
            uint32_t lo[3], hi[3];
            tx_split_bf16x3(p[0], p[1], lo);
            tx_split_bf16x3(p[2], p[3], hi);
#pragma unroll
            for (int k = 0; k < 3; ++k) {
              *reinterpret_cast<uint2*>(planes + k * TX_MMA_PLANE + cc * TX_MMA_RS + 4 * q) =
                  make_uint2(lo[k], hi[k]);
            }
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) p[i] *= du[i];
        }
      }
    }
  }
};

template <typename T>
struct UMomentRows {
  using Filler = UMomentFill<T>;
  using MmaFiller = UMomentMmaFill<T>;
  const T* u;
  const float* w;
  const float* su;
  long long R;
  int n1;

  __device__ __forceinline__ UMomentFill<T> block(int c0, int c_end) const {
    const int b_lo = c0 / n1;
    return {u, w, su, R, n1, c0, c_end - c0, b_lo, (c_end - 1) / n1 - b_lo + 1};
  }

  __device__ __forceinline__ UMomentMmaFill<T> mma_block(int c0, int c_end) const {
    const int b_lo = c0 / n1;
    return {u, w, su, R, n1, c0, c_end - c0, b_lo, (c_end - 1) / n1 - b_lo + 1};
  }
};

// bytes of a tile's staged sample values in the tensor-core kernel: the
// batch rows behind at most TX_MMA_ROWS rows, u and w
inline int umoment_raw_bytes(int nbatch, int order, int elem_bytes, bool weighted) {
  const int n1 = order + 1;
  int nsrc = (TX_MMA_ROWS - 1) / n1 + 2;
  if (nsrc > nbatch) nsrc = nbatch;
  return nsrc * TX_MMA_S * (elem_bytes + (weighted ? 4 : 0));
}

// Which kernel takes K5: up to TX_URS_CB rows the few-rows kernel; more on
// the tensor cores, order 0 excepted (one row per batch row would stage the
// values of up to 224 batch rows a tile, more shared memory than a block
// has), which takes the many-rows FFMA kernel
inline bool umoment_on_tensor_cores(long long m, int order) { return m > TX_URS_CB && order >= 1; }

template <typename T>
int launch_by_counts(const void* u, const void* w, const void* freq, const void* su, void* part,
                     long long R, int nbatch, int order, int nrep, int nchunk, long long chunk,
                     int nr, int np, long long seed, const unsigned int* thresholds,
                     cudaStream_t s) {
  const UMomentRows<T> rows{(const T*)u, (const float*)w, (const float*)su, R, order + 1};
  const int m = nbatch * (order + 1);
  const bool mma = umoment_on_tensor_cores(m, order);
  const int raw_bytes = umoment_raw_bytes(nbatch, order, (int)sizeof(T), w != nullptr);
  if (freq != nullptr) {
    const TableCounts<int32_t> table{(const int32_t*)freq, R};
    if (mma) return launch_mma(rows, table, part, R, m, nrep, nchunk, chunk, raw_bytes, s);
    return launch_resample_rows(rows, table, part, R, m, nrep, nchunk, chunk, nr, np, s);
  }
  PoissonCounts draw;
  if (!make_poisson(seed, thresholds, &draw)) return (int)cudaErrorInvalidValue;
  if (mma) return launch_mma(rows, draw, part, R, m, nrep, nchunk, chunk, raw_bytes, s);
  return launch_resample_rows(rows, draw, part, R, m, nrep, nchunk, chunk, nr, np, s);
}

}  // namespace

extern "C" {

// u (nbatch, R) of the stream type (bf16 != 0: bfloat16, else float32);
// w (nbatch, R) float32 or null; su (nbatch,) float32.  freq: null for the
// Poisson counts drawn from (seed, thresholds[9]), or an int32 (nrep, R)
// count table whose entries replace the draws (the parity hook).  On the
// tensor cores (umoment_on_tensor_cores) chunk is a multiple of TX_MMA_S and
// nr, np are not read; otherwise nr, np are the row- and replicate-threads of
// a block (resample_rows_shape_ok) and chunk a multiple of the kernel's
// sample tile.  Writes part (nchunk, nrep, nbatch (order+1)) float32, chunk
// samples per chunk.  Returns the launch status.
int tx_resample_umoments(const void* u, const void* w, const void* freq, const void* su,
                         void* part, long long nbatch, long long R, int order, int nrep,
                         int nchunk, long long chunk, int nr, int np, int bf16,
                         long long seed, const unsigned int* thresholds, int device,
                         void* stream) {
  const long long m = nbatch * (order + 1);
  if (order < 0 || order > TX_MAX_ORDER || nbatch < 1 || nbatch > 2147483647LL / (order + 1)) {
    return (int)cudaErrorInvalidValue;
  }
  const bool shape_ok =
      umoment_on_tensor_cores(m, order)
          ? resample_mma_shape_ok(m, R, nrep, nchunk, chunk,
                                  umoment_raw_bytes((int)nbatch, order, bf16 ? 2 : 4, w != nullptr))
          : resample_rows_shape_ok(m, R, nrep, nchunk, chunk, nr, np);
  if (!shape_ok) return (int)cudaErrorInvalidValue;
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
