// K2 and K3: per-replicate bootstrap comoment sums, on the shared
// contraction of resample_tile.cuh.
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
// with du = u - s_u, dx = x - s_x (dx_j,-1 = 1).  The shift comes from the
// head-shift kernel of finalize.cu, and its finalize kernel sums the chunk
// partials in float64 (deterministic second pass, no atomics) and recentres
// exactly: the wrapper is those three launches.
//
// This file gives the contraction of resample_tile.cuh K2's and K3's rows
// (ComomentRows); the contraction is the one K5, K7 and K8 run.  Up to 16
// rows (the main path: V = 1 at order 6, 14 rows; the volume path, 6 rows)
// with integer counts (the draw, int8 / int16 / int32 tables) run in its
// few-rows tensor-core kernel (comoment_on_tensor_cores), where each count
// goes from the draw, or the table, straight into an A fragment of mma.sync
// and never touches shared memory; fractional tables run in its few-rows
// kernel on the CUDA cores, and more rows in its many-rows kernel, which
// draws or loads each count once per block for up to 512 rows.  Both count
// sources take the same path through the sums, so K3 on a seed equals K2 on
// that seed's count table (tx_poisson_counts) bit for bit.
//
// Bound on the H100: K2 streams the count table (nrep R entries, 1-4 bytes
// each, 4 to a vector load) and does (order+1)(V+1) FMAs per entry; the
// row-wise reads of the table are what hold it, as they hold K7 and
// torch.matmul on the same table.  K3 reads only the samples; its least time
// is the draw's integer work (a quarter of a Philox4x32-10 call and one level
// lookup a count, philox.cuh).  On the CUDA cores the draw and the FMAs
// ((order+1)(V+1) a count, rounded up to a multiple of 4: 16 at the main
// path's 14 rows) shared the dispatch slots and added up, so the contraction
// runs on the tensor cores: the CUDA cores draw and pack the counts (~17
// instructions a count), the tensor cores take the products.  The sums keep
// float32 accuracy (a looser TPU precision measured 2e-3 wrong): counts are
// exact bf16 digits, rows three bf16 terms, every product exact, the sums
// float32, a tile's terms added into a float32 temporary that joins the
// running sum by one FADD; no TF32 and no dropped term.
//
// The stream type (float32 or bfloat16) is a runtime flag of ComomentFill:
// the rows are built once per sample tile, away from the count loop, and one
// kernel for both types halves the build.  Tables of int8,
// int16 and bfloat16 run in the few-rows kernels only (the wrapper widens them
// for more rows), which keeps the file at 15 kernels.

#include "resample_tile.cuh"

namespace {

// a sample stream of float32 or bfloat16 values, read as float32
struct Stream {
  const void* p;
  int bf16;
  __device__ __forceinline__ float operator[](long long i) const {
    return bf16 ? tx_to_float(static_cast<const __nv_bfloat16*>(p)[i])
                : static_cast<const float*>(p)[i];
  }
};

// rows c = (kx + 1) (order + 1) + n of the value columns behind a block's row
// tile; the u rows count as column kx = -1 (a "source" of the few-rows
// kernel is one column)
struct ComomentFill {
  // one (column, sample) item of the few-rows kernel: u, its weight and the
  // column's value (1 for the u rows)
  struct Raw {
    float u, w, x;
  };
  Stream u;          // (R,)
  Stream x;          // (R, V)
  const float* w;    // (R,) or null
  const float* su;   // (1,)
  const float* sx;   // (V,)
  long long R;
  int V;
  int n1;     // order + 1
  int c0;     // first row of the tile
  int ncol;   // rows of the tile
  int k_lo;   // column of the tile's first row (-1: the u rows)
  int nsrc;   // columns behind the tile

  static __device__ __forceinline__ void keep(Raw& raw) {
    tx_keep(raw.u);
    tx_keep(raw.w);
    tx_keep(raw.x);
  }

  // at[stride (c - c0)] = w du^n dx for the rows c = (k + 1) n1 + n of the
  // tile, p = w on entry
  __device__ __forceinline__ void rows(float* at, int stride, int k, float p, float du,
                                       float dx) const {
    const int row0 = (k + 1) * n1 - c0;
#pragma unroll
    for (int n = 0; n <= TX_MAX_ORDER; ++n) {
      if (n < n1) {
        const int cc = row0 + n;
        if ((unsigned)cc < (unsigned)ncol) at[stride * cc] = p * dx;
        p *= du;
      }
    }
  }

  __device__ __forceinline__ Raw fetch(int item, long long t0, long long j_end) const {
    const long long j = t0 + item % TX_FEW_TILE;
    const int k = k_lo + item / TX_FEW_TILE;
    Raw raw = {0.f, 0.f, 0.f};
    if (j < j_end) {
      raw.u = u[j];
      raw.w = (w != nullptr) ? w[j] : 1.f;
      raw.x = (k < 0) ? 1.f : x[j * V + k];
    }
    return raw;
  }

  __device__ __forceinline__ void store(Raw raw, int item, float* tile, int gstride,
                                        long long t0, long long j_end) const {
    const int i = item % TX_FEW_TILE;
    const int k = k_lo + item / TX_FEW_TILE;
    const bool valid = t0 + i < j_end;  // raw.w is 0 past j_end, and so is every row
    const float du = valid ? raw.u - su[0] : 0.f;
    const float dx = (k < 0) ? 1.f : (valid ? raw.x - sx[k] : 0.f);
    rows(tile + (i >> 2) * gstride + (i & 3), 4, k, raw.w, du, dx);
  }

  // one (column, pair of samples) item of the few-rows tensor-core kernel
  struct RawPair {
    Raw s[2];
  };

  static __device__ __forceinline__ void keep_pair(RawPair& raw) {
    keep(raw.s[0]);
    keep(raw.s[1]);
  }

  __device__ __forceinline__ RawPair fetch_pair(int item, long long t0, long long j_end) const {
    const long long t = t0 + 2 * (item % (TX_FMMA_S / 2));
    const int i = (item / (TX_FMMA_S / 2)) * TX_FEW_TILE;  // fetch's item of the same column
    return {{fetch(i, t, j_end), fetch(i, t + 1, j_end)}};
  }

  // the column's rows of both samples as three bf16 terms, one 32-bit word
  // (the pair) per plane and row
  __device__ __forceinline__ void store_planes(const RawPair& raw, int item, uint32_t* planes,
                                               long long t0, long long j_end) const {
    const int p = item % (TX_FMMA_S / 2);
    const int k = k_lo + item / (TX_FMMA_S / 2);
    float pw[2], du[2], dx[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const bool valid = t0 + 2 * p + h < j_end;  // raw.w is 0 past j_end, and so is every row
      pw[h] = raw.s[h].w;
      du[h] = valid ? raw.s[h].u - su[0] : 0.f;
      dx[h] = (k < 0) ? 1.f : (valid ? raw.s[h].x - sx[k] : 0.f);
    }
    const int row0 = (k + 1) * n1 - c0;
#pragma unroll
    for (int n = 0; n <= TX_MAX_ORDER; ++n) {
      if (n < n1) {
        const int cc = row0 + n;
        if ((unsigned)cc < (unsigned)ncol) {
          uint32_t terms[3];
          tx_split_bf16x3(pw[0] * dx[0], pw[1] * dx[1], terms);
#pragma unroll
          for (int q = 0; q < 3; ++q) planes[q * TX_FMMA_PLANE_W + cc * TX_FMMA_RS_W + p] = terms[q];
        }
        pw[0] *= du[0];
        pw[1] *= du[1];
      }
    }
  }

  __device__ __forceinline__ void fill(float* tile, int tstride, long long t0,
                                       long long j_end) const {
    // one (column, sample) pair per item
    for (int item = threadIdx.x; item < nsrc * TX_URS_TILE; item += TX_URS_THREADS) {
      const int k = k_lo + item / TX_URS_TILE;
      const int i = item % TX_URS_TILE;
      const long long j = t0 + i;
      const bool valid = j < j_end;
      const float p = valid ? ((w != nullptr) ? w[j] : 1.f) : 0.f;
      const float du = valid ? u[j] - su[0] : 0.f;
      const float dx = (k < 0) ? 1.f : (valid ? x[j * V + k] - sx[k] : 0.f);
      rows(tile + i * tstride, 1, k, p, du, dx);
    }
  }
};

struct ComomentRows {
  using Filler = ComomentFill;
  Stream u, x;
  const float* w;
  const float* su;
  const float* sx;
  long long R;
  int V;
  int n1;

  __device__ __forceinline__ ComomentFill block(int c0, int c_end) const {
    const int s_lo = c0 / n1;
    return {u, x, w, su, sx, R, V, n1, c0, c_end - c0, s_lo - 1, (c_end - 1) / n1 - s_lo + 1};
  }
};

// K2/K3 up to 16 rows with integer counts (the draw, int8 / int16 / int32
// tables) run in the few-rows tensor-core kernel; fractional tables and more
// rows stay on the CUDA cores
inline bool comoment_on_tensor_cores(long long m, int count_kind) {
  return m <= TX_URS_CB && (count_kind == 0 || count_kind == 1 || count_kind == 2 || count_kind == 5);
}

int launch_by_counts(const ComomentRows& rows, const void* freq, void* part, long long R, int m,
                     int nrep, int nchunk, long long chunk, int nr, int np, int count_kind,
                     long long seed, const unsigned int* thresholds, cudaStream_t s) {
  const bool few = m <= TX_URS_CB;
  switch (count_kind) {
    case 0:
      if (!few) return (int)cudaErrorInvalidValue;
      return launch_fewmma(rows, TableCounts<int8_t>{(const int8_t*)freq, R}, part, R, m, nrep,
                           nchunk, chunk, s);
    case 1:
      if (!few) return (int)cudaErrorInvalidValue;
      return launch_fewmma(rows, TableCounts<int16_t>{(const int16_t*)freq, R}, part, R, m, nrep,
                           nchunk, chunk, s);
    case 2: {
      const TableCounts<int32_t> table{(const int32_t*)freq, R};
      if (few) return launch_fewmma(rows, table, part, R, m, nrep, nchunk, chunk, s);
      return launch_manyrows(rows, table, part, R, m, nrep, nchunk, chunk, nr, np, s);
    }
    case 3:
      return launch_resample_rows(rows, TableCounts<float>{(const float*)freq, R}, part, R, m,
                                  nrep, nchunk, chunk, nr, np, s);
    case 4:
      if (!few) return (int)cudaErrorInvalidValue;
      return launch_fewrows(rows, TableCounts<__nv_bfloat16>{(const __nv_bfloat16*)freq, R},
                            part, R, m, nrep, nchunk, chunk, np, s);
    case 5: {
      PoissonCounts draw;
      if (!make_poisson(seed, thresholds, &draw)) return (int)cudaErrorInvalidValue;
      if (few) return launch_fewmma(rows, draw, part, R, m, nrep, nchunk, chunk, s);
      return launch_manyrows(rows, draw, part, R, m, nrep, nchunk, chunk, nr, np, s);
    }
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// the in-kernel Poisson counts as a table (nrep, R) int32: the parity hook
// that holds K3's draws against their plain torch reproduction
__global__ void poisson_counts_kernel(PoissonCounts counts, int32_t* __restrict__ out,
                                      long long R) {
  counts.init();
  __syncthreads();
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

struct PoissonThresholds {
  uint32_t t[TX_POISSON_NT];
};

// the draw's word -> count map against the 9-compare sum, word by word:
// stats += (words seen, words where the two differ, sum of the map's counts)
__global__ void poisson_map_kernel(PoissonCounts counts, PoissonThresholds th,
                                   const uint32_t* __restrict__ words, long long start,
                                   long long n, int32_t* __restrict__ out,
                                   unsigned long long* __restrict__ stats) {
  __shared__ unsigned long long block_stats[3];
  counts.init();
  if (threadIdx.x < 3) block_stats[threadIdx.x] = 0;
  __syncthreads();
  unsigned long long seen = 0, wrong = 0, total = 0;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const uint32_t word = (words != nullptr) ? words[i] : (uint32_t)(start + i);
    const int got = (int)poisson_level_count(word);
    seen += 1;
    wrong += (got != poisson_compare_count(word, th.t)) ? 1 : 0;
    total += (unsigned long long)got;
    if (out != nullptr) out[i] = got;
  }
  atomicAdd(&block_stats[0], seen);
  atomicAdd(&block_stats[1], wrong);
  atomicAdd(&block_stats[2], total);
  __syncthreads();
  if (threadIdx.x < 3) atomicAdd(&stats[threadIdx.x], block_stats[threadIdx.x]);
}

}  // namespace

extern "C" {

// u (R,), x (R, V) of the stream type (bf16 != 0: bfloat16, else float32);
// w (R,) float32 or null; su (1,), sx (V,) float32.  count_kind: 0 int8,
// 1 int16, 2 int32, 3 float32, 4 bfloat16 table freq (nrep, R) (0, 1 and 4
// for at most 16 rows); 5 Poisson counts drawn from (seed, thresholds[9])
// with freq unused.  nr, np: row- and replicate-threads of a block
// (resample_rows_shape_ok of resample_tile.cuh).  Writes part (nchunk, nrep,
// (V+1)(order+1)) float32, chunk samples per chunk.  Returns the launch
// status.
int tx_resample_comoments(const void* u, const void* x, const void* w, const void* freq,
                          const void* su, const void* sx, void* part, long long R, int V,
                          int order, int nrep, int nchunk, long long chunk, int nr, int np,
                          int bf16, int count_kind, long long seed,
                          const unsigned int* thresholds, int device, void* stream) {
  const long long m = (long long)(V + 1) * (order + 1);
  const bool shape_ok = comoment_on_tensor_cores(m, count_kind)
                            ? resample_fewmma_shape_ok(m, R, nrep, nchunk, chunk)
                            : resample_rows_shape_ok(m, R, nrep, nchunk, chunk, nr, np);
  if (order < 0 || order > TX_MAX_ORDER || V < 1 || !shape_ok ||
      (count_kind != 5 && freq == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const ComomentRows rows{{u, bf16}, {x, bf16}, (const float*)w, (const float*)su,
                          (const float*)sx, R, V, order + 1};
  return launch_by_counts(rows, freq, part, R, (int)m, nrep, nchunk, chunk, nr, np, count_kind,
                          seed, thresholds, (cudaStream_t)stream);
}

// out (nrep, R) int32: the Poisson counts K3 draws for (seed, r, j).
int tx_poisson_counts(void* out, long long R, int nrep, long long seed,
                      const unsigned int* thresholds, int device, void* stream) {
  PoissonCounts draw;
  if (R < 1 || nrep < 1 || nrep > 65535 || !make_poisson(seed, thresholds, &draw)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long groups = (R + 3) / 4;
  const dim3 grid((unsigned)((groups + 255) / 256), (unsigned)nrep, 1);
  poisson_counts_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(draw, (int32_t*)out, R);
  return (int)cudaGetLastError();
}

// The draw's word -> count map on n words, words[i] or (start + i) mod 2^32
// where words is null, against #{q : word > thresholds[q]}.  Adds (words
// seen, words where the two differ, sum of the map's counts) to stats (3,)
// uint64, and writes the map's count of word i to out[i] (int32) unless out
// is null.  Returns the launch status.
int tx_poisson_map(const void* words, long long start, long long n, void* out, void* stats,
                   const unsigned int* thresholds, int device, void* stream) {
  PoissonCounts draw;
  if (n < 1 || !make_poisson(0, thresholds, &draw)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  PoissonThresholds th;
  for (int q = 0; q < TX_POISSON_NT; ++q) th.t[q] = thresholds[q];
  const long long blocks = (n + 255) / 256;
  const dim3 grid((unsigned)(blocks < 132 * 16 ? blocks : 132 * 16), 1, 1);
  poisson_map_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      draw, th, (const uint32_t*)words, start, n, (int32_t*)out, (unsigned long long*)stats);
  return (int)cudaGetLastError();
}

}  // extern "C"
