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
// Bound on the H100: instruction throughput.  Each count costs a quarter of a
// Philox4x32-10 call and 9 compares, then one FMA per contribution row
// (nbatch (order+1) of them, 448 on a 64-macrostate grid at order 6).  A
// kernel that tiles rows across blocks redraws every count once per row tile
// (K3's 16-row tiles would draw each count 28 times there).  The simple
// design: a block owns a tile of up to 512 contribution rows and up to 128
// replicates; for each tile of TX_URS_TILE samples it draws every count of
// its replicates ONCE into shared memory and builds every contribution row
// once, then each thread accumulates a 4-replicate x 16-row outer product in
// f32 FMAs (no tensor cores, no TF32: the sums must hold f32 accuracy).  The
// 256 threads split as nr row-threads x np replicate-threads x sl sample
// lanes (sl divides 32; the lanes are summed with shuffles at the end), so a
// 448-row grid takes one row tile (each count drawn once per replicate
// block) and the 8-row flat path spreads its threads over replicates and
// samples instead of idling.

#include "philox.cuh"

#define TX_URS_THREADS 256
#define TX_URS_RB 4
#define TX_URS_CB 16
#define TX_URS_TILE 32

namespace {

__device__ __forceinline__ float sum_lanes(float v, int sl) {
  for (int off = sl >> 1; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T, typename Counts>
__global__ void __launch_bounds__(TX_URS_THREADS)
resample_umoments_kernel(const T* __restrict__ u, const float* __restrict__ w,
                         const float* __restrict__ su, Counts counts, float* __restrict__ part,
                         long long R, int nbatch, int order, int nrep, long long chunk, int nr,
                         int np) {
  extern __shared__ __align__(16) float smem[];
  const int n1 = order + 1;
  const int m = nbatch * n1;
  const int sl = TX_URS_THREADS / (nr * np);
  const int rows_block = nr * TX_URS_CB;
  const int reps_block = np * TX_URS_RB;
  const int tstride = rows_block + 1;  // odd strides spread the shared banks
  const int cstride = reps_block + 1;
  float* tile = smem;                            // [TILE][rows_block + 1]
  float* cnt = smem + TX_URS_TILE * tstride;     // [TILE][reps_block + 1]

  const int c0 = blockIdx.z * rows_block;
  const int r0 = blockIdx.y * reps_block;
  const long long j_begin = (long long)blockIdx.x * chunk;
  const long long j_end = (j_begin + chunk < R) ? j_begin + chunk : R;
  const int c_end = (c0 + rows_block < m) ? c0 + rows_block : m;
  const int b_lo = c0 / n1;
  const int nb = (c_end - 1) / n1 - b_lo + 1;  // batch rows behind the row tile

  const int s = threadIdx.x % sl;
  const int rt = (threadIdx.x / sl) % nr;
  const int pt = threadIdx.x / (sl * nr);

  float acc[TX_URS_RB][TX_URS_CB];
#pragma unroll
  for (int i = 0; i < TX_URS_RB; ++i)
#pragma unroll
    for (int k = 0; k < TX_URS_CB; ++k) acc[i][k] = 0.f;

  for (long long t0 = j_begin; t0 < j_end; t0 += TX_URS_TILE) {
    __syncthreads();  // the previous tile has been consumed
    // contribution rows w du^n, one (batch row, sample) pair per item
    for (int item = threadIdx.x; item < nb * TX_URS_TILE; item += TX_URS_THREADS) {
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
        if (n <= order) {
          const int cc = row0 + n;
          if (cc >= 0 && cc < rows_block) tile[i * tstride + cc] = p;
          p *= du;
        }
      }
    }
    // counts: each (replicate, 4 samples) of the block drawn once
    for (int item = threadIdx.x; item < reps_block * (TX_URS_TILE / 4);
         item += TX_URS_THREADS) {
      const int rr = item / (TX_URS_TILE / 4);
      const int q = 4 * (item % (TX_URS_TILE / 4));
      const int r = r0 + rr;
      float f[4] = {0.f, 0.f, 0.f, 0.f};
      if (r < nrep && t0 + q < j_end) counts.load4(r, t0 + q, f);
#pragma unroll
      for (int e = 0; e < 4; ++e) cnt[(q + e) * cstride + rr] = f[e];
    }
    __syncthreads();

    for (int i = s; i < TX_URS_TILE; i += sl) {
      float f[TX_URS_RB];
      float cv[TX_URS_CB];
#pragma unroll
      for (int a = 0; a < TX_URS_RB; ++a) f[a] = cnt[i * cstride + pt + np * a];
#pragma unroll
      for (int k = 0; k < TX_URS_CB; ++k) cv[k] = tile[i * tstride + rt + nr * k];
#pragma unroll
      for (int a = 0; a < TX_URS_RB; ++a)
#pragma unroll
        for (int k = 0; k < TX_URS_CB; ++k) acc[a][k] = fmaf(f[a], cv[k], acc[a][k]);
    }
  }

#pragma unroll
  for (int a = 0; a < TX_URS_RB; ++a) {
    const int r = r0 + pt + np * a;
#pragma unroll
    for (int k = 0; k < TX_URS_CB; ++k) {
      const int c = c0 + rt + nr * k;
      const float v = sum_lanes(acc[a][k], sl);
      if (s == 0 && r < nrep && c < m) part[((long long)blockIdx.x * nrep + r) * m + c] = v;
    }
  }
}

template <typename T, typename Counts>
int launch_umoments(dim3 grid, size_t smem, cudaStream_t s, const void* u, const void* w,
                    const void* su, Counts counts, void* part, long long R, int nbatch,
                    int order, int nrep, long long chunk, int nr, int np) {
  auto kernel = resample_umoments_kernel<T, Counts>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, TX_URS_THREADS, smem, s>>>((const T*)u, (const float*)w, (const float*)su,
                                            counts, (float*)part, R, nbatch, order, nrep,
                                            chunk, nr, np);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_by_counts(dim3 grid, size_t smem, cudaStream_t s, const void* u, const void* w,
                     const void* freq, const void* su, void* part, long long R, int nbatch,
                     int order, int nrep, long long chunk, int nr, int np, long long seed,
                     const unsigned int* thresholds) {
  if (freq != nullptr) {
    return launch_umoments<T>(grid, smem, s, u, w, su,
                              TableCounts<int32_t>{(const int32_t*)freq, R}, part, R, nbatch,
                              order, nrep, chunk, nr, np);
  }
  return launch_umoments<T>(grid, smem, s, u, w, su, make_poisson(seed, thresholds, R), part,
                            R, nbatch, order, nrep, chunk, nr, np);
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
  if (order < 0 || order > TX_MAX_ORDER || nbatch < 1 || nrep < 1 || R < 1 || nchunk < 1 ||
      nr < 1 || np < 1 || TX_URS_THREADS % (nr * np) != 0 ||
      32 % (TX_URS_THREADS / (nr * np)) != 0 || chunk % TX_URS_TILE != 0 ||
      (long long)nchunk * chunk < R || nbatch * (order + 1) > 2147483647LL) {
    return (int)cudaErrorInvalidValue;
  }
  const long long m = nbatch * (order + 1);
  const long long rows_block = (long long)nr * TX_URS_CB;
  const long long reps_block = (long long)np * TX_URS_RB;
  const long long ycount = (nrep + reps_block - 1) / reps_block;
  const long long zcount = (m + rows_block - 1) / rows_block;
  if (ycount > 65535 || zcount > 65535) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = sizeof(float) * TX_URS_TILE * (rows_block + 1 + reps_block + 1);
  const dim3 grid((unsigned)nchunk, (unsigned)ycount, (unsigned)zcount);
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16) {
    return launch_by_counts<__nv_bfloat16>(grid, smem, s, u, w, freq, su, part, R, (int)nbatch,
                                           order, nrep, chunk, nr, np, seed, thresholds);
  }
  return launch_by_counts<float>(grid, smem, s, u, w, freq, su, part, R, (int)nbatch, order,
                                 nrep, chunk, nr, np, seed, thresholds);
}

}  // extern "C"
