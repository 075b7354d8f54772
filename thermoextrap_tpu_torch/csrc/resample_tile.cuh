// The bootstrap contraction shared by K5 and K7/K8: counts drawn (or loaded)
// once per (replicate, sample) into shared memory and consumed by every
// contribution row of the block.
//
//   part[chunk, r, c] = sum_{j in chunk} count(r, j) row_c(j)
//
// over m contribution rows c that a `Rows` functor builds per sample tile
// (K5: w du^n per batch row; K7/K8: e_a [x | 1] per target) and a `Counts`
// source of philox.cuh (the in-kernel Poisson draw or a materialized table).
// The caller sums the chunk partials in float64 (deterministic, no atomics).
//
// Bound on the H100: instruction throughput.  Each count costs a quarter of a
// Philox4x32-10 call and 9 compares, then one FMA per contribution row.  A
// kernel that tiles rows across blocks redraws every count once per row tile
// (K3's 16-row tiles would draw each count 28 times on a 448-row grid).  The
// simple design: a block owns a tile of up to 512 contribution rows and up to
// 128 replicates; for each tile of TX_URS_TILE samples it draws every count
// of its replicates ONCE into shared memory and builds every contribution row
// once, then each thread accumulates a 4-replicate x 16-row outer product in
// f32 FMAs (no tensor cores, no TF32: the sums must hold f32 accuracy).  The
// 256 threads split as nr row-threads x np replicate-threads x sl sample
// lanes (sl divides 32; the lanes are summed with shuffles at the end), so a
// 448-row grid takes one row tile (each count drawn once per replicate
// block) and an 8-row path spreads its threads over replicates and samples
// instead of idling.  Both count sources take the same path through the
// sums, so a draw and its materialized table give the same bits.
#pragma once

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

// Rows::block(c0, c_end) gives the filler of a block's row tile, built once
// before the sample loop (whatever it divides or looks up stays out of the
// loop).  Its fill(tile, tstride, t0, j_end) writes, with every thread of the
// block taking part, tile[i * tstride + (c - c0)] = row_c(t0 + i) for
// c0 <= c < c_end and 0 <= i < TX_URS_TILE, zero where t0 + i >= j_end.
template <typename Rows, typename Counts>
__global__ void __launch_bounds__(TX_URS_THREADS)
resample_rows_kernel(Rows rows, Counts counts, float* __restrict__ part, long long R, int m,
                     int nrep, long long chunk, int nr, int np) {
  extern __shared__ __align__(16) float smem[];
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
  const auto filler = rows.block(c0, c_end);

  const int s = threadIdx.x % sl;
  const int rt = (threadIdx.x / sl) % nr;
  const int pt = threadIdx.x / (sl * nr);

  float acc[TX_URS_RB][TX_URS_CB];
#pragma unroll
  for (int i = 0; i < TX_URS_RB; ++i)
#pragma unroll
    for (int k = 0; k < TX_URS_CB; ++k) acc[i][k] = 0.f;

  // tile rows past c_end are never filled; their sums are never stored
  for (long long t0 = j_begin; t0 < j_end; t0 += TX_URS_TILE) {
    __syncthreads();  // the previous tile has been consumed
    filler.fill(tile, tstride, t0, j_end);
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

// nr, np: row- and replicate-threads of a block (powers of two, nr np divides
// 256, 256 / (nr np) divides 32); chunk a multiple of TX_URS_TILE.
inline bool resample_rows_shape_ok(long long m, long long R, int nrep, int nchunk,
                                   long long chunk, int nr, int np) {
  if (m < 1 || m > 2147483647LL || nrep < 1 || R < 1 || nchunk < 1 || nr < 1 || np < 1 ||
      TX_URS_THREADS % (nr * np) != 0 || 32 % (TX_URS_THREADS / (nr * np)) != 0 ||
      chunk % TX_URS_TILE != 0 || (long long)nchunk * chunk < R) {
    return false;
  }
  const long long rows_block = (long long)nr * TX_URS_CB;
  const long long reps_block = (long long)np * TX_URS_RB;
  return (nrep + reps_block - 1) / reps_block <= 65535 && (m + rows_block - 1) / rows_block <= 65535;
}

// Launch on `stream`; writes part (nchunk, nrep, m) float32.  Returns the
// launch status.
template <typename Rows, typename Counts>
int launch_resample_rows(Rows rows, Counts counts, void* part, long long R, int m, int nrep,
                         int nchunk, long long chunk, int nr, int np, cudaStream_t stream) {
  const int rows_block = nr * TX_URS_CB;
  const int reps_block = np * TX_URS_RB;
  const size_t smem = sizeof(float) * TX_URS_TILE * (rows_block + 1 + reps_block + 1);
  const dim3 grid((unsigned)nchunk, (unsigned)((nrep + reps_block - 1) / reps_block),
                  (unsigned)((m + rows_block - 1) / rows_block));
  auto kernel = resample_rows_kernel<Rows, Counts>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, TX_URS_THREADS, smem, stream>>>(rows, counts, (float*)part, R, m, nrep, chunk,
                                                 nr, np);
  return (int)cudaGetLastError();
}

}  // namespace
