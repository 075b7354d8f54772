// The bootstrap contraction shared by K2/K3, K5 and K7/K8, in two kernels
// that the launcher chooses between by the number of contribution rows:
//
//   part[chunk, r, c] = sum_{j in chunk} count(r, j) row_c(j)
//
// over m contribution rows c that a `Rows` functor builds per sample tile
// (K2/K3: w du^n dx per value column; K5: w du^n per batch row; K7/K8:
// e_a [x | 1] per target) and a `Counts` source of philox.cuh (the
// in-kernel Poisson draw or a materialized table).
// The caller sums the chunk partials in float64 (deterministic, no atomics).
// Within either kernel both count sources take the same path through the
// sums, so a draw and its materialized table give the same bits.
//
// Few rows (m <= 16: K3 on the main path's 14 rows and the volume path's 6,
// K2 at the quick start's 14, K7 and K8 at the serving shape, K5 on one
// row): resample_fewrows_kernel.  Every thread can hold all m rows of its 4
// replicates, so the counts never touch shared memory: a thread fetches the
// counts of its replicates for 4 consecutive samples (the table's entries by
// one 16 / 8 / 4-byte load), expands them to float32 in registers (for the
// Poisson source the expansion IS the draw) and multiplies them with the m
// row values of those samples, read from a shared tile as one float4 per row.
// The loads run two steps ahead of the FMAs (tx_keep pins them there), and
// only the row tile (256 samples, two buffers, filled one tile ahead) needs a
// barrier: one per 256 samples.  The 256 threads are sl sample lanes (fastest,
// so that a warp's loads cover whole 32-byte sectors of each table row) x np
// replicate-threads; the lanes are summed with shuffles at the end.  Each
// thread expands all 4 replicates' counts without a branch, so that the
// compiler interleaves the 4 draws (a branch per replicate serialised them
// and K3 ran at half the speed).  What holds it on the H100: for a table (K2,
// K7) its row-wise reads, which run at ~1 TB/s as torch.matmul's do; for the
// draw (K3, K5, K8) the instruction rate, shared between the draw (a quarter of
// a Philox4x32-10 call and one level lookup a count, ~13 integer
// instructions, its wide multiplies on the FMA pipe) and the FMAs (m rounded
// up to a multiple of 4 a count, 16 at K3's 14 rows): the two add up rather
// than overlap, and the loop runs at about half the SM's instruction rate
// (PERF.md).
//
// Many rows (K5 on a macrostate grid, K7/K8 with many targets or value
// columns): resample_rows_kernel.  A kernel that tiles rows across blocks
// would redraw every count once per row tile (K3's 16-row tiles would draw
// each count 28 times on a 448-row grid).  Here a block owns a tile of up to
// 512 contribution rows and up to 128 replicates; for each tile of
// TX_URS_TILE samples it draws every count of its replicates ONCE into shared
// memory and builds every contribution row once, then each thread accumulates
// a 4-replicate x 16-row outer product in f32 FMAs (no tensor cores, no TF32:
// the sums must hold f32 accuracy).  The 256 threads split as nr row-threads
// x np replicate-threads x sl sample lanes (sl divides 32; the lanes are
// summed with shuffles at the end), so a 448-row grid takes one row tile
// (each count drawn once per replicate block).  Bound on the H100: the f32
// FMAs, one per count and row; on the card the kernel is held back by the
// instructions around them (building the rows, shared loads), see PERF.md.
#pragma once

#include "philox.cuh"

#define TX_URS_THREADS 256
#define TX_URS_RB 4
#define TX_URS_CB 16
#define TX_URS_TILE 32
#define TX_FEW_TILE 256                     // samples of the few-rows kernel's row tile
#define TX_FEW_GROUPS (TX_FEW_TILE / 4)     // groups of 4 samples in it
#define TX_FEW_RI 5                         // row items a thread fetches ahead
#define TX_FEW_AHEAD 2                      // steps the count loads run ahead (4 was slower)

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
  counts.init();  // the loop's first barrier comes before any count

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

// The few-rows kernel.  KB >= m is the number of row slots a thread holds (8
// or 16); groups of 4 slots from m on are skipped by a block-uniform guard.  The row tile
// holds, for each group g of 4 samples, one float4 per row: tile[g (KB + 1) +
// k] = row_k(4 g .. 4 g + 3); the odd stride in float4 spreads 8 neighbouring
// groups over the shared banks.  The filler (type Rows::Filler, built by
// rows.block(0, m)) has `nsrc` sources (batch rows, targets) behind the rows
// and one item per (source, sample of the tile), item = source TX_FEW_TILE +
// i: fetch(item, t0, j_end) loads the sample's values (zeros where t0 + i >=
// j_end), keep(raw) pins them, and store(raw, item, tile, gstride, t0, j_end)
// writes tile[(i / 4) gstride + 4 c + i % 4] = row_c(t0 + i) for the source's
// rows c (floats; zero where t0 + i >= j_end).
template <int KB, typename Counts>
__device__ __forceinline__ void fewrows_step(const Counts& counts,
                                             typename Counts::Raw (&raw)[TX_URS_RB],
                                             float (&acc)[TX_URS_RB][KB], const float4* tg,
                                             const int (&r)[TX_URS_RB], int nrep, int m,
                                             long long j, long long j_ahead, long long j_end) {
  // this step's counts, then the loads of a later step into the registers
  // they leave.  Every replicate expands, unmasked and unbranched, so that
  // the compiler can interleave the 4 draws: a replicate from nrep on is
  // never stored, and a sample from j_end on meets a zero row (a count there
  // may be anything finite: the stale registers of a table, or a draw)
  float f[TX_URS_RB][4];
#pragma unroll
  for (int a = 0; a < TX_URS_RB; ++a) counts.expand(raw[a], r[a], j, f[a]);
#pragma unroll
  for (int a = 0; a < TX_URS_RB; ++a) {
    if (r[a] < nrep && j_ahead < j_end) raw[a] = counts.fetch(r[a], j_ahead);
    Counts::keep(raw[a]);
  }
  // rows in groups of 4: one block-uniform guard and 4 shared loads ahead of
  // 64 FMAs; a group's slots from m on hold whatever the tile holds there, and
  // their sums are never stored
#pragma unroll
  for (int k0 = 0; k0 < KB; k0 += 4) {
    if (k0 < m) {
      float4 cv[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) cv[q] = tg[k0 + q];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
#pragma unroll
        for (int a = 0; a < TX_URS_RB; ++a) {
          float v = acc[a][k0 + q];
          v = fmaf(f[a][0], cv[q].x, v);
          v = fmaf(f[a][1], cv[q].y, v);
          v = fmaf(f[a][2], cv[q].z, v);
          v = fmaf(f[a][3], cv[q].w, v);
          acc[a][k0 + q] = v;
        }
      }
    }
  }
}

template <int KB, typename Rows, typename Counts>
__global__ void __launch_bounds__(TX_URS_THREADS, 2)
resample_fewrows_kernel(Rows rows, Counts counts, float* __restrict__ part, long long R, int m,
                        int nrep, long long chunk, int np) {
  __shared__ float4 tile[2][TX_FEW_GROUPS * (KB + 1)];
  using Filler = typename Rows::Filler;
  const int gstride = 4 * (KB + 1);              // floats between two groups
  const int sl = TX_URS_THREADS / np;            // sample lanes: 8, 16 or 32
  const int spt = TX_FEW_GROUPS / sl;            // steps of a lane per tile: 8, 4 or 2
  const int reps_block = np * TX_URS_RB;
  // grid.x = chunk (replicate blocks) + replicate block: the blocks that read
  // the same samples run together and share them through the L2 cache
  const int ycount = (nrep + reps_block - 1) / reps_block;
  const long long bx = blockIdx.x / ycount;
  const int r0 = (blockIdx.x % ycount) * reps_block;
  const long long j_begin = bx * chunk;
  const long long j_end = (j_begin + chunk < R) ? j_begin + chunk : R;
  const Filler filler = rows.block(0, m);
  const int nri = filler.nsrc * TX_FEW_TILE;     // row items of a tile
  counts.init();  // the barrier after the first tile comes before any count

  const int tid = threadIdx.x;
  const int s = tid % sl;
  const int pt = tid / sl;
  int r[TX_URS_RB];
#pragma unroll
  for (int a = 0; a < TX_URS_RB; ++a) r[a] = r0 + pt + np * a;

  float acc[TX_URS_RB][KB];
#pragma unroll
  for (int a = 0; a < TX_URS_RB; ++a)
#pragma unroll
    for (int k = 0; k < KB; ++k) acc[a][k] = 0.f;

  // the first tile's rows go straight into buffer 0; the counts of the first
  // AH steps into the AH register sets
  constexpr int AH = TX_FEW_AHEAD;
  typename Counts::Raw craw[AH][TX_URS_RB] = {};
  typename Filler::Raw rraw[TX_FEW_RI] = {};
  const long long step = 4LL * sl;               // samples between two steps of a lane
#pragma unroll
  for (int u = 0; u < AH; ++u) {
#pragma unroll
    for (int a = 0; a < TX_URS_RB; ++a) {
      const long long j = j_begin + 4 * s + u * step;
      if (r[a] < nrep && j < j_end) craw[u][a] = counts.fetch(r[a], j);
    }
  }
  for (int item = tid; item < nri; item += TX_URS_THREADS) {
    filler.store(filler.fetch(item, j_begin, j_end), item, reinterpret_cast<float*>(tile[0]),
                 gstride, j_begin, j_end);
  }
  __syncthreads();

  int cur = 0;
  for (long long t0 = j_begin; t0 < j_end; t0 += TX_FEW_TILE) {
    const long long t1 = t0 + TX_FEW_TILE;
    const bool more = t1 < j_end;  // the same for every thread of the block
    if (more) {  // the next tile's sample values, in flight during the FMAs
#pragma unroll
      for (int n = 0; n < TX_FEW_RI; ++n) {
        const int item = tid + n * TX_URS_THREADS;
        if (item < nri) rraw[n] = filler.fetch(item, t1, j_end);
        Filler::keep(rraw[n]);
      }
    }
    for (int n = 0; n < spt; n += AH) {
#pragma unroll
      for (int u = 0; u < AH; ++u) {
        const int g = s + sl * (n + u);
        const long long j = t0 + 4 * g;
        fewrows_step<KB>(counts, craw[u], acc, tile[cur] + g * (KB + 1), r, nrep, m, j,
                         j + AH * step, j_end);
      }
    }
    if (more) {  // the rows of the next tile into the other buffer
      float* next = reinterpret_cast<float*>(tile[cur ^ 1]);
#pragma unroll
      for (int n = 0; n < TX_FEW_RI; ++n) {
        const int item = tid + n * TX_URS_THREADS;
        if (item < nri) filler.store(rraw[n], item, next, gstride, t1, j_end);
      }
      for (int item = tid + TX_FEW_RI * TX_URS_THREADS; item < nri; item += TX_URS_THREADS) {
        filler.store(filler.fetch(item, t1, j_end), item, next, gstride, t1, j_end);
      }
    }
    __syncthreads();  // the tile is consumed and the next one is complete
    cur ^= 1;
  }

#pragma unroll
  for (int a = 0; a < TX_URS_RB; ++a) {
#pragma unroll
    for (int k = 0; k < KB; ++k) {
      const float v = sum_lanes(acc[a][k], sl);
      if (s == 0 && r[a] < nrep && k < m) part[(bx * nrep + r[a]) * m + k] = v;
    }
  }
}

// nr, np: row- and replicate-threads of a block (powers of two, nr np divides
// 256, 256 / (nr np) divides 32).  Up to TX_URS_CB rows run in the few-rows
// kernel (nr = 1, chunk a multiple of TX_FEW_TILE), more in the many-rows
// kernel (chunk a multiple of TX_URS_TILE).
inline bool resample_rows_shape_ok(long long m, long long R, int nrep, int nchunk,
                                   long long chunk, int nr, int np) {
  if (m < 1 || m > 2147483647LL || nrep < 1 || R < 1 || nchunk < 1 || nr < 1 || np < 1 ||
      nr > TX_URS_THREADS || np > TX_URS_THREADS || (nr & (nr - 1)) != 0 ||
      (np & (np - 1)) != 0 || nr * np > TX_URS_THREADS ||
      TX_URS_THREADS / (nr * np) > 32 || chunk < 1 || (long long)nchunk * chunk < R) {
    return false;
  }
  const long long reps_block = (long long)np * TX_URS_RB;
  const long long ycount = (nrep + reps_block - 1) / reps_block;
  if (m <= TX_URS_CB) {
    return nr == 1 && chunk % TX_FEW_TILE == 0 && nchunk * ycount <= 2147483647LL;
  }
  const long long rows_block = (long long)nr * TX_URS_CB;
  return chunk % TX_URS_TILE == 0 && ycount <= 65535 && (m + rows_block - 1) / rows_block <= 65535;
}

// Launch on `stream`; write part (nchunk, nrep, m) float32 and return the
// launch status.  launch_fewrows takes m <= TX_URS_CB rows, launch_manyrows
// more; launch_resample_rows picks between them (a caller that never sends
// a source past 16 rows calls launch_fewrows alone and builds fewer kernels).
template <typename Rows, typename Counts>
int launch_fewrows(Rows rows, Counts counts, void* part, long long R, int m, int nrep, int nchunk,
                   long long chunk, int np, cudaStream_t stream) {
  const int reps_block = np * TX_URS_RB;
  const int ycount = (nrep + reps_block - 1) / reps_block;
  const dim3 grid((unsigned)((long long)nchunk * ycount), 1, 1);
  if (m <= 8) {
    resample_fewrows_kernel<8, Rows, Counts><<<grid, TX_URS_THREADS, 0, stream>>>(
        rows, counts, (float*)part, R, m, nrep, chunk, np);
  } else {
    resample_fewrows_kernel<TX_URS_CB, Rows, Counts><<<grid, TX_URS_THREADS, 0, stream>>>(
        rows, counts, (float*)part, R, m, nrep, chunk, np);
  }
  return (int)cudaGetLastError();
}

template <typename Rows, typename Counts>
int launch_manyrows(Rows rows, Counts counts, void* part, long long R, int m, int nrep,
                    int nchunk, long long chunk, int nr, int np, cudaStream_t stream) {
  const int reps_block = np * TX_URS_RB;
  const int ycount = (nrep + reps_block - 1) / reps_block;
  const int rows_block = nr * TX_URS_CB;
  const size_t smem = sizeof(float) * TX_URS_TILE * (rows_block + 1 + reps_block + 1);
  const dim3 grid((unsigned)nchunk, (unsigned)ycount,
                  (unsigned)((m + rows_block - 1) / rows_block));
  auto kernel = resample_rows_kernel<Rows, Counts>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, TX_URS_THREADS, smem, stream>>>(rows, counts, (float*)part, R, m, nrep, chunk,
                                                 nr, np);
  return (int)cudaGetLastError();
}

template <typename Rows, typename Counts>
int launch_resample_rows(Rows rows, Counts counts, void* part, long long R, int m, int nrep,
                         int nchunk, long long chunk, int nr, int np, cudaStream_t stream) {
  if (m <= TX_URS_CB) return launch_fewrows(rows, counts, part, R, m, nrep, nchunk, chunk, np, stream);
  return launch_manyrows(rows, counts, part, R, m, nrep, nchunk, chunk, nr, np, stream);
}

}  // namespace
