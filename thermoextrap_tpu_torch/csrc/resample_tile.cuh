// The bootstrap contraction shared by K2/K3, K5 and K7/K8, in four kernels
// that the launchers choose between by the number of contribution rows and
// the count source:
//
//   part[chunk, r, c] = sum_{j in chunk} count(r, j) row_c(j)
//
// over m contribution rows c that a `Rows` functor builds per sample tile
// (K2/K3: w du^n dx per value column; K5: w du^n per batch row; K7/K8:
// e_a [x | 1] per target) and a `Counts` source of philox.cuh (the
// in-kernel Poisson draw or a materialized table).
// The caller sums the chunk partials in float64 (deterministic, no atomics).
// Within each kernel both count sources take the same path through the
// sums, so a draw and its materialized table give the same bits.
//
// Which kernel takes which call (the launchers of the three .cu files route
// by it, and the C entry points check the launch shape of the route taken):
//
//   caller   rows m             count sources                 kernel
//   K2/K3    m <= 16            draw; int8/16/32 tables       few rows, tensor cores
//   K2/K3    m <= 16            f32, bf16 tables              few rows
//   K2/K3    m > 16             draw; int32, f32 tables       many rows (FFMA);
//                                                             the wrapper widens
//                                                             int8/16 and bf16
//   K5       m <= 16            draw; int32 table             few rows
//   K5       m > 16, order >= 1 draw; int32 table             tensor cores
//   K5       m > 16, order 0    draw; int32 table             many rows (FFMA)
//   K7/K8    m <= 16            draw; every table type        few rows
//   K7/K8    m > 16             draw; every table type        many rows (FFMA)
//
// The tensor-core kernels take only integer counts (MmaCounts below has no
// other source); fractional float32 and bf16 tables stay on the FFMA kernels.
// K5, K7 and K8 have no rows builder for the tensor cores at few rows, and
// one loop tuned for every caller slowed some of them (PERF.md), so K2/K3's
// tensor-core kernel is a route of its own, not an adaptation of this one.
//
// Few rows on the CUDA cores (m <= 16: K2 on fractional tables, K7 and K8 at
// the serving shape, K5 on one row): resample_fewrows_kernel.  Every thread
// can hold all m rows of its 4 replicates, so the counts never touch shared
// memory: a thread fetches the counts of its replicates for 4 consecutive
// samples (the table's entries by one 16 / 8 / 4-byte load), expands them to
// float32 in registers (for the Poisson source the expansion IS the draw) and
// multiplies them with the m row values of those samples, read from a shared
// tile as one float4 per row.
// The loads run two steps ahead of the FMAs (tx_keep pins them there), and
// only the row tile (256 samples, two buffers, filled one tile ahead) needs a
// barrier: one per 256 samples.  The 256 threads are sl sample lanes (fastest,
// so that a warp's loads cover whole 32-byte sectors of each table row) x np
// replicate-threads; the lanes are summed with shuffles at the end.  Each
// thread expands all 4 replicates' counts without a branch, so that the
// compiler interleaves the 4 draws (a branch per replicate serialised them
// and K3 ran at half the speed).  What holds it on the H100: for a table (K2,
// K7) its row-wise reads, which run at ~1 TB/s as torch.matmul's do; for the
// draw (K5, K8) the instruction rate, shared between the draw (a quarter of
// a Philox4x32-10 call and one level lookup a count, ~13 integer
// instructions, its wide multiplies on the FMA pipe) and the FMAs (m rounded
// up to a multiple of 4 a count, 16 at 14 rows): the two add up rather than
// overlap, and the loop runs at about half the SM's instruction rate
// (PERF.md), which is why K3 moved to the tensor cores.
//
// Many rows on the CUDA cores (K2/K3 past 16 rows, K5 at order 0, K7/K8 with
// many targets or value columns): resample_rows_kernel.  A kernel that tiles rows across blocks
// would redraw every count once per row tile (K3's 16-row tiles would draw
// each count 28 times on a 448-row grid).  Here a block owns a tile of up to
// 512 contribution rows and up to 128 replicates; for each tile of
// TX_URS_TILE samples it draws every count of its replicates ONCE into shared
// memory and builds every contribution row once, then each thread accumulates
// a 4-replicate x 16-row outer product in f32 FMAs (no TF32: the sums must
// hold f32 accuracy; fractional table counts are not exact in bf16).  The
// 256 threads split as nr row-threads x np replicate-threads x sl sample lanes
// (sl divides 32; the lanes are summed with shuffles at the end), so a
// 448-row tile is one block (each count drawn once per replicate block).
// Bound on the H100: the f32 FMAs, one per count and row; on the card the
// kernel is held back by the instructions around them (building the rows,
// shared loads): K5 at the lnPi grid took 12.4 ms here against 3.42 ms of
// FMAs, which is why K5 past 16 rows moved to the tensor cores (PERF.md).
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

// ---------------------------------------------------------------------------
// The tensor-core kernel: many rows, integer counts (K5 on a macrostate grid)
// ---------------------------------------------------------------------------
//
// part[chunk, r, c] = sum_j count(r, j) row_c(j) as bf16 products on the
// tensor cores (mma.sync m16n8k16, float32 sums; tx_mma_bf16_16816):
//   - A = counts (replicates x samples).  A count below 256 is exact in bf16.
//     A table's count is its sign times the digits d_k of 8 bits of its
//     magnitude, A_k = bf16(+-d_k 256^k), each exact and all of one sign (no
//     two digit products cancel); the digits past the first are multiplied in only for a
//     tile where some count has them (__syncthreads_or), so a draw and its
//     table take the same path whenever the table holds draws.  No count is
//     ever rounded.
//   - B = rows (samples x rows) as three bf16 terms, b0 + b1 + b2 = the
//     float32 row to ~24 bits (tx_split_bf16x3): every product count x term
//     is exact in float32, and the three terms of a sample tile (6 mma.sync)
//     add into a float32 temporary that joins the thread's float32 sum by one
//     FADD, so the tensor cores' own rounding of a running sum never acts on
//     more than one tile.
//   - The K order of a 16-sample step is permuted so that lane (g, t) holds
//     samples 4t .. 4t+3 (slots 2t, 2t+1, 2t+8, 2t+9): one Philox call (or
//     one 16-byte table load) fills a replicate's half of its A fragment,
//     and its B fragment is 8 contiguous bytes of a row in shared memory.
// A block is 8 warps over TX_MMA_REPS = 128 replicates x TX_MMA_ROWS = 224
// rows, a warp 64 x 56 (4 x 7 tiles of 16 x 8: 112 float32 sums a thread).
// For each sample tile of TX_MMA_S = 32 samples it draws (or loads) each of
// its counts once into shared memory, already in fragment order, and builds
// each of its rows once, as three bf16 planes; N tiles from the block's last
// row on are skipped by a warp-uniform guard (448 rows are 28 of them, no
// padding).  At the lnPi grid (448 rows, 256 replicates) a count is drawn
// twice and a row built twice.  The pipeline: the sample values of tile t + 2
// go into shared memory by cp.async while tile t is consumed; in the same
// pass the rows and the counts of tile t + 1 are built into the other
// buffer; one barrier a tile.
//
// Rows::MmaFiller (built by rows.mma_block(c0, c_end)) gives the rows:
// stage(raw, t0, j_end) issues the copies of the sample values of
// [t0, t0 + TX_MMA_S) into `raw` (zeros from j_end on), build(raw, planes,
// t0, j_end) writes planes[k][(c - c0) TX_MMA_RS + i] = term k of
// row_c(t0 + i), zero from j_end on, every thread of the block taking part.

#define TX_MMA_REPS 128
#define TX_MMA_ROWS 224
#define TX_MMA_S 32                      // samples of a tile: two k-steps of 16
#define TX_MMA_RS 48                     // bf16 between two rows of a plane (spreads the banks)
#define TX_MMA_PLANE (TX_MMA_ROWS * TX_MMA_RS)
#define TX_MMA_ROW_BYTES (3 * TX_MMA_PLANE * 2)
#define TX_MMA_CNT_BYTES ((TX_MMA_REPS / 16) * (TX_MMA_S / 16) * 32 * 16)
#define TX_MMA_MT 4                      // 16-replicate tiles of a warp
#define TX_MMA_NT 7                      // 8-row tiles of a warp

// the counts of replicate r for samples j .. j+3 as float32 values below 256
// (a table's first digit); true where a table's count has more digits.
// low4(c, r, nrep, j, f) loads them (the tensor-core kernel), low4(c, raw,
// r, j, f) expands what Counts::fetch loaded (the few-rows tensor-core
// kernel, which loads ahead); a table's digit4(raw, k, f) gives digit k.
template <typename Counts>
struct MmaCounts;
template <>
struct MmaCounts<PoissonCounts> {
  static constexpr bool kDigits = false;
  static __device__ __forceinline__ bool low4(const PoissonCounts& c, int r, int, long long j,
                                              float (&f)[4]) {
    c.load4(r, j, f);  // at most 9
    return false;
  }
  // PoissonCounts::load4's draw and level lookup, with the level's +1 as a
  // predicated add (one select fewer a count than poisson_level_count)
  static __device__ __forceinline__ bool low4(const PoissonCounts& c, PoissonCounts::Raw, int r,
                                              long long j, float (&f)[4]) {
    uint32_t w[4] = {(uint32_t)(j >> 2), (uint32_t)r, (uint32_t)(j >> 34), 0u};
    philox4x32_10(w, c.key);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint2 lv = tx_poisson_levels[tx_highest_bit(~w[q]) + 1];
      f[q] = __uint_as_float(lv.y);
      if (w[q] > lv.x) f[q] += 1.f;
    }
    return false;
  }
};
// an integer table of entries F: each count's sign and the 8-bit digits of
// its magnitude.  An int8 count (|count| <= 128) is one digit.
template <typename F>
struct MmaTable {
  static constexpr bool kDigits = sizeof(F) > 1;
  using Raw = typename TableCounts<F>::Raw;
  static __device__ __forceinline__ void words(const Raw& raw, uint32_t (&w)[4]) {
    F e[4];
    memcpy(e, &raw, sizeof(Raw));
#pragma unroll
    for (int q = 0; q < 4; ++q) w[q] = (uint32_t)(int32_t)e[q];
  }
  // |count| and its sign: the digits of a count all carry its sign, so
  // that no two digit products cancel in the float32 sums
  static __device__ __forceinline__ uint32_t magnitude(uint32_t w) {
    return ((int32_t)w < 0) ? 0u - w : w;
  }
  static __device__ __forceinline__ float sign(uint32_t w) { return ((int32_t)w < 0) ? -1.f : 1.f; }
  static __device__ __forceinline__ bool low4(const TableCounts<F>&, const Raw& raw, int, long long,
                                              float (&f)[4]) {
    uint32_t w[4];
    words(raw, w);
    bool hi = false;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint32_t mag = magnitude(w[q]);
      f[q] = sign(w[q]) * (float)(mag & 255u);
      hi |= (mag >> 8) != 0u;
    }
    return hi;
  }
  // digit k (1..3) of each count's magnitude times 256^k, with the count's
  // sign: exact in bf16
  static __device__ __forceinline__ void digit4(const Raw& raw, int k, float (&f)[4]) {
    uint32_t w[4];
    words(raw, w);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      f[q] = sign(w[q]) * (float)((magnitude(w[q]) >> (8 * k)) & 255u) * (float)(1u << (8 * k));
    }
  }
};
template <>
struct MmaCounts<TableCounts<int8_t>> : MmaTable<int8_t> {};
template <>
struct MmaCounts<TableCounts<int16_t>> : MmaTable<int16_t> {};
template <>
struct MmaCounts<TableCounts<int32_t>> : MmaTable<int32_t> {
  static __device__ __forceinline__ uint4 raw(const TableCounts<int32_t>& c, int r, int nrep,
                                              long long j) {
    return (r < nrep) ? c.fetch(r, j) : make_uint4(0u, 0u, 0u, 0u);
  }
  using MmaTable<int32_t>::low4;
  static __device__ __forceinline__ bool low4(const TableCounts<int32_t>& c, int r, int nrep,
                                              long long j, float (&f)[4]) {
    return low4(c, raw(c, r, nrep, j), r, j, f);
  }
};

// the A fragment of replicates (g, g + 8) at samples 4t .. 4t+3 (permuted
// k order): fa the counts of replicate g, fb those of g + 8
__device__ __forceinline__ uint4 mma_a_frag(const float (&fa)[4], const float (&fb)[4]) {
  return make_uint4(tx_pack_bf16x2(fa[0], fa[1]), tx_pack_bf16x2(fb[0], fb[1]),
                    tx_pack_bf16x2(fa[2], fa[3]), tx_pack_bf16x2(fb[2], fb[3]));
}

// acc[mt][nt] += A[ks][mt] x (the three terms of N tile nt), one temporary
// per 16 x 8 tile over the k-steps given; N tiles from c_live on are skipped
template <int KS>
__device__ __forceinline__ void mma_tiles(float (&acc)[TX_MMA_MT][TX_MMA_NT][4],
                                          const uint4 (&af)[KS][TX_MMA_MT],
                                          const uint16_t* planes, int nl0, int c_live, int ks0,
                                          int lane) {
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < TX_MMA_NT; ++nt) {
    const int nl = nl0 + 8 * nt;
    if (nl < c_live) {  // the same for every lane of the warp
      float tmp[TX_MMA_MT][4];
#pragma unroll
      for (int mt = 0; mt < TX_MMA_MT; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) tmp[mt][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t bt[3][2];
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          const uint2 v = *reinterpret_cast<const uint2*>(
              planes + k * TX_MMA_PLANE + (nl + g) * TX_MMA_RS + 16 * (ks0 + ks) + 4 * t);
          bt[k][0] = v.x;
          bt[k][1] = v.y;
        }
#pragma unroll
        for (int k = 0; k < 3; ++k)
#pragma unroll
          for (int mt = 0; mt < TX_MMA_MT; ++mt) {
            const uint32_t a[4] = {af[ks][mt].x, af[ks][mt].y, af[ks][mt].z, af[ks][mt].w};
            tx_mma_bf16_16816(tmp[mt], a, bt[k], tmp[mt]);
          }
      }
#pragma unroll
      for (int mt = 0; mt < TX_MMA_MT; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] += tmp[mt][e];
    }
  }
}

template <typename Rows, typename Counts>
__global__ void __launch_bounds__(TX_URS_THREADS, 1)
resample_mma_kernel(Rows rows, Counts counts, float* __restrict__ part, long long R, int m,
                    int nrep, long long chunk, int raw_bytes) {
  extern __shared__ __align__(16) float smem[];
  using Filler = typename Rows::MmaFiller;
  using MC = MmaCounts<Counts>;
  const int ycount = (nrep + TX_MMA_REPS - 1) / TX_MMA_REPS;
  const int zcount = (m + TX_MMA_ROWS - 1) / TX_MMA_ROWS;
  // grid.x = chunk (replicate block, row block): the blocks that read the
  // same samples run together and share them through the L2 cache
  const long long bx = blockIdx.x / (ycount * zcount);
  const int yz = blockIdx.x % (ycount * zcount);
  const int r0 = (yz % ycount) * TX_MMA_REPS;
  const int c0 = (yz / ycount) * TX_MMA_ROWS;
  const int c_end = (c0 + TX_MMA_ROWS < m) ? c0 + TX_MMA_ROWS : m;
  const int ncol = c_end - c0;
  const long long j_begin = bx * chunk;
  const long long j_end = (j_begin + chunk < R) ? j_begin + chunk : R;
  const Filler filler = rows.mma_block(c0, c_end);
  counts.init();  // the first barrier comes before any count

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp & 1;   // replicates 64 wm .. 64 wm + 63 of the block
  const int wn = warp >> 1;  // rows 56 wn .. 56 wn + 55 of the block
  const int buf_bytes = TX_MMA_ROW_BYTES + TX_MMA_CNT_BYTES + raw_bytes;
  char* const base = reinterpret_cast<char*>(smem);
  auto planes = [&](int b) { return reinterpret_cast<uint16_t*>(base + b * buf_bytes); };
  auto cnt = [&](int b) { return reinterpret_cast<uint4*>(base + b * buf_bytes + TX_MMA_ROW_BYTES); };
  auto raw = [&](int b) { return base + b * buf_bytes + TX_MMA_ROW_BYTES + TX_MMA_CNT_BYTES; };

  // the counts of tile t0 into buffer b, in fragment order: slot (mt, ks,
  // lane) holds replicates r0 + 16 mt + (g, g + 8) at samples t0 + 16 ks +
  // 4t .. +3; true where a count has digits past the first
  auto make_counts = [&](int b, long long t0) {
    bool hi = false;
#pragma unroll
    for (int n = 0; n < (TX_MMA_REPS / 16) * (TX_MMA_S / 16) * 32 / TX_URS_THREADS; ++n) {
      const int slot = tid + n * TX_URS_THREADS;
      const int ln = slot & 31;
      const int ks = (slot >> 5) % (TX_MMA_S / 16);
      const int mt = (slot >> 5) / (TX_MMA_S / 16);
      const int ra = r0 + 16 * mt + (ln >> 2);
      const long long j = t0 + 16 * ks + 4 * (ln & 3);
      float fa[4], fb[4];
      hi |= MC::low4(counts, ra, nrep, j, fa);
      hi |= MC::low4(counts, ra + 8, nrep, j, fb);
      cnt(b)[slot] = mma_a_frag(fa, fb);
    }
    return hi;
  };

  // rows from the block's last one up to a whole N tile read as zeros
  const int ncol8 = (ncol + 7) & ~7;
  for (int i = tid; i < 2 * 3 * (ncol8 - ncol) * TX_MMA_S; i += TX_URS_THREADS) {
    const int b = i / (3 * (ncol8 - ncol) * TX_MMA_S);
    const int rest = i % (3 * (ncol8 - ncol) * TX_MMA_S);
    const int k = rest / ((ncol8 - ncol) * TX_MMA_S);
    const int cc = ncol + (rest / TX_MMA_S) % (ncol8 - ncol);
    planes(b)[k * TX_MMA_PLANE + cc * TX_MMA_RS + rest % TX_MMA_S] = 0;
  }
  float acc[TX_MMA_MT][TX_MMA_NT][4];
#pragma unroll
  for (int mt = 0; mt < TX_MMA_MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < TX_MMA_NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  // prologue: the values of tiles 0 and 1, then tile 0's rows and counts
  filler.stage(raw(0), j_begin, j_end);
  if (j_begin + TX_MMA_S < j_end) filler.stage(raw(1), j_begin + TX_MMA_S, j_end);
  tx_cp_commit();
  tx_cp_wait_all();
  __syncthreads();
  filler.build(raw(0), planes(0), j_begin, j_end);
  bool hi_cur = __syncthreads_or(make_counts(0, j_begin)) != 0;

  int cur = 0;
  for (long long t0 = j_begin; t0 < j_end; t0 += TX_MMA_S) {
    const long long t1 = t0 + TX_MMA_S;
    // the values of tile t + 2 into the raw buffer that tile t's rows came from
    if (t1 + TX_MMA_S < j_end) filler.stage(raw(cur), t1 + TX_MMA_S, j_end);
    tx_cp_commit();
    bool hi_next = false;
    if (t1 < j_end) {  // the same for every thread of the block
      filler.build(raw(cur ^ 1), planes(cur ^ 1), t1, j_end);
      hi_next = make_counts(cur ^ 1, t1);
    }
    // tile t on the tensor cores
    {
      uint4 af[TX_MMA_S / 16][TX_MMA_MT];
#pragma unroll
      for (int ks = 0; ks < TX_MMA_S / 16; ++ks)
#pragma unroll
        for (int mt = 0; mt < TX_MMA_MT; ++mt)
          af[ks][mt] = cnt(cur)[((TX_MMA_MT * wm + mt) * (TX_MMA_S / 16) + ks) * 32 + lane];
      mma_tiles<TX_MMA_S / 16>(acc, af, planes(cur), TX_MMA_NT * 8 * wn, ncol, 0, lane);
    }
    if constexpr (MC::kDigits) {
      if (hi_cur) {  // block-uniform: a table count of this tile has more digits
        for (int k = 1; k <= 3; ++k) {
#pragma unroll
          for (int ks = 0; ks < TX_MMA_S / 16; ++ks) {
            uint4 af[1][TX_MMA_MT];
#pragma unroll
            for (int mt = 0; mt < TX_MMA_MT; ++mt) {
              const int ra = r0 + 16 * (TX_MMA_MT * wm + mt) + (lane >> 2);
              const long long j = t0 + 16 * ks + 4 * (lane & 3);
              float fa[4], fb[4];
              MC::digit4(MC::raw(counts, ra, nrep, j), k, fa);
              MC::digit4(MC::raw(counts, ra + 8, nrep, j), k, fb);
              af[0][mt] = mma_a_frag(fa, fb);
            }
            mma_tiles<1>(acc, af, planes(cur), TX_MMA_NT * 8 * wn, ncol, ks, lane);
          }
        }
      }
    }
    tx_cp_wait_all();  // tile t + 2's values have landed
    hi_cur = __syncthreads_or(hi_next) != 0;  // the one barrier of a tile
    cur ^= 1;
  }

  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < TX_MMA_MT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < TX_MMA_NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = r0 + 16 * (TX_MMA_MT * wm + mt) + g + 8 * (e >> 1);
        const int c = c0 + TX_MMA_NT * 8 * wn + 8 * nt + 2 * t + (e & 1);
        if (r < nrep && c < c_end) part[(bx * nrep + r) * m + c] = acc[mt][nt][e];
      }
    }
  }
}

inline bool resample_mma_shape_ok(long long m, long long R, int nrep, int nchunk, long long chunk,
                                  int raw_bytes) {
  if (m < 1 || m > 2147483647LL || nrep < 1 || R < 1 || nchunk < 1 || chunk < 1 ||
      chunk % TX_MMA_S != 0 || (long long)nchunk * chunk < R || raw_bytes < 0 ||
      raw_bytes % 16 != 0) {
    return false;
  }
  const long long blocks = (long long)nchunk * ((nrep + TX_MMA_REPS - 1) / TX_MMA_REPS) *
                           ((m + TX_MMA_ROWS - 1) / TX_MMA_ROWS);
  const long long smem = 2LL * (TX_MMA_ROW_BYTES + TX_MMA_CNT_BYTES + raw_bytes);
  return blocks <= 2147483647LL && smem <= 232448;
}

template <typename Rows, typename Counts>
int launch_mma(Rows rows, Counts counts, void* part, long long R, int m, int nrep, int nchunk,
               long long chunk, int raw_bytes, cudaStream_t stream) {
  // MmaCounts<Counts> is defined for the draw and int32 tables only: any
  // other source does not compile here
  const long long blocks = (long long)nchunk * ((nrep + TX_MMA_REPS - 1) / TX_MMA_REPS) *
                           ((m + TX_MMA_ROWS - 1) / TX_MMA_ROWS);
  const size_t smem = 2 * (size_t)(TX_MMA_ROW_BYTES + TX_MMA_CNT_BYTES + raw_bytes);
  auto kernel = resample_mma_kernel<Rows, Counts>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3((unsigned)blocks, 1, 1), TX_URS_THREADS, smem, stream>>>(rows, counts, (float*)part,
                                                                         R, m, nrep, chunk, raw_bytes);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The few-rows tensor-core kernel: up to 16 rows, integer counts (K2/K3)
// ---------------------------------------------------------------------------
//
// The same products as the tensor-core kernel above (counts as exact bf16
// digits, rows as three bf16 terms, mma.sync m16n8k16 with float32 sums, the
// permuted k order), shaped for few rows and many replicates, so that the
// CUDA cores do little but the draw:
//   - a block is 8 warps over TX_FMMA_REPS = 256 replicates; a warp owns 32
//     of them (two M tiles) and every row (one N tile up to 8 rows, two up
//     to 16), so each count is drawn once, by the lane whose A fragment
//     holds it, straight into registers: no count touches shared memory.
//     Lane (g, t) draws replicates g and g + 8 of each M tile at samples 4t
//     .. 4t+3 of a 16-sample k-step, one Philox call each.  A table's
//     counts are loaded TX_FMMA_AHEAD k-steps ahead, one 16 / 8 / 4-byte
//     load per replicate and k-step;
//   - the rows of a tile of TX_FMMA_S samples are built once per block as
//     three bf16 planes (Rows::Filler: fetch_pair / store_planes) into one of
//     two shared buffers while the other is consumed, one barrier a tile;
//     each warp reads a k-step's B fragments once and uses them for both of
//     its M tiles;
//   - the three terms of TX_FMMA_AHEAD k-steps (32 samples) go into a
//     float32 temporary that joins the thread's float32 sum by one FADD, as
//     the tensor-core kernel's tile does;
//   - a table count past one digit takes digit passes for its k-step,
//     decided by the warp (__any_sync), so that a draw and a table of draws
//     take one path and give the same bits.
// What holds it on the H100: for the draw, the CUDA cores' ~17 instructions a
// count (a quarter of a Philox call, the level lookup, the bf16 packing; the
// 3 x 16 products a count are ~2.5 ms of the tensor cores at K3's main
// shape), at about half the SM's issue rate; unrolling further, loads four
// k-steps ahead and the Philox products as separate low and high multiplies
// were all slower (PERF.md).  For a table, its row-wise reads.
// Rows::Filler (rows.block(0, m)) has nsrc sources and one item per (source,
// pair of samples of the tile), item = source (TX_FMMA_S / 2) + p:
// fetch_pair(item, t0, j_end) loads samples t0 + 2p and t0 + 2p + 1 (zeros
// from j_end on), keep_pair(raw) pins them, and store_planes(raw, item,
// planes, t0, j_end) writes word p of row c of each plane k, planes[k
// TX_FMMA_PLANE_W + c TX_FMMA_RS_W + p], the bf16 pair of term k of
// row_c(t0 + 2p), row_c(t0 + 2p + 1) (zero from j_end on), for the source's
// rows c.

#define TX_FMMA_REPS 256                     // replicates of a block: 32 a warp
#define TX_FMMA_MT 2                         // 16-replicate tiles of a warp
#define TX_FMMA_S 128                        // samples of a row tile: 8 k-steps
#define TX_FMMA_RS_W (TX_FMMA_S / 2 + 8)     // 32-bit words between two rows of a plane (spreads the banks)
#define TX_FMMA_PLANE_W (TX_URS_CB * TX_FMMA_RS_W)
#define TX_FMMA_AHEAD 2                      // k-steps a table load runs ahead, and of one temporary
#define TX_FMMA_RI 1                         // row items a thread fetches ahead (2 was slower)

// one k-step of a warp: the A fragments of its two M tiles from this step's
// counts, then the loads of a later step into the registers they leave, then
// the products with the three terms of NT N tiles into tmp
template <int NT, typename Counts>
__device__ __forceinline__ void fewmma_step(const Counts& counts,
                                            typename Counts::Raw (&raw)[TX_FMMA_MT][2],
                                            float (&tmp)[TX_FMMA_MT][NT][4], const uint32_t* pl,
                                            const int (&ra)[TX_FMMA_MT][2], int nrep, long long j,
                                            long long j_ahead, long long j_end, int ks, int lane) {
  using MC = MmaCounts<Counts>;
  using Raw = typename Counts::Raw;
  const int g = lane >> 2;
  const int t = lane & 3;
  uint32_t af[TX_FMMA_MT][4];
  bool hi = false;
#pragma unroll
  for (int mt = 0; mt < TX_FMMA_MT; ++mt) {
    float fa[4], fb[4];
    hi |= MC::low4(counts, raw[mt][0], ra[mt][0], j, fa);
    hi |= MC::low4(counts, raw[mt][1], ra[mt][1], j, fb);
    const uint4 v = mma_a_frag(fa, fb);
    af[mt][0] = v.x;
    af[mt][1] = v.y;
    af[mt][2] = v.z;
    af[mt][3] = v.w;
  }
#pragma unroll
  for (int mt = 0; mt < TX_FMMA_MT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      raw[mt][h] = (ra[mt][h] < nrep && j_ahead < j_end) ? counts.fetch(ra[mt][h], j_ahead) : Raw();
      Counts::keep(raw[mt][h]);
    }
  }
  uint32_t bt[NT][3][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const uint2 v = *reinterpret_cast<const uint2*>(pl + k * TX_FMMA_PLANE_W +
                                                      (8 * nt + g) * TX_FMMA_RS_W + 8 * ks + 2 * t);
      bt[nt][k][0] = v.x;
      bt[nt][k][1] = v.y;
    }
  }
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int mt = 0; mt < TX_FMMA_MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) tx_mma_bf16_16816(tmp[mt][nt], af[mt], bt[nt][k], tmp[mt][nt]);
  if constexpr (MC::kDigits) {
    // the same for every lane of the warp; rare, so this step's words are
    // loaded again (from the cache) rather than held in registers
    if (__any_sync(0xffffffffu, hi)) {
      Raw held[TX_FMMA_MT][2];
#pragma unroll
      for (int mt = 0; mt < TX_FMMA_MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          held[mt][h] = (ra[mt][h] < nrep && j < j_end) ? counts.fetch(ra[mt][h], j) : Raw();
        }
      for (int d = 1; d <= 3; ++d) {
#pragma unroll
        for (int mt = 0; mt < TX_FMMA_MT; ++mt) {
          float fa[4], fb[4];
          MC::digit4(held[mt][0], d, fa);
          MC::digit4(held[mt][1], d, fb);
          const uint4 v = mma_a_frag(fa, fb);
          af[mt][0] = v.x;
          af[mt][1] = v.y;
          af[mt][2] = v.z;
          af[mt][3] = v.w;
        }
#pragma unroll
        for (int k = 0; k < 3; ++k)
#pragma unroll
          for (int mt = 0; mt < TX_FMMA_MT; ++mt)
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) tx_mma_bf16_16816(tmp[mt][nt], af[mt], bt[nt][k], tmp[mt][nt]);
      }
    }
  }
}

// NT = 1 for up to 8 rows, 2 for up to 16
template <int NT, typename Rows, typename Counts>
__global__ void __launch_bounds__(TX_URS_THREADS, 2)
resample_fewmma_kernel(Rows rows, Counts counts, float* __restrict__ part, long long R, int m,
                       int nrep, long long chunk) {
  __shared__ __align__(16) uint32_t planes[2][3 * TX_FMMA_PLANE_W];
  using Filler = typename Rows::Filler;
  constexpr int AH = TX_FMMA_AHEAD;
  // grid.x = chunk (replicate blocks) + replicate block
  const int ycount = (nrep + TX_FMMA_REPS - 1) / TX_FMMA_REPS;
  const long long bx = blockIdx.x / ycount;
  const int r0 = (blockIdx.x % ycount) * TX_FMMA_REPS;
  const long long j_begin = bx * chunk;
  const long long j_end = (j_begin + chunk < R) ? j_begin + chunk : R;
  const Filler filler = rows.block(0, m);
  const int nitems = filler.nsrc * (TX_FMMA_S / 2);
  counts.init();  // the barrier after the first tile comes before any count

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int rw = r0 + 32 * (tid >> 5);  // the warp's first replicate
  const bool live = rw < nrep;          // the same for every lane of the warp
  int ra[TX_FMMA_MT][2];
#pragma unroll
  for (int mt = 0; mt < TX_FMMA_MT; ++mt) {
    ra[mt][0] = rw + 16 * mt + g;
    ra[mt][1] = ra[mt][0] + 8;
  }

  // rows from m up to the last N tile read as zeros in both buffers
  for (int i = tid; i < 2 * 3 * (8 * NT - m) * TX_FMMA_RS_W; i += TX_URS_THREADS) {
    const int b = i / (3 * (8 * NT - m) * TX_FMMA_RS_W);
    const int rest = i % (3 * (8 * NT - m) * TX_FMMA_RS_W);
    const int k = rest / ((8 * NT - m) * TX_FMMA_RS_W);
    const int c = m + (rest / TX_FMMA_RS_W) % (8 * NT - m);
    planes[b][k * TX_FMMA_PLANE_W + c * TX_FMMA_RS_W + rest % TX_FMMA_RS_W] = 0u;
  }
  float acc[TX_FMMA_MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < TX_FMMA_MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  // prologue: the first tile's rows into buffer 0, the counts of the first
  // AH k-steps into the AH register sets
  using CRaw = typename Counts::Raw;
  CRaw craw[AH][TX_FMMA_MT][2];
#pragma unroll
  for (int u = 0; u < AH; ++u)
#pragma unroll
    for (int mt = 0; mt < TX_FMMA_MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long j = j_begin + 16 * u + 4 * t;
        craw[u][mt][h] = (ra[mt][h] < nrep && j < j_end) ? counts.fetch(ra[mt][h], j) : CRaw();
      }
  for (int item = tid; item < nitems; item += TX_URS_THREADS) {
    filler.store_planes(filler.fetch_pair(item, j_begin, j_end), item, planes[0], j_begin, j_end);
  }
  __syncthreads();

  typename Filler::RawPair rraw[TX_FMMA_RI] = {};
  int cur = 0;
  for (long long t0 = j_begin; t0 < j_end; t0 += TX_FMMA_S) {
    const long long t1 = t0 + TX_FMMA_S;
    const bool more = t1 < j_end;  // the same for every thread of the block
    if (more) {  // the next tile's sample values, in flight during the products
#pragma unroll
      for (int n = 0; n < TX_FMMA_RI; ++n) {
        const int item = tid + n * TX_URS_THREADS;
        if (item < nitems) rraw[n] = filler.fetch_pair(item, t1, j_end);
        Filler::keep_pair(rraw[n]);
      }
    }
    if (live) {
      for (int n = 0; n < TX_FMMA_S / 16; n += AH) {
        float tmp[TX_FMMA_MT][NT][4];
#pragma unroll
        for (int mt = 0; mt < TX_FMMA_MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) tmp[mt][nt][e] = 0.f;
#pragma unroll
        for (int u = 0; u < AH; ++u) {
          const long long j = t0 + 16 * (n + u) + 4 * t;
          fewmma_step<NT>(counts, craw[u], tmp, planes[cur], ra, nrep, j, j + 16 * AH, j_end, n + u,
                          lane);
        }
#pragma unroll
        for (int mt = 0; mt < TX_FMMA_MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mt][nt][e] += tmp[mt][nt][e];
      }
    }
    if (more) {  // the rows of the next tile into the other buffer
#pragma unroll
      for (int n = 0; n < TX_FMMA_RI; ++n) {
        const int item = tid + n * TX_URS_THREADS;
        if (item < nitems) filler.store_planes(rraw[n], item, planes[cur ^ 1], t1, j_end);
      }
      for (int item = tid + TX_FMMA_RI * TX_URS_THREADS; item < nitems; item += TX_URS_THREADS) {
        filler.store_planes(filler.fetch_pair(item, t1, j_end), item, planes[cur ^ 1], t1, j_end);
      }
    }
    __syncthreads();  // the tile is consumed and the next one is complete
    cur ^= 1;
  }

  if (!live) return;
#pragma unroll
  for (int mt = 0; mt < TX_FMMA_MT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = ra[mt][e >> 1];
        const int c = 8 * nt + 2 * t + (e & 1);
        if (r < nrep && c < m) part[(bx * nrep + r) * m + c] = acc[mt][nt][e];
      }
    }
  }
}

inline bool resample_fewmma_shape_ok(long long m, long long R, int nrep, int nchunk, long long chunk) {
  if (m < 1 || m > TX_URS_CB || nrep < 1 || R < 1 || nchunk < 1 || chunk < 1 ||
      chunk % TX_FMMA_S != 0 || (long long)nchunk * chunk < R) {
    return false;
  }
  return (long long)nchunk * ((nrep + TX_FMMA_REPS - 1) / TX_FMMA_REPS) <= 2147483647LL;
}

// Launch on `stream`; write part (nchunk, nrep, m) float32 and return the
// launch status.  Counts: the draw or an int8 / int16 / int32 table
// (MmaCounts<Counts>); Rows: a filler with fetch_pair / store_planes.
template <typename Rows, typename Counts>
int launch_fewmma(Rows rows, Counts counts, void* part, long long R, int m, int nrep, int nchunk,
                  long long chunk, cudaStream_t stream) {
  const int ycount = (nrep + TX_FMMA_REPS - 1) / TX_FMMA_REPS;
  const dim3 grid((unsigned)((long long)nchunk * ycount), 1, 1);
  if (m <= 8) {
    resample_fewmma_kernel<1, Rows, Counts><<<grid, TX_URS_THREADS, 0, stream>>>(
        rows, counts, (float*)part, R, m, nrep, chunk);
  } else {
    resample_fewmma_kernel<2, Rows, Counts><<<grid, TX_URS_THREADS, 0, stream>>>(
        rows, counts, (float*)part, R, m, nrep, chunk);
  }
  return (int)cudaGetLastError();
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
