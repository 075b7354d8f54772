// K7 and K8: bootstrap sums of perturbation-reweighted samples, one kernel,
// two count sources.
//
// Replaces thermoextrap_tpu/ops/moments_pallas.py
//   K7 resample_perturb_freq    (kernel _perturb_freq_kernel, :1404): counts
//      loaded from a materialized (nrep, R) table of type int8 / int16 /
//      int32 / float32 / bfloat16;
//   K8 resample_perturb_poisson (kernel _perturb_poisson_kernel, :1357):
//      Poisson(1) counts drawn inside the kernel, so the table never exists.
//
// For target a, replicate r and contribution row c = a (V + 1) + k:
//   part[chunk, r, c] = sum_{j in chunk} count(r, j) e_a(j) [x_j | 1]_k
// with e (A, R) the max-shift-stabilized reweighting factors, streamed from
// device memory as the prediction path built them (sample weights and zero
// masks already folded in), so kernel and prediction see the same values.
// The caller sums the chunk partials in float64 and divides numerators by
// the last column.
//
// The contraction is one of the two kernels of resample_tile.cuh (what bounds
// them is said there): up to 16 rows A (V + 1), the serving shape among them,
// run in the few-rows kernel, where the counts go from the table (or the
// draw) through registers into the FMAs; more rows run in the many-rows
// kernel, where each count is drawn or loaded once per (replicate, sample)
// into shared memory for all rows of a block, and beyond 512 rows the kernel
// loops over row tiles on grid.z, drawing once per tile.  K8 draws by the
// Philox schedule of philox.cuh indexed by the global sample, as K3 does: at
// e = 1 its weight-sum column is K3's per-replicate weight sum exactly, and
// K8 on a seed equals K7 on that seed's count table bit for bit (same path
// through the sums).
//
// Bound on the H100 at the serving shape (A = 5, V = 1, nrep = 128; 10 FMAs a
// count): for K7 the count table's bytes (nrep R, 1 to 4 bytes each) beside
// 4 (A + V) R bytes of e and x; for K8 the integer instructions of the draw
// (a quarter Philox call and a level lookup a count, philox.cuh).  PERF.md
// has the times.

#include "resample_tile.cuh"

namespace {

// rows c = a (V + 1) + k of the targets behind a block's row tile
struct PerturbFill {
  // one (target, sample) item of the few-rows kernel: e_a(j) and the first
  // value column are fetched ahead, further value columns are read when the
  // rows are stored
  struct Raw {
    float e, x0;
  };
  const float* e;  // (A, R)
  const float* x;  // (R, V)
  long long R;
  int V;
  int c0;     // first row of the tile
  int ncol;   // rows of the tile
  int a_lo;   // first target behind the tile
  int nsrc;   // targets behind the tile

  static __device__ __forceinline__ void keep(Raw& raw) {
    tx_keep(raw.e);
    tx_keep(raw.x0);
  }

  __device__ __forceinline__ Raw fetch(int item, long long t0, long long j_end) const {
    const long long j = t0 + item % TX_FEW_TILE;
    Raw raw = {0.f, 0.f};
    if (j < j_end) {
      raw.e = e[(long long)(a_lo + item / TX_FEW_TILE) * R + j];
      if (V > 0) raw.x0 = x[j * V];
    }
    return raw;
  }

  __device__ __forceinline__ void store(Raw raw, int item, float* tile, int gstride,
                                        long long t0, long long j_end) const {
    const int i = item % TX_FEW_TILE;
    const long long j = t0 + i;
    const bool valid = j < j_end;
    float* at = tile + (i >> 2) * gstride + (i & 3);
    const int row0 = (a_lo + item / TX_FEW_TILE) * (V + 1) - c0;
    for (int k = 0; k <= V; ++k) {
      const int cc = row0 + k;
      if ((unsigned)cc < (unsigned)ncol) {
        const float xk = (k == V) ? 1.f : ((k == 0) ? raw.x0 : (valid ? x[j * V + k] : 0.f));
        at[4 * cc] = raw.e * xk;  // raw.e is 0 past j_end
      }
    }
  }

  __device__ __forceinline__ void fill(float* tile, int tstride, long long t0,
                                       long long j_end) const {
    const int v1 = V + 1;
    // one (target, sample) pair per item
    for (int item = threadIdx.x; item < nsrc * TX_URS_TILE; item += TX_URS_THREADS) {
      const int a = a_lo + item / TX_URS_TILE;
      const int i = item % TX_URS_TILE;
      const long long j = t0 + i;
      const bool valid = j < j_end;
      const float ea = valid ? e[(long long)a * R + j] : 0.f;
      const int row0 = a * v1 - c0;
      for (int k = 0; k < v1; ++k) {
        const int cc = row0 + k;
        if ((unsigned)cc < (unsigned)ncol) {
          const float xk = (k < V && valid) ? x[j * V + k] : 1.f;
          tile[i * tstride + cc] = ea * xk;
        }
      }
    }
  }
};

struct PerturbRows {
  using Filler = PerturbFill;
  const float* e;
  const float* x;
  long long R;
  int V;

  __device__ __forceinline__ PerturbFill block(int c0, int c_end) const {
    const int a_lo = c0 / (V + 1);
    return {e, x, R, V, c0, c_end - c0, a_lo, (c_end - 1) / (V + 1) - a_lo + 1};
  }
};

}  // namespace

extern "C" {

// e (A, R), x (R, V) float32.  count_kind: 0 int8, 1 int16, 2 int32,
// 3 float32, 4 bfloat16 table freq (nrep, R); 5 Poisson counts drawn from
// (seed, thresholds[9]) with freq unused.  nr, np: row- and replicate-threads
// of a block (powers of two, nr np divides 256, 256 / (nr np) divides 32).
// Writes part (nchunk, nrep, A (V+1)) float32, chunk samples per chunk (a
// multiple of TX_URS_TILE).  Returns the launch status.
int tx_resample_perturb(const void* e, const void* x, const void* freq, void* part, long long A,
                        long long R, int V, int nrep, int nchunk, long long chunk, int nr,
                        int np, int count_kind, long long seed, const unsigned int* thresholds,
                        int device, void* stream) {
  if (A < 1 || V < 0 || V > 2147483646 ||
      !resample_rows_shape_ok(A * ((long long)V + 1), R, nrep, nchunk, chunk, nr, np) ||
      (count_kind != 5 && freq == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const PerturbRows rows{(const float*)e, (const float*)x, R, V};
  const int m = (int)(A * (V + 1));
  cudaStream_t s = (cudaStream_t)stream;
  switch (count_kind) {
    case 0:
      return launch_resample_rows(rows, TableCounts<int8_t>{(const int8_t*)freq, R}, part, R, m,
                                  nrep, nchunk, chunk, nr, np, s);
    case 1:
      return launch_resample_rows(rows, TableCounts<int16_t>{(const int16_t*)freq, R}, part, R,
                                  m, nrep, nchunk, chunk, nr, np, s);
    case 2:
      return launch_resample_rows(rows, TableCounts<int32_t>{(const int32_t*)freq, R}, part, R,
                                  m, nrep, nchunk, chunk, nr, np, s);
    case 3:
      return launch_resample_rows(rows, TableCounts<float>{(const float*)freq, R}, part, R, m,
                                  nrep, nchunk, chunk, nr, np, s);
    case 4:
      return launch_resample_rows(rows,
                                  TableCounts<__nv_bfloat16>{(const __nv_bfloat16*)freq, R},
                                  part, R, m, nrep, nchunk, chunk, nr, np, s);
    case 5: {
      PoissonCounts draw;
      if (!make_poisson(seed, thresholds, &draw)) return (int)cudaErrorInvalidValue;
      return launch_resample_rows(rows, draw, part, R, m, nrep, nchunk, chunk, nr, np, s);
    }
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
