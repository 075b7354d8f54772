// MBAR's expectations at A linear-in-alpha targets in one pass over the
// samples: models.mbar.mbar_expectations_alphas on CUDA tensors.
//
// Replaces no TPU kernel: the JAX package has no Pallas kernel for MBAR
// (thermoextrap_tpu/models/mbar.py leaves the grid to XLA, which fuses each
// block of targets).  In eager PyTorch the same grid was ~10 passes over an
// (A, N) worth of temporaries, one target a block, and took ~900 ms of a
// 1.06 s MBARModel.predict at K = 4, N = 1e8, A = 256.
//
// For sample n and target a, in log2 units (LOG2E = log2(e)):
//   ld_n = log2 sum_k exp2((c_k - u_kn) LOG2E),  c_k = log n_k + f_k
//   t_an = -alpha_a LOG2E u_base_n + (lsw_n LOG2E - ld_n)
//   out[a, v] = sum_n exp2(t_an - m_a) x_nv / sum_n exp2(t_an - m_a)
// with lsw the optional per-sample log weight (-inf drops the sample) and
// m_a any shift near the maximum of t_an; no (A, N), (K, N) or (N, V)
// temporary is written.
//
// mbar_alphas_kernel<T, VG>: a persistent grid of (nbx, ceil(A / 256))
// blocks of 256 threads; block (bx, gy) walks the sample tiles bx, bx + nbx,
// ... for the targets gy 256 .. gy 256 + r - 1 (r <= 256 of them).  Each
// tile of TX_MBAR_TILE samples is staged once in shared memory as rows
// {u_base, b = lsw LOG2E - ld, x_c0 .. x_c0+VG-1} (16-byte aligned), b made
// there from u_kn's K rows by an online log-sum-exp (one ex2 a state and
// sample).  Thread t owns target t % r and, where the block has more threads
// than targets (L = 256 / r lanes a target), a contiguous 1/L share of the
// tile's rows (lane t / r); it reads the rows by broadcast and keeps its
// run's sums in registers: a 16-byte shared load, one FFMA, one FADD, one
// ex2 and 1 + VG FADD / FFMA a row.  A whole tile (one lane a target) is a
// loop of fixed length, so the loads take immediate offsets and no exit test
// sits between the rows.  The shift m is the thread's largest t seen so far,
// raised lazily: a tile is summed against the current m, and only where that
// sum leaves [0, 2^64] (the first tile, a jump of the maximum by ~64, NaN)
// is the tile's maximum taken and the tile summed again, with the thread's
// earlier sums rescaled.  A tile's run is at most TX_MBAR_TILE samples in the
// working type; runs are added into float64 registers, so a sum over 1e8
// samples keeps float32's accuracy.  At the end the L lanes of a target
// combine in shared memory (each partial rescaled to the larger shift) and
// the block writes (m, sum e, sum e x_v) of each target to part[gy][bx][a],
// float64.
//
// mbar_alphas_combine_kernel<T, VG>: one block of 32 threads a target gathers
// its nbx partials, rescales them to their largest m (float64) and writes
// out[a, c0 + v] = sum e x_v / sum e in the working type.
//
// Column groups: V > 8 value columns run as ceil(V / 8) groups of near-equal
// width, a main and a combine launch each, so that a thread's sums stay in
// registers (each group repeats the exponentials).
//
// Bound on the H100 at the serving shape (K = 4, N = 1e8, A = 256, V = 2,
// float32): the (A + K) N = 2.57e10 exponentials at 16 ex2 a clock and SM
// (4.18e12/s): 6.2 ms; the 2.8 GB read take 0.84 ms.  Every ex2 of the
// float32 path is the card's ex2.approx.ftz.f32 (MUFU.EX2); beside it a row
// costs 6 issued instructions and the fixed-length loop ~3/8 more, under the
// 8 an SM issues per MUFU instruction, so the exponentials set the pace.
// float64 takes exp2 on the FP64 pipe.  At A = 1 the kernel reads the
// samples once and is bound by bytes.  PERF.md has the times.

#include "common.cuh"

#define TX_MBAR_THREADS 256  // threads of a main-kernel block: the targets of a group
#define TX_MBAR_TILE 512     // samples a block stages at a time
#define TX_MBAR_MAX_VG 8     // value columns of a group
#define TX_MBAR_COMBINE 32   // threads of a combine block

namespace {

// a row of the staged tile: 2 + VG numbers padded to 16 bytes, moved by
// 16-byte shared-memory loads and stores
template <typename T, int VG>
struct MbarRow {
  static constexpr int R = 16 / (int)sizeof(T);
  static constexpr int P = (2 + VG + R - 1) / R * R;
  T v[P];

  __device__ __forceinline__ void load(const T* p) {
#pragma unroll
    for (int q = 0; q < P / R; ++q) {
      if constexpr (sizeof(T) == 4) {
        const float4 f = reinterpret_cast<const float4*>(p)[q];
        v[4 * q] = f.x;
        v[4 * q + 1] = f.y;
        v[4 * q + 2] = f.z;
        v[4 * q + 3] = f.w;
      } else {
        const double2 d = reinterpret_cast<const double2*>(p)[q];
        v[2 * q] = d.x;
        v[2 * q + 1] = d.y;
      }
    }
  }
  __device__ __forceinline__ void store(T* p) const {
#pragma unroll
    for (int q = 0; q < P / R; ++q) {
      if constexpr (sizeof(T) == 4) {
        reinterpret_cast<float4*>(p)[q] = make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
      } else {
        double2 d;
        d.x = v[2 * q];
        d.y = v[2 * q + 1];
        reinterpret_cast<double2*>(p)[q] = d;
      }
    }
  }
};

// one thread's sums over its rows j0 .. j1 - 1 of a staged tile against the
// shift m: s = sum exp2(t - m), sx[v] = sum exp2(t - m) x_v.  A whole tile
// (one lane a target) runs a loop of fixed length, so that the rows are read
// at immediate offsets and no exit test falls between them.
template <typename T, int VG>
__device__ __forceinline__ void mbar_tile_sums(const T* tile, int j0, int j1, T a2, T m, T& s,
                                               T (&sx)[VG]) {
  using Row = MbarRow<T, VG>;
  s = T(0);
#pragma unroll
  for (int v = 0; v < VG; ++v) sx[v] = T(0);
  auto add = [&](const T* p) {
    Row row;
    row.load(p);
    const T e = tx_ex2(tx_fma(a2, row.v[0], row.v[1]) - m);
    s += e;
#pragma unroll
    for (int v = 0; v < VG; ++v) sx[v] = tx_fma(e, row.v[2 + v], sx[v]);
  };
  if (j1 - j0 == TX_MBAR_TILE) {
#pragma unroll 8
    for (int j = 0; j < TX_MBAR_TILE; ++j) add(tile + j * Row::P);
  } else {
#pragma unroll 4
    for (int j = j0; j < j1; ++j) add(tile + j * Row::P);
  }
}

template <typename T, int VG>
__global__ void __launch_bounds__(TX_MBAR_THREADS)
mbar_alphas_kernel(const T* __restrict__ u_kn, const T* __restrict__ c_k, const T* __restrict__ alphas,
                   const T* __restrict__ u_base, const T* __restrict__ x, const T* __restrict__ lsw,
                   double* __restrict__ part, long long N, int K, int A, int V, int c0) {
  using Row = MbarRow<T, VG>;
  constexpr int P = Row::P;
  const T LOG2E = T(1.4426950408889634);
  const T NEG_INF = -T(INFINITY);
  __shared__ __align__(16) T tile[TX_MBAR_TILE * P];

  const int a0 = (int)blockIdx.y * TX_MBAR_THREADS;
  const int r = A - a0 < TX_MBAR_THREADS ? A - a0 : TX_MBAR_THREADS;
  const int lanes = TX_MBAR_THREADS / r;  // threads a target
  const int t = (int)threadIdx.x;
  const bool active = t < r * lanes;
  const int sub = t / r;
  const T a2 = active ? -alphas[a0 + t % r] * LOG2E : T(0);

  T m = NEG_INF;
  double ds = 0.0;
  double dx[VG];
#pragma unroll
  for (int v = 0; v < VG; ++v) dx[v] = 0.0;

  const long long ntiles = (N + TX_MBAR_TILE - 1) / TX_MBAR_TILE;
  for (long long tl = blockIdx.x; tl < ntiles; tl += gridDim.x) {
    const long long n0 = tl * TX_MBAR_TILE;
    const int cnt = N - n0 < TX_MBAR_TILE ? (int)(N - n0) : TX_MBAR_TILE;
    __syncthreads();  // the previous tile is read
    for (int j = t; j < cnt; j += TX_MBAR_THREADS) {
      const long long n = n0 + j;
      // online log-sum-exp over the states, in log2 units
      T mk = NEG_INF, sk = T(0);
      for (int k = 0; k < K; ++k) {
        const T y = (c_k[k] - u_kn[(long long)k * N + n]) * LOG2E;
        if (y > NEG_INF) {
          const T d = y - mk;
          const T e = tx_ex2(-tx_abs(d));
          sk = d > T(0) ? tx_fma(sk, e, T(1)) : sk + e;
          mk = tx_max(mk, y);
        }
      }
      Row row;
      row.v[0] = u_base[n];
      row.v[1] = (lsw == nullptr ? T(0) : lsw[n] * LOG2E) - (mk + tx_lg2(sk));
#pragma unroll
      for (int v = 0; v < VG; ++v) row.v[2 + v] = x[n * V + c0 + v];
#pragma unroll
      for (int v = 2 + VG; v < P; ++v) row.v[v] = T(0);
      row.store(tile + (long long)j * P);
    }
    __syncthreads();
    if (!active) continue;

    // this lane's rows of the tile: a contiguous share
    const int j0 = sub * cnt / lanes, j1 = (sub + 1) * cnt / lanes;
    T s, sx[VG];
    bool ok = false;
    if (m > NEG_INF) {
      mbar_tile_sums<T, VG>(tile, j0, j1, a2, m, s, sx);
      ok = s <= T(18446744073709551616.0);  // 2^64; false for inf and NaN
#pragma unroll
      for (int v = 0; v < VG; ++v) ok = ok && (sx[v] - sx[v] == T(0));
    }
    if (!ok) {
      // the tile's own maximum, then the tile again against the new shift
      T mt = NEG_INF;
      for (int j = j0; j < j1; ++j) {
        const T* p = tile + j * P;
        mt = tx_max(mt, tx_fma(a2, p[0], p[1]));
      }
      const T mn = tx_max(m, mt);
      if (mn > m) {
        const double scale = exp2((double)m - (double)mn);
        ds *= scale;
#pragma unroll
        for (int v = 0; v < VG; ++v) dx[v] *= scale;
        m = mn;
      }
      if (m > NEG_INF) {
        mbar_tile_sums<T, VG>(tile, j0, j1, a2, m, s, sx);
      } else {  // every sample so far dropped
        s = T(0);
#pragma unroll
        for (int v = 0; v < VG; ++v) sx[v] = T(0);
      }
    }
    ds += (double)s;
#pragma unroll
    for (int v = 0; v < VG; ++v) dx[v] += (double)sx[v];
  }
  static_assert(TX_MBAR_TILE * P * sizeof(T) >= TX_MBAR_THREADS * (2 + VG) * sizeof(double),
                "the lanes' partials fit in the tile");
  // the lanes of a target combine in shared memory (the tile's space, read
  // by now), by halves: lane sub takes in lane sub + h, each rescaled to the
  // larger shift; then lane 0 of each target writes the block's partial
  __syncthreads();
  double* red = reinterpret_cast<double*>(tile);
  if (active) {
    double* mine = red + t * (2 + VG);
    mine[0] = (double)m;
    mine[1] = ds;
#pragma unroll
    for (int v = 0; v < VG; ++v) mine[2 + v] = dx[v];
  }
  for (int h = 1; h < lanes; h *= 2) {
    __syncthreads();
    if (active && sub % (2 * h) == 0 && sub + h < lanes) {
      double* mine = red + t * (2 + VG);
      const double* other = red + (t + h * r) * (2 + VG);
      const double mx = fmax(mine[0], other[0]);
      if (mx > -(double)INFINITY) {
        const double wa = exp2(mine[0] - mx), wb = exp2(other[0] - mx);
#pragma unroll
        for (int v = 1; v < 2 + VG; ++v) mine[v] = mine[v] * wa + other[v] * wb;
        mine[0] = mx;
      }
    }
  }
  __syncthreads();
  if (t < r) {
    const double* mine = red + t * (2 + VG);
    double* dst = part + (((long long)blockIdx.y * gridDim.x + blockIdx.x) * TX_MBAR_THREADS + t) * (2 + VG);
#pragma unroll
    for (int v = 0; v < 2 + VG; ++v) dst[v] = mine[v];
  }
}

// one block a target a: its partials are slot a % 256 of every block bx of
// its group, (2 + VG) numbers each, rescaled to the largest shift and summed
// in float64
template <typename T, int VG>
__global__ void __launch_bounds__(TX_MBAR_COMBINE)
mbar_alphas_combine_kernel(const double* __restrict__ part, T* __restrict__ out, int V, int c0, int nbx) {
  __shared__ double red[TX_MBAR_COMBINE];
  const int a = (int)blockIdx.x;
  const int t = (int)threadIdx.x;
  const double* base = part + ((long long)(a / TX_MBAR_THREADS) * nbx * TX_MBAR_THREADS + a % TX_MBAR_THREADS) * (2 + VG);
  const long long stride = (long long)TX_MBAR_THREADS * (2 + VG);
  auto block_reduce = [&](double v, bool is_max) {
    red[t] = v;
    __syncthreads();
    for (int w = TX_MBAR_COMBINE / 2; w > 0; w >>= 1) {
      if (t < w) red[t] = is_max ? fmax(red[t], red[t + w]) : red[t] + red[t + w];
      __syncthreads();
    }
    const double total = red[0];
    __syncthreads();
    return total;
  };

  double mx = -(double)INFINITY;
  for (int e = t; e < nbx; e += TX_MBAR_COMBINE) mx = fmax(mx, base[e * stride]);
  mx = block_reduce(mx, true);
  double acc[1 + VG];
#pragma unroll
  for (int v = 0; v < 1 + VG; ++v) acc[v] = 0.0;
  for (int e = t; e < nbx; e += TX_MBAR_COMBINE) {
    const double* p = base + e * stride;
    if (p[0] > -(double)INFINITY) {
      const double w = exp2(p[0] - mx);
#pragma unroll
      for (int v = 0; v < 1 + VG; ++v) acc[v] += p[1 + v] * w;
    }
  }
  const double s = block_reduce(acc[0], false);
#pragma unroll
  for (int v = 0; v < VG; ++v) {
    const double sx = block_reduce(acc[1 + v], false);
    if (t == 0) out[(long long)a * V + c0 + v] = (T)(sx / s);
  }
}

template <typename T, int VG>
int launch_mbar_group(const T* u_kn, const T* c_k, const T* alphas, const T* u_base, const T* x,
                      const T* lsw, double* part, T* out, long long N, int K, int A, int V, int c0,
                      int nbx, cudaStream_t s) {
  const dim3 grid((unsigned)nbx, (unsigned)((A + TX_MBAR_THREADS - 1) / TX_MBAR_THREADS), 1);
  mbar_alphas_kernel<T, VG><<<grid, TX_MBAR_THREADS, 0, s>>>(u_kn, c_k, alphas, u_base, x, lsw, part,
                                                             N, K, A, V, c0);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  mbar_alphas_combine_kernel<T, VG><<<(unsigned)A, TX_MBAR_COMBINE, 0, s>>>(part, out, V, c0, nbx);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_mbar(const T* u_kn, const T* c_k, const T* alphas, const T* u_base, const T* x, const T* lsw,
                double* part, T* out, long long N, int K, int A, int V, int nbx, cudaStream_t s) {
  const int ng = (V + TX_MBAR_MAX_VG - 1) / TX_MBAR_MAX_VG;
  int c0 = 0;
  for (int g = 0; g < ng; ++g) {
    const int vg = V / ng + (g < V % ng ? 1 : 0);
    int st = (int)cudaErrorInvalidValue;
    switch (vg) {
#define TX_MBAR_CASE(W)                                                                          \
  case W:                                                                                        \
    st = launch_mbar_group<T, W>(u_kn, c_k, alphas, u_base, x, lsw, part, out, N, K, A, V, c0, \
                                 nbx, s);                                                        \
    break;
      TX_MBAR_CASE(1)
      TX_MBAR_CASE(2)
      TX_MBAR_CASE(3)
      TX_MBAR_CASE(4)
      TX_MBAR_CASE(5)
      TX_MBAR_CASE(6)
      TX_MBAR_CASE(7)
      TX_MBAR_CASE(8)
#undef TX_MBAR_CASE
      default:
        break;
    }
    if (st != 0) return st;
    c0 += vg;
  }
  return 0;
}

// resident blocks of the main kernel of value-column groups of width vg, on
// the whole card
template <typename T>
int mbar_resident_blocks(int vg, int device, int* blocks) {
  int sms = 0, per = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  switch (vg) {
#define TX_MBAR_CASE(W)                                                                             \
  case W:                                                                                           \
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, mbar_alphas_kernel<T, W>, TX_MBAR_THREADS, 0); \
    break;
    TX_MBAR_CASE(1)
    TX_MBAR_CASE(2)
    TX_MBAR_CASE(3)
    TX_MBAR_CASE(4)
    TX_MBAR_CASE(5)
    TX_MBAR_CASE(6)
    TX_MBAR_CASE(7)
    TX_MBAR_CASE(8)
#undef TX_MBAR_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
  *blocks = per * sms;
  return (int)err;
}

}  // namespace

extern "C" {

// The main kernel's resident blocks on the card for V value columns (its
// widest column group) of float64 (is_double != 0) or float32: the size of
// its persistent grid.  Writes blocks; returns the status.
int tx_mbar_alphas_blocks(int V, int is_double, int device, int* blocks) {
  if (V < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int ng = (V + TX_MBAR_MAX_VG - 1) / TX_MBAR_MAX_VG;
  const int vg = (V + ng - 1) / ng;
  return is_double ? mbar_resident_blocks<double>(vg, device, blocks)
                   : mbar_resident_blocks<float>(vg, device, blocks);
}

// u_kn (K, N), c_k (K,) = log n_k + f_k, alphas (A,), u_base (N,), x (N, V)
// row major, lsw (N,) or null: all of one type (is_double != 0: float64,
// else float32), contiguous.  part: float64 scratch of
// ceil(A / 256) nbx 256 (2 + min(V, 8)) numbers.  Writes out (A, V).
// Returns the launch status.
int tx_mbar_alphas(const void* u_kn, const void* c_k, const void* alphas, const void* u_base,
                   const void* x, const void* lsw, void* part, void* out, long long N, int K, int A,
                   int V, int nbx, int is_double, int device, void* stream) {
  if (N < 1 || K < 1 || A < 1 || V < 1 || nbx < 1 ||
      (A + TX_MBAR_THREADS - 1) / TX_MBAR_THREADS > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_double) {
    return launch_mbar<double>((const double*)u_kn, (const double*)c_k, (const double*)alphas,
                               (const double*)u_base, (const double*)x, (const double*)lsw,
                               (double*)part, (double*)out, N, K, A, V, nbx, s);
  }
  return launch_mbar<float>((const float*)u_kn, (const float*)c_k, (const float*)alphas,
                            (const float*)u_base, (const float*)x, (const float*)lsw, (double*)part,
                            (float*)out, N, K, A, V, nbx, s);
}

}  // extern "C"
