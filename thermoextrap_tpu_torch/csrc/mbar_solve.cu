// MBAR's Newton / self-consistent hybrid solve, one pass over u_kn an
// iteration: models.mbar._solve on one problem of CUDA tensors
// (ops/mbar_cuda.py, MbarSolve).
//
// Replaces no TPU kernel: the JAX package has no Pallas kernel for MBAR
// (thermoextrap_tpu/models/mbar.py leaves the solve's while_loop to XLA).  In
// eager PyTorch an iteration was ~30 passes over (K, N) temporaries: ~52 ms
// at K = 4, N = 1e8 float32 against the 0.48 ms of one read of u_kn.
//
// For the candidate free energies f of a pass, with c_k = log n_k + f_k and
// lsw_n the optional per-sample log weight (-inf drops the sample), a
// sample's weight in state k is W_kn = exp(f_k - u_kn - ld_n + lsw_n) =
// e^{lsw_n} p_kn / n_k, p_kn = softmax_k(c_k - u_kn) (over the sampled
// states: n_k > 0); the kernel sums x_kn = nu_k W_kn, nu_k = n_k for a
// sampled state and 1 for another (whose c_k is f_k alone), so that x <= 1
// where the states are sampled and no division by n_k is made per sample:
//   S_k = sum_n W_kn (residual S_k - 1),  G_kl = sum_n W_kn W_ln (Gram).
// All an iteration needs of a candidate is (S, G): the self-consistent
// candidate is f - log S, the Newton gradient n (S - 1) and the Hessian
// diag(n S) - n n^T G.  No log denominator and no (K, N) or (N,) temporary
// is made.
//
// mbar_solve_kernel<T, K>: a persistent grid (one wave of the resident
// blocks) of 256 threads walks the samples in a grid stride.  Where K <= 4
// and u_kn's rows are 16-byte aligned a thread loads 16 bytes of each row at
// a time (4 float32 or 2 float64 samples), a group ahead of its sums, else
// one sample.  Per sample and candidate: K FMAs (c_k - u_kn in log2 units,
// less a constant), a max, K ex2 and one rcp (MUFU in float32), K
// multiplies, then the candidate's sums in float64 registers: K adds and
// K (K + 1) / 2 FMAs, the float32 terms widened by integer operations
// (tx_solve_terms).  The two candidates of an iteration share one read of
// u_kn.  Where a group's spread of c_k and u_kn lets a state fall more than
// 2^-120 below a sample's largest exponential, the group's float32 terms
// come from their exponents (tx_solve_terms_wide), so that a state far
// from its free energy keeps its digits below float32's range.  e^{lsw} is
// unbounded, so with a log weight a thread adds x e^{-m} against a shift
// m, its largest log weight so far (log2 units), raised lazily: only a
// sample above it raises m and rescales the thread's sums.  At the end the
// block folds its threads' sums, each rescaled to the block's largest m, in
// shared memory, 8 at a time, and writes them with that m to part[block],
// float64.
//
// mbar_solve_combine_kernel<T>: one block folds the partials (each rescaled
// to the largest m) in float64, divides by nu, forms each candidate's residual
// max_k |S_k - 1| and keeps the one models.mbar._hybrid_step keeps: the
// Newton candidate where its residual is finite and smaller, else the
// self-consistent one.  It writes f, the residual, the iteration count and
// whether to go on (residual > tol and n_iter < max_iter), then builds the
// next pair on one thread from the kept (S, G): f - log S, and the
// gauge-fixed Newton step on f[1:] with the Tikhonov floor 1e-10 tr / (K - 1)
// by Gaussian elimination with partial pivoting (a zero pivot gives a
// non-finite candidate, whose residual loses).  A solve is an opening pass
// (f = 0, one candidate) and then one pass an iteration.
//
// Bound (portbench/roofline_ops/mbar_iter.py): one read of u_kn an
// iteration, 4 K N bytes, 0.478 ms at K = 4, N = 1e8 float32 on the H100's
// 3.35 TB/s.  Beside the read a sample costs 2 K ex2 and 2 rcp on MUFU
// (10 at K = 4, 0.24 ms at 16 a clock and SM) and K (K + 3) float64 adds and
// FMAs (28, 0.17 ms at 64 a clock and SM), so at K = 4 the read sets the
// pace if enough loads are in flight: 16-byte loads issued a group ahead,
// the sums of two candidates in registers rather than two reads, and no
// F2F conversion (it shares MUFU's pipe).  PERF.md has the times.

#include "common.cuh"

#define TX_SOLVE_THREADS 256  // threads of a main-kernel block
#define TX_SOLVE_MAX_K 8      // states the kernel takes
#define TX_SOLVE_CH 8         // sums a block folds at a time
#define TX_SOLVE_COMBINE 256  // threads of the combine block

namespace {

// sums of one candidate: S (K), then G's upper triangle row by row
__host__ __device__ constexpr int tx_solve_acc(int K) { return K + K * (K + 1) / 2; }
// samples a thread loads at a time from each row
template <typename T, int K>
__host__ __device__ constexpr int tx_solve_vec() {
  return K <= 4 ? 16 / (int)sizeof(T) : 1;
}

template <typename T, int V>
__device__ __forceinline__ void tx_solve_load(const T* p, T (&v)[V]) {
  if constexpr (V == 4) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    v[0] = f.x;
    v[1] = f.y;
    v[2] = f.z;
    v[3] = f.w;
  } else if constexpr (V == 2) {
    const double2 d = *reinterpret_cast<const double2*>(p);
    v[0] = d.x;
    v[1] = d.y;
  } else {
    v[0] = *p;
  }
}

// scale a thread's sums by sc (S) and sc^2 (G)
template <int K>
__device__ __forceinline__ void tx_solve_rescale(double (&acc)[2 * tx_solve_acc(K)], double sc) {
  constexpr int A = tx_solve_acc(K);
#pragma unroll
  for (int i = 0; i < 2 * A; ++i) acc[i] *= (i % A) < K ? sc : sc * sc;
}

// One sample's terms (below) from their exponents: with mx' = mx rounded to an
// integer (a shift common to every state, which the quotient by s drops),
// 2^(y - mx') = 2^f 2^i, i an integer found by the sum with 1.5 2^23 and
// floored at -896, |f| <= 1/2; one ex2 of f.  The denominator s, over the
// sampled states, is taken in float32 (2^i made from exponent bits, floored
// at 2^-126: such a term is below the last digit of s, whose largest term is
// about 1), and each term's 2^i put into the exponent of its float64 value:
// at the floor that exponent is the float32 one, so it cannot wrap and a 0
// stays 0, and a term more than 2^-896 below the largest is 0.  A y of -inf
// (a sample the state cannot have) gives a term of 0, a NaN a NaN s.
template <int K>
__device__ __forceinline__ bool tx_solve_terms_wide(const float (&y)[K], float mx, const float (&sg)[K], float w,
                                                    double (&x)[K]) {
  constexpr float MAGIC = 12582912.0f;  // 1.5 2^23: a float32 sum with it rounds to an integer
  const float mg = MAGIC - mx;          // MAGIC - mx', exactly
  float e[K];
  int di[K];
  float s = 0.0f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const float tr = fmaxf(y[k] + mg, MAGIC - 896.0f);  // MAGIC + i
    di[k] = __float_as_int(tr) - __float_as_int(MAGIC);
    e[k] = tx_ex2(y[k] - (tr - mg));
    s = fmaf(sg[k], e[k] * __int_as_float(((di[k] > -126 ? di[k] : -126) + 127) << 23), s);
  }
  const float r = w * tx_rcp(s);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const unsigned b = __float_as_uint(e[k] * r);
    x[k] = __hiloint2double((int)((b >> 3) + 0x38000000u) + (di[k] << 20), (int)(b << 29));
  }
  return fabsf(r) < INFINITY;
}

// One sample's terms x_k of a candidate, x_k = w p_k for a sampled state
// (n_k W_k) and w W_k for another, in float64: y[k] the log2 of each
// state's exponential, mx their largest, w the sample's weight.  Returns
// false where a term is not finite.  The float32 value of a term is widened
// by integer operations (exponent rebiased, mantissa shifted: exact for a
// normal number), since F2F.F64.F32 shares MUFU's pipe, at 16 a clock and
// SM, with the exponentials.
//
// WIDE (tx_solve_wide decides, a group of samples at a time) takes the
// terms from their exponents, so that a state more than 2^-120 below a
// sample's largest keeps its digits below float32's range, as the torch
// route's log-sum-exp over the samples does (rare where the states overlap;
// every sample of a state whose free energy is far from f).
template <bool WIDE, int K>
__device__ __forceinline__ bool tx_solve_terms(const float (&y)[K], float mx, const float (&sg)[K], float w,
                                               double (&x)[K]) {
  if constexpr (WIDE) return tx_solve_terms_wide<K>(y, mx, sg, w, x);
  float e[K], s = 0.0f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    e[k] = tx_ex2(y[k] - mx);
    s = fmaf(sg[k], e[k], s);
  }
  const float r = w * tx_rcp(s);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const unsigned b = __float_as_uint(e[k] * r);
    x[k] = __hiloint2double((int)((b >> 3) + 0x38000000u), (int)(b << 29));
  }
  return fabsf(r) < INFINITY;
}

template <bool WIDE, int K>
__device__ __forceinline__ bool tx_solve_terms(const double (&y)[K], double mx, const double (&sg)[K], double w,
                                               double (&x)[K]) {
  double e[K], s = 0.0;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    e[k] = exp2(y[k] - mx);
    s = fma(sg[k], e[k], s);
  }
  const double r = w / s;
#pragma unroll
  for (int k = 0; k < K; ++k) x[k] = e[k] * r;
  return fabs(r) < INFINITY;
}

// one sample's terms: u its K reduced potentials, w its weight e^{lsw - m}
// (1 without a log weight), c[j] candidate j's c_k (log2 units, less a
// constant), sg 1 for a sampled state and 0 for one with n_k = 0; adds (x,
// x x^T's upper triangle) of each of the nc candidates to acc.  The
// sample's reference is the largest exponent of all the states: the
// sampled ones' sum s >= 2^-126 unless a state with n_k = 0 outweighs them
// all by more.  bad[j] is set where a term of candidate j is not finite
template <bool WIDE, typename T, int K>
__device__ __forceinline__ void tx_solve_sample(const T (&u)[K], T w, const T (&c)[2][K], const T (&sg)[K],
                                                int nc, double (&acc)[2 * tx_solve_acc(K)], bool (&bad)[2]) {
  constexpr int A = tx_solve_acc(K);
  const T LOG2E = T(1.4426950408889634);
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    if (j < nc) {
      T y[K];
      T mx = -T(INFINITY);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        y[k] = tx_fma(-LOG2E, u[k], c[j][k]);
        mx = tx_max(mx, y[k]);
      }
      double x[K];
      bad[j] = !tx_solve_terms<WIDE, K>(y, mx, sg, w, x) || bad[j];
      int g = j * A + K;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        acc[j * A + k] += x[k];
#pragma unroll
        for (int l = k; l < K; ++l) {
          acc[g] = fma(x[k], x[l], acc[g]);
          ++g;
        }
      }
    }
  }
}

// Whether a group of samples u[k][v] needs the wide terms (float32 only): a
// bound on how far a state's exponent c_k - u_k log2 e can lie below the
// sample's largest, from the spread of the c_k (cs, both candidates') and
// of the sample's u_k.  NaN spreads give false, and their NaN terms.
template <typename T, int K, int V>
__device__ __forceinline__ bool tx_solve_wide(const T (&u)[K][V], T cs) {
  if constexpr (sizeof(T) == 8) return false;
  T spread = T(0);
#pragma unroll
  for (int v = 0; v < V; ++v) {
    T hi = u[0][v], lo = u[0][v];
#pragma unroll
    for (int k = 1; k < K; ++k) {
      hi = tx_max(hi, u[k][v]);
      lo = fminf(lo, u[k][v]);
    }
    spread = tx_max(spread, hi - lo);
  }
  return spread * T(1.4426950408889634) + cs > T(120);
}

// the block's fold of one row a thread of red (TX_SOLVE_CH columns), over
// segments of TX_SOLVE_CH rows and then the segments: the largest (MAX) or
// the sum of each column, in threads t < TX_SOLVE_CH.  Every thread calls
// it, after writing its row.
template <bool MAX>
__device__ double tx_solve_fold(const double* red, double* seg, int t) {
  constexpr int SEGS = TX_SOLVE_THREADS / TX_SOLVE_CH, ROWS = TX_SOLVE_CH;  // a thread a segment and column
  const double zero = MAX ? -(double)INFINITY : 0.0;
  __syncthreads();
  {
    const int j = t % TX_SOLVE_CH, sg = t / TX_SOLVE_CH;
    double v = zero;
    for (int r = 0; r < ROWS; ++r) {
      const double x = red[(sg * ROWS + r) * TX_SOLVE_CH + j];
      v = MAX ? fmax(v, x) : v + x;
    }
    seg[sg * TX_SOLVE_CH + j] = v;
  }
  __syncthreads();
  double v = zero;
  if (t < TX_SOLVE_CH)
    for (int sg = 0; sg < SEGS; ++sg) v = MAX ? fmax(v, seg[sg * TX_SOLVE_CH + t]) : v + seg[sg * TX_SOLVE_CH + t];
  return v;
}

template <typename T, int K>
__global__ void __launch_bounds__(TX_SOLVE_THREADS)
mbar_solve_kernel(const T* __restrict__ u_kn, const T* __restrict__ lsw, const T* __restrict__ cand,
                  double* __restrict__ part, long long N, int nc, int vec) {
  constexpr int A = tx_solve_acc(K);
  constexpr int V = tx_solve_vec<T, K>();
  const T LOG2E = T(1.4426950408889634);
  const T NEG_INF = -T(INFINITY);
  __shared__ double red[TX_SOLVE_THREADS * TX_SOLVE_CH];
  __shared__ double seg[TX_SOLVE_THREADS];

  T c[2][K], sg[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    c[0][k] = cand[k];
    c[1][k] = cand[K + k];
    sg[k] = cand[2 * K + k];
  }
  double acc[2 * A];
#pragma unroll
  for (int i = 0; i < 2 * A; ++i) acc[i] = 0.0;
  T m = lsw == nullptr ? T(0) : NEG_INF;  // the thread's shift, log2 units
  bool bad[2] = {false, false};

  // the spread of the candidates' c_k, for tx_solve_wide
  T cs = T(0);
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    T hi = c[j][0], lo = c[j][0];
#pragma unroll
    for (int k = 1; k < K; ++k) {
      hi = tx_max(hi, c[j][k]);
      lo = fminf(lo, c[j][k]);
    }
    if (j < nc) cs = tx_max(cs, hi - lo);
  }

  // one sample's weight against the shift (raised, and the sums rescaled,
  // where its log weight lies above it)
  auto weight = [&](T l) {
    if (lsw == nullptr) return T(1);
    const T l2 = l * LOG2E;
    if (l2 > m) {
      tx_solve_rescale<K>(acc, exp2((double)m - (double)l2));  // 0 while m is -inf
      m = l2;
    }
    return l2 == NEG_INF ? T(0) : tx_ex2(l2 - m);
  };

  const long long stride = (long long)gridDim.x * TX_SOLVE_THREADS;
  const long long t0 = (long long)blockIdx.x * TX_SOLVE_THREADS + threadIdx.x;
  long long n0 = 0;  // samples the 16-byte loop takes
  if constexpr (V > 1) {
    if (vec) {
      const long long ng = N / V;
      // the next group's loads are issued before this one's sums, so that
      // they are in flight while the thread computes
      T nu[K][V], nl[V];
      auto load = [&](long long gi) {
#pragma unroll
        for (int k = 0; k < K; ++k) tx_solve_load<T, V>(u_kn + (long long)k * N + gi * V, nu[k]);
        if (lsw != nullptr) tx_solve_load<T, V>(lsw + gi * V, nl);
      };
      if (t0 < ng) load(t0);
      for (long long gi = t0; gi < ng; gi += stride) {
        T uv[K][V], lv[V];
#pragma unroll
        for (int v = 0; v < V; ++v) {
#pragma unroll
          for (int k = 0; k < K; ++k) uv[k][v] = nu[k][v];
          lv[v] = lsw != nullptr ? nl[v] : T(0);
        }
        if (gi + stride < ng) load(gi + stride);
        const bool wide = tx_solve_wide<T, K, V>(uv, cs);
#pragma unroll
        for (int v = 0; v < V; ++v) {
          T u[K];
#pragma unroll
          for (int k = 0; k < K; ++k) u[k] = uv[k][v];
          const T w = weight(lv[v]);
          if (wide) {
            tx_solve_sample<true, T, K>(u, w, c, sg, nc, acc, bad);
          } else {
            tx_solve_sample<false, T, K>(u, w, c, sg, nc, acc, bad);
          }
        }
      }
      n0 = ng * V;
    }
  }
  for (long long n = n0 + t0; n < N; n += stride) {
    T u[K], u1[K][1];
#pragma unroll
    for (int k = 0; k < K; ++k) u[k] = u1[k][0] = u_kn[(long long)k * N + n];
    const T w = weight(lsw != nullptr ? lsw[n] : T(0));
    if (tx_solve_wide<T, K, 1>(u1, cs)) {
      tx_solve_sample<true, T, K>(u, w, c, sg, nc, acc, bad);
    } else {
      tx_solve_sample<false, T, K>(u, w, c, sg, nc, acc, bad);
    }
  }

  const int t = (int)threadIdx.x;
#pragma unroll
  for (int j = 0; j < 2; ++j)
    if (bad[j]) acc[j * A] = (double)NAN;  // the candidate's residual is NaN
  // the block's shift: its threads' largest, each thread's sums rescaled to it
  __shared__ double mbs;
  double mb = 0.0;
  if (lsw != nullptr) {
    red[t * TX_SOLVE_CH] = (double)m;
    const double v = tx_solve_fold<true>(red, seg, t);  // column 0's in thread 0
    if (t == 0) mbs = v;
    __syncthreads();
    mb = mbs;
    if ((double)m != mb) tx_solve_rescale<K>(acc, exp2((double)m - mb));  // 0 while m is -inf
  }
  // the block's sums, TX_SOLVE_CH at a time
  double* out = part + (long long)blockIdx.x * (2 * A + 1);
#pragma unroll
  for (int c0 = 0; c0 < 2 * A; c0 += TX_SOLVE_CH) {
#pragma unroll
    for (int i = 0; i < TX_SOLVE_CH; ++i)
      if (c0 + i < 2 * A) red[t * TX_SOLVE_CH + i] = acc[c0 + i];
    const double v = tx_solve_fold<false>(red, seg, t);
    if (t < TX_SOLVE_CH && c0 + t < 2 * A) out[c0 + t] = v;
  }
  if (t == 0) out[2 * A] = mb;
}

// Solve h x = g in place (n x n, partial pivoting); x is left in g.
__device__ void tx_solve_small(double (&h)[TX_SOLVE_MAX_K][TX_SOLVE_MAX_K], double (&g)[TX_SOLVE_MAX_K],
                               int n) {
  for (int c = 0; c < n; ++c) {
    int p = c;
    for (int r = c + 1; r < n; ++r)
      if (fabs(h[r][c]) > fabs(h[p][c])) p = r;
    if (p != c) {
      for (int j = 0; j < n; ++j) {
        const double x = h[c][j];
        h[c][j] = h[p][j];
        h[p][j] = x;
      }
      const double x = g[c];
      g[c] = g[p];
      g[p] = x;
    }
    for (int r = c + 1; r < n; ++r) {
      const double f = h[r][c] / h[c][c];
      for (int j = c; j < n; ++j) h[r][j] -= f * h[c][j];
      g[r] -= f * g[c];
    }
  }
  for (int c = n - 1; c >= 0; --c) {
    double x = g[c];
    for (int j = c + 1; j < n; ++j) x -= h[c][j] * g[j];
    g[c] = x / h[c][c];
  }
}

// nc = 0 starts a solve (candidate 0 is f = 0); nc = 1 folds the opening
// pass, nc = 2 an iteration's.  fc (2 K) holds the candidates' f in float64,
// cand (3 K) their c_k in log2 units (less a constant) and whether each
// state is sampled (1, or 0 where n_k = 0) for the main kernel; flags =
// {n_iter, go on}.
template <typename T>
__global__ void __launch_bounds__(TX_SOLVE_COMBINE)
mbar_solve_combine_kernel(const double* __restrict__ part, int nb, int K, int nc, const T* __restrict__ log_n_k,
                          double* __restrict__ fc, T* __restrict__ cand, T* __restrict__ f_out,
                          T* __restrict__ res_out, long long* __restrict__ flags, double tol,
                          long long max_iter) {
  constexpr int MK = TX_SOLVE_MAX_K;
  const double NEG_INF = -(double)INFINITY;
  __shared__ double red[TX_SOLVE_COMBINE];
  __shared__ double tot[2 * tx_solve_acc(MK)];
  const int t = (int)threadIdx.x;
  const int A = tx_solve_acc(K), at = 2 * A;
  double mx = 0.0;
  if (nc > 0) {
    // the largest block shift, then each sum over the blocks: G groups of
    // threads take every G-th block, then the groups are added
    mx = NEG_INF;
    for (int b = t; b < nb; b += TX_SOLVE_COMBINE) mx = fmax(mx, part[(long long)b * (at + 1) + at]);
    red[t] = mx;
    __syncthreads();
    for (int h = TX_SOLVE_COMBINE / 2; h > 0; h >>= 1) {
      if (t < h) red[t] = fmax(red[t], red[t + h]);
      __syncthreads();
    }
    mx = red[0];
    __syncthreads();
    const int G = TX_SOLVE_COMBINE / at, i = t % at, g = t / at;
    if (g < G) {
      const double pw = (i % A) < K ? 1.0 : 2.0;  // G's sums scale by the shift squared
      double v = 0.0;
#pragma unroll 4
      for (int b = g; b < nb; b += G) {
        const double* p = part + (long long)b * (at + 1);
        if (p[at] == mx) {
          v += p[i];
        } else if (p[at] > NEG_INF) {  // else the block dropped every sample
          v += p[i] * exp2(pw * (p[at] - mx));
        }
      }
      red[g * at + i] = v;
    }
    __syncthreads();
    if (t < at) {
      double v = 0.0;
      for (int gg = 0; gg < G; ++gg) v += red[gg * at + t];
      tot[t] = v;
    }
    __syncthreads();
  }
  if (t != 0) return;

  // n_k, and nu_k: n_k for a sampled state, 1 for one with n_k = 0 (whose
  // sums are of W itself)
  double lnk[MK], nk[MK], nu[MK], f[MK];
  for (int k = 0; k < K; ++k) {
    lnk[k] = (double)log_n_k[k];
    nk[k] = exp(lnk[k]);
    nu[k] = lnk[k] == NEG_INF ? 1.0 : nk[k];
    f[k] = 0.0;
  }
  // the kept candidate's sums: S = x / nu, G = y / (nu nu^T), and log2 x
  double xk[MK], yk[MK][MK], lx[MK];
  if (nc > 0) {
    // each candidate's residual max |S_k - 1| (NaN wins, as torch's amax)
    double res[2] = {0.0, 0.0};
    for (int j = 0; j < nc; ++j)
      for (int k = 0; k < K; ++k) {
        const double d = fabs(tot[j * A + k] * exp2(mx) / nu[k] - 1.0);
        if (d > res[j] || d != d) res[j] = d;
      }
    const int w = (nc == 2 && res[1] - res[1] == 0.0 && res[1] < res[0]) ? 1 : 0;  // finite and smaller
    const long long it = flags[0] + (nc == 2 ? 1 : 0);
    flags[0] = it;
    flags[1] = (res[w] > tol && it < max_iter) ? 1 : 0;
    *res_out = (T)res[w];
    for (int k = 0; k < K; ++k) {
      f[k] = fc[w * K + k];
      f_out[k] = (T)f[k];
      xk[k] = tot[w * A + k] * exp2(mx);
      lx[k] = log2(tot[w * A + k]) + mx;
    }
    for (int k = 0, g = w * A + K; k < K; ++k)
      for (int l = k; l < K; ++l, ++g) yk[k][l] = yk[l][k] = tot[g] * exp2(2.0 * mx);
  } else {
    flags[0] = 0;
    flags[1] = 0;
  }

  // the next pair: the self-consistent candidate f - log S and the Newton
  // step on f[1:], both gauge-fixed.  With rho_k = n_k / nu_k (1 for a
  // sampled state, else 0) the gradient n (S - 1) is rho x - n and the
  // Hessian diag(n S) - n n^T G is diag(rho x) - rho rho^T y: no quotient
  // of the sums is taken (disconnected states give a Hessian of exactly 0)
  double g[MK];
  if (nc > 0) {
    double h[MK][MK], tr = 0.0;
    const int n = K - 1;
    for (int i = 0; i < n; ++i) {
      const double ri = nk[i + 1] / nu[i + 1];
      for (int j = 0; j < n; ++j) h[i][j] = (i == j ? ri * xk[i + 1] : 0.0) - ri * (nk[j + 1] / nu[j + 1]) * yk[i + 1][j + 1];
      g[i] = ri * xk[i + 1] - nk[i + 1];
      tr += h[i][i];
    }
    for (int i = 0; i < n; ++i) h[i][i] += 1e-10 * tr / n;
    tx_solve_small(h, g, n);
  }
  const double LOG2E = 1.4426950408889634, LN2 = 0.6931471805599453;
  for (int j = 0; j < 2; ++j) {
    double fj[MK];
    for (int k = 0; k < K; ++k) {
      if (nc == 0) {
        fj[k] = 0.0;
      } else if (j == 0) {
        fj[k] = f[k] - (lx[k] * LN2 - log(nu[k]));  // f - log S, S in log form (it may underflow)
      } else {
        fj[k] = k == 0 ? f[0] : f[k] - g[k - 1];
      }
    }
    for (int k = K - 1; k >= 0; --k) fj[k] -= fj[0];
    // c_k = (f_k + log n_k) log2 e, less their largest over the sampled
    // states (the weights do not see a shift common to every c_k)
    double cj[MK], top = NEG_INF;
    for (int k = 0; k < K; ++k) {
      cj[k] = (fj[k] + (lnk[k] == NEG_INF ? 0.0 : lnk[k])) * LOG2E;
      if (lnk[k] > NEG_INF) top = fmax(top, cj[k]);
    }
    if (top - top != 0.0) top = 0.0;  // no sampled state, or an infinite c
    for (int k = 0; k < K; ++k) {
      fc[j * K + k] = fj[k];
      cand[j * K + k] = (T)(cj[k] - top);
    }
  }
  if (nc == 0)
    for (int k = 0; k < K; ++k) cand[2 * K + k] = lnk[k] == NEG_INF ? T(0) : T(1);
}

template <typename T, int K>
int launch_solve(const T* u_kn, const T* lsw, const T* log_n_k, T* cand, double* fc, double* part, T* f_out,
                 T* res_out, long long* flags, long long N, int nb, int first, double tol, long long max_iter,
                 cudaStream_t s) {
  constexpr int V = tx_solve_vec<T, K>();
  const int vec = N % V == 0 && (uintptr_t)u_kn % 16 == 0 && (lsw == nullptr || (uintptr_t)lsw % 16 == 0);
  const int nc = first ? 1 : 2;
  if (first) {
    mbar_solve_combine_kernel<T><<<1, TX_SOLVE_COMBINE, 0, s>>>(part, nb, K, 0, log_n_k, fc, cand, f_out,
                                                                 res_out, flags, tol, max_iter);
  }
  mbar_solve_kernel<T, K><<<(unsigned)nb, TX_SOLVE_THREADS, 0, s>>>(u_kn, lsw, cand, part, N, nc, vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  mbar_solve_combine_kernel<T><<<1, TX_SOLVE_COMBINE, 0, s>>>(part, nb, K, nc, log_n_k, fc, cand, f_out,
                                                               res_out, flags, tol, max_iter);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_solve_k(const T* u_kn, const T* lsw, const T* log_n_k, T* cand, double* fc, double* part, T* f_out,
                   T* res_out, long long* flags, long long N, int K, int nb, int first, double tol,
                   long long max_iter, cudaStream_t s) {
  switch (K) {
#define TX_SOLVE_CASE(KK)                                                                             \
  case KK:                                                                                            \
    return launch_solve<T, KK>(u_kn, lsw, log_n_k, cand, fc, part, f_out, res_out, flags, N, nb, first, \
                               tol, max_iter, s);
    TX_SOLVE_CASE(2)
    TX_SOLVE_CASE(3)
    TX_SOLVE_CASE(4)
    TX_SOLVE_CASE(5)
    TX_SOLVE_CASE(6)
    TX_SOLVE_CASE(7)
    TX_SOLVE_CASE(8)
#undef TX_SOLVE_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int solve_resident_blocks(int K, int device, int* blocks) {
  int sms = 0, per = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  switch (K) {
#define TX_SOLVE_CASE(KK)                                                                                   \
  case KK:                                                                                                  \
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, mbar_solve_kernel<T, KK>, TX_SOLVE_THREADS, 0); \
    break;
    TX_SOLVE_CASE(2)
    TX_SOLVE_CASE(3)
    TX_SOLVE_CASE(4)
    TX_SOLVE_CASE(5)
    TX_SOLVE_CASE(6)
    TX_SOLVE_CASE(7)
    TX_SOLVE_CASE(8)
#undef TX_SOLVE_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
  *blocks = per * sms;
  return (int)err;
}

}  // namespace

extern "C" {

// The main kernel's resident blocks on the card for K states of float64
// (is_double != 0) or float32: the size of its persistent grid.  Writes
// blocks; returns the status.
int tx_mbar_solve_blocks(int K, int is_double, int device, int* blocks) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return is_double ? solve_resident_blocks<double>(K, device, blocks)
                   : solve_resident_blocks<float>(K, device, blocks);
}

// One pass of the solve.  u_kn (K, N) contiguous, lsw (N,) or null, log_n_k
// (K,), cand (3 K) and the outputs f_out (K,), res_out (1) of one type
// (is_double != 0: float64, else float32); fc (2 K) and part (nb (2 (K +
// K (K + 1) / 2) + 1)) float64 scratch, flags (2) int64.  first != 0 starts
// the solve at f = 0 and evaluates it; else the pass evaluates the two
// candidates the last one built.  2 <= K <= 8.  Returns the launch status.
int tx_mbar_solve(const void* u_kn, const void* lsw, const void* log_n_k, void* cand, void* fc, void* part,
                  void* f_out, void* res_out, void* flags, long long N, int K, int nb, int first, double tol,
                  long long max_iter, int is_double, int device, void* stream) {
  if (N < 1 || K < 2 || K > TX_SOLVE_MAX_K || nb < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_double) {
    return launch_solve_k<double>((const double*)u_kn, (const double*)lsw, (const double*)log_n_k,
                                  (double*)cand, (double*)fc, (double*)part, (double*)f_out,
                                  (double*)res_out, (long long*)flags, N, K, nb, first, tol, max_iter, s);
  }
  return launch_solve_k<float>((const float*)u_kn, (const float*)lsw, (const float*)log_n_k, (float*)cand,
                               (double*)fc, (double*)part, (float*)f_out, (float*)res_out,
                               (long long*)flags, N, K, nb, first, tol, max_iter, s);
}

}  // extern "C"
