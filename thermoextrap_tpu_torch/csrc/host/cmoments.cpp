// Native (host CPU) central/raw comoment kernels.
//
// This is the compiled-CPU role that cmomy's numba kernels play for the
// reference package (usage tally in the reference's src/thermoextrap/
// data.py:455-536, 1632-1640, 1750-1813): constructor-time and host-side
// moment reductions over raw sample streams, without JAX dispatch/trace
// overhead.  The TPU keeps the accelerated path (ops/moments_pallas.py);
// this engine serves eager host workflows (numpy trajectories, f64
// ingest, CPU-only deployments) at compiled-loop speed.
//
// All reductions are *two-pass* over exactly-centered samples (central
// moments are shift invariant), matching ops/moments.py semantics:
//   du[n]   = <w (u-uave)^n> / <w>        with du[0]=1, du[1]=0 exact
//   dxdu[n] = <w (x-xave)(u-uave)^n> / <w> with dxdu[0]=0 exact
//
// C ABI (driven from Python via ctypes); all return 0 on success:
//   cm_reduce_central        flat (R,) x (R,V) reduction
//   cm_reduce_central_batched  (B,R) x (B,R,V) grids (lnPi macrostates)
//   cm_reduce_raw            raw comoments u[n]=<w u^n>/<w>, xu[n]=<w x u^n>/<w>
//   cm_resample_central      freq-table bootstrap: per-replicate central
//                            comoments with weight freq[rep,r]*w[r]
//
// Layout: row-major everywhere; moment order is the LEADING axis of the
// Python-visible outputs — the ctypes wrapper passes buffers shaped so the
// natural C loops write (n, ...) directly (see native/__init__.py).

#include <cstddef>
#include <cstdint>
#include <limits>
#include <vector>

using std::size_t;

namespace {

// Accumulation is BLOCKED: per-chunk partial sums are folded into the
// global accumulators every kChunk samples, keeping the sequential-sum
// roundoff at ~sqrt(R/kChunk) ulps instead of O(R) — numerically on par
// with numpy's pairwise summation at R ~ 1e8 (gated in tests/bench).
constexpr int64_t kChunk = 16384;

// Pass 1: weighted means.  Returns wsum.
static double weighted_means(const double* uv, const double* xv,
                             const double* w, int64_t R, int64_t V,
                             double* uave, double* xave) {
    double wsum = 0.0, usum = 0.0;
    std::vector<double> xsum(static_cast<size_t>(V), 0.0);
    std::vector<double> xloc(static_cast<size_t>(V));
    for (int64_t r0 = 0; r0 < R; r0 += kChunk) {
        const int64_t r1 = (r0 + kChunk < R) ? r0 + kChunk : R;
        double wl = 0.0, ul = 0.0;
        for (int64_t v = 0; v < V; ++v) xloc[static_cast<size_t>(v)] = 0.0;
        if (w) {
            for (int64_t r = r0; r < r1; ++r) {
                const double p = w[r];
                wl += p;
                ul += p * uv[r];
                const double* xr = xv + r * V;
                for (int64_t v = 0; v < V; ++v) xloc[static_cast<size_t>(v)] += p * xr[v];
            }
        } else {
            for (int64_t r = r0; r < r1; ++r) {
                ul += uv[r];
                const double* xr = xv + r * V;
                for (int64_t v = 0; v < V; ++v) xloc[static_cast<size_t>(v)] += xr[v];
            }
            wl = static_cast<double>(r1 - r0);
        }
        wsum += wl;
        usum += ul;
        for (int64_t v = 0; v < V; ++v) xsum[static_cast<size_t>(v)] += xloc[static_cast<size_t>(v)];
    }
    const double inv = 1.0 / wsum;
    *uave = usum * inv;
    for (int64_t v = 0; v < V; ++v) xave[v] = xsum[static_cast<size_t>(v)] * inv;
    return wsum;
}

// Pass 2 for the flat central reduction; accumulators are zero-initialised
// by the caller.  du has order+1 slots, dxdu has (order+1)*V (n-major).
static void central_accumulate(const double* uv, const double* xv,
                               const double* w, int64_t R, int64_t V,
                               int64_t order, double uave,
                               const double* xave, double* du,
                               double* dxdu) {
    const int64_t N = order + 1;
    std::vector<double> ldu(static_cast<size_t>(N));
    std::vector<double> ldx(static_cast<size_t>(N * V));
    std::vector<double> dx(static_cast<size_t>(V));
    const double xa = xave[0];
    for (int64_t r0 = 0; r0 < R; r0 += kChunk) {
        const int64_t r1 = (r0 + kChunk < R) ? r0 + kChunk : R;
        for (int64_t n = 0; n < N; ++n) ldu[static_cast<size_t>(n)] = 0.0;
        for (int64_t i = 0; i < N * V; ++i) ldx[static_cast<size_t>(i)] = 0.0;
        if (V == 1) {
            // scalar-observable fast path: straight-line body, no inner
            // loops over v, so the chunk accumulators stay in registers.
            for (int64_t r = r0; r < r1; ++r) {
                const double p = w ? w[r] : 1.0;
                const double d = uv[r] - uave;
                const double dxr = p * (xv[r] - xa);
                double pn = p;   // p * d^n
                double dn = dxr; // p * dx * d^n
                for (int64_t n = 0; n < N; ++n) {
                    ldu[static_cast<size_t>(n)] += pn;
                    ldx[static_cast<size_t>(n)] += dn;
                    pn *= d;
                    dn *= d;
                }
            }
        } else {
            // general case: power ladder per sample, vectorised over v.
            for (int64_t r = r0; r < r1; ++r) {
                const double p = w ? w[r] : 1.0;
                const double d = uv[r] - uave;
                const double* xr = xv + r * V;
                for (int64_t v = 0; v < V; ++v)
                    dx[static_cast<size_t>(v)] = xr[v] - xave[v];
                double pn = p;
                for (int64_t n = 0; n < N; ++n) {
                    ldu[static_cast<size_t>(n)] += pn;
                    double* out = ldx.data() + n * V;
                    for (int64_t v = 0; v < V; ++v)
                        out[v] += pn * dx[static_cast<size_t>(v)];
                    pn *= d;
                }
            }
        }
        for (int64_t n = 0; n < N; ++n) du[n] += ldu[static_cast<size_t>(n)];
        for (int64_t i = 0; i < N * V; ++i) dxdu[i] += ldx[static_cast<size_t>(i)];
    }
}

// Shared epilogue: normalise and pin the exact conventions.
static void central_finalize(int64_t V, int64_t order, double wsum,
                             double* du, double* dxdu) {
    const int64_t N = order + 1;
    const double inv = 1.0 / wsum;
    for (int64_t n = 0; n < N; ++n) du[n] *= inv;
    for (int64_t i = 0; i < N * V; ++i) dxdu[i] *= inv;
    du[0] = 1.0;
    if (order >= 1) du[1] = 0.0;
    for (int64_t v = 0; v < V; ++v) dxdu[v] = 0.0;
}

static int reduce_central_one(const double* uv, const double* xv,
                              const double* w, int64_t R, int64_t V,
                              int64_t order, double* uave, double* xave,
                              double* du, double* dxdu) {
    const int64_t N = order + 1;
    for (int64_t n = 0; n < N; ++n) du[n] = 0.0;
    for (int64_t i = 0; i < N * V; ++i) dxdu[i] = 0.0;
    const double wsum = weighted_means(uv, xv, w, R, V, uave, xave);
    if (!(wsum > 0.0)) return -2;  // empty / zero-weight stream
    central_accumulate(uv, xv, w, R, V, order, *uave, xave, du, dxdu);
    central_finalize(V, order, wsum, du, dxdu);
    return 0;
}

// Zero-total-weight convention of the XLA path (0/0): NaN everywhere.
// Used by the flat/batched entries so `set_impl("native")` is a true
// drop-in — the XLA two-pass emits NaN for a zero-weight (batch row's)
// stream rather than raising.
static void fill_nan_one(int64_t V, int64_t order, double* uave,
                         double* xave, double* du, double* dxdu) {
    const double nan = std::numeric_limits<double>::quiet_NaN();
    const int64_t N = order + 1;
    *uave = nan;
    for (int64_t v = 0; v < V; ++v) xave[v] = nan;
    // du[0]/du[1]/dxdu[0] are pinned exactly by the XLA path even for a
    // zero-weight stream (the .at[].set() epilogue, ops/moments.py:146-147)
    du[0] = 1.0;
    if (order >= 1) du[1] = 0.0;
    for (int64_t n = 2; n < N; ++n) du[n] = nan;
    for (int64_t v = 0; v < V; ++v) dxdu[v] = 0.0;
    for (int64_t i = V; i < N * V; ++i) dxdu[i] = nan;
}

}  // namespace

extern "C" {

// Flat reduction.  uv (R,), xv (R,V), w (R,) or NULL.
// Outputs: uave (1,), xave (V,), du (order+1,), dxdu (order+1, V).
int cm_reduce_central(const double* uv, const double* xv, const double* w,
                      int64_t R, int64_t V, int64_t order, double* uave,
                      double* xave, double* du, double* dxdu) {
    if (R <= 0 || V <= 0 || order < 0) return -1;
    int rc = reduce_central_one(uv, xv, w, R, V, order, uave, xave, du, dxdu);
    if (rc == -2) {  // zero total weight: NaN like the XLA 0/0 path
        fill_nan_one(V, order, uave, xave, du, dxdu);
        return 0;
    }
    return rc;
}

// Batched reduction over B independent grids (lnPi macrostate layout).
// uv (B,R), xv (B,R,V), w (B,R) or NULL.
// Outputs: uave (B,), xave (B,V), du (B, order+1), dxdu (B, order+1, V)
// — batch-major here; the Python wrapper moves the moment axis to front.
int cm_reduce_central_batched(const double* uv, const double* xv,
                              const double* w, int64_t B, int64_t R,
                              int64_t V, int64_t order, double* uave,
                              double* xave, double* du, double* dxdu) {
    if (B <= 0 || R <= 0 || V <= 0 || order < 0) return -1;
    const int64_t N = order + 1;
    for (int64_t b = 0; b < B; ++b) {
        int rc = reduce_central_one(
            uv + b * R, xv + b * R * V, w ? w + b * R : nullptr, R, V, order,
            uave + b, xave + b * V, du + b * N, dxdu + b * N * V);
        if (rc == -2) {  // zero-weight row (e.g. unvisited macrostate bin):
            // NaN that row only, like the XLA path; keep reducing the rest
            fill_nan_one(V, order, uave + b, xave + b * V, du + b * N,
                         dxdu + b * N * V);
        } else if (rc) {
            return rc;
        }
    }
    return 0;
}

// Raw comoments (single pass): u[n] = <w u^n>/<w>, xu[n] = <w x u^n>/<w>.
// Outputs: u (order+1,), xu (order+1, V).
int cm_reduce_raw(const double* uv, const double* xv, const double* w,
                  int64_t R, int64_t V, int64_t order, double* u,
                  double* xu) {
    if (R <= 0 || V <= 0 || order < 0) return -1;
    const int64_t N = order + 1;
    for (int64_t n = 0; n < N; ++n) u[n] = 0.0;
    for (int64_t i = 0; i < N * V; ++i) xu[i] = 0.0;
    double wsum = 0.0;
    std::vector<double> lu(static_cast<size_t>(N));
    std::vector<double> lxu(static_cast<size_t>(N * V));
    for (int64_t r0 = 0; r0 < R; r0 += kChunk) {  // blocked like the central path
        const int64_t r1 = (r0 + kChunk < R) ? r0 + kChunk : R;
        double wl = 0.0;
        for (int64_t n = 0; n < N; ++n) lu[static_cast<size_t>(n)] = 0.0;
        for (int64_t i = 0; i < N * V; ++i) lxu[static_cast<size_t>(i)] = 0.0;
        for (int64_t r = r0; r < r1; ++r) {
            const double p = w ? w[r] : 1.0;
            const double ur = uv[r];
            const double* xr = xv + r * V;
            wl += p;
            double pn = p;
            for (int64_t n = 0; n < N; ++n) {
                lu[static_cast<size_t>(n)] += pn;
                double* out = lxu.data() + n * V;
                for (int64_t v = 0; v < V; ++v) out[v] += pn * xr[v];
                pn *= ur;
            }
        }
        wsum += wl;
        for (int64_t n = 0; n < N; ++n) u[n] += lu[static_cast<size_t>(n)];
        for (int64_t i = 0; i < N * V; ++i) xu[i] += lxu[static_cast<size_t>(i)];
    }
    if (!(wsum > 0.0)) {  // XLA raw path has no pinning: NaN everywhere
        const double nan = std::numeric_limits<double>::quiet_NaN();
        for (int64_t n = 0; n < N; ++n) u[n] = nan;
        for (int64_t i = 0; i < N * V; ++i) xu[i] = nan;
        return 0;
    }
    const double inv = 1.0 / wsum;
    for (int64_t n = 0; n < N; ++n) u[n] *= inv;
    for (int64_t i = 0; i < N * V; ++i) xu[i] *= inv;
    return 0;
}

// Freq-table bootstrap: replicate weights freq[rep, r] * w[r], exact
// two-pass central reduction per replicate (host role of
// ops/resample.resample_central_comoments; reference wrap_resample_vals,
// the reference's src/thermoextrap/data.py:1750-1813).
// freq (nrep, R) float64; outputs per-replicate, rep-major:
//   uave (nrep,), xave (nrep,V), du (nrep, order+1), dxdu (nrep, order+1, V).
int cm_resample_central(const double* uv, const double* xv, const double* w,
                        const double* freq, int64_t nrep, int64_t R,
                        int64_t V, int64_t order, double* uave, double* xave,
                        double* du, double* dxdu) {
    if (nrep <= 0 || R <= 0 || V <= 0 || order < 0) return -1;
    const int64_t N = order + 1;
    // global weighted means: the degenerate stand-in for an all-zero
    // replicate row (possible with Poisson frequency tables), matching the
    // XLA path's safe-divide convention (ops/resample.py:107-119).
    double ubar;
    std::vector<double> xbar(static_cast<size_t>(V));
    const double wtot = weighted_means(uv, xv, w, R, V, &ubar, xbar.data());
    // zero GLOBAL weight: the XLA path's 0/0 means poison every replicate
    // (NaN everywhere except the pinned du[0]/du[1]/dxdu[0] trivia) — use
    // the same fill_nan_one pattern as the reduce entries, NOT the finite
    // trivial moments of a single degenerate replicate
    const bool global_zero = !(wtot > 0.0);
    std::vector<double> wrep(static_cast<size_t>(R));
    for (int64_t rep = 0; rep < nrep; ++rep) {
        const double* f = freq + rep * R;
        if (w) {
            for (int64_t r = 0; r < R; ++r)
                wrep[static_cast<size_t>(r)] = f[r] * w[r];
        } else {
            for (int64_t r = 0; r < R; ++r) wrep[static_cast<size_t>(r)] = f[r];
        }
        int rc = reduce_central_one(uv, xv, wrep.data(), R, V, order,
                                    uave + rep, xave + rep * V, du + rep * N,
                                    dxdu + rep * N * V);
        if (rc == -2) {
            if (global_zero) {
                fill_nan_one(V, order, uave + rep, xave + rep * V,
                             du + rep * N, dxdu + rep * N * V);
                continue;
            }
            // degenerate replicate (all-zero freq row with a live stream):
            // global means, trivial central moments (XLA safe-divide
            // stand-in, ops/resample.py:107-119)
            uave[rep] = ubar;
            for (int64_t v = 0; v < V; ++v) xave[rep * V + v] = xbar[static_cast<size_t>(v)];
            double* du_r = du + rep * N;
            double* dx_r = dxdu + rep * N * V;
            du_r[0] = 1.0;
            for (int64_t n = 1; n < N; ++n) du_r[n] = 0.0;
            for (int64_t i = 0; i < N * V; ++i) dx_r[i] = 0.0;
        } else if (rc) {
            return rc;
        }
    }
    return 0;
}

}  // extern "C"
