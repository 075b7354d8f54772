// The count sources of the bootstrap kernels: the Poisson(1) counts drawn
// inside K3, K5 and K8, and the materialized tables of K2 and K7.
//
// Counter layout (K8 must reuse it): the count of replicate r at global
// sample index j is word (j & 3) of
//   Philox4x32-10(counter = {(j >> 2) mod 2^32, r, (j >> 34) mod 2^32, 0},
//                 key     = {seed mod 2^32, (seed >> 32) mod 2^32})
// mapped to #{q : word > thresholds[q]} over the 9 truncated Poisson(1) CDF
// cutoffs.  The counts are a pure function of (seed, r, j): they do not
// depend on the launch shape, and adjacent seeds are different keys, so
// their streams do not alias.  K5 draws by the same schedule and never
// reads a batch-row index into it: every batch row of a replicate sees the
// same count at sample j, and K5 on one row shares K3's counts at equal seed.
#pragma once

#include "common.cuh"

namespace {

struct PoissonThresholds {
  uint32_t t[9];
};

__device__ __forceinline__ void philox4x32_10(uint32_t c[4], uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    if (i > 0) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t lo0 = 0xD2511F53u * c[0];
    const uint32_t hi0 = __umulhi(0xD2511F53u, c[0]);
    const uint32_t lo1 = 0xCD9E8D57u * c[2];
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c[2]);
    const uint32_t n0 = hi1 ^ c[1] ^ k0;
    const uint32_t n2 = hi0 ^ c[3] ^ k1;
    c[0] = n0;
    c[1] = lo1;
    c[2] = n2;
    c[3] = lo0;
  }
}

// Every count source gives the counts of one replicate for the 4 samples
// j .. j+3 (j a multiple of 4) in two steps, so that a kernel can put work
// between them: fetch(r, j) issues whatever global loads the counts need and
// returns them raw, expand(raw, r, j, f) turns them into float32 counts, zero
// from sample R on; keep(raw) pins what was fetched (tx_keep).  load4 is
// fetch and expand in one.

// Poisson(1) counts drawn from the Philox schedule above: nothing to fetch,
// the draw is the expansion
struct PoissonCounts {
  struct Raw {};
  uint32_t k0, k1;
  PoissonThresholds th;
  long long R;
  __device__ __forceinline__ Raw fetch(int, long long) const { return Raw(); }
  static __device__ __forceinline__ void keep(Raw&) {}
  __device__ __forceinline__ void expand(Raw, int r, long long j, float f[4]) const {
    uint32_t c[4] = {(uint32_t)(j >> 2), (uint32_t)r, (uint32_t)(j >> 34), 0u};
    philox4x32_10(c, k0, k1);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      int n = 0;
#pragma unroll
      for (int t = 0; t < 9; ++t) n += (c[q] > th.t[t]) ? 1 : 0;
      f[q] = (j + q < R) ? (float)n : 0.f;
    }
  }
  __device__ __forceinline__ void load4(int r, long long j, float f[4]) const {
    expand(Raw(), r, j, f);
  }
};

// the integer vector that holds 4 table entries of BYTES / 4 bytes each
template <int BYTES>
struct TableWord;
template <>
struct TableWord<4> {
  using type = unsigned int;
};
template <>
struct TableWord<8> {
  using type = uint2;
};
template <>
struct TableWord<16> {
  using type = uint4;
};

// counts of one replicate loaded from a materialized (nrep, R) table, for the
// 4 samples j .. j+3.  One vector load (16 bytes for int32 / float32, 8 for
// int16 / bfloat16, 4 for int8) where the 4 entries lie inside the row and
// their address is aligned to it; entry by entry otherwise (a row length that
// is no multiple of 4, a table that starts at an odd offset, the row's end),
// with zero bits past the row's end.  The values are the same either way, so
// the sums keep their bits.
template <typename F>
struct TableCounts {
  using Raw = typename TableWord<4 * sizeof(F)>::type;
  const F* freq;
  long long R;
  __device__ __forceinline__ Raw fetch(int r, long long j) const {
    const F* p = freq + (long long)r * R + j;
    if (j + 3 < R && (reinterpret_cast<uintptr_t>(p) & (sizeof(Raw) - 1)) == 0) {
      return *reinterpret_cast<const Raw*>(p);
    }
    F v[4];
    memset(v, 0, sizeof(Raw));
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (j + q < R) v[q] = p[q];
    }
    Raw raw;
    memcpy(&raw, v, sizeof(Raw));
    return raw;
  }
  static __device__ __forceinline__ void keep(Raw& raw) { tx_keep(raw); }
  __device__ __forceinline__ void expand(Raw raw, int, long long, float f[4]) const {
    F v[4];
    memcpy(v, &raw, sizeof(Raw));
#pragma unroll
    for (int q = 0; q < 4; ++q) f[q] = tx_to_float(v[q]);
  }
  __device__ __forceinline__ void load4(int r, long long j, float f[4]) const {
    expand(fetch(r, j), r, j, f);
  }
};

inline PoissonCounts make_poisson(long long seed, const unsigned int* thresholds, long long R) {
  PoissonCounts pc;
  pc.k0 = (uint32_t)((unsigned long long)seed & 0xffffffffull);
  pc.k1 = (uint32_t)(((unsigned long long)seed >> 32) & 0xffffffffull);
  for (int t = 0; t < 9; ++t) pc.th.t[t] = thresholds[t];
  pc.R = R;
  return pc;
}

}  // namespace
