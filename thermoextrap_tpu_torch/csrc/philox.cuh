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
//
// What the draw costs on the H100, and what this file does about it (the
// draw bounds K3, K5 on one row and K8; PERF.md has the measurements):
//   - the 10 round keys depend on the seed alone, so the host computes them
//     (make_poisson) and each round's XORs take theirs from the kernel's
//     parameters: a round is 2 wide multiplies and 2 three-input XORs;
//   - the word -> count map is one lookup in place of 9 compares: the
//     number L of leading one bits of the word picks a level, and each level
//     holds at most one threshold (the thresholds lie at L = 0, 1, 3, 5, 8,
//     10, 13, 16, 19), so count = base[L] + (word > threshold[L]).  The 33
//     levels (base as a float, so no conversion follows) sit in shared
//     memory, 8 bytes each: the levels a warp reads lie in distinct banks
//     unless two of its words have L and L + 16 leading ones (p < 2^-16).
//     It gives #{q : word > thresholds[q]} for every word (chip_smoke.py
//     checks all 2^32 words against the 9-compare sum).
#pragma once

#include "common.cuh"

#define TX_POISSON_NT 9          // Poisson(1) thresholds
#define TX_POISSON_LEVELS 33     // leading-one counts 0 .. 32 of a 32-bit word

namespace {

// the word -> count levels of the running block (PoissonCounts::init); the
// level of the words with L leading one bits is entry 32 - L, the position
// of the word's highest zero bit plus one
__shared__ uint2 tx_poisson_levels[TX_POISSON_LEVELS];

struct PhiloxKeys {
  uint32_t k0[10], k1[10];  // round i's key
};

__device__ __forceinline__ void philox4x32_10(uint32_t c[4], const PhiloxKeys& key) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const uint32_t lo0 = 0xD2511F53u * c[0];
    const uint32_t hi0 = __umulhi(0xD2511F53u, c[0]);
    const uint32_t lo1 = 0xCD9E8D57u * c[2];
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c[2]);
    const uint32_t n0 = hi1 ^ c[1] ^ key.k0[i];
    const uint32_t n2 = hi0 ^ c[3] ^ key.k1[i];
    c[0] = n0;
    c[1] = lo1;
    c[2] = n2;
    c[3] = lo0;
  }
}

// #{q : word > t[q]}: the count's definition, the map's parity reference
__device__ __forceinline__ int poisson_compare_count(uint32_t word, const uint32_t (&t)[TX_POISSON_NT]) {
  int n = 0;
#pragma unroll
  for (int q = 0; q < TX_POISSON_NT; ++q) n += (word > t[q]) ? 1 : 0;
  return n;
}

// the position of the highest set bit of v, -1 for v = 0: one FLO (PTX
// bfind; 31 - __clz(v) would cost two more additions per count)
__device__ __forceinline__ int tx_highest_bit(uint32_t v) {
#ifdef __CUDA_ARCH__
  int b;
  asm("bfind.u32 %0, %1;" : "=r"(b) : "r"(v));
  return b;
#else
  return v ? 31 - __builtin_clz(v) : -1;
#endif
}

// the count of a word by its level (tx_poisson_levels must be filled), as a
// float
__device__ __forceinline__ float poisson_level_count(uint32_t word) {
  const uint2 lv = tx_poisson_levels[tx_highest_bit(~word) + 1];
  return __uint_as_float(lv.y) + ((word > lv.x) ? 1.f : 0.f);
}

// Every count source gives the counts of one replicate for the 4 samples
// j .. j+3 (j a multiple of 4) in two steps, so that a kernel can put work
// between them: fetch(r, j) issues whatever global loads the counts need and
// returns them raw, expand(raw, r, j, f) turns them into float32 counts;
// keep(raw) pins what was fetched (tx_keep).  load4 is fetch and expand in
// one.  Counts from sample R on are finite and otherwise unspecified (a
// table's are 0, a draw's are drawn): the kernels' rows are zero there.
// init() is called by every thread of a block before the block's first
// __syncthreads, and expand only after it.

// Poisson(1) counts drawn from the Philox schedule above: nothing to fetch,
// the draw is the expansion
struct PoissonCounts {
  struct Raw {};
  PhiloxKeys key;
  uint2 levels[TX_POISSON_LEVELS];  // (threshold in the level or ~0, bits of the base count)
  __device__ __forceinline__ void init() const {
    for (int i = threadIdx.x; i < TX_POISSON_LEVELS; i += blockDim.x) tx_poisson_levels[i] = levels[i];
  }
  __device__ __forceinline__ Raw fetch(int, long long) const { return Raw(); }
  static __device__ __forceinline__ void keep(Raw&) {}
  __device__ __forceinline__ void expand(Raw, int r, long long j, float f[4]) const {
    uint32_t c[4] = {(uint32_t)(j >> 2), (uint32_t)r, (uint32_t)(j >> 34), 0u};
    philox4x32_10(c, key);
#pragma unroll
    for (int q = 0; q < 4; ++q) f[q] = poisson_level_count(c[q]);
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
  __device__ __forceinline__ void init() const {}
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

// The draw's parameters for a seed: the 10 round keys, and the level table
// of the thresholds.  A word with L leading ones (L < 32) lies in [lo, lo +
// 2^(31 - L) - 1] with lo = 2^32 - 2^(32 - L) (L = 32: the word ~0): every
// threshold below lo is exceeded (the base), none at or above the level's
// last word is, and one in between is compared.  False if a level holds two
// thresholds (the map would not be exact).
inline bool make_poisson(long long seed, const unsigned int* thresholds, PoissonCounts* pc) {
  uint32_t k0 = (uint32_t)((unsigned long long)seed & 0xffffffffull);
  uint32_t k1 = (uint32_t)(((unsigned long long)seed >> 32) & 0xffffffffull);
  for (int i = 0; i < 10; ++i) {
    pc->key.k0[i] = k0;
    pc->key.k1[i] = k1;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  for (int L = 0; L < TX_POISSON_LEVELS; ++L) {
    const unsigned long long lo = (1ull << 32) - (1ull << (32 - L));
    const unsigned long long last = (L == 32) ? lo : lo + (1ull << (31 - L)) - 1;
    int base = 0;
    int inside = 0;
    uint32_t thr = 0xffffffffu;  // no word exceeds it
    for (int q = 0; q < TX_POISSON_NT; ++q) {
      const unsigned long long t = thresholds[q];
      if (t < lo) {
        ++base;
      } else if (t < last) {
        ++inside;
        thr = (uint32_t)t;
      }
    }
    if (inside > 1) return false;
    const float fbase = (float)base;
    uint32_t bits;
    memcpy(&bits, &fbase, sizeof(bits));
    pc->levels[32 - L] = make_uint2(thr, bits);
  }
  return true;
}

}  // namespace
