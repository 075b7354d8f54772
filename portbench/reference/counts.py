"""The bootstrap counts of the program's documented draws, recomputed.

The reference takes no count table from the program: it draws the same
counts again from the seed a call was given, by the rules the port
documents for each route.

- CUDA (K3, K5): Poisson(1) counts from Philox4x32-10.  The count of
  replicate ``r`` at sample ``j`` is word ``j & 3`` of Philox with counter
  ``((j >> 2) mod 2^32, r, (j >> 34) mod 2^32, 0)`` and key ``(seed mod
  2^32, (seed >> 32) mod 2^32)``, mapped by the truncated Poisson(1) CDF.
  A streaming chunk draws at its own seed, ``seed + step * 0x9E3779B97F4A7C15
  mod 2^64``, with ``j`` counted from the chunk's start.
- CPU, batch pipelines: a multinomial table, ``torch.randint`` indices
  from a CPU generator seeded with the call's seed, counted per sample.
- CPU, streaming pipelines: a Poisson(1) table per chunk from 32-bit
  ``torch.randint`` words of a generator seeded with the chunk's seed.

A count source hands out ``block(start, n) -> (nrep, n)`` int32 counts of
samples ``start .. start+n-1`` and splits a range into blocks that never
cross a chunk (``spans``).
"""

from __future__ import annotations

import torch

# Poisson(1) CDF truncated at count 9 and its unsigned 32-bit cutoffs: a
# count is #{k : word > floor(CDF[k] * 2^32)}
POISSON1_CDF = (
    0.36787944117144233,
    0.7357588823428847,
    0.9196986029286058,
    0.9810118431238462,
    0.9963401531726563,
    0.9994058151824183,
    0.9999167588507119,
    0.9999897508033253,
    0.9999988747974049,
)
THRESHOLDS = tuple(int(c * 4294967296.0) for c in POISSON1_CDF)
WEYL64 = 0x9E3779B97F4A7C15
_M32 = 0xFFFFFFFF
_M64 = 0xFFFFFFFFFFFFFFFF


def chunk_seed(seed: int, step: int) -> int:
    """The unsigned 64-bit seed of streaming chunk ``step``."""
    return (int(seed) + int(step) * WEYL64) & _M64


def _philox(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32-10 on int64 tensors of 32-bit words.  The 32 x 32-bit
    products overflow int64, but their bits are right mod 2^64 and only the
    masked words are read."""
    for i in range(10):
        if i:
            k0 = (k0 + 0x9E3779B9) & _M32
            k1 = (k1 + 0xBB67AE85) & _M32
        p0 = c0 * 0xD2511F53
        p1 = c2 * 0xCD9E8D57
        c0, c1, c2, c3 = ((p1 >> 32) & _M32) ^ c1 ^ k0, p1 & _M32, ((p0 >> 32) & _M32) ^ c3 ^ k1, p0 & _M32
    return c0, c1, c2, c3


def _level(word):
    n = torch.zeros(word.shape, dtype=torch.int32, device=word.device)
    for t in THRESHOLDS:
        n += (word > t).to(torch.int32)
    return n


def philox_counts(seed: int, nrep: int, start: int, n: int, device) -> torch.Tensor:
    """Counts ``(nrep, n)`` of samples ``start .. start+n-1`` (``start`` a
    multiple of 4) at ``seed``."""
    if start % 4:
        msg = f"start must be a multiple of 4, got {start}"
        raise ValueError(msg)
    seed = int(seed) & _M64
    ngroup = (n + 3) // 4
    g = torch.arange(start // 4, start // 4 + ngroup, dtype=torch.int64, device=device)
    c0 = (g & _M32)[None, :].expand(nrep, ngroup)
    c2 = ((g >> 32) & _M32)[None, :].expand(nrep, ngroup)
    c1 = torch.arange(nrep, dtype=torch.int64, device=device)[:, None].expand(nrep, ngroup)
    words = _philox(c0, c1, c2, torch.zeros_like(c0), seed & _M32, (seed >> 32) & _M32)
    return torch.stack([_level(w) for w in words], dim=-1).reshape(nrep, 4 * ngroup)[:, :n]


class PhiloxCounts:
    """The CUDA route's counts: one seed over the samples, or one per chunk
    of ``chunk`` samples when ``chunk`` is given."""

    def __init__(self, seed: int, nrep: int, device, *, chunk: int | None = None):
        self.seed, self.nrep, self.device, self.chunk = seed, nrep, device, chunk

    def spans(self, rows: int, block: int):
        return _spans(rows, block, self.chunk)

    def block(self, start: int, n: int) -> torch.Tensor:
        if self.chunk is None:
            return philox_counts(self.seed, self.nrep, start, n, self.device)
        step, local = divmod(start, self.chunk)
        return philox_counts(chunk_seed(self.seed, step), self.nrep, local, n, self.device)


class TableCounts:
    """The CPU route's tables: a multinomial table of ``nrec`` samples at
    ``seed``, or with ``chunk`` a Poisson(1) table per chunk at the chunk's
    seed."""

    def __init__(self, seed: int, nrep: int, nrec: int, *, chunk: int | None = None):
        self.seed, self.nrep, self.nrec, self.chunk = seed, nrep, nrec, chunk
        self._tables: dict[int, torch.Tensor] = {}

    def spans(self, rows: int, block: int):
        return _spans(rows, block, self.chunk)

    def _table(self, step: int) -> torch.Tensor:
        if step not in self._tables:
            gen = torch.Generator(device="cpu")
            if self.chunk is None:
                gen.manual_seed(int(self.seed))
                idx = torch.randint(0, self.nrec, (self.nrep, self.nrec), generator=gen)
                table = torch.zeros((self.nrep, self.nrec), dtype=torch.int32)
                table.scatter_add_(1, idx, torch.ones_like(idx, dtype=torch.int32))
            else:
                gen.manual_seed(chunk_seed(self.seed, step))
                words = torch.randint(0, 2**32, (self.nrep, self.chunk), generator=gen, dtype=torch.int64)
                table = _level(words)
            self._tables[step] = table
        return self._tables[step]

    def block(self, start: int, n: int) -> torch.Tensor:
        if self.chunk is None:
            return self._table(0)[:, start : start + n]
        step, local = divmod(start, self.chunk)
        return self._table(step)[:, local : local + n]


def _spans(rows: int, block: int, chunk: int | None):
    """``(start, n)`` blocks of at most ``block`` samples covering ``0 ..
    rows-1``, each inside one chunk, every start a multiple of 4."""
    block = max(4, block // 4 * 4)
    edge = rows if chunk is None else chunk
    if chunk is not None and chunk % 4:
        msg = f"a chunk of {chunk} samples does not keep block starts on multiples of 4"
        raise ValueError(msg)
    out = []
    for c0 in range(0, rows, edge):
        c1 = min(rows, c0 + edge)
        out.extend((s, min(block, c1 - s)) for s in range(c0, c1, block))
    return out


def for_route(device_type: str, seed: int, nrep: int, nrec: int, device, *, chunk: int | None = None):
    """The count source of a call at ``seed`` on the route of
    ``device_type``; ``nrec`` is the samples a batch call resamples, and
    ``chunk`` the chunk length of a stream."""
    if device_type == "cuda":
        return PhiloxCounts(seed, nrep, device, chunk=chunk)
    return TableCounts(seed, nrep, nrec, chunk=chunk)
