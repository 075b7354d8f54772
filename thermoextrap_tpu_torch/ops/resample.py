r"""Bootstrap resampling of (co)moments, in plain torch.

Counterpart of ``thermoextrap_tpu/ops/resample.py``.  Resampled moments are
a frequency-table product, ``moments[rep] = freq[rep, :] @ contributions``,
with ``freq[r, i]`` the number of times sample ``i`` appears in replicate
``r``.  Samples are centred at the global means first and every replicate is
recentred exactly afterwards (central moments are shift invariant).

Every random draw takes an explicit ``torch.Generator``; the numbers differ
from ``jax.random`` at equal seed, so parity tests hand both packages the
same numpy tables.
"""

from __future__ import annotations

import torch

from .convert import fix_central_du, fix_central_dxdu, shift_raw_comoments, shift_raw_moments
from .moments import u_power_stack

__all__ = [
    "POISSON1_CDF",
    "freq_from_indices",
    "poisson1_freq",
    "random_freq",
    "random_indices",
    "resample_central_comoments",
    "resample_central_umoments_batched",
    "resample_raw_comoments",
    "resample_values",
]

# Poisson(1) CDF truncated at count 9 (P(X>9) ~ 1.1e-7 per draw): the one
# constant behind every Poisson(1) count in the package, the in-kernel draw
# of the CUDA bootstrap included (count = #{k : u32 > floor(CDF[k] * 2^32)}).
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

# the same thresholds as unsigned 32-bit cutoffs
POISSON1_THRESHOLDS = tuple(int(c * 4294967296.0) for c in POISSON1_CDF)


def _gen_device(gen):
    return gen.device if gen is not None else torch.device("cpu")


def random_indices(gen, nrep: int, nrec: int, nsamp: int | None = None, device=None):
    """Uniform bootstrap index table ``(nrep, nsamp)``, sampled with
    replacement from ``gen``; moved to ``device`` when given."""
    nsamp = nrec if nsamp is None else nsamp
    idx = torch.randint(
        0, nrec, (nrep, nsamp), generator=gen, device=_gen_device(gen)
    )
    return idx if device is None else idx.to(device)


def freq_from_indices(indices, nrec: int, dtype=torch.int32):
    """Count table ``freq[r, i] = #{j : indices[r, j] == i}``."""
    indices = torch.as_tensor(indices)
    freq = torch.zeros((indices.shape[0], nrec), dtype=dtype, device=indices.device)
    return freq.scatter_add_(1, indices.long(), torch.ones_like(indices, dtype=dtype))


def poisson1_freq(gen, shape, dtype=torch.float32, device=None):
    """Poisson(1) table by the u32 threshold sum over :data:`POISSON1_CDF`
    (one uniform 32-bit draw per entry; marginal truncated at 9)."""
    bits = torch.randint(
        0, 2**32, tuple(shape), generator=gen, dtype=torch.int64, device=_gen_device(gen)
    )
    f = torch.zeros(bits.shape, dtype=torch.int32, device=bits.device)
    for t in POISSON1_THRESHOLDS:
        f += (bits > t).to(torch.int32)
    f = f.to(dtype)
    return f if device is None else f.to(device)


def random_freq(gen, nrep: int, nrec: int, method: str = "multinomial", dtype=torch.int32):
    """Random frequency table: ``multinomial`` (exact bootstrap, rows sum
    to ``nrec``), ``poisson`` (truncated Poisson(1), see
    :func:`poisson1_freq`) or ``poisson_exact`` (``torch.poisson``)."""
    if method == "multinomial":
        return freq_from_indices(random_indices(gen, nrep, nrec), nrec, dtype=dtype)
    if method == "poisson":
        return poisson1_freq(gen, (nrep, nrec), dtype=dtype)
    if method == "poisson_exact":
        rate = torch.ones((nrep, nrec), dtype=torch.float64, device=_gen_device(gen))
        return torch.poisson(rate, generator=gen).to(dtype)
    msg = f"unknown method {method!r}"
    raise ValueError(msg)


def resample_values(values, indices, rec_axis: int = 0):
    """Index-resample raw values along ``rec_axis``: the index table's
    shape replaces that axis (``values[indices]`` for ``rec_axis=0``)."""
    indices = torch.as_tensor(indices, device=values.device)
    rec_axis = rec_axis % values.ndim
    flat = torch.index_select(values, rec_axis, indices.reshape(-1).long())
    return flat.reshape(
        values.shape[:rec_axis] + indices.shape + values.shape[rec_axis + 1 :]
    )


def _freq_weights(freq, weight, dtype):
    f = torch.as_tensor(freq).to(dtype)
    if weight is not None:
        f = f * torch.as_tensor(weight, dtype=dtype, device=f.device)[None, :]
    return f


def resample_raw_comoments(uv, xv, freq, order: int, weight=None):
    r"""Per-replicate raw comoments by the frequency product.

    ``uv (R,)``, ``xv (R, *val)``, ``freq (nrep, R)`` → ``u (order+1, nrep)``
    and ``xu (order+1, nrep, *val)``.  An all-zero replicate row gets the
    finite stand-in ``u = [1, 0, ...]``, ``xu = 0`` (safe divide) instead of
    0/0.
    """
    val_shape = tuple(xv.shape[1:])
    nrep = freq.shape[0]
    fw = _freq_weights(freq, weight, uv.dtype).to(uv.device)
    wsum0 = fw.sum(dim=-1)
    ok = wsum0 > 0
    wsum = torch.where(ok, wsum0, torch.ones_like(wsum0))

    powers = u_power_stack(uv, order)
    u = (fw @ powers) / wsum[:, None]
    u = torch.cat(
        [torch.where(ok, u[:, 0], torch.ones_like(u[:, 0]))[:, None], u[:, 1:]], dim=1
    )
    xflat = xv.reshape(uv.shape[0], -1)
    contrib = powers[:, :, None] * xflat[:, None, :]
    xu = torch.einsum("pr,rnv->pnv", fw, contrib) / wsum[:, None, None]
    u = torch.movedim(u, 1, 0)
    xu = torch.movedim(xu, 1, 0).reshape((order + 1, nrep, *val_shape))
    return u, xu


def resample_central_comoments(uv, xv, freq, order: int, weight=None):
    r"""Per-replicate central comoments, stabilized by the global means.

    Returns ``xave (nrep, *val)``, ``uave (nrep,)``, ``du (order+1, nrep)``,
    ``dxdu (order+1, nrep, *val)``.
    """
    val_shape = tuple(xv.shape[1:])
    nrep = freq.shape[0]
    w_full = (
        torch.ones_like(uv)
        if weight is None
        else torch.broadcast_to(torch.as_tensor(weight, dtype=uv.dtype, device=uv.device), uv.shape)
    )
    wtot = w_full.sum()
    ubar = (w_full * uv).sum() / wtot
    xflat = xv.reshape(uv.shape[0], -1)
    xbar = (w_full[:, None] * xflat).sum(dim=0) / wtot

    u_s, xu_s = resample_raw_comoments(uv - ubar, xflat - xbar[None, :], freq, order, weight=weight)
    uave = u_s[1] + ubar
    xave = xu_s[0] + xbar[None, :]
    du = shift_raw_moments(u_s, u_s[1])
    x_du = shift_raw_comoments(xu_s, u_s[1][:, None])
    dxdu = fix_central_dxdu(x_du - xu_s[0][None] * du[:, :, None])
    return (
        xave.reshape((nrep, *val_shape)),
        uave,
        fix_central_du(du),
        dxdu.reshape((order + 1, nrep, *val_shape)),
    )


def resample_central_umoments_batched(uv, freq, order: int, weight=None):
    r"""Per-replicate batched central u-moments: ``uv (*batch, R)``,
    ``freq (nrep, R)`` shared across the batch axes (a replicate resamples
    whole configurations).  Returns ``uave (nrep, *batch)`` and
    ``du (order+1, nrep, *batch)`` with ``du[0]=1, du[1]=0``."""
    w = (
        torch.ones_like(uv)
        if weight is None
        else torch.broadcast_to(torch.as_tensor(weight, dtype=uv.dtype, device=uv.device), uv.shape)
    )
    f = torch.as_tensor(freq).to(device=uv.device, dtype=uv.dtype)
    ubar = (w * uv).sum(-1) / w.sum(-1)
    du = uv - ubar[..., None]
    p = w
    rows = [torch.einsum("pr,...r->p...", f, p)]
    for _ in range(order):
        p = p * du
        rows.append(torch.einsum("pr,...r->p...", f, p))
    sums = torch.stack(rows)
    m = sums / torch.where(sums[0] > 0, sums[0], torch.ones_like(sums[0]))
    uave_r = m[1] + ubar[None]
    return uave_r, fix_central_du(shift_raw_moments(m, m[1]))
