r"""Data staging for GPR models.

Counterpart of ``thermoextrap_tpu/stack.py``: each state's derivatives
become rows of the GP input ``X = [alpha, order]`` with outputs summarized
as (mean, variance) over the bootstrap-replicate axis.  Numpy in, numpy
out: a state's derivatives, computed where its data lives (the card, for
data on the card), are read back to the host once per state.

The bootstrap covariance and the block-diagonal noise of
:meth:`GPRData.to_gpr_data` come from the GPR staging
(``gpr_active.active_utils.input_GP_from_state``).
"""

from __future__ import annotations

import numpy as np

from .models.extrap import StateCollection
from .utils.device import host_numpy

__all__ = [
    "GPRData",
    "StackedDerivatives",
    "stack_multidim",
    "states_derivs_concat",
    "to_mean_var",
]


def stack_multidim(
    arr,
    dims,
    x_dims,
    y_dims=None,
    stats_dim=None,
    coords=None,
    policy: str = "infer",
):
    """Flatten named axes of a plain array into the GP staging layout
    (upstream ``stack_dataarray``, stack.py:15-84).

    The reference stacks xarray dims into ``(xstack, ystack[, stats])``
    with a MultiIndex carrying the original coordinates; this is the same
    contract on plain arrays: the axes named by ``x_dims`` merge (C-order)
    into a leading row axis, the remaining axes (minus ``stats_dim``) merge
    into a column axis, and ``stats_dim`` — a (mean, variance) statistics
    axis — is moved last.

    Parameters
    ----------
    arr : array
    dims : sequence of str
        name per axis of ``arr`` (the named-dims convention of the repo's
        data layer; len(dims) == arr.ndim).
    x_dims : str or sequence of str
        axes merged under the row ("xstack") axis, in this order.
    y_dims : str or sequence of str, optional
        axes merged under the column ("ystack") axis; defaults to every
        remaining axis in original order (reference behavior).
    stats_dim : str, optional
        statistics axis moved to the last position.
    coords : dict, optional
        ``{dim: 1-D coordinate array}``; missing entries fall back to
        ``arange(size)`` when ``policy == "infer"`` and raise when
        ``policy == "raise"`` (reference ``policy`` semantics).
    policy : {"infer", "raise"}

    Returns
    -------
    out : array ``(Nx, Ny[, stats])``
    x_coords : array ``(Nx, len(x_dims))``
        cartesian-product coordinates of the merged row axes, ordered to
        match the reshape — the plain-array stand-in for the MultiIndex
        (upstream ``multiindex_to_array``, stack.py:99-101).
    y_coords : array ``(Ny, len(y_dims))``
    """
    arr = np.asarray(arr)
    dims = tuple(dims)
    if policy not in ("infer", "raise"):
        msg = f"policy must be 'infer' or 'raise'; got {policy!r}"
        raise ValueError(msg)
    if len(dims) != arr.ndim:
        msg = f"len(dims)={len(dims)} must equal arr.ndim={arr.ndim}"
        raise ValueError(msg)
    if isinstance(x_dims, str):
        x_dims = (x_dims,)
    x_dims = tuple(x_dims)
    if isinstance(y_dims, str):
        y_dims = (y_dims,)
    elif y_dims is None:
        y_dims = tuple(d for d in dims if d not in x_dims and d != stats_dim)
    else:
        y_dims = tuple(y_dims)

    order_names = x_dims + y_dims + ((stats_dim,) if stats_dim is not None else ())
    if sorted(order_names) != sorted(dims):
        msg = (
            f"x_dims {x_dims} + y_dims {y_dims}"
            + (f" + stats_dim {stats_dim!r}" if stats_dim is not None else "")
            + f" must partition dims {dims}"
        )
        raise ValueError(msg)

    sizes = dict(zip(dims, arr.shape))
    coords = dict(coords or {})

    def _coord(d):
        if d in coords:
            c = np.asarray(coords[d])
            if c.shape[0] != sizes[d]:
                msg = f"coords[{d!r}] has length {c.shape[0]} != axis size {sizes[d]}"
                raise ValueError(msg)
            return c
        if policy == "raise":
            msg = f"coords[{d!r}] not set"
            raise ValueError(msg)
        return np.arange(sizes[d])

    def _cartesian(names):
        if not names:
            return np.empty((1, 0))
        grids = np.meshgrid(*[_coord(d) for d in names], indexing="ij")
        return np.stack([g.ravel() for g in grids], axis=1)

    out = arr.transpose([dims.index(d) for d in order_names])
    nx = int(np.prod([sizes[d] for d in x_dims])) if x_dims else 1
    ny = int(np.prod([sizes[d] for d in y_dims])) if y_dims else 1
    shape = (nx, ny) + ((sizes[stats_dim],) if stats_dim is not None else ())
    return out.reshape(shape), _cartesian(x_dims), _cartesian(y_dims)


def to_mean_var(arr, axis: int = 1):
    """Summarize a replicate axis into a trailing (mean, var) stats axis
    (upstream stack.py:157-183)."""
    arr = np.asarray(arr)
    return np.stack([arr.mean(axis=axis), arr.var(axis=axis)], axis=-1)


def states_derivs_concat(states, order=None, norm: bool = False):
    """Concatenate derivatives of several states along a leading
    (state, order) axis (upstream stack.py:186-216).

    Each state's derivs must share trailing shape; returns
    ``(n_states * (order+1), ...)``.
    """
    if order is None:
        order = min(s.order for s in states)
    return np.concatenate(
        [host_numpy(s.derivs(order=order, norm=norm)) for s in states], axis=0
    )


class StackedDerivatives:
    """Derivative data stacked for GP consumption
    (upstream stack.py:219-516).

    Attributes
    ----------
    x_data : (N, 2) array of [alpha, deriv order] rows
    y_data : (N, Dy, 2) array of (mean, variance) per output dimension
    """

    def __init__(self, x_data, y_data, alpha_name: str = "alpha") -> None:
        self.x_data = np.asarray(x_data)
        self.y_data = np.asarray(y_data)
        self.alpha_name = alpha_name

    @property
    def order(self) -> int:
        return int(self.x_data[:, 1].max())

    def array_data(self, order=None):
        """``(X, [Y_k])`` ready for GP models (upstream stack.py:307-314):
        per output dim, ``Y_k = (N, 2)`` with mean and variance columns."""
        x = self.x_data
        ys = [self.y_data[:, k, :] for k in range(self.y_data.shape[1])]
        if order is not None:
            mask = x[:, 1] <= order
            x = x[mask]
            ys = [y[mask] for y in ys]
        return x, ys

    @classmethod
    def from_mean_var(cls, alphas, means, variances, alpha_name: str = "alpha"):
        """From per-state arrays of derivative means/variances, each shaped
        ``(order+1, Dy)`` (upstream stack.py:344-381)."""
        x_rows, y_rows = [], []
        for a, m, v in zip(alphas, means, variances):
            m = np.asarray(m)
            v = np.asarray(v)
            if m.ndim == 1:
                # (order+1,) scalar observable → (order+1, 1); atleast_2d
                # would TRANSPOSE the layout to one row of Dy=order+1
                m = m.reshape(-1, 1)
                v = v.reshape(-1, 1)
            order = m.shape[0] - 1
            x_rows.append(
                np.stack([np.full(order + 1, a), np.arange(order + 1)], axis=1)
            )
            y_rows.append(np.stack([m, v], axis=-1))
        return cls(np.concatenate(x_rows), np.concatenate(y_rows), alpha_name)

    @classmethod
    def from_derivs(cls, alphas, derivs, rep_axis: int = 1, alpha_name: str = "alpha"):
        """From per-state replicated derivative stacks ``(order+1, nrep, Dy)``
        (upstream stack.py:383-447)."""
        means = [np.asarray(d).mean(axis=rep_axis) for d in derivs]
        variances = [np.asarray(d).var(axis=rep_axis) for d in derivs]
        return cls.from_mean_var(alphas, means, variances, alpha_name)

    @classmethod
    def from_states(cls, states, order=None, nrep: int = 100, alpha_name=None):
        """From extrapolation states, bootstrapping the variances
        (upstream stack.py:449-516)."""
        if order is None:
            order = min(s.order for s in states)
        alphas, derivs = [], []
        for s in states:
            boot = host_numpy(s.resample({"nrep": nrep}).derivs(order=order))
            if boot.ndim == 2:
                boot = boot[:, :, None]
            elif boot.ndim > 3:
                # multi-dim observable: val axes flatten into output dims
                # (upstream stack_dataarray ystack role, stack.py:15-84)
                boot = boot.reshape(boot.shape[0], boot.shape[1], -1)
            alphas.append(s.alpha0)
            derivs.append(boot)
        return cls.from_derivs(
            alphas, derivs, alpha_name=alpha_name or getattr(states[0], "alpha_name", "alpha")
        )


class GPRData(StateCollection):
    """StateCollection with GP staging conveniences
    (upstream stack.py:519-665)."""

    def __init__(self, states, order=None, nrep: int = 100, **kws) -> None:
        super().__init__(states, **kws)
        self._order = order
        self.nrep = nrep
        # StateCollection.resample/append rebuild via type(self)(states,
        # **self.kws) — record our settings there or they silently reset
        self.kws = {"order": order, "nrep": nrep, **kws}

    @property
    def order(self):
        return self._order if self._order is not None else super().order

    def stacked(self, order=None):
        return StackedDerivatives.from_states(
            self.states,
            order=self.order if order is None else order,  # 0 is valid
            nrep=self.nrep,
        )

    def array_data(self, order=None):
        return self.stacked(order=order).array_data()

    def to_gpr_data(self, log_scale: bool = False):
        """Full (X, Y, block-diag noise cov) via the active-learning staging."""
        from scipy import linalg

        from .gpr_active.active_utils import input_GP_from_state

        xs, ys, covs = [], [], []
        for s in self.states:
            x, y, c = input_GP_from_state(s, n_rep=self.nrep, log_scale=log_scale)
            xs.append(x)
            ys.append(y)
            covs.append(c)
        x_data = np.vstack(xs)
        y_data = np.vstack(ys)
        noise = np.array(
            [
                linalg.block_diag(*[c[k] for c in covs])
                for k in range(y_data.shape[1])
            ]
        )
        return x_data, y_data, noise
