r"""Recursive interpolation trainer.

Counterpart of ``thermoextrap_tpu/recursive_interp.py``: recursively
bisects the interval: build a 2-state interpolation, bootstrap the relative
error on a 50-point grid, insert a new state at the worst point, recurse
until the bootstrap relative error meets ``tol``.  Each check reads the
prediction and its bootstrap back to the host once, as numpy.
"""

from __future__ import annotations

import logging

import numpy as np

from . import idealgas
from .data import factory_data_values
from .models.extrap import ExtrapModel, InterpModel
from .utils.device import host_numpy
from .utils.random import split, validate_rng

logger = logging.getLogger(__name__)



__all__ = ["RecursiveInterp"]


class RecursiveInterp:
    """Recursive-bisection piecewise interpolation trainer
    (upstream recursive_interp.py:34-527).

    Parameters
    ----------
    model_cls :
        Collection class used per segment (e.g. ``InterpModel``).
    derivatives :
        :class:`thermoextrap_tpu_torch.models.derivatives.Derivatives`.
    edge_beta :
        Initial interval edges.
    max_order :
        Maximum derivative order per state.
    tol :
        Bootstrap relative-error tolerance.
    """

    def __init__(
        self,
        model_cls,
        derivatives,
        edge_beta,
        max_order: int = 1,
        tol: float = 0.01,
        rng=None,
        nrep: int = 100,
    ) -> None:
        self.model_cls = model_cls
        self.derivatives = derivatives
        self.states: list = []
        self.edge_beta = np.array(edge_beta, dtype=float)
        self.max_order = int(max_order)
        self.tol = float(tol)
        self.rng = validate_rng(rng)
        self.nrep = int(nrep)

    # -- data source (override for real simulations) --------------------------

    def get_data(self, beta):
        """Generate data at a state point; override to run MD/MC or load
        files.  The default is the toy ideal gas (10_000 configurations of
        1000 particles, float64, on the generator's device) as raw moments
        of order ``max_order``: the raw route is plain torch on every device
        (``ops.dispatch.reduce_raw``), as in the JAX package, so it
        launches no kernel."""
        (sub,) = split(self.rng, 1)
        npart, nconfig = 1000, 10_000
        xdata, udata = idealgas.generate_data((nconfig, npart), beta, rng=sub)
        return factory_data_values(uv=udata, xv=xdata, order=self.max_order)

    # -- training --------------------------------------------------------------

    def _bootstrap_rel_err(self, model, beta_vals):
        pred = host_numpy(model.predict(beta_vals, order=self.max_order))
        boot = host_numpy(
            model.resample({"nrep": self.nrep}).predict(
                beta_vals, order=self.max_order
            )
        )  # (A, nrep[, val])
        err = boot.std(axis=1)
        pred_abs = np.abs(pred)
        with np.errstate(divide="ignore", invalid="ignore"):
            rel = np.where(pred_abs > 0, err / pred_abs, 0.0)
        return pred, np.nan_to_num(rel, nan=0.0, posinf=0.0)

    def recursive_train(
        self,
        beta1,
        beta2,
        data1=None,
        data2=None,
        recurse_depth: int = 0,
        recurse_max: int = 10,
        beta_avail=None,
        verbose: bool = False,
    ) -> None:
        """Recursively train on [beta1, beta2]
        (upstream recursive_interp.py:113-267)."""
        if recurse_depth > recurse_max:
            msg = "Maximum recursion depth reached."
            raise RecursionError(msg)
        if verbose:
            logger.setLevel(logging.INFO)
        logger.info("Interpolating from points %f and %f", beta1, beta2)

        if data1 is None:
            data1 = self.get_data(beta1)
        if data2 is None:
            data2 = self.get_data(beta2)

        extrap1 = ExtrapModel(
            alpha0=beta1, data=data1, derivatives=self.derivatives, order=self.max_order
        )
        extrap2 = ExtrapModel(
            alpha0=beta2, data=data2, derivatives=self.derivatives, order=self.max_order
        )
        this_model = self.model_cls([extrap1, extrap2])

        beta_vals = np.linspace(beta1, beta2, num=50)
        _pred, rel_err = self._bootstrap_rel_err(this_model, beta_vals)

        check_ind = np.unravel_index(np.argmax(rel_err), rel_err.shape)
        check_val = rel_err[check_ind]
        logger.info("Maximum bootstrapped error within interval: %s", check_val)
        # a new point must lie STRICTLY inside the interval: the linspace
        # endpoints coincide with the existing states (a near-zero
        # prediction there can spike rel_err), and splitting at an
        # endpoint recurses into a zero-width, singular interpolation —
        # select from the interior grid only
        interior_err = rel_err[1:-1]
        interior_ind = np.unravel_index(
            np.argmax(interior_err), interior_err.shape
        )
        select_beta = beta_vals[1:-1][interior_ind[0]]

        if check_val <= self.tol:
            new_beta = None
        elif beta_avail is not None:
            beta_avail = np.asarray(beta_avail)
            new_beta = beta_avail[np.argmin(np.abs(beta_avail - select_beta))]
            # the nearest AVAILABLE point can fall on/outside the current
            # interval (the reference indexes blindly and crashes); a point
            # at/beyond either endpoint cannot split the interval — accept
            # the interval as converged-as-possible instead of recursing
            # into a zero-width (singular-solve) pair
            if new_beta <= beta1 or new_beta >= beta2:
                logger.info(
                    "No available beta strictly inside (%f, %f); accepting "
                    "interval at tolerance %g > %g",
                    beta1, beta2, check_val, self.tol,
                )
                new_beta = None
        else:
            new_beta = select_beta

        if new_beta is not None:
            logger.info("Selected new extrapolation point: %f", new_beta)
            insert_ind = np.where(self.edge_beta > new_beta)[0][0]
            self.edge_beta = np.insert(self.edge_beta, insert_ind, new_beta)
            self.recursive_train(
                beta1,
                new_beta,
                data1=data1,
                data2=None,
                recurse_depth=recurse_depth + 1,
                recurse_max=recurse_max,
                beta_avail=beta_avail,
                verbose=verbose,
            )
            self.recursive_train(
                new_beta,
                beta2,
                data1=None,
                data2=data2,
                recurse_depth=recurse_depth + 1,
                recurse_max=recurse_max,
                beta_avail=beta_avail,
                verbose=verbose,
            )
        else:
            self.states.append(extrap1)
            if beta2 == self.edge_beta[-1]:
                self.states.append(extrap2)

    def sequential_train(self, beta_train, verbose: bool = False) -> None:
        """Train on a fixed list of state points without subdivision
        (upstream recursive_interp.py:271-349)."""
        for beta_val in beta_train:
            if beta_val not in self.edge_beta:
                self.edge_beta = np.hstack((self.edge_beta, [beta_val]))
                self.states = [*self.states, None]
        while len(self.states) < len(self.edge_beta):
            self.states.append(None)
        sort_inds = np.argsort(self.edge_beta)
        self.states = [self.states[i] for i in sort_inds]
        self.edge_beta = np.sort(self.edge_beta)

        for i, beta_val in enumerate(self.edge_beta):
            if self.states[i] is None:
                self.states[i] = ExtrapModel(
                    alpha0=float(beta_val),
                    data=self.get_data(float(beta_val)),
                    derivatives=self.derivatives,
                    order=self.max_order,
                )

    def predict(self, beta):
        """Piecewise prediction with the trained states
        (upstream recursive_interp.py:353-403)."""
        if len(self.states) == 0:
            msg = "Must train before predicting"
            raise ValueError(msg)

        betas = np.atleast_1d(np.asarray(beta, dtype=float))
        out = []
        for beta_val in betas:
            if beta_val < self.edge_beta[0] or beta_val > self.edge_beta[-1]:
                msg = (
                    f"point {beta_val} outside interpolation interval "
                    f"{self.edge_beta[0]}..{self.edge_beta[-1]}"
                )
                raise IndexError(msg)
            low_ind = int(np.where(self.edge_beta <= beta_val)[0][-1])
            hi = np.where(self.edge_beta > beta_val)[0]
            if len(hi):
                hi_ind = int(hi[0])
            else:
                low_ind -= 1
                hi_ind = len(self.edge_beta) - 1
            model = self.model_cls([self.states[low_ind], self.states[hi_ind]])
            out.append(host_numpy(model.predict(beta_val, order=self.max_order)))
        return np.stack(out, axis=0)

    def check_poly_consistency(self):
        """Z-test agreement of polynomial coefficients between neighbouring
        and merged regions (upstream recursive_interp.py:405-527).

        Returns a list of ``(p12, p1full, p2full)`` arrays per edge triplet.
        """
        from scipy import stats

        if self.model_cls is not InterpModel:
            msg = "Can only check polynomial consistency with InterpModel."
            raise TypeError(msg)
        if len(self.states) == 0:
            msg = "Must train model before checking consistency."
            raise ValueError(msg)
        if len(self.states) == 2:
            msg = "Single interpolation region; nothing to check."
            raise ValueError(msg)

        _stats_cache: dict[tuple[int, int], tuple] = {}

        def coef_stats(i, j):
            # cached: the (a+1, a+2) pair of one loop iteration is the
            # (a, a+1) pair of the next — each redundant call would repay
            # a full bootstrap resample + host-f64 solve
            if (i, j) not in _stats_cache:
                m = self.model_cls([self.states[i], self.states[j]])
                coefs = host_numpy(m.coefs(order=self.max_order))
                boot = host_numpy(
                    m.resample({"nrep": self.nrep}).coefs(order=self.max_order)
                )  # (porder+1, nrep[, val])
                _stats_cache[(i, j)] = (coefs, boot.std(axis=1))
            return _stats_cache[(i, j)]

        all_pvals = []
        for a in range(len(self.edge_beta) - 2):
            c1, e1 = coef_stats(a, a + 1)
            c2, e2 = coef_stats(a + 1, a + 2)
            cf, ef = coef_stats(a, a + 2)

            def pval(ca, ea, cb, eb):
                z = (ca - cb) / np.sqrt(ea**2 + eb**2)
                return stats.norm.cdf(np.abs(z)) - stats.norm.cdf(-np.abs(z))

            all_pvals.append(
                np.vstack(
                    (pval(c1, e1, c2, e2), pval(c1, e1, cf, ef), pval(c2, e2, cf, ef))
                )
            )
        return all_pvals
