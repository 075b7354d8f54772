r"""Adaptive (functional) interpolation trainers.

Counterpart of ``thermoextrap_tpu/adaptive_interp.py``:
``train_iterative`` / ``train_recursive`` add states where the bootstrap
relative error of the current model is largest, until ``tol`` is met.
States are produced by a user ``factory_state`` callable and must carry a
bootstrap-replicate axis (axis 1 of ``model.predict`` outputs).  The
criterion reads the model's ``(A, nrep[, val])`` prediction back to the host
once per iteration, so every ``info`` dict holds numpy arrays.
"""

from __future__ import annotations

from itertools import chain, islice

import numpy as np
import torch

from .utils.device import host_numpy

__all__ = [
    "callback_plot_progress",
    "check_polynomial_consistency",
    "factory_state_idealgas",
    "plot_polynomial_consistency",
    "train_iterative",
    "train_recursive",
    "window",
]


def window(seq, n: int = 2):
    """Sliding window over a sequence (upstream adaptive_interp.py:20-31)."""
    it = iter(seq)
    result = tuple(islice(it, n))
    if len(result) == n:
        yield result
    for elem in it:
        result = result[1:] + (elem,)
        yield result


def relative_fluctuations(arr, axis: int = 1):
    """Mean and relative error along the replicate axis."""
    ave = arr.mean(axis=axis)
    with np.errstate(divide="ignore", invalid="ignore"):
        err = arr.std(axis=axis) / np.abs(ave)
    err = np.where(np.isfinite(err), err, np.nan)
    return ave, err


def _check_relative_fluctuations(
    alphas,
    model,
    states,
    predict_kws=None,
    tol: float = 0.003,
    alpha_tol: float = 0.01,
):
    """Locate the alpha with the worst bootstrap relative error
    (upstream adaptive_interp.py:44-92)."""
    predict_kws = predict_kws or {}
    alphas = np.asarray(alphas, dtype=float)

    pred = host_numpy(model.predict(alphas, **predict_kws))  # (A, nrep[, val])
    ave, err_rel = relative_fluctuations(pred, axis=1)
    # max over remaining (val) axes
    while err_rel.ndim > 1:
        err_rel = np.nanmax(err_rel, axis=-1)

    info = {"alpha0": model.alpha0, "err": err_rel, "ave": ave}

    mask = err_rel > tol
    if alpha_tol > 0 and len(states) > 0:
        alphas_states = np.asarray([s.alpha0 for s in states])
        dist = np.abs(alphas[:, None] - alphas_states[None, :]).min(axis=1)
        mask &= dist > alpha_tol

    if mask.any():
        idx = int(np.nanargmax(np.where(mask, err_rel, -np.inf)))
        alpha_new = float(alphas[idx])
        info["alpha_new"] = alpha_new
        info["err_max"] = float(err_rel[idx])
    else:
        alpha_new = None
    return alpha_new, info


def train_iterative(
    alphas,
    factory_state,
    factory_statecollection,
    states=None,
    maxiter: int = 10,
    state_kws=None,
    statecollection_kws=None,
    predict_kws=None,
    tol: float = 0.003,
    alpha_tol: float = 0.01,
    callback=None,
    callback_kws=None,
):
    """Iteratively add worst-error states over the whole alpha range
    (upstream adaptive_interp.py:95-225).  Returns ``(model, info)``."""
    state_kws = state_kws or {}
    statecollection_kws = statecollection_kws or {}
    callback_kws = callback_kws or {}

    if maxiter <= 0:
        msg = f"{maxiter=} must be positive"
        raise ValueError(msg)

    alphas = np.asarray(alphas, dtype=float)
    if states is None:
        states = [
            factory_state(alphas[0], **state_kws),
            factory_state(alphas[-1], **state_kws),
        ]
    states = list(states)
    info = []
    model = None

    for depth in range(maxiter):
        model = factory_statecollection(states, **statecollection_kws)
        alpha_new, info_dict = _check_relative_fluctuations(
            alphas=alphas,
            model=model,
            states=states,
            predict_kws=predict_kws,
            tol=tol,
            alpha_tol=alpha_tol,
        )
        info_dict["depth"] = depth
        info.append(info_dict)

        if callback is not None and callback(model, alphas, info_dict, **callback_kws):
            break
        if alpha_new is None:
            break
        states = sorted(
            [*states, factory_state(alpha_new, **state_kws)], key=lambda x: x.alpha0
        )

    return model, info


def train_recursive(
    alphas,
    factory_state,
    factory_statecollection,
    state0=None,
    state1=None,
    states=None,
    info=None,
    depth: int = 0,
    maxiter: int = 10,
    state_kws=None,
    statecollection_kws=None,
    predict_kws=None,
    tol: float = 0.003,
    alpha_tol: float = 0.01,
    callback=None,
    callback_kws=None,
):
    """Recursive bisection version (upstream adaptive_interp.py:228-423).
    Returns ``(states, info)``."""
    states = [] if states is None else list(states)
    info = [] if info is None else list(info)
    if depth >= maxiter:
        return states, info

    state_kws = state_kws or {}
    statecollection_kws = statecollection_kws or {}
    callback_kws = callback_kws or {}
    alphas = np.asarray(alphas, dtype=float)

    def get_state(alpha, states):
        for s in states:
            if s.alpha0 == alpha:
                return s
        return factory_state(alpha, **state_kws)

    if state0 is None:
        state0 = get_state(alphas[0], states)
    if state1 is None:
        state1 = get_state(alphas[-1], states)

    model = factory_statecollection([state0, state1], **statecollection_kws)
    alpha0, alpha1 = model.alpha0

    alpha_new, info_dict = _check_relative_fluctuations(
        alphas=alphas,
        model=model,
        states=states,
        predict_kws=predict_kws,
        tol=tol,
        alpha_tol=alpha_tol,
    )
    info_dict["depth"] = depth
    info = [*info, info_dict]

    if callback is not None and callback(model, alphas, info_dict, **callback_kws):
        alpha_new = None

    if alpha_new is not None:
        state_new = get_state(alpha_new, states)
        common = {
            "factory_state": factory_state,
            "factory_statecollection": factory_statecollection,
            "depth": depth + 1,
            "maxiter": maxiter,
            "state_kws": state_kws,
            "statecollection_kws": statecollection_kws,
            "predict_kws": predict_kws,
            "tol": tol,
            "alpha_tol": alpha_tol,
            "callback": callback,
            "callback_kws": callback_kws,
        }
        states, info = train_recursive(
            alphas[(alpha0 <= alphas) & (alphas < alpha_new)],
            state0=state0,
            state1=state_new,
            states=states,
            info=info,
            **common,
        )
        states, info = train_recursive(
            alphas[(alpha_new <= alphas) & (alphas <= alpha1)],
            state0=state_new,
            state1=state1,
            states=states,
            info=info,
            **common,
        )
    else:
        alphas_states = {s.alpha0 for s in states}
        for alpha, state in zip([alpha0, alpha1], [state0, state1]):
            if alpha not in alphas_states:
                states.append(state)
        states = sorted(states, key=lambda x: x.alpha0)

    return states, info


def check_polynomial_consistency(states, factory_statecollection):
    """Pairwise p-values for coefficient agreement across sub-segments
    (upstream adaptive_interp.py:426-490).  Returns ``(p_values, models)``."""
    from scipy import stats

    ave, var, models = {}, {}, {}
    for state_pair in chain(zip(states[:-1], states[1:]), zip(states[:-2], states[2:])):
        model = factory_statecollection(list(state_pair))
        key = tuple(model.alpha0)
        coef = host_numpy(model.coefs(order=None))  # (porder+1, nrep[, val])
        ave[key] = coef.mean(axis=1)
        var[key] = coef.var(axis=1)
        models[key] = model

    ps = {}
    for keys in window((s.alpha0 for s in states), n=3):
        keys01 = keys[0], keys[1]
        keys12 = keys[1], keys[2]
        keys02 = keys[0], keys[2]
        for key0, key1 in [(keys01, keys12), (keys01, keys02), (keys12, keys02)]:
            key = key0, key1
            if key not in ps:
                n = min(ave[key0].shape[0], ave[key1].shape[0])
                z = (ave[key0][:n] - ave[key1][:n]) / np.sqrt(
                    var[key0][:n] + var[key1][:n]
                )
                ps[key] = stats.norm.cdf(np.abs(z)) - stats.norm.cdf(-np.abs(z))
    return ps, models


def callback_plot_progress(
    model,
    alphas,
    info_dict,
    verbose: bool = True,
    maxdepth_stop: int | None = None,
    ax=None,
    exact=None,
    show: bool | None = None,
):
    """Demo iteration callback: plot the current model prediction each
    depth (upstream adaptive_interp.py:550-605).  Pass via
    ``train_iterative(..., callback=callback_plot_progress)``.

    Parameters
    ----------
    verbose : print depth / training alphas / new alpha.
    maxdepth_stop : return ``True`` (stop training) past this depth —
        redundant with ``maxiter``, kept as the reference's demonstration
        of coding a stop criterion into the callback.
    ax : optional :class:`matplotlib.axes.Axes` to draw into.
    exact : optional callable ``alpha -> value`` overlaid as a dotted
        black line (e.g. ``idealgas.x_ave``).
    show : call ``plt.show()``; defaults to True only when ``ax`` is None
        (the reference always shows; headless callers pass an axis).
    """
    import matplotlib.pyplot as plt

    if verbose:
        print("depth:", info_dict["depth"])
        print("alphas:", model.alpha0)

    if show is None:
        show = ax is None
    if ax is None:
        _, ax = plt.subplots()

    alphas = np.asarray(alphas, dtype=float)
    ave = np.asarray(info_dict["ave"]).reshape(len(alphas), -1)
    ax.plot(alphas, ave, label=f"depth {info_dict['depth']}")
    if exact is not None:
        ax.plot(alphas, host_numpy(exact(alphas)).reshape(len(alphas), -1),
                ls=":", color="k")

    alpha_new = info_dict.get("alpha_new")
    if alpha_new is not None:
        if verbose:
            print("alpha_new:", alpha_new)
        ax.axvline(x=alpha_new, ls=":")
    if show:
        plt.show()

    stop = False
    if maxdepth_stop is not None:
        stop = info_dict["depth"] > maxdepth_stop
        if stop and verbose:
            print("reached maxdepth_stop in callback")
    return stop


def plot_polynomial_consistency(
    alphas, states, factory_statecollection, ax=None, verbose: bool = True
):
    """Plotter for :func:`check_polynomial_consistency` (upstream
    adaptive_interp.py:608-635): prints the pairwise segment p-values and
    plots each segment model's bootstrap-mean prediction over the union of
    the two segment ranges.  Returns ``(p_values, models_dict)``."""
    import matplotlib.pyplot as plt

    show = ax is None
    if ax is None:
        _, ax = plt.subplots()
    alphas = np.asarray(alphas, dtype=float)

    p_values, models_dict = check_polynomial_consistency(
        states, factory_statecollection
    )

    hit = set()
    for (key0, key1), p in p_values.items():
        if verbose:
            print(
                "range0: {} range1: {} p01: {}".format(
                    *(np.round(x, 3) for x in (key0, key1, p))
                )
            )
        lb = min(k[0] for k in (key0, key1))
        ub = max(k[1] for k in (key0, key1))
        alphas_lim = alphas[(lb <= alphas) & (alphas <= ub)]
        if len(alphas_lim) == 0:
            continue
        for key in (key0, key1):
            if key not in hit:
                pred = host_numpy(models_dict[key].predict(alphas_lim))
                ax.plot(
                    alphas_lim,
                    pred.mean(axis=1).reshape(len(alphas_lim), -1),
                    label=str(np.round(key, 3)),
                )
                hit.add(key)

    ax.legend()
    if show:
        plt.show()
    return p_values, models_dict


def factory_state_idealgas(
    beta,
    order: int,
    nrep: int = 100,
    nconfig: int = 10_000,
    npart: int = 1_000,
    rng=None,
):
    """Demo state factory: a bootstrap-replicated ideal-gas extrapolation
    state (``DataCentralMomentsVals.from_vals`` on ``(nconfig, npart)``
    positions drawn on the default device, resampled by a count table of
    ``nrep`` multinomial replicates).

    The trainers call it once per alpha with the same ``rng``, so each
    state derives its own seed: ``(seed + b * 0x9E3779B97F4A7C15) mod
    2^64``, with ``seed`` the integer ``rng`` (0 for None, a generator's
    ``initial_seed()``) and ``b`` the bits of ``float32(beta)`` as an
    unsigned integer.  Two generators split from that seed draw the
    positions and the bootstrap indices.  Without the per-state seed every
    state would draw identical samples and indices, and perfectly
    correlated states break the bootstrap criterion.
    """
    from . import beta as beta_xpan
    from . import idealgas
    from .data import DataCentralMomentsVals
    from .utils.random import split

    seed = rng.initial_seed() if isinstance(rng, torch.Generator) else int(0 if rng is None else rng)
    bits = int(np.float32(beta).view(np.uint32))
    g_data, g_boot = split((seed + bits * 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF)
    xdata, udata = idealgas.generate_data((nconfig, npart), beta, rng=g_data)
    data = DataCentralMomentsVals.from_vals(xdata, udata, order=order).resample(
        {"nrep": nrep, "rng": g_boot}
    )
    return beta_xpan.factory_extrapmodel(beta=beta, data=data)
