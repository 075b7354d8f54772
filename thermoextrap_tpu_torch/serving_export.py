r"""Exported serving artifacts (``torch.export``): trace once, serve anywhere.

Counterpart of ``thermoextrap_tpu/serving_export.py``.  A serving pipeline
is traced ONCE into a ``torch.export.ExportedProgram``, shape-polymorphic in
the sample count ``R``, the query count ``A`` and (unless pinned) the value
width ``V``, written to one file, and reloaded in any process without
tracing any Python: loading reads the program, and the first call on a
device moves it there.  One artifact serves every input size.

The programs are traced on the CPU from the plain torch paths
(:mod:`.ops.moments`, :mod:`.ops.resample`, the series engine) under
``ops.dispatch.use_impl("torch")``, so an artifact calls no hand-written
kernel on any device (a traced program could not: the kernels are ctypes
launches on device pointers).  The sample-axis sums of the extrapolation,
volume, lnΠ and perturbation families run in float64, as the kernels'
partial sums and the series do; outputs come back in the artifact's dtype.
Bootstrap replicates use Poisson(1) counts drawn inside the program by
:func:`.ops.resample.philox_poisson1_counts` from the call's ``seed``: the
counts the kernels K3, K5 and K8 draw at that seed, so an artifact's
replicates are those of the in-process kernel pipeline.

Artifact families: β-extrapolation (:func:`export_extrap_pipeline`),
perturbation reweighting (:func:`export_perturb_pipeline`), first-order
volume extrapolation (:func:`export_volume_pipeline`), the macrostate-grid
lnΠ (:func:`export_lnpi_pipeline`), frozen GPR posterior predictors
(:func:`export_gpr_predictor`, polymorphic in the query count ``M``), MBAR
solve and reweighting (:func:`export_mbar_reweighter`, the hybrid solve a
``torch.while_loop`` and the α blocks a ``scan`` inside the program), and
STREAMING bundles (``export_streaming_{extrap,volume,perturb,lnpi}_pipeline``:
``update`` polymorphic in the chunk length, ``predict``, and the initial
state in one file; the state crosses the boundary as a flat tuple of
tensors).

File format: line 1 the magic ``THEXTORCH-EXPORT-1`` (``THEXTORCH-BUNDLE-1``
for a bundle), line 2 a one-line JSON header (the family, its static
config and ``dtype``, the JAX package's keys; a bundle adds ``_sizes`` and
``_state_spec``), then the ``torch.export.save`` bytes of the program (of
the two programs and the encoded initial state, for a bundle).
:func:`describe_artifact` reads the JAX package's headers too;
:func:`load_exported` refuses a JAX artifact.

Examples
--------
>>> import numpy as np
>>> art = export_extrap_pipeline(order=2, beta0=1.0)
>>> uv = np.array([1.0, 2.0, 3.0, 4.0], np.float32)
>>> xv = np.array([[2.0], [4.0], [6.0], [8.0]], np.float32)
>>> pred = art(uv, xv, np.array([1.0], np.float32))
>>> float(pred[0, 0])
5.0
"""

from __future__ import annotations

import copy
import io
import json
import math
import os
import warnings

import numpy as np
import torch
from torch.export import Dim

from .data import _as_tensor
from .models.derivatives import central_u_ave_coefs, central_x_ave_coefs, lnpi_coefs
from .models.extrap import _poly_eval
from .ops import dispatch, moments, resample
from .ops.moments_cuda import _perturb_sums_plain
from .ops.series import series_neg_log
from .utils.device import default_device
from .utils.trees import tree_flatten, tree_unflatten

__all__ = [
    "ExportedPipeline",
    "StreamingExportedPipeline",
    "bucketed_runner",
    "export_extrap_pipeline",
    "export_gpr_predictor",
    "export_lnpi_pipeline",
    "export_mbar_reweighter",
    "export_perturb_pipeline",
    "export_streaming_extrap_pipeline",
    "export_streaming_lnpi_pipeline",
    "export_streaming_perturb_pipeline",
    "export_streaming_volume_pipeline",
    "export_volume_pipeline",
    "describe_artifact",
    "load_exported",
    "save_exported",
]

_MAGIC = b"THEXTORCH-EXPORT-1"
_MAGIC_BUNDLE = b"THEXTORCH-BUNDLE-1"
# the JAX package's magics: same header contract, StableHLO payloads
_JAX_MAGICS = (b"THEXTPU-EXPORT-1", b"THEXTPU-BUNDLE-1")
_PLATFORMS = ("cpu", "cuda")


def _dtype(name) -> torch.dtype:
    """A torch dtype from a dtype, a numpy dtype or its name."""
    if isinstance(name, torch.dtype):
        return name
    name = name if isinstance(name, str) else np.dtype(name).name
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        msg = f"unknown dtype {name!r}"
        raise ValueError(msg)
    return dt


def _dtype_name(dt: torch.dtype) -> str:
    return str(dt).removeprefix("torch.")


def _check_platforms(platforms) -> tuple[str, ...]:
    platforms = tuple(platforms)
    bad = [p for p in platforms if p not in _PLATFORMS]
    if bad or not platforms:
        msg = f"platforms must be a non-empty subset of {_PLATFORMS}, got {platforms}"
        raise ValueError(msg)
    return platforms


# ---------------------------------------------------------------------------
# tracing and moving programs
# ---------------------------------------------------------------------------


class _Fn(torch.nn.Module):
    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def _do_export(fn, args, dynamic) -> torch.export.ExportedProgram:
    """Trace ``fn(*args)`` into an ``ExportedProgram``, ``dynamic`` holding a
    ``{axis: Dim}`` (or None) per argument.  The trace runs under
    ``backed_size_oblivious``: a dimension of size 1 takes the same program as
    any other, so a ``Dim(min=1)`` stays one symbolic size."""
    import torch.fx.experimental._config as fx_config

    with torch.no_grad(), dispatch.use_impl("torch"), fx_config.patch(backed_size_oblivious=True):
        return torch.export.export(_Fn(fn), tuple(args), dynamic_shapes=(tuple(dynamic),))


def _save_program(ep) -> bytes:
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    return buf.getvalue()


def _load_program(blob: bytes) -> torch.export.ExportedProgram:
    return torch.export.load(io.BytesIO(blob))


class _Programs:
    """One stored (CPU) program and its runnable module per device, built on
    first use by ``move_to_device_pass`` (factory ops carry ``device=`` in
    the graph, so a CPU trace is not a CUDA program by itself)."""

    def __init__(self, ep, platforms):
        self.ep = ep
        self.platforms = tuple(platforms)
        self._mods: dict = {}

    def on(self, device: torch.device):
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        if device.type not in self.platforms:
            msg = f"this artifact was exported for platforms {self.platforms}, not {device.type}"
            raise ValueError(msg)
        key = str(device)
        mod = self._mods.get(key)
        if mod is None:
            from torch.export.passes import move_to_device_pass

            # the pass rewrites the program it is given in place: move a copy, so
            # that the stored CPU program (the one saved, and the CPU's) stays
            if device.type == "cpu":
                ep = self.ep
            else:
                with warnings.catch_warnings():  # torch's own deprecation notes of its tree specs
                    warnings.simplefilter("ignore", FutureWarning)
                    ep = copy.deepcopy(self.ep)
                ep = move_to_device_pass(ep, device)
            mod = self._mods[key] = ep.module()
        return mod


def _call_device(a) -> torch.device:
    """The device a call runs on: a tensor's own, else the default device."""
    return a.device if isinstance(a, torch.Tensor) else default_device()


def _in(a, dt, device):
    """An operand as a tensor of ``dt`` on ``device``."""
    return _as_tensor(a, device).to(dt)


def _seed(seed, device):
    return resample.seed_tensor(int(seed), device)


# ---------------------------------------------------------------------------
# the families' pure functions (traced; plain torch, no kernel)
# ---------------------------------------------------------------------------


def _f64(*arrays):
    return tuple(None if a is None else a.to(torch.float64) for a in arrays)


def _extrap_fn(order: int, beta0: float, minus_log: bool, nrep: int, weighted: bool, xalpha: bool = False, x_is_u: bool = False):
    """The β-extrapolation step: the plain two-pass comoments in float64, the
    series, and with ``nrep`` the count-table bootstrap on the traced Poisson
    draw.  With ``xalpha`` the flat value width packs (order+1 β-derivative
    columns) × (vv values), as in the pipeline."""
    from .pipeline import _xalpha_boot_coefs, _xalpha_mean_coefs

    def _post(c):
        return series_neg_log(c) if minus_log else c

    def fn(uv, xv, betas, weight, seed):
        dt = uv.dtype
        u, x, w = _f64(uv, xv, weight)
        dalpha = betas.double() - beta0
        xave, _uave, du, dxdu = moments.reduce_central_comoments(u, x, order, weight=w)
        if xalpha:
            coefs = _xalpha_mean_coefs(xave, du[:, None], dxdu, order)
        else:
            coefs = central_x_ave_coefs(xave, du[:, None], dxdu, order)
        pred = _poly_eval(_post(coefs), dalpha)
        if not nrep:
            return pred.to(dt)
        counts = resample.philox_poisson1_counts(seed, nrep, uv.shape[0])
        bx, _bu, bdu, bdxdu = resample.resample_central_comoments(u, x, counts, order, weight=w)
        if xalpha:
            bcoefs = _xalpha_boot_coefs(bx, bdu[:, :, None], bdxdu, nrep, order)
        else:
            bcoefs = central_x_ave_coefs(bx, bdu[:, :, None], bdxdu, order)
        std = _poly_eval(_post(bcoefs), dalpha).std(dim=1, correction=0)
        return pred.to(dt), std.to(dt)

    def fn_u(uv, betas, weight, seed):
        # <u>(β) from u-moments alone at order + 1 (the dxdu = du[n+1] view)
        dt = uv.dtype
        u, w = _f64(uv, weight)
        dalpha = betas.double() - beta0
        uave, du_full = moments.reduce_central_umoments(u, order + 1, weight=w)
        pred = _poly_eval(_post(central_u_ave_coefs(uave, du_full, order)), dalpha)
        if not nrep:
            return pred.to(dt)
        counts = resample.philox_poisson1_counts(seed, nrep, uv.shape[0])
        bu, bdu_full = resample.resample_central_umoments_batched(u[None], counts, order + 1, weight=w)
        bcoefs = _post(central_u_ave_coefs(bu[:, 0], bdu_full[..., 0], order))
        return pred.to(dt), _poly_eval(bcoefs, dalpha).std(dim=1, correction=0).to(dt)

    if x_is_u:
        if weighted:
            return fn_u
        return lambda uv, betas, seed: fn_u(uv, betas, None, seed)
    if weighted:
        return fn
    return lambda uv, xv, betas, seed: fn(uv, xv, betas, None, seed)


def _lnpi_fn(order: int, beta0: float, nrep: int):
    """The lnΠ grid step over a flat grid axis ``B`` (the caller reshapes)."""

    def _coefs(uave, du, lnpi0, mudotn):
        return lnpi_coefs(central_u_ave_coefs(uave, du, order - 1), lnpi0, mudotn, order)

    def fn(uv, lnpi0, mudotn, betas, seed):
        dt = uv.dtype
        u, l0, mu = _f64(uv, lnpi0, mudotn)
        dalpha = betas.double() - beta0
        uave, du = moments.reduce_central_umoments(u, order)
        pred = _poly_eval(_coefs(uave, du, l0, mu), dalpha)
        if not nrep:
            return pred.to(dt)
        counts = resample.philox_poisson1_counts(seed, nrep, uv.shape[-1])
        bu, bdu = resample.resample_central_umoments_batched(u, counts, order)
        bpred = _poly_eval(_coefs(bu, bdu, l0[None], mu[None]), dalpha)
        return pred.to(dt), bpred.std(dim=1, correction=0).to(dt)

    return fn


def _volume_fn(volume0: float, ndim: int, nrep: int, weighted: bool):
    """The first-order volume step: ``d<x>/dV = (cov(x, W) + <dxdq>) / (V0
    d)`` from one order-1 comoment reduction over ``x`` and ``dxdq`` stacked
    as a leading value axis of size 2."""
    v0d = float(volume0) * float(ndim)

    def _predict(xave, cov1, dalpha, batch_ndim: int):
        # xave (*b, 2, V): [x means, dxdq means]; cov1 (*b, V) = cov(x, W)
        deriv = (cov1 + xave.select(batch_ndim, 1)) / v0d
        da = dalpha.reshape((-1,) + (1,) * (batch_ndim + 1))
        return xave.select(batch_ndim, 0)[None] + da * deriv[None]

    def fn(wv, xv, dxdqv, volumes, weight, seed):
        dt = wv.dtype
        u, x, d, w = _f64(wv, xv, dxdqv, weight)
        packed = torch.stack([x, d], dim=1)  # (R, 2, V)
        dalpha = volumes.double() - volume0
        xave, _uave, _du, dxdu = moments.reduce_central_comoments(u, packed, 1, weight=w, val_ndim=2)
        pred = _predict(xave, dxdu[1, 0], dalpha, 0)
        if not nrep:
            return pred.to(dt)
        counts = resample.philox_poisson1_counts(seed, nrep, wv.shape[0])
        bx, _bu, _bdu, bdxdu = resample.resample_central_comoments(u, packed, counts, 1, weight=w)
        bpred = _predict(bx, bdxdu[1, :, 0], dalpha, 1)
        return pred.to(dt), bpred.std(dim=1, correction=0).to(dt)

    if weighted:
        return fn
    return lambda wv, xv, dxdqv, volumes, seed: fn(wv, xv, dxdqv, volumes, None, seed)


def _perturb_fn(beta0: float, nrep: int, weighted: bool):
    """The perturbation step through the pipeline's stabilized weights, in
    float64: the prediction's sums as one product over the samples (any
    value width), the bootstrap as the plain K7 contraction on the traced
    counts."""
    from .pipeline import _perturb_weights

    def fn(uv, xv, betas, weight, seed):
        dt = uv.dtype
        u, x, w = _f64(uv, xv, weight)
        e = _perturb_weights(u, betas.double() - beta0, w)
        pred = (e @ x) / e.sum(dim=1)[:, None]
        if not nrep:
            return pred.to(dt)
        counts = resample.philox_poisson1_counts(seed, nrep, uv.shape[0])
        s = _perturb_sums_plain(e, x, counts)  # (A, nrep, V+1)
        v = xv.shape[1]
        bpred = s[..., :v] / s[..., v:]
        return pred.to(dt), bpred.std(dim=1, correction=0).to(dt)

    if weighted:
        return fn
    return lambda uv, xv, betas, seed: fn(uv, xv, betas, None, seed)


def _mbar_fn(tol, max_iter: int, method: str, chunk: int):
    """MBAR solve and α-family reweighting in one program, in the samples'
    type.  The solve is a ``torch.while_loop`` whose body is the in-process
    solver's iteration (``models.mbar._hybrid_step``, or the self-consistent
    update for ``method="sci"``); the α arrive padded to a multiple of
    ``chunk`` and are taken a block at a time by a ``scan``, each block a
    ``(chunk, N)`` temporary."""
    from torch._higher_order_ops.scan import scan

    from .models import mbar

    def _solve(u_kn, log_n_k, tol_):
        zero_it = torch.zeros((), dtype=torch.int64, device=u_kn.device)
        f0 = torch.zeros_like(log_n_k)
        if method == "sci":
            f1 = mbar._self_consistent_update(f0, u_kn, log_n_k)

            def cond(f, f_prev, it):
                return ((f - f_prev).abs().amax() > tol_) & (it < max_iter)

            def body(f, f_prev, it):
                return mbar._self_consistent_update(f, u_kn, log_n_k), f.clone(), it + 1

            f, _f_prev, it = torch.while_loop(cond, body, (f1, f0, zero_it + 1))
            return f, it, mbar._max_abs_residual(f, u_kn, log_n_k, None, None)
        ld0 = mbar._log_denom(f0, u_kn, log_n_k)
        res0 = mbar._max_abs_residual(f0, u_kn, log_n_k, None, ld0)

        def cond(f, ld, res, it):
            return (res > tol_) & (it < max_iter)

        def body(f, ld, res, it):
            return (*mbar._hybrid_step(f, ld, u_kn, log_n_k), it + 1)

        f, _ld, res, it = torch.while_loop(cond, body, (f0, ld0, res0, zero_it))
        return f, it, res

    def fn(u_kn, n_k, alphas, u_base, x_n):
        tol_ = (1e-12 if u_kn.dtype == torch.float64 else 1e-5) if tol is None else float(tol)
        log_n_k = torch.log(n_k)
        f_k, _it, res = _solve(u_kn, log_n_k, tol_)
        ld = mbar._log_denom(f_k, u_kn, log_n_k)
        def block(carry, blk):
            # -(α u + ld) is the grid's -u_targets - ld to the bit
            logw = (blk[:, None] * u_base).add_(ld).neg_()
            w = logw.sub_(torch.logsumexp(logw, dim=-1, keepdim=True)).exp_()
            # a sum over the samples per column, not a product: a float32
            # product over 1e8 samples loses digits
            return carry.clone(), (w[:, :, None] * x_n[None]).sum(dim=1)

        _, out = scan(block, torch.zeros((), dtype=u_kn.dtype, device=u_kn.device), alphas.reshape(-1, chunk))
        return f_k, res, out.reshape(-1, x_n.shape[1])

    return fn


# ---------------------------------------------------------------------------
# batch artifacts
# ---------------------------------------------------------------------------


class ExportedPipeline:
    """A (re)loaded serving artifact: ``meta`` and one exported program.

    ``meta`` carries the static config (family, order, beta0, nrep, ...);
    calling the object runs the program on the device of the samples (a
    tensor's own, else :func:`.default_device`; the first call on a device
    moves the program there).  Operands are cast to the exported dtype;
    ``seed`` and (for the weighted families) ``weight`` are keywords.
    """

    def __init__(self, program: torch.export.ExportedProgram, meta: dict, platforms=_PLATFORMS):
        self._programs = _Programs(program, _check_platforms(platforms))
        self.meta = dict(meta)

    @property
    def platforms(self) -> tuple[str, ...]:
        return self._programs.platforms

    def serialize(self) -> bytes:
        header = json.dumps({**self.meta, "_platforms": list(self.platforms)}, sort_keys=True).encode()
        return _MAGIC + b"\n" + header + b"\n" + _save_program(self._programs.ep)

    def save(self, path) -> None:
        with open(path, "wb") as f:
            f.write(self.serialize())

    # -- calling -----------------------------------------------------------
    def _dt(self):
        return _dtype(self.meta["dtype"])

    def _check_width(self, x2):
        """A pinned value width ``nval`` refuses another width by name."""
        nval = self.meta.get("nval")
        width = nval * (self.meta["order"] + 1) if nval and self.meta.get("xalpha") else nval
        if nval and x2.shape[1] != width:
            msg = f"artifact exported with nval={nval}, got values {tuple(x2.shape)}"
            raise ValueError(msg)
        return x2

    def _weight(self, weight, dt, device):
        if self.meta["weighted"]:
            if weight is None:
                msg = "this artifact was exported weighted=True; pass weight="
                raise ValueError(msg)
            return [_in(weight, dt, device)]
        return []

    def __call__(self, *args, seed: int = 0, weight=None):
        m = self.meta
        dt = self._dt()
        fam = m["family"]
        if weight is not None and not (fam in ("extrap", "perturb", "volume") and m.get("weighted")):
            msg = (
                "this artifact takes no weight operand (export with "
                "weighted=True to serve per-sample weights); refusing to "
                "silently ignore weight="
            )
            raise ValueError(msg)
        if fam not in ("extrap", "perturb", "volume", "lnpi", "mbar", "gpr"):
            msg = f"unknown artifact family {fam!r}"
            raise ValueError(msg)
        device = _call_device(args[0])
        prog = self._programs.on(device)

        def reshape_out(out, shape):
            def r(a):
                return a.reshape(a.shape[:1] + tuple(shape))

            return (r(out[0]), r(out[1])) if m.get("nrep") else r(out)

        if fam == "extrap":
            if m.get("x_is_u"):
                uv, betas = args
                call = [_in(uv, dt, device), torch.atleast_1d(_in(betas, dt, device))]
                call += self._weight(weight, dt, device)
                out = prog(*call, _seed(seed, device))
                return tuple(out) if m["nrep"] else out
            uv, xv, betas = args
            uv = _in(uv, dt, device)
            xv = _in(xv, dt, device)
            if m.get("xalpha"):
                nd = m["order"] + 1
                if xv.ndim < 2 or xv.shape[1] != nd:
                    msg = f"xalpha artifact: xv needs a deriv axis of size order+1={nd} after the sample axis, got {tuple(xv.shape)}"
                    raise ValueError(msg)
                val_shape = tuple(xv.shape[2:])
                xv = xv.reshape(xv.shape[0], -1)
            else:
                val_shape = None
                if xv.ndim == 1:
                    xv = xv[:, None]
            call = [uv, self._check_width(xv), torch.atleast_1d(_in(betas, dt, device)), *self._weight(weight, dt, device)]
            out = prog(*call, _seed(seed, device))
            if val_shape is not None:
                return reshape_out(out, val_shape)
            return tuple(out) if m["nrep"] else out
        if fam == "perturb":
            uv, xv, betas = args
            xv = _in(xv, dt, device)
            val_shape = tuple(xv.shape[1:])
            xv = xv.reshape(xv.shape[0], -1) if xv.ndim != 1 else xv[:, None]
            call = [_in(uv, dt, device), self._check_width(xv), torch.atleast_1d(_in(betas, dt, device))]
            call += self._weight(weight, dt, device)
            return reshape_out(prog(*call, _seed(seed, device)), val_shape)
        if fam == "volume":
            wv, xv, dxdqv, volumes = args
            xv = _in(xv, dt, device)
            dxdqv = _in(dxdqv, dt, device)
            if xv.shape != dxdqv.shape:
                msg = f"xv {tuple(xv.shape)} and dxdqv {tuple(dxdqv.shape)} must match"
                raise ValueError(msg)
            val_shape = tuple(xv.shape[1:])
            xv = xv.reshape(xv.shape[0], -1) if xv.ndim != 1 else xv[:, None]
            dxdqv = dxdqv.reshape(dxdqv.shape[0], -1) if dxdqv.ndim != 1 else dxdqv[:, None]
            call = [_in(wv, dt, device), self._check_width(xv), dxdqv, torch.atleast_1d(_in(volumes, dt, device))]
            call += self._weight(weight, dt, device)
            return reshape_out(prog(*call, _seed(seed, device)), val_shape)
        if fam == "lnpi":
            uv, lnpi0, mudotn, betas = args
            uv = _in(uv, dt, device)
            grid = tuple(uv.shape[:-1])
            out = prog(
                uv.reshape(-1, uv.shape[-1]),
                _in(lnpi0, dt, device).reshape(-1),
                _in(mudotn, dt, device).reshape(-1),
                torch.atleast_1d(_in(betas, dt, device)),
                _seed(seed, device),
            )
            return reshape_out(out, grid)
        if fam == "mbar":
            u_kn, n_k, alphas, u_base, x_n = args
            u_kn = _in(u_kn, dt, device)
            if u_kn.shape[0] != m["k_states"]:
                msg = f"artifact exported for K={m['k_states']} states, got u_kn {tuple(u_kn.shape)}"
                raise ValueError(msg)
            x_n = _in(x_n, dt, device)
            squeeze = x_n.ndim == 1
            if squeeze:
                x_n = x_n[:, None]
            alphas = torch.atleast_1d(_in(alphas, dt, device))
            a = alphas.shape[0]
            a_pad = torch.cat([alphas, alphas[-1:].expand(-a % m["chunk"])])
            f_k, res, out = prog(u_kn, _in(n_k, dt, device), a_pad, _in(u_base, dt, device), x_n)
            return f_k, res, (out[:a, 0] if squeeze else out[:a])
        (locs,) = args
        locs = _in(locs, dt, device)
        if locs.ndim == 1:
            if m["obs_dims"] != 1:
                msg = f"locs must be (M, {m['obs_dims']}) for this model"
                raise ValueError(msg)
            locs = locs[:, None]
        return tuple(prog(locs))


def _dims(spec: str):
    return {n.strip(): Dim(n.strip(), min=1) for n in spec.split(",")}


def export_extrap_pipeline(
    order: int,
    beta0: float,
    *,
    minus_log: bool = False,
    xalpha: bool = False,
    x_is_u: bool = False,
    nrep: int = 0,
    weighted: bool = False,
    nval: int | None = None,
    dtype=torch.float32,
    platforms=_PLATFORMS,
) -> ExportedPipeline:
    r"""Export the β-extrapolation pipeline as an artifact, shape-polymorphic
    in the sample count ``R`` and the query count ``A``, and in the value
    width ``V`` unless ``nval`` pins it.

    Parameters mirror :func:`.pipeline.make_extrap_pipeline`: ``order`` /
    ``beta0`` static, ``minus_log``, ``xalpha`` (the artifact takes ``xv (R,
    order+1, *val)`` and returns ``(A, *val)``), ``x_is_u`` (``art(uv,
    betas)``), ``nrep`` bootstrap replicates on Poisson(1) counts drawn in
    the program from the call's ``seed`` (K3's counts at that seed),
    ``weighted`` (a per-sample ``weight=`` operand).  ``dtype``: the
    operands' and outputs' type.  ``platforms``: the devices the artifact
    may run on, of ``("cpu", "cuda")``.
    """
    if x_is_u and xalpha:
        msg = "x_is_u and xalpha are mutually exclusive"
        raise ValueError(msg)
    dt = _dtype(dtype)
    d = _dims("R, A, V")
    r, a = 5, 3
    args = [torch.linspace(0.5, 1.5, r, dtype=dt)]
    dyn = [{0: d["R"]}]
    if not x_is_u:
        v = nval or 2
        width = (order + 1) * v if xalpha else v
        args.append(torch.linspace(1.0, 2.0, r * width, dtype=dt).reshape(r, width))
        vdim = None if nval else ((order + 1) * d["V"] if xalpha else d["V"])
        dyn.append({0: d["R"]} if vdim is None else {0: d["R"], 1: vdim})
    args.append(torch.linspace(0.9, 1.1, a, dtype=dt))
    dyn.append({0: d["A"]})
    if weighted:
        args.append(torch.ones(r, dtype=dt))
        dyn.append({0: d["R"]})
    args.append(resample.seed_tensor(0))
    dyn.append(None)
    fn = _extrap_fn(order, beta0, minus_log, nrep, weighted, xalpha, x_is_u)
    meta = {
        "family": "extrap",
        "order": order,
        "beta0": beta0,
        "minus_log": minus_log,
        "xalpha": xalpha,
        "x_is_u": x_is_u,
        "nrep": nrep,
        "weighted": weighted,
        "nval": nval,
        "dtype": _dtype_name(dt),
    }
    return ExportedPipeline(_do_export(fn, args, dyn), meta, platforms)


def export_lnpi_pipeline(order: int, beta0: float, *, nrep: int = 0, dtype=torch.float32, platforms=_PLATFORMS) -> ExportedPipeline:
    r"""Export the lnΠ grid pipeline (:func:`.pipeline.make_lnpi_pipeline`)
    as an artifact, shape-polymorphic in the flattened grid size ``B``, the
    sample count ``R`` and the query count ``A``.  The artifact takes ``uv
    (*grid, R)`` and reshapes for you; with ``nrep`` one count per
    (replicate, configuration) is shared by the grid (K5's counts at the
    call's seed)."""
    if order < 1:
        msg = f"lnPi order must be >= 1, got {order}"
        raise ValueError(msg)
    dt = _dtype(dtype)
    d = _dims("B, R, A")
    b, r, a = 4, 5, 3
    args = [
        torch.linspace(0.5, 1.5, b * r, dtype=dt).reshape(b, r),
        torch.zeros(b, dtype=dt),
        torch.zeros(b, dtype=dt),
        torch.linspace(0.9, 1.1, a, dtype=dt),
        resample.seed_tensor(0),
    ]
    dyn = [{0: d["B"], 1: d["R"]}, {0: d["B"]}, {0: d["B"]}, {0: d["A"]}, None]
    meta = {"family": "lnpi", "order": order, "beta0": beta0, "nrep": nrep, "dtype": _dtype_name(dt)}
    return ExportedPipeline(_do_export(_lnpi_fn(order, beta0, nrep), args, dyn), meta, platforms)


def _rva_args(dt, nval, n_values: int, d):
    """Example operands ``uv (R,)``, ``n_values`` value arrays ``(R, V)`` and
    ``(A,)`` targets, with their dynamic dims."""
    r, a, v = 5, 3, nval or 2
    args = [torch.linspace(0.5, 1.5, r, dtype=dt)]
    args += [torch.linspace(1.0, 2.0, r * v, dtype=dt).reshape(r, v) + k for k in range(n_values)]
    args.append(torch.linspace(0.9, 1.1, a, dtype=dt))
    vdyn = {0: d["R"]} if nval else {0: d["R"], 1: d["V"]}
    return args, [{0: d["R"]}] + [vdyn] * n_values + [{0: d["A"]}]


def export_perturb_pipeline(
    beta0: float, *, nrep: int = 0, weighted: bool = False, nval: int | None = None, dtype=torch.float32, platforms=_PLATFORMS
) -> ExportedPipeline:
    r"""Export the exponential-reweighting perturbation pipeline
    (:func:`.pipeline.make_perturb_pipeline`) as an artifact,
    shape-polymorphic in ``R``, ``A`` and (unless ``nval`` pins it) ``V``.

    ``art(uv, xv, betas[, weight=], seed=0)`` → ``pred (A, *val)`` or
    ``(pred, std)`` with ``nrep`` replicates on the counts K8 draws at
    ``seed``, as a ``(nrep, R)`` table inside the program (moderate-R
    serving)."""
    dt = _dtype(dtype)
    d = _dims("R, A, V")
    args, dyn = _rva_args(dt, nval, 1, d)
    if weighted:
        args.append(torch.ones(args[0].shape[0], dtype=dt))
        dyn.append({0: d["R"]})
    args.append(resample.seed_tensor(0))
    dyn.append(None)
    meta = {"family": "perturb", "beta0": beta0, "nrep": nrep, "weighted": weighted, "nval": nval, "dtype": _dtype_name(dt)}
    return ExportedPipeline(_do_export(_perturb_fn(beta0, nrep, weighted), args, dyn), meta, platforms)


def export_volume_pipeline(
    volume0: float,
    *,
    ndim: int = 3,
    nrep: int = 0,
    weighted: bool = False,
    nval: int | None = None,
    dtype=torch.float32,
    platforms=_PLATFORMS,
) -> ExportedPipeline:
    r"""Export the first-order volume extrapolation
    (:func:`.pipeline.make_volume_pipeline`) as an artifact,
    shape-polymorphic in ``R``, ``A`` and (unless ``nval`` pins it) ``V``:
    ``art(wv, xv, dxdqv, volumes[, weight=], seed=0)`` with ``wv (R,)`` the
    temperature-scaled virial and ``xv`` / ``dxdqv (R, *val)`` (a bare
    ``(R,)`` for a scalar observable)."""
    dt = _dtype(dtype)
    d = _dims("R, A, V")
    args, dyn = _rva_args(dt, nval, 2, d)
    if weighted:
        args.append(torch.ones(args[0].shape[0], dtype=dt))
        dyn.append({0: d["R"]})
    args.append(resample.seed_tensor(0))
    dyn.append(None)
    meta = {
        "family": "volume",
        "volume0": volume0,
        "ndim": ndim,
        "nrep": nrep,
        "weighted": weighted,
        "nval": nval,
        "dtype": _dtype_name(dt),
    }
    return ExportedPipeline(_do_export(_volume_fn(volume0, ndim, nrep, weighted), args, dyn), meta, platforms)


def export_gpr_predictor(model, d_new=None, *, dtype=torch.float32, mean_new_fn=None, platforms=_PLATFORMS) -> ExportedPipeline:
    r"""Export a trained GPR as a serving artifact: the posterior of
    :func:`.gpr_active.serving.freeze_predictor` (frozen in float64 on the
    GPR device, constants in ``dtype``), shape-polymorphic in the query
    count ``M``.  The serving process calls ``art(locs) -> (mean, var)``,
    each ``(M, out_dim)``.  The program is traced on the device of the
    freeze and stored with its constants on the CPU; a sympy mean function
    is lambdified at freeze time, so serving needs no sympy.  ``d_new`` /
    ``mean_new_fn``: as in ``freeze_predictor`` (one artifact per served
    derivative order)."""
    from .gpr_active.serving import freeze_predictor

    dt = _dtype(dtype)
    pred = freeze_predictor(model, d_new, dtype=dt, mean_new_fn=mean_new_fn)
    locs = torch.linspace(0.5, 1.5, 5 * pred.obs_dims, dtype=dt, device=pred.device).reshape(5, pred.obs_dims)
    ep = _do_export(pred.predict_fn, [locs], [{0: Dim("M", min=1)}])
    if pred.device.type != "cpu":
        from torch.export.passes import move_to_device_pass

        ep = move_to_device_pass(ep, "cpu")  # an artifact stores the CPU program
    meta = {"family": "gpr", **pred.meta, "d_new": list(pred.meta["d_new"])}
    return ExportedPipeline(ep, meta, platforms)


def export_mbar_reweighter(
    k_states: int,
    *,
    tol: float | None = None,
    max_iter: int = 1000,
    method: str = "hybrid",
    chunk: int = 8,
    dtype=torch.float32,
    platforms=_PLATFORMS,
) -> ExportedPipeline:
    r"""Export the MBAR solve and reweighting as an artifact.

    The program takes ``(u_kn (K, N), n_k (K,), alphas (A,), u_base (N,),
    x_n (N, V))``, solves the free energies with the Newton /
    self-consistent hybrid (``method="hybrid"``) or the plain fixed point
    (``"sci"``) inside a ``torch.while_loop``, and evaluates ``<x>`` at every
    target ``alpha * u_base`` in ``chunk``-sized blocks (the ``(A, N)``
    weight matrix never exists).  Returns ``(f_k, residual, out (A, V))``.
    Shape-polymorphic in ``N``, ``V`` and the α count (a multiple of
    ``chunk`` inside the program: the call pads with the last α and slices);
    ``k_states`` is static.  ``tol`` defaults as in
    :func:`.models.mbar.mbar_solve`.
    """
    if k_states < 2:
        msg = f"need k_states >= 2, got {k_states}"
        raise ValueError(msg)
    if method not in ("hybrid", "sci"):
        msg = f"unknown MBAR method {method!r} (use 'hybrid' or 'sci')"
        raise ValueError(msg)
    dt = _dtype(dtype)
    d = _dims("N, V, AC")
    n = 9
    base = torch.linspace(0.5, 1.5, n, dtype=dt)
    args = [
        torch.stack([base * (1.0 + 0.5 * k) for k in range(k_states)]),
        torch.full((k_states,), n / k_states, dtype=dt),
        torch.linspace(0.8, 1.2, 2 * chunk, dtype=dt),
        base,
        torch.stack([base, base * base], dim=1),
    ]
    dyn = [{1: d["N"]}, None, {0: chunk * d["AC"]}, {0: d["N"]}, {0: d["N"], 1: d["V"]}]
    meta = {
        "family": "mbar",
        "k_states": k_states,
        "tol": tol,
        "max_iter": max_iter,
        "method": method,
        "chunk": chunk,
        "dtype": _dtype_name(dt),
    }
    return ExportedPipeline(_do_export(_mbar_fn(tol, max_iter, method, chunk), args, dyn), meta, platforms)


def bucketed_runner(artifact: ExportedPipeline, buckets=None):
    r"""Serve any ``R`` from an artifact through a few fixed sample counts.

    Each request is padded up to the smallest bucket with **zero-weight**
    samples (exact, as :func:`.pipeline.make_bucketed_extrap_runner`), so a
    deployment sees at most ``len(buckets)`` shapes.  Requires an
    ``extrap``, ``perturb`` or ``volume`` artifact exported with
    ``weighted=True``.  ``buckets`` defaults to ``2^12 .. 2^27``; a request
    above the largest runs at its own length.

    Returns ``serve(uv, xv, betas, weight=None, seed=0)`` (extrap /
    perturb), ``serve(uv, betas, weight=None, seed=0)`` for an ``x_is_u``
    artifact, or ``serve(wv, xv, dxdqv, volumes, weight=None, seed=0)`` for a
    volume artifact.
    """
    from .pipeline import bucket_pad, normalize_buckets

    m = artifact.meta
    if m["family"] not in ("extrap", "perturb", "volume") or not m["weighted"]:
        msg = (
            "bucketed_runner needs an extrap, perturb, or volume artifact "
            f"exported with weighted=True, got family={m['family']!r} "
            f"weighted={m.get('weighted')}"
        )
        raise ValueError(msg)
    buckets = normalize_buckets(buckets)

    def _cols(x):
        x = _as_tensor(x)
        return x[:, None] if x.ndim == 1 else x

    if m["family"] == "volume":

        def serve(wv, xv, dxdqv, volumes, weight=None, seed=0):
            wvp, (xvp, dxp), wp = bucket_pad(wv, (_cols(xv), _cols(dxdqv)), weight, buckets)
            return artifact(wvp, xvp, dxp, volumes, weight=wp, seed=seed)

    elif m.get("x_is_u"):

        def serve(uv, betas, weight=None, seed=0):
            uvp, _xvp, wp = bucket_pad(uv, None, weight, buckets)
            return artifact(uvp, betas, weight=wp, seed=seed)

    else:

        def serve(uv, xv, betas, weight=None, seed=0):
            uvp, xvp, wp = bucket_pad(uv, _cols(xv), weight, buckets)
            return artifact(uvp, xvp, betas, weight=wp, seed=seed)

    serve.buckets = buckets
    return serve


# ---------------------------------------------------------------------------
# streaming bundles
# ---------------------------------------------------------------------------


def _encode_state(state):
    """``(spec, blob)``: each leaf's dtype name and shape, and its raw bytes
    (bfloat16 as its 16-bit pattern)."""
    spec, parts = [], []
    for a in state:
        t = a.detach().cpu().contiguous()
        spec.append([_dtype_name(t.dtype), list(t.shape)])
        raw = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
        parts.append(raw.numpy().tobytes())
    return spec, b"".join(parts)


def _decode_state(spec, blob: bytes, device=None):
    out, off = [], 0
    device = default_device() if device is None else device
    for name, shape in spec:
        dt = _dtype(name)
        raw_dt = torch.int16 if dt == torch.bfloat16 else dt
        n = math.prod(shape) * torch.empty((), dtype=raw_dt).element_size()
        raw = torch.frombuffer(bytearray(blob[off : off + n]), dtype=raw_dt) if n else torch.empty(0, dtype=raw_dt)
        t = raw.view(dt) if raw_dt != dt else raw
        out.append(t.reshape(shape).to(device))
        off += n
    return tuple(out)


class StreamingExportedPipeline:
    r"""A streaming serving bundle: ``update`` and ``predict`` programs and
    the initial accumulator state, in one file.

    The state crosses the boundary as a flat tuple of tensors, so the
    serving process needs no package state code:

    >>> art = export_streaming_extrap_pipeline(2, 1.0)       # doctest: +SKIP
    >>> state = art.init_state()                             # doctest: +SKIP
    >>> state = art.update(state, uv_chunk, xv_chunk)        # doctest: +SKIP
    >>> pred = art.predict(state, betas)                     # doctest: +SKIP

    ``update`` is shape-polymorphic in the chunk length ``R`` and
    ``predict`` in the query count ``A``; the state's shapes are static.
    Calls run on the state's device (chunks are sent there).
    :meth:`save_state` / :meth:`load_state` checkpoint a state tuple, any
    leaf type (bfloat16 included).
    """

    def __init__(self, update_ep, predict_ep, state0, meta: dict, platforms=_PLATFORMS):
        platforms = _check_platforms(platforms)
        self._upd = _Programs(update_ep, platforms)
        self._prd = _Programs(predict_ep, platforms)
        self._state0 = tuple(t.detach().cpu() for t in state0)
        self.meta = dict(meta)

    @property
    def platforms(self) -> tuple[str, ...]:
        return self._upd.platforms

    def _dt(self):
        return _dtype(self.meta["dtype"])

    def init_state(self, device=None) -> tuple:
        """A fresh empty state on ``device`` (the default device when None)."""
        device = default_device() if device is None else device
        return tuple(t.clone().to(device) for t in self._state0)

    def update(self, state, uv, xv=None, weight=None, dxdqv=None):
        """Fold one sample chunk into ``state``; returns the new state.

        Extrap bundles: ``update(state, uv, xv[, weight=])`` (``xv`` omitted
        for ``x_is_u``); lnΠ bundles: ``update(state, uv_grid)``; volume
        bundles: ``update(state, wv, xv, dxdqv=...[, weight=])``; perturb
        bundles: ``update(state, uv, xv[, weight=])``.
        """
        m = self.meta
        dt = self._dt()
        state = tuple(state)
        device = state[0].device
        uv = _in(uv, dt, device)
        args = list(state)
        fam = m["family"]
        if dxdqv is not None and fam != "streaming_volume":
            msg = "dxdqv= is only for streaming_volume bundles"
            raise ValueError(msg)
        if fam == "streaming_lnpi":
            if xv is not None or weight is not None:
                msg = "lnPi streaming update takes only (state, uv_grid)"
                raise ValueError(msg)
            args.append(uv.reshape(*m["grid_shape"], uv.shape[-1]))
            return tuple(self._upd.on(device)(*args))
        val_shape = tuple(m.get("val_shape", ()))
        if fam == "streaming_volume":
            if xv is None or dxdqv is None:
                msg = "volume streaming update takes (state, wv, xv, dxdqv=...[, weight=])"
                raise ValueError(msg)
            args += [uv, _in(xv, dt, device).reshape(uv.shape[0], *val_shape), _in(dxdqv, dt, device).reshape(uv.shape[0], *val_shape)]
        elif m.get("x_is_u"):
            if xv is not None:
                msg = "x_is_u streaming update takes (state, uv[, weight=])"
                raise ValueError(msg)
            args.append(uv)
        else:
            if xv is None:
                fam_name = fam.removeprefix("streaming_")
                msg = f"{fam_name} streaming update takes (state, uv, xv[, weight=])"
                raise ValueError(msg)
            if m.get("xalpha"):
                val_shape = (m["order"] + 1, *val_shape)
            args += [uv, _in(xv, dt, device).reshape(uv.shape[0], *val_shape)]
        if m["weighted"]:
            if weight is None:
                msg = "this artifact was exported weighted=True; pass weight="
                raise ValueError(msg)
            args.append(_in(weight, dt, device))
        elif weight is not None:
            msg = "this artifact takes no weight operand (export with weighted=True); refusing to silently ignore weight="
            raise ValueError(msg)
        return tuple(self._upd.on(device)(*args))

    def predict(self, state, *args):
        """Extrap / volume: ``predict(state, betas)``; lnΠ: ``predict(state,
        lnpi0, mudotn, betas)``; perturb: ``predict(state)`` (the targets are
        baked into the bundle).  Returns ``pred`` or ``(pred, std)`` with
        ``nrep > 0``, float64 as the in-process pipelines'."""
        m = self.meta
        dt = self._dt()
        state = tuple(state)
        device = state[0].device
        if m["family"] == "streaming_perturb":
            if args:
                msg = "perturb streaming predict takes only (state): the target betas are baked into the artifact"
                raise ValueError(msg)
            call = list(state)
        elif m["family"] == "streaming_lnpi":
            lnpi0, mudotn, betas = args
            grid = tuple(m["grid_shape"])
            call = [
                *state,
                _in(lnpi0, dt, device).reshape(grid),
                _in(mudotn, dt, device).reshape(grid),
                torch.atleast_1d(_in(betas, dt, device)),
            ]
        else:
            (betas,) = args
            call = [*state, torch.atleast_1d(_in(betas, dt, device))]
        out = self._prd.on(device)(*call)
        return tuple(out) if isinstance(out, (tuple, list)) else out

    # -- state persistence ---------------------------------------------------
    def save_state(self, path, state) -> None:
        """Checkpoint a state tuple (any leaf dtype, bfloat16 included)."""
        spec, blob = _encode_state(state)
        with open(path, "wb") as f:
            f.write(json.dumps(spec).encode() + b"\n" + blob)

    def load_state(self, path, device=None) -> tuple:
        """Reload a :meth:`save_state` checkpoint onto ``device`` (the
        default device when None)."""
        with open(path, "rb") as f:
            head, blob = f.read().split(b"\n", 1)
        return _decode_state(json.loads(head.decode()), blob, device)

    # -- persistence ---------------------------------------------------------
    def serialize(self) -> bytes:
        u = _save_program(self._upd.ep)
        p = _save_program(self._prd.ep)
        spec, s = _encode_state(self._state0)
        header = {**self.meta, "_sizes": [len(u), len(p), len(s)], "_state_spec": spec, "_platforms": list(self.platforms)}
        return _MAGIC_BUNDLE + b"\n" + json.dumps(header, sort_keys=True).encode() + b"\n" + u + p + s

    def save(self, path) -> None:
        with open(path, "wb") as f:
            f.write(self.serialize())

    @classmethod
    def _from_payload(cls, header: dict, payload: bytes):
        nu, np_, ns = header.pop("_sizes")
        spec = header.pop("_state_spec")
        platforms = header.pop("_platforms", _PLATFORMS)
        upd = _load_program(payload[:nu])
        prd = _load_program(payload[nu : nu + np_])
        state0 = _decode_state(spec, payload[nu + np_ : nu + np_ + ns], "cpu")
        return cls(upd, prd, state0, header, platforms)


def _export_streaming(factory, factory_kwargs, meta, upd_args, upd_dyn, prd_args, prd_dyn, platforms):
    """Trace the in-process streaming pipeline's ``xla_only=True`` update and
    predict over a flat state tuple (on the CPU, plain torch: no kernel in
    the bundle), the chunk length and the query count symbolic."""
    state0, update, predict = factory(xla_only=True, device="cpu", **factory_kwargs)
    leaves0, treedef = tree_flatten(state0)
    n = len(leaves0)

    def upd_flat(*args):
        st = tree_unflatten(treedef, list(args[:n]))
        return tuple(tree_flatten(update(st, *args[n:]))[0])

    def pred_flat(*args):
        return predict(tree_unflatten(treedef, list(args[:n])), *args[n:])

    state_dyn = [None] * n
    upd = _do_export(upd_flat, [*leaves0, *upd_args], state_dyn + upd_dyn)
    prd = _do_export(pred_flat, [*leaves0, *prd_args], state_dyn + prd_dyn)
    return StreamingExportedPipeline(upd, prd, leaves0, meta, platforms)


def _chunk(dt, r: int, *shape, lo=0.5):
    return torch.linspace(lo, lo + 1.0, r * math.prod(shape), dtype=dt).reshape(r, *shape)


def export_streaming_extrap_pipeline(
    order: int,
    beta0: float,
    *,
    minus_log: bool = False,
    xalpha: bool = False,
    x_is_u: bool = False,
    val_shape: tuple = (),
    nrep: int = 0,
    seed: int = 0,
    weighted: bool = False,
    dtype=torch.float32,
    platforms=_PLATFORMS,
) -> StreamingExportedPipeline:
    r"""Export the streaming β-extrapolation pipeline
    (:func:`.pipeline.make_streaming_extrap_pipeline`) as a bundle:
    ``update`` (polymorphic in the chunk length ``R``), ``predict``
    (polymorphic in the query count ``A``) and the initial state, whose
    type is ``dtype``.  The programs are the in-process ``xla_only=True``
    route: with ``nrep`` each chunk's counts are those K3 (K5 with
    ``x_is_u``) draws at ``(seed, chunk index)``, the chunk index carried
    in the state, so the bundle's fold equals the in-process
    ``xla_only=True`` stream at equal seed."""
    dt = _dtype(dtype)
    val_shape = tuple(int(s) for s in val_shape)
    chunk_val = (order + 1, *val_shape) if xalpha else val_shape
    d = _dims("R, A")
    r = 6
    upd_args = [torch.linspace(0.5, 1.5, r, dtype=dt)]
    upd_dyn = [{0: d["R"]}]
    if not x_is_u:
        upd_args.append(_chunk(dt, r, *chunk_val, lo=1.0))
        upd_dyn.append({0: d["R"]})
    if weighted:
        upd_args.append(torch.ones(r, dtype=dt))
        upd_dyn.append({0: d["R"]})
    meta = {
        "family": "streaming_extrap",
        "order": order,
        "beta0": beta0,
        "minus_log": minus_log,
        "xalpha": xalpha,
        "x_is_u": x_is_u,
        "val_shape": list(val_shape),
        "nrep": nrep,
        "seed": seed,
        "weighted": weighted,
        "dtype": _dtype_name(dt),
    }
    from .pipeline import make_streaming_extrap_pipeline

    kwargs = dict(order=order, beta0=beta0, minus_log=minus_log, xalpha=xalpha, x_is_u=x_is_u, val_shape=val_shape, dtype=dt, nrep=nrep, seed=seed)
    return _export_streaming(
        make_streaming_extrap_pipeline, kwargs, meta, upd_args, upd_dyn, [torch.linspace(0.9, 1.1, 3, dtype=dt)], [{0: d["A"]}], platforms
    )


def export_streaming_volume_pipeline(
    volume0: float,
    *,
    ndim: int = 3,
    val_shape: tuple = (),
    nrep: int = 0,
    seed: int = 0,
    weighted: bool = False,
    dtype=torch.float32,
    platforms=_PLATFORMS,
) -> StreamingExportedPipeline:
    r"""Export the streaming volume pipeline
    (:func:`.pipeline.make_streaming_volume_pipeline`) as a bundle:
    ``update(state, wv, xv, dxdqv=...[, weight=])`` (polymorphic in ``R``),
    ``predict(state, volumes)`` (polymorphic in ``A``) and the initial
    state."""
    dt = _dtype(dtype)
    val_shape = tuple(int(s) for s in val_shape)
    d = _dims("R, A")
    r = 6
    upd_args = [torch.linspace(0.5, 1.5, r, dtype=dt), _chunk(dt, r, *val_shape, lo=1.0), _chunk(dt, r, *val_shape, lo=2.0)]
    upd_dyn = [{0: d["R"]}] * 3
    if weighted:
        upd_args.append(torch.ones(r, dtype=dt))
        upd_dyn.append({0: d["R"]})
    meta = {
        "family": "streaming_volume",
        "volume0": volume0,
        "ndim": ndim,
        "val_shape": list(val_shape),
        "nrep": nrep,
        "seed": seed,
        "weighted": weighted,
        "dtype": _dtype_name(dt),
    }
    from .pipeline import make_streaming_volume_pipeline

    kwargs = dict(volume0=volume0, ndim=ndim, val_shape=val_shape, dtype=dt, nrep=nrep, seed=seed)
    return _export_streaming(
        make_streaming_volume_pipeline, kwargs, meta, upd_args, upd_dyn, [torch.linspace(1.9, 2.1, 3, dtype=dt)], [{0: d["A"]}], platforms
    )


def export_streaming_perturb_pipeline(
    beta0: float,
    betas,
    *,
    val_shape: tuple = (),
    nrep: int = 0,
    seed: int = 0,
    weighted: bool = False,
    dtype=torch.float32,
    platforms=_PLATFORMS,
) -> StreamingExportedPipeline:
    r"""Export the streaming perturbation pipeline
    (:func:`.pipeline.make_streaming_perturb_pipeline`) as a bundle:
    ``update(state, uv, xv[, weight=])`` (polymorphic in ``R``; the
    running-maximum rescale lives in the program; with ``nrep`` the counts
    K8 draws at ``(seed, chunk index)``), ``predict(state)`` and the initial
    state.  The target β's are baked into the bundle."""
    dt = _dtype(dtype)
    val_shape = tuple(int(s) for s in val_shape)
    betas_l = [float(b) for b in np.atleast_1d(np.asarray(betas, dtype=np.float64))]
    d = _dims("R")
    r = 6
    upd_args = [torch.linspace(0.5, 1.5, r, dtype=dt), _chunk(dt, r, *val_shape, lo=1.0)]
    upd_dyn = [{0: d["R"]}] * 2
    if weighted:
        upd_args.append(torch.ones(r, dtype=dt))
        upd_dyn.append({0: d["R"]})
    meta = {
        "family": "streaming_perturb",
        "beta0": beta0,
        "betas": betas_l,
        "val_shape": list(val_shape),
        "nrep": nrep,
        "seed": seed,
        "weighted": weighted,
        "dtype": _dtype_name(dt),
    }
    from .pipeline import make_streaming_perturb_pipeline

    kwargs = dict(beta0=beta0, betas=torch.tensor(betas_l, dtype=dt), val_shape=val_shape, dtype=dt, nrep=nrep, seed=seed)
    return _export_streaming(make_streaming_perturb_pipeline, kwargs, meta, upd_args, upd_dyn, [], [], platforms)


def export_streaming_lnpi_pipeline(
    order: int,
    beta0: float,
    *,
    grid_shape: tuple,
    nrep: int = 0,
    seed: int = 0,
    dtype=torch.float32,
    platforms=_PLATFORMS,
) -> StreamingExportedPipeline:
    r"""Export the streaming lnΠ grid pipeline
    (:func:`.pipeline.make_streaming_lnpi_pipeline`) as a bundle.  The grid
    shape is static; the chunk length ``R`` and the query count ``A`` are
    symbolic.  ``update(state, uv)`` takes ``uv (*grid_shape, R)``;
    ``predict(state, lnpi0, mudotn, betas)``."""
    if order < 1:
        msg = f"lnPi order must be >= 1, got {order}"
        raise ValueError(msg)
    dt = _dtype(dtype)
    grid_shape = tuple(int(s) for s in grid_shape)
    d = _dims("R, A")
    r = 6
    g = math.prod(grid_shape)
    upd_args = [torch.linspace(0.5, 1.5, g * r, dtype=dt).reshape(*grid_shape, r)]
    upd_dyn = [{len(grid_shape): d["R"]}]
    prd_args = [torch.zeros(grid_shape, dtype=dt), torch.zeros(grid_shape, dtype=dt), torch.linspace(0.9, 1.1, 3, dtype=dt)]
    prd_dyn = [None, None, {0: d["A"]}]
    meta = {
        "family": "streaming_lnpi",
        "order": order,
        "beta0": beta0,
        "grid_shape": list(grid_shape),
        "nrep": nrep,
        "seed": seed,
        "dtype": _dtype_name(dt),
    }
    from .pipeline import make_streaming_lnpi_pipeline

    kwargs = dict(order=order, beta0=beta0, grid_shape=grid_shape, dtype=dt, nrep=nrep, seed=seed)
    return _export_streaming(make_streaming_lnpi_pipeline, kwargs, meta, upd_args, upd_dyn, prd_args, prd_dyn, platforms)


# ---------------------------------------------------------------------------
# files
# ---------------------------------------------------------------------------


def save_exported(artifact, path) -> None:
    """Write an artifact to ``path`` (header and program bytes)."""
    artifact.save(path)


def describe_artifact(path) -> dict:
    """The header of an artifact file, WITHOUT loading its programs.

    Returns the header metadata plus ``kind`` (``"batch"`` /
    ``"streaming"``), ``file_bytes`` and ``format`` (``"torch"``, or
    ``"jax"`` for an artifact of the JAX package, whose header is the same
    contract).  CLI: ``python -m thermoextrap_tpu_torch.serving_export
    ARTIFACT [...]`` prints one JSON line per file.
    """
    with open(path, "rb") as f:
        magic = f.readline().rstrip(b"\n")
        if magic not in (_MAGIC, _MAGIC_BUNDLE, *_JAX_MAGICS):
            msg = f"{path}: not a thermoextrap_tpu export artifact"
            raise ValueError(msg)
        header = json.loads(f.readline().decode())
    for k in ("_state_spec", "_sizes", "_platforms"):
        header.pop(k, None)
    header["kind"] = "streaming" if magic in (_MAGIC_BUNDLE, _JAX_MAGICS[1]) else "batch"
    header["format"] = "jax" if magic in _JAX_MAGICS else "torch"
    header["file_bytes"] = os.path.getsize(path)
    return header


def load_exported(path) -> ExportedPipeline | StreamingExportedPipeline:
    """Reload an artifact written by :func:`save_exported` / ``.save``.

    Dispatches on the file magic: a single program gives an
    :class:`ExportedPipeline` (callable), a bundle a
    :class:`StreamingExportedPipeline` (``init_state`` / ``update`` /
    ``predict``).  Nothing is traced: the programs are read as stored and
    moved to a device on their first call there.
    """
    with open(path, "rb") as f:
        raw = f.read()
    parts = raw.split(b"\n", 2)
    if len(parts) == 3 and parts[0] in _JAX_MAGICS:
        msg = f"{path}: a JAX artifact of thermoextrap_tpu (StableHLO); load it with thermoextrap_tpu.serving_export"
        raise ValueError(msg)
    if len(parts) != 3 or parts[0] not in (_MAGIC, _MAGIC_BUNDLE):
        msg = f"{path}: not a thermoextrap_tpu export artifact"
        raise ValueError(msg)
    magic, header, payload = parts
    meta = json.loads(header.decode())
    if magic == _MAGIC_BUNDLE:
        return StreamingExportedPipeline._from_payload(meta, payload)
    platforms = meta.pop("_platforms", _PLATFORMS)
    return ExportedPipeline(_load_program(payload), meta, platforms)


if __name__ == "__main__":  # pragma: no cover - exercised via subprocess test
    import sys as _sys

    if len(_sys.argv) < 2:
        print("usage: python -m thermoextrap_tpu_torch.serving_export ARTIFACT [...]", file=_sys.stderr)
        raise SystemExit(2)
    for _p in _sys.argv[1:]:
        print(json.dumps({"path": _p, **describe_artifact(_p)}, sort_keys=True))
