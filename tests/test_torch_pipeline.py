"""The β-extrapolation slice of the torch port end to end against the JAX
package: data factory → predict, resampling with the same numpy indices or
tables, the moment-backed container, the serving pipeline (nrep = 0 in
every variant, float64 rtol 1e-10), its bootstrap CI within Monte-Carlo
error, the moment state carried across packages, and the import boundary
(the port never imports jax)."""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from _torch_parity import assert_close, npy, tt

import thermoextrap_tpu as jx
import thermoextrap_tpu_torch as tx
from thermoextrap_tpu import beta as jbeta
from thermoextrap_tpu import idealgas as jideal
from thermoextrap_tpu import pipeline as jpipe
from thermoextrap_tpu_torch import beta as tbeta
from thermoextrap_tpu_torch import idealgas as tideal
from thermoextrap_tpu_torch import interop
from thermoextrap_tpu_torch import pipeline as tpipe

RTOL = 1e-10
ATOL = 1e-13
BETA0 = 1.0
BETAS = np.array([0.8, 1.0, 1.3])


def _ideal_gas(seed, nconfig, npart=20):
    """Ideal-gas samples made with numpy: (x mean per config, u per config)."""
    rng = np.random.default_rng(seed)
    r = rng.uniform(size=(nconfig, npart))
    pos = -np.log(1.0 - r * (1.0 - np.exp(-BETA0))) / BETA0
    return pos.mean(-1), pos.sum(-1)


@pytest.fixture
def gas():
    return _ideal_gas(5, 2000)


# -- data + model ------------------------------------------------------------------


@pytest.mark.parametrize(("central", "minus_log", "order"), [(True, False, 6), (True, True, 4), (False, False, 3)])
def test_factory_predict_matches_jax(gas, central, minus_log, order):
    x, u = gas
    xv = np.stack([x, x**2], -1)
    jdata = jx.factory_data_values(uv=u, xv=xv, order=order, central=central)
    tdata = tx.factory_data_values(uv=tt(u), xv=tt(xv), order=order, central=central)
    jm = jbeta.factory_extrapmodel(BETA0, jdata, minus_log=minus_log)
    tm = tbeta.factory_extrapmodel(BETA0, tdata, minus_log=minus_log)
    assert_close(tm.predict(BETAS), jm.predict(BETAS), RTOL, ATOL)
    assert_close(tm.derivs(), jm.derivs(), RTOL, ATOL)
    assert_close(tm.predict(1.2, cumsum=True), jm.predict(1.2, cumsum=True), RTOL, ATOL)


def test_xalpha_weighted_predict_matches_jax(gas):
    x, u = gas
    order = 3
    xv = np.stack([x * (1.0 + 0.1 * d) for d in range(order + 1)], 1)  # (R, deriv+1)
    w = np.random.default_rng(2).uniform(0.5, 1.5, u.shape)
    jdata = jx.factory_data_values(uv=u, xv=xv, order=order, central=True, xalpha=True, weight=w)
    tdata = tx.factory_data_values(uv=tt(u), xv=tt(xv), order=order, central=True, xalpha=True, weight=tt(w))
    assert_close(
        tbeta.factory_extrapmodel(BETA0, tdata).predict(BETAS),
        jbeta.factory_extrapmodel(BETA0, jdata).predict(BETAS),
        RTOL,
        ATOL,
    )


def test_u_ave_and_observable_validation(gas):
    _, u = gas
    jdata = jx.factory_data_values(uv=u, xv=None, order=4, central=True)
    tdata = tx.factory_data_values(uv=tt(u), xv=None, order=4, central=True)
    assert tdata.x_is_u
    assert_close(
        tbeta.factory_extrapmodel(BETA0, tdata, name="u_ave").predict(BETAS),
        jbeta.factory_extrapmodel(BETA0, jdata, name="u_ave").predict(BETAS),
        RTOL,
        ATOL,
    )
    assert_close(
        tbeta.factory_extrapmodel(BETA0, tdata, name="dun_ave", n=2, order=2).predict(BETAS),
        jbeta.factory_extrapmodel(BETA0, jdata, name="dun_ave", n=2, order=2).predict(BETAS),
        RTOL,
        ATOL,
    )
    with pytest.raises(ValueError, match="needs moment entries"):
        tbeta.factory_extrapmodel(BETA0, tdata, name="dun_ave", n=3)
    with pytest.raises(ValueError, match="unknown observable"):
        tbeta.factory_derivatives("z_ave", central=True)


def test_resample_same_indices_matches_jax(gas):
    """The README quick start's bootstrap (values path, batched reduction)
    and the count-table bootstrap of DataCentralMomentsVals, fed the same
    numpy indices."""
    x, u = gas
    idx = np.random.default_rng(3).integers(0, u.size, (8, u.size))
    jdata = jx.factory_data_values(uv=u, xv=x, order=5, central=True)
    tdata = tx.factory_data_values(uv=tt(u), xv=tt(x), order=5, central=True)
    jm = jbeta.factory_extrapmodel(BETA0, jdata).resample({"indices": idx})
    tm = tbeta.factory_extrapmodel(BETA0, tdata).resample({"indices": tt(idx)})
    assert_close(tm.predict(BETAS), jm.predict(BETAS), RTOL, ATOL)
    jv = jx.DataCentralMomentsVals.from_vals(x, u, 5).resample(idx)
    tv = tx.DataCentralMomentsVals.from_vals(tt(x), tt(u), 5).resample(tt(idx))
    assert_close(
        tbeta.factory_extrapmodel(BETA0, tv).predict(BETAS),
        jbeta.factory_extrapmodel(BETA0, jv).predict(BETAS),
        RTOL,
        ATOL,
    )
    assert_close((tv.xave, tv.uave, tv.du, tv.dxdu, tv.wsum), (jv.xave, jv.uave, jv.du, jv.dxdu, jv.wsum), RTOL, ATOL)


def test_moment_container_matches_jax(gas):
    x, u = gas
    xb, ub = x.reshape(10, 200), u.reshape(10, 200)
    jd = jx.DataCentralMoments.from_vals(xb, ub, 4)
    td = tx.DataCentralMoments.from_vals(tt(xb), tt(ub), 4)
    fields = lambda d: (d.xave, d.uave, d.du, d.dxdu, d.wsum)  # noqa: E731
    assert_close(fields(td), fields(jd), RTOL, ATOL)
    assert_close(fields(td.reduce()), fields(jd.reduce()), RTOL, ATOL)
    freq = np.random.default_rng(4).integers(0, 3, (6, 10))
    assert_close(fields(td.resample({"freq": tt(freq)})), fields(jd.resample({"freq": freq})), RTOL, ATOL)
    assert_close((td.u, td.xu), (jd.u, jd.xu), RTOL, ATOL)
    assert_close(
        tbeta.factory_extrapmodel(BETA0, td.reduce()).predict(BETAS),
        jbeta.factory_extrapmodel(BETA0, jd.reduce()).predict(BETAS),
        RTOL,
        ATOL,
    )
    ja = jx.DataCentralMoments.from_ave_central(jd.xave, jd.uave, jd.du, jd.dxdu, wsum=jd.wsum)
    ta = tx.DataCentralMoments.from_ave_central(td.xave, td.uave, td.du, td.dxdu, wsum=td.wsum)
    assert_close(fields(ta), fields(ja), RTOL, ATOL)
    with pytest.raises(ValueError, match="block batch axis"):
        td.reduce().resample({"nrep": 2})


def test_interop_round_trip(gas):
    """A moment state reduced by the JAX package predicts identically in the
    port, and back."""
    x, u = gas
    jd = jx.DataCentralMoments.from_vals(x, u, 6)
    state = interop.data_to_numpy(jd)
    td = interop.data_from_numpy(state, **{k: state[k] for k in interop.FLAGS})
    jpred = jbeta.factory_extrapmodel(BETA0, jd).predict(BETAS)
    assert_close(tbeta.factory_extrapmodel(BETA0, td).predict(BETAS), jpred, 1e-12, ATOL)
    back = interop.data_to_numpy(td)
    jd2 = jx.DataCentralMoments(
        **{k: back[k] for k in interop.FIELDS}, meta=jx.DataCallback(), **{k: back[k] for k in interop.FLAGS}
    )
    assert_close(jbeta.factory_extrapmodel(BETA0, jd2).predict(BETAS), jpred, 1e-12, ATOL)
    with pytest.raises(ValueError, match="missing moment fields"):
        interop.data_from_numpy({"xave": state["xave"]}, order=6)


# -- the serving pipeline -----------------------------------------------------------


@pytest.mark.parametrize("variant", ["flat", "vector", "xalpha", "minus_log", "weighted", "x_is_u"])
def test_pipeline_matches_jax(gas, variant):
    x, u = gas
    order = 5
    kw = {}
    args = [u, x]
    if variant == "vector":
        args = [u, np.stack([x, 2.0 * x + 1.0], 1)]
    elif variant == "xalpha":
        kw["xalpha"] = True
        args = [u, np.stack([x * (1.0 + 0.2 * d) for d in range(order + 1)], 1)]
    elif variant == "minus_log":
        kw["minus_log"] = True
    elif variant == "weighted":
        kw["weighted"] = True
    elif variant == "x_is_u":
        kw["x_is_u"] = True
        args = [u]
    jrun = jpipe.make_extrap_pipeline(order, BETA0, **kw)
    trun = tpipe.make_extrap_pipeline(order, BETA0, **kw)
    jargs = args + [BETAS]
    targs = [tt(a) for a in args] + [tt(BETAS)]
    if variant == "weighted":
        w = np.random.default_rng(6).uniform(0.5, 1.5, u.size)
        jargs.append(w)
        targs.append(tt(w))
    got = trun(*targs)
    assert got.dtype == torch.float64
    assert_close(got, jrun(*jargs), RTOL, ATOL)


def test_pipeline_ci_within_monte_carlo_error():
    """The CPU bootstrap CI (multinomial table from a seeded
    torch.Generator) agrees with the JAX one within Monte-Carlo error, and
    the prediction sits within 5 sigma of the analytic ideal gas."""
    x, u = _ideal_gas(8, 4000)
    nrep = 200
    tpred, tstd = tpipe.make_extrap_pipeline(4, BETA0, nrep=nrep)(tt(u), tt(x), tt(BETAS), seed=1)
    jpred, jstd = jpipe.make_extrap_pipeline(4, BETA0, nrep=nrep)(u, x, BETAS, seed=1)
    assert_close(tpred, jpred, RTOL, ATOL)
    # the relative spread of a std estimate from nrep replicates is ~1/sqrt(2 nrep) = 5%
    np.testing.assert_allclose(npy(tstd), np.asarray(jstd), rtol=0.25)
    truth = np.array([float(jideal.x_beta_extrap(4, BETA0, b)[0]) for b in BETAS])
    assert np.all(np.abs(npy(tpred) - truth) <= 5 * npy(tstd) + 1e-6)
    tpred2, tstd2 = tpipe.make_extrap_pipeline(4, BETA0, nrep=nrep)(tt(u), tt(x), tt(BETAS), seed=1)
    assert torch.equal(tstd, tstd2)  # the seed fixes the replicates
    _, ustd = tpipe.make_extrap_pipeline(3, BETA0, nrep=50, x_is_u=True)(tt(u), tt(BETAS), seed=2)
    assert bool((ustd > 0).all())


def test_pipeline_validation():
    with pytest.raises(ValueError, match="mutually exclusive"):
        tpipe.make_extrap_pipeline(2, BETA0, x_is_u=True, xalpha=True)
    run = tpipe.make_extrap_pipeline(2, BETA0, xalpha=True)
    with pytest.raises(ValueError, match="deriv axis"):
        run(torch.ones(10), torch.ones(10, 2), tt(BETAS))


def test_idealgas_oracle_matches_jax():
    for b in (0.7, 1.0, 1.4):
        assert_close(tideal.x_ave(b), jideal.x_ave(b), 1e-13)
        assert_close(tideal.x_var(b, 2.0), jideal.x_var(b, 2.0), 1e-13)
    # order-6 derivatives cancel to ~1e-3: roundoff of the two exp/series
    # evaluations shows at ~1e-12 absolute
    assert_close(tideal.x_beta_extrap(6, 1.0, 1.3), jideal.x_beta_extrap(6, 1.0, 1.3), 1e-12, 1e-11)
    x, u = tideal.generate_data((5000, 10), 1.0, rng=3)
    assert x.shape == (5000,) and u.shape == (5000,)
    assert abs(float(x.mean()) - float(jideal.x_ave(1.0))) < 5 * float(jideal.x_var(1.0)) ** 0.5 / np.sqrt(50_000)
    assert torch.equal(tideal.x_sample(7, 1.0, rng=4), tideal.x_sample(7, 1.0, rng=4))


def test_port_never_imports_jax():
    """``import thermoextrap_tpu_torch`` (with the CUDA wrappers and their
    backward route, the checkpoint and tree modules, MBAR, the ingest
    runtime, the native engines, the trainers, the GPR staging, the
    labeled-array adapter, the random seam, the type aliases, the GPR
    modules with their compute device and serving, the sharded path with
    its dry run, the build-cache seam and the export module) pulls in
    neither jax, nor the
    JAX package, nor orbax, nor sympy (imported only inside
    ``Derivatives.from_sympy``, the sympy-expression kernels and, through
    ``torch.distributed.tensor``, the first sharded call).  The example CLIs
    of ``examples_torch/`` and ``chip_smoke.py`` import, by an AST scan of
    every import statement, only the port among the repository's packages
    (and neither jax nor orbax)."""
    root = Path(__file__).resolve().parent.parent
    scripts = sorted((root / "examples_torch").glob("*.py")) + [root / "chip_smoke.py"]
    assert len(scripts) == 15
    for path in scripts:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module]
            else:
                continue
            bad = [m for m in mods if m.split(".")[0] in ("jax", "jaxlib", "thermoextrap_tpu", "orbax")]
            assert not bad, f"{path.name}:{node.lineno} imports {bad}"
    code = (
        "import sys; before = set(sys.modules); "
        "import thermoextrap_tpu_torch, thermoextrap_tpu_torch.ops.moments_cuda; "
        "import thermoextrap_tpu_torch.utils.checkpoint, thermoextrap_tpu_torch.utils.trees; "
        "import thermoextrap_tpu_torch.devtime, thermoextrap_tpu_torch.drawcost, thermoextrap_tpu_torch.emulate; "
        "import thermoextrap_tpu_torch.models.mbar, thermoextrap_tpu_torch.io_stream, thermoextrap_tpu_torch.native; "
        "import thermoextrap_tpu_torch.native._fallback, thermoextrap_tpu_torch.ops.moments_autograd; "
        "import thermoextrap_tpu_torch.stack, thermoextrap_tpu_torch.adaptive_interp; "
        "import thermoextrap_tpu_torch.recursive_interp, thermoextrap_tpu_torch.compat; "
        "import thermoextrap_tpu_torch.random, thermoextrap_tpu_torch.typing; "
        "import thermoextrap_tpu_torch.gpr_active, thermoextrap_tpu_torch.gpr_active.gp_models; "
        "import thermoextrap_tpu_torch.gpr_active.kernels, thermoextrap_tpu_torch.gpr_active.active_utils; "
        "import thermoextrap_tpu_torch.gpr_active.ig_active, thermoextrap_tpu_torch.utils.compute; "
        "import thermoextrap_tpu_torch.parallel, thermoextrap_tpu_torch.parallel.sharded, thermoextrap_tpu_torch.parallel.dryrun; "
        "import thermoextrap_tpu_torch.utils.compile_cache, thermoextrap_tpu_torch.gpr_active.serving; "
        "import thermoextrap_tpu_torch.serving_export; "
        "new = set(sys.modules) - before; "
        "bad = sorted(m for m in new if m.split('.')[0] in ('jax', 'jaxlib', 'thermoextrap_tpu', 'orbax', 'sympy')); "
        "print(bad); sys.exit(1 if bad else 0)"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_all_names_of_the_jax_package():
    """``thermoextrap_tpu_torch.__all__`` is the JAX package's ``__all__``:
    ``serving_export``, the last module, is ported and exports every name
    of the JAX ``serving_export``; ``parallel`` exports every name of the
    JAX ``parallel`` and the two MBAR entries of its ``sharded``; the
    port's own ``default_device``, ``set_default_device`` and ``interop``
    are attributes outside ``__all__``."""
    from thermoextrap_tpu import serving_export as jse
    from thermoextrap_tpu.parallel import sharded as jsharded

    assert set(jx.__all__) == set(tx.__all__)
    assert set(tx.serving_export.__all__) == set(jse.__all__)
    for name in jse.__all__:
        assert getattr(tx.serving_export, name) is not None
    assert set(tx.parallel.__all__) == set(jx.parallel.__all__) | {"mbar_solve_sharded", "mbar_expectations_grid_sharded"}
    assert set(tx.parallel.__all__) == set(jsharded.__all__)
    for name in tx.__all__:
        assert getattr(tx, name) is not None
    assert callable(tx.default_device) and callable(tx.set_default_device) and tx.interop is not None


# -- the default device ----------------------------------------------------------------------


def test_numpy_input_goes_to_the_default_device(monkeypatch):
    """Arrays that are not tensors land on ``default_device()``: with the
    default patched to the meta device (a sentinel that computes shapes
    only), the pipelines, the streaming states and the interop constructors
    ask for it, while a tensor keeps its own device."""
    from thermoextrap_tpu_torch.utils import device as tdevice
    from thermoextrap_tpu_torch.utils.random import validate_rng

    assert tx.default_device() == torch.device("cpu")  # pinned by the parity helper
    monkeypatch.setattr(tdevice, "_DEVICE", torch.device("meta"))
    assert tx.default_device().type == "meta"
    u, x = np.arange(10.0), np.arange(10.0) ** 2
    assert tpipe.make_extrap_pipeline(3, 1.0)(u, x, [1.1]).device.type == "meta"
    assert tpipe.make_extrap_pipeline(3, 1.0, x_is_u=True)(u, [1.1]).device.type == "meta"
    assert tpipe.make_perturb_pipeline(1.0)(u, x, [1.1]).device.type == "meta"
    assert tpipe.make_lnpi_pipeline(2, 1.0)(u[None], [0.0], [1.0], [1.1]).device.type == "meta"
    assert tpipe.make_volume_pipeline(1.0)(u, x, x, [1.1]).device.type == "meta"
    assert tpipe.make_streaming_extrap_pipeline(3, 1.0)[0].xave.device.type == "meta"
    assert tpipe.make_streaming_lnpi_pipeline(2, 1.0, grid_shape=(2,))[0].wsum.device.type == "meta"
    assert tpipe.make_streaming_volume_pipeline(1.0)[0].dxdu.device.type == "meta"
    assert tpipe.make_streaming_perturb_pipeline(1.0, [1.1])[0][0].device.type == "meta"
    assert tpipe.make_streaming_interp_pipeline(2, [1.0, 1.2])[0][1].xave.device.type == "meta"
    assert all(t.device.type == "meta" for t in tpipe.bucket_pad(u, x, None, (16,)))
    assert tx.DataCentralMoments.from_data(np.ones(4), x_is_u=True).wsum.device.type == "meta"
    assert tx.DataCentralMoments.zeros(2).wsum.device.type == "meta"
    assert tx.DataCentralMoments.from_vals(x, u, 2).xave.device.type == "meta"
    state = interop.data_to_numpy(tx.DataCentralMoments.zeros(2, device="cpu"))
    assert interop.state_from_numpy(state).xave.device.type == "meta"
    # MBAR (the solve's loop reads the card, so its pieces stand in for it)
    from thermoextrap_tpu_torch.models import mbar as tmbar

    u_kn = np.stack([u, 2 * u])
    assert tmbar.mbar_log_weights(u_kn, [5, 5], [0.0, 0.5], u).device.type == "meta"
    assert tmbar.mbar_expectations_grid(u_kn, [5, 5], [0.0, 0.5], u_kn, x[:, None]).device.type == "meta"
    assert tmbar.mbar_expectations_alphas(u_kn, [5, 5], [0.0, 0.5], [1.0], u, x).device.type == "meta"
    assert tmbar.mbar_perturbed_free_energies(u_kn, [5, 5], [0.0, 0.5], u_kn).device.type == "meta"
    assert tmbar.statistical_inefficiency(x).device.type == "meta"
    assert tmbar.mbar_log_weights(tt(u_kn), [5, 5], [0.0, 0.5], u).device.type == "cpu"
    # a tensor keeps its device, and an explicit device wins
    assert tpipe.make_extrap_pipeline(3, 1.0)(tt(u), x, [1.1]).device.type == "cpu"
    assert tpipe.make_streaming_extrap_pipeline(3, 1.0, device="cpu")[0].xave.device.type == "cpu"
    assert validate_rng(3, device="cpu").device.type == "cpu"
    monkeypatch.setattr(tdevice, "_DEVICE", None)
    assert tx.default_device().type == ("cuda" if torch.cuda.is_available() else "cpu")
    tx.set_default_device("cpu")
    assert tdevice._DEVICE == torch.device("cpu")
    assert tideal.x_sample((4, 2), 1.0, rng=1).device.type == "cpu"


# -- the bucketed serving runner (tests/test_pipeline.py::TestBucketedRunner) ----------------


def test_bucket_padding_is_exact_and_matches_jax():
    rng = np.random.default_rng(42)
    uv = rng.normal(2.0, 1.0, 1000)
    xv = rng.normal(1.0, 0.5, (1000, 2))
    betas = np.array([1.8, 2.0, 2.2])
    serve = tpipe.make_bucketed_extrap_runner(4, 2.0, buckets=(1 << 9, 1 << 11))
    got = serve(uv, xv, betas)
    assert_close(got, tpipe.make_extrap_pipeline(4, 2.0)(uv, xv, betas), 1e-12, 1e-14)
    assert_close(got, np.asarray(jpipe.make_bucketed_extrap_runner(4, 2.0, buckets=(1 << 9, 1 << 11))(uv, xv, betas)), 1e-12, 1e-14)
    # x_is_u: u alone, padded the same way
    serve_u = tpipe.make_bucketed_extrap_runner(3, 2.0, buckets=(1 << 11,), x_is_u=True)
    jserve_u = jpipe.make_bucketed_extrap_runner(3, 2.0, buckets=(1 << 11,), x_is_u=True)
    assert_close(serve_u(uv, betas), np.asarray(jserve_u(uv, betas)), 1e-12, 1e-14)
    assert_close(serve_u(uv, betas), tpipe.make_extrap_pipeline(3, 2.0, x_is_u=True)(uv, betas), 1e-12, 1e-14)


def test_bucket_selection_and_overflow():
    serve = tpipe.make_bucketed_extrap_runner(2, 1.0, buckets=(32, 8))
    assert serve.buckets == (8, 32)
    assert tpipe.normalize_buckets(None) == tuple(1 << p for p in range(12, 28))
    uv = np.linspace(0.5, 1.5, 100)  # above the largest bucket: its own length
    out = serve(uv, uv[:, None] * 2, np.array([1.0]))
    np.testing.assert_allclose(npy(out)[0, 0], np.mean(2 * uv), rtol=1e-12)
    with pytest.raises(ValueError, match="at least one sample"):
        serve(uv[:0], uv[:0, None], np.array([1.0]))


def test_bucket_weighted_and_bootstrap():
    rng = np.random.default_rng(42)
    uv = rng.normal(2.0, 1.0, 700)
    xv = rng.normal(1.0, 0.5, (700, 1))
    w = rng.uniform(0.5, 1.5, 700)
    serve = tpipe.make_bucketed_extrap_runner(3, 2.0, buckets=(1 << 10,), nrep=32)
    pred, std = serve(uv, xv, np.array([2.0, 2.1]), weight=w, seed=3)
    assert bool(torch.isfinite(pred).all()) and bool((std > 0).all())
    want = tpipe.make_extrap_pipeline(3, 2.0, weighted=True)(uv, xv, np.array([2.0, 2.1]), w)
    assert_close(pred, want, 1e-12)
    jpred, _ = jpipe.make_bucketed_extrap_runner(3, 2.0, buckets=(1 << 10,), nrep=32)(uv, xv, np.array([2.0, 2.1]), weight=w, seed=3)
    assert_close(pred, np.asarray(jpred), 1e-12)


def test_bucket_warmup_runs_each_bucket(monkeypatch):
    serve = tpipe.make_bucketed_extrap_runner(2, 1.0, buckets=(8, 16, 64))
    seen = []
    pad = tpipe.bucket_pad
    monkeypatch.setattr(tpipe, "bucket_pad", lambda uv, *a: seen.append(len(uv)) or pad(uv, *a))
    serve.warmup(val_shape=(1,), n_betas=2, max_bucket=16)
    assert seen == [8, 16]


def test_bucket_pad_streams_weights_and_tensors():
    """Tuples of value streams pad together as each alone; pads replicate
    the last sample with weight 0; weights keep a floating dtype (integers
    become float32); tensors pad on their own device; numpy matches the JAX
    package's padding."""
    rng = np.random.default_rng(42)
    uv = rng.normal(0.0, 1.0, 100)
    xv = rng.normal(0.0, 1.0, (100, 2))
    dx = rng.normal(0.0, 1.0, (100, 2))
    buckets = (128,)
    up, (xp, dp), wp = tpipe.bucket_pad(uv, (xv, dx), None, buckets)
    up1, xp1, wp1 = tpipe.bucket_pad(uv, xv, None, buckets)
    _, dp1, _ = tpipe.bucket_pad(uv, dx, None, buckets)
    for a, b in ((up, up1), (xp, xp1), (dp, dp1), (wp, wp1)):
        assert torch.equal(a, b)
    ju, jxv, jw = jpipe.bucket_pad(uv, xv, None, buckets)
    assert_close((up1, xp1, wp1), (ju, jxv, jw), 0.0)
    assert wp.dtype == torch.float64 and float(wp[100:].abs().sum()) == 0.0 and torch.equal(xp[-1], xp[99])
    assert tpipe.bucket_pad(uv, None, np.ones(100, dtype=np.int64), buckets)[2].dtype == torch.float32
    assert tpipe.bucket_pad(tt(uv, torch.bfloat16), None, None, buckets)[2].dtype == torch.float32
    f64w = tpipe.bucket_pad(uv, xv, np.ones(100), buckets)[2]
    assert f64w.dtype == torch.float64 and f64w.shape == (128,)
    same = tpipe.bucket_pad(uv[:64], xv[:64], None, (64,))
    assert same[0].shape == (64,)
    for bad in ((), (xv, None)):
        with pytest.raises(ValueError, match="tuple of value streams"):
            tpipe.bucket_pad(uv, bad, None, buckets)
