"""The torch port's sharded path (``thermoextrap_tpu_torch.parallel``, the
pipelines' ``mesh=``, sharded MBAR, sharded GPR queries and checkpoints)
against the JAX package, on a spawned world of 4 gloo ranks on the CPU.

One world per module (the ``world`` fixture) runs every case on a 1-D
``("rec",)`` and a 2-D ``("rep", "rec")`` mesh (:mod:`_torch_world`) and
sends the results back as numpy arrays; the parent compares them, in
float64, with the JAX package's sharded functions on ``make_mesh(4)``
(tests/conftest.py gives JAX 8 CPU devices) or, for the pipelines, with the
port's unsharded CPU call at the same seed.  Mirrors of
tests/test_parallel.py:35, :55, :591, :614; tests/test_pipeline.py:83,
:209, :444, :548, :675, :862; tests/test_streaming.py:208 and the mesh half
of :274; tests/test_mbar.py:123-190; tests/test_gpr_serving.py:228;
tests/test_checkpoint.py:59; and ``__graft_entry__.dryrun_multichip``, with
their tolerances.
"""

import jax.numpy as jnp
import numpy as np
import pytest
from _torch_parity import npy
from _torch_world import run_world

from thermoextrap_tpu.models import mbar as jmbar
from thermoextrap_tpu.ops.resample import freq_from_indices, resample_central_comoments
from thermoextrap_tpu.parallel import make_mesh as jmake_mesh
from thermoextrap_tpu.parallel import sharded as jsh
from thermoextrap_tpu_torch import pipeline as tpipe
from thermoextrap_tpu_torch.parallel import dryrun

WORLD = 4


def _harmonic_problem(sigmas, n, seed=0):
    """K harmonic states u_k(x) = x^2 / (2 sigma_k^2), n samples from each
    (tests/test_mbar.py)."""
    rng = np.random.default_rng(seed)
    xs = np.concatenate([rng.normal(0.0, s, size=n) for s in sigmas])
    sig = np.asarray(sigmas, dtype=np.float64)
    return xs[None, :] ** 2 / (2.0 * sig[:, None] ** 2), np.full(len(sigmas), float(n)), xs


def _freq(rng, nrep, r):
    return np.asarray(freq_from_indices(rng.integers(0, r, (nrep, r)), r))


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(20240607)
    d = {}
    r = 4096
    d["red"] = (rng.normal(5.0, 1.0, r), rng.normal(2.0, 0.5, (r, 3)), rng.uniform(0.5, 1.5, r))
    d["res"] = (rng.normal(3.0, 1.0, 1024), rng.normal(1.0, 0.5, (1024, 2)))
    d["res_freq"] = _freq(rng, 8, 1024)
    d["uneven"] = (rng.normal(3.0, 1.0, 1023), rng.normal(1.0, 0.5, (1023, 2)), rng.uniform(0.5, 1.5, 1023))
    d["uneven_freq"] = _freq(rng, 7, 1023)
    d["ured"] = (rng.normal(3.0, 1.0, (6, 2048)), rng.uniform(0.5, 1.5, (6, 2048)))
    d["ures"] = rng.normal(2.0, 1.0, (5, 1024))
    d["ures_freq"] = _freq(rng, 8, 1024)
    d["mbar_solve"] = _harmonic_problem([1.0, 1.7, 2.6, 3.1], 4096, seed=8)
    u_kn, n_k, xs = _harmonic_problem([1.0, 2.0, 3.0], 4096, seed=9)
    scales = np.array([0.8, 1.4, 2.2, 2.9])
    d["mbar_grid"] = (u_kn, n_k, xs[None, :] ** 2 / (2.0 * scales[:, None] ** 2), np.stack([xs, xs**2], axis=1))
    u_kn, n_k, xs = _harmonic_problem([1.0, 2.0], 501, seed=10)
    d["mbar_uneven"] = (u_kn, n_k, u_kn[:1] * 0.9, xs[:, None] ** 2)
    u = rng.normal(3.0, 0.7, r)
    d["extrap"] = (u, 1.5 + 0.2 * (u - 3.0) + rng.normal(0, 0.3, r))
    uw = rng.normal(3.0, 0.7, 3001)
    d["weighted"] = (uw, (1.5 + 0.2 * (uw - 3.0))[:, None] + rng.normal(0, 0.3, (3001, 2)), rng.uniform(0.5, 1.5, 3001))
    ux = rng.normal(2.0, 0.5, r)
    d["xalpha"] = (ux, np.stack([(1.0 + 0.1 * k) * np.cos(ux + k) for k in range(4)], axis=1)[..., None])
    d["lnpi"] = (
        np.linspace(-1, 1, 5)[:, None] + rng.normal(-10.0, 1.5, (5, 1024)),
        rng.normal(0.0, 1.0, 5),
        0.7 * np.arange(5, dtype=float),
    )
    wv = rng.normal(1.0, 0.3, r)
    xv = 0.5 * wv[:, None] + rng.normal(0.0, 0.2, (r, 2))
    d["volume"] = (wv, xv, 0.3 * xv + rng.normal(0.0, 0.05, (r, 2)))
    up = rng.normal(2.0, 0.5, r)
    d["perturb"] = (up, 1.5 + 0.3 * (up[:, None] - 2.0) + rng.normal(0, 0.2, (r, 2)))
    us = rng.normal(1.0, 0.4, 3000)
    d["stream"] = (us, 1.0 + 0.2 * (us[:, None] - 1.0) + rng.normal(0, 0.3, (3000, 3)), rng.uniform(0.5, 1.5, 3000))
    g, rl = 6, 1600
    d["stream_lnpi"] = (rng.normal(-9.0, 1.2, (g, rl)) + np.arange(g)[:, None], np.linspace(0.0, -4.0, g), 0.6 * np.arange(g, dtype=float))
    d["stream_interp"] = [(rng.normal(b, 0.5, 2000), rng.normal(1.0 / b, 0.2, (2000, 1))) for b in (1.0, 1.4)]
    xg = np.linspace(0.0, 2 * np.pi, 8)
    d["gpr"] = (
        np.concatenate([np.stack([xg, np.zeros_like(xg)], 1), np.stack([xg, np.ones_like(xg)], 1)]),
        np.concatenate([np.sin(xg), np.cos(xg)])[:, None] + rng.normal(0, 0.02, (16, 1)),
        np.diag(np.concatenate([np.full(8, 4e-4), np.full(8, 2.5e-3)])),
        np.linspace(0.5, 5.5, 66)[:, None],
    )
    return d


def _cases(d, path):
    red, res, unev, ured = d["red"], d["res"], d["uneven"], d["ured"]
    ext, wtd, xal, lnp, vol, per = d["extrap"], d["weighted"], d["xalpha"], d["lnpi"], d["volume"], d["perturb"]
    st, sl = d["stream"], d["stream_lnpi"]
    betas = np.array([1.9, 2.2])
    chunks = [(0, 1400), (1400, 2200), (2200, 3000)]
    gl = sl[0].shape[1]
    return {
        "reduce_1d": ("reduce_comoments", ("1d", *red, 6)),
        "reduce_2d": ("reduce_comoments", ("2d", *red, 6)),
        "resample_1d": ("resample_comoments", ("1d", *res, d["res_freq"], 4)),
        "resample_2d": ("resample_comoments", ("2d", *res, d["res_freq"], 4)),
        "resample_uneven": ("resample_comoments", ("2d", *unev[:2], d["uneven_freq"], 4, unev[2])),
        "ureduce_1d": ("reduce_umoments", ("1d", ured[0], 5, ured[1])),
        "uresample_2d": ("resample_umoments", ("2d", d["ures"], d["ures_freq"], 4)),
        "mbar_solve": ("mbar_solve", (*d["mbar_solve"][:2], 1e-12)),
        "mbar_grid_f": ("mbar_solve", d["mbar_grid"][:2]),
        "mbar_uneven": ("mbar_solve_and_grid", d["mbar_uneven"]),
        "extrap": ("pipeline", ("2d", "extrap", {"order": 3, "beta0": 2.0, "nrep": 16}, (*ext, betas), 5, (0, 1))),
        "weighted": (
            "pipeline",
            ("1d", "extrap", {"order": 3, "beta0": 2.0, "nrep": 16, "weighted": True}, (*wtd[:2], betas, wtd[2]), 7, (0, 1, 3)),
        ),
        "xalpha": ("pipeline", ("2d", "extrap", {"order": 3, "beta0": 2.0, "xalpha": True, "nrep": 16}, (*xal, betas), 0, (0, 1))),
        "x_is_u": ("pipeline", ("2d", "extrap", {"order": 3, "beta0": 2.0, "x_is_u": True, "nrep": 16}, (ext[0], betas), 0, (0,))),
        "lnpi": ("pipeline", ("2d", "lnpi", {"order": 3, "beta0": 1.4, "nrep": 16}, (*lnp, np.array([1.2, 1.6])), 3, (), (0,))),
        "volume": ("pipeline", ("2d", "volume", {"volume0": 2.0, "ndim": 3, "nrep": 16}, (*vol, betas), 5, (0, 1, 2))),
        "perturb": ("pipeline", ("1d", "perturb", {"beta0": 1.0, "nrep": 32}, (*per, np.array([0.9, 1.05])), 11)),
        "stream": ("streaming", ("1d", "extrap", {"order": 4, "beta0": 1.0, "val_shape": (3,)}, [(st[0][a:b], st[1][a:b]) for a, b in chunks], (betas,))),
        "stream_nrep": (
            "streaming",
            ("2d", "extrap", {"order": 4, "beta0": 1.0, "val_shape": (3,), "nrep": 8, "seed": 3}, [(st[0][a:b], st[1][a:b]) for a, b in chunks], (betas,)),
        ),
        "stream_u": (
            "streaming",
            ("2d", "extrap", {"order": 3, "beta0": 1.0, "x_is_u": True, "nrep": 4, "seed": 4}, [(st[0][a:b], st[2][a:b]) for a, b in chunks], (betas,)),
        ),
        "stream_lnpi": (
            "streaming",
            ("1d", "lnpi", {"order": 3, "beta0": 1.4, "grid_shape": (6,)}, [(sl[0][:, :800],), (sl[0][:, 800:],)], (sl[1], sl[2], np.array([1.2, 1.4, 1.7]))),
        ),
        "stream_lnpi_nrep": (
            "streaming",
            (
                "2d",
                "lnpi",
                {"order": 3, "beta0": 1.4, "grid_shape": (6,), "nrep": 8, "seed": 2},
                [(sl[0][:, :700],), (sl[0][:, 700:gl],)],
                (sl[1], sl[2], np.array([1.2, 1.4, 1.7])),
            ),
        ),
        "stream_volume": (
            "streaming",
            ("2d", "volume", {"volume0": 2.0, "val_shape": (2,), "nrep": 4, "seed": 1}, [tuple(a[:2000] for a in vol), tuple(a[2000:] for a in vol)], (betas,)),
        ),
        "stream_interp": (
            "streaming",
            (
                "1d",
                "interp",
                {"order": 2, "beta0s": [1.0, 1.4], "nrep": 4, "seed": 5},
                [(i, s[0][a:b], s[1][a:b]) for i, s in enumerate(d["stream_interp"]) for a, b in [(0, 1300), (1300, 2000)]],
                (np.array([1.1, 1.2, 1.3]),),
            ),
        ),
        "gpr": ("frozen_queries", d["gpr"]),
        "checkpoint": ("checkpoint_roundtrip", (str(path),)),
        "mesh": ("mesh_checks", ()),
    }


@pytest.fixture(scope="module")
def world(data, tmp_path_factory):
    """Every case on one spawned world of 4 gloo ranks: each rank's results."""
    d = dict(data)
    jm1 = jmake_mesh(WORLD)
    # the grid case takes the JAX package's sharded free energies
    d["mbar_grid_jf"] = np.asarray(jsh.mbar_solve_sharded(*data["mbar_grid"][:2], jm1)[0])
    cases = _cases(d, tmp_path_factory.mktemp("sharded_ckpt") / "ck")
    cases["mbar_grid"] = ("mbar_grid", (*data["mbar_grid"][:2], d["mbar_grid_jf"], *data["mbar_grid"][2:]))
    return run_world(cases, WORLD), d


def _got(world, name):
    return world[0][0][name]


def _close(got, want, rtol, atol=0.0):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = np.asarray(g, np.float64), np.asarray(npy(w), np.float64)
        assert g.shape == w.shape, (g.shape, w.shape)
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)


def test_every_rank_returns_the_same_results(world):
    """Replicated results (plain tensors) and gathered ones agree bit for
    bit on the 4 ranks."""
    ranks, _ = world

    def flat(x):
        return [a for v in x for a in flat(v)] if isinstance(x, (tuple, dict)) and not isinstance(x, np.ndarray) else [x]

    for name in ranks[0]:
        for other in ranks[1:]:
            for a, b in zip(flat(ranks[0][name]), flat(other[name])):
                assert np.array_equal(a, b, equal_nan=np.asarray(a).dtype.kind == "f"), name


def test_mesh_shapes_and_refusals(world):
    """The reference's balanced 2-D factorization; a DTensor on another
    mesh, or placed otherwise, raises."""
    s1, s2, names, refused = _got(world, "mesh")
    assert tuple(s1) == (4,) and tuple(s2) == (2, 2) and tuple(names) == ("rep", "rec")
    assert list(refused) == [True, True]


# -- tests/test_parallel.py ------------------------------------------------------------------


@pytest.mark.parametrize("mesh", ["1d", "2d"])
def test_reduce_sharded(world, mesh):
    """tests/test_parallel.py:35 against the JAX package's sharded reduce."""
    _, d = world
    u, x, w = d["red"]
    jm = jmake_mesh(WORLD, axis_names=("rec",) if mesh == "1d" else ("rep", "rec"))
    want = jsh.reduce_central_comoments_sharded(jnp.asarray(u), jnp.asarray(x), 6, jm, weight=w)
    _close(_got(world, f"reduce_{mesh}"), tuple(want), 1e-12, 1e-14)


@pytest.mark.parametrize("mesh", ["1d", "2d"])
def test_resample_sharded(world, mesh):
    """tests/test_parallel.py:55: the (rep, rec) bootstrap against the JAX
    package's sharded one on the same table (its unsharded one, which that
    test holds it to, on the mesh without rep: each JAX shard_map compiles
    for ~12 s); sharded on rep where the mesh has it."""
    _, d = world
    u, x = d["res"]
    if mesh == "2d":
        want = jsh.resample_central_comoments_sharded(
            jnp.asarray(u), jnp.asarray(x), d["res_freq"], 4, jmake_mesh(WORLD, axis_names=("rep", "rec"))
        )
    else:
        want = resample_central_comoments(u, x, d["res_freq"], 4)
    got, on_rep = _got(world, f"resample_{mesh}")
    _close(got, tuple(want), 1e-9, 1e-12)
    assert list(on_rep) == [mesh == "2d"] * 4


def test_resample_sharded_uneven(world):
    """R = 1023 samples and 7 replicates on the 2 x 2 mesh (shards of
    unequal length, which the reference's even split cannot take), weighted:
    equal to the JAX package's unsharded bootstrap."""
    _, d = world
    u, x, w = d["uneven"]
    want = resample_central_comoments(u, x, d["uneven_freq"], 4, weight=w)
    got, _ = _got(world, "resample_uneven")
    _close(got, tuple(want), 1e-9, 1e-12)


def test_reduce_umoments_batched_sharded(world):
    """tests/test_parallel.py:591 against the JAX package's sharded reduce."""
    _, d = world
    u, w = d["ured"]
    uave, du = jsh.reduce_central_umoments_batched_sharded(jnp.asarray(u), 5, jmake_mesh(WORLD), weight=jnp.asarray(w))
    got = _got(world, "ureduce_1d")
    _close(got[0], uave, 1e-12)
    _close(got[1], du, 1e-11, 1e-14)


def test_resample_umoments_batched_sharded(world):
    """tests/test_parallel.py:614 against the JAX package's (rep, rec) bootstrap."""
    _, d = world
    want = jsh.resample_central_umoments_batched_sharded(
        jnp.asarray(d["ures"]), d["ures_freq"], 4, jmake_mesh(WORLD, axis_names=("rep", "rec"))
    )
    (bu, bdu), on_rep = _got(world, "uresample_2d")
    _close(bu, want[0], 1e-10)
    _close(bdu, want[1], 1e-9, 1e-12)
    assert list(on_rep) == [True, True]


# -- tests/test_mbar.py::TestShardedMBAR -----------------------------------------------------


def test_sharded_solve_equals_single_device(world):
    _, d = world
    u_kn, n_k, _ = d["mbar_solve"]
    f_j, _, _ = jsh.mbar_solve_sharded(u_kn, n_k, jmake_mesh(WORLD), tol=1e-12)
    f, it, res = _got(world, "mbar_solve")
    assert float(res) <= 1e-12 and int(it) > 0
    _close(f, f_j, 0.0, 1e-11)
    _close(f, jmbar.mbar_solve_info(u_kn, n_k, tol=1e-12)[0], 0.0, 1e-11)


def test_sharded_grid_equals_single_device(world):
    _, d = world
    u_kn, n_k, u_targets, x_n = d["mbar_grid"]
    _close(_got(world, "mbar_grid_f")[0], d["mbar_grid_jf"], 0.0, 1e-11)
    want = jsh.mbar_expectations_grid_sharded(u_kn, n_k, d["mbar_grid_jf"], u_targets, x_n, jmake_mesh(WORLD))
    _close(_got(world, "mbar_grid"), want, 1e-11)


def test_uneven_shard_count(world):
    """N = 1002 over 4 ranks: the port's uneven split and the reference's
    -inf padding give the same answer."""
    _, d = world
    u_kn, n_k, u_targets, x_n = d["mbar_uneven"]
    jm = jmake_mesh(WORLD)
    f_j, _, _ = jsh.mbar_solve_sharded(u_kn, n_k, jm)
    f, grid = _got(world, "mbar_uneven")
    _close(f, f_j, 0.0, 1e-11)
    _close(f, jmbar.mbar_solve(u_kn, n_k), 0.0, 1e-11)
    _close(grid, jmbar.mbar_expectations_grid(u_kn, n_k, np.asarray(f), u_targets, x_n), 1e-11)


# -- the pipelines' mesh= against the port's unsharded CPU call at the same seed -------------


@pytest.mark.parametrize(
    ("name", "factory", "kwargs", "key", "extra", "seed", "rtol"),
    [
        # tests/test_pipeline.py:83 (and the dryrun's 1e-8 on sigma)
        ("extrap", "extrap", {"order": 3, "beta0": 2.0, "nrep": 16}, "extrap", (np.array([1.9, 2.2]),), 5, 1e-12),
        # weighted, R = 3001 on 4 ranks (unequal shards)
        ("weighted", "extrap", {"order": 3, "beta0": 2.0, "nrep": 16, "weighted": True}, "weighted", None, 7, 1e-12),
        # tests/test_pipeline.py:444
        ("xalpha", "extrap", {"order": 3, "beta0": 2.0, "xalpha": True, "nrep": 16}, "xalpha", (np.array([1.9, 2.2]),), 0, 1e-12),
        # tests/test_pipeline.py:548
        ("x_is_u", "extrap", {"order": 3, "beta0": 2.0, "x_is_u": True, "nrep": 16}, None, None, 0, 1e-12),
        # tests/test_pipeline.py:209
        ("lnpi", "lnpi", {"order": 3, "beta0": 1.4, "nrep": 16}, "lnpi", (np.array([1.2, 1.6]),), 3, 1e-10),
        # tests/test_pipeline.py:675
        ("volume", "volume", {"volume0": 2.0, "ndim": 3, "nrep": 16}, "volume", (np.array([1.9, 2.2]),), 5, 1e-12),
        # tests/test_pipeline.py:862
        ("perturb", "perturb", {"beta0": 1.0, "nrep": 32}, "perturb", (np.array([0.9, 1.05]),), 11, 1e-10),
    ],
)
def test_pipeline_mesh_equals_unsharded(world, name, factory, kwargs, key, extra, seed, rtol):
    _, d = world
    if name == "weighted":
        u, x, w = d["weighted"]
        args = (u, x, np.array([1.9, 2.2]), w)
    elif name == "x_is_u":
        args = (d["extrap"][0], np.array([1.9, 2.2]))
    else:
        args = (*d[key], *extra)
    pred, std = getattr(tpipe, f"make_{factory}_pipeline")(**kwargs)(*args, seed=seed)
    got_pred, got_std = _got(world, name)
    _close(got_pred, pred, rtol)
    _close(got_std, std, 1e-8, 1e-14)
    assert np.all(np.asarray(got_std)[np.asarray(npy(std)) > 0] > 0)


# -- tests/test_streaming.py -----------------------------------------------------------------


def _stream(factory, kwargs, chunks, *predict_args):
    state, update, predict = getattr(tpipe, f"make_streaming_{factory}_pipeline")(**kwargs)
    for c in chunks:
        state = update(state, *c)
    return predict(state, *predict_args)


def test_streaming_pipeline_mesh_matches_single_device(world):
    """tests/test_streaming.py:208: sharded chunk reductions merged exactly
    equal the one-shot pipeline."""
    _, d = world
    u, x, _ = d["stream"]
    want = tpipe.make_extrap_pipeline(4, 1.0)(u, x, np.array([1.9, 2.2]))
    _close(_got(world, "stream"), want, 1e-12)


@pytest.mark.parametrize("name", ["stream_nrep", "stream_u", "stream_volume", "stream_interp", "stream_lnpi_nrep"])
def test_streaming_mesh_equals_unsharded(world, name):
    """Each streaming factory's mesh= route (chunks sharded, the replicates
    folding the CPU route's per-chunk tables) equals its unsharded CPU
    stream at the same seed."""
    _, d = world
    fn, (_mesh, factory, kwargs, chunks, predict_args) = _cases(d, "")[name]
    pred, std = _stream(factory, kwargs, chunks, *predict_args)
    got_pred, got_std = _got(world, name)
    _close(got_pred, pred, 1e-12)
    _close(got_std, std, 1e-8, 1e-14)


def test_streaming_lnpi_mesh_matches_one_shot(world):
    """The mesh half of tests/test_streaming.py:274."""
    _, d = world
    uv, lnpi0, mudotn = d["stream_lnpi"]
    want = tpipe.make_lnpi_pipeline(3, 1.4)(uv, lnpi0, mudotn, np.array([1.2, 1.4, 1.7]))
    _close(_got(world, "stream_lnpi"), want, 1e-12)


# -- tests/test_gpr_serving.py:228, tests/test_checkpoint.py:59 ------------------------------


def test_sharded_queries_match_single_device(world):
    """Posterior queries sharded over rec come back sharded as they went in,
    equal to the single-device output."""
    want, got, placed = _got(world, "gpr")
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-9, atol=1e-14)
    assert list(placed) == [True, True]


def test_sharded_roundtrip_preserves_sharding(world):
    a, n, same_placement = _got(world, "checkpoint")
    np.testing.assert_array_equal(a, np.arange(64.0))
    assert int(n) == 3 and bool(same_placement)


# -- __graft_entry__.dryrun_multichip ---------------------------------------------------------


def test_dryrun_multichip():
    """The sharded train step and the mesh= pipelines on 4 spawned gloo
    ranks, equal to one device at the reference's bars."""
    dryrun.dryrun_multichip(WORLD, timeout=240.0)

