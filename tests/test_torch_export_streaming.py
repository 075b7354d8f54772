"""The torch port's streaming bundles (``export_streaming_*_pipeline``) and
the ``xla_only=`` route of the four streaming factories they trace, against
the JAX package and the port's own routes, on the CPU.

Mirrors tests/test_export.py :214-:392, :432-:452, :465-:492, :588-:636 and
:746-:820.  Inputs are made with numpy from a seed.  Bars, with their
reasons:

- a bundle against the in-process ``xla_only=True`` stream fed the same
  chunks: rtol 1e-12 (the same program, traced and eager);
- float64 bundles and ``xla_only`` streams against the JAX package's, on
  the deterministic leg: rtol 1e-10 (the same merge in another order);
  float32 bundles against the JAX suite's float32 pipelines: its 2e-6
  (the port sums each chunk in float64);
- the ``xla_only`` replicates: rtol 1e-10 against the plain versions of
  K3 / K5 / K8 on the chunk's seed (the same counts, bit for bit);
- any chunking against one shot: rtol 1e-10;
- bootstrap σ against the JAX package's, whose counts are other draws: a
  ratio within [0.7, 1.4] at 256 replicates.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import assert_close, npy, tt

from thermoextrap_tpu import pipeline as jpipe
from thermoextrap_tpu import serving_export as jse
from thermoextrap_tpu_torch import DataCentralMoments
from thermoextrap_tpu_torch import pipeline as tpipe
from thermoextrap_tpu_torch import serving_export as se
from thermoextrap_tpu_torch.ops import moments_cuda as mc
from thermoextrap_tpu_torch.ops import resample as tresample

ROOT = Path(__file__).resolve().parent.parent
F64 = {"dtype": torch.float64}


def _data(r=257, v=2, seed=0):
    rng = np.random.default_rng(seed)
    return 5.0 + rng.normal(size=r), 2.0 + 0.4 * rng.normal(size=(r, v))


@pytest.fixture(scope="module")
def extrap_bundle():
    """test_export.py:218's bundle (nrep 8, weighted, two values), float64."""
    return se.export_streaming_extrap_pipeline(3, 1.0, nrep=8, weighted=True, val_shape=(2,), **F64)


# -- the traced draw ---------------------------------------------------------------------------


@pytest.mark.parametrize(("seed", "nrep", "nrec", "start"), [(0, 3, 10, 0), (2**63 + 11, 5, 37, 8), (2**64 - 1, 2, 1, 0), (123456789, 7, 4099, 4096)])
def test_traced_draw_equals_poisson_counts(seed, nrep, nrec, start):
    """``philox_poisson1_counts`` on a tensor seed is ``_poisson_counts``
    (the counts K3, K5 and K8 draw) bit for bit, a seed past 2^63 and a
    ``start`` offset included, eager and inside an exported program whose
    sample count is symbolic."""
    want = mc._poisson_counts(seed, nrep, nrec, start=start)
    got = tresample.philox_poisson1_counts(tresample.seed_tensor(seed), nrep, nrec, start=start)
    assert got.dtype == torch.int32 and torch.equal(got, want)
    ep = se._do_export(
        lambda u, s: tresample.philox_poisson1_counts(s, nrep, u.shape[0], start=start),
        [torch.zeros(6), tresample.seed_tensor(0)],
        [{0: torch.export.Dim("R", min=1)}, None],
    )
    assert torch.equal(ep.module()(torch.zeros(nrec), tresample.seed_tensor(seed)), want)


def test_chunk_seed_is_the_pipelines():
    """The traced chunk seed is ``pipeline._chunk_seed`` on int64 bits."""
    for seed, step in [(0, 0), (7, 3), (2**64 - 5, 11), (2**63, 2**40)]:
        got = tresample.chunk_seed(tresample.seed_tensor(seed), torch.tensor(step))
        assert int(got) == tresample.signed64(tpipe._chunk_seed(seed, step))


# -- the xla_only route ------------------------------------------------------------------------


def _fold(update, state, chunks):
    for c in chunks:
        state = update(state, *c)
    return state


def test_xla_only_extrap_is_one_shot_and_the_kernels_counts():
    """``xla_only=True``: every chunking gives the one-shot mean state, and
    each chunk's replicates fold the counts K3 draws at its seed (the plain
    version of K3 on the same chunk and seed)."""
    uv, xv = _data(300)
    w = np.random.default_rng(2).uniform(0.5, 1.5, 300)
    state0, update, _ = tpipe.make_streaming_extrap_pipeline(3, 1.0, val_shape=(2,), nrep=16, seed=5, xla_only=True)
    assert state0[2].dtype == torch.int64 and state0[2].ndim == 0
    one = DataCentralMoments.from_vals(tt(xv), tt(uv), 3, weight=tt(w))
    means = []
    for cuts in ([0, 300], [0, 100, 300], [0, 50, 100, 150, 200, 250, 300]):
        st = _fold(update, state0, [(uv[a:b], xv[a:b], w[a:b]) for a, b in zip(cuts[:-1], cuts[1:])])
        assert int(st[2]) == len(cuts) - 1
        for f in ("xave", "uave", "du", "dxdu", "wsum"):
            assert_close(getattr(st[0], f), getattr(one, f), 1e-10, 1e-13)
        means.append(st[0])
    st1 = update(state0, uv[:120], xv[:120], w[:120])
    bx, bu, bdu, bdxdu, bw = mc.resample_poisson_plain(tt(uv[:120]), tt(xv[:120]), 16, 3, tt(w[:120]), seed=tpipe._chunk_seed(5, 0))
    assert_close((st1[1].xave, st1[1].uave, st1[1].dxdu, st1[1].wsum), (bx, bu, bdxdu, bw), 1e-10, 1e-13)
    assert_close(st1[1].du[..., 0], bdu, 1e-10, 1e-13)


def test_xla_only_x_is_u_and_lnpi_fold_k5s_counts():
    """``xla_only=True`` with ``x_is_u`` and on the lnΠ grid: the
    replicates of a chunk are K5's plain version at the chunk's seed."""
    uv, _ = _data(200)
    state0, update, _ = tpipe.make_streaming_extrap_pipeline(3, 1.0, x_is_u=True, nrep=8, seed=3, xla_only=True)
    st = update(update(state0, uv[:120]), uv[120:])
    bu, bdu, bw = mc.resample_umoments_poisson_plain(tt(uv[120:])[None], None, 8, 4, seed=tpipe._chunk_seed(3, 1))
    chunk = DataCentralMoments.zeros(3, batch_shape=(8,), x_is_u=True, **F64)
    first = update(state0, uv[:120])[1]
    import dataclasses

    chunk = dataclasses.replace(chunk, xave=bu[:, 0], uave=bu[:, 0], du=bdu[:4, :, 0], dxdu=bdu[1:5, :, 0], wsum=bw[:, 0])
    want = first.merge(chunk)
    assert_close((st[1].uave, st[1].du, st[1].dxdu, st[1].wsum), (want.uave, want.du, want.dxdu, want.wsum), 1e-10, 1e-13)
    rng = np.random.default_rng(4)
    grid = rng.normal(-10, 1, (3, 90))
    s0, upd, _ = tpipe.make_streaming_lnpi_pipeline(2, 1.0, grid_shape=(3,), nrep=8, seed=6, xla_only=True)
    sl = upd(s0, grid)
    gu, gdu, gw = mc.resample_umoments_poisson_plain(tt(grid), None, 8, 3, seed=tpipe._chunk_seed(6, 0))
    assert_close((sl[1].uave, sl[1].du, sl[1].dxdu, sl[1].wsum), (gu, gdu[:3], gdu[1:4], gw), 1e-10, 1e-13)


def test_xla_only_matches_jax_xla_only():
    """The port's ``xla_only`` streams against the JAX package's, float64:
    the mean leg of extrap, volume, lnΠ and perturb at 1e-10; σ of the
    extrapolation statistically."""
    uv, xv = _data(4096)
    chunks = [(uv[:1500], xv[:1500]), (uv[1500:], xv[1500:])]
    betas = np.array([0.9, 1.1])
    pt = tpipe.make_streaming_extrap_pipeline(3, 1.0, val_shape=(2,), nrep=256, seed=1, xla_only=True, **F64)
    pj = jpipe.make_streaming_extrap_pipeline(3, 1.0, val_shape=(2,), nrep=256, seed=1, xla_only=True, dtype=jnp.float64)
    (tp, ts), (jp, js) = (p[2](_fold(p[1], p[0], chunks), betas) for p in (pt, pj))
    assert_close(tp, jp, 1e-10)
    ratio = npy(ts) / np.asarray(js)
    assert np.all((ratio > 0.7) & (ratio < 1.4)), ratio
    vt = tpipe.make_streaming_volume_pipeline(2.0, xla_only=True, **F64)
    vj = jpipe.make_streaming_volume_pipeline(2.0, xla_only=True, dtype=jnp.float64)
    vch = [(uv[:1500] / 5, xv[:1500, 0], xv[:1500, 1]), (uv[1500:] / 5, xv[1500:, 0], xv[1500:, 1])]
    assert_close(vt[2](_fold(vt[1], vt[0], vch), betas + 1.0), vj[2](_fold(vj[1], vj[0], vch), betas + 1.0), 1e-10)
    grid = np.random.default_rng(3).normal(-10, 1, (4, 300))
    lt = tpipe.make_streaming_lnpi_pipeline(2, 1.0, grid_shape=(4,), xla_only=True, **F64)
    lj = jpipe.make_streaming_lnpi_pipeline(2, 1.0, grid_shape=(4,), xla_only=True, dtype=jnp.float64)
    lch = [(grid[:, :100],), (grid[:, 100:],)]
    largs = (np.linspace(0, -2, 4), 0.5 * np.arange(4), betas)
    assert_close(lt[2](_fold(lt[1], lt[0], lch), *largs), lj[2](_fold(lj[1], lj[0], lch), *largs), 1e-10)
    qt = tpipe.make_streaming_perturb_pipeline(1.0, betas, val_shape=(2,), xla_only=True, **F64)
    qj = jpipe.make_streaming_perturb_pipeline(1.0, betas, val_shape=(2,), xla_only=True, dtype=jnp.float64)
    assert_close(qt[2](_fold(qt[1], qt[0], chunks)), qj[2](_fold(qj[1], qj[0], chunks)), 1e-10)


def test_streaming_perturb_counts_by_route():
    """The streaming perturbation's replicates: ``xla_only`` folds K8's
    counts at the chunk's seed (its plain version), and the CPU default
    route keeps its generator table."""
    uv, xv = _data(150)
    betas = np.array([0.9, 1.2])
    s0, upd, _ = tpipe.make_streaming_perturb_pipeline(1.0, betas, val_shape=(2,), nrep=8, seed=4, xla_only=True)
    st = upd(s0, uv, xv)
    e = tpipe._perturb_weights(tt(uv), tt(betas) - 1.0, None)
    s = mc.resample_perturb_poisson_plain(e, tt(xv), 8, seed=tpipe._chunk_seed(4, 0))
    assert_close((st[3], st[4]), (s[..., :2], s[..., 2]), 1e-10, 1e-13)
    d0, dupd, _ = tpipe.make_streaming_perturb_pipeline(1.0, betas, val_shape=(2,), nrep=8, seed=4)
    dst = dupd(d0, uv, xv)
    gen = torch.Generator().manual_seed(tpipe._chunk_seed(4, 0))
    freq = tresample.poisson1_freq(gen, (8, 150), dtype=torch.float64)
    s = mc.resample_perturb_freq(e, tt(xv), freq)
    assert_close((dst[3], dst[4]), (s[..., :2], s[..., 2]), 1e-10, 1e-13)


# -- the bundles (test_export.py TestStreamingBundle) -----------------------------------------


def test_extrap_bundle_matches_pipeline(extrap_bundle, tmp_path):
    """test_export.py:218: through a file, two chunk lengths, against the
    in-process ``xla_only`` stream and the JAX bundle's mean."""
    rng = np.random.default_rng(1)
    path = tmp_path / "stream.bin"
    extrap_bundle.save(path)
    art = se.load_exported(path)
    assert isinstance(art, se.StreamingExportedPipeline)
    assert art.meta["family"] == "streaming_extrap"
    s0, upd, prd = tpipe.make_streaming_extrap_pipeline(3, 1.0, nrep=8, val_shape=(2,), xla_only=True, **F64)
    jart = jse.export_streaming_extrap_pipeline(3, 1.0, nrep=8, weighted=True, val_shape=(2,), dtype=jnp.float64)
    state, st, jst = art.init_state(), s0, jart.init_state()
    for n in (70, 58, 1):
        uv = rng.normal(2.0, 1.0, n)
        xv = rng.normal(1.0, 0.3, (n, 2))
        w = rng.uniform(0.5, 1.5, n)
        state = art.update(state, uv, xv, weight=w)
        st = upd(st, uv, xv, weight=w)
        jst = jart.update(jst, uv, xv, weight=w)
    betas = np.array([0.9, 1.1])
    assert_close(art.predict(state, betas), prd(st, betas), 1e-12, 1e-15)
    assert_close(art.predict(state, betas)[0], jart.predict(jst, betas)[0], 1e-10)


def test_lnpi_bundle_matches_pipeline(tmp_path):
    """test_export.py:245."""
    rng = np.random.default_rng(2)
    grid = (4,)
    art = se.export_streaming_lnpi_pipeline(2, 1.0, grid_shape=grid, nrep=4)
    path = tmp_path / "lnpi.bin"
    art.save(path)
    art2 = se.load_exported(path)
    s0, upd, prd = tpipe.make_streaming_lnpi_pipeline(2, 1.0, grid_shape=grid, nrep=4, xla_only=True, dtype=torch.float32)
    jart = jse.export_streaming_lnpi_pipeline(2, 1.0, grid_shape=grid)
    state, st, jst = art2.init_state(), s0, jart.init_state()
    for r in (40, 24):
        uvg = (-10.0 + rng.normal(0, 1, (*grid, r))).astype(np.float32)
        state = art2.update(state, uvg)
        st = upd(st, uvg)
        jst = jart.update(jst, uvg)
    lnpi0 = np.linspace(0, -2, 4).astype(np.float32)
    mud = (0.5 * np.arange(4)).astype(np.float32)
    betas = np.array([0.9, 1.1], np.float32)
    assert_close(art2.predict(state, lnpi0, mud, betas), prd(st, lnpi0, mud, betas), 1e-12, 1e-15)
    assert_close(art2.predict(state, lnpi0, mud, betas)[0], jart.predict(jst, lnpi0, mud, betas), 1e-5, 1e-6)


def test_state_checkpoint_roundtrip(tmp_path):
    """test_export.py:270: a state tuple persisted as plain arrays and
    resumed continues the fold exactly."""
    rng = np.random.default_rng(3)
    art = se.export_streaming_extrap_pipeline(2, 1.0)
    state = art.update(art.init_state(), rng.normal(2, 1, 32), rng.normal(1, 0.2, 32))
    np.savez(tmp_path / "ckpt.npz", *(npy(a) for a in state))
    with np.load(tmp_path / "ckpt.npz") as z:
        back = tuple(torch.as_tensor(z[k]) for k in z.files)
    uv2 = rng.normal(2, 1, 16)
    xv2 = rng.normal(1, 0.2, 16)
    a = art.predict(art.update(state, uv2, xv2), [1.0])
    b = art.predict(art.update(back, uv2, xv2), [1.0])
    np.testing.assert_array_equal(npy(a), npy(b))


def test_bf16_bundle_roundtrip(tmp_path):
    """test_export.py:289: bfloat16 state leaves survive the file and the
    checkpoint helpers (written as their 16-bit patterns)."""
    rng = np.random.default_rng(7)
    art = se.export_streaming_extrap_pipeline(2, 1.0, dtype=torch.bfloat16)
    path = tmp_path / "bf16.bin"
    art.save(path)
    art2 = se.load_exported(path)
    state = art2.init_state()
    assert all(a.dtype == torch.bfloat16 for a in state)
    for a, b in zip(state, art.init_state()):
        assert torch.equal(a, b)
    uv = rng.normal(2, 1, 32).astype(np.float32)
    xv = 2 * uv
    state = art2.update(state, uv, xv)
    want = art.predict(art.update(art.init_state(), uv, xv), [1.0])
    np.testing.assert_array_equal(npy(art2.predict(state, [1.0])), npy(want))
    art2.save_state(tmp_path / "st.bin", state)
    back = art2.load_state(tmp_path / "st.bin")
    for a, b in zip(back, state):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_update_requires_xv():
    """test_export.py:319."""
    art = se.export_streaming_extrap_pipeline(2, 1.0)
    with pytest.raises(ValueError, match="xv"):
        art.update(art.init_state(), np.ones(4, np.float32))


def test_weight_guards():
    """test_export.py:324."""
    rng = np.random.default_rng(4)
    uv = rng.normal(2, 1, 8)
    art_w = se.export_streaming_extrap_pipeline(2, 1.0, weighted=True)
    with pytest.raises(ValueError, match="weighted=True"):
        art_w.update(art_w.init_state(), uv, 2 * uv)
    art_u = se.export_streaming_extrap_pipeline(2, 1.0)
    with pytest.raises(ValueError, match="no weight operand"):
        art_u.update(art_u.init_state(), uv, 2 * uv, weight=np.ones(8))


def test_init_state_is_fresh():
    """test_export.py:335."""
    art = se.export_streaming_extrap_pipeline(2, 1.0)
    for a, b in zip(art.init_state(), art.init_state()):
        assert a is not b and a.data_ptr() != b.data_ptr()
        assert torch.equal(a, b)


def test_bundle_cross_process_reload(tmp_path):
    """test_export.py:343: init, two updates and predict in a fresh
    interpreter with ``torch.export.export`` patched to raise and no jax."""
    art = se.export_streaming_extrap_pipeline(2, 1.0)
    path = tmp_path / "stream.thexport"
    art.save(path)
    rng = np.random.default_rng(5)
    uv = rng.normal(2, 1, 48).astype(np.float32)
    xv = 3 * uv + 1
    np.save(tmp_path / "uv.npy", uv)
    np.save(tmp_path / "xv.npy", xv)
    st = art.update(art.update(art.init_state(), uv[:30], xv[:30]), uv[30:], xv[30:])
    want = npy(art.predict(st, [1.0, 1.2]))
    child = f"""
import sys
import numpy as np
import torch, torch.export
def _refuse(*a, **k):
    raise RuntimeError("traced in the serving process")
torch.export.export = _refuse
from thermoextrap_tpu_torch import set_default_device
from thermoextrap_tpu_torch.serving_export import load_exported
set_default_device("cpu")
art = load_exported({str(path)!r})
uv = np.load({str(tmp_path / 'uv.npy')!r})
xv = np.load({str(tmp_path / 'xv.npy')!r})
st = art.update(art.init_state(), uv[:30], xv[:30])
st = art.update(st, uv[30:], xv[30:])
np.save({str(tmp_path / 'out.npy')!r}, art.predict(st, [1.0, 1.2]).numpy())
print("META", art.meta["family"], art.meta["order"], "jax" in sys.modules)
"""
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    proc = subprocess.run([sys.executable, "-c", child], capture_output=True, text=True, timeout=300, check=False, env=env)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "META streaming_extrap 2 False" in proc.stdout
    np.testing.assert_array_equal(np.load(tmp_path / "out.npy"), want)


def _xalpha_data(r=257, order=3, seed=0):
    rng = np.random.default_rng(seed)
    uv = 5.0 + rng.normal(size=r)
    base = 2.0 + 0.4 * rng.normal(size=(r, 1))
    xv = np.zeros((r, order + 1, 1))
    xv[:, 0] = 2.0 * base
    xv[:, 1] = base
    return uv, xv


def test_streaming_export_xalpha_matches_inprocess():
    """test_export.py:432."""
    bun = se.export_streaming_extrap_pipeline(order=3, beta0=1.0, xalpha=True, val_shape=(1,), **F64)
    uv, xv = _xalpha_data(300)
    betas = np.array([0.8, 1.0, 1.3])
    cuts = [(0, 200), (200, 300)]
    st = _fold(bun.update, bun.init_state(), [(uv[a:b], xv[a:b]) for a, b in cuts])
    got = bun.predict(st, betas)
    s0, upd, prd = tpipe.make_streaming_extrap_pipeline(3, 1.0, xalpha=True, val_shape=(1,), xla_only=True, **F64)
    assert_close(got, prd(_fold(upd, s0, [(uv[a:b], xv[a:b]) for a, b in cuts]), betas), 1e-12, 1e-15)
    j0, jupd, jprd = jpipe.make_streaming_extrap_pipeline(3, 1.0, xalpha=True, val_shape=(1,), xla_only=True, dtype=jnp.float64)
    assert_close(got, jprd(_fold(jupd, j0, [(uv[a:b], xv[a:b]) for a, b in cuts]), betas), 1e-10)


def test_streaming_export_x_is_u_roundtrip(tmp_path):
    """test_export.py:465."""
    bun = se.export_streaming_extrap_pipeline(order=3, beta0=1.0, x_is_u=True, nrep=16, **F64)
    path = tmp_path / "xisu.thexport"
    bun.save(path)
    bun2 = se.load_exported(path)
    uv, _ = _data(300)
    betas = np.array([0.8, 1.0, 1.3])
    st = _fold(bun2.update, bun2.init_state(), [(uv[:200],), (uv[200:],)])
    pred, std = (npy(a) for a in bun2.predict(st, betas))
    assert np.all(np.isfinite(pred)) and np.all(std > 0)
    s0, upd, prd = tpipe.make_streaming_extrap_pipeline(3, 1.0, x_is_u=True, nrep=16, xla_only=True, **F64)
    assert_close((pred, std), prd(_fold(upd, s0, [(uv[:200],), (uv[200:],)]), betas), 1e-12, 1e-15)
    j0, jupd, jprd = jpipe.make_streaming_extrap_pipeline(3, 1.0, x_is_u=True, xla_only=True, dtype=jnp.float64)
    assert_close(pred, jprd(_fold(jupd, j0, [(uv[:200],), (uv[200:],)]), betas), 1e-10)
    with pytest.raises(ValueError, match="x_is_u"):
        bun2.update(bun2.init_state(), uv, np.ones((300, 1)))


def test_streaming_volume_bundle_matches_pipeline(tmp_path):
    """test_export.py:588."""
    rng = np.random.default_rng(5)
    r = 4000
    wv = rng.normal(1.0, 0.4, r).astype(np.float32)
    xv = (0.5 + 0.3 * wv + 0.2 * rng.normal(size=r)).astype(np.float32)
    dxdqv = (0.1 * xv + 0.05 * rng.normal(size=r)).astype(np.float32)
    w = rng.uniform(0.5, 1.5, r).astype(np.float32)
    vols = np.array([1.8, 2.0, 2.3], np.float32)
    art = se.export_streaming_volume_pipeline(2.0, ndim=3, weighted=True)
    st = art.update(art.init_state(), wv[:1500], xv[:1500], dxdqv=dxdqv[:1500], weight=w[:1500])
    st = art.update(st, wv[1500:], xv[1500:], dxdqv=dxdqv[1500:], weight=w[1500:])
    ref = tpipe.make_volume_pipeline(2.0, ndim=3, weighted=True)(wv, xv, dxdqv, vols, w)
    assert_close(art.predict(st, vols), ref, 2e-6, 2e-7)
    art_b = se.export_streaming_volume_pipeline(2.0, ndim=3, nrep=16, seed=9)
    stb = art_b.update(art_b.init_state(), wv[:1500], xv[:1500], dxdqv=dxdqv[:1500])
    path = tmp_path / "vol_bundle.bin"
    spath = tmp_path / "vol_state.ckpt"
    art_b.save(path)
    art_b.save_state(spath, stb)
    art2 = se.load_exported(path)
    st2 = art2.update(art2.load_state(spath), wv[1500:], xv[1500:], dxdqv=dxdqv[1500:])
    pred, std = art2.predict(st2, vols)
    assert np.all(npy(std) > 0)
    assert_close(pred, tpipe.make_volume_pipeline(2.0, ndim=3)(wv, xv, dxdqv, vols), 2e-6, 2e-7)
    with pytest.raises(ValueError, match="dxdqv"):
        art_b.update(stb, wv, xv)
    with pytest.raises(ValueError, match="weight"):
        art_b.update(stb, wv, xv, dxdqv=dxdqv, weight=w)
    ext = se.export_streaming_extrap_pipeline(2, 1.0)
    with pytest.raises(ValueError, match="streaming_volume"):
        ext.update(ext.init_state(), wv, xv, dxdqv=dxdqv)


def test_streaming_perturb_bundle_matches_inprocess(tmp_path):
    """test_export.py:746: same chunking and seed, identical states;
    ``predict`` takes no arguments; the state checkpoint keeps the ``-inf``
    maximum row and the int64 chunk counter."""
    betas = np.array([0.9, 1.0, 1.2])
    art = se.export_streaming_perturb_pipeline(1.0, betas, val_shape=(2,), nrep=16, seed=3, **F64)
    path = tmp_path / "sperturb.thexport"
    art.save(path)
    art = se.load_exported(path)
    assert art.meta["family"] == "streaming_perturb"
    assert art.meta["betas"] == pytest.approx([0.9, 1.0, 1.2])
    st_p, update, predict = tpipe.make_streaming_perturb_pipeline(1.0, betas, val_shape=(2,), nrep=16, seed=3, xla_only=True, **F64)
    st_a = art.init_state()
    assert torch.isinf(st_a[0]).all() and st_a[5].dtype == torch.int64
    uv, xv = _data(300)
    for lo, hi in ((0, 100), (100, 300)):
        st_a = art.update(st_a, uv[lo:hi], xv[lo:hi])
        st_p = update(st_p, uv[lo:hi], xv[lo:hi])
    assert_close(art.predict(st_a), predict(st_p), 1e-12, 1e-15)
    with pytest.raises(ValueError, match="takes only"):
        art.predict(st_a, betas)
    ck = tmp_path / "st.ckpt"
    art.save_state(ck, st_a)
    st_back = art.load_state(ck)
    assert st_back[5].dtype == torch.int64 and int(st_back[5]) == 2
    np.testing.assert_array_equal(npy(art.predict(st_back)[0]), npy(art.predict(st_a)[0]))


def test_streaming_perturb_bundle_weighted(tmp_path):
    """test_export.py:785: a zero-weight chunk is a no-op, weights match the
    in-process pipeline and the JAX pipeline, and the missing-xv message
    names the perturbation family."""
    betas = np.array([0.8, 1.1])
    art = se.export_streaming_perturb_pipeline(1.0, betas, val_shape=(2,), weighted=True)
    path = tmp_path / "sperturb_w.thexport"
    art.save(path)
    art = se.load_exported(path)
    assert art.meta["weighted"] is True
    uv, xv = (a.astype(np.float32) for a in _data(200))
    w = np.linspace(0.5, 2.0, 200).astype(np.float32)
    st = art.update(art.init_state(), uv, xv, weight=w)
    pred0 = npy(art.predict(st))
    st_z = art.update(st, uv[:64], xv[:64], weight=np.zeros(64, np.float32))
    np.testing.assert_allclose(npy(art.predict(st_z)), pred0, rtol=1e-6, atol=1e-7)
    st_p, update, predict = tpipe.make_streaming_perturb_pipeline(1.0, betas, val_shape=(2,), dtype=torch.float32)
    np.testing.assert_allclose(pred0, npy(predict(update(st_p, uv, xv, w))), rtol=2e-6, atol=2e-6)
    j0, jupd, jprd = jpipe.make_streaming_perturb_pipeline(1.0, betas, val_shape=(2,))
    np.testing.assert_allclose(pred0, np.asarray(jprd(jupd(j0, uv, xv, w))), rtol=2e-6, atol=2e-6)
    with pytest.raises(ValueError, match="weighted=True"):
        art.update(st, uv, xv)
    with pytest.raises(ValueError, match="perturb streaming update"):
        art.update(st, uv, weight=w)
