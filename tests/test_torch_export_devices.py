"""A serving artifact keeps its stored CPU program when it is moved to
another device.

``torch.export.passes.move_to_device_pass`` rewrites the program it is given
in place.  An artifact called first on the card and then on the CPU ran the
card's program on CPU tensors ("Tensor device mismatch! Expected: cuda:0,
Got: cpu"), and one saved after a call on the card would have saved the
card's program.  Here the ``meta`` device stands in for the card: the same
pass moves a program there on a machine without one.
"""

import numpy as np
import pytest
import torch
from _torch_parity import cuda_device, npy  # noqa: F401  (pins the default device to the CPU)

from thermoextrap_tpu_torch import serving_export as se

BETAS = [0.9, 1.1]


@pytest.fixture(scope="module")
def samples():
    g = np.random.default_rng(3)
    u = g.normal(5.0, 1.0, 400)
    return torch.tensor(u), torch.tensor(2.0 + 0.1 * u + 0.01 * g.normal(size=400))


def _on_meta_too(programs):
    """The artifact's programs, allowed on the ``meta`` device besides the CPU."""
    return se._Programs(programs.ep, ("cpu", "meta"))


def test_batch_artifact_keeps_its_cpu_program(samples, tmp_path):
    u, x = samples
    art = se.export_extrap_pipeline(order=3, beta0=1.0)
    ref = (art(u, x, BETAS),)
    art._programs = _on_meta_too(art._programs)
    moved = art._programs.on("meta")
    out = moved(u.to("meta", torch.float32), x[:, None].to("meta", torch.float32), torch.tensor(BETAS, device="meta"),
                se._seed(0, "meta"))
    assert out.device.type == "meta"
    # the CPU program after the move: a fresh module, and the artifact's call
    art._programs._mods.clear()
    for a, b in zip((art(u, x, BETAS),), ref):
        assert torch.equal(a, b)
    # what is saved after the move is the CPU program
    art._programs.platforms = se._PLATFORMS
    art.save(tmp_path / "a.thexport")
    back = se.load_exported(tmp_path / "a.thexport")
    for a, b in zip((back(u, x, BETAS),), ref):
        assert torch.equal(a, b)


def test_bundle_keeps_its_cpu_programs(samples, tmp_path):
    u, x = samples
    bundle = se.export_streaming_extrap_pipeline(3, 1.0)
    s = bundle.init_state("cpu")
    for cu, cx in zip(u.chunk(2), x.chunk(2)):
        s = bundle.update(s, cu, cx)
    ref = (bundle.predict(s, BETAS),)
    bundle._upd = _on_meta_too(bundle._upd)
    bundle._prd = _on_meta_too(bundle._prd)
    bundle._upd.on("meta")
    bundle._prd.on("meta")
    bundle._upd._mods.clear()
    bundle._prd._mods.clear()
    s2 = bundle.init_state("cpu")
    for cu, cx in zip(u.chunk(2), x.chunk(2)):
        s2 = bundle.update(s2, cu, cx)
    for a, b in zip((bundle.predict(s2, BETAS),), ref):
        assert torch.equal(a, b)
    bundle._upd.platforms = bundle._prd.platforms = se._PLATFORMS
    bundle.save(tmp_path / "b.thexport")
    back = se.load_exported(tmp_path / "b.thexport")
    s3 = back.init_state("cpu")
    for cu, cx in zip(u.chunk(2), x.chunk(2)):
        s3 = back.update(s3, cu, cx)
    for a, b in zip((back.predict(s3, BETAS),), ref):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_artifact_on_the_card_then_the_cpu(samples, cuda_device):  # noqa: F811
    u, x = samples
    art = se.export_extrap_pipeline(order=3, beta0=1.0, nrep=8)
    card = art(u.to(cuda_device), x.to(cuda_device), BETAS, seed=5)
    cpu = art(u, x, BETAS, seed=5)
    assert card[0].is_cuda and cpu[0].device.type == "cpu"
    for a, b in zip(card, cpu):
        np.testing.assert_allclose(npy(a), npy(b), rtol=1e-5, atol=1e-7)
