"""tests/test_compat.py on the torch port (the labeled-array adapter, against
the JAX package on the same inputs), the adapter's doctest, and the random
seam's ``split``."""

import doctest

import numpy as np
import pytest
import torch
from _torch_parity import npy

import thermoextrap_tpu as jx
from thermoextrap_tpu.compat import LabeledArray as JLabeled
from thermoextrap_tpu.compat import from_labeled as j_from_labeled
from thermoextrap_tpu_torch import beta, compat, factory_data_values, idealgas, random
from thermoextrap_tpu_torch.compat import LabeledArray, from_labeled, predict_labeled

RTOL = 1e-13


def test_any_axis_order_matches_positional(rng_np):
    uv = rng_np.normal(3.0, 1.0, 400)
    xv = rng_np.normal(1.0, 0.5, (400, 3))
    want = factory_data_values(uv=uv, xv=xv, order=4, central=True)
    got = from_labeled(LabeledArray(uv, ("rec",)), LabeledArray(xv.T, ("val", "rec")), order=4, central=True)
    np.testing.assert_allclose(npy(got.dxdu), npy(want.dxdu), rtol=RTOL)
    np.testing.assert_allclose(npy(got.xave), npy(want.xave), rtol=RTOL)
    ref = j_from_labeled(JLabeled(uv, ("rec",)), JLabeled(xv.T, ("val", "rec")), order=4, central=True)
    np.testing.assert_allclose(npy(got.dxdu), np.asarray(ref.dxdu), rtol=1e-10, atol=1e-14)


def test_deriv_dim_sets_xalpha(rng_np):
    uv = rng_np.normal(3.0, 1.0, 200)
    xv = rng_np.normal(1.0, 0.5, (200, 3, 2))
    want = factory_data_values(uv=uv, xv=xv, order=2, central=True, xalpha=True)
    got = from_labeled(
        LabeledArray(uv, ("rec",)),
        LabeledArray(np.transpose(xv, (2, 1, 0)), ("val", "deriv", "rec")),
        order=2,
        central=True,
        deriv_dim="deriv",
    )
    assert got.xalpha
    np.testing.assert_allclose(npy(got.dxdu), npy(want.dxdu), rtol=RTOL)


def test_labeled_weight_and_validation(rng_np):
    uv = rng_np.normal(3.0, 1.0, 100)
    xv = rng_np.normal(1.0, 0.5, (100, 1))
    w = rng_np.uniform(0.5, 1.5, 100)
    want = factory_data_values(uv=uv, xv=xv, order=3, central=True, weight=w)
    got = from_labeled(
        LabeledArray(uv, ("rec",)), LabeledArray(xv, ("rec", "val")), order=3, central=True, weight=LabeledArray(w, ("rec",))
    )
    np.testing.assert_allclose(npy(got.du), npy(want.du), rtol=RTOL)
    with pytest.raises(ValueError, match="rec"):
        from_labeled(LabeledArray(uv, ("time",)), LabeledArray(xv, ("rec", "val")), 2)
    with pytest.raises(TypeError, match="labeled"):
        from_labeled(uv, LabeledArray(xv, ("rec", "val")), 2)
    with pytest.raises(ValueError, match="dims"):
        LabeledArray(xv, ("rec",))


def test_predict_labeled_end_to_end(rng_np):
    x, u = idealgas.generate_data((5000, 1), 2.0, rng=int(rng_np.integers(2**31)))
    data = from_labeled(LabeledArray(npy(u), ("rec",)), LabeledArray(npy(x)[:, None], ("rec", "val")), order=2, central=True)
    out = predict_labeled(beta.factory_extrapmodel(2.0, data), [1.9, 2.0, 2.1], val_dims=("val",))
    assert out.dims == ("beta", "val")
    assert isinstance(out.values, np.ndarray)
    assert np.asarray(out).shape == (3, 1)
    np.testing.assert_allclose(np.asarray(out)[1, 0], np.mean(npy(x)), rtol=1e-10)
    ref = jx.compat.predict_labeled(
        jx.beta.factory_extrapmodel(
            2.0, j_from_labeled(JLabeled(npy(u), ("rec",)), JLabeled(npy(x)[:, None], ("rec", "val")), order=2, central=True)
        ),
        [1.9, 2.0, 2.1],
        val_dims=("val",),
    )
    np.testing.assert_allclose(out.values, np.asarray(ref.values), rtol=1e-10)
    with pytest.raises(ValueError, match="val_dims"):
        predict_labeled(beta.factory_extrapmodel(2.0, data), [2.0], val_dims=("a", "b"))


def test_compat_doctest():
    assert doctest.testmod(compat, raise_on_error=True).attempted == 5


def test_split_gives_independent_generators():
    """``split`` makes ``num`` generators on the source's device, seeded from
    its draws: the same seed gives the same streams, and they differ."""
    a = [torch.rand(4, generator=g) for g in random.split(5, 3)]
    b = [torch.rand(4, generator=g) for g in random.split(torch.Generator().manual_seed(5), 3)]
    assert len(a) == 3
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    assert not torch.equal(a[0], a[1])
    assert random.validate_rng(None).initial_seed() == 0
