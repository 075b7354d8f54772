"""``thermoextrap_tpu_torch.utils.timing.kchain_time`` against its contract,
the port's mirror of ``tests/test_moments.py::test_kchain_time_measures_and_chains``:
the ``K_hi`` chain applies the step exactly ``k_hi`` times, the time is
finite, ``k_hi <= k_lo`` raises, and a difference under the device's noise
floor warns."""

import math
import warnings

import numpy as np
import pytest
import torch
from _torch_parity import cuda_device, npy  # noqa: F401  (pins the default device to the CPU)

from thermoextrap_tpu_torch.utils import timing
from thermoextrap_tpu_torch.utils.timing import kchain_time


def test_kchain_time_measures_and_chains():
    # x -> x + 1 once a call: the K_hi chain's output counts the calls
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        t, (out,) = kchain_time(lambda x: (x + 1.0,), (torch.zeros(16),), k_lo=2, k_hi=10, reps=1)
    assert math.isfinite(t)
    np.testing.assert_allclose(npy(out), 10.0)


def test_kchain_time_matches_the_jax_chain():
    import jax.numpy as jnp

    from thermoextrap_tpu.utils.timing import kchain_time as jax_kchain_time

    def step(a, b):
        return a * 0.5 + b, b + 1.0

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _, ref = jax_kchain_time(step, (jnp.ones(8), jnp.zeros(8)), k_lo=2, k_hi=7, reps=1)
        _, got = kchain_time(step, (torch.ones(8, dtype=torch.float32), torch.zeros(8)), k_lo=2, k_hi=7, reps=1)
    assert len(got) == len(ref) == 2
    for g, r in zip(got, ref):
        np.testing.assert_allclose(npy(g), np.asarray(r), rtol=1e-6)


@pytest.mark.parametrize(("k_lo", "k_hi"), [(5, 5), (6, 3)])
def test_kchain_time_refuses_short_chains(k_lo, k_hi):
    with pytest.raises(ValueError, match="k_hi > k_lo"):
        kchain_time(lambda x: (x,), (torch.zeros(2),), k_lo=k_lo, k_hi=k_hi)


def test_kchain_time_warns_under_the_noise_floor():
    # one more call of a step that does nothing: far under any floor
    with pytest.warns(UserWarning, match="noise floor of the host clock"):
        t, (out,) = kchain_time(lambda x: x, (torch.zeros(4),), k_lo=1, k_hi=2, reps=3)
    assert math.isfinite(t)
    assert float(out.sum()) == 0.0


def test_kchain_time_warns_by_the_device_floor(monkeypatch):
    step = lambda x: x + 1.0  # noqa: E731  (a bare tensor carry)
    monkeypatch.setitem(timing.NOISE_FLOOR_S, "cpu", math.inf)
    with pytest.warns(UserWarning, match="noise floor"):
        kchain_time(step, (torch.zeros(4),), k_lo=1, k_hi=3, reps=1)
    monkeypatch.setitem(timing.NOISE_FLOOR_S, "cpu", -math.inf)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        _, (out,) = kchain_time(step, (torch.zeros(4),), k_lo=1, k_hi=3, reps=1)
    np.testing.assert_allclose(npy(out), 3.0)


def test_kchain_time_takes_numpy_operands_on_the_default_device():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _, (out,) = kchain_time(lambda x: (x * 2.0,), (np.ones(3),), k_lo=1, k_hi=4, reps=1)
    assert isinstance(out, torch.Tensor) and out.device.type == "cpu" and out.dtype == torch.float64
    np.testing.assert_allclose(npy(out), 16.0)


def test_noise_floor_measurement_shape():
    rec = timing._noise_floor("cpu", trials=4, k_lo=1, k_hi=3)
    assert rec["device"] == "cpu" and rec["trials"] == 4
    assert rec["delta_sd_s"] >= 0.0 and rec["floor_s"] == 10.0 * rec["delta_sd_s"]


@pytest.mark.cuda
def test_kchain_time_on_the_card_uses_events(cuda_device):  # noqa: F811
    x = torch.zeros(1 << 20, device=cuda_device)
    t, (out,) = kchain_time(lambda a: a + 1.0, (x,), k_lo=4, k_hi=68, reps=3)
    assert out.is_cuda and float(out[0]) == 68.0
    assert 0.0 < t < 1e-2
