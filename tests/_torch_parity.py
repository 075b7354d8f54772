"""Shared helpers of the torch-port parity tests: numpy inputs go through the
JAX package and through ``thermoextrap_tpu_torch``, and the outputs are
compared as numpy arrays."""

import numpy as np
import pytest
import torch

import thermoextrap_tpu_torch as tx

# The parity tests compare float64 CPU paths: numpy inputs stay on the CPU
# whether or not the machine has a card.  GPU tests hand over CUDA tensors.
tx.set_default_device("cpu")


def tt(a, dtype=None):
    """numpy (or JAX) array -> CPU tensor (a copy: JAX buffers are read-only)."""
    return torch.as_tensor(np.array(a), dtype=dtype, device="cpu")


def npy(a):
    """tensor or JAX array -> numpy array."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().double().numpy() if a.dtype == torch.bfloat16 else a.detach().cpu().numpy()
    return np.asarray(a)


def assert_close(got, ref, rtol, atol=0.0):
    """Elementwise allclose of two outputs or two equal-length tuples of them."""
    if isinstance(got, (tuple, list)):
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            assert_close(g, r, rtol, atol)
        return
    g, r = npy(got), npy(ref)
    assert g.shape == r.shape, (g.shape, r.shape)
    np.testing.assert_allclose(g.astype(np.float64), r.astype(np.float64), rtol=rtol, atol=atol)


@pytest.fixture
def cuda_device():
    """The first CUDA device; skips the test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)
