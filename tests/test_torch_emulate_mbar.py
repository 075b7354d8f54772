"""MBAR's α-grid kernel (``csrc/mbar_alphas.cu``) on the CPU, compiled by the
host's g++ against the stand-in CUDA runtime (``thermoextrap_tpu_torch.emulate``)
and driven through its wrapper ``ops.mbar_cuda.mbar_alphas_cuda``, against the
plain torch route of ``models.mbar.mbar_expectations_alphas`` in float64:

- K = 2 to 6 states, N of a few thousand samples (no multiple of the
  512-sample tile), with the persistent grid cut to two blocks, so that a block walks
  several tiles;
- A = 1 and 3 (the threads of a block split each target's samples), 256 (a
  thread a target) and 300 (two groups of targets, the second ragged);
- V = 1, 2 and 9 (two groups of value columns: 5 and 4);
- float32 and float64, with and without a log sample weight, -inf entries and
  a first tile that is dropped whole among them;
- log weights that rise along the samples, by more between a thread's tiles
  than the kernel's lazy shift allows (a tile is summed again and the earlier
  sums are rescaled), and by less (the shift holds).

Tolerances: the float64 kernel to 1e-10 of the plain route (other order of
summation, exp2 and log2 in place of exp and log); the float32 kernel, on the
float32-rounded inputs, to within 3 times the float32 plain route's own error
against the float64 one, or 2e-6 of the result's scale where that is smaller.
"""

import numpy as np
import pytest
import torch
from _torch_parity import tt

from thermoextrap_tpu_torch import emulate
from thermoextrap_tpu_torch.models import mbar as tm
from thermoextrap_tpu_torch.ops import mbar_cuda
from thermoextrap_tpu_torch.ops import moments_cuda as mc


@pytest.fixture(scope="module")
def kernels():
    if not emulate.available():
        pytest.skip("needs g++ to compile the kernels for the CPU")
    with emulate.emulated() as lib:
        yield lib


@pytest.fixture
def two_blocks(monkeypatch):
    """Two sample blocks for every group of targets: each walks several tiles."""
    monkeypatch.setattr(mbar_cuda, "_TARGET_BLOCKS", 2)


def _problem(k, n, a, v, seed, order=None):
    """Harmonic states u_k = x^2 / (2 sigma_k^2) with their free energies, the
    targets' alphas, u_base = x^2 / 2 and V observables of x."""
    rng = np.random.default_rng(seed)
    sig = np.linspace(1.0, 2.5, k)
    xs = np.concatenate([rng.normal(0.0, s, n // k + (i < n % k)) for i, s in enumerate(sig)])
    if order is not None:
        xs = order(xs)
    u_base = xs**2 / 2
    u_kn = u_base[None] / sig[:, None] ** 2
    n_k = np.array([n // k + (i < n % k) for i in range(k)], dtype=np.float64)
    f_k = -np.log(sig / sig[0])
    alphas = np.linspace(1 / sig[-1] ** 2, 1 / sig[0] ** 2, a)
    x_n = np.stack([np.cos(0.3 * (j + 1) * xs) + 0.1 * j * xs for j in range(v)], axis=1)
    return u_kn, n_k, f_k, alphas, u_base, x_n


def _log_weight(n, seed, drop_head=0):
    """A log sample weight with -inf at a tenth of the samples and at the
    first ``drop_head``."""
    rng = np.random.default_rng(seed + 1)
    lsw = np.log(rng.uniform(0.2, 2.0, n))
    lsw[rng.uniform(size=n) < 0.1] = -np.inf
    lsw[:drop_head] = -np.inf
    return lsw


def _routes(u_kn, n_k, f_k, alphas, u_base, x_n, lsw, dtype):
    """(kernel in ``dtype``, plain float64, plain in ``dtype``), every route on
    the same ``dtype``-rounded inputs."""
    ts = [tt(a, dtype) for a in (u_kn, n_k, f_k, alphas, u_base, x_n)]
    ts.append(None if lsw is None else tt(lsw, dtype))
    u, nk, f, al, ub, x, w = ts
    c_k = torch.log(nk) + f
    got = mbar_cuda.mbar_alphas_cuda(u, c_k, al, ub, x, w)

    def plain(t):
        d = [None if q is None else q.to(t) for q in (u, nk, f, al, ub, x, w)]
        return tm._alphas_plain(d[0], torch.log(d[1]), d[2], d[3], d[4], d[5], 8, d[6])

    return got, plain(torch.float64), plain(dtype)


def _check(got, want, plain, dtype):
    assert got.shape == want.shape and got.dtype == dtype
    g, w, p = (q.double().numpy() for q in (got, want, plain))
    assert np.isfinite(g).all()
    if dtype == torch.float64:
        np.testing.assert_allclose(g, w, rtol=1e-10, atol=1e-12)
        return
    scale = np.abs(w).max()
    bar = max(3.0 * np.abs(p - w).max(), 2e-6 * scale)
    assert np.abs(g - w).max() <= bar, (np.abs(g - w).max(), np.abs(p - w).max(), scale)


@pytest.mark.parametrize(
    ("k", "n", "a", "v", "dtype", "weighted"),
    [
        (2, 2999, 1, 1, torch.float32, False),  # one target on all 256 threads of a block
        (4, 4100, 1, 2, torch.float64, True),
        (3, 1801, 3, 2, torch.float32, True),  # 85 threads a target, one idle
        (4, 2049, 3, 9, torch.float64, False),
        (4, 3001, 256, 2, torch.float32, False),  # the serving shape: a thread a target
        (2, 1500, 256, 1, torch.float64, True),
        (2, 2500, 300, 9, torch.float32, True),  # a full group and a ragged one of 44
        (4, 1700, 300, 1, torch.float64, False),
        (3, 1100, 300, 2, torch.float32, False),
        (6, 2600, 5, 2, torch.float32, True),
        (5, 1500, 256, 1, torch.float64, False),
    ],
)
def test_mbar_alphas_emulated_matches_plain(kernels, two_blocks, k, n, a, v, dtype, weighted):
    u_kn, n_k, f_k, alphas, u_base, x_n = _problem(k, n, a, v, seed=k * n + a)
    lsw = _log_weight(n, seed=n, drop_head=600) if weighted else None
    mc.reset_launches()
    got, want, plain = _routes(u_kn, n_k, f_k, alphas, u_base, x_n, lsw, dtype)
    assert mc.LAUNCHES["mbar_alphas"] == 1 and sum(mc.LAUNCHES.values()) == 1
    _check(got, want, plain, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize(
    ("a", "top"),
    [
        (4, 1000.0),  # a thread's next tile lies ~950 above its last: summed again, the sums rescaled
        (40, 30.0),  # rises of ~30 a tile: the lazy shift holds
    ],
)
def test_mbar_alphas_emulated_rescales_when_the_maximum_moves(kernels, two_blocks, a, top, dtype):
    """u_base falls linearly from ``top`` to 0 along the samples and the
    targets lie beyond the states (alpha 1.5 to 3 against 0.16 to 1), so
    every target's log weight rises along the samples by ~2.8 ``top``."""
    n = 3000
    sig = np.linspace(1.0, 2.5, 3)
    u_base = np.linspace(top, 0.0, n)
    u_kn = u_base[None] / sig[:, None] ** 2
    x_n = np.stack([np.cos(u_base), u_base / top], axis=1)
    alphas = np.linspace(1.5, 3.0, a)
    got, want, plain = _routes(u_kn, np.full(3, n / 3), -np.log(sig / sig[0]), alphas, u_base, x_n, None, dtype)
    _check(got, want, plain, dtype)


def test_mbar_alphas_wrapper_refuses(kernels):
    u_kn, n_k, f_k, alphas, u_base, x_n = (tt(q) for q in _problem(2, 100, 2, 1, seed=1))
    c_k = torch.log(n_k) + f_k
    with pytest.raises(TypeError, match="float32 or float64"):
        mbar_cuda.mbar_alphas_cuda(u_kn.half(), c_k.half(), alphas.half(), u_base.half(), x_n.half())
    with pytest.raises(ValueError, match="type and device"):
        mbar_cuda.mbar_alphas_cuda(u_kn, c_k.float(), alphas, u_base, x_n)
    with pytest.raises(ValueError, match="shapes"):
        mbar_cuda.mbar_alphas_cuda(u_kn, c_k, alphas, u_base[1:], x_n)
    with pytest.raises(NotImplementedError, match="forward only"):
        mbar_cuda.mbar_alphas_cuda(u_kn, c_k, alphas.requires_grad_(), u_base, x_n)


def test_mbar_alphas_emulated_on_the_resident_grid(kernels):
    """The grid sized by the card's resident blocks (two waves of the
    emulator's 8 a multiprocessor on 132): a block a tile."""
    u_kn, n_k, f_k, alphas, u_base, x_n = _problem(4, 5000, 7, 3, seed=4)
    got, want, plain = _routes(u_kn, n_k, f_k, alphas, u_base, x_n, _log_weight(5000, seed=4), torch.float32)
    assert mbar_cuda._resident_blocks(3, 0, None) == 8 * 132
    _check(got, want, plain, torch.float32)
