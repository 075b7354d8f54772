"""MBAR's solve kernel (``csrc/mbar_solve.cu``) on the CPU, compiled by the
host's g++ against the stand-in CUDA runtime (``thermoextrap_tpu_torch.emulate``)
and driven through ``models.mbar.mbar_solve_info``, which routes a hybrid
problem to ``ops.mbar_cuda.MbarSolve`` (inside ``emulated()`` CPU tensors
count as the kernels' device), against its torch route, ``_solve``:

- K = 2, 3, 4, 5 and 8 (the kernel's limit) states, N of a few thousand
  samples (no multiple of the 1024 samples a block's 256 threads load at a
  time; N a multiple of 4, so that K <= 4 takes the 16-byte loads, and not;
  an unaligned view), with the persistent grid cut to two blocks, so that a
  thread walks several groups of samples; one case on the emulator's
  resident grid;
- float32 and float64, with and without a log sample weight: -inf entries,
  the first 1200 samples (more than a block's first load) dropped, weights
  that rise along the samples, so that every thread's shift is raised again
  and again and its sums rescaled, and weights that fall (the shift holds);
- states hundreds of kT apart, whose weights underflow float32 on every
  sample at f = 0; two coinciding states; a state with n_k = 0; the self-consistent and
  then the Newton candidate kept in the first two iterations; on
  disconnected states (a Hessian of 0 up to rounding) the runaway Newton
  candidate losing to the self-consistent one until ``max_iter`` stops
  the loop; a non-finite candidate losing with a NaN residual;
- each pass counted in ``LAUNCHES["mbar_solve"]`` (n_iter + 1 a solve) and
  each iteration in ``MBAR_ITERS``; the routes that keep torch launch
  nothing: the bootstrap's batch of replicates, a process group,
  ``method="sci"``, K above the limit; the wrapper refuses other types,
  shapes that disagree, K out of range and inputs that require grad.

Tolerances: float64 f and residual to 1e-10 of the torch route, with the same
iteration count (the kernel sums in float64 in another order and takes exp2
in log2 units); float32 f within 3 times the float32 torch route's own error
against the float64 one, or 2e-6 where that is larger (the kernel's sums are
float64, the torch route's float32), n_iter within 1 and both residuals
under the tolerance.
"""

import contextlib

import numpy as np
import pytest
import torch
import torch.distributed as dist
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
    """Two blocks in the solve's grid: each thread walks several groups."""
    monkeypatch.setattr(mbar_cuda, "_SOLVE_BLOCKS", 2)


def _problem(k, n, seed):
    """K harmonic states u_k = x^2 / (2 sigma_k^2), samples of each state in
    turn, and their counts."""
    rng = np.random.default_rng(seed)
    sig = np.linspace(1.0, 2.5, k)
    n_k = np.array([n // k + (i < n % k) for i in range(k)], dtype=np.float64)
    xs = np.concatenate([rng.normal(0.0, s, int(c)) for s, c in zip(sig, n_k)])
    return xs[None] ** 2 / (2 * sig[:, None] ** 2), n_k


def _weighted(n_k, lsw):
    """n_k of the weighted problem: each state's block of weights summed, so
    that the solve has a solution (as the bootstrap's count sums)."""
    edges = np.concatenate([[0], np.cumsum(n_k).astype(int)])
    w = np.exp(lsw)
    return np.array([w[a:b].sum() for a, b in zip(edges[:-1], edges[1:])])


def _log_weight(n, seed):
    """Log weights in [log 0.2, log 2], -inf at a tenth of the samples and at
    the first 1100 (more than the 1024 a block's threads load first)."""
    rng = np.random.default_rng(seed + 1)
    lsw = np.log(rng.uniform(0.2, 2.0, n))
    lsw[rng.uniform(size=n) < 0.1] = -np.inf
    lsw[:1100] = -np.inf
    return lsw


@contextlib.contextmanager
def _torch_route():
    """The solve's torch route for CPU tensors, as outside emulated()."""
    saved = mbar_cuda.kernel_device
    mbar_cuda.kernel_device = lambda t: False
    try:
        yield
    finally:
        mbar_cuda.kernel_device = saved


def _routes(u_kn, n_k, dtype, lsw=None, **kw):
    """(kernel, torch route in ``dtype``, torch route in float64), each
    ``(f, n_iter, res)``, the first two on the ``dtype``-rounded inputs, the
    last on the float64 ones (a weighted problem rounded to float32 has no
    exact solution: its n_k are rounded sums); the kernel's passes and
    iterations counted."""
    u, nk = tt(u_kn, dtype), tt(n_k, dtype)
    w = None if lsw is None else tt(lsw, dtype)
    mc.reset_launches()
    iters = tm.MBAR_ITERS["n"]
    got = tm.mbar_solve_info(u, nk, log_sample_weight=w, **kw)
    assert tm.MBAR_ITERS["n"] - iters == got[1]
    assert mc.LAUNCHES == {**dict.fromkeys(mc.LAUNCHES, 0), "mbar_solve": got[1] + 1}
    with _torch_route():
        plain = tm.mbar_solve_info(u, nk, log_sample_weight=w, **kw)
        plain64 = tm.mbar_solve_info(tt(u_kn), tt(n_k), log_sample_weight=None if lsw is None else tt(lsw), **kw)
    assert mc.LAUNCHES["mbar_solve"] == got[1] + 1
    return got, plain, plain64


def _check(got, plain, plain64, dtype, tol=None):
    (f, it, res), (fp, itp, resp), (f64, _, _) = got, plain, plain64
    assert f.dtype == dtype and f.shape == fp.shape and res.shape == () and isinstance(it, int)
    assert np.isfinite(f.numpy()).all()
    if dtype == torch.float64:
        np.testing.assert_allclose(f.numpy(), fp.numpy(), rtol=0, atol=1e-10)
        assert abs(float(res) - float(resp)) <= 1e-10 and it == itp
        return
    err, own = (float((q.double() - f64).abs().max()) for q in (f, fp))
    assert err <= max(3.0 * own, 2e-6), (err, own)
    assert abs(it - itp) <= 1
    if tol is None:
        assert float(res) <= 1e-5 and float(resp) <= 1e-5


@pytest.mark.parametrize(
    ("k", "n", "dtype", "weighted"),
    [
        (2, 2999, torch.float64, False),  # N no multiple of 4: one sample at a time
        (3, 1801, torch.float32, False),
        (3, 4002, torch.float64, True),  # 16-byte loads of 2 float64 samples
        (4, 3000, torch.float32, False),  # the serving shape's K: 16-byte loads of 4 samples
        (4, 6001, torch.float32, True),
        (5, 2000, torch.float32, False),  # K > 4: one sample at a time
        (8, 2500, torch.float64, False),  # the kernel's limit
        (8, 9203, torch.float32, True),
    ],
)
def test_mbar_solve_emulated_matches_torch(kernels, two_blocks, k, n, dtype, weighted):
    u_kn, n_k = _problem(k, n, seed=k * n)
    lsw = _log_weight(n, seed=n) if weighted else None
    if weighted:
        n_k = _weighted(n_k, lsw)
    _check(*_routes(u_kn, n_k, dtype, lsw), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("top", [60.0, -60.0])
def test_mbar_solve_emulated_moving_log_weights(kernels, two_blocks, dtype, top):
    """Log weights that rise from 0 to 60 along the samples (each thread's
    shift is raised at every sample it takes, its sums rescaled each time),
    and that fall to -60 (the first sample's shift holds)."""
    u_kn, n_k = _problem(3, 3000, seed=7)
    lsw = np.linspace(0.0, top, 3000)
    _check(*_routes(u_kn, _weighted(n_k, lsw), dtype, lsw), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_mbar_solve_emulated_states_far_apart(kernels, two_blocks, dtype):
    """States whose free energies lie hundreds of kT apart (harmonic states
    offset by 0, 150, 300 and 450): at f = 0 every weight of the upper
    states underflows float32 on every sample (S_k ~ e^-450), which the
    torch route's log-sum-exp over the samples keeps and the kernel's
    per-state shifts must too.  In float32 the kernel is held to the
    float64 route alone: it carries f in float64 and converges, where the
    float32 route's f (spacing 3e-5 at 450) leaves a residual above 1e-5."""
    u_kn, n_k = _problem(4, 4000, seed=31)
    u_kn = u_kn + np.array([0.0, 150.0, 300.0, 450.0])[:, None]
    got, plain, plain64 = _routes(u_kn, n_k, dtype, max_iter=100)
    if dtype == torch.float64:
        _check(got, plain, plain64, dtype)
    else:
        assert float(got[2]) <= 1e-5 and float((got[0].double() - plain64[0]).abs().max()) <= 2e-4
    assert 3 <= got[1] <= 20 and float(got[0][3]) > 440.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_mbar_solve_emulated_coinciding_states(kernels, two_blocks, dtype):
    u_kn, n_k = _problem(3, 3000, seed=5)
    u_kn[2] = u_kn[1]
    got = _routes(u_kn, n_k, dtype)
    _check(*got, dtype)
    assert float((got[0][0][1] - got[0][0][2]).abs()) <= (1e-12 if dtype == torch.float64 else 1e-6)


def test_mbar_solve_emulated_keeps_each_candidate(kernels, two_blocks):
    """From f = 0 the first iteration keeps the self-consistent candidate,
    the second the Newton one (float64)."""
    u_kn, n_k = _problem(4, 3000, seed=11)
    u, log_n = tt(u_kn), torch.log(tt(n_k))
    first, plain, plain64 = _routes(u_kn, n_k, torch.float64, max_iter=1)
    _check(first, plain, plain64, torch.float64, tol=False)
    second, plain, plain64 = _routes(u_kn, n_k, torch.float64, max_iter=2)
    _check(second, plain, plain64, torch.float64, tol=False)
    f0 = torch.zeros(4, dtype=torch.float64)
    sc0, nw0 = tm._self_consistent_update(f0, u, log_n), tm._newton_update(f0, u, log_n)
    sc1, nw1 = tm._self_consistent_update(first[0], u, log_n), tm._newton_update(first[0], u, log_n)
    assert float((first[0] - sc0).abs().max()) <= 1e-10 and float((nw0 - sc0).abs().max()) > 1e-2
    assert float((second[0] - nw1).abs().max()) <= 1e-10 and float((nw1 - sc1).abs().max()) > 1e-3


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_mbar_solve_emulated_newton_loses_on_disconnected_states(kernels, two_blocks, dtype):
    """Two states that share no sample (each state's samples 1e4 above the
    other's energy): every weight is 0 or 1/n_k, the reduced Hessian is 0 up
    to rounding and, with more draws named for state 1 than it has, the
    Newton step from f = 0 runs off (to inf in the float32 torch route); the
    self-consistent candidate is kept at every iteration, its residual
    stays 400 / 512 - 1, and max_iter stops the loop."""
    n = 1000
    u_kn = np.zeros((2, n))
    u_kn[1, :600] = 1e4
    u_kn[0, 600:] = 1e4
    n_k = np.array([600.0, 512.0])
    got, plain, _ = _routes(u_kn, n_k, dtype, max_iter=3)
    (f, it, res), (fp, itp, resp) = got, plain
    assert it == itp == 3 and abs(float(res) - 0.21875) < 1e-6 and abs(float(resp) - 0.21875) < 1e-6
    np.testing.assert_allclose(f.double().numpy(), fp.double().numpy(), rtol=0, atol=1e-6)
    f0 = torch.zeros(2, dtype=torch.float64)
    newton = tm._newton_update(f0, tt(u_kn), torch.log(tt(n_k)))
    assert abs(float(newton[1])) > 1e6 or not torch.isfinite(newton).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_mbar_solve_emulated_non_finite_candidate_loses(kernels, two_blocks, dtype):
    """A candidate of +inf free energies (set in the solve's scratch after
    the opening pass): its terms are not finite, so the kernel marks its
    first sum, and with it its residual, NaN (the first block's shown), and
    the iteration keeps the other one, the self-consistent step from
    f = 0."""
    u_kn, n_k = _problem(3, 2000, seed=37)
    u, log_n = tt(u_kn, dtype), torch.log(tt(n_k, dtype))
    sv = mbar_cuda.MbarSolve(u, log_n, 1e-5, 5)
    sv._fc[3:] = float("inf")
    sv._cand[3:6] = float("inf")
    sv.step()
    # K = 3: 9 sums a candidate, then the block's shift
    assert torch.isnan(sv._part.view(-1, 19)[0, 9]) and not torch.isnan(sv._part.view(-1, 19)[0, :9]).any()
    sc = tm._self_consistent_update(torch.zeros(3, dtype=dtype), u, log_n)
    np.testing.assert_allclose(sv.f.double().numpy(), sc.double().numpy(), rtol=0, atol=1e-5 if dtype == torch.float32 else 1e-12)
    assert int(sv.n_iter) == 1 and bool(torch.isfinite(sv.res))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_mbar_solve_emulated_unsampled_state(kernels, two_blocks, dtype):
    """A state with n_k = 0 (its free energy found by reweighting alone),
    first among the states and in the middle."""
    rng = np.random.default_rng(29)
    for sig, counts in (([1.0, 1.6, 2.2, 3.0], [1000, 0, 1000, 1000]), ([3.0, 1.0, 1.6, 2.2], [0, 900, 1100, 1000])):
        sig = np.asarray(sig)
        xs = np.concatenate([rng.normal(0.0, s, c) for s, c in zip(sig, counts)])
        _check(*_routes(xs[None] ** 2 / (2 * sig[:, None] ** 2), np.asarray(counts, dtype=float), dtype), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_mbar_solve_emulated_stops_at_max_iter(kernels, two_blocks, dtype):
    u_kn, n_k = _problem(4, 2400, seed=13)
    got, plain, plain64 = _routes(u_kn, n_k, dtype, max_iter=2)
    assert got[1] == plain[1] == 2 and float(got[2]) > 1e-5
    _check(got, plain, plain64, dtype, tol=False)


def test_mbar_solve_emulated_unaligned_and_resident_grid(kernels):
    """An unaligned view (float32 u_kn 4 bytes past a 16-byte boundary: one
    sample at a time though N is a multiple of 4), on the grid sized by the
    card's resident blocks (the emulator's 8 a multiprocessor on 132)."""
    u_kn, n_k = _problem(4, 3000, seed=17)
    flat = torch.zeros(u_kn.size + 1, dtype=torch.float32)
    flat[1:] = tt(u_kn, torch.float32).reshape(-1)
    u = flat[1:].view(u_kn.shape)
    assert u.is_contiguous() and u.data_ptr() % 16 == 4
    mc.reset_launches()
    f, it, res = tm.mbar_solve_info(u, tt(n_k, torch.float32))
    assert mc.LAUNCHES["mbar_solve"] == it + 1
    assert mbar_cuda._solve_blocks(4, 0, None) == 8 * 132
    with _torch_route():
        f64 = tm.mbar_solve_info(tt(u_kn), tt(n_k))[0]
        fp = tm.mbar_solve_info(u, tt(n_k, torch.float32))[0]
    err, own = (float((q.double() - f64).abs().max()) for q in (f, fp))
    assert err <= max(3.0 * own, 2e-6) and float(res) <= 1e-5


@pytest.fixture
def world_of_one():
    """A gloo process group of one rank in this process (an in-memory store)."""
    if dist.is_initialized():
        yield dist.group.WORLD
        return
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


def test_mbar_solve_emulated_routes_that_keep_torch(kernels, two_blocks, world_of_one):
    """Within emulated() a CPU tensor counts as the kernels' device, yet
    none of these launches the kernel: the bootstrap's batch of replicates
    and a process group's solve call ``_solve`` itself, and ``mbar_solve_info``
    keeps ``method="sci"`` and K above the limit there."""
    u_kn, n_k = _problem(3, 1500, seed=19)
    u, nk = tt(u_kn), tt(n_k)
    log_n = torch.log(nk)[None]
    mc.reset_launches()
    counts = torch.ones((2, 1500), dtype=torch.float64)
    counts[1, ::3] = 0.0
    boot = tm._bootstrap_from_counts(u, [500, 500, 500], u[:1], u[0][:, None], counts)
    sharded = tm._solve(u, log_n, None, 1e-12, 100, "hybrid", group=world_of_one)
    sci = tm.mbar_solve_info(u, nk, method="sci")
    big = tm.mbar_solve_info(tt(_problem(9, 1800, seed=23)[0]), np.full(9, 200.0))
    assert mc.LAUNCHES == dict.fromkeys(mc.LAUNCHES, 0)
    assert boot.shape == (2, 1, 1) and sharded[2][0] <= 1e-12 and sci[2] <= 1e-10 and big[2] <= 1e-12


def test_mbar_solve_wrapper_refuses(kernels):
    u_kn, n_k = _problem(3, 300, seed=1)
    u, log_n = tt(u_kn), torch.log(tt(n_k))
    with pytest.raises(TypeError, match="float32 or float64"):
        mbar_cuda.MbarSolve(u.half(), log_n.half(), 1e-5, 10)
    with pytest.raises(ValueError, match="type and device"):
        mbar_cuda.MbarSolve(u, log_n.float(), 1e-5, 10)
    with pytest.raises(ValueError, match="shapes"):
        mbar_cuda.MbarSolve(u, log_n[:2], 1e-5, 10)
    with pytest.raises(ValueError, match="shapes"):
        mbar_cuda.MbarSolve(u, log_n, 1e-5, 10, torch.zeros(299, dtype=torch.float64))
    with pytest.raises(ValueError, match="2 <= K"):
        mbar_cuda.MbarSolve(tt(np.zeros((9, 300))), torch.zeros(9, dtype=torch.float64), 1e-5, 10)
    with pytest.raises(NotImplementedError, match="forward only"):
        mbar_cuda.MbarSolve(u.clone().requires_grad_(), log_n, 1e-5, 10)
    # the solve's kernel route takes such an input, so it raises there too
    with pytest.raises(NotImplementedError, match="forward only"):
        tm.mbar_solve_info(u.clone().requires_grad_(), tt(n_k))
