"""Gradients through the kernel route of K1, K2, K4 and K6
(``thermoextrap_tpu_torch.ops.moments_autograd``) against the JAX package.

``dispatch.use_impl("cuda")`` on CPU tensors runs each autograd Function
with its wrapper's plain forward, so the backward code runs here.  Each
gradient is held against torch autograd of the plain float64 path and
against ``jax.grad`` of the JAX package's XLA formulation on the same numpy
inputs, both to 1e-10, and against the JAX package's ``custom_vjp`` entries
with their Pallas forward in interpret mode at the bar of
tests/test_parallel.py:364-367 (rtol 2e-3, atol 1e-5).  ``gradcheck`` holds
K1's closed form against finite differences.  The card's cases are in the
jax-free tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import npy, tt

from thermoextrap_tpu.ops import moments as jm
from thermoextrap_tpu.ops import moments_pallas as mp
from thermoextrap_tpu.ops import resample as jr
from thermoextrap_tpu_torch.ops import dispatch, moments_autograd, moments_cuda
from thermoextrap_tpu_torch.ops import moments as tm
from thermoextrap_tpu_torch.ops import resample as trs

RTOL_EXACT = 1e-10
RTOL_AD, ATOL_AD = 2e-3, 1e-5


def _scalar(out, xp):
    """A fixed scalar of every output: sum(sin(o)) + sum(o^2 * ramp)."""
    total = 0.0
    for o in out:
        n = o.size if xp is jnp else o.numel()
        ramp = xp.arange(1.0, 1.0 + n, dtype=o.dtype)
        total = total + xp.sum(xp.sin(o)) + xp.sum(o**2 * ramp.reshape(o.shape))
    return total


def _torch_grads(fn, inputs):
    """``torch.autograd.grad`` of the scalar of ``fn(*tensors)`` for numpy
    ``inputs`` (float64 CPU tensors that require grad)."""
    ts = [tt(a).requires_grad_(True) for a in inputs]
    return torch.autograd.grad(_scalar(fn(*ts), torch), ts)


def _jax_grads(fn, inputs):
    return jax.jit(jax.grad(lambda *a: _scalar(fn(*a), jnp), argnums=tuple(range(len(inputs)))))(
        *[jnp.asarray(a) for a in inputs]
    )


def _kernel_route(fn):
    def run(*ts):
        with dispatch.use_impl("cuda"):
            return fn(*ts)

    return run


def _interpret(name, fn):
    """Run ``fn`` with ``mp.<name>`` (the Pallas forward) in interpret mode."""
    orig = getattr(mp, name)
    setattr(mp, name, lambda *a, **k: orig(*a, interpret=True, **k))
    try:
        return fn()
    finally:
        setattr(mp, name, orig)


def _assert_grads(got, ref, rtol, atol=None):
    """Elementwise, with ``atol`` by default ``rtol`` times the largest
    reference entry (a sample no replicate draws has a gradient of zero in
    one package and rounding noise in the other)."""
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        r = np.asarray(r)
        np.testing.assert_allclose(npy(g), r, rtol=rtol, atol=rtol * np.abs(r).max() if atol is None else atol)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(11)
    return {
        "u": rng.normal(2.0, 1.0, 300),
        "x": rng.normal(1.0, 0.5, (300, 2)),
        "w": rng.uniform(0.5, 1.5, 300),
        "ub": rng.normal(2.0, 1.0, (2, 300)),
        "xb": rng.normal(1.0, 0.5, (2, 300, 2)),
        "wb": rng.uniform(0.5, 1.5, (2, 300)),
        "uu": rng.normal(2.0, 1.0, (3, 400)),
        "wu": rng.uniform(0.5, 1.5, (3, 400)),
        "freq": np.asarray(jr.freq_from_indices(rng.integers(0, 300, (6, 300)), 300)),
    }


# -- one case per kernel: (port route, plain float64, JAX XLA, JAX _ad entry, inputs) ------


def _k1(weighted):
    order = 4
    keys = ("u", "x", "w") if weighted else ("u", "x")

    def port(u, x, w=None):
        return dispatch.reduce_central(u, x, order, weight=w)

    def plain(u, x, w=None):
        return tm.reduce_central_comoments(u, x, order, weight=w)

    def jax_ref(u, x, w=None):
        return jm.reduce_central_comoments(u, x, order, weight=w)

    def jax_ad(d):
        f = lambda u, x, w=None: mp.reduce_central_comoments_fused_ad(u, x, w, order)  # noqa: E731
        return _interpret("reduce_central_comoments_fused", lambda: _jax_grads(f, [d[k] for k in keys]))

    return port, plain, jax_ref, jax_ad, keys


def _k6():
    order = 3
    keys = ("ub", "xb", "wb")

    def port(u, x, w):
        return dispatch.reduce_central(u, x, order, weight=w)

    def plain(u, x, w):
        return tm.reduce_central_comoments(u, x, order, weight=w)

    def jax_ref(u, x, w):
        return jm.reduce_central_comoments(u, x, order, weight=w)

    def jax_ad(d):
        f = lambda u, x, w: mp.reduce_central_comoments_batched_ad(u, x, w, order)  # noqa: E731
        return _interpret("reduce_central_comoments_batched", lambda: _jax_grads(f, [d[k] for k in keys]))

    return port, plain, jax_ref, jax_ad, keys


def _k4():
    order = 4
    keys = ("uu", "wu")

    def port(u, w):
        return dispatch.reduce_central_u(u, order, weight=w)

    def plain(u, w):
        return tm.reduce_central_umoments(u, order, weight=w)

    def jax_ref(u, w):
        return mp._u_batched_xla(u, w, order)

    def jax_ad(d):
        f = lambda u, w: mp.reduce_central_umoments_batched_ad(u, w, order)  # noqa: E731
        return _interpret("reduce_central_umoments_batched", lambda: _jax_grads(f, [d[k] for k in keys]))

    return port, plain, jax_ref, jax_ad, keys


def _k2(freq, weighted):
    order = 3
    keys = ("u", "x", "w") if weighted else ("u", "x")

    def port(u, x, w=None):
        return dispatch.resample_central(u, x, tt(freq), order, weight=w)

    def plain(u, x, w=None):
        return trs.resample_central_comoments(u, x, tt(freq), order, weight=w)

    def jax_ref(u, x, w=None):
        return jr.resample_central_comoments(u, x, jnp.asarray(freq), order, weight=w)

    def jax_ad(d):
        def f(u, x, w=None):
            return mp.resample_central_comoments_fused_ad(u, x, jnp.asarray(freq), order, weight=w)

        return _interpret("resample_central_comoments_fused", lambda: _jax_grads(f, [d[k] for k in keys]))

    return port, plain, jax_ref, jax_ad, keys


CASES = ["K1", "K1_weighted", "K6", "K4", "K2", "K2_weighted"]


def _case(name, d):
    return {
        "K1": lambda: _k1(False),
        "K1_weighted": lambda: _k1(True),
        "K6": _k6,
        "K4": _k4,
        "K2": lambda: _k2(d["freq"], False),
        "K2_weighted": lambda: _k2(d["freq"], True),
    }[name]()


@pytest.fixture(scope="module")
def port_grads(data):
    out = {}
    for name in CASES:
        port, _, _, _, keys = _case(name, data)
        out[name] = _torch_grads(_kernel_route(port), [data[k] for k in keys])
    return out


@pytest.mark.parametrize("name", CASES)
def test_kernel_route_matches_plain_autograd(data, port_grads, name):
    _, plain, _, _, keys = _case(name, data)
    ref = _torch_grads(plain, [data[k] for k in keys])
    _assert_grads(port_grads[name], ref, RTOL_EXACT)


@pytest.mark.parametrize("name", CASES)
def test_kernel_route_matches_jax_xla_grad(data, port_grads, name):
    _, _, jax_ref, _, keys = _case(name, data)
    _assert_grads(port_grads[name], _jax_grads(jax_ref, [data[k] for k in keys]), RTOL_EXACT)


@pytest.mark.parametrize("name", CASES)
def test_kernel_route_matches_jax_custom_vjp(data, port_grads, name):
    _, _, _, jax_ad, _ = _case(name, data)
    _assert_grads(port_grads[name], jax_ad(data), RTOL_AD, ATOL_AD)


@pytest.mark.parametrize("weighted", [False, True])
def test_k1_closed_form_gradcheck(weighted):
    rng = np.random.default_rng(5)
    u = tt(rng.normal(2.0, 1.0, 64)).requires_grad_(True)
    x = tt(rng.normal(1.0, 0.5, (64, 1))).requires_grad_(True)
    w = tt(rng.uniform(0.5, 1.5, 64)).requires_grad_(True) if weighted else None
    inputs = (u, x, w) if weighted else (u, x)
    assert torch.autograd.gradcheck(
        lambda *a: moments_autograd.reduce_central_comoments_fused_ad(a[0], a[1], a[2] if weighted else None, 4),
        inputs,
    )


def test_x_is_u_route_differentiates_through_k4(data):
    """The x_is_u comoments come from K4 at order + 1; their gradient equals
    the plain path's."""
    u, w = data["uu"][0], data["wu"][0]

    def run(impl):
        tu, tw = tt(u).requires_grad_(True), tt(w).requires_grad_(True)
        with dispatch.use_impl(impl):
            out = dispatch.reduce_central(tu, tu, 3, weight=tw, val_ndim=0, x_is_u=True)
        return torch.autograd.grad(_scalar(out, torch), (tu, tw))

    _assert_grads(run("cuda"), [npy(g) for g in run("torch")], RTOL_EXACT)


def test_no_grad_takes_the_wrapper_itself(data):
    """Without an input that requires grad, or under no_grad, the kernel
    route is the wrapper call: no graph, the same numbers."""
    u, x = tt(data["u"]), tt(data["x"])
    with dispatch.use_impl("cuda"):
        plain = dispatch.reduce_central(u, x, 4)
        assert all(o.grad_fn is None for o in plain)
        with torch.no_grad():
            out = dispatch.reduce_central(u.clone().requires_grad_(True), x, 4)
        assert all(o.grad_fn is None for o in out)
        graph = dispatch.reduce_central(u.clone().requires_grad_(True), x, 4)
    assert all(o.grad_fn is not None for o in graph)
    for a, b in zip(graph, plain):
        np.testing.assert_array_equal(npy(a), npy(b))


def test_grad_check_of_the_wrappers():
    """A direct wrapper call of K1 / K2 / K4 / K6 raises on an input that
    requires grad under grad mode only (the Functions' forward runs with it
    off); K3 / K5 / K7 / K8 raise always: they have no backward."""
    t = torch.ones(3, requires_grad=True)
    with pytest.raises(NotImplementedError, match="returns no graph"):
        moments_cuda._check_cuda_inputs(t, backward=True)
    with torch.no_grad():
        moments_cuda._check_cuda_inputs(t, backward=True)
        with pytest.raises(NotImplementedError, match="forward only"):
            moments_cuda._check_cuda_inputs(t)
