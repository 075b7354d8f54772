"""The traced slice's reading on a synthetic profile: busy time as the union
of device intervals, kernels without copies, per-call sums, and each idle
gap named by the innermost host operation over its middle."""

import types

import pytest
from torch.autograd import DeviceType

from portbench import tracing


def _evt(name, start, end, device=DeviceType.CPU):
    rng = types.SimpleNamespace(start=start, end=end, elapsed_us=lambda: end - start)
    return types.SimpleNamespace(name=name, device_type=device, time_range=rng)


def test_slice_reading():
    cuda = DeviceType.CUDA
    events = [
        _evt(tracing.SLICE, 0.0, 100.0),
        _evt(tracing.CALL, 0.0, 50.0),
        _evt(tracing.CALL, 50.0, 100.0),
        _evt(tracing.CALL, 0.0, 50.0, cuda),  # the annotation's device mirror: not device work
        _evt("aten::mul", 10.0, 30.0),
        _evt("cudaLaunchKernel", 12.0, 14.0),
        _evt("aten::copy_", 60.0, 90.0),
        _evt("kernel_a", 0.0, 10.0, cuda),
        _evt("kernel_a", 20.0, 25.0, cuda),  # overlaps the next one
        _evt("kernel_b", 22.0, 40.0, cuda),
        _evt("Memcpy DtoH", 80.0, 100.0, cuda),
    ]
    prof = types.SimpleNamespace(events=lambda: events)
    r = tracing.read_slice(prof)
    assert r.calls == 2 and r.kernels == 3
    assert r.window_s == pytest.approx(100e-6)
    assert r.busy_s == pytest.approx((10 + 20 + 20) * 1e-6)  # [0,10] [20,40] [80,100]
    ops = dict(r.device_ops)
    assert ops["kernel_a"] == pytest.approx(7.5e-6) and ops["Memcpy DtoH"] == pytest.approx(10e-6)
    gaps = dict(r.idle_gaps)
    # [10, 20]: middle 15 under aten::mul (cudaLaunchKernel ends at 14);
    # [40, 80]: middle 60 at the start of aten::copy_
    assert gaps == {"aten::mul": pytest.approx(5e-6), "aten::copy_": pytest.approx(20e-6)}
