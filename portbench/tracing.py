"""Readings from ``torch.profiler``: the device time of one entry per call,
and the device activity of a profiled slice of the measured window.

``device_ms`` is the arithmetic of ``thermoextrap_tpu_torch/devtime.py``
(``device_time``), frozen here: device-side activities only, so an operator
and the kernel it launched are not counted twice, each kernel's time per
call its mean over the records the profiler kept times its launches per
call.

A slice is the calls the harness runs under one profiler inside a
``SLICE`` span, each call inside a ``CALL`` span.  Its reading takes the
union of the device intervals inside the slice (busy time, and so the idle
share), counts device kernels (every device activity but copies and fills),
sums each device operation's time, and names each idle gap between device
intervals by the innermost host operation that covers its middle (``CALL``
itself where the host runs Python between operations of the call).
"""

from __future__ import annotations

import dataclasses

import numpy as np

SLICE = "portbench.slice"
CALL = "portbench.call"
# the profiler's own buffer allocation, reported as a device activity
_OVERHEAD = ("Activity Buffer Request",)
_NOT_KERNELS = ("Memcpy", "Memset")


def _profile():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def _is_device(evt) -> bool:
    """A device activity: not the profiler's own, and not the device-side
    mirror of a host span (``record_function`` annotations)."""
    from torch.autograd import DeviceType

    return (
        evt.device_type == DeviceType.CUDA
        and evt.name not in _OVERHEAD
        and evt.name not in (SLICE, CALL)
        and not getattr(evt, "is_user_annotation", False)
    )


def short_name(name: str) -> str:
    """A device operation's name without the C++ noise, at most 120
    characters."""
    for noise in ("void ", "(anonymous namespace)::", "at::native::", "std::"):
        name = name.replace(noise, "")
    return name[:120]


def device_ms(fn, calls: int = 5) -> float | None:
    """Device milliseconds per call of ``fn`` (None where the profiler saw no
    device activity)."""
    import torch

    fn()
    torch.cuda.synchronize()
    with _profile() as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    spans: dict[str, list[float]] = {}
    for evt in prof.events():
        if _is_device(evt):
            spans.setdefault(evt.name, []).append(evt.time_range.elapsed_us() / 1e3)
    if not spans:
        return None
    return sum(sum(ms) / len(ms) * max(1, round(len(ms) / calls)) for ms in spans.values())


@dataclasses.dataclass
class SliceReading:
    calls: int
    window_s: float
    busy_s: float
    kernels: int
    device_ops: list  # [name, seconds per call], most first
    idle_gaps: list  # [host op, idle seconds per call], most first


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def read_slice(prof) -> SliceReading | None:
    """The reading of the ``SLICE`` span of ``prof`` (None without one)."""
    from torch.autograd import DeviceType

    events = list(prof.events())
    spans = [e for e in events if e.name == SLICE and e.device_type == DeviceType.CPU]
    if not spans:
        return None
    t0, t1 = spans[0].time_range.start, spans[0].time_range.end
    calls = sum(1 for e in events if e.name == CALL and e.device_type == DeviceType.CPU and t0 <= e.time_range.start <= t1)
    dev, host = [], []
    for e in events:
        s, t = e.time_range.start, e.time_range.end
        if _is_device(e):
            if t > t0 and s < t1:
                dev.append((e.name, max(s, t0), min(t, t1)))
        elif e.device_type == DeviceType.CPU and e.name not in (SLICE, *_OVERHEAD) and t > t0 and s < t1:
            host.append((s, t, e.name))
    busy = _merge([(s, t) for _, s, t in dev])
    per_call = max(calls, 1)
    ops: dict[str, float] = {}
    for name, s, t in dev:
        key = short_name(name)
        ops[key] = ops.get(key, 0.0) + (t - s) * 1e-6 / per_call
    gaps = [(a[1], b[0]) for a, b in zip(busy, busy[1:])]
    if busy:
        gaps = [(t0, busy[0][0]), *gaps, (busy[-1][1], t1)]
    hs = np.array([h[0] for h in host], dtype=np.float64)
    he = np.array([h[1] for h in host], dtype=np.float64)
    named: dict[str, float] = {}
    for s, t in gaps:
        if t <= s:
            continue
        mid = 0.5 * (s + t)
        cover = np.flatnonzero((hs <= mid) & (he >= mid))
        name = host[cover[np.argmin(he[cover] - hs[cover])]][2] if cover.size else "(between calls)"
        named[name] = named.get(name, 0.0) + (t - s) * 1e-6 / per_call
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]  # noqa: E731
    return SliceReading(
        calls=calls,
        window_s=(t1 - t0) * 1e-6,
        busy_s=sum(t - s for s, t in busy) * 1e-6,
        kernels=sum(1 for name, _, _ in dev if not name.startswith(_NOT_KERNELS)),
        device_ops=top(ops),
        idle_gaps=top(named) if busy else [],
    )
