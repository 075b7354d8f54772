"""One run of one cell: set-up, the measured window, the traced slice and
its per-layer readings, the check against the plain reference, and the
result line.

Everything is found by name: the cell in ``BENCHMARK.json``, its limits
in ``workloads/<cell>.json``, its configuration through the ``configs`` entry of
``BENCHMARK.json``, its traffic mix in ``traffic/<traffic>.json``, the model
that configuration names in ``models/<model>.py`` with its plain reference
in ``reference/<model>.py``, each end-to-end metric in
``end_to_end/<metric>.py`` and each per-layer metric in
``metrics/<metric>.py``.  A metric split by the end-to-end metric its cells
report (``call_ms.host`` beside ``call_ms``) is read by the file of the
name before its first dot.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path

from . import generator, tracing

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
FOREIGN = ("jax", "jaxlib", "flax", "thermoextrap_tpu")
SLICE_START_S = 1.0  # the traced slice starts this far into the window ...
SLICE_CALLS = 60  # ... and holds at most this many calls
SLICE_S = 2.0  # ... or this many seconds of them
TRACES = ROOT / "traces"


def reader(kind: str, metric: str):
    """The reader of ``metric``: ``<kind>/<name before the first dot>.py``."""
    base = metric.split(".")[0]
    return load_module(ROOT / kind / f"{base}.py", f"portbench.{kind}.{base}")


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def foreign_modules(names) -> list[str]:
    """The loaded modules whose top-level name (the part before the first
    dot) is one of :data:`FOREIGN`, compared whole."""
    return sorted({n.split(".")[0] for n in names} & set(FOREIGN))


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, overrides: dict | None = None) -> Cell:
    """The cell ``name``; ``overrides`` may replace keys of its
    configuration (``"config"``) and traffic mix (``"traffic"``)."""
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        msg = f"no workload {name!r} in BENCHMARK.json"
        raise KeyError(msg)
    own = json.loads((ROOT / "workloads" / f"{name}.json").read_text())
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    overrides = overrides or {}
    config = {**json.loads((REPO / conf["file"]).read_text()), **overrides.get("config", {})}
    traffic = {**json.loads((ROOT / "traffic" / f"{entry['traffic']}.json").read_text()), **overrides.get("traffic", {})}
    return Cell(
        name=name,
        config=config,
        traffic=traffic,
        limits=own["limits"],
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
    )


def model(config: dict):
    return load_module(ROOT / "models" / f"{config['model']}.py", f"portbench.models.{config['model']}")


def reference(config: dict):
    return importlib.import_module(f"portbench.reference.{config['model']}")


@dataclasses.dataclass
class Window:
    """What the measured window saw."""

    setup_s: float
    wall_s: float
    latencies_s: list
    answers: list
    failed: int
    peak_bytes: int
    process_peak_bytes: int


@dataclasses.dataclass
class TraceContext:
    """What a per-layer reader may read."""

    slice: tracing.SliceReading | None
    entry: dict  # the operands one call hands to the port's reductions
    device_ms: object  # device_ms(fn) -> ms per call, or None


def _sync(device) -> None:
    if device.type == "cuda":
        import torch

        torch.cuda.synchronize(device)


def run(
    cell: Cell,
    seed: int,
    seconds: float,
    trace: bool,
    device,
    *,
    t_start: float,
    control: bool = False,
) -> dict:
    """Run ``cell`` on ``device`` and return the result line's fields and
    the checks (``{"checks": {name: {"value", "limit"}}, ...}``)."""
    import torch
    from torch.autograd.profiler import record_function

    cuda = device.type == "cuda"
    mod = model(cell.config)
    inputs = mod.make_inputs(cell.config, seed, device)
    loop = generator.make(cell.traffic, mod, cell.config, inputs, seed, control=control)
    loop.warm()
    gc.collect()
    gc.freeze()  # what set-up made is not traversed by the collector in the window
    if trace:  # the profiler's own start-up belongs to set-up
        with tracing._profile():
            torch.ones(1, device=device).add_(1)
            _sync(device)
    _sync(device)
    setup_s = time.perf_counter() - t_start
    process_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)

    lat, answers, failed = [], [], 0
    prof = slice_span = None
    slice_calls = 0

    def close_slice():
        nonlocal slice_span
        slice_span.__exit__(None, None, None)
        _sync(device)
        prof.stop()
        slice_span = None

    t0 = time.perf_counter()
    i = 0
    while True:
        now = time.perf_counter()
        if trace and prof is None and now - t0 >= min(SLICE_START_S, seconds / 4):
            prof = tracing._profile()
            prof.start()
            slice_span = record_function(tracing.SLICE)
            slice_span.__enter__()
            t_slice = now
        in_slice = slice_span is not None
        ctx = record_function(tracing.CALL) if in_slice else contextlib.nullcontext()
        try:
            with ctx:
                ans = loop.step(i)
            answers.append(ans)
        except Exception as err:  # a failed call counts, and the window goes on
            failed += 1
            if failed == 1:
                print(f"call {i} failed: {err!r}", file=sys.stderr)
        end = time.perf_counter()
        lat.append(end - now)
        i += 1
        if in_slice:
            slice_calls += 1
            if slice_calls >= SLICE_CALLS or end - t_slice >= SLICE_S:
                close_slice()
        if end - t0 >= seconds:
            break
    if slice_span is not None:
        close_slice()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    win = Window(setup_s, wall, lat, answers, failed, peak, max(peak, process_peak))
    out = {"window": win, "foreign": foreign_modules(sys.modules)}

    if trace:
        reading = tracing.read_slice(prof) if prof is not None else None
        if prof is not None and cuda:
            TRACES.mkdir(exist_ok=True)
            prof.export_chrome_trace(str(TRACES / f"{cell.name}.{seed}.json"))
        tctx = TraceContext(
            slice=reading if reading is not None and reading.busy_s > 0 else None,
            entry=mod.entry_inputs(cell.config, inputs, cell.traffic),
            device_ms=tracing.device_ms if cuda else (lambda fn: None),
        )
        out["per_layer"] = {}
        for m in cell.per_layer:
            value = reader("metrics", m["name"]).read(tctx)
            if value is not None:
                out["per_layer"][m["name"]] = {"value": value, "unit": m["unit"]}
        out["slice"] = tctx.slice

    loop.close()
    gc.unfreeze()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    nums = check(cell, loop, answers, device)
    nums_ok = all(nums[k] <= cell.limits[k] for k in nums)
    out["checks"] = {k: {"value": nums[k], "limit": cell.limits[k]} for k in nums}
    out["correct"] = bool(answers) and failed == 0 and nums_ok
    return out


def check(cell: Cell, loop, answers: list, device) -> dict:
    """The checks of the window's answers against the plain reference, with
    the TF32 path of float32 products off on the reference's side."""
    import torch

    if not answers:
        return {}
    allow = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            return loop.check(reference(cell.config), answers, device)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = allow


def result_line(cell: Cell, out: dict, trace: bool, device) -> dict:
    """The result line of a run, ``checks`` last."""
    import torch

    win = out["window"]
    if trace:
        metrics = out["per_layer"]
    else:
        metrics = {}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": reader("end_to_end", m["name"]).read(win), "unit": m["unit"]}
    dev = {
        "platform": "gpu" if device.type == "cuda" else device.type,
        "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "count": 1,
        "memory_peak_bytes": win.process_peak_bytes,
    }
    line = {
        "correct": out["correct"],
        "attempted": len(win.latencies_s),
        "failed": win.failed,
        "metrics": metrics,
        "device": dev,
    }
    if trace:
        s = out.get("slice")
        dev["busy_s"] = s.busy_s if s else 0.0
        dev["window_s"] = s.window_s if s else 0.0
        if s:
            line["breakdown"] = {"device_ops": s.device_ops, "idle_gaps": s.idle_gaps}
    line["checks"] = out["checks"]
    return line
